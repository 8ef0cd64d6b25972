"""Per-partition stage ops over ``(P, cap)`` batches.

The counterpart of ``dryad_tpu/exec/kernels.py``: every stage op kind
of the reference (the row-wise ops and user functions ``select``,
``where``, ``project``, ``seed``, ``select_many``, ``apply``, ``fork``;
``string_code`` and ``group_reduce_dense``; the exchanges
``exchange_hash`` and ``exchange_range`` with ``resize``;
``group_reduce``, ``group_combine``, ``distinct``, ``local_sort``,
``topk``; the joins ``join``, ``semi``, ``group_join_count``,
``join_ranked`` with shuffle, broadcast or run-time ``auto`` placement;
``concat``; the rank and ordered ops ``with_rank``, ``take``, ``skip``,
``tail``, ``take_while``, ``skip_while``, ``reverse``,
``default_if_empty``, ``zip``, ``sliding_window``; ``scalar_agg``).
The reference composes them into one traced SPMD program per stage;
here a unit's ops run in order inside its stage program
(``exec/programs.py``: captured once into a CUDA graph on the card),
each on all of a rank's partitions at once (all P in one process,
``P / world`` of a gang), and a user function of ``apply`` or ``fork``
runs once per partition on a one-partition view, as the reference's
does.  No op reads a device value on the host or copies a host tensor
to the device, so every op can be captured.  Every
partition-axis operation goes through the partition layer's collectives
(``parallel/partition.py``) over the stage's mesh: tensor ops in one
process, ``torch.distributed`` calls across a gang's ranks.  Capacities derive from the stage's entry
capacities, its growth and the executor's retry ``boost``, as in the
reference.  Every exchange goes through :func:`_exchange`, which logs
the planner's byte accounting (``plan/xchgplan.py``) on the context's
``xchg_log`` (the executor's ``exchange_round`` events) and runs the
flat exchange (window 0) or the staged one.  On a hybrid mesh the
``tree`` param of ``exchange_hash`` runs the reference's tree exchange
(:func:`_tree_exchange_hash`); on a flat mesh it is ignored, as the
reference ignores it on a one-axis mesh.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from dryad_tpu_torch.columnar.batch import MASK32, WORD, ColumnBatch
from dryad_tpu_torch.ops import join as J
from dryad_tpu_torch.ops import segmented as SEG
from dryad_tpu_torch.ops import shuffle as SH
from dryad_tpu_torch.ops import sort as SORT
from dryad_tpu_torch.ops.bucket import bucket_sum_count
from dryad_tpu_torch.ops.hash import partition_ids
from dryad_tpu_torch.parallel import partition as PART
from dryad_tpu_torch.parallel.mesh import AXIS, axis_sizes, mesh_axes
from dryad_tpu_torch.plan import xchgplan as XP


def _round8(n: float) -> int:
    return max(8, int(math.ceil(n / 8.0)) * 8)


class StageContext:
    """Mutable state while running one stage at one retry ``boost``: its
    slots, the overflow flag the executor reads after the stage, and the
    dictionary-miss counter it reads once after the job."""

    def __init__(self, P: int, device, operands=None, slack: float = 2.0, boost: int = 1,
                 mesh=None, window: int = 0):
        self.P = P  # global partitions
        self.device = torch.device(device)
        # the partitions' mesh (parallel/mesh.py): None or a mesh without
        # a group in one process; this rank holds partitions base.. of P
        self.mesh = mesh
        self.base = mesh.base if mesh is not None else 0
        # the mesh's axes, outermost first, and their extents
        self.axes = mesh_axes(mesh)
        self.axis_sizes = axis_sizes(mesh) if mesh is not None else (P,)
        # staged-exchange window (config.exchange_window, resolved by the
        # executor); 0 = the flat exchange
        self.window = window
        # each exchange's per-round byte accounting, in order: the
        # executor's exchange_round events of this dispatch
        self.xchg_log: List[Dict[str, int]] = []
        # the dispatch's tables (exec/programs.py: PositionalOperands)
        self.operands = operands
        self.slack = slack
        self.boost = boost
        self.slots: Dict[int, ColumnBatch] = {}
        self.entry_caps: Dict[int, int] = {}
        # capacity of the resize fused into the running exchange (run_ops)
        self.resize_to: Optional[int] = None
        # set when an exchange bucket or a resize dropped rows
        self.overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        # rows whose dense key missed its domain (STRING words absent
        # from the dictionary, INT32 keys past the ingest range)
        self.dict_miss = torch.zeros((), dtype=torch.int64, device=self.device)

    def bind_inputs(self, batches: Tuple[ColumnBatch, ...]) -> None:
        for i, b in enumerate(batches):
            self.slots[i] = b
            self.entry_caps[i] = b.capacity

    def base_cap(self, slot: int) -> int:
        return self.entry_caps.get(slot, max(self.entry_caps.values() or [64]))

    def operand(self, obj) -> Tuple[torch.Tensor, ...]:
        """Device tensors of a coding table (``exec/operands.py``)."""
        return self.operands.get(obj)


def apply_op(ctx: StageContext, kind: str, p: Dict[str, Any]) -> None:
    fn = _KERNELS.get(kind)
    if fn is None:
        raise NotImplementedError(f"no kernel for stage op {kind!r}")
    fn(ctx, p)


def run_ops(ctx: StageContext, ops) -> None:
    """Apply a stage's ops in order.  An exchange followed by the resize
    of its slot (lowering always emits the pair) runs as one placement
    straight into the resized layout: the two ops' bytes and overflow
    flag, without the exchange's padded layout in between."""
    i = 0
    while i < len(ops):
        op = ops[i]
        nxt = ops[i + 1] if i + 1 < len(ops) else None
        fuse = (
            op.kind in ("exchange_hash", "exchange_range")
            and nxt is not None and nxt.kind == "resize"
            and nxt.params["slot"] == op.params["slot"]
        )
        ctx.resize_to = _resize_target(ctx, nxt.params) if fuse else None
        apply_op(ctx, op.kind, op.params)
        ctx.resize_to = None
        i += 2 if fuse else 1


def _k_select(ctx: StageContext, p) -> None:
    b = ctx.slots[p["slot"]]
    ctx.slots[p["slot"]] = ColumnBatch(dict(p["fn"](dict(b.data))), b.valid)


def _k_where(ctx: StageContext, p) -> None:
    b = ctx.slots[p["slot"]]
    ctx.slots[p["slot"]] = b.filter(p["fn"](dict(b.data)))


def _k_project(ctx: StageContext, p) -> None:
    b = ctx.slots[p["slot"]]
    ctx.slots[p["slot"]] = b.select(p["cols"])


def _k_seed(ctx: StageContext, p) -> None:
    """A decomposable's seed: its state columns added to the batch."""
    b = ctx.slots[p["slot"]]
    ctx.slots[p["slot"]] = ColumnBatch({**b.data, **p["fn"](dict(b.data))}, b.valid)


def _k_select_many(ctx: StageContext, p) -> None:
    """Flat-map with a static factor: ``fn`` sees the columns flattened
    to ``(P * cap,)`` and returns ``(P * cap, factor)`` columns and
    validity; row r of partition q becomes rows ``r * factor ..`` of
    partition q, as in the reference's per-partition layout."""
    b = ctx.slots[p["slot"]]
    factor = int(p["factor"])
    P, cap = b.valid.shape
    n = P * cap
    out_cols, out_valid = p["fn"]({c: t.reshape(n) for c, t in b.data.items()})
    data = {}
    for name, col in out_cols.items():
        if tuple(col.shape[:2]) != (n, factor):
            raise ValueError(
                f"select_many column {name!r} must be ({n},{factor},...), got {tuple(col.shape)}"
            )
        data[name] = col.reshape((P, cap * factor) + tuple(col.shape[2:]))
    valid = (b.valid.reshape(n, 1) & out_valid).reshape(P, cap * factor)
    ctx.slots[p["slot"]] = ColumnBatch(data, valid)


def _partition_views(b: ColumnBatch):
    """One-partition ``(cap,)`` views of a batch, in partition order."""
    return [
        ColumnBatch({c: t[i] for c, t in b.data.items()}, b.valid[i])
        for i in range(b.valid.shape[0])
    ]


def _stack_partitions(outs, what: str) -> ColumnBatch:
    """One-partition batches from a user function -> one ``(P, cap)``
    batch; every partition must give the same columns and capacity, as
    the reference's traced program must."""
    cols, caps = outs[0].columns, {o.capacity for o in outs}
    if any(o.columns != cols for o in outs) or len(caps) != 1:
        raise ValueError(f"{what} fn must give every partition the same columns and capacity")
    return ColumnBatch(
        {c: torch.stack([o.data[c] for o in outs]) for c in cols},
        torch.stack([o.valid for o in outs]),
    )


def _k_apply(ctx: StageContext, p) -> None:
    """Per-partition user function over a one-partition ColumnBatch
    (with ``with_index``, also the partition's index)."""
    outs = []
    for i, view in enumerate(_partition_views(ctx.slots[p["slot"]]), ctx.base):
        out = p["fn"](view, i) if p.get("with_index") else p["fn"](view)
        if not isinstance(out, ColumnBatch):
            raise TypeError("apply fn must return a ColumnBatch")
        outs.append(out)
    ctx.slots[p["slot"]] = _stack_partitions(outs, "apply")


def _k_fork(ctx: StageContext, p) -> None:
    """Multi-output per-partition user function: each output branch
    fills one of the stage's output slots."""
    per_part = []
    for view in _partition_views(ctx.slots[p["slot"]]):
        outs = p["fn"](view)
        if len(outs) != p["n_out"]:
            raise ValueError(f"fork fn returned {len(outs)} outputs, expected {p['n_out']}")
        if not all(isinstance(o, ColumnBatch) for o in outs):
            raise TypeError("fork fn must return ColumnBatches")
        per_part.append(outs)
    for j, slot in enumerate(p["out_slots"]):
        ctx.slots[slot] = _stack_partitions([outs[j] for outs in per_part], "fork")


# -- exchanges ------------------------------------------------------------

def _fanout(ctx: StageContext, nparts) -> int:
    """Destination count of a fan-reduced exchange: rows concentrate on
    the first ``nparts`` partitions, the rest run masked-empty.  On a
    hybrid (two-axis) mesh the tree exchange ignores ``nparts``, so the
    reduction is off there outright, as in the reference: a half-applied
    one would inflate the paired resize while the rows spread
    full-width."""
    if not nparts or len(ctx.axes) != 1:
        return ctx.P
    return min(int(nparts), ctx.P)


def _exchange(ctx: StageContext, b: ColumnBatch, dest: torch.Tensor, n: int, B: int,
              axes: Tuple[str, ...], capacity: Optional[int] = None):
    """Every repartition's route (the reference's ``_exchange``): log
    the planner's accounting on ``ctx.xchg_log``, then the flat exchange
    (window 0, or one partition) or the staged one along
    ``plan_exchange(n, window, dcn)``.  ``axes``: the mesh axes the
    exchange spans (all of them, or one axis of a hybrid mesh, ``n``
    its extent); ``capacity``: the fused resize's.  Returns
    ``(batch, overflow)``."""
    if len(axes) == 2:
        dcn = ctx.axis_sizes[0]
    elif len(ctx.axes) == 2 and axes[0] == ctx.axes[0]:
        dcn = n  # over the DCN axis alone: every hop crosses
    else:
        dcn = 1
    axis = axes[0] if len(axes) < len(ctx.axes) else None
    per_row = SH.row_bytes(b)
    if ctx.window < 1 or n == 1:
        ctx.xchg_log.append(XP.flat_accounting(n, dcn, B, per_row))
        return SH.exchange(b, dest, n, B, capacity=capacity, mesh=ctx.mesh, axis=axis)
    schedule = XP.plan_exchange(n, ctx.window, dcn)
    ctx.xchg_log.extend(schedule.accounting(B, per_row))
    return SH.exchange_staged(b, dest, n, B, schedule, capacity=capacity, mesh=ctx.mesh,
                              axis=axis)


def _exchange_slot(ctx: StageContext, slot: int, dest: torch.Tensor, P_eff: int) -> None:
    """A full-width exchange of one slot over ``P_eff`` destinations,
    into the fused resize's capacity when one follows."""
    b = ctx.slots[slot]
    B = SH.bucket_capacity(b.capacity, P_eff, ctx.slack * ctx.boost)
    out, ovf = _exchange(ctx, b, dest, ctx.P, B, ctx.axes, ctx.resize_to)
    ctx.slots[slot] = out
    ctx.overflow = ctx.overflow | ovf


def _k_exchange_hash(ctx: StageContext, p) -> None:
    b = ctx.slots[p["slot"]]
    if p.get("tree") is not None and len(ctx.axes) == 2:
        _tree_exchange_hash(ctx, p["slot"], p["keys"], p["tree"])
        return
    P_eff = _fanout(ctx, p.get("nparts"))
    _exchange_slot(ctx, p["slot"], partition_ids([b.data[k] for k in p["keys"]], P_eff), P_eff)


def _tree_exchange_hash(ctx: StageContext, slot: int, keys, tree) -> None:
    """Hierarchical shuffle on a hybrid mesh (the reference's
    ``_tree_exchange_hash``): rows for global partition g first move
    within their slice to ICI index ``g % P_ici``, resized to
    ``round8(cap * slack)``; duplicate keys combine there (``distinct``,
    ``group_combine`` or ``group_reduce``, as the plan's tree spec
    says); only the per-slice partials then cross to slice
    ``g // P_ici``.  The plan's resize after the exchange is fused into
    that DCN hop only."""
    D, P_in = ctx.axis_sizes
    slack = ctx.slack * ctx.boost

    def dest_global(batch):
        return partition_ids([batch.data[k] for k in keys], ctx.P)

    # hop 1: within each slice, to ICI index g % P_in
    b = ctx.slots[slot]
    B1 = SH.bucket_capacity(b.capacity, P_in, slack)
    out, ovf = _exchange(ctx, b, dest_global(b) % P_in, P_in, B1, (ctx.axes[1],),
                         capacity=_round8(b.capacity * ctx.slack))
    ctx.overflow = ctx.overflow | ovf
    # the per-slice combine
    if tree.get("distinct"):
        out = SEG.distinct(out, tree["keys"])
    elif "merge" in tree:
        out = SEG.group_combine(out, tree["keys"], tree["state_cols"], tree["merge"])
    else:
        out = SEG.group_reduce(out, tree["keys"], tree["aggs"])
    # hop 2: across the slices, to slice g // P_in
    B2 = SH.bucket_capacity(out.capacity, D, slack)
    out2, ovf = _exchange(ctx, out, dest_global(out) // P_in, D, B2, (ctx.axes[0],),
                          ctx.resize_to)
    ctx.overflow = ctx.overflow | ovf
    ctx.slots[slot] = out2


def _k_exchange_range(ctx: StageContext, p) -> None:
    """Range exchange.  The splitter sample count is ``sample_rate`` of
    the partition, clamped to [16, 512]; rate and clamp scale with the
    boost, so an overflow retry also elects better splitters.  With
    ``spread`` (order_by) the splitters are elected over every sort
    operand plus a uniform tiebreak word, so a heavy key's run is cut
    across partitions; range_partition keeps strict splitters over the
    primary operand, so equal keys share a partition."""
    b = ctx.slots[p["slot"]]
    operands = p["operands_fn"](b)
    rate = float(p.get("rate", 0.001)) * ctx.boost
    m = int(min(512 * ctx.boost, max(16 * ctx.boost, b.capacity * rate)))
    P_eff = _fanout(ctx, p.get("nparts"))
    if p.get("spread"):
        words = list(operands) + [SORT.spread_word(b.capacity, b.device).expand_as(b.valid)]
        splitters = SORT.sample_splitters_multi(words, b.valid, P_eff, m, ctx.mesh)
        dest = SORT.range_dest_multi(words, splitters)
    else:
        splitters = SORT.sample_splitters(operands[0], b.valid, P_eff, m, ctx.mesh)
        dest = SORT.range_dest(operands[0], splitters)
    _exchange_slot(ctx, p["slot"], dest, P_eff)


def _resize_target(ctx: StageContext, p) -> int:
    """Post-shuffle capacity: entry capacity x growth x retry boost x
    slack, scaled by P / P_eff after a fan-reduced exchange."""
    conc = ctx.P / _fanout(ctx, p.get("nparts"))
    return _round8(ctx.base_cap(p["slot"]) * p["factor"] * conc * ctx.boost * ctx.slack)


def _k_resize(ctx: StageContext, p) -> None:
    slot = p["slot"]
    out, ovf = SH.resize(ctx.slots[slot], _resize_target(ctx, p))
    ctx.slots[slot] = out
    ctx.overflow = ctx.overflow | ovf


# Op kinds whose kernels never set the overflow flag: the executor reads
# the flag only of stages holding another kind.
NON_OVERFLOW_OPS = frozenset({
    "select", "where", "project", "select_many", "apply", "fork",
    "group_reduce", "group_combine", "group_reduce_dense", "distinct",
    "local_sort", "concat", "scalar_agg", "topk", "string_code",
})


# -- grouping / sorting ------------------------------------------------------

def _k_group_reduce(ctx: StageContext, p) -> None:
    b = ctx.slots[p["slot"]]
    ctx.slots[p["slot"]] = SEG.group_reduce(b, p["keys"], p["aggs"])


def _k_group_combine(ctx: StageContext, p) -> None:
    b = ctx.slots[p["slot"]]
    ctx.slots[p["slot"]] = SEG.group_combine(b, p["keys"], p["state_cols"], p["merge"])


def _k_distinct(ctx: StageContext, p) -> None:
    b = ctx.slots[p["slot"]]
    ctx.slots[p["slot"]] = SEG.distinct(b, p["keys"])


def _k_local_sort(ctx: StageContext, p) -> None:
    b = ctx.slots[p["slot"]]
    ctx.slots[p["slot"]] = SORT.sort_batch_by_operands(b, p["operands_fn"](b))


def _kernel_value(v: torch.Tensor) -> torch.Tensor:
    """A value column as the bucket kernel takes it: int32 and float32
    as they are; BOOL and UINT32 (int64 carrier) as float32, the same
    rounding the reference applies inside its kernel."""
    if v.dtype not in (torch.int32, torch.float32):
        v = v.to(torch.float32)
    return v.contiguous()


def _k_group_reduce_dense(ctx: StageContext, p) -> None:
    """Dense-key GroupBy: per-partition bucket tables from the Hopper
    kernel (``ops/bucket.py``), then the reduce-scatter over partitions.

    Output partition i holds buckets ``[i*per, (i+1)*per)``.  Each
    partition's f32 counts are exact (capacity guard below) and are
    rounded to int32 BEFORE the sum over partitions, so global counts
    stay exact past 2^24.  SUM columns stay f32 end to end."""
    b = ctx.slots[p["slot"]]
    if b.capacity > (1 << 24):
        raise ValueError(
            f"dense group_by: partition capacity {b.capacity} exceeds the "
            "f32-exact accumulation range (2^24 rows/partition); use the "
            "sort-based group_by path"
        )
    if ctx.P * b.capacity > 0x7FFFFFFF:
        raise ValueError(
            f"dense group_by: global capacity {ctx.P * b.capacity} exceeds "
            "the int32 count range; use the sort-based group_by path"
        )
    K = int(p["num_buckets"])
    per = max(1, -(-K // ctx.P))
    Kp = per * ctx.P
    key = b.data[p["key"]]
    in_range = b.valid & (key >= 0) & (key < K)
    if p.get("guard"):
        ctx.dict_miss = ctx.dict_miss + (b.valid & ~in_range).sum()

    val_cols = []
    for a in p["aggs"]:
        if a.op in ("sum", "mean") and a.col not in val_cols:
            val_cols.append(a.col)
    vals = [_kernel_value(b.data[c]) for c in val_cols]
    sums, cnt = bucket_sum_count(key.contiguous(), vals, in_range.contiguous(), Kp)
    cnt = PART.psum_scatter(torch.round(cnt).to(torch.int32), ctx.mesh)  # (local, per)
    by_col = {c: PART.psum_scatter(s, ctx.mesh) for c, s in zip(val_cols, sums)}

    me = PART.axis_index(ctx.P, key.device, ctx.mesh)
    codes = me * per + torch.arange(per, device=key.device)  # (local, per) int64
    decode = p.get("decode")
    if decode is None:
        out: Dict[str, torch.Tensor] = {p["key"]: codes.to(key.dtype)}
    else:
        words = decode.slice_rows(me * per, per, operands=ctx.operand(decode))
        okey = p["out_key"]
        out = {
            f"{okey}#{w}": words[..., i]
            for i, w in enumerate(("h0", "h1", "r0", "r1"))
        }
    for a in p["aggs"]:
        if a.op == "count":
            out[a.out] = cnt
        elif a.op == "sum":
            s = by_col[a.col]
            dt = b.data[a.col].dtype
            out[a.out] = (
                torch.round(s).to(dt) if not dt.is_floating_point else s.to(dt)
            )
        elif a.op == "mean":
            out[a.out] = by_col[a.col] / cnt.clamp(min=1).to(torch.float32)
        else:  # guarded at the API layer
            raise ValueError(f"dense group_by cannot compute {a.op!r}")
    valid = (cnt > 0) & (codes < K)
    ctx.slots[p["slot"]] = ColumnBatch(out, valid)


def _k_string_code(ctx: StageContext, p) -> None:
    """Map a STRING column's Hash64 words to dense dictionary codes;
    misses map past the code domain and are counted for the executor's
    deferred failure."""
    b = ctx.slots[p["slot"]]
    table = p["table"]
    codes = table.lookup(b.data[p["h0"]], b.data[p["h1"]], operands=ctx.operand(table))
    # apart: a call on an expression naming the table reads as a table call (operand-registry)
    bound = table.num_codes_padded
    miss = (b.valid & (codes >= bound)).sum()
    ctx.dict_miss = ctx.dict_miss + miss
    ctx.slots[p["slot"]] = b.with_column(p["out"], codes)


def _k_topk(ctx: StageContext, p) -> None:
    """Fused OrderBy+Take(n): per-partition local sort, the P heads
    gathered, one sort of the gathered heads, and partition i keeps
    rows ``[i*n_pad, (i+1)*n_pad)`` of that order, those past n invalid.
    The reference sorts the gathered heads on every device; every
    partition would hold the same array, so here it is sorted once a
    rank."""
    b = ctx.slots[p["slot"]]
    sb = SORT.sort_batch_by_operands(b, p["operands_fn"](b))
    n = int(p["n"])
    n_pad = min(b.capacity, max(8, _round8(n)))
    head = ColumnBatch(
        {c: v[:, :n_pad] for c, v in sb.data.items()}, sb.valid[:, :n_pad]
    )
    gb = ColumnBatch(
        {c: PART.all_gather(v, ctx.mesh)[:1] for c, v in head.data.items()},
        PART.all_gather(head.valid, ctx.mesh)[:1],
    )  # one (1, P * n_pad) copy of every partition's view
    gsb = SORT.sort_batch_by_operands(gb, p["operands_fn"](gb))
    P = ctx.P
    pos = torch.arange(P * n_pad, device=b.device).reshape(P, n_pad)
    mine = lambda v: PART.local_rows(v.reshape(P, n_pad), ctx.mesh)
    data = {c: mine(v) for c, v in gsb.data.items()}
    valid = mine(gsb.valid.reshape(P, n_pad) & (pos < n))
    ctx.slots[p["slot"]] = ColumnBatch(data, valid)


# -- multi-input -------------------------------------------------------------

def _join_strategy(ctx: StageContext, p, right: ColumnBatch) -> bool:
    """True -> broadcast the right side; False -> co-hash-partition.
    With ``strategy="auto"`` the plan's static row bound of the right
    side decides when there is one, else its total capacity (both known
    before the stage runs, as the reference decides at trace time)."""
    strategy = p.get("strategy", "shuffle")
    if strategy == "broadcast":
        return True
    if strategy == "auto":
        limit = p.get("broadcast_limit", 1 << 16)
        est = p.get("est_right")
        if est is not None:
            return est <= limit
        return right.capacity * ctx.P <= limit
    return False


def _exchange_hash_resized(ctx: StageContext, slot: int, keys) -> None:
    """``exchange_hash`` then ``resize(factor=1.0)`` of one slot, run as
    one placement (see :func:`run_ops`)."""
    ctx.resize_to = _resize_target(ctx, dict(slot=slot, factor=1.0))
    b = ctx.slots[slot]
    _exchange_slot(ctx, slot, partition_ids([b.data[k] for k in keys], ctx.P), ctx.P)
    ctx.resize_to = None


def _co_partition_for_join(ctx: StageContext, p) -> None:
    """Hash-exchange whichever sides the plan found not partitioned on
    the join keys (deferred from lowering when the strategy is
    decided at run time)."""
    if p.get("need_left_exchange"):
        _exchange_hash_resized(ctx, p["left_slot"], p["left_keys"])
    if p.get("need_right_exchange"):
        _exchange_hash_resized(ctx, p["right_slot"], p["right_keys"])


def _apply_join_strategy(ctx: StageContext, p) -> int:
    """Run the chosen placement (replicate the right side, or the
    deferred co-partition exchanges) and return the capacity base that
    sizes the candidate-pair buffer: the sides' capacities BEFORE a
    broadcast (replication multiplies the right capacity by P, not the
    match count)."""
    base = max(ctx.slots[p["left_slot"]].capacity, ctx.slots[p["right_slot"]].capacity)
    if "strategy" in p:
        if _join_strategy(ctx, p, ctx.slots[p["right_slot"]]):
            right = ctx.slots[p["right_slot"]]
            est = p.get("est_right")
            if est is not None:
                # a row-bounded right side shrinks to its bound first, so
                # the replica is not P x its capacity (cannot overflow:
                # a partition's rows <= all rows <= est)
                tight = _round8(min(right.capacity, max(8, int(est))))
                if tight < right.capacity:
                    right, ovf = SH.resize(right, tight)
                    ctx.overflow = ctx.overflow | ovf
            ctx.slots[p["right_slot"]] = PART.gather_batch(right, ctx.mesh)
        else:
            _co_partition_for_join(ctx, p)
            base = max(
                ctx.slots[p["left_slot"]].capacity, ctx.slots[p["right_slot"]].capacity
            )
    return base


def _join_sides(ctx: StageContext, p) -> Tuple[ColumnBatch, ColumnBatch, int]:
    """Placement, then (left, right, pair capacity)."""
    base = _apply_join_strategy(ctx, p)
    cap = _round8(base * p["expansion"] * ctx.boost)
    return ctx.slots[p["left_slot"]], ctx.slots[p["right_slot"]], cap


def _k_join(ctx: StageContext, p) -> None:
    left, right, out_cap = _join_sides(ctx, p)
    if p.get("outer"):
        out, ovf = J.hash_join_outer(
            left, right, p["left_keys"], p["right_keys"], out_cap,
            p.get("right_defaults") or {}, p.get("suffix", "_r"),
        )
    else:
        out, ovf = J.hash_join(
            left, right, p["left_keys"], p["right_keys"], out_cap, p.get("suffix", "_r")
        )
    ctx.slots[p["left_slot"]] = out
    ctx.overflow = ctx.overflow | ovf


def _k_semi(ctx: StageContext, p) -> None:
    left, right, cap = _join_sides(ctx, p)
    mask, ovf = J.exists_mask(left, right, p["left_keys"], p["right_keys"], cap)
    if p.get("negate"):
        mask = ~mask
    ctx.slots[p["left_slot"]] = left.filter(mask)
    ctx.overflow = ctx.overflow | ovf


def _k_concat(ctx: StageContext, p) -> None:
    batches = [ctx.slots[s] for s in p["slots"]]
    names = sorted(set(batches[0].columns))
    ctx.slots[p["out_slot"]] = ColumnBatch.concatenate([b.select(names) for b in batches])


def _k_group_join_count(ctx: StageContext, p) -> None:
    left, right, cap = _join_sides(ctx, p)
    counts, ovf = J.group_join_counts(left, right, p["left_keys"], p["right_keys"], cap)
    ctx.slots[p["left_slot"]] = left.with_column(p["out"], counts)
    ctx.overflow = ctx.overflow | ovf


def _k_join_ranked(ctx: StageContext, p) -> None:
    """Inner join emitting each pair's group-local match rank (full
    GroupJoin's enumerable group).  At the retry ladder's last rung the
    ``rank_limit`` window clamp drops away."""
    left, right, out_cap = _join_sides(ctx, p)
    operands_fn = p.get("operands_fn")
    operands = operands_fn(right) if operands_fn is not None else ()
    out, ovf = J.hash_join_ranked(
        left, right, p["left_keys"], p["right_keys"], out_cap,
        p.get("suffix", "_r"), p["rank_out"], operands,
        rank_limit=p.get("rank_limit"), boost=ctx.boost,
        final_attempt=ctx.boost >= p.get("rank_limit_max_boost", 1 << 30),
    )
    ctx.slots[p["left_slot"]] = out
    ctx.overflow = ctx.overflow | ovf


# -- global (rank) ops ------------------------------------------------------------

RANK_NONE = 0xFFFFFFFF  # the rank of an invalid row


def _rank_column(b: ColumnBatch, ctx: StageContext) -> Tuple[ColumnBatch, torch.Tensor]:
    """Compact each partition and attach every valid row's global rank
    in partition-major order as ``#rank`` (uint32 values on the int64
    carrier, ``RANK_NONE`` on invalid rows); also the total row count."""
    c = b.compact()
    # the reference's ranks are uint32: guard the global capacity
    if ctx.P * c.capacity >= 0xFFFFFFFF:
        raise ValueError(
            f"rank-based operator: global capacity {ctx.P * c.capacity} "
            "exceeds the uint32 rank range (4.29e9 rows)"
        )
    local = c.valid.sum(-1, dtype=torch.int64)
    offset, total = PART.exclusive_prefix(local, ctx.mesh)  # rows of earlier partitions
    pos = torch.arange(c.capacity, device=c.device)
    rank = torch.where(c.valid, offset[:, None] + pos, RANK_NONE)
    return ColumnBatch(dict(c.data, **{"#rank": rank}), c.valid), total


def _strip_rank(b: ColumnBatch, keep: torch.Tensor) -> ColumnBatch:
    return ColumnBatch({n: c for n, c in b.data.items() if n != "#rank"}, keep)


def _k_with_rank(ctx: StageContext, p) -> None:
    """Attach each row's global engine-order rank as an int32 column."""
    b, _total = _rank_column(ctx.slots[p["slot"]], ctx)
    out = {n: c for n, c in b.data.items() if n != "#rank"}
    out[p["out"]] = torch.where(b.valid, b.data["#rank"], 0).to(torch.int32)
    ctx.slots[p["slot"]] = ColumnBatch(out, b.valid)


def _k_take(ctx: StageContext, p) -> None:
    """The first n rows of global engine order."""
    b, _total = _rank_column(ctx.slots[p["slot"]], ctx)
    ctx.slots[p["slot"]] = _strip_rank(b, b.valid & (b.data["#rank"] < int(p["n"])))


def _k_skip(ctx: StageContext, p) -> None:
    """Drop the first n rows of global engine order."""
    b, _total = _rank_column(ctx.slots[p["slot"]], ctx)
    ctx.slots[p["slot"]] = _strip_rank(b, b.valid & (b.data["#rank"] >= int(p["n"])))


def _k_tail(ctx: StageContext, p) -> None:
    """Keep the last n rows of global engine order."""
    b, total = _rank_column(ctx.slots[p["slot"]], ctx)
    cut = torch.clamp(total - int(p["n"]), min=0)
    ctx.slots[p["slot"]] = _strip_rank(b, b.valid & (b.data["#rank"] >= cut))


def _cut_at_first_failure(ctx: StageContext, p, before: bool) -> None:
    """Rows before (TakeWhile) or from (SkipWhile) the first valid row,
    in global engine order, that fails the predicate."""
    b, total = _rank_column(ctx.slots[p["slot"]], ctx)
    pred = p["fn"]({n: c for n, c in b.data.items() if n != "#rank"})
    rank = b.data["#rank"]
    first = PART.allreduce(torch.where(b.valid & ~pred, rank, RANK_NONE).amin(), "min", ctx.mesh)
    cut = torch.minimum(first, total)
    ctx.slots[p["slot"]] = _strip_rank(b, b.valid & ((rank < cut) if before else (rank >= cut)))


def _k_take_while(ctx: StageContext, p) -> None:
    _cut_at_first_failure(ctx, p, before=True)


def _k_skip_while(ctx: StageContext, p) -> None:
    _cut_at_first_failure(ctx, p, before=False)


def _exchange_by_rank(ctx: StageContext, b: ColumnBatch, per: int) -> ColumnBatch:
    """Repartition so global rank r lands on partition ``r // per``, each
    partition sorted by rank (position i holds rank ``pid * per + i``):
    the hash exchange's placement into a ``per``-row layout, whose
    bucket and resize overflows set the flag, then a sort by rank."""
    dest = torch.clamp(b.data["#rank"] // per, 0, ctx.P - 1)
    B = SH.bucket_capacity(b.capacity, ctx.P, ctx.slack * ctx.boost)
    out, ovf = _exchange(ctx, b, dest, ctx.P, B, ctx.axes, capacity=per)
    ctx.overflow = ctx.overflow | ovf
    return SORT.sort_batch_by_operands(out, [out.data["#rank"]])


def _k_reverse(ctx: StageContext, p) -> None:
    """Globally reverse engine row order: invert each row's global rank
    and repartition by it."""
    b, total = _rank_column(ctx.slots[p["slot"]], ctx)
    inv = torch.where(b.valid, (total - 1) - b.data["#rank"], RANK_NONE)
    b = ColumnBatch(dict(b.data, **{"#rank": inv}), b.valid)
    out = _exchange_by_rank(ctx, b, _round8(ctx.base_cap(p["slot"]) * ctx.boost))
    ctx.slots[p["slot"]] = _strip_rank(out, out.valid)


def _k_default_if_empty(ctx: StageContext, p) -> None:
    """If the table is empty, one row of defaults on partition 0."""
    b = ctx.slots[p["slot"]].compact()
    emit = ~PART.any_(b.valid, ctx.mesh)
    first = torch.zeros_like(b.valid)
    # global partition 0 only; a fill, not a copy of a host scalar
    # (capture-safe)
    first[0, 0].fill_(ctx.base == 0)
    first = first & emit
    data = {}
    for name, col in b.data.items():
        # filled on the device (no host tensor crosses: capture-safe)
        v = p["defaults"].get(name, 0)
        v = float(v) if col.dtype.is_floating_point else bool(v) if col.dtype == torch.bool else int(v)
        dflt = torch.full((), v, dtype=col.dtype, device=col.device)
        data[name] = torch.where(first, dflt, col)
    ctx.slots[p["slot"]] = ColumnBatch(data, b.valid | first)


def _k_zip(ctx: StageContext, p) -> None:
    """Pair rows by global position (LINQ Zip: the shorter side's
    length): both sides exchanged by rank into the same layout."""
    per = _round8(max(ctx.base_cap(p["left_slot"]), ctx.base_cap(p["right_slot"])) * ctx.boost)
    lb, _ = _rank_column(ctx.slots[p["left_slot"]], ctx)
    rb, _ = _rank_column(ctx.slots[p["right_slot"]], ctx)
    la = _exchange_by_rank(ctx, lb, per)
    ra = _exchange_by_rank(ctx, rb, per)
    data = {n: c for n, c in la.data.items() if n != "#rank"}
    for n, c in ra.data.items():
        if n != "#rank":
            data[J._suffixed(n, p["suffix"]) if n in data else n] = c
    ctx.slots[p["left_slot"]] = ColumnBatch(data, la.valid & ra.valid)


def _k_sliding_window(ctx: StageContext, p) -> None:
    """Windows of ``size`` consecutive rows over the global sequence:
    columns ``{c}_w{j}``.  Each compacted partition is extended by a
    halo, the next ``size - 1`` valid rows of the partitions after it in
    global order (empty partitions between included), written right
    after its own valid rows: the rows the reference's ring of
    ``ppermute`` hops brings to each device."""
    b = ctx.slots[p["slot"]].compact()
    w = int(p["size"])
    need = w - 1
    P, cap = ctx.P, b.capacity
    n_loc = b.valid.sum(-1)
    ext_v = torch.nn.functional.pad(b.valid, (0, max(need, 0)))
    ext = {c: torch.nn.functional.pad(b.data[c], (0, max(need, 0))) for c in p["cols"]}
    if need > 0 and P > 1:
        k = min(need, cap)  # each partition's prefix, as the reference ships it

        def arrivals(x):  # hop h brings partition i the prefix of i + h (none past the end)
            g = PART.gather_rows(x[:, :k], ctx.mesh)  # every partition's prefix
            hops = [torch.nn.functional.pad(g[h:], (0, 0, 0, h)) for h in range(1, P)]
            return PART.local_rows(torch.cat(hops, -1), ctx.mesh)

        arr_v = arrivals(b.valid)
        order = torch.sort((~arr_v).to(torch.uint8), dim=-1, stable=True)[1][:, :need]
        at = n_loc[:, None] + torch.arange(order.shape[-1], device=b.device)
        ext_v = ext_v.scatter(-1, at, arr_v.gather(-1, order))
        for c in p["cols"]:
            ext[c] = ext[c].scatter(-1, at, arrivals(b.data[c]).gather(-1, order))
    win_valid = torch.ones_like(b.valid)
    for j in range(w):
        win_valid = win_valid & ext_v[:, j : j + cap]
    out = {f"{c}_w{j}": ext[c][:, j : j + cap] for c in p["cols"] for j in range(w)}
    ctx.slots[p["slot"]] = ColumnBatch(out, win_valid)


# -- scalar aggregates ---------------------------------------------------------

def _extreme(dtype: torch.dtype, op: str):
    """Identity of a min (``"min"``) or max over ``dtype``: +-inf for
    float32, the type's bounds for int32 and the uint32 carrier."""
    if dtype == torch.float32:
        return float("inf") if op == "min" else float("-inf")
    if dtype == WORD:
        return MASK32 if op == "min" else 0
    bounds = torch.iinfo(torch.int32)
    return bounds.max if op == "min" else bounds.min


def _global_pair_reduce(op: str, b: ColumnBatch, lo_col: str, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-table 64-bit reduce of a split column: each partition's
    pair, then the P partial pairs (gathered over the mesh) reduced the
    same way (all-invalid partitions give the identity pair), as the
    reference."""
    hi_col = lo_col[: -len("#h0")] + "#h1"
    plo, phi = SEG.pair_scalar_reduce(op, b.data[lo_col], b.data[hi_col], b.valid)
    plo, phi = PART.gather_rows(plo, mesh), PART.gather_rows(phi, mesh)
    return SEG.pair_scalar_reduce(op, plo, phi, torch.ones_like(plo, dtype=torch.bool))


def _scalar_sum(col: torch.Tensor, v: torch.Tensor, mesh) -> torch.Tensor:
    """Sum of the valid values: float32 by integer accumulation
    (``ops/segmented.py::f32_total``), int32 mod 2^32 as the
    reference's int32 sums wrap, uint32 words mod 2^32."""
    if col.dtype == torch.float32:
        return SEG.f32_total(col, v, mesh)
    s = PART.allreduce(torch.where(v, col.to(torch.int64), 0).sum(), "sum", mesh)
    if col.dtype == WORD:
        return s & MASK32
    return (((s + (1 << 31)) & MASK32) - (1 << 31)).to(torch.int32)


def _k_scalar_agg(ctx: StageContext, p) -> None:
    """Whole-table aggregates: one output row, valid on partition 0
    (every partition holds the value, as after the reference's
    ``psum``).  Float32 sums and means are the same bytes on every run
    and device; their difference from the reference's summation order
    is rounding only."""
    b = ctx.slots[p["slot"]]
    v = b.valid
    mesh = ctx.mesh
    one = lambda x: x.reshape(1, 1).expand(v.shape[0], 1)
    count = lambda: PART.allreduce(v.sum(dtype=torch.int64), "sum", mesh)
    out: Dict[str, torch.Tensor] = {}
    for a in p["aggs"]:
        if a.op == "count":
            out[a.out] = one(count().to(torch.int32))
        elif a.op == "sum":
            out[a.out] = one(_scalar_sum(b.data[a.col], v, mesh))
        elif a.op in ("min", "max"):
            col = b.data[a.col]
            masked = torch.where(v, col, _extreme(col.dtype, a.op))
            red = masked.amin() if a.op == "min" else masked.amax()
            out[a.out] = one(PART.allreduce(red, a.op, mesh))
        elif a.op == "mean":
            s = SEG.f32_total(b.data[a.col].to(torch.float32), v, mesh)
            out[a.out] = one(s / torch.clamp(count().to(torch.float32), min=1.0))
        elif a.op == "mean64":
            tlo, thi = _global_pair_reduce("sum64", b, a.col, mesh)
            c = count().to(torch.float32)
            out[a.out] = one(SEG.pair_to_f32(tlo, thi) / torch.clamp(c, min=1.0))
        elif a.op in SEG.PAIR_OPS:
            tlo, thi = _global_pair_reduce(a.op, b, a.col, mesh)
            out[f"{a.out}#h0"] = one(tlo)
            out[f"{a.out}#h1"] = one(thi)
        elif a.op == "any":
            out[a.out] = one(PART.any_(v & b.data[a.col], mesh))
        elif a.op == "all":
            out[a.out] = one(~PART.any_(~torch.where(v, b.data[a.col], True), mesh))
        else:
            raise ValueError(f"unknown scalar agg {a.op!r}")
    valid = PART.axis_index(ctx.P, v.device, mesh) == 0
    ctx.slots[p["slot"]] = ColumnBatch(out, valid)


# (op kind, param) pairs whose tables travel as device operands
# (``ctx.operand``): the executor's operand cache keys them by their
# shape tier (``operand_signature``), not their content, so every table
# of a tier shares one key, as the reference's compile key does.  A
# plain literal: graftlint's ``operand-registry`` rule reads it.
OPERAND_PARAMS = frozenset({
    ("string_code", "table"),
    ("group_reduce_dense", "decode"),
})

_KERNELS = {
    "select": _k_select,
    "where": _k_where,
    "project": _k_project,
    "seed": _k_seed,
    "select_many": _k_select_many,
    "apply": _k_apply,
    "fork": _k_fork,
    "group_combine": _k_group_combine,
    "take_while": _k_take_while,
    "skip_while": _k_skip_while,
    "reverse": _k_reverse,
    "default_if_empty": _k_default_if_empty,
    "zip": _k_zip,
    "sliding_window": _k_sliding_window,
    "group_reduce_dense": _k_group_reduce_dense,
    "string_code": _k_string_code,
    "topk": _k_topk,
    "exchange_hash": _k_exchange_hash,
    "exchange_range": _k_exchange_range,
    "resize": _k_resize,
    "group_reduce": _k_group_reduce,
    "distinct": _k_distinct,
    "local_sort": _k_local_sort,
    "join": _k_join,
    "semi": _k_semi,
    "concat": _k_concat,
    "group_join_count": _k_group_join_count,
    "join_ranked": _k_join_ranked,
    "with_rank": _k_with_rank,
    "take": _k_take,
    "skip": _k_skip,
    "tail": _k_tail,
    "scalar_agg": _k_scalar_agg,
}
