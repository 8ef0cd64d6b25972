"""Per-partition stage ops over ``(P, cap)`` batches.

The counterpart of ``dryad_tpu/exec/kernels.py`` for the op kinds of the
ported path: ``select``, ``where``, ``project``, ``string_code``,
``group_reduce_dense`` and ``topk``.  The reference composes them into
one traced SPMD program per stage; PyTorch runs eagerly, so each op
runs as it is applied, on all P partitions at once.  Collectives are
the partition layer's tensor ops (``parallel/partition.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from dryad_tpu_torch.columnar.batch import ColumnBatch
from dryad_tpu_torch.ops import sort as SORT
from dryad_tpu_torch.ops.bucket import bucket_sum_count
from dryad_tpu_torch.parallel import partition as PART


def _round8(n: float) -> int:
    return max(8, int(math.ceil(n / 8.0)) * 8)


class StageContext:
    """Mutable state while running one stage: its slots, and the
    deferred counters the executor reads once after the job."""

    def __init__(self, P: int, device, tables=None):
        self.P = P
        self.device = torch.device(device)
        self.tables = tables  # exec.operands.DeviceTables
        self.slots: Dict[int, ColumnBatch] = {}
        # the exchange's overflow flag; no op of the ported path sets it
        self.overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        # rows whose dense key missed its domain (STRING words absent
        # from the dictionary, INT32 keys past the ingest range)
        self.dict_miss = torch.zeros((), dtype=torch.int64, device=self.device)

    def bind_inputs(self, batches: Tuple[ColumnBatch, ...]) -> None:
        for i, b in enumerate(batches):
            self.slots[i] = b

    def operand(self, obj) -> Tuple[torch.Tensor, ...]:
        """Device tensors of a coding table (uploaded once per context)."""
        return self.tables.get(obj)


def apply_op(ctx: StageContext, kind: str, p: Dict[str, Any]) -> None:
    fn = _KERNELS.get(kind)
    if fn is None:
        raise NotImplementedError(f"no kernel for stage op {kind!r}")
    fn(ctx, p)


def _k_select(ctx: StageContext, p) -> None:
    b = ctx.slots[p["slot"]]
    ctx.slots[p["slot"]] = ColumnBatch(dict(p["fn"](dict(b.data))), b.valid)


def _k_where(ctx: StageContext, p) -> None:
    b = ctx.slots[p["slot"]]
    ctx.slots[p["slot"]] = b.filter(p["fn"](dict(b.data)))


def _k_project(ctx: StageContext, p) -> None:
    b = ctx.slots[p["slot"]]
    ctx.slots[p["slot"]] = b.select(p["cols"])


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
    cnt = PART.psum_scatter(torch.round(cnt).to(torch.int32))  # (P, per)
    by_col = {c: PART.psum_scatter(s) for c, s in zip(val_cols, sums)}

    me = PART.axis_index(ctx.P, key.device)
    codes = me * per + torch.arange(per, device=key.device)  # (P, per) int64
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
    miss = (b.valid & (codes >= table.num_codes_padded)).sum()
    ctx.dict_miss = ctx.dict_miss + miss
    ctx.slots[p["slot"]] = b.with_column(p["out"], codes)


def _k_topk(ctx: StageContext, p) -> None:
    """Fused OrderBy+Take(n): per-partition local sort, the P heads
    gathered, one sort of the gathered heads, and partition i keeps
    rows ``[i*n_pad, (i+1)*n_pad)`` of that order, those past n invalid.
    The reference sorts the gathered heads on every device; every
    partition would hold the same array, so here it is sorted once."""
    b = ctx.slots[p["slot"]]
    sb = SORT.sort_batch_by_operands(b, p["operands_fn"](b))
    n = int(p["n"])
    n_pad = min(b.capacity, max(8, _round8(n)))
    head = ColumnBatch(
        {c: v[:, :n_pad] for c, v in sb.data.items()}, sb.valid[:, :n_pad]
    )
    gb = ColumnBatch(
        {c: PART.all_gather(v)[:1] for c, v in head.data.items()},
        PART.all_gather(head.valid)[:1],
    )  # one (1, P * n_pad) copy of every partition's view
    gsb = SORT.sort_batch_by_operands(gb, p["operands_fn"](gb))
    P = ctx.P
    pos = torch.arange(P * n_pad, device=b.device).reshape(P, n_pad)
    data = {c: v.reshape(P, n_pad) for c, v in gsb.data.items()}
    valid = gsb.valid.reshape(P, n_pad) & (pos < n)
    ctx.slots[p["slot"]] = ColumnBatch(data, valid)


_KERNELS = {
    "select": _k_select,
    "where": _k_where,
    "project": _k_project,
    "group_reduce_dense": _k_group_reduce_dense,
    "string_code": _k_string_code,
    "topk": _k_topk,
}
