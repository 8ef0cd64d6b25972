"""Segmented (group-by) reduction over sorted rows.

The counterpart of ``dryad_tpu/ops/segmented.py``: ``group_reduce``
sorts each partition's rows by key, marks segment starts, and reduces
every segment; ``distinct`` keeps each segment's first row.  Every
function works along the last axis of ``(P, cap)`` batches.

Output rows, keys and counts are the reference's byte for byte.  How
each aggregate is reduced:

- counts come from one scatter of segment-start positions, as in the
  reference;
- integer sums, min/max, any/all and the 64-bit pair ops
  (``sum64``/``min64``/``max64`` over split ``(lo, hi)`` words) are
  integer scatters, whose result does not depend on the order the
  device applies them in.  ``sum64`` adds the low and high words
  apart and carries, so nothing overflows; ``min64``/``max64`` compare
  the pair as one signed int64.  The reference gets the same values
  from a segmented scan;
- float32 min/max reduce the order-preserving uint32 image of each
  value (``to_sortable_u32``), so they are integer scatters too; a
  segment holding a NaN gives NaN, as the reference's ``segment_min``/
  ``segment_max`` do;
- float32 sums and means never use float atomics (their rounding would
  change from run to run on CUDA).  Each value is scaled to a 64-bit
  integer against its segment's largest exponent, the integers are
  summed (exactly, in any order), and the total is scaled back and
  rounded once.  The result is the same on every run and device, and
  differs from the reference's f32 summation only by rounding: within
  ``n_g * 2^-23 * sum |v|`` for a group of ``n_g`` values.

``group_combine`` reduces each segment with a user's associative
``merge`` (the decomposable aggregates): a flagged segmented scan
through :func:`associative_scan`, which copies JAX's own recursion
(``lax.associative_scan``), so every merge sees the operands the
reference's sees and float states come out with the same bytes.

``group_reduce_fused`` is the reference's opt-in sort path
(``DRYAD_TPU_SORT_FUSED=1`` routes ``group_reduce`` to it; off by
default, as there): one multi-channel flagged segmented scan through
:func:`associative_scan`, counts from the positions of each segment's
last row, and every output bitcast to a 32-bit word and written by one
stacked scatter.  Float sums and means there are the reference's fused
path byte for byte (the same f32 additions in JAX's scan order, with
subnormals flushed as its backends flush them), not the fixed-point
sums above.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from dryad_tpu_torch.columnar.batch import DUMP, MASK32, WORD, ColumnBatch, row_cumsum
from dryad_tpu_torch.ops.sort import sort_batch_by_operands
from dryad_tpu_torch.parallel import partition as PART
from dryad_tpu_torch.ops.sortkeys import (
    SIGN32,
    flush_subnormal,
    keys_equal_adjacent,
    to_sortable_u32,
)


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One built-in aggregation over a physical column.

    op: sum | count | min | max | mean | any | all | first, and the
    64-bit pair ops sum64 | min64 | max64 (``col`` names the low word)
    col: input physical column (None for count)
    out: output physical column name
    """

    op: str
    col: Optional[str]
    out: str


PAIR_OPS = ("sum64", "min64", "max64")
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def _dump(cap: int, device) -> torch.Tensor:
    """Where rows outside any segment (invalid rows; non-first rows of a
    first-row scatter) land: DUMP slots past the ``cap`` segments."""
    return cap + torch.arange(cap, device=device) % DUMP


def _segment_layout(
    batch: ColumnBatch, key_cols: Sequence[str]
) -> Tuple[ColumnBatch, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort each partition by its keys (valid rows first); return
    ``(sorted batch, valid, start, seg, nseg)``.  ``seg`` maps each row to
    its segment id, invalid rows to the dump slots past ``cap``."""
    cap = batch.capacity
    sb = sort_batch_by_operands(
        batch, [to_sortable_u32(batch.data[k]) for k in key_cols]
    )
    v = sb.valid
    start = v & ~keys_equal_adjacent([sb.data[k] for k in key_cols])
    seg = torch.where(v, row_cumsum(start) - 1, _dump(cap, v.device))
    nseg = start.sum(-1, dtype=torch.int32)
    return sb, v, start, seg, nseg


def _first_scatter(
    val: torch.Tensor, start: torch.Tensor, seg: torch.Tensor, cap: int
) -> torch.Tensor:
    """Per-segment value of the segment's first row (zeros past the
    last segment)."""
    idx = torch.where(start, seg, _dump(cap, seg.device))
    out = torch.zeros(val.shape[:-1] + (cap + DUMP,), dtype=val.dtype, device=val.device)
    return out.scatter_(-1, idx, val)[..., :cap]


def _scatter(val, seg, cap, reduce, init) -> torch.Tensor:
    """``scatter_reduce`` of rows into ``cap`` segments (the dump slots
    past them dropped); empty segments keep ``init``."""
    out = torch.full(val.shape[:-1] + (cap + DUMP,), init, dtype=val.dtype, device=val.device)
    return out.scatter_reduce_(-1, seg, val, reduce, include_self=True)[..., :cap]


def _signed64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """A split (lo, hi) word pair as one signed int64."""
    return torch.where(hi >= SIGN32, hi - (1 << 32), hi) * (1 << 32) + lo


def _segmented_pair_reduce(op, lo, hi, seg, cap) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment 64-bit reduce of a split (lo, hi) word column;
    empty segments give the (0, 0) pair, as the reference."""
    if op == "sum64":  # mod 2^64: word sums apart (exact), then the carry
        s_lo = _scatter(lo, seg, cap, "sum", 0)
        s_hi = _scatter(hi, seg, cap, "sum", 0)
        return s_lo & MASK32, (s_hi + (s_lo >> 32)) & MASK32
    v = _signed64(lo, hi)
    out = torch.zeros(v.shape[:-1] + (cap + DUMP,), dtype=v.dtype, device=v.device)
    r = out.scatter_reduce_(
        -1, seg, v, "amin" if op == "min64" else "amax", include_self=False
    )[..., :cap]
    return r & MASK32, (r >> 32) & MASK32


_PAIR_IDENTITY = {"min64": (1 << 63) - 1, "max64": -(1 << 63)}


def pair_scalar_reduce(
    op: str, lo: torch.Tensor, hi: torch.Tensor, valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """64-bit reduce of a split (lo, hi) word column along the last axis
    to one (lo, hi) pair per leading index: ``sum64`` mod 2^64 (word
    sums apart, then the carry), ``min64``/``max64`` over the pair as one
    signed int64.  Invalid rows count as the op's identity, so an
    all-invalid row block reduces to the identity pair ((0, 0) for
    ``sum64``), which is neutral when partial pairs are reduced again.
    The reference's scan gives the same pair in any order."""
    if op == "sum64":
        s_lo = torch.where(valid, lo, 0).sum(-1)
        s_hi = torch.where(valid, hi, 0).sum(-1)
        return s_lo & MASK32, (s_hi + (s_lo >> 32)) & MASK32
    v = torch.where(valid, _signed64(lo, hi), _PAIR_IDENTITY[op])
    r = v.amin(-1) if op == "min64" else v.amax(-1)
    return r & MASK32, (r >> 32) & MASK32


def pair_to_f32(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Approximate f32 value of a split signed-64 word pair (hi signed *
    2^32 + lo unsigned), the reference's float32 operations in order."""
    hs = torch.where(hi >= SIGN32, hi - (1 << 32), hi)
    return hs.to(torch.float32) * 4294967296.0 + lo.to(torch.float32)


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """``2.0 ** k`` in float64, exactly, for integer k in [-1022, 1023]
    (built from the exponent bits: no pow/exp2 rounding)."""
    return ((k.to(torch.int64) + 1023) << 52).view(torch.float64)


def _f32_sum(x: torch.Tensor, seg: torch.Tensor, cap: int) -> torch.Tensor:
    """Per-segment float32 sum with integer accumulation (module
    docstring).  With E a segment's largest biased exponent, each value
    becomes ``round(x * 2^(K + 127 - E))``, below 2^(K+1) in magnitude,
    so the sum of up to ``cap`` of them stays below 2^63; values within
    2^(K-23) of the largest are exact, smaller ones lose at most half a
    unit of 2^(E-127-K) each.  Subnormal inputs and results count as
    zero, as in the reference's backends.  NaN and infinities follow
    IEEE: any NaN, or both infinities, give NaN; one infinity gives
    itself."""
    K = 62 - max(1, cap.bit_length())
    x = flush_subnormal(x)  # as the reference's backends add
    biased = (x.view(torch.int32) >> 23) & 0xFF
    keep = (biased != 0xFF) & (seg < cap)  # finite rows of a real segment
    e = torch.where(keep, torch.clamp(biased, min=1), 0)  # subnormals as 1
    E = _scatter(e, seg, cap, "amax", 0)
    E_row = E.gather(-1, seg.clamp(max=cap - 1))  # any E for rows dropped anyway
    xd = torch.where(keep, x, 0.0).to(torch.float64)
    q = torch.round(xd * _pow2(K + 127 - E_row)).to(torch.int64)
    total = _scatter(q, seg, cap, "sum", 0)
    out = flush_subnormal((total.to(torch.float64) * _pow2(E - 127 - K)).to(torch.float32))
    # non-finite rows: code 2 = NaN, 1 = +Inf (a max), and -Inf apart
    pos = torch.where(torch.isnan(x), 2, (x == float("inf")).to(torch.int32))
    f_pos = _scatter(pos.to(torch.int32), seg, cap, "amax", 0)
    f_neg = _scatter((x == float("-inf")).to(torch.int32), seg, cap, "amax", 0)
    out = torch.where(f_pos == 1, float("inf"), out)
    out = torch.where(f_neg == 1, float("-inf"), out)
    return torch.where((f_pos == 2) | ((f_pos == 1) & (f_neg == 1)), float("nan"), out)


def f32_total(x: torch.Tensor, valid: torch.Tensor, mesh=None) -> torch.Tensor:
    """Sum of every valid float32 value of ``x``, as a 0-d tensor: the
    integer accumulation of :func:`_f32_sum` for one segment, by
    reductions (a scatter into one slot would serialize its atomics on
    the card).  The same bytes on every run and device; over ``mesh``'s
    group the exponent, the integer sum and the non-finite flags are
    reduced across ranks, so the bytes equal one process's at the same
    P."""
    world = 1 if mesh is None or mesh.group is None else mesh.world
    n = x.numel() * world
    K = 62 - max(1, n.bit_length())
    x = flush_subnormal(x)
    biased = (x.view(torch.int32) >> 23) & 0xFF
    keep = valid & (biased != 0xFF)
    E = PART.allreduce(torch.where(keep, torch.clamp(biased, min=1), 0).amax(), "max", mesh)
    xd = torch.where(keep, x, 0.0).to(torch.float64)
    total = PART.allreduce(torch.round(xd * _pow2(K + 127 - E)).to(torch.int64).sum(), "sum", mesh)
    out = flush_subnormal((total.to(torch.float64) * _pow2(E - 127 - K)).to(torch.float32))
    nan = PART.any_(valid & torch.isnan(x), mesh)
    pinf = PART.any_(valid & (x == float("inf")), mesh)
    ninf = PART.any_(valid & (x == float("-inf")), mesh)
    out = torch.where(pinf, float("inf"), torch.where(ninf, float("-inf"), out))
    return torch.where(nan | (pinf & ninf), float("nan"), out)


def _u32_minmax(w: torch.Tensor, seg, cap, op: str, init: int) -> torch.Tensor:
    """Per-segment min/max of uint32 words (int64 carrier), reduced as
    int32 (``w - 2^31`` keeps the order) so the card's native 32-bit
    atomics apply; empty segments give ``init``."""
    red = "amin" if op == "min" else "amax"
    r = _scatter((w - SIGN32).to(torch.int32), seg, cap, red, init - SIGN32)
    return r.to(WORD) + SIGN32


def _f32_minmax(x: torch.Tensor, seg, cap, op: str) -> torch.Tensor:
    """Per-segment float32 min/max over the values' sortable words;
    empty segments give +inf (min) or -inf (max), as the reference."""
    init = to_sortable_u32(torch.tensor(float("inf") if op == "min" else float("-inf")))
    r = _u32_minmax(to_sortable_u32(x), seg, cap, op, int(init))
    bits = torch.where(r >= SIGN32, r ^ SIGN32, r ^ MASK32)
    out = (torch.where(bits >= SIGN32, bits - (1 << 32), bits)).to(torch.int32).view(torch.float32)
    has_nan = _scatter(torch.isnan(x).to(torch.int32), seg, cap, "amax", 0)
    return torch.where(has_nan > 0, float("nan"), out)


def _segment_sum(col: torch.Tensor, seg, cap) -> torch.Tensor:
    """The reference's ``segment_sum`` for one plain column: int32
    wraps mod 2^32, uint32 words too, bool sums are an OR."""
    if col.dtype == torch.float32:
        return _f32_sum(col, seg, cap)
    s = _scatter(col.to(torch.int64), seg, cap, "sum", 0)
    if col.dtype == torch.int32:
        return (((s + (1 << 31)) & MASK32) - (1 << 31)).to(torch.int32)
    if col.dtype == WORD:
        return s & MASK32
    return s > 0  # bool


def _segment_minmax(col: torch.Tensor, seg, cap, op: str) -> torch.Tensor:
    if col.dtype == torch.float32:
        return _f32_minmax(col, seg, cap, op)
    red = "amin" if op == "min" else "amax"
    if col.dtype == torch.int32:
        return _scatter(col, seg, cap, red, _I32_MAX if op == "min" else _I32_MIN)
    if col.dtype == WORD:
        return _u32_minmax(col, seg, cap, op, MASK32 if op == "min" else 0)
    return _scatter(col.to(torch.int32), seg, cap, red, int(op == "min")).to(torch.bool)


def group_reduce(
    batch: ColumnBatch, key_cols: Sequence[str], aggs: Sequence[AggSpec]
) -> ColumnBatch:
    """Group each partition's rows by the key columns and reduce; the
    output keeps the input's capacity, with one valid row per distinct
    key at the front (rows ``0..nseg-1``): the key columns plus one
    column per AggSpec (two words for the pair ops).
    ``DRYAD_TPU_SORT_FUSED=1`` routes to :func:`group_reduce_fused`, as
    in the reference."""
    if os.environ.get("DRYAD_TPU_SORT_FUSED") == "1":  # graftlint: disable=kernel-determinism -- the reference's opt-in switch, off by default; constant within a run
        return group_reduce_fused(batch, key_cols, aggs)
    cap = batch.capacity
    sb, v, start, seg, nseg = _segment_layout(batch, key_cols)
    out: Dict[str, torch.Tensor] = {}
    for k in key_cols:
        out[k] = _first_scatter(sb.data[k], start, seg, cap)

    seg_count = None
    if any(a.op in ("count", "mean") for a in aggs):
        # counts from one scatter of segment-start positions, then
        # adjacent differences (the reference's start-position scatter)
        nvalid = v.sum(-1, keepdim=True, dtype=torch.int32)
        idx = torch.where(start, seg, _dump(cap, v.device) + 2)
        pos = torch.arange(cap, dtype=torch.int32, device=v.device).expand_as(v)
        sp = nvalid.expand(-1, cap + 2 + DUMP).clone().scatter_(-1, idx, pos)[:, : cap + 1]
        seg_count = sp[:, 1:] - sp[:, :cap]

    sums: Dict[str, torch.Tensor] = {}  # aggs summing one column share it
    for a in aggs:
        if a.op == "count":
            out[a.out] = seg_count
            continue
        if a.op in PAIR_OPS:
            hi_col = a.col[: -len("#h0")] + "#h1"
            lo, hi = _segmented_pair_reduce(a.op, sb.data[a.col], sb.data[hi_col], seg, cap)
            out[f"{a.out}#h0"] = lo
            out[f"{a.out}#h1"] = hi
            continue
        col = sb.data[a.col]
        if a.op == "sum":
            if a.col not in sums:
                sums[a.col] = _segment_sum(col, seg, cap)
            out[a.out] = sums[a.col]
        elif a.op in ("min", "max"):
            out[a.out] = _segment_minmax(col, seg, cap, a.op)
        elif a.op == "mean":
            s = _f32_sum(col.to(torch.float32), seg, cap)
            out[a.out] = s / torch.clamp(seg_count.to(torch.float32), min=1.0)
        elif a.op == "any":
            out[a.out] = _scatter(col.to(torch.int32), seg, cap, "amax", _I32_MIN) != 0
        elif a.op == "all":
            vals = torch.where(v, col, True).to(torch.int32)
            out[a.out] = _scatter(vals, seg, cap, "amin", _I32_MAX) != 0
        elif a.op == "first":
            out[a.out] = _first_scatter(col, start, seg, cap)
        else:
            raise ValueError(f"unknown agg op {a.op!r}")

    valid = torch.arange(cap, device=v.device) < nseg[:, None]
    return ColumnBatch(out, valid)


def _to_word32(t: torch.Tensor) -> torch.Tensor:
    """A column's 32 bits as int32: float32 and int32 bit for bit, bool
    as 0/1, uint32 words (int64 carrier) wrapped."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.to(torch.int32)


def _from_word32(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float32:
        return w.view(torch.float32)
    if dtype == WORD:
        return w.to(WORD) & MASK32
    return w.to(dtype)


def _pair_combine(op: str):
    """The reference's 64-bit word-pair combine: carry-propagating add
    for ``sum64``, signed lexicographic select for ``min64``/``max64``."""
    if op == "sum64":
        def combine(alo, ahi, blo, bhi):
            slo = (alo + blo) & MASK32
            return slo, (ahi + bhi + (slo < blo).to(WORD)) & MASK32
    else:
        def combine(alo, ahi, blo, bhi):
            ahs = torch.where(ahi >= SIGN32, ahi - (1 << 32), ahi)
            bhs = torch.where(bhi >= SIGN32, bhi - (1 << 32), bhi)
            a_less = (ahs < bhs) | ((ahs == bhs) & (alo < blo))
            take_a = a_less if op == "min64" else ~a_less
            return torch.where(take_a, alo, blo), torch.where(take_a, ahi, bhi)
    return combine


def _elem_combine(kind: str, ea: torch.Tensor, eb: torch.Tensor) -> torch.Tensor:
    """One channel group's combine, as the reference's: int32 sums wrap,
    uint32 words wrap mod 2^32, f32 sums flush subnormals."""
    if kind == "sum":
        m = ea + eb
        if m.dtype == torch.float32:
            return flush_subnormal(m)
        return m & MASK32 if m.dtype == WORD else m
    if kind == "min":
        return torch.minimum(ea, eb)
    if kind == "max":
        return torch.maximum(ea, eb)
    return ea  # first: keep the left (earlier) value


def group_reduce_fused(
    batch: ColumnBatch, key_cols: Sequence[str], aggs: Sequence[AggSpec]
) -> ColumnBatch:
    """The reference's fused sort path: :func:`group_reduce`'s output
    from ONE multi-channel flagged segmented scan and ONE stacked
    scatter.  Every aggregate with per-segment state is a channel of the
    scan (channels grouped by combine kind and dtype, one combine a
    group); counts are the differences of the positions of consecutive
    segments' last rows; keys, aggregates and positions are bitcast to
    32-bit words and written together at the rows that end a segment
    (the positions are unique, so the result is deterministic).

    Integers, keys and counts equal :func:`group_reduce`'s byte for
    byte.  Float32 sums and means are f32 additions in JAX's scan order
    (:func:`associative_scan`, subnormals flushed in and out of every
    addition as the reference's backends flush them): the reference's
    fused path byte for byte, within ``n_g * 2^-23 * sum |v|`` of the
    exact sum of a group of ``n_g`` values."""
    cap = batch.capacity
    sb, v, start, seg, nseg = _segment_layout(batch, key_cols)
    nxt_start = torch.nn.functional.pad(start[..., 1:], (0, 1), value=True)
    nxt_valid = torch.nn.functional.pad(v[..., 1:], (0, 1), value=False)
    last = v & (nxt_start | ~nxt_valid)

    # scan channels, grouped so one combine handles a whole stack
    elem_groups: Dict[Tuple[str, str], List[Tuple[str, torch.Tensor]]] = {}
    pair_groups: Dict[str, List[Tuple[str, torch.Tensor, torch.Tensor]]] = {}

    def elem(kind: str, name: str, arr: torch.Tensor) -> None:
        if arr.dtype == torch.float32:
            arr = flush_subnormal(arr)
        elem_groups.setdefault((kind, str(arr.dtype)), []).append((name, arr))

    need_count = any(a.op in ("count", "mean") for a in aggs)
    for a in aggs:
        if a.op == "count":
            continue
        if a.op in PAIR_OPS:
            hi_col = a.col[: -len("#h0")] + "#h1"
            pair_groups.setdefault(a.op, []).append((a.out, sb.data[a.col], sb.data[hi_col]))
            continue
        col = sb.data[a.col]
        if a.op in ("sum", "min", "max", "first"):
            elem(a.op, a.out, col)
        elif a.op == "mean":
            elem("sum", a.out, col.to(torch.float32))
        elif a.op == "any":
            elem("max", a.out, col.to(torch.int32))
        elif a.op == "all":
            elem("min", a.out, col.to(torch.int32))
        else:
            raise ValueError(f"unknown agg op {a.op!r}")

    ekeys = sorted(elem_groups)
    pkeys = sorted(pair_groups)
    scanned: List[torch.Tensor] = []
    if ekeys or pkeys:
        # channel stacks as (P, C, cap): the scan runs along the last axis
        stacks = [torch.stack([x for _n, x in elem_groups[k]], -2) for k in ekeys]
        for k in pkeys:
            stacks.append(torch.stack([lo for _n, lo, _h in pair_groups[k]], -2))
            stacks.append(torch.stack([hi for _n, _l, hi in pair_groups[k]], -2))

        def combine(a, b):
            keep_b = b[0][..., None, :]
            out = [a[0] | b[0]]
            for i, (kind, _dt) in enumerate(ekeys):
                out.append(torch.where(keep_b, b[1 + i], _elem_combine(kind, a[1 + i], b[1 + i])))
            at = 1 + len(ekeys)
            for j, k in enumerate(pkeys):
                alo, ahi = a[at + 2 * j], a[at + 2 * j + 1]
                blo, bhi = b[at + 2 * j], b[at + 2 * j + 1]
                mlo, mhi = _pair_combine(k)(alo, ahi, blo, bhi)
                out += [torch.where(keep_b, blo, mlo), torch.where(keep_b, bhi, mhi)]
            return out

        scanned = associative_scan(combine, [start] + stacks)[1:]

    # ONE stacked scatter at the segments' last rows
    chans: List[torch.Tensor] = []
    names: List[Tuple[str, torch.dtype]] = []  # (out name, dtype to restore)
    for k in key_cols:  # keys are constant within a segment
        chans.append(_to_word32(sb.data[k]))
        names.append((k, sb.data[k].dtype))
    for i, gk in enumerate(ekeys):
        for c, (name, arr) in enumerate(elem_groups[gk]):
            chans.append(_to_word32(scanned[i][..., c, :]))
            names.append((f"#chan/{gk[0]}/{name}", arr.dtype))
    at = len(ekeys)
    for j, pk in enumerate(pkeys):
        slo, shi = scanned[at + 2 * j], scanned[at + 2 * j + 1]
        for c, (name, _lo, _hi) in enumerate(pair_groups[pk]):
            chans += [_to_word32(slo[..., c, :]), _to_word32(shi[..., c, :])]
            names += [(f"{name}#h0", WORD), (f"{name}#h1", WORD)]
    if need_count:
        chans.append(torch.arange(cap, dtype=torch.int32, device=v.device).expand_as(v))
        names.append(("#chan/pos", torch.int32))
    stacked = torch.stack(chans, -1)  # (P, cap, C) int32
    # rows that end no segment land in the dump slots past cap
    idx = torch.where(last, seg, _dump(cap, v.device))
    out3 = torch.zeros(v.shape[:-1] + (cap + DUMP, stacked.shape[-1]), dtype=torch.int32,
                       device=v.device)
    out3 = out3.scatter_(-2, idx[..., None].expand_as(stacked), stacked)[..., :cap, :]
    fetched = {name: _from_word32(out3[..., i], dt) for i, (name, dt) in enumerate(names)}

    out: Dict[str, torch.Tensor] = {k: fetched[k] for k in key_cols}
    seg_count = None
    if need_count:
        pos_last = fetched["#chan/pos"]
        prev = torch.nn.functional.pad(pos_last[..., : cap - 1], (1, 0), value=-1)
        seg_count = pos_last - prev
    for a in aggs:
        if a.op == "count":
            out[a.out] = seg_count
        elif a.op in PAIR_OPS:
            out[f"{a.out}#h0"] = fetched[f"{a.out}#h0"]
            out[f"{a.out}#h1"] = fetched[f"{a.out}#h1"]
        elif a.op == "mean":
            s = fetched[f"#chan/sum/{a.out}"]
            out[a.out] = flush_subnormal(s / torch.clamp(seg_count.to(torch.float32), min=1.0))
        elif a.op in ("sum", "min", "max", "first"):
            out[a.out] = fetched[f"#chan/{a.op}/{a.out}"]
        elif a.op == "any":
            out[a.out] = fetched[f"#chan/max/{a.out}"].to(torch.bool)
        else:  # all
            out[a.out] = fetched[f"#chan/min/{a.out}"].to(torch.bool)
    valid = torch.arange(cap, device=v.device) < nseg[:, None]
    return ColumnBatch(out, valid)


def distinct(batch: ColumnBatch, key_cols: Sequence[str]) -> ColumnBatch:
    """Distinct rows over the key columns: group with the segment's
    first row of every other column."""
    keys = set(key_cols)
    aggs = [AggSpec("first", c, c) for c in batch.columns if c not in keys]
    return group_reduce(batch, key_cols, aggs)


# -- generic user decompositions ------------------------------------------

MergeFn = Callable[[Dict[str, torch.Tensor], Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a[0], b[0], a[1], b[1], ...`` along the last axis (``a`` as long
    as ``b`` or one longer).  JAX interleaves by adding two zero-padded
    arrays, which on the reference's backends turns -0.0 into +0.0 and
    flushes subnormals: float values take the same bytes here."""
    n = a.shape[-1] + b.shape[-1]
    out = torch.empty(a.shape[:-1] + (n,), dtype=a.dtype, device=a.device)
    out[..., 0::2] = a
    out[..., 1::2] = b
    return flush_subnormal(out) if out.dtype.is_floating_point else out


def associative_scan(
    combine: Callable[[List[torch.Tensor], List[torch.Tensor]], List[torch.Tensor]],
    elems: List[torch.Tensor],
) -> List[torch.Tensor]:
    """Inclusive scan along the last axis with an associative
    ``combine`` over lists of tensors: JAX's recursion
    (``lax.associative_scan``), so each output is combined from the same
    operands in the same order.  Combine even/odd neighbours, scan that
    half-length result, combine it with the remaining even elements
    (odd lengths apart), put the first element back in front and
    interleave."""
    n = elems[0].shape[-1]
    if n < 2:
        return list(elems)
    reduced = combine([e[..., 0:-1:2] for e in elems], [e[..., 1::2] for e in elems])
    odd = associative_scan(combine, reduced)
    if n % 2 == 0:
        even = combine([e[..., :-1] for e in odd], [e[..., 2::2] for e in elems])
    else:
        even = combine(odd, [e[..., 2::2] for e in elems])
    even = [torch.cat([e[..., :1], r], -1) for e, r in zip(elems, even)]
    return [_interleave(a, b) for a, b in zip(even, odd)]


def _flush_floats(cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: flush_subnormal(v) if v.dtype.is_floating_point else v for k, v in cols.items()}


def group_combine(
    batch: ColumnBatch,
    key_cols: Sequence[str],
    state_cols: Sequence[str],
    merge: MergeFn,
) -> ColumnBatch:
    """Segmented reduce with an arbitrary associative ``merge`` (the
    reference's RecursiveAccumulate), applied to whole ``(P, n)``
    state tensors, invalid rows included, as the reference applies it.
    A flagged segmented :func:`associative_scan`: a pair keeps its right
    operand where that starts a segment, else the merge; each segment's
    scan value at its last row is the segment's reduction.

    The reference's backends treat subnormal floats as zero in
    arithmetic and compares, and its scan's interleave flushes every
    output, so float state columns enter every merge flushed and leave
    it flushed: the same bytes for additive and selecting merges."""
    cap = batch.capacity
    sb, v, start, seg, nseg = _segment_layout(batch, key_cols)
    names = list(state_cols)

    def combine(a, b):
        fa, *va = a
        fb, *vb = b
        da, db = dict(zip(names, va)), dict(zip(names, vb))
        merged = _flush_floats(merge(_flush_floats(da), _flush_floats(db)))
        return [fa | fb] + [torch.where(fb, db[k], merged[k]) for k in names]

    _, *scanned = associative_scan(combine, [start] + [sb.data[c] for c in names])
    # last row of each segment: the next row starts a segment, is invalid, or is past the end
    nxt_start = torch.nn.functional.pad(start[..., 1:], (0, 1), value=True)
    nxt_valid = torch.nn.functional.pad(v[..., 1:], (0, 1), value=False)
    last = v & (nxt_start | ~nxt_valid)
    out: Dict[str, torch.Tensor] = {k: _first_scatter(sb.data[k], start, seg, cap) for k in key_cols}
    for c, val in zip(names, scanned):
        out[c] = _first_scatter(val, last, seg, cap)
    pos = torch.arange(cap, device=v.device)
    return ColumnBatch(out, pos < nseg[..., None])
