"""Hash equi-join with static output shapes, over ``(P, cap)`` batches.

The counterpart of ``dryad_tpu/ops/join.py``.  Both sides arrive
co-partitioned by key hash (or the right side replicated to every
partition); each partition sorts its right side by a 31-bit key hash,
probes it with ``searchsorted`` for every left row's candidate range,
expands the candidate pairs into a fixed-capacity output by prefix
sums, and masks the pairs to exact key equality (hash collisions only
add masked-off candidates).  More candidates than the output holds set
the overflow flag, and the executor retries with a larger buffer.

Differences of layout, none of result:

- every function works on all P partitions at once, along the last
  axis; the reference's per-partition arrays are rows here;
- counts, offsets and the pair total are int64 (the reference's are
  int32, which wrap past 2^31 candidates in one partition);
- pair slots past the total point past the right side; the reference's
  gathers clamp such indices, so the port clamps them explicitly to the
  same rows (torch raises on them).  Those slots are invalid either way;
- float keys compare as the reference's backends compare them:
  subnormals equal zero (``ops/sortkeys.py::flush_subnormal``), and
  -0.0 equals 0.0.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from dryad_tpu_torch.columnar.batch import MASK32, ColumnBatch, row_cumsum
from dryad_tpu_torch.ops.hash import hash_columns
from dryad_tpu_torch.ops.sort import sort_batch_by_operands, sort_carry
from dryad_tpu_torch.ops.sortkeys import flush_subnormal


def _suffixed(phys_name: str, suffix: str) -> str:
    """Apply a clash suffix to the logical base of a physical name:
    ``'v#h0' -> 'v{suffix}#h0'``, so split columns stay consistent with
    the suffixed logical field of the output schema."""
    if "#" in phys_name:
        base, word = phys_name.split("#", 1)
        return f"{base}{suffix}#{word}"
    return f"{phys_name}{suffix}"


def _probe_ranges(
    left: ColumnBatch,
    right: ColumnBatch,
    left_keys: Sequence[str],
    right_keys: Sequence[str],
) -> Tuple[ColumnBatch, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort the right side by key hash; per valid left row its candidate
    range.  Returns ``(right_sorted, lhash, start, counts)``.  Invalid
    right rows sort last with the sentinel hash 2^32-1, which no probe
    hash (top bit cleared) can equal.  The sort is stable and carries
    the whole batch, so an earlier order of the right rows survives
    within each run of equal hashes."""
    rhash = hash_columns([right.data[k] for k in right_keys]) >> 1
    rhash = torch.where(right.valid, rhash, MASK32)
    names = right.columns
    vs, (rhash_sorted,), carried = sort_carry(
        [rhash], right.valid, [right.data[n] for n in names]
    )
    rs = ColumnBatch(dict(zip(names, carried)), vs)
    lhash = hash_columns([left.data[k] for k in left_keys]) >> 1
    start = torch.searchsorted(rhash_sorted, lhash)
    end = torch.searchsorted(rhash_sorted, lhash, right=True)
    counts = torch.where(left.valid, end - start, 0)
    return rs, lhash, start, counts


def _expand_pairs(
    start: torch.Tensor, counts: torch.Tensor, out_capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Enumerate candidate (left row, right row) pairs into
    ``out_capacity`` slots a partition.  Returns ``(li, ri, pair_valid,
    overflow, offsets)``: ``offsets[p, i]`` is the first slot of left row
    i's candidates (one left row's slots are contiguous).  ``ri`` of a
    slot past the total may point past the right side; the callers clamp
    it (:func:`_right_index`)."""
    P, n = counts.shape
    incl = row_cumsum(counts)
    offsets = incl - counts
    total = incl[:, -1:]
    overflow = (total > out_capacity).any()
    slots = torch.arange(out_capacity, device=counts.device).expand(P, -1).contiguous()
    # which left row does slot j belong to? offsets is non-decreasing
    li = torch.searchsorted(offsets, slots, right=True) - 1
    li = li.clamp(0, n - 1)
    within = slots - offsets.gather(-1, li)
    pair_valid = slots < total
    ri = start.gather(-1, li) + within
    return li, ri, pair_valid, overflow, offsets


def _right_index(ri: torch.Tensor, rs: ColumnBatch) -> torch.Tensor:
    """Clamp pair slots' right rows into the right side, where the
    reference's gathers clamp them (only invalid slots reach past)."""
    return ri.clamp(max=rs.capacity - 1)


def _key_values(col: torch.Tensor) -> torch.Tensor:
    return flush_subnormal(col) if col.dtype == torch.float32 else col


def _exact_pair_match(
    left: ColumnBatch,
    rs: ColumnBatch,
    left_keys: Sequence[str],
    right_keys: Sequence[str],
    li: torch.Tensor,
    ri: torch.Tensor,
    pair_valid: torch.Tensor,
) -> torch.Tensor:
    """Candidate pairs that match on ALL key columns (kills collisions)."""
    exact = pair_valid & left.valid.gather(-1, li) & rs.valid.gather(-1, ri)
    for lk, rk in zip(left_keys, right_keys):
        a = _key_values(left.data[lk].gather(-1, li))
        b = _key_values(rs.data[rk].gather(-1, ri))
        exact = exact & (a == b)
    return exact


def _exact_per_left(li: torch.Tensor, exact: torch.Tensor, n: int) -> torch.Tensor:
    """Per-left-row count of exact pairs (an integer scatter-add over
    the pair slots), ``(P, n)`` int32."""
    out = torch.zeros(li.shape[:-1] + (n,), dtype=torch.int32, device=li.device)
    return out.scatter_add_(-1, li, exact.to(torch.int32))


def _pair_columns(
    left: ColumnBatch,
    rs: ColumnBatch,
    right_keys: Sequence[str],
    li: torch.Tensor,
    ri: torch.Tensor,
    suffix: str,
) -> Dict[str, torch.Tensor]:
    """Every left column at ``li`` plus the right side's non-key columns
    at ``ri`` (names clashing with the left's suffixed)."""
    data: Dict[str, torch.Tensor] = {n: c.gather(-1, li) for n, c in left.data.items()}
    rk = set(right_keys)
    for name, col in rs.data.items():
        if name in rk:
            continue
        data[_suffixed(name, suffix) if name in data else name] = col.gather(-1, ri)
    return data


def _probe_and_expand(left, right, left_keys, right_keys, out_capacity):
    rs, _lhash, start, counts = _probe_ranges(left, right, left_keys, right_keys)
    li, ri, pair_valid, overflow, offsets = _expand_pairs(start, counts, out_capacity)
    return rs, counts, li, _right_index(ri, rs), pair_valid, overflow, offsets


def hash_join(
    left: ColumnBatch,
    right: ColumnBatch,
    left_keys: Sequence[str],
    right_keys: Sequence[str],
    out_capacity: int,
    suffix: str = "_r",
) -> Tuple[ColumnBatch, torch.Tensor]:
    """Local inner equi-join of co-partitioned sides.  Output: every
    left column plus the right side's non-key columns (names clashing
    with the left's get ``suffix``).  Returns ``(batch, overflow)``."""
    rs, _c, li, ri, pair_valid, overflow, _o = _probe_and_expand(
        left, right, left_keys, right_keys, out_capacity
    )
    data = _pair_columns(left, rs, right_keys, li, ri, suffix)
    valid = _exact_pair_match(left, rs, left_keys, right_keys, li, ri, pair_valid)
    return ColumnBatch(data, valid), overflow


def hash_join_outer(
    left: ColumnBatch,
    right: ColumnBatch,
    left_keys: Sequence[str],
    right_keys: Sequence[str],
    out_capacity: int,
    right_defaults: Dict[str, object],
    suffix: str = "_r",
) -> Tuple[ColumnBatch, torch.Tensor]:
    """Left-outer equi-join: the inner pairs, then every unmatched left
    row with default-valued right columns.  Output capacity is
    ``out_capacity + left.capacity``; the unmatched tail is reserved, so
    it never overflows."""
    rs, _c, li, ri, pair_valid, overflow, _o = _probe_and_expand(
        left, right, left_keys, right_keys, out_capacity
    )
    exact = _exact_pair_match(left, rs, left_keys, right_keys, li, ri, pair_valid)
    matched = _exact_per_left(li, exact, left.capacity)
    unmatched = left.valid & (matched == 0)

    rk = set(right_keys)
    data: Dict[str, torch.Tensor] = {
        n: torch.cat([c.gather(-1, li), c], -1) for n, c in left.data.items()
    }
    for name, col in rs.data.items():
        if name in rk:
            continue
        out_name = _suffixed(name, suffix) if name in data else name
        dflt = right_defaults.get(name, 0)
        dflt = dflt.item() if hasattr(dflt, "item") else dflt  # graftlint: disable=host-transfer -- dflt is a numpy scalar from right_defaults, not a tensor
        tail = torch.full(left.valid.shape, dflt, dtype=col.dtype, device=col.device)
        data[out_name] = torch.cat([col.gather(-1, ri), tail], -1)
    return ColumnBatch(data, torch.cat([exact, unmatched], -1)), overflow


def group_join_counts(
    left: ColumnBatch,
    right: ColumnBatch,
    left_keys: Sequence[str],
    right_keys: Sequence[str],
    out_capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-left-row count of exactly matching right rows (GroupJoin's
    count shape), ``(P, left.capacity)`` int32, and the overflow flag."""
    rs, _c, li, ri, pair_valid, overflow, _o = _probe_and_expand(
        left, right, left_keys, right_keys, out_capacity
    )
    exact = _exact_pair_match(left, rs, left_keys, right_keys, li, ri, pair_valid)
    return _exact_per_left(li, exact, left.capacity), overflow


def hash_join_ranked(
    left: ColumnBatch,
    right: ColumnBatch,
    left_keys: Sequence[str],
    right_keys: Sequence[str],
    out_capacity: int,
    suffix: str = "_r",
    rank_name: str = "gj_rank",
    order_operands: Sequence[torch.Tensor] = (),
    rank_limit: Optional[int] = None,
    boost: int = 1,
    final_attempt: bool = False,
) -> Tuple[ColumnBatch, torch.Tensor]:
    """Inner equi-join that also emits each pair's group-local rank: the
    position of the matching right row among its left row's exact
    matches, as an int32 column (full GroupJoin's enumerable group).

    With ``order_operands`` (uint32 sort words over the UNSORTED right
    batch), ranks follow that value order within each group; without,
    the right side's engine order.  ``rank_limit=k`` keeps only ranks
    below k and expands each left row's first ``k * boost`` candidates
    only; a clamped row that found fewer than k exact matches (hash
    collisions in its window) sets the overflow flag, so the executor
    retries with a wider window.  ``final_attempt`` (the retry ladder's
    last rung) drops the clamp: such a row then costs the unclamped
    expansion instead of failing.  Semantics as the reference's."""
    if len(order_operands):
        right = sort_batch_by_operands(right, order_operands)
    # the hash sort is stable, so the operand order survives within each
    # run of equal hashes
    rs, _lhash, start, counts = _probe_ranges(left, right, left_keys, right_keys)
    full_counts = counts
    if rank_limit is not None and not final_attempt:
        counts = torch.clamp(counts, max=rank_limit * boost)
    li, ri, pair_valid, overflow, offsets = _expand_pairs(start, counts, out_capacity)
    ri = _right_index(ri, rs)
    exact = _exact_pair_match(left, rs, left_keys, right_keys, li, ri, pair_valid)

    # rank among EXACT matches: a left row's slots are contiguous, so
    # the rank is the count of exact slots in [offsets[li], slot] minus 1
    cs = row_cumsum(exact.to(torch.int64))
    seg = offsets.gather(-1, li)
    before = torch.where(
        seg > 0, cs.gather(-1, (seg - 1).clamp(0, out_capacity - 1)), 0
    )
    rank = torch.where(exact, cs - 1 - before, 0).to(torch.int32)

    if rank_limit is not None:
        if not final_attempt:
            exact_cnt = _exact_per_left(li, exact, full_counts.shape[-1])
            short = left.valid & (full_counts > counts) & (exact_cnt < rank_limit)
            overflow = overflow | short.any()
        exact = exact & (rank < rank_limit)

    data = _pair_columns(left, rs, right_keys, li, ri, suffix)
    data[rank_name] = rank
    return ColumnBatch(data, exact), overflow


def exists_mask(
    left: ColumnBatch,
    right: ColumnBatch,
    left_keys: Sequence[str],
    right_keys: Sequence[str],
    out_capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-left-row "has an exactly matching right row" (semi and anti
    joins), and the overflow flag."""
    counts, overflow = group_join_counts(left, right, left_keys, right_keys, out_capacity)
    return counts > 0, overflow
