"""Stable multi-key sorting, range splitters and range bucketing.

The counterpart of ``dryad_tpu/ops/sort.py``: ``sort_carry``,
``sort_batch_by_operands``, the splitter election of the range exchange
(``sample_splitters(_multi)``), its bucketing (``range_dest(_multi)``)
and the skew-spread tiebreak word (``spread_word``).  The reference
sorts with ``lax.sort(num_keys=k, is_stable=True)``; ``torch.sort`` has
one key.  :func:`lex_order` packs consecutive word pairs into one
order-preserving int64 (``(a - 2^31) * 2^32 + b``) and chains stable
sorts from the least significant pack, which gives exactly the
reference's permutation, ties kept in row order.  All sorts run along
the last axis, so a ``(P, cap)`` batch sorts every partition at once.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from dryad_tpu_torch.columnar.batch import MASK32, WORD, ColumnBatch
from dryad_tpu_torch.parallel import partition as PART

_HALF = 1 << 31
_SHIFT = 1 << 32


def _packs(words: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Pairs of uint32 words -> order-preserving signed int64 keys."""
    out = []
    for i in range(0, len(words), 2):
        if i + 1 < len(words):
            out.append((words[i] - _HALF) * _SHIFT + words[i + 1])
        else:
            out.append(words[i])
    return out


def lex_order(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation (last axis) sorting rows lexicographically by
    ``words`` (most significant first), each an int64 tensor of uint32
    values."""
    *high, low = _packs(words)
    _, order = torch.sort(low.expand(words[0].shape), dim=-1, stable=True)
    for k in reversed(high):
        _, perm = torch.sort(k.gather(-1, order), dim=-1, stable=True)
        order = order.gather(-1, perm)
    return order


def sort_carry(
    operands: Sequence[torch.Tensor],
    valid: torch.Tensor,
    carry: Sequence[torch.Tensor] = (),
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """Stable sort (valid rows first, then lexicographic by uint32
    operands) carrying payload tensors along.  Returns
    ``(sorted_valid, sorted_operands, sorted_carry)``."""
    inv = (~valid).to(WORD)
    order = lex_order([inv, *operands])
    take = lambda t: t.gather(-1, order)
    return take(valid), [take(o) for o in operands], [take(c) for c in carry]


def sort_batch_by_operands(
    batch: ColumnBatch, operands: Sequence[torch.Tensor]
) -> ColumnBatch:
    """Sort a whole batch by uint32 operands (valid rows first)."""
    names = batch.columns
    valid, _, carried = sort_carry(
        operands, batch.valid, [batch.data[n] for n in names]
    )
    return ColumnBatch(dict(zip(names, carried)), valid)


def _sorted_words(words: Sequence[torch.Tensor], valid: torch.Tensor) -> List[torch.Tensor]:
    """Each partition's words in the lexicographic order of its valid
    rows (the invalid ones after them), as ``sort_carry`` gives them.
    Up to two words pack into one int64 sorted once, invalid rows forced
    past every valid one: the sorted valid prefix, the only part sampled,
    holds the same values (only rows with equal words may change places)."""
    if len(words) > 2:
        return sort_carry(list(words), valid)[1]
    (packed,) = _packs(list(words))
    packed = torch.where(valid, packed, torch.iinfo(torch.int64).max)
    packed, _ = torch.sort(packed, dim=-1)
    if len(words) == 1:
        return [packed]
    return [(packed >> 32) + _HALF, packed & MASK32]


def _sample_index(valid: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(P, m)`` evenly spaced positions in each partition's sorted valid
    prefix, and the ``(P,)`` valid counts (the reference's f32 math)."""
    count = valid.sum(-1, dtype=torch.int32)
    pos = (torch.arange(m, dtype=torch.float32, device=valid.device) + 0.5) * (
        count.to(torch.float32)[:, None]
    ) / m
    hi = torch.clamp(count - 1, min=0)[:, None]
    idx = torch.minimum(torch.clamp(pos.to(torch.int32), min=0), hi)
    return idx.to(torch.int64), count


def _elect(pool: List[torch.Tensor], pool_valid: torch.Tensor, P: int) -> List[torch.Tensor]:
    """Cut the pooled samples (invalid ones forced to +inf in every
    word) at P-1 evenly spaced ranks of their lexicographic order."""
    total = pool_valid.sum(dtype=torch.int32)
    ops = [torch.where(pool_valid, w, MASK32) for w in pool]
    order = lex_order(ops)
    ranks = torch.arange(1, P, dtype=torch.float32, device=pool_valid.device) * (
        total.to(torch.float32)
    ) / P
    sidx = torch.minimum(torch.clamp(ranks.to(torch.int32), min=0), torch.clamp(total - 1, min=0))
    at = order[sidx.to(torch.int64)]
    return [o[at] for o in ops]


def sample_splitters_multi(
    words: Sequence[torch.Tensor], valid: torch.Tensor, num_partitions: int, m: int,
    mesh=None,
) -> List[torch.Tensor]:
    """P-1 range splitters over a lexicographic multi-word key: ``m``
    evenly spaced samples from each partition's sorted valid rows,
    pooled over all partitions (an ``all_gather`` of every rank's
    samples over ``mesh``'s group, in global partition order), cut at
    P-1 evenly spaced ranks.  Returns one ``(P-1,)`` tensor per word
    (``num_partitions`` = P, which may be below the partition count
    under fan-out reduction)."""
    idx, count = _sample_index(valid, m)
    sorted_words = _sorted_words(words, valid)
    pool = [PART.gather_rows(w.gather(-1, idx), mesh).reshape(-1) for w in sorted_words]
    has = PART.gather_rows(count > 0, mesh)
    pool_valid = has[:, None].expand(-1, m).reshape(-1)
    return _elect(pool, pool_valid, num_partitions)


def sample_splitters(
    key_u32: torch.Tensor, valid: torch.Tensor, num_partitions: int, m: int, mesh=None
) -> torch.Tensor:
    """Single-word :func:`sample_splitters_multi`."""
    return sample_splitters_multi([key_u32], valid, num_partitions, m, mesh)[0]


def range_dest(key_u32: torch.Tensor, splitters: torch.Tensor) -> torch.Tensor:
    """Destination per row: the number of splitters <= its key
    (``searchsorted(side="right")``), so equal keys share a partition."""
    if splitters.numel() == 0:
        return torch.zeros(key_u32.shape, dtype=torch.int32, device=key_u32.device)
    return torch.searchsorted(splitters, key_u32, right=True).to(torch.int32)


def range_dest_multi(
    words: Sequence[torch.Tensor], splitters: Sequence[torch.Tensor]
) -> torch.Tensor:
    """Destination per row by lexicographic compare against multi-word
    splitters: the number of splitters <= the row.  Word pairs are packed
    into order-preserving int64 keys; one pack is a ``searchsorted``,
    more are compared splitter by splitter, which keeps the memory at a
    few ``(P, cap)`` masks where the reference builds ``(n, P-1)`` ones."""
    rows, cuts = _packs(list(words)), _packs(list(splitters))
    if len(rows) == 1:
        return range_dest(rows[0], cuts[0])
    dest = torch.zeros(rows[0].shape, dtype=torch.int32, device=rows[0].device)
    for j in range(cuts[0].shape[0]):
        lt = torch.zeros_like(dest, dtype=torch.bool)  # splitter < row so far
        eq = torch.ones_like(lt)
        for r, c in zip(rows, cuts):
            s = c[j]
            lt = lt | (eq & (s < r))
            eq = eq & (s == r)
        dest += lt | eq
    return dest


def spread_word(n: int, device=None) -> torch.Tensor:
    """Uniform synthetic tiebreak word (Knuth multiplicative hash of the
    row index, ``i * 2654435761 mod 2^32``), so splitter election can cut
    inside a heavy key's run."""
    return (torch.arange(n, dtype=WORD, device=device) * 2654435761) & MASK32
