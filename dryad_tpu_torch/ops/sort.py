"""Stable multi-key sorting over uint32 operand words.

The counterpart of the parts of ``dryad_tpu/ops/sort.py`` the ported
path uses (``sort_carry``, ``sort_batch_by_operands``).  The reference
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

from dryad_tpu_torch.columnar.batch import WORD, ColumnBatch

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
    packs = _packs(words)
    n = words[0].shape[-1]
    order = torch.arange(n, device=words[0].device).expand(words[0].shape)
    for k in reversed(packs):
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
