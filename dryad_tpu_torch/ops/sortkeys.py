"""Order-preserving key transforms for on-device sorting.

The counterpart of ``dryad_tpu/ops/sortkeys.py``.  Every sortable device
column maps to a uint32 word (carried as int64 in ``[0, 2^32)``) whose
unsigned order equals the column's logical order: int32 bias flip, the
IEEE-754 total-order trick for float32 (so -0.0 sorts before +0.0),
and bitwise complement for descending keys — bit for bit the
reference's words.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from dryad_tpu_torch.columnar.batch import MASK32, WORD

SIGN32 = 0x80000000


def to_sortable_u32(col: torch.Tensor, descending: bool = False) -> torch.Tensor:
    if col.dtype == WORD:  # uint32 carrier
        k = col
    elif col.dtype == torch.int32:
        k = (col.to(WORD) & MASK32) ^ SIGN32
    elif col.dtype == torch.bool:
        k = col.to(WORD)
    elif col.dtype == torch.float32:
        bits = col.view(torch.int32).to(WORD) & MASK32
        # negative floats: flip all bits; non-negative: set the sign bit
        k = torch.where(bits >= SIGN32, bits ^ MASK32, bits | SIGN32)
    else:
        raise TypeError(f"unsortable device column dtype {col.dtype}")
    return k ^ MASK32 if descending else k


def sort_order(
    key_cols: Sequence[torch.Tensor],
    valid: torch.Tensor,
    descending: Sequence[bool] | None = None,
) -> torch.Tensor:
    """Stable row permutation along the last axis: valid rows first,
    ordered by the keys (invalid rows sort last)."""
    from dryad_tpu_torch.ops.sort import lex_order

    desc = list(descending) if descending is not None else [False] * len(key_cols)
    if len(desc) != len(key_cols):
        raise ValueError(
            f"descending has {len(desc)} entries for {len(key_cols)} key columns"
        )
    operands: List[torch.Tensor] = [(~valid).to(WORD)]
    for col, d in zip(key_cols, desc):
        operands.append(to_sortable_u32(col, d))
    return lex_order(operands)
