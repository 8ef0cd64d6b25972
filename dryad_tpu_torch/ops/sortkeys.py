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
FLT_MIN = 2.0 ** -126  # smallest normal float32


def flush_subnormal(col: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values (and -0.0) as +0.0.  The reference's XLA
    backends flush subnormals to zero in arithmetic and compares, so
    where a float decides placement (hashing, key equality) the port
    compares flushed values to give the same answer."""
    return torch.where(col.abs() < FLT_MIN, torch.zeros_like(col), col)


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


def lexi_less(
    a_cols: Sequence[torch.Tensor], b_cols: Sequence[torch.Tensor]
) -> torch.Tensor:
    """Elementwise lexicographic ``a < b`` over parallel key columns."""
    lt = torch.zeros(a_cols[0].shape, dtype=torch.bool, device=a_cols[0].device)
    eq = torch.ones_like(lt)
    for a, b in zip(a_cols, b_cols):
        ka, kb = to_sortable_u32(a), to_sortable_u32(b)
        lt = lt | (eq & (ka < kb))
        eq = eq & (ka == kb)
    return lt


def keys_equal_adjacent(key_cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """For columns sorted along the last axis: row i equals row i-1 on
    every key (row 0 of each partition -> False; float32 compared as the
    reference's backends compare, subnormals equal to zero)."""
    eq = torch.ones(key_cols[0].shape, dtype=torch.bool, device=key_cols[0].device)
    for col in key_cols:
        if col.dtype == torch.float32:
            col = flush_subnormal(col)
        eq = eq & (col == torch.roll(col, 1, -1))
    eq[..., 0] = False
    return eq
