"""Device-side hashing for hash partitioning.

The counterpart of ``dryad_tpu/ops/hash.py``: the murmur3 32-bit
finalizer over the physical uint32 words of the key columns, combined
hash-combine style, bit for bit the reference's ``partition_ids``.

uint32 words ride as int64 in ``[0, 2^32)`` (``columnar/batch.py``).
Every step that can leave 32 bits is masked back: the shift left, the
sums, and each multiply by a 32-bit constant, which is split into
16-bit halves so no int64 product passes 2^63.  Shifts right act on the
non-negative int64 carrier, so they are logical, as the reference's
uint32 shifts.
"""

from __future__ import annotations

from typing import Sequence

import torch

from dryad_tpu_torch.columnar.batch import MASK32, WORD
from dryad_tpu_torch.ops.sortkeys import flush_subnormal

_GOLDEN = 0x9E3779B9


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2^32`` for ``h`` in ``[0, 2^32)`` and a 32-bit
    constant ``c``, with every intermediate below 2^50."""
    lo = (h & 0xFFFF) * c
    hi = (((h >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer (public-domain constant mix)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _to_u32(col: torch.Tensor) -> torch.Tensor:
    """A physical column as its uint32 hash word (int64 carrier)."""
    if col.dtype == WORD:  # uint32 carrier
        return col
    if col.dtype == torch.int32:
        return col.to(WORD) & MASK32
    if col.dtype == torch.bool:
        return col.to(WORD)
    if col.dtype == torch.float32:
        # -0.0 (and subnormals, zero to the reference's backends) hash
        # as +0.0, so equal floats hash equally
        return flush_subnormal(col).view(torch.int32).to(WORD) & MASK32
    raise TypeError(f"unhashable device column dtype {col.dtype}")


def hash_columns(cols: Sequence[torch.Tensor], seed: int = 0) -> torch.Tensor:
    """Combine physical columns into one uint32 hash per row."""
    h = torch.full(cols[0].shape, _GOLDEN ^ seed, dtype=WORD, device=cols[0].device)
    for c in cols:
        mix = _fmix32(_to_u32(c)) + _GOLDEN + ((h << 6) & MASK32) + (h >> 2)
        h = h ^ (mix & MASK32)
    return _fmix32(h)


def partition_ids(cols: Sequence[torch.Tensor], num_partitions: int) -> torch.Tensor:
    """Hash-partition destination per row: ``hash(key) % P`` as int32."""
    return (hash_columns(cols) % num_partitions).to(torch.int32)
