"""Systematic MDS generator matrices over the integers.

An (n, k) code for stage partials: the first k rows are the identity
(each "systematic" coded vertex IS one plain per-partition partial),
the last r = n - k rows are parity — integer linear combinations of
ALL k partials.  The MDS property (every k-row subset of the n x k
matrix is invertible) is what makes ANY k completions sufficient.

Construction: parity row t is the Cauchy row ``1 / (x_t + y_j)`` with
``x_t = t`` and ``y_j = r + j``, scaled by the LCM of its denominators
so every entry is a positive integer (row scaling preserves rank
structure).  Every minor of a Cauchy matrix is nonzero, and a mixed
identity/Cauchy k-subset's determinant Laplace-reduces to a Cauchy
minor, so ``[I; C]`` is MDS over the rationals.  Integer entries keep
the worker-side encode exact for integer accumulators (int64 weighted
sums), and the driver-side decode runs in exact rational arithmetic
(``redundancy.reconstruct``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List


def generator_rows(k: int, r: int) -> List[List[int]]:
    """The n = k + r generator rows (each a length-k integer vector).

    Rows 0..k-1 are unit vectors (systematic); rows k..n-1 are scaled
    Cauchy parity rows with strictly positive entries.
    """
    if k < 1:
        raise ValueError("k must be >= 1")
    if r < 0:
        raise ValueError("r must be >= 0")
    rows = [[1 if j == i else 0 for j in range(k)] for i in range(k)]
    for t in range(r):
        dens = [t + r + j for j in range(k)]
        scale = math.lcm(*dens)
        rows.append([scale // d for d in dens])
    return rows


@dataclasses.dataclass(frozen=True)
class CodedSpec:
    """Task layout of one coded stage: k data shards, r parity spares.

    Coded vertex ``j < k`` computes the plain partial of shard ``j``
    (support = one shard, same work as an uncoded vertex); a parity
    vertex computes the integer combination of ALL k shard partials
    named by its generator row (support = k shards — the redundancy
    work is r * k shard-partials, paid only when spares launch).
    """

    k: int
    r: int

    @property
    def n(self) -> int:
        return self.k + self.r

    def rows(self) -> List[List[int]]:
        return generator_rows(self.k, self.r)

    def row(self, j: int) -> List[int]:
        if not 0 <= j < self.n:
            raise IndexError(f"coded id {j} out of range for n={self.n}")
        return self.rows()[j]

    def is_parity(self, j: int) -> bool:
        return j >= self.k

    def support(self, j: int) -> List[int]:
        """Shard ids coded vertex ``j`` must read."""
        return list(range(self.k)) if self.is_parity(j) else [j]

    def coeffs(self, j: int) -> List[int]:
        """Generator coefficients aligned with :meth:`support`."""
        return self.rows()[j] if self.is_parity(j) else [1]
