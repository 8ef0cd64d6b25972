"""Decode any k completed coded partials back into stage output.

Two decode surfaces:

- :func:`merge_coded` — the production path.  The driver does not need
  the individual per-partition partials, only their SUM (the merged
  stage output), so it solves the single system ``G_S^T w = 1`` for
  combination weights ``w`` and folds the k observed coded tables once.
- :func:`reconstruct_partials` — inverts ``G_S`` to recover every
  systematic partial individually (the property-test surface, and the
  repair path a future cache layer could use).

Exactness contract: integer state columns decode in exact rational
arithmetic (``fractions.Fraction`` elimination over Python ints — no
overflow, no rounding), and the result is asserted integral; a coded
run that reconstructs through parity is therefore BYTE-IDENTICAL to
the unfailed run.  Float state columns decode in float64 with an
amplification guard: the L1 norm of the weights bounds how much coded
rounding noise the decode can amplify, and a subset beyond the
configured bound raises :class:`CodedReconstructionError` instead of
returning silently degraded sums.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, List, Sequence, Tuple

import numpy as np

from dryad_tpu_torch.exec.partial import align_partials


class CodedReconstructionError(RuntimeError):
    """A k-subset that cannot decode (singular rows — impossible for an
    MDS generator — or a float weight set beyond the amplification
    bound)."""


def _solve_exact(rows: Sequence[Sequence[int]], rhs: Sequence[int]):
    """Gauss-Jordan over Fractions; returns the exact solution vector."""
    k = len(rows)
    m = [
        [Fraction(rows[i][j]) for j in range(k)] + [Fraction(rhs[i])]
        for i in range(k)
    ]
    for col in range(k):
        piv = next((i for i in range(col, k) if m[i][col] != 0), None)
        if piv is None:
            raise CodedReconstructionError(
                "singular coded subset (non-MDS generator rows?)"
            )
        m[col], m[piv] = m[piv], m[col]
        pv = m[col][col]
        m[col] = [x / pv for x in m[col]]
        for i in range(k):
            if i != col and m[i][col]:
                f = m[i][col]
                m[i] = [x - f * y for x, y in zip(m[i], m[col])]
    return [m[i][k] for i in range(k)]


def solve_merge_weights(rows_used: Sequence[Sequence[int]]) -> List[Fraction]:
    """Exact weights ``w`` with ``sum_j w_j * G[j] == (1, ..., 1)``:
    the weighted sum of the observed coded partials IS the sum of all
    k systematic partials (= the merged stage output)."""
    k = len(rows_used)
    if any(len(r) != k for r in rows_used):
        raise CodedReconstructionError(
            f"need exactly k={k} length-k generator rows"
        )
    at = [[rows_used[j][i] for j in range(k)] for i in range(k)]
    return _solve_exact(at, [1] * k)


def _fold_exact(weights, mat) -> np.ndarray:
    """Fraction-weighted fold of an object-int matrix; asserts the
    result is integral (the bit-exactness guarantee)."""
    acc = None
    for w, row in zip(weights, mat):
        term = row * w
        acc = term if acc is None else acc + term
    out = []
    for v in (acc if acc is not None else []):
        f = Fraction(v)
        if f.denominator != 1:
            raise CodedReconstructionError(
                f"integer state decoded to non-integer {f} — coded "
                "inputs were not produced by integer-linear partials"
            )
        out.append(int(f))
    return np.asarray(out, dtype=np.int64)


def _weight_amplification(weights) -> float:
    return float(sum(abs(Fraction(w)) for w in weights))


def merge_coded(
    rows_used: Sequence[Sequence[int]],
    tables: Sequence[Dict[str, np.ndarray]],
    key_cols: Sequence[str],
    state_cols: Sequence[str],
    max_amplification: float = 1e6,
) -> Tuple[Dict[str, np.ndarray], Dict[str, object]]:
    """Fold any k completed coded partial tables into the merged stage
    output.  Returns ``(merged, info)`` where ``info`` records whether
    every state column decoded exactly and the weight amplification."""
    weights = solve_merge_weights(rows_used)
    amp = _weight_amplification(weights)
    key_arrays, mats = align_partials(tables, key_cols, state_cols)
    merged: Dict[str, np.ndarray] = dict(key_arrays)
    exact = True
    for c, mat in mats.items():
        if mat.dtype == object:
            merged[c] = _fold_exact(weights, mat)
        else:
            exact = False
            if amp > max_amplification:
                raise CodedReconstructionError(
                    f"float decode amplification {amp:.3g} exceeds "
                    f"bound {max_amplification:.3g} for subset rows "
                    f"{list(map(list, rows_used))}"
                )
            wf = np.asarray([float(w) for w in weights], np.float64)
            merged[c] = wf @ mat
    return merged, {"exact": exact, "amplification": amp}


def reconstruct_partials(
    rows_used: Sequence[Sequence[int]],
    tables: Sequence[Dict[str, np.ndarray]],
    key_cols: Sequence[str],
    state_cols: Sequence[str],
    max_amplification: float = 1e6,
) -> List[Dict[str, np.ndarray]]:
    """Invert the observed generator rows to recover EVERY systematic
    partial (each over the full key union; keys outside a partition
    decode to the 0 identity).  Exact for integer states."""
    k = len(rows_used)
    # column i of the inverse comes from solving G_S^T x = e_i... the
    # partial recovery is s = G_S^{-1} c, i.e. row i of the inverse
    # applied across coded tables: solve G_S^T w_i = e_i per i.
    at = [[rows_used[j][i] for j in range(k)] for i in range(k)]
    key_arrays, mats = align_partials(tables, key_cols, state_cols)
    out: List[Dict[str, np.ndarray]] = []
    for i in range(k):
        rhs = [1 if t == i else 0 for t in range(k)]
        weights = _solve_exact(at, rhs)
        amp = _weight_amplification(weights)
        part: Dict[str, np.ndarray] = {
            c: np.array(a, copy=True) for c, a in key_arrays.items()
        }
        for c, mat in mats.items():
            if mat.dtype == object:
                part[c] = _fold_exact(weights, mat)
            else:
                if amp > max_amplification:
                    raise CodedReconstructionError(
                        f"float decode amplification {amp:.3g} exceeds "
                        f"bound {max_amplification:.3g}"
                    )
                wf = np.asarray([float(w) for w in weights], np.float64)
                part[c] = wf @ mat
        out.append(part)
    return out
