"""User-defined decomposable aggregations (a copy of
``dryad_tpu/api/decomposable.py`` whose exemplars use ``torch``).

The analog of the reference's ``IDecomposable`` contract
(``LinqToDryad/IDecomposable.cs:35-71``): an aggregation splits into
Seed (per-row initial accumulator), Accumulate/RecursiveAccumulate
(associative merge of accumulators — one fn here since accumulators are
columns), and FinalReduce (finalize).  The optimizer uses this to build
the partial-aggregation tree: local combine before the shuffle, final
combine after (``DryadLinqDecomposition.cs:34``;
``DrDynamicAggregateManager.h:117-168``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from dryad_tpu_torch.columnar.schema import ColumnType


@dataclasses.dataclass
class Decomposable:
    """seed: cols -> state cols (vectorized over rows: ``(P, cap)``
    tensors in the port).
    merge: (state_a, state_b) -> state (associative, vectorized).
    finalize: cols -> cols (optional; runs after the final combine).
    state_cols: physical state column names produced by ``seed``.
    out_fields: logical (name, ColumnType) list for the final output
    columns (after ``finalize`` if present, else the state columns).
    state_fields: OPTIONAL logical (name, ColumnType) list typing the
    state columns themselves (the reference's independent-vertex
    submission reads it; the port has no such path yet).

    **Linearity**: ``linear=True`` declares that ``merge`` is
    ELEMENTWISE ADDITION of the state columns and ``identity`` is their
    additive zero (the contract the reference's coded stage redundancy
    relies on).  Declaring ``linear=True`` REQUIRES registering the
    identity element, one zero per state column, enforced here.
    """

    seed: Callable[[Dict], Dict]
    merge: Callable[[Dict, Dict], Dict]
    state_cols: Sequence[str]
    out_fields: Sequence[Tuple[str, ColumnType]]
    finalize: Optional[Callable[[Dict], Dict]] = None
    state_fields: Optional[Sequence[Tuple[str, ColumnType]]] = None
    linear: bool = False
    identity: Optional[Dict[str, Any]] = None

    def __post_init__(self) -> None:
        if not self.linear:
            return
        if self.identity is None:
            raise ValueError(
                "Decomposable(linear=True) requires a registered "
                "identity element: identity={state_col: 0, ...}"
            )
        if set(self.identity) != set(self.state_cols):
            raise ValueError(
                f"identity keys {sorted(self.identity)} must match "
                f"state_cols {sorted(self.state_cols)}"
            )
        bad = {k: v for k, v in self.identity.items() if v != 0}
        if bad:
            raise ValueError(
                "a linear Decomposable's merge is elementwise addition, "
                f"so its identity must be the additive zero; got {bad}"
            )


def delta_fold_reason(dec: "Decomposable") -> str:
    """Why a ``group_by(decomposable=...)`` plan cannot back an
    incremental materialized view (``dryad_tpu.views``) — the
    structured ``view_fallback`` reason.  A non-linear merge gives the
    delta fold no algebra at all; a linear one WOULD fold (state adds
    elementwise), but its seed/merge fns run on device tensors and the
    reference's view delta path folds on the HOST from client threads,
    so builtin aggregates remain the supported surface."""
    if not dec.linear:
        return "non-linear decomposable merge has no delta fold"
    return (
        "decomposable delta folds not supported (builtin aggregates "
        "only)"
    )


# Registry of known-linear Decomposables (the reference's coded-
# redundancy suite sweeps its own copy).  Users may register their own.
LINEAR_DECOMPOSABLES: Dict[str, Decomposable] = {}


def register_linear(name: str, dec: Decomposable) -> Decomposable:
    """Register a linear Decomposable exemplar (validates the flag)."""
    if not dec.linear:
        raise ValueError(f"{name!r} is not declared linear=True")
    # graftlint: disable=kernel-determinism -- import-time registration API; the table is fixed before any vertex runs
    LINEAR_DECOMPOSABLES[name] = dec
    return dec


# -- builtin linear exemplars (sum / count / moment histograms) -------------

def _vecsum_seed(cols):
    return {"s": cols["v"]}


def _vecsum_merge(a, b):
    return {"s": a["s"] + b["s"]}


def _countsum_seed(cols):
    return {"cnt": torch.ones_like(cols["v"]), "s": cols["v"]}


def _countsum_merge(a, b):
    return {"cnt": a["cnt"] + b["cnt"], "s": a["s"] + b["s"]}


def _countsum_finalize(cols):
    return {"mean": cols["s"] / torch.clamp(cols["cnt"], min=1)}


def _moments_seed(cols):
    return {
        "cnt": torch.ones_like(cols["v"]),
        "s1": cols["v"],
        "s2": cols["v"] * cols["v"],
    }


def _moments_merge(a, b):
    return {k: a[k] + b[k] for k in ("cnt", "s1", "s2")}


def _moments_finalize(cols):
    c = torch.clamp(cols["cnt"], min=1)
    m = cols["s1"] / c
    return {"var": cols["s2"] / c - m * m}


def _intsum_seed(cols):
    return {"t": cols["v"]}


def _intsum_merge(a, b):
    return {"t": a["t"] + b["t"]}


register_linear("vecsum", Decomposable(
    seed=_vecsum_seed, merge=_vecsum_merge, state_cols=["s"],
    out_fields=[("s", ColumnType.FLOAT32)],
    state_fields=[("s", ColumnType.FLOAT32)],
    linear=True, identity={"s": 0},
))
register_linear("countsum", Decomposable(
    seed=_countsum_seed, merge=_countsum_merge, state_cols=["cnt", "s"],
    out_fields=[("mean", ColumnType.FLOAT32)],
    state_fields=[
        ("cnt", ColumnType.FLOAT32), ("s", ColumnType.FLOAT32),
    ],
    finalize=_countsum_finalize,
    linear=True, identity={"cnt": 0, "s": 0},
))
register_linear("moments", Decomposable(
    seed=_moments_seed, merge=_moments_merge,
    state_cols=["cnt", "s1", "s2"],
    out_fields=[("var", ColumnType.FLOAT32)],
    state_fields=[
        ("cnt", ColumnType.FLOAT32), ("s1", ColumnType.FLOAT32),
        ("s2", ColumnType.FLOAT32),
    ],
    finalize=_moments_finalize,
    linear=True, identity={"cnt": 0, "s1": 0, "s2": 0},
))
register_linear("intsum", Decomposable(
    seed=_intsum_seed, merge=_intsum_merge,
    state_cols=["t"],
    out_fields=[("t", ColumnType.INT32)],
    state_fields=[("t", ColumnType.INT32)],
    linear=True, identity={"t": 0},
))
