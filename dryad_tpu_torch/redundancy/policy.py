"""Per-stage coding eligibility.

Coding is only SOUND for partials that form a vector space: the coded
vertex computes an integer linear combination of per-partition partial
aggregates, so the combiner's merge must be elementwise addition with
a zero identity.  That holds for the builtin sum/count/mean partial
plans (``exec.partial.LINEAR_AGGS``) and for ``Decomposable``s that
declare ``linear=True`` with a registered zero ``identity``.
Everything else — min/max/any/all/first, order-dependent or lattice
merges, undeclared custom combiners — falls back to today's
duplicate-on-straggle + retry path, loudly (a ``coded_fallback``
event names the reason).

A second, mechanical gate: coded partial files carry fixed-width
numeric columns only, so STRING key/state columns (which decode to
Python objects) keep the duplicate path too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from dryad_tpu_torch.columnar.schema import ColumnType
from dryad_tpu_torch.exec.partial import LINEAR_AGGS


@dataclasses.dataclass(frozen=True)
class CodedDecision:
    """Outcome of the per-stage policy check."""

    apply: bool
    reason: str
    k: int = 0
    r: int = 0
    key_cols: Tuple[str, ...] = ()
    state_cols: Tuple[str, ...] = ()
    kind: str = ""


def _no(reason: str) -> CodedDecision:
    return CodedDecision(False, reason)


def decide(
    partial_query,
    merge_spec,
    config,
    nparts: int,
    requested: Optional[bool] = None,
) -> CodedDecision:
    """Decide whether a partitioned-aggregation submission runs coded.

    ``partial_query`` is the per-vertex partial plan (its schema types
    the coded file columns); ``merge_spec`` is the rewrite descriptor
    from ``LocalJobSubmission._rewrite_partial_group``; ``requested``
    overrides ``config.coded_redundancy`` (True forces the check even
    with the config off; False disables outright).
    """
    enabled = config.coded_redundancy if requested is None else requested
    if not enabled:
        return _no("coded redundancy disabled")
    if nparts < 2:
        return _no("needs >= 2 data shards (nparts < 2)")
    kind, keys, plan_or_dec, _out_schema = merge_spec
    if kind == "group_dec":
        dec = plan_or_dec
        if not getattr(dec, "linear", False):
            return _no(
                "Decomposable not declared linear=True (merge must be "
                "elementwise addition for coding to be sound)"
            )
        ident = getattr(dec, "identity", None)
        if ident is None or set(ident) != set(dec.state_cols):
            return _no("linear Decomposable without a registered identity")
        if any(v != 0 for v in ident.values()):
            return _no("linear identity must be the additive zero")
        state: Sequence[str] = [n for n, _ct in dec.state_fields]
    elif kind in ("group", "aggregate"):
        plan = plan_or_dec
        nonlinear = sorted(
            {op for _o, op, _p in plan if op not in LINEAR_AGGS}
        )
        if nonlinear:
            return _no(f"non-linear aggregate(s) {nonlinear}")
        state = [p for _o, _op, pcols in plan for p in pcols]
    else:
        return _no(f"unsupported partial kind {kind!r}")
    strings = [
        f.name for f in partial_query.schema.fields
        if f.ctype is ColumnType.STRING
    ]
    if strings:
        return _no(
            f"STRING column(s) {strings} in the partial schema (coded "
            "files carry fixed-width numerics only)"
        )
    r = max(1, int(config.coded_parity_tasks))
    return CodedDecision(
        True, "linear partials", k=int(nparts), r=r,
        key_cols=tuple(keys), state_cols=tuple(dict.fromkeys(state)),
        kind=kind,
    )
