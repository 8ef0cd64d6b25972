"""Whole-DAG fusion: the decision, as the reference takes it.

The counterpart of ``dryad_tpu/plan/fuse.py`` for its decision only:
which maximal runs of consecutive device-eligible stages the reference
stitches into one compiled program (a ``FusedStage`` region), and, per
broken seam, why.  :func:`fuse` returns the :class:`FuseReport` that
``tools/explain.py`` renders and that the executor turns into
``fuse_break`` events.  The port does not rewire the graph into regions:
the executor runs and retries the report's regions as units
(``exec/executor.py::retry_regions``), each unit one stage program
(``exec/programs.py``: one CUDA graph on the card) built through
``parallel/stage.py::compile_fused``.

Eligibility (a seam BREAKS, with its reason, when a rule fails):

- every op of the stage is a device kernel of :data:`FUSABLE_OPS`
  (``apply_host`` / ``do_while`` stages are driver-evaluated host
  boundaries — ``host_boundary:*``);
- a stage shaped for observed-volume width adaptation (all ops
  width-insensitive, a full-width exchange, statically unbounded
  non-plan inputs, and a shrinking producer) stays unfused so the
  executor's runtime re-widthing still applies (``width_adapt:*``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from dryad_tpu_torch.plan.lower import Stage, StageGraph, _stage_ids

# Stage-op kinds the fuser admits into a fused region (the reference's
# set: every op kind with a device kernel).
FUSABLE_OPS = frozenset({
    "select", "where", "project", "seed", "select_many", "apply",
    "exchange_hash", "exchange_range", "resize",
    "group_reduce", "group_reduce_dense", "string_code",
    "group_combine", "distinct", "local_sort", "topk",
    "join", "semi", "concat", "take", "with_rank", "skip", "tail",
    "take_while", "skip_while", "reverse", "default_if_empty",
    "scalar_agg", "fork", "group_join_count", "join_ranked", "zip",
    "sliding_window",
})

# Driver-evaluated stages: hard host boundaries no region may cross.
DRIVER_OPS = frozenset({"do_while", "apply_host"})

# Op kinds proven width-insensitive: the observed-volume width adapter
# may re-dispatch a stage of only these at a reduced fan (one definition
# for this pass's adapt-seam rule and the executor's runtime gate).
ADAPT_OK_OPS = frozenset({
    "select", "where", "project", "exchange_hash", "exchange_range",
    "resize", "group_reduce", "group_reduce_dense", "local_sort",
    "join", "scalar_agg", "string_code",
})

# Aggregation-shaped ops that shrink data by orders of magnitude: the
# producers whose observed output makes width adaptation worth a sync.
SHRINKING_OPS = frozenset({
    "group_reduce", "group_reduce_dense", "distinct", "scalar_agg",
    "topk",
})


@dataclasses.dataclass
class FuseReport:
    """What fuses and why seams break — the explain/debug surface."""

    enabled: bool
    # one entry per dispatch unit, in dispatch order:
    # {"id", "members": [stage ids], "names": [...], "fused": bool,
    #  "reason": Optional[str]}  (reason set on unfused singletons)
    regions: List[Dict[str, Any]]
    # {"after": stage id, "before": stage id, "reason": str} per
    # consecutive-stage boundary that does NOT fuse
    breaks: List[Dict[str, Any]]
    n_stages: int
    n_dispatch_units: int


def _ineligible_reason(stage: Stage) -> Optional[str]:
    """None when every op is fusable; else the seam-break reason."""
    for op in stage.ops:
        if op.kind in DRIVER_OPS:
            return f"host_boundary:{op.kind}"
        if op.kind not in FUSABLE_OPS:
            return f"unsupported_op:{op.kind}"
    return None


def _is_shrinker(stage: Stage) -> bool:
    return any(op.kind in SHRINKING_OPS for op in stage.ops)


def _adaptable_shape(stage: Stage) -> bool:
    """All ops width-insensitive and at least one full-width exchange
    (the executor's ``_adaptable``)."""
    return all(op.kind in ADAPT_OK_OPS for op in stage.ops) and any(
        op.kind in ("exchange_hash", "exchange_range") and not op.params.get("nparts")
        for op in stage.ops
    )


def _adapt_candidate(stage: Stage, by_id: Dict[int, Stage], config, single_axis: bool) -> bool:
    """True when the executor could re-dispatch ``stage`` at an
    observed-volume-reduced width: fusing it would pin it to the static
    full width, so the pass leaves it alone.  A hybrid mesh
    (``single_axis`` False) adapts no width."""
    if not single_axis or not getattr(config, "tail_fanout_rows", 0):
        return False
    if not _adaptable_shape(stage):
        return False
    producers = []
    for ref, _idx in stage.input_refs:
        if ref == "plan_input":
            return False  # static bindings: lowering already decided
        p = by_id.get(ref)
        if p is None:
            return False
        producers.append(p)
    return any(_is_shrinker(p) for p in producers)


def fuse(graph: StageGraph, config, single_axis: bool = True) -> FuseReport:
    """The reference's fusion decision over ``graph`` (stages in
    topological order, so any contiguous run is a valid region) on a
    flat mesh, or with ``single_axis`` False a hybrid one.  A fused
    region takes a fresh id from the stage counter, as the reference's
    ``FusedStage`` does."""
    by_id = {s.id: s for s in graph.stages}
    # None = fusable; a string = unfused singleton + reason
    cls: Dict[int, Optional[str]] = {}
    for s in graph.stages:
        reason = _ineligible_reason(s)
        if reason is None and _adapt_candidate(s, by_id, config, single_axis):
            reason = "width_adapt:observed-volume adaptation opportunity"
        cls[s.id] = reason

    runs: List[List[Stage]] = []
    cur: List[Stage] = []
    for s in graph.stages:
        if cls[s.id] is None:
            cur.append(s)
        else:
            if cur:
                runs.append(cur)
                cur = []
            runs.append([s])
    if cur:
        runs.append(cur)

    breaks: List[Dict[str, Any]] = []
    for a, b in zip(graph.stages, graph.stages[1:]):
        if cls[a.id] is None and cls[b.id] is None:
            continue  # same run
        breaks.append({
            "after": a.id, "before": b.id,
            "reason": cls[b.id] or cls[a.id] or "single_stage",
        })

    regions: List[Dict[str, Any]] = []
    for run in runs:
        if len(run) < 2 or cls[run[0].id] is not None:
            for s in run:
                regions.append({
                    "id": s.id, "members": [s.id], "names": [s.name],
                    "fused": False, "reason": cls[s.id],
                })
            continue
        regions.append({
            "id": next(_stage_ids), "members": [m.id for m in run],
            "names": [m.name for m in run], "fused": True, "reason": None,
        })
    return FuseReport(
        enabled=True, regions=regions, breaks=breaks,
        n_stages=len(graph.stages), n_dispatch_units=len(regions),
    )


def unfused(graph: StageGraph) -> FuseReport:
    """The decision with ``plan_fuse`` off: every stage is its own unit
    and no seam is reported, as in the reference's per-stage path."""
    regions = [
        {"id": s.id, "members": [s.id], "names": [s.name],
         "fused": False, "reason": None}
        for s in graph.stages
    ]
    return FuseReport(
        enabled=False, regions=regions, breaks=[],
        n_stages=len(graph.stages), n_dispatch_units=len(regions),
    )
