"""Stage executor of the ported path.

The counterpart of ``dryad_tpu/exec/executor.py`` reduced to what the
ported stages need:

- Stages run in order, each fed its inputs, grouped into retry units
  (:func:`retry_regions`): the reference compiles each maximal run of
  stages into one program (``plan/fuse.py``, on by default) and retries
  the run as a whole, so the port retries the same runs; a stage the
  width adaptation may re-dispatch stands alone, as there.  A unit
  holding an op outside ``NON_OVERFLOW_OPS`` (an exchange, a resize, a
  join) reads its overflow flag before its consumers run, in one
  device->host copy with the observed row counts the width adaptation
  wants.  On overflow the unit reruns with the boost doubled, up to
  ``2 ** max_shuffle_retries``; past that it fails with the
  reference's message.  Units that cannot overflow never synchronise.
- Observed-volume width adaptation, as the reference: a stage whose ops
  are all width-insensitive (``ADAPT_OK_OPS``), with a full-width
  exchange, fed only by stages whose observed output is tail-sized,
  reruns its exchanges at a reduced power-of-two width (a join side
  whose exchange was elided gets one).  Escalated boosts (4 and up)
  drop the reduced width first.  The reference also counts
  overflow-free units that join its speculative dispatch window while
  one is open; the port reads each flag before consumers run and has no
  such window, so only overflow-capable units report counts.
- After the job, the deferred dictionary/range-miss counters of every
  unit are read in ONE copy; a nonzero count raises, as the
  reference's ``_raise_miss``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from dryad_tpu_torch.columnar.batch import ColumnBatch
from dryad_tpu_torch.exec.kernels import NON_OVERFLOW_OPS, StageContext, run_ops
from dryad_tpu_torch.exec.operands import DeviceTables
from dryad_tpu_torch.plan.lower import Stage, StageGraph, StageOp, tail_width

# Op kinds proven width-insensitive: the observed-volume adapter may
# re-dispatch a stage of only these at a reduced fan (the reference's
# ``plan/fuse.py`` set).
ADAPT_OK_OPS = frozenset({
    "select", "where", "project", "exchange_hash", "exchange_range",
    "resize", "group_reduce", "group_reduce_dense", "local_sort",
    "join", "scalar_agg", "string_code",
})


class StageFailedError(RuntimeError):
    """A stage reached a terminal failure (budget, capacity, guard)."""


def _miss_message(name: str, m: int) -> str:
    return (
        f"stage {name!r}: {m} rows fall outside the dense "
        "path's key domain (STRING values missing from the "
        "context dictionary, or INT32 keys past their "
        "ingest-time range — fabricated at run time?); the "
        "dense kernel would drop them. Register/ingest the "
        "values, or use group_by(salt=) to force the sort "
        "path."
    )


def _exhausted_message(name: str, ops, boost: int) -> str:
    """The reference's message for a stage past its last retry; an
    expansion join points at the knob that bounds a hot key's pairs."""
    if any("expansion" in op.params for op in ops):
        hint = (
            "raise the join's expansion= argument (hot keys multiply pair "
            "counts quadratically), shuffle_slack, or partition count"
        )
    else:
        hint = "raise shuffle_slack or partition count"
    return f"stage {name!r} still overflowing at boost {boost}; {hint}"


def _slot_reroutes(stage: Stage, slot: int) -> bool:
    """True when the first op touching ``slot`` is an exchange: rows
    re-route by key, so upstream placement does not matter."""
    for op in stage.ops:
        touched = [op.params.get(k) for k in ("slot", "left_slot", "right_slot") if k in op.params]
        if slot in touched:
            return op.kind in ("exchange_hash", "exchange_range")
    return False


def _adaptable(stage: Stage) -> bool:
    return all(op.kind in ADAPT_OK_OPS for op in stage.ops) and any(
        op.kind in ("exchange_hash", "exchange_range") and not op.params.get("nparts")
        for op in stage.ops
    )


def _fan_adapted_stage(stage: Stage, fan: int) -> Stage:
    """Stage copy whose full-width exchanges and resizes concentrate
    onto ``fan`` partitions; a join side whose exchange was elided on
    its partition claim gets a reduced-width exchange inserted, so both
    sides stay co-partitioned (the reference's rewrite)."""
    ops: List[StageOp] = []
    exchanged = set()
    for op in stage.ops:
        if op.kind == "join":
            for side, keys_p in (("left_slot", "left_keys"), ("right_slot", "right_keys")):
                sl = op.params[side]
                if sl not in exchanged and keys_p in op.params:
                    ops.append(StageOp("exchange_hash", {
                        "slot": sl, "keys": list(op.params[keys_p]), "nparts": fan,
                    }))
                    ops.append(StageOp("resize", {"slot": sl, "factor": 1.0, "nparts": fan}))
                    exchanged.add(sl)
        if op.kind in ("exchange_hash", "exchange_range", "resize"):
            exchanged.add(op.params.get("slot"))
            if not op.params.get("nparts"):
                ops.append(StageOp(op.kind, {**op.params, "nparts": fan}))
                continue
        ops.append(op)
    return Stage(
        stage.id, stage.name, list(stage.input_refs), ops=ops,
        out_slots=list(stage.out_slots), growth=stage.growth,
    )


# Aggregation-shaped ops that shrink data by orders of magnitude: a
# stage fed by one of them may adapt its width (the reference's set).
SHRINKING_OPS = frozenset({
    "group_reduce", "group_reduce_dense", "distinct", "scalar_agg", "topk",
})


def _adapt_candidate(stage: Stage, by_id: Dict[int, Stage], config) -> bool:
    """A stage the width adaptation may re-dispatch at a reduced width:
    adaptable ops, every input from a stage, one of them aggregation-
    shaped.  Such a stage retries on its own."""
    if not getattr(config, "tail_fanout_rows", 0) or not _adaptable(stage):
        return False
    producers = []
    for ref, _idx in stage.input_refs:
        if ref == "plan_input" or ref not in by_id:
            return False
        producers.append(by_id[ref])
    return any(op.kind in SHRINKING_OPS for p in producers for op in p.ops)


def retry_regions(graph: StageGraph, config) -> List[List[Stage]]:
    """The units that run and retry as one, in order: maximal runs of
    consecutive stages, an adaptation candidate (:func:`_adapt_candidate`)
    standing alone.  The reference compiles each such run into one
    program (``plan/fuse.py``) whose overflow retries the whole run at
    the next boost; the port runs the member stages one after another
    and retries the run the same way, so capacities, range splitters and
    overflow events follow the reference's."""
    if len(graph.stages) <= 1:
        return [[s] for s in graph.stages]
    by_id = {s.id: s for s in graph.stages}
    units: List[List[Stage]] = []
    run: List[Stage] = []
    for s in graph.stages:
        if _adapt_candidate(s, by_id, config):
            if run:
                units.append(run)
                run = []
            units.append([s])
        else:
            run.append(s)
    if run:
        units.append(run)
    return units


def _unit_name(unit: List[Stage]) -> str:
    """A run's name: its members' op-kind tokens, each once."""
    seen: Dict[str, None] = {}
    for m in unit:
        for tok in m.name.split("+"):
            seen.setdefault(tok)
    return "+".join(seen)


class GraphExecutor:
    def __init__(self, P: int, config, device):
        self.P = P
        self.config = config
        self.device = torch.device(device)
        self.tables = DeviceTables(self.device)
        # the last job's retries and adaptations, as (kind, name, value):
        # ("stage_overflow", name, boost) for each overflowed attempt,
        # ("stage_width_adapt", name, fan) for each adapted stage; a run
        # of stages is named by its members' tokens (``_unit_name``)
        self.events: List[Tuple[str, str, int]] = []

    def execute(
        self, graph: StageGraph, bindings: Dict[int, ColumnBatch]
    ) -> Dict[Tuple[int, int], ColumnBatch]:
        results: Dict[Tuple[int, int], ColumnBatch] = {}
        misses = []  # (unit name, miss counter)
        self.events = []
        units = retry_regions(graph, self.config)
        self._prepare_width_adapt(graph, units)
        for unit in units:
            misses.append(self._run_unit(unit, bindings, results))
        if misses:
            counts = torch.stack([m for _, m in misses]).cpu().tolist()
            for (name, _), m in zip(misses, counts):
                if m:
                    raise StageFailedError(_miss_message(name, int(m)))
        return results

    # -- one unit (a stage or a run of stages), with the overflow retry ------
    def _run_unit(self, unit: List[Stage], bindings, results):
        solo = unit[0] if len(unit) == 1 else None
        name = solo.name if solo else _unit_name(unit)
        ops = [op for m in unit for op in m.ops]
        can_overflow = any(op.kind not in NON_OVERFLOW_OPS for op in ops)
        adapt_fan = self._adapt_fan_for(solo) if solo else None
        if adapt_fan:
            self.events.append(("stage_width_adapt", name, adapt_fan))
        exports = self._exports[id(unit)]
        want_count = can_overflow and id(unit) in self._count_wanted
        boost = 1
        while True:
            overflow = dict_miss = None  # or-ed / summed over the members
            for m in unit:
                # escalated boosts drop the reduced width first: the
                # concentration itself may be what overflowed
                run = _fan_adapted_stage(m, adapt_fan) if adapt_fan and boost < 4 else m
                ctx = StageContext(
                    self.P, self.device, self.tables, self.config.shuffle_slack, boost
                )
                ctx.bind_inputs(tuple(
                    bindings[idx] if ref == "plan_input" else results[(ref, idx)]
                    for ref, idx in m.input_refs
                ))
                run_ops(ctx, run.ops)
                for i, slot in enumerate(m.out_slots):
                    results[(m.id, i)] = ctx.slots[slot]
                overflow = ctx.overflow if overflow is None else overflow | ctx.overflow
                dict_miss = ctx.dict_miss if dict_miss is None else dict_miss + ctx.dict_miss
            if not can_overflow:
                return name, dict_miss
            flags = [overflow.to(torch.int64)]
            if want_count:
                flags += [results[e].valid.sum() for e in exports]
            host = torch.stack(flags).cpu().tolist()
            if not host[0]:
                for e, c in zip(exports if want_count else (), host[1:]):
                    self._observed_rows[e] = int(c)
                return name, dict_miss
            self.events.append(("stage_overflow", name, boost))
            if boost >= 2 ** self.config.max_shuffle_retries:
                raise StageFailedError(_exhausted_message(name, ops, boost))
            boost *= 2

    # -- observed-volume stage-width adaptation ----------------------------
    def _prepare_width_adapt(self, graph: StageGraph, units: List[List[Stage]]) -> None:
        """Per unit: which outputs it exports (consumed by later units
        or by the plan's roots; the observed counts key on them), whether
        a later adaptable stage wants its counts, and per exported output
        whether every consumer re-routes it through a leading exchange (an
        adapted output no longer meets the full-width claim its plan node
        advertises; a run of stages counts as not re-routing, as the
        reference's fused region does)."""
        self._observed_rows: Dict[Tuple[int, int], int] = {}
        self._count_wanted: set = set()
        self._adapt_safe: Dict[Tuple[int, int], bool] = {}
        self._exports: Dict[int, List[Tuple[int, int]]] = {}
        unit_of = {m.id: unit for unit in units for m in unit}
        roots = set(graph.outputs.values())
        consumed = {
            (ref, idx)
            for s in graph.stages for ref, idx in s.input_refs
            if ref != "plan_input" and unit_of[ref] is not unit_of[s.id]
        }
        limit = getattr(self.config, "tail_fanout_rows", 0)
        for unit in units:
            solo = unit[0] if len(unit) == 1 else None
            ex = [
                (m.id, i) for m in unit for i in range(len(m.out_slots))
                if solo is not None or (m.id, i) in consumed or (m.id, i) in roots
            ]
            self._exports[id(unit)] = ex or [(unit[-1].id, i) for i in range(len(unit[-1].out_slots))]
            members = {m.id for m in unit}
            for m in unit:
                for j, (ref, idx) in enumerate(m.input_refs):
                    if ref == "plan_input" or ref in members:
                        continue
                    ok = solo is not None and _slot_reroutes(solo, j)
                    self._adapt_safe[(ref, idx)] = self._adapt_safe.get((ref, idx), True) and ok
            if limit and solo is not None and _adaptable(solo):
                for ref, _idx in solo.input_refs:
                    if ref != "plan_input":
                        self._count_wanted.add(id(unit_of[ref]))

    def _adapt_fan_for(self, stage: Stage) -> Optional[int]:
        """Reduced width for this stage from its inputs' observed rows;
        None = run as lowered."""
        if not getattr(self.config, "tail_fanout_rows", 0) or not _adaptable(stage):
            return None
        if not all(
            self._adapt_safe.get((stage.id, i), True) for i in range(len(stage.out_slots))
        ):
            return None  # a consumer pinned this stage to full width
        total = 0
        for ref, idx in stage.input_refs:
            if ref == "plan_input":
                return None  # static bindings: lowering already decided
            c = self._observed_rows.get((ref, idx))
            if c is None:
                return None
            total += c
        w = tail_width(total, self.config, self.P)
        if w is None:
            return None
        fan = 1 << (w - 1).bit_length()  # power-of-two widths
        return fan if fan < self.P else None
