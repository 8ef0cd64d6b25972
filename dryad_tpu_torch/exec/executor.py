"""Stage executor of the ported path.

The counterpart of ``dryad_tpu/exec/executor.py`` reduced to what the
ported stages need:

- Stages run in order, each fed its inputs.  A stage holding an op
  outside ``NON_OVERFLOW_OPS`` (an exchange or a resize) reads its
  overflow flag before its consumers run, in one device->host copy with
  the observed row counts the width adaptation wants.  On overflow the
  stage reruns with the boost doubled, up to ``2 ** max_shuffle_retries``;
  past that it fails with the reference's message.  Stages that cannot
  overflow never synchronise.
- Observed-volume width adaptation, as the reference: a stage whose ops
  are all width-insensitive (``ADAPT_OK_OPS``), with a full-width
  exchange, fed only by stages whose observed output is tail-sized,
  reruns its exchanges at a reduced power-of-two width.  Escalated
  boosts (4 and up) drop the reduced width first.  The reference also
  counts overflow-free stages that join its speculative dispatch window
  while one is open; the port reads each flag before consumers run and
  has no such window, so only overflow-capable producers report counts.
  The join branch of the reference's adapted-stage rewrite waits for
  joins (ROADMAP.md queue 1 item 10).
- After the job, the deferred dictionary/range-miss counters of every
  stage are read in ONE copy; a nonzero count raises, as the
  reference's ``_raise_miss``.
- The reference fuses runs of stages into one program (``plan/fuse.py``,
  queue 1 item 10); the port runs every stage on its own.
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


def _slot_reroutes(stage: Stage, slot: int) -> bool:
    """True when the first op touching ``slot`` is an exchange: rows
    re-route by key, so upstream placement does not matter."""
    for op in stage.ops:
        if op.params.get("slot") == slot:
            return op.kind in ("exchange_hash", "exchange_range")
    return False


def _adaptable(stage: Stage) -> bool:
    return all(op.kind in ADAPT_OK_OPS for op in stage.ops) and any(
        op.kind in ("exchange_hash", "exchange_range") and not op.params.get("nparts")
        for op in stage.ops
    )


def _fan_adapted_stage(stage: Stage, fan: int) -> Stage:
    """Stage copy whose full-width exchanges and resizes concentrate
    onto ``fan`` partitions."""
    ops: List[StageOp] = []
    for op in stage.ops:
        if op.kind in ("exchange_hash", "exchange_range", "resize") and not op.params.get("nparts"):
            ops.append(StageOp(op.kind, {**op.params, "nparts": fan}))
        else:
            ops.append(op)
    return Stage(
        stage.id, stage.name, list(stage.input_refs), ops=ops,
        out_slots=list(stage.out_slots), growth=stage.growth,
    )


class GraphExecutor:
    def __init__(self, P: int, config, device):
        self.P = P
        self.config = config
        self.device = torch.device(device)
        self.tables = DeviceTables(self.device)
        # the last job's retries and adaptations, as (kind, stage name,
        # value): ("stage_overflow", name, boost) for each overflowed
        # attempt, ("stage_width_adapt", name, fan) for each adapted stage
        self.events: List[Tuple[str, str, int]] = []

    def execute(
        self, graph: StageGraph, bindings: Dict[int, ColumnBatch]
    ) -> Dict[Tuple[int, int], ColumnBatch]:
        results: Dict[Tuple[int, int], ColumnBatch] = {}
        misses = []  # (stage name, miss counter)
        self.events = []
        self._prepare_width_adapt(graph)
        for stage in graph.stages:
            outs, miss = self._run_stage(stage, bindings, results)
            for i, out in enumerate(outs):
                results[(stage.id, i)] = out
            misses.append((stage.name, miss))
        if misses:
            counts = torch.stack([m for _, m in misses]).cpu().tolist()
            for (name, _), m in zip(misses, counts):
                if m:
                    raise StageFailedError(_miss_message(name, int(m)))
        return results

    # -- one stage, with the overflow retry ---------------------------------
    def _run_stage(self, stage: Stage, bindings, results):
        ins = tuple(
            bindings[idx] if ref == "plan_input" else results[(ref, idx)]
            for ref, idx in stage.input_refs
        )
        can_overflow = any(op.kind not in NON_OVERFLOW_OPS for op in stage.ops)
        adapt_fan = self._adapt_fan_for(stage)
        if adapt_fan:
            self.events.append(("stage_width_adapt", stage.name, adapt_fan))
        want_count = can_overflow and stage.id in self._count_wanted
        boost = 1
        while True:
            # escalated boosts drop the reduced width first: the
            # concentration itself may be what overflowed
            run = _fan_adapted_stage(stage, adapt_fan) if adapt_fan and boost < 4 else stage
            ctx = StageContext(
                self.P, self.device, self.tables, self.config.shuffle_slack, boost
            )
            ctx.bind_inputs(ins)
            run_ops(ctx, run.ops)
            outs = [ctx.slots[slot] for slot in stage.out_slots]
            if not can_overflow:
                return outs, ctx.dict_miss
            flags = [ctx.overflow.to(torch.int64)]
            if want_count:
                flags += [o.valid.sum() for o in outs]
            host = torch.stack(flags).cpu().tolist()
            if not host[0]:
                for i, c in enumerate(host[1:]):
                    self._observed_rows[(stage.id, i)] = int(c)
                return outs, ctx.dict_miss
            self.events.append(("stage_overflow", stage.name, boost))
            if boost >= 2 ** self.config.max_shuffle_retries:
                raise StageFailedError(
                    f"stage {stage.name!r} still overflowing at boost {boost}; "
                    "raise shuffle_slack or partition count"
                )
            boost *= 2

    # -- observed-volume stage-width adaptation ----------------------------
    def _prepare_width_adapt(self, graph: StageGraph) -> None:
        self._observed_rows: Dict[Tuple[int, int], int] = {}
        self._count_wanted: set = set()
        # (producer stage, out index) -> every consumer re-routes it
        # through a leading exchange (an adapted output no longer meets
        # the full-width claim its plan node advertises)
        self._adapt_safe: Dict[Tuple[int, int], bool] = {}
        limit = getattr(self.config, "tail_fanout_rows", 0)
        for st in graph.stages:
            for j, (ref, idx) in enumerate(st.input_refs):
                if ref == "plan_input":
                    continue
                key = (ref, idx)
                self._adapt_safe[key] = self._adapt_safe.get(key, True) and _slot_reroutes(st, j)
            if limit and _adaptable(st):
                for ref, _idx in st.input_refs:
                    if ref != "plan_input":
                        self._count_wanted.add(ref)

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
