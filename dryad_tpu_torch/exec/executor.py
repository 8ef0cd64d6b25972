"""Stage executor of the ported path.

The counterpart of ``dryad_tpu/exec/executor.py`` reduced to what the
ported stages need:

- Stages run in order, each fed its inputs, grouped into retry units
  (:func:`retry_regions`), the regions of ``plan/fuse.py``'s decision:
  the reference compiles each maximal run of stages into one program
  (on by default) and retries the run as a whole, so the port runs and
  retries the same runs; a stage the width adaptation may re-dispatch,
  and a driver stage (``do_while``, ``apply_host``), stands alone, as
  there.
- Each unit runs as one stage program (``exec/programs.py``) cached
  under the reference's lowering key ``(unit key, boost, shape key,
  resolved window, fan)``: one CUDA graph on the card in one process,
  captured at the key's first dispatch and replayed on every later
  one; the unit's eager function on the CPU and over a gloo group.
  The key's first dispatch logs ``xla_compile`` (after ``stage_start``
  / ``fused_dispatch`` and the fault consultation, before the
  attempt's ``exchange_round`` events) and the ``xla_compiles`` /
  ``xla_compile_s`` metrics; the flight recorder's ``xla_programs``
  probe reads the cache's size.
- The speculative dispatch window, as the reference's: a unit holding
  an op outside ``NON_OVERFLOW_OPS`` (an exchange, a resize, a join)
  joins the window, and so does every unit dispatched while it is
  open; the window's overflow flags and the row counts the width
  adaptation wants are read in ONE device->host copy when it holds
  ``overflow_sync_depth`` units, before a driver stage, before a stage
  that could adapt its width from a count it holds, and at job end.
  On overflow the clean prefix is kept and the overflowing unit and
  everything dispatched after it rerun one by one, the first at boost
  2; each rerun unit retries with the boost doubled up to
  ``2 ** max_shuffle_retries`` and past that fails with the
  reference's message.  With depth 1 each overflow-capable unit reads
  its flag at once and overflow-free units never synchronise.
- Observed-volume width adaptation, as the reference: a stage whose ops
  are all width-insensitive (``ADAPT_OK_OPS``), with a full-width
  exchange, fed only by stages whose observed output is tail-sized,
  reruns its exchanges at a reduced power-of-two width (a join side
  whose exchange was elided gets one).  Escalated boosts (4 and up)
  drop the reduced width first.  Counts are those of units read
  synchronously or drained from the window, so a stage adapts exactly
  when the reference's does.
- ``do_while`` first tries the reference's on-device loop (with
  ``device=True``, and always under the default
  ``config.do_while_device_auto``): body and condition lowered to one
  stage each (the context's ``loop_lowerer``) run as one loop program
  (``exec/devloop.py``: one CUDA graph a run on the card), logging
  ``do_while_device_start`` and ``do_while_device_done``; an overflow
  reruns it at twice the boost.  A lowering refusal (``ValueError``),
  or a body that changes the carry (``TypeError``), logs
  ``do_while_device_fallback`` and runs the reference's driver loop
  (body, then condition, the state compacted after every round, its
  capacity boosted on overflow).  A body or condition that reads a
  value to the host raises ``TypeError`` on the card (the driver
  loop's stage programs would refuse the read too).  ``apply_host`` is
  its host round trip per partition.
- The string coding tables of each dispatch attempt come from the
  content-addressed operand pool (``exec/operands.py``), which scatters
  a widened table's delta and counts its bytes into ``h2d_bytes`` and
  ``operand_h2d_bytes``; the flight recorder's ``operand_pool`` probe
  reads its counters.
- After the job, the deferred dictionary/range-miss counters of every
  unit are read in ONE copy; a nonzero count raises, as the
  reference's ``_raise_miss``.  ``execute(defer_miss=True)`` hands
  that read to the caller (:class:`DeferredFinish`), who makes it
  beside the result's own copy, as the reference's asynchronous
  result fetches do.
- The staged-exchange window of each dispatch attempt
  (:meth:`GraphExecutor._resolve_window`): ``config.exchange_window``,
  or under -1 the rewriter's ``retune_exchange`` hint, then the
  measured headroom, then ``exchange_hbm_budget_mb``.  The on-device
  ``do_while`` runs flat exchanges and logs no rounds, as the
  reference's loop program does.  On a hybrid mesh no fan-out is
  reduced and no width adapts, as in the reference.
- Every job writes the reference's events to the context's
  :class:`~dryad_tpu_torch.exec.events.EventLog`, with the reference's
  fields, in its order: ``fuse_break`` per seam of ``plan/fuse.py``'s
  decision, ``job_start``, per unit ``stage_fanout`` /
  ``stage_width_adapt``, then per attempt ``stage_start`` (and
  ``fused_dispatch`` for a run of stages), one ``exchange_round`` per
  planned round of each of its exchanges (the planner's static byte
  accounting, members in order), followed by
  ``stage_complete``, ``stage_overflow`` or, inside the window,
  ``stage_dispatched``; a drain logs ``overflow_drain`` and completes
  its clean prefix; ``do_while_*`` and ``apply_host_*`` for the driver
  stages; ``job_complete`` after the miss check (``dict_miss`` and
  ``job_failed`` on the failure paths).  A unit's ``stage`` id is its
  region's id in that decision.  Each dispatch attempt is one ``span``
  (cat=execute) stamped with the active query's ``qid``.
- Versioned re-execution under injected faults, as the reference:
  before each dispatch attempt the fault registry
  (``exec/faults.py``) may fail the unit (``InjectedFault``), kill the
  process (a seeded plan on a worker) or delay it.  A failure is
  classified against the unit's attempt history
  (``exec/failure.py::classify``): a transient one logs
  ``stage_failed``, waits the seeded backoff of ``RetryPolicy`` and
  reruns the unit as the next version (``stage_start`` again); a
  deterministic repeat, or the ``max_stage_failures`` budget spent,
  logs ``job_failed`` and raises :class:`JobFailedError` carrying
  every :class:`Attempt`.  Fault tokens match the unit's name (the
  fused op name, ``group_by``).  Each synchronous attempt feeds the
  unit name's :class:`StageStatistics`; an outlier logs
  ``stage_straggler``.
- :meth:`GraphExecutor.graph_key` is the structural identity of a
  lowered graph (the reference's compile-cache key), which the serving
  tier's result cache keys on.
- With ``config.checkpoint_dir`` set, each unit's outputs are saved
  under a Merkle fingerprint of its ops, input shapes and input
  fingerprints (``exec/checkpoint.py``) and a later run with the same
  fingerprint loads them instead of dispatching (``stage_checkpoint_hit``,
  no ``stage_start``).  A unit with a dictionary-miss guard saves only
  after the job's miss check passed (at ``DeferredFinish.finish``).
- With ``config.profile_dir`` set, a top-level job runs inside a
  ``torch.profiler`` session (CUDA activity recorded when the device
  is the card) and writes one Chrome trace into the directory on exit
  (``profile_trace`` names it); each dispatch attempt is a
  ``record_function`` range named after its unit, the reference's
  per-stage step marker.  A nested run (a ``do_while`` subplan) records
  into the open session, and a job that starts while another profiler
  is active (a caller's own) records into that one and logs
  ``profile_trace`` with ``skipped``.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
import time
import weakref
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dryad_tpu_torch.columnar.batch import ColumnBatch, to_host_column
from dryad_tpu_torch.exec.checkpoint import CheckpointStore, stage_fingerprint
from dryad_tpu_torch.exec.events import EventLog
from dryad_tpu_torch.exec import faults
from dryad_tpu_torch.exec.failure import (
    Attempt, FailureKind, JobFailedError, RetryPolicy, StageFailedError, classify,
)
from dryad_tpu_torch.exec.kernels import (
    NON_OVERFLOW_OPS, OPERAND_PARAMS, StageContext, _round8, run_ops,
)
from dryad_tpu_torch.ops import shuffle as SH
from dryad_tpu_torch.exec.devloop import HostReadError, LoopProgram
from dryad_tpu_torch.exec.operands import BakedOperands, DeviceOperandPool, operand_objects
from dryad_tpu_torch.exec.programs import PositionalOperands, ProgramCache, types_of
from dryad_tpu_torch.exec.stats import StageStatistics
from dryad_tpu_torch.obs import flightrec, tracectx
from dryad_tpu_torch.obs.metrics import MetricsRegistry
from dryad_tpu_torch.obs.span import Tracer
from dryad_tpu_torch.parallel import partition as PART
from dryad_tpu_torch.parallel import stage as STAGE
from dryad_tpu_torch.parallel.mesh import mesh_axes
from dryad_tpu_torch.plan.fuse import (
    DRIVER_OPS, SHRINKING_OPS, FuseReport, _adaptable_shape as _adaptable, fuse,
    unfused,
)
from dryad_tpu_torch.plan.lower import Stage, StageGraph, StageOp, tail_width
from dryad_tpu_torch.plan.xchgplan import resolve_window
from dryad_tpu_torch.utils.logging import get_logger

_log = get_logger("dryad_tpu_torch.exec")

LOOP_PROGRAMS = 8  # on-device do_while programs an executor keeps

# trace files of ``config.profile_dir``, numbered within the process
_PROFILE_SEQ = itertools.count()

__all__ = ["DeferredFinish", "GraphExecutor", "JobFailedError", "StageFailedError", "retry_regions"]

def _has_miss_guard(ops) -> bool:
    """Ops whose dense domain counts rows it would drop: STRING
    dictionary coding, or the guarded int auto-dense reduce."""
    return any(
        op.kind == "string_code"
        or (op.kind == "group_reduce_dense" and op.params.get("guard"))
        for op in ops
    )


def _region_structure(unit: List[Stage], exports) -> Tuple[list, list]:
    """A run's wiring and exports, as the reference's ``FusedStage``
    holds them: per member, one entry per input, ``("mem", member
    position, output)`` or ``("ext", external input position)``; the
    exports as ``(member position, output)``."""
    pos = {m.id: i for i, m in enumerate(unit)}
    ext: Dict[Tuple, int] = {}
    wiring = []
    for m in unit:
        w = []
        for ref, idx in m.input_refs:
            if ref != "plan_input" and ref in pos:
                w.append(("mem", pos[ref], idx))
            else:
                w.append(("ext", ext.setdefault((ref, idx), len(ext))))
        wiring.append(tuple(w))
    return wiring, [(pos[sid], i) for sid, i in exports]


class _UnitStage:
    """A run of stages seen as one stage by the checkpoint store (the
    reference's ``FusedStage`` surface): its id is the region's, its
    name the members' tokens, its ops the members' chained, its
    ``out_slots`` one per export; ``fingerprint_extra`` adds the run's
    member boundaries, wiring and exports to the identity."""

    def __init__(self, uid: int, name: str, unit: List[Stage], exports):
        self.id = uid
        self.name = name
        self.ops = [op for m in unit for op in m.ops]
        self.out_slots = list(range(len(exports)))
        wiring, ex = _region_structure(unit, exports)
        self.fingerprint_extra = (
            f"fused:members={[(len(m.ops), tuple(m.out_slots)) for m in unit]!r}"
            f":wiring={wiring!r}:exports={ex!r}"
        )


class DeferredFinish:
    """Tail of an ``execute(defer_miss=True)`` job: its dictionary-miss
    counters, read when the caller fetches the result, and the
    checkpoint saves of miss-guarded units, which wait for them.
    ``finish()`` raises ``StageFailedError`` on a nonzero counter
    (``job_failed`` and ``dict_miss`` logged, as the reference's; the
    gated checkpoints are dropped) and otherwise writes them and logs
    ``job_complete``; ``abort(reason)`` closes a job whose result copy
    failed, persisting nothing."""

    def __init__(self, executor: "GraphExecutor", pending, ckpts=()):
        self._executor = executor
        self._pending = pending
        self._ckpts = list(ckpts)

    def abort(self, reason: str) -> None:
        self._pending = []
        self._ckpts = []
        self._executor.event_log.emit("job_failed", reason=reason, failure_kind="transient")

    def finish(self, deferred: bool = True) -> None:
        """``deferred=False``: the executor's own check at job end,
        which logs ``dict_miss`` alone, as the reference's."""
        pending, self._pending = self._pending, []
        log = self._executor.event_log
        if pending:
            counts = torch.stack([m for _, m in pending]).cpu().tolist()
            for (name, _), m in zip(pending, counts):
                if m:
                    self._ckpts = []  # poisoned results: never persist
                    if deferred:
                        log.emit("job_failed", reason=f"dict miss in {name}",
                                 failure_kind="deterministic")
                    log.emit("dict_miss", stage_name=name, rows=int(m))
                    raise StageFailedError(_miss_message(name, int(m)))
        ckpts, self._ckpts = self._ckpts, []
        for stage, fp, outs in ckpts:
            self._executor._write_checkpoint(stage, fp, outs)
        log.emit("job_complete")


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


def _driver_kind(stage: Stage) -> Optional[str]:
    return next((op.kind for op in stage.ops if op.kind in DRIVER_OPS), None)


def retry_regions(graph: StageGraph, report: FuseReport) -> List[List[Stage]]:
    """The units that run and retry as one, in order: the regions of
    the fusion decision ``report`` (``plan/fuse.py``): maximal runs of
    consecutive stages, with an adaptation candidate or a driver stage
    standing alone.  The reference compiles each such run into one
    program whose overflow retries the whole run at the next boost; the
    port runs each as one stage program (its members' ops in order) and
    retries the run the same way, so capacities, range splitters and
    overflow events follow the reference's."""
    by_id = {s.id: s for s in graph.stages}
    return [[by_id[m] for m in r["members"]] for r in report.regions]


def _unit_refs(unit: List[Stage]) -> List[Tuple]:
    """A unit's external inputs, ``(producer or "plan_input", index)``
    each once, in order of first use."""
    members = {m.id for m in unit}
    refs: List[Tuple] = []
    for m in unit:
        for ref, idx in m.input_refs:
            if (ref == "plan_input" or ref not in members) and (ref, idx) not in refs:
                refs.append((ref, idx))
    return refs


def _unit_name(unit: List[Stage]) -> str:
    """A run's name: its members' op-kind tokens, each once."""
    seen: Dict[str, None] = {}
    for m in unit:
        for tok in m.name.split("+"):
            seen.setdefault(tok)
    return "+".join(seen)


def _phys_np_dtype(col: str, schema) -> np.dtype:
    """Host numpy dtype of one physical column (split words uint32)."""
    if "#" in col:
        return np.dtype(np.uint32)
    return schema.field(col).ctype.numpy_dtype


class GraphExecutor:
    def __init__(self, P: int, config, device, event_log: Optional[EventLog] = None, mesh=None):
        self.P = P
        # the partitions' mesh (parallel/mesh.py); over a process group
        # every stage's flags, misses and counts are reduced across the
        # ranks (parallel/stage.py), so every rank decides alike
        self.mesh = mesh
        self.config = config
        self.device = torch.device(device)
        # every job's events, the reference's kinds and fields
        self.event_log = event_log if event_log is not None else EventLog(None)
        # counters and histograms of the stream driver (spill and
        # transfer bytes, per-piece rows) and of the operand pool,
        # written as ``metrics`` events
        self.metrics = MetricsRegistry()
        # string coding tables: the pool feeds each dispatch (runtime
        # tables, the default); baked tables feed the device loop and
        # the ``stringcode_runtime_tables=False`` path, as the
        # reference's compiled constants do
        self.runtime_operands = bool(getattr(config, "stringcode_runtime_tables", True))
        self.operand_pool = DeviceOperandPool(self.device, metrics=self.metrics)
        self.baked_operands = BakedOperands(self.device)
        pool = weakref.ref(self.operand_pool)  # the probe must not pin the executor
        flightrec.probe("operand_pool", lambda: _pool_probe(pool()))
        # each retry unit's program by lowering key (exec/programs.py):
        # CUDA graphs on the card in one process, the eager function on
        # the CPU and over a gloo group; the flight recorder's
        # ``xla_programs`` probe reads how many are cached
        self.programs = ProgramCache(self.device, mesh, events=self.event_log, metrics=self.metrics)
        progs = weakref.ref(self.programs)
        flightrec.probe("xla_programs", lambda: len(progs() or ()))
        # on-device do_while programs by the reference's key, the
        # LOOP_PROGRAMS most recent: a plan built with fresh lambdas is a
        # new key each run, and each graph holds a private pool; the
        # rest are freed when the executor goes
        self._loops: "OrderedDict[Tuple, LoopProgram]" = OrderedDict()
        weakref.finalize(self, _release_loops, self._loops)
        # lowers a do_while subplan to one stage, during a job only (the
        # context's method; see ``subquery_runner``)
        self.loop_lowerer = None
        # the last job's retries, adaptations and loop rounds, as (kind,
        # name, value): ("stage_overflow", name, boost) for each
        # overflowed attempt, ("stage_width_adapt", name, fan) for each
        # adapted stage (a run of stages is named by its members' tokens,
        # ``_unit_name``), ("do_while_iter", name, round),
        # ("do_while_state_boost", name, boost) and ("do_while_max_iter",
        # name, rounds); a do_while's subplans add theirs to its job's
        self.events: List[Tuple[str, str, int]] = []
        # runs a do_while body or condition subplan, during a job only:
        # the context's method, kept past the job, would keep the
        # context (and its device tables) alive in a reference cycle
        self.subquery_runner = None
        self._depth = 0  # do_while subplans re-enter execute()
        # one execute span (cat=execute) per dispatch attempt
        self.tracer = Tracer(self.event_log)
        # content-addressed stage outputs, when a directory is set
        self.checkpoints = (
            CheckpointStore(config.checkpoint_dir, events=self.event_log)
            if getattr(config, "checkpoint_dir", None) else None
        )
        # per-unit-name duration models (straggler events)
        self.stats: Dict[str, StageStatistics] = {}
        # injected failures: seeded backoff under the per-stage budget;
        # deterministic repeats fail fast
        self.retry_policy = RetryPolicy(
            max_attempts=config.max_stage_failures,
            backoff_base=config.retry_backoff_base,
            backoff_max=config.retry_backoff_max,
            jitter=config.retry_jitter,
            seed=config.retry_seed,
        )
        # injectable sleep: backoff-timing tests record instead of wait
        self._sleep: Callable[[float], None] = time.sleep
        # the runtime plan rewriter (rewrite/controller.py), wired by the
        # context after construction; consulted for per-unit starting
        # boost floors (overflow pre-widening) and, under
        # ``exchange_window=-1``, its exchange-window hint
        # (``retune_exchange``)
        self.rewriter = None
        self._rewrites_applied: set = set()
        # the measured headroom of the context's resource sampler
        # (obs/telemetry.py), wired by the context; the auto
        # exchange-window policy reads it (None: the configured budget)
        self.headroom = None
        # True while this executor's profiler session is open: a nested
        # execute (a do_while subplan) records into it
        self._profiling = False

    # -- structural identity -------------------------------------------------
    def _stage_key(self, stage: Stage, split_operands: bool = True) -> Tuple:
        """Structural stage identity: op kinds + static params.  A
        value-hashable param keys by value, so a rebuilt query shares
        the key; any other hashable object (a user function, an
        ``AggSpec``) keys by reference, held alive by the key, so a
        closure-bearing plan shares it only when run again from the same
        ``Query``; an unhashable param keys by its repr.  The string
        tables of ``OPERAND_PARAMS`` key by their shape tier, as the
        reference's runtime operands do
        (``config.stringcode_runtime_tables``); ``split_operands=False``
        keys them by content (the device loop holds its tables)."""
        split = split_operands and self.runtime_operands
        parts = []
        for op in stage.ops:
            items = []
            for k, v in sorted(op.params.items()):
                if split and (op.kind, k) in OPERAND_PARAMS and hasattr(v, "operand_signature"):
                    items.append((k, ("operand", v.operand_signature())))
                    continue
                if isinstance(v, list):
                    v = tuple(v)
                try:
                    hash(v)
                except TypeError:
                    v = repr(v)
                items.append((k, v))
            parts.append((op.kind, tuple(items)))
        return (tuple(parts), tuple(stage.out_slots))

    def graph_key(self, graph: StageGraph) -> Tuple:
        """Structural identity of a lowered graph, one ``_stage_key``
        per stage in graph order: the serving tier's result-cache key
        (the reference's ``graph_key``).  Lowerings share a key iff
        their stages match under ``_stage_key``'s rules."""
        return tuple(self._stage_key(s) for s in graph.stages)

    def execute(
        self, graph: StageGraph, bindings: Dict[int, ColumnBatch], subquery_runner=None,
        defer_miss: bool = False, binding_fps: Optional[Dict[int, Optional[str]]] = None,
        loop_lowerer=None,
    ):
        """Run the graph; returns its results by ``(stage id, output)``,
        or with ``defer_miss`` ``(results, DeferredFinish)``, whose
        ``finish()`` the caller runs when it reads the result.
        ``binding_fps``: plan-input node id -> content fingerprint (None:
        not fingerprintable), the inputs' part of each checkpoint
        identity.  ``loop_lowerer``: lowers a do_while subplan to one
        stage (the on-device loop's; without it every loop runs the
        driver loop)."""
        top = self._depth == 0
        if top:
            self.events = []
            self.programs.begin_job()  # its programs are kept until it ends
        # the adaptation state is per graph: a nested run keeps its own
        saved = tuple(getattr(self, a, None) for a in _ADAPT_STATE)
        saved_runner, saved_lowerer = self.subquery_runner, self.loop_lowerer
        self.subquery_runner = subquery_runner or saved_runner
        self.loop_lowerer = loop_lowerer or saved_lowerer
        self._depth += 1
        try:
            with self._profile():
                results, misses, ckpts = self._execute(graph, bindings, binding_fps or {})
        finally:
            self._depth -= 1
            self.subquery_runner, self.loop_lowerer = saved_runner, saved_lowerer
            for a, v in zip(_ADAPT_STATE, saved):
                setattr(self, a, v)
            if top:
                self.programs.end_job()
        deferred = DeferredFinish(self, misses, ckpts)
        if defer_miss:
            return results, deferred
        deferred.finish(deferred=False)
        return results

    def _profile(self):
        """The profiler session of a top-level job under
        ``config.profile_dir``, or a null context: without the
        directory, inside this executor's own session, or while another
        profiler is active (it records the same work)."""
        pdir = getattr(self.config, "profile_dir", None)
        if not pdir or self._profiling:
            return contextlib.nullcontext()
        if torch._C._autograd._profiler_enabled():
            self.event_log.emit("profile_trace", path=None, skipped="profiler_active")
            return contextlib.nullcontext()
        return self._profile_session(pdir)

    @contextlib.contextmanager
    def _profile_session(self, pdir: str):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(pdir, exist_ok=True)
        path = os.path.join(
            pdir, f"job-{int(time.time() * 1000)}-{os.getpid()}-{next(_PROFILE_SEQ)}.json")
        self._profiling = True
        prof = profile(activities=acts)
        try:
            with prof:
                yield
        finally:
            self._profiling = False
            prof.export_chrome_trace(path)
            self.event_log.emit("profile_trace", path=path)

    def _execute(self, graph: StageGraph, bindings, binding_fps):
        results: Dict[Tuple[int, int], ColumnBatch] = {}
        misses: List[Tuple[str, torch.Tensor]] = []  # (unit name, miss counter)
        # (unit stage, fp, outputs) saves that wait for the miss check
        self._gated_ckpts: List[tuple] = []
        report = (fuse(graph, self.config, single_axis=self._single_axis())
                  if self.config.plan_fuse else unfused(graph))
        units = retry_regions(graph, report)
        self._start_job(graph, report, units)
        self._prepare_width_adapt(graph, units)
        depth = max(1, self.config.overflow_sync_depth)
        window: List[dict] = []
        # (member stage id, output) -> its unit's fingerprint and export
        # position, the upstream part of a consumer's identity
        self._out_fp: Dict[Tuple[int, int], Optional[str]] = {}
        self._unit_fp: Dict[int, Optional[str]] = {}  # id(unit) -> fingerprint
        self._binding_fps = binding_fps
        for unit in units:
            driver = _driver_kind(unit[0])
            if driver:
                self._drain(window, bindings, results, misses)
                stage = unit[0]
                (current,) = self._inputs(stage, bindings, results)
                with STAGE.named_failures(self.mesh, stage.name):
                    if driver == "do_while":
                        results[(stage.id, 0)] = self._run_do_while(stage, current, misses)
                    else:
                        results[(stage.id, 0)] = self._run_apply_host(stage, current)
                self._out_fp[(stage.id, 0)] = None  # loop state / host fn: opaque
                continue
            if window and self._drain_for_adapt(unit, window):
                # a count this stage could adapt from sits in the window
                self._drain(window, bindings, results, misses)
            self._run_unit(unit, bindings, results, misses, window if depth > 1 else None)
            if len(window) >= depth:
                self._drain(window, bindings, results, misses)
        self._drain(window, bindings, results, misses)
        return results, misses, self._gated_ckpts

    # -- checkpoints -----------------------------------------------------------
    def _unit_stage(self, unit: List[Stage]):
        """The stage the checkpoint store sees for ``unit``: the stage
        itself, or for a run of stages its :class:`_UnitStage`."""
        if len(unit) == 1:
            return unit[0]
        return _UnitStage(self._unit_id[id(unit)], _unit_name(unit), unit,
                          self._exports[id(unit)])

    def _unit_fingerprint(self, unit: List[Stage], bindings, results) -> Optional[str]:
        """Merkle identity of a unit: its ops and out slots, its
        external inputs' shapes (columns and capacity) and their
        fingerprints (a binding's content digest, or the producing
        unit's fingerprint and export position).  None when an input
        cannot be fingerprinted (a device binding, a loop state)."""
        fps, shapes = [], []
        for ref, idx in _unit_refs(unit):
            b = bindings[idx] if ref == "plan_input" else results[(ref, idx)]
            shapes.append((tuple(sorted(b.data.keys())), b.capacity))
            fps.append(self._binding_fps.get(idx) if ref == "plan_input"
                       else self._out_fp.get((ref, idx)))
        fp = stage_fingerprint(self._unit_stage(unit), tuple(shapes), tuple(fps))
        self._unit_fp[id(unit)] = fp
        for pos, e in enumerate(self._exports[id(unit)]):
            self._out_fp[e] = f"{fp}:{pos}" if fp is not None else None
        return fp

    def _load_checkpoint(self, unit: List[Stage], bindings, results) -> bool:
        """Publish a unit's outputs from its checkpoint, when one with
        its fingerprint exists and reads clean."""
        fp = self._unit_fingerprint(unit, bindings, results)
        if fp is None:
            return False
        stage = self._unit_stage(unit)
        exports = self._exports[id(unit)]
        hit = self.checkpoints.load(stage, fp, self.device, self.P)
        if hit is None or len(hit) != len(exports):
            return False
        self.event_log.emit("stage_checkpoint_hit", stage=stage.id, name=stage.name)
        for e, b in zip(exports, hit):
            results[e] = b
        return True

    def _save_checkpoint(self, unit: List[Stage], results) -> None:
        """Save a clean unit's exports; a unit with a miss guard waits
        for the job's miss check (its saves ride ``DeferredFinish``), so
        a result whose dense domain dropped rows is never persisted."""
        if self.checkpoints is None:
            return
        fp = self._unit_fp.get(id(unit))
        if fp is None:
            return
        stage = self._unit_stage(unit)
        outs = tuple(results[e] for e in self._exports[id(unit)])
        if _has_miss_guard(stage.ops):
            self._gated_ckpts.append((stage, fp, outs))
            return
        self._write_checkpoint(stage, fp, outs)

    def _write_checkpoint(self, stage, fp: str, outs) -> None:
        if self.config.checkpoint_retain_seconds is not None:
            n = self.checkpoints.gc(self.config.checkpoint_retain_seconds)
            if n:
                self.event_log.emit("checkpoint_gc", removed=n)
        try:
            path = self.checkpoints.save(stage, fp, tuple(outs[: len(stage.out_slots)]))
            self.event_log.emit("stage_checkpoint_saved", stage=stage.id, name=stage.name,
                                path=path)
        except OSError as e:
            _log.warning("checkpoint save failed for %s: %s", stage.name, e)

    def _note(self, kind: str, label: str, value: int, **fields) -> None:
        """Log an event and keep its ``(kind, name, value)`` record."""
        self.events.append((kind, label, value))
        self.event_log.emit(kind, **fields)

    def _start_job(self, graph: StageGraph, report: FuseReport, units: List[List[Stage]]) -> None:
        """Log the fusion decision's seams and ``job_start`` with the
        topology of the units, and fix each unit's id (its region's)."""
        if len(graph.stages) > 1:
            for br in report.breaks:
                self.event_log.emit(
                    "fuse_break", after=br["after"], before=br["before"], reason=br["reason"],
                )
        self._unit_id = {id(u): r["id"] for u, r in zip(units, report.regions)}
        owner = {m.id: self._unit_id[id(u)] for u in units for m in u}
        topology = []
        for u in units:
            members = {m.id for m in u}
            deps: List[list] = []
            for m in u:
                for ref, idx in m.input_refs:
                    if ref in members:
                        continue
                    dep = ["in", idx] if ref == "plan_input" else [owner[ref], idx]
                    if dep not in deps:
                        deps.append(dep)
            topology.append({"id": self._unit_id[id(u)], "name": _unit_name(u), "deps": deps})
        self.event_log.emit("job_start", stages=len(units), topology=topology)

    def _inputs(self, stage: Stage, bindings, results) -> Tuple[ColumnBatch, ...]:
        return tuple(
            bindings[idx] if ref == "plan_input" else results[(ref, idx)]
            for ref, idx in stage.input_refs
        )

    # -- one unit (a stage or a run of stages), with the overflow retry ------
    def _run_unit(self, unit: List[Stage], bindings, results, misses, window, boost: int = 1):
        """Run a unit.  Inside an open window (``window`` a list) it is
        dispatched once and its flag and counts wait for the drain;
        otherwise an overflow-capable unit reads its flag (and wanted
        counts) at once and retries until clean.  With checkpoints on,
        a unit whose fingerprint has a checkpoint is loaded instead."""
        if self.checkpoints is not None and self._load_checkpoint(unit, bindings, results):
            return
        solo = unit[0] if len(unit) == 1 else None
        name = solo.name if solo else _unit_name(unit)
        sid = self._unit_id[id(unit)]
        log = self.event_log
        ops = [op for m in unit for op in m.ops]
        can_overflow = any(op.kind not in NON_OVERFLOW_OPS for op in ops)
        static_fan = [op.params["nparts"] for op in ops if op.params.get("nparts")]
        # the kernels reduce the fan-out on a flat mesh only: the event
        # says what runs
        if static_fan and self._single_axis() and min(static_fan) < self.P:
            log.emit("stage_fanout", stage=sid, name=name, nparts=min(static_fan), of=self.P)
        adapt_fan = self._adapt_fan_for(solo) if solo else None
        if adapt_fan:
            observed = sum(self._observed_rows.get(r, 0) for r in solo.input_refs)
            self._note("stage_width_adapt", name, adapt_fan, stage=sid, name=name,
                       nparts=adapt_fan, of=self.P, observed_rows=observed)
        exports = self._exports[id(unit)]
        want_count = id(unit) in self._count_wanted and (can_overflow or bool(window))
        st = self.stats.setdefault(name, StageStatistics(self.config.outlier_sigmas))
        if self.rewriter is not None and can_overflow:
            # an overflow_loop diagnosis raised this unit's starting
            # boost: the next dispatch skips the narrow attempts
            floor = self.rewriter.boost_floor(name)
            if floor > boost:
                boost = floor
                if (name, floor) not in self._rewrites_applied:
                    self._rewrites_applied.add((name, floor))
                    log.emit("plan_rewrite", phase="applied", action="prewiden_palette",
                             rule="overflow_loop", subject=name, stage=name, boost=floor)
        failures = 0
        attempts: List[Attempt] = []  # failed-attempt history (post-mortem)
        version = 0
        while True:
            version += 1
            log.emit("stage_start", stage=sid, name=name, version=version, boost=boost)
            if solo is None:
                log.emit("fused_dispatch", stage=sid, name=name, members=len(unit),
                         version=version, boost=boost)
            t0 = time.time()
            try:
                self._inject_faults(sid, name)
            except faults.InjectedFault as e:
                failures += 1
                self._stage_failed(sid, name, version, e, failures, attempts)
                continue  # versioned re-execution (after the backoff)
            # escalated boosts drop the reduced width first: the
            # concentration itself may be what overflowed
            fan = adapt_fan if adapt_fan and boost < 4 else None
            host = None
            with torch.profiler.record_function(name), \
                    self.tracer.span(name, cat="execute", stage=sid, version=version, boost=boost), \
                    STAGE.named_failures(self.mesh, name):
                overflow, dict_miss, counts, rounds = self._dispatch(
                    unit, bindings, results, fan, boost)
                # the planner's static accounting: every dispatch attempt
                # ships these bytes again
                for rnd in rounds:
                    log.emit("exchange_round", stage=sid, name=name,
                             qid=tracectx.current_qid(), **rnd)
                counts = counts if want_count else []
                windowed = window is not None and (can_overflow or bool(window))
                if windowed:
                    window.append(dict(
                        unit=unit, name=name, sid=sid, ops=ops, boost=boost, miss=dict_miss,
                        flag=overflow if can_overflow else None, counts=counts,
                        version=version, t0=t0, fan=fan,
                    ))
                    log.emit("stage_dispatched", stage=sid, name=name, version=version,
                             boost=boost, inflight=len(window))
                elif can_overflow:
                    host = torch.stack([overflow.to(torch.int64)] + counts).cpu().tolist()
            if windowed:
                return
            dt = time.time() - t0
            st.record(dt)
            if st.is_outlier(dt):
                log.emit("stage_straggler", stage=sid, name=name, version=version,
                         seconds=dt, threshold=st.outlier_threshold())
            if not can_overflow:
                misses.append((name, dict_miss))
                # overflow-free units report their dispatch time
                log.emit("stage_complete", stage=sid, name=name, version=version,
                         seconds=dt, **{"async": True})
                if not fan:  # a reduced-width layout is not what the fingerprint says
                    self._save_checkpoint(unit, results)
                return
            if not host[0]:
                self._record(exports, host[1:])
                misses.append((name, dict_miss))
                log.emit("stage_complete", stage=sid, name=name, version=version, seconds=dt)
                if not fan:
                    self._save_checkpoint(unit, results)
                return
            self._note("stage_overflow", name, boost, stage=sid, name=name,
                       version=version, boost=boost)
            if boost >= 2 ** self.config.max_shuffle_retries:
                log.emit("job_failed", stage=sid, name=name, failure_kind="resource",
                         reason="shuffle overflow at max boost")
                flightrec.dump_now(f"overflow_exhausted:{name}")
                raise StageFailedError(_exhausted_message(name, ops, boost))
            boost *= 2

    def _inject_faults(self, sid: int, name: str) -> None:
        """The fault registry's consultation points before a dispatch
        (``exec/faults.py``): an injected failure raises, a seeded kill
        ends this process (after logging ``worker_killed_injected`` and
        dumping the flight recorder: ``os._exit`` skips atexit), an
        injected delay stalls the attempt."""
        faults.registry.maybe_fail(name)
        if faults.registry.maybe_kill(name):
            self.event_log.emit("worker_killed_injected", stage=sid, name=name)
            flightrec.dump_now(f"worker_killed:{name}")
            os._exit(113)
        delay = faults.registry.maybe_delay(name)
        if delay:
            self.event_log.emit("stage_delay_injected", stage=sid, name=name, seconds=delay)
            self._sleep(delay)

    def _stage_failed(self, sid: int, name: str, version: int, e: Exception,
                      failures: int, attempts: List[Attempt]) -> None:
        """Account one injected failure of a unit: classify it against
        the history, log ``stage_failed``, and either back off (seeded)
        before the next version or, on a deterministic repeat or an
        exhausted budget, log ``job_failed`` and raise
        :class:`JobFailedError` with the attempt history."""
        kind = classify(e, attempts)
        exhausted = self.retry_policy.exhausted(failures)
        # deterministic repeats fail fast: identical class + message
        # means elsewhere/later cannot help
        terminal = exhausted or kind is FailureKind.DETERMINISTIC
        backoff = 0.0 if terminal else self.retry_policy.backoff(name, failures)
        attempts.append(Attempt(
            number=version, error_type=type(e).__name__, error=str(e),
            kind=kind.value, backoff=backoff,
        ))
        self.event_log.emit(
            "stage_failed", stage=sid, name=name, version=version, error=str(e),
            failures=failures, failure_kind=kind.value, backoff=round(backoff, 4),
        )
        if terminal:
            self.event_log.emit("job_failed", stage=sid, name=name,
                                failure_kind=kind.value, reason=str(e))
            why = (
                "failed deterministically (identical error reproduced; "
                "retrying cannot help)"
                if kind is FailureKind.DETERMINISTIC and not exhausted
                else f"exceeded failure budget ({self.config.max_stage_failures})"
            )
            flightrec.dump_now(f"job_failed:{name}")
            raise JobFailedError(
                f"stage {name!r} {why}: {e}", stage=name, attempts=attempts,
            ) from e
        if backoff:
            self._sleep(backoff)

    def _dispatch(self, unit: List[Stage], bindings, results, fan, boost: int):
        """Run a unit once through its stage program (``exec/programs.py``):
        the program under the unit's lowering key, built at the key's
        first dispatch.  Publishes the unit's exports and returns its
        overflow flag and dictionary-miss counter (or-ed and summed over
        the members), its exports' row counts (each reduced over a
        gang's group) and its exchanges' per-round accounting, in member
        order."""
        inputs = self._unit_inputs(unit, bindings, results)
        window = self._resolve_window(inputs, boost)
        run = [_fan_adapted_stage(m, fan) if fan else m for m in unit]
        exports = self._exports[id(unit)]
        # the attempt's tables, each fetched once: from the pool (runtime
        # tables, copied into the program's buffers) or baked
        objs = operand_objects([op for m in run for op in m.ops], OPERAND_PARAMS)
        src = self.operand_pool if self.runtime_operands else self.baked_operands
        tables = [src.get(o) for o in objs]
        key = (self._unit_key(run, exports), boost, _shape_key(inputs), window, fan)
        name = unit[0].name if len(unit) == 1 else _unit_name(unit)
        prog = self.programs.get(key, name, lambda: self._build_program(
            unit, run, exports, objs, boost, window), types_of(inputs, tables))
        outs, overflow, dict_miss, counts = self.programs.run(prog, inputs, tables)
        for e, b in zip(exports, outs):
            results[e] = b
        return overflow, dict_miss, counts, prog.rounds

    def _unit_key(self, run: List[Stage], exports) -> Tuple:
        """A unit's structural identity: its stage's key, or for a run of
        stages the members' keys with the run's wiring and exports (the
        reference's ``"fused"`` key: member-local slots overlap, so the
        chained ops alone would alias differently wired runs)."""
        if len(run) == 1:
            return self._stage_key(run[0])
        wiring, ex = _region_structure(run, exports)
        return ("fused", tuple(self._stage_key(m) for m in run), tuple(wiring), tuple(ex))

    def _build_program(self, unit: List[Stage], run: List[Stage], exports, objs, boost: int,
                       window: int):
        """The unit's function over its external inputs and positional
        tables, and the cell its exchanges' rounds fill: a lone stage
        through ``parallel/stage.py::compile_stage``, a run of stages
        through ``compile_fused`` (the reduction over a gang's group)."""
        cell: List[dict] = []
        fn = _unit_fn(unit, run, exports, objs, self.P, self.device, self.config.shuffle_slack,
                      boost, self.mesh, window, cell)
        compile_ = STAGE.compile_stage if len(unit) == 1 else STAGE.compile_fused
        return compile_(self.mesh, fn), cell

    def _unit_inputs(self, unit: List[Stage], bindings, results) -> List[ColumnBatch]:
        """A unit's external inputs (the region's, as the reference's
        fused program takes them)."""
        return [bindings[idx] if ref == "plan_input" else results[(ref, idx)]
                for ref, idx in _unit_refs(unit)]

    def _single_axis(self) -> bool:
        """A flat mesh: fan-out reduction and width adaptation apply."""
        return len(mesh_axes(self.mesh)) == 1

    def _resolve_window(self, inputs, boost: int) -> int:
        """The staged-exchange window of one dispatch attempt (the
        reference's ``_resolve_window``).  ``config.exchange_window >=
        0`` passes through; ``-1`` asks ``plan/xchgplan.py::
        resolve_window`` with a per-destination bucket estimate from
        the inputs' shapes (the reference's global capacity times the
        boost over P, times slack, columns and 8 bytes), the configured
        budget, the rewriter's ``retune_exchange`` hint, and the
        measured headroom rounded down to a power of two (precedence:
        hint, headroom, budget); over a gang, the narrowest window of
        any rank.  The window is part of the dispatch's identity: the
        stage runs the exchange it names."""
        cfgw = int(self.config.exchange_window)
        if cfgw >= 0:
            return cfgw
        slack = float(self.config.shuffle_slack)
        bucket_bytes = 1
        for b in inputs:
            glob = b.capacity * self.P  # the reference's sharded capacity
            rows = -(-glob * max(1, int(boost)) // max(1, self.P))
            bucket_bytes = max(bucket_bytes, int(rows * slack) * max(1, len(b.data)) * 8)
        budget = int(self.config.exchange_hbm_budget_mb) << 20
        hint = self.rewriter.exchange_window_hint() if self.rewriter is not None else None
        headroom = None
        if self.headroom is not None:
            h = self.headroom.headroom_bytes()
            if h is not None and int(h) > 0:
                headroom = 1 << (int(h).bit_length() - 1)
        w = resolve_window(cfgw, self.P, bucket_bytes, budget, hint=hint, headroom_bytes=headroom)
        if self.mesh is not None and self.mesh.group is not None:
            # each rank measures its own headroom, and every rank must run
            # one schedule: the narrowest window any rank resolved (flat
            # counts as the widest)
            w = int(PART.allreduce(torch.tensor(w or self.P), "min", self.mesh))
            w = 0 if w >= self.P else w
        return w

    def _record(self, exports, counts) -> None:
        for e, c in zip(exports, counts):
            self._observed_rows[e] = int(c)

    def _drain(self, window: List[dict], bindings, results, misses) -> None:
        """Resolve the window in one device->host copy of its flags and
        counts.  All clean: record the counts.  Else keep the clean
        prefix, forget the counts from the first overflowing unit on,
        and rerun those units one by one, the first at boost 2."""
        if not window:
            return
        entries = list(window)
        window.clear()
        self.event_log.emit("overflow_drain", inflight=len(entries),
                            stages=[w["name"] for w in entries])
        parts = [w["flag"].to(torch.int64) for w in entries if w["flag"] is not None]
        parts += [c for w in entries for c in w["counts"]]
        host = iter(torch.stack(parts).cpu().tolist() if parts else [])
        flag_of = {id(w): next(host) for w in entries if w["flag"] is not None}
        count_of = {id(w): [next(host) for _ in w["counts"]] for w in entries}
        bad = next((i for i, w in enumerate(entries) if flag_of.get(id(w))), len(entries))
        for w in entries[:bad]:
            self._record(self._exports[id(w["unit"])], count_of[id(w)])
            misses.append((w["name"], w["miss"]))
            # dispatch to drain: the whole window's time
            self.event_log.emit("stage_complete", stage=w["sid"], name=w["name"],
                                version=w["version"], seconds=time.time() - w["t0"],
                                deferred=True)
            if not w["fan"]:
                self._save_checkpoint(w["unit"], results)
        if bad == len(entries):
            return
        for w in entries[bad:]:
            for e in self._exports[id(w["unit"])]:
                self._observed_rows.pop(e, None)
        first = entries[bad]
        self._note("stage_overflow", first["name"], first["boost"], stage=first["sid"],
                   name=first["name"], version=first["version"], boost=first["boost"])
        for j, w in enumerate(entries[bad:]):
            self._run_unit(w["unit"], bindings, results, misses, None, boost=2 if j == 0 else 1)

    def _drain_for_adapt(self, unit: List[Stage], window: List[dict]) -> bool:
        """Worth draining early: this stage could adapt its width, every
        input's count is known or held by the window, and a producer in
        the window is aggregation-shaped (the reference's rule)."""
        if len(unit) != 1 or not getattr(self.config, "tail_fanout_rows", 0) \
                or not self._single_axis():
            return False
        stage = unit[0]
        if not _adaptable(stage) or not self._consumers_allow_adapt(stage):
            return False
        in_window = {id(w["unit"]): w for w in window}
        shrinker = False
        for ref, idx in stage.input_refs:
            if ref == "plan_input":
                return False
            if (ref, idx) in self._observed_rows:
                continue
            w = in_window.get(id(self._unit_of[ref]))
            if w is None or not w["counts"]:
                return False
            shrinker = shrinker or any(op.kind in SHRINKING_OPS for op in w["ops"])
        return shrinker

    # -- driver stages -------------------------------------------------------
    def _run_do_while(self, stage: Stage, current: ColumnBatch, misses) -> ColumnBatch:
        """DoWhile.  With ``device=True`` or ``do_while_device_auto``,
        first the on-device loop (:meth:`_run_do_while_device`); on its
        refusal, or otherwise, the reference's driver loop: each round
        runs the body subplan on the current state, compacts the state
        back to ``base_pp * boost`` rows a partition (doubling ``boost``
        while it overflows, up to ``2 ** max_shuffle_retries``), then
        runs the condition subplan, whose one value is read on the
        host."""
        if self.subquery_runner is None:
            raise RuntimeError("do_while requires a subquery_runner (use DryadContext)")
        p = stage.ops[0].params
        auto = bool(getattr(self.config, "do_while_device_auto", False))
        if (p.get("device") or auto) and self.loop_lowerer is not None:
            try:
                return self._run_do_while_device(stage, p, current, misses)
            except HostReadError:
                raise  # the driver loop's stage programs refuse the same read
            except (ValueError, TypeError) as e:
                # ValueError: the lowerer refused the subplan (more than
                # one stage); TypeError: the body changes the carry
                self._note("do_while_device_fallback", stage.name, 0, stage=stage.id,
                           reason=str(e))
        base_pp = max(8, current.capacity)
        boost, it = 1, 0
        while True:
            it += 1
            if it > p["max_iter"]:
                self._note("do_while_max_iter", stage.name, it - 1, stage=stage.id, iters=it - 1)
                break
            self._note("do_while_iter", stage.name, it, stage=stage.id, iter=it)
            current = self.subquery_runner(p["body"], p["schema"], current)
            while True:
                compacted, ovf = SH.resize(current, _round8(base_pp * boost))
                if not bool(PART.any_(ovf, self.mesh)):  # every rank boosts alike
                    current = compacted
                    break
                if boost >= 2 ** self.config.max_shuffle_retries:
                    raise RuntimeError(
                        f"do_while state exceeded compaction capacity at "
                        f"boost {boost} (base {base_pp} rows/partition)"
                    )
                boost *= 2
                self._note("do_while_state_boost", stage.name, boost, stage=stage.id, boost=boost)
            if not self.subquery_runner(p["cond"], p["schema"], current, scalar=True):
                break
        return current

    def _run_do_while_device(self, stage: Stage, p, current: ColumnBatch, misses) -> ColumnBatch:
        """The reference's on-device DoWhile: body and condition lowered
        to one stage each run as one loop program (``exec/devloop.py``),
        cached under the reference's key (the stages, the carry layout,
        ``max_iter`` and the boost).  ``do_while_device_start`` comes
        before the carry check, as the reference's comes before the
        trace that raises; an overflow logs ``stage_overflow`` and reruns
        at twice the boost, up to ``2 ** max_shuffle_retries``.  The
        body's dictionary misses join the job's deferred miss check when
        a stage codes strings."""
        body_stage, body_schema = self.loop_lowerer(p["body"], p["schema"], current)
        cond_stage, cond_schema = self.loop_lowerer(p["cond"], body_schema, current)
        cond_col = cond_schema.device_names()[0]
        max_iter = int(p["max_iter"])
        layout = (
            tuple(sorted((n, str(t.dtype), tuple(t.shape)) for n, t in current.data.items())),
            tuple(current.valid.shape),
        )
        boost = 1
        while True:
            key = ("do_while_device", self._stage_key(body_stage, split_operands=False),
                   self._stage_key(cond_stage, split_operands=False), layout, max_iter, boost)
            self._note("do_while_device_start", stage.name, boost, stage=stage.id, boost=boost)
            prog = self._loops.get(key)
            first = None
            if prog is not None:
                self._loops.move_to_end(key)
            else:
                fns = [_loop_stage_fn(s, self.P, self.device, self.baked_operands,
                                      self.config.shuffle_slack, boost, with_miss=m,
                                      mesh=self.mesh)
                       for s, m in ((body_stage, True), (cond_stage, False))]
                eager = self.mesh is not None and self.mesh.world > 1
                prog = LoopProgram(*fns, cond_col, max_iter, self.device, eager=eager)
                try:
                    first = prog.check(current)  # TypeError: the driver loop runs it
                except HostReadError as e:
                    raise HostReadError(f"do_while {stage.name!r} (body {body_stage.name!r}, "
                                        f"condition {cond_stage.name!r}): {e}") from e
                self._loops[key] = prog
                while len(self._loops) > LOOP_PROGRAMS:
                    self._loops.popitem(last=False)[1].release()
            res = prog.run(current, first)
            if not res.overflow:
                if any(op.kind == "string_code" for s in (body_stage, cond_stage) for op in s.ops):
                    misses.append((stage.name, res.miss))
                self._note("do_while_device_done", stage.name, res.iters, stage=stage.id,
                           iters=res.iters)
                return res.batch
            self._note("stage_overflow", stage.name, boost, stage=stage.id, name=stage.name,
                       version=1, boost=boost)
            if boost >= 2 ** self.config.max_shuffle_retries:
                raise StageFailedError(f"device do_while still overflowing at boost {boost}")
            boost *= 2


    def _run_apply_host(self, stage: Stage, b: ColumnBatch) -> ColumnBatch:
        """Host-callback Apply: each partition's valid rows go to the
        host, ``fn(cols, partition_index)`` runs on numpy arrays, and
        the results, checked against the schema and cast, come back as a
        new batch (the reference's documented device->host->device round
        trip)."""
        self.event_log.emit("apply_host_start", stage=stage.id)
        p = stage.ops[0].params
        schema = p["schema"]
        phys = schema.device_names()
        expected = {n: _phys_np_dtype(n, schema) for n in phys}
        valid = b.valid.cpu().numpy()
        host = {n: to_host_column(v) for n, v in b.data.items()}
        base = self.mesh.base if self.mesh is not None else 0
        out_parts = []
        for j in range(valid.shape[0]):  # this rank's partitions
            i, m = base + j, valid[j]
            out = p["fn"]({n: v[j][m] for n, v in host.items()}, i)
            if set(out.keys()) != set(phys):
                raise ValueError(
                    f"apply_host fn output columns {sorted(out)} != "
                    f"schema physical columns {phys} (partition {i})"
                )
            out = {n: np.asarray(v, expected[n]) for n, v in out.items()}
            lens = {len(v) for v in out.values()} or {0}
            if len(lens) != 1:
                raise ValueError(
                    f"apply_host fn returned ragged columns: { {n: len(v) for n, v in out.items()} }"
                )
            out_parts.append(out)
        rows = [len(next(iter(op.values()), [])) for op in out_parts]
        most = PART.allreduce(torch.tensor(max(rows, default=1)), "max", self.mesh)
        new_cap = max(8, int(math.ceil(int(most) / 8.0)) * 8)  # one capacity on every rank
        data = {n: np.zeros((len(out_parts), new_cap), expected[n]) for n in phys}
        vbuf = np.zeros((len(out_parts), new_cap), np.bool_)
        for i, op in enumerate(out_parts):
            for n in phys:
                data[n][i, : rows[i]] = op[n]
            vbuf[i, : rows[i]] = True
        self.event_log.emit("apply_host_done", stage=stage.id)
        return ColumnBatch.from_host_layout(data, vbuf, self.device)

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
        self._unit_of = unit_of = {m.id: unit for unit in units for m in unit}
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
            if limit and solo is not None and self._single_axis() and _adaptable(solo):
                for ref, _idx in solo.input_refs:
                    if ref != "plan_input":
                        self._count_wanted.add(id(unit_of[ref]))

    def _consumers_allow_adapt(self, stage: Stage) -> bool:
        """Every consumer of this stage's outputs re-routes them through
        a leading exchange (no entry = no consumer)."""
        return all(
            self._adapt_safe.get((stage.id, i), True) for i in range(len(stage.out_slots))
        )

    def _adapt_fan_for(self, stage: Stage) -> Optional[int]:
        """Reduced width for this stage from its inputs' observed rows;
        None = run as lowered."""
        if not getattr(self.config, "tail_fanout_rows", 0) or not self._single_axis() \
                or not _adaptable(stage):
            return None
        if not self._consumers_allow_adapt(stage):
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


def _loop_stage_fn(stage: Stage, P: int, device, operands, slack: float, boost: int,
                   with_miss: bool, mesh=None):
    """One lowered stage as a function of the loop state: its ops at
    ``boost`` over ``operands`` (baked tables); returns the output batch
    and its overflow flag (and, for the body, its miss count), reduced
    over ``mesh``'s group.  It holds no reference to the executor, whose
    loops outlive no executor."""
    def fn(batch: ColumnBatch):
        ctx = StageContext(P, device, operands, slack, boost, mesh=mesh)
        ctx.bind_inputs((batch,))
        run_ops(ctx, stage.ops)
        out = ctx.slots[stage.out_slots[0]]
        return (out, ctx.overflow, ctx.dict_miss) if with_miss else (out, ctx.overflow)
    return STAGE.compile_stage(mesh, fn)


def _shape_key(inputs: List[ColumnBatch]) -> Tuple:
    """Each input's column names and capacity (the reference's
    ``_shape_key``; its capacity is the global one, ``P`` times ours).
    The column types join the program cache's slot, not the key
    (``exec/programs.py::types_of``)."""
    return tuple((tuple(sorted(b.data.keys())), b.capacity) for b in inputs)


def _unit_fn(unit: List[Stage], run: List[Stage], exports, objs, P: int, device, slack: float,
             boost: int, mesh, window: int, cell: List[dict]):
    """A unit as a function ``fn(inputs, tables) -> (exports, overflow,
    miss, counts)`` of its external inputs (in ``_unit_refs`` order) and
    its coding tables (in ``objs`` order): the members' ops at ``boost``
    and ``window``, the fan-adapted copies ``run`` in place of the
    members.  Each call refills ``cell`` with the exchanges' rounds.  It
    holds no reference to the executor."""
    members = {m.id for m in unit}
    ext = {ref: j for j, ref in enumerate(_unit_refs(unit))}

    def fn(inputs, tables):
        operands = PositionalOperands(objs, tables)
        local: Dict[Tuple[int, int], ColumnBatch] = {}
        overflow = miss = None
        cell.clear()
        for m, r in zip(unit, run):
            ctx = StageContext(P, device, operands, slack, boost, mesh=mesh, window=window)
            ctx.bind_inputs(tuple(
                local[(ref, idx)] if ref in members else inputs[ext[(ref, idx)]]
                for ref, idx in m.input_refs
            ))
            run_ops(ctx, r.ops)
            for i, slot in enumerate(m.out_slots):
                local[(m.id, i)] = ctx.slots[slot]
            overflow = ctx.overflow if overflow is None else overflow | ctx.overflow
            miss = ctx.dict_miss if miss is None else miss + ctx.dict_miss
            cell.extend(ctx.xchg_log)
        outs = [local[e] for e in exports]
        return outs, overflow, miss, [b.valid.sum() for b in outs]

    return fn


def _pool_probe(pool: Optional[DeviceOperandPool]) -> dict:
    """The flight recorder's ``operand_pool`` microsnapshot."""
    if pool is None:
        return {}
    return {"tiers": len(pool._tiers), "hits": pool.hits,
            "full_uploads": pool.full_uploads, "delta_scatters": pool.delta_scatters}


def _release_loops(loops: Dict[Tuple, LoopProgram]) -> None:
    for prog in loops.values():
        prog.release()
    loops.clear()


# the per-graph state (adaptation, checkpoint identities) a nested
# execute() saves and restores
_ADAPT_STATE = (
    "_observed_rows", "_count_wanted", "_adapt_safe", "_exports", "_unit_of", "_unit_id",
    "_out_fp", "_unit_fp", "_binding_fps", "_gated_ckpts",
)
