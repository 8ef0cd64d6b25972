"""Append-only job event log — the Calypso reporter analog (a copy of
``dryad_tpu/exec/events.py``).

The reference GM appends timestamped job events (process/vertex state
transitions, final topology) to ``calypso.log`` in the job's DFS
directory (``GraphManager/reporting/DrCalypsoReporting.cpp``), consumed
post-hoc by the JobBrowser.  Here: JSONL events per job, the same kinds
and fields as the JAX package's, so one reader folds either package's
logs.

Every event carries two clocks: ``ts`` (wall, ``time.time()`` — for
human-readable placement and cross-process merging) and ``mono``
(``time.monotonic()`` — for derived durations, immune to wall-clock
steps).  Field values are normalized to native Python types before
serialization.

The full event schema lives in :data:`EVENT_KINDS` below, copied whole
from the reference (kinds of modules the port has not ported yet
included, so the registry is one schema), plus the port's one kind of
its own, ``profile_trace`` (the torch.profiler session of
``config.profile_dir``).
``tests/test_torch_events_explain.py`` checks that every ``emit(...)``
kind in the port is registered.

Events may be emitted from pipeline threads; ``EventLog`` is
thread-safe.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

# ``kind`` -> one-line schema doc (the reference's registry, whole).
EVENT_KINDS: Dict[str, str] = {
    # -- job / stage lifecycle (exec.executor) ----------------------------
    "job_start": "job begins; stages=count, topology=[{id,name,deps}]",
    "job_complete": "job drained cleanly (after deferred miss checks)",
    "job_failed": "terminal job failure; stage/name/failure_kind/reason",
    "stage_start": "one stage attempt begins; stage/name/version/boost",
    "stage_complete": "attempt succeeded; seconds, async/deferred flags",
    "stage_failed": "attempt failed; error, failure_kind, backoff",
    "stage_overflow": "shuffle capacity overflow; retried at boost*2",
    "stage_straggler": "attempt duration beyond the outlier threshold",
    "stage_dispatched": "speculative dispatch joined the overflow window",
    "overflow_drain": "batched readback of the speculative window's flags",
    "stage_fanout": "stage lowered at reduced width; nparts/of",
    "fused_dispatch": "fused region dispatched as ONE program; members",
    "fuse_break": "plan fusion kept a driver seam; after/before/reason",
    "stage_width_adapt": "observed-volume width adaptation; nparts/of",
    "stage_delay_injected": "fault-injection delay before the attempt",
    "exchange_round": "one planned exchange round; round/window/bytes/"
                      "ici_bytes/dcn_bytes (window 0 = flat all_to_all)",
    "dict_miss": "rows outside the dense key domain; stage_name/rows",
    # -- checkpointing (exec.checkpoint / executor) -----------------------
    "stage_checkpoint_hit": "stage served from the checkpoint store",
    "stage_checkpoint_saved": "stage outputs persisted; path",
    "checkpoint_corrupt": "CRC mismatch at load; recomputed instead",
    "checkpoint_gc": "retention lease removed old checkpoints; removed",
    # -- do_while (exec.executor) -----------------------------------------
    "do_while_iter": "driver-loop iteration began; iter",
    "do_while_max_iter": "loop stopped at the iteration budget",
    "do_while_state_boost": "loop state outgrew capacity; boost",
    "do_while_device_start": "whole loop on the device as one graph; boost",
    "do_while_device_done": "device loop finished; iters",
    "do_while_device_fallback": "device lowering rejected; driver loop",
    # -- apply_host (exec.executor) ---------------------------------------
    "apply_host_start": "host-callback stage began; stage",
    "apply_host_done": "host-callback stage finished; stage",
    # -- out-of-core streaming (exec.outofcore / pipeline / spill) --------
    "stream_start": "a stream binding began evaluation; node",
    "stream_chunk": "one ingest chunk processed; rows, partial_rows/cap",
    "stream_spill": "one bucket piece spilled; bucket/rows/depth",
    "stream_bucket": "one bucket's device job finished; bucket/rows",
    "stream_bucket_split": "oversized bucket re-split; mode/fanout",
    "stream_store": "streamed results persisted; path/rows/partitions",
    "stream_prefetch": "one chunk prefetched; queued, in_flight sample",
    "stream_pipeline": "pipeline close summary; produced, stall seconds",
    "stream_pipeline_error": "prefetch/spill-thread fault; failure_kind",
    "stream_combine": "partial compaction; device/fan_in or rows_out, "
                      "plus level/ici_bytes/dcn_bytes collective split",
    "stream_combine_policy": "combine degrade/reprobe decision; mode",
    "stream_group_done": "streaming group_by finished; chunks/groups",
    "dispatch_gap": "device-idle gap between consecutive async chunk "
                    "dispatches; gap_s, in_flight at submit",
    "dispatch_window": "async dispatch window close summary; depth/"
                       "dispatches/retries/gap_s/driver_cpu_s",
    # -- combine tree (exec.combinetree / outofcore / localjob) -----------
    "combine_tree_level": "one tree merge; level/group/fan_in/cap_rows/"
                          "bytes/ici_bytes/dcn_bytes/device",
    "combine_tree_degrade": "key ranges degraded to host; degraded/"
                            "fraction/chunks",
    "stream_distinct_spill": "distinct switched to Grace spilling; rows",
    # -- observability (obs.span / obs.metrics / executor) ----------------
    "span": "closed hierarchical span; name/cat/span_id/parent_id/dur",
    "metrics": "counter/histogram registry snapshot; counters/hists",
    "xla_compile": "stage (re)compiled; stage/key/trace_s/compile_s",
    "telemetry_merged": "driver absorbed worker span/counter batches",
    # -- diagnosis / flight recorder (obs.diagnose / exec.events) ---------
    "resource_sample": "continuous telemetry sample; hbm/rss/probes",
    "profile_trace": "profiler trace of a top-level job written (path), "
                     "or skipped under another active profiler (port only)",
    "diagnosis": "online pathology detected; rule/severity/evidence/hint",
    "plan_rewrite": "runtime plan rewrite decided/applied; "
                    "action/rule/phase (rewrite.controller)",
    "events_dropped": "in-memory ring evicted events; dropped total",
    # -- cluster: scheduler / quarantine (cluster.scheduler) --------------
    "process_failed": "a scheduled process failed; computer/error",
    "process_stranded": "hard affinity unsatisfiable after removal",
    "process_dispatch": "queued process placed on a computer; wait_s",
    "computer_quarantined": "failure threshold crossed; cooldown",
    "computer_probation": "cooldown expired; probation re-admission",
    "computer_readmitted": "probation success; computer healthy again",
    # -- cluster: gang / vertex jobs (cluster.localjob) -------------------
    "worker_started": "worker process launched; worker",
    "worker_joined": "worker announced on the control plane; worker",
    "worker_dead": "worker process died; worker",
    "command_batch": "batched worker command stream posted; worker/"
                     "commands/round_trips_saved",
    "gang_window": "overlapped gang command window close summary; "
                   "depth/dispatches/peak_in_flight/retries",
    "gang_partial_combine": "worker-side level -1 partial pre-merge; "
                            "worker/parts/rows/read_bytes/cache hits",
    "gang_run_start": "gang SPMD submission began; seq/workers",
    "gang_run_complete": "gang SPMD submission finished; seconds",
    "gang_straggler": "gang run duration beyond the outlier threshold",
    "gang_rebuild": "gang reshaped/restarted; dead/workers/generation",
    "gang_member_lost_mid_job": "mid-job death; auto-shrink attempt",
    "vertex_job_start": "independent vertex-task job began; nparts",
    "vertex_job_complete": "vertex-task job finished; seq",
    "vertex_job_failed": "a vertex task exhausted retries; part",
    "vertex_complete": "one vertex task finished; part/seconds/computer",
    "vertex_retry": "vertex task re-executed; attempt/backoff/error",
    "vertex_duplicate": "straggling task speculatively duplicated",
    "vertex_duplicate_win": "the duplicate finished first; winner",
    "vertex_duplicate_cancel": "the losing attempt was canceled; loser",
    "vertex_routed": "driver routed inputs for a shuffle-bearing plan",
    "vertex_partials_merged": "driver merged per-vertex partials; rows",
    "assemble_fetch": "result partitions fetched; wire/raw bytes",
    # -- coded stage redundancy (cluster.localjob / redundancy) -----------
    "coded_job_start": "coded k-of-n stage began; seq/k/n/r/kind",
    "coded_launch": "parity spares launched; trigger/threshold/spares",
    "coded_task_complete": "one coded vertex done; coded/parity/seconds",
    "coded_task_failed": "one coded vertex failed; coded/error",
    "coded_retry": "coded vertex relaunched (coverage shortfall); coded",
    "coded_cancel": "unneeded coded vertices canceled at k completions",
    "coded_reconstruct": "output reconstructed; used/parity_used/exact",
    "coded_waste_bytes": "completed-but-unused coded output bytes",
    "coded_job_complete": "coded stage finished; seq/seconds",
    "coded_fallback": "stage ineligible for coding; reason",
    # -- gang chaos (exec.faults via cluster.worker set_fault) ------------
    "worker_killed_injected": "seeded chaos kill: process exits mid-stage",
    # -- multihost shared quarantine (obs.gang / cluster.scheduler) -------
    "quarantine_delta": "local failure deltas shipped to peer drivers",
    "quarantine_absorbed": "peer failure delta folded into local blacklist",
    # -- serving tier (serve.service) -------------------------------------
    "query_admitted": "tenant query passed admission; tenant/query/cost",
    "query_rejected": "admission refused past quota; tenant/reason/limit",
    "query_complete": "tenant query resolved; tenant/query/seconds/ok",
    "result_cache_hit": "repeat query served from the result cache",
    "tenant_quota": "tenant quota state transition; saturated or ok",
    # -- materialized views (views.matview / serve.service) ---------------
    "view_register": "plan admitted as a resident view; tenant/view/rows",
    "view_delta": "append folded into a view's partial state; rows/bytes",
    "view_snapshot": "view served a read; fresh (0 dispatches) or "
                     "finalized (1 dispatch); staleness_s",
    "view_fallback": "view registration refused; structured reason "
                     "(mirrors coded_fallback)",
    # -- serving fleet (serve.fleet router / supervisor) ------------------
    "replica_started": "engine replica joined the fleet; replica/mode",
    "replica_dead": "heartbeat went stale; replica reaped, gen bumped",
    "fleet_submit": "front door admitted + routed a query to a replica",
    "fleet_result": "front door delivered a replica's result; seconds",
    "fleet_reroute": "in-flight query replayed to the failover replica",
    "fleet_rejected": "front-door fast reject (negative quota memo)",
}

# ``kind`` -> (required payload keys, optional payload keys), the
# reference's table: every literal emit() call site of the port stays
# inside required+optional and carries every required key
# (``tests/test_torch_events_explain.py``).
EVENT_PAYLOADS: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    "job_start": (("stages", "topology"), ()),
    "job_complete": ((), ()),
    "job_failed": (("failure_kind", "reason"), ("name", "stage")),
    "stage_start": (("boost", "name", "stage", "version"), ()),
    "stage_complete": (
        ("name", "seconds", "stage", "version"),
        ("async", "deferred"),
    ),
    "stage_failed": (
        ("backoff", "error", "failure_kind", "failures", "name", "stage",
         "version"),
        (),
    ),
    "stage_overflow": (("boost", "name", "stage", "version"), ()),
    "stage_straggler": (
        ("name", "seconds", "stage", "threshold", "version"), (),
    ),
    "stage_dispatched": (
        ("boost", "inflight", "name", "stage", "version"), (),
    ),
    "overflow_drain": (("inflight", "stages"), ()),
    "stage_fanout": (("name", "nparts", "of", "stage"), ()),
    "fused_dispatch": (("boost", "members", "name", "stage", "version"), ()),
    "fuse_break": (("after", "before", "reason"), ()),
    "stage_width_adapt": (
        ("name", "nparts", "observed_rows", "of", "stage"), (),
    ),
    "stage_delay_injected": (("name", "seconds", "stage"), ()),
    "exchange_round": (
        ("bytes", "dcn_bytes", "ici_bytes", "round", "window"),
        ("name", "qid", "stage"),
    ),
    "dict_miss": (("rows", "stage_name"), ()),
    "stage_checkpoint_hit": (("name", "stage"), ()),
    "stage_checkpoint_saved": (("name", "path", "stage"), ()),
    "checkpoint_corrupt": (("error", "name", "path", "stage"), ()),
    "checkpoint_gc": (("removed",), ()),
    "do_while_iter": (("iter", "stage"), ()),
    "do_while_max_iter": (("iters", "stage"), ()),
    "do_while_state_boost": (("boost", "stage"), ()),
    "do_while_device_start": (("boost", "stage"), ()),
    "do_while_device_done": (("iters", "stage"), ()),
    "do_while_device_fallback": (("reason", "stage"), ()),
    "apply_host_start": (("stage",), ()),
    "apply_host_done": (("stage",), ()),
    "stream_start": (("node",), ()),
    "stream_chunk": (("rows",), ("partial_cap", "partial_rows")),
    "stream_spill": (("bucket", "depth", "rows"), ()),
    "stream_bucket": (("bucket", "depth", "rows"), ()),
    "stream_bucket_split": (
        ("bucket", "depth", "mode", "rows"), ("fanout",),
    ),
    "stream_store": (("partitions", "path", "rows"), ()),
    "stream_prefetch": (("in_flight", "pipeline", "queued"), ()),
    "stream_pipeline": (("depth", "pipeline"), ()),
    "stream_pipeline_error": (
        ("error", "failure_kind", "phase", "pipeline"), (),
    ),
    "stream_combine": (
        ("dcn_bytes", "ici_bytes", "level"),
        ("cap_rows", "device", "fan_in", "rows_out"),
    ),
    "stream_combine_policy": (
        ("chunks", "mode"), ("pinned", "reprobe", "static"),
    ),
    "stream_group_done": (("chunks", "groups"), ()),
    "dispatch_gap": (("gap_s",), ("in_flight", "pipeline", "qid")),
    "dispatch_window": (
        ("depth", "dispatches", "gap_s", "retries"),
        ("driver_cpu_s", "pipeline", "wall_s"),
    ),
    "combine_tree_level": (
        ("bytes", "cap_rows", "dcn_bytes", "device", "fan_in",
         "ici_bytes", "level"),
        ("group",),
    ),
    "combine_tree_degrade": (("chunks", "degraded", "fraction"), ()),
    "stream_distinct_spill": (("rows",), ()),
    "span": (
        ("cat", "dur", "name", "parent_id", "span_id", "thread"),
        ("qid",),
    ),
    "metrics": ((), ("counters", "hists")),
    "xla_compile": (("compile_s", "key", "stage", "trace_s"), ("qid",)),
    "telemetry_merged": (("events", "offsets"), ()),
    "process_failed": (("computer", "error", "process"), ()),
    "process_stranded": (("computer", "process"), ()),
    "process_dispatch": (("computer", "process", "wait_s"), ()),
    "computer_quarantined": (
        ("computer", "cooldown", "failures", "probation"), (),
    ),
    "computer_probation": (("computer",), ()),
    "computer_readmitted": (("computer",), ()),
    "worker_started": (("worker",), ()),
    "worker_joined": (("worker",), ()),
    "worker_dead": (("worker",), ()),
    "command_batch": (
        ("commands", "round_trips_saved", "worker"),
        ("clamped_from", "seqs"),
    ),
    "gang_window": (
        ("depth", "dispatches", "peak_in_flight", "pipeline",
         "retries", "wall_s"),
        ("qid", "workers"),
    ),
    "gang_partial_combine": (
        ("cache_hits", "cache_misses", "parts", "read_bytes", "rows",
         "worker"),
        ("bytes", "in_rows", "seconds"),
    ),
    "gang_run_start": (("seq", "workers"), ()),
    "gang_run_complete": (("seconds", "seq"), ()),
    "gang_straggler": (("seconds", "seq", "threshold"), ()),
    "gang_rebuild": (("dead", "generation", "workers"), ()),
    "gang_member_lost_mid_job": (("attempt", "dead"), ()),
    "vertex_job_start": (("nparts", "seq", "speculation"), ()),
    "vertex_job_complete": (("seq",), ()),
    "vertex_job_failed": (("failure_kind", "part"), ()),
    "vertex_complete": (("computer", "part", "seconds"), ()),
    "vertex_retry": (
        ("attempt", "backoff", "computer", "error", "failure_kind",
         "part"),
        (),
    ),
    "vertex_duplicate": (("elapsed", "part", "threshold"), ()),
    "vertex_duplicate_win": (("part", "seconds", "winner"), ()),
    "vertex_duplicate_cancel": (("loser", "part"), ()),
    "vertex_routed": (("inputs", "nparts", "plan_kind"), ()),
    "vertex_partials_merged": (("rows", "seq"), ()),
    "assemble_fetch": (("parts", "raw_bytes", "wire_bytes"), ()),
    "coded_job_start": (("agg", "k", "n", "r", "seq"), ()),
    "coded_launch": (
        ("k", "n", "r", "seq", "threshold", "trigger"), (),
    ),
    "coded_task_complete": (
        ("coded", "computer", "parity", "seconds", "seq"), (),
    ),
    "coded_task_failed": (
        ("coded", "error", "failure_kind", "parity", "seq"), (),
    ),
    "coded_retry": (("attempt", "coded", "seq"), ()),
    "coded_cancel": (("canceled", "seq"), ()),
    "coded_reconstruct": (
        ("amplification", "exact", "parity_used", "seconds", "seq",
         "used"),
        (),
    ),
    "coded_waste_bytes": (("bytes", "seq", "unused"), ()),
    "coded_job_complete": (("seconds", "seq"), ()),
    "coded_fallback": (("reason",), ()),
    "worker_killed_injected": (("name", "stage"), ()),
    "quarantine_delta": (("computer", "count", "src"), ()),
    "quarantine_absorbed": (("deltas", "source"), ()),
    "profile_trace": (("path",), ("skipped",)),
    "resource_sample": (
        ("source",),
        ("hbm_headroom_bytes", "hbm_limit_bytes", "hbm_used_bytes",
         "probes", "rss_kb"),
    ),
    "diagnosis": (
        ("evidence", "hint", "rule", "severity"),
        ("name", "qid", "stage"),
    ),
    "plan_rewrite": (
        ("action", "phase", "rule"),
        ("boost", "bucket", "depth", "fan", "mode", "ratio", "rows",
         "stage", "subject", "tree", "window"),
    ),
    "events_dropped": (("dropped",), ()),
    "query_admitted": (("cost_bytes", "query", "tenant"), ("queued",)),
    "query_rejected": (
        ("current", "limit", "query", "reason", "tenant"), (),
    ),
    "query_complete": (
        ("ok", "query", "seconds", "tenant"), ("cached", "error"),
    ),
    "result_cache_hit": (("query", "tenant"), ("rows",)),
    "tenant_quota": (
        ("inflight", "limit", "state", "tenant"), ("bytes",),
    ),
    "view_register": (
        ("tenant", "view"), ("rows", "state_rows", "windows"),
    ),
    "view_delta": (
        ("rows", "tenant", "view"), ("bytes", "state_rows", "windows"),
    ),
    "view_snapshot": (
        ("fresh", "tenant", "view"), ("qid", "rows", "staleness_s"),
    ),
    "view_fallback": (("reason", "tenant"), ()),
    "replica_started": (("mode", "replica"), ("pid",)),
    "replica_dead": (
        ("generation", "replica"), ("inflight", "stale_s"),
    ),
    "fleet_submit": (
        ("query", "replica", "tenant", "tier"), ("fingerprint",),
    ),
    "fleet_result": (
        ("ok", "query", "seconds", "tenant"), ("cached", "replica"),
    ),
    "fleet_reroute": (
        ("from_replica", "query", "tenant", "to_replica"), (),
    ),
    "fleet_rejected": (
        ("reason", "tenant"), ("current", "limit", "query"),
    ),
}


# Event kinds scoped to one query: their emit sites stamp the active
# trace context's query id as an explicit ``qid=`` keyword
# (``obs.tracectx.current_qid()``; None outside any query scope).
QUERY_SCOPED_KINDS: Tuple[str, ...] = (
    "diagnosis",
    "dispatch_gap",
    "exchange_round",
    "gang_window",
    "span",
    "view_snapshot",
)


# Documented kinds whose emitting part is not ported yet, each with the
# ROADMAP.md item that brings it.  graftlint's ``event-schema`` rule
# lets these kinds go without an emit site and reports one that gains a
# site, so this list only shrinks; it is empty since ``xla_compile``
# gained its emitter (``exec/programs.py``).
PENDING_KINDS: Dict[str, str] = {}


def _to_native(v: Any) -> Any:
    """Normalize numpy scalars/arrays (and containers of them) to
    native Python types so JSON round-trips preserve numbers — the
    old ``default=str`` fallback silently stringified them, corrupting
    jobview's numeric folds."""
    # numpy scalars expose .item(); arrays expose .tolist(); test by
    # attribute to avoid importing numpy on the hot path
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _to_native(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_to_native(x) for x in v]
    item = getattr(v, "item", None)
    if item is not None and getattr(v, "shape", None) == ():
        return v.item()  # numpy scalar (0-d)
    tolist = getattr(v, "tolist", None)
    if tolist is not None:
        return v.tolist()  # numpy array
    return v


class EventLog:
    """Thread-safe append-only JSONL event sink.

    ``mem_cap`` bounds the in-memory mirror with a ring buffer (long
    out-of-core jobs emit per-chunk events without bound); the file
    sink, when configured, always keeps the full stream.  ``None``
    keeps the unbounded list (test-friendly default).

    Ring evictions are COUNTED (``dropped``) and announced in-stream
    with ``events_dropped`` markers on a doubling schedule, so the
    diagnosis engine and blackbox merges see "the stream is truncated
    here" instead of misreading a gap as idleness.

    ``add_tap(fn)`` registers a live observer called with every
    appended event OUTSIDE the log lock — the feed for the online
    diagnosis engine and the flight recorder.  Taps must be fast and
    must never raise (exceptions are swallowed; observability cannot
    fail the job).
    """

    def __init__(self, path: Optional[str] = None,
                 mem_cap: Optional[int] = None):
        self.path = path
        self.mem_cap = mem_cap
        self._lock = threading.Lock()
        self._mem = (
            deque(maxlen=mem_cap) if mem_cap else []
        )  # type: ignore[var-annotated]
        self.dropped = 0  # total ring evictions since construction
        self._next_drop_marker = 1  # doubling threshold for the marker
        self._taps: List[Any] = []
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        else:
            self._fh = None

    def add_tap(self, fn) -> None:
        """Register a live per-event observer (called outside the
        lock, after the event is appended)."""
        self._taps.append(fn)

    def remove_tap(self, fn) -> None:
        try:
            self._taps.remove(fn)
        except ValueError:
            pass

    def emit(self, kind: str, **fields: Any) -> None:
        ev = {
            "ts": time.time(), "mono": time.monotonic(), "kind": kind,
            **{k: _to_native(v) for k, v in fields.items()},
        }
        self._append(ev)

    def absorb(self, ev: Dict[str, Any]) -> None:
        """Append a pre-stamped event AS-IS (no re-stamping) — the
        driver-side merge path for worker telemetry batches whose
        clocks were already offset-corrected (``obs.gang``)."""
        self._append({k: _to_native(v) for k, v in ev.items()})

    def _append(self, ev: Dict[str, Any]) -> None:
        marker = False
        with self._lock:
            if (
                self.mem_cap
                and len(self._mem) == self.mem_cap
            ):
                self.dropped += 1
                if self.dropped >= self._next_drop_marker:
                    # next marker at 2x: O(log drops) markers total, so
                    # the announcement cannot itself flood the ring
                    self._next_drop_marker = max(
                        self._next_drop_marker * 2, self.dropped * 2
                    )
                    marker = True
            self._mem.append(ev)
            if self._fh:
                self._fh.write(json.dumps(ev, default=str) + "\n")
        for tap in self._taps:
            try:
                tap(ev)
            except Exception:
                pass  # observability must never fail the job
        if marker:
            self.emit("events_dropped", dropped=self.dropped)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._mem)

    def filter(self, *kinds: str) -> List[Dict[str, Any]]:
        """Snapshot of events whose ``kind`` is one of ``kinds`` —
        the recovery/chaos suites assert on specific transitions
        (quarantine, retry, corruption) without refolding the stream."""
        with self._lock:
            return [e for e in self._mem if e["kind"] in kinds]

    def drain(self) -> List[Dict[str, Any]]:
        """Atomically snapshot AND clear the in-memory mirror — the
        worker-side telemetry shipping primitive (the file sink, if
        any, is unaffected)."""
        with self._lock:
            out = list(self._mem)
            self._mem.clear()
            return out

    def close(self) -> None:
        with self._lock:
            if self._fh:
                self._fh.close()
                self._fh = None

    @staticmethod
    def load(path: str) -> List[Dict[str, Any]]:
        out = []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out
