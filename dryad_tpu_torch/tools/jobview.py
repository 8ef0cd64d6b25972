"""Job viewer — the JobBrowser / JOM analog (a copy of
``dryad_tpu/tools/jobview.py``; it reads either package's logs).

The reference ships a WinForms GUI that reconstructs a job (stages,
vertices, per-vertex timings, failures) from the GraphManager's Calypso
event log and runs a failure **Diagnosis** pass
(``JobBrowser/JOM/jobinfo.cs:62``, ``JobBrowser/JobBrowser/Diagnosis.cs``).
Here the event source is the executor's JSONL event log
(``dryad_tpu_torch.exec.events``); this module rebuilds the job model,
renders a text report (with the obs time-attribution summary: compile
vs execute vs ingest-stall vs spill), diagnoses common failure shapes,
and exports the stream as a Chrome/Perfetto trace.

CLI: ``python -m dryad_tpu_torch.tools.jobview [--html out.html]
[--trace out.json] [--follow] <events.jsonl>``

- ``--trace out.json`` writes a Chrome-trace (Perfetto) JSON of the
  stream: span slices on per-thread tracks (prefetch / compute /
  spill), pipeline-occupancy counters, instant markers for state
  transitions, one process per worker for merged gang telemetry
  (``dryad_tpu_torch.obs.trace``).  Load it at ``ui.perfetto.dev``.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Dict, List, Optional, Tuple

from dryad_tpu_torch.exec.events import EventLog


@dataclasses.dataclass
class StageInfo:
    """Runtime record of one stage (the JOM DryadLinqJobStage analog)."""

    id: int
    name: str
    versions: int = 0
    completed: bool = False
    from_checkpoint: bool = False
    failures: int = 0
    overflows: int = 0
    stragglers: int = 0
    seconds: float = 0.0
    last_error: Optional[str] = None
    max_boost: int = 1
    # async dispatch (overflow-free stage): seconds is DISPATCH time;
    # device time overlapped downstream stages
    async_dispatch: bool = False
    # whole-DAG fusion (plan.fuse): >0 when this "stage" is a fused
    # region covering that many member stages in ONE dispatch
    fused_members: int = 0
    # per-attempt failure records ({version, kind, backoff, error})
    # folded from stage_failed events — the DrVertexRecord version
    # history, post-mortem
    attempt_log: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list
    )
    checkpoint_corrupt: int = 0


@dataclasses.dataclass
class JobInfo:
    stages: Dict[int, StageInfo]
    n_stages_declared: int
    started: bool
    completed: bool
    failed: bool
    do_while_iters: int
    do_while_state_boost: int  # max loop-state capacity boost reached
    wall_seconds: float
    # stage DAG from the job_start event ([{id, name, deps}]) — lets
    # the report redraw the graph post-hoc, the way the reference
    # JobBrowser rebuilds it from GM logs (JOM/jobinfo.cs:62)
    topology: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    # out-of-core streaming progress (exec.outofcore stream_* events):
    # {chunks, chunk_rows, spills, spill_rows, buckets, splits,
    #  combines} — zero when the job never streamed
    stream: Dict[str, int] = dataclasses.field(default_factory=dict)
    # exchange planner rounds (exchange_round events) grouped by stage
    # name: {rounds, window, peak, ici, dcn} — empty when the job never
    # repartitioned
    exchanges: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict
    )

    @property
    def ok(self) -> bool:
        return self.completed and not self.failed


def split_jobs(events: List[Dict[str, Any]]) -> List[List[Dict[str, Any]]]:
    """Split a per-context event stream into per-job segments.

    One context appends every submission to the same log, so a log may
    hold several job_start..job_complete spans; events before the first
    job_start (if any) join the first segment."""
    segments: List[List[Dict[str, Any]]] = []
    cur: List[Dict[str, Any]] = []
    seen_start = False
    for ev in events:
        if ev["kind"] == "job_start" and seen_start:
            segments.append(cur)
            cur = []
        if ev["kind"] == "job_start":
            seen_start = True
        cur.append(ev)
    if cur:
        segments.append(cur)
    return segments


def build_jobs(events: List[Dict[str, Any]]) -> List["JobInfo"]:
    return [_fold_job(seg) for seg in split_jobs(events)]


def build_job(events: List[Dict[str, Any]]) -> JobInfo:
    """Job model of the MOST RECENT job in the stream."""
    segs = split_jobs(events)
    return _fold_job(segs[-1] if segs else [])


def _fold_job(events: List[Dict[str, Any]]) -> JobInfo:
    """Fold one job's event segment into a job model."""
    stages: Dict[int, StageInfo] = {}
    declared = 0
    started = completed = failed = False
    iters = 0
    state_boost = 0
    topology: List[Dict[str, Any]] = []
    stream_stats: Dict[str, int] = {}
    exchanges: Dict[str, Dict[str, int]] = {}
    t0 = t1 = None

    def stage(ev) -> StageInfo:
        sid = ev["stage"]
        if sid not in stages:
            stages[sid] = StageInfo(sid, ev.get("name", f"stage{sid}"))
        return stages[sid]

    for ev in events:
        kind = ev["kind"]
        ts = ev.get("ts")
        if ts is not None:
            t0 = ts if t0 is None else t0
            t1 = ts
        if kind == "job_start":
            started = True
            declared = ev.get("stages", 0)
            topology = ev.get("topology", topology)
        elif kind == "job_complete":
            completed = True
        elif kind == "job_failed":
            failed = True
        elif kind == "stage_start":
            s = stage(ev)
            s.versions = max(s.versions, ev.get("version", s.versions + 1))
            s.max_boost = max(s.max_boost, ev.get("boost", 1))
        elif kind == "stage_complete":
            s = stage(ev)
            s.completed = True
            s.seconds += ev.get("seconds", 0.0)
            s.async_dispatch = bool(ev.get("async", s.async_dispatch))
        elif kind == "fused_dispatch":
            s = stage(ev)
            s.fused_members = max(s.fused_members, ev.get("members", 0))
        elif kind == "stage_checkpoint_hit":
            s = stage(ev)
            s.completed = True
            s.from_checkpoint = True
        elif kind == "stage_failed":
            s = stage(ev)
            s.failures += 1
            s.last_error = ev.get("error")
            s.attempt_log.append({
                "version": ev.get("version", s.versions),
                "kind": ev.get("failure_kind", "transient"),
                "backoff": ev.get("backoff", 0.0),
                "error": ev.get("error", ""),
            })
        elif kind == "checkpoint_corrupt":
            stage(ev).checkpoint_corrupt += 1
        elif kind == "stage_overflow":
            stage(ev).overflows += 1
        elif kind == "stage_straggler":
            stage(ev).stragglers += 1
        elif kind in ("do_while_iter",):
            iters = max(iters, ev.get("iter", 0))
        elif kind == "do_while_state_boost":
            state_boost = max(state_boost, ev.get("boost", 0))
        elif kind == "combine_tree_level":
            # per-level combine panel: merges / input bytes / estimated
            # ICI vs DCN collective traffic at each tree level
            lv = int(ev.get("level", 0))
            tl = stream_stats.setdefault("tree_levels", {})
            ent = tl.setdefault(
                lv, {"merges": 0, "bytes": 0, "ici": 0, "dcn": 0}
            )
            ent["merges"] += 1
            ent["bytes"] += int(ev.get("bytes", 0) or 0)
            ent["ici"] += int(ev.get("ici_bytes", 0) or 0)
            ent["dcn"] += int(ev.get("dcn_bytes", 0) or 0)
        elif kind == "exchange_round":
            # per-exchange panel: rounds grouped by the stage that ran
            # them, with the window, per-round peak footprint, and the
            # ICI/DCN collective split
            key = ev.get("name", f"stage{ev.get('stage', '?')}")
            ent = exchanges.setdefault(
                key,
                {"rounds": 0, "window": 0, "peak": 0, "ici": 0, "dcn": 0},
            )
            ent["rounds"] += 1
            ent["window"] = max(ent["window"], int(ev.get("window", 0)))
            ent["peak"] = max(ent["peak"], int(ev.get("bytes", 0) or 0))
            ent["ici"] += int(ev.get("ici_bytes", 0) or 0)
            ent["dcn"] += int(ev.get("dcn_bytes", 0) or 0)
        elif kind == "combine_tree_degrade":
            stream_stats["degraded_fraction"] = max(
                stream_stats.get("degraded_fraction", 0.0),
                float(ev.get("fraction", 0.0) or 0.0),
            )
        elif kind == "dispatch_gap":
            # async-dispatch occupancy sample: the window went idle
            # (device starved) before this submit
            stream_stats["dispatch_gaps"] = (
                stream_stats.get("dispatch_gaps", 0) + 1
            )
        elif kind == "dispatch_window":
            # close-time window summary: cumulative device-idle gap,
            # drain retries, and the driver thread's CPU over the
            # window's wall time (the off-the-hot-path signal)
            stream_stats["dispatch_windows"] = (
                stream_stats.get("dispatch_windows", 0) + 1
            )
            stream_stats["dispatch_depth"] = max(
                stream_stats.get("dispatch_depth", 0), ev.get("depth", 0)
            )
            stream_stats["dispatches"] = (
                stream_stats.get("dispatches", 0)
                + ev.get("dispatches", 0)
            )
            stream_stats["dispatch_retries"] = (
                stream_stats.get("dispatch_retries", 0)
                + ev.get("retries", 0)
            )
            stream_stats["dispatch_gap_s"] = round(
                stream_stats.get("dispatch_gap_s", 0.0)
                + ev.get("gap_s", 0.0), 4,
            )
            stream_stats["_disp_cpu_s"] = (
                stream_stats.get("_disp_cpu_s", 0.0)
                + ev.get("driver_cpu_s", 0.0)
            )
            stream_stats["_disp_wall_s"] = (
                stream_stats.get("_disp_wall_s", 0.0)
                + ev.get("wall_s", 0.0)
            )
        elif kind == "gang_partial_combine":
            # worker-side level -1 pre-merge: parts folded per winner
            # worker before shipping, job-root bytes the partition
            # cache did NOT have to re-read, and the cache hit split
            stream_stats["gang_premerges"] = (
                stream_stats.get("gang_premerges", 0) + 1
            )
            stream_stats["gang_premerge_parts"] = (
                stream_stats.get("gang_premerge_parts", 0)
                + ev.get("parts", 0)
            )
            stream_stats["gang_premerge_rows"] = (
                stream_stats.get("gang_premerge_rows", 0)
                + ev.get("rows", 0)
            )
            stream_stats["gang_root_read_bytes"] = (
                stream_stats.get("gang_root_read_bytes", 0)
                + ev.get("read_bytes", 0)
            )
            stream_stats["gang_cache_hits"] = (
                stream_stats.get("gang_cache_hits", 0)
                + ev.get("cache_hits", 0)
            )
            stream_stats["gang_cache_misses"] = (
                stream_stats.get("gang_cache_misses", 0)
                + ev.get("cache_misses", 0)
            )
        elif kind == "gang_window":
            # overlapped gang command stream close summary:
            # peak_in_flight >= 2 means the feed genuinely kept more
            # than one runbatch envelope outstanding per worker
            stream_stats["gang_windows"] = (
                stream_stats.get("gang_windows", 0) + 1
            )
            stream_stats["gang_depth"] = max(
                stream_stats.get("gang_depth", 0), ev.get("depth", 0)
            )
            stream_stats["gang_dispatches"] = (
                stream_stats.get("gang_dispatches", 0)
                + ev.get("dispatches", 0)
            )
            stream_stats["gang_peak_in_flight"] = max(
                stream_stats.get("gang_peak_in_flight", 0),
                ev.get("peak_in_flight", 0),
            )
            stream_stats["gang_retries"] = (
                stream_stats.get("gang_retries", 0)
                + ev.get("retries", 0)
            )
        elif kind.startswith("stream_"):
            if kind == "stream_chunk":
                stream_stats["chunks"] = stream_stats.get("chunks", 0) + 1
                stream_stats["chunk_rows"] = (
                    stream_stats.get("chunk_rows", 0) + ev.get("rows", 0)
                )
            elif kind == "stream_spill":
                stream_stats["spills"] = stream_stats.get("spills", 0) + 1
                stream_stats["spill_rows"] = (
                    stream_stats.get("spill_rows", 0) + ev.get("rows", 0)
                )
            elif kind == "stream_bucket":
                stream_stats["buckets"] = stream_stats.get("buckets", 0) + 1
            elif kind == "stream_bucket_split":
                stream_stats["splits"] = stream_stats.get("splits", 0) + 1
            elif kind == "stream_combine":
                stream_stats["combines"] = (
                    stream_stats.get("combines", 0) + 1
                )
                if ev.get("device"):
                    stream_stats["device_combines"] = (
                        stream_stats.get("device_combines", 0) + 1
                    )
            elif kind == "stream_prefetch":
                # per-chunk pipeline occupancy sample (in-flight count)
                stream_stats["prefetched"] = (
                    stream_stats.get("prefetched", 0) + 1
                )
                stream_stats["_occ_sum"] = (
                    stream_stats.get("_occ_sum", 0)
                    + ev.get("in_flight", 0)
                )
            elif kind == "stream_pipeline":
                # per-pipeline summary: fold the stall breakdown
                stream_stats["pipelines"] = (
                    stream_stats.get("pipelines", 0) + 1
                )
                stream_stats["pipeline_depth"] = max(
                    stream_stats.get("pipeline_depth", 0),
                    ev.get("depth", 0),
                )
                stream_stats["peak_in_flight"] = max(
                    stream_stats.get("peak_in_flight", 0),
                    ev.get("peak_in_flight", 0),
                )
                stream_stats["ingest_stall_s"] = round(
                    stream_stats.get("ingest_stall_s", 0.0)
                    + ev.get("consumer_wait_s", 0.0), 4,
                )
                stream_stats["compute_stall_s"] = round(
                    stream_stats.get("compute_stall_s", 0.0)
                    + ev.get("producer_wait_s", 0.0), 4,
                )
            elif kind == "stream_pipeline_error":
                stream_stats["pipeline_errors"] = (
                    stream_stats.get("pipeline_errors", 0) + 1
                )
            elif kind == "stream_combine_policy":
                stream_stats["combine_policy"] = ev.get("mode", "?")
    wall = (t1 - t0) if (t0 is not None and t1 is not None) else 0.0
    return JobInfo(
        stages, declared, started, completed, failed, iters, state_boost,
        wall, topology, stream_stats, exchanges,
    )


def diagnose(job: JobInfo) -> List[str]:
    """Failure/performance diagnosis (Diagnosis.cs analog): name the
    likely cause and the knob to turn."""
    out: List[str] = []
    if not job.started:
        out.append("no job_start event — log is empty or truncated")
        return out
    for s in sorted(job.stages.values(), key=lambda s: s.id):
        if not s.completed and job.failed:
            if s.failures:
                why = f": {s.last_error}" if s.last_error else ""
                det = (
                    s.attempt_log
                    and s.attempt_log[-1]["kind"] == "deterministic"
                )
                cause = (
                    "deterministic failure (identical error reproduced; "
                    "retrying elsewhere cannot help)"
                    if det
                    else "exceeded the failure budget "
                    "(config.max_stage_failures)"
                )
                out.append(
                    f"stage {s.id} ({s.name}) FAILED after {s.failures} "
                    f"attempt(s){why} — {cause}"
                )
            elif s.overflows:
                out.append(
                    f"stage {s.id} ({s.name}) FAILED: shuffle capacity "
                    f"exhausted after {s.overflows} overflow retries "
                    f"(boost reached {s.max_boost}x) — severe skew or "
                    f"under-provisioned capacity; raise "
                    f"config.shuffle_slack / max_shuffle_retries or "
                    f"repartition on a better key"
                )
            else:
                out.append(
                    f"stage {s.id} ({s.name}) did not complete before the "
                    f"job failed"
                )
        failed_by_overflow = (
            not s.completed and job.failed and not s.failures and s.overflows
        )
        if s.overflows and not failed_by_overflow:
            out.append(
                f"stage {s.id} ({s.name}) overflowed {s.overflows}x "
                f"(final capacity boost {s.max_boost}x) — shuffle skew or "
                f"under-provisioned capacity; raise config.shuffle_slack "
                f"or pre-partition on a better key"
            )
        if s.stragglers:
            out.append(
                f"stage {s.id} ({s.name}) flagged as straggler "
                f"{s.stragglers}x — duration beyond the Gaussian outlier "
                f"threshold; candidate for speculative duplication"
            )
        if s.failures and s.completed:
            out.append(
                f"stage {s.id} ({s.name}) recovered after {s.failures} "
                f"failure(s) via versioned re-execution"
            )
        if s.checkpoint_corrupt:
            out.append(
                f"stage {s.id} ({s.name}) hit {s.checkpoint_corrupt} "
                f"corrupt checkpoint(s) — CRC mismatch detected at load; "
                f"recomputed instead of serving corrupt data (check the "
                f"checkpoint volume for bit rot)"
            )
    n_ckpt = sum(1 for s in job.stages.values() if s.from_checkpoint)
    if n_ckpt:
        out.append(
            f"{n_ckpt} stage(s) served from checkpoint (resumed run)"
        )
    if job.do_while_state_boost >= 2:
        out.append(
            f"do_while loop state outgrew its capacity (boost reached "
            f"{job.do_while_state_boost}x) — the iteration accumulates "
            f"rows; expected for growing workloads, but repeated boosts "
            f"recompile the loop stages"
        )
    if job.completed and not job.failed and not out:
        out.append("job completed cleanly; no anomalies")
    return out


def render(job: JobInfo) -> str:
    """Text report: per-stage table + status + diagnosis."""
    lines = []
    status = "FAILED" if job.failed else ("OK" if job.completed else "INCOMPLETE")
    lines.append(
        f"job: {status}  stages={len(job.stages)}/{job.n_stages_declared or '?'}"
        f"  wall={job.wall_seconds:.3f}s"
        + (f"  do_while_iters={job.do_while_iters}" if job.do_while_iters else "")
    )
    lines.append(
        f"{'id':>4} {'stage':<40} {'vers':>4} {'fail':>4} {'ovfl':>4} "
        f"{'slow':>4} {'secs':>8}  state"
    )
    for s in sorted(job.stages.values(), key=lambda s: s.id):
        state = "NOT DONE"
        if s.completed:
            state = "ckpt" if s.from_checkpoint else "done"
            if s.async_dispatch:
                state += " (async)"
        if s.fused_members:
            state += f" fused[{s.fused_members}]"
        lines.append(
            f"{s.id:>4} {s.name[:40]:<40} {s.versions:>4} {s.failures:>4} "
            f"{s.overflows:>4} {s.stragglers:>4} {s.seconds:>8.3f}  {state}"
        )
    if job.stream:
        st = job.stream
        lines.append(
            "streaming: "
            f"chunks={st.get('chunks', 0)} "
            f"({st.get('chunk_rows', 0)} rows)  "
            f"spills={st.get('spills', 0)} "
            f"({st.get('spill_rows', 0)} rows)  "
            f"buckets={st.get('buckets', 0)}  "
            f"splits={st.get('splits', 0)}  "
            f"combines={st.get('combines', 0)}"
            + (f" ({st['device_combines']} on-device)"
               if st.get("device_combines") else "")
        )
        if st.get("tree_levels"):
            # hierarchical combine panel: level 0/1 merges are exchange-
            # elided (zero collective bytes); the top level is the one
            # exchanged reduction whose dcn column is the DCN crossing
            lines.append("combine tree:")
            for lv in sorted(st["tree_levels"]):
                e = st["tree_levels"][lv]
                lines.append(
                    f"  level {lv}: merges={e['merges']}  "
                    f"in={e['bytes']}B  ici={e['ici']}B  dcn={e['dcn']}B"
                )
            if st.get("degraded_fraction"):
                lines.append(
                    f"  degraded key ranges: "
                    f"{st['degraded_fraction']:.1%} (host accumulation)"
                )
        if st.get("pipelines"):
            # occupancy = mean chunks in flight over the prefetch
            # samples; the stall breakdown names the slow side
            # (ingest_stall = consumer waited on the prefetch thread;
            # compute_stall = prefetch waited on the driver)
            occ = (
                st.get("_occ_sum", 0) / st["prefetched"]
                if st.get("prefetched") else 0.0
            )
            lines.append(
                "pipeline: "
                f"depth={st.get('pipeline_depth', 0)}  "
                f"occupancy={occ:.1f} "
                f"(peak {st.get('peak_in_flight', 0)})  "
                f"stalls: ingest={st.get('ingest_stall_s', 0.0):.3f}s "
                f"compute={st.get('compute_stall_s', 0.0):.3f}s  "
                f"errors={st.get('pipeline_errors', 0)}"
                + (f"  combine_policy={st['combine_policy']}"
                   if st.get("combine_policy") else "")
            )
        if st.get("dispatch_windows"):
            # dispatch-occupancy line: how much of the windows' wall
            # time the device had work queued (1 - gap/wall), and the
            # driver thread's CPU share of it — depth>1 should push
            # occupancy up and driver_cpu down vs the serial baseline
            wall = st.get("_disp_wall_s", 0.0)
            gap = st.get("dispatch_gap_s", 0.0)
            occ = max(0.0, 1.0 - gap / wall) if wall > 0 else 0.0
            cpu = (
                st.get("_disp_cpu_s", 0.0) / wall if wall > 0 else 0.0
            )
            lines.append(
                "dispatch: "
                f"depth={st.get('dispatch_depth', 0)}  "
                f"async={st.get('dispatches', 0)} "
                f"over {st.get('dispatch_windows', 0)} window(s)  "
                f"occupancy={occ:.0%} (gap {gap:.3f}s)  "
                f"driver_cpu={min(cpu, 1.0):.0%}"
                + (
                    f"  retries={st.get('dispatch_retries', 0)}"
                    if st.get("dispatch_retries") else ""
                )
            )
        if st.get("gang_premerges") or st.get("gang_windows"):
            # gang hot-path panel: worker-side pre-merges (level -1 of
            # the combine tree) and the overlapped command window —
            # root_reads should be ~0 once the partition cache is warm,
            # and peak>=2 means the overlap actually happened
            bits = []
            if st.get("gang_premerges"):
                hits = st.get("gang_cache_hits", 0)
                total = hits + st.get("gang_cache_misses", 0)
                bits.append(
                    f"premerge={st.get('gang_premerge_parts', 0)} parts "
                    f"-> {st.get('gang_premerge_rows', 0)} rows on "
                    f"{st['gang_premerges']} worker(s)  "
                    f"root_reads={st.get('gang_root_read_bytes', 0)}B  "
                    f"cache={hits}/{total}"
                )
            if st.get("gang_windows"):
                bits.append(
                    f"depth={st.get('gang_depth', 0)}  "
                    f"envelopes={st.get('gang_dispatches', 0)} "
                    f"over {st['gang_windows']} window(s)  "
                    f"peak_in_flight={st.get('gang_peak_in_flight', 0)}"
                    + (
                        f"  retries={st.get('gang_retries', 0)}"
                        if st.get("gang_retries") else ""
                    )
                )
            lines.append("gang: " + "  ".join(bits))
    if job.exchanges:
        # exchange planner panel: one line per repartitioning stage —
        # window 0 means the flat all_to_all baseline, whose peak is
        # the whole (P, B) send buffer; a staged window caps the peak
        # at window * B * row_bytes per round
        lines.append("exchanges:")
        for name in sorted(job.exchanges):
            e = job.exchanges[name]
            mode = (
                f"window={e['window']}" if e["window"] else "flat"
            )
            lines.append(
                f"  {name}: rounds={e['rounds']} ({mode})  "
                f"peak={e['peak']}B  ici={e['ici']}B  dcn={e['dcn']}B"
            )
    if any(s.attempt_log for s in job.stages.values()):
        lines.append("-- attempt history --")
        for s in sorted(job.stages.values(), key=lambda s: s.id):
            for a in s.attempt_log:
                wait = (
                    f", backoff {a['backoff']:.3f}s" if a["backoff"] else ""
                )
                lines.append(
                    f"  stage {s.id} ({s.name[:32]}) v{a['version']} "
                    f"[{a['kind']}{wait}]: {a['error'][:90]}"
                )
    lines.append("-- diagnosis --")
    lines.extend("  " + d for d in diagnose(job))
    return "\n".join(lines)


# -- vertex-task (partitioned) jobs ----------------------------------------

@dataclasses.dataclass
class VertexJobInfo:
    """Model of one independent-vertex-task job (submit_partitioned):
    the per-vertex drill-down the JobBrowser GUI offers for reference
    jobs (``JOM/jobinfo.cs:62`` vertex lists)."""

    seq: int
    nparts: int
    attempts: Dict[int, int]
    seconds: Dict[int, float]
    computers: Dict[int, str]
    duplicated: List[int]
    dup_wins: List[int]
    retries: List[int]
    completed: bool
    failed_part: Optional[int] = None
    wire_bytes: int = 0
    raw_bytes: int = 0
    workers_joined: int = 0
    workers_dead: int = 0
    # part -> [{attempt, computer, error, backoff, kind}] retry records
    attempt_log: Dict[int, List[Dict[str, Any]]] = dataclasses.field(
        default_factory=dict
    )


def build_vertex_jobs(events: List[Dict[str, Any]]) -> List[VertexJobInfo]:
    """Fold a LocalJobSubmission event stream into vertex-job models."""
    jobs: List[VertexJobInfo] = []
    cur: Optional[VertexJobInfo] = None
    joined = dead = 0
    for ev in events:
        kind = ev["kind"]
        if kind == "worker_joined":
            joined += 1
        elif kind == "worker_dead":
            dead += 1
        # membership counters reflect what each job could SEE: stamped
        # continuously while the job is open, frozen once it ends (a
        # later worker_dead must not be misattributed to an earlier job)
        if cur is not None and not cur.completed and cur.failed_part is None:
            cur.workers_joined = joined
            cur.workers_dead = dead
        if kind in ("worker_joined", "worker_dead"):
            continue
        if kind == "vertex_job_start":
            cur = VertexJobInfo(
                ev.get("seq", 0), ev.get("nparts", 0),
                {}, {}, {}, [], [], [], False,
                workers_joined=joined, workers_dead=dead,
            )
            jobs.append(cur)
        elif cur is None:
            continue
        elif kind == "vertex_complete":
            p = ev["part"]
            cur.attempts[p] = cur.attempts.get(p, 1)
            cur.seconds[p] = ev.get("seconds", 0.0)
            cur.computers[p] = ev.get("computer", "?")
        elif kind == "vertex_duplicate":
            cur.duplicated.append(ev["part"])
        elif kind == "vertex_duplicate_win":
            cur.dup_wins.append(ev["part"])
        elif kind == "vertex_retry":
            cur.retries.append(ev["part"])
            cur.attempts[ev["part"]] = ev.get("attempt", 2)
            cur.attempt_log.setdefault(ev["part"], []).append({
                "attempt": ev.get("attempt", 2),
                "computer": ev.get("computer"),
                "error": ev.get("error") or "",
                "backoff": ev.get("backoff", 0.0),
                "kind": ev.get("failure_kind", "transient"),
            })
        elif kind == "vertex_job_complete":
            cur.completed = True
        elif kind == "vertex_job_failed":
            cur.failed_part = ev.get("part")
        elif kind == "assemble_fetch":
            cur.wire_bytes += ev.get("wire_bytes", 0)
            cur.raw_bytes += ev.get("raw_bytes", 0)
    return jobs


def render_vertex_job(j: VertexJobInfo) -> str:
    """Per-vertex drill-down: attempts, placement, duplication story."""
    lines = [
        f"vertex job r{j.seq}: "
        + ("OK" if j.completed else f"FAILED (part {j.failed_part})")
        + f"  parts={j.nparts}  workers_joined={j.workers_joined}"
        + (f"  workers_dead={j.workers_dead}" if j.workers_dead else "")
    ]
    lines.append(f"{'part':>5} {'attempts':>8} {'secs':>8} {'computer':<12} notes")
    for p in range(j.nparts):
        notes = []
        if p in j.duplicated:
            notes.append("duplicated")
        if p in j.dup_wins:
            notes.append("dup won")
        if p in j.retries:
            notes.append("re-executed")
        lines.append(
            f"{p:>5} {j.attempts.get(p, 0):>8} "
            f"{j.seconds.get(p, 0.0):>8.3f} "
            f"{j.computers.get(p, '?'):<12} {', '.join(notes) or '—'}"
        )
    if j.raw_bytes:
        ratio = j.raw_bytes / max(j.wire_bytes, 1)
        lines.append(
            f"assemble: {j.raw_bytes} bytes decoded from {j.wire_bytes} "
            f"on the wire ({ratio:.1f}x compression)"
        )
    if j.attempt_log:
        lines.append("attempt history:")
        for p in sorted(j.attempt_log):
            for a in j.attempt_log[p]:
                where = f" (prev on {a['computer']})" if a["computer"] else ""
                wait = (
                    f", backoff {a['backoff']:.3f}s" if a["backoff"] else ""
                )
                lines.append(
                    f"  part {p} -> attempt {a['attempt']}{where} "
                    f"[{a['kind']}{wait}]: {a['error'][:80]}"
                )
    return "\n".join(lines)


# -- coded k-of-n stage panel (dryad_tpu_torch.redundancy) ------------------------

@dataclasses.dataclass
class CodedJobInfo:
    """Model of one coded k-of-n stage (``submit_partitioned`` with a
    linear combiner): which coded vertices ran, which r-spare launches
    fired, which k-subset reconstructed the output, and how much coded
    work was wasted."""

    seq: int
    k: int
    n: int
    r: int
    agg_kind: str = ""
    seconds: Dict[int, float] = dataclasses.field(default_factory=dict)
    parity: Dict[int, bool] = dataclasses.field(default_factory=dict)
    computers: Dict[int, str] = dataclasses.field(default_factory=dict)
    failed: List[int] = dataclasses.field(default_factory=list)
    retries: List[int] = dataclasses.field(default_factory=list)
    launch_trigger: Optional[str] = None
    launch_threshold: Optional[float] = None
    used: List[int] = dataclasses.field(default_factory=list)
    parity_used: int = 0
    exact: Optional[bool] = None
    waste_bytes: int = 0
    canceled: int = 0
    completed: bool = False
    total_seconds: float = 0.0


def build_coded_jobs(events: List[Dict[str, Any]]) -> List[CodedJobInfo]:
    """Fold coded_* events into per-stage k-of-n models."""
    jobs: List[CodedJobInfo] = []
    cur: Optional[CodedJobInfo] = None
    for ev in events:
        kind = ev["kind"]
        if kind == "coded_job_start":
            cur = CodedJobInfo(
                ev.get("seq", 0), ev.get("k", 0), ev.get("n", 0),
                ev.get("r", 0), agg_kind=ev.get("agg", ""),
            )
            jobs.append(cur)
        elif cur is None:
            continue
        elif kind == "coded_task_complete":
            j = ev["coded"]
            cur.seconds[j] = ev.get("seconds", 0.0)
            cur.parity[j] = bool(ev.get("parity"))
            cur.computers[j] = ev.get("computer", "?")
        elif kind == "coded_task_failed":
            cur.failed.append(ev["coded"])
        elif kind == "coded_retry":
            cur.retries.append(ev["coded"])
        elif kind == "coded_launch":
            cur.launch_trigger = ev.get("trigger")
            cur.launch_threshold = ev.get("threshold")
        elif kind == "coded_reconstruct":
            cur.used = list(ev.get("used", []))
            cur.parity_used = ev.get("parity_used", 0)
            cur.exact = ev.get("exact")
        elif kind == "coded_waste_bytes":
            cur.waste_bytes += ev.get("bytes", 0)
        elif kind == "coded_cancel":
            cur.canceled += ev.get("canceled", 0)
        elif kind == "coded_job_complete":
            cur.completed = True
            cur.total_seconds = ev.get("seconds", 0.0)
    return jobs


def render_coded_job(c: CodedJobInfo) -> str:
    """The per-stage k-of-n panel: coded roles, spare launch, decode."""
    head = (
        f"coded stage r{c.seq}: "
        + ("OK" if c.completed else "FAILED/INCOMPLETE")
        + f"  k={c.k} of n={c.n} ({c.r} parity)"
        + (f"  {c.total_seconds:.3f}s" if c.completed else "")
    )
    lines = [head]
    if c.launch_trigger:
        thr = (
            f" at threshold {c.launch_threshold:.3f}s"
            if c.launch_threshold else ""
        )
        lines.append(f"  spares launched on {c.launch_trigger}{thr}")
    lines.append(
        f"  {'coded':>6} {'role':<6} {'secs':>8} {'computer':<12} notes"
    )
    ids = sorted(
        set(c.seconds) | set(c.failed) | set(range(c.k))
    )
    for j in ids:
        role = "parity" if (c.parity.get(j) or j >= c.k) else "data"
        notes = []
        if j in c.used:
            notes.append("used")
        elif j in c.seconds:
            notes.append("unused")
        if j in c.failed:
            notes.append("failed")
        if j in c.retries:
            notes.append("re-executed")
        secs = c.seconds.get(j)
        lines.append(
            f"  {j:>6} {role:<6} "
            + (f"{secs:>8.3f}" if secs is not None else f"{'—':>8}")
            + f" {c.computers.get(j, '—'):<12} {', '.join(notes) or '—'}"
        )
    if c.used:
        lines.append(
            f"  reconstructed from {c.used} "
            f"(parity_used={c.parity_used}, "
            + ("exact" if c.exact else "float64")
            + (f", waste={c.waste_bytes}B" if c.waste_bytes else "")
            + (f", canceled={c.canceled}" if c.canceled else "")
            + ")"
        )
    return "\n".join(lines)


# -- per-computer failure / quarantine summary ------------------------------

@dataclasses.dataclass
class ComputerHealth:
    """Fold of one computer's failure accounting from the event stream
    (the machine-blacklist story the reference GM keeps internally,
    made post-mortem inspectable)."""

    name: str
    failures: int = 0
    quarantines: int = 0
    probations: int = 0
    readmissions: int = 0
    stranded: int = 0
    last_error: Optional[str] = None
    state: str = "ok"  # ok | quarantined | probation


def build_computer_health(
    events: List[Dict[str, Any]],
) -> Dict[str, ComputerHealth]:
    """Fold scheduler failure/quarantine events into per-computer
    health records (``state`` is the LAST observed state)."""
    out: Dict[str, ComputerHealth] = {}

    def h(name: str) -> ComputerHealth:
        return out.setdefault(name, ComputerHealth(name))

    for ev in events:
        kind = ev["kind"]
        if kind == "process_failed":
            c = h(ev.get("computer", "?"))
            c.failures += 1
            c.last_error = ev.get("error")
        elif kind == "computer_quarantined":
            c = h(ev["computer"])
            c.quarantines += 1
            c.state = "quarantined"
        elif kind == "computer_probation":
            c = h(ev["computer"])
            c.probations += 1
            c.state = "probation"
        elif kind == "computer_readmitted":
            c = h(ev["computer"])
            c.readmissions += 1
            c.state = "ok"
        elif kind == "process_stranded":
            h(ev.get("computer", "?")).stranded += 1
    return out


def render_computer_health(health: Dict[str, ComputerHealth]) -> str:
    """Per-computer failure/quarantine table (empty string when the
    stream carries no failure accounting)."""
    if not health:
        return ""
    lines = [
        "-- computer health --",
        f"{'computer':<14} {'fail':>4} {'quar':>4} {'prob':>4} "
        f"{'readm':>5}  state",
    ]
    for c in sorted(health.values(), key=lambda c: c.name):
        line = (
            f"{c.name:<14} {c.failures:>4} {c.quarantines:>4} "
            f"{c.probations:>4} {c.readmissions:>5}  {c.state}"
        )
        if c.stranded:
            line += f"  ({c.stranded} stranded)"
        if c.last_error:
            line += f"  last: {c.last_error[:60]}"
        lines.append(line)
    return "\n".join(lines)


def topology_svg(job: JobInfo) -> str:
    """Self-contained SVG of the job's stage DAG, rebuilt from the
    event log's job_start topology and colored by observed stage state
    (green done, blue checkpoint-hit, red failed, grey not run) — the
    JobBrowser drawing surface (``JobBrowser/Tools/drawingSurface.cs``)
    over log data.  Empty string when the log predates topology
    events."""
    if not job.topology:
        return ""
    # layered layout: plan inputs on layer 0, each stage one past its
    # deepest producer (same algorithm as tools/explain._layered_layout)
    layer: Dict[str, int] = {}
    for ent in job.topology:
        deps = []
        for ref, idx in ent["deps"]:
            key = f"in{idx}" if ref == "in" else f"s{ref}"
            if key.startswith("in"):
                layer.setdefault(key, 0)
            deps.append(layer.get(key, 0))
        layer[f"s{ent['id']}"] = (max(deps) + 1) if deps else 1
    cols: Dict[str, int] = {}
    counts: Dict[int, int] = {}
    for key, ly in layer.items():
        cols[key] = counts.get(ly, 0)
        counts[ly] = counts.get(ly, 0) + 1

    BW, BH, GX, GY, PAD = 180, 40, 30, 56, 16
    width = max(counts.values()) * (BW + GX) + PAD * 2
    height = (max(layer.values()) + 1) * (BH + GY) + PAD * 2

    def pos(key):
        ly, c = layer[key], cols[key]
        row_w = counts[ly] * BW + (counts[ly] - 1) * GX
        x0 = (width - row_w) / 2 + c * (BW + GX)
        return x0, PAD + ly * (BH + GY)

    def esc(t: str) -> str:
        return t.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")

    out = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width:.0f}" '
        f'height="{height:.0f}" font-family="monospace" font-size="11">',
        '<defs><marker id="jv-arr" markerWidth="8" markerHeight="8" '
        'refX="7" refY="4" orient="auto"><path d="M0,0 L8,4 L0,8 z" '
        'fill="#555"/></marker></defs>',
    ]
    for ent in job.topology:  # edges first, under the boxes
        x1, y1 = pos(f"s{ent['id']}")
        for ref, idx in ent["deps"]:
            key = f"in{idx}" if ref == "in" else f"s{ref}"
            x0, y0 = pos(key)
            out.append(
                f'<line x1="{x0 + BW / 2:.0f}" y1="{y0 + BH:.0f}" '
                f'x2="{x1 + BW / 2:.0f}" y2="{y1:.0f}" stroke="#555" '
                'marker-end="url(#jv-arr)"/>'
            )
    for key, ly in layer.items():
        x, y = pos(key)
        if key.startswith("in"):
            fill, label, sub = "#f4f6f6", f"input {key[2:]}", ""
        else:
            sid = int(key[1:])
            s = job.stages.get(sid)
            if s is None:
                fill, sub = "#d5d8dc", "not run"
            elif s.failures and not s.completed:
                fill, sub = "#f5b7b1", f"{s.failures} fail"
            elif s.from_checkpoint:
                fill, sub = "#d6eaf8", "checkpoint"
            elif s.completed:
                fill, sub = "#d5f5e3", f"{s.seconds:.3f}s"
            else:
                fill, sub = "#fdebd0", "incomplete"
            ent = next(e for e in job.topology if e["id"] == sid)
            label = f"s{sid} {ent['name']}"
        out.append(
            f'<rect x="{x:.0f}" y="{y:.0f}" width="{BW}" height="{BH}" '
            f'rx="6" fill="{fill}" stroke="#7f8c8d"/>'
            f'<text x="{x + 8:.0f}" y="{y + 16:.0f}">{esc(label[:26])}</text>'
            f'<text x="{x + 8:.0f}" y="{y + 31:.0f}" '
            f'fill="#566573">{esc(sub)}</text>'
        )
    out.append("</svg>")
    return "".join(out)


def render_html(job: JobInfo) -> str:
    """Standalone HTML report (the JobBrowser GUI analog): stage DAG
    drawing, stage table with duration bars, status badges, and the
    diagnosis list."""
    import html as H

    status = "FAILED" if job.failed else ("OK" if job.completed else "INCOMPLETE")
    color = {"FAILED": "#c0392b", "OK": "#1e8449", "INCOMPLETE": "#b9770e"}[status]
    max_s = max((s.seconds for s in job.stages.values()), default=0.0) or 1.0
    rows = []
    for s in sorted(job.stages.values(), key=lambda s: s.id):
        state = "not done"
        if s.completed:
            state = "checkpoint" if s.from_checkpoint else "done"
        bar = int(100 * s.seconds / max_s)
        flags = []
        if s.failures:
            flags.append(f"{s.failures} fail")
        if s.overflows:
            flags.append(f"{s.overflows} ovfl (boost {s.max_boost}x)")
        if s.stragglers:
            flags.append(f"{s.stragglers} slow")
        rows.append(
            f"<tr><td>{s.id}</td><td><code>{H.escape(s.name)}</code></td>"
            f"<td>{s.versions}</td>"
            f"<td><div style='background:#d6eaf8;width:{bar}%;"
            f"min-width:2px;padding:1px 3px'>{s.seconds:.3f}s</div></td>"
            f"<td>{H.escape(', '.join(flags) or '—')}</td>"
            f"<td>{H.escape(state)}</td></tr>"
        )
    diag = "".join(f"<li>{H.escape(d)}</li>" for d in diagnose(job))
    return f"""<!doctype html><html><head><meta charset="utf-8">
<title>dryad_tpu job report</title>
<style>
body{{font-family:system-ui,sans-serif;margin:2em;max-width:70em}}
table{{border-collapse:collapse;width:100%}}
td,th{{border:1px solid #ccc;padding:4px 8px;text-align:left;font-size:14px}}
th{{background:#f2f3f4}}
.badge{{display:inline-block;padding:2px 10px;border-radius:4px;
color:#fff;background:{color};font-weight:600}}
</style></head><body>
<h1>Job report <span class="badge">{status}</span></h1>
<p>stages {len(job.stages)}/{job.n_stages_declared or "?"}
 · wall {job.wall_seconds:.3f}s
{f" · do_while iterations {job.do_while_iters}" if job.do_while_iters else ""}</p>
<table><tr><th>id</th><th>stage</th><th>versions</th><th>duration</th>
<th>flags</th><th>state</th></tr>
{"".join(rows)}
</table>
{f"<h2>Stage DAG</h2><div style='overflow-x:auto'>{topology_svg(job)}</div>" if job.topology else ""}
<h2>Diagnosis</h2><ul>{diag}</ul>
</body></html>"""


def build_gang_runs(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-seq model of gang SPMD submissions: one entry per run, with
    completion and straggler status folded together (localjob emits
    gang_straggler AND gang_run_complete for an outlier run)."""
    runs: Dict[Any, Dict[str, Any]] = {}
    for ev in events:
        seq = ev.get("seq")
        if ev["kind"] == "gang_run_start":
            runs[seq] = {"seq": seq, "completed": False, "straggler": None}
        elif ev["kind"] == "gang_run_complete":
            r = runs.setdefault(
                seq, {"seq": seq, "completed": False, "straggler": None}
            )
            r["completed"] = True
            r["seconds"] = ev.get("seconds", 0.0)
        elif ev["kind"] == "gang_straggler":
            r = runs.setdefault(
                seq, {"seq": seq, "completed": False, "straggler": None}
            )
            r["straggler"] = ev.get("threshold", 0.0)
    return list(runs.values())


def _render_gang_run(r: Dict[str, Any]) -> str:
    if not r["completed"]:
        # started but never completed: the submit raised mid-run
        return f"gang run r{r['seq']}: FAILED/INCOMPLETE"
    line = f"gang run r{r['seq']}: OK  {r.get('seconds', 0.0):.3f}s"
    if r["straggler"] is not None:
        line += f"  (STRAGGLER: threshold {r['straggler']:.3f}s)"
    return line


def fold_submission(
    events: List[Dict[str, Any]],
) -> Tuple[str, bool]:
    """(rendered text, ok) for a LocalJobSubmission event stream —
    ONE fold shared by rendering and the exit code."""
    gang = build_gang_runs(events)
    vjobs = build_vertex_jobs(events)
    cjobs = build_coded_jobs(events)
    parts = []
    if gang:
        parts.append("\n".join(_render_gang_run(r) for r in gang))
    parts.extend(render_vertex_job(vj) for vj in vjobs)
    parts.extend(render_coded_job(cj) for cj in cjobs)
    health = build_computer_health(events)
    if health:
        parts.append(render_computer_health(health))
    ok = (
        all(r["completed"] for r in gang)
        and all(vj.completed for vj in vjobs)
        and all(cj.completed for cj in cjobs)
    )
    return "\n\n".join(parts), ok


def render_attribution(events: List[Dict[str, Any]]) -> str:
    """The obs time-attribution block (compile vs execute vs
    ingest-stall vs spill) plus a critical-path line (wall time vs the
    accounted leaf time, and the longest single span — the place to
    attack first).  Empty when the stream has no obs data."""
    from dryad_tpu_torch.obs.metrics import JobMetrics, format_attribution

    m = JobMetrics.from_events(events)
    lines = format_attribution(m)
    if not lines:
        return ""
    ts = [e["ts"] for e in events if "ts" in e]
    wall = (max(ts) - min(ts)) if len(ts) > 1 else 0.0
    spans = [e for e in events if e.get("kind") == "span"]
    if wall > 0 and spans:
        accounted = (
            m.compile_s + m.execute_s + m.ingest_stall_s + m.spill_write_s
            + m.checkpoint_s
        )
        top = max(spans, key=lambda e: e.get("dur", 0.0))
        lines.append(
            f"critical path: wall={wall:.3f}s  accounted="
            f"{min(accounted / wall, 1.0):.0%}  longest span="
            f"{top.get('name')} ({top.get('dur', 0.0):.3f}s, "
            f"{top.get('cat')})"
        )
    return "\n".join(["-- time attribution --"] + ["  " + l for l in lines])


def render_health(events: List[Dict[str, Any]]) -> str:
    """Live-pathology panel: ``diagnosis`` events the online engine
    (``obs.diagnose``) emitted into the stream, newest last, plus any
    ring-truncation markers — so ``--follow`` shows WHAT is going
    wrong while it still is.  Empty when the stream is healthy."""
    diags = [e for e in events if e.get("kind") == "diagnosis"]
    dropped = [e for e in events if e.get("kind") == "events_dropped"]
    if not diags and not dropped:
        return ""
    lines = ["-- health --"]
    for d in diags:
        ev = d.get("evidence") or {}
        subject = ev.get("subject", "")
        brief = " ".join(
            f"{k}={v}" for k, v in sorted(ev.items()) if k != "subject"
        )
        lines.append(
            f"  [{d.get('severity', '?'):<5}] {d.get('rule')}"
            + (f" ({subject})" if subject else "")
            + (f": {brief}" if brief else "")
        )
        if d.get("hint"):
            lines.append(f"      hint: {d['hint']}")
    if dropped:
        lines.append(
            f"  NOTE: event ring overflowed ({dropped[-1].get('dropped')} "
            "evicted) — older history above is truncated"
        )
    return "\n".join(lines)


def render_rewrites(events: List[Dict[str, Any]]) -> str:
    """Runtime plan-rewrite panel: the ``plan_rewrite`` audit trail
    (``rewrite.controller``), one line per decision with whether a
    driver applied it at a safe boundary — the closed diagnosis→replan
    loop made visible.  Empty when nothing was rewritten."""
    rws = [e for e in events if e.get("kind") == "plan_rewrite"]
    if not rws:
        return ""
    applied = {
        (e.get("action"), e.get("subject"), e.get("bucket"))
        for e in rws if e.get("phase") == "applied"
    }
    lines = ["-- plan rewrites --"]
    for e in rws:
        if e.get("phase") != "decided":
            continue
        tag = (e.get("action"), e.get("subject"), e.get("bucket"))
        detail = " ".join(
            f"{k}={e[k]}"
            for k in ("bucket", "depth", "fan", "boost", "mode",
                      "tree", "window")
            if k in e
        )
        lines.append(
            f"  {e.get('action')} <- {e.get('rule')}"
            + (f" ({e.get('subject')})" if e.get("subject") else "")
            + (f": {detail}" if detail else "")
            + ("  [applied]" if tag in applied else "  [pending]")
        )
    return "\n".join(lines)


def render_tenants(events: List[Dict[str, Any]]) -> str:
    """Serving-tier panel: one line per tenant (queries in flight,
    cache hits, quota state) folded from the ``query_*`` /
    ``result_cache_hit`` / ``tenant_quota`` events the QueryService
    emits.  Empty for non-serving streams."""
    from dryad_tpu_torch.obs.metrics import JobMetrics

    m = JobMetrics.from_events(events)
    if not m.tenants:
        return ""
    lines = ["-- tenants --"]
    for name in sorted(m.tenants):
        t = m.tenants[name]
        in_flight = t["admitted"] - t["completed"]
        done = t["completed"]
        hit_rate = t["cache_hits"] / done if done else 0.0
        mean_s = t["seconds"] / done if done else 0.0
        lines.append(
            f"  {name}: in_flight={in_flight}  done={done} "
            f"(mean {mean_s:.3f}s)  cache_hits={t['cache_hits']} "
            f"({hit_rate:.0%})  rejected={t['rejected']}  "
            f"failed={t['failed']}  quota={t['quota_state']}"
        )
    return "\n".join(lines)


def render_views(events: List[Dict[str, Any]]) -> str:
    """Materialized-view panel: one line per registered view (delta
    folds, state rows, how reads resolved) plus the structured
    registration refusals, folded from the ``view_*`` events.  Empty
    for streams with no view activity."""
    from dryad_tpu_torch.obs.metrics import JobMetrics

    m = JobMetrics.from_events(events)
    if not (m.views_registered or m.view_fallbacks):
        return ""
    lines = ["-- views --"]
    per: Dict[str, Dict[str, Any]] = {}
    for e in events:
        kind = e.get("kind")
        if kind not in ("view_register", "view_delta", "view_snapshot"):
            continue
        v = per.setdefault(
            str(e.get("view", "?")),
            {"tenant": e.get("tenant", "?"), "deltas": 0, "rows": 0,
             "state_rows": 0, "fresh": 0, "finalized": 0},
        )
        if kind == "view_register":
            v["state_rows"] = int(e.get("state_rows", 0) or 0)
        elif kind == "view_delta":
            v["deltas"] += 1
            v["rows"] += int(e.get("rows", 0) or 0)
            v["state_rows"] = int(e.get("state_rows", 0) or 0)
        elif e.get("fresh"):
            v["fresh"] += 1
        else:
            v["finalized"] += 1
    for name in sorted(per):
        v = per[name]
        reads = v["fresh"] + v["finalized"]
        fresh_rate = v["fresh"] / reads if reads else 0.0
        lines.append(
            f"  {name} ({v['tenant']}): deltas={v['deltas']} "
            f"({v['rows']} rows)  state_rows={v['state_rows']}  "
            f"reads={reads} (fresh {fresh_rate:.0%})"
        )
    for e in events:
        if e.get("kind") == "view_fallback":
            lines.append(
                f"  fallback ({e.get('tenant', '?')}): "
                f"{e.get('reason', '?')}"
            )
    return "\n".join(lines)


def render_queries(events: List[Dict[str, Any]]) -> str:
    """Per-query critical-path panel: one line per traced query
    (``obs.critpath`` fold over the qid-stamped span/compile/lifecycle
    events), showing where each query's wall time went — admission
    wait, cache probe, compile, ingest, dispatch, exchange,
    collective, readback.  Empty for streams with no query-scoped
    events."""
    from dryad_tpu_torch.obs import critpath

    folds = {
        qid: bd
        for qid, bd in critpath.fold_all(events).items()
        if bd.phases or bd.spans
    }
    if not folds:
        return ""
    lines = ["-- queries --"]
    for bd in folds.values():
        lines.append("  " + bd.format())
    return "\n".join(lines)


def render_telemetry(events: List[Dict[str, Any]]) -> str:
    """Continuous-telemetry panel: the ``resource_sample`` stream
    (``obs.telemetry.ResourceMonitor``) folded to HBM/RSS extremes,
    plus per-tenant admission→completion latency percentiles recomputed
    from ``query_complete`` events with the SAME pow2 bucketing the
    live RollingStore uses — so this panel and a ``metricsd`` scrape
    agree bucket-for-bucket.  Empty when the stream has no samples."""
    from dryad_tpu_torch.obs import telemetry

    samples = [e for e in events if e.get("kind") == "resource_sample"]
    if not samples:
        return ""
    lines = [f"-- telemetry ({len(samples)} samples) --"]
    hbm = [e for e in samples if e.get("hbm_limit_bytes")]
    if hbm:
        last = hbm[-1]
        min_head = min(int(e.get("hbm_headroom_bytes", 0)) for e in hbm)
        lines.append(
            f"  hbm: used={int(last.get('hbm_used_bytes', 0)) >> 20}MB"
            f"/{int(last.get('hbm_limit_bytes', 0)) >> 20}MB  "
            f"headroom={int(last.get('hbm_headroom_bytes', 0)) >> 20}MB "
            f"(min {min_head >> 20}MB)"
        )
    rss = [e for e in samples if e.get("rss_kb")]
    if rss:
        lines.append(
            f"  host rss: last={int(rss[-1]['rss_kb']) >> 10}MB  "
            f"peak={max(int(e['rss_kb']) for e in rss) >> 10}MB"
        )
    by_tenant: Dict[str, List[float]] = {}
    for e in events:
        if e.get("kind") == "query_complete" and "seconds" in e:
            by_tenant.setdefault(str(e.get("tenant", "?")), []).append(
                float(e["seconds"])
            )
    for name in sorted(by_tenant):
        vals = by_tenant[name]
        p50 = telemetry.percentile_of(vals, 0.5)
        p95 = telemetry.percentile_of(vals, 0.95)
        p99 = telemetry.percentile_of(vals, 0.99)
        lines.append(
            f"  slo {name}: n={len(vals)}  p50<={p50:.4g}s  "
            f"p95<={p95:.4g}s  p99<={p99:.4g}s"
        )
    return "\n".join(lines)


def _render_stream(events: List[Dict[str, Any]]) -> str:
    """Render whichever job model the stream holds."""
    kinds = {e["kind"] for e in events}
    if kinds & {"vertex_job_start", "gang_run_start", "coded_job_start"}:
        text = fold_submission(events)[0]
    else:
        text = render(build_job(events))
    attr = render_attribution(events)
    tenants = render_tenants(events)
    views = render_views(events)
    queries = render_queries(events)
    telemetry = render_telemetry(events)
    health = render_health(events)
    rewrites = render_rewrites(events)
    return (
        text
        + ("\n" + attr if attr else "")
        + ("\n\n" + tenants if tenants else "")
        + ("\n\n" + views if views else "")
        + ("\n\n" + queries if queries else "")
        + ("\n\n" + telemetry if telemetry else "")
        + ("\n\n" + health if health else "")
        + ("\n\n" + rewrites if rewrites else "")
    )


def _load_tolerant(path: str) -> List[Dict[str, Any]]:
    """Load a JSONL event log that may be MID-WRITE: a torn final line
    (flushed across two OS writes by the producer) is skipped rather
    than crashing the live view."""
    import json

    out: List[Dict[str, Any]] = []
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # torn tail; the next poll re-reads it
    except OSError:
        pass
    return out


def _watch_events(
    path: str, interval: float, max_rounds: Optional[int] = None
):
    """Yield a fresh event list each time the log file changes — the
    ONE change-detection loop behind both live renderers.  Bounded by
    ``max_rounds`` for tests; swallows Ctrl-C as a clean stop."""
    import os
    import time

    last = -1
    rounds = 0
    try:
        while max_rounds is None or rounds < max_rounds:
            rounds += 1
            try:
                size = os.path.getsize(path)
            except OSError:
                size = -1
            if size != last:
                last = size
                yield _load_tolerant(path) if size > 0 else []
            time.sleep(interval)
    except KeyboardInterrupt:
        return


def _submission_html(text: str, extra_head: str = "") -> str:
    """The submission-log report page (shared by the one-shot --html
    path and the live page)."""
    import html as H

    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"{extra_head}<title>dryad_tpu submission log</title></head>"
        f"<body><pre>{H.escape(text)}</pre></body></html>"
    )


def follow(path: str, interval: float = 1.0) -> None:
    """LIVE view (the JobBrowser's running-job mode): re-render whenever
    the event log grows; Ctrl-C to stop."""
    for events in _watch_events(path, interval):
        print("\x1b[2J\x1b[H", end="")  # clear screen, home
        print(_render_stream(events))
        print(f"\n[watching {path} — Ctrl-C to stop]")


def follow_html(
    path: str, out: str, interval: float = 1.0, max_rounds: Optional[int] = None
) -> None:
    """LIVE HTML view: re-render the report whenever the event log
    grows; the page self-refreshes (the JobBrowser running-job GUI as
    a static file any browser can watch).  ``max_rounds`` bounds the
    loop for tests."""
    import os
    import time

    refresh = f'<meta http-equiv="refresh" content="{max(1, int(interval))}">'
    for events in _watch_events(path, interval, max_rounds):
        if {e["kind"] for e in events} & {
            "vertex_job_start", "gang_run_start", "coded_job_start"
        }:
            text, _ok = fold_submission(events)
            page = _submission_html(text, extra_head=refresh)
        else:
            page = render_html(build_job(events)).replace(
                "</title>", f"</title>{refresh}", 1
            )
        tmp = f"{out}.tmp"
        with open(tmp, "w") as fh:
            fh.write(page)
        os.replace(tmp, out)  # atomic: the browser never sees a torn page


def main(argv: Optional[List[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]

    def _flag_with_arg(name: str) -> Optional[str]:
        nonlocal argv
        if name not in argv:
            return None
        i = argv.index(name)
        try:
            val = argv[i + 1]
        except IndexError:
            raise SystemExit(f"{name} requires an output path")
        argv = argv[:i] + argv[i + 2:]
        return val

    html_out = _flag_with_arg("--html")
    trace_out = _flag_with_arg("--trace")
    live = "--follow" in argv
    if live:
        argv.remove("--follow")
    if len(argv) != 1:
        print(
            "usage: python -m dryad_tpu_torch.tools.jobview [--html out.html] "
            "[--trace out.json] [--follow] <events.jsonl>\n"
            "  --html out.html   standalone HTML report "
            "(--follow --html = live page)\n"
            "  --trace out.json  Chrome-trace (Perfetto) export: span "
            "tracks per thread\n"
            "                    (prefetch/compute/spill), occupancy "
            "counters, one process\n"
            "                    per worker for merged gang telemetry\n"
            "  --follow          live re-render as the log grows"
        )
        return 2
    if live:
        if html_out:
            print(f"live HTML -> {html_out} (Ctrl-C to stop)")
            follow_html(argv[0], html_out)
        else:
            follow(argv[0])
        return 0
    events = EventLog.load(argv[0])
    if trace_out:
        from dryad_tpu_torch.obs.trace import write_chrome_trace

        write_chrome_trace(events, trace_out)
        print(f"wrote {trace_out}")
    attr = render_attribution(events)
    if {e["kind"] for e in events} & {"vertex_job_start", "gang_run_start", "coded_job_start"}:
        text, ok = fold_submission(events)
        if attr:
            text = text + "\n" + attr
        if html_out:
            with open(html_out, "w") as fh:
                fh.write(_submission_html(text))
            print(f"wrote {html_out}")
        print(text)
        return 0 if ok else 1
    job = build_job(events)
    if html_out:
        with open(html_out, "w") as fh:
            fh.write(render_html(job))
        print(f"wrote {html_out}")
    print(render(job))
    if attr:
        print(attr)
    return 0 if job.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
