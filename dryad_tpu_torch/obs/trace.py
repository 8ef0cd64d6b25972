"""Chrome-trace (Perfetto) export of an event stream (a copy of
``dryad_tpu/obs/trace.py``).

Renders the framework's event log in the Trace Event Format that
``ui.perfetto.dev`` / ``chrome://tracing`` load directly:

- each ``span`` event becomes a complete ("X") slice on a track named
  after the THREAD that ran it — so the pipeline's prefetch thread(s),
  the driver's compute loop, and the background spill writer show as
  separate swim lanes, and the pipeline's overlap is visible;
- ``stream_prefetch`` events become an ``in_flight`` counter track
  (pipeline occupancy over time);
- ``dispatch_gap`` events become an ``in_flight_dispatches`` counter
  track (async-dispatch window occupancy — dips mark device idle);
- every other event becomes an instant marker on a per-process
  "events" track, so state transitions (stage_failed, quarantine,
  combine-policy flips) line up against the slices that caused them;
- processes: the driver is pid 0; worker telemetry merged by
  ``obs.gang`` carries a ``worker`` field and renders as its own
  process (pid = worker + 1) with clock-offset-corrected timestamps.

Timestamps are wall-clock (``ts``) rebased to the stream's first
event, in microseconds; span starts are recovered as ``ts - dur``
(spans serialize at close, see ``obs.span``).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional

__all__ = ["chrome_trace", "write_chrome_trace"]


def _pid_of(ev: Dict[str, Any]) -> int:
    w = ev.get("worker")
    return 0 if w is None else int(w) + 1


def chrome_trace(
    events: Iterable[Dict[str, Any]], title: str = "dryad_tpu job"
) -> Dict[str, Any]:
    """Fold an event stream into a Trace Event Format dict."""
    evs = [e for e in events if "ts" in e]
    if not evs:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    base = min(
        (e["ts"] - e.get("dur", 0.0)) if e.get("kind") == "span" else e["ts"]
        for e in evs
    )

    out: List[Dict[str, Any]] = []
    tids: Dict[tuple, int] = {}  # (pid, track label) -> tid
    pids_seen: Dict[int, str] = {}

    def tid_of(pid: int, label: str) -> int:
        key = (pid, label)
        t = tids.get(key)
        if t is None:
            t = tids[key] = len([k for k in tids if k[0] == pid]) + 1
            out.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": t,
                "args": {"name": label},
            })
        return t

    def note_pid(pid: int) -> None:
        if pid not in pids_seen:
            pids_seen[pid] = "driver" if pid == 0 else f"worker{pid - 1}"
            out.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": pids_seen[pid]},
            })

    for ev in evs:
        kind = ev.get("kind")
        pid = _pid_of(ev)
        note_pid(pid)
        if kind == "span":
            dur = float(ev.get("dur", 0.0))
            label = ev.get("thread") or ev.get("cat") or "driver"
            args = {
                k: v for k, v in ev.items()
                if k not in ("ts", "mono", "kind", "name", "dur", "thread",
                             "worker")
            }
            out.append({
                "ph": "X", "name": str(ev.get("name", "span")),
                "cat": str(ev.get("cat", "driver")),
                "pid": pid, "tid": tid_of(pid, label),
                "ts": round((ev["ts"] - dur - base) * 1e6, 1),
                "dur": round(dur * 1e6, 1),
                "args": args,
            })
        elif kind == "stream_prefetch":
            out.append({
                "ph": "C", "name": f"in_flight:{ev.get('pipeline', '?')}",
                "pid": pid, "tid": 0,
                "ts": round((ev["ts"] - base) * 1e6, 1),
                "args": {"in_flight": ev.get("in_flight", 0)},
            })
        elif kind == "dispatch_gap":
            # async-dispatch occupancy: each gap event samples the
            # window going idle, so the counter dips to the sampled
            # in-flight count exactly where the device starved
            out.append({
                "ph": "C",
                "name": f"in_flight_dispatches:{ev.get('pipeline', '?')}",
                "pid": pid, "tid": 0,
                "ts": round((ev["ts"] - base) * 1e6, 1),
                "args": {"in_flight": ev.get("in_flight", 0)},
            })
        elif kind == "resource_sample":
            # one "resources" counter track per process: HBM usage and
            # headroom (device samples) or RSS (host fallback) ride as
            # Perfetto counters alongside the dispatch occupancy
            args = {
                k: ev[k]
                for k in ("hbm_used_bytes", "hbm_headroom_bytes", "rss_kb")
                if ev.get(k) is not None
            }
            if not args:
                continue
            out.append({
                "ph": "C", "name": "resources",
                "pid": pid, "tid": 0,
                "ts": round((ev["ts"] - base) * 1e6, 1),
                "args": args,
            })
        elif kind == "metrics":
            continue  # snapshots are bulky; JobMetrics folds them
        else:
            args = {
                k: v for k, v in ev.items()
                if k not in ("ts", "mono", "kind", "worker")
            }
            out.append({
                "ph": "i", "s": "t", "name": str(kind),
                "pid": pid, "tid": tid_of(pid, "events"),
                "ts": round((ev["ts"] - base) * 1e6, 1),
                "args": args,
            })
    # metadata first, then time order — stable for golden tests
    out.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0)))
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {"title": title},
    }


def write_chrome_trace(
    events: Iterable[Dict[str, Any]], path: str,
    title: str = "dryad_tpu job",
) -> Dict[str, Any]:
    trace = chrome_trace(events, title=title)
    with open(path, "w") as fh:
        json.dump(trace, fh)
    return trace
