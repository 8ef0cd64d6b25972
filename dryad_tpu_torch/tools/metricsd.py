"""metricsd — scrape dryad_tpu event logs into one Prometheus/JSON view
(a copy of ``dryad_tpu/tools/metricsd.py``; either package's logs).

The continuous telemetry plane (``obs.telemetry``) keeps its rolling
SLO state inside the resident process; this CLI is the OUT-of-process
export surface: it folds JSONL event logs (the Calypso-style stream a
running service writes via ``config.event_log_dir``) through the SAME
:class:`~dryad_tpu_torch.obs.telemetry.RollingStore` the live plane uses, so
a scrape shows exactly what the service would report — per-tenant
query counters, admission→completion latency p50/p95/p99, per-query
critical-path phase seconds, and the latest resource gauges — in
Prometheus text exposition or a JSON snapshot.

**Fleet aggregation**: pass several inputs and metricsd merges them
into one fleet view.  ``*.jsonl`` inputs are event logs (all folded
into one shared store — summed observations ARE the merged
histogram); ``*.json`` inputs are RollingStore snapshots exported by
OTHER processes (their ``--json-out`` sinks), merged loss-lessly via
the raw pow2 ``buckets`` each latency entry carries: counters sum,
gauges sum (fleet totals), histograms merge bucket-for-bucket and the
fleet p50/p95/p99 re-derive through the same
:func:`~dryad_tpu_torch.obs.telemetry.quantiles_from_hist` fold the live
plane uses.  Merging the percentile readouts themselves would not
commute; merging buckets does.

Usage::

    python -m dryad_tpu_torch.tools.metricsd events.jsonl [more.jsonl ...]
        [proc2-snapshot.json ...]
        [--json] [--prom out.prom] [--json-out out.json]
        [--window S] [--follow --interval S]

One-shot (default) folds the whole log into one window and prints
Prometheus text (``--json`` prints the JSON snapshot instead).
``--prom`` / ``--json-out`` write file sinks (atomic tmp+rename, so a
scraper never reads a torn file).  ``--follow`` keeps the process
resident: it tails each log from its last byte offset every
``--interval`` seconds — surviving log rotation (see
:class:`LogCursor`) — re-reads snapshot inputs wholesale, and
rewrites the sinks: the "periodic file sink" deployment, one step
short of an HTTP endpoint.

Inputs may be shell-style GLOBS (quote them past your shell):
``'fleet/*.jsonl'`` scrapes every replica's event log with its own
:class:`LogCursor`, and in ``--follow`` mode the pattern re-expands
every interval — a replica that starts (or respawns after a chaos
kill) AFTER metricsd is picked up on the next tick, no restart.
"""

from __future__ import annotations

import glob as globlib
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from dryad_tpu_torch.obs import critpath
from dryad_tpu_torch.obs.telemetry import (
    RollingStore,
    prometheus_text,
    quantiles_from_hist,
)

__all__ = [
    "CursorSet", "LogCursor", "expand_inputs", "fold_events",
    "fold_query_phases", "load_events", "merge_snapshots", "main",
]

# one-shot folds have no live clock: make the window wide enough that
# every event in the log lands in the readout
ONESHOT_WINDOW_S = 1e9


def load_events(
    path: str, offset: int = 0
) -> Tuple[List[Dict[str, Any]], int]:
    """Read JSONL events from ``path`` starting at byte ``offset``;
    returns (events, new_offset).  A torn final line (mid-write by the
    producer) is left for the next poll."""
    out: List[Dict[str, Any]] = []
    try:
        with open(path, "rb") as fh:
            fh.seek(offset)
            data = fh.read()
    except OSError:
        return out, offset
    end = data.rfind(b"\n")
    if end < 0:
        return out, offset
    for line in data[: end + 1].splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except ValueError:
            continue
    return out, offset + end + 1


class LogCursor:
    """Byte-offset tail over a possibly-rotating JSONL log.

    A bare ``load_events(path, offset)`` loop silently goes blind when
    the producer rotates the file (new inode at the same path) or
    truncates it in place: the retained offset points past the end of
    the fresh file, ``rfind`` sees no newline, and every subsequent
    poll returns nothing.  The cursor stats the path each poll and
    restarts from byte 0 on an inode change OR a size regression, so
    post-rotation events keep flowing."""

    def __init__(self, path: str):
        self.path = path
        self.offset = 0
        self._ino: Optional[int] = None

    def poll(self) -> List[Dict[str, Any]]:
        """New complete events since the last poll (empty on a missing
        file — the producer may not have started yet)."""
        try:
            st = os.stat(self.path)
        except OSError:
            return []
        if (
            self._ino is not None and st.st_ino != self._ino
        ) or st.st_size < self.offset:
            self.offset = 0
        self._ino = st.st_ino
        events, self.offset = load_events(self.path, self.offset)
        return events


def expand_inputs(patterns: List[str]) -> List[str]:
    """Expand shell-style globs in *patterns* (sorted, deduped; a
    literal path passes through even when it doesn't exist yet, so a
    one-shot scrape of a missing file still errors loudly)."""
    out: List[str] = []
    seen = set()
    for pat in patterns:
        matched = (
            sorted(globlib.glob(pat))
            if globlib.has_magic(pat)
            else [pat]
        )
        for p in matched:
            if p not in seen:
                seen.add(p)
                out.append(p)
    return out


class CursorSet:
    """Per-path :class:`LogCursor` pool over glob patterns.

    ``poll()`` re-expands every pattern and tails each matched file
    from ITS OWN byte offset — so ``'fleet/*.jsonl'`` keeps working as
    replicas come and go: a log that appears after the first poll gets
    a fresh cursor (read from byte 0), an existing one never re-reads
    what it already folded."""

    def __init__(self, patterns: List[str]):
        self.patterns = list(patterns)
        self._cursors: Dict[str, LogCursor] = {}

    def paths(self) -> List[str]:
        return sorted(self._cursors)

    def poll(self) -> List[Dict[str, Any]]:
        events: List[Dict[str, Any]] = []
        for path in expand_inputs(self.patterns):
            cur = self._cursors.get(path)
            if cur is None:
                cur = self._cursors[path] = LogCursor(path)
            events.extend(cur.poll())
        return events


def fold_events(
    events: List[Dict[str, Any]], store: Optional[RollingStore] = None
) -> RollingStore:
    """Fold serve/telemetry events into a RollingStore — the same
    metric names, labels, and pow2 latency buckets the live plane
    emits, so offline scrapes and in-process readouts agree."""
    if store is None:
        store = RollingStore(window_s=ONESHOT_WINDOW_S)
    for ev in events:
        kind = ev.get("kind")
        tenant = str(ev.get("tenant", "?"))
        if kind == "query_admitted":
            store.incr("queries_admitted", tenant=tenant)
        elif kind == "query_rejected":
            store.incr("queries_rejected", tenant=tenant)
        elif kind == "result_cache_hit":
            store.incr("result_cache_hits", tenant=tenant)
        elif kind == "query_complete":
            store.incr("queries_completed", tenant=tenant)
            if "seconds" in ev:
                store.observe_latency(
                    "query_latency_s", float(ev["seconds"]), tenant=tenant
                )
        elif kind == "resource_sample":
            # literal metric names only: the graftlint metric-key rule
            # cross-references every call site against METRIC_KEYS
            if ev.get("hbm_used_bytes") is not None:
                store.set_gauge("hbm_used_bytes", int(ev["hbm_used_bytes"]))
            if ev.get("hbm_limit_bytes") is not None:
                store.set_gauge(
                    "hbm_limit_bytes", int(ev["hbm_limit_bytes"])
                )
            if ev.get("hbm_headroom_bytes") is not None:
                store.set_gauge(
                    "hbm_headroom_bytes", int(ev["hbm_headroom_bytes"])
                )
            if ev.get("rss_kb") is not None:
                store.set_gauge("host_rss_kb", int(ev["rss_kb"]))
            probes = ev.get("probes") or {}
            q = probes.get("serve:queue")
            if isinstance(q, dict) and "queued" in q:
                store.set_gauge("serve_queue_depth", int(q["queued"]))
    return store


def fold_query_phases(
    events: List[Dict[str, Any]], store: RollingStore
) -> None:
    """Offline twin of the serve-side critical-path fold: sweep each
    qid's span DAG (``obs.critpath``) and observe per-phase seconds —
    the same ``query_phase_s`` latency histogram the live
    ``QueryService`` feeds.  One-shot only: an incremental tail may
    split a query's events across polls and would under-attribute."""
    for bd in critpath.fold_all(events).values():
        tenant = str(bd.tenant or "?")
        for phase, secs in bd.phases.items():
            if secs > 0.0:
                store.observe_latency(
                    "query_phase_s", secs, tenant=tenant, phase=phase
                )


def _lkey(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def merge_snapshots(snaps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge several :meth:`RollingStore.snapshot` dicts into one
    fleet snapshot (same shape — ``prometheus_text`` renders it
    directly).  Counters and gauges sum per (name, labels); latency
    histograms merge their raw pow2 ``buckets`` bucket-for-bucket and
    the fleet quantiles re-derive through
    :func:`~dryad_tpu_torch.obs.telemetry.quantiles_from_hist` — the ONLY
    commutative fold (a p95-of-p95s is not a fleet p95).  Latency
    entries without ``buckets`` (pre-bucket exporters) merge their
    counts but cannot contribute to quantiles."""
    counters: Dict[Tuple, int] = {}
    gauges: Dict[Tuple, Any] = {}
    hists: Dict[Tuple, Dict[int, int]] = {}
    window = 0.0
    for snap in snaps:
        window = max(window, float(snap.get("window_s", 0.0) or 0.0))
        for rec in snap.get("counters", []):
            key = (rec["name"], _lkey(rec.get("labels", {})))
            counters[key] = counters.get(key, 0) + int(rec["total"])
        for rec in snap.get("gauges", []):
            key = (rec["name"], _lkey(rec.get("labels", {})))
            gauges[key] = gauges.get(key, 0) + rec["value"]
        for rec in snap.get("latencies", []):
            key = (rec["name"], _lkey(rec.get("labels", {})))
            merged = hists.setdefault(key, {})
            for e, n in (rec.get("buckets") or {}).items():
                e = int(e)
                merged[e] = merged.get(e, 0) + int(n)
    out: Dict[str, Any] = {
        "window_s": window,
        "processes": len(snaps),
        "counters": [
            {"name": name, "labels": dict(lk), "total": total}
            for (name, lk), total in sorted(counters.items())
        ],
        "gauges": [
            {"name": name, "labels": dict(lk), "value": v}
            for (name, lk), v in sorted(gauges.items())
        ],
        "latencies": [],
    }
    for (name, lk), merged in sorted(hists.items()):
        pct = quantiles_from_hist(merged)
        if pct is not None:
            out["latencies"].append(
                {
                    "name": name, "labels": dict(lk),
                    "buckets": {
                        str(e): n for e, n in sorted(merged.items())
                    },
                    **pct,
                }
            )
    return out


def _load_snapshot(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as fh:
            snap = json.load(fh)
    except (OSError, ValueError):
        return None
    return snap if isinstance(snap, dict) else None


def _write_atomic(path: str, text: str) -> None:
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        fh.write(text)
    os.replace(tmp, path)


def _emit(snapshot: Dict[str, Any], as_json: bool,
          prom_out: Optional[str], json_out: Optional[str]) -> None:
    if prom_out:
        _write_atomic(prom_out, prometheus_text(snapshot))
    if json_out:
        _write_atomic(json_out, json.dumps(snapshot, default=str))
    if not prom_out and not json_out:
        print(
            json.dumps(snapshot, default=str)
            if as_json else prometheus_text(snapshot)
        )


def _fleet_snapshot(
    store: RollingStore, snap_paths: List[str]
) -> Dict[str, Any]:
    """The emitted view: the local fold's snapshot merged with every
    readable remote snapshot (one store already holds ALL event-log
    inputs; ``.json`` peers merge on top)."""
    own = store.snapshot()
    if not snap_paths:
        return own
    snaps = [own]
    for p in snap_paths:
        snap = _load_snapshot(p)
        if snap is not None:
            snaps.append(snap)
    return merge_snapshots(snaps)


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)

    def _flag_with_arg(name: str) -> Optional[str]:
        if name in args:
            i = args.index(name)
            args.pop(i)
            return args.pop(i)
        return None

    window = float(_flag_with_arg("--window") or 0.0)
    interval = float(_flag_with_arg("--interval") or 2.0)
    prom_out = _flag_with_arg("--prom")
    json_out = _flag_with_arg("--json-out")
    as_json = "--json" in args
    if as_json:
        args.remove("--json")
    follow = "--follow" in args
    if follow:
        args.remove("--follow")
    if not args:
        print(
            "usage: python -m dryad_tpu_torch.tools.metricsd <events.jsonl> "
            "[more.jsonl ...] [peer-snapshot.json ...] "
            "[--json] [--prom out.prom] [--json-out out.json] "
            "[--window S] [--follow --interval S]",
            file=sys.stderr,
        )
        return 2
    # .json inputs are peer snapshots (another process's --json-out);
    # everything else is an event log to fold locally.  Either kind
    # may be a glob; follow mode re-expands each tick.
    snap_patterns = [p for p in args if p.endswith(".json")]
    log_patterns = [p for p in args if not p.endswith(".json")]
    if not follow:
        inputs = expand_inputs(args)
        missing = [p for p in inputs if not os.path.exists(p)]
        if missing:
            print(f"no input at {missing[0]}", file=sys.stderr)
            return 1
        store = RollingStore(window_s=window or ONESHOT_WINDOW_S)
        all_events: List[Dict[str, Any]] = []
        for p in expand_inputs(log_patterns):
            events, _ = load_events(p)
            all_events.extend(events)
        fold_events(all_events, store)
        fold_query_phases(all_events, store)
        _emit(
            _fleet_snapshot(store, expand_inputs(snap_patterns)),
            as_json, prom_out, json_out,
        )
        return 0
    # resident mode: a real rolling window over the live logs
    store = RollingStore(window_s=window or 60.0)
    cursors = CursorSet(log_patterns)
    try:
        while True:
            fold_events(cursors.poll(), store)
            _emit(
                _fleet_snapshot(store, expand_inputs(snap_patterns)),
                as_json, prom_out, json_out,
            )
            time.sleep(interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
