"""Blackbox merge CLI — multi-process crash-dump forensics (a copy of
``dryad_tpu/tools/blackbox.py``).

``obs.flightrec`` leaves one ``blackbox-<pid>.json`` per dying
process (driver AND gang workers).  This tool reassembles them into
ONE clock-corrected timeline of the last N seconds before the fatal
event — the JobBrowser-style post-mortem, except built from rings
that survived the crash instead of telemetry that reached the driver.

Clock correction reuses the gang offset model (``obs.gang``): the
driver's recorder embeds its per-worker minimum-RTT offsets
(``worker_offsets`` info, fed from the telemetry drain), and each
worker event's wall clock is shifted by its worker's offset before
merging — the same correction live telemetry gets, applied post-hoc.

Usage::

    python -m dryad_tpu_torch.tools.blackbox <dump-dir> [--window 30]
        [--trace out.json] [--json] [--diagnose]

``--trace`` exports the merged window as a Chrome/Perfetto trace via
``obs.trace``; ``--diagnose`` re-runs the online pathology folds
(``obs.diagnose.scan``) over the merged stream.
"""

from __future__ import annotations

import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional

__all__ = ["load_dumps", "merge", "render", "main"]

DEFAULT_WINDOW_S = 30.0


def load_dumps(path: str) -> List[Dict[str, Any]]:
    """Load every ``blackbox-*.json`` under *path* (a directory or a
    single dump file), skipping unreadable/partial files."""
    if os.path.isfile(path):
        candidates = [path]
    else:
        candidates = sorted(
            glob.glob(os.path.join(path, "**", "blackbox-*.json"),
                      recursive=True)
        )
    dumps = []
    for p in candidates:
        try:
            with open(p) as fh:
                d = json.load(fh)
        except (OSError, ValueError):
            continue
        d["_path"] = p
        dumps.append(d)
    return dumps


def _offsets(dumps: List[Dict[str, Any]]) -> Dict[int, float]:
    """Per-worker clock offsets from the driver dump's info block
    (missing workers fall back to offset 0 — uncorrected is better
    than dropped)."""
    out: Dict[int, float] = {}
    for d in dumps:
        raw = (d.get("info") or {}).get("worker_offsets") or {}
        for k, v in raw.items():
            try:
                if v is not None:
                    out[int(k)] = float(v)
            except (TypeError, ValueError):
                continue
    return out


def merge(
    dumps: List[Dict[str, Any]],
    window_s: Optional[float] = DEFAULT_WINDOW_S,
) -> Dict[str, Any]:
    """Merge per-process dumps into one clock-corrected timeline.

    Returns ``{"events", "sources", "fatal_ts", "window_s",
    "dropped", "snapshots"}`` — events sorted by corrected wall
    clock, trimmed to the last *window_s* seconds ending at the
    newest event (the fatal window); ``window_s=None`` keeps all."""
    offsets = _offsets(dumps)
    events: List[Dict[str, Any]] = []
    snapshots: List[Dict[str, Any]] = []
    sources = []
    dropped = 0
    for d in dumps:
        worker = d.get("worker")
        off = offsets.get(worker, 0.0) if worker is not None else 0.0
        sources.append({
            "path": d.get("_path"),
            "pid": d.get("pid"),
            "role": d.get("role"),
            "worker": worker,
            "reason": d.get("reason"),
            "events": len(d.get("events") or ()),
            "clock_offset": off,
        })
        dropped += int(d.get("dropped", 0) or 0)
        for ev in d.get("events") or ():
            ev = dict(ev)
            if "ts" in ev:
                ev["ts"] = ev["ts"] + off
            ev.setdefault(
                "worker", worker if worker is not None else None
            )
            if ev.get("worker") is None:
                ev.pop("worker")  # driver events carry no worker field
            ev["_role"] = d.get("role", "?")
            events.append(ev)
        for snap in d.get("snapshots") or ():
            snap = dict(snap)
            snap["ts"] = snap.get("ts", 0.0) + off
            snap["_role"] = d.get("role", "?")
            snapshots.append(snap)
    events.sort(key=lambda e: e.get("ts", 0.0))
    snapshots.sort(key=lambda s: s.get("ts", 0.0))
    fatal_ts = events[-1]["ts"] if events else None
    if window_s is not None and fatal_ts is not None:
        lo = fatal_ts - window_s
        events = [e for e in events if e.get("ts", 0.0) >= lo]
        snapshots = [s for s in snapshots if s.get("ts", 0.0) >= lo]
    return {
        "events": events,
        "sources": sources,
        "fatal_ts": fatal_ts,
        "window_s": window_s,
        "dropped": dropped,
        "snapshots": snapshots,
    }


_BRIEF_KEYS = (
    "stage", "name", "pipeline", "seq", "part", "coded", "bucket",
    "rule", "severity", "reason", "error", "seconds", "dur", "rows",
    "worker_kill", "dead", "trigger",
)


def _brief(ev: Dict[str, Any]) -> str:
    bits = []
    for k in _BRIEF_KEYS:
        if k in ev:
            v = ev[k]
            if isinstance(v, float):
                v = round(v, 4)
            bits.append(f"{k}={v}")
    return " ".join(bits)


def render(merged: Dict[str, Any]) -> str:
    """Human-readable last-N-seconds timeline."""
    lines = ["== blackbox merge =="]
    for s in merged["sources"]:
        lines.append(
            f"  {s['role']:<10} pid={s['pid']} "
            + (f"worker={s['worker']} " if s["worker"] is not None else "")
            + f"reason={s['reason']} events={s['events']} "
            f"clock_offset={s['clock_offset']:+.4f}s"
        )
    if merged["dropped"]:
        lines.append(
            f"  NOTE: {merged['dropped']} event(s) evicted from rings "
            "before the dump — the timeline is truncated, not idle"
        )
    fatal = merged["fatal_ts"]
    if fatal is None:
        lines.append("  (no events)")
        return "\n".join(lines)
    w = merged["window_s"]
    lines.append(
        f"-- timeline: last {w:.0f}s before the fatal event --"
        if w is not None else "-- full timeline --"
    )
    for ev in merged["events"]:
        rel = ev.get("ts", 0.0) - fatal
        src = (
            f"w{ev['worker']}" if "worker" in ev
            else ev.get("_role", "?")[:6]
        )
        lines.append(
            f"  {rel:+9.4f}s {src:<7} {ev.get('kind', '?'):<28} "
            f"{_brief(ev)}".rstrip()
        )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)

    def _flag_with_arg(name: str) -> Optional[str]:
        if name in args:
            i = args.index(name)
            args.pop(i)
            return args.pop(i)
        return None

    window: Optional[float] = float(
        _flag_with_arg("--window") or DEFAULT_WINDOW_S
    )
    if window <= 0:
        window = None
    trace_out = _flag_with_arg("--trace")
    as_json = "--json" in args
    if as_json:
        args.remove("--json")
    diagnose = "--diagnose" in args
    if diagnose:
        args.remove("--diagnose")
    if not args:
        print(
            "usage: python -m dryad_tpu_torch.tools.blackbox <dump-dir> "
            "[--window S] [--trace out.json] [--json] [--diagnose]",
            file=sys.stderr,
        )
        return 2
    dumps = load_dumps(args[0])
    if not dumps:
        print(f"no blackbox-*.json dumps under {args[0]}", file=sys.stderr)
        return 1
    merged = merge(dumps, window_s=window)
    if trace_out:
        from dryad_tpu_torch.obs.trace import write_chrome_trace

        write_chrome_trace(merged["events"], trace_out, title="blackbox")
        print(f"chrome trace -> {trace_out}", file=sys.stderr)
    if as_json:
        print(json.dumps(merged, default=str))
    else:
        print(render(merged))
    if diagnose:
        from dryad_tpu_torch.obs.diagnose import scan

        print("== diagnoses (offline scan) ==")
        found = scan(merged["events"])
        if not found:
            print("  none")
        for d in found:
            print(
                f"  [{d['severity']}] {d['rule']} ({d['subject']}): "
                f"{d['evidence']}"
            )
            print(f"      hint: {d['hint']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
