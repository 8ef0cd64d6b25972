"""Per-query critical-path attribution over the merged event stream
(a copy of ``dryad_tpu/obs/critpath.py``).

Given one query's qid-stamped events (driver spans, worker spans that
shipped back clock-offset-corrected on the telemetry channel, compile
records, exchange accounting, lifecycle events), fold the span DAG
into an attributed latency breakdown: every instant of the query's
admission->completion wall interval is charged to exactly ONE phase,
so the breakdown sums to the end-to-end latency by construction.

The fold is a line sweep, not a span-duration sum: spans overlap
(prefetch rides under execute, worker spans run concurrently with the
driver's), and summing durations would double-charge overlapped time.
At each elementary segment the attribution goes to the active interval
that is (a) deepest in the span hierarchy and (b) most specific by
phase priority — i.e. the work the query was actually waiting on.
Uncovered time before the first span is ``admission_wait`` (queueing
behind other tenants); uncovered time elsewhere is ``other`` (honest
residual, never silently redistributed).

Phases (:data:`PHASES`): admission_wait / cache_probe / compile /
ingest / dispatch / exchange / collective / readback / other.
Surfaces: ``QueryService.stats()["slo"]`` per-tenant phase totals, the
``-- critical path --`` panel of ``Query.explain(analyze=True)`` and
jobview's queries panel.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "PHASES", "QueryBreakdown", "fold_query", "fold_all",
    "format_queries", "query_ids",
]

# canonical phase order (also the display order)
PHASES: Tuple[str, ...] = (
    "admission_wait", "cache_probe", "compile", "ingest", "dispatch",
    "exchange", "collective", "readback", "other",
)

# span category -> phase (name-based overrides win, below)
_CAT_PHASE: Dict[str, str] = {
    "serve": "cache_probe",
    "compile": "compile",
    "prefetch": "ingest",
    "spill": "ingest",
    "execute": "dispatch",
    "chunk": "dispatch",
    "worker": "dispatch",
    "driver": "dispatch",
    "checkpoint": "other",
    "readback": "readback",
}

# specificity when intervals tie on span depth: a readback or compile
# blocks the query outright; generic dispatch is the least specific
# covered phase
_PRIORITY: Dict[str, int] = {
    "other": 0, "admission_wait": 0, "dispatch": 1, "ingest": 2,
    "cache_probe": 3, "exchange": 4, "collective": 5, "compile": 6,
    "readback": 7,
}

_LIFECYCLE = ("query_admitted", "query_complete", "result_cache_hit")


def _phase_of(name: str, cat: str) -> str:
    n = name or ""
    if "exchange" in n:
        return "exchange"
    if n.startswith(("combine", "merge", "assemble")):
        return "collective"
    if n in ("fetch", "readback"):
        return "readback"
    if n == "cache_probe":
        return "cache_probe"
    if n.startswith(("ingest", "chunk_ingest")):
        return "ingest"
    return _CAT_PHASE.get(cat or "", "other")


class QueryBreakdown:
    """One query's attributed latency fold."""

    def __init__(self, qid: str):
        self.qid = qid
        self.tenant: Optional[str] = None
        self.total_s = 0.0  # swept wall interval (sum of phases)
        self.measured_s: Optional[float] = None  # query_complete.seconds
        self.cached = False
        self.ok: Optional[bool] = None
        self.phases: Dict[str, float] = {}
        self.spans = 0
        self.workers: List[Any] = []  # worker indices seen in the trace
        self.xchg_rounds = 0
        self.xchg_bytes = 0
        self.dispatch_gap_s = 0.0
        self.diagnoses = 0

    def coverage(self) -> float:
        """Attributed (non-residual) fraction of the wall interval."""
        if self.total_s <= 0.0:
            return 1.0
        other = self.phases.get("other", 0.0) + self.phases.get(
            "admission_wait", 0.0
        )
        return max(0.0, (self.total_s - other)) / self.total_s

    def as_dict(self) -> Dict[str, Any]:
        return {
            "qid": self.qid,
            "tenant": self.tenant,
            "total_s": round(self.total_s, 6),
            "measured_s": self.measured_s,
            "cached": self.cached,
            "ok": self.ok,
            "phases": {
                p: round(self.phases[p], 6)
                for p in PHASES if self.phases.get(p, 0.0) > 0.0
            },
            "spans": self.spans,
            "workers": sorted(self.workers),
            "xchg_rounds": self.xchg_rounds,
            "xchg_bytes": self.xchg_bytes,
            "dispatch_gap_s": round(self.dispatch_gap_s, 6),
            "diagnoses": self.diagnoses,
        }

    def format(self) -> str:
        parts = []
        for p in PHASES:
            v = self.phases.get(p, 0.0)
            if v <= 0.0:
                continue
            pct = 100.0 * v / self.total_s if self.total_s > 0 else 0.0
            parts.append(f"{p} {v:.3f}s ({pct:.0f}%)")
        head = f"{self.qid}"
        if self.tenant:
            head += f" [{self.tenant}]"
        flags = []
        if self.cached:
            flags.append("cached")
        if self.ok is False:
            flags.append("FAILED")
        if self.workers:
            flags.append(f"workers={len(self.workers)}")
        tail = f"  ({', '.join(flags)})" if flags else ""
        return (
            f"{head}  total={self.total_s:.3f}s  "
            + ("  ".join(parts) if parts else "no attributed spans")
            + tail
        )


def _query_events(
    events: Iterable[Dict[str, Any]], qid: str
) -> List[Dict[str, Any]]:
    out = []
    for ev in events:
        if ev.get("qid") == qid or (
            ev.get("kind") in _LIFECYCLE and ev.get("query") == qid
        ):
            out.append(ev)
    return out


def query_ids(events: Iterable[Dict[str, Any]]) -> List[str]:
    """Every qid in the stream, in order of first appearance."""
    seen: Dict[str, bool] = {}
    for ev in events:
        q = ev.get("qid")
        if q is None and ev.get("kind") in _LIFECYCLE:
            q = ev.get("query")
        if q is not None and q not in seen:
            seen[q] = True
    return list(seen)


def fold_query(
    events: Iterable[Dict[str, Any]], qid: str
) -> Optional[QueryBreakdown]:
    """Fold one query's breakdown out of a (merged) event stream;
    None when the stream holds nothing for ``qid``."""
    evs = _query_events(events, qid)
    if not evs:
        return None
    bd = QueryBreakdown(qid)
    # (start, end, depth, priority, phase) wall intervals to sweep
    intervals: List[Tuple[float, float, int, int, str]] = []
    parents: Dict[Any, Any] = {}
    span_ivs: List[Tuple[Any, float, float, str]] = []
    t_admit: Optional[float] = None
    t_done: Optional[float] = None
    for ev in evs:
        kind = ev.get("kind")
        ts = float(ev.get("ts", 0.0) or 0.0)
        if kind == "span":
            dur = float(ev.get("dur", 0.0) or 0.0)
            phase = _phase_of(
                str(ev.get("name", "")), str(ev.get("cat", ""))
            )
            parents[ev.get("span_id")] = ev.get("parent_id")
            span_ivs.append((ev.get("span_id"), ts - dur, ts, phase))
            bd.spans += 1
            if ev.get("worker") is not None and (
                ev["worker"] not in bd.workers
            ):
                bd.workers.append(ev["worker"])
        elif kind == "xla_compile":
            dur = float(ev.get("compile_s", 0.0) or 0.0) + float(
                ev.get("trace_s", 0.0) or 0.0
            )
            # compile blocks the driver: deepest-possible interval
            intervals.append((ts - dur, ts, 1 << 20,
                              _PRIORITY["compile"], "compile"))
        elif kind == "exchange_round":
            bd.xchg_rounds += 1
            bd.xchg_bytes += int(ev.get("bytes", 0) or 0)
        elif kind == "dispatch_gap":
            bd.dispatch_gap_s += float(ev.get("gap_s", 0.0) or 0.0)
        elif kind == "diagnosis":
            bd.diagnoses += 1
        elif kind == "query_admitted":
            t_admit = ts
            bd.tenant = ev.get("tenant")
        elif kind == "result_cache_hit":
            bd.cached = True
        elif kind == "query_complete":
            t_done = ts
            bd.tenant = ev.get("tenant") or bd.tenant
            bd.measured_s = ev.get("seconds")
            bd.ok = ev.get("ok")
            bd.cached = bool(ev.get("cached")) or bd.cached

    # span depth within this query's own hierarchy (cross-process
    # parents that never shipped fall off the chain harmlessly)
    def depth_of(sid: Any) -> int:
        d = 0
        seen = set()
        while sid in parents and sid not in seen:
            seen.add(sid)
            sid = parents[sid]
            d += 1
        return d

    for sid, s, e, phase in span_ivs:
        intervals.append((s, e, depth_of(sid), _PRIORITY[phase], phase))

    if not intervals and t_admit is None and t_done is None:
        return bd  # qid seen, but nothing sweepable
    starts = [iv[0] for iv in intervals]
    ends = [iv[1] for iv in intervals]
    t0 = t_admit if t_admit is not None else (min(starts) if starts else t_done)
    t1 = t_done if t_done is not None else (max(ends) if ends else t_admit)
    if t0 is None or t1 is None or t1 <= t0:
        return bd
    first_start = min(starts) if starts else t1
    bounds = sorted(
        {t0, t1}
        | {min(max(s, t0), t1) for s in starts}
        | {min(max(e, t0), t1) for e in ends}
    )
    phases: Dict[str, float] = {}
    for a, b in zip(bounds, bounds[1:]):
        if b <= a:
            continue
        best: Optional[Tuple[int, int, str]] = None
        for s, e, d, pr, ph in intervals:
            if s < b and e > a:  # overlaps (a, b)
                cand = (d, pr, ph)
                if best is None or cand[:2] > best[:2]:
                    best = cand
        if best is not None:
            ph = best[2]
        elif t_admit is not None and b <= first_start:
            ph = "admission_wait"
        else:
            ph = "other"
        phases[ph] = phases.get(ph, 0.0) + (b - a)
    bd.phases = phases
    bd.total_s = t1 - t0
    return bd


def fold_all(
    events: Iterable[Dict[str, Any]]
) -> "Dict[str, QueryBreakdown]":
    """Breakdown per qid, in order of first appearance."""
    evs = list(events)
    out: Dict[str, QueryBreakdown] = {}
    for qid in query_ids(evs):
        bd = fold_query(evs, qid)
        if bd is not None:
            out[qid] = bd
    return out


def format_queries(breakdowns: "Dict[str, QueryBreakdown]") -> str:
    """The jobview ``-- queries --`` panel body."""
    if not breakdowns:
        return "no query-scoped events"
    return "\n".join(bd.format() for bd in breakdowns.values())
