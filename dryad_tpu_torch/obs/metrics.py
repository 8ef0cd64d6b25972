"""Counters, histograms, key-range histograms and the job-level
attribution snapshot (``MetricsRegistry``, ``KeyRangeHistogram`` and
``JobMetrics`` of ``dryad_tpu/obs/metrics.py``).

- :class:`MetricsRegistry`: thread-safe labeled counters and
  histograms (spill bytes, transfer bytes, per-piece rows).  A
  histogram keeps count/sum/min/max and power-of-two bucket counts, so
  per-partition row samples double as skew histograms;
  ``emit(events)`` writes one ``metrics`` event.
- :class:`KeyRangeHistogram`: per hash-derived key range, a row count
  and a HyperLogLog-style distinct estimate; the combine tree places
  partials by the counts and degrades ranges by the estimates.
- :class:`JobMetrics`: where the time and bytes went, folded from any
  event stream: leaf span time by category, dispatches (one per
  ``stage_start``), the dispatch windows, the combine tree, and the
  serving tier's admission, cache and view counters with their
  per-tenant folds.  The reference's compile, gang, coded-redundancy,
  exchange-round and rewrite fields have no events in the port and
  are left out.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Iterable, Tuple

import numpy as np

__all__ = ["MetricsRegistry", "KeyRangeHistogram", "JobMetrics"]


def _labels_key(labels: Dict[str, Any]) -> Tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Hist:
    __slots__ = ("n", "sum", "min", "max", "buckets")

    def __init__(self):
        self.n = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.buckets: Dict[int, int] = {}  # pow2 exponent -> count

    def observe(self, v: float) -> None:
        self.n += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        b = max(0, int(v).bit_length()) if v >= 1 else 0
        self.buckets[b] = self.buckets.get(b, 0) + 1

    def as_dict(self) -> Dict[str, Any]:
        return {
            "n": self.n, "sum": round(self.sum, 6),
            "min": self.min if self.n else 0,
            "max": self.max if self.n else 0,
            # skew signal without shipping raw samples: pow2 buckets
            "buckets": {str(k): v for k, v in sorted(self.buckets.items())},
        }


class MetricsRegistry:
    """Thread-safe labeled counters + histograms.

    ``add`` accumulates a counter; ``observe`` feeds a histogram (one
    sample per call — per-partition rows, per-piece bytes).  A
    ``snapshot()`` is JSON-ready and ``emit(events)`` serializes it as
    ONE ``metrics`` event so snapshots ride the same stream jobview
    and the gang-telemetry path already carry.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Tuple], float] = {}
        self._hists: Dict[Tuple[str, Tuple], _Hist] = {}

    def add(self, name: str, value: float = 1.0, **labels: Any) -> None:
        key = (name, _labels_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def observe(self, name: str, value: float, **labels: Any) -> None:
        key = (name, _labels_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Hist()
            h.observe(value)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counters = [
                {"name": n, "labels": dict(lk), "value": round(v, 6)}
                for (n, lk), v in sorted(self._counters.items())
            ]
            hists = [
                {"name": n, "labels": dict(lk), **h.as_dict()}
                for (n, lk), h in sorted(self._hists.items())
            ]
        return {"counters": counters, "hists": hists}

    def emit(self, events) -> None:
        """Serialize the registry into the event stream (one
        ``metrics`` event holding the whole snapshot)."""
        if events is not None:
            events.emit("metrics", **self.snapshot())


# -- coarse per-key-range distribution histogram -----------------------------

# HLL-style registers per key range: enough for a reduction-worthiness
# estimate (does this range's key set recur across chunks?), tiny enough
# that a snapshot is a plain numpy pair the planner can read per chunk.
_KR_REGISTERS = 32
_KR_ALPHA = 0.697  # standard HyperLogLog bias constant for m=32


class KeyRangeHistogram:
    """Coarse per-key-range distribution of a keyed stream.

    Extends the per-partition skew histograms (pow2-bucket ``_Hist``)
    with the signal distribution-aware combine scheduling needs
    (PAPERS.md "Chasing Similarity"): ``ranges`` hash-derived key
    ranges, each carrying a row count (the placement/similarity vector)
    and an HLL-style distinct-key estimate (the per-range degrade
    signal — a range whose distinct estimate tracks its row count never
    reduces under merging, so device combining cannot pay for it).

    Feeds on PRE-computed 64-bit key hashes (the driver hashes raw host
    chunks before ingest); the tree planner reads :meth:`snapshot`
    dicts only, never raw tables.
    """

    __slots__ = ("ranges", "counts", "registers", "rows")

    def __init__(self, ranges: int = 64):
        if ranges < 2 or ranges & (ranges - 1):
            raise ValueError("ranges must be a power of two >= 2")
        self.ranges = ranges
        self.counts = np.zeros(ranges, np.int64)
        # per-(range, register) max leading-zero rank
        self.registers = np.zeros(ranges * _KR_REGISTERS, np.uint8)
        self.rows = 0

    @staticmethod
    def range_ids(hashes: np.ndarray, ranges: int) -> np.ndarray:
        """Key hash -> range id; the SAME derivation the degrade split
        uses, so a degraded range's rows route consistently."""
        h = hashes.astype(np.uint64, copy=False)
        return ((h >> np.uint64(33)) % np.uint64(ranges)).astype(np.int64)

    def observe(self, hashes: np.ndarray) -> None:
        """Fold one chunk's key hashes (uint64, one per row)."""
        if len(hashes) == 0:
            return
        h = hashes.astype(np.uint64, copy=False)
        rid = self.range_ids(h, self.ranges)
        self.counts += np.bincount(rid, minlength=self.ranges)
        self.rows += len(h)
        reg = (h & np.uint64(_KR_REGISTERS - 1)).astype(np.int64)
        w = (h >> np.uint64(5)).astype(np.uint64)
        # rank = leading-zero count of the 59-bit remainder + 1; the
        # float64 exponent gives bit_length (exact for rank purposes)
        bl = np.zeros(len(w), np.int64)
        nz = w > 0
        bl[nz] = np.frexp(w[nz].astype(np.float64))[1]
        rank = np.clip(60 - bl, 1, 60).astype(np.uint8)
        np.maximum.at(self.registers, rid * _KR_REGISTERS + reg, rank)

    def merge(self, other: "KeyRangeHistogram") -> None:
        if other.ranges != self.ranges:
            raise ValueError("key-range histogram resolution mismatch")
        self.counts += other.counts
        self.rows += other.rows
        np.maximum(self.registers, other.registers, out=self.registers)

    def distinct_estimates(self) -> np.ndarray:
        """Per-range distinct-key estimates (float64)."""
        m = _KR_REGISTERS
        regs = self.registers.reshape(self.ranges, m).astype(np.float64)
        est = _KR_ALPHA * m * m / np.sum(np.exp2(-regs), axis=1)
        # small-range correction: linear counting on empty registers
        zeros = np.sum(regs == 0, axis=1)
        small = (est <= 2.5 * m) & (zeros > 0)
        with np.errstate(divide="ignore"):
            lc = m * np.log(np.where(zeros > 0, m / np.maximum(zeros, 1), 1))
        est = np.where(small, lc, est)
        return np.minimum(est, self.counts.astype(np.float64))

    def snapshot(self) -> Dict[str, Any]:
        """Plain-data view: per-range row counts (the similarity /
        placement vector) and distinct-ratio estimates (the degrade
        signal).  This dict — not the histogram, not any table — is
        what combine-tree placement is allowed to read."""
        counts = self.counts
        est = self.distinct_estimates()
        with np.errstate(invalid="ignore"):
            ratios = np.where(counts > 0, est / np.maximum(counts, 1), 0.0)
        return {
            "ranges": self.ranges,
            "rows": int(self.rows),
            "counts": counts.copy(),
            "distinct": est,
            "reduction_ratios": ratios,
        }


# -- job-level attribution snapshot -----------------------------------------

# span categories that count as LEAF time (mutually exclusive regions);
# structural cats (chunk, driver) group spans and must not double-count
_LEAF_CATS = {
    "execute": "execute_s",
    "prefetch": "ingest_s",
    "spill": "spill_write_s",
    "checkpoint": "checkpoint_s",
}


@dataclasses.dataclass
class JobMetrics:
    """Where the time (and bytes) went, foldable from any event stream.

    Seconds: ``execute_s`` (stage attempts, ``span`` cat=execute),
    ``ingest_s`` / ``spill_write_s`` / ``checkpoint_s`` (background
    prefetch pulls, spill piece writes, checkpoint I/O), and the
    stream pipeline's ``ingest_stall_s`` (the driver waiting on the
    prefetch thread) and ``compute_stall_s`` (the reverse).  Counts:
    ``dispatch_count`` (one per ``stage_start``: a cache hit adds
    none), fused-region dispatches, the dispatch windows, the combine
    tree, and the serving tier's admission, result-cache and view
    counters with a per-tenant fold in ``tenants``, and the runtime
    plan rewriter's decided and applied ``plan_rewrite`` events.
    """

    execute_s: float = 0.0
    ingest_s: float = 0.0
    ingest_stall_s: float = 0.0
    compute_stall_s: float = 0.0
    spill_write_s: float = 0.0
    checkpoint_s: float = 0.0
    spill_bytes: int = 0
    spill_rows: int = 0
    d2h_bytes: int = 0
    h2d_bytes: int = 0
    layout_rows: int = 0
    valid_rows: int = 0
    rows_in: int = 0
    rows_out: int = 0
    spans: int = 0
    dispatch_count: int = 0
    fused_dispatches: int = 0
    fused_member_stages: int = 0
    dcn_bytes: int = 0
    ici_bytes: int = 0
    tree_combines: int = 0
    tree_depth: int = 0
    degraded_ranges: int = 0
    degraded_fraction: float = 0.0
    dispatch_windows: int = 0
    window_dispatches: int = 0
    dispatch_gap_s: float = 0.0
    dispatch_retries: int = 0
    driver_cpu_s: float = 0.0
    driver_wall_s: float = 0.0
    # serving tier: service-level totals plus tenant -> counter dict
    # (admitted/completed/rejected/cache_hits/failed/seconds and the
    # latest quota_state)
    queries_admitted: int = 0
    queries_completed: int = 0
    queries_rejected: int = 0
    result_cache_hits: int = 0
    tenants: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    # materialized views: registrations vs refusals, delta-fold volume,
    # and how reads resolved (fresh: zero dispatches; finalized: one)
    views_registered: int = 0
    view_fallbacks: int = 0
    view_deltas: int = 0
    view_delta_rows: int = 0
    view_delta_bytes: int = 0
    view_snapshots_fresh: int = 0
    view_snapshots_finalized: int = 0
    # runtime plan rewriting (rewrite/controller.py): decisions folded
    # from the diagnosis stream against those a driver honored at a
    # safe point, and the decided count of each action
    rewrites_decided: int = 0
    rewrites_applied: int = 0
    rewrite_actions: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def driver_cpu_fraction(self) -> float:
        """Driver-thread CPU seconds per wall second across dispatch
        windows (0 without window summaries)."""
        if self.driver_wall_s <= 0:
            return 0.0
        return min(1.0, self.driver_cpu_s / self.driver_wall_s)

    @property
    def padding_waste(self) -> float:
        """Fraction of device layout rows that were padding."""
        if self.layout_rows <= 0:
            return 0.0
        return max(0.0, 1.0 - self.valid_rows / self.layout_rows)

    def _tenant(self, ev: Dict[str, Any]) -> Dict[str, Any]:
        """The per-tenant record of an event's tenant, made on first
        contact."""
        t = self.tenants.get(ev.get("tenant", "?"))
        if t is None:
            t = self.tenants[ev.get("tenant", "?")] = {
                "admitted": 0, "completed": 0, "rejected": 0,
                "cache_hits": 0, "failed": 0, "seconds": 0.0,
                "quota_state": "ok",
            }
        return t

    # counters of ``metrics`` snapshot events folded into the fields above
    _COUNTER_FIELDS = {
        "d2h_bytes": "d2h_bytes",
        "h2d_bytes": "h2d_bytes",
        "layout_rows": "layout_rows",
        "valid_rows": "valid_rows",
        "rows_in": "rows_in",
        "rows_out": "rows_out",
        "spill_bytes": "spill_bytes",
    }

    @classmethod
    def from_events(cls, events: Iterable[Dict[str, Any]]) -> "JobMetrics":
        """Fold an event stream (live or loaded) into one snapshot.
        ``metrics`` events are cumulative per registry, so only the last
        value of each counter contributes."""
        m = cls()
        last_counter: Dict[str, float] = {}
        for ev in events:
            kind = ev.get("kind")
            if kind == "span":
                m.spans += 1
                field = _LEAF_CATS.get(ev.get("cat"))
                if field is not None:
                    setattr(m, field, getattr(m, field) + ev.get("dur", 0.0))
                if ev.get("cat") == "spill":
                    m.spill_bytes += int(ev.get("bytes", 0) or 0)
            elif kind == "stage_start":
                m.dispatch_count += 1
            elif kind == "fused_dispatch":
                m.fused_dispatches += 1
                m.fused_member_stages += int(ev.get("members", 0) or 0)
            elif kind == "stream_pipeline":
                m.ingest_stall_s += ev.get("consumer_wait_s", 0.0)
                m.compute_stall_s += ev.get("producer_wait_s", 0.0)
            elif kind == "stream_spill":
                m.spill_rows += int(ev.get("rows", 0) or 0)
            elif kind == "stream_combine":
                m.dcn_bytes += int(ev.get("dcn_bytes", 0) or 0)
                m.ici_bytes += int(ev.get("ici_bytes", 0) or 0)
            elif kind == "stream_chunk":
                m.rows_in += int(ev.get("rows", 0) or 0)
            elif kind == "combine_tree_level":
                m.tree_combines += 1
                m.tree_depth = max(m.tree_depth, int(ev.get("level", 0)) + 1)
                m.dcn_bytes += int(ev.get("dcn_bytes", 0) or 0)
                m.ici_bytes += int(ev.get("ici_bytes", 0) or 0)
            elif kind == "combine_tree_degrade":
                m.degraded_ranges = max(m.degraded_ranges, int(ev.get("degraded", 0) or 0))
                m.degraded_fraction = max(
                    m.degraded_fraction, float(ev.get("fraction", 0.0) or 0.0)
                )
            elif kind == "dispatch_window":
                # the close-time summary carries the window's cumulative
                # gap_s: only the summary is folded
                m.dispatch_windows += 1
                m.window_dispatches += int(ev.get("dispatches", 0) or 0)
                m.dispatch_gap_s += float(ev.get("gap_s", 0.0) or 0.0)
                m.dispatch_retries += int(ev.get("retries", 0) or 0)
                m.driver_cpu_s += float(ev.get("driver_cpu_s", 0.0) or 0.0)
                m.driver_wall_s += float(ev.get("wall_s", 0.0) or 0.0)
            elif kind == "query_admitted":
                m.queries_admitted += 1
                m._tenant(ev)["admitted"] += 1
            elif kind == "query_rejected":
                m.queries_rejected += 1
                m._tenant(ev)["rejected"] += 1
            elif kind == "query_complete":
                m.queries_completed += 1
                t = m._tenant(ev)
                t["completed"] += 1
                t["seconds"] += float(ev.get("seconds", 0.0) or 0.0)
                if not ev.get("ok", True):
                    t["failed"] += 1
            elif kind == "result_cache_hit":
                m.result_cache_hits += 1
                m._tenant(ev)["cache_hits"] += 1
            elif kind == "tenant_quota":
                # state transitions: the last one is the live state
                m._tenant(ev)["quota_state"] = ev.get("state", "ok")
            elif kind == "view_register":
                m.views_registered += 1
            elif kind == "view_fallback":
                m.view_fallbacks += 1
            elif kind == "view_delta":
                m.view_deltas += 1
                m.view_delta_rows += int(ev.get("rows", 0) or 0)
                m.view_delta_bytes += int(ev.get("bytes", 0) or 0)
            elif kind == "view_snapshot":
                if ev.get("fresh"):
                    m.view_snapshots_fresh += 1
                else:
                    m.view_snapshots_finalized += 1
            elif kind == "plan_rewrite":
                if ev.get("phase") == "applied":
                    m.rewrites_applied += 1
                else:
                    m.rewrites_decided += 1
                    act = str(ev.get("action", "?"))
                    m.rewrite_actions[act] = m.rewrite_actions.get(act, 0) + 1
            elif kind == "metrics":
                for c in ev.get("counters", []):
                    name = c.get("name")
                    if name in cls._COUNTER_FIELDS:
                        last_counter[name] = c.get("value", 0.0)
        for name, v in last_counter.items():
            field = cls._COUNTER_FIELDS[name]
            setattr(m, field, getattr(m, field) + int(v))
        return m
