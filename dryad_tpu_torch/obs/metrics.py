"""Counters, histograms, key-range histograms and the job-level
attribution snapshot (a copy of ``dryad_tpu/obs/metrics.py``).

- :class:`MetricsRegistry`: thread-safe labeled counters and
  histograms (spill bytes, transfer bytes, per-piece rows).  A
  histogram keeps count/sum/min/max and power-of-two bucket counts, so
  per-partition row samples double as skew histograms;
  ``emit(events)`` writes one ``metrics`` event.
- :class:`KeyRangeHistogram`: per hash-derived key range, a row count
  and a HyperLogLog-style distinct estimate; the combine tree places
  partials by the counts and degrades ranges by the estimates.
- :class:`JobMetrics`: where the time and bytes went, folded from any
  event stream, either package's: leaf span time by category,
  dispatches (one per ``stage_start``), the dispatch windows, the
  combine tree, retries and quarantines, the coded k-of-n launches and
  reconstructions (``cluster/localjob.py``), the worker-side partial
  merges, the serving tier's admission, cache and view counters with
  their per-tenant folds, and the plan rewriter's decisions.  The port
  has no compile step and emits no ``xla_compile``, so ``compile_s``
  and ``compile_count`` stay 0 on its logs; they and the exchange and
  command-batch fields stay in the snapshot, so the panels keep the
  reference's layout and read a reference log as the reference does.
  :func:`format_attribution` renders the text lines jobview prints.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Iterable, List, Tuple

import numpy as np

__all__ = ["MetricsRegistry", "KeyRangeHistogram", "JobMetrics", "format_attribution"]


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

    def counter(self, name: str, **labels: Any) -> float:
        """Current value of one counter (0.0 when never touched)."""
        with self._lock:
            return self._counters.get((name, _labels_key(labels)), 0.0)

    def total(self, name: str) -> float:
        """Sum of one counter across ALL label sets."""
        with self._lock:
            return sum(
                v for (n, _l), v in self._counters.items() if n == name
            )

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
# structural cats (chunk, bucket, driver, worker, gang) group the
# Perfetto view but contain leaf spans and must not double-count
_LEAF_CATS = {
    "compile": "compile_s",
    "execute": "execute_s",
    "prefetch": "ingest_s",
    "spill": "spill_write_s",
    "checkpoint": "checkpoint_s",
}


@dataclasses.dataclass
class JobMetrics:
    """Where the time (and bytes) went — the programmatic snapshot the
    acceptance criteria name, foldable from any event stream.

    Time attribution (seconds):
    - ``compile_s``/``compile_count``: XLA trace+compile per lowering
      key (``xla_compile`` events, which only the reference emits: 0
      on the port's logs);
    - ``execute_s``: engine stage attempts (``span`` cat=execute);
    - ``ingest_stall_s``: driver blocked waiting on the prefetch
      thread (``stream_pipeline`` consumer_wait_s);
    - ``compute_stall_s``: prefetch thread blocked waiting on the
      driver (``stream_pipeline`` producer_wait_s);
    - ``ingest_s``/``spill_write_s``/``checkpoint_s``: background
      thread time (prefetch pulls, spill piece writes, checkpoint IO).

    Byte/row accounting: spill bytes, D2H/H2D transfer bytes, layout
    vs valid rows (``padding_waste`` = fraction of layout rows that
    were padding), retry/quarantine counts.
    """

    compile_count: int = 0
    compile_s: float = 0.0
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
    retries: int = 0
    quarantines: int = 0
    workers: int = 0  # distinct workers whose telemetry was merged
    spans: int = 0
    # whole-DAG fusion (plan.fuse): program dispatches per plan
    # (stage_start attempts), how many covered a fused region, and the
    # total member stages those regions folded into one program
    dispatch_count: int = 0
    fused_dispatches: int = 0
    fused_member_stages: int = 0
    # coded stage redundancy (redundancy/): spare launches, decode
    # rounds, and completed-but-unused coded output bytes
    coded_launches: int = 0
    coded_reconstructs: int = 0
    coded_waste_bytes: int = 0
    # combine tree (exec.combinetree): estimated collective bytes the
    # stream-combine merges moved over DCN vs ICI (the number the tree
    # is supposed to shrink), tree merge count and max depth, and the
    # per-key-range host degrade extent
    dcn_bytes: int = 0
    ici_bytes: int = 0
    tree_combines: int = 0
    tree_depth: int = 0
    degraded_ranges: int = 0
    degraded_fraction: float = 0.0
    # exchange planner (plan.xchgplan): staged/flat redistribution
    # rounds dispatched, the largest per-device exchange send-buffer
    # footprint any single round materialized (the number the
    # exchange_window bound caps at O(window * B * row_bytes)), and the
    # exchanges' own ICI/DCN collective split — kept separate from the
    # combine-tree dcn_bytes/ici_bytes so tree-on/off comparisons stay
    # on their own scale
    exchange_rounds: int = 0
    peak_exchange_bytes: int = 0
    exchange_ici_bytes: int = 0
    exchange_dcn_bytes: int = 0
    # async device-paced dispatch (exec.pipeline DispatchWindow):
    # device-idle seconds between consecutive dispatches (the number
    # the window exists to drive to ~0), drain-time chunk retries, and
    # the driver thread's CPU vs wall occupancy over the windows'
    # lives (surfaced as ``driver_cpu_fraction``)
    dispatch_windows: int = 0
    window_dispatches: int = 0
    dispatch_gap_s: float = 0.0
    dispatch_retries: int = 0
    driver_cpu_s: float = 0.0
    driver_wall_s: float = 0.0
    # batched worker command streams (cluster.localjob submit_many):
    # runbatch envelopes shipped and the mailbox round trips they
    # saved vs one command per trip
    command_batches: int = 0
    batched_commands: int = 0
    round_trips_saved: int = 0
    # gang hot path (cluster.localjob): worker-side level -1 partial
    # pre-merges (rows folded before shipping, job-root read bytes the
    # partition cache avoided, cache hit/miss totals) and overlapped
    # gang command windows (envelopes in flight while the feed keeps
    # posting — peak_in_flight >= 2 is the overlap-actually-happened
    # signal; retries are drain-time serial re-entries)
    gang_premerges: int = 0
    gang_premerge_parts: int = 0
    gang_premerge_rows_in: int = 0
    gang_premerge_rows_out: int = 0
    gang_root_read_bytes: int = 0
    gang_cache_hits: int = 0
    gang_cache_misses: int = 0
    gang_windows: int = 0
    gang_dispatches: int = 0
    gang_peak_in_flight: int = 0
    gang_retries: int = 0
    # serving tier (serve.service): service-level admission/cache
    # totals plus per-tenant attribution — tenant -> counter dict
    # (admitted/completed/rejected/cache_hits/failed/seconds plus the
    # latest quota_state), the fold the jobview tenant panel renders
    queries_admitted: int = 0
    queries_completed: int = 0
    queries_rejected: int = 0
    result_cache_hits: int = 0
    tenants: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict
    )
    # materialized views (views.matview via serve): registrations vs
    # structured refusals, delta-fold volume, and how reads resolved —
    # fresh (zero dispatches) vs finalized (one dispatch)
    views_registered: int = 0
    view_fallbacks: int = 0
    view_deltas: int = 0
    view_delta_rows: int = 0
    view_delta_bytes: int = 0
    view_snapshots_fresh: int = 0
    view_snapshots_finalized: int = 0
    # runtime plan rewriting (rewrite.controller): decisions folded
    # from the diagnosis stream vs how many a driver actually honored
    # at a safe application point, plus per-action decided counts
    # (action name -> count) for the jobview rewrite panel
    rewrites_decided: int = 0
    rewrites_applied: int = 0
    rewrite_actions: Dict[str, int] = dataclasses.field(
        default_factory=dict
    )

    @property
    def driver_cpu_fraction(self) -> float:
        """Driver-thread CPU seconds per wall second across dispatch
        windows (0 when no window summaries were recorded) — the
        driver-off-the-hot-path signal: asynchronous dispatch should
        push this well below 1 while the device stays busy."""
        if self.driver_wall_s <= 0:
            return 0.0
        return min(1.0, self.driver_cpu_s / self.driver_wall_s)

    @property
    def padding_waste(self) -> float:
        """Fraction of device layout rows that were padding (0 when no
        layout accounting was recorded)."""
        if self.layout_rows <= 0:
            return 0.0
        return max(0.0, 1.0 - self.valid_rows / self.layout_rows)

    def attribution(self) -> Dict[str, float]:
        """The compile/execute/stall/spill summary as a flat dict (the
        BENCH-record / jobview rendering surface)."""
        return {
            "compile_s": round(self.compile_s, 4),
            "compile_count": self.compile_count,
            "execute_s": round(self.execute_s, 4),
            "ingest_stall_s": round(self.ingest_stall_s, 4),
            "compute_stall_s": round(self.compute_stall_s, 4),
            "spill_write_s": round(self.spill_write_s, 4),
            "checkpoint_s": round(self.checkpoint_s, 4),
            "spill_bytes": self.spill_bytes,
            "d2h_bytes": self.d2h_bytes,
            "h2d_bytes": self.h2d_bytes,
            "padding_waste": round(self.padding_waste, 4),
            "retries": self.retries,
            "quarantines": self.quarantines,
            "dispatch_count": self.dispatch_count,
            "fused_dispatches": self.fused_dispatches,
            "coded_launches": self.coded_launches,
            "coded_waste_bytes": self.coded_waste_bytes,
            "dcn_bytes": self.dcn_bytes,
            "ici_bytes": self.ici_bytes,
            "tree_combines": self.tree_combines,
            "tree_depth": self.tree_depth,
            "degraded_fraction": round(self.degraded_fraction, 4),
            "exchange_rounds": self.exchange_rounds,
            "peak_exchange_bytes": self.peak_exchange_bytes,
            "dispatch_gap_s": round(self.dispatch_gap_s, 4),
            "driver_cpu_fraction": round(self.driver_cpu_fraction, 4),
            "dispatch_retries": self.dispatch_retries,
            "command_batches": self.command_batches,
            "round_trips_saved": self.round_trips_saved,
            "gang_premerges": self.gang_premerges,
            "gang_root_read_bytes": self.gang_root_read_bytes,
            "gang_cache_hits": self.gang_cache_hits,
            "gang_peak_in_flight": self.gang_peak_in_flight,
            "queries_admitted": self.queries_admitted,
            "queries_completed": self.queries_completed,
            "queries_rejected": self.queries_rejected,
            "result_cache_hits": self.result_cache_hits,
            "views_registered": self.views_registered,
            "view_fallbacks": self.view_fallbacks,
            "view_deltas": self.view_deltas,
            "view_delta_rows": self.view_delta_rows,
            "view_delta_bytes": self.view_delta_bytes,
            "view_snapshots_fresh": self.view_snapshots_fresh,
            "view_snapshots_finalized": self.view_snapshots_finalized,
            "rewrites_decided": self.rewrites_decided,
            "rewrites_applied": self.rewrites_applied,
        }

    def _tenant(self, ev: Dict[str, Any]) -> Dict[str, Any]:
        """The per-tenant counter record for an event's tenant label,
        created on first contact."""
        t = self.tenants.get(ev.get("tenant", "?"))
        if t is None:
            t = self.tenants[ev.get("tenant", "?")] = {
                "admitted": 0, "completed": 0, "rejected": 0,
                "cache_hits": 0, "failed": 0, "seconds": 0.0,
                "quota_state": "ok",
            }
        return t

    # counter names folded from ``metrics`` snapshot events into the
    # scalar fields above
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

        ``metrics`` snapshot events are CUMULATIVE per source registry,
        so only the LAST snapshot per (worker, counter) contributes —
        re-emitting a registry never double-counts.
        """
        m = cls()
        # (worker, counter name) -> latest cumulative value
        last_counter: Dict[Tuple[Any, str], float] = {}
        workers = set()
        for ev in events:
            kind = ev.get("kind")
            if "worker" in ev and kind == "span":
                workers.add(ev["worker"])
            if kind == "span":
                m.spans += 1
                field = _LEAF_CATS.get(ev.get("cat"))
                if field is not None:
                    setattr(m, field, getattr(m, field) + ev.get("dur", 0.0))
                if ev.get("cat") == "spill":
                    m.spill_bytes += int(ev.get("bytes", 0) or 0)
            elif kind == "xla_compile":
                m.compile_count += 1
                m.compile_s += ev.get("compile_s", 0.0)
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
                # flat-path combines carry the same estimated collective
                # byte split as combine_tree_level, so tree-on vs -off
                # runs compare on one scale
                m.dcn_bytes += int(ev.get("dcn_bytes", 0) or 0)
                m.ici_bytes += int(ev.get("ici_bytes", 0) or 0)
            elif kind == "stream_chunk":
                m.rows_in += int(ev.get("rows", 0) or 0)
            elif kind in ("stage_failed", "vertex_retry", "coded_retry"):
                m.retries += 1
            elif kind == "computer_quarantined":
                m.quarantines += 1
            elif kind == "coded_launch":
                m.coded_launches += 1
            elif kind == "coded_reconstruct":
                m.coded_reconstructs += 1
            elif kind == "coded_waste_bytes":
                m.coded_waste_bytes += int(ev.get("bytes", 0) or 0)
            elif kind == "combine_tree_level":
                m.tree_combines += 1
                m.tree_depth = max(m.tree_depth, int(ev.get("level", 0)) + 1)
                m.dcn_bytes += int(ev.get("dcn_bytes", 0) or 0)
                m.ici_bytes += int(ev.get("ici_bytes", 0) or 0)
            elif kind == "exchange_round":
                # "bytes" is the round's peak send-buffer footprint per
                # device; ici/dcn are the shipped collective bytes
                m.exchange_rounds += 1
                m.peak_exchange_bytes = max(
                    m.peak_exchange_bytes, int(ev.get("bytes", 0) or 0)
                )
                m.exchange_dcn_bytes += int(ev.get("dcn_bytes", 0) or 0)
                m.exchange_ici_bytes += int(ev.get("ici_bytes", 0) or 0)
            elif kind == "dispatch_window":
                # the close-time summary carries the cumulative gap_s
                # of its per-gap ``dispatch_gap`` events, so ONLY the
                # summary is folded — the per-gap events feed the
                # trace/jobview timelines instead of this snapshot
                m.dispatch_windows += 1
                m.window_dispatches += int(ev.get("dispatches", 0) or 0)
                m.dispatch_gap_s += float(ev.get("gap_s", 0.0) or 0.0)
                m.dispatch_retries += int(ev.get("retries", 0) or 0)
                m.driver_cpu_s += float(ev.get("driver_cpu_s", 0.0) or 0.0)
                m.driver_wall_s += float(ev.get("wall_s", 0.0) or 0.0)
            elif kind == "command_batch":
                m.command_batches += 1
                m.batched_commands += int(ev.get("commands", 0) or 0)
                m.round_trips_saved += int(
                    ev.get("round_trips_saved", 0) or 0
                )
            elif kind == "gang_partial_combine":
                m.gang_premerges += 1
                m.gang_premerge_parts += int(ev.get("parts", 0) or 0)
                m.gang_premerge_rows_in += int(ev.get("in_rows", 0) or 0)
                m.gang_premerge_rows_out += int(ev.get("rows", 0) or 0)
                m.gang_root_read_bytes += int(ev.get("read_bytes", 0) or 0)
                m.gang_cache_hits += int(ev.get("cache_hits", 0) or 0)
                m.gang_cache_misses += int(ev.get("cache_misses", 0) or 0)
            elif kind == "gang_window":
                m.gang_windows += 1
                m.gang_dispatches += int(ev.get("dispatches", 0) or 0)
                m.gang_peak_in_flight = max(
                    m.gang_peak_in_flight,
                    int(ev.get("peak_in_flight", 0) or 0),
                )
                m.gang_retries += int(ev.get("retries", 0) or 0)
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
                # state TRANSITIONS, so the last one is the live state
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
                act = str(ev.get("action", "?"))
                if ev.get("phase") == "applied":
                    m.rewrites_applied += 1
                else:
                    m.rewrites_decided += 1
                    m.rewrite_actions[act] = (
                        m.rewrite_actions.get(act, 0) + 1
                    )
            elif kind == "combine_tree_degrade":
                m.degraded_ranges = max(
                    m.degraded_ranges, int(ev.get("degraded", 0) or 0)
                )
                m.degraded_fraction = max(
                    m.degraded_fraction, float(ev.get("fraction", 0.0) or 0.0)
                )
            elif kind == "metrics":
                src = ev.get("worker", "driver")
                for c in ev.get("counters", []):
                    name = c.get("name")
                    if name in cls._COUNTER_FIELDS:
                        last_counter[(src, name)] = c.get("value", 0.0)
        m.workers = len(workers)
        for (_src, name), v in last_counter.items():
            field = cls._COUNTER_FIELDS[name]
            setattr(m, field, getattr(m, field) + int(v))
        return m


def format_attribution(m: JobMetrics) -> List[str]:
    """Human-readable attribution lines (shared by jobview's text
    report; empty when the stream carries no obs data)."""
    if not (m.spans or m.compile_count or m.ingest_stall_s
            or m.compute_stall_s):
        return []
    lines = [
        "time attribution: "
        f"compile={m.compile_s:.3f}s ({m.compile_count} compiles)  "
        f"execute={m.execute_s:.3f}s  "
        f"ingest_stall={m.ingest_stall_s:.3f}s  "
        f"spill={m.spill_write_s:.3f}s"
        + (f"  checkpoint={m.checkpoint_s:.3f}s" if m.checkpoint_s else "")
    ]
    if m.dispatch_count:
        # dispatch count alongside compile count: the whole-DAG fusion
        # win is fewer programs launched per plan, not just fewer built
        lines.append(
            f"dispatches: {m.dispatch_count}"
            + (
                f" ({m.fused_dispatches} fused regions covering "
                f"{m.fused_member_stages} stages)"
                if m.fused_dispatches else ""
            )
        )
    if m.dispatch_windows:
        # the dispatch-occupancy line: device-idle gap between
        # dispatches and the driver thread's CPU share of the window's
        # wall time — both should fall as dispatch_depth rises
        lines.append(
            f"dispatch: {m.window_dispatches} async over "
            f"{m.dispatch_windows} window(s)  "
            f"gap={m.dispatch_gap_s:.3f}s  "
            f"driver_cpu={m.driver_cpu_fraction:.0%}"
            + (
                f"  retries={m.dispatch_retries}"
                if m.dispatch_retries else ""
            )
        )
    parts = []
    if m.spill_bytes:
        parts.append(f"spill_bytes={m.spill_bytes}")
    if m.d2h_bytes or m.h2d_bytes:
        parts.append(f"d2h={m.d2h_bytes}B h2d={m.h2d_bytes}B")
    if m.layout_rows:
        parts.append(f"padding_waste={m.padding_waste:.1%}")
    if m.retries or m.quarantines:
        parts.append(f"retries={m.retries} quarantines={m.quarantines}")
    if m.coded_launches or m.coded_reconstructs:
        parts.append(
            f"coded: launches={m.coded_launches} "
            f"reconstructs={m.coded_reconstructs} "
            f"waste={m.coded_waste_bytes}B"
        )
    if m.tree_combines or m.dcn_bytes or m.ici_bytes:
        parts.append(
            f"combine: dcn={m.dcn_bytes}B ici={m.ici_bytes}B"
            + (
                f" tree[{m.tree_combines} merges, depth {m.tree_depth}]"
                if m.tree_combines else ""
            )
            + (
                f" degraded={m.degraded_fraction:.0%} of key ranges"
                if m.degraded_ranges else ""
            )
        )
    if m.exchange_rounds:
        parts.append(
            f"exchange: rounds={m.exchange_rounds} "
            f"peak={m.peak_exchange_bytes}B "
            f"dcn={m.exchange_dcn_bytes}B ici={m.exchange_ici_bytes}B"
        )
    if m.command_batches:
        parts.append(
            f"cmd_batch: {m.batched_commands} cmds in "
            f"{m.command_batches} batches "
            f"(saved {m.round_trips_saved} round trips)"
        )
    if m.gang_premerges or m.gang_windows:
        bits = []
        if m.gang_premerges:
            folded = max(
                0, m.gang_premerge_rows_in - m.gang_premerge_rows_out
            )
            bits.append(
                f"premerged {m.gang_premerge_parts} parts on "
                f"{m.gang_premerges} worker pass(es) "
                f"(folded {folded} rows, root_reads="
                f"{m.gang_root_read_bytes}B, cache "
                f"{m.gang_cache_hits}/{m.gang_cache_hits + m.gang_cache_misses})"
            )
        if m.gang_windows:
            bits.append(
                f"{m.gang_dispatches} envelopes over {m.gang_windows} "
                f"window(s) peak_in_flight={m.gang_peak_in_flight}"
                + (f" retries={m.gang_retries}" if m.gang_retries else "")
            )
        parts.append("gang: " + "  ".join(bits))
    if m.queries_admitted or m.queries_rejected:
        hit_rate = (
            m.result_cache_hits / m.queries_completed
            if m.queries_completed else 0.0
        )
        parts.append(
            f"serve: {m.queries_completed}/{m.queries_admitted} queries "
            f"over {len(m.tenants)} tenant(s) "
            f"cache_hit={hit_rate:.0%} rejected={m.queries_rejected}"
        )
    if m.views_registered or m.view_fallbacks:
        parts.append(
            f"views: {m.views_registered} registered "
            f"deltas={m.view_deltas} ({m.view_delta_rows} rows) "
            f"reads fresh={m.view_snapshots_fresh} "
            f"finalized={m.view_snapshots_finalized} "
            f"fallbacks={m.view_fallbacks}"
        )
    if m.workers:
        parts.append(f"worker_telemetry={m.workers} workers")
    if parts:
        lines.append("resources: " + "  ".join(parts))
    return lines
