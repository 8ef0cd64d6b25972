"""Counters, histograms and key-range histograms of the stream path
(``MetricsRegistry`` and ``KeyRangeHistogram`` of
``dryad_tpu/obs/metrics.py``).

- :class:`MetricsRegistry`: thread-safe labeled counters and
  histograms (spill bytes, transfer bytes, per-piece rows).  A
  histogram keeps count/sum/min/max and power-of-two bucket counts, so
  per-partition row samples double as skew histograms;
  ``emit(events)`` writes one ``metrics`` event.
- :class:`KeyRangeHistogram`: per hash-derived key range, a row count
  and a HyperLogLog-style distinct estimate; the combine tree places
  partials by the counts and degrades ranges by the estimates.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Tuple

import numpy as np

__all__ = ["MetricsRegistry", "KeyRangeHistogram"]


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
