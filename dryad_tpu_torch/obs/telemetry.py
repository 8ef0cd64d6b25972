"""The continuous telemetry plane (a copy of ``dryad_tpu/obs/telemetry.py``):
live resource monitoring, rolling SLO metrics, and measured-headroom
adaptive policies.

- :class:`RollingStore`: windowed counters, last-write gauges and pow2
  latency histograms with p50/p95/p99 readouts, labeled (per tenant,
  per phase).  The window is a ring of ``buckets`` sub-windows rotated
  by an injectable clock.  Every metric name written anywhere in the
  port appears in :data:`METRIC_KEYS`.
- :class:`ResourceMonitor`: the live resource sampler.  It reads device
  memory through :func:`device_memory_probe` (below), falls back to the
  host (process RSS from ``/proc`` via ``obs/flightrec.py``), and adds
  every probe of the flightrec shared registry (the serve queue, the
  dispatch windows).  Samples land in a bounded ring, as
  ``resource_sample`` events (the ``hbm_pressure`` diagnosis, the
  jobview telemetry panel, the Chrome-trace counter track) and as
  gauges on a RollingStore.  Sampling is opportunistic (an EventLog
  tap paced by ``interval_s``: no idle cost); :meth:`ResourceMonitor.start`
  adds a background thread for resident processes.
- :class:`HeadroomProvider`: the measured headroom that the adaptive
  dispatch depth (:func:`resolve_depth`, ``dispatch_depth=-1``)
  consults.  Any depth gives the serial loop's bytes, so a bad
  measurement can cost time, never correctness.

The device probe.  The reference reads its allocator's ``bytes_in_use``
and ``bytes_limit``.  Here the limit is the card's total memory from
``torch.cuda.mem_get_info``, and the headroom is the card's free memory
plus the blocks this process's caching allocator holds unused
(``memory_reserved - memory_allocated``: free to reuse); used is the
limit minus the headroom.  Read device-wide like this, the headroom
stays honest when several worker processes or serving replicas share
one card: a per-process reading would show each of them the whole card
free.  The probe never creates a CUDA context (it reads only a CUDA
device of a process whose CUDA state is initialized, else the host
fallback is taken, as on the CPU), and it adds no stream sync; it names
the device explicitly, because the tap runs on whichever thread emits
(the spill writer, the prefetcher).

Export surfaces: :func:`prometheus_text` / :meth:`RollingStore.snapshot`
(``tools/metricsd.py``), ``resource_sample`` counter tracks in
``obs/trace.py``, and the jobview telemetry panel.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from dryad_tpu_torch.obs import flightrec

__all__ = [
    "METRIC_KEYS",
    "RollingStore",
    "ResourceMonitor",
    "HeadroomProvider",
    "device_memory_probe",
    "resolve_depth",
    "latency_bucket",
    "bucket_upper",
    "percentile_of",
    "quantiles_from_hist",
    "prometheus_text",
]

# Every telemetry metric name the port writes, one line each: the
# documented metric table (``prometheus_text`` reads its help lines).
METRIC_KEYS: Dict[str, str] = {
    "queries_admitted": "queries past admission, windowed, per tenant",
    "queries_completed": "queries resolved (ok or failed), per tenant",
    "queries_rejected": "admissions refused past quota, per tenant",
    "result_cache_hits": "queries served from the result cache",
    "view_snapshots_fresh": "view reads served from a fresh snapshot "
                            "(zero dispatches), per tenant",
    "query_latency_s": "admission->completion latency, per tenant",
    "query_phase_s": "critical-path phase time per completed query, "
                     "per tenant+phase (obs.critpath fold)",
    "serve_queue_depth": "queued-and-unpicked queries across tenants",
    "hbm_used_bytes": "device HBM in use (summed over local devices)",
    "hbm_limit_bytes": "device HBM capacity (summed over local devices)",
    "hbm_headroom_bytes": "limit - used; the adaptive policies' input",
    "host_rss_kb": "driver process resident set size (CPU fallback)",
}

_QUANTILES = (0.5, 0.95, 0.99)
# frexp exponent floor for non-positive/zero observations (the
# subnormal limit: 2^-1074 is the smallest positive double)
_ZERO_EXP = -1074


def latency_bucket(v: float) -> int:
    """pow2 bucket exponent ``e`` with ``2^(e-1) <= v < 2^e``.

    ``math.frexp`` covers sub-second latencies with full resolution
    (0.3s -> e=-1, i.e. the (0.25, 0.5] bucket) where an
    ``int(v).bit_length()`` scheme collapses everything below 1s into
    one bucket."""
    if v <= 0.0:
        return _ZERO_EXP
    return math.frexp(float(v))[1]


def bucket_upper(e: int) -> float:
    """Upper bound (the representative readout value) of bucket ``e``."""
    if e <= _ZERO_EXP:
        return 0.0
    return float(2.0 ** e)


def percentile_of(values, q: float) -> Optional[float]:
    """Quantile ``q`` of raw observations under the pow2 bucketing —
    the offline twin of :meth:`RollingStore.percentiles` (jobview and
    metricsd fold recorded streams through this so live and post-hoc
    readouts agree bucket-for-bucket)."""
    counts: Dict[int, int] = {}
    n = 0
    for v in values:
        counts[latency_bucket(float(v))] = counts.get(
            latency_bucket(float(v)), 0
        ) + 1
        n += 1
    if n == 0:
        return None
    rank = max(1, math.ceil(q * n))
    cum = 0
    for e in sorted(counts):
        cum += counts[e]
        if cum >= rank:
            return bucket_upper(e)
    return bucket_upper(max(counts))


def quantiles_from_hist(
    merged: Dict[int, int], qs: Tuple[float, ...] = _QUANTILES
) -> Optional[Dict[str, float]]:
    """``{"n", "p50", ...}`` from a pow2 bucket histogram (exponent ->
    count), or None when empty.  THE quantile fold — the live
    :meth:`RollingStore.percentiles`, the offline :func:`percentile_of`,
    and metricsd's fleet merge all read through it, so every surface
    agrees bucket-for-bucket."""
    n = sum(merged.values())
    if n == 0:
        return None
    out: Dict[str, float] = {"n": n}
    exps = sorted(merged)
    for q in qs:
        rank = max(1, math.ceil(q * n))
        cum = 0
        val = bucket_upper(exps[-1])
        for e in exps:
            cum += merged[e]
            if cum >= rank:
                val = bucket_upper(e)
                break
        out[f"p{int(q * 100)}"] = val
    return out


def _labels_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class RollingStore:
    """Windowed counters + gauges + pow2 latency histograms.

    The window ``window_s`` splits into ``buckets`` sub-windows; each
    write lands in the current sub-window and reads fold every
    sub-window younger than the window — so a counter total decays in
    ``window_s / buckets`` granularity instead of cliff-dropping to
    zero.  ``clock`` is injectable (monotonic seconds); the golden
    tests drive rotation with a fake clock.  Gauges are last-write
    point-in-time values, not windowed.  Thread-safe (serve client
    threads, the driver, and the sampler all write)."""

    def __init__(
        self,
        window_s: float = 60.0,
        buckets: int = 6,
        clock: Callable[[], float] = time.monotonic,
    ):
        if window_s <= 0:
            raise ValueError("window_s must be > 0")
        if buckets < 1:
            raise ValueError("buckets must be >= 1")
        self.window_s = float(window_s)
        self.buckets = int(buckets)
        self._span = self.window_s / self.buckets
        self._clock = clock
        self._lock = threading.Lock()
        # epoch -> {"counters": {(name, labels): n},
        #           "hists": {(name, labels): {exp: count}}}
        self._slots: Dict[int, Dict[str, Dict]] = {}
        self._gauges: Dict[Tuple[str, Tuple], float] = {}

    # -- rotation ------------------------------------------------------------

    def _epoch(self) -> int:
        return int(self._clock() / self._span)

    def _slot_locked(self) -> Dict[str, Dict]:
        now = self._epoch()
        floor = now - self.buckets + 1
        for ep in [e for e in self._slots if e < floor]:
            del self._slots[ep]
        slot = self._slots.get(now)
        if slot is None:
            slot = self._slots[now] = {"counters": {}, "hists": {}}
        return slot

    def _live_locked(self) -> List[Dict[str, Dict]]:
        floor = self._epoch() - self.buckets + 1
        return [
            slot for ep, slot in sorted(self._slots.items()) if ep >= floor
        ]

    # -- write surface (the metric-key rule scans these names) ---------------

    def incr(self, name: str, n: int = 1, **labels: Any) -> None:
        """Add ``n`` to the windowed counter ``name`` (labeled)."""
        key = (name, _labels_key(labels))
        with self._lock:
            c = self._slot_locked()["counters"]
            c[key] = c.get(key, 0) + int(n)

    def set_gauge(self, name: str, value: float, **labels: Any) -> None:
        """Set the point-in-time gauge ``name`` (last write wins)."""
        with self._lock:
            self._gauges[(name, _labels_key(labels))] = float(value)

    def observe_latency(self, name: str, seconds: float, **labels: Any) -> None:
        """Record one latency observation into the pow2 histogram."""
        key = (name, _labels_key(labels))
        e = latency_bucket(float(seconds))
        with self._lock:
            h = self._slot_locked()["hists"].setdefault(key, {})
            h[e] = h.get(e, 0) + 1

    # -- read surface --------------------------------------------------------

    def counter_total(self, name: str, **labels: Any) -> int:
        key = (name, _labels_key(labels))
        with self._lock:
            return sum(
                slot["counters"].get(key, 0) for slot in self._live_locked()
            )

    def gauge(self, name: str, **labels: Any) -> Optional[float]:
        with self._lock:
            return self._gauges.get((name, _labels_key(labels)))

    def _merged_hist_locked(self, key) -> Dict[int, int]:
        merged: Dict[int, int] = {}
        for slot in self._live_locked():
            for e, n in slot["hists"].get(key, {}).items():
                merged[e] = merged.get(e, 0) + n
        return merged

    def percentiles(
        self, name: str, qs: Tuple[float, ...] = _QUANTILES, **labels: Any
    ) -> Optional[Dict[str, float]]:
        """``{"n": count, "p50": ..., "p95": ..., "p99": ...}`` over
        the live window, or None with no observations.  Each quantile
        reads as the pow2 UPPER bound of the bucket its rank lands in
        — deterministic, so golden tests pin exact values."""
        key = (name, _labels_key(labels))
        with self._lock:
            merged = self._merged_hist_locked(key)
        return quantiles_from_hist(merged, qs)

    def label_sets(self, name: str) -> List[Dict[str, str]]:
        """Every label combination seen for ``name`` in the window."""
        with self._lock:
            keys = set()
            for slot in self._live_locked():
                for (n, lk) in slot["counters"]:
                    if n == name:
                        keys.add(lk)
                for (n, lk) in slot["hists"]:
                    if n == name:
                        keys.add(lk)
            for (n, lk) in self._gauges:
                if n == name:
                    keys.add(lk)
        return [dict(lk) for lk in sorted(keys)]

    def snapshot(self) -> Dict[str, Any]:
        """One JSON-able point-in-time readout of the whole window:
        counters (windowed totals), gauges, and per-label latency
        percentiles — the metricsd JSON export body.  Each latency
        entry also carries its raw pow2 ``buckets`` (exponent ->
        count, string keys for JSON), the lossless form metricsd's
        fleet aggregator merges across processes before re-deriving
        quantiles — merging the percentile readouts themselves would
        not commute."""
        with self._lock:
            live = self._live_locked()
            counters: Dict[Tuple, int] = {}
            hists: Dict[Tuple, Dict[int, int]] = {}
            for slot in live:
                for key, n in slot["counters"].items():
                    counters[key] = counters.get(key, 0) + n
                for key, h in slot["hists"].items():
                    merged = hists.setdefault(key, {})
                    for e, n in h.items():
                        merged[e] = merged.get(e, 0) + n
            gauges = dict(self._gauges)
        out: Dict[str, Any] = {
            "window_s": self.window_s,
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


def _fmt_labels(labels: Dict[str, str], extra: Tuple = ()) -> str:
    pairs = sorted(labels.items()) + list(extra)
    if not pairs:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in pairs)
    return "{" + body + "}"


def prometheus_text(
    snapshot: Dict[str, Any], prefix: str = "dryad_"
) -> str:
    """Render a :meth:`RollingStore.snapshot` dict as Prometheus text
    exposition (stable ordering — golden-testable).  Counters export
    as ``<prefix><name>_total``, gauges verbatim, latency histograms
    as quantile summaries plus a ``_count``."""
    lines: List[str] = []
    docs = METRIC_KEYS
    seen_type = set()

    def head(name: str, mtype: str) -> None:
        if name in seen_type:
            return
        seen_type.add(name)
        base = name[len(prefix):] if name.startswith(prefix) else name
        base = base[:-6] if base.endswith("_total") else base
        doc = docs.get(base, base)
        lines.append(f"# HELP {name} {doc}")
        lines.append(f"# TYPE {name} {mtype}")

    for rec in snapshot.get("counters", []):
        name = f"{prefix}{rec['name']}_total"
        head(name, "counter")
        lines.append(f"{name}{_fmt_labels(rec['labels'])} {rec['total']}")
    for rec in snapshot.get("gauges", []):
        name = f"{prefix}{rec['name']}"
        head(name, "gauge")
        v = rec["value"]
        sv = str(int(v)) if float(v).is_integer() else repr(float(v))
        lines.append(f"{name}{_fmt_labels(rec['labels'])} {sv}")
    for rec in snapshot.get("latencies", []):
        name = f"{prefix}{rec['name']}"
        head(name, "summary")
        for q in _QUANTILES:
            key = f"p{int(q * 100)}"
            if key not in rec:
                continue
            lab = _fmt_labels(rec["labels"], (("quantile", str(q)),))
            lines.append(f"{name}{lab} {rec[key]}")
        lines.append(
            f"{name}_count{_fmt_labels(rec['labels'])} {rec['n']}"
        )
    return "\n".join(lines) + ("\n" if lines else "")


class HeadroomProvider:
    """The measured-headroom handle the adaptive policies consult.

    ``headroom_bytes()`` returns the latest measured free-HBM figure,
    or None when no measurement is available — in which case every
    consumer falls back to its configured behavior (the default
    depth).  Thread-safe; the sampler writes, the
    driver reads."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._headroom: Optional[int] = None

    def update(self, headroom_bytes: Optional[int]) -> None:
        with self._lock:
            self._headroom = (
                None if headroom_bytes is None else int(headroom_bytes)
            )

    def headroom_bytes(self) -> Optional[int]:
        with self._lock:
            return self._headroom


# deterministic headroom -> depth tiers for dispatch_depth == -1; the
# window collector drains strictly in submit order, so ANY resolved
# depth is byte-identical to the serial loop — the tiers only trade
# in-flight host result memory against device idle gaps
_DEPTH_TIERS = ((4 << 30, 4), (1 << 30, 3), (256 << 20, 2))
_DEFAULT_ADAPTIVE_DEPTH = 2


def resolve_depth(config_depth: int, provider=None) -> int:
    """The effective dispatch-window depth for one driver.

    ``config_depth >= 1`` is a static override, returned verbatim;
    ``-1`` is the adaptive mode — measured headroom picks the tier
    (>=4GB -> 4, >=1GB -> 3, >=256MB -> 2, else 1), and with no
    measurement available the default (2) applies.  Any other value
    returns verbatim for the caller's own validation to reject.
    Deterministic in its inputs."""
    d = int(config_depth)
    if d != -1:
        return d
    h = provider.headroom_bytes() if provider is not None else None
    if h is None:
        return _DEFAULT_ADAPTIVE_DEPTH
    h = int(h)
    for floor, depth in _DEPTH_TIERS:
        if h >= floor:
            return depth
    return 1


def _no_device_memory() -> Optional[Tuple[int, int]]:
    return None


def device_memory_probe(device) -> Callable[[], Optional[Tuple[int, int]]]:
    """The ``device_memory_fn`` of a context on ``device``, or on each
    of a list of devices (a context over several cards): a reader of
    ``(used, limit)`` bytes summed over those cards (see the module
    doc), as the reference sums its local devices' memory stats.  It
    returns None (the host fallback) when none of them is a CUDA card,
    or while the process's CUDA state is uninitialized, so that
    sampling never creates a context."""
    import torch  # noqa: PLC0415 - keeps this module light to import

    devices = [torch.device(d) for d in (device if isinstance(device, (list, tuple)) else [device])]
    cards = [d for d in devices if d.type == "cuda"]
    if not cards:
        return _no_device_memory

    def read() -> Optional[Tuple[int, int]]:
        if not torch.cuda.is_initialized():
            return None
        used = limit = 0
        for card in cards:
            free, total = torch.cuda.mem_get_info(card)
            cached = torch.cuda.memory_reserved(card) - torch.cuda.memory_allocated(card)
            headroom = min(total, free + max(0, cached))
            used += total - headroom
            limit += total
        return used, limit

    return read


class ResourceMonitor:
    """Live resource sampler; see the module doc.

    ``observe`` is an EventLog tap (opportunistic sampling on event
    flow — the flightrec discipline, zero idle cost); :meth:`start`
    adds a background daemon thread for resident processes that must
    keep sampling while the event stream is idle.  Both paths funnel
    through :meth:`sample`, which is also the manual test surface.

    ``device_memory_fn`` is injectable (tests fake HBM readings; a
    context passes ``device_memory_probe`` of its cards, and without
    one every sample takes the host fallback); ``clock`` paces
    opportunistic sampling deterministically."""

    def __init__(
        self,
        interval_s: float = 1.0,
        events=None,
        store: Optional[RollingStore] = None,
        clock: Callable[[], float] = time.monotonic,
        history: int = 256,
        device_memory_fn: Callable[
            [], Optional[Tuple[int, int]]
        ] = _no_device_memory,
    ):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.interval_s = float(interval_s)
        self.events = events
        self.store = store
        self.headroom = HeadroomProvider()
        self.samples: deque = deque(maxlen=max(1, int(history)))
        self._clock = clock
        self._device_memory = device_memory_fn
        self._last = float("-inf")
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- sampling ------------------------------------------------------------

    def sample(self) -> Dict[str, Any]:
        """Take one sample now: device HBM (or the host fallback),
        plus every shared flightrec probe.  Retains it in the ring,
        updates the headroom provider and gauges, and emits one
        ``resource_sample`` event."""
        snap: Dict[str, Any] = {"mono": self._clock()}
        mem = self._device_memory()
        store = self.store
        if mem is not None:
            used, limit = mem
            headroom = max(0, limit - used)
            snap.update(
                source="device",
                hbm_used_bytes=used,
                hbm_limit_bytes=limit,
                hbm_headroom_bytes=headroom,
            )
            self.headroom.update(headroom)
            if store is not None:
                store.set_gauge("hbm_used_bytes", used)
                store.set_gauge("hbm_limit_bytes", limit)
                store.set_gauge("hbm_headroom_bytes", headroom)
        else:
            snap["source"] = "host"
            rss = flightrec._rss_kb()
            if rss is not None:
                snap["rss_kb"] = rss
                if store is not None:
                    store.set_gauge("host_rss_kb", rss)
            # no device measurement: the adaptive consumers must fall
            # back to their configured budgets, not act on a stale one
            self.headroom.update(None)
        probes = flightrec.sample_shared_probes()
        if probes:
            snap["probes"] = probes
        with self._lock:
            self.samples.append(snap)
        if self.events is not None:
            fields = {k: v for k, v in snap.items() if k != "mono"}
            self.events.emit("resource_sample", **fields)
        return snap

    def observe(self, ev: Dict[str, Any]) -> None:
        """EventLog tap: sample when ``interval_s`` has elapsed since
        the last one.  Never raises; ignores its own samples (no
        self-sustaining feedback)."""
        try:
            if ev.get("kind") == "resource_sample":
                return
            now = self._clock()
            if now - self._last >= self.interval_s:
                self._last = now
                self.sample()
        except Exception:
            pass  # observability must never fail the job

    def recent(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self.samples)

    # -- background thread (resident processes) ------------------------------

    def start(self) -> "ResourceMonitor":
        """Spawn the background sampler thread (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="dryad-telemetry", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop and join the sampler thread (no-op when not started)."""
        with self._lock:
            thread = self._thread
            self._thread = None
        if thread is None:
            return
        self._stop.set()
        thread.join(timeout=10.0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._last = self._clock()
                self.sample()
            except Exception:
                pass  # keep sampling; one bad read is not fatal
