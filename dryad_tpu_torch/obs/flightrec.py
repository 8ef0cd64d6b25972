"""Flight recorder (a copy of ``dryad_tpu/obs/flightrec.py``): crash
forensics that survive the process.

An always-on bounded ring of the most recent events (span closes
included) plus periodic health microsnapshots (RSS, and every probe in
the shared registry: the serve queue, dispatch windows), dumped
atomically to ``blackbox-<pid>.json`` when the process is about to die:

- explicitly, from a job-failure site (:func:`dump_now`);
- on unhandled exceptions (a chained ``sys.excepthook``);
- on exit or SIGTERM, opt-in per process role.

``record`` is an ``EventLog`` tap (called on every event, outside the
log lock), so it never raises and never blocks.  Microsnapshots are
sampled inside ``record`` when ``snapshot_s`` has elapsed: no
background thread, no idle cost.  ``tools/blackbox.py`` merges the
dumps into one timeline.
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "FlightRecorder",
    "install_recorder",
    "get_recorder",
    "uninstall_recorder",
    "probe",
    "unprobe",
    "sample_shared_probes",
    "dump_now",
]

DUMP_VERSION = 1
_SNAPSHOT_CAP = 256  # snapshots kept alongside the event ring

# One process-wide probe registry shared by every consumer — the
# blackbox microsnapshots AND the telemetry ResourceMonitor sample the
# same entries, so a subsystem registers its probe exactly once and
# ``unprobe`` removes it everywhere.  Keyed by name (re-registering a
# name replaces the callable, which also bounds any leak from callers
# that never unprobe).
_PROBE_LOCK = threading.Lock()
_SHARED_PROBES: Dict[str, Callable[[], Any]] = {}


def sample_shared_probes() -> Dict[str, Any]:
    """Sample every shared probe once; a raising probe is skipped.
    Callables run outside the lock (they may take their own locks)."""
    with _PROBE_LOCK:
        probes = list(_SHARED_PROBES.items())
    out: Dict[str, Any] = {}
    for name, fn in probes:
        try:
            out[name] = fn()
        except Exception:
            pass
    return out


def _rss_kb() -> Optional[int]:
    """Resident set size in KB; /proc fast path, getrusage fallback."""
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        return pages * (os.sysconf("SC_PAGE_SIZE") // 1024)
    except Exception:
        try:
            import resource

            return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
        except Exception:
            return None


class FlightRecorder:
    """Bounded ring of recent events + health microsnapshots, dumped
    to ``blackbox-<pid>.json`` when the process is about to die."""

    def __init__(
        self,
        capacity: int = 2048,
        snapshot_s: float = 1.0,
        dump_dir: Optional[str] = None,
        role: str = "driver",
        worker: Optional[int] = None,
    ):
        self.capacity = capacity
        self.snapshot_s = snapshot_s
        self.dump_dir = dump_dir or "."
        self.role = role
        self.worker = worker
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._snapshots: deque = deque(maxlen=_SNAPSHOT_CAP)
        self._probes: Dict[str, Callable[[], Any]] = {}
        self._info: Dict[str, Any] = {}
        self._last_snap = 0.0
        self._dumped_reasons: List[str] = []
        self.dropped_hint = 0  # last events_dropped total seen in-stream

    # -- feeding ------------------------------------------------------------

    def record(self, ev: Dict[str, Any]) -> None:
        """EventLog tap: append one event to the ring.  Must never
        raise (the tap caller swallows, but don't rely on it)."""
        try:
            with self._lock:
                self._ring.append(ev)
                if ev.get("kind") == "events_dropped":
                    self.dropped_hint = int(ev.get("dropped", 0) or 0)
            now = time.monotonic()
            if now - self._last_snap >= self.snapshot_s:
                self._last_snap = now
                self.snapshot()
        except Exception:
            pass

    def probe(self, name: str, fn: Callable[[], Any]) -> None:
        """Register a health probe sampled into every microsnapshot
        (in-flight dispatches, pipeline occupancy, pool residency...).
        The callable must be cheap and is allowed to raise (the sample
        is skipped)."""
        with self._lock:
            self._probes[name] = fn

    def unprobe(self, name: str) -> None:
        with self._lock:
            self._probes.pop(name, None)

    def set_info(self, **kw: Any) -> None:
        """Attach identity/context metadata to future dumps (job dir,
        gang generation, per-worker clock offsets...)."""
        with self._lock:
            self._info.update(kw)

    def snapshot(self) -> Dict[str, Any]:
        """Take one health microsnapshot now and retain it."""
        snap: Dict[str, Any] = {
            "ts": time.time(), "mono": time.monotonic(),
        }
        rss = _rss_kb()
        if rss is not None:
            snap["rss_kb"] = rss
        # shared registry first, instance probes win on a name clash
        with _PROBE_LOCK:
            merged = dict(_SHARED_PROBES)
        with self._lock:
            merged.update(self._probes)
        probes = list(merged.items())
        for name, fn in probes:
            try:
                snap[name] = fn()
            except Exception:
                pass
        with self._lock:
            self._snapshots.append(snap)
        return snap

    # -- dumping ------------------------------------------------------------

    def dump(self, reason: str) -> Optional[str]:
        """Write the blackbox atomically (tmp + rename); returns the
        path, or None when the write failed or there is nothing to
        say.  Repeated same-process dumps overwrite — the LAST reason
        wins, but every reason is retained in the payload."""
        try:
            with self._lock:
                self._dumped_reasons.append(reason)
                payload = {
                    "version": DUMP_VERSION,
                    "pid": os.getpid(),
                    "role": self.role,
                    "worker": self.worker,
                    "reason": reason,
                    "reasons": list(self._dumped_reasons),
                    "wall": time.time(),
                    "mono": time.monotonic(),
                    "dropped": self.dropped_hint,
                    "info": dict(self._info),
                    "events": list(self._ring),
                    "snapshots": list(self._snapshots),
                }
            path = os.path.join(
                self.dump_dir, f"blackbox-{os.getpid()}.json"
            )
            os.makedirs(self.dump_dir, exist_ok=True)
            tmp = path + f".tmp.{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(payload, fh, default=str)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
            return path
        except Exception:
            return None


# -- per-process singleton ---------------------------------------------------

_RECORDER: Optional[FlightRecorder] = None
_TAPPED_LOG = None
_HOOKS_INSTALLED = False
_ATEXIT_DUMP = False
_PREV_EXCEPTHOOK = None
_PREV_SIGTERM = None


def _excepthook(etype, value, tb):
    rec = _RECORDER
    if rec is not None:
        rec.dump(f"unhandled:{etype.__name__}")
    hook = _PREV_EXCEPTHOOK or sys.__excepthook__
    hook(etype, value, tb)


def _atexit_dump():
    rec = _RECORDER
    if rec is not None and _ATEXIT_DUMP:
        rec.dump("atexit")


def _sigterm(signum, frame):
    rec = _RECORDER
    if rec is not None:
        rec.dump("sigterm")
    prev = _PREV_SIGTERM
    if callable(prev):
        prev(signum, frame)
    else:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)


def _install_hooks(atexit_dump: bool, signals: bool) -> None:
    global _HOOKS_INSTALLED, _ATEXIT_DUMP, _PREV_EXCEPTHOOK, _PREV_SIGTERM
    _ATEXIT_DUMP = _ATEXIT_DUMP or atexit_dump
    if _HOOKS_INSTALLED:
        return
    _HOOKS_INSTALLED = True
    _PREV_EXCEPTHOOK = sys.excepthook
    sys.excepthook = _excepthook
    atexit.register(_atexit_dump)
    if signals:
        try:
            # only the main thread may set handlers; workers install
            # from main(), library use from elsewhere just skips it
            _PREV_SIGTERM = signal.signal(signal.SIGTERM, _sigterm)
        except ValueError:
            pass


def install_recorder(
    capacity: int = 2048,
    snapshot_s: float = 1.0,
    dump_dir: Optional[str] = None,
    role: str = "driver",
    worker: Optional[int] = None,
    events=None,
    atexit_dump: bool = False,
    signals: bool = False,
) -> FlightRecorder:
    """Create (or replace) the process flight recorder, tap it into
    *events*, and install the death hooks.

    ``atexit_dump``/``signals`` are opt-in per role: worker processes
    dump on ANY exit (their telemetry may be un-shipped); the driver
    dumps only on failure paths (clean test runs must not litter)."""
    global _RECORDER, _TAPPED_LOG
    if _RECORDER is not None and _TAPPED_LOG is not None:
        try:
            _TAPPED_LOG.remove_tap(_RECORDER.record)
        except Exception:
            pass
    rec = FlightRecorder(
        capacity=capacity, snapshot_s=snapshot_s, dump_dir=dump_dir,
        role=role, worker=worker,
    )
    _RECORDER = rec
    _TAPPED_LOG = events
    if events is not None:
        events.add_tap(rec.record)
    _install_hooks(atexit_dump=atexit_dump, signals=signals)
    return rec


def get_recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def uninstall_recorder() -> None:
    """Detach the current recorder (tests / context teardown).  The
    death hooks stay installed but become no-ops."""
    global _RECORDER, _TAPPED_LOG, _ATEXIT_DUMP
    if _RECORDER is not None and _TAPPED_LOG is not None:
        try:
            _TAPPED_LOG.remove_tap(_RECORDER.record)
        except Exception:
            pass
    _RECORDER = None
    _TAPPED_LOG = None
    _ATEXIT_DUMP = False


def probe(name: str, fn: Callable[[], Any]) -> None:
    """Register a health probe in the SHARED registry: one entry feeds
    both the blackbox microsnapshots (of whatever recorder is current)
    and the telemetry ResourceMonitor — no double registration, no
    double sampling.  Never gates on a recorder being installed."""
    with _PROBE_LOCK:
        _SHARED_PROBES[name] = fn


def unprobe(name: str) -> None:
    """Remove *name* everywhere — the shared registry and the current
    recorder's instance probes."""
    with _PROBE_LOCK:
        _SHARED_PROBES.pop(name, None)
    rec = _RECORDER
    if rec is not None:
        rec.unprobe(name)


def dump_now(reason: str) -> Optional[str]:
    """Dump the process blackbox now (no-op without a recorder)."""
    rec = _RECORDER
    if rec is not None:
        return rec.dump(reason)
    return None
