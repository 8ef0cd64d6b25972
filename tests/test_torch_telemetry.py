"""The continuous telemetry plane (dryad_tpu_torch/obs/telemetry.py): the
port against the JAX package, after tests/test_telemetry.py.

Host code, so the tolerance is zero.  Every case runs the same fakes
(an injected clock, injected device-memory readings, the same shared
flightrec probes) through both packages and compares what they return
and the events they emit, field for field, without the clocks (``ts``,
``mono``).  The default contexts of both packages (the sampler on) are
compared by the kind and source of their samples, not by their count,
which follows the wall clock.  The device probe is checked against a
faked ``torch.cuda`` and shown never to initialize CUDA.
"""

import time

import numpy as np
import pytest
import torch

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.exec.events import EventLog as JEventLog
from dryad_tpu.exec.pipeline import DispatchWindow as JDispatchWindow
from dryad_tpu.obs import flightrec as jflightrec
from dryad_tpu.obs import telemetry as jtel
from dryad_tpu.obs.diagnose import DiagnosisEngine as JDiagnosisEngine
from dryad_tpu.rewrite.controller import RewriteController as JRewriteController
from dryad_tpu_torch.exec.events import EventLog as TEventLog
from dryad_tpu_torch.exec.pipeline import DispatchWindow as TDispatchWindow
from dryad_tpu_torch.obs import flightrec as tflightrec
from dryad_tpu_torch.obs import telemetry as ttel
from dryad_tpu_torch.obs.diagnose import DiagnosisEngine as TDiagnosisEngine
from dryad_tpu_torch.rewrite.controller import RewriteController as TRewriteController

P = 8
PKGS = {
    "ref": dict(tel=jtel, log=JEventLog, window=JDispatchWindow, flightrec=jflightrec,
                engine=JDiagnosisEngine, controller=JRewriteController),
    "port": dict(tel=ttel, log=TEventLog, window=TDispatchWindow, flightrec=tflightrec,
                 engine=TDiagnosisEngine, controller=TRewriteController),
}


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def _no_shared_probe_leak():
    """Shared flightrec probes registered by a case leave with it."""
    yield
    for mod in (jflightrec, tflightrec):
        for name in list(mod._SHARED_PROBES):
            mod.unprobe(name)


def _bare(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "mono")} for e in events]


def _both(fn):
    """``fn(pkg)`` for each package: (reference's, port's)."""
    return fn(PKGS["ref"]), fn(PKGS["port"])


# -- measured headroom -> adaptive depth --------------------------------------


def test_headroom_provider_latest_measurement_wins_like_the_reference():
    def run(m):
        p = m["tel"].HeadroomProvider()
        seen = [p.headroom_bytes()]
        p.update(1 << 30)
        seen.append(p.headroom_bytes())
        p.update(None)  # host fallback: measurement withdrawn, not stale
        seen.append(p.headroom_bytes())
        return seen

    ref, port = _both(run)
    assert port == ref == [None, 1 << 30, None]


HEADROOMS = [None, 8 << 30, 4 << 30, (4 << 30) - 1, 2 << 30, 1 << 30, 512 << 20,
             256 << 20, 100, 0]


@pytest.mark.parametrize("config_depth", [-1, 1, 3, 0])
def test_resolve_depth_tiers_equal_the_reference(config_depth):
    def run(m):
        out = [m["tel"].resolve_depth(config_depth, None)]
        p = m["tel"].HeadroomProvider()
        for h in HEADROOMS:
            p.update(h)
            out.append(m["tel"].resolve_depth(config_depth, p))
        return out

    ref, port = _both(run)
    assert port == ref
    if config_depth == -1:
        assert port == [2, 2, 4, 4, 3, 3, 3, 2, 2, 1, 1]


def test_dispatch_window_adaptive_depth_from_a_fake_provider():
    def run(m):
        depths = []
        p = m["tel"].HeadroomProvider()
        p.update(2 << 30)
        for kw in ({"headroom": p}, {}):
            w = m["window"](-1, **kw)
            try:
                depths.append(w.depth)
            finally:
                w.close()
        with pytest.raises(ValueError):
            m["window"](0)  # a static zero is still rejected
        return depths

    ref, port = _both(run)
    assert port == ref == [3, 2]


# -- ResourceMonitor ----------------------------------------------------------


def test_sampler_device_path_equals_the_reference():
    def run(m):
        clk = FakeClock(5.0)
        log = m["log"](None)
        st = m["tel"].RollingStore(clock=clk)
        mon = m["tel"].ResourceMonitor(
            interval_s=1.0, events=log, store=st, clock=clk,
            device_memory_fn=lambda: (3 << 30, 4 << 30),
        )
        m["flightrec"].probe("serve:queue", lambda: {"queued": 5})
        snap = mon.sample()
        gauges = [st.gauge(g) for g in ("hbm_used_bytes", "hbm_limit_bytes",
                                        "hbm_headroom_bytes")]
        return snap, mon.headroom.headroom_bytes(), gauges, _bare(log.events())

    ref, port = _both(run)
    assert port == ref
    snap, headroom, gauges, events = port
    assert snap["source"] == "device" and snap["mono"] == 5.0
    assert headroom == 1 << 30 and gauges == [3 << 30, 4 << 30, 1 << 30]
    assert events == [{"kind": "resource_sample", "source": "device",
                       "hbm_used_bytes": 3 << 30, "hbm_limit_bytes": 4 << 30,
                       "hbm_headroom_bytes": 1 << 30,
                       "probes": {"serve:queue": {"queued": 5}}}]


def test_sampler_host_fallback_withdraws_headroom_like_the_reference():
    def run(m):
        clk = FakeClock()
        st = m["tel"].RollingStore(clock=clk)
        log = m["log"](None)
        mon = m["tel"].ResourceMonitor(interval_s=1.0, events=log, store=st, clock=clk,
                                       device_memory_fn=lambda: None)
        mon.headroom.update(1 << 30)  # a stale device reading must not survive
        snap = mon.sample()
        return (snap["source"], "rss_kb" in snap, mon.headroom.headroom_bytes(),
                st.gauge("host_rss_kb") is not None,
                [sorted(e) for e in _bare(log.events())])

    ref, port = _both(run)
    assert port == ref
    assert port[0] == "host" and port[2] is None


def test_tap_pacing_under_an_injected_clock_equals_the_reference():
    def run(m):
        clk = FakeClock(0.0)
        log = m["log"](None)
        mon = m["tel"].ResourceMonitor(interval_s=1.0, events=log, clock=clk,
                                       device_memory_fn=lambda: (1, 2))
        log.add_tap(mon.observe)
        counts = []
        for t, text in ((0.0, "a"), (0.0, "b"), (0.5, "c"), (1.5, "d")):
            clk.t = t
            log.emit("note", text=text)
            counts.append(len(log.filter("resource_sample")))
        # a poisoned reader never raises through the tap
        clk.t = 10.0
        mon._device_memory = lambda: (_ for _ in ()).throw(RuntimeError("x"))
        log.emit("note", text="e")
        counts.append(len(log.filter("resource_sample")))
        return counts, _bare(log.events())

    ref, port = _both(run)
    assert port == ref
    assert port[0] == [1, 1, 1, 2, 2]


def test_sample_ring_is_bounded_like_the_reference():
    def run(m):
        clk = FakeClock()
        mon = m["tel"].ResourceMonitor(interval_s=1.0, clock=clk, history=4,
                                       device_memory_fn=lambda: (1, 2))
        for i in range(10):
            clk.t = float(i)
            mon.sample()
        return mon.recent()

    ref, port = _both(run)
    assert port == ref and [s["mono"] for s in port] == [6.0, 7.0, 8.0, 9.0]


def test_background_sampler_starts_and_stops():
    log = TEventLog(None)
    mon = ttel.ResourceMonitor(interval_s=0.01, events=log, device_memory_fn=lambda: (1, 4))
    assert mon.start() is mon.start()  # idempotent
    deadline = time.monotonic() + 10.0
    while not log.filter("resource_sample") and time.monotonic() < deadline:
        time.sleep(0.01)
    mon.stop()
    mon.stop()  # a second stop is a no-op
    n = len(log.filter("resource_sample"))
    assert n >= 1 and mon._thread is None


# -- hbm_pressure: diagnosis -> rewriter hint ---------------------------------


def _pressure_ev(used, limit):
    return {"kind": "resource_sample", "source": "device", "hbm_used_bytes": used,
            "hbm_limit_bytes": limit, "hbm_headroom_bytes": max(0, limit - used)}


def test_hbm_pressure_fires_at_the_reference_ratio():
    def run(m):
        log = m["log"](None, mem_cap=256)
        eng = m["engine"](events=log)
        log.add_tap(eng.observe)
        seen = []
        for used in (90, 91, 92, 95):
            log.emit(**_pressure_ev(used=used, limit=100))
            seen.append([(d["rule"], d["evidence"]) for d in eng.diagnoses()])
        log.emit(kind="resource_sample", source="host", rss_kb=123)
        return seen, [e for e in _bare(log.events()) if e["kind"] == "diagnosis"]

    ref, port = _both(run)
    assert port == ref
    seen, _ = port
    assert seen[0] == seen[1] == []
    assert seen[2] == [("hbm_pressure", {"used": 92, "limit": 100, "ratio": 0.92, "headroom": 8})]


def test_hbm_pressure_pins_the_exchange_window_once_like_the_reference():
    ev = {"kind": "diagnosis", "rule": "hbm_pressure",
          "evidence": {"used": 95, "limit": 100, "ratio": 0.95, "headroom": 5}}

    def run(m):
        log = m["log"](None)
        c = m["controller"](events=log)
        c.observe(ev)
        first = (c.exchange_window_hint(), len(c.actions()))
        c.observe(ev)  # pressure persists: the pin stays, no re-decision
        return first, (c.exchange_window_hint(), len(c.actions())), _bare(log.events())

    ref, port = _both(run)
    assert port == ref
    assert port[0] == (1, port[1][1]) and port[1][0] == 1


# -- the device probe -----------------------------------------------------------


def test_device_probe_takes_the_host_fallback_off_cuda():
    assert ttel.device_memory_probe("cpu")() is None
    assert ttel.device_memory_probe(torch.device("cpu"))() is None


def test_device_probe_never_initializes_cuda():
    assert not torch.cuda.is_initialized()
    read = ttel.device_memory_probe(torch.device("cuda", 0))
    assert read() is None
    assert not torch.cuda.is_initialized()


def test_device_probe_reads_the_whole_card(monkeypatch):
    """limit = the card's total; headroom = the card's free bytes plus
    the blocks the caching allocator holds unused; used = limit -
    headroom.  Each reader is named the context's device."""
    gib = 1 << 30
    seen = []

    def rec(name, value):
        def fn(device=None):
            seen.append((name, device))
            return value
        return fn

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info", rec("mem_get_info", (30 * gib, 80 * gib)))
    monkeypatch.setattr(torch.cuda, "memory_reserved", rec("memory_reserved", 12 * gib))
    monkeypatch.setattr(torch.cuda, "memory_allocated", rec("memory_allocated", 4 * gib))
    dev = torch.device("cuda", 0)
    used, limit = ttel.device_memory_probe(dev)()
    assert limit == 80 * gib and used == 80 * gib - (30 * gib + 8 * gib)
    assert seen and all(d == dev for _n, d in seen)
    # fed to the sampler, it is the reference's device path
    mon = ttel.ResourceMonitor(device_memory_fn=ttel.device_memory_probe(dev))
    snap = mon.sample()
    assert snap["source"] == "device" and snap["hbm_headroom_bytes"] == 38 * gib
    assert ttel.resolve_depth(-1, mon.headroom) == 4


# -- default contexts ------------------------------------------------------------


def _kinds_and_sources(events):
    return {(e["kind"], e.get("source")) for e in events if e["kind"] == "resource_sample"}


def test_default_contexts_sample_the_host_like_the_reference():
    rng = np.random.default_rng(0)
    t = {"k": rng.integers(-20, 20, 500).astype(np.int32), "v": rng.standard_normal(500).astype(np.float32)}
    jc = J.DryadContext(num_partitions_=P)
    tc = T.DryadContext(num_partitions_=P, device="cpu")
    assert tc.telemetry is not None and tc.headroom is tc.telemetry.headroom
    assert tc.executor.headroom is tc.headroom
    for c in (jc, tc):
        c.from_arrays(t).group_by("k", {"c": ("count", None)}).collect()
    ref, port = _kinds_and_sources(jc.events.events()), _kinds_and_sources(tc.events.events())
    assert port == ref == {("resource_sample", "host")}
    # on the CPU no measurement exists: the adaptive depth is the default
    assert tc.headroom.headroom_bytes() is None and jc.headroom.headroom_bytes() is None
    assert ttel.resolve_depth(-1, tc.headroom) == jtel.resolve_depth(-1, jc.headroom) == 2
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("kw", [{"config": "off"}, {"local_debug": True}])
def test_no_sampler_where_the_reference_has_none(kw):
    if kw.get("config") == "off":
        jc = J.DryadContext(num_partitions_=P, config=J.DryadConfig(obs_telemetry=False))
        tc = T.DryadContext(num_partitions_=P, config=T.DryadConfig(obs_telemetry=False), device="cpu")
    else:
        jc = J.DryadContext(num_partitions_=P, local_debug=True)
        tc = T.DryadContext(num_partitions_=P, local_debug=True, device="cpu")
    for c in (jc, tc):
        assert c.telemetry is None and c.headroom is None
    assert tc.executor.headroom is None
    tc.from_arrays({"k": np.arange(10, dtype=np.int32)}).collect()
    assert not tc.events.filter("resource_sample")


@pytest.mark.parametrize("bad", [0.0, -1.0])
def test_sample_interval_validation_like_the_reference(bad):
    with pytest.raises(ValueError, match="telemetry_sample_s must be > 0"):
        J.DryadConfig(telemetry_sample_s=bad).validate()
    with pytest.raises(ValueError, match="telemetry_sample_s must be > 0"):
        T.DryadContext(config=T.DryadConfig(telemetry_sample_s=bad), device="cpu")


def test_config_defaults_equal_the_reference():
    for f in ("obs_telemetry", "telemetry_sample_s", "profile_dir"):
        assert getattr(T.DryadConfig(), f) == getattr(J.DryadConfig(), f)
    assert T.DryadConfig().obs_telemetry is True
