"""Query tracing, the critical-path fold, the rolling SLO store and the
flight recorder: the port (dryad_tpu_torch, device="cpu") against the
JAX package, after tests/test_query_trace.py's tracectx and critpath
cases.

Host code, so the tolerance is zero: the same events give the same fold
and the same quantiles in both packages, a collect's events carry one
``qid`` (compared with the reference's after renumbering qids in order
of first appearance, as ids are compared elsewhere), and
``query_trace=False`` leaves every event unstamped.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.exec.events import QUERY_SCOPED_KINDS as J_SCOPED
from dryad_tpu.obs import critpath as jcrit
from dryad_tpu.obs import telemetry as jtel
from dryad_tpu.obs import tracectx as jtrace
from dryad_tpu_torch.exec.events import EventLog
from dryad_tpu_torch.exec.events import QUERY_SCOPED_KINDS as T_SCOPED
from dryad_tpu_torch.exec.pipeline import DispatchWindow
from dryad_tpu_torch.obs import critpath, flightrec, telemetry, tracectx

P = 8


# -- TraceContext ----------------------------------------------------------------

@pytest.mark.parametrize("mod", [tracectx, jtrace], ids=["port", "ref"])
def test_tracectx_mint_activate_and_wire_round_trip(mod):
    assert mod.current() is None and mod.current_qid() is None
    ctx = mod.mint(tenant="t0", fingerprint="fp")
    assert ctx.qid.startswith(f"q-{os.getpid()}-")
    with mod.activate(ctx):
        assert mod.current() is ctx and mod.current_qid() == ctx.qid
        with mod.activate(mod.mint(qid="inner")):
            assert mod.current_qid() == "inner"
        with mod.activate(None):  # a handoff that captured nothing
            assert mod.current_qid() == ctx.qid
        assert mod.current_qid() == ctx.qid
    assert mod.current() is None
    back = mod.TraceContext.from_wire(ctx.to_wire())
    assert (back.qid, back.tenant, back.fingerprint) == (ctx.qid, "t0", "fp")
    assert ctx.to_wire() == jtrace.TraceContext.from_wire(ctx.to_wire()).to_wire()
    assert mod.TraceContext.from_wire(None) is None
    assert mod.TraceContext.from_wire({"tenant": "x"}) is None
    seen = []

    def worker(captured):
        with mod.activate(captured):
            seen.append(mod.current_qid())

    with mod.activate(mod.mint(qid="xthread")):
        th = threading.Thread(target=worker, args=(mod.current(),))
        th.start()
        th.join()
    assert seen == ["xthread"]


def test_query_scoped_kinds_equal_the_reference():
    assert T_SCOPED == J_SCOPED


# -- critical-path fold --------------------------------------------------------------

def _span(ts, dur, name, cat, qid="q1", sid=None, parent=None, **kw):
    return dict(kind="span", ts=ts, dur=dur, name=name, cat=cat, qid=qid,
                span_id=sid or f"{name}@{ts}", parent_id=parent, **kw)


FOLD_STREAMS = {
    "overlap": [
        {"kind": "query_admitted", "ts": 0.0, "query": "q1", "tenant": "a"},
        _span(8.0, 6.0, "execute", "execute", sid="e"),
        _span(8.0, 2.0, "fetch", "readback", sid="r", parent="e"),
        _span(7.0, 4.0, "prefetch", "prefetch", sid="p"),
        {"kind": "query_complete", "ts": 10.0, "query": "q1", "tenant": "a", "ok": True,
         "seconds": 10.0, "cached": False},
    ],
    "compile_and_exchange": [
        _span(5.0, 5.0, "execute", "execute", sid="e"),
        {"kind": "xla_compile", "ts": 3.0, "compile_s": 1.5, "trace_s": 0.5, "qid": "q1"},
        {"kind": "exchange_round", "ts": 4.0, "qid": "q1", "bytes": 128, "rounds": 1},
        {"kind": "exchange_round", "ts": 4.5, "qid": "q1", "bytes": 72},
        {"kind": "dispatch_gap", "ts": 4.6, "qid": "q1", "gap_s": 0.25},
        {"kind": "diagnosis", "ts": 4.7, "qid": "q1", "check": "x", "severity": "info",
         "stage": "s"},
    ],
    "two_queries": [
        _span(1.0, 1.0, "execute", "execute", qid="a"),
        _span(2.0, 1.0, "cache_probe", "serve", qid="b"),
        {"kind": "result_cache_hit", "ts": 2.5, "query": "b", "tenant": "t", "rows": 1},
        {"kind": "query_complete", "ts": 3.0, "query": "b", "tenant": "t", "ok": True,
         "seconds": 1.0, "cached": True},
    ],
}


@pytest.mark.parametrize("name", sorted(FOLD_STREAMS))
def test_the_same_events_give_the_same_fold(name):
    evs = FOLD_STREAMS[name]
    port, ref = critpath.fold_all(evs), jcrit.fold_all(evs)
    assert list(port) == list(ref) == critpath.query_ids(evs) == jcrit.query_ids(evs)
    for qid in port:
        assert port[qid].as_dict() == ref[qid].as_dict()
        assert port[qid].format() == ref[qid].format()
        assert sum(port[qid].phases.values()) == pytest.approx(port[qid].total_s)
    assert critpath.format_queries(port) == jcrit.format_queries(ref)
    assert critpath.fold_query(evs, "nope") is None


# -- the rolling store -----------------------------------------------------------------

def _fill(mod, clock):
    store = mod.RollingStore(window_s=60.0, buckets=6, clock=lambda: clock[0])
    for i, v in enumerate((0.1, 0.3, 0.7, 1.5, 0.0, 6.0, 0.02)):
        clock[0] = i * 7.0
        store.observe_latency("query_latency_s", v, tenant="t")
        store.incr("queries_completed", tenant="t" if i % 2 else "u")
        store.set_gauge("serve_queue_depth", i)
    clock[0] = 75.0  # the first two sub-windows expired
    return store


def test_rolling_store_and_prometheus_text_equal_the_reference():
    a, b = [0.0], [0.0]
    port, ref = _fill(telemetry, a), _fill(jtel, b)
    assert port.snapshot() == ref.snapshot()
    assert port.percentiles("query_latency_s", tenant="t") == ref.percentiles(
        "query_latency_s", tenant="t")
    assert port.counter_total("queries_completed", tenant="u") == ref.counter_total(
        "queries_completed", tenant="u")
    assert port.label_sets("queries_completed") == ref.label_sets("queries_completed")
    assert telemetry.prometheus_text(port.snapshot()) == jtel.prometheus_text(ref.snapshot())
    vals = [0.0, 1e-9, 0.25, 0.3, 1.0, 3.0, 1e6]
    assert [telemetry.latency_bucket(v) for v in vals] == [jtel.latency_bucket(v) for v in vals]
    assert telemetry.percentile_of(vals, 0.95) == jtel.percentile_of(vals, 0.95)
    assert set(telemetry.METRIC_KEYS) <= set(jtel.METRIC_KEYS)
    assert telemetry.resolve_depth(-1) == 2 and telemetry.resolve_depth(3) == 3


# -- collect: one qid, spans stamped, the fold covers the wall ----------------------------

def _table(seed=0, n=512):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 13, n).astype(np.int32), "v": rng.random(n).astype(np.float32)}


def _renumbered_qids(events):
    seen = {}
    return [(e["kind"], seen.setdefault(e["qid"], len(seen))) for e in events
            if e.get("qid") is not None]


def test_collect_stamps_one_qid_as_the_reference_does():
    t = _table()
    jc = J.DryadContext(num_partitions_=P)
    tc = T.DryadContext(num_partitions_=P, device="cpu")
    for c in (jc, tc):
        q = c.from_arrays(t).group_by("k", {"s": ("sum", "v")})
        q.collect()
        q.collect()
    evs = tc.events.events()
    qids = critpath.query_ids(evs)
    assert len(qids) == 2
    spans = [e for e in evs if e["kind"] == "span"]
    assert spans and all(s["qid"] in qids for s in spans)
    # the reference's execute spans carry the same qids, renumbered
    jspans = [e for e in jc.events.events() if e["kind"] == "span" and e["cat"] == "execute"]
    assert _renumbered_qids(spans) == _renumbered_qids(jspans)
    for qid in qids:
        bd = critpath.fold_query(evs, qid)
        assert sum(bd.phases.values()) == pytest.approx(bd.total_s)
        assert bd.phases.get("dispatch", 0) > 0


def test_stream_query_stamps_its_pipeline_events():
    chunks = [_table(i, 300) for i in range(4)]
    tc = T.DryadContext(num_partitions_=P, device="cpu",
                        config=T.DryadConfig(stream_bucket_rows=256, stream_combine_rows=256))
    tc.from_stream(iter([dict(c) for c in chunks])).group_by("k", {"s": ("sum", "v")}).collect()
    evs = tc.events.events()
    (qid,) = critpath.query_ids(evs)
    scoped = [e for e in evs if e["kind"] in T_SCOPED]
    assert scoped and all(e.get("qid") == qid for e in scoped)
    assert {"span", "dispatch_gap"} & {e["kind"] for e in scoped}
    assert any(e["kind"] == "span" and e["cat"] == "prefetch" for e in scoped)


def test_query_trace_off_leaves_events_unstamped():
    tc = T.DryadContext(num_partitions_=P, device="cpu", config=T.DryadConfig(query_trace=False))
    tc.from_arrays(_table()).distinct("k").collect()
    assert critpath.query_ids(tc.events.events()) == []
    assert any(e["kind"] == "span" for e in tc.events.events())


# -- the dispatch window's gap clamp ------------------------------------------------------

def _drain_all(win):
    out = []
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        out.extend(win.ready())
        if out:
            return out
        time.sleep(0.01)
    raise AssertionError("window never produced an outcome")


def test_dispatch_gap_clamps_to_last_commit_between_queries():
    log = EventLog(None, mem_cap=256)
    win = DispatchWindow(depth=2, events=log, name="clamptest")
    try:
        with tracectx.activate(tracectx.mint(qid="qa")):
            win.submit("a", lambda: tracectx.current_qid())
        assert _drain_all(win)[0][:2] == ("a", "qa")  # the fetch ran under its query
        time.sleep(0.3)
        win.submit("b", lambda: 2)
        assert win.gap_s < 0.2
        gaps = [e for e in log.events() if e["kind"] == "dispatch_gap"]
        assert gaps and gaps[-1]["gap_s"] < 0.2
        assert _drain_all(win)[0][:2] == ("b", 2)
        assert not win.wait(0.01)  # idle: nothing outstanding
    finally:
        win.close()
    fetches = [e for e in log.events() if e["kind"] == "span" and e["name"] == "fetch"]
    assert [e["qid"] for e in fetches] == ["qa", None]
    assert "dispatch:clamptest" not in flightrec.sample_shared_probes()


# -- the flight recorder -------------------------------------------------------------------

def test_flight_recorder_ring_probes_and_dump(tmp_path):
    log = EventLog(None)
    rec = flightrec.install_recorder(capacity=16, snapshot_s=1e-6, dump_dir=str(tmp_path),
                                     events=log)
    try:
        flightrec.probe("serve:queue", lambda: {"queued": 3})
        flightrec.probe("bad", lambda: 1 / 0)
        for i in range(40):
            log.emit("stage_start", stage=i, name="x", version=1, boost=1)
        assert flightrec.get_recorder() is rec and len(rec._ring) == 16
        snaps = list(rec._snapshots)
        assert snaps and snaps[-1]["serve:queue"] == {"queued": 3} and "bad" not in snaps[-1]
        path = flightrec.dump_now("test")
        doc = json.load(open(path))
        assert doc["reason"] == "test" and len(doc["events"]) == 16
        assert doc["events"][-1]["stage"] == 39
    finally:
        flightrec.unprobe("serve:queue")
        flightrec.unprobe("bad")
        flightrec.uninstall_recorder()
    assert flightrec.get_recorder() is None and flightrec.dump_now("gone") is None
    log.emit("stage_start", stage=0, name="x", version=1, boost=1)  # no tap left
