"""Span export and the profiler hook: dryad_tpu_torch/obs/trace.py,
``Tracer.current_id``/``traced`` of obs/span.py and the executor's
``config.profile_dir`` session, against the JAX package.

- The same event streams (a real port job's log, and synthetic streams
  with worker telemetry, prefetch and dispatch counters and resource
  samples) give byte-equal Chrome traces through both packages'
  ``write_chrome_trace``; a port log's trace is valid JSON with one
  ``X`` slice for each ``span`` event.
- The tracer's decorator and explicit parents give the reference's
  span events (clocks and ids aside).
- ``profile_dir`` on the CPU: a small ``group_by`` writes one
  torch.profiler Chrome trace holding one ``record_function`` range
  for each dispatched stage attempt; a ``do_while`` under ``profile_dir`` gives
  the reference's rows and one trace (the nested runs record into the
  top-level session); a job under a caller's own profiler writes no
  trace and logs ``profile_trace`` with ``skipped``.
"""

import json
import os

import numpy as np
import pytest
import torch

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.exec.events import EventLog as JEventLog
from dryad_tpu.obs import span as jspan
from dryad_tpu.obs import trace as jtrace
from dryad_tpu_torch.exec import faults as TX
from dryad_tpu_torch.exec.events import EventLog as TEventLog
from dryad_tpu_torch.obs import span as tspan
from dryad_tpu_torch.obs import trace as ttrace

P = 8


@pytest.fixture(autouse=True)
def clear_port_faults():
    TX.clear_faults()
    yield
    TX.clear_faults()


def _port_log(**cfg):
    tc = T.DryadContext(num_partitions_=P, device="cpu",
                        config=T.DryadConfig(retry_backoff_base=0.001, **cfg))
    rng = np.random.default_rng(1)
    t = {"k": rng.integers(-30, 30, 1000).astype(np.int32), "v": rng.standard_normal(1000).astype(np.float32)}
    TX.set_fake_stage_failure("group_by", 1)
    tc.from_arrays(t).group_by("k", {"c": ("count", None), "s": ("sum", "v")}).order_by([("c", True)]).collect()
    return tc


SYNTHETIC = [
    {"ts": 10.0, "mono": 1.0, "kind": "job_start", "stages": 1},
    {"ts": 10.2, "mono": 1.2, "kind": "span", "name": "pull", "cat": "prefetch", "span_id": 1,
     "parent_id": None, "dur": 0.15, "thread": "prefetch-0", "rows": 10},
    {"ts": 10.25, "kind": "stream_prefetch", "pipeline": "p", "in_flight": 2, "queued": 1},
    {"ts": 10.3, "kind": "dispatch_gap", "pipeline": "w", "in_flight": 0, "gap_s": 0.01},
    {"ts": 10.35, "kind": "resource_sample", "source": "device", "hbm_used_bytes": 5,
     "hbm_limit_bytes": 10, "hbm_headroom_bytes": 5},
    {"ts": 10.36, "kind": "resource_sample", "source": "host"},
    {"ts": 10.4, "kind": "metrics", "counters": [], "hists": []},
    {"ts": 10.5, "kind": "span", "name": "map", "cat": "execute", "span_id": 2, "parent_id": None,
     "dur": 0.2, "thread": "MainThread", "worker": 1},
    {"ts": 10.6, "kind": "stage_failed", "stage": 3, "name": "map", "worker": 0},
    {"ts": 10.9, "kind": "job_complete"},
    {"kind": "note"},  # no clock: left out
]


@pytest.mark.parametrize("source", ["port_log", "synthetic", "empty"])
def test_chrome_trace_is_byte_equal_to_the_reference(tmp_path, source):
    if source == "port_log":
        events = _port_log().events.events()
    else:
        events = SYNTHETIC if source == "synthetic" else []
    outs = []
    for mod, title in ((jtrace, "job"), (ttrace, "job")):
        path = str(tmp_path / f"{mod.__name__}.json")
        mod.write_chrome_trace(events, path, title=title)
        outs.append(open(path).read())
    assert outs[1] == outs[0]
    assert ttrace.chrome_trace(events) == jtrace.chrome_trace(events)
    doc = json.loads(outs[1])
    if source == "port_log":
        slices = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        spans = [e for e in events if e["kind"] == "span"]
        assert len(slices) == len(spans)
        assert sum(e["cat"] == "execute" for e in slices) == \
            sum(e.get("cat") == "execute" for e in spans) >= 1
        assert any(e["name"] == "stage_failed" for e in doc["traceEvents"])
        assert any(e["ph"] == "C" and e["name"] == "resources" for e in doc["traceEvents"])
    elif source == "synthetic":
        names = {e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
        assert {"driver", "worker1", "worker0", "prefetch-0", "MainThread", "events"} <= names


def _traced_events(mod, log_cls):
    log = log_cls(None)
    tr = mod.Tracer(log)

    @tr.traced(cat="driver", tag="x")
    def work(n):
        with tr.span("inner", cat="execute", rows=n):
            parent = tr.current_id()
        with tr.span("handoff", cat="prefetch", parent=parent):
            pass
        with tr.span("orphan", parent=None):
            pass
        return n

    assert work(3) == 3 and tr.current_id() is None
    return log.events()


def test_tracer_decorator_and_explicit_parents_equal_the_reference():
    def shape(events):
        ids = {}

        def num(v):
            return None if v is None else ids.setdefault(v, len(ids))

        return [{**{k: v for k, v in e.items() if k not in ("ts", "mono", "dur", "span_id",
                                                            "parent_id")},
                 "span_id": num(e["span_id"]), "parent_id": num(e["parent_id"])} for e in events]

    ref, port = (shape(_traced_events(m, L)) for m, L in ((jspan, JEventLog), (tspan, TEventLog)))
    assert port == ref
    assert [e["name"] for e in port] == ["inner", "handoff", "orphan", "work"]
    work = port[-1]
    assert port[0]["parent_id"] == work["span_id"] and port[1]["parent_id"] == port[0]["span_id"]
    assert port[2]["parent_id"] is None and work["tag"] == "x"


def _traces(pdir):
    return sorted(os.path.join(pdir, f) for f in os.listdir(pdir)) if os.path.isdir(pdir) else []


def test_profile_dir_writes_a_trace_with_one_range_per_stage_attempt(tmp_path):
    pdir = str(tmp_path / "prof")
    tc = _port_log(profile_dir=pdir)
    (path,) = _traces(pdir)
    written = tc.events.filter("profile_trace")
    assert [e["path"] for e in written] == [path]
    doc = json.load(open(path))
    names = [e.get("name") for e in doc["traceEvents"]]
    # one range per dispatched attempt: each execute span; the attempt
    # the injected failure stopped before its dispatch has neither
    attempts = [e["name"] for e in tc.events.filter("span") if e["cat"] == "execute"]
    assert attempts and tc.events.filter("stage_failed")
    for name in set(attempts):
        assert names.count(name) == attempts.count(name), name


def test_profile_dir_with_do_while_gives_the_reference_rows(tmp_path):
    def body(q):
        return q.select(lambda c: {"v": c["v"] * 2.0})

    def cond(q):
        return q.aggregate_as_query({"m": ("max", "v")}).select(lambda c: {"go": c["m"] < 8.0})

    outs = []
    for c in (J.DryadContext(num_partitions_=P, config=J.DryadConfig(profile_dir=str(tmp_path / "j"))),
              T.DryadContext(num_partitions_=P, config=T.DryadConfig(profile_dir=str(tmp_path / "t")),
                             device="cpu")):
        outs.append(c.from_arrays({"v": np.ones(64, np.float32)}).do_while(body, cond, max_iter=10).collect())
        if isinstance(c, T.DryadContext):
            tc = c
    np.testing.assert_array_equal(outs[1]["v"], outs[0]["v"])
    assert float(outs[1]["v"][0]) == 8.0
    # the body and condition subplans recorded into the job's session
    assert len(_traces(str(tmp_path / "t"))) == 1
    assert [e["path"] for e in tc.events.filter("profile_trace")] == _traces(str(tmp_path / "t"))


def test_a_caller_profiler_takes_the_job_and_the_executor_says_so(tmp_path):
    pdir = str(tmp_path / "prof")
    tc = T.DryadContext(num_partitions_=P, device="cpu", config=T.DryadConfig(profile_dir=pdir))
    q = tc.from_arrays({"k": np.arange(100, dtype=np.int32) % 7}).group_by("k", {"c": ("count", None)})
    with torch.profiler.profile() as prof:
        out = q.collect()
    assert sorted(out["k"].tolist()) == list(range(7))
    assert _traces(pdir) == []
    (ev,) = tc.events.filter("profile_trace")
    assert ev["path"] is None and ev["skipped"] == "profiler_active"
    # the caller's session recorded the job's stage ranges
    starts = {e["name"] for e in tc.events.filter("stage_start")}
    assert starts <= {e.key for e in prof.key_averages()}
    # with no profiler open, the next job writes its own trace
    q.collect()
    assert len(_traces(pdir)) == 1
