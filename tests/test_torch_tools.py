"""The job tools (dryad_tpu_torch/tools/jobview.py, metricsd.py,
blackbox.py) and the etl_speculation sample: the port against the JAX
package, after tests/test_tools.py and tests/test_telemetry.py.

Two kinds of jobview case:

- *Same job, each package's log.*  One query runs in each package at
  P=8; the port's jobview renders the port's log and the reference's
  jobview the reference's.  The texts are equal once the clocks are
  masked (seconds, shares, MB readings, the qid and the sampler's
  sample count) and stage ids are renumbered in order of first
  appearance.  One kind of the reference's log is left out before it
  is rendered, because the port cannot emit it: ``xla_compile`` (the
  port has no compile step); ``exchange_round`` is emitted by both
  packages and compared.  Diagnoses of the wall-clock rules are left
  out of both.
- *Same synthetic events, both renderers.*  The event lists of the
  reference's own tests go through both packages' renderers, which
  must give byte-equal output.

metricsd and blackbox: the same JSONL logs, snapshots and dump
directories give byte-equal Prometheus text, JSON snapshots, merged
timelines and Chrome traces through both packages' CLIs.
"""

import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.exec import faults as JX
from dryad_tpu.tools import blackbox as jbb
from dryad_tpu.tools import jobview as JV
from dryad_tpu.tools import metricsd as jmd
from dryad_tpu_torch.exec import faults as TX
from dryad_tpu_torch.obs import flightrec as tflightrec
from dryad_tpu_torch.tools import blackbox as tbb
from dryad_tpu_torch.tools import jobview as TV
from dryad_tpu_torch.tools import metricsd as tmd

P = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def clear_port_faults():
    TX.clear_faults()
    yield
    TX.clear_faults()


# -- same job, each package's log ------------------------------------------------

# kinds only the reference emits: none since the port's stage programs
# log ``xla_compile`` (its seconds are masked with the other clocks)
REF_ONLY: set = set()
CLOCK_RULES = {"straggler", "stall_dominance", "recompile_storm"}


def _norm(events):
    """Events without the reference-only kinds and the wall-clock
    diagnoses, stage ids renumbered in order of first appearance."""
    ids = {}

    def num(v, ns="stage"):
        return ids.setdefault((ns, v), sum(1 for k in ids if k[0] == ns))

    def dep(d):  # a stage id, or ["in", input node id]
        return num(d) if isinstance(d, int) else [d[0], num(d[1], "node")]

    out = []
    for e in events:
        if e["kind"] in REF_ONLY or e["kind"] == "stage_straggler":
            continue
        if e["kind"] == "diagnosis" and e.get("rule") in CLOCK_RULES:
            continue
        e = dict(e)
        if isinstance(e.get("stage"), int):
            e["stage"] = num(e["stage"])
        if "topology" in e:
            e["topology"] = [dict(t, id=num(t["id"]), deps=[dep(d) for d in t.get("deps", [])])
                             for t in e["topology"]]
        out.append(e)
    return out


_QID = re.compile(r"\bq-\d+-\d+")


def _mask(text):
    text = _QID.sub("q-N", text)
    text = re.sub(r"\d+\.\d+", "X", text)
    text = re.sub(r"\d+%", "X%", text)
    text = re.sub(r"\d+MB", "NMB", text)
    text = re.sub(r"telemetry \(\d+ samples\)", "telemetry (N samples)", text)
    # which span was the longest is the clock's choice
    text = re.sub(r"longest span=\S+ \(", "longest span=S (", text)
    # the critical path's residual: the wall time no span covers
    return re.sub(r"  other Xs \(X%\)", "", text)


def _wordcountish(ctx):
    # k includes -1 so the int auto-dense rewrite stays off and the plan
    # keeps its hash exchange
    q = ctx.from_arrays({"k": (np.arange(100, dtype=np.int32) % 7) - 1,
                         "v": np.ones(100, np.float32)})
    return q.group_by("k", {"s": ("sum", "v")}).order_by([("s", True)])


def _ctxs(**cfg):
    return (J.DryadContext(num_partitions_=P, config=J.DryadConfig(**cfg)),
            T.DryadContext(num_partitions_=P, config=T.DryadConfig(**cfg), device="cpu"))


def _views(jc, tc):
    """(reference's, port's) jobview text of each package's log: the
    whole stream render (its last job), every job's report and the
    HTML report."""
    out = []
    for c, V in ((jc, JV), (tc, TV)):
        evs = _norm(c.events.events())
        texts = [V._render_stream(evs)] + [V.render(j) for j in V.build_jobs(evs)]
        out.append(_mask("\n".join(texts + [V.render_html(V.build_job(evs))])))
    return tuple(out)


def test_jobview_clean_job_equals_the_reference():
    jc, tc = _ctxs()
    for c in (jc, tc):
        _wordcountish(c).collect()
    ref, port = _views(jc, tc)
    assert port == ref
    assert "job: OK" in port and "completed cleanly" in port and "-- queries --" in port
    assert "-- telemetry (N samples) --" in port


def test_jobview_recovered_failure_equals_the_reference():
    jc, tc = _ctxs(retry_backoff_base=0.001)
    for c, X in ((jc, JX), (tc, TX)):
        X.set_fake_stage_failure("group_by", 1)
        _wordcountish(c).collect()
    ref, port = _views(jc, tc)
    assert port == ref
    notes = TV.diagnose(TV.build_job(tc.events.events()))
    assert any("recovered" in n and "versioned re-execution" in n for n in notes)


def test_jobview_failed_job_diagnosis_equals_the_reference():
    jc, tc = _ctxs(max_stage_failures=2, retry_backoff_base=0.001)
    for c, X in ((jc, JX), (tc, TX)):
        X.set_fake_stage_failure("group_by", 99)
        with pytest.raises(Exception, match="failure budget"):
            _wordcountish(c).collect()
    ref, port = _views(jc, tc)
    assert port == ref
    assert "FAILED" in port and "failure budget" in port


def test_jobview_multi_job_log_equals_the_reference():
    jc, tc = _ctxs()
    for c in (jc, tc):
        _wordcountish(c).collect()
        _wordcountish(c).collect()
    ref, port = _views(jc, tc)
    assert port == ref
    jobs = TV.build_jobs(tc.events.events())
    assert len(jobs) == 2 and len(TV.build_job(tc.events.events()).stages) == len(jobs[0].stages)


def test_jobview_stage_attempt_history_and_corruption_equal_the_reference(tmp_path):
    views = []
    for pkg, X in (("ref", JX), ("port", TX)):
        cfg = dict(checkpoint_dir=str(tmp_path / pkg), retry_backoff_base=0.001)
        ctxs = []
        for _ in range(2):
            c = (J.DryadContext(num_partitions_=P, config=J.DryadConfig(**cfg)) if pkg == "ref"
                 else T.DryadContext(num_partitions_=P, config=T.DryadConfig(**cfg), device="cpu"))
            if not ctxs:
                X.set_fake_stage_failure("group_by", 1)
                X.set_fake_checkpoint_corruption(1)
            _wordcountish(c).collect()
            ctxs.append(c)
        V = JV if pkg == "ref" else TV
        views.append([_mask(V._render_stream(_norm(c.events.events()))) for c in ctxs])
    assert views[1] == views[0]
    first, second = views[1]
    assert "attempt history" in first and "transient" in first
    assert "corrupt checkpoint" in second and "CRC" in second


def test_jobview_combine_tree_panel_equals_the_reference():
    rng = np.random.default_rng(5)
    chunks = [{"k": rng.integers(0, 3000, 2000).astype(np.int32),
               "v": rng.integers(-50, 50, 2000).astype(np.int32)} for _ in range(8)]
    jc, tc = _ctxs(stream_combine_rows=1024, combine_tree_fan=2)
    for c in (jc, tc):
        q = c.from_stream(iter([{k: v.copy() for k, v in ch.items()} for ch in chunks]))
        q.group_by("k", {"c": ("count", None), "s": ("sum", "v")}).collect()
    # the port compacts each partial and merge to its rows, so the
    # layout bytes of its merges are its own (tests/test_torch_combinetree.py::
    # test_tree_batches_are_compacted_on_the_same_cadence), and so are the
    # capacities its merge programs are keyed by (two more compiles at this
    # size); the levels, merge counts and layout rows are the reference's
    ref, port = (re.sub(r"\(\d+ compiles", "(N compiles", re.sub(r"(in|ici|dcn)=\d+B", r"\1=NB", t))
                 for t in _views(jc, tc))
    assert port == ref
    assert "combine tree:" in port and "level 0: merges=" in port


def test_jobview_serve_queries_and_tenants_panels_equal_the_reference():
    from dryad_tpu.serve.service import QueryService as JService
    from dryad_tpu_torch.serve.service import QueryService as TService

    rng = np.random.default_rng(2)
    t = {"k": rng.integers(-20, 20, 800).astype(np.int32), "v": rng.standard_normal(800).astype(np.float32)}
    texts = []
    for c, S, V in ((J.DryadContext(num_partitions_=P), JService, JV),
                    (T.DryadContext(num_partitions_=P, device="cpu"), TService, TV)):
        with S(c) as svc:
            for tenant in ("a", "b", "a"):
                svc.session(tenant).run(c.from_arrays(t).group_by("k", {"n": ("count", None)}))
        evs = _norm(c.events.events())
        texts.append("\n".join(_mask(f(evs)) for f in (V.render_queries, V.render_tenants)))
    assert texts[1] == texts[0]
    assert "-- queries --" in texts[1] and "[a]" in texts[1] and "-- tenants --" in texts[1]


def test_jobview_cli_renders_a_port_log(tmp_path, capsys):
    tc = T.DryadContext(num_partitions_=P, config=T.DryadConfig(event_log_dir=str(tmp_path)), device="cpu")
    _wordcountish(tc).collect()
    tc.events.close()
    (log,) = glob.glob(str(tmp_path / "*.jsonl"))
    assert TV.main([log]) == 0
    out = capsys.readouterr().out
    assert "job: OK" in out
    html = str(tmp_path / "r.html")
    assert TV.main(["--html", html, log]) == 0 and "<svg" in open(html).read()
    trace = str(tmp_path / "t.json")
    assert TV.main(["--trace", trace, log]) == 0
    assert json.load(open(trace))["traceEvents"]
    assert TV.main([]) == 2
    r = subprocess.run([sys.executable, "-m", "dryad_tpu_torch.tools.jobview", log],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0 and "job: OK" in r.stdout


# -- same synthetic events, both renderers ---------------------------------------

VERTEX_EVENTS = [
    {"ts": 1.0, "kind": "worker_joined", "worker": 0},
    {"ts": 1.1, "kind": "worker_joined", "worker": 1},
    {"ts": 2.0, "kind": "vertex_job_start", "seq": 1, "nparts": 3},
    {"ts": 2.5, "kind": "vertex_complete", "part": 0, "seconds": 0.4, "computer": "worker0"},
    {"ts": 2.6, "kind": "vertex_duplicate", "part": 1, "threshold": 0.5, "elapsed": 1.2},
    {"ts": 2.9, "kind": "vertex_duplicate_win", "part": 1, "winner": "worker0", "seconds": 0.3},
    {"ts": 2.9, "kind": "vertex_complete", "part": 1, "seconds": 0.3, "computer": "worker0"},
    {"ts": 3.0, "kind": "vertex_retry", "part": 2, "attempt": 2, "computer": "worker1",
     "error": "RuntimeError: injected", "backoff": 0.07, "failure_kind": "transient"},
    {"ts": 3.4, "kind": "vertex_complete", "part": 2, "seconds": 0.4, "computer": "worker1"},
    {"ts": 3.5, "kind": "assemble_fetch", "parts": 3, "wire_bytes": 1000, "raw_bytes": 9000},
    {"ts": 3.6, "kind": "vertex_job_complete", "seq": 1},
]

CODED_EVENTS = [
    {"ts": 1.0, "kind": "coded_job_start", "seq": 3, "k": 3, "n": 5, "r": 2, "agg": "group"},
    {"ts": 1.2, "kind": "coded_task_complete", "coded": 0, "parity": False, "seconds": 0.2,
     "computer": "worker0"},
    {"ts": 1.3, "kind": "coded_task_failed", "coded": 1, "parity": False, "error": "boom",
     "failure_kind": "transient"},
    {"ts": 1.3, "kind": "coded_launch", "seq": 3, "k": 3, "n": 5, "r": 2, "trigger": "failure",
     "threshold": None},
    {"ts": 1.9, "kind": "coded_task_complete", "coded": 3, "parity": True, "seconds": 0.7,
     "computer": "worker0"},
    {"ts": 2.1, "kind": "coded_task_complete", "coded": 4, "parity": True, "seconds": 0.9,
     "computer": "worker2"},
    {"ts": 2.1, "kind": "coded_cancel", "seq": 3, "canceled": 1},
    {"ts": 2.1, "kind": "coded_waste_bytes", "seq": 3, "bytes": 1234, "unused": []},
    {"ts": 2.2, "kind": "coded_reconstruct", "seq": 3, "used": [0, 3, 4], "parity_used": 2,
     "exact": True, "amplification": 1.7, "seconds": 0.004},
    {"ts": 2.3, "kind": "coded_job_complete", "seq": 3, "seconds": 1.5},
]

MEMBERSHIP_EVENTS = [
    {"ts": 1, "kind": "worker_joined", "worker": 0},
    {"ts": 1, "kind": "worker_joined", "worker": 1},
    {"ts": 2, "kind": "vertex_job_start", "seq": 1, "nparts": 1},
    {"ts": 3, "kind": "vertex_complete", "part": 0, "seconds": 0.1, "computer": "worker0"},
    {"ts": 4, "kind": "vertex_job_complete", "seq": 1},
    {"ts": 5, "kind": "worker_dead", "worker": 1},
    {"ts": 6, "kind": "vertex_job_start", "seq": 2, "nparts": 1},
    {"ts": 7, "kind": "vertex_complete", "part": 0, "seconds": 0.1, "computer": "worker0"},
    {"ts": 8, "kind": "vertex_job_complete", "seq": 2},
]

HEALTH_EVENTS = [
    {"ts": 1.0, "kind": "vertex_job_start", "seq": 1, "nparts": 1},
    {"ts": 1.1, "kind": "process_failed", "process": "part0-a0", "computer": "worker1",
     "error": "RuntimeError: bad disk"},
    {"ts": 1.2, "kind": "process_failed", "process": "part0-a1", "computer": "worker1",
     "error": "RuntimeError: bad disk"},
    {"ts": 1.3, "kind": "computer_quarantined", "computer": "worker1", "failures": 3,
     "cooldown": 30.0, "probation": False},
    {"ts": 2.0, "kind": "computer_probation", "computer": "worker1"},
    {"ts": 2.5, "kind": "computer_readmitted", "computer": "worker1"},
    {"ts": 3.0, "kind": "vertex_complete", "part": 0, "seconds": 0.1, "computer": "worker0"},
    {"ts": 3.1, "kind": "vertex_job_complete", "seq": 1},
]

SUBMISSION_EVENTS = [
    {"ts": 1, "kind": "worker_joined", "worker": 0},
    {"ts": 2, "kind": "gang_run_start", "seq": 1, "workers": 2},
    {"ts": 3, "kind": "gang_run_complete", "seq": 1, "seconds": 1.25},
    {"ts": 4, "kind": "vertex_job_start", "seq": 2, "nparts": 1},
    {"ts": 5, "kind": "vertex_complete", "part": 0, "seconds": 0.2, "computer": "worker0"},
    {"ts": 6, "kind": "vertex_job_complete", "seq": 2},
    {"ts": 7, "kind": "gang_run_start", "seq": 3, "workers": 2},
    {"ts": 8, "kind": "gang_straggler", "seq": 3, "seconds": 9.0, "threshold": 2.0},
    {"ts": 9, "kind": "gang_run_complete", "seq": 3, "seconds": 9.0},
    {"ts": 10, "kind": "gang_run_start", "seq": 4, "workers": 2},
]

TELEMETRY_EVENTS = [
    {"kind": "query_admitted", "tenant": "a"},
    {"kind": "query_admitted", "tenant": "b"},
    {"kind": "query_complete", "tenant": "a", "seconds": 0.3},
    {"kind": "query_complete", "tenant": "b", "seconds": 1.0},
    {"kind": "result_cache_hit", "tenant": "a"},
    {"kind": "query_rejected", "tenant": "b"},
    {"kind": "resource_sample", "source": "device", "hbm_used_bytes": 10 << 30,
     "hbm_limit_bytes": 80 << 30, "hbm_headroom_bytes": 70 << 30,
     "probes": {"serve:queue": {"queued": 3}}},
    {"kind": "resource_sample", "source": "host", "rss_kb": 2048},
]

COMBINE_EVENTS = [
    {"kind": "job_start", "stages": 0},
    {"kind": "combine_tree_level", "level": 0, "group": 0, "fan_in": 3, "cap_rows": 4096,
     "bytes": 1000, "ici_bytes": 0, "dcn_bytes": 0, "device": True},
    {"kind": "combine_tree_level", "level": 0, "group": 1, "fan_in": 2, "cap_rows": 2048,
     "bytes": 500, "ici_bytes": 0, "dcn_bytes": 0, "device": True},
    {"kind": "combine_tree_level", "level": 1, "fan_in": 2, "cap_rows": 4096, "bytes": 1500,
     "ici_bytes": 900, "dcn_bytes": 40, "device": True},
    {"kind": "combine_tree_degrade", "degraded": 8, "fraction": 0.125, "chunks": 5},
    {"kind": "job_complete"},
]

OVERFLOW_EVENTS = [
    {"ts": 0.0, "kind": "job_start", "stages": 1},
    {"ts": 0.1, "kind": "stage_start", "stage": 3, "name": "join", "version": 1, "boost": 1},
    {"ts": 0.2, "kind": "stage_overflow", "stage": 3, "name": "join", "version": 1, "boost": 1},
    {"ts": 0.3, "kind": "stage_start", "stage": 3, "name": "join", "version": 2, "boost": 8},
    {"ts": 0.4, "kind": "stage_overflow", "stage": 3, "name": "join", "version": 2, "boost": 8},
    {"ts": 0.5, "kind": "job_failed", "stage": 3, "name": "join"},
]


def _renders(V):
    """Every renderer over the synthetic lists, as one list of texts."""
    out = []
    for j in V.build_vertex_jobs(VERTEX_EVENTS) + V.build_vertex_jobs(MEMBERSHIP_EVENTS):
        out += [V.render_vertex_job(j), repr((j.workers_joined, j.workers_dead, j.duplicated,
                                              j.dup_wins, j.retries))]
    for c in V.build_coded_jobs(CODED_EVENTS):
        out.append(V.render_coded_job(c))
    for evs in (CODED_EVENTS, CODED_EVENTS[:-1], HEALTH_EVENTS, SUBMISSION_EVENTS, VERTEX_EVENTS):
        out.append(repr(V.fold_submission(evs)))
    out.append(V.render_computer_health(V.build_computer_health(HEALTH_EVENTS)))
    out.append(V.render_telemetry(TELEMETRY_EVENTS))
    for evs in (COMBINE_EVENTS, OVERFLOW_EVENTS):
        job = V.build_job(evs)
        out += [V.render(job), V.render_html(job), repr(V.diagnose(job))]
    for evs in (VERTEX_EVENTS, CODED_EVENTS, TELEMETRY_EVENTS, COMBINE_EVENTS):
        out.append(V._render_stream(evs))
    return out


def test_synthetic_panels_are_byte_equal_to_the_reference():
    ref, port = _renders(JV), _renders(TV)
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert a == b
    text = "\n".join(port)
    for want in ("dup won", "re-executed", "9.0x compression", "k=3 of n=5",
                 "spares launched on failure", "reconstructed from [0, 3, 4]", "computer health",
                 "bad disk", "-- telemetry (2 samples) --", "host rss: last=2MB  peak=2MB",
                 "slo a: n=1  p50<=0.5s", "degraded key ranges: 12", "capacity exhausted",
                 "gang run r4: FAILED/INCOMPLETE"):
        assert want in text, want


def test_tolerant_load_and_live_html_equal_the_reference(tmp_path):
    p = tmp_path / "ev.jsonl"
    p.write_text('{"ts": 1, "kind": "job_start", "stages": 1}\n{"ts": 2, "kind": "stage_sta')
    assert TV._load_tolerant(str(p)) == JV._load_tolerant(str(p)) == [
        {"ts": 1, "kind": "job_start", "stages": 1}]
    evs = [
        {"ts": 0.0, "kind": "job_start", "stages": 2},
        {"ts": 0.1, "kind": "stage_start", "stage": 1, "name": "input+group_by", "version": 1,
         "boost": 1},
        {"ts": 0.5, "kind": "stage_complete", "stage": 1, "name": "input+group_by", "version": 1,
         "seconds": 0.4},
        {"ts": 0.9, "kind": "job_complete"},
    ]
    log = tmp_path / "events.jsonl"
    log.write_text("".join(json.dumps(e) + "\n" for e in evs))
    pages = []
    for V in (JV, TV):
        out = tmp_path / f"{V.__name__}.html"
        V.follow_html(str(log), str(out), interval=0.01, max_rounds=2)
        pages.append(out.read_text())
    assert pages[1] == pages[0]
    assert 'http-equiv="refresh"' in pages[1] and "OK" in pages[1]


# -- metricsd ----------------------------------------------------------------------


def _write_log(path, events):
    with open(path, "w") as fh:
        for ev in events:
            fh.write(json.dumps(ev) + "\n")


def _cli(mod, argv, capsys):
    rc = mod.main(list(argv))
    cap = capsys.readouterr()
    return rc, cap.out


@pytest.mark.parametrize("flags", [[], ["--json"], ["--window", "30"]])
def test_metricsd_oneshot_is_byte_equal_to_the_reference(tmp_path, capsys, flags):
    """A port log (a served job with its resource samples) and the
    synthetic serve events, one file each and a glob over both."""
    from dryad_tpu_torch.serve.service import QueryService

    tc = T.DryadContext(num_partitions_=P, config=T.DryadConfig(event_log_dir=str(tmp_path / "port")),
                        device="cpu")
    with QueryService(tc) as svc:
        for tenant in ("a", "b"):
            svc.session(tenant).run(tc.from_arrays({"k": np.arange(64, dtype=np.int32) % 5})
                                    .group_by("k", {"n": ("count", None)}))
    tc.events.close()
    (port_log,) = glob.glob(str(tmp_path / "port" / "*.jsonl"))
    syn = str(tmp_path / "syn.jsonl")
    _write_log(syn, TELEMETRY_EVENTS)
    for inputs in ([port_log], [syn], [str(tmp_path / "*.jsonl"), port_log]):
        ref, port = _cli(jmd, inputs + flags, capsys), _cli(tmd, inputs + flags, capsys)
        assert port == ref and port[0] == 0
    out = _cli(tmd, [port_log], capsys)[1]
    assert 'dryad_queries_admitted_total{tenant="a"} 1' in out
    assert "dryad_host_rss_kb" in out and "dryad_query_phase_s" in out


def test_metricsd_sinks_peer_snapshots_and_errors_equal_the_reference(tmp_path, capsys):
    log = str(tmp_path / "ev.jsonl")
    _write_log(log, TELEMETRY_EVENTS)
    peer = str(tmp_path / "peer.json")
    assert jmd.main([log, "--json-out", peer]) == 0  # a peer process's snapshot
    outs = []
    for mod in (jmd, tmd):
        prom, jout = str(tmp_path / f"{mod.__name__}.prom"), str(tmp_path / f"{mod.__name__}.out")
        rc, printed = _cli(mod, [log, peer, "--prom", prom, "--json-out", jout], capsys)
        outs.append((rc, printed, open(prom).read(), open(jout).read()))
        assert _cli(mod, [], capsys)[0] == 2
        assert _cli(mod, [str(tmp_path / "missing.jsonl")], capsys)[0] == 1
    assert outs[1] == outs[0]
    rc, printed, prom, doc = outs[1]
    assert rc == 0 and printed == "" and json.loads(doc)["processes"] == 2
    assert "dryad_hbm_headroom_bytes" in prom
    snaps = [json.loads(doc), json.loads(doc)]
    assert tmd.merge_snapshots(snaps) == jmd.merge_snapshots(snaps)


def test_log_cursor_survives_rotation_and_truncation(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    cursors = [jmd.LogCursor(path), tmd.LogCursor(path)]
    assert [c.poll() for c in cursors] == [[], []]  # not written yet
    seen = [[], []]

    def poll():
        for c, s in zip(cursors, seen):
            s.append([e["n"] for e in c.poll()])

    _write_log(path, [{"n": 1}, {"n": 2}])
    poll()
    with open(path, "a") as fh:
        fh.write(json.dumps({"n": 3}) + "\n" + '{"n": 4')  # torn tail
    poll()
    with open(path, "a") as fh:
        fh.write("}\n")
    poll()
    os.rename(path, path + ".1")  # rotation: a new file at the same path
    _write_log(path, [{"n": 10}])
    poll()
    _write_log(path, [{"n": 2}])  # truncated in place to a shorter file
    poll()
    assert seen[1] == seen[0] == [[1, 2], [3], [4], [10], [2]]


def test_cursor_set_reexpands_globs_like_the_reference(tmp_path):
    pat = [str(tmp_path / "*.jsonl")]
    sets = [jmd.CursorSet(pat), tmd.CursorSet(pat)]
    got = [[], []]

    def poll():
        for cs, g in zip(sets, got):
            g.append(sorted(e["n"] for e in cs.poll()))

    _write_log(str(tmp_path / "r0.jsonl"), [{"n": 1}])
    poll()
    poll()
    _write_log(str(tmp_path / "r1.jsonl"), [{"n": 10}])  # a replica appears
    with open(str(tmp_path / "r0.jsonl"), "a") as fh:
        fh.write(json.dumps({"n": 2}) + "\n")
    poll()
    assert got[1] == got[0] == [[1], [], [2, 10]]
    assert sets[1].paths() == sets[0].paths()
    lit = [str(tmp_path / "nope.jsonl"), str(tmp_path / "*.jsonl"), str(tmp_path / "r0.jsonl")]
    assert tmd.expand_inputs(lit) == jmd.expand_inputs(lit)


# -- blackbox ---------------------------------------------------------------------


def _dumps(tmp_path):
    """A dump directory: the driver's ring from a real port job that
    failed (dumped by the port's flight recorder) and two workers'
    synthetic dumps, one with a clock offset."""
    d = tmp_path / "dumps"
    rec = tflightrec.FlightRecorder(capacity=256, dump_dir=str(d), role="driver")
    rec.set_info(worker_offsets={"0": 0.25, "1": None})
    tc = T.DryadContext(num_partitions_=P, device="cpu",
                        config=T.DryadConfig(max_stage_failures=2, retry_backoff_base=0.001,
                                             obs_flight_recorder=False))
    tc.events.add_tap(rec.record)
    TX.set_fake_stage_failure("group_by", 99)
    with pytest.raises(Exception, match="failure budget"):
        _wordcountish(tc).collect()
    assert rec.dump("job_failed")
    base = max(e["ts"] for e in tc.events.events())
    for w, (pid, kill) in enumerate(((7001, True), (7002, False))):
        evs = [{"ts": base - 2.0, "kind": "stage_start", "name": "map", "stage": 1, "worker": w},
               {"ts": base - 1.0, "kind": "span", "name": "map", "cat": "execute", "dur": 0.5,
                "span_id": 1, "parent_id": None, "thread": "MainThread"}]
        if kill:
            evs.append({"ts": base - 0.5, "kind": "worker_killed_injected", "name": "map",
                        "stage": 1})
        with open(d / f"blackbox-{pid}.json", "w") as fh:
            json.dump({"version": 1, "pid": pid, "role": f"worker-{w}", "worker": w,
                       "reason": "sigterm" if kill else "exit", "dropped": 3 * w,
                       "events": evs, "snapshots": [{"ts": base - 1.5, "rss_kb": 1000}]}, fh)
    with open(d / "blackbox-9.json", "w") as fh:
        fh.write('{"torn": ')  # a partial dump is skipped
    return str(d)


@pytest.mark.parametrize("flags", [[], ["--json"], ["--window", "0", "--diagnose"],
                                   ["--window", "1.2"]])
def test_blackbox_merge_is_byte_equal_to_the_reference(tmp_path, capsys, flags):
    d = _dumps(tmp_path)
    outs = []
    for mod in (jbb, tbb):
        trace = str(tmp_path / f"{mod.__name__}.trace.json")
        rc, printed = _cli(mod, [d, "--trace", trace] + flags, capsys)
        outs.append((rc, printed, open(trace).read()))
    assert outs[1] == outs[0]
    rc, printed, trace = outs[1]
    assert rc == 0 and json.loads(trace)["traceEvents"]
    if not flags:
        assert "worker_killed_injected" in printed and "job_failed" in printed
        assert "clock_offset=+0.2500s" in printed and "evicted from rings" in printed
    assert tbb.main([]) == jbb.main([]) == 2
    assert tbb.main([str(tmp_path / "empty")]) == jbb.main([str(tmp_path / "empty")]) == 1


# -- the sample --------------------------------------------------------------------


def _drilldown(out):
    return [line for line in out.splitlines() if line.startswith(("vertex job", " part", "    "))]


def test_etl_speculation_drilldown_shows_a_duplicate_that_won_like_the_reference():
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    runs = [subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, env=env, timeout=600)
            for cmd in ([sys.executable, "-m", "dryad_tpu_torch.samples.etl_speculation",
                         "--device", "cpu"],
                        [sys.executable, os.path.join(ROOT, "samples", "etl_speculation.py")])]
    for r in runs:
        assert r.returncode == 0, r.stderr[-2000:]
    port, ref = (r.stdout for r in runs)
    assert port.splitlines()[0] == ref.splitlines()[0]  # kept N/M rows
    for out in (port, ref):
        assert "vertex job r2: OK  parts=8" in out and "duplicated, dup won" in out
    # the same job shapes: both vertex jobs' headers and part rows
    head = [line for line in _drilldown(port) if line.startswith("vertex job")]
    assert head == [line for line in _drilldown(ref) if line.startswith("vertex job")]


def test_metrics_registry_readers_equal_the_reference():
    from dryad_tpu.obs.metrics import MetricsRegistry as JRegistry
    from dryad_tpu_torch.obs.metrics import MetricsRegistry as TRegistry

    regs = [JRegistry(), TRegistry()]
    for r in regs:
        r.add("spill_bytes", 10, bucket=1)
        r.add("spill_bytes", 5, bucket=2)
        r.add("spill_bytes", 1, bucket=1)
        r.observe("rows", 3.0, part=0)
    got = [(r.counter("spill_bytes", bucket=1), r.counter("spill_bytes", bucket=9),
            r.total("spill_bytes"), r.total("nope"), r.snapshot()) for r in regs]
    assert got[1] == got[0] and got[1][:4] == (11.0, 0.0, 16.0, 0)
