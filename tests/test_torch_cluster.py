"""The cluster layer of the port (dryad_tpu_torch): scheduler, mailbox,
block cache, file server, control plane, job packages, late join and
the launcher templates, after tests/test_cluster.py,
tests/test_quarantine.py (its scheduler, telemetry and statistics
cases), tests/test_multihost_control.py,
tests/test_jobpackage.py and tests/test_late_join.py.

The reference's own test bodies run against the port: each named case
is executed from a copy of its reference test file whose imports name
``dryad_tpu_torch`` instead of ``dryad_tpu``, with its fixtures built
the same way.  Job packages are held against the reference with seeded
numpy inputs (``slice_binding`` equal, packed-and-run results equal to
the reference's ``collect()``, tolerance zero), and the worker-process
cases run the port's workers on the CPU (``device="cpu"``).
"""

import inspect
import os
import pickle
import re
import stat
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.exec import jobpackage as JP
from dryad_tpu_torch.cluster.localjob import (
    CommandLauncher,
    LocalJobSubmission,
    SubprocessLauncher,
    WorkerLauncher,
)
from dryad_tpu_torch.exec import jobpackage as TP

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# -- the reference's cases, run against the port ------------------------------

_PORT_COPIES = {}


def _port_copy(name: str) -> types.ModuleType:
    """tests/<name>.py with every ``dryad_tpu`` import retargeted to the
    port."""
    if name not in _PORT_COPIES:
        src = open(os.path.join(HERE, f"{name}.py")).read()
        src = re.sub(r"\bdryad_tpu\.", "dryad_tpu_torch.", src)
        src = src.replace("from dryad_tpu import", "from dryad_tpu_torch import")
        assert not re.search(r"\bdryad_tpu\b(?!_torch)", src), name
        mod = types.ModuleType(f"port_copy_of_{name}")
        exec(compile(src, f"<tests/{name}.py on dryad_tpu_torch>", "exec"), mod.__dict__)
        _PORT_COPIES[name] = mod
    return _PORT_COPIES[name]


CASES = [
    ("test_cluster", f"TestScheduler.test_{n}") for n in (
        "runs_and_completes", "failure_reported", "soft_affinity_prefers_computer",
        "soft_affinity_relaxes_to_rack_then_cluster", "hard_affinity_never_relaxes",
        "soft_rack_affinity_immediate", "hard_rack_affinity", "cancel_queued",
        "elastic_membership", "state_watcher_sequence",
    )
] + [
    ("test_cluster", f"TestServiceAndCache.test_{n}") for n in (
        "mailbox_versioned_long_poll", "file_range_reads", "symlink_escape_blocked",
        "block_cache_hits_and_spill", "shutdown_cancels_queued",
        "cache_budget_stable_under_concurrent_misses", "cache_does_not_truncate_growing_file",
        "cache_status_endpoint",
    )
] + [
    ("test_cluster", f"TestMailboxCloseAndWatch.test_{n}") for n in (
        "close_wakes_outstanding_long_polls_fast", "closed_mailbox_polls_return_immediately",
        "watch_sees_every_set_and_unsubscribes", "watch_exception_does_not_break_set_prop",
        "del_prop_removes_and_tolerates_missing",
    )
] + [
    ("test_quarantine", f"TestQuarantine.test_{n}") for n in (
        "threshold_quarantines_no_new_dispatches",
        "quarantined_sole_computer_blocks_until_cooldown",
        "soft_affinity_relaxes_away_immediately", "hard_affinity_still_dispatches",
        "probation_success_readmits", "probation_failure_requarantines_immediately",
        "window_expiry_forgives_old_failures", "remove_computer_clears_quarantine_state",
    )
] + [
    ("test_quarantine", n) for n in (
        "TestRemoveComputerFailFast.test_queued_hard_affinity_fails_fast_on_removal",
        "TestRemoveComputerFailFast.test_hard_rack_affinity_survives_member_removal",
        "TestRetryPolicy.test_exponential_growth_and_cap",
        "TestRetryPolicy.test_jitter_is_seeded_and_bounded",
        "TestRetryPolicy.test_classify_deterministic_needs_repeat",
        "TestRetryPolicy.test_job_failed_error_carries_history",
        "TestFailureWindow.test_sliding_window_counts",
        "test_shared_quarantine_converges_across_drivers",
        "test_remote_failures_combine_with_local_for_quarantine",
        "test_straggler_threshold_floor_with_few_samples",
        "test_spare_threshold_acts_from_first_sample",
    )
] + [
    ("test_multihost_control", f"test_{n}") for n in (
        "requires_exactly_one_backend", "membership_and_wait", "heartbeat_failure_detection",
        "barrier_blocks_until_all_arrive", "barrier_timeout", "failure_reporting",
        "control_plane_over_http", "init_distributed_noop_without_env",
    )
]


def _resolve(mod, fn, values, teardown):
    """Arguments for ``fn`` from the module's fixtures, each built once
    per test into ``values`` (which starts with pytest's ``tmp_path``);
    generator fixtures are finished in ``teardown``."""
    kwargs = {}
    for pname in inspect.signature(fn).parameters:
        if pname == "self":
            continue
        if pname not in values:
            fx = getattr(mod, pname).__wrapped__
            val = fx(**_resolve(mod, fx, values, teardown))
            if inspect.isgenerator(val):
                gen, val = val, next(val)
                teardown.append(gen)
            values[pname] = val
        kwargs[pname] = values[pname]
    return kwargs


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}::{c[1]}")
def test_reference_case_on_the_port(case, tmp_path, monkeypatch):
    name, path = case
    mod = _port_copy(name)
    owner, _, fname = path.rpartition(".")
    fn = getattr(getattr(mod, owner), fname) if owner else getattr(mod, fname)
    teardown = []
    try:
        kwargs = _resolve(mod, fn, {"tmp_path": tmp_path, "monkeypatch": monkeypatch}, teardown)
        if owner:
            fn(None, **kwargs)
        else:
            fn(**kwargs)
    finally:
        for gen in reversed(teardown):
            for _ in gen:
                pass


def test_port_copies_use_the_port_classes():
    mod = _port_copy("test_cluster")
    assert mod.LocalScheduler.__module__ == "dryad_tpu_torch.cluster.scheduler"
    assert mod.ProcessService.__module__ == "dryad_tpu_torch.cluster.service"
    mod = _port_copy("test_multihost_control")
    assert mod.ControlPlane.__module__ == "dryad_tpu_torch.parallel.multihost"


# -- job packages ---------------------------------------------------------------


def _table(seed=0, n=512):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 16, n).astype(np.int32),
            "v": rng.integers(-100, 100, n).astype(np.int32)}


def _double_v(cols):
    """Module-level fn: packs by reference without cloudpickle."""
    return {"k": cols["k"], "v": cols["v"] * 2}


def _byte_equal(a, b):
    assert set(a) == set(b)
    for c in a:
        va, vb = np.asarray(a[c]), np.asarray(b[c])
        if va.dtype == object:
            assert va.tolist() == vb.tolist(), c
        else:
            assert va.dtype == vb.dtype and va.tobytes() == vb.tobytes(), c


def test_slice_binding_equals_the_reference(tmp_path):
    tbl = _table(1, 103)
    words = np.asarray([f"w{i % 11}" for i in range(103)], object)
    routed = ("host_routed", {"k": np.sort(tbl["k"]), "v": tbl["v"]},
              np.array([0, 10, 10, 60, 103], np.int64))
    phys = ("host_physical", {"word#h0": np.arange(103, dtype=np.uint32),
                              "word#h1": np.arange(103, dtype=np.uint32) * 3})
    parts = [{"k": np.arange(i, dtype=np.int32)} for i in range(7)]
    for binding in (("host", {**tbl, "w": words}, None), routed, phys, ("store", parts, None)):
        for nparts in (1, 3, 4):
            for part in range(nparts):
                if binding[0] == "host_routed" and nparts != 4:
                    continue
                tb, jb = TP.slice_binding(binding, part, nparts), JP.slice_binding(binding, part, nparts)
                assert tb[0] == jb[0] and len(tb) == len(jb)
                if tb[0] == "store":
                    assert [p["k"].tolist() for p in tb[1]] == [p["k"].tolist() for p in jb[1]]
                else:
                    _byte_equal(tb[1], jb[1])
    with pytest.raises(ValueError, match="cannot slice binding kind 'device'"):
        TP.slice_binding(("device", None), 0, 2)


def _plan(mod, ctx, tbl):
    return (ctx.from_arrays(tbl).select(_double_v).group_by("k", {"s": ("sum", "v")})
            .order_by([("k", False)]))


def test_pack_and_run_in_fresh_context_equals_the_reference(tmp_path):
    tbl = _table()
    ref = _plan(J, J.DryadContext(num_partitions_=8), tbl).collect()
    tc = T.DryadContext(num_partitions_=8, device="cpu")
    path = str(tmp_path / "job.pkl")
    manifest = TP.pack_query(_plan(T, tc, tbl), path)
    assert manifest["bindings"] == 1 and manifest["version"] == TP.PACKAGE_VERSION
    _byte_equal(TP.run_package(path, device="cpu"), ref)
    # a one-partition context on the worker's device, as a vertex runs
    q = TP.load_query(path, device="cpu", num_partitions=1)
    assert q.ctx.num_partitions == 1 and q.ctx.device.type == "cpu"
    _byte_equal(q.collect(), ref)
    with pytest.raises(ValueError, match="either ctx or device"):
        TP.load_query(path, ctx=tc, device="cpu")


def test_pack_string_dictionary_travels(tmp_path):
    tc = T.DryadContext(num_partitions_=8, device="cpu")
    q = tc.from_text("apple banana apple").group_by("word", {"n": ("count", None)})
    path = str(tmp_path / "wc.pkl")
    TP.pack_query(q, path)
    out = TP.run_package(path, device="cpu")
    assert dict(zip(out["word"], out["n"].tolist())) == {"apple": 2, "banana": 1}


def test_pack_refuses_device_bindings_like_the_reference(tmp_path):
    msgs = []
    for mod, pack, kw in ((J, JP.pack_query, {}), (T, TP.pack_query, {"device": "cpu"})):
        ctx = mod.DryadContext(num_partitions_=8, **kw)
        cached = ctx.from_arrays({"v": np.ones(64, np.float32)}).cache()
        with pytest.raises(ValueError) as ei:
            pack(cached, str(tmp_path / "dev.pkl"))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "device-resident" in msgs[1]


def test_cross_process_run_loads_neither_jax_nor_the_reference(tmp_path):
    tbl = {"k": np.random.default_rng(3).integers(0, 8, 256).astype(np.int32)}
    tc = T.DryadContext(num_partitions_=8, device="cpu")
    q = tc.from_arrays(tbl).group_by("k", {"c": ("count", None)}).order_by([("k", False)])
    path = str(tmp_path / "xp.pkl")
    TP.pack_query(q, path)
    code = (
        "import sys;"
        "from dryad_tpu_torch.exec.jobpackage import run_package;"
        f"out = run_package({path!r}, device='cpu');"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'dryad_tpu'));"
        "print('TOTAL', int(out['c'].sum()), 'BAD', bad)"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"TOTAL {len(tbl['k'])} BAD []" in r.stdout


def test_stale_ids_from_young_packer_rekeyed(tmp_path):
    """Node ids are process-local: a package whose ids twin the ones this
    process hands out next must be re-keyed on load (else lowering's own
    top-k node collides with a loaded input node)."""
    from dryad_tpu_torch.plan.nodes import fresh_id, walk

    tbl = {"v": np.random.default_rng(0).integers(0, 1 << 20, 512).astype(np.int64)}
    tc = T.DryadContext(num_partitions_=8, device="cpu")
    path = str(tmp_path / "ob.pkl")
    TP.pack_query(tc.from_arrays(tbl).order_by([("v", False)]).take(64), path)
    with open(path, "rb") as fh:
        blob = pickle.load(fh)
    base = fresh_id()
    forged = {}
    for off, n in enumerate(walk([blob["node"]])):
        old, n.id = n.id, base + 1 + off  # the ids the NEXT local nodes take
        forged[old] = n.id
    blob["bindings"] = {forged[i]: b for i, b in blob["bindings"].items()}
    with open(path, "wb") as fh:
        pickle.dump(blob, fh, protocol=pickle.HIGHEST_PROTOCOL)
    ctx2 = T.DryadContext(num_partitions_=8, device="cpu")
    for _ in range(2):  # two loads coexist in one context
        out = TP.load_query(path, ctx=ctx2).collect()
        np.testing.assert_array_equal(out["v"], np.sort(tbl["v"])[:64])


def test_lambda_ships_by_value_or_fails_like_the_reference(tmp_path, monkeypatch):
    """With cloudpickle a lambda packs by value; with the standard
    pickler both packages refuse it with the pickler's own error."""
    tbl = {"k": np.random.default_rng(0).integers(0, 8, 128).astype(np.int32)}
    factor = 3
    path = str(tmp_path / "lam.pkg")
    if TP._pickler is not pickle:
        tc = T.DryadContext(num_partitions_=8, device="cpu")
        TP.pack_query(tc.from_arrays(tbl).select(lambda c: {"k": c["k"] * factor}), path)
        out = TP.run_package(path, device="cpu")
        assert sorted(out["k"].tolist()) == sorted((tbl["k"] * factor).tolist())
    errs = []
    for mod, pkgmod, kw in ((J, JP, {}), (T, TP, {"device": "cpu"})):
        monkeypatch.setattr(pkgmod, "_pickler", pickle)
        ctx = mod.DryadContext(num_partitions_=8, **kw)
        with pytest.raises(Exception) as ei:
            pkgmod.pack_query(ctx.from_arrays(tbl).select(lambda c: {"k": c["k"] * factor}), path)
        errs.append((type(ei.value), str(ei.value)))
    assert errs[0] == errs[1] and "lambda" in errs[1][1]


# -- worker processes: late join, launcher templates, gang entry points -------


class CountingLauncher(SubprocessLauncher):
    """Proves the seam is used for every start."""

    def __init__(self):
        self.started = []

    def start(self, spec):
        self.started.append(spec["index"])
        return super().start(spec)


def _count_plan(n=400, mod=T, kw=None):
    ctx = mod.DryadContext(num_partitions_=1, **(kw if kw is not None else {"device": "cpu"}))
    tbl = {"k": (np.arange(n) % 5).astype(np.int32)}
    return ctx.from_arrays(tbl).group_by("k", {"c": ("count", None)})


def test_fetch_span_reaches_the_driver_before_a_task_that_lost_to_its_duplicate():
    """A worker ships its telemetry right after it fetched the job's
    package: its ``fetch_package`` span is in the driver's log when the
    job returns, even when its only task stalls after the fetch (an
    injected stage delay), loses to a duplicate on the other worker and
    ends after the job (the three-fetch WordCount of the card run)."""
    delay = 8.0
    with LocalJobSubmission(num_workers=2, device="cpu") as sub:
        sub.inject_fault(None, plan={"seed": 0, "stage_delay_prob": 1.0,
                                     "stage_delay_seconds": delay}, workers=[1])
        mark = len(sub.events.events())
        t0 = time.monotonic()
        # the duplicate path (a STRING WordCount's), not the coded one
        out = sub.submit_partitioned(_count_plan(), nparts=4, coded=False)
        dt = time.monotonic() - t0
        evs = sub.events.events()[mark:]
        assert int(out["c"].sum()) == 400
        assert dt < delay - 1.0, f"job took {dt:.1f}s, the stalled task was not bypassed"
        won = {e["computer"] for e in evs if e["kind"] == "vertex_complete"}
        assert won == {"worker0"} and "vertex_duplicate_win" in {e["kind"] for e in evs}
        fetches = sorted(e["worker"] for e in evs
                         if e["kind"] == "span" and e.get("name") == "fetch_package")
        assert fetches == [0, 1]
        sub.launcher.stop(sub._handles[1])  # still stalled: do not wait it out


def test_late_worker_join_completes_job():
    launcher = CountingLauncher()
    with LocalJobSubmission(num_workers=2, device="cpu", launcher=launcher,
                            defer_workers=1) as sub:
        assert launcher.started == [0]
        result = {}

        def submit():
            result["table"] = sub.submit_partitioned(_count_plan(), nparts=2)

        t = threading.Thread(target=submit, daemon=True)
        t.start()
        time.sleep(2.0)
        assert t.is_alive(), "submission did not wait for the late worker"
        sub.start_worker(1)
        t.join(timeout=180.0)
        assert not t.is_alive(), "job did not complete after late join"
        assert launcher.started == [0, 1]
        assert int(result["table"]["c"].sum()) == 400
        kinds = [e["kind"] for e in sub.events.events()]
        assert kinds.count("worker_joined") == 2
        devs = sub.worker_devices()
        assert sorted(devs) == [0, 1] and all(d["device"] == "cpu" for d in devs.values())
        with pytest.raises(ValueError, match="already started"):
            sub.start_worker(1)


class JoiningLauncher(WorkerLauncher):
    """Starts no process; each ``poll`` that finds a deferred slot
    starts that worker, as a thread calling ``start_worker`` would
    between two polls of a loop over the workers."""

    def __init__(self):
        self.sub = None
        self.started = []
        self.waited = []

    def start(self, spec):
        self.started.append(spec["index"])
        return spec["index"]

    def poll(self, handle):
        late = [i for i in range(self.sub.n) if i not in self.started] if self.sub else []
        if late:
            self.sub.start_worker(late[0])
        return None

    def wait(self, handle, timeout):
        self.waited.append(handle)

    def stop(self, handle, timeout=5.0):
        pass


def test_late_join_during_a_loop_over_the_workers():
    """A worker that joins while the liveness check or ``shutdown``
    walks the workers does not break the walk (``dictionary changed
    size during iteration``): the walk covers the workers it started
    with, and ``shutdown`` still waits for the one that joined."""
    launcher = JoiningLauncher()
    sub = LocalJobSubmission(num_workers=3, device="cpu", launcher=launcher,
                             defer_workers=2)
    try:
        assert launcher.started == [0]
        launcher.sub = sub
        sub._check_workers_alive()
        assert launcher.started == [0, 1]
    finally:
        sub.shutdown(graceful_timeout=0.1)
    assert launcher.started == [0, 1, 2]
    exits = [i for i in range(3) if sub.service.mailbox.get_prop(sub.job_id, f"cmd/{i}")]
    assert exits == [0, 1] and launcher.waited == [0, 1, 2]


def test_dead_worker_leaves_scheduling_before_its_task_fails():
    """A round trip that finds its worker dead deregisters it before it
    raises: the failure frees the worker's slot, and the scheduler must
    not place a queued task there before the driver's loop reaps it (two
    seeded kills would then cost a coded job three vertices).  The
    death is logged once, whoever reaps first."""
    from dryad_tpu_torch.cluster.interfaces import ClusterProcess

    with LocalJobSubmission(num_workers=2, device="cpu") as sub:
        out = sub.submit_partitioned(_count_plan(100), nparts=2)
        assert sorted(out["c"].tolist()) == [20] * 5
        h = sub._handles[1]
        h.kill()
        deadline = time.monotonic() + 30.0
        while sub.launcher.poll(h) is None and time.monotonic() < deadline:
            time.sleep(0.05)
        proc = ClusterProcess(sub._placed_round_trip(
            {"kind": "runpart", "cseq": sub._next_cseq()}))
        proc.computer = "worker1"
        with pytest.raises(RuntimeError, match="worker 1 exited"):
            proc.fn(proc)
        assert [c.name for c in sub.scheduler.computers()] == ["worker0"]
        sub._reap_dead_workers()
        dead = [e["worker"] for e in sub.events.events() if e["kind"] == "worker_dead"]
        assert dead == [1]


def test_command_launcher_template():
    seen = []

    class Recording(CommandLauncher):
        def start(self, spec):
            host = self.hosts[spec["index"] % len(self.hosts)]
            seen.append([t.replace("{host}", host) for t in self.template])
            assert spec["argv"][1:3] == ["-m", "dryad_tpu_torch.cluster.worker"]
            assert spec["argv"][-2:] == ["--device", "cpu"]
            assert "JAX_PLATFORMS" not in spec["env"] or os.environ.get("JAX_PLATFORMS")
            return super().start(spec)

    launcher = Recording(["env", "DRYAD_VIA_TEMPLATE={host}"], hosts=["hostA", "hostB"])
    with LocalJobSubmission(num_workers=2, device="cpu", launcher=launcher) as sub:
        out = sub.submit_partitioned(_count_plan(100), nparts=2)
        assert sorted(out["c"].tolist()) == [20] * 5
    assert seen[0] == ["env", "DRYAD_VIA_TEMPLATE=hostA"]
    assert seen[1] == ["env", "DRYAD_VIA_TEMPLATE=hostB"]


def test_ssh_preset_launches_workers_via_stand_in(tmp_path):
    """CommandLauncher.ssh(): the worker env travels as shell-quoted
    `env K=V` tokens behind the ssh prefix; a local fake ssh (drops the
    options and host, hands the rest to a shell) stands in for it."""
    fake = tmp_path / "fake_ssh"
    fake.write_text('#!/bin/sh\nwhile [ "${1#-}" != "$1" ]; do shift; done\nshift\nexec sh -c "$*"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    launcher = CommandLauncher.ssh(["nodeA", "nodeB"])
    assert launcher.template[0] == "ssh" and launcher.forward_env
    assert "-tt" in launcher.template
    launcher.template[0] = str(fake)
    with LocalJobSubmission(num_workers=2, device="cpu", launcher=launcher) as sub:
        out = sub.submit_partitioned(_count_plan(60), nparts=2)
        assert sorted(out["c"].tolist()) == [12] * 5
