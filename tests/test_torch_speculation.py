"""Independent vertex tasks over worker processes: the port's
``LocalJobSubmission.submit_partitioned`` (dryad_tpu_torch, workers on
the CPU) against the reference's, after tests/test_speculation.py and
the worker-kill case of tests/test_chaos.py.

One port submission and one reference submission (2 workers each) are
shared by the parity cases.  For partition-local, partial ``group_by``,
scalar, decomposable, routed join and routed ``order_by`` plans the
port's results equal the reference's (integers byte for byte, in the
same row order; float sums of the sort path within
``n_g * 2^-23 * sum|v|``), the vertex event kinds of each job are the
reference's, the rejections raise the reference's ``ValueError``
messages, and ``gang_combine_tree=True`` gives the bytes of the flat
assembly.  The straggler and dead-worker cases run on the port alone
and assert the reference's event kinds and a numpy oracle.
"""

import collections
import threading
import time

import numpy as np
import pytest

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.cluster.localjob import LocalJobSubmission as JSubmission
from dryad_tpu_torch.cluster.localjob import LocalJobSubmission as TSubmission

DELAY = 8.0
F32_REL = 2.0 ** -23
# kinds whose presence depends on wall-clock timing, not on the plan
TIMING_KINDS = {"vertex_duplicate", "vertex_duplicate_win", "vertex_duplicate_cancel",
                "coded_launch", "coded_cancel", "diagnosis"}


@pytest.fixture(scope="module")
def subs():
    with TSubmission(num_workers=2, device="cpu") as t, \
            JSubmission(num_workers=2, devices_per_worker=1) as j:
        yield {"port": t, "ref": j}


def _ctx(pkg, **cfg):
    if pkg == "port":
        return T.DryadContext(num_partitions_=1, device="cpu", config=T.DryadConfig(**cfg))
    return J.DryadContext(num_partitions_=1, config=J.DryadConfig(**cfg))


def _even(cols):
    # module-level: without cloudpickle, plans ship functions by reference
    return cols["k"] % 2 == 0


def _twice(cols):
    return {"k": cols["k"] * 2}


def _tables(seed=7, n=4000, keys=100):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, keys, n).astype(np.int32),
            "i": rng.integers(-1000, 1000, n).astype(np.int32),
            "v": rng.standard_normal(n).astype(np.float32)}


def _etl(pkg, mod):
    return _ctx(pkg).from_arrays(_tables()).where(_even).project(["k", "i", "v"])


def _group(pkg, mod):
    return _ctx(pkg).from_arrays(_tables(11, keys=20)).group_by(
        "k", {"c": ("count", None), "s": ("sum", "i"), "mn": ("min", "v"), "m": ("mean", "i")})


def _group_float_sum(pkg, mod):
    return _ctx(pkg).from_arrays(_tables(11, keys=20)).group_by(
        "k", {"c": ("count", None), "s": ("sum", "v"), "mx": ("max", "v")})


def _scalar(pkg, mod):
    return _ctx(pkg).from_arrays(_tables(13, 3000)).aggregate_as_query(
        {"s": ("sum", "i"), "n": ("count", None), "lo": ("min", "v"), "hi": ("max", "i")})


def _first(pkg, mod):
    n = 1200
    return _ctx(pkg).from_arrays({"k": np.arange(n, dtype=np.int32) % 7,
                                  "v": np.arange(n, dtype=np.float32)}).group_by(
        "k", {"f": ("first", "v"), "c": ("count", None)})


def _strings(pkg, mod):
    vocab = np.array(["ant", "bee", "cat", "dog", "elk"], object)
    words = vocab[np.random.default_rng(11).integers(0, len(vocab), 400)]
    return _ctx(pkg).from_arrays({"w": words, "x": np.arange(400, dtype=np.int32)}).project(
        ["w", "x"])


def _seed_moments(cols):
    v = cols["v"]
    return {"cnt": v * 0 + 1, "s1": v, "s2": v * v}


def _merge_moments(a, b):
    return {c: a[c] + b[c] for c in ("cnt", "s1", "s2")}


def _finalize_moments(cols):
    return {**cols, "var": cols["s2"] / cols["cnt"] - (cols["s1"] / cols["cnt"]) ** 2}


def _moments_dec(mod):
    return mod.Decomposable(
        seed=_seed_moments, merge=_merge_moments, state_cols=["cnt", "s1", "s2"],
        state_fields=[(c, mod.ColumnType.FLOAT32) for c in ("cnt", "s1", "s2")],
        finalize=_finalize_moments, out_fields=[("var", mod.ColumnType.FLOAT32)],
    )


def _decomposable(pkg, mod):
    t = _tables(23, 3000, keys=12)
    t["v"] = np.random.default_rng(23).integers(-8, 8, 3000).astype(np.float32)
    return _ctx(pkg).from_arrays(t).group_by("k", decomposable=_moments_dec(mod))


def _join_inputs():
    rng = np.random.default_rng(5)
    L = {"k": rng.integers(0, 200, 5000).astype(np.int32),
         "a": rng.integers(0, 9, 5000).astype(np.int32)}
    R = {"k": rng.integers(0, 200, 1500).astype(np.int32),
         "b": rng.integers(0, 9, 1500).astype(np.int32)}
    return L, R


def _join(pkg, mod):
    L, R = _join_inputs()
    ctx = _ctx(pkg)
    return ctx.from_arrays(L).join(ctx.from_arrays(R), ["k"], ["k"])


def _join_group(pkg, mod):
    return _join(pkg, mod).group_by("k", {"c": ("count", None), "s": ("sum", "b")})


def _order_by(pkg, mod):
    rng = np.random.default_rng(6)
    t = {"x": rng.integers(0, 10 ** 6, 6000).astype(np.int32),
         "y": rng.integers(0, 50, 6000).astype(np.int32)}
    return _ctx(pkg).from_arrays(t).order_by([("x", True), "y"])


PLANS = {
    "etl": (_etl, 6), "group_partials": (_group, 6), "group_float_sum": (_group_float_sum, 5),
    "scalar": (_scalar, 5), "first_engine_order": (_first, 4), "strings": (_strings, 4),
    "decomposable": (_decomposable, 5), "routed_join": (_join, 4),
    "routed_join_group": (_join_group, 4), "routed_order_by": (_order_by, 4),
}
# the route a plan takes: the rows it returns come in a hash-routed order
UNORDERED = {"routed_join"}


def _vertex_kinds(events):
    return {e["kind"] for e in events
            if e["kind"].startswith(("vertex_", "coded_")) and e["kind"] not in TIMING_KINDS}


def _submit(sub, q, nparts, **kw):
    mark = len(sub.events.events())
    out = sub.submit_partitioned(q, nparts=nparts, **kw)
    return out, sub.events.events()[mark:]


def _assert_close_sums(t, j, keys, col):
    """Sort-path float sums: within n_g * 2^-23 * sum|v| of the reference
    (the bound is checked against the count column as n_g)."""
    np.testing.assert_allclose(t[col], j[col], rtol=0, atol=float(np.max(np.abs(j[col])) + 1)
                               * F32_REL * max(int(np.max(t["c"])), 1) * 4)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_results_and_vertex_events_equal_the_reference(subs, name):
    build, nparts = PLANS[name]
    out = {}
    for pkg, mod in (("ref", J), ("port", T)):
        out[pkg] = _submit(subs[pkg], build(pkg, mod), nparts)
    (jt, jev), (tt, tev) = out["ref"], out["port"]
    assert set(tt) == set(jt)
    if name in UNORDERED:
        order_t = np.lexsort([tt[c] for c in sorted(tt)])
        order_j = np.lexsort([jt[c] for c in sorted(jt)])
        tt = {c: v[order_t] for c, v in tt.items()}
        jt = {c: v[order_j] for c, v in jt.items()}
    floats = {"group_float_sum": ["s"], "decomposable": ["var"]}.get(name, [])
    for c in tt:
        a, b = np.asarray(tt[c]), np.asarray(jt[c])
        if c in floats:
            assert a.dtype == b.dtype
            if name == "decomposable":
                # integer-valued states: sums exact, the finalize rounds
                # twice in eager torch (ROADMAP section 3, FMA)
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
            else:
                _assert_close_sums(tt, jt, ["k"], c)
        elif a.dtype == object:
            assert a.tolist() == b.tolist(), c
        else:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), c
    assert _vertex_kinds(tev) == _vertex_kinds(jev)


REJECTIONS = {
    "mid_plan_group_by": lambda pkg, mod: _ctx(pkg).from_arrays(_tables(17, 500, 20))
    .group_by("k", {"s": ("sum", "v")}).where(_even),
    "unroutable_select": lambda pkg, mod: _select_join(pkg),
    "self_join_other_keys": lambda pkg, mod: _self_join(pkg),
    "routed_first": lambda pkg, mod: _routed_first(pkg),
    "coded_forced_ineligible": None,
}


def _select_join(pkg):
    rng = np.random.default_rng(7)
    ctx = _ctx(pkg)
    L = ctx.from_arrays({"k": rng.integers(0, 9, 100).astype(np.int32)})
    R = ctx.from_arrays({"k": rng.integers(0, 9, 50).astype(np.int32),
                         "b": np.arange(50, dtype=np.int32)})
    return L.select(_twice).join(R, ["k"], ["k"])


def _self_join(pkg):
    t = _ctx(pkg).from_arrays({"src": np.array([1, 2, 3, 1], np.int32),
                               "dst": np.array([2, 3, 1, 3], np.int32)})
    return t.join(t, ["src"], ["dst"], suffix="_r")


def _routed_first(pkg):
    rng = np.random.default_rng(8)
    ctx = _ctx(pkg)
    L = ctx.from_arrays({"k": rng.integers(0, 9, 200).astype(np.int32),
                         "g": rng.integers(0, 3, 200).astype(np.int32),
                         "v": rng.random(200).astype(np.float32)})
    R = ctx.from_arrays({"k": np.arange(9, dtype=np.int32)})
    return L.join(R, ["k"], ["k"]).group_by("g", {"f": ("first", "v")})


@pytest.mark.parametrize("name", sorted(REJECTIONS))
def test_rejections_raise_the_reference_messages(subs, name):
    msgs = []
    for pkg, mod in (("ref", J), ("port", T)):
        if name == "coded_forced_ineligible":
            q, kw = _ctx(pkg).from_arrays(_tables(2, 200, 9)).group_by(
                "k", {"lo": ("min", "v")}), {"coded": True}
        else:
            q, kw = REJECTIONS[name](pkg, mod), {}
        with pytest.raises(ValueError) as ei:
            subs[pkg].submit_partitioned(q, nparts=4, **kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_store_backed_first_refuses_like_the_reference(subs, tmp_path):
    msgs = []
    for pkg, mod in (("ref", J), ("port", T)):
        path = str(tmp_path / pkg)
        _ctx(pkg).from_arrays({"k": np.arange(40, dtype=np.int32) % 5,
                               "v": np.arange(40, dtype=np.float32)}).to_store(path)
        q = _ctx(pkg).from_store(path).group_by("k", {"f": ("first", "v")})
        with pytest.raises(ValueError) as ei:
            subs[pkg].submit_partitioned(q, nparts=4)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "exchange-free" in msgs[1]


def test_auto_fanout_equals_the_reference(subs):
    for rows, per in ((100, 1 << 18), (50 * 2 * 3, 50), (10 ** 6, 1000)):
        got = []
        for pkg in ("ref", "port"):
            q = _ctx(pkg, rows_per_vertex=per).from_arrays(
                {"k": np.arange(rows, dtype=np.int32)}).project(["k"])
            got.append(subs[pkg]._auto_fanout(q))
        assert got[0] == got[1]


def test_gang_combine_tree_gives_the_flat_bytes(subs):
    """Level -1 worker combines (``gang_combine_tree``) fold each
    winner's parts worker-side; the assembled result is byte-equal to
    the flat assembly's."""
    sub = subs["port"]

    def run(tree):
        q = _ctx("port", gang_combine_tree=tree, combine_tree=True).from_arrays(
            _tables(19, 6000, 300)).group_by("k", {"c": ("count", None), "s": ("sum", "i"),
                                                    "mx": ("max", "v")})
        return _submit(sub, q, 8)

    flat, _ = run(False)
    tree, evs = run(True)
    kinds = [e["kind"] for e in evs]
    assert "gang_partial_combine" in kinds
    assert any(e["kind"] == "combine_tree_level" and e["level"] == -1 for e in evs)
    assert _canonical_rows(tree) == _canonical_rows(flat)


def _canonical_rows(t):
    """Column names and the sorted list of each row's bytes (the
    reference's tests/test_gangtree.py comparison: merge groups may
    place rows in another order)."""
    names = sorted(t)
    cols = [np.asarray(t[c]) for c in names]
    assert all(c.dtype != object for c in cols)
    rows = sorted(b"".join(c[i].tobytes() for c in cols) for i in range(len(cols[0])))
    return names, [str(c.dtype) for c in cols], rows


def test_worker_telemetry_reaches_the_driver(subs):
    """A worker's telemetry carries its spans (the package fetch, the
    vertex commands) and the job context's stage events, each stamped
    with the worker."""
    sub = subs["port"]
    _, evs = _submit(sub, _group("port", T), 4)
    spans = {e["name"] for e in evs if e["kind"] == "span" and "worker" in e}
    assert {"fetch_package", "runpart"} <= spans
    assert any(e["kind"] == "stage_start" and "worker" in e for e in evs)


def test_worker_compiles_reach_the_driver_as_the_reference(subs):
    """A vertex task's stage programs log their ``xla_compile`` in the
    worker's job context; the worker ships them to the driver with its
    telemetry, stamped with the worker, as the reference's worker does
    (``dryad_tpu/cluster/worker.py``, ``_absorb_ctx_events``)."""
    got = {}
    for name in ("port", "ref"):
        sub = subs[name]
        _, evs = _submit(sub, _etl(name, T if name == "port" else J), 4)
        comp = [e for e in evs if e["kind"] == "xla_compile"]
        # which worker ran which task is the scheduler's timing: the
        # stages compiled, each from a worker, are the plan's
        assert comp and all(e["worker"] in (0, 1) for e in comp)
        got[name] = sorted({e["stage"] for e in comp})
    assert got["port"] == got["ref"]


def _oracle_even(tbl):
    m = tbl["k"] % 2 == 0
    return {c: np.sort(tbl[c][m]) for c in ("k", "i")}


def test_straggler_duplicated_first_completion_wins():
    """One worker stalls DELAY seconds on its next vertex task; the
    duration model flags the outlier, the task is duplicated onto the
    other worker, and the job finishes long before the stall ends."""
    with TSubmission(num_workers=2, device="cpu") as sub:
        q = _etl("port", T)
        sub.submit_partitioned(q, nparts=6)  # warm both workers' caches
        sub.inject_delay(worker=1, seconds=DELAY, count=1)
        t0 = time.monotonic()
        out = sub.submit_partitioned(q, nparts=6)
        dt = time.monotonic() - t0
        exp = _oracle_even(_tables())
        assert {c: np.sort(out[c]) for c in ("k", "i")}.keys() == exp.keys()
        for c in exp:
            np.testing.assert_array_equal(np.sort(out[c]), exp[c])
        assert dt < DELAY - 1.0, f"job took {dt:.1f}s, straggler not bypassed"
        kinds = [e["kind"] for e in sub.events.events()]
        assert "vertex_duplicate" in kinds and "vertex_duplicate_win" in kinds
        sub.launcher.stop(sub._handles[1])  # still stalled: do not wait it out


def test_worker_killed_mid_task_reexecutes_on_the_survivor():
    """A worker killed while it stalls on its vertex task: the driver
    reaps it, re-executes the task on the survivor, and the result
    matches the oracle (speculation off: only re-execution can finish
    it).  Its slot then takes a replacement worker."""
    with TSubmission(num_workers=2, device="cpu") as sub:
        q = _etl("port", T)
        sub.submit_partitioned(q, nparts=4)
        sub.inject_delay(worker=1, seconds=30.0, count=1)

        def killer():
            time.sleep(1.0)  # let the stalled task dispatch first
            sub._handles[1].kill()

        t = threading.Thread(target=killer)
        t.start()
        out = sub.submit_partitioned(q, nparts=4, speculation=False)
        t.join()
        exp = _oracle_even(_tables())
        for c in exp:
            np.testing.assert_array_equal(np.sort(out[c]), exp[c])
        kinds = [e["kind"] for e in sub.events.events()]
        assert "worker_dead" in kinds and "vertex_retry" in kinds
        assert "vertex_job_complete" in kinds
        # the reference's late join, into the dead worker's slot
        sub.start_worker(1)
        again = sub.submit_partitioned(q, nparts=4)
        for c in exp:
            np.testing.assert_array_equal(np.sort(again[c]), exp[c])
        assert collections.Counter(
            e["kind"] for e in sub.events.events())["worker_joined"] == 3
