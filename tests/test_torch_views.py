"""Materialized views under continuous ingest: the port (dryad_tpu_torch,
device="cpu") against the JAX package on its 8-device CPU mesh, at P=8,
after tests/test_views.py, its fleet case included (two thread replicas
of ``serve/fleet.py``, each with its own port context).

Every float column holds integer values (cast to float32), so a view's
host fold and a device recompute add exactly: the tolerance is zero.  At
every read point of the fuzz cases the port's snapshot is byte-equal to
a fresh port context's recompute over the rows so far and to the
reference's snapshot at the same point; a re-read dispatches nothing;
``view_fallback`` reasons are the reference's, word for word.
"""

import dataclasses
import time

import numpy as np
import pytest

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu import serve as JS
from dryad_tpu.api.decomposable import Decomposable as JDec
from dryad_tpu.columnar.schema import ColumnType as JType
from dryad_tpu.views import ViewIneligible as JIneligible
from dryad_tpu_torch import serve as TS
from dryad_tpu_torch.api.decomposable import Decomposable as TDec
from dryad_tpu_torch.columnar.schema import ColumnType as TType
from dryad_tpu_torch.obs.metrics import JobMetrics
from dryad_tpu_torch.views import ViewIneligible as TIneligible

P = 8
VOCAB = 6
PKGS = {
    "ref": (J, JS, {}),
    "port": (T, TS, {"device": "cpu"}),
}
_PORT_FIELDS = {f.name for f in dataclasses.fields(T.DryadConfig)}


def _ctx(pkg, **cfg):
    """A context; the port takes the config keys it has."""
    mod, _, kw = PKGS[pkg]
    if pkg == "port":
        cfg = {k: v for k, v in cfg.items() if k in _PORT_FIELDS}
    return mod.DryadContext(num_partitions_=P, config=mod.DryadConfig(**cfg), **kw)


def _byte_equal(a, b):
    assert set(a) == set(b), (set(a), set(b))
    for k in a:
        va, vb = np.asarray(a[k]), np.asarray(b[k])
        if va.dtype == object or vb.dtype == object:
            assert [str(x) for x in va] == [str(x) for x in vb], k
        else:
            assert va.dtype == vb.dtype, k
            assert va.tobytes() == vb.tobytes(), k


def _mk_exact(rng, n, wid_lo=0):
    """A chunk of integer-valued floats whose window ids straddle two
    adjacent windows."""
    return {
        "k": np.asarray([f"w{i}" for i in rng.integers(0, VOCAB, n)], object),
        "v": rng.integers(0, 1_000_000, n).astype(np.int32),
        "w": rng.integers(0, 64, n).astype(np.float32),
        "wid": rng.integers(wid_lo, wid_lo + 2, n).astype(np.int32),
    }


def _concat(chunks):
    return {c: np.concatenate([np.asarray(ch[c]) for ch in chunks]) for c in chunks[0]}


def _live_rows(chunks, window_count):
    full = _concat(chunks)
    floor = int(full["wid"].max()) - window_count + 1
    m = full["wid"] >= floor
    return {c: v[m] for c, v in full.items()}


def _recompute(build, arrays):
    """The oracle: a fresh port context over the accumulated rows."""
    ctx = _ctx("port")
    return ctx.run_to_host(build(ctx.from_arrays(arrays)))


def _shape_group(t):
    return t.group_by("k", aggs={"s": ("sum", "v"), "m": ("mean", "w"), "c": ("count", None),
                                 "mx": ("max", "v")})


def _shape_tail(t):
    return t.group_by("k", aggs={"s": ("sum", "v"), "m": ("mean", "w")}).order_by("s").take(4)


def _shape_windowed(t):
    return t.group_by(["wid", "k"], aggs={"s": ("sum", "v"), "c": ("count", None)})


SHAPES = {
    "group": (_shape_group, None),
    "tail": (_shape_tail, None),
    "windowed": (_shape_windowed, ("wid", 3)),
}

CONFIGS = {
    "default": {},
    "nofuse": {"plan_fuse": False},
    "noctree": {"combine_tree": False},
}

FUZZ_CASES = [
    (0, "group", "default"),
    (1, "group", "nofuse"),
    (2, "group", "noctree"),
    (0, "tail", "default"),
    (1, "tail", "nofuse"),
    (0, "windowed", "default"),
    (2, "windowed", "noctree"),
]


def _fuzz_script(pkg, seed, shape, cfg):
    """The reference test's interleaving of appends and reads; returns
    the snapshot at every read, the chunks so far at each, the
    re-reads' dispatch deltas and the service's events."""
    _, serve, _ = PKGS[pkg]
    rng = np.random.default_rng(seed)
    build, window = SHAPES[shape]
    ctx = _ctx(pkg, **CONFIGS[cfg])
    chunks = [_mk_exact(rng, 96)]
    wid_lo = 1
    reads = []
    with serve.QueryService(ctx) as svc:
        s = svc.session("fuzz")
        t = s.ingest(chunks[0])
        q = build(t)
        if window is None:
            s.register_view(q)
        else:
            s.register_view(q, window_col=window[0], window_count=window[1])
        ops = list(rng.permutation(["append", "append", "read"])) + ["append", "read"]
        for op in ops:
            if op == "append":
                chunk = _mk_exact(rng, int(rng.integers(16, 64)), wid_lo=wid_lo)
                wid_lo += 1
                chunks.append(chunk)
                s.append(t, chunk)
                continue
            out = s.run(q)
            before = svc.stats()["dispatches"]
            again = s.run(q)
            reads.append((out, again, svc.stats()["dispatches"] - before, list(chunks)))
        events = svc.events.events()
    return reads, events, ops


@pytest.mark.parametrize("seed,shape,cfg", FUZZ_CASES,
                         ids=[f"s{s}-{sh}-{c}" for s, sh, c in FUZZ_CASES])
def test_fuzz_append_read_differential(seed, shape, cfg):
    build, window = SHAPES[shape]
    reads, events, ops = _fuzz_script("port", seed, shape, cfg)
    ref_reads, _, _ = _fuzz_script("ref", seed, shape, cfg)
    assert len(reads) == len(ref_reads) == ops.count("read")
    for (out, again, dispatched, chunks), (ref_out, *_rest) in zip(reads, ref_reads):
        rows = _concat(chunks) if window is None else _live_rows(chunks, window[1])
        _byte_equal(out, _recompute(build, rows))
        _byte_equal(out, ref_out)
        _byte_equal(again, out)
        assert dispatched == 0, "a fresh view read dispatched"
    snaps = [e for e in events if e["kind"] == "view_snapshot"]
    assert snaps and all(e.get("qid") for e in snaps)
    finalized = [e for e in snaps if not e["fresh"]]
    assert len(finalized) == ops.count("read")
    m = JobMetrics.from_events(events)
    assert (m.views_registered, m.view_fallbacks) == (1, 0)
    assert m.view_deltas == ops.count("append")
    assert m.view_snapshots_finalized == len(finalized)
    assert m.view_snapshots_fresh == len(snaps) - len(finalized)


def test_windowed_ring_expires_old_windows():
    rng = np.random.default_rng(0)
    build, _ = SHAPES["windowed"]
    first = _mk_exact(rng, 128, wid_lo=0)
    nxt = _mk_exact(rng, 64, wid_lo=2)
    outs = {}
    for pkg in PKGS:
        _, serve, _ = PKGS[pkg]
        ctx = _ctx(pkg)
        with serve.QueryService(ctx) as svc:
            s = svc.session("ring")
            t = s.ingest(first)
            q = build(t)
            view = s.register_view(q, window_col="wid", window_count=2)
            assert view.stats()["windows"] == 2
            a = s.run(q)
            s.append(t, nxt)
            assert view.stats()["windows"] == 2
            outs[pkg] = (a, s.run(q), view.stats()["state_rows"])
    _byte_equal(outs["port"][0], _recompute(build, first))
    live = _live_rows([first, nxt], 2)
    assert set(np.unique(live["wid"])) == {2, 3}
    _byte_equal(outs["port"][1], _recompute(build, live))
    assert int(np.asarray(outs["port"][1]["wid"]).min()) >= 2
    for a, b in zip(outs["port"][:2], outs["ref"][:2]):
        _byte_equal(a, b)
    assert outs["port"][2] == outs["ref"][2]


def test_bounded_staleness_serves_old_snapshot_then_refreshes():
    rng = np.random.default_rng(0)
    build, _ = SHAPES["group"]
    base = _mk_exact(rng, 96)
    extra = _mk_exact(rng, 32)
    ctx = _ctx("port")
    with TS.QueryService(ctx) as svc:
        s = svc.session("stale")
        t = s.ingest(base)
        q = build(t)
        s.register_view(q, max_staleness_s=1.5)
        old = s.run(q)
        _byte_equal(old, _recompute(build, base))
        s.append(t, extra)
        before = svc.stats()["dispatches"]
        within = s.run(q)
        assert svc.stats()["dispatches"] == before
        _byte_equal(within, old)
        time.sleep(1.6)
        fresh = s.run(q)
        assert svc.stats()["dispatches"] == before + 1
        _byte_equal(fresh, _recompute(build, _concat([base, extra])))
        snaps = [e for e in svc.events.events() if e["kind"] == "view_snapshot"]
        assert all(e["staleness_s"] < 1.5 for e in snaps if e["fresh"])
        assert [e["staleness_s"] for e in snaps if not e["fresh"]][-1] >= 1.5


def _decomposables(dec, ctype):
    nonlinear = dec(seed=lambda c: {"s1": c["w"]}, merge=lambda a, b: {"s1": a["s1"] + b["s1"]},
                    state_cols=["s1"], out_fields=[("s1", ctype.FLOAT32)])
    linear = dec(seed=lambda c: {"s1": c["w"]}, merge=lambda a, b: {"s1": a["s1"] + b["s1"]},
                 state_cols=["s1"], out_fields=[("s1", ctype.FLOAT32)], linear=True,
                 identity={"s1": 0})
    return nonlinear, linear


def _fallbacks(pkg):
    _, serve, _ = PKGS[pkg]
    dec, ctype, inel = (TDec, TType, TIneligible) if pkg == "port" else (JDec, JType, JIneligible)
    nonlinear, linear = _decomposables(dec, ctype)
    ctx = _ctx(pkg)
    reasons = []
    with serve.QueryService(ctx) as svc:
        s = svc.session("nope")
        t = s.ingest(_mk_exact(np.random.default_rng(0), 64))
        cases = [
            t.distinct("k"),
            t.group_by("k", aggs={"f": ("first", "v")}),
            t.group_by("k", aggs={"s": ("sum", "v")}, salt=2),
            t.group_by("k", decomposable=nonlinear),
            t.group_by("k", decomposable=linear),
            t.where(lambda c: c["v"] > 0).group_by("k", aggs={"s": ("sum", "v")}),
        ]
        for q in cases:
            with pytest.raises(inel) as ei:
                s.register_view(q)
            reasons.append(ei.value.reason)
        with pytest.raises(inel, match="must be a group key"):
            s.register_view(t.group_by("k", aggs={"s": ("sum", "v")}), window_col="wid",
                            window_count=2)
        emitted = [(e["reason"], e["tenant"]) for e in svc.events.events()
                   if e["kind"] == "view_fallback"]
        views = svc.stats()["views"]
    return reasons, emitted, (views["fallbacks"], views["registered"])


def test_fallback_reasons_equal_the_reference():
    port = _fallbacks("port")
    assert port == _fallbacks("ref")
    reasons, emitted, counts = port
    for fragment, reason in zip(
        ["root operator 'distinct'", "order-dependent aggregate 'first'", "salted group_by",
         "non-linear decomposable merge", "decomposable delta folds not supported",
         "pre-aggregation operator"], reasons):
        assert fragment in reason
    assert len(emitted) == 7 and all(t == "nope" for _, t in emitted)
    assert counts == (7, 0)


def _finalize_race(mod, views, serve_ctx):
    """Two finalizes of one view built before either commits, a delta
    folded between them, then the first commits: is the view fresh?"""
    ctx = serve_ctx
    rng = np.random.default_rng(3)
    t = ctx.from_arrays(_mk_exact(rng, 64))
    view = views.ViewRegistry(ctx).register("t", _shape_group(t))
    first = views.finalize_query(view, ctx)
    view.fold_delta(_mk_exact(rng, 16))
    second = views.finalize_query(view, ctx)
    table = ctx.run_to_host(first)
    if mod is T:
        view.commit_snapshot(table, ctx, first)
    else:
        view.commit_snapshot(table, ctx)
    return view.fresh(), view.snap_version, view.version, second


def test_a_finalize_commits_the_version_it_was_built_at():
    """A fault of the reference, repaired: its view keeps one pending
    finalize record, so when a second stale read builds its finalize
    before the first commits (the serve window holds two), the first
    commit takes the newer version and the view serves the older rows
    as fresh.  The port keys the record by finalize plan."""
    from dryad_tpu import views as jviews
    from dryad_tpu_torch import views as tviews

    fresh, snap, version, _ = _finalize_race(T, tviews, _ctx("port"))
    assert (fresh, snap, version) == (False, 1, 2)
    ref_fresh, ref_snap, ref_version, _ = _finalize_race(J, jviews, _ctx("ref"))
    assert (ref_fresh, ref_snap, ref_version) == (True, 2, 2)  # the reference's fault


def test_a_read_between_two_finalize_commits_sees_every_delta():
    """The same race through the service: finalize A's copy is held, an
    append lands, read B builds finalize B (its copy held too); once A
    commits, a read C must not be served A's rows as fresh: it waits for
    a finalize that saw the append and equals a full recompute."""
    import threading

    rng = np.random.default_rng(8)
    build, _ = SHAPES["group"]
    base, one, two = _mk_exact(rng, 96), _mk_exact(rng, 32), _mk_exact(rng, 32)
    ctx = _ctx("port")
    gates, entered = [threading.Event(), threading.Event()], [threading.Event(), threading.Event()]
    real, calls = ctx._host_table, []

    def held(query, batch):
        i = len(calls)
        calls.append(query)
        if i < 2:
            entered[i].set()
            assert gates[i].wait(60)
        return real(query, batch)

    with TS.QueryService(ctx) as svc:
        s = svc.session("race")
        t = s.ingest(base)
        q = build(t)
        s.register_view(q)
        ctx._host_table = held
        s.append(t, one)
        fa = s.submit(q)
        assert entered[0].wait(60)
        s.append(t, two)
        fb = s.submit(q)
        for _ in range(600):  # finalize B dispatched; its copy waits behind A's
            if sum(e["kind"] == "view_snapshot" for e in svc.events.events()) == 2:
                break
            time.sleep(0.1)
        gates[0].set()
        fa.result(timeout=60)  # A committed
        assert entered[1].wait(60)
        fc = s.submit(q)
        gates[1].set()
        outs = [f.result(timeout=60) for f in (fa, fb, fc)]
    _byte_equal(outs[0], _recompute(build, _concat([base, one])))
    _byte_equal(outs[1], _recompute(build, _concat([base, one, two])))
    _byte_equal(outs[2], _recompute(build, _concat([base, one, two])))


# -- fleet: replicated views + chaos ---------------------------------------------------


def _wait_router(fleet, pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = fleet.stats()["router"]
        if pred(st):
            return st
        time.sleep(0.01)
    return fleet.stats()["router"]


def test_fleet_view_survives_replica_death_byte_identical():
    """Every replica registers the same view (the prepared statement of
    the package's sha) and folds the same append; the rendezvous owner
    is killed and the replay finalizes the survivor's state to the bytes
    the owner served, a fresh recompute's, and the reference's."""
    from dryad_tpu_torch.api.query import Query
    from dryad_tpu_torch.serve.fleet import ServeFleet, pack_for_fleet
    from dryad_tpu_torch.serve.router import rendezvous_rank

    def factory():
        return T.DryadContext(num_partitions_=4, device="cpu")

    rng = np.random.default_rng(7)
    base, extra = _mk_exact(rng, 256), _mk_exact(rng, 64)
    q = _shape_group(factory().from_arrays(base))
    blob, fp = pack_for_fleet(q)
    # the oracles at the replicas' P: a fresh port context and the reference
    tctx, jctx = factory(), J.DryadContext(num_partitions_=4)
    ref = tctx.run_to_host(_shape_group(tctx.from_arrays(_concat([base, extra]))))
    jref = jctx.run_to_host(_shape_group(jctx.from_arrays(_concat([base, extra]))))
    _byte_equal(ref, jref)
    with ServeFleet(hb_interval=0.15, stale_after=0.8) as fleet:
        runners = {rid: fleet.spawn_thread(rid, factory) for rid in ("r0", "r1")}
        for runner in runners.values():
            pq = runner._prepared_query({"package": blob})
            sess = runner.svc.session("mv")
            sess.register_view(pq)
            sess.append(Query(runner.ctx, pq.node.inputs[0]), extra)
        owner = rendezvous_rank(fp, fleet.replicas.alive())[0]
        survivor = next(r for r in ("r0", "r1") if r != owner)
        _byte_equal(ref, fleet.result(fleet.submit(tenant="mv", package=blob, fingerprint=fp),
                                      timeout=120))
        _byte_equal(ref, fleet.result(fleet.submit(tenant="mv", package=blob, fingerprint=fp),
                                      timeout=120))
        owner_snaps = [e for e in runners[owner].svc.events.events() if e["kind"] == "view_snapshot"]
        assert [e["fresh"] for e in owner_snaps] == [False, True]
        fleet.kill_replica(owner)
        _byte_equal(ref, fleet.result(fleet.submit(tenant="mv", package=blob, fingerprint=fp),
                                      timeout=120))
        st = _wait_router(fleet, lambda st: st["delivered"] >= 3)
        assert st["replayed"] == 1 and st["dead"] == [owner], st
        surv = [e for e in runners[survivor].svc.events.events() if e["kind"] == "view_snapshot"]
        assert surv and surv[-1]["fresh"] is False
