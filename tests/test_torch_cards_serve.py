"""Serving, views and the fleet on one context over several devices
(dryad_tpu_torch): ``QueryService``, ``ViewRegistry`` and fleet replicas
on ``DryadContext(devices=...)``, a rank thread a device, as the
reference's serving tier runs on its mesh over ``jax.devices()``.

The ranks run on the CPU (``devices=["cpu"] * D``, D = 2 and 4, over an
in-process gloo group) at P = 8, with the bucket kernel's plain version.
Served results equal the reference's ``QueryService`` on its 8 CPU
devices and the one-device port at P = 8 (keys, counts and integer
aggregates byte-equal; a dense float mean within 2^-16 * sum|w| of its
key's rows, the ranks reducing in another order than one device), and
byte-equal to serial runs on the same context.  Cache hits dispatch on
no rank; invalidation counts, fair-share orders and view snapshots are
the reference's; the result-cache keys and admission costs are one
device's.  Tables a view's finalize or an append leave behind are
dropped on every rank.  Fleet replicas over two rank threads serve
byte-identical results, also after a replica's death.  Staleness is
held through view versions, never through sleeps.  Each test runs under
a time limit of its own (``TEST_LIMIT_S``).
"""

import collections
import signal
import textwrap
import threading
import time

import numpy as np
import pytest

import dryad_tpu as J
import dryad_tpu_torch as T
import test_torch_fleet as F
import test_torch_serve as S
import test_torch_views as V
from dryad_tpu_torch import serve as TS
from dryad_tpu_torch.obs.metrics import JobMetrics
from dryad_tpu_torch.parallel import multihost
from dryad_tpu_torch.parallel.partition import GangStageError
from dryad_tpu_torch.serve import fleet as TF
from dryad_tpu_torch.serve import router as trouter

P = 8
RANKS = [2, 4]
TEST_LIMIT_S = 60


@pytest.fixture(autouse=True)
def time_limit():
    """Each test fails, instead of hanging the run, after TEST_LIMIT_S."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran past its limit of {TEST_LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _cards(D, P_=P, **cfg):
    return T.DryadContext(num_partitions_=P_, devices=["cpu"] * D, config=T.DryadConfig(**cfg))


def _one(**cfg):
    return T.DryadContext(num_partitions_=P, device="cpu", config=T.DryadConfig(**cfg))


@pytest.fixture
def port_on_ranks(monkeypatch):
    """``on(D)``: from now on the serve and view tests' port contexts are
    contexts over D rank threads (the reference's stay as they are)."""
    def on(D):
        s_ctx, v_ctx = S._ctx, V._ctx

        def serve_ctx(pkg, **cfg):
            return _cards(D, **cfg) if pkg == "port" else s_ctx(pkg, **cfg)

        def view_ctx(pkg, **cfg):
            if pkg != "port":
                return v_ctx(pkg, **cfg)
            return _cards(D, **{k: v for k, v in cfg.items() if k in V._PORT_FIELDS})

        monkeypatch.setattr(S, "_ctx", serve_ctx)
        monkeypatch.setattr(V, "_ctx", view_ctx)

    return on


def _rank_dispatches(ctx) -> list:
    """Stage dispatches each rank's executor logged so far."""
    return [JobMetrics.from_events(rc.events.events()).dispatch_count
            for rc in ctx._ranks.contexts]


# -- served results: serial, one device and the reference ------------------------------

@pytest.fixture(scope="module")
def served_data():
    """The serve tests' table, the reference's serial results of the six
    shapes and the one-device port's."""
    data = S._mk_data(np.random.default_rng(0))
    jc = S._ctx("ref", serve_result_cache_bytes=0)
    ref = [jc.run_to_host(q) for q in S._shapes(jc.from_arrays(data))]
    one = _one(serve_result_cache_bytes=0)
    return data, ref, [one.run_to_host(q) for q in S._shapes(one.from_arrays(data))]


@pytest.mark.parametrize("D", RANKS)
def test_32_clients_over_ranks_equal_serial_one_device_and_the_reference(D, served_data):
    data, ref, one = served_data
    tc = _cards(D, serve_result_cache_bytes=0)
    queries = S._shapes(tc.from_arrays(data))
    serial = [tc.run_to_host(q) for q in queries]
    for i, (s, r, o) in enumerate(zip(serial, ref, one)):
        S._equal_to_reference(s, r, data, keyed=i < 5)
        S._equal_to_reference(s, o, data, keyed=i < 5)
        # in one device's row order too: the same placement at the same P
        S._byte_equal({c: v for c, v in s.items() if c != "m"}, {c: v for c, v in o.items() if c != "m"})
    with TS.QueryService(tc) as svc:
        sessions = [svc.session(f"tenant{i}") for i in range(4)]
        results, errors = [None] * 32, []

        def client(i):
            try:
                results[i] = sessions[i % 4].run(queries[i % len(queries)], timeout=50)
            except BaseException as e:  # noqa: BLE001
                errors.append((i, e))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(32)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=55)
        assert not errors, errors
        for i in range(32):
            S._byte_equal(results[i], serial[i % len(queries)])
        stats = svc.stats()
    assert sum(t["completed"] for t in stats["tenants"].values()) == 32
    assert stats["cache"]["hits"] == 0 and stats["dispatches"] == 32
    # every rank ran every job: the one stream the service folds is rank 0's
    counts = _rank_dispatches(tc)
    assert len(set(counts)) == 1 and counts[0] > 0, counts


@pytest.mark.parametrize("D", RANKS)
def test_fetches_and_jobs_meet_on_the_rank_threads_in_either_order(D, monkeypatch):
    """Each rank copies a result's rows on its own thread, queued behind
    or ahead of the next job's part there: with seeded delays on some
    ranks' copies, every result still equals its serial run and results
    commit in submit order."""
    from dryad_tpu_torch.columnar.batch import ColumnBatch

    data = S._mk_data(np.random.default_rng(6))
    tc = _cards(D, serve_result_cache_bytes=0)
    queries = S._shapes(tc.from_arrays(data))
    serial = [tc.run_to_host(q) for q in queries]
    rng, lock = np.random.default_rng(D), threading.Lock()
    real = ColumnBatch.fetch_valid_rows

    def jittered(self, *a, **kw):
        if threading.current_thread().name.startswith("dryad-rank-"):
            with lock:
                pause = float(rng.choice([0.0, 0.0, 0.01, 0.03]))
            time.sleep(pause)
        return real(self, *a, **kw)

    monkeypatch.setattr(ColumnBatch, "fetch_valid_rows", jittered)
    with TS.QueryService(tc, start=False) as svc:
        s = svc.session("order")
        futs = [s.submit(queries[i % len(queries)]) for i in range(16)]
        svc.start()
        outs = [f.result(timeout=50) for f in futs]
        done = [e["query"] for e in tc.events.events()
                if e["kind"] == "query_complete" and e["tenant"] == "order"]
    for i, out in enumerate(outs):
        S._byte_equal(out, serial[i % len(queries)])
    assert done == [f.qid for f in futs]


# -- the result cache -------------------------------------------------------------

@pytest.mark.parametrize("D", RANKS)
def test_a_repeat_query_dispatches_on_no_rank(D):
    ctx = _cards(D)
    q = ctx.from_arrays(S._mk_data(np.random.default_rng(0))).group_by("k", aggs={"s": ("sum", "v")})
    with TS.QueryService(ctx) as svc:
        s = svc.session("alpha")
        first = s.run(q, timeout=50)
        before = _rank_dispatches(ctx)
        fut = s.submit(q)
        second = fut.result(timeout=50)
        after = _rank_dispatches(ctx)
        assert fut.cached and after == before and min(before) > 0, (before, after)
        S._byte_equal(first, second)
        assert "result_cache_hit" in [e["kind"] for e in ctx.events.events()]


@pytest.mark.parametrize("D", RANKS)
def test_per_binding_invalidation_over_ranks_equals_the_reference(D, port_on_ranks):
    rng = np.random.default_rng(0)
    data1 = S._mk_data(rng, vocab=8)
    data2 = S._mk_data(rng, n=512, vocab=200)
    extra = S._mk_data(rng, n=64, vocab=8)
    ref_counters, ref_dropped, ref_out = S._invalidation_script("ref", data1, data2, extra)
    port_on_ranks(D)
    counters, dropped, out = S._invalidation_script("port", data1, data2, extra)
    assert (counters, dropped) == (ref_counters, ref_dropped)
    for a, b in zip(out, ref_out):
        S._equal_to_reference(a, b, None)
    both = {k: np.concatenate([np.asarray(data1[k]), np.asarray(extra[k])]) for k in data1}
    fresh = _one(serve_result_cache_bytes=0)
    S._byte_equal(out[4], fresh.run_to_host(fresh.from_arrays(both).group_by(
        "k", aggs={"s": ("sum", "v")})))


def _keyed_queries(ctx, data, other, text):
    t, u, w = ctx.from_arrays(data), ctx.from_arrays(other), ctx.from_text(text)
    return S._shapes(t) + [
        u.group_by("k", {"s": ("sum", "v")}), t.join(u, "k"), w,
        w.group_by("word", {"n": ("count", None)}),
    ], t


@pytest.mark.parametrize("D", RANKS)
def test_cache_keys_and_admission_costs_equal_one_device(D):
    """``query_fingerprint``, its canonical form and ``query_input_bytes``
    of a context over D ranks are one device's at the same P (a repeat
    is a hit, and a fleet routes by the same key whatever each replica's
    layout); plans with function-valued params fall in the same classes."""
    rng = np.random.default_rng(4)
    data, other = S._mk_data(rng), S._mk_data(rng)
    text = " ".join(f"w{i}" for i in range(300))
    got, classes = {}, {}
    for who, ctx in (("one", _one()), ("cards", _cards(D))):
        qs, t = _keyed_queries(ctx, data, other, text)
        fps = [ctx.query_fingerprint(q) for q in qs]
        got[who] = (fps, [trouter.canonical_fingerprint(fp) for fp in fps],
                    [ctx.query_input_bytes(q) for q in qs])
        sel = t.select(lambda c: c, schema=t.schema)
        a, b = t.fork(lambda batch: (batch, batch), [t.schema, t.schema])
        fn = [sel, sel, t.select(lambda c: c, schema=t.schema), a, b, qs[0]]
        fn = [ctx.query_fingerprint(q) for q in fn]
        classes[who] = [[x == y for y in fn] for x in fn]
    assert got["cards"] == got["one"]
    assert None not in got["one"][0][:8] and got["one"][1][0] is not None
    assert classes["cards"] == classes["one"]


# -- the serve path's threading over the ranks ------------------------------------------

@pytest.mark.parametrize("D", RANKS)
def test_a_held_fetch_blocks_neither_the_next_dispatch_nor_an_append(D):
    """While query 1's result copy is held on the window's collector,
    the driver dispatches query 2 on every rank and a client's append
    lands between jobs; releasing the copy resolves both, each equal to
    a fresh context's run."""
    tc = _cards(D, serve_result_cache_bytes=0)
    data = S._mk_data(np.random.default_rng(6))
    t = tc.from_arrays(data)
    q1, q2 = t.group_by("k", {"s": ("sum", "v")}), t.distinct("k")
    gate, entered = threading.Event(), threading.Event()
    real = tc._host_table

    def held(query, batch):
        if query is q1:
            entered.set()
            assert gate.wait(40)
        return real(query, batch)

    tc._host_table = held
    with TS.QueryService(tc) as svc:
        assert svc._window.depth == 2
        s = svc.session("a")
        f1 = s.submit(q1)
        assert entered.wait(40)
        n0 = _rank_dispatches(tc)
        f2 = s.submit(q2)
        for _ in range(400):
            if min(_rank_dispatches(tc)) > max(n0):
                break
            time.sleep(0.05)
        assert min(_rank_dispatches(tc)) > max(n0), "query 2 did not dispatch on every rank"
        assert s.append(t, S._mk_data(np.random.default_rng(7), n=16)) == 0
        assert not f1.done() and not f2.done()
        gate.set()
        out1, out2 = f1.result(timeout=40), f2.result(timeout=40)
    ref = _one(serve_result_cache_bytes=0)
    rt = ref.from_arrays(data)
    S._byte_equal(out1, ref.run_to_host(rt.group_by("k", {"s": ("sum", "v")})))
    S._byte_equal(out2, ref.run_to_host(rt.distinct("k")))


@pytest.mark.parametrize("case", ["weighted", "tiers"])
def test_fair_share_order_over_ranks_equals_the_reference(case, port_on_ranks):
    ref = S._completion_order("ref", case)
    port_on_ranks(2)
    assert S._completion_order("port", case) == ref


def _boom(batch, i):
    if i == 5:
        raise ValueError("partition 5 refuses")
    return batch


@pytest.mark.parametrize("D", RANKS)
def test_a_failing_rank_resolves_its_own_future_and_the_service_serves_on(D, monkeypatch):
    """A query whose user function raises on one rank resolves its own
    future with the ``GangStageError`` naming the rank and the stage;
    the query queued behind it runs on the rebuilt group."""
    monkeypatch.setattr(multihost, "_timeout_s", 5.0)  # the abandoned gloo group's end
    data = S._mk_data(np.random.default_rng(3))
    tc = _cards(D, serve_result_cache_bytes=0)
    t = tc.from_arrays(data)
    good = t.group_by("k", {"c": ("count", None)})
    one = _one()
    want = one.run_to_host(S._shapes(one.from_arrays(data))[1])
    with TS.QueryService(tc, start=False) as svc:
        s = svc.session("alpha")
        bad = s.submit(t.apply(_boom, with_index=True).group_by("k", {"c": ("count", None)}))
        after = s.submit(good)
        svc.start()
        with pytest.raises(GangStageError) as err:
            bad.result(timeout=50)
        S._byte_equal(after.result(timeout=50), want)
        assert s.run(good, timeout=50) is not None
        stats = svc.stats()["tenants"]["alpha"]
    rank = 5 // (P // D)
    msg = str(err.value)
    assert f"on rank {rank} of {D}" in msg and "'input+apply" in msg and "partition 5 refuses" in msg
    assert (stats["failed"], stats["completed"]) == (1, 3)
    assert tc._ranks.generation == 2


def test_the_serve_window_sizes_from_every_cards_headroom(monkeypatch):
    """``dispatch_depth=-1``: the serve window's depth is the tier of the
    headroom summed over the context's cards (each card alone has the
    headroom of a shallower tier)."""
    import torch

    import test_torch_cards_stream as CS
    from dryad_tpu_torch.api import context as CTX
    from dryad_tpu_torch.obs import telemetry

    G = 1 << 30
    card = (G + G // 2, 80 * G, 0, 0)  # 1.5 GiB free a card: depth 3 alone
    CS._fake_cards(monkeypatch, [card] * 4)
    real = CTX.device_memory_probe
    monkeypatch.setattr(CTX, "device_memory_probe", lambda devs: real(
        [torch.device("cuda", i) for i in range(len(devs))]))
    ctx = _cards(4, dispatch_depth=-1)
    ctx.telemetry.sample()
    assert ctx.headroom.headroom_bytes() == 4 * card[0]
    mon = telemetry.ResourceMonitor(device_memory_fn=real(torch.device("cuda", 0)))
    mon.sample()
    assert telemetry.resolve_depth(-1, mon.headroom) == 3
    with TS.QueryService(ctx) as svc:
        assert svc._window.depth == 4


# -- views --------------------------------------------------------------------------

def _recompute_one(build, arrays):
    """The oracle: a one-device context over the rows so far."""
    ctx = _one()
    return ctx.run_to_host(build(ctx.from_arrays(arrays)))


VIEW_CASES = [(0, "group", "default"), (1, "tail", "nofuse"), (2, "windowed", "noctree")]
_VIEW_REFS: dict = {}


@pytest.mark.parametrize("D", RANKS)
@pytest.mark.parametrize("seed,shape,cfg", VIEW_CASES,
                         ids=[f"s{s}-{sh}-{c}" for s, sh, c in VIEW_CASES])
def test_view_fuzz_over_ranks_equals_one_device_and_the_reference(seed, shape, cfg, D,
                                                                  port_on_ranks):
    """Appends and reads interleaved as the reference's fuzz does: every
    snapshot byte-equal to a one-device recompute over the rows so far
    and to the reference's snapshot, a re-read dispatches nothing, and
    the view's events count what the reference's do."""
    build, window = V.SHAPES[shape]
    if (seed, shape, cfg) not in _VIEW_REFS:
        _VIEW_REFS[seed, shape, cfg] = V._fuzz_script("ref", seed, shape, cfg)[0]
    ref_reads = _VIEW_REFS[seed, shape, cfg]
    port_on_ranks(D)
    reads, events, ops = V._fuzz_script("port", seed, shape, cfg)
    assert len(reads) == len(ref_reads) == ops.count("read")
    for (out, again, dispatched, chunks), (ref_out, *_rest) in zip(reads, ref_reads):
        rows = V._concat(chunks) if window is None else V._live_rows(chunks, window[1])
        S._byte_equal(out, _recompute_one(build, rows))
        S._byte_equal(out, ref_out)
        S._byte_equal(again, out)
        assert dispatched == 0, "a fresh view read dispatched"
    m = JobMetrics.from_events(events)
    assert (m.views_registered, m.view_fallbacks, m.view_deltas) == (1, 0, ops.count("append"))
    assert m.view_snapshots_finalized == ops.count("read")


@pytest.mark.parametrize("D", RANKS)
def test_a_finalize_over_ranks_commits_the_version_it_was_built_at(D):
    """The port's repair of the reference's pending record holds over
    the ranks, and the committed finalize's state table is on no card."""
    from dryad_tpu_torch import views as tviews

    ctx = _cards(D)
    fresh, snap, version, _pending = V._finalize_race(T, tviews, ctx)
    assert (fresh, snap, version) == (False, 1, 2)
    held = [set(rc._device_cache) for rc in ctx._ranks.contexts]
    assert all(not h for h in held), held


@pytest.mark.parametrize("D", RANKS)
def test_no_rank_keeps_a_finalize_or_a_pre_append_table(D, monkeypatch):
    """After a stale view read and after an append, no rank's device cache
    holds the finalize's state table or the table's old rows; every rank
    dropped the stage programs holding a copy of the old rows, and kept
    the finalize's (the next finalize's state table has its shape and
    replays them)."""
    ctx = _cards(D)
    dropped = collections.defaultdict(list)
    for rc in ctx._ranks.contexts:
        real = rc.executor.programs.drop_holding
        monkeypatch.setattr(rc.executor.programs, "drop_holding",
                            lambda b, r=rc.mesh.rank, real=real: dropped[r].append(b) or real(b))
    rng = np.random.default_rng(8)
    with TS.QueryService(ctx) as svc:
        s = svc.session("mem")
        t = s.ingest(V._mk_exact(rng, 96))
        q = V._shape_group(t)
        s.register_view(q)
        s.run(q, timeout=50)  # stale: one finalize
        # the finalize committed: its state table is on no rank
        assert all(set(rc._device_cache) == set() for rc in ctx._ranks.contexts)
        assert not any(dropped.values()), dict(dropped)
        s.run(t.group_by("k", {"c": ("count", None)}), timeout=50)
        old = [rc._device_cache[t.node.id][1] for rc in ctx._ranks.contexts]
        s.append(t, V._mk_exact(rng, 32))
        for r, rc in enumerate(ctx._ranks.contexts):
            assert t.node.id not in rc._device_cache
            assert any(b is old[r] for b in dropped[r])
        out = s.run(t.group_by("k", {"c": ("count", None)}), timeout=50)
    assert int(out["c"].sum()) == 128
    assert not ctx._device_cache


def test_one_device_append_drops_the_programs_holding_the_old_rows(monkeypatch):
    """On one device too an append forgets the table's cached copy and
    releases the stage programs whose buffers hold it."""
    ctx = _one()
    dropped = []
    real = ctx.executor.programs.drop_holding
    monkeypatch.setattr(ctx.executor.programs, "drop_holding",
                        lambda b: dropped.append(b) or real(b))
    t = ctx.from_arrays(V._mk_exact(np.random.default_rng(9), 64))
    ctx.run_to_host(t.group_by("k", {"c": ("count", None)}))
    old = ctx._device_cache[t.node.id][1]
    ctx.append_arrays(t, V._mk_exact(np.random.default_rng(10), 16))
    assert t.node.id not in ctx._device_cache and any(b is old for b in dropped)
    out = ctx.run_to_host(t.group_by("k", {"c": ("count", None)}))
    assert int(out["c"].sum()) == 80


# -- the fleet --------------------------------------------------------------------------

def _replica_ctx():
    return T.DryadContext(num_partitions_=F.P, devices=["cpu"] * 2)


def test_fleet_replicas_over_ranks_byte_identical_also_after_a_death():
    """Two in-process replicas, each over two rank threads: every plan
    byte-identical to the direct run and to the reference's; the owner of
    a plan killed, its query replays byte-identical on the survivor."""
    data = F._mk_data(np.random.default_rng(0))
    ctx = F._factory()
    t = ctx.from_arrays(data)
    jt = J.DryadContext(num_partitions_=F.P).from_arrays(data)
    with TF.ServeFleet(hb_interval=0.15, stale_after=0.8) as fleet:
        runners = {rid: fleet.spawn_thread(rid, _replica_ctx) for rid in ("r0", "r1")}
        for q, jq in zip(F._shapes(t), F._shapes(jt)):
            out = fleet.run(q, tenant="ident", timeout=50)
            F._tables_equal(ctx.run_to_host(q), out)
            F._tables_equal(F._canonical(jq.collect()), F._canonical(out))
        assert all(r.ctx._ranks.world == 2 for r in runners.values())
        q = t.group_by("k", aggs={"s": ("sum", "v"), "m": ("mean", "w")})
        blob, fp = TF.pack_for_fleet(q)
        owner = trouter.rendezvous_rank(fp, fleet.replicas.alive())[0]
        fleet.kill_replica(owner)
        out = fleet.result(fleet.submit(tenant="chaos", package=blob, fingerprint=fp), timeout=50)
        F._tables_equal(ctx.run_to_host(q), out)
        st = F._wait_router(fleet, lambda st: st["replayed"] >= 1)
        assert st["replayed"] == 1 and st["dead"] == [owner], st


def test_a_process_replica_over_two_rank_threads_serves(tmp_path):
    """``python -m dryad_tpu_torch.serve.replica`` whose bootstrap builds
    ``DryadContext(devices=["cpu"] * 2)``: byte-equal results, and its
    stats post carries the process's kernel launches."""
    import pickle

    boot = tmp_path / "boot.py"
    boot.write_text(textwrap.dedent(f"""
        import dryad_tpu_torch as T

        def build_context():
            return T.DryadContext(num_partitions_={F.P}, devices=["cpu"] * 2)
    """))
    ctx = F._factory()
    t = ctx.from_arrays(F._mk_data(np.random.default_rng(4)))
    with TF.ServeFleet(hb_interval=0.2, stale_after=10.0) as fleet:
        fleet.spawn_process("p0", str(boot), timeout=50)
        for q in F._shapes(t)[:3]:
            F._tables_equal(ctx.run_to_host(q), fleet.run(q, tenant="proc", timeout=40))
        for _ in range(50):
            got = fleet.mailbox.get_prop(TF.FLEET_PID, "stats/p0")
            if got is not None and pickle.loads(got[1])["stats"]["dispatches"] >= 3:
                break
            time.sleep(0.1)
        post = pickle.loads(got[1])
    assert post["stats"]["dispatches"] >= 3 and "bucket_sum_count" in post["kernel_launches"]
    assert fleet._procs["p0"].returncode == 0


@pytest.mark.parametrize("cards", [0, 1, 3])
def test_the_four_card_serve_phase_fails_on_fewer_cards(monkeypatch, cards):
    """``chip_smoke.py --phases env,cards_serve`` fails, and does not
    skip, on a host with fewer cards than its ranks."""
    import torch

    import chip_smoke

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(AssertionError, match="cards_serve needs 4 cards"):
        chip_smoke.phase_cards_serve(torch.device("cpu"), "no card")
