"""The serving tier: the port (dryad_tpu_torch, device="cpu") against the
JAX package on its 8-device CPU mesh, at P=8, after tests/test_serve.py.

Both packages get the same seeded numpy tables and the same tenant
scripts.  Tolerances:

- keys, counts and integer aggregates are exact;
- a dense-path float sum (or mean) is within 2^-16 * sum|v| of its key's
  (the reference's bound for the bucket kernel); these tables have no
  sort-path float aggregate;
- within the port, served and serial results are byte-equal;
- admission decisions, rejection fields, cache hit/miss and invalidation
  counts, and the fair-share completion orders equal the reference's;
- the router's functions give the reference's outputs for the same
  inputs.
"""

import threading

import numpy as np
import pytest

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu import serve as JS
from dryad_tpu.obs.metrics import JobMetrics as JMetrics
from dryad_tpu.serve import router as jrouter
from dryad_tpu.serve.cache import ResultCache as JCache
from dryad_tpu_torch import serve as TS
from dryad_tpu_torch.obs.metrics import JobMetrics as TMetrics
from dryad_tpu_torch.plan.lower import lower as tlower
from dryad_tpu_torch.serve import router as trouter
from dryad_tpu_torch.serve.cache import ResultCache as TCache

P = 8
DENSE_REL = 2.0 ** -16
PKGS = {
    "ref": (J, JS, JMetrics, {}),
    "port": (T, TS, TMetrics, {"device": "cpu"}),
}


def _ctx(pkg, **cfg):
    mod, _, _, kw = PKGS[pkg]
    return mod.DryadContext(num_partitions_=P, config=mod.DryadConfig(**cfg), **kw)


def _mk_data(rng, n=256, vocab=8):
    words = np.asarray([f"w{i:03d}" for i in rng.integers(0, vocab, n)], object)
    return {
        "k": words,
        "v": rng.integers(0, 1000, n).astype(np.int32),
        "w": rng.random(n).astype(np.float32),
    }


def _shapes(t):
    """The reference test's six plan shapes, all value-hashable."""
    return [
        t.group_by("k", aggs={"s": ("sum", "v")}),
        t.group_by("k", aggs={"c": ("count", None)}),
        t.group_by("k", aggs={"m": ("mean", "w")}),
        t.group_by("k", aggs={"mx": ("max", "v"), "mn": ("min", "v")}),
        t.distinct("k"),
        t.order_by("v").take(16),
    ]


def _byte_equal(a, b):
    assert set(a) == set(b), (set(a), set(b))
    for k in a:
        va, vb = np.asarray(a[k]), np.asarray(b[k])
        if va.dtype == object or vb.dtype == object:
            assert [str(x) for x in va] == [str(x) for x in vb], k
        else:
            assert va.dtype == vb.dtype, k
            assert va.tobytes() == vb.tobytes(), k


def _by_key(t):
    order = np.argsort(np.asarray(t["k"]).astype(str), kind="stable")
    return {c: np.asarray(v)[order] for c, v in t.items()}


def _equal_to_reference(port, ref, data, keyed=True):
    """Keys, counts and integer columns exact; float columns within the
    dense bound 2^-16 * sum|w| of the key's rows."""
    if keyed:
        port, ref = _by_key(port), _by_key(ref)
    assert set(port) == set(ref)
    for c in ref:
        a, b = np.asarray(port[c]), np.asarray(ref[c])
        if b.dtype == object:
            assert [str(x) for x in a] == [str(x) for x in b], c
        elif b.dtype.kind == "f" and keyed:
            assert a.dtype == b.dtype, c
            absw = {k: np.abs(data["w"][data["k"] == k]).sum() for k in set(data["k"])}
            bound = np.array([DENSE_REL * absw[str(k)] for k in port["k"]])
            assert (np.abs(a.astype(np.float64) - b) <= bound).all(), c
        else:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), c


@pytest.fixture(scope="module")
def reference_results():
    """The reference's serial results of the six shapes, and the data."""
    data = _mk_data(np.random.default_rng(0))
    jc = _ctx("ref", serve_result_cache_bytes=0)
    return data, [jc.run_to_host(q) for q in _shapes(jc.from_arrays(data))]


# -- concurrent byte identity ------------------------------------------------------

def test_32_clients_byte_equal_to_serial_and_to_the_reference(reference_results):
    data, ref = reference_results
    tc = _ctx("port", serve_result_cache_bytes=0)
    queries = _shapes(tc.from_arrays(data))
    serial = [tc.run_to_host(q) for q in queries]
    for i, (p, r) in enumerate(zip(serial, ref)):
        _equal_to_reference(p, r, data, keyed=i < 5)
    with TS.QueryService(tc) as svc:
        sessions = [svc.session(f"tenant{i}") for i in range(4)]
        results, errors = [None] * 32, []

        def client(i):
            try:
                results[i] = sessions[i % 4].run(queries[i % len(queries)], timeout=120)
            except BaseException as e:  # noqa: BLE001
                errors.append((i, e))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(32)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180)
        assert not errors, errors
        for i in range(32):
            _byte_equal(results[i], serial[i % len(queries)])
        stats = svc.stats()
    assert sum(t["completed"] for t in stats["tenants"].values()) == 32
    assert stats["cache"]["hits"] == 0
    assert stats["dispatches"] == 32


def test_served_plans_lower_through_the_bucket_kernel():
    """The chip's serve plans over a tenant table (STRING k, int64 v, f32
    w): count and mean of w by k lowers to string_code ->
    group_reduce_dense (the bucket kernel); the int64 sum by k takes the
    sort path, the distinct a hash exchange and the top-k none of them,
    as the reference's plans do."""
    tc = _ctx("port")
    rng = np.random.default_rng(1)
    vocab = np.asarray([f"t0w{i:04d}" for i in range(64)], object)
    t = tc.from_arrays({"k": vocab[rng.integers(0, 64, 512)],
                        "v": rng.integers(0, 1000, 512).astype(np.int64),
                        "w": rng.random(512).astype(np.float32)})

    def kinds(q):
        return [op.kind for s in tlower([q.node], tc.config, tc.dictionary, P=P).stages
                for op in s.ops]

    dense = t.group_by("k", {"c": ("count", None), "m": ("mean", "w")})
    assert kinds(dense) == ["string_code", "group_reduce_dense", "project"]
    assert "string_code" in dense.explain() and "group_reduce_dense" in dense.explain()
    for q in (t.group_by("k", {"s": ("sum", "v")}), t.distinct("k"), t.order_by("v").take(64)):
        assert "group_reduce_dense" not in kinds(q), kinds(q)


def test_a_held_fetch_blocks_neither_the_next_dispatch_nor_an_append():
    """The context's job lock covers lower, bind and launch, never a
    fetch: while query 1's result copy is held on the window's collector
    thread, the driver dispatches query 2 (the window's depth, 2) and a
    client's append completes; releasing the copy resolves both."""
    tc = _ctx("port", serve_result_cache_bytes=0)
    data = _mk_data(np.random.default_rng(6))
    t = tc.from_arrays(data)
    q1, q2 = t.group_by("k", {"s": ("sum", "v")}), t.distinct("k")
    gate, entered = threading.Event(), threading.Event()
    real = tc._host_table

    def held(query, batch):
        if query is q1:
            entered.set()
            assert gate.wait(60)
        return real(query, batch)

    tc._host_table = held

    def starts():
        return sum(e["kind"] == "stage_start" for e in tc.events.events())

    with TS.QueryService(tc) as svc:
        assert svc._window.depth == 2
        s = svc.session("a")
        f1 = s.submit(q1)
        assert entered.wait(60)
        n0 = starts()
        f2 = s.submit(q2)
        deadline = threading.Event()
        for _ in range(600):
            if starts() > n0:
                break
            deadline.wait(0.1)
        assert starts() > n0, "query 2 did not dispatch while query 1's fetch was held"
        assert s.append(t, _mk_data(np.random.default_rng(7), n=16)) == 0
        assert not f1.done() and not f2.done()
        gate.set()
        out1, out2 = f1.result(timeout=60), f2.result(timeout=60)
    ref = _ctx("port", serve_result_cache_bytes=0)
    rt = ref.from_arrays(data)
    _byte_equal(out1, ref.run_to_host(rt.group_by("k", {"s": ("sum", "v")})))
    _byte_equal(out2, ref.run_to_host(rt.distinct("k")))


# -- result cache ------------------------------------------------------------------

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_repeat_query_served_from_cache_zero_dispatches(pkg):
    _, serve, metrics, _ = PKGS[pkg]
    ctx = _ctx(pkg)
    q = ctx.from_arrays(_mk_data(np.random.default_rng(0))).group_by("k", aggs={"s": ("sum", "v")})
    with serve.QueryService(ctx) as svc:
        s = svc.session("alpha")
        first = s.run(q, timeout=120)
        before = metrics.from_events(ctx.events.events()).dispatch_count
        fut = s.submit(q)
        second = fut.result(timeout=120)
        after = metrics.from_events(ctx.events.events()).dispatch_count
        assert fut.cached and after == before > 0
        _byte_equal(first, second)
        assert "result_cache_hit" in [e["kind"] for e in ctx.events.events()]
        second["s"][:] = -1  # the client's own copy
        third = s.run(q, timeout=120)
    _byte_equal(first, third)


def _invalidation_script(pkg, data1, data2, extra):
    """The reference test's per-binding invalidation script; returns the
    cache counters after each step, the append's drop count and the
    results."""
    _, serve, _, _ = PKGS[pkg]
    ctx = _ctx(pkg)
    steps = []
    with serve.QueryService(ctx) as svc:
        s = svc.session("alpha")
        t1 = s.ingest(data1)
        q1 = t1.group_by("k", aggs={"s": ("sum", "v")})
        out = [s.run(q1, timeout=120), s.run(q1, timeout=120)]
        steps.append(dict(svc.stats()["cache"]))
        t2 = s.ingest(data2)  # widens the dictionary past a table tier
        q2 = t2.group_by("k", aggs={"s": ("sum", "v")})
        out += [s.run(q2, timeout=120), s.run(q1, timeout=120)]
        steps.append(dict(svc.stats()["cache"]))
        dropped = s.append(t1, extra)
        out += [s.run(q1, timeout=120), s.run(q2, timeout=120)]
        steps.append(dict(svc.stats()["cache"]))
    counters = [{k: st[k] for k in ("entries", "hits", "misses", "invalidations")} for st in steps]
    return counters, dropped, out


def test_per_binding_invalidation_decisions_equal_the_reference():
    rng = np.random.default_rng(0)
    data1 = _mk_data(rng, vocab=8)
    data2 = _mk_data(rng, n=512, vocab=200)
    extra = _mk_data(rng, n=64, vocab=8)
    ref_counters, ref_dropped, ref_out = _invalidation_script("ref", data1, data2, extra)
    counters, dropped, out = _invalidation_script("port", data1, data2, extra)
    assert (counters, dropped) == (ref_counters, ref_dropped)
    assert dropped == 1 and counters[1]["invalidations"] == 0 and counters[2]["hits"] == 3
    for a, b in zip(out, ref_out):
        _equal_to_reference(a, b, None)
    _byte_equal(out[0], out[1])
    _byte_equal(out[0], out[3])
    _byte_equal(out[2], out[5])
    # the post-append result equals a fresh port context over all rows
    fresh = _ctx("port", serve_result_cache_bytes=0)
    both = {k: np.concatenate([np.asarray(data1[k]), np.asarray(extra[k])]) for k in data1}
    _byte_equal(out[4], fresh.run_to_host(fresh.from_arrays(both).group_by("k", aggs={"s": ("sum", "v")})))


def test_query_fingerprint_classes_equal_the_reference():
    """Rebuilt value-param queries share a fingerprint; another input,
    another plan or another output position differs; a stream input has
    none; the classes are the reference's."""
    rng = np.random.default_rng(4)
    data, other = _mk_data(rng), _mk_data(rng)
    classes = {}
    for pkg in PKGS:
        ctx = _ctx(pkg)
        t = ctx.from_arrays(data)
        t_same = ctx.from_arrays({k: v.copy() for k, v in data.items()})
        u = ctx.from_arrays(other)
        fn = lambda c: c  # noqa: E731
        sel = t.select(fn, schema=t.schema)
        a, b = t.fork(lambda batch: (batch, batch), [t.schema, t.schema])
        qs = {
            "sum": t.group_by("k", {"s": ("sum", "v")}),
            "sum_rebuilt": t.group_by("k", {"s": ("sum", "v")}),
            "sum_same_data": t_same.group_by("k", {"s": ("sum", "v")}),
            "sum_other_data": u.group_by("k", {"s": ("sum", "v")}),
            "count": t.group_by("k", {"c": ("count", None)}),
            "sel": sel,
            "sel_again": sel,
            "sel_rebuilt": t.select(lambda c: c, schema=t.schema),
            "fork0": a,
            "fork1": b,
            "stream": ctx.from_stream(iter([data])).group_by("k", {"s": ("sum", "v")}),
        }
        fps = {n: ctx.query_fingerprint(q) for n, q in qs.items()}
        assert fps["stream"] is None
        assert ctx.is_stream_query(qs["stream"]) and not ctx.is_stream_query(qs["sum"])
        names = sorted(fps)
        classes[pkg] = [[fps[x] == fps[y] for y in names] for x in names]
        # the router's canonical form is portable for value plans only
        assert jrouter.canonical_fingerprint(fps["sum"]) is not None or pkg == "port"
        assert trouter.canonical_fingerprint(fps["sel"]) is None
        assert trouter.canonical_fingerprint(fps["sum"]) == trouter.canonical_fingerprint(
            fps["sum_rebuilt"])
    assert classes["port"] == classes["ref"]


# -- admission -----------------------------------------------------------------------

def _quota_script(pkg):
    _, serve, _, _ = PKGS[pkg]
    ctx = _ctx(pkg)
    q = ctx.from_arrays(_mk_data(np.random.default_rng(0))).group_by("k", aggs={"s": ("sum", "v")})
    svc = serve.QueryService(ctx, start=False)  # queue up without draining
    try:
        s = svc.session("alpha", quota=serve.TenantQuota(max_inflight=4))
        futs = [s.submit(q) for _ in range(4)]
        with pytest.raises(serve.QueryRejected) as ei:
            s.submit(q)
        svc.start()  # a structured rejection, never a wedge
        for f in futs:
            f.result(timeout=120)
        assert s.run(q, timeout=120) is not None
        kinds = [e["kind"] for e in ctx.events.events()]
        tiny = svc.session("tiny", quota=serve.TenantQuota(max_inflight=100, max_bytes=16))
        with pytest.raises(serve.QueryRejected) as eb:
            tiny.submit(q)
    finally:
        svc.close()
    e, b = ei.value, eb.value
    return ((e.tenant, e.reason, e.limit, e.current), (b.tenant, b.reason, b.limit, b.current),
            "query_rejected" in kinds, "tenant_quota" in kinds)


def test_quota_fail_fast_and_rejection_fields_equal_the_reference():
    port = _quota_script("port")
    assert port == _quota_script("ref")
    assert port[0] == ("alpha", "inflight", 4, 4)
    assert port[1][:3] == ("tiny", "bytes", 16) and port[2] and port[3]


def test_query_input_bytes_equal_the_reference(tmp_path):
    data = _mk_data(np.random.default_rng(2), n=1000)
    text = " ".join(f"w{i}" for i in range(300))
    got = {}
    for pkg in PKGS:
        ctx = _ctx(pkg)
        t = ctx.from_arrays(data)
        w = ctx.from_text(text)
        got[pkg] = [ctx.query_input_bytes(q) for q in (
            t, t.group_by("k", {"s": ("sum", "v")}), t.join(t, "k"), w,
            w.group_by("word", {"n": ("count", None)}),
        )]
    assert got["port"] == got["ref"]
    assert got["port"][0] == sum(np.asarray(v).nbytes for v in data.values())
    assert got["port"][2] == got["port"][0]  # a table counts once


def test_failed_query_resolves_future_and_service_survives():
    tc = _ctx("port")
    t = tc.from_arrays(_mk_data(np.random.default_rng(0)))

    def boom(cols):
        raise ValueError("bad plan")

    with TS.QueryService(tc) as svc:
        s = svc.session("alpha")
        bad = s.submit(t.select(boom, schema=t.schema))
        with pytest.raises(ValueError, match="bad plan"):
            bad.result(timeout=120)
        assert s.run(t.group_by("k", aggs={"s": ("sum", "v")}), timeout=120) is not None
        assert svc.stats()["tenants"]["alpha"]["failed"] == 1


# -- fair share and tiers ----------------------------------------------------------

FAIRNESS = {
    # (tenant, weight, tier) pairs and queries each, submitted in turn
    "equal_weights": ([("a", 1, None), ("b", 1, None)], 8),
    "weighted": ([("heavy", 2, None), ("light", 1, None)], 6),
    "tiers": ([("bulk", 16, "batch"), ("fast", 1, "latency")], None),
    "weights_within_a_tier": ([("bheavy", 2, "batch"), ("blight", 1, "batch")], 6),
}


def _completion_order(pkg, case):
    _, serve, _, _ = PKGS[pkg]
    tenants, per = FAIRNESS[case]
    ctx = _ctx(pkg, serve_result_cache_bytes=0)
    rng = np.random.default_rng(5)
    tables = [ctx.from_arrays(_mk_data(rng)) for _ in tenants]
    svc = serve.QueryService(ctx, start=False)
    try:
        sess = [svc.session(n, weight=w, tier=tier) for n, w, tier in tenants]
        futs = []
        if per is None:  # the batch tenant's 6 queries first, then 4 latency ones
            futs += [sess[0].submit(tables[0].group_by("k", aggs={"s": ("sum", "v")}))
                     for _ in range(6)]
            futs += [sess[1].submit(tables[1].group_by("k", aggs={"c": ("count", None)}))
                     for _ in range(4)]
        else:
            for _ in range(per):
                for s, t in zip(sess, tables):
                    futs.append(s.submit(t.group_by("k", aggs={"s": ("sum", "v")})))
        svc.start()
        for f in futs:
            f.result(timeout=120)
        tiers = {n: svc.stats()["tenants"][n]["tier"] for n, _, _ in tenants}
    finally:
        svc.close()
    names = {n for n, _, _ in tenants}
    order = [e["tenant"] for e in ctx.events.events()
             if e["kind"] == "query_complete" and e["tenant"] in names]
    return order, tiers


@pytest.mark.parametrize("case", sorted(FAIRNESS))
def test_fair_share_orders_equal_the_reference(case):
    order, tiers = _completion_order("port", case)
    assert (order, tiers) == _completion_order("ref", case)
    if case == "equal_weights":
        assert len(order) == 16
        for i in range(1, len(order) + 1):
            assert abs(order[:i].count("a") - (i - order[:i].count("a"))) <= 2, order
    elif case in ("weighted", "weights_within_a_tier"):
        heavy, light = (("heavy", "light") if case == "weighted" else ("bheavy", "blight"))
        for i in range(2, len(order) + 1):
            assert order[:i].count(heavy) >= order[:i].count(light), order
    else:
        assert order[:4] == ["fast"] * 4 and tiers == {"bulk": "batch", "fast": "latency"}


def test_unknown_tier_and_tier_update_on_reopen():
    tc = _ctx("port")
    with TS.QueryService(tc) as svc:
        with pytest.raises(ValueError, match="tier"):
            svc.session("t", tier="express")
        svc.session("t")
        assert svc.stats()["tenants"]["t"]["tier"] == "latency"
        svc.session("t", tier="batch")
        assert svc.stats()["tenants"]["t"]["tier"] == "batch"
        with pytest.raises(ValueError, match="weight"):
            svc.session("u", weight=0)


# -- cost admission ---------------------------------------------------------------------

def _payload_table(nbytes):
    return {"v": np.zeros(max(1, nbytes // 8), dtype=np.int64)}


def _cache_script(cache_cls):
    """The reference tests' eviction-storm and edge-rule sequences."""
    expensive = _payload_table(8 * 1024)
    cheap = [_payload_table(2 << 20) for _ in range(4)]
    out = []
    for admission in ("all", "cost"):
        c = cache_cls(3 << 20, admission=admission)
        c.put("expensive", expensive, epoch=0, cost_s=5.0)
        for i, t in enumerate(cheap):
            c.put(f"cheap{i}", t, epoch=0, cost_s=1e-4)
        out.append((c.get("expensive", 0) is not None, c.get("cheap0", 0) is not None, c.stats()))
    c = cache_cls(1 << 20, admission="cost", min_sec_per_gb=0.5)
    c.put("nocost", _payload_table(64 * 1024), epoch=0)
    nb = 64 * 1024
    c.put("at", _payload_table(nb), epoch=0, cost_s=0.5 * (nb / 1e9))
    out.append((c.get("nocost", 0) is not None, c.get("at", 0) is not None, c.stats()))
    c.put("e", _payload_table(64), epoch=1)
    out.append((c.get("e", 2), c.stats()))  # an epoch that moved on misses and drops
    return out


def test_cost_admission_and_its_edge_rules_equal_the_reference():
    port = _cache_script(TCache)
    assert port == _cache_script(JCache)
    (lru_exp, _, _), (cost_exp, cost_cheap, cost_st), (nocost, at, edge_st), _ = port
    assert not lru_exp and cost_exp and not cost_cheap
    assert cost_st["rejected"] == 4 and cost_st["evictions"] == 0
    assert nocost and at and edge_st["rejected"] == 0


def test_service_builds_cache_from_config():
    tc = _ctx("port", serve_cache_admission="cost", serve_cache_min_sec_per_gb=2.5)
    with TS.QueryService(tc) as svc:
        assert (svc._cache.admission, svc._cache.min_sec_per_gb) == ("cost", 2.5)
        assert "rejected" in svc.stats()["cache"]
    with pytest.raises(ValueError, match="serve_cache_admission"):
        _ctx("port", serve_cache_admission="lfu")


# -- observability folds -----------------------------------------------------------------

def _synthetic_serve_events():
    return [
        {"kind": "query_admitted", "tenant": "a", "query": "a:0", "cost_bytes": 100, "queued": 1},
        {"kind": "query_admitted", "tenant": "a", "query": "a:1", "cost_bytes": 100, "queued": 2},
        {"kind": "query_complete", "tenant": "a", "query": "a:0", "ok": True, "seconds": 0.5,
         "cached": False},
        {"kind": "result_cache_hit", "tenant": "a", "query": "a:1", "rows": 3},
        {"kind": "query_complete", "tenant": "a", "query": "a:1", "ok": True, "seconds": 0.01,
         "cached": True},
        {"kind": "query_admitted", "tenant": "b", "query": "b:0", "cost_bytes": 9, "queued": 1},
        {"kind": "query_rejected", "tenant": "b", "query": "b:rej1", "reason": "inflight",
         "limit": 1, "current": 1},
        {"kind": "tenant_quota", "tenant": "b", "state": "saturated", "inflight": 1, "limit": 1,
         "bytes": 9},
        {"kind": "stage_start", "stage": 1, "name": "x", "version": 1, "boost": 1},
    ]


FOLDS = ("queries_admitted", "queries_completed", "queries_rejected", "result_cache_hits",
         "dispatch_count", "tenants")


def test_jobmetrics_per_tenant_folds_equal_the_reference():
    evs = _synthetic_serve_events()
    port, ref = TMetrics.from_events(evs), JMetrics.from_events(evs)
    assert [getattr(port, f) for f in FOLDS] == [getattr(ref, f) for f in FOLDS]
    assert port.tenants["a"]["cache_hits"] == 1 and port.tenants["b"]["quota_state"] == "saturated"
    # and on a live service's stream: the same counts in both packages
    live = {}
    for pkg in PKGS:
        _, serve, metrics, _ = PKGS[pkg]
        ctx = _ctx(pkg)
        q = ctx.from_arrays(_mk_data(np.random.default_rng(0))).distinct("k")
        with serve.QueryService(ctx) as svc:
            s = svc.session("a", quota=serve.TenantQuota(max_inflight=1, max_bytes=10**9))
            s.run(q, timeout=120)
            s.run(q, timeout=120)
        m = metrics.from_events(ctx.events.events())
        for t in m.tenants.values():
            t.pop("seconds")
        live[pkg] = [getattr(m, f) for f in FOLDS]
    assert live["port"] == live["ref"]


def test_serve_stats_phase_breakdown_sums_to_latency():
    from dryad_tpu_torch.obs import critpath

    tc = _ctx("port", serve_result_cache_bytes=0)
    t = tc.from_arrays(_mk_data(np.random.default_rng(3)))
    with TS.QueryService(tc) as svc:
        s = svc.session("alpha")
        for q in (t.group_by("k", {"s": ("sum", "v")}), t.distinct("k")):
            s.run(q, timeout=120)
        stats = svc.stats()
        assert svc._trace_buf == {}
    pct = stats["slo"]["alpha"]
    assert pct["n"] == 2 and set(pct["phases"]) <= set(critpath.PHASES)
    assert "dispatch" in pct["phases"] and "readback" in pct["phases"]
    folds = [bd for bd in critpath.fold_all(tc.events.events()).values() if bd.measured_s]
    assert len(folds) == 2
    for bd in folds:
        assert sum(bd.phases.values()) == pytest.approx(bd.total_s)


# -- the router ----------------------------------------------------------------------

def _router_corpus():
    rng = np.random.default_rng(9)
    return [
        ("group_by", {"aggs": {"s": ("sum", f"col{i}")}, "keys": (f"k{rng.integers(0, 9)}",)},
         frozenset({f"b{j}" for j in range(int(rng.integers(1, 5)))}),
         np.dtype("int32" if i % 3 else "float32"), np.int64(rng.integers(0, 1 << 40)),
         float(rng.random()), None, bool(i % 2), bytes(rng.integers(0, 256, 8, dtype=np.uint8)))
        for i in range(32)
    ] + [None, (lambda x: x,), ("ok", ("nested", print))]


def test_router_functions_equal_the_reference():
    corpus = _router_corpus()
    fps = [trouter.canonical_fingerprint(fp) for fp in corpus]
    assert fps == [jrouter.canonical_fingerprint(fp) for fp in corpus]
    assert fps[-3:] == [None, None, None] and None not in fps[:-3]
    reps = [f"r{i}" for i in range(5)]
    keys = [str(f) for f in fps[:-3]] + [f"q{i}" for i in range(200)]
    for k in keys:
        assert trouter.rendezvous_rank(k, reps) == jrouter.rendezvous_rank(k, reps)
        assert trouter.route(k, reps) == jrouter.route(k, reps)
    assert trouter.remap_fraction(keys, reps, reps[:-1]) == jrouter.remap_fraction(
        keys, reps, reps[:-1])
    assert trouter.package_fingerprint(b"blob") == jrouter.package_fingerprint(b"blob")
    with pytest.raises(ValueError):
        trouter.route("fp", [])
    now = [0.0]
    memos = [m(ttl=1.0, clock=lambda: now[0]) for m in (trouter.NegativeQuotaMemo,
                                                         jrouter.NegativeQuotaMemo)]
    sets = [r(stale_after=1.0, clock=lambda: now[0]) for r in (trouter.ReplicaSet,
                                                               jrouter.ReplicaSet)]
    trace = [[], []]
    for step in range(6):
        now[0] = step * 0.4
        for i, (memo, rs) in enumerate(zip(memos, sets)):
            if step == 0:
                memo.note_rejection("t", "inflight", {"limit": 4})
                memo.note_rejection("u", "closed", {})
                rs.add("r0")
                rs.add("r1")
            rs.observe("r0", step)
            if step == 4:
                rs.reap("r1")
            trace[i].append((memo.check("t"), memo.check("u"), memo.fast_rejects, rs.stale(),
                             rs.alive(), rs.dead(), rs.generation))
    assert trace[0] == trace[1]
