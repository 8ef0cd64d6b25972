"""Joins of the port (dryad_tpu_torch, device="cpu") against the JAX
package on its 8-device CPU mesh, both at P=8.

Ops level: ``hash_join``, ``hash_join_outer``, ``group_join_counts``,
``hash_join_ranked`` and ``exists_mask`` on int32 keys, split int64
keys, float keys (-0.0, 0.0, the subnormal 1e-45 and NaN), keys whose
31-bit probe hashes collide, and a 90% hot key; right sides
co-partitioned and replicated (the broadcast placement).  Every output
slot (valid or not), the valid mask and the overflow flag are compared
byte for byte.

Query level: the reference's join-strategy and GroupJoin shapes and the
Pavlo et al. join query at 2^14 rows under shuffle, broadcast and auto:
``collect()`` byte for byte (float sums of the sort path within
n_g * 2^-23 * sum_g |v|), the stage op lists against the reference's
lowering, the placement ``auto`` chooses, and the overflow retries.
The retry of a run of stages (the reference fuses runs into one program
and retries them whole) is held against the reference's events.
"""

import numpy as np
import pytest
import torch

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.columnar.schema import ColumnType as JCT
from dryad_tpu.columnar.schema import Schema as JSchema
from dryad_tpu.exec import kernels as JK
from dryad_tpu.exec.events import EventLog
from dryad_tpu.exec.executor import StageFailedError as JStageFailed
from dryad_tpu.ops import join as JJ
from dryad_tpu.parallel.distribute import from_host_table
from dryad_tpu.parallel.mesh import AXIS
from dryad_tpu.parallel.stage import compile_stage
from dryad_tpu.plan import keys as JKEYS
from dryad_tpu.plan.lower import lower as jlower
from dryad_tpu_torch.columnar.batch import ColumnBatch, to_host_column
from dryad_tpu_torch.columnar.schema import ColumnType, Schema
from dryad_tpu_torch.exec import kernels as TK
from dryad_tpu_torch.exec.executor import StageFailedError
from dryad_tpu_torch.ops import join as TJ
from dryad_tpu_torch.ops.hash import hash_columns
from dryad_tpu_torch.parallel.partition import gather_batch
from dryad_tpu_torch.plan import keys as TKEYS
from dryad_tpu_torch.plan.lower import lower as tlower

P = 8
F32_REL = 2.0 ** -23


# -- ops level -------------------------------------------------------------------

def _collision_keys():
    """int32 keys in pairs whose 31-bit probe hashes (hash >> 1) are
    equal, found among the first 2^19 non-negative ints."""
    ks = torch.arange(1 << 19, dtype=torch.int32)
    h = (hash_columns([ks]) >> 1).numpy()
    order = np.argsort(h, kind="stable")
    same = np.nonzero(h[order][1:] == h[order][:-1])[0]
    pairs = np.stack([order[same], order[same + 1]], 1)
    assert len(pairs) >= 8
    return pairs[:8].reshape(-1).astype(np.int32)


FLOAT_KEYS = np.array([-0.0, 0.0, 1e-45, -1e-45, 1.5, -2.25, np.nan, 3e-39], np.float32)


def _key_values(rng, kind, n):
    if kind == "int32":
        return rng.integers(-20, 20, n).astype(np.int32)
    if kind == "int64":
        base = np.array([-(1 << 40), 1 << 40, (1 << 40) + 1, 7, -7, 1 << 62], np.int64)
        return base[rng.integers(0, len(base), n)]
    if kind == "float":
        return FLOAT_KEYS[rng.integers(0, len(FLOAT_KEYS), n)]
    if kind == "collide":
        ks = _collision_keys()
        return ks[rng.integers(0, len(ks), n)]
    assert kind == "hot"
    return np.where(rng.random(n) < 0.9, 5, rng.integers(-30, 30, n)).astype(np.int32)


KTYPE = {"int32": "INT32", "int64": "INT64", "float": "FLOAT32", "collide": "INT32", "hot": "INT32"}


def _sides(rng, kind):
    kt = KTYPE[kind]
    left = {"k": _key_values(rng, kind, 600), "lv": np.arange(600, dtype=np.int32),
            "x": rng.standard_normal(600).astype(np.float32)}
    right = {"k": _key_values(rng, kind, 300), "rv": rng.standard_normal(300).astype(np.float32),
             "x": rng.integers(0, 2**32, 300, dtype=np.uint64).astype(np.uint32)}
    lf = [("k", kt), ("lv", "INT32"), ("x", "FLOAT32")]
    rf = [("k", kt), ("rv", "FLOAT32"), ("x", "UINT32")]
    return (left, lf, 100), (right, rf, 50)


def _port_batch(side):
    t, fields, cap = side
    ts = Schema([(c, getattr(ColumnType, ct)) for c, ct in fields])
    return ColumnBatch.from_numpy(ts, t, P, "cpu", partition_capacity=cap), ts


def _both(mesh, side):
    t, fields, cap = side
    js = JSchema([(c, getattr(JCT, ct)) for c, ct in fields])
    return (from_host_table(js, t, mesh, partition_capacity=cap), js, *_port_batch(side))


def _ref(mesh, jl, jr, fn, broadcast):
    """Run ``fn(left, right) -> (batch or array, overflow)`` per
    partition of the reference; the overflow flag or-ed over the mesh."""
    def stage(sh, _r):
        left, right = sh
        if broadcast:
            right = JK._gather_all(right, (AXIS,))
        out, ovf = fn(left, right)
        return (out,), (jax_any(ovf),)

    (out,), (ovf,) = compile_stage(mesh, stage)((jl, jr), ())
    if hasattr(out, "fetch_host"):
        valid, cols, _ = out.fetch_host()
        return valid, cols, bool(np.asarray(ovf))
    return np.asarray(out), None, bool(np.asarray(ovf))


def jax_any(flag):
    import jax
    import jax.numpy as jnp

    return jax.lax.psum(flag.astype(jnp.int32), AXIS) > 0


def _port(tl, tr, fn, broadcast):
    out, ovf = fn(tl, gather_batch(tr) if broadcast else tr)
    if isinstance(out, ColumnBatch):
        return (out.valid.reshape(-1).numpy(),
                {c: to_host_column(t.reshape(-1)) for c, t in out.data.items()}, bool(ovf))
    return to_host_column(out.reshape(-1)), None, bool(ovf)


def _assert_bytes(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=what)


def _check(ref, port):
    (jv, jc, jo), (tv, tc, to) = ref, port
    assert jo == to, "overflow flag"
    _assert_bytes(tv, jv, "valid")
    if jc is not None:
        assert sorted(tc) == sorted(jc)
        for c in jc:
            _assert_bytes(tc[c], jc[c], c)
    return jo


def _keys_of(schema):
    return JKEYS.equality_cols(schema, ["k"])


KINDS = ["int32", "int64", "float", "collide", "hot"]
OPS = {
    "hash_join": lambda M, L, R, k, cap: M.hash_join(L, R, k, k, cap),
    "hash_join_outer": lambda M, L, R, k, cap: M.hash_join_outer(
        L, R, k, k, cap, {"rv": np.float32(-1.5), "x_r": 0}),
    "group_join_counts": lambda M, L, R, k, cap: M.group_join_counts(L, R, k, k, cap),
    "exists_mask": lambda M, L, R, k, cap: M.exists_mask(L, R, k, k, cap),
}


@pytest.mark.parametrize("broadcast", [False, True], ids=["copartitioned", "replicated"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("op", sorted(OPS))
def test_join_ops_byte_identical(mesh8, rng, op, kind, broadcast):
    ls, rs = _sides(rng, kind)
    jl, js, tl, _ = _both(mesh8, ls)
    jr, _, tr, _ = _both(mesh8, rs)
    keys = _keys_of(js)
    flags = []
    for cap in (1200, 48):  # roomy except for the hot key, then too small
        ref = _ref(mesh8, jl, jr, lambda L, R: OPS[op](JJ, L, R, keys, cap), broadcast)
        port = _port(tl, tr, lambda L, R: OPS[op](TJ, L, R, keys, cap), broadcast)
        flags.append(_check(ref, port))
    assert flags[1] is True  # the small buffer overflows in every case


def test_slots_past_the_total_point_past_the_right_side(rng):
    """The out-of-range gathers: pair slots past a partition's total get
    right rows past the right side's capacity, which JAX's gathers clamp
    and torch's would reject; the port clamps them to the same rows, so
    ``hash_join`` runs and those (invalid) slots hold the reference's
    bytes (``test_join_ops_byte_identical`` compares every slot)."""
    ls, rs = _sides(rng, "hot")
    tl, tr = _port_batch(ls)[0], _port_batch(rs)[0]
    right_sorted, _h, start, counts = TJ._probe_ranges(tl, tr, ["k"], ["k"])
    _li, ri, pair_valid, _ovf, _off = TJ._expand_pairs(start, counts, 4000)
    assert bool((ri[~pair_valid] >= right_sorted.capacity).any())
    out, _ = TJ.hash_join(tl, tr, ["k"], ["k"], 4000)
    assert out.capacity == 4000


@pytest.mark.parametrize("final_attempt", [False, True], ids=["clamped", "final"])
@pytest.mark.parametrize("rank_limit", [None, 2], ids=["all_ranks", "rank_limit2"])
@pytest.mark.parametrize("ordered", [False, True], ids=["engine_order", "order_operands"])
@pytest.mark.parametrize("kind", ["int32", "float", "collide", "hot"])
def test_hash_join_ranked_byte_identical(mesh8, rng, kind, ordered, rank_limit, final_attempt):
    ls, rs = _sides(rng, kind)
    jl, js, tl, _ = _both(mesh8, ls)
    jr, jrs, tr, trs = _both(mesh8, rs)
    keys = _keys_of(js)
    order = [("rv", True), ("x", False)]

    def ref_fn(L, R):
        ops = JKEYS.ordering_operands(jrs, order)(R) if ordered else ()
        return JJ.hash_join_ranked(L, R, keys, keys, cap, "_r", "rank", ops,
                                   rank_limit=rank_limit, boost=boost, final_attempt=final_attempt)

    def port_fn(L, R):
        ops = TKEYS.ordering_operands(trs, order)(R) if ordered else ()
        return TJ.hash_join_ranked(L, R, keys, keys, cap, "_r", "rank", ops,
                                   rank_limit=rank_limit, boost=boost, final_attempt=final_attempt)

    for cap, boost, broadcast in ((1600, 1, False), (160, 2, True), (40, 1, False)):
        _check(_ref(mesh8, jl, jr, ref_fn, broadcast), _port(tl, tr, port_fn, broadcast))


# -- query level -----------------------------------------------------------------

def _ctxs(**cfg):
    jc = J.DryadContext(num_partitions_=P, config=J.DryadConfig(**cfg))
    jc.executor.events = EventLog(None)
    tc = T.DryadContext(num_partitions_=P, config=T.DryadConfig(**cfg), device="cpu")
    return jc, tc


def _assert_same(a, b, bounds=None):
    """``collect()`` results byte for byte; ``bounds`` maps a float
    column to its per-row bound on |port - ref|."""
    assert list(a) == list(b)
    for c in a:
        assert a[c].dtype == b[c].dtype, c
        if bounds and c in bounds:
            assert np.all(np.abs(a[c].astype(np.float64) - b[c]) <= bounds[c]), c
        elif a[c].dtype == object:
            assert a[c].tolist() == b[c].tolist(), c
        else:
            np.testing.assert_array_equal(a[c].view(np.uint8), b[c].view(np.uint8), err_msg=c)


def _join_sides(rng, n_left=300, n_right=12, keys=16):
    left = {"k": rng.integers(0, keys, n_left).astype(np.int32),
            "lv": np.arange(n_left, dtype=np.int32),
            "s": np.array([f"s{i}" for i in rng.integers(0, 9, n_left)], object)}
    right = {"k": np.arange(n_right, dtype=np.int32) % keys,
             "rv": (np.arange(n_right) * 1.5).astype(np.float32),
             "w": rng.integers(-50, 50, n_right).astype(np.int32),
             "s": np.array([f"s{i}" for i in range(n_right)], object)}
    return left, right


def _pivot(p, xp):
    """A concat-style selector: the first 3 ranks of ``w`` pivoted into
    columns (``xp`` is the backend's array module)."""
    def widen(cols):
        out = {"gj_lid": cols["gj_lid"]}
        for j in range(3):
            w = xp.where(cols["gj_rank"] == j, cols["w"], 0)
            out[f"w_{j}"] = w.to(torch.int32) if xp is torch else w.astype(xp.int32)
        return out

    mod = T if xp is torch else J
    schema = mod.Schema([("gj_lid", mod.ColumnType.INT32)]
                        + [(f"w_{j}", mod.ColumnType.INT32) for j in range(3)])
    return p.select(widen, schema=schema).group_by(
        "gj_lid", {f"w_{j}": ("sum", f"w_{j}") for j in range(3)})


def _jnp():
    import jax.numpy as jnp

    return jnp


GJ_SELECTORS = {
    "group_agg": (lambda p, xp: p.group_by("gj_lid", {"n": ("count", None), "sw": ("sum", "w")}),
                  {"n": 0, "sw": 0}, None),
    "top2_ordered": (lambda p, xp: p.where(lambda c: c["gj_rank"] < 2).group_by(
        "gj_lid", {"top2": ("sum", "w"), "nn": ("count", None)}), {"top2": 0, "nn": 0},
        [("rv", True)]),
    "rank_pivot": (_pivot, {f"w_{j}": 0 for j in range(3)}, [("w", False), ("rv", False)]),
}

JOIN_QUERIES = {
    "inner": lambda q, r, s: q.join(r, "k", strategy=s),
    "inner_string_key": lambda q, r, s: q.join(r, "s", strategy=s),
    "left": lambda q, r, s: q.left_join(r, "k", right_defaults={"rv": -1.0, "s": "none"},
                                        strategy=s),
    "semi": lambda q, r, s: q.semi_join(r, "k", strategy=s),
    "anti": lambda q, r, s: q.anti_join(r, "k", strategy=s),
    "count": lambda q, r, s: q.group_join_count(r, "k", strategy=s),
    "group_join_aggs": lambda q, r, s: q.group_join(
        r, "k", aggs={"n": ("count", None), "sw": ("sum", "w"), "mx": ("max", "rv")},
        defaults={"mx": -9.0}, strategy=s),
    "hash_partitioned_left": lambda q, r, s: q.hash_partition("k").join(r, "k", strategy=s)
    .group_by("k", {"n": ("count", None)}),
}


@pytest.mark.parametrize("strategy", ["shuffle", "broadcast", "auto"])
@pytest.mark.parametrize("name", sorted(JOIN_QUERIES))
def test_join_query_matches_reference(rng, name, strategy):
    left, right = _join_sides(rng)
    outs, plans = [], []
    for ctx, low in zip(_ctxs(), (jlower, tlower)):
        q = JOIN_QUERIES[name](ctx.from_arrays(left), ctx.from_arrays(right), strategy)
        outs.append(q.collect())
        plans.append(_ops(low([q.node], ctx.config, ctx.dictionary, P=P)))
    _assert_same(outs[1], outs[0])
    assert plans[0] == plans[1]
    assert len(next(iter(outs[1].values()))) > 0


@pytest.mark.parametrize("strategy", ["shuffle", "broadcast", "auto"])
@pytest.mark.parametrize("name", sorted(GJ_SELECTORS))
def test_group_join_selector_matches_reference(rng, name, strategy):
    left, right = _join_sides(rng, n_left=120, n_right=90, keys=8)
    sel, defaults, order = GJ_SELECTORS[name]
    outs = []
    for ctx, xp in zip(_ctxs(), (_jnp(), torch)):
        q = ctx.from_arrays(left).group_join(
            ctx.from_arrays(right), "k", selector=lambda p: sel(p, xp),
            defaults=defaults, order=order, strategy=strategy)
        outs.append(q.collect())
    _assert_same(outs[1], outs[0])


@pytest.mark.parametrize("strategy", ["shuffle", "broadcast", "auto"])
def test_rank_limit_hot_key_matches_reference(strategy):
    """80% of both sides on 3 keys: rank_limit=2 bounds the pairs before
    expansion (tests/test_group_join_full.py's shape)."""
    rng = np.random.default_rng(724)
    n = 2000
    k = np.where(rng.random(n) < 0.8, rng.integers(0, 3, n), rng.integers(0, 5000, n)).astype(np.int32)
    left = {"k": k, "lv": np.arange(n, dtype=np.int32)}
    right = {"k": k[rng.permutation(n)], "score": rng.integers(0, 100000, n).astype(np.int32)}
    outs = []
    for ctx in _ctxs():
        q = ctx.from_arrays(left).group_join(
            ctx.from_arrays(right), "k", order=[("score", "desc")], rank_limit=2,
            selector=lambda p: p.group_by("gj_lid", {"top2": ("sum", "score"), "m": ("count", None)}),
            defaults={"top2": 0, "m": 0}, strategy=strategy)
        outs.append(q.collect())
    _assert_same(outs[1], outs[0])
    assert outs[1]["m"].max() == 2


# -- the chip phases' queries at 2^14 rows ------------------------------------------

def _visits(rng, n, n_pages):
    pages = rng.permutation(np.arange(n_pages, dtype=np.int64) * 7919 + (1 << 40))
    ip_pool = rng.integers(-2**31, 2**31, max(8, n // 16), dtype=np.int64).astype(np.int32)
    visits = {
        "sourceIP": ip_pool[rng.integers(0, len(ip_pool), n)],
        "destURL": pages[rng.integers(0, n_pages, n)],
        "adRevenue": rng.gamma(2.0, 5.0, n).astype(np.float32),
        "visitDate": rng.integers(0, 4096, n).astype(np.int32),
    }
    rankings = {"pageURL": pages, "pageRank": rng.integers(0, 10000, n_pages).astype(np.int32),
                "avgDuration": rng.integers(1, 600, n_pages).astype(np.int32)}
    return visits, rankings


def _join_task(ctx, visits, rankings, lo, hi, limit=None):
    v = ctx.from_arrays(visits).where(lambda c: (c["visitDate"] >= lo) & (c["visitDate"] < hi))
    j = v.join(ctx.from_arrays(rankings), "destURL", "pageURL", strategy="auto", expansion=1.0)
    return j.group_by("sourceIP", {"totalRevenue": ("sum", "adRevenue"),
                                   "avgPageRank": ("mean", "pageRank"), "n": ("count", None)})


def _spy_strategy(monkeypatch):
    chosen = []
    real = TK._join_strategy

    def spy(ctx, p, right):
        chosen.append(real(ctx, p, right))
        return chosen[-1]

    monkeypatch.setattr(TK, "_join_strategy", spy)
    return chosen


def test_join_shuffle_query_matches_reference(rng, monkeypatch):
    """The Pavlo et al. Join Task at 2^14 visits, 2^11 pages: the right
    side's capacity is past ``broadcast_limit``, so ``auto`` shuffles."""
    visits, rankings = _visits(rng, 1 << 14, 1 << 11)
    chosen = _spy_strategy(monkeypatch)
    outs = []
    for ctx in _ctxs(broadcast_limit=1024):
        g = _join_task(ctx, visits, rankings, 700, 1100)
        outs.append(g.collect())
        top = g.order_by([("totalRevenue", True)]).take(1).collect()
        assert top["totalRevenue"][0] == outs[-1]["totalRevenue"].max()
    assert chosen == [False, False]
    # float64 oracle of the grouped table: keys and counts exact, sums
    # within the sort path's bound, the mean of int32 ranks to f32
    keep = (visits["visitDate"] >= 700) & (visits["visitDate"] < 1100)
    rank_of = dict(zip(rankings["pageURL"].tolist(), rankings["pageRank"].tolist()))
    ips, rev = visits["sourceIP"][keep], visits["adRevenue"][keep].astype(np.float64)
    pr = np.array([rank_of[u] for u in visits["destURL"][keep].tolist()], np.float64)
    uk, inv = np.unique(ips, return_inverse=True)
    cnt = np.bincount(inv)
    tot = np.bincount(inv, weights=rev)  # adRevenue > 0: sum |v| = sum v
    got = outs[1]
    at = np.searchsorted(uk, got["sourceIP"])
    np.testing.assert_array_equal(np.sort(got["sourceIP"]), uk)
    np.testing.assert_array_equal(got["n"], cnt[at])
    bound = cnt[at] * F32_REL * tot[at]
    assert np.all(np.abs(got["totalRevenue"] - tot[at]) <= bound)
    np.testing.assert_allclose(got["avgPageRank"], (np.bincount(inv, weights=pr) / cnt)[at],
                               rtol=2.0 ** -22)
    _assert_same(outs[1], outs[0], {"totalRevenue": bound})


def test_join_broadcast_query_matches_reference(rng, monkeypatch):
    """``samples/join_groupby.py`` at 2^14 orders: ``auto`` broadcasts
    the 1000 customers, then the dense group_by runs the bucket path."""
    n = 1 << 14
    orders = {"cust": rng.integers(0, 1000, n).astype(np.int32),
              "amount": rng.gamma(2.0, 10.0, n).astype(np.float32)}
    customers = {"cust": np.arange(1000, dtype=np.int32),
                 "region": (np.arange(1000) % 7).astype(np.int32)}
    chosen = _spy_strategy(monkeypatch)
    outs, plans = [], []
    for ctx, low in zip(_ctxs(), (jlower, tlower)):
        q = ctx.from_arrays(orders).join(ctx.from_arrays(customers), "cust", strategy="auto",
                                         expansion=1.0)
        q = q.group_by("region", {"total": ("sum", "amount"), "orders": ("count", None)}, dense=7)
        outs.append(q.collect())
        plans.append(_ops(low([q.node], ctx.config, ctx.dictionary, P=P)))
    assert chosen == [True]
    assert plans[0] == plans[1]
    assert [k for s in plans[1] for k, _ in s][-3:] == ["join", "group_reduce_dense", "project"]
    region = orders["cust"] % 7
    np.testing.assert_array_equal(outs[1]["orders"], np.bincount(region, minlength=7))
    exact = np.bincount(region, weights=orders["amount"].astype(np.float64), minlength=7)
    absv = np.bincount(region, weights=np.abs(orders["amount"].astype(np.float64)), minlength=7)
    assert np.all(np.abs(outs[1]["total"] - exact) <= 2.0 ** -16 * absv)
    _assert_same(outs[1], outs[0], {"total": 2.0 ** -16 * absv})


# -- stage op lists -----------------------------------------------------------------

def _view(k, v):
    if k == "aggs":
        return [(a.op, a.col, a.out) for a in v]
    if k == "operands_fn":
        return None if v is None else [(f.name, f.ctype.value, d) for f, d in v.fields]
    if k == "fn":
        return (type(v).__name__, sorted(vars(v).items()))
    if k == "tree":
        return {kk: _view(kk, vv) for kk, vv in v.items()}
    if k == "right_defaults" and v is not None:
        return {kk: np.asarray(vv).item() for kk, vv in v.items()}
    return v


def _ops(graph):
    return [[(op.kind, {k: _view(k, v) for k, v in op.params.items()}) for op in s.ops]
            for s in graph.stages]


def test_ranked_join_op_list_matches_reference(rng):
    left, right = _join_sides(rng)
    plans = []
    for ctx, low in zip(_ctxs(), (jlower, tlower)):
        q = ctx.from_arrays(left).group_join(
            ctx.from_arrays(right), "k", order=[("rv", True)], rank_limit=3,
            selector=lambda p: p.group_by("gj_lid", {"n": ("count", None)}), defaults={"n": 0},
            strategy="auto")
        plans.append(_ops(low([q.node], ctx.config, ctx.dictionary, P=P)))
    assert plans[0] == plans[1]
    kinds = [k for s in plans[1] for k, _ in s]
    assert "join_ranked" in kinds and "with_rank" in kinds and kinds.count("join") == 1


# -- overflow retries, and runs of stages retried whole -----------------------------

def _events(jc, tc):
    ref = [(e["kind"], e["name"], e.get("boost", e.get("nparts")))
           for e in jc.executor.events.events()
           if e["kind"] in ("stage_overflow", "stage_width_adapt")]
    return ref, list(tc.executor.events)


RETRY_QUERIES = {
    # the join's own expansion is too small: the stage retries
    "undersized_expansion": lambda c, L, R: c.from_arrays(L).join(
        c.from_arrays(R), "k", strategy="shuffle", expansion=2.0),
    # a range exchange before the join, in the same run: the retry reruns
    # the order_by with the boost too (more splitter samples)
    "range_exchange_before": lambda c, L, R: c.from_arrays(L).order_by([("lv", True)]).join(
        c.from_arrays(R), "k", strategy="shuffle", expansion=2.0),
    # a hash exchange before an auto join (its exchanges deferred to the
    # join kernel): the rerun exchange widens the join's base capacity
    "hash_exchange_before": lambda c, L, R: c.from_arrays(L).hash_partition(["lv"]).join(
        c.from_arrays(R), "k", strategy="auto", expansion=2.0),
    "ranked_undersized": lambda c, L, R: c.from_arrays(L).group_join(
        c.from_arrays(R), "k", selector=lambda p: p.group_by("gj_lid", {"n": ("count", None)}),
        defaults={"n": 0}, expansion=0.5, strategy="shuffle"),
    # an overflow-free dense aggregation and a sort-path one feed a
    # shuffle join: the join adapts its width from both observed counts
    "aggregations_feed_join": lambda c, L, R: c.from_arrays(L).group_by(
        "k", {"c": ("count", None)}).join(
        c.from_arrays({"d": (np.arange(4000) % 300).astype(np.int32)}).group_by(
            "d", {"m": ("count", None)}, dense=300), "k", "d", strategy="shuffle"),
}


@pytest.mark.parametrize("name", sorted(RETRY_QUERIES))
def test_retries_and_adaptation_match_reference(name):
    rng = np.random.default_rng(3)
    L = {"k": rng.integers(-50, 50, 3000).astype(np.int32), "lv": np.arange(3000, dtype=np.int32)}
    R = {"k": rng.integers(-50, 50, 2000).astype(np.int32),
         "rv": rng.standard_normal(2000).astype(np.float32)}
    jc, tc = _ctxs()
    outs = [RETRY_QUERIES[name](ctx, L, R).collect() for ctx in (jc, tc)]
    _assert_same(outs[1], outs[0])
    ref, port = _events(jc, tc)
    assert port == ref
    if name == "aggregations_feed_join":
        assert [e[0] for e in port] == ["stage_width_adapt"]
    else:
        assert [e[2] for e in port if e[0] == "stage_overflow"][:1] == [1]


def test_join_past_the_retry_budget_fails_as_the_reference():
    L = {"k": np.full(2000, 3, np.int32)}
    R = {"k": np.full(500, 3, np.int32), "v": np.arange(500, dtype=np.int32)}
    msgs = []
    for ctx, err in zip(_ctxs(max_shuffle_retries=1), (JStageFailed, StageFailedError)):
        with pytest.raises(err, match="raise the join's expansion") as ei:
            ctx.from_arrays(L).join(ctx.from_arrays(R), "k", strategy="shuffle").collect()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
