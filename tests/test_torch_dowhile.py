"""Iteration, materialization and the speculative dispatch window of the
port (dryad_tpu_torch, device="cpu") against the JAX package at P=8.

- ``do_while``: the reference's driver loop (body before condition,
  ``max_iter``, the state compacted after every round and its capacity
  boosted on overflow, ``do_while_device_auto=False`` in both), rows
  byte for byte and the ``do_while_iter`` / ``do_while_state_boost``
  events equal to the reference's driver loop; at the default settings
  the port's on-device loop gives the reference's on-device loop's rows
  and events (``tests/test_torch_devloop.py`` has the rest).
- ``cache``/``release``: a cached result is read by later queries
  without rerunning its pipeline, keeps its partition claim (a
  consumer on the same keys elides its exchange), is not evicted by the
  ingest cache's budget, and raises the stale-binding error once
  released.
- PageRank of ``samples/pagerank_dowhile.py`` at 64 nodes: the same
  rounds, nodes and top node as the reference, ranks within the sort
  path's float-sum bound, and within 1e-6 of a float64 numpy oracle.
- The window: an overflow-free unit dispatched while an overflow-capable
  one is open reports its row counts, so a stage it feeds adapts its
  width as in the reference; with ``overflow_sync_depth=1`` neither
  adapts; an overflow inside an open window reruns the window's rest.
"""

import numpy as np
import pytest
import torch

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.exec.events import EventLog
from dryad_tpu.plan.lower import lower as jlower
from dryad_tpu_torch.exec import kernels as TK
from dryad_tpu_torch.plan.lower import lower as tlower

P = 8
LOOP_EVENTS = ("do_while_iter", "do_while_state_boost", "do_while_max_iter")


def _ctxs(**cfg):
    # both driver loops: the on-device loops log no rounds
    jc = J.DryadContext(num_partitions_=P, config=J.DryadConfig(do_while_device_auto=False, **cfg))
    jc.executor.events = EventLog(None)
    tc = T.DryadContext(num_partitions_=P, config=T.DryadConfig(do_while_device_auto=False, **cfg),
                        device="cpu")
    return jc, tc


def _assert_same(a, b):
    assert list(a) == list(b)
    for c in a:
        assert a[c].dtype == b[c].dtype, c
        np.testing.assert_array_equal(a[c].view(np.uint8), b[c].view(np.uint8), err_msg=c)


def _events(jc, tc, kinds=LOOP_EVENTS + ("stage_overflow", "stage_width_adapt")):
    value = ("iter", "boost", "iters", "nparts")
    ref = [(e["kind"], next(e[v] for v in value if v in e))
           for e in jc.executor.events.events() if e["kind"] in kinds]
    return ref, [(k, v) for k, _name, v in tc.executor.events if k in kinds]


# -- do_while ----------------------------------------------------------------------

def _double(q):
    return q.select(lambda cols: {"x": cols["x"] * 2})


def _below_100(q):
    return q.aggregate_as_query({"m": ("max", "x")}).select(lambda cols: {"go": cols["m"] < 100.0})


def _dup(xp):
    def fn(cols):
        x = cols["x"]
        ones = xp.ones((x.shape[0], 2), dtype=xp.bool_ if hasattr(xp, "bool_") else torch.bool)
        return {"x": xp.stack([x, x + 1000], 1)}, ones
    return fn


def _count_below(n):
    return lambda q: q.count_as_query().select(lambda c: {"go": c["count"] < n})


def _jnp():
    import jax.numpy as jnp

    return jnp


LOOPS = {
    # tests/test_api_e2e.py: doubles until max >= 100
    "double": lambda c, xp: c.from_arrays({"x": np.array([1, 2, 3, 4], np.float32)}).do_while(
        _double, _below_100, max_iter=20),
    # tests/test_executor.py: cond false at once, the body still runs once
    "body_runs_once": lambda c, xp: c.from_arrays({"x": np.array([200, 300], np.float32)}).do_while(
        _double, _below_100, max_iter=20),
    "max_iter": lambda c, xp: c.from_arrays({"x": np.array([1, 2, 3], np.float32)}).do_while(
        _double, _below_100, max_iter=3),
    # tests/test_executor.py: the state doubles each round and outgrows
    # its compaction capacity, which boosts
    "growing_state": lambda c, xp: c.from_arrays({"x": np.arange(16, dtype=np.int32)}).do_while(
        lambda q: q.select_many(_dup(xp), 2), _count_below(100), max_iter=10),
    # a shrinking state with a shuffle in the body
    "group_by_body": lambda c, xp: c.from_arrays(
        {"x": np.arange(3000, dtype=np.int32) % 700}).do_while(
        lambda q: q.select(lambda cols: {"x": cols["x"] // 2}).group_by(
            "x", {"n": ("count", None)}).project(["x"]), _count_below(40), max_iter=12),
}


@pytest.mark.parametrize("name", sorted(LOOPS))
def test_do_while_matches_reference_driver_loop(name):
    jc, tc = _ctxs()
    outs = [LOOPS[name](ctx, xp).collect() for ctx, xp in zip((jc, tc), (_jnp(), torch))]
    _assert_same(outs[1], outs[0])
    ref, port = _events(jc, tc)
    assert port == ref
    rounds = [v for k, v in port if k == "do_while_iter"]
    assert rounds == list(range(1, len(rounds) + 1))
    if name == "growing_state":
        assert len(outs[1]["x"]) == 128 and ("do_while_state_boost", 2) in port
    if name == "body_runs_once":
        assert rounds == [1] and sorted(outs[1]["x"].tolist()) == [400.0, 600.0]
    if name == "max_iter":
        assert port[-1] == ("do_while_max_iter", 3)


@pytest.mark.parametrize("device", [False, True])
def test_do_while_rows_equal_reference_device_loop(device):
    """At the default settings both packages run a one-stage body as
    one on-device loop (``device=True`` or not): the same rows and the
    same ``do_while_device_*`` events."""
    jc = J.DryadContext(num_partitions_=P)
    tc = T.DryadContext(num_partitions_=P, device="cpu")
    outs = [c.from_arrays({"v": np.array([1.0, 2.0, 3.0], np.float32)}).do_while(
        lambda q: q.select(lambda cols: {"v": cols["v"] * 2}),
        lambda q: q.aggregate_as_query({"m": ("max", "v")}).select(
            lambda cols: {"go": cols["m"] < 100.0}),
        max_iter=20, device=device).collect() for c in (jc, tc)]
    _assert_same(outs[1], outs[0])
    assert max(outs[1]["v"]) == 192.0
    kinds = ("do_while_device_start", "do_while_device_done", "do_while_iter")
    ref = [(e["kind"], e.get("boost"), e.get("iters")) for e in jc.events.events() if e["kind"] in kinds]
    port = [(e["kind"], e.get("boost"), e.get("iters")) for e in tc.events.events() if e["kind"] in kinds]
    assert port == ref == [("do_while_device_start", 1, None), ("do_while_device_done", None, 6)]


def test_do_while_state_past_the_retry_budget_fails_as_the_reference():
    msgs = []
    for ctx, xp in zip(_ctxs(max_shuffle_retries=1), (_jnp(), torch)):
        with pytest.raises(RuntimeError, match="compaction capacity") as ei:
            ctx.from_arrays({"x": np.arange(16, dtype=np.int32)}).do_while(
                lambda q: q.select_many(_dup(xp), 2), _count_below(1000), max_iter=10).collect()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_do_while_subplans_are_built_once():
    _, tc = _ctxs()
    built = []

    def body(q):
        built.append(1)
        return _double(q)

    tc.from_arrays({"x": np.array([1.0], np.float32)}).do_while(body, _below_100).collect()
    assert len(built) == 1 and len(tc._subplans) == 2


# -- cache and release -------------------------------------------------------------

def test_cache_materializes_and_branches(rng, monkeypatch):
    """tests/test_api_e2e.py: later queries read the cached result; the
    group_by ran once."""
    n = 4000
    # integer sums: the sort path's float sums differ from the
    # reference's by rounding only (tests/test_torch_terasort.py)
    tbl = {"k": rng.integers(0, 100, n).astype(np.int32),
           "v": rng.integers(-1000, 1000, n).astype(np.int32)}
    ran = []
    real = TK._KERNELS["group_reduce"]
    monkeypatch.setitem(TK._KERNELS, "group_reduce", lambda ctx, p: (ran.append(1), real(ctx, p)))
    outs = []
    for ctx in _ctxs(auto_dense_ints=False):
        cached = ctx.from_arrays(tbl).group_by("k", {"s": ("sum", "v"), "c": ("count", None)}).cache()
        calls = len(ran)
        outs.append((cached.where(lambda cols: cols["c"] > 1).count(),
                     cached.order_by([("s", True)]).take(5).collect(),
                     cached.aggregate_as_query({"m": ("max", "s")}).collect()))
    assert len(ran) == calls == 2  # the partial and the final reduce, once
    assert outs[0][0] == outs[1][0] == int((np.bincount(tbl["k"]) > 1).sum())
    _assert_same(outs[1][1], outs[0][1])
    _assert_same(outs[1][2], outs[0][2])


def test_cache_partition_claim_elides_downstream_exchange(rng):
    tbl = {"k": rng.integers(0, 50, 2000).astype(np.int32),
           "v": rng.integers(-1000, 1000, 2000).astype(np.int32)}
    outs, kinds = [], []
    for ctx, low in zip(_ctxs(auto_dense_strings=False), (jlower, tlower)):
        cached = ctx.from_arrays(tbl).group_by("k", {"s": ("sum", "v")}).cache()
        follow = cached.group_by("k", {"m": ("max", "s")})
        kinds.append([op.kind for st in low([follow.node], ctx.config, ctx.dictionary).stages
                      for op in st.ops])
        outs.append(follow.collect())
    assert kinds[0] == kinds[1] and "exchange_hash" not in kinds[1]
    _assert_same(outs[1], outs[0])
    assert len(outs[1]["k"]) == len(np.unique(tbl["k"]))


def test_cache_release_and_stale_binding_error(rng):
    tbl = {"k": rng.integers(0, 10, 200).astype(np.int32)}
    for ctx in _ctxs():
        c = ctx.from_arrays(tbl).group_by("k", {"n": ("count", None)}).cache()
        assert c.count() == len(np.unique(tbl["k"]))
        ctx.release(c)
        with pytest.raises(RuntimeError, match="no binding"):
            c.collect()
        with pytest.raises(ValueError, match="release"):
            ctx.release(ctx.from_arrays(tbl))
        with pytest.raises(ValueError, match="release"):
            ctx.release(ctx.from_arrays(tbl).where(lambda cols: cols["k"] > 1))


def test_cached_table_is_pinned_outside_the_ingest_cache(rng):
    """A budget of one byte keeps only the newest ingest; the cached
    table stays resident and is read, not recomputed."""
    tc = T.DryadContext(num_partitions_=P, config=T.DryadConfig(device_cache_bytes=1), device="cpu")
    base = tc.from_arrays({"k": np.arange(64, dtype=np.int32)}).where(lambda c: c["k"] % 2 == 0)
    cached = base.cache()
    for i in range(3):
        tc.from_arrays({"k": np.arange(8 + i, dtype=np.int32)}).count()
    assert len(tc._device_cache) == 1 and cached.node.id not in tc._device_cache
    batch = tc._bindings[cached.node.id][1]
    assert tc.execute(cached) is batch
    assert sorted(cached.collect()["k"].tolist()) == list(range(0, 64, 2))


# -- PageRank (samples/pagerank_dowhile.py) ---------------------------------------------

DAMP, EPS, N_NODES = 0.85, 1e-4, 64


def _contrib_row(c):
    return {"node": c["dst"], "c": c["w"] * c["rank"]}


def _apply_rank(c):
    return {"node": c["node"], "rank": (1.0 - DAMP) / N_NODES + DAMP * c["inflow"], "prev": c["rank"]}


def _delta_row(c):
    return {"d": abs(c["rank"] - c["prev"])}


def _go_row(c):
    return {"go": c["m"] > EPS}


def _pagerank(ctx, src, dst, w):
    edges = ctx.from_arrays({"src": src, "dst": dst, "w": w}).cache()
    state = ctx.from_arrays({"node": np.arange(N_NODES, dtype=np.int32),
                             "rank": np.full(N_NODES, 1.0 / N_NODES, np.float32),
                             "prev": np.zeros(N_NODES, np.float32)})

    def body(q):
        contrib = (edges.join(q, "src", "node").select(_contrib_row)
                   .group_by("node", {"inflow": ("sum", "c")}))
        return q.left_join(contrib, "node").select(_apply_rank)

    def cond(q):
        return q.select(_delta_row).aggregate_as_query({"m": ("max", "d")}).select(_go_row)

    return state.do_while(body, cond, max_iter=50).order_by([("rank", True)]).collect()


def test_pagerank_matches_reference_and_numpy():
    rng = np.random.default_rng(7)
    src = rng.integers(0, N_NODES, 400).astype(np.int32)
    dst = rng.integers(0, N_NODES, 400).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    deg = np.bincount(src, minlength=N_NODES).astype(np.float32)
    w = (1.0 / np.maximum(deg, 1.0))[src].astype(np.float32)
    jc, tc = _ctxs()
    ref, port = (_pagerank(c, src, dst, w) for c in (jc, tc))
    ref_events, port_events = _events(jc, tc)  # rounds, and the retries the sample's query takes
    assert port_events == ref_events
    rounds = _events(jc, tc, ("do_while_iter",))
    assert len(rounds[1]) > 3
    assert sorted(port["node"].tolist()) == list(range(N_NODES))
    assert port["node"][0] == ref["node"][0]
    by_node = lambda t, c: t[c][np.argsort(t["node"])].astype(np.float64)  # noqa: E731
    # the sort path's f32 sums: within n_g * 2^-23 * sum|v| a round
    assert np.all(np.abs(by_node(port, "rank") - by_node(ref, "rank")) <= 2e-7 * len(rounds[1]))
    r = np.full(N_NODES, 1.0 / N_NODES)
    for _ in range(len(rounds[1])):
        r = (1.0 - DAMP) / N_NODES + DAMP * np.bincount(dst, weights=w * r[src], minlength=N_NODES)
    assert np.all(np.abs(by_node(port, "rank") - r) <= 1e-6)


# -- the speculative dispatch window -------------------------------------------------

def _window_query(c, expansion):
    """Units: [the sort-path and dense aggregations] (overflow-capable),
    [join] (adapts alone), [a dense aggregation] (overflow-free),
    [join] (adapts alone; its left exchange elided)."""
    rng = np.random.default_rng(3)
    a = c.from_arrays({"k": rng.integers(0, 100, 3000).astype(np.int32)}).group_by(
        "k", {"c": ("count", None)})
    b = c.from_arrays({"d": (np.arange(4000) % 300).astype(np.int32)}).group_by(
        "d", {"m": ("count", None)}, dense=300)
    j1 = a.join(b, "k", "d", strategy="shuffle", expansion=expansion)
    e = c.from_arrays({"e": (np.arange(2000) % 50).astype(np.int32)}).group_by(
        "e", {"n": ("count", None)}, dense=50)
    return j1.join(e, "k", "e", strategy="shuffle")


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("case", ["overflow_free_count", "overflow_in_open_window"])
def test_window_counts_and_reruns_match_reference(case, depth):
    jc, tc = _ctxs(overflow_sync_depth=depth, tail_fanout_rows=4096)
    expansion = 1.0 if case == "overflow_free_count" else 0.05
    outs = [_window_query(c, expansion).collect() for c in (jc, tc)]
    _assert_same(outs[1], outs[0])
    ref, port = _events(jc, tc)
    assert port == ref
    adapts = [e for e in port if e[0] == "stage_width_adapt"]
    if case == "overflow_free_count":
        # the last join adapts from the dense aggregation's count only
        # when the window holds it
        assert adapts == ([("stage_width_adapt", 1)] if depth == 4 else [])
    else:
        assert ("stage_overflow", 1) in port


def test_overflow_sync_depth_is_validated():
    with pytest.raises(ValueError, match="overflow_sync_depth"):
        T.DryadContext(num_partitions_=P, config=T.DryadConfig(overflow_sync_depth=0), device="cpu")
    assert T.DryadConfig().overflow_sync_depth == J.DryadConfig().overflow_sync_depth == 4
