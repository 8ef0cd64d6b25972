"""The combine tree and the partial-aggregation algebra:
the port (``exec/combinetree.py``, ``exec/partial.py``,
``obs/metrics.py``) against the JAX package.

The tree's streaming group_by runs in both packages on the same seeded
chunks at P=8 (the reference on its 8-device CPU mesh), each case at the
default config (the diagnosis engine and the runtime plan rewriter on in
both packages) and with both off, and on the 2 x 4 hybrid mesh: equal groups, byte-equal integer
aggregates, equal ``combine_tree_*``/``stream_*`` event counts, equal
``diagnosis`` and ``plan_rewrite`` events, and intermediate merges that
move no exchange bytes.  The placement,
planner, histogram and partial-state helpers are held against the
reference's on the same inputs.
"""

import collections

import numpy as np
import pytest

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.exec import combinetree as jct
from dryad_tpu.exec import partial as jpartial
from dryad_tpu.obs.metrics import KeyRangeHistogram as JHist
from dryad_tpu_torch.exec import combinetree as tct
from dryad_tpu_torch.exec import partial as tpartial
from dryad_tpu_torch.obs.metrics import KeyRangeHistogram as THist
from dryad_tpu_torch.obs.metrics import MetricsRegistry
from dryad_tpu_torch.parallel import mesh as TM

P = 8


# the reference's config, and the port's beside it: the defaults (the
# diagnosis engine and the plan rewriter on) or both off
REF = pytest.mark.parametrize("ref", ["default", "off"])
# diagnosis rules that follow the wall clock
WALL_CLOCK_RULES = ("straggler", "stall_dominance", "recompile_storm")


def _ctxs(ref="off", hybrid=False, **cfg):
    """The two packages' contexts at P=8: flat, or with ``hybrid`` on
    the 2 x 4 DCN x ICI mesh."""
    if ref == "off":
        cfg = dict(cfg, obs_diagnosis=False, plan_rewrite=False)
    mesh = {"dcn_slices": 2} if hybrid else {"num_partitions_": P}
    jc = J.DryadContext(config=J.DryadConfig(**cfg), **mesh)
    tc = T.DryadContext(config=T.DryadConfig(**cfg), device="cpu", **mesh)
    return jc, tc


def _counts(events):
    """Counts of the streaming kinds, the diagnoses (rule and subject;
    wall-clock rules left out) and the rewriter's events."""
    out = collections.Counter(
        e["kind"] for e in events if e["kind"].startswith(("stream_", "combine_tree_")))
    for e in events:
        if e["kind"] == "diagnosis" and e["rule"] not in WALL_CLOCK_RULES:
            out[("diagnosis", e["rule"], e["evidence"].get("subject"))] += 1
        elif e["kind"] == "plan_rewrite":
            out[("plan_rewrite",) + tuple(e.get(f) for f in ("action", "phase", "rule",
                                                              "subject", "mode"))] += 1
    return out


def _sorted(out):
    o = np.argsort(np.asarray(out["k"]), kind="stable")
    return {c: np.asarray(v)[o] for c, v in out.items()}


def _run(chunks, aggs, ref="off", hybrid=False, **cfg):
    outs, evs = [], []
    for c in _ctxs(ref, hybrid, **cfg):
        q = c.from_stream(iter([{k: v.copy() for k, v in ch.items()} for ch in chunks]))
        outs.append(_sorted(q.group_by("k", aggs).collect()))
        evs.append(c.executor.events.events() if isinstance(c, J.DryadContext) else c.events.events())
    assert _counts(evs[1]) == _counts(evs[0])
    for col in outs[0]:
        assert outs[0][col].tobytes() == outs[1][col].tobytes(), col
    return outs[1], evs[1]


def _oracle(chunks, out):
    allk = np.concatenate([c["k"] for c in chunks])
    uk, cnt = np.unique(allk, return_counts=True)
    assert np.array_equal(out["k"], uk)
    assert np.array_equal(out["c"].astype(np.int64), cnt)


def _chunks(seed, n, rows, lo, hi, dtype=np.int64, tail=None):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = rng.integers(lo, hi, rows)
        if tail is not None:
            k = np.concatenate([k, rng.integers(*tail)])
            rng.shuffle(k)
        out.append({"k": k.astype(dtype), "v": rng.integers(-50, 50, len(k)).astype(np.int64)})
    return out


CASES = {
    # a reducing stream: hierarchical merges, no degrade
    "reducing": (dict(seed=0, n=6, rows=1500, lo=0, hi=60), dict(stream_combine_rows=2000)),
    # high cardinality: ranges degrade to host, union still exact
    "degrade": (dict(seed=7, n=4, rows=2500, lo=0, hi=5_000_000),
                dict(stream_combine_rows=2000, combine_tree_ranges=4)),
    # skew: the heavy ranges stay on the device, the tail degrades
    "skewed": (dict(seed=13, n=4, rows=2000, lo=0, hi=8, tail=(1000, 4_000_000, 2000)),
               dict(stream_combine_rows=2000, combine_tree_ranges=8)),
    # small groups and a tight budget: level-1 folds of representatives
    "deep": (dict(seed=21, n=12, rows=600, lo=0, hi=400, dtype=np.int32),
             dict(stream_combine_rows=300, combine_tree_fan=2)),
}


@REF
@pytest.mark.parametrize("case", list(CASES))
def test_tree_group_matches_reference(case, ref):
    gen, cfg = CASES[case]
    chunks = _chunks(**gen)
    out, evs = _run(chunks, {"c": ("count", None), "s": ("sum", "v"), "mn": ("min", "v")}, ref,
                    **cfg)
    _oracle(chunks, out)
    levels = [e for e in evs if e["kind"] == "combine_tree_level"]
    deg = [e for e in evs if e["kind"] == "combine_tree_degrade"]
    if case in ("reducing", "deep"):
        assert levels and not deg
        # intermediate merges elide the exchange: zero collective bytes
        top = max(e["level"] for e in levels)
        assert all(e["ici_bytes"] == 0 and e["dcn_bytes"] == 0 for e in levels if e["level"] < top)
    if case == "deep":
        assert any(e["level"] == 1 for e in levels)
    if case == "degrade":
        assert deg and 0.0 < deg[-1]["fraction"] <= 1.0
        assert deg[-1]["degraded"] >= deg[0]["degraded"]  # monotone
    if case == "skewed":
        assert deg and deg[-1]["fraction"] < 1.0


@REF
def test_host_reprobe_returns_to_device_like_reference(ref):
    rng = np.random.default_rng(11)
    first = {"k": np.arange(3000, dtype=np.int64), "v": np.ones(3000, np.int64)}
    rest = [{"k": rng.integers(0, 3000, 4000).astype(np.int64), "v": np.ones(4000, np.int64)}
            for _ in range(6)]
    chunks = [first] + rest
    out, evs = _run(chunks, {"c": ("count", None)}, ref, combine_tree=False,
                    stream_combine_rows=500, stream_host_reprobe=2)
    _oracle(chunks, out)
    pol = [e for e in evs if e["kind"] == "stream_combine_policy"]
    assert any(e.get("static") for e in pol)
    assert any(e["mode"] == "device" and e.get("reprobe") for e in pol)


@REF
def test_first_aggregate_stays_flat_like_reference(ref):
    rng = np.random.default_rng(5)
    chunks = [{"k": rng.integers(0, 30, 800).astype(np.int32),
               "v": rng.integers(0, 100, 800).astype(np.int64)} for _ in range(4)]
    out, evs = _run(chunks, {"f": ("first", "v"), "c": ("count", None)}, ref)
    assert len(out["k"]) == 30
    assert not [e for e in evs if e["kind"] == "combine_tree_level"]


@REF
def test_group_by_a_computed_key(ref):
    """A group key that a row-local node computes cannot be hashed on
    the raw chunk: the port's tree takes a neutral snapshot for it and
    groups correctly, where the reference's driver raises KeyError
    (a reference fault, not copied)."""
    from dryad_tpu_torch.columnar.schema import ColumnType, Schema

    rng = np.random.default_rng(3)
    chunks = [{"x": rng.integers(0, 10**6, 1500).astype(np.int32)} for _ in range(4)]
    allx = np.concatenate([c["x"] for c in chunks])
    jc, tc = _ctxs(ref, stream_combine_rows=500)
    with pytest.raises(KeyError):
        jc.from_stream(iter([dict(c) for c in chunks])).select(
            lambda cols: {"k": cols["x"] % 97},
            schema=J.Schema([("k", J.ColumnType.INT32)]),
        ).group_by("k", {"c": ("count", None)}).collect()
    out = tc.from_stream(iter([dict(c) for c in chunks])).select(
        lambda cols: {"k": cols["x"] % 97}, schema=Schema([("k", ColumnType.INT32)]),
    ).group_by("k", {"c": ("count", None)}).collect()
    uk, cnt = np.unique(allx % 97, return_counts=True)
    o = _sorted(out)
    assert np.array_equal(o["k"], uk) and np.array_equal(o["c"], cnt.astype(np.int32))


# -- placement, planner, histograms -------------------------------------------


def test_key_range_histogram_equals_reference():
    rng = np.random.default_rng(0)
    few = rng.integers(0, 32, 20000).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    uniq = rng.integers(0, 2**63, 20000, dtype=np.int64).astype(np.uint64)
    for ranges in (4, 64):
        hj, ht = JHist(ranges), THist(ranges)
        for h in (few, uniq, few[:7]):
            a, b = JHist(ranges), THist(ranges)
            a.observe(h)
            b.observe(h)
            hj.merge(a)
            ht.merge(b)
        sj, st = hj.snapshot(), ht.snapshot()
        assert sj["rows"] == st["rows"] == 40007
        for f in ("counts", "distinct", "reduction_ratios"):
            assert np.asarray(sj[f]).tobytes() == np.asarray(st[f]).tobytes(), f
        assert np.array_equal(JHist.range_ids(uniq, ranges), THist.range_ids(uniq, ranges))
    with pytest.raises(ValueError):
        THist(48)
    with pytest.raises(ValueError):
        THist(4).merge(THist(8))


def test_planner_and_placement_equal_reference():
    rows = 4 * tct.MIN_DEGRADE_ROWS
    snap = {"ranges": 4, "rows": rows * 4, "counts": [rows] * 4,
            "distinct": [rows * 0.01, rows * 0.2, rows * 0.9, rows * 1.0],
            "reduction_ratios": [0.01, 0.2, 0.9, 1.0]}
    for mod in (jct, tct):
        p = mod.CombineTreePlanner(4, degrade_ratio=0.75)
        p.note_cumulative(snap)
        assert p.degrade_set() == {2, 3} and p.degraded_fraction() == 0.5
        p.note_cumulative({**snap, "distinct": [0.0] * 4})
        assert p.degrade_set() == {2, 3}  # monotone
        few = tct.MIN_DEGRADE_ROWS // 2
        q = mod.CombineTreePlanner(2, degrade_ratio=0.75)
        q.note_chunk({"counts": [few, few], "distinct": [few, few]})
        assert q.degrade_set() == set()  # below the evidence floor
    lo = {"counts": [100, 100, 0, 0], "distinct": [5, 5, 0, 0]}
    hi = {"counts": [0, 0, 100, 100], "distinct": [0, 0, 5, 5]}
    rng = np.random.default_rng(1)
    snaps = [lo, hi, lo, hi, lo, hi] + [
        {"counts": rng.integers(0, 50, 4).tolist()} for _ in range(20)]
    for n in (1, 2, 3, 5):
        assert tct.plan_groups(snaps, n) == jct.plan_groups(snaps, n)
    assert sorted(sorted(g) for g in tct.plan_groups(snaps[:6], 2)) == [[0, 2, 4], [1, 3, 5]]
    assert tct.place(tct.neutral_snapshot(4), [None, [1.0, 0, 0, 0]]) == 0
    assert tct.neutral_snapshot(8) == jct.neutral_snapshot(8)


class _ShapeCfg:
    combine_tree_groups = 0
    combine_tree_fan = 16


def test_tree_shape_on_one_device():
    shape = tct.TreeShape(TM.make_mesh(P, "cpu"), _ShapeCfg())
    ref = jct.TreeShape(J.parallel.mesh.make_mesh(P), _ShapeCfg())
    assert (shape.groups, shape.fan, shape.dcn_slices, shape.ici_partitions) == (
        ref.groups, ref.fan, ref.dcn_slices, ref.ici_partitions)
    for a, b in ((1000, 100), (8, 8), (10**9, 1)):
        assert shape.exchange_split(a, b) == ref.exchange_split(a, b)

    class _Cfg:
        combine_tree_groups, combine_tree_fan = 3, 1

    shape = tct.TreeShape(TM.make_mesh(P, "cpu"), _Cfg())
    assert shape.groups == 3 and shape.fan == 2


@pytest.mark.parametrize("dcn", [1, 2, 4])
def test_tree_shape_on_a_hybrid_mesh(dcn):
    """The hybrid geometry: one level-0 group a slice, and the ICI/DCN
    split of an exchange, equal to the reference's on its 2-D mesh."""
    shape = tct.TreeShape(TM.make_hybrid_mesh(dcn, P // dcn, "cpu"), _ShapeCfg())
    ref = jct.TreeShape(J.parallel.mesh.make_hybrid_mesh(dcn, P // dcn), _ShapeCfg())
    assert (shape.groups, shape.fan, shape.dcn_slices, shape.ici_partitions) == (
        ref.groups, ref.fan, ref.dcn_slices, ref.ici_partitions) == (
        ref.groups, 16, dcn, P // dcn)
    for a, b in ((1000, 100), (8, 8), (10**9, 1), (77, 10**6)):
        assert shape.exchange_split(a, b) == ref.exchange_split(a, b)


def test_tree_hybrid_mesh_single_dcn_crossing():
    """The reference's case on both packages' 2 x 4 meshes: the stream's
    intermediate merges move nothing, and exactly one level, the root,
    crosses the DCN.  The groups, the counts and every
    ``combine_tree_level`` event's level, fan-in and layout rows equal
    the reference's; the root's split is the reference's rule (hop 1
    over ICI at the input bytes, 3/4 of them crossing a 4-partition
    slice) over the port's compacted bytes
    (``test_tree_batches_are_compacted_on_the_same_cadence``)."""
    rng = np.random.default_rng(3)
    chunks = [{"k": rng.integers(0, 50, 1200).astype(np.int64), "v": np.ones(1200, np.int64)}
              for _ in range(5)]
    outs, levels = [], []
    for c in _ctxs("off", hybrid=True, stream_combine_rows=2000):
        q = c.from_stream(iter([{k: v.copy() for k, v in ch.items()} for ch in chunks]))
        outs.append(_sorted(q.group_by("k", {"c": ("count", None)}).collect()))
        evs = c.executor.events.events() if isinstance(c, J.DryadContext) else c.events.events()
        levels.append([e for e in evs if e["kind"] == "combine_tree_level"])
    _oracle(chunks, outs[1])
    for col in outs[0]:
        assert outs[0][col].tobytes() == outs[1][col].tobytes(), col
    shape = [[(e["level"], e["fan_in"], e["cap_rows"]) for e in lv] for lv in levels]
    assert shape[1] == shape[0] and shape[1]
    for lv in levels:
        top = max(e["level"] for e in lv)
        crossing = [e for e in lv if e["dcn_bytes"] > 0]
        assert len(crossing) == 1 and crossing[0]["level"] == top
        assert crossing[0]["ici_bytes"] == crossing[0]["bytes"] * 3 // 4
        assert all(e["dcn_bytes"] == 0 and e["ici_bytes"] == 0 for e in lv if e["level"] < top)


def test_tree_combiner_routes_and_folds():
    """The combiner alone over stand-in batches: level-0 flushes at the
    group threshold or the fan, level-1 folds, ``fold(1)`` leaves one."""
    import torch

    class B:
        def __init__(self, rows):
            self.valid = torch.ones(P, rows, dtype=torch.bool)
            self.data = {"k": torch.zeros(P, rows, dtype=torch.int32)}

    class Cfg:
        combine_tree_groups = 2
        combine_tree_fan = 3

    merges, events = [], []
    comb = tct.TreeCombiner(
        lambda bs: merges.append(len(bs)) or B(sum(b.valid.shape[1] for b in bs) // 2),
        tct.TreeShape(TM.make_mesh(P, "cpu"), Cfg()), 64, lambda kind, **f: events.append((kind, f)),
    )
    lo = {"counts": [10, 0]}
    hi = {"counts": [0, 10]}
    for i in range(7):
        comb.push(B(4), lo if i % 2 else hi)
    assert tct.layout_rows(B(4)) == 32 and tct.batch_bytes(B(4)) == 32 * 4 + 32
    left = comb.fold(1)
    assert len(left) == 1 and comb.drain() == []
    assert all(k == "combine_tree_level" for k, _ in events)
    assert {f["level"] for _, f in events} <= {0, 1} and merges


# -- the partial-aggregation algebra -------------------------------------------


AGGS = [("sum", "v", "s"), ("count", None, "c"), ("mean", "v", "mu"),
        ("min", "v", "lo"), ("max", "w", "hi"), ("any", "b", "an"), ("all", "b", "al"),
        ("first", "v", "f")]


def test_partial_plan_and_merge_spec_equal_reference():
    for m in (jpartial, tpartial):
        assert m.MERGEABLE_AGGS == jpartial.MERGEABLE_AGGS
        assert m.LINEAR_AGGS == jpartial.LINEAR_AGGS
    assert tpartial.partial_plan(AGGS) == jpartial.partial_plan(AGGS)
    partial, plan = tpartial.partial_plan(AGGS)
    assert tpartial.merge_agg_spec(plan) == jpartial.merge_agg_spec(plan)
    assert tpartial.state_reductions(plan) == jpartial.state_reductions(plan)
    assert tpartial.plan_is_linear(plan) == jpartial.plan_is_linear(plan) is False
    assert tpartial.plan_is_linear(tpartial.partial_plan(AGGS[:3])[1])


def test_state_helpers_equal_reference():
    rng = np.random.default_rng(4)
    n = 500
    cols = {
        "k": rng.integers(0, 30, n).astype(np.int32),
        "s": np.array([f"w{i}" for i in rng.integers(0, 9, n)], object),
        "f": rng.standard_normal(n),
        "v": rng.integers(-100, 100, n).astype(np.int64),
        "b": rng.random(n) < 0.5,
    }
    for keys in (["k"], ["s"], ["k", "s"], ["f"], ["b"]):
        assert tpartial.key_hash64(cols, keys).tobytes() == jpartial.key_hash64(cols, keys).tobytes()
    aggs = [("sum", "v", "s1"), ("count", None, "c"), ("min", "v", "lo"), ("mean", "v", "mu"),
            ("any", "b", "an")]
    seeded_t = tpartial.seed_state_rows(cols, aggs)
    seeded_j = jpartial.seed_state_rows(cols, aggs)
    assert {c: v.tobytes() for c, v in seeded_t.items()} == {c: v.tobytes() for c, v in seeded_j.items()}
    with pytest.raises(ValueError):
        tpartial.seed_state_rows(cols, [("first", "v", "f")])
    _, plan = tpartial.partial_plan(aggs)
    red = tpartial.state_reductions(plan)
    state = {"k": cols["k"], **seeded_t}
    mt, mj = tpartial.merge_state_rows(state, ["k"], red), jpartial.merge_state_rows(state, ["k"], red)
    assert list(mt) == list(mj)
    for c in mt:
        assert np.asarray(mt[c]).tobytes() == np.asarray(mj[c]).tobytes(), c
    halves = [{c: v[: n // 2] for c, v in state.items()}, {c: v[n // 2:] for c, v in state.items()}]
    ka_t, mats_t = tpartial.align_partials(halves, ["k"], ["s1__p", "c__p"])
    ka_j, mats_j = jpartial.align_partials(halves, ["k"], ["s1__p", "c__p"])
    assert ka_t["k"].tobytes() == ka_j["k"].tobytes()
    assert all((mats_t[c] == mats_j[c]).all() for c in mats_t)
    ct = tpartial.coded_combine(halves, [1, 2], ["k"], ["s1__p", "c__p"])
    cj = jpartial.coded_combine(halves, [1, 2], ["k"], ["s1__p", "c__p"])
    assert {c: v.tobytes() for c, v in ct.items()} == {c: v.tobytes() for c, v in cj.items()}
    out = {}
    tpartial.copy_physical({"w#h0": 1, "w#h1": 2, "x": 3}, "w", "y", out)
    assert out == {"y#h0": 1, "y#h1": 2}
    with pytest.raises(KeyError):
        tpartial.copy_physical({}, "w", "y", out)


def test_finalize_fn_equals_reference():
    import jax.numpy as jnp
    import torch

    _, plan = tpartial.partial_plan([("mean", "v", "mu"), ("sum", "w", "s"), ("count", None, "n")])
    rng = np.random.default_rng(2)
    ps = (rng.standard_normal(64) * 1000).astype(np.float32)
    pc = rng.integers(0, 9, 64).astype(np.int32)  # zero counts: the denominator clamps to 1
    w = rng.integers(-9, 9, 64).astype(np.int32)
    cols = {"mu__ps": ps, "mu__pc": pc, "s__p": w, "n__p": pc}
    got = tpartial.finalize_fn(plan)({c: torch.from_numpy(v) for c, v in cols.items()})
    ref = jpartial.finalize_fn(plan)({c: jnp.asarray(v) for c, v in cols.items()})
    assert list(got) == list(ref)
    for c in got:
        assert got[c].numpy().tobytes() == np.asarray(ref[c]).tobytes(), c
    with pytest.raises(KeyError, match="split-word"):
        tpartial.finalize_fn(plan)({"mu__ps#h0": 1})


def test_metrics_registry():
    m = MetricsRegistry()
    m.add("spill_bytes", 10, depth=0)
    m.add("spill_bytes", 5, depth=1)
    m.add("spill_bytes", 1, depth=0)
    for v in (3, 1000, 0.5):
        m.observe("partition_rows", v, depth=0)
    snap = m.snapshot()
    assert [(c["labels"], c["value"]) for c in snap["counters"]] == [
        ({"depth": "0"}, 11.0), ({"depth": "1"}, 5.0)]
    (h,) = snap["hists"]
    assert (h["n"], h["min"], h["max"]) == (3, 0.5, 1000)
    assert h["buckets"] == {"0": 1, "2": 1, "10": 1}
    from dryad_tpu_torch.exec.events import EventLog

    log = EventLog(None)
    m.emit(log)
    (ev,) = log.filter("metrics")
    assert ev["counters"] == snap["counters"]


@REF
def test_tree_batches_are_compacted_on_the_same_cadence(ref):
    """The reference's partials keep their exchange's padding (twice the
    chunk's rows) and its elided merges the sum of their inputs', so its
    tree's batches grow with the stream.  The port compacts each partial
    and merge to its rows: the merges' input bytes shrink to the keys',
    while the flush cadence and the reported layout rows stay the
    reference's."""
    rng = np.random.default_rng(8)
    chunks = [{"k": rng.integers(0, 64, 4096).astype(np.int64),
               "v": rng.integers(0, 9, 4096).astype(np.int64)} for _ in range(8)]
    levels = []
    for c in _ctxs(ref, stream_combine_rows=2000):
        c.from_stream(iter([dict(ch) for ch in chunks])).group_by(
            "k", {"c": ("count", None), "s": ("sum", "v")}).collect()
        evs = c.executor.events.events() if isinstance(c, J.DryadContext) else c.events.events()
        levels.append([e for e in evs if e["kind"] == "combine_tree_level"])
    jlv, port = levels
    assert [(e["level"], e["fan_in"], e["cap_rows"]) for e in port] == \
        [(e["level"], e["fan_in"], e["cap_rows"]) for e in jlv]
    assert jlv[-1]["cap_rows"] >= 2 * 8 * 4096  # the reference's padding, summed
    # each input holds at most 64 keys: a few rows a partition after
    # compaction, against the reference's thousands of padded slots
    for r, t in zip(jlv, port):
        assert t["bytes"] * 20 <= r["bytes"]
