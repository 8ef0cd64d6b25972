"""TeraSort, the sort-path group_by, distinct and the partitioning
operators end to end: the port (dryad_tpu_torch, device="cpu") against
the JAX package on its 8-device CPU mesh, both at P=8.

``collect()`` output is compared byte for byte, row order included, for
keys, counts, integer and 64-bit aggregates, min/max/first/any/all.
Float32 sums and means (fixed point in the port, f32 in row order in
the reference): per group |port - ref| <= n_g * 2^-23 * sum_g |v|.
Each query runs at full width (2^14 rows straight from ``from_arrays``)
and fan-reduced (behind a statically small node, so its exchanges
concentrate on fewer partitions).  The stage op lists, the overflow
retries and the observed-volume width adaptation are held against the
reference's too."""

import numpy as np
import pytest

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.exec.events import EventLog
from dryad_tpu.exec.executor import StageFailedError as JStageFailed
from dryad_tpu.plan.lower import lower as jlower
from dryad_tpu_torch.exec.executor import StageFailedError
from dryad_tpu_torch.plan.lower import lower as tlower

P = 8
F32_REL = 2.0 ** -23


def _ctxs(**cfg):
    jc = J.DryadContext(num_partitions_=P, config=J.DryadConfig(**cfg))
    jc.executor.events = EventLog(None)
    tc = T.DryadContext(num_partitions_=P, config=T.DryadConfig(**cfg), device="cpu")
    return jc, tc


def _table(rng, n, hot=None):
    k = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    if hot is not None:
        k = np.where(rng.random(n) < hot, 12345, k).astype(np.int32)
    return {
        "k": k,
        "g": rng.integers(-60, 60, n).astype(np.int32),  # negative group keys
        "d": rng.integers(0, 3000, n).astype(np.int32),  # a dense-able key
        "b": rng.random(n) < 0.5,
        "s": np.array([f"w{i}" for i in rng.integers(0, 90, n)], object),
        "v": (rng.standard_normal(n) * 10.0 ** rng.integers(-2, 3, n)).astype(np.float32),
        "w": rng.integers(-1000, 1000, n).astype(np.int32),
        "L": rng.integers(-2**40, 2**40, n, dtype=np.int64),  # past 2^32
        "id": np.arange(n, dtype=np.int32),
    }


# every op's kernel is held against the reference's in every output slot
# by tests/test_torch_segmented.py; here each decomposition path once
AGGS = {"c": ("count", None), "sv": ("sum", "v"), "mv": ("mean", "v"), "mnw": ("min", "w"),
        "sL": ("sum", "L"), "mL": ("mean", "L"), "fw": ("first", "w"), "ab": ("any", "b")}

QUERIES = {
    "terasort_asc": lambda q: q.order_by([("k", False)]),
    "terasort_desc": lambda q: q.order_by([("k", True)]),
    "terasort_multikey": lambda q: q.order_by([("g", False), ("v", True), ("id", False)]),
    "group_by_negative": lambda q: q.group_by("g", AGGS),
    "group_by_unbounded": lambda q: q.group_by("k", {"c": ("count", None), "sv": ("sum", "v")}),
    "group_by_two_keys": lambda q: q.group_by(["g", "b"], AGGS),
    "group_by_string": lambda q: q.group_by("s", AGGS),
    "group_by_salt": lambda q: q.group_by("g", AGGS, salt=3),
    "range_partition_order_by": lambda q: q.range_partition(["g"]).order_by([("g", False), ("id", False)]),
    "group_by_order_by": lambda q: q.group_by("g", AGGS).order_by([("c", True), ("g", False)]),
    "distinct": lambda q: q.distinct(["g", "b"]),
    "hash_partition": lambda q: q.hash_partition(["g"]),
}


def _source(ctx, t, reduced):
    """The table at full width, or behind a statically small node: a
    top-k of 1000 rows (its consumers' exchanges fan out to 2 of the 8
    partitions)."""
    q = ctx.from_arrays(t)
    return q.order_by([("id", False)]).take(1000) if reduced else q


def _group_bounds(t, keys, rows):
    """Per output row: (n_g, sum_g |v|) of the input rows of its group."""
    key_of = list(zip(*[t[k].tolist() for k in keys]))
    acc = {}
    for kk, v in zip(key_of, np.abs(t["v"].astype(np.float64))):
        n, s = acc.get(kk, (0, 0.0))
        acc[kk] = (n + 1, s + v)
    out = [acc[kk] for kk in zip(*[rows[k].tolist() for k in keys])]
    return np.array([o[0] for o in out], np.float64), np.array([o[1] for o in out])


def _assert_same(a, b, t=None, keys=None):
    assert list(a) == list(b)
    for c in a:
        assert a[c].dtype == b[c].dtype, c
        if a[c].dtype == np.float32 and c in ("sv", "mv"):
            n, absv = _group_bounds(t, keys, a)
            bound = n * F32_REL * absv / (n if c == "mv" else 1)
            assert np.all(np.abs(a[c].astype(np.float64) - b[c]) <= bound), c
        elif a[c].dtype == object:
            assert a[c].tolist() == b[c].tolist(), c
        else:
            np.testing.assert_array_equal(a[c].view(np.uint8), b[c].view(np.uint8), err_msg=c)


def _group_keys(name):
    return {"group_by_two_keys": ["g", "b"], "group_by_string": ["s"],
            "group_by_unbounded": ["k"], "group_by_order_by": ["g"]}.get(name, ["g"])


@pytest.mark.parametrize("reduced", [False, True], ids=["full_width", "fan_reduced"])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_matches_reference(rng, name, reduced):
    t = _table(rng, 1 << 14)
    outs = []
    for ctx in _ctxs(auto_dense_strings=False):
        outs.append(QUERIES[name](_source(ctx, t, reduced)).collect())
    src = t
    if reduced:  # the groups are those of the 1000-row head
        src = {c: v[:1000] for c, v in t.items()}
    _assert_same(outs[1], outs[0], src, _group_keys(name))
    assert len(next(iter(outs[1].values()))) > 0


def test_terasort_oracle_and_two_runs_byte_equal(rng):
    t = _table(rng, 1 << 14)
    _, tc = _ctxs()
    q = tc.from_arrays({"k": t["k"], "v": t["v"]}).order_by([("k", False)])
    a, b = q.collect(), q.collect()
    np.testing.assert_array_equal(a["k"], np.sort(t["k"]))
    assert sorted(zip(a["k"].tolist(), a["v"].tolist())) == sorted(zip(t["k"].tolist(), t["v"].tolist()))
    for c in a:
        np.testing.assert_array_equal(a[c].view(np.uint8), b[c].view(np.uint8))


@pytest.mark.parametrize("dense_k", [3000, 1000])
def test_dense_group_by_then_order_by_fan_reduced(rng, dense_k):
    """A dense group_by bounds its output statically (K rows), so the
    order_by behind it fans out to ceil(K / 512) partitions."""
    t = _table(rng, 1 << 14)
    outs, plans = [], []
    for ctx, low in zip(_ctxs(), (jlower, tlower)):
        q = ctx.from_arrays(t).group_by("d", {"c": ("count", None), "sw": ("sum", "w")}, dense=dense_k)
        q = q.order_by([("c", True), ("d", False)])
        outs.append(q.collect())
        plans.append(_ops(low([q.node], ctx.config, ctx.dictionary, P=P)))
    _assert_same(outs[1], outs[0])
    assert plans[0] == plans[1]
    assert ("exchange_range", -(-dense_k // 512)) in [(k, p.get("nparts")) for k, p in plans[1][0]]


# -- the stage op lists ----------------------------------------------------------

def _view(k, v):
    if k == "aggs":
        return [(a.op, a.col, a.out) for a in v]
    if k == "operands_fn":
        return [(f.name, f.ctype.value, d) for f, d in v.fields]
    if k == "fn":
        return (type(v).__name__, sorted(vars(v).items()))
    if k == "tree":
        return {kk: _view(kk, vv) for kk, vv in v.items()}
    return v


def _ops(graph):
    return [[(op.kind, {k: _view(k, v) for k, v in op.params.items()}) for op in s.ops]
            for s in graph.stages]


@pytest.mark.parametrize("reduced", [False, True], ids=["full_width", "fan_reduced"])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_stage_op_lists_match_reference(rng, name, reduced):
    t = _table(rng, 2000)
    plans = []
    for ctx, low in zip(_ctxs(auto_dense_strings=False), (jlower, tlower)):
        q = QUERIES[name](_source(ctx, t, reduced))
        plans.append(_ops(low([q.node], ctx.config, ctx.dictionary, P=P)))
    assert plans[0] == plans[1]
    nparts = [p.get("nparts") for s in plans[1] for k, p in s if k.startswith("exchange")]
    assert nparts and all(n == (2 if reduced else None) for n in nparts[-1:])


# -- overflow retries and skew -------------------------------------------------

def _ref_overflows(ctx):
    return [e for e in ctx.executor.events.events() if e["kind"] == "stage_overflow"]


def test_hash_exchange_overflow_retries_as_the_reference():
    """Every row on one key: the hash exchange overflows until the boost
    widens its buckets; same retries, same output."""
    t = {"k": np.full(4000, 5, np.int32), "v": np.arange(4000, dtype=np.float32)}
    (jc, tc), outs = _ctxs(), []
    for ctx in (jc, tc):
        outs.append(ctx.from_arrays(t).hash_partition(["k"]).collect())
    _assert_same(outs[1], outs[0])
    port = [e for e in tc.executor.events if e[0] == "stage_overflow"]
    assert [e[2] for e in port] == [e["boost"] for e in _ref_overflows(jc)] == [1, 2]


def test_overflow_past_the_retry_budget_fails_as_the_reference():
    t = {"k": np.full(4000, 5, np.int32)}
    jc, tc = _ctxs(max_shuffle_retries=1)
    msgs = []
    for ctx, err in ((jc, JStageFailed), (tc, StageFailedError)):
        with pytest.raises(err, match="still overflowing at boost 2") as ei:
            ctx.from_arrays(t).hash_partition(["k"]).collect()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("build", [
    lambda q: q.order_by(["k"]),
    lambda q: q.group_by("k", {"sv": ("sum", "v"), "c": ("count", None)}),
], ids=["order_by", "group_by"])
def test_hot_key_needs_no_retry(rng, build):
    """90% of the rows on one key: the spread range exchange and the
    partial combine before the hash exchange keep every bucket inside
    its capacity, as in the reference (tests/test_skew.py)."""
    t = _table(rng, 1 << 13, hot=0.9)
    t = {"k": t["k"], "v": t["v"]}
    (jc, tc), outs = _ctxs(), []
    for ctx in (jc, tc):
        outs.append(build(ctx.from_arrays(t)).collect())
    _assert_same(outs[1], outs[0], t, ["k"])
    assert _ref_overflows(jc) == [] and tc.executor.events == []


# -- observed-volume width adaptation ------------------------------------------

def test_width_adaptation_matches_reference(rng):
    """One group_by feeding two order_bys (one plan, two roots): the
    group_by stage's observed output is tail-sized, so both order_by
    stages rerun their exchanges at a reduced width."""
    t = _table(rng, 1 << 14)
    jc, tc = _ctxs()
    outs = []
    for ctx in (jc, tc):
        g = ctx.from_arrays(t).group_by("g", {"c": ("count", None), "sw": ("sum", "w")})
        outs.append([g.order_by([("c", True), ("g", False)]), g.order_by([("sw", False), ("g", False)])])
    ref = [f() for f in jc.run_many_to_host_async(outs[0])]
    graph = tlower([q.node for q in outs[1]], tc.config, tc.dictionary, P=P)
    res = tc.executor.execute(graph, {nid: tc._bind_device(n) for nid, n in graph.inputs.items()})
    port = [res[graph.outputs[q.node.id]].to_numpy(q.schema, tc.dictionary) for q in outs[1]]
    for a, b in zip(port, ref):
        _assert_same(a, b)
    jad = [e["nparts"] for e in jc.executor.events.events() if e["kind"] == "stage_width_adapt"]
    tad = [e[2] for e in tc.executor.events if e[0] == "stage_width_adapt"]
    assert tad == jad == [1, 1]
