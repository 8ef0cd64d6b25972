"""The ordered and user-function operators of the port (dryad_tpu_torch,
device="cpu") against the JAX package on its 8-device CPU mesh, both at
P=8: ``take_while``, ``skip_while``, ``reverse``, ``default_if_empty``,
``zip_``, ``sequence_equal``, ``sliding_window``, ``select_many``,
``apply`` (with and without the partition index), ``fork`` and
``apply_host``.

Every query's ``collect()`` is compared byte for byte, in row order (the
engine order these operators define), with its stage op list and its
overflow retries.  The cases mirror the reference's
``tests/test_operators_extended.py`` and ``tests/test_workloads.py``
(the Apply + Fork DAG), plus a hot key (90% of the rows on one
partition, so the rank exchange's buckets overflow and retry) and
partitions left empty by a filter, for ``reverse``, ``zip_`` and
``sliding_window``.  User functions are written once where the same
operators work on ``jnp`` and ``torch`` arrays; ``xp`` is the array
module where they do not.
"""

import numpy as np
import pytest
import torch

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.exec.events import EventLog
from dryad_tpu.plan.lower import lower as jlower
from dryad_tpu_torch.plan.lower import lower as tlower

P = 8


def _jnp():
    import jax.numpy as jnp

    return jnp


def _ctxs(**cfg):
    jc = J.DryadContext(num_partitions_=P, config=J.DryadConfig(**cfg))
    jc.executor.events = EventLog(None)
    tc = T.DryadContext(num_partitions_=P, config=T.DryadConfig(**cfg), device="cpu")
    return jc, tc


def _assert_same(a, b):
    """``collect()`` results byte for byte, in row order."""
    assert list(a) == list(b)
    for c in a:
        assert a[c].dtype == b[c].dtype, c
        if a[c].dtype == object:
            assert a[c].tolist() == b[c].tolist(), c
        else:
            np.testing.assert_array_equal(a[c].view(np.uint8), b[c].view(np.uint8), err_msg=c)


def _events(jc, tc):
    ref = [(e["kind"], e["name"], e.get("boost", e.get("nparts")))
           for e in jc.executor.events.events()
           if e["kind"] in ("stage_overflow", "stage_width_adapt")]
    return ref, list(tc.executor.events)


def _view(v):
    if callable(v):
        return type(v).__name__  # a user function: its kind, not its identity
    if isinstance(v, dict):
        return {k: _view(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_view(x) for x in v]
    if hasattr(v, "op") and hasattr(v, "out"):  # each package's AggSpec
        return (v.op, v.col, v.out)
    if isinstance(v, np.generic):
        return v.item()
    return v


def _ops(graph):
    return [[(op.kind, {k: _view(v) for k, v in op.params.items()}) for op in s.ops]
            for s in graph.stages]


def _tbl(n=100):
    return {"x": np.arange(n, dtype=np.int32), "v": (np.arange(n) * 0.5).astype(np.float32)}


def _hot(n=2000):
    """90% of the rows on key 7: a hash_partition puts them on one
    partition."""
    rng = np.random.default_rng(5)
    k = np.where(rng.random(n) < 0.9, 7, rng.integers(0, 1000, n)).astype(np.int32)
    return {"k": k, "x": np.arange(n, dtype=np.int32), "v": rng.standard_normal(n).astype(np.float32)}


def _sparse(c, n=1000):
    """Rows on partitions 0 and 7 only: the partitions between are empty."""
    return c.from_arrays(_tbl(n)).where(lambda cols: (cols["x"] < 130) | (cols["x"] > 990))


def _dup(xp):
    def fn(cols):
        x = cols["x"]
        return {"x": xp.stack([x, x + 1000], 1), "v": xp.stack([cols["v"], -cols["v"]], 1)}, (
            xp.stack([x, x], 1) % 3) != 0
    return fn


QUERIES = {
    # tests/test_operators_extended.py
    "take_while": lambda c, xp: c.from_arrays(_tbl()).take_while(lambda cols: cols["x"] < 42),
    "take_while_never_fails": lambda c, xp: c.from_arrays(_tbl(20)).take_while(
        lambda cols: cols["x"] >= 0),
    "skip_while": lambda c, xp: c.from_arrays(_tbl()).skip_while(lambda cols: cols["x"] != 60),
    "take_while_not_prefix_closed": lambda c, xp: c.from_arrays(_tbl(50)).take_while(
        lambda cols: (cols["x"] < 10) | (cols["x"] > 20)),
    "reverse": lambda c, xp: c.from_arrays(_tbl(64)).reverse(),
    "reverse_then_take": lambda c, xp: c.from_arrays(_tbl(64)).reverse().take(5),
    "default_if_empty": lambda c, xp: c.from_arrays(_tbl(10)).where(
        lambda cols: cols["x"] > 100).default_if_empty({"x": -1, "v": 2.5}),
    "default_if_empty_passthrough": lambda c, xp: c.from_arrays(_tbl(10)).default_if_empty(),
    "default_if_empty_then_join": lambda c, xp: c.from_arrays(
        {"k": np.arange(8, dtype=np.int32)}).hash_partition("k").where(
        lambda cols: cols["k"] > 100).default_if_empty({"k": 5}).join(
        c.from_arrays({"k": np.array([5], np.int32), "rv": np.array([1.5], np.float32)}), "k"),
    "zip": lambda c, xp: c.from_arrays(_tbl(50)).zip_(
        c.from_arrays(_tbl(37)).where(lambda cols: cols["x"] % 3 != 0)),
    "sliding_window": lambda c, xp: c.from_arrays(_tbl()).sliding_window(3, ["x", "v"]),
    "sliding_window_size_1": lambda c, xp: c.from_arrays(_tbl(30)).sliding_window(1),
    "select_many": lambda c, xp: c.from_arrays(_tbl(40)).select_many(_dup(xp), 2),
    "select_many_then_group_by": lambda c, xp: c.from_arrays(_tbl(40)).select_many(
        _dup(xp), 2).group_by("x", {"n": ("count", None), "s": ("sum", "v")}),
    # tests/test_api_e2e.py: apply
    "apply": lambda c, xp: c.from_arrays(_tbl(64)).apply(lambda b: b.with_column("x", b["x"] * 2)),
    "apply_with_index": lambda c, xp: c.from_arrays(_tbl(64)).apply(
        lambda b, i: b.with_column("x", b["x"] * 0 + i).filter(b["v"] > 3.0), with_index=True),
    # a hot key and empty partitions
    "reverse_hot_key": lambda c, xp: c.from_arrays(_hot()).hash_partition("k").reverse(),
    "reverse_empty_partitions": lambda c, xp: _sparse(c).reverse(),
    "zip_empty_partitions": lambda c, xp: _sparse(c).zip_(c.from_arrays(_tbl(300)), suffix="_b"),
    "zip_hot_key": lambda c, xp: c.from_arrays(_hot()).hash_partition("k").zip_(
        c.from_arrays(_tbl(1500))),
    "sliding_window_hot_key": lambda c, xp: c.from_arrays(_hot()).hash_partition(
        "k").sliding_window(3, ["k", "x"]),
    "sliding_window_empty_partitions": lambda c, xp: _sparse(c).sliding_window(4, ["x"]),
    "sliding_window_across_one_row_partitions": lambda c, xp: c.from_arrays(_tbl(800)).where(
        lambda cols: cols["x"] % 100 == 3).sliding_window(5, ["x"]),
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_operator_matches_reference(name):
    outs, plans = [], []
    jc, tc = _ctxs()
    for ctx, low, xp in zip((jc, tc), (jlower, tlower), (_jnp(), torch)):
        q = QUERIES[name](ctx, xp)
        outs.append(q.collect())
        plans.append(_ops(low([q.node], ctx.config, ctx.dictionary, P=P)))
    _assert_same(outs[1], outs[0])
    assert plans[1] == plans[0]
    ref, port = _events(jc, tc)
    assert port == ref
    if "hot_key" in name and not name.startswith("sliding"):
        assert [e[0] for e in port][:1] == ["stage_overflow"]  # the rank exchange retried


def test_operator_results_as_linq_defines_them():
    _, tc = _ctxs()
    assert tc.from_arrays(_tbl(64)).reverse().collect()["x"].tolist() == list(range(63, -1, -1))
    assert QUERIES["take_while_not_prefix_closed"](tc, torch).collect()["x"].tolist() == list(range(10))
    d = QUERIES["default_if_empty"](tc, torch).collect()
    assert d["x"].tolist() == [-1] and d["v"].tolist() == [2.5]
    w = QUERIES["sliding_window_empty_partitions"](tc, torch).collect()
    x = np.r_[np.arange(130), np.arange(991, 1000)].astype(np.int32)
    for j in range(4):
        np.testing.assert_array_equal(w[f"x_w{j}"], x[j: len(x) - 3 + j])


@pytest.mark.parametrize("case", ["equal", "shorter", "mutated", "empty", "strings"])
def test_sequence_equal_matches_reference(case):
    got = []
    for ctx in _ctxs():
        a = ctx.from_arrays(_tbl(40))
        b = {
            "equal": lambda: ctx.from_arrays(_tbl(40)),
            "shorter": lambda: ctx.from_arrays(_tbl(39)),
            "mutated": lambda: ctx.from_arrays(_tbl(40)).select(
                lambda cols: {"x": cols["x"], "v": cols["v"] + (cols["x"] == 7)}, schema=a.schema),
            "empty": lambda: ctx.from_arrays(_tbl(10)).where(lambda c: c["x"] > 90),
            "strings": lambda: ctx.from_arrays({"s": np.array(["a", "x", "c"], object)}),
        }[case]()
        if case == "empty":
            a = ctx.from_arrays(_tbl(10)).where(lambda c: c["x"] > 50)
        if case == "strings":
            a = ctx.from_arrays({"s": np.array(["a", "b", "c"], object)})
            got.append((a.sequence_equal(b), a.sequence_equal(
                ctx.from_arrays({"s": np.array(["a", "b", "c"], object)}))))
        else:
            got.append(a.sequence_equal(b))
    assert got[0] == got[1]
    assert got[1] == {"equal": True, "shorter": False, "mutated": False, "empty": True,
                      "strings": (False, True)}[case]


def test_apply_fork_dag_matches_reference():
    """tests/test_workloads.py's Apply + Fork DAG: a per-partition apply,
    then a fork whose two branches feed different pipelines."""
    tbl = {"x": np.arange(800, dtype=np.int32)}
    outs = []
    for ctx, mod in zip(_ctxs(), (J, T)):
        s = mod.Schema([("x", mod.ColumnType.INT32)])
        base = ctx.from_arrays(tbl).apply(lambda b: b.with_column("x", b["x"] + 1))
        mult, rest = base.fork(
            lambda b: (b.filter(b["x"] % 3 == 0), b.filter(b["x"] % 3 != 0)), [s, s])
        agg = mult.group_by("x", {"c": ("count", None)}).aggregate_as_query(
            {"total": ("count", None)})
        outs.append((mult.collect(), rest.collect(), agg.collect()))
    for a, b in zip(outs[1], outs[0]):
        _assert_same(a, b)
    assert int(outs[1][2]["total"][0]) == len(range(3, 801, 3))


def _host_fn(cols, pidx):
    keep = cols["v"] > np.median(cols["v"]) if len(cols["v"]) else cols["v"] > 0
    return {"v": cols["v"][keep], "pid": np.full(int(keep.sum()), pidx, np.int32)}


def test_apply_host_matches_reference(rng):
    v = rng.standard_normal(800).astype(np.float32)
    outs = []
    for ctx, mod in zip(_ctxs(), (J, T)):
        sch = mod.Schema([("v", mod.ColumnType.FLOAT32), ("pid", mod.ColumnType.INT32)])
        q = ctx.from_arrays({"v": v}).apply_host(_host_fn, schema=sch)
        s = mod.Schema([("s", mod.ColumnType.STRING), ("n", mod.ColumnType.INT32)])
        strs = ctx.from_arrays({"s": np.array(["a", "bb", "a", "c"], object)}).apply_host(
            lambda cols, i: {**{k: v for k, v in cols.items()},
                             "n": np.full(len(cols["s#h0"]), i, np.int64)}, schema=s)
        outs.append((q.collect(), q.where(lambda c: c["pid"] == 0).count(), strs.collect()))
    _assert_same(outs[1][0], outs[0][0])
    assert outs[1][1] == outs[0][1] and 0 < outs[1][1] < 200
    _assert_same(outs[1][2], outs[0][2])
    assert outs[1][2]["n"].dtype == np.int32  # cast to the schema


def test_apply_host_validates_as_the_reference():
    v = np.arange(100, dtype=np.float32)
    msgs = []
    for ctx, mod in zip(_ctxs(), (J, T)):
        sch = mod.Schema([("v", mod.ColumnType.FLOAT32), ("pid", mod.ColumnType.INT32)])
        with pytest.raises(ValueError, match="schema physical columns") as ei:
            ctx.from_arrays({"v": v}).apply_host(lambda c, i: {"wrong": c["v"]}, schema=sch).collect()
        msgs.append(str(ei.value))
        with pytest.raises(ValueError, match="ragged"):
            ctx.from_arrays({"v": v}).apply_host(
                lambda c, i: {"v": c["v"], "pid": [i]}, schema=sch).collect()
        out = ctx.from_arrays({"v": v}).apply_host(
            lambda c, i: {"v": list(c["v"][:2]), "pid": [i, i]}, schema=sch).collect()
        assert out["v"].dtype == np.float32 and len(out["v"]) == 16
    assert msgs[0] == msgs[1]


def test_select_many_contract_and_apply_errors():
    _, tc = _ctxs()
    q = tc.from_arrays(_tbl(16))
    with pytest.raises(ValueError, match="must be"):
        q.select_many(lambda c: ({"x": c["x"][:, None]}, torch.ones(16, 1, dtype=torch.bool)),
                      2, schema=q.schema).collect()
    with pytest.raises(TypeError, match="must return a ColumnBatch"):
        q.apply(lambda b: b["x"]).collect()
    with pytest.raises(ValueError, match="same columns and capacity"):
        q.apply(lambda b, i: b if i else b.select(["x"]), with_index=True).collect()
