"""Scalar aggregates, the rank operators and the set operators of the
port (dryad_tpu_torch, device="cpu") against the JAX package on its
8-device CPU mesh, both at P=8.

Counts, integer sums (int32 wraps), min/max, any/all and the 64-bit
pair results of int64/float64 columns are compared byte for byte, empty
tables included.  Float32 sums and means: the port sums in fixed point
(the same bytes on every run and device), the reference in f32 in an
unspecified order, so |port - ref| <= n * 2^-23 * sum |v|.  Ranks,
``take``/``skip``/``tail`` and the element accessors follow global
engine order (partition-major), as in the reference, on unordered and
on sorted input."""

import numpy as np
import pytest
import torch

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.exec.events import EventLog
from dryad_tpu.ops import segmented as JSEG
from dryad_tpu.plan.lower import lower as jlower
from dryad_tpu_torch.ops import segmented as TSEG
from dryad_tpu_torch.plan.lower import lower as tlower

P = 8
F32_REL = 2.0 ** -23


def _ctxs(**cfg):
    jc = J.DryadContext(num_partitions_=P, config=J.DryadConfig(**cfg))
    jc.executor.events = EventLog(None)
    tc = T.DryadContext(num_partitions_=P, config=T.DryadConfig(**cfg), device="cpu")
    return jc, tc


def _table(rng, n):
    return {
        "i": rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32),  # sums wrap
        "f": (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)).astype(np.float32),
        "u": rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
        "b": rng.random(n) < 0.999,
        "L": rng.integers(-2**62, 2**62, n, dtype=np.int64),  # past 2^32, sums wrap
        "D": rng.standard_normal(n) * 1e300,
        "s": np.array([f"w{i}" for i in rng.integers(0, 50, n)], object),
        "id": np.arange(n, dtype=np.int32),
    }


AGGS = {
    "n": ("count", None), "si": ("sum", "i"), "mni": ("min", "i"), "mxi": ("max", "i"),
    "sf": ("sum", "f"), "mf": ("mean", "f"), "mnf": ("min", "f"), "mxf": ("max", "f"),
    "mi": ("mean", "i"), "su": ("sum", "u"), "mnu": ("min", "u"), "mxu": ("max", "u"),
    "ab": ("any", "b"), "allb": ("all", "b"), "sL": ("sum", "L"), "mnL": ("min", "L"),
    "mxL": ("max", "L"), "mL": ("mean", "L"), "mnD": ("min", "D"), "mxD": ("max", "D"),
}
# float32 sums and means (a mean of int32 sums the values as float32):
# output -> (column, mean)
FLOAT_SUMS = {"sf": ("f", False), "mf": ("f", True), "mi": ("i", True)}


def _assert_scalars(port, ref, t, n):
    assert list(port) == list(ref)
    for c in ref:
        assert port[c].dtype == ref[c].dtype and port[c].shape == ref[c].shape == (1,), c
        if c in FLOAT_SUMS:
            col, mean = FLOAT_SUMS[c]
            absv = np.abs(t[col][:n].astype(np.float32).astype(np.float64))
            absv = np.where(absv < 2.0 ** -126, 0.0, absv).sum()
            bound = n * F32_REL * absv / (max(n, 1) if mean else 1)
            assert abs(float(port[c][0]) - float(ref[c][0])) <= bound, c
        else:
            np.testing.assert_array_equal(port[c].view(np.uint8), ref[c].view(np.uint8), err_msg=c)


@pytest.mark.parametrize("where", ["all_rows", "some_rows", "no_rows"])
def test_scalar_aggregates_match_reference(rng, where):
    t = _table(rng, 5000)
    keep = {"all_rows": None, "some_rows": 1000, "no_rows": -1}[where]
    outs, plans = [], []
    for ctx, low in zip(_ctxs(), (jlower, tlower)):
        q = ctx.from_arrays(t)
        if keep is not None:
            q = q.where(lambda c, k=keep: c["id"] < k)
        q = q.aggregate_as_query(AGGS)
        outs.append(q.collect())
        plans.append([[op.kind for op in s.ops] for s in low([q.node], ctx.config, P=P).stages])
    assert plans[0] == plans[1] and plans[1][-1][-1] == "scalar_agg"
    _assert_scalars(outs[1], outs[0], t, {None: 5000, 1000: 1000, -1: 0}[keep])


def test_scalar_float_sum_same_bytes_on_every_run(rng):
    t = _table(rng, 5000)
    _, tc = _ctxs()
    q = tc.from_arrays(t).aggregate_as_query({"s": ("sum", "f"), "m": ("mean", "f")})
    a, b = q.collect(), q.collect()
    assert a["s"].tobytes() == b["s"].tobytes() and a["m"].tobytes() == b["m"].tobytes()
    exact = t["f"].astype(np.float64).sum()
    assert abs(float(a["s"][0]) - exact) <= 5000 * F32_REL * np.abs(t["f"]).astype(np.float64).sum()


@pytest.mark.parametrize("method,col", [
    ("count", None), ("sum_", "i"), ("min_", "f"), ("max_", "u"), ("mean", "i"),
    ("any_", "b"), ("all_", "b"), ("sum_", "L"), ("min_", "D"),
])
@pytest.mark.parametrize("empty", [False, True], ids=["rows", "empty"])
def test_scalar_methods_match_reference(rng, method, col, empty):
    t = _table(rng, 3000)
    got = []
    for ctx in _ctxs():
        q = ctx.from_arrays(t)
        if empty:
            q = q.where(lambda c: c["id"] < 0)
        fn = getattr(q, method)
        try:
            got.append(fn() if col is None else fn(col))
        except TypeError as e:  # mean() of an empty table: float(None), as the reference
            got.append(repr(e))
    assert type(got[0]) is type(got[1]) and got[0] == got[1]
    if method == "mean" and empty:
        assert "NoneType" in got[1]


@pytest.mark.parametrize("op", ["sum64", "min64", "max64"])
def test_pair_scalar_reduce_byte_identical(rng, op):
    """Whole-array 64-bit reduce of split words, per partition and then
    over the P partial pairs, as ``_k_scalar_agg`` uses it; invalid rows
    count as the op's identity (an all-invalid row block included)."""
    import jax.numpy as jnp

    lo = rng.integers(0, 2**32, (P, 300), dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 2**32, (P, 300), dtype=np.uint64).astype(np.uint32)
    valid = rng.random((P, 300)) < 0.7
    valid[3] = False
    ref = [JSEG.pair_scalar_reduce(op, jnp.asarray(lo[p]), jnp.asarray(hi[p]), jnp.asarray(valid[p]))
           for p in range(P)]
    rlo, rhi = [np.array([np.asarray(r[i]) for r in ref]) for i in (0, 1)]
    tlo, thi = TSEG.pair_scalar_reduce(op, torch.from_numpy(lo.astype(np.int64)),
                                       torch.from_numpy(hi.astype(np.int64)), torch.from_numpy(valid))
    np.testing.assert_array_equal(tlo.numpy().astype(np.uint32), rlo)
    np.testing.assert_array_equal(thi.numpy().astype(np.uint32), rhi)
    g = JSEG.pair_scalar_reduce(op, jnp.asarray(rlo), jnp.asarray(rhi), jnp.ones(P, bool))
    t2 = TSEG.pair_scalar_reduce(op, tlo, thi, torch.ones(P, dtype=torch.bool))
    assert [int(x) for x in t2] == [int(np.asarray(x)) for x in g]


# -- rank operators ------------------------------------------------------------------

RANK_QUERIES = {
    "with_rank": lambda q: q.with_rank("r"),
    "take": lambda q: q.take(37),
    "take_zero": lambda q: q.take(0),
    "skip": lambda q: q.skip(2990),
    "tail": lambda q: q.tail(25),
    "tail_past_all": lambda q: q.tail(10**6),
    "where_take": lambda q: q.where(lambda c: c["b"]).take(1500),
    "order_by_take_large": lambda q: q.order_by([("f", True)]).take(2000),
    "order_by_skip": lambda q: q.order_by([("i", False)]).skip(2950),
    "with_rank_after_where": lambda q: q.where(lambda c: c["id"] % 3 == 0).with_rank("r").skip(5),
    "group_by_take": lambda q: q.group_by("s", {"n": ("count", None)}).take(7),
}


@pytest.mark.parametrize("name", sorted(RANK_QUERIES))
def test_rank_query_matches_reference(rng, name):
    t = _table(rng, 3000)
    outs, plans = [], []
    for ctx, low in zip(_ctxs(auto_dense_strings=False), (jlower, tlower)):
        q = RANK_QUERIES[name](ctx.from_arrays(t))
        outs.append(q.collect())
        plans.append([[(op.kind, op.params.get("n")) for op in s.ops]
                      for s in low([q.node], ctx.config, ctx.dictionary, P=P).stages])
    assert plans[0] == plans[1]
    _assert_tables(outs[1], outs[0])


def _assert_tables(a, b):
    assert list(a) == list(b)
    for c in a:
        assert a[c].dtype == b[c].dtype, c
        if a[c].dtype == object:
            assert a[c].tolist() == b[c].tolist(), c
        else:
            np.testing.assert_array_equal(a[c].view(np.uint8), b[c].view(np.uint8), err_msg=c)


def _row_equal(a, b):
    if a is None or b is None:
        return a is b
    return list(a) == list(b) and all(
        np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes() for k in a)


@pytest.mark.parametrize("call", [
    lambda q: q.first(), lambda q: q.first_or_default(), lambda q: q.last(),
    lambda q: q.last_or_default(), lambda q: q.element_at(1234),
    lambda q: q.element_at_or_default(10**6), lambda q: q.element_at_or_default(-1),
    lambda q: q.where(lambda c: c["id"] == 77).single(),
    lambda q: q.where(lambda c: c["id"] < 0).single_or_default(),
    lambda q: q.where(lambda c: c["id"] < 0).first_or_default(),
], ids=["first", "first_or_default", "last", "last_or_default", "element_at",
        "element_at_past_end", "element_at_negative", "single", "single_or_default_empty",
        "first_or_default_empty"])
def test_element_access_matches_reference(rng, call):
    t = _table(rng, 3000)
    rows = [call(ctx.from_arrays(t)) for ctx in _ctxs()]
    assert _row_equal(rows[1], rows[0])


@pytest.mark.parametrize("call,err", [
    (lambda q: q.where(lambda c: c["id"] < 0).first(), ValueError),
    (lambda q: q.where(lambda c: c["id"] < 0).last(), ValueError),
    (lambda q: q.single(), ValueError),
    (lambda q: q.element_at(10**6), IndexError),
], ids=["first_empty", "last_empty", "single_many", "element_at_past_end"])
def test_element_access_errors_as_reference(rng, call, err):
    t = _table(rng, 500)
    msgs = []
    for ctx in _ctxs():
        with pytest.raises(err) as ei:
            call(ctx.from_arrays(t))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("present", [True, False])
def test_contains_matches_reference(rng, present):
    t = _table(rng, 2000)
    t = {c: t[c] for c in ("i", "f", "s", "L")}
    row = {c: t[c][1500] for c in t}
    if not present:
        row["i"] = np.int32(row["i"] ^ 1)
    got = [ctx.from_arrays(t).contains(row) for ctx in _ctxs()]
    assert got == [present, present]


# -- set operators ---------------------------------------------------------------------

def _sets(rng):
    a = {"k": rng.integers(-40, 40, 900).astype(np.int32),
         "s": np.array([f"v{i}" for i in rng.integers(0, 6, 900)], object)}
    b = {"k": rng.integers(-20, 60, 500).astype(np.int32),
         "s": np.array([f"v{i}" for i in rng.integers(0, 6, 500)], object)}
    return a, b


SET_QUERIES = {
    "concat": lambda a, b: a.concat(b),
    "concat_three": lambda a, b: a.concat(b, a.where(lambda c: c["k"] > 0)),
    "union": lambda a, b: a.union(b),
    "intersect": lambda a, b: a.intersect(b),
    "except": lambda a, b: a.except_(b),
    "concat_then_count": lambda a, b: a.concat(b).count_as_query(),
}


@pytest.mark.parametrize("name", sorted(SET_QUERIES))
def test_set_query_matches_reference(rng, name):
    a, b = _sets(rng)
    outs = []
    for ctx in _ctxs(auto_dense_strings=False):
        outs.append(SET_QUERIES[name](ctx.from_arrays(a), ctx.from_arrays(b)).collect())
    _assert_tables(outs[1], outs[0])
    assert len(next(iter(outs[1].values()))) > 0


def test_of_type_and_assumed_partitioning_match_reference(rng):
    """``of_type`` on a plain and on a split (int64) tag column, and an
    ``assume_hash_partition`` claim that elides a group_by's exchange."""
    t = _table(rng, 3000)
    tag = int(t["L"][17])
    t["L"][rng.random(3000) < 0.3] = tag
    outs, plans = [], []
    for ctx, low in zip(_ctxs(), (jlower, tlower)):
        src = ctx.from_arrays({c: t[c] for c in ("i", "L", "id")})
        outs.append(src.of_type("L", tag).collect())
        outs.append(src.where(lambda c: c["id"] % 2 == 0).of_type("id", 42).collect())
        g = src.assume_hash_partition("i").group_by("i", {"n": ("count", None)})
        outs.append(g.collect())
        plans.append([[op.kind for op in s.ops] for s in low([g.node], ctx.config, P=P).stages])
    for a, b in zip(outs[3:], outs[:3]):
        _assert_tables(a, b)
    assert len(outs[3]["L"]) > 800 and outs[4]["id"].tolist() == [42]
    assert plans[0] == plans[1] and "exchange_hash" not in plans[1][-1]
