"""Segmented reduction of the port (dryad_tpu_torch/ops/segmented.py)
against the JAX package's ``group_reduce`` / ``distinct`` run per
partition on its 8-device CPU mesh, both at P=8.

Keys, counts, the valid mask, integer sums, min/max (int and float),
any/all/first and the 64-bit pair ops (values past 2^32) are compared
byte for byte in every output slot.  Float32 sums and means: the port
sums in fixed point (order-free, deterministic), the reference in f32
in row order, so per group |port - ref| <= n_g * 2^-23 * sum_g |v|."""

import numpy as np
import pytest
import torch

from dryad_tpu.columnar.schema import ColumnType as JCT
from dryad_tpu.columnar.schema import Schema as JSchema
from dryad_tpu.ops import segmented as JSEG
from dryad_tpu.parallel.distribute import from_host_table
from dryad_tpu.parallel.stage import compile_stage
from dryad_tpu_torch.columnar.batch import ColumnBatch, to_host_column
from dryad_tpu_torch.columnar.schema import ColumnType, Schema
from dryad_tpu_torch.ops import segmented as TSEG

P = 8
FIELDS = [
    ("k", "INT32"), ("k2", "BOOL"), ("v", "FLOAT32"), ("w", "INT32"),
    ("u", "UINT32"), ("b", "BOOL"), ("L", "INT64"), ("D", "FLOAT64"),
]
INT_OPS = [("count", None), ("sum", "w"), ("min", "w"), ("max", "w"), ("sum", "u"),
           ("min", "u"), ("max", "u"), ("any", "b"), ("all", "b"), ("first", "w"),
           ("first", "v"), ("min", "v"), ("max", "v"), ("sum64", "L#h0"),
           ("min64", "L#h0"), ("max64", "L#h0"), ("min64", "D#h0"), ("max64", "D#h0")]


def _table(rng, n, nkeys):
    return {
        "k": rng.integers(-nkeys, nkeys, n).astype(np.int32),
        "k2": rng.random(n) < 0.3,
        "v": (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)).astype(np.float32),
        "w": rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32),  # sums wrap
        "u": rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
        "b": rng.random(n) < 0.6,
        "L": rng.integers(-2**62, 2**62, n, dtype=np.int64),  # past 2^32, sums wrap
        "D": rng.standard_normal(n) * 1e300,
    }


def _both(mesh, t, cap):
    jb = from_host_table(JSchema([(c, getattr(JCT, ct)) for c, ct in FIELDS]), t, mesh,
                         partition_capacity=cap)
    tb = ColumnBatch.from_numpy(Schema([(c, getattr(ColumnType, ct)) for c, ct in FIELDS]),
                                t, P, "cpu", partition_capacity=cap)
    return jb, tb


def _ref(mesh, jb, fn):
    out, _ = compile_stage(mesh, lambda sh, _r: ((fn(sh[0]),), ()))((jb,), ())
    valid, cols, _ = out[0].fetch_host()
    return valid, cols


def _port(tb, fn):
    out = fn(tb)
    return (out.valid.reshape(-1).numpy(),
            {c: to_host_column(t.reshape(-1)) for c, t in out.data.items()})


def _assert_bytes(a: np.ndarray, b: np.ndarray, what: str):
    assert a.dtype == b.dtype, what
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=what)


@pytest.mark.parametrize("nkeys", [3, 300])
@pytest.mark.parametrize("keys", [["k"], ["k", "k2"]])
def test_group_reduce_integer_ops_byte_identical(mesh8, rng, nkeys, keys):
    t = _table(rng, 3000, nkeys)
    jb, tb = _both(mesh8, t, 450)
    aggs = [(op, c, f"o{i}") for i, (op, c) in enumerate(INT_OPS)]
    jv, jc = _ref(mesh8, jb, lambda b: JSEG.group_reduce(b, keys, [JSEG.AggSpec(*a) for a in aggs]))
    tv, tc = _port(tb, lambda b: TSEG.group_reduce(b, keys, [TSEG.AggSpec(*a) for a in aggs]))
    np.testing.assert_array_equal(tv, jv)
    assert sorted(tc) == sorted(jc)
    for c in jc:
        _assert_bytes(tc[c], jc[c], c)


@pytest.mark.parametrize("nkeys", [3, 300])
def test_group_reduce_float_sums_within_bound(mesh8, rng, nkeys):
    t = _table(rng, 3000, nkeys)
    t["v"][:40] = np.float32(1e-42)  # subnormal: zero to the reference's backends
    jb, tb = _both(mesh8, t, 450)
    aggs = [("sum", "v", "s"), ("mean", "v", "m"), ("mean", "w", "mw"), ("count", None, "c")]
    jv, jc = _ref(mesh8, jb, lambda b: JSEG.group_reduce(b, ["k"], [JSEG.AggSpec(*a) for a in aggs]))
    tv, tc = _port(tb, lambda b: TSEG.group_reduce(b, ["k"], [TSEG.AggSpec(*a) for a in aggs]))
    np.testing.assert_array_equal(tv, jv)
    for c in ("k", "c"):
        _assert_bytes(tc[c], jc[c], c)
    # sum |v| per (partition, key), from the host layout of the input
    cap = 450
    vin, cin = tb.valid.numpy(), {c: tb.data[c].numpy() for c in ("k", "v", "w")}
    for p in range(P):
        sl = slice(p * cap, (p + 1) * cap)
        keys, kv = cin["k"][p][vin[p]], cin["v"][p][vin[p]].astype(np.float64)
        kv = np.where(np.abs(kv) < 2.0 ** -126, 0.0, kv)
        kw = cin["w"][p][vin[p]].astype(np.float32).astype(np.float64)
        uk, inv = np.unique(keys, return_inverse=True)
        cnt = np.bincount(inv)
        out_keys = tc["k"][sl][tv[sl]]
        np.testing.assert_array_equal(out_keys, uk)
        for name, absv, div in (("s", np.abs(kv), 1), ("m", np.abs(kv), cnt), ("mw", np.abs(kw), cnt)):
            bound = cnt * 2.0 ** -23 * np.bincount(inv, weights=absv) / div
            got = tc[name][sl][tv[sl]].astype(np.float64)
            ref = jc[name][sl][tv[sl]].astype(np.float64)
            assert np.all(np.abs(got - ref) <= bound), name


def test_float_sum_special_values():
    """NaN and infinities per IEEE, subnormals as zero, -0.0 sums to +0.0,
    and a small value between two large ones that cancel keeps its share
    (f32 in row order would lose it)."""
    x = torch.tensor([[1.0, 2.0**-60, float("nan"), 1.0, float("inf"), float("-inf"),
                       float("inf"), 3.0, -0.0, -0.0, 1e-44, 1e-44, 5.0]])
    seg = torch.tensor([[0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 13]])
    got = TSEG._f32_sum(x, seg, 13)[0, :6]
    assert got[0].item() == 1.0  # 1 + 2^-60 rounds to 1 in f32
    assert torch.isnan(got[1]) and torch.isnan(got[2])
    assert got[3].item() == float("inf")
    assert got[4].view(torch.int32).item() == 0 and got[5].view(torch.int32).item() == 0
    big = torch.tensor([[2.0**20, 2.0**-10, -2.0**20]])
    assert TSEG._f32_sum(big, torch.zeros((1, 3), dtype=torch.int64), 3)[0, 0].item() == 2.0**-10


def test_float_sums_same_bytes_whatever_the_row_order(rng):
    """Integer accumulation: permuting the rows of a segment changes no
    bit of its sum (f32 atomics would)."""
    x = torch.from_numpy((rng.standard_normal((1, 5000)) * 10.0 ** rng.integers(-8, 8, (1, 5000))).astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, 7, (1, 5000)))
    a = TSEG._f32_sum(x, seg, 5000)
    perm = torch.from_numpy(rng.permutation(5000)).reshape(1, -1)
    b = TSEG._f32_sum(x.gather(-1, perm), seg.gather(-1, perm), 5000)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("keys", [["k"], ["k", "b"], ["L#h0", "L#h1"]])
def test_distinct_byte_identical(mesh8, rng, keys):
    t = _table(rng, 2000, 20)
    t["L"] = rng.integers(-3, 3, 2000).astype(np.int64) << np.int64(33)
    jb, tb = _both(mesh8, t, 300)
    jv, jc = _ref(mesh8, jb, lambda b: JSEG.distinct(b, keys))
    tv, tc = _port(tb, lambda b: TSEG.distinct(b, keys))
    np.testing.assert_array_equal(tv, jv)
    assert sorted(tc) == sorted(jc)
    for c in jc:
        _assert_bytes(tc[c][tv], jc[c][jv], c)


def test_pair_to_f32_matches_reference():
    import jax.numpy as jnp

    lo = np.array([0, 1, 2**32 - 1, 12345, 2**31], np.uint32)
    hi = np.array([0, 2**31, 2**32 - 1, 7, 2**31 - 1], np.uint32)
    ref = np.asarray(JSEG.pair_to_f32(jnp.asarray(lo), jnp.asarray(hi)))
    got = TSEG.pair_to_f32(torch.from_numpy(lo.astype(np.int64)), torch.from_numpy(hi.astype(np.int64)))
    _assert_bytes(got.numpy(), ref, "pair_to_f32")
