"""The fused sort path of the port (``dryad_tpu_torch/ops/segmented.py::
group_reduce_fused``, one multi-channel scan and one stacked scatter)
against the reference's ``group_reduce_fused`` run per partition on its
8-device CPU mesh, both at P=8: the cases of ``tests/test_fused_sortpath.py``.

Every output slot, valid or not, is compared byte for byte, floats
included: the port's scan copies JAX's recursion and adds f32 in its
order, flushing subnormals as the reference's backends do.  The float
sums also stay within ``n_g * 2^-23 * sum |v|`` of an exact float64
sum, and the integer outputs equal the port's default path.  The
``DRYAD_TPU_SORT_FUSED`` switch routes both packages' ``group_reduce``.
"""

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
FIELDS = [("k", "UINT32"), ("v", "FLOAT32"), ("i", "INT32"), ("b", "BOOL"), ("w", "INT64")]

# tests/test_fused_sortpath.py's aggregates (``w#h0`` the low word of w)
AGGS = [
    ("sum", "v", "sv"), ("sum", "i", "si"), ("count", None, "c"), ("mean", "v", "mv"),
    ("min", "v", "mnv"), ("max", "i", "mxi"), ("any", "b", "ab"), ("all", "b", "lb"),
    ("first", "i", "fi"), ("sum64", "w#h0", "ws"), ("min64", "w#h0", "wl"),
    ("max64", "w#h0", "wh"),
]


def _table(rng, n):
    return {
        "k": rng.integers(0, 40, n).astype(np.uint32),
        "v": (rng.standard_normal(n) * 3).astype(np.float32),
        "i": rng.integers(-50, 50, n).astype(np.int32),
        "b": rng.random(n) > 0.4,
        "w": (rng.integers(0, 2**20, n).astype(np.int64) << np.int64(32))
        | rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.int64),
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


def _fused(keys, aggs, pkg):
    return lambda b: pkg.group_reduce_fused(b, keys, [pkg.AggSpec(*a) for a in aggs])


@pytest.mark.parametrize("seed", range(5))
def test_fused_equals_reference_fused(mesh8, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(400, 7200))
    cap = 1024
    t = _table(rng, n)
    t["v"][:10] = np.float32(1e-42)  # subnormal: zero to the reference's backends
    jb, tb = _both(mesh8, t, cap)
    jv, jc = _ref(mesh8, jb, _fused(["k"], AGGS, JSEG))
    tv, tc = _port(tb, _fused(["k"], AGGS, TSEG))
    np.testing.assert_array_equal(tv, jv)
    assert sorted(tc) == sorted(jc)
    for c in jc:
        _assert_bytes(tc[c], jc[c], c)
    # integers equal the default path's, floats within its sum bound
    dv, dc = _port(tb, lambda b: TSEG.group_reduce(b, ["k"], [TSEG.AggSpec(*a) for a in AGGS]))
    np.testing.assert_array_equal(dv, tv)
    for c in dc:
        if dc[c].dtype.kind != "f":
            _assert_bytes(tc[c][tv], dc[c][dv], c)
    vin, k, v = tb.valid.numpy(), tb.data["k"].numpy(), tb.data["v"].numpy().astype(np.float64)
    v = np.where(np.abs(v) < 2.0 ** -126, 0.0, v)
    for p in range(P):
        sl = slice(p * cap, (p + 1) * cap)
        uk, inv = np.unique(k[p][vin[p]], return_inverse=True)
        cnt = np.bincount(inv)
        exact = np.bincount(inv, weights=v[p][vin[p]])
        bound = cnt * 2.0 ** -23 * np.bincount(inv, weights=np.abs(v[p][vin[p]]))
        got = tc["sv"][sl][tv[sl]].astype(np.float64)
        assert np.all(np.abs(got - exact) <= bound + 1e-30)


def test_fused_multi_key_and_empty(mesh8):
    rng = np.random.default_rng(9)
    t = _table(rng, 2400)
    jb, tb = _both(mesh8, t, 512)
    aggs = [("sum", "v", "s"), ("count", None, "c")]
    jv, jc = _ref(mesh8, jb, _fused(["k", "i"], aggs, JSEG))
    tv, tc = _port(tb, _fused(["k", "i"], aggs, TSEG))
    np.testing.assert_array_equal(tv, jv)
    for c in jc:
        _assert_bytes(tc[c], jc[c], c)
    # all-invalid input
    empty = ColumnBatch(dict(tb.data), torch.zeros_like(tb.valid))
    fe = TSEG.group_reduce_fused(empty, ["k"], [TSEG.AggSpec(*a) for a in aggs])
    assert int(fe.valid.sum()) == 0


def test_fused_env_switch_routes_group_reduce(mesh8, monkeypatch):
    """DRYAD_TPU_SORT_FUSED=1 routes both packages' entry point; unset,
    the default path runs."""
    rng = np.random.default_rng(3)
    t = _table(rng, 1600)
    jb, tb = _both(mesh8, t, 256)
    aggs = [("sum", "v", "s"), ("count", None, "c")]
    entry = lambda pkg: lambda b: pkg.group_reduce(b, ["k"], [pkg.AggSpec(*a) for a in aggs])
    monkeypatch.setenv("DRYAD_TPU_SORT_FUSED", "1")
    jv, jc = _ref(mesh8, jb, entry(JSEG))
    tv, tc = _port(tb, entry(TSEG))
    fv, fc = _port(tb, _fused(["k"], aggs, TSEG))
    monkeypatch.delenv("DRYAD_TPU_SORT_FUSED")
    dv, dc = _port(tb, entry(TSEG))
    for c in jc:
        _assert_bytes(tc[c], jc[c], c)
        _assert_bytes(tc[c], fc[c], c)
    np.testing.assert_array_equal(dv, tv)
    _assert_bytes(dc["c"][dv], tc["c"][tv], "c")


def test_fused_query_through_the_context(monkeypatch):
    """A sort-path group_by through a port context with the switch on
    gives the default path's keys and integer aggregates, and the same
    bytes on a rerun."""
    import dryad_tpu_torch as T

    rng = np.random.default_rng(5)
    t = {"k": rng.integers(-5000, 5000, 20000).astype(np.int32),
         "v": rng.standard_normal(20000).astype(np.float32),
         "i": rng.integers(-100, 100, 20000).astype(np.int32)}
    aggs = {"c": ("count", None), "si": ("sum", "i"), "sv": ("sum", "v"), "mx": ("max", "v")}
    ctx = T.DryadContext(num_partitions_=P, config=T.DryadConfig(auto_dense_ints=False), device="cpu")
    base = ctx.from_arrays(t).group_by("k", aggs).order_by([("k", False)]).collect()
    monkeypatch.setenv("DRYAD_TPU_SORT_FUSED", "1")
    runs = [ctx.from_arrays(t).group_by("k", aggs).order_by([("k", False)]).collect() for _ in range(2)]
    for c in base:
        _assert_bytes(runs[0][c], runs[1][c], c)
        if c != "sv":
            _assert_bytes(runs[0][c], base[c], c)
    np.testing.assert_allclose(runs[0]["sv"], base["sv"], rtol=1e-5, atol=1e-5)
