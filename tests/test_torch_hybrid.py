"""The hybrid DCN x ICI mesh of the port (``DryadContext(dcn_slices=2)``,
``parallel/mesh.py::make_hybrid_mesh``, the exchange over one mesh axis,
``exec/kernels.py::_tree_exchange_hash``) against the JAX package on
its 2 x 4 hybrid mesh of virtual CPU devices.

Every case of the reference's tests/test_multihost.py runs in both
packages, plus a negative-key ``group_by`` (the tree exchange: non-
negative INT32 keys would lower to the dense path, which exchanges
nothing), a salted one, the distinct and decomposable trees, the dense
bucket path, and the staged exchange on the hybrid mesh.  Keys,
integers and placement are byte-equal to the reference's rows; float
sums stay within the sort path's n_g * 2^-23 * sum_g |v|; the
``exchange_round`` events equal the reference's field for field.  The
exchange over one axis is held against the reference's op slot for
slot, and ``exclude_devices`` keeps the 2-D structure as the
reference's does.
"""

import collections

import numpy as np
import pytest
import torch

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.columnar.schema import ColumnType as JCT
from dryad_tpu.columnar.schema import Schema as JSchema
from dryad_tpu.ops import hash as JH
from dryad_tpu.ops import shuffle as JSH
from dryad_tpu.parallel import mesh as JM
from dryad_tpu.parallel.distribute import from_host_table
from dryad_tpu.parallel.stage import compile_stage
from dryad_tpu.plan import xchgplan as JXP
from dryad_tpu_torch.columnar.batch import ColumnBatch, to_host_column
from dryad_tpu_torch.columnar.schema import ColumnType, Schema
from dryad_tpu_torch.ops import hash as TH
from dryad_tpu_torch.ops import shuffle as TSH
from dryad_tpu_torch.parallel import mesh as TM
from dryad_tpu_torch.plan import xchgplan as TXP

F32 = 2.0 ** -23


@pytest.fixture(scope="module")
def ctxs():
    return J.DryadContext(dcn_slices=2), T.DryadContext(dcn_slices=2, device="cpu")


@pytest.fixture
def table(rng):
    n = 2048
    return {"k": rng.integers(0, 64, n).astype(np.int32), "v": rng.standard_normal(n).astype(np.float32)}


def _np(out):
    return {c: np.asarray(v) for c, v in out.items()}


def _by(out, keys):
    """Rows in key order (the result's own order when ``keys`` is empty)."""
    out = _np(out)
    if not keys:
        return out
    order = np.lexsort([out[k] for k in reversed(keys)])
    return {c: v[order] for c, v in out.items()}


def _equal(a, b, floats=None):
    """Equal columns: byte for byte, or for ``floats`` (column -> per-row
    bound) within the bound."""
    floats = floats or {}
    assert sorted(a) == sorted(b)
    for c in a:
        assert a[c].dtype == b[c].dtype and a[c].shape == b[c].shape, c
        if c in floats:
            assert (np.abs(a[c].astype(np.float64) - b[c]) <= floats[c]).all(), c
        elif a[c].dtype == object:  # STRING
            assert a[c].tolist() == b[c].tolist(), c
        else:
            assert a[c].tobytes() == b[c].tobytes(), c


def _group_bound(t, keys, out, col="v", mean=False):
    """n_g * 2^-23 * sum_g |v| per output group (divided by n_g for a mean)."""
    absv = np.abs(t[col].astype(np.float64))
    out_keys = list(zip(*[out[k] for k in keys]))
    n = collections.Counter(zip(*[t[k] for k in keys]))
    s = collections.defaultdict(float)
    for key, a in zip(zip(*[t[k] for k in keys]), absv):
        s[key] += a
    return np.array([(1 if mean else n[key]) * F32 * s[key] for key in out_keys])


def _rounds(ctx):
    evs = ctx.executor.events.events() if isinstance(ctx, J.DryadContext) else ctx.events.events()
    ids = {}
    out = []
    for e in evs:
        if e["kind"] == "exchange_round":
            r = {f: e[f] for f in ("stage", "name", "round", "window", "bytes", "ici_bytes",
                                   "dcn_bytes")}
            r["stage"] = ids.setdefault(r["stage"], len(ids))
            out.append(r)
    return out


def _both(ctxs, build, keys=()):
    """The query ``build(ctx)`` collected in each package: (reference
    rows, port rows), in key order."""
    return tuple(_by(build(c).collect(), list(keys)) for c in ctxs)


# -- the mesh ----------------------------------------------------------------------


def test_hybrid_mesh_shape(ctxs):
    jc, tc = ctxs
    assert TM.mesh_axes(tc.mesh) == tuple(jc.mesh.axis_names) == (TM.DCN_AXIS, TM.AXIS)
    assert TM.num_partitions(tc.mesh) == JM.num_partitions(jc.mesh) == 8
    assert TM.dcn_slice_count(tc.mesh) == JM.dcn_slice_count(jc.mesh) == 2
    assert TM.ici_partitions_per_slice(tc.mesh) == JM.ici_partitions_per_slice(jc.mesh) == 4
    assert tc.device.type == "cpu"


@pytest.mark.parametrize("bad", [[0], [5], [0, 1, 2, 3], [1, 6], [2, 7, 99], []])
def test_exclusion_keeps_the_dcn_axis(bad):
    """``exclude_devices`` on the 2 x 4 mesh (a partition names one of
    the reference's devices): the slices shed their excluded partitions
    and shrink to the smallest survivor, an emptied slice is dropped."""
    jm = JM.make_hybrid_mesh(2, 4)
    jbad = [d.id for d in jm.devices.flat if d.id in set(bad)]
    j2 = JM.exclude_devices(jm, jbad)
    t2 = TM.exclude_devices(TM.make_hybrid_mesh(2, 4, "cpu"), bad)
    assert TM.mesh_axes(t2) == tuple(j2.axis_names)
    assert (t2.dcn, t2.ici, t2.P) == (j2.devices.shape[0], j2.devices.shape[1], j2.devices.size)
    with pytest.raises(ValueError, match="empty mesh"):
        TM.exclude_devices(TM.make_hybrid_mesh(2, 4, "cpu"), range(8))


# -- the reference's tests/test_multihost.py cases ---------------------------------


def test_hybrid_group_by_matches_reference(ctxs, table):
    aggs = {"s": ("sum", "v"), "c": ("count", None)}
    j, t = _both(ctxs, lambda c: c.from_arrays(table).group_by("k", aggs).order_by([("k", False)]))
    _equal(j, t, {"s": _group_bound(table, ["k"], t)})
    assert t["c"].sum() == len(table["k"])


def test_hybrid_order_by_global_sort(ctxs, table):
    j, t = _both(ctxs, lambda c: c.from_arrays(table).order_by([("v", False)]))
    _equal(j, t)
    np.testing.assert_array_equal(t["v"], np.sort(table["v"]))


def test_hybrid_join_and_where(ctxs, table):
    dims = {"k": np.arange(64, dtype=np.int32), "w": (np.arange(64) % 7).astype(np.float32)}
    got = [c.from_arrays(table).join(c.from_arrays(dims), "k", "k").where(lambda x: x["w"] > 3.0)
           .count() for c in ctxs]
    assert got[0] == got[1] == sum(1 for k in table["k"] if int(k) % 7 > 3)


def test_hybrid_take_skip_global_order(ctxs, table):
    j, t = _both(ctxs, lambda c: c.from_arrays(table).order_by([("v", False)]).take(10))
    _equal(j, t)
    j, t = _both(ctxs, lambda c: c.from_arrays(table).order_by([("v", False)]).skip(2030))
    _equal(j, t)
    assert len(t["v"]) == 18


def test_hybrid_scalar_aggregates(ctxs, table):
    got = [(c.from_arrays(table).count(), c.from_arrays(table).sum_("v"),
            c.from_arrays(table).min_("v")) for c in ctxs]
    assert got[0][0] == got[1][0] == len(table["k"])
    assert got[0][2] == got[1][2] == float(table["v"].min())
    assert abs(got[0][1] - got[1][1]) <= len(table["v"]) * F32 * np.abs(table["v"]).sum()


def test_hybrid_distinct(ctxs, table):
    j, t = _both(ctxs, lambda c: c.from_arrays({"k": table["k"]}).distinct(), ["k"])
    _equal(j, t)
    assert t["k"].tolist() == sorted(set(table["k"].tolist()))


def test_hybrid_broadcast_join(ctxs, table):
    small = {"k": np.arange(8, dtype=np.int32), "tag": np.ones(8, np.int32)}
    got = [c.from_arrays(table).join(c.from_arrays(small), "k", "k", strategy="broadcast").count()
           for c in ctxs]
    assert got[0] == got[1] == sum(1 for k in table["k"] if int(k) < 8)


def test_hybrid_matches_flat_mesh(table):
    """The hybrid mesh's mean by key equals the flat mesh's, in each package."""
    for pkg, kw in ((J, {}), (T, {"device": "cpu"})):
        outs = [_by(pkg.DryadContext(**mesh, **kw).from_arrays(table).group_by(
            "k", {"m": ("mean", "v")}).order_by([("k", False)]).collect(), [])
            for mesh in ({"num_partitions_": 8}, {"dcn_slices": 2})]
        assert outs[0]["k"].tobytes() == outs[1]["k"].tobytes()
        np.testing.assert_allclose(outs[0]["m"], outs[1]["m"], rtol=1e-5)


def test_hybrid_distinct_tree(ctxs, rng):
    """Negative keys keep the sort path, so ``distinct`` runs the tree
    exchange with the per-slice distinct."""
    ks = rng.integers(-50, 50, 3000).astype(np.int32)
    j, t = _both(ctxs, lambda c: c.from_arrays({"k": ks}).distinct(), ["k"])
    _equal(j, t)
    assert t["k"].tolist() == sorted(set(ks.tolist()))
    assert _rounds(ctxs[1])[-2:] == _rounds(ctxs[0])[-2:]


def _sum_sq(pkg):
    return pkg.Decomposable(
        seed=lambda cols: {"ss": cols["v"] * cols["v"]},
        merge=lambda a, b: {"ss": a["ss"] + b["ss"]},
        state_cols=["ss"],
        out_fields=[("ss", pkg.ColumnType.FLOAT32)],
    )


def test_hybrid_decomposable_tree(ctxs, rng):
    """A sum of squares through the tree exchange's per-slice
    ``group_combine`` (negative keys: the sort path)."""
    tbl = {"k": rng.integers(-8, 8, 2048).astype(np.int32), "v": rng.standard_normal(2048).astype(np.float32)}
    outs = [_by(c.from_arrays(tbl).group_by("k", decomposable=_sum_sq(pkg)).order_by(
        [("k", False)]).collect(), []) for c, pkg in zip(ctxs, (J, T))]
    sq = {"k": tbl["k"], "v": tbl["v"] * tbl["v"]}
    _equal(outs[0], outs[1], {"ss": _group_bound(sq, ["k"], outs[1])})
    ref = collections.defaultdict(float)
    for k, v in zip(tbl["k"], tbl["v"]):
        ref[int(k)] += float(v) ** 2
    np.testing.assert_allclose(outs[1]["ss"], [ref[k] for k in sorted(ref)], rtol=2e-4)


def test_hybrid_sliding_window_ring(ctxs):
    tbl = {"x": np.arange(24, dtype=np.int32)}
    j, t = _both(ctxs, lambda c: c.from_arrays(tbl).sliding_window(10, "x"),
                 [f"x_w{i}" for i in range(10)])
    _equal(j, t)
    rows = sorted(zip(*[t[f"x_w{i}"] for i in range(10)]))
    assert [tuple(int(v) for v in r) for r in rows] == [tuple(range(i, i + 10)) for i in range(15)]


# -- the tree exchange and the dense path ------------------------------------------


AGGS = {"c": ("count", None), "s": ("sum", "v"), "m": ("mean", "v"), "lo": ("min", "w"),
        "hi": ("max", "w"), "sw": ("sum", "w")}


def _neg_table(seed, n=3000, nkeys=120):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(-nkeys // 2, nkeys // 2, n).astype(np.int32),
            "g": rng.integers(0, 3, n).astype(np.int32),
            "v": rng.standard_normal(n).astype(np.float32),
            "w": rng.integers(-1000, 1000, n).astype(np.int32)}


@pytest.mark.parametrize("window", [0, 1, 2])
@pytest.mark.parametrize("salt", [None, 3])
def test_negative_key_group_by_takes_the_tree_exchange(salt, window):
    """A negative-key ``group_by`` on the 2 x 4 mesh: the ICI hop, the
    per-slice reduce, the DCN hop, flat or staged.  Rows and every
    ``exchange_round`` event equal the reference's; each tree has one
    DCN exchange, whose pseudo-round crosses slices only."""
    t = _neg_table(5)
    cfg = dict(exchange_window=window)
    jc = J.DryadContext(dcn_slices=2, config=J.DryadConfig(**cfg))
    tc = T.DryadContext(dcn_slices=2, device="cpu", config=T.DryadConfig(**cfg))
    j, o = _both((jc, tc), lambda c: c.from_arrays(t).group_by("k", AGGS, salt=salt), ["k"])
    _equal(j, o, {"s": _group_bound(t, ["k"], o), "m": _group_bound(t, ["k"], o, mean=True)})
    jr, tr = _rounds(jc), _rounds(tc)
    assert tr == jr and tr
    assert all(r["window"] == window for r in tr)
    dcn = [r for r in tr if r["dcn_bytes"]]
    assert dcn and all(r["ici_bytes"] == 0 for r in dcn)


def test_two_key_and_string_group_by_on_the_hybrid_mesh(ctxs):
    t = _neg_table(6)
    t["s"] = np.array([f"w{i}" for i in np.abs(t["k"])], object)
    j, o = _both(ctxs, lambda c: c.from_arrays(t).group_by(["k", "g"], AGGS), ["k", "g"])
    _equal(j, o, {"s": _group_bound(t, ["k", "g"], o), "m": _group_bound(t, ["k", "g"], o, mean=True)})
    j, o = _both(ctxs, lambda c: c.from_arrays(t).group_by("s", {"c": ("count", None),
                                                                 "sw": ("sum", "w")}), ["s"])
    _equal(j, o)


def test_dense_bucket_path_on_the_hybrid_mesh(ctxs):
    """Non-negative INT32 keys auto-lower to the dense path (the bucket
    kernel's plain version on the CPU, then the reduce-scatter): no
    exchange, the reference's rows."""
    rng = np.random.default_rng(8)
    t = {"k": rng.integers(0, 500, 4000).astype(np.int32), "v": rng.standard_normal(4000).astype(np.float32),
         "w": rng.integers(-100, 100, 4000).astype(np.int32)}
    aggs = {"c": ("count", None), "s": ("sum", "v"), "sw": ("sum", "w")}
    before = len(_rounds(ctxs[1]))
    j, o = _both(ctxs, lambda c: c.from_arrays(t).group_by("k", aggs), ["k"])
    absv = np.bincount(t["k"], weights=np.abs(t["v"].astype(np.float64)))[o["k"]]
    _equal(j, o, {"s": 2.0 ** -16 * absv})
    assert len(_rounds(ctxs[1])) == before  # the dense path exchanges nothing


@pytest.mark.parametrize("window", [1, 2])
def test_staged_queries_on_the_hybrid_mesh(window):
    """TeraSort, a shuffle join and the rank exchanges at a staged
    window on the 2 x 4 mesh: the flat window's rows, the reference's
    events (ICI rounds first, then one DCN round)."""
    t = _neg_table(9)
    right = {"k": np.arange(-60, 60, dtype=np.int32), "r": np.arange(120, dtype=np.int32)}
    queries = [lambda c: c.from_arrays(t).order_by([("w", False), ("k", True)]),
               lambda c: c.from_arrays(t).join(c.from_arrays(right), "k", strategy="shuffle"),
               lambda c: c.from_arrays(t).zip_(c.from_arrays(t).where(lambda x: x["g"] > 0))]
    ref_rows = []
    for pkg, kw in ((J, {}), (T, {"device": "cpu"})):
        rows = []
        for w in (0, window):
            ctx = pkg.DryadContext(dcn_slices=2, config=pkg.DryadConfig(exchange_window=w), **kw)
            rows.append([_np(q(ctx).collect()) for q in queries] + [_rounds(ctx)])
        ref_rows.append(rows)
    (j0, jw), (t0, tw) = ref_rows
    for a, b, c in zip(t0[:-1], tw[:-1], jw[:-1]):
        keys = sorted(a)
        a, b, c = _by(a, keys), _by(b, keys), _by(c, keys)
        _equal(a, b)
        _equal(c, b)
    assert tw[-1] == jw[-1] and t0[-1] == j0[-1]
    dcn = [i for i, r in enumerate(tw[-1]) if r["dcn_bytes"]]
    assert dcn and all(r["window"] == window for r in tw[-1])


# -- the exchange over one axis, op level ------------------------------------------


FIELDS = [("k", "INT32"), ("v", "FLOAT32")]


@pytest.mark.parametrize("window", [0, 1, 3])
@pytest.mark.parametrize("axis", ["ici", "dcn"])
def test_exchange_over_one_axis_equals_the_reference(axis, window):
    """Within each slice (ICI) or across the slices (DCN): the received
    width is the axis's extent times B, as the reference's, and every
    slot and the flag are the reference's, flat or staged."""
    jm = JM.make_hybrid_mesh(2, 4)
    tm = TM.make_hybrid_mesh(2, 4, "cpu")
    rng = np.random.default_rng(4)
    n, cap = 700, 96
    t = {"k": rng.integers(-90, 90, n).astype(np.int32), "v": rng.standard_normal(n).astype(np.float32)}
    jb = from_host_table(JSchema([(c, getattr(JCT, ct)) for c, ct in FIELDS]), t, jm,
                         partition_capacity=cap)
    tb = ColumnBatch.from_numpy(Schema([(c, getattr(ColumnType, ct)) for c, ct in FIELDS]), t, 8,
                                "cpu", partition_capacity=cap)
    jaxis, taxis, n_axis = ((JM.AXIS, TM.AXIS, 4) if axis == "ici" else (JM.DCN_AXIS, TM.DCN_AXIS, 2))
    dcn = 1 if axis == "ici" else 2
    window = min(window, n_axis - 1)
    B = TSH.bucket_capacity(cap, n_axis, 1.5)

    def stage(sharded, _):
        (b,) = sharded
        dest = JH.partition_ids([b["k"]], 8) % n_axis
        if window:
            out, ovf = JSH.exchange_staged(b, dest, n_axis, B, (jaxis,),
                                           JXP.plan_exchange(n_axis, window, dcn))
        else:
            out, ovf = JSH.exchange(b, dest, n_axis, B, (jaxis,))
        return (out,), (ovf,)

    (jout,), (jovf,) = compile_stage(jm, stage)((jb,), ())
    dest = TH.partition_ids([tb.data["k"]], 8) % n_axis
    if window:
        out, ovf = TSH.exchange_staged(tb, dest, n_axis, B, TXP.plan_exchange(n_axis, window, dcn),
                                       mesh=tm, axis=taxis)
    else:
        out, ovf = TSH.exchange(tb, dest, n_axis, B, mesh=tm, axis=taxis)
    assert out.capacity == n_axis * B
    assert bool(ovf) == bool(jovf)
    jv, jcols, _ = jout.fetch_host()
    np.testing.assert_array_equal(to_host_column(out.valid.reshape(-1)), jv)
    for c, a in jcols.items():
        assert to_host_column(out.data[c].reshape(-1)).tobytes() == a.tobytes(), c
    flat, _ = TSH.exchange(tb, dest, n_axis, B, capacity=n_axis * B // 2, mesh=tm, axis=taxis)
    staged, _ = TSH.exchange_staged(tb, dest, n_axis, B, TXP.plan_exchange(n_axis, 1, dcn),
                                    capacity=n_axis * B // 2, mesh=tm, axis=taxis)
    assert torch.equal(flat.valid, staged.valid)
    for c in flat.data:
        assert torch.equal(flat.data[c], staged.data[c]), c


def test_an_axis_exchange_needs_a_hybrid_mesh():
    tb = ColumnBatch({"k": torch.zeros(8, 4, dtype=torch.int32)}, torch.ones(8, 4, dtype=torch.bool))
    dest = torch.zeros(8, 4, dtype=torch.int64)
    with pytest.raises(ValueError, match="hybrid mesh"):
        TSH.exchange(tb, dest, 4, 8, mesh=TM.make_mesh(8, "cpu"), axis=TM.AXIS)
    with pytest.raises(ValueError, match="among 4 partitions"):
        TSH.exchange(tb, dest, 2, 8, mesh=TM.make_hybrid_mesh(2, 4, "cpu"), axis=TM.AXIS)
