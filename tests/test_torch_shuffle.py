"""Hashing, splitter election, range bucketing, the exchange and resize
of the port (dryad_tpu_torch/ops/{hash,sort,shuffle}.py,
columnar/batch.py) against the JAX package on its 8-device CPU mesh,
both at P=8.  Every comparison is exact: these decide where each row
lands, so they must be bit-identical (hash words, destinations,
splitters, every slot of the exchanged and resized batches, the
overflow flag)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dryad_tpu.columnar.schema import ColumnType as JCT
from dryad_tpu.columnar.schema import Schema as JSchema
from dryad_tpu.ops import hash as JH
from dryad_tpu.ops import shuffle as JSH
from dryad_tpu.ops import sort as JS
from dryad_tpu.ops import sortkeys as JK
from dryad_tpu.parallel.distribute import from_host_table
from dryad_tpu.parallel.mesh import AXIS
from dryad_tpu.parallel.stage import compile_stage
from dryad_tpu_torch.columnar.batch import ColumnBatch, to_device_column, to_host_column
from dryad_tpu_torch.columnar.schema import ColumnType, Schema
from dryad_tpu_torch.ops import hash as TH
from dryad_tpu_torch.ops import shuffle as TSH
from dryad_tpu_torch.ops import sort as TS
from dryad_tpu_torch.ops import sortkeys as TK
from dryad_tpu_torch.parallel import partition as TP

P = 8
FIELDS = [("k", "INT32"), ("v", "FLOAT32"), ("b", "BOOL")]


def _table(rng, n, hot=None):
    k = rng.integers(-40, 40, n).astype(np.int32)
    if hot is not None:
        k = np.where(rng.random(n) < hot, 7, k).astype(np.int32)
    v = rng.choice(np.array([0.0, -0.0, 1.5, -2.25, np.inf, 3.0], np.float32), n)
    return {"k": k, "v": v.astype(np.float32), "b": rng.random(n) < 0.5}


def _both(mesh, rng, n, cap, **kw):
    """The same table laid out over P partitions of ``cap`` rows (the
    tail of each partition invalid) in both packages."""
    t = _table(rng, n, **kw)
    jschema = JSchema([(c, getattr(JCT, ct)) for c, ct in FIELDS])
    tschema = Schema([(c, getattr(ColumnType, ct)) for c, ct in FIELDS])
    jb = from_host_table(jschema, t, mesh, partition_capacity=cap)
    tb = ColumnBatch.from_numpy(tschema, t, P, "cpu", partition_capacity=cap)
    return jb, tb


def _run(mesh, fn, jb):
    return compile_stage(mesh, fn)((jb,), ())


def _flat(t: torch.Tensor) -> np.ndarray:
    return to_host_column(t.reshape(-1))


def _assert_batches_equal(jbatch, tbatch):
    jv, jcols, _ = jbatch.fetch_host()
    np.testing.assert_array_equal(_flat(tbatch.valid), jv)
    assert sorted(tbatch.data) == sorted(jcols)
    for c, a in jcols.items():
        got = _flat(tbatch.data[c])
        assert got.dtype == a.dtype, c
        np.testing.assert_array_equal(got.view(np.uint8), a.view(np.uint8), err_msg=c)


# -- hashing ----------------------------------------------------------------

def _hash_cols(rng):
    n = 3000
    words = rng.integers(0, 2**64, n, dtype=np.uint64)  # STRING #h0/#h1 words
    return [
        np.array([0, 1, -1, 2**31 - 1, -2**31] * 600, np.int32),
        rng.choice(np.array([0.0, -0.0, 1.0, -1.0, np.nan, np.inf, 1e-45, 3.4e38], np.float32), n),
        rng.random(n) < 0.5,
        (words & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        (words >> np.uint64(32)).astype(np.uint32),
    ]


@pytest.mark.parametrize("which", [[0], [1], [2], [3, 4], [0, 1, 2, 3, 4]])
@pytest.mark.parametrize("nparts", [8, 3, 1])
def test_hash_and_partition_ids_bit_identical(rng, which, nparts):
    cols = [_hash_cols(rng)[i] for i in which]
    ref_h = np.asarray(JH.hash_columns([jnp.asarray(c) for c in cols]))
    ref_p = np.asarray(JH.partition_ids([jnp.asarray(c) for c in cols], nparts))
    tcols = [to_device_column(c, "cpu") for c in cols]
    np.testing.assert_array_equal(to_host_column(TH.hash_columns(tcols)), ref_h)
    got = TH.partition_ids(tcols, nparts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref_p)


def test_negative_zero_hashes_as_zero():
    h = TH.hash_columns([torch.tensor([0.0, -0.0])])
    assert int(h[0]) == int(h[1])


# -- splitters and range destinations -----------------------------------------

@pytest.mark.parametrize("nparts,m", [(8, 16), (3, 37), (1, 16)])
@pytest.mark.parametrize("hot", [None, 0.9])
def test_splitters_and_range_dest_bit_identical(mesh8, rng, nparts, m, hot):
    jb, tb = _both(mesh8, rng, 2500, 400, hot=hot)

    def stage(sharded, _):
        (b,) = sharded
        k = JK.to_sortable_u32(b["k"])
        words = [k, JK.to_sortable_u32(b["v"], True), JS.spread_word(b.capacity)]
        sp = JS.sample_splitters(k, b.valid, nparts, m, AXIS)
        spm = JS.sample_splitters_multi(words, b.valid, nparts, m, AXIS)
        sp2 = JS.sample_splitters_multi(words[::2], b.valid, nparts, m, AXIS)  # order_by's
        dests = (JS.range_dest(k, sp), JS.range_dest_multi(words, spm),
                 JS.range_dest_multi(words[::2], sp2))
        return dests, (sp, *spm, *sp2)

    dests, splitters = _run(mesh8, stage, jb)
    k = TK.to_sortable_u32(tb.data["k"])
    words = [k, TK.to_sortable_u32(tb.data["v"], True),
             TS.spread_word(tb.capacity).expand_as(k)]
    tsp = TS.sample_splitters(k, tb.valid, nparts, m)
    tspm = TS.sample_splitters_multi(words, tb.valid, nparts, m)
    tsp2 = TS.sample_splitters_multi(words[::2], tb.valid, nparts, m)
    for a, b in zip([tsp, *tspm, *tsp2], splitters):
        np.testing.assert_array_equal(to_host_column(a), np.asarray(b))
    tdests = (TS.range_dest(k, tsp), TS.range_dest_multi(words, tspm),
              TS.range_dest_multi(words[::2], tsp2))
    for a, b in zip(tdests, dests):
        np.testing.assert_array_equal(_flat(a), np.asarray(b))


def test_spread_word_bit_identical():
    n = 5000
    np.testing.assert_array_equal(to_host_column(TS.spread_word(n)), np.asarray(JS.spread_word(n)))


def test_range_dest_multi_single_pack_matches_splitter_loop(rng):
    """The one-pack searchsorted route and the splitter-by-splitter route
    give the same destinations."""
    w = [torch.from_numpy(rng.integers(0, 4, (P, 300))).to(torch.int64) for _ in range(3)]
    sp = [torch.tensor([0, 1, 1, 3]), torch.tensor([2, 0, 3, 1]), torch.tensor([1, 1, 0, 2])]
    two = TS.range_dest_multi(w[:2], sp[:2])
    three = TS.range_dest_multi(w[:2] + [torch.zeros_like(w[0])], sp[:2] + [torch.zeros(4, dtype=torch.int64)])
    np.testing.assert_array_equal(two.numpy(), three.numpy())


# -- exchange and resize ------------------------------------------------------

@pytest.mark.parametrize("nparts", [8, 3])
@pytest.mark.parametrize("hot", [None, 0.9])
def test_exchange_placement_and_overflow_bit_identical(mesh8, rng, nparts, hot):
    """Two bucket capacities: the slack one and one that overflows; the
    placement, every slot and the flag match the reference."""
    jb, tb = _both(mesh8, rng, 2500, 400, hot=hot)
    for B in (JSH.bucket_capacity(400, nparts, 2.0), 24):

        def stage(sharded, _):
            (b,) = sharded
            dest = JH.partition_ids([b["k"]], nparts)
            out, ovf = JSH.exchange(b, dest, P, B, AXIS)
            return (out,), (ovf,)

        (jout,), (jovf,) = _run(mesh8, stage, jb)
        tout, tovf = TSH.exchange(tb, TH.partition_ids([tb.data["k"]], nparts), P, B)
        assert bool(tovf) == bool(jovf)
        _assert_batches_equal(jout, tout)
    assert bool(tovf)  # the small bucket overflows


@pytest.mark.parametrize("cap", [64, 400, 1000])
def test_resize_bit_identical(mesh8, rng, cap):
    jb, tb = _both(mesh8, rng, 2000, 400)
    B = JSH.bucket_capacity(400, P, 2.0)

    def stage(sharded, _):
        (b,) = sharded
        out, _ = JSH.exchange(b, JH.partition_ids([b["k"]], P), P, B, AXIS)
        out, ovf = JSH.resize(out, cap)
        return (out,), (ovf,)

    (jout,), (jovf,) = _run(mesh8, stage, jb)
    dest = TH.partition_ids([tb.data["k"]], P)
    tout, _ = TSH.exchange(tb, dest, P, B)
    tout, tovf = TSH.resize(tout, cap)
    assert bool(tovf) == bool(jovf) == (cap == 64)
    _assert_batches_equal(jout, tout)
    # the resize fused into the exchange's placement: the same bytes
    fout, fovf = TSH.exchange(tb, dest, P, B, capacity=cap)
    assert bool(fovf) == bool(jovf)
    _assert_batches_equal(jout, fout)


def test_bucket_capacity_matches_reference():
    for cap, n, slack in [(100, 8, 2.0), (4, 8, 2.0), (1 << 20, 3, 1.5), (7, 1, 8.0)]:
        assert TSH.bucket_capacity(cap, n, slack) == JSH.bucket_capacity(cap, n, slack)


def test_compact_take_pad_to(mesh8, rng):
    jb, tb = _both(mesh8, rng, 2000, 300)

    def stage(sharded, _):
        (b,) = sharded
        c = b.compact()
        return (c, c.pad_to(320)), (c.count(),)

    (jc, jp), _ = _run(mesh8, stage, jb)
    _assert_batches_equal(jc, tb.compact())
    _assert_batches_equal(jp, tb.compact().pad_to(320))
    np.testing.assert_array_equal(
        tb.count().numpy(), tb.valid.sum(-1).numpy().astype(np.int32))


def test_all_to_all_and_psum_layouts():
    send = torch.arange(P * P * 3).reshape(P, P, 3)
    recv = TP.all_to_all(send)
    for dst in range(P):
        for src in range(P):
            assert recv[dst, src * 3: src * 3 + 3].tolist() == send[src, dst].tolist()
    assert TP.psum(torch.ones(P, 4, dtype=torch.int32)).tolist() == [P] * 4
