"""WordCount and the dense group_by end to end: the port
(dryad_tpu_torch, device="cpu") against the JAX package on its 8-device
CPU mesh, both at P=8.

Exact (byte-identical) comparison for keys, counts, integer sums, the
top-k rows including which tied words are chosen, and the stage op
lists.  Float sums: the reference's CPU dense path sums with an exact
f32 segment_sum and the port with f32 index_add, in other orders, so a
bucket may differ by f32 rounding of its partial sums:
|diff| <= 1e-5 * sum(|v|) + 1e-6.
"""

import numpy as np
import pytest
import torch

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.exec.executor import StageFailedError as JStageFailed
from dryad_tpu.parallel import distribute as JD
from dryad_tpu.plan.lower import lower as jlower
from dryad_tpu_torch import interop
from dryad_tpu_torch.exec.executor import StageFailedError
from dryad_tpu_torch.parallel.partition import block_layout
from dryad_tpu_torch.plan.lower import lower as tlower

P = 8


def _ctxs(**cfg):
    jc = J.DryadContext(num_partitions_=P, config=J.DryadConfig(**cfg) if cfg else None)
    tc = T.DryadContext(num_partitions_=P, config=T.DryadConfig(**cfg) if cfg else None, device="cpu")
    return jc, tc


def _tied_text(seed):
    """Counts with long runs of ties, so take(10) must pick the same tied
    words as the reference, plus multi-byte and long words."""
    rng = np.random.default_rng(seed)
    counts = [50, 40, 30, 30, 30] + [20] * 9 + [10] * 20 + [3] * 30 + [1] * 40
    words = [f"w{i:03d}" for i in range(len(counts) - 3)] + ["é", "naïveté", "abcdefghijkl"]
    toks = np.repeat(np.array(words, object), counts)
    rng.shuffle(toks)
    return " ".join(toks) + "\n"


def _assert_identical(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", [0, 1])
def test_wordcount_table_and_top10_byte_identical(seed):
    text = _tied_text(seed)
    out = []
    for ctx in _ctxs():
        q = ctx.from_text(text).group_by("word", {"n": ("count", None)})
        out.append((
            q.collect(),
            q.order_by([("n", True)]).take(10).collect(),
            q.order_by([("n", True), ("word", False)]).take(7).collect(),
        ))
    for a, b in zip(*out):
        _assert_identical(a, b)
    assert len(out[1][1]["word"]) == 10


def test_wordcount_from_arrays_strings(rng):
    words = np.array([f"k{i}" for i in rng.integers(0, 40, 500)], object)
    res = [
        ctx.from_arrays({"s": words, "x": np.ones(500, np.int32)})
        .group_by("s", {"c": ("count", None), "t": ("sum", "x")}).collect()
        for ctx in _ctxs()
    ]
    _assert_identical(*res)


def _plan(ctx, q, lower):
    if lower is jlower:
        return lower([q.node], ctx.config, ctx.dictionary, P=P)
    return lower([q.node], ctx.config, ctx.dictionary)


def _param_view(k, v):
    if k == "aggs":
        return [(a.op, a.col, a.out) for a in v]
    if k == "operands_fn":
        return [(f.name, f.ctype.value, d) for f, d in v.fields]
    if k == "table":
        return (v.slots_h0.tobytes(), v.slots_h1.tobytes(), v.slots_code.tobytes())
    if k == "decode":
        return v.words.tobytes()
    return v


def test_stage_op_lists_match_reference():
    text = _tied_text(3)
    plans = []
    for ctx, lower in zip(_ctxs(), (jlower, tlower)):
        q = ctx.from_text(text).group_by("word", {"n": ("count", None)})
        graph = _plan(ctx, q.order_by([("n", True)]).take(10), lower)
        plans.append([
            [(op.kind, {k: _param_view(k, v) for k, v in op.params.items()}) for op in s.ops]
            for s in graph.stages
        ])
    assert plans[0] == plans[1]
    assert [k for k, _ in plans[1][0]] == ["string_code", "group_reduce_dense", "project", "topk"]


def _dense_table(rng, n=4096, K=97):
    return {
        "k": rng.integers(0, K, n).astype(np.int32),
        "v": rng.standard_normal(n).astype(np.float32),
        "w": rng.integers(-50, 50, n).astype(np.int32),
    }


AGGS = {"c": ("count", None), "s": ("sum", "v"), "m": ("mean", "v"), "sw": ("sum", "w")}


def _assert_dense_close(a, b, tbl, K):
    for k in ("k", "c", "sw"):
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    absum = np.bincount(tbl["k"], weights=np.abs(tbl["v"]), minlength=K)[a["k"]]
    for k, scale in (("s", absum), ("m", absum / np.maximum(a["c"], 1))):
        assert a[k].dtype == b[k].dtype == np.float32
        assert np.all(np.abs(a[k] - b[k]) <= 1e-5 * scale + 1e-6)


@pytest.mark.parametrize("dense", [97, None])
def test_dense_and_int_auto_dense_group_by(rng, dense):
    tbl = _dense_table(rng)
    res, plans = [], []
    for ctx, lower in zip(_ctxs(), (jlower, tlower)):
        q = ctx.from_arrays(tbl).group_by("k", AGGS, dense=dense)
        res.append(q.collect())
        plans.append([op.kind for s in _plan(ctx, q, lower).stages for op in s.ops])
        guard = _plan(ctx, q, lower).stages[0].ops[0].params["guard"]
        assert guard is (dense is None)
    assert plans[0] == plans[1] == ["group_reduce_dense", "project"]
    _assert_dense_close(*res, tbl, 97)
    np.testing.assert_array_equal(res[1]["c"], np.bincount(tbl["k"], minlength=97))


def test_int_auto_dense_fabricated_key_raises(rng):
    for ctx, err in zip(_ctxs(), (JStageFailed, StageFailedError)):
        arrays = {"k": rng.integers(0, 20, 400).astype(np.int32)}
        q = ctx.from_arrays(arrays).group_by("k", {"c": ("count", None)})
        arrays["k"][:] = arrays["k"] + 100  # past the ingest-time range
        with pytest.raises(err, match="ingest-time range"):
            q.collect()


def test_dense_explicit_drops_out_of_range_keys():
    k = np.array([0, 1, 2, 7, -1, 1], np.int32)
    res = [
        ctx.from_arrays({"k": k}).group_by("k", {"c": ("count", None)}, dense=3).collect()
        for ctx in _ctxs()
    ]
    _assert_identical(*res)
    np.testing.assert_array_equal(res[1]["c"], [1, 2, 1])


def test_ingest_layout_matches_reference(mesh8, rng):
    phys = {"a": rng.integers(0, 2**32, 1001, dtype=np.uint64).astype(np.uint32),
            "b": rng.standard_normal(1001).astype(np.float32)}
    ref = JD.from_physical_table(phys, mesh8)
    valid, cols = ref.fetch_host()[:2]
    got = interop.batch_from_physical(cols, valid, P, "cpu")
    data, lay_valid = block_layout(phys, P)
    np.testing.assert_array_equal(got.valid.numpy(), lay_valid)
    for c in phys:
        np.testing.assert_array_equal(got.data[c].numpy(), data[c].astype(got.data[c].numpy().dtype))


def test_unported_shapes_raise_not_implemented():
    from dryad_tpu_torch.plan.nodes import Node, PartitionInfo

    _, tc = _ctxs()
    q = tc.from_text("b a c a")
    k = tc.from_arrays({"k": np.array([-1, 2], np.int32)})
    unknown = Node("bogus", [q.node, k.node], q.schema, PartitionInfo())
    with pytest.raises(NotImplementedError, match="lowering for node kind 'bogus'"):
        tlower([unknown], tc.config, tc.dictionary)
    # explain(analyze=True) is ported: its runtime panels are the
    # reference's, clocks masked (the plan text is compared, ids
    # renumbered, in tests/test_torch_events_explain.py)
    from tests.test_torch_events_explain import mask_analyze

    jc, _ = _ctxs()
    port, ref = (c.from_text("b a c a").group_by("word", {"n": ("count", None)}).explain(analyze=True)
                 for c in (tc, jc))
    panel = "== runtime diagnosis =="
    assert mask_analyze(port.split(panel)[1]) == mask_analyze(ref.split(panel)[1])
    # collect_stream is ported: a plan without a stream input yields
    # its whole result as one piece
    (piece,) = list(k.collect_stream())
    np.testing.assert_array_equal(piece["k"], np.array([-1, 2], np.int32))


def test_context_device_cache_reuses_ingest():
    _, tc = _ctxs()
    q = tc.from_text("x y x").group_by("word", {"n": ("count", None)})
    a = q.collect()
    assert len(tc._device_cache) == 1
    batch = next(iter(tc._device_cache.values()))[1]
    _assert_identical(a, q.collect())
    assert next(iter(tc._device_cache.values()))[1] is batch
    assert isinstance(batch.valid, torch.Tensor) and batch.valid.shape[0] == P
