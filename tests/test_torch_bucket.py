"""The port's bucket reduction (dryad_tpu_torch/ops/bucket.py) against the
reference's Pallas kernel in interpret mode and numpy bincount.

On the CPU the wrapper runs its plain PyTorch version (the CUDA kernel
is held against that same plain version on the card by chip_smoke.py).

Tolerances: counts and integer sums are compared exactly (the contract:
exact while a bucket's partition total stays <= 2^24).  Float sums: the
reference splits each value into two bf16 terms (~2^-16 relative error
per element, ops/pallas_bucket.py docstring) and both sides accumulate
in f32, so a bucket may differ by up to 2^-15 * sum(|v|) over its rows.
"""

import jax
import numpy as np
import pytest
import torch

from dryad_tpu.ops.pallas_bucket import bucket_sum_count as jax_bucket
from dryad_tpu_torch.ops.bucket import bucket_sum_count, bucket_sum_count_plain
from dryad_tpu_torch.parallel.partition import psum_scatter

FLOAT_REL = 2.0 ** -15


def _inputs(rng, n, K, kinds):
    keys = rng.integers(0, K, n).astype(np.int32)
    valid = rng.random(n) > 0.25
    vals = []
    for kind in kinds:
        if kind == "i32":
            vals.append(rng.integers(-1000, 1000, n).astype(np.int32))
        else:
            vals.append((rng.standard_normal(n) * 10).astype(np.float32))
    return keys, valid, vals


def _check_sums(got, ref, keys, valid, v, K):
    if v.dtype == np.int32:
        np.testing.assert_array_equal(got, ref)
    else:
        absum = np.bincount(keys[valid], weights=np.abs(v[valid]), minlength=K)
        assert np.all(np.abs(got - ref) <= FLOAT_REL * absum + 1e-6)


@pytest.mark.parametrize(
    "K,kinds",
    [(128, ()), (128, ("f32", "i32")), (4096, ("f32",)), (5000, ()),
     (5000, ("i32", "f32"))],
)
def test_plain_matches_pallas_interpret_and_bincount(rng, K, kinds):
    n = 3001  # ragged: not a multiple of any row block
    keys, valid, vals = _inputs(rng, n, K, kinds)
    j_sums, j_cnt = jax_bucket(keys, vals, valid, K, interpret=True)
    t_sums, t_cnt = bucket_sum_count(
        torch.from_numpy(keys)[None], [torch.from_numpy(v)[None] for v in vals],
        torch.from_numpy(valid)[None], K,
    )
    ref_cnt = np.bincount(keys[valid], minlength=K)
    np.testing.assert_array_equal(t_cnt[0].numpy(), ref_cnt)
    np.testing.assert_array_equal(t_cnt[0].numpy(), np.asarray(j_cnt))
    for v, js, ts in zip(vals, j_sums, t_sums):
        exact = np.bincount(keys[valid], weights=v[valid].astype(np.float64), minlength=K)
        _check_sums(ts[0].numpy(), np.asarray(js), keys, valid, v, K)
        _check_sums(ts[0].numpy(), exact, keys, valid, v, K)


def test_partition_batching_matches_per_partition_calls(rng):
    """(P, cap) in one call == one reference call per partition row."""
    P, cap, K = 8, 300, 128
    keys, valid, (v,) = _inputs(rng, P * cap, K, ("f32",))
    keys, valid, v = keys.reshape(P, cap), valid.reshape(P, cap), v.reshape(P, cap)
    t_sums, t_cnt = bucket_sum_count_plain(
        torch.from_numpy(keys), [torch.from_numpy(v)], torch.from_numpy(valid), K
    )
    assert t_cnt.shape == (P, K) and t_sums[0].shape == (P, K)
    call = jax.jit(lambda k, w, m: jax_bucket(k, [w], m, K, interpret=True))
    for p in range(P):
        j_sums, j_cnt = call(keys[p], v[p], valid[p])
        np.testing.assert_array_equal(t_cnt[p].numpy(), np.asarray(j_cnt))
        _check_sums(t_sums[0][p].numpy(), np.asarray(j_sums[0]), keys[p], valid[p], v[p], K)


def test_masked_and_out_of_domain_rows_are_dropped(rng):
    keys = torch.tensor([[0, 1, 7, -1, 1]], dtype=torch.int32)
    valid = torch.tensor([[True, False, True, True, True]])
    vals = torch.tensor([[1.5, 100.0, 1e9, 5.0, 2.0]])
    sums, cnt = bucket_sum_count(keys, [vals], valid, 4)
    np.testing.assert_array_equal(cnt.numpy(), [[1, 1, 0, 0]])
    np.testing.assert_array_equal(sums[0].numpy(), [[1.5, 2.0, 0, 0]])


def test_cpu_path_does_not_count_launches_and_bad_inputs_raise():
    before = bucket_sum_count.launches
    k = torch.zeros((2, 4), dtype=torch.int32)
    m = torch.ones((2, 4), dtype=torch.bool)
    bucket_sum_count(k, [], m, 8)
    assert bucket_sum_count.launches == before
    with pytest.raises(ValueError):
        bucket_sum_count(k.long(), [], m, 8)
    with pytest.raises(ValueError):
        bucket_sum_count(k, [torch.zeros((2, 4), dtype=torch.float64)], m, 8)
    with pytest.raises(ValueError):
        bucket_sum_count(k.to("meta"), [], m.to("meta"), 8)


def test_counts_round_to_int32_before_the_partition_sum():
    """Each partition's f32 count is exact below 2^24; the global sum is
    taken in int32, so it stays exact past 2^24 where an f32 sum of the
    same partials would round (the reference's psum_scatter rule)."""
    P, per = 8, 4
    part = torch.zeros((P, P * per), dtype=torch.float32)
    part[:, 3] = float((1 << 24) - 1)
    part[0, 3] = float((1 << 24) - 2)
    part[:, 5] = 1.0
    total = P * (1 << 24) - P - 1  # not a multiple of f32's spacing there
    got = psum_scatter(torch.round(part).to(torch.int32))
    assert got.dtype == torch.int32 and got.shape == (P, per)
    assert int(got[0, 3]) == total
    assert int(got[1, 1]) == P
    assert float(part.sum(0)[3]) != total


# -- the fixed-point design: adversarial values, order, batching, geometry ---


def _wide_f32(rng, n, K, tiny_buckets=8):
    """f32 values spanning 2^-60 .. 2^60; buckets [0, tiny_buckets) hold
    only values below 2^-50."""
    keys = rng.integers(0, K, n).astype(np.int32)
    expo = rng.integers(-60, 61, n)
    expo = np.where(keys < tiny_buckets, rng.integers(-60, -50, n), expo)
    v = (rng.standard_normal(n) * np.exp2(expo.astype(np.float64))).astype(np.float32)
    return keys, v


def _within(got, ref, keys, valid, v, K):
    absum = np.bincount(keys[valid], weights=np.abs(v[valid].astype(np.float64)), minlength=K)
    np.testing.assert_array_less(
        np.abs(got.astype(np.float64) - np.asarray(ref, np.float64)), FLOAT_REL * absum + 1e-300)


def _plain1(keys, vals, valid, K):
    """The port on one partition (CPU: the plain version)."""
    sums, cnt = bucket_sum_count(
        torch.from_numpy(keys)[None], [torch.from_numpy(v)[None] for v in vals],
        torch.from_numpy(valid)[None], K)
    return [s[0].numpy() for s in sums], cnt[0].numpy()


@pytest.mark.parametrize("K", [1, 64, 300])
@pytest.mark.parametrize("ref", ["interpret", "scatter", "float64"])
def test_fixed_point_sums_of_wide_values_stay_within_bound(rng, K, ref):
    """Values over 2^-60 .. 2^60, with buckets that hold only tiny ones:
    the fixed-point sum stays within 2^-15 * sum|v| of the reference's
    interpret-mode kernel, of its scatter strategy and of float64."""
    n = 2001
    keys, v = _wide_f32(rng, n, K, tiny_buckets=min(K, 8) if K > 1 else 0)
    valid = rng.random(n) > 0.2
    (got,), cnt = _plain1(keys, [v], valid, K)
    if ref == "float64":
        want = np.bincount(keys[valid], weights=v[valid].astype(np.float64), minlength=K)
    else:
        kw = {"interpret": True} if ref == "interpret" else {"strategy": "scatter"}
        want = np.asarray(jax_bucket(keys, [v], valid, K, **kw)[0][0])
    _within(got, want, keys, valid, v, K)
    np.testing.assert_array_equal(cnt, np.bincount(keys[valid], minlength=K))


def test_nan_and_inf_per_bucket_match_the_reference_scatter(rng):
    """NaN, +Inf, -Inf and -0.0 rows: each bucket comes out as IEEE
    addition gives it, which is the reference's scatter strategy (its
    interpret-mode kernel multiplies 0 * inf and poisons every bucket)."""
    K, n = 16, 4000
    keys = rng.integers(0, K, n).astype(np.int32)
    v = rng.standard_normal(n).astype(np.float32)
    v[keys == 1] = -0.0  # only -0.0: +0.0, as 0.0 + -0.0
    v[np.flatnonzero(keys == 2)[:3]] = np.nan
    v[np.flatnonzero(keys == 3)[:2]] = np.inf
    v[np.flatnonzero(keys == 4)[:2]] = -np.inf
    k5 = np.flatnonzero(keys == 5)
    v[k5[:2]], v[k5[2:4]] = np.inf, -np.inf  # +Inf + -Inf: NaN
    v[np.flatnonzero(keys == 6)[:1]] = np.nan
    v[np.flatnonzero(keys == 6)[1:2]] = np.inf
    valid = np.ones(n, bool)
    valid[np.flatnonzero(keys == 7)[:1]] = False
    v[np.flatnonzero(keys == 7)[:1]] = np.nan  # a masked NaN is dropped
    (got,), _ = _plain1(keys, [v], valid, K)
    want = np.asarray(jax_bucket(keys, [v], valid, K, strategy="scatter")[0][0])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    inf = np.isinf(want)
    np.testing.assert_array_equal(np.sign(got[inf]), np.sign(want[inf]))
    assert got[1] == 0.0 and not np.signbit(got[1])
    assert np.isnan(got[[2, 5, 6]]).all() and got[3] == np.inf and got[4] == -np.inf
    fin = np.isfinite(want)
    finite_v = np.where(np.isfinite(v), v, 0).astype(np.float32)
    _within(np.where(fin, got, 0), np.where(fin, want, 0), keys, valid, finite_v, K)


@pytest.mark.parametrize("kinds", [("f32",), ("i32", "f32"), ()])
def test_row_order_within_a_partition_does_not_change_the_bytes(rng, kinds):
    """Every sum is an integer sum, so any permutation of a partition's
    rows gives the same bytes: the property the kernel's determinism
    rests on (its atomics land in any order)."""
    P, cap, K = 3, 1500, 97
    keys, valid, vals = _inputs(rng, P * cap, K, kinds)
    if kinds:
        keys_w, vals[-1] = _wide_f32(rng, P * cap, K)
    shaped = [x.reshape(P, cap) for x in (keys, valid, *vals)]
    base = bucket_sum_count_plain(*_as_torch(shaped), K)
    perm = np.stack([rng.permutation(cap) for _ in range(P)])
    permuted = [np.take_along_axis(x, perm, 1) for x in shaped]
    again = bucket_sum_count_plain(*_as_torch(permuted), K)
    _assert_same_bytes(base, again)


def _as_torch(shaped):
    keys, valid, *vals = shaped
    return (torch.from_numpy(np.ascontiguousarray(keys)),
            [torch.from_numpy(np.ascontiguousarray(v)) for v in vals],
            torch.from_numpy(np.ascontiguousarray(valid)))


def _assert_same_bytes(a, b):
    (sa, ca), (sb, cb) = a, b
    assert torch.equal(ca.view(torch.int32), cb.view(torch.int32))
    for x, y in zip(sa, sb):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_batched_call_equals_one_call_per_partition_byte_for_byte(rng):
    P, cap, K = 5, 800, 200
    keys, valid, vals = _inputs(rng, P * cap, K, ("i32", "f32"))
    _, vals[1] = _wide_f32(rng, P * cap, K)
    shaped = [x.reshape(P, cap) for x in (keys, valid, *vals)]
    sums, cnt = bucket_sum_count(*_as_torch(shaped), K)
    for p in range(P):
        one = bucket_sum_count(*_as_torch([x[p:p + 1] for x in shaped]), K)
        _assert_same_bytes(([s[p:p + 1] for s in sums], cnt[p:p + 1]), one)


@pytest.mark.parametrize("K", [1, 128, 5000, 65536, 131072, 1 << 20])
@pytest.mark.parametrize("n_int,n_float", [(0, 0), (1, 1), (0, 1), (3, 0), (2, 6), (0, 8)])
def test_launch_geometry_covers_the_buckets_within_the_card_limits(K, n_int, n_float):
    from dryad_tpu_torch.ops import bucket as BK

    P, cap = 8, 1 << 23
    for phase in (0, 1):
        if phase == 0 and n_float == 0:
            continue  # the exponent pass runs only for float columns
        g = BK.launch_geometry(P, cap, K, n_int, n_float, phase=phase)
        C, T = g.cluster, g.block_buckets
        assert 1 <= C <= BK.MAX_CLUSTER and C & (C - 1) == 0
        assert g.smem_bytes <= BK.SMEM_LIMIT
        assert g.smem_bytes == g.list_bytes + T * BK.bucket_bytes(n_int, n_float, phase)
        assert g.list_bytes == (g.threads // 32) * BK.LIST_ENTRIES * 4
        # blocks (range, rank) hold [range*C*T + rank*T, +T): [0, K) exactly once
        starts = np.arange(g.ranges * C) * T
        covered = np.zeros(g.ranges * C * T, np.int8)
        for s in starts:
            covered[s:s + T] += 1
        assert (covered[:K] == 1).all() and g.ranges * C * T - K < C * T
        # rows: chunks of whole 128-row groups cover [0, cap)
        assert g.chunk_rows % BK.CHUNK_ALIGN == 0
        assert (g.chunks - 1) * g.chunk_rows < cap <= g.chunks * g.chunk_rows
        assert g.chunks * g.ranges <= 65535 and 32 <= g.threads <= 1024
    g = BK.launch_geometry(P, cap, K, n_int, n_float)
    if K in (65536, 131072) and n_int + n_float <= 2:
        assert g.cluster > 1  # the main path's shapes are held by a cluster


@pytest.mark.parametrize("per_row,rows", [(1 << 10, 1 << 14), ((1 << 24) // 7, 7),
                                          ((1 << 24) // 7 + 1, 7), (2**31 - 1, 40)])
def test_int32_sums_exact_to_2_24_and_rounded_once_above(rng, per_row, rows):
    """int32 columns accumulate in int64 and round once: totals up to
    2^24 are exact, larger ones are the nearest f32 of the exact total
    (an f32 running sum would round at every step)."""
    keys = np.zeros(rows + 3, np.int32)
    keys[-3:] = 1
    w = np.full(rows + 3, per_row, np.int32)
    w[-3:] = [3, -(2**31), 5]
    valid = np.ones(rows + 3, bool)
    (got,), _ = _plain1(keys, [w], valid, 2)
    total = per_row * rows
    assert total < 2**53  # float64 holds it exactly, so float32() rounds once
    assert got[0] == np.float32(float(total))
    assert got[1] == np.float32(3 - 2**31 + 5)
    if total <= 1 << 24:
        assert int(got[0]) == total


def test_more_rows_than_the_fixed_point_bound_raise():
    k = torch.empty((1, (1 << 24) + 16), dtype=torch.int32)
    m = torch.zeros((1, (1 << 24) + 16), dtype=torch.bool)
    with pytest.raises(ValueError):
        bucket_sum_count(k, [], m, 8)
