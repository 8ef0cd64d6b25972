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
