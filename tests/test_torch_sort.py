"""Order-preserving sort words and stable multi-key sorting of the port
(dryad_tpu_torch/ops/sortkeys.py, ops/sort.py) against the reference's
``to_sortable_u32`` and ``lax.sort``-based ``sort_carry``.  Exact
comparison: the words and permutations are integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dryad_tpu.ops import sort as JS
from dryad_tpu.ops import sortkeys as JK
from dryad_tpu_torch.columnar.batch import to_device_column, to_host_column
from dryad_tpu_torch.ops import sort as TS
from dryad_tpu_torch.ops import sortkeys as TK

INTS = np.array([0, 1, -1, 2**31 - 1, -2**31, 17, -17, 5, 5, -5], np.int32)
FLOATS = np.array(
    [0.0, -0.0, 1.5, -1.5, np.inf, -np.inf, 1e-45, -1e-45, 3.4e38, -3.4e38, 2.0, 2.0],
    np.float32,
)
UINTS = np.array([0, 1, 2**31, 2**32 - 1, 12345], np.uint32)


def _torch_col(a):
    return to_device_column(a, "cpu")


@pytest.mark.parametrize("values", [INTS, FLOATS, UINTS, np.array([True, False, True])])
@pytest.mark.parametrize("descending", [False, True])
def test_sortable_words_bit_identical(values, descending):
    ref = np.asarray(JK.to_sortable_u32(jnp.asarray(values), descending))
    got = to_host_column(TK.to_sortable_u32(_torch_col(values), descending))
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.uint32


def test_negative_zero_sorts_before_positive_zero():
    w = TK.to_sortable_u32(torch.tensor([0.0, -0.0]))
    assert int(w[1]) < int(w[0])


@pytest.mark.parametrize("n_ops", [1, 2, 3, 5])
def test_stable_multikey_sort_matches_lax_sort(rng, n_ops):
    P, n = 4, 64
    # few distinct values -> many ties; the row order must break them
    ops = [rng.integers(0, 3, (P, n)).astype(np.uint32) for _ in range(n_ops)]
    ops[0][:, :5] = np.uint32(2**32 - 1)  # high-bit words
    valid = rng.random((P, n)) > 0.3
    payload = np.arange(P * n, dtype=np.int32).reshape(P, n)
    t_valid, t_ops, (t_pay,) = TS.sort_carry(
        [_torch_col(o) for o in ops], torch.from_numpy(valid), [torch.from_numpy(payload)]
    )
    for p in range(P):
        j_valid, j_ops, (j_pay,) = JS.sort_carry(
            [jnp.asarray(o[p]) for o in ops], jnp.asarray(valid[p]),
            [jnp.asarray(payload[p])],
        )
        np.testing.assert_array_equal(t_valid[p].numpy(), np.asarray(j_valid))
        np.testing.assert_array_equal(t_pay[p].numpy(), np.asarray(j_pay))
        for t, j in zip(t_ops, j_ops):
            np.testing.assert_array_equal(to_host_column(t[p]), np.asarray(j))


def test_sort_order_descending_keys_with_ties_matches_reference(rng):
    n = 50
    a = rng.integers(-3, 3, n).astype(np.int32)
    b = rng.choice(FLOATS, n).astype(np.float32)
    valid = rng.random(n) > 0.2
    ref = np.asarray(JK.sort_order(
        [jnp.asarray(a), jnp.asarray(b)], jnp.asarray(valid), [True, False]
    ))
    got = TK.sort_order(
        [torch.from_numpy(a), torch.from_numpy(b)], torch.from_numpy(valid), [True, False]
    )
    np.testing.assert_array_equal(got.numpy(), ref)


def test_lexi_less_and_adjacent_equality_match_reference(rng):
    a = [rng.integers(-2, 2, 200).astype(np.int32), rng.choice(FLOATS, 200)]
    b = [rng.integers(-2, 2, 200).astype(np.int32), rng.choice(FLOATS, 200)]
    ref = np.asarray(JK.lexi_less([jnp.asarray(x) for x in a], [jnp.asarray(x) for x in b]))
    got = TK.lexi_less([torch.from_numpy(x) for x in a], [torch.from_numpy(x) for x in b])
    np.testing.assert_array_equal(got.numpy(), ref)
    srt = [np.sort(a[0]), np.sort(a[1])]
    ref = np.asarray(JK.keys_equal_adjacent([jnp.asarray(x) for x in srt]))
    got = TK.keys_equal_adjacent([torch.from_numpy(x) for x in srt])
    np.testing.assert_array_equal(got.numpy(), ref)
