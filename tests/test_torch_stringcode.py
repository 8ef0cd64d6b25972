"""String coding of the port (dryad_tpu_torch/ops/stringcode.py) against
the reference: identical dictionaries, slot arrays, codes (hits and
misses) and decode slices, including the clamped slice start.  Exact
comparison throughout (all integer work)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dryad_tpu.columnar.schema import StringDictionary as JDict
from dryad_tpu.ops import stringcode as JC
from dryad_tpu_torch import interop
from dryad_tpu_torch.columnar.batch import to_device_column, to_host_column
from dryad_tpu_torch.columnar.schema import StringDictionary as TDict, split64
from dryad_tpu_torch.exec.operands import DeviceTables
from dryad_tpu_torch.ops import stringcode as TC


def _dicts(rng, n):
    words = [f"w{i}_{int(x)}" for i, x in enumerate(rng.integers(0, 10**9, n))]
    words += ["é", "日本", "a"]
    jd, td = JDict(), TDict()
    for w in words:
        assert jd.add(w) == td.add(w)
    return jd, td


@pytest.mark.parametrize("n", [1, 3, 100, 700])
def test_tables_identical(rng, n):
    jd, td = _dicts(rng, n)
    assert jd.items() == td.items()
    jc, jdec = JC.build_tables(jd)
    tc, tdec = TC.build_tables(td)
    for attr in ("num_slots", "num_codes", "num_codes_padded", "max_probe", "probe_bound"):
        assert getattr(jc, attr) == getattr(tc, attr)
    for a in ("slots_h0", "slots_h1", "slots_code"):
        np.testing.assert_array_equal(getattr(jc, a), getattr(tc, a))
    np.testing.assert_array_equal(jdec.words_padded, tdec.words_padded)
    assert jc.operand_sha() == tc.operand_sha()
    # the interop rebuild from the reference's raw arrays agrees too
    ic = interop.code_table_from_slots(jc.slots_h0, jc.slots_h1, jc.slots_code)
    assert ic == tc
    assert interop.decode_table_from_words(jdec.words) == tdec
    assert interop.dictionary_from_items(jd.items()).items() == td.items()


def test_subset_tables_identical(rng):
    jd, td = _dicts(rng, 300)
    hashes = np.array([h for h, _ in jd.items()][::3], np.uint64)
    jc, jdec = JC.build_tables_subset(jd, hashes)
    tc, tdec = TC.build_tables_subset(td, hashes)
    np.testing.assert_array_equal(jc.slots_code, tc.slots_code)
    np.testing.assert_array_equal(jdec.words, tdec.words)


def test_lookup_codes_hits_and_misses(rng):
    jd, td = _dicts(rng, 500)
    jc, _ = JC.build_tables(jd)
    tc, _ = TC.build_tables(td)
    known = np.array([h for h, _ in jd.items()], np.uint64)
    fake = rng.integers(0, 2**63, 200, dtype=np.int64).astype(np.uint64)
    probe = np.concatenate([rng.choice(known, 300), fake])
    h0, h1 = split64(probe)
    ref = np.asarray(jc.lookup(jnp.asarray(h0), jnp.asarray(h1)))
    tables = DeviceTables("cpu")
    got = tc.lookup(
        to_device_column(h0.reshape(2, -1), "cpu"),
        to_device_column(h1.reshape(2, -1), "cpu"),
        operands=tables.get(tc),
    )
    np.testing.assert_array_equal(got.numpy().reshape(-1), ref)
    assert (ref[300:] == jc.num_codes_padded).all()
    tables.get(tc)
    assert tables.uploads == 1


def test_mul32_wraps_like_uint32():
    a = np.array([0, 1, 2**32 - 1, 2**31, 123456789], np.uint32)
    ref = (a * np.uint32(0x9E3779B9)).astype(np.uint32)
    got = to_host_column(TC.mul32(to_device_column(a, "cpu"), 0x9E3779B9))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("count", [1, 3, 8])
def test_decode_slices_with_clamped_start(rng, count):
    jd, td = _dicts(rng, 5)  # K = 8 codes -> padded buffer of 16 rows
    _, jdec = JC.build_tables(jd)
    _, tdec = TC.build_tables(td)
    R = jdec.words_padded.shape[0]
    starts = [0, 2, R - count, R - count + 1, R + 5]  # the last two clamp
    got = tdec.slice_rows(
        torch.tensor(starts).reshape(-1, 1), count,
        operands=DeviceTables("cpu").get(tdec),
    )
    for i, s in enumerate(starts):
        ref = np.asarray(jdec.slice_rows(jnp.int32(s), count))
        np.testing.assert_array_equal(to_host_column(got[i]), ref)
