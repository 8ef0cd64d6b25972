"""The port's tokenizer (dryad_tpu_torch/runtime/bindings.py) against the
reference's: identical words, Hash64 words, prefix ranks, offsets and
lengths, for the Python twin and the native library alike.  Exact
comparison: tokenizing is integer work."""

import numpy as np
import pytest

from dryad_tpu.runtime import bindings as JB
from dryad_tpu_torch.runtime import bindings as TB

TEXTS = [
    b"",
    b"   \t\n",
    b"hello world",
    b"  the cat\tsat\non the\r\nmat \x0bx\x0cy  ",
    "café naïve 日本語 abcdefghij a ab abc abcd".encode(),
    b"trailing-no-newline",
]


def _random_text(seed):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(33, 127, rng.integers(1, 12)).astype(np.uint8)) for _ in range(200)]
    seps = [b" ", b"\n", b"\t", b"  ", b"\r\n"]
    return b"".join(words[i] + seps[i % len(seps)] for i in range(len(words)))


@pytest.mark.parametrize("text", TEXTS + [_random_text(0), _random_text(1)])
def test_python_twin_matches_reference(text):
    ref = JB.tokenize(text)  # the reference's native library (or its twin)
    got = TB.tokenize_python(text)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(g))
        assert np.asarray(r).dtype == np.asarray(g).dtype


@pytest.mark.parametrize("text", TEXTS + [_random_text(2)])
def test_native_matches_python_twin(text):
    if not TB.native_loaded():
        pytest.skip("no C++ compiler: the native tokenizer cannot be built")
    for n, p in zip(TB.tokenize(text), TB.tokenize_python(text)):
        np.testing.assert_array_equal(n, p)
        assert n.dtype == p.dtype


def test_hash64_matches_reference():
    for s in TEXTS:
        assert TB.hash64(s) == JB.hash64(s)
