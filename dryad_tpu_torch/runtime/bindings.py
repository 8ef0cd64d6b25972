"""ctypes bindings for the port's host tokenizer, with a Python twin.

The counterpart of ``dryad_tpu/runtime/bindings.py`` for ``tokenize``
and ``hash64`` only.  The library is built at first use from
``runtime/native/dryadtok.cpp`` by :mod:`dryad_tpu_torch.utils.build`.
Where no C++ compiler exists the Python twin (identical semantics, far
slower) runs instead; :func:`native_loaded` says which one is in use.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from typing import Optional, Tuple

import numpy as np

from dryad_tpu_torch.columnar.schema import hash64_bytes, string_prefix_rank
from dryad_tpu_torch.utils import build as B

log = logging.getLogger("dryad_tpu_torch.runtime")

SOURCES = ("runtime/native/dryadtok.cpp",)
LIB_NAME = "dryadtok"

_lib = None
_lib_tried = False
_lock = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    with _lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        try:
            lib = ctypes.CDLL(B.build(LIB_NAME, SOURCES, cuda=False))
        except (B.BuildError, OSError) as e:
            log.warning("native tokenizer unavailable (%s); using the Python twin", e)
            return None
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.dn_hash64.restype = ctypes.c_uint64
        lib.dn_hash64.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.dn_token_count.restype = ctypes.c_size_t
        lib.dn_token_count.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.dn_tokenize.restype = ctypes.c_size_t
        lib.dn_tokenize.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            u32p, u32p, u32p, u32p,
            ctypes.POINTER(ctypes.c_uint64), u32p,
        ]
        _lib = lib
        return _lib


def native_loaded() -> bool:
    """True when the compiled tokenizer (not the Python twin) is in use."""
    return _load() is not None


def hash64(data: bytes) -> int:
    lib = _load()
    if lib is not None:
        return int(lib.dn_hash64(data, len(data)))
    return hash64_bytes(data)


Tokens = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def tokenize(text: bytes) -> Tokens:
    """Whitespace-tokenize a byte buffer into columnar token arrays:
    ``(h0, h1, r0, r1, starts, lens)`` — Hash64 word pairs, 8-byte
    prefix rank words, byte offsets and lengths."""
    lib = _load()
    if lib is None:
        return tokenize_python(text)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    n = lib.dn_token_count(text, len(text))
    h0, h1, r0, r1, lens = (np.empty(n, np.uint32) for _ in range(5))
    starts = np.empty(n, np.uint64)
    got = lib.dn_tokenize(
        text, len(text), n,
        h0.ctypes.data_as(u32p), h1.ctypes.data_as(u32p),
        r0.ctypes.data_as(u32p), r1.ctypes.data_as(u32p),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        lens.ctypes.data_as(u32p),
    )
    if got != n:
        raise RuntimeError(f"native tokenizer wrote {got} of {n} tokens")
    return h0, h1, r0, r1, starts, lens


def tokenize_python(text: bytes) -> Tokens:
    """The Python twin of the native tokenizer (the reference's own
    fallback, ``dryad_tpu/runtime/bindings.py``)."""
    tokens = []
    starts_l = []
    i = 0
    while i < len(text):
        while i < len(text) and text[i : i + 1].isspace():
            i += 1
        if i >= len(text):
            break
        s = i
        while i < len(text) and not text[i : i + 1].isspace():
            i += 1
        tokens.append(text[s:i])
        starts_l.append(s)
    hashes = np.array([hash64_bytes(t) for t in tokens], np.uint64)
    h0 = (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    h1 = (hashes >> np.uint64(32)).astype(np.uint32)
    sarr = np.array([t.decode("utf-8", "replace") for t in tokens], object)
    r0 = string_prefix_rank(sarr)
    r1 = string_prefix_rank(sarr, offset=4)
    return (
        h0, h1, r0, r1,
        np.array(starts_l, np.uint64),
        np.array([len(t) for t in tokens], np.uint32),
    )
