"""ctypes bindings for the port's host tokenizer and host I/O, each
with a Python twin.

The counterpart of ``dryad_tpu/runtime/bindings.py``: ``tokenize``,
``hash64``, ``decompress_batch``, ``write_partition``, ``Fifo``,
``PrefetchChannel``, ``tlv_encode`` and ``tlv_decode``.  Two libraries are built at first use by
:mod:`dryad_tpu_torch.utils.build`: the tokenizer from
``runtime/native/dryadtok.cpp`` and the I/O routines from
``runtime/native/dryadio.cpp`` (linked with zlib).  Where one cannot be
built its Python twin (identical semantics and bytes, slower) runs
instead; :func:`native_loaded` and :func:`io_native_loaded` say which
is in use.
"""

from __future__ import annotations

import ctypes
import logging
import struct
import threading
from typing import List, Optional, Tuple

import numpy as np

from dryad_tpu_torch.columnar.schema import hash64_bytes, string_prefix_rank
from dryad_tpu_torch.utils import build as B

log = logging.getLogger("dryad_tpu_torch.runtime")

SOURCES = ("runtime/native/dryadtok.cpp",)
LIB_NAME = "dryadtok"
IO_SOURCES = ("runtime/native/dryadio.cpp",)
IO_LIB_NAME = "dryadio"
IO_LIBS = ("-pthread", "-lz")

_lib = None
_lib_tried = False
_io_lib = None
_io_lib_tried = False
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


# -- host I/O -------------------------------------------------------------------

def _load_io() -> Optional[ctypes.CDLL]:
    global _io_lib, _io_lib_tried
    with _lock:
        if _io_lib is not None or _io_lib_tried:
            return _io_lib
        _io_lib_tried = True
        try:
            lib = ctypes.CDLL(B.build(IO_LIB_NAME, IO_SOURCES, cuda=False, libs=IO_LIBS))
        except (B.BuildError, OSError) as e:
            log.warning("native I/O unavailable (%s); using the Python twins", e)
            return None
        vp, u64, u8pp = ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
        lib.dn_decompress_batch.restype = ctypes.c_int32
        lib.dn_decompress_batch.argtypes = [
            ctypes.c_size_t, ctypes.POINTER(vp), ctypes.POINTER(u64),
            ctypes.POINTER(vp), ctypes.POINTER(u64),
        ]
        lib.dn_channel_open.restype = vp
        lib.dn_channel_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t,
        ]
        lib.dn_channel_next.restype = ctypes.c_int64
        lib.dn_channel_next.argtypes = [vp, u8pp]
        lib.dn_channel_close.restype = None
        lib.dn_channel_close.argtypes = [vp]
        lib.dn_write_partition.restype = ctypes.c_int32
        lib.dn_write_partition.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(vp), ctypes.POINTER(u64), u64, ctypes.c_int32,
        ]
        lib.dn_fifo_create.restype = vp
        lib.dn_fifo_create.argtypes = [ctypes.c_size_t]
        lib.dn_fifo_push.restype = ctypes.c_int32
        lib.dn_fifo_push.argtypes = [vp, ctypes.c_char_p, ctypes.c_size_t]
        lib.dn_fifo_pop.restype = ctypes.c_int64
        lib.dn_fifo_pop.argtypes = [vp, u8pp]
        lib.dn_fifo_close.restype = None
        lib.dn_fifo_close.argtypes = [vp]
        lib.dn_fifo_destroy.restype = None
        lib.dn_fifo_destroy.argtypes = [vp]
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.dn_tlv_encoded_size.restype = ctypes.c_size_t
        lib.dn_tlv_encoded_size.argtypes = [ctypes.c_size_t, u32p]
        lib.dn_tlv_encode.restype = ctypes.c_size_t
        lib.dn_tlv_encode.argtypes = [
            ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(vp), u32p,
            ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.dn_tlv_decode.restype = ctypes.c_size_t
        lib.dn_tlv_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(u64), u32p,
        ]
        _io_lib = lib
        return _io_lib


def io_native_loaded() -> bool:
    """True when the compiled I/O routines (not the Python twins) are in use."""
    return _load_io() is not None


def decompress_batch(srcs, dsts) -> bool:
    """Inflate each zlib payload in ``srcs`` into the matching writable
    numpy array in ``dsts``, all columns in parallel on native threads.
    Returns False when the native library is unavailable (the caller
    inflates with :mod:`zlib`)."""
    lib = _load_io()
    if lib is None or not srcs:
        return False
    n = len(srcs)
    src_ptrs = (ctypes.c_void_p * n)()
    src_lens = (ctypes.c_uint64 * n)()
    dst_ptrs = (ctypes.c_void_p * n)()
    dst_lens = (ctypes.c_uint64 * n)()
    for i, (s, d) in enumerate(zip(srcs, dsts)):
        # points at the bytes object's buffer (no copy); the caller keeps
        # ``srcs`` referenced for the duration of the call
        src_ptrs[i] = ctypes.cast(ctypes.c_char_p(s), ctypes.c_void_p)
        src_lens[i] = len(s)
        dst_ptrs[i] = d.ctypes.data_as(ctypes.c_void_p)
        dst_lens[i] = d.nbytes
    if lib.dn_decompress_batch(n, src_ptrs, src_lens, dst_ptrs, dst_lens) != 0:
        raise ValueError("corrupt compressed column payload")
    return True


def write_partition(path: str, cols: "dict[str, np.ndarray]", compression: Optional[str] = None) -> None:
    """Write one ``.dpf`` partition file (format: ``columnar/io.py``),
    columns compressed concurrently on native threads; the Python
    writer where the library is unavailable (the same bytes)."""
    lib = _load_io()
    if lib is None:
        from dryad_tpu_torch.columnar import io as cio

        cio.write_partition_file(path, cols, compression)
        return
    names = list(cols.keys())
    arrays = [np.ascontiguousarray(cols[n]) for n in names]
    rows = len(arrays[0]) if arrays else 0
    name_arr = (ctypes.c_char_p * len(names))(*[n.encode() for n in names])
    dt_arr = (ctypes.c_char_p * len(names))(*[str(a.dtype).encode() for a in arrays])
    buf_arr = (ctypes.c_void_p * len(names))(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrays]
    )
    len_arr = (ctypes.c_uint64 * len(names))(*[a.nbytes for a in arrays])
    level = 6 if (compression or "none") == "zlib" else -1
    rc = lib.dn_write_partition(
        path.encode(), len(names), name_arr, dt_arr, buf_arr, len_arr, rows, level,
    )
    if rc != 0:
        raise IOError(f"native partition write failed rc={rc} path={path}")


class Fifo:
    """Bounded blocking byte-block queue (the reference's ``Fifo``):
    ``push`` blocks while full and returns False once closed; ``pop``
    blocks until a block or close, then returns None at end of stream
    (repeatably); ``close`` never blocks.  Native or Python, the same
    semantics."""

    def __init__(self, depth: int = 4):
        self._lib = _load_io()
        # a native pop hands out a pointer into a buffer owned by the
        # queue, valid until the next pop: pop and copy under one lock
        self._pop_lock = threading.Lock()
        if self._lib is not None:
            self._handle = self._lib.dn_fifo_create(depth)
        else:
            self._handle = None
            self._depth = max(1, depth)
            self._deque: List[bytes] = []
            self._closed = False
            self._cv = threading.Condition()

    def push(self, data: bytes) -> bool:
        if self._handle is not None:
            return self._lib.dn_fifo_push(self._handle, data, len(data)) == 0
        with self._cv:
            while not self._closed and len(self._deque) >= self._depth:
                self._cv.wait()
            if self._closed:
                return False
            self._deque.append(data)
            self._cv.notify_all()
            return True

    def pop(self) -> Optional[bytes]:
        """Next block, or None at end of stream (closed and drained)."""
        if self._handle is not None:
            with self._pop_lock:
                ptr = ctypes.POINTER(ctypes.c_uint8)()
                n = self._lib.dn_fifo_pop(self._handle, ctypes.byref(ptr))
                return None if n < 0 else ctypes.string_at(ptr, n)
        with self._cv:
            while not self._closed and not self._deque:
                self._cv.wait()
            if not self._deque:
                return None
            item = self._deque.pop(0)
            self._cv.notify_all()
            return item

    def close(self) -> None:
        if self._handle is not None:
            self._lib.dn_fifo_close(self._handle)
            return
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def destroy(self) -> None:
        if self._handle is not None:
            self._lib.dn_fifo_destroy(self._handle)
            self._handle = None


class PrefetchChannel:
    """Ordered multi-file reader with background prefetch: iterate for
    each file's bytes in order (native threads read ahead up to
    ``depth`` files; the Python twin reads them one by one)."""

    def __init__(self, paths: List[str], depth: int = 4, threads: int = 2):
        self.paths = list(paths)
        self._lib = _load_io()
        self._handle = None
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
            self._handle = self._lib.dn_channel_open(arr, len(self.paths), depth, threads)

    def __iter__(self):
        if self._handle is None:
            for p in self.paths:
                with open(p, "rb") as fh:
                    yield fh.read()
            return
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        while True:
            n = self._lib.dn_channel_next(self._handle, ctypes.byref(ptr))
            if n == -1:
                break
            if n == -2:
                raise IOError("native channel read error")
            yield ctypes.string_at(ptr, n)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.dn_channel_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def tlv_encode(entries: List[Tuple[int, bytes]]) -> bytes:
    """Encode (tag, value) pairs as the TLV property wire format (the
    reference's property blocks): tag u16 LE + len u32 LE + value."""
    for tag, val in entries:
        if not 0 <= tag <= 0xFFFF:
            raise ValueError(f"TLV tag {tag} outside u16 range")
        if len(val) > 0xFFFFFFFF:
            raise ValueError("TLV value exceeds u32 length")
    lib = _load_io()
    if lib is not None and entries:
        vals = [bytes(v) for _, v in entries]
        tags = (ctypes.c_uint16 * len(entries))(*[t for t, _ in entries])
        lens = (ctypes.c_uint32 * len(vals))(*[len(v) for v in vals])
        ptrs = (ctypes.c_void_p * len(vals))(
            *[ctypes.cast(ctypes.c_char_p(v), ctypes.c_void_p).value for v in vals]
        )
        size = lib.dn_tlv_encoded_size(len(vals), lens)
        out = ctypes.create_string_buffer(size)
        if lib.dn_tlv_encode(len(vals), tags, ptrs, lens, out, size) != size:
            raise ValueError("tlv encode overflow")
        return out.raw
    return b"".join(struct.pack("<HI", tag, len(val)) + bytes(val) for tag, val in entries)


def tlv_decode(buf: bytes) -> List[Tuple[int, bytes]]:
    """Decode a TLV property block; raises ValueError on malformed input."""
    lib = _load_io()
    if lib is not None and buf:
        max_n = max(1, len(buf) // 6)
        tags = (ctypes.c_uint16 * max_n)()
        offs = (ctypes.c_uint64 * max_n)()
        lens = (ctypes.c_uint32 * max_n)()
        n = lib.dn_tlv_decode(buf, len(buf), max_n, tags, offs, lens)
        if n == ctypes.c_size_t(-1).value:
            raise ValueError("malformed TLV block")
        return [(int(tags[i]), buf[offs[i] : offs[i] + lens[i]]) for i in range(n)]
    out = []
    at = 0
    while at < len(buf):
        if at + 6 > len(buf):
            raise ValueError("malformed TLV block")
        tag, ln = struct.unpack_from("<HI", buf, at)
        if at + 6 + ln > len(buf):
            raise ValueError("malformed TLV block")
        out.append((tag, buf[at + 6 : at + 6 + ln]))
        at += 6 + ln
    return out
