"""Schema / type system for columnar batches.

A verbatim copy of ``dryad_tpu/columnar/schema.py`` (numpy only): the
port may not import the JAX package, and these semantics (Hash64, prefix
ranks, split words) decide byte-identity with it, so they must not drift.

The reference ships a row-oriented binary record format with per-type
(de)serializers (``LinqToDryad/DryadLinqBinaryReader.cs``,
``DryadLinqSerialization.cs``).  The TPU-native design is columnar
(struct-of-arrays in HBM): a ``Schema`` is an ordered list of named,
typed columns; records are rows across those columns.

Strings cannot live on a TPU, so STRING columns are dictionary-encoded at
ingest: each string becomes a 64-bit hash carried as TWO uint32 device
columns (``name#h0``/``name#h1`` — avoids requiring jax x64 mode), with a
host-side :class:`StringDictionary` mapping hashes back to strings at
egress.  This follows the reference's own precedent of hashing record
keys with a deterministic 64-bit hash (``LinqToDryad/Hash64.cs``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class ColumnType(enum.Enum):
    INT32 = "int32"
    INT64 = "int64"  # stored on device as two uint32 words (#h0 low, #h1 high)
    FLOAT32 = "float32"
    # Stored on device as the ORDER-PRESERVING signed-int64 image of the
    # IEEE-754 bits (two uint32 words): exact round-trip, and every
    # int64 comparison/sort/min/max kernel applies unchanged.  No f64
    # arithmetic on device (x64 stays off): sum/mean are rejected with
    # a cast-to-f32 suggestion.
    FLOAT64 = "float64"
    BOOL = "bool"
    UINT32 = "uint32"
    STRING = "string"  # dictionary-encoded: two uint32 hash words + host dict

    @property
    def is_split(self) -> bool:
        """True when the logical column maps to multiple uint32 device columns."""
        return self in (ColumnType.INT64, ColumnType.FLOAT64, ColumnType.STRING)

    @property
    def numpy_dtype(self) -> np.dtype:
        return {
            ColumnType.INT32: np.dtype(np.int32),
            ColumnType.INT64: np.dtype(np.int64),
            ColumnType.FLOAT32: np.dtype(np.float32),
            ColumnType.FLOAT64: np.dtype(np.float64),
            ColumnType.BOOL: np.dtype(np.bool_),
            ColumnType.UINT32: np.dtype(np.uint32),
            ColumnType.STRING: np.dtype(object),
        }[self]


def device_column_names(name: str, ctype: ColumnType) -> List[str]:
    """Physical device-column names backing one logical column.

    INT64  -> ``#h0`` (low word), ``#h1`` (high word).
    STRING -> ``#h0``/``#h1`` (Hash64 words, the identity) plus ``#r0``/``#r1``,
    an order-preserving uint32 rank of the first 4 UTF-8 bytes
    (big-endian), so range partitioning / OrderBy on strings is exact on
    4-byte prefixes with hash-order tie-breaking beyond that.
    """
    if ctype == ColumnType.STRING:
        return [f"{name}#h0", f"{name}#h1", f"{name}#r0", f"{name}#r1"]
    if ctype in (ColumnType.INT64, ColumnType.FLOAT64):
        return [f"{name}#h0", f"{name}#h1"]
    return [name]


def factorize_strings(a) -> Optional[Tuple[List[str], np.ndarray]]:
    """``(distinct values, int64 codes)`` of a column whose every value
    is exactly a ``str``, with ``values[codes[i]] == a[i]``; None for any
    other column.  One pass over the rows at C speed (a set, then a dict
    lookup per row), where a per-row encode would run Python for every
    row: what a few-thousand-key STRING column of 2^24 rows needs."""
    rows = np.asarray(a, object).ravel().tolist()
    try:
        distinct = set(rows)
    except TypeError:  # unhashable values
        return None
    if not all(type(v) is str for v in distinct):
        return None
    values = list(distinct)
    index = {v: i for i, v in enumerate(values)}
    codes = np.fromiter(map(index.__getitem__, rows), np.int64, len(rows))
    return values, codes


def unique_strings(a) -> np.ndarray:
    """``np.unique`` of an object column (sorted distinct values), the
    rows deduplicated by hashing first when every value is a ``str``
    (sorting 2^24 Python strings takes seconds; their set, a fraction)."""
    f = factorize_strings(a)
    if f is None:
        return np.unique(np.asarray(a, object))
    return np.unique(np.asarray(f[0], object))


def string_prefix_rank(strings: "np.ndarray", offset: int = 0) -> "np.ndarray":
    """uint32 big-endian rank of UTF-8 bytes [offset, offset+4) of each
    string — memcomparable prefix words (``#r0`` offset 0, ``#r1``
    offset 4: exact ordering for 8-byte prefixes, hash-order beyond)."""
    out = np.zeros(len(strings), np.uint32)
    for i, s in enumerate(strings):
        b = str(s).encode("utf-8")[offset : offset + 4]
        r = 0
        for j in range(4):
            r = (r << 8) | (b[j] if j < len(b) else 0)
        out[i] = r
    return out


FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def hash64_bytes(data: bytes) -> int:
    """Deterministic 64-bit FNV-1a hash.

    The framework-wide string hash, the analog of the reference's
    deterministic ``Hash64`` (``LinqToDryad/Hash64.cs``) used so every
    machine partitions identically.  Implemented identically in the
    native runtime (``runtime/native/dryadnative.cpp``).
    """
    h = FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * FNV_PRIME) & _MASK64
    return h


def hash64_str(s: str) -> int:
    return hash64_bytes(s.encode("utf-8"))


def split64(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split uint64/int64 array into (low, high) uint32 words."""
    v = values.astype(np.uint64)
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (v >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def join64(lo: np.ndarray, hi: np.ndarray, signed: bool = False) -> np.ndarray:
    v = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    return v.view(np.int64) if signed else v


_SIGN64 = np.uint64(1 << 63)


def f64_to_ordered_i64(values: np.ndarray) -> np.ndarray:
    """Order-preserving signed-int64 image of float64 values.

    The classic memcomparable-double transform (negatives: ~bits;
    non-negatives: bits | signbit) shifted into the signed domain
    (xor signbit), so signed-int64 comparisons order exactly like the
    doubles under IEEE-754 totalOrder semantics: -0.0 orders below
    +0.0, sign-negative NaNs below -inf, sign-positive NaNs above +inf
    (the documented engine semantic for float64 ordering).
    """
    bits = np.ascontiguousarray(values, np.float64).view(np.uint64)
    neg = (bits & _SIGN64) != 0
    t = np.where(neg, ~bits ^ _SIGN64, bits)
    return t.view(np.int64)


def ordered_i64_to_f64(vals: np.ndarray) -> np.ndarray:
    """Inverse of :func:`f64_to_ordered_i64`."""
    s = np.ascontiguousarray(vals, np.int64).view(np.uint64)
    neg = (s & _SIGN64) != 0  # negatives map to signed-negative images
    bits = np.where(neg, ~(s ^ _SIGN64), s)
    return bits.view(np.float64)


class StringDictionary:
    """Host-side hash -> string mapping for dictionary-encoded columns.

    Built at ingest, consulted only at egress (the reference keeps string
    payloads in channel bytes; we keep them on the host and ship hashes).
    """

    def __init__(self) -> None:
        self._map: Dict[int, str] = {}

    def __len__(self) -> int:
        return len(self._map)

    def add(self, s: str) -> int:
        h = hash64_str(s)
        existing = self._map.get(h)
        if existing is not None and existing != s:
            # 64-bit collision between distinct strings: astronomically
            # unlikely; surface loudly rather than silently merging keys.
            raise ValueError(f"hash64 collision: {existing!r} vs {s!r}")
        self._map[h] = s
        return h

    def add_all(self, strings: Iterable[str]) -> np.ndarray:
        return np.array([self.add(s) for s in strings], dtype=np.uint64)

    def lookup(self, h: int) -> str:
        return self._map[int(h)]

    def lookup_all(self, hashes: np.ndarray) -> List[str]:
        return [self._map[int(h)] for h in np.asarray(hashes).ravel()]

    def merge(self, other: "StringDictionary") -> "StringDictionary":
        out = StringDictionary()
        out._map.update(self._map)
        for h, s in other._map.items():
            if h in out._map and out._map[h] != s:
                raise ValueError(f"hash64 collision merging dictionaries: {s!r}")
            out._map[h] = s
        return out

    def items(self):
        # Snapshot: a streaming prefetch thread may register tokens
        # concurrently with a consumer iterating the dictionary (e.g.
        # build_tables during lowering) — a live view would raise
        # "dict changed size during iteration".
        return list(self._map.items())


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    ctype: ColumnType

    @property
    def device_names(self) -> List[str]:
        return device_column_names(self.name, self.ctype)


class Schema:
    """Ordered, named, typed columns of a dataset."""

    def __init__(self, fields: Sequence[Tuple[str, ColumnType]]):
        self.fields: List[Field] = [Field(n, t) for n, t in fields]
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names in schema: {names}")
        self._by_name = {f.name: f for f in self.fields}

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def field(self, name: str) -> Field:
        return self._by_name[name]

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Schema) and self.fields == other.fields

    def __repr__(self) -> str:
        cols = ", ".join(f"{f.name}:{f.ctype.value}" for f in self.fields)
        return f"Schema({cols})"

    def device_names(self) -> List[str]:
        out: List[str] = []
        for f in self.fields:
            out.extend(f.device_names)
        return out

    def with_field(self, name: str, ctype: ColumnType) -> "Schema":
        return Schema([(f.name, f.ctype) for f in self.fields] + [(name, ctype)])

    def select(self, names: Sequence[str]) -> "Schema":
        return Schema([(n, self._by_name[n].ctype) for n in names])
