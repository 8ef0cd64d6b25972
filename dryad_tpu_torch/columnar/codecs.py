"""User-type codecs — the custom-serializer hook (a copy of
``dryad_tpu/columnar/codecs.py``).

The reference lets a user type define its own record serialization
(``IDryadLinqSerializer<T>``, ``DryadLinqSerialization.cs:41``) and
auto-generates serializers for composite types.  Device columns are
fixed-width here, so the TPU-native form of "custom serializer" is a
**codec**: how one logical host column of arbitrary Python objects
expands into typed device columns at ingest, and how those columns fold
back into objects at egress.

A codec declares ``fields()`` (suffix -> ColumnType) and implements
``encode`` (object array -> suffix-keyed typed arrays) / ``decode``
(the inverse).  Ingest expands column ``c`` into ``c.<suffix>`` columns;
egress re-packs when every suffix column survived the query (renaming
or dropping any of them leaves the raw columns in the result).

Built-ins: ``ComplexCodec`` (re/im float32), ``DatetimeCodec``
(microseconds since epoch, INT64), ``PairCodec`` (2-tuples of numbers).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from dryad_tpu_torch.columnar.schema import ColumnType


class TypeCodec:
    def fields(self) -> List[Tuple[str, ColumnType]]:
        """(suffix, ColumnType) per generated column."""
        raise NotImplementedError

    def encode(self, values: np.ndarray) -> Dict[str, np.ndarray]:
        """Object array -> {suffix: typed array} (all same length)."""
        raise NotImplementedError

    def decode(self, cols: Dict[str, np.ndarray]) -> np.ndarray:
        """{suffix: typed array} -> object array."""
        raise NotImplementedError


def expanded_name(col: str, suffix: str) -> str:
    return f"{col}.{suffix}"


class ComplexCodec(TypeCodec):
    """complex -> (re, im) float32 columns."""

    def fields(self):
        return [("re", ColumnType.FLOAT32), ("im", ColumnType.FLOAT32)]

    def encode(self, values):
        a = np.asarray(values, np.complex64)
        return {"re": a.real.astype(np.float32), "im": a.imag.astype(np.float32)}

    def decode(self, cols):
        return (
            cols["re"].astype(np.float32)
            + 1j * cols["im"].astype(np.float32)
        ).astype(np.complex64)


class DatetimeCodec(TypeCodec):
    """numpy datetime64 -> INT64 microseconds since epoch."""

    def fields(self):
        return [("us", ColumnType.INT64)]

    def encode(self, values):
        a = np.asarray(values, "datetime64[us]")
        return {"us": a.astype(np.int64)}

    def decode(self, cols):
        return cols["us"].astype(np.int64).astype("datetime64[us]")


class PairCodec(TypeCodec):
    """2-tuples of numbers -> two float32 columns (a composite-type
    auto-serializer example, reference ``DryadLinqSerialization.cs``
    Pair/Tuple serializers)."""

    def fields(self):
        return [("a", ColumnType.FLOAT32), ("b", ColumnType.FLOAT32)]

    def encode(self, values):
        a = np.array([v[0] for v in values], np.float32)
        b = np.array([v[1] for v in values], np.float32)
        return {"a": a, "b": b}

    def decode(self, cols):
        out = np.empty(len(cols["a"]), object)
        for i, (x, y) in enumerate(zip(cols["a"], cols["b"])):
            out[i] = (float(x), float(y))
        return out


def expand_arrays(
    arrays: Dict[str, np.ndarray], codecs: Dict[str, TypeCodec]
) -> Dict[str, np.ndarray]:
    """Apply codecs at ingest: replace each coded column with its
    expanded typed columns."""
    out: Dict[str, np.ndarray] = {}
    for name, arr in arrays.items():
        codec = codecs.get(name)
        if codec is None:
            out[name] = arr
            continue
        enc = codec.encode(np.asarray(arr, object))
        declared = {s for s, _t in codec.fields()}
        if set(enc) != declared:
            raise ValueError(
                f"codec for {name!r} produced {sorted(enc)} but declared "
                f"{sorted(declared)}"
            )
        for suffix, col in enc.items():
            out[expanded_name(name, suffix)] = col
    return out


def collapse_table(
    table: Dict[str, np.ndarray], codecs: Dict[str, TypeCodec]
) -> Dict[str, np.ndarray]:
    """Apply codecs at egress: fold suffix columns back into object
    columns where the full set survived."""
    out = dict(table)
    for name, codec in codecs.items():
        suffixes = [s for s, _t in codec.fields()]
        names = [expanded_name(name, s) for s in suffixes]
        if not all(n in out for n in names):
            continue
        packed = codec.decode(
            {s: out[n] for s, n in zip(suffixes, names)}
        )
        for n in names:
            del out[n]
        out[name] = packed
    return out
