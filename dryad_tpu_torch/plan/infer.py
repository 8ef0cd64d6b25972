"""Schema inference for user projection functions.

The counterpart of ``dryad_tpu/plan/infer.py``: where the reference
traces ``fn`` with ``jax.eval_shape``, the port calls it on a tiny
zero-filled CPU batch and reads the output dtypes.  Output columns are
taken in name order, as a traced dict comes back from JAX.  Physical names
``x#h0``/``x#h1``/``x#r0``/``x#r1`` are STRING, ``x#h0``/``x#h1`` pairs
INT64 (or the input's split type), everything else maps by dtype (the
int64 word carrier maps to UINT32).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from dryad_tpu_torch.columnar.batch import WORD
from dryad_tpu_torch.columnar.schema import ColumnType, Schema

_DEVICE_DTYPES = {
    ColumnType.INT32: torch.int32,
    ColumnType.FLOAT32: torch.float32,
    ColumnType.BOOL: torch.bool,
    ColumnType.UINT32: WORD,
}
_DTYPE_TO_TYPE = {v: k for k, v in _DEVICE_DTYPES.items()}


def dummy_cols(schema: Schema, n: int = 4) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for f in schema.fields:
        if f.ctype.is_split:
            for d in f.device_names:
                out[d] = torch.zeros((1, n), dtype=WORD)
        else:
            out[f.name] = torch.zeros((1, n), dtype=_DEVICE_DTYPES[f.ctype])
    return out


def infer_select_many_schema(schema: Schema, fn, factor: int) -> Schema:
    """``fn`` maps ``(n,)`` columns to ``(n, factor)`` columns and
    validity (the flat-map contract)."""
    cols = {k: v.reshape(-1) for k, v in dummy_cols(schema).items()}
    out_cols, _valid = fn(cols)
    flat = {n: out_cols[n].reshape(-1) for n in sorted(out_cols)}
    return schema_from_physical(flat, like=schema)


def infer_select_schema(schema: Schema, fn) -> Schema:
    out = fn(dummy_cols(schema))
    if not isinstance(out, dict):
        raise TypeError("select fn must return a dict of physical columns")
    return schema_from_physical({n: out[n] for n in sorted(out)}, like=schema)


def schema_from_physical(cols: Dict[str, torch.Tensor], like: Schema = None) -> Schema:
    """Reconstruct a logical schema from physical columns (see the
    reference for the split-word rules)."""
    names = set(cols.keys())
    fields: List[Tuple[str, ColumnType]] = []
    seen = set()
    for name in cols:
        if "#" in name:
            base = name.split("#")[0]
            if base in seen:
                continue
            seen.add(base)
            has = {f"{base}#{s}" for s in ("h0", "h1", "r0", "r1")} & names
            if has == {f"{base}#h0", f"{base}#h1", f"{base}#r0", f"{base}#r1"}:
                fields.append((base, ColumnType.STRING))
            elif has == {f"{base}#h0", f"{base}#h1"}:
                if like is not None and base in like and like.field(base).ctype.is_split:
                    fields.append((base, like.field(base).ctype))
                else:
                    fields.append((base, ColumnType.INT64))
            else:
                raise ValueError(
                    f"incomplete split column set for {base!r}: {sorted(has)}"
                )
        else:
            dt = cols[name].dtype
            if dt not in _DTYPE_TO_TYPE:
                raise TypeError(f"column {name!r} has unsupported dtype {dt}")
            fields.append((name, _DTYPE_TO_TYPE[dt]))
    return Schema(fields)
