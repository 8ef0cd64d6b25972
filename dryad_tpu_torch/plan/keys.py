"""Logical key -> physical device-column lowering.

The counterpart of ``dryad_tpu/plan/keys.py``: equality keys are the
identity columns (hash words for strings); ordering keys are uint32
operand words (int64 carrier) whose lexicographic order equals the
logical order.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from dryad_tpu_torch.columnar.batch import MASK32, ColumnBatch
from dryad_tpu_torch.columnar.schema import ColumnType, Schema
from dryad_tpu_torch.ops.sortkeys import SIGN32, to_sortable_u32


def equality_cols(schema: Schema, names: Sequence[str]) -> List[str]:
    """Physical columns whose tuple-equality == logical key equality."""
    out: List[str] = []
    for n in names:
        f = schema.field(n)
        if f.ctype.is_split:
            out += [f"{n}#h0", f"{n}#h1"]
        else:
            out.append(n)
    return out


def group_carry_cols(schema: Schema, names: Sequence[str]) -> List[str]:
    """Physical columns to carry as group keys (includes string ranks so
    ordering info survives a group-by)."""
    out: List[str] = []
    for n in names:
        out.extend(schema.field(n).device_names)
    return out


class OrderingOperands:
    """Callable: batch -> uint32 operand list, lexicographic order ==
    logical (column, descending) chain order.  INT64/FLOAT64: (sign-
    flipped high word, low word); STRING: (8-byte prefix rank words,
    hash words).  VALUE-equal, as in the reference."""

    def __init__(self, schema: Schema, keys: Sequence[Tuple[str, bool]]):
        self.fields = tuple((schema.field(n), bool(d)) for n, d in keys)

    def __eq__(self, other) -> bool:
        return type(other) is OrderingOperands and other.fields == self.fields

    def __hash__(self) -> int:
        return hash(self.fields)

    def __call__(self, batch: ColumnBatch) -> List[torch.Tensor]:
        ops: List[torch.Tensor] = []
        flip = lambda t, d: t ^ MASK32 if d else t
        for f, desc in self.fields:
            if f.ctype == ColumnType.STRING:
                triple = [batch.data[f"{f.name}#{w}"] for w in ("r0", "r1", "h1", "h0")]
                ops.extend(flip(t, desc) for t in triple)
            elif f.ctype in (ColumnType.INT64, ColumnType.FLOAT64):
                hi = batch.data[f"{f.name}#h1"] ^ SIGN32
                lo = batch.data[f"{f.name}#h0"]
                ops.extend([flip(hi, desc), flip(lo, desc)])
            else:
                ops.append(to_sortable_u32(batch.data[f.name], desc))
        return ops


def ordering_operands(schema: Schema, keys: Sequence[Tuple[str, bool]]) -> OrderingOperands:
    return OrderingOperands(schema, keys)
