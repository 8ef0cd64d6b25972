"""ColumnBatch — the device-resident record container of the port.

The counterpart of ``dryad_tpu/columnar/batch.py``.  One GPU holds all P
logical partitions, so every physical column is a ``(P, cap)`` tensor
and the validity mask is a ``(P, cap)`` bool tensor; flattening the two
leading axes gives the reference's partition-major ``(P * cap)`` global
layout.

Word carrier: PyTorch's uint32 lacks shifts, adds, compares and sorts,
so every uint32 physical word (string hash and rank words, split 64-bit
halves, UINT32 columns) lives on the device as int64 in ``[0, 2^32)``.
An int64 device column therefore always means "uint32 on the host";
the port has no other int64 device type.

Host/device movement happens only here and in ``api/context.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dryad_tpu_torch.columnar.schema import (
    ColumnType,
    Schema,
    StringDictionary,
    f64_to_ordered_i64,
    join64,
    ordered_i64_to_f64,
    split64,
    string_prefix_rank,
)

WORD = torch.int64  # device carrier of uint32 words
MASK32 = 0xFFFFFFFF


def encode_physical(
    field, a: np.ndarray, dictionary: Optional[StringDictionary]
) -> Dict[str, np.ndarray]:
    """One logical host column -> its physical columns (STRING: Hash64
    words + memcomparable prefix ranks; INT64/FLOAT64: order-preserving
    split words).  Same encoding as the reference."""
    if field.ctype == ColumnType.STRING:
        if dictionary is None:
            raise ValueError(f"STRING column {field.name} needs a dictionary")
        strs = [str(s) for s in a]
        hashes = dictionary.add_all(strs)
        lo, hi = split64(hashes)
        sarr = np.array(strs, object)
        return {
            f"{field.name}#h0": lo,
            f"{field.name}#h1": hi,
            f"{field.name}#r0": string_prefix_rank(sarr),
            f"{field.name}#r1": string_prefix_rank(sarr, offset=4),
        }
    if field.ctype == ColumnType.INT64:
        lo, hi = split64(a.astype(np.int64))
        return {f"{field.name}#h0": lo, f"{field.name}#h1": hi}
    if field.ctype == ColumnType.FLOAT64:
        lo, hi = split64(f64_to_ordered_i64(a))
        return {f"{field.name}#h0": lo, f"{field.name}#h1": hi}
    return {field.name: a.astype(field.ctype.numpy_dtype)}


def to_device_column(a: np.ndarray, device) -> torch.Tensor:
    """Host physical column -> device tensor (uint32 rides as int64)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    elif not a.flags.writeable:
        a = a.copy()
    # always a copy: the batch never aliases the caller's arrays
    return torch.from_numpy(a).to(device, copy=True)


def to_host_column(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> host physical column (int64 carrier -> uint32)."""
    a = t.detach().cpu().numpy()
    return a.astype(np.uint32) if a.dtype == np.int64 else a


class ColumnBatch:
    """Fixed-capacity columnar batch of P partitions with a validity mask.

    ``data`` maps physical column name -> ``(P, cap)`` tensor; ``valid``
    is ``(P, cap)`` bool.  Every tensor lies on one device.
    """

    def __init__(self, data: Dict[str, torch.Tensor], valid: torch.Tensor):
        self.data = dict(data)
        self.valid = valid

    @property
    def num_partitions(self) -> int:
        return int(self.valid.shape[0])

    @property
    def capacity(self) -> int:
        """Per-partition capacity."""
        return int(self.valid.shape[1])

    @property
    def device(self) -> torch.device:
        return self.valid.device

    @property
    def columns(self) -> List[str]:
        return sorted(self.data.keys())

    def nbytes(self) -> int:
        return sum(
            t.numel() * t.element_size() for t in self.data.values()
        ) + self.valid.numel()

    def with_column(self, name: str, values: torch.Tensor) -> "ColumnBatch":
        return ColumnBatch({**self.data, name: values}, self.valid)

    def select(self, names: Sequence[str]) -> "ColumnBatch":
        return ColumnBatch({n: self.data[n] for n in names}, self.valid)

    def filter(self, keep_mask: torch.Tensor) -> "ColumnBatch":
        """Row filter: AND a predicate into the validity mask (Where)."""
        return ColumnBatch(self.data, self.valid & keep_mask)

    # -- host conversion ---------------------------------------------------
    @staticmethod
    def from_host_layout(
        data: Dict[str, np.ndarray], valid: np.ndarray, device
    ) -> "ColumnBatch":
        """Upload an already laid-out ``(P, cap)`` host table."""
        return ColumnBatch(
            {c: to_device_column(v, device) for c, v in data.items()},
            to_device_column(valid, device),
        )

    @staticmethod
    def from_numpy(
        schema: Schema,
        arrays: Dict[str, np.ndarray],
        num_partitions: int,
        device,
        partition_capacity: Optional[int] = None,
        dictionary: Optional[StringDictionary] = None,
    ) -> "ColumnBatch":
        """Encode host logical columns and block-partition them over P
        partitions (``parallel.partition.block_layout``)."""
        from dryad_tpu_torch.parallel.partition import block_layout

        n = None
        for name in schema.names:
            m = len(np.asarray(arrays[name]))
            if n is not None and m != n:
                raise ValueError("ragged input columns")
            n = m
        phys: Dict[str, np.ndarray] = {}
        for f in schema.fields:
            phys.update(encode_physical(f, np.asarray(arrays[f.name]), dictionary))
        data, valid = block_layout(phys, num_partitions, partition_capacity)
        return ColumnBatch.from_host_layout(data, valid, device)

    def fetch_host(self) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """``(valid, columns)`` on the host in the flat partition-major
        ``(P * cap)`` layout, uint32 words restored."""
        valid = self.valid.reshape(-1).cpu().numpy()
        host = {c: to_host_column(v.reshape(-1)) for c, v in self.data.items()}
        return valid, host

    def to_numpy(
        self, schema: Schema, dictionary: Optional[StringDictionary] = None
    ) -> Dict[str, np.ndarray]:
        """Decode valid rows back to host logical columns."""
        valid, host = self.fetch_host()
        return decode_physical_table(schema, valid, host, dictionary)


def decode_physical_table(
    schema: Schema,
    valid,
    host: Dict[str, np.ndarray],
    dictionary: Optional[StringDictionary] = None,
) -> Dict[str, np.ndarray]:
    """Physical host columns -> logical table (``valid`` is a bool mask
    or a full slice).  The inverse of :func:`encode_physical`."""
    out: Dict[str, np.ndarray] = {}
    for f in schema.fields:
        if f.ctype == ColumnType.STRING:
            hashes = join64(host[f"{f.name}#h0"][valid], host[f"{f.name}#h1"][valid])
            out[f.name] = (
                hashes if dictionary is None
                else np.array(dictionary.lookup_all(hashes), dtype=object)
            )
        elif f.ctype == ColumnType.INT64:
            out[f.name] = join64(
                host[f"{f.name}#h0"][valid], host[f"{f.name}#h1"][valid],
                signed=True,
            )
        elif f.ctype == ColumnType.FLOAT64:
            out[f.name] = ordered_i64_to_f64(join64(
                host[f"{f.name}#h0"][valid], host[f"{f.name}#h1"][valid],
                signed=True,
            ))
        else:
            out[f.name] = np.asarray(host[f.name])[valid]
    return out
