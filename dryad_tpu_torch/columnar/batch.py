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

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from dryad_tpu_torch.columnar.schema import (
    ColumnType,
    Schema,
    StringDictionary,
    f64_to_ordered_i64,
    factorize_strings,
    join64,
    ordered_i64_to_f64,
    split64,
    string_prefix_rank,
)

WORD = torch.int64  # device carrier of uint32 words
MASK32 = 0xFFFFFFFF
# A scatter sends the rows it drops to DUMP slots past its output,
# spread by row position: one shared slot would serialize their writes
# (and atomics) on the card.
DUMP = 1024


def encode_physical(
    field, a: np.ndarray, dictionary: Optional[StringDictionary]
) -> Dict[str, np.ndarray]:
    """One logical host column -> its physical columns (STRING: Hash64
    words + memcomparable prefix ranks; INT64/FLOAT64: order-preserving
    split words).  Same encoding as the reference."""
    if field.ctype == ColumnType.STRING:
        if dictionary is None:
            raise ValueError(f"STRING column {field.name} needs a dictionary")
        f = factorize_strings(a)
        if f is not None:
            # encode each distinct value once, then gather by row: the
            # same words as the per-row encode below
            values, codes = f
            sarr = np.array(values, object)
            hashes = dictionary.add_all(values)
            lo, hi = split64(hashes)
            r0, r1 = string_prefix_rank(sarr), string_prefix_rank(sarr, offset=4)
            return {
                f"{field.name}#h0": lo[codes],
                f"{field.name}#h1": hi[codes],
                f"{field.name}#r0": r0[codes],
                f"{field.name}#r1": r1[codes],
            }
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


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int64 cumsum along the last axis of a ``(P, n)`` tensor,
    as one scan of the flattened tensor minus each row's start.  (A scan
    along the last axis of a few long rows runs one block per row on
    CUDA; the flat scan uses the whole card.)"""
    flat = x.reshape(-1).cumsum(0, dtype=torch.int64).view(x.shape)
    return flat - torch.nn.functional.pad(flat[:-1, -1], (1, 0))[:, None]


class ColumnBatch:
    """Fixed-capacity columnar batch of P partitions with a validity mask.

    ``data`` maps physical column name -> ``(P, cap)`` tensor; ``valid``
    is ``(P, cap)`` bool.  Every tensor lies on one device.  A user
    function of ``apply`` or ``fork`` gets one partition as a batch of
    ``(cap,)`` tensors, on which the row methods below work the same.
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
        return int(self.valid.shape[-1])

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

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.data[name]

    def with_column(self, name: str, values: torch.Tensor) -> "ColumnBatch":
        return ColumnBatch({**self.data, name: values}, self.valid)

    def select(self, names: Sequence[str]) -> "ColumnBatch":
        return ColumnBatch({n: self.data[n] for n in names}, self.valid)

    def filter(self, keep_mask: torch.Tensor) -> "ColumnBatch":
        """Row filter: AND a predicate into the validity mask (Where)."""
        return ColumnBatch(self.data, self.valid & keep_mask)

    def count(self) -> torch.Tensor:
        """Valid rows per partition, ``(P,)`` int32."""
        return self.valid.sum(-1, dtype=torch.int32)

    def compact_order(self) -> torch.Tensor:
        """The ``(P, cap)`` gather index that moves each partition's valid
        rows to its front, stably: the reference's stable sort on
        ``~valid`` (valid rows in order, then the invalid ones in theirs),
        computed as the inverse of one cumsum rather than a sort."""
        v = self.valid
        c = row_cumsum(v)
        src = torch.arange(v.shape[-1], device=v.device).expand_as(c)
        dst = torch.where(v, c - 1, c[:, -1:] + src - c)
        return torch.empty_like(dst).scatter_(-1, dst, src)

    def compact(self) -> "ColumnBatch":
        """Move valid rows to the front (stable); invalid slots keep
        stale values with their mask bits off."""
        return self.take(self.compact_order())

    def take(self, order: torch.Tensor) -> "ColumnBatch":
        """Row gather by a ``(P, n)`` index (caller manages mask
        semantics)."""
        return ColumnBatch(
            {c: t.gather(-1, order) for c, t in self.data.items()},
            self.valid.gather(-1, order),
        )

    def pad_to(self, capacity: int) -> "ColumnBatch":
        """Grow every partition to ``capacity`` rows with zero-filled,
        invalid slots."""
        extra = capacity - self.capacity
        if extra == 0:
            return self
        if extra < 0:
            raise ValueError(
                f"pad_to({capacity}) below current capacity {self.capacity}"
            )
        pad = lambda t: torch.nn.functional.pad(t, (0, extra))
        return ColumnBatch({c: pad(t) for c, t in self.data.items()}, pad(self.valid))

    @staticmethod
    def concatenate(batches: Sequence["ColumnBatch"]) -> "ColumnBatch":
        """Concat along rows, partition by partition (the Concat
        operator's device step): partition p holds the first batch's
        rows of p, then the second's, and so on."""
        names = batches[0].columns
        for b in batches[1:]:
            if b.columns != names:
                raise ValueError("concat of batches with differing columns")
        data = {n: torch.cat([b.data[n] for b in batches], -1) for n in names}
        return ColumnBatch(data, torch.cat([b.valid for b in batches], -1))

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
        rows: Optional[slice] = None,
    ) -> "ColumnBatch":
        """Encode host logical columns and block-partition them over P
        partitions (``parallel.partition.block_layout``); with ``rows``,
        only those partitions of the layout (a gang rank's own)."""
        from dryad_tpu_torch.parallel.partition import block_layout

        n = None
        for name in schema.names:
            m = len(np.asarray(arrays[name]))
            if n is not None and m != n:
                raise ValueError("ragged input columns")
            n = m
        total = None
        if rows is not None and n:
            # a rank's partitions: encode only their rows
            per = -(-n // num_partitions)
            parts = range(num_partitions)[rows]
            lo, hi = min(parts.start * per, n), min(parts.stop * per, n)
            arrays = {name: np.asarray(arrays[name])[lo:hi] for name in schema.names}
            total = n
        phys: Dict[str, np.ndarray] = {}
        for f in schema.fields:
            phys.update(encode_physical(f, np.asarray(arrays[f.name]), dictionary))
        data, valid = block_layout(phys, num_partitions, partition_capacity, rows, total)
        return ColumnBatch.from_host_layout(data, valid, device)

    def fetch_valid_rows(self, with_counts: bool = False):
        """The valid rows' physical columns on the host, in the flat
        partition-major order, uint32 words restored.  Rows are selected
        on the device first, so only valid rows cross to the host (an
        exchanged batch is mostly padding); from a GPU they are copied
        into page-locked buffers, all copies queued before one wait.
        ``with_counts``: also each partition's valid count, ``(P,)``
        int64, in the same copy; returns ``(columns, counts)``."""
        keep = self.valid.reshape(-1).nonzero().squeeze(1)
        rows = {c: v.reshape(-1)[keep] for c, v in self.data.items()}
        extra = [self.valid.sum(-1)] if with_counts else []
        if self.device.type == "cuda":
            def pinned(t):
                return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)

            rows = {c: pinned(t) for c, t in rows.items()}
            extra = [pinned(t) for t in extra]
            torch.cuda.current_stream(self.device).synchronize()
        host = {c: to_host_column(t) for c, t in rows.items()}
        return (host, extra[0].numpy()) if with_counts else host

    def to_numpy(
        self, schema: Schema, dictionary: Optional[StringDictionary] = None
    ) -> Dict[str, np.ndarray]:
        """Decode valid rows back to host logical columns."""
        host = self.fetch_valid_rows()
        return decode_physical_table(schema, slice(None), host, dictionary)


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
