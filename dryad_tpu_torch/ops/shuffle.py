"""The shuffle exchange: repartitioning rows between partitions.

The counterpart of ``dryad_tpu/ops/shuffle.py`` (``bucket_capacity``,
``row_bytes``, ``exchange``, ``resize``).  Each source partition sends
at most ``B`` rows to each destination; a bucket that would hold more
drops rows and sets the overflow flag, and the executor re-runs the
stage with a larger ``B``.  Placement inside a destination is ordered by
(source, position after the stable sort by destination), independent of
``B``, so results are byte-identical across overflow boosts.

The reference builds a ``(P, B)`` send buffer per device and moves it
with ``all_to_all``.  All P partitions live on one device here, so each
row is scattered straight to its place in the received layout
``recv[dst, src * B + w]`` (``parallel/partition.py::all_to_all`` is the
same layout as a transpose of the send buffer).  ``exchange_staged``
waits for the exchange planner (ROADMAP.md queue 1 item 10).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from dryad_tpu_torch.columnar.batch import DUMP, ColumnBatch


def bucket_capacity(capacity: int, num_partitions: int, slack: float) -> int:
    """Per-(src, dst) bucket rows: slack times the uniform expectation,
    at least 8, at most ``capacity`` (a source never holds more)."""
    want = max(8, int(math.ceil(capacity * slack / num_partitions)))
    return max(1, min(want, capacity))


def row_bytes(batch: ColumnBatch) -> int:
    """Per-row byte footprint on the device (columns + validity mask)."""
    per = 1
    for col in batch.data.values():
        per += col.element_size() * int(math.prod(col.shape[2:]))
    return per


def exchange(
    batch: ColumnBatch,
    dest: torch.Tensor,
    num_partitions: int,
    bucket_cap: int,
    capacity: Optional[int] = None,
) -> Tuple[ColumnBatch, torch.Tensor]:
    """Move every valid row to partition ``dest`` (in ``[0, P)``).

    Returns the received batch, capacity ``S * B`` per partition for S
    source partitions (destination ``d`` holds source ``s``'s rows for it
    at ``[s * B, (s + 1) * B)``, zero-filled past them), and a scalar bool
    overflow flag, set when any (source, destination) bucket got more
    than ``B`` rows.

    With ``capacity``, returns ``resize(exchange(...), capacity)`` instead,
    placing each row straight at its compacted position (the rows kept
    from earlier sources, plus its rank in its bucket): the same bytes
    and flag, without the padded layout in between."""
    P, B = num_partitions, bucket_cap
    S, cap = batch.valid.shape
    dev = batch.device
    d = torch.where(batch.valid, dest.to(torch.int64), P)  # invalid -> sentinel
    # stable sort by destination (one radix pass on a byte): a row's rank
    # among its bucket's rows
    small = torch.uint8 if P < 255 else torch.int32
    dsorted, order = torch.sort(d.to(small), dim=-1, stable=True)
    dsorted = dsorted.to(torch.int64)
    src = torch.arange(S, device=dev).reshape(S, 1)
    counts = torch.bincount((d + src * (P + 1)).reshape(-1), minlength=S * (P + 1))
    counts = counts.reshape(S, P + 1)
    offsets = counts.cumsum(-1) - counts
    pos = torch.arange(cap, device=dev)
    within = pos - offsets.gather(-1, dsorted)
    keep = (dsorted < P) & (within < B)
    overflow = (counts[:, :P] > B).any()
    if capacity is None:
        width = S * B
        at = src * B + within
    else:
        kept = counts[:, :P].clamp(max=B)  # (S, P) rows each bucket keeps
        before = kept.cumsum(0) - kept  # kept rows of earlier sources
        width = capacity
        at = before.gather(-1, dsorted.clamp(max=P - 1)) + within
        keep = keep & (at < capacity)
        overflow = overflow | (kept.sum(0) > capacity).any()
    size = P * width
    tgt_sorted = torch.where(keep, dsorted * width + at, size + pos % DUMP)
    tgt = torch.empty_like(tgt_sorted).scatter_(-1, order, tgt_sorted).reshape(-1)

    def place(col: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(size + DUMP, dtype=col.dtype, device=dev)
        return out.scatter_(0, tgt, col.reshape(-1))[:size].reshape(P, width)

    data = {c: place(t) for c, t in batch.data.items()}
    valid = place(torch.ones_like(batch.valid))
    return ColumnBatch(data, valid), overflow


def resize(batch: ColumnBatch, capacity: int) -> Tuple[ColumnBatch, torch.Tensor]:
    """Compact valid rows to the front and resize every partition to
    ``capacity``.  Returns ``(batch, overflow)``: overflow is set when a
    partition holds more valid rows than ``capacity`` (those past it are
    dropped; the executor retries with a larger shape)."""
    order = batch.compact_order()
    overflow = (batch.count() > capacity).any()
    if capacity < batch.capacity:
        order = order[:, :capacity]
    out = batch.take(order)
    if capacity > batch.capacity:
        out = out.pad_to(capacity)
    return out, overflow
