"""The shuffle exchange: repartitioning rows between partitions.

The counterpart of ``dryad_tpu/ops/shuffle.py`` (``bucket_capacity``,
``row_bytes``, ``exchange``, ``resize``).  Each source partition sends
at most ``B`` rows to each destination; a bucket that would hold more
drops rows and sets the overflow flag, and the executor re-runs the
stage with a larger ``B``.  Placement inside a destination is ordered by
(source, position after the stable sort by destination), independent of
``B``, so results are byte-identical across overflow boosts.

The reference builds a ``(P, B)`` send buffer per device and moves it
with ``all_to_all``.  In one process all P partitions live on one
device, so each row is scattered straight to its place in the received
layout ``recv[dst, src * B + w]`` (``parallel/partition.py::all_to_all``
is the same layout as a transpose of the send buffer).  Over a process
group each rank scatters its ``local`` sources into a ``(local, P, B)``
send buffer, ``all_to_all`` moves it into that same received layout,
and a placement into ``capacity`` rows reads every source's kept counts
from an ``all_gather`` of the ``(local, P)`` bucket counts: the same
bytes as the one-process exchange at the same P.  ``exchange_staged``
waits for the exchange planner (ROADMAP.md queue 1 item 11).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from dryad_tpu_torch.columnar.batch import DUMP, ColumnBatch
from dryad_tpu_torch.parallel import partition as PART


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
    mesh=None,
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
    and flag, without the padded layout in between.  ``mesh``: the
    partitions' mesh; over a process group the rows cross ranks."""
    if mesh is not None and mesh.group is not None:
        return _exchange_group(batch, dest, num_partitions, bucket_cap, capacity, mesh)
    P, B = num_partitions, bucket_cap
    S, cap = batch.valid.shape
    dev = batch.device
    dsorted, order, counts, within = _bucket_ranks(batch, dest, P)
    src = torch.arange(S, device=dev).reshape(S, 1)
    pos = torch.arange(cap, device=dev)
    keep = (dsorted < P) & (within < B)
    overflow = (counts[:, :P] > B).any()
    if capacity is None:
        width = S * B
        at = src * B + within
    else:
        before, over = _kept_before(counts, P, B, capacity, None)
        width = capacity
        at = before.gather(-1, dsorted.clamp(max=P - 1)) + within
        keep = keep & (at < capacity)
        overflow = overflow | over
    size = P * width
    tgt_sorted = torch.where(keep, dsorted * width + at, size + pos % DUMP)
    tgt = torch.empty_like(tgt_sorted).scatter_(-1, order, tgt_sorted).reshape(-1)

    def place(col: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(size + DUMP, dtype=col.dtype, device=dev)
        return out.scatter_(0, tgt, col.reshape(-1))[:size].reshape(P, width)

    data = {c: place(t) for c, t in batch.data.items()}
    valid = place(torch.ones_like(batch.valid))
    return ColumnBatch(data, valid), overflow


def _kept_before(counts: torch.Tensor, P: int, B: int, capacity: int, mesh):
    """The placement rule of the exchange with ``capacity``: each
    ``(source, destination)`` bucket keeps at most ``B`` rows, and its
    rows land behind the kept rows of every earlier source.  Returns
    ``(before, overflow)``: ``before[s, d]`` over every source in global
    order (over a group, the sources' counts gathered from every rank),
    and whether a destination kept more than ``capacity`` rows."""
    kept = PART.gather_rows(counts[:, :P].clamp(max=B), mesh)
    return kept.cumsum(0) - kept, (kept.sum(0) > capacity).any()


def _bucket_ranks(batch: ColumnBatch, dest: torch.Tensor, P: int):
    """Each source's rows sorted stably by destination (one radix pass
    on a byte; invalid rows go to the sentinel P): ``(dsorted,
    order, counts, within)``, ``counts`` the ``(S, P + 1)`` rows per
    destination (invalid rows at P) and ``within`` a row's rank in its
    bucket."""
    S, cap = batch.valid.shape
    dev = batch.device
    d = torch.where(batch.valid, dest.to(torch.int64), P)
    small = torch.uint8 if P < 255 else torch.int32
    dsorted, order = torch.sort(d.to(small), dim=-1, stable=True)
    dsorted = dsorted.to(torch.int64)
    src = torch.arange(S, device=dev).reshape(S, 1)
    counts = torch.bincount((d + src * (P + 1)).reshape(-1), minlength=S * (P + 1))
    counts = counts.reshape(S, P + 1)
    offsets = counts.cumsum(-1) - counts
    within = torch.arange(cap, device=dev) - offsets.gather(-1, dsorted)
    return dsorted, order, counts, within


def _exchange_group(batch, dest, P, B, capacity, mesh):
    """:func:`exchange` over a process group: a ``(local, P, B)`` send
    buffer through ``all_to_all``, then, with ``capacity``, each
    received row placed behind the kept rows of every earlier source
    (their counts from an ``all_gather``)."""
    S, cap = batch.valid.shape
    dev = batch.device
    dsorted, order, counts, within = _bucket_ranks(batch, dest, P)
    keep = (dsorted < P) & (within < B)
    overflow = (counts[:, :P] > B).any()
    size = S * P * B
    src = torch.arange(S, device=dev).reshape(S, 1)
    pos = torch.arange(cap, device=dev)
    tgt_sorted = torch.where(keep, (src * P + dsorted) * B + within, size + pos % DUMP)
    tgt = torch.empty_like(tgt_sorted).scatter_(-1, order, tgt_sorted).reshape(-1)

    def send(col: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(size + DUMP, dtype=col.dtype, device=dev)
        return out.scatter_(0, tgt, col.reshape(-1))[:size].reshape(S, P, B)

    data = {c: PART.all_to_all(send(t), mesh) for c, t in batch.data.items()}
    valid = PART.all_to_all(send(torch.ones_like(batch.valid)), mesh)
    if capacity is None:
        return ColumnBatch(data, valid), overflow
    # each local destination's offsets behind every source's kept rows
    before, over = _kept_before(counts, P, B, capacity, mesh)
    overflow = overflow | over
    before = before[:, mesh.base : mesh.base + mesh.local]  # (P, local)
    L = valid.shape[0]
    at = before.t().unsqueeze(-1) + torch.arange(B, device=dev)  # (local, P, B)
    at = at.reshape(L, P * B)
    ok = valid & (at < capacity)
    flat = torch.where(
        ok, torch.arange(L, device=dev).reshape(L, 1) * capacity + at,
        L * capacity + torch.arange(P * B, device=dev) % DUMP,
    ).reshape(-1)

    def place(col: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(L * capacity + DUMP, dtype=col.dtype, device=dev)
        return out.scatter_(0, flat, col.reshape(-1))[: L * capacity].reshape(L, capacity)

    out = ColumnBatch({c: place(t) for c, t in data.items()}, place(ok))
    return out, overflow


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
