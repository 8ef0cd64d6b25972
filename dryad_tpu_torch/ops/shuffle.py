"""The shuffle exchange: repartitioning rows between partitions.

The counterpart of ``dryad_tpu/ops/shuffle.py`` (``bucket_capacity``,
``row_bytes``, ``exchange``, ``exchange_staged``, ``resize``).  Each
source partition sends at most ``B`` rows to each destination; a bucket
that would hold more drops rows and sets the overflow flag, and the
executor re-runs the stage with a larger ``B``.  Placement inside a
destination is ordered by (source, position after the stable sort by
destination), independent of ``B``, so results are byte-identical
across overflow boosts.

The reference builds a ``(P, B)`` send buffer per device and moves it
with ``all_to_all``.  In one process all P partitions live on one
device, so each row is scattered straight to its place in the received
layout ``recv[dst, src * B + w]`` (``parallel/partition.py::all_to_all``
is the same layout as a transpose of the send buffer).  Over a process
group each rank scatters its ``local`` sources into a ``(local, P, B)``
send buffer, ``all_to_all`` moves it into that same received layout,
and a placement into ``capacity`` rows reads every source's kept counts
from an ``all_gather`` of the ``(local, P)`` bucket counts: the same
bytes as the one-process exchange at the same P.

``exchange_staged`` moves the same rows along an exchange planner's
schedule (``plan/xchgplan.py``): one ``(B, ...)`` block per source and
hop, hops grouped into rounds, each round one ``ppermute``
(``parallel/partition.py``), so at most ``window`` blocks a partition
are in flight.  Its output is the flat exchange's, byte for byte,
padding included, in both layouts.

On a hybrid mesh (``parallel/mesh.py``) an exchange may run over one
axis: ``axis=AXIS`` within each slice (``num_partitions`` the slice's
``ici``), ``axis=DCN_AXIS`` across the slices at each ICI index
(``num_partitions`` the slice count).  Its received width is
``num_partitions * B``, as the reference's exchange over one mesh axis.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from dryad_tpu_torch.columnar.batch import DUMP, WORD, ColumnBatch
from dryad_tpu_torch.parallel import partition as PART
from dryad_tpu_torch.parallel.mesh import AXIS, DCN_AXIS


def bucket_capacity(capacity: int, num_partitions: int, slack: float) -> int:
    """Per-(src, dst) bucket rows: slack times the uniform expectation,
    at least 8, at most ``capacity`` (a source never holds more)."""
    want = max(8, int(math.ceil(capacity * slack / num_partitions)))
    return max(1, min(want, capacity))


def row_bytes(batch: ColumnBatch) -> int:
    """Per-row byte footprint of the reference's layout (columns +
    validity mask), the exchange planner's ``row_bytes``: a carrier word
    counts as the 4-byte uint32 it carries."""
    per = 1
    for col in batch.data.values():
        size = 4 if col.dtype == WORD else col.element_size()
        per += size * int(math.prod(col.shape[2:]))
    return per


def exchange(
    batch: ColumnBatch,
    dest: torch.Tensor,
    num_partitions: int,
    bucket_cap: int,
    capacity: Optional[int] = None,
    mesh=None,
    axis: Optional[str] = None,
) -> Tuple[ColumnBatch, torch.Tensor]:
    """Move every valid row to partition ``dest`` (in ``[0, n)`` for
    ``n = num_partitions``).

    Returns the received batch, capacity ``n * B`` per partition
    (destination ``d`` holds source ``s``'s rows for it at
    ``[s * B, (s + 1) * B)``, zero-filled past them), and a scalar bool
    overflow flag, set when any (source, destination) bucket got more
    than ``B`` rows.

    With ``capacity``, returns ``resize(exchange(...), capacity)`` instead,
    placing each row straight at its compacted position (the rows kept
    from earlier sources, plus its rank in its bucket): the same bytes
    and flag, without the padded layout in between.  ``mesh``: the
    partitions' mesh; over a process group the rows cross ranks.
    ``axis``: one axis of a hybrid mesh (module docstring); None, all
    partitions (``n == P``)."""
    if axis is not None:
        batch, dest, inv = _axis_view(batch, dest, num_partitions, mesh, axis)
        out, overflow = _exchange_local(batch, dest, num_partitions, bucket_cap, capacity)
        return _partitions(out, inv), overflow
    if mesh is not None and mesh.group is not None:
        return _exchange_group(batch, dest, num_partitions, bucket_cap, capacity, mesh)
    return _exchange_local(batch, dest, num_partitions, bucket_cap, capacity)


def _exchange_local(batch: ColumnBatch, dest: torch.Tensor, n: int, B: int,
                    capacity: Optional[int]) -> Tuple[ColumnBatch, torch.Tensor]:
    """:func:`exchange` in one process over groups of ``n`` consecutive
    partitions (one group of all P, or the slices of a hybrid axis
    laid out group-major): rows move within their group."""
    S, cap = batch.valid.shape
    dev = batch.device
    dsorted, order, counts, within = _bucket_ranks(batch, dest, n)
    src = torch.arange(S, device=dev).reshape(S, 1)
    pos = torch.arange(cap, device=dev)
    keep = (dsorted < n) & (within < B)
    overflow = (counts[:, :n] > B).any()
    if capacity is None:
        width = n * B
        at = (src % n) * B + within
    else:
        before, over = _kept_before(counts, n, B, capacity, None)
        width = capacity
        at = before.gather(-1, dsorted.clamp(max=n - 1)) + within
        keep = keep & (at < capacity)
        overflow = overflow | over
    if S > n:  # rows move within their group of n partitions
        dsorted = dsorted + (src - src % n)
    size = S * width
    tgt_sorted = torch.where(keep, dsorted * width + at, size + pos % DUMP)
    tgt = torch.empty_like(tgt_sorted).scatter_(-1, order, tgt_sorted).reshape(-1)

    def place(col: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(size + DUMP, dtype=col.dtype, device=dev)
        return out.scatter_(0, tgt, col.reshape(-1))[:size].reshape(S, width)

    data = {c: place(t) for c, t in batch.data.items()}
    valid = place(torch.ones_like(batch.valid))
    return ColumnBatch(data, valid), overflow


def _axis_view(batch: ColumnBatch, dest: torch.Tensor, n: int, mesh, axis: str):
    """A hybrid mesh's partitions laid out group-major for an exchange
    over ``axis``: ``(batch, dest, inverse)``, ``inverse`` (None when
    the layout is the mesh's own) restoring the mesh's order."""
    if mesh is None or not mesh.hybrid or mesh.group is not None:
        raise ValueError(f"an exchange over axis {axis!r} needs a one-process hybrid mesh")
    if axis == AXIS:
        if n != mesh.ici:
            raise ValueError(f"an ICI exchange moves rows among {mesh.ici} partitions, not {n}")
        return batch, dest, None
    if axis != DCN_AXIS:
        raise ValueError(f"unknown mesh axis {axis!r}")
    if n != mesh.dcn:
        raise ValueError(f"a DCN exchange moves rows among {mesh.dcn} slices, not {n}")
    D, ici, dev = mesh.dcn, mesh.ici, batch.device
    # position p * D + d holds partition d * ici + p
    order = torch.arange(mesh.P, device=dev).reshape(D, ici).t().reshape(-1)
    inv = torch.arange(mesh.P, device=dev).reshape(ici, D).t().reshape(-1)
    return _partitions(batch, order), dest[order], inv


def _partitions(batch: ColumnBatch, idx: Optional[torch.Tensor]) -> ColumnBatch:
    """The batch's partitions in the order ``idx`` (as it is for None)."""
    if idx is None:
        return batch
    return ColumnBatch({c: t[idx] for c, t in batch.data.items()}, batch.valid[idx])


def _kept_before(counts: torch.Tensor, n: int, B: int, capacity: int, mesh):
    """The placement rule of the exchange with ``capacity``: each
    ``(source, destination)`` bucket keeps at most ``B`` rows, and its
    rows land behind the kept rows of every earlier source of its group
    of ``n`` partitions.  Returns ``(before, overflow)``: ``before[s, d]``
    over every source in global order (over a group, the sources'
    counts gathered from every rank), and whether a destination kept
    more than ``capacity`` rows."""
    kept = PART.gather_rows(counts[:, :n].clamp(max=B), mesh)
    groups = kept.reshape(-1, n, n)
    before = (groups.cumsum(1) - groups).reshape(-1, n)
    return before, (groups.sum(1) > capacity).any()


def exchange_staged(
    batch: ColumnBatch,
    dest: torch.Tensor,
    num_partitions: int,
    bucket_cap: int,
    schedule,
    capacity: Optional[int] = None,
    mesh=None,
    axis: Optional[str] = None,
) -> Tuple[ColumnBatch, torch.Tensor]:
    """:func:`exchange` along ``schedule`` (a
    :class:`~dryad_tpu_torch.plan.xchgplan.ExchangeSchedule` over the
    ``n = num_partitions`` partitions the exchange spans): the same
    output, byte for byte, padding cells included, and the same flag.

    Each source partition's own bucket is placed in place.  Hop
    ``(sd, sp)`` builds, for every source ``(d, p)`` (its index in the
    exchange, slice-major over the schedule's ``dcn_slices x ici``), one
    ``(B, ...)`` block per column of the rows bound for
    ``((d + sd) % D, (p + sp) % ici)``, gathered from the source's rows
    in bucket order; a round's hops move in one
    ``parallel/partition.py::ppermute_many`` (every column and the
    valid bits of a block packed as bytes), and each received block is
    written at its source's slot: ``[s * B, (s + 1) * B)`` of the padded
    layout, or behind the kept rows of the earlier sources with
    ``capacity``.  At most one block a hop of a round is in flight a
    partition, instead of the flat exchange's ``n`` buckets."""
    n, B = num_partitions, bucket_cap
    D, ici = schedule.dcn_slices, schedule.ici_partitions
    if n != schedule.num_partitions:
        raise ValueError(f"a schedule over {schedule.num_partitions} partitions for an "
                         f"exchange over {n}")
    inv = None
    if axis is not None:
        batch, dest, inv = _axis_view(batch, dest, n, mesh, axis)
        mesh = None  # the slices' partitions all live in this process
    spans = mesh is not None and mesh.group is not None
    S, cap = batch.valid.shape
    dev = batch.device
    base = mesh.base if spans else 0
    total = mesh.P if spans else S  # partitions over every rank
    _dsorted, order, counts, _within = _bucket_ranks(batch, dest, n)
    overflow = (counts[:, :n] > B).any()
    kept = counts[:, :n].clamp(max=B)
    offsets = counts.cumsum(-1) - counts
    pos = torch.arange(base, base + S, device=dev)
    member = pos % n  # each local partition's index in its group of n
    if capacity is None:
        width = n * B
    else:
        before, over = _kept_before(counts, n, B, capacity, mesh)
        overflow = overflow | over
        width = capacity
    w = torch.arange(B, device=dev)
    size = S * width
    row0 = torch.arange(S, device=dev).reshape(S, 1) * width
    cols = list(batch.data.items())
    outs = [torch.zeros(size + DUMP, dtype=t.dtype, device=dev) for _, t in cols]
    out_valid = torch.zeros(size + DUMP, dtype=torch.bool, device=dev)

    def target(m, sd: int, sp: int):
        return ((m // ici + sd) % D) * ici + (m % ici + sp) % ici

    def block(tgt: torch.Tensor):
        """Every local source's (B,) block per column for its target."""
        t = tgt.reshape(S, 1)
        ok = w < kept.gather(-1, t)
        at = order.gather(-1, (offsets.gather(-1, t) + w).clamp(max=cap - 1))
        return [col.gather(-1, at).masked_fill_(~ok, 0) for _, col in cols], ok

    def place(blocks, ok, src: torch.Tensor) -> None:
        """Write each local destination's received block from its
        source (index ``src`` in the group) at the source's slot."""
        s = src.reshape(S, 1)
        if capacity is None:
            at = s * B + w
        else:  # behind the kept rows of the group's earlier sources
            at = before[pos - member + src, member].reshape(S, 1) + w
            ok = ok & (at < capacity)
        at = torch.where(ok, row0 + at, size + w % DUMP).reshape(-1)
        for out, blk in zip(outs, blocks):
            out.scatter_(0, at, blk.reshape(-1))
        out_valid.scatter_(0, at, ok.reshape(-1))

    place(*block(member), member)  # the local bucket: no hop
    for rnd in schedule.rounds:
        items, srcs = [], []
        for sd, sp in rnd.hops:
            blocks, ok = block(target(member, sd, sp))
            items.append((_pack(blocks + [ok]), [
                (g, g - g % n + target(g % n, sd, sp)) for g in range(total)]))
            srcs.append(target(member, -sd, -sp))
        for got in PART.ppermute_many(items, mesh):
            *blocks, ok = _unpack(got, [t.dtype for _, t in cols] + [torch.bool], B)
            place(blocks, ok, srcs.pop(0))
    data = {c: out[:size].view(S, width) for (c, _), out in zip(cols, outs)}
    return _partitions(ColumnBatch(data, out_valid[:size].view(S, width)), inv), overflow


def _pack(blocks: List[torch.Tensor]) -> torch.Tensor:
    """``(S, B)`` blocks of any dtypes -> one ``(S, bytes)`` uint8 tensor."""
    return torch.cat([b.contiguous().view(torch.uint8) for b in blocks], dim=1)


def _unpack(packed: torch.Tensor, dtypes, B: int) -> List[torch.Tensor]:
    """The inverse of :func:`_pack` for blocks of ``B`` rows."""
    out, at = [], 0
    for dt in dtypes:
        size = B * torch.empty((), dtype=dt).element_size()
        out.append(packed[:, at : at + size].contiguous().view(dt))
        at += size
    return out


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
    # each destination's run in the sorted row, by binary search: no
    # host read (``bincount`` sizes its output from a read of the max),
    # so the exchange can be captured into a stage program's graph
    edges = torch.arange(P + 2, device=dev).expand(S, P + 2).contiguous()
    bounds = torch.searchsorted(dsorted, edges)
    counts = bounds[:, 1:] - bounds[:, :-1]
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
