"""The partition layer: the collectives of the stage ops over a mesh.

The counterpart of the collectives in ``dryad_tpu/ops`` and
``dryad_tpu/exec`` and of ``dryad_tpu/parallel/distribute.py``'s host
layout.  The reference runs one partition per device under
``shard_map``.  The port keeps a rank's ``local`` partitions on its one
device as the leading axis of every ``(local, cap)`` tensor
(``parallel/mesh.py``).  Each collective takes the mesh: with no mesh,
or a mesh without a process group (one process, ``local == P``), it is
a tensor operation on that axis, as before any group existed; over a
group it crosses the ranks through ``torch.distributed``:

=================================  ====================  ================================
reference collective               one process           over a group
=================================  ====================  ================================
``psum_scatter(tiled=True)``       ``x.sum(0)``,          local sum, ``reduce_scatter``
                                   ``reshape(P, per)``
``psum`` / ``pmin`` / ``pmax``     reduction over axis 0  local reduction, ``all_reduce``
``all_gather(tiled=True)``         ``reshape(1, P * n)``  ``all_gather`` of the blocks
                                   (a stride-0 view)
``all_to_all(tiled=True)``         transpose of           ``alltoall_base`` of the
                                   ``(P, P, B)``          ``(world, local, local, B)``
                                                          send buffer
``axis_index``                     ``arange(P)``          ``rank * local + arange(local)``
exclusive prefix over partitions   ``cumsum(0) - x``      ``all_gather``, then the same
``ppermute``                       an index of axis 0     sends and receives in one
                                                          coalesced launch (NCCL), one
                                                          send and one receive a peer
=================================  ====================  ================================

On a hybrid mesh over rank threads an exchange over one axis passes
the axis's view (``parallel/mesh.py::AxisMesh``) as the mesh: the same
collectives then run over the axis's sub-group, a slice's cards or the
cards at one position, and on the DCN axis :func:`all_to_all_strided`
moves each local partition's blocks to the partition at its place on
every card of the sub-group.  Their bytes count on the whole mesh.

Every collective runs through one adapter over the group object's own
methods (:func:`_allreduce_into`, :func:`_allgather_into`,
:func:`_reduce_scatter_into`, :func:`_alltoall_into`, :func:`_p2p`):
the same calls serve a gang's group, registered by
``init_process_group``, and the unregistered groups of a context whose
ranks are threads of one process (``parallel/ranks.py``), which
``torch.distributed``'s functions refuse.  Over the latter a rank's
wait for its peers also watches the group's abort flag
(``mesh.link.abort``): the context sets it when a rank failed, and a
rank waiting on the failed one raises :class:`GangStageError` at once.

A group of the ``gloo`` backend carries CUDA tensors through the host
(each collective copies its operand to the CPU and the result back, and
blocks until the group's timeout at most: a rank that never reaches a
collective fails its peers' call instead of hanging them).  ``nccl``
takes them on the card, one rank a card, and runs them asynchronously:
inside a stage program's CUDA graph, or enqueued after it.  Its bound
is :func:`settle`: every read of a device value on the host over an
NCCL group first waits, the group's timeout at most, for the work the
rank enqueued (each dispatch marked with its stage by
:func:`note_dispatch`), and raises :class:`GangStageError` naming the
first stage whose collectives did not complete.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed import distributed_c10d as c10d


def block_layout(
    phys: Dict[str, np.ndarray],
    P: int,
    partition_capacity: Optional[int] = None,
    rows: Optional[slice] = None,
    total: Optional[int] = None,
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Block-partition encoded physical columns on the host.

    Partition p holds rows ``[p*per, (p+1)*per)`` with
    ``per = ceil(n / P)`` (``cap = per`` unless given), exactly as
    ``dryad_tpu/parallel/distribute.py::from_physical_table``, so the
    partition-major order equals the original row order.  Returns
    ``(P, cap)`` host arrays and the ``(P, cap)`` valid mask; with
    ``rows``, only those partitions of the layout (a rank's own).
    ``total``: the table's row count when ``phys`` holds only the rows
    of ``rows``' partitions (a rank encodes only its own rows)."""
    names = list(phys.keys())
    held = len(np.asarray(phys[names[0]])) if names else 0
    n = held if total is None else int(total)
    per = -(-n // P) if n else 1
    cap = partition_capacity if partition_capacity is not None else per
    if cap < per:
        raise ValueError(f"partition_capacity {cap} < required {per}")
    parts = range(P)[rows] if rows is not None else range(P)
    sizes = [min((p + 1) * per, n) - min(p * per, n) for p in parts]
    # the row the arrays start at: 0, or the first row of ``rows``
    # when they hold only those partitions' rows
    off = 0 if total is None else min(parts.start * per, n) if len(parts) else 0
    data = {}
    for c in names:
        a = np.asarray(phys[c])
        if cap == per and n == P * per:
            # exact fit: a view, no copy
            data[c] = (a.reshape(P, cap)[parts.start : parts.stop] if total is None
                       else a.reshape((len(parts), cap) + a.shape[1:]))
            continue
        pad = np.zeros((len(parts), cap) + a.shape[1:], a.dtype)
        for i, (p, m) in enumerate(zip(parts, sizes)):
            lo = min(p * per, n) - off
            pad[i, :m] = a[lo : lo + m]
        data[c] = pad
    valid = np.zeros((len(parts), cap), np.bool_)
    for i, m in enumerate(sizes):
        valid[i, :m] = True
    return data, valid


# -- transport -----------------------------------------------------------------

class GangStageError(RuntimeError):
    """A stage of a gang failed on this rank, its collective included (a
    peer that never arrived, a peer that died): the message names the
    stage and the rank."""


def _spans(mesh) -> bool:
    return mesh is not None and mesh.group is not None


def _on_cards(mesh) -> bool:
    """An NCCL group of several ranks: its collectives run on the cards,
    asynchronously to the host."""
    return _spans(mesh) and mesh.backend == "nccl" and mesh.world > 1


# the host's poll of a settle, seconds between two queries of an event
SETTLE_POLL_S = 5e-5


def note_dispatch(mesh, name: str, graph: bool = False) -> None:
    """Over an NCCL group: mark the work this rank enqueued on the card
    so far as stage ``name``'s (an event on the current stream), for
    :func:`settle` to wait for and to name; ``graph``: it replayed a
    CUDA graph.  Nothing elsewhere, and nothing inside a capture."""
    if not _on_cards(mesh) or torch.cuda.is_current_stream_capturing():
        return
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(mesh.device))
    mesh.inflight.append((ev, name))
    mesh.replayed = mesh.replayed or graph


def _aborted(mesh) -> bool:
    """True when the context of in-process ranks gave up on the group
    (a peer rank failed)."""
    link = getattr(mesh, "link", None)
    return link is not None and link.abort.is_set()


def _abort_error(mesh, stage: Optional[str] = None) -> GangStageError:
    stage = stage or getattr(mesh, "stage", None) or "the job"
    return GangStageError(
        f"stage {stage!r} failed on rank {mesh.rank} of {mesh.world}: the group was "
        "aborted (a peer rank failed)")


def settle(mesh, name: Optional[str] = None) -> None:
    """Over an NCCL group, before a read of a device value on the host:
    wait until the work this rank enqueued has run, the group's timeout
    (``mesh.timeout``) at most, and raise :class:`GangStageError`
    naming the first marked stage (:func:`note_dispatch`) that has not
    run by then: its collectives wait for a peer that died or never
    arrived.  ``name`` names the work since the last mark.  Nothing
    elsewhere (gloo's collectives block on the host themselves)."""
    if not _on_cards(mesh) or torch.cuda.is_current_stream_capturing():
        return
    note_dispatch(mesh, name or (mesh.inflight[-1][1] if mesh.inflight else "the job"))
    pending, mesh.inflight, mesh.replayed = mesh.inflight, [], False
    deadline = time.monotonic() + mesh.timeout
    for ev, stage in pending:
        while not ev.query():
            if _aborted(mesh):
                raise _abort_error(mesh, stage)
            if time.monotonic() > deadline:
                raise GangStageError(
                    f"stage {stage!r} failed on rank {mesh.rank} of {mesh.world}: its "
                    f"collectives did not complete within {mesh.timeout:g} s (a peer died or "
                    "never arrived)")
            time.sleep(SETTLE_POLL_S)


def _wire(mesh, t: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous copy of ``t`` where the group's backend takes
    it: the host for ``gloo`` (which stages CUDA tensors), the mesh's
    card for ``nccl``.  Bools travel as uint8.  An NCCL collective
    launched outside a capture after a graph's replay first waits for
    the replay (:func:`settle`): the group runs without NCCL's support
    for graph and eager launches in flight together
    (``NCCL_GRAPH_MIXING_SUPPORT=0``, which a WHILE node's body needs,
    ``init_distributed``)."""
    if mesh.replayed and not torch.cuda.is_current_stream_capturing():
        settle(mesh)
    dev = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
    dt = torch.uint8 if t.dtype == torch.bool else t.dtype
    buf = torch.empty(t.shape, dtype=dt, device=dev).copy_(t)
    mesh.sent_bytes += buf.numel() * buf.element_size()
    return buf


def _back(buf: torch.Tensor, like: torch.Tensor, mesh=None) -> torch.Tensor:
    """The collective's result as ``like``'s device and dtype; a result
    bound for the host from the card waits for the group (:func:`settle`)."""
    if like.device.type == "cpu" and buf.device.type == "cuda":
        settle(mesh)
    return buf.to(device=like.device, dtype=like.dtype)


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}

# -- the adapter over the group object ---------------------------------------------

def _polled(mesh) -> bool:
    """In-process ranks over gloo: their waits poll (see :func:`_wait`),
    so each collective is one whose gloo work reports its completion
    (an all-reduce, an all-gather, an all-to-all)."""
    return getattr(mesh, "link", None) is not None and mesh.backend == "gloo"


def _wait(mesh, work) -> None:
    """Wait for a collective's ``work`` as ``torch.distributed``'s
    blocking calls do (gloo: on the host; NCCL: the current stream waits
    for it).  Over in-process gloo ranks the host's wait polls, so that
    a rank waiting on a failed peer raises once the context aborts the
    group (a gloo collective cannot be cancelled: it ends at the group's
    timeout, on a group nobody uses again)."""
    if work is None:
        return
    if _polled(mesh):
        while not work.is_completed():
            if _aborted(mesh):
                raise _abort_error(mesh)
            time.sleep(SETTLE_POLL_S)
    work.wait()


def _opts(cls, op: Optional[str] = None):
    o = cls()
    if op is not None:
        o.reduceOp = getattr(dist.ReduceOp, _OPS[op])
    if hasattr(o, "asyncOp"):
        o.asyncOp = False  # as the blocking calls: NCCL runs on the current stream
    return o


def _allreduce_into(mesh, buf: torch.Tensor, op: str) -> None:
    _wait(mesh, mesh.group.allreduce([buf], _opts(c10d.AllreduceOptions, op)))


def _allgather_into(mesh, out: torch.Tensor, buf: torch.Tensor) -> None:
    _wait(mesh, mesh.group._allgather_base(out, buf, _opts(c10d.AllgatherOptions)))


def _reduce_scatter_into(mesh, out: torch.Tensor, buf: torch.Tensor) -> None:
    if _polled(mesh):
        # gloo's reduce-scatter runs inside its wait: reduce it all, keep ours
        _allreduce_into(mesh, buf, "sum")
        out.copy_(buf.reshape(mesh.world, -1)[mesh.rank])
        return
    _wait(mesh, mesh.group._reduce_scatter_base(
        out, buf, _opts(c10d.ReduceScatterOptions, "sum")))


def _alltoall_into(mesh, out: torch.Tensor, buf: torch.Tensor) -> None:
    _wait(mesh, mesh.group.alltoall_base(out, buf, [], [], _opts(c10d.AllToAllOptions)))


def _coalesces(pg, device: torch.device) -> bool:
    """NCCL-style coalescing of point-to-point calls (one group launch),
    as ``batch_isend_irecv`` decides it."""
    if type(pg) is dist.ProcessGroup:
        return bool(pg._get_backend(device).supports_coalescing)
    return bool(getattr(pg, "supports_coalescing", False))


def _p2p(mesh, sends, recvs) -> None:
    """One round of point-to-point messages, ``sends`` and ``recvs``
    lists of ``(peer rank, tensor)`` in the group's ranks: posted as one
    coalesced launch where the backend coalesces (NCCL), else each
    posted asynchronously (gloo) before any wait."""
    pg = mesh.group
    items = sends + recvs
    if not items:
        return
    dev = items[0][1].device
    co = _coalesces(pg, dev)
    # a group takes the device its backend serves; a backend is that one
    on = (dev,) if type(pg) is dist.ProcessGroup else ()
    if co:
        pg._start_coalescing(*on)
    works = [pg.send([t], peer, 0) for peer, t in sends]
    works += [pg.recv([t], peer, 0) for peer, t in recvs]
    if co:
        works = [pg._end_coalescing(*on)]
    for w in works:
        _wait(mesh, w)



def allreduce(t: torch.Tensor, op: str, mesh=None) -> torch.Tensor:
    """``t`` reduced elementwise over the ranks (``op`` sum, max or
    min); ``t`` itself with no group."""
    if not _spans(mesh):
        return t
    buf = _wire(mesh, t)
    _allreduce_into(mesh, buf, op)
    return _back(buf, t, mesh)


def gather_ranks(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """Every rank's ``t`` stacked rank-major: ``(world, *t.shape)``."""
    if not _spans(mesh):
        return t.unsqueeze(0)
    buf = _wire(mesh, t).reshape(-1)
    out = torch.empty(mesh.world * buf.numel(), dtype=buf.dtype, device=buf.device)
    _allgather_into(mesh, out, buf)
    return _back(out.reshape((mesh.world,) + tuple(t.shape)), t, mesh)


def gather_rows(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``(local, ...)`` per-partition rows -> ``(P, ...)``: every
    partition's row, in global partition order, on every rank."""
    if not _spans(mesh):
        return x
    g = gather_ranks(x, mesh)
    return g.reshape((g.shape[0] * g.shape[1],) + tuple(g.shape[2:]))


def local_rows(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The rows of this rank's partitions of a ``(P, ...)`` tensor."""
    if not _spans(mesh):
        return x
    return x[mesh.base : mesh.base + mesh.local]


# -- the stage ops' collectives --------------------------------------------------

def psum_scatter(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``(local, P*per)`` per-partition tables -> ``(local, per)``: the
    sum over all partitions, partition i keeping slice
    ``[i*per, (i+1)*per)``."""
    s = x.sum(0, dtype=x.dtype)
    if not _spans(mesh):
        return s.reshape(x.shape[0], -1)
    buf = _wire(mesh, s)
    out = torch.empty(buf.shape[0] // mesh.world, dtype=buf.dtype, device=buf.device)
    _reduce_scatter_into(mesh, out, buf)
    return _back(out, s, mesh).reshape(mesh.local, -1)


def all_gather(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``(local, n)`` -> ``(local, P*n)``: every partition sees all P
    blocks in partition order (a broadcast view of one copy)."""
    local = x.shape[0]
    return gather_rows(x, mesh).reshape(1, -1).expand(local, -1)


def gather_batch(batch, mesh=None):
    """Replicate a batch to every partition: each partition holds all P
    blocks in partition order (the reference's tiled ``all_gather`` of
    every column, ``dryad_tpu/exec/kernels.py::_gather_all``).  The
    result is a stride-0 view of one ``(1, P * cap)`` copy, which its
    consumers only read."""
    from dryad_tpu_torch.columnar.batch import ColumnBatch

    return ColumnBatch(
        {c: all_gather(t, mesh) for c, t in batch.data.items()}, all_gather(batch.valid, mesh)
    )


def axis_index(P: int, device, mesh=None) -> torch.Tensor:
    """Each local partition's global index, as a ``(local, 1)`` column."""
    if not _spans(mesh):
        return torch.arange(P, device=device).reshape(P, 1)
    return torch.arange(mesh.base, mesh.base + mesh.local, device=device).reshape(-1, 1)


def psum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Sum over the partition axis (``(local, ...)`` -> ``(...)``): the
    value every partition holds after the reference's ``psum``."""
    return allreduce(x.sum(0, dtype=x.dtype), "sum", mesh)


def pmax(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Max over the partition axis (``(local, ...)`` -> ``(...)``)."""
    return allreduce(x.amax(0), "max", mesh)


def pmin(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Min over the partition axis (``(local, ...)`` -> ``(...)``)."""
    return allreduce(x.amin(0), "min", mesh)


def any_(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """True where any element of ``x`` on any rank is (0-d bool)."""
    return allreduce(x.any(), "max", mesh)


def exclusive_prefix(x: torch.Tensor, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(local, ...)`` per-partition values -> (each local partition's
    sum over the partitions before it in global order, the sum over all
    P partitions)."""
    g = gather_rows(x, mesh)
    before = g.cumsum(0) - g
    return local_rows(before, mesh), g.sum(0)


def all_to_all(send: torch.Tensor, mesh=None) -> torch.Tensor:
    """``send[src, dst, b]`` -> ``recv[dst, src * B + b]``: partition
    ``dst`` receives every source's block for it, in global source
    order (``src`` and ``dst`` local to the sending and the receiving
    rank, the layout global)."""
    S, P, B = send.shape[:3]
    rest = tuple(send.shape[3:])
    if not _spans(mesh):
        return send.transpose(0, 1).reshape((P, S * B) + rest)
    W, L = mesh.world, mesh.local
    # per destination rank: (world_dst, S, local_dst, B, ...)
    buf = _wire(mesh, send.reshape((S, W, L, B) + rest).transpose(0, 1))
    out = torch.empty_like(buf)
    _alltoall_into(mesh, out, buf)
    # out: (world_src, S_src, local_dst, B, ...) -> (local_dst, P * B, ...)
    recv = out.permute((2, 0, 1, 3) + tuple(range(4, out.dim())))
    return _back(recv.reshape((L, W * S * B) + rest), send, mesh)


def all_to_all_strided(send: torch.Tensor, mesh=None) -> torch.Tensor:
    """``send[i, dst, b]`` -> ``recv[i, src * B + b]`` over a mesh whose
    ranks each hold member ``rank`` of the same ``local`` exchange
    groups (a hybrid mesh's DCN axis over ranks,
    ``parallel/mesh.py::AxisMesh``): local partition ``i`` sends its
    block for ``dst`` to partition ``i`` of rank ``dst`` and receives
    every rank's block for it, in rank order.  Each rank's blocks for
    one peer travel together."""
    L, W, B = send.shape[:3]
    rest = tuple(send.shape[3:])
    if not _spans(mesh):
        return send.reshape((L, W * B) + rest)
    buf = _wire(mesh, send.transpose(0, 1))  # (world_dst, local, B, ...)
    out = torch.empty_like(buf)
    _alltoall_into(mesh, out, buf)
    # out: (world_src, local, B, ...) -> (local, world_src * B, ...)
    return _back(out.transpose(0, 1).reshape((L, W * B) + rest), send, mesh)


def ppermute(x: torch.Tensor, perm, mesh=None) -> torch.Tensor:
    """``(local, ...)`` rows of this rank's partitions moved along
    ``perm``, a list of ``(source, destination)`` global partition
    pairs: destination ``d`` receives source ``s``'s row, a partition no
    pair names receives zeros (the reference's ``ppermute``)."""
    return ppermute_many([(x, perm)], mesh)[0]


def ppermute_many(items, mesh=None):
    """Several :func:`ppermute` calls as one round: ``items`` is a list
    of ``(x, perm)`` whose rows share one shape and dtype; returns their
    results in order.  Over a group,
    every row this rank sends to one peer travels in one message, and
    every rank posts its sends and receives for the round in one
    ``batch_isend_irecv``, peers in ascending rank, so the ranks pair
    up alike; rows that stay on this rank are copied.  Bytes sent to
    other ranks count in ``mesh.sent_bytes``."""
    if not _spans(mesh):
        out = []
        for x, perm in items:
            y = torch.zeros_like(x)
            # one copy a pair: no index tensor crosses from the host, so
            # the round can be captured into a stage program's graph
            for s, d in perm:
                y[d] = x[s]
            out.append(y)
        return out
    L, base, me = mesh.local, mesh.base, mesh.rank
    if _polled(mesh):
        # gloo's point-to-point waits cannot be polled: every rank's rows
        # to every rank, each keeping those its pairs name
        outs = []
        for x, perm in items:
            g = gather_rows(x, mesh)
            y = torch.zeros_like(x)
            for s, d in perm:
                if base <= d < base + L:
                    y[d - base] = g[s]
            outs.append(y)
        return outs
    outs = [torch.zeros_like(x) for x, _ in items]
    sends: Dict[int, list] = {}  # peer -> [(item, local source row)]
    recvs: Dict[int, list] = {}  # peer -> [(item, local destination row)]
    for k, (x, perm) in enumerate(items):
        for s, d in perm:
            sr, dr = s // L, d // L
            if sr == me and dr == me:
                outs[k][d - base] = x[s - base]
            elif sr == me:
                sends.setdefault(dr, []).append((k, s - base))
            elif dr == me:
                recvs.setdefault(sr, []).append((k, d - base))
    out_msgs, landing = [], []
    for peer in sorted(set(sends) | set(recvs)):
        if peer in sends:
            rows = torch.stack([items[k][0][i] for k, i in sends[peer]])
            out_msgs.append((peer, _wire(mesh, rows)))
        if peer in recvs:
            k0 = recvs[peer][0][0]
            like = items[k0][0]
            dev = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
            dt = torch.uint8 if like.dtype == torch.bool else like.dtype
            buf = torch.empty((len(recvs[peer]),) + tuple(like.shape[1:]), dtype=dt, device=dev)
            landing.append((peer, buf))
    _p2p(mesh, out_msgs, landing)
    for peer, buf in landing:
        rows = _back(buf, outs[recvs[peer][0][0]], mesh)
        for j, (k, i) in enumerate(recvs[peer]):
            outs[k][i] = rows[j]
    return outs


def first_valid(col: torch.Tensor, valid: torch.Tensor, mesh=None):
    """The value of the first valid row in global order, on the host,
    or None when no partition holds a valid row."""
    vals = col.reshape(-1)[valid.reshape(-1)][:1]
    if not _spans(mesh):
        return vals.cpu()[0] if len(vals) else None
    has = torch.tensor([len(vals)], dtype=torch.int64, device=col.device)
    one = vals if len(vals) else torch.zeros(1, dtype=col.dtype, device=col.device)
    hs, vs = gather_ranks(has, mesh).reshape(-1), gather_ranks(one, mesh).reshape(-1)
    settle(mesh)
    hs, vs = hs.cpu(), vs.cpu()
    at = (hs > 0).nonzero()
    return vs[int(at[0])] if len(at) else None
