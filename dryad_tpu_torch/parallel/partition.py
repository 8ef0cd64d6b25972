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
``all_to_all(tiled=True)``         transpose of           ``all_to_all_single`` of the
                                   ``(P, P, B)``          ``(world, local, local, B)``
                                                          send buffer
``axis_index``                     ``arange(P)``          ``rank * local + arange(local)``
exclusive prefix over partitions   ``cumsum(0) - x``      ``all_gather``, then the same
``ppermute``                       an index of axis 0     ``batch_isend_irecv``, one send
                                                          and one receive a peer rank
=================================  ====================  ================================

A group of the ``gloo`` backend carries CUDA tensors through the host
(each collective copies its operand to the CPU and the result back);
``nccl`` takes them on the card.  Every call blocks on or orders after
the group's timeout (``init_distributed``): a rank that never reaches a
collective fails its peers' call instead of hanging them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def block_layout(
    phys: Dict[str, np.ndarray],
    P: int,
    partition_capacity: Optional[int] = None,
    rows: Optional[slice] = None,
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Block-partition encoded physical columns on the host.

    Partition p holds rows ``[p*per, (p+1)*per)`` with
    ``per = ceil(n / P)`` (``cap = per`` unless given), exactly as
    ``dryad_tpu/parallel/distribute.py::from_physical_table``, so the
    partition-major order equals the original row order.  Returns
    ``(P, cap)`` host arrays and the ``(P, cap)`` valid mask; with
    ``rows``, only those partitions of the layout (a rank's own)."""
    names = list(phys.keys())
    n = len(np.asarray(phys[names[0]])) if names else 0
    per = -(-n // P) if n else 1
    cap = partition_capacity if partition_capacity is not None else per
    if cap < per:
        raise ValueError(f"partition_capacity {cap} < required {per}")
    parts = range(P)[rows] if rows is not None else range(P)
    sizes = [min((p + 1) * per, n) - min(p * per, n) for p in parts]
    data = {}
    for c in names:
        a = np.asarray(phys[c])
        if cap == per and n == P * per:
            # exact fit: a view, no copy
            data[c] = a.reshape(P, cap)[parts.start : parts.stop]
            continue
        pad = np.zeros((len(parts), cap) + a.shape[1:], a.dtype)
        for i, (p, m) in enumerate(zip(parts, sizes)):
            lo = min(p * per, n)
            pad[i, :m] = a[lo : lo + m]
        data[c] = pad
    valid = np.zeros((len(parts), cap), np.bool_)
    for i, m in enumerate(sizes):
        valid[i, :m] = True
    return data, valid


# -- transport -----------------------------------------------------------------

def _spans(mesh) -> bool:
    return mesh is not None and mesh.group is not None


def _wire(mesh, t: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous copy of ``t`` where the group's backend takes
    it: the host for ``gloo`` (which stages CUDA tensors), the mesh's
    card for ``nccl``.  Bools travel as uint8."""
    dev = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
    dt = torch.uint8 if t.dtype == torch.bool else t.dtype
    buf = torch.empty(t.shape, dtype=dt, device=dev).copy_(t)
    mesh.sent_bytes += buf.numel() * buf.element_size()
    return buf


def _back(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return buf.to(device=like.device, dtype=like.dtype)


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def allreduce(t: torch.Tensor, op: str, mesh=None) -> torch.Tensor:
    """``t`` reduced elementwise over the ranks (``op`` sum, max or
    min); ``t`` itself with no group."""
    if not _spans(mesh):
        return t
    buf = _wire(mesh, t)
    dist.all_reduce(buf, op=getattr(dist.ReduceOp, _OPS[op]), group=mesh.group)
    return _back(buf, t)


def gather_ranks(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """Every rank's ``t`` stacked rank-major: ``(world, *t.shape)``."""
    if not _spans(mesh):
        return t.unsqueeze(0)
    buf = _wire(mesh, t).reshape(-1)
    out = torch.empty(mesh.world * buf.numel(), dtype=buf.dtype, device=buf.device)
    if hasattr(dist, "all_gather_single"):
        dist.all_gather_single(out, buf, group=mesh.group)
    else:
        dist.all_gather_into_tensor(out, buf, group=mesh.group)
    return _back(out.reshape((mesh.world,) + tuple(t.shape)), t)


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
    if hasattr(dist, "reduce_scatter_single"):
        dist.reduce_scatter_single(out, buf, op=dist.ReduceOp.SUM, group=mesh.group)
    else:
        dist.reduce_scatter_tensor(out, buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return _back(out, s).reshape(mesh.local, -1)


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
    dist.all_to_all_single(out, buf, group=mesh.group)
    # out: (world_src, S_src, local_dst, B, ...) -> (local_dst, P * B, ...)
    recv = out.permute((2, 0, 1, 3) + tuple(range(4, out.dim())))
    return _back(recv.reshape((L, W * S * B) + rest), send)


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
    ops, landing = [], []
    for peer in sorted(set(sends) | set(recvs)):
        if peer in sends:
            rows = torch.stack([items[k][0][i] for k, i in sends[peer]])
            ops.append(dist.P2POp(dist.isend, _wire(mesh, rows), peer, group=mesh.group))
        if peer in recvs:
            k0 = recvs[peer][0][0]
            like = items[k0][0]
            dev = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
            dt = torch.uint8 if like.dtype == torch.bool else like.dtype
            buf = torch.empty((len(recvs[peer]),) + tuple(like.shape[1:]), dtype=dt, device=dev)
            ops.append(dist.P2POp(dist.irecv, buf, peer, group=mesh.group))
            landing.append((peer, buf))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for peer, buf in landing:
        rows = _back(buf, outs[recvs[peer][0][0]])
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
    hs = gather_ranks(has, mesh).reshape(-1).cpu()
    vs = gather_ranks(one, mesh).reshape(-1).cpu()
    at = (hs > 0).nonzero()
    return vs[int(at[0])] if len(at) else None
