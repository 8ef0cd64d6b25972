"""Ranks as threads: one context whose partitions lie over several cards.

The counterpart of the reference's single-controller mode
(``dryad_tpu/parallel/mesh.py::make_mesh`` over ``jax.devices()``): one
process holds every partition, one device's share on each device, and
every collective runs inside one program.  Here
``DryadContext(devices=...)`` builds one rank a card, as a gang worker
does (``cluster/worker.py``), but as a persistent thread of the driver's
process instead of a process: each rank owns a
:class:`~dryad_tpu_torch.parallel.mesh.PartitionMesh` of ``P / D``
partitions on its card over a group made in the process, so the stage
ops' collectives (``parallel/partition.py``), the stage programs and the
device loop run as they do in a gang, with no job package, no pickling
and no partition files.

- :class:`RankGroup` starts the threads (each makes its card current
  once), makes the group and each rank's mesh, and runs one function on
  every rank at once (:meth:`RankGroup.run`).  The group is made over a
  shared ``HashStore``: ``ProcessGroupNCCL`` when every rank has a card
  of its own, ``ProcessGroupGloo`` when two ranks share a card or run on
  the CPU (``multihost.choose_backend`` decides, as for a gang).  For a
  hybrid mesh (``dcn_slices``) it also makes each rank's two
  sub-groups, its slice's cards and the cards at its position in every
  slice, each under a prefix of its own and connected eagerly as the
  group is.
- :class:`RankLink` is what the ranks of one group share: the cards,
  the abort flag every wait of a rank watches, and a host exchange of
  Python values among the threads (checkpoint files, injected faults,
  the device loop's one-at-a-time check).
- :class:`RankBatches` is a result over the ranks: each rank's
  ``(local, cap)`` batch on its card, in partition order.

A rank that raises fails the whole run: the group's abort flag is set,
so a rank waiting on it (in a collective over gloo, in ``settle`` over
NCCL, in the host exchange) raises
:class:`~dryad_tpu_torch.parallel.partition.GangStageError`; an NCCL
group is aborted; and the group is made anew before the next run.  The
error names the failed rank and the stage it ran.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import datetime
import os
import queue
import socket
import threading
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dryad_tpu_torch.parallel.mesh import AXIS, DCN_AXIS, PartitionMesh
from dryad_tpu_torch.parallel.multihost import NCCL_WATCHDOG_FACTOR, choose_backend
from dryad_tpu_torch.parallel.partition import GangStageError, allreduce
from dryad_tpu_torch.utils.logging import get_logger

log = get_logger("dryad_tpu_torch.parallel.ranks")

__all__ = ["RankBatches", "RankGroup", "RankLink", "exclusive", "resolve_devices"]

# seconds a failed run waits for the other ranks to raise the same
# error by themselves (no abort then), to notice the abort, and for the
# group's abort to return
ALIKE_GRACE_S = 2.0
ABORT_GRACE_S = 5.0
ABORT_WAIT_S = 10.0

# groups given up on after a failure: a gloo collective cannot be
# cancelled, and dropping the group would wait for it in its destructor;
# each ends at the group's timeout
_ABANDONED: List[list] = []


def resolve_devices(devices) -> List[torch.device]:
    """The cards of a context over several devices: an int ``n`` is the
    first ``n`` visible cards, a list names each device (``"cpu"``
    repeated runs the ranks on the CPU).  A card the host lacks raises;
    nothing falls back to fewer cards or to the CPU."""
    if isinstance(devices, int):
        n = devices
        if n < 1:
            raise ValueError(f"devices={n}: a context needs at least one card")
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise ValueError(f"devices={n}: this host has {have} CUDA cards")
        return [torch.device("cuda", i) for i in range(n)]
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("devices=[]: a context needs at least one device")
    for d in out:
        if d.type == "cuda":
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if d.index is None or d.index >= have:
                raise ValueError(
                    f"device {d}: name a card by its index; this host has {have} CUDA cards")
        elif d.type != "cpu":
            raise ValueError(f"device {d}: only CUDA cards and the CPU are supported")
    return out


_MISSING = object()


class RankLink:
    """What the in-process ranks of one group share (``mesh.link``)."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self.world = len(self.devices)
        self.abort = threading.Event()
        self._cv = threading.Condition()
        self._round = [0] * self.world
        self._slots: Dict[int, list] = {}
        self.solo = threading.Lock()

    def set_abort(self) -> None:
        with self._cv:
            self.abort.set()
            self._cv.notify_all()

    def exchange(self, rank: int, value, what: str = "the host exchange") -> list:
        """Every rank's ``value``, rank-major: an all-gather of Python
        values among the threads (each rank calls it in the same order).
        Raises :class:`GangStageError` once the group is aborted."""
        with self._cv:
            n = self._round[rank]
            self._round[rank] += 1
            slot = self._slots.setdefault(n, [[_MISSING] * self.world, 0])
            slot[0][rank] = value
            self._cv.notify_all()
            while any(v is _MISSING for v in slot[0]):
                if self.abort.is_set():
                    raise GangStageError(
                        f"{what} failed on rank {rank} of {self.world}: the group was "
                        "aborted (a peer rank failed)")
                self._cv.wait(0.05)
            slot[1] += 1
            values = list(slot[0])
            if slot[1] == self.world:
                del self._slots[n]
            return values


@contextlib.contextmanager
def exclusive(mesh):
    """Run the body on one rank of an in-process group at a time while
    the others wait on the host, reading nothing: for a check that
    switches a process-wide mode (``exec/devloop.py``'s host-read
    check).  Elsewhere it runs the body as it is."""
    link = getattr(mesh, "link", None)
    if link is None:
        yield
        return
    link.exchange(mesh.rank, None, "the device loop's check")
    try:
        with link.solo:
            yield
    finally:
        link.exchange(mesh.rank, None, "the device loop's check")


class _RankThread:
    """A persistent thread that serves one rank: its card made current
    once, then each submitted function in turn."""

    def __init__(self, device: torch.device, rank: int):
        self.device = device
        self._stopped = False
        self._q: "queue.Queue" = queue.Queue()
        self._t = threading.Thread(target=self._serve, name=f"dryad-rank-{rank}", daemon=True)
        self._t.start()

    def _serve(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, fut = item
            del item
            if fut.set_running_or_notify_cancel():
                try:
                    fut.set_result(fn())
                except BaseException as e:  # noqa: BLE001 - handed to the driver
                    fut.set_exception(e)
            # hold nothing of the job between jobs: the group and the
            # contexts are freed where the context is, never on this thread
            del fn, fut

    def submit(self, fn: Callable[[], object]) -> cf.Future:
        fut: cf.Future = cf.Future()
        if self._stopped:
            fut.set_exception(RuntimeError(
                f"the rank thread of {self.device} has stopped (its context was rebuilt)"))
            return fut
        self._q.put((fn, fut))
        return fut

    def stop(self) -> None:
        self._stopped = True
        self._q.put(None)
        if threading.current_thread() is not self._t:
            self._t.join(timeout=60.0)


def _new_group(backend: str, store, rank: int, world: int, timeout: float):
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = datetime.timedelta(seconds=timeout * NCCL_WATCHDOG_FACTOR)
        return dist.ProcessGroupNCCL(store, rank, world, opts)
    return dist.ProcessGroupGloo(store, rank, world, datetime.timedelta(seconds=timeout))


def _connect(mesh: PartitionMesh) -> None:
    """Every kind of collective the stage ops run, once, eagerly, on
    every rank at once: the communicator starts, and NCCL sets up the
    connections each kind needs (its peer-to-peer ones at their first
    use) here, where every rank's thread reaches them together, and not
    inside a capture, where the host blocks until the peers connect
    while they wait to capture in turn."""
    from dryad_tpu_torch.parallel import partition as PART

    dev, W = mesh.device, mesh.world
    allreduce(torch.zeros((), dtype=torch.int64, device=dev), "sum", mesh)
    # over NCCL a small and a large message (their protocols differ);
    # gloo's ranks are connected when the group is made
    for n in ((W, W << 20) if mesh.backend == "nccl" else (W,)):
        x = torch.zeros(n, dtype=torch.int64, device=dev)
        PART._allgather_into(mesh, torch.empty(n * W, dtype=x.dtype, device=dev), x)
        PART._reduce_scatter_into(mesh, torch.empty(n // W, dtype=x.dtype, device=dev), x.clone())
        PART._alltoall_into(mesh, torch.empty_like(x), x)
        if mesh.backend == "nccl":  # gloo's ranks in one process never send point to point
            peers = [p for p in range(W) if p != mesh.rank]
            PART._p2p(mesh, [(p, x[:n // W].clone()) for p in peers],
                      [(p, torch.empty(n // W, dtype=x.dtype, device=dev)) for p in peers])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class RankGroup:
    """The rank threads of one context over several cards, their group
    and each rank's context (``make_context(mesh)``, kept across groups:
    a new group re-attaches it, ``attach(ctx, mesh)``)."""

    def __init__(self, devices: Sequence[torch.device], num_partitions: int, timeout: float,
                 make_context: Callable, attach: Callable, dcn_slices: Optional[int] = None):
        self.devices = list(devices)
        self.world = len(self.devices)
        self.P = int(num_partitions)
        if self.P < 1 or self.P % self.world:
            raise ValueError(
                f"num_partitions {self.P} is not a multiple of the {self.world} devices "
                "(every card holds the same number of partitions)")
        # a hybrid mesh over the cards: dcn_slices slices of whole cards
        if dcn_slices is not None and (dcn_slices < 1 or self.world % dcn_slices):
            raise ValueError(f"dcn_slices {dcn_slices} does not divide the {self.world} devices: "
                             "a DCN slice holds whole cards")
        self.dcn_slices = dcn_slices
        self.timeout = float(timeout)
        host = socket.gethostname()
        self.backend = choose_backend([f"{host}/{d}" for d in self.devices])
        self._make_context, self._attach = make_context, attach
        self.contexts: list = [None] * self.world
        self.meshes: List[PartitionMesh] = []
        self.link: Optional[RankLink] = None
        self.groups: list = []
        self.generation = 0
        self.broken = self.fresh_streams = False
        self._threads = [_RankThread(d, r) for r, d in enumerate(self.devices)]
        self._build()

    # -- the group ---------------------------------------------------------------
    def _build(self) -> None:
        """A fresh group and a mesh a rank over it; every rank's first
        collective runs now, eagerly (an NCCL communicator must not start
        inside a capture)."""
        self.generation += 1
        if self.backend == "nccl":
            # as parallel/multihost.py::init_distributed: NCCL's watchdog
            # aborts without ending the process, and a captured WHILE body
            # holds no event node of NCCL's graph mixing; and every
            # algorithm's connections made when the communicator starts
            os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2")
            os.environ.setdefault("NCCL_GRAPH_MIXING_SUPPORT", "0")
            os.environ.setdefault("NCCL_RUNTIME_CONNECT", "0")
        link = RankLink(self.devices)
        store = dist.PrefixStore(f"ranks/{id(self)}/{self.generation}/", dist.HashStore())
        D = self.dcn_slices or 1
        C = self.world // D

        fresh = self.fresh_streams

        def make(r: int) -> PartitionMesh:
            if self.devices[r].type == "cuda":
                from dryad_tpu_torch.ops import bucket as BK

                if fresh:
                    torch.cuda.set_stream(torch.cuda.Stream(self.devices[r]))
                BK.preload(self.devices[r])  # the kernels load before any collective waits
            pg = _new_group(self.backend, store, r, self.world, self.timeout)
            # a hybrid mesh's sub-groups: the slice's C cards (ICI) and the
            # D cards at this position in every slice (DCN), each under a
            # prefix of its own; an axis of one card stays on the card
            d, q = divmod(r, C)
            ici = (_new_group(self.backend, dist.PrefixStore(f"ici{d}/", store), q, C,
                              self.timeout) if self.dcn_slices and C > 1 else None)
            dcn = (_new_group(self.backend, dist.PrefixStore(f"dcn{q}/", store), d, D,
                              self.timeout) if self.dcn_slices and D > 1 else None)
            mesh = PartitionMesh(self.P, self.devices[r], rank=r, world=self.world, group=pg,
                                 backend=self.backend, timeout=self.timeout, link=link,
                                 dcn_slices=self.dcn_slices, ici_group=ici, dcn_group=dcn)
            _connect(mesh)
            if self.dcn_slices:  # every rank: the whole group, then ICI, then DCN
                for axis in (AXIS, DCN_AXIS):
                    sub = mesh.axis_mesh(axis)
                    if sub.group is not None:
                        _connect(sub)
            return mesh

        self.meshes = self._each(make)
        self.link = link
        self.groups = [g for m in self.meshes for g in (m.group, m.ici_group, m.dcn_group)
                       if g is not None]
        for r, mesh in enumerate(self.meshes):
            if self.contexts[r] is None:
                self.contexts[r] = self._make_context(mesh)
            else:
                self._attach(self.contexts[r], mesh)
        self.broken = self.fresh_streams = False

    def _each(self, fn: Callable[[int], object]) -> list:
        futs = [t.submit(lambda r=r: fn(r)) for r, t in enumerate(self._threads)]
        return [f.result() for f in futs]

    def abort(self) -> None:
        """Give the group up: every waiting rank raises, the group and its
        sub-groups are aborted (NCCL's kernels stop; gloo's pending work ends at its
        timeout) on a thread of its own, waited for ``ABORT_WAIT_S`` at
        most, and the next run makes a new group, each rank on a fresh
        stream (work queued behind a collective that never completes
        stays there)."""
        if self.link is not None:
            self.link.set_abort()
        groups = self.groups
        _ABANDONED.append(groups)

        def abort_all():
            for pg in groups:
                try:
                    pg.abort()
                except RuntimeError:
                    pass  # already torn down by its watchdog

        t = threading.Thread(target=abort_all, name="dryad-rank-abort", daemon=True)
        t.start()
        t.join(ABORT_WAIT_S)
        self.broken = self.fresh_streams = True

    # -- running ------------------------------------------------------------------
    def run(self, fn: Callable[[object], object]) -> list:
        """``[fn(ctx_r) for each rank]``, every rank on its thread at
        once.  An error every rank raised alike (the engine's own
        decision over reduced flags, at the same point of the program)
        is raised as it is.  Otherwise a rank that raised aborts the
        group and the run raises :class:`GangStageError` naming the rank
        and its stage, chained to the rank's own error (the first rank's
        that is not a peer's abort); each rank's error is logged first."""
        if self.broken:
            self._build()
        futs = [t.submit(lambda c=c: fn(c)) for t, c in zip(self._threads, self.contexts)]
        done, pending = cf.wait(futs, return_when=cf.FIRST_EXCEPTION)
        if not pending and all(f.exception() is None for f in futs):
            return [f.result() for f in futs]
        cf.wait(pending, timeout=ALIKE_GRACE_S)  # do the others raise the same?
        errors = {i: f.exception() for i, f in enumerate(futs) if f.done() and f.exception()}
        if len(errors) == self.world and len({(type(e), str(e)) for e in errors.values()}) == 1:
            return _raise(errors[0])
        self.link.set_abort()
        cf.wait([f for f in futs if not f.done()], timeout=ABORT_GRACE_S)
        errors = {i: f.exception() for i, f in enumerate(futs) if f.done() and f.exception()}
        for i, e in sorted(errors.items()):
            log.warning("rank %d of %d (%s) failed in stage %r: %s", i, self.world, self.devices[i],
                        self.meshes[i].stage, "".join(traceback.format_exception(e)))
        self.abort()
        cf.wait([f for f in futs if not f.done()], timeout=self.timeout)
        own = [i for i in sorted(errors) if not _is_abort(errors[i])]
        r = own[0] if own else min(errors)
        e = errors[r]
        stage = self.meshes[r].stage or "the job"
        raise GangStageError(
            f"stage {stage!r} failed on rank {r} of {self.world} ({self.devices[r]}): "
            f"{type(e).__name__}: {e}") from e

    def local(self, fn: Callable[[int], object]) -> list:
        """``[fn(r) for each rank]``, each on its rank's thread, for work
        that holds no collective (a copy to the host, a gather of one
        rank's rows): it may run between two jobs of the ranks, in any
        order across them.  An error every rank raised alike is raised
        as it is; otherwise the first failed rank's error is raised as
        :class:`GangStageError` naming the rank."""
        futs = [t.submit(lambda r=r: fn(r)) for r, t in enumerate(self._threads)]
        cf.wait(futs)
        errors = {i: f.exception() for i, f in enumerate(futs) if f.exception() is not None}
        if not errors:
            return [f.result() for f in futs]
        if len(errors) == self.world and len({(type(e), str(e)) for e in errors.values()}) == 1:
            return _raise(errors[0])
        r = min(errors)
        e = errors[r]
        raise GangStageError(
            f"a host read of the result failed on rank {r} of {self.world} ({self.devices[r]}): "
            f"{type(e).__name__}: {e}") from e

    def close(self) -> None:
        for t in self._threads:
            t.stop()


def _raise(e: BaseException):
    raise e


def _is_abort(e: BaseException) -> bool:
    return isinstance(e, GangStageError) and "aborted" in str(e)


class RankBatches:
    """A result over the ranks of one context: ``parts[r]`` is rank r's
    ``(local, cap)`` batch on its card, so partition ``r * local + i``
    is ``parts[r]``'s row ``i``.

    Shape metadata is read where it is called; every device operation
    on a part runs on its rank's thread (``group.local``): after an
    abort a rank works on a stream of its own, so a copy made on another
    thread would race the rank's work.  ``nominal_rows``, when set, is the layout rows the
    one-card batch would count (``exec/combinetree.py::layout_rows``)."""

    def __init__(self, parts: Sequence, group: Optional["RankGroup"] = None):
        self.parts = list(parts)
        self.group = group
        self.nominal_rows: Optional[int] = None

    @property
    def num_partitions(self) -> int:
        return sum(p.num_partitions for p in self.parts)

    @property
    def capacity(self) -> int:
        return self.parts[0].capacity

    def nbytes(self) -> int:
        return sum(p.nbytes() for p in self.parts)

    def each(self, fn: Callable[[object], object]) -> list:
        """``[fn(parts[r]) for each rank]``, each on its rank's thread."""
        if self.group is None:
            return [fn(p) for p in self.parts]
        return self.group.local(lambda r: fn(self.parts[r]))

    def map(self, fn: Callable[[object], object]) -> "RankBatches":
        """The batches ``fn(parts[r])``, each made on its rank's thread."""
        return RankBatches(self.each(fn), self.group)

    def fetch_valid_rows(self, with_counts: bool = False):
        """Each rank's valid rows, concatenated in partition order (the
        one-card batch's flat order)."""
        got = self.each(lambda p: p.fetch_valid_rows(with_counts=True))
        return join_rows(got, with_counts)

    def to_numpy(self, schema, dictionary=None) -> Dict[str, np.ndarray]:
        """The valid rows as host logical columns, in partition order."""
        from dryad_tpu_torch.columnar.batch import decode_physical_table

        return decode_physical_table(schema, slice(None), self.fetch_valid_rows(), dictionary)


def join_rows(got: Sequence[tuple], with_counts: bool = False):
    """``[(columns, counts) per rank]`` -> the columns (and counts) of
    the whole table, in partition order."""
    cols = {c: np.concatenate([g[0][c] for g in got]) for c in got[0][0]}
    if not with_counts:
        return cols
    return cols, np.concatenate([g[1] for g in got])
