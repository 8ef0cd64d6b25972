"""The on-device ``do_while``: one loop program per (body stage,
condition stage, carry layout, ``max_iter``, boost).

The counterpart of the ``lax.while_loop`` program that the reference's
``dryad_tpu/exec/executor.py::_run_do_while_device`` compiles.  The
body and the condition are one lowered stage each, given here as
functions of a batch (the executor runs their ops, ``exec/kernels.py::
run_ops``).  The loop is DoWhile: the body runs once, then the loop
continues while ``(i < max_iter) & go & ~overflow``, ``go`` being the
condition column's first element.  After the loop the condition runs
once more on the final state, so that an overflow in it is not lost.

- On CUDA (:meth:`LoopProgram.run`) the loop is ONE CUDA graph,
  captured at the first run on a private memory pool and replayed for
  every later one.  The carry lives in fixed buffers: the graph zeroes
  the loop state, applies the body, copies its outputs into the carry,
  runs the condition's ops and the loop-control kernel
  (``ops/loopctl.py``), which sets a WHILE conditional node; the node's
  body graph repeats the same round.  A run copies the input into the
  carry, replays the graph and reads the loop state ``(overflow, iters,
  miss)`` in ONE device-to-host copy, whatever the number of rounds.
- Its plain version (:meth:`LoopProgram.run_plain`) runs the same stage
  functions and the kernel's plain twin in a Python loop that reads the
  predicate each round: the CPU's path, and the card's comparison.
- Over a process group (``mesh``) the stage functions cross ranks
  through ``torch.distributed`` collectives.  Over NCCL (each rank on a
  card of its own) a rank's loop is the same one graph, the collectives
  of every round captured in it, as the reference's ``lax.while_loop``
  holds its own.  A gloo group stages them through the host, which a
  CUDA graph cannot hold: such a loop (``eager``) runs the plain
  version.  The executor decides this from the mesh before any capture,
  as it decides its stage programs (``exec/programs.py::graphs_for``),
  and logs ``do_while_device_start`` and ``_done`` either way.  Every
  rank must run the same rounds, so over a group the loop-control step
  reads the condition of global partition 0, gathered from its rank
  (the replicated value of a whole-table aggregate, the reference's
  ``couts[0].data[cond_col][0]`` on a one-process mesh); a rank's bytes
  to the group count every round a replay runs; and a host read of the
  loop state waits for the group at most its timeout
  (``parallel/partition.py::settle``).

:meth:`LoopProgram.check` is the trace-time check of the reference: it
applies the body and the condition once and raises ``TypeError`` when
the body changes the carry (its columns, their types or the capacity),
and the executor then falls back to its driver loop; or, on CUDA, it
raises :class:`HostReadError` (a ``TypeError``) when either reads a
value to the host (run under ``torch.cuda.set_sync_debug_mode
("error")``), and the executor raises it: the driver loop's stage
programs would refuse the same read in their capture, as the
reference's trace raises ``ConcretizationTypeError`` in both loops.  On
the CPU a read to the host cannot be seen, so such a body runs here
(ROADMAP.md, section 3).  Nothing gives way to the plain version on a
card: a capture or launch error raises.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from dryad_tpu_torch.columnar.batch import ColumnBatch
from dryad_tpu_torch.ops import bucket as BK
from dryad_tpu_torch.ops import loopctl as LC
from dryad_tpu_torch.parallel import partition as PART
from dryad_tpu_torch.parallel.ranks import exclusive

# body(batch) -> (batch, overflow flag, miss count); cond(batch) -> (batch, overflow flag)
BodyFn = Callable[[ColumnBatch], Tuple[ColumnBatch, torch.Tensor, torch.Tensor]]
CondFn = Callable[[ColumnBatch], Tuple[ColumnBatch, torch.Tensor]]


class LoopResult(NamedTuple):
    batch: ColumnBatch
    overflow: bool
    iters: int
    miss: torch.Tensor  # int64 0-d tensor on the loop's device


class HostReadError(TypeError):
    """A loop's body or condition reads a device value on the host."""


def _layout(b: ColumnBatch) -> Tuple:
    return (
        tuple(sorted((n, t.dtype, tuple(t.shape)) for n, t in b.data.items())),
        b.valid.dtype, tuple(b.valid.shape),
    )


@contextlib.contextmanager
def _sync_is_error(device: torch.device):
    """On CUDA, a synchronising call (a read to the host) raises."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():  # "a prototype feature"
        warnings.simplefilter("ignore", UserWarning)
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def _capturing(graph, pool, stream, device: torch.device):
    """``torch.cuda.graph``'s capture on ``stream`` without its
    device-wide ``synchronize`` and ``empty_cache``: the latter frees
    cached blocks on every card, which waits on every card, and a rank
    of a context over several cards touches only its own (another's may
    hold a collective that waits on this one)."""
    from dryad_tpu_torch.exec.programs import CAPTURE_LOCK

    stream.wait_stream(torch.cuda.current_stream(device))
    with CAPTURE_LOCK, torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            yield
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass  # the capture was invalidated by the error being raised
            raise
        graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(stream)


@contextlib.contextmanager
def _thread_to_pool(device: torch.device, pool):
    """Inside a capture on ``pool``: route every allocation this thread
    makes to the pool, on whatever stream (the capture routes only its
    own stream's, and the WHILE node's body records on a second one).
    The capture's end removes the routing; the caller releases the extra
    reference to the pool once the capture has ended."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    torch._C._cuda_endAllocateToPool(idx, pool)  # the capture stream's routing
    torch._C._cuda_beginAllocateCurrentThreadToPool(idx, pool)
    yield


class LoopProgram:
    """One do_while loop over a fixed carry layout."""

    def __init__(self, body: BodyFn, cond: CondFn, cond_col: str, max_iter: int, device,
                 eager: bool = False, mesh=None, name: str = "do_while"):
        self.body = body
        self.cond = cond
        self.cond_col = cond_col
        self.max_iter = int(max_iter)
        self.device = torch.device(device)
        # the Python round loop on every device: a gloo group's
        # collectives stage through the host, which a CUDA graph cannot
        # hold (set from the mesh before any capture)
        self.eager = bool(eager)
        self.mesh = mesh  # the process group the stage functions cross, or None
        self.name = name  # the stage a failed collective names
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.carry: Optional[ColumnBatch] = None
        self.state: Optional[torch.Tensor] = None
        # set at capture: seconds it took, bytes its private pool reserved
        self.capture_s: Optional[float] = None
        self.pool_bytes = 0
        # bucket-kernel launches the capture recorded: the first round,
        # a round of the WHILE body, the final condition; and the bytes
        # each hands to the group
        self._bucket = (0, 0, 0)
        self._sent = (0, 0, 0)

    # -- the reference's trace-time check ---------------------------------------
    def check(self, current: ColumnBatch):
        """Apply the body and then the condition once; raise TypeError
        when the body changes the carry, :class:`HostReadError` when
        either reads a value to the host (CUDA).  Returns the body's
        ``(batch, overflow, miss)``."""
        on_card = not self.eager and self.device.type == "cuda"
        try:
            # the sync check is process-wide: the ranks of a context over
            # several cards take it one at a time, the others parked
            with exclusive(self.mesh if on_card else None), \
                    _sync_is_error(self.device if on_card else torch.device("cpu")):
                out = self.body(current)
                self.cond(out[0])
        except RuntimeError as e:
            if "synchronizing" not in str(e):
                raise
            raise HostReadError(f"do_while subplan reads a device value on the host: {e}") from e
        if _layout(out[0]) != _layout(current):
            raise TypeError(
                "do_while body changes the loop carry "
                f"({_layout(current)} -> {_layout(out[0])})"
            )
        return out

    # -- the plain version --------------------------------------------------------
    def run_plain(self, current: ColumnBatch, first=None) -> LoopResult:
        """The loop in Python: the same stage functions and the kernel's
        plain twin, the predicate read each round.  ``first``: the
        body's first application, when :meth:`check` made it."""
        st = torch.zeros(4, dtype=torch.int64, device=self.device)
        b, bovf, bmiss = first if first is not None else self.body(current)
        while True:
            c, covf = self.cond(b)
            LC.loop_step_plain(st, bovf, bmiss, self._go(c), covf, self.max_iter)
            PART.settle(self.mesh, self.name)
            if not bool(st[3]):
                break
            b, bovf, bmiss = self.body(b)
        _, covf = self.cond(b)
        PART.settle(self.mesh, self.name)
        overflow = bool(st[1]) or bool(covf)
        return LoopResult(b, overflow, int(st[0]), st[2].clone())

    def _go(self, c: ColumnBatch) -> torch.Tensor:
        """The condition column the step reads (its first element): over
        a group, global partition 0's first row, gathered to every rank
        so that every rank runs the same rounds."""
        col = c.data[self.cond_col]
        if self.mesh is None or self.mesh.group is None:
            return col
        return PART.gather_rows(col.reshape(col.shape[0], -1)[:, :1], self.mesh)

    # -- the graph ------------------------------------------------------------------
    def run(self, current: ColumnBatch, first=None) -> LoopResult:
        """The loop on the loop's device: one graph replay on CUDA, the
        plain version on the CPU and for an eager (gloo gang) loop."""
        if self.device.type == "cpu" or self.eager:
            return self.run_plain(current, first)
        if self.device.type != "cuda":
            raise ValueError(f"do_while device loop: unsupported device {self.device}")
        if self.graph is None:
            self._capture(current)
        for n, t in self.carry.data.items():
            t.copy_(current.data[n])
        self.carry.valid.copy_(current.valid)
        self.graph.replay()
        PART.note_dispatch(self.mesh, self.name, graph=True)
        PART.settle(self.mesh, self.name)
        iters, ovf, miss = self.state[:3].cpu().tolist()  # the run's one read
        LC.note_graph_launches(iters)
        rounds = lambda per: per[0] + per[1] * max(0, int(iters) - 1) + per[2]
        BK.note_graph_launches(rounds(self._bucket), self.device)
        if self.mesh is not None:
            self.mesh.sent_bytes += rounds(self._sent)
        out = ColumnBatch({n: t.clone() for n, t in self.carry.data.items()}, self.carry.valid.clone())
        return LoopResult(out, bool(ovf), int(iters), self.state[2].clone())

    def _round(self, handle: int) -> None:
        """One round into the carry: body, copy back, condition, step."""
        out, bovf, bmiss = self.body(self.carry)
        _assign(self.carry, out)
        c, covf = self.cond(self.carry)
        LC.loop_step(self.state, bovf, bmiss, self._go(c), covf, self.max_iter, handle)

    def _capture(self, current: ColumnBatch) -> None:
        from dryad_tpu_torch.exec.programs import card_lock

        with card_lock(self.device):  # the card's captures, one at a time
            self._capture_locked(current)

    def _capture_locked(self, current: ColumnBatch) -> None:
        dev = self.device
        self.carry = ColumnBatch(
            {n: torch.empty_like(t, memory_format=torch.contiguous_format)
             for n, t in current.data.items()},
            torch.empty_like(current.valid, memory_format=torch.contiguous_format),
        )
        self.state = torch.zeros(4, dtype=torch.int64, device=dev)
        LC.runtime_version()  # load the libraries before the capture starts
        BK.preload(dev)
        t0 = time.perf_counter()
        reserved = torch.cuda.memory_reserved(dev)
        sent = lambda: getattr(self.mesh, "sent_bytes", 0)
        sent0 = sent()
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        pool = torch.cuda.graph_pool_handle()  # the graph's private pool
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        try:
            # in one process, torch's capture; a rank of a context over
            # several cards must not wait on the other cards (_capturing)
            if getattr(self.mesh, "link", None) is None:
                capture = torch.cuda.graph(graph, pool=pool, stream=side,
                                           capture_error_mode="thread_local")
            else:
                capture = _capturing(graph, pool, side, dev)
            with capture, _thread_to_pool(dev, pool):
                stream = torch.cuda.current_stream(dev).cuda_stream
                handle = LC.handle_create(stream)
                self.state.zero_()
                marks = [(BK.captured_here(), sent())]
                self._round(handle)
                marks.append((BK.captured_here(), sent()))
                body = LC.while_begin(stream, handle)
                try:
                    with torch.cuda.stream(torch.cuda.ExternalStream(body, device=dev)):
                        self._round(handle)
                finally:
                    LC.while_end(body)
                marks.append((BK.captured_here(), sent()))
                _, covf = self.cond(self.carry)
                self.state[1:2].bitwise_or_(covf.to(torch.int64).reshape(1))
                marks.append((BK.captured_here(), sent()))
        finally:
            torch._C._cuda_releasePool(idx, pool)  # the routing's reference
        self.graph = graph
        self._bucket = tuple(b[0] - a[0] for a, b in zip(marks, marks[1:]))
        self._sent = tuple(b[1] - a[1] for a, b in zip(marks, marks[1:]))
        if self.mesh is not None:
            self.mesh.sent_bytes = sent0  # the capture handed nothing over: its replays do
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_s = time.perf_counter() - t0

    def release(self) -> None:
        """Drop the graph (its private pool goes with it) and the carry."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.carry = self.state = None


def _assign(carry: ColumnBatch, out: ColumnBatch) -> None:
    """Copy a body's outputs into the carry's buffers.  An output that
    shares memory with another carry buffer (a column renamed or
    swapped, a view) is cloned first, so no copy reads a buffer an
    earlier copy has written."""
    dst = dict(carry.data)
    dst[None] = carry.valid
    src: Dict = dict(out.data)
    src[None] = out.valid
    owned = {t.untyped_storage().data_ptr() for t in dst.values()}
    staged = {}
    for n, t in src.items():
        same = t.data_ptr() == dst[n].data_ptr() and t.stride() == dst[n].stride()
        if not same and t.untyped_storage().data_ptr() in owned:
            t = t.clone()
        staged[n] = (t, same)
    for n, (t, same) in staged.items():
        if not same:
            dst[n].copy_(t)
