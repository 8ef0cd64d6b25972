"""Stage programs: each retry unit run as one cached program per
lowering key.

The counterpart of the reference's compile cache
(``dryad_tpu/exec/executor.py``: ``_get_compiled``, ``_CompileTimed``
and ``_lowering_key_hash``).  The reference traces and compiles one XLA
program per key, ``(unit key, boost, shape key, resolved window)``, on
the unit's first dispatch, logs one ``xla_compile`` event and the
``xla_compiles`` / ``xla_compile_s`` metrics for it, and calls the
cached program on every later dispatch.  Here a program is:

- **on the card, in one process** (a flat or hybrid mesh, or a one-rank
  NCCL group): one ``torch.cuda.CUDAGraph``.  The first dispatch copies
  the inputs and the coding tables into buffers the program owns, loads
  the kernel libraries, captures the unit's ops and replays them.  Every
  later dispatch copies its inputs and tables into the same buffers,
  replays, and clones the exports, the overflow flag, the miss counter
  and the row counts out of the graph's memory.  ``trace_s`` is the
  build time, ``compile_s`` the capture and the first replay.
- **on the CPU, and over a gloo group**: the unit's own function, run
  eagerly on every dispatch (a gloo collective cannot be captured);
  ``compile_s`` is the first call's wall time, as the reference's
  ``_CompileTimed`` times its first call.

Which of the two a cache builds is decided from the device and the
mesh before any capture (:func:`graphs_for`), never from a failure: a
capture or replay error raises, naming the unit.  A capture refuses
any transfer between the host and the device (a read like
``int(t.max())``, or a host tensor copied in); it raises ``TypeError``
naming the unit, as the reference's trace raises for a function that
reads a value.  The capture's own error is what is caught, not
``torch.cuda.set_sync_debug_mode``: that mode is process-wide, and
would fail the reads other threads make meanwhile (the stream driver's
prefetcher, a result copy).

Memory.  Every graph of the process captures into one memory pool per
card, on one capture stream: graphs run one at a time under one
process-wide lock, on the dispatching thread's stream, and each run's
outputs are cloned out before the next, so the pool holds the largest
working set and not the sum of them (the input buffers and tables lie
outside it).  The pool goes when its last graph does.  The graphs of
the process share a byte budget, :data:`BUDGET_SHARE` of the card's
memory (or a cache's ``max_bytes``, when set), counting the buffers and
the pool: before and after a capture, and when a job ends, the least
recently used programs are released until the bytes fit, except those
a job used while it is still running (a job never captures its own
units twice); an idle executor's programs are released like any other.
A released key captures again on its next dispatch and logs
``xla_compile`` again, the one place where the port logs compiles the
reference does not, at sizes no CPU test reaches.  An allocation
failure inside a capture releases every other program of the process
and captures once more; a second failure raises.  An allocation
failure in a dispatch outside a capture (a replay's outputs, an eager
program) releases the programs no running job holds, lets the pool go
and runs the dispatch once more (in one process: a rank of a gang
must not run its collectives twice).

A cache's slot is the lowering key and the types of what the program
reads: each input column's dtype and trailing shape, each table's.  The
hashed key holds columns and capacity only, as the reference's, so two
tables of one key with other column types (a ``take(n)`` over int32
and over float32 columns) are two programs under one key hash, and the
second logs a second ``xla_compile`` where the reference's jit traces
again inside its one compile event.
"""

from __future__ import annotations

import itertools
import threading
import time
import weakref
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from dryad_tpu_torch.columnar.batch import ColumnBatch
from dryad_tpu_torch.ops import bucket as BK
from dryad_tpu_torch.parallel import partition as PART
from dryad_tpu_torch.obs import tracectx

__all__ = [
    "BUDGET_SHARE", "PositionalOperands", "ProgramCache", "StageProgram", "graphs_for",
    "lowering_key_hash", "pool_bytes", "types_of",
]

# share of the card's memory that the process's graphs may hold
BUDGET_SHARE = 0.5

# unit fn(inputs, tables) -> (exports, overflow, miss, counts)
UnitFn = Callable[[Sequence[ColumnBatch], Sequence[Tuple[torch.Tensor, ...]]], tuple]

# captures and replays, process-wide: the graphs share one memory pool
_LOCK = threading.RLock()
# every live cache of the process (the byte budget spans them)
_CACHES: "weakref.WeakSet[ProgramCache]" = weakref.WeakSet()
_TICK = itertools.count(1)  # least-recently-used order across caches


class _Pool:
    """The memory pool every graph of the process captures into on one
    card, with the one stream the captures run on (a freed block is
    reused only on its own stream), the bytes the captures reserved for
    it and the graphs that use it.  Graphs run one at a time and their
    outputs are cloned out before the next runs, so one graph's
    intermediates may lie where another's were: the pool holds the
    largest working set, not their sum."""

    def __init__(self, device: torch.device):
        self.handle = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.bytes = 0
        self.graphs = 0


_POOLS: Dict[int, _Pool] = {}  # card index -> its pool, while a graph uses it


def _card(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _pool(device: torch.device) -> _Pool:
    idx = _card(device)
    if idx not in _POOLS:
        _POOLS[idx] = _Pool(device)
    return _POOLS[idx]


def pool_bytes(device) -> int:
    """Bytes the process's graph pool on ``device`` reserved (0 when no
    graph uses it)."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    p = _POOLS.get(_card(device))
    return p.bytes if p is not None else 0


def lowering_key_hash(key) -> str:
    """The crc32 of the key's repr, the ``key`` field of ``xla_compile``
    (object reprs embed ids: stable within a run, which is the scope
    the recompile accounting needs)."""
    return format(zlib.crc32(repr(key).encode()) & 0xFFFFFFFF, "08x")


def graphs_for(device, mesh) -> bool:
    """True when a program is a CUDA graph: on the card, in one process
    or a one-rank NCCL group; a gloo group (its collectives stage
    through the host) runs the eager function."""
    if torch.device(device).type != "cuda":
        return False
    group = getattr(mesh, "group", None)
    if group is None:
        return True
    return getattr(mesh, "world", 1) == 1 and getattr(mesh, "backend", None) == "nccl"


class PositionalOperands:
    """A program's coding tables: the operand objects it was built over,
    each bound to the tables at its position (a later dispatch of the
    same key brings other objects of the same tier, in the same order)."""

    def __init__(self, objs: Sequence, tables: Sequence[Tuple[torch.Tensor, ...]]):
        self._pos = {id(o): i for i, o in enumerate(objs)}
        self._tables = tables

    def get(self, obj) -> Tuple[torch.Tensor, ...]:
        return self._tables[self._pos[id(obj)]]


def _batch_like(b: ColumnBatch) -> ColumnBatch:
    return ColumnBatch({n: torch.empty_like(t) for n, t in b.data.items()},
                       torch.empty_like(b.valid))


def _copy_batch(dst: ColumnBatch, src: ColumnBatch) -> None:
    """``src`` into the program's buffers ``dst`` (same columns, types
    and shapes: the key holds columns and capacity)."""
    pairs = [(dst.data.get(n), t) for n, t in src.data.items()] + [(dst.valid, src.valid)]
    for d, t in pairs:
        if d is None or d.dtype != t.dtype or d.shape != t.shape or len(dst.data) != len(src.data):
            raise ValueError("a stage program's input differs from the one it was captured with")
        d.copy_(t)


def _clone_batch(b: ColumnBatch) -> ColumnBatch:
    return ColumnBatch({n: t.clone() for n, t in b.data.items()}, b.valid.clone())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _unuse(pool: _Pool) -> None:
    """One graph fewer on ``pool``; with none left the pool is dropped
    (its memory is freed at the allocator's next release) and the next
    capture starts a new one."""
    pool.graphs -= 1
    if pool.graphs == 0:
        for idx, p in list(_POOLS.items()):
            if p is pool:
                del _POOLS[idx]


class StageProgram:
    """One unit's program under one lowering key (see the module
    docstring).  ``rounds``: the unit's ``exchange_round`` accounting,
    filled by the first call and logged on every dispatch."""

    def __init__(self, fn: UnitFn, name: str, key_hash: str, build_s: float,
                 rounds: List[dict], graph: bool, device):
        self.fn = fn
        self.name = name
        self.key_hash = key_hash
        self.build_s = build_s
        self.rounds = rounds
        self.graph_mode = bool(graph)
        self.device = torch.device(device)
        self.compiled = False
        self.compile_s: Optional[float] = None
        self.last_used = 0
        # the graph and the buffers it reads and writes (graph mode)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._in: List[ColumnBatch] = []
        self._tables: List[Tuple[torch.Tensor, ...]] = []
        self._out = None
        self._launches = 0  # bucket-kernel launches a replay runs
        self._pool: Optional[_Pool] = None
        self.pool_bytes = 0  # what its capture added to the shared pool
        self.held_bytes = 0  # its buffers (inputs, tables), outside the pool
        # the inputs of the last dispatch, weakly: ``ctx.release`` drops
        # the programs holding a copy of a released table
        self._sources: List[weakref.ref] = []

    def holds(self, batch: ColumnBatch) -> bool:
        """True when the last dispatch copied ``batch`` into the
        program's buffers."""
        return any(r() is batch.valid for r in self._sources)

    def __call__(self, inputs: Sequence[ColumnBatch], tables: Sequence[Tuple[torch.Tensor, ...]]):
        if not self.graph_mode:
            if self.compiled:
                return self.fn(inputs, tables)
            t0 = time.perf_counter()
            out = self.fn(inputs, tables)
            self.compile_s = time.perf_counter() - t0
            self.compiled = True
            return out
        self._sources = [weakref.ref(b.valid) for b in inputs]
        if self.graph is None:
            self._capture(inputs, tables)
        else:
            for dst, src in zip(self._in, inputs):
                _copy_batch(dst, src)
            for dst, src in zip(self._tables, tables):
                for d, s in zip(dst, src):
                    d.copy_(s)
            self._replay()
        outs, ovf, miss, counts = self._out
        return ([_clone_batch(b) for b in outs], ovf.clone(), miss.clone(),
                [c.clone() for c in counts])

    def _replay(self) -> None:
        try:
            self.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"stage program {self.name!r}: replay failed: {e}") from e
        if self._launches:
            BK.note_graph_launches(self._launches)

    def _capture(self, inputs, tables) -> None:
        dev = self.device
        t0 = time.perf_counter()
        self._in = [_batch_like(b) for b in inputs]
        for dst, src in zip(self._in, inputs):
            _copy_batch(dst, src)
        self._tables = [tuple(t.clone() for t in tab) for tab in tables]
        BK.preload(dev)  # the libraries and their modules, before the capture
        reserved = torch.cuda.memory_reserved(dev)
        before = BK.bucket_sum_count.captured
        graph = torch.cuda.CUDAGraph()
        pool = _pool(dev)
        side = pool.stream
        side.wait_stream(torch.cuda.current_stream(dev))
        pool.graphs += 1
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=pool.handle, capture_error_mode="thread_local")
                try:
                    out = self.fn(self._in, self._tables)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture was invalidated by the error being raised
                    raise
                graph.capture_end()
        except torch.cuda.OutOfMemoryError:
            graph.reset()
            _unuse(pool)
            raise
        except RuntimeError as e:
            graph.reset()
            _unuse(pool)
            if "capturing" in str(e) or "synchroniz" in str(e):
                raise TypeError(
                    f"stage program {self.name!r} moves a value between the host and the "
                    f"device inside its capture (a read to the host): {e}") from e
            raise RuntimeError(f"stage program {self.name!r}: capture failed: {e}") from e
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph, self._pool = graph, pool
        self._out = out
        self._launches = BK.bucket_sum_count.captured - before
        self._replay()
        self.compile_s = time.perf_counter() - t0
        self.compiled = True
        self.pool_bytes = max(0, torch.cuda.memory_reserved(dev) - reserved)
        pool.bytes += self.pool_bytes
        held = sum(_nbytes(t) for b in self._in for t in (*b.data.values(), b.valid))
        self.held_bytes = held + sum(_nbytes(t) for tab in self._tables for t in tab)

    def release(self) -> None:
        """Drop the graph (the pool goes with the process's last graph)
        and the buffers; an eager program holds nothing."""
        if self.graph is not None:
            self.graph.reset()
            _unuse(self._pool)
        self.graph = self._out = self._pool = None
        self._in, self._tables, self._sources = [], [], []
        self.held_bytes = self.pool_bytes = 0


class ProgramCache:
    """An executor's programs by lowering key (see the module
    docstring).  ``graphs``: whether new programs are CUDA graphs,
    decided from the device and the mesh (:func:`graphs_for`); setting
    it False on the card runs the eager functions instead, kept apart
    (the comparison of the two).  ``max_bytes``: a byte budget for the
    whole process (None: :data:`BUDGET_SHARE` of the card's memory);
    ``evictions`` counts the programs released for it."""

    def __init__(self, device, mesh=None, events=None, metrics=None):
        self.device = torch.device(device)
        self.mesh = mesh
        self.graphs = graphs_for(self.device, mesh)
        # a group's communicator starts at its first collective, which
        # must not fall inside a capture (a one-rank NCCL group)
        self._group_ready = getattr(mesh, "group", None) is None
        self.events = events
        self.metrics = metrics
        self.max_bytes: Optional[int] = None
        self.evictions = 0
        # the jobs running on the executor and the tick the newest
        # started at: while one runs, the programs used since are kept
        # whatever the budget, so a job never captures its own units twice
        self.running = 0
        self.job_tick = 0
        self._progs: Dict[Tuple, StageProgram] = {}
        _CACHES.add(self)
        weakref.finalize(self, _release_all, self._progs)

    def __len__(self) -> int:
        return len(self._progs)

    def held_bytes(self) -> int:
        """Bytes its programs' buffers hold (the shared pool apart)."""
        return sum(p.held_bytes for p in list(self._progs.values()))

    def begin_job(self) -> None:
        """A top-level job starts: until it ends, the programs it uses
        are the running job's."""
        with _LOCK:
            self.running += 1
            self.job_tick = next(_TICK)

    def end_job(self) -> None:
        """A top-level job ends: from now on its programs may be
        released like any other's.  The budget holds again at once for
        the programs of the process that sit idle (the job may have
        grown the pool past it); the ended job's own stay until the next
        capture or allocation failure wants their memory, so a job over
        the budget does not capture everything anew on each run."""
        with _LOCK:
            self.running -= 1
            if self.running == 0:
                _enforce_budget(device=self.device, spare=self)

    def _protected(self, prog: "StageProgram") -> bool:
        return self.running > 0 and prog.last_used >= self.job_tick

    def get(self, key, name: str, build: Callable[[], Tuple[UnitFn, List[dict]]],
            types: Tuple = ()) -> StageProgram:
        """The program under ``key`` for inputs of ``types`` (see
        :func:`types_of`), built by ``build() -> (fn, rounds cell)`` on
        a miss."""
        with _LOCK:
            # a graph and an eager program of a key apart, and programs
            # over other column types (one key hash, as the reference's)
            slot = (self.graphs, key, types)
            prog = self._progs.get(slot)
            if prog is None:
                t0 = time.perf_counter()
                fn, cell = build()
                prog = StageProgram(fn, name, lowering_key_hash(key), time.perf_counter() - t0,
                                    cell, self.graphs, self.device)
                self._progs[slot] = prog
            prog.last_used = next(_TICK)
            return prog

    def run(self, prog: StageProgram, inputs, tables):
        """Dispatch ``prog``; its first call logs ``xla_compile`` and
        the compile metrics, and a capture makes the budget hold."""
        if not prog.graph_mode:
            first = not prog.compiled
            out = self._relieved(prog, lambda: prog(inputs, tables))
            if first:
                self._compiled(prog)
            return out
        with _LOCK:
            first = not prog.compiled
            if first and not self._group_ready:
                PART.allreduce(torch.zeros((), dtype=torch.int64, device=self.device), "sum",
                               self.mesh)
                self._group_ready = True
            if first:
                # a pool grown by an earlier job's working set and kept
                # by its leftover programs: let it go before capturing
                _enforce_budget(keep=prog)
            else:
                return self._relieved(prog, lambda: prog(inputs, tables))
            try:
                out = prog(inputs, tables)
            except torch.cuda.OutOfMemoryError:
                _evict_everything(keep=prog)
                torch.cuda.empty_cache()
                try:
                    out = prog(inputs, tables)
                except torch.cuda.OutOfMemoryError as e:
                    raise RuntimeError(
                        f"stage program {prog.name!r}: out of device memory in its capture "
                        f"with every program released: {e}") from e
            self._compiled(prog)
            _enforce_budget(keep=prog)
            return out

    def _relieved(self, prog: StageProgram, call):
        """``call()``; when the card runs out of memory outside a
        capture, the programs no running job holds are released, the
        pool goes with the last of them, and ``call`` runs once more (in
        one process only: a gang's rank must not repeat its
        collectives)."""
        try:
            return call()
        except torch.cuda.OutOfMemoryError:
            if self.device.type != "cuda" or getattr(self.mesh, "world", 1) > 1:
                raise
            with _LOCK:
                freed = _release_idle(keep=prog)
            torch.cuda.empty_cache()
            if not freed:
                raise
            return call()

    def _compiled(self, prog: StageProgram) -> None:
        if self.metrics is not None:
            self.metrics.add("xla_compiles", 1.0, stage=prog.name)
            self.metrics.add("xla_compile_s", prog.compile_s, stage=prog.name)
        if self.events is not None:
            self.events.emit(
                "xla_compile", stage=prog.name, key=prog.key_hash, qid=tracectx.current_qid(),
                trace_s=round(prog.build_s, 6), compile_s=round(prog.compile_s, 6),
            )

    def evict(self, key) -> None:
        with _LOCK:
            prog = self._progs.pop(key, None)
            if prog is not None:
                prog.release()
                self.evictions += 1

    def drop_holding(self, batch: ColumnBatch) -> int:
        """Release the programs whose buffers hold a copy of ``batch``
        (a released table); returns how many."""
        with _LOCK:
            keys = [k for k, p in self._progs.items() if p.holds(batch)]
            for k in keys:
                self._progs.pop(k).release()
            return len(keys)

    def clear(self) -> None:
        with _LOCK:
            _release_all(self._progs)


def _release_all(progs: Dict[Tuple, StageProgram]) -> None:
    with _LOCK:
        for p in progs.values():
            p.release()
        progs.clear()


def _budget(device: torch.device) -> Optional[int]:
    """The process's byte budget: the smallest cache cap set, else
    :data:`BUDGET_SHARE` of the card's memory (None off the card)."""
    caps = [c.max_bytes for c in list(_CACHES) if c.max_bytes is not None]
    if caps:
        return min(caps)
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory * BUDGET_SHARE)


def _victims(keep: Optional[StageProgram], spare: Optional[ProgramCache] = None) -> list:
    """``(last used, cache, key)`` of every program that holds memory
    and may go: not ``keep``, not one a running job used, not one the
    last job of ``spare`` used."""
    return [(p.last_used, c, k) for c in list(_CACHES) for k, p in list(c._progs.items())
            if p is not keep and not c._protected(p)
            and not (c is spare and p.last_used >= c.job_tick)
            and (p.held_bytes or p.graph is not None)]


def _enforce_budget(keep: Optional[StageProgram] = None, device=None,
                    spare: Optional[ProgramCache] = None) -> None:
    """Release the least recently used programs of the process until the
    bytes the programs and the shared pool hold fit the budget; ``keep``,
    the programs a running job used and those of ``spare``'s last job
    stay.  Before a capture this also lets a pool that an earlier job
    grew go with its last graph, so the capture starts a pool of its
    own size."""
    device = keep.device if device is None else torch.device(device)
    budget = _budget(device)
    if budget is None:
        return
    caches = list(_CACHES)
    while sum(c.held_bytes() for c in caches) + pool_bytes(device) > budget:
        victims = _victims(keep, spare)
        if not victims:
            return
        _, cache, key = min(victims, key=lambda v: v[0])
        cache.evict(key)


def _release_idle(keep: Optional[StageProgram]) -> int:
    """Release every program no running job holds, but ``keep``;
    returns how many."""
    victims = _victims(keep)
    for _, cache, key in victims:
        cache.evict(key)
    return len(victims)


def types_of(inputs: Sequence[ColumnBatch], tables: Sequence[Tuple[torch.Tensor, ...]]) -> Tuple:
    """What a program's buffers fix beyond its key: each input column's
    dtype and trailing shape (in column order), each table's dtype and
    shape."""
    def sig(t):
        return str(t.dtype), tuple(t.shape[1:])
    return (tuple(tuple((n, *sig(t)) for n, t in sorted(b.data.items())) for b in inputs),
            tuple(tuple((str(t.dtype), tuple(t.shape)) for t in tab) for tab in tables))


def _evict_everything(keep: StageProgram) -> None:
    """Release every program of the process but ``keep`` (whose capture
    ran out of memory)."""
    for c in list(_CACHES):
        for k, p in list(c._progs.items()):
            if p is not keep:
                c.evict(k)
