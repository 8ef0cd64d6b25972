"""Out-of-core streaming execution: the bounded-device-memory chunk
loop (the counterpart of ``dryad_tpu/exec/outofcore.py``).

A two-phase partition-spill driver over the ordinary engine:

- phase 1 (scatter): each ingest *chunk* runs the plan's row-local
  prefix as one engine job, then is routed to range or hash buckets on
  the host and spilled as ``.dpf`` pieces (``exec/spill.py``);
- phase 2 (gather): each bucket, sized to fit the ``(P, cap)`` device
  layout, runs the wide operator (sort / group / join) as an ordinary
  engine job, and results stream out in bucket order.

Aggregations whose aggregates decompose skip the spill: per-chunk
partials stay on the device and fold through a combiner (by default
the combine tree of ``exec/combinetree.py``).  Oversized buckets
re-split from their observed volume.

The runtime plan rewriter (``rewrite/``), when the context has one,
is polled at chunk boundaries: a ``split_bucket`` refines a hot sort
bucket into sub-ranges or re-hashes a hot join bucket at the next salt,
and a ``combine_thrash`` diagnosis pins or flips the streaming combiner.
The port also releases the device tables of the
chunks, buckets and partials it binds once their job ran, so device
memory does not grow with the stream.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dryad_tpu_torch.columnar.schema import ColumnType, Schema
from dryad_tpu_torch.exec.combinetree import (
    CombineTreePlanner,
    TreeCombiner,
    TreeShape,
    batch_bytes,
    layout_rows,
    neutral_snapshot,
)
from dryad_tpu_torch.exec.executor import JobFailedError, StageFailedError
from dryad_tpu_torch.exec.faults import InjectedFault
from dryad_tpu_torch.exec.partial import MERGEABLE_AGGS, finalize_fn, merge_agg_spec, partial_plan
from dryad_tpu_torch.exec.pipeline import DispatchWindow, prefetched
from dryad_tpu_torch.exec.spill import SpillDir, SpillWriter
from dryad_tpu_torch.obs import telemetry
from dryad_tpu_torch.obs.metrics import KeyRangeHistogram
from dryad_tpu_torch.obs.span import Tracer
from dryad_tpu_torch.parallel.ranks import RankBatches
from dryad_tpu_torch.plan.nodes import Node, PartitionInfo, walk

# Node kinds applied chunk-locally in phase 1 (row-wise, stateless
# across chunks).  Partitioning hints are identity under streaming:
# every per-chunk/per-bucket engine job re-derives its own exchanges.
ROW_LOCAL = {"select", "where", "select_many"}
PARTITION_HINTS = {"hash_partition", "range_partition", "assume_partition"}

_MIX = np.uint64(0x9E3779B97F4A7C15)


class ChunkSource:
    """A stream ingest binding: an iterable of host tables.  The
    consumed flag lives HERE (not on the per-execution stream view) so
    a second collect() over the same query raises the explicit error
    instead of silently computing on a drained iterator."""

    def __init__(self, chunks, schema: Schema):
        self.chunks = chunks
        self.schema = schema
        self.state = {"consumed": False}


class _IngestScope:
    """Per-call-site chunk ingest state: a stable partition capacity
    (so every chunk runs at the same shapes) and accumulated auto-dense
    metadata (string vocabularies and int ranges widen monotonically
    across chunks).

    With ``cache_plans`` (the pipelined driver) the scope also reuses
    the ingest Node itself: a chunk that introduces no new vocabulary
    tier, no wider int range, and fits the stable capacity REBINDS the
    previous chunk's input node to its arrays instead of building a
    fresh node, so downstream plan chains repeat exactly.

    Every input node the scope binds is added to ``owned``: the driver
    drops those bindings (and their device tables) after each job."""

    def __init__(self, ctx, cache_plans: bool = False, slots: int = 1, owned=None):
        self.ctx = ctx
        self.cap: Optional[int] = None
        # K chunks lowered into ONE multi-root job each need their own
        # input node bound at dispatch: the reuse cache round-robins
        # over `slots` cached nodes
        self.slots = max(1, int(slots))
        self._slot_counter = 0
        self.vocab: Dict[str, np.ndarray] = {}
        self.stats: Dict[str, Tuple[int, int]] = {}
        self.cache_plans = cache_plans
        self.owned = owned if owned is not None else set()
        # runtime coding tables: a vocabulary widening within one
        # power-of-two palette tier keeps the cached input node
        self._runtime_tables = bool(getattr(ctx.config, "stringcode_runtime_tables", True))
        # bumps whenever vocab/stats/capacity widen beyond what cached
        # plans can absorb
        self.version = 0
        # (cap, binding kind, slot) -> (version, node) reusable input
        self._cached_input: Dict[Tuple, Tuple[int, Node]] = {}
        # (input node id, pending/extra node ids) -> cloned chain root
        self.chain_cache: Dict[Tuple, Any] = {}

    def _fit_cap(self, n: int, P: int) -> int:
        if self.cap is None or n > self.cap * P:
            self.cap = max(1, math.ceil(n / P / 8) * 8)
            self.version += 1
        return self.cap

    def _widen_vocab(self, col: str, v: np.ndarray) -> np.ndarray:
        from dryad_tpu_torch.ops.stringcode import palette_domain

        prev = self.vocab.get(col)
        new = v if prev is None else np.union1d(prev, v)
        if prev is None:
            self.version += 1
        elif len(new) != len(prev):
            if not self._runtime_tables or palette_domain(len(new)) != palette_domain(len(prev)):
                self.version += 1
        self.vocab[col] = new
        return new

    def _account(self, table: Dict[str, np.ndarray], n: int, P: int) -> None:
        """Ingest-side byte/row accounting: host->device bytes and the
        layout-vs-valid rows behind the padding-waste ratio."""
        if self.cap is None:
            return
        m = self.ctx.executor.metrics
        m.add("h2d_bytes", sum(np.asarray(v).nbytes for c, v in table.items() if c != "#vocab"))
        m.add("rows_in", n)
        m.add("valid_rows", n)
        m.add("layout_rows", self.cap * P)

    def ingest(self, table: Dict[str, np.ndarray], schema: Schema):
        ctx = self.ctx
        P = ctx.num_partitions
        if is_physical_chunk(table, schema):
            return self._maybe_reuse(self._ingest_physical(table, schema, P))
        n = len(next(iter(table.values()))) if table else 0
        self._fit_cap(n, P)
        self._account(table, n, P)
        q = ctx.from_arrays(table, schema=schema, partition_capacity=self.cap)
        node = q.node
        self.owned.add(node.id)
        # Widen auto-dense metadata to the stream scope.  The widened
        # dicts REPLACE the node's params, never written into the
        # originals, which clones share by reference.
        sv = node.params.get("str_vocab") or {}
        if sv:
            node.params["str_vocab"] = {col: self._widen_vocab(col, vocab) for col, vocab in sv.items()}
        cs = node.params.get("col_stats") or {}
        if cs:
            merged = {}
            for col, (mn, mx) in cs.items():
                if col in self.stats:
                    pmn, pmx = self.stats[col]
                    nmn, nmx = min(mn, pmn), max(mx, pmx)
                else:
                    nmn, nmx = mn, mx
                if self.stats.get(col) != (nmn, nmx):
                    self.version += 1
                self.stats[col] = (nmn, nmx)
                merged[col] = (nmn, nmx)
            node.params["col_stats"] = merged
        return self._maybe_reuse(q)

    def _maybe_reuse(self, q):
        """Swap the freshly built input node for the cached one when
        this chunk's metadata is covered by it (vocab/stats widen
        monotonically, so an unchanged version proves coverage)."""
        if not self.cache_plans:
            return q
        from dryad_tpu_torch.api.query import Query

        ctx = self.ctx
        node = q.node
        binding = ctx._bindings.get(node.id)
        if binding is None:
            return q
        slot = self._slot_counter % self.slots
        self._slot_counter += 1
        key = (self.cap, binding[0], slot)
        cached = self._cached_input.get(key)
        if cached is not None and cached[0] == self.version:
            cnode = cached[1]
            ctx._bindings[cnode.id] = ctx._bindings.pop(node.id)
            self.owned.discard(node.id)
            self.owned.add(cnode.id)
            # a within-tier widen reuses the node, but the next lowering
            # must code against the full accumulated vocabulary
            sv = cnode.params.get("str_vocab")
            if sv:
                cnode.params["str_vocab"] = {c: self.vocab.get(c, vv) for c, vv in sv.items()}
            return Query(ctx, cnode)
        self._cached_input[key] = (self.version, node)
        return q

    def _ingest_physical(self, table: Dict[str, np.ndarray], schema, P):
        """Pre-encoded chunk (physical columns straight off the native
        tokenizer): bind as host_physical, with no per-token Python
        string work on the streaming hot path."""
        from dryad_tpu_torch.api.query import Query

        ctx = self.ctx
        vocab = table.pop("#vocab", None) or {}
        for col, v in vocab.items():
            self._widen_vocab(col, v)
        n = len(next(iter(table.values()))) if table else 0
        self._fit_cap(n, P)
        self._account(table, n, P)
        node = Node(
            "input", [], schema, PartitionInfo.roundrobin(),
            source="host_physical",
            str_vocab={c: v.copy() for c, v in self.vocab.items()},
        )
        ctx._bindings[node.id] = ("host_physical", table, self.cap)
        self.owned.add(node.id)
        return Query(ctx, node)


class _AsyncDispatcher:
    """Driver-side async chunk dispatcher: a
    :class:`~dryad_tpu_torch.exec.pipeline.DispatchWindow` plus
    cross-chunk plan fusion.

    Queries queue up to ``fuse`` deep and dispatch in submit order (a
    fused batch lowers as ONE multi-root job,
    ``run_many_to_host_async``), and each chunk's readback fetch hands
    off to the window's collector thread.  Outcomes are delivered
    strictly in submit order, so the caller's commit body observes the
    serial sequence and results stay byte-identical with
    ``dispatch_depth=1``.  A stage failure surfacing at the drain site
    re-executes that chunk serially via the caller's ``retry``; other
    errors propagate, and the caller's ``finally`` closes the window.
    ``release(queries)`` runs after each dispatch."""

    def __init__(self, ctx, depth, fuse, events=None, name="chunks", retry=None, release=None):
        self.ctx = ctx
        self.fuse = max(1, int(fuse))
        self.retry = retry
        self.release = release
        # a fused batch enters the window whole, so the window must
        # admit at least `fuse` in-flight fetches
        self.win = DispatchWindow(max(1, int(depth), self.fuse), events=events, name=name)
        self._queued: List[Tuple[Any, Any]] = []  # awaiting fused dispatch

    def submit(self, tag, query) -> None:
        self._queued.append((tag, query))
        if len(self._queued) >= self.fuse:
            self._dispatch()

    def _dispatch(self) -> None:
        queued, self._queued = self._queued, []
        if not queued:
            return
        if len(queued) == 1:
            fetches = [self.ctx.run_to_host_async(queued[0][1])]
        else:
            fetches = self.ctx.run_many_to_host_async([q for _tag, q in queued])
        if self.release is not None:
            self.release([q for _tag, q in queued])
        for (tag, _q), fetch in zip(queued, fetches):
            self.win.submit(tag, fetch)

    def ready(self):
        """Completed (tag, table) pairs, non-blocking."""
        return self._deliver(self.win.ready())

    def drain(self):
        """Flush the fused queue and deliver every remaining outcome
        in submit order (blocking)."""
        self._dispatch()
        return self._deliver(self.win.drain())

    def _deliver(self, outcomes):
        for tag, value, error in outcomes:
            if error is not None:
                value = self._retry_one(tag, error)
            yield tag, value

    def _retry_one(self, tag, error):
        """A failed fetch reruns serially at the drain site when its
        failure is transient: a stage failure or an injected fault, not
        a job that already spent its retry budget."""
        transient = isinstance(
            error, (StageFailedError, InjectedFault)
        ) and not isinstance(error, JobFailedError)
        if self.retry is None or not transient:
            raise error
        self.win.note_retry()
        return self.retry(tag)

    def close(self) -> None:
        self.win.close()


class _Stream:
    """A lazily-realized chunk stream: base chunks plus a pending
    chain of row-local plan nodes applied per chunk on the device.
    Derived streams (``with_pending``) SHARE the consumption state with
    their base: two branches over one chunk iterator raise the explicit
    already-consumed error instead of silently splitting the data."""

    def __init__(self, base_schema: Schema, chunks: Iterator, pending=(), _state: Optional[dict] = None):
        self.base_schema = base_schema
        self.chunks = chunks
        self.pending: List[Node] = list(pending)
        self._state = _state if _state is not None else {"consumed": False}

    @property
    def consumed(self) -> bool:
        return self._state["consumed"]

    @consumed.setter
    def consumed(self, v: bool) -> None:
        self._state["consumed"] = v

    @property
    def schema(self) -> Schema:
        return self.pending[-1].schema if self.pending else self.base_schema

    def with_pending(self, node: Node) -> "_Stream":
        return _Stream(self.base_schema, self.chunks, self.pending + [node], _state=self._state)


class StreamNotSupported(NotImplementedError):
    pass


def has_stream_input(ctx, root: Node) -> bool:
    if not getattr(ctx, "_any_stream", False):
        return False  # the context never created a stream binding
    return bool(stream_reaching_ids(ctx, root))


def stream_reaching_ids(ctx, root: Node) -> set:
    """Ids of nodes whose subtree contains a stream binding, in ONE
    topological walk."""
    ids: set = set()
    for n in walk([root]):
        b = ctx._bindings.get(n.id)
        if (b is not None and b[0] == "stream") or any(i.id in ids for i in n.inputs):
            ids.add(n.id)
    return ids


def is_physical_chunk(table, schema: Schema) -> bool:
    """Chunks may arrive pre-encoded as physical columns (``name#h0``
    etc., straight off the native tokenizer) instead of logical host
    arrays; ``#vocab`` optionally carries the chunk's string vocab."""
    cols = set(table) - {"#vocab"}
    return cols != set(schema.names) and any("#" in c for c in cols)


def _hashable_keys(table, stream: "_Stream", keys) -> bool:
    """True when the raw chunk holds the group keys as logical columns,
    so the host can hash them before ingest.  A physical chunk, or keys
    a pending row-local node computes, cannot be: such a chunk takes a
    neutral histogram snapshot (the reference's driver raises a
    ``KeyError`` on computed keys)."""
    return not is_physical_chunk(table, stream.base_schema) and all(k in table for k in keys)


def _chunk_rows(table) -> int:
    for c, v in table.items():
        if c != "#vocab":
            return len(v)
    return 0


class _DeviceCombiner:
    """Accumulator of device-resident partial batches (the flat N-ary
    combiner, the tree-off baseline).

    Partials pile up untouched until their combined LAYOUT rows (sum of
    batch capacities: an upper bound known without a device readback,
    so pushes never block the dispatch loop) exceed ``combine_rows`` or
    the fan-in cap; then ONE N-ary concat+merge job folds them to a
    single batch.  ``push`` returns False when a flush kept >= 3/4 of
    its inputs' combined layout (high-cardinality keys): the caller
    then ``drain()``s and degrades to host-side accumulation."""

    MAX_FANIN = 64  # bounds one merge job's arity

    def __init__(self, merge_many, combine_rows: int, emit, split=None):
        self._merge_many = merge_many
        self._combine_rows = combine_rows
        self._emit = emit
        # optional (in_bytes, out_bytes) -> (ici, dcn) estimator
        # (TreeShape.exchange_split): every flat flush pays a full hash
        # exchange, tagged on its event
        self._split = split
        self._pending: List[Any] = []

    def _cap(self) -> int:
        return sum(layout_rows(b) for b in self._pending)

    def push(self, batch) -> bool:
        """Insert one partial; False = the flush this push triggered
        did not reduce (caller should ``drain()`` and change policy)."""
        self._pending.append(batch)
        if len(self._pending) < 2 or (
            self._cap() <= self._combine_rows and len(self._pending) < self.MAX_FANIN
        ):
            return True
        in_cap = self._cap()
        fan = len(self._pending)
        in_bytes = sum(batch_bytes(b) for b in self._pending)
        merged = self._merge_many(self._pending)
        self._pending = [merged]
        ici, dcn = self._split(in_bytes, batch_bytes(merged)) if self._split else (0, 0)
        self._emit("stream_combine", cap_rows=layout_rows(merged), device=True, fan_in=fan,
                   level=0, ici_bytes=ici, dcn_bytes=dcn)
        return layout_rows(merged) < 0.75 * in_cap

    def drain(self) -> List[Any]:
        """All held batches; the combiner is empty afterwards."""
        out = self._pending
        self._pending = []
        return out

    def fold(self):
        """Merge everything left into one batch; None when nothing was
        pushed."""
        if not self._pending:
            return None
        if len(self._pending) == 1:
            return self._pending.pop()
        merged = self._merge_many(self._pending)
        self._pending = []
        return merged


class StreamExecutor:
    """Drives a plan whose input is a chunk stream; every device job it
    launches is bounded by the chunk/bucket budgets."""

    def __init__(self, ctx):
        self.ctx = ctx
        cfg = ctx.config
        self.bucket_rows = int(cfg.stream_bucket_rows)
        # a static staged-exchange window (plan/xchgplan.py) caps a
        # dispatch's redistribution footprint at O(window * B) instead
        # of O(P * B): spend it on bigger buckets (fewer device jobs and
        # spill round trips), by the P / window shrink clamped to 4x,
        # as the reference does; the auto window (-1) resolves per
        # dispatch, so no static scaling applies
        window = int(cfg.exchange_window)
        if window > 0 and self._P() > window:
            self.bucket_rows *= min(4, max(1, self._P() // window))
        self.combine_rows = int(cfg.stream_combine_rows)
        self.num_buckets = int(cfg.stream_buckets)
        # chunk pipeline: ingest / compute / readback-spill overlap with
        # this many chunks in flight; 1 = the serial driver
        self.pipeline_depth = max(1, int(cfg.stream_pipeline_depth))
        self.writer_queue = int(cfg.stream_writer_queue)
        # chunk and bucket dispatches in flight behind the dispatch
        # window's collector (-1: the measured headroom's tier, read
        # from the context's sampler); any depth gives the serial
        # loop's bytes
        self.dispatch_depth = max(1, telemetry.resolve_depth(
            int(cfg.dispatch_depth), getattr(ctx, "headroom", None)))
        # cross-chunk fusion: K chunk partial-plans lowered as one job
        self.chunk_fuse = max(1, int(cfg.chunk_fuse))
        self.max_split_depth = 3
        self.events = ctx.executor.event_log
        # the runtime plan rewriter (rewrite/controller.py), polled at
        # chunk boundaries for hot-bucket splits and combine pins; None
        # when diagnosis or rewriting is off
        self.rewriter = getattr(ctx, "rewriter", None)
        # driver-loop spans (cat=chunk); engine jobs run inside them
        self.tracer = Tracer(self.events)
        self.metrics = ctx.executor.metrics
        self._small_nodes: Dict[int, Node] = {}
        self._eval_cache: Dict[int, Tuple[str, Any]] = {}
        self._stream_ids: Optional[set] = None
        # input nodes this driver bound (chunks, buckets, partials):
        # their bindings go once their job ran
        self._owned: set = set()

    @property
    def _pipelined(self) -> bool:
        return self.pipeline_depth > 1

    def _scope(self, slots: int = 1, cache: Optional[bool] = None) -> _IngestScope:
        if cache is None:
            cache = self._pipelined or slots > 1
        return _IngestScope(self.ctx, cache_plans=cache, slots=slots, owned=self._owned)

    @property
    def _async_dispatch(self) -> bool:
        """Async drain path: window the chunk dispatches."""
        return self.dispatch_depth > 1 or self.chunk_fuse > 1

    def _spill_writer(self) -> Optional[SpillWriter]:
        if not self._pipelined:
            return None
        return SpillWriter(events=self.events, queue_depth=self.writer_queue)

    # ---- public --------------------------------------------------------

    def run_to_host(self, root: Node) -> Dict[str, np.ndarray]:
        kind, val = self._eval(root)
        if kind == "small":
            self.metrics.emit(self.events)
            return val
        tables = list(self._realized(val))
        self.metrics.emit(self.events)
        return _concat_tables(tables, val.schema)

    def run_stream(self, root: Node):
        """(schema, iterator of host tables): the bounded-memory result
        surface of ``Query.collect_stream``."""
        kind, val = self._eval(root)
        if kind == "small":
            return root.schema, iter([val])
        return val.schema, self._realized(val)

    def to_store(self, root: Node, path: str) -> int:
        """Stream results into a partitioned store, one part file per
        non-empty piece, then the manifest; returns the row count."""
        import os

        from dryad_tpu_torch.columnar.io import _part_name, write_store_meta
        from dryad_tpu_torch.runtime.bindings import write_partition

        kind, val = self._eval(root)
        schema = val.schema if kind == "stream" else root.schema
        tables = self._realized(val) if kind == "stream" else iter([val])
        os.makedirs(path, exist_ok=True)
        total = 0
        i = 0
        for t in tables:
            n = len(next(iter(t.values()))) if t else 0
            if not n:
                continue
            phys = _encode_store_part(t, schema, self.ctx.dictionary)
            write_partition(os.path.join(path, _part_name(i)), phys, None)
            total += n
            i += 1
        write_store_meta(path, i, schema, self.ctx.dictionary)
        self._emit("stream_store", path=path, rows=total, partitions=i)
        self.metrics.emit(self.events)
        return total

    # ---- helpers -------------------------------------------------------

    def _P(self) -> int:
        return self.ctx.num_partitions

    def _emit(self, kind: str, **fields) -> None:
        self.events.emit(kind, **fields)

    def _release(self, roots) -> None:
        """Drop the bindings this driver made for the jobs of ``roots``
        (their host arrays and cached device tables): the job has run,
        and the next chunk rebinds the node if it needs it."""
        ctx = self.ctx
        with ctx._job_lock:  # another thread's job may be evicting the cache
            for n in walk([r.node if hasattr(r, "node") else r for r in roots]):
                if n.kind == "input" and n.id in self._owned:
                    self._owned.discard(n.id)
                    # every card's copy; the next chunk's job replays
                    # into the programs' buffers
                    ctx._forget(n.id, programs=False)

    def _device(self, query):
        """Run a driver-built query; its result batch stays on the
        device."""
        batch = self.ctx.execute(query)
        self._release([query])
        return batch

    def _host(self, query) -> Dict[str, np.ndarray]:
        """Run a driver-built query to a host table."""
        out = self.ctx.run_to_host(query)
        self._release([query])
        return out

    def _from_batch(self, batch, schema):
        """A driver-owned query over a device batch."""
        q = self.ctx._from_device_batch(batch, schema)
        self._owned.add(q.node.id)
        return q

    def _run_engine(self, node: Node) -> Dict[str, np.ndarray]:
        from dryad_tpu_torch.api.query import Query

        with self.tracer.span(f"engine:{node.kind}", cat="chunk"):
            return self._host(Query(self.ctx, node))

    def _clone(self, n: Node, new_inputs: Sequence[Node]) -> Node:
        return Node(n.kind, list(new_inputs), n.schema, n.partition, **n.params)

    def _materialize_small(self, node: Node) -> Node:
        """Run a stream-free subtree once; re-ingest as a host table so
        per-chunk jobs reuse the same binding instead of recomputing."""
        if node.id in self._small_nodes:
            return self._small_nodes[node.id]
        if node.kind == "input" and self.ctx._bindings.get(node.id, ("",))[0] in (
            "host", "host_physical",
        ):
            self._small_nodes[node.id] = node  # already a cheap binding
            return node
        table = self._run_engine(node)
        q = self.ctx.from_arrays(table, schema=node.schema)
        self._small_nodes[node.id] = q.node
        return q.node

    def _chain_root(self, scope: _IngestScope, q, nodes: Sequence[Node]):
        """Clone the pending chain onto an ingest query ONCE per
        (reused) input node; a rebound chunk reuses the whole chain."""
        if not scope.cache_plans:
            cur = q.node
            for n in nodes:
                cur = self._clone(n, [cur] + n.inputs[1:])
            return cur
        key = (q.node.id,) + tuple(n.id for n in nodes)
        root = scope.chain_cache.get(key)
        if root is None:
            root = q.node
            for n in nodes:
                root = self._clone(n, [root] + n.inputs[1:])
            scope.chain_cache[key] = root
        return root

    def _realize_table(
        self, table: Dict[str, np.ndarray], stream: _Stream,
        scope: _IngestScope, extra: Sequence[Node] = (),
    ) -> Dict[str, np.ndarray]:
        """Apply the stream's pending chain (+ extra nodes) to one chunk
        as a single engine job."""
        if not stream.pending and not extra:
            if is_physical_chunk(table, stream.base_schema):
                from dryad_tpu_torch.columnar.batch import decode_physical_table

                t = {c: v for c, v in table.items() if c != "#vocab"}
                return decode_physical_table(stream.base_schema, slice(None), t, self.ctx.dictionary)
            return table
        q = scope.ingest(table, stream.base_schema)
        cur = self._chain_root(scope, q, list(stream.pending) + list(extra))
        return self._run_engine(cur)

    def _realized(self, stream: _Stream) -> Iterator[Dict[str, np.ndarray]]:
        scope = self._scope()
        for table in self._iter_base(stream):
            yield self._realize_table(table, stream, scope)

    # ---- evaluator -----------------------------------------------------

    def _eval(self, node: Node):
        """Memoized: a diamond (tee) re-requesting a node gets the same
        result object; a second consumer of a stream raises the explicit
        already-consumed error."""
        if node.id in self._eval_cache:
            return self._eval_cache[node.id]
        if self._stream_ids is None:  # one walk per execution
            self._stream_ids = stream_reaching_ids(self.ctx, node)
        r = self._eval_inner(node)
        self._eval_cache[node.id] = r
        return r

    def _reaches_stream(self, node: Node) -> bool:
        return node.id in self._stream_ids

    def _eval_inner(self, node: Node):
        b = self.ctx._bindings.get(node.id)
        if node.kind == "input" and b is not None and b[0] == "stream":
            src: ChunkSource = b[1]
            self._emit("stream_start", node=node.id)
            return "stream", _Stream(src.schema, iter(src.chunks), _state=src.state)
        if not self._reaches_stream(node):
            return "small", self._run_engine(node)

        if node.kind in PARTITION_HINTS:
            return self._eval(node.inputs[0])
        if node.kind == "concat":
            return self._eval_concat(node)
        if node.kind == "join":
            return self._eval_join(node)
        # single-chain operators: a subtree that STREAMS may still
        # evaluate to a small table (e.g. group_by output feeding
        # order_by); then this operator runs as one engine job over the
        # materialized input
        k, v = self._eval(node.inputs[0])
        if k == "small":
            q = self.ctx.from_arrays(v, schema=node.inputs[0].schema)
            self._owned.add(q.node.id)
            cur = self._clone(node, [q.node] + node.inputs[1:])
            return "small", self._run_engine(cur)
        if node.kind in ROW_LOCAL:
            return "stream", v.with_pending(node)
        if node.kind == "group_by":
            return self._eval_group(node, v)
        if node.kind == "aggregate":
            return self._eval_aggregate(node, v)
        if node.kind == "distinct":
            return self._eval_distinct(node, v)
        if node.kind == "order_by":
            return self._eval_order_by(node, v)
        if node.kind == "take":
            return self._eval_take(node, v)
        raise StreamNotSupported(
            f"operator {node.kind!r} over a chunk stream is not supported; "
            "materialize with to_store first"
        )

    # ---- group_by ------------------------------------------------------

    def _eval_group(self, node: Node, stream: _Stream):
        agg_list = node.params.get("aggs")
        keys = list(node.params["keys"])
        if agg_list and all(op in MERGEABLE_AGGS for op, _c, _o in agg_list):
            return self._group_partial(node, stream, keys, agg_list)
        # non-mergeable (a Decomposable, etc.): Grace hash-bucketing,
        # the original group node per bucket
        return "stream", _Stream(node.schema, self._grace_buckets([(stream, keys)], [node], node.schema))

    def _finalize_query(self, q, plan, keys, out_schema):
        """Append the merge finalizer (mean = sum/count, renames) to a
        merged-partials query."""
        from dryad_tpu_torch.exec.partial import copy_physical

        fin = finalize_fn(plan)

        def full(cols, _fin=fin, _keys=keys):
            out = {}
            for kk in _keys:
                copy_physical(cols, kk, kk, out)
            out.update(_fin(cols))
            return out

        return q.select(full, schema=out_schema)

    def _chunk_partial_query(self, scope, stream, table, node, keys, partial):
        """One chunk's partial group query, chain-cached: a rebound
        chunk reuses the ingest node, the pending clones AND the group
        node, so the whole per-chunk plan repeats."""
        from dryad_tpu_torch.api.query import Query

        q = scope.ingest(table, stream.base_schema)
        key = ("gp", q.node.id)
        pq = scope.chain_cache.get(key)
        if pq is None:
            cur = self._chain_root(scope, q, stream.pending)
            pq = Query(self.ctx, cur).group_by(
                keys, partial, dense=node.params.get("dense"), salt=node.params.get("salt"),
            )
            if scope.cache_plans:
                scope.chain_cache[key] = pq
        return pq

    def _dispatcher(self, name: str, retry=None) -> _AsyncDispatcher:
        return _AsyncDispatcher(
            self.ctx, self.dispatch_depth, self.chunk_fuse, events=self.events, name=name,
            retry=retry, release=self._release,
        )

    def _group_partial(self, node, stream, keys, agg_list):
        if self._pipelined:
            return self._group_partial_device(node, stream, keys, agg_list)
        if self._async_dispatch:
            return self._group_partial_async(node, stream, keys, agg_list)
        return self._group_partial_serial(node, stream, keys, agg_list)

    def _host_combiner(self, keys, merge_spec, plan, out_schema, shape, mscope, state):
        """The host accumulator's merge: concat the partial tables,
        ingest, merge (and finalize when ``final``)."""

        def combine(tables, final: bool):
            cat = _concat_tables(tables, state["pschema"])
            q = mscope.ingest(cat, state["pschema"]).group_by(keys, merge_spec)
            if final:
                q = self._finalize_query(q, plan, keys, out_schema)
            return self._host(q)

        def compact(acc) -> int:
            """Fold the accumulator in place; returns its rows."""
            in_bytes = sum(int(np.asarray(v).nbytes) for t in acc for v in t.values())
            merged = combine(acc, final=False)
            acc[:] = [merged]
            rows = len(next(iter(merged.values()))) if merged else 0
            out_bytes = sum(int(np.asarray(v).nbytes) for v in merged.values())
            ici, dcn = shape.exchange_split(in_bytes, out_bytes)
            self._emit("stream_combine", rows_out=rows, level=0, ici_bytes=ici, dcn_bytes=dcn)
            return rows

        return combine, compact

    def _group_partial_serial(self, node, stream, keys, agg_list):
        """Serial driver (stream_pipeline_depth=1): per-chunk host
        readback of partials, host-side combine re-ingest."""
        partial, plan = partial_plan(agg_list)
        merge_spec = merge_agg_spec(plan)
        scope = self._scope()
        shape = TreeShape(self.ctx.mesh, self.ctx.config)
        st = {"pschema": None}
        combine, compact = self._host_combiner(
            keys, merge_spec, plan, node.schema, shape, self._scope(), st,
        )
        acc: List[Dict[str, np.ndarray]] = []
        acc_rows = 0
        nchunks = 0
        for table in self._iter_base(stream):
            n = _chunk_rows(table)
            pq = self._chunk_partial_query(scope, stream, table, node, keys, partial)
            if st["pschema"] is None:
                st["pschema"] = pq.schema
            pt = self._host(pq)
            rows = len(next(iter(pt.values()))) if pt else 0
            acc.append(pt)
            acc_rows += rows
            nchunks += 1
            self._emit("stream_chunk", rows=n, partial_rows=rows)
            if acc_rows > self.combine_rows and len(acc) > 1:
                acc_rows = compact(acc)
        if st["pschema"] is None:  # empty stream
            return "small", _empty_table(node.schema)
        out = combine(acc, final=True)
        self._emit("stream_group_done", chunks=nchunks, groups=len(next(iter(out.values()))) if out else 0)
        return "small", out

    def _group_partial_async(self, node, stream, keys, agg_list):
        """Async serial driver (``dispatch_depth``/``chunk_fuse`` > 1
        without the device-resident pipeline): the serial driver's
        accumulate/combine body, with chunk partial dispatches in
        flight through the dispatch window.  Commits run strictly in
        submit order, so the host accumulator matches the serial loop
        bit for bit."""
        partial, plan = partial_plan(agg_list)
        merge_spec = merge_agg_spec(plan)
        # one cached-input slot per fused chunk: a fused batch needs
        # all K input nodes bound at dispatch
        scope = self._scope(slots=self.chunk_fuse)
        shape = TreeShape(self.ctx.mesh, self.ctx.config)
        st = {"acc_rows": 0, "nchunks": 0, "pschema": None}
        combine, compact = self._host_combiner(
            keys, merge_spec, plan, node.schema, shape, self._scope(), st,
        )
        acc: List[Dict[str, np.ndarray]] = []

        def retry(tag):
            # serial re-execution of ONE chunk through a fresh uncached
            # scope (slot reuse may have rebound its input node)
            _n, table = tag
            rq = self._chunk_partial_query(self._scope(cache=False), stream, table, node, keys, partial)
            return self._host(rq)

        def commit(tag, pt):
            n, _table = tag
            rows = len(next(iter(pt.values()))) if pt else 0
            acc.append(pt)
            st["acc_rows"] += rows
            st["nchunks"] += 1
            self._emit("stream_chunk", rows=n, partial_rows=rows)
            if st["acc_rows"] > self.combine_rows and len(acc) > 1:
                st["acc_rows"] = compact(acc)

        dsp = self._dispatcher("grouppartial", retry=retry)
        try:
            for table in self._iter_base(stream):
                n = _chunk_rows(table)
                pq = self._chunk_partial_query(scope, stream, table, node, keys, partial)
                if st["pschema"] is None:
                    st["pschema"] = pq.schema
                dsp.submit((n, table), pq)
                for tag, pt in dsp.ready():
                    commit(tag, pt)
            for tag, pt in dsp.drain():
                commit(tag, pt)
        finally:
            dsp.close()
        if st["pschema"] is None:  # empty stream
            return "small", _empty_table(node.schema)
        out = combine(acc, final=True)
        self._emit("stream_group_done", chunks=st["nchunks"],
                   groups=len(next(iter(out.values()))) if out else 0)
        return "small", out

    def _batch_to_host(self, batch, schema) -> Dict[str, np.ndarray]:
        """Materialize a device batch as a host logical table (the
        degrade path when device-side combining stops paying)."""
        self.metrics.add("d2h_bytes", batch.nbytes())
        return batch.to_numpy(schema, self.ctx.dictionary)

    def _group_partial_device(self, node, stream, keys, agg_list):
        """Pipelined driver: per-chunk partials stay DEVICE-RESIDENT,
        accumulate as ColumnBatches and merge device to device; the
        scatter phase pays one device->host copy at the END instead of
        one per chunk.  With ``config.combine_tree`` (default) they go
        through the combine tree; the flat combiner stays as the
        baseline and takes order-sensitive aggregates (``first``),
        which the tree's similarity routing would reorder."""
        tree = bool(self.ctx.config.combine_tree)
        ov = self.rewriter.combine_tree_override() if self.rewriter is not None else None
        if ov is not None and bool(ov) != tree:
            # combine_thrash rewrite: flip the strategy for streams that
            # START after the diagnosis (both compute the same groups;
            # only the merge cadence differs)
            tree = bool(ov)
            self._emit("plan_rewrite", phase="applied", action="flip_combine",
                       rule="combine_thrash", subject="stream_combine", tree=tree)
        if tree and not any(op == "first" for op, _c, _o in agg_list):
            return self._group_partial_tree(node, stream, keys, agg_list)
        return self._group_partial_flat(node, stream, keys, agg_list)

    def _combine_pinned(self) -> bool:
        """True when a combine_thrash rewrite pinned the streaming
        combine to host accumulation (the always-correct side of the
        oscillation)."""
        return self.rewriter is not None and self.rewriter.combine_pin() == "host"

    def _first_chunk_irreducible(self, table, stream, keys, batch, n):
        """Static high-cardinality signal for the first chunk: count the
        chunk's distinct keys with a HOST-side hash (exact, no device
        readback).  The partial batch's layout capacity is only trusted
        for physical chunks, and only below the chunk's row count."""
        if n <= 0:
            return False
        if _hashable_keys(table, stream, keys):
            h = _host_key_hash64(table, keys, dictionary=self.ctx.dictionary)
            return np.unique(h).size >= 0.75 * n
        return n > layout_rows(batch) >= 0.75 * n

    def _group_partial_flat(self, node, stream, keys, agg_list):
        """Flat N-ary device combiner (the tree-off baseline).

        High-cardinality streams whose merges show no reduction degrade
        to host-side threshold accumulation.  After
        ``config.stream_host_reprobe`` CONSECUTIVE host combines that
        do reduce, the device path is retried with the merged
        accumulator re-ingested."""
        partial, plan = partial_plan(agg_list)
        merge_spec = merge_agg_spec(plan)
        scope = self._scope()
        mscope = self._scope()
        shape = TreeShape(self.ctx.mesh, self.ctx.config)
        reprobe_after = int(self.ctx.config.stream_host_reprobe or 0)
        st = {"pschema": None}
        host_combine, compact = self._host_combiner(
            keys, merge_spec, plan, node.schema, shape, mscope, st,
        )

        def merge_many(batches):
            qs = [self._from_batch(b, st["pschema"]) for b in batches]
            q = qs[0].concat(*qs[1:])  # ONE N-ary concat node/stage
            return self._device(q.group_by(keys, merge_spec))

        comb = _DeviceCombiner(merge_many, self.combine_rows, self._emit, split=shape.exchange_split)
        host_acc: Optional[List[Dict[str, np.ndarray]]] = None
        host_rows = 0
        reduce_streak = 0  # consecutive host combines that DID reduce
        nchunks = 0
        pin_applied = False
        if self._combine_pinned():
            # pin_combine rewrite: start (and stay) on host accumulation,
            # no probe merge, no reprobe oscillation
            host_acc = []
            pin_applied = True
            self._emit("stream_combine_policy", mode="host", chunks=0, pinned=True)
            self._emit("plan_rewrite", phase="applied", action="pin_combine",
                       rule="combine_thrash", subject="stream_combine", mode="host")
        for table in self._iter_base(stream):
            n = _chunk_rows(table)
            pq = self._chunk_partial_query(scope, stream, table, node, keys, partial)
            if st["pschema"] is None:
                st["pschema"] = pq.schema
            batch = self._device(pq)  # the partial stays on the device
            nchunks += 1
            self._emit("stream_chunk", rows=n, partial_cap=layout_rows(batch))
            if host_acc is None and nchunks == 1 and self._first_chunk_irreducible(
                table, stream, keys, batch, n,
            ):
                # the FIRST chunk's keys are ~all distinct: device
                # merging cannot pay; degrade before one probe merge
                host_acc = []
                self._emit("stream_combine_policy", mode="host", chunks=nchunks, static=True)
            if host_acc is None:
                if comb.push(batch):
                    continue
                # no reduction: degrade to host accumulation
                host_acc = [self._batch_to_host(b, st["pschema"]) for b in comb.drain()]
                host_rows = sum(len(next(iter(t.values()))) if t else 0 for t in host_acc)
                self._emit("stream_combine_policy", mode="host", chunks=nchunks)
            else:
                pt = self._batch_to_host(batch, st["pschema"])
                host_acc.append(pt)
                host_rows += len(next(iter(pt.values()))) if pt else 0
            if host_rows > self.combine_rows and len(host_acc) > 1:
                pre_rows = host_rows
                host_rows = compact(host_acc)
                # un-stick the degrade: host combines that keep reducing
                # mean the keys DO collapse
                reduce_streak = reduce_streak + 1 if host_rows < 0.75 * pre_rows else 0
                if self._combine_pinned():
                    # a combine_thrash diagnosis mid-stream pins the
                    # degrade: stop re-probing the device path
                    reduce_streak = 0
                    if not pin_applied:
                        pin_applied = True
                        self._emit("plan_rewrite", phase="applied", action="pin_combine",
                                   rule="combine_thrash", subject="stream_combine", mode="host")
                elif reprobe_after and reduce_streak >= reprobe_after and host_rows > 0:
                    merged = host_acc[0]
                    back = self._device(mscope.ingest(merged, st["pschema"]))
                    self.metrics.add("h2d_bytes", sum(int(np.asarray(v).nbytes) for v in merged.values()))
                    comb.push(back)
                    host_acc = None
                    host_rows = 0
                    reduce_streak = 0
                    self._emit("stream_combine_policy", mode="device", chunks=nchunks, reprobe=True)
        if st["pschema"] is None:  # empty stream
            return "small", _empty_table(node.schema)
        if host_acc is not None:
            out = host_combine(host_acc, final=True)
        else:
            folded = comb.fold()
            q = self._from_batch(folded, st["pschema"]).group_by(keys, merge_spec)
            out = self._host(self._finalize_query(q, plan, keys, node.schema))
        self._emit("stream_group_done", chunks=nchunks, groups=len(next(iter(out.values()))) if out else 0)
        return "small", out

    def _group_partial_tree(self, node, stream, keys, agg_list):
        """Combine-tree driver (``exec/combinetree.py``): chunk partials
        route into similarity-placed tree groups whose merges ELIDE the
        hash exchange (partials are co-hash-partitioned on the group
        keys, so one local reduce merges them).  Only the final
        merge+finalize query pays a full exchange.

        The host degrade is PER KEY RANGE: the driver hashes each raw
        chunk's keys host-side, folds them into a
        :class:`KeyRangeHistogram`, and ranges whose distinct-key
        estimate tracks their row count split out of later chunks and
        stream to host accumulation, while still-reducing ranges stay
        on the device."""
        cfg = self.ctx.config
        partial, plan = partial_plan(agg_list)
        merge_spec = merge_agg_spec(plan)
        scope = self._scope()
        cscope = self._scope()  # degraded-range (cold) chunk plans
        shape = TreeShape(self.ctx.mesh, cfg)
        ranges = int(cfg.combine_tree_ranges)
        planner = CombineTreePlanner(ranges, float(cfg.combine_tree_degrade_ratio))
        hist = KeyRangeHistogram(ranges)
        st = {"pschema": None}
        host_combine, compact = self._host_combiner(
            keys, merge_spec, plan, node.schema, shape, self._scope(), st,
        )

        def merge_local(batches):
            # every chunk's partial group_by hash-exchanged on the same
            # keys over the same partitions: the batches are
            # co-partitioned and the merge elides its exchange
            qs = [self._from_batch(b, st["pschema"]) for b in batches]
            q = qs[0].concat(*qs[1:]).assume_hash_partition(keys)
            # the local reduce keeps its input's layout: the concat's
            return _compacted(self._device(q.group_by(keys, merge_spec)),
                              sum(layout_rows(b) for b in batches))

        comb = TreeCombiner(merge_local, shape, self.combine_rows, self._emit)
        host_acc: List[Dict[str, np.ndarray]] = []
        host_rows = 0
        degraded: set = set()
        nchunks = 0
        for table in self._iter_base(stream):
            n = _chunk_rows(table)
            h = None
            if _hashable_keys(table, stream, keys):
                h = _host_key_hash64(table, keys, dictionary=self.ctx.dictionary)
            snap = None
            if h is not None:
                ch = KeyRangeHistogram(ranges)
                ch.observe(h)
                hist.merge(ch)
                snap = ch.snapshot()
            nchunks += 1
            hot: Optional[Dict[str, Any]] = table
            if degraded and h is not None:
                rid = KeyRangeHistogram.range_ids(h, ranges)
                cold_mask = np.isin(rid, np.fromiter(degraded, np.int64, len(degraded)))
                if cold_mask.any():
                    cold = {c: np.asarray(v)[cold_mask] for c, v in table.items()}
                    hot = (
                        {c: np.asarray(v)[~cold_mask] for c, v in table.items()}
                        if not cold_mask.all() else None
                    )
                    cq = self._chunk_partial_query(cscope, stream, cold, node, keys, partial)
                    if st["pschema"] is None:
                        st["pschema"] = cq.schema
                    pt = self._host(cq)
                    host_acc.append(pt)
                    host_rows += len(next(iter(pt.values()))) if pt else 0
            if hot is not None:
                pq = self._chunk_partial_query(scope, stream, hot, node, keys, partial)
                if st["pschema"] is None:
                    st["pschema"] = pq.schema
                batch = self._device(pq)  # stays on the device
                batch = _compacted(batch, layout_rows(batch))
                self._emit("stream_chunk", rows=n, partial_cap=layout_rows(batch))
                comb.push(batch, snap or neutral_snapshot(ranges))
            else:
                self._emit("stream_chunk", rows=n, partial_cap=0)
            if host_rows > self.combine_rows and len(host_acc) > 1:
                host_rows = compact(host_acc)
            if h is not None:
                planner.note_cumulative(hist.snapshot())
                new = planner.degrade_set()
                if new - degraded:
                    degraded = new
                    self._emit("combine_tree_degrade", degraded=len(degraded),
                               fraction=round(planner.degraded_fraction(), 4), chunks=nchunks)
        if st["pschema"] is None:  # empty stream
            return "small", _empty_table(node.schema)
        if not host_acc:
            # pure device path: collapse the survivors to ONE batch with
            # elided merges first (the root's exchange pays bytes in
            # proportion to what it ingests), then run the one exchanged
            # merge+finalize, accounted at the histogram's estimate of
            # the distinct keys
            folded = comb.fold(1)
            if not folded:  # every chunk was empty
                return "small", _empty_table(node.schema)
            root = folded[0]
            in_bytes = batch_bytes(root)
            est_rows = float(hist.distinct_estimates().sum()) if hist.rows else 0.0
            per_row = in_bytes / max(layout_rows(root), 1)
            out_bytes = int(min(in_bytes, per_row * max(est_rows, 1.0)))
            ici, dcn = shape.exchange_split(in_bytes, out_bytes)
            self._emit("combine_tree_level", level=comb.max_level + 1, fan_in=1,
                       cap_rows=layout_rows(root), bytes=in_bytes, ici_bytes=ici,
                       dcn_bytes=dcn, device=True)
            # the root's exchange may run at a tail fan-out width
            # (``tail_fanout_rows``); a compacted layout too narrow for it
            # would overflow into retries the reference's padded layout
            # never takes, so a small root holds all its rows a partition
            rows = sum(_each(root, lambda b: int(b.valid.sum())))
            if rows <= cfg.tail_fanout_rows and root.capacity < rows:
                root = _map(root, lambda b: b.pad_to(-(-rows // 8) * 8))
            q = self._from_batch(root, st["pschema"]).group_by(keys, merge_spec)
            out = self._host(self._finalize_query(q, plan, keys, node.schema))
        else:
            # degraded ranges finish host-side: the device remainder
            # folds once, pays ONE device->host copy, and merges with
            # the host accumulator in the final combine
            folded = comb.fold(1)
            tables = list(host_acc)
            if folded:
                tables.append(self._batch_to_host(folded[0], st["pschema"]))
            out = host_combine(tables, final=True)
        self._emit("stream_group_done", chunks=nchunks, groups=len(next(iter(out.values()))) if out else 0)
        return "small", out

    # ---- scalar aggregate ---------------------------------------------

    def _eval_aggregate(self, node: Node, stream: _Stream):
        from dryad_tpu_torch.api.query import Query

        agg_list = node.params["aggs"]
        bad = [op for op, _c, _o in agg_list if op not in MERGEABLE_AGGS or op == "first"]
        if bad:
            raise StreamNotSupported(f"streaming scalar aggregate cannot merge {bad}")
        partial, plan = partial_plan(agg_list)
        merge_spec = merge_agg_spec(plan)
        scope = self._scope(slots=1 if self._pipelined else self.chunk_fuse)
        fin = finalize_fn(plan)
        st = {"pschema": None}

        def chunk_query(table, sc=scope):
            q = sc.ingest(table, stream.base_schema)
            key = ("agg", q.node.id)
            pq = sc.chain_cache.get(key)
            if pq is None:
                cur = self._chain_root(sc, q, stream.pending)
                pq = Query(self.ctx, cur).aggregate_as_query(partial)
                if sc.cache_plans:
                    sc.chain_cache[key] = pq
            return pq

        def final(q):
            q = q.aggregate_as_query(merge_spec)
            return "small", self._host(q.select(lambda cols: fin(cols), schema=node.schema))

        if self._pipelined:
            # device-resident partials + N-ary device merge: one
            # device->host copy in all (scalar partials are one row
            # each, so flushes always reduce and never degrade)
            def merge_many(batches):
                qs = [self._from_batch(b, st["pschema"]) for b in batches]
                return self._device(qs[0].concat(*qs[1:]).aggregate_as_query(merge_spec))

            comb = _DeviceCombiner(
                merge_many, self.combine_rows, self._emit,
                split=TreeShape(self.ctx.mesh, self.ctx.config).exchange_split,
            )
            for table in self._iter_base(stream):
                pq = chunk_query(table)
                if st["pschema"] is None:
                    st["pschema"] = pq.schema
                comb.push(self._device(pq))
            folded = comb.fold()
            if folded is None:
                raise StreamNotSupported("scalar aggregate over an empty stream")
            return final(self._from_batch(folded, st["pschema"]))

        # serial driver: host partials, bounded by the SAME combine
        # threshold as the group partials
        acc_t: List[Dict[str, np.ndarray]] = []
        rows = [0]
        mscope = self._scope()

        def commit(pt):
            acc_t.append(pt)
            rows[0] += len(next(iter(pt.values()))) if pt else 0
            if rows[0] > self.combine_rows and len(acc_t) > 1:
                cat = _concat_tables(acc_t, st["pschema"])
                merged = self._host(mscope.ingest(cat, st["pschema"]).aggregate_as_query(merge_spec))
                acc_t[:] = [merged]
                rows[0] = len(next(iter(merged.values()))) if merged else 0
                self._emit("stream_combine", rows_out=rows[0], level=0, ici_bytes=0, dcn_bytes=0)

        if self._async_dispatch:
            # async serial driver: partial dispatches in flight through
            # the window; the accumulator commits in submit order
            def retry(table):
                return self._host(chunk_query(table, self._scope(cache=False)))

            dsp = self._dispatcher("aggpartial", retry=retry)
            try:
                for table in self._iter_base(stream):
                    pq = chunk_query(table)
                    if st["pschema"] is None:
                        st["pschema"] = pq.schema
                    dsp.submit(table, pq)
                    for _tag, pt in dsp.ready():
                        commit(pt)
                for _tag, pt in dsp.drain():
                    commit(pt)
            finally:
                dsp.close()
        else:
            for table in self._iter_base(stream):
                pq = chunk_query(table)
                if st["pschema"] is None:
                    st["pschema"] = pq.schema
                commit(self._host(pq))
        if st["pschema"] is None:
            raise StreamNotSupported("scalar aggregate over an empty stream")
        cat = _concat_tables(acc_t, st["pschema"])
        return final(mscope.ingest(cat, st["pschema"]))

    def _iter_base(self, stream: _Stream):
        """Non-empty base chunks, read ahead by the prefetch thread when
        the pipeline is on: the source's host work (tokenize, disk
        read, decode) for chunk k+2 overlaps the driver's dispatch of
        chunk k+1 (``exec/pipeline.py``)."""
        if stream.consumed:
            raise RuntimeError("stream already consumed (tee over streams needs an explicit to_store)")
        stream.consumed = True

        def nonempty():
            for table in stream.chunks:
                if _chunk_rows(table):
                    yield table

        yield from prefetched(nonempty(), self.pipeline_depth, events=self.events, name="ingest")

    # ---- distinct ------------------------------------------------------

    def _eval_distinct(self, node: Node, stream: _Stream):
        keys = list(node.params["keys"] or stream.schema.names)
        scope = self._scope()
        acc: List[Dict[str, np.ndarray]] = []
        acc_rows = 0
        spill = None
        writer = None
        try:
            for table in self._iter_base(stream):
                t = self._realize_table(table, stream, scope, extra=[node])
                rows = len(next(iter(t.values()))) if t else 0
                if spill is not None:
                    self._spill_by_hash(spill, t, keys, 0, writer=writer)
                    continue
                acc.append(t)
                acc_rows += rows
                if acc_rows > self.combine_rows and len(acc) > 1:
                    cscope = self._scope()
                    cat = _concat_tables(acc, node.schema)
                    merged = self._run_engine(self._clone(node, [cscope.ingest(cat, node.schema).node]))
                    acc = [merged]
                    acc_rows = len(next(iter(merged.values()))) if merged else 0
                    if acc_rows > self.bucket_rows:
                        # high cardinality: switch to Grace spilling
                        spill = self._spill_dir()
                        writer = self._spill_writer()
                        self._spill_by_hash(spill, merged, keys, 0, writer=writer)
                        acc = []
                        self._emit("stream_distinct_spill", rows=acc_rows)
            if writer is not None:
                writer.flush()
        except BaseException:
            if writer is not None:
                writer.close(drain=False)
                writer = None
            if spill is not None:
                spill.cleanup()
            raise
        finally:
            if writer is not None:
                writer.close()
        if spill is None:
            if not acc:
                return "small", _empty_table(node.schema)
            cscope = self._scope()
            cat = _concat_tables(acc, node.schema)
            return "small", self._run_engine(self._clone(node, [cscope.ingest(cat, node.schema).node]))

        def buckets():
            try:
                bscope = self._scope()
                for b in spill.buckets():
                    rows = spill.bucket_rows(b)
                    t = spill.read_bucket(b)
                    bscope.cap = self._bucket_cap(rows)
                    out = self._run_engine(self._clone(node, [bscope.ingest(t, node.schema).node]))
                    self._emit("stream_bucket", bucket=b, depth=0, rows=rows)
                    yield out
            finally:
                spill.cleanup()

        return "stream", _Stream(node.schema, buckets())

    # ---- order_by (external distribution sort) -------------------------

    def _eval_order_by(self, node: Node, stream: _Stream):
        keys = list(node.params["keys"])  # [(name, desc)]
        return "stream", _Stream(node.schema, self._external_sort(node, stream, keys))

    def _bucket_cap(self, rows: int) -> int:
        """Per-partition capacity of a bucket job from its OBSERVED rows:
        the next power-of-two step of the per-partition need (min 8),
        capped at the bucket budget.  The serial driver (depth 1) keeps
        the worst-case capacity: one program shape for all buckets."""
        P = self._P()
        full = max(1, math.ceil(self.bucket_rows / P / 8) * 8)
        if not self._pipelined:
            return full
        need = max(1, -(-max(rows, 1) // P))
        cap = 8
        while cap < need:
            cap *= 2
        return min(cap, full)

    def _external_sort(self, node, stream, keys, pieces=None, depth=0, splitters=None):
        """Route chunks to range buckets by the primary key, then sort
        each bucket on the device and emit in key order.  Oversized
        buckets re-split from observed volume; a single-value bucket
        falls through to the secondary keys (or emits as-is when none:
        equal-key order is unspecified).

        Pipelined: bucket writes go through the background SpillWriter
        so they overlap the next chunk's routing, and phase 2 keeps
        bucket sorts in flight (read/decode of bucket k+2 on the
        prefetch thread, dispatch of k+1, readback of k)."""
        primary, pdesc = keys[0]
        spill = self._spill_dir()
        writer = self._spill_writer()
        # rewrite-split hot buckets: bucket -> {"splitters", "spill",
        # "extent", "rows"}; rows landing in a refined bucket route
        # straight into its sub-range spill at depth+1 (the controller's
        # split_bucket action, claimed at chunk boundaries)
        refined: Dict[int, dict] = {}
        try:
            scope = self._scope()
            if pieces is not None:
                src = prefetched(
                    self._iter_pieces_realized(pieces), self.pipeline_depth,
                    events=self.events, name=f"resplit{depth}",
                )
            else:
                src = (self._realize_table(t, stream, scope) for t in self._iter_base(stream))
            # exact per-bucket key extent, tracked at spill time: the
            # all-equal decision below must not rest on a sample
            extent: Dict[int, Tuple] = {}
            for t in src:
                col = _sort_key_view(t[primary])
                if splitters is None:
                    splitters = _sample_splitters(col, self.num_buckets)
                # chunk boundary = safe application point: no partial
                # chunk is in flight, bucket contents are self-contained
                if self.rewriter is not None:
                    self._apply_sort_splits(spill, writer, refined, primary, depth)
                bids = _range_bucket_ids(splitters, col)
                for b, piece in _split_by_bucket(bids, t):
                    if b in refined:
                        self._route_refined(refined[b], piece, primary, depth)
                        continue
                    kcol = _sort_key_view(piece[primary])
                    mn, mx = kcol.min(), kcol.max()
                    if b in extent:
                        pmn, pmx = extent[b]
                        mn, mx = min(mn, pmn), max(mx, pmx)
                    extent[b] = (mn, mx)
                    self.metrics.observe("partition_rows", len(kcol), depth=depth)
                    if writer is not None:
                        writer.submit(spill, b, piece, depth)
                    else:
                        n = spill.append(b, piece)
                        self._emit("stream_spill", bucket=b, rows=n, depth=depth)
            if writer is not None:
                writer.flush()  # phase barrier: bucket metadata is final
            order = spill.buckets()
            if refined:
                order = sorted(set(order) | set(refined))
            if pdesc:
                order = list(reversed(order))
            yield from self._sort_buckets(node, spill, order, extent, keys, depth,
                                          refined=refined or None)
        finally:
            if writer is not None:
                writer.close(drain=False)
            for rec in refined.values():
                rec["spill"].cleanup()
            spill.cleanup()

    def _apply_sort_splits(self, spill, writer, refined, primary, depth):
        """Claim the pending split_bucket rewrites of this depth and
        turn each into a range refinement: sub-splitters from the
        bucket's spilled sample, its spilled pieces re-routed now, later
        rows routed on arrival (``_route_refined``).  Sub-buckets nest
        inside the parent range and emit in range order, so the sorted
        order, and every byte of it, stays as it was."""
        acts = [a for a in self.rewriter.claim_splits(depth)
                if int(a.params["bucket"]) not in refined]
        if not acts or depth >= self.max_split_depth:
            return
        if writer is not None:
            writer.flush()  # bucket piece lists must be final to reroute
        for act in acts:
            b = int(act.params["bucket"])
            if b not in spill.buckets():
                continue  # a diagnosis about another spill at this depth
            sample = _bucket_sample(spill, b, primary)
            sub = _splitters_from_sample(sample, int(act.params.get("fan", 8) or 8))
            if len(sub) == 0:
                continue  # single-valued: a range split cannot help
            rec = {"splitters": sub, "spill": self._spill_dir(), "extent": {}, "rows": 0}
            for piece in spill.read_bucket_pieces(b):
                self._route_refined(rec, piece, primary, depth)
            spill.drop_bucket(b)
            refined[b] = rec
            self._emit("plan_rewrite", phase="applied", action="split_bucket",
                       rule=act.rule, subject=act.subject, bucket=b, depth=depth,
                       fan=int(len(sub)) + 1)

    def _route_refined(self, rec, piece, primary, depth):
        """Route one piece of a rewrite-split bucket into its sub-range
        spill at ``depth + 1``, tracking exact sub-extents (the invariant
        phase 1 keeps for the parent buckets)."""
        col = _sort_key_view(piece[primary])
        bids = _range_bucket_ids(rec["splitters"], col)
        rspill = rec["spill"]
        for sb, sub in _split_by_bucket(bids, piece):
            kcol = _sort_key_view(sub[primary])
            mn, mx = kcol.min(), kcol.max()
            if sb in rec["extent"]:
                pmn, pmx = rec["extent"][sb]
                mn, mx = min(mn, pmn), max(mx, pmx)
            rec["extent"][sb] = (mn, mx)
            self.metrics.observe("partition_rows", len(kcol), depth=depth + 1)
            n = rspill.append(sb, sub)
            self._emit("stream_spill", bucket=sb, rows=n, depth=depth + 1)
            rec["rows"] += n

    def _sort_buckets(self, node, spill, order, extent, keys, depth, refined=None):
        """Phase 2 of the external sort: per-bucket device sorts in key
        order, with read-ahead and a bounded dispatch window when
        pipelined."""
        from dryad_tpu_torch.api.query import Query

        primary, _pdesc = keys[0]
        # one scope for all buckets: the pow2 capacity palette keeps
        # repeated bucket sizes on the same plan
        bscope = self._scope(slots=self.chunk_fuse)

        def reads():
            for b in order:
                if refined and b in refined:
                    # rewrite-split: its rows live in the sub-spill, the
                    # driver recurses below (never read whole)
                    yield b, refined[b]["rows"], None
                    continue
                rows = spill.bucket_rows(b)
                # oversized buckets are re-split by the driver, which
                # streams their pieces: don't read them whole ahead
                table = spill.read_bucket(b) if rows <= self.bucket_rows else None
                yield b, rows, table

        src = prefetched(reads(), self.pipeline_depth, events=self.events, name=f"sortread{depth}")
        inflight: deque = deque()  # (fetch, bucket, rows)

        def drain_one():
            fetch, b, rows = inflight.popleft()
            out = fetch()
            self._emit("stream_bucket", bucket=b, rows=rows, depth=depth)
            spill.drop_bucket(b)
            return out

        def retry(tag):
            # serial re-run of one bucket through a fresh scope (the
            # shared scope's cached node may have been rebound)
            b, rows, t = tag
            rscope = self._scope(cache=False)
            rscope.cap = self._bucket_cap(rows)
            return self._run_engine(self._clone(node, [rscope.ingest(t, node.schema).node]))

        dsp = self._dispatcher(f"sortdrain{depth}", retry=retry) if self._async_dispatch else None

        def committed(outcomes):
            for (db, drows, _dt), out in outcomes:
                self._emit("stream_bucket", bucket=db, rows=drows, depth=depth)
                spill.drop_bucket(db)
                yield out

        try:
            for b, rows, t in src:
                if t is not None:
                    bscope.cap = self._bucket_cap(rows)
                    cur = Query(self.ctx, self._clone(node, [bscope.ingest(t, node.schema).node]))
                    if dsp is not None:
                        # async drain path: the collector owns the
                        # readback, the driver commits in key order
                        dsp.submit((b, rows, t), cur)
                        yield from committed(dsp.ready())
                    elif self._pipelined:
                        inflight.append((self.ctx.run_to_host_async(cur), b, rows))
                        self._release([cur])
                        while len(inflight) >= self.pipeline_depth:
                            yield drain_one()
                    else:
                        out = self._run_engine(cur.node)
                        self._emit("stream_bucket", bucket=b, rows=rows, depth=depth)
                        yield out
                        spill.drop_bucket(b)
                    continue
                # refined or oversized: results must stay in key order,
                # so the dispatch window drains before the recursion
                if dsp is not None:
                    yield from committed(dsp.drain())
                while inflight:
                    yield drain_one()
                if refined and b in refined:
                    # rewrite-split bucket: its sub-ranges nest inside the
                    # parent range, so emitting them in range order here
                    # keeps the global sorted order exactly
                    rec = refined[b]
                    rorder = sorted(rec["spill"].buckets())
                    if _pdesc:
                        rorder = list(reversed(rorder))
                    self._emit("stream_bucket_split", bucket=b, rows=rows, depth=depth,
                               mode="rewrite", fanout=len(rorder))
                    yield from self._sort_buckets(node, rec["spill"], rorder, rec["extent"],
                                                  keys, depth + 1)
                    continue
                if depth >= self.max_split_depth:
                    raise RuntimeError(
                        f"sort bucket {b} still holds {rows} rows at "
                        f"split depth {depth}; raise stream_bucket_rows"
                    )
                mn, mx = extent[b]
                if mn == mx:  # exact: every primary value identical
                    if len(keys) > 1:
                        self._emit("stream_bucket_split", bucket=b, rows=rows, depth=depth,
                                   mode="secondary_key")
                        yield from self._external_sort(
                            node, None, keys[1:], pieces=(spill, b), depth=depth + 1,
                        )
                    else:
                        # all key values equal: any order is sorted
                        self._emit("stream_bucket_split", bucket=b, rows=rows, depth=depth,
                                   mode="equal_keys")
                        for piece in spill.read_bucket_pieces(b):
                            yield piece
                    spill.drop_bucket(b)
                    continue
                # fan-out from OBSERVED volume, splitters from the whole
                # bucket's sample (not its first piece)
                sample = _bucket_sample(spill, b, primary)
                fan = min(256, max(2, -(-rows // self.bucket_rows) * 2))
                sub = _splitters_from_sample(sample, fan)
                self._emit("stream_bucket_split", bucket=b, rows=rows, depth=depth,
                           mode="resplit", fanout=fan)
                yield from self._external_sort(
                    node, None, keys, pieces=(spill, b), depth=depth + 1, splitters=sub,
                )
                spill.drop_bucket(b)
            if dsp is not None:
                yield from committed(dsp.drain())
            while inflight:
                yield drain_one()
        finally:
            if dsp is not None:
                dsp.close()
            if hasattr(src, "close"):
                src.close()

    def _iter_pieces_realized(self, pieces):
        spill, b = pieces
        yield from spill.read_bucket_pieces(b)

    # ---- join ----------------------------------------------------------

    def _eval_join(self, node: Node):
        left, right = node.inputs
        lstream = self._reaches_stream(left)
        rstream = self._reaches_stream(right)
        if lstream and not rstream:
            rnode = self._materialize_small(right)
            k, s = self._eval(left)
            assert k == "stream"
            clone = self._clone(node, [None, rnode])  # input[0] = chain
            return "stream", s.with_pending(clone)
        # a stream on the RIGHT only: a per-chunk join with the
        # materialized left would duplicate left rows of outer kinds per
        # chunk, so both sides take the Grace path
        lk_cols = list(node.params["left_keys"])
        rk_cols = list(node.params["right_keys"])
        kl, ls = self._eval(left)
        kr, rs = self._eval(right)
        ls = ls if kl == "stream" else _table_as_stream(ls, left.schema)
        rs = rs if kr == "stream" else _table_as_stream(rs, right.schema)
        return "stream", _Stream(node.schema, self._grace_join(node, ls, rs, lk_cols, rk_cols))

    def _grace_join(self, node, ls, rs, lk, rk, depth=0):
        lspill = self._spill_dir()
        rspill = self._spill_dir()
        writer = self._spill_writer()
        # rewrite-split hot buckets: bucket -> (left sub-spill, right
        # sub-spill), re-hashed at salt depth+1 on BOTH sides so matching
        # keys stay co-bucketed (split_bucket, claimed at the chunk
        # boundaries of either side's spill loop)
        jrefined: Dict[int, Tuple[SpillDir, SpillDir]] = {}
        try:
            lscope = self._scope()
            rscope = self._scope()
            for side, (st, keys, spill, scope) in enumerate(
                ((ls, lk, lspill, lscope), (rs, rk, rspill, rscope))
            ):
                for t in (self._realize_table(x, st, scope) for x in self._iter_base(st)):
                    if self.rewriter is not None:
                        self._apply_join_splits(jrefined, lspill, rspill, lk, rk, writer, depth)
                    self._spill_by_hash(spill, t, keys, depth, writer=writer,
                                        refined=jrefined, side=side)
            if writer is not None:
                writer.flush()
            yield from self._join_buckets(node, lspill, rspill, lk, rk, depth,
                                          refined=jrefined or None)
        finally:
            if writer is not None:
                writer.close(drain=False)
            for l2, r2 in jrefined.values():
                l2.cleanup()
                r2.cleanup()
            lspill.cleanup()
            rspill.cleanup()

    def _apply_join_splits(self, jrefined, lspill, rspill, lk, rk, writer, depth):
        """Claim the pending split_bucket rewrites of this depth and
        re-hash each hot bucket into per-side sub-spills at depth+1: the
        salt and fan-out the oversized re-hash would use, so every key's
        co-bucketing, and so the join's output, is the same; only when
        the work happens changes."""
        acts = [a for a in self.rewriter.claim_splits(depth)
                if int(a.params["bucket"]) not in jrefined]
        if not acts or depth >= self.max_split_depth:
            return
        if writer is not None:
            writer.flush()  # bucket piece lists must be final to reroute
        for act in acts:
            b = int(act.params["bucket"])
            l2, r2 = self._spill_dir(), self._spill_dir()
            jrefined[b] = (l2, r2)
            for spill, sub, keys in ((lspill, l2, lk), (rspill, r2, rk)):
                if b in spill.buckets():
                    for piece in spill.read_bucket_pieces(b):
                        self._spill_by_hash(sub, piece, keys, depth + 1)
                    spill.drop_bucket(b)
            self._emit("plan_rewrite", phase="applied", action="split_bucket",
                       rule=act.rule, subject=act.subject, bucket=b, depth=depth)

    def _join_buckets(self, node, lspill, rspill, lk, rk, depth, refined=None):
        jkind = node.params.get("join_kind", "inner")
        # shared per-side scopes: the pow2 capacity palette keeps
        # repeated bucket sizes on the same join plan
        lscope = self._scope()
        rscope = self._scope()
        allb = set(lspill.buckets()) | set(rspill.buckets())
        if refined:
            allb |= set(refined)
        for b in sorted(allb):
            if refined and b in refined:
                # rewrite-split: both sides already re-hashed at depth+1;
                # join the sub-buckets in the parent's slot (where the
                # oversized re-hash would emit them)
                l2, r2 = refined[b]
                rows2 = (sum(l2.bucket_rows(x) for x in l2.buckets())
                         + sum(r2.bucket_rows(x) for x in r2.buckets()))
                self._emit("stream_bucket_split", bucket=b, rows=rows2, depth=depth,
                           mode="rewrite")
                yield from self._join_buckets(node, l2, r2, lk, rk, depth + 1)
                continue
            lrows = lspill.bucket_rows(b)
            rrows = rspill.bucket_rows(b)
            if lrows == 0 and jkind in ("inner", "left", "semi", "anti", "count", "ranked"):
                continue
            if rrows == 0 and jkind in ("inner", "semi", "ranked"):
                continue
            if lrows + rrows > self.bucket_rows:
                if depth >= self.max_split_depth:
                    raise RuntimeError(
                        f"join bucket {b} holds {lrows}+{rrows} rows at "
                        f"split depth {depth}; raise stream_bucket_rows "
                        "(skewed key?)"
                    )
                self._emit("stream_bucket_split", bucket=b, rows=lrows + rrows, depth=depth,
                           mode="rehash")
                l2 = self._spill_dir()
                r2 = self._spill_dir()
                try:
                    for piece in lspill.read_bucket_pieces(b):
                        self._spill_by_hash(l2, piece, lk, depth + 1)
                    for piece in rspill.read_bucket_pieces(b):
                        self._spill_by_hash(r2, piece, rk, depth + 1)
                    yield from self._join_buckets(node, l2, r2, lk, rk, depth + 1)
                finally:
                    l2.cleanup()
                    r2.cleanup()
                continue
            lt = lspill.read_bucket(b) or _empty_table(node.inputs[0].schema)
            rt = rspill.read_bucket(b) or _empty_table(node.inputs[1].schema)
            lscope.cap = self._bucket_cap(lrows)
            rscope.cap = self._bucket_cap(rrows)
            lq = lscope.ingest(lt, node.inputs[0].schema)
            rq = rscope.ingest(rt, node.inputs[1].schema)
            out = self._run_engine(self._clone(node, [lq.node, rq.node]))
            self._emit("stream_bucket", bucket=b, rows=lrows + rrows, depth=depth)
            yield out

    def _grace_buckets(self, sides, tail_nodes, out_schema):
        """Generic single-input Grace: spill each (stream, keys) side,
        then run the tail nodes per bucket (the non-mergeable
        group_by)."""
        (stream, keys), = sides
        spill = self._spill_dir()
        writer = self._spill_writer()
        try:
            scope = self._scope()
            for t in (self._realize_table(x, stream, scope) for x in self._iter_base(stream)):
                self._spill_by_hash(spill, t, keys, 0, writer=writer)
            if writer is not None:
                writer.flush()
            bscope = self._scope()
            for b in spill.buckets():
                rows = spill.bucket_rows(b)
                t = spill.read_bucket(b)
                bscope.cap = self._bucket_cap(rows)
                cur = bscope.ingest(t, stream.schema).node
                for n in tail_nodes:
                    cur = self._clone(n, [cur] + n.inputs[1:])
                out = self._run_engine(cur)
                self._emit("stream_bucket", bucket=b, depth=0, rows=rows)
                yield out
        finally:
            if writer is not None:
                writer.close(drain=False)
            spill.cleanup()

    def _spill_by_hash(self, spill, table, keys, depth, writer=None, refined=None, side=0):
        bids = _host_hash_buckets(table, keys, self.num_buckets, salt=depth,
                                  dictionary=self.ctx.dictionary)
        for b, piece in _split_by_bucket(bids, table):
            if refined and b in refined:
                # rewrite-split hot bucket: straight into this side's
                # sub-spill at depth+1 (the re-hash's salt)
                self._spill_by_hash(refined[b][side], piece, keys, depth + 1, writer=writer)
                continue
            # per-piece row histogram: the skew signal
            self.metrics.observe("partition_rows", _chunk_rows(piece), depth=depth)
            if writer is not None:
                writer.submit(spill, b, piece, depth)
                continue
            n = spill.append(b, piece)
            self._emit("stream_spill", bucket=b, rows=n, depth=depth)

    def _spill_dir(self) -> SpillDir:
        return SpillDir(self.ctx.dictionary, root=self._spill_root(), metrics=self.metrics)

    def _spill_root(self):
        import os
        import tempfile

        base = self.ctx.config.stream_spill_dir
        if base:
            os.makedirs(base, exist_ok=True)
            return tempfile.mkdtemp(prefix="spill_", dir=base)
        return None

    # ---- take / concat -------------------------------------------------

    def _eval_take(self, node: Node, s: _Stream):
        want = int(node.params["n"])

        def gen():
            got = 0
            for t in self._realized(s):
                rows = len(next(iter(t.values()))) if t else 0
                if got + rows >= want:
                    keep = want - got
                    yield {c: v[:keep] for c, v in t.items()}
                    return
                got += rows
                yield t

        return "stream", _Stream(node.schema, gen())

    def _eval_concat(self, node: Node):
        parts = [self._eval(i) for i in node.inputs]

        def gen():
            for k, v in parts:
                if k == "small":
                    yield v
                else:
                    yield from self._realized(v)

        return "stream", _Stream(node.schema, gen())


def _compacted(batch, nominal: int):
    """``batch`` with each partition's valid rows moved to its front
    (stably) and the layout cut to the largest count, rounded up to 8;
    ``nominal_rows`` records the reference's layout rows, which the
    tree's cadence follows.  The reference's partials and elided merges
    keep every input's padding (each partial's layout is twice its
    chunk's rows, and a merge's is the sum of its inputs'), so the
    tree's batches would grow with the stream, not with its keys; the
    rows, their order in each partition and every result stay the
    same.  Costs one read of the largest count.  Over the ranks of a
    context over several cards the cut is the largest count of all P
    partitions, so every rank keeps one capacity (its collectives'
    block sizes), the one-card batch's; each rank reads its own count
    and cuts its own part on its thread."""
    need = max(_each(batch, lambda b: int(b.valid.sum(-1).max())))
    cap = max(8, -(-need // 8) * 8)
    if cap < batch.capacity:
        batch = _map(batch, lambda b: b.take(b.compact_order()[:, :cap]))
    batch.nominal_rows = nominal
    return batch


def _each(batch, fn) -> list:
    """``[fn(batch)]``, or over the ranks ``fn`` of each rank's part, on
    its rank's thread."""
    return batch.each(fn) if isinstance(batch, RankBatches) else [fn(batch)]


def _map(batch, fn):
    """``fn(batch)``, or over the ranks the parts ``fn`` makes, each on
    its rank's thread."""
    return batch.map(fn) if isinstance(batch, RankBatches) else fn(batch)


# ---- host-side helpers -------------------------------------------------


def _concat_tables(tables: List[Dict[str, np.ndarray]], schema: Optional[Schema]) -> Dict[str, np.ndarray]:
    tables = [t for t in tables if t and len(next(iter(t.values())))]
    if not tables:
        if schema is None:
            return {}
        return _empty_table(schema)
    names = list(tables[0].keys())
    return {n: np.concatenate([np.asarray(t[n]) for t in tables]) for n in names}


def _empty_table(schema: Schema) -> Dict[str, np.ndarray]:
    out = {}
    for f in schema.fields:
        if f.ctype is ColumnType.STRING:
            out[f.name] = np.array([], object)
        else:
            out[f.name] = np.array([], f.ctype.numpy_dtype)
    return out


def _table_as_stream(table, schema) -> "_Stream":
    return _Stream(schema, iter([table]))


def _sort_key_view(col: np.ndarray) -> np.ndarray:
    """An order-preserving comparable view of a sort-key column.
    String columns become object arrays: numpy compares them lexically
    and reductions (min/max for the exact bucket extent) dispatch to
    Python comparisons, which fixed-width ``<U``/``<S`` dtypes lack."""
    a = np.asarray(col)
    if a.dtype.kind in ("U", "S"):
        return a.astype(object)
    return a


def _range_bucket_ids(splitters: np.ndarray, col: np.ndarray) -> np.ndarray:
    """``np.searchsorted(splitters, col, side="right")``, the reference's
    routing.  Integer keys go through ``torch.bucketize`` (the same ids),
    which takes a 2^30-row external sort on an H100 host from about 230 s
    to about 170 s (``chip_smoke.py``'s stream TeraSort, PERF.md section
    6); other key types have only numpy's."""
    if col.dtype.kind == "i" and np.asarray(splitters).dtype == col.dtype:
        return torch.bucketize(
            torch.from_numpy(np.ascontiguousarray(col)),
            torch.from_numpy(np.ascontiguousarray(splitters)), right=True,
        ).numpy()
    return np.searchsorted(splitters, col, side="right")


def _split_by_bucket(bids: np.ndarray, table):
    """``(bucket, piece)`` for each bucket id present, ascending; each
    piece keeps its rows' order.  The reference's ``np.unique`` plus one
    boolean mask per bucket, done as one stable counting sort and a
    gather per column."""
    if len(bids) == 0:
        return
    bids = np.asarray(bids)
    top = int(bids.max())
    order = np.argsort(bids.astype(np.uint8 if top < 256 else np.int64), kind="stable")
    counts = np.bincount(bids, minlength=top + 1)
    cols = {c: np.asarray(v)[order] for c, v in table.items()}
    at = 0
    for b in np.flatnonzero(counts):
        n = int(counts[b])
        yield int(b), {c: v[at : at + n] for c, v in cols.items()}
        at += n


def _sample_splitters(col: np.ndarray, buckets: int) -> np.ndarray:
    """B-1 value splitters from the first chunk (the 0.1% sampler
    collapsed onto the leading chunk; estimation error is repaired by
    observed-volume re-splits)."""
    n = len(col)
    if n == 0:
        return np.asarray([])
    take = min(n, 1 << 16)
    idx = np.linspace(0, n - 1, take).astype(np.int64)
    return _splitters_from_sample(col[idx], buckets)


def _splitters_from_sample(sample: np.ndarray, buckets: int) -> np.ndarray:
    if len(sample) == 0:
        return np.asarray([])
    s = np.sort(sample)
    pos = np.linspace(0, len(s) - 1, buckets + 1).astype(np.int64)[1:-1]
    return np.unique(s[pos])


def _bucket_sample(spill: SpillDir, bucket: int, primary: str) -> np.ndarray:
    vals = []
    for piece in spill.read_bucket_pieces(bucket):
        col = np.asarray(piece[primary])
        take = min(len(col), 4096)
        if take:
            vals.append(col[np.linspace(0, len(col) - 1, take).astype(np.int64)])
    return np.concatenate(vals) if vals else np.asarray([])


def _host_key_hash64(table, keys, salt: int = 0, dictionary=None) -> np.ndarray:
    """Deterministic 64-bit row hash over the key columns.  Equal
    logical values give equal words: strings hash via the engine
    dictionary and numerics widen to a canonical 64-bit pattern.  Feeds
    both the spill bucket ids and the combine tree's key-range
    histograms (same high bits, coarser modulus)."""
    n = len(np.asarray(table[keys[0]]))
    h = np.full(n, np.uint64(0x84222325 + salt * 0x1000193), np.uint64)
    for kcol in keys:
        a = np.asarray(table[kcol])
        if a.dtype == object or a.dtype.kind in ("U", "S"):
            uniq, inv = np.unique(a.astype(object), return_inverse=True)
            hs = np.asarray([dictionary.add(str(s)) for s in uniq], np.uint64)
            w = hs[inv]
        elif a.dtype.kind == "f":
            w = np.ascontiguousarray(a.astype(np.float64)).view(np.uint64)
        elif a.dtype.kind == "b":
            w = a.astype(np.uint64)
        else:
            w = a.astype(np.int64).view(np.uint64)
        h = (h ^ w) * _MIX
        h ^= h >> np.uint64(29)
    return h


def _host_hash_buckets(table, keys, buckets: int, salt: int = 0, dictionary=None) -> np.ndarray:
    """Deterministic row hash over the key columns -> bucket ids."""
    h = _host_key_hash64(table, keys, salt=salt, dictionary=dictionary)
    return ((h >> np.uint64(33)) % np.uint64(buckets)).astype(np.int64)


def _encode_store_part(table, schema: Schema, dictionary):
    """Host table -> physical store columns via the shared ingest
    encoding, so streamed parts read back through the same store
    binding as engine-written ones."""
    from dryad_tpu_torch.columnar.batch import encode_physical

    out = {}
    for f in schema.fields:
        out.update(encode_physical(f, np.asarray(table[f.name]), dictionary))
    return out
