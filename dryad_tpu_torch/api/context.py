"""DryadContext — the port's entry point and job driver.

The counterpart of ``dryad_tpu/api/context.py`` for ``from_arrays``
(with user-type ``codecs``), ``from_text`` (one path, a list of paths,
a str or bytes), ``from_store`` / ``to_store`` (partitioned stores by
path or URI, ``columnar/uri.py``), ``collect`` and ``submit``, the
out-of-core stream inputs (``from_stream``, ``text_stream``,
``store_stream``), whose plans run through ``exec/outofcore.py``, the
asynchronous result fetches of that driver (``run_to_host_async``,
``run_many_to_host_async``), the
tables pinned by ``Query.cache()`` (and ``release``), the subplans
of a ``do_while``, and the serving tier's surface: ``append_arrays``
(continuous ingest into a ``from_arrays`` table), ``query_fingerprint``
(the result-cache key), ``query_input_bytes`` (the admission cost) and
``is_stream_query``.  With ``config.checkpoint_dir`` set, jobs save and
resume stage outputs keyed by the inputs' content fingerprints
(``exec/checkpoint.py``).  Each ``run_*`` entry point runs under a
query trace context (``obs/tracectx.py``) when ``config.query_trace``
is on, so the job's spans and dispatch gaps carry its ``qid``.  A context owns one device (CUDA unless the caller
passes ``device="cpu"``; it never falls back by itself), P logical
partitions on it, or, with ``devices=``, several cards, one rank thread
a card holding ``P / len(devices)`` of the partitions (the reference's
single controller over ``jax.devices()``, ``parallel/ranks.py``), the
string dictionary, the job event log
(``exec/events.py``: a JSONL file under ``event_log_dir``, or memory
only), and a device-resident ingest cache keyed by binding, LRU by
bytes.  A cached table is a pin, not an entry of that cache: its budget
never evicts it.
"""

from __future__ import annotations

import itertools
import math
import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import Dict, Optional, Union

import numpy as np
import torch

from dryad_tpu_torch.api.query import JobHandle, Query
from dryad_tpu_torch.columnar.batch import ColumnBatch, decode_physical_table
from dryad_tpu_torch.columnar.schema import ColumnType, Schema, StringDictionary, unique_strings
from dryad_tpu_torch.exec.events import EventLog
from dryad_tpu_torch.exec.executor import GraphExecutor
from dryad_tpu_torch.obs import flightrec, tracectx
from dryad_tpu_torch.obs.diagnose import DiagnosisEngine
from dryad_tpu_torch.obs.telemetry import ResourceMonitor, device_memory_probe
from dryad_tpu_torch.parallel.distribute import from_host_table, from_physical_table, own_rows
from dryad_tpu_torch.parallel.mesh import (
    DEFAULT_PARTITIONS, PartitionMesh, make_hybrid_mesh, make_mesh, resolve_device,
)
from dryad_tpu_torch.parallel.partition import first_valid
from dryad_tpu_torch.parallel.ranks import RankBatches, RankGroup, join_rows, resolve_devices
from dryad_tpu_torch.plan.lower import lower
from dryad_tpu_torch.plan.nodes import Node, PartitionInfo
from dryad_tpu_torch.rewrite import RewriteController
from dryad_tpu_torch.utils.config import DryadConfig


_NP_TYPE_MAP = {
    np.dtype(np.int32): ColumnType.INT32,
    np.dtype(np.int64): ColumnType.INT64,
    np.dtype(np.float32): ColumnType.FLOAT32,
    np.dtype(np.float64): ColumnType.FLOAT64,
    np.dtype(np.bool_): ColumnType.BOOL,
    np.dtype(np.uint32): ColumnType.UINT32,
}


def _infer_schema(arrays: Dict[str, np.ndarray]) -> Schema:
    fields = []
    for name, a in arrays.items():
        a = np.asarray(a)
        if a.dtype == object or a.dtype.kind in ("U", "S"):
            fields.append((name, ColumnType.STRING))
        elif a.dtype in _NP_TYPE_MAP:
            fields.append((name, _NP_TYPE_MAP[a.dtype]))
        else:
            raise TypeError(f"column {name!r}: unsupported dtype {a.dtype}")
    return Schema(fields)


class DryadContext:
    def __init__(
        self,
        num_partitions_: Optional[int] = None,
        config: Optional[DryadConfig] = None,
        device: Union[None, str, torch.device] = None,
        local_debug: bool = False,
        mesh: Optional[PartitionMesh] = None,
        dcn_slices: Optional[int] = None,
        devices=None,
    ):
        """``devices``: several devices, a list or an int ``n`` (the
        first ``n`` visible cards): one rank thread a device holds
        ``num_partitions_ / len(devices)`` partitions (default one a
        device, as the reference's mesh), over a group made in this
        process (``parallel/ranks.py``: NCCL when each rank has a card
        of its own, else gloo).  A card the host lacks raises.  Without
        it the context holds all its partitions on one device.
        ``mesh``: the partitions' mesh (``parallel/mesh.py``), for
        instance a gang worker's, whose ranks each hold ``P / world``
        partitions; it fixes the partition count and the device.
        ``dcn_slices``: a hybrid mesh of that many slices
        (``make_hybrid_mesh``), ``num_partitions_ // dcn_slices``
        partitions each (``num_partitions_`` must divide), on one
        device; with ``devices``, each slice holds whole cards
        (``dcn_slices`` must divide the card count): slice ``d`` is
        cards ``d * C .. d * C + C - 1``, ``C = len(devices) /
        dcn_slices``, each rank with a sub-group for each axis.  Without
        either, ``make_mesh(num_partitions_)`` on ``device``, which
        spans the process group this process joined
        (``init_distributed``), if any."""
        self.config = config or DryadConfig()
        self.config.validate()
        # collect() runs the NumPy interpreter of exec/localdebug.py over
        # the logical plan instead of the engine (differential debugging)
        self.local_debug = local_debug
        self._ranks: Optional[RankGroup] = None
        if devices is not None:
            self._refuse_with_devices(mesh, local_debug)
            devs = resolve_devices(devices)
            self.device = devs[0]
            self.mesh = None  # rank 0's, once the ranks are built below
            self.num_partitions = num_partitions_ if num_partitions_ is not None else len(devs)
            if self.num_partitions < 1:
                raise ValueError("num_partitions_ must be >= 1")
        elif mesh is not None:
            if num_partitions_ is not None and num_partitions_ != mesh.P:
                raise ValueError(
                    f"pass either num_partitions_ or mesh (num_partitions_="
                    f"{num_partitions_}, mesh of {mesh.P} partitions)"
                )
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            self.device = mesh.device
            self.mesh = mesh
        elif dcn_slices is not None:
            # the hybrid mesh: ICI within a slice, DCN across slices
            self.device = resolve_device(device)
            if num_partitions_ is not None and num_partitions_ % dcn_slices != 0:
                raise ValueError(
                    f"num_partitions_ {num_partitions_} not divisible by dcn_slices {dcn_slices}"
                )
            ici = num_partitions_ // dcn_slices if num_partitions_ is not None else None
            self.mesh = make_hybrid_mesh(dcn_slices, ici, self.device)
        else:
            self.device = resolve_device(device)
            if (num_partitions_ or DEFAULT_PARTITIONS) < 1:
                raise ValueError("num_partitions_ must be >= 1")
            self.mesh = make_mesh(num_partitions_ or DEFAULT_PARTITIONS, self.device)
        if devices is None:
            self.num_partitions = self.mesh.P
        if devices is None and self.mesh.world > 1 and self.config.checkpoint_dir:
            raise NotImplementedError(
                "stage checkpoints of a gang (a mesh over several ranks) are "
                "not ported: ROADMAP queue 1 item 11"
            )
        self.dictionary = StringDictionary()
        self._bindings: Dict[int, tuple] = {}
        # True once a stream binding exists: the fast gate of the
        # per-collect stream check (``exec/outofcore.py::has_stream_input``)
        self._any_stream = False
        # column name -> TypeCodec of from_arrays(codecs=): expanded at
        # ingest, folded back at collect
        self._codecs: Dict[str, object] = {}
        # input node id -> (binding tuple, batch, bytes); the stored
        # binding identity invalidates the entry when a node is rebound
        self._device_cache: "OrderedDict[int, tuple]" = OrderedDict()
        # input node id -> content fingerprint of its binding (None: not
        # fingerprintable); dropped when the node is rebound
        self._binding_fp_cache: Dict[int, Optional[str]] = {}
        path = None
        if self.config.event_log_dir:
            path = os.path.join(self.config.event_log_dir, f"job-{int(time.time() * 1000)}.jsonl")
        self.events = EventLog(path, mem_cap=self.config.obs_events_mem_cap)
        # the flight recorder's ring taps this context's stream (dumped
        # when a job fails); a recorder already installed in the process
        # keeps its place and gains this stream as a tap
        if self.config.obs_flight_recorder:
            rec = flightrec.get_recorder()
            if rec is not None:
                self.events.add_tap(rec.record)
            else:
                flightrec.install_recorder(
                    capacity=self.config.flightrec_events,
                    snapshot_s=self.config.flightrec_snapshot_s,
                    dump_dir=self.config.flightrec_dir or self.config.event_log_dir or ".",
                    role="driver", events=self.events,
                )
        # the online diagnosis engine folds pathologies over the same
        # stream (obs/diagnose.py) and emits its diagnoses back into it;
        # the runtime plan rewriter folds those diagnoses into actions
        # the drivers poll at safe boundaries (rewrite/controller.py),
        # so it needs the engine upstream
        self.diagnosis: Optional[DiagnosisEngine] = None
        self.rewriter: Optional[RewriteController] = None
        if self.config.obs_diagnosis:
            self.diagnosis = DiagnosisEngine(config=self.config, events=self.events)
            self.events.add_tap(self.diagnosis.observe)
        if self.config.obs_diagnosis and self.config.plan_rewrite:
            self.rewriter = RewriteController(config=self.config, events=self.events)
            self.events.add_tap(self.rewriter.observe)
        # the resource sampler (obs/telemetry.py), paced by the event
        # flow (resident processes call ctx.telemetry.start()): its
        # samples feed the hbm_pressure rule upstream and the measured
        # headroom the adaptive dispatch depths read; None (local_debug,
        # obs_telemetry=False): the default depth
        self.telemetry: Optional[ResourceMonitor] = None
        self.headroom = None
        if self.config.obs_telemetry and not local_debug:
            self.telemetry = ResourceMonitor(
                interval_s=self.config.telemetry_sample_s, events=self.events,
                # every card of the context, summed, as the reference
                # sums the memory of its local devices
                device_memory_fn=device_memory_probe(devs if devices is not None else self.device),
            )
            self.headroom = self.telemetry.headroom
            self.events.add_tap(self.telemetry.observe)
        if devices is None:
            self.executor = GraphExecutor(
                self.num_partitions, self.config, self.device, self.events, mesh=self.mesh
            )
            self.executor.rewriter = self.rewriter
            self.executor.headroom = self.headroom
        else:
            self._build_ranks(devs, dcn_slices)
        # one job at a time: the executor keeps per-job state, and the
        # stream driver runs jobs from its prefetch threads too (a
        # group_by over a join's bucket stream); re-entrant for do_while
        self._job_lock = threading.RLock()
        # do_while body/cond plans, built once per function object
        self._subplans: Dict[tuple, tuple] = {}
        self.tokenizer_native = None  # set by from_text: which tokenizer ran
        # set by the store and multi-file paths: which I/O routines ran
        # (native or the Python twins); and the host timings (seconds)
        # and bytes of the last store read (read_s), store ingest
        # (repack_s, h2d_s) and to_store (run_s: the query, ingest
        # included; fetch_s: the device->host copy; write_s)
        self.io_native = None
        self.io_stats: Dict[str, float] = {}

    # -- several cards -----------------------------------------------------------
    @staticmethod
    def _refuse_with_devices(mesh, local_debug) -> None:
        if mesh is not None:
            raise ValueError("pass either devices or mesh")
        if local_debug:
            raise ValueError("local_debug runs the NumPy interpreter on the host: it takes no devices")

    def _build_ranks(self, devs, dcn_slices: Optional[int] = None) -> None:
        """One rank a device (``parallel/ranks.py``): rank 0's mesh and
        executor are the context's, and its events are the context's.
        ``dcn_slices``: a hybrid mesh over the cards."""
        from dryad_tpu_torch.parallel.multihost import group_timeout

        me = weakref.ref(self)  # the ranks must not keep the context alive
        if getattr(self, "_close_ranks", None) is not None:
            # the ranks it replaces: their graphs and tables go while their
            # group still stands, then their threads end
            for rc in self._ranks.contexts:
                rc._release()
            self._close_ranks()
        self._ranks = RankGroup(devs, self.num_partitions, group_timeout(),
                                make_context=lambda mesh: _RankContext(me(), mesh),
                                attach=lambda rc, mesh: rc._attach(mesh),
                                dcn_slices=dcn_slices)
        self._close_ranks = weakref.finalize(self, self._ranks.close)
        self._wire_rank0()

    def _wire_rank0(self) -> None:
        rc = self._ranks.contexts[0]
        self.mesh, self.executor, self.device = rc.mesh, rc.executor, rc.device

    @property
    def devices(self) -> list:
        """The devices the context's partitions lie on, in rank order."""
        return list(self._ranks.devices) if self._ranks is not None else [self.device]

    def rebuild_mesh(self, exclude_device_ids) -> None:
        """Elastic recovery (the reference's ``rebuild_mesh``): shrink the
        mesh past failed devices and rebuild the executors.  The ids are
        indices into the context's devices (``self.devices``).  Device
        bindings and the device cache are dropped (a cached table used
        afterwards raises); host and store bindings survive.  Over
        several cards the ranks are built anew over the surviving cards,
        each with the same partitions a card as before; excluding every
        device (a one-device context's only one) raises ``ValueError``.
        A hybrid mesh over cards keeps its 2-D structure (each slice
        sheds its cards, the slices shrink to the smallest survivor, an
        empty one goes), as the reference's ``exclude_devices``."""
        from dryad_tpu_torch.parallel.mesh import exclude_devices

        with self._job_lock:
            if self._ranks is None:
                self.mesh = exclude_devices(self.mesh, exclude_device_ids)
            else:
                keep = exclude_devices(self.mesh, exclude_device_ids)
                dcn = len(keep) if self.mesh.hybrid else None  # the surviving slices
                if dcn is not None:
                    keep = [d for row in keep for d in row]
                if len(keep) != len(self._ranks.devices):
                    local = self.num_partitions // len(self._ranks.devices)
                    self.num_partitions = local * len(keep)
                    self._build_ranks(keep, dcn)
                else:
                    for rc in self._ranks.contexts:
                        rc._device_cache.clear()
                        rc._attach(rc.mesh)
                    self._wire_rank0()
                if self.telemetry is not None:  # the headroom of the cards that remain
                    self.telemetry._device_memory = device_memory_probe(self.devices)
            for nid in [n for n, b in self._bindings.items() if b[0] == "device"]:
                del self._bindings[nid]
            self._device_cache.clear()
            if self._ranks is None:
                self.num_partitions = self.mesh.P
                self.executor = GraphExecutor(
                    self.num_partitions, self.config, self.device, self.events, mesh=self.mesh
                )
                self.executor.rewriter = self.rewriter
                self.executor.headroom = self.headroom

    def _run_ranks(self, queries, fetch: bool = False):
        """Lower once, then run the job on every rank at once: each rank
        binds its own blocks of the inputs and executes the graph on its
        context.  Returns one :class:`RankBatches` a query, or with
        ``fetch`` one host table's physical columns a query (each rank's
        valid rows fetched on its thread, joined in partition order);
        ``io_stats`` gains ``compute_s`` (the slowest rank's job) and
        ``gather_s`` (the rest of the call: the fetch and the join of the
        ranks' rows on the host)."""
        from dryad_tpu_torch.exec import faults

        with self._job_lock:
            t0 = time.perf_counter()
            graph = lower([q.node for q in queries], self.config, self.dictionary,
                          P=self.num_partitions)
            for n in graph.inputs.values():
                self._bound(n)  # the stale-binding error, raised here once
            fps = None
            if self.config.checkpoint_dir:
                fps = {nid: self._binding_fp(n) for nid, n in graph.inputs.items()}
            tctx = tracectx.current()
            # every rank reads the same rewrites and injected faults
            rewriter = _FrozenRewriter(self.rewriter) if self.rewriter is not None else None
            shared_faults = faults.registry.armed()

            def job(rc):
                t = time.perf_counter()
                with tracectx.activate(tctx):
                    rc.executor.rewriter = rewriter
                    rc.executor.shared_faults = shared_faults
                    rc.io_stats = {}
                    bindings = {nid: rc._bind_device(n) for nid, n in graph.inputs.items()}
                    out = rc.executor.execute(
                        graph, bindings, subquery_runner=rc._run_subquery, binding_fps=fps,
                        loop_lowerer=rc._lower_loop_stage,
                    )
                    batches = [out[graph.outputs[q.node.id]] for q in queries]
                    if not fetch:
                        return batches, time.perf_counter() - t, dict(rc.io_stats)
                    compute = time.perf_counter() - t
                    rows = [b.fetch_valid_rows(with_counts=True) for b in batches]
                    rc.io_stats["fetched_bytes"] = sum(b.nbytes() for b in batches)
                    return rows, compute, dict(rc.io_stats)

            per_rank = self._ranks.run(job)
            out = ([RankBatches([r[0][i] for r in per_rank], self._ranks)
                    for i in range(len(queries))]
                   if not fetch else
                   [join_rows([r[0][i] for r in per_rank], with_counts=True)
                    for i in range(len(queries))])
            wall = time.perf_counter() - t0
            compute = max(r[1] for r in per_rank)
            stats = [r[2] for r in per_rank]
            if any("h2d_bytes" in st for st in stats):
                # a store ingest: each rank copied its own partitions
                self.io_stats.update(
                    repack_s=max(st.get("repack_s", 0.0) for st in stats),
                    h2d_s=max(st.get("h2d_s", 0.0) for st in stats),
                    h2d_bytes=sum(st.get("h2d_bytes", 0) for st in stats),
                )
            self.io_stats.update(compute_s=compute, gather_s=wall - compute,
                                 fetched_bytes=sum(st.get("fetched_bytes", 0) for st in stats))
        return out

    # -- ingestion -----------------------------------------------------------
    def from_arrays(
        self,
        arrays: Dict[str, np.ndarray],
        schema: Optional[Schema] = None,
        partition_capacity: Optional[int] = None,
        codecs: Optional[Dict[str, object]] = None,
    ) -> Query:
        """A table from host arrays.  STRING values register in the
        dictionary now (the auto-dense rewrite codes against it at
        lowering); INT32 ranges feed the int auto-dense rewrite.
        ``codecs``: column name -> ``columnar.codecs.TypeCodec``; each
        coded column expands into typed columns here and folds back at
        collect."""
        if codecs:
            from dryad_tpu_torch.columnar.codecs import expand_arrays

            arrays = expand_arrays(arrays, codecs)
            self._codecs.update(codecs)
        schema = schema or _infer_schema(arrays)
        str_vocab = {}
        if self.config.auto_dense_strings:
            for name in schema.names:
                if schema.field(name).ctype is ColumnType.STRING and name in arrays:
                    hs = [self.dictionary.add(str(s)) for s in unique_strings(arrays[name])]
                    str_vocab[name] = np.sort(np.asarray(hs, dtype=np.uint64))
        col_stats = {}
        if self.config.auto_dense_ints:
            for name in schema.names:
                if schema.field(name).ctype is ColumnType.INT32 and name in arrays:
                    a = np.asarray(arrays[name])
                    if a.size:
                        col_stats[name] = (int(a.min()), int(a.max()))
        node = Node(
            "input", [], schema, PartitionInfo.roundrobin(),
            source="host", col_stats=col_stats, str_vocab=str_vocab,
        )
        self._bindings[node.id] = ("host", arrays, partition_capacity)
        return Query(self, node)

    def append_arrays(self, query: Query, arrays: Dict[str, np.ndarray]) -> Optional[str]:
        """Append host rows to a ``from_arrays`` table in place: the
        continuous-ingest write path.  The node keeps its identity
        (registered views and prepared queries keep pointing at it); its
        binding is rebound to the concatenated columns, so the device
        copy and the binding fingerprint drop, and the auto-dense
        metadata (string vocabulary, int key ranges) widens to the grown
        domain.  Returns the fingerprint the table had before the append
        (None when unfingerprintable): the key of every result cached
        over the old contents.  Takes the job lock, so an append never
        lands while a job binds or reads the table."""
        node = query.node
        with self._job_lock:
            binding = self._bindings.get(node.id)
            if node.kind != "input" or binding is None or binding[0] != "host":
                raise ValueError(
                    "append_arrays() takes a from_arrays table; got a "
                    f"{node.kind!r} node bound as "
                    f"{binding[0] if binding else None!r}"
                )
            if self._codecs and any(c in self._codecs for c in arrays):
                from dryad_tpu_torch.columnar.codecs import expand_arrays

                arrays = expand_arrays(
                    arrays, {c: self._codecs[c] for c in arrays if c in self._codecs}
                )
            _, old_arrays, cap = binding
            if set(arrays) != set(old_arrays):
                raise ValueError(
                    f"append columns {sorted(arrays)} != table columns "
                    f"{sorted(old_arrays)}"
                )
            old_fp = self._binding_fp(node)
            merged = {}
            for name, old in old_arrays.items():
                old = np.asarray(old)
                new = np.asarray(arrays[name])
                if old.dtype == object or old.dtype.kind in ("U", "S"):
                    new = np.asarray(new, object)
                elif new.dtype != old.dtype:
                    raise TypeError(
                        f"column {name!r}: append dtype {new.dtype} != "
                        f"table dtype {old.dtype}"
                    )
                merged[name] = np.concatenate(
                    [np.asarray(old, object) if old.dtype == object else old, new]
                )
            # widen the auto-dense gates for the new rows (a widened
            # vocabulary or range only loosens the gate)
            if self.config.auto_dense_strings:
                vocab = node.params.get("str_vocab") or {}
                for name in vocab:
                    if name in arrays:
                        hs = [self.dictionary.add(str(v)) for v in unique_strings(arrays[name])]
                        vocab[name] = np.unique(np.concatenate(
                            [vocab[name], np.asarray(hs, dtype=np.uint64)]
                        ))
                node.params["str_vocab"] = vocab
            if self.config.auto_dense_ints:
                stats = node.params.get("col_stats") or {}
                for name, (lo, hi) in list(stats.items()):
                    a = np.asarray(arrays.get(name, ()))
                    if a.size:
                        stats[name] = (min(lo, int(a.min())), max(hi, int(a.max())))
                node.params["col_stats"] = stats
            self._forget(node.id)
            self._bindings[node.id] = ("host", merged, cap)
        return old_fp

    def _tokenize_buf(self, buf: bytes):
        """Tokenize a byte buffer, registering tokens in the dictionary;
        returns the (h0, h1, r0, r1) physical columns and the sorted
        unique 64-bit hashes (the column's vocabulary)."""
        from dryad_tpu_torch.runtime import bindings as RB

        self.tokenizer_native = RB.native_loaded()
        h0, h1, r0, r1, starts, lens = RB.tokenize(buf)
        hashes = (h1.astype(np.uint64) << np.uint64(32)) | h0.astype(np.uint64)
        uniq, first_idx = np.unique(hashes, return_index=True)
        for h, i in zip(uniq.tolist(), first_idx.tolist()):
            s = int(starts[i])
            tok = buf[s : s + int(lens[i])].decode("utf-8", "replace")
            existing = self.dictionary._map.get(h)
            if existing is not None and existing != tok:
                raise ValueError(f"hash64 collision: {existing!r} vs {tok!r}")
            self.dictionary._map[h] = tok
        return h0, h1, r0, r1, uniq

    def from_text(self, data, column: str = "word") -> Query:
        """A one-STRING-column table of the whitespace-separated tokens
        of ``data``: a filesystem path, a list of paths (read through
        the prefetch channel: file i+1 is read while file i tokenizes),
        a str, or bytes."""
        if isinstance(data, (list, tuple)):
            from dryad_tpu_torch.runtime import bindings as RB

            self.io_native = RB.io_native_loaded()
            parts = []
            with RB.PrefetchChannel(list(data), depth=4, threads=2) as ch:
                for fbuf in ch:
                    parts.append(self._tokenize_buf(fbuf))
            if parts:
                h0, h1, r0, r1 = (np.concatenate([p[i] for p in parts]) for i in range(4))
                vocab = np.unique(np.concatenate([p[4] for p in parts]))
            else:
                h0 = h1 = r0 = r1 = np.zeros(0, np.uint32)
                vocab = np.zeros(0, np.uint64)
        else:
            if isinstance(data, str) and os.path.exists(data):
                with open(data, "rb") as fh:
                    buf = fh.read()
            elif isinstance(data, str):
                buf = data.encode("utf-8")
            else:
                buf = bytes(data)
            h0, h1, r0, r1, vocab = self._tokenize_buf(buf)
        node = Node(
            "input", [], Schema([(column, ColumnType.STRING)]),
            PartitionInfo.roundrobin(), source="host_physical",
            str_vocab={column: vocab},
        )
        self._bindings[node.id] = (
            "host_physical",
            {f"{column}#h0": h0, f"{column}#h1": h1,
             f"{column}#r0": r0, f"{column}#r1": r1},
        )
        return Query(self, node)

    def from_stream(self, chunks, schema: Optional[Schema] = None) -> Query:
        """Out-of-core input: an iterable of host tables, processed as
        bounded chunks by the streaming driver (``exec/outofcore.py``).
        Queries over it run the row-local operators per chunk, plus
        group_by/aggregate/distinct (partial combine), order_by
        (external distribution sort), join (Grace bucketing), take and
        concat.  Without ``schema`` the first chunk's dtypes give it."""
        from dryad_tpu_torch.exec.outofcore import ChunkSource

        it = iter(chunks)
        if schema is None:
            first = next(it, None)
            if first is None:
                raise ValueError("an empty stream needs an explicit schema")
            first = {k: np.asarray(v) for k, v in first.items()}
            schema = _infer_schema(first)
            it = itertools.chain([first], it)
        node = Node("input", [], schema, PartitionInfo.roundrobin(), source="stream")
        self._bindings[node.id] = ("stream", ChunkSource(it, schema))
        self._any_stream = True
        return Query(self, node)

    def text_stream(self, paths, chunk_bytes: int = 1 << 25, column: str = "word") -> Query:
        """Chunked tokenizing text input for corpora larger than memory
        (the streaming ``from_text``).  Chunks split at whitespace, so
        no token straddles two, and arrive as the tokenizer's physical
        columns (hash and prefix-rank words) with their vocabulary."""
        if isinstance(paths, str):
            paths = [paths]
        schema = Schema([(column, ColumnType.STRING)])

        def phys(buf):
            h0, h1, r0, r1, vocab = self._tokenize_buf(buf)
            return {
                f"{column}#h0": h0, f"{column}#h1": h1,
                f"{column}#r0": r0, f"{column}#r1": r1,
                "#vocab": {column: vocab},
            }

        def gen():
            for p in paths:
                with open(p, "rb") as fh:
                    carry = b""
                    while True:
                        buf = fh.read(chunk_bytes)
                        if not buf:
                            if carry.strip():
                                yield phys(carry)
                            break
                        buf = carry + buf
                        # cut at the last whitespace so tokens stay whole
                        cut = max(buf.rfind(b" "), buf.rfind(b"\n"),
                                  buf.rfind(b"\t"), buf.rfind(b"\r"))
                        if cut <= 0:
                            carry = buf
                            continue
                        chunk, carry = buf[:cut], buf[cut:]
                        if chunk.strip():
                            yield phys(chunk)

        return self.from_stream(gen(), schema)

    def store_stream(self, path: str, parts_per_chunk: int = 1) -> Query:
        """A local store as a chunk stream, ``parts_per_chunk``
        partition files a chunk: the out-of-core ``from_store``."""
        from dryad_tpu_torch.columnar.io import _part_name, load_store_meta, read_partition_file

        manifest, schema, dict_map = load_store_meta(path)
        self.dictionary._map.update(dict_map)

        def flush(batch):
            if len(batch) == 1:
                return batch[0]
            return {c: np.concatenate([b[c] for b in batch]) for c in batch[0]}

        def gen():
            batch: list = []
            for i in range(manifest["partitions"]):
                phys = read_partition_file(os.path.join(path, _part_name(i)))
                batch.append(decode_physical_table(schema, slice(None), phys, self.dictionary))
                if len(batch) >= parts_per_chunk:
                    yield flush(batch)
                    batch = []
            if batch:
                yield flush(batch)

        return self.from_stream(gen(), schema)

    def from_store(self, path: str) -> Query:
        """A table from a store by path or URI (``columnar/uri.py``:
        partfile://, file://, mem://, hdfs://, wasb://, abfs://).  The
        store's dictionary merges into the context's, and every STRING
        column takes the store's hashes as its vocabulary (a superset
        per column, still a sound auto-dense gate)."""
        from dryad_tpu_torch.columnar.uri import read_store_uri
        from dryad_tpu_torch.runtime import bindings as RB

        t0 = time.perf_counter()
        schema, parts, dictionary = read_store_uri(path)
        self.io_native = RB.io_native_loaded()
        self.io_stats.update(
            read_s=time.perf_counter() - t0,
            read_bytes=sum(a.nbytes for cols in parts for a in cols.values()),
        )
        self.dictionary = self.dictionary.merge(dictionary)
        store_hashes = np.sort(np.fromiter(dictionary._map.keys(), dtype=np.uint64))
        node = Node(
            "input", [], schema, PartitionInfo.roundrobin(), source="store",
            str_vocab={
                f.name: store_hashes for f in schema.fields if f.ctype is ColumnType.STRING
            },
        )
        self._bindings[node.id] = ("store", parts, schema)
        return Query(self, node)

    def _from_device_batch(
        self, batch: ColumnBatch, schema: Schema, partition: Optional[PartitionInfo] = None
    ) -> Query:
        """A query over a device-resident batch.  ``partition``: the
        producing node's claim, which the batch's layout meets, so a
        consumer keyed the same elides its exchange."""
        node = Node("input", [], schema, partition or PartitionInfo(), source="device")
        self._bindings[node.id] = ("device", batch)
        return Query(self, node)

    def release(self, query: Query) -> None:
        """Drop a table pinned by ``Query.cache()``; later use of the
        query raises the stale-binding error.  Only such queries
        qualify: releasing a source table or a derived query raises.
        The stage programs whose buffers hold a copy of the table (a
        CUDA graph's inputs, ``exec/programs.py``) go with it."""
        binding = self._bindings.get(query.node.id)
        if query.node.kind != "input" or binding is None or binding[0] != "device":
            raise ValueError(
                "release() takes the query returned by cache(); got a "
                f"{query.node.kind!r} node bound as "
                f"{binding[0] if binding else None!r}"
            )
        self._forget(query.node.id)

    def _forget(self, node_id: int, programs: bool = True) -> None:
        """Forget a table: the node's binding, its fingerprint and its
        device copy, in the driver's cache and in every rank's (each rank
        of a context over several cards ingests its own blocks into its
        own cache), with the stage programs whose buffers hold a copy of
        it or of a pinned table (a CUDA graph's inputs).  ``programs``
        False keeps the programs, for a table whose successor has its
        shape (a stream's next chunk, a view's next finalize): it replays
        into the same buffers.  Under the job lock, so no job binds or
        reads the table meanwhile."""
        with self._job_lock:
            binding = self._bindings.pop(node_id, None)
            self._binding_fp_cache.pop(node_id, None)
            pinned = binding[1] if binding is not None and binding[0] == "device" else None
            ranks = [self]
            if self._ranks is not None:  # each rank bound its own blocks
                self._device_cache.pop(node_id, None)
                ranks = self._ranks.contexts
            for r, rc in enumerate(ranks):
                hit = rc._device_cache.pop(node_id, None)
                if not programs:
                    continue
                part = pinned.parts[r] if isinstance(pinned, RankBatches) else pinned
                for batch in (hit[1] if hit is not None else None, part):
                    if batch is not None:
                        rc.executor.programs.drop_holding(batch)

    # -- execution -------------------------------------------------------------
    def _bound(self, node: Node) -> tuple:
        if node.id not in self._bindings:
            raise RuntimeError(
                f"input node {node.id} has no binding: its device-"
                "resident table was dropped (rebuild_mesh clears cached "
                "tables; release() drops them explicitly) — re-run "
                ".cache() or re-ingest"
            )
        return self._bindings[node.id]

    def _bind_device(self, node: Node) -> ColumnBatch:
        binding = self._bound(node)
        if binding[0] == "device":
            b = binding[1]  # a pin, outside the ingest cache
            return b.parts[self.mesh.rank] if isinstance(b, RankBatches) else b
        budget = self.config.device_cache_bytes
        hit = self._device_cache.get(node.id)
        if hit is not None and hit[0] is binding:
            self._device_cache.move_to_end(node.id)
            return hit[1]
        self._device_cache.pop(node.id, None)
        batch = self._ingest(binding, node)
        if budget:
            self._device_cache[node.id] = (binding, batch, batch.nbytes())
            total = sum(e[2] for e in self._device_cache.values())
            while total > budget and len(self._device_cache) > 1:
                _, (_, _, freed) = self._device_cache.popitem(last=False)
                total -= freed
        return batch

    def _ingest(self, binding, node: Node) -> ColumnBatch:
        kind, *rest = binding
        if kind == "host":
            arrays, cap = rest
            return from_host_table(
                node.schema, arrays, self.mesh, partition_capacity=cap,
                dictionary=self.dictionary,
            )
        if kind == "host_physical":
            # a stream chunk carries the capacity its scope fixed
            cap = rest[1] if len(rest) > 1 else None
            return from_physical_table(rest[0], self.mesh, cap)
        if kind == "store":
            return self._ingest_store(*rest)
        if kind == "stream":
            raise RuntimeError(
                "a chunk-stream input cannot bind as a device table; "
                "this operator needs the whole input resident (e.g. "
                "cache/apply) — materialize with to_store() first"
            )
        raise RuntimeError(f"unknown binding kind {kind}")

    def _ingest_store(self, parts, schema: Schema) -> ColumnBatch:
        """The reference's store binding: store partition i folds into
        partition ``i % P``, ``cap = ceil(max rows / 8) * 8``, and one
        host ``(P, cap)`` layout per physical column (in the device
        carrier's dtype; page-locked when the target is the card) is
        the one copy of the rows, then copied to the device."""
        t0 = time.perf_counter()
        P = self.num_partitions
        phys = schema.device_names()
        folded: list = [[] for _ in range(P)]
        for i, cols in enumerate(parts):
            folded[i % P].append(cols)
        rows_per = [sum(_rows(c) for c in group) for group in folded]
        cap = math.ceil(max(max(rows_per, default=1), 1) / 8) * 8
        folded = folded[own_rows(self.mesh)]  # a gang rank uploads its partitions only
        pin = self.device.type == "cuda"
        L = len(folded)
        data = {
            c: torch.zeros((L, cap), dtype=_carrier(c, schema), pin_memory=pin) for c in phys
        }
        valid = torch.zeros((L, cap), dtype=torch.bool, pin_memory=pin)
        host = {c: t.numpy() for c, t in data.items()}
        vhost = valid.numpy()
        for p, group in enumerate(folded):
            at = 0
            for cols in group:
                n = _rows(cols)
                for c in phys:
                    host[c][p, at : at + n] = cols[c]
                vhost[p, at : at + n] = True
                at += n
        t1 = time.perf_counter()
        batch = ColumnBatch(
            {c: t.to(self.device, non_blocking=True) for c, t in data.items()},
            valid.to(self.device, non_blocking=True),
        )
        if pin:
            torch.cuda.current_stream(self.device).synchronize()
        self.io_stats.update(
            repack_s=t1 - t0, h2d_s=time.perf_counter() - t1, h2d_bytes=batch.nbytes(),
        )
        return batch

    def _binding_fp(self, node: Node) -> Optional[str]:
        """Content SHA-1 of a plan input's binding (the checkpoint and
        result-cache identity); None for device and stream bindings,
        which cannot be fingerprinted without a copy.  Cached per input
        node until it is rebound."""
        if node.id in self._binding_fp_cache:
            return self._binding_fp_cache[node.id]
        from dryad_tpu_torch.exec.checkpoint import content_fingerprint

        kind, *rest = self._bindings[node.id]
        fp = None
        if kind == "host":
            arrays, cap = rest
            fp = content_fingerprint({str(k): np.asarray(v) for k, v in arrays.items()}) + f":{cap}"
        elif kind == "host_physical":
            phys, *opt = rest
            fp = content_fingerprint(phys) + (f":{opt[0]}" if opt else "")
        elif kind == "store":
            parts, _schema = rest
            fp = content_fingerprint(
                {f"p{i}/{c}": v for i, cols in enumerate(parts) for c, v in cols.items()}
            )
        self._binding_fp_cache[node.id] = fp
        return fp

    # -- serving-tier surface --------------------------------------------------
    def is_stream_query(self, query: Query) -> bool:
        """True when the plan draws on a chunk-stream binding: such
        plans run through the stream driver, not the asynchronous
        dispatch path, and are not cacheable."""
        from dryad_tpu_torch.exec.outofcore import has_stream_input

        return has_stream_input(self, query.node)

    def query_fingerprint(self, query: Query):
        """The result-cache key of a query: ``(graph_key, (position,
        output), binding fingerprints)``, or None when it is uncacheable
        (a stream input, or a binding whose content cannot be
        fingerprinted without a copy).  Plan structure is the executor's
        ``graph_key``: value-hashable params match across rebuilt
        queries, function-valued ones only when run again from the same
        ``Query``.  The output is named by its stage's position in the
        lowered graph (stage ids are fresh per lowering); the inputs by
        their content fingerprints in plan creation order."""
        if self.is_stream_query(query):
            return None
        with self._job_lock:
            graph = lower([query.node], self.config, self.dictionary, P=self.num_partitions)
            fps = []
            for nid in sorted(graph.inputs):
                fp = self._binding_fp(graph.inputs[nid])
                if fp is None:
                    return None
                fps.append(fp)
        sid, oidx = graph.outputs[query.node.id]
        pos = {s.id: i for i, s in enumerate(graph.stages)}[sid]
        return (self.executor.graph_key(graph), (pos, oidx), tuple(fps))

    def query_input_bytes(self, query: Query) -> int:
        """Host bytes bound under the plan: the admission cost of a
        query (device and stream bindings count zero: no host copy is
        admitted on their behalf).  The reference's rule, so a host
        table costs the same bytes in both packages."""
        total = 0
        seen = set()
        stack = [query.node]
        while stack:
            node = stack.pop()
            if node.id in seen:
                continue
            seen.add(node.id)
            stack.extend(node.inputs)
            binding = self._bindings.get(node.id)
            if binding is None:
                continue
            kind, *rest = binding
            if kind == "host":
                total += sum(np.asarray(v).nbytes for v in rest[0].values())
            elif kind == "host_physical":
                total += sum(np.asarray(v).nbytes for v in rest[0].values())
            elif kind == "store":
                total += sum(np.asarray(v).nbytes for cols in rest[0] for v in cols.values())
        return total

    def _trace_ctx(self):
        """The active trace context, or a fresh one for a job outside
        any query scope; None (a no-op under ``tracectx.activate``) when
        ``config.query_trace`` is off."""
        ctx = tracectx.current()
        if ctx is None and self.config.query_trace:
            ctx = tracectx.mint()
        return ctx

    def _run_graph(self, queries, defer_miss: bool = False):
        if self._ranks is not None:
            # each rank checked its misses at its job's end
            return self._run_ranks(queries), (_Finished() if defer_miss else None)
        with self._job_lock:
            graph = lower([q.node for q in queries], self.config, self.dictionary, P=self.num_partitions)
            bindings = {nid: self._bind_device(n) for nid, n in graph.inputs.items()}
            binding_fps = None
            if self.config.checkpoint_dir:
                binding_fps = {nid: self._binding_fp(n) for nid, n in graph.inputs.items()}
            out = self.executor.execute(
                graph, bindings, subquery_runner=self._run_subquery, defer_miss=defer_miss,
                binding_fps=binding_fps, loop_lowerer=self._lower_loop_stage,
            )
        results, deferred = out if defer_miss else (out, None)
        return [results[graph.outputs[q.node.id]] for q in queries], deferred

    def execute(self, query: Query, defer_miss: bool = False):
        """Lower and run a query; the result batch stays on the device.
        ``defer_miss``: returns ``(batch, DeferredFinish)`` and leaves
        the dictionary-miss check to the caller's ``finish()``."""
        (batch,), deferred = self._run_graph([query], defer_miss)
        return (batch, deferred) if defer_miss else batch

    def _refuse_gang(self, what: str) -> None:
        """A rank of a gang holds only its own partitions: results leave
        as partition files (``cluster/worker.py``), never as one table.
        The ranks of a context over several cards are its own threads,
        whose partitions it joins."""
        if self.mesh.world > 1 and self.mesh.link is None:
            raise RuntimeError(
                f"{what} on a context whose mesh spans {self.mesh.world} ranks: "
                "this rank holds partitions "
                f"{self.mesh.base}..{self.mesh.base + self.mesh.local - 1} of "
                f"{self.mesh.P}; the gang writes each rank's partitions as "
                "partition files instead (LocalJobSubmission.submit)"
            )

    def _host_table(self, query: Query, batch: ColumnBatch) -> Dict[str, np.ndarray]:
        self._refuse_gang("collect()")
        # device->host byte accounting (obs/metrics.py): every result
        # fetch funnels through here or the stream driver
        self.executor.metrics.add("d2h_bytes", batch.nbytes())
        return self._decode(query, batch.fetch_valid_rows())

    def _decode(self, query: Query, host: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """A result's valid physical rows -> its logical host table (the
        strings decoded with the context's dictionary)."""
        table = decode_physical_table(query.schema, slice(None), host, self.dictionary)
        if self._codecs:
            from dryad_tpu_torch.columnar.codecs import collapse_table

            table = collapse_table(table, self._codecs)
        return table

    def run_to_host(self, query: Query) -> Dict[str, np.ndarray]:
        # the job's spans and dispatch gaps carry this context's qid
        with tracectx.activate(self._trace_ctx()):
            return self._run_to_host(query)

    def _run_to_host(self, query: Query) -> Dict[str, np.ndarray]:
        from dryad_tpu_torch.exec.outofcore import StreamExecutor, has_stream_input

        self._refuse_gang("collect()")
        if has_stream_input(self, query.node):
            if self.local_debug:
                raise RuntimeError(
                    "from_stream inputs are not supported in local_debug "
                    "mode (the NumPy interpreter holds whole tables); "
                    "materialize the chunks and use from_arrays"
                )
            return StreamExecutor(self).run_to_host(query.node)
        if self.local_debug:
            from dryad_tpu_torch.exec.localdebug import LocalDebugInterpreter

            return LocalDebugInterpreter(self).run_to_logical(query.node)
        if self._ranks is not None:
            # every rank fetches its own rows on its thread
            ((host, _counts),) = self._run_ranks([query], fetch=True)
            # the whole table's bytes, every rank's part (the one-card count)
            self.executor.metrics.add("d2h_bytes", self.io_stats["fetched_bytes"])
            return self._decode(query, host)
        return self._host_table(query, self.execute(query))

    def _fetch(self, query: Query, batch: ColumnBatch, deferred, tctx):
        """A zero-arg closure that runs ``deferred``'s miss check (when
        given) and copies ``batch`` to the host as ``query``'s table,
        under the trace context ``tctx`` (a fetch drained on another
        thread still stamps its spans with the query's qid).  Over
        several cards each rank copies its rows on its own thread
        (``RankBatches.fetch_valid_rows``), never the draining one."""
        def fetch() -> Dict[str, np.ndarray]:
            with tracectx.activate(tctx):
                if deferred is not None:
                    deferred.finish()
                try:
                    return self._host_table(query, batch)
                except Exception as e:  # the copy failed: close the job out
                    if deferred is not None:
                        deferred.abort(f"output transfer failed: {e!r}")
                    raise

        return fetch

    def run_to_host_async(self, query: Query):
        """Dispatch the job now; return a zero-arg ``fetch`` closure that
        checks its dictionary-miss counters and copies the result to the
        host (the streaming driver's dispatch/drain split: bucket k+1's
        job is queued while bucket k's result copies).  Not for plans
        over a stream input."""
        tctx = self._trace_ctx()
        with tracectx.activate(tctx):
            batch, deferred = self.execute(query, defer_miss=True)
        return self._fetch(query, batch, deferred, tctx)

    def run_many_to_host_async(self, queries):
        """Lower SEVERAL independent queries as one job (cross-chunk
        fusion, ``config.chunk_fuse``); one ``fetch`` closure each.
        Each query stays its own computation, so results equal separate
        runs.  The miss check rides the FIRST fetch: a miss anywhere in
        the group raises there, before any result is committed."""
        tctx = self._trace_ctx()
        with tracectx.activate(tctx):
            batches, deferred = self._run_graph(list(queries), defer_miss=True)
        return [
            self._fetch(q, b, deferred if i == 0 else None, tctx)
            for i, (q, b) in enumerate(zip(queries, batches))
        ]

    def submit(self, query: Query) -> JobHandle:
        return JobHandle(self.run_to_host(query))

    def to_store(self, query: Query, path: str) -> JobHandle:
        """Execute and persist as a store by path or URI: one part file
        per partition holding that partition's valid rows (columns in
        name order, as the reference's host fetch returns them), then
        the manifest and the dictionary.  The column codec is
        ``config.intermediate_compression``.  A plan over a stream input
        writes a local store as it streams, one part file per non-empty
        piece; its handle's table holds the row count."""
        with tracectx.activate(self._trace_ctx()):
            return self._to_store(query, path)

    def _to_store(self, query: Query, path: str) -> JobHandle:
        from dryad_tpu_torch.columnar.uri import write_store_uri
        from dryad_tpu_torch.exec.outofcore import StreamExecutor, has_stream_input
        from dryad_tpu_torch.runtime import bindings as RB

        self._refuse_gang("to_store()")
        if has_stream_input(self, query.node):
            # results stream into the store one part file per piece
            rows = StreamExecutor(self).to_store(query.node, path)
            return JobHandle({"rows": np.asarray([rows])}, path)
        t_run = time.perf_counter()
        if self._ranks is not None:
            ((host, counts),) = self._run_ranks([query], fetch=True)
            t0 = t_run + self.io_stats["compute_s"]
        else:
            batch = self.execute(query)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            host, counts = batch.fetch_valid_rows(with_counts=True)
        t1 = time.perf_counter()
        bounds = np.concatenate([[0], np.cumsum(counts)])
        names = sorted(host)
        parts = [
            {c: host[c][bounds[i] : bounds[i + 1]] for c in names}
            for i in range(len(counts))
        ]
        self.io_native = RB.io_native_loaded()
        write_store_uri(
            path, parts, query.schema, self.dictionary, self.config.intermediate_compression,
        )
        self.io_stats.update(
            run_s=t0 - t_run, fetch_s=t1 - t0, write_s=time.perf_counter() - t1,
            write_bytes=sum(a.nbytes for a in host.values()),
        )
        table = decode_physical_table(query.schema, slice(None), host, self.dictionary)
        return JobHandle(table, path)

    # -- do_while support ------------------------------------------------------
    def _lower_loop_stage(self, plan_fn, schema: Schema, example: ColumnBatch):
        """Lower a do_while body or condition subplan to ONE stage for the
        on-device loop; returns ``(stage, output schema)``.  Raises
        ValueError when the subplan needs more than one stage or its
        stage is not one input to one output: the executor then runs its
        driver loop."""
        q0 = self._from_device_batch(example, schema)
        try:
            out_q = plan_fn(q0)
            graph = lower([out_q.node], self.config, self.dictionary, P=self.num_partitions)
        finally:  # lowering reads the node, not its binding: pin nothing
            del self._bindings[q0.node.id]
        if len(graph.stages) != 1:
            raise ValueError(
                f"subplan lowers to {len(graph.stages)} stages; device "
                f"loop needs exactly one"
            )
        stage = graph.stages[0]
        if stage.input_refs != [("plan_input", q0.node.id)] or len(stage.out_slots) != 1:
            raise ValueError("subplan stage shape unsupported for device loop")
        return stage, out_q.schema

    def _run_subquery(self, plan_fn, schema: Schema, current: ColumnBatch, scalar: bool = False):
        """Run a do_while body (-> the new state batch) or condition (->
        its one bool value, read on the host) on ``current``.  Each plan
        is built once per function object and its input rebound every
        round."""
        key = (plan_fn, tuple(schema.names))
        if key not in self._subplans:
            q0 = self._from_device_batch(current, schema)
            self._subplans[key] = (q0.node.id, plan_fn(q0).node)
        input_id, out_node = self._subplans[key]
        self._bindings[input_id] = ("device", current)
        try:
            batch = self.execute(Query(self, out_node))
        finally:  # the loop state is pinned only while its round runs
            del self._bindings[input_id]
        if not scalar:
            return batch
        # the first valid row in global order: every gang rank reads the same
        first = first_valid(next(iter(batch.data.values())), batch.valid, self.mesh)
        return bool(first) if first is not None else False


class _RankContext(DryadContext):
    """One rank of a context over several cards (``parallel/ranks.py``):
    a mesh, an executor and a device cache of its own, on its card; the
    driver's config, dictionary, bindings and codecs, read through.
    Rank 0's events are the driver's stream (the reference's single
    controller logs one stream); the other ranks' stay in memory."""

    def __init__(self, driver: DryadContext, mesh: PartitionMesh):
        self._driver_ref = weakref.ref(driver)
        self.config = driver.config
        self.local_debug = False
        self._ranks = None
        self._any_stream = False
        self._device_cache: "OrderedDict[int, tuple]" = OrderedDict()
        self.events = (driver.events if mesh.rank == 0
                       else EventLog(None, mem_cap=self.config.obs_events_mem_cap))
        self.diagnosis = self.rewriter = self.telemetry = None
        self.headroom = driver.headroom
        self._job_lock = threading.RLock()
        self.tokenizer_native = self.io_native = None
        self.io_stats: Dict[str, float] = {}
        self._attach(mesh)

    def _attach(self, mesh: PartitionMesh) -> None:
        """Serve ``mesh`` (a new group's) with a new executor."""
        self.mesh, self.device, self.num_partitions = mesh, mesh.device, mesh.P
        self._subplans: Dict[tuple, tuple] = {}
        self.executor = GraphExecutor(self.num_partitions, self.config, self.device, self.events,
                                      mesh=mesh)
        self.executor.headroom = self.headroom

    def _release(self) -> None:
        """Drop this rank's device tables and its stage and loop programs."""
        from dryad_tpu_torch.exec.executor import _release_loops

        self._device_cache.clear()
        self.executor.programs.clear()
        _release_loops(self.executor._loops)

    @property
    def _driver(self) -> DryadContext:
        d = self._driver_ref()
        if d is None:
            raise RuntimeError("the context this rank served is gone")
        return d

    @property
    def dictionary(self) -> StringDictionary:
        return self._driver.dictionary

    @property
    def _bindings(self) -> Dict[int, tuple]:
        return self._driver._bindings

    @property
    def _codecs(self) -> Dict[str, object]:
        return self._driver._codecs

    @property
    def _binding_fp_cache(self) -> Dict[int, Optional[str]]:
        return self._driver._binding_fp_cache


class _FrozenRewriter:
    """The plan rewriter's decisions as a job starts (boost floors and
    the exchange-window hint): every rank of a context over several
    cards reads the same ones, whatever the rewriter learns meanwhile
    from rank 0's events (ranks that decided differently would wait in
    different collectives)."""

    def __init__(self, rewriter):
        with rewriter._lock:
            self._floors = dict(rewriter._floors)
        self._hint = rewriter.exchange_window_hint()

    def boost_floor(self, name: str) -> int:
        return self._floors.get(name, 1)

    def exchange_window_hint(self) -> Optional[int]:
        return self._hint


class _Finished:
    """The deferred tail of a job whose ranks ran their miss checks and
    checkpoint saves at its end: nothing is left to do."""

    def finish(self, deferred: bool = True) -> None:
        pass

    def abort(self, reason: str) -> None:
        pass


def _rows(cols: Dict[str, np.ndarray]) -> int:
    return len(next(iter(cols.values()))) if cols else 0


def _carrier(col: str, schema: Schema) -> torch.dtype:
    """Device dtype of one physical column: uint32 words (split columns
    and UINT32) ride as int64."""
    if "#" in col:
        return torch.int64
    return {
        ColumnType.INT32: torch.int32,
        ColumnType.FLOAT32: torch.float32,
        ColumnType.BOOL: torch.bool,
        ColumnType.UINT32: torch.int64,
    }[schema.field(col).ctype]
