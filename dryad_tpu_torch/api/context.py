"""DryadContext — the port's entry point and job driver.

The counterpart of ``dryad_tpu/api/context.py`` for ``from_arrays``,
``from_text`` and ``collect``.  A context owns one device (CUDA unless
the caller passes ``device="cpu"``; it never falls back by itself), P
logical partitions on it, the string dictionary, and a device-resident
ingest cache keyed by binding, LRU by bytes.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, Optional, Union

import numpy as np
import torch

from dryad_tpu_torch.api.query import Query
from dryad_tpu_torch.columnar.batch import ColumnBatch
from dryad_tpu_torch.columnar.schema import ColumnType, Schema, StringDictionary
from dryad_tpu_torch.exec.executor import GraphExecutor
from dryad_tpu_torch.parallel.partition import block_layout
from dryad_tpu_torch.plan.lower import lower
from dryad_tpu_torch.plan.nodes import Node, PartitionInfo
from dryad_tpu_torch.utils.config import DryadConfig

DEFAULT_PARTITIONS = 8

_NP_TYPE_MAP = {
    np.dtype(np.int32): ColumnType.INT32,
    np.dtype(np.int64): ColumnType.INT64,
    np.dtype(np.float32): ColumnType.FLOAT32,
    np.dtype(np.float64): ColumnType.FLOAT64,
    np.dtype(np.bool_): ColumnType.BOOL,
    np.dtype(np.uint32): ColumnType.UINT32,
}


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` -> the current CUDA device; raises when there is none.
    The CPU is used only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dryad_tpu_torch: no CUDA device available; pass "
                "device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


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
    ):
        self.config = config or DryadConfig()
        self.config.validate()
        self.device = resolve_device(device)
        self.num_partitions = num_partitions_ or DEFAULT_PARTITIONS
        if self.num_partitions < 1:
            raise ValueError("num_partitions_ must be >= 1")
        self.dictionary = StringDictionary()
        self._bindings: Dict[int, tuple] = {}
        # input node id -> (binding tuple, batch, bytes); the stored
        # binding identity invalidates the entry when a node is rebound
        self._device_cache: "OrderedDict[int, tuple]" = OrderedDict()
        self.executor = GraphExecutor(self.num_partitions, self.config, self.device)
        self.tokenizer_native = None  # set by from_text: which tokenizer ran

    # -- ingestion -----------------------------------------------------------
    def from_arrays(
        self,
        arrays: Dict[str, np.ndarray],
        schema: Optional[Schema] = None,
        partition_capacity: Optional[int] = None,
    ) -> Query:
        """A table from host arrays.  STRING values register in the
        dictionary now (the auto-dense rewrite codes against it at
        lowering); INT32 ranges feed the int auto-dense rewrite."""
        schema = schema or _infer_schema(arrays)
        str_vocab = {}
        if self.config.auto_dense_strings:
            for name in schema.names:
                if schema.field(name).ctype is ColumnType.STRING and name in arrays:
                    hs = [
                        self.dictionary.add(str(s))
                        for s in np.unique(np.asarray(arrays[name], object))
                    ]
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
        of ``data``: a filesystem path, a str, or bytes."""
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

    # -- execution -------------------------------------------------------------
    def _bind_device(self, node: Node) -> ColumnBatch:
        binding = self._bindings[node.id]
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
            return ColumnBatch.from_numpy(
                node.schema, arrays, self.num_partitions, self.device,
                partition_capacity=cap, dictionary=self.dictionary,
            )
        if kind == "host_physical":
            data, valid = block_layout(rest[0], self.num_partitions)
            return ColumnBatch.from_host_layout(data, valid, self.device)
        raise RuntimeError(f"unknown binding kind {kind}")

    def execute(self, query: Query) -> ColumnBatch:
        """Lower and run a query; the result batch stays on the device."""
        graph = lower([query.node], self.config, self.dictionary)
        bindings = {nid: self._bind_device(n) for nid, n in graph.inputs.items()}
        results = self.executor.execute(graph, bindings)
        return results[graph.outputs[query.node.id]]

    def run_to_host(self, query: Query) -> Dict[str, np.ndarray]:
        return self.execute(query).to_numpy(query.schema, self.dictionary)
