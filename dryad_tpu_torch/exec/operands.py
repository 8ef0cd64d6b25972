"""Device operand pool: the content-addressed upload cache of the string
coding tables.

The counterpart of ``dryad_tpu/exec/operands.py``.  A table travels to
the stage ops as device tensors (``exec/kernels.py::StageContext.
operand``).  A widening vocabulary makes a new table per widening, but
the dictionary grows append-only: within one tier (the same buffer
layout) a widened table differs from its predecessor only in the rows
the new entries filled (``ops/stringcode.py`` builds subset tables in
insertion order to keep this true).  So the pool keeps the LATEST
content of each tier resident and, on a new content, scatters only the
changed rows (``index_copy_`` into a copy of the resident tensors, as
the reference's functional update), uploading in full only an unknown
tier or a change of more than half the rows.

Participating objects implement the operand protocol:
``operand_arrays()`` (host numpy arrays, leading axis the scatter axis)
and ``operand_sha()`` (content digest).  uint32 words ride on the
device as int64 (``columnar/batch.py``); they cross to the card as
their four bytes and widen there, so the bytes counted are the bytes
copied: every upload adds to the ``h2d_bytes`` and
``operand_h2d_bytes`` counters of the registry it is given, as the
reference's pool does.

One pool per :class:`~dryad_tpu_torch.exec.executor.GraphExecutor`;
its ``hits``, ``full_uploads`` and ``delta_scatters`` feed the flight
recorder's ``operand_pool`` probe.  A dispatch fetches its unit's
tables from the pool in ``operand_objects`` order and hands them to the
unit's stage program (``exec/programs.py``), which on the card copies
them into buffers it owns: a scatter makes new tensors, so a graph
that captured the resident ones would read a stale table after a widen
within its tier (the reference's call-time operands).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dryad_tpu_torch.columnar.batch import MASK32


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array on the device; uint32 crosses as its 4 bytes and
    widens to the int64 carrier there."""
    if a.dtype == np.uint32:
        t = torch.from_numpy(a.view(np.int32)).to(device, copy=True)
        return t.to(torch.int64) & MASK32
    return torch.from_numpy(a).to(device, copy=True)


class DeviceOperandPool:
    """Per-executor cache: operand tier -> resident device tensors.

    Only the latest content a tier stays resident; the resident sha is a
    hit, a new sha on a known tier scatters the changed rows, an unknown
    tier uploads in full.  Thread-safe: residency and counters change
    together under one lock."""

    def __init__(self, device, metrics=None):
        self.device = torch.device(device)
        self.metrics = metrics
        # tier -> (sha, host arrays, device tensors)
        self._tiers: Dict[Tuple, Tuple[str, Tuple, Tuple]] = {}
        self.hits = 0
        self.full_uploads = 0
        self.delta_scatters = 0
        self._lock = threading.Lock()

    def _account(self, nbytes: int) -> None:
        if self.metrics is not None:
            self.metrics.add("h2d_bytes", int(nbytes))
            self.metrics.add("operand_h2d_bytes", int(nbytes))

    def get(self, obj: Any) -> Tuple[torch.Tensor, ...]:
        """Device tensors of ``obj``'s ``operand_arrays()``, uploading or
        scattering as needed."""
        sha = obj.operand_sha()
        host = tuple(np.ascontiguousarray(a) for a in obj.operand_arrays())
        # residency keys on the buffer layout, not the compile signature
        tier = (type(obj).__name__,) + tuple((a.shape, str(a.dtype)) for a in host)
        with self._lock:
            cur = self._tiers.get(tier)
            if cur is not None and cur[0] == sha:
                self.hits += 1
                return cur[2]
            dev: Optional[Tuple] = None
            if cur is not None:
                dev = self._scatter_delta(cur[1], cur[2], host)
            if dev is None:
                dev = tuple(_upload(a, self.device) for a in host)
                self._account(sum(a.nbytes for a in host))
                self.full_uploads += 1
            else:
                self.delta_scatters += 1
            self._tiers[tier] = (sha, host, dev)
            return dev

    def _scatter_delta(self, prev_host, prev_dev, host) -> Optional[Tuple]:
        """New resident tensors holding ``host``: the old ones with the
        changed rows copied in; None when more than half the rows of an
        array changed (a full upload is cheaper)."""
        deltas = []
        for old, new in zip(prev_host, host):
            if old.shape != new.shape or old.dtype != new.dtype:
                return None
            diff = old != new
            if diff.ndim > 1:
                diff = diff.reshape(diff.shape[0], -1).any(axis=1)
            idx = np.nonzero(diff)[0]
            if len(idx) > new.shape[0] // 2:
                return None
            deltas.append(idx)
        out = []
        nbytes = 0
        for old_dev, new, idx in zip(prev_dev, host, deltas):
            if len(idx) == 0:
                out.append(old_dev)
                continue
            vals = np.ascontiguousarray(new[idx])
            nbytes += idx.nbytes + vals.nbytes
            rows = torch.from_numpy(idx).to(self.device, copy=True)
            # into a copy, as the reference's functional update: a
            # dispatch still holding the old content keeps it
            out.append(old_dev.clone().index_copy_(0, rows, _upload(vals, self.device)))
        self._account(nbytes)
        return tuple(out)


def operand_objects(ops, params) -> list:
    """The operand objects of ``ops``' registered ``(kind, param)``
    pairs, in op order then param name, each object once: the
    reference's ``stage_operand_objs`` enumeration."""
    objs, seen = [], set()
    for op in ops:
        for k in sorted(op.params):
            v = op.params[k]
            if (op.kind, k) in params and hasattr(v, "operand_sha") and id(v) not in seen:
                seen.add(id(v))
                objs.append(v)
    return objs


class BakedOperands:
    """Tables uploaded once per content and kept, outside the pool: the
    reference's baked constants (``stringcode_runtime_tables`` off, and
    the on-device ``do_while``, whose program holds its tables)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._tables: Dict[str, Tuple[torch.Tensor, ...]] = {}

    def get(self, obj: Any) -> Tuple[torch.Tensor, ...]:
        sha = obj.operand_sha()
        hit = self._tables.get(sha)
        if hit is None:
            hit = self._tables[sha] = tuple(
                _upload(np.ascontiguousarray(a), self.device) for a in obj.operand_arrays())
        return hit
