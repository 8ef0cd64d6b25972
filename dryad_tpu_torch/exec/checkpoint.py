"""Stage-boundary checkpointing — durable intermediates + resume (a
copy of ``dryad_tpu/exec/checkpoint.py``).

The reference has no job-level checkpointing; its durability is that
every ``DCT_File`` channel is a persisted file on the producer's disk,
so recovery replays only missing vertices and a job restart re-reads
whatever inputs still exist (SURVEY §5.4; ``DrProcess.h:80-89`` retain/
lease times).  The TPU equivalent implemented here: completed stage
outputs are materialized host-side as ``.dpf`` partition files keyed by
a **content-addressed stage identity** — a Merkle chain of
(op-kind structure + static params + input shapes + the SHA-1 of every
transitive input's data).  Re-running the same stage over the same data
(same process or a restarted driver) loads the persisted output and
skips the stage; changing the input data or any upstream operator
changes the fingerprint and recomputes — stale hits are impossible.

Stages whose inputs cannot be fingerprinted (device-resident bindings,
e.g. do_while loop state) are simply not checkpointed; user callables
in operator params contribute only a structural marker, so a *changed*
user lambda with identical structure is the one identity component the
store cannot see — the same contract as the reference, which trusts the
resubmitted job to ship the same generated vertex DLL.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from dryad_tpu_torch.columnar.batch import ColumnBatch, to_device_column, to_host_column
from dryad_tpu_torch.columnar.io import read_partition_file, write_partition_file
from dryad_tpu_torch.exec import faults
from dryad_tpu_torch.exec.failure import CheckpointCorruptionError
from dryad_tpu_torch.obs.span import Tracer
from dryad_tpu_torch.utils.logging import get_logger

log = get_logger("dryad_tpu_torch.exec.checkpoint")

_VALID = "__valid__"


def _col_crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def _hash_strings(h, a: np.ndarray) -> None:
    """Feed ``h`` each value's UTF-8 bytes, length-prefixed.  A column of
    exact ``str`` values encodes each distinct value once and joins the
    records in row order, in pieces (the same bytes as the per-row
    loop, several times faster on a few-thousand-key column)."""
    rows = a.ravel().tolist()
    try:
        distinct = set(rows)
    except TypeError:
        distinct = None
    if distinct is None or not all(type(v) is str for v in distinct):
        for s in rows:
            b = str(s).encode("utf-8", "surrogatepass")
            h.update(len(b).to_bytes(4, "little"))
            h.update(b)
        return
    rec = {}
    for v in distinct:
        b = v.encode("utf-8", "surrogatepass")
        rec[v] = len(b).to_bytes(4, "little") + b
    step = 1 << 22
    for i in range(0, len(rows), step):
        h.update(b"".join(map(rec.__getitem__, rows[i : i + step])))


def content_fingerprint(arrays: Dict[str, np.ndarray]) -> str:
    """SHA-1 of a host table's content (column names, dtypes, bytes).

    Object/str columns hash by VALUE, length-prefixed: ``tobytes`` on
    an object column serializes PyObject pointers, which differ per
    process — equal tables must fingerprint equal everywhere (the
    serving tier routes and invalidates by this digest)."""
    h = hashlib.sha1()
    for name in sorted(arrays):
        a = np.ascontiguousarray(np.asarray(arrays[name]))
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        if a.dtype == object or a.dtype.kind in ("U", "S"):
            _hash_strings(h, a)
        else:
            h.update(a.tobytes())
    return h.hexdigest()[:16]


def _stable_param(v) -> str:
    """Structural repr of a static param; callables collapse to '<fn>'
    (cross-process resume assumes the same resubmitted query)."""
    if callable(v):
        return "<fn>"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_stable_param(x) for x in v) + "]"
    return repr(v)


def stage_fingerprint(
    stage,
    shape_key: Tuple,
    input_fps: Tuple[Optional[str], ...],
) -> Optional[str]:
    """Merkle stage identity; None if any input is unfingerprintable."""
    if any(fp is None for fp in input_fps):
        return None
    parts = []
    for op in stage.ops:
        items = ",".join(
            f"{k}={_stable_param(v)}" for k, v in sorted(op.params.items())
        )
        parts.append(f"{op.kind}({items})")
    blob = (
        "|".join(parts)
        + f"|outs={stage.out_slots}|shapes={shape_key}|ins={input_fps}"
    )
    # Runs of stages (the executor's retry units) chain member ops whose
    # slot numbers overlap; their wiring/exports/member boundaries are
    # part of the identity or two differently-wired runs could alias.
    extra = getattr(stage, "fingerprint_extra", None)
    if extra:
        blob += "|" + extra
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


class CheckpointStore:
    """Directory of per-stage materialized outputs, content-addressed."""

    def __init__(self, root: str, events=None):
        self.root = root
        self.events = events  # optional EventLog for integrity reports
        self._tracer = Tracer(events)  # save/load IO spans (cat=checkpoint)
        # Checkpoints touched (saved or loaded) by THIS run: exempt from
        # gc, so a retention lease shorter than the job's wall time can't
        # delete earlier stages of the running job out from under a
        # later resume-after-failure.
        self._active: set = set()
        os.makedirs(root, exist_ok=True)

    def _dir(self, stage, fp: str) -> str:
        name = re.sub(r"[^A-Za-z0-9_+-]", "_", stage.name)[:48]
        return os.path.join(self.root, f"{name}-{fp}")

    def save(
        self, stage, fp: str, outputs: Tuple[ColumnBatch, ...]
    ) -> str:
        with self._tracer.span(
            f"ckpt_save:{stage.name}", cat="checkpoint"
        ):
            return self._save(stage, fp, outputs)

    def _save(
        self, stage, fp: str, outputs: Tuple[ColumnBatch, ...]
    ) -> str:
        d = self._dir(stage, fp)
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        meta = {"outputs": len(outputs), "stage": stage.name, "crc": {}}
        for i, b in enumerate(outputs):
            # columns in name order: the reference's compiled outputs
            # come back as key-sorted dicts, and the file lists them so
            cols = {n: to_host_column(b.data[n].reshape(-1)) for n in sorted(b.data)}
            cols[_VALID] = to_host_column(b.valid.reshape(-1))
            write_partition_file(os.path.join(tmp, f"out{i}.dpf"), cols)
            # per-column CRC32 recorded at save, verified at load: a
            # silently bit-rotted payload must fail loudly into the
            # recompute path, never return corrupt data
            meta["crc"][f"out{i}"] = {
                n: _col_crc(a) for n, a in cols.items()
            }
        with open(os.path.join(tmp, "meta.json"), "w") as fh:
            json.dump(meta, fh)
        # atomic publish: a partially-written checkpoint is never visible
        if os.path.exists(d):
            import shutil

            shutil.rmtree(d)
        os.replace(tmp, d)
        self._active.add(d)
        # chaos hook: an installed FaultPlan may flip payload bytes in
        # the published checkpoint (simulated bit rot)
        faults.registry.maybe_corrupt_checkpoint(d)
        return d

    def gc(self, retain_seconds: float) -> int:
        """Drop checkpoints older than the retention lease — the analog
        of the reference's channel-file retain/lease grace times
        (``DrProcessTemplate``, ``DrProcess.h:80-89``).  A loaded
        checkpoint's mtime refreshes on save only; returns the number
        of entries removed."""
        import shutil
        import time as _time

        cutoff = _time.time() - retain_seconds
        removed = 0
        for name in os.listdir(self.root):
            d = os.path.join(self.root, name)
            meta = os.path.join(d, "meta.json")
            if not os.path.isdir(d) or d in self._active:
                continue
            try:
                ts = os.path.getmtime(meta if os.path.exists(meta) else d)
                if ts < cutoff:
                    shutil.rmtree(d)
                    removed += 1
            except OSError:  # concurrent removal: fine
                pass
        return removed

    def load(
        self, stage, fp: str, device, partitions: int
    ) -> Optional[Tuple[ColumnBatch, ...]]:
        d = self._dir(stage, fp)
        meta_path = os.path.join(d, "meta.json")
        if not os.path.exists(meta_path):
            return None
        with self._tracer.span(f"ckpt_load:{stage.name}", cat="checkpoint"):
            return self._load(stage, fp, d, meta_path, device, partitions)

    def _load(
        self, stage, fp: str, d: str, meta_path: str, device, partitions: int
    ) -> Optional[Tuple[ColumnBatch, ...]]:
        try:
            with open(meta_path) as fh:
                meta = json.load(fh)

            def up(a: np.ndarray):
                return to_device_column(a, device).reshape(partitions, -1)

            outs = []
            crcs = meta.get("crc", {})
            for i in range(meta["outputs"]):
                cols = read_partition_file(os.path.join(d, f"out{i}.dpf"))
                self._verify_crc(d, f"out{i}", cols, crcs.get(f"out{i}"))
                valid = cols.pop(_VALID)
                data = {n: up(v) for n, v in cols.items()}
                outs.append(ColumnBatch(data, up(valid)))
            self._active.add(d)
            return tuple(outs)
        except CheckpointCorruptionError as e:
            # integrity failure is TRANSIENT: fall through to recompute,
            # never serve corrupt data — but say so distinctly (bit rot
            # is a different diagnosis than a torn write)
            log.warning("checkpoint integrity failure: %s; recomputing", e)
            if self.events is not None:
                self.events.emit(
                    "checkpoint_corrupt", stage=stage.id, name=stage.name,
                    path=d, error=str(e),
                )
            return None
        except Exception as e:  # noqa: BLE001 — treat as cache miss
            log.warning("checkpoint %s unreadable (%s); recomputing", d, e)
            return None

    @staticmethod
    def _verify_crc(
        d: str, out_name: str, cols: Dict[str, np.ndarray], expect
    ) -> None:
        """Compare read columns against the CRCs recorded at save.
        Pre-CRC checkpoints (no ``crc`` in meta) load unverified."""
        if not expect:
            return
        for n, a in cols.items():
            want = expect.get(n)
            if want is None:
                continue
            got = _col_crc(a)
            if got != int(want):
                raise CheckpointCorruptionError(
                    f"column {n!r} of {d}/{out_name}.dpf: crc32 {got} != "
                    f"recorded {int(want)}"
                )
