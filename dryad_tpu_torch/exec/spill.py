"""Bucketed spill files of the out-of-core driver (a copy of
``dryad_tpu/exec/spill.py``).

A stage whose working set does not fit on the device streams bucketed
``.dpf`` pieces to local disk (the port's ``columnar/io.py`` format,
byte-equal to the reference's) and re-reads one bucket at a time.
Strings spill as their 64-bit dictionary hashes (8 bytes a row) and
decode back through the context dictionary on read.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from dryad_tpu_torch.columnar.io import read_partition_file, write_partition_file
from dryad_tpu_torch.obs.span import Tracer

_STR_MARK = "#spillstr_"  # physical prefix for hash-encoded string cols


class SpillDir:
    """Append-only bucketed spill directory.

    ``append(bucket, table)`` writes one ``.dpf`` piece;
    ``read_bucket(bucket)`` concatenates the bucket's pieces back into
    one host table.  Object/str columns are hash-encoded via the
    context dictionary (which must already contain the values — true
    for any table that passed through ingest).  With a ``metrics``
    registry, the bytes of the pieces written and read are counted as
    ``spill_bytes`` and ``spill_read_bytes``.
    """

    def __init__(self, dictionary=None, root: Optional[str] = None, metrics=None):
        # a caller-provided root is a fresh mkdtemp too (under the
        # configured stream_spill_dir), so cleanup() removes it
        self.root = root or tempfile.mkdtemp(prefix="dryad_spill_")
        os.makedirs(self.root, exist_ok=True)
        self.dictionary = dictionary
        self._pieces: Dict[int, List[str]] = {}
        self._rows: Dict[int, int] = {}
        self.bytes_written = 0
        self.metrics = metrics

    def _count(self, name: str, nbytes: int) -> None:
        if self.metrics is not None:
            self.metrics.add(name, nbytes)

    def _encode(self, table: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = {}
        for name, a in table.items():
            a = np.asarray(a)
            if a.dtype == object or a.dtype.kind in ("U", "S"):
                if self.dictionary is None:
                    raise ValueError(
                        f"string column {name!r} needs a dictionary to spill"
                    )
                uniq, inv = np.unique(a.astype(object), return_inverse=True)
                hs = np.asarray(
                    [self.dictionary.add(str(s)) for s in uniq], np.uint64
                )
                out[_STR_MARK + name] = hs[inv]
            else:
                out[name] = a
        return out

    def _decode(self, cols: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = {}
        for name, a in cols.items():
            if name.startswith(_STR_MARK):
                hs = a.astype(np.uint64)
                uniq, inv = np.unique(hs, return_inverse=True)
                vals = np.asarray(
                    [self.dictionary._map[int(h)] for h in uniq], object
                )
                out[name[len(_STR_MARK):]] = vals[inv]
            else:
                out[name] = a
        return out

    def append(self, bucket: int, table: Dict[str, np.ndarray]) -> int:
        """Spill one piece; returns the piece's row count."""
        enc = self._encode(table)
        n = len(next(iter(enc.values()))) if enc else 0
        if n == 0:
            return 0
        bdir = os.path.join(self.root, f"bucket_{bucket:05d}")
        os.makedirs(bdir, exist_ok=True)
        pieces = self._pieces.setdefault(bucket, [])
        path = os.path.join(bdir, f"piece_{len(pieces):05d}.dpf")
        write_partition_file(path, enc)
        pieces.append(path)
        self._rows[bucket] = self._rows.get(bucket, 0) + n
        size = os.path.getsize(path)
        self.bytes_written += size
        self._count("spill_bytes", size)
        return n

    def buckets(self) -> List[int]:
        return sorted(self._pieces)

    def bucket_rows(self, bucket: int) -> int:
        return self._rows.get(bucket, 0)

    def _read(self, path: str) -> Dict[str, np.ndarray]:
        self._count("spill_read_bytes", os.path.getsize(path))
        return read_partition_file(path)

    def read_bucket(self, bucket: int) -> Dict[str, np.ndarray]:
        pieces = [self._read(p) for p in self._pieces.get(bucket, [])]
        if not pieces:
            return {}
        cols = {
            n: np.concatenate([p[n] for p in pieces]) for n in pieces[0]
        }
        return self._decode(cols)

    def read_bucket_pieces(
        self, bucket: int
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Per-piece iterator (for re-bucketing an oversized bucket
        without holding it whole)."""
        for p in self._pieces.get(bucket, []):
            yield self._decode(self._read(p))

    def drop_bucket(self, bucket: int) -> None:
        for p in self._pieces.pop(bucket, []):
            with contextlib.suppress(OSError):
                os.remove(p)
        self._rows.pop(bucket, None)

    def cleanup(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)
        self._pieces.clear()
        self._rows.clear()


class SpillWriter:
    """Buffered background writer: ``SpillDir.append`` moved off the
    driver loop so bucket writes overlap the next chunk's compute.

    One writer THREAD, FIFO order: per-bucket piece indices are
    assigned in submit order, so the spilled bytes are identical to the
    serial driver's.

    A write error is latched and re-raised from the NEXT ``submit`` or
    from ``flush()`` — the driver's existing cleanup path (``finally:
    spill.cleanup()``) then removes the directory, so a mid-stream
    fault leaves no orphaned spills.  ``flush()`` is the phase barrier:
    phase 2 may only read bucket metadata after it returns.
    """

    def __init__(self, events=None, queue_depth: int = 8):
        self.events = events
        # writer-thread spans (cat=spill, with piece bytes): the spill
        # track of the Perfetto export + the spill_bytes accounting
        self._tracer = Tracer(events)
        self._max = max(1, queue_depth)
        self._q: List[Tuple] = []
        self._cv = threading.Condition()
        self._err: Optional[BaseException] = None
        self._closed = False
        self._busy = False  # a write is in progress (flush barrier)
        self._thread = threading.Thread(
            target=self._run, name="dryad-spill-writer", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait(0.1)
                if not self._q and self._closed:
                    return
                job = self._q.pop(0)
                self._busy = True
                self._cv.notify_all()
            spill, bucket, table, depth = job
            try:
                b0 = spill.bytes_written
                with self._tracer.span(
                    "spill_piece", cat="spill", bucket=bucket, depth=depth,
                ) as sp:
                    n = spill.append(bucket, table)
                    sp.add(rows=n, bytes=spill.bytes_written - b0)
                if self.events is not None and n:
                    self.events.emit(
                        "stream_spill", bucket=bucket, rows=n, depth=depth
                    )
            except BaseException as e:  # noqa: BLE001 - latched for driver
                with self._cv:
                    if self._err is None:
                        self._err = e
                    self._q.clear()  # poisoned stream: drop queued writes
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def _raise_pending(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            if self.events is not None:
                # a first failure with no attempt history: the
                # reference's classification calls it transient
                self.events.emit(
                    "stream_pipeline_error", pipeline="spill",
                    phase="spill", failure_kind="transient",
                    error=f"{type(err).__name__}: {err}",
                )
            raise err

    def submit(self, spill: SpillDir, bucket: int, table, depth: int = 0):
        """Queue one piece write; blocks when ``queue_depth`` writes are
        pending (bounded memory), raises a latched writer error."""
        with self._cv:
            self._raise_pending()
            while len(self._q) >= self._max and self._err is None \
                    and not self._closed:
                self._cv.wait(0.1)
            self._raise_pending()
            if self._closed:
                raise RuntimeError("spill writer is closed")
            self._q.append((spill, bucket, table, depth))
            self._cv.notify_all()

    def flush(self) -> None:
        """Barrier: all submitted writes are durable (or the first
        error raises)."""
        with self._cv:
            while (self._q or self._busy) and self._err is None:
                self._cv.wait(0.1)
            self._raise_pending()

    def close(self, drain: bool = True) -> None:
        """Stop the writer.  ``drain=True`` flushes first (clean end of
        stream); ``drain=False`` abandons queued writes (error path —
        the caller is about to remove the spill directory anyway)."""
        if drain and self._err is None:
            with contextlib.suppress(BaseException):
                self.flush()
        with self._cv:
            self._closed = True
            if not drain:
                self._q.clear()
            self._cv.notify_all()
        self._thread.join(timeout=30.0)

    def __enter__(self) -> "SpillWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        self.close(drain=exc_type is None)
