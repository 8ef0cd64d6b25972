"""Gang-resident partition state — the worker-side partition cache.

A gang worker that just WROTE a result partition is the cheapest place
to read it back from: the level-(-1) ``combineparts`` merge (and any
later sub-command referencing the same partitions) would otherwise pay
a job-root round trip through the driver's file server for bytes this
process produced moments ago.  :class:`PartitionCache` keeps those
serialized partition blobs resident, keyed by CONTENT fingerprint (the
sha1 of the partition-file bytes — the same content-addressed keying as
``exec.operands.DeviceOperandPool``), so a reference is valid exactly
when the bytes it names still exist, regardless of which path produced
them or whether the file was since rewritten.

Eviction is LRU by a byte budget with spill-to-file (the
``cluster.service.BlockCache`` discipline): an evicted entry writes its
blob to the spill directory and stays SERVABLE — a cache "hit" that
reads the spill file is still a worker-local read, just a cold one,
counted separately so the telemetry can tell residency from mere
locality.  ``runbatch`` chains thus become worker-local dataflow: the
driver names partitions by fingerprint, the worker resolves them from
memory, spill, or (miss) the job root.
"""

from __future__ import annotations

import collections
import hashlib
import os
import threading
from typing import Dict, Optional


def content_fp(blob: bytes) -> str:
    """Content fingerprint of one serialized partition (sha1 hex)."""
    return hashlib.sha1(blob).hexdigest()


class PartitionCache:
    """Content-keyed LRU byte-budget cache of partition blobs."""

    def __init__(
        self,
        budget_bytes: int,
        spill_dir: Optional[str] = None,
    ):
        self.budget = int(budget_bytes)
        self.spill_dir = spill_dir
        self._lock = threading.Lock()
        self._mem: "collections.OrderedDict[str, bytes]" = (
            collections.OrderedDict()
        )
        self._mem_bytes = 0
        self._spilled: Dict[str, str] = {}
        self.hits = 0  # served from memory
        self.spill_hits = 0  # served from a spill file
        self.misses = 0  # caller must read the job root
        self.spills = 0  # evictions that wrote a spill file
        self.evictions = 0
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)

    @property
    def mem_bytes(self) -> int:
        return self._mem_bytes

    def put(self, fp: str, blob: bytes) -> None:
        """Insert one blob under its content fingerprint.  A blob
        larger than the whole budget is not admitted (it would evict
        everything and then evict itself); a zero budget disables the
        cache entirely."""
        if self.budget <= 0 or len(blob) > self.budget:
            return
        with self._lock:
            old = self._mem.pop(fp, None)
            if old is not None:
                self._mem_bytes -= len(old)
            self._mem[fp] = blob
            self._mem_bytes += len(blob)
            while self._mem_bytes > self.budget and len(self._mem) > 1:
                old_fp, old = self._mem.popitem(last=False)
                self._mem_bytes -= len(old)
                self.evictions += 1
                if self.spill_dir and old_fp not in self._spilled:
                    sp = os.path.join(self.spill_dir, f"{old_fp}.part")
                    tmp = f"{sp}.tmp"
                    with open(tmp, "wb") as fh:
                        fh.write(old)
                    os.replace(tmp, sp)
                    self._spilled[old_fp] = sp
                    self.spills += 1

    def get(self, fp: str) -> Optional[bytes]:
        """Resolve a fingerprint from memory or spill; None = miss
        (the caller reads the job root and should :meth:`put` the
        bytes back so the next reference hits)."""
        with self._lock:
            blob = self._mem.get(fp)
            if blob is not None:
                self._mem.move_to_end(fp)
                self.hits += 1
                return blob
            sp = self._spilled.get(fp)
        if sp is not None and os.path.exists(sp):
            with open(sp, "rb") as fh:
                blob = fh.read()
            with self._lock:
                self.spill_hits += 1
            # re-admit: a spilled entry being referenced again is hot
            self.put(fp, blob)
            return blob
        with self._lock:
            self.misses += 1
        return None

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self.hits,
                "spill_hits": self.spill_hits,
                "misses": self.misses,
                "spills": self.spills,
                "evictions": self.evictions,
                "mem_bytes": self._mem_bytes,
                "entries": len(self._mem),
            }
