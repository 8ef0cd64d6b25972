"""Plan-fingerprint result cache — repeat queries without re-dispatch
(a copy of ``dryad_tpu/serve/cache.py``).

Keys are ``(tenant, DryadContext.query_fingerprint(query))``: plan
structure via the executor's ``graph_key`` (the reference's
compile-cache key), output position, and the content SHA-1 of every
ingest binding.  A query whose fingerprint is None (stream inputs,
device-resident bindings) is simply uncacheable.

Invalidation is two-tier.  PER-BINDING (the continuous-ingest path):
``invalidate_binding`` drops exactly the entries whose fingerprint
covers the rewritten ingest binding — an append to table T touches
only results computed over T's old bytes, everything else keeps
hitting.  EPOCH-based (the blunt manual hammer): every entry records
the tenant's ingest epoch at insert, and a lookup whose epoch has
moved on misses (stale entries are dropped on contact, so a bumped
epoch also reclaims their bytes); ``TenantSession.bump_epoch`` remains
for whole-tenant resets.  Content changes need no invalidation at all:
a new binding fingerprints differently and misses cleanly (likewise a
vocabulary widening that moves the plan to a new string-table tier
changes the graph key — a recompute, never a stale hit).

Eviction is LRU by byte budget.  ADMISSION is cost-aware (config
``serve_cache_admission="cost"``): an insert carrying its observed
compute seconds is rejected when the query is cheaper to recompute
than its bytes are worth keeping — ``cost_s < min_sec_per_gb *
nbytes/1e9`` — so a burst of big cheap scans cannot evict small
expensive aggregates.  ``admission="all"`` restores unconditional
insert (the differential baseline); inserts without a cost always
admit.  Hits hand back per-client array copies so a caller mutating
its result cannot poison the cached master.  NOT thread-safe on its
own: the service driver thread is the only caller (lookups, inserts,
and eviction all happen between dispatches).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np


def table_nbytes(table: Dict[str, np.ndarray]) -> int:
    """Budget accounting for one host result table.  Object (string)
    columns count pointer width only — an approximation, but a stable
    one, and string-heavy results still evict in insertion order."""
    return sum(np.asarray(v).nbytes for v in table.values())


def _copy_table(table: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v).copy() for k, v in table.items()}


class ResultCache:
    """LRU-by-bytes map: (tenant, fingerprint) -> host result table."""

    def __init__(
        self,
        budget_bytes: int,
        admission: str = "all",
        min_sec_per_gb: float = 0.5,
    ):
        self.budget = int(budget_bytes)
        self.admission = str(admission)
        self.min_sec_per_gb = float(min_sec_per_gb)
        # key -> (master table, nbytes, tenant epoch at insert)
        self._entries: "OrderedDict[Tuple, Tuple[Dict, int, int]]" = (
            OrderedDict()
        )
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.rejected = 0
        self.invalidations = 0
        self.bytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key, epoch: int) -> Optional[Dict[str, np.ndarray]]:
        """The cached table (a fresh copy) when ``key`` is live at
        ``epoch``; None otherwise.  A stale-epoch entry is dropped on
        contact — the bump already invalidated it, this reclaims it."""
        if self.budget <= 0 or key is None:
            return None
        ent = self._entries.get(key)
        if ent is not None and ent[2] != epoch:
            self._drop(key)
            ent = None
        if ent is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return _copy_table(ent[0])

    def put(
        self,
        key,
        table: Dict[str, np.ndarray],
        epoch: int,
        cost_s: Optional[float] = None,
    ) -> None:
        """Insert; ``cost_s`` is the observed compute seconds the entry
        would save on a hit (the ``query_complete`` wall time).  Under
        cost admission an entry must be worth its bytes to enter."""
        if self.budget <= 0 or key is None:
            return
        nbytes = table_nbytes(table)
        if nbytes > self.budget:
            return  # would evict everything and still not fit
        if (
            self.admission == "cost"
            and cost_s is not None
            and cost_s < self.min_sec_per_gb * (nbytes / 1e9)
        ):
            self.rejected += 1
            return
        if key in self._entries:
            self._drop(key)
        self._entries[key] = (_copy_table(table), nbytes, epoch)
        self.bytes += nbytes
        while self.bytes > self.budget:
            _, (_t, nb, _e) = self._entries.popitem(last=False)
            self.bytes -= nb
            self.evictions += 1

    def invalidate_binding(self, tenant, binding_fp: str) -> int:
        """Drop exactly the entries computed over a rewritten ingest
        binding: a key's fingerprint carries the content SHA of every
        plan input (``query_fingerprint`` index [2]), so an entry is
        stale iff it covers the binding's PRE-append fingerprint.
        ``tenant=None`` sweeps every tenant — an ingest binding is
        shared engine state, so any tenant's result over it is stale.
        Returns the number of entries dropped."""
        if binding_fp is None:
            return 0
        stale = [
            k for k in self._entries
            if (tenant is None or k[0] == tenant)
            and isinstance(k[1], tuple)
            and len(k[1]) > 2
            and binding_fp in k[1][2]
        ]
        for k in stale:
            self._drop(k)
        self.invalidations += len(stale)
        return len(stale)

    def _drop(self, key) -> None:
        _t, nb, _e = self._entries.pop(key)
        self.bytes -= nb

    def stats(self) -> Dict[str, int]:
        return {
            "entries": len(self._entries),
            "bytes": self.bytes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "rejected": self.rejected,
            "invalidations": self.invalidations,
        }
