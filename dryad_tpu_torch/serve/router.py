"""Plan-fingerprint-affine routing for the serving fleet (a copy of
``dryad_tpu/serve/router.py``; the fleet itself is
:mod:`~dryad_tpu_torch.serve.fleet`).

Pure logic — no sockets, no threads — so every property the fleet
depends on is testable in isolation:

- **canonical fingerprints** (:func:`canonical_fingerprint`): a
  process-portable SHA-256 of the serve cache's
  ``(graph_key, (pos, oidx), binding_SHAs)`` tuple.  The compile-cache
  key holds fn-valued params BY REFERENCE (``GraphExecutor._stage_key``), so
  a fingerprint is only portable when every leaf is a value — the
  encoder refuses reference-keyed leaves and the caller falls back to
  :func:`package_fingerprint` (SHA-256 of the packed query blob), which
  is deterministic for a client resubmitting the same bytes.
- **rendezvous (HRW) hashing** (:func:`rendezvous_rank`): each replica
  scores ``sha256(fingerprint | replica_id)``; the query goes to the
  max.  Removing one replica remaps only that replica's shard (~1/N of
  fingerprints) — every other query keeps its warm compile cache,
  operand-pool residency, and result-cache entries.  Built on sha256,
  never the builtin ``hash()`` — routing keys must agree across
  processes and ``PYTHONHASHSEED`` values.
- **negative quota memos** (:class:`NegativeQuotaMemo`): a hard-quota'd
  tenant fails fast at the front door instead of paying an RPC round
  trip per rejection.
- **replica liveness** (:class:`ReplicaSet`): heartbeat-versioned
  membership with a routing generation that bumps on every death, so
  stale results from a removed replica are recognizably stale.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "canonical_fingerprint",
    "package_fingerprint",
    "rendezvous_rank",
    "route",
    "NegativeQuotaMemo",
    "ReplicaSet",
]


class _Unportable(Exception):
    """A fingerprint leaf keyed by reference — not stable across
    processes, so the canonical encoding refuses it."""


def _is_np_dtype(obj) -> bool:
    """Duck-typed numpy dtype check (no numpy import here).  Modern
    numpy hands out instances of per-type subclasses
    (``numpy.dtypes.Int64DType``), so a name check on ``type(obj)``
    misses — walk the MRO instead."""
    mod = getattr(type(obj), "__module__", "")
    if not (mod == "numpy" or mod.startswith("numpy.")):
        return False
    return any(c.__name__ == "dtype" for c in type(obj).__mro__)


def _encode(obj, out: List[bytes]) -> None:
    """Append a canonical, self-delimiting encoding of *obj*.

    Only VALUE leaves are admitted: two processes that built the same
    logical plan must produce identical bytes, and any leaf whose repr
    or identity is address-dependent (functions, lambdas, arbitrary
    objects) raises :class:`_Unportable` instead of silently encoding
    an unstable key.
    """
    if obj is None:
        out.append(b"n;")
    elif obj is True:
        out.append(b"T;")
    elif obj is False:
        out.append(b"F;")
    elif isinstance(obj, int):
        out.append(b"i%d;" % obj)
    elif isinstance(obj, float):
        out.append(f"f{obj!r};".encode())
    elif isinstance(obj, str):
        b = obj.encode()
        out.append(b"s%d:" % len(b))
        out.append(b)
    elif isinstance(obj, bytes):
        out.append(b"b%d:" % len(obj))
        out.append(obj)
    elif isinstance(obj, enum.Enum):
        _encode(("enum", type(obj).__qualname__, obj.name), out)
    elif isinstance(obj, (tuple, list)):
        out.append(b"t%d:" % len(obj))
        for item in obj:
            _encode(item, out)
    elif isinstance(obj, dict):
        items = sorted(obj.items(), key=lambda kv: repr(kv[0]))
        out.append(b"d%d:" % len(items))
        for k, v in items:
            _encode(k, out)
            _encode(v, out)
    elif isinstance(obj, frozenset):
        enc: List[bytes] = []
        for item in obj:
            one: List[bytes] = []
            _encode(item, one)
            enc.append(b"".join(one))
        enc.sort()
        out.append(b"S%d:" % len(enc))
        out.extend(enc)
    elif _is_np_dtype(obj):
        _encode(("dtype", str(obj)), out)
    elif hasattr(obj, "dtype") and hasattr(obj, "item") and not hasattr(
        obj, "__len__"
    ):
        # numpy scalar: value + dtype pin it down
        _encode(("npscalar", str(obj.dtype), obj.item()), out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = tuple(
            (f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)
        )
        _encode(("dc", type(obj).__qualname__, fields), out)
    else:
        raise _Unportable(type(obj).__qualname__)


def canonical_fingerprint(fp) -> Optional[str]:
    """SHA-256 hex of the canonical encoding of a
    ``DryadContext.query_fingerprint`` tuple, or None when the tuple
    contains reference-keyed leaves (closure-bearing plans) or the
    query was uncacheable (``fp is None``).  Identical logical plans
    produce identical digests in every process regardless of
    ``PYTHONHASHSEED``."""
    if fp is None:
        return None
    out: List[bytes] = []
    try:
        _encode(fp, out)
    except _Unportable:
        return None
    return hashlib.sha256(b"".join(out)).hexdigest()


def package_fingerprint(blob: bytes) -> str:
    """Routing fallback for non-portable plans: SHA-256 of the packed
    query bytes.  A client resubmitting the same package routes to the
    same replica (prepared-statement affinity survives), while two
    clients that independently pickled equal plans may land apart —
    correct, just colder."""
    return "pkg:" + hashlib.sha256(blob).hexdigest()


def rendezvous_rank(fingerprint: str, replicas: Sequence[str]) -> List[str]:
    """Highest-random-weight order of *replicas* for *fingerprint*:
    element 0 is the owner, element 1 the failover target, and so on.
    Deterministic across processes (sha256-scored), and removing a
    replica leaves the relative order of the survivors unchanged — the
    rendezvous property that bounds remapping to ~1/N."""
    key = fingerprint.encode()
    scored = [
        (hashlib.sha256(key + b"|" + rid.encode()).digest(), rid)
        for rid in replicas
    ]
    scored.sort(key=lambda pair: (pair[0], pair[1]), reverse=True)
    return [rid for _, rid in scored]


def route(fingerprint: str, replicas: Sequence[str]) -> str:
    """The rendezvous owner of *fingerprint* among *replicas*."""
    if not replicas:
        raise ValueError("no replicas to route to")
    return rendezvous_rank(fingerprint, replicas)[0]


class NegativeQuotaMemo:
    """Front-door memo of per-tenant hard-quota rejections.

    When a replica rejects tenant T (reason ``inflight``/``bytes``),
    the router records it; further submissions from T fail fast at the
    front door — no envelope post, no replica round trip — until the
    memo expires (``ttl`` seconds) or any completion for T frees
    capacity.  Only *load*-shaped rejections memoize: a ``closed``
    rejection means the replica is going away, which is the liveness
    plane's problem, not the tenant's.
    """

    MEMOABLE = ("inflight", "bytes")

    def __init__(self, ttl: float = 0.25, clock=time.monotonic):
        self.ttl = ttl
        self._clock = clock
        self._memo: Dict[str, Tuple[float, Dict[str, object]]] = {}
        self.fast_rejects = 0

    def note_rejection(self, tenant: str, reason: str, detail: Dict) -> None:
        if reason in self.MEMOABLE:
            self._memo[tenant] = (
                self._clock(),
                dict(detail, reason=reason),
            )

    def note_completion(self, tenant: str) -> None:
        # capacity freed: the next submission deserves a real attempt
        self._memo.pop(tenant, None)

    def check(self, tenant: str) -> Optional[Dict[str, object]]:
        """The memoized rejection detail when fresh, else None."""
        got = self._memo.get(tenant)
        if got is None:
            return None
        stamped, detail = got
        if self._clock() - stamped > self.ttl:
            del self._memo[tenant]
            return None
        self.fast_rejects += 1
        return detail


class ReplicaSet:
    """Heartbeat-versioned fleet membership.

    Each replica posts a monotonically versioned heartbeat prop; the
    router feeds ``observe`` with the (version, now) it read.  A
    replica whose heartbeat version stops advancing for
    ``stale_after`` seconds is dead: ``reap`` removes it and bumps the
    routing ``generation``, which every subsequently routed envelope
    carries — a result stamped with an older generation by a removed
    replica is recognizably stale and gets dropped instead of
    delivered.
    """

    def __init__(self, stale_after: float = 3.0, clock=time.monotonic):
        self.stale_after = stale_after
        self._clock = clock
        # rid -> (last heartbeat version, monotonic time it advanced)
        self._hb: Dict[str, Tuple[int, float]] = {}
        self._dead: Dict[str, float] = {}
        self.generation = 0

    def add(self, rid: str) -> None:
        self._hb.setdefault(rid, (0, self._clock()))

    def alive(self) -> List[str]:
        return sorted(self._hb)

    def is_alive(self, rid: str) -> bool:
        return rid in self._hb

    def observe(self, rid: str, version: int) -> None:
        """Record a heartbeat read; only an ADVANCING version counts as
        liveness (a wedged replica's last value re-read forever must
        still go stale)."""
        if rid not in self._hb:
            return
        last_ver, last_t = self._hb[rid]
        if version > last_ver:
            self._hb[rid] = (version, self._clock())

    def stale(self) -> List[str]:
        now = self._clock()
        return sorted(
            rid
            for rid, (_, t) in self._hb.items()
            if now - t > self.stale_after
        )

    def reap(self, rid: str) -> int:
        """Remove a dead replica; returns the new routing generation."""
        if rid in self._hb:
            del self._hb[rid]
            self._dead[rid] = self._clock()
            self.generation += 1
        return self.generation

    def dead(self) -> List[str]:
        return sorted(self._dead)


def remap_fraction(
    fingerprints: Iterable[str], before: Sequence[str], after: Sequence[str]
) -> float:
    """Fraction of *fingerprints* whose rendezvous owner changes going
    from replica set *before* to *after* (test/diagnostic helper)."""
    fps = list(fingerprints)
    if not fps:
        return 0.0
    moved = sum(
        1 for fp in fps if route(fp, before) != route(fp, after)
    )
    return moved / len(fps)
