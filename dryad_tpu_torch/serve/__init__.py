"""Serving tier — multiplex concurrent tenant queries on one resident
engine (a copy of ``dryad_tpu/serve/``).

A :class:`QueryService` owns ONE driver thread (the executor is
driver-owned and not thread-safe), admits queries from many logical
tenants under per-tenant quotas, schedules them fair-share (weighted
deficit round robin inside strict priority tiers) onto a single shared
:class:`~dryad_tpu_torch.exec.pipeline.DispatchWindow`, and serves
repeat queries from a plan-fingerprint result cache.  Client threads
only build plans, submit, and block on :class:`QueryFuture`.

The multi-process serving fleet (``FleetClient``, ``ReplicaRunner``,
``ServeFleet``) needs the cluster service and job packages: ROADMAP
queue 1 item 13.  Its names raise ``NotImplementedError`` here; the
router's pure functions (:mod:`~dryad_tpu_torch.serve.router`) are
ported.
"""

from dryad_tpu_torch.serve.admission import (
    DEFAULT_TIER,
    TIERS,
    QueryRejected,
    TenantQuota,
)
from dryad_tpu_torch.serve.cache import ResultCache
from dryad_tpu_torch.serve.router import (
    NegativeQuotaMemo,
    ReplicaSet,
    canonical_fingerprint,
    package_fingerprint,
    rendezvous_rank,
    route,
)
from dryad_tpu_torch.serve.service import QueryFuture, QueryService, TenantSession

# the serving fleet of the reference's serve/fleet.py and serve/replica.py
_PENDING_FLEET = ("FleetClient", "ReplicaRunner", "ServeFleet")


def __getattr__(name):
    if name in _PENDING_FLEET:
        raise NotImplementedError(
            f"dryad_tpu_torch.serve.{name}: the multi-process serving fleet "
            "is not ported yet (ROADMAP.md queue 1 item 13)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DEFAULT_TIER",
    "NegativeQuotaMemo",
    "QueryFuture",
    "QueryRejected",
    "QueryService",
    "ReplicaSet",
    "ResultCache",
    "TIERS",
    "TenantSession",
    "TenantQuota",
    "canonical_fingerprint",
    "package_fingerprint",
    "rendezvous_rank",
    "route",
]
