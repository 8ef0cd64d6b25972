"""Serving tier — multiplex concurrent tenant queries on one resident
engine (a copy of ``dryad_tpu/serve/``).

A :class:`QueryService` owns ONE driver thread (the executor is
driver-owned and not thread-safe), admits queries from many logical
tenants under per-tenant quotas, schedules them fair-share (weighted
deficit round robin inside strict priority tiers) onto a single shared
:class:`~dryad_tpu_torch.exec.pipeline.DispatchWindow`, and serves
repeat queries from a plan-fingerprint result cache.  Client threads
only build plans, submit, and block on :class:`QueryFuture`.

The multi-process serving fleet (:mod:`~dryad_tpu_torch.serve.fleet`:
``ServeFleet``, ``FleetClient``, ``ReplicaRunner``; replica processes
through ``python -m dryad_tpu_torch.serve.replica``) puts one front-door
``ProcessService`` before N such engines and routes each plan to its
rendezvous owner (:mod:`~dryad_tpu_torch.serve.router`).
"""

from dryad_tpu_torch.serve.admission import (
    DEFAULT_TIER,
    TIERS,
    QueryRejected,
    TenantQuota,
)
from dryad_tpu_torch.serve.cache import ResultCache
from dryad_tpu_torch.serve.fleet import FleetClient, ReplicaRunner, ServeFleet
from dryad_tpu_torch.serve.router import (
    NegativeQuotaMemo,
    ReplicaSet,
    canonical_fingerprint,
    package_fingerprint,
    rendezvous_rank,
    route,
)
from dryad_tpu_torch.serve.service import QueryFuture, QueryService, TenantSession

__all__ = [
    "DEFAULT_TIER",
    "FleetClient",
    "NegativeQuotaMemo",
    "QueryFuture",
    "QueryRejected",
    "QueryService",
    "ReplicaRunner",
    "ReplicaSet",
    "ResultCache",
    "ServeFleet",
    "TIERS",
    "TenantSession",
    "TenantQuota",
    "canonical_fingerprint",
    "package_fingerprint",
    "rendezvous_rank",
    "route",
]
