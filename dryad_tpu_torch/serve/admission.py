"""Admission control — per-tenant budgets and the structured rejection
(a copy of ``dryad_tpu/serve/admission.py``).

Admission runs on the CLIENT thread at submit time, before a query
ever reaches the shared dispatch window: an over-quota tenant fails
fast with :class:`QueryRejected` and can never wedge the window (the
acceptance invariant of the serving tier).  Budgets are per tenant —
in-flight query count and admitted host-input bytes — so one tenant
saturating its own quota leaves every other tenant's admission
untouched.

Priority tiers layer ON TOP of the DRR weights: every tenant belongs
to one of :data:`TIERS` ("latency" before "batch"), the scheduler
serves any runnable latency-tier tenant before touching the batch
tier, and weights keep their meaning WITHIN a tier.
"""

from __future__ import annotations

import dataclasses

# Scheduling order: every runnable tenant of TIERS[i] is served before
# any tenant of TIERS[i+1].  DRR weights apply within a tier only.
TIERS = ("latency", "batch")
DEFAULT_TIER = "latency"


def check_tier(tier: str) -> str:
    """Validate a tier name (returns it, for assignment chaining)."""
    if tier not in TIERS:
        raise ValueError(
            f"unknown priority tier {tier!r}; expected one of {TIERS}"
        )
    return tier


def tier_rank(tier: str) -> int:
    """Position of *tier* in the strict-priority order (0 = first)."""
    return TIERS.index(check_tier(tier))


class QueryRejected(RuntimeError):
    """Admission refused — structured so callers can shed load
    programmatically instead of parsing a message.

    ``reason`` is one of ``"inflight"`` (per-tenant in-flight query
    cap), ``"bytes"`` (per-tenant admitted host-input byte budget), or
    ``"closed"`` (service shut down with the query still queued).
    ``limit``/``current`` are the budget and the value that tripped it.
    """

    def __init__(self, tenant: str, reason: str, limit: int, current: int):
        self.tenant = tenant
        self.reason = reason
        self.limit = limit
        self.current = current
        super().__init__(
            f"tenant {tenant!r} rejected: {reason} at {current} "
            f"against limit {limit}"
        )


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """One tenant's admission budget.

    ``max_inflight``: admitted-and-unresolved query cap.
    ``max_bytes``: summed host-input bytes of admitted queries
    (``DryadContext.query_input_bytes``); 0 disables the byte check.
    Defaults come from ``config.serve_max_inflight`` /
    ``config.serve_max_bytes`` when the session is opened without an
    explicit quota.
    """

    max_inflight: int = 32
    max_bytes: int = 1 << 30

    def check(
        self, tenant: str, inflight: int, inflight_bytes: int,
        cost_bytes: int,
    ) -> None:
        """Raise :class:`QueryRejected` when admitting one more query
        of ``cost_bytes`` would exceed either budget."""
        if inflight >= self.max_inflight:
            raise QueryRejected(
                tenant, "inflight", self.max_inflight, inflight
            )
        if self.max_bytes and inflight_bytes + cost_bytes > self.max_bytes:
            raise QueryRejected(
                tenant, "bytes", self.max_bytes,
                inflight_bytes + cost_bytes,
            )
