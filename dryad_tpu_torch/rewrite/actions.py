"""RewriteAction — the typed unit of runtime plan rewriting.

An action is a *decision*: which rewrite to apply, to what subject,
with what parameters, and which diagnosis rule justified it.  The
controller creates actions (emitting a ``plan_rewrite`` event with
``phase="decided"``); a driver that honors one emits the matching
``phase="applied"`` event at its application point.  The two-phase
trail is the audit surface — a decided action with no applied twin
means the driver never reached a safe boundary (or the subject was
already gone), which is itself diagnostic.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

# action id -> what the driver does with it
ACTIONS: Dict[str, str] = {
    "split_bucket": (
        "refine a hot spill bucket into sub-buckets mid-stream: the "
        "sort driver re-elects range splitters for that bucket from "
        "the observed key sample, the join driver re-hashes it at "
        "salt+1; rows already spilled re-route once, rows still to "
        "come route directly"
    ),
    "prewiden_palette": (
        "raise the starting pow2 capacity boost for one stage so the "
        "next dispatch starts wide instead of overflowing into the "
        "retry ladder again"
    ),
    "pin_combine": (
        "pin the streaming-combine host/device decision for the rest "
        "of the stream, ending a degrade/reprobe oscillation"
    ),
    "flip_combine": (
        "prefer the combine tree (per-key-range degrade) over the "
        "flat all-or-nothing combiner for subsequent group_by streams"
    ),
    "retune_exchange": (
        "override the auto exchange-window policy with an explicit "
        "staged-exchange window for subsequent compilations"
    ),
}


@dataclasses.dataclass(frozen=True)
class RewriteAction:
    """One rewrite decision.  ``params`` is action-specific and flat
    (scalars only) — it inlines into the ``plan_rewrite`` event."""

    action: str  # key into ACTIONS
    rule: str  # diagnosis rule that produced it ("manual" for API calls)
    subject: str  # diagnosis subject (stage name, spill depth, ...)
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown rewrite action {self.action!r}")

    def event_fields(self) -> Dict[str, Any]:
        """Flat payload for the ``plan_rewrite`` event (minus phase)."""
        out: Dict[str, Any] = {
            "action": self.action,
            "rule": self.rule,
            "subject": self.subject,
        }
        out.update(self.params)
        return out
