"""RewriteController — fold diagnoses into plan-rewrite decisions.

Driver-side policy object, fed from the live event stream exactly the
way :class:`obs.diagnose.DiagnosisEngine` is (an ``EventLog`` tap
whose ``observe`` never raises).  It folds ONLY ``diagnosis`` events
— the diagnosis engine already did the statistics; this layer maps
named pathologies onto the small action vocabulary of
:mod:`rewrite.actions`:

====================  =================  ==============================
diagnosis rule        action             consumed by
====================  =================  ==============================
``partition_skew``    split_bucket       ``StreamExecutor`` phase-1
(stream_spill)                           chunk boundary (sort range
                                         refinement / join re-hash)
``overflow_loop``     prewiden_palette   ``GraphExecutor._run_stage``
                                         boost floor
``combine_thrash``    pin_combine +      ``_group_partial_flat`` (pin)
                      flip_combine       / ``_group_partial_device``
                                         (strategy choice)
manual/any            retune_exchange    ``GraphExecutor`` auto
                                         exchange-window resolution
====================  =================  ==============================

Every decision emits a ``plan_rewrite`` event with
``phase="decided"``; drivers emit ``phase="applied"`` when they honor
one.  Decisions are deduplicated (one pending split per bucket, a
boost floor only ever rises, a pin sets once) so a persistent
pathology cannot flood the drivers with identical actions.

Thread-safety: taps run on whatever thread emitted the event (driver,
spill writer, collector); consumption runs on the driver thread.  All
state mutations hold the controller lock.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional

from dryad_tpu_torch.rewrite.actions import RewriteAction

__all__ = ["RewriteController"]

# bound the split fan-out a single skew diagnosis can request
_MAX_SPLIT_FAN = 64
_MIN_SPLIT_FAN = 4


def _split_fan(ratio: float) -> int:
    """Sub-bucket count for a hot bucket: enough pow2 sub-ranges to
    level a ``ratio``-times-mean bucket back to ~mean, clamped."""
    r = max(2.0, float(ratio or 2.0))
    return int(min(_MAX_SPLIT_FAN, max(_MIN_SPLIT_FAN, 2 ** math.ceil(math.log2(r)))))


class _Tuning:
    """Config fallbacks (the controller works config-less, like the
    diagnosis engine)."""

    def __init__(self, config):
        g = lambda k, d: getattr(config, k, d) if config is not None else d  # noqa: E731
        self.boost_cap = 2 ** int(g("max_shuffle_retries", 4))
        self.max_split_depth = 3


class RewriteController:
    """See the module doc.  ``events`` is the sink ``plan_rewrite``
    decisions are emitted into (usually the same log being tapped —
    ``observe`` ignores non-``diagnosis`` kinds, so no feedback
    loop); ``None`` retains the audit trail without emitting."""

    def __init__(self, config=None, events=None):
        self.tuning = _Tuning(config)
        self.events = events
        self._lock = threading.Lock()
        # audit trail: every action ever decided, in order
        self.records: List[RewriteAction] = []
        # pending hot-bucket splits: depth -> bucket -> action
        self._splits: Dict[int, Dict[int, RewriteAction]] = {}
        self._split_seen: set = set()  # (depth, bucket) ever decided
        # per-stage-name starting-boost floors (only ever rise)
        self._floors: Dict[str, int] = {}
        # streaming-combine pin ("host") and tree-strategy override
        self._pin: Optional[str] = None
        self._tree_override: Optional[bool] = None
        # explicit staged-exchange window override (auto mode only)
        self._xchg_hint: Optional[int] = None

    # -- fold surface (EventLog tap) -----------------------------------------

    def observe(self, ev: Dict[str, Any]) -> None:
        """EventLog tap: fold one event.  Never raises."""
        try:
            if ev.get("kind") == "diagnosis":
                self._on_diagnosis(ev)
        except Exception:
            pass  # policy must never fail the job

    def _on_diagnosis(self, ev: Dict[str, Any]) -> None:
        rule = ev.get("rule")
        evidence = ev.get("evidence") or {}
        if rule == "partition_skew":
            self._on_skew(evidence)
        elif rule == "overflow_loop":
            self._on_overflow(ev, evidence)
        elif rule == "combine_thrash":
            self._on_thrash(evidence)
        elif rule == "hbm_pressure":
            self._on_hbm_pressure(evidence)

    def _on_skew(self, evidence: Dict[str, Any]) -> None:
        # only the stream_spill fold names a concrete bucket; the
        # histogram fold is a labels-level signal with nothing to split
        if evidence.get("source") != "stream_spill":
            return
        subject = str(evidence.get("subject", ""))
        if "depth=" not in subject or "hot_bucket" not in evidence:
            return
        depth = int(str(subject).rsplit("depth=", 1)[1])
        if depth >= self.tuning.max_split_depth:
            return  # the driver could not recurse further anyway
        bucket = int(evidence["hot_bucket"])
        act = RewriteAction(
            action="split_bucket",
            rule="partition_skew",
            subject=subject,
            params={
                "depth": depth,
                "bucket": bucket,
                "rows": int(evidence.get("hot_rows", 0) or 0),
                "ratio": float(evidence.get("ratio", 0.0) or 0.0),
                "fan": _split_fan(evidence.get("ratio", 2.0)),
            },
        )
        with self._lock:
            if (depth, bucket) in self._split_seen:
                return
            self._split_seen.add((depth, bucket))
            self._splits.setdefault(depth, {})[bucket] = act
            self.records.append(act)
        self._emit_decided(act)

    def _on_hbm_pressure(self, evidence: Dict[str, Any]) -> None:
        # measured HBM near exhaustion: pin the staged-exchange window
        # to its narrowest (1) so subsequent compilations stage one
        # bucket at a time.  A pinned hint — from anywhere, including
        # an earlier pressure fold — stays pinned: pressure persists
        # until operands shrink, and re-pinning every sample would
        # flood the decision trail.
        with self._lock:
            if self._xchg_hint is not None:
                return
        self.retune_exchange(1, reason="hbm_pressure")

    def _on_overflow(self, ev: Dict[str, Any], evidence: Dict[str, Any]) -> None:
        name = str(ev.get("name") or evidence.get("subject") or "?")
        boost = int(evidence.get("boost", 1) or 1)
        # the diagnosed boost already overflowed — start the NEXT
        # dispatch one tier wider, inside the bounded palette
        floor = min(boost * 2, self.tuning.boost_cap)
        act = RewriteAction(
            action="prewiden_palette",
            rule="overflow_loop",
            subject=name,
            params={"stage": name, "boost": floor},
        )
        with self._lock:
            if self._floors.get(name, 1) >= floor:
                return
            self._floors[name] = floor
            self.records.append(act)
        self._emit_decided(act)

    def _on_thrash(self, evidence: Dict[str, Any]) -> None:
        # pin the HOST side of the oscillation: degrade is the
        # always-correct conservative mode the policy kept returning
        # to, and pinning it ends the re-ingest churn immediately
        with self._lock:
            if self._pin is not None:
                return
            self._pin = "host"
            self._tree_override = True
            pin = RewriteAction(
                action="pin_combine",
                rule="combine_thrash",
                subject="stream_combine",
                params={"mode": "host"},
            )
            flip = RewriteAction(
                action="flip_combine",
                rule="combine_thrash",
                subject="stream_combine",
                params={"tree": True},
            )
            self.records.extend((pin, flip))
        self._emit_decided(pin)
        self._emit_decided(flip)

    # -- consumption surfaces (driver-side) ----------------------------------

    def claim_splits(self, depth: int) -> List[RewriteAction]:
        """Pop every pending hot-bucket split for ``depth``.  The
        claimant owns them: the sort driver refines the range, the
        join driver re-hashes — whichever spill loop polls first."""
        with self._lock:
            pend = self._splits.pop(int(depth), None)
        return list(pend.values()) if pend else []

    def boost_floor(self, name: str) -> int:
        """Starting-boost floor for one stage name (1 = no rewrite)."""
        with self._lock:
            return self._floors.get(name, 1)

    def combine_pin(self) -> Optional[str]:
        """Pinned streaming-combine mode, or None."""
        return self._pin

    def combine_tree_override(self) -> Optional[bool]:
        """Tree-vs-flat strategy override for group_by streams."""
        return self._tree_override

    def exchange_window_hint(self) -> Optional[int]:
        """Explicit window for the auto exchange policy, or None."""
        return self._xchg_hint

    def retune_exchange(self, window: int, reason: str = "manual") -> RewriteAction:
        """Public retune hook: pin the auto exchange-window policy to
        ``window`` (0 = flat) for subsequent compilations.  Only
        consulted when ``config.exchange_window == -1`` — the static
        knob always wins."""
        w = max(0, int(window))
        act = RewriteAction(
            action="retune_exchange",
            rule=reason,
            subject="exchange",
            params={"window": w},
        )
        with self._lock:
            self._xchg_hint = w
            self.records.append(act)
        self._emit_decided(act)
        return act

    # -- audit ---------------------------------------------------------------

    def actions(self) -> List[Dict[str, Any]]:
        """The decision trail as flat dicts (explain/bench surface)."""
        with self._lock:
            return [a.event_fields() for a in self.records]

    def reset(self) -> None:
        """Drop all decisions and pins (tests / long-lived contexts)."""
        with self._lock:
            self._splits.clear()
            self._split_seen.clear()
            self._floors.clear()
            self._pin = None
            self._tree_override = None
            self._xchg_hint = None

    def _emit_decided(self, act: RewriteAction) -> None:
        if self.events is not None:
            self.events.emit(
                "plan_rewrite", phase="decided", **act.event_fields()
            )
