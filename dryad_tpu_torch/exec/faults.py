"""Fault injection — the SetFakeVertexFailure analog, grown into a
seeded chaos harness.

The reference exposes knobs to fake vertex / vertex-input failures for
testing recovery paths (``DryadVertex/VertexHost/system/dprocess/
include/dryadvertex.h:240,247``).  Here: a process-global registry the
executor (and checkpoint store) consult before running work, with two
injection modes:

- **count-based** knobs (``set_fake_stage_failure`` et al.): fail the
  next N attempts — the original remote-controllable switches;
- a **seeded** :class:`FaultPlan`: probabilistic stage failures,
  stage delays, and checkpoint corruption drawn from one
  ``random.Random(seed)`` stream, with per-stage caps so a chaos run
  is guaranteed to stay inside the retry budget.  The same seed
  replays the same fault schedule — the property the chaos
  differential suite (``tests/test_chaos.py``) is built on.

Injected faults raise :class:`InjectedStageFailure` (a TRANSIENT
failure in the ``exec.failure`` taxonomy), exercising the
versioned-retry + backoff path.
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import Dict, Optional, Sequence


class InjectedFault(RuntimeError):
    """Base class of all injected failures (classified TRANSIENT)."""


class InjectedStageFailure(InjectedFault):
    pass


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded probabilistic fault schedule.

    Draws come from one ``random.Random(seed)`` stream in call order,
    so a fixed (seed, workload) pair replays bit-identically.  Caps
    (``max_failures_per_stage``, ``max_checkpoint_corruptions``) bound
    the injected chaos below the retry budget, so a chaos run is
    *expected to succeed* — the suite asserts oracle-exact results,
    not mere survival.

    - ``stage_failure_prob``: per-attempt probability that a stage
      raises :class:`InjectedStageFailure`;
    - ``stages``: restrict failures/delays to stages whose fused name
      contains one of these op tokens (None = all stages);
    - ``stage_delay_prob`` / ``stage_delay_seconds``: probabilistic
      slow-stage injection (the slow-worker scenario);
    - ``checkpoint_corruption_prob``: probability that a just-saved
      checkpoint gets payload bytes flipped (silent bit rot the CRC
      verification must catch);
    - ``worker_kill_prob`` / ``max_worker_kills``: per-stage-attempt
      probability that the hosting PROCESS dies outright
      (``os._exit``) — the gang chaos scenario: a worker dying inside
      a stage leaves its peers stranded in the stage's collectives
      (mid-collective death).  Only install kill-bearing plans on
      WORKER processes (via the ``set_fault`` mailbox command,
      ``cluster.worker``); a driver-side plan with kills would kill
      the test/driver process itself.
    """

    seed: int = 0
    stage_failure_prob: float = 0.0
    stages: Optional[Sequence[str]] = None
    max_failures_per_stage: int = 2
    stage_delay_prob: float = 0.0
    stage_delay_seconds: float = 0.0
    checkpoint_corruption_prob: float = 0.0
    max_checkpoint_corruptions: int = 1
    worker_kill_prob: float = 0.0
    max_worker_kills: int = 1


class _Registry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_stage: Dict[str, int] = {}
        self._delay_by_stage: Dict[str, tuple] = {}  # key -> (secs, count)
        self._corrupt_count = 0
        self._plan: Optional[FaultPlan] = None
        self._plan_rng = random.Random(0)
        self._plan_failures: Dict[str, int] = {}
        self._plan_corruptions = 0
        self._plan_kills = 0
        self._corrupt_rng = random.Random(0xC0FFEE)  # count-based mode

    # -- count-based knobs (the remote-controllable switches) ----------------
    def set_fake_stage_failure(self, stage_name: str, count: int = 1) -> None:
        """Fail the next ``count`` attempts of stages named
        ``stage_name``.  ``count < 0`` means fail EVERY attempt with a
        stable message — a deterministic failure the taxonomy
        (``exec.failure.classify``) fails fast on."""
        with self._lock:
            self._by_stage[stage_name] = count

    def set_fake_stage_delay(
        self, stage_name: str, seconds: float, count: int = 1
    ) -> None:
        """Stall the next ``count`` attempts of matching stages by
        ``seconds`` — the injected slow-stage knob."""
        with self._lock:
            self._delay_by_stage[stage_name] = (float(seconds), int(count))

    def set_fake_checkpoint_corruption(self, count: int = 1) -> None:
        """Corrupt the next ``count`` checkpoint saves (payload byte
        flips after publish — silent bit rot for the CRC check)."""
        with self._lock:
            self._corrupt_count = int(count)

    def install_plan(self, plan: Optional[FaultPlan]) -> None:
        """Install (or clear, with None) the seeded chaos plan."""
        with self._lock:
            self._plan = plan
            self._plan_rng = random.Random(plan.seed if plan else 0)
            self._plan_failures.clear()
            self._plan_corruptions = 0
            self._plan_kills = 0

    def clear(self) -> None:
        with self._lock:
            self._by_stage.clear()
            self._delay_by_stage.clear()
            self._corrupt_count = 0
            self._plan = None
            self._plan_failures.clear()
            self._plan_corruptions = 0
            self._plan_kills = 0

    # -- consultation points -------------------------------------------------
    def _plan_matches(self, tokens: set) -> bool:
        assert self._plan is not None
        if self._plan.stages is None:
            return True
        return any(k in tokens for k in self._plan.stages)

    def maybe_fail(self, stage_name: str) -> None:
        """Fail if any registered name matches the stage's fused-op name
        (stage names are '+'-joined node kinds, e.g. 'input+group_by'),
        or if the installed plan's draw says so."""
        tokens = set(stage_name.split("+"))
        with self._lock:
            for key, n in self._by_stage.items():
                if key != stage_name and key not in tokens:
                    continue
                if n < 0:
                    # stable message: classified DETERMINISTIC on repeat
                    raise InjectedStageFailure(
                        f"injected deterministic failure for stage "
                        f"{stage_name!r} (key {key!r})"
                    )
                if n > 0:
                    self._by_stage[key] = n - 1
                    raise InjectedStageFailure(
                        f"injected failure for stage {stage_name!r} "
                        f"(key {key!r}, {n} remaining)"
                    )
            p = self._plan
            if (
                p is not None
                and p.stage_failure_prob > 0.0
                and self._plan_matches(tokens)
                and self._plan_failures.get(stage_name, 0)
                < p.max_failures_per_stage
                and self._plan_rng.random() < p.stage_failure_prob
            ):
                k = self._plan_failures.get(stage_name, 0) + 1
                self._plan_failures[stage_name] = k
                # per-occurrence message: stays TRANSIENT in the taxonomy
                raise InjectedStageFailure(
                    f"chaos(seed={p.seed}): injected failure #{k} for "
                    f"stage {stage_name!r}"
                )

    def maybe_kill(self, stage_name: str) -> bool:
        """Seeded gang-chaos draw: True when the installed plan says the
        hosting PROCESS should die before executing this stage attempt
        (the caller ``os._exit``s).  Returns False unless a plan with
        ``worker_kill_prob > 0`` is installed — so in-process chaos
        suites (which never set it) can never kill the test runner."""
        with self._lock:
            p = self._plan
            if p is None or p.worker_kill_prob <= 0.0:
                return False
            if self._plan_kills >= p.max_worker_kills:
                return False
            if not self._plan_matches(set(stage_name.split("+"))):
                return False
            if self._plan_rng.random() < p.worker_kill_prob:
                self._plan_kills += 1
                return True
        return False

    def maybe_delay(self, stage_name: str) -> float:
        """Seconds this stage attempt should stall (0.0 = no delay)."""
        tokens = set(stage_name.split("+"))
        with self._lock:
            for key, (secs, n) in self._delay_by_stage.items():
                if n > 0 and (key == stage_name or key in tokens):
                    self._delay_by_stage[key] = (secs, n - 1)
                    return secs
            p = self._plan
            if (
                p is not None
                and p.stage_delay_prob > 0.0
                and self._plan_matches(tokens)
                and self._plan_rng.random() < p.stage_delay_prob
            ):
                return p.stage_delay_seconds
        return 0.0

    def maybe_corrupt_checkpoint(self, directory: str) -> bool:
        """Flip payload bytes in one partition file of a just-published
        checkpoint — AFTER the header line, so the file still parses
        and only the CRC verification can tell (silent bit rot)."""
        with self._lock:
            fire = False
            if self._corrupt_count > 0:
                self._corrupt_count -= 1
                fire = True
            else:
                p = self._plan
                if (
                    p is not None
                    and p.checkpoint_corruption_prob > 0.0
                    and self._plan_corruptions < p.max_checkpoint_corruptions
                    and self._plan_rng.random()
                    < p.checkpoint_corruption_prob
                ):
                    self._plan_corruptions += 1
                    fire = True
            rng = (
                self._plan_rng if self._plan is not None
                else self._corrupt_rng
            )
        if not fire:
            return False
        return _flip_payload_bytes(directory, rng)


def _flip_payload_bytes(directory: str, rng) -> bool:
    """XOR a byte in the first ``.dpf`` payload under ``directory``."""
    import glob
    import os

    for path in sorted(glob.glob(os.path.join(directory, "*.dpf"))):
        with open(path, "rb") as fh:
            buf = bytearray(fh.read())
        nl = buf.find(b"\n")
        if nl < 0 or nl + 1 >= len(buf):
            continue  # no payload to corrupt; try the next file
        at = nl + 1 + rng.randrange(len(buf) - nl - 1)
        buf[at] ^= 0xFF
        with open(path, "wb") as fh:
            fh.write(buf)
        return True
    return False


registry = _Registry()
set_fake_stage_failure = registry.set_fake_stage_failure
set_fake_stage_delay = registry.set_fake_stage_delay
set_fake_checkpoint_corruption = registry.set_fake_checkpoint_corruption
install_plan = registry.install_plan
clear_faults = registry.clear
