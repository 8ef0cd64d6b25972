"""Failure taxonomy, retry policy, and structured job failure.

The reference's job manager distinguishes *where* a failure came from
before deciding what to do about it: vertices re-execute under a
version budget (``DrVertexRecord.h:164-194``), machines that repeatedly
produce failures are blacklisted so the retries land elsewhere
(``DrGraph.h:42`` failure accounting), and capacity problems re-shape
the graph rather than retrying blindly.  This module is that decision
layer for this framework:

- :class:`FailureKind` — the failure domains:

  * ``TRANSIENT``: injected faults, worker death, unreadable or
    corrupt checkpoints — re-execution on (possibly different)
    resources is expected to succeed;
  * ``DETERMINISTIC``: the same exception class + message reproduced
    on a *different* computer — retrying elsewhere cannot help, fail
    fast with the history instead of burning the budget;
  * ``RESOURCE``: capacity-shaped outcomes (shuffle/join overflow) —
    handled by the executor's boost palette, never by blind retry.

- :class:`RetryPolicy` — exponential backoff with **seeded** jitter
  (deterministic per (seed, key, attempt), so chaos runs replay
  bit-identically) and a per-stage attempt budget.

- :class:`JobFailedError` — the structured terminal error carrying the
  full :class:`Attempt` history, so a failed job is post-mortem
  inspectable (the event log's ``stage_failed`` and ``job_failed``
  events hold the same history).
"""

from __future__ import annotations

import dataclasses
import enum
import random
from typing import List, Optional, Sequence


class FailureKind(enum.Enum):
    """Failure domain of one failed attempt."""

    TRANSIENT = "transient"
    DETERMINISTIC = "deterministic"
    RESOURCE = "resource"


@dataclasses.dataclass
class Attempt:
    """Record of one failed attempt (the DrVertexRecord version entry)."""

    number: int
    error_type: str
    error: str
    kind: str = FailureKind.TRANSIENT.value
    computer: Optional[str] = None
    backoff: float = 0.0

    def describe(self) -> str:
        where = f" on {self.computer}" if self.computer else ""
        wait = f", backoff {self.backoff:.3f}s" if self.backoff else ""
        return (
            f"attempt {self.number}{where}: {self.error_type}: "
            f"{self.error} [{self.kind}{wait}]"
        )


class StageFailedError(RuntimeError):
    """A stage reached a terminal failure (budget, capacity, guard)."""


class CheckpointCorruptionError(StageFailedError):
    """A persisted checkpoint failed its integrity check (CRC
    mismatch).  TRANSIENT: the caller recomputes instead of loading."""


class JobFailedError(StageFailedError):
    """Terminal job failure carrying the full attempt history."""

    def __init__(
        self,
        message: str,
        stage: Optional[str] = None,
        attempts: Sequence[Attempt] = (),
    ):
        self.stage = stage
        self.attempts: List[Attempt] = list(attempts)
        if self.attempts:
            message += "\nattempt history:\n" + "\n".join(
                "  " + a.describe() for a in self.attempts
            )
        super().__init__(message)


def classify(
    error: BaseException,
    history: Sequence[Attempt],
    computer: Optional[str] = None,
) -> FailureKind:
    """Classify a new failure against the attempt history so far.

    A failure whose exception class AND message reproduce an earlier
    attempt's is DETERMINISTIC when the earlier attempt ran on a
    different computer (or when neither side names a computer — the
    single-driver executor, where "elsewhere" does not exist and an
    identical repeat is already proof).  Everything else is TRANSIENT;
    RESOURCE failures (overflow) never reach this function — the
    executor's boost palette owns them.
    """
    et, em = type(error).__name__, str(error)
    for a in history:
        if a.error_type != et or a.error != em:
            continue
        if computer is None or a.computer is None or a.computer != computer:
            return FailureKind.DETERMINISTIC
    return FailureKind.TRANSIENT


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with seeded jitter and an attempt budget.

    ``backoff(key, failures)`` is deterministic in (seed, key,
    failures): chaos suites replay the exact same schedule per seed,
    and two stages with the same failure count still spread out
    (the jitter term de-correlates their retry storms).
    """

    max_attempts: int = 3
    backoff_base: float = 0.05
    backoff_max: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    def backoff(self, key: str, failures: int) -> float:
        """Seconds to wait before the retry after ``failures`` (>= 1)
        consecutive failures of ``key``."""
        raw = min(
            self.backoff_base * (2 ** max(failures - 1, 0)),
            self.backoff_max,
        )
        # random.Random(str) seeds via sha512: stable across processes
        # (hash() is salted per-process and would break replay)
        rng = random.Random(f"{self.seed}:{key}:{failures}")
        return raw * (1.0 + self.jitter * rng.random())

    def exhausted(self, failures: int) -> bool:
        return failures >= self.max_attempts
