"""Failure taxonomy and structured job failure (a part of
``dryad_tpu/exec/failure.py``).

- :class:`FailureKind`: the failure domains — ``TRANSIENT`` (unreadable
  or corrupt checkpoints: recomputing is expected to succeed),
  ``DETERMINISTIC`` (the same error reproduces: fail fast),
  ``RESOURCE`` (capacity: the executor's boost palette handles it).
- :class:`StageFailedError`: a stage reached a terminal failure;
  :class:`CheckpointCorruptionError`, a checkpoint failed its CRC
  check; :class:`JobFailedError`, a terminal job failure carrying its
  :class:`Attempt` history.

The reference's retry policy and failure classifier (``RetryPolicy``,
``classify``) drive its stage-failure retries, which come with the
cluster and fault-injection work (ROADMAP queue 1 item 13).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence


class FailureKind(enum.Enum):
    """Failure domain of one failed attempt."""

    TRANSIENT = "transient"
    DETERMINISTIC = "deterministic"
    RESOURCE = "resource"


@dataclasses.dataclass
class Attempt:
    """Record of one failed attempt."""

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
