"""Cluster-service abstractions — the ``ClusterInterface`` analog.

Mirrors the reference's L3 contracts (``ClusterInterface/Interfaces.cs:324-545``):
``ICluster`` (computer membership, process scheduling/cancel, property
mailbox access, file-path construction) and ``IScheduler`` (queue a
process, notify run/completion), plus the resource/affinity model of the
GM kernel (``GraphManager/kernel/DrResources.h:41-137`` —
DrResource/DrUniverse/DrAffinity).

In this framework the "process" is host-side work around the device
compute (a vertex task's command round trip, stage materialization,
multi-host control), not the compute itself.  The semantics
kept from the reference: locality affinities with hard/soft weights,
dynamic computer membership, versioned process state callbacks.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

_pids = itertools.count(1)


class ProcessState(enum.Enum):
    """Lifecycle of a scheduled process (``DrProcess.h:40-46`` DPBS_*)."""

    NOT_STARTED = "not_started"
    QUEUED = "queued"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"
    CANCELED = "canceled"


@dataclasses.dataclass(frozen=True)
class Computer:
    """A worker host (``DrResources.h`` DrResource at machine level)."""

    name: str
    rack: str = "rack0"
    slots: int = 1


@dataclasses.dataclass(frozen=True)
class Affinity:
    """Placement preference (``DrResources.h:41-137`` DrAffinity).

    ``locality`` names a computer or a rack; ``hard`` constraints never
    relax to other locations; ``weight`` orders soft preferences.
    """

    locality: str
    hard: bool = False
    weight: float = 1.0


class ClusterProcess:
    """Handle for one scheduled unit of host work (``DrProcess`` analog).

    ``fn`` runs on the assigned computer's worker slot; raising marks
    the process FAILED.  State transitions are observed via
    ``on_state`` callbacks (the IProcessWatcher contract,
    ``Interfaces.cs:214-258``).
    """

    def __init__(
        self,
        fn: Callable[["ClusterProcess"], Any],
        name: str = "",
        affinities: Sequence[Affinity] = (),
    ):
        self.id = next(_pids)
        self.name = name or f"proc-{self.id}"
        self.fn = fn
        self.affinities = list(affinities)
        self.state = ProcessState.NOT_STARTED
        self.computer: Optional[str] = None
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self._done = threading.Event()
        self._cancel = threading.Event()
        self._watchers: List[Callable[["ClusterProcess"], None]] = []
        self._lock = threading.Lock()

    # -- watcher contract ----------------------------------------------------
    def on_state(self, cb: Callable[["ClusterProcess"], None]) -> None:
        with self._lock:
            self._watchers.append(cb)

    def _transition(self, state: ProcessState) -> None:
        with self._lock:
            self.state = state
            watchers = list(self._watchers)
        for cb in watchers:
            cb(self)
        if state in (
            ProcessState.COMPLETED,
            ProcessState.FAILED,
            ProcessState.CANCELED,
        ):
            self._done.set()

    # -- caller surface ------------------------------------------------------
    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)


class Scheduler:
    """The IScheduler contract (``Interfaces.cs:467-545``), extended
    with the machine-level failure accounting of the reference GM
    (computers producing repeated failures are blacklisted so retries
    land elsewhere; re-admitted on probation after a cooldown)."""

    def schedule(self, process: ClusterProcess) -> None:
        raise NotImplementedError

    def cancel(self, process: ClusterProcess) -> None:
        raise NotImplementedError

    def add_computer(self, computer: Computer) -> None:
        raise NotImplementedError

    def remove_computer(self, name: str) -> None:
        raise NotImplementedError

    def computers(self) -> List[Computer]:
        raise NotImplementedError

    # -- failure accounting / quarantine (optional; default no-op) -----------
    def record_failure(self, computer: str) -> None:
        """Attribute one failure to ``computer`` (implementations keep
        a sliding window and quarantine past a threshold)."""

    def quarantined(self) -> List[str]:
        """Names of computers currently receiving no new dispatches."""
        return []
