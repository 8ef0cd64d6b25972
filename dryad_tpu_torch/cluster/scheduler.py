"""LocalScheduler — affinity queues with delay-based locality relaxation
and machine-level failure quarantine.

The analog of the reference scheduler (``LocalScheduler/LocalScheduler.cs``):
processes queue at their preferred computer first, relax to the rack
queue after ``rack_delay`` seconds and to the cluster-wide queue after
``cluster_delay`` seconds (reference defaults 1s/2s,
``LocalScheduler.cs:52-53``); hard constraints never relax
(``:149-160``).  Computer membership is elastic
(``WaitForReasonableNumberOfComputers``, ``LocalScheduler.cs:88``).

**Quarantine** (the Dryad machine-blacklist analog): every process
failure is attributed to the computer it ran on in a sliding window;
past ``quarantine_threshold`` failures the computer is quarantined —
no new dispatches, and queued SOFT affinities relax away from it
immediately.  A HARD affinity naming a quarantined computer still
dispatches there: hard constraints never relax, and refusing them
would deadlock gang commands that are pinned per-worker by design.
After ``quarantine_cooldown`` the computer re-admits on **probation**:
the first failure while on probation re-quarantines immediately; a
success clears probation.  ``clock`` is injectable so the whole
lifecycle is fake-time testable (no real sleeps).

Worker slots are threads; a "process" is host-side work (stage
materialization, ingest/egress, control) — see ``interfaces`` docstring.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Set

from dryad_tpu_torch.cluster.interfaces import (
    Affinity,
    ClusterProcess,
    Computer,
    ProcessState,
    Scheduler,
)
from dryad_tpu_torch.exec.stats import FailureWindow
from dryad_tpu_torch.utils.logging import get_logger

log = get_logger("dryad_tpu_torch.cluster")


class _Entry:
    def __init__(self, process: ClusterProcess, now: float):
        self.process = process
        self.enqueued = now


class LocalScheduler(Scheduler):
    def __init__(
        self,
        computers: Optional[List[Computer]] = None,
        rack_delay: float = 1.0,
        cluster_delay: float = 2.0,
        poll_interval: float = 0.02,
        quarantine_threshold: int = 3,
        quarantine_window: float = 60.0,
        quarantine_cooldown: float = 30.0,
        clock=None,
        events=None,
    ):
        self.rack_delay = rack_delay
        self.cluster_delay = cluster_delay
        self.poll_interval = poll_interval
        self.quarantine_threshold = quarantine_threshold
        self.quarantine_window = quarantine_window
        self.quarantine_cooldown = quarantine_cooldown
        self._clock = clock or time.monotonic
        self._events = events  # optional EventLog
        self._lock = threading.Condition()
        self._computers: Dict[str, Computer] = {}
        self._busy: Dict[str, int] = {}  # computer -> running count
        self._queue: List[_Entry] = []  # single list; eligibility by age
        self._failures: Dict[str, FailureWindow] = {}
        self._quarantine: Dict[str, float] = {}  # name -> cooldown end
        self._probation: Set[str] = set()
        # LOCAL failures not yet exported to peer drivers (multihost
        # shared quarantine, obs.gang.ship_failure_deltas); remote
        # absorptions never land here, so deltas can't echo.
        self._unshipped: Dict[str, int] = {}
        self._stop = False
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="dryad-scheduler", daemon=True
        )
        for c in computers or []:
            self._computers[c.name] = c
            self._busy[c.name] = 0
        self._dispatcher.start()

    def _emit(self, kind: str, **fields) -> None:
        if self._events is not None:
            self._events.emit(kind, **fields)

    # -- membership (elastic, Interfaces.cs:336-343) -------------------------
    def add_computer(self, computer: Computer) -> None:
        with self._lock:
            self._computers[computer.name] = computer
            self._busy.setdefault(computer.name, 0)
            self._lock.notify_all()

    def remove_computer(self, name: str) -> None:
        stranded: List[_Entry] = []
        with self._lock:
            self._computers.pop(name, None)
            # a re-added computer of the same name is a fresh worker:
            # its predecessor's failure history must not follow it
            # (locally or through the shared-quarantine channel)
            self._failures.pop(name, None)
            self._quarantine.pop(name, None)
            self._probation.discard(name)
            self._unshipped.pop(name, None)
            # Fail fast queued processes whose HARD affinity named the
            # removed computer and can no longer be satisfied by any
            # remaining member — _eligible would never match a missing
            # computer, leaving them queued until an external timeout.
            for e in list(self._queue):
                hard = [a for a in e.process.affinities if a.hard]
                if not hard or not any(a.locality == name for a in hard):
                    continue
                if not any(
                    self._hard_matches(a, c)
                    for a in hard
                    for c in self._computers.values()
                ):
                    self._queue.remove(e)
                    stranded.append(e)
        for e in stranded:
            p = e.process
            p.error = RuntimeError(
                f"computer {name!r} removed from the cluster; process "
                f"{p.name!r} holds a hard affinity "
                f"{[a.locality for a in p.affinities if a.hard]} no "
                f"remaining computer satisfies"
            )
            log.warning("%s", p.error)
            self._emit(
                "process_stranded", process=p.name, computer=name,
            )
            p._transition(ProcessState.FAILED)

    def _hard_matches(self, a: Affinity, comp: Computer) -> bool:
        """One hard affinity vs one computer (same rule as _eligible)."""
        return a.locality == comp.name or (
            a.locality not in self._computers and a.locality == comp.rack
        )

    # -- failure accounting / quarantine (machine blacklist analog) ----------
    def record_failure(self, computer: str) -> None:
        """Attribute one failure to ``computer``; quarantine past the
        sliding-window threshold (probation failures re-quarantine at
        once)."""
        with self._lock:
            self._note_failure_locked(computer)

    def _note_failure_locked(self, name: str, remote: bool = False) -> None:
        now = self._clock()
        count = self._failures.setdefault(
            name, FailureWindow(self.quarantine_window)
        ).record(now)
        if not remote:
            self._unshipped[name] = self._unshipped.get(name, 0) + 1
        if name in self._probation:
            # a probation failure proves the cooldown solved nothing
            self._probation.discard(name)
            self._quarantine[name] = now + self.quarantine_cooldown
            log.warning("computer %s re-quarantined on probation", name)
            self._emit(
                "computer_quarantined", computer=name, failures=count,
                cooldown=self.quarantine_cooldown, probation=True,
            )
            return
        if name not in self._quarantine and count >= self.quarantine_threshold:
            self._quarantine[name] = now + self.quarantine_cooldown
            log.warning(
                "computer %s quarantined after %d failures in %.0fs",
                name, count, self.quarantine_window,
            )
            self._emit(
                "computer_quarantined", computer=name, failures=count,
                cooldown=self.quarantine_cooldown, probation=False,
            )

    def _note_success_locked(self, name: str) -> None:
        if name in self._probation:
            self._probation.discard(name)
            self._failures.pop(name, None)
            log.info("computer %s readmitted after probation", name)
            self._emit("computer_readmitted", computer=name)

    def _quarantined_now_locked(self) -> Set[str]:
        """Names currently quarantined; expired cooldowns move the
        computer to probation as a side effect."""
        now = self._clock()
        out: Set[str] = set()
        for name, until in list(self._quarantine.items()):
            if now < until:
                out.add(name)
            else:
                del self._quarantine[name]
                self._probation.add(name)
                self._emit("computer_probation", computer=name)
        return out

    def quarantined(self) -> List[str]:
        with self._lock:
            return sorted(self._quarantined_now_locked())

    # -- multihost shared quarantine (ROADMAP; GM-global machine failure
    # counts): every driver in a multi-controller gang ships its LOCAL
    # failure deltas through the telemetry mailbox channel
    # (obs.gang.ship_failure_deltas) and folds its peers' deltas into
    # the same sliding windows, so the whole gang converges on one
    # blacklist without a central coordinator.
    def failure_delta(self) -> Dict[str, int]:
        """Drain the not-yet-shipped LOCAL failure counts (the export
        half of the shared blacklist; remote absorptions are excluded
        so a delta can never echo back and forth)."""
        with self._lock:
            out = {k: v for k, v in self._unshipped.items() if v > 0}
            self._unshipped.clear()
            return out

    def absorb_remote_failures(
        self, deltas: Dict[str, int], source=None
    ) -> None:
        """Fold a peer driver's failure deltas into this scheduler's
        windows/quarantine WITHOUT re-exporting them."""
        with self._lock:
            for name, n in deltas.items():
                for _ in range(int(n)):
                    self._note_failure_locked(name, remote=True)
        self._emit(
            "quarantine_absorbed", source=source, deltas=dict(deltas),
        )

    def computers(self) -> List[Computer]:
        with self._lock:
            return list(self._computers.values())

    def wait_for_computers(self, n: int, timeout: float = 30.0) -> bool:
        """Block until >= n computers joined (LocalScheduler.cs:88)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while len(self._computers) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._lock.wait(left)
            return True

    # -- scheduling ----------------------------------------------------------
    def schedule(self, process: ClusterProcess) -> None:
        with self._lock:
            process._transition(ProcessState.QUEUED)
            self._queue.append(_Entry(process, self._clock()))
            self._lock.notify_all()

    def schedule_batch(self, processes: List[ClusterProcess]) -> None:
        """Enqueue several processes atomically (one lock round, one
        wakeup) — the coded-spare launch path enqueues all r parity
        vertices at once so they contend for slots as one decision."""
        with self._lock:
            now = self._clock()
            for p in processes:
                p._transition(ProcessState.QUEUED)
                self._queue.append(_Entry(p, now))
            self._lock.notify_all()

    def cancel(self, process: ClusterProcess) -> None:
        """Cancel a queued or running process (``ICluster.CancelProcess``).

        Running work observes ``process.cancelled`` cooperatively (the
        reference kills the worker process; slots here are threads)."""
        with self._lock:
            for e in list(self._queue):
                if e.process is process:
                    self._queue.remove(e)
                    process._cancel.set()
                    process._transition(ProcessState.CANCELED)
                    return
        process._cancel.set()  # running: cooperative

    # -- placement policy ----------------------------------------------------
    def _rack_of(self, locality: str) -> str:
        """A locality names a computer or a rack; resolve to a rack."""
        c = self._computers.get(locality)
        return c.rack if c is not None else locality

    def _eligible(self, entry: _Entry, comp: Computer, quar: Set[str]) -> bool:
        affs = entry.process.affinities
        if not affs:
            return True
        hard = [a for a in affs if a.hard]
        if hard:
            # a hard computer constraint pins exactly that computer; a
            # hard rack constraint allows any computer in the rack
            return any(self._hard_matches(a, comp) for a in hard)
        # quarantined preferred localities drop out of the preference
        # set entirely: the entry relaxes away from them IMMEDIATELY
        # (waiting out rack/cluster delays for a blacklisted machine
        # would just stall the retry the quarantine exists to re-place)
        affs = [a for a in affs if a.locality not in quar]
        if not affs:
            return True
        age = self._clock() - entry.enqueued
        # the preferred locality itself is served immediately: an exact
        # computer match, or a rack-level affinity naming this rack —
        # delays only gate *relaxation* away from the preference
        if any(
            a.locality == comp.name
            or (a.locality not in self._computers and a.locality == comp.rack)
            for a in affs
        ):
            return True
        if age >= self.rack_delay and any(
            self._rack_of(a.locality) == comp.rack for a in affs
        ):
            return True
        return age >= self.cluster_delay

    def _dispatchable(self, entry: _Entry, comp: Computer, quar: Set[str]) -> bool:
        """Quarantine gate ahead of affinity eligibility: a quarantined
        computer receives no new dispatches — except for processes whose
        HARD affinity pins them to it (hard constraints never relax;
        refusing would deadlock per-worker gang commands)."""
        if comp.name in quar and not any(
            a.hard and self._hard_matches(a, comp)
            for a in entry.process.affinities
        ):
            return False
        return self._eligible(entry, comp, quar)

    def _pick(self) -> Optional[tuple]:
        """Find (entry, computer) to run; prefer older entries and their
        stronger (higher-weight) affinities."""
        idle = [
            c
            for c in self._computers.values()
            if self._busy.get(c.name, 0) < c.slots
        ]
        if not idle:
            return None
        quar = self._quarantined_now_locked()
        for entry in self._queue:  # FIFO
            affs = sorted(
                entry.process.affinities, key=lambda a: -a.weight
            )
            # strongest preference first: exact computer, then rack
            for a in affs:
                for c in idle:
                    if c.name == a.locality and self._dispatchable(
                        entry, c, quar
                    ):
                        return entry, c
            for a in affs:
                for c in idle:
                    if c.rack == a.locality and self._dispatchable(
                        entry, c, quar
                    ):
                        return entry, c
            for c in idle:
                if self._dispatchable(entry, c, quar):
                    return entry, c
        return None

    # -- dispatch loop -------------------------------------------------------
    def _dispatch_loop(self) -> None:
        while True:
            with self._lock:
                if self._stop:
                    return
                pick = self._pick()
                if pick is None:
                    self._lock.wait(self.poll_interval)
                    continue
                entry, comp = pick
                self._queue.remove(entry)
                self._busy[comp.name] += 1
                wait = self._clock() - entry.enqueued
            # queue-wait accounting (obs): how long placement took,
            # including locality-relaxation delays — the scheduling-
            # latency half of the gang telemetry story
            self._emit(
                "process_dispatch", process=entry.process.name,
                computer=comp.name, wait_s=round(wait, 4),
            )
            threading.Thread(
                target=self._run, args=(entry.process, comp), daemon=True
            ).start()

    def _run(self, process: ClusterProcess, comp: Computer) -> None:
        process.computer = comp.name
        process._transition(ProcessState.RUNNING)
        try:
            if process.cancelled:
                process._transition(ProcessState.CANCELED)
                return
            process.result = process.fn(process)
        except BaseException as e:  # noqa: BLE001 — report, don't die
            process.error = e
            log.warning("process %s failed on %s: %s", process.name, comp.name, e)
            self._emit(
                "process_failed", process=process.name,
                computer=comp.name, error=str(e),
            )
            with self._lock:
                self._note_failure_locked(comp.name)
            process._transition(ProcessState.FAILED)
        else:
            if process.cancelled:
                process._transition(ProcessState.CANCELED)
            else:
                with self._lock:
                    self._note_success_locked(comp.name)
                process._transition(ProcessState.COMPLETED)
        finally:
            with self._lock:
                if comp.name in self._busy:
                    self._busy[comp.name] -= 1
                self._lock.notify_all()

    def shutdown(self) -> None:
        with self._lock:
            self._stop = True
            drained = [e.process for e in self._queue]
            self._queue.clear()
            self._lock.notify_all()
        for p in drained:  # never-started work must still reach a terminal state
            p._cancel.set()
            p._transition(ProcessState.CANCELED)
        self._dispatcher.join(timeout=5)
