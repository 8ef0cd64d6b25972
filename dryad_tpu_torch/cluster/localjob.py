"""LocalJobSubmission — an N-process local job, end to end
(``dryad_tpu/cluster/localjob.py``).

The reference's minimum distributed bar (``LinqToDryad/
LocalJobSubmission.cs:97-147``): one job-manager process plus N worker
processes on one machine, composed from the same parts a real cluster
uses:

- ``ProcessService`` (mailbox + file server + block cache) is the
  control/data plane, hosted in the driver;
- ``LocalScheduler`` places the per-worker command round trips on the
  workers' computer slots with soft and hard affinities and quarantine;
- N ``cluster.worker`` OS processes announce on the ``ControlPlane``
  and run on their device (CUDA unless the submission names the CPU:
  several workers share one card, each with its own context);
- ``submit`` runs a plan as ONE program across the worker gang: the
  workers join one ``torch.distributed`` group (``init_distributed``;
  ``nccl`` when each has a card of its own, ``gloo`` on the CPU or when
  they share a card), each holds ``devices_per_worker`` of the
  ``num_workers * devices_per_worker`` partitions, and the plan's
  collectives cross processes (``parallel/partition.py``);
  ``submit_many`` batches several such runs into ``runbatch``
  envelopes, overlapped through a ``GangDispatchWindow`` at
  ``gang_batch_depth > 1``; a gang that lost a member mid-job restarts
  under a fresh coordinator (``rebuild_gang``) and re-runs;
- ``ControlPlane`` barriers gate the gang's stage boundaries (start,
  durable output) and carry membership, heartbeats and failure reports;
- job packages ship the plan (``exec/jobpackage.py``); result
  partitions come back as partition files read through the file
  server's ranged GETs with zlib wire compression.

``submit_partitioned`` runs a plan as independent re-executable vertex
tasks with speculative duplication of stragglers, coded k-of-n partial
aggregation (``redundancy/``), dead-worker re-execution, fault and
delay injection (``inject_fault``, ``inject_delay``) and level -1
worker combines.

Usage::

    with LocalJobSubmission(num_workers=2, devices_per_worker=4) as sub:
        table = sub.submit(query)
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from dryad_tpu_torch.cluster.interfaces import (
    Affinity,
    ClusterProcess,
    Computer,
    ProcessState,
)
from dryad_tpu_torch.cluster.scheduler import LocalScheduler
from dryad_tpu_torch.cluster.service import ProcessService, ServiceClient
from dryad_tpu_torch.columnar.io import parse_partition_bytes
from dryad_tpu_torch.columnar.schema import StringDictionary
from dryad_tpu_torch.exec import partial as _partial
from dryad_tpu_torch.exec.events import EventLog
from dryad_tpu_torch.exec.failure import (
    Attempt,
    FailureKind,
    JobFailedError,
    RetryPolicy,
    classify,
)
from dryad_tpu_torch.exec.jobpackage import pack_query
from dryad_tpu_torch.exec.stats import StageStatistics
from dryad_tpu_torch.obs import flightrec, tracectx
from dryad_tpu_torch.obs.diagnose import DiagnosisEngine
from dryad_tpu_torch.obs.span import Tracer
from dryad_tpu_torch.utils.logging import get_logger

log = get_logger("dryad_tpu_torch.cluster.localjob")


def _driver_key_hash(cols, keys) -> np.ndarray:
    """Row hash over the key columns for similarity HISTOGRAMS.  Now
    that gang workers ship level-(-1) pre-merge snapshots, driver- and
    worker-computed histograms must live in ONE range space, so this
    delegates to the shared deterministic hash
    (``exec.partial.key_hash64`` — engine Hash64 for strings, never
    Python's process-salted ``hash()``)."""
    return _partial.key_hash64(cols, keys)


def _merge_group_state(cols, keys, red) -> Dict[str, np.ndarray]:
    """Fold one merge group's partial STATE rows by key with the plan's
    associative reductions (``exec.partial.state_reductions``) — no
    finalize, so the result is itself a valid partial table.  The fold
    itself lives in ``exec.partial.merge_state_rows`` so the gang
    workers' level-(-1) pre-merge is the same code path byte for
    byte."""
    return _partial.merge_state_rows(cols, keys, red)


def _host_call(fn, *tables) -> Dict[str, np.ndarray]:
    """Run a user function of the port (a ``Decomposable``'s ``merge``
    or ``finalize``, written for torch tensors) on the driver's host
    columns: numeric columns travel as CPU tensors (object columns as
    they are) and the result comes back as numpy arrays."""
    import torch

    args = [
        {k: (torch.from_numpy(np.ascontiguousarray(v)) if np.asarray(v).dtype != object
             else np.asarray(v)) for k, v in t.items()}
        for t in tables
    ]
    return {
        k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
        for k, v in fn(*args).items()
    }


def _free_port() -> int:
    """Pick a coordinator port from a pid-derived candidate sequence so
    concurrent LocalJobSubmissions on one machine probe DIFFERENT ports
    (the bind-check-close window lasts until worker 0 rebinds it — a
    kernel-assigned port 0 can't be reserved across processes)."""
    base = 21000 + (os.getpid() * 131) % 20000
    for off in range(64):
        port = base + off
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", port))
                return port
        except OSError:
            continue
    with socket.socket() as s:  # fall back to a kernel-assigned port
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class WorkerLauncher:
    """The worker-start seam (reference: composing Peloponnese process
    groups for LOCAL vs YARN, ``LocalJobSubmission.cs:141-147`` /
    ``YarnJobSubmission.cs:63-111``).  ``spec`` carries everything
    needed to start one worker; implementations may exec a subprocess
    (below), ssh to a host, or exec into a pod."""

    def start(self, spec: Dict):
        """Launch one worker; returns an opaque handle."""
        raise NotImplementedError

    def poll(self, handle) -> Optional[int]:
        """Exit code if the worker died, else None."""
        raise NotImplementedError

    def stop(self, handle, timeout: float = 5.0) -> None:
        raise NotImplementedError

    def wait(self, handle, timeout: float) -> None:
        raise NotImplementedError


class SubprocessLauncher(WorkerLauncher):
    """Local OS-process launcher (the reference's LOCAL platform)."""

    def start(self, spec: Dict) -> subprocess.Popen:
        lf = open(spec["log_path"], "w")
        try:
            return subprocess.Popen(
                spec["argv"], stdout=lf, stderr=subprocess.STDOUT,
                env=spec["env"],
            )
        finally:
            lf.close()

    def poll(self, handle) -> Optional[int]:
        return handle.poll()

    def wait(self, handle, timeout: float) -> None:
        handle.wait(timeout=timeout)

    def stop(self, handle, timeout: float = 5.0) -> None:
        handle.terminate()
        try:
            handle.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            handle.kill()


class CommandLauncher(SubprocessLauncher):
    """Launcher that wraps the worker argv in a host command template —
    the remote-cluster seam (``YarnJobSubmission.cs:63-111`` composes
    worker process groups the same way).  ``template`` is a list of
    prefix tokens; ``{host}`` substitutes a per-worker host from
    ``hosts`` (round-robin).

    What this seam does and does NOT solve: the template only controls
    HOW the worker command starts.  True off-machine launch (ssh /
    kubectl exec) additionally needs (a) the wrapper to forward the
    worker environment (spec["env"] applies to the local wrapper
    process, so e.g. ssh needs ``env K=V ...`` tokens or a remote
    profile), (b) an interpreter + checkout reachable at the same
    paths on the remote host (shared filesystem or baked image), and
    (c) the driver's ProcessService and coordinator bound on a
    routable address — pass ``bind_host``/``advertise_host`` to
    :class:`LocalJobSubmission` for that.  The template alone is
    exercised in-tree with local prefixes (``env``, ``nice`` …).
    """

    def __init__(self, template: Optional[List[str]] = None,
                 hosts: Optional[List[str]] = None):
        self.template = list(template or [])
        self.hosts = list(hosts or [])
        self.forward_env = False

    def start(self, spec: Dict):
        host = (
            self.hosts[spec["index"] % len(self.hosts)]
            if self.hosts else "localhost"
        )
        prefix = [t.replace("{host}", host) for t in self.template]
        tail = list(spec["argv"])
        if self.forward_env:
            # materialize the worker env as `env K=V ...` argv tokens so
            # a remote shell (ssh) starts the worker with the same
            # environment the local launcher would have injected; every
            # token is shell-quoted because ssh joins argv with spaces
            # and the REMOTE shell re-parses the line — unquoted values
            # like XLA_FLAGS='--a --b' would split, and metacharacters
            # (PS1 with $(...), LESSOPEN with |) would execute remotely
            import shlex

            tail = ["env"] + [
                f"{k}={v}" for k, v in sorted(spec.get("env", {}).items())
            ] + tail
            tail = [shlex.quote(t) for t in tail]
        spec = dict(spec, argv=prefix + tail)
        return super().start(spec)

    @classmethod
    def ssh(cls, hosts: List[str], ssh_args: Optional[List[str]] = None):
        """Preset for ssh-launched workers — the YARN/Peloponnese
        remote process-group shape (``YarnJobSubmission.cs:63-111``):
        ``ssh -tt <args> {host} env K=V ... python -m dryad_tpu_torch.cluster.worker ...``.
        ``-tt`` forces a remote tty so that killing the local ssh
        client (the launcher's stop/kill escalation for a wedged
        worker) hangs up the remote side and the worker dies with it —
        without it sshd leaves the remote process running.
        Requirements (interpreter + checkout on the remote path, driver
        services bound on a routable address) are in the class
        docstring.  The env-forwarding argv form is what the in-tree
        template test exercises with a local stand-in."""
        out = cls(["ssh", "-tt", *(ssh_args or []), "{host}"], hosts)
        out.forward_env = True
        return out


class LocalJobSubmission:
    """Driver for N worker processes jointly executing submitted queries
    (a gang program, ``submit``) or their vertex tasks
    (``submit_partitioned``).

    ``device``: where the workers run (``"cuda"``, the default, or
    ``"cpu"``); N workers on one card each hold a context of their own.
    ``devices_per_worker``: the partitions each worker holds in a gang.  ``defer_workers``: leave that many workers
    unstarted; they may join LATE via :meth:`start_worker` —
    submissions block in ``_sync_membership`` until a worker announced
    (elastic membership, ``LocalScheduler.cs:88``
    WaitForReasonableNumberOfComputers).  :meth:`start_worker` also
    restarts a worker that died, in its old slot.
    """

    def __init__(
        self,
        num_workers: int = 2,
        devices_per_worker: int = 2,
        root: Optional[str] = None,
        worker_timeout: float = 300.0,
        launcher: Optional[WorkerLauncher] = None,
        defer_workers: int = 0,
        bind_host: str = "127.0.0.1",
        advertise_host: Optional[str] = None,
        device: str = "cuda",
    ):
        """``bind_host``/``advertise_host``: where the driver's service
        listens / how workers address it — loopback for local jobs;
        bind "0.0.0.0" and advertise a routable name when a
        :class:`CommandLauncher` starts workers off-machine."""
        from dryad_tpu_torch.parallel.multihost import ControlPlane

        self.n = num_workers
        self.k = devices_per_worker
        self.device = str(device)
        self.timeout = worker_timeout
        self.root = root or tempfile.mkdtemp(prefix="dryad-localjob-")
        self.job_id = f"job-{os.getpid()}-{int(time.time() * 1000)}"
        self.advertise = advertise_host or "127.0.0.1"
        self.service = ProcessService(self.root, host=bind_host)
        self.launcher = launcher or SubprocessLauncher()
        self.events = EventLog(os.path.join(self.root, "events.jsonl"))
        # Flight recorder: the driver's ring dumps next to the workers'
        # (every process writes blackbox-<pid>.json under
        # <root>/blackbox), and this dump is the one carrying the
        # per-worker clock offsets.
        self._recorder = flightrec.install_recorder(
            capacity=2048,
            snapshot_s=1.0,
            dump_dir=os.path.join(self.root, "blackbox"),
            role="driver",
            events=self.events,
        )
        # Online diagnosis over the driver-side stream.  The engine's
        # per-family duration models persist ACROSS submissions, which
        # is what lets a later coded job pre-launch parity from prior
        # jobs' completion times instead of waiting for its own first
        # failure (see _submit_coded).
        self.diagnosis = DiagnosisEngine(events=self.events)
        self.events.add_tap(self.diagnosis.observe)
        # Computers register on ANNOUNCE (elastic membership), not at
        # construction — a late worker's slot must not accept tasks
        # that would stall until it exists.  The scheduler shares the
        # submission's event log so quarantine transitions land in the
        # job's one stream.
        self.scheduler = LocalScheduler([], events=self.events)
        self.tracer = Tracer(self.events)
        self._client = ServiceClient("127.0.0.1", self.service.port)
        self._cp = ControlPlane(self.job_id, -1, mailbox=self.service.mailbox)
        self._status_ver: Dict[int, int] = {}
        # per-worker telemetry read cursors + clock offsets (obs.gang)
        self._telemetry_state: Dict[int, Dict] = {}
        # per-plan-signature duration models: the outlier fit assumes
        # repeated attempts of the SAME work (DrStageStatistics), so
        # heterogeneous queries must not share one model
        self._gang_stats: Dict[Tuple, StageStatistics] = {}
        self._seq = 0
        self._cseq = 0  # unique per driver command; echoed in statuses
        # mailbox round trips actually paid (one per command posted)
        self.round_trips = 0
        self._handles: Dict[int, object] = {}
        self._logs: Dict[int, str] = {}
        self._registered: set = set()
        self._dead: set = set()
        self._reap_lock = threading.Lock()
        self._coord = f"{self.advertise}:{_free_port()}"
        self._base_job_id = self.job_id
        self._gen = 0  # gang generation (bumped by rebuild_gang)
        # set when a gang run failed in a collective: the group's ranks
        # may be out of step, so the next gang submission rebuilds first
        self._gang_out_of_step = False
        for i in range(self.n - max(defer_workers, 0)):
            self.start_worker(i)

    # -- worker process group (the Peloponnese "Worker" group) ---------------
    def _worker_spec(self, i: int) -> Dict:
        env = dict(os.environ)
        # Workers must resolve the same modules as the driver: packed
        # plans pickle user fns BY REFERENCE to their defining module
        # (the local-mode analog of the reference staging the generated
        # vertex DLL to every worker, LocalJobSubmission.cs:141-147).
        repo = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
        paths = [repo] + [p for p in sys.path if p] + [
            p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p
        ]
        env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
        return {
            "argv": [
                sys.executable, "-m", "dryad_tpu_torch.cluster.worker",
                "--service-host", self.advertise,
                "--service-port", str(self.service.port),
                "--job", self.job_id,
                "--pid", str(i),
                "--nproc", str(self.n),
                "--devices-per-proc", str(self.k),
                "--coordinator", self._coord,
                "--root", self.root,
                # a gang collective gives up before the driver does, so
                # the driver reads the error naming the stage
                "--timeout", str(max(1.0, self.timeout / 2)),
                "--device", self.device,
            ],
            "env": env,
            "log_path": os.path.join(self.root, f"worker{i}.log"),
            "index": i,
        }

    def start_worker(self, i: int) -> None:
        """Start (possibly late) worker ``i`` through the launcher; a
        worker whose process died is replaced in its slot."""
        if i in self._handles:
            if self.launcher.poll(self._handles[i]) is None:
                raise ValueError(f"worker {i} already started")
            self._clear_slot(i)
        spec = self._worker_spec(i)
        self._logs[i] = spec["log_path"]
        self._handles[i] = self.launcher.start(spec)
        self.events.emit("worker_started", worker=i)
        log.info(
            "started worker %d/%d x %d partitions on %s (job %s, psvc :%d)",
            i, self.n, self.k, self.device, self.job_id, self.service.port,
        )

    def _clear_slot(self, i: int) -> None:
        """Forget dead worker ``i`` so a replacement takes its slot: its
        computer, membership and command props, and its telemetry
        batches (drained first, so nothing it shipped is lost and the
        replacement's numbering starts afresh).  Its status prop stays:
        versions keep rising, so stale statuses stay recognisable."""
        self._collect_telemetry()
        self._handles.pop(i)
        self._logs.pop(i, None)
        self.scheduler.remove_computer(f"worker{i}")
        self._registered.discard(i)
        self._dead.discard(i)
        mb = self.service.mailbox
        for name in (f"member/{i}", f"cmd/{i}", f"hb/{i}", f"fail/{i}"):
            mb.del_prop(self.job_id, name)
        st = self._telemetry_state.pop(i, None) or {}
        for seq in range(1, st.get("seq", 0) + 1):
            mb.del_prop(self.job_id, f"telemetry/{i}/{seq}")

    def worker_devices(self) -> Dict[int, Dict]:
        """Announce metadata of each announced worker: ``device`` (e.g.
        ``cuda:0``), ``device_name``, or ``device_error`` for a worker
        that could not open its device."""
        out: Dict[int, Dict] = {}
        for i in self._cp.announced(self.n):
            got = self._cp._get(f"member/{i}")
            if got is not None:
                out[i] = json.loads(got[1])
        return out

    def _sync_membership(self, timeout: float = 120.0, gang: bool = True) -> None:
        """Block until the gang announced; register each announced
        worker's computer with the scheduler exactly once.

        ``gang=True`` (SPMD jobs) needs EVERY worker: a started worker
        dying before it announces fails fast with its log tail instead
        of burning the membership timeout.  ``gang=False`` (independent
        vertex tasks) tolerates dead workers — survivors carry the job
        (DrVertex re-execution semantics)."""
        deadline = time.monotonic() + timeout
        while True:
            if gang:
                self._check_workers_alive()
            else:
                self._reap_dead_workers()
            for i in self._cp.announced(self.n):
                if i not in self._registered:
                    self._registered.add(i)
                    self.scheduler.add_computer(
                        Computer(f"worker{i}", slots=1)
                    )
                    self.events.emit("worker_joined", worker=i)
            live = len(self._registered - self._dead)
            need = self.n if gang else max(1, self.n - len(self._dead))
            if live >= need:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"only {live}/{need} workers announced after {timeout}s"
                )
            time.sleep(0.1)

    def _worker_log_tail(self, i: int, nbytes: int = 2000) -> str:
        try:
            with open(self._logs[i], "rb") as fh:
                fh.seek(0, os.SEEK_END)
                size = fh.tell()
                fh.seek(max(0, size - nbytes))
                return fh.read().decode("utf-8", "replace")
        except OSError:
            return "<no log>"

    def _check_workers_alive(self) -> None:
        # a copy: start_worker may insert a late worker meanwhile
        for i, h in list(self._handles.items()):
            rc = self.launcher.poll(h)
            if rc is not None:
                raise RuntimeError(
                    f"worker {i} exited rc={rc}; log tail:\n"
                    + self._worker_log_tail(i)
                )

    def _reap_dead_workers(self) -> None:
        """Deregister dead workers' computers so vertex-task retries and
        duplicates place on survivors only.  Round-trip threads call it
        too, so a death is logged once."""
        with self._reap_lock:
            for i, h in list(self._handles.items()):
                if i in self._dead:
                    continue
                if self.launcher.poll(h) is not None:
                    self._dead.add(i)
                    self.scheduler.remove_computer(f"worker{i}")
                    self.events.emit("worker_dead", worker=i)
                    log.warning("worker %d died; removed from scheduling", i)

    # -- submission ----------------------------------------------------------
    def _next_cseq(self) -> int:
        self._cseq += 1
        return self._cseq

    def _check_worker_alive(self, i: int) -> None:
        h = self._handles.get(i)
        if h is not None:
            rc = self.launcher.poll(h)
            if rc is not None:
                # deregister first: the failure frees the worker's slot in
                # the scheduler, which would place a queued task on the dead
                # worker before the driver's loop reaps it (a coded job then
                # loses a third vertex to two kills and re-executes)
                self._reap_dead_workers()
                raise RuntimeError(
                    f"worker {i} exited rc={rc}; log tail:\n"
                    + self._worker_log_tail(i)
                )

    def _round_trip_body(
        self, i: int, cmd: Dict, proc: ClusterProcess, gang: bool = True
    ) -> Dict:
        """The GM->worker command protocol: set ``cmd/<i>``, long-poll
        ``status/<i>`` (DVertexCommand / DVertexStatus,
        ``dvertexcommand.cpp:29-30``).  ``cmd`` must carry a unique
        ``cseq``; statuses echoing an older cseq (a run the driver
        already timed out on or canceled) are consumed and discarded so
        they can't be misattributed to this command.

        ``gang`` commands fail fast when ANY worker dies (a gang SPMD
        program cannot finish without every member); vertex-task round
        trips watch only their OWN worker, so an unrelated death leaves
        independent work running (re-execution handles the victim)."""
        mb = self.service.mailbox
        self.round_trips += 1
        mb.set_prop(self.job_id, f"cmd/{i}", json.dumps(cmd).encode())
        deadline = time.monotonic() + self.timeout
        while not proc.cancelled:
            after = self._status_ver.get(i, 0)
            got = mb.get_prop(self.job_id, f"status/{i}", after, timeout=1.0)
            if got is not None:
                self._status_ver[i] = got[0]
                st = json.loads(got[1])
                if st.get("cseq") != cmd["cseq"]:
                    continue  # stale status from an abandoned command
                if st.get("state") == "failed":
                    self._note_gang_status(st)
                    raise RuntimeError(
                        f"worker {i} failed: {st.get('error')}"
                    )
                return st
            if gang:
                self._check_workers_alive()
            else:
                self._check_worker_alive(i)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"worker {i}: no status after {self.timeout}s; "
                    f"log tail:\n" + self._worker_log_tail(i)
                )
        return {"state": "canceled"}

    @staticmethod
    def _stamp_trace(cmd: Dict) -> Dict:
        """Attach the active query's trace context to a mailbox
        envelope (driver thread — the context is live HERE, not on the
        round-trip process that later posts the command)."""
        ctx = tracectx.current()
        if ctx is not None and "trace" not in cmd:
            cmd["trace"] = ctx.to_wire()
        return cmd

    def _command_round_trip(self, i: int, cmd: Dict):
        """Round trip pinned to worker ``i`` (gang commands)."""
        self._stamp_trace(cmd)

        def fn(proc: ClusterProcess) -> Dict:
            return self._round_trip_body(i, cmd, proc)

        return fn

    def _placed_round_trip(self, cmd: Dict):
        """Round trip to whichever worker the scheduler placed the
        process on (vertex tasks: any computer may serve any task)."""
        self._stamp_trace(cmd)

        def fn(proc: ClusterProcess) -> Dict:
            i = int(proc.computer.removeprefix("worker"))
            return self._round_trip_body(i, cmd, proc, gang=False)

        return fn

    def _note_gang_status(self, st: Dict) -> None:
        """Mark the gang out of step when a status (or one of a batch's
        sub-statuses) failed in a collective: a rank that timed out
        inside an exchange its peer never entered leaves the group's
        collective sequences misaligned, and no later collective on it
        can be trusted."""
        errs = [st.get("error")] + [r.get("error") for r in st.get("results") or []]
        if any(e and "GangStageError" in e for e in errs):
            self._gang_out_of_step = True

    def _heal_gang(self) -> None:
        """Before a gang submission: restart a gang whose group is out of
        step (:meth:`rebuild_gang` at the same size)."""
        if self._gang_out_of_step:
            log.warning("the gang's group is out of step after a collective failure; rebuilding")
            self.rebuild_gang(self.n)

    def rebuild_gang(self, num_workers: Optional[int] = None) -> int:
        """Mid-job gang elasticity (the reference's mutable computer
        set, ``ClusterInterface/Interfaces.cs:336-343``,
        ``LocalScheduler.cs:88``): reshape the gang to ``num_workers``
        (default: the current survivors) and restart it under a fresh
        coordinator + announce namespace.  A ``torch.distributed``
        group pins its membership at init (it cannot shrink), so a gang
        that lost a member RESTARTS rather than limping — survivors
        (possibly blocked in collectives with the dead peer) are
        stopped, every slot respawns, and the caller re-runs its
        submission."""
        dead = set(self._dead) | {
            i for i, h in self._handles.items()
            if self.launcher.poll(h) is not None
        }
        target = num_workers if num_workers is not None else max(
            1, self.n - len(dead)
        )
        self.events.emit(
            "gang_rebuild", dead=sorted(dead), workers=target,
            generation=self._gen + 1,
        )
        for h in self._handles.values():
            try:
                if self.launcher.poll(h) is None:
                    self.launcher.stop(h)
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        for i in list(self._registered):
            self.scheduler.remove_computer(f"worker{i}")
        self._handles.clear()
        self._logs.clear()
        self._registered.clear()
        self._dead.clear()
        self._status_ver.clear()
        self.n = target
        self._gen += 1
        self._gang_out_of_step = False
        # Fresh namespace: stale announce/status props from the old
        # generation must not satisfy the new gang's membership wait.
        from dryad_tpu_torch.parallel.multihost import ControlPlane

        self.job_id = f"{self._base_job_id}-g{self._gen}"
        self._cp = ControlPlane(self.job_id, -1, mailbox=self.service.mailbox)
        self._cseq += 1  # statuses of the old namespace stay unread
        self._telemetry_state = {}  # fresh namespace, fresh cursors
        self._coord = f"{self.advertise}:{_free_port()}"
        for i in range(self.n):
            self.start_worker(i)
        return target

    def submit(
        self, query, auto_recover: bool = True
    ) -> Dict[str, np.ndarray]:
        """Pack the query, run it across the worker gang, assemble the
        result table (reference SubmitAndWait).

        ``auto_recover``: a gang member dying MID-JOB no longer fails
        the submission — the gang auto-shrinks to the survivors
        (:meth:`rebuild_gang`) and the job re-runs, up to two
        reshapes (the elastic computer-set semantics of the
        reference's scheduler)."""
        attempts = 0
        while True:
            try:
                return self._submit_gang(query)
            except (RuntimeError, TimeoutError):
                dead = {
                    i for i, h in self._handles.items()
                    if self.launcher.poll(h) is not None
                }
                if (
                    not auto_recover
                    or not dead
                    or attempts >= 2
                    or self.n - len(dead) < 1
                ):
                    raise
                attempts += 1
                self.events.emit(
                    "gang_member_lost_mid_job", dead=sorted(dead),
                    attempt=attempts,
                )
                # Forensics checkpoint: the dead worker already left
                # its own dump (or not, if it was SIGKILLed); the
                # driver's view of the fatal window must survive the
                # recovery that is about to rewrite gang state.
                flightrec.dump_now(
                    f"gang_member_lost:{','.join(map(str, sorted(dead)))}"
                )
                log.warning(
                    "gang member(s) %s died mid-job; shrinking to %d "
                    "workers and re-running", sorted(dead),
                    self.n - len(dead),
                )
                self.rebuild_gang()

    def _submit_gang(self, query) -> Dict[str, np.ndarray]:
        self._heal_gang()
        self._check_workers_alive()
        self._sync_membership()
        self._seq += 1
        seq = self._seq
        job_dir = os.path.join(self.root, self.job_id, f"r{seq}")
        os.makedirs(job_dir, exist_ok=True)
        pkg_rel = f"{self.job_id}/r{seq}/job.pkg"
        with self.tracer.span("pack", cat="driver", seq=seq):
            pack_query(query, os.path.join(self.root, pkg_rel))
        result_rel = f"{self.job_id}/r{seq}/result"

        cmd = {
            "kind": "run", "package": pkg_rel,
            "result_dir": result_rel, "seq": seq, "cseq": self._next_cseq(),
        }
        t_run0 = time.monotonic()
        self.events.emit("gang_run_start", seq=seq, workers=self.n)
        procs = []
        terminal = (
            ProcessState.COMPLETED, ProcessState.FAILED,
            ProcessState.CANCELED,
        )
        try:
            for i in range(self.n):
                p = ClusterProcess(
                    self._command_round_trip(i, cmd),
                    name=f"run{seq}-w{i}",
                    affinities=[Affinity(f"worker{i}", hard=True)],
                )
                self.scheduler.schedule(p)
                procs.append(p)
            for i, p in enumerate(procs):
                if not p.wait(self.timeout + 30.0):
                    raise TimeoutError(
                        f"worker {i} command round-trip hung"
                    )
            failed = [
                p for p in procs if p.state is not ProcessState.COMPLETED
            ]
            if failed:
                errs = "; ".join(f"{p.name}: {p.error}" for p in failed)
                raise RuntimeError(f"local job failed: {errs}")
        except BaseException:
            # a failed/auto-recovering gang run must not leak queued
            # commands into the (possibly rebuilt) gang's mailboxes
            for p in procs:
                if p.state not in terminal:
                    self.scheduler.cancel(p)
            raise
        # Gang runs are lockstep (a mid-program straggler cannot be
        # duplicated), so the duration model here SURFACES outliers for
        # the jobview diagnosis rather than acting (the stage-level half
        # of DrStageStatistics; the acting half lives in
        # submit_partitioned).  Keyed by plan structure: only repeats
        # of the same pipeline feed one model.
        from dryad_tpu_torch.plan.nodes import walk

        sig = tuple(nd.kind for nd in walk([query.node]))
        st = self._gang_stats.setdefault(sig, StageStatistics())
        dt = time.monotonic() - t_run0
        if st.is_outlier(dt):
            self.events.emit(
                "gang_straggler", seq=seq, seconds=round(dt, 3),
                threshold=round(st.outlier_threshold(), 3),
            )
        st.record(dt)
        self.events.emit(
            "gang_run_complete", seq=seq, seconds=round(dt, 3)
        )
        self._collect_telemetry()

        part_ids = sorted(
            {g for p in procs for g in p.result.get("parts", [])}
        )
        return self._assemble(query, result_rel, part_ids)

    def submit_many(self, queries, batch: Optional[int] = None) -> List[
        Dict[str, np.ndarray]
    ]:
        """Run several gang SPMD queries with BATCHED worker command
        streams: one ``runbatch`` mailbox round trip per worker
        carries up to ``batch`` run sub-commands (default: the first
        query's ``config.command_batch``; <= 1 falls back to per-query
        :meth:`submit`).  Workers execute the sub-commands
        back-to-back — the per-command start/done barriers stay
        aligned because every gang member runs the same list in the
        same order — and ship ONE aggregated status, so mailbox round
        trips per gang job drop from ``n`` to ``n / K``.  Results
        return in query order; any sub-command failure fails the batch
        with the first error (per-command classification preserved in
        the aggregated status)."""
        queries = list(queries)
        cfgs = [getattr(q.ctx, "config", None) for q in queries]
        if batch is None:
            # the gang executes ONE envelope per worker, so the most
            # conservative query governs the whole batch — reading only
            # queries[0] would silently over-batch a stricter peer
            sizes = [int(getattr(c, "command_batch", 0) or 0) for c in cfgs]
            batch = min(sizes) if sizes else 0
            if sizes and batch != max(sizes):
                self.events.emit(
                    "command_batch", worker=-1, commands=batch,
                    round_trips_saved=0, clamped_from=max(sizes),
                )
        depths = [int(getattr(c, "gang_batch_depth", 1) or 1) for c in cfgs]
        depth = min(depths) if depths else 1
        if batch <= 1 or len(queries) <= 1:
            return [self.submit(q) for q in queries]
        if depth > 1:
            return self._submit_gang_windowed(queries, batch, depth)
        out: List[Dict[str, np.ndarray]] = []
        for at in range(0, len(queries), batch):
            out.extend(self._submit_gang_batch(queries[at:at + batch]))
        return out

    def _pack_batch(self, queries) -> Tuple[List[Dict], List[str]]:
        """Pack each query of one batch; returns the run sub-commands
        (each with its own seq — the start/done barrier keys; the batch
        envelope owns the cseq echo) and the per-query result dirs."""
        subs: List[Dict] = []
        result_rels: List[str] = []
        for query in queries:
            self._seq += 1
            seq = self._seq
            os.makedirs(
                os.path.join(self.root, self.job_id, f"r{seq}"),
                exist_ok=True,
            )
            pkg_rel = f"{self.job_id}/r{seq}/job.pkg"
            with self.tracer.span("pack", cat="driver", seq=seq):
                pack_query(query, os.path.join(self.root, pkg_rel))
            result_rel = f"{self.job_id}/r{seq}/result"
            result_rels.append(result_rel)
            subs.append({
                "kind": "run", "package": pkg_rel,
                "result_dir": result_rel, "seq": seq,
            })
        return subs, result_rels

    def _record_sub_durations(self, queries, per_worker_results) -> None:
        """Fold the workers' per-sub-command wall clocks into the
        per-plan duration models.  The batch path used to smear ONE
        batch-wide dt over K plans, poisoning every model with K-1
        foreign commands' time; workers now ship each sub-command's own
        duration, and the gang sample is the max across members (a gang
        command is as slow as its slowest member)."""
        from dryad_tpu_torch.plan.nodes import walk

        for j, query in enumerate(queries):
            secs = [
                r[j].get("seconds")
                for r in per_worker_results
                if j < len(r) and r[j].get("seconds") is not None
            ]
            if not secs:
                continue
            sig = tuple(nd.kind for nd in walk([query.node]))
            st = self._gang_stats.setdefault(sig, StageStatistics())
            st.record(max(secs))

    def _submit_gang_batch(self, queries) -> List[Dict[str, np.ndarray]]:
        self._heal_gang()
        self._check_workers_alive()
        self._sync_membership()
        subs, result_rels = self._pack_batch(queries)
        seqs = [s["seq"] for s in subs]
        cmd = {"kind": "runbatch", "cmds": subs, "cseq": self._next_cseq()}
        t_run0 = time.monotonic()
        self.events.emit("gang_run_start", seq=seqs[0], workers=self.n)
        for i in range(self.n):
            self.events.emit(
                "command_batch", worker=i, commands=len(subs),
                round_trips_saved=len(subs) - 1, seqs=seqs,
            )
        procs = []
        terminal = (
            ProcessState.COMPLETED, ProcessState.FAILED,
            ProcessState.CANCELED,
        )
        try:
            for i in range(self.n):
                p = ClusterProcess(
                    self._command_round_trip(i, cmd),
                    name=f"runbatch{seqs[0]}-w{i}",
                    affinities=[Affinity(f"worker{i}", hard=True)],
                )
                self.scheduler.schedule(p)
                procs.append(p)
            for i, p in enumerate(procs):
                if not p.wait(self.timeout + 30.0):
                    raise TimeoutError(
                        f"worker {i} batch command round-trip hung"
                    )
            failed = [
                p for p in procs if p.state is not ProcessState.COMPLETED
            ]
            if failed:
                errs = "; ".join(f"{p.name}: {p.error}" for p in failed)
                raise RuntimeError(f"local job failed: {errs}")
        except BaseException:
            for p in procs:
                if p.state not in terminal:
                    self.scheduler.cancel(p)
            raise
        dt = time.monotonic() - t_run0
        self.events.emit(
            "gang_run_complete", seq=seqs[0], seconds=round(dt, 3)
        )
        self._collect_telemetry()
        self._record_sub_durations(
            queries, [p.result.get("results") or [] for p in procs]
        )
        out: List[Dict[str, np.ndarray]] = []
        for j, (query, result_rel) in enumerate(zip(queries, result_rels)):
            part_ids: set = set()
            for p in procs:
                sub_sts = p.result.get("results") or []
                if j < len(sub_sts):
                    part_ids.update(sub_sts[j].get("parts") or [])
            out.append(self._assemble(query, result_rel, sorted(part_ids)))
        return out

    def _submit_gang_windowed(
        self, queries, batch: int, depth: int
    ) -> List[Dict[str, np.ndarray]]:
        """Overlapped command streams: keep up to ``depth`` runbatch
        envelopes in flight per worker (``config.gang_batch_depth``).
        The driver thread only FEEDS — it packs each batch, posts its
        envelope to every worker's command mailbox, and hands the
        blocking status drain to the :class:`GangDispatchWindow`
        collector — so the gang starts batch k+1 the moment it finishes
        batch k instead of idling through a driver round trip.

        Two distinct keys make the overlap safe on a latest-value
        mailbox: each envelope posts its status to its OWN per-envelope
        key (``wstatus/<i>/c<cseq>``), and the worker ACKS the dequeue
        itself (``ack/<i>/c<cseq>``) so the feed never overwrites the
        shared ``cmd/<i>`` slot while an unread envelope sits in it.
        Results commit strictly in submit order; a batch with failed
        sub-commands re-runs those queries SERIALLY at its commit
        position (fresh seqs — consumed barrier keys are never reused),
        so the output is byte-identical to the depth-1 serial loop."""
        from dryad_tpu_torch.cluster.gangwindow import GangDispatchWindow

        mb = self.service.mailbox
        self._heal_gang()
        self._check_workers_alive()
        self._sync_membership()
        chunks = [
            queries[at:at + batch] for at in range(0, len(queries), batch)
        ]
        results: List[Optional[List[Dict[str, np.ndarray]]]] = (
            [None] * len(chunks)
        )
        posted = [0] * self.n
        statused = [0] * self.n
        # (job id, key) of each worker's last envelope: a rebuild's fresh
        # namespace leaves the old generation's acks unread
        last_ack: List[Optional[Tuple[str, str]]] = [None] * self.n
        # tag -> (job id, cseq, status keys) of each posted envelope
        envelopes: Dict[int, Tuple[str, int, List[str]]] = {}

        def await_acks() -> None:
            for i, ack in enumerate(last_ack):
                if ack is not None and ack[0] == self.job_id:
                    await_ack(i, ack[1])

        def await_ack(i: int, key: str) -> None:
            deadline = time.monotonic() + self.timeout
            while True:
                if mb.get_prop(self.job_id, key, 0, timeout=0.5) is not None:
                    return
                self._check_workers_alive()
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"worker {i}: envelope never dequeued "
                        f"(no ack on {key}); log tail:\n"
                        + self._worker_log_tail(i)
                    )

        def await_status(i: int, jid: str, skey: str, cseq: int, deadline) -> Dict:
            while True:
                got = mb.get_prop(jid, skey, 0, timeout=1.0)
                if got is not None:
                    st = json.loads(got[1])
                    if st.get("cseq") == cseq:
                        self._note_gang_status(st)
                        return st
                self._check_workers_alive()
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"worker {i}: no windowed status after "
                        f"{self.timeout}s; log tail:\n"
                        + self._worker_log_tail(i)
                    )

        def commit(tag, value, error, win) -> None:
            """Consume one drained batch at its commit position (submit
            order): surface drain-site errors, re-run failed queries
            serially, record durations, assemble."""
            if error is not None:
                raise error
            chunk, sts = value["chunk"], value["statuses"]
            per_worker = [st.get("results") or [] for st in sts]
            self.events.emit(
                "gang_run_complete", seq=value["seqs"][0],
                seconds=round(time.monotonic() - value["t_post"], 3),
            )
            self._collect_telemetry()
            self._record_sub_durations(chunk, per_worker)
            out: List[Dict[str, np.ndarray]] = []
            for j, query in enumerate(chunk):
                failed = any(
                    j < len(r) and r[j].get("state") != "completed"
                    for r in per_worker
                ) or any(j >= len(r) for r in per_worker)
                if failed:
                    win.note_retry()
                    if self._gang_out_of_step:
                        # the re-run rebuilds the gang: every later
                        # envelope still runs on the old one (each fails
                        # fast there), so wait for their statuses first
                        deadline = time.monotonic() + self.timeout
                        for t in sorted(envelopes):
                            jid, c, skeys = envelopes[t]
                            if t > tag and jid == self.job_id:
                                for i, skey in enumerate(skeys):
                                    await_status(i, jid, skey, c, deadline)
                    # the shared cmd slot may still hold a later unread
                    # envelope — wait for its dequeue ack before the
                    # serial re-run posts into the same slot
                    await_acks()
                    out.append(self.submit(query, auto_recover=False))
                    continue
                part_ids: set = set()
                for r in per_worker:
                    part_ids.update(r[j].get("parts") or [])
                out.append(
                    self._assemble(
                        query, value["result_rels"][j], sorted(part_ids)
                    )
                )
            results[tag] = out

        win = GangDispatchWindow(
            depth, events=self.events, name="submit_many"
        )
        try:
            for k, chunk in enumerate(chunks):
                subs, result_rels = self._pack_batch(chunk)
                seqs = [s["seq"] for s in subs]
                cseq = self._next_cseq()
                self.events.emit(
                    "gang_run_start", seq=seqs[0], workers=self.n
                )
                t_post = time.monotonic()
                skeys: List[str] = []
                jid = self.job_id
                for i in range(self.n):
                    self.events.emit(
                        "command_batch", worker=i, commands=len(subs),
                        round_trips_saved=len(subs) - 1, seqs=seqs,
                    )
                    if last_ack[i] is not None and last_ack[i][0] == jid:
                        await_ack(i, last_ack[i][1])
                    ack = f"ack/{i}/c{cseq}"
                    skey = f"wstatus/{i}/c{cseq}"
                    env = self._stamp_trace({
                        "kind": "runbatch", "cmds": subs, "cseq": cseq,
                        "ack": ack, "skey": skey,
                    })
                    self.round_trips += 1
                    mb.set_prop(jid, f"cmd/{i}", json.dumps(env).encode())
                    last_ack[i] = (jid, ack)
                    posted[i] += 1
                    win.note_in_flight(posted[i] - statused[i])
                    skeys.append(skey)
                envelopes[k] = (jid, cseq, skeys)

                def drain(cseq=cseq, skeys=skeys, chunk=chunk,
                          result_rels=result_rels, seqs=seqs,
                          t_post=t_post, jid=jid) -> Dict:
                    deadline = time.monotonic() + self.timeout
                    sts = []
                    for i, skey in enumerate(skeys):
                        sts.append(await_status(i, jid, skey, cseq, deadline))
                        statused[i] += 1
                    return {
                        "statuses": sts, "chunk": chunk,
                        "result_rels": result_rels, "seqs": seqs,
                        "t_post": t_post,
                    }

                win.submit(k, drain)
                for tag, value, error in win.ready():
                    commit(tag, value, error, win)
            for tag, value, error in win.drain():
                commit(tag, value, error, win)
        finally:
            win.close(workers=self.n)
        out: List[Dict[str, np.ndarray]] = []
        for res in results:
            out.extend(res or [])
        return out

    def _collect_telemetry(self) -> int:
        """Absorb worker span/counter batches into the driver's event
        log (clock-offset corrected) — the cluster-wide trace merge.
        Best-effort: a telemetry hiccup must never fail a job that
        already completed.  Also the shared-quarantine exchange point:
        the driver ships its scheduler's local failure deltas through
        the same channel and folds any peer driver's deltas into its
        own blacklist (multihost quarantine, ``obs.gang``)."""
        try:
            from dryad_tpu_torch.obs.gang import ship_failure_deltas

            ship_failure_deltas(self._cp, self.scheduler, self.events)
            n = self._cp.drain_telemetry(
                self.n, self._telemetry_state, self.events,
                scheduler=self.scheduler,
            )
            # Stash the drain's min-RTT clock offsets in the flight
            # recorder so a post-mortem merge of the blackbox dumps can
            # apply the same correction live telemetry got.
            rec = flightrec.get_recorder()
            if rec is not None:
                rec.set_info(worker_offsets={
                    i: st.get("off")
                    for i, st in self._telemetry_state.items()
                    if st.get("off") is not None
                })
            return n
        except Exception as e:  # noqa: BLE001 — observability only
            log.warning("worker telemetry drain failed: %s", e)
            return 0

    # -- independent vertex tasks with speculative duplication ---------------
    _PARTITIONED_OPS = frozenset(
        {"select", "where", "project", "select_many", "resize"}
    )

    def submit_partitioned(
        self,
        query,
        nparts: Optional[int] = None,
        speculation: bool = True,
        coded: Optional[bool] = None,
    ) -> Dict[str, np.ndarray]:
        """Run a partition-local plan as ``nparts`` INDEPENDENT vertex
        tasks — the reference's execution model (one re-executable
        vertex per partition, ``DrVertex.h:49``), with **speculative
        duplication**: completed-task durations feed the robust stage
        model (``exec.stats``, ``DrStageStatistics.cpp:93``), and a
        task running past the outlier threshold is duplicated onto the
        least-loaded idle worker, first completion wins, the loser is
        canceled (``DrVertex.cpp:444`` RequestDuplicate,
        ``DrStageManager.h:156`` CheckForDuplicates).

        Exchange-free plans qualify directly (each vertex sees one
        input partition; the union of outputs is the job output).  A
        plan whose TERMINAL node is a builtin-agg ``group_by`` or a
        scalar aggregate also qualifies: it is split into per-vertex
        partial reduction plus a driver-side final merge — the
        reference's machine-level partial-aggregation vertices
        (``DrDynamicAggregateManager.h:35-168``), so speculation and
        re-execution cover real aggregation work.  A join or
        ``order_by`` over host inputs qualifies by driver-side routing.
        Other shuffling plans are refused with a message naming
        :meth:`submit` (the gang program across processes).

        **Coded redundancy** (``dryad_tpu_torch.redundancy``): when the
        terminal partial's combiner is LINEAR (sum/count/mean, or a
        ``Decomposable(linear=True)``), the job runs as k systematic +
        r parity CODED vertices instead — any k of the k+r completions
        reconstruct the stage output (exactly for integer
        accumulators), so a straggler needs no identification and a
        killed vertex no re-execution.  ``coded=None`` follows
        ``config.coded_redundancy``; True forces it (raising if the
        plan is ineligible); False keeps the duplicate path.
        """
        from dryad_tpu_torch.cluster.interfaces import ProcessState as PS
        from dryad_tpu_torch.plan.lower import lower

        self._reap_dead_workers()
        self._sync_membership(gang=False)
        rewrite = self._rewrite_partial_group(query)
        if rewrite is not None:
            run_query, merge, gate_node = rewrite
        else:
            run_query, merge, gate_node = query, None, query.node
        # The gate checks what vertices actually run per-partition: for
        # a rewritten plan, the pre-group slice (the group tail is
        # partition-local by construction — its exchange is identity on
        # the one-device vertex mesh).
        graph = lower([gate_node], query.ctx.config, query.ctx.dictionary)
        overrides = None
        bad_all = [
            op.kind
            for st in graph.stages
            for op in st.ops
            if op.kind not in self._PARTITIONED_OPS
        ]
        if bad_all:
            # routed slices order by key hash, not engine order — a
            # terminal partial merge containing "first" would return a
            # hash-assignment-dependent value (the r4 guard's exact
            # failure mode), so such plans keep the gang path
            if merge is not None and any(
                op == "first" for _o, op, _p in merge[2]
            ):
                raise ValueError(
                    "partitioned submission cannot route a plan whose "
                    "terminal aggregate uses 'first' (routing reorders "
                    "rows, making 'first' nparts-dependent) — use "
                    "submit()"
                )
            # shuffle-bearing plan: qualify anyway when the driver can
            # make its exchanges partition-local by ROUTING the host
            # inputs (co-partitioned join sides; range-routed sort) —
            # the reference speculates every vertex kind
            # (DrStageManager.h:156, DrVertex.cpp:444), so joins and
            # sorts must run as duplicable vertex tasks too.
            nparts = nparts or self._auto_fanout(query)
            overrides = self._route_for_vertices(gate_node, query.ctx,
                                                 nparts)
            if overrides is None:
                raise ValueError(
                    f"partitioned submission requires an exchange-free "
                    f"plan, a terminal builtin-agg group_by/aggregate "
                    f"partial, or a driver-routable join/order_by over "
                    f"host inputs; plan contains {sorted(set(bad_all))} "
                    f"— use submit()"
                )
            self.events.emit(
                "vertex_routed", plan_kind=overrides[0],
                nparts=nparts, inputs=sorted(overrides[1]),
            )
            overrides = overrides[1]
        query = run_query
        nparts = nparts or self._auto_fanout(query)
        if merge is not None and overrides is None:
            from dryad_tpu_torch.redundancy import policy as coded_policy

            decision = coded_policy.decide(
                query, merge, query.ctx.config, nparts, requested=coded,
            )
            if decision.apply:
                return self._submit_coded(query, merge, nparts, decision)
            if coded is True:
                raise ValueError(
                    f"coded submission requested but the plan is "
                    f"ineligible: {decision.reason}"
                )
            if coded is None and query.ctx.config.coded_redundancy:
                self.events.emit(
                    "coded_fallback", reason=decision.reason,
                )
        elif coded is True:
            raise ValueError(
                "coded submission requires a terminal linear partial "
                "aggregation over unrouted inputs — use coded=None/False"
            )
        self._seq += 1
        seq = self._seq
        job_dir = os.path.join(self.root, self.job_id, f"r{seq}")
        os.makedirs(job_dir, exist_ok=True)
        pkg_rel = f"{self.job_id}/r{seq}/job.pkg"
        self._register_strings(query)
        pack_query(
            query, os.path.join(self.root, pkg_rel),
            binding_overrides=overrides,
        )
        result_rel = f"{self.job_id}/r{seq}/result"
        self.events.emit(
            "vertex_job_start", seq=seq, nparts=nparts,
            speculation=speculation,
        )

        stats = StageStatistics()
        run_t0: Dict[int, float] = {}  # ClusterProcess.id -> RUNNING ts

        cache_bytes = int(
            getattr(query.ctx.config, "gang_partition_cache_bytes", 0) or 0
        )

        def make_proc(part: int, attempt: int) -> ClusterProcess:
            cmd = {
                "kind": "runpart", "package": pkg_rel, "part": part,
                "nparts": nparts, "result_dir": result_rel, "seq": seq,
                "cseq": self._next_cseq(), "cache_bytes": cache_bytes,
            }
            # Primaries spread round-robin as a soft preference;
            # duplicates go wherever a slot is free first.
            affs = (
                [Affinity(f"worker{part % self.n}")] if attempt == 0 else []
            )
            p = ClusterProcess(
                self._placed_round_trip(cmd),
                name=f"part{part}-a{attempt}", affinities=affs,
            )

            def watch(pr: ClusterProcess) -> None:
                if pr.state is PS.RUNNING:
                    run_t0[pr.id] = time.monotonic()

            p.on_state(watch)
            return p

        terminal = (PS.COMPLETED, PS.FAILED, PS.CANCELED)
        tasks: Dict[int, Dict] = {}
        winners: Dict[int, int] = {}  # part -> worker that completed it
        part_fps: Dict[int, str] = {}  # part -> content fp (cache key)
        for part in range(nparts):
            p = make_proc(part, 0)
            tasks[part] = {
                "procs": [p], "dup": False,
                # failure-domain bookkeeping: Attempt history, proc ids
                # already folded into it, and the backoff gate for the
                # next re-execution (None = no retry pending)
                "attempts": [], "seen": set(), "retry_at": None,
            }
            self.scheduler.schedule(p)

        pending = set(range(nparts))
        # nparts tasks over n worker slots run in ceil(nparts/n)
        # sequential waves; every wave gets the per-command budget.
        waves = -(-nparts // max(self.n, 1))
        deadline = time.monotonic() + self.timeout * waves + 30.0
        # versioned re-execution budget (DrVertexRecord) + exponential
        # backoff with seeded jitter between transient re-executions
        policy = RetryPolicy(max_attempts=3)
        max_attempts = policy.max_attempts
        try:
            while pending:
                self._reap_dead_workers()
                for part in sorted(pending):
                    t = tasks[part]
                    winner = next(
                        (p for p in t["procs"] if p.state is PS.COMPLETED),
                        None,
                    )
                    if winner is not None:
                        dur = time.monotonic() - run_t0.get(
                            winner.id, time.monotonic()
                        )
                        stats.record(dur)
                        if winner.computer:
                            winners[part] = int(
                                winner.computer.removeprefix("worker")
                            )
                        wfp = (winner.result or {}).get("fp")
                        if wfp:
                            part_fps[part] = wfp
                        for p in t["procs"]:
                            if p is not winner and p.state not in terminal:
                                self.scheduler.cancel(p)
                                self.events.emit(
                                    "vertex_duplicate_cancel", part=part,
                                    loser=p.computer or "queued",
                                )
                        if t["dup"]:
                            self.events.emit(
                                "vertex_duplicate_win", part=part,
                                winner=winner.computer, seconds=dur,
                            )
                        self.events.emit(
                            "vertex_complete", part=part, seconds=dur,
                            computer=winner.computer,
                        )
                        pending.discard(part)
                        continue
                    if t["procs"] and all(
                        p.state in (PS.FAILED, PS.CANCELED)
                        for p in t["procs"]
                    ):
                        # Independent re-executable vertex: a TRANSIENT
                        # failure re-runs (on a surviving worker, after
                        # a seeded backoff) up to the version budget
                        # (DrVertex.cpp:531 InstantiateVersion; failure
                        # budget DrGraph.h:42).  A DETERMINISTIC repeat
                        # — same exception class+message on a different
                        # computer — fails fast with the history.
                        if t["retry_at"] is not None:
                            if time.monotonic() >= t["retry_at"]:
                                t["retry_at"] = None
                                np_ = make_proc(part, len(t["procs"]))
                                t["procs"].append(np_)
                                self.scheduler.schedule(np_)
                            continue
                        for p in t["procs"]:
                            if (
                                p.state is PS.FAILED
                                and p.error is not None
                                and p.id not in t["seen"]
                            ):
                                t["seen"].add(p.id)
                                kind = classify(
                                    p.error, t["attempts"],
                                    computer=p.computer,
                                )
                                t["attempts"].append(Attempt(
                                    number=len(t["attempts"]) + 1,
                                    error_type=type(p.error).__name__,
                                    error=str(p.error),
                                    kind=kind.value,
                                    computer=p.computer,
                                ))
                        attempts = t["attempts"]
                        deterministic = bool(attempts) and (
                            attempts[-1].kind
                            == FailureKind.DETERMINISTIC.value
                        )
                        if deterministic or len(t["procs"]) >= max_attempts:
                            self.events.emit(
                                "vertex_job_failed", part=part,
                                failure_kind=(
                                    attempts[-1].kind if attempts
                                    else FailureKind.TRANSIENT.value
                                ),
                            )
                            why = (
                                "failed deterministically (identical "
                                "error on different computers; retrying "
                                "cannot help)"
                                if deterministic
                                and len(t["procs"]) < max_attempts
                                else f"failed on all {len(t['procs'])} "
                                "attempts"
                            )
                            errs = "; ".join(
                                str(p.error) for p in t["procs"] if p.error
                            )
                            raise JobFailedError(
                                f"vertex task {part} {why}: {errs}",
                                stage=f"part{part}", attempts=attempts,
                            )
                        backoff = policy.backoff(
                            f"part{part}", len(attempts) or 1
                        )
                        if attempts:
                            attempts[-1].backoff = backoff
                        t["retry_at"] = time.monotonic() + backoff
                        last = attempts[-1] if attempts else None
                        self.events.emit(
                            "vertex_retry", part=part,
                            attempt=len(t["procs"]) + 1,
                            backoff=round(backoff, 4),
                            computer=last.computer if last else None,
                            error=last.error if last else None,
                            failure_kind=(
                                last.kind if last
                                else FailureKind.TRANSIENT.value
                            ),
                        )
                    # Speculation: a RUNNING attempt past the outlier
                    # threshold gets one duplicate (CheckForDuplicates).
                    thr = stats.outlier_threshold()
                    if speculation and not t["dup"] and thr is not None:
                        running = [
                            p for p in t["procs"]
                            if p.state is PS.RUNNING and p.id in run_t0
                        ]
                        if running and any(
                            time.monotonic() - run_t0[p.id] > thr
                            for p in running
                        ):
                            t["dup"] = True
                            dp = make_proc(part, 1)
                            t["procs"].append(dp)
                            self.scheduler.schedule(dp)
                            self.events.emit(
                                "vertex_duplicate", part=part,
                                threshold=round(thr, 4),
                                elapsed=round(
                                    max(
                                        time.monotonic() - run_t0[p.id]
                                        for p in running
                                    ), 4,
                                ),
                            )
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"vertex job timed out with parts "
                        f"{sorted(pending)} outstanding"
                    )
                if pending:
                    time.sleep(0.05)
        finally:
            # Never leak attempts: a queued proc dispatched later would
            # clobber the worker's cmd mailbox slot (latest-value
            # semantics) and poison the next submission.
            for t in tasks.values():
                for p in t["procs"]:
                    if p.state not in terminal:
                        self.scheduler.cancel(p)
        self.events.emit("vertex_job_complete", seq=seq)
        self._collect_telemetry()
        part_rows: List[int] = []
        table = None
        snaps = None
        if (
            merge is not None
            and merge[0] == "group"
            and bool(getattr(query.ctx.config, "gang_combine_tree", False))
            and not any(op == "first" for _o, op, _p in merge[2])
        ):
            # level -1: winners pre-merge their own parts worker-side;
            # None (a worker died or refused) falls back to the flat
            # assembly below — the part files are durable on the job
            # root, so the pre-merge is an optimization, never a
            # correctness dependency
            pre = self._worker_combine(
                query, pkg_rel, result_rel, nparts, winners, part_fps,
                merge,
            )
            if pre is not None:
                table, part_rows, snaps = pre
        if table is None:
            table = self._assemble(
                query, result_rel, list(range(nparts)),
                dictionary=query.ctx.dictionary, part_rows=part_rows,
            )
        if merge is not None:
            table = self._merge_partials(
                table, merge, part_rows=part_rows,
                config=query.ctx.config, snaps=snaps,
            )
            self.events.emit(
                "vertex_partials_merged", seq=seq,
                rows=len(next(iter(table.values()), [])),
            )
        return table

    def _worker_combine(
        self, query, pkg_rel: str, result_rel: str, nparts: int,
        winners: Dict[int, int], part_fps: Dict[int, str], merge,
    ):
        """Level -1 of the combine tree (``config.gang_combine_tree``):
        each winner worker folds the un-finalized partial state of the
        parts IT completed into one ``wpart<w>.dpf``
        (``cluster.worker._combine_parts``) and ships a key-range
        snapshot, so the driver fetches one partial per WORKER instead
        of one per VERTEX — ingress drops by the per-worker fan-in and
        the existing level-0/1 driver tree starts from pre-merged
        segments.  Returns ``(table, part_rows, snaps)`` with the
        decoded premerged segments (string keys looked up from the
        driver dictionary — wparts carry raw Hash64 codes), or ``None``
        when any worker's combine fails, where the caller assembles the
        original parts flat (byte-identical either way)."""
        from dryad_tpu_torch.columnar.schema import ColumnType
        from dryad_tpu_torch.exec.partial import state_reductions

        _kind, keys, plan, _out_schema = merge
        by_worker: Dict[int, List[int]] = {}
        for part in range(nparts):
            w = winners.get(part)
            if w is None:
                return None  # owner unknown — keep the flat path
            by_worker.setdefault(w, []).append(part)
        self._reap_dead_workers()
        wids = sorted(by_worker)
        if not wids or any(w in self._dead for w in wids):
            return None
        config = query.ctx.config
        red = state_reductions(plan)
        ranges = int(getattr(config, "combine_tree_ranges", 64))
        cache_bytes = int(
            getattr(config, "gang_partition_cache_bytes", 0) or 0
        )
        terminal = (
            ProcessState.COMPLETED, ProcessState.FAILED,
            ProcessState.CANCELED,
        )
        procs = []
        for widx, w in enumerate(wids):
            cmd = self._stamp_trace({
                "kind": "combineparts", "package": pkg_rel,
                "result_dir": result_rel,
                "parts": [
                    {"part": p, "fp": part_fps.get(p)}
                    for p in by_worker[w]
                ],
                "keys": list(keys), "red": red, "ranges": ranges,
                "wid": widx, "cache_bytes": cache_bytes,
                "cseq": self._next_cseq(),
            })

            def fn(proc: ClusterProcess, i=w, cmd=cmd) -> Dict:
                # per-worker watch (gang=False): an unrelated death
                # must not poison every winner's combine
                return self._round_trip_body(i, cmd, proc, gang=False)

            p = ClusterProcess(
                fn, name=f"combine-w{w}",
                affinities=[Affinity(f"worker{w}", hard=True)],
            )
            self.scheduler.schedule(p)
            procs.append(p)
        statuses = []
        ok = True
        for p in procs:
            if not p.wait(self.timeout + 30.0):
                ok = False
                break
            if p.state is not ProcessState.COMPLETED:
                ok = False
                break
            statuses.append(p.result)
        if not ok:
            for p in procs:
                if p.state not in terminal:
                    self.scheduler.cancel(p)
            log.warning(
                "worker-side combine failed (%s); falling back to flat "
                "assembly — part files are durable",
                "; ".join(
                    f"{p.name}: {p.error}" for p in procs if p.error
                ) or "timeout",
            )
            return None
        # premerged assembly: wparts hold LOGICAL columns already (the
        # worker decoded before folding), so this is lookup +
        # pass-through, not the physical decode
        w0, r0 = self._client.wire_bytes, self._client.raw_bytes
        tables = []
        part_rows: List[int] = []
        snaps: List[Dict] = []
        with self.tracer.span(
            "assemble", cat="driver", parts=len(statuses)
        ):
            for st in statuses:
                host = parse_partition_bytes(
                    self._client.read_whole_file(
                        f"{result_rel}/{st['wfile']}", compress=True
                    )
                )
                tbl: Dict[str, np.ndarray] = {}
                for f in query.schema.fields:
                    if f.name not in host:
                        continue
                    col = np.asarray(host[f.name])
                    if f.ctype is ColumnType.STRING:
                        col = np.array(
                            query.ctx.dictionary.lookup_all(
                                col.astype(np.uint64)
                            ),
                            dtype=object,
                        )
                    tbl[f.name] = col
                tables.append(tbl)
                part_rows.append(len(next(iter(tbl.values()), [])))
                snaps.append(st.get("snapshot"))
        self.events.emit(
            "assemble_fetch", parts=len(statuses),
            wire_bytes=self._client.wire_bytes - w0,
            raw_bytes=self._client.raw_bytes - r0,
        )
        for widx, st in enumerate(statuses):
            self.events.emit(
                "gang_partial_combine", worker=wids[widx],
                parts=len(st.get("parts") or []),
                rows=int(st.get("rows", 0)),
                in_rows=int(st.get("in_rows", 0)),
                read_bytes=int(st.get("read_bytes", 0)),
                cache_hits=int(st.get("cache_hits", 0)),
                cache_misses=int(st.get("cache_misses", 0)),
                bytes=int(st.get("bytes", 0)),
            )
            self.events.emit(
                "combine_tree_level", level=-1, group=widx,
                fan_in=len(st.get("parts") or []),
                cap_rows=int(st.get("rows", 0)),
                bytes=int(st.get("bytes", 0)),
                ici_bytes=0, dcn_bytes=0, device=False,
            )
        table = {
            c: np.concatenate([t[c] for t in tables]) for c in tables[0]
        }
        return table, part_rows, snaps

    # -- coded k-of-n vertex execution (dryad_tpu_torch.redundancy) ----------------
    def _submit_coded(self, query, merge, nparts, decision):
        """Run a qualifying partial aggregation as k systematic + r
        parity CODED vertices (``redundancy.coding``): ANY k of the
        k + r coded completions reconstruct the merged stage output
        (``redundancy.reconstruct`` — bit-exact for integer
        accumulators), so

        - spares launch on the coarse floor trigger
          (``exec.stats.spare_threshold``) — coding needs no straggler
          IDENTIFICATION, only a suspicion that up to r vertices are
          slow — and immediately on the first vertex failure (failure
          masking with zero re-executions);
        - at k completions the rest are canceled and completed-but-
          unused coded output is accounted as ``coded_waste_bytes``;
        - a coded vertex is relaunched ONLY if failures make k
          completions impossible (fewer than k live+done vertices) —
          the bounded fallback to re-execution semantics.
        """
        from dryad_tpu_torch.cluster.interfaces import ProcessState as PS
        from dryad_tpu_torch.redundancy.coding import CodedSpec
        from dryad_tpu_torch.redundancy.reconstruct import merge_coded

        cfg = query.ctx.config
        spec = CodedSpec(int(nparts), int(decision.r))
        self._seq += 1
        seq = self._seq
        os.makedirs(
            os.path.join(self.root, self.job_id, f"r{seq}"), exist_ok=True
        )
        pkg_rel = f"{self.job_id}/r{seq}/job.pkg"
        self._register_strings(query)
        pack_query(query, os.path.join(self.root, pkg_rel))
        result_rel = f"{self.job_id}/r{seq}/result"
        self.events.emit(
            "coded_job_start", seq=seq, k=spec.k, n=spec.n, r=spec.r,
            agg=decision.kind,
        )
        t_job0 = time.monotonic()
        stats = StageStatistics(floor_ratio=cfg.straggler_floor_ratio)
        # Diagnosis-driven pre-seeding: the engine's "coded" duration
        # model accumulated coded_task_complete times from PRIOR
        # submissions, so spare_threshold() is armed from t=0 of this
        # job — a straggler can trigger parity before this job records
        # a single completion (and before any failure).
        for d in self.diagnosis.stats_for("coded").durations:
            stats.record(d)
        run_t0: Dict[int, float] = {}
        retry_policy = RetryPolicy(
            backoff_base=cfg.retry_backoff_base,
            backoff_max=cfg.retry_backoff_max,
            jitter=cfg.retry_jitter, seed=cfg.retry_seed,
        )

        def make_proc(j: int, attempt: int) -> ClusterProcess:
            cmd = {
                "kind": "runcoded", "package": pkg_rel, "coded": j,
                "parts": spec.support(j), "coeffs": spec.coeffs(j),
                "nparts": spec.k, "keys": list(decision.key_cols),
                "state": list(decision.state_cols),
                "result_dir": result_rel, "seq": seq,
                "cseq": self._next_cseq(),
            }
            affs = (
                [Affinity(f"worker{j % self.n}")]
                if not spec.is_parity(j) and attempt == 0 else []
            )
            p = ClusterProcess(
                self._placed_round_trip(cmd),
                name=f"coded{seq}-c{j}-a{attempt}", affinities=affs,
            )

            def watch(pr: ClusterProcess) -> None:
                if pr.state is PS.RUNNING:
                    run_t0[pr.id] = time.monotonic()

            p.on_state(watch)
            return p

        terminal = (PS.COMPLETED, PS.FAILED, PS.CANCELED)
        tasks: Dict[int, Dict] = {}
        for j in range(spec.k):
            tasks[j] = {
                "procs": [make_proc(j, 0)], "attempts": [], "seen": set(),
                "retry_at": None,
            }
        self.scheduler.schedule_batch([tasks[j]["procs"][0]
                                       for j in range(spec.k)])
        completed: Dict[int, ClusterProcess] = {}
        parity_launched = False
        # parity support spans all k shards, so budget parity waves at
        # full-stage cost on top of the systematic waves
        waves = -(-spec.n // max(self.n, 1)) + 1
        deadline = time.monotonic() + self.timeout * waves + 30.0

        def all_failed(t) -> bool:
            return bool(t["procs"]) and all(
                p.state in (PS.FAILED, PS.CANCELED) for p in t["procs"]
            )

        def launch_parity(trigger: str, threshold) -> None:
            nonlocal parity_launched
            parity_launched = True
            spares = []
            for j in range(spec.k, spec.n):
                tasks[j] = {
                    "procs": [make_proc(j, 0)], "attempts": [],
                    "seen": set(), "retry_at": None,
                }
                spares.append(tasks[j]["procs"][0])
            self.scheduler.schedule_batch(spares)
            self.events.emit(
                "coded_launch", seq=seq, k=spec.k, n=spec.n, r=spec.r,
                trigger=trigger,
                threshold=round(threshold, 4) if threshold else None,
            )

        try:
            while len(completed) < spec.k:
                self._reap_dead_workers()
                now = time.monotonic()
                for j in sorted(tasks):
                    t = tasks[j]
                    if j in completed:
                        continue
                    winner = next(
                        (p for p in t["procs"] if p.state is PS.COMPLETED),
                        None,
                    )
                    if winner is not None:
                        dur = now - run_t0.get(winner.id, now)
                        stats.record(dur)
                        completed[j] = winner
                        self.events.emit(
                            "coded_task_complete", seq=seq, coded=j,
                            parity=spec.is_parity(j),
                            seconds=round(dur, 4),
                            computer=winner.computer,
                        )
                        continue
                    if all_failed(t):
                        for p in t["procs"]:
                            if (
                                p.state is PS.FAILED
                                and p.error is not None
                                and p.id not in t["seen"]
                            ):
                                t["seen"].add(p.id)
                                kind = classify(
                                    p.error, t["attempts"],
                                    computer=p.computer,
                                )
                                t["attempts"].append(Attempt(
                                    number=len(t["attempts"]) + 1,
                                    error_type=type(p.error).__name__,
                                    error=str(p.error), kind=kind.value,
                                    computer=p.computer,
                                ))
                                self.events.emit(
                                    "coded_task_failed", seq=seq,
                                    coded=j, parity=spec.is_parity(j),
                                    error=str(p.error)[:200],
                                    failure_kind=kind.value,
                                )
                # failure masking: the FIRST failure launches all r
                # spares at once — parity covers ANY r losses, so
                # there is nothing to target
                failed_now = [j for j, t in tasks.items()
                              if j not in completed and all_failed(t)]
                if failed_now and not parity_launched:
                    launch_parity("failure", None)
                # straggler masking: the coarse spare trigger (no
                # per-task identification needed — see spare_threshold)
                if not parity_launched:
                    thr = stats.spare_threshold()
                    slow = None
                    if thr is not None:
                        slow = next(
                            (
                                (j, now - run_t0[p.id])
                                for j, t in tasks.items()
                                if j not in completed
                                for p in t["procs"]
                                if p.state is PS.RUNNING
                                and p.id in run_t0
                                and now - run_t0[p.id] > thr
                            ),
                            None,
                        )
                    if slow is not None:
                        # diagnose FIRST so the `diagnosis` event
                        # precedes the coded_launch it is driving
                        self.diagnosis.note_inflight(
                            "coded", slow[1], subject=f"coded{slow[0]}"
                        )
                        launch_parity("straggler", thr)
                # coverage shortfall: relaunch dead vertices only when
                # k completions are otherwise impossible
                live = sum(
                    1 for j, t in tasks.items()
                    if j not in completed and not all_failed(t)
                )
                shortfall = spec.k - len(completed) - live
                if shortfall > 0:
                    for j in failed_now:
                        if shortfall <= 0:
                            break
                        t = tasks[j]
                        if len(t["procs"]) >= retry_policy.max_attempts:
                            errs = "; ".join(
                                str(p.error)
                                for p in t["procs"] if p.error
                            )
                            raise JobFailedError(
                                f"coded vertex {j} failed on all "
                                f"{len(t['procs'])} attempts and the "
                                f"remaining coded vertices cannot reach "
                                f"k={spec.k} completions: {errs}",
                                stage=f"coded{j}", attempts=t["attempts"],
                            )
                        if t["retry_at"] is None:
                            t["retry_at"] = now + retry_policy.backoff(
                                f"coded{j}", len(t["attempts"]) or 1
                            )
                        if now >= t["retry_at"]:
                            t["retry_at"] = None
                            np_ = make_proc(j, len(t["procs"]))
                            t["procs"].append(np_)
                            self.scheduler.schedule(np_)
                            shortfall -= 1
                            self.events.emit(
                                "coded_retry", seq=seq, coded=j,
                                attempt=len(t["procs"]),
                            )
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"coded job timed out with "
                        f"{len(completed)}/{spec.k} completions"
                    )
                if len(completed) < spec.k:
                    time.sleep(0.05)
        finally:
            canceled = 0
            for t in tasks.values():
                for p in t["procs"]:
                    if p.state not in terminal:
                        self.scheduler.cancel(p)
                        canceled += 1
            if canceled:
                self.events.emit(
                    "coded_cancel", seq=seq, canceled=canceled,
                )
        # prefer systematic rows among the completions (identity
        # weights decode fastest and keep float paths exact); the
        # result is subset-independent for integer states anyway
        used = sorted(completed)[: spec.k]
        waste = 0
        unused = []
        for j in sorted(tasks):
            if j in used:
                continue
            path = os.path.join(self.root, result_rel, f"cpart{j}.dpf")
            if os.path.exists(path):
                waste += os.path.getsize(path)
                unused.append(j)
        self.events.emit(
            "coded_waste_bytes", seq=seq, bytes=waste, unused=unused,
        )
        t_rec0 = time.monotonic()
        tables = [
            parse_partition_bytes(
                self._client.read_whole_file(
                    f"{result_rel}/cpart{j}.dpf", compress=True
                )
            )
            for j in used
        ]
        merged, info = merge_coded(
            [spec.row(j) for j in used], tables,
            list(decision.key_cols), list(decision.state_cols),
            max_amplification=cfg.coded_max_amplification,
        )
        self.events.emit(
            "coded_reconstruct", seq=seq, used=used,
            parity_used=sum(1 for j in used if spec.is_parity(j)),
            exact=info["exact"],
            amplification=round(float(info["amplification"]), 4),
            seconds=round(time.monotonic() - t_rec0, 4),
        )
        self.events.emit(
            "coded_job_complete", seq=seq,
            seconds=round(time.monotonic() - t_job0, 4),
        )
        self._collect_telemetry()
        return self._finalize_coded(merged, merge)

    def _finalize_coded(self, merged, merge):
        """Produce the user-facing table from the reconstructed merged
        state columns (the coded twin of :meth:`_merge_partials`; keys
        arrive in sorted order from the union alignment, which is
        completion-subset independent)."""
        kind, keys, plan_or_dec, out_schema = merge
        result: Dict[str, np.ndarray] = {
            k: np.asarray(merged[k]) for k in keys
        }
        if kind == "group_dec":
            dec = plan_or_dec
            full = dict(result)
            # states narrow back to their declared dtypes BEFORE
            # finalize so user fns see what the uncoded path feeds them
            for name, ct in dec.state_fields:
                full[name] = np.asarray(merged[name]).astype(
                    ct.numpy_dtype
                )
            if dec.finalize is not None:
                full = _host_call(dec.finalize, full)
            for name, _ct in dec.out_fields:
                dt = out_schema.field(name).ctype.numpy_dtype
                result[name] = np.asarray(full[name]).astype(dt)
            return result
        plan = plan_or_dec
        for out, op, pcols in plan:
            if op == "mean":
                s = np.asarray(merged[pcols[0]], np.float64)
                c = np.maximum(
                    np.asarray(merged[pcols[1]], np.float64), 1.0
                )
                vals = s / c
            else:  # sum / count (linear by policy)
                vals = merged[pcols[0]]
            dt = out_schema.field(out).ctype.numpy_dtype
            result[out] = np.asarray(vals).astype(dt)
        return result

    # row-local node kinds that preserve key VALUES between an input
    # binding and the routed operator (where removes rows, project
    # renames nothing it keeps) — a select could rewrite the key and
    # silently break co-partitioning, so it blocks routing
    _ROUTE_CHAIN_OPS = frozenset({"where", "project"})

    @staticmethod
    def _route_base(node, ctx):
        """Descend a where/project chain to a host input binding;
        (input_node, arrays) or None."""
        cur = node
        while cur.kind in LocalJobSubmission._ROUTE_CHAIN_OPS:
            cur = cur.inputs[0]
        if cur.kind != "input":
            return None
        b = ctx._bindings.get(cur.id)
        if not b or b[0] != "host":
            return None
        return cur, b[1]

    def _route_for_vertices(self, gate_node, ctx, nparts):
        """Driver-side routing that makes a shuffle-bearing plan
        partition-local: join inputs co-partition by key hash, sort
        inputs range-partition on driver-sampled splitters (the
        sampler + distributor pair of ``DryadLinqSampler.cs:38-42`` /
        ``DrDynamicRangeDistributor.cpp:28-100`` executed at the
        driver).  On the vertex's one-device mesh the plan's exchanges
        are identity, so each vertex computes exactly its partition of
        the answer.  Returns ``(kind, {input_node_id: host_routed
        binding})`` or None when the plan shape doesn't qualify."""
        from dryad_tpu_torch.exec.outofcore import (
            _host_hash_buckets,
            _sample_splitters,
            _sort_key_view,
        )

        cur = gate_node
        while cur.kind in self._ROUTE_CHAIN_OPS:
            cur = cur.inputs[0]
        if cur.kind == "join":
            jp = cur.params
            sides = []
            for inp, keys in (
                (cur.inputs[0], jp["left_keys"]),
                (cur.inputs[1], jp["right_keys"]),
            ):
                base = self._route_base(inp, ctx)
                if base is None:
                    return None
                nid_node, arrays = base
                if any(k not in arrays for k in keys):
                    return None
                sides.append((nid_node.id, arrays, list(keys)))
            if sides[0][0] == sides[1][0] and sides[0][2] != sides[1][2]:
                # self-join on DIFFERENT key columns: one node cannot
                # carry two routings — a silent overwrite would drop
                # matches, so fall back to the gang submit
                return None
            overrides = {}
            for nid, arrays, keys in sides:
                buckets = _host_hash_buckets(
                    arrays, keys, nparts, salt=0,
                    dictionary=ctx.dictionary,
                )
                overrides[nid] = self._routed_binding(
                    arrays, buckets, nparts
                )
            return "join", overrides
        if cur.kind == "order_by":
            keys = cur.params["keys"]
            primary, pdesc = keys[0]
            base = self._route_base(cur.inputs[0], ctx)
            if base is None:
                return None
            nid_node, arrays = base
            if primary not in arrays:
                return None
            col = _sort_key_view(np.asarray(arrays[primary], copy=False))
            splitters = _sample_splitters(col, nparts)
            buckets = np.searchsorted(splitters, col, side="right")
            if pdesc:
                # part order must follow the sort direction: the
                # largest-value range lands on part 0
                buckets = len(splitters) - buckets
            return "order_by", {
                nid_node.id: self._routed_binding(
                    arrays, buckets, nparts
                )
            }
        return None

    @staticmethod
    def _routed_binding(arrays, buckets, nparts):
        order = np.argsort(buckets, kind="stable")
        counts = np.bincount(buckets, minlength=nparts)
        offsets = np.concatenate(
            [[0], np.cumsum(counts)]
        ).astype(np.int64)
        return (
            "host_routed",
            {k: np.asarray(v)[order] for k, v in arrays.items()},
            offsets,
        )

    # mergeable builtin aggregates for the partial-vertex rewrite
    # (shared with the streaming executor; "first" merges correctly
    # because _assemble concatenates partition results in part-id order
    # = engine order, so the first partial occurrence of a key IS the
    # engine-order first).
    _MERGEABLE_AGGS = _partial.MERGEABLE_AGGS

    _partial_plan = staticmethod(_partial.partial_plan)

    def _rewrite_partial_group(self, query):
        """Split a terminal builtin-agg group_by / scalar aggregate into
        per-vertex partials + a driver-side final merge.  Returns
        (partial_query, merge_spec, gate_node) or None when the plan
        does not qualify.  merge_spec: (kind, keys, plan, out_schema)
        where plan rows are (out_name, op, partial_col_names)."""
        from dryad_tpu_torch.api.query import Query

        node = query.node
        dec = node.params.get("decomposable")
        if node.kind == "group_by" and dec is not None:
            return self._rewrite_partial_decomposable(query, node, dec)
        agg_list = node.params.get("aggs")
        if not agg_list or any(
            op not in self._MERGEABLE_AGGS for op, _c, _o in agg_list
        ):
            return None
        if any(op == "first" for op, _c, _o in agg_list):
            # "first" merges by part-id-concat order, which equals
            # engine order only for HOST bindings (np.array_split is
            # contiguous); slice_binding deals STORE partitions
            # round-robin, where that order diverges from
            # submit()/collect() — refuse rather than return an
            # nparts-dependent answer (code-review r4).
            from dryad_tpu_torch.plan.nodes import walk as _walk

            for nd in _walk([node]):
                b = query.ctx._bindings.get(nd.id)
                if b and b[0] == "store":
                    return None
        if node.kind == "group_by":
            inner = Query(query.ctx, node.inputs[0])
            partial, plan = self._partial_plan(agg_list)
            pq = inner.group_by(
                list(node.params["keys"]), partial,
                dense=node.params.get("dense"),
                # salt= is the user's sort-path/skew escape hatch;
                # keep honoring it on the vertex
                salt=node.params.get("salt"),
            )
            return pq, (
                "group", list(node.params["keys"]), plan, query.schema
            ), inner.node
        if node.kind == "aggregate":
            # scalar "first" has no neutral value for an empty
            # partition's partial row (and scalar_agg doesn't implement
            # it) — the engine-order merge applies to group_by only
            if any(op == "first" for op, _c, _o in agg_list):
                return None
            inner = Query(query.ctx, node.inputs[0])
            partial, plan = self._partial_plan(agg_list)
            pq = inner.aggregate_as_query(partial)
            return pq, ("aggregate", [], plan, query.schema), inner.node
        return None

    def _rewrite_partial_decomposable(self, query, node, dec):
        """Custom-combiner vertex partials: qualify when the
        Decomposable types its state columns (``state_fields``) — each
        vertex emits per-partition state rows, the driver merges with
        the user's associative ``merge`` and runs ``finalize`` once
        (the reference's machine-level partial aggregation for custom
        combiners, ``DrDynamicAggregateManager``)."""
        import dataclasses as _dc

        from dryad_tpu_torch.api.query import Query

        if dec.state_fields is None:
            return None
        if {n for n, _ct in dec.state_fields} != set(dec.state_cols):
            raise ValueError(
                "Decomposable.state_fields names "
                f"{[n for n, _ct in dec.state_fields]} must match "
                f"state_cols {list(dec.state_cols)}"
            )
        if any(ct.is_split for _n, ct in dec.state_fields):
            return None  # split-word states can't merge on the host
        inner = Query(query.ctx, node.inputs[0])
        partial_dec = _dc.replace(
            dec, out_fields=list(dec.state_fields), finalize=None
        )
        pq = inner.group_by(
            list(node.params["keys"]), decomposable=partial_dec
        )
        return pq, (
            "group_dec", list(node.params["keys"]), dec, query.schema
        ), inner.node

    def _merge_partials(
        self, table, merge, part_rows=None, config=None, snaps=None
    ):
        """Final merge of assembled per-vertex partial results on the
        driver (the aggregation tree's root; reference
        ``DrDynamicAggregateManager`` final vertex).

        With ``config.combine_tree`` on and per-vertex row boundaries
        from assembly, grouped partials reduce HIERARCHICALLY first:
        vertices place into merge groups by key-histogram similarity
        (``exec.combinetree.plan_groups``), each group's partial state
        merges un-finalized (level 0), and the flat pass below
        finalizes over the much smaller pre-merged rows — the driver-
        side analog of the device combine tree.  Plans carrying
        "first" skip the tree (its merge is engine-order-sensitive and
        similarity grouping reorders rows)."""
        kind, keys, plan, out_schema = merge
        if kind == "group_dec":
            return self._merge_dec_partials(table, keys, plan, out_schema)
        if (
            kind == "group"
            and part_rows
            and sum(1 for r in part_rows if r) > 2
            and bool(getattr(config, "combine_tree", False))
            and not any(op == "first" for _out, op, _p in plan)
        ):
            table = self._tree_merge_state(
                table, keys, plan, part_rows, config, snaps=snaps
            )
        cols = {k: np.asarray(v) for k, v in table.items()}
        n = len(next(iter(cols.values()), []))

        def reduce_rows(idxs):
            row = {}
            for out, op, pcols in plan:
                if op == "mean":
                    s = cols[pcols[0]][idxs].sum()
                    c = cols[pcols[1]][idxs].sum()
                    row[out] = s / max(int(c), 1)
                elif op in ("sum", "count"):
                    row[out] = cols[pcols[0]][idxs].sum()
                elif op == "min":
                    row[out] = cols[pcols[0]][idxs].min()
                elif op == "max":
                    row[out] = cols[pcols[0]][idxs].max()
                elif op == "any":
                    row[out] = bool(np.any(cols[pcols[0]][idxs]))
                elif op == "all":
                    row[out] = bool(np.all(cols[pcols[0]][idxs]))
                elif op == "first":
                    # partial rows concatenate in part-id order, so the
                    # first occurrence is the engine-order first
                    row[out] = cols[pcols[0]][np.asarray(idxs)[0]]
            return row

        out: Dict[str, list] = {}
        if kind == "aggregate":
            # scalar: one partial row per vertex; empty-partition rows
            # carry neutral sentinels (0 sums, +/-inf extrema), which
            # the reductions absorb.
            row = reduce_rows(slice(None)) if n else {}
            out = {o: [row.get(o, 0)] for o, _op, _p in plan}
        else:
            index: Dict[tuple, list] = {}
            tups = list(zip(*[cols[k].tolist() for k in keys])) if n else []
            for i, t in enumerate(tups):
                index.setdefault(t, []).append(i)
            out = {k: [] for k in keys}
            for o, _op, _p in plan:
                out[o] = []
            for t, idxs in index.items():
                for k, kv in zip(keys, t):
                    out[k].append(kv)
                row = reduce_rows(np.asarray(idxs))
                for o, _op, _p in plan:
                    out[o].append(row[o])
        result: Dict[str, np.ndarray] = {}
        for k in keys:
            result[k] = np.asarray(out[k], dtype=cols[k].dtype)
        for o, _op, _p in plan:
            dt = out_schema.field(o).ctype.numpy_dtype
            result[o] = np.asarray(out[o]).astype(dt)
        return result

    def _tree_merge_state(
        self, table, keys, plan, part_rows, config, snaps=None
    ):
        """Level-0 of the driver-side combine tree: slice the assembled
        table back into per-vertex segments, place segments into merge
        groups by key-histogram similarity, and fold each group's
        partial STATE (un-finalized, associative reductions only).
        Returns the concatenated group results — a valid partial table
        the flat finalizing pass then reduces as the tree root.
        ``snaps``: per-segment key-range snapshots already computed at
        a lower tree level (the gang workers' level-(-1) pre-merge
        ships them — same deterministic hash, same range space), which
        skip the driver-side hash + histogram pass."""
        from dryad_tpu_torch.exec.combinetree import plan_groups
        from dryad_tpu_torch.exec.partial import state_reductions
        from dryad_tpu_torch.obs.metrics import KeyRangeHistogram

        cols = {k: np.asarray(v) for k, v in table.items()}
        ranges = int(getattr(config, "combine_tree_ranges", 64))
        bounds = np.cumsum([0] + list(part_rows))
        if (
            snaps is None
            or len(snaps) != len(part_rows)
            or any(s is None for s in snaps)
        ):
            h = _driver_key_hash(cols, keys)
            snaps = []
            for i in range(len(part_rows)):
                kr = KeyRangeHistogram(ranges)
                kr.observe(h[bounds[i]:bounds[i + 1]])
                snaps.append(kr.snapshot())
        g = int(getattr(config, "combine_tree_groups", 0) or 0)
        n_groups = g if g > 0 else max(2, int(len(part_rows) ** 0.5))
        groups = plan_groups(snaps, n_groups)
        red = state_reductions(plan)
        merged = []
        for gi, members in enumerate(groups):
            rows = np.concatenate(
                [np.arange(bounds[m], bounds[m + 1]) for m in members]
            )
            seg = {c: v[rows] for c, v in cols.items()}
            mseg = _merge_group_state(seg, keys, red)
            merged.append(mseg)
            self.events.emit(
                "combine_tree_level", level=0, group=gi,
                fan_in=len(members),
                cap_rows=len(next(iter(mseg.values()), [])),
                bytes=int(sum(v.nbytes for v in seg.values())),
                ici_bytes=0, dcn_bytes=0, device=False,
            )
        out = {
            c: np.concatenate([m[c] for m in merged])
            for c in merged[0]
        }
        self.events.emit(
            "combine_tree_level", level=1, fan_in=len(groups),
            cap_rows=len(next(iter(out.values()), [])),
            bytes=int(
                sum(sum(v.nbytes for v in m.values()) for m in merged)
            ),
            ici_bytes=0, dcn_bytes=0, device=False,
        )
        return out

    def _auto_fanout(self, query) -> int:
        """Data-size-driven task count (``DrDynamicRangeDistributor.cpp:
        54-110``: consumer copies = observed size / data-per-vertex):
        one task per ``config.rows_per_vertex`` input rows, at least one
        wave over the gang, capped at 8 waves."""
        from dryad_tpu_torch.plan.nodes import walk

        rows = 0
        for n in walk([query.node]):
            b = query.ctx._bindings.get(n.id)
            if not b:
                continue
            kind, *rest = b
            if kind in ("host", "host_physical"):
                arrays = rest[0]
                rows += max(
                    (len(np.asarray(v)) for v in arrays.values()), default=0
                )
            elif kind == "store":
                parts = rest[0]
                rows += sum(
                    len(next(iter(c.values()))) if c else 0 for c in parts
                )
        per = max(query.ctx.config.rows_per_vertex, 1)
        fanout = max(self.n, -(-rows // per))
        return min(fanout, self.n * 8)

    def _register_strings(self, query) -> None:
        """Register every host-bound STRING token in the DRIVER's
        dictionary before packing.  Workers re-encode the same strings
        with the same deterministic Hash64 (``columnar/schema.py``), so
        assembly can decode results without a worker-shipped dictionary
        (the gang path ships one; vertex tasks don't)."""
        from dryad_tpu_torch.columnar.schema import ColumnType, hash64_str
        from dryad_tpu_torch.plan.nodes import walk

        for n in walk([query.node]):
            b = query.ctx._bindings.get(n.id)
            if not b or b[0] != "host":
                continue
            arrays = b[1]
            for f in n.schema.fields:
                if f.ctype is ColumnType.STRING and f.name in arrays:
                    for s in np.unique(np.asarray(arrays[f.name], object)):
                        query.ctx.dictionary._map[hash64_str(str(s))] = str(s)

    def _merge_dec_partials(self, table, keys, dec, out_schema):
        """Reduce assembled per-vertex STATE rows with the user's
        associative ``merge`` — vectorized across ALL groups at once,
        one round per duplicate rank (<= nparts-1 rounds, each a single
        user-merge call) — then run ``finalize`` once over the merged
        groups."""
        state_names = [n for n, _ct in dec.state_fields]
        cols = {k: np.asarray(v) for k, v in table.items()}
        n = len(next(iter(cols.values()), []))
        tups = list(zip(*[cols[k].tolist() for k in keys])) if n else []
        index: Dict[tuple, list] = {}
        for i, t in enumerate(tups):
            index.setdefault(t, []).append(i)
        groups = list(index.items())
        # Pad every group's row list to the same depth and fold rounds:
        # merge(acc, rows[j]) vectorized across ALL groups at once.
        acc = {
            c: np.asarray([cols[c][idxs[0]] for _t, idxs in groups])
            for c in state_names
        }
        depth = max((len(idxs) for _t, idxs in groups), default=1)
        for j in range(1, depth):
            rows_j = [
                idxs[j] if j < len(idxs) else idxs[0]
                for _t, idxs in groups
            ]
            nxt = {c: cols[c][rows_j] for c in state_names}
            merged = _host_call(dec.merge, acc, nxt)
            has_j = np.asarray([j < len(idxs) for _t, idxs in groups])
            acc = {
                c: np.where(has_j, np.asarray(merged[c]), acc[c])
                for c in state_names
            }
        # one key-array build, preserving the assembled dtype (int32
        # keys stay int32; string keys stay object)
        key_arrays = {
            k: np.asarray([t[i] for t, _ in groups], dtype=cols[k].dtype)
            for i, k in enumerate(keys)
        }
        full = dict(key_arrays)
        full.update(acc)
        if dec.finalize is not None:
            full = _host_call(dec.finalize, full)
        result: Dict[str, np.ndarray] = dict(key_arrays)
        for name, _ct in dec.out_fields:
            dt = out_schema.field(name).ctype.numpy_dtype
            result[name] = np.asarray(full[name]).astype(dt)
        return result

    def inject_delay(
        self, worker: int, seconds: float, count: int = 1
    ) -> None:
        """Make the next ``count`` vertex tasks on one worker stall
        ``seconds`` — the injected-straggler knob (per-worker, unlike
        :meth:`inject_fault`'s gang broadcast)."""
        self._sync_membership()
        cmd = {
            "kind": "set_delay", "seconds": seconds, "count": count,
            "cseq": self._next_cseq(),
        }
        p = ClusterProcess(
            self._command_round_trip(worker, cmd),
            name=f"delay-w{worker}",
            affinities=[Affinity(f"worker{worker}", hard=True)],
        )
        self.scheduler.schedule(p)
        if not p.wait(30.0) or p.state is not ProcessState.COMPLETED:
            raise RuntimeError(
                f"delay injection on worker {worker} failed: {p.error}"
            )

    def _assemble(
        self, query, result_rel: str, part_ids: List[int],
        dictionary: Optional[StringDictionary] = None,
        part_rows: Optional[List[int]] = None,
    ) -> Dict[str, np.ndarray]:
        """Fetch result partitions through the file server (HTTP range
        reads via the block cache) and decode to a host table (the
        workers wrote valid rows only, so every row decodes; STRING
        columns through ``dictionary``, where ``_register_strings`` put
        every host token, or else the gang's ``dictionary.pkl``)."""
        from concurrent.futures import ThreadPoolExecutor

        from dryad_tpu_torch.columnar.batch import decode_physical_table

        # Partitions fetch CONCURRENTLY with zlib wire compression
        # (assemble time ~ max partition, not the sum; the async
        # channel-reader role, HttpReader.cs:78 + dryadvertex.h:33-48).
        w0, r0 = self._client.wire_bytes, self._client.raw_bytes
        with self.tracer.span(
            "assemble", cat="driver", parts=len(part_ids)
        ), ThreadPoolExecutor(
            max_workers=min(8, max(len(part_ids), 1))
        ) as ex:
            cols_parts = list(
                ex.map(
                    lambda g: parse_partition_bytes(
                        self._client.read_whole_file(
                            f"{result_rel}/part{g}.dpf", compress=True
                        )
                    ),
                    part_ids,
                )
            )
        self.events.emit(
            "assemble_fetch", parts=len(part_ids),
            wire_bytes=self._client.wire_bytes - w0,
            raw_bytes=self._client.raw_bytes - r0,
        )
        if dictionary is None:
            dictionary = StringDictionary()
            dictionary._map.update(
                pickle.loads(self._client.read_whole_file(f"{result_rel}/dictionary.pkl"))
            )
        phys = query.schema.device_names()
        if not cols_parts:
            return {n: np.zeros(0) for n in query.schema.names}
        if part_rows is not None and phys:
            # per-part row boundaries of the concatenation — lets the
            # combine-tree merge slice the decoded table back into
            # per-vertex segments (decode is row-preserving)
            part_rows.extend(len(p[phys[0]]) for p in cols_parts)
        cols = {
            c: np.concatenate([p[c] for p in cols_parts]) for c in phys
        }
        return decode_physical_table(query.schema, slice(None), cols, dictionary)

    def inject_fault(
        self,
        stage: Optional[str],
        count: int = 1,
        plan: Optional[Dict] = None,
        workers: Optional[List[int]] = None,
    ) -> None:
        """Send a fault-injection command to workers (remote
        SetFakeVertexFailure; ``stage=None`` with no plan clears).

        ``plan``: a seeded :class:`exec.faults.FaultPlan` as a dict —
        including ``worker_kill_prob`` process kills, the gang chaos
        scenario.  ``workers``: target subset (default all).  For gang
        SPMD jobs a *stage fault* must reach EVERY member (a partial
        fault strands the rest in a collective); partial targeting is
        for vertex/coded tasks and for kill scenarios, where stranding
        the peers mid-collective is exactly the point."""
        self._sync_membership()
        cmd = {
            "kind": "set_fault", "stage": stage, "count": count,
            "cseq": self._next_cseq(),
        }
        if plan is not None:
            cmd["plan"] = plan
        targets = list(workers) if workers is not None else list(range(self.n))
        procs = []
        for i in targets:
            p = ClusterProcess(
                self._command_round_trip(i, cmd),
                name=f"fault-w{i}",
                affinities=[Affinity(f"worker{i}", hard=True)],
            )
            self.scheduler.schedule(p)
            procs.append(p)
        for i, p in zip(targets, procs):
            if not p.wait(30.0) or p.state is not ProcessState.COMPLETED:
                raise RuntimeError(f"fault injection on worker {i} failed: {p.error}")

    # -- teardown ------------------------------------------------------------
    def shutdown(self, graceful_timeout: float = 15.0) -> None:
        try:
            for i, h in list(self._handles.items()):
                if self.launcher.poll(h) is None:
                    self.service.mailbox.set_prop(
                        self.job_id, f"cmd/{i}",
                        json.dumps(
                            {"kind": "exit", "cseq": self._next_cseq()}
                        ).encode(),
                    )
            deadline = time.monotonic() + graceful_timeout
            for h in list(self._handles.values()):
                left = max(0.1, deadline - time.monotonic())
                try:
                    self.launcher.wait(h, timeout=left)
                except Exception:  # noqa: BLE001 — escalate to stop
                    self.launcher.stop(h)
        finally:
            self.scheduler.shutdown()
            self.service.close()
            self.events.close()
            # the recorder dumps under this job's root: it goes with it
            if flightrec.get_recorder() is self._recorder:
                flightrec.uninstall_recorder()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
