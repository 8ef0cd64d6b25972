"""Multi-process runtime init and the job control plane over a
property mailbox (``dryad_tpu/parallel/multihost.py``).

The reference coordinates a job across processes with the job
manager's cluster abstraction and the per-node ProcessService property
mailbox (``ProcessService.cs:42-126``).  The data plane is the gang's
own program: :func:`init_distributed` joins this process to a
``torch.distributed`` group, over which the stage ops' collectives
(``parallel/partition.py``) synchronise the gang.  The control plane
is a thin client of ``cluster/service.py``'s ``ProcessService``:
membership, heartbeats, barriers, failure reports and telemetry
shipping (``obs/gang.py``).
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from dryad_tpu_torch.cluster.service import Mailbox, ServiceClient
from dryad_tpu_torch.utils.logging import get_logger

log = get_logger("dryad_tpu_torch.parallel.multihost")

_initialized = False
_init_lock = threading.Lock()

DEFAULT_TIMEOUT_S = 300.0


def local_index(process_id: int, num_processes: int) -> Tuple[int, int]:
    """``(local rank, local world size)`` of this process on its host:
    torch's ``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` where a launcher set
    them, else every rank on this host."""
    lr, lw = os.environ.get("LOCAL_RANK"), os.environ.get("LOCAL_WORLD_SIZE")
    if lr and lw:
        return int(lr), int(lw)
    return int(process_id), int(num_processes)


def rank_device(device, local_rank: int, local_world: int):
    """The device of a gang's rank: ``device`` when it names one (a CPU,
    or a card by index); for ``"cuda"`` (or None) card ``local_rank``
    when the host has a card for each of its ``local_world`` ranks, else
    the current card, which the host's ranks then share."""
    import torch

    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if torch.cuda.device_count() >= local_world:
        return torch.device("cuda", local_rank)
    return dev


def choose_backend(layout: Sequence[str]) -> str:
    """The group's backend from every rank's ``host/device``, gathered
    before the group exists: ``nccl`` when every rank is on a card and
    no two ranks share one, else ``gloo`` (the CPU, or ranks sharing a
    card: NCCL refuses two ranks on one device, and gloo stages CUDA
    tensors through the host)."""
    on_cards = all(d.split("/", 1)[1].startswith("cuda:") for d in layout)
    return "nccl" if on_cards and len(set(layout)) == len(layout) else "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    timeout: Optional[float] = None,
) -> bool:
    """Join this process to the gang's ``torch.distributed`` group
    (idempotent).

    The analog of the reference's multi-controller bring-up: after
    this, ``parallel/mesh.py::make_mesh`` spans every rank, and the
    stage ops' collectives cross processes.  Arguments default from
    torch's standard variables (``MASTER_ADDR``:``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``); returns False (no group) when neither
    arguments nor environment ask for more than one process.  The
    rank's device and the group's backend are decided here, together:
    the device by :func:`rank_device` from the rank's local index
    (:func:`local_index`), made current; the backend by
    :func:`choose_backend` from every rank's host and device, exchanged
    through the coordinator's store before the group is made.
    ``timeout`` (seconds, default 300) bounds every collective, so a
    rank that never arrives fails its peers' call instead of hanging
    them."""
    global _initialized
    with _init_lock:
        if _initialized:
            return True
        if coordinator_address is None and os.environ.get("MASTER_ADDR"):
            coordinator_address = (
                f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
            )
        if num_processes is None:
            v = os.environ.get("WORLD_SIZE")
            num_processes = int(v) if v else None
        if process_id is None:
            v = os.environ.get("RANK")
            process_id = int(v) if v else None
        if not coordinator_address or not num_processes or num_processes <= 1:
            return False
        import torch
        import torch.distributed as dist

        world, rank = int(num_processes), int(process_id or 0)
        dev = rank_device(device, *local_index(rank, world))
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(dev)
        td = datetime.timedelta(seconds=timeout or DEFAULT_TIMEOUT_S)
        host, port = coordinator_address.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), world, is_master=rank == 0, timeout=td)
        store.set(f"layout/{rank}", f"{socket.gethostname()}/{dev}")
        layout = [store.get(f"layout/{r}").decode() for r in range(world)]
        backend = choose_backend(layout)
        dist.init_process_group(backend, store=store, world_size=world, rank=rank, timeout=td)
        _initialized = True
        log.info(
            "joined process group %s as rank %d/%d on %s (%s)",
            coordinator_address, rank, world, dev, backend,
        )
        return True


class ControlPlane:
    """Job control plane over a property mailbox.

    One instance per driver process.  Backed either by a remote
    ``ProcessService`` (``ServiceClient``) or an in-process ``Mailbox``
    (local/test mode).  Properties live under the job id, mirroring the
    reference's per-process mailbox records
    (``ProcessService.cs:81-126`` MailboxRecord):

    - ``member/<i>``    — membership announcement (JSON metadata)
    - ``hb/<i>``        — heartbeat timestamps (failure detection)
    - ``barrier/<name>/<i>`` — barrier arrivals
    - ``fail/<i>``      — failure reports (JSON)
    """

    def __init__(
        self,
        job_id: str,
        process_id: int,
        client: Optional[ServiceClient] = None,
        mailbox: Optional[Mailbox] = None,
        heartbeat_interval: float = 2.0,
    ):
        if (client is None) == (mailbox is None):
            raise ValueError("exactly one of client/mailbox required")
        self.job_id = job_id
        self.process_id = process_id
        self._client = client
        self._mailbox = mailbox
        self._hb_interval = heartbeat_interval
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None

    # -- mailbox primitives -------------------------------------------------
    def _set(self, name: str, value: bytes) -> int:
        if self._client is not None:
            return self._client.set_prop(self.job_id, name, value)
        return self._mailbox.set_prop(self.job_id, name, value)

    def _get(
        self, name: str, after: int = 0, timeout: float = 0.0
    ):
        if self._client is not None:
            return self._client.get_prop(self.job_id, name, after, timeout)
        return self._mailbox.get_prop(self.job_id, name, after, timeout)

    # -- membership ---------------------------------------------------------
    def announce(self, meta: Optional[Dict] = None) -> None:
        """Register this process (LocalScheduler computer-join analog)."""
        body = json.dumps(
            dict(meta or {}, pid=self.process_id, ts=time.time())
        ).encode()
        self._set(f"member/{self.process_id}", body)

    def announced(self, n: int) -> List[int]:
        """Process ids (of 0..n-1) that have announced, non-blocking."""
        return [i for i in range(n) if self._get(f"member/{i}") is not None]

    def wait_for_members(
        self, n: int, timeout: float = 60.0, poll: float = 0.1
    ) -> List[int]:
        """Block until >= n processes announced (the reference's
        ``WaitForReasonableNumberOfComputers``, ``LocalScheduler.cs:88``)."""
        deadline = time.monotonic() + timeout
        while True:
            members = [
                i for i in range(n) if self._get(f"member/{i}") is not None
            ]
            if len(members) >= n:
                return members
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"only {len(members)}/{n} members after {timeout}s"
                )
            time.sleep(poll)

    # -- heartbeats / failure detection ------------------------------------
    def start_heartbeat(self) -> None:
        """Background liveness beacon (ProcessService child-watch analog,
        ``Interfaces.cs:214-258`` IProcessWatcher)."""
        if self._hb_thread is not None:
            return

        def beat():
            while not self._hb_stop.wait(self._hb_interval):
                try:
                    self._set(
                        f"hb/{self.process_id}", str(time.time()).encode()
                    )
                except Exception as e:  # control plane hiccup: keep beating
                    log.warning("heartbeat failed: %s", e)

        self._set(f"hb/{self.process_id}", str(time.time()).encode())
        self._hb_thread = threading.Thread(target=beat, daemon=True)
        self._hb_thread.start()

    def stop_heartbeat(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)
            self._hb_thread = None

    def alive_members(self, n: int, ttl: float = 10.0) -> List[int]:
        """Processes whose heartbeat is fresher than ``ttl`` seconds."""
        now = time.time()
        alive = []
        for i in range(n):
            got = self._get(f"hb/{i}")
            if got is not None and now - float(got[1]) <= ttl:
                alive.append(i)
        return alive

    # -- barriers -----------------------------------------------------------
    def barrier(
        self, name: str, n: int, timeout: float = 120.0, poll: float = 0.05
    ) -> None:
        """Arrive at a named barrier and wait for all n processes.

        Control-plane only (slow path): intra-program synchronisation is
        the SPMD collectives'; this guards host-side stage boundaries
        (e.g. everyone finished materialising before anyone reads).
        """
        self._set(f"barrier/{name}/{self.process_id}", b"1")
        deadline = time.monotonic() + timeout
        while True:
            arrived = sum(
                1
                for i in range(n)
                if self._get(f"barrier/{name}/{i}") is not None
            )
            if arrived >= n:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"barrier {name!r}: {arrived}/{n} after {timeout}s"
                )
            time.sleep(poll)

    # -- telemetry (obs.gang: worker span/counter batches) ------------------
    def ship_telemetry(self, batch) -> None:
        """Worker side: publish one drained event batch as a numbered
        ``telemetry/<pid>/<seq>`` property (see ``obs.gang``)."""
        from dryad_tpu_torch.obs.gang import ship_telemetry

        ship_telemetry(self, batch)

    def drain_telemetry(
        self, n: int, state: Dict, events, scheduler=None
    ) -> int:
        """Driver side: absorb every worker's unread telemetry batches
        into ``events`` with clock-offset correction; ``scheduler``
        additionally folds peer ``quarantine_delta`` events into the
        local blacklist; returns the number of absorbed events (see
        ``obs.gang``)."""
        from dryad_tpu_torch.obs.gang import drain_telemetry

        return drain_telemetry(self, n, state, events, scheduler=scheduler)

    # -- failures -----------------------------------------------------------
    def report_failure(self, info: Dict) -> None:
        self._set(
            f"fail/{self.process_id}",
            json.dumps(dict(info, ts=time.time())).encode(),
        )

    def failures(self, n: int) -> Dict[int, Dict]:
        out: Dict[int, Dict] = {}
        for i in range(n):
            got = self._get(f"fail/{i}")
            if got is not None:
                out[i] = json.loads(got[1])
        return out
