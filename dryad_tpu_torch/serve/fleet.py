"""Serving fleet — multi-process front door + engine replicas (the
counterpart of ``dryad_tpu/serve/fleet.py``).

The reference Dryad scales by putting a per-node ProcessService daemon
in front of every machine; this module is that move for the serving
tier.  ONE front-door :class:`~dryad_tpu_torch.cluster.service.ProcessService`
(mailbox + HTTP) faces the clients, N engine replicas (each a
:class:`~dryad_tpu_torch.serve.service.QueryService` wrapping its OWN
:class:`~dryad_tpu_torch.api.context.DryadContext`) sit behind it, and a
plan-fingerprint-affine router keeps repeat plans landing on the
replica that already holds their compiled program, operand-pool
residency, and result-cache entries.

Wire protocol — everything is mailbox props under the ``fleet`` pid,
so the transport is exactly the gang envelope plane:

- ``rq/<qid>``    client -> router: pickled submit envelope (tenant,
                  tier, weight, routing fingerprint, packed query
                  blob, TraceContext wire form).  The mailbox itself
                  is the SUBMIT LOG: replay after a replica death
                  re-reads the envelope from this prop.
- ``cmd/<rid>/<seq>`` router -> replica: pickled list of envelopes.
                  Sequential per-replica props (never overwritten), so
                  the replica reads seq 0,1,2,... and a batch can
                  never be lost to latest-value semantics; batching is
                  natural back-pressure — whatever queued while the
                  replica was busy ships as one prop.
- ``res/<qid>``   replica -> everyone: framed result (header + table).
                  The CLIENT long-polls this prop directly — result
                  delivery costs no router hop — while the router's
                  in-process mailbox watch observes the same set to
                  retire the in-flight entry, feed the negative quota
                  memo, and emit ``fleet_result``.
- ``hb/<rid>``    replica heartbeat; the prop VERSION is the liveness
                  signal (:class:`~dryad_tpu_torch.serve.router.ReplicaSet`
                  only counts an advancing version).
- ``stats/<rid>`` periodic ``QueryService.stats()`` + rolling SLO
                  snapshot, the metricsd scrape surface
                  (``merge_snapshots`` folds N of these).

The router runs IN the front-door process and touches the mailbox
object directly (a mailbox watch wakes it; routing decisions cost zero
HTTP).  Failure path: a replica whose heartbeat version stops
advancing is reaped, the routing generation bumps, and every in-flight
query it held replays from the submit log onto the rendezvous failover
replica — byte-identical results, because the engine is deterministic
and the replayed envelope is the original bytes.
"""

from __future__ import annotations

import itertools
import os
import pickle
import struct
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from dryad_tpu_torch.cluster.service import ProcessService, ServiceClient
from dryad_tpu_torch.exec.events import EventLog
from dryad_tpu_torch.obs import tracectx
from dryad_tpu_torch.serve.admission import (
    DEFAULT_TIER,
    QueryRejected,
    check_tier,
    tier_rank,
)
from dryad_tpu_torch.serve.router import (
    NegativeQuotaMemo,
    ReplicaSet,
    canonical_fingerprint,
    package_fingerprint,
    rendezvous_rank,
)
from dryad_tpu_torch.utils.logging import get_logger

log = get_logger("dryad_tpu_torch.serve.fleet")

FLEET_PID = "fleet"  # mailbox pid namespace for every fleet prop

_MAGIC = b"F1"


# -- result framing ---------------------------------------------------------
# header and table pickle separately so the router (which only needs
# the header to retire an in-flight entry) never deserializes payload
# tables on the hot path.


def encode_result(header: Dict[str, Any], table) -> bytes:
    h = pickle.dumps(header, protocol=pickle.HIGHEST_PROTOCOL)
    t = pickle.dumps(table, protocol=pickle.HIGHEST_PROTOCOL)
    return _MAGIC + struct.pack("<II", len(h), len(t)) + h + t


def decode_result_header(blob: bytes) -> Dict[str, Any]:
    if blob[:2] != _MAGIC:
        raise ValueError("bad result frame")
    hlen, _tlen = struct.unpack("<II", blob[2:10])
    return pickle.loads(blob[10 : 10 + hlen])


def decode_result(blob: bytes) -> Tuple[Dict[str, Any], Any]:
    if blob[:2] != _MAGIC:
        raise ValueError("bad result frame")
    hlen, tlen = struct.unpack("<II", blob[2:10])
    header = pickle.loads(blob[10 : 10 + hlen])
    table = pickle.loads(blob[10 + hlen : 10 + hlen + tlen])
    return header, table


def raise_for_result(header: Dict[str, Any]) -> None:
    """Map a failed result header onto the structured exceptions the
    single-process serving tier raises."""
    rej = header.get("rejected")
    if rej is not None:
        raise QueryRejected(
            header.get("tenant", "?"), rej.get("reason", "?"),
            int(rej.get("limit", 0)), int(rej.get("current", 0)),
        )
    if not header.get("ok", False):
        raise RuntimeError(
            f"fleet query {header.get('qid')} failed: "
            f"{header.get('error')}"
        )


def pack_for_fleet(query) -> Tuple[bytes, str]:
    """Serialize *query* into a fleet envelope payload: the job-package
    bytes plus the routing fingerprint — the canonical sha of the serve
    cache's ``(graph_key, output, binding_SHAs)`` tuple when the plan
    is value-portable, else the package-bytes sha (same client
    resubmitting the same blob still routes affine)."""
    from dryad_tpu_torch.exec import jobpackage

    with tempfile.TemporaryDirectory(prefix="dryad-pack-") as td:
        path = os.path.join(td, "query.qpkg")
        jobpackage.pack_query(query, path)
        with open(path, "rb") as fh:
            blob = fh.read()
    fp = canonical_fingerprint(query.ctx.query_fingerprint(query))
    return blob, (fp or package_fingerprint(blob))


def make_envelope(
    *,
    qid: str,
    tenant: str,
    package: bytes,
    fingerprint: Optional[str] = None,
    tier: str = DEFAULT_TIER,
    weight: int = 1,
    trace: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    check_tier(tier)
    return {
        "qid": qid,
        "tenant": tenant,
        "tier": tier,
        "weight": int(weight),
        "package": package,
        "fingerprint": fingerprint or package_fingerprint(package),
        "trace": trace or {"qid": qid, "tenant": tenant},
    }


# -- replica side -----------------------------------------------------------


class ReplicaRunner:
    """One engine replica: its own DryadContext + QueryService, fed by
    the front door's ``cmd/<rid>/<seq>`` prop stream over real HTTP
    (same wire whether the runner lives in a thread or its own
    process — ``dryad_tpu_torch.serve.replica`` is this class as a main).

    Threads: the SERVE loop long-polls command props in sequence,
    loads/looks-up the prepared query per package sha, and submits to
    the local QueryService; the RESULT loop posts each future's
    outcome as it resolves (so the serve loop keeps reading the next
    batch while earlier queries execute); the HEARTBEAT loop versions
    ``hb/<rid>`` and refreshes ``stats/<rid>``.

    ``kill()`` is the chaos hook: a simulated SIGKILL — every loop
    stops posting IMMEDIATELY (no result flush, no farewell heartbeat),
    exactly what the router's staleness detector must recover from.
    """

    def __init__(
        self,
        rid: str,
        host: str,
        port: int,
        ctx_factory: Callable[[], Any],
        hb_interval: float = 0.25,
        poll_s: float = 1.0,
        allow_process_exit: bool = False,
    ):
        self.rid = rid
        self.host, self.port = host, port
        self._ctx_factory = ctx_factory
        self.hb_interval = hb_interval
        self.poll_s = poll_s
        # only a replica that OWNS its process may honor a FaultPlan
        # kill (os._exit) — a thread-mode runner must never take the
        # test runner down with it
        self._allow_process_exit = allow_process_exit
        self._killed = False
        self._stopping = False
        self._ready = threading.Event()
        self._drained = threading.Event()
        self._results: "deque" = deque()
        self._res_cv = threading.Condition()
        self.svc = None
        self.ctx = None
        self._threads: List[threading.Thread] = []

    # -- lifecycle --

    def start(self) -> "ReplicaRunner":
        t = threading.Thread(
            target=self._serve_loop, daemon=True,
            name=f"dryad-replica-{self.rid}",
        )
        self._threads.append(t)
        t.start()
        return self

    def run_forever(self) -> None:
        """Process-mode entry: serve on the calling thread until the
        exit envelope arrives (``dryad_tpu_torch.serve.replica`` main)."""
        self._serve_loop()

    def kill(self) -> None:
        """Chaos: die mid-query.  Nothing further is posted — pending
        results, heartbeats, and stats all stop on the spot."""
        self._killed = True
        with self._res_cv:
            self._res_cv.notify_all()

    def stop(self, timeout: float = 30.0) -> None:
        """Graceful local stop (normally driven by the exit envelope)."""
        self._stopping = True
        with self._res_cv:
            self._res_cv.notify_all()
        for t in self._threads:
            t.join(timeout)
        self._cleanup()

    def _cleanup(self) -> None:
        if self.svc is not None:
            try:
                self.svc.close(timeout=10.0)
            except Exception:  # noqa: BLE001
                pass

    # -- loops --

    def _serve_loop(self) -> None:
        from dryad_tpu_torch.serve.service import QueryService

        client = ServiceClient(self.host, self.port)
        try:
            self.ctx = self._ctx_factory()
            self.svc = QueryService(self.ctx)
        except Exception:  # noqa: BLE001 — a replica that can't build
            log.exception("replica %s failed to build its engine", self.rid)
            return
        self._prepared: Dict[str, Any] = {}
        self._ready.set()
        for target, name in (
            (self._hb_loop, f"dryad-replica-{self.rid}-hb"),
            (self._result_loop, f"dryad-replica-{self.rid}-res"),
        ):
            t = threading.Thread(target=target, daemon=True, name=name)
            self._threads.append(t)
            t.start()
        seq = 0
        while not self._killed and not self._stopping:
            try:
                got = client.get_prop(
                    FLEET_PID, f"cmd/{self.rid}/{seq}", 0, self.poll_s
                )
            except Exception:  # noqa: BLE001 — front door gone
                if self._stopping or self._killed:
                    break
                time.sleep(min(self.poll_s, 0.2))
                continue
            if got is None:
                continue
            seq += 1
            if self._maybe_chaos_exit(seq):
                return
            try:
                envelopes = pickle.loads(got[1])
            except Exception:  # noqa: BLE001
                log.exception("replica %s: bad command batch", self.rid)
                continue
            for env in envelopes:
                if env.get("exit"):
                    self._graceful_exit(client)
                    return
                self._submit_one(client, env)

    def _maybe_chaos_exit(self, seq: int) -> bool:
        """Seeded FaultPlan kill at a batch boundary — process-mode
        replicas reuse the gang chaos machinery (``worker_kill_prob``),
        dying the way a machine dies: no cleanup, no farewell."""
        if not self._allow_process_exit:
            return False
        from dryad_tpu_torch.exec import faults
        from dryad_tpu_torch.obs import flightrec

        if faults.registry.maybe_kill(f"replica:{self.rid}"):
            try:
                self.svc.events.emit(
                    "worker_killed_injected",
                    name=f"replica:{self.rid}", stage=f"batch{seq}",
                )
                flightrec.dump_now("replica_chaos_kill")
            except Exception:  # noqa: BLE001
                pass
            os._exit(113)
        return False

    def _graceful_exit(self, client: ServiceClient) -> None:
        # drain: wait for the result loop to post everything in flight
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            with self._res_cv:
                if not self._results:
                    break
            time.sleep(0.01)
        self._stopping = True
        with self._res_cv:
            self._res_cv.notify_all()
        try:
            self._post_stats(client)
        except Exception:  # noqa: BLE001
            pass
        self._cleanup()

    def _submit_one(self, client: ServiceClient, env: Dict) -> None:
        qid, tenant = env["qid"], env["tenant"]
        t0 = time.monotonic()
        try:
            query = self._prepared_query(env)
            sess = self.svc.session(
                tenant, weight=max(1, int(env.get("weight", 1))),
                tier=env.get("tier") or DEFAULT_TIER,
            )
            tctx = tracectx.TraceContext.from_wire(env.get("trace"))
            fut = sess.submit(query, qid=qid, tctx=tctx)
        except QueryRejected as e:
            self._post_result(client, env, t0, rejected=e)
            return
        except Exception as e:  # noqa: BLE001 — bad package, etc.
            self._post_result(client, env, t0, error=e)
            return
        with self._res_cv:
            self._results.append((env, fut, t0))
            self._res_cv.notify_all()

    def _prepared_query(self, env: Dict):
        """Prepared-statement cache: the FIRST envelope carrying a
        package sha pays the load (bindings ingest into the resident
        context); every repeat reuses the loaded Query OBJECT — so the
        compile cache and the result cache hit even for plans whose
        graph key holds closures by reference."""
        import hashlib

        from dryad_tpu_torch.exec import jobpackage

        blob = env["package"]
        sha = hashlib.sha256(blob).hexdigest()
        query = self._prepared.get(sha)
        if query is None:
            path = os.path.join(
                tempfile.gettempdir(),
                f"dryad-replica-{os.getpid()}-{self.rid}-{sha[:16]}.qpkg",
            )
            with open(path, "wb") as fh:
                fh.write(blob)
            try:
                query = jobpackage.load_query(path, ctx=self.ctx)
            finally:
                try:
                    os.unlink(path)
                except OSError:
                    pass
            self._prepared[sha] = query
        return query

    def _result_loop(self) -> None:
        client = ServiceClient(self.host, self.port)
        while not self._killed:
            with self._res_cv:
                while not self._results and not (
                    self._killed or self._stopping
                ):
                    self._res_cv.wait(0.5)
                if not self._results:
                    if self._killed or self._stopping:
                        return
                    continue
                env, fut, t0 = self._results.popleft()
            try:
                table = fut.result(timeout=600.0)
            except QueryRejected as e:
                self._post_result(client, env, t0, rejected=e)
                continue
            except BaseException as e:  # noqa: BLE001
                self._post_result(client, env, t0, error=e)
                continue
            self._post_result(
                client, env, t0, table=table, cached=fut.cached
            )

    def _post_result(
        self, client: ServiceClient, env: Dict, t0: float,
        table=None, cached: bool = False, error=None, rejected=None,
    ) -> None:
        if self._killed:
            return  # a dead replica posts nothing
        header: Dict[str, Any] = {
            "qid": env["qid"],
            "tenant": env["tenant"],
            "ok": error is None and rejected is None,
            "cached": cached,
            "seconds": round(time.monotonic() - t0, 6),
            "replica": self.rid,
            "generation": env.get("generation", 0),
            "error": repr(error) if error is not None else None,
            "rejected": (
                {
                    "reason": rejected.reason,
                    "limit": rejected.limit,
                    "current": rejected.current,
                }
                if rejected is not None
                else None
            ),
        }
        try:
            client.set_prop(
                FLEET_PID, f"res/{env['qid']}", encode_result(header, table)
            )
        except Exception:  # noqa: BLE001 — front door gone mid-close
            if not self._stopping:
                log.exception(
                    "replica %s: result post failed for %s",
                    self.rid, env["qid"],
                )

    def _hb_loop(self) -> None:
        client = ServiceClient(self.host, self.port)
        last_stats = 0.0
        while not self._killed and not self._stopping:
            try:
                client.set_prop(
                    FLEET_PID, f"hb/{self.rid}",
                    pickle.dumps({"pid": os.getpid(), "ts": time.time()}),
                )
                now = time.monotonic()
                if now - last_stats >= max(self.hb_interval, 0.5):
                    self._post_stats(client)
                    last_stats = now
            except Exception:  # noqa: BLE001
                if self._stopping or self._killed:
                    return
            time.sleep(self.hb_interval)

    def _post_stats(self, client: ServiceClient) -> None:
        from dryad_tpu_torch.exec.kernels import bucket_sum_count

        if self.svc is None or self._killed:
            return
        payload = {
            "stats": self.svc.stats(),
            "snapshot": self.svc.slo.snapshot(),
            "pid": os.getpid(),
            "ts": time.time(),
            # the hand kernels' launches in this replica's process so far
            "kernel_launches": {"bucket_sum_count": int(bucket_sum_count.launches)},
        }
        client.set_prop(
            FLEET_PID, f"stats/{self.rid}", pickle.dumps(payload)
        )


# -- router / supervisor ----------------------------------------------------


class _InFlight:
    __slots__ = ("qid", "rid", "tenant", "tier", "fingerprint", "t0",
                 "replays", "cmd_key")

    def __init__(self, qid, rid, tenant, tier, fingerprint, t0):
        self.qid = qid
        self.rid = rid
        self.tenant = tenant
        self.tier = tier
        self.fingerprint = fingerprint
        self.t0 = t0
        self.replays = 0
        self.cmd_key = None  # (rid, seq) of the batch that carried it


class ServeFleet:
    """Fleet supervisor: the front-door service, the affinity router,
    and replica lifecycle (spawn / attach / chaos-kill / reap)."""

    def __init__(
        self,
        root: Optional[str] = None,
        port: int = 0,
        events: Optional[EventLog] = None,
        hb_interval: float = 0.25,
        stale_after: float = 2.0,
        memo_ttl: float = 0.25,
        res_gc_s: float = 20.0,
    ):
        self._own_root = root is None
        self.root = root or tempfile.mkdtemp(prefix="dryad-fleet-")
        self.service = ProcessService(self.root, port=port)
        self.host, self.port = "127.0.0.1", self.service.port
        self.mailbox = self.service.mailbox
        self.events = events if events is not None else EventLog()
        self.hb_interval = hb_interval
        self.replicas = ReplicaSet(stale_after=stale_after)
        self.memo = NegativeQuotaMemo(ttl=memo_ttl)
        self.res_gc_s = res_gc_s
        self._runners: Dict[str, ReplicaRunner] = {}
        self._procs: Dict[str, subprocess.Popen] = {}
        self._modes: Dict[str, str] = {}
        self._inflight: Dict[str, _InFlight] = {}
        self._cmd_seq: Dict[str, int] = {}
        # (rid, seq) -> unresolved qids riding that cmd prop (GC)
        self._cmd_members: Dict[Tuple[str, int], set] = {}
        self._done_gc: "deque" = deque()
        self._queue: "deque" = deque()
        self._cv = threading.Condition()
        self._closing = False
        self._seq = itertools.count(1)
        self.routed = 0
        self.delivered = 0
        self.replayed = 0
        self.failed = 0
        self.stale_results = 0
        self.mailbox.add_watch(self._on_prop)
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="dryad-fleet-router"
        )
        self._thread.start()

    # -- replica lifecycle --

    def spawn_thread(
        self, rid: str, ctx_factory: Callable[[], Any],
        timeout: float = 120.0,
    ) -> ReplicaRunner:
        """In-process replica (its own DryadContext + QueryService on
        daemon threads, same HTTP wire as a subprocess replica)."""
        runner = ReplicaRunner(
            rid, self.host, self.port, ctx_factory,
            hb_interval=self.hb_interval,
        )
        self._runners[rid] = runner
        self._modes[rid] = "thread"
        runner.start()
        self.attach(rid, timeout=timeout, mode="thread")
        return runner

    def spawn_process(
        self,
        rid: str,
        bootstrap: str,
        fault: Optional[str] = None,
        env: Optional[Dict[str, str]] = None,
        timeout: float = 180.0,
    ) -> subprocess.Popen:
        """Subprocess replica: ``python -m dryad_tpu_torch.serve.replica``
        with *bootstrap* (a python file defining ``build_context()``)
        and an optional FaultPlan JSON for seeded chaos."""
        argv = [
            sys.executable, "-m", "dryad_tpu_torch.serve.replica",
            "--host", self.host, "--port", str(self.port),
            "--rid", rid, "--bootstrap", bootstrap,
            "--hb-interval", str(self.hb_interval),
        ]
        if fault:
            argv += ["--fault", fault]
        if env is None:
            # the replica resolves the modules the front door does: a
            # package pickles plan functions by reference to their module
            env = dict(os.environ)
            repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
            paths = [repo] + [p for p in sys.path if p] + [
                p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p
            ]
            env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
        p = subprocess.Popen(argv, env=env)
        self._procs[rid] = p
        self._modes[rid] = "process"
        self.attach(rid, timeout=timeout, mode="process")
        return p

    def attach(
        self, rid: str, timeout: float = 120.0, mode: str = "external"
    ) -> None:
        """Wait for the replica's first heartbeat, then add it to the
        routing set."""
        got = self.mailbox.get_prop(FLEET_PID, f"hb/{rid}", 0, timeout)
        if got is None:
            raise TimeoutError(
                f"replica {rid} posted no heartbeat in {timeout}s"
            )
        info = {}
        try:
            info = pickle.loads(got[1])
        except Exception:  # noqa: BLE001
            pass
        mode = self._modes.setdefault(rid, mode)
        with self._cv:
            self.replicas.add(rid)
            self.replicas.observe(rid, got[0])
        self.events.emit(
            "replica_started", replica=rid, mode=mode,
            pid=info.get("pid"),
        )

    def kill_replica(self, rid: str) -> None:
        """Chaos: make *rid* die mid-query.  Thread replicas get the
        simulated SIGKILL (stop posting instantly); process replicas
        get the real one."""
        runner = self._runners.get(rid)
        if runner is not None:
            runner.kill()
        p = self._procs.get(rid)
        if p is not None and p.poll() is None:
            p.kill()

    # -- client surface (in-process; FleetClient is the HTTP twin) --

    def submit(
        self,
        *,
        tenant: str,
        package: bytes,
        fingerprint: Optional[str] = None,
        tier: str = DEFAULT_TIER,
        weight: int = 1,
        qid: Optional[str] = None,
    ) -> str:
        qid = qid or f"f-{os.getpid()}-{next(self._seq)}"
        env = make_envelope(
            qid=qid, tenant=tenant, package=package,
            fingerprint=fingerprint, tier=tier, weight=weight,
        )
        self.mailbox.set_prop(
            FLEET_PID, f"rq/{qid}",
            pickle.dumps(env, protocol=pickle.HIGHEST_PROTOCOL),
        )
        return qid

    def result(self, qid: str, timeout: float = 60.0):
        got = self.mailbox.get_prop(FLEET_PID, f"res/{qid}", 0, timeout)
        if got is None:
            raise TimeoutError(f"fleet query {qid} unresolved in {timeout}s")
        header, table = decode_result(got[1])
        raise_for_result(header)
        return table

    def run(self, query, tenant: str, tier: str = DEFAULT_TIER,
            weight: int = 1, timeout: float = 60.0):
        """Pack, route, execute, and fetch — the one-call local path."""
        blob, fp = pack_for_fleet(query)
        qid = self.submit(
            tenant=tenant, package=blob, fingerprint=fp, tier=tier,
            weight=weight,
        )
        return self.result(qid, timeout=timeout)

    # -- observability --

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            inflight = len(self._inflight)
        return {
            "replicas": {
                rid: self._replica_stats(rid)
                for rid in self.replicas.alive()
            },
            "router": {
                "routed": self.routed,
                "delivered": self.delivered,
                "replayed": self.replayed,
                "failed": self.failed,
                "fast_rejects": self.memo.fast_rejects,
                "stale_results": self.stale_results,
                "in_flight": inflight,
                "generation": self.replicas.generation,
                "dead": self.replicas.dead(),
            },
        }

    def _replica_stats(self, rid: str) -> Optional[Dict[str, Any]]:
        got = self.mailbox.get_prop(FLEET_PID, f"stats/{rid}")
        if got is None:
            return None
        try:
            return pickle.loads(got[1])["stats"]
        except Exception:  # noqa: BLE001
            return None

    def replica_snapshots(self) -> List[Dict[str, Any]]:
        """The latest rolling-SLO snapshot each replica posted —
        ``tools.metricsd.merge_snapshots`` folds these into fleet
        percentiles (bucket-for-bucket, the only commutative fold)."""
        out = []
        for rid in self.replicas.alive() + self.replicas.dead():
            got = self.mailbox.get_prop(FLEET_PID, f"stats/{rid}")
            if got is None:
                continue
            try:
                out.append(pickle.loads(got[1])["snapshot"])
            except Exception:  # noqa: BLE001
                continue
        return out

    # -- shutdown --

    def close(self, timeout: float = 60.0) -> None:
        with self._cv:
            if self._closing:
                return
            self._closing = True
            self._cv.notify_all()
        # exit envelopes ride the same sequential cmd stream, so they
        # land AFTER everything already routed
        for rid in self.replicas.alive():
            try:
                self._post_cmd(rid, [{"exit": True}])
            except Exception:  # noqa: BLE001
                pass
        for rid, runner in self._runners.items():
            runner.stop(timeout=timeout)
        for rid, p in self._procs.items():
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        self._thread.join(timeout=10.0)
        self.mailbox.remove_watch(self._on_prop)
        self.service.close()

    def __enter__(self) -> "ServeFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- router internals --

    def _on_prop(self, pid: str, name: str, ver: int, value: bytes) -> None:
        """Mailbox watch — the router's wake signal.  Runs on whatever
        thread called set_prop (HTTP handler, replica thread, router
        itself); must only enqueue."""
        if pid != FLEET_PID:
            return
        if name.startswith("rq/"):
            item = ("rq", name[3:], value)
        elif name.startswith("res/"):
            item = ("res", name[4:], value)
        elif name.startswith("hb/"):
            item = ("hb", name[3:], ver)
        else:
            return
        with self._cv:
            self._queue.append(item)
            self._cv.notify_all()

    def _run(self) -> None:
        tick = max(0.05, self.hb_interval / 2.0)
        while True:
            with self._cv:
                if not self._queue:
                    if self._closing:
                        return
                    self._cv.wait(tick)
                drained = list(self._queue)
                self._queue.clear()
            batches: Dict[str, List[Dict]] = {}
            for kind, key, val in drained:
                try:
                    if kind == "rq":
                        self._route_one(key, val, batches)
                    elif kind == "res":
                        self._on_result(key, val)
                    else:
                        self.replicas.observe(key, val)
                except Exception:  # noqa: BLE001 — router must survive
                    log.exception("fleet router: %s/%s failed", kind, key)
            try:
                self._sweep_stale(batches)
            except Exception:  # noqa: BLE001
                log.exception("fleet router: staleness sweep failed")
            for rid, envs in batches.items():
                self._post_cmd(rid, envs)
            self._gc()

    def _fail(self, qid: str, tenant: str, message: str) -> None:
        self.failed += 1
        self.mailbox.set_prop(
            FLEET_PID, f"res/{qid}",
            encode_result(
                {
                    "qid": qid, "tenant": tenant, "ok": False,
                    "cached": False, "seconds": 0.0, "replica": None,
                    "generation": self.replicas.generation,
                    "error": message, "rejected": None,
                },
                None,
            ),
        )
        self._done_gc.append((time.monotonic(), qid))

    def _reject_fast(self, qid: str, tenant: str, memo: Dict) -> None:
        self.mailbox.set_prop(
            FLEET_PID, f"res/{qid}",
            encode_result(
                {
                    "qid": qid, "tenant": tenant, "ok": False,
                    "cached": False, "seconds": 0.0, "replica": None,
                    "generation": self.replicas.generation,
                    "error": None,
                    "rejected": {
                        "reason": memo.get("reason", "inflight"),
                        "limit": memo.get("limit", 0),
                        "current": memo.get("current", 0),
                    },
                },
                None,
            ),
        )
        self.events.emit(
            "fleet_rejected", tenant=tenant, query=qid,
            reason=memo.get("reason", "inflight"),
            limit=memo.get("limit"), current=memo.get("current"),
        )
        self._done_gc.append((time.monotonic(), qid))

    def _route_one(
        self, qid: str, blob: bytes, batches: Dict[str, List[Dict]]
    ) -> None:
        try:
            env = pickle.loads(blob)
            tenant = env["tenant"]
            check_tier(env.get("tier") or DEFAULT_TIER)
        except Exception as e:  # noqa: BLE001
            self._fail(qid, "?", f"malformed envelope: {e!r}")
            return
        memo = self.memo.check(tenant)
        if memo is not None:
            # negative-result memo: the tenant is hard-quota'd; fail
            # fast at the front door, no replica round trip
            self._reject_fast(qid, tenant, memo)
            return
        alive = self.replicas.alive()
        if not alive:
            self._fail(qid, tenant, "no replicas in the fleet")
            return
        fp = env.get("fingerprint") or package_fingerprint(env["package"])
        rid = rendezvous_rank(fp, alive)[0]
        env["generation"] = self.replicas.generation
        info = _InFlight(
            qid, rid, tenant, env.get("tier") or DEFAULT_TIER, fp,
            time.monotonic(),
        )
        self._inflight[qid] = info
        batches.setdefault(rid, []).append(env)
        self.routed += 1
        self.events.emit(
            "fleet_submit", tenant=tenant, query=qid, replica=rid,
            tier=info.tier, fingerprint=fp[:16],
        )

    def _post_cmd(self, rid: str, envs: List[Dict]) -> None:
        # latency-tier envelopes lead the batch: the replica submits in
        # batch order, so the front door's tier ordering is preserved
        # end to end (the replica's own scheduler then keeps it)
        envs.sort(
            key=lambda e: tier_rank(e.get("tier") or DEFAULT_TIER)
            if not e.get("exit") else len("zz")
        )
        seq = self._cmd_seq.get(rid, 0)
        self._cmd_seq[rid] = seq + 1
        members = {e["qid"] for e in envs if "qid" in e}
        if members:
            self._cmd_members[(rid, seq)] = members
            for e in envs:
                if "qid" in e and e["qid"] in self._inflight:
                    self._inflight[e["qid"]].cmd_key = (rid, seq)
        self.mailbox.set_prop(
            FLEET_PID, f"cmd/{rid}/{seq}",
            pickle.dumps(envs, protocol=pickle.HIGHEST_PROTOCOL),
        )

    def _retire_cmd(self, info: _InFlight) -> None:
        key = info.cmd_key
        if key is None:
            return
        members = self._cmd_members.get(key)
        if members is None:
            return
        members.discard(info.qid)
        if not members:
            del self._cmd_members[key]
            self.mailbox.del_prop(FLEET_PID, f"cmd/{key[0]}/{key[1]}")

    def _on_result(self, qid: str, blob: bytes) -> None:
        info = self._inflight.pop(qid, None)
        if info is None:
            # late post from a reaped replica after replay delivered —
            # harmless (deterministic engine: same bytes), just counted
            self.stale_results += 1
            return
        try:
            header = decode_result_header(blob)
        except Exception:  # noqa: BLE001
            header = {"ok": False, "error": "undecodable result"}
        rej = header.get("rejected")
        if rej is not None:
            self.memo.note_rejection(
                info.tenant, rej.get("reason", ""), dict(rej),
            )
        else:
            self.memo.note_completion(info.tenant)
        self.delivered += 1
        self._retire_cmd(info)
        self._done_gc.append((time.monotonic(), qid))
        self.events.emit(
            "fleet_result", tenant=info.tenant, query=qid,
            ok=bool(header.get("ok")),
            seconds=round(time.monotonic() - info.t0, 6),
            cached=bool(header.get("cached")),
            replica=header.get("replica"),
        )

    def _sweep_stale(self, batches: Dict[str, List[Dict]]) -> None:
        for rid in self.replicas.stale():
            victims = [
                info for info in self._inflight.values() if info.rid == rid
            ]
            gen = self.replicas.reap(rid)
            age = self.replicas.stale_after
            self.events.emit(
                "replica_dead", replica=rid, generation=gen,
                inflight=len(victims), stale_s=round(age, 3),
            )
            log.warning(
                "fleet: replica %s heartbeat stale; reaped (gen %d), "
                "replaying %d in-flight queries", rid, gen, len(victims),
            )
            alive = self.replicas.alive()
            for info in victims:
                self._retire_cmd(info)
                # the submit log IS the mailbox: replay the original
                # envelope bytes, so the rerun is bit-for-bit the same
                # submission
                got = self.mailbox.get_prop(FLEET_PID, f"rq/{info.qid}")
                if got is None or not alive:
                    del self._inflight[info.qid]
                    self._fail(
                        info.qid, info.tenant,
                        f"replica {rid} died"
                        + ("; no submit log" if got is None
                           else "; no replicas left"),
                    )
                    continue
                env = pickle.loads(got[1])
                env["generation"] = gen
                new_rid = rendezvous_rank(info.fingerprint, alive)[0]
                info.rid = new_rid
                info.replays += 1
                self.replayed += 1
                batches.setdefault(new_rid, []).append(env)
                self.events.emit(
                    "fleet_reroute", tenant=info.tenant, query=info.qid,
                    from_replica=rid, to_replica=new_rid,
                )

    def _gc(self) -> None:
        now = time.monotonic()
        while self._done_gc and now - self._done_gc[0][0] > self.res_gc_s:
            _, qid = self._done_gc.popleft()
            self.mailbox.del_prop(FLEET_PID, f"res/{qid}")
            self.mailbox.del_prop(FLEET_PID, f"rq/{qid}")


# -- HTTP client ------------------------------------------------------------


class FleetClient:
    """A tenant's HTTP handle on the fleet front door.  Import-light by
    design (stdlib + cluster transport only): closed-loop bench client
    processes submit pre-packed envelopes without paying an engine
    import."""

    def __init__(
        self,
        host: str,
        port: int,
        tenant: str,
        tier: str = DEFAULT_TIER,
        weight: int = 1,
    ):
        self.tenant = tenant
        self.tier = check_tier(tier)
        self.weight = weight
        self._sc = ServiceClient(host, port)
        # sha-derived client nonce — qids must be unique fleet-wide and
        # PYTHONHASHSEED-independent
        self._nonce = os.urandom(6).hex()
        self._seq = itertools.count(1)

    def submit_package(
        self,
        package: bytes,
        fingerprint: Optional[str] = None,
        qid: Optional[str] = None,
    ) -> str:
        qid = qid or f"{self.tenant}-{self._nonce}-{next(self._seq)}"
        env = make_envelope(
            qid=qid, tenant=self.tenant, package=package,
            fingerprint=fingerprint, tier=self.tier, weight=self.weight,
        )
        self._sc.set_prop(
            FLEET_PID, f"rq/{qid}",
            pickle.dumps(env, protocol=pickle.HIGHEST_PROTOCOL),
        )
        return qid

    def submit_query(self, query, qid: Optional[str] = None) -> str:
        blob, fp = pack_for_fleet(query)
        return self.submit_package(blob, fingerprint=fp, qid=qid)

    def result(self, qid: str, timeout: float = 60.0):
        got = self._sc.get_prop(FLEET_PID, f"res/{qid}", 0, timeout)
        if got is None:
            raise TimeoutError(f"fleet query {qid} unresolved in {timeout}s")
        header, table = decode_result(got[1])
        raise_for_result(header)
        return table

    def result_header(self, qid: str, timeout: float = 60.0) -> Dict:
        """Latency-probe variant: wait for the result but decode only
        the header (no table deserialization on the client)."""
        got = self._sc.get_prop(FLEET_PID, f"res/{qid}", 0, timeout)
        if got is None:
            raise TimeoutError(f"fleet query {qid} unresolved in {timeout}s")
        return decode_result_header(got[1])

    def run(self, query, timeout: float = 60.0):
        return self.result(self.submit_query(query), timeout=timeout)
