"""Worker process for N-process local jobs — the VertexHost analog
(``dryad_tpu/cluster/worker.py``).

The reference's worker node runs a long-lived daemon whose children poll
a versioned property mailbox for a ``DVertexCommand``, execute the
vertex, and post ``DVertexStatus`` back (``dvertexpncontrol.h:38-70``;
mailbox ``ProcessService.cs:42-126``).  This worker:

1. opens its device (``--device``, CUDA unless the submission names the
   CPU).  A worker that cannot open it announces the reason and answers
   every vertex command with a failed status carrying it; it never goes
   on on the CPU;
2. announces itself on the driver's ProcessService control plane
   (membership with its device, heartbeats; ``parallel/multihost.py``);
3. loops on its ``cmd/<pid>`` mailbox property: ``run`` runs the
   packaged plan as one program across the gang: every worker holds
   ``--devices-per-proc`` of the ``nproc * devices-per-proc``
   partitions on its device, the plan's collectives cross processes
   through the gang's ``torch.distributed`` group (joined at the first
   gang command, ``parallel/multihost.py::init_distributed``: vertex
   tasks need none), and each worker writes the partitions it owns as
   ``part<gid>.dpf`` (worker 0 also the ``dictionary.pkl``) between a
   start and a done barrier; ``runbatch`` runs a list of ``run``
   sub-commands back to back under one aggregated status (posted to
   the envelope's own status key when the driver's dispatch window
   sent it, after acknowledging the dequeue); ``runpart`` runs the
   packaged plan over one input partition of ``nparts`` in a
   one-partition context on its device and writes the valid rows as a
   partition file (``part<p>.dpf``); ``runcoded`` runs the plan over a
   coded vertex's support and writes the coded partial
   (``cpart<j>.dpf``); ``combineparts`` folds the partial state of the
   parts this worker won (level -1 of the combine tree); ``set_fault``
   and ``set_delay`` inject faults; ``exit`` ends the loop.  Each
   status is posted to ``status/<pid>`` after the worker's telemetry
   (spans, the job context's events, and the hand kernels' launch
   counts as a ``metrics`` event) was shipped.

Run as ``python -m dryad_tpu_torch.cluster.worker --service-port P
--job J --pid I --nproc N --devices-per-proc K --coordinator H:P
--root DIR [--device cuda|cpu] [--timeout S]`` (spawned by
``cluster.localjob.LocalJobSubmission``).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import tempfile
import time
import traceback
from typing import Dict, Optional

from dryad_tpu_torch.obs import tracectx

def _open_device(name: str):
    """``(torch.device, description)`` for the worker's device; raises
    when it cannot be used (no CUDA, a bad ordinal)."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.zeros(1, device=dev)  # opens the context: fail here, not mid-task
        return dev, torch.cuda.get_device_name(dev)
    return dev, dev.type


class _PackageCache:
    """Per-process cache of loaded job packages for vertex tasks.

    A ``runpart`` stream re-uses one loaded plan + context across
    partitions — the reference's VertexHost similarly keeps the vertex
    DLL loaded across vertex executions.  ``flush``: ships the worker's
    telemetry, called right after a fetch, so the ``fetch_package`` span
    reaches the driver before the job's result, even when this task
    itself loses to a duplicate and ends after the job returned."""

    def __init__(self, device=None, tracer=None, flush=None) -> None:
        from dryad_tpu_torch.obs.span import Tracer

        self.key: str = ""
        self.query = None
        self.pristine: Dict = {}
        self.device = device
        self.tracer = tracer if tracer is not None else Tracer(None)
        self.flush = flush

    def load(self, rel: str, client):
        if self.key == rel and self.query is not None:
            return self.query, self.pristine
        from dryad_tpu_torch.exec.jobpackage import load_query
        from dryad_tpu_torch.parallel.mesh import PartitionMesh

        # the whole package crosses the driver's file server once per
        # worker and job
        pkg_path = _fetch_package(rel, client, self.tracer)
        if self.flush is not None:
            self.flush()
        try:
            # Vertex tasks run as ONE partition on this worker's device:
            # independent work, not the gang's mesh (DrStorageVertex-style
            # per-partition channels, not cohort collectives).
            q = load_query(pkg_path, mesh=PartitionMesh(1, self.device))
        finally:
            os.unlink(pkg_path)
        self.key = rel
        self.query = q
        self.pristine = dict(q.ctx._bindings)
        return q, self.pristine


def _rebind(q, pristine: Dict, part: int, nparts: int) -> None:
    from dryad_tpu_torch.exec.jobpackage import slice_binding

    for nid, binding in pristine.items():
        q.ctx._bindings[nid] = slice_binding(binding, part, nparts)
    # rebinding invalidates cached binding fingerprints — a stale part-0
    # fingerprint would make checkpointing restore part 0 for every part
    q.ctx._binding_fp_cache.clear()


def _run_part(cmd: Dict, args, client, pkgs: _PackageCache,
              pcache=None) -> Dict:
    """Execute ONE vertex task: the plan restricted to input partition
    ``part`` of ``nparts``, on this worker's device, writing the result
    as a partition file (the independent re-executable vertex of the
    reference, ``DrVertex.h:49`` — duplicate-safe: every attempt
    writes identical bytes and the rename is atomic)."""
    from dryad_tpu_torch.cluster.partcache import content_fp
    from dryad_tpu_torch.columnar.io import write_partition_file

    q, pristine = pkgs.load(cmd["package"], client)
    part, nparts = int(cmd["part"]), int(cmd["nparts"])
    _rebind(q, pristine, part, nparts)
    batch = q.ctx.execute(q)
    host = batch.fetch_valid_rows()
    cols = {c: host[c] for c in sorted(host)}
    out_dir = os.path.join(args.root, cmd["result_dir"])
    os.makedirs(out_dir, exist_ok=True)
    final = os.path.join(out_dir, f"part{part}.dpf")
    tmp = f"{final}.w{args.pid}.tmp"
    write_partition_file(tmp, cols)
    # fingerprint the serialized bytes BEFORE the rename (duplicates
    # write identical bytes, so every attempt reports the same fp) and
    # keep them resident: a later combineparts naming this partition by
    # fp reads it from memory instead of the job root
    with open(tmp, "rb") as fh:
        blob = fh.read()
    fp = content_fp(blob)
    os.replace(tmp, final)
    if pcache is not None:
        pcache.put(fp, blob)
    return {"state": "completed", "parts": [part], "fp": fp}


def _combine_parts(cmd: Dict, args, client, pkgs: _PackageCache,
                   pcache=None, wlog=None) -> Dict:
    """Level -1 of the combine tree: fold the un-finalized partial STATE
    of the vertex parts THIS worker won into one partial table
    (``exec.partial.merge_state_rows``) before anything ships to the
    driver (``DrDynamicAggregateManager.h:117-168`` pushed into the
    worker).  Ships one ``wpart<w>.dpf`` plus a KeyRangeHistogram
    snapshot over deterministic key hashes (``exec.partial.key_hash64``:
    snapshots must mean the same ranges in every process).  Part bytes
    resolve through the :class:`~dryad_tpu_torch.cluster.partcache.PartitionCache`
    by content fingerprint, else from the job root."""
    import numpy as np

    from dryad_tpu_torch.cluster.partcache import content_fp
    from dryad_tpu_torch.columnar.batch import decode_physical_table
    from dryad_tpu_torch.columnar.io import (
        parse_partition_bytes,
        write_partition_file,
    )
    from dryad_tpu_torch.exec import faults
    from dryad_tpu_torch.exec.partial import key_hash64, merge_state_rows
    from dryad_tpu_torch.obs.metrics import KeyRangeHistogram

    faults.registry.maybe_fail("combineparts")
    if faults.registry.maybe_kill("combineparts"):
        # mid-level-(-1) chaos: the process dies between winning its
        # parts and shipping the folded partial — the driver falls back
        # to flat assembly (the part files are durable)
        from dryad_tpu_torch.obs import flightrec

        if wlog is not None:
            wlog.emit(
                "worker_killed_injected", stage=-1, name="combineparts"
            )
        flightrec.dump_now("worker_killed:combineparts")
        os._exit(113)

    q, _pristine = pkgs.load(cmd["package"], client)
    keys = list(cmd["keys"])
    red = dict(cmd["red"])
    tables = []
    read_bytes = 0
    hits = misses = 0
    for spec in cmd["parts"]:
        blob = None
        fp = spec.get("fp")
        if pcache is not None and fp:
            blob = pcache.get(fp)
        if blob is None:
            misses += 1
            blob = client.read_whole_file(
                f"{cmd['result_dir']}/part{spec['part']}.dpf"
            )
            read_bytes += len(blob)
            if pcache is not None:
                pcache.put(fp or content_fp(blob), blob)
        else:
            hits += 1
        host = parse_partition_bytes(blob)
        # decode to logical columns WITHOUT the dictionary: string keys
        # stay raw Hash64 codes (cross-process deterministic), so the
        # fold groups on codes and the driver decodes once at assembly
        tables.append(
            decode_physical_table(q.schema, slice(None), host, None)
        )
    cols = {c: np.concatenate([t[c] for t in tables]) for c in tables[0]}
    in_rows = int(len(next(iter(cols.values()), [])))
    merged = merge_state_rows(cols, keys, red)
    out_rows = int(len(merged[keys[0]])) if keys else 0
    kr = KeyRangeHistogram(int(cmd.get("ranges", 64) or 64))
    if keys and out_rows:
        kr.observe(key_hash64(merged, keys))
    out_dir = os.path.join(args.root, cmd["result_dir"])
    os.makedirs(out_dir, exist_ok=True)
    wname = f"wpart{int(cmd['wid'])}.dpf"
    final = os.path.join(out_dir, wname)
    tmp = f"{final}.w{args.pid}.tmp"
    write_partition_file(tmp, merged)
    with open(tmp, "rb") as fh:
        out_blob = fh.read()
    out_fp = content_fp(out_blob)
    os.replace(tmp, final)
    if pcache is not None:
        pcache.put(out_fp, out_blob)
    snap = {
        k: (v.tolist() if hasattr(v, "tolist") else v)
        for k, v in kr.snapshot().items()
    }
    return {
        "state": "completed", "wfile": wname, "fp": out_fp,
        "parts": [int(s["part"]) for s in cmd["parts"]],
        "rows": out_rows, "in_rows": in_rows,
        "bytes": len(out_blob), "read_bytes": read_bytes,
        "cache_hits": hits, "cache_misses": misses,
        "snapshot": snap,
    }


def _run_coded(cmd: Dict, args, client, pkgs: _PackageCache) -> Dict:
    """Execute ONE CODED vertex (``dryad_tpu_torch.redundancy``): run
    the partial plan over each shard in the vertex's support, linearly
    combine the partial tables with the generator coefficients
    (``exec.partial.coded_combine`` — exact int64 for integer states),
    and write the coded partial as ``cpart<j>.dpf``.  A systematic
    vertex (support of one shard, coefficient 1) does exactly one
    shard's work; a parity vertex pays the full-support redundancy
    work that buys any-k-of-n reconstruction."""
    from dryad_tpu_torch.columnar.io import write_partition_file
    from dryad_tpu_torch.exec.partial import coded_combine

    q, pristine = pkgs.load(cmd["package"], client)
    nparts = int(cmd["nparts"])
    tables = []
    for part in cmd["parts"]:
        _rebind(q, pristine, int(part), nparts)
        batch = q.ctx.execute(q)
        tables.append(batch.to_numpy(q.schema, q.ctx.dictionary))
    combined = coded_combine(
        tables, [int(c) for c in cmd["coeffs"]],
        list(cmd["keys"]), list(cmd["state"]),
    )
    out_dir = os.path.join(args.root, cmd["result_dir"])
    os.makedirs(out_dir, exist_ok=True)
    j = int(cmd["coded"])
    final = os.path.join(out_dir, f"cpart{j}.dpf")
    tmp = f"{final}.w{args.pid}.tmp"
    write_partition_file(tmp, combined)
    os.replace(tmp, final)
    return {"state": "completed", "coded": [j]}


def _absorb_ctx_events(wlog, ctx) -> None:
    """Move the job context's engine events (stage spans and events)
    into the worker's telemetry log so they ship to the driver with
    the next batch."""
    if wlog is None or ctx is None:
        return
    for ev in ctx.events.drain():
        wlog.absorb(ev)


def _fetch_package(rel: str, client, tracer) -> str:
    """The package through the driver's file server (the managed-channel
    read path), as a local temporary file; its seconds are the
    ``fetch_package`` span."""
    with tracer.span("fetch_package", cat="worker", package=rel) as sp:
        blob = client.read_whole_file(rel)
        sp.add(bytes=len(blob))
    with tempfile.NamedTemporaryFile(suffix=".pkg", delete=False) as fh:
        fh.write(blob)
        return fh.name


def _join_gang(args) -> None:
    """Join the gang's process group (idempotent): at the first gang
    command, when every member is about to run the same program."""
    from dryad_tpu_torch.parallel.multihost import init_distributed

    init_distributed(args.coordinator, args.nproc, args.pid, device=args.device,
                     timeout=args.timeout)


def _run_command(cmd: Dict, args, client, cp, device, wtracer, wlog=None) -> Dict:
    """Execute one ``run`` command: fetch the package, run the plan as
    one program over the gang's mesh, write the owned result
    partitions."""
    from dryad_tpu_torch.columnar.io import write_partition_file
    from dryad_tpu_torch.exec.jobpackage import load_query
    from dryad_tpu_torch.parallel.mesh import make_mesh

    import torch

    _join_gang(args)
    pkg_path = _fetch_package(cmd["package"], client, wtracer)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    try:
        mesh = make_mesh(args.nproc * args.devices_per_proc, device)
        q = load_query(pkg_path, mesh=mesh)
        ctx = q.ctx
        # Everyone present before ingest: a member joining mid-collective
        # would stall the gang, so gate here where the failure is a clean
        # timeout instead (DrStartClique semantics).
        cp.barrier(f"start/{cmd['seq']}", args.nproc)
        batch = ctx.execute(q)
        host, counts = batch.fetch_valid_rows(with_counts=True)
        bounds = [0]
        for c in counts:
            bounds.append(bounds[-1] + int(c))
        out_dir = os.path.join(args.root, cmd["result_dir"])
        os.makedirs(out_dir, exist_ok=True)
        # each local partition IS one owned partition of the global mesh
        parts = []
        for j in range(mesh.local):
            gid = mesh.base + j
            cols = {c: host[c][bounds[j]:bounds[j + 1]] for c in sorted(host)}
            write_partition_file(os.path.join(out_dir, f"part{gid}.dpf"), cols)
            parts.append(gid)
        if args.pid == 0:
            # The dictionary is built at ingest (identically in every
            # worker); ship one copy so the driver can decode strings.
            with open(os.path.join(out_dir, "dictionary.pkl"), "wb") as fh:
                pickle.dump(dict(ctx.dictionary._map), fh)
        # All partitions durable before anyone reports success: the
        # driver may start reading as soon as one status arrives.
        cp.barrier(f"done/{cmd['seq']}", args.nproc)
        _absorb_ctx_events(wlog, ctx)
        if wlog is not None:
            # what this run handed to the group, and its device peak
            labels = {"backend": mesh.backend or "none"}
            counters = [{"name": "collective_bytes", "labels": labels, "value": mesh.sent_bytes}]
            if on_card:
                counters.append({"name": "device_peak_bytes", "labels": labels,
                                 "value": int(torch.cuda.max_memory_allocated(device))})
            wlog.emit("metrics", counters=counters, hists=[])
        return {"state": "completed", "parts": parts}
    finally:
        os.unlink(pkg_path)


def _ship_launches(wlog, shipped: Dict[str, int]) -> None:
    """Log the hand kernels' launches since the last shipment as one
    ``metrics`` event (counter ``kernel_launches`` labelled by kernel):
    the launches happen in this process, and the driver sums them from
    the telemetry it absorbs."""
    from dryad_tpu_torch.ops.bucket import bucket_sum_count

    now = {"bucket_sum_count": int(bucket_sum_count.launches)}
    counters = []
    for name, n in now.items():
        delta = n - shipped.get(name, 0)
        if delta:
            counters.append({
                "name": "kernel_launches", "labels": {"kernel": name},
                "value": delta,
            })
        shipped[name] = n
    if counters:
        wlog.emit("metrics", counters=counters, hists=[])


def _resolve_pcache(pstate: Dict, cmd: Dict, args):
    """Lazily build this worker's :class:`PartitionCache` the first time
    a command carries a ``cache_bytes`` budget (the driver forwards
    ``config.gang_partition_cache_bytes``); a zero/absent budget runs
    the command cache-less without disturbing an existing cache."""
    budget = int(cmd.get("cache_bytes", 0) or 0)
    if budget <= 0:
        return None
    pc = pstate.get("pcache")
    if pc is None:
        from dryad_tpu_torch.cluster.partcache import PartitionCache

        pc = PartitionCache(
            budget,
            spill_dir=os.path.join(args.root, f".pcache-w{args.pid}"),
        )
        pstate["pcache"] = pc
    return pc


def _exec_one(cmd: Dict, args, client, cp, pkgs, delay, wtracer, wlog,
              pstate=None, device_error: Optional[str] = None) -> Dict:
    """Execute one run/runpart/runcoded/combineparts command and return
    its status dict (no cseq — the caller stamps the mailbox echo).
    Failures are reported per command: a failed status carries the
    error, and the worker keeps serving; once a gang run failed in a
    collective (:class:`GangStageError`), every later gang run fails
    at once, because the group's ranks may be out of step."""
    from dryad_tpu_torch.parallel.stage import GangStageError

    pstate = pstate if pstate is not None else {}
    try:
        if device_error is not None:
            raise RuntimeError(device_error)
        # Re-activate the query's trace context from the mailbox
        # envelope: every span this command produces (and the engine
        # events absorbed from the job context) ships back qid-stamped.
        with tracectx.activate(
            tracectx.TraceContext.from_wire(cmd.get("trace"))
        ), wtracer.span(
            cmd["kind"], cat="worker", seq=cmd.get("seq"),
            part=cmd.get("part", cmd.get("coded")),
        ):
            if cmd["kind"] in ("runpart", "runcoded"):
                # injected straggler applies to coded vertices too, so
                # coded-vs-duplicate comparisons stall the same way
                if delay["count"] > 0:
                    delay["count"] -= 1
                    time.sleep(delay["seconds"])
                status = (
                    _run_part(cmd, args, client, pkgs,
                              pcache=_resolve_pcache(pstate, cmd, args))
                    if cmd["kind"] == "runpart"
                    else _run_coded(cmd, args, client, pkgs)
                )
                _absorb_ctx_events(
                    wlog,
                    pkgs.query.ctx if pkgs.query is not None else None,
                )
            elif cmd["kind"] == "combineparts":
                status = _combine_parts(
                    cmd, args, client, pkgs,
                    pcache=_resolve_pcache(pstate, cmd, args), wlog=wlog,
                )
            else:
                if pstate.get("out_of_step"):
                    # no collective may run on a group whose ranks
                    # diverged: the driver restarts the gang
                    raise GangStageError(
                        "the gang's group is out of step since "
                        f"{pstate['out_of_step']}; the gang must be rebuilt"
                    )
                status = _run_command(cmd, args, client, cp, pkgs.device, wtracer, wlog=wlog)
    except Exception as e:  # noqa: BLE001 — report, keep serving
        traceback.print_exc()
        if isinstance(e, GangStageError) and not pstate.get("out_of_step"):
            pstate["out_of_step"] = str(e)
        info = {"error": f"{type(e).__name__}: {e}", "cmd": cmd}
        cp.report_failure(info)
        status = {"state": "failed", "error": info["error"]}
    return status


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--service-host", default="127.0.0.1")
    ap.add_argument("--service-port", type=int, required=True)
    ap.add_argument("--job", required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--devices-per-proc", type=int, default=1,
                    help="partitions this worker holds in a gang")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of the gang's process group (rank 0 hosts it)")
    ap.add_argument("--root", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds a gang collective may wait for its peers")
    args = ap.parse_args(argv)

    from dryad_tpu_torch.cluster.service import ServiceClient
    from dryad_tpu_torch.parallel.multihost import ControlPlane, local_index, rank_device

    if args.coordinator and args.nproc > 1:
        # a gang member's device is the one its rank takes in the group
        args.device = str(rank_device(args.device, *local_index(args.pid, args.nproc)))

    client = ServiceClient(args.service_host, args.service_port)
    cp = ControlPlane(args.job, args.pid, client=client)
    # the device first: a worker that cannot reach it says why, and
    # every vertex command it is sent fails with that reason
    device = None
    device_error = None
    meta = {"ospid": os.getpid(), "device": args.device}
    try:
        device, desc = _open_device(args.device)
        meta.update(device=str(device), device_name=desc)
    except Exception as e:  # noqa: BLE001 — reported, never a fallback
        device_error = (
            f"worker {args.pid} cannot open device {args.device!r}: "
            f"{type(e).__name__}: {e}"
        )
        meta["device_error"] = device_error
        print(device_error, file=sys.stderr, flush=True)
    cp.announce(meta)
    cp.start_heartbeat()

    # Worker-local telemetry: spans around command execution plus the
    # job context's engine events and the kernels' launch counts,
    # shipped to the driver through the ControlPlane mailbox after
    # every command.
    from dryad_tpu_torch.exec.events import EventLog
    from dryad_tpu_torch.obs.span import Tracer

    wlog = EventLog(None, mem_cap=8192)
    wtracer = Tracer(wlog)

    # Flight recorder: the worker's ring survives what telemetry
    # shipping cannot — a process death takes un-shipped events with
    # it, so the ring dumps to the SHARED job root
    # (blackbox-<ospid>.json) on any exit, the chaos os._exit path
    # included (dumped explicitly before _exit).
    from dryad_tpu_torch.obs import flightrec

    flightrec.install_recorder(
        capacity=2048,
        snapshot_s=1.0,
        dump_dir=os.path.join(args.root, "blackbox"),
        role=f"worker-{args.pid}",
        worker=args.pid,
        events=wlog,
        atexit_dump=True,
        signals=True,
    )
    flightrec.get_recorder().set_info(job=args.job, nproc=args.nproc)

    after = 0
    def flush() -> None:
        try:
            cp.ship_telemetry(wlog.drain())
        except Exception:  # noqa: BLE001 — telemetry is best-effort
            pass

    pkgs = _PackageCache(device=device, tracer=wtracer, flush=flush)
    pstate: Dict = {}  # lazy PartitionCache
    shipped: Dict[str, int] = {}  # kernel launches already shipped
    delay = {"seconds": 0.0, "count": 0}  # injected straggler behavior
    while True:
        got = client.get_prop(args.job, f"cmd/{args.pid}", after, timeout=2.0)
        if got is None:
            continue
        after, body = got
        cmd = json.loads(body)
        # Every status echoes the command's unique id ("cseq") so the
        # driver can discard stale statuses from a command it already
        # gave up on.
        cseq = cmd.get("cseq")
        if cmd.get("ack"):
            # Windowed envelope: acknowledge the DEQUEUE itself, before
            # executing — the command mailbox is a latest-value slot,
            # and the overlapped feed may only overwrite it once this
            # envelope has provably left it.
            try:
                client.set_prop(args.job, str(cmd["ack"]), b"1")
            except Exception:  # noqa: BLE001 — driver timeout surfaces it
                pass
        if cmd["kind"] == "exit":
            client.set_prop(
                args.job, f"status/{args.pid}",
                json.dumps({"state": "exited", "cseq": cseq}).encode(),
            )
            cp.stop_heartbeat()
            return 0
        if cmd["kind"] == "set_fault":
            # Remote fault injection (SetFakeVertexFailure over the
            # command mailbox); a seeded FaultPlan may carry
            # worker_kill_prob process kills.
            from dryad_tpu_torch.exec import faults

            if cmd.get("plan"):
                faults.install_plan(faults.FaultPlan(**cmd["plan"]))
            elif cmd.get("stage"):
                faults.set_fake_stage_failure(
                    cmd["stage"], int(cmd.get("count", 1))
                )
            else:
                faults.clear_faults()
            client.set_prop(
                args.job, f"status/{args.pid}",
                json.dumps({"state": "fault_set", "cseq": cseq}).encode(),
            )
            continue
        if cmd["kind"] == "set_delay":
            # Injected straggler: the next ``count`` vertex tasks on
            # THIS worker stall ``seconds`` before executing — the
            # slow-machine scenario speculative duplication exists for
            # (``DrStageStatistics.cpp:93`` outlier model).
            delay["seconds"] = float(cmd.get("seconds", 0.0))
            delay["count"] = int(cmd.get("count", 0))
            client.set_prop(
                args.job, f"status/{args.pid}",
                json.dumps({"state": "delay_set", "cseq": cseq}).encode(),
            )
            continue
        if cmd["kind"] == "runbatch":
            # Batched command stream: execute the sub-commands back to
            # back and ship ONE aggregated status — K mailbox round trips
            # become one (the cseq echo covers the batch).  A failed
            # sub-command does NOT stop the batch: every gang member runs
            # the same list in the same order, keeping the per-command
            # start/done barriers aligned, and the per-command statuses
            # keep their failure.
            results = []
            first_error = None
            for sub in cmd["cmds"]:
                # the envelope's trace context covers sub-commands that
                # carry none of their own
                if cmd.get("trace") and not sub.get("trace"):
                    sub["trace"] = cmd["trace"]
                sub_t0 = time.perf_counter()
                st = _exec_one(sub, args, client, cp, pkgs, delay, wtracer, wlog,
                               pstate=pstate, device_error=device_error)
                # each sub-command's own wall clock, for the driver's
                # per-plan duration models
                st["seconds"] = round(time.perf_counter() - sub_t0, 6)
                results.append(st)
                if st.get("state") == "failed" and first_error is None:
                    first_error = st.get("error")
            status = {"state": "failed" if first_error else "completed", "results": results}
            if first_error:
                status["error"] = first_error
        elif cmd["kind"] in ("run", "runpart", "runcoded", "combineparts"):
            status = _exec_one(cmd, args, client, cp, pkgs, delay,
                               wtracer, wlog, pstate=pstate,
                               device_error=device_error)
        else:
            continue  # unknown command kind: ignore, keep serving
        # telemetry ships BEFORE the status post: the driver drains
        # right after it sees the status, so shipping after would race
        # the batch against the drain
        try:
            _ship_launches(wlog, shipped)
            cp.ship_telemetry(wlog.drain())
        except Exception:  # noqa: BLE001 — telemetry is best-effort
            pass
        status["cseq"] = cseq
        client.set_prop(
            args.job, cmd.get("skey") or f"status/{args.pid}",
            json.dumps(status).encode(),
        )


if __name__ == "__main__":
    sys.exit(main())
