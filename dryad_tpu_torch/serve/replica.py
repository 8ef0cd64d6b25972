"""Engine-replica subprocess entry — ``python -m dryad_tpu_torch.serve.replica``.

One fleet replica as its own OS process: builds a DryadContext from a
bootstrap file (so the parent decides mesh shape, backend, and data
loading without this module knowing), wraps it in a QueryService, and
serves the front door's ``cmd/<rid>/<seq>`` prop stream until the exit
envelope arrives.

The bootstrap file is plain python defining ``build_context() ->
DryadContext`` (and optionally ``prepare(ctx)`` for table ingest).  It
runs INSIDE the replica process — the whole point of process replicas
is that each one owns its runtime, its CUDA context, its device tables
and its operand pools, so no device state crosses the process
boundary.  A bootstrap's ``DryadContext()`` runs on the card; it runs
on the CPU only when the bootstrap passes ``device="cpu"``.  Several
replicas may share one card, each with its own CUDA context.

``--fault`` takes a FaultPlan JSON (see :mod:`dryad_tpu_torch.exec.faults`)
and arms the seeded chaos hook: the replica may ``os._exit`` at a
command-batch boundary, mid-query, with no cleanup — the way a machine
dies — which is what the router's heartbeat reaping and submit-log
replay exist to absorb.
"""

from __future__ import annotations

import argparse
import json
import runpy
import sys

from dryad_tpu_torch.serve.fleet import ReplicaRunner
from dryad_tpu_torch.utils.logging import get_logger

log = get_logger("dryad_tpu_torch.serve.replica")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dryad_tpu_torch.serve.replica")
    ap.add_argument("--host", required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--rid", required=True, help="replica id")
    ap.add_argument(
        "--bootstrap", required=True,
        help="python file defining build_context() (and optionally "
        "prepare(ctx))",
    )
    ap.add_argument("--hb-interval", type=float, default=0.25)
    ap.add_argument(
        "--fault", default=None,
        help="FaultPlan JSON for seeded chaos kills",
    )
    args = ap.parse_args(argv)

    if args.fault:
        from dryad_tpu_torch.exec import faults

        plan = json.loads(args.fault)
        faults.install_plan(faults.FaultPlan(**plan))

    ns = runpy.run_path(args.bootstrap)
    build_context = ns.get("build_context")
    if build_context is None:
        log.error("bootstrap %s defines no build_context()", args.bootstrap)
        return 2
    prepare = ns.get("prepare")

    def factory():
        ctx = build_context()
        if prepare is not None:
            prepare(ctx)
        return ctx

    runner = ReplicaRunner(
        args.rid, args.host, args.port, factory,
        hb_interval=args.hb_interval, allow_process_exit=True,
    )
    log.info("replica %s serving %s:%d", args.rid, args.host, args.port)
    runner.run_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
