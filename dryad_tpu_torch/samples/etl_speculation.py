"""ETL with independent vertex tasks + speculative duplication
(``samples/etl_speculation.py``).

A partition-local plan runs as independent, re-executable vertices over
a two-process local cluster (``cluster/localjob.py``), with the
speculative-duplication machinery live: one worker is given an injected
stall, the duration model flags the outlier, the task duplicates to the
fast worker and the first completion wins.  Prints the per-vertex
drill-down (``tools/jobview.py``) showing the duplication story.

Run:
    python -m dryad_tpu_torch.samples.etl_speculation [--device cpu]
"""

import numpy as np

from dryad_tpu_torch import DryadContext
from dryad_tpu_torch.cluster.localjob import LocalJobSubmission
from dryad_tpu_torch.samples import parser
from dryad_tpu_torch.tools.jobview import build_vertex_jobs, render_vertex_job


def keep_paid(cols):
    # module-level: the plan ships to workers by pickle
    return cols["amount"] > 0


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    rng = np.random.default_rng(0)
    n = 20_000
    tbl = {
        "user": rng.integers(0, 5_000, n).astype(np.int32),
        "amount": rng.normal(10.0, 30.0, n).astype(np.float32),
    }

    with LocalJobSubmission(num_workers=2, device=args.device or "cuda") as sub:
        ctx = DryadContext(num_partitions_=1, device=args.device)
        q = ctx.from_arrays(tbl).where(keep_paid).project(["user", "amount"])

        # 8 vertex tasks over 2 workers: enough completions for the
        # duration model (MIN_SAMPLES=3) to flag the stalled outlier
        sub.submit_partitioned(q, nparts=8)  # warm worker caches
        # make worker 1 a straggler for its next vertex task
        sub.inject_delay(worker=1, seconds=6.0, count=1)
        out = sub.submit_partitioned(q, nparts=8)

        kept = int((tbl["amount"] > 0).sum())
        assert len(out["user"]) == kept
        print(f"kept {kept}/{n} rows\n")
        for vj in build_vertex_jobs(sub.events.events()):
            print(render_vertex_job(vj))
            print()


if __name__ == "__main__":
    main()
