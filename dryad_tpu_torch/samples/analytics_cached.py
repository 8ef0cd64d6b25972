"""Interactive-analytics shape (``samples/analytics_cached.py``):
materialize one aggregate with ``cache()`` (the reference's temp-table
pattern, kept in device memory, not the DFS), then branch several
queries from it without recomputing; persist one branch to a DFS-scheme
store through the file-plane gateway.

The STRING group_by underneath rides the auto-dense path (dictionary
codes, no shuffle, the bucket kernel); ``explain`` shows the
shuffle-free stage.

Run:
    python -m dryad_tpu_torch.samples.analytics_cached [--device cpu]
"""

import os
import tempfile

import numpy as np

from dryad_tpu_torch import DryadContext
from dryad_tpu_torch.cluster.service import ProcessService
from dryad_tpu_torch.samples import parser
from dryad_tpu_torch.tools.explain import explain


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    rng = np.random.default_rng(0)
    n = 100_000
    users = np.array([f"user{int(i):04d}" for i in rng.integers(0, 2000, n)], object)
    spend = (rng.gamma(2.0, 10.0, n)).astype(np.float32)

    ctx = DryadContext(num_partitions_=8, device=args.device)
    events = ctx.from_arrays({"user": users, "spend": spend})

    per_user = events.group_by("user", {"total": ("sum", "spend"), "visits": ("count", None)})
    print(explain(per_user))

    agg = per_user.cache()  # one execution, resident on the device

    # three branches, zero recomputation of the aggregate
    top = agg.order_by([("total", True)]).take(5).collect()
    print("\ntop spenders:")
    for u, t, v in zip(top["user"], top["total"], top["visits"]):
        print(f"  {u}: {t:9.2f} over {int(v)} visits")

    whales = agg.where(lambda c: c["total"] > 500.0).count()
    # single-column distinct = the vocabulary query (dense path too)
    vocab = events.project(["user"]).distinct()
    print(f"\nusers over 500.0 total: {whales}")
    print(f"distinct users: {len(vocab.collect()['user'])}")

    # persist one branch through a DFS-scheme URI (a local ProcessService
    # stands in for the gateway; set DRYAD_TPU_DFS_GATEWAY in real use)
    with tempfile.TemporaryDirectory() as root, ProcessService(root) as svc:
        os.environ["DRYAD_TPU_DFS_GATEWAY"] = f"127.0.0.1:{svc.port}"
        try:
            agg.order_by([("total", True)]).to_store("hdfs://warehouse/per_user")
            back = (
                DryadContext(num_partitions_=8, device=args.device)
                .from_store("hdfs://warehouse/per_user")
                .count()
            )
        finally:
            del os.environ["DRYAD_TPU_DFS_GATEWAY"]
        print(f"rows persisted+reread via hdfs:// gateway: {back}")

    ctx.release(agg)


if __name__ == "__main__":
    main()
