"""Full GroupJoin (result selector) + WebHDFS storage
(``samples/topk_per_key_hdfs.py``): per-product top-2 reviews by score
via group-local ranks, persisted to and re-read from an hdfs:// store
served by the in-tree WebHDFS protocol stub on localhost.

Run:
    python -m dryad_tpu_torch.samples.topk_per_key_hdfs [--device cpu]
"""

import os
import tempfile

import numpy as np

from dryad_tpu_torch import DryadContext
from dryad_tpu_torch.samples import parser
from dryad_tpu_torch.tools.webhdfs_stub import WebHdfsStubServer


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    rng = np.random.default_rng(0)
    ctx = DryadContext(device=args.device)

    products = ctx.from_arrays({
        "pid": np.arange(50, dtype=np.int32),
        "price": (rng.gamma(3.0, 15.0, 50)).astype(np.float32),
    })
    reviews = ctx.from_arrays({
        "pid": rng.integers(0, 50, 4000).astype(np.int32),
        "score": rng.uniform(0.0, 5.0, 4000).astype(np.float32),
    })

    # Full GroupJoin: per product, the group of matching reviews,
    # value-ordered by score; the selector keeps the top-2 and sums
    # them. Unreviewed products survive with the default (DefaultIfEmpty).
    top2 = products.group_join(
        reviews, "pid",
        order=[("score", True)],  # descending score ranks
        selector=lambda p: p.where(lambda c: c["gj_rank"] < 2).group_by(
            "gj_lid", {"top2": ("sum", "score"), "nrev": ("count", None)}
        ),
        defaults={"top2": 0.0, "nrev": 0},
    )

    # Persist through the WebHDFS protocol (two-hop redirects,
    # chunk-parallel reads) against the in-tree stub namenode.
    os.environ.pop("DRYAD_TPU_DFS_GATEWAY", None)
    with tempfile.TemporaryDirectory() as root, WebHdfsStubServer(root) as nn:
        uri = f"hdfs://{nn.host}:{nn.port}/warehouse/top_reviews"
        top2.to_store(uri)
        back = DryadContext(device=args.device).from_store(uri).collect()
        print(f"persisted+reread {len(back['pid'])} products via {uri}")
        print(f"webhdfs redirects observed: {nn.redirects}")

    order = np.argsort(-back["top2"])
    print("best-reviewed products (top-2 score sum):")
    for i in order[:5]:
        print(
            f"  pid {int(back['pid'][i]):3d}: top2={back['top2'][i]:.2f} "
            f"from {int(back['nrev'][i])} ranked reviews"
        )
    total = int(np.sum(back["nrev"]))
    print(f"ranked reviews considered: {total}")


if __name__ == "__main__":
    main()
