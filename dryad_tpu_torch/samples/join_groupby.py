"""Join + GroupBy + aggregation (``samples/join_groupby.py``): a join
whose ``auto`` placement broadcasts the small right side, then the dense
group_by on the bucket kernel.

Run:
    python -m dryad_tpu_torch.samples.join_groupby [--device cpu]
"""

import numpy as np

from dryad_tpu_torch import DryadContext
from dryad_tpu_torch.samples import parser


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    rng = np.random.default_rng(0)
    ctx = DryadContext(device=args.device)
    n = 50_000

    orders = ctx.from_arrays({
        "cust": rng.integers(0, 1000, n).astype(np.int32),
        "amount": rng.gamma(2.0, 10.0, n).astype(np.float32),
    })
    customers = ctx.from_arrays({
        "cust": np.arange(1000, dtype=np.int32),
        "region": (np.arange(1000) % 7).astype(np.int32),
    })

    # Broadcast join (small right side) -> dense-key group_by.
    per_region = (
        orders
        .join(customers, "cust", "cust", strategy="auto")
        .group_by("region", {"total": ("sum", "amount"),
                             "orders": ("count", None)}, dense=7)
        .collect()
    )
    for r, t, c in zip(per_region["region"], per_region["total"],
                       per_region["orders"]):
        print(f"region {r}: {c:6d} orders, total {t:12.2f}")


if __name__ == "__main__":
    main()
