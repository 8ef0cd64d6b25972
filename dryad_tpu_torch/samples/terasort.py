"""TeraSort shape — the reference's range-partitioned sort
(``samples/terasort.py``): sampled splitters, one range exchange, a
local sort per partition — globally sorted output.

Run:
    python -m dryad_tpu_torch.samples.terasort [n_rows] [--device cpu]
"""

import numpy as np

from dryad_tpu_torch import DryadContext
from dryad_tpu_torch.samples import parser


def main(argv=None) -> None:
    ap = parser(__doc__)
    ap.add_argument("n", nargs="?", type=int, default=100_000, help="rows (default 100000)")
    args = ap.parse_args(argv)
    n = args.n
    rng = np.random.default_rng(0)
    ctx = DryadContext(device=args.device)

    table = {
        "key": rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32),
        "payload": rng.standard_normal(n).astype(np.float32),
    }
    out = ctx.from_arrays(table).order_by([("key", False)]).collect()

    assert np.array_equal(out["key"], np.sort(table["key"])), "not sorted!"
    print(f"sorted {n} rows; head={out['key'][:5].tolist()}")


if __name__ == "__main__":
    main()
