"""Top-K words — WordCount + the fused order_by+take top-k
(``samples/top_words.py``): partial count, hash exchange, final count,
local top-k and one gather of the P heads; ``explain`` shows the plan.

Run:
    python -m dryad_tpu_torch.samples.top_words [textfile] [--device cpu]
"""

import numpy as np

from dryad_tpu_torch import DryadContext
from dryad_tpu_torch.samples import parser
from dryad_tpu_torch.tools.explain import explain


def main(argv=None) -> None:
    ap = parser(__doc__)
    ap.add_argument("source", nargs="?", default=None, help="a text file (default: 50,000 drawn words)")
    args = ap.parse_args(argv)
    ctx = DryadContext(num_partitions_=8, device=args.device)
    if args.source:
        q = ctx.from_text(args.source)
    else:
        rng = np.random.default_rng(0)
        vocab = np.array(
            "the quick brown fox jumps over a lazy dog and cat".split(),
            object,
        )
        words = vocab[
            rng.choice(len(vocab), 50_000, p=np.linspace(1, 2, len(vocab))
                       / np.linspace(1, 2, len(vocab)).sum())
        ]
        q = ctx.from_arrays({"word": words})

    top = (
        q.group_by("word", {"count": ("count", None)})
        .order_by([("count", True)])
        .take(10)
    )
    print(explain(top))
    print()
    out = top.collect()
    for w, c in zip(out["word"], out["count"]):
        print(f"{c:>8}  {w}")


if __name__ == "__main__":
    main()
