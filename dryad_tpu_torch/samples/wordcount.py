"""WordCount — the reference's canonical sample (``samples/wordcount.py``):
tokenize at the ingest edge (native tokenizer), count words on the
device, print the ten most frequent.

Run:
    python -m dryad_tpu_torch.samples.wordcount [textfile] [--device cpu]
"""

from dryad_tpu_torch import DryadContext
from dryad_tpu_torch.samples import parser

TEXT = """the quick brown fox jumps over the lazy dog
the dog barks and the fox runs away over the hill"""


def main(argv=None) -> None:
    ap = parser(__doc__)
    ap.add_argument("source", nargs="?", default=TEXT, help="a text file (default: a built-in text)")
    args = ap.parse_args(argv)
    ctx = DryadContext(device=args.device)
    counts = (
        ctx.from_text(args.source)
        .group_by("word", {"n": ("count", None)})
        .order_by([("n", True)])  # descending by count
        .take(10)
        .collect()
    )
    for w, n in zip(counts["word"], counts["n"]):
        print(f"{n:6d}  {w}")


if __name__ == "__main__":
    main()
