"""Runnable samples of the port, one per sample of the reference
(``samples/``): ``python -m dryad_tpu_torch.samples.<name>``.  Each runs
on the card unless given ``--device cpu`` and prints what the
reference's sample prints."""

import argparse


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the samples' common ``--device`` option
    (default: the current CUDA device)."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: CUDA)")
    return ap
