"""Sweep the bucket kernel's launch geometry on the card.

    python3 -m dryad_tpu_torch.tools.sweep_bucket [--shapes wordcount,dense,...]

Times ``ops.bucket.bucket_sum_count`` (CUDA events, mean of 5 after 2
warm-ups) at the shapes the port's paths give it — WordCount (P=8, 2^23
rows a partition, K=131072, Zipf(1.1) keys, no value column) and the
dense group_by (K=65536 uniform keys, an f32 and an int32 column; also
each column alone, and 90% of the rows on one key) — for each cluster
size, warps a block and blocks a launch, checking each result against
the plain version byte for byte.  Prints one JSON line per case and the
card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from dryad_tpu_torch.ops import bucket as B

P, CAP = 8, 1 << 23
WARPS = (16, 32)
TARGETS = (132, 264, 528)
CLUSTERS = {"wordcount": (4, 8, 16), "dense": (16,), "dense_f32": (8, 16),
            "dense_i32": (4, 8, 16), "hot_key": (16,)}


def _time(fn, iters=5):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _shapes(dev, names):
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(1)
    valid = torch.ones((P, CAP), dtype=torch.bool, device=dev)
    out = {}
    if "wordcount" in names:
        w = np.arange(1, 100_001, dtype=np.float64) ** -1.1
        ids = np.searchsorted(np.cumsum(w / w.sum()), rng.random(P * CAP))
        wc = np.minimum(ids, 99_999).astype(np.int32).reshape(P, CAP)
        out["wordcount"] = (torch.from_numpy(wc).to(dev), [], valid, 131072)
    dk = torch.randint(0, 65536, (P, CAP), generator=gen, dtype=torch.int32)
    f = (torch.randn((P, CAP), generator=gen) * 100).to(dev)
    i = torch.randint(-100, 100, (P, CAP), generator=gen, dtype=torch.int32).to(dev)
    hot = torch.where(torch.rand((P, CAP), generator=gen) < 0.9, 7, dk).to(torch.int32)
    dk = dk.to(dev)
    for name, cols in (("dense", [f, i]), ("dense_f32", [f]), ("dense_i32", [i])):
        if name in names:
            out[name] = (dk, cols, valid, 65536)
    if "hot_key" in names:
        out["hot_key"] = (hot.to(dev), [f, i], valid, 65536)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default="wordcount,dense")
    ap.add_argument("--warps", default=",".join(map(str, WARPS)))
    ap.add_argument("--targets", default=",".join(map(str, TARGETS)))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_bucket: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    names = args.shapes.split(",")
    saved = B.CLUSTER, B.WARPS, B.TARGET_BLOCKS
    try:
        for name, (k, vals, valid, K) in _shapes(dev, names).items():
            ref_s, ref_c = B.bucket_sum_count_plain(k, vals, valid, K)
            for C in CLUSTERS[name]:
                for W, TB in ((w, t) for w in map(int, args.warps.split(","))
                              for t in map(int, args.targets.split(","))):
                    B.CLUSTER, B.WARPS, B.TARGET_BLOCKS = C, W, TB
                    s, c = B.bucket_sum_count(k, vals, valid, K)
                    ok = torch.equal(c.view(torch.int32), ref_c.view(torch.int32)) and all(
                        torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip(s, ref_s))
                    ms = _time(lambda: B.bucket_sum_count(k, vals, valid, K))
                    ni = sum(v.dtype == torch.int32 for v in vals)
                    geo = B.launch_geometry(P, CAP, K, ni, len(vals) - ni)
                    print(json.dumps({"shape": name, "cluster": C, "warps": W,
                                      "target_blocks": TB, "ms": ms, "byte_equal": ok,
                                      "geometry": geo._asdict()}), flush=True)
    finally:
        B.CLUSTER, B.WARPS, B.TARGET_BLOCKS = saved
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
