"""Sweep the bucket kernel's launch geometry on the card.

    python3 -m dryad_tpu_torch.tools.sweep_bucket

Times ``ops.bucket.bucket_sum_count`` (CUDA events, mean of 10 after 2
warm-ups) at the two shapes the port's paths give it — WordCount
(P=8, 2^23 rows a partition, K=131072, Zipf(1.1) keys, no value column)
and the dense group_by (K=65536 uniform keys, an f32 and an int32
column) — for each threads-per-block and shared-memory budget, checking
each result against the plain version.  Prints one JSON line per case
and the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from dryad_tpu_torch.ops import bucket as B

P, CAP = 8, 1 << 23
THREADS = (128, 256, 512)
BUDGETS = (48 * 1024, 100 * 1024, 200 * 1024)


def _time(fn, iters=10):
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


def _shapes(dev):
    rng = np.random.default_rng(0)
    w = np.arange(1, 100_001, dtype=np.float64) ** -1.1
    ids = np.searchsorted(np.cumsum(w / w.sum()), rng.random(P * CAP))
    wc = torch.from_numpy(np.minimum(ids, 99_999).astype(np.int32).reshape(P, CAP)).to(dev)
    gen = torch.Generator().manual_seed(1)
    dk = torch.randint(0, 65536, (P, CAP), generator=gen, dtype=torch.int32).to(dev)
    dv = [torch.randn((P, CAP), generator=gen).to(dev),
          torch.randint(-100, 100, (P, CAP), generator=gen, dtype=torch.int32).to(dev)]
    valid = torch.ones((P, CAP), dtype=torch.bool, device=dev)
    return {"wordcount": (wc, [], valid, 131072), "dense": (dk, dv, valid, 65536)}


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_bucket: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    shapes = _shapes(dev)
    for name, (k, vals, valid, K) in shapes.items():
        ref_s, ref_c = B.bucket_sum_count_plain(k, vals, valid, K)
        for threads in THREADS:
            for budget in BUDGETS:
                B.THREADS, B.SMEM_BUDGET = threads, budget
                s, c = B.bucket_sum_count(k, vals, valid, K)
                ok = torch.equal(c, ref_c) and all(
                    torch.allclose(a, b, rtol=1e-4, atol=1e-2) for a, b in zip(s, ref_s))
                ms = _time(lambda: B.bucket_sum_count(k, vals, valid, K))
                geo = B.launch_geometry(P, CAP, K, len(vals))
                print(json.dumps({"shape": name, "threads": threads, "smem_budget": budget,
                                  "tile_chunks_rows": geo, "ms": ms, "ok": ok}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
