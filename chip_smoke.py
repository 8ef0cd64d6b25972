"""Chip smoke test of the PyTorch/CUDA port (dryad_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

It builds the port's native code from the checkout (the CUDA bucket
kernel for sm_90a and the host tokenizer, both compilers started
together), holds the kernel against its plain PyTorch version on the
card, drives WordCount at full size and the dense integer group_by
through the port's entry points, checks every result against a numpy
oracle, and prints:

- a ``{"kernels": [...]}`` line (each kernel's launches on the main
  path, its error against the plain version, its time, the plain
  version's time, the least time the card could take for the same work,
  and the time of one PyTorch call computing the same function);
- the card's name and power limit as nvidia-smi reports them;
- as the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result line.  Without a CUDA device it exits non-zero at once.
``--phases`` runs a subset (env, kernel, wordcount, dense), for short
first runs of a changed kernel.  The WordCount phase also profiles one
warm query with torch.profiler and prints device time by kernel.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
ROOT = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(ROOT, "dryad_tpu_torch", "_build", "smoke")  # git-ignored

# WordCount at full size: 2^26 words over a Zipf(1.1) vocabulary of
# 100,000 words; P = 8 partitions of 2^23 rows each.
WC_WORDS = 1 << 26
WC_VOCAB = 100_000
WC_ZIPF = 1.1
P = 8
DENSE_ROWS = 1 << 26
DENSE_K = 65536
SEED = 0

KERNEL_CASES_K = (128, 4096, 5000, 131072)
KERNEL_CASES_VALS = ((), ("f32",), ("i32", "f32"))
FLOAT_REL = 2.0 ** -16  # the reference's per-element bound for float sums


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- phase 1: environment and build ------------------------------------------

def phase_env(card: str) -> dict:
    from dryad_tpu_torch.ops import bucket
    from dryad_tpu_torch.runtime import bindings
    from dryad_tpu_torch.utils import build

    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build.build_many({
        bucket.LIB_NAME: (bucket.SOURCES, True),
        bindings.LIB_NAME: (bindings.SOURCES, False),
    })
    secs = time.perf_counter() - t0
    bucket._kernel_lib()
    check(bindings.native_loaded(), "native tokenizer did not load")
    log(f"build (set-up, not measured work): {secs:.1f} s for kernel + tokenizer")
    return {"build_s": secs}


# -- phase 2: kernel against its plain version ---------------------------------

def _case(gen, cap, K, kinds, dev):
    keys = torch.randint(0, K, (P, cap), generator=gen, dtype=torch.int32).to(dev)
    valid = (torch.rand((P, cap), generator=gen) > 0.25)
    valid[:, cap - cap // 7:] = False  # a ragged, masked tail
    vals = []
    for kind in kinds:
        if kind == "i32":
            vals.append(torch.randint(-1000, 1000, (P, cap), generator=gen, dtype=torch.int32))
        else:
            vals.append(torch.randn((P, cap), generator=gen) * 10)
    return keys, valid.to(dev), [v.to(dev) for v in vals]


def _compare(keys, valid, vals, K):
    """Kernel vs plain on one input: returns the max abs error; raises on
    a disagreement past the stated tolerance or nondeterminism."""
    from dryad_tpu_torch.ops.bucket import bucket_sum_count, bucket_sum_count_plain

    before = bucket_sum_count.launches
    sums, cnt = bucket_sum_count(keys, vals, valid, K)
    sums2, cnt2 = bucket_sum_count(keys, vals, valid, K)
    torch.cuda.synchronize()
    check(bucket_sum_count.launches == before + 2, "launch counter did not advance")
    p_sums, p_cnt = bucket_sum_count_plain(keys, vals, valid, K)
    check(torch.equal(cnt, p_cnt), f"counts differ (K={K})")
    check(torch.equal(cnt.view(torch.int32), cnt2.view(torch.int32)), "counts not deterministic")
    err = 0.0
    for v, s, s2, ps in zip(vals, sums, sums2, p_sums):
        check(torch.equal(s.view(torch.int32), s2.view(torch.int32)), "sums not deterministic")
        if v.dtype == torch.int32:
            check(torch.equal(s, ps), f"integer sums differ (K={K})")
        else:
            absum = bucket_sum_count_plain(keys, [v.abs()], valid, K)[0][0]
            d = (s - ps).abs()
            check(bool((d <= FLOAT_REL * absum + 1e-6).all()),
                  f"float sums differ past 2^-16 * sum|v| (K={K}, max {float(d.max())})")
            err = max(err, float(d.max()))
    return err


def phase_kernel(dev) -> dict:
    from dryad_tpu_torch.ops.bucket import bucket_sum_count, bucket_sum_count_plain

    gen = torch.Generator().manual_seed(SEED)
    err = 0.0
    for K in KERNEL_CASES_K:
        for kinds in KERNEL_CASES_VALS:
            cap = 50_001 if K < 131072 else 400_003
            keys, valid, vals = _case(gen, cap, K, kinds, dev)
            e = _compare(keys, valid, vals, K)
            err = max(err, e)
            log(f"kernel vs plain: K={K} values={kinds or '-'} cap={cap}: ok (max abs err {e:.3g})")

    # timing at the WordCount shape: P x 2^23 keys of Zipf(1.1) words, all valid
    ids = zipf_ids(np.random.default_rng(SEED + 1), WC_WORDS)
    K = 131072
    keys = torch.from_numpy(ids.astype(np.int32).reshape(P, -1)).to(dev)
    valid = torch.ones_like(keys, dtype=torch.bool)
    e = _compare(keys, valid, [], K)
    kernel_ms = cuda_time_ms(lambda: bucket_sum_count(keys, [], valid, K), 20)
    plain_ms = cuda_time_ms(lambda: bucket_sum_count_plain(keys, [], valid, K), 10)
    flat = (keys.long() + torch.arange(P, device=dev).reshape(P, 1) * K).reshape(-1)
    lib_out = torch.bincount(flat, minlength=P * K).reshape(P, K).float()
    check(torch.equal(lib_out, bucket_sum_count(keys, [], valid, K)[1]), "bincount yardstick differs")
    library_ms = cuda_time_ms(lambda: torch.bincount(flat, minlength=P * K), 10)
    n = keys.numel()
    moved = n * (4 + 1) + P * K * 4
    del flat, lib_out

    # the dense group_by's shape: K=65536, an f32 and an int32 value column
    dk = torch.randint(0, DENSE_K, keys.shape, generator=gen, dtype=torch.int32).to(dev)
    dv = [(torch.randn(keys.shape, generator=gen) * 100).to(dev),
          torch.randint(-100, 100, keys.shape, generator=gen, dtype=torch.int32).to(dev)]
    e2 = _compare(dk, valid, dv, DENSE_K)
    dense = {
        "shape": f"P={P} cap={keys.shape[1]} K={DENSE_K} values=f32,i32",
        "kernel_ms": cuda_time_ms(lambda: bucket_sum_count(dk, dv, valid, DENSE_K), 10),
        "plain_ms": cuda_time_ms(lambda: bucket_sum_count_plain(dk, dv, valid, DENSE_K), 5),
        "bound_ms": (n * (4 + 1 + 8) + 3 * P * DENSE_K * 4) / HBM_BYTES_PER_S * 1e3,
        "max_abs_err": e2,
    }
    log(f"bucket_sum_count at the dense shape ({dense['shape']}): kernel "
        f"{dense['kernel_ms']:.3f} ms, plain {dense['plain_ms']:.3f} ms, "
        f"bound {dense['bound_ms']:.4f} ms")
    res = {
        "max_abs_err": max(err, e), "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
        "shape": f"P={P} cap={keys.shape[1]} K={K} values=0", "dense_shape": dense,
    }
    log(f"bucket_sum_count at the WordCount shape ({res['shape']}): kernel {kernel_ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, bincount {library_ms:.3f} ms, bound {res['bound_ms']:.4f} ms")
    return res


# -- phase 3: WordCount at full size -------------------------------------------

def zipf_ids(rng, n: int) -> np.ndarray:
    """n word ids in [0, WC_VOCAB) with P(id = k) proportional to (k+1)^-1.1."""
    w = np.arange(1, WC_VOCAB + 1, dtype=np.float64) ** -WC_ZIPF
    cdf = np.cumsum(w / w.sum())
    return np.minimum(np.searchsorted(cdf, rng.random(n)), WC_VOCAB - 1)


def vocab_table() -> np.ndarray:
    """(WC_VOCAB, 8) uint8: word i in bijective base 26 (1-4 letters),
    padded with spaces, so a text is ``table[ids].tobytes()``."""
    tab = np.full((WC_VOCAB, 8), ord(" "), np.uint8)
    for i in range(WC_VOCAB):
        j, letters = i + 1, []
        while j:
            j, r = divmod(j - 1, 26)
            letters.append(97 + r)
        tab[i, : len(letters)] = letters[::-1]
        tab[i, 7] = ord("\n") if i % 11 == 0 else ord(" ")
    return tab


def profile_query(q, path: str) -> list:
    """One ``collect()`` under torch.profiler: device time by kernel name
    (top 15), the full table written to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        q.collect()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    with open(path, "w") as fh:
        fh.write(avgs.table(sort_by="cuda_time_total", row_limit=60))
    rows = sorted(
        ((a.key, getattr(a, "device_time_total", 0) / 1e3) for a in avgs),
        key=lambda r: -r[1],
    )
    return [r for r in rows if r[1] > 0][:15]


def phase_wordcount(dev, card: str) -> dict:
    from dryad_tpu_torch import DryadContext
    from dryad_tpu_torch.ops.bucket import bucket_sum_count

    rng = np.random.default_rng(SEED + 2)
    ids = zipf_ids(rng, WC_WORDS)
    tab = vocab_table()
    words = np.array([bytes(r).split()[0].decode() for r in tab], object)
    os.makedirs(WORK_DIR, exist_ok=True)
    path = os.path.join(WORK_DIR, "wordcount.txt")
    with open(path, "wb") as fh:
        fh.write(tab[ids].tobytes())
    log(f"wordcount text: {os.path.getsize(path) / 1e6:.1f} MB, {WC_WORDS} words")

    ctx = DryadContext(num_partitions_=P)
    check(ctx.device.type == "cuda", "context is not on the card")
    t0 = time.perf_counter()
    q = ctx.from_text(path).group_by("word", {"n": ("count", None)})
    tokenize_s = time.perf_counter() - t0
    check(ctx.tokenizer_native is True, "the native tokenizer was not used")
    os.remove(path)

    bucket_sum_count.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    table = q.collect()  # cold: includes the host->device ingest
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    table = q.collect()
    warm_s = time.perf_counter() - t0
    top_q = q.order_by([("n", True)]).take(20)
    top = top_q.collect()
    launches = bucket_sum_count.launches
    check(launches >= 3, f"WordCount ran the kernel {launches} times, expected 3")
    resident = next(iter(ctx._device_cache.values()))[1].nbytes()

    # the oracle: numpy counts of the sampled ids
    uid, ucnt = np.unique(ids, return_counts=True)
    oracle = dict(zip(words[uid].tolist(), ucnt.tolist()))
    got = dict(zip(table["word"].tolist(), table["n"].tolist()))
    check(table["n"].dtype == np.int32, "count column is not int32")
    check(got == oracle, "WordCount table differs from the numpy oracle")
    top_counts = sorted(ucnt.tolist(), reverse=True)[:20]
    check(top["n"].tolist() == top_counts, "top-20 counts differ from the oracle")
    check(all(oracle[w] == c for w, c in zip(top["word"], top["n"])), "a top-20 word has a wrong count")
    res = {
        "words": WC_WORDS, "vocab": len(oracle), "tokenize_and_register_s": tokenize_s,
        "first_query_s": cold_s, "warm_query_s": warm_s, "warm_rows_per_s": WC_WORDS / warm_s,
        "device_resident_bytes": resident, "launches": launches, "card": card,
    }
    t0 = time.perf_counter()
    res["profile_ms_by_kernel"] = profile_query(top_q, os.path.join(WORK_DIR, "profile.txt"))
    res["profiled_query_s"] = time.perf_counter() - t0
    for name, ms in res["profile_ms_by_kernel"]:
        log(f"  profile [{card}] {ms:9.3f} ms  {name[:90]}")
    log(f"  profiled top-20 query wall time (profiler on) {res['profiled_query_s']:.4f} s")
    log(f"wordcount: {len(oracle)} distinct words, table and top-20 match the oracle; "
        f"top-3 {list(zip(top['word'][:3], top['n'][:3].tolist()))}")
    log(f"wordcount [{card}]: tokenize+register {tokenize_s:.2f} s, first query "
        f"(ingest to device + run) {cold_s:.3f} s, warm query {warm_s:.4f} s = "
        f"{WC_WORDS / warm_s:.4g} rows/s, resident {resident / 1e9:.2f} GB, kernel launches {launches}")
    del ctx
    torch.cuda.empty_cache()
    return res


# -- phase 4: dense integer group_by ---------------------------------------------

def phase_dense(dev, card: str) -> dict:
    from dryad_tpu_torch import DryadContext
    from dryad_tpu_torch.ops.bucket import bucket_sum_count

    rng = np.random.default_rng(SEED + 3)
    tbl = {
        "k": rng.integers(0, DENSE_K, DENSE_ROWS).astype(np.int32),
        "v": (rng.standard_normal(DENSE_ROWS) * 100).astype(np.float32),
        "w": rng.integers(-100, 100, DENSE_ROWS).astype(np.int32),
    }
    k = tbl["k"]
    ref_c = np.bincount(k, minlength=DENSE_K)
    ref_v = np.bincount(k, weights=tbl["v"].astype(np.float64), minlength=DENSE_K)
    ref_a = np.bincount(k, weights=np.abs(tbl["v"].astype(np.float64)), minlength=DENSE_K)
    ref_w = np.bincount(k, weights=tbl["w"].astype(np.float64), minlength=DENSE_K)
    aggs = {"c": ("count", None), "sv": ("sum", "v"), "mv": ("mean", "v"), "sw": ("sum", "w")}
    ctx = DryadContext(num_partitions_=P)
    out = {}
    bucket_sum_count.launches = 0
    for label, dense in (("dense=K", DENSE_K), ("int auto-dense", None)):
        q = ctx.from_arrays(tbl).group_by("k", aggs, dense=dense)
        q.collect()
        t0 = time.perf_counter()
        r = q.collect()
        secs = time.perf_counter() - t0
        present = np.nonzero(ref_c)[0]
        c, v, a, w = ref_c[present], ref_v[present], ref_a[present], ref_w[present]
        check(np.array_equal(r["k"], present), f"{label}: keys differ")
        check(np.array_equal(r["c"], c), f"{label}: counts differ")
        check(np.array_equal(r["sw"], w.astype(np.int32)), f"{label}: integer sums differ")
        err = np.abs(r["sv"] - v)
        check(bool((err <= FLOAT_REL * a + 1e-3).all()), f"{label}: float sums past tolerance")
        merr = np.abs(r["mv"] - v / c)
        check(bool((merr <= (FLOAT_REL * a + 1e-3) / c).all()), f"{label}: means past tolerance")
        out[label] = {"warm_query_s": secs, "rows_per_s": DENSE_ROWS / secs,
                      "max_abs_err_sum": float(err.max())}
        log(f"{label} [{card}]: {DENSE_ROWS} rows, K={DENSE_K}, count/sum/mean/int-sum match "
            f"the oracle (max |sum err| {err.max():.3g}); warm query {secs:.4f} s = "
            f"{DENSE_ROWS / secs:.4g} rows/s")
    launches = bucket_sum_count.launches
    check(launches >= 4, f"dense group_by ran the kernel {launches} times, expected 4")
    out["launches"] = launches
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="env,kernel,wordcount,dense")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    results = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    results["env"] = phase_env(card)  # always: the build is needed by every phase
    if "kernel" in phases:
        results["kernel"] = phase_kernel(dev)
    if "wordcount" in phases:
        results["wordcount"] = phase_wordcount(dev, card)
    if "dense" in phases:
        results["dense"] = phase_dense(dev, card)
    print("results: " + json.dumps(results))

    kern = results.get("kernel", {})
    wc = results.get("wordcount", {})
    line = {"kernels": [{
        "name": "bucket_sum_count",
        "route": "cuda",
        "source": "dryad_tpu_torch/ops/csrc/bucket_sum_count.cu",
        "replaces": "dryad_tpu/ops/pallas_bucket.py:156",
        "tpu": "dryad_tpu/ops/pallas_bucket.py::_make_kernel",
        "launches": wc.get("launches"),
        "max_abs_err": kern.get("max_abs_err"),
        "ms": kern.get("kernel_ms"),
        "kernel_ms": kern.get("kernel_ms"),
        "plain_ms": kern.get("plain_ms"),
        "bound_ms": kern.get("bound_ms"),
        "bound_by": "bytes",
        "library_ms": kern.get("library_ms"),
    }]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
