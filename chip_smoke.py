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


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def _compare(keys, valid, vals, K):
    """Kernel vs plain on one input: counts and every sum must be equal
    byte for byte, and two launches identical; returns the max abs
    difference (0.0 when the bytes agree)."""
    from dryad_tpu_torch.ops.bucket import bucket_sum_count, bucket_sum_count_plain

    before = bucket_sum_count.launches
    sums, cnt = bucket_sum_count(keys, vals, valid, K)
    sums2, cnt2 = bucket_sum_count(keys, vals, valid, K)
    torch.cuda.synchronize()
    check(bucket_sum_count.launches == before + 2, "launch counter did not advance")
    p_sums, p_cnt = bucket_sum_count_plain(keys, vals, valid, K)
    check(torch.equal(_bits(cnt), _bits(p_cnt)), f"counts differ from the plain version (K={K})")
    check(torch.equal(_bits(cnt), _bits(cnt2)), "counts not deterministic")
    err = 0.0
    for j, (s, s2, ps) in enumerate(zip(sums, sums2, p_sums)):
        check(torch.equal(_bits(s), _bits(s2)), f"sums of column {j} not deterministic")
        same = _bits(s) == _bits(ps)
        if not bool(same.all()):
            d = (s - ps).abs()[~same]
            raise AssertionError(
                f"sums of column {j} ({vals[j].dtype}) differ from the plain version "
                f"in {int((~same).sum())} buckets (K={K}, max {float(d.max())})")
    return err


def _check_f64(keys, valid, v, K, sums):
    """Float sums against a float64 numpy sum within 2^-16 * sum |v|."""
    k, ok, x = keys.cpu().numpy(), valid.cpu().numpy(), v.cpu().numpy().astype(np.float64)
    for p in range(k.shape[0]):
        kk, xx = k[p][ok[p]], x[p][ok[p]]
        exact = np.bincount(kk, weights=xx, minlength=K)
        absum = np.bincount(kk, weights=np.abs(xx), minlength=K)
        got = sums[p].cpu().numpy().astype(np.float64)
        check(bool((np.abs(got - exact) <= FLOAT_REL * absum).all()),
              "float sums past 2^-16 * sum|v| of the float64 sum")


def _special_cases(gen, dev):
    """(label, keys, valid, values, K) of the adversarial inputs."""
    cases = []
    cap = 50_001
    # values spanning 2^-60 .. 2^60; buckets [0, 64) hold only tiny ones
    K = 4096
    keys = torch.randint(0, K, (P, cap), generator=gen, dtype=torch.int32)
    expo = torch.randint(-60, 61, (P, cap), generator=gen)
    tiny = keys < 64
    expo = torch.where(tiny, torch.randint(-60, -50, (P, cap), generator=gen), expo)
    v = torch.randn((P, cap), generator=gen) * torch.pow(2.0, expo.double()).float()
    valid = torch.rand((P, cap), generator=gen) > 0.1
    cases.append(("f32 over 2^-60..2^60", keys, valid, [v], K))
    # NaN, +Inf, -Inf and -0.0 rows among finite ones
    K = 512
    keys = torch.randint(0, K, (P, cap), generator=gen, dtype=torch.int32)
    v = torch.randn((P, cap), generator=gen)
    pick = torch.rand((P, cap), generator=gen)
    v = torch.where(pick < 0.001, float("nan"), v)
    v = torch.where((pick >= 0.001) & (pick < 0.003), float("inf"), v)
    v = torch.where((pick >= 0.003) & (pick < 0.005), float("-inf"), v)
    v = torch.where(pick >= 0.99, -0.0, v)
    v[:, :64] = -0.0
    keys[:, :64] = K - 1  # a bucket of -0.0 rows only
    keys[:, 64:80] = K - 2
    v[:, 64:72] = float("inf")
    v[:, 72:80] = float("-inf")  # +Inf and -Inf in one bucket: NaN
    valid = torch.ones((P, cap), dtype=torch.bool)
    valid[:, 80:] = keys[:, 80:] < K - 2  # the two special buckets hold only those rows
    w = torch.randint(-5, 5, (P, cap), generator=gen, dtype=torch.int32)
    cases.append(("NaN/+Inf/-Inf/-0.0", keys, valid, [v, w], K))
    # K = 1
    keys = torch.zeros((P, cap), dtype=torch.int32)
    valid = torch.rand((P, cap), generator=gen) > 0.5
    cases.append(("K=1", keys, valid, [torch.randn((P, cap), generator=gen),
                                       torch.randint(-9, 9, (P, cap), generator=gen, dtype=torch.int32)], 1))
    # K not a multiple of any tile, and integer sums past 2^24
    K = 100_003
    keys = torch.randint(0, 64, (P, cap), generator=gen, dtype=torch.int32) * 1511
    w = torch.randint(1 << 20, 1 << 30, (P, cap), generator=gen, dtype=torch.int32)
    valid = torch.rand((P, cap), generator=gen) > 0.25
    cases.append(("K=100003, int sums past 2^24", keys, valid,
                  [w, torch.randn((P, cap), generator=gen)], K))
    # K = 2^20 with two value columns: bucket passes
    K = 1 << 20
    keys = torch.randint(0, K, (P, cap), generator=gen, dtype=torch.int32)
    valid = torch.rand((P, cap), generator=gen) > 0.25
    cases.append(("K=2^20, f32+i32", keys, valid,
                  [torch.randn((P, cap), generator=gen),
                   torch.randint(-100, 100, (P, cap), generator=gen, dtype=torch.int32)], K))
    return [(lab, k.to(dev), m.to(dev), [x.to(dev) for x in vs], K)
            for lab, k, m, vs, K in cases]


def _dense_inputs(gen, keys, dev, hot: bool):
    """The dense group_by's shape: K=65536, an f32 and an int32 column;
    with ``hot``, 90% of the rows on one key."""
    dk = torch.randint(0, DENSE_K, keys.shape, generator=gen, dtype=torch.int32)
    if hot:
        dk = torch.where(torch.rand(keys.shape, generator=gen) < 0.9, 7, dk).to(torch.int32)
    dv = [(torch.randn(keys.shape, generator=gen) * 100).to(dev),
          torch.randint(-100, 100, keys.shape, generator=gen, dtype=torch.int32).to(dev)]
    return dk.to(dev), dv


def phase_kernel(dev) -> dict:
    from dryad_tpu_torch.ops.bucket import (bucket_sum_count, bucket_sum_count_plain,
                                            launch_geometry)

    gen = torch.Generator().manual_seed(SEED)
    for K in KERNEL_CASES_K:
        for kinds in KERNEL_CASES_VALS:
            cap = 50_001 if K < 131072 else 400_003
            keys, valid, vals = _case(gen, cap, K, kinds, dev)
            _compare(keys, valid, vals, K)
            log(f"kernel vs plain: K={K} values={kinds or '-'} cap={cap}: byte-equal")
    # forced cluster sizes (K=5000 alone would fit one block)
    from dryad_tpu_torch.ops import bucket as BK

    keys, valid, vals = _case(gen, 50_001, 5000, ("i32", "f32"), dev)
    saved = BK.CLUSTER
    try:
        for C in (2, 4, 16):
            BK.CLUSTER = C
            _compare(keys, valid, vals, 5000)
            log(f"kernel vs plain: cluster {C}: byte-equal")
    finally:
        BK.CLUSTER = saved
    for label, keys, valid, vals, K in _special_cases(gen, dev):
        _compare(keys, valid, vals, K)
        sums, cnt = bucket_sum_count(keys, vals, valid, K)
        if label.startswith("f32 over"):
            _check_f64(keys, valid, vals[0], K, sums[0])
        if label.startswith("NaN"):
            s = sums[0].cpu()
            check(bool(torch.isnan(s[:, K - 2]).all()), "+Inf and -Inf did not give NaN")
            check(bool((s[:, K - 1].view(torch.int32) == 0).all()), "-0.0 rows did not give +0.0")
        log(f"kernel vs plain: {label}: byte-equal")

    def timed(keys, vals, valid, K, plain_iters):
        kernel_ms = cuda_time_ms(lambda: bucket_sum_count(keys, vals, valid, K), 10)
        plain_ms = cuda_time_ms(lambda: bucket_sum_count_plain(keys, vals, valid, K), plain_iters)
        return kernel_ms, plain_ms

    # the WordCount shape: P x 2^23 keys of Zipf(1.1) words, all valid
    ids = zipf_ids(np.random.default_rng(SEED + 1), WC_WORDS)
    K = 131072
    keys = torch.from_numpy(ids.astype(np.int32).reshape(P, -1)).to(dev)
    valid = torch.ones_like(keys, dtype=torch.bool)
    _compare(keys, valid, [], K)
    kernel_ms, plain_ms = timed(keys, [], valid, K, 10)
    flat = (keys.long() + torch.arange(P, device=dev).reshape(P, 1) * K).reshape(-1)
    lib_out = torch.bincount(flat, minlength=P * K).reshape(P, K).float()
    check(torch.equal(lib_out, bucket_sum_count(keys, [], valid, K)[1]), "bincount yardstick differs")
    library_ms = cuda_time_ms(lambda: torch.bincount(flat, minlength=P * K), 10)
    n = keys.numel()
    cap = keys.shape[1]
    del flat, lib_out
    geo = launch_geometry(P, cap, K, 0, 0)
    res = {
        "max_abs_err": 0.0, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": (n * (4 + 1) + P * K * 4) / HBM_BYTES_PER_S * 1e3,
        "shape": f"P={P} cap={cap} K={K} values=0", "geometry": geo._asdict(),
    }
    log(f"bucket_sum_count at the WordCount shape ({res['shape']}): kernel {kernel_ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, bincount {library_ms:.3f} ms, bound {res['bound_ms']:.4f} ms; "
        f"{geo}")

    # the dense group_by's shape, uniform keys and a hot key
    for label, hot in (("dense", False), ("hot_key", True)):
        dk, dv = _dense_inputs(gen, keys, dev, hot)
        _compare(dk, valid, dv, DENSE_K)
        kernel_ms, plain_ms = timed(dk, dv, valid, DENSE_K, 3)
        geo = launch_geometry(P, cap, DENSE_K, 1, 1)
        geo0 = launch_geometry(P, cap, DENSE_K, 1, 1, phase=0)
        out = {
            "shape": f"P={P} cap={cap} K={DENSE_K} values=f32,i32" + (", 90% on one key" if hot else ""),
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": (n * (4 + 1 + 8) + 3 * P * DENSE_K * 4) / HBM_BYTES_PER_S * 1e3,
            "geometry": geo._asdict(),
            "geometry_phase0": geo0._asdict(),
        }
        if not hot:
            # one index_add_ of a stacked (rows, 1+m) f32 source computes the
            # counts and both sums; the stacking is done outside the timed window
            flat = (dk.long() + torch.arange(P, device=dev).reshape(P, 1) * DENSE_K).reshape(-1)
            src = torch.stack([valid.reshape(-1).float(), dv[0].reshape(-1),
                               dv[1].reshape(-1).float()], 1)
            tab = torch.zeros((P * DENSE_K, 3), device=dev)
            lib_ms = cuda_time_ms(lambda: tab.zero_().index_add_(0, flat, src), 5)
            check(torch.equal(tab[:, 0].reshape(P, DENSE_K),
                              bucket_sum_count(dk, dv, valid, DENSE_K)[1]),
                  "index_add_ yardstick counts differ")
            out["library_ms"] = lib_ms
            del flat, src, tab
        res[label] = out
        log(f"bucket_sum_count at the {label} shape ({out['shape']}): kernel {kernel_ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, one index_add_ {out.get('library_ms', float('nan')):.3f} ms, "
            f"bound {out['bound_ms']:.4f} ms; {geo}")
        del dk, dv
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
        "dense_launches": results.get("dense", {}).get("launches"),
        "dense_kernel_ms": kern.get("dense", {}).get("kernel_ms"),
        "dense_plain_ms": kern.get("dense", {}).get("plain_ms"),
        "dense_library_ms": kern.get("dense", {}).get("library_ms"),
        "dense_bound_ms": kern.get("dense", {}).get("bound_ms"),
        "hot_key_kernel_ms": kern.get("hot_key", {}).get("kernel_ms"),
        "hot_key_bound_ms": kern.get("hot_key", {}).get("bound_ms"),
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
