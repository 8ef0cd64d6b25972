"""Chip smoke test of the PyTorch/CUDA port (dryad_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

It first runs the port's static-analysis gate (graftlint, the whole
registry of ``dryad_tpu_torch/analysis/`` over the checkout: any
unsuppressed finding fails the run before anything is built), then
builds the port's native code from the checkout (the CUDA bucket
kernel and the do_while loop-control kernel for sm_90a, the host
tokenizer and the host I/O routines, the compilers started together),
holds the kernels against their plain PyTorch versions on the
card, drives through the port's entry points WordCount at full size,
the dense integer group_by, TeraSort (2^28 rows, and 2^26 rows with a
hot key), the sort-path group_by with distinct and range_partition
(2^26 rows), the stage programs (every unit of every phase runs as one
CUDA graph captured once a lowering key; the ``programs`` phase holds
the group_by, WordCount and a serve tenant's count+mean to one
``xla_compile`` a region, byte-equal warm replays, 10 graph/eager
pairs, the bytes the graphs hold, and a host read inside a capture
raising ``TypeError``), the hybrid DCN x ICI mesh (``DryadContext(dcn_slices=2)``,
2 slices of 4: WordCount and the sort-path group_by through the tree
exchange beside the flat context, TeraSort of 2^28 rows at staged
exchange windows 0, 1, 2 and 4 and at the auto window), the same group_by on the fused sort path
(DRYAD_TPU_SORT_FUSED=1) beside the default, the Join Task of Pavlo et al. (2^26 visits joined to 2^23
pages by shuffle, then a sort-path group_by and a top-1), the broadcast
join of samples/join_groupby.py (2^26 orders, then the dense group_by
on the bucket kernel), PageRank by do_while on a Graph500 Kronecker
graph (scale 20, edgefactor 16, 10 rounds; its multi-stage body falls
back from the on-device loop), the on-device do_while as one CUDA graph
(a per-row Newton iteration over 2^26 rows against a numpy oracle, the
driver loop and its plain version), the decomposable group_by,
its built-in twin and aggregate_decomposable over the Join Task's
UserVisits, the ordered and user-function operators over a 2^26-row
event log (sliding_window, reverse, take_while/skip_while, zip_,
select_many, default_if_empty, apply with the partition index, fork),
the parity queries of the CPU tests on the card and on the CPU, and the
stores (TeraSort of 2^26 rows from a store into a store, a zlib store,
WordCount through 8 text files and a STRING store, ``submit``, the JSONL
event log, and the six ported samples), and out-of-core streaming (an
external TeraSort of 2^26 rows whose peak device memory stays within
1.5x of the same query's at 2^25, streaming WordCount through
``text_stream``, a 2^26-row group_by through the combine tree, and the
Join Task as a Grace join of two ``store_stream``s into a stream
``to_store``), and serving (16 and 64 closed-loop clients over 4 tenants
of 2^22 rows on one resident context through ``QueryService``, result
cache off and on; materialized views under two 2^20-row appends in the
views, recompute and epoch modes; stage checkpoints of the 2^23-row
group_by written, resumed in a new context and recomputed past a
corrupted column file), and the local cluster (4 worker processes
sharing the card through ``LocalJobSubmission.submit_partitioned``:
WordCount as 16 vertex tasks, then with a 20 s straggler and with a
worker killed mid-job; an int auto-dense group_by as coded k-of-n
partials, clean and after seeded kills of 2 workers; seeded stage chaos
in one context), the gang (one plan as one program across 2 worker
processes sharing the card, 4 partitions each, their collectives over
gloo, through ``LocalJobSubmission.submit``: the dense group_by at 2^26
rows, TeraSort of 2^25 rows (flat and staged one bucket a round) and WordCount of 2^24 words, each
held to one process at P = 8; ``submit_many`` through the dispatch
window; a worker killed mid-job and the gang rebuilt on 1 worker; then
the dense group_by over a one-rank NCCL group, and NCCL's answer to two
ranks on one card), the runtime plan rewriter at the default config (a
2^26-row drift sort and a skewed Grace join whose hot buckets split
mid-stream, a thrashing streaming combine pinned to the host and the
next stream flipped to the combine tree, an overflowing group_by
pre-widened; each against its rewriter-off run), and the serving fleet
(a front door before 4 replica processes on the card, 4 tenants of
2^20 rows, 16 closed-loop client processes, a replica killed with
queries in flight and replayed, then one killed by a seeded fault whose
flight-recorder dump ``tools/blackbox`` merges), and the telemetry plane
(WordCount at 2^25 words in a default context: its device samples held
to ``torch.cuda.mem_get_info``, ``explain(analyze=True)``, a
``profile_dir`` trace naming the bucket kernel, the sampler's cost on the
warm median, the span export, jobview and metricsd over its JSONL log,
and a 2^25-row stream sort at ``dispatch_depth=-1`` beside depth 2,
each twice, in the order -1, 2, 2, -1), checks every result against a numpy oracle, and prints:

- a ``{"kernels": [...]}`` line (each kernel's launches on the main
  path, its error against the plain version, its time, the plain
  version's time, the least time the card could take for the same work,
  and the time of one PyTorch call computing the same function);
- the card's name and power limit as nvidia-smi reports them;
- as the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result line.  Without a CUDA device it exits non-zero at once.
``--phases`` runs a subset (lint, env, kernel, wordcount, dense, terasort,
terasort_hot, groupby_sort, programs, hybrid, groupby_sort_fused,
join_shuffle, join_broadcast, pagerank, devloop, decomposable, ordered_ops,
cpu_parity, stores, stream, serve, cluster, gang, rewrite, fleet, obs), for
short first runs of a changed kernel; ``terasort_capacity`` (the largest
TeraSort that fits with the stage programs as graphs and as eager
functions) runs only when named.  The WordCount, TeraSort, sort-path group_by, join,
PageRank, decomposable and ordered phases also profile one warm query
with torch.profiler and print device time by op, the device's busy
share of the warm query, and peak memory.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import os
import subprocess
import sys
import threading
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
# TeraSort: int32 keys uniform over the full range, an f32 payload
TS_ROWS = 1 << 28
TS_HOT_ROWS = 1 << 26
# sort-path group_by: 2^22 distinct keys over the int32 range
GB_ROWS = 1 << 26
GB_KEYS = 1 << 22
PARITY_ROWS = 1 << 14
# the Join Task of Pavlo et al. (SIGMOD 2009): UserVisits 8x Rankings
JS_VISITS = 1 << 26
JS_PAGES = 1 << 23
JS_IPS = 1 << 22
JS_DAYS = 1 << 12
JS_WEEK = (2100, 2107)  # the one-week visitDate window of the query
# samples/join_groupby.py at full size
JB_ORDERS = 1 << 26
JB_CUSTOMERS = 1000
JB_REGIONS = 7
# both join tables stay resident between queries, as for a user who
# re-queries them: UserVisits alone is 1.95 GB on the card, so the
# default 2 GiB ingest cache would evict and re-upload it every query
JOIN_CACHE_BYTES = 16 << 30
F32_REL = 2.0 ** -23  # the sort path's float sums: n_g * 2^-23 * sum |v|

# PageRank (samples/pagerank_dowhile.py) on a Graph500 Kronecker graph:
# scale 20 (cut from 22, then 21, for the run's time limit, PERF.md section 4),
# edgefactor 16, A/B/C/D = 0.57/0.19/0.19/0.05
PR_SCALE = 20
PR_EDGEFACTOR = 16
PR_A, PR_B, PR_C = 0.57, 0.19, 0.19
PR_DAMP = 0.85
PR_ROUNDS = 10
PR_REL = 1e-4  # every rank within PR_REL * max(rank) of the float64 oracle
PR_PARITY_SCALE = 10
# the ordered operators over an event log in timestamp order
ORD_ROWS = 1 << 26

KERNEL_CASES_K = (128, 4096, 5000, 131072)
KERNEL_CASES_VALS = ((), ("f32",), ("i32", "f32"))
FLOAT_REL = 2.0 ** -16  # the reference's per-element bound for float sums


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log, led by the seconds since the script
    started (where the run's time goes, phase by phase and inside one)."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def card_id() -> str:
    """The card torch uses, as ``nvidia-smi -i`` takes it: its uuid (an
    index would name the physical card, which CUDA_VISIBLE_DEVICES may
    have renumbered)."""
    u = str(torch.cuda.get_device_properties(0).uuid)
    return u if u.startswith("GPU-") else "GPU-" + u


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "-i", card_id(), "--query-gpu=name,power.limit", "--format=csv,noheader"],
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


def free_card() -> None:
    """Return a finished phase's device memory: a context that ran a
    do_while stays in a reference cycle (its subplans' functions close
    over its queries) until the collector runs."""
    gc.collect()
    torch.cuda.empty_cache()


def card_peak() -> int:
    """What the work held on the card at most since the peak statistics
    were last reset: the allocated peak (the stage programs' input and
    table buffers among it) plus the bytes of the process's graph pool,
    where a replay's working set lies.  A replay allocates nothing, so
    the allocated peak alone misses that working set; the reserved peak
    would count the allocator's cache of earlier work too."""
    from dryad_tpu_torch.exec.programs import pool_bytes

    return torch.cuda.max_memory_allocated() + pool_bytes(
        torch.device("cuda", torch.cuda.current_device()))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- phase 0: the static-analysis gate ----------------------------------------

def phase_lint(card: str) -> dict:
    """The port's whole graftlint registry over this checkout, through
    ``explain_lint`` (the counterpart of the reference's ``bench.py
    --lint-gate``).  It parses source only: no card, a few seconds.  One
    line gives the panel's per-rule counts and the phase's seconds
    beside the card; an unsuppressed finding raises."""
    from dryad_tpu_torch.tools.explain import explain_lint

    t0 = time.perf_counter()
    panel = explain_lint(root=ROOT).split("\n")
    seconds = time.perf_counter() - t0
    rules = {}
    for ln in panel[1:]:
        parts = ln.split()
        if len(parts) >= 2 and (parts[1] == "ok" or parts[1].startswith("FINDINGS=")):
            rules[parts[0]] = " ".join(parts[1:])
    n_sup = sum(1 for ln in panel if ln.startswith("    dryad_tpu_torch/"))
    log("lint: " + ", ".join(f"{r} {v}" for r, v in rules.items())
        + f"; {n_sup} suppressions; {panel[-1].strip()}; {seconds:.2f} s on {card}")
    check(len(rules) == 20, f"lint: expected 20 rules in the panel, got {len(rules)}")
    check(panel[-1] == "  tree clean", "lint: unsuppressed findings\n" + "\n".join(panel))
    return {"rules": rules, "suppressions": n_sup, "seconds": seconds, "card": card}


# -- phase 1: environment and build ------------------------------------------

def phase_env(card: str) -> dict:
    from dryad_tpu_torch.ops import bucket, loopctl
    from dryad_tpu_torch.runtime import bindings
    from dryad_tpu_torch.utils import build

    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build.build_many({
        bucket.LIB_NAME: (bucket.SOURCES, True),
        loopctl.LIB_NAME: (loopctl.SOURCES, True),
        bindings.LIB_NAME: (bindings.SOURCES, False),
        bindings.IO_LIB_NAME: (bindings.IO_SOURCES, False, bindings.IO_LIBS),
    })
    secs = time.perf_counter() - t0
    bucket._kernel_lib()
    log(f"loop-control library built against CUDA runtime {loopctl.runtime_version()}")
    check(bindings.native_loaded(), "native tokenizer did not load")
    check(bindings.io_native_loaded(), "native I/O routines did not load")
    log(f"build (set-up, not measured work): {secs:.1f} s for the two kernels + tokenizer + I/O")
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

    # the join_broadcast phase's shape: the dense group_by over the 7
    # regions of the joined rows (P x 2^23 keys in [0, 7), one f32
    # column; the kernel takes K = 8, the buckets rounded up to P)
    rk = torch.randint(0, JB_REGIONS, keys.shape, generator=gen, dtype=torch.int32).to(dev)
    rv = [(torch.rand(keys.shape, generator=gen) * 40).to(dev)]
    Kj = -(-JB_REGIONS // P) * P
    _compare(rk, valid, rv, Kj)
    kernel_ms, plain_ms = timed(rk, rv, valid, Kj, 3)
    flat = (rk.long() + torch.arange(P, device=dev).reshape(P, 1) * Kj).reshape(-1)
    src = torch.stack([valid.reshape(-1).float(), rv[0].reshape(-1)], 1)
    tab = torch.zeros((P * Kj, 2), device=dev)
    lib_ms = cuda_time_ms(lambda: tab.zero_().index_add_(0, flat, src), 5)
    check(torch.equal(tab[:, 0].reshape(P, Kj), bucket_sum_count(rk, rv, valid, Kj)[1]),
          "index_add_ yardstick counts differ at the join_broadcast shape")
    geo = launch_geometry(P, cap, Kj, 0, 1)
    res["join_broadcast"] = {
        "shape": f"P={P} cap={cap} K={Kj} (dense=7) values=f32",
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
        "bound_ms": (n * (4 + 1 + 4) + 2 * P * Kj * 4) / HBM_BYTES_PER_S * 1e3,
        "geometry": geo._asdict(),
    }
    log(f"bucket_sum_count at the join_broadcast shape ({res['join_broadcast']['shape']}): "
        f"kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, one index_add_ {lib_ms:.3f} ms, "
        f"bound {res['join_broadcast']['bound_ms']:.4f} ms; {geo}")
    del flat, src, tab, rk, rv
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


def profile_query(q, path: str) -> dict:
    """One ``collect()`` under torch.profiler: device time by op (the
    top 15 ``aten::`` ops), the device time of all kernels, and the full
    table written to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        q.collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    with open(path, "w") as fh:
        fh.write(avgs.table(sort_by="cuda_time_total", row_limit=80))
    ops = sorted(
        ((a.key, getattr(a, "device_time_total", 0) / 1e3) for a in avgs
         if a.key.startswith("aten::")),
        key=lambda r: -r[1],
    )
    from torch.autograd import DeviceType

    # device busy time: the kernels', copies' and fills' own spans.  The
    # executor's record_function range round each stage attempt also
    # shows on the CUDA timeline (a gpu_user_annotation spanning the
    # kernels it covers): it is no work of its own, and is left out
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e6
    # the port issues all its work on one stream: its spans cannot
    # overlap, so more busy time than wall means something else counted
    check(busy <= wall, f"profile: device busy {busy:.4f} s exceeds the profiled wall {wall:.4f} s")
    return {"top_ops_ms": [r for r in ops if r[1] > 0][:15], "device_busy_s": busy,
            "profiled_wall_s": wall}


def print_profile(label: str, card: str, prof: dict, warm_s: float) -> None:
    for name, ms in prof["top_ops_ms"]:
        log(f"  profile {label} [{card}] {ms:9.3f} ms  {name[:90]}")
    log(f"  profile {label}: device busy {prof['device_busy_s']:.4f} s (kernels, copies, fills); "
        f"warm query {warm_s:.4f} s without the profiler, so the device is idle "
        f"{max(0.0, 1 - prof['device_busy_s'] / warm_s):.3f} of it; "
        f"wall with the profiler on {prof['profiled_wall_s']:.4f} s")


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
    t0 = time.perf_counter()
    top = top_q.collect()  # warm: its coding tables are built
    top_s = time.perf_counter() - t0
    launches = bucket_sum_count.launches
    check(launches >= 4, f"WordCount ran the kernel {launches} times, expected 4")
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
    _FLAT["wordcount"] = (table, warm_s)  # the hybrid phase's flat twin
    if _PG.get("keep"):  # the programs phase reuses the tokenized corpus
        _PG["wordcount"] = (ctx, q, oracle)
    res = {
        "words": WC_WORDS, "vocab": len(oracle), "tokenize_and_register_s": tokenize_s,
        "first_query_s": cold_s, "warm_query_s": warm_s, "warm_rows_per_s": WC_WORDS / warm_s,
        "device_resident_bytes": resident, "launches": launches, "card": card,
    }
    res["profile"] = profile_query(top_q, os.path.join(WORK_DIR, "profile_wordcount.txt"))
    res["warm_top20_query_s"] = top_s
    print_profile("wordcount top-20", card, res["profile"], top_s)
    log(f"wordcount: {len(oracle)} distinct words, table and top-20 match the oracle; "
        f"top-3 {list(zip(top['word'][:3], top['n'][:3].tolist()))}")
    log(f"wordcount [{card}]: tokenize+register {tokenize_s:.2f} s, first query "
        f"(ingest to device + run) {cold_s:.3f} s, warm query {warm_s:.4f} s = "
        f"{WC_WORDS / warm_s:.4g} rows/s, resident {resident / 1e9:.2f} GB, kernel launches {launches}")
    del ctx
    free_card()
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


# -- phases 5-8: TeraSort, the sort-path group_by, CPU parity -------------------

def overflow_retries(ctx) -> int:
    """Overflow retries of the context's last job."""
    return sum(1 for e in ctx.executor.events if e[0] == "stage_overflow")


def digest(out: dict) -> str:
    """SHA-256 over every column's name, dtype and bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for c, a in out.items():
        h.update(f"{c}:{a.dtype}:".encode())
        h.update(np.ascontiguousarray(a).view(np.uint8) if a.dtype != object
                 else "\0".join(map(str, a)).encode())
    return h.hexdigest()


def timed_runs(ctx, q, label: str, card: str, rows: int):
    """Cold run (ingest included); two warm runs, each after the previous
    result was dropped, and a third while the second's result is still
    held (results live in page-locked memory, so holding one makes the
    next query allocate anew); all three must give the same bytes with
    no overflow retry.  Then peak device memory of a warm run and one
    profiled warm run.  The bucket kernel's launches over the four runs
    are counted from 0: a path that reaches the kernel once a query
    (join_broadcast) reads 4, one that holds no hand-written kernel 0."""
    from dryad_tpu_torch.ops.bucket import bucket_sum_count

    bucket_sum_count.launches = 0
    t0 = time.perf_counter()
    out = q.collect()
    cold_s = time.perf_counter() - t0
    check(overflow_retries(ctx) == 0, f"{label}: the cold run retried an overflow")
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = q.collect()
    warm_s = time.perf_counter() - t0
    peak, peak_alloc = card_peak(), torch.cuda.max_memory_allocated()
    check(overflow_retries(ctx) == 0, f"{label}: a warm run retried an overflow")
    first = digest(out)
    del out
    t0 = time.perf_counter()
    out = q.collect()
    warm2_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    held = q.collect()
    held_s = time.perf_counter() - t0
    check(digest(out) == first == digest(held), f"{label}: warm runs differ")
    del held
    launches = bucket_sum_count.launches
    prof = profile_query(q, os.path.join(WORK_DIR, f"profile_{label}.txt"))
    res = {"rows": rows, "cold_s": cold_s, "warm_s": warm_s, "warm2_s": warm2_s,
           "warm_result_held_s": held_s, "rows_per_s": rows / warm_s, "peak_bytes": peak,
           "peak_allocated_bytes": peak_alloc,
           "resident_bytes": base, "profile": prof, "card": card,
           "bucket_sum_count_launches": launches}
    log(f"{label} [{card}]: {rows} rows, first query (ingest to device + run) {cold_s:.3f} s, "
        f"warm {warm_s:.4f} s and {warm2_s:.4f} s = {rows / warm_s:.4g} rows/s, "
        f"{held_s:.4f} s with the previous result held (all byte-equal), "
        f"peak device memory (allocated + graph pool) {peak / 1e9:.2f} GB, allocated {peak_alloc / 1e9:.2f} GB "
        f"({base / 1e9:.2f} GB resident before), "
        f"0 overflow retries, bucket kernel launches {launches}")
    print_profile(label, card, prof, warm_s)
    return res, out


def _pack(k: np.ndarray, p: np.ndarray) -> np.ndarray:
    return (k.astype(np.int64) << 32) | p.view(np.uint32).astype(np.int64)


def terasort_oracle(key: np.ndarray, pay: np.ndarray) -> tuple:
    """np.sort of the keys, and of the (key, payload) pairs packed to int64."""
    return np.sort(key), np.sort(_pack(key, pay))


def check_terasort(out: dict, key: np.ndarray, pay: np.ndarray, label: str, oracle=None) -> None:
    """Keys equal np.sort; (key, payload) pairs equal the input's as a
    multiset (both packed to int64 and sorted).  ``oracle``: the input's
    ``terasort_oracle``, when computed ahead (numpy sorts release the
    GIL, so a phase can sort the input while the card works).  The
    output's pairs are sorted by numpy's default sort: where one key
    holds most rows (the hot-key input), the stable merge sort of pairs
    already in key order is several times slower."""
    sorted_key, sorted_pairs = oracle if oracle is not None else terasort_oracle(key, pay)
    check(len(out["key"]) == len(key), f"{label}: {len(out['key'])} rows out of {len(key)}")
    check(np.array_equal(out["key"], sorted_key), f"{label}: keys are not sorted as np.sort")
    check(np.array_equal(np.sort(_pack(out["key"], out["payload"])), sorted_pairs),
          f"{label}: (key, payload) pairs differ from the input's")


def phase_terasort(dev, card: str, rows: int, hot: bool) -> dict:
    from dryad_tpu_torch import DryadContext

    label = "terasort_hot" if hot else "terasort"
    rng = np.random.default_rng(SEED + (5 if hot else 4))
    key = rng.integers(-2**31, 2**31, rows, dtype=np.int32)
    if hot:
        key[rng.random(rows) < 0.9] = 12345
    pay = rng.random(rows, dtype=np.float32)
    oracle = {}
    sorter = threading.Thread(target=lambda: oracle.update(v=terasort_oracle(key, pay)))
    sorter.start()  # the numpy oracle sorts while the card works
    ctx = DryadContext(num_partitions_=P)
    q = ctx.from_arrays({"key": key, "payload": pay}).order_by([("key", False)])
    res, out = timed_runs(ctx, q, label, card, rows)
    sorter.join()
    check_terasort(out, key, pay, label, oracle=oracle["v"])
    log(f"{label}: output keys equal np.sort, (key, payload) pairs equal the input's")
    del ctx, q, out
    free_card()
    return res


# TeraSort sizes the capacity phase tries, with the programs as graphs and as eager functions
TC_ROWS = (1 << 28, 3 << 27, 1 << 29)


def _out_of_memory(e: BaseException) -> bool:
    return isinstance(e, torch.cuda.OutOfMemoryError) or "out of device memory" in str(e)


def phase_terasort_capacity(dev, card: str) -> dict:
    """The largest TeraSort that fits on the card with the stage
    programs as CUDA graphs and as eager functions (the executor's
    ``programs.graphs``; not in the default run: ``--phases
    env,terasort_capacity``).  Each of TC_ROWS runs in a fresh child
    process (:func:`terasort_capacity_child`), so no earlier size's
    cached or fragmented memory counts against it; a mode stops at its
    first size that runs out of device memory."""
    res = {"card": card, "rows": list(TC_ROWS)}
    for mode in ("eager", "graphs"):
        res[mode] = {}
        for rows in TC_ROWS:
            out_path = os.path.join(WORK_DIR, f"capacity_{mode}_{rows}.json")
            os.makedirs(WORK_DIR, exist_ok=True)
            rc, _out, err = _finish_child(
                _start_child(["--terasort-capacity", mode, str(rows), out_path]), 600)
            check(rc == 0 and os.path.exists(out_path),
                  f"terasort_capacity {mode} {rows}: the child exited {rc}: {err[-2000:]}")
            with open(out_path) as fh:
                cell = res[mode][rows] = json.load(fh)
            os.remove(out_path)
            fits = "out_of_memory" not in cell
            log(f"terasort_capacity [{card}] {mode} {rows} rows: "
                + (f"fits, warm {cell['warm_s']:.4f} s" if fits else
                   f"out of device memory ({cell['out_of_memory'][:160]})")
                + f"; peak device memory (allocated + graph pool) {cell['peak_bytes'] / 1e9:.3f} GB, allocated "
                  f"{cell['peak_allocated_bytes'] / 1e9:.3f} GB, reserved "
                  f"{cell['peak_reserved_bytes'] / 1e9:.3f} GB, the programs and the graph pool "
                  f"{cell['programs_bytes'] / 1e9:.3f} GB")
            if not fits:
                break
        ok = [r for r, c in res[mode].items() if "out_of_memory" not in c]
        res[mode + "_largest_rows"] = max(ok) if ok else 0
    log(f"terasort_capacity [{card}]: the largest TeraSort that fits of {list(TC_ROWS)} rows, each "
        f"in a fresh process: eager {res['eager_largest_rows']}, graphs {res['graphs_largest_rows']}")
    return res


def terasort_capacity_child(mode: str, rows: int, out_path: str) -> int:
    """Child: TeraSort of ``rows`` seeded rows (the first ``rows`` of
    one 2^29-row draw) on a fresh context with the programs as graphs
    or eager; the first collect ingests (and captures), the second is
    timed and its keys checked sorted.  Writes to ``out_path`` the warm
    seconds or the out-of-memory error, the reserved and allocated
    peaks, and the bytes the programs and the graph pool hold."""
    from dryad_tpu_torch import DryadContext
    from dryad_tpu_torch.exec.programs import pool_bytes

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 4)
    key = rng.integers(-2**31, 2**31, max(TC_ROWS), dtype=np.int32)[:rows]
    pay = rng.random(max(TC_ROWS), dtype=np.float32)[:rows]
    ctx = DryadContext(num_partitions_=P)
    ctx.executor.programs.graphs = mode == "graphs"
    q = ctx.from_arrays({"key": key, "payload": pay}).order_by([("key", False)])
    cell = {"mode": mode, "rows": rows, "total_bytes": torch.cuda.mem_get_info(dev)[1]}
    try:
        q.collect()  # ingest, and the capture with the graphs on
        t0 = time.perf_counter()
        out = q.collect()
        cell["warm_s"] = time.perf_counter() - t0
        check(len(out["key"]) == rows and bool((np.diff(out["key"]) >= 0).all()),
              f"terasort_capacity {mode} {rows}: keys not sorted")
    except (torch.cuda.OutOfMemoryError, RuntimeError) as e:
        if not _out_of_memory(e):
            raise
        cell["out_of_memory"] = str(e)[:1000]
    cell["peak_bytes"] = card_peak()
    cell["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    cell["peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
    cell["programs_bytes"] = ctx.executor.programs.held_bytes() + pool_bytes(dev)
    with open(out_path, "w") as fh:
        json.dump(cell, fh)
    return 0


def groupby_table(rng, rows: int, nkeys: int) -> dict:
    """``nkeys`` distinct int32 keys, one in each of nkeys equal bins of
    the int32 range (negatives included), drawn uniformly per row."""
    width = (1 << 32) // nkeys
    pool = (np.arange(nkeys, dtype=np.int64) * width + rng.integers(0, width, nkeys) - 2**31)
    return {
        "key": pool.astype(np.int32)[rng.integers(0, nkeys, rows)],
        "v": (rng.standard_normal(rows) * 100).astype(np.float32),
        "w": rng.integers(-1000, 1000, rows, dtype=np.int32),
        "L": rng.integers(-2**40, 2**40, rows, dtype=np.int64),
    }


GB_AGGS = {"c": ("count", None), "sv": ("sum", "v"), "mv": ("mean", "v"),
           "mnw": ("min", "w"), "mxw": ("max", "w"), "sL": ("sum", "L")}


def groupby_oracle(t: dict) -> dict:
    """float64 and exact int64 sums over the key-sorted rows (the order
    within a key moves the float64 sums by far less than the bound, so
    the faster unstable argsort serves)."""
    order = np.argsort(t["key"])
    ks = t["key"][order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    v = t["v"][order].astype(np.float64)
    w = t["w"][order]
    return {"ks": ks, "uniq": ks[starts], "cnt": np.diff(np.r_[starts, len(ks)]),
            "sv": np.add.reduceat(v, starts), "av": np.add.reduceat(np.abs(v), starts),
            "mnw": np.minimum.reduceat(w, starts), "mxw": np.maximum.reduceat(w, starts),
            "sL": np.add.reduceat(t["L"][order], starts)}


def check_groupby(out: dict, oracle: dict, label: str) -> float:
    """GB_AGGS's result against the oracle: keys, counts, min/max and
    int64 sums exact, f32 sums and means within n_g * 2^-23 * sum|v|;
    returns the largest |err| / sum|v| of the sums."""
    got = np.argsort(out["key"])
    o = {c: a[got] for c, a in out.items()}
    cnt, av, sv = oracle["cnt"], oracle["av"], oracle["sv"]
    check(np.array_equal(o["key"], oracle["uniq"]), f"{label}: keys differ from the oracle's")
    check(np.array_equal(o["c"], cnt.astype(np.int32)), f"{label}: counts differ")
    check(np.array_equal(o["mnw"], oracle["mnw"]), f"{label}: min differs")
    check(np.array_equal(o["mxw"], oracle["mxw"]), f"{label}: max differs")
    check(np.array_equal(o["sL"], oracle["sL"]), f"{label}: int64 sums differ")
    bound = cnt * F32_REL * av
    err = np.abs(o["sv"] - sv)
    check(bool((err <= bound).all()), f"{label}: f32 sums past n_g * 2^-23 * sum|v|")
    merr = np.abs(o["mv"] - sv / cnt)
    check(bool((merr <= bound / cnt).all()), f"{label}: f32 means past the bound")
    return float((err / np.maximum(av, 1e-30)).max())


_GB_INPUTS: dict = {}


def groupby_inputs() -> tuple:
    """The groupby_sort table and its oracle, made once for the phases
    that share them (set-up, not measured work)."""
    if not _GB_INPUTS:
        t = groupby_table(np.random.default_rng(SEED + 6), GB_ROWS, GB_KEYS)
        _GB_INPUTS.update(t=t, oracle=groupby_oracle(t))
    return _GB_INPUTS["t"], _GB_INPUTS["oracle"]


def phase_groupby_sort(dev, card: str) -> dict:
    from dryad_tpu_torch import DryadContext

    t, oracle = groupby_inputs()
    ctx = DryadContext(num_partitions_=P)
    src = ctx.from_arrays(t)
    q = src.group_by("key", GB_AGGS)
    res, out = timed_runs(ctx, q, "groupby_sort", card, GB_ROWS)

    uniq, ks = oracle["uniq"], oracle["ks"]
    res["max_rel_err_sum"] = check_groupby(out, oracle, "groupby_sort")
    del out
    res["distinct_keys"] = int(len(uniq))
    log(f"groupby_sort: {len(uniq)} groups; keys, counts, min/max, int64 sums exact; f32 sums "
        f"within n_g*2^-23*sum|v| (max |err|/sum|v| {res['max_rel_err_sum']:.3g})")

    # distinct over the key
    t0 = time.perf_counter()
    d = src.distinct(["key"]).collect()
    res["distinct_s"] = time.perf_counter() - t0
    check(np.array_equal(np.sort(d["key"]), uniq), "distinct: keys differ from np.unique")
    check(overflow_retries(ctx) == 0, "distinct retried an overflow")
    # range_partition over the key: disjoint ascending key ranges
    t0 = time.perf_counter()
    b = ctx.execute(src.range_partition(["key"]))
    keys = b.data["key"]
    big = torch.iinfo(torch.int32)
    lo = torch.where(b.valid, keys, big.max).amin(-1).cpu().numpy()
    hi = torch.where(b.valid, keys, big.min).amax(-1).cpu().numpy()
    n_part = b.valid.sum(-1).cpu().numpy()
    flat = keys[b.valid].cpu().numpy()
    res["range_partition_s"] = time.perf_counter() - t0
    check(overflow_retries(ctx) == 0, "range_partition retried an overflow")
    check(int(n_part.sum()) == GB_ROWS, "range_partition lost rows")
    check(np.array_equal(np.sort(flat), ks), "range_partition: keys differ from the input's")
    live = [p for p in range(P) if n_part[p]]
    check(all(hi[a] < lo[b_] for a, b_ in zip(live, live[1:])),
          "range_partition: partitions' key ranges overlap or are out of order")
    res["range_partition_rows"] = n_part.tolist()
    log(f"groupby_sort: distinct {res['distinct_s']:.3f} s and range_partition "
        f"{res['range_partition_s']:.3f} s (warm, host checks included) match the oracle; "
        f"rows per partition {n_part.tolist()}")
    del ctx, src, q, b, keys, flat
    free_card()
    return res


# -- stage programs: each region one CUDA graph, captured once a key ------------

PG_SERVE_ROWS = 1 << 19  # one serve tenant's table (the serve phase's cap=2^19 shape)
PG_PAIRS = 10  # warm graph / eager pairs, alternating
_PG: dict = {}  # the wordcount phase's tokenized corpus, for the programs phase


def program_cell(ctx, q, label: str, card: str, check_out) -> dict:
    """One query through its stage programs (``exec/programs.py``): the
    first collect captures one CUDA graph a region and logs one
    ``xla_compile`` a region (its capture seconds printed); then
    PG_PAIRS pairs of warm collects with the executor's programs as
    graphs and as eager functions (``executor.programs.graphs``), in
    alternating order: every graph collect logs no compile, every
    collect is byte-equal to the first; the medians; the last pair's
    peak device memory (allocated and reserved, from the run's start);
    the bytes the programs hold and their pools'."""
    import statistics

    from dryad_tpu_torch.exec.programs import pool_bytes

    progs = ctx.executor.programs
    check(progs.graphs, f"{label}: the context's programs are not CUDA graphs")
    log_ = ctx.events
    mark = len(log_.events())
    cached = len(progs)  # a context that ran before may still hold some
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = q.collect()
    cold_s = time.perf_counter() - t0
    new = log_.events()[mark:]
    comp = [e for e in new if e["kind"] == "xla_compile"]
    units = [e["name"] for e in new if e["kind"] == "stage_start"]
    stages = [e["stage"] for e in comp]
    # one compile a program built: every region on a fresh context, the
    # released ones on a context that ran before
    check(len(comp) == len(progs) - cached and all(st in units for st in stages)
          and (cached or stages == units),
          f"{label}: xla_compile {stages} for the regions {units} ({cached} programs cached before)")
    check_out(first)
    ref = digest(first)
    del first
    times, peaks = {True: [], False: []}, {}
    for i in range(PG_PAIRS):
        for graph in ((True, False) if i % 2 == 0 else (False, True)):
            progs.graphs = graph
            mark = len(log_.events())
            torch.cuda.synchronize()
            if i == PG_PAIRS - 1:
                torch.cuda.reset_peak_memory_stats()
                base = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
            t0 = time.perf_counter()
            out = q.collect()
            times[graph].append(time.perf_counter() - t0)
            if i == PG_PAIRS - 1:
                peaks[graph] = (torch.cuda.max_memory_allocated() - base[0],
                                torch.cuda.max_memory_reserved() - base[1])
            check(digest(out) == ref, f"{label}: a {'graph' if graph else 'eager'} collect differs "
                  "from the first")
            del out
            if graph:
                again = [e for e in log_.events()[mark:] if e["kind"] == "xla_compile"]
                check(not again, f"{label}: a warm collect compiled {[e['stage'] for e in again]}")
    progs.graphs = True
    graphs = [p for p in progs._progs.values() if p.graph_mode]
    # what a dispatch pays to copy its inputs into the graphs' buffers:
    # the same copies, timed on the card (CUDA events, mean of 5)
    bufs = [t for p in graphs for b in p._in for t in (*b.data.values(), b.valid)]
    srcs = [t.clone() for t in bufs]
    copy_ms = cuda_time_ms(lambda: [d.copy_(s_) for d, s_ in zip(bufs, srcs)], 5)
    del srcs
    res = {
        "input_bytes": sum(t.numel() * t.element_size() for t in bufs), "input_copy_ms": copy_ms,
        "regions": units, "capture_s": [e["compile_s"] for e in comp],
        "build_s": [e["trace_s"] for e in comp], "first_query_s": cold_s,
        "graph_warm_s": times[True], "eager_warm_s": times[False],
        "graph_median_s": statistics.median(times[True]),
        "eager_median_s": statistics.median(times[False]),
        "held_bytes": sum(p.held_bytes for p in graphs),
        "pool_bytes": sum(p.pool_bytes for p in graphs),
        "process_pool_bytes": pool_bytes(ctx.device), "evictions": progs.evictions,
        "graph_peak_allocated": peaks[True][0], "graph_peak_reserved": peaks[True][1],
        "eager_peak_allocated": peaks[False][0], "eager_peak_reserved": peaks[False][1],
        "bucket_launches_a_replay": [p._launches for p in graphs],
    }
    res["graph_over_eager"] = res["graph_median_s"] / res["eager_median_s"]
    log(f"programs {label} [{card}]: first collect {cold_s:.3f} s with {len(comp)} capture(s) "
        f"{[round(x, 4) for x in res['capture_s']]} s (build {[round(x, 5) for x in res['build_s']]} s) "
        f"for the regions {units}; warm median graph {res['graph_median_s']:.4f} s against eager "
        f"{res['eager_median_s']:.4f} s ({res['graph_over_eager']:.3f}x) in {PG_PAIRS} pairs (of "
        f"it the input copy, {res['input_bytes'] / 1e9:.3f} GB, {copy_ms:.3f} ms), "
        f"every collect byte-equal, no compile when warm; its programs' buffers hold "
        f"{res['held_bytes'] / 1e9:.3f} GB, their captures grew the shared pool by "
        f"{res['pool_bytes'] / 1e9:.3f} GB (the process's pool {res['process_pool_bytes'] / 1e9:.3f} "
        f"GB), {res['evictions']} evictions; a warm run's peak above its start: graph "
        f"{peaks[True][0] / 1e9:.3f} GB allocated / {peaks[True][1] / 1e9:.3f} GB reserved, eager "
        f"{peaks[False][0] / 1e9:.3f} / {peaks[False][1] / 1e9:.3f} GB")
    return res


def phase_programs(dev, card: str) -> dict:
    """Stage programs on the card: the sort-path group_by (2^26 rows,
    2^22 keys), WordCount of the wordcount phase's 2^26 words and one
    serve tenant's count+mean over PG_SERVE_ROWS rows, each through
    :func:`program_cell`; the bucket kernel's launches counted through
    the replays."""
    from dryad_tpu_torch import DryadContext
    from dryad_tpu_torch.ops.bucket import bucket_sum_count

    free_card()
    t_phase = time.perf_counter()
    res = {"card": card, "pairs": PG_PAIRS}
    bucket_sum_count.launches = 0  # the programs path starts here
    # a TeraSort dispatch's input copy: the 2^28-row table's columns
    # (int32 key, f32 payload, bool mask), device to device
    cols = [torch.empty(TS_ROWS, dtype=d, device=dev) for d in (torch.int32, torch.float32, torch.bool)]
    dst = [torch.empty_like(c) for c in cols]
    res["terasort_input_copy_ms"] = cuda_time_ms(lambda: [d.copy_(c) for d, c in zip(dst, cols)], 5)
    log(f"programs [{card}]: a {TS_ROWS}-row TeraSort table's input copy "
        f"({sum(c.numel() * c.element_size() for c in cols) / 1e9:.3f} GB) takes "
        f"{res['terasort_input_copy_ms']:.3f} ms a dispatch")
    del cols, dst
    t, oracle = groupby_inputs()
    ctx = DryadContext(num_partitions_=P)
    q = ctx.from_arrays(t).group_by("key", GB_AGGS)
    res["groupby_sort"] = program_cell(ctx, q, "groupby_sort", card,
                                       lambda out: check_groupby(out, oracle, "programs group_by"))
    del ctx, q
    free_card()

    if "wordcount" in _PG:
        ctx, q, wc_oracle = _PG.pop("wordcount")
        # the wordcount phase's context sat idle since: its programs are
        # nobody's running job's, so a capture that took the process
        # past its byte budget (TeraSort's) released them
        idle = ctx.executor.programs
        kept = sum(p.graph is not None for p in idle._progs.values())
        res["idle_wordcount"] = {"evictions": idle.evictions, "graphs_kept": kept}
        log(f"programs [{card}]: the wordcount phase's context, idle since, lost {idle.evictions} "
            f"programs to the byte budget and keeps {kept} graphs")
        if "terasort" in _PG.get("ran", ()):
            check(idle.evictions > 0 and kept == 0,
                  f"the idle wordcount context kept {kept} graphs through TeraSort's captures "
                  f"({idle.evictions} evicted)")
    else:  # the wordcount phase did not run: its corpus here
        path = os.path.join(WORK_DIR, "programs_words.txt")
        os.makedirs(WORK_DIR, exist_ok=True)
        wc_oracle = _wordcount_text(path)
        ctx = DryadContext(num_partitions_=P)
        q = ctx.from_text(path).group_by("word", {"n": ("count", None)})
        os.remove(path)

    def wc_check(out):
        check(dict(zip(out["word"].tolist(), out["n"].tolist())) == wc_oracle,
              "programs WordCount differs from the numpy oracle")

    before = bucket_sum_count.launches
    res["wordcount"] = program_cell(ctx, q, "wordcount", card, wc_check)
    n = res["wordcount"]["launches"] = bucket_sum_count.launches - before
    check(n == 1 + 2 * PG_PAIRS,
          f"programs WordCount: {n} bucket kernel launches for {1 + 2 * PG_PAIRS} collects")
    del ctx, q
    free_card()

    vocab, ids, data = serve_tables(np.random.default_rng(SEED + 11), rows=PG_SERVE_ROWS)[0]
    ctx = DryadContext(num_partitions_=P)
    q = ctx.from_arrays(data).group_by("k", {"c": ("count", None), "m": ("mean", "w")})
    res["serve"] = program_cell(ctx, q, "serve count+mean", card,
                                lambda out: serve_oracle(1, out, vocab, ids, data))
    del ctx, q
    free_card()
    # a read to the host inside a captured region raises TypeError
    # naming the unit, as the reference's trace does
    ctx = DryadContext(num_partitions_=P)
    bad = ctx.from_arrays({"x": np.arange(1 << 12, dtype=np.int32)}).select(_pg_host_read)
    try:
        bad.collect()
        raised = None
    except TypeError as e:
        raised = str(e)
    check(raised is not None and "select" in raised,
          f"a host read inside a capture gave {raised!r}, not a TypeError naming the unit")
    res["host_read_error"] = raised
    log(f"programs [{card}]: a host read inside a capture raised TypeError: {raised[:160]}")
    del ctx, bad
    free_card()
    res["launches"] = bucket_sum_count.launches  # the programs path ends here
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"programs phase [{card}]: {res['phase_s']:.1f} s")
    return res


def _pg_host_read(c):
    """A select that reads a device value on the host."""
    return {"x": c["x"] + int(c["x"].max())}


# -- the hybrid DCN x ICI mesh and the staged exchange -------------------------

HY_DCN = 2  # slices of the hybrid context: 2 x 4 partitions
HY_TS_WINDOWS = (0, 1, 2, 4)  # TeraSort's exchange windows on the flat context
HY_TS_HYBRID_WINDOW = 2
# each phase's flat result that the hybrid phase is held to (the
# wordcount phase's table, kept when it ran in the same run)
_FLAT: dict = {}


def _exchange_rounds(ctx, mark: int) -> list:
    """The exchange_round events the context logged since event ``mark``."""
    return [e for e in ctx.events.events()[mark:] if e["kind"] == "exchange_round"]


def _same_rows(a: dict, b: dict) -> bool:
    """Every column of two host tables byte-equal (without copies)."""
    return sorted(a) == sorted(b) and all(
        a[c].dtype == b[c].dtype and a[c].shape == b[c].shape
        and np.array_equal(a[c].view(np.uint8), b[c].view(np.uint8)) for c in a)


def _round_bytes(rounds: list) -> dict:
    return {"rounds": len(rounds), "peak_bytes": max((r["bytes"] for r in rounds), default=0),
            "ici_bytes": sum(r["ici_bytes"] for r in rounds),
            "dcn_bytes": sum(r["dcn_bytes"] for r in rounds),
            "windows": sorted({r["window"] for r in rounds})}


def _wordcount_text(path: str) -> dict:
    """The wordcount phase's corpus written to ``path``; its numpy oracle."""
    rng = np.random.default_rng(SEED + 2)
    ids = zipf_ids(rng, WC_WORDS)
    tab = vocab_table()
    words = np.array([bytes(r).split()[0].decode() for r in tab], object)
    with open(path, "wb") as fh:
        fh.write(tab[ids].tobytes())
    uid, ucnt = np.unique(ids, return_counts=True)
    return dict(zip(words[uid].tolist(), ucnt.tolist()))


def phase_hybrid(dev, card: str) -> dict:
    """The hybrid DCN x ICI mesh in one process: ``DryadContext(dcn_slices=2)``,
    2 slices of 4 partitions (P = 8), beside the flat context.

    (a) WordCount over the wordcount phase's 2^26 Zipf(1.1) words: the
    table byte-equal to the flat context's, the bucket kernel's launches
    counted from 0 and its first launch held against its plain version.
    (b) The sort-path group_by (2^26 rows, 2^22 keys, negatives included,
    so it takes the tree exchange: ICI hop, per-slice reduce, DCN hop):
    integers byte-equal to the flat context's, float sums within
    n_g * 2^-23 * sum_g |v|; warm seconds flat, hybrid, hybrid, flat; the
    exchange_round events' ICI and DCN bytes against flat's.
    (c) TeraSort of 2^28 rows on the flat context at exchange_window 0, 1,
    2 and 4 and on the hybrid context at 2: rows byte-equal to window 0,
    warm seconds and peak device memory per window, and the events'
    peak staged bytes times P equal to the flat peak times the window.
    (d) exchange_window = -1 on the same table with telemetry off, at
    budgets of 256, 4096 and 16384 MiB: the window each resolves to."""
    from dryad_tpu_torch import DryadConfig, DryadContext
    from dryad_tpu_torch.ops.bucket import bucket_sum_count
    from dryad_tpu_torch.exec.programs import pool_bytes
    from dryad_tpu_torch.plan.xchgplan import resolve_window

    free_card()
    t_phase = time.perf_counter()
    res = {"card": card, "dcn_slices": HY_DCN, "ici": P // HY_DCN}

    def ctx_of(hybrid: bool, **cfg):
        mesh = {"dcn_slices": HY_DCN} if hybrid else {"num_partitions_": P}
        return DryadContext(config=DryadConfig(obs_events_mem_cap=0, **cfg), **mesh)

    # (a) WordCount
    os.makedirs(WORK_DIR, exist_ok=True)
    path = os.path.join(WORK_DIR, "hybrid_words.txt")
    oracle = _wordcount_text(path)
    if "wordcount" not in _FLAT:  # the wordcount phase did not run: the flat twin here
        fq = ctx_of(False).from_text(path).group_by("word", {"n": ("count", None)})
        fq.collect()
        t0 = time.perf_counter()
        _FLAT["wordcount"] = (fq.collect(), time.perf_counter() - t0)
        del fq
        free_card()
    flat_wc, flat_warm_s = _FLAT["wordcount"]  # kept: the stream phase's in-core twin too
    hctx = ctx_of(True)
    check(hctx.mesh.hybrid and (hctx.mesh.dcn, hctx.mesh.ici) == (HY_DCN, P // HY_DCN),
          f"the hybrid context's mesh is {hctx.mesh}")
    t0 = time.perf_counter()
    q = hctx.from_text(path).group_by("word", {"n": ("count", None)})
    tok_s = time.perf_counter() - t0
    os.remove(path)
    bucket_sum_count.launches = 0  # the hybrid path starts here
    with LaunchRecorder() as rec:
        t0 = time.perf_counter()
        table = q.collect()
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        table = q.collect()
        warm_s = time.perf_counter() - t0
    launches = bucket_sum_count.launches
    check(launches >= 2, f"hybrid WordCount ran the bucket kernel {launches} times, expected 2")
    check(dict(zip(table["word"].tolist(), table["n"].tolist())) == oracle,
          "hybrid WordCount differs from the numpy oracle")
    check(table["word"].tolist() == flat_wc["word"].tolist()
          and table["n"].tobytes() == flat_wc["n"].tobytes(),
          "hybrid WordCount differs from the flat context's table")
    ((_m, K, _cap), (keys, vals, valid)), = rec.first.items()
    shape = kernel_shape_report(keys, vals, valid, K)
    res["wordcount"] = {"words": WC_WORDS, "tokenize_and_register_s": tok_s, "first_query_s": cold_s,
                        "warm_query_s": warm_s, "flat_warm_query_s": flat_warm_s,
                        "launches": launches, "kernel_shape": shape}
    log(f"hybrid wordcount [{card}]: {WC_WORDS} words on the {HY_DCN} x {P // HY_DCN} mesh, table "
        f"byte-equal to the flat context's and equal to the oracle; tokenize+register {tok_s:.2f} s, "
        f"first query {cold_s:.3f} s, warm {warm_s:.4f} s (flat {flat_warm_s:.4f} s); bucket "
        f"kernel launches {launches}; "
        f"kernel vs plain at {shape['shape']}: byte-equal, kernel {shape['kernel_ms']:.3f} ms, plain "
        f"{shape['plain_ms']:.3f} ms, {shape['library']} {shape['library_ms']:.3f} ms, bound "
        f"{shape['bound_ms']:.4f} ms")
    del q, table, flat_wc, hctx, keys, vals, valid, rec
    free_card()

    # (b) the sort-path group_by through the tree exchange
    t, gb_oracle = groupby_inputs()
    ctxs = {False: ctx_of(False), True: ctx_of(True)}
    qs = {h: c.from_arrays(t).group_by("key", GB_AGGS) for h, c in ctxs.items()}
    outs, times, rounds = {}, {False: [], True: []}, {}
    for h in (False, True):  # cold: ingest and first run
        outs[h] = qs[h].collect()
    for h in (False, True, True, False):
        mark = len(ctxs[h].events.events())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = qs[h].collect()
        times[h].append(time.perf_counter() - t0)
        rounds[h] = _round_bytes(_exchange_rounds(ctxs[h], mark))
        check(digest(out) == digest(outs[h]), f"group_by ({'hybrid' if h else 'flat'}): reruns differ")
        del out
    for h, c in ctxs.items():
        check(overflow_retries(c) == 0, "the group_by retried an overflow")
    f, hy = ({c: a[np.argsort(o["key"])] for c, a in o.items()} for o in (outs[False], outs[True]))
    for c in ("key", "c", "mnw", "mxw", "sL"):
        check(f[c].dtype == hy[c].dtype and f[c].tobytes() == hy[c].tobytes(),
              f"hybrid group_by: {c} differs from the flat context's")
    err = check_groupby(outs[True], gb_oracle, "hybrid group_by")
    check(rounds[True]["dcn_bytes"] > 0 and rounds[False]["dcn_bytes"] == 0,
          f"exchange bytes by fabric: flat {rounds[False]}, hybrid {rounds[True]}")
    res["groupby"] = {"rows": GB_ROWS, "keys": GB_KEYS, "flat_warm_s": times[False],
                      "hybrid_warm_s": times[True], "flat_rounds": rounds[False],
                      "hybrid_rounds": rounds[True], "max_rel_err_sum": err}
    log(f"hybrid group_by [{card}]: {GB_ROWS} rows, {len(gb_oracle['uniq'])} groups through the tree "
        f"exchange; integers byte-equal to the flat context's, f32 sums within n_g*2^-23*sum|v| "
        f"(max |err|/sum|v| {err:.3g}); warm flat {times[False]} s, hybrid {times[True]} s; "
        f"exchange_round per query: flat {rounds[False]}, hybrid {rounds[True]}")
    del ctxs, qs, outs, f, hy
    free_card()

    # (c) TeraSort at each window; (d) the auto window
    rng = np.random.default_rng(SEED + 4)  # the terasort phase's table
    ts = {"key": rng.integers(-2**31, 2**31, TS_ROWS, dtype=np.int32),
          "payload": rng.random(TS_ROWS, dtype=np.float32)}
    runs = [(False, w) for w in HY_TS_WINDOWS] + [(True, HY_TS_HYBRID_WINDOW)]
    res["terasort"] = {}
    base = None
    for hybrid in (False, True):
        ctx = ctx_of(hybrid, obs_telemetry=False)
        q = ctx.from_arrays(ts).order_by([("key", False)])
        q.collect()  # ingest to the device cache
        for h, w in runs:
            if h != hybrid:
                continue
            label = f"{'hybrid' if hybrid else 'flat'} window {w}"
            ctx.config.exchange_window = w
            q.collect()  # first run at this window
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mark = len(ctx.events.events())
            t0 = time.perf_counter()
            out = q.collect()
            secs = time.perf_counter() - t0
            # a graph's replay allocates none of its intermediates: they
            # live in its pool, which card_peak and the programs' held
            # bytes show
            peak, peak_alloc = card_peak(), torch.cuda.max_memory_allocated()
            held = ctx.executor.programs.held_bytes() + pool_bytes(ctx.device)
            rb = _round_bytes(_exchange_rounds(ctx, mark))
            check(overflow_retries(ctx) == 0, f"TeraSort {label} retried an overflow")
            check(rb["windows"] == [w], f"TeraSort {label}: events at windows {rb['windows']}")
            if base is None:
                check(len(out["key"]) == TS_ROWS and bool((np.diff(out["key"]) >= 0).all()),
                      "TeraSort window 0: keys not sorted")
                base, base_rb = out, rb
            else:
                check(_same_rows(out, base), f"TeraSort {label} differs from window 0's rows")
                if not hybrid:
                    check(rb["peak_bytes"] * P == base_rb["peak_bytes"] * w,
                          f"TeraSort {label}: peak staged bytes {rb['peak_bytes']} x P != flat "
                          f"{base_rb['peak_bytes']} x {w}")
            res["terasort"][label] = {"warm_s": secs, "peak_bytes": peak,
                                      "peak_allocated_bytes": peak_alloc, "programs_held_bytes": held,
                                      "program_evictions": ctx.executor.programs.evictions, **rb}
            log(f"hybrid terasort [{card}] {label}: {TS_ROWS} rows byte-equal to window 0, warm "
                f"{secs:.4f} s, peak device memory (allocated + graph pool) {peak / 1e9:.3f} GB "
                f"({peak_alloc / 1e9:.3f} GB allocated), the context's programs and the process's "
                f"graph pool holding {held / 1e9:.3f} GB ({ctx.executor.programs.evictions} "
                f"evicted), "
                f"exchange_round {rb}")
            del out
        if not hybrid:  # (d) the auto window over the same table
            res["auto_window"] = {}
            ctx.config.exchange_window = -1
            for mb in (256, 4096, 16384):
                ctx.config.exchange_hbm_budget_mb = mb
                mark = len(ctx.events.events())
                out = q.collect()
                rb = _round_bytes(_exchange_rounds(ctx, mark))
                check(_same_rows(out, base),
                      f"TeraSort at the auto window ({mb} MiB) differs from window 0's rows")
                res["auto_window"][mb] = rb["windows"]
                log(f"hybrid terasort [{card}] exchange_window=-1, budget {mb} MiB, telemetry off: "
                    f"resolved window {rb['windows']}, rows byte-equal to window 0")
                del out
            # the executor's bucket estimate: a partition's rows x slack x
            # 2 columns x 8 bytes (1 GiB at 2^28 rows: windows 1, 4 and 0)
            est = int(TS_ROWS // P * ctx.config.shuffle_slack) * 2 * 8
            want = {mb: [resolve_window(-1, P, est, mb << 20)] for mb in res["auto_window"]}
            check(res["auto_window"] == want, f"auto windows {res['auto_window']}, expected {want}")
        del ctx, q
        free_card()
    del base, ts
    res["launches"] = launches
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"hybrid phase [{card}]: {res['phase_s']:.1f} s")
    return res


# -- phases 9-10: joins at full size -------------------------------------------

class StrategySpy:
    """Records each placement the join kernel chooses (True = broadcast
    the right side, False = co-hash-partition) while installed."""

    def __init__(self):
        from dryad_tpu_torch.exec import kernels

        self.mod, self.real, self.chosen = kernels, kernels._join_strategy, []

    def __enter__(self):
        def spy(ctx, p, right):
            self.chosen.append(self.real(ctx, p, right))
            return self.chosen[-1]

        self.mod._join_strategy = spy
        return self

    def __exit__(self, *exc):
        self.mod._join_strategy = self.real


def visits_tables(rng) -> tuple:
    """UserVisits and Rankings of the Join Task: 2^26 visits of 2^22
    distinct sourceIPs spread over the int32 range; each destURL a
    64-bit page id drawn from the 2^23 unique pageURLs."""
    width = (1 << 32) // JS_IPS
    ips = (np.arange(JS_IPS, dtype=np.int64) * width + rng.integers(0, width, JS_IPS)
           - 2**31).astype(np.int32)
    # an odd multiplier is a bijection of 64-bit words: unique ids
    pages = (np.arange(JS_PAGES, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
             + np.uint64(12345)).view(np.int64)
    visits = {
        "sourceIP": ips[rng.integers(0, JS_IPS, JS_VISITS)],
        "destURL": pages[rng.integers(0, JS_PAGES, JS_VISITS)],
        "adRevenue": (rng.random(JS_VISITS, dtype=np.float32) * 1000).astype(np.float32),
        "visitDate": rng.integers(0, JS_DAYS, JS_VISITS).astype(np.int32),
    }
    rankings = {
        "pageURL": pages,
        "pageRank": rng.integers(0, 10000, JS_PAGES).astype(np.int32),
        "avgDuration": rng.integers(1, 600, JS_PAGES).astype(np.int32),
    }
    return visits, rankings


JS_AGGS = {"totalRevenue": ("sum", "adRevenue"), "avgPageRank": ("mean", "pageRank"),
           "n": ("count", None)}


def check_join_task(table: dict, visits: dict, rankings: dict, label: str) -> tuple:
    """The grouped Join Task table against a float64 oracle: sourceIPs
    and counts exact, revenue within n_g * 2^-23 * sum|v|, the mean
    pageRank within f32 rounding.  Returns (window mask, keys, counts,
    |revenue error|)."""
    lo, hi = JS_WEEK
    keep = (visits["visitDate"] >= lo) & (visits["visitDate"] < hi)
    order = np.argsort(rankings["pageURL"])
    at = np.searchsorted(rankings["pageURL"], visits["destURL"][keep], sorter=order)
    pr = rankings["pageRank"][order[at]].astype(np.float64)
    uk, inv = np.unique(visits["sourceIP"][keep], return_inverse=True)
    cnt = np.bincount(inv)
    rev = np.bincount(inv, weights=visits["adRevenue"][keep].astype(np.float64))
    mean_pr = np.bincount(inv, weights=pr) / cnt
    o = np.argsort(table["sourceIP"])
    got = {c: a[o] for c, a in table.items()}
    check(np.array_equal(got["sourceIP"], uk), f"{label}: sourceIPs differ from the oracle's")
    check(np.array_equal(got["n"], cnt.astype(np.int32)), f"{label}: counts differ")
    err = np.abs(got["totalRevenue"] - rev)
    check(bool((err <= cnt * F32_REL * rev).all()),  # adRevenue >= 0: sum |v| = sum v
          f"{label}: revenue sums past n_g * 2^-23 * sum|v|")
    check(bool((np.abs(got["avgPageRank"] - mean_pr) <= 2.0 ** -22 * mean_pr + 1e-6).all()),
          f"{label}: mean pageRank past f32 rounding")
    return keep, uk, cnt, err / np.maximum(rev, 1e-30)


def phase_join_shuffle(dev, card: str) -> dict:
    """The Join Task: visits in a one-week window, joined to their
    page's rank (``auto`` must shuffle: the right side's capacity is far
    past ``broadcast_limit``), grouped by sourceIP (the sort path: the
    keys are negative too), then the top source by revenue."""
    from dryad_tpu_torch import DryadConfig, DryadContext

    rng = np.random.default_rng(SEED + 8)
    visits, rankings = visits_tables(rng)
    lo, hi = JS_WEEK
    ctx = DryadContext(num_partitions_=P, config=DryadConfig(device_cache_bytes=JOIN_CACHE_BYTES))
    v = ctx.from_arrays(visits).where(lambda c: (c["visitDate"] >= lo) & (c["visitDate"] < hi))
    j = v.join(ctx.from_arrays(rankings), "destURL", "pageURL", strategy="auto", expansion=1.0)
    g = j.group_by("sourceIP", JS_AGGS)
    q = g.order_by([("totalRevenue", True)]).take(1)
    with StrategySpy() as spy:
        res, top = timed_runs(ctx, q, "join_shuffle", card, JS_VISITS)
        table = g.collect()
    check(overflow_retries(ctx) == 0, "join_shuffle: the grouped table retried an overflow")
    check(spy.chosen and not any(spy.chosen), f"join_shuffle: auto chose {spy.chosen}, not shuffle")
    res["auto_chose"] = "shuffle"

    keep, uk, cnt, rel_err = check_join_task(table, visits, rankings, "join_shuffle")
    best = int(np.argmax(table["totalRevenue"]))
    check(top["totalRevenue"].tolist() == [table["totalRevenue"][best]]
          and top["sourceIP"].tolist() == [table["sourceIP"][best]],
          "join_shuffle: the top-1 row is not the grouped table's largest revenue")
    res.update(visits_in_window=int(keep.sum()), groups=int(len(uk)),
               max_rel_err_revenue=float(rel_err.max()))
    log(f"join_shuffle: auto chose shuffle; {res['visits_in_window']} visits in the window, "
        f"{len(uk)} sourceIPs: keys and counts exact, revenue within n_g*2^-23*sum|v| "
        f"(max rel err {res['max_rel_err_revenue']:.3g}), top-1 {top['sourceIP'][0]} "
        f"{top['totalRevenue'][0]:.2f}")
    del ctx, v, j, g, q, table, visits, rankings
    free_card()
    return res


def phase_join_broadcast(dev, card: str) -> dict:
    """samples/join_groupby.py at 2^26 orders: ``auto`` replicates the
    1000 customers to every partition, and the dense group_by over the 7
    regions runs the bucket kernel (its launches are counted).  The
    join's ``expansion=1.0`` (each order has one customer): the sample's
    default 4.0 would size the pair buffer at 2^25 rows a partition, past
    the dense path's 2^24 guard, in the reference as here."""
    from dryad_tpu_torch import DryadConfig, DryadContext

    rng = np.random.default_rng(SEED + 9)
    orders = {"cust": rng.integers(0, JB_CUSTOMERS, JB_ORDERS).astype(np.int32),
              "amount": rng.gamma(2.0, 10.0, JB_ORDERS).astype(np.float32)}
    customers = {"cust": np.arange(JB_CUSTOMERS, dtype=np.int32),
                 "region": (np.arange(JB_CUSTOMERS) % JB_REGIONS).astype(np.int32)}
    ctx = DryadContext(num_partitions_=P, config=DryadConfig(device_cache_bytes=JOIN_CACHE_BYTES))
    q = (ctx.from_arrays(orders)
         .join(ctx.from_arrays(customers), "cust", strategy="auto", expansion=1.0)
         .group_by("region", {"total": ("sum", "amount"), "orders": ("count", None)},
                   dense=JB_REGIONS))
    with StrategySpy() as spy:
        res, out = timed_runs(ctx, q, "join_broadcast", card, JB_ORDERS)
    check(spy.chosen and all(spy.chosen), f"join_broadcast: auto chose {spy.chosen}, not broadcast")
    launches = res["bucket_sum_count_launches"]
    check(launches == 4, f"join_broadcast ran the bucket kernel {launches} times, expected 4")
    region = orders["cust"] % JB_REGIONS
    amount = orders["amount"].astype(np.float64)
    cnt = np.bincount(region, minlength=JB_REGIONS)
    exact = np.bincount(region, weights=amount, minlength=JB_REGIONS)
    check(np.array_equal(out["region"], np.arange(JB_REGIONS)), "join_broadcast: regions differ")
    check(np.array_equal(out["orders"], cnt.astype(np.int32)), "join_broadcast: counts differ")
    err = np.abs(out["total"] - exact)
    check(bool((err <= FLOAT_REL * exact).all()),  # amount > 0: sum |v| = sum v
          "join_broadcast: sums past 2^-16 * sum|v|")
    res.update(auto_chose="broadcast", max_rel_err_total=float((err / exact).max()))
    log(f"join_broadcast: auto chose broadcast; counts exact, sums within 2^-16*sum|v| "
        f"(max rel err {res['max_rel_err_total']:.3g}); bucket kernel launches {launches}")
    del ctx, q, out, orders
    free_card()
    return res


# -- phases 11-13: iteration, decomposable aggregates, ordered operators --------

def kronecker_edges(seed: int, scale: int, edgefactor: int = 16, device: str = "cuda"):
    """The Graph500 Kronecker generator (graph500.org benchmark
    specification): ``edgefactor * 2^scale`` edges over ``2^scale``
    vertices, each edge's bits drawn with A=0.57, B=0.19, C=0.19
    (D=0.05), the vertex labels randomly permuted; then self loops
    removed (as samples/pagerank_dowhile.py does) and duplicate edges
    kept.  Drawn on ``device`` from a torch generator seeded with
    ``seed`` (at scale 21, 2^31 draws: numpy took 18.7 s of set-up),
    returned on the host."""
    n, m = 1 << scale, edgefactor << scale
    ab, c_norm, a_norm = PR_A + PR_B, PR_C / (1.0 - (PR_A + PR_B)), PR_A / (PR_A + PR_B)
    gen = torch.Generator(device=device).manual_seed(seed)
    src = torch.zeros(m, dtype=torch.int32, device=device)
    dst = torch.zeros(m, dtype=torch.int32, device=device)
    c_t, a_t = (torch.tensor(x, dtype=torch.float32, device=device) for x in (c_norm, a_norm))
    for bit in range(scale):
        ii = torch.rand(m, generator=gen, device=device) > ab
        jj = torch.rand(m, generator=gen, device=device) > torch.where(ii, c_t, a_t)
        src |= ii.to(torch.int32) << bit
        dst |= jj.to(torch.int32) << bit
    perm = torch.randperm(n, generator=gen, device=device).to(torch.int32)
    src, dst = perm[src.long()], perm[dst.long()]
    keep = src != dst
    return src[keep].cpu().numpy(), dst[keep].cpu().numpy()


# PageRank rows (module level: a do_while's subplans are built once per
# function object, and these rows are the same objects every round)
def _pr_contrib(c):
    return {"node": c["dst"], "c": c["w"] * c["rank"]}


def _pr_delta(c):
    return {"d": abs(c["rank"] - c["prev"])}


class _PrApply:
    def __init__(self, n):
        self.n = n

    def __call__(self, c):
        return {"node": c["node"], "rank": (1.0 - PR_DAMP) / self.n + PR_DAMP * c["inflow"],
                "prev": c["rank"]}


def pagerank_query(ctx, src, dst, w, n, max_iter=PR_ROUNDS, eps=0.0):
    """samples/pagerank_dowhile.py's query: the edges cached on the
    card, the state {node, rank, prev} over every vertex; each round
    joins ranks onto the edges, sums contributions per destination,
    left-joins them back and applies the damping; the condition keeps
    going while the largest change exceeds ``eps``.  Two cuts, both
    for memory: each join passes ``expansion=1.0`` (every edge matches
    one vertex, every vertex at most one sum), and the state is
    hash-partitioned on ``node`` once, a claim the body restates with
    ``assume_hash_partition``.  Without it every round after the first
    re-exchanges the already-partitioned state, whose buckets (sized for
    a uniform spread) overflow twice and rerun the round's joins at
    boost 4, as in the reference."""
    edges = ctx.from_arrays({"src": src, "dst": dst, "w": w}).cache()
    state = ctx.from_arrays({"node": np.arange(n, dtype=np.int32),
                             "rank": np.full(n, 1.0 / n, np.float32),
                             "prev": np.zeros(n, np.float32)}).hash_partition("node")
    apply_rank = _PrApply(n)

    def body(q):
        q = q.assume_hash_partition("node")
        contrib = (edges.join(q, "src", "node", expansion=1.0).select(_pr_contrib)
                   .group_by("node", {"inflow": ("sum", "c")}))
        return q.left_join(contrib, "node", expansion=1.0).select(apply_rank)

    def cond(q):
        return (q.select(_pr_delta).aggregate_as_query({"m": ("max", "d")})
                .select(lambda c: {"go": c["m"] > eps}))

    return state.do_while(body, cond, max_iter=max_iter)


def pagerank_oracle(src, dst, w, n, rounds):
    """float64 PageRank, the query's formula, ``rounds`` rounds."""
    r = np.full(n, 1.0 / n)
    w64 = w.astype(np.float64)
    for _ in range(rounds):
        r = (1.0 - PR_DAMP) / n + PR_DAMP * np.bincount(dst, weights=w64 * r[src], minlength=n)
    return r


def loop_rounds(ctx) -> int:
    return sum(1 for e in ctx.executor.events if e[0] == "do_while_iter")


def phase_pagerank(dev, card: str) -> dict:
    """PageRank by do_while on a Graph500 Kronecker graph, scale PR_SCALE,
    edgefactor 16 (2^22 vertices, 2^26 edges before self loops go):
    exactly 10 rounds (eps = 0), checked against a float64 oracle."""
    from dryad_tpu_torch import DryadConfig, DryadContext

    t0 = time.perf_counter()
    src, dst = kronecker_edges(SEED + 11, PR_SCALE)
    n = 1 << PR_SCALE
    deg = np.bincount(src, minlength=n).astype(np.float32)
    w = (1.0 / np.maximum(deg, 1.0))[src].astype(np.float32)
    gen_s = time.perf_counter() - t0
    log(f"pagerank graph: Kronecker scale {PR_SCALE}, {len(src)} edges after self loops "
        f"({(PR_EDGEFACTOR << PR_SCALE) - len(src)} removed), max out-degree {int(deg.max())}; "
        f"made in {gen_s:.1f} s (set-up)")
    ctx = DryadContext(num_partitions_=P, config=DryadConfig(device_cache_bytes=JOIN_CACHE_BYTES))
    t0 = time.perf_counter()
    q = pagerank_query(ctx, src, dst, w, n)
    cache_s = time.perf_counter() - t0
    res, out = timed_runs(ctx, q, "pagerank", card, len(src))
    rounds = loop_rounds(ctx)
    check(rounds == PR_ROUNDS, f"pagerank ran {rounds} rounds, expected {PR_ROUNDS}")
    check(any(e[0] == "do_while_max_iter" for e in ctx.executor.events),
          "pagerank: the loop did not stop at max_iter")
    check(res["bucket_sum_count_launches"] == 0, "pagerank reached the bucket kernel")
    dev_kinds = [e[0] for e in ctx.executor.events if e[0].startswith("do_while_device")]
    check(dev_kinds == ["do_while_device_fallback"],
          f"pagerank: device-loop events {dev_kinds}, expected one fallback (a multi-stage body)")
    boosts = [e[2] for e in ctx.executor.events if e[0] == "do_while_state_boost"]
    oracle = pagerank_oracle(src, dst, w, n, PR_ROUNDS)
    check(np.array_equal(np.sort(out["node"]), np.arange(n)), "pagerank: vertices differ")
    rank = np.empty(n, np.float64)
    rank[out["node"]] = out["rank"]
    err = np.abs(rank - oracle)
    tol = PR_REL * oracle.max()
    check(bool((err <= tol).all()), f"pagerank: a rank is past {PR_REL} * max(r) of the oracle")
    # the top 100 in the oracle's order, wherever the oracle's ranks are
    # not tied within twice this run's largest error
    top = np.argsort(-oracle, kind="stable")[:101]
    mine = np.argsort(-rank, kind="stable")[:100]
    gap = 2 * err.max()
    sep = np.abs(np.diff(oracle[top])) > gap
    for i in range(100):
        if sep[i] and (i == 0 or sep[i - 1]):
            check(mine[i] == top[i], f"pagerank: top-100 position {i} differs from the oracle")
    res.update(rounds=rounds, seconds_per_round=res["warm_s"] / rounds, edges=int(len(src)),
               vertices=n, max_abs_err_over_max_rank=float(err.max() / oracle.max()),
               state_boosts=boosts, graph_s=gen_s, cache_edges_s=cache_s)
    log(f"pagerank [{card}]: {rounds} rounds, {res['seconds_per_round']:.4f} s a round (warm); "
        f"ranks within {res['max_abs_err_over_max_rank']:.3g} * max(r) of the float64 oracle "
        f"(bound {PR_REL}); top-100 in the oracle's order where not tied; state boosts {boosts}")
    del ctx, q, out, src, dst, w
    free_card()
    return res


# -- phase: the on-device do_while (one CUDA graph a run) -----------------------

DL_ROWS = 1 << 26  # per-row Newton steps over 2^26 rows {id, a, x}: 768 MiB of state
DL_EPS = 2.0 ** -17  # the condition: max relative residual |x^3 - a| / a above this
DL_MAX_ITER = 100
DL_PAIRS = 10  # warm device-loop / driver-loop pairs, interleaved


def _dl_row(c):
    x = c["x"]
    return {"id": c["id"], "a": c["a"], "x": x - (x * x * x - c["a"]) / (3 * x * x)}


def _dl_res(c):
    x = c["x"]
    return {"r": abs(x * x * x - c["a"]) / c["a"]}


def _dl_go(c):
    return {"go": c["m"] > DL_EPS}


def _dl_body(q):
    return q.select(_dl_row)


def _dl_cond(q):
    return q.select(_dl_res).aggregate_as_query({"m": ("max", "r")}).select(_dl_go)


def _dl_host_row(c):
    s = float(c["x"].sum())  # a device value read on the host
    return {"id": c["id"], "a": c["a"], "x": c["x"] * 0.5 + s * 0.0}


def newton_oracle(a: np.ndarray, max_iter: int):
    """The loop's float32 steps in numpy, in the body's order of
    operations (each rounded once, as each PyTorch op rounds), and the
    condition's max residual read after every step: (x, rounds).  The
    rows are independent, so 8 threads step 8 slices (numpy's ufuncs
    let go of the GIL) and the round's max is the slices' max."""
    from concurrent.futures import ThreadPoolExecutor

    x = a.copy()
    three = np.float32(3)
    cut = np.linspace(0, len(a), 9).astype(np.int64)
    parts = [(x[lo:hi], a[lo:hi]) for lo, hi in zip(cut[:-1], cut[1:])]  # views of x

    def step(xa):
        xs, as_ = xa
        t = xs * xs
        t *= xs
        t -= as_
        u = three * xs
        u *= xs
        t /= u
        xs -= t  # x - (x*x*x - a) / (3*x*x), in place on this slice of x
        t = xs * xs
        t *= xs
        t -= as_
        np.abs(t, out=t)
        t /= as_
        return float(t.max())

    it = 0
    with ThreadPoolExecutor(8) as pool:
        while True:
            m = max(pool.map(step, parts))
            it += 1
            if not (it < max_iter and m > DL_EPS):
                return x, it


def profile_run(fn) -> dict:
    """``fn()`` and a synchronize under torch.profiler: the device's busy
    time (kernels, copies, fills; user ranges left out) over the wall,
    the device-to-host copies, and the top ops by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e6
    d2h = sum(e.count for e in avgs if "DtoH" in e.key or "Device -> Host" in e.key)
    ops = sorted(((e.key, getattr(e, "device_time_total", 0) / 1e3) for e in avgs
                  if getattr(e, "device_time_total", 0) > 0 and not e.key.startswith("ProfilerStep")),
                 key=lambda r: -r[1])
    return {"device_busy_s": busy, "wall_s": wall, "busy_share": busy / wall, "d2h": d2h,
            "top_ops_ms": ops[:10]}


def loopctl_report(dev) -> dict:
    """The loop-control kernel against its plain twin on the card, over
    every combination of its flags (byte-equal loop states: error 0),
    then both timed one launch at a time (the loop's shape: one step)."""
    from dryad_tpu_torch.ops import loopctl as LC

    err = 0
    before = LC.loop_step.launches
    for go, bovf, covf, old, i in itertools.product((0, 1), (False, True), (False, True), (0, 1), (0, 4, 9)):
        args = [torch.tensor(bovf, device=dev), torch.tensor(3, dtype=torch.int64, device=dev),
                torch.full((P, 1), go, dtype=torch.bool, device=dev), torch.tensor(covf, device=dev), 5]
        a = torch.tensor([i, old, 7, 1], dtype=torch.int64, device=dev)
        b = a.clone()
        LC.loop_step(a, *args)
        LC.loop_step_plain(b, *args)
        err = max(err, int((a - b).abs().max()))
    st = torch.zeros(4, dtype=torch.int64, device=dev)
    args = [torch.tensor(False, device=dev), torch.tensor(0, dtype=torch.int64, device=dev),
            torch.ones((P, 1), dtype=torch.bool, device=dev), torch.tensor(False, device=dev), 1 << 40]
    kernel_ms = cuda_time_ms(lambda: LC.loop_step(st, *args), iters=2000, warmup=10)
    plain_ms = cuda_time_ms(lambda: LC.loop_step_plain(st, *args), iters=2000, warmup=10)
    LC.loop_step.launches = before  # comparison launches are not the main path's
    # the work: 4 state words + 2 flags + 1 miss word + 1 go byte read,
    # 4 state words written; a dozen integer operations
    nbytes = 4 * 8 + 2 + 8 + 1 + 4 * 8
    bound_ms = max(nbytes / HBM_BYTES_PER_S, 12 / 67e12) * 1e3
    check(err == 0, f"loop-control kernel differs from its plain version by {err}")
    return {"max_abs_err": err, "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "bytes": nbytes}


def phase_devloop(dev, card: str) -> dict:
    """The on-device do_while at 2^26 rows: a per-row Newton iteration
    for cube roots (x <- x - (x^3 - a) / (3 x^2), x from a, a uniform in
    [1, 10^6) made from the seed) until the largest relative residual
    is at most 2^-17, about 27 rounds.  Its rows equal a numpy oracle
    that takes the same float32 steps, the same query under the driver
    loop (do_while_device_auto=False) and the loop program's plain
    version on the card, byte for byte; its rounds equal the driver
    loop's; its events are start then done.  Prints the capture's
    seconds and pool bytes, the warm medians of both loops over
    DL_PAIRS interleaved pairs, the device's busy share, and the
    device-to-host copies of one run of each loop, which for the device
    loop must not grow with the rounds.  A body that reads a device
    value on the host falls back to the driver loop."""
    from dryad_tpu_torch import DryadConfig, DryadContext
    from dryad_tpu_torch.ops import loopctl as LC

    rng = np.random.default_rng(SEED + 13)
    a = rng.uniform(1.0, 1e6, DL_ROWS).astype(np.float32)
    t = {"id": np.arange(DL_ROWS, dtype=np.int32), "a": a, "x": a.copy()}
    t0 = time.perf_counter()
    x_ref, rounds_ref = newton_oracle(a, DL_MAX_ITER)
    oracle_s = time.perf_counter() - t0
    dctx = DryadContext(num_partitions_=P)
    rctx = DryadContext(num_partitions_=P, config=DryadConfig(do_while_device_auto=False))
    src = dctx.from_arrays(t)
    qd = src.do_while(_dl_body, _dl_cond, max_iter=DL_MAX_ITER)
    qr = rctx.from_arrays(t).do_while(_dl_body, _dl_cond, max_iter=DL_MAX_ITER)

    def rows(out):
        o = np.argsort(out["id"])
        return out["x"][o]

    # the main path: the count of loop-control launches from 0
    LC.loop_step.launches = 0
    t0 = time.perf_counter()
    out = qd.collect()
    first_s = time.perf_counter() - t0
    launches = LC.loop_step.launches
    kinds = [(k, v) for k, _n, v in dctx.executor.events if k.startswith("do_while")]
    check([k for k, _ in kinds] == ["do_while_device_start", "do_while_device_done"],
          f"devloop: events {kinds}, expected start then done")
    iters = kinds[-1][1]
    (prog,) = dctx.executor._loops.values()
    check(prog.graph is not None, "devloop: the loop ran without its CUDA graph")
    check(launches == iters, f"devloop: {launches} loop-control launches for {iters} rounds")
    check(iters == rounds_ref, f"devloop: {iters} rounds, the oracle took {rounds_ref}")
    check(np.array_equal(rows(out).view(np.uint32), x_ref.view(np.uint32)),
          "devloop: rows differ from the numpy oracle")
    ref = qr.collect()
    drv_rounds = sum(1 for e in rctx.executor.events if e[0] == "do_while_iter")
    check(drv_rounds == iters, f"devloop: the driver loop ran {drv_rounds} rounds, the device loop {iters}")
    check(np.array_equal(rows(ref).view(np.uint32), x_ref.view(np.uint32)),
          "devloop: the driver loop's rows differ from the oracle")
    del out, ref
    # the graph against its plain version on the card, from the same input
    cur = dctx._bind_device(src.node)
    g = prog.run(cur)
    p = prog.run_plain(cur)
    check(g.iters == p.iters == iters and g.overflow == p.overflow is False,
          "devloop: graph and plain version ran different rounds")
    for c in g.batch.data:
        check(torch.equal(g.batch.data[c].view(torch.int32) if g.batch.data[c].dtype == torch.float32
                          else g.batch.data[c],
                          p.batch.data[c].view(torch.int32) if p.batch.data[c].dtype == torch.float32
                          else p.batch.data[c]), f"devloop: column {c} of the graph differs from the plain loop")
    check(torch.equal(g.batch.valid, p.batch.valid), "devloop: valid mask differs from the plain loop")
    del g, p
    # warm medians, interleaved
    dev_s, drv_s = [], []
    for _ in range(DL_PAIRS):
        for q, ctx, acc in ((qd, dctx, dev_s), (qr, rctx, drv_s)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b = ctx.execute(q)
            torch.cuda.synchronize()
            acc.append(time.perf_counter() - t0)
            del b
    dev_med, drv_med = float(np.median(dev_s)), float(np.median(drv_s))
    # one profiled run of each loop: the device's busy share, and the
    # device-to-host copies, which for the device loop do not grow with
    # the rounds (a second input that converges sooner replays the graph)
    pd = profile_run(lambda: dctx.execute(qd))
    fast = dctx.from_arrays({"id": t["id"], "a": a % np.float32(7.0) + np.float32(1.0),
                             "x": a % np.float32(7.0) + np.float32(1.0)})
    qf = fast.do_while(_dl_body, _dl_cond, max_iter=DL_MAX_ITER)
    dctx.execute(qf)  # ingest
    pf = profile_run(lambda: dctx.execute(qf))
    fast_iters = [v for k, _n, v in dctx.executor.events if k == "do_while_device_done"][-1]
    pr = profile_run(lambda: rctx.execute(qr))
    d2h_dev, d2h_fast, d2h_drv = pd["d2h"], pf["d2h"], pr["d2h"]
    check(len(dctx.executor._loops) == 1, "devloop: the second input did not replay the same graph")
    check(fast_iters < iters, f"devloop: the short input ran {fast_iters} rounds, not fewer than {iters}")
    check(d2h_fast == d2h_dev, f"devloop: {d2h_dev} device-to-host copies at {iters} rounds, "
          f"{d2h_fast} at {fast_iters}: they grow with the rounds")
    check(d2h_drv > d2h_dev, f"devloop: the driver loop made {d2h_drv} copies, the device loop {d2h_dev}")
    # a body that reads a device value on the host raises TypeError at
    # the loop's check (the sync check), naming the body's stage: the
    # driver loop's stage programs would refuse the same read in their
    # capture, as the reference's traced loops raise (ROADMAP section 3)
    small = {c: v[:4096] for c, v in t.items()}
    hctx = DryadContext(num_partitions_=P)
    try:
        hctx.from_arrays(small).do_while(lambda q: q.select(_dl_host_row, schema=q.schema),
                                         _dl_cond, max_iter=3).collect()
        raised = None
    except TypeError as e:
        raised = str(e)
    hk = [k for k, _n, _v in hctx.executor.events if k.startswith("do_while")]
    check(hk == ["do_while_device_start"],
          f"devloop: a host-reading body gave {hk}, expected the start and no driver loop")
    check(raised is not None and "select" in raised,
          f"devloop: a host-reading body gave {raised!r}, not a TypeError naming its stage")
    res = {
        "rows": DL_ROWS, "rounds": iters, "first_run_s": first_s, "capture_s": prog.capture_s,
        "pool_bytes": prog.pool_bytes, "device_loop_warm_median_s": dev_med,
        "driver_loop_warm_median_s": drv_med, "device_loop_warm_s": dev_s, "driver_loop_warm_s": drv_s,
        "speedup": drv_med / dev_med, "profile_device_loop": pd, "profile_driver_loop": pr,
        "d2h_device_loop": d2h_dev, "d2h_device_loop_short": d2h_fast, "short_rounds": fast_iters,
        "d2h_driver_loop": d2h_drv, "loopctl_launches": launches, "oracle_s": oracle_s,
        "loopctl": loopctl_report(dev), "card": card,
    }
    lc = res["loopctl"]
    log(f"devloop [{card}]: {DL_ROWS} rows, {iters} rounds; rows equal the numpy oracle, the driver "
        f"loop and the plain loop byte for byte; first run {first_s:.3f} s (ingest, lowering, check "
        f"and capture {prog.capture_s:.3f} s), graph pool {prog.pool_bytes / 2**20:.1f} MiB")
    log(f"devloop [{card}]: warm medians over {DL_PAIRS} interleaved pairs (execute + synchronize): "
        f"device loop {dev_med:.4f} s, driver loop {drv_med:.4f} s ({drv_med / dev_med:.2f}x); device "
        f"busy {pd['device_busy_s']:.4f} s of a profiled {pd['wall_s']:.4f} s device-loop run "
        f"({pd['busy_share']:.3f}), {pr['device_busy_s']:.4f} s of {pr['wall_s']:.4f} s for the driver "
        f"loop ({pr['busy_share']:.3f})")
    log(f"devloop [{card}]: device-to-host copies a run: device loop {d2h_dev} at {iters} rounds and "
        f"{d2h_fast} at {fast_iters}; driver loop {d2h_drv}; a host-reading body raised TypeError")
    log(f"devloop [{card}]: loop-control kernel launches {launches} (one a round), error 0 against "
        f"its plain twin; one launch {lc['kernel_ms'] * 1e3:.2f} us, plain {lc['plain_ms'] * 1e3:.2f} us, "
        f"bound {lc['bound_ms'] * 1e3:.5f} us ({lc['bytes']} bytes): launch-bound")
    for name, ms in pd["top_ops_ms"][:8]:
        log(f"  profile devloop [{card}] {ms:9.3f} ms  {name[:90]}")
    del dctx, rctx, hctx, src, qd, qr, qf, fast, cur, prog
    free_card()
    return res


def phase_groupby_sort_fused(dev, card: str) -> dict:
    """The groupby_sort phase's query (2^26 rows, 2^22 keys, GB_AGGS)
    with DRYAD_TPU_SORT_FUSED=1 (the fused sort path: one scan, one
    scatter), set and restored within the phase, beside the default
    path, in the order default, fused, fused, default (twice): integers
    byte-equal to the default's, floats within the numpy oracle's bound,
    the fused reruns byte-equal; both warm medians and the fused run's
    top ops."""
    from dryad_tpu_torch import DryadContext

    t, oracle = groupby_inputs()
    ctx = DryadContext(num_partitions_=P)
    q = ctx.from_arrays(t).group_by("key", GB_AGGS)
    prev = os.environ.get("DRYAD_TPU_SORT_FUSED")

    def run(fused: bool):
        if fused:
            os.environ["DRYAD_TPU_SORT_FUSED"] = "1"
        else:
            os.environ.pop("DRYAD_TPU_SORT_FUSED", None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = q.collect()
        return out, time.perf_counter() - t0

    times = {False: [], True: []}
    digests = {False: set(), True: set()}
    outs = {}
    try:
        run(False), run(True)  # warm both
        for fused in (False, True, True, False) * 2:
            out, s = run(fused)
            times[fused].append(s)
            digests[fused].add(digest(out))
            outs[fused] = out
        os.environ["DRYAD_TPU_SORT_FUSED"] = "1"
        prof = profile_query(q, os.path.join(WORK_DIR, "profile_groupby_sort_fused.txt"))
    finally:
        if prev is None:
            os.environ.pop("DRYAD_TPU_SORT_FUSED", None)
        else:
            os.environ["DRYAD_TPU_SORT_FUSED"] = prev
    check(overflow_retries(ctx) == 0, "groupby_sort_fused retried an overflow")
    check(len(digests[True]) == 1 and len(digests[False]) == 1, "groupby_sort_fused: reruns differ")
    f, d = ({c: a[np.argsort(o["key"])] for c, a in o.items()} for o in (outs[True], outs[False]))
    for c in ("key", "c", "mnw", "mxw", "sL"):
        check(f[c].dtype == d[c].dtype and np.array_equal(f[c], d[c]),
              f"groupby_sort_fused: {c} differs from the default path")
    err = check_groupby(outs[True], oracle, "groupby_sort_fused")
    fused_med, base_med = float(np.median(times[True])), float(np.median(times[False]))
    res = {"rows": GB_ROWS, "keys": GB_KEYS, "fused_warm_median_s": fused_med,
           "default_warm_median_s": base_med, "fused_s": times[True], "default_s": times[False],
           "max_rel_err_sum": err, "profile": prof, "card": card}
    log(f"groupby_sort_fused [{card}]: {GB_ROWS} rows, {len(oracle['uniq'])} groups; integers equal the "
        f"default path byte for byte, f32 sums within n_g*2^-23*sum|v| (max |err|/sum|v| {err:.3g}), "
        f"reruns byte-equal; warm medians fused {fused_med:.4f} s, default {base_med:.4f} s")
    print_profile("groupby_sort_fused", card, prof, fused_med)
    del ctx, q, outs, f, d
    _GB_INPUTS.clear()
    free_card()
    return res


def variance_dec(state_key: str = "adRevenue"):
    """(count, sum, sum of squares) with the variance as finalize; the
    finalize keeps every column, states included."""
    from dryad_tpu_torch import ColumnType, Decomposable

    def finalize(c):
        m = c["s1"] / c["cnt"]
        return {**c, "var": c["s2"] / c["cnt"] - m * m}

    return Decomposable(
        seed=lambda c: {"cnt": torch.ones_like(c[state_key]), "s1": c[state_key],
                        "s2": c[state_key] * c[state_key]},
        merge=lambda a, b: {k: a[k] + b[k] for k in ("cnt", "s1", "s2")},
        state_cols=["cnt", "s1", "s2"], finalize=finalize,
        out_fields=[(n, ColumnType.FLOAT32) for n in ("cnt", "s1", "s2", "var")])


def best_visit_dec(rev: str = "adRevenue", day: str = "visitDate"):
    """A non-linear merge: the highest revenue with its date, ties to
    the later date."""
    from dryad_tpu_torch import ColumnType, Decomposable

    def merge(a, b):
        take_b = (b["rev"] > a["rev"]) | ((b["rev"] == a["rev"]) & (b["day"] > a["day"]))
        return {"rev": torch.where(take_b, b["rev"], a["rev"]),
                "day": torch.where(take_b, b["day"], a["day"])}

    return Decomposable(seed=lambda c: {"rev": c[rev], "day": c[day]}, merge=merge,
                        state_cols=["rev", "day"],
                        out_fields=[("rev", ColumnType.FLOAT32), ("day", ColumnType.INT32)])


def _with_rev2(c):
    return {**c, "rev2": c["adRevenue"] * c["adRevenue"]}


def phase_decomposable(dev, card: str) -> dict:
    """The Join Task's UserVisits: the variance of adRevenue per
    sourceIP through a Decomposable (seed, local combine, shuffle, final
    combine), the same sums through the built-in aggregates in the same
    call, a non-linear argmax merge, and the whole-table
    aggregate_decomposable; every one against numpy."""
    from dryad_tpu_torch import DryadConfig, DryadContext
    from dryad_tpu_torch.ops.bucket import bucket_sum_count

    rng = np.random.default_rng(SEED + 8)
    visits, _ = visits_tables(rng)
    visits = {c: visits[c] for c in ("sourceIP", "adRevenue", "visitDate")}
    ctx = DryadContext(num_partitions_=P, config=DryadConfig(device_cache_bytes=JOIN_CACHE_BYTES))
    src = ctx.from_arrays(visits)
    res, out = timed_runs(ctx, src.group_by("sourceIP", decomposable=variance_dec()),
                          "decomposable", card, JS_VISITS)
    builtin, bout = timed_runs(
        ctx, src.select(_with_rev2).group_by(
            "sourceIP", {"cnt": ("count", None), "s1": ("sum", "adRevenue"), "s2": ("sum", "rev2")}),
        "decomposable_builtin", card, JS_VISITS)

    ip, rev = visits["sourceIP"], visits["adRevenue"].astype(np.float64)
    uk, inv = np.unique(ip, return_inverse=True)
    cnt = np.bincount(inv)
    s1, s2 = np.bincount(inv, weights=rev), np.bincount(inv, weights=rev * rev)
    o = np.argsort(out["sourceIP"])
    got = {c: a[o] for c, a in out.items()}
    check(np.array_equal(got["sourceIP"], uk), "decomposable: sourceIPs differ from the oracle's")
    check(np.array_equal(got["cnt"], cnt.astype(np.float32)), "decomposable: counts differ")
    # adRevenue >= 0: sum |v| = s1; each square rounds once more
    check(bool((np.abs(got["s1"] - s1) <= cnt * F32_REL * s1).all()),
          "decomposable: sums past n_g * 2^-23 * sum|v|")
    check(bool((np.abs(got["s2"] - s2) <= (cnt + 1) * F32_REL * s2).all()),
          "decomposable: sums of squares past (n_g + 1) * 2^-23 * sum v^2")
    m = got["s1"].astype(np.float64) / got["cnt"]
    fin = got["s2"] / got["cnt"].astype(np.float64) - m * m
    check(bool((np.abs(got["var"] - fin) <= 2.0 ** -22 * (got["s2"] / got["cnt"] + m * m)).all()),
          "decomposable: the variance is not its states' within rounding")
    ob = np.argsort(bout["sourceIP"])
    check(np.array_equal(bout["sourceIP"][ob], uk)
          and np.array_equal(bout["cnt"][ob], cnt.astype(np.int32)),
          "decomposable_builtin: keys or counts differ from the oracle's")
    check(bool((np.abs(bout["s1"][ob] - s1) <= cnt * F32_REL * s1).all()),
          "decomposable_builtin: sums past the bound")

    bucket_sum_count.launches = 0  # timed_runs counted its own queries
    best_q = src.group_by("sourceIP", decomposable=best_visit_dec())
    best_q.collect()
    t0 = time.perf_counter()
    best = best_q.collect()
    res["argmax_warm_s"] = time.perf_counter() - t0
    # the oracle: each sourceIP's highest revenue, then the latest date
    # among its rows at that revenue (two unbuffered maxima, not a sort)
    top_rev = np.full(len(uk), -np.inf, np.float32)
    np.maximum.at(top_rev, inv, visits["adRevenue"])
    at_top = visits["adRevenue"] == top_rev[inv]
    top_day = np.full(len(uk), np.iinfo(np.int32).min, np.int32)
    np.maximum.at(top_day, inv[at_top], visits["visitDate"][at_top])
    ob = np.argsort(best["sourceIP"])
    check(np.array_equal(best["sourceIP"][ob], uk)
          and np.array_equal(best["rev"][ob], top_rev)
          and np.array_equal(best["day"][ob], top_day),
          "decomposable argmax: not the oracle's highest revenue and latest date")
    check(overflow_retries(ctx) == 0, "decomposable argmax retried an overflow")

    whole_dec = variance_dec()
    src.aggregate_decomposable(whole_dec)
    t0 = time.perf_counter()
    whole = src.aggregate_decomposable(whole_dec)
    res["aggregate_warm_s"] = time.perf_counter() - t0
    n = float(JS_VISITS)
    check(whole["cnt"] == n, f"aggregate_decomposable: count {whole['cnt']} != {JS_VISITS}")
    check(abs(whole["s1"] - s1.sum()) <= n * F32_REL * s1.sum()
          and abs(whole["s2"] - s2.sum()) <= (n + 1) * F32_REL * s2.sum(),
          "aggregate_decomposable: sums past the bound")
    res.update(builtin=builtin, groups=int(len(uk)),
               max_rel_err_s1=float((np.abs(got["s1"] - s1) / s1).max()),
               whole_rel_err_s1=float(abs(whole["s1"] - s1.sum()) / s1.sum()))
    log(f"decomposable [{card}]: {len(uk)} groups; counts exact, sums within n_g*2^-23*sum|v| "
        f"(max rel err {res['max_rel_err_s1']:.3g}); warm {res['warm_s']:.4f} s against the "
        f"built-in aggregates' {builtin['warm_s']:.4f} s; argmax merge exact, warm "
        f"{res['argmax_warm_s']:.4f} s; aggregate_decomposable warm {res['aggregate_warm_s']:.4f} s "
        f"(rel err {res['whole_rel_err_s1']:.3g})")
    res["bucket_sum_count_launches"] += (builtin["bucket_sum_count_launches"]
                                         + bucket_sum_count.launches)
    check(res["bucket_sum_count_launches"] == 0, "decomposable reached the bucket kernel")
    del ctx, src, out, bout, best, visits
    free_card()
    return res


def _pid(b, i):
    return b.with_column("pid", b["ts"] * 0 + i)


def _dup_neg(cols):
    ts, v = cols["ts"], cols["v"]
    return ({"ts": torch.stack([ts, ts], 1), "v": torch.stack([v, -v], 1)},
            torch.stack([torch.ones_like(v, dtype=torch.bool), v > 0], 1))


def _split_sign(b):
    return b.filter(b["v"] > 0), b.filter(~(b["v"] > 0))


def phase_ordered_ops(dev, card: str) -> dict:
    """An event log of 2^26 rows in timestamp order (int32, strictly
    increasing) and a second 2^26-row table: sliding_window, reverse,
    take_while/skip_while, zip_, select_many, default_if_empty, apply
    with the partition index and a two-way fork, each equal to numpy
    with no overflow retry."""
    from dryad_tpu_torch import ColumnType, DryadConfig, DryadContext, Schema
    from dryad_tpu_torch.ops.bucket import bucket_sum_count

    rng = np.random.default_rng(SEED + 12)
    n = ORD_ROWS
    ts = (np.cumsum(rng.integers(1, 32, n)) - 2**30).astype(np.int32)
    v = rng.standard_normal(n).astype(np.float32)
    u = rng.integers(-2**31, 2**31, n, dtype=np.int32)
    # a rank exchange moves each partition's contiguous run of ranks to
    # one or two partitions, so a bucket must hold a whole partition
    ctx = DryadContext(num_partitions_=P, config=DryadConfig(
        shuffle_slack=float(P), device_cache_bytes=JOIN_CACHE_BYTES))
    log_q = ctx.from_arrays({"ts": ts, "v": v}).assume_order_by([("ts", False)])
    other = ctx.from_arrays({"u": u})
    cut = int(ts[n // 3])
    sch = Schema([("ts", ColumnType.INT32), ("v", ColumnType.FLOAT32)])
    pos_q, neg_q = log_q.fork(_split_sign, [sch, sch])
    keep = np.stack([np.ones(n, bool), v > 0], 1).ravel()
    expect = {
        "sliding_window": (log_q.sliding_window(3, ["v"]),
                           {"v_w0": v[:-2], "v_w1": v[1:-1], "v_w2": v[2:]}),
        "reverse": (log_q.reverse(), {"ts": ts[::-1], "v": v[::-1]}),
        "take_while": (log_q.take_while(lambda c: c["ts"] < cut),
                       {"ts": ts[: n // 3], "v": v[: n // 3]}),
        "skip_while": (log_q.skip_while(lambda c: c["ts"] < cut),
                       {"ts": ts[n // 3:], "v": v[n // 3:]}),
        "zip": (log_q.zip_(other), {"ts": ts, "v": v, "u": u}),
        "select_many": (log_q.select_many(_dup_neg, 2),
                        {"ts": np.repeat(ts, 2)[keep], "v": np.stack([v, -v], 1).ravel()[keep]}),
        "default_if_empty": (log_q.where(lambda c: c["ts"] < -2**31 + 1).default_if_empty(
            {"ts": -1, "v": 0.5}), {"ts": np.array([-1], np.int32), "v": np.array([0.5], np.float32)}),
        "apply_with_index": (log_q.apply(_pid, schema=sch.with_field("pid", ColumnType.INT32),
                                         with_index=True), None),
        "fork_positive": (pos_q, {"ts": ts[v > 0], "v": v[v > 0]}),
        "fork_rest": (neg_q, {"ts": ts[~(v > 0)], "v": v[~(v > 0)]}),
    }
    res = {"rows": n, "card": card}
    bucket_sum_count.launches = 0
    for name, (q, want) in expect.items():
        t0 = time.perf_counter()
        got = q.collect()
        first = time.perf_counter() - t0
        check(overflow_retries(ctx) == 0, f"ordered_ops {name}: retried an overflow")
        del got
        t0 = time.perf_counter()
        got = q.collect()
        secs = time.perf_counter() - t0
        check(overflow_retries(ctx) == 0, f"ordered_ops {name}: retried an overflow")
        if want is None:  # apply: the log unchanged, each row tagged with its partition
            pid = got["pid"]
            check(np.array_equal(got["ts"], ts) and np.array_equal(got["v"], v),
                  "ordered_ops apply_with_index: rows differ")
            check(bool((np.diff(pid) >= 0).all()) and np.array_equal(
                np.bincount(pid, minlength=P), np.full(P, n // P)),
                "ordered_ops apply_with_index: partition indexes differ from the layout's")
        else:
            check(list(got) == list(want), f"ordered_ops {name}: columns {list(got)}")
            for c, a in want.items():
                a = np.ascontiguousarray(a)
                check(got[c].dtype == a.dtype and np.array_equal(got[c].view(np.uint8), a.view(np.uint8)),
                      f"ordered_ops {name}: column {c} differs from numpy's")
        rows = len(next(iter(got.values())))
        res[name] = {"first_s": first, "warm_s": secs, "rows_out": rows}
        log(f"ordered_ops {name} [{card}]: {rows} rows out, equal to numpy, 0 retries; "
            f"first {first:.4f} s, warm {secs:.4f} s")
        del got
    res["bucket_sum_count_launches"] = bucket_sum_count.launches
    check(bucket_sum_count.launches == 0, "ordered_ops reached the bucket kernel")
    res["profile"] = profile_query(expect["reverse"][0], os.path.join(WORK_DIR, "profile_ordered_ops.txt"))
    print_profile("ordered_ops reverse", card, res["profile"], res["reverse"]["warm_s"])
    del ctx, log_q, other, expect
    free_card()
    return res


def parity_table(rng, n: int) -> dict:
    return {
        "k": rng.integers(-2**31, 2**31, n, dtype=np.int32),
        "g": rng.integers(-60, 60, n).astype(np.int32),
        "b": rng.random(n) < 0.5,
        "s": np.array([f"w{i}" for i in rng.integers(0, 90, n)], object),
        "v": (rng.standard_normal(n) * 10.0 ** rng.integers(-2, 3, n)).astype(np.float32),
        "w": rng.integers(-1000, 1000, n).astype(np.int32),
        "L": rng.integers(-2**40, 2**40, n, dtype=np.int64),
        "id": np.arange(n, dtype=np.int32),
    }


PARITY_AGGS = {"c": ("count", None), "sv": ("sum", "v"), "mv": ("mean", "v"),
               "mnw": ("min", "w"), "sL": ("sum", "L"), "mL": ("mean", "L"),
               "fw": ("first", "w"), "ab": ("any", "b")}
PARITY_QUERIES = {  # the queries of tests/test_torch_terasort.py
    "terasort_asc": (lambda q: q.order_by([("k", False)]), None),
    "terasort_desc": (lambda q: q.order_by([("k", True)]), None),
    "terasort_multikey": (lambda q: q.order_by([("g", False), ("v", True), ("id", False)]), None),
    "group_by_negative": (lambda q: q.group_by("g", PARITY_AGGS), ["g"]),
    "group_by_unbounded": (lambda q: q.group_by("k", {"c": ("count", None), "sv": ("sum", "v")}), ["k"]),
    "group_by_two_keys": (lambda q: q.group_by(["g", "b"], PARITY_AGGS), ["g", "b"]),
    "group_by_string": (lambda q: q.group_by("s", PARITY_AGGS), ["s"]),
    "group_by_salt": (lambda q: q.group_by("g", PARITY_AGGS, salt=3), ["g"]),
    "range_partition_order_by": (
        lambda q: q.range_partition(["g"]).order_by([("g", False), ("id", False)]), None),
    "group_by_order_by": (
        lambda q: q.group_by("g", PARITY_AGGS).order_by([("c", True), ("g", False)]), ["g"]),
    "distinct": (lambda q: q.distinct(["g", "b"]), None),
    "hash_partition": (lambda q: q.hash_partition(["g"]), None),
}


def parity_join_tables(rng, n: int, hot: bool) -> tuple:
    k = rng.integers(0, 1000, n).astype(np.int32)
    if hot:
        k = np.where(rng.random(n) < 0.9, 77, k).astype(np.int32)
    left = {"k": k, "lv": np.arange(n, dtype=np.int32),
            "x": rng.standard_normal(n).astype(np.float32)}
    m = n // 4
    right = {"k": rng.integers(0, 1200, m).astype(np.int32),
             "rv": rng.standard_normal(m).astype(np.float32),
             "w": rng.integers(-1000, 1000, m).astype(np.int32),
             "L": rng.integers(-2**40, 2**40, m, dtype=np.int64)}
    return left, right


PARITY_JOIN_QUERIES = {  # the queries of tests/test_torch_join.py
    "inner": lambda a, b, s: a.join(b, "k", strategy=s),
    "left": lambda a, b, s: a.left_join(b, "k", right_defaults={"rv": -1.0}, strategy=s),
    "semi": lambda a, b, s: a.semi_join(b, "k", strategy=s),
    "anti": lambda a, b, s: a.anti_join(b, "k", strategy=s),
    "count": lambda a, b, s: a.group_join_count(b, "k", strategy=s),
    "group_join_aggs": lambda a, b, s: a.group_join(
        b, "k", aggs={"n": ("count", None), "sw": ("sum", "w"), "srv": ("sum", "rv"),
                      "mL": ("max", "L")}, strategy=s),
    "group_join_selector": lambda a, b, s: a.group_join(
        b, "k", order=[("rv", True)], rank_limit=2, strategy=s,
        selector=lambda p: p.group_by("gj_lid", {"m": ("count", None), "top": ("max", "rv"),
                                                 "sw": ("sum", "w")}),
        defaults={"m": 0}),
}
PARITY_SCALAR_QUERIES = {  # the queries of tests/test_torch_scalar.py
    "scalar_aggregates": lambda q: q.aggregate_as_query({
        "n": ("count", None), "sv": ("sum", "v"), "mv": ("mean", "v"), "sw": ("sum", "w"),
        "mnw": ("min", "w"), "mxv": ("max", "v"), "sL": ("sum", "L"), "mnL": ("min", "L"),
        "mL": ("mean", "L"), "ab": ("any", "b"), "allb": ("all", "b")}),
    "scalar_empty": lambda q: q.where(lambda c: c["id"] < 0).aggregate_as_query({
        "n": ("count", None), "sv": ("sum", "v"), "mnw": ("min", "w"), "mxL": ("max", "L")}),
    "with_rank": lambda q: q.with_rank("r"),
    "take": lambda q: q.take(37),
    "skip": lambda q: q.skip(PARITY_ROWS - 50),
    "tail": lambda q: q.tail(25),
    "order_by_take": lambda q: q.order_by([("v", True)]).take(2000),
}


def _parity_pagerank(ctx, t):
    src, dst = kronecker_edges(SEED + 13, PR_PARITY_SCALE)
    n = 1 << PR_PARITY_SCALE
    deg = np.bincount(src, minlength=n).astype(np.float32)
    w = (1.0 / np.maximum(deg, 1.0))[src].astype(np.float32)
    return [pagerank_query(ctx, src, dst, w, n).collect()]


def _parity_host(cols, i):
    keep = cols["w"] > np.median(cols["w"]) if len(cols["w"]) else cols["w"] > 0
    return {"w": cols["w"][keep], "pid": np.full(int(keep.sum()), i, np.int32)}


def _parity_fork(ctx, t):
    q = ctx.from_arrays(t)
    a, b = q.fork(lambda bt: (bt.filter(bt["b"]), bt.filter(bt["w"] > 0)), [q.schema, q.schema])
    return [a.collect(), b.collect()]


def _parity_cache(ctx, t):
    cached = ctx.from_arrays(t).group_by("g", {"n": ("count", None), "sw": ("sum", "w")}).cache()
    out = [cached.where(lambda c: c["n"] > 30).collect(), cached.group_by("g", {"m": ("max", "sw")}).collect()]
    ctx.release(cached)
    return out


def _parity_do_while(ctx, t):
    q = ctx.from_arrays({"x": t["w"]})
    return [q.do_while(lambda s: s.select(lambda c: {"x": c["x"] // 2}).distinct(),
                       lambda s: s.count_as_query().select(lambda c: {"go": c["count"] > 5}),
                       max_iter=30).collect()]


PARITY_OPERATOR_QUERIES = {  # the queries of tests/test_torch_{operators,decomposable,dowhile}.py
    "take_while": lambda c, t: [c.from_arrays(t).take_while(lambda x: x["id"] < 5000).collect()],
    "skip_while": lambda c, t: [c.from_arrays(t).skip_while(lambda x: x["w"] < 900).collect()],
    "reverse": lambda c, t: [c.from_arrays(t).reverse().collect()],
    "reverse_hash_partitioned": lambda c, t: [c.from_arrays(t).hash_partition(["g"]).reverse().collect()],
    "default_if_empty": lambda c, t: [c.from_arrays(t).where(lambda x: x["id"] < 0).default_if_empty(
        {"g": 3, "s": "none", "L": -5}).collect()],
    "zip": lambda c, t: [c.from_arrays(t).zip_(c.from_arrays(t).where(lambda x: x["b"])).collect()],
    "sequence_equal": lambda c, t: [{"eq": np.array([c.from_arrays(t).sequence_equal(
        c.from_arrays(t).where(lambda x: x["id"] >= 0))])}],
    "sliding_window": lambda c, t: [c.from_arrays(t).where(lambda x: x["g"] > 40).sliding_window(
        3, ["v", "w"]).collect()],
    "select_many": lambda c, t: [c.from_arrays(t).select_many(_dup_neg_w, 2).collect()],
    "apply_with_index": lambda c, t: [c.from_arrays(t).apply(
        lambda b, i: b.with_column("w", b["w"] * 0 + i).filter(b["b"]), cap_factor=2.0,
        with_index=True).group_by("w", {"n": ("count", None)}).collect()],
    "fork": _parity_fork,
    "apply_host": lambda c, t: [c.from_arrays(t).apply_host(_parity_host, schema=_host_schema()).collect()],
    "decomposable_variance": lambda c, t: [c.from_arrays(t).group_by(
        "g", decomposable=variance_dec("v")).collect()],
    "decomposable_argmax": lambda c, t: [c.from_arrays(t).group_by(
        "g", decomposable=best_visit_dec("v", "w")).collect()],
    "aggregate_decomposable": lambda c, t: [{k: np.atleast_1d(x) for k, x in c.from_arrays(
        t).aggregate_decomposable(variance_dec("v")).items()}],
    "do_while": _parity_do_while,
    "cache": _parity_cache,
    "pagerank_scale10": _parity_pagerank,
}


def _dup_neg_w(cols):
    w = cols["w"]
    return {"w": torch.stack([w, -w], 1)}, torch.stack([w > 0, w < 0], 1)


def _host_schema():
    from dryad_tpu_torch import ColumnType, Schema

    return Schema([("w", ColumnType.INT32), ("pid", ColumnType.INT32)])


def _byte_equal(a: dict, b: dict, what: str) -> None:
    check(list(a) == list(b), f"{what}: columns differ")
    for c in a:
        check(a[c].dtype == b[c].dtype and len(a[c]) == len(b[c]),
              f"{what}: column {c} differs in type or length")
        if a[c].dtype == object:
            check(a[c].tolist() == b[c].tolist(), f"{what}: {c} differs")
        else:
            check(np.array_equal(a[c].view(np.uint8), b[c].view(np.uint8)), f"{what}: {c} differs")


def phase_cpu_parity(dev, card: str) -> dict:
    """The parity tests' queries at 2^14 rows, full width and behind a
    1000-row top-k (fan-reduced), on the CPU and on the card: every
    column byte-equal in row order but f32 sums and means, which must be
    within n_g * 2^-23 * sum |v| of each other (a check of the int64
    word arithmetic of hashing and splitters on the card)."""
    from dryad_tpu_torch import DryadConfig, DryadContext

    t = parity_table(np.random.default_rng(SEED + 7), PARITY_ROWS)
    ctxs = [DryadContext(num_partitions_=P, config=DryadConfig(auto_dense_strings=False),
                         device=d) for d in ("cpu", dev)]
    res = {}
    for reduced in (False, True):
        src_t = {c: a[:1000] for c, a in t.items()} if reduced else t
        for name, (build, keys) in PARITY_QUERIES.items():
            outs = []
            for ctx in ctxs:
                q = ctx.from_arrays(t)
                if reduced:
                    q = q.order_by([("id", False)]).take(1000)
                outs.append(build(q).collect())
            a, b = outs
            check(list(a) == list(b), f"cpu_parity {name}: columns differ")
            exact = True
            for c in a:
                check(a[c].dtype == b[c].dtype and len(a[c]) == len(b[c]),
                      f"cpu_parity {name}: column {c} differs in type or length")
                if a[c].dtype == np.float32 and c in ("sv", "mv"):
                    same = np.array_equal(a[c].view(np.uint8), b[c].view(np.uint8))
                    exact = exact and same
                    if not same:
                        grp = {}
                        for kk, v in zip(zip(*[src_t[k].tolist() for k in keys]),
                                         np.abs(src_t["v"].astype(np.float64))):
                            n, s_ = grp.get(kk, (0, 0.0))
                            grp[kk] = (n + 1, s_ + v)
                        ng = np.array([grp[kk] for kk in zip(*[a[k].tolist() for k in keys])])
                        bound = ng[:, 0] * F32_REL * ng[:, 1] / (ng[:, 0] if c == "mv" else 1)
                        check(bool((np.abs(a[c].astype(np.float64) - b[c]) <= bound).all()),
                              f"cpu_parity {name}: {c} past the f32 bound")
                elif a[c].dtype == object:
                    check(a[c].tolist() == b[c].tolist(), f"cpu_parity {name}: {c} differs")
                else:
                    check(np.array_equal(a[c].view(np.uint8), b[c].view(np.uint8)),
                          f"cpu_parity {name}: {c} differs")
            tag = f"{name}{' (fan-reduced)' if reduced else ''}"
            res[tag] = "byte-equal" if exact else "f32 within bound"
            log(f"cpu_parity {tag}: {len(next(iter(a.values())))} rows, {res[tag]}")
    # joins under each placement, uniform and 90% hot keys; the scalar
    # and rank queries: every column byte-equal, float sums included
    # (their integer accumulation gives the same bytes on both devices)
    for hot in (False, True):
        left, right = parity_join_tables(np.random.default_rng(SEED + 10), PARITY_ROWS, hot)
        for name, build in PARITY_JOIN_QUERIES.items():
            for strategy in ("shuffle", "broadcast", "auto"):
                outs, events = [], []
                for ctx in ctxs:
                    outs.append(build(ctx.from_arrays(left), ctx.from_arrays(right),
                                      strategy).collect())
                    events.append(list(ctx.executor.events))
                tag = f"{name} {strategy}{' (90% hot key)' if hot else ''}"
                _byte_equal(outs[0], outs[1], f"cpu_parity {tag}")
                check(events[0] == events[1], f"cpu_parity {tag}: retries differ {events}")
                res[tag] = "byte-equal"
                log(f"cpu_parity {tag}: {len(next(iter(outs[0].values())))} rows, byte-equal, "
                    f"retries {len(events[0])}")
    for name, build in PARITY_SCALAR_QUERIES.items():
        a, b = (build(ctx.from_arrays(t)).collect() for ctx in ctxs)
        _byte_equal(a, b, f"cpu_parity {name}")
        res[name] = "byte-equal"
        log(f"cpu_parity {name}: {len(next(iter(a.values())))} rows, byte-equal")
    # the ordered, user-function, decomposable and iteration queries,
    # PageRank at scale 10: every table byte-equal, retries and rounds too
    for name, build in PARITY_OPERATOR_QUERIES.items():
        outs, events = [], []
        for ctx in ctxs:
            outs.append(build(ctx, t))
            events.append(list(ctx.executor.events))
        for i, (a, b) in enumerate(zip(*outs)):
            _byte_equal(a, b, f"cpu_parity {name} [{i}]")
        check(events[0] == events[1], f"cpu_parity {name}: events differ {events}")
        res[name] = "byte-equal"
        rounds = sum(1 for e in events[0] if e[0] == "do_while_iter")
        log(f"cpu_parity {name}: {[len(next(iter(a.values()))) for a in outs[0]]} rows, "
            f"byte-equal, events {len(events[0])} ({rounds} loop rounds)")
    return res


# -- phase 14: stores, submit, the event log and the samples ------------------

ST_ROWS = 1 << 26  # TeraSort through stores: 512 MiB of int32 keys and f32 payloads (2^28 to PR 5, 2^27 to PR 9)
ST_ZLIB_ROWS = 1 << 24  # the compressed store (zlib's host time; cut from 2^26, then 2^25; PERF.md section 4)
ST_WC_FILES = 8
ST_WC_WORDS = 1 << 23  # the stores' WordCount corpus (cut from 2^26, 2^25, then 2^24; PERF.md section 4)
# Disk peaks while the sorted TeraSort store is written beside its input
# (2 x 1 GiB); both go once checked.  The later files (the 0.47 GiB zlib
# store, the 0.5 GiB corpus, its 8 pieces of 0.5 GiB in all, the 1 GiB
# words store) hold about 2.5 GiB.  One GiB more for the event logs.
ST_FREE_BYTES = 5 << 30
SAMPLE_EXPECT = {  # the strings tests/test_samples.py checks, and top_words' panel
    "wordcount": "the", "terasort": "sorted 100000 rows", "join_groupby": "region 0:",
    "pagerank_dowhile": "top node matches numpy PageRank: OK",
    "topk_per_key_hdfs": "ranked reviews considered: 100", "top_words": "== fusion ==",
}


def _gbps(nbytes: float, secs: float) -> float:
    return nbytes / secs / 1e9 if secs > 0 else float("inf")


def _read_back(path: str) -> dict:
    """A store's rows in partition order, by the port's read_store."""
    from dryad_tpu_torch.columnar.io import read_store

    _schema, parts, _ = read_store(path)
    return {c: np.concatenate([p[c] for p in parts]) for c in parts[0]}


def phase_stores(dev, card: str) -> dict:
    """TeraSort through stores (ST_ROWS rows), a zlib store (ST_ZLIB_ROWS rows),
    WordCount through 8 text files and a STRING store, ``submit``, the
    event log, and the six ported samples on the card.  Every context of
    the phase logs its events to a JSONL file."""
    import contextlib
    import importlib
    import io
    import shutil
    import threading

    from dryad_tpu_torch import DryadConfig, DryadContext
    from dryad_tpu_torch.exec.events import EVENT_KINDS, EventLog
    from dryad_tpu_torch.ops.bucket import bucket_sum_count

    t_phase = time.perf_counter()
    root = os.path.join(WORK_DIR, "stores")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    free = shutil.disk_usage(root).free
    if free < ST_FREE_BYTES:
        raise RuntimeError(f"stores phase needs {ST_FREE_BYTES / 1e9:.1f} GB free under {root}; "
                           f"{free / 1e9:.1f} GB free")
    evdir = os.path.join(root, "events")
    contexts = []

    def context(**cfg):
        ctx = DryadContext(num_partitions_=P, config=DryadConfig(event_log_dir=evdir, **cfg))
        contexts.append(ctx.events.path)
        time.sleep(0.002)  # one log file per context: names carry milliseconds
        return ctx

    torch.cuda.reset_peak_memory_stats()
    res = {"card": card}
    try:
        # -- TeraSort through stores ------------------------------------------
        rng = np.random.default_rng(SEED + 14)
        key = rng.integers(-2**31, 2**31, ST_ROWS, dtype=np.int32)
        pay = rng.random(ST_ROWS, dtype=np.float32)
        oracle = {}
        sorter = threading.Thread(target=lambda: oracle.update(v=terasort_oracle(key, pay)))
        sorter.start()  # the numpy oracle sorts while the card works
        in_path, out_path = os.path.join(root, "ts_in"), os.path.join(root, "ts_out")
        ctx = context()
        ctx.from_arrays({"key": key, "payload": pay}).to_store(in_path)
        check(ctx.io_native is True, "to_store did not use the native I/O routines")
        w = dict(ctx.io_stats)
        del ctx
        free_card()
        ctx = context()
        q = ctx.from_store(in_path).order_by([("key", False)])
        check(ctx.io_native is True, "from_store did not use the native I/O routines")
        h = q.to_store(out_path)
        r = dict(ctx.io_stats)
        sort_s = r["run_s"] - r["repack_s"] - r["h2d_s"]
        retries = overflow_retries(ctx)
        ts_events = ctx.events.path
        del h, q, ctx
        free_card()
        t0 = time.perf_counter()
        out = _read_back(out_path)
        readback_s = time.perf_counter() - t0
        sorter.join()
        check_terasort(out, key, pay, "stores terasort", oracle=oracle["v"])
        del out, oracle
        shutil.rmtree(in_path)
        shutil.rmtree(out_path)
        gib = w["write_bytes"]
        res["terasort"] = {
            "rows": ST_ROWS, "to_store_fetch_s": w["fetch_s"], "to_store_write_s": w["write_s"],
            "to_store_fetch_gbps": _gbps(gib, w["fetch_s"]), "to_store_write_gbps": _gbps(gib, w["write_s"]),
            "from_store_read_s": r["read_s"], "from_store_read_gbps": _gbps(r["read_bytes"], r["read_s"]),
            "from_store_repack_s": r["repack_s"], "from_store_h2d_s": r["h2d_s"],
            "from_store_h2d_gbps": _gbps(r["h2d_bytes"], r["h2d_s"]), "sort_s": sort_s,
            "sorted_to_store_fetch_s": r["fetch_s"], "sorted_to_store_write_s": r["write_s"],
            "read_back_s": readback_s, "overflow_retries": retries, "bytes": gib,
        }
        log(f"stores terasort [{card}]: {ST_ROWS} rows, {gib / 2**30:.2f} GiB of columns, P={P}; "
            f"to_store: device->host {w['fetch_s']:.4f} s = {_gbps(gib, w['fetch_s']):.2f} GB/s, "
            f"write {w['write_s']:.4f} s = {_gbps(gib, w['write_s']):.2f} GB/s (into the page cache, "
            f"not synced); from_store's first query: read+parse {r['read_s']:.4f} s = "
            f"{_gbps(r['read_bytes'], r['read_s']):.2f} GB/s (from the page cache: the files were "
            f"just written), repack to (P, cap) {r['repack_s']:.4f} s, host->device "
            f"{r['h2d_s']:.4f} s = {_gbps(r['h2d_bytes'], r['h2d_s']):.2f} GB/s, sort {sort_s:.4f} s; "
            f"sorted to_store: device->host {r['fetch_s']:.4f} s, write {r['write_s']:.4f} s; "
            f"read back {readback_s:.4f} s; keys equal np.sort, pairs equal the input's; "
            f"{retries} overflow retries")

        # -- the compressed store ---------------------------------------------
        zkey, zpay = key[:ST_ZLIB_ROWS], pay[:ST_ZLIB_ROWS]
        zpath = os.path.join(root, "ts_zlib")
        ctx = context(intermediate_compression="zlib")
        ctx.from_arrays({"key": zkey, "payload": zpay}).to_store(zpath)
        zw = dict(ctx.io_stats)
        disk = sum(os.path.getsize(os.path.join(zpath, f)) for f in os.listdir(zpath))
        del ctx
        ctx = context()
        zq = ctx.from_store(zpath).order_by([("key", False)])
        zr = dict(ctx.io_stats)
        zout = zq.collect()
        check_terasort(zout, zkey, zpay, "stores zlib")
        res["zlib"] = {"rows": ST_ZLIB_ROWS, "write_s": zw["write_s"], "read_s": zr["read_s"],
                       "raw_bytes": zw["write_bytes"], "disk_bytes": disk,
                       "ratio": zw["write_bytes"] / disk}
        log(f"stores zlib [{card}]: {ST_ZLIB_ROWS} rows, {zw['write_bytes'] / 2**20:.0f} MiB raw, "
            f"{disk / 2**20:.0f} MiB on disk (ratio {zw['write_bytes'] / disk:.3f}); compress+write "
            f"{zw['write_s']:.3f} s = {_gbps(zw['write_bytes'], zw['write_s']):.3f} GB/s, read+inflate "
            f"{zr['read_s']:.3f} s = {_gbps(zw['write_bytes'], zr['read_s']):.3f} GB/s; rows check as "
            f"TeraSort's")
        del zq, ctx, zout, key, pay, zkey, zpay
        free_card()

        # -- WordCount through files and a STRING store -----------------------
        rng = np.random.default_rng(SEED + 15)
        ids = zipf_ids(rng, ST_WC_WORDS)
        tab = vocab_table()
        words = np.array([bytes(r).split()[0].decode() for r in tab], object)
        one = os.path.join(root, "corpus.txt")
        with open(one, "wb") as fh:
            fh.write(tab[ids].tobytes())
        paths = []
        for i, chunk in enumerate(np.array_split(ids, ST_WC_FILES)):
            paths.append(os.path.join(root, f"corpus-{i}.txt"))
            with open(paths[-1], "wb") as fh:
                fh.write(tab[chunk].tobytes())
        ctx = context()
        count = {"n": ("count", None)}
        t0 = time.perf_counter()
        q8 = ctx.from_text(paths)
        multi_s = time.perf_counter() - t0
        check(ctx.io_native is True and ctx.tokenizer_native is True,
              "multi-file from_text did not use the native prefetch channel and tokenizer")
        t0 = time.perf_counter()
        q1 = ctx.from_text(one)
        single_s = time.perf_counter() - t0
        check(digest(q8.group_by("word", count).collect()) == digest(q1.group_by("word", count).collect()),
              "from_text of 8 files counts differently from one file")
        words_path = os.path.join(root, "words")
        q8.to_store(words_path)
        wst = dict(ctx.io_stats)
        del q1, q8, ctx
        free_card()
        ctx = context()
        qs = ctx.from_store(words_path).group_by("word", count)
        top_q = qs.order_by([("n", True)]).take(20)
        text = top_q.explain()
        check("string_code" in text and "exchange_hash" not in text,
              "explain of the STRING store's top-20 shows no string_code or an exchange_hash")
        bucket_sum_count.launches = 0  # the stores path starts here
        t0 = time.perf_counter()
        table = qs.collect()
        first_s = time.perf_counter() - t0
        top = top_q.collect()
        launches = bucket_sum_count.launches
        check(launches == 2, f"WordCount from a STRING store launched the bucket kernel {launches} "
              "times, not 2 (the count and the top-20)")
        uid, ucnt = np.unique(ids, return_counts=True)
        oracle_wc = dict(zip(words[uid].tolist(), ucnt.tolist()))
        check(dict(zip(table["word"].tolist(), table["n"].tolist())) == oracle_wc,
              "WordCount from the STRING store differs from the numpy oracle")
        check(top["n"].tolist() == sorted(ucnt.tolist(), reverse=True)[:20],
              "top-20 counts from the STRING store differ from the oracle")
        check(all(oracle_wc[w_] == c for w_, c in zip(top["word"], top["n"])), "a top-20 word has a wrong count")
        h = qs.submit()
        check(digest(h.result()) == digest(qs.collect()), "submit(q).result() differs from collect()")
        res["wordcount"] = {"words": ST_WC_WORDS, "files": ST_WC_FILES, "from_text_files_s": multi_s,
                            "from_text_one_file_s": single_s,
                            "words_store_bytes": wst["write_bytes"], "words_to_store_write_s": wst["write_s"],
                            "first_query_s": first_s, "launches": launches}
        log(f"stores wordcount [{card}]: from_text (tokenize and register) of {ST_WC_FILES} files "
            f"({ST_WC_WORDS} words) {multi_s:.3f} s, of one file {single_s:.3f} s; counts equal; the words' STRING store "
            f"{wst['write_bytes'] / 2**20:.0f} MiB written in {wst['write_s']:.3f} s; from_store + "
            f"group_by first query {first_s:.3f} s; table and top-20 equal the oracle; explain shows "
            f"string_code and no exchange_hash; submit equals collect; bucket kernel launches {launches}")
        del ctx, qs, top_q, table, top, h
        free_card()

        # -- the event log ------------------------------------------------------
        check(len(set(contexts)) == len(contexts), "two contexts shared one event-log file")
        n_events = 0
        for path in contexts:
            evs = EventLog.load(path)
            n_events += len(evs)
            bad = sorted({e["kind"] for e in evs} - set(EVENT_KINDS))
            check(not bad, f"{path}: kinds outside EVENT_KINDS {bad}")
            kinds = [e["kind"] for e in evs]
            check(kinds.count("job_start") == kinds.count("job_complete") > 0,
                  f"{path}: {kinds.count('job_start')} job_start, {kinds.count('job_complete')} job_complete")
        ts_overflows = [e for e in EventLog.load(ts_events) if e["kind"] == "stage_overflow"]
        check(len(ts_overflows) == res["terasort"]["overflow_retries"],
              "the TeraSort log's stage_overflow count differs from overflow_retries")
        res["event_log"] = {"files": len(contexts), "events": n_events}
        log(f"stores event log: {len(contexts)} files, {n_events} events, every line parses, every kind "
            f"registered, job_start = job_complete per file, stage_overflow = overflow retries "
            f"({len(ts_overflows)})")

        # -- the samples on the card --------------------------------------------
        res["samples_s"] = {}
        for name, expect in SAMPLE_EXPECT.items():
            mod = importlib.import_module(f"dryad_tpu_torch.samples.{name}")
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                mod.main([])
            res["samples_s"][name] = time.perf_counter() - t0
            check(expect in buf.getvalue(), f"sample {name} did not print {expect!r}")
            free_card()
        log(f"stores samples [{card}]: " + ", ".join(f"{n} {t:.2f} s" for n, t in res["samples_s"].items())
            + "; each printed its expected string")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["peak_bytes"] = card_peak()
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"stores phase [{card}]: peak device memory (allocated + graph pool) {res['peak_bytes'] / 1e9:.2f} GB, "
        f"{res['phase_s']:.1f} s")
    return res


# -- phase 15: out-of-core streaming ---------------------------------------------

# the external TeraSort: 1 GiB of int32 keys and f32 payloads in two
# chunks (cut from 2^30 rows, then 2^29 and 2^28, so that every phase,
# the serve and cluster phases included, fits the run's time limit with
# room: PERF.md section 4)
SM_TS_ROWS = 1 << 26  # 2^27 to PR 9 (cut for the run's time limit)
SM_TS_SMALL_ROWS = 1 << 25  # the same query first, for the peak it must stay within 1.5x of
SM_TS_CHUNK = 1 << 24  # rows a from_stream chunk: 2 and 4 chunks for the peak check
SM_GB_ROWS = 1 << 26  # the combine-tree group_by (cut from 2^28 for the same limit)
SM_GB_CHUNK = 1 << 24
SM_PEAK_RATIO = 1.5
# streaming WordCount's bucket-kernel launches: 16 chunk partials (the
# corpus in 2^25-byte chunks), the combine tree's merges and its root
ST_WC_LAUNCHES = 22
# The TeraSort's spill peaks at its whole table (1 GiB at 2^27 rows) plus
# one bucket's re-split (1/32 of it); the corpus, the Join Task's stores
# and the event logs take about 2 GiB more, after the sort's spill is
# gone.
SM_FREE_BYTES = 10 << 30
_MIX1 = np.uint64(0x9E3779B97F4A7C15)


def row_checksum(key: np.ndarray, pay: np.ndarray) -> int:
    """Order-free checksum of (key, payload bits) rows: the sum, mod
    2^64, of a 64-bit mix of each row (a row's 64 bits, xor-shifted,
    times an odd constant)."""
    x = (key.view(np.uint32).astype(np.uint64) << np.uint64(32)) | pay.view(np.uint32)
    x ^= x >> np.uint64(29)
    x *= _MIX1
    return int(x.sum(dtype=np.uint64))


class DeviceBusy:
    """The card's busy share over a whole part, sampled every 100 ms by
    ``nvidia-smi`` on the card torch uses (NVML's ``utilization.gpu``:
    the share of each sample period in which a kernel ran; copies alone
    count as idle).  Cheap at
    any length, where a torch.profiler trace of the 2^27-row sort's
    thousands of bucket jobs takes minutes to read back."""

    def __enter__(self):
        torch.cuda.synchronize()
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", card_id(), "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        try:
            torch.cuda.synchronize()
            self.wall_s = time.perf_counter() - self.t0
        finally:
            self.proc.terminate()
            out, _ = self.proc.communicate(timeout=60)
        if exc[0] is not None:
            return
        samples = [float(x) for x in out.split() if x.replace(".", "", 1).isdigit()]
        check(bool(samples), "nvidia-smi gave no utilization samples")
        share = sum(samples) / len(samples) / 100.0
        self.samples = len(samples)
        self.busy_s = share * self.wall_s
        self.idle = 1.0 - share


def metric_total(ctx, name: str) -> float:
    """A counter of the context's metrics registry, summed over its
    labels (the stream driver counts ``spill_bytes`` and
    ``spill_read_bytes`` there)."""
    return sum(c["value"] for c in ctx.executor.metrics.snapshot()["counters"] if c["name"] == name)


class LaunchRecorder:
    """Keeps on the host, while installed, the inputs of the first call
    of the executor's bucket kernel (``exec/kernels.py``) at each shape
    (value-column count, K, cap): in a streaming WordCount, the chunk
    partials' count-only launches and the combine tree's merges and root
    of one int32 count column.  A call inside a stage program's capture
    (``exec/programs.py``) is recorded into the graph, not run: its
    input tensors are held (no copy enters the graph, so the graph is
    the one the port builds; only their blocks stay out of the pool's
    reuse until then) and copied to the host right after the graph's
    first replay filled them (the replay reports its launches through
    ``note_graph_launches``), before another graph of the shared pool
    can run over them.  ``launched()`` is what the kernel's counter
    should have gained: the calls outside a capture plus the launches
    the replays ran.  The kernel's launch counter is left as it is; the
    context runs one job at a time, so calls do not interleave."""

    def __enter__(self):
        from dryad_tpu_torch.exec import kernels
        from dryad_tpu_torch.ops import bucket

        self.mod, self.real = kernels, kernels.bucket_sum_count
        self.bucket, self.real_note = bucket, bucket.note_graph_launches
        self.calls, self.captured, self.replayed, self.first = 0, 0, 0, {}
        self.pending = {}  # shape -> a captured call's inputs, filled at the first replay

        def rec(keys, values, valid, num_buckets):
            self.calls += 1
            key = (len(values), int(num_buckets), int(keys.shape[1]))
            capturing = keys.is_cuda and torch.cuda.is_current_stream_capturing()
            self.captured += capturing
            if key not in self.first and key not in self.pending:
                if capturing:
                    self.pending[key] = (keys, list(values), valid)
                else:
                    self.first[key] = (keys.cpu(), [v.cpu() for v in values], valid.cpu())
            return self.real(keys, values, valid, num_buckets)

        def note(n):
            self.replayed += int(n)
            self.real_note(n)
            for key, (a, vs, m) in self.pending.items():
                self.first[key] = (a.cpu(), [v.cpu() for v in vs], m.cpu())
            self.pending.clear()

        kernels.bucket_sum_count = rec
        bucket.note_graph_launches = note
        return self

    def launched(self) -> int:
        return self.calls - self.captured + self.replayed

    def __exit__(self, *exc):
        self.mod.bucket_sum_count = self.real
        self.bucket.note_graph_launches = self.real_note
        check(exc[0] is not None or not self.pending,
              f"captured bucket launches at {sorted(self.pending)} never replayed")


def _stream_ctx(spill_root: str, **cfg):
    """A context on the reference's default stream configuration
    (pipeline depth 4, the combine tree, 2^21-row buckets, 32 buckets),
    spilling under ``spill_root``, keeping every event in memory."""
    from dryad_tpu_torch import DryadConfig, DryadContext

    ctx = DryadContext(num_partitions_=P, config=DryadConfig(
        stream_spill_dir=spill_root, obs_events_mem_cap=0, **cfg))
    c = ctx.config
    check((c.stream_pipeline_depth, c.combine_tree, c.stream_bucket_rows, c.stream_buckets)
          == (4, True, 1 << 21, 32), "the stream phase is not on the default stream config")
    return ctx


def stream_terasort(rows: int, spill_root: str, card: str) -> dict:
    """order_by(key) over a from_stream of ``rows`` seeded rows in
    SM_TS_CHUNK-row chunks, read with collect_stream and checked as it
    streams: each piece sorted, piece boundaries non-decreasing, the row
    count, and the order-free checksum of (key, payload bits)."""
    rng = np.random.default_rng(SEED + 16)
    chunk = min(SM_TS_CHUNK, rows)
    made = {"rows": 0, "sum": 0, "s": 0.0}

    def chunks():
        for _ in range(rows // chunk):
            t = time.perf_counter()
            key = rng.integers(-2**31, 2**31, chunk, dtype=np.int32)
            pay = rng.random(chunk, dtype=np.float32)
            made["rows"] += chunk
            made["sum"] = (made["sum"] + row_checksum(key, pay)) % (1 << 64)
            made["s"] += time.perf_counter() - t
            yield {"key": key, "payload": pay}

    ctx = _stream_ctx(spill_root)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    got, total, last, pieces = 0, 0, None, 0
    t0 = time.monotonic()
    with DeviceBusy() as busy:
        for piece in ctx.from_stream(chunks()).order_by([("key", False)]).collect_stream():
            k = piece["key"]
            if len(k) == 0:
                continue
            check(bool((k[1:] >= k[:-1]).all()), f"stream terasort: piece {pieces} is not sorted")
            check(last is None or int(k[0]) >= last, f"stream terasort: piece {pieces} starts below "
                  "the previous piece's last key")
            last = int(k[-1])
            got += len(k)
            total = (total + row_checksum(k, piece["payload"])) % (1 << 64)
            pieces += 1
        t_end = time.monotonic()
    peak = card_peak()
    evs = ctx.events.events()
    written, read = metric_total(ctx, "spill_bytes"), metric_total(ctx, "spill_read_bytes")
    check(written > 0 and read >= written, f"stream terasort: spill written {written} bytes, read {read}")
    check(got == made["rows"] == rows, f"stream terasort: {got} rows out of {rows}")
    check(total == made["sum"], "stream terasort: the (key, payload) checksum differs from the input's")
    kinds = [e["kind"] for e in evs]
    check("events_dropped" not in kinds, "stream terasort: the event log dropped events")
    gather_at = min(e["mono"] for e in evs if e["kind"] in ("stream_bucket", "stream_bucket_split"))
    splits = [e for e in evs if e["kind"] == "stream_bucket_split"]
    res = {
        "rows": rows, "bytes": rows * 8, "wall_s": busy.wall_s, "rows_per_s": rows / busy.wall_s,
        "scatter_s": gather_at - t0, "gather_s": t_end - gather_at, "source_s": made["s"],
        "spill_written_bytes": written, "spill_read_bytes": read,
        "buckets_sorted": kinds.count("stream_bucket"), "pieces": pieces,
        "phase1_buckets": len({e["bucket"] for e in evs if e["kind"] == "stream_spill" and e["depth"] == 0}),
        "resplits": sum(e["mode"] == "resplit" for e in splits),
        "peak_bytes": peak, "device_busy_s": busy.busy_s, "device_idle": busy.idle, "card": card,
    }
    log(f"stream terasort [{card}]: {rows} rows ({rows * 8 / 2**30:.2f} GiB) in {busy.wall_s:.2f} s = "
        f"{rows / busy.wall_s:.4g} rows/s; phase-1 scatter {res['scatter_s']:.2f} s (of it the "
        f"source's generation and checksum {made['s']:.2f} s, on the prefetch thread), phase-2 "
        f"gather {res['gather_s']:.2f} s; spill written {written / 2**30:.2f} GiB, read "
        f"{read / 2**30:.2f} GiB; {res['phase1_buckets']} phase-1 buckets, {res['resplits']} "
        f"re-splits, {res['buckets_sorted']} buckets sorted on the card, {pieces} pieces, each sorted, "
        f"boundaries ordered, rows and checksum equal the input's; peak device memory "
        f"(allocated + graph pool) {peak / 1e9:.3f} GB; device busy {busy.busy_s:.3f} s, idle {busy.idle:.3f}")
    del ctx
    free_card()
    return res


def kernel_shape_report(keys, vals, valid, K: int) -> dict:
    """Holds the bucket kernel byte for byte against its plain version
    on inputs a main path gave it (kept on the host by LaunchRecorder),
    and times both, one PyTorch call computing the same function
    (``torch.bincount`` for counts alone; otherwise one ``index_add_``
    of the stacked mask and value columns: int64 when every column is
    int32, else f32) and the bound: each input byte once (keys, mask,
    value columns), the count and sum tables written once."""
    from dryad_tpu_torch.ops.bucket import bucket_sum_count, bucket_sum_count_plain

    keys, valid, vals = keys.cuda(), valid.cuda(), [v.cuda() for v in vals]
    _compare(keys, valid, vals, K)
    Pk, cap = keys.shape
    n = keys.numel()
    m = len(vals)
    kinds = ",".join(str(v.dtype).replace("torch.", "") for v in vals) or "-"
    # invalid rows go to one extra bucket, outside the timed call
    flat = torch.where(valid, keys.long() + torch.arange(Pk, device=keys.device).reshape(Pk, 1) * K,
                       Pk * K).reshape(-1)
    counts = bucket_sum_count(keys, vals, valid, K)[1]
    if not vals:
        library = "torch.bincount"
        lib = lambda: torch.bincount(flat, minlength=Pk * K + 1)  # noqa: E731
        check(torch.equal(lib()[: Pk * K].reshape(Pk, K).float(), counts),
              "bincount yardstick counts differ")
    else:
        dt = torch.float32 if any(v.is_floating_point() for v in vals) else torch.int64
        src = torch.stack([valid.reshape(-1).to(dt)] + [v.reshape(-1).to(dt) for v in vals], 1)
        tab = torch.zeros((Pk * K + 1, 1 + m), dtype=dt, device=keys.device)
        library = f"one index_add_ of a (rows, {1 + m}) {str(dt).replace('torch.', '')} source"
        lib = lambda: tab.zero_().index_add_(0, flat, src)  # noqa: E731
        check(torch.equal(lib()[: Pk * K, 0].reshape(Pk, K).float(), counts),
              "index_add_ yardstick counts differ")
    out = {
        "shape": f"P={Pk} cap={cap} K={K} values={m}" + (f" ({kinds})" if m else ""),
        "kernel_ms": cuda_time_ms(lambda: bucket_sum_count(keys, vals, valid, K), 10),
        "plain_ms": cuda_time_ms(lambda: bucket_sum_count_plain(keys, vals, valid, K), 3),
        "library": library,
        "library_ms": cuda_time_ms(lib, 10),
        "bound_ms": (n * (4 + 1 + 4 * m) + (1 + m) * Pk * K * 4) / HBM_BYTES_PER_S * 1e3,
    }
    del keys, valid, vals, flat
    return out


def stream_wordcount(root: str, spill_root: str, card: str) -> dict:
    """The wordcount phase's corpus as 8 files through text_stream
    (2^25-byte chunks), group_by(word, count), then the top 20; equal
    to the in-core WordCount of the same corpus (the wordcount phase's
    table when it ran, else the 8 files through from_text), and to the
    numpy oracle.  The bucket kernel's launches are counted from 0 just
    before the stream query; the inputs of its first launch at each
    shape the query gives it are kept and, after the query, the kernel
    is held byte for byte against its plain version on each."""
    from dryad_tpu_torch import DryadContext
    from dryad_tpu_torch.ops.bucket import bucket_sum_count

    rng = np.random.default_rng(SEED + 2)
    ids = zipf_ids(rng, WC_WORDS)
    tab = vocab_table()
    words = np.array([bytes(r).split()[0].decode() for r in tab], object)
    paths = []
    for i, part in enumerate(np.array_split(ids, ST_WC_FILES)):
        paths.append(os.path.join(root, f"corpus-{i}.txt"))
        with open(paths[-1], "wb") as fh:
            fh.write(tab[part].tobytes())
    count = {"n": ("count", None)}
    ctx = _stream_ctx(spill_root)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    bucket_sum_count.launches = 0  # the stream path starts here
    with LaunchRecorder() as rec, DeviceBusy() as busy:
        table = ctx.text_stream(paths).group_by("word", count).collect()
    launches = bucket_sum_count.launches
    peak = card_peak()
    top = ctx.from_arrays(table).order_by([("n", True)]).take(20).collect()
    check(launches == rec.launched() == ST_WC_LAUNCHES,
          f"streaming WordCount launched the bucket kernel {launches} times, its calls and replays "
          f"{rec.launched()}, expected {ST_WC_LAUNCHES}")
    check({m for m, _, _ in rec.first} == {0, 1},
          f"streaming WordCount's kernel shapes {sorted(rec.first)} lack a chunk partial or a merge")
    shapes = []
    for (m, K, _), (keys, vals, valid) in sorted(rec.first.items()):
        shapes.append(kernel_shape_report(keys, vals, valid, K))
        log(f"kernel vs plain at the stream WordCount's {'merge' if m else 'chunk partial'} shape "
            f"({shapes[-1]['shape']}): byte-equal; kernel {shapes[-1]['kernel_ms']:.3f} ms, "
            f"plain {shapes[-1]['plain_ms']:.3f} ms, {shapes[-1]['library']} "
            f"{shapes[-1]['library_ms']:.3f} ms, bound {shapes[-1]['bound_ms']:.4f} ms")
    rec.first.clear()
    chunks = sum(e["kind"] == "stream_chunk" for e in ctx.events.events())
    pool = ctx.executor.operand_pool
    operands = {"hits": pool.hits, "full_uploads": pool.full_uploads,
                "delta_scatters": pool.delta_scatters,
                "operand_h2d_bytes": metric_total(ctx, "operand_h2d_bytes")}
    check(pool.delta_scatters >= 1, f"streaming WordCount: the widening vocabulary scattered no "
          f"delta (operand pool {operands})")
    log(f"stream wordcount [{card}]: operand pool hits {pool.hits}, full uploads {pool.full_uploads}, "
        f"delta scatters {pool.delta_scatters}, operand_h2d_bytes {operands['operand_h2d_bytes']:.0f}")
    del ctx
    free_card()
    if "wordcount" in _FLAT:  # the wordcount phase's in-core table of the same corpus
        ref, incore_s = _FLAT["wordcount"][0], None
    else:
        incore = DryadContext(num_partitions_=P)
        t0 = time.perf_counter()
        ref = incore.from_text(paths).group_by("word", count).collect()
        incore_s = time.perf_counter() - t0
        del incore
        free_card()
    got = dict(zip(table["word"].tolist(), table["n"].tolist()))
    check(table["n"].dtype == np.int32, "streaming WordCount's count column is not int32")
    check(got == dict(zip(ref["word"].tolist(), ref["n"].tolist())),
          "streaming WordCount differs from the in-core WordCount")
    uid, ucnt = np.unique(ids, return_counts=True)
    check(got == dict(zip(words[uid].tolist(), ucnt.tolist())), "streaming WordCount differs from numpy")
    check(top["n"].tolist() == sorted(ref["n"].tolist(), reverse=True)[:20]
          == sorted(ucnt.tolist(), reverse=True)[:20],
          "streaming top-20 counts differ from the in-core top-20")
    check(all(got[w] == c for w, c in zip(top["word"], top["n"])), "a streaming top-20 word has a wrong count")
    res = {"words": WC_WORDS, "files": len(paths), "chunks": chunks, "wall_s": busy.wall_s,
           "words_per_s": WC_WORDS / busy.wall_s, "incore_s": incore_s, "launches": launches,
           "kernel_shapes": shapes, "operand_pool": operands,
           "peak_bytes": peak, "device_busy_s": busy.busy_s, "device_idle": busy.idle, "card": card}
    log(f"stream wordcount [{card}]: {WC_WORDS} words in {len(paths)} files, {chunks} chunks of "
        f"2^25 bytes, text_stream + group_by {busy.wall_s:.2f} s = {WC_WORDS / busy.wall_s:.4g} words/s "
        + (f"(in-core from_text + group_by: {incore_s:.2f} s)" if incore_s is not None else
           "(in-core: the wordcount phase's table)")
        + f"; {len(got)} words, table and top-20 "
        f"equal the in-core WordCount and numpy; bucket kernel launches {launches}; peak device memory "
        f"(allocated + graph pool) {peak / 1e9:.3f} GB; device busy {busy.busy_s:.3f} s, idle {busy.idle:.3f}")
    for p in paths:
        os.remove(p)
    return res


def stream_groupby(spill_root: str, card: str) -> dict:
    """SM_GB_ROWS rows over GB_KEYS int32 keys spread over the int32
    range (groupby_sort's distribution), SM_GB_CHUNK-row chunks, through
    the combine tree: count, int sum, min, max exact; the f32 sum within
    n_g * 2^-23 * sum|v| of float64; the tree's merge events logged."""
    rng = np.random.default_rng(SEED + 17)
    width = (1 << 32) // GB_KEYS
    pool = (np.arange(GB_KEYS, dtype=np.int64) * width + rng.integers(0, width, GB_KEYS)
            - 2**31).astype(np.int32)  # ascending, one key in each bin
    o_cnt = np.zeros(GB_KEYS, np.int64)
    o_sum = np.zeros(GB_KEYS, np.int64)
    o_min = np.full(GB_KEYS, np.iinfo(np.int32).max, np.int32)
    o_max = np.full(GB_KEYS, np.iinfo(np.int32).min, np.int32)
    o_fs = np.zeros(GB_KEYS)
    o_abs = np.zeros(GB_KEYS)

    def chunks():
        for _ in range(SM_GB_ROWS // SM_GB_CHUNK):
            idx = rng.integers(0, GB_KEYS, SM_GB_CHUNK)
            w = rng.integers(-1000, 1000, SM_GB_CHUNK, dtype=np.int32)
            v = (rng.standard_normal(SM_GB_CHUNK) * 100).astype(np.float32)
            o_cnt[:] += np.bincount(idx, minlength=GB_KEYS)
            o_sum[:] += np.bincount(idx, weights=w, minlength=GB_KEYS).astype(np.int64)
            np.minimum.at(o_min, idx, w)
            np.maximum.at(o_max, idx, w)
            o_fs[:] += np.bincount(idx, weights=v.astype(np.float64), minlength=GB_KEYS)
            o_abs[:] += np.bincount(idx, weights=np.abs(v.astype(np.float64)), minlength=GB_KEYS)
            yield {"key": pool[idx], "w": w, "v": v}

    ctx = _stream_ctx(spill_root)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    aggs = {"c": ("count", None), "sw": ("sum", "w"), "lo": ("min", "w"), "hi": ("max", "w"),
            "sv": ("sum", "v")}
    with DeviceBusy() as busy:
        out = ctx.from_stream(chunks()).group_by("key", aggs).collect()
    peak = card_peak()
    evs = ctx.events.events()
    del ctx
    free_card()
    live = o_cnt > 0
    o = np.argsort(out["key"])
    got = {c: a[o] for c, a in out.items()}
    check(np.array_equal(got["key"], pool[live]), "stream group_by: keys differ from the oracle's")
    check(np.array_equal(got["c"], o_cnt[live].astype(np.int32)), "stream group_by: counts differ")
    check(np.array_equal(got["sw"].astype(np.int64), o_sum[live]), "stream group_by: int sums differ")
    check(np.array_equal(got["lo"], o_min[live]) and np.array_equal(got["hi"], o_max[live]),
          "stream group_by: min or max differ")
    err = np.abs(got["sv"].astype(np.float64) - o_fs[live])
    check(bool((err <= o_cnt[live] * F32_REL * o_abs[live]).all()),
          "stream group_by: f32 sums past n_g * 2^-23 * sum|v|")
    levels = [e for e in evs if e["kind"] == "combine_tree_level"]
    check(bool(levels), "stream group_by: the combine tree logged no merge")
    check(not any(e["kind"] == "combine_tree_degrade" for e in evs),
          "stream group_by: a reducing stream degraded key ranges to the host")
    res = {"rows": SM_GB_ROWS, "keys": int(live.sum()), "wall_s": busy.wall_s,
           "rows_per_s": SM_GB_ROWS / busy.wall_s, "tree_merges": len(levels),
           "tree_levels": sorted({e["level"] for e in levels}),
           "stream_combine_events": sum(e["kind"] == "stream_combine" for e in evs),
           "max_rel_err_sum": float((err / np.maximum(o_abs[live], 1e-30)).max()),
           "peak_bytes": peak, "device_busy_s": busy.busy_s, "device_idle": busy.idle, "card": card}
    log(f"stream group_by [{card}]: {SM_GB_ROWS} rows in {SM_GB_ROWS // SM_GB_CHUNK} chunks, "
        f"{res['keys']} keys, {busy.wall_s:.2f} s = {SM_GB_ROWS / busy.wall_s:.4g} rows/s; count, int "
        f"sum, min, max exact, f32 sum within n_g*2^-23*sum|v| (max |err|/sum|v| "
        f"{res['max_rel_err_sum']:.3g}); {len(levels)} combine_tree_level merges at levels "
        f"{res['tree_levels']}, {res['stream_combine_events']} stream_combine; peak device memory "
        f"(allocated + graph pool) {peak / 1e9:.3f} GB; device busy {busy.busy_s:.3f} s, idle {busy.idle:.3f}")
    return res


def stream_join(root: str, spill_root: str, card: str) -> dict:
    """The Join Task's tables (join_shuffle's generator and seed) written
    with to_store and opened with store_stream, so both sides stream and
    the join takes the Grace path; then group_by("sourceIP") and a
    stream to_store.  The store read back equals the in-core
    join_shuffle query on the same data."""
    from dryad_tpu_torch import DryadConfig, DryadContext

    rng = np.random.default_rng(SEED + 8)
    visits, rankings = visits_tables(rng)
    vpath, rpath, opath = (os.path.join(root, n) for n in ("visits", "rankings", "grouped"))
    ctx = DryadContext(num_partitions_=P)
    ctx.from_arrays(visits).to_store(vpath)
    ctx.from_arrays(rankings).to_store(rpath)
    del ctx
    free_card()
    lo, hi = JS_WEEK
    ctx = _stream_ctx(spill_root)
    torch.cuda.reset_peak_memory_stats()
    with DeviceBusy() as busy:
        v = ctx.store_stream(vpath).where(lambda c: (c["visitDate"] >= lo) & (c["visitDate"] < hi))
        j = v.join(ctx.store_stream(rpath), "destURL", "pageURL", strategy="auto", expansion=1.0)
        h = j.group_by("sourceIP", JS_AGGS).to_store(opath)
    peak = card_peak()
    evs = ctx.events.events()
    check(any(e["kind"] == "stream_store" for e in evs), "stream join: to_store did not stream")
    joins = sum(e["kind"] == "stream_bucket" for e in evs)
    del ctx, v, j
    free_card()
    table = _read_back(opath)
    check(int(h.result()["rows"][0]) == len(table["sourceIP"]), "stream join: the store's row count differs")
    incore = DryadContext(num_partitions_=P, config=DryadConfig(device_cache_bytes=JOIN_CACHE_BYTES))
    iv = incore.from_arrays(visits).where(lambda c: (c["visitDate"] >= lo) & (c["visitDate"] < hi))
    ref = iv.join(incore.from_arrays(rankings), "destURL", "pageURL", strategy="auto",
                  expansion=1.0).group_by("sourceIP", JS_AGGS).collect()
    del incore, iv
    free_card()
    o, r = np.argsort(table["sourceIP"]), np.argsort(ref["sourceIP"])
    check(np.array_equal(table["sourceIP"][o], ref["sourceIP"][r])
          and np.array_equal(table["n"][o], ref["n"][r]),
          "stream join: sourceIPs or counts differ from the in-core join_shuffle query")
    keep, uk, cnt, rel_err = check_join_task(table, visits, rankings, "stream join")
    check_join_task(ref, visits, rankings, "in-core join")
    res = {"visits": JS_VISITS, "pages": JS_PAGES, "groups": int(len(uk)), "bucket_joins": joins,
           "wall_s": busy.wall_s, "max_rel_err_revenue": float(rel_err.max()), "peak_bytes": peak,
           "device_busy_s": busy.busy_s, "device_idle": busy.idle, "card": card}
    log(f"stream join [{card}]: {JS_VISITS} visits and {JS_PAGES} pages from stores, Grace join in "
        f"{joins} bucket jobs, group_by and to_store {busy.wall_s:.2f} s; {len(uk)} sourceIPs, keys and "
        f"counts equal the in-core query's, revenue within n_g*2^-23*sum|v| (max rel err "
        f"{res['max_rel_err_revenue']:.3g}); peak device memory (allocated + graph pool) {peak / 1e9:.3f} GB; device busy "
        f"{busy.busy_s:.3f} s, idle {busy.idle:.3f}")
    return res


def phase_stream(dev, card: str) -> dict:
    """Out-of-core streaming on the default stream config at P=8: the
    external TeraSort at SM_TS_SMALL_ROWS and SM_TS_ROWS (its peak device
    memory may not grow past SM_PEAK_RATIO), streaming WordCount (the
    bucket kernel's stream path), the combine-tree group_by, and the
    Grace join into a store.  Spills go under WORK_DIR/stream."""
    import shutil

    t_phase = time.perf_counter()
    root = os.path.join(WORK_DIR, "stream")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    free = shutil.disk_usage(root).free
    if free < SM_FREE_BYTES:
        raise RuntimeError(f"stream phase needs {SM_FREE_BYTES / 2**30:.0f} GiB free under {root}; "
                           f"{free / 2**30:.1f} GiB free")
    spill_root = os.path.join(root, "spill")
    res = {"card": card, "free_bytes": free}
    try:
        res["terasort_small"] = stream_terasort(SM_TS_SMALL_ROWS, spill_root, card)
        res["terasort"] = stream_terasort(SM_TS_ROWS, spill_root, card)
        ratio = res["terasort"]["peak_bytes"] / res["terasort_small"]["peak_bytes"]
        res["terasort_peak_ratio"] = ratio
        check(ratio <= SM_PEAK_RATIO, f"stream terasort: the {SM_TS_ROWS}-row peak is {ratio:.3f}x the "
              f"{SM_TS_SMALL_ROWS}-row peak, past {SM_PEAK_RATIO}x")
        log(f"stream terasort: peak device memory (allocated + graph pool) {res['terasort']['peak_bytes'] / 1e9:.3f} GB at "
            f"{SM_TS_ROWS} rows, {res['terasort_small']['peak_bytes'] / 1e9:.3f} GB at "
            f"{SM_TS_SMALL_ROWS} rows: {ratio:.3f}x")
        check(not os.listdir(spill_root), "stream terasort left spill directories behind")
        res["wordcount"] = stream_wordcount(root, spill_root, card)
        res["groupby"] = stream_groupby(spill_root, card)
        res["join"] = stream_join(root, spill_root, card)
        check(not os.listdir(spill_root), "the stream phase left spill directories behind")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["launches"] = res["wordcount"]["launches"]
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"stream phase [{card}]: {res['phase_s']:.1f} s")
    return res


# -- phase 16: serving tenants from one resident engine -------------------------

SV_TENANTS = 4
SV_ROWS = 1 << 22  # each tenant's table (the bench's 2^24; 2^23 to PR 9; cut for the run's time limit)
SV_WORDS = 1024  # each tenant's STRING keys t{t}w{i:04d}
SV_CELLS = (16, 64)  # closed-loop client threads
SV_PER_CLIENT = 6
SV_CACHE_BYTES = 256 << 20
# the tables stay resident: 4 tenants' device tables (~0.85 GB each at
# the bench's 2^24 rows) pass the 2 GiB default and would re-upload
# every query
SV_DEVICE_CACHE = 16 << 30
SV_MAX_CLIENTS_PER_TENANT = max(SV_CELLS) // SV_TENANTS
MV_ROWS = 1 << 22  # the hot tenant's table, and the unrelated tenant's (the bench's 2^24; 2^23 to PR 9)
MV_KEYS = 512
# the bench's chunk-to-table ratio, 1/4; the writer's appends set each
# mode's wall time (about 5 s each at 2^24 rows on the card: the grown
# table's fingerprint and the views' folds), so 2 of the bench's 6 fit
# the run's time limit beside the cluster phase (PERF.md section 4)
MV_APPENDS = 2
MV_APPEND_ROWS = 1 << 20
MV_READERS = 8
MV_READS = 8  # the bench's 12, cut for the run's time limit
MV_OTHER_READERS = MV_READERS // 2
MV_STALENESS_S = 0.05
MV_MODES = ("views", "recompute", "epoch")
CK_FREE_BYTES = 10 << 30  # the group_by's checkpoint (4.4 GB) twice: a rerun writes its new copy before removing the old


def serve_tables(rng, rows: int = None) -> list:
    """The reference's serve bench schema: per tenant a STRING key over
    its 1024 words (indexed from a vocabulary array), int64 v in [0,
    1000) and f32 w; each with its word ids for the oracle.  ``rows``
    a table (default SV_ROWS)."""
    rows = SV_ROWS if rows is None else rows
    out = []
    for t in range(SV_TENANTS):
        vocab = np.array([f"t{t}w{i:04d}" for i in range(SV_WORDS)], object)
        ids = rng.integers(0, SV_WORDS, rows)
        out.append((vocab, ids, {
            "k": vocab[ids],
            "v": rng.integers(0, 1000, rows).astype(np.int64),
            "w": rng.random(rows).astype(np.float32),
        }))
    return out


def serve_plans(tab) -> list:
    """The bench's four prepared shapes, all value-hashable."""
    return [
        tab.group_by("k", {"s": ("sum", "v")}),
        tab.group_by("k", {"c": ("count", None), "m": ("mean", "w")}),
        tab.distinct("k"),
        tab.order_by("v").take(64),
    ]


def serve_oracle(i: int, out: dict, vocab, ids, data) -> None:
    """Plan ``i``'s result against numpy: keys, counts and integer sums
    exact, the mean within 2^-16 * sum|w| of its key's, the top-64 rows
    rows of the table with the 64 smallest v."""
    cnt = np.bincount(ids, minlength=SV_WORDS)
    present = np.flatnonzero(cnt)
    if i == 3:
        v = out["v"]
        check(np.array_equal(v, np.sort(data["v"])[:64]), "serve top-64: v differs from np.sort")
        pool = {}
        for val in np.unique(v):
            m = data["v"] == val
            pool[int(val)] = set(zip(ids[m].tolist(), data["w"][m].view(np.int32).tolist()))
        idx = {w: j for j, w in enumerate(vocab.tolist())}
        rows = zip(out["k"].tolist(), v.tolist(), out["w"].view(np.int32).tolist())
        check(all((idx[k], wb) in pool[val] for k, val, wb in rows),
              "serve top-64: a row is not a row of the table")
        return
    keys = np.array([int(str(k)[-4:]) for k in out["k"]])
    check(sorted(keys.tolist()) == present.tolist(), f"serve plan {i}: keys differ from numpy")
    if i == 0:
        sums = np.bincount(ids, weights=data["v"], minlength=SV_WORDS)
        check(out["s"].dtype == np.int64 and np.array_equal(out["s"], sums[keys].astype(np.int64)),
              "serve plan 0: int64 sums differ from numpy")
    elif i == 1:
        check(np.array_equal(out["c"], cnt[keys].astype(np.int32)), "serve plan 1: counts differ")
        sw = np.bincount(ids, weights=data["w"].astype(np.float64), minlength=SV_WORDS)
        aw = np.bincount(ids, weights=np.abs(data["w"]).astype(np.float64), minlength=SV_WORDS)
        err = np.abs(out["m"].astype(np.float64) - sw[keys] / cnt[keys])
        check(bool((err <= FLOAT_REL * aw[keys]).all()), "serve plan 1: mean past 2^-16 * sum|w|")


def _dispatches(ctx) -> int:
    from dryad_tpu_torch.obs.metrics import JobMetrics

    return JobMetrics.from_events(ctx.events.events()).dispatch_count


def _pct(lat: list, q: float) -> float:
    lat = sorted(lat)
    return lat[min(len(lat) - 1, int(len(lat) * q))]


def serve_cell(ctx, plans, refs, plan_dispatches, clients: int, cache_on: bool, card: str) -> dict:
    """The bench's run_cell: ``clients`` closed-loop threads spread over
    the tenants, SV_PER_CLIENT queries each (a rejected query is
    retried), through one QueryService over ``ctx``.  Every result is
    held byte for byte against its plan's serial result, and the
    dispatches of the cell against the plans' serial dispatch counts:
    a cache hit adds none."""
    import threading

    from dryad_tpu_torch.serve import QueryRejected, QueryService

    ctx.config.serve_result_cache_bytes = SV_CACHE_BYTES if cache_on else 0
    d0 = _dispatches(ctx)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    svc = QueryService(ctx)
    lat = [[] for _ in range(clients)]
    fin = [0.0] * clients
    served, errors = [], []
    rejected = [0]

    def client(i):
        tenant = i % SV_TENANTS
        sess = svc.session(f"tenant{tenant}")
        try:
            for j in range(SV_PER_CLIENT):
                pi = (i // SV_TENANTS + j) % len(plans[tenant])
                t0 = time.perf_counter()
                while True:
                    try:
                        fut = sess.submit(plans[tenant][pi])
                        out = fut.result(timeout=600)
                        break
                    except QueryRejected:
                        rejected[0] += 1
                        time.sleep(0.002)
                lat[i].append(time.perf_counter() - t0)
                served.append((tenant, pi, out, fut.cached))
            fin[i] = time.perf_counter()
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(repr(e))

    ths = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    with DeviceBusy() as busy:
        t_start = time.perf_counter()
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        elapsed = time.perf_counter() - t_start
    stats = svc.stats()
    svc.close()
    peak = card_peak()
    check(not errors, f"serve cell {clients}/{'on' if cache_on else 'off'}: {errors[:1]}")
    queries = clients * SV_PER_CLIENT
    check(len(served) == queries, "a served query went missing")
    for tenant, pi, out, _cached in served:
        _byte_equal(out, refs[tenant][pi], f"served tenant{tenant} plan {pi}")
    hits = sum(c for *_, c in served)
    check(cache_on or hits == 0, "a query was served from the cache with the cache off")
    want = sum(plan_dispatches[t][pi] for t, pi, _, c in served if not c)
    got = _dispatches(ctx) - d0
    check(got == want, f"serve cell: {got} dispatches, expected {want} (a cache hit dispatched)")
    check(rejected[0] == 0 and sum(t["rejected"] for t in stats["tenants"].values()) == 0,
          f"serve cell: {rejected[0]} queries rejected")
    tput = []
    for t in range(SV_TENANTS):
        el = max(fin[i] for i in range(clients) if i % SV_TENANTS == t) - t_start
        tput.append(stats["tenants"][f"tenant{t}"]["completed"] / max(el, 1e-9))
    all_lat = [x for ls in lat for x in ls]
    cache = stats["cache"]
    looked = cache["hits"] + cache["misses"]
    res = {
        "clients": clients, "cache": "on" if cache_on else "off", "queries": queries,
        "seconds": elapsed, "queries_per_s": queries / elapsed,
        "rows_per_s": queries * SV_ROWS / elapsed,
        "p50_ms": 1e3 * _pct(all_lat, 0.5), "p99_ms": 1e3 * _pct(all_lat, 0.99),
        "cache_hit_rate": cache["hits"] / looked if looked else 0.0, "served_hits": hits,
        "fairness_spread": max(tput) / max(min(tput), 1e-9), "rejected": rejected[0],
        "dispatches": got, "device_idle": busy.idle, "device_busy_s": busy.busy_s,
        "peak_bytes": peak, "card": card,
    }
    log(f"serve cell [{card}]: {clients} clients, cache {res['cache']}: {queries} queries in "
        f"{elapsed:.3f} s = {res['queries_per_s']:.1f} queries/s, {res['rows_per_s']:.4g} rows/s; "
        f"p50 {res['p50_ms']:.2f} ms, p99 {res['p99_ms']:.2f} ms; hit rate "
        f"{res['cache_hit_rate']:.3f} ({hits} hits, {got} dispatches); fairness spread "
        f"{res['fairness_spread']:.3f}; rejected {rejected[0]}; device idle {busy.idle:.3f}; "
        f"peak device memory (allocated + graph pool) {peak / 1e9:.2f} GB; every result byte-equal to serial")
    return res


def serve_tenants(card: str) -> dict:
    """4 tenants of SV_ROWS rows on one resident context; each plan run
    serially (cold, then warm: the warm result is the reference), then
    the cells of SV_CELLS clients with the result cache off and on."""
    from dryad_tpu_torch import DryadConfig, DryadContext

    rng = np.random.default_rng(SEED + 11)
    t0 = time.perf_counter()
    tables = serve_tables(rng)
    gen_s = time.perf_counter() - t0
    cost = sum(a.nbytes for a in tables[0][2].values())
    # the default byte budget (1 GiB) admits 3 of these 320 MiB queries
    # a tenant at once; the cells' closed loops keep up to
    # SV_MAX_CLIENTS_PER_TENANT in flight, so the budget admits them all
    ctx = DryadContext(num_partitions_=P, config=DryadConfig(
        device_cache_bytes=SV_DEVICE_CACHE, obs_events_mem_cap=0,
        serve_max_bytes=SV_MAX_CLIENTS_PER_TENANT * cost))
    check(ctx.config.serve_max_inflight >= SV_MAX_CLIENTS_PER_TENANT,
          "the default in-flight quota is below the clients a tenant runs")
    t0 = time.perf_counter()
    tabs = [ctx.from_arrays(d) for _, _, d in tables]
    register_s = time.perf_counter() - t0
    plans = [serve_plans(t) for t in tabs]
    check(ctx.query_input_bytes(plans[0][0]) == cost, "query_input_bytes is not the table's bytes")
    refs, plan_dispatches, first_s = [], [], []
    for (vocab, ids, data), ps in zip(tables, plans):
        refs.append([])
        plan_dispatches.append([])
        for i, q in enumerate(ps):
            t0 = time.perf_counter()
            cold = ctx.run_to_host(q)
            first_s.append(time.perf_counter() - t0)
            d0 = _dispatches(ctx)
            warm = ctx.run_to_host(q)
            plan_dispatches[-1].append(_dispatches(ctx) - d0)
            _byte_equal(warm, cold, f"serial plan {i}: warm vs cold")
            serve_oracle(i, warm, vocab, ids, data)
            refs[-1].append(warm)
    log(f"serve tables [{card}]: {SV_TENANTS} tenants x {SV_ROWS} rows generated in {gen_s:.2f} s, "
        f"registered in {register_s:.2f} s; serial plans (first run, ingest included) "
        f"{min(first_s):.3f}-{max(first_s):.3f} s; every result equals numpy; dispatches a plan "
        f"{plan_dispatches[0]}")
    cells = []
    for clients in SV_CELLS:
        for cache_on in (False, True):
            cells.append(serve_cell(ctx, plans, refs, plan_dispatches, clients, cache_on, card))
    # one hit, alone: zero dispatches
    from dryad_tpu_torch.serve import QueryService

    ctx.config.serve_result_cache_bytes = SV_CACHE_BYTES
    with QueryService(ctx) as svc:
        s = svc.session("tenant0")
        s.run(plans[0][1], timeout=600)
        d0 = _dispatches(ctx)
        fut = s.submit(plans[0][1])
        _byte_equal(fut.result(timeout=600), refs[0][1], "a cache hit")
        check(fut.cached and _dispatches(ctx) == d0, "a cache hit added dispatches")
    del ctx, tabs, plans, refs
    free_card()
    return {"rows_per_tenant": SV_ROWS, "tenants": SV_TENANTS, "query_bytes": cost,
            "generate_s": gen_s, "register_s": register_s, "first_query_s": first_s,
            "plan_dispatches": plan_dispatches, "cells": cells}


def matview_chunk(rng, rows: int) -> dict:
    """The reference's matview bench rows: 512 STRING keys, int64 v and
    integer-valued f32 w (a view's host fold then adds exactly)."""
    vocab = np.array([f"h{i:03d}" for i in range(MV_KEYS)], object)
    return {
        "k": vocab[rng.integers(0, MV_KEYS, rows)],
        "v": rng.integers(0, 1_000_000, rows).astype(np.int64),
        "w": rng.integers(0, 64, rows).astype(np.float32),
    }


def matview_plans(tab) -> list:
    return [tab.group_by("k", {"s": ("sum", "v")}),
            tab.group_by("k", {"c": ("count", None), "m": ("mean", "w")})]


def matview_mode(mode: str, base: dict, other: dict, chunks: list, card: str) -> dict:
    """The reference's matview bench cell: a hot tenant whose table
    takes MV_APPENDS appends while MV_READERS readers read its two
    plans, and an unrelated tenant's cached plan read by
    MV_OTHER_READERS readers.  ``views``: the hot plans are views
    (max_staleness_s=0.05); ``recompute``: every read after an append
    recomputes; ``epoch``: each append also bumps both tenants' epochs."""
    import threading

    from dryad_tpu_torch import DryadConfig, DryadContext
    from dryad_tpu_torch.serve import QueryService

    final_rows = MV_ROWS + MV_APPENDS * MV_APPEND_ROWS
    cost = sum(a.nbytes for a in base.values()) * final_rows // MV_ROWS
    ctx = DryadContext(num_partitions_=P, config=DryadConfig(
        device_cache_bytes=SV_DEVICE_CACHE, obs_events_mem_cap=0,
        serve_result_cache_bytes=SV_CACHE_BYTES, serve_max_bytes=MV_READERS * cost))
    free_card()
    torch.cuda.reset_peak_memory_stats()
    svc = QueryService(ctx)
    hot = svc.session("hot")
    hot_t = hot.ingest(dict(base))
    hot_plans = matview_plans(hot_t)
    oth = svc.session("other")
    other_q = oth.ingest(dict(other)).group_by("k", {"s": ("sum", "v")})
    t0 = time.perf_counter()
    if mode == "views":
        for q in hot_plans:
            hot.register_view(q, max_staleness_s=MV_STALENESS_S)
    register_s = time.perf_counter() - t0
    for q in hot_plans:
        hot.run(q, timeout=600)
    oth.run(other_q, timeout=600)
    errors, append_s = [], []

    def writer():
        try:
            for ch in chunks:
                t = time.perf_counter()
                hot.append(hot_t, ch)
                if mode == "epoch":
                    hot.bump_epoch()
                    oth.bump_epoch()
                append_s.append(time.perf_counter() - t)
                time.sleep(0.02)
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(repr(e))

    def reader(i, sess, q, counts):
        try:
            for _ in range(MV_READS):
                sess.run(q, timeout=600)
                counts[i] += 1
        except BaseException as e:  # noqa: BLE001
            errors.append(repr(e))

    hot_counts, oth_counts = [0] * MV_READERS, [0] * MV_OTHER_READERS
    ths = [threading.Thread(target=writer)]
    ths += [threading.Thread(target=reader, args=(i, hot, hot_plans[i % 2], hot_counts))
            for i in range(MV_READERS)]
    ths += [threading.Thread(target=reader, args=(i, oth, other_q, oth_counts))
            for i in range(MV_OTHER_READERS)]
    with DeviceBusy() as busy:
        t_start = time.perf_counter()
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        elapsed = time.perf_counter() - t_start
    check(not errors, f"matview {mode}: {errors[:1]}")
    time.sleep(2 * MV_STALENESS_S)  # past the staleness bound: the next read is fresh
    final = [hot.run(q, timeout=600) for q in hot_plans]
    stats = svc.stats()
    evs = ctx.events.events()
    svc.close()
    peak = card_peak()
    snaps = [e for e in evs if e["kind"] == "view_snapshot"]
    fresh_stal = [e["staleness_s"] for e in snaps if e["fresh"]]
    check(all(s <= MV_STALENESS_S for s in fresh_stal),
          f"matview {mode}: a fresh snapshot was {max(fresh_stal, default=0):.4f} s stale")
    o = stats["tenants"]["other"]
    if mode != "epoch":
        check(o["cache_hits"] == MV_OTHER_READERS * MV_READS,
              f"matview {mode}: the unrelated tenant's entry was invalidated "
              f"({o['cache_hits']} hits of {MV_OTHER_READERS * MV_READS} reads)")
    del ctx, svc, hot_t, hot_plans, other_q
    free_card()
    # the oracle: a new context over every row, the plans run directly
    rows = {c: np.concatenate([base[c]] + [ch[c] for ch in chunks]) for c in base}
    fresh = DryadContext(num_partitions_=P, config=DryadConfig(device_cache_bytes=SV_DEVICE_CACHE))
    tab = fresh.from_arrays(rows)
    for q, got in zip(matview_plans(tab), final):
        _byte_equal(got, fresh.run_to_host(q), f"matview {mode}: a read after the writer stopped")
    del fresh, tab, rows
    free_card()
    views = stats["views"]
    hot_reads = sum(hot_counts)
    res = {
        "mode": mode, "seconds": elapsed, "hot_reads": hot_reads,
        "reads_per_s": hot_reads / elapsed, "rows_per_s": hot_reads * final_rows / elapsed,
        "dispatches": stats["dispatches"],
        "unrelated_hit_rate": o["cache_hits"] / max(o["completed"], 1),
        "staleness_p95_ms": 1e3 * _pct([e["staleness_s"] for e in snaps], 0.95) if snaps else 0.0,
        "fresh_staleness_max_ms": 1e3 * max(fresh_stal, default=0.0),
        "delta_fold_bytes": views["delta_bytes"], "snapshots_fresh": views["snapshots_fresh"],
        "snapshots_finalized": views["snapshots_finalized"], "register_s": register_s,
        "append_s": append_s, "device_idle": busy.idle, "peak_bytes": peak, "card": card,
    }
    log(f"matview {mode} [{card}]: {hot_reads} hot reads in {elapsed:.3f} s = "
        f"{res['reads_per_s']:.2f} reads/s during {len(chunks)} appends of {MV_APPEND_ROWS} rows "
        f"(append {min(append_s):.3f}-{max(append_s):.3f} s); {stats['dispatches']} dispatches; "
        f"unrelated tenant hit rate {res['unrelated_hit_rate']:.3f}; staleness p95 "
        f"{res['staleness_p95_ms']:.2f} ms (fresh max {res['fresh_staleness_max_ms']:.2f} ms); "
        f"delta-fold bytes {views['delta_bytes']}; snapshots fresh {views['snapshots_fresh']}, "
        f"finalized {views['snapshots_finalized']}; device idle {busy.idle:.3f}; reads after "
        f"the writer equal a full recompute over {final_rows} rows")
    return res


def serve_matviews(card: str) -> dict:
    rng = np.random.default_rng(SEED + 12)
    base = matview_chunk(rng, MV_ROWS)
    other = matview_chunk(rng, MV_ROWS)
    chunks = [matview_chunk(rng, MV_APPEND_ROWS) for _ in range(MV_APPENDS)]
    res = {m: matview_mode(m, base, other, chunks, card) for m in MV_MODES}
    res["views_speedup"] = res["views"]["reads_per_s"] / res["recompute"]["reads_per_s"]
    log(f"matview [{card}]: views {res['views_speedup']:.2f}x the reads/s of recompute")
    return res


CK_ROWS = 1 << 23  # groupby_sort's 2^26 (cut to 2^25, 2^24, then 2^23 for the run's time limit; PERF.md section 4)


def serve_checkpoints(card: str) -> dict:
    """The groupby_sort phase's query (CK_ROWS rows, 2^22 keys) with stage
    checkpoints: a cold run writes them, a new context on the directory
    resumes (byte-equal, no stage dispatched), and with one column file
    corrupted a third context logs checkpoint_corrupt, recomputes and
    gives the same bytes."""
    import shutil

    from dryad_tpu_torch import DryadConfig, DryadContext

    root = os.path.join(WORK_DIR, "ckpt")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    free = shutil.disk_usage(root).free
    if free < CK_FREE_BYTES:
        raise RuntimeError(f"the checkpoint part needs {CK_FREE_BYTES / 2**30:.0f} GiB free under "
                           f"{root}; {free / 2**30:.1f} GiB free")
    t = groupby_table(np.random.default_rng(SEED + 6), CK_ROWS, GB_KEYS)

    def run():
        ctx = DryadContext(num_partitions_=P, config=DryadConfig(checkpoint_dir=root))
        t0 = time.perf_counter()
        out = ctx.from_arrays(t).group_by("key", GB_AGGS).collect()
        secs = time.perf_counter() - t0
        evs = ctx.events.events()
        del ctx
        free_card()
        kinds = [e["kind"] for e in evs]
        io_s = sum(e["dur"] for e in evs if e["kind"] == "span" and e["cat"] == "checkpoint")
        return out, secs, kinds, io_s

    try:
        cold, cold_s, kinds, save_s = run()
        saved = kinds.count("stage_checkpoint_saved")
        check(saved >= 1, "the cold run saved no checkpoint")
        nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
        uniq, cnt = np.unique(t["key"], return_counts=True)
        order = np.argsort(cold["key"])
        check(np.array_equal(cold["key"][order], uniq) and
              np.array_equal(cold["c"][order], cnt.astype(np.int32)),
              "checkpointed group_by: keys or counts differ from numpy")
        resumed, resume_s, kinds, load_s = run()
        _byte_equal(resumed, cold, "the resumed group_by")
        check(kinds.count("stage_start") == 0 and kinds.count("stage_checkpoint_hit") == saved,
              f"the resume dispatched {kinds.count('stage_start')} stages")
        files = sorted((os.path.getsize(os.path.join(d, f)), os.path.join(d, f))
                       for d, _, fs in os.walk(root) for f in fs if f.endswith(".dpf"))
        path = files[-1][1]
        with open(path, "r+b") as fh:
            head = fh.readline()
            fh.seek(len(head) + 12345)
            b = fh.read(1)
            fh.seek(len(head) + 12345)
            fh.write(bytes([b[0] ^ 0xFF]))
        again, again_s, kinds, _ = run()
        _byte_equal(again, cold, "the group_by after a corrupted checkpoint")
        check("checkpoint_corrupt" in kinds and kinds.count("stage_start") >= 1,
              "a corrupted checkpoint was not detected and recomputed")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res = {"rows": CK_ROWS, "keys": GB_KEYS, "checkpoints": saved, "bytes": nbytes,
           "cold_s": cold_s, "save_s": save_s, "resume_s": resume_s, "load_s": load_s,
           "corrupt_rerun_s": again_s, "card": card}
    log(f"checkpoints [{card}]: group_by of {CK_ROWS} rows, {GB_KEYS} keys: cold run {cold_s:.3f} s "
        f"with {saved} checkpoints written ({nbytes / 1e9:.3f} GB, save {save_s:.3f} s); resume in a "
        f"new context {resume_s:.3f} s (load {load_s:.3f} s), byte-equal, no stage dispatched; a "
        f"corrupted column file recomputed in {again_s:.3f} s, byte-equal")
    return res


def phase_serve(dev, card: str) -> dict:
    """Many tenants served from one resident engine at P=8: the serve
    bench's cells, materialized views under continuous ingest, and stage
    checkpoints.  The bucket kernel's launches are counted from 0 at the
    phase start; the inputs of its first launch at each shape are kept
    and the kernel is held against its plain version on each."""
    from dryad_tpu_torch.ops.bucket import bucket_sum_count

    t_phase = time.perf_counter()
    bucket_sum_count.launches = 0  # the serve path starts here
    with LaunchRecorder() as rec:
        res = {"tenants": serve_tenants(card)}
        res["matview"] = serve_matviews(card)
        res["checkpoint"] = serve_checkpoints(card)
    launches = bucket_sum_count.launches
    check(launches >= 1 and launches == rec.launched(),
          f"the serve path launched the bucket kernel {launches} times, its calls and replays "
          f"{rec.launched()}")
    shapes = []
    for (m, K, _), (keys, vals, valid) in sorted(rec.first.items()):
        shapes.append(kernel_shape_report(keys, vals, valid, K))
        log(f"kernel vs plain at a serve shape ({shapes[-1]['shape']}): byte-equal; kernel "
            f"{shapes[-1]['kernel_ms']:.3f} ms, plain {shapes[-1]['plain_ms']:.3f} ms, "
            f"{shapes[-1]['library']} {shapes[-1]['library_ms']:.3f} ms, bound "
            f"{shapes[-1]['bound_ms']:.4f} ms")
    rec.first.clear()
    free_card()
    res.update(launches=launches, kernel_shapes=shapes, phase_s=time.perf_counter() - t_phase)
    log(f"serve phase [{card}]: {res['phase_s']:.1f} s, bucket kernel launches {launches} "
        f"at {len(shapes)} shapes")
    return res


# -- phase 17: vertex tasks over worker processes sharing the card ------------

CL_WORKERS = 4
CL_DEVICE = "cuda"  # where the workers run their vertices
CL_NPARTS = 16
CL_DELAY_S = 20.0
CL_KILL_AFTER_S = 3.0
# the cluster's WordCount corpus and coded group_by (cut from 2^26 words
# and 2^26 rows; the corpus from 2^25 too) and its stage-chaos table: cut
# for the run's time limit
CL_WORDS = 1 << 24
CL_DENSE_ROWS = 1 << 24  # the coded group_by (cut from 2^25 for the run's time limit; PERF.md section 4)
CL_CHAOS_ROWS = 1 << 23  # the sort-path group_by of GB_KEYS keys (cut from GB_ROWS, then 2^24)
CL_DENSE_K = 65536
CL_CHAOS = dict(seed=0, stage_failure_prob=0.3)
CL_CHAOS_RUNS = 8  # the seeded plan's 4th draw fails: at most this many runs to see it


def _since(sub, mark: int, kind=None) -> list:
    return [e for e in sub.events.events()[mark:] if kind is None or e["kind"] == kind]


def _kinds(sub, mark: int) -> list:
    return [e["kind"] for e in _since(sub, mark)]


def worker_launches(sub, mark: int) -> int:
    """Bucket-kernel launches the workers made since event ``mark``: each
    worker counts its own and ships the new ones as a ``metrics`` event
    (counter ``kernel_launches``) with the telemetry of every command."""
    return int(sum(
        c["value"] for e in _since(sub, mark, "metrics") for c in e.get("counters", ())
        if c["name"] == "kernel_launches" and c["labels"].get("kernel") == "bucket_sum_count"))


def _sorted_by(t: dict, key: str) -> dict:
    order = np.argsort(t[key], kind="stable")
    return {c: np.asarray(v)[order] for c, v in t.items()}


def _package(sub, mark: int, kind: str) -> str:
    """The job package of the job that logged ``kind`` (with its ``seq``)
    since ``mark``, under the submission's root."""
    seq = _since(sub, mark, kind)[-1]["seq"]
    return os.path.join(sub.root, sub.job_id, f"r{seq}", "job.pkg")


def vertex_shape(pkg_path: str, dev) -> tuple:
    """The inputs of the bucket kernel's first launch in vertex 0 of a
    job: its package loaded into a one-partition context on the card and
    run over input partition 0 of ``CL_NPARTS``, as a worker runs it."""
    from dryad_tpu_torch.exec.jobpackage import load_query, slice_binding

    q = load_query(pkg_path, device=dev, num_partitions=1)
    for nid, b in list(q.ctx._bindings.items()):
        q.ctx._bindings[nid] = slice_binding(b, 0, CL_NPARTS)
    with LaunchRecorder() as rec:
        q.ctx.execute(q)
    check(len(rec.first) == 1, f"a vertex ran the kernel at {len(rec.first)} shapes, expected 1")
    ((_m, K, _cap), inputs), = rec.first.items()
    return inputs, K


def _wait_for_workers(sub, n: int, timeout: float = 300.0) -> dict:
    deadline = time.monotonic() + timeout
    while True:
        devs = sub.worker_devices()
        if len(devs) >= n:
            return devs
        check(time.monotonic() < deadline, f"only {len(devs)}/{n} workers announced")
        time.sleep(0.05)


def phase_cluster(dev, card: str) -> dict:
    """Independent vertex tasks (``LocalJobSubmission.submit_partitioned``)
    on 4 worker processes sharing the card, each with its own CUDA
    context: WordCount as 16 vertex tasks (duplicate path), the same job
    with a 20 s straggler (speculative duplication) and with a worker
    killed mid-job (re-execution), an int auto-dense group_by as coded
    k-of-n partials, clean and after seeded kills of 2 workers (parity
    reconstructs, nothing re-executes), then seeded stage chaos in one
    context (versioned re-execution).  The bucket kernel's launches are
    the workers' own, shipped with their telemetry; the kernel is held
    against its plain version at each vertex shape."""
    import shutil
    import threading

    from dryad_tpu_torch import DryadConfig, DryadContext
    from dryad_tpu_torch.cluster.localjob import LocalJobSubmission
    from dryad_tpu_torch.exec import faults
    from dryad_tpu_torch.exec.failure import JobFailedError

    free_card()
    t_phase = time.perf_counter()
    res = {"card": card, "workers": CL_WORKERS, "nparts": CL_NPARTS}
    root = os.path.join(WORK_DIR, "cluster")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    # WordCount's input: CL_WORDS of the wordcount phase's Zipf words
    rng = np.random.default_rng(SEED + 2)
    ids = zipf_ids(rng, CL_WORDS)
    tab = vocab_table()
    words = np.array([bytes(r).split()[0].decode() for r in tab], object)
    uid, ucnt = np.unique(ids, return_counts=True)
    oracle = dict(zip(words[uid].tolist(), ucnt.tolist()))
    text = os.path.join(root, "words.txt")
    with open(text, "wb") as fh:
        fh.write(tab[ids].tobytes())
    wctx = DryadContext(num_partitions_=1)
    wq = wctx.from_text(text).group_by("word", {"n": ("count", None)})
    os.remove(text)
    del ids

    with DeviceBusy() as busy:
        t0 = time.perf_counter()
        sub = LocalJobSubmission(num_workers=CL_WORKERS, root=os.path.join(root, "job"),
                                 device=CL_DEVICE)
        try:
            devs = _wait_for_workers(sub, CL_WORKERS)
            res["workers_start_s"] = time.perf_counter() - t0
            check(all(d.get("device", "").startswith(CL_DEVICE) and "device_error" not in d
                      for d in devs.values()), f"a worker is not on the card: {devs}")
            res["worker_devices"] = {str(i): d.get("device_name") for i, d in sorted(devs.items())}
            log(f"cluster: {CL_WORKERS} workers on the card in {res['workers_start_s']:.2f} s: "
                f"{sorted(set(res['worker_devices'].values()))}")
            mark0 = len(sub.events.events())  # the cluster path starts here

            # 1. WordCount as vertex tasks (the duplicate path: a STRING key)
            mark = len(sub.events.events())
            t0 = time.perf_counter()
            out1 = sub.submit_partitioned(wq, nparts=CL_NPARTS)
            wc_s = time.perf_counter() - t0
            kinds = _kinds(sub, mark)
            check("coded_fallback" in kinds and "coded_job_start" not in kinds,
                  "WordCount did not fall back from the coded path")
            got = dict(zip(out1["word"].tolist(), out1["n"].tolist()))
            check(got == oracle, "cluster WordCount differs from the numpy oracle")
            pkg = _package(sub, mark, "vertex_job_start")
            spans = [e for e in _since(sub, mark, "span") if e.get("name") == "fetch_package"]
            fetch = sorted(e["dur"] for e in spans)
            (asm,) = _since(sub, mark, "assemble_fetch")
            res["wordcount"] = {
                "job_s": wc_s, "package_bytes": os.path.getsize(pkg), "fetch_s": fetch,
                "assemble_wire_bytes": asm["wire_bytes"], "assemble_raw_bytes": asm["raw_bytes"],
                "launches": worker_launches(sub, mark),
            }
            # one fetch a worker that ran a task (the package is cached a
            # worker and job): every worker that completed a vertex shipped
            # its fetch before its status, and a worker whose only task lost
            # to a duplicate ships it as the fetch ends (cluster/worker.py)
            by_worker = {}
            for e in spans:
                by_worker[e.get("worker")] = by_worker.get(e.get("worker"), 0) + 1
            won = {int(e["computer"].removeprefix("worker"))
                   for e in _since(sub, mark, "vertex_complete")}
            res["wordcount"]["fetches_by_worker"] = by_worker
            check(all(by_worker.get(w) == 1 for w in won) and set(by_worker) <= set(range(CL_WORKERS))
                  and all(n == 1 for n in by_worker.values()),
                  f"package fetches by worker {by_worker}; the workers that completed a vertex {won}")
            log(f"cluster WordCount [{card}]: {len(oracle)} words equal the oracle; job "
                f"{wc_s:.2f} s; package {res['wordcount']['package_bytes'] / 2**30:.2f} GiB, "
                f"fetched in {', '.join(f'{x:.2f}' for x in fetch)} s; assembly "
                f"{asm['wire_bytes']} wire bytes ({asm['raw_bytes']} raw); "
                f"{res['wordcount']['launches']} kernel launches in the workers")
            wc_inputs, wc_K = vertex_shape(pkg, dev)
            # each worker's own resource sampler reads the card device-wide
            # (its job contexts' resource_sample events ship with its
            # telemetry): the card's total, and the headroom all four
            # processes leave
            total = torch.cuda.mem_get_info(dev)[1]
            ran = {int(e["computer"][6:]) for e in _since(sub, mark, "vertex_complete")}
            heads = {e["worker"]: e for e in _since(sub, mark, "resource_sample")
                     if "worker" in e and e["source"] == "device"}
            check(ran and ran <= set(heads), f"device samples from workers {sorted(heads)}, "
                  f"vertices ran on {sorted(ran)}")
            for w, e in sorted(heads.items()):
                check(e["hbm_limit_bytes"] == total and 0 < e["hbm_headroom_bytes"] <= total,
                      f"worker {w}'s sample {e} against the card's {total} bytes")
            res["wordcount"]["worker_headroom_bytes"] = {
                str(w): e["hbm_headroom_bytes"] for w, e in sorted(heads.items())}
            log(f"cluster WordCount: each worker's last headroom reading (GB of "
                f"{total / 1e9:.2f}): " + ", ".join(
                    f"worker{w} {e['hbm_headroom_bytes'] / 1e9:.2f}" for w, e in sorted(heads.items())))

            # 2. a straggler: speculative duplication
            sub.inject_delay(worker=1, seconds=CL_DELAY_S, count=1)
            mark = len(sub.events.events())
            t0 = time.perf_counter()
            out2 = sub.submit_partitioned(wq, nparts=CL_NPARTS)
            s2 = time.perf_counter() - t0
            kinds = _kinds(sub, mark)
            check("vertex_duplicate" in kinds and "vertex_duplicate_win" in kinds,
                  "the straggler was not duplicated")
            # without the duplicate the job would take the clean job's
            # time plus the delay (each job fetches its package anew, 8-14
            # s a worker on the card): the straggler may cost under half
            # its delay, and the job ends inside the delay
            check(s2 < wc_s + CL_DELAY_S / 2 and s2 < CL_DELAY_S,
                  f"the straggling job took {s2:.2f} s, the clean one {wc_s:.2f} s, "
                  f"under a {CL_DELAY_S} s delay")
            check(digest(out2) == digest(out1), "straggler WordCount differs from step 1's")
            res["straggler"] = {"job_s": s2, "duplicates": kinds.count("vertex_duplicate"),
                                "launches": worker_launches(sub, mark)}
            log(f"cluster straggler: job {s2:.2f} s under a {CL_DELAY_S:.0f} s delay (step 1 "
                f"{wc_s:.2f} s), {kinds.count('vertex_duplicate')} duplicate(s), bytes equal "
                f"step 1's")
            # the stalled worker still sleeps: replace it, so step 3 starts with four
            sub.launcher.stop(sub._handles[1])
            t0 = time.perf_counter()
            sub.start_worker(1)
            _wait_for_workers(sub, CL_WORKERS)
            restarts = [time.perf_counter() - t0]

            # 3. a worker killed mid-job: re-execution on the survivors
            sub.inject_delay(worker=1, seconds=600.0, count=1)
            mark = len(sub.events.events())
            killer = threading.Timer(CL_KILL_AFTER_S, lambda: sub._handles[1].kill())
            killer.start()
            t0 = time.perf_counter()
            try:
                out3 = sub.submit_partitioned(wq, nparts=CL_NPARTS, speculation=False)
            finally:
                killer.join()
            s3 = time.perf_counter() - t0
            kinds = _kinds(sub, mark)
            check("worker_dead" in kinds and "vertex_retry" in kinds,
                  "the dead worker's vertex was not re-executed")
            check(digest(out3) == digest(out1), "dead-worker WordCount differs from step 1's")
            res["dead_worker"] = {"job_s": s3, "retries": kinds.count("vertex_retry"),
                                  "launches": worker_launches(sub, mark)}
            log(f"cluster dead worker: job {s3:.2f} s, {kinds.count('vertex_retry')} vertex "
                f"retries, bytes equal step 1's")
            t0 = time.perf_counter()
            sub.start_worker(1)
            _wait_for_workers(sub, CL_WORKERS)
            restarts.append(time.perf_counter() - t0)
            del out2, out3, wctx, wq

            # 4. coded partials: an int auto-dense group_by, then seeded kills
            rng = np.random.default_rng(SEED + 31)
            ct = {"k": rng.integers(0, CL_DENSE_K, CL_DENSE_ROWS, dtype=np.int32),
                  "v": rng.integers(-1000, 1000, CL_DENSE_ROWS, dtype=np.int32)}
            aggs = {"c": ("count", None), "s": ("sum", "v")}
            cq = DryadContext(num_partitions_=1).from_arrays(ct).group_by("k", aggs)
            mark = len(sub.events.events())
            t0 = time.perf_counter()
            outa = sub.submit_partitioned(cq, nparts=CL_NPARTS)
            sa = time.perf_counter() - t0
            check("coded_job_start" in _kinds(sub, mark), "the int group_by did not run coded")
            coded_pkg = _package(sub, mark, "coded_job_start")
            launches_a = worker_launches(sub, mark)
            one = DryadContext(num_partitions_=P)
            ref = one.from_arrays(ct).group_by("k", aggs).collect()
            del one
            check(digest(_sorted_by(outa, "k")) == digest(_sorted_by(ref, "k")),
                  "coded group_by differs from one context's collect")
            sub.inject_fault(None, plan={"seed": 7, "worker_kill_prob": 1.0,
                                         "max_worker_kills": 1}, workers=[1, 2])
            mark = len(sub.events.events())
            t0 = time.perf_counter()
            outb = sub.submit_partitioned(cq, nparts=CL_NPARTS)
            sb = time.perf_counter() - t0
            kinds = _kinds(sub, mark)
            check(digest(outb) == digest(outa), "coded group_by after two kills differs")
            check(kinds.count("coded_retry") == 0 and kinds.count("vertex_retry") == 0,
                  "a killed coded vertex was re-executed")
            rec = _since(sub, mark, "coded_reconstruct")[-1]
            check(rec["exact"] is True, "the coded reconstruction was not exact")
            check(kinds.count("worker_dead") == 2, f"{kinds.count('worker_dead')} workers died, expected 2")
            res["coded"] = {
                "rows": CL_DENSE_ROWS, "keys": CL_DENSE_K, "job_s": sa, "killed_job_s": sb,
                "parity_used": rec["parity_used"], "amplification": rec["amplification"],
                "launches": launches_a + worker_launches(sub, mark),
            }
            log(f"cluster coded group_by [{card}]: {CL_DENSE_ROWS} rows in {sa:.2f} s, equal to "
                f"one context's collect; after 2 seeded kills {sb:.2f} s, byte-equal, "
                f"{rec['parity_used']} parity partials used, exact, no re-execution")
            dense_inputs, dense_K = vertex_shape(coded_pkg, dev)
            t0 = time.perf_counter()
            for i in (1, 2):  # both replacements start at once
                sub.start_worker(i)
            _wait_for_workers(sub, CL_WORKERS)
            restarts.append(time.perf_counter() - t0)
            res["worker_restart_s"] = restarts
            res["launches"] = worker_launches(sub, mark0)
            check(res["launches"] >= 1, "the workers launched no bucket kernel")
            del outa, outb, ref, ct, cq
        finally:
            sub.shutdown()

        # 5. seeded stage chaos in one context: versioned re-execution
        rng = np.random.default_rng(SEED + 6)
        t = groupby_table(rng, CL_CHAOS_ROWS, GB_KEYS)
        ctx = DryadContext(num_partitions_=P, config=DryadConfig(
            max_stage_failures=4, retry_backoff_base=0.002))
        q = ctx.from_arrays(t).group_by("key", GB_AGGS)
        clean = q.collect()
        failed = runs = 0
        faults.install_plan(faults.FaultPlan(**CL_CHAOS))
        try:
            while not failed and runs < CL_CHAOS_RUNS:
                runs += 1
                mark = len(ctx.events.events())
                check(digest(q.collect()) == digest(clean), "stage chaos group_by differs from a clean run")
                failed = sum(1 for e in ctx.events.events()[mark:] if e["kind"] == "stage_failed")
        finally:
            faults.clear_faults()
        check(failed >= 1, f"the seeded plan failed no stage in {runs} runs")
        faults.set_fake_stage_failure("group_by", -1)
        try:
            q.collect()
            check(False, "a deterministic stage failure did not fail the job")
        except JobFailedError as e:
            check(len(e.attempts) == 2 and e.attempts[-1].kind == "deterministic",
                  f"deterministic failure history {e.attempts}")
        finally:
            faults.clear_faults()
        res["chaos"] = {"runs": runs, "stage_failed": failed}
        log(f"cluster stage chaos: {failed} injected stage failure(s) in {runs} runs of the "
            f"{CL_CHAOS_ROWS}-row group_by under FaultPlan({CL_CHAOS}), each byte-equal to the clean run; "
            f"a deterministic failure raised JobFailedError after 2 attempts")
        del ctx, q, clean, t

    res.update(device_idle=busy.idle, device_busy_s=busy.busy_s, wall_s=busy.wall_s)
    shapes = []
    for (keys, vals, valid), K in ((wc_inputs, wc_K), (dense_inputs, dense_K)):
        shapes.append(kernel_shape_report(keys, vals, valid, K))
        log(f"kernel vs plain at a vertex shape ({shapes[-1]['shape']}): byte-equal; kernel "
            f"{shapes[-1]['kernel_ms']:.3f} ms, plain {shapes[-1]['plain_ms']:.3f} ms, "
            f"{shapes[-1]['library']} {shapes[-1]['library_ms']:.3f} ms, bound "
            f"{shapes[-1]['bound_ms']:.4f} ms")
    shutil.rmtree(root, ignore_errors=True)
    free_card()
    res.update(kernel_shapes=shapes, phase_s=time.perf_counter() - t_phase)
    log(f"cluster phase [{card}]: {res['phase_s']:.1f} s (workers start "
        f"{res['workers_start_s']:.2f} s, restarts {', '.join(f'{x:.2f}' for x in restarts)} s); "
        f"{res['launches']} bucket kernel launches in the workers; card idle "
        f"{busy.idle:.3f} of {busy.wall_s:.1f} s (NVML, every process)")
    return res


# -- phase 18: runtime plan rewriting at the default config ---------------------

RW_SORT_ROWS = 1 << 26
RW_SORT_CHUNK = 1 << 24  # four chunks: the first uniform in [0, 2^20), the rest in [0, 2^14)
RW_JOIN_LEFT = 1 << 25
RW_JOIN_RIGHT = 1 << 23
RW_JOIN_CHUNK = 1 << 23
RW_JOIN_HOT = 0.01  # the left's later chunks fall on this share of the keys
RW_GB_ROWS = 1 << 26
RW_GB_CHUNK = 1 << 21
RW_GB_KEYS = 1 << 20  # the thrashing stream's int64 keys
RW_DENSE_KEYS = 1 << 16  # the flipped stream's int32 keys: auto-dense, on the bucket kernel
RW_OV_ROWS = 1 << 25  # the pre-widened group_by (cut from 2^26)
RW_OV_RUNS = 4
RW_FREE_BYTES = 10 << 30


def _rw_ctx(spill_root: str, rewrite: bool, **cfg):
    """A context on the default config (the diagnosis engine and the plan
    rewriter on) or with ``plan_rewrite=False``, spilling under
    ``spill_root`` and keeping every event in memory."""
    from dryad_tpu_torch import DryadConfig, DryadContext

    if rewrite:
        check(DryadConfig().plan_rewrite and DryadConfig().obs_diagnosis,
              "the rewriter is not on by default")
    else:
        cfg["plan_rewrite"] = False
    ctx = DryadContext(num_partitions_=P, config=DryadConfig(
        stream_spill_dir=spill_root, obs_events_mem_cap=0, **cfg))
    check((ctx.rewriter is not None) == rewrite and ctx.diagnosis is not None,
          "the context's diagnosis engine or rewriter is not wired as configured")
    return ctx


def _rewrites(ctx, action: str, phase: str, mark: int = 0) -> list:
    return [e for e in ctx.events.events()[mark:] if e["kind"] == "plan_rewrite"
            and e["action"] == action and e["phase"] == phase]


def _rw_run(label: str, ctx, build, card: str) -> tuple:
    """``build(ctx).collect()`` timed, with its peak device memory."""
    free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = build(ctx).collect()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = card_peak()
    log(f"rewrite {label} [{card}]: {secs:.3f} s, peak device memory (allocated + graph pool) {peak / 1e9:.3f} GB")
    return out, secs, peak


def rw_sort_chunks(seed: int):
    """The drift fixture of tests/test_rewrite_differential.py at size:
    the splitters sample a chunk uniform in [0, 2^20); the later chunks
    fall in [0, 2^14), all inside the static partition's lowest bucket."""
    rng = np.random.default_rng(seed)
    for i in range(RW_SORT_ROWS // RW_SORT_CHUNK):
        hi = 1 << 20 if i == 0 else 1 << 14
        yield {"x": rng.integers(0, hi, RW_SORT_CHUNK).astype(np.int64),
               "v": rng.random(RW_SORT_CHUNK, dtype=np.float32)}


def rewrite_sort(spill_root: str, card: str) -> dict:
    """order_by(["x", "v"]) over the drift stream, rewriter on and off:
    the hot bucket splits mid-stream (decided, applied, a ``rewrite``
    split), and both runs equal numpy's sort byte for byte (x below
    2^20 and v in [0, 1) pack into one uint64 whose order is the rows')."""
    t0 = time.perf_counter()
    chunks = list(rw_sort_chunks(SEED + 41))
    packed = np.sort(np.concatenate([(c["x"].astype(np.uint64) << np.uint64(32))
                                     | c["v"].view(np.uint32).astype(np.uint64) for c in chunks]))
    res, outs = {"oracle_s": time.perf_counter() - t0}, {}
    for on in (True, False):
        ctx = _rw_ctx(spill_root, on)
        out, secs, peak = _rw_run(f"sort ({'on' if on else 'off'})", ctx, lambda c: c.from_stream(
            iter(chunks)).order_by(["x", "v"]), card)
        got = (out["x"].astype(np.uint64) << np.uint64(32)) | out["v"].view(np.uint32).astype(np.uint64)
        check(np.array_equal(got, packed), f"rewrite sort ({on}): rows differ from numpy's sort")
        del got
        splits = [e["mode"] for e in ctx.events.events() if e["kind"] == "stream_bucket_split"]
        res["on" if on else "off"] = {"seconds": secs, "peak_bytes": peak, "splits": splits}
        if on:
            dec, app = _rewrites(ctx, "split_bucket", "decided"), _rewrites(ctx, "split_bucket", "applied")
            check(dec and app and "rewrite" in splits,
                  f"rewrite sort: split_bucket decided {len(dec)}, applied {len(app)}, splits {splits}")
            res["on"].update(decided=len(dec), applied=len(app),
                             applied_at=[(e["depth"], e["bucket"], e.get("fan")) for e in app])
        else:
            check(not [e for e in ctx.events.events() if e["kind"] == "plan_rewrite"],
                  "rewrite sort: the rewriter-off run rewrote")
        outs[on] = out
        del ctx
    check(digest(outs[True]) == digest(outs[False]), "rewrite sort: on and off differ")
    log(f"rewrite sort [{card}]: {RW_SORT_ROWS} rows, split_bucket decided "
        f"{res['on']['decided']} applied {res['on']['applied']} at (depth, bucket, fan) "
        f"{res['on']['applied_at']}; splits on {res['on']['splits']}, off {res['off']['splits']}; "
        f"on {res['on']['seconds']:.2f} s, off {res['off']['seconds']:.2f} s; byte-equal to each "
        f"other and to numpy's sort (data and oracle {res['oracle_s']:.2f} s)")
    return res


def rw_join_tables(ctx) -> tuple:
    """Right: every page id in [0, 2^23) once, with b; left: 2^25 visits,
    the first chunk uniform over the pages, the later ones on the 1% of
    page ids whose salt-0 host hash falls in the stream driver's bucket
    0 (a skew its static hash partition does not spread)."""
    from dryad_tpu_torch.exec.outofcore import _host_hash_buckets

    rng = np.random.default_rng(SEED + 43)
    pages = np.arange(RW_JOIN_RIGHT, dtype=np.int64)
    bids = _host_hash_buckets({"k": pages}, ["k"], ctx.config.stream_buckets,
                              dictionary=ctx.dictionary)
    hot = pages[bids == 0][: int(RW_JOIN_RIGHT * RW_JOIN_HOT)]
    right = {"k": rng.permutation(pages), "b": rng.integers(0, 1 << 20, RW_JOIN_RIGHT).astype(np.int32)}
    left = []
    for i in range(RW_JOIN_LEFT // RW_JOIN_CHUNK):
        k = (rng.integers(0, RW_JOIN_RIGHT, RW_JOIN_CHUNK) if i == 0
             else hot[rng.integers(0, len(hot), RW_JOIN_CHUNK)]).astype(np.int64)
        left.append({"k": k, "a": rng.integers(0, 1 << 20, RW_JOIN_CHUNK).astype(np.int32)})
    return left, right, len(hot)


def _join_canonical(t: dict) -> np.ndarray:
    """The rows (k, a) packed and sorted; b rides along checked by key."""
    return np.sort((np.asarray(t["k"]).astype(np.int64) << 20) | np.asarray(t["a"]).astype(np.int64))


def rewrite_join(spill_root: str, card: str) -> dict:
    """The Grace join of a skewed visit stream with the page stream,
    rewriter on and off: the hot hash bucket re-hashes at salt 1
    mid-stream; both equal numpy as row multisets."""
    t0 = time.perf_counter()
    left, right, nhot = rw_join_tables(_rw_ctx(spill_root, False))
    half = RW_JOIN_RIGHT // 2
    rchunks = [{c: a[i:i + half] for c, a in right.items()} for i in (0, half)]
    b_of = np.empty(RW_JOIN_RIGHT, np.int32)
    b_of[right["k"]] = right["b"]
    want = _join_canonical({"k": np.concatenate([t["k"] for t in left]),
                            "a": np.concatenate([t["a"] for t in left])})
    res, canon = {"hot_keys": nhot, "oracle_s": time.perf_counter() - t0}, {}
    for on in (True, False):
        ctx = _rw_ctx(spill_root, on)
        out, secs, peak = _rw_run(f"join ({'on' if on else 'off'})", ctx, lambda c: c.from_stream(
            iter(left)).join(c.from_stream(iter(rchunks)), ["k"], ["k"]), card)
        check(len(out["k"]) == RW_JOIN_LEFT and np.array_equal(out["b"], b_of[out["k"]]),
              f"rewrite join ({on}): a row's b is not its page's")
        canon[on] = _join_canonical(out)
        check(np.array_equal(canon[on], want), f"rewrite join ({on}): rows differ from numpy's")
        del out
        splits = [e["mode"] for e in ctx.events.events() if e["kind"] == "stream_bucket_split"]
        res["on" if on else "off"] = {"seconds": secs, "peak_bytes": peak, "splits": splits}
        if on:
            app = _rewrites(ctx, "split_bucket", "applied")
            check(app and "rewrite" in splits, f"rewrite join: split_bucket applied {len(app)}, splits {splits}")
            res["on"].update(applied=len(app), decided=len(_rewrites(ctx, "split_bucket", "decided")))
        del ctx
    check(np.array_equal(canon[True], canon[False]), "rewrite join: on and off differ")
    log(f"rewrite join [{card}]: {RW_JOIN_LEFT} visits (later chunks on {nhot} page ids of hash "
        f"bucket 0) x {RW_JOIN_RIGHT} pages; split_bucket applied {res['on']['applied']}, splits on "
        f"{res['on']['splits']}, off {res['off']['splits']}; on {res['on']['seconds']:.2f} s, off "
        f"{res['off']['seconds']:.2f} s; equal to each other and to numpy as row multisets (data "
        f"and oracle {res['oracle_s']:.2f} s)")
    return res


def rw_group_chunks(seed: int, dense: bool):
    """2^26 rows in 2^21-row chunks: int64 keys over 2^20 (the flat
    combiner's layout rule then degrades and re-probes in turn: the
    reference's combine_thrash), or int32 keys over 2^16 (auto-dense)."""
    rng = np.random.default_rng(seed)
    for _ in range(RW_GB_ROWS // RW_GB_CHUNK):
        if dense:
            yield {"k": rng.integers(0, RW_DENSE_KEYS, RW_GB_CHUNK).astype(np.int32),
                   "v": rng.integers(-1000, 1000, RW_GB_CHUNK).astype(np.int32)}
        else:
            yield {"k": rng.integers(0, RW_GB_KEYS, RW_GB_CHUNK).astype(np.int64),
                   "v": rng.integers(0, 100, RW_GB_CHUNK).astype(np.int64)}


def _group_oracle(chunks: list, nk: int) -> tuple:
    """Per-key counts and integer sums of the stream, by numpy."""
    cnt = np.zeros(nk, np.int64)
    sums = np.zeros(nk, np.int64)
    for c in chunks:
        cnt += np.bincount(c["k"], minlength=nk)
        sums += np.bincount(c["k"], weights=c["v"].astype(np.float64), minlength=nk).astype(np.int64)
    return cnt, sums


def _check_group(out: dict, oracle: tuple, label: str) -> None:
    cnt, sums = oracle
    k = np.asarray(out["k"]).astype(np.int64)
    check(np.array_equal(np.sort(k), np.flatnonzero(cnt)), f"{label}: keys differ from numpy")
    check(np.array_equal(out["c"].astype(np.int64), cnt[k]), f"{label}: counts differ from numpy")
    check(np.array_equal(out["s"].astype(np.int64), sums[k]), f"{label}: sums differ from numpy")


def rewrite_combine(spill_root: str, card: str) -> tuple:
    """Two stream group_bys on the flat combiner (``combine_tree=False``,
    ``stream_host_reprobe=2``), rewriter on and off: A (sum, count,
    first; int64 keys) thrashes between the host and the device until
    the combine_thrash diagnosis pins it to the host mid-stream; B
    (sum, count; auto-dense int32 keys) then starts flipped to the
    combine tree.  Keys, counts and sums equal the rewriter-off run's and
    numpy's; A's ``first`` is a row of its key.  Returns the results and
    the bucket kernel's first inputs at B's shapes."""
    aggs_a = {"s": ("sum", "v"), "c": ("count", None), "f": ("first", "v")}
    aggs_b = {"s": ("sum", "v"), "c": ("count", None)}
    t0 = time.perf_counter()
    chunks_a = list(rw_group_chunks(SEED + 45, False))
    chunks_b = list(rw_group_chunks(SEED + 46, True))
    oracle_a, oracle_b = _group_oracle(chunks_a, RW_GB_KEYS), _group_oracle(chunks_b, RW_DENSE_KEYS)
    # (key, v) pairs present in A's stream: each key's "first" must be one
    seen = np.zeros((RW_GB_KEYS, 128), bool)
    for c in chunks_a:
        seen[c["k"], c["v"]] = True
    res, outs, rec_first = {"oracle_s": time.perf_counter() - t0}, {}, {}
    for on in (True, False):
        ctx = _rw_ctx(spill_root, on, combine_tree=False, stream_host_reprobe=2)
        tag = "on" if on else "off"
        a, sa, pa = _rw_run(f"combine A ({tag})", ctx, lambda c: c.from_stream(
            iter(chunks_a)).group_by("k", aggs_a), card)
        mark = len(ctx.events.events())
        with LaunchRecorder() as rec:
            b, sb, pb = _rw_run(f"combine B ({tag})", ctx, lambda c: c.from_stream(
                iter(chunks_b)).group_by("k", aggs_b), card)
        if on:
            rec_first = rec.first
        modes = [e["mode"] for e in ctx.events.events()[:mark] if e["kind"] == "stream_combine_policy"]
        thrash = [e for e in ctx.events.events() if e["kind"] == "diagnosis" and e["rule"] == "combine_thrash"]
        res[tag] = {"a_seconds": sa, "a_peak_bytes": pa, "b_seconds": sb, "b_peak_bytes": pb,
                    "a_modes": modes, "thrash_diagnoses": len(thrash), "b_kernel_calls": rec.calls}
        if on:
            pin = _rewrites(ctx, "pin_combine", "applied")
            flip = _rewrites(ctx, "flip_combine", "applied", mark)
            check(thrash and pin and pin[0]["mode"] == "host",
                  f"combine A: no pin (modes {modes}, {len(thrash)} thrash diagnoses)")
            check(flip and flip[0]["tree"] is True, "combine B: the combiner was not flipped to the tree")
            check(any(e["kind"] == "combine_tree_level" for e in ctx.events.events()[mark:]),
                  "combine B: the flipped stream ran no tree level")
            res[tag].update(pin_applied=len(pin), flip_applied=len(flip))
        else:
            check(not [e for e in ctx.events.events() if e["kind"] == "plan_rewrite"],
                  "combine: the rewriter-off runs rewrote")
        _check_group(a, oracle_a, f"combine A ({tag})")
        _check_group(b, oracle_b, f"combine B ({tag})")
        check(bool(seen[a["k"], a["f"]].all()), f"combine A ({tag}): a first is no row of its key")
        outs[on] = (_sorted_by(a, "k"), _sorted_by(b, "k"))
        del ctx, a, b
    # "first" names the first row in the engine's order, which the pin
    # changes (a host fold instead of a device merge), in the reference
    # as in the port: the count of keys whose pick moved is reported
    res["first_moved"] = int((outs[True][0]["f"] != outs[False][0]["f"]).sum())
    exact = ("k", "s", "c")
    check(digest({c: outs[True][0][c] for c in exact}) == digest({c: outs[False][0][c] for c in exact}),
          "combine A: on and off differ")
    check(digest(outs[True][1]) == digest(outs[False][1]), "combine B: on and off differ")
    log(f"rewrite combine [{card}]: A {RW_GB_ROWS} rows, modes {res['on']['a_modes']} then pinned "
        f"to the host ({res['on']['thrash_diagnoses']} thrash diagnosis); A on "
        f"{res['on']['a_seconds']:.2f} s, off {res['off']['a_seconds']:.2f} s; B flipped to the "
        f"tree, on {res['on']['b_seconds']:.2f} s, off {res['off']['b_seconds']:.2f} s; keys, counts and "
        f"sums equal to the off run and to numpy (A's first moved on {res['first_moved']} keys; data "
        f"and oracle {res['oracle_s']:.2f} s)")
    return res, rec_first


def rewrite_prewiden(card: str) -> dict:
    """A group_by whose exchange overflows on every run (slack 1.0 over
    RW_OV_ROWS distinct keys; the -1 keeps the int auto-dense rewrite off):
    after the overflow_loop diagnosis the next dispatch starts at the
    boost floor, with fewer retries, and the rows stay byte-equal."""
    from dryad_tpu_torch import DryadConfig, DryadContext

    rng = np.random.default_rng(SEED + 47)
    keys = (rng.permutation(RW_OV_ROWS) - 1).astype(np.int32)
    res = {}
    for on in (True, False):
        ctx = DryadContext(num_partitions_=P, config=DryadConfig(shuffle_slack=1.0, plan_rewrite=on))
        q = ctx.from_arrays({"k": keys}).group_by("k", {"c": ("count", None)})
        runs, digests = [], []
        for i in range(RW_OV_RUNS if on else 2):
            mark = len(ctx.events.events())
            t0 = time.perf_counter()
            out = q.collect()
            secs = time.perf_counter() - t0
            evs = ctx.events.events()[mark:]
            starts = [(e["name"], e["boost"]) for e in evs if e["kind"] == "stage_start"]
            over = [(e["name"], e["boost"]) for e in evs if e["kind"] == "stage_overflow"]
            runs.append({"seconds": secs, "starts": starts, "overflows": over})
            o = _sorted_by(out, "k")
            if not digests:
                check(np.array_equal(o["k"], np.arange(-1, RW_OV_ROWS - 1, dtype=np.int32))
                      and bool((o["c"] == 1).all()), "prewiden: rows differ from numpy")
            digests.append(digest(o))
            del out, o
        check(len(set(digests)) == 1, "prewiden: the runs' rows differ")
        check(runs[0]["overflows"], "prewiden: the first run did not overflow")
        res["on" if on else "off"] = runs
        if on:
            name = runs[0]["overflows"][0][0]
            app = _rewrites(ctx, "prewiden_palette", "applied")
            check(app and ctx.rewriter.boost_floor(name) >= 2, "prewiden: no boost floor was applied")
            first = next(b for n, b in runs[-1]["starts"] if n == name)
            check(first >= 2 and len(runs[-1]["overflows"]) < len(runs[0]["overflows"]),
                  f"prewiden: the last run started at boost {first} with {runs[-1]['overflows']}")
        del ctx, q
    on, off = res["on"], res["off"]
    log(f"rewrite prewiden [{card}]: {RW_OV_ROWS} rows; on: retries by run "
        f"{[len(r['overflows']) for r in on]}, seconds {[round(r['seconds'], 3) for r in on]}, last run "
        f"starts {on[-1]['starts']}; off: retries {[len(r['overflows']) for r in off]}, seconds "
        f"{[round(r['seconds'], 3) for r in off]}; every run byte-equal")
    return res


def phase_rewrite(dev, card: str) -> dict:
    """The runtime plan rewriter at the default config (one context on the
    card per run; its rewriter-off twin beside it): a drift sort whose
    hot range bucket splits mid-stream, a skewed Grace join whose hot
    hash bucket re-hashes, a thrashing streaming combine pinned to the
    host and the next stream flipped to the combine tree, and an
    overflowing group_by pre-widened.  The bucket kernel's launches are
    counted from 0 before the phase; it is held against its plain
    version at the flipped stream's shapes."""
    import shutil

    from dryad_tpu_torch.ops.bucket import bucket_sum_count

    t_phase = time.perf_counter()
    root = os.path.join(WORK_DIR, "rewrite")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    free = shutil.disk_usage(root).free
    if free < RW_FREE_BYTES:
        raise RuntimeError(f"rewrite phase needs {RW_FREE_BYTES / 2**30:.0f} GiB free under {root}; "
                           f"{free / 2**30:.1f} GiB free")
    spill_root = os.path.join(root, "spill")
    res = {"card": card}
    bucket_sum_count.launches = 0
    try:
        with DeviceBusy() as busy:
            res["sort"] = rewrite_sort(spill_root, card)
            res["join"] = rewrite_join(spill_root, card)
            res["combine"], shapes_in = rewrite_combine(spill_root, card)
            res["prewiden"] = rewrite_prewiden(card)
        res["launches"] = int(bucket_sum_count.launches)
        check(not os.listdir(spill_root), "the rewrite phase left spill directories behind")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(res["launches"] >= 1, "the rewrite phase launched no bucket kernel")
    shapes = []
    for (_m, K, _cap), (keys, vals, valid) in sorted(shapes_in.items()):
        shapes.append(kernel_shape_report(keys, vals, valid, K))
        log(f"kernel vs plain at a rewrite shape ({shapes[-1]['shape']}): byte-equal; kernel "
            f"{shapes[-1]['kernel_ms']:.3f} ms, plain {shapes[-1]['plain_ms']:.3f} ms, "
            f"{shapes[-1]['library']} {shapes[-1]['library_ms']:.3f} ms, bound "
            f"{shapes[-1]['bound_ms']:.4f} ms")
    free_card()
    res.update(kernel_shapes=shapes, device_idle=busy.idle, device_busy_s=busy.busy_s,
               phase_s=time.perf_counter() - t_phase)
    log(f"rewrite phase [{card}]: {res['phase_s']:.1f} s; {res['launches']} bucket kernel launches; "
        f"card idle {busy.idle:.3f} of {busy.wall_s:.1f} s")
    return res


# -- phase 19: the serving fleet -------------------------------------------------

FL_REPLICAS = 4
FL_ROWS = 1 << 20  # a tenant's table: each envelope carries it (PERF.md section 4)
FL_CLIENTS = 16
FL_PER_CLIENT = 6
FL_HB_S = 0.25
# a replica's heartbeat may stall for seconds while the front door moves
# the envelopes' tables (a 3 s timeout reaped a live replica on the card)
FL_STALE_S = 10.0
FL_DEVICE = None  # the replicas' DryadContext device (None: the card)
FL_KILL_QUERIES = 4

# A closed-loop fleet client: its own OS process speaking the mailbox
# HTTP wire with the stdlib alone (the reference bench's client); it
# reports each query's qid, plan, latency and header.
FLEET_CLIENT = r"""
import http.client, json, os, pickle, struct, sys, time

host, port, payload, tenant, tier = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
per_client, idx = int(sys.argv[6]), int(sys.argv[7])
with open(payload, "rb") as fh:
    items = pickle.load(fh)
conn = http.client.HTTPConnection(host, port, timeout=300)
nonce = os.urandom(6).hex()


def post(name, body):
    conn.request("POST", "/prop/fleet/" + name, body=body)
    r = conn.getresponse()
    r.read()
    assert r.status == 200, r.status


def poll(name, timeout):
    conn.request("GET", "/prop/fleet/%s?after=0&timeout=%s" % (name, timeout))
    r = conn.getresponse()
    body = r.read()
    return body if r.status == 200 else None


done = []
t_start = time.perf_counter()
for j in range(per_client):
    plan = (idx + j) % len(items)
    blob, fp = items[plan]
    qid = "%s-%s-%d" % (tenant, nonce, j)
    env = {"qid": qid, "tenant": tenant, "tier": tier, "weight": 1, "package": blob,
           "fingerprint": fp, "trace": {"qid": qid, "tenant": tenant}}
    t0 = time.perf_counter()
    post("rq/" + qid, pickle.dumps(env, protocol=pickle.HIGHEST_PROTOCOL))
    body = poll("res/" + qid, 300)
    dt = time.perf_counter() - t0
    assert body is not None and body[:2] == b"F1", "no result for " + qid
    hlen = struct.unpack("<II", body[2:10])[0]
    h = pickle.loads(body[10:10 + hlen])
    assert h.get("ok") and h.get("rejected") is None, h
    done.append({"qid": qid, "plan": plan, "lat": dt, "cached": bool(h.get("cached")),
                 "replica": h.get("replica")})
print(json.dumps({"tenant": tenant, "tier": tier, "done": done,
                  "elapsed": time.perf_counter() - t_start}))
"""


def _tier(t: int) -> str:
    return "latency" if t < SV_TENANTS // 2 else "batch"


def phase_fleet(dev, card: str) -> dict:
    """The serving fleet: a front door (``ServeFleet``) in this process
    before FL_REPLICAS replica processes on the card (``python -m
    dryad_tpu_torch.serve.replica``, a bootstrap building
    ``DryadContext()``), 4 tenants of FL_ROWS rows (tenants 0-1 in the
    latency tier, 2-3 in the batch tier) and the reference bench's four
    plans each, every plan warmed on its rendezvous owner; FL_CLIENTS
    closed-loop stdlib client processes, FL_PER_CLIENT queries each over
    the wire; then a replica killed with queries in flight.  Every
    result is byte-equal to a direct run in one port context (itself
    held to numpy), repeats land on their owners, and the dead replica's
    queries replay byte-identical on the failover replica.  The bucket
    kernel's launches are the replicas' own, posted with their stats."""
    import pickle
    import shutil
    import threading

    from dryad_tpu_torch import DryadContext
    from dryad_tpu_torch.serve.fleet import FLEET_PID, ServeFleet, decode_result, pack_for_fleet
    from dryad_tpu_torch.serve.router import rendezvous_rank

    free_card()
    t_phase = time.perf_counter()
    root = os.path.join(WORK_DIR, "fleet")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    res = {"card": card, "replicas": FL_REPLICAS, "rows": FL_ROWS, "clients": FL_CLIENTS}

    # the tenants' tables, their plans' direct results (numpy-checked)
    # and kernel inputs, and the packages
    rng = np.random.default_rng(SEED + 51)
    tables = serve_tables(rng, FL_ROWS)
    direct = DryadContext(num_partitions_=P)
    plans, refs, packs = [], [], []
    with LaunchRecorder() as rec:
        for t, (vocab, ids, data) in enumerate(tables):
            tab = direct.from_arrays(data)
            plans.append(serve_plans(tab))
            refs.append([])
            for i, q in enumerate(plans[t]):
                out = q.collect()
                serve_oracle(i, out, vocab, ids, data)
                refs[t].append(digest(out))
            packs.append([pack_for_fleet(q) for q in plans[t]])
    shapes_in = rec.first
    for t in range(SV_TENANTS):
        with open(os.path.join(root, f"payload{t}.pkl"), "wb") as fh:
            pickle.dump(packs[t], fh, protocol=pickle.HIGHEST_PROTOCOL)
    res["package_bytes"] = max(len(b) for p in packs for b, _ in p)
    client = os.path.join(root, "client.py")
    with open(client, "w") as fh:
        fh.write(FLEET_CLIENT)
    boot = os.path.join(root, "bootstrap.py")
    with open(boot, "w") as fh:
        fh.write("from dryad_tpu_torch import DryadContext\n\n\ndef build_context():\n"
                 f"    return DryadContext(device={FL_DEVICE!r})\n")

    def result_of(fleet, qid):
        got = fleet.mailbox.get_prop(FLEET_PID, f"res/{qid}")
        check(got is not None, f"fleet: no result for {qid}")
        header, table = decode_result(got[1])
        check(header["ok"], f"fleet: {qid} failed: {header.get('error')}")
        return header, table

    os.makedirs(os.path.join(root, "door"))
    fleet = ServeFleet(root=os.path.join(root, "door"), hb_interval=FL_HB_S, stale_after=FL_STALE_S,
                       res_gc_s=3600.0)
    try:
        errs = []

        def spawn(rid):
            try:
                fleet.spawn_process(rid, boot, timeout=600.0)
            except BaseException as e:  # noqa: BLE001 - raised below
                errs.append(repr(e))

        rids = [f"r{i}" for i in range(FL_REPLICAS)]
        ths = [threading.Thread(target=spawn, args=(rid,)) for rid in rids]
        t0 = time.perf_counter()
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        check(not errs, f"fleet: a replica did not start: {errs[:1]}")
        res["boot_s"] = time.perf_counter() - t0
        owners = {fp: rendezvous_rank(fp, rids)[0] for p in packs for _b, fp in p}
        res["owners"] = sorted(owners.values())
        log(f"fleet: {FL_REPLICAS} replica processes on the card in {res['boot_s']:.2f} s; "
            f"{len(owners)} plans over owners {dict((r, res['owners'].count(r)) for r in rids)}")

        # warm every plan on its owner (package load, first run, cache fill)
        t0 = time.perf_counter()
        for t in range(SV_TENANTS):
            for i, (blob, fp) in enumerate(packs[t]):
                qid = fleet.submit(tenant=f"tenant{t}", package=blob, fingerprint=fp, tier=_tier(t))
                fleet.result(qid, timeout=600)
                header, table = result_of(fleet, qid)
                check(header["replica"] == owners[fp], f"fleet warm-up: {qid} ran off its owner")
                check(digest(table) == refs[t][i], f"fleet warm-up: tenant{t} plan {i} differs from "
                      "the direct run")
        res["warm_s"] = time.perf_counter() - t0

        # the load: closed-loop client processes over the wire
        with DeviceBusy() as busy:
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, client, fleet.host, str(fleet.port),
                 os.path.join(root, f"payload{i % SV_TENANTS}.pkl"), f"tenant{i % SV_TENANTS}",
                 _tier(i % SV_TENANTS), str(FL_PER_CLIENT), str(i // SV_TENANTS)],
                stdout=subprocess.PIPE, text=True) for i in range(FL_CLIENTS)]
            reports = []
            for p in procs:
                out, _ = p.communicate(timeout=900)
                check(p.returncode == 0, f"fleet client exited {p.returncode}")
                reports.append(json.loads(out.strip().splitlines()[-1]))
            elapsed = time.perf_counter() - t0
        done = [(int(r["tenant"][6:]), q) for r in reports for q in r["done"]]
        check(len(done) == FL_CLIENTS * FL_PER_CLIENT, "fleet: a client query went missing")
        cached = 0
        for t, q in done:
            header, table = result_of(fleet, q["qid"])
            check(digest(table) == refs[t][q["plan"]],
                  f"fleet: tenant{t} plan {q['plan']} ({'cached' if header['cached'] else 'run'}) "
                  "differs from the direct run")
            check(header["replica"] == owners[packs[t][q["plan"]][1]], f"fleet: {q['qid']} ran off its owner")
            cached += bool(header["cached"])
        lat = {tier: sorted(q["lat"] for r in reports if r["tier"] == tier for q in r["done"])
               for tier in ("latency", "batch")}
        time.sleep(2 * max(FL_HB_S, 0.5))  # each replica posts its stats once more
        stats = fleet.stats()
        rates = {}
        for rid in rids:
            c = (stats["replicas"].get(rid) or {}).get("cache", {})
            looked = c.get("hits", 0) + c.get("misses", 0)
            rates[rid] = c.get("hits", 0) / looked if looked else None
        known = [v for v in rates.values() if v is not None]
        res.update(
            queries=len(done), seconds=elapsed, queries_per_s=len(done) / elapsed, cached=cached,
            p50_ms={k: 1e3 * _pct(v, 0.5) for k, v in lat.items()},
            p99_ms={k: 1e3 * _pct(v, 0.99) for k, v in lat.items()},
            hit_rate=cached / len(done), replica_hit_rates=rates,
            hit_rate_spread=(max(known) - min(known)) if known else None,
            device_idle=busy.idle, device_busy_s=busy.busy_s,
        )
        log(f"fleet cell [{card}]: {len(done)} queries from {FL_CLIENTS} client processes in "
            f"{elapsed:.3f} s = {res['queries_per_s']:.2f} queries/s; p50/p99 latency tier "
            f"{res['p50_ms']['latency']:.1f}/{res['p99_ms']['latency']:.1f} ms, batch tier "
            f"{res['p50_ms']['batch']:.1f}/{res['p99_ms']['batch']:.1f} ms; hit rate "
            f"{res['hit_rate']:.3f}, by replica {rates}; card idle {busy.idle:.3f} (NVML, every "
            f"process); every result byte-equal to the direct run, each on its owner")

        # a replica killed with queries in flight: fresh plans it owns
        victim = rids[0]
        fresh = []
        for t in range(SV_TENANTS):
            tab = direct.from_arrays(tables[t][2])
            for n in range(65, 4096):
                q = tab.order_by("v").take(n)
                blob, fp = pack_for_fleet(q)
                if rendezvous_rank(fp, rids)[0] == victim:
                    fresh.append((t, q, blob, fp))
                    break
            if len(fresh) == FL_KILL_QUERIES:
                break
        want = {id(q): digest(q.collect()) for _t, q, _b, _f in fresh}
        routed0 = fleet.stats()["router"]["routed"]
        qids = [(fleet.submit(tenant=f"tenant{t}", package=b, fingerprint=fp, tier=_tier(t)), q)
                for t, q, b, fp in fresh]
        deadline = time.monotonic() + 60
        while fleet.stats()["router"]["routed"] < routed0 + len(qids):
            check(time.monotonic() < deadline, "fleet: the kill cell's queries were not routed")
            time.sleep(0.001)
        t_kill = time.perf_counter()
        fleet.kill_replica(victim)
        in_flight = sum(fleet.mailbox.get_prop(FLEET_PID, f"res/{qid}") is None for qid, _q in qids)
        for qid, q in qids:
            fleet.result(qid, timeout=600)
            header, table = result_of(fleet, qid)
            check(digest(table) == want[id(q)], f"fleet: the replayed {qid} differs from the direct run")
        recover_s = time.perf_counter() - t_kill
        router = fleet.stats()["router"]
        check(router["dead"] == [victim], f"fleet: dead replicas {router['dead']}")
        check(in_flight >= 1 and router["replayed"] >= in_flight,
              f"fleet: {in_flight} queries in flight at the kill, {router['replayed']} replayed")
        res.update(killed=victim, in_flight_at_kill=in_flight, replayed=router["replayed"],
                   recover_s=recover_s)
        log(f"fleet kill [{card}]: {victim} killed with {in_flight} of {len(qids)} queries in flight; "
            f"{router['replayed']} replayed on the failover replica, byte-identical to the direct "
            f"runs; recovered in {recover_s:.3f} s (heartbeat stale after {FL_STALE_S} s)")

        # a replica that dies through the chaos hook (a seeded FaultPlan
        # kill at a command batch) dumps its flight recorder first:
        # tools/blackbox merges the dump into the timeline of its death
        dumps = os.path.join(root, "dumps")
        cboot = os.path.join(root, "bootstrap_chaos.py")
        with open(cboot, "w") as fh:
            fh.write("from dryad_tpu_torch import DryadConfig, DryadContext\n\n\ndef build_context():\n"
                     f"    return DryadContext(device={FL_DEVICE!r}, "
                     f"config=DryadConfig(flightrec_dir={dumps!r}))\n")
        fleet.spawn_process("rc", cboot, fault=json.dumps(
            {"seed": 0, "worker_kill_prob": 1.0, "stages": ["replica:rc"]}), timeout=600.0)
        live = [r for r in rids if r != victim] + ["rc"]
        tab = direct.from_arrays(tables[0][2])
        for n in range(4096, 8192):
            q = tab.order_by("v").take(n)
            blob, fp = pack_for_fleet(q)
            if rendezvous_rank(fp, live)[0] == "rc":
                break
        t0 = time.perf_counter()
        qid = fleet.submit(tenant="tenant0", package=blob, fingerprint=fp, tier=_tier(0))
        fleet.result(qid, timeout=600)
        header, table = result_of(fleet, qid)
        check(digest(table) == digest(q.collect()), "fleet: the chaos replica's replayed query differs")
        check("rc" in fleet.stats()["router"]["dead"], "fleet: the chaos replica was not reaped")
        trace = os.path.join(root, "blackbox_trace.json")
        bb = subprocess.run(
            [sys.executable, "-m", "dryad_tpu_torch.tools.blackbox", dumps, "--window", "0",
             "--diagnose", "--trace", trace], capture_output=True, text=True, cwd=ROOT, timeout=300)
        check(bb.returncode == 0, f"blackbox exited {bb.returncode}: {bb.stderr[-2000:]}")
        kill_lines = [ln for ln in bb.stdout.splitlines() if "worker_killed_injected" in ln]
        check("reason=replica_chaos_kill" in bb.stdout and len(kill_lines) == 1,
              "fleet: the blackbox timeline does not hold the chaos kill")
        check(bool(json.load(open(trace))["traceEvents"]), "fleet: the blackbox trace is empty")
        res["chaos_kill"] = {"recover_s": time.perf_counter() - t0}
        log(f"fleet chaos kill: replica rc died at its first command batch after dumping its "
            f"flight recorder; its query replayed byte-identical in {res['chaos_kill']['recover_s']:.3f} s; "
            f"tools/blackbox merged the dump: {kill_lines[0].strip()}")
    finally:
        fleet.close()
    launches = {}
    for rid in rids:
        got = fleet.mailbox.get_prop(FLEET_PID, f"stats/{rid}")
        launches[rid] = pickle.loads(got[1])["kernel_launches"]["bucket_sum_count"] if got else 0
    res["replica_launches"] = launches
    res["launches"] = sum(launches.values())
    check(res["launches"] >= 1, "the fleet's replicas launched no bucket kernel")
    shapes = []
    for (_m, K, _cap), (keys, vals, valid) in sorted(shapes_in.items()):
        shapes.append(kernel_shape_report(keys, vals, valid, K))
        log(f"kernel vs plain at a fleet shape ({shapes[-1]['shape']}): byte-equal; kernel "
            f"{shapes[-1]['kernel_ms']:.3f} ms, plain {shapes[-1]['plain_ms']:.3f} ms, "
            f"{shapes[-1]['library']} {shapes[-1]['library_ms']:.3f} ms, bound "
            f"{shapes[-1]['bound_ms']:.4f} ms")
    del direct, plans
    shutil.rmtree(root, ignore_errors=True)
    free_card()
    res.update(kernel_shapes=shapes, phase_s=time.perf_counter() - t_phase)
    log(f"fleet phase [{card}]: {res['phase_s']:.1f} s (boot {res['boot_s']:.2f} s, warm "
        f"{res['warm_s']:.2f} s); {res['launches']} bucket kernel launches in the replicas {launches}")
    return res


# -- phase 20: the telemetry plane, the profiler hook and the job tools ---------

OBS_SORT_ROWS = 1 << 25  # the adaptive-depth stream sort, in SM_TS_CHUNK-row chunks (cut from 2^26)
OBS_WORDS = 1 << 25  # the obs path's WordCount corpus (cut from WC_WORDS)
OBS_COST_PAIRS = 40  # WordCount warm queries with the sampler on and off, interleaved (cut from 60)


def obs_stream_sort(spill_root: str, **cfg) -> dict:
    """order_by(key) over a from_stream of OBS_SORT_ROWS seeded rows (the
    stream phase's TeraSort input) read with collect_stream: the output's
    key and payload digests (byte-equal runs have equal digests), its row
    count and order-free checksum against the input's, the seconds, the
    peak device memory and the dispatch depth its driver resolved."""
    import hashlib

    from dryad_tpu_torch.obs.telemetry import resolve_depth

    rng = np.random.default_rng(SEED + 16)
    made = {"sum": 0}

    def chunks():
        for _ in range(OBS_SORT_ROWS // SM_TS_CHUNK):
            key = rng.integers(-2**31, 2**31, SM_TS_CHUNK, dtype=np.int32)
            pay = rng.random(SM_TS_CHUNK, dtype=np.float32)
            made["sum"] = (made["sum"] + row_checksum(key, pay)) % (1 << 64)
            yield {"key": key, "payload": pay}

    ctx = _stream_ctx(spill_root, **cfg)
    # a fresh context's first sample comes with its first event, after
    # the stream's driver resolved its depth: take one first, as a
    # resident context's sampler would have
    ctx.telemetry.sample()
    headroom = ctx.headroom.headroom_bytes()
    want = resolve_depth(ctx.config.dispatch_depth, ctx.headroom)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    hk, hp = hashlib.sha256(), hashlib.sha256()
    rows, total, last = 0, 0, None
    t0 = time.perf_counter()
    for piece in ctx.from_stream(chunks()).order_by([("key", False)]).collect_stream():
        k = piece["key"]
        if len(k) == 0:
            continue
        check(bool((k[1:] >= k[:-1]).all()) and (last is None or int(k[0]) >= last),
              "obs stream sort: a piece is out of order")
        last = int(k[-1])
        hk.update(k.tobytes())
        hp.update(piece["payload"].tobytes())
        rows += len(k)
        total = (total + row_checksum(k, piece["payload"])) % (1 << 64)
    secs = time.perf_counter() - t0
    peak = card_peak()
    check(rows == OBS_SORT_ROWS and total == made["sum"],
          f"obs stream sort: {rows} rows, checksum equal to the input's: {total == made['sum']}")
    depths = {e["depth"] for e in ctx.events.events() if e["kind"] == "dispatch_window"}
    check(depths == {want}, f"obs stream sort: dispatch windows at depths {depths}, resolved {want}")
    out = {"digest": hk.hexdigest() + hp.hexdigest(), "seconds": secs, "peak_bytes": peak,
           "depth": want, "headroom_bytes": headroom}
    del ctx
    free_card()
    return out


def phase_obs(dev, card: str) -> dict:
    """The continuous telemetry plane, the profiler hook and the job tools
    on WordCount at the wordcount phase's size, in a default context (the
    resource sampler on) logging to a JSONL file: device-source samples
    held to ``torch.cuda.mem_get_info`` around the query, no
    ``hbm_pressure``; ``explain(analyze=True)``; ``profile_dir`` (a
    torch.profiler trace naming the bucket kernel and one
    ``record_function`` range per stage attempt; under a caller's
    profiler the executor opens none and says so); the sampler's cost on
    the warm median (its event tap on and off, interleaved); the span
    export (``obs/trace.py``); the bucket kernel held against its plain
    version at the inputs of its first launch at each shape on the path;
    jobview and metricsd over the log; then a 2^25-row stream sort at
    ``dispatch_depth=-1`` beside the default depth of 2, in the order
    -1, 2, 2, -1."""
    import json as _json
    import shutil

    from dryad_tpu_torch import DryadConfig, DryadContext
    from dryad_tpu_torch.api.query import Query
    from dryad_tpu_torch.obs.trace import write_chrome_trace
    from dryad_tpu_torch.ops.bucket import bucket_sum_count
    from dryad_tpu_torch.serve.service import QueryService

    free_card()
    t_phase = time.perf_counter()
    root = os.path.join(WORK_DIR, "obs")
    shutil.rmtree(root, ignore_errors=True)
    logs, prof_dir = os.path.join(root, "events"), os.path.join(root, "profile")
    os.makedirs(logs)
    res = {"card": card, "words": OBS_WORDS}
    steps = res["steps_s"] = {}
    t_step = [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        steps[name] = now - t_step[0]
        t_step[0] = now

    rng = np.random.default_rng(SEED + 2)
    ids = zipf_ids(rng, OBS_WORDS)
    tab = vocab_table()
    words = np.array([bytes(r).split()[0].decode() for r in tab], object)
    path = os.path.join(root, "wordcount.txt")
    with open(path, "wb") as fh:
        fh.write(tab[ids].tobytes())
    cnt = np.bincount(ids, minlength=WC_VOCAB)
    oracle = {w: c for w, c in zip(words.tolist(), cnt.tolist()) if c}
    del ids

    def rows_ok(table, what):
        check(dict(zip(table["word"].tolist(), table["n"].tolist())) == oracle,
              f"obs WordCount ({what}) differs from the numpy oracle")

    ctx = DryadContext(num_partitions_=P, config=DryadConfig(event_log_dir=logs))
    check(ctx.telemetry is not None and ctx.executor.headroom is ctx.headroom,
          "the default context has no resource sampler")
    q = ctx.from_text(path).group_by("word", {"n": ("count", None)})
    os.remove(path)
    step("input_and_tokenize")
    bucket_sum_count.launches = 0  # the obs path starts here
    # the inputs of the kernel's first launch at each shape on the path,
    # held against its plain version after it (uninstalled at its end)
    rec = LaunchRecorder().__enter__()
    rows_ok(q.collect(), "first query")
    step("first_query")

    # 1. device samples during a warm query, inside what mem_get_info
    # reads around it: free + the allocator's cached bytes
    time.sleep(ctx.config.telemetry_sample_s)  # a sample is due at its first event
    mark = len(ctx.events.events())
    torch.cuda.synchronize()
    free0, total = torch.cuda.mem_get_info(dev)
    reserved0 = torch.cuda.memory_reserved(dev)
    rows_ok(q.collect(), "sampled")
    torch.cuda.synchronize()
    free1, _ = torch.cuda.mem_get_info(dev)
    reserved1 = torch.cuda.memory_reserved(dev)
    samples = [e for e in ctx.events.events()[mark:] if e["kind"] == "resource_sample"]
    check(bool(samples) and all(e["source"] == "device" for e in samples),
          f"obs: the warm query's samples {samples}")
    lo, hi = min(free0, free1), max(free0, free1) + max(reserved0, reserved1)
    for e in samples:
        check(e["hbm_limit_bytes"] == total, f"obs: sample limit {e['hbm_limit_bytes']} != {total}")
        check(lo <= e["hbm_headroom_bytes"] <= hi,
              f"obs: sample headroom {e['hbm_headroom_bytes']} outside [{lo}, {hi}]")
        check(e["hbm_used_bytes"] + e["hbm_headroom_bytes"] == total, f"obs: sample {e}")
    res["sample"] = {k: samples[-1][k] for k in ("hbm_used_bytes", "hbm_limit_bytes", "hbm_headroom_bytes")}
    log(f"obs [{card}]: {len(samples)} device sample(s) in the warm query: limit {total} B "
        f"(= mem_get_info's total), headroom {samples[-1]['hbm_headroom_bytes'] / 1e9:.3f} GB within "
        f"[{lo / 1e9:.3f}, {hi / 1e9:.3f}] GB (free before/after, widened by the cached bytes)")

    step("samples")

    # 2. explain(analyze=True): the same query, its rows kept
    kept = []
    q.collect = lambda: kept.append(Query.collect(q)) or kept[-1]
    text = q.explain(analyze=True)
    del q.collect
    rows_ok(kept[0], "explain(analyze=True)")
    check("\n  phases: " in text and "\n-- critical path --\n" in text,
          "obs: explain(analyze=True) lacks its phases line or critical path")
    log("obs explain(analyze=True), its runtime panels:\n" + text.split("== runtime diagnosis ==")[1])

    step("explain_analyze")

    # 3. profile_dir: one trace per top-level job (the executor reads the
    # directory from the context's config at each job)
    ctx.config.profile_dir = prof_dir
    mark = len(ctx.events.events())
    rows_ok(q.collect(), "profile_dir")
    evs = ctx.events.events()[mark:]
    (written,) = [e["path"] for e in evs if e["kind"] == "profile_trace"]
    check(os.path.dirname(written) == prof_dir, f"obs: trace written to {written}")
    doc = _json.load(open(written))
    kern = [e for e in doc["traceEvents"] if e.get("cat") == "kernel"]
    check(any("bucket_cluster" in e["name"] for e in kern), "obs: the trace does not name the bucket kernel")
    attempts = [e["name"] for e in evs if e["kind"] == "span" and e["cat"] == "execute"]
    ranges = [e["name"] for e in doc["traceEvents"] if e.get("cat") == "user_annotation"]
    check(bool(attempts) and all(ranges.count(n) == attempts.count(n) for n in set(attempts)),
          f"obs: record_function ranges {sorted(set(ranges))[:8]} against attempts {attempts}")
    by_op = {}
    for e in kern + [e for e in doc["traceEvents"] if e.get("cat") in ("gpu_memcpy", "gpu_memset")]:
        by_op[e["name"]] = by_op.get(e["name"], 0.0) + e.get("dur", 0.0) / 1e3
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:15]
    res["profile"] = {"trace_bytes": os.path.getsize(written), "attempts": len(attempts),
                      "device_ms_by_op": top, "device_ms": sum(by_op.values())}
    for name, ms in top:
        log(f"  obs profile_dir trace [{card}] {ms:9.3f} ms  {name[:90]}")
    log(f"obs profile_dir: {os.path.getsize(written) / 1e6:.1f} MB trace, the bucket kernel named, "
        f"{len(attempts)} stage attempt range(s); device time {res['profile']['device_ms']:.3f} ms "
        "(kernels, copies, fills)")
    from torch.profiler import ProfilerActivity, profile

    mark = len(ctx.events.events())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        rows_ok(q.collect(), "under a caller's profiler")
    (skipped,) = [e for e in ctx.events.events()[mark:] if e["kind"] == "profile_trace"]
    check(skipped["path"] is None and skipped["skipped"] == "profiler_active"
          and os.listdir(prof_dir) == [os.path.basename(written)],
          "obs: the executor opened a session under a caller's profiler")
    ctx.config.profile_dir = None
    step("profile_dir")

    # 4. the sampler's cost on the warm median: its tap off and on in
    # turn (obs_telemetry=False builds no sampler; the tap is all it adds)
    tap = ctx.telemetry.observe
    times = {"on": [], "off": []}
    mark = len(ctx.events.events())
    for i in range(OBS_COST_PAIRS):
        for mode in (("on", "off") if i % 2 == 0 else ("off", "on")):
            if mode == "off":
                ctx.events.remove_tap(tap)
            t0 = time.perf_counter()
            q.collect()
            times[mode].append(time.perf_counter() - t0)
            if mode == "off":
                ctx.events.add_tap(tap)
    evs = ctx.events.events()[mark:]
    per_query = sum(e["kind"] != "resource_sample" for e in evs) / (2 * OBS_COST_PAIRS)
    sampled = sum(e["kind"] == "resource_sample" for e in evs)
    med = {m: float(np.median(v)) for m, v in times.items()}
    spread = {m: float(np.percentile(v, 75) - np.percentile(v, 25)) for m, v in times.items()}
    # the sampler's own work, apart: one tap call that samples nothing,
    # and one sample of the card (no event log)
    from dryad_tpu_torch.obs.telemetry import ResourceMonitor, device_memory_probe

    probe = ResourceMonitor(interval_s=1e9, device_memory_fn=device_memory_probe(dev))
    probe.sample()
    t0 = time.perf_counter()
    for _ in range(200):
        probe.sample()
    sample_us = (time.perf_counter() - t0) / 200 * 1e6
    probe.observe({"kind": "note"})
    t0 = time.perf_counter()
    for _ in range(10000):
        probe.observe({"kind": "note"})
    tap_us = (time.perf_counter() - t0) / 10000 * 1e6
    res["sampler_cost"] = {"pairs": OBS_COST_PAIRS, "median_on_s": med["on"], "median_off_s": med["off"],
                           "iqr_on_s": spread["on"], "iqr_off_s": spread["off"],
                           "ratio": med["on"] / med["off"], "events_per_query": per_query,
                           "samples_taken": sampled, "sample_us": sample_us, "tap_us": tap_us}
    log(f"obs sampler cost [{card}]: WordCount warm median {med['on']:.4f} s with the sampler, "
        f"{med['off']:.4f} s without ({OBS_COST_PAIRS} each, interleaved; IQR {spread['on']:.4f} / "
        f"{spread['off']:.4f} s): ratio {med['on'] / med['off']:.4f}; apart: a tap call {tap_us:.2f} us "
        f"x {per_query:.1f} events a query, a sample of the card {sample_us:.1f} us ({sampled} taken "
        f"in the {OBS_COST_PAIRS} sampled queries)")

    step("sampler_cost")

    # 5. one served query (the query counters), the span export
    with QueryService(ctx) as svc:
        rows_ok(svc.session("obs").run(q), "served")
    del svc
    evs = ctx.events.events()
    check(not [e for e in evs if e["kind"] == "diagnosis" and e["rule"] == "hbm_pressure"],
          "obs: a clean run diagnosed hbm_pressure")
    spans_path = os.path.join(root, "spans.json")
    write_chrome_trace(evs, spans_path)
    doc = _json.load(open(spans_path))
    n_exec = sum(e["kind"] == "span" and e["cat"] == "execute" for e in evs)
    n_x = sum(e["ph"] == "X" and e["cat"] == "execute" for e in doc["traceEvents"])
    check(n_exec > 0 and n_x == n_exec, f"obs: {n_x} execute slices for {n_exec} execute spans")
    launches = bucket_sum_count.launches  # the obs path ends here
    rec.__exit__(None, None, None)
    check(launches >= 1 and launches == rec.launched(),
          f"obs: the path launched the bucket kernel {launches} times, its calls and replays "
          f"{rec.launched()}")
    step("serve_and_span_export")
    shapes = []
    for (m, K, _), (keys, vals, valid) in sorted(rec.first.items()):
        shapes.append(kernel_shape_report(keys, vals, valid, K))
        log(f"kernel vs plain at an obs shape ({shapes[-1]['shape']}): byte-equal; kernel "
            f"{shapes[-1]['kernel_ms']:.3f} ms, plain {shapes[-1]['plain_ms']:.3f} ms, "
            f"{shapes[-1]['library']} {shapes[-1]['library_ms']:.3f} ms, bound "
            f"{shapes[-1]['bound_ms']:.4f} ms")
    rec.first.clear()
    res["kernel_shapes"] = shapes
    step("kernel_shapes")

    # 6. the job tools over the JSONL log, through their command lines
    import contextlib
    import io

    from dryad_tpu_torch.exec.events import EventLog
    from dryad_tpu_torch.tools import jobview, metricsd

    (log_path,) = [os.path.join(logs, f) for f in os.listdir(logs)]
    html = os.path.join(root, "job.html")
    tools = {}
    for name, mod, argv in (("jobview", jobview, ["--html", html, log_path]),
                            ("metricsd", metricsd, [log_path])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = mod.main(argv)
        check(rc == 0, f"obs: {name} exited {rc}")
        tools[name] = out.getvalue()
    check("job: OK" in tools["jobview"] and "-- time attribution --" in tools["jobview"],
          "obs: jobview's report:\n" + tools["jobview"])
    check("<svg" in open(html).read(), "obs: jobview's HTML has no stage DAG")
    # the live view's panels (``--follow``), rendered from the same log
    logged = EventLog.load(log_path)
    panels = jobview.render_telemetry(logged) + "\n" + jobview.render_queries(logged)
    check("hbm: used=" in panels and "\n-- queries --\n" in panels,
          "obs: jobview's telemetry or queries panel is missing:\n" + panels)
    prom = tools["metricsd"]
    check("\ndryad_hbm_headroom_bytes " in prom and 'dryad_queries_completed_total{tenant="obs"} 1' in prom
          and 'dryad_queries_admitted_total{tenant="obs"} 1' in prom,
          "obs: metricsd's Prometheus text lacks the headroom gauge or the query counters")
    log("obs jobview panels:\n" + "\n".join(panels.splitlines()[:8]))
    log("obs metricsd: " + "; ".join(ln for ln in prom.splitlines()
                                    if ln.startswith(("dryad_hbm_", "dryad_queries_completed"))))
    del ctx, q, kept
    free_card()
    step("job_tools")

    # 7. the adaptive dispatch depth: a 2^25-row stream sort at -1 beside
    # 2, in the order -1, 2, 2, -1 so that neither depth always runs first
    spill = os.path.join(root, "spill")
    runs = {"-1": [], "2": []}
    for depth in ("-1", "2", "2", "-1"):
        runs[depth].append(obs_stream_sort(spill, **({"dispatch_depth": -1} if depth == "-1" else {})))
    step("adaptive_depth_sorts")
    deep, base = runs["-1"][0], runs["2"][0]
    check(all(r["depth"] == 2 for r in runs["2"]), f"obs: the default depth resolved to {base['depth']}")
    check(all(r["depth"] == deep["depth"] for r in runs["-1"]),
          f"obs: dispatch_depth=-1 resolved to {[r['depth'] for r in runs['-1']]}")
    check(all(r["digest"] == base["digest"] for r in runs["-1"] + runs["2"]),
          "obs: the depth -1 sort's rows differ from depth 2's")
    res["adaptive_depth"] = {"rows": OBS_SORT_ROWS, "resolved": deep["depth"], "order": "-1, 2, 2, -1",
                             "headroom_bytes": deep["headroom_bytes"],
                             "seconds": {d: [r["seconds"] for r in v] for d, v in runs.items()},
                             "peak_bytes": {d: [r["peak_bytes"] for r in v] for d, v in runs.items()}}
    log(f"obs adaptive depth [{card}]: dispatch_depth=-1 resolved to {deep['depth']} from "
        f"{deep['headroom_bytes'] / 1e9:.2f} GB headroom; the {OBS_SORT_ROWS}-row stream sort, run "
        f"in the order -1, 2, 2, -1: depth -1 "
        + ", ".join(f"{r['seconds']:.3f} s (peak {r['peak_bytes'] / 1e9:.3f} GB)" for r in runs["-1"])
        + "; depth 2 "
        + ", ".join(f"{r['seconds']:.3f} s (peak {r['peak_bytes'] / 1e9:.3f} GB)" for r in runs["2"])
        + "; rows byte-equal")
    shutil.rmtree(root, ignore_errors=True)
    res.update(launches=launches, phase_s=time.perf_counter() - t_phase)
    log(f"obs phase [{card}]: {res['phase_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in steps.items())
        + f" s); {launches} bucket kernel launches on the obs path")
    return res


# -- phase 22: the gang data plane (one program across worker processes) ------------

GANG_WORKERS = 2
GANG_PARTS = 4  # partitions a worker holds: P = 8 over the gang
GANG_DEVICE = "cuda"  # where the gang's workers run
GANG_TS_ROWS = 1 << 25  # the gang's TeraSort, uniform int32 keys, f32 payloads (cut from 2^26)
GANG_WORDS = 1 << 24  # the gang's WordCount corpus (cut from 2^25; PERF.md section 4)
GANG_MANY = 4  # submit_many's queries ...
GANG_MANY_ROWS = 1 << 20  # ... of this many rows
GANG_KILL_ROWS = 1 << 24  # the group_by whose gang loses a worker mid-job
GANG_CHILD_TIMEOUT_S = 240.0
GANG_DL_ROWS = 1 << 22  # the devloop phase's Newton loop, run over the one-rank NCCL group


def _dense_table() -> dict:
    """The dense phase's table: 2^26 rows, K = 65536 int keys, f32 and
    int32 values."""
    rng = np.random.default_rng(SEED + 3)
    return {
        "k": rng.integers(0, DENSE_K, DENSE_ROWS).astype(np.int32),
        "v": (rng.standard_normal(DENSE_ROWS) * 100).astype(np.float32),
        "w": rng.integers(-100, 100, DENSE_ROWS).astype(np.int32),
    }


GANG_DENSE_AGGS = {"c": ("count", None), "sv": ("sum", "v"), "mv": ("mean", "v"), "sw": ("sum", "w")}


def check_dense_gang(out: dict, one: dict, tbl: dict, label: str) -> float:
    """``out`` against the one-process result ``one`` at the same P:
    keys, counts and integer sums byte-equal, float sums and means
    within 2^-16 * sum|v| of each other and of the float64 oracle."""
    for c in ("k", "c", "sw"):
        check(out[c].dtype == one[c].dtype and out[c].tobytes() == one[c].tobytes(),
              f"{label}: {c} differs from the one-process result")
    a = np.bincount(tbl["k"], weights=np.abs(tbl["v"].astype(np.float64)), minlength=DENSE_K)[out["k"]]
    ref = np.bincount(tbl["k"], weights=tbl["v"].astype(np.float64), minlength=DENSE_K)[out["k"]]
    err = np.abs(out["sv"].astype(np.float64) - one["sv"])
    check(bool((err <= FLOAT_REL * a).all()), f"{label}: float sums past 2^-16 sum|v| of one process's")
    check(bool((np.abs(out["sv"] - ref) <= FLOAT_REL * a + 1e-3).all()), f"{label}: float sums past the oracle")
    merr = np.abs(out["mv"].astype(np.float64) - one["mv"])
    check(bool((merr <= FLOAT_REL * a / out["c"]).all()), f"{label}: means past the bound")
    return float(err.max())


def _gang_counters(sub, mark: int, name: str) -> dict:
    """A worker-shipped counter since event ``mark``, by worker."""
    out = {}
    for e in _since(sub, mark, "metrics"):
        for c in e.get("counters", ()):
            if c["name"] == name:
                out[e.get("worker")] = out.get(e.get("worker"), 0) + c["value"]
    return out


def _gang_peaks(sub, mark: int) -> dict:
    out = {}
    for e in _since(sub, mark, "metrics"):
        for c in e.get("counters", ()):
            if c["name"] == "device_peak_bytes":
                out[e.get("worker")] = max(out.get(e.get("worker"), 0), c["value"])
    return out


def _gang_backends(sub) -> list:
    """The backend each worker's log says its process group took."""
    import re

    found = []
    for i in range(sub.n):
        with open(os.path.join(sub.root, f"worker{i}.log"), errors="replace") as fh:
            m = re.findall(r"joined process group \S+ as rank \d+/\d+ on \S+ \((\w+)\)", fh.read())
        found.append(m[-1] if m else None)
    return found


def gang_job(sub, q, label: str, card: str) -> tuple:
    """One gang submission: (table, its numbers), logged."""
    mark = len(sub.events.events())
    t0 = time.perf_counter()
    out = sub.submit(q)
    secs = time.perf_counter() - t0
    pkg = _package(sub, mark, "gang_run_start")
    fetch = sorted(e["dur"] for e in _since(sub, mark, "span") if e.get("name") == "fetch_package")
    res = {
        "job_s": secs, "package_bytes": os.path.getsize(pkg), "fetch_s": fetch,
        "collective_bytes": _gang_counters(sub, mark, "collective_bytes"),
        "launches": worker_launches(sub, mark),
        "launches_by_worker": _gang_counters(sub, mark, "kernel_launches"),
        "peak_bytes": _gang_peaks(sub, mark),
    }
    log(f"gang {label} [{card}]: job {secs:.2f} s; package {res['package_bytes'] / 2**20:.1f} MiB, "
        f"fetched in {', '.join(f'{x:.2f}' for x in fetch)} s; bytes to the group by worker "
        f"{res['collective_bytes']}; bucket kernel launches {res['launches']} "
        f"{res['launches_by_worker']}; device peak by worker (GB) "
        f"{ {w: round(b / 1e9, 3) for w, b in res['peak_bytes'].items()} }")
    return out, res


def _kill_mid_job(sub, worker: int) -> "threading.Thread":
    """Kill ``worker`` once both gang members passed the next run's start
    barrier: the job is then under way in both."""
    import threading

    seq = sub._seq + 1

    def run():
        mb = sub.service.mailbox
        while not all(mb.get_prop(sub.job_id, f"barrier/start/{seq}/{i}") is not None
                      for i in range(sub.n)):
            time.sleep(0.005)
        sub._handles[worker].kill()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _start_child(args: list) -> subprocess.Popen:
    """This script as a child process (its ``--nccl-*`` and
    ``--terasort-capacity`` modes)."""
    return subprocess.Popen([sys.executable, os.path.abspath(__file__)] + args,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)


def _finish_child(proc: subprocess.Popen, timeout: float) -> tuple:
    """``(returncode, stdout, stderr)`` of a child, killed past ``timeout``."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        err += f"\n(killed after {timeout} s)"
    return proc.returncode, out, err


def nccl_two_ranks_one_card() -> dict:
    """Two processes join one NCCL group on the same card and all-reduce
    once: NCCL's answer, recorded as it gives it."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [_start_child(["--nccl-probe", str(r), str(port)]) for r in range(2)]
    outs = [_finish_child(p, 120.0) for p in procs]
    ok = all(rc == 0 and "ALLREDUCE 3" in o for rc, o, _ in outs)
    msg = "" if ok else next((e.strip().splitlines()[-1] for rc, _, e in outs if rc and e.strip()),
                             "no error text")
    return {"accepted": ok, "message": msg, "rcs": [rc for rc, _, _ in outs]}


def phase_gang(dev, card: str) -> dict:
    """One plan as one program across worker processes
    (``LocalJobSubmission.submit``): 2 workers sharing the card, 4
    partitions each (P = 8), their collectives over gloo (CUDA tensors
    through the host).  (a) the dense phase's group_by, bucket kernel in
    each worker then the cross-process psum_scatter, against one process
    at P = 8; (b) TeraSort of GANG_TS_ROWS rows, rows and placement byte-equal to
    one process's; (c) WordCount of the cluster phase's corpus, the
    dictionary back as dictionary.pkl; (d) submit_many of 4 queries
    through the dispatch window, equal to serial submits; (e) a worker
    killed mid-job, the gang rebuilt on 1 worker, the re-run equal to
    the clean run.  Then query (a) in one process over a one-rank NCCL
    group, and NCCL's answer to two ranks on one card."""
    import shutil

    from dryad_tpu_torch import DryadConfig, DryadContext
    from dryad_tpu_torch.cluster.localjob import LocalJobSubmission
    from dryad_tpu_torch.columnar.io import parse_partition_bytes

    free_card()
    t_phase = time.perf_counter()
    res = {"card": card, "workers": GANG_WORKERS, "partitions_per_worker": GANG_PARTS}
    root = os.path.join(WORK_DIR, "gang")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    # beside the gang's work: NCCL's answer to two ranks on one card, and
    # query (a) in one process over a one-rank NCCL group (a child each)
    import concurrent.futures

    probe_pool = concurrent.futures.ThreadPoolExecutor(1)
    probe = probe_pool.submit(nccl_two_ranks_one_card)
    out_path = os.path.join(root, "nccl_world1.npz")
    world1 = _start_child(["--nccl-world1", out_path])
    try:
        # the one-process results the gang is held to, and the kernel's inputs
        tbl = _dense_table()
        one_ctx = DryadContext(num_partitions_=P)
        with LaunchRecorder() as rec:
            dense_one = one_ctx.from_arrays(tbl).group_by("k", GANG_DENSE_AGGS, dense=DENSE_K).collect()
        ((_m, K, _cap), (keys, vals, valid)), = rec.first.items()
        rng = np.random.default_rng(SEED + 4)
        ts = {"key": rng.integers(-2**31, 2**31, GANG_TS_ROWS, dtype=np.int32),
              "payload": rng.random(GANG_TS_ROWS, dtype=np.float32)}
        tq = one_ctx.from_arrays(ts).order_by([("key", False)])
        b = one_ctx.execute(tq)
        ts_counts = b.valid.sum(-1).cpu().numpy()
        ts_one = one_ctx._host_table(tq, b)
        del b, tq, one_ctx
        free_card()

        rng = np.random.default_rng(SEED + 2)
        ids = zipf_ids(rng, GANG_WORDS)
        tab = vocab_table()
        words = np.array([bytes(r).split()[0].decode() for r in tab], object)
        uid, ucnt = np.unique(ids, return_counts=True)
        wc_oracle = dict(zip(words[uid].tolist(), ucnt.tolist()))
        text = os.path.join(root, "words.txt")
        with open(text, "wb") as fh:
            fh.write(tab[ids].tobytes())
        del ids

        with DeviceBusy() as busy:
            t0 = time.perf_counter()
            sub = LocalJobSubmission(num_workers=GANG_WORKERS, devices_per_worker=GANG_PARTS,
                                     root=os.path.join(root, "job"), device=GANG_DEVICE)
            try:
                devs = _wait_for_workers(sub, GANG_WORKERS)
                res["workers_start_s"] = time.perf_counter() - t0
                check(all(d.get("device", "").startswith(GANG_DEVICE) for d in devs.values()),
                      f"a gang worker is not on the card: {devs}")
                mark0 = len(sub.events.events())
                ctx = DryadContext(num_partitions_=P)

                # (a) the dense group_by: the bucket kernel in each worker, then
                # the cross-process psum_scatter
                out, res["dense"] = gang_job(sub, ctx.from_arrays(tbl).group_by(
                    "k", GANG_DENSE_AGGS, dense=DENSE_K), "dense group_by", card)
                res["backends"] = _gang_backends(sub)
                log(f"gang: the process group's backend by worker: {res['backends']}")
                check(res["backends"] == ["gloo"] * GANG_WORKERS, f"gang backends {res['backends']}")
                res["dense"]["max_abs_err_sum"] = check_dense_gang(out, dense_one, tbl, "gang dense")
                by_worker = res["dense"]["launches_by_worker"]
                check(sorted(by_worker) == list(range(GANG_WORKERS)) and min(by_worker.values()) >= 1,
                      f"bucket kernel launches by worker {by_worker}")
                log(f"gang dense group_by: {DENSE_ROWS} rows, K={DENSE_K}: keys, counts and int sums "
                    f"byte-equal to one process at P={P}; float sums within 2^-16 sum|v| (max |err| "
                    f"{res['dense']['max_abs_err_sum']:.3g})")
                del out

                # (b) TeraSort: rows and placement byte-equal to one process's
                out, res["terasort"] = gang_job(sub, ctx.from_arrays(ts).order_by([("key", False)]),
                                                "TeraSort", card)
                check(digest(out) == digest(ts_one), "gang TeraSort differs from one process's rows")
                seq = _since(sub, mark0, "gang_run_start")[-1]["seq"]
                part_dir = os.path.join(sub.root, sub.job_id, f"r{seq}", "result")
                counts = []
                for g in range(P):
                    with open(os.path.join(part_dir, f"part{g}.dpf"), "rb") as fh:
                        counts.append(len(parse_partition_bytes(fh.read())["key"]))
                check(counts == ts_counts.tolist(), f"gang TeraSort placement {counts}, one process "
                      f"{ts_counts.tolist()}")
                log(f"gang TeraSort: {GANG_TS_ROWS} rows byte-equal to one process at P={P}, each "
                    f"partition's rows too (so its splitters): {counts}")
                del out

                # (b') the same TeraSort with its exchange staged one bucket a round
                wctx = DryadContext(num_partitions_=P, config=DryadConfig(exchange_window=1))
                out, res["terasort_window1"] = gang_job(
                    sub, wctx.from_arrays(ts).order_by([("key", False)]), "TeraSort window 1", card)
                check(digest(out) == digest(ts_one),
                      "gang TeraSort at window 1 differs from one process's rows")
                w0, w1 = res["terasort"], res["terasort_window1"]
                log(f"gang TeraSort window 1 [{card}]: byte-equal to one process at P={P}; job "
                    f"{w1['job_s']:.2f} s (window 0 {w0['job_s']:.2f} s); bytes to the group by worker "
                    f"{w1['collective_bytes']} (window 0 {w0['collective_bytes']}); device peak by "
                    f"worker (GB) { {w: round(b / 1e9, 3) for w, b in w1['peak_bytes'].items()} } "
                    f"(window 0 { {w: round(b / 1e9, 3) for w, b in w0['peak_bytes'].items()} })")
                del out, ts, ts_one, wctx

                # (c) WordCount: the dictionary comes back as dictionary.pkl
                wq = ctx.from_text(text).group_by("word", {"n": ("count", None)})
                out, res["wordcount"] = gang_job(sub, wq, "WordCount", card)
                check(dict(zip(out["word"].tolist(), out["n"].tolist())) == wc_oracle,
                      "gang WordCount differs from the numpy oracle")
                check(res["wordcount"]["launches"] >= GANG_WORKERS, "gang WordCount ran no bucket kernel")
                log(f"gang WordCount: {GANG_WORDS} words, {len(wc_oracle)} equal to the oracle")
                del out, wq
                os.remove(text)

                # (d) submit_many through the dispatch window, against serial submits
                rng = np.random.default_rng(SEED + 41)
                cfg = DryadConfig(command_batch=2, gang_batch_depth=2)
                qs = []
                for i in range(GANG_MANY):
                    t = {"k": rng.integers(-5000, 5000, GANG_MANY_ROWS).astype(np.int32),
                         "v": rng.integers(-1000, 1000, GANG_MANY_ROWS).astype(np.int32)}
                    qs.append(DryadContext(num_partitions_=P, config=cfg).from_arrays(t).group_by(
                        "k", {"c": ("count", None), "s": ("sum", "v")}))
                t0 = time.perf_counter()
                serial = [sub.submit(q) for q in qs]
                serial_s = time.perf_counter() - t0
                mark = len(sub.events.events())
                t0 = time.perf_counter()
                many = sub.submit_many(qs)
                many_s = time.perf_counter() - t0
                check([digest(o) for o in many] == [digest(o) for o in serial],
                      "submit_many differs from serial submits")
                (win,) = _since(sub, mark, "gang_window")
                check(win["peak_in_flight"] >= 2 and win["depth"] == 2,
                      f"the dispatch window held {win['peak_in_flight']} envelopes")
                res["submit_many"] = {"serial_s": serial_s, "windowed_s": many_s,
                                      "peak_in_flight": win["peak_in_flight"],
                                      "dispatches": win["dispatches"]}
                log(f"gang submit_many: {GANG_MANY} queries of {GANG_MANY_ROWS} rows, command_batch 2, "
                    f"depth 2: {many_s:.2f} s (serial submits {serial_s:.2f} s), byte-equal, "
                    f"{win['peak_in_flight']} envelopes in flight at peak")
                del serial, many, qs

                # (e) a worker killed mid-job: the gang rebuilds on 1 worker
                rng = np.random.default_rng(SEED + 43)
                kt = {"k": rng.integers(-2**20, 2**20, GANG_KILL_ROWS).astype(np.int32),
                      "v": rng.integers(-1000, 1000, GANG_KILL_ROWS).astype(np.int32)}
                kq = ctx.from_arrays(kt).group_by("k", {"c": ("count", None), "s": ("sum", "v")})
                clean, res["kill_clean"] = gang_job(sub, kq, "group_by (clean)", card)
                mark = len(sub.events.events())
                killer = _kill_mid_job(sub, 1)
                t0 = time.perf_counter()
                again = sub.submit(kq)
                kill_s = time.perf_counter() - t0
                killer.join(timeout=60)
                kinds = _kinds(sub, mark)
                check("gang_member_lost_mid_job" in kinds and "gang_rebuild" in kinds,
                      f"the lost worker was not seen: {sorted(set(kinds))}")
                check(sub.n == 1, f"the gang has {sub.n} workers after the kill")
                check(digest(_sorted_by(again, "k")) == digest(_sorted_by(clean, "k")),
                      "the re-run on 1 worker differs from the clean run")
                res["kill"] = {"job_s": kill_s, "workers_after": sub.n,
                               "launches": worker_launches(sub, mark)}
                log(f"gang kill: worker 1 killed past the start barrier; gang_member_lost_mid_job, "
                    f"gang_rebuild, re-run on 1 worker in {kill_s:.2f} s (clean "
                    f"{res['kill_clean']['job_s']:.2f} s), equal to the clean run")
                res["launches"] = worker_launches(sub, mark0)
                del clean, again, kq, kt, ctx
            finally:
                sub.shutdown()
        res.update(device_idle=busy.idle, device_busy_s=busy.busy_s, wall_s=busy.wall_s)
        res["nccl_two_ranks_one_card"] = nccl = probe.result()
        probe_pool.shutdown()
        log(f"gang: NCCL with two ranks on one card: "
            f"{'accepted' if nccl['accepted'] else 'refused: ' + nccl['message']}")
    except BaseException:  # a failed phase leaves no child running
        world1.kill()
        world1.communicate()
        raise

    rc, stdout, stderr = _finish_child(world1, GANG_CHILD_TIMEOUT_S)
    check(rc == 0, f"the NCCL world-1 run failed: {stderr[-2000:]}")
    info = json.loads(stdout.strip().splitlines()[-1])
    with np.load(out_path, allow_pickle=False) as z:
        out = {c: z[c] for c in z.files}
    res["nccl_world1"] = info
    res["nccl_world1"]["max_abs_err_sum"] = check_dense_gang(out, dense_one, tbl, "NCCL world 1")
    check(info["backend"] == "nccl" and info["world"] == 1 and info["launches"] >= 1,
          f"NCCL world-1 run {info}")
    log(f"gang NCCL world 1 [{card}]: query (a) over a one-rank {info['backend']} group in "
        f"{info['warm_s']:.3f} s warm; {info['collective_bytes']} bytes to the group; "
        f"{info['launches']} bucket kernel launches; keys, counts, int sums byte-equal to one "
        f"process; the Newton do_while over {GANG_DL_ROWS} rows as one CUDA graph with the group's "
        f"collectives, {info['devloop_rounds']} rounds, byte-equal to the loop without a group")

    shape = kernel_shape_report(keys[:GANG_PARTS], [v[:GANG_PARTS] for v in vals],
                                valid[:GANG_PARTS], K)
    log(f"kernel vs plain at a gang worker's shape ({shape['shape']}): byte-equal; kernel "
        f"{shape['kernel_ms']:.3f} ms, plain {shape['plain_ms']:.3f} ms, {shape['library']} "
        f"{shape['library_ms']:.3f} ms, bound {shape['bound_ms']:.4f} ms")
    shutil.rmtree(root, ignore_errors=True)
    free_card()
    res.update(kernel_shapes=[shape], phase_s=time.perf_counter() - t_phase)
    log(f"gang phase [{card}]: {res['phase_s']:.1f} s (workers start {res['workers_start_s']:.2f} s); "
        f"{res['launches']} bucket kernel launches in the workers; card idle {busy.idle:.3f} of "
        f"{busy.wall_s:.1f} s (NVML, every process)")
    return res


def nccl_probe(rank: int, port: int) -> int:
    """Child: rank ``rank`` of a two-rank NCCL group on card 0, one
    all-reduce."""
    import datetime

    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    try:
        t = torch.ones(1, device="cuda") * (rank + 1)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        print(f"ALLREDUCE {int(t.item())}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def nccl_world1(out_path: str) -> int:
    """Child: query (a) in one process whose mesh is a one-rank NCCL group
    (``make_mesh`` takes the initialized group), written to ``out_path``;
    then the devloop phase's Newton do_while at GANG_DL_ROWS rows over the
    same group: one CUDA graph with the group's collectives in it, equal
    to the same loop in a context without a group.  It runs beside the
    gang's jobs, so its warm time shares the card and the host with
    them."""
    import datetime
    import socket

    import torch.distributed as dist

    from dryad_tpu_torch import DryadContext
    from dryad_tpu_torch.ops.bucket import bucket_sum_count

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        ctx = DryadContext(num_partitions_=P)
        check(ctx.mesh.group is not None and ctx.mesh.world == 1, f"mesh {ctx.mesh}")
        q = ctx.from_arrays(_dense_table()).group_by("k", GANG_DENSE_AGGS, dense=DENSE_K)
        q.collect()
        bucket_sum_count.launches = 0
        sent0 = ctx.mesh.sent_bytes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = q.collect()
        warm = time.perf_counter() - t0
        sent = ctx.mesh.sent_bytes - sent0
        np.savez(out_path, **out)
        from dryad_tpu_torch.parallel.mesh import PartitionMesh

        a = np.random.default_rng(SEED + 13).uniform(1.0, 1e6, GANG_DL_ROWS).astype(np.float32)
        t = {"id": np.arange(GANG_DL_ROWS, dtype=np.int32), "a": a, "x": a.copy()}
        loops = []
        for c in (ctx, DryadContext(mesh=PartitionMesh(P, ctx.device))):
            loops.append(c.from_arrays(t).do_while(_dl_body, _dl_cond, max_iter=DL_MAX_ITER).collect())
            kinds = [k for k, _n, _v in c.executor.events if k.startswith("do_while")]
            check(kinds == ["do_while_device_start", "do_while_device_done"], f"do_while events {kinds}")
            check(all(p.graph is not None for p in c.executor._loops.values()), "no graph captured")
        check(digest(loops[0]) == digest(loops[1]), "the loop over the group differs")
        rounds = [v for k, _n, v in ctx.executor.events if k == "do_while_device_done"][0]
        print(json.dumps({"backend": ctx.mesh.backend, "world": ctx.mesh.world, "warm_s": warm,
                          "launches": bucket_sum_count.launches,
                          "collective_bytes": sent, "devloop_rounds": rounds}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def loopctl_line(dl) -> dict:
    """The loop-control kernel's entry of the kernels line (the devloop
    phase's numbers; None where it did not run)."""
    lc = (dl or {}).get("loopctl", {})
    return {
        "name": "loop_step",
        "route": "cuda",
        "source": "dryad_tpu_torch/ops/csrc/loop_control.cu",
        "replaces": "none: dryad_tpu/exec/executor.py:1551 (the lax.while_loop condition and carry update)",
        "launches": (dl or {}).get("loopctl_launches"),
        "max_abs_err": lc.get("max_abs_err"),
        "ms": lc.get("kernel_ms"),
        "plain_ms": lc.get("plain_ms"),
        "bound_ms": lc.get("bound_ms"),
        "bound_by": lc.get("bound_by", "bytes"),
        "library_ms": None,
        "note": "launch-bound: one thread, 75 bytes; bound_ms is the work's, not the launch's",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--phases",
        default="lint,env,kernel,wordcount,dense,terasort,terasort_hot,groupby_sort,programs,"
                "hybrid,groupby_sort_fused,join_shuffle,join_broadcast,pagerank,devloop,decomposable,"
                "ordered_ops,cpu_parity,stores,stream,serve,cluster,gang,rewrite,fleet,obs")
    # the gang phase's child processes (not for direct use)
    ap.add_argument("--nccl-probe", nargs=2, type=int, metavar=("RANK", "PORT"), help=argparse.SUPPRESS)
    ap.add_argument("--nccl-world1", metavar="OUT", help=argparse.SUPPRESS)
    ap.add_argument("--terasort-capacity", nargs=3, metavar=("MODE", "ROWS", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    _PG["keep"] = "programs" in phases
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    if args.nccl_probe:
        return nccl_probe(*args.nccl_probe)
    if args.nccl_world1:
        return nccl_world1(args.nccl_world1)
    if args.terasort_capacity:
        mode, rows, out = args.terasort_capacity
        return terasort_capacity_child(mode, int(rows), out)
    dev = torch.device("cuda", 0)
    card = card_line()
    results = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    wall = results["phase_wall_s"] = {}
    if "lint" in phases:  # first: a dirty tree fails before the build
        t0 = time.perf_counter()
        results["lint"] = phase_lint(card)
        wall["lint"] = time.perf_counter() - t0
        log(f"phase lint: {wall['lint']:.1f} s")
    results["env"] = phase_env(card)  # always: the build is needed by every phase
    steps = (
        ("kernel", lambda: phase_kernel(dev)),
        ("wordcount", lambda: phase_wordcount(dev, card)),
        ("dense", lambda: phase_dense(dev, card)),
        ("terasort", lambda: phase_terasort(dev, card, TS_ROWS, hot=False)),
        ("terasort_hot", lambda: phase_terasort(dev, card, TS_HOT_ROWS, hot=True)),
        ("groupby_sort", lambda: phase_groupby_sort(dev, card)),
        ("programs", lambda: phase_programs(dev, card)),
        ("hybrid", lambda: phase_hybrid(dev, card)),
        ("groupby_sort_fused", lambda: phase_groupby_sort_fused(dev, card)),
        ("join_shuffle", lambda: phase_join_shuffle(dev, card)),
        ("join_broadcast", lambda: phase_join_broadcast(dev, card)),
        ("pagerank", lambda: phase_pagerank(dev, card)),
        ("devloop", lambda: phase_devloop(dev, card)),
        ("decomposable", lambda: phase_decomposable(dev, card)),
        ("ordered_ops", lambda: phase_ordered_ops(dev, card)),
        ("cpu_parity", lambda: phase_cpu_parity(dev, card)),
        ("stores", lambda: phase_stores(dev, card)),
        ("stream", lambda: phase_stream(dev, card)),
        ("serve", lambda: phase_serve(dev, card)),
        ("cluster", lambda: phase_cluster(dev, card)),
        ("gang", lambda: phase_gang(dev, card)),
        ("rewrite", lambda: phase_rewrite(dev, card)),
        ("fleet", lambda: phase_fleet(dev, card)),
        ("obs", lambda: phase_obs(dev, card)),
        ("terasort_capacity", lambda: phase_terasort_capacity(dev, card)),
    )
    _PG["ran"] = ran = []
    for name, run in steps:
        if name in phases:
            t0 = time.perf_counter()
            results[name] = run()
            ran.append(name)
            wall[name] = time.perf_counter() - t0
            log(f"phase {name}: {wall[name]:.1f} s")
    print("results: " + json.dumps(results))

    kern = results.get("kernel", {})
    # launches on each main path that ran, each counted from 0 just
    # before its queries and read just after
    per_path = {
        "wordcount": results.get("wordcount", {}).get("launches"),
        "hybrid": results.get("hybrid", {}).get("launches"),
        "dense": results.get("dense", {}).get("launches"),
        "programs": results.get("programs", {}).get("launches"),
        "join_broadcast": results.get("join_broadcast", {}).get("bucket_sum_count_launches"),
        "pagerank": results.get("pagerank", {}).get("bucket_sum_count_launches"),
        "decomposable": results.get("decomposable", {}).get("bucket_sum_count_launches"),
        "ordered_ops": results.get("ordered_ops", {}).get("bucket_sum_count_launches"),
        "stores": results.get("stores", {}).get("wordcount", {}).get("launches"),
        "stream": results.get("stream", {}).get("launches"),
        "serve": results.get("serve", {}).get("launches"),
        "cluster": results.get("cluster", {}).get("launches"),
        "gang": results.get("gang", {}).get("launches"),
        "rewrite": results.get("rewrite", {}).get("launches"),
        "fleet": results.get("fleet", {}).get("launches"),
        "obs": results.get("obs", {}).get("launches"),
    }
    ran = [n for n in per_path.values() if n is not None]
    jb = kern.get("join_broadcast", {})
    line = {"kernels": [{
        "name": "bucket_sum_count",
        "route": "cuda",
        "source": "dryad_tpu_torch/ops/csrc/bucket_sum_count.cu",
        "replaces": "dryad_tpu/ops/pallas_bucket.py:156",
        "tpu": "dryad_tpu/ops/pallas_bucket.py::_make_kernel",
        "launches": sum(ran) if ran else None,
        "launches_by_path": per_path,
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
        "hot_key_plain_ms": kern.get("hot_key", {}).get("plain_ms"),
        "hot_key_library_ms": kern.get("hot_key", {}).get("library_ms"),
        "hot_key_bound_ms": kern.get("hot_key", {}).get("bound_ms"),
        "join_broadcast_kernel_ms": jb.get("kernel_ms"),
        "join_broadcast_plain_ms": jb.get("plain_ms"),
        "join_broadcast_library_ms": jb.get("library_ms"),
        "join_broadcast_bound_ms": jb.get("bound_ms"),
        "stream_shapes": results.get("stream", {}).get("wordcount", {}).get("kernel_shapes"),
        "serve_shapes": results.get("serve", {}).get("kernel_shapes"),
        "cluster_shapes": results.get("cluster", {}).get("kernel_shapes"),
        "gang_shapes": results.get("gang", {}).get("kernel_shapes"),
        "hybrid_shapes": [results["hybrid"]["wordcount"]["kernel_shape"]] if "hybrid" in results else None,
        "rewrite_shapes": results.get("rewrite", {}).get("kernel_shapes"),
        "fleet_shapes": results.get("fleet", {}).get("kernel_shapes"),
        "obs_shapes": results.get("obs", {}).get("kernel_shapes"),
    }, loopctl_line(results.get("devloop"))]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
