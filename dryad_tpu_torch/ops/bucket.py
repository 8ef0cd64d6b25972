"""Dense-key bucket reduction: the Hopper kernel's wrapper and its plain
PyTorch version.

The counterpart of ``dryad_tpu/ops/pallas_bucket.py``.  The reference
launches its one Pallas TPU kernel (``_make_kernel``, a factorised
one-hot bf16 product on the MXU) through ``pl.pallas_call``; here
:func:`bucket_sum_count` launches the hand-written CUDA kernels in
``ops/csrc/bucket_sum_count.cu`` (design, determinism and what bounds
them are set out at the top of that file).

Contract (what ``exec.kernels._k_group_reduce_dense`` relies on), over a
``(P, cap)`` layout in ONE launch, partitions never pooled:

- ``keys`` int32, ``valid`` bool, value columns int32 or float32, all
  ``(P, cap)`` contiguous on one device, ``cap <= 2^24``; the caller
  masks rows whose key is outside ``[0, num_buckets)`` out of ``valid``
  (such rows are dropped here, never clipped into a bucket);
- returns ``([sum per value column], counts)``, each ``(P, num_buckets)``
  float32: counts exact; integer sums accumulate in int64 and are
  rounded once to f32 (exact while a bucket's partition total stays
  <= 2^24); float sums accumulate in fixed point against the bucket's
  largest exponent and are rounded once (within 2^-46 of sum |v| before
  that rounding; NaN and +-Inf per bucket as IEEE addition gives them);
- deterministic: every sum is an integer sum, so the same rows in any
  order give the same bytes, and the kernel equals
  :func:`bucket_sum_count_plain` byte for byte.

The reference's measured strategy choice (``_default_strategy``,
``PROBE_TPU.json``) is not carried over: on the card the dense path
always runs the kernel.  On a CPU tensor the wrapper runs
:func:`bucket_sum_count_plain`; on a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from dryad_tpu_torch.utils import build as B

SOURCES = ("ops/csrc/bucket_sum_count.cu",)
LIB_NAME = "dryadbucket"

MAX_ROWS = 1 << 24  # rows a partition (the fixed-point overflow bound)
MAX_VALS = 8
MAX_CLUSTER = 16  # blocks a cluster (above 8: non-portable size on H100)
SMEM_LIMIT = 232448  # shared memory a block may use (227 KB)
FIX_SHIFT = 46  # F - 23 with F = 69 fraction bits
SCALE_BIAS = 196  # 127 + F
ROW_ALIGN = 4  # rows: a lane loads 4 keys as one 16-byte word
CHUNK_ALIGN = 128  # rows: a chunk is whole 128-row groups
LIST_ENTRIES = 160  # a warp's row list (the kernel's DN_LIST), u32 each

# Free parameters of the launch (tools/sweep_bucket.py sweeps them).
# Cluster size of the pass that adds rows (phase 1; None: the smallest
# that holds K in one pass).  The exponent pass (phase 0, float columns
# only) takes the smallest cluster that holds its 4-byte buckets.
CLUSTER: Optional[int] = None
WARPS = 32  # warps a block
TARGET_BLOCKS = 4 * 132  # blocks a launch aims at (four per SM of 132)

_lib = None
_lock = threading.Lock()


def _kernel_lib() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(B.build(LIB_NAME, SOURCES, cuda=True))
            vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.dn_bucket_sum_count.restype = ci
            lib.dn_bucket_sum_count.argtypes = [
                vp, vp, ctypes.POINTER(vp), ctypes.c_uint, ci,
                ci, cll, ci, ctypes.POINTER(cll), ci,
                vp, vp, vp, vp, vp, vp, vp, vp,
            ]
            lib.dn_cuda_error_string.restype = ctypes.c_char_p
            lib.dn_cuda_error_string.argtypes = [ci]
            _lib = lib
        return _lib


class Geometry(NamedTuple):
    cluster: int  # C: blocks a cluster
    block_buckets: int  # T: buckets a block holds
    ranges: int  # bucket passes: the cluster's C*T buckets cover [0, K)
    chunks: int  # row chunks a partition
    chunk_rows: int  # rows a chunk (a multiple of CHUNK_ALIGN)
    threads: int
    list_bytes: int  # the warps' row lists, ahead of the bucket table
    smem_bytes: int  # dynamic shared memory a block


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def bucket_bytes(n_int: int, n_float: int, phase: int = 1) -> int:
    """Shared-memory bytes a bucket needs.  Phase 1: u32 count, int64 per
    int column, two 64-bit words and an exponent byte per float column;
    phase 0: a u32 exponent per float column."""
    return 4 * n_float if phase == 0 else 4 + 8 * n_int + 17 * n_float


def launch_geometry(
    P: int, cap: int, num_buckets: int, n_int: int, n_float: int,
    cluster: Optional[int] = None, phase: int = 1,
) -> Geometry:
    """The launch for ``P`` partitions of ``cap`` rows (a multiple of
    ``ROW_ALIGN``) and ``num_buckets`` buckets: after the warps' row
    lists, a block's shared memory holds its bucket table; the cluster
    is the smallest power of two whose blocks hold every bucket (at most
    ``MAX_CLUSTER``, then bucket passes); rows are cut into chunks until
    the grid has about ``TARGET_BLOCKS``."""
    if cap % ROW_ALIGN or cap < 1 or num_buckets < 1:
        raise ValueError(f"launch_geometry: bad cap {cap} or num_buckets {num_buckets}")
    if phase == 0 and n_float == 0:
        raise ValueError("launch_geometry: the exponent pass needs a float column")
    if phase == 1:
        cluster = cluster or CLUSTER
    threads = 32 * WARPS
    lists = WARPS * LIST_ENTRIES * 4
    bb = bucket_bytes(n_int, n_float, phase)
    t_max = (SMEM_LIMIT - lists) // bb // 8 * 8
    if cluster is not None:
        C = int(cluster)
        if C < 1 or C > MAX_CLUSTER:
            raise ValueError(f"cluster size {C} outside [1, {MAX_CLUSTER}]")
    else:
        C = 1
        while C < MAX_CLUSTER and C * t_max < num_buckets:
            C *= 2
    ranges = -(-num_buckets // (C * t_max))
    T = _round_up(-(-num_buckets // (C * ranges)), 8)
    max_chunks = max(1, -(-cap // (CHUNK_ALIGN * C)))
    chunks = min(max_chunks, max(1, -(-TARGET_BLOCKS // (P * ranges * C))), 65535 // ranges)
    chunk_rows = _round_up(-(-cap // chunks), CHUNK_ALIGN)
    chunks = -(-cap // chunk_rows)
    return Geometry(C, T, ranges, chunks, chunk_rows, threads, lists, lists + T * bb)


def _check(keys, values, valid, num_buckets) -> None:
    if keys.dim() != 2 or keys.dtype != torch.int32:
        raise ValueError(f"keys must be (P, cap) int32, got {keys.dtype} {tuple(keys.shape)}")
    if valid.dtype != torch.bool or valid.shape != keys.shape:
        raise ValueError("valid must be a bool tensor shaped like keys")
    for v in values:
        if v.dtype not in (torch.int32, torch.float32) or v.shape != keys.shape:
            raise ValueError(
                f"value columns must be int32/float32 shaped like keys, got "
                f"{v.dtype} {tuple(v.shape)}"
            )
    for t in (valid, *values):
        if t.device != keys.device:
            raise ValueError("all inputs must lie on one device")
    if num_buckets < 1:
        raise ValueError("num_buckets must be >= 1")
    if len(values) > MAX_VALS:
        raise ValueError(f"bucket_sum_count: at most {MAX_VALS} value columns")
    if keys.shape[1] > MAX_ROWS:
        raise ValueError(
            f"bucket_sum_count: {keys.shape[1]} rows a partition exceed {MAX_ROWS}"
        )


def _aligned(t: torch.Tensor, cap_a: int) -> torch.Tensor:
    """``t`` as a contiguous ``(P, cap_a)`` tensor on a 16-byte aligned
    base, padded with zeros (False for the mask) past ``cap``."""
    P, cap = t.shape
    if cap == cap_a and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    out = torch.zeros((P, cap_a), dtype=t.dtype, device=t.device)
    out[:, :cap] = t
    return out


def bucket_sum_count(
    keys: torch.Tensor,
    values: Sequence[torch.Tensor],
    valid: torch.Tensor,
    num_buckets: int,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Per-partition, per-bucket sums of each value column and row
    counts (see the module docstring for the contract)."""
    _check(keys, values, valid, num_buckets)
    if keys.device.type == "cpu":
        return bucket_sum_count_plain(keys, values, valid, num_buckets)
    if keys.device.type != "cuda":
        raise ValueError(f"bucket_sum_count: unsupported device {keys.device}")
    lib = _kernel_lib()
    P, cap = keys.shape
    cap_a = _round_up(cap, ROW_ALIGN)
    keys, valid = _aligned(keys, cap_a), _aligned(valid, cap_a)
    values = [_aligned(v, cap_a) for v in values]
    m = len(values)
    is_int = [v.dtype == torch.int32 for v in values]
    ni = sum(is_int)
    nf = m - ni
    K = int(num_buckets)
    gs = [launch_geometry(P, cap_a, K, ni, nf, phase=0) if nf else None,
          launch_geometry(P, cap_a, K, ni, nf)]
    geo = (ctypes.c_longlong * 12)(*[
        x for g in gs for x in (
            (g.cluster, g.block_buckets, g.ranges, g.chunks, g.chunk_rows, g.smem_bytes)
            if g else (0,) * 6)
    ])
    dev = keys.device
    E = torch.ones((max(nf, 1), P, K), dtype=torch.int32, device=dev)
    cnt_g = torch.zeros((P, K), dtype=torch.int32, device=dev)
    isum_g = torch.zeros((max(ni, 1), P, K), dtype=torch.int64, device=dev)
    fhi_g = torch.zeros((max(nf, 1), P, K), dtype=torch.int64, device=dev)
    flo_g = torch.zeros((max(nf, 1), P, K), dtype=torch.int64, device=dev)
    cnt = torch.empty((P, K), dtype=torch.float32, device=dev)
    sums = torch.empty((m, P, K), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * max(1, m))(*[v.data_ptr() for v in values])
    int_mask = sum(1 << j for j, f in enumerate(is_int) if f)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.dn_bucket_sum_count(
            keys.data_ptr(), valid.data_ptr(), ptrs, int_mask, m, P, cap_a, K,
            geo, gs[1].threads, E.data_ptr(), cnt_g.data_ptr(), isum_g.data_ptr(),
            fhi_g.data_ptr(), flo_g.data_ptr(), cnt.data_ptr(),
            sums.data_ptr() if m else None, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"bucket_sum_count launch failed ({gs}): "
            f"{lib.dn_cuda_error_string(err).decode()}"
        )
    bucket_sum_count.launches += 1
    return list(sums.unbind(0)), cnt


bucket_sum_count.launches = 0  # kernel launches (plain CPU runs not counted)


# -- the plain version: the same integer terms, summed with index_add_ -------

_M32 = (1 << 32) - 1


def float_terms(bits: torch.Tensor, eb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 bit patterns (int64 in ``[0, 2^32)``) of finite values and the
    biased exponent of their bucket -> the int64 terms ``(hi, lo)`` of
    ``q = round(v * 2^(69 - E))``, ``hi = floor(q / 2^32)``, ``lo = q mod
    2^32`` (ties away from zero), as the kernel's ``float_terms``."""
    e = (bits >> 23) & 0xFF
    s = torch.where(e == 0, bits & 0x7FFFFF, (bits & 0x7FFFFF) | 0x800000)
    sh = e.clamp(min=1) - eb + FIX_SHIFT
    hi_a = s << (sh - 32).clamp(0, 31)  # sh >= 32
    f = s << sh.clamp(0, 31)  # 0 <= sh < 32
    r = (-sh).clamp(1, 25)  # sh < 0: s < 2^24, so 25 shifts to 0
    lo_c = (s + (1 << (r - 1))) >> r
    hi = torch.where(sh >= 32, hi_a, torch.where(sh >= 0, f >> 32, 0))
    lo = torch.where(sh >= 32, 0, torch.where(sh >= 0, f & _M32, lo_c))
    neg = (bits >> 31) == 1
    hi = torch.where(neg, torch.where(lo != 0, -hi - 1, -hi), hi)
    lo = torch.where(neg & (lo != 0), (1 << 32) - lo, lo)
    return hi, lo


def integer_to_f32(H: torch.Tensor, L: torch.Tensor, scale) -> torch.Tensor:
    """The f32 nearest to ``(H * 2^32 + L) * 2^scale`` (int64 tensors, L
    in ``[0, 2^32)``), by the kernel's steps: cut to 53 bits with a
    sticky bit, exact double, exact power-of-two scale, one rounding."""
    neg = H < 0
    hm = torch.where(neg, torch.where(L != 0, -H - 1, -H), H)
    lm = torch.where(neg & (L != 0), (1 << 32) - L, L)
    small = hm < (1 << 21)
    nb = torch.frexp(hm.to(torch.float64))[1].to(torch.int64)  # bit length, maybe +1
    nb = torch.where((hm >> (nb - 1).clamp(0, 62)) == 0, nb - 1, nb)
    sh = torch.where(small, 0, nb - 21).clamp(0, 41)
    t_lo = (hm << (32 - sh).clamp(0, 31)) | (lm >> sh.clamp(0, 32))
    t_lo = t_lo | ((lm & ((1 << sh.clamp(0, 32)) - 1)) != 0).to(torch.int64)
    t_hi = hm >> (sh - 32).clamp(0, 63)
    t_hi = t_hi | (((hm & ((1 << (sh - 32).clamp(0, 62)) - 1)) | lm) != 0).to(torch.int64)
    t = torch.where(small, (hm << 32) | lm, torch.where(sh <= 32, t_lo, t_hi))
    p2 = ((sh + scale + 1023) << 52).view(torch.float64)
    d = t.to(torch.float64) * p2
    return torch.where(neg, -d, d).to(torch.float32)


def bucket_sum_count_plain(
    keys: torch.Tensor,
    values: Sequence[torch.Tensor],
    valid: torch.Tensor,
    num_buckets: int,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The same function in plain PyTorch, computed the same way: the
    kernel's integer terms summed with one int64 ``index_add_`` into
    ``(P * (K + 1), W)`` tables whose last bucket of each partition is a
    dropped sentinel for masked rows, then the kernel's rounding.  Used
    on the CPU and as the card's comparison (equal byte for byte)."""
    P, cap = keys.shape
    K = int(num_buckets)
    dev = keys.device
    live = valid & (keys >= 0) & (keys < K)
    row0 = torch.arange(P, device=dev).reshape(P, 1) * (K + 1)
    flat = (torch.where(live, keys.long(), K) + row0).reshape(-1)

    def table(cols: List[torch.Tensor]) -> torch.Tensor:
        src = torch.stack([c.reshape(-1) for c in cols], 1)
        out = torch.zeros((P * (K + 1), len(cols)), dtype=torch.int64, device=dev)
        out.index_add_(0, flat, src)
        return out.reshape(P, K + 1, len(cols))[:, :K]

    cols = [live.to(torch.int64)]
    exps = []
    for v in values:
        if v.dtype == torch.int32:
            cols.append(torch.where(live, v.long(), 0))
            continue
        bits = v.view(torch.int32).long() & _M32
        e = (bits >> 23) & 0xFF
        fin = live & (e != 0xFF)
        eb = torch.ones(P * (K + 1), dtype=torch.int64, device=dev)
        eb.scatter_reduce_(0, flat, torch.where(fin, e.clamp(min=1), 1).reshape(-1), "amax")
        hi, lo = float_terms(bits, eb[flat].reshape(P, cap))
        nonfin = live & (e == 0xFF)
        frac = bits & 0x7FFFFF
        neg = (bits >> 31) == 1
        cols += [torch.where(fin, hi, 0), torch.where(fin, lo, 0), nonfin & (frac != 0),
                 nonfin & (frac == 0) & ~neg, nonfin & (frac == 0) & neg]
        exps.append(eb.reshape(P, K + 1)[:, :K])
    tab = table([c.to(torch.int64) for c in cols])
    sums, c, f = [], 1, 0
    for v in values:
        if v.dtype == torch.int32:
            s = tab[..., c]
            sums.append(integer_to_f32(s >> 32, s & _M32, 0))
            c += 1
            continue
        hi, lo, nan, pinf, ninf = (tab[..., c + i] for i in range(5))
        out = integer_to_f32(hi + (lo >> 32), lo & _M32, exps[f] - SCALE_BIAS)
        out = torch.where(ninf > 0, torch.tensor(float("-inf"), device=dev), out)
        out = torch.where(pinf > 0, torch.tensor(float("inf"), device=dev), out)
        is_nan = (nan > 0) | ((pinf > 0) & (ninf > 0))
        sums.append(torch.where(is_nan, torch.tensor(float("nan"), device=dev), out))
        c += 5
        f += 1
    return sums, tab[..., 0].to(torch.float32)
