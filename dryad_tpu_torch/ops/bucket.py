"""Dense-key bucket reduction: the Hopper kernel's wrapper and its plain
PyTorch version.

The counterpart of ``dryad_tpu/ops/pallas_bucket.py``.  The reference
launches its one Pallas TPU kernel (``_make_kernel``, a factorised
one-hot bf16 product on the MXU) through ``pl.pallas_call``; here
:func:`bucket_sum_count` launches the hand-written CUDA kernel in
``ops/csrc/bucket_sum_count.cu`` (design, determinism and what bounds
it are set out at the top of that file).

Contract (what ``exec.kernels._k_group_reduce_dense`` relies on), over a
``(P, cap)`` layout in ONE launch, partitions never pooled:

- ``keys`` int32, ``valid`` bool, value columns int32 or float32, all
  ``(P, cap)`` contiguous on one device; the caller masks rows whose key
  is outside ``[0, num_buckets)`` out of ``valid`` (such rows are
  dropped here, never clipped into a bucket);
- returns ``([sum per value column], counts)``, each ``(P, num_buckets)``
  float32: counts exact; integer sums exact while a bucket's partition
  total stays <= 2^24; float sums accumulate in f32 (within the
  reference's ~2^-16-per-element bound);
- deterministic: the same inputs give the same bytes.

The reference's measured strategy choice (``_default_strategy``,
``PROBE_TPU.json``) is not carried over: on the card the dense path
always runs the kernel.  On a CPU tensor the wrapper runs
:func:`bucket_sum_count_plain`; on a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Sequence, Tuple

import torch

from dryad_tpu_torch.utils import build as B

SOURCES = ("ops/csrc/bucket_sum_count.cu",)
LIB_NAME = "dryadbucket"

# Geometry from the on-card sweep (tools/sweep_bucket.py): 16 warps a
# block and two blocks an SM were fastest at both shapes the paths use.
THREADS = 512
SMEM_BUDGET = 100 * 1024  # two blocks per SM (227 KB usable each)
TARGET_BLOCKS = 4 * 132  # four waves' worth of blocks on 132 SMs
MIN_WARP_STEPS = 8  # each warp walks at least this many 32-row steps

_lib = None
_lock = threading.Lock()


def _kernel_lib() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(B.build(LIB_NAME, SOURCES, cuda=True))
            vp = ctypes.c_void_p
            lib.dn_bucket_sum_count.restype = ctypes.c_int
            lib.dn_bucket_sum_count.argtypes = [
                vp, vp, ctypes.POINTER(vp), ctypes.c_uint, ctypes.c_int,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                vp, vp, vp, vp, vp,
            ]
            lib.dn_bucket_max_vals.restype = ctypes.c_int
            lib.dn_cuda_error_string.restype = ctypes.c_char_p
            lib.dn_cuda_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return _lib


def launch_geometry(P: int, cap: int, num_buckets: int, m: int) -> Tuple[int, int, int]:
    """``(tile, n_chunks, chunk_rows)`` for one launch: the bucket tile
    is as wide as shared memory allows (one uint32 count table per block
    plus one f32 table per warp and value column); rows are cut into
    chunks until the grid has about ``TARGET_BLOCKS`` blocks."""
    warps = THREADS // 32
    tile = SMEM_BUDGET // (4 * (1 + warps * m)) // 32 * 32
    tile = max(32, min(tile, -(-num_buckets // 32) * 32))
    n_tiles = -(-num_buckets // tile)
    step = THREADS  # rows one block covers per step (all warps)
    max_chunks = max(1, cap // (step * MIN_WARP_STEPS))
    n_chunks = min(max_chunks, max(1, -(-TARGET_BLOCKS // (n_tiles * P))), 65535)
    per_chunk = -(-cap // n_chunks)
    chunk_rows = max(step, -(-per_chunk // step) * step)
    n_chunks = max(1, -(-cap // chunk_rows))
    return tile, n_chunks, chunk_rows


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
    m = len(values)
    if m > lib.dn_bucket_max_vals():
        raise ValueError(f"bucket_sum_count: at most {lib.dn_bucket_max_vals()} value columns")
    for t in (keys, valid, *values):
        if not t.is_contiguous():
            raise ValueError("bucket_sum_count: inputs must be contiguous")
    P, cap = keys.shape
    Kp = int(num_buckets)
    tile, n_chunks, chunk_rows = launch_geometry(P, cap, Kp, m)
    dev = keys.device
    pcnt = torch.empty((P, n_chunks, Kp), dtype=torch.int32, device=dev)
    psum = torch.empty((m, P, n_chunks, Kp), dtype=torch.float32, device=dev)
    cnt = torch.empty((P, Kp), dtype=torch.float32, device=dev)
    sums = torch.empty((m, P, Kp), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * max(1, m))(*[v.data_ptr() for v in values])
    int_mask = sum(1 << j for j, v in enumerate(values) if v.dtype == torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.dn_bucket_sum_count(
            keys.data_ptr(), valid.data_ptr(), ptrs, int_mask, m, P, cap, Kp,
            tile, n_chunks, chunk_rows, THREADS,
            pcnt.data_ptr(), psum.data_ptr() if m else None,
            cnt.data_ptr(), sums.data_ptr() if m else None, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"bucket_sum_count launch failed: {lib.dn_cuda_error_string(err).decode()}"
        )
    bucket_sum_count.launches += 1
    return list(sums.unbind(0)), cnt


bucket_sum_count.launches = 0  # kernel launches (plain CPU runs not counted)


def bucket_sum_count_plain(
    keys: torch.Tensor,
    values: Sequence[torch.Tensor],
    valid: torch.Tensor,
    num_buckets: int,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The same function in plain PyTorch: ``index_add_`` into
    ``(P, Kp + 1)`` tables whose last column is a dropped sentinel for
    masked rows.  Used on the CPU and as the card's comparison."""
    P, cap = keys.shape
    Kp = int(num_buckets)
    dev = keys.device
    live = valid & (keys >= 0) & (keys < Kp)
    row0 = torch.arange(P, device=dev).reshape(P, 1) * (Kp + 1)
    flat = (torch.where(live, keys.long(), Kp) + row0).reshape(-1)
    live_f = live.reshape(-1).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def table(w: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(P * (Kp + 1), dtype=torch.float32, device=dev)
        out.index_add_(0, flat, w)
        return out.reshape(P, Kp + 1)[:, :Kp]

    sums = [
        table(torch.where(live, v.to(torch.float32), zero).reshape(-1))
        for v in values
    ]
    return sums, table(live_f)
