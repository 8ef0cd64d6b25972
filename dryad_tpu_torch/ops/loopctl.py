"""Loop control of the on-device ``do_while``: the Hopper kernel's
wrapper, the WHILE-node graph calls, and the kernel's plain PyTorch
version.

The kernel (``ops/csrc/loop_control.cu``) replaces no TPU kernel: it
computes what the reference's ``lax.while_loop`` condition and carry
update compute (``dryad_tpu/exec/executor.py::_run_do_while_device``),
so that ``exec/devloop.py`` can run a whole loop as one CUDA graph.  One
step updates the loop state ``st`` (int64 ``[i, overflow, miss, pred]``)
in place::

    i        <- i + 1
    overflow <- overflow | body_ovf | cond_ovf
    miss     <- miss + body_miss
    pred     <- (i < max_iter) & go & !overflow

where ``go`` is the condition column's first element (partition 0, row
0), true when nonzero.  With a conditional ``handle`` the kernel also
sets the graph's WHILE node to ``pred``.  On a CPU tensor
:func:`loop_step` runs :func:`loop_step_plain`; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from dryad_tpu_torch.utils import build as B

SOURCES = ("ops/csrc/loop_control.cu",)
LIB_NAME = "dryadloopctl"

# the kernel's go_kind codes
GO_KINDS = {
    torch.bool: 0, torch.uint8: 0, torch.int8: 0,
    torch.int32: 1, torch.int64: 2, torch.float32: 3, torch.float64: 4,
}

_lib = None
_lock = threading.Lock()


def _kernel_lib() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    global _lib  # graftlint: disable=kernel-determinism -- the extension's lazy load: process state set once under the lock, never data a vertex reads
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(B.build(LIB_NAME, SOURCES, cuda=True))
            vp, ci, cll, cull = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
            lib.dl_loop_step.restype = ci
            lib.dl_loop_step.argtypes = [vp, vp, vp, vp, ci, vp, cll, cull, ci, vp]
            lib.dl_handle_create.restype = ci
            lib.dl_handle_create.argtypes = [vp, ctypes.POINTER(cull)]
            lib.dl_while_begin.restype = ci
            lib.dl_while_begin.argtypes = [vp, cull, ctypes.POINTER(vp)]
            lib.dl_while_end.restype = ci
            lib.dl_while_end.argtypes = [vp]
            lib.dl_runtime_version.restype = ci
            lib.dl_runtime_version.argtypes = [ctypes.POINTER(ci)]
            lib.dl_cuda_error_string.restype = ctypes.c_char_p
            lib.dl_cuda_error_string.argtypes = [ci]
            _lib = lib
        return _lib


def _raise(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: {_kernel_lib().dl_cuda_error_string(err).decode()}")


def _check(st, body_ovf, body_miss, go, cond_ovf) -> None:
    if st.dtype != torch.int64 or st.shape != (4,) or not st.is_contiguous():
        raise ValueError(f"loop state must be a contiguous int64 (4,), got {st.dtype} {tuple(st.shape)}")
    if body_ovf.dtype != torch.bool or cond_ovf.dtype != torch.bool:
        raise ValueError("overflow flags must be bool")
    if body_miss.dtype != torch.int64:
        raise ValueError("the miss count must be int64")
    if go.dtype not in GO_KINDS or go.numel() < 1:
        raise ValueError(f"condition column of unsupported type {go.dtype} or empty")
    for t in (body_ovf, body_miss, go, cond_ovf):
        if t.device != st.device:
            raise ValueError("all inputs must lie on one device")


def loop_step(st: torch.Tensor, body_ovf: torch.Tensor, body_miss: torch.Tensor,
              go: torch.Tensor, cond_ovf: torch.Tensor, max_iter: int,
              handle: Optional[int] = None) -> None:
    """One step of the loop state (see the module docstring), in place.
    ``handle``: the WHILE node's conditional handle (CUDA only).  A
    launch inside a graph capture is recorded, not run: the graph's
    replays add their launches (:func:`note_graph_launches`)."""
    _check(st, body_ovf, body_miss, go, cond_ovf)
    if st.device.type == "cpu":
        if handle is not None:
            raise ValueError("loop_step: a conditional handle needs a CUDA graph")
        loop_step_plain(st, body_ovf, body_miss, go, cond_ovf, max_iter)
        return
    if st.device.type != "cuda":
        raise ValueError(f"loop_step: unsupported device {st.device}")
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(st.device).cuda_stream
    with torch.cuda.device(st.device):
        err = lib.dl_loop_step(
            st.data_ptr(), body_ovf.data_ptr(), body_miss.data_ptr(), go.data_ptr(),
            GO_KINDS[go.dtype], cond_ovf.data_ptr(), int(max_iter),
            0 if handle is None else int(handle), int(handle is not None), stream,
        )
    _raise("loop_step launch", err)
    if not torch.cuda.is_current_stream_capturing():
        loop_step.launches += 1


loop_step.launches = 0  # kernel launches (plain CPU runs not counted)


def note_graph_launches(n: int) -> None:
    """A graph replay ran the recorded kernel ``n`` times."""
    loop_step.launches += int(n)


def loop_step_plain(st: torch.Tensor, body_ovf: torch.Tensor, body_miss: torch.Tensor,
                    go: torch.Tensor, cond_ovf: torch.Tensor, max_iter: int) -> None:
    """The same step in plain PyTorch (on the CPU, and the card's
    comparison)."""
    g = go[(0,) * go.dim()] != 0
    i = st[0] + 1
    ovf = st[1] | body_ovf.to(torch.int64) | cond_ovf.to(torch.int64)
    miss = st[2] + body_miss
    pred = (i < int(max_iter)) & g & (ovf == 0)
    st.copy_(torch.stack([i, ovf, miss, pred.to(torch.int64)]))


# -- the WHILE node ---------------------------------------------------------------

def runtime_version() -> int:
    """The CUDA runtime version the kernel library was built against."""
    v = ctypes.c_int(0)
    _raise("cudaRuntimeGetVersion", _kernel_lib().dl_runtime_version(ctypes.byref(v)))
    return v.value


def handle_create(stream: int) -> int:
    """A conditional handle of the graph ``stream`` is capturing."""
    h = ctypes.c_ulonglong(0)
    _raise("cudaGraphConditionalHandleCreate", _kernel_lib().dl_handle_create(stream, ctypes.byref(h)))
    return h.value


def while_begin(stream: int, handle: int) -> int:
    """Add a WHILE node on ``handle`` to the graph ``stream`` is
    capturing (it follows the capture's current work, and later work
    follows it) and start capturing its body on a new stream; returns
    that stream."""
    out = ctypes.c_void_p(0)
    _raise("WHILE node capture", _kernel_lib().dl_while_begin(stream, handle, ctypes.byref(out)))
    return out.value


def while_end(body_stream: int) -> None:
    """End the body's capture and destroy its stream."""
    _raise("WHILE body capture end", _kernel_lib().dl_while_end(body_stream))
