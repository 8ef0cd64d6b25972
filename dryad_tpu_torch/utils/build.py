"""Build step for the port's native code: the CUDA kernels (``nvcc`` for
``sm_90a``), the host tokenizer and the host I/O routines (the system
C++ compiler; the I/O library links zlib).

Each library is compiled at first use from the sources in the checkout
into ``dryad_tpu_torch/_build/`` (listed in ``.gitignore``), named by a
digest of its sources and flags, so an edited source never loads a
stale build.  The output is written under a temporary name and renamed
into place, so concurrent builders (test workers, parallel smoke
phases) never see a half-written library.  Sources expose a plain C
interface and are loaded with ``ctypes``; no PyTorch header is
compiled, which keeps a build to seconds.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")

CUDA_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-Wall")

_lock = threading.Lock()


class BuildError(RuntimeError):
    """A native library could not be compiled (no compiler, or errors)."""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise BuildError("nvcc not found (PATH or /usr/local/cuda/bin)")


def _cxx() -> str:
    for name in ("c++", "g++", "clang++"):
        found = shutil.which(name)
        if found:
            return found
    raise BuildError("no C++ compiler found (c++, g++ or clang++)")


def _sources(rel: Sequence[str]) -> List[str]:
    return [os.path.join(PKG_DIR, r) for r in rel]


def library_path(name: str, sources: Sequence[str], cuda: bool, libs: Sequence[str] = ()) -> str:
    """Where the build of ``sources`` (paths relative to the package)
    lives: the name carries a digest of the sources, flags and link
    libraries."""
    h = hashlib.sha1(" ".join((*(CUDA_FLAGS if cuda else CXX_FLAGS), *libs)).encode())
    for path in _sources(sources):
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _command(out: str, sources: Sequence[str], cuda: bool, libs: Sequence[str]) -> List[str]:
    if cuda:
        return [_nvcc(), *CUDA_FLAGS, "-o", out, *_sources(sources), *libs]
    return [_cxx(), *CXX_FLAGS, "-o", out, *_sources(sources), *libs]


def build_many(specs: Dict[str, tuple]) -> Dict[str, str]:
    """Build every ``name -> (sources, cuda[, libs])`` spec not built
    yet, all compilers started together; returns ``name -> library
    path``.  ``libs``: link flags after the sources (``-lz``).  Raises
    :class:`BuildError` with the compiler's output on failure."""
    specs = {n: (tuple(s[0]), s[1], tuple(s[2]) if len(s) > 2 else ()) for n, s in specs.items()}
    paths = {n: library_path(n, s, c, l) for n, (s, c, l) in specs.items()}
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for name, (sources, cuda, libs) in specs.items():
            out = paths[name]
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
            proc = subprocess.Popen(
                _command(tmp, sources, cuda, libs),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
            procs.append((name, proc, tmp, out))
        failed = []
        for name, proc, tmp, out in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log.decode(errors='replace')}")
                if os.path.exists(tmp):
                    os.remove(tmp)
            else:
                os.replace(tmp, out)
        if failed:
            raise BuildError("native build failed: " + "\n".join(failed))
    return paths


def build(name: str, sources: Sequence[str], cuda: bool, libs: Sequence[str] = ()) -> str:
    """Build (or find) one library; returns its path."""
    return build_many({name: (tuple(sources), cuda, tuple(libs))})[name]
