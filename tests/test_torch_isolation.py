"""The port stands alone: importing dryad_tpu_torch loads neither jax nor
the JAX package, no module of it (nor chip_smoke.py) imports them, and
its entry point never picks the CPU by itself."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "dryad_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "dryad_tpu")


def _forbidden(name: str) -> bool:
    # "dryad_tpu_torch" must not match "dryad_tpu": compare whole dotted heads
    return name.split(".")[0] in FORBIDDEN


def _port_files():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_forbidden_match_is_exact():
    assert _forbidden("dryad_tpu") and _forbidden("dryad_tpu.ops.sort")
    assert _forbidden("jax.numpy")
    assert not _forbidden("dryad_tpu_torch") and not _forbidden("dryad_tpu_torch.ops")


def test_no_module_imports_jax_or_the_jax_package():
    bad = []
    for path in _port_files():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            elif (
                isinstance(node, ast.Call)
                and getattr(node.func, "attr", getattr(node.func, "id", None))
                in ("import_module", "__import__")
                and node.args and isinstance(node.args[0], ast.Constant)
            ):
                names = [str(node.args[0].value)]
            bad += [f"{path}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert not bad, bad


def test_import_in_fresh_process_loads_no_jax():
    code = (
        "import sys, dryad_tpu_torch, dryad_tpu_torch.interop\n"
        "import dryad_tpu_torch.ops.bucket, dryad_tpu_torch.exec.executor\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_context_without_gpu_raises(monkeypatch):
    import torch

    import dryad_tpu_torch as T

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.DryadContext()
    assert T.DryadContext(device="cpu").device.type == "cpu"
