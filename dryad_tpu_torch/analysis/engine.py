"""Repo-level graftlint runner.

Locates the working tree from the installed package (the repo root is
the parent of the ``dryad_tpu_torch`` package directory), builds a
:class:`~dryad_tpu_torch.analysis.core.Project` over ``dryad_tpu_torch/``
and ``tests/test_torch_*.py``, and runs the registry.  This is what the
CLI, the tier-1 test, ``tools/explain.py::explain_lint`` and the
``lint`` phase of ``chip_smoke.py`` all call.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Optional

import dryad_tpu_torch
from dryad_tpu_torch.analysis.core import Project, Report, run


def repo_root() -> Path:
    return Path(dryad_tpu_torch.__file__).resolve().parent.parent


def load_project(root: Optional[Path] = None) -> Project:
    return Project.from_root(Path(root) if root else repo_root())


def run_repo(
    rules: Optional[Iterable[str]] = None,
    root: Optional[Path] = None,
) -> Report:
    return run(load_project(root), rules=rules)
