"""Checker: runtime plan-rewrite layering contract.

``rewrite-layering``: the rewrite subsystem is a POLICY layer — it
folds diagnosis events into actions the execution drivers poll.  Its
safety argument (every rewrite is byte-identical because the drivers
only ever apply it at chunk/window boundaries) depends on the layer
never touching the machinery itself:

- ``rewrite/`` consumes only the event/diagnosis/plan surfaces: its
  dryad imports stay inside ``obs``/``plan``/``utils``/``rewrite``
  plus the event schema module (``exec.events``); it must never
  import ``cluster/`` (no worker control), any other ``exec``
  internals (no dispatching), nor ``torch`` (no device access — a
  policy decision must stay a pure host-side fold);
- engine layers (``exec/``, ``plan/``, ``ops/``, ``redundancy/``,
  ``parallel/``, ``columnar/``, ``cluster/``) must never import
  ``dryad_tpu_torch.rewrite`` — drivers receive the controller by handle
  (``ctx.rewriter`` / ``executor.rewriter``), so the engine compiles
  and runs with the subsystem deleted.

Anchor: ``rewrite/controller.py`` must define
:class:`RewriteController` — if the class moves, the scan reports the
lost anchor instead of silently passing.
"""

from __future__ import annotations

import ast
from typing import Iterator, Tuple

from dryad_tpu_torch.analysis import astutil
from dryad_tpu_torch.analysis.core import Checker, Finding, Project, register

REWRITE_PREFIX = "dryad_tpu_torch/rewrite/"
CONTROLLER_PATH = "dryad_tpu_torch/rewrite/controller.py"
CONTROLLER_CLASS = "RewriteController"

# engine layers that must never depend on the policy layer
_ENGINE_PREFIXES: Tuple[str, ...] = (
    "dryad_tpu_torch/exec/",
    "dryad_tpu_torch/plan/",
    "dryad_tpu_torch/ops/",
    "dryad_tpu_torch/redundancy/",
    "dryad_tpu_torch/parallel/",
    "dryad_tpu_torch/columnar/",
    "dryad_tpu_torch/cluster/",
)

# dryad_tpu_torch.* module prefixes rewrite/ files may import; exec.events
# alone is carved out of exec/ — the schema registry is a data
# surface, not machinery
_REWRITE_ALLOWED: Tuple[str, ...] = (
    "dryad_tpu_torch.obs",
    "dryad_tpu_torch.plan",
    "dryad_tpu_torch.utils",
    "dryad_tpu_torch.rewrite",
    "dryad_tpu_torch.exec.events",
)


def _imports(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module, node.lineno


@register
class RewriteLayeringChecker(Checker):
    rule = "rewrite-layering"
    summary = (
        "engine layers never import rewrite/; rewrite/ consumes only "
        "event/diagnosis/plan surfaces (no cluster, no exec machinery, "
        "no torch)"
    )
    hint = (
        "the rewriter is a policy fold over the event stream: drivers "
        "poll it by handle, it never reaches into the engine"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        # direction 1: the engine runs with the policy layer deleted
        for src in project.iter(_ENGINE_PREFIXES):
            for mod, ln in _imports(src.tree):
                if mod == "dryad_tpu_torch.rewrite" or mod.startswith(
                    "dryad_tpu_torch.rewrite."
                ):
                    yield self.finding(
                        src.rel,
                        ln,
                        f"engine layer imports {mod} — drivers receive "
                        "the rewrite controller by handle, the engine "
                        "never depends on the policy layer",
                    )
        # direction 2: the policy layer stays a pure host-side fold
        for src in project.iter((REWRITE_PREFIX,)):
            for mod, ln in _imports(src.tree):
                root = mod.split(".")[0]
                if root == "torch":
                    yield self.finding(
                        src.rel,
                        ln,
                        f"rewrite/ imports {mod} — a rewrite decision "
                        "must be a pure host-side fold, never device "
                        "access",
                    )
                elif root == "dryad_tpu_torch" and not any(
                    mod == p or mod.startswith(p + ".")
                    for p in _REWRITE_ALLOWED
                ):
                    yield self.finding(
                        src.rel,
                        ln,
                        f"rewrite/ imports {mod} — outside the allowed "
                        "surfaces (obs/plan/utils/rewrite/exec.events)",
                    )
        # anchor: the scan is about RewriteController's layering
        src = project.file(CONTROLLER_PATH)
        if src is not None and (
            astutil.find_class(src.tree, CONTROLLER_CLASS) is None
        ):
            yield self.finding(
                src.rel,
                1,
                f"{CONTROLLER_CLASS} class not found — the "
                "rewrite-layering scan lost its anchor",
                hint="re-anchor the scan to the controller entry point",
            )
