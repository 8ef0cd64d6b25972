"""Checker: serving-tier layering contract.

``serve-layering``: the serving tier sits ABOVE the engine, so the
dependency arrows only point down —

- engine layers (``exec/``, ``plan/``, ``ops/``, ``redundancy/``,
  ``parallel/``, ``columnar/``, ``cluster/``) must never import
  ``dryad_tpu_torch.serve`` (a resident service is a client of the engine,
  never a dependency of it);
- ``serve/`` reaches devices only through the ``api``/``exec`` public
  entry points: its dryad imports stay inside ``api``/``exec``/
  ``obs``/``utils``/``cluster``/``serve``, and it never imports
  ``torch`` directly (direct device access would bypass the
  driver-thread ownership the whole tier is built around).
  ``cluster`` is allowed for the TRANSPORT only — the fleet front
  door rides the ProcessService mailbox — and stays legal because
  ``cluster/`` itself never imports ``serve/`` (direction 1).

Anchor: ``serve/service.py`` must define :class:`QueryService` — if
the class moves, the scan reports the lost anchor instead of silently
passing.
"""

from __future__ import annotations

import ast
from typing import Iterator, Tuple

from dryad_tpu_torch.analysis import astutil
from dryad_tpu_torch.analysis.core import Checker, Finding, Project, register

SERVE_PREFIX = "dryad_tpu_torch/serve/"
SERVICE_PATH = "dryad_tpu_torch/serve/service.py"
SERVICE_CLASS = "QueryService"

# engine layers that must never depend on the serving tier
_ENGINE_PREFIXES: Tuple[str, ...] = (
    "dryad_tpu_torch/exec/",
    "dryad_tpu_torch/plan/",
    "dryad_tpu_torch/ops/",
    "dryad_tpu_torch/redundancy/",
    "dryad_tpu_torch/parallel/",
    "dryad_tpu_torch/columnar/",
    "dryad_tpu_torch/cluster/",
)

# dryad_tpu_torch.* module prefixes serve/ files may import (cluster: the
# fleet transport — mailbox/HTTP envelopes — not engine internals)
_SERVE_ALLOWED: Tuple[str, ...] = (
    "dryad_tpu_torch.api",
    "dryad_tpu_torch.exec",
    "dryad_tpu_torch.obs",
    "dryad_tpu_torch.utils",
    "dryad_tpu_torch.cluster",
    "dryad_tpu_torch.serve",
    "dryad_tpu_torch.views",
)


def _imports(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module, node.lineno


@register
class ServeLayeringChecker(Checker):
    rule = "serve-layering"
    summary = (
        "engine layers never import serve/; serve/ reaches devices "
        "only via api/exec entry points (no direct torch, no engine "
        "internals outside the allowed layers)"
    )
    hint = (
        "the service is a client of the engine: route device access "
        "through DryadContext/exec public surfaces"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        # direction 1: engine must not know the service exists
        for src in project.iter(_ENGINE_PREFIXES):
            for mod, ln in _imports(src.tree):
                if mod == "dryad_tpu_torch.serve" or mod.startswith(
                    "dryad_tpu_torch.serve."
                ):
                    yield self.finding(
                        src.rel,
                        ln,
                        f"engine layer imports {mod} — the serving "
                        "tier is a client of the engine, never a "
                        "dependency of it",
                    )
        # direction 2: serve/ stays on the public entry points
        for src in project.iter((SERVE_PREFIX,)):
            for mod, ln in _imports(src.tree):
                root = mod.split(".")[0]
                if root == "torch":
                    yield self.finding(
                        src.rel,
                        ln,
                        f"serve/ imports {mod} — device access only "
                        "through api/exec public entry points",
                    )
                elif root == "dryad_tpu_torch" and not any(
                    mod == p or mod.startswith(p + ".")
                    for p in _SERVE_ALLOWED
                ):
                    yield self.finding(
                        src.rel,
                        ln,
                        f"serve/ imports {mod} — outside the allowed "
                        "layers (api/exec/obs/utils/cluster/serve/views)",
                    )
        # anchor: the scan is about QueryService's device discipline
        src = project.file(SERVICE_PATH)
        if src is not None and (
            astutil.find_class(src.tree, SERVICE_CLASS) is None
        ):
            yield self.finding(
                src.rel,
                1,
                f"{SERVICE_CLASS} class not found — the serve-layering "
                "scan lost its anchor",
                hint="re-anchor the scan to the service entry point",
            )
