"""Checker: materialized-view state discipline.

``view-state-discipline``: the views package (``dryad_tpu_torch/views/``)
BUILDS plans and folds host partial state — it never executes, and it
never finalizes partial state outside the snapshot path:

- views/ never imports ``dryad_tpu_torch.cluster`` or ``dryad_tpu_torch.serve``
  (the serve driver imports the registry, not vice versa — a views ->
  serve import is a cycle through ``serve/__init__``);
- views/ never calls an execution surface (``run_to_host`` /
  ``run_to_host_async`` / ``collect`` / ``submit`` / ``to_store``) —
  dispatching the finalize plan belongs to the serve driver, so a
  view read costs dispatches ONLY where the driver accounts for them;
- partial state finalizes only inside :func:`finalize_query` in
  ``views/matview.py`` — a ``group_by`` plan build or a
  ``finalize_fn`` reference anywhere else in views/ is a second,
  unaudited finalization path;
- the engine (``dryad_tpu_torch/`` outside serve/, tools/, analysis/) never
  imports ``dryad_tpu_torch.views`` — views ride ON the engine, the engine
  must not know them.

Anchor drift: if ``finalize_query`` disappears from matview.py the
scan reports the lost anchor instead of silently passing.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Tuple

from dryad_tpu_torch.analysis import astutil
from dryad_tpu_torch.analysis.core import Checker, Finding, Project, register

VIEWS_PREFIX = "dryad_tpu_torch/views/"
MATVIEW_PATH = "dryad_tpu_torch/views/matview.py"
FINALIZE_ANCHOR = "finalize_query"

# views/ may import the algebra (api/, exec/, columnar/) — never the
# layers that DRIVE execution
_FORBIDDEN_VIEW_IMPORTS = ("dryad_tpu_torch.cluster", "dryad_tpu_torch.serve")

# call names that execute or move results — the serve driver's job
_EXEC_SURFACES = (
    "run_to_host",
    "run_to_host_async",
    "collect",
    "submit",
    "to_store",
    "_execute_device",
)

# surfaces that finalize partial state: only the anchor may touch them
_FINALIZE_SURFACES = ("group_by", "finalize_fn")

# engine subtrees allowed to import views (serve drives them; tools
# and analysis observe them)
_ENGINE_EXEMPT = (
    "dryad_tpu_torch/serve/",
    "dryad_tpu_torch/tools/",
    "dryad_tpu_torch/analysis/",
    VIEWS_PREFIX,
)


def _call_name(node: ast.Call) -> str:
    f = node.func
    return getattr(f, "attr", None) or getattr(f, "id", "") or ""


@register
class ViewStateDisciplineChecker(Checker):
    rule = "view-state-discipline"
    summary = (
        "views/ never executes, never imports cluster/serve, and "
        "finalizes partial state only inside finalize_query; the "
        "engine never imports views/"
    )
    hint = (
        "fold state on the host, build plans, and let the serve "
        "driver execute them"
    )

    def _anchor_span(
        self, project: Project
    ) -> Tuple[Optional[Tuple[int, int]], Iterator[Finding]]:
        findings = []
        span = None
        mat = project.file(MATVIEW_PATH)
        if mat is not None:
            fn = astutil.find_function(mat.tree, FINALIZE_ANCHOR)
            if fn is None:
                findings.append(
                    self.finding(
                        mat.rel,
                        1,
                        f"{FINALIZE_ANCHOR}() not found — the snapshot-"
                        "path scan lost its anchor",
                        hint="re-anchor the scan to the finalize path",
                    )
                )
            else:
                span = (fn.lineno, fn.end_lineno or fn.lineno)
        return span, iter(findings)

    def check(self, project: Project) -> Iterator[Finding]:
        span, drift = self._anchor_span(project)
        yield from drift
        for src in project.iter((VIEWS_PREFIX,)):
            for node in ast.walk(src.tree):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [(a.name, node.lineno) for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods = [(node.module, node.lineno)]
                for mod, ln in mods:
                    if any(
                        mod == f or mod.startswith(f + ".")
                        for f in _FORBIDDEN_VIEW_IMPORTS
                    ):
                        yield self.finding(
                            src.rel,
                            ln,
                            f"imports {mod} — views build plans for the "
                            "driver, they never reach into it",
                        )
                if not isinstance(node, ast.Call):
                    continue
                name = _call_name(node)
                if name in _EXEC_SURFACES:
                    yield self.finding(
                        src.rel,
                        node.lineno,
                        f"calls execution surface {name}() — "
                        "dispatching belongs to the serve driver",
                    )
                elif name in _FINALIZE_SURFACES:
                    inside_anchor = (
                        src.rel == MATVIEW_PATH
                        and span is not None
                        and span[0] <= node.lineno <= span[1]
                    )
                    if not inside_anchor:
                        yield self.finding(
                            src.rel,
                            node.lineno,
                            f"{name}() outside {FINALIZE_ANCHOR}() — "
                            "partial state finalizes only on the "
                            "snapshot path",
                        )
        for src in project.iter(("dryad_tpu_torch/",)):
            if src.rel.startswith(_ENGINE_EXEMPT):
                continue
            for node in ast.walk(src.tree):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [(a.name, node.lineno) for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods = [(node.module, node.lineno)]
                for mod, ln in mods:
                    if mod == "dryad_tpu_torch.views" or mod.startswith(
                        "dryad_tpu_torch.views."
                    ):
                        yield self.finding(
                            src.rel,
                            ln,
                            f"engine module imports {mod} — views ride "
                            "on the engine, the engine must not know "
                            "them",
                        )
