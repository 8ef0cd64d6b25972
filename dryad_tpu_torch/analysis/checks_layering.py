"""Checkers: layering/provenance contracts.

``layer-imports``: ``exec/combinetree.py`` must never
import ``cluster.*`` (the gang driver imports the planner, not vice
versa), and ``redundancy/`` must never import the streaming engine
(``exec.outofcore``) or the cluster layer that drives it.

``placement-snapshot``: combine-tree placement (``place`` /
``plan_groups`` / ``_cosine`` and :class:`CombineTreePlanner`) reads
histogram SNAPSHOT dicts only — never batch payloads (``.data`` /
``.valid`` / ``.to_numpy``) — so routing can never depend on device
readback.

``coded-linearity``: every ``Decomposable(linear=True)`` anywhere in
the package or the test tree must register its identity element — the
coding layer scales states by generator coefficients, which is only
sound when absent keys decode to a true additive zero.  Constructs
inside ``pytest.raises`` blocks are negative tests and exempt.
"""

from __future__ import annotations

import ast
from typing import Iterator, Tuple

from dryad_tpu_torch.analysis import astutil
from dryad_tpu_torch.analysis.core import (
    Checker,
    FileChecker,
    Finding,
    Project,
    SourceFile,
    register,
)
from dryad_tpu_torch.analysis.checks_fusion import COMBINETREE_PATH

# (file-prefix, forbidden-import-prefixes, why)
_LAYER_RULES: Tuple[Tuple[str, Tuple[str, ...], str], ...] = (
    (
        COMBINETREE_PATH,
        ("dryad_tpu_torch.cluster",),
        "the gang driver imports the planner, not vice versa",
    ),
    (
        "dryad_tpu_torch/redundancy/",
        ("dryad_tpu_torch.exec.outofcore", "dryad_tpu_torch.cluster"),
        "redundancy/ must not depend on the streaming engine or the "
        "cluster layer that drives it",
    ),
)

_PAYLOAD_ATTRS = ("data", "valid", "to_numpy")
_PLACEMENT_FNS = ("place", "plan_groups", "_cosine")
_PLANNER_CLASS = "CombineTreePlanner"


@register
class LayerImportsChecker(Checker):
    rule = "layer-imports"
    summary = (
        "combinetree never imports cluster.*; redundancy/ never "
        "imports outofcore or cluster.*"
    )
    hint = "invert the dependency: the higher layer imports the lower"

    def check(self, project: Project) -> Iterator[Finding]:
        for prefix, forbidden, why in _LAYER_RULES:
            for src in project.iter((prefix,)):
                for node in ast.walk(src.tree):
                    mods = []
                    if isinstance(node, ast.Import):
                        mods = [(a.name, node.lineno) for a in node.names]
                    elif isinstance(node, ast.ImportFrom) and node.module:
                        mods = [(node.module, node.lineno)]
                    for mod, ln in mods:
                        if any(mod.startswith(f) for f in forbidden):
                            yield self.finding(
                                src.rel,
                                ln,
                                f"imports {mod} — {why}",
                            )


@register
class PlacementSnapshotChecker(Checker):
    rule = "placement-snapshot"
    summary = (
        "combine-tree placement reads histogram snapshots only, never "
        "batch payloads (.data/.valid/.to_numpy)"
    )
    hint = "base the placement decision on the snapshot dict"

    def check(self, project: Project) -> Iterator[Finding]:
        src = project.file(COMBINETREE_PATH)
        if src is None:
            return
        surfaces = []
        for name in _PLACEMENT_FNS:
            fn = astutil.find_function(src.tree, name)
            if fn is None:
                yield self.finding(
                    src.rel,
                    1,
                    f"placement function {name}() not found — the "
                    "snapshot-only scan lost its anchor",
                    hint="re-anchor the scan to the placement surface",
                )
            else:
                surfaces.append((name, fn))
        planner = astutil.find_class(src.tree, _PLANNER_CLASS)
        if planner is None:
            yield self.finding(
                src.rel,
                1,
                f"{_PLANNER_CLASS} class not found — the snapshot-only "
                "scan lost its anchor",
                hint="re-anchor the scan to the placement surface",
            )
        else:
            surfaces.append((_PLANNER_CLASS, planner))
        for name, node in surfaces:
            for n in ast.walk(node):
                if (
                    isinstance(n, ast.Attribute)
                    and n.attr in _PAYLOAD_ATTRS
                ):
                    yield self.finding(
                        src.rel,
                        n.lineno,
                        f"{name} reads batch payload .{n.attr} — "
                        "placement must depend on snapshots only",
                    )


@register
class CodedLinearityChecker(FileChecker):
    rule = "coded-linearity"
    summary = (
        "every Decomposable(linear=True) registers an identity element"
    )
    hint = "pass identity=<additive zero> or drop linear=True"
    prefixes = ("dryad_tpu_torch/", "tests/")

    def check_file(
        self, src: SourceFile, project: Project
    ) -> Iterator[Finding]:
        spans = astutil.raises_spans(src.tree)
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = getattr(f, "attr", None) or getattr(f, "id", "")
            if name != "Decomposable":
                continue
            if astutil.in_spans(node.lineno, spans):
                continue
            kw = {k.arg: k.value for k in node.keywords}
            lin = kw.get("linear")
            declared_linear = (
                isinstance(lin, ast.Constant) and lin.value is True
            )
            if declared_linear and "identity" not in kw:
                yield self.finding(
                    src.rel,
                    node.lineno,
                    "Decomposable(linear=True) without a registered "
                    "identity element — coded k-of-n decode is unsound "
                    "for absent keys",
                )
