"""Checker: canonical collective ordering inside one function body.

``collective-order``: every device-path function must issue its
``torch.distributed`` collectives in the canonical class order

    send/recv/batch_isend_irecv  ->  all_to_all(_single)  ->
    all_gather(_into_tensor)  ->  reductions (all_reduce/
                                  reduce_scatter(_tensor))

Every rank runs its own program and launches collectives on its own
NCCL communicator, so two ranks that reach the same collectives in a
different order park in different collectives and the group hangs.  A
fixed class order per function body makes any two fused members'
sequences mutually consistent by construction — the prerequisite for
trusting the exchange planner's multi-round schedules across ranks.
Over the port's tree it ranks the partition layer's calls
(``parallel/partition.py``: the staged exchange's ``batch_isend_irecv``
rounds first), and its cases also run on synthetic trees.

The check is purely syntactic and per-scope: within one function body
(nested functions and lambdas are separate scopes — they run when
CALLED, not where they are defined), the ``dist.<collective>`` /
``torch.distributed.<collective>`` calls must appear in non-decreasing
class rank by source position.  Loops repeat a subsequence in place,
which preserves relative class order, so source position is the right
proxy for issue order.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Tuple

from dryad_tpu_torch.analysis.core import Checker, Finding, Project, register

# class rank per collective: point-to-point data movement, then
# subgroup exchange, then gathers, then reductions
COLLECTIVE_RANK = {
    "send": 0,
    "recv": 0,
    "isend": 0,
    "irecv": 0,
    "batch_isend_irecv": 0,
    "all_to_all": 1,
    "all_to_all_single": 1,
    "all_gather": 2,
    "all_gather_into_tensor": 2,
    "all_gather_single": 2,
    "all_reduce": 3,
    "reduce_scatter": 3,
    "reduce_scatter_tensor": 3,
    "reduce_scatter_single": 3,
}

_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _is_collective(node: ast.AST) -> str:
    """The collective name when *node* is a ``dist.<coll>`` or
    ``torch.distributed.<coll>`` call."""
    if not isinstance(node, ast.Call):
        return ""
    f = node.func
    if not isinstance(f, ast.Attribute) or f.attr not in COLLECTIVE_RANK:
        return ""
    v = f.value
    if isinstance(v, ast.Name) and v.id == "dist":
        return f.attr
    if isinstance(v, ast.Attribute) and v.attr == "distributed":
        return f.attr
    return ""


def _direct_collectives(scope: ast.AST) -> List[Tuple[int, str]]:
    """Collective calls belonging to *scope* itself, in source order,
    excluding those inside nested function/lambda scopes."""
    out: List[Tuple[int, str]] = []

    def visit(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _SCOPES):
                continue
            name = _is_collective(child)
            if name:
                out.append((child.lineno, name))
            visit(child)

    visit(scope)
    out.sort()
    return out


def scope_violations(tree: ast.AST) -> List[Tuple[int, str, str]]:
    """(line, earlier collective, out-of-order collective) triples."""
    bad: List[Tuple[int, str, str]] = []
    for scope in ast.walk(tree):
        if not isinstance(scope, _SCOPES):
            continue
        calls = _direct_collectives(scope)
        high: Tuple[int, str] = (-1, "")
        for line, name in calls:
            rank = COLLECTIVE_RANK[name]
            if rank < high[0]:
                bad.append((line, high[1], name))
            else:
                high = (rank, name)
    return bad


@register
class CollectiveOrderChecker(Checker):
    rule = "collective-order"
    summary = (
        "device-path functions issue collectives in canonical class "
        "order: send/recv -> all_to_all -> all_gather -> reductions"
    )
    hint = (
        "move the data-movement collective ahead of the reduction (or "
        "split the phases into separate functions)"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        for src in project.package_files():
            for line, before, name in scope_violations(src.tree):
                yield self.finding(
                    src.rel,
                    line,
                    f"collective {name}() issued after {before}() — "
                    "out of canonical class order; ranks that reach "
                    "collectives in different orders hang the process "
                    "group",
                )
