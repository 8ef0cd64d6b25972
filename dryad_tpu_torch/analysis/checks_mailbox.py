"""Checker: gang feed loops must never drain the mailbox themselves.

``mailbox-discipline``: the overlapped gang command stream
(``cluster/gangwindow.py`` ``GangDispatchWindow``) splits the driver
into a FEED half (posts envelopes, hands each drain closure to
``submit``) and a COLLECTOR half (the one sanctioned blocking point,
running the drains in submit order).  The property mailbox is a
latest-value store, so the overlap is only safe while the feed side
keeps moving: a blocking status wait inside the feed loop re-serializes
the window (depth stops doing anything), and worse, it can deadlock —
the feed thread waits on a status that only arrives after an envelope
the blocked feed has not posted yet.  Flagged inside any loop that also
submits to a window object:

- ``<x>.wait(...)`` — a process/condition wait in the feed path;
- ``<x>._command_round_trip(...)`` / ``<x>._placed_round_trip(...)``
  (or bare calls) — the synchronous mailbox round trip, which both
  posts AND drains;
- ``<x>.drain(...)`` — the blocking drain belongs AFTER the feed loop
  (or in ``ready()`` form, which never blocks).

Nested ``def``/``lambda`` bodies inside the loop are exempt: a closure
defined in the feed loop is exactly the drain half being handed to the
collector, where blocking is the job.  As a structural-drift guard, a
``cluster/gangwindow.py`` that no longer defines ``GangDispatchWindow``
is itself a finding — the rule must not go silent because its anchor
moved.  Over the port's tree it anchors on the port's
``cluster/gangwindow.py`` and checks ``LocalJobSubmission``'s windowed
feed loop; its cases also run on synthetic trees.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Set, Tuple

from dryad_tpu_torch.analysis import astutil
from dryad_tpu_torch.analysis.core import Checker, Finding, Project, register

GANGWINDOW_PATH = "dryad_tpu_torch/cluster/gangwindow.py"

# calls that block the feed thread on mailbox/status progress
_ROUND_TRIPS = ("_command_round_trip", "_placed_round_trip")


def _is_windowish(node: ast.expr) -> bool:
    """True when the receiver names a dispatch window (``win``,
    ``window``, ``self._win``, ``gang_window``, ...)."""
    chain = astutil.dotted(node)
    if not chain:
        return False
    name = chain[-1].lower()
    return name == "win" or "window" in name or name.endswith("_win")


_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _iter_no_defs(node: ast.AST) -> Iterator[ast.AST]:
    """Walk a subtree, skipping nested function/lambda bodies (closures
    defined in the feed loop ARE the sanctioned drain half)."""
    yield node
    if isinstance(node, _DEFS):
        return
    for child in ast.iter_child_nodes(node):
        yield from _iter_no_defs(child)


def _loop_body_nodes(loop: ast.AST) -> Iterator[ast.AST]:
    for stmt in getattr(loop, "body", []) + getattr(loop, "orelse", []):
        yield from _iter_no_defs(stmt)


def _window_submits(nodes: List[ast.AST]) -> bool:
    for node in nodes:
        if isinstance(node, ast.Call):
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr == "submit"
                and _is_windowish(f.value)
            ):
                return True
    return False


def _blocking_calls(nodes: List[ast.AST]) -> Iterator[Tuple[int, str]]:
    for node in nodes:
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr == "wait":
                yield node.lineno, ".wait() blocks the feed thread"
            elif f.attr in _ROUND_TRIPS:
                yield (
                    node.lineno,
                    f".{f.attr}() is a synchronous mailbox round trip",
                )
            elif f.attr == "drain":
                yield (
                    node.lineno,
                    ".drain() is the blocking drain; it belongs after "
                    "the feed loop",
                )
        elif isinstance(f, ast.Name) and f.id in _ROUND_TRIPS:
            yield (
                node.lineno,
                f"{f.id}() is a synchronous mailbox round trip",
            )


@register
class MailboxDisciplineChecker(Checker):
    rule = "mailbox-discipline"
    summary = (
        "no blocking mailbox drains inside a gang feed loop; the "
        "window collector is the single sanctioned drain site"
    )
    hint = (
        "hand the blocking half to GangDispatchWindow.submit as a "
        "drain closure, consume ready() inside the loop, and move "
        "drain()/round trips after the feed loop"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        for src in project.package_files():
            if src.rel == GANGWINDOW_PATH and astutil.find_class(
                src.tree, "GangDispatchWindow"
            ) is None:
                # structural drift: the anchor class moved or was
                # renamed — fail loudly instead of scanning nothing
                yield self.finding(
                    src.rel,
                    1,
                    "cluster/gangwindow.py no longer defines "
                    "GangDispatchWindow; mailbox-discipline has lost "
                    "its anchor",
                    hint="re-point the checker at the new gang window "
                    "surface",
                )
            seen: Set[Tuple[int, str]] = set()
            for node in ast.walk(src.tree):
                if not isinstance(node, (ast.For, ast.While)):
                    continue
                body = list(_loop_body_nodes(node))
                if not _window_submits(body):
                    continue
                for line, what in _blocking_calls(body):
                    if (line, what) in seen:
                        continue  # nested loops scan overlapping bodies
                    seen.add((line, what))
                    yield self.finding(
                        src.rel,
                        line,
                        f"{what} inside a gang feed loop that submits "
                        "to a dispatch window; the collector is the "
                        "only sanctioned drain site",
                    )
