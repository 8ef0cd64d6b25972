"""Checker: routing keys must be process-portable.

``routing-hash``: the fleet router places queries by plan fingerprint
(rendezvous hashing), replicas agree on cache keys across processes,
and replay after a chaos kill re-routes by the SAME key — so every
routing/affinity key must be derived from content (sha256 of canonical
bytes), never from Python's builtin ``hash()`` (salted per process by
``PYTHONHASHSEED``) or ``id()`` (an address).  A builtin-hash routing
key silently destroys affinity: each front-door process computes a
different key for the same plan, the fleet's cache-hit rate collapses
to 1/N, and a replayed query lands on a cold replica while looking
perfectly healthy.

Two scopes:

- **routing tier** (``serve/``, ``cluster/``): ANY call to the builtin
  ``hash()`` or ``id()`` fires — this tier exists to move keys between
  processes, so there is no safe use (an intentional exception takes a
  graftlint disable comment naming this rule, justification on the
  record).
- **project-wide**: an assignment or keyword argument whose name says
  it IS a routing key (``*fingerprint*``, ``*route*``/``*routing*``,
  ``*shard*``, ``*affinity*``) fed from a ``hash()``/``id()`` call —
  the key escapes its process the moment the serving tier picks it up.

A module that defines its OWN ``hash``/``id`` binding is skipped (the
builtin is shadowed, whatever it does is that module's business).

Anchor: ``serve/router.py`` must define :func:`rendezvous_rank` — the
function whose cross-process determinism this rule protects.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set, Tuple

from dryad_tpu_torch.analysis import astutil
from dryad_tpu_torch.analysis.core import Checker, Finding, Project, register

ROUTER_PATH = "dryad_tpu_torch/serve/router.py"
ROUTER_ANCHOR = "rendezvous_rank"

# the tier whose whole job is moving keys between processes
_ROUTING_PREFIXES: Tuple[str, ...] = (
    "dryad_tpu_torch/serve/",
    "dryad_tpu_torch/cluster/",
)

_BANNED = ("hash", "id")

# a name carrying one of these substrings IS a routing key
_KEY_MARKERS = ("fingerprint", "route", "routing", "shard", "affinity")


def _shadowed(tree: ast.Module) -> Set[str]:
    """Builtin names rebound anywhere in the module."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name in _BANNED:
                out.add(node.name)
            a = node.args
            for arg in (
                a.posonlyargs + a.args + a.kwonlyargs
                + [x for x in (a.vararg, a.kwarg) if x is not None]
            ):
                if arg.arg in _BANNED:
                    out.add(arg.arg)
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id in _BANNED:
                    out.add(tgt.id)
    return out


def _banned_calls(node: ast.AST, shadowed: Set[str]):
    """Yield (name, lineno) for builtin hash()/id() calls under *node*."""
    for sub in ast.walk(node):
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Name)
            and sub.func.id in _BANNED
            and sub.func.id not in shadowed
        ):
            yield sub.func.id, sub.lineno


def _target_names(node: ast.AST):
    """Bound names of an assignment target (Name or trailing attribute
    — ``self.fingerprint = ...`` counts)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            yield sub.id
        elif isinstance(sub, ast.Attribute):
            yield sub.attr


def _is_key_name(name: str) -> bool:
    low = name.lower()
    return any(m in low for m in _KEY_MARKERS)


@register
class RoutingHashChecker(Checker):
    rule = "routing-hash"
    summary = (
        "routing/affinity keys derive from content hashes (sha256), "
        "never the process-salted builtin hash() or id()"
    )
    hint = (
        "use hashlib.sha256 over canonical bytes (see "
        "serve.router.canonical_fingerprint); builtin hash() differs "
        "per process under PYTHONHASHSEED, id() is an address"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        for src in project.iter(_ROUTING_PREFIXES):
            shadowed = _shadowed(src.tree)
            for name, ln in _banned_calls(src.tree, shadowed):
                yield self.finding(
                    src.rel,
                    ln,
                    f"builtin {name}() in the routing tier — keys "
                    "cross process boundaries here; derive them from "
                    "sha256 of canonical bytes",
                )
        in_tier = set(_ROUTING_PREFIXES)
        for src in project.iter(("dryad_tpu_torch/",)):
            if any(src.rel.startswith(p) for p in in_tier):
                continue  # already scanned under the stricter rule
            shadowed = _shadowed(src.tree)
            for node in ast.walk(src.tree):
                if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                    targets = (
                        node.targets
                        if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                    if node.value is None or not any(
                        _is_key_name(n)
                        for t in targets
                        for n in _target_names(t)
                    ):
                        continue
                    for name, ln in _banned_calls(node.value, shadowed):
                        yield self.finding(
                            src.rel,
                            ln,
                            f"routing-key assignment fed by builtin "
                            f"{name}() — the key is not stable across "
                            "processes",
                        )
                elif isinstance(node, ast.Call):
                    for kw in node.keywords:
                        if kw.arg is None or not _is_key_name(kw.arg):
                            continue
                        for name, ln in _banned_calls(kw.value, shadowed):
                            yield self.finding(
                                src.rel,
                                ln,
                                f"routing-key argument {kw.arg}= fed by "
                                f"builtin {name}() — the key is not "
                                "stable across processes",
                            )
        src = project.file(ROUTER_PATH)
        if src is not None and (
            astutil.find_function(src.tree, ROUTER_ANCHOR) is None
        ):
            yield self.finding(
                src.rel,
                1,
                f"{ROUTER_ANCHOR}() not found — the routing-hash scan "
                "lost its anchor",
                hint="re-anchor the scan to the rendezvous router",
            )
