"""Checker: event-emission discipline against the events.py schema.

The source of truth is ``exec/events.py`` itself — ``EVENT_KINDS``
(kind -> doc) and ``EVENT_PAYLOADS`` (kind -> (required keys, optional
keys)).  Enforced:

- every ``emit("kind", ...)`` / ``_emit("kind", ...)`` literal call
  site in the package — and every ``_note("kind", label, value,
  **payload)`` site, the executor's wrapper that logs the event and
  keeps its ``(kind, name, value)`` record — names a kind in
  ``EVENT_KINDS`` (both directions: documented kinds with no call site
  are stale);
- ``PENDING_KINDS`` (kind -> the ROADMAP item that brings its emitter)
  lists the documented kinds whose emitting part is not ported yet:
  they need no call site, an entry must name a documented kind, and a
  pending kind that gains a call site is a finding, so the list only
  shrinks;
- docs are non-empty one-liners;
- ``EVENT_PAYLOADS`` covers exactly the kinds in ``EVENT_KINDS``;
- each call site's explicit keyword payload is consistent with the
  kind's spec: explicit keys stay inside required+optional, and every
  required key is present (sites forwarding a ``**kwargs`` blob are
  only checked for the inclusion direction — the blob's keys are not
  statically visible).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Tuple

from dryad_tpu_torch.analysis import astutil
from dryad_tpu_torch.analysis.core import Checker, Finding, Project, register

EVENTS_PATH = "dryad_tpu_torch/exec/events.py"

# call names whose first argument is an event kind and whose keywords
# are its payload
EMITTERS = ("emit", "_emit", "_note")


def _payload_specs(
    tree: ast.Module,
) -> Optional[Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]]]:
    raw = astutil.literal_dict(tree, "EVENT_PAYLOADS")
    if raw is None:
        return None
    out = {}
    for kind, node in raw.items():
        if not (isinstance(node, ast.Tuple) and len(node.elts) == 2):
            return None
        groups = []
        for part in node.elts:
            if not isinstance(part, ast.Tuple):
                return None
            keys = []
            for e in part.elts:
                if not (
                    isinstance(e, ast.Constant)
                    and isinstance(e.value, str)
                ):
                    return None
                keys.append(e.value)
            groups.append(tuple(keys))
        out[kind] = (groups[0], groups[1])
    return out


def pending_kinds(tree: ast.Module) -> Optional[Dict[str, ast.expr]]:
    """``PENDING_KINDS`` of events.py ({} when absent, None when it is
    not a plain literal dict)."""
    if astutil.find_assign(tree, "PENDING_KINDS") is None:
        return {}
    return astutil.literal_dict(tree, "PENDING_KINDS")


def _emit_sites(project: Project):
    """(kind, src, call node, explicit keys, has **blob) per literal
    emit site in the package."""
    for src in project.package_files():
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = getattr(f, "attr", None) or getattr(f, "id", "")
            if name not in EMITTERS:
                continue
            if not (
                node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                continue
            keys = tuple(
                kw.arg for kw in node.keywords if kw.arg is not None
            )
            star = any(kw.arg is None for kw in node.keywords)
            yield node.args[0].value, src, node, keys, star


@register
class EventSchemaChecker(Checker):
    rule = "event-schema"
    summary = (
        "EVENT_KINDS and emit() sites agree both ways; per-kind payload "
        "keys match EVENT_PAYLOADS"
    )
    hint = (
        "document the kind (one line) in exec/events.py EVENT_KINDS and "
        "its payload in EVENT_PAYLOADS"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        src = project.file(EVENTS_PATH)
        if src is None:
            return
        kinds = astutil.literal_dict(src.tree, "EVENT_KINDS")
        payloads = _payload_specs(src.tree)
        if kinds is None or payloads is None:
            yield self.finding(
                src.rel,
                1,
                "could not parse EVENT_KINDS / EVENT_PAYLOADS literals",
                hint="keep both schema dicts as plain literals",
            )
            return
        pending = pending_kinds(src.tree)
        pend_stmt = astutil.find_assign(src.tree, "PENDING_KINDS")
        pend_line = pend_stmt.lineno if pend_stmt is not None else 1
        if pending is None:
            yield self.finding(
                src.rel,
                pend_line,
                "could not parse the PENDING_KINDS literal",
                hint="keep PENDING_KINDS a plain dict of kind -> item",
            )
            pending = {}
        for kind, item in pending.items():
            if kind not in kinds:
                yield self.finding(
                    src.rel,
                    item.lineno,
                    f"PENDING_KINDS names undocumented kind {kind!r}",
                )
            if not (
                isinstance(item, ast.Constant)
                and isinstance(item.value, str)
                and item.value.strip()
            ):
                yield self.finding(
                    src.rel,
                    item.lineno,
                    f"PENDING_KINDS entry {kind!r} must name the ROADMAP "
                    "item that brings its emitter",
                )
        kinds_stmt = astutil.find_assign(src.tree, "EVENT_KINDS")
        kinds_line = kinds_stmt.lineno if kinds_stmt is not None else 1
        pay_stmt = astutil.find_assign(src.tree, "EVENT_PAYLOADS")
        pay_line = pay_stmt.lineno if pay_stmt is not None else 1

        # docs are non-empty one-liners
        for kind, doc_node in kinds.items():
            doc = (
                doc_node.value
                if isinstance(doc_node, ast.Constant)
                and isinstance(doc_node.value, str)
                else None
            )
            if doc is None or not doc.strip() or "\n" in doc:
                yield self.finding(
                    src.rel,
                    doc_node.lineno,
                    f"doc for {kind!r} must be a non-empty one-line "
                    "string",
                )

        # payload specs cover exactly the documented kinds
        for kind in sorted(set(kinds) - set(payloads)):
            yield self.finding(
                src.rel,
                pay_line,
                f"kind {kind!r} documented in EVENT_KINDS but missing "
                "from EVENT_PAYLOADS",
            )
        for kind in sorted(set(payloads) - set(kinds)):
            yield self.finding(
                src.rel,
                pay_line,
                f"EVENT_PAYLOADS names unknown kind {kind!r}",
            )

        emitted: Dict[str, List] = {}
        for kind, esrc, node, keys, star in _emit_sites(project):
            emitted.setdefault(kind, [])
            if kind in pending:
                yield self.finding(
                    esrc.rel,
                    node.lineno,
                    f"emits pending kind {kind!r}",
                    hint="its emitter is ported: drop the kind from "
                    "PENDING_KINDS",
                )
            if kind not in kinds:
                yield self.finding(
                    esrc.rel,
                    node.lineno,
                    f"emits undocumented kind {kind!r}",
                )
                continue
            spec = payloads.get(kind)
            if spec is None:
                continue
            required, optional = spec
            allowed = set(required) | set(optional)
            for k in keys:
                if k not in allowed:
                    yield self.finding(
                        esrc.rel,
                        node.lineno,
                        f"{kind!r} payload key {k!r} not in its "
                        "EVENT_PAYLOADS spec",
                    )
            if not star:
                missing = sorted(set(required) - set(keys))
                if missing:
                    yield self.finding(
                        esrc.rel,
                        node.lineno,
                        f"{kind!r} emit site missing required payload "
                        f"key(s) {missing}",
                    )

        # documented kinds with no static call site are stale, unless
        # their emitter is still to be ported
        for kind in sorted(set(kinds) - set(emitted) - set(pending)):
            yield self.finding(
                src.rel,
                kinds_line,
                f"EVENT_KINDS documents kind {kind!r} that no call "
                "site emits",
                hint="remove the stale kind or emit it",
            )
