"""Checker: query-scoped events must carry an explicit trace id.

The end-to-end tracing layer (``obs.tracectx`` / ``obs.critpath``)
only works if EVERY emit site of a query-scoped event kind stamps
``qid=`` — one forgotten site and that event class silently drops out
of every per-query fold (critical-path panels, the serve SLO phase
breakdown, metricsd's offline attribution).  The source of truth is
``exec/events.py``'s ``QUERY_SCOPED_KINDS`` tuple literal; this rule
pins the contract both ways:

- every literal ``emit("kind", ...)`` site for a registered kind
  passes ``qid`` as an EXPLICIT keyword (a ``**blob`` forward does not
  count — the whole point is that the stamp is visible at the site);
- every registry entry names a documented ``EVENT_KINDS`` kind whose
  ``EVENT_PAYLOADS`` spec admits ``qid`` and that some site actually
  emits (stale registry entries rot the tracing docs), unless the kind
  is in ``PENDING_KINDS`` (its emitter is not ported yet; the
  ``event-schema`` rule keeps that list honest).
"""

from __future__ import annotations

from typing import Iterator

from dryad_tpu_torch.analysis import astutil
from dryad_tpu_torch.analysis.checks_events import (
    EVENTS_PATH,
    _emit_sites,
    _payload_specs,
    pending_kinds,
)
from dryad_tpu_torch.analysis.core import Checker, Finding, Project, register


@register
class TraceContextChecker(Checker):
    rule = "trace-context"
    summary = (
        "QUERY_SCOPED_KINDS emit sites pass qid explicitly; the "
        "registry stays consistent with EVENT_KINDS/EVENT_PAYLOADS"
    )
    hint = (
        "stamp qid=tracectx.current_qid() (or the known id) at the "
        "emit site, or fix the QUERY_SCOPED_KINDS registry in "
        "exec/events.py"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        src = project.file(EVENTS_PATH)
        if src is None:
            return
        scoped = astutil.literal_str_set(src.tree, "QUERY_SCOPED_KINDS")
        if scoped is None:
            yield self.finding(
                src.rel,
                1,
                "could not parse the QUERY_SCOPED_KINDS literal",
                hint="keep QUERY_SCOPED_KINDS a plain tuple of strings",
            )
            return
        kinds = astutil.literal_dict(src.tree, "EVENT_KINDS") or {}
        payloads = _payload_specs(src.tree) or {}
        stmt = astutil.find_assign(src.tree, "QUERY_SCOPED_KINDS")
        reg_line = stmt.lineno if stmt is not None else 1

        # registry -> schema direction
        for kind in sorted(scoped):
            if kind not in kinds:
                yield self.finding(
                    src.rel,
                    reg_line,
                    f"QUERY_SCOPED_KINDS names unknown kind {kind!r}",
                )
                continue
            spec = payloads.get(kind)
            if spec is not None and "qid" not in spec[0] + spec[1]:
                yield self.finding(
                    src.rel,
                    reg_line,
                    f"query-scoped kind {kind!r} does not admit 'qid' "
                    "in its EVENT_PAYLOADS spec",
                )

        # emit-site direction: explicit qid= at every site, and every
        # registered kind emitted somewhere
        emitted = set()
        for kind, esrc, node, keys, _star in _emit_sites(project):
            if kind not in scoped:
                continue
            emitted.add(kind)
            if "qid" not in keys:
                yield self.finding(
                    esrc.rel,
                    node.lineno,
                    f"query-scoped kind {kind!r} emitted without an "
                    "explicit qid= keyword",
                )
        pending = set(pending_kinds(src.tree) or {})
        for kind in sorted(scoped - emitted - pending):
            if kind in kinds:
                yield self.finding(
                    src.rel,
                    reg_line,
                    f"QUERY_SCOPED_KINDS entry {kind!r} has no emit "
                    "site",
                    hint="remove the stale entry or emit the kind",
                )
