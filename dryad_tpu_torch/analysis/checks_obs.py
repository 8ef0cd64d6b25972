"""Checkers: observability discipline — spans, config keys, metrics.

Rules grown out of the flight-recorder and telemetry work
(``obs.flightrec`` / ``obs.telemetry``): crash forensics is only as
good as the stream it records, and the stream is only trustworthy if
spans always close, config reads always name real knobs, and metric
emissions always name registered series.

- ``span-discipline``: every ``tracer.span(...)`` call site must be a
  ``with``-statement context item.  A span held as a plain value can
  leak open across an exception, leaving the Perfetto export with
  unterminated slices and the flight recorder's ring with begin events
  whose ends never come.  Direct ``Span(...)`` construction outside
  ``obs/span.py`` is flagged for the same reason — the tracer is the
  only sanctioned factory.
- ``config-key``: ``utils/config.py`` keeps a ``CONFIG_KEYS`` literal
  (key -> one-line doc) that must mirror the ``DryadConfig`` dataclass
  fields BOTH ways, and every config attribute read in the package
  (``*.config.<key>``, ``cfg.<key>``, ``getattr(config, "<key>")``)
  must name a schema key or a real method.  The repo has no string
  config lookups — attribute access IS the lookup — so a typo'd knob
  read otherwise fails only at runtime, or worse, silently via
  ``getattr`` defaults.
- ``metric-key``: ``obs/telemetry.py`` keeps a ``METRIC_KEYS`` literal
  (metric name -> one-line doc) that must agree BOTH ways with every
  ``incr``/``set_gauge``/``observe_latency`` literal call site in the
  package (mirroring the event-schema rule) — a misspelled metric name
  otherwise silently starts a new time series nobody scrapes.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set, Tuple

from dryad_tpu_torch.analysis import astutil
from dryad_tpu_torch.analysis.core import Checker, Finding, Project, register

SPAN_PATH = "dryad_tpu_torch/obs/span.py"
CONFIG_PATH = "dryad_tpu_torch/utils/config.py"

# receiver chains whose final link marks a DryadConfig value
_CONFIG_NAMES = ("config", "cfg")


@register
class SpanDisciplineChecker(Checker):
    rule = "span-discipline"
    summary = (
        "tracer.span(...) only as a with-item; Span() construction "
        "only inside obs/span.py"
    )
    hint = (
        "wrap the call in `with tracer.span(...):` so the span closes "
        "on every exit path"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        for src in project.package_files():
            if src.rel == SPAN_PATH:
                continue  # the factory itself returns/holds Spans
            with_items = set()
            for node in ast.walk(src.tree):
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        with_items.add(id(item.context_expr))
            for node in ast.walk(src.tree):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if (
                    isinstance(f, ast.Attribute)
                    and f.attr == "span"
                    and id(node) not in with_items
                ):
                    yield self.finding(
                        src.rel,
                        node.lineno,
                        "span(...) held as a value instead of a "
                        "with-item; it will not close on exceptions",
                    )
                elif (
                    isinstance(f, ast.Name)
                    and f.id == "Span"
                ):
                    yield self.finding(
                        src.rel,
                        node.lineno,
                        "direct Span(...) construction outside "
                        "obs/span.py; use tracer.span(...)",
                        hint="the Tracer is the only sanctioned Span "
                        "factory",
                    )


def _config_fields(tree: ast.Module) -> Optional[Tuple[Set[str], Set[str]]]:
    """(dataclass field names, method names) of DryadConfig."""
    cls = astutil.find_class(tree, "DryadConfig")
    if cls is None:
        return None
    fields: Set[str] = set()
    methods: Set[str] = set()
    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(
            stmt.target, ast.Name
        ):
            fields.add(stmt.target.id)
        elif isinstance(stmt, ast.FunctionDef):
            methods.add(stmt.name)
    return fields, methods


def _is_config_receiver(node: ast.expr) -> bool:
    """True for ``config`` / ``cfg`` names and any attribute chain
    ending in ``.config`` — except chains that mention torch (its
    ``torch._dynamo.config`` and kin are a different animal)."""
    chain = astutil.dotted(node)
    if not chain:
        return False
    if any("torch" in part for part in chain):
        return False
    return chain[-1] in _CONFIG_NAMES


@register
class ConfigKeyChecker(Checker):
    rule = "config-key"
    summary = (
        "CONFIG_KEYS mirrors DryadConfig fields both ways; every "
        "config attribute read names a schema key"
    )
    hint = (
        "add the field to DryadConfig AND document it in CONFIG_KEYS "
        "(utils/config.py), or fix the attribute name"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        src = project.file(CONFIG_PATH)
        if src is None:
            return
        keys = astutil.literal_dict(src.tree, "CONFIG_KEYS")
        parsed = _config_fields(src.tree)
        if keys is None or parsed is None:
            yield self.finding(
                src.rel,
                1,
                "could not parse CONFIG_KEYS literal / DryadConfig "
                "class",
                hint="keep CONFIG_KEYS a plain literal dict",
            )
            return
        fields, methods = parsed
        stmt = astutil.find_assign(src.tree, "CONFIG_KEYS")
        keys_line = stmt.lineno if stmt is not None else 1

        # docs are non-empty one-liners
        for key, doc_node in keys.items():
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
                    f"doc for config key {key!r} must be a non-empty "
                    "one-line string",
                )

        # schema <-> dataclass, both directions
        for key in sorted(set(keys) - fields):
            yield self.finding(
                src.rel,
                keys_line,
                f"CONFIG_KEYS documents {key!r} but DryadConfig has "
                "no such field",
            )
        for key in sorted(fields - set(keys)):
            yield self.finding(
                src.rel,
                keys_line,
                f"DryadConfig field {key!r} missing from CONFIG_KEYS",
            )

        allowed = set(keys) | fields | methods
        for usage in project.package_files():
            if usage.rel == CONFIG_PATH:
                continue
            for node in ast.walk(usage.tree):
                if isinstance(node, ast.Attribute):
                    if (
                        not node.attr.startswith("_")
                        and _is_config_receiver(node.value)
                        and node.attr not in allowed
                    ):
                        yield self.finding(
                            usage.rel,
                            node.lineno,
                            f"config attribute {node.attr!r} is not a "
                            "DryadConfig field",
                        )
                elif (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "getattr"
                    and len(node.args) >= 2
                    and isinstance(node.args[1], ast.Constant)
                    and isinstance(node.args[1].value, str)
                    and _is_config_receiver(node.args[0])
                ):
                    key = node.args[1].value
                    if not key.startswith("_") and key not in allowed:
                        yield self.finding(
                            usage.rel,
                            node.lineno,
                            f"getattr config key {key!r} is not a "
                            "DryadConfig field",
                        )


TELEMETRY_PATH = "dryad_tpu_torch/obs/telemetry.py"

# RollingStore's write surface: a literal first argument at any of
# these call sites IS a metric emission
_METRIC_EMITTERS = ("incr", "set_gauge", "observe_latency")


@register
class MetricKeyChecker(Checker):
    rule = "metric-key"
    summary = (
        "METRIC_KEYS and incr/set_gauge/observe_latency sites agree "
        "both ways; metric names are string literals"
    )
    hint = (
        "document the metric (one line) in obs/telemetry.py "
        "METRIC_KEYS, or remove the stale entry"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        src = project.file(TELEMETRY_PATH)
        if src is None:
            return
        keys = astutil.literal_dict(src.tree, "METRIC_KEYS")
        if keys is None:
            yield self.finding(
                src.rel,
                1,
                "could not parse the METRIC_KEYS literal",
                hint="keep the metric schema dict a plain literal",
            )
            return
        keys_stmt = astutil.find_assign(src.tree, "METRIC_KEYS")
        keys_line = keys_stmt.lineno if keys_stmt is not None else 1

        # docs are non-empty one-liners (the schema doubles as THE
        # documented metric table — see the event-schema rule)
        for name, doc_node in keys.items():
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
                    f"doc for metric {name!r} must be a non-empty "
                    "one-line string",
                )

        emitted: Set[str] = set()
        for usage in project.package_files():
            for node in ast.walk(usage.tree):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if not (
                    isinstance(f, ast.Attribute)
                    and f.attr in _METRIC_EMITTERS
                ):
                    continue
                if not node.args:
                    continue
                first = node.args[0]
                if not (
                    isinstance(first, ast.Constant)
                    and isinstance(first.value, str)
                ):
                    yield self.finding(
                        usage.rel,
                        node.lineno,
                        f"{f.attr}() metric name must be a string "
                        "literal (the schema cross-reference cannot "
                        "see computed names)",
                    )
                    continue
                name = first.value
                emitted.add(name)
                if name not in keys:
                    yield self.finding(
                        usage.rel,
                        node.lineno,
                        f"emits unregistered metric {name!r}",
                    )

        # documented metrics no call site emits are stale
        for name in sorted(set(keys) - emitted):
            yield self.finding(
                src.rel,
                keys_line,
                f"METRIC_KEYS documents metric {name!r} that no call "
                "site emits",
                hint="remove the stale metric or emit it",
            )
