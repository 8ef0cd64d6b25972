"""graftlint core: findings, checkers, suppressions, and the runner.

The moving parts:

- :class:`Finding` — one structured diagnostic (rule id, file:line,
  message, fix hint) plus its suppression state;
- :class:`SourceFile` / :class:`Project` — a parsed view of the tree
  under analysis.  ``Project.from_sources`` builds a synthetic project
  from in-memory sources, which is how the seeded-mutation self-tests
  prove each checker actually fires;
- :class:`Checker` — the pass base class; ``@register`` puts an
  instance in the global registry keyed by its rule id;
- :func:`run` — executes selected checkers over a project, applies
  inline suppressions, and reports on the suppressions themselves
  (missing reason -> ``bad-suppression``, matched nothing ->
  ``unused-suppression``).

Suppression grammar — the reason is REQUIRED, and the comment covers
its own line plus the next one (so it can trail the offending line or
sit just above it)::

    os.environ.get("KNOB")  # graftlint: disable=<rule> -- read once at import
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

# rules emitted by the framework itself (about suppressions), always on
BAD_SUPPRESSION = "bad-suppression"
UNUSED_SUPPRESSION = "unused-suppression"
FRAMEWORK_RULES = (BAD_SUPPRESSION, UNUSED_SUPPRESSION)

# what the gate scans: the port's package and the port's own tests (the
# reference's tests belong to the reference's gate), minus the build
# tree the port writes at run time
SCAN = (("dryad_tpu_torch", "**/*.py"), ("tests", "test_torch_*.py"))
SKIP = ("dryad_tpu_torch/_build/",)

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable=([A-Za-z0-9_,-]+)(\s*--\s*(.*\S)?)?\s*$"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: where, what rule, what to do about it."""

    rule: str
    path: str
    line: int
    message: str
    hint: str = ""
    suppressed: bool = False
    reason: str = ""  # the suppression's reason when suppressed

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def render(self) -> str:
        out = f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        if self.hint:
            out += f"  (fix: {self.hint})"
        if self.suppressed:
            out += f"  [suppressed: {self.reason}]"
        return out

    def to_json(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Suppression:
    """A parsed ``# graftlint: disable=...`` comment."""

    path: str
    line: int
    rules: Tuple[str, ...]
    reason: str
    used_rules: Set[str] = dataclasses.field(default_factory=set)

    def covers(self, line: int) -> bool:
        # trailing the offending line, or on its own line just above
        return line in (self.line, self.line + 1)


class SourceFile:
    """One file: text, lazily-parsed AST, and its suppressions."""

    def __init__(self, rel: str, text: str):
        self.rel = rel
        self.text = text
        self._tree: Optional[ast.Module] = None
        self._suppressions: Optional[List[Suppression]] = None

    @property
    def tree(self) -> ast.Module:
        if self._tree is None:
            self._tree = ast.parse(self.text, filename=self.rel)
        return self._tree

    @property
    def suppressions(self) -> List[Suppression]:
        if self._suppressions is None:
            out = []
            for i, raw in enumerate(self.text.splitlines(), start=1):
                m = _SUPPRESS_RE.search(raw)
                if not m:
                    continue
                rules = tuple(
                    r.strip() for r in m.group(1).split(",") if r.strip()
                )
                reason = (m.group(3) or "").strip()
                out.append(Suppression(self.rel, i, rules, reason))
            self._suppressions = out
        return self._suppressions


class Project:
    """The set of files under analysis, keyed by POSIX relpath."""

    def __init__(self, files: Dict[str, SourceFile]):
        self.files = files

    @classmethod
    def from_root(
        cls, root: Path, scan: Sequence[Tuple[str, str]] = SCAN
    ) -> "Project":
        files: Dict[str, SourceFile] = {}
        for sub, pattern in scan:
            base = root / sub
            if not base.is_dir():
                continue
            for p in sorted(base.glob(pattern)):
                rel = p.relative_to(root).as_posix()
                if "__pycache__" in p.parts or rel.startswith(SKIP):
                    continue
                files[rel] = SourceFile(rel, p.read_text())
        return cls(files)

    @classmethod
    def from_sources(cls, sources: Dict[str, str]) -> "Project":
        """Synthetic project for checker self-tests: relpath -> text."""
        return cls({rel: SourceFile(rel, text) for rel, text in sources.items()})

    def file(self, rel: str) -> Optional[SourceFile]:
        return self.files.get(rel)

    def iter(self, prefixes: Sequence[str]) -> Iterator[SourceFile]:
        for rel in sorted(self.files):
            if any(rel.startswith(p) for p in prefixes):
                yield self.files[rel]

    def package_files(self) -> Iterator[SourceFile]:
        return self.iter(("dryad_tpu_torch/",))

    def test_files(self) -> Iterator[SourceFile]:
        return self.iter(("tests/",))


class Checker:
    """Base pass: project-wide.  Subclasses set the rule id, a one-line
    summary, and a fix hint, and yield findings from :meth:`check`."""

    rule: str = ""
    summary: str = ""
    hint: str = ""

    def check(self, project: Project) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(
        self, rel: str, line: int, message: str, hint: Optional[str] = None
    ) -> Finding:
        return Finding(
            rule=self.rule,
            path=rel,
            line=line,
            message=message,
            hint=self.hint if hint is None else hint,
        )


class FileChecker(Checker):
    """Per-file pass over files matching :attr:`prefixes`."""

    prefixes: Tuple[str, ...] = ("dryad_tpu_torch/",)

    def check(self, project: Project) -> Iterator[Finding]:
        for src in project.iter(self.prefixes):
            yield from self.check_file(src, project)

    def check_file(
        self, src: SourceFile, project: Project
    ) -> Iterator[Finding]:
        raise NotImplementedError


_REGISTRY: Dict[str, Checker] = {}
_BUILTIN_LOADED = False


def register(cls):
    """Class decorator: instantiate and index by rule id."""
    inst = cls()
    assert inst.rule, f"{cls.__name__} must set a rule id"
    assert inst.rule not in _REGISTRY, f"duplicate rule id {inst.rule!r}"
    _REGISTRY[inst.rule] = inst
    return cls


def _load_builtin() -> None:
    global _BUILTIN_LOADED
    if _BUILTIN_LOADED:
        return
    _BUILTIN_LOADED = True
    # imports populate _REGISTRY via @register
    from dryad_tpu_torch.analysis import (  # noqa: F401
        checks_collectives,
        checks_determinism,
        checks_dispatch,
        checks_events,
        checks_fusion,
        checks_layering,
        checks_mailbox,
        checks_obs,
        checks_operands,
        checks_recompile,
        checks_rewrite,
        checks_routing,
        checks_serve,
        checks_trace,
        checks_views,
    )


def all_checkers() -> Dict[str, Checker]:
    _load_builtin()
    return dict(sorted(_REGISTRY.items()))


def known_rules() -> Tuple[str, ...]:
    return tuple(all_checkers()) + FRAMEWORK_RULES


@dataclasses.dataclass
class Report:
    """Everything one run produced, suppressed findings included."""

    findings: List[Finding]
    suppressions: List[Suppression]
    rules_run: Tuple[str, ...]

    def unsuppressed(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    def suppressed(self) -> List[Finding]:
        return [f for f in self.findings if f.suppressed]

    @property
    def ok(self) -> bool:
        return not self.unsuppressed()

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            if not f.suppressed:
                out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def by_rule(self, rule: str) -> List[Finding]:
        return [f for f in self.findings if f.rule == rule]

    def to_json(self) -> Dict[str, object]:
        return {
            "ok": self.ok,
            "rules_run": list(self.rules_run),
            "counts": self.counts(),
            "findings": [f.to_json() for f in self.findings],
            "suppressions": [
                {
                    "path": s.path,
                    "line": s.line,
                    "rules": list(s.rules),
                    "reason": s.reason,
                }
                for s in self.suppressions
            ],
        }


def run(
    project: Project, rules: Optional[Iterable[str]] = None
) -> Report:
    """Run checkers over *project* and apply suppressions.

    ``rules=None`` runs everything.  An explicit rule subset still
    parses suppressions, but only reports a suppression as unused when
    EVERY rule it names was actually run (a filtered run cannot know
    whether the others would have matched).
    """
    checkers = all_checkers()
    if rules is None:
        selected = tuple(checkers)
    else:
        selected = tuple(rules)
        unknown = [r for r in selected if r not in known_rules()]
        if unknown:
            raise ValueError(f"unknown rule(s): {unknown}")

    raw: List[Finding] = []
    for rule in selected:
        if rule in FRAMEWORK_RULES:
            continue
        raw.extend(checkers[rule].check(project))

    suppressions: List[Suppression] = []
    for src in project.files.values():
        suppressions.extend(src.suppressions)
    by_path: Dict[str, List[Suppression]] = {}
    for s in suppressions:
        by_path.setdefault(s.path, []).append(s)

    findings: List[Finding] = []
    for f in raw:
        matched = None
        for s in by_path.get(f.path, ()):
            if f.rule in s.rules and s.covers(f.line) and s.reason:
                matched = s
                break
        if matched is not None:
            matched.used_rules.add(f.rule)
            f = dataclasses.replace(
                f, suppressed=True, reason=matched.reason
            )
        findings.append(f)

    # the framework's own rules: suppressions must carry a reason and
    # name known rules, and must have matched something.  These are
    # never themselves suppressible — that would be laundering.
    valid = known_rules()
    for s in suppressions:
        if not s.reason:
            findings.append(
                Finding(
                    BAD_SUPPRESSION,
                    s.path,
                    s.line,
                    f"suppression of {','.join(s.rules)} has no reason",
                    hint="append ' -- <why this is safe>'",
                )
            )
            continue
        bogus = [r for r in s.rules if r not in valid]
        if bogus:
            findings.append(
                Finding(
                    BAD_SUPPRESSION,
                    s.path,
                    s.line,
                    f"suppression names unknown rule(s) {bogus}",
                    hint=f"known rules: {', '.join(valid)}",
                )
            )
            continue
        checkable = set(s.rules) & set(selected)
        unused = sorted(checkable - s.used_rules)
        if unused and checkable == set(s.rules):
            findings.append(
                Finding(
                    UNUSED_SUPPRESSION,
                    s.path,
                    s.line,
                    f"suppression of {','.join(unused)} matched no finding",
                    hint="delete the stale comment",
                )
            )

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return Report(findings, suppressions, selected)
