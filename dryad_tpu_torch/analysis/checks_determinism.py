"""Checker: the deterministic re-execution contract.

Dryad's whole fault-tolerance story — retries, checkpoints, coded
k-of-n reconstruction, whole-region overflow redo — rests on vertex
re-execution being BIT-EXACT.  This checker statically bans the ways
Python code silently breaks that inside kernel-reachable code:

- wall-clock reads (``time.*``) — two executions, two values;
- unseeded randomness: ``random.<fn>()``, ``random.Random()`` with no
  seed, ``np.random.<fn>()``, ``np.random.default_rng()`` with no
  seed, and the PyTorch samplers drawing from the global generator:
  ``torch.rand``/``randn``/``randint``/``randperm``/``normal``/
  ``bernoulli``/``multinomial`` (and the in-place ``Tensor`` samplers
  such as ``.uniform_()``) without ``generator=``, or a
  ``torch.Generator()`` that is never ``manual_seed``-ed.
  Explicitly-seeded constructors (``random.Random(key)``,
  ``np.random.default_rng(seed)``, ``Generator``/``PCG64``/
  ``Philox``/``SeedSequence`` with args) and an explicit, seeded
  ``generator=`` (the port's counterpart of the reference's
  threaded-key ``jax.random``) are fine;
- environment reads (``os.environ`` / ``os.getenv``) — replay on a
  different worker sees a different environment;
- ``id()`` used as a VALUE — CPython addresses differ across
  processes.  Using ``id()`` as an identity-map KEY within one process
  (subscript slice, ``in`` test, ``.add/.get/...`` argument) is the
  legal idiom and exempt;
- iterating an unordered ``set``/``frozenset`` — element order is
  hash-seed dependent (wrap in ``sorted(...)``);
- mutable module-global writes from function bodies (``global``
  statements, or mutating a module-level dict/list/set) — replay
  order changes the state the next execution sees.

Scope: the kernel registry and everything it can reach plus the seeded
jitter paths the retry machinery depends on (``exec/failure.py``,
``exec/stats.py``).
"""

from __future__ import annotations

import ast
from typing import Iterator, Set, Tuple

from dryad_tpu_torch.analysis import astutil
from dryad_tpu_torch.analysis.core import (
    FileChecker,
    Finding,
    Project,
    SourceFile,
    register,
)

SCOPE = (
    "dryad_tpu_torch/exec/kernels.py",
    "dryad_tpu_torch/exec/partial.py",
    "dryad_tpu_torch/exec/combinetree.py",
    "dryad_tpu_torch/exec/failure.py",
    "dryad_tpu_torch/exec/stats.py",
    "dryad_tpu_torch/api/decomposable.py",
    "dryad_tpu_torch/ops/",
    "dryad_tpu_torch/redundancy/",
)

# np.random constructors that are deterministic WHEN given a seed arg
_SEEDED_CTORS = ("default_rng", "Generator", "SeedSequence", "PCG64", "Philox")

# torch samplers that draw from the process-global generator unless
# given ``generator=``
_TORCH_SAMPLERS = (
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial",
)
# in-place Tensor samplers, same rule
_TENSOR_SAMPLERS = (
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
    "geometric_", "cauchy_", "log_normal_",
)

# method calls through which id() legally feeds an identity map
_KEY_SINKS = ("add", "get", "setdefault", "pop", "discard", "remove")

_MUTATORS = (
    "append", "add", "update", "setdefault", "pop", "clear",
    "extend", "insert", "remove", "popitem", "discard",
)


def _module_mutables(tree: ast.Module) -> Set[str]:
    """Names bound at module level to a mutable container literal."""
    out: Set[str] = set()
    for stmt in tree.body:
        targets = []
        value = None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        if value is None:
            continue
        mutable = isinstance(
            value,
            (ast.Dict, ast.List, ast.Set, ast.DictComp, ast.ListComp,
             ast.SetComp),
        ) or (
            isinstance(value, ast.Call)
            and astutil.dotted(value.func)[-1:]
            in (("dict",), ("list",), ("set",), ("defaultdict",))
        )
        if not mutable:
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                out.add(t.id)
    return out


def _set_iter_target(node: ast.expr) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    return (
        isinstance(node, ast.Call)
        and astutil.dotted(node.func) in (("set",), ("frozenset",))
    )


def _unseeded_generators(
    tree: ast.Module, parents
) -> Iterator[ast.Call]:
    """``torch.Generator(...)`` calls never ``manual_seed``-ed: neither
    chained (``torch.Generator().manual_seed(s)``) nor through the name
    or attribute they are bound to (``g.manual_seed(s)`` anywhere in
    the module)."""
    seeded = {
        astutil.dotted(n.func.value)
        for n in ast.walk(tree)
        if isinstance(n, ast.Call)
        and isinstance(n.func, ast.Attribute)
        and n.func.attr == "manual_seed"
    }
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call)
            and astutil.dotted(node.func) == ("torch", "Generator")
        ):
            continue
        parent = parents.get(node)
        if isinstance(parent, ast.Attribute) and parent.attr == "manual_seed":
            continue
        targets = []
        if isinstance(parent, ast.Assign):
            targets = parent.targets
        elif isinstance(parent, ast.AnnAssign):
            targets = [parent.target]
        if any(astutil.dotted(t) in seeded for t in targets if astutil.dotted(t)):
            continue
        yield node


@register
class KernelDeterminismChecker(FileChecker):
    rule = "kernel-determinism"
    summary = (
        "kernel-reachable code is replay-deterministic: no wall clock, "
        "unseeded RNG, env reads, id() values, set iteration, or "
        "mutable-global writes"
    )
    hint = (
        "derive the value from injected inputs/seeds (or sorted() the "
        "iteration); if genuinely replay-safe, suppress with a reason"
    )
    prefixes = SCOPE

    def check_file(
        self, src: SourceFile, project: Project
    ) -> Iterator[Finding]:
        tree = src.tree
        parents = astutil.parent_map(tree)
        mutables = _module_mutables(tree)
        from_imports = {
            a.asname or a.name: node.module
            for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and node.module
            for a in node.names
        }

        in_function: Set[int] = set()
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for sub in ast.walk(fn):
                    in_function.add(id(sub))

        for node in ast.walk(tree):
            # --- wall clock + RNG + env, all call-shaped hazards
            if isinstance(node, ast.Call):
                chain = astutil.dotted(node.func)
                has_args = bool(node.args or node.keywords)
                if chain[:1] == ("time",) and len(chain) == 2:
                    yield self.finding(
                        src.rel,
                        node.lineno,
                        f"wall-clock read {'.'.join(chain)}() — two "
                        "executions observe two values",
                    )
                elif chain == ("os", "getenv") or chain[:2] == (
                    "os",
                    "environ",
                ):
                    yield self.finding(
                        src.rel,
                        node.lineno,
                        f"environment read {'.'.join(chain)}() — "
                        "replay on another worker sees another value",
                    )
                elif chain[:1] == ("random",) and len(chain) == 2:
                    if chain[1] == "Random" and has_args:
                        pass  # explicitly seeded
                    else:
                        yield self.finding(
                            src.rel,
                            node.lineno,
                            f"unseeded randomness {'.'.join(chain)}() — "
                            "seed it from an injected key",
                        )
                elif (
                    len(chain) == 3
                    and chain[0] in ("np", "numpy")
                    and chain[1] == "random"
                ):
                    if chain[2] in _SEEDED_CTORS and has_args:
                        pass
                    else:
                        yield self.finding(
                            src.rel,
                            node.lineno,
                            f"unseeded randomness {'.'.join(chain)}() — "
                            "seed it from an injected key",
                        )
                elif (
                    chain[:1] == ("torch",)
                    and chain[-1] in _TORCH_SAMPLERS
                    or isinstance(node.func, ast.Attribute)
                    and node.func.attr in _TENSOR_SAMPLERS
                ) and not any(kw.arg == "generator" for kw in node.keywords):
                    yield self.finding(
                        src.rel,
                        node.lineno,
                        f"unseeded randomness {'.'.join(chain) or node.func.attr}() "
                        "draws from the global generator — pass a "
                        "seeded generator=",
                    )
                elif (
                    len(chain) == 1
                    and from_imports.get(chain[0]) in ("time", "random")
                ):
                    yield self.finding(
                        src.rel,
                        node.lineno,
                        f"{chain[0]}() imported from "
                        f"{from_imports[chain[0]]} — wall clock / "
                        "unseeded randomness",
                    )
                elif chain == ("id",):
                    parent = parents.get(node)
                    exempt = False
                    if isinstance(parent, ast.Subscript) and (
                        parent.slice is node
                    ):
                        exempt = True  # identity-map key
                    elif isinstance(parent, ast.Compare) and all(
                        isinstance(op, (ast.In, ast.NotIn))
                        for op in parent.ops
                    ):
                        exempt = True  # membership test
                    elif (
                        isinstance(parent, ast.Call)
                        and isinstance(parent.func, ast.Attribute)
                        and parent.func.attr in _KEY_SINKS
                        and node in parent.args
                    ):
                        exempt = True  # feeding an identity map/set
                    if not exempt:
                        yield self.finding(
                            src.rel,
                            node.lineno,
                            "id() used as a value — CPython addresses "
                            "differ across processes (identity-map "
                            "keys are exempt)",
                        )

            # --- environment reads that are not calls (os.environ[...])
            elif isinstance(node, ast.Attribute):
                if astutil.dotted(node) == ("os", "environ"):
                    parent = parents.get(node)
                    if not (
                        isinstance(parent, ast.Attribute)
                        or (
                            isinstance(parent, ast.Call)
                            and parent.func is node
                        )
                    ):
                        yield self.finding(
                            src.rel,
                            node.lineno,
                            "environment read os.environ[...] — replay "
                            "on another worker sees another value",
                        )

            # --- unordered iteration
            elif isinstance(node, ast.For):
                if _set_iter_target(node.iter):
                    yield self.finding(
                        src.rel,
                        node.iter.lineno,
                        "iterating an unordered set — element order is "
                        "hash-seed dependent; sorted() it",
                    )
            elif isinstance(node, ast.comprehension):
                if _set_iter_target(node.iter):
                    yield self.finding(
                        src.rel,
                        node.iter.lineno,
                        "comprehension over an unordered set — element "
                        "order is hash-seed dependent; sorted() it",
                    )

            # --- mutable global state
            elif isinstance(node, ast.Global):
                yield self.finding(
                    src.rel,
                    node.lineno,
                    f"global statement ({', '.join(node.names)}) — "
                    "re-execution order changes what replay observes",
                )
            elif isinstance(node, ast.Assign) and id(node) in in_function:
                for t in node.targets:
                    if (
                        isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and t.value.id in mutables
                    ):
                        yield self.finding(
                            src.rel,
                            node.lineno,
                            f"write into module-level mutable "
                            f"{t.value.id!r} from a function body",
                        )
            elif (
                isinstance(node, ast.AugAssign)
                and id(node) in in_function
                and isinstance(node.target, ast.Subscript)
                and isinstance(node.target.value, ast.Name)
                and node.target.value.id in mutables
            ):
                yield self.finding(
                    src.rel,
                    node.lineno,
                    f"write into module-level mutable "
                    f"{node.target.value.id!r} from a function body",
                )

        for node in _unseeded_generators(tree, parents):
            yield self.finding(
                src.rel,
                node.lineno,
                "torch.Generator() never manual_seed-ed — it starts "
                "from a nondeterministic seed",
            )

        # mutating method calls on module-level mutables, inside defs
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Call)
                and id(node) in in_function
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATORS
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in mutables
            ):
                yield self.finding(
                    src.rel,
                    node.lineno,
                    f"{node.func.value.id}.{node.func.attr}() mutates "
                    "module-level state from a function body",
                )
