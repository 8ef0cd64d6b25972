"""Checker: recompile hazards — shapes that bypass the pow2 palette.

The reference compiles one XLA program per distinct shape, and the
palette (``ops.stringcode.palette_domain``) quantizes every
data-dependent dimension to a pow2 domain so compiles stay O(log n).
The port's shapes key the same caches: its stage programs
(``exec/programs.py``) are keyed by the tables' ``operand_signature``
and the inputs' capacities, and each key is one CUDA-graph capture
that replays only the shapes it captured, so every raw length is a
new capture (an ``xla_compile``) and a new set of device buffers held
by the graph.
This checker flags the two ways code leaks raw sizes past the palette:

- in OPERAND-PROTOCOL classes (any class carrying an
  ``operand_signature`` / ``operand_arity`` surface — their array
  layouts key the operand cache): a host or device array constructor
  whose shape derives from a raw ``len(...)`` that was never quantized
  through ``palette_domain`` — every distinct input length becomes a
  distinct operand signature;
- in DEVICE bodies (the registered ``_k_*`` kernels plus
  ``apply_op``/``run_ops`` in ``exec/kernels.py``): any host-numpy
  array constructor (a host constant built and uploaded per call), any
  ``len()``-derived dimension in a ``torch.zeros/ones/empty/full``
  shape, and any non-pow2 literal dimension >= 16 (a magic size the
  palette cannot reproduce — widths must come from the
  operand/palette machinery).
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set, Tuple

from dryad_tpu_torch.analysis import astutil
from dryad_tpu_torch.analysis.core import (
    Checker,
    Finding,
    Project,
    SourceFile,
    register,
)
from dryad_tpu_torch.analysis.checks_operands import KERNELS_PATH

_CTORS = ("zeros", "ones", "empty", "full")


def _contains_len(node: ast.AST) -> bool:
    return any(
        isinstance(n, ast.Call) and astutil.dotted(n.func) == ("len",)
        for n in ast.walk(node)
    )


def _contains_palette(node: ast.AST) -> bool:
    return any(
        isinstance(n, ast.Call)
        and astutil.dotted(n.func)[-1:] == ("palette_domain",)
        for n in ast.walk(node)
    )


def _target_keys(t: ast.expr):
    """Taint keys for an assignment target: local names as "x", self
    attributes as "self.x"."""
    if isinstance(t, ast.Name):
        yield t.id
    elif isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name):
        yield f"{t.value.id}.{t.attr}"


def _expr_keys(node: ast.AST):
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            yield n.id
        elif isinstance(n, ast.Attribute) and isinstance(
            n.value, ast.Name
        ):
            yield f"{n.value.id}.{n.attr}"


def _quantized_and_raw(
    fns, seed_quantized: Set[str], seed_raw: Set[str]
) -> Tuple[Set[str], Set[str]]:
    """Fixpoint taint over assignments in *fns*: a target is QUANTIZED
    once its value routes through ``palette_domain`` (directly or via a
    quantized name), RAW when it derives from an unquantized
    ``len(...)``.  Quantized wins — ``2 * palette_domain(len(x))`` is
    palette-shaped."""
    quantized = set(seed_quantized)
    raw = set(seed_raw)
    changed = True
    while changed:
        changed = False
        for fn in fns:
            for stmt in ast.walk(fn):
                if not isinstance(stmt, ast.Assign):
                    continue
                keys = set(_expr_keys(stmt.value))
                q = _contains_palette(stmt.value) or bool(
                    keys & quantized
                )
                r = not q and (
                    _contains_len(stmt.value) or bool(keys & raw)
                )
                for t in stmt.targets:
                    for k in _target_keys(t):
                        if q and k not in quantized:
                            quantized.add(k)
                            raw.discard(k)
                            changed = True
                        elif r and k not in raw and k not in quantized:
                            raw.add(k)
                            changed = True
    return quantized, raw


def _shape_args(call: ast.Call):
    """The shape-bearing argument(s) of an array constructor call
    (``torch.zeros(n, m)`` spreads its shape over the positional
    arguments)."""
    if call.args:
        first = call.args[0]
        if (
            len(call.args) > 1
            and astutil.dotted(call.func)[:1] == ("torch",)
            and astutil.dotted(call.func)[-1:] != ("full",)
        ):
            first = ast.Tuple(elts=list(call.args), ctx=ast.Load())
            ast.copy_location(first, call.args[0])
        yield first
    for kw in call.keywords:
        if kw.arg == "shape":
            yield kw.value


@register
class RecompileHazardChecker(Checker):
    rule = "recompile-hazard"
    summary = (
        "no len()-derived or off-palette literal dims in operand "
        "layouts or device bodies (a cache key and an allocation per "
        "shape)"
    )
    hint = "quantize the dimension through palette_domain(...)"

    def check(self, project: Project) -> Iterator[Finding]:
        for src in project.package_files():
            yield from self._check_operand_classes(src)
        ksrc = project.file(KERNELS_PATH)
        if ksrc is not None:
            yield from self._check_device_bodies(ksrc)

    # -- operand-protocol classes ------------------------------------
    def _check_operand_classes(
        self, src: SourceFile
    ) -> Iterator[Finding]:
        for cls in ast.walk(src.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            surface = False
            for stmt in cls.body:
                if (
                    isinstance(stmt, ast.FunctionDef)
                    and stmt.name == "operand_signature"
                ):
                    surface = True
                if isinstance(stmt, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "operand_arity"
                    for t in stmt.targets
                ):
                    surface = True
                if (
                    isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)
                    and stmt.target.id == "operand_arity"
                ):
                    surface = True
            if not surface:
                continue
            methods = [
                n for n in cls.body if isinstance(n, ast.FunctionDef)
            ]
            quantized, raw = _quantized_and_raw(methods, set(), set())
            for fn in methods:
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Call):
                        continue
                    chain = astutil.dotted(node.func)
                    if not (
                        len(chain) == 2
                        and chain[0] in ("np", "numpy", "torch")
                        and chain[1] in _CTORS
                    ):
                        continue
                    for shape in _shape_args(node):
                        if _contains_palette(shape):
                            continue
                        if _contains_len(shape):
                            yield self.finding(
                                src.rel,
                                node.lineno,
                                f"{cls.name}.{fn.name}: raw len() in "
                                f"{'.'.join(chain)} shape — every "
                                "input length becomes a distinct "
                                "operand signature and cache key",
                            )
                            continue
                        bad = sorted(
                            set(_expr_keys(shape)) & raw
                        )
                        if bad:
                            yield self.finding(
                                src.rel,
                                node.lineno,
                                f"{cls.name}.{fn.name}: shape uses "
                                f"{bad} derived from len() without "
                                "palette_domain quantization",
                            )

    # -- device bodies in exec/kernels.py ----------------------------
    def _check_device_bodies(self, src: SourceFile) -> Iterator[Finding]:
        tree = src.tree
        kernels = astutil.literal_dict(tree, "_KERNELS")
        names = set()
        if kernels is not None:
            names = {
                v.id for v in kernels.values() if isinstance(v, ast.Name)
            }
        names |= {"apply_op", "run_ops"}
        defs = astutil.function_defs(tree)
        for name in sorted(names):
            fn = defs.get(name)
            if fn is None:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                chain = astutil.dotted(node.func)
                if len(chain) != 2 or chain[1] not in (
                    _CTORS + ("asarray", "array", "arange")
                ):
                    continue
                if chain[0] in ("np", "numpy"):
                    yield self.finding(
                        src.rel,
                        node.lineno,
                        f"{name}: host-numpy {'.'.join(chain)}() in a "
                        "device body builds and uploads a host constant "
                        "per call",
                        hint="use torch with palette-quantized shapes",
                    )
                    continue
                if chain[0] != "torch" or chain[1] not in _CTORS:
                    continue
                for shape in _shape_args(node):
                    if _contains_palette(shape):
                        continue
                    if _contains_len(shape):
                        yield self.finding(
                            src.rel,
                            node.lineno,
                            f"{name}: len()-derived dim in "
                            f"torch.{chain[1]} shape — a distinct "
                            "shape per distinct length",
                        )
                        continue
                    elts = (
                        shape.elts
                        if isinstance(shape, ast.Tuple)
                        else [shape]
                    )
                    for e in elts:
                        if (
                            isinstance(e, ast.Constant)
                            and isinstance(e.value, int)
                            and e.value >= 16
                            and e.value & (e.value - 1) != 0
                        ):
                            yield self.finding(
                                src.rel,
                                e.lineno,
                                f"{name}: literal dim {e.value} in "
                                f"torch.{chain[1]} shape is off the pow2 "
                                "palette",
                            )
