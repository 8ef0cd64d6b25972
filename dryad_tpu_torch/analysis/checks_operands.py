"""Checker: the OPERAND_PARAMS registry vs the kernel bodies.

``exec/kernels.py`` registers (op kind, param name) pairs whose tables
travel as device operands (``ctx.operand``, the executor's
``exec/operands.py::DeviceOperandPool``, keyed by the table's buffer
layout) instead of being built per call.  The registry is only honest if the
kernels obey it, enforced in BOTH directions:

- a kernel registered for an operand param must never materialize that
  param through a host-constant path (``asarray``/``array``/
  ``device_put`` on anything aliasing the param) and must route every
  table-method call through ``operands=ctx.operand(...)`` — otherwise
  the table's content is uploaded per call outside the operand cache,
  and the executor's tier-keyed cache no longer describes what ran;
- a kernel that calls ``ctx.operand(...)`` must belong to an op kind
  with a registered operand param — otherwise the executor's operand
  split never keys it;
- every registered pair must point at a real kernel that actually
  references the param name (no stale registry entries).
"""

from __future__ import annotations

import ast
from typing import Iterator

from dryad_tpu_torch.analysis import astutil
from dryad_tpu_torch.analysis.core import Checker, Finding, Project, register

KERNELS_PATH = "dryad_tpu_torch/exec/kernels.py"

_BAKE_FNS = ("asarray", "array", "device_put")


def _param_mentions(fn_ast: ast.FunctionDef, param: str):
    """Predicate: does an expression subtree reach ``p["<param>"]`` /
    ``p.get("<param>")`` or a local name assigned from one?  Call
    RESULTS (``codes = table.lookup(...)``) are arrays, not the table,
    and do not propagate."""
    tainted = set()

    def direct(node) -> bool:
        if isinstance(node, ast.Subscript):
            if (
                isinstance(node.value, ast.Name)
                and node.value.id == "p"
                and isinstance(node.slice, ast.Constant)
                and node.slice.value == param
            ):
                return True
        if isinstance(node, ast.Call):
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr == "get"
                and isinstance(f.value, ast.Name)
                and f.value.id == "p"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == param
            ):
                return True
        return False

    def is_alias(node) -> bool:
        return direct(node) or (
            isinstance(node, ast.Name) and node.id in tainted
        )

    changed = True
    while changed:
        changed = False
        for stmt in ast.walk(fn_ast):
            if isinstance(stmt, ast.Assign) and is_alias(stmt.value):
                for t in stmt.targets:
                    if isinstance(t, ast.Name) and t.id not in tainted:
                        tainted.add(t.id)
                        changed = True

    def mentions(node) -> bool:
        return any(is_alias(n) for n in ast.walk(node))

    return mentions


def _calls_ctx_operand(node) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "operand"
        and isinstance(node.func.value, ast.Name)
        and node.func.value.id == "ctx"
    )


@register
class OperandRegistryChecker(Checker):
    rule = "operand-registry"
    summary = (
        "OPERAND_PARAMS entries and ctx.operand() usage agree in both "
        "directions; operand params never bypass the operand cache"
    )
    hint = (
        "route table arrays through operands=ctx.operand(<param>) and "
        "keep OPERAND_PARAMS in sync with the kernels"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        src = project.file(KERNELS_PATH)
        if src is None:
            return
        tree = src.tree
        kernels = astutil.literal_dict(tree, "_KERNELS")
        params = astutil.literal_pair_set(tree, "OPERAND_PARAMS")
        if kernels is None or params is None:
            yield self.finding(
                src.rel,
                1,
                "could not parse _KERNELS / OPERAND_PARAMS literals",
                hint="keep both registries as plain literals",
            )
            return
        kernel_names = {
            kind: v.id
            for kind, v in kernels.items()
            if isinstance(v, ast.Name)
        }
        defs = astutil.function_defs(tree)
        reg_stmt = astutil.find_assign(tree, "OPERAND_PARAMS")
        reg_line = reg_stmt.lineno if reg_stmt is not None else 1

        # direction 1: registered params never baked, always routed
        for kind, param in sorted(params):
            fname = kernel_names.get(kind)
            fn_ast = defs.get(fname) if fname else None
            if fn_ast is None:
                yield self.finding(
                    src.rel,
                    reg_line,
                    f"OPERAND_PARAMS names op kind {kind!r} with no "
                    "registered kernel",
                )
                continue
            mentions = _param_mentions(fn_ast, param)
            operand_names = {
                t.id
                for stmt in ast.walk(fn_ast)
                if isinstance(stmt, ast.Assign)
                and _calls_ctx_operand(stmt.value)
                for t in stmt.targets
                if isinstance(t, ast.Name)
            }
            saw_table_call = False
            for node in ast.walk(fn_ast):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if (
                    isinstance(f, ast.Attribute)
                    and f.attr in _BAKE_FNS
                    and any(mentions(a) for a in node.args)
                ):
                    yield self.finding(
                        src.rel,
                        node.lineno,
                        f"{fname}: {f.attr}() on operand param "
                        f"({kind!r}, {param!r}) uploads table content "
                        "outside the operand cache",
                    )
                if (
                    isinstance(f, ast.Attribute)
                    and f.attr not in ("get",)
                    and mentions(f.value)
                ):
                    saw_table_call = True
                    ok = any(
                        kw.arg == "operands"
                        and (
                            _calls_ctx_operand(kw.value)
                            or (
                                isinstance(kw.value, ast.Name)
                                and kw.value.id in operand_names
                            )
                        )
                        for kw in node.keywords
                    )
                    if not ok:
                        yield self.finding(
                            src.rel,
                            node.lineno,
                            f"{fname}: {f.attr}() on operand param "
                            f"({kind!r}, {param!r}) without "
                            "operands=ctx.operand(...)",
                        )
            if not saw_table_call:
                yield self.finding(
                    src.rel,
                    fn_ast.lineno,
                    f"{fname}: registered operand param ({kind!r}, "
                    f"{param!r}) is never used — stale registry entry",
                )
                continue
            # registry honesty: the kernel must reference the param name
            consts = {
                n.value
                for n in ast.walk(fn_ast)
                if isinstance(n, ast.Constant) and isinstance(n.value, str)
            }
            if param not in consts:
                yield self.finding(
                    src.rel,
                    fn_ast.lineno,
                    f"kernel for {kind!r} never references param "
                    f"{param!r}",
                )

        # direction 2: ctx.operand() only in registered kernels
        registered_kinds = {k for k, _ in params}
        for kind, fname in sorted(kernel_names.items()):
            fn_ast = defs.get(fname)
            if fn_ast is None or kind in registered_kinds:
                continue
            for node in ast.walk(fn_ast):
                if _calls_ctx_operand(node):
                    yield self.finding(
                        src.rel,
                        node.lineno,
                        f"{fname} (op {kind!r}) calls ctx.operand() "
                        "without a registered OPERAND param — nothing "
                        "ever binds the arrays it asks for",
                    )
                    break
