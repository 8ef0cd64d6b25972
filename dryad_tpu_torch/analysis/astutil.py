"""Shared AST helpers for graftlint checkers.

Registries are read as LITERALS from the AST (never imported), so the
same checkers run identically over the real tree and over the
synthetic fixture projects the self-tests build.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

# attribute calls that move a tensor's data to the host (each waits
# for the device); ``.to("cpu")`` and ``<stream|event>.synchronize()``
# are matched by shape in :func:`transfer_call`
HOST_TRANSFER_ATTRS = ("item", "cpu", "tolist", "numpy")
# host copies of whatever they are given: ``np.asarray``/``np.array``
# of a tensor reads it back (``torch.as_tensor``/``torch.asarray``
# stay on the device and are exempt)
HOST_COPY_FNS = ("asarray", "array")
_HOST_NP = ("np", "numpy")


def dotted(node: ast.AST) -> Tuple[str, ...]:
    """``np.random.seed`` -> ("np", "random", "seed"); () if the chain
    bottoms out in anything but a Name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    out: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            out[child] = node
    return out


def function_defs(tree: ast.AST) -> Dict[str, ast.FunctionDef]:
    """name -> FunctionDef for every def in the subtree (methods and
    nested defs included; later defs win on name collision)."""
    return {
        n.name: n
        for n in ast.walk(tree)
        if isinstance(n, ast.FunctionDef)
    }


def find_function(tree: ast.AST, name: str) -> Optional[ast.FunctionDef]:
    return function_defs(tree).get(name)


def find_class(tree: ast.AST, name: str) -> Optional[ast.ClassDef]:
    for n in ast.walk(tree):
        if isinstance(n, ast.ClassDef) and n.name == name:
            return n
    return None


def find_assign(tree: ast.Module, name: str) -> Optional[ast.stmt]:
    """Top-level ``NAME = ...`` / ``NAME: T = ...`` statement."""
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    return stmt
        elif isinstance(stmt, ast.AnnAssign):
            if (
                isinstance(stmt.target, ast.Name)
                and stmt.target.id == name
                and stmt.value is not None
            ):
                return stmt
    return None


def _assign_value(stmt: ast.stmt) -> ast.expr:
    return stmt.value  # type: ignore[attr-defined]


def _set_elements(value: ast.expr) -> Optional[List[ast.expr]]:
    """Elements of a set-ish literal: ``{...}``, ``frozenset({...})``,
    ``set([...])``, or a bare list/tuple."""
    if isinstance(value, ast.Call):
        f = value.func
        if (
            isinstance(f, ast.Name)
            and f.id in ("frozenset", "set")
            and len(value.args) == 1
        ):
            value = value.args[0]
        else:
            return None
    if isinstance(value, (ast.Set, ast.List, ast.Tuple)):
        return list(value.elts)
    return None


def literal_str_set(tree: ast.Module, name: str) -> Optional[Set[str]]:
    """``NAME = frozenset({"a", "b"})`` -> {"a", "b"}."""
    stmt = find_assign(tree, name)
    if stmt is None:
        return None
    elts = _set_elements(_assign_value(stmt))
    if elts is None:
        return None
    out = set()
    for e in elts:
        if not (isinstance(e, ast.Constant) and isinstance(e.value, str)):
            return None
        out.add(e.value)
    return out


def literal_pair_set(
    tree: ast.Module, name: str
) -> Optional[Set[Tuple[str, str]]]:
    """``NAME = frozenset({("k", "p"), ...})`` -> {("k", "p"), ...}."""
    stmt = find_assign(tree, name)
    if stmt is None:
        return None
    elts = _set_elements(_assign_value(stmt))
    if elts is None:
        return None
    out = set()
    for e in elts:
        if not (isinstance(e, ast.Tuple) and len(e.elts) == 2):
            return None
        k, v = e.elts
        if not (
            isinstance(k, ast.Constant)
            and isinstance(k.value, str)
            and isinstance(v, ast.Constant)
            and isinstance(v.value, str)
        ):
            return None
        out.add((k.value, v.value))
    return out


def literal_dict(
    tree: ast.Module, name: str
) -> Optional[Dict[str, ast.expr]]:
    """``NAME = {"k": <expr>, ...}`` -> {"k": <expr node>}."""
    stmt = find_assign(tree, name)
    if stmt is None:
        return None
    value = _assign_value(stmt)
    if not isinstance(value, ast.Dict):
        return None
    out: Dict[str, ast.expr] = {}
    for k, v in zip(value.keys, value.values):
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
            return None
        out[k.value] = v
    return out


def imported_modules(tree: ast.AST) -> Iterator[str]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def raises_spans(tree: ast.AST) -> List[Tuple[int, int]]:
    """Line spans of ``with pytest.raises(...)`` bodies — constructs in
    there are EXPECTED to violate contracts (negative tests)."""
    spans = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.With):
            continue
        for item in node.items:
            c = item.context_expr
            if (
                isinstance(c, ast.Call)
                and getattr(c.func, "attr", "") == "raises"
            ):
                spans.append((node.lineno, node.end_lineno or node.lineno))
    return spans


def in_spans(line: int, spans: Sequence[Tuple[int, int]]) -> bool:
    return any(lo <= line <= hi for lo, hi in spans)


def _is_cpu_device(node: ast.expr) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (
        isinstance(node, ast.Call)
        and dotted(node.func)[-1:] == ("device",)
        and bool(node.args)
        and _is_cpu_device(node.args[0])
    )


def transfer_call(n: ast.Call) -> Optional[str]:
    """The rendered call when *n* moves device data to the host or
    waits for the device, else None."""
    f = n.func
    if not isinstance(f, ast.Attribute):
        return None
    attr = f.attr
    base = f.value
    base_name = ".".join(dotted(base)) or "<expr>"
    what = f"{base_name}.{attr}()"
    if attr in HOST_TRANSFER_ATTRS or attr == "synchronize":
        return what
    if attr == "to":
        dev = [kw.value for kw in n.keywords if kw.arg == "device"]
        if any(_is_cpu_device(a) for a in list(n.args[:1]) + dev):
            return f"{base_name}.to('cpu')"
        return None
    if attr in HOST_COPY_FNS:
        chain = dotted(base)
        if chain and chain[-1] in _HOST_NP:
            return what
    return None


def host_transfer_calls(node: ast.AST) -> List[Tuple[int, str]]:
    """(lineno, rendered call) for every host-transfer call in the
    subtree (:func:`transfer_call`), plus ``float()``/``int()``/
    ``bool()`` collapsing a device value (the argument contains a
    ``torch.*`` call)."""
    hits = []
    for n in ast.walk(node):
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        what = transfer_call(n)
        if what is not None:
            hits.append((n.lineno, what))
        elif (
            isinstance(f, ast.Name)
            and f.id in ("float", "int", "bool")
            and n.args
        ):
            for sub in ast.walk(n.args[0]):
                if isinstance(sub, ast.Call) and dotted(sub.func)[:1] == (
                    "torch",
                ):
                    hits.append(
                        (n.lineno, f"{f.id}() on a device value")
                    )
                    break
    return hits
