"""Query — the lazy table handle and its operators (ported subset).

The counterpart of ``dryad_tpu/api/query.py`` for ``select``,
``project``, ``where``, ``group_by``, ``order_by``, ``take`` and
``collect``.  Node construction, validation and the auto-dense gates are
the reference's, so both packages build the same logical plan; what
the planner cannot lower yet raises there (``plan/lower.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from dryad_tpu_torch.columnar.schema import ColumnType, Schema
from dryad_tpu_torch.plan import infer
from dryad_tpu_torch.plan.nodes import Node, PartitionInfo

KeyArg = Union[str, Sequence[str]]
OrderArg = Union[str, Tuple[str, Union[bool, str]]]  # True / "desc" = descending

_AGG_TYPE_RULES = {
    "count": lambda ct: ColumnType.INT32,
    "sum": lambda ct: ct,
    "min": lambda ct: ct,
    "max": lambda ct: ct,
    "first": lambda ct: ct,
    "mean": lambda ct: ColumnType.FLOAT32,
    "any": lambda ct: ColumnType.BOOL,
    "all": lambda ct: ColumnType.BOOL,
}

_PLAIN = (ColumnType.INT32, ColumnType.UINT32, ColumnType.FLOAT32, ColumnType.BOOL)


def _keys(k: KeyArg) -> List[str]:
    return [k] if isinstance(k, str) else list(k)


def _order_keys(keys: Sequence[OrderArg]) -> List[Tuple[str, bool]]:
    out: List[Tuple[str, bool]] = []
    for k in keys:
        if isinstance(k, str):
            out.append((k, False))
            continue
        name, d = k[0], k[1]
        if isinstance(d, str):
            if d not in ("asc", "desc"):
                raise ValueError(
                    f"order direction for {name!r} must be 'asc', 'desc' "
                    f"or a bool (True=descending), got {d!r}")
            d = d == "desc"
        out.append((name, bool(d)))
    return out


class _Project:
    """Name-projection row fn; VALUE-equal, as in the reference."""

    def __init__(self, phys: List[str]):
        self.phys = tuple(phys)

    def __eq__(self, other) -> bool:
        return type(other) is _Project and other.phys == self.phys

    def __hash__(self) -> int:
        return hash(("_Project", self.phys))

    def __call__(self, cols: Dict) -> Dict:
        return {c: cols[c] for c in self.phys}


# node kinds that pass column values through unchanged, so an ingest
# bound on a column (INT32 range, STRING vocabulary) still holds
_VALUE_PRESERVING = frozenset({
    "where", "take", "skip", "tail", "reverse", "order_by",
    "hash_partition", "range_partition", "assume_partition", "tee",
    "with_rank", "take_while", "skip_while", "distinct",
})


def _walk_bound(node, col, at_input, combine):
    """Walk an ingest-time column bound back through value-preserving
    nodes (and name-only projections); None once something could
    fabricate values."""
    if node.kind == "input":
        return at_input(node)
    if node.kind == "concat":
        bs = [_walk_bound(i, col, at_input, combine) for i in node.inputs]
        return None if any(b is None for b in bs) else combine(bs)
    if node.kind == "select" and isinstance(node.params.get("fn"), _Project):
        return _walk_bound(node.inputs[0], col, at_input, combine)
    if node.kind in _VALUE_PRESERVING and node.inputs:
        return _walk_bound(node.inputs[0], col, at_input, combine)
    return None


def static_str_vocab(node, col):
    """Static hash vocabulary of a STRING column, walked back to ingest:
    the union of the reaching ingests' hash sets, or None."""
    return _walk_bound(
        node, col,
        lambda n: (n.params.get("str_vocab") or {}).get(col),
        lambda vs: np.unique(np.concatenate(vs)) if vs else None,
    )


def int_key_range(node, col) -> Optional[Tuple[int, int]]:
    """Static (min, max) of an INT32 column, walked back to ingest."""
    return _walk_bound(
        node, col,
        lambda n: (n.params.get("col_stats") or {}).get(col),
        lambda rs: (min(r[0] for r in rs), max(r[1] for r in rs)),
    )


class Query:
    """Lazy distributed table: a logical plan node plus its context."""

    def __init__(self, ctx, node: Node):
        self.ctx = ctx
        self.node = node

    @property
    def schema(self) -> Schema:
        return self.node.schema

    def _require_cols(self, names: Sequence[str], where: str = "") -> None:
        missing = [n for n in names if n not in self.schema]
        if missing:
            raise ValueError(
                f"unknown column(s) {missing} {where}; have {self.schema.names}"
            )

    # -- row-wise operators ----------------------------------------------
    def select(self, fn: Callable[[Dict], Dict], schema: Optional[Schema] = None) -> "Query":
        """Map over physical ``(P, cap)`` column tensors; partition
        metadata is dropped (``fn`` may rewrite key values)."""
        out_schema = schema or infer.infer_select_schema(self.schema, fn)
        return Query(self.ctx, Node("select", [self.node], out_schema, PartitionInfo(), fn=fn))

    def project(self, names: KeyArg) -> "Query":
        names = _keys(names)
        out_schema = self.schema.select(names)
        keep = self.node.partition
        if keep.keys and not all(k in out_schema for k in keep.keys):
            keep = PartitionInfo()
        fn = _Project(out_schema.device_names())
        return Query(self.ctx, Node("select", [self.node], out_schema, keep, fn=fn))

    def where(self, fn: Callable[[Dict], Any]) -> "Query":
        """Filter by a predicate over physical column tensors."""
        return Query(self.ctx, Node("where", [self.node], self.schema, self.node.partition, fn=fn))

    # -- grouping -----------------------------------------------------------
    def group_by(
        self,
        keys: KeyArg,
        aggs: Optional[Dict[str, Tuple[str, Optional[str]]]] = None,
        dense: Optional[int] = None,
        salt: Optional[int] = None,
    ) -> "Query":
        """GroupBy with builtin aggregates (see the reference for the
        full contract).  ``dense=K`` declares the single INT32 key lies
        in [0, K): the dense bucket kernel then reduces it, sum/count/mean
        only, out-of-range rows dropped.  Without ``dense``, a group_by
        over one INT32 key with an ingest range [0, K) or one STRING key
        takes the same path automatically (``auto_dense_*``); other
        group_bys need the sort path, which is not ported yet."""
        keys = _keys(keys)
        if salt is not None:
            if salt < 2:
                raise ValueError("salt must be >= 2")
            if dense is not None:
                raise ValueError("salt applies to builtin-agg group_by only")
        if dense is not None:
            if len(keys) != 1:
                raise ValueError("dense group_by requires exactly one key")
            if self.schema.field(keys[0]).ctype != ColumnType.INT32:
                raise ValueError("dense group_by key must be INT32")
            if dense < 1:
                raise ValueError("dense bucket count must be >= 1")
            if not aggs:
                raise ValueError("group_by needs aggs")
            bad = [op for _o, (op, _c) in aggs.items() if op not in ("sum", "count", "mean")]
            if bad:
                raise ValueError(f"dense group_by supports sum/count/mean, got {bad}")
            wide = [
                c for _o, (_op, c) in aggs.items()
                if c is not None and self.schema.field(c).ctype.is_split
            ]
            if wide:
                raise ValueError(
                    f"dense group_by aggregates f32 in the bucket kernel; "
                    f"columns {wide} are 64-bit/split types — use the "
                    f"sort-based path"
                )
        if not aggs:
            raise ValueError("group_by needs aggs")
        fields: List[Tuple[str, ColumnType]] = [(k, self.schema.field(k).ctype) for k in keys]
        agg_list = []
        for out_name, (op, col) in aggs.items():
            if op not in _AGG_TYPE_RULES:
                raise ValueError(f"unknown aggregate {op!r}")
            ct = self.schema.field(col).ctype if col is not None else ColumnType.INT32
            fields.append((out_name, _AGG_TYPE_RULES[op](ct)))
            agg_list.append((op, col, out_name))
        ranged = PartitionInfo.ranged([(keys[0], False)], ordered=[(keys[0], False)])
        if dense is not None:
            node = Node("group_by", [self.node], Schema(fields), ranged,
                        keys=keys, aggs=agg_list, dense=int(dense))
        elif (k_int := self._auto_dense_int(keys, agg_list, salt)) is not None:
            node = Node("group_by", [self.node], Schema(fields), ranged,
                        keys=keys, aggs=agg_list, dense=k_int, guard_range=True)
        else:
            auto = self._auto_dense_eligible(keys, agg_list, salt)
            part = PartitionInfo() if auto else PartitionInfo.hashed(keys)
            node = Node("group_by", [self.node], Schema(fields), part,
                        keys=keys, aggs=agg_list, salt=salt, auto_dense=auto)
        return Query(self.ctx, node)

    def _plain_aggs(self, agg_list) -> bool:
        return all(
            op in ("sum", "count", "mean")
            and (col is None or self.schema.field(col).ctype in _PLAIN)
            for op, col, _name in agg_list
        )

    def _auto_dense_int(self, keys, agg_list, salt) -> Optional[int]:
        """K when one INT32 key has ingest range [0, K), K <= limit."""
        cfg = self.ctx.config
        if salt or not cfg.auto_dense_ints or len(keys) != 1:
            return None
        if self.schema.field(keys[0]).ctype is not ColumnType.INT32:
            return None
        if not self._plain_aggs(agg_list):
            return None
        rng = int_key_range(self.node, keys[0])
        if rng is None or rng[0] < 0 or rng[1] + 1 > cfg.auto_dense_limit:
            return None
        return rng[1] + 1

    def _auto_dense_eligible(self, keys, agg_list, salt) -> bool:
        """Build-time gate of the auto-dense STRING group_by."""
        cfg = self.ctx.config
        d = self.ctx.dictionary
        if salt or not cfg.auto_dense_strings or len(d) == 0 or len(keys) != 1:
            return False
        vocab = static_str_vocab(self.node, keys[0])
        bound = len(vocab) if vocab is not None else len(d)
        if not 0 < bound <= cfg.auto_dense_limit:
            return False
        if self.schema.field(keys[0]).ctype is not ColumnType.STRING:
            return False
        return self._plain_aggs(agg_list)

    # -- ordering -------------------------------------------------------------
    def order_by(self, keys: Sequence[OrderArg]) -> "Query":
        """Global sort.  Only ``order_by(...).take(n)`` (fused top-k) is
        ported; a plain order_by raises at collect."""
        ks = _order_keys(keys)
        self._require_cols([n for n, _ in ks], "in order_by")
        return Query(self.ctx, Node(
            "order_by", [self.node], self.schema,
            PartitionInfo.ranged(ks, ks, spread=True), keys=ks,
        ))

    def take(self, n: int) -> "Query":
        return Query(self.ctx, Node(
            "take", [self.node], self.schema, self.node.partition, n=max(0, int(n)),
        ))

    def collect(self) -> Dict[str, np.ndarray]:
        """Execute and fetch host logical columns."""
        return self.ctx.run_to_host(self)
