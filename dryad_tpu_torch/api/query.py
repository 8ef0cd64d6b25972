"""Query — the lazy table handle and its operators.

The counterpart of ``dryad_tpu/api/query.py``: ``select``, ``project``,
``where``, ``select_many``, ``of_type``, ``group_by`` (dense and sort
path, ``salt``, int64/float64 aggregates, a ``Decomposable``),
``distinct``, the partitioning operators and their ``assume_*`` claims,
``order_by``, the joins (``join``, ``semi_join``, ``anti_join``,
``left_join``, ``group_join`` in its count, aggregate and selector
forms, ``group_join_count``), the set operators (``concat``, ``union``,
``intersect``, ``except_``), the rank and ordered operators
(``with_rank``, ``take``, ``skip``, ``tail``, ``take_while``,
``skip_while``, ``reverse``, ``default_if_empty``, ``zip_``,
``sequence_equal``, ``sliding_window``) and the element accessors
built on them, the user-function operators (``apply``, ``apply_host``,
``fork``), iteration (``do_while``) and materialization (``cache``),
the scalar and decomposable aggregates, ``collect``,
``collect_stream``, ``submit``, ``to_store`` and ``explain``.  Node
construction, validation and the auto-dense gates are the reference's,
so both packages build the same logical plan.  ``explain(analyze=True)``
runs the query and adds the runtime panels (the last job's phases,
diagnoses and critical path), as the reference's does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import operator

import numpy as np
import torch

from dryad_tpu_torch.api.decomposable import Decomposable
from dryad_tpu_torch.columnar.schema import ColumnType, Schema
from dryad_tpu_torch.plan import infer
from dryad_tpu_torch.plan.nodes import Node, PartitionInfo

KeyArg = Union[str, Sequence[str]]
OrderArg = Union[str, Tuple[str, Union[bool, str]]]  # True / "desc" = descending

JOIN_STRATEGIES = ("shuffle", "broadcast", "auto")


def _check_strategy(strategy: str) -> None:
    if strategy not in JOIN_STRATEGIES:
        raise ValueError(
            f"unknown join strategy {strategy!r}; expected one of {JOIN_STRATEGIES}"
        )

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

    def select_many(
        self,
        fn: Callable[[Dict], Tuple[Dict, Any]],
        factor: int,
        schema: Optional[Schema] = None,
    ) -> "Query":
        """Flat-map: each row becomes ``factor`` rows.  ``fn`` gets the
        physical columns flattened to ``(n,)`` tensors and returns
        ``(out_cols each (n, factor), valid (n, factor))``."""
        out_schema = schema or infer.infer_select_many_schema(self.schema, fn, factor)
        return Query(self.ctx, Node(
            "select_many", [self.node], out_schema, PartitionInfo(), fn=fn, factor=int(factor),
        ))

    # -- grouping -----------------------------------------------------------
    def group_by(
        self,
        keys: KeyArg,
        aggs: Optional[Dict[str, Tuple[str, Optional[str]]]] = None,
        decomposable: Optional[Decomposable] = None,
        dense: Optional[int] = None,
        salt: Optional[int] = None,
    ) -> "Query":
        """GroupBy with builtin aggregates (see the reference for the
        full contract).  ``dense=K`` declares the single INT32 key lies
        in [0, K): the dense bucket kernel then reduces it, sum/count/mean
        only, out-of-range rows dropped.  Without ``dense``, a group_by
        over one INT32 key with an ingest range [0, K) or one STRING key
        takes the same path automatically (``auto_dense_*``); every
        other group_by takes the sort path: partial reduce, hash
        exchange, final reduce (int64 aggregates exact, float64
        min/max/first).  ``salt=S`` spreads each key over S exchange
        destinations first, the escape hatch for heavy keys.
        ``decomposable`` reduces each group with a user's seed, merge
        and finalize instead: local combine, hash exchange, final
        combine."""
        keys = _keys(keys)
        if salt is not None:
            if salt < 2:
                raise ValueError("salt must be >= 2")
            if dense is not None or decomposable is not None:
                raise ValueError("salt applies to builtin-agg group_by only")
        if dense is not None:
            if decomposable is not None:
                raise ValueError("dense group_by takes builtin aggs only")
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
        fields: List[Tuple[str, ColumnType]] = [(k, self.schema.field(k).ctype) for k in keys]
        if decomposable is not None:
            fields += list(decomposable.out_fields)
            return Query(self.ctx, Node(
                "group_by", [self.node], Schema(fields), PartitionInfo.hashed(keys),
                keys=keys, decomposable=decomposable,
            ))
        if not aggs:
            raise ValueError("group_by needs aggs or a decomposable")
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

    def distinct(self, keys: Optional[KeyArg] = None) -> "Query":
        """Distinct rows over ``keys`` (default: every column).  One
        STRING column as the whole schema is the vocabulary query, which
        rides the auto-dense bucket path."""
        keys = _keys(keys) if keys is not None else self.schema.names
        auto = self.schema.names == list(keys) and self._auto_dense_eligible(
            keys, [("count", None, "#c")], None
        )
        return Query(self.ctx, Node(
            "distinct", [self.node], self.schema,
            PartitionInfo() if auto else PartitionInfo.hashed(keys),
            keys=keys, auto_dense=auto,
        ))

    # -- partitioning -----------------------------------------------------------
    def hash_partition(self, keys: KeyArg) -> "Query":
        keys = _keys(keys)
        return Query(self.ctx, Node(
            "hash_partition", [self.node], self.schema, PartitionInfo.hashed(keys), keys=keys,
        ))

    def range_partition(self, keys: KeyArg) -> "Query":
        """Range-partition by ``keys`` (each a name or ``(name, desc)``):
        equal keys share a partition, partitions in key order."""
        ks = _order_keys(_keys(keys))
        self._require_cols([n for n, _ in ks], "in range_partition")
        return Query(self.ctx, Node(
            "range_partition", [self.node], self.schema, PartitionInfo.ranged(ks), keys=ks,
        ))

    # -- ordering -------------------------------------------------------------
    def order_by(self, keys: Sequence[OrderArg]) -> "Query":
        """Global sort: the skew-spread range exchange, then a local sort
        (``take(n)`` right after fuses both into top-k)."""
        ks = _order_keys(keys)
        self._require_cols([n for n, _ in ks], "in order_by")
        return Query(self.ctx, Node(
            "order_by", [self.node], self.schema,
            PartitionInfo.ranged(ks, ks, spread=True), keys=ks,
        ))

    def assume_hash_partition(self, keys: KeyArg) -> "Query":
        return Query(self.ctx, Node(
            "assume_partition", [self.node], self.schema, PartitionInfo.hashed(_keys(keys)),
        ))

    def assume_range_partition(self, keys: KeyArg) -> "Query":
        return Query(self.ctx, Node(
            "assume_partition", [self.node], self.schema,
            PartitionInfo.ranged(_order_keys(_keys(keys))),
        ))

    def assume_order_by(self, keys: Sequence[OrderArg]) -> "Query":
        ks = _order_keys(keys)
        return Query(self.ctx, Node(
            "assume_partition", [self.node], self.schema, PartitionInfo.ranged(ks, ks),
        ))

    # -- rank operators (global engine order: partition-major) ----------------
    def with_rank(self, out: str = "rank") -> "Query":
        """Attach each row's global engine-order position as an INT32
        column (the indexed-operator primitive)."""
        if out in self.schema.names:
            raise ValueError(f"column {out!r} already exists")
        return Query(self.ctx, Node(
            "with_rank", [self.node], self.schema.with_field(out, ColumnType.INT32),
            self.node.partition, out=out,
        ))

    def take(self, n: int) -> "Query":
        """The first n rows of global engine order (after ``order_by``:
        of sort order; negative n gives an empty table)."""
        return Query(self.ctx, Node(
            "take", [self.node], self.schema, self.node.partition, n=max(0, int(n)),
        ))

    def skip(self, n: int) -> "Query":
        """Drop the first n rows of global engine order."""
        return Query(self.ctx, Node(
            "skip", [self.node], self.schema, self.node.partition, n=max(0, int(n)),
        ))

    def tail(self, n: int) -> "Query":
        """Keep the last n rows of global engine order."""
        return Query(self.ctx, Node(
            "tail", [self.node], self.schema, self.node.partition, n=max(0, int(n)),
        ))

    def take_while(self, fn: Callable[[Dict], Any]) -> "Query":
        """Rows strictly before the first predicate failure in global
        engine order (TakeWhile)."""
        return Query(self.ctx, Node("take_while", [self.node], self.schema, self.node.partition, fn=fn))

    def skip_while(self, fn: Callable[[Dict], Any]) -> "Query":
        """Rows from the first predicate failure onward (SkipWhile)."""
        return Query(self.ctx, Node("skip_while", [self.node], self.schema, self.node.partition, fn=fn))

    def reverse(self) -> "Query":
        """Global engine row order reversed."""
        return Query(self.ctx, Node("reverse", [self.node], self.schema, PartitionInfo()))

    def default_if_empty(self, defaults: Optional[Dict[str, Any]] = None) -> "Query":
        """If empty, a single row of ``defaults`` (logical column ->
        value; unlisted columns zero / empty string) on partition 0, so
        no placement claim survives."""
        return Query(self.ctx, Node(
            "default_if_empty", [self.node], self.schema, PartitionInfo(),
            defaults=self._physical_row(defaults or {}),
        ))

    def zip_(self, other: "Query", suffix: str = "_r") -> "Query":
        """Pair rows by global position; the shorter input's length
        (LINQ Zip).  Right names clashing with the left's get
        ``suffix``."""
        fields = [(f.name, f.ctype) for f in self.schema.fields]
        lnames = {f.name for f in self.schema.fields}
        for f in other.schema.fields:
            fields.append((f.name if f.name not in lnames else f"{f.name}{suffix}", f.ctype))
        return Query(self.ctx, Node(
            "zip", [self.node, other.node], Schema(fields), PartitionInfo(), suffix=suffix,
        ))

    def sequence_equal(self, other: "Query") -> bool:
        """Element-wise equality of two sequences in global engine
        order (SequenceEqual): same schema, same count, and a zip whose
        every row matches."""
        if [(f.name, f.ctype) for f in self.schema.fields] != [
            (f.name, f.ctype) for f in other.schema.fields
        ]:
            return False
        n1, n2 = self.count(), other.count()
        if n1 != n2:
            return False
        if n1 == 0:
            return True
        from dryad_tpu_torch.ops.join import _suffixed
        from dryad_tpu_torch.plan import keys as K

        suffix = "__sq"
        lcols = K.equality_cols(self.schema, self.schema.names)
        rcols = [_suffixed(c, suffix) for c in lcols]

        def fn(cols):
            m = None
            for a, b in zip(lcols, rcols):
                e = cols[a] == cols[b]
                m = e if m is None else (m & e)
            return {"eq": m}

        z = self.zip_(other, suffix=suffix)
        return bool(z.select(fn, schema=Schema([("eq", ColumnType.BOOL)])).all_("eq"))

    def sliding_window(self, size: int, cols: Optional[KeyArg] = None) -> "Query":
        """Windows of ``size`` consecutive rows of the global sequence:
        columns ``{c}_w{j}`` (the j-th row of the window), n - size + 1
        windows; non-split columns only."""
        cols = _keys(cols) if cols is not None else self.schema.names
        self._require_cols(cols, "in sliding_window")
        fields: List[Tuple[str, ColumnType]] = []
        for c in cols:
            ct = self.schema.field(c).ctype
            if ct.is_split:
                raise ValueError(f"sliding_window unsupported on {ct.value} column {c!r}")
            fields += [(f"{c}_w{j}", ct) for j in range(size)]
        return Query(self.ctx, Node(
            "sliding_window", [self.node], Schema(fields), PartitionInfo(),
            size=int(size), cols=cols,
        ))

    def of_type(self, tag_col: str, value: Any) -> "Query":
        """Rows whose type-tag column equals ``value`` (tag equality)."""
        self._require_cols([tag_col], "in of_type")
        if self.schema.field(tag_col).ctype.is_split:
            phys = self._physical_row({tag_col: value})
            h0, h1 = int(phys[f"{tag_col}#h0"]), int(phys[f"{tag_col}#h1"])

            def fn(cols):
                return (cols[f"{tag_col}#h0"] == h0) & (cols[f"{tag_col}#h1"] == h1)
        else:
            def fn(cols):
                return cols[tag_col] == value
        return self.where(fn)

    # -- element access (eager) -------------------------------------------------
    def _one_row(self, q: "Query") -> Optional[Dict[str, Any]]:
        table = q.collect()
        n = len(next(iter(table.values()), []))
        if n == 0:
            return None
        return {k: v[0] if np.asarray(v).ndim else v for k, v in table.items()}

    def first(self) -> Dict[str, Any]:
        row = self._one_row(self.take(1))
        if row is None:
            raise ValueError("first() on an empty sequence")
        return row

    def first_or_default(self) -> Optional[Dict[str, Any]]:
        return self._one_row(self.take(1))

    def last(self) -> Dict[str, Any]:
        row = self._one_row(self.tail(1))
        if row is None:
            raise ValueError("last() on an empty sequence")
        return row

    def last_or_default(self) -> Optional[Dict[str, Any]]:
        return self._one_row(self.tail(1))

    def single(self) -> Dict[str, Any]:
        table = self.take(2).collect()
        n = len(next(iter(table.values()), []))
        if n == 0:
            raise ValueError("single() on an empty sequence")
        if n > 1:
            raise ValueError("single() on a sequence with more than one row")
        return {k: v[0] for k, v in table.items()}

    def single_or_default(self) -> Optional[Dict[str, Any]]:
        table = self.take(2).collect()
        n = len(next(iter(table.values()), []))
        if n > 1:
            raise ValueError("single_or_default() on a sequence with more than one row")
        return {k: v[0] for k, v in table.items()} if n else None

    def element_at(self, n: int) -> Dict[str, Any]:
        if n < 0:
            raise IndexError(f"element_at({n}) out of range")
        row = self._one_row(self.skip(n).take(1))
        if row is None:
            raise IndexError(f"element_at({n}) out of range")
        return row

    def element_at_or_default(self, n: int) -> Optional[Dict[str, Any]]:
        if n < 0:
            return None
        return self._one_row(self.skip(n).take(1))

    def contains(self, row: Dict[str, Any]) -> bool:
        """Whole-row membership: a broadcast semi join against a one-row
        table."""
        if set(row) != set(self.schema.names):
            raise ValueError(f"contains() row must bind every column {self.schema.names}")
        arrays = {k: np.asarray([v]) for k, v in row.items()}
        one = self.ctx.from_arrays(arrays, schema=self.schema)
        return self.semi_join(one, self.schema.names, strategy="broadcast").count() > 0

    # -- joins ------------------------------------------------------------------
    def _join_partition_info(self, lk: List[str], strategy: str) -> PartitionInfo:
        """A broadcast join keeps the left side's placement; a shuffle
        join co-hash-partitions; ``auto`` is decided at run time, so
        nothing can be assumed."""
        if strategy == "broadcast":
            return self.node.partition
        if strategy == "auto":
            return PartitionInfo()
        return PartitionInfo.hashed(lk)

    def _join_fields(self, other: "Query", rk: List[str], suffix: str) -> List[Tuple[str, ColumnType]]:
        """Every left field, then the right side's non-key fields (names
        clashing with the left's get ``suffix``)."""
        fields = [(f.name, f.ctype) for f in self.schema.fields]
        lnames = {f.name for f in self.schema.fields}
        for f in other.schema.fields:
            if f.name in rk:
                continue
            fields.append((f.name if f.name not in lnames else f"{f.name}{suffix}", f.ctype))
        return fields

    def _join_keys(self, other, left_keys, right_keys, where="in join") -> Tuple[List[str], List[str]]:
        lk = _keys(left_keys)
        rk = _keys(right_keys) if right_keys is not None else lk
        self._require_cols(lk, f"{where} left keys")
        other._require_cols(rk, f"{where} right keys")
        return lk, rk

    def join(
        self,
        other: "Query",
        left_keys: KeyArg,
        right_keys: Optional[KeyArg] = None,
        expansion: float = 4.0,
        suffix: str = "_r",
        strategy: str = "auto",
    ) -> "Query":
        """Inner equi-join: co-hash-partition both sides and join each
        partition, or replicate a small right side to every partition
        (``strategy``: shuffle | broadcast | auto).  ``expansion`` sizes
        the pair buffer (output rows per input row); a larger need
        retries the stage with a doubled buffer."""
        _check_strategy(strategy)
        lk, rk = self._join_keys(other, left_keys, right_keys)
        return Query(self.ctx, Node(
            "join", [self.node, other.node], Schema(self._join_fields(other, rk, suffix)),
            self._join_partition_info(lk, strategy),
            left_keys=lk, right_keys=rk, join_kind="inner",
            expansion=expansion, suffix=suffix, strategy=strategy,
        ))

    def semi_join(
        self, other: "Query", left_keys: KeyArg,
        right_keys: Optional[KeyArg] = None, expansion: float = 4.0,
        strategy: str = "auto",
    ) -> "Query":
        return self._semi(other, left_keys, right_keys, expansion, False, strategy)

    def anti_join(
        self, other: "Query", left_keys: KeyArg,
        right_keys: Optional[KeyArg] = None, expansion: float = 4.0,
        strategy: str = "auto",
    ) -> "Query":
        return self._semi(other, left_keys, right_keys, expansion, True, strategy)

    def _semi(self, other, left_keys, right_keys, expansion, anti, strategy="shuffle") -> "Query":
        _check_strategy(strategy)
        lk, rk = self._join_keys(other, left_keys, right_keys)
        return Query(self.ctx, Node(
            "join", [self.node, other.node], self.schema,
            self._join_partition_info(lk, strategy),
            left_keys=lk, right_keys=rk,
            join_kind="anti" if anti else "semi", expansion=expansion,
            strategy=strategy,
        ))

    def left_join(
        self,
        other: "Query",
        left_keys: KeyArg,
        right_keys: Optional[KeyArg] = None,
        right_defaults: Optional[Dict[str, Any]] = None,
        expansion: float = 4.0,
        suffix: str = "_r",
        strategy: str = "auto",
    ) -> "Query":
        """Left-outer equi-join: unmatched left rows survive with
        default-valued right columns (zero / empty string unless
        ``right_defaults`` names a value)."""
        _check_strategy(strategy)
        lk, rk = self._join_keys(other, left_keys, right_keys)
        return Query(self.ctx, Node(
            "join", [self.node, other.node], Schema(self._join_fields(other, rk, suffix)),
            self._join_partition_info(lk, strategy),
            left_keys=lk, right_keys=rk, join_kind="left",
            expansion=expansion, suffix=suffix,
            right_defaults=other._physical_row(right_defaults or {}), strategy=strategy,
        ))

    def group_join(
        self,
        other: "Query",
        left_keys: KeyArg,
        right_keys: Optional[KeyArg] = None,
        aggs: Optional[Dict[str, Tuple[str, Optional[str]]]] = None,
        defaults: Optional[Dict[str, Any]] = None,
        expansion: float = 4.0,
        strategy: str = "auto",
        selector: Optional[Callable[["Query"], "Query"]] = None,
        order: Optional[Sequence[OrderArg]] = None,
        rank_limit: Optional[int] = None,
        lid_col: str = "gj_lid",
        rank_col: str = "gj_rank",
        suffix: str = "_r",
    ) -> "Query":
        """GroupJoin: per left row, the group of exactly matching right
        rows, in three shapes (see the reference for the contract):

        - neither ``aggs`` nor ``selector``: the match count per left row;
        - ``aggs``: aggregates over the group, by a right-side group_by
          and a left join (unmatched lefts get ``defaults``; counts 0);
        - ``selector``: the pairs (every left column, the right non-key
          columns, ``lid_col`` the global left-row id and ``rank_col``
          the match's rank in its group, by ``order`` when given) go
          through ``selector``, whose result keeps ``lid_col`` and is
          left-joined back onto the left rows.  ``rank_limit=k`` keeps
          each group's first k matches, bounded before pair expansion.
        """
        lk = _keys(left_keys)
        rk = _keys(right_keys) if right_keys is not None else lk
        if rank_limit is not None and selector is None:
            raise ValueError("group_join: rank_limit only applies to the selector form")
        if selector is not None:
            if aggs:
                raise ValueError("group_join: pass aggs OR selector, not both")
            for c in (lid_col, rank_col):
                if c in self.schema.names or c in other.schema.names:
                    raise ValueError(
                        f"group_join helper column {c!r} clashes with an "
                        "input column; rename via lid_col=/rank_col="
                    )
            left2 = self.with_rank(lid_col)
            pairs = left2._ranked_join(
                other, lk, rk, rank_out=rank_col, order=order,
                expansion=expansion, suffix=suffix, strategy=strategy,
                rank_limit=rank_limit,
            )
            sel = selector(pairs)
            if lid_col not in sel.schema.names:
                raise ValueError(
                    f"group_join selector result must keep the {lid_col!r} "
                    "column (one row per left-row group)"
                )
            out = left2.left_join(
                sel, [lid_col], right_defaults=defaults, expansion=2.0,
                suffix="_s", strategy=strategy,
            )
            return out.project([c for c in out.schema.names if c not in (lid_col, rank_col)])
        if not aggs:
            return self.group_join_count(other, lk, rk, expansion=expansion, strategy=strategy)
        right_agg = other.group_by(rk, aggs)
        dflt = dict(defaults or {})
        for out_name, (op, _col) in aggs.items():
            if op == "count" and out_name not in dflt:
                dflt[out_name] = 0
        return self.left_join(
            right_agg, lk, rk, right_defaults=dflt, expansion=expansion, strategy=strategy,
        )

    def _ranked_join(
        self,
        other: "Query",
        left_keys: List[str],
        right_keys: List[str],
        rank_out: str,
        order: Optional[Sequence[OrderArg]] = None,
        expansion: float = 4.0,
        suffix: str = "_r",
        strategy: str = "auto",
        rank_limit: Optional[int] = None,
    ) -> "Query":
        """Inner equi-join that also emits each pair's group-local match
        rank (:meth:`group_join`'s selector form)."""
        _check_strategy(strategy)
        if rank_limit is not None:
            try:  # any integral type (np.int32 etc.), not bool
                if isinstance(rank_limit, (bool, np.bool_)):
                    raise TypeError
                rank_limit = operator.index(rank_limit)
            except TypeError:
                raise ValueError(f"rank_limit must be a positive int, got {rank_limit!r}") from None
            if rank_limit < 1:
                raise ValueError(f"rank_limit must be a positive int, got {rank_limit!r}")
        self._require_cols(left_keys, "in group_join left keys")
        other._require_cols(right_keys, "in group_join right keys")
        ks = _order_keys(order) if order is not None else None
        if ks is not None:
            other._require_cols([n for n, _ in ks], "in group_join order")
        fields = self._join_fields(other, right_keys, suffix) + [(rank_out, ColumnType.INT32)]
        return Query(self.ctx, Node(
            "join", [self.node, other.node], Schema(fields),
            self._join_partition_info(left_keys, strategy),
            left_keys=left_keys, right_keys=right_keys, join_kind="ranked",
            rank_out=rank_out, order=ks, expansion=expansion, suffix=suffix,
            strategy=strategy, rank_limit=rank_limit,
        ))

    def group_join_count(
        self,
        other: "Query",
        left_keys: KeyArg,
        right_keys: Optional[KeyArg] = None,
        out: str = "match_count",
        expansion: float = 4.0,
        strategy: str = "auto",
    ) -> "Query":
        """Per left row, the count of matching right rows as a new INT32
        column."""
        _check_strategy(strategy)
        lk, rk = self._join_keys(other, left_keys, right_keys, "in group_join")
        fields = [(f.name, f.ctype) for f in self.schema.fields] + [(out, ColumnType.INT32)]
        return Query(self.ctx, Node(
            "join", [self.node, other.node], Schema(fields),
            self._join_partition_info(lk, strategy),
            left_keys=lk, right_keys=rk, join_kind="count",
            expansion=expansion, out=out, strategy=strategy,
        ))

    def _physical_row(self, values: Dict[str, Any]) -> Dict[str, Any]:
        """One logical row (missing columns -> zero / empty string) as
        physical column scalars, strings registered in the context
        dictionary."""
        from dryad_tpu_torch.columnar.batch import encode_physical

        row: Dict[str, Any] = {}
        for f in self.schema.fields:
            v = values.get(f.name)
            if v is None:
                v = "" if f.ctype == ColumnType.STRING else 0
            enc = encode_physical(f, np.asarray([v]), self.ctx.dictionary)
            row.update({k: np.asarray(a)[0] for k, a in enc.items()})
        return row

    def aggregate_decomposable(self, dec: Decomposable) -> Dict[str, Any]:
        """Whole-table custom aggregate: a one-group ``group_by`` with
        ``dec``; returns the single result row."""
        phys = self.schema.device_names()

        def add_key(cols):
            out = {c: cols[c] for c in phys}
            out["__g"] = torch.zeros_like(next(iter(cols.values())), dtype=torch.int32)
            return out

        keyed = self.select(add_key, schema=self.schema.with_field("__g", ColumnType.INT32))
        table = keyed.group_by("__g", decomposable=dec).project([n for n, _ in dec.out_fields]).collect()
        return {k: (v[0] if len(v) else None) for k, v in table.items()}

    # -- user functions, iteration, materialization ------------------------------
    def apply(
        self,
        fn: Callable,
        schema: Optional[Schema] = None,
        cap_factor: float = 1.0,
        with_index: bool = False,
    ) -> "Query":
        """Per-partition user function: ``fn(batch)`` (``fn(batch, i)``
        with ``with_index``, i the partition's index) over a
        one-partition ColumnBatch of ``(cap,)`` tensors, returning one;
        every partition's result has the same capacity.  ``cap_factor``
        scales the capacity later exchanges size for."""
        return Query(self.ctx, Node(
            "apply", [self.node], schema or self.schema, PartitionInfo(),
            fn=fn, cap_factor=cap_factor, with_index=with_index,
        ))

    def apply_host(self, fn: Callable, schema: Optional[Schema] = None) -> "Query":
        """Per-partition HOST callback: ``fn(cols, partition_index)``
        over the partition's valid rows as numpy arrays of *physical*
        columns (STRING as its ``#h0``..``#r1`` words) -> a dict of
        equal-length arrays, checked against ``schema`` and cast.  Each
        run costs a device->host->device round trip."""
        return Query(self.ctx, Node(
            "apply_host", [self.node], schema or self.schema, PartitionInfo(), fn=fn,
        ))

    def fork(self, fn: Callable, out_schemas: Sequence[Schema]) -> Tuple["Query", ...]:
        """Multi-output per-partition function: ``fn(batch)`` -> a tuple
        of one-partition batches, one query per ``out_schemas`` entry."""
        fork_node = Node(
            "fork", [self.node], self.schema, PartitionInfo(),
            fn=fn, out_schemas=list(out_schemas),
        )
        return tuple(
            Query(self.ctx, Node("fork_branch", [fork_node], s, PartitionInfo(), index=i))
            for i, s in enumerate(out_schemas)
        )

    def do_while(
        self,
        body: Callable[["Query"], "Query"],
        cond: Callable[["Query"], "Query"],
        max_iter: int = 100,
        device: bool = False,
    ) -> "Query":
        """Iterate ``body`` until ``cond`` (the current dataset -> a
        one-row bool query) yields False, at most ``max_iter`` rounds;
        the body runs before the first check (DoWhile).

        ``device=True``, and every loop under the default
        ``config.do_while_device_auto``, runs the WHOLE loop on the
        device when body and condition each lower to one stage and the
        body keeps the batch's columns, types and capacity: on the card
        one CUDA graph a run (``exec/devloop.py``), whose host reads the
        loop's flags once; on the CPU the same stages in a Python loop.
        Otherwise the driver loop runs it (a ``do_while_device_fallback``
        event is logged): each round runs the body's plan, built once
        and rebound to the new state, compacts the state, then runs the
        condition and reads its value on the host.  A body or condition
        that reads a device value on the host raises ``TypeError`` on
        the card, as the reference's trace does."""
        return Query(self.ctx, Node(
            "do_while", [self.node], self.schema, PartitionInfo(),
            body=body, cond=cond, max_iter=max_iter, device=device,
        ))

    def cache(self) -> "Query":
        """Execute now and return a query over the device-resident
        result, which later queries read instead of recomputing this
        one.  The table is pinned (the ingest cache's budget does not
        evict it) until ``ctx.release`` drops it, and carries this
        query's partition claim, so a consumer keyed the same elides
        its exchange."""
        batch = self.ctx.execute(self)
        return self.ctx._from_device_batch(batch, self.schema, partition=self.node.partition)

    # -- set operations -----------------------------------------------------------
    def concat(self, *others: "Query") -> "Query":
        for o in others:
            if o.schema.names != self.schema.names:
                raise ValueError("concat requires identical schemas")
        return Query(self.ctx, Node(
            "concat", [self.node] + [o.node for o in others], self.schema, PartitionInfo(),
        ))

    def union(self, other: "Query") -> "Query":
        return self.concat(other).distinct()

    def intersect(self, other: "Query") -> "Query":
        return self.distinct().semi_join(other, self.schema.names)

    def except_(self, other: "Query") -> "Query":
        return self.distinct().anti_join(other, self.schema.names)

    # -- scalar aggregates ----------------------------------------------------------
    def _aggregate_node(self, aggs: List[Tuple[str, Optional[str], str]]) -> Node:
        fields = []
        for op, col, out in aggs:
            ct = self.schema.field(col).ctype if col else ColumnType.INT32
            fields.append((out, _AGG_TYPE_RULES[op](ct)))
        return Node("aggregate", [self.node], Schema(fields), PartitionInfo(), aggs=aggs)

    def aggregate_as_query(self, aggs: Dict[str, Tuple[str, Optional[str]]]) -> "Query":
        lst = [(op, col, out) for out, (op, col) in aggs.items()]
        return Query(self.ctx, self._aggregate_node(lst))

    def count_as_query(self) -> "Query":
        return self.aggregate_as_query({"count": ("count", None)})

    def _scalar(self, op: str, col: Optional[str]):
        # min/max/mean/any/all of an empty table would show the
        # reduction's identity; the count beside it guards that
        q = self.aggregate_as_query({"v": (op, col), "n": ("count", None)})
        table = q.collect()
        if op not in ("count", "sum") and int(table["n"][0]) == 0:
            return None
        return table["v"][0].item()

    def count(self) -> int:
        return int(self._scalar("count", None))

    def sum_(self, col: str):
        return self._scalar("sum", col)

    def min_(self, col: str):
        return self._scalar("min", col)

    def max_(self, col: str):
        return self._scalar("max", col)

    def mean(self, col: str) -> float:
        return float(self._scalar("mean", col))

    def any_(self, col: str) -> bool:
        return bool(self._scalar("any", col))

    def all_(self, col: str) -> bool:
        return bool(self._scalar("all", col))

    # -- materialization ---------------------------------------------------------
    def collect(self) -> Dict[str, np.ndarray]:
        """Execute and fetch host logical columns."""
        return self.ctx.run_to_host(self)

    def collect_stream(self):
        """Execute and yield host tables one bounded piece at a time:
        a plan over a stream input (``from_stream`` and kin) yields the
        out-of-core driver's pieces (sorted buckets in key order, join
        buckets, ...), for results larger than host memory; any other
        plan yields its whole result once."""
        from dryad_tpu_torch.exec.outofcore import StreamExecutor, has_stream_input

        if not has_stream_input(self.ctx, self.node):
            yield self.collect()
            return
        _schema, tables = StreamExecutor(self.ctx).run_stream(self.node)
        yield from tables

    def submit(self) -> "JobHandle":
        return self.ctx.submit(self)

    def to_store(self, path: str) -> "JobHandle":
        """Execute and persist as a partitioned store (path or URI)."""
        return self.ctx.to_store(self, path)

    def explain(self, analyze: bool = False) -> str:
        """The logical plan, the stage graph and the fusion decision as
        text (``tools/explain.py``).  ``analyze=True`` EXECUTES the
        query first and appends the runtime-diagnosis panel (phase
        attribution plus any pathologies the online engine,
        ``obs/diagnose.py``, caught during the run) and the run's
        critical path (``obs/critpath.py``)."""
        from dryad_tpu_torch.obs import critpath, tracectx
        from dryad_tpu_torch.tools.explain import explain, explain_diagnoses

        text = explain(self)
        if analyze:
            # mint (or adopt) a trace context so the run's events are
            # qid-stamped, then fold them into the critical-path panel
            tctx = tracectx.current() or tracectx.mint()
            with tracectx.activate(tctx):
                self.collect()
            text += "\n\n" + explain_diagnoses(self.ctx)
            bd = critpath.fold_query(self.ctx.events.events(), tctx.qid)
            if bd is not None and bd.phases:
                text += "\n\n-- critical path --\n" + bd.format()
        return text

    def __iter__(self):
        """Execute and yield the result's rows as dicts."""
        table = self.collect()
        names = list(table.keys())
        n = len(table[names[0]]) if names else 0
        for i in range(n):
            yield {c: table[c][i] for c in names}


class JobHandle:
    """A completed job: its result table and, for ``to_store``, the
    store's path."""

    def __init__(self, table: Dict[str, np.ndarray], path: Optional[str] = None):
        self.table = table
        self.path = path

    def result(self) -> Dict[str, np.ndarray]:
        return self.table

