"""LocalDebug — a NumPy interpreter over the logical plan (the
counterpart of ``dryad_tpu/exec/localdebug.py``).

The analog of the reference's LocalDebug provider, which runs the same
query through LINQ-to-Objects in-process for semantics debugging
(``DryadLinqContext.cs:966-983``, ``DryadLinqQuery.cs:55-137``).  This
interpreter executes logical nodes directly on dense host arrays with
independent (non-XLA) implementations, so differential tests can compare
the distributed engine against it.

Tables here are dicts of *physical* dense numpy columns (no validity
mask — rows are materialized).  User fns of ``select``/``where``/
``select_many``/``apply_host`` receive numpy-backed dicts; outputs are
converted back with ``np.asarray``.  Those of ``apply`` and ``fork`` get
a one-partition :class:`ColumnBatch` of CPU tensors, as the engine hands
them one partition (uint32 words ride as int64, as on the device); the
ordering keys are the engine's own operands over such a batch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np

import torch

from dryad_tpu_torch.columnar.batch import (
    ColumnBatch,
    decode_physical_table,
    encode_physical,
    to_device_column,
    to_host_column,
)
from dryad_tpu_torch.columnar.schema import Schema
from dryad_tpu_torch.plan import keys as K
from dryad_tpu_torch.plan.nodes import Node, walk

Table = Dict[str, np.ndarray]


def _rows(t: Table) -> int:
    for v in t.values():
        return len(v)
    return 0


def _take_rows(t: Table, idx) -> Table:
    return {k: np.asarray(v)[idx] for k, v in t.items()}


def _call(fn: Callable, cols: Table) -> Dict[str, np.ndarray]:
    out = fn({k: v for k, v in cols.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _join_split_col(t: Table, col: str) -> np.ndarray:
    """Signed-int64 view of a split (#h0/#h1) column's word pairs."""
    from dryad_tpu_torch.columnar.schema import join64

    return join64(
        np.asarray(t[f"{col}#h0"]), np.asarray(t[f"{col}#h1"]), signed=True
    )


def _key_tuples(t: Table, cols: List[str]) -> List[tuple]:
    arrs = [np.asarray(t[c]) for c in cols]
    return list(zip(*[a.tolist() for a in arrs])) if arrs else [()] * _rows(t)


class LocalDebugInterpreter:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cache: Dict[int, Any] = {}

    # -- public -------------------------------------------------------------
    def run_to_logical(self, root: Node) -> Dict[str, np.ndarray]:
        table = self.run(root)
        return self._decode(table, root.schema)

    def run(self, root: Node) -> Table:
        for node in walk([root]):
            if node.id not in self.cache:
                self.cache[node.id] = self._eval(node)
        val = self.cache[root.id]
        if isinstance(val, tuple):  # fork outputs
            raise RuntimeError("cannot collect a fork node directly")
        return val

    def _decode(self, table: Table, schema: Schema) -> Dict[str, np.ndarray]:
        # each physical column at its device type (words uint32, the rest
        # the schema's), as the engine's result batch holds them
        host = {}
        for f in schema.fields:
            for name in f.device_names:
                dt = np.uint32 if "#" in name else f.ctype.numpy_dtype
                host[name] = np.asarray(table[name]).astype(dt, copy=False)
        return decode_physical_table(schema, slice(None), host, self.ctx.dictionary)

    # -- node dispatch ------------------------------------------------------
    def _eval(self, node: Node) -> Any:
        m = getattr(self, f"_n_{node.kind}", None)
        if m is None:
            raise NotImplementedError(f"localdebug: node kind {node.kind!r}")
        return m(node)

    def _in(self, node: Node, i: int = 0) -> Table:
        return self.cache[node.inputs[i].id]

    # -- inputs -------------------------------------------------------------
    def _n_input(self, node: Node) -> Table:
        if node.id not in self.ctx._bindings:
            raise RuntimeError(
                f"input node {node.id} has no binding: the cached table "
                "was released — re-run .cache() or re-ingest"
            )
        kind, *rest = self.ctx._bindings[node.id]
        if kind == "host":
            arrays, _cap = rest
            out: Table = {}
            for f in node.schema.fields:
                out.update(encode_physical(f, np.asarray(arrays[f.name]), self.ctx.dictionary))
            return out
        if kind == "store":
            parts, _schema = rest
            out: Table = {}
            for c in parts[0].keys():
                out[c] = np.concatenate([p[c] for p in parts])
            return out
        if kind == "host_physical":
            phys = rest[0]
            return {k: np.asarray(v) for k, v in phys.items()}
        if kind == "table":  # bound by do_while recursion
            return rest[0]
        raise RuntimeError(f"localdebug: unsupported input binding {kind}")

    # -- row-wise -----------------------------------------------------------
    def _n_select(self, node: Node) -> Table:
        return _call(node.params["fn"], self._in(node))

    def _n_where(self, node: Node) -> Table:
        t = self._in(node)
        mask = np.asarray(node.params["fn"](dict(t))).astype(bool)
        return _take_rows(t, mask)

    def _n_select_many(self, node: Node) -> Table:
        t = self._in(node)
        out_cols, valid = node.params["fn"](dict(t))
        valid = np.asarray(valid).astype(bool).reshape(-1)
        flat = {}
        for k, v in out_cols.items():
            v = np.asarray(v)
            flat[k] = v.reshape((v.shape[0] * v.shape[1],) + tuple(v.shape[2:]))
        return {k: v[valid] for k, v in flat.items()}

    def _n_apply_host(self, node: Node) -> Table:
        t = self._in(node)
        out = node.params["fn"](dict(t), 0)
        phys = node.schema.device_names()
        if set(out.keys()) != set(phys):
            raise ValueError(
                f"apply_host fn output columns {sorted(out)} != "
                f"schema physical columns {phys}"
            )
        return {n: np.asarray(v) for n, v in out.items()}

    def _n_with_rank(self, node: Node) -> Table:
        t = self._in(node)
        n = len(next(iter(t.values()), []))
        out = dict(t)
        out[node.params["out"]] = np.arange(n, dtype=np.int32)
        return out

    def _n_assume_partition(self, node: Node) -> Table:
        return self._in(node)

    def _n_hash_partition(self, node: Node) -> Table:
        return self._in(node)

    def _n_range_partition(self, node: Node) -> Table:
        return self._in(node)

    def _n_tee(self, node: Node) -> Table:
        return self._in(node)

    # -- grouping -----------------------------------------------------------
    def _n_group_by(self, node: Node) -> Table:
        t = self._in(node)
        in_schema = node.inputs[0].schema
        keys = node.params["keys"]
        eq = K.equality_cols(in_schema, keys)
        carry = K.group_carry_cols(in_schema, keys)
        tuples = _key_tuples(t, eq)
        groups: Dict[tuple, List[int]] = {}
        for i, k in enumerate(tuples):
            groups.setdefault(k, []).append(i)
        order = list(groups.values())

        out: Table = {c: np.array([np.asarray(t[c])[idx[0]] for idx in order],
                                  dtype=np.asarray(t[c]).dtype)
                      for c in carry}

        dec = node.params.get("decomposable")
        if dec is not None:
            state = _call(dec.seed, t)
            full = dict(t)
            full.update(state)
            for c in dec.state_cols:
                vals = []
                for idx in order:
                    acc = {k: np.asarray(full[k])[idx[:1]] for k in dec.state_cols}
                    for j in idx[1:]:
                        nxt = {k: np.asarray(full[k])[j : j + 1] for k in dec.state_cols}
                        acc = {k: np.asarray(v) for k, v in dec.merge(acc, nxt).items()}
                    vals.append(acc[c][0])
                out[c] = np.array(vals)
            if dec.finalize is not None:
                out = _call(dec.finalize, out)
            want = K.group_carry_cols(node.schema, node.schema.names)
            return {c: out[c] for c in want}

        from dryad_tpu_torch.columnar.schema import ColumnType, split64

        for op, col, name in node.params["aggs"]:
            ctype = (
                in_schema.field(col).ctype if col is not None else None
            )
            if ctype is ColumnType.FLOAT64 and op in ("sum", "mean"):
                raise ValueError(
                    f"aggregate {op!r} unsupported on float64 column "
                    f"{col!r}: cast to float32"
                )
            if (
                col is not None
                and col not in t
                and (
                    (ctype is ColumnType.INT64 and op in ("sum", "min", "max"))
                    # FLOAT64 words are the order-preserving i64 image:
                    # min/max commute with the monotone transform
                    or (ctype is ColumnType.FLOAT64 and op in ("min", "max"))
                )
            ):
                # split 64-bit column: independent numpy-int64 oracle for
                # the engine's paired-word arithmetic (wrapping sum)
                full = _join_split_col(t, col)
                with np.errstate(over="ignore"):
                    vals64 = np.array(
                        [getattr(full[idx], op)() for idx in order], np.int64
                    )
                out[f"{name}#h0"], out[f"{name}#h1"] = split64(vals64)
                continue
            if (
                col is not None and col not in t
                and ctype is ColumnType.INT64 and op == "mean"
            ):
                full = _join_split_col(t, col)
                # mirror the engine: WRAPPING int64 sum (mod 2^64, the
                # documented contract) then f32 divide — a true-f64 mean
                # here would diverge from the device on overflow
                with np.errstate(over="ignore"):
                    out[name] = np.array(
                        [np.float64(full[idx].sum()) / len(idx)
                         for idx in order],
                        np.float32,
                    )
                continue
            if col is not None and col not in t and (
                in_schema.field(col).ctype.is_split
            ):
                if op == "first":
                    # per-word first, mirroring the device expansion
                    # (plan/lower.py _phys_aggs)
                    for dev in in_schema.field(col).device_names:
                        word = dev.split("#", 1)[1]
                        arr = np.asarray(t[dev])
                        out[f"{name}#{word}"] = np.array(
                            [arr[idx[0]] for idx in order], arr.dtype
                        )
                    continue
                # mirror the device lowering error (plan/lower.py
                # _phys_aggs) instead of a raw KeyError
                raise ValueError(
                    f"aggregate {op!r} unsupported on "
                    f"{in_schema.field(col).ctype.value} column {col!r}"
                )
            vals = []
            for idx in order:
                a = np.asarray(t[col])[idx] if col is not None else None
                if op == "count":
                    vals.append(np.int32(len(idx)))
                elif op == "sum":
                    vals.append(a.sum(dtype=a.dtype))
                elif op == "min":
                    vals.append(a.min())
                elif op == "max":
                    vals.append(a.max())
                elif op == "mean":
                    vals.append(np.float32(a.astype(np.float64).mean()))
                elif op == "first":
                    vals.append(a[0])
                elif op == "any":
                    vals.append(bool(a.any()))
                elif op == "all":
                    vals.append(bool(a.all()))
                else:
                    raise ValueError(op)
            out[name] = np.array(vals)
        return out

    def _n_distinct(self, node: Node) -> Table:
        t = self._in(node)
        eq = K.equality_cols(node.inputs[0].schema, node.params["keys"])
        tuples = _key_tuples(t, eq)
        seen = set()
        idx = []
        for i, k in enumerate(tuples):
            if k not in seen:
                seen.add(k)
                idx.append(i)
        return _take_rows(t, idx)

    # -- join ----------------------------------------------------------------
    def _n_join(self, node: Node) -> Table:
        left, right = node.inputs
        lt, rt = self._in(node, 0), self._in(node, 1)
        lk = K.equality_cols(left.schema, node.params["left_keys"])
        rk = K.equality_cols(right.schema, node.params["right_keys"])
        ltup = _key_tuples(lt, lk)
        rtup = _key_tuples(rt, rk)
        kind = node.params.get("join_kind", "inner")
        if kind in ("semi", "anti"):
            rset = set(rtup)
            mask = np.array([k in rset for k in ltup], bool)
            if kind == "anti":
                mask = ~mask
            return _take_rows(lt, mask)
        rorder = range(len(rtup))
        if kind == "ranked" and node.params.get("order"):
            # Rank order: sort right rows by the requested value order
            # (stable), so match lists enumerate value-ordered.
            rorder = self._lexsort(rt, right.schema, [tuple(k) for k in node.params["order"]])
        index: Dict[tuple, List[int]] = {}
        for j in rorder:
            index.setdefault(rtup[j], []).append(j)
        if kind == "count":
            counts = np.array([len(index.get(k, ())) for k in ltup], np.int32)
            out = {c: np.asarray(v) for c, v in lt.items()}
            out[node.params["out"]] = counts
            return out
        li, ri, ranks = [], [], []
        outer = kind == "left"
        defaults = node.params.get("right_defaults") or {}
        # ranked joins with rank_limit=k enumerate only the first k
        # matches per group — same contract as the device path
        limit = node.params.get("rank_limit") if kind == "ranked" else None
        for i, k in enumerate(ltup):
            matches = index.get(k, ())
            if limit is not None:
                matches = matches[:limit]
            for r, j in enumerate(matches):
                li.append(i)
                ri.append(j)
                ranks.append(r)
            if outer and not matches:
                li.append(i)
                ri.append(-1)  # sentinel: default-valued right row
        suffix = node.params.get("suffix", "_r")
        out: Table = {c: np.asarray(lt[c])[li] for c in lt}
        rkset = set(rk)
        ri_arr = np.asarray(ri, np.int64) if ri else np.zeros(0, np.int64)
        for c in rt:
            if c in rkset:
                continue
            if c in out:
                base, _, word = c.partition("#")
                name = f"{base}{suffix}#{word}" if word else f"{c}{suffix}"
            else:
                name = c
            a = np.asarray(rt[c])
            pad = np.broadcast_to(
                np.asarray(defaults.get(c, 0), a.dtype), (1,) + a.shape[1:]
            )
            out[name] = np.concatenate([a, pad])[ri_arr]
        if kind == "ranked":
            out[node.params["rank_out"]] = np.asarray(ranks, np.int32)
        return out

    def _n_zip(self, node: Node) -> Table:
        lt, rt = self._in(node, 0), self._in(node, 1)
        n = min(_rows(lt), _rows(rt))
        suffix = node.params.get("suffix", "_r")
        out: Table = {c: np.asarray(lt[c])[:n] for c in lt}
        for c in rt:
            if c in out:
                base, _, word = c.partition("#")
                name = f"{base}{suffix}#{word}" if word else f"{c}{suffix}"
            else:
                name = c
            out[name] = np.asarray(rt[c])[:n]
        return out

    def _n_sliding_window(self, node: Node) -> Table:
        t = self._in(node)
        w = node.params["size"]
        n = _rows(t)
        m = max(n - w + 1, 0)
        out: Table = {}
        for c in node.params["cols"]:
            a = np.asarray(t[c])
            for j in range(w):
                out[f"{c}_w{j}"] = a[j : j + m]
        return out

    # -- ordering ------------------------------------------------------------
    def _lexsort(self, t: Table, schema: Schema, keys) -> np.ndarray:
        """Stable row order of ``t`` by ``keys`` [(name, desc)], on the
        engine's ordering operands."""
        operands_fn = K.ordering_operands(schema, keys)
        names = [n for k, _d in keys for n in schema.field(k).device_names]
        ops = [o.numpy() for o in operands_fn(self._batch({n: t[n] for n in names}))]
        return np.lexsort(list(reversed(ops)))

    def _n_order_by(self, node: Node) -> Table:
        t = self._in(node)
        order = self._lexsort(t, node.inputs[0].schema, [(k, d) for k, d in node.params["keys"]])
        return _take_rows(t, order)

    def _n_take(self, node: Node) -> Table:
        t = self._in(node)
        return _take_rows(t, slice(0, node.params["n"]))

    def _n_skip(self, node: Node) -> Table:
        t = self._in(node)
        return _take_rows(t, slice(node.params["n"], None))

    def _n_tail(self, node: Node) -> Table:
        t = self._in(node)
        n = node.params["n"]
        start = max(_rows(t) - n, 0)
        return _take_rows(t, slice(start, None))

    def _first_false(self, node: Node, t: Table) -> int:
        mask = np.asarray(node.params["fn"](dict(t))).astype(bool)
        bad = np.nonzero(~mask)[0]
        return int(bad[0]) if len(bad) else _rows(t)

    def _n_take_while(self, node: Node) -> Table:
        t = self._in(node)
        return _take_rows(t, slice(0, self._first_false(node, t)))

    def _n_skip_while(self, node: Node) -> Table:
        t = self._in(node)
        return _take_rows(t, slice(self._first_false(node, t), None))

    def _n_reverse(self, node: Node) -> Table:
        t = self._in(node)
        return _take_rows(t, slice(None, None, -1))

    def _n_default_if_empty(self, node: Node) -> Table:
        t = self._in(node)
        if _rows(t):
            return t
        d = node.params["defaults"]
        return {
            k: np.asarray([d.get(k, 0)], dtype=np.asarray(t[k]).dtype)
            for k in t
        }

    def _n_concat(self, node: Node) -> Table:
        ts = [self.cache[i.id] for i in node.inputs]
        cols = sorted(ts[0].keys())
        return {c: np.concatenate([np.asarray(t[c]) for t in ts]) for c in cols}

    # -- aggregates ----------------------------------------------------------
    def _n_aggregate(self, node: Node) -> Table:
        from dryad_tpu_torch.columnar.schema import ColumnType, split64

        t = self._in(node)
        in_schema = node.inputs[0].schema
        n = _rows(t)
        out: Table = {}
        for op, col, name in node.params["aggs"]:
            ctype = in_schema.field(col).ctype if col is not None else None
            if ctype is ColumnType.FLOAT64 and op in ("sum", "mean"):
                raise ValueError(
                    f"aggregate {op!r} unsupported on float64 column "
                    f"{col!r}: cast to float32"
                )
            if col is not None and col not in t and (
                (ctype is ColumnType.INT64 and op in ("sum", "min", "max"))
                or (ctype is ColumnType.FLOAT64 and op in ("min", "max"))
            ):
                # split 64-bit scalar: numpy-int64 oracle on the word
                # pairs (ordered image for f64; wrapping sum for i64).
                # Empty input yields the op IDENTITY, matching the
                # device engine's pair-identity semantics.
                full = _join_split_col(t, col)
                if n == 0:
                    ident = {
                        "sum": 0,
                        "min": np.iinfo(np.int64).max,
                        "max": np.iinfo(np.int64).min,
                    }[op]
                    v64 = np.array([ident], np.int64)
                else:
                    with np.errstate(over="ignore"):
                        v64 = np.array([getattr(full, op)()], np.int64)
                out[f"{name}#h0"], out[f"{name}#h1"] = split64(v64)
                continue
            if (
                col is not None and col not in t
                and ctype is ColumnType.INT64 and op == "mean"
            ):
                full = _join_split_col(t, col)
                with np.errstate(over="ignore"):  # wrapping, as device
                    val = np.float64(full.sum()) / n if n else 0.0
                out[name] = np.array([val], np.float32)
                continue
            if col is not None and col not in t and (
                ctype is not None and ctype.is_split
            ):
                # mirror the device engine's lowering error for
                # unsupported aggregates on split columns (mean/any/all
                # on int64, etc.) instead of a raw KeyError
                raise ValueError(
                    f"aggregate {op!r} unsupported on {ctype.value} "
                    f"column {col!r}"
                )
            a = np.asarray(t[col]) if col is not None else None
            if op == "count":
                out[name] = np.array([n], np.int32)
            elif op == "sum":
                out[name] = np.array([a.sum(dtype=a.dtype)])
            elif n == 0 and op in ("min", "max", "mean", "any", "all"):
                # Sentinel row; Query._scalar returns None via the count
                # guard, matching the device engine.
                if op == "mean":
                    out[name] = np.zeros(1, np.float32)
                elif op in ("any", "all"):
                    out[name] = np.array([op == "all"])
                else:
                    out[name] = np.zeros(1, a.dtype)
            elif op == "min":
                out[name] = np.array([a.min()])
            elif op == "max":
                out[name] = np.array([a.max()])
            elif op == "mean":
                out[name] = np.array([a.astype(np.float64).mean()], np.float32)
            elif op == "any":
                out[name] = np.array([bool(a.any())])
            elif op == "all":
                out[name] = np.array([bool(a.all())])
            else:
                raise ValueError(op)
        return out

    # -- escape hatches -------------------------------------------------------
    def _batch(self, t: Table) -> ColumnBatch:
        """A one-partition batch of CPU tensors at the engine's column
        types: a column a user function widened to float64 or int64
        narrows to float32 or int32, as the reference's 32-bit arrays
        narrow it (physical words stay uint32, carried as int64)."""
        n = _rows(t)
        data = {}
        for k, v in t.items():
            a = np.asarray(v)
            if "#" in k:
                a = a.astype(np.uint32, copy=False)
            elif a.dtype == np.float64:
                a = a.astype(np.float32)
            elif a.dtype == np.int64:
                a = a.astype(np.int32)
            data[k] = to_device_column(a, "cpu")
        return ColumnBatch(data, torch.ones((n,), dtype=torch.bool))

    def _unbatch(self, b: ColumnBatch) -> Table:
        valid = b.valid.numpy()
        return {k: to_host_column(v)[valid] for k, v in b.data.items()}

    def _n_apply(self, node: Node) -> Table:
        b = self._batch(self._in(node))
        if node.params.get("with_index"):
            out = node.params["fn"](b, 0)
        else:
            out = node.params["fn"](b)
        return self._unbatch(out)

    def _n_fork(self, node: Node) -> Tuple[Table, ...]:
        b = self._batch(self._in(node))
        outs = node.params["fn"](b)
        return tuple(self._unbatch(o) for o in outs)

    def _n_fork_branch(self, node: Node) -> Table:
        forked = self.cache[node.inputs[0].id]
        return forked[node.params["index"]]

    # -- iteration -------------------------------------------------------------
    def _n_do_while(self, node: Node) -> Table:
        from dryad_tpu_torch.api.query import Query
        from dryad_tpu_torch.plan.nodes import Node as N, PartitionInfo

        current = self._in(node)
        body = node.params["body"]
        cond = node.params["cond"]
        for _ in range(node.params.get("max_iter", 100)):
            inp = N("input", [], node.schema, PartitionInfo(), source="table")
            self.ctx._bindings[inp.id] = ("table", current)
            sub = LocalDebugInterpreter(self.ctx)
            out_q = body(Query(self.ctx, inp))
            current = sub.run(out_q.node)

            inp2 = N("input", [], node.schema, PartitionInfo(), source="table")
            self.ctx._bindings[inp2.id] = ("table", current)
            sub2 = LocalDebugInterpreter(self.ctx)
            cond_q = cond(Query(self.ctx, inp2))
            cond_t = sub2.run(cond_q.node)
            col = next(iter(cond_t.values()))
            if not (len(col) and bool(col[0])):
                break
        return current
