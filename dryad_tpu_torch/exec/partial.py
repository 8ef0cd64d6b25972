"""Partial-aggregation decomposition (a copy of
``dryad_tpu/exec/partial.py``).

A GroupBy's builtin aggregates split into per-chunk partials and an
associative merge, so partial combines run close to the data and merge
up an aggregation tree.  The streaming driver (``exec/outofcore.py``)
uses the decomposition for its per-chunk partials; the host-side state
folds and the coded combine serve the vertex tasks and coded partials
of ``cluster/localjob.py`` and ``cluster/worker.py``, and the views.
"""

from __future__ import annotations

# Builtin aggregates whose partials merge associatively.  "first"
# merges correctly only when partial rows concatenate in engine order
# (the callers enforce their own ordering constraints).
MERGEABLE_AGGS = frozenset(
    {"sum", "count", "min", "max", "mean", "any", "all", "first"}
)

# The LINEAR subset: partials that merge by elementwise ADDITION over
# their state columns ("mean" decomposes to sum + count, both linear).
# Only these qualify for coded stage redundancy:
# an integer linear combination of linear partials is itself a valid
# partial, so any k of n coded vertices reconstruct the stage output.
# min/max/any/all are lattice ops (idempotent, not invertible) and
# "first" is order-dependent — none of them form a vector space.
LINEAR_AGGS = frozenset({"sum", "count", "mean"})


def plan_is_linear(plan) -> bool:
    """True when every merge-plan row is a linear aggregate."""
    return all(op in LINEAR_AGGS for _out, op, _pcols in plan)


def partial_plan(agg_list):
    """Decompose builtin aggs into partial specs plus the merge plan.

    Returns ``(partial, plan)`` where ``partial`` is an agg spec dict
    for the chunk/vertex-side group_by and ``plan`` rows are
    ``(out_name, op, partial_col_names)`` for the final merge.
    """
    partial, plan = {}, []
    for op, col, out in agg_list:
        if op == "mean":
            partial[f"{out}__ps"] = ("sum", col)
            partial[f"{out}__pc"] = ("count", None)
            plan.append((out, "mean", (f"{out}__ps", f"{out}__pc")))
        else:
            partial[f"{out}__p"] = (op, col)
            plan.append((out, op, (f"{out}__p",)))
    return partial, plan


def merge_agg_spec(plan):
    """Agg spec that merges partial columns into partial columns of the
    same names — closed under composition, so intermediate compaction
    rounds can apply it repeatedly before the final round."""
    spec = {}
    for _out, op, pcols in plan:
        if op == "mean":
            spec[pcols[0]] = ("sum", pcols[0])
            spec[pcols[1]] = ("sum", pcols[1])
        elif op in ("sum", "count"):
            spec[pcols[0]] = ("sum", pcols[0])
        elif op in ("min", "max", "any", "all", "first"):
            spec[pcols[0]] = (op, pcols[0])
        else:  # pragma: no cover - guarded by MERGEABLE_AGGS
            raise AssertionError(f"unmergeable agg {op}")
    return spec


def state_reductions(plan):
    """Partial STATE column -> associative host reduction ("sum" /
    "min" / "max" / "any" / "all") for an intermediate, UN-finalized
    merge round: mean's sum+count columns both add, lattice ops stay
    themselves.  "first" has no associative state reduction (order-
    dependent) and is absent from the mapping — callers must fall back
    to a flat engine-order merge when the plan carries it."""
    red = {}
    for _out, op, pcols in plan:
        if op == "mean":
            red[pcols[0]] = "sum"
            red[pcols[1]] = "sum"
        elif op in ("sum", "count"):
            red[pcols[0]] = "sum"
        elif op in ("min", "max", "any", "all"):
            red[pcols[0]] = op
    return red


def seed_state_rows(arrays, agg_list):
    """Seed partial STATE columns directly from raw host rows — the
    delta-ingest counterpart of running the chunk-side partial
    group_by: each input row becomes one state row (sum/min/max carry
    the value, count/mean-count carry 1) which then folds through
    :func:`merge_state_rows` exactly like any other streaming chunk.
    State columns keep their SOURCE dtypes (count columns are int32,
    matching the count output ctype) so a later finalize narrows to
    the same output schema a direct run of the plan produces."""
    import numpy as np

    n = 0
    for a in arrays.values():
        n = len(np.asarray(a))
        break
    out = {}
    for op, col, name in agg_list:
        if op == "count":
            out[f"{name}__p"] = np.ones(n, np.int32)
        elif op == "mean":
            out[f"{name}__ps"] = np.asarray(arrays[col]).copy()
            out[f"{name}__pc"] = np.ones(n, np.int32)
        elif op in ("any", "all"):
            out[f"{name}__p"] = np.asarray(arrays[col]).astype(np.bool_)
        elif op in ("sum", "min", "max"):
            out[f"{name}__p"] = np.asarray(arrays[col]).copy()
        else:  # "first" and friends are order-dependent — no seed
            raise ValueError(f"agg {op!r} has no row-seeded state")
    return out


_MIX64 = 0x9E3779B97F4A7C15


def key_hash64(cols, keys):
    """Deterministic row hash over the key columns (the gang workers'
    pre-merge histograms in the reference).  Strings hash with the
    engine's Hash64 (``columnar/schema.py::hash64_str``), not Python's
    process-salted ``hash()``, so another process computes the same
    key ranges for the same rows."""
    import numpy as np

    from dryad_tpu_torch.columnar.schema import hash64_str

    mix = np.uint64(_MIX64)
    n = len(cols[keys[0]])
    h = np.full(n, np.uint64(0x84222325), np.uint64)
    for k in keys:
        a = np.asarray(cols[k])
        if a.dtype == object or a.dtype.kind in ("U", "S"):
            uniq, inv = np.unique(a.astype(object), return_inverse=True)
            hs = np.asarray(
                [hash64_str(str(s)) for s in uniq], np.uint64
            )
            w = hs[inv]
        elif a.dtype.kind == "f":
            w = np.ascontiguousarray(a.astype(np.float64)).view(np.uint64)
        elif a.dtype.kind == "b":
            w = a.astype(np.uint64)
        else:
            w = a.astype(np.int64).view(np.uint64)
        h = (h ^ w) * mix
        h ^= h >> np.uint64(29)
    return h


def _key_groups(cols, keys):
    """Rows grouped by their key tuple, or None when a key column is
    neither integer/bool nor all-``str`` (those keep the tuple dict:
    its float and mixed-object equality is what the reference's merge
    does).  Returns ``(order, spans)``: the row indices sorted stably by
    group, and per group, in order of its first row, the ``(start,
    end)`` of its rows in ``order`` (in row order: the reference's
    per-key index list)."""
    import numpy as np

    from dryad_tpu_torch.columnar.schema import factorize_strings

    codes, card = None, 1
    for k in keys:
        a = np.asarray(cols[k])
        if a.dtype == object:
            f = factorize_strings(a)
            if f is None:
                return None
            c, m = f[1], len(f[0])
        elif a.dtype.kind in "iub":
            u, c = np.unique(a, return_inverse=True)
            c, m = c.reshape(-1), len(u)
        else:
            return None
        if codes is None:
            codes, card = c, m
        else:  # re-compact after each column: codes stay below the row count
            u, codes = np.unique(codes * m + c, return_inverse=True)
            codes, card = codes.reshape(-1), len(u)
    # a stable sort of small codes is a radix sort
    narrow = np.uint8 if card <= 1 << 8 else np.uint16 if card <= 1 << 16 else np.int64
    order = np.argsort(codes.astype(narrow), kind="stable")
    bounds = np.concatenate([[0], np.cumsum(np.bincount(codes, minlength=card))])
    first = order[bounds[:-1]]  # every code occurs: its segment's first row
    spans = [(bounds[c], bounds[c + 1]) for c in np.argsort(first, kind="stable").tolist()]
    return order, spans


def merge_state_rows(cols, keys, red):
    """Fold partial STATE rows by key with the plan's associative
    reductions (:func:`state_reductions`) — no finalize, so the result
    is itself a valid partial table: one host fold step of the
    aggregation tree.  Groups come out in order of their first row and
    each reduction runs over the group's rows in row order, as the
    reference's fold; integer, bool and string keys are grouped by
    sorting codes instead of a dict of Python tuples (the same groups,
    rows and bytes, several times faster on millions of rows)."""
    import numpy as np

    n = len(cols[keys[0]]) if keys else 0
    grouped = _key_groups(cols, keys) if n else None
    if grouped is not None:
        order, spans = grouped
        first = order[[a for a, _ in spans]]
        res = {k: np.asarray(cols[k])[first] for k in keys}
        for c, op in red.items():
            vs = np.asarray(cols[c])[order]
            fold = {"sum": np.sum, "min": np.min, "max": np.max, "any": np.any}.get(op, np.all)
            # each group's rows, contiguous and in row order: the same
            # reduction over the same sequence as a fancy-indexed copy
            res[c] = np.asarray([fold(vs[a:b]) for a, b in spans])
        return res
    tups = list(zip(*[np.asarray(cols[k]).tolist() for k in keys])) if n \
        else []
    index = {}
    for i, t in enumerate(tups):
        index.setdefault(t, []).append(i)
    out = {k: [] for k in keys}
    for c in red:
        out[c] = []
    for t, idxs in index.items():
        for k, kv in zip(keys, t):
            out[k].append(kv)
        ii = np.asarray(idxs)
        for c, op in red.items():
            v = np.asarray(cols[c])[ii]
            if op == "sum":
                out[c].append(v.sum())
            elif op == "min":
                out[c].append(v.min())
            elif op == "max":
                out[c].append(v.max())
            elif op == "any":
                out[c].append(np.any(v))
            else:  # all
                out[c].append(np.all(v))
    res = {
        k: np.asarray(out[k], dtype=np.asarray(cols[k]).dtype)
        for k in keys
    }
    for c in red:
        # promoted accumulators (int sums widen) keep their width; the
        # flat root pass narrows to the output schema at finalize
        res[c] = np.asarray(out[c])
    return res


# -- coded combine (k-of-n partial aggregates) ------------------------------

def align_partials(tables, key_cols, state_cols):
    """Align partial STATE tables onto the sorted union of their keys.

    Returns ``(key_arrays, mats)`` where ``key_arrays`` maps each key
    column to its union array (ascending tuple order — deterministic
    regardless of which tables are present) and ``mats`` maps each
    state column to a ``(len(tables), n_keys)`` matrix whose row i is
    table i's values scattered onto the union (missing keys are the
    additive identity 0 — the linearity contract).  Integer/bool state
    columns accumulate in exact Python ints (object dtype) so the
    coded decode can stay bit-exact; floats accumulate in float64.
    """
    import numpy as np

    keysets = []
    for t in tables:
        if key_cols:
            ks = list(zip(*[np.asarray(t[k]).tolist() for k in key_cols]))
        else:
            n = len(np.asarray(t[state_cols[0]])) if state_cols else 0
            ks = [()] * n
        keysets.append(ks)
    union = sorted(set().union(*keysets)) if keysets else []
    index = {key: i for i, key in enumerate(union)}
    key_arrays = {}
    for pos, kname in enumerate(key_cols):
        dt = np.asarray(tables[0][kname]).dtype if tables else None
        key_arrays[kname] = np.asarray([u[pos] for u in union], dtype=dt)
    mats = {}
    for c in state_cols:
        dt = np.asarray(tables[0][c]).dtype if tables else np.dtype(float)
        exact = dt.kind in "iub"
        acc_dt = object if exact else np.float64
        mat = np.zeros((len(tables), len(union)), dtype=acc_dt)
        for ti, (t, ks) in enumerate(zip(tables, keysets)):
            vals = np.asarray(t[c])
            idx = [index[key] for key in ks]
            if exact:
                for p, v in zip(idx, vals.tolist()):
                    mat[ti, p] += v  # duplicate keys merge additively
            else:
                np.add.at(mat[ti], idx, vals.astype(np.float64))
        mats[c] = mat
    return key_arrays, mats


def coded_combine(tables, coeffs, key_cols, state_cols):
    """The worker-side ENCODE step: one coded partial table as the
    integer-weighted sum of its support partials, keyed on the sorted
    union of their keys.  Integer states come back exact int64; float
    states come back float64 (narrowing happens only at finalize).
    """
    import numpy as np

    key_arrays, mats = align_partials(tables, key_cols, state_cols)
    out = dict(key_arrays)
    for c, mat in mats.items():
        if mat.dtype == object:
            w = np.asarray([int(x) for x in coeffs], dtype=object)
            comb = (w[:, None] * mat).sum(axis=0) if len(mat) else mat.sum(0)
            out[c] = np.asarray([int(v) for v in comb], dtype=np.int64)
        else:
            w = np.asarray(coeffs, np.float64)
            out[c] = w @ mat
    return out


_PHYS_SUFFIXES = ("#h0", "#h1", "#r0", "#r1")


def copy_physical(cols, src: str, dst: str, out) -> None:
    """Copy a logical column between physical column dicts, whatever
    its physical width (plain, split-word, or string 4-column)."""
    if src in cols:
        out[dst] = cols[src]
        return
    found = False
    for suf in _PHYS_SUFFIXES:
        if f"{src}{suf}" in cols:
            out[f"{dst}{suf}"] = cols[f"{src}{suf}"]
            found = True
    if not found:
        raise KeyError(src)


def finalize_fn(plan):
    """Row-wise finalizer mapping merged partial columns to the user's
    output columns (mean = sum/count; everything else renames).  Runs
    over PHYSICAL column tensors, so renames carry split-word/string
    physical columns through."""

    def fn(cols):
        import torch

        out = {}
        for name, op, pcols in plan:
            if op == "mean":
                if pcols[0] not in cols:
                    raise KeyError(
                        f"streaming mean over a split-word column "
                        f"({pcols[0]}) is not supported"
                    )
                c = cols[pcols[1]]
                denom = torch.clamp_min(c, 1).to(torch.float32)
                out[name] = cols[pcols[0]].to(torch.float32) / denom
            else:
                copy_physical(cols, pcols[0], name, out)
        return out

    return fn
