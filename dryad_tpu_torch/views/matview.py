"""Incremental materialized views over continuous ingest (a copy of
``dryad_tpu/views/matview.py``).

A view registers a group_by plan (optionally tailed by order_by/take)
whose input is a host-bound ingest table.  Registration seeds partial
STATE rows from the current table; every append folds in as one more
delta through the SAME state algebra the streaming executor's combine
path uses (``exec.partial.seed_state_rows`` → ``merge_state_rows``
with ``state_reductions``), so view state is byte-for-byte the partial
table any chunk pipeline over the same rows would hold.  A read
finalizes a SNAPSHOT: fresh state serves the stored result with zero
dispatches; stale state costs exactly one dispatch of the (tiny)
finalize plan built by :func:`finalize_query`.  Windowed aggregates
keep a ring of per-window partials folded with the same mechanism —
expired windows simply drop out of the ring.

Discipline: this package BUILDS plans and folds host state; it never
executes —
``run_to_host``/``collect``/``submit`` belong to the serve driver —
and partial state finalizes only inside :func:`finalize_query`.

Staleness contract: a snapshot reflects every delta folded before its
finalize dispatch; ``max_staleness_s > 0`` lets reads reuse a
snapshot that is at most that old even when newer deltas exist
(bounded staleness); ``max_staleness_s == 0`` means reads always see
the latest folded delta (one finalize dispatch per write round).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from dryad_tpu_torch.api.decomposable import delta_fold_reason
from dryad_tpu_torch.exec.partial import (
    copy_physical,
    merge_state_rows,
    partial_plan,
    seed_state_rows,
    state_reductions,
)

_DELTA_AGGS = frozenset({"sum", "count", "mean", "min", "max", "any", "all"})


def _table_rows(arrays) -> int:
    for v in arrays.values():
        return len(np.asarray(v))
    return 0


def _table_bytes(arrays) -> int:
    return sum(np.asarray(v).nbytes for v in arrays.values())


class ViewIneligible(ValueError):
    """A plan with no incremental maintenance path; ``reason`` is the
    structured explanation mirrored into the ``view_fallback`` event."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def _eligibility(ctx, query):
    """Validate a plan for incremental maintenance; returns
    ``(group_by_node, input_node, agg_list, tail)`` where ``tail`` is
    the innermost-first list of (kind, params) to re-apply after the
    snapshot finalize.  Raises :class:`ViewIneligible` with a
    structured reason otherwise."""
    tail: List[Tuple[str, dict]] = []
    node = query.node
    while node.kind in ("order_by", "take"):
        tail.append((node.kind, dict(node.params)))
        node = node.inputs[0]
    if node.kind != "group_by":
        raise ViewIneligible(
            f"root operator {node.kind!r} has no incremental maintenance"
        )
    dec = node.params.get("decomposable")
    if dec is not None:
        raise ViewIneligible(delta_fold_reason(dec))
    if node.params.get("salt"):
        raise ViewIneligible(
            "salted group_by reduces on (key, salt); no delta fold"
        )
    if node.params.get("dense") and not node.params.get("guard_range"):
        raise ViewIneligible(
            "explicit dense group_by drops out-of-range rows; register "
            "the sort-path plan"
        )
    agg_list = node.params.get("aggs") or []
    for op, _col, _out in agg_list:
        if op == "first":
            raise ViewIneligible(
                "order-dependent aggregate 'first' has no associative "
                "delta fold"
            )
        if op not in _DELTA_AGGS:
            raise ViewIneligible(f"aggregate {op!r} has no delta fold")
    src = node.inputs[0]
    if src.kind != "input":
        raise ViewIneligible(
            f"pre-aggregation operator {src.kind!r} between ingest and "
            "group_by; register the bare aggregation"
        )
    binding = ctx._bindings.get(src.id)
    if binding is None:
        raise ViewIneligible("input binding was released")
    if binding[0] == "stream":
        raise ViewIneligible(
            "stream inputs re-drain their chunks; no resident table to "
            "fold deltas into"
        )
    if binding[0] != "host":
        raise ViewIneligible(
            f"{binding[0]!r}-bound input has no append path (views fold "
            "host deltas)"
        )
    tail.reverse()
    return node, src, agg_list, tail


class _SnapshotSelect:
    """Physical projection closing mean partials into the output
    column (sum/count stay what the finalize group_by named them), in
    torch ops on the column tensors with the reference's f32 division;
    VALUE-equal so a rebuilt snapshot plan keeps its graph key,
    picklable for job packages."""

    def __init__(self, plan, keys):
        self.plan = tuple(
            (name, op, tuple(pcols)) for name, op, pcols in plan
        )
        self.keys = tuple(keys)

    def __eq__(self, other) -> bool:
        return (
            type(other) is _SnapshotSelect
            and other.plan == self.plan
            and other.keys == self.keys
        )

    def __hash__(self) -> int:
        return hash(("_SnapshotSelect", self.plan, self.keys))

    def __call__(self, cols: Dict) -> Dict:
        import torch

        out: Dict = {}
        for k in self.keys:
            copy_physical(cols, k, k, out)
        for name, op, _pcols in self.plan:
            if op == "mean":
                denom = torch.clamp_min(cols[f"{name}__pc"], 1).to(torch.float32)
                out[name] = cols[f"{name}__ps"].to(torch.float32) / denom
            else:
                copy_physical(cols, name, name, out)
        return out


class MaterializedView:
    """Resident un-finalized state for one registered plan.

    ``state`` holds one partial row per key (per live window when
    windowed) in SOURCE dtypes — ``merge_state_rows`` promotes integer
    accumulators, so every fold narrows back, keeping the finalize
    plan's output schema identical to a direct run of the plan."""

    def __init__(
        self,
        tenant: str,
        query,
        gb_node,
        src_node,
        agg_list,
        tail,
        name: Optional[str] = None,
        window_col: Optional[str] = None,
        window_count: Optional[int] = None,
        max_staleness_s: float = 0.0,
    ):
        self.tenant = tenant
        self.query = query
        self.root_id = query.node.id
        self.src_id = src_node.id
        self.keys: Tuple[str, ...] = tuple(gb_node.params["keys"])
        self.agg_list = list(agg_list)
        _partial, self.plan = partial_plan(self.agg_list)
        self.red = state_reductions(self.plan)
        self.out_schema = gb_node.schema
        self.tail = list(tail)
        self.name = name or f"view-{self.root_id}"
        if window_col is not None:
            if window_col not in self.keys:
                raise ViewIneligible(
                    f"window column {window_col!r} must be a group key"
                )
            if not window_count or window_count < 1:
                raise ViewIneligible("window_count must be >= 1")
        self.window_col = window_col
        self.window_count = window_count
        self.max_staleness_s = float(max_staleness_s)
        # plain state: {col: np.ndarray}; windowed: ring of them
        self._state: Optional[Dict[str, np.ndarray]] = None
        self._ring: "OrderedDict[int, Dict[str, np.ndarray]]" = (
            OrderedDict()
        )
        self._max_wid: Optional[int] = None
        self._state_dtypes: Dict[str, np.dtype] = {}
        self.version = 0
        self.snap_table: Optional[Dict[str, np.ndarray]] = None
        self.snap_version = -1
        self.snap_ts = 0.0
        # finalize plan root node id -> (view version when it was built,
        # its state-table input node id): several finalizes of one view
        # may be in flight at once (the serve window's depth), and each
        # commit must record the version its own plan saw
        self._pending: Dict[int, Tuple[int, int]] = {}
        self.deltas = 0
        self.delta_rows = 0
        self.delta_bytes = 0
        self.snapshots_fresh = 0
        self.snapshots_finalized = 0

    # -- delta fold ---------------------------------------------------------
    def _seed(self, arrays) -> Dict[str, np.ndarray]:
        seeded = seed_state_rows(arrays, self.agg_list)
        for k in self.keys:
            a = np.asarray(arrays[k])
            if a.dtype.kind in ("U", "S"):
                a = np.asarray(a, object)
            seeded[k] = a
        if not self._state_dtypes:
            self._state_dtypes = {
                c: np.asarray(v).dtype for c, v in seeded.items()
            }
        return seeded

    def _merge(self, state, seeded) -> Dict[str, np.ndarray]:
        parts = [p for p in (state, seeded) if p is not None]
        cols = {
            c: np.concatenate([np.asarray(p[c]) for p in parts])
            for c in seeded
        }
        merged = merge_state_rows(cols, list(self.keys), self.red)
        # narrow promoted accumulators back to their seed dtypes (the
        # source-dtype discipline that keeps finalize output schemas
        # identical to a direct run)
        for c in self.red:
            merged[c] = np.asarray(merged[c]).astype(
                self._state_dtypes[c]
            )
        return merged

    def fold_delta(self, arrays: Dict[str, np.ndarray]) -> Tuple[int, int]:
        """Fold appended rows into the resident state — one more chunk
        through the combine algebra.  Returns (rows, bytes) folded."""
        rows = _table_rows(arrays)
        nbytes = _table_bytes(arrays)
        if rows:
            if self.window_col is None:
                self._state = self._merge(self._state, self._seed(arrays))
            else:
                wids = np.asarray(arrays[self.window_col])
                for wid in np.unique(wids):
                    m = wids == wid
                    sub = {
                        c: np.asarray(v)[m] for c, v in arrays.items()
                    }
                    w = int(wid)
                    self._ring[w] = self._merge(
                        self._ring.get(w), self._seed(sub)
                    )
                self._max_wid = max(
                    int(wids.max()),
                    self._max_wid if self._max_wid is not None else int(
                        wids.max()
                    ),
                )
                floor = self._max_wid - int(self.window_count) + 1
                for w in [w for w in self._ring if w < floor]:
                    del self._ring[w]
        self.version += 1
        self.deltas += 1
        self.delta_rows += rows
        self.delta_bytes += nbytes
        return rows, nbytes

    # -- snapshot surface ---------------------------------------------------
    def state_table(self) -> Dict[str, np.ndarray]:
        """The current partial state as one host table (live windows
        concatenate — their key tuples are disjoint on the window id,
        so the concat is itself a valid state table)."""
        if self.window_col is None:
            if self._state is not None:
                return dict(self._state)
            cols = list(self.keys) + list(self.red)
        else:
            live = list(self._ring.values())
            if live:
                return {
                    c: np.concatenate([np.asarray(s[c]) for s in live])
                    for c in live[0]
                }
            cols = list(self.keys) + list(self.red)
        return {
            c: np.zeros(0, self._state_dtypes.get(c, np.int32))
            for c in cols
        }

    def state_rows(self) -> int:
        if self.window_col is None:
            return _table_rows(self._state) if self._state else 0
        return sum(_table_rows(s) for s in self._ring.values())

    def fresh(self, now: Optional[float] = None) -> bool:
        """True when the stored snapshot satisfies the staleness
        contract — serving it costs zero dispatches."""
        if self.snap_table is None:
            return False
        if self.snap_version == self.version:
            return True
        now = time.monotonic() if now is None else now
        return (
            self.max_staleness_s > 0
            and (now - self.snap_ts) < self.max_staleness_s
        )

    def staleness_s(self, now: Optional[float] = None) -> float:
        if self.snap_table is None or self.snap_version == self.version:
            return 0.0
        now = time.monotonic() if now is None else now
        return max(0.0, now - self.snap_ts)

    def read_snapshot(self) -> Dict[str, np.ndarray]:
        """A per-reader copy of the stored snapshot (fresh path)."""
        self.snapshots_fresh += 1
        return {k: np.asarray(v).copy() for k, v in self.snap_table.items()}

    def commit_snapshot(self, table, ctx=None, query=None) -> None:
        """Store a finalized snapshot of the finalize plan ``query``;
        drops the transient state-table binding it ingested (plan
        bookkeeping, not execution).  Deltas folded since that plan was
        BUILT leave the view stale again — the version recorded at its
        build wins, whatever other finalizes of the view were built
        since (the reference keeps one pending record a view, so a
        second finalize built before the first commits lends the first
        its newer version, and a read then serves older rows as fresh)."""
        version = self.release_finalize(query, ctx)
        self.snap_table = {
            k: np.asarray(v).copy() for k, v in table.items()
        }
        self.snap_version = version
        self.snap_ts = time.monotonic()
        self.snapshots_finalized += 1

    def release_finalize(self, query, ctx=None) -> int:
        """Forget the finalize plan ``query`` (committed or failed) and
        drop its state-table binding; returns the view version it was
        built at (the current version for an unknown plan)."""
        version, node_id = self.version, None
        if query is not None:
            version, node_id = self._pending.pop(query.node.id, (version, None))
        if node_id is not None and ctx is not None:
            with ctx._job_lock:  # the device cache changes under it
                ctx._bindings.pop(node_id, None)
                ctx._binding_fp_cache.pop(node_id, None)
                ctx._device_cache.pop(node_id, None)
        return version

    def stats(self) -> Dict:
        return {
            "name": self.name,
            "tenant": self.tenant,
            "keys": list(self.keys),
            "version": self.version,
            "snap_version": self.snap_version,
            "state_rows": self.state_rows(),
            "windows": len(self._ring) if self.window_col else 0,
            "deltas": self.deltas,
            "delta_rows": self.delta_rows,
            "delta_bytes": self.delta_bytes,
            "snapshots_fresh": self.snapshots_fresh,
            "snapshots_finalized": self.snapshots_finalized,
        }


def finalize_query(view: MaterializedView, ctx):
    """THE snapshot path — the only place view state may finalize.
    Builds the
    one-dispatch plan closing the view's partial state into its output
    schema: group the state rows with the merge-plan aggregates
    (count partials SUM; lattice partials stay themselves), divide
    mean partials, then re-apply the registered tail.  Returns a Query
    for the serve driver (or any caller) to execute — this function
    itself dispatches nothing."""
    state = view.state_table()
    q = ctx.from_arrays(state)
    final_aggs: Dict[str, Tuple[str, Optional[str]]] = {}
    has_mean = False
    for name, op, pcols in view.plan:
        if op == "mean":
            has_mean = True
            final_aggs[f"{name}__ps"] = ("sum", pcols[0])
            final_aggs[f"{name}__pc"] = ("sum", pcols[1])
        elif op == "count":
            final_aggs[name] = ("sum", pcols[0])
        else:
            final_aggs[name] = (op, pcols[0])
    gq = q.group_by(list(view.keys), final_aggs)
    if has_mean:
        gq = gq.select(
            _SnapshotSelect(view.plan, view.keys), schema=view.out_schema
        )
    for kind, params in view.tail:
        if kind == "order_by":
            gq = gq.order_by(params["keys"])
        else:
            gq = gq.take(params["n"])
    view._pending[gq.node.id] = (view.version, q.node.id)
    return gq


class ViewRegistry:
    """All resident views of one engine context, keyed by the
    registered plan's ROOT node identity — prepared statements: the
    same Query object matches; a structurally equal rebuild takes the
    normal recompute path, which is correct, just not incremental."""

    def __init__(self, ctx, events=None):
        self.ctx = ctx
        self.events = events
        self._views: Dict[Tuple[str, int], MaterializedView] = {}
        self.fallbacks = 0

    def __len__(self) -> int:
        return len(self._views)

    def _emit(self, kind: str, **payload) -> None:
        if self.events is not None:
            self.events.emit(kind, **payload)

    def register(
        self,
        tenant: str,
        query,
        name: Optional[str] = None,
        window_col: Optional[str] = None,
        window_count: Optional[int] = None,
        max_staleness_s: float = 0.0,
    ) -> MaterializedView:
        """Admit a plan as a resident view, seeding state from the
        table's current rows (dispatch-free — seeding IS the first
        delta).  Ineligible plans fail FAST with a structured
        ``view_fallback`` event + :class:`ViewIneligible`."""
        try:
            gb_node, src_node, agg_list, tail = _eligibility(
                self.ctx, query
            )
            view = MaterializedView(
                tenant, query, gb_node, src_node, agg_list, tail,
                name=name, window_col=window_col,
                window_count=window_count,
                max_staleness_s=max_staleness_s,
            )
        except ViewIneligible as e:
            self.fallbacks += 1
            self._emit("view_fallback", reason=e.reason, tenant=tenant)
            raise
        _kind, arrays, _cap = self.ctx._bindings[src_node.id]
        rows, _ = view.fold_delta(arrays)
        self._views[(tenant, view.root_id)] = view
        self._emit(
            "view_register", tenant=tenant, view=view.name, rows=rows,
            state_rows=view.state_rows(),
            windows=len(view._ring) if view.window_col else 0,
        )
        return view

    def lookup(self, tenant: str, query) -> Optional[MaterializedView]:
        return self._views.get((tenant, query.node.id))

    def views_over(self, input_node_id: int) -> List[MaterializedView]:
        return [
            v for v in self._views.values() if v.src_id == input_node_id
        ]

    def apply_delta(
        self, input_node_id: int, arrays: Dict[str, np.ndarray]
    ) -> List[MaterializedView]:
        """Fold an append into EVERY view over the table (views of any
        tenant — the binding is shared engine state) and emit one
        ``view_delta`` per fold.  Returns the touched views."""
        touched = self.views_over(input_node_id)
        for v in touched:
            rows, nbytes = v.fold_delta(arrays)
            self._emit(
                "view_delta", tenant=v.tenant, view=v.name, rows=rows,
                bytes=nbytes, state_rows=v.state_rows(),
                windows=len(v._ring) if v.window_col else 0,
            )
        return touched

    def stats(self) -> Dict:
        return {
            "registered": len(self._views),
            "fallbacks": self.fallbacks,
            "deltas": sum(v.deltas for v in self._views.values()),
            "delta_rows": sum(
                v.delta_rows for v in self._views.values()
            ),
            "delta_bytes": sum(
                v.delta_bytes for v in self._views.values()
            ),
            "state_rows": sum(
                v.state_rows() for v in self._views.values()
            ),
            "snapshots_fresh": sum(
                v.snapshots_fresh for v in self._views.values()
            ),
            "snapshots_finalized": sum(
                v.snapshots_finalized for v in self._views.values()
            ),
            "views": [v.stats() for v in self._views.values()],
        }
