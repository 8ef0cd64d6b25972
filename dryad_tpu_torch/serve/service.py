"""QueryService — one resident engine, many concurrent tenants (a copy
of ``dryad_tpu/serve/service.py``).

Many tenants' plans are multiplexed onto one resident
:class:`~dryad_tpu_torch.api.context.DryadContext` (its device tables,
dictionary and executor all shared).

Threading model — the executor is driver-owned and NOT thread-safe, so
the service owns exactly ONE driver thread and every dispatch happens
there:

- client threads build plans, pass admission (quota check + enqueue,
  under the service lock), and block on :class:`QueryFuture`;
- the driver thread picks the next query fair-share (weighted deficit
  round robin over the tenant ring), computes its result-cache
  fingerprint, and either resolves it from the cache (zero dispatches)
  or dispatches it through the ONE shared
  :class:`~dryad_tpu_torch.exec.pipeline.DispatchWindow` — whose
  collector drains fetches strictly in submit order, so interleaved
  tenants still commit deterministically and results stay
  byte-identical to serial one-at-a-time execution;
- session ingest and appends (which mutate the shared dictionary and
  binding table) serialize against driver-side lowering on
  ``_ctx_lock``, never held while blocked on the window; inside it the
  context's own job lock covers lower, bind and launch only, never a
  fetch, so the collector copies query k's result while the driver
  launches query k+1 (``dispatch_depth`` fetches in flight).
- CUDA ordering: the driver launches, the collector copies to the host
  and an append's rows upload at the next bind, all on the device's
  default stream, which every host thread shares, so each copy is
  ordered after the kernels that produced it.
- over several cards (``DryadContext(devices=...)``) the driver's job
  runs on every rank thread at once, and each rank copies its part of a
  result on its own thread and stream (``RankBatches.fetch_valid_rows``),
  so a fetch of query k and the job of query k+1 may queue in either
  order on different ranks: a fetch holds no collective, so neither
  waits on the other, and the window still commits in submit order.  A
  rank that fails resolves its query's future with the
  ``GangStageError`` naming it; the next job runs on a new group.

Fair share is classic weighted deficit round robin: each visit to a
tenant with queued work earns ``weight`` quantum units, a query costs
``1 + input_bytes // config.serve_drr_quantum_bytes`` units, and an
idle tenant forfeits its credit — so a heavy tenant cannot starve a
light one, and a returning tenant cannot burst on banked idle time.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

from dryad_tpu_torch.exec.pipeline import DispatchWindow
from dryad_tpu_torch.obs import critpath, flightrec, tracectx
from dryad_tpu_torch.obs.span import Tracer
from dryad_tpu_torch.obs.telemetry import RollingStore
from dryad_tpu_torch.serve.admission import (
    DEFAULT_TIER,
    TIERS,
    QueryRejected,
    TenantQuota,
    check_tier,
)
from dryad_tpu_torch.serve.cache import ResultCache
from dryad_tpu_torch.serve.router import canonical_fingerprint
from dryad_tpu_torch.utils.logging import get_logger
from dryad_tpu_torch.views import ViewRegistry, finalize_query

log = get_logger("dryad_tpu_torch.serve")


class QueryFuture:
    """Resolution handle for one admitted query.  ``result()`` blocks
    until the driver resolves it — with the host table, the execution
    error, or a :class:`QueryRejected` if the service closed first."""

    def __init__(self, tenant: str, qid: str):
        self.tenant = tenant
        self.qid = qid
        self.cached = False  # set at resolve: served from the result cache
        self._ev = threading.Event()
        self._result: Optional[Dict] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) -> Dict:
        if not self._ev.wait(timeout):
            raise TimeoutError(
                f"query {self.qid} unresolved after {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return self._result

    def _resolve(self, result=None, error=None) -> None:
        self._result = result
        self._error = error
        self._ev.set()


class _Queued:
    """One admitted query riding the tenant queue."""

    __slots__ = (
        "state", "qid", "query", "future", "cost_bytes", "cost_units",
        "epoch", "t_submit", "tctx", "view", "finalize",
    )

    def __init__(self, state, qid, query, future, cost_bytes, cost_units,
                 epoch, t_submit, tctx=None):
        self.state = state
        self.qid = qid
        self.query = query
        self.future = future
        self.cost_bytes = cost_bytes
        self.cost_units = cost_units
        self.epoch = epoch  # tenant ingest epoch at ADMISSION
        self.t_submit = t_submit
        self.view = None  # MaterializedView when a stale read finalizes
        self.finalize = None  # and the finalize plan it dispatched
        # trace identity, minted at admission — or adopted when the
        # caller minted the qid (``submit(qid=, tctx=)``) so every
        # span/event on this side carries the end-to-end qid
        self.tctx = tctx or tracectx.mint(tenant=state.name, qid=qid)


class _TenantState:
    """Service-internal per-tenant record (queues, quota, counters).
    All mutation under the service lock."""

    def __init__(self, name: str, weight: int, quota: TenantQuota,
                 tier: str = DEFAULT_TIER):
        self.name = name
        self.weight = weight
        self.quota = quota
        self.tier = check_tier(tier)
        self.queue: "deque[_Queued]" = deque()
        self.deficit = 0
        self.visited = False  # earned this visit's refill already
        self.epoch = 0  # ingest epoch: result-cache invalidation signal
        self.saturated = False
        self.inflight = 0  # admitted and not yet resolved
        self.inflight_bytes = 0
        self.seq = 0
        self.admitted = 0
        self.completed = 0
        self.rejected = 0
        self.cache_hits = 0
        self.failed = 0


class TenantSession:
    """A tenant's handle on the service: submit plans, ingest data,
    bump the ingest epoch.  Cheap — open one per logical client."""

    def __init__(self, service: "QueryService", state: _TenantState):
        self._service = service
        self._state = state

    @property
    def name(self) -> str:
        return self._state.name

    @property
    def epoch(self) -> int:
        return self._state.epoch

    def submit(self, query, qid: Optional[str] = None,
               tctx=None) -> QueryFuture:
        """Admit ``query`` (raises :class:`QueryRejected` past quota)
        and return its future.  Never blocks on device work.

        ``qid``/``tctx`` adopt an externally minted query identity, so
        the caller's TraceContext keeps flowing through this engine's
        spans and events."""
        return self._service._submit(self._state, query, qid=qid, tctx=tctx)

    def run(self, query, timeout: Optional[float] = None) -> Dict:
        """Submit and block for the result."""
        return self.submit(query).result(timeout)

    def ingest(self, arrays, **kw):
        """Bind a host table through the shared context.  Streaming —
        no epoch bump: a NEW binding fingerprints differently from
        anything cached, so existing results cannot alias it and stay
        valid.  Invalidation work happens only on :meth:`append`, and
        only for the entries the append actually staled."""
        svc = self._service
        with svc._ctx_lock:
            return svc.ctx.from_arrays(arrays, **kw)

    def append(self, query, arrays) -> int:
        """Append rows to an ingested table WITHOUT stopping the world:
        rewrites the binding in place, drops exactly the cached results
        computed over the table's old bytes (any tenant — the binding
        is shared engine state), and folds the rows as a delta into
        every registered view over it.  Returns the number of cache
        entries invalidated."""
        svc = self._service
        with svc._ctx_lock:
            old_fp = svc.ctx.append_arrays(query, arrays)
            dropped = svc._cache.invalidate_binding(None, old_fp)
            svc.views.apply_delta(query.node.id, arrays)
        return dropped

    def register_view(self, query, name=None, window_col=None,
                      window_count=None, max_staleness_s: float = 0.0):
        """Admit ``query`` as a resident materialized view: reads of
        this exact Query serve a bounded-staleness snapshot (zero
        dispatches fresh, one finalize dispatch stale) and appends to
        its table fold in as deltas.  The default name is the plan's
        process-portable canonical fingerprint.  Raises
        :class:`~dryad_tpu_torch.views.ViewIneligible` (after emitting the
        structured ``view_fallback`` event) for plans with no
        incremental maintenance path."""
        svc = self._service
        with svc._ctx_lock:
            if name is None:
                fp = svc.ctx.query_fingerprint(query)
                cfp = canonical_fingerprint(fp) if fp is not None else None
                if cfp is not None:
                    name = f"view-{cfp[:16]}"
            return svc.views.register(
                self.name, query, name=name, window_col=window_col,
                window_count=window_count,
                max_staleness_s=max_staleness_s,
            )

    def bump_epoch(self) -> None:
        """Advance the ingest epoch: every cached result this tenant
        inserted before now is invalid (epoch-mismatch miss)."""
        with self._service._lock:
            self._state.epoch += 1


class QueryService:
    """Long-lived multiplexing front end over one DryadContext."""

    def __init__(self, ctx, start: bool = True):
        self.ctx = ctx
        self.config = ctx.config
        self.events = ctx.events
        self._cache = ResultCache(
            self.config.serve_result_cache_bytes,
            admission=getattr(
                self.config, "serve_cache_admission", "all"
            ),
            min_sec_per_gb=getattr(
                self.config, "serve_cache_min_sec_per_gb", 0.5
            ),
        )
        # resident materialized views: registered plans whose reads
        # serve snapshots and whose appends fold in as deltas
        self.views = ViewRegistry(ctx, events=self.events)
        self._window = DispatchWindow(
            depth=self.config.dispatch_depth, events=self.events,
            name="serve", headroom=getattr(ctx, "headroom", None),
        )
        # per-tenant SLO plane: admission->completion latency
        # percentiles and windowed admission/completion/rejection
        # counters over the telemetry rolling window — the
        # ``stats()["slo"]`` block
        self.slo = RollingStore(
            window_s=getattr(self.config, "telemetry_window_s", 60.0)
        )
        # driver-side serve spans (cache_probe etc) for the per-query
        # critical-path fold
        self.tracer = Tracer(self.events)
        # per-query trace buffers: an EventLog tap routes each
        # qid-stamped event into its query's buffer between admission
        # and completion, so the critical-path fold at _finish reads one
        # small list instead of refolding the whole ring
        self._trace_buf: Dict[str, list] = {}
        if self.events is not None:
            self.events.add_tap(self._trace_tap)
        # cumulative per-tenant critical-path phase seconds (stats())
        self._phase_totals: Dict[str, Dict[str, float]] = {}
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        # ingest (client threads) vs lowering/dispatch (driver thread)
        # both touch the shared dictionary and binding table; RLock so
        # the driver's fingerprint+dispatch pair stays one critical
        # section.  NEVER held while blocked on the window.
        self._ctx_lock = threading.RLock()
        self._tenants: Dict[str, _TenantState] = {}
        # per-tier deficit-round-robin ring pointers (strict priority
        # across tiers, DRR within)
        self._rr: Dict[str, int] = {}
        self._queued = 0  # total across tenant queues
        self._inflight_items: Dict[str, Tuple[_Queued, Any]] = {}
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        # queue-depth health probe in the shared registry: the flight
        # recorder's microsnapshots sample it
        flightrec.probe(
            "serve:queue",
            lambda: {
                "queued": self._queued,
                "in_flight": len(self._inflight_items),
                "depth": self._window.depth,
            },
        )
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "QueryService":
        """Spawn the driver thread (idempotent).  A service built with
        ``start=False`` queues admissions until started — the fairness
        tests preload competing tenants this way."""
        with self._lock:
            if self._thread is not None or self._closed:
                return self
            self._thread = threading.Thread(
                target=self._drive, name="dryad-serve", daemon=True
            )
            self._thread.start()
        return self

    def close(self, timeout: float = 60.0) -> None:
        """Stop admitting, drain everything already admitted, join the
        driver, close the window.  Safe to call repeatedly."""
        with self._lock:
            already = self._closed
            self._closed = True
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        elif not already:
            # never started: unblock queued clients with a structured
            # rejection instead of letting them wait forever
            self._cancel_queued()
        self._window.close()
        if self.events is not None:
            self.events.remove_tap(self._trace_tap)
        self._trace_buf.clear()
        flightrec.unprobe("serve:queue")

    def __enter__(self) -> "QueryService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- tenants -----------------------------------------------------------

    def session(self, tenant: str, weight: int = 1,
                quota: Optional[TenantQuota] = None,
                tier: Optional[str] = None) -> TenantSession:
        """Open (or re-open) a tenant session.  ``weight`` is the DRR
        share WITHIN the tenant's priority ``tier`` ("latency" tenants
        are always served before "batch" tenants with runnable work);
        ``quota`` defaults to the config budgets."""
        if weight < 1:
            raise ValueError("tenant weight must be >= 1")
        if tier is not None:
            check_tier(tier)
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                st = _TenantState(
                    tenant, weight,
                    quota or TenantQuota(
                        max_inflight=self.config.serve_max_inflight,
                        max_bytes=self.config.serve_max_bytes,
                    ),
                    tier=tier or DEFAULT_TIER,
                )
                self._tenants[tenant] = st
            else:
                st.weight = weight
                if quota is not None:
                    st.quota = quota
                if tier is not None:
                    st.tier = tier
        return TenantSession(self, st)

    # -- admission (client threads) ----------------------------------------

    def _submit(self, st: _TenantState, query, qid: Optional[str] = None,
                tctx=None) -> QueryFuture:
        with self._ctx_lock:
            cost = self.ctx.query_input_bytes(query)
        rejection = None
        quota_event = None
        with self._lock:
            if self._closed:
                rejection = QueryRejected(st.name, "closed", 0, 0)
                st.rejected += 1
                rej_id = f"{st.name}:rej{st.rejected}"
            else:
                try:
                    st.quota.check(
                        st.name, st.inflight, st.inflight_bytes, cost
                    )
                except QueryRejected as e:
                    rejection = e
                    st.rejected += 1
                    rej_id = f"{st.name}:rej{st.rejected}"
            if rejection is None:
                if qid is None:
                    qid = f"{st.name}:{st.seq}"
                st.seq += 1
                item = _Queued(
                    st, qid, query, QueryFuture(st.name, qid), cost,
                    1 + cost // self.config.serve_drr_quantum_bytes,
                    st.epoch, time.monotonic(), tctx=tctx,
                )
                st.inflight += 1
                st.inflight_bytes += cost
                st.admitted += 1
                st.queue.append(item)
                # open the trace buffer BEFORE query_admitted fires so
                # the lifecycle event itself lands in it
                self._trace_buf[qid] = []
                self._queued += 1
                queued = len(st.queue)
                if (not st.saturated
                        and st.inflight >= st.quota.max_inflight):
                    st.saturated = True
                    quota_event = dict(
                        tenant=st.name, state="saturated",
                        inflight=st.inflight,
                        limit=st.quota.max_inflight,
                        bytes=st.inflight_bytes,
                    )
                self._work.notify_all()
        if rejection is not None:
            self.slo.incr("queries_rejected", tenant=st.name)
            self.events.emit(
                "query_rejected", tenant=st.name, query=rej_id,
                reason=rejection.reason, limit=rejection.limit,
                current=rejection.current,
            )
            raise rejection
        self.slo.incr("queries_admitted", tenant=st.name)
        self.slo.set_gauge("serve_queue_depth", self._queued)
        self.events.emit(
            "query_admitted", tenant=st.name, query=qid,
            cost_bytes=cost, queued=queued,
        )
        if quota_event is not None:
            self.events.emit(
                "tenant_quota", tenant=quota_event["tenant"],
                state=quota_event["state"],
                inflight=quota_event["inflight"],
                limit=quota_event["limit"], bytes=quota_event["bytes"],
            )
        return item.future

    # -- fair-share scheduling (driver thread) -----------------------------

    def _pick_locked(self) -> Optional[_Queued]:
        """Strict priority across tiers, weighted deficit round robin
        within each tier.  A runnable latency-tier tenant always goes
        before any batch-tier tenant; weights keep their DRR meaning
        among same-tier peers.  None when nothing is runnable (all
        queues empty, or the window is at depth — dispatching more
        would block the driver)."""
        if len(self._inflight_items) >= self._window.depth:
            return None
        for tier in TIERS:
            ring = [
                st for st in self._tenants.values() if st.tier == tier
            ]
            if not ring or not any(st.queue for st in ring):
                continue
            rr = self._rr.get(tier, 0)
            while True:
                st = ring[rr % len(ring)]
                if not st.queue:
                    # idle tenants forfeit credit: no bursting on
                    # banked idle time when they return
                    st.deficit = 0
                    st.visited = False
                    rr += 1
                    continue
                if not st.visited:
                    st.deficit += st.weight
                    st.visited = True
                head = st.queue[0]
                if st.deficit >= head.cost_units:
                    st.deficit -= head.cost_units
                    st.queue.popleft()
                    self._queued -= 1
                    if not st.queue:
                        st.visited = False
                    self._rr[tier] = rr
                    return head
                # deficit exhausted: next tenant (credit carries over,
                # so an expensive head eventually accumulates its cost)
                st.visited = False
                rr += 1
        return None

    # -- driver loop -------------------------------------------------------

    def _drive(self) -> None:
        try:
            while True:
                with self._lock:
                    item = self._pick_locked()
                    if (item is None and self._closed
                            and self._queued == 0
                            and not self._inflight_items):
                        break
                if item is not None:
                    self._dispatch(item)
                for out in self._window.ready():
                    self._commit(out)
                if item is None:
                    # park: wakes immediately on a window outcome, and
                    # within one short tick of a new submission (two
                    # wait targets, one thread — bounded poll)
                    if not self._window.wait(0.02):
                        with self._work:
                            if self._queued == 0 and not self._closed:
                                self._work.wait(0.02)
        except BaseException as e:  # noqa: BLE001 - fail every future
            log.exception("serve driver died: %r", e)
            self._abort(e)

    def _dispatch(self, item: _Queued) -> None:
        """Resolve ``item`` from the cache, or dispatch it.  Any
        lowering or execution error resolves the future — the loop never
        dies on one tenant's bad plan.  Runs under the query's trace
        context: execute spans and the window handoff inherit its qid."""
        with tracectx.activate(item.tctx):
            self._dispatch_traced(item)

    def _dispatch_traced(self, item: _Queued) -> None:
        st = item.state
        key = None
        run_query = item.query
        try:
            with self._ctx_lock:
                if self.ctx.is_stream_query(item.query):
                    # stream plans route through the StreamExecutor —
                    # no async fetch to window; run inline (rare on a
                    # serving path, still correct)
                    table = self.ctx.run_to_host(item.query)
                    self._finish(item, table=table)
                    return
                view = self.views.lookup(st.name, item.query)
                if view is not None:
                    now = time.monotonic()
                    if view.fresh(now):
                        # fresh snapshot: zero dispatches, zero probes
                        table = view.read_snapshot()
                        rows = (
                            len(next(iter(table.values())))
                            if table else 0
                        )
                        self.slo.incr(
                            "view_snapshots_fresh", tenant=st.name
                        )
                        self.events.emit(
                            "view_snapshot", tenant=st.name,
                            view=view.name, fresh=True, qid=item.qid,
                            rows=rows,
                            staleness_s=round(view.staleness_s(now), 6),
                        )
                        self._finish(item, table=table, cached=True)
                        return
                    # stale: ONE dispatch of the finalize plan over the
                    # resident partial state (the snapshot IS this
                    # plan's cache — skip the result-cache probe)
                    self.events.emit(
                        "view_snapshot", tenant=st.name, view=view.name,
                        fresh=False, qid=item.qid,
                        staleness_s=round(view.staleness_s(now), 6),
                    )
                    item.view = view
                    run_query = item.finalize = finalize_query(view, self.ctx)
                elif self._cache.budget > 0:
                    with self.tracer.span(
                        "cache_probe", cat="serve", query=item.qid,
                    ):
                        fp = self.ctx.query_fingerprint(item.query)
                        table = None
                        if fp is not None:
                            # sha-based trace label, never builtin
                            # hash(): stable across processes
                            cfp = canonical_fingerprint(fp)
                            if cfp is None:
                                # reference-keyed plan: label is
                                # process-local by construction
                                cfp = hashlib.sha256(
                                    repr(fp).encode()
                                ).hexdigest()
                            item.tctx.fingerprint = cfp[:16]
                            key = (st.name, fp)
                            table = self._cache.get(key, item.epoch)
                    if table is not None:
                        rows = (
                            len(next(iter(table.values())))
                            if table else 0
                        )
                        self.slo.incr(
                            "result_cache_hits", tenant=st.name
                        )
                        self.events.emit(
                            "result_cache_hit", tenant=st.name,
                            query=item.qid, rows=rows,
                        )
                        self._finish(item, table=table, cached=True)
                        return
                fetch = self.ctx.run_to_host_async(run_query)
        except Exception as e:
            if item.finalize is not None:
                with self._ctx_lock:
                    item.view.release_finalize(item.finalize, self.ctx)
            self._finish(item, error=e)
            return
        with self._lock:
            self._inflight_items[item.qid] = (item, key)
        self._window.submit(item.qid, fetch)

    def _commit(self, out) -> None:
        tag, value, error = out
        with self._lock:
            item, key = self._inflight_items.pop(tag)
        if item.view is not None:
            # store the finalized snapshot: the next read of this view
            # is zero dispatches until an append folds a newer delta
            with self._ctx_lock:
                if error is None:
                    item.view.commit_snapshot(value, self.ctx, item.finalize)
                else:
                    item.view.release_finalize(item.finalize, self.ctx)
        if error is None and key is not None:
            # observed compute seconds drive cost-aware admission: a
            # cheap-to-recompute result must not displace expensive ones
            self._cache.put(
                key, value, item.epoch,
                cost_s=time.monotonic() - item.t_submit,
            )
        if isinstance(error, BaseException) and not isinstance(
            error, Exception
        ):
            raise error  # KeyboardInterrupt etc: don't swallow
        self._finish(item, table=value, error=error)

    def _finish(self, item: _Queued, table=None, cached: bool = False,
                error: Optional[BaseException] = None) -> None:
        st = item.state
        ok = error is None
        quota_event = None
        with self._lock:
            st.inflight -= 1
            st.inflight_bytes -= item.cost_bytes
            st.completed += 1
            if cached:
                st.cache_hits += 1
            if not ok:
                st.failed += 1
            if st.saturated and st.inflight < st.quota.max_inflight:
                st.saturated = False
                quota_event = dict(
                    tenant=st.name, inflight=st.inflight,
                    limit=st.quota.max_inflight, bytes=st.inflight_bytes,
                )
        seconds = round(time.monotonic() - item.t_submit, 6)
        self.slo.incr("queries_completed", tenant=st.name)
        self.slo.observe_latency("query_latency_s", seconds, tenant=st.name)
        self.slo.set_gauge("serve_queue_depth", self._queued)
        if ok:
            self.events.emit(
                "query_complete", tenant=st.name, query=item.qid,
                ok=True, seconds=seconds, cached=cached,
            )
        else:
            self.events.emit(
                "query_complete", tenant=st.name, query=item.qid,
                ok=False, seconds=seconds, cached=False,
                error=repr(error),
            )
        if quota_event is not None:
            self.events.emit(
                "tenant_quota", tenant=quota_event["tenant"], state="ok",
                inflight=quota_event["inflight"],
                limit=quota_event["limit"], bytes=quota_event["bytes"],
            )
        # critical-path fold: pop the trace buffer (query_complete just
        # landed in it via the tap) and sweep it into per-phase seconds
        # for the tenant's SLO plane.  Attribution failure must never
        # fail the query.
        trace = self._trace_buf.pop(item.qid, None)
        if trace is not None:
            try:
                bd = critpath.fold_query(trace, item.qid)
            except Exception:
                bd = None
            if bd is not None and bd.phases:
                with self._lock:
                    tot = self._phase_totals.setdefault(st.name, {})
                    for ph, secs in bd.phases.items():
                        tot[ph] = tot.get(ph, 0.0) + secs
                for ph, secs in bd.phases.items():
                    if secs > 0.0:
                        self.slo.observe_latency(
                            "query_phase_s", secs,
                            tenant=st.name, phase=ph,
                        )
        item.future.cached = cached
        item.future._resolve(result=table, error=error)

    def _trace_tap(self, ev: Dict[str, Any]) -> None:
        """EventLog tap: route qid-stamped events (and ``query=``-keyed
        lifecycle events) into the per-query trace buffer, if one is
        open.  Runs on every emit; must stay cheap and never raise."""
        q = ev.get("qid")
        if q is None and ev.get("kind") in (
            "query_admitted", "query_complete", "result_cache_hit",
        ):
            q = ev.get("query")
        if q is None:
            return
        buf = self._trace_buf.get(q)
        if buf is not None:
            buf.append(ev)

    # -- failure teardown --------------------------------------------------

    def _cancel_queued(self) -> None:
        with self._lock:
            items = []
            for st in self._tenants.values():
                items.extend(st.queue)
                st.queue.clear()
            self._queued = 0
            for it in items:
                it.state.inflight -= 1
                it.state.inflight_bytes -= it.cost_bytes
        for it in items:
            it.future._resolve(
                error=QueryRejected(it.state.name, "closed", 0, 0)
            )

    def _abort(self, exc: BaseException) -> None:
        """Driver-death last resort: every unresolved future gets the
        error instead of a hang."""
        self._cancel_queued()
        with self._lock:
            inflight = list(self._inflight_items.values())
            self._inflight_items.clear()
        for item, _key in inflight:
            item.future._resolve(error=exc)

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Point-in-time counters for benchmarks and panels."""
        with self._lock:
            tenants = {
                st.name: {
                    "admitted": st.admitted,
                    "completed": st.completed,
                    "rejected": st.rejected,
                    "cache_hits": st.cache_hits,
                    "failed": st.failed,
                    "in_flight": st.inflight,
                    "queued": len(st.queue),
                    "epoch": st.epoch,
                    "saturated": st.saturated,
                    "tier": st.tier,
                }
                for st in self._tenants.values()
            }
        # rolling-window SLO readout: admission->completion latency
        # percentiles per tenant (None until a query completes inside
        # the window), plus cumulative critical-path phase seconds once
        # any query has been folded
        with self._lock:
            phase_totals = {
                t: dict(ph) for t, ph in self._phase_totals.items()
            }
        slo: Dict[str, Any] = {}
        for name in tenants:
            pct = self.slo.percentiles("query_latency_s", tenant=name)
            phases = phase_totals.get(name)
            if phases:
                pct = dict(pct or {})
                pct["phases"] = {
                    p: round(v, 6) for p, v in sorted(phases.items())
                }
            slo[name] = pct
        return {
            "tenants": tenants,
            "slo": slo,
            "cache": self._cache.stats(),
            "views": self.views.stats(),
            "dispatches": self._window.dispatches,
        }
