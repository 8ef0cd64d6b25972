"""Bounded chunk pipeline of the out-of-core driver and the serving
tier (a copy of ``dryad_tpu/exec/pipeline.py``, with its flight-recorder
probes and query trace handoffs).

Host threads overlap ingest, device compute and readback for the
streaming driver (``exec/outofcore.py``):

- :class:`ChunkPrefetcher` — a background producer pulling (and
  host-decoding) chunk k+2 from the source iterator while the driver
  dispatches chunk k+1's device program, with at most
  ``stream_pipeline_depth`` chunks in flight (semaphore flow control,
  so "in flight" counts the producer's in-hand chunk too);
- :class:`PipelineStats` — per-pipeline occupancy/stall accounting
  (producer vs consumer wait), emitted as ``stream_prefetch`` events
  per chunk and one ``stream_pipeline`` summary at close;
- exception plumbing: a fault in the producer thread re-raises in the
  consumer (announced by a ``stream_pipeline_error`` event), the
  thread always joins, and the semaphore protocol guarantees the
  producer can never deadlock on a dead consumer.

The spill half of the pipeline (background bucket writes) lives next
to the format it serializes: ``exec/spill.py::SpillWriter``.

The dispatch half — the driver keeping N device dispatches in flight
while a background collector drains readbacks in submit order — is
:class:`DispatchWindow` (``config.dispatch_depth``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Iterator, Optional

from dryad_tpu_torch.obs import flightrec, telemetry, tracectx
from dryad_tpu_torch.obs.span import Tracer

__all__ = [
    "ChunkPrefetcher", "DispatchWindow", "PipelineStats", "prefetched",
]


class PipelineStats:
    """Occupancy/stall counters for one pipeline stage pair."""

    def __init__(self) -> None:
        self.produced = 0
        self.consumed = 0
        self.peak_in_flight = 0
        self.producer_wait_s = 0.0  # producer blocked: consumer behind
        self.consumer_wait_s = 0.0  # consumer blocked: producer behind

    def as_fields(self) -> dict:
        return {
            "produced": self.produced,
            "consumed": self.consumed,
            "peak_in_flight": self.peak_in_flight,
            "producer_wait_s": round(self.producer_wait_s, 4),
            "consumer_wait_s": round(self.consumer_wait_s, 4),
        }


class _Done:
    pass


class _Err:
    def __init__(self, exc: BaseException):
        self.exc = exc


class ChunkPrefetcher:
    """Bounded background iterator: runs ``source`` in a thread, hands
    items to the consumer IN ORDER, and keeps at most ``depth`` items
    in flight (queued + the one the producer holds).

    ``close()`` (idempotent; called by ``prefetched`` when its consumer
    finishes or abandons it) stops the producer promptly: it stops pulling new
    items at the next semaphore check and the thread joins.  An
    exception in the producer re-raises from the consumer's next
    ``__next__`` — the original exception object, so the driver's
    failure taxonomy (``exec.failure.classify``) sees the real class
    and message.
    """

    def __init__(
        self,
        source: Iterator,
        depth: int,
        events=None,
        name: str = "prefetch",
    ):
        if depth < 1:
            raise ValueError("pipeline depth must be >= 1")
        self.depth = depth
        self.name = name
        self.events = events
        # producer-thread spans (cat=prefetch): each source pull is one
        # slice on the prefetch track of the Perfetto export
        self._tracer = Tracer(events)
        # the producer thread works FOR the query that built this
        # prefetcher: its cat=prefetch spans carry the qid
        self._tctx = tracectx.current()
        self.stats = PipelineStats()
        self._source = source
        self._sem = threading.Semaphore(depth)  # in-flight budget
        self._items: list = []
        self._cv = threading.Condition()
        self._closed = False
        self._finished = False
        self._thread = threading.Thread(
            target=self._feed, name=f"dryad-{name}", daemon=True
        )
        flightrec.probe(
            f"pipeline:{name}",
            lambda: {
                "queued": len(self._items),
                "in_flight": self.stats.produced - self.stats.consumed,
                "depth": self.depth,
            },
        )
        self._thread.start()

    # -- producer ----------------------------------------------------------

    def _feed(self) -> None:
        with tracectx.activate(self._tctx):
            self._feed_traced()

    def _feed_traced(self) -> None:
        tail: Any = _Done()
        try:
            it = iter(self._source)
            while True:
                t0 = time.monotonic()
                # acquire BEFORE pulling the next item: in-flight
                # (queued + producer in-hand) never exceeds depth
                while not self._sem.acquire(timeout=0.1):
                    if self._closed:
                        return
                self.stats.producer_wait_s += time.monotonic() - t0
                if self._closed:
                    return
                try:
                    with self._tracer.span(
                        self.name, cat="prefetch",
                        chunk=self.stats.produced,
                    ):
                        item = next(it)
                except StopIteration:
                    return
                with self._cv:
                    self._items.append(item)
                    self.stats.produced += 1
                    in_flight = self.stats.produced - self.stats.consumed
                    self.stats.peak_in_flight = max(
                        self.stats.peak_in_flight, in_flight
                    )
                    self._cv.notify_all()
                if self.events is not None:
                    self.events.emit(
                        "stream_prefetch", pipeline=self.name,
                        queued=len(self._items), in_flight=in_flight,
                    )
        except BaseException as e:  # noqa: BLE001 - re-raised in consumer
            tail = _Err(e)
        finally:
            with self._cv:
                self._finished = True
                self._items.append(tail)
                self._cv.notify_all()

    # -- consumer ----------------------------------------------------------

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        t0 = time.monotonic()
        with self._cv:
            while not self._items:
                self._cv.wait(0.1)
                if self._closed and not self._items:
                    raise StopIteration
            item = self._items.pop(0)
        self.stats.consumer_wait_s += time.monotonic() - t0
        if isinstance(item, _Done):
            self._emit_summary()
            raise StopIteration
        if isinstance(item, _Err):
            self._emit_summary(error=item.exc)
            raise item.exc
        self.stats.consumed += 1
        self._sem.release()
        return item

    def close(self) -> None:
        """Stop the producer and join its thread.  Safe to call from
        ``finally`` blocks and repeatedly."""
        with self._cv:
            if self._closed:
                closed_already = True
            else:
                closed_already = False
                self._closed = True
            self._cv.notify_all()
        # unblock a producer waiting on the semaphore
        self._sem.release()
        self._thread.join(timeout=30.0)
        flightrec.unprobe(f"pipeline:{self.name}")
        if not closed_already:
            self._emit_summary()

    _summary_emitted = False

    def _emit_summary(self, error: Optional[BaseException] = None) -> None:
        if self.events is None or self._summary_emitted:
            return
        self._summary_emitted = True
        self.events.emit(
            "stream_pipeline", pipeline=self.name, depth=self.depth,
            **self.stats.as_fields(),
        )
        if error is not None:
            # a first failure with no attempt history: the reference's
            # classification calls it transient
            self.events.emit(
                "stream_pipeline_error", pipeline=self.name,
                phase="prefetch", failure_kind="transient",
                error=f"{type(error).__name__}: {error}",
            )


class DispatchWindow:
    """Async device-paced dispatch: the driver only FEEDS.

    The driver thread dispatches device work itself (kernels queue on
    the card's stream; the executor is driver-owned and not
    thread-safe) and hands the blocking half — the zero-arg ``fetch``
    closure from ``api.context.DryadContext.run_to_host_async`` — to
    ONE background collector thread via :meth:`submit`.  The collector drains fetches
    strictly in submit order, so chunk commit order (and therefore the
    float accumulation order of everything downstream) is exactly the
    serial loop's and results stay byte-identical.

    Window invariants:

    - at most ``depth`` fetches are in flight (handed to the collector
      and not yet drained): :meth:`submit` blocks past that, the flow
      control that bounds host result memory.  The block waits on the
      COLLECTOR's progress, never the driver's own — a full window can
      always drain itself;
    - the collector ONLY calls fetch closures — device dispatch, chunk
      ingest, combines, and retries all stay on the driver thread;
    - outcomes surface in submit order as ``(tag, value, error)``
      triples from :meth:`ready` / :meth:`drain`; a fetch exception is
      delivered at the drain site (never raised on the collector
      thread), where the driver may re-dispatch the chunk — the retry
      re-enters the window at the failed chunk's commit position;
    - :meth:`close` always joins the collector, also mid-error: a
      poisoned window can never deadlock the driver's ``finally``.

    ``dispatch_gap`` events sample the device-idle seconds between the
    previous drain going idle and the next submit (the metric async
    dispatch exists to drive to ~0); one ``dispatch_window`` summary at
    close carries totals plus the driver thread's CPU seconds over the
    window's life.
    """

    def __init__(
        self,
        depth: int,
        events=None,
        name: str = "dispatch",
        headroom=None,
    ):
        # -1: the adaptive depth, a tier of the measured headroom
        # (``obs/telemetry.py``); any depth is byte-identical, the
        # collector drains in submit order
        depth = telemetry.resolve_depth(depth, headroom)
        if depth < 1:
            raise ValueError("dispatch depth must be >= 1")
        self.depth = depth
        self.name = name
        self.events = events
        # collector-thread readback spans (cat=readback): the d2h
        # transfer each query's critical path ends on
        self._tracer = Tracer(events)
        self.dispatches = 0
        self.retries = 0
        self.gap_s = 0.0
        self._t0_wall = time.monotonic()
        # driver CPU over the window's life: __init__/close both run on
        # the driver thread, so thread_time deltas are driver-only
        self._t0_cpu = time.thread_time()
        self._pending: list = []  # (tag, fetch, tctx) for the collector
        self._done: list = []  # (tag, value, error) in submit order
        self._outstanding = 0  # submitted - consumed by the driver
        self._cv = threading.Condition()
        self._closed = False
        # None until the first drain-to-empty: the span between window
        # creation and the first submit is ingest warmup, not a
        # dispatch gap — counting it would drown the between-dispatch
        # signal the metric exists for
        self._idle_since: Optional[float] = None
        # when the driver last consumed an outcome (ready/drain pop):
        # once everything submitted has been committed, idle time past
        # this point is between-query think time on a shared window,
        # not a device gap — submit clamps its gap accounting here
        self._last_commit: Optional[float] = None
        self._thread = threading.Thread(
            target=self._collect, name=f"dryad-{name}", daemon=True
        )
        flightrec.probe(
            f"dispatch:{name}",
            lambda: {
                "in_flight": len(self._pending),
                "outstanding": self._outstanding,
                "depth": self.depth,
            },
        )
        self._thread.start()

    # -- collector thread --------------------------------------------------

    def _collect(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait(0.1)
                if not self._pending:
                    return  # closed and drained
                tag, fetch, tctx = self._pending[0]
            value, error = None, None
            try:
                # the fetch works FOR the query that submitted it:
                # readback spans on this thread carry its qid
                with tracectx.activate(tctx), self._tracer.span(
                    "fetch", cat="readback", pipeline=self.name,
                ):
                    value = fetch()
            except BaseException as e:  # noqa: BLE001 - delivered at drain
                error = e
            with self._cv:
                if self._pending:  # close() may have dropped the queue
                    self._pending.pop(0)
                self._done.append((tag, value, error))
                if not self._pending:
                    self._idle_since = time.monotonic()
                self._cv.notify_all()

    # -- driver side -------------------------------------------------------

    def submit(self, tag, fetch) -> None:
        """Hand one dispatched chunk's fetch closure to the collector.
        Call immediately after the async dispatch; blocks while the
        window is full (``depth`` outstanding)."""
        now = time.monotonic()
        with self._cv:
            if self._closed:
                raise RuntimeError(f"dispatch window {self.name} closed")
            if not self._pending and self._idle_since is not None:
                end = now
                if self._outstanding == 0 and self._last_commit is not None:
                    # fully drained AND fully committed: the previous
                    # query/stream ended here, so the tail between its
                    # last commit and this submit is caller think time
                    # (inter-query idle on a shared serve window), not
                    # device starvation — clamp to the last commit
                    end = min(now, self._last_commit)
                gap = max(0.0, end - self._idle_since)
                self.gap_s += gap
                in_flight = len(self._pending)
            else:
                gap = None
            # flow control on UN-FETCHED work only: the collector makes
            # progress independently, so this wait always resolves (a
            # wait on driver-consumed counts would deadlock — the
            # driver is the one blocked here)
            while len(self._pending) >= self.depth and not self._closed:
                self._cv.wait(0.1)
            self._pending.append((tag, fetch, tracectx.current()))
            self._outstanding += 1
            self.dispatches += 1
            self._idle_since = None
            self._cv.notify_all()
        if gap is not None and self.events is not None:
            self.events.emit(
                "dispatch_gap", pipeline=self.name,
                gap_s=round(gap, 6), in_flight=in_flight,
                qid=tracectx.current_qid(),
            )

    def note_retry(self) -> None:
        """Record one drain-time chunk retry (re-entered the window)."""
        self.retries += 1

    def wait(self, timeout: float = 0.1) -> bool:
        """Block until at least one outcome is ready for :meth:`ready`
        (True), or the window is idle or closed, or ``timeout`` elapses
        (False): the serving driver parks here when its tenant queues
        hold nothing runnable."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while not self._done:
                if self._closed or (not self._pending and self._outstanding == 0):
                    return False
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(min(remaining, 0.1))
            return True

    def ready(self):
        """Yield completed ``(tag, value, error)`` triples in submit
        order WITHOUT blocking — the driver's between-dispatches
        commit opportunity."""
        while True:
            with self._cv:
                if not self._done:
                    return
                item = self._done.pop(0)
                self._outstanding -= 1
                self._last_commit = time.monotonic()
                self._cv.notify_all()
            yield item

    def drain(self):
        """Yield every remaining outcome in submit order, blocking
        until the collector delivers each."""
        while True:
            with self._cv:
                while not self._done:
                    if not self._pending and self._outstanding == 0:
                        return
                    self._cv.wait(0.1)
                item = self._done.pop(0)
                self._outstanding -= 1
                self._last_commit = time.monotonic()
                self._cv.notify_all()
            yield item

    def close(self) -> None:
        """Join the collector.  Safe from ``finally`` and repeatedly;
        undelivered fetches are abandoned (their device work completes
        harmlessly — readback never happens)."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            # abandoned pending fetches would block the join on device
            # readbacks nobody will consume; the collector checks
            # _closed only between fetches, so drop the queue here
            self._pending.clear()
            self._cv.notify_all()
        self._thread.join(timeout=30.0)
        flightrec.unprobe(f"dispatch:{self.name}")
        if self.events is not None:
            self.events.emit(
                "dispatch_window", pipeline=self.name, depth=self.depth,
                dispatches=self.dispatches, retries=self.retries,
                gap_s=round(self.gap_s, 6),
                wall_s=round(time.monotonic() - self._t0_wall, 6),
                driver_cpu_s=round(
                    time.thread_time() - self._t0_cpu, 6
                ),
            )


def prefetched(source, depth: int, events=None, name: str = "prefetch"):
    """Generator wrapper: yield from a :class:`ChunkPrefetcher` over
    ``source`` when ``depth > 1``, closing it even when the consumer
    abandons the stream early (``take``); pass-through at depth 1 (the
    serial driver — no thread, no reordering risk)."""
    if depth <= 1:
        yield from source
        return
    pf = ChunkPrefetcher(iter(source), depth, events=events, name=name)
    try:
        yield from pf
    finally:
        pf.close()
