"""Overlapped gang command streams — the mailbox dispatch window
(``dryad_tpu/cluster/gangwindow.py``).

``submit_many`` historically issued one ``runbatch`` envelope per
worker and then BLOCKED on the whole batch before feeding the next:
the gang sat idle for a full driver round trip between batches.  This
module is the gang-scale analog of ``exec.pipeline.DispatchWindow``
with the same invariants, transplanted from device readbacks to
mailbox round trips:

- the driver thread only FEEDS: it posts each envelope to the workers'
  command mailboxes itself (the posts are cheap local HTTP writes) and
  hands the blocking half — a zero-arg ``drain`` closure that
  long-polls the envelope's per-worker status keys — to ONE background
  collector thread via :meth:`submit`;
- the collector runs the drains strictly in submit order, so batch
  COMMIT order (and everything downstream of it) is exactly the serial
  loop's and results stay byte-identical;
- at most ``depth`` envelopes are in flight (submitted and not yet
  drained): :meth:`submit` blocks past that, waiting on the
  COLLECTOR's progress, never the driver's own — a full window can
  always drain itself;
- a drain exception is delivered at the drain site (never raised on
  the collector thread), where the driver re-runs the envelope's
  failed sub-commands SERIALLY at their commit position
  (:meth:`note_retry` records it);
- :meth:`close` always joins the collector, also mid-error: a
  poisoned window can never deadlock the driver's ``finally``.

Mailbox discipline (graftlint rule 17, ``mailbox-discipline``): the
property mailbox is a latest-value store, so the feed side must never
block on a status drain itself — overlapping envelopes are only safe
because each one posts its status to a distinct per-envelope key and
the collector is the single drain site.  One ``gang_window`` summary
event at close carries totals plus the peak per-worker envelope
overlap actually achieved.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from dryad_tpu_torch.obs import flightrec, tracectx


class GangDispatchWindow:
    """Async mailbox-paced gang dispatch: the driver only feeds."""

    def __init__(self, depth: int, events=None, name: str = "gang"):
        depth = int(depth)
        if depth < 1:
            raise ValueError("gang window depth must be >= 1")
        self.depth = depth
        self.name = name
        self.events = events
        self.dispatches = 0
        self.retries = 0
        self.peak_in_flight = 0
        self._t0_wall = time.monotonic()
        self._pending: list = []  # (tag, drain) awaiting the collector
        self._done: list = []  # (tag, value, error) in submit order
        self._outstanding = 0  # submitted - consumed by the driver
        self._cv = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(
            target=self._collect, name=f"dryad-gangwin-{name}", daemon=True
        )
        flightrec.probe(
            f"gangwindow:{name}",
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
                tag, drain = self._pending[0]
            value, error = None, None
            try:
                value = drain()
            except BaseException as e:  # noqa: BLE001 - delivered at drain
                error = e
            with self._cv:
                if self._pending:  # close() may have dropped the queue
                    self._pending.pop(0)
                self._done.append((tag, value, error))
                self._cv.notify_all()

    # -- driver side -------------------------------------------------------

    def submit(self, tag, drain) -> None:
        """Hand one posted envelope's drain closure to the collector.
        Call immediately after posting the envelope to every worker's
        command mailbox; blocks while the window is full."""
        with self._cv:
            if self._closed:
                raise RuntimeError(f"gang window {self.name} closed")
            # flow control on UN-DRAINED work only: the collector makes
            # progress independently, so this wait always resolves (a
            # wait on driver-consumed counts would deadlock — the
            # driver is the one blocked here)
            while len(self._pending) >= self.depth and not self._closed:
                self._cv.wait(0.1)
            self._pending.append((tag, drain))
            self._outstanding += 1
            self.dispatches += 1
            self._cv.notify_all()

    def note_retry(self) -> None:
        """Record one drain-site serial re-run of a failed envelope."""
        self.retries += 1

    def note_in_flight(self, n: int) -> None:
        """Record an observed per-worker envelope-overlap sample (the
        feed side samples posted-minus-statused at each post)."""
        if n > self.peak_in_flight:
            self.peak_in_flight = n

    def ready(self):
        """Yield completed ``(tag, value, error)`` triples in submit
        order WITHOUT blocking."""
        while True:
            with self._cv:
                if not self._done:
                    return
                item = self._done.pop(0)
                self._outstanding -= 1
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
                self._cv.notify_all()
            yield item

    def close(self, workers: Optional[int] = None) -> None:
        """Join the collector.  Safe from ``finally`` and repeatedly;
        undelivered drains are abandoned (their statuses sit harmlessly
        in per-envelope mailbox keys nobody will read)."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._pending.clear()
            self._cv.notify_all()
        self._thread.join(timeout=30.0)
        flightrec.unprobe(f"gangwindow:{self.name}")
        if self.events is not None:
            extra = {} if workers is None else {"workers": workers}
            self.events.emit(
                "gang_window", pipeline=self.name, depth=self.depth,
                dispatches=self.dispatches, retries=self.retries,
                peak_in_flight=self.peak_in_flight,
                qid=tracectx.current_qid(),
                wall_s=round(time.monotonic() - self._t0_wall, 6),
                **extra,
            )

    def __enter__(self) -> "GangDispatchWindow":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
