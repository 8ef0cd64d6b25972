"""Hierarchical spans over the ``EventLog`` stream (a copy of
``dryad_tpu/obs/span.py``).

A span measures one timed region (chunk, pipeline pull, spill write)
on monotonic clocks and serializes into the event stream as ONE
``span`` event at close: ``{"kind": "span", "name", "cat", "span_id",
"parent_id", "dur", "thread", "qid", ...fields}``; ``qid`` is the
active query's (``obs/tracectx.py``), None outside any query.  Its start is ``mono -
dur``, so the stream never holds an unmatched begin.  Parenting is
implicit per thread (a thread-local stack).  Span ids are unique
process-wide (one shared counter).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any

from dryad_tpu_torch.obs import tracectx

__all__ = ["Span", "Tracer"]

_ids = itertools.count(1)
_ids_lock = threading.Lock()


def _next_id() -> int:
    with _ids_lock:
        return next(_ids)


class Span:
    """One open timed region; emits its ``span`` event at ``__exit__``.
    ``add(**fields)`` attaches facts found mid-region (rows, bytes)."""

    __slots__ = ("_tracer", "name", "cat", "fields", "span_id", "parent_id", "_t0")

    def __init__(self, tracer, name, cat, parent_id, fields):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.fields = fields
        self.span_id = _next_id()
        self.parent_id = parent_id
        self._t0 = 0.0

    def add(self, **fields: Any) -> "Span":
        self.fields.update(fields)
        return self

    def __enter__(self) -> "Span":
        self._tracer._push(self)
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dur = time.monotonic() - self._t0
        self._tracer._pop(self)
        if exc_type is not None and exc_type is not StopIteration:
            # StopIteration ends a prefetch pull's stream: not a fault
            self.fields.setdefault("error", f"{exc_type.__name__}: {exc}")
        # a field passed at construction wins over the thread's scope
        qid = self.fields.pop("qid", None) or tracectx.current_qid()
        self._tracer._events.emit(
            "span", name=self.name, cat=self.cat, span_id=self.span_id,
            parent_id=self.parent_id, dur=round(dur, 6), qid=qid,
            thread=threading.current_thread().name, **self.fields,
        )


class _NullSpan:
    """Shared no-op span of a tracer without an event log."""

    __slots__ = ()
    span_id = None
    parent_id = None

    def add(self, **fields: Any) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL = _NullSpan()


class Tracer:
    """Span factory bound to one event log; thread-safe (each thread
    keeps its own open-span stack).  ``events=None`` yields no-op
    spans, so instrumented code needs no guards."""

    def __init__(self, events=None):
        self._events = events
        self._local = threading.local()

    def _stack(self):
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        elif span in st:  # mis-nested exit: drop it and everything above
            del st[st.index(span):]

    def span(self, name: str, cat: str = "driver", **fields: Any):
        """Open a span as a context manager, the child of this thread's
        innermost open span."""
        if self._events is None:
            return _NULL
        st = self._stack()
        return Span(self, name, cat, st[-1].span_id if st else None, dict(fields))
