"""Hierarchical spans over the ``EventLog`` stream (a copy of
``dryad_tpu/obs/span.py``).

A span measures one timed region (chunk, pipeline pull, spill write)
on monotonic clocks and serializes into the event stream as ONE
``span`` event at close: ``{"kind": "span", "name", "cat", "span_id",
"parent_id", "dur", "thread", "qid", ...fields}``; ``qid`` is the
active query's (``obs/tracectx.py``), None outside any query.  Its start is ``mono -
dur``, so the stream never holds an unmatched begin.  Parenting is
implicit per thread (a thread-local stack); work handed to another
thread passes ``parent=`` (:meth:`Tracer.current_id`).  Span ids are unique
process-wide (one shared counter).
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import Any, Optional

from dryad_tpu_torch.obs import tracectx

__all__ = ["Span", "Tracer"]

_ids = itertools.count(1)
_ids_lock = threading.Lock()


def _next_id() -> int:
    with _ids_lock:
        return next(_ids)


_UNSET = object()


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

    def current_id(self) -> Optional[int]:
        """Id of this thread's innermost open span (to pass as
        ``parent=`` into work handed to another thread)."""
        st = self._stack()
        return st[-1].span_id if st else None

    def span(self, name: str, cat: str = "driver", parent=_UNSET, **fields: Any):
        """Open a span as a context manager.  ``parent`` defaults to
        this thread's innermost open span; pass an explicit id (or
        None) when the logical parent lives on another thread."""
        if self._events is None:
            return _NULL
        pid = self.current_id() if parent is _UNSET else parent
        return Span(self, name, cat, pid, dict(fields))

    def traced(self, name: Optional[str] = None, cat: str = "driver", **fields: Any):
        """Decorator form: the wrapped call body runs inside a span."""

        def deco(fn):
            sname = name or fn.__name__

            @functools.wraps(fn)
            def wrapper(*a, **k):
                with self.span(sname, cat=cat, **fields):
                    return fn(*a, **k)

            return wrapper

        return deco
