"""Query-scoped trace context (a copy of ``dryad_tpu/obs/tracectx.py``).

A :class:`TraceContext` is minted once per query (at ``QueryService``
admission, or at ``DryadContext.run_*`` for other jobs, when
``config.query_trace`` is on) and carried

- within a thread by a thread-local stack (:func:`activate`), so the
  ``span`` and ``dispatch_gap`` emit sites stamp ``qid=`` without an
  argument threaded through every layer;
- across threads by capturing :func:`current` at the handoff point
  (``DispatchWindow.submit``, ``ChunkPrefetcher`` construction) and
  re-activating it inside the worker thread;
- across processes by :meth:`TraceContext.to_wire` /
  :meth:`from_wire` (a vertex command's envelope carries it to the
  worker, ``cluster/localjob.py`` and ``cluster/worker.py``).

The event kinds that carry ``qid`` are ``QUERY_SCOPED_KINDS`` in
:mod:`dryad_tpu_torch.exec.events`.  :func:`current_qid` on the hot
span path is one thread-local attribute read.
"""

from __future__ import annotations

import itertools
import os
import threading
from contextlib import contextmanager
from typing import Any, Dict, Optional

__all__ = [
    "TraceContext", "activate", "current", "current_qid", "mint",
]

# process-wide sequence for auto-minted qids (non-serve jobs); serve
# queries use the service's ``tenant:seq`` admission id instead
_seq = itertools.count(1)


class TraceContext:
    """Identity of one query: ``qid`` (globally unique), tenant, plan
    fingerprint, and the driver-side parent span id (for cross-process
    span reparenting in the merged timeline)."""

    __slots__ = ("qid", "tenant", "fingerprint", "parent_span")

    def __init__(
        self,
        qid: str,
        tenant: Optional[str] = None,
        fingerprint: Optional[str] = None,
        parent_span: Optional[int] = None,
    ):
        self.qid = qid
        self.tenant = tenant
        self.fingerprint = fingerprint
        self.parent_span = parent_span

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"TraceContext(qid={self.qid!r}, tenant={self.tenant!r}, "
            f"fingerprint={self.fingerprint!r}, "
            f"parent_span={self.parent_span!r})"
        )

    # -- wire form (gang mailbox envelopes) -------------------------------
    def to_wire(self) -> Dict[str, Any]:
        """JSON-safe dict for mailbox envelopes; omits empty fields."""
        out: Dict[str, Any] = {"qid": self.qid}
        if self.tenant is not None:
            out["tenant"] = self.tenant
        if self.fingerprint is not None:
            out["fingerprint"] = self.fingerprint
        if self.parent_span is not None:
            out["parent_span"] = self.parent_span
        return out

    @classmethod
    def from_wire(cls, d: Optional[Dict[str, Any]]) -> Optional["TraceContext"]:
        """Rebuild from an envelope field; ``None``/malformed -> None
        (old drivers may post envelopes without a context)."""
        if not isinstance(d, dict) or "qid" not in d:
            return None
        return cls(
            qid=str(d["qid"]),
            tenant=d.get("tenant"),
            fingerprint=d.get("fingerprint"),
            parent_span=d.get("parent_span"),
        )


_local = threading.local()


def current() -> Optional[TraceContext]:
    """The innermost active context on this thread, or None."""
    st = getattr(_local, "stack", None)
    return st[-1] if st else None


def current_qid() -> Optional[str]:
    """Hot-path accessor: the active query id, or None outside any
    query scope (every query-scoped emit site passes this as qid=)."""
    st = getattr(_local, "stack", None)
    return st[-1].qid if st else None


@contextmanager
def activate(ctx: Optional[TraceContext]):
    """Make *ctx* the active context for the dynamic extent.

    ``activate(None)`` is a true no-op (the surrounding context, if
    any, stays active) — handoff sites capture ``current()`` and
    re-activate unconditionally, and a capture taken outside any query
    must not mask a context the executing thread already holds.
    """
    if ctx is None:
        yield None
        return
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    st.append(ctx)
    try:
        yield ctx
    finally:
        # tolerate mis-nested exits the way Tracer._pop does
        if st and st[-1] is ctx:
            st.pop()
        elif ctx in st:
            del st[st.index(ctx):]


def mint(
    tenant: Optional[str] = None,
    fingerprint: Optional[str] = None,
    qid: Optional[str] = None,
    parent_span: Optional[int] = None,
) -> TraceContext:
    """New context; ``qid`` defaults to ``q-<pid>-<seq>`` (unique per
    process, distinguishable across a driver + gang worker fleet)."""
    if qid is None:
        qid = f"q-{os.getpid()}-{next(_seq)}"
    return TraceContext(
        qid=qid, tenant=tenant, fingerprint=fingerprint,
        parent_span=parent_span,
    )
