"""Gang telemetry aggregation: worker -> driver span/counter batches.

The reference runs its Calypso reporter INSIDE the GraphManager, so
every vertex event already lands in one process.  Our workers are
separate OS processes (possibly separate hosts); their span/counter
events never left the worker before this module.  The path:

- the worker keeps a local in-memory ``EventLog`` and, after each
  command, ships ``EventLog.drain()`` through its ControlPlane mailbox
  as numbered ``telemetry/<pid>/<seq>`` properties (numbered — the
  mailbox has latest-value semantics per property, so one slot would
  drop batches the driver hadn't read yet);
- the driver drains the numbered batches after each submission and
  absorbs them into ITS event log with a per-worker **clock-offset
  correction**, producing one merged cluster-wide stream jobview and
  the Perfetto exporter consume directly.

Clock offset: each batch carries the worker's wall clock at ship time;
the driver estimates ``offset = driver_receive_wall - worker_ship_wall``
and keeps the MINIMUM across batches (the estimate includes mailbox
transit + poll latency, so the minimum is the tightest bound on true
skew).  Worker event timestamps shift by that offset before merging.
On one host the skew is ~0 and the correction is a no-op bounded by
poll latency; across hosts it aligns each worker's track to the
driver's timeline.  This shared accounting channel is also the
groundwork for multihost quarantine (ROADMAP open item).
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List

__all__ = ["ship_telemetry", "drain_telemetry", "ship_failure_deltas"]


def ship_telemetry(cp, batch: List[Dict[str, Any]]) -> None:
    """Worker side: publish one batch of events through the control
    plane (no-op for an empty batch).  ``cp`` is a ControlPlane."""
    if not batch:
        return
    seq = getattr(cp, "_telemetry_seq", 0) + 1
    cp._telemetry_seq = seq
    body = json.dumps({"wall": time.time(), "batch": batch}).encode()
    cp._set(f"telemetry/{cp.process_id}/{seq}", body)


def ship_failure_deltas(cp, scheduler, events=None) -> int:
    """The multihost shared-quarantine export (ROADMAP open item):
    drain the local scheduler's unshipped failure counts and publish
    them as ``quarantine_delta`` events through the SAME numbered
    telemetry channel the span batches ride.  Every peer driver that
    drains the channel folds the deltas into its own scheduler
    (``drain_telemetry(..., scheduler=)``), so the whole gang converges
    on one blacklist.  Returns the number of deltas shipped."""
    deltas = scheduler.failure_delta()
    if not deltas:
        return 0
    now = time.time()
    batch = []
    for comp, count in sorted(deltas.items()):
        if events is not None:
            events.emit(
                "quarantine_delta", computer=comp, count=count,
                src=cp.process_id,
            )
        batch.append({
            "ts": now, "kind": "quarantine_delta", "computer": comp,
            "count": int(count), "src": cp.process_id,
        })
    ship_telemetry(cp, batch)
    return len(batch)


def drain_telemetry(
    cp, n: int, state: Dict[int, Dict[str, Any]], events,
    scheduler=None,
) -> int:
    """Driver side: drain every worker's unread telemetry batches into
    ``events`` (the driver's EventLog) with clock-offset-corrected
    timestamps and a ``worker`` field.  ``state`` persists the
    per-worker read cursor + best offset across calls (the caller owns
    it).  ``scheduler``: when given, ``quarantine_delta`` events from
    OTHER processes fold into its failure accounting (the absorb half
    of the multihost shared blacklist; own-pid deltas are skipped so a
    driver never double-counts what it already recorded locally).
    Returns the number of absorbed events."""
    absorbed = 0
    for i in range(n):
        st = state.setdefault(i, {"seq": 0, "off": None})
        while True:
            got = cp._get(f"telemetry/{i}/{st['seq'] + 1}")
            if got is None:
                break
            st["seq"] += 1
            payload = json.loads(got[1])
            est = time.time() - payload.get("wall", time.time())
            if st["off"] is None or est < st["off"]:
                st["off"] = est
            off = st["off"]
            for ev in payload.get("batch", []):
                if (
                    scheduler is not None
                    and ev.get("kind") == "quarantine_delta"
                    and ev.get("src") != cp.process_id
                ):
                    scheduler.absorb_remote_failures(
                        {ev["computer"]: int(ev.get("count", 1))},
                        source=ev.get("src"),
                    )
                ev = dict(ev, worker=i, clock_offset=round(off, 6))
                if "ts" in ev:
                    ev["ts"] = ev["ts"] + off
                events.absorb(ev)
                absorbed += 1
    if absorbed:
        events.emit(
            "telemetry_merged", events=absorbed,
            offsets={
                str(i): round(st["off"], 6)
                for i, st in state.items() if st["off"] is not None
            },
        )
    return absorbed
