"""Online diagnosis engine — live pathology detection with evidence.

The reference GM continuously monitored per-vertex execution
statistics and *acted* on them (dynamic graph rewrites, duplicate
dispatch, failure forensics) — the statistics were an input to
control, not a dashboard.  This module is that layer above raw
telemetry: streaming folds over the live event stream (an ``EventLog``
tap) that detect NAMED pathologies and emit each as a
schema-registered ``diagnosis`` event carrying a rule id, severity,
an evidence dict, and a remediation hint.

Rules (``rule`` field of the emitted event):

- ``recompile_storm`` — xla_compile rate per stage/lowering tier
  exceeds ``diagnose_recompile_burst`` inside the sliding window (the
  palette exists so tiers compile once; a storm means shape-baking).
- ``straggler`` — a completed vertex/stage duration is a z-score
  outlier vs its :class:`exec.stats.StageStatistics` family, or an
  IN-FLIGHT task exceeds the family's ``spare_threshold`` (the
  proactive path — :meth:`DiagnosisEngine.note_inflight` — which
  feeds coded-parity pre-launch *before* the first failure).
- ``partition_skew`` — per-bucket row imbalance (max/mean at or above
  ``diagnose_skew_ratio``) folded live from ``stream_spill`` events
  and from ``partition_rows`` histograms in ``metrics`` snapshots.
- ``stall_dominance`` — cumulative ingest stall dominates execute
  time (the pipeline is IO-bound, not compute-bound).
- ``quarantine_churn`` — a computer cycles through quarantine
  repeatedly (probation readmissions keep failing).
- ``combine_thrash`` — the streaming-combine degrade/reprobe policy
  oscillates between host and device modes.
- ``overflow_loop`` — one stage overflows its shuffle capacity
  repeatedly, walking the bounded palette instead of fitting.
- ``quota_pressure`` — one tenant's admissions are rejected
  repeatedly inside the sliding window (the serving tier is shedding
  that tenant's load, not absorbing a one-off burst).

Each (rule, subject) pair re-announces at most once per
``diagnose_cooldown_s`` — a persistent pathology must not flood the
very stream it is diagnosing.  The engine keeps every emitted
diagnosis in :attr:`records` for ``Query.explain(analyze=True)``,
the jobview health panel, and the bench ``diagnoses`` block; the
module-level :func:`scan` re-runs the same folds over a RECORDED
stream (loaded JSONL / blackbox dumps).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from dryad_tpu_torch.exec.stats import StageStatistics
from dryad_tpu_torch.obs import tracectx

__all__ = ["DiagnosisEngine", "scan", "RULES", "drain_recent"]

# Process-wide tail of emitted diagnoses (across ALL engines): the
# bench harness drains this into each metric record's ``diagnoses``
# block without holding a handle on every context it benchmarked.
_RECENT: "deque" = deque(maxlen=256)


def drain_recent() -> List[Dict[str, Any]]:
    """Return and clear the process-wide recent-diagnosis tail."""
    out = list(_RECENT)
    _RECENT.clear()
    return out

# rule id -> (severity, remediation hint)
RULES: Dict[str, Tuple[str, str]] = {
    "recompile_storm": (
        "error",
        "a shape or constant is baked into the lowering key — run the "
        "recompile-hazard lint, widen the palette, or pin the vocab",
    ),
    "straggler": (
        "warn",
        "pre-launch coded parity / duplicate the task; check the "
        "computer if one host dominates the stragglers",
    ),
    "partition_skew": (
        "warn",
        "key distribution is skewed — raise shuffle_slack, lower "
        "combine_tree_degrade_ratio, or salt the hot keys",
    ),
    "stall_dominance": (
        "warn",
        "the job is ingest-bound — raise stream_pipeline_depth / "
        "io_threads or move inputs closer to the accelerator",
    ),
    "quarantine_churn": (
        "error",
        "a computer cycles through quarantine — remove it from the "
        "pool; probation keeps readmitting a bad host",
    ),
    "combine_thrash": (
        "warn",
        "degrade/reprobe oscillates — raise stream_host_reprobe or "
        "adjust combine_tree_degrade_ratio so the decision sticks",
    ),
    "overflow_loop": (
        "warn",
        "repeated shuffle overflow on one stage — raise shuffle_slack "
        "or fix the skew the partition_skew rule is pointing at",
    ),
    "quota_pressure": (
        "warn",
        "one tenant keeps hitting admission rejection — raise its "
        "serve_max_inflight/serve_max_bytes quota or DRR weight, or "
        "shed load client-side with backoff on QueryRejected",
    ),
    "hbm_pressure": (
        "warn",
        "measured device HBM is nearly exhausted — the rewriter "
        "narrows the staged-exchange window; consider lowering "
        "dispatch_depth/chunk_fuse or raising exchange_hbm_budget_mb "
        "headroom by shrinking resident operands",
    ),
}

_WINDOW_S = 60.0  # sliding window for rate-based rules
_MIN_STALL_S = 1.0  # ignore stall dominance below this absolute cost
_HBM_PRESSURE_RATIO = 0.92  # used/limit at or above diagnoses pressure


class _Tuning:
    """Thresholds with config fallbacks (engine works config-less)."""

    def __init__(self, config):
        g = lambda k, d: getattr(config, k, d) if config is not None else d  # noqa: E731
        self.skew_ratio = float(g("diagnose_skew_ratio", 4.0))
        self.recompile_burst = int(g("diagnose_recompile_burst", 4))
        self.cooldown_s = float(g("diagnose_cooldown_s", 5.0))
        self.floor_ratio = float(g("straggler_floor_ratio", 1.5))
        self.sigmas = float(g("outlier_sigmas", 3.0))


class DiagnosisEngine:
    """Streaming folds over one event stream; see the module doc.

    ``events`` is the sink diagnoses are emitted into (usually the
    SAME log the engine taps — ``observe`` ignores ``diagnosis``
    events, so there is no feedback loop).  ``None`` retains records
    without emitting (the offline :func:`scan` path).
    """

    def __init__(self, config=None, events=None):
        self.tuning = _Tuning(config)
        self.events = events
        self._lock = threading.Lock()
        self.records: List[Dict[str, Any]] = []
        # (rule, subject) -> mono of last emission (cooldown dedup)
        self._last: Dict[Tuple[str, str], float] = {}
        # per-family completed-duration statistics (straggler feed,
        # and the coded-spare seeding surface: stats persist across
        # jobs on one engine, so job N+1 has a threshold at t=0)
        self._stats: Dict[str, StageStatistics] = {}
        # recompile_storm: stage -> deque[(mono, key)]
        self._compiles: Dict[str, deque] = {}
        # partition_skew: (source, depth) -> bucket -> rows
        self._buckets: Dict[Tuple[str, Any], Dict[int, int]] = {}
        # stall_dominance accumulators
        self._ingest_stall_s = 0.0
        self._execute_s = 0.0
        # quarantine_churn: computer -> count
        self._quarantines: Dict[str, int] = {}
        # combine_thrash: deque[(mono, mode)] of policy decisions
        self._modes: deque = deque(maxlen=64)
        self._mode_flips = 0
        # overflow_loop: stage name -> count
        self._overflows: Dict[str, int] = {}
        # quota_pressure: tenant -> deque[mono] of rejections
        self._rejections: Dict[str, deque] = {}

    # -- public fold surface -------------------------------------------------

    def observe(self, ev: Dict[str, Any]) -> None:
        """EventLog tap: fold one event.  Never raises."""
        try:
            self._observe(ev)
        except Exception:
            pass  # observability must never fail the job

    def stats_for(self, family: str) -> StageStatistics:
        """Completed-duration statistics for one task family (e.g.
        ``"coded"``, ``"vertex"``, ``"stage:<name>"``) — the surface
        coded-spare pre-launch seeds from."""
        with self._lock:
            st = self._stats.get(family)
            if st is None:
                st = self._stats[family] = StageStatistics(
                    outlier_sigmas=self.tuning.sigmas,
                    floor_ratio=self.tuning.floor_ratio,
                )
            return st

    def spare_threshold(self, family: str) -> Optional[float]:
        return self.stats_for(family).spare_threshold()

    def note_inflight(
        self, family: str, elapsed: float, subject: str = ""
    ) -> Optional[float]:
        """Proactive straggler probe: *elapsed* seconds in flight for
        one *family* task.  When the family's spare threshold exists
        and is exceeded, emits a ``straggler`` diagnosis and returns
        the threshold (the caller's pre-launch trigger); else None."""
        st = self.stats_for(family)
        thr = st.spare_threshold()
        if thr is None or elapsed <= thr:
            return None
        self._diagnose(
            "straggler",
            subject or family,
            evidence={
                "family": family,
                "elapsed_s": round(float(elapsed), 4),
                "threshold_s": round(float(thr), 4),
                "samples": len(st.durations),
                "in_flight": True,
            },
        )
        return thr

    def diagnoses(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self.records)

    # -- emission ------------------------------------------------------------

    def _diagnose(
        self,
        rule: str,
        subject: str,
        evidence: Dict[str, Any],
        stage: Optional[str] = None,
        name: Optional[str] = None,
    ) -> bool:
        severity, hint = RULES[rule]
        now = time.monotonic()
        with self._lock:
            last = self._last.get((rule, subject))
            if last is not None and now - last < self.tuning.cooldown_s:
                return False
            self._last[(rule, subject)] = now
            rec = {
                "rule": rule,
                "severity": severity,
                "subject": subject,
                "evidence": evidence,
                "hint": hint,
            }
            self.records.append(rec)
            _RECENT.append(rec)
        if self.events is not None:
            extra: Dict[str, Any] = {}
            if stage is not None:
                extra["stage"] = stage
            if name is not None:
                extra["name"] = name
            self.events.emit(
                "diagnosis", rule=rule, severity=severity,
                evidence=dict(evidence, subject=subject), hint=hint,
                qid=tracectx.current_qid(), **extra,
            )
        return True

    # -- the folds -----------------------------------------------------------

    def _observe(self, ev: Dict[str, Any]) -> None:
        kind = ev.get("kind")
        if kind in ("diagnosis", "events_dropped"):
            return  # no feedback loops; truncation markers fold nowhere
        if kind == "xla_compile":
            self._fold_compile(ev)
        elif kind in ("vertex_complete", "coded_task_complete"):
            fam = "vertex" if kind == "vertex_complete" else "coded"
            self._fold_duration(fam, ev.get("seconds"), ev)
        elif kind == "stage_complete":
            self._fold_duration(
                f"stage:{ev.get('name', '?')}", ev.get("seconds"), ev
            )
        elif kind == "gang_run_complete":
            self._fold_duration("gang", ev.get("seconds"), ev)
        elif kind == "stream_spill":
            self._fold_bucket(ev)
        elif kind == "metrics":
            self._fold_metrics(ev)
        elif kind == "stream_pipeline":
            self._ingest_stall_s += float(ev.get("consumer_wait_s", 0.0) or 0)
            self._check_stall()
        elif kind == "span":
            if ev.get("cat") == "execute":
                self._execute_s += float(ev.get("dur", 0.0) or 0)
        elif kind == "computer_quarantined":
            self._fold_quarantine(ev)
        elif kind == "stream_combine_policy":
            self._fold_mode(ev)
        elif kind == "stage_overflow":
            self._fold_overflow(ev)
        elif kind == "query_rejected":
            self._fold_rejection(ev)
        elif kind == "resource_sample":
            self._fold_resource(ev)

    def _fold_resource(self, ev: Dict[str, Any]) -> None:
        """Measured HBM near the limit diagnoses ``hbm_pressure`` —
        the rewriter folds it into a conservative exchange-window
        retune.  Host-fallback samples (no device limit) fold
        nowhere."""
        used = int(ev.get("hbm_used_bytes", 0) or 0)
        limit = int(ev.get("hbm_limit_bytes", 0) or 0)
        if limit <= 0:
            return
        ratio = used / limit
        if ratio >= _HBM_PRESSURE_RATIO:
            self._diagnose(
                "hbm_pressure", "hbm",
                evidence={
                    "used": used,
                    "limit": limit,
                    "ratio": round(ratio, 4),
                    "headroom": max(0, limit - used),
                },
            )

    def _fold_compile(self, ev: Dict[str, Any]) -> None:
        stage = str(ev.get("stage", "?"))
        now = time.monotonic()
        dq = self._compiles.setdefault(stage, deque(maxlen=128))
        dq.append((now, ev.get("key")))
        while dq and now - dq[0][0] > _WINDOW_S:
            dq.popleft()
        if len(dq) >= self.tuning.recompile_burst:
            keys = sorted({str(k) for _, k in dq})
            self._diagnose(
                "recompile_storm",
                stage,
                evidence={
                    "compiles": len(dq),
                    "window_s": _WINDOW_S,
                    "keys": keys[:8],
                    "distinct_keys": len(keys),
                },
                stage=stage,
            )

    def _fold_duration(
        self, family: str, seconds, ev: Dict[str, Any]
    ) -> None:
        if seconds is None:
            return
        dur = float(seconds)
        st = self.stats_for(family)
        if st.is_outlier(dur):
            thr = st.outlier_threshold()
            which = ev.get("part", ev.get("coded", ev.get("seq", "")))
            self._diagnose(
                "straggler",
                f"{family}:{which}" if which != "" else family,
                evidence={
                    "family": family,
                    "seconds": round(dur, 4),
                    "threshold_s": round(float(thr), 4) if thr else None,
                    "samples": len(st.durations),
                    "in_flight": False,
                },
            )
        st.record(dur)

    def _fold_bucket(self, ev: Dict[str, Any]) -> None:
        key = ("spill", ev.get("depth"))
        rows = self._buckets.setdefault(key, {})
        b = int(ev.get("bucket", 0) or 0)
        rows[b] = rows.get(b, 0) + int(ev.get("rows", 0) or 0)
        self._check_skew(f"spill depth={key[1]}", rows)

    def _fold_metrics(self, ev: Dict[str, Any]) -> None:
        for h in ev.get("hists", []) or []:
            if h.get("name") != "partition_rows" or not h.get("n"):
                continue
            mean = h["sum"] / h["n"]
            mx = float(h.get("max", 0) or 0)
            if mean > 0 and mx / mean >= self.tuning.skew_ratio:
                self._diagnose(
                    "partition_skew",
                    f"hist:{h.get('labels')}",
                    evidence={
                        "source": "partition_rows histogram",
                        "labels": h.get("labels"),
                        "max_rows": mx,
                        "mean_rows": round(mean, 2),
                        "ratio": round(mx / mean, 2),
                        "samples": h["n"],
                    },
                )

    def _check_skew(self, subject: str, rows: Dict[int, int]) -> None:
        if len(rows) < 4:
            return  # imbalance over <4 buckets is noise
        total = sum(rows.values())
        if total <= 0:
            return
        mean = total / len(rows)
        mx = max(rows.values())
        if mean > 0 and mx / mean >= self.tuning.skew_ratio:
            hot = max(rows, key=rows.get)  # type: ignore[arg-type]
            self._diagnose(
                "partition_skew",
                subject,
                evidence={
                    "source": "stream_spill",
                    "buckets": len(rows),
                    "hot_bucket": hot,
                    "hot_rows": rows[hot],
                    "mean_rows": round(mean, 2),
                    "ratio": round(mx / mean, 2),
                },
            )

    def _check_stall(self) -> None:
        if self._ingest_stall_s < _MIN_STALL_S:
            return
        if self._ingest_stall_s > 2.0 * max(self._execute_s, 1e-9):
            self._diagnose(
                "stall_dominance",
                "pipeline",
                evidence={
                    "ingest_stall_s": round(self._ingest_stall_s, 4),
                    "execute_s": round(self._execute_s, 4),
                },
            )

    def _fold_quarantine(self, ev: Dict[str, Any]) -> None:
        comp = str(ev.get("computer", "?"))
        n = self._quarantines.get(comp, 0) + 1
        self._quarantines[comp] = n
        if n >= 2:
            self._diagnose(
                "quarantine_churn",
                comp,
                evidence={"computer": comp, "quarantined": n},
                name=comp,
            )

    def _fold_mode(self, ev: Dict[str, Any]) -> None:
        mode = ev.get("mode")
        now = time.monotonic()
        if self._modes and self._modes[-1][1] != mode:
            self._mode_flips += 1
        self._modes.append((now, mode))
        if self._mode_flips >= 3:
            self._diagnose(
                "combine_thrash",
                "stream_combine",
                evidence={
                    "flips": self._mode_flips,
                    "recent_modes": [m for _, m in list(self._modes)[-8:]],
                },
            )

    def _fold_overflow(self, ev: Dict[str, Any]) -> None:
        name = str(ev.get("name", ev.get("stage", "?")))
        n = self._overflows.get(name, 0) + 1
        self._overflows[name] = n
        if n >= 2:
            self._diagnose(
                "overflow_loop",
                name,
                evidence={"overflows": n, "boost": ev.get("boost")},
                stage=ev.get("stage"),
                name=name,
            )


    def _fold_rejection(self, ev: Dict[str, Any]) -> None:
        tenant = str(ev.get("tenant", "?"))
        now = time.monotonic()
        dq = self._rejections.setdefault(tenant, deque(maxlen=128))
        dq.append(now)
        while dq and now - dq[0] > _WINDOW_S:
            dq.popleft()
        if len(dq) >= 3:
            self._diagnose(
                "quota_pressure",
                tenant,
                evidence={
                    "tenant": tenant,
                    "rejections": len(dq),
                    "window_s": _WINDOW_S,
                    "reason": ev.get("reason"),
                    "limit": ev.get("limit"),
                },
            )


def scan(events, config=None) -> List[Dict[str, Any]]:
    """Run the diagnosis folds over a RECORDED stream (a list of
    event dicts — loaded JSONL, blackbox merge) and return the
    diagnoses.  Rate-window rules degrade gracefully: the fold clock
    is the scan's own, so bursts collapse into the window and still
    fire."""
    eng = DiagnosisEngine(config=config, events=None)
    eng.tuning.cooldown_s = 0.0  # offline: report every distinct subject
    for ev in events:
        eng.observe(ev)
    return eng.diagnoses()
