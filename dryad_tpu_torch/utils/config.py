"""Per-context configuration: the subset of ``dryad_tpu/utils/config.py``
that the ported path reads.

Field names, defaults and environment overrides match the reference, so
a configuration means the same thing to both packages.  Fields of the
reference that no ported module reads yet are absent on purpose.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v not in (None, "") else default


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v in (None, ""):
        return default
    return v.lower() in ("1", "true", "yes", "on")


class StaticConfig:
    """Process-wide defaults read once at import (the reference's
    ``StaticConfig``, reduced to what the port reads)."""

    logging_level: str = os.environ.get("DRYAD_TPU_LOGGING_LEVEL", "INFO")


@dataclasses.dataclass
class DryadConfig:
    """Context knobs of the ported path (see the reference for history).

    - ``auto_dense_strings``: a single-STRING-key group_by with
      sum/count/mean aggregates lowers to the dense bucket path keyed on
      dictionary codes.
    - ``auto_dense_ints``: a group_by over one INT32 key whose ingest
      range is [0, K), K <= ``auto_dense_limit``, rides the same path
      with a range-miss guard.
    - ``stringcode_runtime_tables``: the dense domain of the STRING
      rewrite is the code table's power-of-two tier, not K itself.
    - ``shuffle_slack`` / ``max_shuffle_retries``: exchange bucket
      slack over the uniform expectation, and the number of overflow
      retries (each doubles the boost) before a stage fails.
    - ``sample_rate``: range-exchange sampler rate (0.1%), clamped to
      16-512 samples a partition, both scaled by the boost.
    - ``tail_fanout_rows`` / ``tail_rows_per_partition``: an exchange
      whose input holds at most ``tail_fanout_rows`` rows (statically,
      or as observed at run time) concentrates them onto
      ``ceil(rows / tail_rows_per_partition)`` partitions; 0 disables.
    - ``topk_limit``: order_by + take(n) fuses to top-k for n at or
      below this.
    - ``broadcast_limit``: a join with ``strategy="auto"`` replicates
      its right side to every partition when the right side's static
      row bound (or, without one, its total capacity) is at or below
      this; otherwise both sides are co-hash-partitioned.
    - ``device_cache_bytes``: budget of the device-resident ingest
      cache; 0 turns it off.  A table pinned by ``Query.cache()`` is
      not an entry of it.
    - ``overflow_sync_depth``: units (stages or runs of stages)
      dispatched before their overflow flags are read in one batched
      copy (the speculative dispatch window); 1 reads each at once.
    - ``intermediate_compression``: the column codec of stores written
      by ``to_store`` (None or "zlib").
    - ``event_log_dir``: directory of the context's JSONL event log
      (one ``job-<ms>.jsonl`` file per context); None keeps the log in
      memory only.
    - ``profile_dir``: torch.profiler output directory (one Chrome
      trace per top-level job, CUDA activity included on the card;
      each stage attempt a ``record_function`` range named after the
      stage); None disables.
    - ``obs_events_mem_cap``: ring cap of the event log's in-memory
      mirror; 0 = unbounded (the file keeps the full stream).
    - Out-of-core streaming (``exec/outofcore.py``):
      ``stream_bucket_rows`` is the most rows a phase-2 bucket job may
      hold before it re-splits from observed volume,
      ``stream_combine_rows`` the partial accumulator's compaction
      threshold, ``stream_buckets`` the phase-1 spill fan-out and
      ``stream_spill_dir`` the spill root (None: a fresh temporary
      directory).  ``stream_pipeline_depth`` chunks may be in flight
      (prefetch thread, background spill writer and device-resident
      partials; 1 is the serial driver) and ``stream_writer_queue``
      pieces may wait for the spill writer.
    - Combine tree (``exec/combinetree.py``): ``combine_tree`` routes a
      streaming group_by's partials into similarity-placed groups whose
      merges elide the exchange (off: the flat N-ary combiner);
      ``combine_tree_fan`` caps one merge's fan-in,
      ``combine_tree_ranges`` is the key-range histograms' resolution (a
      power of two), ``combine_tree_groups`` the level-0 group count (0:
      auto) and ``combine_tree_degrade_ratio`` the distinct/rows ratio at
      which a key range degrades to host accumulation.
      ``stream_host_reprobe``: consecutive reducing host combines after
      which the flat combiner retries the device (0: never).
    - ``dispatch_depth``: chunk and bucket jobs in flight behind the
      dispatch window's collector thread (1: dispatch then read; -1:
      adaptive: the measured headroom's tier, 2 without a measurement);
      ``chunk_fuse``: chunk plans lowered together into one job.
    - Stage checkpoints (``exec/checkpoint.py``): ``checkpoint_dir``
      holds each stage's output keyed by its content fingerprint (None
      disables); ``checkpoint_retain_seconds`` is the retention lease
      (None keeps them).
    - Flight recorder (``obs/flightrec.py``): ``obs_flight_recorder``
      taps the event log into a bounded ring of ``flightrec_events``
      events with health snapshots every ``flightrec_snapshot_s``,
      dumped under ``flightrec_dir`` (None: ``event_log_dir`` or the
      working directory) when a job fails.
    - Serving (``serve/``): ``serve_max_inflight`` and
      ``serve_max_bytes`` are each tenant's admission budgets (queries
      admitted and unresolved, their summed host-input bytes; 0: no
      byte budget); ``serve_result_cache_bytes`` the result cache's
      budget (0 disables); ``serve_drr_quantum_bytes`` the input bytes
      per fair-share cost unit; ``serve_cache_admission`` ("cost" or
      "all") and ``serve_cache_min_sec_per_gb`` the cache's admission
      rule.  ``telemetry_window_s`` is the rolling window of the SLO
      store; ``query_trace`` stamps each query's events with its
      ``qid`` (``obs/tracectx.py``).
    - Fault tolerance (``exec/failure.py``, ``exec/faults.py``):
      ``max_stage_failures`` is a stage's attempt budget; transient
      failures wait ``retry_backoff_base * 2^(failures-1)`` seconds
      (capped at ``retry_backoff_max``) times ``1 + retry_jitter *
      U(0,1)``, drawn from ``retry_seed``.  ``outlier_sigmas`` and
      ``straggler_floor_ratio`` shape the straggler model
      (``exec/stats.py``).
    - Vertex tasks (``cluster/localjob.py``): ``rows_per_vertex`` sizes
      an unpinned ``submit_partitioned`` fan-out;
      ``coded_redundancy``, ``coded_parity_tasks`` and
      ``coded_max_amplification`` drive the coded k-of-n path
      (``redundancy/``); ``gang_combine_tree`` folds each worker's won
      partials worker-side (level -1), with a
      ``gang_partition_cache_bytes`` cache of the parts it wrote.
    - Diagnosis (``obs/diagnose.py``): ``obs_diagnosis`` turns the
      online rules on; ``diagnose_skew_ratio``,
      ``diagnose_recompile_burst`` and ``diagnose_cooldown_s`` are
      their triggers.
    - Continuous telemetry (``obs/telemetry.py``): ``obs_telemetry``
      turns on the resource sampler and its measured headroom (the
      ``dispatch_depth=-1`` tiers and the ``hbm_pressure`` rule read
      it; off: the default depth); ``telemetry_sample_s`` is the least
      time between two samples.
    - Runtime plan rewriting (``rewrite/``): ``plan_rewrite`` turns on
      the diagnosis-driven, byte-identity-preserving rewriter; the
      controller taps the event stream, folds ``diagnosis`` events into
      ``RewriteAction`` objects, and the drivers apply them at chunk and
      dispatch boundaries.  It needs ``obs_diagnosis``.
    """

    shuffle_slack: float = _env_float("DRYAD_TPU_SHUFFLE_SLACK", 2.0)
    max_shuffle_retries: int = 3
    sample_rate: float = 0.001
    tail_fanout_rows: int = _env_int("DRYAD_TPU_TAIL_FANOUT_ROWS", 4096)
    tail_rows_per_partition: int = _env_int(
        "DRYAD_TPU_TAIL_ROWS_PER_PARTITION", 512
    )
    topk_limit: int = _env_int("DRYAD_TPU_TOPK_LIMIT", 1024)
    broadcast_limit: int = _env_int("DRYAD_TPU_BROADCAST_LIMIT", 1 << 16)
    auto_dense_strings: bool = True
    auto_dense_ints: bool = True
    auto_dense_limit: int = _env_int("DRYAD_TPU_AUTO_DENSE_LIMIT", 1 << 17)
    stringcode_runtime_tables: bool = _env_bool(
        "DRYAD_TPU_STRINGCODE_RUNTIME_TABLES", True
    )
    device_cache_bytes: int = _env_int(
        "DRYAD_TPU_DEVICE_CACHE", 2 * 1024 * 1024 * 1024
    )
    overflow_sync_depth: int = _env_int("DRYAD_TPU_OVERFLOW_SYNC_DEPTH", 4)
    intermediate_compression: Optional[str] = None  # None | "zlib"
    event_log_dir: Optional[str] = None
    profile_dir: Optional[str] = None
    obs_events_mem_cap: int = _env_int("DRYAD_TPU_OBS_EVENTS_MEM_CAP", 1 << 16)
    stream_bucket_rows: int = _env_int("DRYAD_TPU_STREAM_BUCKET_ROWS", 1 << 21)
    stream_combine_rows: int = _env_int("DRYAD_TPU_STREAM_COMBINE_ROWS", 1 << 20)
    stream_buckets: int = _env_int("DRYAD_TPU_STREAM_BUCKETS", 32)
    stream_spill_dir: Optional[str] = os.environ.get("DRYAD_TPU_STREAM_SPILL_DIR") or None
    stream_pipeline_depth: int = _env_int("DRYAD_TPU_STREAM_PIPELINE_DEPTH", 4)
    stream_writer_queue: int = _env_int("DRYAD_TPU_STREAM_WRITER_QUEUE", 8)
    combine_tree: bool = _env_bool("DRYAD_TPU_COMBINE_TREE", True)
    combine_tree_fan: int = _env_int("DRYAD_TPU_COMBINE_TREE_FAN", 16)
    combine_tree_ranges: int = _env_int("DRYAD_TPU_COMBINE_TREE_RANGES", 64)
    combine_tree_groups: int = _env_int("DRYAD_TPU_COMBINE_TREE_GROUPS", 0)
    combine_tree_degrade_ratio: float = _env_float(
        "DRYAD_TPU_COMBINE_TREE_DEGRADE_RATIO", 0.75
    )
    stream_host_reprobe: int = _env_int("DRYAD_TPU_STREAM_HOST_REPROBE", 2)
    dispatch_depth: int = _env_int("DRYAD_TPU_DISPATCH_DEPTH", 2)
    chunk_fuse: int = _env_int("DRYAD_TPU_CHUNK_FUSE", 1)
    checkpoint_dir: Optional[str] = None
    checkpoint_retain_seconds: Optional[float] = None
    obs_flight_recorder: bool = _env_bool("DRYAD_TPU_FLIGHT_RECORDER", True)
    flightrec_events: int = _env_int("DRYAD_TPU_FLIGHTREC_EVENTS", 2048)
    flightrec_snapshot_s: float = _env_float("DRYAD_TPU_FLIGHTREC_SNAPSHOT_S", 1.0)
    flightrec_dir: Optional[str] = os.environ.get("DRYAD_TPU_FLIGHTREC_DIR") or None
    serve_max_inflight: int = _env_int("DRYAD_TPU_SERVE_MAX_INFLIGHT", 32)
    serve_max_bytes: int = _env_int("DRYAD_TPU_SERVE_MAX_BYTES", 1 << 30)
    serve_result_cache_bytes: int = _env_int(
        "DRYAD_TPU_SERVE_CACHE_BYTES", 256 * 1024 * 1024
    )
    serve_drr_quantum_bytes: int = _env_int("DRYAD_TPU_SERVE_DRR_QUANTUM", 1 << 22)
    serve_cache_admission: str = os.environ.get("DRYAD_TPU_SERVE_CACHE_ADMISSION", "cost")
    serve_cache_min_sec_per_gb: float = _env_float(
        "DRYAD_TPU_SERVE_CACHE_MIN_SEC_PER_GB", 0.5
    )
    obs_telemetry: bool = _env_bool("DRYAD_TPU_OBS_TELEMETRY", True)
    telemetry_sample_s: float = _env_float("DRYAD_TPU_TELEMETRY_SAMPLE_S", 1.0)
    telemetry_window_s: float = _env_float("DRYAD_TPU_TELEMETRY_WINDOW_S", 60.0)
    query_trace: bool = _env_bool("DRYAD_TPU_QUERY_TRACE", True)
    max_stage_failures: int = 3
    outlier_sigmas: float = 3.0
    straggler_floor_ratio: float = _env_float("DRYAD_TPU_STRAGGLER_FLOOR", 1.5)
    coded_redundancy: bool = _env_bool("DRYAD_TPU_CODED_REDUNDANCY", True)
    coded_parity_tasks: int = _env_int("DRYAD_TPU_CODED_PARITY", 2)
    coded_max_amplification: float = _env_float("DRYAD_TPU_CODED_MAX_AMP", 1e6)
    retry_backoff_base: float = _env_float("DRYAD_TPU_RETRY_BACKOFF", 0.05)
    retry_backoff_max: float = 2.0
    retry_jitter: float = 0.5
    retry_seed: int = _env_int("DRYAD_TPU_RETRY_SEED", 0)
    rows_per_vertex: int = _env_int("DRYAD_TPU_ROWS_PER_VERTEX", 1 << 18)
    obs_diagnosis: bool = _env_bool("DRYAD_TPU_OBS_DIAGNOSIS", True)
    diagnose_skew_ratio: float = _env_float("DRYAD_TPU_DIAGNOSE_SKEW_RATIO", 4.0)
    diagnose_recompile_burst: int = _env_int("DRYAD_TPU_DIAGNOSE_RECOMPILE_BURST", 4)
    diagnose_cooldown_s: float = _env_float("DRYAD_TPU_DIAGNOSE_COOLDOWN_S", 5.0)
    plan_rewrite: bool = _env_bool("DRYAD_TPU_PLAN_REWRITE", True)
    gang_combine_tree: bool = _env_bool("DRYAD_TPU_GANG_COMBINE_TREE", False)
    gang_partition_cache_bytes: int = _env_int(
        "DRYAD_TPU_GANG_PARTITION_CACHE", 64 * 1024 * 1024
    )

    def validate(self) -> None:
        if self.shuffle_slack < 1.0:
            raise ValueError("shuffle_slack must be >= 1.0")
        if self.intermediate_compression not in (None, "zlib"):
            raise ValueError("intermediate_compression must be None or 'zlib'")
        if not 0.0 < self.sample_rate <= 1.0:
            raise ValueError("sample_rate must be in (0, 1]")
        if self.max_shuffle_retries < 0:
            raise ValueError("max_shuffle_retries must be >= 0")
        if self.tail_fanout_rows < 0:
            raise ValueError("tail_fanout_rows must be >= 0")
        if self.tail_rows_per_partition < 1:
            raise ValueError("tail_rows_per_partition must be >= 1")
        if self.device_cache_bytes < 0:
            raise ValueError("device_cache_bytes must be >= 0")
        if self.overflow_sync_depth < 1:
            raise ValueError("overflow_sync_depth must be >= 1")
        if self.obs_events_mem_cap < 0:
            raise ValueError("obs_events_mem_cap must be >= 0")
        if self.stream_bucket_rows < 1:
            raise ValueError("stream_bucket_rows must be >= 1")
        if self.stream_combine_rows < 1:
            raise ValueError("stream_combine_rows must be >= 1")
        if self.stream_buckets < 2:
            raise ValueError("stream_buckets must be >= 2")
        if self.stream_pipeline_depth < 1:
            raise ValueError("stream_pipeline_depth must be >= 1")
        if self.stream_writer_queue < 1:
            raise ValueError("stream_writer_queue must be >= 1")
        if self.combine_tree_fan < 2:
            raise ValueError("combine_tree_fan must be >= 2")
        if self.combine_tree_ranges < 2 or (
            self.combine_tree_ranges & (self.combine_tree_ranges - 1)
        ):
            raise ValueError("combine_tree_ranges must be a power of two >= 2")
        if self.combine_tree_groups < 0:
            raise ValueError("combine_tree_groups must be >= 0")
        if not 0.0 < self.combine_tree_degrade_ratio <= 1.0:
            raise ValueError("combine_tree_degrade_ratio must be in (0, 1]")
        if self.stream_host_reprobe < 0:
            raise ValueError("stream_host_reprobe must be >= 0")
        if self.dispatch_depth != -1 and self.dispatch_depth < 1:
            raise ValueError(
                "dispatch_depth must be >= 1, or -1 for the adaptive "
                "headroom policy"
            )
        if self.chunk_fuse < 1:
            raise ValueError("chunk_fuse must be >= 1")
        if self.flightrec_events < 16:
            raise ValueError("flightrec_events must be >= 16")
        if self.flightrec_snapshot_s <= 0:
            raise ValueError("flightrec_snapshot_s must be > 0")
        if self.serve_max_inflight < 1:
            raise ValueError("serve_max_inflight must be >= 1")
        if self.serve_max_bytes < 0:
            raise ValueError("serve_max_bytes must be >= 0")
        if self.serve_result_cache_bytes < 0:
            raise ValueError("serve_result_cache_bytes must be >= 0")
        if self.serve_drr_quantum_bytes < 1:
            raise ValueError("serve_drr_quantum_bytes must be >= 1")
        if self.serve_cache_admission not in ("cost", "all"):
            raise ValueError(
                "serve_cache_admission must be 'cost' or 'all'"
            )
        if self.serve_cache_min_sec_per_gb < 0:
            raise ValueError("serve_cache_min_sec_per_gb must be >= 0")
        if self.telemetry_sample_s <= 0:
            raise ValueError("telemetry_sample_s must be > 0")
        if self.telemetry_window_s <= 0:
            raise ValueError("telemetry_window_s must be > 0")
        if self.max_stage_failures < 1:
            raise ValueError("max_stage_failures must be >= 1")
        if self.outlier_sigmas <= 0:
            raise ValueError("outlier_sigmas must be > 0")
        if self.straggler_floor_ratio < 1.0:
            raise ValueError("straggler_floor_ratio must be >= 1.0")
        if self.coded_parity_tasks < 1:
            raise ValueError("coded_parity_tasks must be >= 1")
        if self.coded_max_amplification <= 0:
            raise ValueError("coded_max_amplification must be > 0")
        if self.retry_backoff_base < 0:
            raise ValueError("retry_backoff_base must be >= 0")
        if self.retry_backoff_max < self.retry_backoff_base:
            raise ValueError(
                "retry_backoff_max must be >= retry_backoff_base"
            )
        if self.retry_jitter < 0:
            raise ValueError("retry_jitter must be >= 0")
        if self.rows_per_vertex < 1:
            raise ValueError("rows_per_vertex must be >= 1")
        if self.diagnose_skew_ratio < 1.0:
            raise ValueError("diagnose_skew_ratio must be >= 1.0")
        if self.diagnose_recompile_burst < 2:
            raise ValueError("diagnose_recompile_burst must be >= 2")
        if self.diagnose_cooldown_s < 0:
            raise ValueError("diagnose_cooldown_s must be >= 0")
        if self.gang_partition_cache_bytes < 0:
            raise ValueError("gang_partition_cache_bytes must be >= 0")
