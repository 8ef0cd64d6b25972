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
    - ``obs_events_mem_cap``: ring cap of the event log's in-memory
      mirror; 0 = unbounded (the file keeps the full stream).
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
    obs_events_mem_cap: int = _env_int("DRYAD_TPU_OBS_EVENTS_MEM_CAP", 1 << 16)

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
