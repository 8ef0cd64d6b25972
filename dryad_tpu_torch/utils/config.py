"""Per-context configuration: the subset of ``dryad_tpu/utils/config.py``
that the ported path reads.

Field names, defaults and environment overrides match the reference, so
a configuration means the same thing to both packages.  Fields of the
reference that no ported module reads yet are absent on purpose.
"""

from __future__ import annotations

import dataclasses
import os


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
    - ``shuffle_slack`` / ``max_shuffle_retries``: exchange capacity
      slack and retry budget (validated here; the exchange itself is
      not ported yet).
    - ``topk_limit``: order_by + take(n) fuses to top-k for n at or
      below this.
    - ``device_cache_bytes``: budget of the device-resident ingest
      cache; 0 turns it off.
    """

    shuffle_slack: float = _env_float("DRYAD_TPU_SHUFFLE_SLACK", 2.0)
    max_shuffle_retries: int = 3
    topk_limit: int = _env_int("DRYAD_TPU_TOPK_LIMIT", 1024)
    auto_dense_strings: bool = True
    auto_dense_ints: bool = True
    auto_dense_limit: int = _env_int("DRYAD_TPU_AUTO_DENSE_LIMIT", 1 << 17)
    stringcode_runtime_tables: bool = _env_bool(
        "DRYAD_TPU_STRINGCODE_RUNTIME_TABLES", True
    )
    device_cache_bytes: int = _env_int(
        "DRYAD_TPU_DEVICE_CACHE", 2 * 1024 * 1024 * 1024
    )

    def validate(self) -> None:
        if self.shuffle_slack < 1.0:
            raise ValueError("shuffle_slack must be >= 1.0")
        if self.max_shuffle_retries < 0:
            raise ValueError("max_shuffle_retries must be >= 0")
        if self.device_cache_bytes < 0:
            raise ValueError("device_cache_bytes must be >= 0")
