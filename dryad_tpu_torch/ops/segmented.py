"""Aggregation specs shared by the planner and the stage ops.

Only ``AggSpec`` of ``dryad_tpu/ops/segmented.py`` is ported so far; the
sort-based ``group_reduce`` / ``group_combine`` / ``distinct`` follow
with the exchange (ROADMAP.md, queue 1 item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One built-in aggregation over a physical column.

    op: sum | count | min | max | mean | any | all | first
    col: input physical column (None for count)
    out: output physical column name
    """

    op: str
    col: Optional[str]
    out: str
