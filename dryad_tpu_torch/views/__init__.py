"""Materialized views — incremental maintenance of registered queries.

The serving tier's write side: a registered aggregation becomes a
resident view holding UN-finalized partial state; appends fold in as
deltas through the same state algebra the streaming combine path uses
(``exec.partial``), and reads finalize a bounded-staleness snapshot
instead of recomputing the plan.  This package builds plans and folds
host state only — execution stays with the serve driver.  A copy of
``dryad_tpu/views/``.
"""

from dryad_tpu_torch.views.matview import (
    MaterializedView,
    ViewIneligible,
    ViewRegistry,
    finalize_query,
)

__all__ = [
    "MaterializedView",
    "ViewIneligible",
    "ViewRegistry",
    "finalize_query",
]
