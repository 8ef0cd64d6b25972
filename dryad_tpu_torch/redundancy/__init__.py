"""Coded stage redundancy: k-of-n reconstruction of partial aggregates.

The duplicate-on-straggle model (``cluster.localjob.submit_partitioned``
+ ``exec.stats``) reacts to a straggler by racing a full copy of the
SPECIFIC slow vertex — it must first identify which vertex is slow
(a robust duration model needing several completed samples), and every
spare duplicates one vertex of work that is thrown away when the
original wins.

For stages whose partial aggregates combine LINEARLY (sum / count /
histogram-style ``Decomposable`` states — PAPERS.md "Leveraging Coding
Techniques for Speeding up Distributed Computing", with the
decomposition discipline of "Partial Partial Aggregates"), there is a
strictly stronger tool: encode the k per-partition partials as n = k+r
CODED vertices through a systematic MDS generator matrix.  ANY k
completions reconstruct the stage output exactly, so

- no straggler needs to be *identified* — the spares cover whichever
  r vertices are slow (the spare trigger can therefore be a coarse
  floor threshold instead of a converged outlier model);
- a vertex killed mid-stage needs NO re-execution — the stage completes
  from the surviving k of n and reconstruction recovers its
  contribution bit-exactly for integer accumulators.

Modules:

- :mod:`coding` — the generator matrix (identity over the k data
  shards + r integer scaled-Cauchy parity rows; every k-row subset is
  invertible) and the :class:`CodedSpec` task layout;
- :mod:`reconstruct` — solve the linear system for any k completed
  coded partials: exact rational arithmetic for integer state columns,
  amplification-checked float64 for float states;
- :mod:`policy` — the per-stage eligibility decision: only combiners
  whose merge is elementwise addition qualify (builtin sum/count/mean
  partials, or ``Decomposable(linear=True, identity={...: 0})``);
  everything else keeps the duplicate/retry path.

Layering: this package sits below ``cluster`` (which drives it) and
above ``exec.partial`` / ``columnar``; it must never import the
streaming engine (``exec.outofcore``) — enforced by
``tests/test_coded_lint.py``.
"""

from dryad_tpu_torch.redundancy.coding import CodedSpec, generator_rows
from dryad_tpu_torch.redundancy.policy import CodedDecision, decide
from dryad_tpu_torch.redundancy.reconstruct import (
    CodedReconstructionError,
    merge_coded,
    reconstruct_partials,
    solve_merge_weights,
)

__all__ = [
    "CodedSpec",
    "generator_rows",
    "CodedDecision",
    "decide",
    "CodedReconstructionError",
    "merge_coded",
    "reconstruct_partials",
    "solve_merge_weights",
]
