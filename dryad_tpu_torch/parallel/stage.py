"""Stage programs over a mesh: where replicated outputs meet.

The counterpart of ``dryad_tpu/parallel/stage.py``.  The reference
traces one per-partition function per stage and ``shard_map``s it over
the mesh; its replicated outputs (the overflow flag, the dictionary-miss
count) are reduced across the mesh inside the program
(``dryad_tpu/exec/kernels.py:1181-1185``), so every device reads the
same values.  The port runs a unit's ops on a rank's ``(local, cap)``
tensors, as one stage program (``exec/programs.py``) built through
:func:`compile_stage` (a lone stage) or :func:`compile_fused` (a run of
stages), and this module is the one place where a unit's replicated
outputs are reduced across the process group: the overflow OR, the miss
sum and the row counts the executor reads.  Every
rank then takes the same retry, boost and failure decision; no stage op
reads a flag that only one rank has.  In one process both functions
hand their inputs back unchanged.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Sequence, Tuple

import torch

from dryad_tpu_torch.parallel.partition import allreduce


def reduce_replicated(
    mesh, overflow: torch.Tensor, miss: torch.Tensor, counts: Sequence[torch.Tensor] = ()
) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """``(overflow, miss, counts)`` summed over the group in one
    ``all_reduce`` (the flag as an OR: a sum above 0)."""
    if mesh is None or mesh.group is None:
        return overflow, miss, list(counts)
    vec = torch.stack(
        [overflow.to(torch.int64), miss.to(torch.int64)] + [c.to(torch.int64) for c in counts]
    )
    vec = allreduce(vec, "sum", mesh)
    return vec[0] > 0, vec[1], list(vec[2:])


class GangStageError(RuntimeError):
    """A stage of a gang failed on this rank, its collective included (a
    peer that never arrived, a peer that died): the message names the
    stage and the rank."""


@contextlib.contextmanager
def named_failures(mesh, name: str):
    """Over a process group, a ``RuntimeError`` raised inside (a
    collective's timeout or a peer's closed connection among them)
    becomes a :class:`GangStageError` naming stage ``name``: a gang
    that diverged ends in an error that says where, never a hang.  The
    engine's own errors pass unchanged."""
    try:
        yield
    except RuntimeError as e:
        # the engine's own errors (retry budgets, overflow) name their stage
        if mesh is None or mesh.group is None or type(e).__module__.startswith("dryad_tpu_torch"):
            raise
        raise GangStageError(
            f"stage {name!r} failed on rank {mesh.rank} of {mesh.world}: {e}"
        ) from e


def compile_stage(mesh, fn: Callable[..., Tuple[Any, ...]]):
    """A stage function ``fn(*args) -> (out, overflow[, miss[,
    counts]])`` whose replicated outputs come back reduced over the
    mesh's group in one ``all_reduce`` (the executor's unit programs
    return their exports' row counts too; a loop stage returns none)."""
    if mesh is None or mesh.group is None:
        return fn

    def run(*args):
        out, ovf, *rest = fn(*args)
        miss = rest[0] if rest else torch.zeros((), dtype=torch.int64, device=ovf.device)
        ovf, m, counts = reduce_replicated(mesh, ovf, miss, rest[1] if len(rest) > 1 else ())
        return (out, ovf) + ((m,) if rest else ()) + ((counts,) if len(rest) > 1 else ())

    return run


def compile_fused(mesh, fn: Callable[..., Tuple[Any, ...]]):
    """A fused region's function, with the same calling convention as a
    single stage's (the reference compiles it the same way); the
    executor builds every run of stages through it."""
    return compile_stage(mesh, fn)
