"""Minimal stage executor of the ported path.

The counterpart of ``dryad_tpu/exec/executor.py`` reduced to what the
ported stages need: run the stages in order, feed each its inputs, and
after the job read the deferred counters in ONE device->host copy —
the dictionary/range-miss count (a nonzero count raises, as the
reference's ``_raise_miss``) and the exchange overflow flag (which no
op of this slice sets; the boost/retry loop arrives with the exchange).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from dryad_tpu_torch.columnar.batch import ColumnBatch
from dryad_tpu_torch.exec.kernels import StageContext, apply_op
from dryad_tpu_torch.exec.operands import DeviceTables
from dryad_tpu_torch.plan.lower import StageGraph


class StageFailedError(RuntimeError):
    """A stage reached a terminal failure (budget, capacity, guard)."""


def _miss_message(name: str, m: int) -> str:
    return (
        f"stage {name!r}: {m} rows fall outside the dense "
        "path's key domain (STRING values missing from the "
        "context dictionary, or INT32 keys past their "
        "ingest-time range — fabricated at run time?); the "
        "dense kernel would drop them. Register/ingest the "
        "values, or use group_by(salt=) to force the sort "
        "path."
    )


class GraphExecutor:
    def __init__(self, P: int, config, device):
        self.P = P
        self.config = config
        self.device = torch.device(device)
        self.tables = DeviceTables(self.device)

    def execute(
        self, graph: StageGraph, bindings: Dict[int, ColumnBatch]
    ) -> Dict[Tuple[int, int], ColumnBatch]:
        results: Dict[Tuple[int, int], ColumnBatch] = {}
        pending = []  # (stage name, miss counter, overflow flag)
        for stage in graph.stages:
            ins = tuple(
                bindings[idx] if ref == "plan_input" else results[(ref, idx)]
                for ref, idx in stage.input_refs
            )
            ctx = StageContext(self.P, self.device, self.tables)
            ctx.bind_inputs(ins)
            for op in stage.ops:
                apply_op(ctx, op.kind, op.params)
            for i, slot in enumerate(stage.out_slots):
                results[(stage.id, i)] = ctx.slots[slot]
            pending.append((stage.name, ctx.dict_miss, ctx.overflow))
        if pending:
            flags = torch.stack(
                [torch.stack([m, o.to(m.dtype)]) for _, m, o in pending]
            ).cpu()
            for (name, _, _), (miss, ovf) in zip(pending, flags.tolist()):
                if miss:
                    raise StageFailedError(_miss_message(name, int(miss)))
                if ovf:
                    raise StageFailedError(
                        f"stage {name!r}: exchange overflow (the retry loop "
                        "is not ported yet)"
                    )
        return results
