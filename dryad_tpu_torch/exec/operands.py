"""Device copies of the string coding tables, uploaded once per context.

The counterpart of ``dryad_tpu/exec/operands.py`` only as far as the
ported path needs it: the reference's pool feeds tables to compiled
programs as call-time operands and scatters widening deltas; PyTorch
runs eagerly, so here a table's arrays simply become device tensors the
first time a stage needs them and stay, keyed by the table's content
digest, for the life of the context.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from dryad_tpu_torch.columnar.batch import to_device_column


class DeviceTables:
    """Content-addressed cache: table digest -> device tensors."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._tables: Dict[str, Tuple[torch.Tensor, ...]] = {}
        self.uploads = 0

    def get(self, table: Any) -> Tuple[torch.Tensor, ...]:
        """Device tensors of a ``CodeTable``/``DecodeTable``'s
        ``operand_arrays()`` (uint32 words as int64)."""
        sha = table.operand_sha()
        hit = self._tables.get(sha)
        if hit is None:
            hit = tuple(
                to_device_column(a, self.device) for a in table.operand_arrays()
            )
            self._tables[sha] = hit
            self.uploads += 1
        return hit
