"""Host <-> mesh data movement for ColumnBatches.

The counterpart of ``dryad_tpu/parallel/distribute.py``: the ingest and
egress edge.  A global host table becomes one ``(local, cap)`` batch on
this rank's device: every rank lays out the whole ``(P, cap)`` block on
the host (``parallel/partition.py::block_layout``) and uploads only its
own ``local`` rows, as each JAX process places only its addressable
shards of a ``NamedSharding``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from dryad_tpu_torch.columnar.batch import ColumnBatch
from dryad_tpu_torch.columnar.schema import Schema, StringDictionary
from dryad_tpu_torch.parallel.mesh import PartitionMesh
from dryad_tpu_torch.parallel.partition import block_layout


def own_rows(mesh: PartitionMesh) -> slice:
    """The rows of the ``(P, cap)`` layout this rank uploads."""
    return slice(mesh.base, mesh.base + mesh.local)


def from_physical_table(
    phys: Dict[str, np.ndarray],
    mesh: PartitionMesh,
    partition_capacity: Optional[int] = None,
) -> ColumnBatch:
    """Block-partition already-encoded physical columns (no hashing):
    partition p holds contiguous rows ``[p*per, (p+1)*per)``, so the
    partition-major global order equals the original row order."""
    data, valid = block_layout(phys, mesh.P, partition_capacity, own_rows(mesh))
    return ColumnBatch.from_host_layout(data, valid, mesh.device)


def from_host_table(
    schema: Schema,
    arrays: Dict[str, np.ndarray],
    mesh: PartitionMesh,
    partition_capacity: Optional[int] = None,
    dictionary: Optional[StringDictionary] = None,
) -> ColumnBatch:
    """Encode host logical columns and block-partition them into P
    partitions of equal static capacity, this rank's rows on its
    device (``DryadLinqContext.cs:1176-1223``)."""
    return ColumnBatch.from_numpy(
        schema, arrays, mesh.P, mesh.device, partition_capacity=partition_capacity,
        dictionary=dictionary, rows=own_rows(mesh),
    )


def to_host_table(
    batch: ColumnBatch,
    schema: Schema,
    dictionary: Optional[StringDictionary] = None,
) -> Dict[str, np.ndarray]:
    """This rank's partitions of a batch as host logical columns."""
    return batch.to_numpy(schema, dictionary)
