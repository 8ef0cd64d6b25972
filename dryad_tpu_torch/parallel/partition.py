"""The partition layer: P logical partitions on one device.

The counterpart of ``dryad_tpu/parallel/{mesh,distribute,stage}.py``.
The reference runs one partition per device under ``shard_map``; the
port keeps all P partitions on one GPU as the leading axis of every
``(P, cap)`` tensor, so the collectives the ported stage ops use become
tensor operations on that axis:

=================================  =====================================
reference collective               here
=================================  =====================================
``psum_scatter(tiled=True)``       ``x.sum(0)`` then ``reshape(P, per)``
``all_gather(tiled=True)``         ``reshape(1, P * n)`` on every row
``axis_index``                     ``arange(P)``
=================================  =====================================

Multi-GPU ``torch.distributed`` comes later behind the same functions.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def block_layout(
    phys: Dict[str, np.ndarray],
    P: int,
    partition_capacity: Optional[int] = None,
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Block-partition encoded physical columns on the host.

    Partition p holds rows ``[p*per, (p+1)*per)`` with
    ``per = ceil(n / P)`` (``cap = per`` unless given), exactly as
    ``dryad_tpu/parallel/distribute.py::from_physical_table``, so the
    partition-major order equals the original row order.  Returns
    ``(P, cap)`` host arrays and the ``(P, cap)`` valid mask."""
    names = list(phys.keys())
    n = len(np.asarray(phys[names[0]])) if names else 0
    per = -(-n // P) if n else 1
    cap = partition_capacity if partition_capacity is not None else per
    if cap < per:
        raise ValueError(f"partition_capacity {cap} < required {per}")
    sizes = [min((p + 1) * per, n) - min(p * per, n) for p in range(P)]
    data = {}
    for c in names:
        a = np.asarray(phys[c])
        if cap == per and n == P * per:
            data[c] = a.reshape(P, cap)  # exact fit: a view, no copy
            continue
        pad = np.zeros((P, cap) + a.shape[1:], a.dtype)
        for p, m in enumerate(sizes):
            lo = min(p * per, n)
            pad[p, :m] = a[lo : lo + m]
        data[c] = pad
    valid = np.zeros((P, cap), np.bool_)
    for p, m in enumerate(sizes):
        valid[p, :m] = True
    return data, valid


def psum_scatter(x: torch.Tensor) -> torch.Tensor:
    """``(P, P*per)`` per-partition tables -> ``(P, per)``: the sum over
    partitions, partition i keeping slice ``[i*per, (i+1)*per)``."""
    P = x.shape[0]
    return x.sum(0, dtype=x.dtype).reshape(P, -1)


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """``(P, n)`` -> ``(P, P*n)``: every partition sees all P blocks in
    partition order (a broadcast view, no copy)."""
    P = x.shape[0]
    return x.reshape(1, -1).expand(P, -1)


def axis_index(P: int, device) -> torch.Tensor:
    """Each partition's index, as a ``(P, 1)`` column."""
    return torch.arange(P, device=device).reshape(P, 1)
