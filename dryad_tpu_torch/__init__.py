"""dryad_tpu_torch — the PyTorch/CUDA port of dryad_tpu.

A second package beside the JAX reference, with the same subpackage
layout so every ported module has its reference at the same path under
``dryad_tpu/``.  It imports ``torch`` and numpy and never ``jax`` or
``dryad_tpu``.  Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""

from dryad_tpu_torch.api.decomposable import Decomposable
from dryad_tpu_torch.api.context import DryadContext
from dryad_tpu_torch.api.query import Query
from dryad_tpu_torch.columnar.schema import ColumnType, Schema
from dryad_tpu_torch.utils.config import DryadConfig

__all__ = ["DryadContext", "DryadConfig", "Decomposable", "Query", "Schema", "ColumnType"]
