"""Carry the JAX package's host state into the port, without importing it.

The reference's state is handed over as numpy arrays and plain Python
objects (what ``dryad_tpu`` objects expose), so the tests can feed both
packages identical dictionaries, code assignments and partition
layouts:

- :func:`dictionary_from_items`: a ``StringDictionary`` from
  ``(hash, string)`` items (``StringDictionary.items()``);
- :func:`code_table_from_slots` / :func:`decode_table_from_words`: coding
  tables from the reference's slot arrays and decode words;
- :func:`batch_from_physical`: a ``(P, cap)`` ``ColumnBatch`` from the
  reference's flat ``(P * cap)`` physical columns and valid mask.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from dryad_tpu_torch.columnar.batch import ColumnBatch
from dryad_tpu_torch.columnar.schema import StringDictionary
from dryad_tpu_torch.ops.stringcode import CodeTable, DecodeTable


def dictionary_from_items(items: Iterable[Tuple[int, str]]) -> StringDictionary:
    """A dictionary holding the same entries in the same insertion order
    (insertion order is code order).  Each hash is checked against its
    string."""
    d = StringDictionary()
    for h, s in items:
        if d.add(s) != int(h):
            raise ValueError(f"hash {int(h):#x} does not match {s!r}")
    return d


def code_table_from_slots(
    slots_h0: np.ndarray, slots_h1: np.ndarray, slots_code: np.ndarray
) -> CodeTable:
    """The CodeTable whose build yields exactly these slot arrays: the
    (h0, h1) pairs in code order are rebuilt into a table, which must
    reproduce the given slots (else the reference built them by other
    rules and this raises)."""
    code = np.asarray(slots_code, np.int32)
    used = np.nonzero(code >= 0)[0]
    order = used[np.argsort(code[used], kind="stable")]
    if not np.array_equal(code[order], np.arange(len(order))):
        raise ValueError("slot codes are not a dense 0..K-1 assignment")
    pairs = np.stack(
        [np.asarray(slots_h0, np.uint32)[order], np.asarray(slots_h1, np.uint32)[order]],
        axis=1,
    ) if len(order) else np.zeros((0, 2), np.uint32)
    table = CodeTable(pairs)
    if not (
        np.array_equal(table.slots_h0, slots_h0)
        and np.array_equal(table.slots_h1, slots_h1)
        and np.array_equal(table.slots_code, code)
    ):
        raise ValueError("rebuilt code table differs from the given slots")
    return table


def decode_table_from_words(words: np.ndarray) -> DecodeTable:
    """DecodeTable from ``(K, 4)`` uint32 words in code order."""
    return DecodeTable(np.asarray(words, np.uint32))


def batch_from_physical(
    phys: Dict[str, np.ndarray], valid: np.ndarray, num_partitions: int, device
) -> ColumnBatch:
    """The reference's flat partition-major ``(P * cap)`` layout as a
    ``(P, cap)`` batch on ``device`` (row placement unchanged)."""
    valid = np.asarray(valid, np.bool_)
    if valid.size % num_partitions:
        raise ValueError(f"{valid.size} rows do not split into {num_partitions} partitions")
    shape = (num_partitions, valid.size // num_partitions)
    data = {c: np.asarray(v).reshape(shape) for c, v in phys.items()}
    return ColumnBatch.from_host_layout(data, valid.reshape(shape), torch.device(device))
