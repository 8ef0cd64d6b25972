"""Logical plan nodes (a copy of ``dryad_tpu/plan/nodes.py``).

The analog of the reference's physical query-node graph
(``LinqToDryad/DryadLinqQueryNode.cs:837-4794`` — Input/Where/Select/
OrderBy/GroupBy/PartitionOp/Join/Distinct/BasicAggregate/Concat/
SetOperation/HashPartition/RangePartition/Super/Apply/Fork/DoWhile/Tee)
plus the partition-metadata bookkeeping (DataSetInfo) that lets the
optimizer elide redundant shuffles (Assume*Partition operators,
``DryadLinqQueryable.cs:3408-3678``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from dryad_tpu_torch.columnar.schema import Schema

_ids = itertools.count()


def fresh_id() -> int:
    """Next node id from THIS process's counter.  Ids are process-local:
    a DAG deserialized from another process (job packages) must be
    re-keyed through this before it can coexist with locally built
    nodes — ``walk``/``consumers``/lowering all dedup by id, so a
    collision silently drops a node (see ``jobpackage.load_query``)."""
    return next(_ids)


@dataclasses.dataclass(frozen=True)
class PartitionInfo:
    """How the dataset is partitioned across the mesh (DataSetInfo analog).

    scheme: 'roundrobin' | 'hash' | 'range' | 'any'
    keys:   logical column names the scheme applies to
    range_by: the (name, descending) chain partitions are range-ordered
    by (direction matters: ascending vs descending ranges differ).
    ordered_by: (name, descending) chain if each partition is ALSO
    locally sorted (set by order_by, not by bare range_partition).
    spread: True when the range exchange used skew-spread splitters
    (order_by): global ORDER holds but equal keys may straddle a
    partition boundary, so consumers needing equal-key COLOCATION
    (range_partition elision) must re-exchange.
    """

    scheme: str = "any"
    keys: Tuple[str, ...] = ()
    range_by: Tuple[Tuple[str, bool], ...] = ()
    ordered_by: Tuple[Tuple[str, bool], ...] = ()
    spread: bool = False

    @staticmethod
    def roundrobin() -> "PartitionInfo":
        return PartitionInfo("roundrobin")

    @staticmethod
    def hashed(keys: Sequence[str]) -> "PartitionInfo":
        return PartitionInfo("hash", tuple(keys))

    @staticmethod
    def ranged(
        range_by: Sequence[Tuple[str, bool]],
        ordered: Sequence[Tuple[str, bool]] = (),
        spread: bool = False,
    ) -> "PartitionInfo":
        return PartitionInfo(
            "range",
            tuple(n for n, _ in range_by),
            tuple((n, bool(d)) for n, d in range_by),
            tuple(ordered),
            spread,
        )


class Node:
    """One logical operator. Immutable once built; forms a DAG."""

    def __init__(
        self,
        kind: str,
        inputs: Sequence["Node"],
        schema: Schema,
        partition: PartitionInfo,
        **params: Any,
    ):
        self.id = next(_ids)
        self.kind = kind
        self.inputs = list(inputs)
        self.schema = schema
        self.partition = partition
        self.params: Dict[str, Any] = params

    def __repr__(self) -> str:
        return f"Node#{self.id}({self.kind})"


# Node kinds (params in parentheses):
#   input         (name, arrays | batch_ref, capacity)
#   select        (fn, )                     row-wise projection/map
#   where         (fn, )                     predicate -> mask
#   select_many   (fn, factor)               flat-map with static expansion
#   group_by      (keys, aggs | decomposable)
#   join          (left=inputs[0], right=inputs[1], left_keys, right_keys,
#                  kind='inner'|'semi'|'anti', expansion)
#   order_by      (keys=[(name, desc)], )
#   distinct      (keys, )
#   concat        (inputs*, )
#   hash_partition(keys, )                   explicit repartition
#   range_partition(keys, )                  explicit repartition
#   assume_partition(info, )                 metadata-only hint
#   apply         (fn, out_schema, cap_factor, with_index: bool)
#   fork          (fn, out_schemas)          multi-output apply
#   fork_branch   (index, )                  selects one fork output
#   do_while      (body, cond, max_iter)     driver-loop iteration
#   take          (n, )
#   aggregate     (aggs, )                   whole-table scalar aggregates
#   tee           ()                         explicit materialization point


def walk(roots: Sequence[Node]) -> List[Node]:
    """Topological order (inputs before consumers) over the DAG."""
    seen: Dict[int, Node] = {}
    order: List[Node] = []

    def visit(n: Node) -> None:
        if n.id in seen:
            return
        seen[n.id] = n
        for i in n.inputs:
            visit(i)
        order.append(n)

    for r in roots:
        visit(r)
    return order


def consumers(roots: Sequence[Node]) -> Dict[int, int]:
    """Node id -> number of consumers in the DAG (for Tee insertion)."""
    count: Dict[int, int] = {}
    for n in walk(roots):
        for i in n.inputs:
            count[i.id] = count.get(i.id, 0) + 1
    return count
