"""Lowering: logical node DAG -> fused stage graph (ported subset).

The counterpart of ``dryad_tpu/plan/lower.py`` for the node kinds of the
ported path: ``input``, ``select``/``where`` (including name-only
projections), ``group_by`` on the dense bucket path (explicit
``dense=K``, int auto-dense with its range guard, and auto-dense STRING
through ``string_code``), and ``order_by`` + ``take(n)`` fused into
``topk``.  It emits the SAME ``StageOp`` kinds and params as the
reference, so a plan's op list can be held against the reference's
lowering.  Every other node kind raises ``NotImplementedError`` naming
the ROADMAP.md item that will port it.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

from dryad_tpu_torch.columnar.schema import Schema
from dryad_tpu_torch.ops.segmented import AggSpec
from dryad_tpu_torch.plan import keys as K
from dryad_tpu_torch.plan.nodes import Node, PartitionInfo, consumers, walk

_stage_ids = itertools.count()

# Where each not-yet-ported node kind lands (ROADMAP.md, "Modules to port").
_PENDING = {
    "order_by": "slice 2: TeraSort and plain order_by (exchange_range, "
                "resize, local_sort)",
    "range_partition": "slice 2: TeraSort and plain order_by (exchange_range)",
    "group_by": "queue 1 items 4-5: the hash exchange and sort-path "
                "group_reduce",
    "distinct": "queue 1 items 4-5: the hash exchange and segmented distinct",
    "hash_partition": "queue 1 item 4: the hash exchange",
}


def _pending(kind: str) -> NotImplementedError:
    where = _PENDING.get(kind, "queue 1 item 10: operator breadth")
    return NotImplementedError(
        f"dryad_tpu_torch does not lower {kind!r} yet (ROADMAP.md, {where})"
    )


@dataclasses.dataclass
class StageOp:
    kind: str
    params: Dict[str, Any]

    def __repr__(self) -> str:
        return f"{self.kind}({', '.join(sorted(self.params))})"


@dataclasses.dataclass
class Stage:
    """A fused per-partition pipeline.  ``input_refs``: (producer stage
    id, out index) pairs, or ("plan_input", node id); ops manipulate
    numbered slots; outputs are the slots in ``out_slots``."""

    id: int
    name: str
    input_refs: List[Tuple[Any, int]]
    ops: List[StageOp] = dataclasses.field(default_factory=list)
    out_slots: List[int] = dataclasses.field(default_factory=lambda: [0])


@dataclasses.dataclass
class StageGraph:
    stages: List[Stage]
    outputs: Dict[int, Tuple[int, int]]
    inputs: Dict[int, Node]


class _Builder:
    def __init__(self, config, dictionary=None) -> None:
        self.config = config
        self.dictionary = dictionary
        self.stages: List[Stage] = []
        self.open: Dict[int, Stage] = {}
        self.cursor: Dict[int, Tuple] = {}
        self.plan_inputs: Dict[int, Node] = {}
        self._vocab_cache: Dict[Tuple[int, str], Any] = {}

    def _str_vocab(self, node: Node, col: str):
        key = (node.id, col)
        if key not in self._vocab_cache:
            from dryad_tpu_torch.api.query import static_str_vocab

            self._vocab_cache[key] = static_str_vocab(node, col)
        return self._vocab_cache[key]

    # -- stage bookkeeping (as the reference) -------------------------------
    def _new_stage(self, name: str, input_refs: List[Tuple[Any, int]]) -> Stage:
        s = Stage(next(_stage_ids), name, input_refs)
        self.stages.append(s)
        self.open[s.id] = s
        return s

    def _close(self, stage: Stage, out_slots: Optional[List[int]] = None) -> None:
        if out_slots is not None:
            stage.out_slots = out_slots
        self.open.pop(stage.id, None)

    def _materialize(self, node: Node) -> Tuple[int, int]:
        kind, *rest = self.cursor[node.id]
        if kind == "closed":
            return rest[0], rest[1]
        stage, slot = rest
        self._close(stage, [slot])
        self.cursor[node.id] = ("closed", stage.id, 0)
        return stage.id, 0

    def _continue_or_start(self, node: Node, n_consumers: int) -> Tuple[Stage, int]:
        (src,) = node.inputs
        kind, *rest = self.cursor[src.id]
        if kind == "open" and n_consumers == 1:
            stage, slot = rest
            if node.kind not in stage.name.split("+"):
                stage.name = f"{stage.name}+{node.kind}"
            return stage, slot
        ref = self._materialize(src)
        stage = self._new_stage(node.kind, [ref])
        return stage, 0

    # -- node lowering -------------------------------------------------------
    def lower_node(self, node: Node, fanout: Dict[int, int]) -> None:
        n_cons = fanout.get(node.id, 1)
        k = node.kind
        if k == "input":
            self.plan_inputs[node.id] = node
            stage = self._new_stage("input", [("plan_input", node.id)])
            self.cursor[node.id] = ("open", stage, 0)
        elif k in ("select", "where"):
            stage, slot = self._continue_or_start(node, fanout.get(node.inputs[0].id, 1))
            stage.ops.append(StageOp(k, dict(slot=slot, fn=node.params["fn"])))
            self.cursor[node.id] = ("open", stage, slot)
        elif k == "topk":
            stage, slot = self._continue_or_start(node, fanout.get(node.inputs[0].id, 1))
            operands_fn = K.ordering_operands(node.inputs[0].schema, node.params["keys"])
            stage.ops.append(StageOp(
                "topk", dict(slot=slot, operands_fn=operands_fn, n=int(node.params["n"])),
            ))
            # topk shrinks the capacity: close the stage after it
            self.cursor[node.id] = ("open", stage, slot)
            self._materialize(node)
        elif k == "assume_partition":
            self.cursor[node.id] = self.cursor[node.inputs[0].id]
        elif k == "group_by":
            self._lower_group_by(node, fanout)
        else:
            raise _pending(k)
        if n_cons > 1 and self.cursor[node.id][0] == "open":
            self._materialize(node)

    def _emit_auto_dense(self, node: Node, stage, slot, key: str, aggs) -> None:
        """string_code -> dense bucket reduce with decode -> project, the
        coding tables shrunk to the key column's own vocabulary when it
        is statically known (as the reference)."""
        from dryad_tpu_torch.ops.stringcode import build_tables, build_tables_subset

        vocab = self._str_vocab(node.inputs[0], key)
        if vocab is not None and len(vocab) < len(self.dictionary):
            code_t, dec_t = build_tables_subset(self.dictionary, vocab)
        else:
            code_t, dec_t = build_tables(self.dictionary)
        runtime = bool(getattr(self.config, "stringcode_runtime_tables", True))
        num_buckets = code_t.num_codes_padded if runtime else code_t.num_codes
        stage.ops.append(StageOp(
            "string_code",
            dict(slot=slot, h0=f"{key}#h0", h1=f"{key}#h1", out="#code", table=code_t),
        ))
        stage.ops.append(StageOp(
            "group_reduce_dense",
            dict(slot=slot, key="#code", aggs=aggs, num_buckets=num_buckets,
                 decode=dec_t, out_key=key),
        ))
        want = K.group_carry_cols(node.schema, node.schema.names)
        stage.ops.append(StageOp("project", dict(slot=slot, cols=want)))
        self.cursor[node.id] = ("open", stage, slot)

    def _auto_dense_ok(self, node: Node, keys) -> bool:
        """Lowering-time re-check of the auto-dense STRING gate (the
        vocabulary may have grown since the node was built)."""
        if not node.params.get("auto_dense"):
            return False
        if self.dictionary is None or len(self.dictionary) == 0:
            return False
        limit = getattr(self.config, "auto_dense_limit", 1 << 17)
        vocab = self._str_vocab(node.inputs[0], keys[0])
        bound = len(vocab) if vocab is not None else len(self.dictionary)
        return 0 < bound <= limit

    def _phys_aggs(self, schema: Schema, aggs) -> List[AggSpec]:
        """Logical aggs -> physical AggSpecs for plain (non-split)
        columns, which is all the dense path accepts."""
        out = []
        for op, col, name in aggs:
            if col is not None and schema.field(col).ctype.is_split:
                raise _pending("group_by")
            out.append(AggSpec(op, col, name))
        return out

    def _lower_group_by(self, node: Node, fanout: Dict[int, int]) -> None:
        keys = node.params["keys"]
        dense = node.params.get("dense")
        if not dense and not self._auto_dense_ok(node, keys):
            raise _pending("group_by")
        stage, slot = self._continue_or_start(node, fanout.get(node.inputs[0].id, 1))
        in_schema = node.inputs[0].schema
        aggs = self._phys_aggs(in_schema, node.params["aggs"])
        if not dense:
            self._emit_auto_dense(node, stage, slot, keys[0], aggs)
            return
        stage.ops.append(StageOp(
            "group_reduce_dense",
            dict(slot=slot, key=K.group_carry_cols(in_schema, keys)[0], aggs=aggs,
                 num_buckets=int(dense), guard=bool(node.params.get("guard_range"))),
        ))
        want = K.group_carry_cols(node.schema, node.schema.names)
        stage.ops.append(StageOp("project", dict(slot=slot, cols=want)))
        self.cursor[node.id] = ("open", stage, slot)


def _rewrite_topk(roots: Sequence[Node], limit: int) -> List[Node]:
    """``take(n)`` over a sole-consumer ``order_by`` becomes one fused
    ``topk`` node for n <= ``limit`` (the reference's rewrite)."""
    fanout = consumers(roots)
    memo: Dict[int, Node] = {}

    def rb(node: Node) -> Node:
        if node.id in memo:
            return memo[node.id]
        new_inputs = [rb(i) for i in node.inputs]
        src = node.inputs[0] if node.inputs else None
        if (
            node.kind == "take"
            and src is not None
            and src.kind == "order_by"
            and fanout.get(src.id, 1) == 1
            and 0 < node.params["n"] <= limit
        ):
            ob = new_inputs[0]
            ks = [(kk, bool(d)) for kk, d in ob.params["keys"]]
            nn = Node(
                "topk", [ob.inputs[0]], node.schema,
                PartitionInfo.ranged(ks, ks, spread=True),
                keys=ks, n=node.params["n"],
            )
        elif all(ni is oi for ni, oi in zip(new_inputs, node.inputs)):
            nn = node
        else:
            nn = Node(node.kind, new_inputs, node.schema, node.partition, **node.params)
        memo[node.id] = nn
        return nn

    return [rb(r) for r in roots]


def lower(roots: Sequence[Node], config, dictionary=None) -> StageGraph:
    """Lower a logical DAG to a stage graph (``dictionary`` enables the
    auto-dense STRING rewrite)."""
    b = _Builder(config, dictionary)
    rewritten = _rewrite_topk(roots, getattr(config, "topk_limit", 1024))
    fanout = consumers(rewritten)
    for node in walk(rewritten):
        b.lower_node(node, fanout)
    outputs: Dict[int, Tuple[int, int]] = {}
    for orig, r in zip(roots, rewritten):
        outputs[orig.id] = b._materialize(r)
    return StageGraph(b.stages, outputs, b.plan_inputs)
