"""Lowering: logical node DAG -> fused stage graph.

The counterpart of ``dryad_tpu/plan/lower.py``: every node kind of the
reference lowers here to the SAME ``StageOp`` kinds and params,
including the static fan-out reduction of exchanges over statically
small inputs (``nparts``), so a plan's op list can be held against the
reference's lowering.  ``input``, ``select``/``where`` (name-only
projections too), ``select_many``, ``apply``, ``fork``/``fork_branch``,
``tee``, the rank and ordered operators (``with_rank``, ``take``,
``skip``, ``tail``, ``take_while``, ``skip_while``, ``reverse``,
``default_if_empty``, ``zip``, ``sliding_window``), ``group_by`` (the
dense bucket path: explicit ``dense=K``, int auto-dense with its range
guard, auto-dense STRING through ``string_code``; the sort path with or
without ``salt``; and a ``Decomposable``: seed, local combine, hash
exchange, final combine, finalize), ``distinct``, ``hash_partition``,
``order_by`` and ``range_partition``, ``order_by`` + ``take(n)`` fused
into ``topk``, the joins (inner, left-outer, semi, anti, count, ranked;
static shuffle, broadcast or run-time ``auto`` placement), ``concat``,
the scalar ``aggregate``, and the driver stages ``apply_host`` and
``do_while`` (re-lowered by the executor each round).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from dryad_tpu_torch.columnar.schema import ColumnType, Schema
from dryad_tpu_torch.ops.segmented import AggSpec, pair_to_f32
from dryad_tpu_torch.plan import keys as K
from dryad_tpu_torch.plan.nodes import Node, PartitionInfo, consumers, walk

_stage_ids = itertools.count()


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
    # output capacity multiplier relative to the base input capacity
    growth: float = 1.0


@dataclasses.dataclass
class StageGraph:
    stages: List[Stage]
    outputs: Dict[int, Tuple[int, int]]
    inputs: Dict[int, Node]


def tail_width(rows, config, P) -> Optional[int]:
    """``ceil(rows / tail_rows_per_partition)`` when ``rows`` is at or
    below ``tail_fanout_rows``; None = full width.  A width at or above
    the partition count ``P`` (when known) is no reduction.  One sizing
    policy for the static estimator and the executor's observed-volume
    adaptation."""
    limit = getattr(config, "tail_fanout_rows", 4096)
    if not limit or rows is None or rows > limit:
        return None
    per = max(1, getattr(config, "tail_rows_per_partition", 512))
    nparts = max(1, -(-rows // per))
    if P is not None and nparts >= P:
        return None
    return nparts


class _Builder:
    def __init__(self, config, dictionary=None, P: Optional[int] = None) -> None:
        self.config = config
        self.dictionary = dictionary
        self.P = P  # partition count when the caller knows it
        self.stages: List[Stage] = []
        self.open: Dict[int, Stage] = {}
        self.cursor: Dict[int, Tuple] = {}
        self.plan_inputs: Dict[int, Node] = {}
        # node id -> static bound on the global row count (None = none)
        self.est: Dict[int, Optional[int]] = {}
        # nodes whose hash claim came from a fan-reduced exchange: still
        # key-colocated, but not co-partitioned with a full-width side
        self.reduced: set = set()
        self._vocab_cache: Dict[Tuple[int, str], Any] = {}

    def _str_vocab(self, node: Node, col: str):
        key = (node.id, col)
        if key not in self._vocab_cache:
            from dryad_tpu_torch.api.query import static_str_vocab

            self._vocab_cache[key] = static_str_vocab(node, col)
        return self._vocab_cache[key]

    # -- static row estimates (as the reference) -------------------------
    def _estimate_node(self, node: Node) -> Optional[int]:
        ins = [self.est.get(i.id) for i in node.inputs]
        k = node.kind
        if k == "aggregate":
            return 1
        if k in ("take", "tail", "topk"):
            return int(node.params["n"])
        if k == "group_by":
            if node.params.get("dense"):
                return int(node.params["dense"])
            if node.params.get("auto_dense") and self.dictionary is not None:
                return len(self.dictionary)
            return ins[0]  # groups <= input rows
        if k == "distinct":
            return ins[0]
        if k == "concat":
            return sum(ins) if all(e is not None for e in ins) else None
        if k == "zip":
            known = [e for e in ins if e is not None]
            return min(known) if known else None
        if k in (
            "select", "where", "project", "with_rank", "take_while",
            "skip_while", "skip", "reverse", "default_if_empty",
            "order_by", "hash_partition", "range_partition",
            "assume_partition", "tee", "fork_branch", "cache",
        ):
            return ins[0] if ins else None
        if k == "join" and node.params.get("join_kind") in ("count", "semi", "anti"):
            return ins[0]
        return None

    def _tail_nparts(self, src: Node) -> Optional[int]:
        """Fan-out of the consumer exchange when the source is statically
        small (:func:`tail_width`); None = full width."""
        return tail_width(self.est.get(src.id), self.config, self.P)

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
        self.est[node.id] = self._estimate_node(node)
        # reduced-ness is sticky down single-input chains
        if node.inputs and node.inputs[0].id in self.reduced:
            self.reduced.add(node.id)
        n_cons = fanout.get(node.id, 1)
        k = node.kind
        if k == "input":
            self.plan_inputs[node.id] = node
            stage = self._new_stage("input", [("plan_input", node.id)])
            self.cursor[node.id] = ("open", stage, 0)
        elif k in (
            "select", "where", "select_many", "apply", "take", "skip", "tail",
            "take_while", "skip_while", "reverse", "default_if_empty", "with_rank",
        ):
            stage, slot = self._continue_or_start(node, fanout.get(node.inputs[0].id, 1))
            if k in ("select", "where", "take_while", "skip_while"):
                stage.ops.append(StageOp(k, dict(slot=slot, fn=node.params["fn"])))
            elif k == "select_many":
                stage.ops.append(StageOp("select_many", dict(
                    slot=slot, fn=node.params["fn"], factor=node.params["factor"],
                )))
                stage.growth *= node.params["factor"]
            elif k == "apply":
                stage.ops.append(StageOp("apply", dict(
                    slot=slot, fn=node.params["fn"],
                    with_index=node.params.get("with_index", False),
                    cap_factor=node.params.get("cap_factor", 1.0),
                )))
                stage.growth *= node.params.get("cap_factor", 1.0)
            elif k == "with_rank":
                stage.ops.append(StageOp("with_rank", dict(slot=slot, out=node.params["out"])))
            elif k in ("take", "skip", "tail"):
                # global rank is partition-major, so take() after order_by
                # keeps the first n in sort order, and on unordered input
                # the first n in engine (ingest) order
                stage.ops.append(StageOp(k, dict(slot=slot, n=node.params["n"])))
            elif k == "reverse":
                stage.ops.append(StageOp("reverse", dict(slot=slot)))
            else:
                stage.ops.append(StageOp(
                    "default_if_empty", dict(slot=slot, defaults=node.params["defaults"]),
                ))
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
        elif k in ("hash_partition", "group_by", "distinct"):
            self._lower_keyed(node, fanout)
        elif k in ("order_by", "range_partition"):
            self._lower_ranged(node, fanout)
        elif k == "join":
            self._lower_join(node)
        elif k == "concat":
            refs = [self._materialize(i) for i in node.inputs]
            stage = self._new_stage("concat", refs)
            stage.ops.append(StageOp("concat", dict(slots=list(range(len(refs))), out_slot=0)))
            stage.growth = float(len(refs))
            self.cursor[node.id] = ("open", stage, 0)
        elif k == "aggregate":
            stage, slot = self._continue_or_start(node, fanout.get(node.inputs[0].id, 1))
            aggs = self._phys_aggs(node.inputs[0].schema, node.params["aggs"])
            stage.ops.append(StageOp("scalar_agg", dict(slot=slot, aggs=aggs)))
            self.cursor[node.id] = ("open", stage, slot)
        elif k == "zip":
            lref = self._materialize(node.inputs[0])
            rref = self._materialize(node.inputs[1])
            stage = self._new_stage("zip", [lref, rref])
            stage.ops.append(StageOp("zip", dict(
                left_slot=0, right_slot=1, suffix=node.params["suffix"],
            )))
            self.cursor[node.id] = ("open", stage, 0)
        elif k == "sliding_window":
            stage, slot = self._continue_or_start(node, fanout.get(node.inputs[0].id, 1))
            stage.ops.append(StageOp("sliding_window", dict(
                slot=slot, size=node.params["size"], cols=node.params["cols"],
            )))
            self.cursor[node.id] = ("open", stage, slot)
        elif k == "fork":
            stage, slot = self._continue_or_start(node, fanout.get(node.inputs[0].id, 1))
            n_out = len(node.params["out_schemas"])
            # fork outputs occupy fresh slots after the stage's inputs
            out_slots = [len(stage.input_refs) + 100 + i for i in range(n_out)]
            stage.ops.append(StageOp("fork", dict(
                slot=slot, fn=node.params["fn"], n_out=n_out, out_slots=out_slots,
            )))
            self._close(stage, out_slots)
            self.cursor[node.id] = ("closed", stage.id, -1)  # branches index it
        elif k == "fork_branch":
            _, stage_id, _ = self.cursor[node.inputs[0].id]
            self.cursor[node.id] = ("closed", stage_id, node.params["index"])
        elif k == "tee":
            ref = self._materialize(node.inputs[0])
            self.cursor[node.id] = ("closed", ref[0], ref[1])
        elif k == "apply_host":
            # driver-evaluated host callback (device -> host -> device)
            ref = self._materialize(node.inputs[0])
            stage = self._new_stage("apply_host", [ref])
            stage.ops.append(StageOp("apply_host", dict(
                fn=node.params["fn"], schema=node.schema,
            )))
            self._close(stage, [0])
            self.cursor[node.id] = ("closed", stage.id, 0)
        elif k == "do_while":
            # driver loop: body and cond are plan-building callables the
            # executor lowers and runs each round
            ref = self._materialize(node.inputs[0])
            stage = self._new_stage("do_while", [ref])
            stage.ops.append(StageOp("do_while", dict(
                body=node.params["body"], cond=node.params["cond"],
                max_iter=node.params.get("max_iter", 100),
                device=node.params.get("device", False), schema=node.schema,
            )))
            self._close(stage, [0])
            self.cursor[node.id] = ("closed", stage.id, 0)
        else:
            raise NotImplementedError(f"lowering for node kind {k!r}")
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
        """Logical aggs -> physical AggSpecs: int64 sum/min/max/mean and
        float64 min/max become the 64-bit pair ops over the split
        ``(#h0, #h1)`` words; ``first`` of a split column takes each
        word."""
        out = []
        for op, col, name in aggs:
            if col is not None:
                f = schema.field(col)
                if f.ctype is ColumnType.INT64 and op in ("sum", "min", "max"):
                    out.append(AggSpec(f"{op}64", f"{col}#h0", name))
                    continue
                if f.ctype is ColumnType.INT64 and op == "mean":
                    out.append(AggSpec("mean64", f"{col}#h0", name))
                    continue
                if f.ctype is ColumnType.FLOAT64:
                    if op in ("min", "max"):
                        # the words are the order-preserving signed-int64
                        # image, so int64 min/max apply unchanged
                        out.append(AggSpec(f"{op}64", f"{col}#h0", name))
                        continue
                    if op in ("sum", "mean"):
                        raise ValueError(
                            f"aggregate {op!r} unsupported on float64 "
                            f"column {col!r}: no f64 arithmetic on "
                            f"device — cast to float32 for approximate "
                            f"sums"
                        )
                if f.ctype.is_split:
                    if op != "first":
                        raise ValueError(
                            f"aggregate {op!r} unsupported on {f.ctype.value} "
                            f"column {col!r}"
                        )
                    for dev in f.device_names:
                        word = dev.split("#", 1)[1]
                        out.append(AggSpec("first", dev, f"{name}#{word}"))
                    continue
            out.append(AggSpec(op, col, name))
        return out

    def _needs_hash_exchange(self, node: Node, keys: Sequence[str]) -> bool:
        """Equal-key colocation elision for keyed ops: a matching hash
        claim colocates, and so does a strict (non-spread) range claim
        whose keys are a subset of the group keys."""
        p = node.inputs[0].partition
        if p.scheme == "hash" and tuple(p.keys) == tuple(keys):
            return False
        if p.scheme == "range" and not p.spread and p.keys and set(p.keys) <= set(keys):
            return False
        return True

    def _hash_exchange(self, node, stage, slot, keys, nparts, tree=None) -> None:
        """exchange_hash + resize of one slot (the reference's pair)."""
        if nparts:
            self.reduced.add(node.id)
        params = dict(slot=slot, keys=keys, nparts=nparts)
        if tree is not None:
            params["tree"] = tree
        stage.ops.append(StageOp("exchange_hash", params))
        stage.ops.append(StageOp(
            "resize", dict(slot=slot, factor=stage.growth, nparts=nparts),
        ))

    def _lower_keyed(self, node: Node, fanout: Dict[int, int]) -> None:
        stage, slot = self._continue_or_start(node, fanout.get(node.inputs[0].id, 1))
        in_schema = node.inputs[0].schema
        keys = node.params["keys"]
        eq_cols = K.equality_cols(in_schema, keys)
        carry_cols = K.group_carry_cols(in_schema, keys)
        need_exchange = self._needs_hash_exchange(node, keys)
        # a statically small input concentrates onto fewer partitions
        nparts = self._tail_nparts(node.inputs[0])

        if node.kind == "hash_partition":
            if need_exchange:
                self._hash_exchange(node, stage, slot, eq_cols, nparts)
            self.cursor[node.id] = ("open", stage, slot)
            return

        if node.kind == "distinct" and self._auto_dense_ok(node, keys):
            # vocabulary distinct: bucket count > 0 + decode, no shuffle
            self._emit_auto_dense(
                node, stage, slot, keys[0], [AggSpec("count", None, "#c")]
            )
            return

        if node.kind == "distinct":
            if need_exchange:
                stage.ops.append(StageOp("distinct", dict(slot=slot, keys=eq_cols)))
                self._hash_exchange(
                    node, stage, slot, eq_cols, nparts,
                    tree=dict(keys=eq_cols, distinct=True),
                )
            stage.ops.append(StageOp("distinct", dict(slot=slot, keys=eq_cols)))
            self.cursor[node.id] = ("open", stage, slot)
            return

        if node.params.get("dense"):
            aggs = self._phys_aggs(in_schema, node.params["aggs"])
            stage.ops.append(StageOp(
                "group_reduce_dense",
                dict(slot=slot, key=carry_cols[0], aggs=aggs,
                     num_buckets=int(node.params["dense"]),
                     guard=bool(node.params.get("guard_range"))),
            ))
            want = K.group_carry_cols(node.schema, node.schema.names)
            stage.ops.append(StageOp("project", dict(slot=slot, cols=want)))
            self.cursor[node.id] = ("open", stage, slot)
            return

        if self._auto_dense_ok(node, keys):
            aggs = self._phys_aggs(in_schema, node.params["aggs"])
            self._emit_auto_dense(node, stage, slot, keys[0], aggs)
            return

        dec = node.params.get("decomposable")
        if dec is not None:
            self._lower_decomposable(node, stage, slot, dec, carry_cols, eq_cols,
                                     need_exchange, nparts)
            return

        aggs = self._phys_aggs(in_schema, node.params["aggs"])
        partial, final = _decompose_aggs(aggs)
        salt = node.params.get("salt")
        if salt and need_exchange:
            # skew path: partial-reduce on (key, salt), exchange on (key,
            # salt), re-reduce, then the key-only exchange below
            salted = carry_cols + ["#salt"]
            stage.ops.append(StageOp("select", dict(slot=slot, fn=_AddSalt(int(salt)))))
            stage.ops.append(StageOp("group_reduce", dict(slot=slot, keys=salted, aggs=partial)))
            stage.ops.append(StageOp(
                "exchange_hash",
                dict(slot=slot, keys=eq_cols + ["#salt"], tree=dict(keys=salted, aggs=final)),
            ))
            stage.ops.append(StageOp("resize", dict(slot=slot, factor=stage.growth)))
            stage.ops.append(StageOp("group_reduce", dict(slot=slot, keys=salted, aggs=final)))
        else:
            stage.ops.append(StageOp("group_reduce", dict(slot=slot, keys=carry_cols, aggs=partial)))
        if need_exchange:
            self._hash_exchange(
                node, stage, slot, eq_cols, nparts, tree=dict(keys=carry_cols, aggs=final),
            )
            stage.ops.append(StageOp("group_reduce", dict(slot=slot, keys=carry_cols, aggs=final)))
        fin = _finalize_fn(aggs)
        if fin is not None:
            stage.ops.append(StageOp("select", dict(slot=slot, fn=fin)))
        want = K.group_carry_cols(node.schema, node.schema.names)
        stage.ops.append(StageOp("project", dict(slot=slot, cols=want)))
        self.cursor[node.id] = ("open", stage, slot)

    def _lower_decomposable(self, node, stage, slot, dec, carry_cols, eq_cols,
                            need_exchange, nparts) -> None:
        """Seed, project to keys + state, local combine, then (unless the
        input is already partitioned on the keys) the hash exchange and
        the final combine, then finalize."""
        combine = StageOp("group_combine", dict(
            slot=slot, keys=carry_cols, state_cols=dec.state_cols, merge=dec.merge,
        ))
        stage.ops.append(StageOp("seed", dict(slot=slot, fn=dec.seed, state_cols=dec.state_cols)))
        stage.ops.append(StageOp("project", dict(slot=slot, cols=carry_cols + list(dec.state_cols))))
        stage.ops.append(combine)
        if need_exchange:
            if nparts:
                self.reduced.add(node.id)
            stage.ops.append(StageOp("exchange_hash", dict(
                slot=slot, keys=eq_cols, nparts=nparts,
                tree=dict(keys=carry_cols, state_cols=dec.state_cols, merge=dec.merge),
            )))
            stage.ops.append(StageOp("resize", dict(slot=slot, factor=stage.growth, nparts=nparts)))
            stage.ops.append(StageOp("group_combine", dict(combine.params)))
        if dec.finalize is not None:
            stage.ops.append(StageOp("select", dict(slot=slot, fn=dec.finalize)))
            want = K.group_carry_cols(node.schema, node.schema.names)
            stage.ops.append(StageOp("project", dict(slot=slot, cols=want)))
        self.cursor[node.id] = ("open", stage, slot)

    def _lower_ranged(self, node: Node, fanout: Dict[int, int]) -> None:
        stage, slot = self._continue_or_start(node, fanout.get(node.inputs[0].id, 1))
        keys: List[Tuple[str, bool]] = [(kk, bool(d)) for kk, d in node.params["keys"]]
        operands_fn = K.ordering_operands(node.inputs[0].schema, keys)
        src_p = node.inputs[0].partition
        # Elision needs the same primary key AND direction.  A spread
        # input keeps global order but not equal-key colocation, so only
        # an order_by by exactly its ordering may elide over it.
        spread_ok = node.kind == "order_by" and src_p.ordered_by == tuple(keys)
        already_ranged = (
            src_p.scheme == "range"
            and len(src_p.range_by) > 0
            and src_p.range_by[0] == keys[0]
            and (not src_p.spread or spread_ok)
        )
        if not already_ranged:
            # order_by needs only global order, so its exchange spreads
            # equal keys (skew-proof); range_partition promises
            # colocation and keeps strict splitters
            nparts = self._tail_nparts(node.inputs[0])
            if nparts:
                self.reduced.add(node.id)
            stage.ops.append(StageOp(
                "exchange_range",
                dict(slot=slot, operands_fn=operands_fn, spread=node.kind == "order_by",
                     rate=self.config.sample_rate, nparts=nparts),
            ))
            stage.ops.append(StageOp(
                "resize", dict(slot=slot, factor=stage.growth, nparts=nparts)
            ))
        if node.kind == "order_by":
            stage.ops.append(StageOp("local_sort", dict(slot=slot, operands_fn=operands_fn)))
        self.cursor[node.id] = ("open", stage, slot)

    # -- join -----------------------------------------------------------------
    def _lower_join(self, node: Node) -> None:
        left, right = node.inputs
        lref = self._materialize(left)
        rref = self._materialize(right)
        stage = self._new_stage("join", [lref, rref])
        lkeys = K.equality_cols(left.schema, node.params["left_keys"])
        rkeys = K.equality_cols(right.schema, node.params["right_keys"])
        strategy = node.params.get("strategy", "shuffle")
        need_l = self._needs_hash_exchange_for(left, node.params["left_keys"])
        need_r = self._needs_hash_exchange_for(right, node.params["right_keys"])
        strat_params = {}
        if strategy == "shuffle":
            # static co-partitioning: the exchanges are stage ops
            if need_l:
                stage.ops.append(StageOp("exchange_hash", dict(slot=0, keys=lkeys)))
                stage.ops.append(StageOp("resize", dict(slot=0, factor=1.0)))
            if need_r:
                stage.ops.append(StageOp("exchange_hash", dict(slot=1, keys=rkeys)))
                stage.ops.append(StageOp("resize", dict(slot=1, factor=1.0)))
        else:
            # broadcast / auto: the kernel decides from the right side's
            # static row bound (``est_right``) or capacity, and either
            # replicates the right side or runs the deferred exchanges
            strat_params = dict(
                strategy=strategy,
                need_left_exchange=need_l,
                need_right_exchange=need_r,
                broadcast_limit=self.config.broadcast_limit,
                est_right=self.est.get(right.id),
            )
        sides = dict(left_slot=0, right_slot=1, left_keys=lkeys, right_keys=rkeys)
        expansion = node.params.get("expansion", 1.0)
        jk = node.params.get("join_kind", "inner")
        if jk == "count":
            stage.ops.append(StageOp("group_join_count", dict(
                **sides, out=node.params["out"], expansion=expansion, **strat_params,
            )))
        elif jk == "ranked":
            order = node.params.get("order")
            operands_fn = K.ordering_operands(right.schema, list(order)) if order else None
            stage.ops.append(StageOp("join_ranked", dict(
                **sides, rank_out=node.params["rank_out"], operands_fn=operands_fn,
                expansion=expansion, suffix=node.params.get("suffix", "_r"),
                rank_limit=node.params.get("rank_limit"),
                rank_limit_max_boost=2 ** self.config.max_shuffle_retries,
                **strat_params,
            )))
            stage.growth = max(1.0, expansion)
        elif jk in ("inner", "left"):
            stage.ops.append(StageOp("join", dict(
                **sides, expansion=expansion, suffix=node.params.get("suffix", "_r"),
                outer=(jk == "left"), right_defaults=node.params.get("right_defaults"),
                **strat_params,
            )))
            stage.growth = max(1.0, expansion) + (1.0 if jk == "left" else 0.0)
        else:
            stage.ops.append(StageOp("semi", dict(
                **sides, negate=(jk == "anti"), expansion=expansion, **strat_params,
            )))
        self.cursor[node.id] = ("open", stage, 0)

    def _needs_hash_exchange_for(self, src: Node, keys: Sequence[str]) -> bool:
        """A join side needs its exchange unless it is hash-partitioned
        on exactly these keys at full width (a fan-reduced layout is
        key-colocated but not co-partitioned with a full-width side)."""
        if src.id in self.reduced:
            return True
        p = src.partition
        return not (p.scheme == "hash" and tuple(p.keys) == tuple(keys))


def _decompose_aggs(aggs):
    """Builtin combiner decomposition: local partial + post-shuffle
    final (count -> local count + final sum; mean -> (sum, count)
    partials + final divide; the 64-bit pair ops re-reduce their
    pair)."""
    partial, final = [], []
    for a in aggs:
        if a.op == "sum":
            partial.append(AggSpec("sum", a.col, a.out))
            final.append(AggSpec("sum", a.out, a.out))
        elif a.op == "count":
            partial.append(AggSpec("count", None, a.out))
            final.append(AggSpec("sum", a.out, a.out))
        elif a.op in ("min", "max", "first", "any", "all"):
            partial.append(AggSpec(a.op, a.col, a.out))
            final.append(AggSpec(a.op, a.out, a.out))
        elif a.op in ("sum64", "min64", "max64"):
            partial.append(AggSpec(a.op, a.col, a.out))
            final.append(AggSpec(a.op, f"{a.out}#h0", a.out))
        elif a.op == "mean64":
            partial.append(AggSpec("sum64", a.col, f"{a.out}#s"))
            partial.append(AggSpec("count", None, f"{a.out}#c"))
            final.append(AggSpec("sum64", f"{a.out}#s#h0", f"{a.out}#s"))
            final.append(AggSpec("sum", f"{a.out}#c", f"{a.out}#c"))
        elif a.op == "mean":
            partial.append(AggSpec("sum", a.col, f"{a.out}#s"))
            partial.append(AggSpec("count", None, f"{a.out}#c"))
            final.append(AggSpec("sum", f"{a.out}#s", f"{a.out}#s"))
            final.append(AggSpec("sum", f"{a.out}#c", f"{a.out}#c"))
        else:
            raise ValueError(f"unknown agg op {a.op!r}")
    return partial, final


class _AddSalt:
    """Row fn appending the ``#salt`` spread column (row index mod
    salt); value-equal, as in the reference."""

    def __init__(self, salt: int):
        self.salt = salt

    def __eq__(self, other) -> bool:
        return type(other) is _AddSalt and other.salt == self.salt

    def __hash__(self) -> int:
        return hash(("_AddSalt", self.salt))

    def __call__(self, cols):
        ref = next(iter(cols.values()))
        n = ref.shape[-1]
        salt = torch.arange(n, dtype=torch.int32, device=ref.device) % self.salt
        return {**cols, "#salt": salt.expand(ref.shape[:-1] + (n,))}


class _FinalizeMeans:
    """Post-shuffle mean finalize (sum / count; 64-bit sums decode their
    word pair to f32 first); value-equal, as in the reference."""

    def __init__(self, outs, outs64=()):
        self.outs = tuple(outs)
        self.outs64 = tuple(outs64)

    def __eq__(self, other) -> bool:
        return (
            type(other) is _FinalizeMeans
            and other.outs == self.outs
            and other.outs64 == self.outs64
        )

    def __hash__(self) -> int:
        return hash(("_FinalizeMeans", self.outs, self.outs64))

    def __call__(self, cols):
        out = dict(cols)
        for name in self.outs:
            s = out.pop(f"{name}#s").to(torch.float32)
            c = out.pop(f"{name}#c").to(torch.float32)
            out[name] = s / torch.clamp(c, min=1.0)
        for name in self.outs64:
            lo = out.pop(f"{name}#s#h0")
            hi = out.pop(f"{name}#s#h1")
            c = out.pop(f"{name}#c").to(torch.float32)
            out[name] = pair_to_f32(lo, hi) / torch.clamp(c, min=1.0)
        return out


def _finalize_fn(aggs):
    """Post-shuffle finalize for aggs whose partials differ (mean)."""
    means = [a.out for a in aggs if a.op == "mean"]
    means64 = [a.out for a in aggs if a.op == "mean64"]
    if not means and not means64:
        return None
    return _FinalizeMeans(means, means64)


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


def lower(
    roots: Sequence[Node], config, dictionary=None, P: Optional[int] = None
) -> StageGraph:
    """Lower a logical DAG to a stage graph (``dictionary`` enables the
    auto-dense STRING rewrite; ``P``, the partition count when known,
    lets the fan-out reduction skip widths at or above it)."""
    b = _Builder(config, dictionary, P)
    rewritten = _rewrite_topk(roots, getattr(config, "topk_limit", 1024))
    fanout = consumers(rewritten)
    for node in walk(rewritten):
        b.lower_node(node, fanout)
    outputs: Dict[int, Tuple[int, int]] = {}
    for orig, r in zip(roots, rewritten):
        outputs[orig.id] = b._materialize(r)
    return StageGraph(b.stages, outputs, b.plan_inputs)
