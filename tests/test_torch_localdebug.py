"""LocalDebug, the NumPy interpreter over the logical plan: the port's
(``dryad_tpu_torch/exec/localdebug.py``) against the reference's
(``dryad_tpu/exec/localdebug.py``) and against the port's engine
(``device="cpu"``, P=8).

The random pipelines are ``tests/test_fuzz_differential.py``'s: the same
seeded tables and op grammar.  The two interpreters run the same
algorithms on the same host arrays, so their results are equal as
canonical byte-keyed row multisets (and in place wherever an
``order_by`` fixes the order); the engine is held to the interpreter
with ``oracle.check``'s tolerance, as the reference's fuzz test holds
its engine.
"""

import numpy as np
import pytest

import dryad_tpu as J
import dryad_tpu_torch as T
from oracle import check
from test_fuzz_differential import _STEPS, _build_pipeline, _rand_table

P = 8


def _canonical_rows(table):
    names = sorted(table)
    cols = [np.asarray(table[n]) for n in names]
    rows = []
    for i in range(len(cols[0]) if cols else 0):
        rows.append(tuple(
            str(c[i]).encode() if c.dtype == object else c.dtype.str.encode() + c[i].tobytes()
            for c in cols
        ))
    return names, sorted(rows)


def _run(ctx, tbl, steps):
    q = ctx.from_arrays({k: v.copy() for k, v in tbl.items()})
    for name in steps:
        q = _STEPS[name](q)
    return q.collect()


@pytest.mark.parametrize("seed", range(28))
def test_random_pipeline_localdebug_matches_reference_and_engine(seed):
    rng = np.random.default_rng(seed)
    tbl = _rand_table(rng, int(rng.integers(50, 400)))
    steps = _build_pipeline(rng, int(rng.integers(1, 6)))
    tag = f"seed={seed} steps={steps}"
    port_dbg = _run(T.DryadContext(num_partitions_=P, device="cpu", local_debug=True), tbl, steps)
    ref_dbg = _run(J.DryadContext(local_debug=True), tbl, steps)
    assert _canonical_rows(port_dbg) == _canonical_rows(ref_dbg), tag
    engine = _run(T.DryadContext(num_partitions_=P, device="cpu"), tbl, steps)
    try:
        check(engine, port_dbg)
    except AssertionError as e:
        raise AssertionError(f"{tag}: {e}") from e


def test_ordered_and_user_function_operators_match_reference():
    """Operators the fuzz grammar does not draw: ``apply`` and ``fork``
    (a one-partition batch), ``select_many``, ``with_rank``, ``zip``,
    ``sliding_window``, ``take_while``/``skip_while``, ``default_if_empty``,
    the scalar aggregates and a ranked ``group_join`` order."""
    rng = np.random.default_rng(5)
    n = 300
    tbl = {
        "k": rng.integers(0, 7, n).astype(np.int32),
        "v": rng.standard_normal(n).astype(np.float32),
        "w": rng.integers(-(2 ** 40), 2 ** 40, n).astype(np.int64),
    }

    def build(ctx):
        q = ctx.from_arrays({c: a.copy() for c, a in tbl.items()})
        s = q.order_by([("v", False)])
        out = {
            "apply": s.apply(lambda b: b.filter(b["k"] % 2 == 1)),
            "rank": s.with_rank("r"),
            "zip": s.project(["k"]).zip_(s.project(["v"]).reverse()),
            "window": s.sliding_window(3, ["v"]),
            "take_while": s.take_while(lambda c: c["v"] < 1.0),
            "skip_while": s.skip_while(lambda c: c["v"] < 0.5),
            "empty": q.where(lambda c: c["k"] > 100).default_if_empty({"k": -1, "v": 0.5}),
            "gj": q.project(["k", "v"]).group_join(
                q.project(["k", "w"]), "k", order=[("w", True)], rank_limit=2,
                selector=lambda p: p.group_by("gj_lid", {"c": ("count", None),
                                                         "mw": ("max", "w")}),
                defaults={"c": 0},
            ),
        }
        a, b = s.fork(lambda bt: (bt.filter(bt["k"] < 3), bt.filter(bt["k"] >= 3)),
                      [s.schema, s.schema])
        out["fork_lo"], out["fork_hi"] = a, b
        return out

    port, ref = build(T.DryadContext(num_partitions_=P, device="cpu", local_debug=True)), \
        build(J.DryadContext(local_debug=True))
    for name in port:
        pt, rt = port[name].collect(), ref[name].collect()
        assert _canonical_rows(pt) == _canonical_rows(rt), name
    aggs = {"s": ("sum", "w"), "mn": ("min", "v"), "c": ("count", None), "mu": ("mean", "k")}
    pt = T.DryadContext(num_partitions_=P, device="cpu", local_debug=True).from_arrays(tbl) \
        .aggregate_as_query(aggs).collect()
    rt = J.DryadContext(local_debug=True).from_arrays(tbl).aggregate_as_query(aggs).collect()
    assert _canonical_rows(pt) == _canonical_rows(rt)


def test_do_while_and_stream_rejection_match_reference():
    tbl = {"x": np.arange(10, dtype=np.int32)}
    outs = []
    for ctx in (T.DryadContext(num_partitions_=P, device="cpu", local_debug=True),
                J.DryadContext(local_debug=True)):
        q = ctx.from_arrays({"x": tbl["x"].copy()}).do_while(
            lambda q: q.select(lambda c: {"x": c["x"] * 2}),
            lambda q: q.aggregate_as_query({"m": ("max", "x")}).select(
                lambda c: {"go": c["m"] < 1000}),
            max_iter=20,
        )
        outs.append(q.collect())
        with pytest.raises(RuntimeError, match="local_debug"):
            ctx.from_stream(iter([{"x": np.arange(4, dtype=np.int32)}])).collect()
    assert _canonical_rows(outs[0]) == _canonical_rows(outs[1])
    assert outs[0]["x"].max() >= 1000
