"""Decomposable aggregates of the port (dryad_tpu_torch, device="cpu")
against the JAX package at P=8.

- ``ops/segmented.py::associative_scan`` copies JAX's recursion, so it
  gives ``jax.lax.associative_scan``'s bytes: float addition, a
  non-commutative merge (composition of affine maps) and an argmax
  merge, at lengths 1, 2, 3, 7, 8 and 1000, batched over rows.
- ``group_combine`` against the reference's, partition by partition,
  every output slot, subnormal and -0.0 float states included.
- ``group_by(decomposable=...)`` (the four exemplars of
  ``api/decomposable.py``, the variance of the reference's
  ``tests/test_api_e2e.py``, a non-linear argmax) and
  ``aggregate_decomposable``: ``collect()`` byte for byte, float states
  included, and the stage op lists.  One difference is shown, not
  hidden: the reference's compiled stages fuse a multiply feeding an add
  into one rounding (an FMA) and PyTorch's eager ops round twice, so a
  finalize like the variance's ``s2/c - m*m`` is held to that rounding,
  its states to their bytes (ROADMAP.md section 3).

User functions are written once where the same operators work on
``jnp`` and ``torch`` arrays; ``xp`` is the array module where they do
not.
"""

import dataclasses

import numpy as np
import pytest
import torch

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.api import decomposable as JD
from dryad_tpu.columnar.batch import ColumnBatch as JBatch
from dryad_tpu.ops import segmented as JSEG
from dryad_tpu.plan.lower import lower as jlower
from dryad_tpu_torch.api import decomposable as TD
from dryad_tpu_torch.columnar.batch import ColumnBatch
from dryad_tpu_torch.ops import segmented as TSEG
from dryad_tpu_torch.plan.lower import lower as tlower

P = 8


def _jnp():
    import jax.numpy as jnp

    return jnp


def _bytes_equal(a, b, what=""):
    a, b = np.atleast_1d(a), np.atleast_1d(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=what)


# -- the scan ----------------------------------------------------------------------

def _add(xp):
    return lambda a, b: [a[0] + b[0]]


def _affine(xp):
    # (m, c) then (m', c'): x -> m' (m x + c) + c'; associative, not commutative
    return lambda a, b: [a[0] * b[0], a[1] * b[0] + b[1]]


def _argmax(xp):
    # (value, index): the larger value, ties to the larger index
    def f(a, b):
        take_b = (b[0] > a[0]) | ((b[0] == a[0]) & (b[1] > a[1]))
        return [xp.where(take_b, b[0], a[0]), xp.where(take_b, b[1], a[1])]
    return f


def _scan_inputs(merge, n):
    rng = np.random.default_rng(n)
    if merge == "add":
        return [(rng.standard_normal((3, n)) * 10.0 ** rng.integers(-3, 4, (3, n))).astype(np.float32)]
    if merge == "affine":
        return [rng.uniform(0.5, 1.5, (3, n)).astype(np.float32),
                rng.standard_normal((3, n)).astype(np.float32)]
    return [rng.integers(0, 7, (3, n)).astype(np.float32), np.tile(np.arange(n, dtype=np.int32), (3, 1))]


MERGES = {"add": _add, "affine": _affine, "argmax": _argmax}


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 1000])
@pytest.mark.parametrize("merge", sorted(MERGES))
def test_associative_scan_matches_jax(merge, n):
    import jax

    jnp = _jnp()
    elems = _scan_inputs(merge, n)
    ref = jax.lax.associative_scan(
        lambda a, b: tuple(MERGES[merge](jnp)(list(a), list(b))),
        tuple(jnp.asarray(e) for e in elems), axis=1)
    got = TSEG.associative_scan(MERGES[merge](torch), [torch.from_numpy(e) for e in elems])
    for r, g in zip(ref, got):
        _bytes_equal(g.numpy(), np.asarray(r), f"{merge} n={n}")


def test_scan_zero_padding_add_flushes_as_jax():
    """JAX interleaves by adding zero-padded halves: -0.0 and subnormal
    values come out as +0.0 on the reference's backends."""
    import jax

    x = np.array([-0.0, 3e-39, -0.0, 1e-45, 5.0, -1e-40], np.float32)
    ref = jax.lax.associative_scan(lambda a, b: a, _jnp().asarray(x))
    (got,) = TSEG.associative_scan(lambda a, b: [a[0]], [torch.from_numpy(x)])
    _bytes_equal(got.numpy(), np.asarray(ref))
    assert got.numpy().view(np.uint32).tolist()[:4] == [0, 0, 0, 0]


# -- group_combine against the reference's, partition by partition -----------------

def _combine_inputs(rng, cap, state):
    k = rng.integers(-5, 5, (P, cap)).astype(np.int32)
    valid = rng.random((P, cap)) < 0.8
    valid[3] = False  # an empty partition
    if state == "subnormal":
        s = rng.choice(np.array([1e-45, -3e-39, 2e-39, 0.0, -0.0, 1.5e-38], np.float32), (P, cap))
    else:
        s = (rng.standard_normal((P, cap)) * 10.0 ** rng.integers(-2, 3, (P, cap))).astype(np.float32)
    t = rng.integers(0, 4, (P, cap)).astype(np.int32)
    return k, valid, {"s": s, "t": t}


def _sum_merge(xp):
    return lambda a, b: {"s": a["s"] + b["s"], "t": a["t"] + b["t"]}


def _max_merge(xp):
    def f(a, b):
        take_b = (b["s"] > a["s"]) | ((b["s"] == a["s"]) & (b["t"] > a["t"]))
        return {"s": xp.where(take_b, b["s"], a["s"]), "t": xp.where(take_b, b["t"], a["t"])}
    return f


def _group_combine_both(k, valid, state, merge):
    jnp = _jnp()
    port = TSEG.group_combine(
        ColumnBatch({"k": torch.from_numpy(k), **{c: torch.from_numpy(v) for c, v in state.items()}},
                    torch.from_numpy(valid)),
        ["k"], ["s", "t"], merge(torch))
    refs = [JSEG.group_combine(
        JBatch({"k": jnp.asarray(k[p]), **{c: jnp.asarray(v[p]) for c, v in state.items()}},
               jnp.asarray(valid[p])),
        ["k"], ["s", "t"], merge(jnp)) for p in range(P)]
    return port, refs


@pytest.mark.parametrize("cap", [1, 8, 100])
@pytest.mark.parametrize("merge", ["sum", "max"])
def test_group_combine_matches_reference(rng, merge, cap):
    k, valid, state = _combine_inputs(rng, cap, "normal")
    port, refs = _group_combine_both(k, valid, state, _sum_merge if merge == "sum" else _max_merge)
    for p, ref in enumerate(refs):
        _bytes_equal(port.valid[p].numpy(), np.asarray(ref.valid), f"valid {p}")
        for c in ("k", "s", "t"):
            _bytes_equal(port.data[c][p].numpy(), np.asarray(ref.data[c]), f"{c} {p}")


@pytest.mark.parametrize("merge", ["sum", "max"])
def test_group_combine_subnormal_states_match_reference(rng, merge):
    """Subnormal (and -0.0) float states.  The reference's arithmetic
    and compares treat them as zero and its scan's interleave (an add
    of zero padding) flushes every output, so a merge that only selects
    ends flushed too; the port flushes the states into and out of each
    merge and in the interleave, and gives the same bytes."""
    k, valid, state = _combine_inputs(rng, 64, "subnormal")
    port, refs = _group_combine_both(k, valid, state, _sum_merge if merge == "sum" else _max_merge)
    for p, ref in enumerate(refs):
        for c in ("k", "s", "t"):
            _bytes_equal(port.data[c][p].numpy(), np.asarray(ref.data[c]), f"{c} {p}")
    s = port.data["s"][port.valid].numpy()
    assert np.all((s == 0) | (np.abs(s) >= 2.0 ** -126)) and not np.any(np.signbit(s) & (s == 0))


# -- the decomposable group_by and aggregate_decomposable ---------------------------

def _ctxs():
    return (J.DryadContext(num_partitions_=P),
            T.DryadContext(num_partitions_=P, device="cpu"))


def _variance(mod, xp):
    """tests/test_api_e2e.py's variance by (count, sum, sum of squares)."""
    return mod.Decomposable(
        seed=lambda cols: {"cnt": xp.ones_like(cols["v"]), "s1": cols["v"], "s2": cols["v"] * cols["v"]},
        merge=lambda a, b: {k: a[k] + b[k] for k in ("cnt", "s1", "s2")},
        state_cols=["cnt", "s1", "s2"],
        finalize=lambda cols: {
            **{k: v for k, v in cols.items() if k not in ("cnt", "s1", "s2")},
            "var": cols["s2"] / cols["cnt"] - (cols["s1"] / cols["cnt"]) ** 2,
        },
        out_fields=[("var", mod.ColumnType.FLOAT32)],
    )


def _best_visit(mod, xp):
    """Non-linear: the highest revenue with its date, ties to the later date."""
    def merge(a, b):
        take_b = (b["rev"] > a["rev"]) | ((b["rev"] == a["rev"]) & (b["day"] > a["day"]))
        return {"rev": xp.where(take_b, b["rev"], a["rev"]), "day": xp.where(take_b, b["day"], a["day"])}
    return mod.Decomposable(
        seed=lambda cols: {"rev": cols["v"], "day": cols["d"]}, merge=merge,
        state_cols=["rev", "day"],
        out_fields=[("rev", mod.ColumnType.FLOAT32), ("day", mod.ColumnType.INT32)],
    )


def _keyed(dec):
    """An exemplar whose finalize keeps the key column."""
    if dec.finalize is None:
        return dec
    return dataclasses.replace(dec, finalize=lambda cols, f=dec.finalize: {"k": cols["k"], **f(cols)})


def _table(rng, n=3000, keys=40, ints=False):
    return {
        "k": rng.integers(-keys, keys, n).astype(np.int32),
        "v": (rng.integers(-100, 100, n).astype(np.int32) if ints
              else (rng.standard_normal(n) * 10.0 ** rng.integers(-2, 3, n)).astype(np.float32)),
        "d": rng.integers(0, 9, n).astype(np.int32),
    }


DECS = {
    "variance": lambda mod, D, xp: _variance(mod, xp),
    "best_visit": lambda mod, D, xp: _best_visit(mod, xp),
    **{f"exemplar_{n}": (lambda n: lambda mod, D, xp: _keyed(D.LINEAR_DECOMPOSABLES[n]))(n)
       for n in ("vecsum", "countsum", "moments", "intsum")},
}


# finalizes whose multiply feeds a subtraction: the reference's compiled
# stage rounds it once (FMA), PyTorch twice
FMA_FINALIZE = ("variance", "exemplar_moments")


def _run_group_by(rng, name, shape, finalize=True):
    t = _table(np.random.default_rng(rng), ints=name == "exemplar_intsum")
    outs, plans = [], []
    for ctx, mod, D, xp, low in zip(_ctxs(), (J, T), (JD, TD), (_jnp(), torch), (jlower, tlower)):
        q = ctx.from_arrays(t)
        if shape == "hash_partitioned":
            q = q.hash_partition("k")  # the exchange is elided
        elif shape == "fan_reduced":
            q = q.order_by([("d", False), ("k", False)]).take(700)
        dec = DECS[name](mod, D, xp)
        if not finalize:
            names = list(dec.state_cols)
            dec = dataclasses.replace(dec, finalize=None, out_fields=[
                (n, mod.ColumnType.INT32 if name == "exemplar_intsum" else mod.ColumnType.FLOAT32)
                for n in names])
        g = q.group_by("k", decomposable=dec)
        outs.append(g.collect())
        plans.append([[op.kind for op in s.ops] for s in low([g.node], ctx.config, P=P).stages])
    assert list(outs[0]) == list(outs[1])
    assert plans[0] == plans[1]
    assert "group_combine" in plans[1][-1]
    return outs


@pytest.mark.parametrize("shape", ["full_width", "hash_partitioned", "fan_reduced"])
@pytest.mark.parametrize("name", sorted(DECS))
def test_decomposable_group_by_matches_reference(name, shape):
    ref, port = _run_group_by(11, name, shape)
    for c in ref:
        if c == "var" and name in FMA_FINALIZE:
            continue
        _bytes_equal(port[c], ref[c], c)
    if name in FMA_FINALIZE:
        # the states byte for byte, then the finalize within its rounding
        sref, sport = _run_group_by(11, name, shape, finalize=False)
        for c in sref:
            _bytes_equal(sport[c], sref[c], c)
        m = sport["s1"].astype(np.float64) / np.maximum(sport["cnt"], 1)
        bound = 2.0 ** -23 * (m * m + 2 * np.abs(ref["var"]))
        assert np.all(np.abs(port["var"].astype(np.float64) - ref["var"]) <= bound)


@pytest.mark.parametrize("name", ["countsum", "moments"])
def test_exemplar_finalize_without_keys_fails_as_the_reference(rng, name):
    """The countsum and moments exemplars' finalize returns only its
    output column, so the project after it misses the group key: both
    packages raise KeyError, in group_by and in aggregate_decomposable."""
    for ctx, D in zip(_ctxs(), (JD, TD)):
        q = ctx.from_arrays(_table(rng, n=50))
        with pytest.raises(KeyError, match="'k'"):
            q.group_by("k", decomposable=D.LINEAR_DECOMPOSABLES[name]).collect()
        with pytest.raises(KeyError, match="__g"):
            q.aggregate_decomposable(D.LINEAR_DECOMPOSABLES[name])


@pytest.mark.parametrize("name", ["sumsq", "vecsum", "intsum", "best_visit"])
def test_aggregate_decomposable_matches_reference(rng, name):
    t = _table(rng, ints=name == "intsum")
    got = []
    for ctx, mod, D, xp in zip(_ctxs(), (J, T), (JD, TD), (_jnp(), torch)):
        if name == "sumsq":  # tests/test_operators_extended.py
            dec = mod.Decomposable(
                seed=lambda cols: {"acc": cols["v"] * cols["v"]},
                merge=lambda a, b: {"acc": a["acc"] + b["acc"]},
                state_cols=["acc"], out_fields=[("acc", mod.ColumnType.FLOAT32)])
        elif name == "best_visit":
            dec = _best_visit(mod, xp)
        else:
            dec = D.LINEAR_DECOMPOSABLES[name]
        got.append(ctx.from_arrays(t).aggregate_decomposable(dec))
    assert list(got[0]) == list(got[1])
    for c in got[0]:
        _bytes_equal(got[1][c], got[0][c], c)
    empty = T.DryadContext(num_partitions_=P, device="cpu").from_arrays(
        {"v": np.zeros(0, np.float32)}).aggregate_decomposable(TD.LINEAR_DECOMPOSABLES["vecsum"])
    assert empty == {"s": None}


def test_decomposable_contract():
    seed = TD.LINEAR_DECOMPOSABLES["vecsum"].seed
    merge = TD.LINEAR_DECOMPOSABLES["vecsum"].merge
    with pytest.raises(ValueError, match="identity"):
        TD.Decomposable(seed, merge, ["s"], [("s", T.ColumnType.FLOAT32)], linear=True)
    with pytest.raises(ValueError, match="must match"):
        TD.Decomposable(seed, merge, ["s"], [("s", T.ColumnType.FLOAT32)], linear=True,
                        identity={"t": 0})
    with pytest.raises(ValueError, match="additive zero"):
        TD.Decomposable(seed, merge, ["s"], [("s", T.ColumnType.FLOAT32)], linear=True,
                        identity={"s": 1})
    nonlin = TD.Decomposable(seed, merge, ["s"], [("s", T.ColumnType.FLOAT32)])
    assert TD.delta_fold_reason(nonlin) == JD.delta_fold_reason(nonlin)
    with pytest.raises(ValueError, match="not declared linear"):
        TD.register_linear("x", nonlin)
    assert sorted(TD.LINEAR_DECOMPOSABLES) == sorted(JD.LINEAR_DECOMPOSABLES)
    assert T.Decomposable is TD.Decomposable
    q = T.DryadContext(num_partitions_=P, device="cpu").from_arrays({"k": np.zeros(2, np.int32)})
    with pytest.raises(ValueError, match="salt applies"):
        q.group_by("k", decomposable=nonlin, salt=2)
    with pytest.raises(ValueError, match="builtin aggs only"):
        q.group_by("k", decomposable=nonlin, dense=4)
