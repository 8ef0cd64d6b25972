"""Coded k-of-n partial aggregation (dryad_tpu_torch.redundancy): the
port against the reference, after tests/test_coded.py.

- the coding math: generator rows, coded specs, reconstructions and the
  merge weights equal the reference's on identical inputs (integer
  states byte for byte, float states within 1e-9), over seeds and every
  registered linear ``Decomposable``;
- the policy: ``decide`` gives the reference's decision and reason on
  equal plans;
- end to end over the port's worker processes (``device="cpu"``): coded
  ``group_by``, scalar and linear ``Decomposable`` jobs equal the
  reference's ``collect()`` of the same plan (integers byte for byte;
  the moments finalize within 1e-6), and seeded kills of r of the n
  coded vertices give the unfailed bytes with no re-execution.
"""

from fractions import Fraction
from itertools import combinations

import numpy as np
import pytest

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.api.decomposable import LINEAR_DECOMPOSABLES as J_LINEAR
from dryad_tpu.exec import partial as JPA
from dryad_tpu.redundancy import coding as JC
from dryad_tpu.redundancy import policy as JPO
from dryad_tpu.redundancy import reconstruct as JR
from dryad_tpu_torch.api.decomposable import LINEAR_DECOMPOSABLES as T_LINEAR
from dryad_tpu_torch.cluster.localjob import LocalJobSubmission
from dryad_tpu_torch.exec import faults as TX
from dryad_tpu_torch.exec import partial as TPA
from dryad_tpu_torch.redundancy import coding as TC
from dryad_tpu_torch.redundancy import policy as TPO
from dryad_tpu_torch.redundancy import reconstruct as TR

SEEDS = [0, 1, 2]


@pytest.fixture(autouse=True)
def clear_port_faults():
    TX.clear_faults()
    yield
    TX.clear_faults()


# -- coding math ----------------------------------------------------------------


@pytest.mark.parametrize("k,r", [(2, 1), (3, 2), (4, 2), (5, 3), (6, 2), (16, 2)])
def test_generator_and_spec_equal_the_reference(k, r):
    assert TC.generator_rows(k, r) == JC.generator_rows(k, r)
    ts, js = TC.CodedSpec(k, r), JC.CodedSpec(k, r)
    assert (ts.k, ts.r, ts.n) == (js.k, js.r, js.n)
    for j in range(ts.n):
        assert ts.row(j) == js.row(j)
        assert ts.support(j) == js.support(j)
        assert ts.coeffs(j) == js.coeffs(j)
        assert ts.is_parity(j) == js.is_parity(j)
    rows = TC.generator_rows(k, r)
    for subset in list(combinations(range(k + r), k))[:40]:
        w = TR.solve_merge_weights([rows[j] for j in subset])
        assert w == JR.solve_merge_weights([rows[j] for j in subset])
        for i in range(k):
            assert sum(w[jj] * rows[j][i] for jj, j in enumerate(subset)) == Fraction(1)


def _partial_tables(seed, k, float_states):
    """k per-partition partial tables with different key subsets."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        keys = np.sort(rng.choice(np.arange(11, dtype=np.int32),
                                  size=int(rng.integers(3, 9)), replace=False))
        t = {"g": keys, "a": rng.integers(-10 ** 6, 10 ** 6, len(keys)).astype(np.int64)}
        if float_states:
            t["f"] = rng.standard_normal(len(keys)).astype(np.float64)
        out.append(t)
    return out


def _equal(a, b, float_cols=()):
    assert set(a) == set(b)
    for c in a:
        x, y = np.asarray(a[c]), np.asarray(b[c])
        assert x.dtype == y.dtype, c
        if c in float_cols:
            np.testing.assert_allclose(x, y, rtol=1e-9, atol=1e-9)
        else:
            assert x.tobytes() == y.tobytes(), c


@pytest.mark.parametrize("floats", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_every_k_subset_reconstructs_like_the_reference(seed, floats):
    k, r = 4, 2
    spec = TC.CodedSpec(k, r)
    state = ["a", "f"] if floats else ["a"]
    partials = _partial_tables(seed, k, floats)
    coded = []
    for j in range(spec.n):
        part = [partials[i] for i in spec.support(j)]
        tcj = TPA.coded_combine(part, spec.coeffs(j), ["g"], state)
        _equal(tcj, JPA.coded_combine(part, spec.coeffs(j), ["g"], state))
        coded.append(tcj)
    truth = TPA.coded_combine(partials, [1] * k, ["g"], state)
    for subset in combinations(range(spec.n), k):
        rows = [spec.row(j) for j in subset]
        tables = [coded[j] for j in subset]
        tm, ti = TR.merge_coded(rows, tables, ["g"], state)
        jm, ji = JR.merge_coded(rows, tables, ["g"], state)
        _equal(tm, jm)  # the same arithmetic: equal bytes, floats too
        assert ti == ji and ti["exact"] is (not floats)
        _equal(tm, truth, float_cols=("f",))
    for subset in ((0, 2, 4, 5), (2, 3, 4, 5)):
        rows = [spec.row(j) for j in subset]
        tables = [coded[j] for j in subset]
        for tp, jp in zip(TR.reconstruct_partials(rows, tables, ["g"], state),
                          JR.reconstruct_partials(rows, tables, ["g"], state)):
            _equal(tp, jp)


def _dec_state_tables(dec, seed, k):
    """Per-partition STATE tables of one linear Decomposable, group-summed
    per key (seeded in numpy: both packages' seeds are elementwise)."""
    rng = np.random.default_rng(seed)
    tables = []
    for _ in range(k):
        n = int(rng.integers(20, 60))
        v = rng.integers(-50, 50, n)
        floaty = any(ct.numpy_dtype.kind == "f" for _n, ct in dec.state_fields)
        v = v.astype(np.float32 if floaty else np.int32)
        keys = rng.integers(0, 7, n).astype(np.int32)
        seeded = {"cnt": np.ones_like(v), "s1": v, "s2": v * v, "s": v, "t": v}
        t = {"g": np.unique(keys)}
        for name, ct in dec.state_fields:
            acc = np.zeros(len(t["g"]), ct.numpy_dtype)
            np.add.at(acc, np.searchsorted(t["g"], keys), seeded[name].astype(ct.numpy_dtype))
            t[name] = acc
        tables.append(t)
    return tables


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(T_LINEAR))
def test_registered_linear_decomposables_reconstruct_like_the_reference(name, seed):
    assert sorted(T_LINEAR) == sorted(J_LINEAR)
    tdec, jdec = T_LINEAR[name], J_LINEAR[name]
    assert [(n, ct.name) for n, ct in tdec.state_fields] == \
        [(n, ct.name) for n, ct in jdec.state_fields]
    assert tdec.identity == jdec.identity and tdec.linear and jdec.linear
    state = [n for n, _ct in tdec.state_fields]
    k, r = 3, 2
    spec = TC.CodedSpec(k, r)
    tables = _dec_state_tables(tdec, seed, k)
    coded = [TPA.coded_combine([tables[i] for i in spec.support(j)], spec.coeffs(j), ["g"], state)
             for j in range(spec.n)]
    truth = TPA.coded_combine(tables, [1] * k, ["g"], state)
    exact = all(ct.numpy_dtype.kind in "iub" for _n, ct in tdec.state_fields)
    for subset in combinations(range(spec.n), k):
        rows = [spec.row(j) for j in subset]
        tm, _ = TR.merge_coded(rows, [coded[j] for j in subset], ["g"], state)
        jm, _ = JR.merge_coded(rows, [coded[j] for j in subset], ["g"], state)
        _equal(tm, jm)
        _equal(tm, truth, float_cols=() if exact else tuple(state))


# -- policy ---------------------------------------------------------------------


def _ctx(pkg, **cfg):
    if pkg == "port":
        return T.DryadContext(num_partitions_=1, device="cpu", config=T.DryadConfig(**cfg))
    return J.DryadContext(num_partitions_=1, config=J.DryadConfig(**cfg))


def _group_spec(pkg, aggs, table=None):
    mod, pa = (T, TPA) if pkg == "port" else (J, JPA)
    ctx = _ctx(pkg)
    table = table or {"k": np.arange(10, dtype=np.int32), "v": np.ones(10, np.float32)}
    key = next(iter(table))
    q = ctx.from_arrays(table).group_by(key, aggs)
    partial, plan = pa.partial_plan([(op, col, out) for out, (op, col) in aggs.items()])
    pq = type(q)(ctx, q.node.inputs[0]).group_by(key, partial)
    return pq, ("group", [key], plan, q.schema), mod


def _max_state(a, b):
    """A non-additive merge (keeps the later state)."""
    return {"m": b["m"]}


def _seed_m(c):
    return {"m": c["v"]}


def _undeclared(mod):
    return mod.Decomposable(
        seed=_seed_m, merge=_max_state, state_cols=["m"],
        out_fields=[("m", mod.ColumnType.FLOAT32)],
        state_fields=[("m", mod.ColumnType.FLOAT32)],
    )


POLICY_CASES = {
    "linear_group": (dict(s=("sum", "v"), c=("count", None), m=("mean", "v")), {}, 4, None),
    "non_linear": (dict(s=("sum", "v"), lo=("min", "v")), {}, 4, None),
    "disabled": (dict(s=("sum", "v")), dict(coded_redundancy=False), 4, None),
    "disabled_requested": (dict(s=("sum", "v")), dict(coded_redundancy=False), 4, True),
    "single_shard": (dict(s=("sum", "v")), {}, 1, None),
    "parity_tasks": (dict(s=("sum", "v")), dict(coded_parity_tasks=3), 6, None),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_policy_decisions_equal_the_reference(case):
    aggs, cfg, nparts, requested = POLICY_CASES[case]
    got = []
    for pkg, po in (("ref", JPO), ("port", TPO)):
        pq, spec, mod = _group_spec(pkg, aggs)
        d = po.decide(pq, spec, mod.DryadConfig(**cfg), nparts, requested=requested)
        got.append((d.apply, d.reason, d.k, d.r, d.key_cols, d.state_cols, d.kind))
    assert got[0] == got[1]


def test_policy_string_key_and_undeclared_decomposable_fall_back_like_the_reference():
    words = {"w": np.array(["a", "b", "c", "a"], object)}
    got = []
    for pkg, po in (("ref", JPO), ("port", TPO)):
        pq, spec, mod = _group_spec(pkg, {"c": ("count", None)}, words)
        d1 = po.decide(pq, spec, mod.DryadConfig(), 4)
        dec = _undeclared(mod)
        q = _ctx(pkg).from_arrays({"k": np.arange(4, dtype=np.int32),
                                   "v": np.ones(4, np.float32)}).group_by("k", decomposable=dec)
        d2 = po.decide(q, ("group_dec", ["k"], dec, q.schema), mod.DryadConfig(), 4)
        got.append((d1.apply, d1.reason, d2.apply, d2.reason))
    assert got[0] == got[1]
    assert "STRING" in got[1][1] and "linear" in got[1][3]


@pytest.mark.parametrize("identity,match", [(None, "identity"), ({"s": 1}, "additive zero")])
def test_linear_decomposable_requires_identity_like_the_reference(identity, match):
    msgs = []
    for mod in (J, T):
        with pytest.raises(ValueError, match=match) as ei:
            mod.Decomposable(seed=_seed_m, merge=_max_state, state_cols=["s"],
                             out_fields=[("s", mod.ColumnType.FLOAT32)], linear=True,
                             identity=identity)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


# -- end to end over the port's worker processes --------------------------------


@pytest.fixture(scope="module")
def submission():
    with LocalJobSubmission(num_workers=2, device="cpu") as sub:
        yield sub


def _int_table(seed=5, n=3000, keys=20):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, keys, n).astype(np.int32),
            "v": rng.integers(-100, 100, n).astype(np.int32)}


def _by_key(t, key="k"):
    order = np.argsort(t[key], kind="stable")
    return {c: np.asarray(v)[order] for c, v in t.items()}


def _kinds_since(sub, mark):
    return [e["kind"] for e in sub.events.events()[mark:]]


def test_coded_group_by_equals_the_reference(submission):
    tbl = _int_table()
    aggs = {"c": ("count", None), "s": ("sum", "v")}
    mark = len(submission.events.events())
    out = submission.submit_partitioned(
        _ctx("port").from_arrays(tbl).group_by("k", aggs), nparts=4, coded=True)
    ref = J.DryadContext(num_partitions_=8).from_arrays(tbl).group_by("k", aggs).collect()
    _equal(_by_key(out), _by_key(ref))
    kinds = _kinds_since(submission, mark)
    for k in ("coded_job_start", "coded_reconstruct", "coded_job_complete"):
        assert k in kinds


def test_coded_scalar_aggregate_equals_the_reference(submission):
    tbl = {"v": np.random.default_rng(13).integers(0, 1000, 3000).astype(np.int32)}
    aggs = {"s": ("sum", "v"), "n": ("count", None)}
    out = submission.submit_partitioned(
        _ctx("port").from_arrays(tbl).aggregate_as_query(aggs), nparts=5, coded=True)
    ref = J.DryadContext(num_partitions_=8).from_arrays(tbl).aggregate_as_query(aggs).collect()
    _equal(out, ref)


def _moments_seed(cols):
    v = cols["v"]
    return {"cnt": v * 0 + 1, "s1": v, "s2": v * v}


def _moments_merge(a, b):
    return {c: a[c] + b[c] for c in ("cnt", "s1", "s2")}


def _moments_finalize_torch(cols):
    import torch

    c = torch.clamp(cols["cnt"], min=1)
    m = cols["s1"] / c
    return {**cols, "var": cols["s2"] / c - m * m}


def _moments_finalize_jnp(cols):
    import jax.numpy as jnp

    c = jnp.maximum(cols["cnt"], 1)
    m = cols["s1"] / c
    return {**cols, "var": cols["s2"] / c - m * m}


def _linear_moments(mod, finalize):
    """The registered "moments" with a finalize that keeps the key
    columns (the in-process reference projects them afterwards)."""
    return mod.Decomposable(
        seed=_moments_seed, merge=_moments_merge, state_cols=["cnt", "s1", "s2"],
        state_fields=[(c, mod.ColumnType.FLOAT32) for c in ("cnt", "s1", "s2")],
        finalize=finalize, out_fields=[("var", mod.ColumnType.FLOAT32)],
        linear=True, identity={"cnt": 0, "s1": 0, "s2": 0},
    )


def test_coded_linear_decomposable_equals_the_reference(submission):
    """The driver runs the port's torch finalize on host columns."""
    rng = np.random.default_rng(23)
    tbl = {"k": rng.integers(0, 9, 2500).astype(np.int32),
           "v": rng.integers(-20, 20, 2500).astype(np.float32)}
    mark = len(submission.events.events())
    out = submission.submit_partitioned(
        _ctx("port").from_arrays(tbl).group_by(
            "k", decomposable=_linear_moments(T, _moments_finalize_torch)),
        nparts=4, coded=True)
    ref = J.DryadContext(num_partitions_=8).from_arrays(tbl).group_by(
        "k", decomposable=_linear_moments(J, _moments_finalize_jnp)).collect()
    a, b = _by_key(out), _by_key(ref)
    assert a["k"].tobytes() == b["k"].tobytes()
    # integer-valued states: exact sums; the finalize rounds like eager
    # ops (ROADMAP section 3, FMA)
    np.testing.assert_allclose(a["var"], b["var"], rtol=1e-6, atol=1e-6)
    assert "coded_job_start" in _kinds_since(submission, mark)


def test_coded_kill_r_of_n_byte_identical_zero_reexecution():
    """Seeded FaultPlan kills (the ``set_fault`` mailbox command) take
    down the workers hosting 2 of the n=5 coded vertices inside their
    stage; the output is byte-identical to the unfailed run, with no
    re-execution in the event stream."""
    tbl = _int_table(9, 4000, 16)
    tbl["v"] = np.random.default_rng(9).integers(-1000, 1000, 4000).astype(np.int32)
    with LocalJobSubmission(num_workers=3, device="cpu") as sub:
        q = _ctx("port").from_arrays(tbl).group_by("k", {"c": ("count", None), "s": ("sum", "v")})
        out_a = sub.submit_partitioned(q, nparts=3, coded=True)
        sub.inject_fault(None, plan={"seed": 7, "worker_kill_prob": 1.0, "max_worker_kills": 1},
                         workers=[1, 2])
        mark = len(sub.events.events())
        out_b = sub.submit_partitioned(q, nparts=3, coded=True)
        _equal(out_a, out_b)
        evs = sub.events.events()[mark:]
        kinds = [e["kind"] for e in evs]
        assert kinds.count("coded_retry") == 0 and kinds.count("vertex_retry") == 0
        rec = [e for e in evs if e["kind"] == "coded_reconstruct"][-1]
        assert rec["exact"] is True and rec["parity_used"] == 2
        assert kinds.count("worker_dead") == 2


def test_registered_finalize_without_keys_fails_in_one_context_like_the_reference():
    """The registered "moments" finalize returns only ``var``: the coded
    path reads its out_fields, but a ``group_by`` in one context then
    lacks its key column, in both packages alike (ROADMAP section 3)."""
    t = {"k": np.arange(100, dtype=np.int32) % 7, "v": np.ones(100, np.float32)}
    errs = []
    for ctx, lin in ((J.DryadContext(num_partitions_=8), J_LINEAR),
                     (T.DryadContext(num_partitions_=8, device="cpu"), T_LINEAR)):
        with pytest.raises(KeyError) as ei:
            ctx.from_arrays(t).group_by("k", decomposable=lin["moments"]).collect()
        errs.append(str(ei.value))
    assert errs[0] == errs[1] == "'k'"
