"""Stage-level fault tolerance: the port (dryad_tpu_torch, device="cpu")
against the JAX package on its 8-device CPU mesh, at P=8, after
tests/test_executor.py:13-70 and the in-process cases of
tests/test_chaos.py.

Tolerance zero: under the same seeded ``FaultPlan`` the two executors
log the same ``stage_start`` / ``stage_failed`` / ``job_failed``
sequences (names, versions, failure kinds, backoffs) and return
byte-equal results (the pipelines aggregate integers, take float
extrema or sort floats); deterministic failures and spent budgets raise
``JobFailedError`` with equal messages and attempt histories; the
duration model, the classifier and the backoff give equal values.
"""

import numpy as np
import pytest

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.exec import failure as JF
from dryad_tpu.exec import faults as JX
from dryad_tpu.exec import stats as JS
from dryad_tpu_torch.exec import failure as TF
from dryad_tpu_torch.exec import faults as TX
from dryad_tpu_torch.exec import stats as TS

P = 8
PKGS = {"ref": (J, JX, {}), "port": (T, TX, {"device": "cpu"})}
CHAOS_CONFIG = dict(max_stage_failures=4, retry_backoff_base=0.002, retry_backoff_max=0.02)
# seeds whose draws fail the first attempt once (1), fail it and delay
# the retry (3), and fail it twice, the plan's cap (4)
SEEDS = [1, 3, 4]
FAILURE_KINDS = ("stage_start", "stage_failed", "job_failed", "stage_delay_injected")


@pytest.fixture(autouse=True)
def clear_port_faults():
    """The port's registry is its own: clear it around every test, as
    conftest's fixture does the reference's."""
    TX.clear_faults()
    yield
    TX.clear_faults()


def _ctx(pkg, **cfg):
    mod, _fx, kw = PKGS[pkg]
    ctx = mod.DryadContext(num_partitions_=P, config=mod.DryadConfig(**cfg), **kw)
    waits = []
    ctx.executor._sleep = waits.append  # record the backoffs, do not wait
    return ctx, waits


def _data(n=800):
    rng = np.random.default_rng(42)
    return {
        "k": rng.integers(0, 13, n).astype(np.int32),
        "i": rng.integers(-50, 50, n).astype(np.int32),
        "v": rng.standard_normal(n).astype(np.float32),
    }


def _pos(c):
    return c["v"] > 0


def _groupby_sort(ctx):
    return (ctx.from_arrays(_data()).group_by("k", {"s": ("sum", "i"), "n": ("count", None)})
            .order_by([("s", True), ("k", False)]))


def _join_agg(ctx):
    rng = np.random.default_rng(7)
    right = {"k": np.arange(13, dtype=np.int32), "w": rng.standard_normal(13).astype(np.float32)}
    return (ctx.from_arrays(_data(600)).join(ctx.from_arrays(right), "k")
            .group_by("k", {"m": ("max", "w"), "n": ("count", None)}))


def _filter_topk(ctx):
    return ctx.from_arrays(_data(500)).where(_pos).order_by([("v", True)]).take(20)


def _keep(cols, _part):
    return cols


def _groupby_host_sort(ctx):
    """Three retry units: the host round trip breaks the fused region."""
    return (ctx.from_arrays(_data()).group_by("k", {"s": ("sum", "i")}).apply_host(_keep)
            .order_by([("s", False), ("k", False)]))


def _groupby(ctx, n=100):
    return ctx.from_arrays(_data(n)).group_by("k", {"n": ("count", None)})


PIPELINES = {"groupby_sort": _groupby_sort, "join_agg": _join_agg, "filter_topk": _filter_topk,
             "groupby_host_sort": _groupby_host_sort}


def _byte_equal(a, b):
    assert set(a) == set(b)
    for c in a:
        va, vb = np.asarray(a[c]), np.asarray(b[c])
        assert va.dtype == vb.dtype and va.tobytes() == vb.tobytes(), c


def _failure_events(ctx):
    keep = ("name", "version", "failure_kind", "backoff", "failures", "error", "reason", "seconds")
    return [(e["kind"],) + tuple((k, e[k]) for k in keep if k in e)
            for e in ctx.events.events() if e["kind"] in FAILURE_KINDS]


def _run(pkg, pipeline, plan=None, **cfg):
    ctx, waits = _ctx(pkg, **{**CHAOS_CONFIG, **cfg})
    q = PIPELINES[pipeline](ctx) if isinstance(pipeline, str) else pipeline(ctx)
    fx = PKGS[pkg][1]
    fx.install_plan(plan(fx) if plan else None)
    try:
        out = q.collect()
    finally:
        fx.install_plan(None)
    return out, ctx, waits


def _chaos_plan(seed):
    return lambda fx: fx.FaultPlan(seed=seed, stage_failure_prob=0.5, max_failures_per_stage=2,
                                   stage_delay_prob=0.4, stage_delay_seconds=0.005)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pipeline", sorted(PIPELINES))
def test_seeded_chaos_matches_the_reference(pipeline, seed):
    runs = {pkg: _run(pkg, pipeline, _chaos_plan(seed)) for pkg in PKGS}
    (jout, jctx, jw), (tout, tctx, tw) = runs["ref"], runs["port"]
    _byte_equal(tout, jout)
    assert _failure_events(tctx) == _failure_events(jctx)
    assert tw == jw  # the same injected delays and seeded backoffs
    kinds = [e["kind"] for e in tctx.events.events()]
    assert "job_failed" not in kinds and "job_complete" in kinds


def test_seeded_chaos_fires_and_replays():
    """Every seed of the suite fails a stage (the plan is not a no-op
    here), one also delays one, and a replay repeats the schedule."""
    kinds = [
        [e[0] for e in _failure_events(_run("port", "groupby_host_sort", _chaos_plan(s))[1])]
        for s in SEEDS
    ]
    assert all("stage_failed" in k for k in kinds)
    assert any("stage_delay_injected" in k for k in kinds)
    a = _failure_events(_run("port", "groupby_host_sort", _chaos_plan(4))[1])
    b = _failure_events(_run("port", "groupby_host_sort", _chaos_plan(4))[1])
    assert a == b


def test_injected_failure_retries_and_succeeds():
    outs = {}
    for pkg, (_m, fx, _k) in PKGS.items():
        fx.set_fake_stage_failure("group_by", 1)
        outs[pkg] = _run(pkg, _groupby)
    _byte_equal(outs["port"][0], outs["ref"][0])
    assert int(outs["port"][0]["n"].sum()) == 100
    assert _failure_events(outs["port"][1]) == _failure_events(outs["ref"][1])
    kinds = [e["kind"] for e in outs["port"][1].events.events()]
    assert "stage_failed" in kinds and "stage_complete" in kinds


def _raises(pkg, stage_count, **cfg):
    ctx, _w = _ctx(pkg, **cfg)
    PKGS[pkg][1].set_fake_stage_failure("group_by", stage_count)
    err = JF.JobFailedError if pkg == "ref" else TF.JobFailedError
    with pytest.raises(err) as ei:
        _groupby(ctx).collect()
    return ei.value, ctx


@pytest.mark.parametrize("case", ["deterministic", "budget"])
def test_terminal_failures_carry_the_reference_history(case):
    """A stable error fails fast on its second identical attempt; varying
    errors spend the whole budget.  Messages, attempt histories and the
    terminal events equal the reference's."""
    cfg = (dict(max_stage_failures=5) if case == "deterministic"
           else dict(max_stage_failures=3, retry_backoff_base=0.001))
    count = -1 if case == "deterministic" else 99
    (je, jctx), (te, tctx) = (_raises(p, count, **cfg) for p in ("ref", "port"))
    assert str(te) == str(je)
    assert [vars(a) for a in te.attempts] == [vars(a) for a in je.attempts]
    assert te.stage == je.stage
    assert _failure_events(tctx) == _failure_events(jctx)
    if case == "deterministic":
        assert len(te.attempts) == 2
        assert [a.kind for a in te.attempts] == ["transient", "deterministic"]
        assert "deterministic" in str(te) and "attempt history" in str(te)
    else:
        assert len(te.attempts) == 3 and "failure budget" in str(te)
        assert all(a.kind == "transient" for a in te.attempts)


def test_stage_statistics_equal_the_reference():
    samples = [1.0, 1.1, 0.9, 1.05, 0.95, 1.0, 1.02, 0.98, 1.0, 1.0, 3.0]
    for floor in (1.5, 2.5):
        js, ts = JS.StageStatistics(3.0, floor), TS.StageStatistics(3.0, floor)
        for d in samples:
            assert ts.outlier_threshold() == js.outlier_threshold()
            assert ts.spare_threshold() == js.spare_threshold()
            assert ts.mean_std() == js.mean_std()
            for x in (0.5, 1.0, 2.0, 5.0):
                assert ts.is_outlier(x) == js.is_outlier(x)
            js.record(d)
            ts.record(d)
    st = TS.StageStatistics(outlier_sigmas=3.0)
    assert st.outlier_threshold() is None
    jw, tw = JS.FailureWindow(10.0), TS.FailureWindow(10.0)
    for t in (0.0, 3.0, 9.0, 12.0, 25.0):
        assert tw.record(t) == jw.record(t)
        assert tw.count(t + 5) == jw.count(t + 5)


def test_classify_and_backoff_equal_the_reference():
    for mod_f in (JF, TF):
        assert mod_f.FailureKind.DETERMINISTIC.value == "deterministic"
    hist = []
    errs = [RuntimeError("a"), RuntimeError("b"), RuntimeError("a"), ValueError("a")]
    for comp_prev in (None, "w0", "w1"):
        for comp in (None, "w0", "w1"):
            jh = [JF.Attempt(1, "RuntimeError", "a", computer=comp_prev)]
            th = [TF.Attempt(1, "RuntimeError", "a", computer=comp_prev)]
            for e in errs:
                assert TF.classify(e, th, comp).value == JF.classify(e, jh, comp).value
    assert TF.classify(RuntimeError("x"), hist).value == "transient"
    for kw in ({}, dict(backoff_base=0.01, backoff_max=0.05, jitter=0.9, seed=7)):
        jp, tp = JF.RetryPolicy(**kw), TF.RetryPolicy(**kw)
        for key in ("group_by", "input+hash_partition+join", "part3"):
            for n in range(1, 8):
                assert tp.backoff(key, n) == jp.backoff(key, n)
                assert tp.exhausted(n) == jp.exhausted(n)


def test_fault_plan_draws_equal_the_reference():
    """The registry's consultation points draw from the plan's seeded
    stream in the same order, so a seeded run fails the same stages."""
    names = ["input+group_by", "group_by+order_by", "join", "input+hash_partition+join"] * 6
    plan = dict(seed=5, stage_failure_prob=0.4, stages=["group_by", "join"],
                stage_delay_prob=0.3, stage_delay_seconds=0.25,
                worker_kill_prob=0.2, max_worker_kills=2)

    def trace(fx):
        fx.clear_faults()
        fx.install_plan(fx.FaultPlan(**plan))
        out = []
        for n in names:
            try:
                fx.registry.maybe_fail(n)
                out.append("ok")
            except fx.InjectedStageFailure as e:
                out.append(str(e))
            out.append(fx.registry.maybe_kill(n))
            out.append(fx.registry.maybe_delay(n))
        fx.install_plan(None)
        return out

    assert trace(TX) == trace(JX)
