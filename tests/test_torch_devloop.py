"""The on-device ``do_while`` of the port (``exec/devloop.py`` through
``exec/executor.py``, device="cpu": the loop program's plain version)
against the JAX package's on-device loop, both at their default
settings (``do_while_device_auto`` on) at P=8.

Each case compares the rows byte for byte and the loop's event
sequence: ``do_while_device_start`` (boost), ``do_while_device_done``
(iters), ``do_while_device_fallback`` (by kind and stage, not by the
words of its reason) and the driver loop's ``do_while_iter`` rounds
after a fallback.  The loop-control kernel's plain twin is held to
numpy over every combination of its flags.  One case shows the known
difference of the CPU: a body that reads a device value on the host
falls back in the reference (and on the card), and runs as a device
loop here (ROADMAP.md, queue 3).
"""

import itertools

import numpy as np
import pytest
import torch

import chip_smoke
import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu_torch.columnar.batch import ColumnBatch
from dryad_tpu_torch.exec import devloop as DL
from dryad_tpu_torch.ops import loopctl as LC

P = 8
KINDS = ("do_while_device_start", "do_while_device_done", "do_while_device_fallback",
         "do_while_iter", "do_while_state_boost", "do_while_max_iter", "stage_overflow")


def _ctxs(**cfg):
    jc = J.DryadContext(num_partitions_=P, config=J.DryadConfig(**cfg))
    tc = T.DryadContext(num_partitions_=P, config=T.DryadConfig(**cfg), device="cpu")
    return jc, tc


def _loop_events(ctx):
    """(kind, stage, boost, iters, iter) of the loop events; stage ids
    are numbered in order of first appearance (each package counts its
    own ids)."""
    ids = {}
    keep = ("boost", "iters", "iter")
    return [(e["kind"], ids.setdefault(e.get("stage"), len(ids))) + tuple(e.get(k) for k in keep)
            for e in ctx.events.events() if e["kind"] in KINDS]


def _assert_same(a, b):
    assert list(a) == list(b)
    for c in a:
        assert a[c].dtype == b[c].dtype, c
        if a[c].dtype == object:  # STRING columns
            assert a[c].tolist() == b[c].tolist(), c
            continue
        np.testing.assert_array_equal(a[c].view(np.uint8), b[c].view(np.uint8), err_msg=c)


def _sorted(out, key):
    order = np.argsort(out[key], kind="stable")
    return {c: v[order] for c, v in out.items()}


# tests/test_executor.py's device-loop body and condition
def _dw_body(q):
    return q.select(lambda c: {"v": c["v"] * 2.0})


def _dw_cond(q):
    return q.aggregate_as_query({"m": ("max", "v")}).select(lambda cols: {"go": cols["m"] < 100.0})


def _count_below(n):
    return lambda q: q.count_as_query().select(lambda c: {"go": c["count"] < n})


LOOPS = {
    # doubles until max >= 100: 1, 2, 3 -> 64, 128, 192 in 6 rounds
    "double": (lambda c: c.from_arrays({"v": np.array([1.0, 2.0, 3.0], np.float32)})
               .do_while(_dw_body, _dw_cond, max_iter=20)),
    # the condition is false at once: the body still runs once
    "body_runs_once": (lambda c: c.from_arrays({"v": np.array([150.0, 7.0], np.float32)})
                       .do_while(_dw_body, _dw_cond, max_iter=20)),
    "max_iter": (lambda c: c.from_arrays({"v": np.array([1.0, 2.0, 3.0], np.float32)})
                 .do_while(_dw_body, _dw_cond, max_iter=3)),
    # a where in the body keeps the carry: rows leave the state
    "where_body": (lambda c: c.from_arrays({"v": np.arange(1, 200, dtype=np.float32)})
                   .do_while(lambda q: q.where(lambda cols: cols["v"] < 150.0)
                             .select(lambda cols: {"v": cols["v"] * 1.5}),
                             _count_below(20), max_iter=30)),
    # select + group_by lowers to one stage that changes the carry:
    # start, fallback, then the driver loop's rounds
    "group_by_body": (lambda c: c.from_arrays({"x": np.arange(3000, dtype=np.int32) % 700})
                      .do_while(lambda q: q.select(lambda cols: {"x": cols["x"] // 2})
                                .group_by("x", {"n": ("count", None)}).project(["x"]),
                                _count_below(40), max_iter=12)),
    # the state doubles each round (select_many): it changes the carry too
    "growing_state": (lambda c: c.from_arrays({"x": np.arange(16, dtype=np.int32)})
                      .do_while(lambda q: q.select_many(_dup, 2), _count_below(100), max_iter=10)),
}


def _dup(cols):
    x = cols["x"]
    if isinstance(x, torch.Tensor):
        return {"x": torch.stack([x, x + 1000], 1)}, torch.ones((x.shape[0], 2), dtype=torch.bool)
    import jax.numpy as jnp

    return {"x": jnp.stack([x, x + 1000], 1)}, jnp.ones((x.shape[0], 2), dtype=jnp.bool_)


@pytest.mark.parametrize("name", sorted(LOOPS))
def test_default_loop_rows_and_events_equal_reference(name):
    jc, tc = _ctxs()
    outs = [LOOPS[name](c).collect() for c in (jc, tc)]
    key = next(iter(outs[0]))
    _assert_same(_sorted(outs[1], key), _sorted(outs[0], key))
    ref, port = _loop_events(jc), _loop_events(tc)
    assert port == ref
    kinds = [e[0] for e in port]
    if name in ("group_by_body", "growing_state"):
        assert kinds[:2] == ["do_while_device_start", "do_while_device_fallback"]
        assert "do_while_iter" in kinds
    else:
        assert kinds == ["do_while_device_start", "do_while_device_done"]
    if name == "double":
        assert port[-1][3] == 6 and max(outs[1]["v"]) == 192.0
    if name == "body_runs_once":
        assert port[-1][3] == 1 and sorted(outs[1]["v"].tolist()) == [14.0, 300.0]
    if name == "max_iter":
        assert port[-1][3] == 3


def test_multi_stage_body_falls_back_without_start():
    """tests/test_executor.py's zip_ body lowers to several stages: the
    lowerer refuses it, so fallback comes with no start."""
    tbl = {"k": np.arange(8, dtype=np.int32), "v": np.ones(8, np.float32)}

    def body(q):
        return q.zip_(q.select(lambda c: dict(c)))

    def cond(q):
        return q.aggregate_as_query({"c": ("count", None)}).select(lambda cols: {"go": cols["c"] < 0})

    jc, tc = _ctxs()
    outs = [c.from_arrays(tbl).do_while(body, cond, max_iter=3, device=True).collect() for c in (jc, tc)]
    _assert_same(_sorted(outs[1], "k"), _sorted(outs[0], "k"))
    ref, port = _loop_events(jc), _loop_events(tc)
    assert port == ref
    assert [e[0] for e in port] == ["do_while_device_fallback", "do_while_iter"]


def test_device_true_with_auto_off():
    """``device=True`` asks for the device loop when the default is off;
    without it the driver loop runs, in both packages."""
    jc, tc = _ctxs(do_while_device_auto=False)
    for device in (True, False):
        mark = [len(c.events.events()) for c in (jc, tc)]
        outs = [c.from_arrays({"v": np.array([1.0, 5.0], np.float32)}).do_while(
            _dw_body, _dw_cond, max_iter=20, device=device).collect() for c in (jc, tc)]
        _assert_same(_sorted(outs[1], "v"), _sorted(outs[0], "v"))
        ref = [e for e in _loop_events(jc)][sum(1 for e in jc.events.events()[:mark[0]] if e["kind"] in KINDS):]
        port = [e for e in _loop_events(tc)][sum(1 for e in tc.events.events()[:mark[1]] if e["kind"] in KINDS):]
        assert port == ref
        kinds = {e[0] for e in port}
        assert ("do_while_device_done" in kinds) is device and ("do_while_iter" in kinds) is not device


def _fabricate(cols):
    out = dict(cols)
    out["w#h0"] = out["w#h0"] ^ 7  # the words leave the dictionary
    return out


def test_string_code_body_miss_raises_as_the_reference():
    """A dense STRING group_by body whose words leave the dictionary:
    the device loop keeps the carry, counts the misses, and the job's
    miss check raises the reference's error."""
    words = np.array([f"w{i % 16}" for i in range(512)])
    msgs = []
    for c in _ctxs():
        state = c.from_arrays({"w": words}).group_by("w", {"c": ("count", None)})
        q = state.do_while(
            lambda q: q.select(_fabricate, schema=q.schema).group_by("w", {"c": ("count", None)}),
            _count_below(0), max_iter=4)
        with pytest.raises(Exception) as ei:
            q.collect()
        msgs.append((type(ei.value).__name__, str(ei.value)))
    assert msgs[1] == msgs[0]
    assert "dense" in msgs[1][1]


def test_string_code_body_without_miss_runs_on_the_device():
    words = np.array([f"w{i % 16}" for i in range(512)])
    outs, evs = [], []
    for c in _ctxs():
        state = c.from_arrays({"w": words}).group_by("w", {"c": ("count", None)})
        outs.append(state.do_while(lambda q: q.group_by("w", {"c": ("count", None)}),
                                   _count_below(0), max_iter=3).collect())
        evs.append(_loop_events(c))
    _assert_same(_sorted(outs[1], "w"), _sorted(outs[0], "w"))
    assert evs[1] == evs[0]


def _host_read_row(cols):
    v = cols["v"]
    s = float(v.sum())  # a device value read on the host
    return {"v": v * 2.0 + s * 0.0}


def test_host_read_in_body_is_a_cpu_difference():
    """A body that reads a device value on the host: the reference's
    trace raises ConcretizationTypeError (a TypeError), so its device
    loop logs start and falls back, and its driver loop, whose stages
    are traced too, raises it.  The port on the card raises it at the
    loop's sync check (``test_host_read_at_the_loop_check_raises_without_
    the_driver_loop``); on the CPU no sync can be seen, so the device
    loop runs the body."""
    jc, tc = _ctxs()
    tbl = {"v": np.array([1.0, 2.0], np.float32)}
    with pytest.raises(TypeError):
        jc.from_arrays(tbl).do_while(
            lambda q: q.select(_host_read_row, schema=q.schema), _dw_cond, max_iter=20).collect()
    assert [e[0] for e in _loop_events(jc)] == [
        "do_while_device_start", "do_while_device_fallback", "do_while_iter"]
    out = tc.from_arrays(tbl).do_while(
        lambda q: q.select(_host_read_row, schema=q.schema), _dw_cond, max_iter=20).collect()
    assert sorted(out["v"].tolist()) == [64.0, 128.0]
    assert [e[0] for e in _loop_events(tc)] == ["do_while_device_start", "do_while_device_done"]


def test_device_loop_is_cached_and_released():
    """The built loop is kept under the reference's key (module-level
    plans share it across runs) and dropped when the executor goes."""
    import gc
    import weakref

    _, tc = _ctxs()
    for _ in range(2):
        tc.from_arrays({"v": np.array([1.0, 2.0], np.float32)}).do_while(
            _dw_body, _dw_cond, max_iter=20).collect()
    assert len(tc.executor._loops) == 2  # the condition's lambda is new each plan build
    prog = weakref.ref(next(iter(tc.executor._loops.values())))
    ex = weakref.ref(tc.executor)
    tc.executor = None
    del tc
    gc.collect()
    assert ex() is None and prog() is None


# -- the loop program and the loop-control kernel's plain twin --------------------

def _batch(x, valid=None):
    x = torch.as_tensor(x)
    return ColumnBatch({"x": x}, torch.ones_like(x, dtype=torch.bool) if valid is None else valid)


def _zero(dtype):
    return torch.zeros((), dtype=dtype)


def test_loop_program_check_refuses_a_carry_change():
    grow = lambda b: (_batch(torch.cat([b.data["x"], b.data["x"]], 1)), _zero(torch.bool), _zero(torch.int64))
    cond = lambda b: (ColumnBatch({"go": torch.ones((2, 1), dtype=torch.bool)}, b.valid[:, :1]), _zero(torch.bool))
    prog = DL.LoopProgram(grow, cond, "go", 5, "cpu")
    with pytest.raises(TypeError, match="carry"):
        prog.check(_batch(torch.zeros((2, 8))))
    retype = lambda b: (_batch(b.data["x"].to(torch.int32)), _zero(torch.bool), _zero(torch.int64))
    with pytest.raises(TypeError, match="carry"):
        DL.LoopProgram(retype, cond, "go", 5, "cpu").check(_batch(torch.zeros((2, 8))))


def test_assign_copies_swapped_and_renamed_columns():
    a, b = torch.arange(4.0).reshape(1, 4), torch.arange(10.0, 14.0).reshape(1, 4)
    carry = ColumnBatch({"a": a.clone(), "b": b.clone()}, torch.ones((1, 4), dtype=torch.bool))
    swapped = ColumnBatch({"a": carry.data["b"], "b": carry.data["a"]}, carry.valid)
    DL._assign(carry, swapped)
    assert torch.equal(carry.data["a"], b) and torch.equal(carry.data["b"], a)


@pytest.mark.parametrize("dtype", [torch.bool, torch.int32, torch.int64, torch.float32, torch.float64])
def test_loop_step_plain_against_numpy(dtype):
    """Every combination of the go value, both overflow flags, the
    stored overflow and the round against max_iter."""
    for go, bovf, covf, old_ovf, i, miss in itertools.product(
            (0, 1), (False, True), (False, True), (0, 1), (0, 3, 4, 9), (0, 5)):
        max_iter = 5
        st = torch.tensor([i, old_ovf, 7, 1], dtype=torch.int64)
        go_col = torch.full((8, 1), go, dtype=dtype)
        LC.loop_step(st, torch.tensor(bovf), torch.tensor(miss, dtype=torch.int64), go_col,
                     torch.tensor(covf), max_iter)
        ni = i + 1
        novf = old_ovf | int(bovf) | int(covf)
        want = np.array([ni, novf, 7 + miss, int(ni < max_iter and go != 0 and novf == 0)])
        np.testing.assert_array_equal(st.numpy(), want)
    assert LC.loop_step.launches == 0  # the plain twin launches nothing


def test_loop_step_checks_its_inputs():
    st = torch.zeros(4, dtype=torch.int64)
    f, m = torch.tensor(False), torch.tensor(0, dtype=torch.int64)
    with pytest.raises(ValueError):
        LC.loop_step(st.to(torch.int32), f, m, torch.ones((1, 1), dtype=torch.bool), f, 3)
    with pytest.raises(ValueError):
        LC.loop_step(st, f, m, torch.ones((1, 1), dtype=torch.float16), f, 3)
    with pytest.raises(ValueError):
        LC.loop_step(st, f, m, torch.ones((1, 1), dtype=torch.bool), f, 3, handle=1)


def test_loop_programs_are_bounded():
    """A plan built with fresh lambdas is a new program each run; the
    executor keeps the most recent LOOP_PROGRAMS and releases the rest."""
    from dryad_tpu_torch.exec import executor as EX

    _, tc = _ctxs()
    for i in range(EX.LOOP_PROGRAMS + 3):
        out = tc.from_arrays({"v": np.array([1.0, 2.0], np.float32)}).do_while(
            lambda q: q.select(lambda c: {"v": c["v"] * 2.0}), _dw_cond, max_iter=20).collect()
        assert sorted(out["v"].tolist()) == [64.0, 128.0]
    assert len(tc.executor._loops) == EX.LOOP_PROGRAMS


def test_host_read_at_the_loop_check_raises_without_the_driver_loop(monkeypatch):
    """On the card the loop's check sees a body that reads a device
    value on the host (``HostReadError``, a ``TypeError``); the executor
    logs the reference's events (the fallback with its reason, the
    driver loop's first round: ``chip_smoke.DL_HOST_READ_KINDS``) and
    raises it, naming the loop's stages, instead of running the driver
    loop, whose stage programs would refuse the same read.  The CPU
    cannot see the read, so the check's verdict is forced here."""
    from dryad_tpu_torch.exec import devloop

    def check(self, current):
        raise devloop.HostReadError("do_while subplan reads a device value on the host")

    monkeypatch.setattr(devloop.LoopProgram, "check", check)
    _, tc = _ctxs()
    with pytest.raises(TypeError, match="reads a device value") as err:
        tc.from_arrays({"v": np.array([1.0, 2.0], np.float32)}).do_while(
            lambda q: q.select(_host_read_row, schema=q.schema), _dw_cond, max_iter=20).collect()
    assert isinstance(err.value, devloop.HostReadError) and "select" in str(err.value)
    assert [e[0] for e in _loop_events(tc)] == chip_smoke.DL_HOST_READ_KINDS
    (fb,) = [e for e in tc.events.events() if e["kind"] == "do_while_device_fallback"]
    assert "reads a device value" in fb["reason"]


def test_the_cards_host_read_events_are_the_references():
    """The events ``chip_smoke.py``'s devloop phase expects of a
    host-reading body on the card, before its ``TypeError``, are the
    reference's: its device loop's start and fallback, then its driver
    loop's first round, whose trace raises."""
    jc, _ = _ctxs()
    with pytest.raises(TypeError):
        jc.from_arrays({"v": np.array([1.0, 2.0], np.float32)}).do_while(
            lambda q: q.select(_host_read_row, schema=q.schema), _dw_cond, max_iter=20).collect()
    kinds = [e["kind"] for e in jc.events.events() if e["kind"].startswith("do_while")]
    assert kinds == chip_smoke.DL_HOST_READ_KINDS
