"""Stage programs (``exec/programs.py``): each retry unit run as one
cached program per lowering key, with the reference's ``xla_compile``
events and compile accounting.  The port (dryad_tpu_torch,
device="cpu", where a program is the unit's eager function) against the
JAX package on its 8-device CPU mesh, at P=8.

Host code, so the tolerance is zero: the ``xla_compile`` events equal
the reference's in count, stage names, key grouping (each package's key
hashes numbered in order of first appearance) and position among
``stage_start``, ``fused_dispatch``, ``exchange_round``,
``stage_overflow`` and ``stage_width_adapt``; their clocks
(``trace_s``, ``compile_s``) and qids (each package's own counters) are
left out.  The CUDA graphs themselves run only on the card
(``chip_smoke.py``'s ``programs`` phase).
"""

import math
import weakref

import numpy as np
import pytest

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.exec.events import EventLog as JEventLog
from dryad_tpu.obs.metrics import JobMetrics as JMetrics
from dryad_tpu_torch.exec import programs as PR
from dryad_tpu_torch.obs import flightrec
from dryad_tpu_torch.obs.metrics import JobMetrics as TMetrics

P = 8
KINDS = {"stage_start", "fused_dispatch", "xla_compile", "exchange_round", "stage_overflow",
         "stage_width_adapt"}


def _ctxs(**cfg):
    """Both contexts; the reference's executor writes to a log of its
    own (its compiles and stage events apart from the context's spans),
    and its diagnosis engine, plan rewriter and resource sampler tap
    that log, where the stage events they fold now land (as
    ``tests/test_torch_events_explain.py`` does)."""
    jc = J.DryadContext(num_partitions_=P, config=J.DryadConfig(**cfg))
    jc.executor.events = JEventLog(None)
    for tap in (jc.diagnosis, jc.rewriter, jc.telemetry):
        if tap is not None:
            tap.events = jc.executor.events
            jc.executor.events.add_tap(tap.observe)
    tc = T.DryadContext(num_partitions_=P, config=T.DryadConfig(**cfg), device="cpu")
    return jc, tc


def _logs(jc, tc):
    return jc.executor.events.events(), tc.events.events()


def _stream(events):
    """The events of KINDS without clocks, ids and qids, compile keys
    numbered by first appearance."""
    keys: dict = {}
    out = []
    for e in events:
        if e["kind"] not in KINDS:
            continue
        f = {k: v for k, v in e.items()
             if k not in ("ts", "mono", "seconds", "stage", "qid", "trace_s", "compile_s")}
        if e["kind"] == "xla_compile":
            f["key"] = keys.setdefault(e["key"], len(keys))
            f["stage"] = e["stage"]
        out.append((e["kind"], f))
    return out


def _compiles(events):
    return [e for e in events if e["kind"] == "xla_compile"]


def _table(seed=0, n=3000):
    rng = np.random.default_rng(seed)
    return {
        "k": rng.integers(-60, 60, n).astype(np.int32),
        "v": rng.standard_normal(n).astype(np.float32),
        "i": np.arange(n, dtype=np.int32),
        "w": np.array([f"w{j}" for j in rng.integers(0, 40, n)], object),
    }


def _skewed(n=4000):
    rng = np.random.default_rng(7)
    k = rng.integers(-500, 500, n).astype(np.int32)
    k[: int(n * 0.9)] = -7  # one hot key: its partition's bucket past the slack
    return {"k": k, "i": np.arange(n, dtype=np.int32)}


def _right(ctx):
    rng = np.random.default_rng(4)
    return ctx.from_arrays({"k": rng.integers(-60, 60, 1500).astype(np.int32),
                            "r": np.arange(1500, dtype=np.int32)})


# integer aggregates: the sort path's float sums are within a bound of
# the reference's, not byte-equal
AGGS = {"c": ("count", None), "s": ("sum", "i"), "lo": ("min", "v"), "hi": ("max", "v")}

QUERIES = {
    "wordcount": (lambda c: c.from_arrays(_table()).group_by("w", {"n": ("count", None)})
                  .order_by([("n", True), ("w", False)]).take(10), {}),
    "group_by_sort_path": (lambda c: c.from_arrays(_table()).group_by("k", AGGS), {}),
    "terasort": (lambda c: c.from_arrays(_table()).order_by([("k", False), ("i", True)]), {}),
    "join_shuffle": (lambda c: c.from_arrays(_table()).join(_right(c), "k", strategy="shuffle"), {}),
    # an order_by feeding a join: one region of two stages
    "fused_region": (lambda c: c.from_arrays(_table()).order_by([("i", True)]).join(
        _right(c), "k", strategy="shuffle"), {}),
    "fused_region_plan_fuse_off": (lambda c: c.from_arrays(_table()).order_by([("i", True)]).join(
        _right(c), "k", strategy="shuffle"), {"plan_fuse": False}),
    # without the rewriter, whose pre-widening follows the diagnosis
    # cooldown's wall clock: the rerun retries through the same boosts
    "overflow_retry": (lambda c: c.from_arrays(_skewed()).join(_right(c), "k", strategy="shuffle"),
                       {"shuffle_slack": 1.0, "plan_rewrite": False}),
    # two aggregations feed a join that adapts its width
    "width_adapt": (lambda c: c.from_arrays(_table()).group_by("k", {"c": ("count", None)}).join(
        c.from_arrays({"d": (np.arange(4000) % 300).astype(np.int32)}).group_by(
            "d", {"m": ("count", None)}, dense=300), "k", "d", strategy="shuffle"), {}),
    "exchange_window_0": (lambda c: c.from_arrays(_table()).group_by("k", AGGS),
                          {"exchange_window": 0}),
    "exchange_window_1": (lambda c: c.from_arrays(_table()).group_by("k", AGGS),
                          {"exchange_window": 1}),
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_xla_compile_events_equal_the_reference(name):
    """One ``xla_compile`` per new lowering key, in the reference's place
    (after ``stage_start`` / ``fused_dispatch``, before the attempt's
    ``exchange_round`` events); an overflow retry at a new boost is a new
    key; the same query again compiles nothing; ``JobMetrics.
    compile_count`` equals the reference's."""
    build, cfg = QUERIES[name]
    jc, tc = _ctxs(**cfg)
    jq, tq = build(jc), build(tc)
    outs = [q.collect() for q in (jq, tq)]
    for c in outs[0]:
        np.testing.assert_array_equal(outs[1][c], outs[0][c])
    jev, tev = _logs(jc, tc)
    assert _compiles(tev)
    assert _stream(tev) == _stream(jev)
    kinds = {e["kind"] for e in tev}
    if name == "overflow_retry":
        assert "stage_overflow" in kinds
    if name == "width_adapt":
        assert "stage_width_adapt" in kinds
    if name.startswith("fused_region"):
        assert ("fused_dispatch" in kinds) == (name == "fused_region")
    assert TMetrics.from_events(tev).compile_count == JMetrics.from_events(jev).compile_count \
        == len(_compiles(tev))
    n = (len(_compiles(jev)), len(_compiles(tev)))
    for q in (jq, tq):
        q.collect()
    jev, tev = _logs(jc, tc)
    assert (len(_compiles(jev)), len(_compiles(tev))) == n
    assert _stream(tev) == _stream(jev)


def test_metrics_registry_counts_the_compiles():
    jc, tc = _ctxs()
    for c in (jc, tc):
        QUERIES["fused_region"][0](c).collect()

    def counters(reg, name):
        return sorted((dict(lbl)["stage"], v) for (n, lbl), v in reg._counters.items() if n == name)

    assert counters(tc.executor.metrics, "xla_compiles") == \
        counters(jc.executor.metrics, "xla_compiles")
    assert {s for s, _ in counters(tc.executor.metrics, "xla_compile_s")} == \
        {e["stage"] for e in _compiles(tc.events.events())}


def test_fresh_lambdas_raise_a_recompile_storm():
    """A plan rebuilt with a fresh lambda each time is a new key each
    time: every collect compiles, and the diagnosis engine folds the
    port's own events into ``recompile_storm``, as the reference's."""
    found = []
    for pkg in (J, T):
        kw = {} if pkg is J else {"device": "cpu"}
        ctx = pkg.DryadContext(num_partitions_=P, **kw)
        t = _table()
        for i in range(5):
            ctx.from_arrays(t).where(lambda b, i=i: b["k"] > i - 3).group_by(
                "k", {"c": ("count", None)}).collect()
        storms = [e for e in ctx.events.events()
                  if e["kind"] == "diagnosis" and e["rule"] == "recompile_storm"]
        found.append((len(_compiles(ctx.events.events())),
                      sorted({e["evidence"]["subject"] for e in storms})))
    assert found[1] == found[0]
    assert found[1][1], "the port raised no recompile_storm"


def _widening_chunks(nchunks, rows=800, base=50, step=40, seed=0):
    """The reference's widening-vocabulary stream
    (``tests/test_runtime_tables.py``)."""
    rng = np.random.default_rng(seed)
    final = base + (nchunks - 1) * step
    words = np.array([f"w{j:05d}" for j in range(final)])
    return [{"w": rng.choice(words[: base + i * step], rows)} for i in range(nchunks)], final


def _dense_compiles(events):
    return [e for e in events if e["kind"] == "xla_compile" and "group_by" in e["stage"]]


@pytest.mark.parametrize("runtime", [True, False], ids=["runtime_tables", "baked_tables"])
def test_widening_vocabulary_compiles_as_the_reference(runtime):
    """A widening vocabulary over 16 chunks: O(palette tiers) compiles
    with runtime tables, one per chunk baked, and the port's count and
    stage names equal the reference's in both modes."""
    nchunks = 16
    chunks, final = _widening_chunks(nchunks)
    outs, comps = [], []
    for pkg in (J, T):
        kw = {} if pkg is J else {"device": "cpu"}
        ctx = pkg.DryadContext(num_partitions_=P,
                               config=pkg.DryadConfig(stringcode_runtime_tables=runtime), **kw)
        out = ctx.from_stream(iter([dict(c) for c in chunks])).group_by(
            "w", {"c": ("count", None)}).collect()
        order = np.argsort(np.asarray([str(s) for s in out["w"]]))
        outs.append(([str(out["w"][i]) for i in order], np.asarray(out["c"])[order]))
        evs = ctx.executor.events.events() if pkg is J else ctx.events.events()
        comps.append(_dense_compiles(evs))
    assert outs[1][0] == outs[0][0] and np.array_equal(outs[1][1], outs[0][1])
    assert [e["stage"] for e in comps[1]] == [e["stage"] for e in comps[0]]
    if runtime:
        assert len(comps[1]) <= math.ceil(math.log2(final)) + 2
    else:
        assert len([e for e in comps[1] if e["stage"] == "input+group_by"]) >= nchunks - 1


def test_in_core_widening_within_a_tier_reuses_the_program():
    """The in-core twin (``tests/test_runtime_tables.py``): a dictionary
    widened inside its palette domain brings the next job's tables as
    operands, scattered as a delta, and recompiles at most once (a probe
    tier), as the reference."""
    counts = []
    for pkg in (J, T):
        kw = {} if pkg is J else {"device": "cpu"}
        ctx = pkg.DryadContext(num_partitions_=P, config=pkg.DryadConfig(
            stringcode_runtime_tables=True), **kw)
        rng = np.random.default_rng(2)
        n = []
        for width, extra in ((70, 330), (100, 300)):
            w = np.array([f"a{i}" for i in range(width)])
            out = ctx.from_arrays({"w": np.concatenate([w, rng.choice(w, extra)])}).group_by(
                "w", {"c": ("count", None)}).collect()
            assert int(np.asarray(out["c"]).sum()) == 400
            evs = ctx.executor.events.events() if pkg is J else ctx.events.events()
            n.append(len(_dense_compiles(evs)))
        assert n[1] - n[0] <= 1
        assert ctx.executor.operand_pool.delta_scatters > 0
        counts.append(n)
    assert counts[1] == counts[0]


def test_xla_programs_probe_reads_the_cache():
    """The flight recorder's ``xla_programs`` probe is the size of the
    newest executor's program cache, as the reference's."""
    tc = T.DryadContext(num_partitions_=P, device="cpu")
    assert flightrec.sample_shared_probes()["xla_programs"] == 0
    QUERIES["fused_region"][0](tc).collect()
    n = len(tc.executor.programs)
    assert n == len(_compiles(tc.events.events())) > 0
    assert flightrec.sample_shared_probes()["xla_programs"] == n
    tc.executor.programs.clear()
    assert flightrec.sample_shared_probes()["xla_programs"] == 0


def test_programs_are_graphs_only_on_the_card():
    """Decided from the device and the mesh, before any capture: the CPU
    and a gloo group run the eager function."""
    class Mesh:
        def __init__(self, group, world, backend):
            self.group, self.world, self.backend = group, world, backend

    assert not PR.graphs_for("cpu", None)
    assert PR.graphs_for("cuda", None)
    assert PR.graphs_for("cuda", Mesh(None, 1, None))
    assert PR.graphs_for("cuda", Mesh(object(), 1, "nccl"))
    assert not PR.graphs_for("cuda", Mesh(object(), 2, "gloo"))
    assert not PR.graphs_for("cuda", Mesh(object(), 1, "gloo"))
    tc = T.DryadContext(num_partitions_=P, device="cpu")
    assert tc.executor.programs.graphs is False


class _Held(PR.StageProgram):
    """A program that says it holds ``nbytes`` (a graph's buffers and
    pool, which only the card makes)."""

    def __init__(self, nbytes):
        super().__init__(lambda i, t: None, "held", "0", 0.0, [], False, "cpu")
        self.held_bytes = nbytes

    def release(self):
        self.released = True
        super().release()


def test_byte_cap_releases_the_least_recently_used_programs():
    """Over the process's byte budget (here forced through the
    executor's ``programs.max_bytes``), the least recently used programs
    go first; the newest and the running job's stay, and ``evictions``
    counts the released."""
    tc = T.DryadContext(num_partitions_=P, device="cpu")
    cache = tc.executor.programs
    progs = {k: _Held(100) for k in "abcde"}
    for tick, (k, p) in enumerate(progs.items()):
        p.last_used = tick
        cache._progs[(False, k)] = p
    cache.running, cache.job_tick = 1, 4  # "e" belongs to the running job
    cache.max_bytes = 250
    try:
        PR._enforce_budget(keep=progs["a"])
    finally:
        cache.max_bytes = None
    assert sorted(k for _, k in cache._progs) == ["a", "e"]
    assert cache.evictions == 3
    assert all(getattr(progs[k], "released", False) for k in "bcd")
    assert progs["b"].held_bytes == 0
    # over the budget with only the running job's programs left: they stay
    cache.job_tick = 0
    for k in "fg":
        cache._progs[(False, k)] = _Held(200)
    cache.max_bytes = 100
    try:
        PR._enforce_budget(keep=progs["a"])
    finally:
        cache.max_bytes = None
    assert sorted(k for _, k in cache._progs) == ["a", "e", "f", "g"]
    cache.running = 0


@pytest.mark.parametrize("running", [False, True], ids=["idle", "running"])
def test_an_idle_executors_programs_go_under_the_budget(running):
    """Programs are kept whatever the budget only while the job that
    used them runs.  Once it has ended, its executor's programs go
    like any other's when another job's end finds the process over the
    budget (forced through ``programs.max_bytes``); that job's own stay,
    so a job over the budget does not capture everything anew on each
    run."""
    a = T.DryadContext(num_partitions_=P, device="cpu")
    b = T.DryadContext(num_partitions_=P, device="cpu")
    QUERIES["wordcount"][0](a).collect()
    idle = a.executor.programs
    assert idle.running == 0 and len(idle) > 0
    n = len(idle)
    if running:  # a's next job has started and used them again
        idle.begin_job()
        for p in idle._progs.values():
            p.last_used = next(PR._TICK)
    for p in idle._progs.values():
        p.held_bytes = 100  # a graph's buffers (only the card makes them)
    busy = b.executor.programs
    busy.begin_job()
    mine = _Held(100)
    busy._progs[(True, "mine")] = mine
    mine.last_used = next(PR._TICK)
    busy.max_bytes = 150
    try:
        busy.end_job()
    finally:
        busy.max_bytes = None
        if running:
            idle.running = 0
    assert busy._progs == {(True, "mine"): mine} and not getattr(mine, "released", False)
    assert len(idle) == (n if running else 0)
    assert idle.evictions == (0 if running else n)


def test_column_types_get_programs_of_their_own():
    """One query over two tables with the same columns and capacity but
    other column types: one lowering key (the reference's, whose hash
    the events carry), two cache slots, since a program's buffers fix
    the types of what it reads."""
    tc = T.DryadContext(num_partitions_=P, device="cpu")
    for dtype in (np.int32, np.float32):
        out = tc.from_arrays({"x": np.arange(300).astype(dtype)}).take(5).collect()
        assert out["x"].dtype == dtype and len(out["x"]) == 5
    slots = list(tc.executor.programs._progs)
    by_key: dict = {}
    for graphs, key, types in slots:
        by_key.setdefault(key, set()).add(types)
    # the first input's first column's dtype, for each key's slots
    dtypes = [{types[0][0][0][1] for types in ts} for ts in by_key.values() if len(ts) > 1]
    assert {"torch.int32", "torch.float32"} in dtypes
    # each slot compiled once, under its key's hash
    assert len(_compiles(tc.events.events())) == len(slots)


def test_an_evicted_key_compiles_again():
    """After its program is released, a key's next dispatch builds it
    again and logs ``xla_compile`` again (the one place the port's
    compiles may outnumber the reference's, at sizes no CPU test
    reaches)."""
    tc = T.DryadContext(num_partitions_=P, device="cpu")
    q = QUERIES["wordcount"][0](tc)
    q.collect()
    first = [e["stage"] for e in _compiles(tc.events.events())]
    for k in list(tc.executor.programs._progs):
        tc.executor.programs.evict(k)
    assert tc.executor.programs.evictions == len(first)
    q.collect()
    assert [e["stage"] for e in _compiles(tc.events.events())] == first + first


def test_release_drops_the_programs_holding_the_table():
    """``ctx.release`` drops the programs whose buffers hold a copy of
    the released table (on the card, a graph's input buffers)."""
    tc = T.DryadContext(num_partitions_=P, device="cpu")
    pinned = tc.from_arrays(_table()).cache()
    pinned.group_by("k", {"c": ("count", None)}).collect()
    batch = tc._bindings[pinned.node.id][1]
    holder, other = _Held(10), _Held(10)
    holder._sources = [weakref.ref(batch.valid)]
    tc.executor.programs._progs[(True, "holder")] = holder
    tc.executor.programs._progs[(True, "other")] = other
    n = len(tc.executor.programs)
    tc.release(pinned)
    assert getattr(holder, "released", False) and not getattr(other, "released", False)
    assert len(tc.executor.programs) == n - 1


def test_stage_functions_reach_compile_fused():
    """A run of stages is built through ``parallel/stage.py::
    compile_fused``, a lone stage through ``compile_stage``."""
    from dryad_tpu_torch.parallel import stage as STAGE

    calls = []
    real_s, real_f = STAGE.compile_stage, STAGE.compile_fused

    def spy(kind, real):
        def f(mesh, fn):
            calls.append(kind)
            return real(mesh, fn)
        return f

    STAGE.compile_stage, STAGE.compile_fused = spy("stage", real_s), spy("fused", real_f)
    try:
        tc = T.DryadContext(num_partitions_=P, device="cpu")
        QUERIES["fused_region"][0](tc).collect()
        T.DryadContext(num_partitions_=P, device="cpu", config=T.DryadConfig(plan_fuse=False)) \
            .from_arrays(_table()).group_by("k", {"c": ("count", None)}).collect()
    finally:
        STAGE.compile_stage, STAGE.compile_fused = real_s, real_f
    assert "fused" in calls and "stage" in calls
