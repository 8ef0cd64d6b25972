"""The event log, the fusion decision and ``explain``: the port
(dryad_tpu_torch, device="cpu") against the JAX package on its 8-device
CPU mesh, at P=8.

Host code, so the tolerance is zero: ``explain()`` texts (and the DOT
and SVG drawings) are equal character for character once node and stage
ids are renumbered in order of first appearance (each package draws ids
from its own counters); event streams are equal in their kinds, their
order and every field but the clocks (``ts``, ``mono``, ``seconds``) and
the ids (``stage``, ``topology``, ``after``, ``before``).
"""

import ast
import itertools
import json
import os
import re

import numpy as np
import pytest

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.exec.events import EventLog as JEventLog
from dryad_tpu.plan.fuse import fuse as jfuse
from dryad_tpu.plan.lower import lower as jlower
from dryad_tpu.tools import explain as jexplain
from dryad_tpu_torch.exec.events import EVENT_KINDS, EVENT_PAYLOADS, EventLog
from dryad_tpu_torch.exec.executor import retry_regions
from dryad_tpu_torch.plan.fuse import fuse
from dryad_tpu_torch.plan.lower import lower as tlower
from dryad_tpu_torch.tools import explain as texplain

P = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "dryad_tpu_torch")

_ID = re.compile(r"(#|\bin|\bstage ?|\bf|\bs)(\d+)")


@pytest.fixture(autouse=True)
def same_id_width(monkeypatch):
    """Both packages draw node and stage ids from counters of the same
    width: explain pads its columns to the longest label, ids included,
    so ids of different digit counts (each counter advanced by whatever
    ran before in the process) would shift the padding."""
    from dryad_tpu.plan import fuse as jfuse_mod
    from dryad_tpu.plan import lower as jlower_mod
    from dryad_tpu.plan import nodes as jnodes
    from dryad_tpu_torch.plan import fuse as tfuse_mod
    from dryad_tpu_torch.plan import lower as tlower_mod
    from dryad_tpu_torch.plan import nodes as tnodes

    for mod in (jnodes, tnodes):
        monkeypatch.setattr(mod, "_ids", itertools.count(10**12))
    # fuse imports the stage counter by name: one counter for all four
    stage_ids = itertools.count(10**6)
    for mod in (jlower_mod, jfuse_mod, tlower_mod, tfuse_mod):
        monkeypatch.setattr(mod, "_stage_ids", stage_ids)


def renumber(text: str) -> str:
    """Node ids (``#N``, DOT ``inN``) and stage/region ids (``stage N``,
    ``stageN``, ``fN``, DOT ``sN``) renumbered in order of first
    appearance, each kind apart."""
    seen = {}

    def sub(m):
        ns = "node" if m.group(1) in ("#", "in") else "stage"
        key = (ns, m.group(2))
        if key not in seen:
            seen[key] = sum(1 for k in seen if k[0] == ns)
        return f"{m.group(1)}{seen[key]}"

    return _ID.sub(sub, text)


def _ctxs(**cfg):
    jc = J.DryadContext(num_partitions_=P, config=J.DryadConfig(**cfg))
    _swap_executor_log(jc)
    tc = T.DryadContext(num_partitions_=P, config=T.DryadConfig(**cfg), device="cpu")
    return jc, tc


def _swap_executor_log(jc):
    """Give the reference's executor a log of its own (its stream apart
    from the context's spans); its diagnosis engine, plan rewriter and
    resource sampler tap the context's log, so they move to the
    executor's, where the stage events they fold now land."""
    jc.executor.events = JEventLog(None)
    for tap in (jc.diagnosis, jc.rewriter, jc.telemetry):
        if tap is not None:
            tap.events = jc.executor.events
            jc.executor.events.add_tap(tap.observe)


def _table(seed=0, n=2000):
    rng = np.random.default_rng(seed)
    return {
        "k": rng.integers(-50, 50, n).astype(np.int32),
        "g": rng.integers(0, 30, n).astype(np.int32),
        "v": rng.standard_normal(n).astype(np.float32),
        "id": np.arange(n, dtype=np.int32),
        "s": np.array([f"s{i}" for i in rng.integers(0, 25, n)], object),
    }


def _right(ctx):
    return ctx.from_arrays({"k": np.arange(-50, 50, 4, dtype=np.int32),
                            "rv": np.arange(25, dtype=np.float32)})


TEXT = "the quick brown fox jumps over the lazy dog the fox"
AGGS = {"c": ("count", None), "sv": ("sum", "v"), "mn": ("min", "k")}

# the parity queries of tests/test_torch_wordcount.py, the join and the
# sort tests
QUERIES = {
    "wordcount": lambda c, t: c.from_text(TEXT).group_by("word", {"n": ("count", None)}),
    "wordcount_top10": lambda c, t: c.from_text(TEXT).group_by("word", {"n": ("count", None)})
    .order_by([("n", True)]).take(10),
    "dense_int": lambda c, t: c.from_arrays(t).group_by("g", {"c": ("count", None), "sv": ("sum", "v")}),
    "dense_explicit": lambda c, t: c.from_arrays(t).group_by("g", {"c": ("count", None), "mv": ("mean", "v")}, dense=30),
    "terasort": lambda c, t: c.from_arrays(t).order_by([("k", False)]),
    "terasort_multikey": lambda c, t: c.from_arrays(t).order_by([("g", False), ("v", True), ("id", False)]),
    "group_by_negative": lambda c, t: c.from_arrays(t).group_by("k", AGGS),
    "group_by_string": lambda c, t: c.from_arrays(t).group_by("s", AGGS),
    "group_by_salt": lambda c, t: c.from_arrays(t).group_by("k", AGGS, salt=3),
    "group_by_order_by": lambda c, t: c.from_arrays(t).group_by("k", AGGS).order_by([("c", True), ("k", False)]),
    "distinct": lambda c, t: c.from_arrays(t).distinct(["g", "k"]),
    "reduced_width": lambda c, t: c.from_arrays(t).order_by([("id", False)]).take(1000)
    .group_by("k", AGGS),
    "join_shuffle": lambda c, t: c.from_arrays(t).join(_right(c), "k", strategy="shuffle"),
    "join_broadcast": lambda c, t: c.from_arrays(t).join(_right(c), "k", strategy="broadcast"),
    "join_auto_then_group": lambda c, t: c.from_arrays(t).join(_right(c), "k", strategy="auto")
    .group_by("g", {"c": ("count", None)}),
    "left_join": lambda c, t: c.from_arrays(t).left_join(_right(c), "k", right_defaults={"rv": -1.0}),
    "semi_anti": lambda c, t: c.from_arrays(t).semi_join(_right(c), "k").concat(
        c.from_arrays(t).anti_join(_right(c), "k")),
    "aggregations_feed_join": lambda c, t: c.from_arrays(t).group_by("k", {"c": ("count", None)}).join(
        c.from_arrays(t).group_by("g", {"m": ("count", None)}, dense=30), "k", "g", strategy="shuffle"),
    "apply_host": lambda c, t: c.from_arrays(t).group_by("k", {"c": ("count", None)})
    .apply_host(lambda cols, i: cols, schema=None),
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_explain_equals_the_reference_up_to_ids(name):
    t = _table()
    jc, tc = _ctxs()
    jq, tq = (QUERIES[name](c, t) for c in (jc, tc))
    ref, port = jexplain.explain(jq), tq.explain()
    assert renumber(port) == renumber(ref)
    assert renumber(texplain.explain_dot(tq)) == renumber(jexplain.explain_dot(jq))
    assert renumber(texplain.explain_svg(tq)) == renumber(jexplain.explain_svg(jq))


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_fuse_regions_are_the_retry_units(name):
    """The executor retries (and logs) the units ``retry_regions``
    forms from the port's fusion decision; their stages are those of
    the regions the reference's decision forms on its own graph, and
    the executor's ``job_start`` names one unit per region."""
    t = _table()
    jc, tc = _ctxs()
    jq, tq = (QUERIES[name](c, t) for c in (jc, tc))
    graph = tlower([tq.node], tc.config, tc.dictionary, P=P)
    report = fuse(graph, tc.config)
    units = [[s.name for s in u] for u in retry_regions(graph, report)]
    jgraph = jlower([jq.node], jc.config, jc.dictionary, P=P)
    _g, jreport = jfuse(jgraph, jc.config)
    assert units == [r["names"] for r in jreport.regions]
    tq.collect()
    (start,) = [e for e in tc.events.events() if e["kind"] == "job_start"]
    assert [u["name"] for u in start["topology"]] == [
        "+".join(dict.fromkeys(tok for n in u for tok in n.split("+"))) for u in units
    ]


def test_renumber_keeps_distinct_ids_distinct():
    a = renumber("#12 <- #9 stage 30 <- input#12 stage31.out0 region f40: [stage30]")
    assert a == "#0 <- #1 stage 0 <- input#0 stage1.out0 region f2: [stage0]"


_SECS = re.compile(r"\d+\.\d+s")
_PCT = re.compile(r"\(\d+%\)")
_QID = re.compile(r"\bq-\d+-\d+")


def mask_analyze(text: str) -> str:
    """An ``explain(analyze=True)`` text with its clocks masked: seconds
    and shares, the qid (each package draws qids from its own counter),
    the two phases only one package or only the clock decides: the
    reference's ``compile`` (the port has no compile step, so its
    ``compile_s`` is 0 and drops out of the phases line) and the
    critical path's ``other``, the residual wall time no span covers;
    and the diagnoses of the wall-clock rules."""
    text = _QID.sub("q-N", _PCT.sub("(X%)", _SECS.sub("Xs", text)))
    text = re.sub(r"compile=Xs\s*", "", text)
    text = re.sub(r"  (compile|other) Xs \(X%\)", "", renumber(text))
    # diagnoses of the rules that fold the wall clock (and their hint
    # lines) are the clock's; "no pathologies" then says nothing
    lines, skip = [], False
    for ln in text.split("\n"):
        m = re.match(r"  \[\w+\] (\w+) ", ln)
        if m and m.group(1) in CLOCK_RULES:
            skip = True
        elif not (skip and ln.startswith("      hint: ")) and ln != "  no pathologies detected":
            skip = False
            lines.append(ln)
    return "\n".join(lines)


def _overflowing(c):
    rng = np.random.default_rng(0)
    t = {"k": rng.integers(-5000, 5000, 4000).astype(np.int32),
         "v": rng.standard_normal(4000).astype(np.float32)}
    return c.from_arrays(t).group_by("k", {"c": ("count", None), "s": ("sum", "v")})


def test_explain_analyze_and_the_obs_panels_name_their_item():
    """``explain(analyze=True)`` and ``explain_diagnoses`` give the
    reference's text, clocks masked: WordCount, then a group_by whose
    exchange overflows at ``shuffle_slack=1.0`` (the second run
    diagnoses ``overflow_loop``); ``explain_lint`` still raises, naming
    its queue item."""
    for cfg, build in (({}, lambda c: c.from_text(TEXT).group_by("word", {"n": ("count", None)})),
                       ({"shuffle_slack": 1.0}, _overflowing)):
        jc = J.DryadContext(num_partitions_=P, config=J.DryadConfig(**cfg))
        tc = T.DryadContext(num_partitions_=P, config=T.DryadConfig(**cfg), device="cpu")
        for _ in range(2):
            ref, port = (build(c).explain(analyze=True) for c in (jc, tc))
            assert mask_analyze(port) == mask_analyze(ref)
            assert "== runtime diagnosis ==" in port and "-- critical path --" in port
        assert mask_analyze(texplain.explain_diagnoses(tc)) == \
            mask_analyze(jexplain.explain_diagnoses(jc))
    assert "[warn] overflow_loop (input+group_by)" in port
    off = T.DryadContext(num_partitions_=P, config=T.DryadConfig(obs_diagnosis=False), device="cpu")
    assert texplain.explain_diagnoses(off) == jexplain.explain_diagnoses(
        J.DryadContext(num_partitions_=P, config=J.DryadConfig(obs_diagnosis=False)))
    with pytest.raises(NotImplementedError, match="queue 1 item 15"):
        texplain.explain_lint()


# -- events ------------------------------------------------------------------------

def _emit_sites():
    """(path:line, kind, keyword names, has **kwargs) of every literal
    ``.emit("kind", ...)`` call in the port."""
    out = []
    for d, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            tree = ast.parse(open(path).read(), path)
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "emit"
                        and node.args and isinstance(node.args[0], ast.Constant)):
                    kws = {k.arg for k in node.keywords if k.arg}
                    star = any(k.arg is None for k in node.keywords)
                    out.append((f"{os.path.relpath(path, ROOT)}:{node.lineno}", node.args[0].value,
                                kws, star))
    return out


def test_every_emitted_kind_is_registered_with_its_fields():
    sites = _emit_sites()
    assert len(sites) >= 15  # the executor's sites are found
    for where, kind, kws, star in sites:
        assert kind in EVENT_KINDS, f"{where}: {kind!r} not in EVENT_KINDS"
        req, opt = EVENT_PAYLOADS[kind]
        assert kws <= set(req) | set(opt), f"{where}: {kind} fields {kws - set(req) - set(opt)}"
        if not star:
            assert set(req) <= kws, f"{where}: {kind} lacks {set(req) - kws}"
    # the executor's _note forwards kind and fields: its callers' kinds
    src = open(os.path.join(PKG, "exec", "executor.py")).read()
    noted = set(re.findall(r'_note\(\s*"([a-z_]+)"', src))
    assert noted and noted <= set(EVENT_KINDS)
    assert set(EVENT_KINDS) == set(EVENT_PAYLOADS)


def _comparable(events, kinds):
    """Events of ``kinds`` without their clock and ids; diagnoses of the
    rules that follow the wall clock left out, the others without the
    qid (each package draws qids from its own counter)."""
    drop = ("ts", "mono", "seconds", "stage", "topology", "after", "before")
    out = []
    for e in events:
        if e["kind"] not in kinds:
            continue
        if e["kind"] == "diagnosis" and e["rule"] in CLOCK_RULES:
            continue
        f = {k: v for k, v in e.items() if k not in drop}
        if e["kind"] == "diagnosis":
            f.pop("qid", None)
        out.append((e["kind"], f))
    return out


def _spans(events):
    """The ``span`` events without their clock (``dur``), their ``qid``,
    ``span_id`` and ``parent_id`` renumbered in order of first
    appearance (each package draws them from its own counters)."""
    ids = {}

    def num(ns, v):
        return None if v is None else ids.setdefault((ns, v), sum(1 for k in ids if k[0] == ns))

    out = []
    for e in events:
        if e["kind"] != "span":
            continue
        f = {k: v for k, v in e.items() if k not in ("ts", "mono", "dur", "stage")}
        f["qid"] = num("q", f.get("qid"))
        f["span_id"] = num("s", f["span_id"])
        f["parent_id"] = num("s", f["parent_id"])
        out.append(f)
    return out


# kinds decided by each package's own wall clock, as ``seconds`` is:
# ``stage_straggler`` flags an attempt slower than the unit's duration
# model (both packages run it; which attempt crosses it is timing), and
# the resource sampler samples at most once a ``telemetry_sample_s``,
# so its ``resource_sample`` count follows the clock (compared by kind
# and source instead)
CLOCK_KINDS = {"span", "stage_straggler", "resource_sample"}
# diagnosis rules that fold durations or rates of the wall clock
CLOCK_RULES = {"straggler", "stall_dominance", "recompile_storm"}


def _samples(events):
    return {(e["kind"], e["source"]) for e in events if e["kind"] == "resource_sample"}


def _assert_streams_equal(tc, jc, kinds):
    """The port's stream equals the reference's executor stream in the
    given kinds, and its spans equal the reference's, which its tracer
    writes to the context's own log (the harness swaps the executor's)."""
    assert _comparable(tc.events.events(), kinds - CLOCK_KINDS) == \
        _comparable(jc.executor.events.events(), kinds - CLOCK_KINDS)
    assert _samples(tc.events.events()) == _samples(jc.executor.events.events())
    spans = _spans(tc.events.events())
    assert spans and all(s["qid"] is not None for s in spans)
    assert spans == _spans(jc.events.events())


def _rng_tables():
    rng = np.random.default_rng(3)
    L = {"k": rng.integers(-50, 50, 3000).astype(np.int32), "lv": np.arange(3000, dtype=np.int32)}
    R = {"k": rng.integers(-50, 50, 2000).astype(np.int32),
         "rv": rng.standard_normal(2000).astype(np.float32)}
    return L, R


RETRYING = {
    # the join's expansion is too small: the region retries twice
    "undersized_join": lambda c, L, R: c.from_arrays(L).order_by([("lv", True)]).join(
        c.from_arrays(R), "k", strategy="shuffle", expansion=2.0),
    # two aggregations feed a join that adapts its width
    "width_adapt": lambda c, L, R: c.from_arrays(L).group_by("k", {"c": ("count", None)}).join(
        c.from_arrays({"d": (np.arange(4000) % 300).astype(np.int32)}).group_by(
            "d", {"m": ("count", None)}, dense=300), "k", "d", strategy="shuffle"),
    # the same with the window off: every unit reads its flag at once
    "no_window": lambda c, L, R: c.from_arrays(L).join(
        c.from_arrays(R), "k", strategy="shuffle", expansion=2.0),
}


@pytest.mark.parametrize("name", sorted(RETRYING))
def test_event_stream_of_a_retrying_query_equals_the_reference(name):
    L, R = _rng_tables()
    jc, tc = _ctxs(**({"overflow_sync_depth": 1} if name == "no_window" else {}))
    outs = [RETRYING[name](c, L, R).collect() for c in (jc, tc)]
    for c in outs[0]:
        np.testing.assert_array_equal(outs[1][c], outs[0][c])
    port = tc.events.events()
    kinds = {e["kind"] for e in port}
    assert {"job_start", "stage_start", "stage_complete", "job_complete"} <= kinds
    assert "stage_overflow" in kinds or "stage_width_adapt" in kinds
    _assert_streams_equal(tc, jc, kinds)
    # the (kind, name, value) view keeps its meaning
    view = [(e["kind"], e["name"], e.get("boost", e.get("nparts"))) for e in port
            if e["kind"] in ("stage_overflow", "stage_width_adapt")]
    assert tc.executor.events == view


def test_do_while_and_apply_host_events_equal_the_reference():
    t = {"x": np.arange(64, dtype=np.int32)}

    def body(q):
        return q.select(lambda c: {"x": c["x"] + 1})

    def cond(q):
        return q.aggregate_as_query({"m": ("max", "x")}).select(lambda c: {"go": c["m"] < 70})

    jc = J.DryadContext(num_partitions_=P, config=J.DryadConfig(do_while_device_auto=False))
    _swap_executor_log(jc)
    tc = T.DryadContext(num_partitions_=P, device="cpu")
    for c in (jc, tc):
        c.from_arrays(t).do_while(body, cond, max_iter=10).apply_host(
            lambda cols, i: cols, schema=None).collect()
    kinds = {e["kind"] for e in tc.events.events()}
    assert {"do_while_iter", "apply_host_start", "apply_host_done"} <= kinds
    _assert_streams_equal(tc, jc, kinds)


def test_event_log_file_is_written_when_a_directory_is_set(tmp_path):
    L, R = _rng_tables()
    tc = T.DryadContext(num_partitions_=P, config=T.DryadConfig(event_log_dir=str(tmp_path)),
                        device="cpu")
    RETRYING["undersized_join"](tc, L, R).collect()
    tc.from_text(TEXT).group_by("word", {"n": ("count", None)}).collect()
    (name,) = os.listdir(tmp_path)
    assert re.fullmatch(r"job-\d+\.jsonl", name)
    lines = [json.loads(x) for x in open(tmp_path / name).read().splitlines()]
    assert lines == [json.loads(json.dumps(e)) for e in tc.events.events()]
    assert all(e["kind"] in EVENT_KINDS for e in lines)
    kinds = [e["kind"] for e in lines]
    assert kinds.count("job_start") == kinds.count("job_complete") == 2
    assert EventLog.load(str(tmp_path / name)) == lines
    mem = T.DryadContext(num_partitions_=P, config=T.DryadConfig(obs_events_mem_cap=2), device="cpu")
    mem.from_text(TEXT).group_by("word", {"n": ("count", None)}).collect()
    assert mem.events.path is None and len(mem.events.events()) == 2 and mem.events.dropped > 0
