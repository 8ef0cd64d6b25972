"""The runtime plan rewriter: the port (``dryad_tpu_torch/rewrite/``, its
hooks in ``exec/outofcore.py`` and ``exec/executor.py``, the context's
wiring and ``JobMetrics``' fold) against the JAX package, after
``tests/test_rewrite.py`` and ``tests/test_rewrite_differential.py``.

Controller units: both packages' controllers fold the same diagnosis
sequence into the same decisions and ``plan_rewrite`` events.
Integration: the same seeded streams run through both packages at the
default config (the diagnosis engine and the rewriter on; the reference
tests' ``diagnose_cooldown_s=0`` where they set it) and with
``plan_rewrite=False``.  Sort outputs are byte-equal in place, join and
group outputs as canonical byte-keyed row multisets; the rewriter's
events are equal in action, phase, rule, subject and mode, the
``stream_bucket_split`` modes equal, and ``JobMetrics``' rewrite folds
equal.
"""

import collections

import numpy as np
import pytest

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.exec.events import EventLog as JLog
from dryad_tpu.obs.metrics import JobMetrics as JMetrics
from dryad_tpu.rewrite import RewriteController as JRC
from dryad_tpu_torch.exec.events import EventLog as TLog
from dryad_tpu_torch.obs.metrics import JobMetrics as TMetrics
from dryad_tpu_torch.rewrite import RewriteController as TRC

P = 8


def _diag(rule, evidence, **kw):
    ev = {"kind": "diagnosis", "rule": rule, "evidence": evidence}
    ev.update(kw)
    return ev


def _skew_ev(bucket=3, depth=0, rows=9000, ratio=6.0):
    return {"source": "stream_spill", "subject": f"spill depth={depth}", "buckets": 8,
            "hot_bucket": bucket, "hot_rows": rows, "mean_rows": rows / ratio, "ratio": ratio}


def _strip(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "mono")} for e in events]


# -- controller units: the same folds, decisions and events -----------------------


def _units():
    """(name, steps): each step is ("observe", event), ("claim", depth),
    ("floor", name), ("pin",), ("retune", window) or ("reset",)."""
    thrash = _diag("combine_thrash", {"flips": 3, "recent_modes": ["host", "device"] * 2})
    return {
        "skew_claim_once": [
            ("observe", _diag("partition_skew", _skew_ev(3, 0))), ("claim", 0), ("claim", 0),
            ("observe", _diag("partition_skew", _skew_ev(3, 0))), ("claim", 0),
            ("observe", _diag("partition_skew", _skew_ev(5, 0))), ("claim", 0),
        ],
        "skew_ignored": [
            ("observe", _diag("partition_skew", {"source": "metrics", "subject": "hist:depth=0",
                                                 "ratio": 9.0})), ("claim", 0),
            ("observe", _diag("partition_skew", _skew_ev(1, 3))), ("claim", 3),
        ],
        "split_fan": [
            ("observe", _diag("partition_skew", _skew_ev(0, ratio=4.0))),
            ("observe", _diag("partition_skew", _skew_ev(1, ratio=100.0))),
            ("observe", _diag("partition_skew", _skew_ev(2, ratio=1e9))), ("claim", 0),
        ],
        "overflow_floor": [("floor", "s1:group_by")] + [
            step for b in (1, 2, 1, 8, 16, 64, 1024)
            for step in (("observe", _diag("overflow_loop", {"overflows": 2, "boost": b},
                                           name="s1:group_by")), ("floor", "s1:group_by"))
        ] + [("floor", "other")],
        "thrash_once": [("pin",), ("observe", thrash), ("pin",), ("observe", thrash), ("pin",)],
        "retune": [("retune", 3), ("retune", -5), ("observe", _diag("hbm_pressure", {}))],
        "malformed": [
            ("observe", {"kind": "diagnosis"}),
            ("observe", {"kind": "diagnosis", "rule": "partition_skew",
                         "evidence": {"source": "stream_spill", "subject": "garbage",
                                      "hot_bucket": "x"}}),
            ("observe", {}), ("claim", 0),
        ],
        "reset": [
            ("observe", _diag("partition_skew", _skew_ev())),
            ("observe", _diag("overflow_loop", {"boost": 2}, name="s")),
            ("observe", thrash), ("retune", 2), ("reset",), ("claim", 0), ("floor", "s"), ("pin",),
        ],
    }


def _drive(rc_cls, log, steps):
    c = rc_cls(events=log)
    log.add_tap(c.observe)  # tapping its own sink must not loop
    out = []
    for step in steps:
        op = step[0]
        if op == "observe":
            c.observe(step[1])
        elif op == "claim":
            out.append([a.event_fields() for a in c.claim_splits(step[1])])
        elif op == "floor":
            out.append(c.boost_floor(step[1]))
        elif op == "pin":
            out.append((c.combine_pin(), c.combine_tree_override(), c.exchange_window_hint()))
        elif op == "retune":
            out.append(c.retune_exchange(step[1]).event_fields())
        elif op == "reset":
            c.reset()
    return out, c.actions(), _strip(log.events())


@pytest.mark.parametrize("name", sorted(_units()))
def test_controller_decisions_and_events_equal_the_reference(name):
    steps = _units()[name]
    assert _drive(TRC, TLog(None), steps) == _drive(JRC, JLog(None), steps)


def test_jobmetrics_folds_rewrite_counts_like_the_reference():
    evs = [
        {"kind": "plan_rewrite", "phase": "decided", "action": "split_bucket",
         "rule": "partition_skew"},
        {"kind": "plan_rewrite", "phase": "decided", "action": "prewiden_palette",
         "rule": "overflow_loop"},
        {"kind": "plan_rewrite", "phase": "applied", "action": "split_bucket",
         "rule": "partition_skew"},
    ]
    t, j = TMetrics.from_events(evs), JMetrics.from_events(evs)
    assert (t.rewrites_decided, t.rewrites_applied) == (2, 1)
    assert (t.rewrites_decided, t.rewrites_applied, t.rewrite_actions) == \
        (j.rewrites_decided, j.rewrites_applied, j.rewrite_actions)


def test_context_wires_the_engine_and_the_rewriter_like_the_reference():
    for kw, has_diag, has_rw in (({}, True, True), ({"plan_rewrite": False}, True, False),
                                 ({"obs_diagnosis": False}, False, False)):
        jc = J.DryadContext(num_partitions_=P, config=J.DryadConfig(**kw))
        tc = T.DryadContext(num_partitions_=P, config=T.DryadConfig(**kw), device="cpu")
        assert (tc.diagnosis is not None, tc.rewriter is not None) == (has_diag, has_rw)
        assert (jc.diagnosis is not None, jc.rewriter is not None) == (has_diag, has_rw)
        assert tc.executor.rewriter is tc.rewriter
    assert T.DryadConfig().plan_rewrite is True


# -- integration: both packages, the same streams ------------------------------------


def _ctxs(rw=True, **kw):
    cfg = dict(stream_bucket_rows=kw.pop("bucket_rows", 4000),
               stream_combine_rows=kw.pop("combine_rows", 2000),
               stream_buckets=kw.pop("buckets", 8), diagnose_cooldown_s=0.0, **kw)
    if not rw:
        cfg["plan_rewrite"] = False
    jc = J.DryadContext(num_partitions_=P, config=J.DryadConfig(**cfg))
    tc = T.DryadContext(num_partitions_=P, config=T.DryadConfig(**cfg), device="cpu")
    return jc, tc


def _trail(events):
    """The rewriter's events (action, phase, rule, subject, mode) and the
    bucket-split modes, with their counts."""
    out = collections.Counter()
    for e in events:
        if e["kind"] == "plan_rewrite":
            out[tuple(e.get(f) for f in ("action", "phase", "rule", "subject", "mode"))] += 1
        elif e["kind"] == "stream_bucket_split":
            out[("stream_bucket_split", e["mode"])] += 1
    return out


def _evs(ctx):
    return ctx.executor.events.events() if isinstance(ctx, J.DryadContext) else ctx.events.events()


def _stream(ctx, chunks):
    return ctx.from_stream(iter([{k: v.copy() for k, v in c.items()} for c in chunks]))


def _canonical_rows(table):
    names = sorted(table)
    cols = [np.asarray(table[n]) for n in names]
    rows = sorted(tuple(str(c[i]).encode() if c.dtype == object
                        else c.dtype.str.encode() + c[i].tobytes() for c in cols)
                  for i in range(len(cols[0]) if cols else 0))
    return names, rows


def _byte_equal(a, b):
    assert set(a) == set(b)
    for c in a:
        assert a[c].dtype == b[c].dtype and a[c].tobytes() == b[c].tobytes(), c


def _both(build, rw=True, seed_ctx=None, exact=True, **kw):
    """Run ``build(ctx)`` in both packages; with ``exact``, equal rewrite
    trails and JobMetrics folds.  Returns (port output, reference output,
    port ctx, reference ctx)."""
    outs, trails, folds = [], [], []
    jc, tc = _ctxs(rw, **kw)
    for c in (tc, jc):
        if seed_ctx is not None:
            seed_ctx(c)
        outs.append(build(c))
        trails.append(_trail(_evs(c)))
        m = (TMetrics if c is tc else JMetrics).from_events(_evs(c))
        folds.append((m.rewrites_decided, m.rewrites_applied, m.rewrite_actions))
    if exact:
        assert trails[0] == trails[1]
        assert folds[0] == folds[1]
    return outs[0], outs[1], tc, jc


def _port_off(build, **kw):
    """``build(ctx)`` in the port alone with ``plan_rewrite=False`` (the
    reference's rewriter-off runs are its own suite's business)."""
    _jc, tc = _ctxs(False, **kw)
    out = build(tc)
    assert not [e for e in _evs(tc) if e["kind"] == "plan_rewrite"]
    return out


def _drift_sort_chunks(seed, nchunks=9, n=1500):
    rng = np.random.default_rng(seed)
    chunks = [{"x": rng.integers(0, 1000, n).astype(np.int64),
               "v": rng.random(n).astype(np.float32)}]
    for _ in range(nchunks - 1):
        chunks.append({"x": rng.integers(0, 20, n).astype(np.int64),
                       "v": rng.random(n).astype(np.float32)})
    return chunks


@pytest.mark.parametrize("cfg", [{}, {"dispatch_depth": 3}, {"stream_pipeline_depth": 1}],
                         ids=["default", "deep_dispatch", "serial"])
def test_skewed_sort_splits_its_hot_bucket_byte_identical(cfg, seed=3):
    """The drift fixture's hot range bucket trips ``partition_skew``; the
    sort driver claims the split at a chunk boundary.  Pipelined, the
    spill writer's thread emits the ``stream_spill`` events the diagnosis
    folds, so whether a split lands before the stream ends (or inside
    the phase-2 re-split of the oversized bucket) follows that thread's
    pace in both packages: there each decides the split and holds its
    bytes; the serial driver applies it, and its trail is the
    reference's, event for event."""
    chunks = _drift_sort_chunks(seed)
    order = np.lexsort([np.concatenate([c["v"] for c in chunks]),
                        np.concatenate([c["x"] for c in chunks])])
    exact = cfg.get("stream_pipeline_depth") == 1

    def build(c):
        return _stream(c, chunks).order_by(["x", "v"]).collect()

    on, jon, tc, jc = _both(build, exact=exact, **cfg)
    off, joff, tc_off, _ = _both(build, rw=False, **cfg)
    for a in (jon, off, joff):
        _byte_equal(on, a)
    np.testing.assert_array_equal(on["x"], np.concatenate([c["x"] for c in chunks])[order])
    for c in (tc, jc):
        trail = _trail(_evs(c))
        assert trail[("split_bucket", "decided", "partition_skew", "spill depth=0", None)], trail
        if exact:
            assert trail[("split_bucket", "applied", "partition_skew", "spill depth=0", None)]
            assert trail[("stream_bucket_split", "rewrite")]
    assert not any(k[0] != "stream_bucket_split" for k in _trail(_evs(tc_off)))
    assert tc.rewriter is not None and tc_off.rewriter is None


def _seed_splits(ctx, buckets=(0, 5)):
    for b in buckets:
        ctx.rewriter.observe(_diag("partition_skew", _skew_ev(bucket=b, depth=0, ratio=6.0,
                                                               rows=9000)))


def test_skewed_join_split_at_the_grace_boundary_same_rows(seed=3):
    rng = np.random.default_rng(seed)

    def chunks(side):
        return [{"k": rng.integers(0, 20000, 1200).astype(np.int64),
                 side: rng.integers(0, 1000, 1200).astype(np.int32)} for _ in range(8)]

    L, R = chunks("a"), chunks("b")

    def build(c):
        return _stream(c, L).join(_stream(c, R), ["k"], ["k"]).collect()

    on, jon, tc, _ = _both(build, seed_ctx=_seed_splits)
    off = _port_off(build)
    for a in (jon, off):
        assert _canonical_rows(on) == _canonical_rows(a)
    assert _trail(_evs(tc))[("split_bucket", "applied", "partition_skew", "spill depth=0", None)] == 2


def _thrash(ctx):
    for mode in ("host", "device", "host", "device", "host"):
        ctx.events.emit("stream_combine_policy", mode=mode, chunks=1)


def _skew_group_chunks(seed, nchunks=4, n=1200):
    rng = np.random.default_rng(seed)
    chunks = []
    for _ in range(nchunks):
        k = np.concatenate([rng.integers(0, 8, n // 2), rng.integers(1000, 40 * n, n - n // 2)])
        rng.shuffle(k)
        chunks.append({"k": k.astype(np.int64),
                       "w": rng.integers(-(2 ** 52), 2 ** 52, n).astype(np.int64)})
    return chunks


@pytest.mark.parametrize("kind", ["pin", "flip"])
def test_combine_thrash_pins_or_flips_the_combiner_byte_identical(kind, seed=3):
    chunks = _skew_group_chunks(seed)
    aggs = {"c": ("count", None), "ws": ("sum", "w")}
    if kind == "pin":
        aggs["f"] = ("first", "w")  # the flat path, where the pin applies

    def build(c):
        return _stream(c, chunks).group_by("k", aggs).collect()

    on, jon, tc, _ = _both(build, seed_ctx=_thrash, combine_tree=False, stream_host_reprobe=2)
    off = _port_off(build, combine_tree=False, stream_host_reprobe=2)
    for a in (jon, off):
        assert _canonical_rows(on) == _canonical_rows(a)
    want = "pin_combine" if kind == "pin" else "flip_combine"
    assert _trail(_evs(tc))[(want, "applied", "combine_thrash", "stream_combine",
                              "host" if kind == "pin" else None)] == 1
    pol = [e for e in _evs(tc) if e["kind"] == "stream_combine_policy"]
    if kind == "pin":
        assert any(e.get("pinned") for e in pol) and not any(e.get("reprobe") for e in pol)


def test_overflow_loop_prewidens_the_next_dispatch_like_the_reference():
    n = 4096
    rng = np.random.default_rng(3)
    tbl = {"k": rng.permutation(n).astype(np.int32) - 1,
           "w": rng.integers(-(2 ** 40), 2 ** 40, n).astype(np.int64)}
    runs = {}
    for rw in (True, False):
        cfg = dict(shuffle_slack=1.0, diagnose_cooldown_s=0.0, plan_rewrite=rw)
        jc = J.DryadContext(num_partitions_=P, config=J.DryadConfig(**cfg))
        tc = T.DryadContext(num_partitions_=P, config=T.DryadConfig(**cfg), device="cpu")
        for c in (jc, tc):
            outs, starts = [], []
            for _ in range(3):
                i0 = len(_evs(c))
                outs.append(c.from_arrays({k: v.copy() for k, v in tbl.items()}).group_by(
                    "k", {"c": ("count", None), "ws": ("sum", "w")}).collect())
                starts.append([(e["name"], e["boost"]) for e in _evs(c)[i0:]
                               if e["kind"] in ("stage_start", "stage_overflow")])
            runs[(rw, c is tc)] = (outs, starts, _trail(_evs(c)))
    for rw in (True, False):
        (t_outs, t_starts, t_trail), (j_outs, j_starts, j_trail) = runs[(rw, True)], runs[(rw, False)]
        assert t_starts == j_starts and t_trail == j_trail
        for a, b in zip(t_outs, j_outs):
            assert _canonical_rows(a) == _canonical_rows(b)
    for a, b in zip(runs[(True, True)][0], runs[(False, True)][0]):
        assert _canonical_rows(a) == _canonical_rows(b)
    t_starts = runs[(True, True)][1]
    assert any(trail[0] == "prewiden_palette" and trail[1] == "applied"
               for trail in runs[(True, True)][2])
    # the last run is born pre-widened: it starts above boost 1 and
    # overflows no more than the first
    assert max(b for _n, b in t_starts[-1]) >= 2
    assert len(t_starts[-1]) <= len(t_starts[0])
    assert not runs[(False, True)][2]


def test_a_natural_combine_thrash_pins_like_the_reference():
    """A stream over a fixed key set on the flat combiner thrashes by
    itself (the layout rule degrades each device merge; two reducing
    host folds re-probe the device): the third flip diagnoses
    combine_thrash and the pin lands mid-stream.  Both packages emit the
    same policy modes, diagnoses and rewrites at the same chunks (the
    reference tests' zero cooldown: the engine's cooldown follows the
    wall clock), and the same rows, "first" included; keys, counts and
    sums equal the rewriter-off run's (a pin may move a key's "first":
    ``chip_smoke.py``'s rewrite phase counts the keys it moved)."""
    rng = np.random.default_rng(0)
    chunks = [{"k": rng.integers(0, 3000, 4000).astype(np.int64),
               "v": rng.integers(0, 100, 4000).astype(np.int64)} for _ in range(16)]
    aggs = {"s": ("sum", "v"), "c": ("count", None), "f": ("first", "v")}
    trails, outs = [], []
    for rw in (True, False):
        cfg = dict(combine_tree=False, stream_host_reprobe=2, stream_combine_rows=6000,
                   diagnose_cooldown_s=0.0, plan_rewrite=rw)
        ctxs = [T.DryadContext(num_partitions_=P, config=T.DryadConfig(**cfg), device="cpu")]
        if rw:  # the reference's rewriter-off run is its own suite's business
            ctxs.append(J.DryadContext(num_partitions_=P, config=J.DryadConfig(**cfg)))
        for c in ctxs:
            out = _stream(c, chunks).group_by("k", aggs).collect()
            trails.append([(e["kind"], e.get("mode"), e.get("chunks"), e.get("action"), e.get("phase"))
                           for e in _evs(c) if e["kind"] in ("stream_combine_policy", "plan_rewrite")
                           or e["kind"] == "diagnosis" and e["rule"] == "combine_thrash"])
            outs.append(_by_key(out))
    t_on, j_on, t_off = trails
    assert t_on == j_on
    assert ("plan_rewrite", "host", None, "pin_combine", "applied") in t_on
    assert ("diagnosis", None, None, None, None) in t_off  # diagnosed, not acted on
    assert not [x for x in t_off if x[0] == "plan_rewrite" and x[3] == "pin_combine"]
    _byte_equal(outs[0], outs[1])
    for c in ("k", "s", "c"):
        assert outs[0][c].tobytes() == outs[2][c].tobytes()


def _by_key(t):
    o = np.argsort(np.asarray(t["k"]), kind="stable")
    return {c: np.asarray(v)[o] for c, v in t.items()}
