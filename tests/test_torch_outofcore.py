"""Out-of-core streaming: the port (dryad_tpu_torch, device="cpu")
against the JAX package on its 8-device CPU mesh.

Both packages get the same seeded chunks at P=8 with the reference
tests' small stream config (``stream_bucket_rows=4000``,
``stream_combine_rows=2000``, ``stream_buckets=8``), each case twice:
at the default config (the diagnosis engine and the runtime plan
rewriter on in both packages) and with both off.  Integer results and
sort outputs must be byte-equal, float sums within the sort path's
``n_g * 2^-23 * sum|v|`` of the reference (the port sums in fixed
point), the streaming driver's events (``stream_*`` and
``combine_tree_*`` kinds) equal in kind and count, and the ``diagnosis``
and ``plan_rewrite`` events equal (``rewrite_trail``).
"""

import collections
import os

import numpy as np
import pytest

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.exec.outofcore import StreamNotSupported as JStreamNotSupported
from dryad_tpu_torch.exec.outofcore import StreamNotSupported as TStreamNotSupported

P = 8
F32_REL = 2.0 ** -23


def _cfg(**kw):
    cfg = dict(stream_bucket_rows=4000, stream_combine_rows=2000, stream_buckets=8)
    cfg.update(kw)
    return cfg


# the reference's config, and the port's beside it: the defaults (the
# diagnosis engine and the plan rewriter on) or both off
REF = pytest.mark.parametrize("ref", ["default", "off"])
_OFF = dict(obs_diagnosis=False, plan_rewrite=False)
# diagnosis rules that follow the wall clock
WALL_CLOCK_RULES = ("straggler", "stall_dominance", "recompile_storm")


def _ctxs(ref="off", **kw):
    cfg = _cfg(**kw)
    if ref == "off":
        cfg.update(_OFF)
    jc = J.DryadContext(num_partitions_=P, config=J.DryadConfig(**cfg))
    tc = T.DryadContext(num_partitions_=P, config=T.DryadConfig(**cfg), device="cpu")
    return jc, tc


def rewrite_trail(events):
    """The diagnoses (rule, subject; wall-clock rules left out) and the
    rewriter's decisions and applications (action, phase, rule, subject,
    mode) with their counts, and the ``stream_bucket_split`` modes."""
    out = collections.Counter()
    for e in events:
        if e["kind"] == "diagnosis" and e["rule"] not in WALL_CLOCK_RULES:
            out[("diagnosis", e["rule"], e["evidence"].get("subject"))] += 1
        elif e["kind"] == "plan_rewrite":
            out[("plan_rewrite",) + tuple(e.get(f) for f in ("action", "phase", "rule",
                                                              "subject", "mode"))] += 1
        elif e["kind"] == "stream_bucket_split":
            out[("stream_bucket_split", e["mode"])] += 1
    return out


def _jevents(jc):
    return jc.executor.events.events()


def stream_counts(events, skip=()):
    """Kind -> count of the streaming driver's events."""
    return collections.Counter(
        e["kind"] for e in events
        if e["kind"].startswith(("stream_", "combine_tree_")) and e["kind"] not in skip
    )


def _copy(chunks):
    return [{k: np.array(v, copy=True) for k, v in c.items()} for c in chunks]


def run_both(build, skip=(), ref="off", **kw):
    """``build(ctx)`` -> a query over fresh copies of the chunks; runs
    it in both packages and holds their streaming, diagnosis and
    rewrite events equal."""
    jc, tc = _ctxs(ref, **kw)
    jout = build(jc).collect()
    tout = build(tc).collect()
    assert stream_counts(tc.events.events(), skip) == stream_counts(_jevents(jc), skip)
    assert rewrite_trail(tc.events.events()) == rewrite_trail(_jevents(jc))
    return jout, tout, jc, tc


def assert_byte_equal(a, b):
    assert list(a) == list(b)
    for c in a:
        x, y = np.asarray(a[c]), np.asarray(b[c])
        assert x.dtype == y.dtype, c
        if x.dtype == object:
            assert x.tolist() == y.tolist(), c
        else:
            assert x.tobytes() == y.tobytes(), c


def by_key(out, key):
    o = np.argsort(np.asarray(out[key]), kind="stable")
    return {c: np.asarray(v)[o] for c, v in out.items()}


def _group_chunks(seed=0, n=6, rows=1500, keys=40):
    rng = np.random.default_rng(seed)
    return [
        {"k": rng.integers(0, keys, rows).astype(np.int32),
         "v": rng.random(rows).astype(np.float32)}
        for _ in range(n)
    ]


GROUP_CONFIGS = {
    "tree": {},
    "flat": {"combine_tree": False},
    "serial": {"stream_pipeline_depth": 1, "dispatch_depth": 1},
    "async": {"stream_pipeline_depth": 1, "dispatch_depth": 2},
}


@REF
@pytest.mark.parametrize("combine_rows", [2000, 50], ids=["plain", "compacting"])
@pytest.mark.parametrize("mode", list(GROUP_CONFIGS))
def test_group_partials_match_reference(mode, combine_rows, ref):
    chunks = _group_chunks()
    aggs = {"s": ("sum", "v"), "c": ("count", None), "mx": ("max", "v"), "mu": ("mean", "v")}
    jout, tout, jc, tc = run_both(ref=ref, build=
        lambda c: c.from_stream(iter(_copy(chunks))).group_by("k", aggs),
        stream_combine_rows=combine_rows, **GROUP_CONFIGS[mode],
    )
    j, t = by_key(jout, "k"), by_key(tout, "k")
    for c in ("k", "c", "mx"):
        assert j[c].tobytes() == t[c].tobytes(), c
    allk = np.concatenate([c["k"] for c in chunks])
    allv = np.concatenate([c["v"] for c in chunks]).astype(np.float64)
    av = np.array([np.abs(allv[allk == k]).sum() for k in j["k"]])
    bound = j["c"] * F32_REL * av
    assert (np.abs(t["s"].astype(np.float64) - j["s"]) <= 2 * bound).all()
    assert (np.abs(t["mu"].astype(np.float64) - j["mu"]) <= 2 * bound / j["c"] + 1e-7).all()
    kinds = stream_counts(tc.events.events())
    if combine_rows == 50:
        assert kinds["stream_combine"] or kinds["combine_tree_level"]


@REF
@pytest.mark.parametrize("mode", ["flat", "tree"])
def test_high_cardinality_degrade_matches_reference(mode, ref):
    rng = np.random.default_rng(4)
    if mode == "flat":
        chunks = [{"k": rng.integers(0, 1 << 22, 1200).astype(np.int32),
                   "v": np.ones(1200, np.float32)} for _ in range(3)]
        kw = dict(stream_combine_rows=1000, combine_tree=False)
    else:
        chunks = [{"k": rng.integers(0, 5_000_000, 8000).astype(np.int64),
                   "v": rng.integers(0, 100, 8000).astype(np.int64)} for _ in range(4)]
        kw = dict(stream_combine_rows=4000)
    jout, tout, jc, tc = run_both(ref=ref, build=
        lambda c: c.from_stream(iter(_copy(chunks))).group_by(
            "k", {"c": ("count", None), "s": ("sum", "v")}),
        **kw,
    )
    assert_byte_equal(by_key(jout, "k"), by_key(tout, "k"))
    kinds = stream_counts(tc.events.events())
    if mode == "flat":
        assert kinds["stream_combine_policy"]
    else:
        assert kinds["combine_tree_degrade"]


def _sort_case(name):
    rng = np.random.default_rng(2)
    if name == "resplit":
        first = {"x": rng.integers(0, 10, 2000).astype(np.int32)}
        rest = [{"x": rng.integers(0, 1_000_000, 4000).astype(np.int32)} for _ in range(3)]
        return [first] + rest, [("x", False)], dict(stream_bucket_rows=3000, stream_buckets=4)
    if name == "desc_secondary":
        chunks = [{"a": rng.integers(0, 5, 1200).astype(np.int32),
                   "b": rng.integers(0, 1000, 1200).astype(np.int32)} for _ in range(3)]
        return chunks, [("a", True), "b"], {}
    if name == "equal_keys":
        return [{"x": np.full(1500, 7, np.int32)} for _ in range(3)], ["x"], dict(
            stream_bucket_rows=1000, stream_buckets=4)
    if name == "string":
        vocab = np.array([f"w{i:04d}" for i in range(300)])
        return [{"w": rng.choice(vocab, 1000)} for _ in range(3)], ["w"], {}
    if name == "payload":
        chunks = [{"x": rng.integers(-10**6, 10**6, 1500).astype(np.int32),
                   "p": rng.standard_normal(1500).astype(np.float32)} for _ in range(4)]
        return chunks, ["x", "p"], {}
    raise AssertionError(name)


@REF
@pytest.mark.parametrize("name", ["resplit", "desc_secondary", "equal_keys", "string", "payload"])
def test_external_sort_matches_reference(name, ref):
    chunks, keys, kw = _sort_case(name)
    jout, tout, jc, tc = run_both(ref=ref, build=
        lambda c: c.from_stream(iter(_copy(chunks))).order_by(keys), **kw)
    assert_byte_equal(jout, tout)
    first = keys[0][0] if isinstance(keys[0], tuple) else keys[0]
    flat = np.concatenate([np.asarray(c[first]) for c in chunks])
    expect = np.sort(flat)
    if isinstance(keys[0], tuple) and keys[0][1]:
        expect = expect[::-1]
    assert np.asarray(tout[first]).tolist() == expect.tolist()
    splits = [e for e in tc.events.events() if e["kind"] == "stream_bucket_split"]
    if name == "resplit":
        assert any(e["mode"] == "resplit" for e in splits)
    if name == "equal_keys":
        assert any(e["mode"] == "equal_keys" for e in splits)


@REF
def test_grace_join_hot_key_rehash_matches_reference(ref):
    rng = np.random.default_rng(5)
    L = [{"k": np.where(rng.random(2000) < 0.5, 7, rng.integers(0, 100, 2000)).astype(np.int32),
          "a": rng.integers(0, 3, 2000).astype(np.int32)} for _ in range(2)]
    R = [{"k": rng.integers(0, 100, 500).astype(np.int32),
          "b": rng.integers(0, 3, 500).astype(np.int32)} for _ in range(2)]
    jout, tout, jc, tc = run_both(ref=ref, build=
        lambda c: c.from_stream(iter(_copy(L))).join(c.from_stream(iter(_copy(R))), ["k"], ["k"]),
        stream_bucket_rows=2500, stream_buckets=4,
    )
    assert_byte_equal(jout, tout)
    ridx = collections.defaultdict(list)
    for kk, bb in zip(np.concatenate([d["k"] for d in R]).tolist(),
                      np.concatenate([d["b"] for d in R]).tolist()):
        ridx[kk].append(bb)
    exp = sorted((kk, aa, bb)
                 for kk, aa in zip(np.concatenate([d["k"] for d in L]).tolist(),
                                   np.concatenate([d["a"] for d in L]).tolist())
                 for bb in ridx.get(kk, []))
    assert sorted(zip(tout["k"].tolist(), tout["a"].tolist(), tout["b"].tolist())) == exp
    assert any(e["mode"] == "rehash" for e in tc.events.events()
               if e["kind"] == "stream_bucket_split")


@REF
def test_left_join_small_right_matches_reference(ref):
    rng = np.random.default_rng(6)
    chunks = [{"k": rng.integers(0, 20, 800).astype(np.int32)} for _ in range(3)]
    right = {"k": np.arange(10, dtype=np.int32), "w": np.arange(10, dtype=np.int32) * 3}
    jout, tout, _, _ = run_both(ref=ref, build=
        lambda c: c.from_stream(iter(_copy(chunks))).left_join(
            c.from_arrays({k: v.copy() for k, v in right.items()}), ["k"], ["k"],
            right_defaults={"w": -1}),
    )
    assert_byte_equal(jout, tout)
    allk = np.concatenate([c["k"] for c in chunks])
    exp = sorted((int(k), int(k) * 3 if k < 10 else -1) for k in allk)
    assert sorted(zip(tout["k"].tolist(), tout["w"].tolist())) == exp


@REF
@pytest.mark.parametrize("depth", [1, 4])
def test_scalar_aggregate_and_take_match_reference(depth, ref):
    rng = np.random.default_rng(7)
    chunks = [{"x": rng.integers(0, 1000, 900).astype(np.int32)} for _ in range(4)]
    xs = np.concatenate([c["x"] for c in chunks])
    jout, tout, _, _ = run_both(ref=ref, build=
        lambda c: c.from_stream(iter(_copy(chunks))).aggregate_as_query(
            {"s": ("sum", "x"), "mn": ("min", "x"), "mu": ("mean", "x"), "c": ("count", None)}),
        stream_pipeline_depth=depth, stream_combine_rows=3,
    )
    for c in ("s", "mn", "c"):
        assert jout[c].tobytes() == tout[c].tobytes(), c
    assert int(tout["s"][0]) == int(xs.sum()) and int(tout["mn"][0]) == int(xs.min())
    assert tout["mu"].tobytes() == jout["mu"].tobytes()
    # a take stops the stream early: the prefetcher's pulls are racy
    jt, tt, _, _ = run_both(ref=ref, build=
        lambda c: c.from_stream(iter(_copy(chunks))).take(1234),
        skip=("stream_prefetch", "stream_pipeline"), stream_pipeline_depth=depth,
    )
    assert_byte_equal(jt, tt)
    assert np.array_equal(tt["x"], xs[:1234])


@REF
def test_distinct_high_cardinality_spills_like_reference(ref):
    rng = np.random.default_rng(8)
    chunks = [{"x": rng.integers(0, 100_000, 1200).astype(np.int32)} for _ in range(5)]
    jout, tout, jc, tc = run_both(ref=ref, build=
        lambda c: c.from_stream(iter(_copy(chunks))).distinct(),
        stream_bucket_rows=1500, stream_combine_rows=800, stream_buckets=4,
    )
    assert_byte_equal(jout, tout)
    exp = set(np.concatenate([ch["x"] for ch in chunks]).tolist())
    assert set(tout["x"].tolist()) == exp and len(tout["x"]) == len(exp)
    assert stream_counts(tc.events.events())["stream_distinct_spill"] == 1


def _store_bytes(path):
    return {f: open(os.path.join(path, f), "rb").read() for f in sorted(os.listdir(path))}


@REF
def test_text_stream_and_store_stream_wordcount_match_reference(tmp_path, ref):
    rng = np.random.default_rng(9)
    vocab = [f"word{i}" for i in range(50)]
    words = rng.choice(vocab, 20000)
    path = tmp_path / "corpus.txt"
    path.write_text(" ".join(words.tolist()))
    jout, tout, jc, tc = run_both(ref=ref, build=
        lambda c: c.text_stream(str(path), chunk_bytes=2048).group_by("word", {"c": ("count", None)}))
    assert_byte_equal(by_key(jout, "word"), by_key(tout, "word"))
    got = {str(w): int(c) for w, c in zip(tout["word"], tout["c"])}
    assert got == dict(collections.Counter(words.tolist()))
    # a stream's to_store writes the reference's bytes, and each
    # package streams the other's store back
    chunks = [{"k": rng.integers(0, 60, 1000).astype(np.int32)} for _ in range(4)]
    jc, tc = _ctxs(ref)
    js, ts = str(tmp_path / "j"), str(tmp_path / "t")
    jc.to_store(jc.from_stream(iter(_copy(chunks))).order_by(["k"]), js)
    h = tc.to_store(tc.from_stream(iter(_copy(chunks))).order_by(["k"]), ts)
    assert int(h.result()["rows"][0]) == 4000
    assert _store_bytes(js) == _store_bytes(ts)
    assert stream_counts(tc.events.events()) == stream_counts(_jevents(jc))
    allk = np.concatenate([ch["k"] for ch in chunks])
    for path_ in (js, ts):
        jc2, tc2 = _ctxs(ref)
        aggs = {"c": ("count", None), "s": ("sum", "k")}
        a = jc2.store_stream(path_).aggregate_as_query(aggs).collect()
        b = tc2.store_stream(path_).aggregate_as_query(aggs).collect()
        assert_byte_equal(a, b)
        assert int(b["c"][0]) == len(allk) and int(b["s"][0]) == int(allk.sum())
    assert np.array_equal(tc2.from_store(js).collect()["k"], np.sort(allk))


@REF
def test_concat_and_select_many_match_reference(ref):
    rng = np.random.default_rng(10)
    a = [{"x": rng.integers(0, 50, 600).astype(np.int32)} for _ in range(2)]
    b = [{"x": rng.integers(50, 99, 600).astype(np.int32)} for _ in range(2)]
    jout, tout, _, _ = run_both(ref=ref, build=
        lambda c: c.from_stream(iter(_copy(a))).concat(c.from_stream(iter(_copy(b))))
        .aggregate_as_query({"c": ("count", None), "s": ("sum", "x")}),
    )
    assert_byte_equal(jout, tout)
    assert int(tout["c"][0]) == 2400

    def dup_j(cols):
        import jax.numpy as jnp
        x = cols["x"]
        return {"x": jnp.stack([x, x + 1000], axis=1)}, jnp.stack([x % 2 == 0, x >= 0], axis=1)

    def dup_t(cols):
        import torch
        x = cols["x"]
        return {"x": torch.stack([x, x + 1000], dim=1)}, torch.stack([x % 2 == 0, x >= 0], dim=1)

    def build(c):
        fn = dup_t if isinstance(c, T.DryadContext) else dup_j
        return c.from_stream(iter(_copy(a))).select_many(fn, 2, schema=c.from_arrays(
            {"x": np.zeros(1, np.int32)}).schema).order_by(["x"])

    jout, tout, _, _ = run_both(ref=ref, build=build)
    assert_byte_equal(jout, tout)
    xs = np.concatenate([c["x"] for c in a])
    assert tout["x"].tolist() == sorted(xs[xs % 2 == 0].tolist() + (xs + 1000).tolist())


@REF
def test_stream_errors_match_reference(ref):
    jc, tc = _ctxs(ref)
    msgs = []
    for c, exc in ((jc, JStreamNotSupported), (tc, TStreamNotSupported)):
        q = c.from_stream(iter([{"x": np.arange(10, dtype=np.int32)}]))
        with pytest.raises(exc) as ei:
            q.with_rank().collect()
        msgs.append(str(ei.value))
        with pytest.raises(ValueError, match="explicit schema"):
            c.from_stream(iter([]))
    assert msgs[0] == msgs[1]
    # an explicit schema allows an empty stream
    outs = []
    for c, mod in ((jc, J), (tc, T)):
        q = c.from_stream(iter([]), mod.Schema([("x", mod.ColumnType.INT32)]))
        outs.append(q.group_by("x", {"c": ("count", None)}).collect())
    assert_byte_equal(*outs)
    assert len(outs[1]["x"]) == 0


@REF
def test_tee_and_second_collect_raise_like_reference(ref):
    for c in _ctxs(ref):
        s = c.from_stream(iter([{"x": np.arange(8, dtype=np.int32)},
                                {"x": np.arange(8, 16, dtype=np.int32)}]))
        a = s.where(lambda cols: cols["x"] % 2 == 0)
        b = s.where(lambda cols: cols["x"] % 2 == 1)
        with pytest.raises(RuntimeError, match="consumed"):
            a.concat(b).collect()
        q = c.from_stream(iter([{"x": np.arange(20, dtype=np.int32)},
                                {"x": np.arange(20, 40, dtype=np.int32)}]))
        assert len(q.take(5).collect()["x"]) == 5
        with pytest.raises(RuntimeError, match="consumed"):
            q.collect()


@REF
def test_collect_stream_yields_bounded_pieces_like_reference(ref):
    rng = np.random.default_rng(11)
    chunks = [{"x": rng.integers(0, 10**6, 2000).astype(np.int32)} for _ in range(4)]
    pieces = {}
    for name, c in zip("jt", _ctxs(ref)):
        pieces[name] = list(c.from_stream(iter(_copy(chunks))).order_by(["x"]).collect_stream())
    assert len(pieces["t"]) == len(pieces["j"]) > 1
    for a, b in zip(pieces["j"], pieces["t"]):
        assert_byte_equal(a, b)
    got = np.concatenate([p["x"] for p in pieces["t"]])
    assert np.array_equal(got, np.sort(np.concatenate([c["x"] for c in chunks])))
    # a plan without a stream input yields its whole result once
    tc = T.DryadContext(num_partitions_=P, device="cpu")
    (piece,) = list(tc.from_arrays({"x": np.arange(5, dtype=np.int32)}).collect_stream())
    assert np.array_equal(piece["x"], np.arange(5))


@REF
def test_wordcount_chunk_partial_takes_the_dense_kernel_path(tmp_path, ref):
    """Each chunk's partial of a streaming WordCount lowers, in both
    packages, to ``string_code`` and ``group_reduce_dense`` (the bucket
    kernel's op)."""
    from dryad_tpu.exec.outofcore import _IngestScope as JScope
    from dryad_tpu.plan.lower import lower as jlower
    from dryad_tpu_torch.exec.outofcore import _IngestScope as TScope
    from dryad_tpu_torch.plan.lower import lower as tlower

    path = tmp_path / "c.txt"
    path.write_text("a b a c a b " * 300)
    ops = []
    for c, scope_cls, lower in zip(_ctxs(ref), (JScope, TScope), (jlower, tlower)):
        q = c.text_stream(str(path), chunk_bytes=512)
        chunk = next(iter(c._bindings[q.node.id][1].chunks))
        pq = scope_cls(c).ingest(chunk, q.schema).group_by("word", {"c__p": ("count", None)})
        graph = lower([pq.node], c.config, c.dictionary, P=P)
        ops.append([op.kind for s in graph.stages for op in s.ops])
    assert ops[0] == ops[1]
    assert "string_code" in ops[1] and "group_reduce_dense" in ops[1]


def _stream_chaos_run(depth, fuse, plan):
    """A stream group_by under a seeded chaos plan (the reference's
    tests/test_chaos.py async-window case, integer sums)."""
    from dryad_tpu_torch.exec import faults as TX

    rng = np.random.default_rng(6)
    chunks = [{"k": rng.integers(0, 13, 600).astype(np.int32),
               "v": rng.integers(-9, 9, 600).astype(np.int32)} for _ in range(4)]
    tc = T.DryadContext(num_partitions_=P, device="cpu", config=T.DryadConfig(**_cfg(
        stream_pipeline_depth=1, dispatch_depth=depth, chunk_fuse=fuse, stream_combine_rows=20,
        max_stage_failures=4, retry_backoff_base=0.002, retry_backoff_max=0.02)))
    TX.install_plan(plan)
    try:
        out = (tc.from_stream(iter(_copy(chunks)))
               .group_by("k", {"s": ("sum", "v"), "n": ("count", None)}).collect())
    finally:
        TX.clear_faults()
    return out, tc


def test_stream_under_seeded_faults_equals_a_clean_run():
    """Injected stage failures and delays land while the dispatch window
    holds chunks in flight: each is retried inside its budget and the
    result is byte-equal to a clean serial run."""
    from dryad_tpu_torch.exec import faults as TX

    plan = TX.FaultPlan(seed=2, stage_failure_prob=0.25, max_failures_per_stage=2,
                        stage_delay_prob=0.2, stage_delay_seconds=0.005)
    chaos, tc = _stream_chaos_run(3, 2, plan)
    clean, _ = _stream_chaos_run(1, 1, None)
    kinds = [e["kind"] for e in tc.events.events()]
    assert "stage_failed" in kinds, "the chaos plan should have fired"
    assert "job_failed" not in kinds
    assert set(chaos) == set(clean)
    for c in clean:
        assert chaos[c].dtype == clean[c].dtype and chaos[c].tobytes() == clean[c].tobytes(), c


def test_drain_site_retries_injected_faults_like_the_reference():
    """The dispatcher reruns a fetch that failed with an injected
    (transient) fault serially at the drain site, in submit order, and
    re-raises a terminal ``JobFailedError`` without a rerun
    (``dryad_tpu/exec/outofcore.py:341-352``)."""
    from dryad_tpu_torch.exec.failure import JobFailedError
    from dryad_tpu_torch.exec.faults import InjectedStageFailure
    from dryad_tpu_torch.exec.outofcore import _AsyncDispatcher

    class _FakeCtx:
        # the dispatcher hands each query straight back as its fetch
        def run_to_host_async(self, fetch):
            return fetch

        def run_many_to_host_async(self, fetches):
            return list(fetches)

    def ok(i):
        return lambda: {"i": np.array([i])}

    def boom(exc):
        def fetch():
            raise exc

        return fetch

    retried = []

    def retry(tag):
        retried.append(tag)
        return {"i": np.array([tag])}

    got = []
    dsp = _AsyncDispatcher(_FakeCtx(), 3, 2, retry=retry)
    try:
        for i in range(7):
            dsp.submit(i, boom(InjectedStageFailure("mid-window")) if i == 3 else ok(i))
            got.extend(dsp.ready())
        got.extend(dsp.drain())
    finally:
        dsp.close()
    assert retried == [3]
    assert [(tag, int(t["i"][0])) for tag, t in got] == [(i, i) for i in range(7)]
    assert dsp.win.retries == 1

    dsp2 = _AsyncDispatcher(_FakeCtx(), 3, 1, retry=retry)
    try:
        dsp2.submit(0, boom(JobFailedError("retry budget burned")))
        with pytest.raises(JobFailedError):
            list(dsp2.drain())
    finally:
        dsp2.close()
    assert retried == [3], "terminal failures must not re-dispatch"
