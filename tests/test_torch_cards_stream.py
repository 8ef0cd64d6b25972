"""Streams on one context over several devices (dryad_tpu_torch):
``from_stream``, ``text_stream`` and ``store_stream`` on ``DryadContext(
devices=...)``, a rank thread a device, as the reference's stream driver
runs on its mesh over ``jax.devices()``.

The ranks run on the CPU (``devices=["cpu"] * D``, D = 2 and 4, over an
in-process gloo group) at P = 8, at the default config (the diagnosis
engine and the runtime plan rewriter on, the pipelined driver, the
async dispatch window, the combine tree).  Each stream case of
``tests/test_torch_outofcore.py`` equals the reference's
``DryadContext(num_partitions_=8)`` on its 8 CPU devices (integers and
sort output byte-equal, float sums within the sort path's
``n_g * 2^-23 * sum|v|``, as that file holds them) with the streaming
driver's events (``stream_*``, ``combine_tree_*``) equal in kind and
count and the same ``diagnosis`` and ``plan_rewrite`` trail, and equals
the one-device port at P = 8 as closely.  Besides: the stream
errors, seeded faults and drain-site retries over the ranks, no chunk
table left in any rank's device cache after a stream, the headroom read
over every card, and the coding tables' upload bytes counted once.
Each test runs under a time limit of its own (``TEST_LIMIT_S``).
"""

import collections
import hashlib
import os
import signal
import threading

import numpy as np
import pytest

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.exec.outofcore import StreamNotSupported as JStreamNotSupported
from dryad_tpu_torch.exec.outofcore import StreamNotSupported as TStreamNotSupported
from dryad_tpu_torch.parallel.partition import GangStageError
from test_torch_outofcore import (
    F32_REL, GROUP_CONFIGS, _cfg, _copy, _group_chunks, _sort_case, assert_byte_equal, by_key,
    rewrite_trail, stream_counts,
)

P = 8
RANKS = [2, 4]
TEST_LIMIT_S = 60


@pytest.fixture(autouse=True)
def time_limit():
    """Each test fails, instead of hanging the run, after TEST_LIMIT_S."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran past its limit of {TEST_LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _port(D, **kw):
    """The port at P = 8: one device (``D=None``) or D rank threads."""
    cfg = T.DryadConfig(**_cfg(**kw))
    if D is None:
        return T.DryadContext(num_partitions_=P, config=cfg, device="cpu")
    return T.DryadContext(num_partitions_=P, devices=["cpu"] * D, config=cfg)


def _ref(**kw):
    return J.DryadContext(num_partitions_=P, config=J.DryadConfig(**_cfg(**kw)))


def _events(c):
    return c.events.events() if isinstance(c, T.DryadContext) else c.executor.events.events()


# -- the cases: each runs its queries in a context and returns its tables ----------

_AGGS = {"s": ("sum", "v"), "c": ("count", None), "mx": ("max", "v"), "mu": ("mean", "v")}


def _group(mode, combine_rows):
    chunks = _group_chunks()

    def run(c, tmp):
        return {"out": c.from_stream(iter(_copy(chunks))).group_by("k", _AGGS).collect()}

    return run, dict(stream_combine_rows=combine_rows, **GROUP_CONFIGS[mode]), "group", ()


def _degrade(mode):
    rng = np.random.default_rng(4)
    if mode == "flat":
        chunks = [{"k": rng.integers(0, 1 << 22, 1200).astype(np.int32),
                   "v": np.ones(1200, np.float32)} for _ in range(3)]
        kw = dict(stream_combine_rows=1000, combine_tree=False)
    else:
        chunks = [{"k": rng.integers(0, 5_000_000, 8000).astype(np.int64),
                   "v": rng.integers(0, 100, 8000).astype(np.int64)} for _ in range(4)]
        kw = dict(stream_combine_rows=4000)

    def run(c, tmp):
        return {"out": c.from_stream(iter(_copy(chunks))).group_by(
            "k", {"c": ("count", None), "s": ("sum", "v")}).collect()}

    return run, kw, "keyed", ()


def _sort(name):
    chunks, keys, kw = _sort_case(name)

    def run(c, tmp):
        return {"out": c.from_stream(iter(_copy(chunks))).order_by(keys).collect()}

    return run, kw, "bytes", ()


def _join_rehash():
    rng = np.random.default_rng(5)
    L = [{"k": np.where(rng.random(2000) < 0.5, 7, rng.integers(0, 100, 2000)).astype(np.int32),
          "a": rng.integers(0, 3, 2000).astype(np.int32)} for _ in range(2)]
    R = [{"k": rng.integers(0, 100, 500).astype(np.int32),
          "b": rng.integers(0, 3, 500).astype(np.int32)} for _ in range(2)]

    def run(c, tmp):
        return {"out": c.from_stream(iter(_copy(L))).join(
            c.from_stream(iter(_copy(R))), ["k"], ["k"]).collect()}

    return run, dict(stream_bucket_rows=2500, stream_buckets=4), "bytes", ()


def _left_join_small():
    rng = np.random.default_rng(6)
    chunks = [{"k": rng.integers(0, 20, 800).astype(np.int32)} for _ in range(3)]
    right = {"k": np.arange(10, dtype=np.int32), "w": np.arange(10, dtype=np.int32) * 3}

    def run(c, tmp):
        return {"out": c.from_stream(iter(_copy(chunks))).left_join(
            c.from_arrays({k: v.copy() for k, v in right.items()}), ["k"], ["k"],
            right_defaults={"w": -1}).collect()}

    return run, {}, "bytes", ()


def _scalar_take(depth):
    rng = np.random.default_rng(7)
    chunks = [{"x": rng.integers(0, 1000, 900).astype(np.int32)} for _ in range(4)]
    aggs = {"s": ("sum", "x"), "mn": ("min", "x"), "mu": ("mean", "x"), "c": ("count", None)}

    def run(c, tmp):
        return {"agg": c.from_stream(iter(_copy(chunks))).aggregate_as_query(aggs).collect(),
                "take": c.from_stream(iter(_copy(chunks))).take(1234).collect()}

    # a take stops the stream early: the prefetcher's pulls are racy
    return (run, dict(stream_pipeline_depth=depth, stream_combine_rows=3), "bytes",
            ("stream_prefetch", "stream_pipeline"))


def _distinct_spill():
    rng = np.random.default_rng(8)
    chunks = [{"x": rng.integers(0, 100_000, 1200).astype(np.int32)} for _ in range(5)]

    def run(c, tmp):
        return {"out": c.from_stream(iter(_copy(chunks))).distinct().collect()}

    return run, dict(stream_bucket_rows=1500, stream_combine_rows=800, stream_buckets=4), \
        "bytes", ()


def _corpus(tmp):
    path = os.path.join(tmp, "corpus.txt")
    if not os.path.exists(path):
        rng = np.random.default_rng(9)
        words = rng.choice([f"word{i}" for i in range(50)], 20000)
        with open(path, "w") as fh:
            fh.write(" ".join(words.tolist()))
    return path


def _wordcount_text():
    def run(c, tmp):
        return {"out": c.text_stream(_corpus(tmp), chunk_bytes=8192).group_by(
            "word", {"c": ("count", None)}).collect()}

    return run, {}, "keyed", ()


def _store_digest(path):
    """Each file of a store and the SHA-1 of its bytes, as a table."""
    names = sorted(os.listdir(path))
    return {"file": np.asarray(names, object),
            "sha": np.asarray([hashlib.sha1(open(os.path.join(path, f), "rb").read()).hexdigest()
                               for f in names], object)}


def _wordcount_store():
    rng = np.random.default_rng(12)
    vocab = np.asarray([f"w{i:03d}" for i in range(80)], object)
    chunks = [{"word": rng.choice(vocab, 900), "n": rng.integers(0, 9, 900).astype(np.int32)}
              for _ in range(4)]

    def run(c, tmp):
        # a stream's to_store (one part file a sorted piece), then the
        # WordCount streamed back from that store, two part files a chunk
        path = os.path.join(tmp, f"store-{id(c)}")
        h = c.to_store(c.from_stream(iter(_copy(chunks))).order_by(["word", "n"]), path)
        out = c.store_stream(path, parts_per_chunk=2).group_by(
            "word", {"c": ("count", None), "s": ("sum", "n")}).collect()
        return {"rows": h.result(), "store": _store_digest(path), "out": out}

    return run, {}, "keyed", ()


def _concat_select_many():
    rng = np.random.default_rng(10)
    a = [{"x": rng.integers(0, 50, 600).astype(np.int32)} for _ in range(2)]
    b = [{"x": rng.integers(50, 99, 600).astype(np.int32)} for _ in range(2)]

    def dup_j(cols):
        import jax.numpy as jnp
        x = cols["x"]
        return {"x": jnp.stack([x, x + 1000], axis=1)}, jnp.stack([x % 2 == 0, x >= 0], axis=1)

    def dup_t(cols):
        import torch
        x = cols["x"]
        return {"x": torch.stack([x, x + 1000], dim=1)}, torch.stack([x % 2 == 0, x >= 0], dim=1)

    def run(c, tmp):
        fn = dup_t if isinstance(c, T.DryadContext) else dup_j
        schema = c.from_arrays({"x": np.zeros(1, np.int32)}).schema
        return {
            "concat": c.from_stream(iter(_copy(a))).concat(c.from_stream(iter(_copy(b))))
            .aggregate_as_query({"c": ("count", None), "s": ("sum", "x")}).collect(),
            "many": c.from_stream(iter(_copy(a))).select_many(fn, 2, schema=schema)
            .order_by(["x"]).collect(),
        }

    return run, {}, "bytes", ()


def _collect_stream():
    rng = np.random.default_rng(11)
    chunks = [{"x": rng.integers(0, 10**6, 2000).astype(np.int32)} for _ in range(4)]

    def run(c, tmp):
        pieces = list(c.from_stream(iter(_copy(chunks))).order_by(["x"]).collect_stream())
        assert len(pieces) > 1
        return {f"piece{i}": p for i, p in enumerate(pieces)}

    return run, {}, "bytes", ()


CASES = {
    **{f"group_{m}_{n}": (lambda m=m, r=r: _group(m, r))
       for m in GROUP_CONFIGS for n, r in (("plain", 2000), ("compacting", 50))},
    "degrade_flat": lambda: _degrade("flat"),
    "degrade_tree": lambda: _degrade("tree"),
    **{f"sort_{n}": (lambda n=n: _sort(n))
       for n in ("resplit", "desc_secondary", "equal_keys", "string", "payload")},
    "grace_join_rehash": _join_rehash,
    "left_join_small_right": _left_join_small,
    "scalar_and_take_depth1": lambda: _scalar_take(1),
    "scalar_and_take_depth4": lambda: _scalar_take(4),
    "distinct_spill": _distinct_spill,
    "wordcount_text_stream": _wordcount_text,
    "wordcount_store_stream": _wordcount_store,
    "concat_select_many": _concat_select_many,
    "collect_stream_pieces": _collect_stream,
}

_RESULTS: dict = {}


def _result(who, name, tmp):
    """``(tables, stream counts, rewrite trail)`` of case ``name`` run by
    ``who`` ("ref", "one" or a rank count), computed once."""
    key = (who, name)
    if key not in _RESULTS:
        run, kw, _kind, skip = CASES[name]()
        c = _ref(**kw) if who == "ref" else _port(None if who == "one" else who, **kw)
        tables = run(c, str(tmp))
        ev = _events(c)
        _RESULTS[key] = (tables, stream_counts(ev, skip), rewrite_trail(ev))
    return _RESULTS[key]


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("cards_stream")


def _same(kind, a, b):
    """Case tables ``b`` held to ``a``: byte-equal, or (``kind`` group)
    integers byte-equal and the float sums within the sort path's bound
    (the ranks reduce a dense float sum in another order)."""
    assert list(a) == list(b)
    for name in a:
        x, y = a[name], b[name]
        if kind in ("group", "keyed"):
            key = "word" if "word" in x else "k"
            if key in x:
                x, y = by_key(x, key), by_key(y, key)
        if kind != "group":
            assert_byte_equal(x, y)
            continue
        for c in ("k", "c", "mx"):
            assert x[c].tobytes() == y[c].tobytes(), c
        allv = np.concatenate([ch["v"] for ch in _group_chunks()]).astype(np.float64)
        allk = np.concatenate([ch["k"] for ch in _group_chunks()])
        av = np.array([np.abs(allv[allk == k]).sum() for k in x["k"]])
        bound = x["c"] * F32_REL * av
        assert (np.abs(y["s"].astype(np.float64) - x["s"]) <= 2 * bound).all()
        assert (np.abs(y["mu"].astype(np.float64) - x["mu"]) <= 2 * bound / x["c"] + 1e-7).all()


@pytest.mark.parametrize("D", RANKS)
@pytest.mark.parametrize("name", list(CASES))
def test_stream_over_ranks_equals_reference_and_one_device(name, D, tmp):
    kind = CASES[name]()[2]
    tables, counts, trail = _result(D, name, tmp)
    rtables, rcounts, rtrail = _result("ref", name, tmp)
    otables, _ocounts, _otrail = _result("one", name, tmp)
    _same(kind, rtables, tables)
    _same(kind, otables, tables)
    assert counts == rcounts
    assert trail == rtrail
    if name.startswith("degrade"):  # the case reaches the host degrade
        assert counts["stream_combine_policy"] or counts["combine_tree_degrade"]


# -- errors, faults and retries over the ranks ---------------------------------------


@pytest.mark.parametrize("D", RANKS)
def test_stream_errors_over_ranks_match_reference(D):
    jc, tc = _ref(), _port(D)
    msgs = []
    for c, exc in ((jc, JStreamNotSupported), (tc, TStreamNotSupported)):
        q = c.from_stream(iter([{"x": np.arange(10, dtype=np.int32)}]))
        with pytest.raises(exc) as ei:
            q.with_rank().collect()
        msgs.append(str(ei.value))
        with pytest.raises(ValueError, match="explicit schema"):
            c.from_stream(iter([]))
    assert msgs[0] == msgs[1]
    outs = []
    for c, mod in ((jc, J), (tc, T)):
        q = c.from_stream(iter([]), mod.Schema([("x", mod.ColumnType.INT32)]))
        outs.append(q.group_by("x", {"c": ("count", None)}).collect())
    assert_byte_equal(*outs)
    assert len(outs[1]["x"]) == 0
    # a tee over one stream and a second collect raise, as the reference's
    s = tc.from_stream(iter([{"x": np.arange(8, dtype=np.int32)},
                             {"x": np.arange(8, 16, dtype=np.int32)}]))
    with pytest.raises(RuntimeError, match="consumed"):
        s.where(lambda cols: cols["x"] % 2 == 0).concat(
            s.where(lambda cols: cols["x"] % 2 == 1)).collect()
    q = tc.from_stream(iter([{"x": np.arange(20, dtype=np.int32)}]))
    assert len(q.take(5).collect()["x"]) == 5
    with pytest.raises(RuntimeError, match="consumed"):
        q.collect()


def _chaos(D, depth, fuse, plan):
    """A stream group_by under a seeded chaos plan at ``dispatch_depth``
    ``depth`` and ``chunk_fuse`` ``fuse`` (integer sums)."""
    from dryad_tpu_torch.exec import faults as TX

    rng = np.random.default_rng(6)
    chunks = [{"k": rng.integers(0, 13, 600).astype(np.int32),
               "v": rng.integers(-9, 9, 600).astype(np.int32)} for _ in range(4)]
    c = _port(D, stream_pipeline_depth=1, dispatch_depth=depth, chunk_fuse=fuse,
              stream_combine_rows=20, max_stage_failures=4, retry_backoff_base=0.002,
              retry_backoff_max=0.02)
    TX.install_plan(plan)
    try:
        out = (c.from_stream(iter(_copy(chunks)))
               .group_by("k", {"s": ("sum", "v"), "n": ("count", None)}).collect())
    finally:
        TX.clear_faults()
    return out, c


@pytest.mark.parametrize("D", RANKS)
def test_seeded_faults_over_ranks_equal_a_clean_run(D):
    """Injected stage failures and delays land on every rank alike (rank
    0 consults the plan and shares it) while the dispatch window holds
    chunks in flight: each is retried inside its budget, and the result
    equals a clean serial run on one device."""
    from dryad_tpu_torch.exec import faults as TX

    plan = TX.FaultPlan(seed=2, stage_failure_prob=0.25, max_failures_per_stage=2,
                        stage_delay_prob=0.2, stage_delay_seconds=0.005)
    chaos, c = _chaos(D, 3, 2, plan)
    clean, _ = _chaos(None, 1, 1, None)
    kinds = [e["kind"] for e in c.events.events()]
    assert "stage_failed" in kinds, "the chaos plan should have fired"
    assert "job_failed" not in kinds
    assert_byte_equal(clean, chaos)


def _async_group(c):
    return (c.from_stream(iter(_copy(_group_chunks(n=4))))
            .group_by("k", {"c": ("count", None), "mx": ("max", "v")}).collect())


_ASYNC = dict(stream_pipeline_depth=1, dispatch_depth=2)


@pytest.mark.parametrize("D", RANKS)
def test_drain_site_retries_over_ranks(D, monkeypatch):
    """A fetch of the async window runs on each rank's thread.  A fault
    every rank raises alike surfaces as itself and is retried serially at
    the drain site, as on one device; a fault of one rank surfaces as
    ``GangStageError`` naming the rank, which no retry hides."""
    from dryad_tpu_torch.columnar.batch import ColumnBatch
    from dryad_tpu_torch.exec.faults import InjectedStageFailure

    clean = _async_group(_port(None, **_ASYNC))
    real = ColumnBatch.fetch_valid_rows

    def failing(ranks):
        fired = set()
        lock = threading.Lock()

        def fetch(self, with_counts=False):
            name = threading.current_thread().name
            with lock:
                fire = name in ranks and name not in fired
                fired.add(name)
            if fire:
                raise InjectedStageFailure("injected at the fetch")
            return real(self, with_counts)

        return fetch, fired

    fetch, fired = failing({f"dryad-rank-{r}" for r in range(D)})
    monkeypatch.setattr(ColumnBatch, "fetch_valid_rows", fetch)
    c = _port(D, **_ASYNC)
    out = _async_group(c)
    assert fired == {f"dryad-rank-{r}" for r in range(D)}
    by = collections.Counter(e["kind"] for e in c.events.events())
    assert by["stream_chunk"] == 4
    windows = [e for e in c.events.events() if e["kind"] == "dispatch_window"]
    assert sum(e["retries"] for e in windows) == 1
    assert_byte_equal(by_key(clean, "k"), by_key(out, "k"))

    fetch, fired = failing({f"dryad-rank-{D - 1}"})
    monkeypatch.setattr(ColumnBatch, "fetch_valid_rows", fetch)
    with pytest.raises(GangStageError, match=f"rank {D - 1} of {D}"):
        _async_group(_port(D, **_ASYNC))


# -- memory: the release, the headroom, the operand uploads --------------------------


@pytest.mark.parametrize("D", RANKS)
def test_no_rank_keeps_a_chunk_table_after_a_stream(D):
    """The driver releases the chunk, bucket and partial tables of every
    rank once their job ran: a stream's device memory does not grow with
    it on any card."""
    c = _port(D)
    chunks = _group_chunks(n=5)
    c.from_stream(iter(_copy(chunks))).group_by("k", {"c": ("count", None)}).collect()
    c.from_stream(iter(_copy(chunks))).order_by(["k"]).collect()
    assert c._ranks.world == D
    for rc in c._ranks.contexts:
        assert not rc._device_cache, (rc.mesh.rank, list(rc._device_cache))
    assert not c._device_cache


def _fake_cards(monkeypatch, readings):
    """Fake per-card memory readings: card i has ``readings[i] = (free,
    total, reserved, allocated)`` bytes."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    idx = lambda d: torch.device(d).index
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: readings[idx(d)][:2])
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: readings[idx(d)][2])
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: readings[idx(d)][3])


def test_headroom_sums_every_card(monkeypatch):
    """A context over several cards reads the used and limit bytes of all
    its cards, summed (the reference sums its local devices); one card
    reads its own; a probe over the CPU takes the host fallback."""
    import torch

    from dryad_tpu_torch.api import context as CTX
    from dryad_tpu_torch.obs.telemetry import ResourceMonitor, device_memory_probe

    G = 1 << 30
    readings = [(70 * G, 80 * G, 2 * G, 1 * G), (10 * G, 80 * G, 0, 0),
                (40 * G, 80 * G, 4 * G, 4 * G), (79 * G, 80 * G, 0, 0)]
    _fake_cards(monkeypatch, readings)
    cards = [torch.device("cuda", i) for i in range(4)]
    used = sum(t - min(t, f + r - a) for f, t, r, a in readings)
    assert device_memory_probe(cards)() == (used, 4 * 80 * G)
    assert device_memory_probe(cards[1])() == (70 * G, 80 * G)
    assert device_memory_probe(["cpu", "cpu"])() is None
    mon = ResourceMonitor(device_memory_fn=device_memory_probe(cards))
    mon.sample()
    assert mon.headroom.headroom_bytes() == 4 * 80 * G - used

    # the context builds its probe over every card, and rebuild_mesh
    # over the cards that remain
    seen = []
    monkeypatch.setattr(CTX, "device_memory_probe", lambda d: seen.append(d) or (lambda: None))
    c = T.DryadContext(num_partitions_=P, devices=["cpu"] * 4)
    assert [str(d) for d in seen[-1]] == ["cpu"] * 4
    c.rebuild_mesh([1, 2])
    assert [str(d) for d in seen[-1]] == ["cpu"] * 2


def test_coding_tables_upload_once_in_the_count(tmp):
    """Each rank's executor keeps its own operand pool (the streaming
    WordCount's coding tables reach every card), and the job's counters,
    rank 0's, count the uploads as the one-device context does."""
    def uploads(D):
        c = _port(D)
        c.text_stream(_corpus(str(tmp)), chunk_bytes=8192).group_by(
            "word", {"c": ("count", None)}).collect()
        pools = [rc.executor.operand_pool for rc in c._ranks.contexts] if D else []
        return c.executor.metrics.total("operand_h2d_bytes"), pools

    one, _ = uploads(None)
    for D in RANKS:
        got, pools = uploads(D)
        assert got == one > 0
        assert len({id(p) for p in pools}) == D
        assert all(p.full_uploads > 0 for p in pools)
