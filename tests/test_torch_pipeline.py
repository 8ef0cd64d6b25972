"""The out-of-core chunk pipeline of the port (``exec/pipeline.py``,
``exec/spill.py`` and the pipelined driver of ``exec/outofcore.py``),
on the CPU.

Port-only behaviour, modelled on the reference's tests/test_pipeline.py:
bounded read-ahead with backpressure, in-order delivery, the spill
writer's order, flush and latched errors, the dispatch window's
submit-order drain, byte-identical results at every pipeline and
dispatch depth, the combine tree on and off, and spill cleanup when the
source, a device job or a spill write fails.  Parity with the JAX
package is tests/test_torch_outofcore.py's.
"""

import collections
import glob
import os
import threading
import time

import numpy as np
import pytest

import dryad_tpu_torch as T
from dryad_tpu_torch.columnar.schema import ColumnType, Schema
from dryad_tpu_torch.exec.executor import GraphExecutor, StageFailedError
from dryad_tpu_torch.exec.pipeline import ChunkPrefetcher, DispatchWindow, prefetched
from dryad_tpu_torch.exec.spill import SpillDir, SpillWriter

P = 8


def make_ctx(depth=4, spill=None, **kw):
    cfg = T.DryadConfig(
        stream_bucket_rows=kw.pop("bucket_rows", 4000),
        stream_combine_rows=kw.pop("combine_rows", 2000),
        stream_buckets=kw.pop("buckets", 8),
        stream_pipeline_depth=depth,
        stream_spill_dir=spill,
        **kw,
    )
    return T.DryadContext(num_partitions_=P, config=cfg, device="cpu")


def _events(c, kind):
    return c.events.filter(kind)


def _sort_chunks(nchunks=4, rows=1500, seed=0):
    rng = np.random.default_rng(seed)
    return [
        {"x": rng.integers(0, 10**6, rows).astype(np.int32),
         "p": rng.standard_normal(rows).astype(np.float32)}
        for _ in range(nchunks)
    ]


def _copy(chunks):
    return [{k: v.copy() for k, v in c.items()} for c in chunks]


# ---- prefetcher -----------------------------------------------------------


def test_prefetcher_inorder_and_backpressure():
    state = {"max_ahead": 0, "produced": 0}
    consumed = [0]

    def src():
        for i in range(50):
            state["produced"] += 1
            state["max_ahead"] = max(state["max_ahead"], state["produced"] - consumed[0])
            yield i

    pf = ChunkPrefetcher(src(), depth=3)
    out = []
    for x in pf:
        time.sleep(0.001)  # a slow consumer: the producer must block
        out.append(x)
        consumed[0] += 1
    assert out == list(range(50))
    assert pf.stats.peak_in_flight <= 3
    assert state["max_ahead"] <= 3 + 1  # +1: the item mid-handoff
    assert pf.stats.produced == pf.stats.consumed == 50


def test_prefetcher_exception_propagates_and_joins():
    class Boom(RuntimeError):
        pass

    def src():
        yield 1
        yield 2
        raise Boom("prefetch died")

    from dryad_tpu_torch.exec.events import EventLog

    log = EventLog(None)
    pf = ChunkPrefetcher(src(), depth=2, events=log, name="t")
    got = []
    with pytest.raises(Boom, match="prefetch died"):
        for x in pf:
            got.append(x)
    assert got == [1, 2]
    pf.close()  # idempotent; the thread joined
    assert not pf._thread.is_alive()
    (err,) = log.filter("stream_pipeline_error")
    assert err["phase"] == "prefetch" and err["failure_kind"] == "transient"
    assert len(log.filter("stream_pipeline")) == 1


def test_prefetcher_early_close_stops_producer():
    pulled = []

    def src():
        for i in range(1000):
            pulled.append(i)
            yield i

    pf = ChunkPrefetcher(src(), depth=2)
    assert next(iter(pf)) == 0
    pf.close()
    assert len(pulled) <= 10  # stopped promptly, far short of the source
    # the generator wrapper closes its prefetcher when abandoned
    gen = prefetched(iter(range(1000)), 2)
    assert next(gen) == 0
    gen.close()
    assert [x for x in prefetched(iter(range(5)), 1)] == list(range(5))


# ---- spill writer ---------------------------------------------------------


def test_spill_writer_order_and_flush(tmp_path):
    ctx = make_ctx()
    sync = SpillDir(ctx.dictionary, root=str(tmp_path / "sync"))
    asyn = SpillDir(ctx.dictionary, root=str(tmp_path / "async"))
    rng = np.random.default_rng(1)
    pieces = [{"v": rng.integers(0, 100, 50).astype(np.int32),
               "s": np.array([f"w{i}" for i in rng.integers(0, 9, 50)], object)}
              for _ in range(12)]
    with SpillWriter(queue_depth=3) as w:
        for p in pieces:
            sync.append(p["v"][0] % 3, p)
            w.submit(asyn, p["v"][0] % 3, p)
        w.flush()
        assert asyn.buckets() == sync.buckets()
        for b in sync.buckets():
            a, s = asyn.read_bucket(b), sync.read_bucket(b)
            assert np.array_equal(a["v"], s["v"]) and a["s"].tolist() == s["s"].tolist()
            assert asyn.bucket_rows(b) == sync.bucket_rows(b)
    sync.cleanup()
    asyn.cleanup()
    assert not os.path.exists(sync.root) and not os.path.exists(asyn.root)


def test_spill_writer_error_latches(tmp_path, monkeypatch):
    from dryad_tpu_torch.exec.events import EventLog

    spill = SpillDir(None, root=str(tmp_path / "s"))
    log = EventLog(None)
    w = SpillWriter(events=log, queue_depth=2)

    def exploding(self, bucket, table):
        raise IOError("disk gone")

    monkeypatch.setattr(SpillDir, "append", exploding)
    try:
        w.submit(spill, 0, {"v": np.arange(10).astype(np.int32)})
        with pytest.raises(IOError, match="disk gone"):
            w.flush()
        w.flush()  # the latched error is raised once
    finally:
        w.close(drain=False)
        spill.cleanup()
    assert [e["phase"] for e in log.filter("stream_pipeline_error")] == ["spill"]
    with pytest.raises(RuntimeError, match="closed"):
        w.submit(spill, 0, {"v": np.arange(3).astype(np.int32)})


# ---- dispatch window ------------------------------------------------------


def test_dispatch_window_drains_in_submit_order_and_delivers_errors():
    from dryad_tpu_torch.exec.events import EventLog

    log = EventLog(None)
    win = DispatchWindow(2, events=log, name="w")
    delays = [0.03, 0.0, 0.01, 0.0]

    def fetch(i):
        def f():
            time.sleep(delays[i])
            if i == 2:
                raise StageFailedError("chunk 2 failed")
            return i
        return f

    for i in range(4):
        win.submit(i, fetch(i))
    got = list(win.drain())
    win.close()
    assert [t for t, _v, _e in got] == [0, 1, 2, 3]
    assert [v for _t, v, _e in got] == [0, 1, None, 3]
    assert isinstance(got[2][2], StageFailedError)
    (summary,) = log.filter("dispatch_window")
    assert summary["dispatches"] == 4 and summary["depth"] == 2
    with pytest.raises(RuntimeError, match="closed"):
        win.submit(9, fetch(0))
    with pytest.raises(ValueError):
        DispatchWindow(0)
    assert DispatchWindow(-1).depth == 2  # adaptive without a measurement


# ---- the pipelined driver: identical bytes at every depth ------------------


def _join_query(c, chunks):
    right = {"x": np.arange(0, 10**6, 997, dtype=np.int32)}
    right["r"] = (right["x"] % 13).astype(np.int32)
    left = c.from_stream(iter(_copy(chunks)))
    return left.join(c.from_stream(iter([right])), ["x"], ["x"])


QUERIES = {
    "sort": lambda c, ch: c.from_stream(iter(_copy(ch))).order_by(["x", "p"]),
    "group": lambda c, ch: c.from_stream(iter(_copy(ch))).select(
        lambda cols: {"k": cols["x"] % 97, "x": cols["x"]},
        schema=Schema([("k", ColumnType.INT32), ("x", ColumnType.INT32)]),
    ).group_by("k", {"c": ("count", None), "s": ("sum", "x"), "m": ("min", "x")}),
    "join": _join_query,
    "distinct": lambda c, ch: c.from_stream(iter(_copy(ch))).select(
        lambda cols: {"x": cols["x"] % 5000},
        schema=Schema([("x", ColumnType.INT32)]),
    ).distinct(),
    "aggregate": lambda c, ch: c.from_stream(iter(_copy(ch))).aggregate_as_query(
        {"s": ("sum", "x"), "mx": ("max", "x"), "c": ("count", None)}),
}


def _bytes(out):
    return {c: np.asarray(v).tobytes() for c, v in out.items()}


@pytest.mark.parametrize("name", list(QUERIES))
def test_pipeline_and_dispatch_depths_byte_identical(name):
    chunks = _sort_chunks(5, 1500, seed=2)
    outs = []
    for depth, dispatch in ((1, 1), (2, 1), (4, 2), (4, 1), (1, 3)):
        c = make_ctx(depth=depth, dispatch_depth=dispatch, combine_rows=500)
        outs.append(_bytes(QUERIES[name](c, chunks).collect()))
    for o in outs[1:]:
        assert o == outs[0]


def test_chunk_fuse_byte_identical():
    chunks = _sort_chunks(6, 1200, seed=3)
    outs = [
        _bytes(QUERIES[q](make_ctx(depth=1, dispatch_depth=2, chunk_fuse=f), chunks).collect())
        for f in (1, 3) for q in ("group", "sort")
    ]
    assert outs[:2] == outs[2:]


def test_combine_tree_on_and_off_identical():
    rng = np.random.default_rng(3)
    chunks = [{"k": rng.integers(0, 30, 900).astype(np.int32),
               "v": rng.integers(-50, 50, 900).astype(np.int32)} for _ in range(6)]
    outs = {}
    for tree in (True, False):
        c = make_ctx(combine_rows=50, combine_tree=tree)
        out = c.from_stream(iter(_copy(chunks))).group_by(
            "k", {"s": ("sum", "v"), "c": ("count", None), "lo": ("min", "v")}).collect()
        o = np.argsort(out["k"])
        outs[tree] = {k: v[o] for k, v in out.items()}
        kind = "combine_tree_level" if tree else "stream_combine"
        assert [e for e in _events(c, kind) if e.get("device")], kind
    assert _bytes(outs[True]) == _bytes(outs[False])


def test_first_aggregate_takes_the_flat_combiner():
    rng = np.random.default_rng(5)
    chunks = [{"k": rng.integers(0, 20, 600).astype(np.int32),
               "v": rng.integers(0, 1000, 600).astype(np.int32)} for _ in range(5)]
    c = make_ctx(combine_rows=50)
    out = c.from_stream(iter(_copy(chunks))).group_by(
        "k", {"f": ("first", "v"), "c": ("count", None)}).collect()
    assert not _events(c, "combine_tree_level")
    assert [e for e in _events(c, "stream_combine") if e.get("device")]
    allk = np.concatenate([ch["k"] for ch in chunks])
    allv = np.concatenate([ch["v"] for ch in chunks])
    for k, f, n in zip(out["k"], out["f"], out["c"]):
        assert n == (allk == k).sum() and f in allv[allk == k]


def test_pipeline_events_and_bounded_inflight():
    c = make_ctx(depth=3)
    out = c.from_stream(iter(_sort_chunks(5, 1200, seed=5))).order_by(["x"]).collect()
    assert len(out["x"]) == 6000
    pf = _events(c, "stream_prefetch")
    assert pf and max(e["in_flight"] for e in pf) <= 3
    summaries = _events(c, "stream_pipeline")
    assert summaries and all(e["depth"] == 3 for e in summaries)
    spans = [e for e in _events(c, "span") if e["cat"] == "spill"]
    assert spans and all(e["bytes"] > 0 for e in spans)
    (metrics,) = _events(c, "metrics")
    assert "h2d_bytes" in {m["name"] for m in metrics["counters"]}
    assert "partition_rows" in {h["name"] for h in metrics["hists"]}


def test_stream_bindings_are_released():
    """Chunk, bucket and partial tables bound by the driver do not
    outlive their jobs: after a run only the stream binding is left."""
    for q in ("sort", "group", "join"):
        c = make_ctx(combine_rows=300)
        before = set(c._bindings)
        QUERIES[q](c, _sort_chunks(4, 1500, seed=6)).collect()
        left = {nid: b[0] for nid, b in c._bindings.items() if nid not in before}
        assert set(left.values()) <= {"stream"}, (q, left)
        assert not c._device_cache, q


def test_distinct_empty_stream_schema_dtypes():
    c = make_ctx()
    q = c.from_stream(iter([]), Schema([("a", ColumnType.INT32), ("s", ColumnType.STRING)]))
    out = q.distinct().collect()
    assert len(out["a"]) == 0 and len(out["s"]) == 0
    assert out["a"].dtype == np.int32 and out["s"].dtype == object


def test_ingest_does_not_mutate_node_params():
    from dryad_tpu_torch.exec.outofcore import _IngestScope

    ctx = make_ctx(depth=1)
    scope = _IngestScope(ctx)
    schema = Schema([("w", ColumnType.STRING)])
    q1 = scope.ingest({"w": np.array(["a", "b"], object)}, schema)
    snap = q1.node.params["str_vocab"]["w"].copy()
    q2 = scope.ingest({"w": np.array(["c", "d", "e"], object)}, schema)
    assert set(q1.node.params["str_vocab"]["w"].tolist()) == set(snap.tolist())
    assert len(q2.node.params["str_vocab"]["w"]) == 5  # the scope widened


# ---- failures: propagate, and leave no spill behind ------------------------


def _leftovers(root):
    return [d for d in glob.glob(os.path.join(root, "spill_*")) if os.path.isdir(d)]


def test_prefetch_fault_cleans_spills(tmp_path):
    class IngestDied(RuntimeError):
        pass

    def chunks():
        rng = np.random.default_rng(7)
        yield {"x": rng.integers(0, 10**6, 2000).astype(np.int32)}
        yield {"x": rng.integers(0, 10**6, 2000).astype(np.int32)}
        raise IngestDied("source failed mid-stream")

    root = str(tmp_path / "spills")
    c = make_ctx(depth=4, spill=root)
    with pytest.raises(IngestDied, match="mid-stream"):
        c.from_stream(chunks()).order_by(["x"]).collect()
    assert _leftovers(root) == []
    assert _events(c, "stream_pipeline_error")


@pytest.mark.parametrize("dispatch", [1, 2])
def test_compute_fault_propagates_and_cleans(tmp_path, monkeypatch, dispatch):
    root = str(tmp_path / "spills")
    c = make_ctx(depth=4, spill=root, dispatch_depth=dispatch)
    real = GraphExecutor.execute

    def failing(self, graph, *a, **k):
        if any(op.kind == "local_sort" for s in graph.stages for op in s.ops):
            raise StageFailedError("sort stage failed")
        return real(self, graph, *a, **k)

    monkeypatch.setattr(GraphExecutor, "execute", failing)
    rng = np.random.default_rng(8)
    chunks = [{"x": rng.integers(0, 10**6, 1500).astype(np.int32)} for _ in range(3)]
    with pytest.raises(StageFailedError, match="sort stage failed"):
        c.from_stream(iter(chunks)).order_by(["x"]).collect()
    assert _leftovers(root) == []


def test_spill_fault_propagates_and_cleans(tmp_path, monkeypatch):
    root = str(tmp_path / "spills")
    c = make_ctx(depth=2, spill=root)
    rng = np.random.default_rng(9)
    chunks = [{"x": rng.integers(0, 10**6, 1500).astype(np.int32)} for _ in range(4)]
    orig = SpillDir.append
    calls = {"n": 0}

    def flaky(self, bucket, table):
        calls["n"] += 1
        if calls["n"] > 3:
            raise IOError("spill volume died")
        return orig(self, bucket, table)

    monkeypatch.setattr(SpillDir, "append", flaky)
    with pytest.raises(IOError, match="spill volume died"):
        c.from_stream(iter(chunks)).order_by(["x"]).collect()
    assert _leftovers(root) == []
    # the spill writer latched it; the result stream's prefetch thread,
    # which ran the sort, re-raised it (as the reference's does)
    assert [e["phase"] for e in _events(c, "stream_pipeline_error")] == ["spill", "prefetch"]
    assert threading.active_count() < 20  # every pipeline thread joined


def test_stream_config_validation():
    for bad in (dict(stream_bucket_rows=0), dict(stream_buckets=1),
                dict(stream_pipeline_depth=0), dict(stream_writer_queue=0),
                dict(combine_tree_fan=1), dict(combine_tree_ranges=48),
                dict(combine_tree_groups=-1), dict(combine_tree_degrade_ratio=0.0),
                dict(stream_host_reprobe=-1), dict(dispatch_depth=0), dict(chunk_fuse=0)):
        with pytest.raises(ValueError):
            T.DryadContext(config=T.DryadConfig(**bad), device="cpu")
    cfg = T.DryadConfig()
    assert (cfg.stream_bucket_rows, cfg.stream_combine_rows, cfg.stream_buckets) == (1 << 21, 1 << 20, 32)
    assert (cfg.stream_pipeline_depth, cfg.dispatch_depth, cfg.chunk_fuse) == (4, 2, 1)
    assert cfg.combine_tree and cfg.stream_writer_queue == 8


def _group_by_over_grace_join(c):
    """Runs a group_by over a join of two streams in ``c``; asserts the
    result equals numpy's."""
    rng = np.random.default_rng(12)
    L = [{"k": rng.integers(0, 300, 1500).astype(np.int32),
          "g": rng.integers(0, 17, 1500).astype(np.int32)} for _ in range(4)]
    R = [{"k": np.arange(0, 300, 2, dtype=np.int32),
          "w": rng.integers(0, 100, 150).astype(np.int32)}]
    out = c.from_stream(iter(_copy(L))).join(c.from_stream(iter(_copy(R))), ["k"], ["k"]).group_by(
        "g", {"n": ("count", None), "s": ("sum", "w")}).collect()
    lk = np.concatenate([d["k"] for d in L])
    lg = np.concatenate([d["g"] for d in L])
    w = dict(zip(R[0]["k"].tolist(), R[0]["w"].tolist()))
    hit = np.array([k in w for k in lk.tolist()])
    exp = collections.Counter(lg[hit].tolist())
    sums = collections.Counter()
    for k, g in zip(lk[hit].tolist(), lg[hit].tolist()):
        sums[g] += w[k]
    got = {int(g): (int(n), int(s)) for g, n, s in zip(out["g"], out["n"], out["s"])}
    assert got == {g: (exp[g], sums[g]) for g in exp}


@pytest.mark.parametrize("depth", [1, 4])
def test_group_by_over_a_grace_join_stream(depth):
    """A group_by over a join of two streams: at depth 4 the join's
    bucket jobs run on the result stream's prefetch thread while the
    driver runs the chunk partials, so the context runs one job at a
    time; the result equals numpy's."""
    _group_by_over_grace_join(make_ctx(depth=depth, bucket_rows=1000, buckets=4, combine_rows=200))


class _OwnedLock:
    """A re-entrant lock that knows which thread holds it."""

    def __init__(self):
        self._lock = threading.RLock()
        self.owner, self.depth = None, 0

    def __enter__(self):
        self._lock.acquire()
        self.owner = threading.get_ident()
        self.depth += 1
        return self

    def __exit__(self, *exc):
        self.depth -= 1
        if not self.depth:
            self.owner = None
        self._lock.release()

    def held(self) -> bool:
        return self.owner == threading.get_ident()


class _GuardedCache(collections.OrderedDict):
    """The device cache, asserting that every change and every walk over
    it happens under the context's job lock."""

    lock = None

    def _held(self):
        assert self.lock is not None and self.lock.held(), "device cache touched outside the job lock"

    def __setitem__(self, k, v):
        self._held()
        super().__setitem__(k, v)

    def __delitem__(self, k):
        self._held()
        super().__delitem__(k)

    def pop(self, *a):
        self._held()
        return super().pop(*a)

    def popitem(self, last=True):
        self._held()
        return super().popitem(last=last)

    def move_to_end(self, k, last=True):
        self._held()
        super().move_to_end(k, last=last)

    def values(self):
        self._held()
        return super().values()


def test_device_cache_changes_only_under_the_job_lock():
    """At depth 4 the join's bucket jobs run on a prefetch thread while
    the driver releases its partials' tables: with a device cache small
    enough that every bind evicts (and walks the cache), each change to
    the cache, the driver's releases included, holds the job lock."""
    for _ in range(5):
        c = make_ctx(depth=4, bucket_rows=1000, buckets=4, combine_rows=200, device_cache_bytes=1 << 12)
        c._job_lock = _OwnedLock()
        c._device_cache = _GuardedCache()
        c._device_cache.lock = c._job_lock
        _group_by_over_grace_join(c)
        assert not c._device_cache


def test_async_fetches_equal_collect_and_defer_the_miss_check():
    """``run_to_host_async``/``run_many_to_host_async`` dispatch now and
    copy at ``fetch()``; the dictionary-miss check rides the (first)
    fetch, as the reference's deferred finish does."""
    import torch

    from dryad_tpu_torch.exec.executor import DeferredFinish

    c = make_ctx()
    rng = np.random.default_rng(13)
    t = {"k": rng.integers(-50, 50, 3000).astype(np.int32),
         "s": np.array([f"w{i}" for i in rng.integers(0, 30, 3000)], object)}
    qs = [c.from_arrays(t).group_by("k", {"n": ("count", None)}),
          c.from_arrays(t).group_by("s", {"n": ("count", None)}),
          c.from_arrays(t).order_by(["k"])]
    want = [_bytes({k: np.asarray(v) for k, v in q.collect().items() if k != "s"}) for q in qs]
    jobs = len(c.events.filter("job_complete"))
    fetch = c.run_to_host_async(qs[0])
    assert len(c.events.filter("job_complete")) == jobs  # deferred to the fetch
    assert _bytes(fetch()) == want[0]
    assert len(c.events.filter("job_complete")) == jobs + 1
    fetches = c.run_many_to_host_async(qs)
    got = [f() for f in fetches]
    for g, w in zip(got, want):
        assert _bytes({k: v for k, v in g.items() if k != "s"}) == w
    assert got[1]["s"].tolist() == qs[1].collect()["s"].tolist()
    ex = c.executor
    with pytest.raises(StageFailedError, match="3 rows fall outside"):
        DeferredFinish(ex, [("group_by", torch.tensor(3))]).finish()
    kinds = [e["kind"] for e in c.events.events()[-2:]]
    assert kinds == ["job_failed", "dict_miss"]
    DeferredFinish(ex, [("group_by", torch.tensor(0))]).abort("output transfer failed")
    assert c.events.events()[-1]["failure_kind"] == "transient"
