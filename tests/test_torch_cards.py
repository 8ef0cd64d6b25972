"""One context over several devices (dryad_tpu_torch): ``DryadContext(
devices=...)``, a rank thread a device inside the driver's process, as
the reference's single controller spans ``jax.devices()``.

Here the ranks run on the CPU (``devices=["cpu"] * D``) over a gloo group
made in the process.  The port at D = 2 and 4 ranks of P = 8
partitions equals the one-device port at P = 8 on the gang's op corpus
(``tests/torch_gang.py``), and at D = 2, 4 and 8 the reference's
``DryadContext(num_partitions_=8)`` on its 8 CPU devices on WordCount, TeraSort, both
``group_by`` paths, the shuffle and the broadcast join, an ordered
operator and PageRank as a ``do_while``: every partition's rows
byte-equal, float sums within the summation-order bounds of
``tests/test_torch_gang.py`` (the dense path's 2^-16 * sum|v|, the sort
path's n_g * 2^-23 * sum_g|v|).  The event stream and ``JobMetrics`` equal
the reference's; ``rebuild_mesh``, checkpoints, a failing rank and the
devices a host lacks are held to the reference or named.  Each test runs
under a time limit of its own (``TEST_LIMIT_S``).
"""

import re
import signal

import numpy as np
import pytest
import torch

import dryad_tpu as J
import dryad_tpu_torch as T
import torch_gang as G
from dryad_tpu.parallel import mesh as jmesh
from dryad_tpu_torch.obs.metrics import JobMetrics
from dryad_tpu_torch.parallel import multihost
from dryad_tpu_torch.parallel.partition import GangStageError
from dryad_tpu_torch.parallel.ranks import RankBatches
from test_torch_dowhile import N_NODES, _pagerank
from test_torch_events_explain import (
    CLOCK_KINDS, RETRYING, _comparable, _rng_tables, _samples, _spans, _swap_executor_log,
)
from test_torch_checkpoint import _ckpt_events, _files
from test_torch_gang import FLOAT_BOUNDS, _reference_partitions, _same_partitions

P = 8
RANKS = [2, 4, 8]
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


def cards(D, **cfg):
    return T.DryadContext(num_partitions_=P, devices=["cpu"] * D, config=T.DryadConfig(**cfg))


# -- the op corpus: D ranks against one device -------------------------------------


@pytest.fixture(scope="module")
def one_corpus():
    return G.run_corpus(T.DryadContext(num_partitions_=P, device="cpu"), list(G.CORPUS))


# the whole corpus at 2 and 4 ranks (8 ranks run the named queries below)
CORPUS_RANKS = [2, 4]


@pytest.fixture(scope="module")
def ranks_corpus():
    return {D: G.run_corpus(cards(D), list(G.CORPUS)) for D in CORPUS_RANKS}


@pytest.mark.parametrize("D", CORPUS_RANKS)
@pytest.mark.parametrize("name", list(G.CORPUS))
def test_corpus_over_ranks_equals_one_device(name, D, ranks_corpus, one_corpus):
    floats = [c for (n, c) in FLOAT_BOUNDS if n == name and FLOAT_BOUNDS[(n, c)][1] == "dense"]
    for (rcap, rparts), (cap, parts) in zip(ranks_corpus[D][0][name], one_corpus[0][name]):
        assert rcap == cap, name
        _same_partitions(name, rparts, parts, floats)


def test_corpus_over_ranks_reaches_every_op_kind(ranks_corpus, one_corpus):
    for D in CORPUS_RANKS:
        assert ranks_corpus[D][1] == one_corpus[1], D


# -- the named queries against the reference at P = 8 --------------------------------

def _words():
    rng = np.random.default_rng(5)
    vocab = np.array([f"w{i}" for i in range(300)], object)
    return {"word": vocab[np.minimum(rng.zipf(1.3, 6000), 300) - 1]}


REFERENCE = {
    "wordcount": lambda c: [c.from_arrays(_words()).group_by("word", {"n": ("count", None)})],
    "terasort": G.CORPUS["terasort"],
    "group_by_dense": G.CORPUS["group_by_dense"],
    "group_by_sort_path": G.CORPUS["group_by_sort_path"],
    "join_inner_shuffle": G.CORPUS["join_inner_shuffle"],
    "join_inner_broadcast": G.CORPUS["join_inner_broadcast"],
    "sliding_window": G.CORPUS["sliding_window"],
}


@pytest.fixture(scope="module")
def reference_rows():
    jc = J.DryadContext(num_partitions_=P)
    assert jmesh.num_partitions(jc.mesh) == P
    return {n: [_reference_partitions(jc, q) for q in REFERENCE[n](jc)] for n in REFERENCE}


@pytest.fixture(scope="module")
def ranks_rows():
    out = {}
    for D in RANKS:
        tc = cards(D)
        for n in REFERENCE:
            got = []
            for q in REFERENCE[n](tc):
                b = tc.execute(q)
                assert isinstance(b, RankBatches) and len(b.parts) == D
                got.append(G.partition_rows(b)[1])
            out[(D, n)] = got
    return out


@pytest.mark.parametrize("D", RANKS)
@pytest.mark.parametrize("name", list(REFERENCE))
def test_query_over_ranks_equals_the_reference(name, D, ranks_rows, reference_rows):
    floats = [c for (n, c) in FLOAT_BOUNDS if n == name]
    for mine, ref in zip(ranks_rows[(D, name)], reference_rows[name]):
        _same_partitions(name, mine, ref, floats)


def _pagerank_inputs():
    rng = np.random.default_rng(7)
    src = rng.integers(0, N_NODES, 400).astype(np.int32)
    dst = rng.integers(0, N_NODES, 400).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    deg = np.bincount(src, minlength=N_NODES).astype(np.float32)
    return src, dst, (1.0 / np.maximum(deg, 1.0))[src].astype(np.float32)


@pytest.fixture(scope="module")
def pagerank_reference():
    jc = J.DryadContext(num_partitions_=P)
    return _pagerank(jc, *_pagerank_inputs()), [e["kind"] for e in jc.events.events()]


@pytest.mark.parametrize("D", RANKS)
def test_pagerank_do_while_over_ranks_equals_the_reference(D, pagerank_reference):
    ref, ref_kinds = pagerank_reference
    tc = cards(D)
    port = _pagerank(tc, *_pagerank_inputs())
    assert port["node"].tolist() == ref["node"].tolist()
    rounds = sum(1 for k in ref_kinds if k == "do_while_iter")
    assert rounds > 3
    assert [k for k in (e["kind"] for e in tc.events.events()) if k.startswith("do_while")] == \
        [k for k in ref_kinds if k.startswith("do_while")]
    # the sort path's f32 sums: within n_g * 2^-23 * sum|v| a round
    assert np.all(np.abs(port["rank"].astype(np.float64) - ref["rank"]) <= 2e-7 * rounds)


# -- one event stream -----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(RETRYING))
def test_event_stream_and_job_metrics_equal_the_references(name):
    """Rank 0's events are the context's stream: the reference's single
    controller's on the same query at P = 8, retries and width
    adaptation included, one ``xla_compile`` a program; JobMetrics'
    compile, dispatch and byte counts equal."""
    L, R = _rng_tables()
    jc = J.DryadContext(num_partitions_=P)
    _swap_executor_log(jc)
    tc = cards(4)
    outs = [RETRYING[name](c, L, R).collect() for c in (jc, tc)]
    for c in outs[0]:
        np.testing.assert_array_equal(outs[1][c], outs[0][c])
    port = tc.events.events()
    kinds = {e["kind"] for e in port}
    assert "stage_overflow" in kinds or "stage_width_adapt" in kinds
    assert _comparable(port, kinds - CLOCK_KINDS) == \
        _comparable(jc.executor.events.events(), kinds - CLOCK_KINDS)
    assert _samples(port) == _samples(jc.executor.events.events())
    # the spans, but for the thread that ran the unit: rank 0's
    spans, ref_spans = _spans(port), _spans(jc.events.events())
    assert spans and {s.pop("thread") for s in spans} == {"dryad-rank-0"}
    assert spans == [{k: v for k, v in s.items() if k != "thread"} for s in ref_spans]
    jm = JobMetrics.from_events(jc.executor.events.events())
    tm = JobMetrics.from_events(port)
    for f in ("compile_count", "dispatch_count", "fused_dispatches", "exchange_rounds",
              "peak_exchange_bytes", "exchange_ici_bytes", "exchange_dcn_bytes"):
        assert getattr(tm, f) == getattr(jm, f), f
    # the result's device->host bytes: the whole table, every rank's part
    assert tc.executor.metrics.total("d2h_bytes") == jc.executor.metrics.total("d2h_bytes")


# -- rebuild_mesh ------------------------------------------------------------------------

def test_elastic_mesh_rebuild_after_exclusion(rng):
    """The reference's test on 8 ranks: exclude two cards, re-run on the
    survivors at the same partitions a card."""
    ctx = cards(8)
    tbl = {"k": rng.integers(0, 16, 512).astype(np.int32)}
    before = ctx.from_arrays(tbl).group_by("k", {"c": ("count", None)}).collect()
    ctx.rebuild_mesh([0, 1])
    assert ctx.mesh.P == 6 and ctx.num_partitions == 6 and len(ctx.devices) == 6
    after = ctx.from_arrays(tbl).group_by("k", {"c": ("count", None)}).collect()
    assert sorted(zip(before["k"], before["c"])) == sorted(zip(after["k"], after["c"]))


@pytest.mark.parametrize("D", [1, 8])
def test_exclude_all_devices_rejected(D):
    ctx = (T.DryadContext(num_partitions_=P, device="cpu") if D == 1 else cards(D))
    with pytest.raises(ValueError, match="excluding all devices"):
        ctx.rebuild_mesh(list(range(D)))


def _message(e) -> str:
    return re.sub(r"input node \d+", "input node N", str(e))


@pytest.mark.parametrize("D", [1, 4])
def test_a_cached_table_after_rebuild_raises_the_references_message(D):
    tbl = {"k": np.arange(64, dtype=np.int32)}
    jc = J.DryadContext(num_partitions_=P)
    jq = jc.from_arrays(tbl).cache()
    jc.rebuild_mesh([0])
    with pytest.raises(RuntimeError) as jerr:
        jq.collect()
    tc = T.DryadContext(num_partitions_=P, device="cpu") if D == 1 else cards(D)
    tq = tc.from_arrays(tbl).cache()
    tc.rebuild_mesh([0] if D > 1 else [])  # one device: it has no other
    with pytest.raises(RuntimeError) as terr:
        tq.collect()
    assert _message(terr.value) == _message(jerr.value)
    # a host table survives the rebuild
    assert sorted(tc.from_arrays(tbl).collect()["k"].tolist()) == list(range(64))


# -- checkpoints --------------------------------------------------------------------------

def _ckpt_query(c, tbl):
    return c.from_arrays(tbl).group_by("k", {"c": ("count", None), "s": ("sum", "w")}).order_by(
        [("k", False)])


def test_checkpoint_saved_and_resumed_on_four_ranks(tmp_path, rng):
    """Four ranks save the reference's checkpoint files (stage names,
    files, bytes and CRCs; the fingerprint in a directory's name is each
    package's own) and log its checkpoint events; a fresh four-rank
    context and a one-device one resume from them."""
    tbl = {"k": rng.integers(-40, 40, 3000).astype(np.int32),
           "w": rng.integers(-9, 9, 3000).astype(np.int32)}
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jc = J.DryadContext(num_partitions_=P, config=J.DryadConfig(checkpoint_dir=jdir))
    want = _ckpt_query(jc, tbl).collect()
    tc = cards(4, checkpoint_dir=tdir)
    got = _ckpt_query(tc, tbl).collect()
    for c in want:
        np.testing.assert_array_equal(got[c], want[c])
    assert _files(tdir) == _files(jdir) and _files(tdir)
    assert _ckpt_events(tc) == _ckpt_events(jc)
    for resumed in (cards(4, checkpoint_dir=tdir),
                    T.DryadContext(num_partitions_=P, device="cpu",
                                   config=T.DryadConfig(checkpoint_dir=tdir))):
        out = _ckpt_query(resumed, tbl).collect()
        kinds = [e["kind"] for e in resumed.events.events()]
        assert "stage_checkpoint_hit" in kinds and "stage_checkpoint_saved" not in kinds
        for c in want:
            np.testing.assert_array_equal(out[c], want[c])


# -- a rank that fails -----------------------------------------------------------------------

def _boom(batch, i):
    if i == 5:
        raise ValueError("partition 5 refuses")
    return batch


def test_a_failing_rank_fails_collect_naming_it_and_the_next_query_runs(monkeypatch, rng):
    monkeypatch.setattr(multihost, "_timeout_s", 5.0)  # the abandoned gloo group's end
    tc = cards(4)
    tbl = {"k": rng.integers(0, 16, 512).astype(np.int32)}
    with pytest.raises(GangStageError) as err:
        tc.from_arrays(tbl).apply(_boom, with_index=True).group_by(
            "k", {"c": ("count", None)}).collect()
    msg = str(err.value)
    assert "on rank 2 of 4" in msg and "'input+apply" in msg and "partition 5 refuses" in msg
    assert isinstance(err.value.__cause__, ValueError)
    out = tc.from_arrays(tbl).group_by("k", {"c": ("count", None)}).collect()
    assert int(out["c"].sum()) == 512
    assert tc._ranks.generation == 2  # a fresh group after the abort


@pytest.fixture
def port_faults():
    from dryad_tpu_torch.exec import faults

    faults.registry.clear()
    yield faults.registry
    faults.registry.clear()


@pytest.mark.parametrize("count", [2, -1], ids=["transient", "deterministic"])
def test_injected_stage_failures_retry_alike_on_every_rank(count, port_faults):
    """Rank 0 consults the fault registry and every rank takes its
    outcome: the retries, and the terminal error, are the reference's."""
    from dryad_tpu.exec import faults as jfaults

    tbl = {"k": np.random.default_rng(4).integers(-50, 50, 2000).astype(np.int32)}
    kw = dict(max_stage_failures=4, retry_backoff_base=0.002)
    jc = J.DryadContext(num_partitions_=P, config=J.DryadConfig(**kw))
    tc = cards(4, **kw)
    seen = []
    for c, reg in ((jc, jfaults.registry), (tc, port_faults)):
        reg.set_fake_stage_failure("group_by", count)
        try:
            out = c.from_arrays(tbl).group_by("k", {"n": ("count", None)}).collect()
            seen.append(("ok", int(out["n"].sum())))
        except Exception as e:  # noqa: BLE001 - the error is what is compared
            seen.append((type(e).__name__, str(e)))
        reg.clear()
    assert seen[0] == seen[1]
    kinds = ("stage_start", "stage_failed", "job_failed", "job_complete")
    ev = [[(e["kind"], e.get("version")) for e in c.events.events() if e["kind"] in kinds]
          for c in (jc, tc)]
    assert ev[0] == ev[1] and ("stage_failed", 1) in ev[1]
    assert int(tc.from_arrays(tbl).group_by("k", {"n": ("count", None)}).collect()["n"].sum()) == 2000


class _Work:
    def __init__(self, log, what):
        self.log, self.what = log, what

    def wait(self):
        self.log.append(("wait", self.what))


class _FakeNccl:
    """The calls an NCCL backend made in the process receives: it
    coalesces, and its coalescing calls take no device (a registered
    group's take one)."""

    supports_coalescing = True

    def __init__(self):
        self.log = []

    def _start_coalescing(self):
        self.log.append(("start",))

    def _end_coalescing(self):
        self.log.append(("end",))
        return _Work(self.log, "group")

    def send(self, tensors, dst, tag):
        self.log.append(("send", dst, tensors[0].tolist()))
        return _Work(self.log, "send")

    def recv(self, tensors, src, tag):
        self.log.append(("recv", src))
        return _Work(self.log, "recv")


def test_point_to_point_coalesces_on_a_backend_made_in_the_process():
    from dryad_tpu_torch.parallel import partition as PART
    from dryad_tpu_torch.parallel.mesh import PartitionMesh

    pg = _FakeNccl()
    mesh = PartitionMesh(4, "cpu", rank=1, world=2, group=pg, backend="nccl")
    PART._p2p(mesh, [(0, torch.tensor([7, 8]))], [(0, torch.empty(2))])
    assert pg.log == [("start",), ("send", 0, [7, 8]), ("recv", 0), ("end",), ("wait", "group")]


# -- what the context refuses, and what it never does -------------------------------------

def _have():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


@pytest.mark.parametrize("devices, why", [
    (lambda: [f"cuda:{_have()}"], "CUDA cards"), (lambda: _have() + 1, "CUDA cards"),
    (lambda: [], "at least one"),
], ids=["a_card_past_the_last", "more_cards_than_the_host", "none"])
def test_devices_the_host_lacks_raise(devices, why):
    """A context naming cards the host lacks raises: it never falls back
    to fewer cards or to the CPU."""
    with pytest.raises(ValueError, match=why):
        T.DryadContext(devices=devices())


def test_partitions_a_card_and_the_default():
    assert cards(4).mesh.local == 2
    c = T.DryadContext(devices=["cpu"] * 4)
    assert c.num_partitions == 4 and c.mesh.local == 1 and c.mesh.world == 4
    with pytest.raises(ValueError, match="multiple of the 3 devices"):
        T.DryadContext(num_partitions_=8, devices=["cpu"] * 3)
