"""The gang data plane of the port (dryad_tpu_torch): the collectives of
``parallel/partition.py`` over a process group, the op corpus run as
one program across ranks, and ``LocalJobSubmission.submit`` /
``submit_many`` / ``rebuild_gang``.

Everything runs on the CPU over ``gloo``.  The collectives run at world
2 and 4 in spawned processes (``tests/torch_gang.py``) and equal the
one-process functions on the whole ``(P, ...)`` tensors.  The op corpus
runs on 2 ranks of 2 partitions each and equals one process at P = 4
and the reference at P = 4 on the 8-device CPU mesh: integer columns
and every partition's rows byte-equal, float sums within the
summation-order bounds (dense 2^-16 * sum|v|, the sort path's
n_g * 2^-23 * sum_g|v|).  The reference's gang tests
(tests/test_localjob.py, tests/test_gang_elastic.py and the window
cases of tests/test_gangtree.py) run on the port through
``tests/test_torch_cluster.py::_port_copy`` with workers on the CPU and
a short group timeout.
"""

import inspect
import time

import numpy as np
import pytest
import torch

import dryad_tpu as J
from dryad_tpu.parallel import mesh as jmesh
import dryad_tpu_torch as T
import torch_gang as G
from dryad_tpu.cluster.localjob import LocalJobSubmission as JLocalJobSubmission
from dryad_tpu_torch.cluster.localjob import LocalJobSubmission
from dryad_tpu_torch.exec import kernels as TK
from dryad_tpu_torch.parallel import mesh as TM
from dryad_tpu_torch.parallel import partition as PART
from dryad_tpu_torch.parallel.multihost import (
    choose_backend, init_distributed, local_index, rank_device,
)
from test_torch_cluster import _port_copy, _resolve

P = 4  # the corpus's partitions: 2 ranks x 2

# -- the partition layer's collectives over a group -------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_equal_the_one_process_functions(world):
    Pw = 2 * world
    got = G.run_ranks(world, "collectives_case", Pw, 5 + world)
    full = {k: torch.from_numpy(v) for k, v in G.collectives_inputs(Pw, 5 + world).items()}
    one = G.collectives_apply(PART, full, None, Pw)
    per_partition = {"psum_scatter_i", "psum_scatter_f", "all_gather", "all_to_all",
                     "axis_index", "prefix", "ppermute"}
    fabs = np.abs(full["f"].numpy().astype(np.float64))
    for k, want in one.items():
        if k in per_partition:
            have = np.concatenate([g[k] for g in got])
        else:  # replicated: every rank holds the same bytes
            have = got[0][k]
            for g in got[1:]:
                assert g[k].tobytes() == have.tobytes(), k
        assert have.dtype == want.dtype and have.shape == want.shape, k
        if want.dtype.kind == "f":
            # the sum over P partitions in another order: within P ulps of sum|v|
            col = fabs.sum(0) if k == "psum_f" else fabs.sum(0).reshape(Pw, -1)
            bound = Pw * 2.0 ** -23 * (col if k != "pmax" else 0.0)
            assert (np.abs(have.astype(np.float64) - want) <= bound).all(), k
        else:
            assert have.tobytes() == want.tobytes(), k


def test_a_gang_rerun_gives_the_same_bytes():
    """gloo reduces in a fixed order for a fixed world: the float sums
    of two runs of the same gang are byte-equal."""
    a = G.run_ranks(2, "collectives_case", 4, 9)
    b = G.run_ranks(2, "collectives_case", 4, 9)
    for ra, rb in zip(a, b):
        for k in ra:
            assert ra[k].tobytes() == rb[k].tobytes(), k


def test_one_process_mesh_and_flat_functions():
    m = TM.make_mesh(8, "cpu")
    assert (m.P, m.rank, m.world, m.local, m.group, m.base) == (8, 0, 1, 8, None, 0)
    assert TM.num_partitions(m) == 8 and TM.mesh_axes(m) == ("p",)
    assert TM.dcn_slice_count(m) == TM.dcn_slice_count(None) == 1
    assert TM.ici_partitions_per_slice(m) == 8 and TM.ici_partitions_per_slice(None) == 1
    assert TM.exclude_devices(m, [3]) is m
    with pytest.raises(ValueError, match="empty mesh"):
        TM.exclude_devices(m, [0])
    with pytest.raises(ValueError, match="multiple"):
        TM.PartitionMesh(6, "cpu", rank=0, world=4, group=object())
    two = TM.PartitionMesh(8, "cpu", rank=1, world=2, group=object(), backend="gloo")
    assert (two.local, two.base) == (4, 4)
    with pytest.raises(ValueError, match="cannot shrink"):
        TM.exclude_devices(two, [0])
    # the hybrid mesh: 2 slices of 4 in one process, as the reference's 2 x 4
    h = TM.make_hybrid_mesh(2, device="cpu")
    assert (h.P, h.dcn, h.ici, h.world, h.group) == (8, 2, 4, 1, None)
    assert TM.mesh_axes(h) == (TM.DCN_AXIS, TM.AXIS) == tuple(jmesh.make_hybrid_mesh(2).axis_names)
    assert TM.dcn_slice_count(h) == 2 and TM.ici_partitions_per_slice(h) == 4
    hc = T.DryadContext(num_partitions_=8, device="cpu", dcn_slices=2)
    assert (hc.num_partitions, hc.mesh.dcn, hc.mesh.ici) == (8, 2, 4)
    # the reference's validation errors
    with pytest.raises(ValueError, match="dcn_slices must be >= 1"):
        TM.make_hybrid_mesh(0)
    with pytest.raises(ValueError, match="not divisible by dcn_slices"):
        T.DryadContext(num_partitions_=6, device="cpu", dcn_slices=4)
    with pytest.raises(ValueError, match="no partition in a slice"):
        TM.make_hybrid_mesh(16)
    with pytest.raises(ValueError, match="gang keeps the flat mesh"):
        TM.PartitionMesh(8, "cpu", rank=0, world=2, group=object(), dcn_slices=2)


def test_init_distributed_and_the_backend_choice(monkeypatch):
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    assert init_distributed() is False
    assert init_distributed("127.0.0.1:1", 1, 0, device="cpu") is False
    # the backend from every rank's host and device: a card each takes
    # NCCL (on one host or several); the CPU or a shared card takes gloo
    assert choose_backend(["a/cpu", "a/cpu"]) == "gloo"
    assert choose_backend(["a/cuda:0", "a/cuda:0"]) == "gloo"
    assert choose_backend(["a/cuda:0", "a/cpu"]) == "gloo"
    assert choose_backend(["a/cuda:0", "a/cuda:1"]) == "nccl"
    assert choose_backend(["a/cuda:0", "b/cuda:0"]) == "nccl"
    # a rank's device from its local index: a card each where the host
    # has enough of them, else the current card, shared
    assert local_index(3, 4) == (3, 4)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert local_index(3, 4) == (1, 2)
    assert rank_device("cpu", 1, 2) == torch.device("cpu")
    assert rank_device("cuda:3", 1, 2) == torch.device("cuda", 3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert rank_device("cuda", 1, 2) == torch.device("cuda", 1)
    assert rank_device(None, 1, 2) == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert rank_device("cuda", 1, 2) == torch.device("cuda")


def test_a_mesh_defaults_to_the_card(monkeypatch):
    """``make_mesh(P)`` and ``PartitionMesh(P)`` take the current CUDA
    device, raise without one, and take the CPU only when it is named."""
    if torch.cuda.is_available():
        assert TM.make_mesh(4).device.type == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.make_mesh(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.PartitionMesh(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert TM.make_mesh(4).device == torch.device("cuda", 0)
    assert TM.make_mesh(4, "cpu").device == torch.device("cpu")


def test_context_mesh_is_exclusive_and_a_rank_never_collects():
    m = TM.PartitionMesh(4, "cpu")
    ctx = T.DryadContext(mesh=m)
    assert ctx.num_partitions == 4 and ctx.mesh is m and ctx.device.type == "cpu"
    with pytest.raises(ValueError, match="either num_partitions_ or mesh"):
        T.DryadContext(num_partitions_=8, mesh=m)
    rank1 = TM.PartitionMesh(4, "cpu", rank=1, world=2, group=object(), backend="gloo")
    gctx = T.DryadContext(mesh=rank1)
    q = gctx.from_arrays({"k": np.arange(10, dtype=np.int32)})
    with pytest.raises(RuntimeError, match="partition files"):
        q.collect()
    with pytest.raises(RuntimeError, match="partition files"):
        q.to_store("unused")


def test_a_rank_uploads_only_its_partitions():
    from dryad_tpu_torch.parallel.distribute import from_host_table, from_physical_table

    tbl = {"k": np.arange(50, dtype=np.int32)}
    q = T.DryadContext(num_partitions_=4, device="cpu").from_arrays(tbl)
    whole = from_host_table(q.schema, tbl, TM.PartitionMesh(4, "cpu"))
    for r in range(2):
        m = TM.PartitionMesh(4, "cpu", rank=r, world=2, group=object(), backend="gloo")
        mine = from_host_table(q.schema, tbl, m)
        assert mine.valid.shape == (2, whole.capacity)
        assert torch.equal(mine.data["k"], whole.data["k"][2 * r: 2 * r + 2])
        assert torch.equal(mine.valid, whole.valid[2 * r: 2 * r + 2])
        phys = from_physical_table({"k": tbl["k"]}, m, 16)
        data, valid = PART.block_layout({"k": tbl["k"]}, 4, 16)
        assert phys.data["k"].numpy().tobytes() == data["k"][2 * r: 2 * r + 2].tobytes()
        assert phys.valid.numpy().tobytes() == valid[2 * r: 2 * r + 2].tobytes()


# -- the op corpus: 2 ranks x 2 partitions against one process and the reference ---


@pytest.fixture(scope="module")
def gang_corpus():
    ranks = G.run_ranks(2, "corpus_case", P, list(G.CORPUS))
    out = {}
    for name in G.CORPUS:
        out[name] = [
            (ranks[0][0][name][j][0], ranks[0][0][name][j][1] + ranks[1][0][name][j][1])
            for j in range(len(ranks[0][0][name]))
        ]
    return out, ranks[0][1] | ranks[1][1]


@pytest.fixture(scope="module")
def one_corpus():
    return G.run_corpus(T.DryadContext(num_partitions_=P, device="cpu"), list(G.CORPUS))


# float columns whose sums change order across ranks or packages, with
# the keys of their groups and the bound's kind
FLOAT_BOUNDS = {
    ("group_by_dense", "sv"): (["d"], "dense"),
    ("group_by_sort_path", "sv"): (["g"], "sum"), ("group_by_sort_path", "mv"): (["g"], "mean"),
    ("group_by_two_keys", "sv"): (["g", "b"], "sum"), ("group_by_two_keys", "mv"): (["g", "b"], "mean"),
    ("group_by_salt", "sv"): (["g"], "sum"), ("group_by_salt", "mv"): (["g"], "mean"),
    ("scalar", "sv"): ([], "sum"), ("scalar", "mv"): ([], "mean"),
}


def _bound(name, col, part):
    """Per-row bound of a float column of one partition's rows."""
    keys, kind = FLOAT_BOUNDS[(name, col)]
    t = G.corpus_table()
    absv = np.abs(t["v"].astype(np.float64))
    out = []
    for i in range(len(part[col])):
        sel = np.ones(len(absv), bool)
        for k in keys:
            sel &= t[k] == part[k][i]
        n, s = int(sel.sum()), float(absv[sel].sum())
        out.append(2.0 ** -16 * s if kind == "dense" else
                   (n if kind == "sum" else 1) * 2.0 ** -23 * s)
    return np.array(out)


def _same_partitions(name, a, b, float_cols=()):
    """Partition by partition, the same rows: every column byte-equal,
    ``float_cols`` within their bounds."""
    assert len(a) == len(b), name
    for p, (pa, pb) in enumerate(zip(a, b)):
        assert sorted(pa) == sorted(pb), (name, p)
        for c in pa:
            x, y = np.asarray(pa[c]), np.asarray(pb[c])
            assert x.dtype == y.dtype and x.shape == y.shape, (name, p, c)
            if c in float_cols:
                diff = np.abs(x.astype(np.float64) - y.astype(np.float64))
                assert (diff <= _bound(name, c, pa)).all(), (name, p, c)
            else:
                assert x.tobytes() == y.tobytes(), (name, p, c)


@pytest.mark.parametrize("name", list(G.CORPUS))
def test_corpus_query_on_two_ranks_equals_one_process(name, gang_corpus, one_corpus):
    gang, one = gang_corpus[0][name], one_corpus[0][name]
    floats = [c for (n, c) in FLOAT_BOUNDS if n == name and FLOAT_BOUNDS[(n, c)][1] == "dense"]
    for (gcap, gparts), (cap, parts) in zip(gang, one):
        assert gcap == cap, name
        _same_partitions(name, gparts, parts, floats)


def _reference_partitions(jc, q):
    b = jc._execute_device(q)
    Pj = jmesh.num_partitions(jc.mesh)
    valid = np.asarray(b.valid).reshape(Pj, -1)
    cols = {c: np.asarray(v).reshape((Pj, -1) + np.asarray(v).shape[1:]) for c, v in b.data.items()}
    return [{c: v[i][valid[i]] for c, v in sorted(cols.items())} for i in range(Pj)]


@pytest.mark.parametrize("name", [n for n in G.CORPUS if n not in G.PORT_ONLY])
def test_corpus_query_on_two_ranks_equals_the_reference(name, gang_corpus):
    jc = J.DryadContext(num_partitions_=P)
    floats = [c for (n, c) in FLOAT_BOUNDS if n == name]
    for (gcap, gparts), q in zip(gang_corpus[0][name], G.CORPUS[name](jc)):
        _same_partitions(name, gparts, _reference_partitions(jc, q), floats)


@pytest.mark.parametrize("capacity", [None, 40], ids=["padded", "capacity"])
def test_staged_exchange_on_two_ranks_equals_one_process(capacity):
    """``exchange_staged`` over a 2-rank gloo group at windows 1-3 gives
    the one-process flat exchange's bytes, padding cells included, and
    its flag (the skewed input overflows into the fused resize), and a
    rank hands the group fewer bytes than the flat exchange's send
    buffer: its blocks for the other rank only."""
    windows = [0, 1, 2, 3]
    ranks = G.run_ranks(2, "staged_case", P, 3, windows, capacity)
    one = G.staged_apply(G.staged_inputs(P, 3), P, 0, capacity, None)
    for i, w in enumerate(windows):
        for c in ("k", "v", "w", "b", "valid", "overflow"):
            have = np.concatenate([r[i][c] for r in ranks]) if c != "overflow" else ranks[0][i][c]
            assert have.dtype == one[c].dtype and have.tobytes() == one[c].tobytes(), (w, c)
        assert ranks[1][i]["overflow"].tobytes() == one["overflow"].tobytes()
        if w:
            assert all(r[i]["sent"][0] < r[0]["sent"][0] for r in ranks), w
    assert bool(one["overflow"][0]) == (capacity is not None)


EXCHANGE_CORPUS = ["terasort", "group_by_sort_path", "hash_partition", "range_partition",
                   "distinct", "rank_ops", "zip", "join_inner_shuffle", "do_while"]


def test_corpus_at_window_one_on_two_ranks_equals_one_process(one_corpus):
    """The op corpus's exchanging queries at ``exchange_window=1`` over 2
    ranks: every exchange staged in rounds of one bucket, each partition's
    rows and capacity byte-equal to one process's flat exchanges at
    P = 4."""
    ranks = G.run_ranks(2, "corpus_case", P, EXCHANGE_CORPUS, 1)
    for name in EXCHANGE_CORPUS:
        outs = ranks[0][0][name]
        for j, (cap, parts) in enumerate(one_corpus[0][name]):
            assert outs[j][0] == ranks[1][0][name][j][0] == cap, name
            _same_partitions(name, outs[j][1] + ranks[1][0][name][j][1], parts)


def test_auto_window_on_two_ranks_equals_one_process(one_corpus):
    """``exchange_window=-1`` over 2 ranks: the ranks agree on one window
    (the narrowest any resolved), so every exchange runs one schedule
    and the rows equal one process's."""
    names = EXCHANGE_CORPUS[:3]
    ranks = G.run_ranks(2, "corpus_case", P, names, -1)
    for name in names:
        for j, (cap, parts) in enumerate(one_corpus[0][name]):
            assert ranks[0][0][name][j][0] == cap, name
            _same_partitions(name, ranks[0][0][name][j][1] + ranks[1][0][name][j][1], parts)


def test_corpus_reaches_every_op_kind(gang_corpus, one_corpus):
    """Each stage op kind of the registry runs in some corpus query, on
    the gang and in one process."""
    kinds = set(TK._KERNELS)
    assert kinds - gang_corpus[1] == set()
    assert kinds - one_corpus[1] == set()


# -- the gang through LocalJobSubmission ----------------------------------------------


class _CpuContext(T.DryadContext):
    def __init__(self, *args, **kw):
        kw.setdefault("device", "cpu")
        super().__init__(*args, **kw)


class _CpuSubmission(LocalJobSubmission):
    """Workers on the CPU, with a group timeout of 30 s: a gang that
    diverged fails its test instead of the suite's time limit."""

    def __init__(self, *args, **kw):
        kw.setdefault("device", "cpu")
        kw.setdefault("worker_timeout", 60.0)
        super().__init__(*args, **kw)


def _cpu_copy(name: str):
    mod = _port_copy(name)
    mod.DryadContext = _CpuContext
    mod.LocalJobSubmission = _CpuSubmission
    return mod


GANG_CASES = [
    ("test_localjob", f"test_{n}") for n in (
        "wordcount_across_processes", "second_submit_reuses_worker_gang",
        "injected_fault_retries_across_gang", "persistent_fault_surfaces_as_job_failure",
        "do_while_across_gang", "apply_host_across_gang", "gang_telemetry_merges_worker_spans",
    )
] + [
    ("test_gang_elastic", "test_gang_member_death_mid_job_auto_shrinks"),
    ("test_gang_elastic", "test_auto_recover_off_raises"),
    ("test_gangtree", "test_windowed_depths_match_serial"),
    ("test_gangtree", "test_submit_many_clamps_heterogeneous_command_batch"),
]


@pytest.mark.parametrize("case", GANG_CASES, ids=lambda c: f"{c[0]}::{c[1]}")
def test_reference_gang_case_on_the_port(case, tmp_path):
    name, fname = case
    mod = _cpu_copy(name)
    fn = getattr(mod, fname)
    teardown = []
    values = {"tmp_path": tmp_path}
    values.update({k: p.default for k, p in inspect.signature(fn).parameters.items()
                   if p.default is not inspect.Parameter.empty})
    try:
        fn(**_resolve(mod, fn, values, teardown))
    finally:
        for gen in reversed(teardown):
            for _ in gen:
                pass


def _wordcount(ctx, words):
    return (ctx.from_arrays({"word": words}).group_by("word", {"count": ("count", None)})
            .order_by([("count", True), "word"]))


GANG_KINDS = ("worker_started", "worker_joined", "gang_run_start", "gang_run_complete",
              "assemble_fetch", "gang_straggler", "gang_rebuild", "gang_member_lost_mid_job",
              "command_batch", "gang_window")


def test_wordcount_through_both_gangs():
    """The reference's gang (2 workers x 2 CPU devices) and the port's
    (2 workers x 2 partitions) give the same table, byte for byte, and
    the same driver-side gang events in order."""
    rng = np.random.default_rng(5)
    vocab = np.array([f"w{i:02d}" for i in range(40)], object)
    words = vocab[rng.integers(0, len(vocab), 3000)]
    tables, kinds = [], []
    for mod, Sub, kw in ((J, JLocalJobSubmission, {}),
                         (T, _CpuSubmission, {"device": "cpu"})):
        with Sub(num_workers=2, devices_per_worker=2) as sub:
            tables.append(sub.submit(_wordcount(mod.DryadContext(num_partitions_=8, **kw), words)))
            kinds.append([e["kind"] for e in sub.events.events() if e["kind"] in GANG_KINDS])
    ref, port = tables
    assert list(ref) == list(port)
    assert ref["word"].tolist() == port["word"].tolist()
    assert ref["count"].dtype == port["count"].dtype
    assert ref["count"].tobytes() == port["count"].tobytes()
    assert kinds[0] == kinds[1]
    assert kinds[1][-3:] == ["gang_run_start", "gang_run_complete", "assemble_fetch"]


def test_a_divergent_rank_fails_the_submission_naming_the_stage():
    """One rank fails before its exchange, its peer waits inside it: the
    peer's collective times out (half the submission's timeout) and the
    submission fails with an error naming the stage, well inside the
    submission's timeout."""
    tbl = {"k": np.random.default_rng(2).integers(-50, 50, 600).astype(np.int32)}
    with _CpuSubmission(num_workers=2, devices_per_worker=2, worker_timeout=20.0) as sub:
        q = _CpuContext(num_partitions_=4).from_arrays(tbl).group_by("k", {"c": ("count", None)})
        healthy = sub.submit(q)  # a healthy gang first
        sub.inject_fault("group_by", count=100, workers=[1])
        t0 = time.monotonic()
        with pytest.raises(RuntimeError) as ei:
            sub.submit(q, auto_recover=False)
        took = time.monotonic() - t0
        # the group is out of step: the next submission restarts the
        # gang at its size and runs clean
        sub.inject_fault(None, workers=[1])
        again = sub.submit(q, auto_recover=False)
        rebuilds = [e for e in sub.events.events() if e["kind"] == "gang_rebuild"]
    msg = str(ei.value)
    assert "GangStageError" in msg and "stage 'input+group_by'" in msg and "rank 0 of 2" in msg, msg
    assert took < 20.0, took
    assert [(e["workers"], e["dead"]) for e in rebuilds] == [(2, [])]
    assert sorted(again) == sorted(healthy)
    for c in healthy:
        assert again[c].tobytes() == healthy[c].tobytes(), c


def test_cross_process_run_loads_neither_jax_nor_the_reference_in_gang_workers():
    """A gang worker's process holds no module of jax or the JAX
    package after running a plan (the plan's host function reports its
    process's modules)."""
    with _CpuSubmission(num_workers=2, devices_per_worker=1) as sub:
        ctx = _CpuContext(num_partitions_=2)
        q = ctx.from_arrays({"x": np.arange(8, dtype=np.int32)}).apply_host(
            G.forbidden_modules, schema=G.forbidden_schema())
        out = sub.submit(q)
    assert out["bad"].tolist() == [0, 0] and sorted(out["pid"].tolist()) == [0, 1]
