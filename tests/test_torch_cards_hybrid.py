"""The hybrid mesh over several devices (dryad_tpu_torch):
``DryadContext(devices=[...], dcn_slices=D)``, a rank thread a device, a
DCN slice of whole devices, each rank with an ICI sub-group (its
slice's devices) and a DCN sub-group (the devices at its place in every
slice).

Here the ranks run on the CPU (``devices=["cpu"] * W``) over gloo.  At
(W, D) = (2, 2), (4, 2), (8, 2) and (4, 4), P = 8, the port is held to
the reference's ``DryadContext(dcn_slices=D)`` on its 8 CPU devices on
the query cases of ``tests/test_torch_hybrid.py``: every partition's
rows (keys, integers and placement) byte-equal, float sums within the
bounds of the sort path (n_g * 2^-23 * sum_g |v|) or of the dense path
(2^-16 * sum_g |v|: the ranks reduce in another order), and the
``exchange_round`` events field for field.  The exchange over one axis
equals the one-device hybrid's slot for slot, flat and staged; a
stream's combine tree, a served query and a view read, a checkpointed
job and ``rebuild_mesh`` are held to the reference or to one device's
hybrid; the layouts a slice of whole devices cannot give raise.  Each
test runs under a time limit of its own (``TEST_LIMIT_S``).
"""

import signal

import numpy as np
import pytest
import torch

import dryad_tpu as J
import dryad_tpu_torch as T
import torch_gang as G
import test_torch_views as V
from dryad_tpu.parallel import mesh as JM
from dryad_tpu_torch.columnar.batch import ColumnBatch
from dryad_tpu_torch.columnar.schema import ColumnType, Schema
from dryad_tpu_torch.ops import hash as TH
from dryad_tpu_torch.ops import shuffle as TSH
from dryad_tpu_torch.parallel import mesh as TM
from dryad_tpu_torch.parallel.ranks import RankBatches
from dryad_tpu_torch.plan import xchgplan as TXP
from test_torch_checkpoint import _ckpt_events, _files
from test_torch_gang import _reference_partitions
from test_torch_hybrid import (
    AGGS, F32, _by, _equal, _group_bound, _neg_table, _np, _rounds, _sum_sq,
)

P = 8
LAYOUTS = [(2, 2), (4, 2), (8, 2), (4, 4)]
LAYOUT_IDS = [f"W{w}xD{d}" for w, d in LAYOUTS]
TEST_LIMIT_S = 120


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


_MADE: list = []


@pytest.fixture(autouse=True)
def close_ranks():
    """Each context over ranks a test made has its rank threads and
    groups closed when the test ends, not when it is collected."""
    yield
    while _MADE:
        _MADE.pop()._close_ranks()


def cards(W, D, P_=P, **cfg):
    tc = T.DryadContext(num_partitions_=P_, devices=["cpu"] * W, dcn_slices=D,
                        config=T.DryadConfig(**cfg))
    _MADE.append(tc)
    return tc


def one_hybrid(D, P_=P, **cfg):
    return T.DryadContext(num_partitions_=P_, dcn_slices=D, device="cpu",
                          config=T.DryadConfig(**cfg))


# -- the layout ---------------------------------------------------------------------


@pytest.mark.parametrize("W,D", LAYOUTS, ids=LAYOUT_IDS)
def test_a_slice_holds_whole_cards(W, D):
    """Card r holds partitions [r*L, (r+1)*L) and lies in slice r // C;
    each rank's sub-groups are its slice's C cards and the D cards at its
    position (none where the axis stays on one card)."""
    tc = cards(W, D)
    C, L = W // D, P // W
    assert tc._ranks.backend == "gloo"
    for r, m in enumerate(tc._ranks.meshes):
        assert m.hybrid and (m.dcn, m.ici, m.P, m.world, m.local) == (D, P // D, P, W, L)
        assert (m.slice_index, m.position, m.cards_per_slice) == (r // C, r % C, C)
        assert (m.ici_group is None) == (C == 1) and (m.dcn_group is None) == (D == 1)
        ici, dcn = m.axis_mesh(TM.AXIS), m.axis_mesh(TM.DCN_AXIS)
        assert (ici.world, ici.rank, ici.P, ici.base) == (C, r % C, P // D, (r % C) * L)
        assert (dcn.world, dcn.rank, dcn.P, dcn.strided) == (D, r // C, D * L, True)
        # global partition d * ici + p lies on card d * C + p // L
        for g in range(m.base, m.base + L):
            d, p = divmod(g, m.ici)
            assert d * C + p // L == r
    assert TM.mesh_axes(tc.mesh) == (TM.DCN_AXIS, TM.AXIS)
    assert TM.dcn_slice_count(tc.mesh) == D and TM.ici_partitions_per_slice(tc.mesh) == P // D
    # one sub-group a slice and one a position, each rank in exactly one of each
    assert len(tc._ranks.groups) == W + (W if C > 1 else 0) + (W if D > 1 else 0)


@pytest.mark.parametrize("W,D,P_,why", [
    (2, 4, 8, "a DCN slice holds whole cards"),
    (4, 3, 12, "a DCN slice holds whole cards"),
    (4, 2, 6, "not a multiple of the 4 devices"),
    (2, 0, 8, "dcn_slices 0 does not divide"),
], ids=["slices_split_a_card", "three_slices_of_four", "uneven_partitions", "no_slice"])
def test_a_layout_whose_slices_split_a_card_raises(W, D, P_, why):
    with pytest.raises(ValueError, match=why):
        cards(W, D, P_)


def test_a_gang_keeps_the_flat_mesh():
    """A gang's mesh (several ranks, a process group, no in-process
    link) refuses ``dcn_slices``, as the reference's LocalJobSubmission
    builds a flat mesh."""
    with pytest.raises(ValueError, match="a gang keeps the flat mesh"):
        TM.PartitionMesh(8, "cpu", rank=0, world=2, group=object(), backend="gloo", dcn_slices=2)
    assert TM.PartitionMesh(8, "cpu", rank=0, world=2, group=object(), backend="gloo").hybrid is False


# -- the query cases against the reference ----------------------------------------


_REF: dict = {}


def _ref_ctx(D, window=0):
    """The reference's hybrid context on its 8 CPU devices (one a
    (D, window), its results kept under ``_REF``)."""
    key = ("ctx", D, window)
    if key not in _REF:
        _REF[key] = J.DryadContext(dcn_slices=D, config=J.DryadConfig(exchange_window=window))
    return _REF[key]


def _since(rounds, mark):
    """The rounds from ``mark`` on, stage ids numbered from 0 among them."""
    ids = {}
    return [dict(r, stage=ids.setdefault(r["stage"], len(ids))) for r in rounds[mark:]]


def _ref_parts(D, name, build, window=0):
    """Each partition's rows of the reference's result, and the events
    of its run (kept)."""
    key = ("parts", D, name, window)
    if key not in _REF:
        jc = _ref_ctx(D, window)
        mark = len(_rounds(jc))
        parts = _reference_partitions(jc, build(jc))
        _REF[key] = (parts, _since(_rounds(jc), mark))
    return _REF[key]


def _port_parts(tc, build):
    mark = len(_rounds(tc))
    b = tc.execute(build(tc))
    assert isinstance(b, RankBatches) and len(b.parts) == len(tc.devices)
    return G.partition_rows(b)[1], _since(_rounds(tc), mark)


def _table():
    rng = np.random.default_rng(11)
    n = 2048
    return {"k": rng.integers(0, 64, n).astype(np.int32), "v": rng.standard_normal(n).astype(np.float32)}


def _neg():
    return _neg_table(5)


def _dims():
    return {"k": np.arange(-60, 64, dtype=np.int32), "x": (np.arange(124) % 7).astype(np.float32)}


def _words():
    t = _neg_table(6)
    return {"s": np.array([f"w{i}" for i in np.abs(t["k"])], object), "w": t["w"], "k": t["k"],
            "g": t["g"], "v": t["v"]}


def _sq():
    rng = np.random.default_rng(12)
    return {"k": rng.integers(-8, 8, 2048).astype(np.int32), "v": rng.standard_normal(2048).astype(np.float32)}


# name -> (build(ctx) -> query, the table its floats come from, the float
# columns: column -> (group keys, "sum" | "mean" | "dense" | "sq"))
QUERIES = {
    "group_by_dense": (lambda c: c.from_arrays(_table()).group_by(
        "k", {"s": ("sum", "v"), "c": ("count", None)}), _table, {"s": (["k"], "dense")}),
    "group_by_order_by": (lambda c: c.from_arrays(_table()).group_by(
        "k", {"m": ("mean", "v")}).order_by([("k", False)]), _table, {"m": (["k"], "dense_mean")}),
    "order_by": (lambda c: c.from_arrays(_table()).order_by([("v", False)]), _table, {}),
    "join_where": (lambda c: c.from_arrays(_neg()).join(c.from_arrays(_dims()), "k", "k").where(
        lambda x: x["x"] > 3.0), _neg, {}),
    "take": (lambda c: c.from_arrays(_table()).order_by([("v", False)]).take(10), _table, {}),
    "skip": (lambda c: c.from_arrays(_table()).order_by([("v", False)]).skip(2030), _table, {}),
    "distinct": (lambda c: c.from_arrays({"k": _table()["k"]}).distinct(), _table, {}),
    "distinct_tree": (lambda c: c.from_arrays({"k": _neg()["k"]}).distinct(), _neg, {}),
    "broadcast_join": (lambda c: c.from_arrays(_neg()).join(
        c.from_arrays({"k": np.arange(-4, 4, dtype=np.int32), "tag": np.ones(8, np.int32)}),
        "k", "k", strategy="broadcast"), _neg, {}),
    "decomposable_tree": (lambda c: c.from_arrays(_sq()).group_by(
        "k", decomposable=_sum_sq(J if isinstance(c, J.DryadContext) else T)), _sq,
        {"ss": (["k"], "sq")}),
    "sliding_window": (lambda c: c.from_arrays({"x": np.arange(24, dtype=np.int32)}).sliding_window(
        10, "x"), None, {}),
    "two_key_group_by": (lambda c: c.from_arrays(_neg()).group_by(["k", "g"], AGGS), _neg,
                         {"s": (["k", "g"], "sum"), "m": (["k", "g"], "mean")}),
    "string_group_by": (lambda c: c.from_arrays(_words()).group_by(
        "s", {"c": ("count", None), "sw": ("sum", "w")}), _words, {}),
    "dense_bucket": (lambda c: c.from_arrays(_dense()).group_by(
        "k", {"c": ("count", None), "s": ("sum", "v"), "sw": ("sum", "w")}), lambda: _dense(),
        {"s": (["k"], "dense")}),
}


def _dense():
    rng = np.random.default_rng(8)
    return {"k": rng.integers(0, 500, 4000).astype(np.int32),
            "v": rng.standard_normal(4000).astype(np.float32),
            "w": rng.integers(-100, 100, 4000).astype(np.int32)}


def _bound(table, keys, kind, part, col="v"):
    """Each row's bound of a float column of one partition's rows."""
    v = table[col].astype(np.float64)
    absv = np.abs(v * v) if kind == "sq" else np.abs(v)
    out = []
    for i in range(len(part[keys[0]])):
        sel = np.ones(len(absv), bool)
        for k in keys:
            sel &= table[k] == part[k][i]
        n, s = int(sel.sum()), float(absv[sel].sum())
        if kind.startswith("dense"):
            b = max(2.0 ** -16, n * F32) * s
            out.append(b / max(n, 1) if kind == "dense_mean" else b)
        else:
            out.append((1 if kind == "mean" else n) * F32 * s)
    return np.array(out)


def _same_parts(name, mine, ref, table, floats):
    assert len(mine) == len(ref), name
    for p, (a, b) in enumerate(zip(mine, ref)):
        assert sorted(a) == sorted(b), (name, p)
        for c in a:
            x, y = np.asarray(a[c]), np.asarray(b[c])
            assert x.dtype == y.dtype and x.shape == y.shape, (name, p, c)
            if c in floats:
                keys, kind = floats[c]
                diff = np.abs(x.astype(np.float64) - y.astype(np.float64))
                assert (diff <= _bound(table(), keys, kind, a)).all(), (name, p, c)
            else:
                assert x.tobytes() == y.tobytes(), (name, p, c)


@pytest.fixture(scope="module")
def port_parts():
    """Every named query on a context of each layout: (partitions, events)."""
    out = {}
    for W, D in LAYOUTS:
        tc = cards(W, D)
        for name, (build, _t, _f) in QUERIES.items():
            out[(W, D, name)] = _port_parts(tc, build)
    return out


@pytest.mark.parametrize("W,D", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("name", list(QUERIES))
def test_query_on_the_hybrid_cards_equals_the_reference(name, W, D, port_parts):
    build, table, floats = QUERIES[name]
    ref, ref_rounds = _ref_parts(D, name, build)
    mine, rounds = port_parts[(W, D, name)]
    _same_parts(name, mine, ref, table, floats)
    assert rounds == ref_rounds, name


@pytest.mark.parametrize("W,D", LAYOUTS, ids=LAYOUT_IDS)
def test_scalar_aggregates_on_the_hybrid_cards(W, D):
    t = _table()
    tc, jc = cards(W, D), _ref_ctx(D)
    got = [(c.from_arrays(t).count(), c.from_arrays(t).sum_("v"), c.from_arrays(t).min_("v"),
            c.from_arrays(_neg()).join(c.from_arrays(_dims()), "k", "k").count()) for c in (jc, tc)]
    assert got[0][0] == got[1][0] == len(t["k"])
    assert got[0][2] == got[1][2] == float(t["v"].min())
    assert abs(got[0][1] - got[1][1]) <= len(t["v"]) * F32 * np.abs(t["v"]).sum()
    assert got[0][3] == got[1][3]


@pytest.mark.parametrize("W,D", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("window", [0, 1, 2])
@pytest.mark.parametrize("salt", [None, 3])
def test_negative_key_tree_exchange_on_the_hybrid_cards(salt, window, W, D):
    """The tree exchange's ICI hop over the slice's cards, the per-slice
    reduce, the DCN hop over the cards at one position, flat or staged:
    every partition's rows and every ``exchange_round`` event the
    reference's."""
    build = lambda c: c.from_arrays(_neg()).group_by("k", AGGS, salt=salt)  # noqa: E731
    ref, ref_rounds = _ref_parts(D, ("tree", salt), build, window)
    mine, rounds = _port_parts(cards(W, D, exchange_window=window), build)
    _same_parts("tree", mine, ref, _neg, {"s": (["k"], "sum"), "m": (["k"], "mean")})
    assert rounds == ref_rounds and rounds
    assert all(r["window"] == window for r in rounds)
    dcn = [r for r in rounds if r["dcn_bytes"]]
    assert dcn and all(r["ici_bytes"] == 0 for r in dcn)


STAGED = {
    "terasort": lambda c: c.from_arrays(_neg()).order_by([("w", False), ("k", True)]),
    "shuffle_join": lambda c: c.from_arrays(_neg()).join(c.from_arrays(
        {"k": np.arange(-60, 60, dtype=np.int32), "r": np.arange(120, dtype=np.int32)}), "k",
        strategy="shuffle"),
    "zip": lambda c: c.from_arrays(_neg()).zip_(c.from_arrays(_neg()).where(lambda x: x["g"] > 0)),
}


@pytest.mark.parametrize("W,D,window", [(2, 2, 1), (8, 2, 1), (4, 2, 2), (4, 4, 2)],
                         ids=["W2xD2-1", "W8xD2-1", "W4xD2-2", "W4xD4-2"])
def test_staged_queries_on_the_hybrid_cards(window, W, D):
    """TeraSort, a shuffle join and the rank exchanges at a staged
    window over both axes (global pairs over the whole group): the
    reference's rows a partition and its events (its ICI rounds, then
    its DCN round)."""
    tc = cards(W, D, exchange_window=window)
    for name, build in STAGED.items():
        ref, ref_rounds = _ref_parts(D, ("staged", name), build, window)
        mine, rounds = _port_parts(tc, build)
        _same_parts(name, mine, ref, _neg, {})
        assert rounds == ref_rounds and any(r["dcn_bytes"] for r in rounds), name
        assert all(r["window"] == window for r in rounds), name


# -- the exchange over one axis against the one-device hybrid ------------------------


def _axis_case(D, axis, window, capacity):
    """The one-device hybrid's exchange over ``axis`` of a seeded batch
    at P = 8: (inputs, n, B, schedule, its output and flag)."""
    rng = np.random.default_rng(4)
    n_rows, cap = 700, 96
    t = {"k": rng.integers(-90, 90, n_rows).astype(np.int32),
         "v": rng.standard_normal(n_rows).astype(np.float32)}
    tb = ColumnBatch.from_numpy(Schema([("k", ColumnType.INT32), ("v", ColumnType.FLOAT32)]), t, P,
                                "cpu", partition_capacity=cap)
    n = P // D if axis == TM.AXIS else D
    dest = TH.partition_ids([tb.data["k"]], P) % n
    B = TSH.bucket_capacity(cap, n, 1.5)
    window = min(window, n - 1)
    sched = TXP.plan_exchange(n, window, 1 if axis == TM.AXIS else n) if window else None
    return tb, dest, n, B, sched, capacity


def _run_axis(tb, dest, n, B, sched, capacity, mesh, axis):
    if sched is None:
        return TSH.exchange(tb, dest, n, B, capacity=capacity, mesh=mesh, axis=axis)
    return TSH.exchange_staged(tb, dest, n, B, sched, capacity=capacity, mesh=mesh, axis=axis)


@pytest.mark.parametrize("W,D", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("window", [0, 1, 3])
@pytest.mark.parametrize("axis", ["ici", "dcn"])
@pytest.mark.parametrize("capacity", [None, 40], ids=["padded", "capacity"])
def test_exchange_over_one_axis_equals_the_one_device_hybrid(capacity, axis, window, W, D):
    """Each rank exchanges its own partitions over the axis's sub-group:
    the ranks' outputs, in partition order, are the one-device hybrid's
    slot for slot (padding included) and the flag its flag; no partition
    leaves its card to be reordered, and an axis of one card a slice
    sends nothing."""
    taxis = TM.AXIS if axis == "ici" else TM.DCN_AXIS
    case = _axis_case(D, taxis, window, capacity)
    tb, dest, n, B, sched, cap = case
    one, one_ovf = _run_axis(*case, mesh=TM.make_hybrid_mesh(D, P // D, "cpu"), axis=taxis)
    tc = cards(W, D)
    L = P // W

    def rank(rc):
        m = rc.mesh
        lo = m.base
        part = ColumnBatch({c: v[lo : lo + L] for c, v in tb.data.items()}, tb.valid[lo : lo + L])
        sent = m.sent_bytes
        out, ovf = _run_axis(part, dest[lo : lo + L], n, B, sched, cap, mesh=m, axis=taxis)
        sent = m.sent_bytes - sent
        return out, bool(T.parallel.partition.any_(ovf, m)), sent

    got = tc._ranks.run(rank)
    for c in one.data:
        assert torch.cat([g[0].data[c] for g in got]).numpy().tobytes() == one.data[c].numpy().tobytes(), c
    assert torch.equal(torch.cat([g[0].valid for g in got]), one.valid)
    assert all(g[1] == bool(one_ovf) for g in got)
    if taxis == TM.AXIS and W == D:  # one card a slice: the ICI hop stays on the card
        assert all(g[2] == 0 for g in got)
    elif sched is None or W // (D if taxis == TM.AXIS else W // D) > 1:
        assert all(g[2] > 0 for g in got)


def test_an_axis_exchange_needs_a_hybrid_mesh():
    """The flat context over ranks has no axis to exchange over."""
    tc = T.DryadContext(num_partitions_=P, devices=["cpu"] * 2)
    _MADE.append(tc)
    tb = ColumnBatch({"k": torch.zeros(4, 4, dtype=torch.int32)}, torch.ones(4, 4, dtype=torch.bool))
    dest = torch.zeros(4, 4, dtype=torch.int64)

    def rank(rc):
        with pytest.raises(ValueError, match="hybrid mesh"):
            TSH.exchange(tb, dest, 4, 8, mesh=rc.mesh, axis=TM.AXIS)
        return True

    assert all(tc._ranks.run(rank))


# -- a stream, serving, views, checkpoints, rebuild_mesh --------------------------------


def _aggtree_chunks(skew, nchunks=4, chunk_rows=512):
    """The reference's aggtree bench's chunks (``bench.py``'s child) at a
    small size: int64 keys at its three skews, int64 values."""
    rng = np.random.default_rng(3)
    out = []
    for _ in range(nchunks):
        if skew == "uniform":
            k = rng.integers(0, 50 * chunk_rows, chunk_rows)
        elif skew == "zipf":
            hot = rng.integers(0, 64, chunk_rows // 2)
            tail = rng.integers(64, 20 * chunk_rows, chunk_rows - chunk_rows // 2)
            k = np.concatenate([hot, tail])
            rng.shuffle(k)
        else:
            k = rng.integers(0, 4096, chunk_rows)
        out.append({"k": k.astype(np.int64), "v": rng.integers(-1000, 1000, chunk_rows).astype(np.int64)})
    return out


@pytest.mark.parametrize("W,D,skew", [(4, 2, "zipf"), (4, 4, "uniform")],
                         ids=["W4xD2-zipf", "W4xD4-uniform"])
def test_stream_combine_tree_on_the_hybrid_cards_equals_the_reference(W, D, skew):
    """The aggtree bench's stream, tree on and off: the reference's rows
    and combine-tree levels, and the one-device hybrid's ``stream_combine``
    and level events with their ICI/DCN split (the port's partial
    layouts are compacted, so its byte fields are its own)."""
    aggs = {"c": ("count", None), "s": ("sum", "v")}
    chunks = _aggtree_chunks(skew)
    for tree in (True, False):
        cfg = dict(combine_tree=tree, stream_combine_rows=512, obs_diagnosis=False,
                   plan_rewrite=False)
        got = []
        for c in (J.DryadContext(dcn_slices=D, config=J.DryadConfig(**cfg)),
                  one_hybrid(D, **cfg), cards(W, D, **cfg)):
            out = c.from_stream(iter([dict(x) for x in chunks])).group_by("k", aggs).collect()
            evs = c.executor.events.events() if isinstance(c, J.DryadContext) else c.events.events()
            comb = [(e["kind"], e.get("level"), e.get("ici_bytes"), e.get("dcn_bytes"))
                    for e in evs if e["kind"] in ("stream_combine", "combine_tree_level")]
            got.append((_by(out, ["k"]), comb))
        (ref, ref_ev), (one, one_ev), (mine, ev) = got
        _equal(ref, mine)
        _equal(one, mine)
        assert [e[:2] for e in ev] == [e[:2] for e in ref_ev] and ev, tree
        assert ev == one_ev, tree
        if tree:
            assert sum(x[3] or 0 for x in ev) > 0


@pytest.mark.parametrize("W,D", [(4, 2)], ids=["W4xD2"])
def test_served_query_and_view_read_equal_one_device_hybrid(W, D, monkeypatch):
    """A tree group_by served to 8 clients and a view's reads over appends
    on the hybrid cards: byte-equal to the one-device hybrid's."""
    from dryad_tpu_torch import serve as TS
    import threading

    t = _neg()
    q_of = lambda c: c.from_arrays(t).group_by("k", {"c": ("count", None), "sw": ("sum", "w")})  # noqa
    oc = one_hybrid(D)
    one = oc.run_to_host(q_of(oc))
    tc = cards(W, D)
    q = q_of(tc)
    results = [None] * 8
    with TS.QueryService(tc) as svc:
        sessions = [svc.session(f"t{i % 2}") for i in range(8)]
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, sessions[i].run(q, timeout=50))) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=55)
    for r in results:
        V._byte_equal(r, one)
    reads = {}
    for label, make in (("cards", lambda: cards(W, D)), ("one", lambda: one_hybrid(D))):
        monkeypatch.setattr(V, "_ctx", lambda pkg, **cfg: make())
        reads[label] = V._fuzz_script("port", 0, "group", "default")[0]
    assert len(reads["cards"]) == len(reads["one"]) > 0
    for (a, again, dispatched, _c), (b, *_r) in zip(reads["cards"], reads["one"]):
        V._byte_equal(a, b)
        V._byte_equal(again, a)
        assert dispatched == 0


def test_checkpointed_job_on_the_hybrid_cards_resumes(tmp_path):
    """The hybrid cards save the reference's checkpoint files and events
    of a tree group_by; a fresh context of the same layout and a
    one-device hybrid resume from them."""
    t = _neg()
    build = lambda c: c.from_arrays(t).group_by("k", {"c": ("count", None), "sw": ("sum", "w")}).order_by(  # noqa
        [("k", False)])
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jc = J.DryadContext(dcn_slices=2, config=J.DryadConfig(checkpoint_dir=jdir))
    want = build(jc).collect()
    tc = cards(4, 2, checkpoint_dir=tdir)
    got = build(tc).collect()
    _equal(_np(want), _np(got))
    assert _files(tdir) == _files(jdir) and _files(tdir)
    assert _ckpt_events(tc) == _ckpt_events(jc)
    for resumed in (cards(4, 2, checkpoint_dir=tdir), one_hybrid(2, checkpoint_dir=tdir)):
        out = build(resumed).collect()
        kinds = [e["kind"] for e in resumed.events.events()]
        assert "stage_checkpoint_hit" in kinds and "stage_checkpoint_saved" not in kinds
        _equal(_np(want), _np(out))


def test_rebuild_mesh_keeps_two_axes_over_four_cards():
    """Shedding card 1 of 2 x 2: slice 0 keeps card 0, slice 1 shrinks to
    card 2, so 2 x 1 at P = 4; the rerun equals a fresh hybrid of that
    shape and the one-device hybrid."""
    t = _neg()
    build = lambda c: c.from_arrays(t).group_by("k", AGGS)  # noqa: E731
    tc = cards(4, 2)
    tc.rebuild_mesh([1])
    assert [str(d) for d in tc.devices] == ["cpu"] * 2 and tc.num_partitions == 4
    assert (tc.mesh.dcn, tc.mesh.ici, tc.mesh.world, tc.mesh.hybrid) == (2, 2, 2, True)
    fresh = cards(2, 2, P_=4)
    a, b = _port_parts(tc, build), _port_parts(fresh, build)
    floats = {"s": (["k"], "sum"), "m": (["k"], "mean")}
    _same_parts("rebuilt", a[0], b[0], _neg, floats)
    assert len(a[0]) == 4 and a[1] == b[1] and a[1]
    one = tuple(_by(x, ["k"]) for x in (build(tc).collect(), build(one_hybrid(2, P_=4)).collect()))
    _equal(*one, {"s": _group_bound(t, ["k"], one[0]), "m": _group_bound(t, ["k"], one[0], mean=True)})


@pytest.mark.parametrize("bad", [[0], [5], [0, 1, 2, 3], [1, 6], [2, 7, 99], []])
def test_rebuild_mesh_shape_equals_the_references_exclusion(bad):
    """At W = 8 (one partition a card, a card for each of the reference's
    devices) the rebuilt shape is the reference's ``exclude_devices`` on
    its 2 x 4 mesh."""
    j2 = JM.exclude_devices(JM.make_hybrid_mesh(2, 4), bad)
    tc = cards(8, 2)
    tc.rebuild_mesh(bad)
    assert (tc.mesh.dcn, tc.mesh.ici, tc.num_partitions) == (
        j2.devices.shape[0], j2.devices.shape[1], j2.devices.size)
    assert len(tc.devices) == j2.devices.size
    with pytest.raises(ValueError, match="empty mesh"):
        cards(4, 2).rebuild_mesh(range(4))
