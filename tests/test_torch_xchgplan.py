"""The exchange planner and the staged exchange of the port
(``dryad_tpu_torch/plan/xchgplan.py``, ``ops/shuffle.py::exchange_staged``,
the executor's window and its ``exchange_round`` events) against the JAX
package on its 8-device CPU mesh, after tests/test_xchgplan.py.

- The planner's schedules, their accounting, ``flat_accounting`` and
  ``resolve_window`` equal the reference's over a grid of partition
  counts, windows, slice counts, hints and measured headrooms.
- ``exchange_staged`` gives the flat exchange's bytes, padding cells
  included, at windows 1, 2 and 8, on the flat mesh and the 2 x 4
  hybrid mesh, skewed and not, in the padded layout and with a fused
  resize; and both equal the reference's exchange (and its resize)
  slot for slot.
- The ``exchange_round`` events of ``hash_partition``, ``order_by`` and
  a shuffle join equal the reference's field for field at windows 0
  and 2, and ``JobMetrics`` folds them as the reference's does.
- ``exchange_window=-1`` resolves as the reference's: staged under a
  tight budget, flat under a roomy one, the rewriter's hint first.
"""

import itertools

import numpy as np
import pytest
import torch

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.columnar.schema import ColumnType as JCT
from dryad_tpu.columnar.schema import Schema as JSchema
from dryad_tpu.obs.metrics import JobMetrics as JJobMetrics
from dryad_tpu.ops import hash as JH
from dryad_tpu.ops import shuffle as JSH
from dryad_tpu.parallel import mesh as JM
from dryad_tpu.parallel.distribute import from_host_table
from dryad_tpu.parallel.stage import compile_stage
from dryad_tpu.plan import xchgplan as JXP
from dryad_tpu_torch.columnar.batch import ColumnBatch, to_host_column
from dryad_tpu_torch.columnar.schema import ColumnType, Schema
from dryad_tpu_torch.obs.metrics import JobMetrics as TJobMetrics
from dryad_tpu_torch.ops import hash as TH
from dryad_tpu_torch.ops import shuffle as TSH
from dryad_tpu_torch.parallel import mesh as TM
from dryad_tpu_torch.plan import xchgplan as TXP

P = 8
MB = 1 << 20

# -- the planner ---------------------------------------------------------------


def _sched(m, P, window, dcn):
    s = m.plan_exchange(P, window, dcn)
    return (s.num_partitions, s.dcn_slices, s.ici_partitions, s.window, s.num_rounds,
            s.dcn_rounds, s.peak_width, [(r.index, r.hops, r.dcn, r.width) for r in s.rounds],
            s.accounting(37, 13))


PLANS = [(p, w, d) for p in (1, 2, 4, 8, 12, 16) for w in (1, 2, 3, 8, 20) for d in (1, 2, 4)
         if p % d == 0]


@pytest.mark.parametrize("P_,window,dcn", PLANS)
def test_plan_and_accounting_equal_the_reference(P_, window, dcn):
    assert _sched(TXP, P_, window, dcn) == _sched(JXP, P_, window, dcn)
    for rows, rb in ((1, 1), (128, 9), (4096, 21)):
        assert TXP.flat_accounting(P_, dcn, rows, rb) == JXP.flat_accounting(P_, dcn, rows, rb)


@pytest.mark.parametrize("bad", [(0, 1, 1), (8, 0, 1), (8, 1, 3), (8, 1, 0)])
def test_plan_refuses_what_the_reference_refuses(bad):
    for m in (TXP, JXP):
        with pytest.raises(ValueError):
            m.plan_exchange(*bad)


WINDOW_GRID = list(itertools.product(
    (-1, 0, 1, 3), (0, 1, 2, 8, 16), (0, 1, MB, 3 * MB), (1, 4 * MB, 8 * MB, 1 << 30),
    (None, -4, 0, 3, 99), (None, MB, 8 * MB)))


def test_resolve_window_equals_the_reference_over_a_grid():
    for cfg, P_, bucket, budget, hint, headroom in WINDOW_GRID:
        args = (cfg, P_, bucket, budget)
        kw = dict(hint=hint, headroom_bytes=headroom)
        assert TXP.resolve_window(*args, **kw) == JXP.resolve_window(*args, **kw), (args, kw)


def test_resolve_window_precedence():
    # the static knob, then the hint, then the measured headroom, then the budget
    assert TXP.resolve_window(2, 8, MB, 8 * MB, hint=5, headroom_bytes=MB) == 2
    assert TXP.resolve_window(-1, 8, MB, 8 * MB, hint=3, headroom_bytes=MB) == 3
    assert TXP.resolve_window(-1, 8, MB, 8 * MB, headroom_bytes=MB) == 1
    assert TXP.resolve_window(-1, 8, MB, 4 * MB) == 4
    assert TXP.resolve_window(-1, 8, MB, 8 * MB) == 0


# -- the staged exchange against the flat one and the reference's ---------------

FIELDS = [("k", "INT32"), ("v", "FLOAT32"), ("b", "BOOL")]


def _both(jmesh, seed, skew, cap=128, n=900):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 97, n).astype(np.int32)
    if skew:  # most rows target one destination
        k = np.where(rng.random(n) < 0.7, 3, k).astype(np.int32)
    t = {"k": k, "v": rng.standard_normal(n).astype(np.float32), "b": rng.random(n) < 0.5}
    jb = from_host_table(JSchema([(c, getattr(JCT, ct)) for c, ct in FIELDS]), t, jmesh,
                         partition_capacity=cap)
    tb = ColumnBatch.from_numpy(Schema([(c, getattr(ColumnType, ct)) for c, ct in FIELDS]), t, P,
                                "cpu", partition_capacity=cap)
    return jb, tb


def _flat(t):
    return to_host_column(t.reshape(-1))


def _same_as_reference(jbatch, tbatch):
    jv, jcols, _ = jbatch.fetch_host()
    np.testing.assert_array_equal(_flat(tbatch.valid), jv)
    for c, a in jcols.items():
        np.testing.assert_array_equal(_flat(tbatch.data[c]).view(np.uint8), a.view(np.uint8),
                                      err_msg=c)


def _same(a, b):
    assert torch.equal(a.valid, b.valid)
    assert sorted(a.data) == sorted(b.data)
    for c in a.data:
        assert a.data[c].dtype == b.data[c].dtype and torch.equal(a.data[c], b.data[c]), c


MESHES = {"flat": (1, lambda: J.parallel.mesh.make_mesh(P), lambda: None),
          "2x4": (2, lambda: JM.make_hybrid_mesh(2, 4), lambda: TM.make_hybrid_mesh(2, 4, "cpu"))}


@pytest.mark.parametrize("skew", [False, True], ids=["uniform", "skewed"])
@pytest.mark.parametrize("layout", ["flat", "2x4"])
def test_staged_equals_flat_and_the_reference(layout, skew):
    dcn, jmesh_of, tmesh_of = MESHES[layout]
    jmesh, tmesh = jmesh_of(), tmesh_of()
    axes = JM.mesh_axes(jmesh)
    jb, tb = _both(jmesh, 11 if skew else 7, skew)
    B = TSH.bucket_capacity(tb.capacity, P, 1.0 if skew else 2.0)
    resized = 96  # a fused resize that drops rows (every partition holds ~112)
    flags = {}

    def ref(staged_window, cap):
        def stage(sharded, _):
            (b,) = sharded
            dest = JH.partition_ids([b["k"]], P)
            if staged_window:
                out, ovf = JSH.exchange_staged(b, dest, P, B, axes,
                                               JXP.plan_exchange(P, staged_window, dcn))
            else:
                out, ovf = JSH.exchange(b, dest, P, B, axes)
            if cap is not None:
                out, ovf2 = JSH.resize(out, cap)
                ovf = ovf | (jax_psum_any(ovf2, axes))
            return (out,), (ovf,)

        return compile_stage(jmesh, stage)((jb,), ())

    dest = TH.partition_ids([tb.data["k"]], P)
    for cap in (None, resized):
        (jflat,), (jovf,) = ref(0, cap)
        flat, fovf = TSH.exchange(tb, dest, P, B, capacity=cap, mesh=tmesh)
        _same_as_reference(jflat, flat)
        assert bool(fovf) == bool(jovf)
        flags[cap] = bool(fovf)
        for window in (1, 2, 8):
            out, ovf = TSH.exchange_staged(tb, dest, P, B, TXP.plan_exchange(P, window, dcn),
                                           capacity=cap, mesh=tmesh)
            _same(out, flat)  # padding cells included
            assert bool(ovf) == bool(fovf)
            if cap is None:
                (jst,), _ = ref(window, None)
                _same_as_reference(jst, out)
    assert flags == {None: skew, resized: True}


def jax_psum_any(flag, axes):
    import jax
    import jax.numpy as jnp

    return jax.lax.psum(flag.astype(jnp.int32), axes) > 0


def test_row_bytes_counts_a_carrier_word_as_the_reference_does():
    """A uint32 word rides as int64 on the device; the planner's row
    footprint counts it as the reference's 4 bytes."""
    t = {"s": np.array(["a", "bb", "a"], object), "x": np.arange(3, dtype=np.int64),
         "f": np.ones(3, np.float32)}
    ctx = J.DryadContext(num_partitions_=P)
    jb = ctx._execute_device(ctx.from_arrays(t))
    tctx = T.DryadContext(num_partitions_=P, device="cpu")
    tb = tctx.execute(tctx.from_arrays(t))
    assert TSH.row_bytes(tb) == JSH.row_bytes(jb) == 1 + 4 * 4 + 2 * 4 + 4


# -- exchange_round events -------------------------------------------------------


def _tables(n=600, seed=3):
    rng = np.random.default_rng(seed)
    left = {"k": rng.integers(-50, 50, n).astype(np.int32), "v": rng.standard_normal(n).astype(np.float32),
            "w": rng.integers(0, 2**20, n).astype(np.int64)}
    right = {"k": np.arange(-50, 50, dtype=np.int32), "r": np.arange(100, dtype=np.int32)}
    return left, right


QUERIES = {
    "hash_partition": lambda c, l, r: c.from_arrays(l).hash_partition(["k"]),
    "order_by": lambda c, l, r: c.from_arrays(l).order_by([("v", False)]),
    "shuffle_join": lambda c, l, r: c.from_arrays(l).join(c.from_arrays(r), "k", strategy="shuffle"),
}
ROUND_FIELDS = ("stage", "name", "round", "window", "bytes", "ici_bytes", "dcn_bytes")


def _job(pkg, query, window, **mesh):
    cfg = dict(exchange_window=window)
    if pkg is J:
        ctx = J.DryadContext(config=J.DryadConfig(**cfg), **mesh)
        evs_of = ctx.executor.events.events
    else:
        ctx = T.DryadContext(config=T.DryadConfig(**cfg), device="cpu", **mesh)
        evs_of = ctx.events.events
    left, right = _tables()
    out = QUERIES[query](ctx, left, right).collect()
    return out, evs_of()


def _rounds(evs):
    ids = {}
    out = []
    for e in evs:
        if e["kind"] == "exchange_round":
            r = {f: e[f] for f in ROUND_FIELDS}
            r["stage"] = ids.setdefault(r["stage"], len(ids))
            out.append(r)
    return out


@pytest.mark.parametrize("window", [0, 2])
@pytest.mark.parametrize("query", list(QUERIES))
def test_exchange_round_events_equal_the_reference(query, window):
    jout, jevs = _job(J, query, window, num_partitions_=P)
    tout, tevs = _job(T, query, window, num_partitions_=P)
    for c in jout:
        a, b = np.sort(np.asarray(jout[c])), np.sort(np.asarray(tout[c]))
        assert a.tobytes() == b.tobytes(), c
    jr, tr = _rounds(jevs), _rounds(tevs)
    assert tr == jr and tr
    assert all(e["window"] == window for e in tr)
    assert all("qid" in e for e in tevs if e["kind"] == "exchange_round")
    jm, tm = JJobMetrics.from_events(jevs), TJobMetrics.from_events(tevs)
    for f in ("exchange_rounds", "peak_exchange_bytes", "exchange_ici_bytes"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert tm.exchange_rounds == len(tr)
    assert tm.peak_exchange_bytes == max(e["bytes"] for e in tr)


def test_staged_peak_scales_with_the_window_not_p():
    """The reference's bounded-peak contract on the port's events: the
    flat peak is P blocks, the staged peak ``window`` blocks, and both
    ship the same ICI bytes."""
    _, staged = _job(T, "hash_partition", 2, num_partitions_=P)
    _, flat = _job(T, "hash_partition", 0, num_partitions_=P)
    s, f = _rounds(staged), _rounds(flat)
    assert max(e["bytes"] for e in s) * P == max(e["bytes"] for e in f) * 2
    assert sum(e["ici_bytes"] for e in s) == sum(e["ici_bytes"] for e in f)


# -- the auto window -------------------------------------------------------------


def _auto_table(n=40000, seed=9):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 500, n).astype(np.int32), "v": rng.standard_normal(n).astype(np.float32),
            "w": rng.standard_normal(n).astype(np.float32), "u": rng.integers(0, 9, n).astype(np.int64)}


def _auto(pkg, window, budget_mb=1024, hint=None):
    cfg = dict(exchange_window=window, exchange_hbm_budget_mb=budget_mb)
    if pkg is J:
        ctx = J.DryadContext(num_partitions_=P, config=J.DryadConfig(**cfg))
        log = ctx.executor.events
    else:
        ctx = T.DryadContext(num_partitions_=P, config=T.DryadConfig(**cfg), device="cpu")
        log = ctx.events
    if hint is not None:
        ctx.rewriter.retune_exchange(hint)
    out = ctx.from_arrays({k: v.copy() for k, v in _auto_table().items()}).hash_partition("k").collect()
    return out, [e["window"] for e in log.events() if e["kind"] == "exchange_round"]


@pytest.mark.parametrize("budget_mb,hint", [(1, None), (4096, None), (4096, 3), (1, 0)])
def test_auto_window_resolves_as_the_reference(budget_mb, hint):
    """``exchange_window=-1``: a 1 MiB budget cannot hold the flat send
    buffer (staged), a roomy one can (flat), and the rewriter's
    ``retune_exchange`` hint wins over either; rows byte-equal to the
    flat run, the windows equal to the reference's."""
    flat, _ = _auto(T, 0)
    out, windows = _auto(T, -1, budget_mb, hint)
    _, jwindows = _auto(J, -1, budget_mb, hint)
    assert windows == jwindows and windows
    if hint is not None:
        assert set(windows) == {hint}
    elif budget_mb == 1:
        assert all(w > 0 for w in windows)
    else:
        assert set(windows) == {0}
    for c in flat:
        assert flat[c].tobytes() == out[c].tobytes(), c


def test_auto_window_follows_the_measured_headroom():
    """The measured headroom, rounded down to a power of two, beats the
    budget: a provider reporting just over 1 MiB stages the job a roomy
    budget would keep flat, at the reference's window."""

    class Headroom:
        def headroom_bytes(self):
            return MB + 12345

    windows = []
    for ctx in (J.DryadContext(num_partitions_=P, config=J.DryadConfig(
                    exchange_window=-1, exchange_hbm_budget_mb=4096)),
                T.DryadContext(num_partitions_=P, device="cpu", config=T.DryadConfig(
                    exchange_window=-1, exchange_hbm_budget_mb=4096))):
        ctx.executor.headroom = Headroom()
        ctx.from_arrays(_auto_table()).hash_partition("k").collect()
        windows.append([e["window"] for e in ctx.events.events() if e["kind"] == "exchange_round"])
    assert windows[1] == windows[0] and windows[1][0] >= 1
