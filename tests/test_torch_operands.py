"""The operand pool of the port (``dryad_tpu_torch/exec/operands.py``)
against the reference's ``DeviceOperandPool``: the same table sequence
gives the same ``hits``, ``full_uploads`` and ``delta_scatters``, the
same ``operand_h2d_bytes`` and ``h2d_bytes``, and device tensors equal
to each table's arrays; a delta of more than half the rows uploads in
full; concurrent ``get`` calls leave the resident sha and tensors in
agreement.  Through a context, a vocabulary that widens within one tier
(in core, and chunk by chunk in a stream) scatters its delta in both
packages with equal counters, and the flight recorder's
``operand_pool`` probe reads them.
"""

import threading

import numpy as np
import pytest
import torch

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.columnar.schema import StringDictionary as JDict
from dryad_tpu.exec.operands import DeviceOperandPool as JPool
from dryad_tpu.obs.metrics import MetricsRegistry as JMetrics
from dryad_tpu.ops import stringcode as JSC
from dryad_tpu_torch.columnar.batch import to_host_column
from dryad_tpu_torch.columnar.schema import StringDictionary as TDict
from dryad_tpu_torch.exec.operands import DeviceOperandPool as TPool
from dryad_tpu_torch.obs import flightrec
from dryad_tpu_torch.obs.metrics import MetricsRegistry as TMetrics
from dryad_tpu_torch.ops import stringcode as TSC

P = 8


def _tables(n0, n1, subset=False):
    """(reference, port) code and decode tables of a dictionary of n0,
    then n1 strings."""
    out = []
    for D, SC in ((JDict, JSC), (TDict, TSC)):
        d = D()
        hs = [d.add(f"s{i}") for i in range(n0)]
        t0 = SC.build_tables(d) if not subset else SC.build_tables_subset(d, np.asarray(hs, np.uint64))
        hs += [d.add(f"s{i}") for i in range(n0, n1)]
        t1 = SC.build_tables(d) if not subset else SC.build_tables_subset(d, np.asarray(hs, np.uint64))
        out.append((t0, t1))
    return out


def _state(pool, metrics):
    return (pool.hits, pool.full_uploads, pool.delta_scatters, len(pool._tiers),
            metrics.counter("operand_h2d_bytes"), metrics.counter("h2d_bytes"))


def _equal_content(dev, obj):
    for got, want in zip(dev, obj.operand_arrays()):
        got = to_host_column(got) if want.dtype == np.uint32 else got.numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("subset", [False, True])
def test_widening_within_a_tier_counts_as_the_reference(subset):
    """100 -> 120 strings stays in the 128 tier: the code and decode
    tables scatter their deltas; the same content again is a hit; an
    earlier table (a retry of an earlier job) scatters back."""
    (jt0, jt1), (tt0, tt1) = _tables(100, 120, subset)
    jm, tm = JMetrics(), TMetrics()
    jp, tp = JPool(metrics=jm), TPool("cpu", metrics=tm)
    seq = [0, 1, 1, 0, 1]  # (code, decode) of table 0 or 1
    for i in seq:
        for k in (0, 1):
            jp.get((jt0, jt1)[i][k])
            dev = tp.get((tt0, tt1)[i][k])
            _equal_content(dev, (tt0, tt1)[i][k])
            assert _state(tp, tm) == _state(jp, jm)
    assert tp.delta_scatters >= 2 and tp.hits == 2 and tp.full_uploads == 2
    assert 0 < tm.counter("operand_h2d_bytes") == tm.counter("h2d_bytes")


class _Table:
    """An operand-protocol object over given arrays."""

    def __init__(self, arrays, sha):
        self._a, self._sha = arrays, sha

    def operand_arrays(self):
        return self._a

    def operand_sha(self):
        return self._sha


def test_delta_over_half_the_rows_uploads_in_full():
    """A change of more than half a table's rows uploads in full in both
    packages, exactly half scatters (an append-only widening stays in
    its tier at no more than half: it scatters, as the first part shows)."""
    (jt0, jt1), (tt0, tt1) = _tables(40, 62)
    jm, tm = JMetrics(), TMetrics()
    jp, tp = JPool(metrics=jm), TPool("cpu", metrics=tm)
    for j, t in ((jt0, tt0), (jt1, tt1)):
        for k in (0, 1):
            jp.get(j[k])
            _equal_content(tp.get(t[k]), t[k])
    assert _state(tp, tm) == _state(jp, jm)
    assert (tp.full_uploads, tp.delta_scatters) == (2, 2)
    base = np.arange(16, dtype=np.int32)
    for pool in (JPool(metrics=JMetrics()), TPool("cpu", metrics=TMetrics())):
        pool.get(_Table([base], "a"))
        pool.get(_Table([base + 1], "b"))  # 16 of 16 rows changed
        assert (pool.full_uploads, pool.delta_scatters) == (2, 0)
        pool.get(_Table([np.where(base < 8, base + 1, base + 2)], "c"))  # 8 of 16
        assert (pool.full_uploads, pool.delta_scatters) == (2, 1)


def test_concurrent_gets_keep_sha_and_tensors_in_agreement():
    (_, _), (tt0, tt1) = _tables(100, 120)
    pool = TPool("cpu", metrics=TMetrics())
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(60):
                obj = (tt0, tt1)[int(rng.integers(0, 2))][0]
                _equal_content(pool.get(obj), obj)
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    ((sha, host, dev),) = pool._tiers.values()
    obj = tt0[0] if sha == tt0[0].operand_sha() else tt1[0]
    assert sha == obj.operand_sha()
    _equal_content(dev, obj)
    assert pool.hits + pool.full_uploads + pool.delta_scatters == 360


def _widen_ctx_runs(ctx):
    rng = np.random.default_rng(2)
    w1 = np.array([f"a{i}" for i in range(70)])
    w2 = np.array([f"a{i}" for i in range(100)])  # 70 -> 100: both in the 128 tier
    outs = []
    for w, n in ((w1, 330), (w2, 300)):
        t = {"w": np.concatenate([w, rng.choice(w, n)])}
        outs.append(ctx.from_arrays(t).group_by("w", {"c": ("count", None)}).collect())
    return outs


def _ctx_state(ctx):
    pool, m = ctx.executor.operand_pool, ctx.executor.metrics
    return (pool.hits, pool.full_uploads, pool.delta_scatters, len(pool._tiers),
            m.counter("operand_h2d_bytes"), m.counter("h2d_bytes"))


def test_in_core_widening_scatters_as_the_reference():
    jc = J.DryadContext(num_partitions_=P)
    tc = T.DryadContext(num_partitions_=P, device="cpu")
    jo, to = _widen_ctx_runs(jc), _widen_ctx_runs(tc)
    for a, b in zip(jo, to):
        assert sorted(zip(a["w"].tolist(), a["c"].tolist())) == sorted(zip(b["w"].tolist(), b["c"].tolist()))
    assert _ctx_state(tc) == _ctx_state(jc)
    assert tc.executor.operand_pool.delta_scatters > 0
    snap = flightrec._SHARED_PROBES["operand_pool"]()
    assert snap == {"tiers": 2, "hits": tc.executor.operand_pool.hits,
                    "full_uploads": tc.executor.operand_pool.full_uploads,
                    "delta_scatters": tc.executor.operand_pool.delta_scatters}


def test_stream_widening_scatters_as_the_reference():
    """The reference's widening stream (tests/test_runtime_tables.py):
    16 chunks whose vocabulary grows 40 words a chunk."""
    rng = np.random.default_rng(0)
    words = np.array([f"w{j:05d}" for j in range(50 + 15 * 40)])
    chunks = [{"w": rng.choice(words[: 50 + i * 40], 800)} for i in range(16)]
    outs, states = [], []
    for ctx in (J.DryadContext(num_partitions_=P), T.DryadContext(num_partitions_=P, device="cpu")):
        out = ctx.from_stream(iter([dict(c) for c in chunks])).group_by("w", {"c": ("count", None)}).collect()
        outs.append(sorted(zip([str(s) for s in out["w"]], np.asarray(out["c"]).tolist())))
        states.append(_ctx_state(ctx))
    assert outs[1] == outs[0]
    assert states[1] == states[0]
    assert states[1][2] > 0  # delta scatters


def test_runtime_tables_off_keeps_the_pool_idle():
    words = np.array([f"k{i}" for i in range(50)])
    t = {"w": np.random.default_rng(1).choice(words, 500)}
    for runtime, used in ((False, False), (True, True)):
        tc = T.DryadContext(num_partitions_=P, config=T.DryadConfig(stringcode_runtime_tables=runtime),
                            device="cpu")
        out = tc.from_arrays(t).group_by("w", {"c": ("count", None)}).collect()
        assert int(out["c"].sum()) == 500
        assert (tc.executor.operand_pool.full_uploads > 0) is used
