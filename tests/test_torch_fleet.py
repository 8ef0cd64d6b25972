"""The serving fleet (``dryad_tpu_torch/serve/fleet.py``,
``serve/replica.py``) against the JAX package's, after
``tests/test_fleet.py``: a front-door ``ProcessService`` before replicas
that each own a port ``DryadContext`` on the CPU (``device="cpu"``, P=4)
and a ``QueryService``, over the real HTTP mailbox.

Every result through front door, router and replica is byte-equal to
the port's direct run of the same query and to the reference's direct
run (the tables' float column feeds a mean only through integer-valued
floats, so the dense path's sums are exact in both packages); routing
(rendezvous owners, the latency-first batch order, the negative quota
memo, heartbeat reaping and submit-log replay) is held to the
reference's own fleet on the same packages' fingerprints.
"""

import os
import pickle
import textwrap
import time

import numpy as np
import pytest

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu.serve import fleet as JF
from dryad_tpu_torch.obs import critpath
from dryad_tpu_torch.serve import QueryRejected
from dryad_tpu_torch.serve import fleet as TF
from dryad_tpu_torch.serve.router import rendezvous_rank

P = 4


def _mk_data(rng, n=256, vocab=8):
    return {
        "k": np.asarray([f"w{i:03d}" for i in rng.integers(0, vocab, n)], object),
        "v": rng.integers(0, 1000, n).astype(np.int32),
        "w": rng.integers(0, 64, n).astype(np.float32),
    }


def _shapes(t):
    return [
        t.group_by("k", aggs={"s": ("sum", "v")}),
        t.group_by("k", aggs={"c": ("count", None)}),
        t.group_by("k", aggs={"m": ("mean", "w")}),
        t.distinct("k"),
        t.order_by("v").take(16),
    ]


def _tables_equal(a, b):
    assert set(a) == set(b), (set(a), set(b))
    for k in a:
        va, vb = np.asarray(a[k]), np.asarray(b[k])
        if va.dtype == object or vb.dtype == object:
            assert [str(x) for x in va] == [str(x) for x in vb], k
        else:
            assert va.dtype == vb.dtype, k
            assert va.tobytes() == vb.tobytes(), k


def _canonical(t):
    names = sorted(t)
    order = np.lexsort([np.asarray([str(x) for x in t[n]]) if np.asarray(t[n]).dtype == object
                        else np.asarray(t[n]) for n in names])
    return {n: np.asarray(t[n])[order] for n in names}


def _factory():
    return T.DryadContext(num_partitions_=P, config=T.DryadConfig(), device="cpu")


def _wait_router(fleet, pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        s = fleet.stats()["router"]
        if pred(s):
            return s
        time.sleep(0.01)
    return fleet.stats()["router"]


@pytest.fixture(scope="module")
def fleet_env():
    """One shared two-replica fleet, a client context holding the table
    (its bindings travel inside each job package) and the reference's
    context over the same table."""
    data = _mk_data(np.random.default_rng(0))
    ctx = _factory()
    t = ctx.from_arrays(data)
    jctx = J.DryadContext(num_partitions_=P)
    jt = jctx.from_arrays(data)
    fleet = TF.ServeFleet(hb_interval=0.2, stale_after=60.0)
    for rid in ("r0", "r1"):
        fleet.spawn_thread(rid, _factory)
    yield fleet, ctx, t, jctx, jt
    fleet.close()


# -- byte identity ------------------------------------------------------------


def test_fleet_byte_identical_to_direct_and_to_the_reference(fleet_env):
    fleet, ctx, t, jctx, jt = fleet_env
    for q, jq in zip(_shapes(t), _shapes(jt)):
        out = fleet.run(q, tenant="ident", timeout=120)
        _tables_equal(ctx.run_to_host(q), out)
        _tables_equal(_canonical(jctx.run_to_host(jq)), _canonical(out))


def test_fingerprint_affinity_and_prepared_reuse(fleet_env):
    """A plan resubmitted lands on its rendezvous owner every time, the
    owner the reference's router ranks first for the reference's
    package of the same plan, and its repeats hit that replica's cache."""
    fleet, ctx, t, jctx, jt = fleet_env
    c = TF.FleetClient(fleet.host, fleet.port, "affine")
    for q, jq in zip(_shapes(t)[:3], _shapes(jt)[:3]):
        blob, fp = TF.pack_for_fleet(q)
        assert fp == JF.pack_for_fleet(jq)[1]
        owners, cached = set(), []
        for _ in range(3):
            h = c.result_header(c.submit_package(blob, fingerprint=fp), timeout=120)
            assert h["ok"], h
            owners.add(h["replica"])
            cached.append(h["cached"])
        assert owners == {rendezvous_rank(fp, ["r0", "r1"])[0]}
        assert cached[1] and cached[2], cached
        table = c.result(c.submit_package(blob, fingerprint=fp), timeout=120)
        _tables_equal(ctx.run_to_host(q), table)


def test_distinct_plans_spread_over_replicas(fleet_env):
    fleet, ctx, t, jctx, jt = fleet_env
    qs = _shapes(t) + [t.take(n) for n in (3, 5, 7)]
    jqs = _shapes(jt) + [jt.take(n) for n in (3, 5, 7)]
    fps = [TF.pack_for_fleet(q)[1] for q in qs]
    # a value-portable plan has the reference's canonical fingerprint;
    # the others fall back to their package bytes' digest in both
    for fp, jfp in zip(fps, [JF.pack_for_fleet(q)[1] for q in jqs]):
        assert fp == jfp or fp.startswith("pkg:") and jfp.startswith("pkg:")
    assert len(set(fps)) == len(fps)
    assert {rendezvous_rank(fp, ["r0", "r1"])[0] for fp in fps} == {"r0", "r1"}


# -- tier ordering and framing --------------------------------------------------


def test_front_door_batches_order_latency_first(fleet_env):
    fleet = fleet_env[0]
    envs = [TF.make_envelope(qid=f"tier-{i}", tenant="tt", package=b"x",
                             tier=("batch" if i % 2 else "latency"))
            for i in range(6)] + [{"exit": True}]
    fleet._post_cmd("tier-probe", envs)
    seq = fleet._cmd_seq["tier-probe"] - 1
    posted = pickle.loads(fleet.mailbox.get_prop(TF.FLEET_PID, f"cmd/tier-probe/{seq}")[1])
    assert [e.get("tier") for e in posted] == ["latency"] * 3 + ["batch"] * 3 + [None]
    assert posted[-1].get("exit") is True
    for mod in (TF, JF):
        with pytest.raises(ValueError):
            mod.make_envelope(qid="q", tenant="t", package=b"x", tier="turbo")


def test_result_frames_equal_the_reference_and_decode_header_only():
    header = {"qid": "q", "ok": True, "cached": False, "seconds": 0.5, "replica": "r0",
              "generation": 3, "error": None, "rejected": None, "tenant": "t"}
    table = {"col": np.arange(1024)}
    blob = TF.encode_result(header, table)
    assert blob == JF.encode_result(header, table)
    assert TF.decode_result_header(blob) == header
    h2, t2 = TF.decode_result(blob)
    assert h2 == header and (t2["col"] == table["col"]).all()
    with pytest.raises(ValueError):
        TF.decode_result_header(b"XXnot-a-frame")
    for h in ({"ok": False, "qid": "q", "error": "boom", "rejected": None},
              {"ok": False, "tenant": "t", "rejected": {"reason": "bytes", "limit": 1,
                                                        "current": 2}}):
        with pytest.raises(Exception) as te:
            TF.raise_for_result(h)
        with pytest.raises(Exception) as je:
            JF.raise_for_result(h)
        assert str(te.value) == str(je.value)


# -- negative quota memo ---------------------------------------------------------


def test_quota_rejection_memoized_at_front_door():
    def tight_factory():
        return T.DryadContext(num_partitions_=P, device="cpu", config=T.DryadConfig(
            serve_max_bytes=1, serve_result_cache_bytes=0))

    t = _factory().from_arrays(_mk_data(np.random.default_rng(1)))
    q1, q2, q3 = _shapes(t)[:3]
    with TF.ServeFleet(hb_interval=0.2, stale_after=60.0, memo_ttl=30.0) as fleet:
        fleet.spawn_thread("solo", tight_factory)
        b1, f1 = TF.pack_for_fleet(q1)
        b2, f2 = TF.pack_for_fleet(q2)
        with pytest.raises(QueryRejected) as ei:
            fleet.result(fleet.submit(tenant="greedy", package=b1, fingerprint=f1), timeout=120)
        assert ei.value.reason == "bytes"
        s = _wait_router(fleet, lambda s: s["delivered"] >= 1)
        assert s["routed"] == 1, s
        with pytest.raises(QueryRejected) as ei2:
            fleet.result(fleet.submit(tenant="greedy", package=b2, fingerprint=f2), timeout=60)
        assert ei2.value.reason == "bytes"
        s = _wait_router(fleet, lambda s: s["fast_rejects"] >= 1)
        assert s["fast_rejects"] == 1 and s["routed"] == 1, s
        assert "fleet_rejected" in [e["kind"] for e in fleet.events.events()]
        b3, f3 = TF.pack_for_fleet(q3)
        with pytest.raises(QueryRejected):
            fleet.result(fleet.submit(tenant="polite", package=b3, fingerprint=f3), timeout=60)
        assert _wait_router(fleet, lambda s: s["routed"] >= 2)["routed"] == 2


# -- chaos: kill + replay ------------------------------------------------------------


def test_replica_death_replays_byte_identical_with_full_trace():
    ctx = _factory()
    data = _mk_data(np.random.default_rng(2), n=512)
    q = ctx.from_arrays(data).group_by("k", aggs={"s": ("sum", "v")})
    ref = ctx.run_to_host(q)
    jq = J.DryadContext(num_partitions_=P).from_arrays(data).group_by("k", aggs={"s": ("sum", "v")})
    blob, fp = TF.pack_for_fleet(q)
    with TF.ServeFleet(hb_interval=0.15, stale_after=0.8) as fleet:
        runners = {rid: fleet.spawn_thread(rid, _factory) for rid in ("r0", "r1")}
        owner = rendezvous_rank(fp, fleet.replicas.alive())[0]
        survivor = next(r for r in ("r0", "r1") if r != owner)
        fleet.kill_replica(owner)
        qid = fleet.submit(tenant="chaos", package=blob, fingerprint=fp)
        out = fleet.result(qid, timeout=120)
        _tables_equal(ref, out)
        _tables_equal(_canonical(jq.collect()), _canonical(out))
        s = _wait_router(fleet, lambda s: s["delivered"] >= 1)
        assert s["replayed"] == 1 and s["generation"] == 1 and s["dead"] == [owner], s
        mine = [e["kind"] for e in fleet.events.events()
                if e.get("query") == qid or e.get("replica") == owner]
        at = [mine.index(k) for k in ("fleet_submit", "replica_dead", "fleet_reroute",
                                      "fleet_result")]
        assert at == sorted(at), mine
        bd = critpath.fold_all(fleet.events.events()
                               + runners[survivor].svc.events.events()).get(qid)
        # the replayed run is attributed (its phases' share of the wall
        # time, ``coverage()``, follows the clock and the heartbeat wait)
        assert bd is not None and bd.total_s > 0 and bd.phases
        assert abs(sum(bd.phases.values()) - bd.total_s) < 1e-6


def test_all_replicas_dead_fails_loudly():
    t = _factory().from_arrays(_mk_data(np.random.default_rng(3), n=64))
    blob, fp = TF.pack_for_fleet(t.distinct("k"))
    with TF.ServeFleet(hb_interval=0.15, stale_after=0.6) as fleet:
        fleet.spawn_thread("only", _factory)
        fleet.kill_replica("only")
        qid = fleet.submit(tenant="t", package=blob, fingerprint=fp)
        with pytest.raises(RuntimeError, match="died|no replicas"):
            fleet.result(qid, timeout=60)


# -- fleet metrics ---------------------------------------------------------------------


def test_replica_snapshots_count_every_completion(fleet_env):
    """Each live replica posts its rolling SLO snapshot (the reference's
    metricsd fold is not ported); their completion counters sum to the
    queries the fleet delivered to them, and each post carries the
    replica's kernel launches."""
    fleet, ctx, t, _jctx, _jt = fleet_env
    for q in _shapes(t)[:4]:
        fleet.run(q, tenant="metrics", timeout=120)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        snaps = fleet.replica_snapshots()
        done = sum(c["total"] for s in snaps for c in s.get("counters", [])
                   if c["name"] == "queries_completed" and c["labels"].get("tenant") == "metrics")
        if len(snaps) == 2 and done == 4:
            break
        time.sleep(0.2)
    assert len(snaps) == 2 and done == 4
    for rid in ("r0", "r1"):
        post = pickle.loads(fleet.mailbox.get_prop(TF.FLEET_PID, f"stats/{rid}")[1])
        assert set(post) >= {"stats", "snapshot", "pid", "ts", "kernel_launches"}
        assert post["kernel_launches"]["bucket_sum_count"] >= 0


def test_close_is_idempotent():
    fleet = TF.ServeFleet(hb_interval=0.2)
    fleet.spawn_thread("r0", _factory)
    fleet.close()
    fleet.close()


# -- a replica process -------------------------------------------------------------


def test_process_replica_serves_and_dies_with_a_seeded_fault(tmp_path):
    """``python -m dryad_tpu_torch.serve.replica`` with a bootstrap that
    builds a CPU context: it serves byte-equal results; a second replica
    armed with ``--fault`` dies at its first command batch, dumping its
    flight recorder (the reference's runner calls a ``flightrec.dump``
    that does not exist, so its dump is lost), and its query replays on
    the first."""
    import json

    boxes = tmp_path / "boxes"
    boot = tmp_path / "boot.py"
    boot.write_text(textwrap.dedent(f"""
        import dryad_tpu_torch as T

        def build_context():
            return T.DryadContext(num_partitions_=4, device="cpu",
                                  config=T.DryadConfig(flightrec_dir={str(boxes)!r}))
    """))
    ctx = _factory()
    t = ctx.from_arrays(_mk_data(np.random.default_rng(4)))
    qs = _shapes(t)[:3]
    with TF.ServeFleet(hb_interval=0.2, stale_after=3.0) as fleet:
        fleet.spawn_process("p0", str(boot))
        for q in qs:
            _tables_equal(ctx.run_to_host(q), fleet.run(q, tenant="proc", timeout=120))
        fleet.spawn_process("p1", str(boot), fault='{"seed": 0, "worker_kill_prob": 1.0}')
        fps = [TF.pack_for_fleet(q) for q in qs]
        mine = [(q, b, fp) for q, (b, fp) in zip(qs, fps)
                if rendezvous_rank(fp, ["p0", "p1"])[0] == "p1"]
        assert mine, "no plan ranks to the faulted replica"
        q, blob, fp = mine[0]
        qid = fleet.submit(tenant="proc", package=blob, fingerprint=fp)
        _tables_equal(ctx.run_to_host(q), fleet.result(qid, timeout=120))
        s = _wait_router(fleet, lambda s: s["delivered"] >= len(qs) + 1)
        assert s["replayed"] == 1 and s["dead"] == ["p1"], s
        assert fleet._procs["p1"].wait(timeout=30) == 113
    assert fleet._procs["p0"].returncode == 0
    dumps = [json.load(open(boxes / f)) for f in os.listdir(boxes)]
    killed = [d for d in dumps if d["pid"] == fleet._procs["p1"].pid]
    assert killed and killed[0]["reason"] == "replica_chaos_kill"
