"""Stage checkpoints: the port (dryad_tpu_torch, device="cpu") against the
JAX package on its 8-device CPU mesh, at P=8, after
tests/test_checkpoint.py.

Tolerance zero: each checkpoint's column files and its ``meta.json``
(the per-column CRC32s) are byte-equal to the reference's for the same
stage outputs, the save/hit/corruption decisions are the reference's,
and a resumed, rerun or recomputed result is byte-equal to the first
run (these jobs aggregate integers and integer-valued floats).
"""

import glob
import os
import time

import numpy as np
import pytest

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu_torch.columnar.schema import ColumnType, Schema
from dryad_tpu_torch.exec import faults
from dryad_tpu_torch.exec.checkpoint import CheckpointStore
from dryad_tpu_torch.exec.failure import (
    CheckpointCorruptionError,
    JobFailedError,
    StageFailedError,
)

P = 8
PKGS = {"ref": (J, {}), "port": (T, {"device": "cpu"})}
CKPT_KINDS = ("stage_checkpoint_saved", "stage_checkpoint_hit", "checkpoint_corrupt")


def _ctx(pkg, cdir=None, **cfg):
    mod, kw = PKGS[pkg]
    return mod.DryadContext(num_partitions_=P, config=mod.DryadConfig(checkpoint_dir=cdir, **cfg),
                            **kw)


def _table(n=1000):
    return {"k": np.arange(n, dtype=np.int32) % 13, "v": np.ones(n, np.float32),
            "s": np.asarray([f"w{i % 7}" for i in range(n)], object)}


def _byte_equal(a, b):
    assert set(a) == set(b)
    for c in a:
        va, vb = np.asarray(a[c]), np.asarray(b[c])
        if va.dtype == object:
            assert va.tolist() == vb.tolist(), c
        else:
            assert va.dtype == vb.dtype and va.tobytes() == vb.tobytes(), c


def _job(ctx):
    return ctx.from_arrays(_table()).group_by("k", {"s": ("sum", "v")}).order_by([("s", True)])


def _ckpt_events(ctx):
    return [(e["kind"], e["name"]) for e in ctx.events.events() if e["kind"] in CKPT_KINDS]


def _dirs(cdir):
    return sorted(d for d in os.listdir(cdir) if os.path.isdir(os.path.join(cdir, d)))


QUERIES = {
    "group_by_order_by": lambda c, t: c.from_arrays(t).group_by("k", {"s": ("sum", "v")})
    .order_by([("s", True)]),
    "string_dense": lambda c, t: c.from_arrays(t).group_by("s", {"c": ("count", None)}),
    "int_dense": lambda c, t: c.from_arrays(t).group_by("k", {"c": ("count", None),
                                                             "m": ("max", "k")}),
    "sort": lambda c, t: c.from_arrays(t).order_by([("k", False)]),
    "join": lambda c, t: c.from_arrays(t).join(
        c.from_arrays({"k": np.arange(13, dtype=np.int32), "r": np.arange(13, dtype=np.int32)}),
        "k", strategy="shuffle"),
}


def _files(cdir):
    """stage name -> sorted list of each checkpoint's {file: bytes}."""
    out = {}
    for d in _dirs(cdir):
        files = {f: open(os.path.join(cdir, d, f), "rb").read()
                 for f in sorted(os.listdir(os.path.join(cdir, d)))}
        out.setdefault(d.rsplit("-", 1)[0], []).append(files)
    return {k: sorted(v, key=lambda f: sorted(f.items())) for k, v in out.items()}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_checkpoint_files_and_crcs_equal_the_reference(tmp_path, name):
    files, events = {}, {}
    for pkg in PKGS:
        cdir = str(tmp_path / pkg)
        ctx = _ctx(pkg, cdir)
        QUERIES[name](ctx, _table()).collect()
        files[pkg], events[pkg] = _files(cdir), _ckpt_events(ctx)
    assert events["port"] == events["ref"] and events["port"]
    assert files["port"] == files["ref"]


def _decisions(pkg, root):
    """The reference test file's scripts in one: a cold run, a resume in
    a new context, a same-context rerun, changed data, another query,
    a fork's two outputs; the checkpoint events of each step."""
    cdir = os.path.join(root, pkg)
    steps, outs = [], []
    ctx = _ctx(pkg, cdir)
    outs.append(_job(ctx).collect())
    steps.append(_ckpt_events(ctx))
    ctx = _ctx(pkg, cdir)
    q = _job(ctx)
    outs.append(q.collect())
    steps.append(_ckpt_events(ctx))
    n_dirs = len(_dirs(cdir))
    outs.append(q.collect())
    steps.append(_ckpt_events(ctx))
    assert len(_dirs(cdir)) == n_dirs  # a rerun writes nothing new
    ctx = _ctx(pkg, cdir)
    t = _table()
    t["v"] = np.full(1000, 3.0, np.float32)
    outs.append(ctx.from_arrays(t).group_by("k", {"s": ("sum", "v")}).order_by([("s", True)])
                .collect())
    steps.append(_ckpt_events(ctx))
    ctx = _ctx(pkg, cdir)
    outs.append(ctx.from_arrays({"k": np.arange(1000, dtype=np.int32) % 7,
                                 "v": np.full(1000, 2.0, np.float32)})
                .group_by("k", {"s": ("max", "v")}).collect())
    steps.append(_ckpt_events(ctx))
    for _ in range(2):
        ctx = _ctx(pkg, cdir)
        q = ctx.from_arrays({"x": np.arange(64, dtype=np.int32)})
        sch = Schema([("x", ColumnType.INT32)]) if pkg == "port" else J.Schema(
            [("x", J.ColumnType.INT32)])
        evens, odds = q.fork(lambda b: (b.filter((b["x"] % 2) == 0), b.filter((b["x"] % 2) == 1)),
                             [sch, sch])
        outs.append(evens.collect())
        outs.append(odds.collect())
        steps.append(_ckpt_events(ctx))
    return steps, outs


def test_save_and_hit_decisions_equal_the_reference(tmp_path):
    steps, outs = _decisions("port", str(tmp_path))
    ref_steps, ref_outs = _decisions("ref", str(tmp_path))
    assert steps == ref_steps
    for a, b in zip(outs, ref_outs):
        _byte_equal(a, b)
    cold, resume, rerun, changed, other, fork1, fork2 = steps
    assert cold and all(k == "stage_checkpoint_saved" for k, _ in cold)
    assert resume and all(k == "stage_checkpoint_hit" for k, _ in resume)
    assert [k for k, _ in rerun].count("stage_checkpoint_hit") == 2 * len(resume)
    assert all(k == "stage_checkpoint_saved" for k, _ in changed)
    assert all(k == "stage_checkpoint_saved" for k, _ in other)
    assert any(k == "stage_checkpoint_hit" for k, _ in fork2)
    _byte_equal(outs[0], outs[1])
    assert float(outs[3]["s"].sum()) == 3000.0 and len(outs[4]["k"]) == 7


def test_resume_dispatches_nothing_and_is_byte_equal(tmp_path):
    cdir = str(tmp_path / "ckpt")
    first = _ctx("port", cdir)
    out1 = _job(first).collect()
    starts = [e for e in first.events.events() if e["kind"] == "stage_start"]
    ctx = _ctx("port", cdir)
    out2 = _job(ctx).collect()
    kinds = [e["kind"] for e in ctx.events.events()]
    assert starts and kinds.count("stage_start") == 0
    assert kinds.count("stage_checkpoint_hit") == len({e["name"] for e in starts})
    _byte_equal(out1, out2)


def test_checkpoint_disabled_by_default():
    ctx = _ctx("port")
    _job(ctx).collect()
    assert ctx.executor.checkpoints is None
    assert not _ckpt_events(ctx)


@pytest.mark.parametrize("how", ["garbage", "bit_flip"])
def test_corrupt_checkpoint_recomputes(tmp_path, how):
    events = {}
    for pkg in PKGS:
        cdir = str(tmp_path / pkg)
        if how == "bit_flip":
            (faults if pkg == "port" else J.exec.faults).set_fake_checkpoint_corruption(1)
        try:
            out1 = _job(_ctx(pkg, cdir)).collect()
        finally:
            faults.clear_faults()
            J.exec.faults.clear_faults()
        if how == "garbage":
            for f in glob.glob(os.path.join(cdir, "*-*", "*.dpf")):
                with open(f, "wb") as fh:
                    fh.write(b"garbage")
        ctx = _ctx(pkg, cdir)
        out2 = _job(ctx).collect()
        _byte_equal(out1, out2)
        events[pkg] = [k for k, _ in _ckpt_events(ctx)]
    assert events["port"] == events["ref"]
    if how == "bit_flip":
        assert "checkpoint_corrupt" in events["port"]
    else:
        assert "stage_checkpoint_hit" not in events["port"]


def test_crc_mismatch_raises_the_corruption_error(tmp_path):
    cdir = str(tmp_path / "ckpt")
    _job(_ctx("port", cdir)).collect()
    (d,) = [os.path.join(cdir, x) for x in _dirs(cdir)][:1]
    cols = {"a": np.arange(4, dtype=np.int32)}
    with pytest.raises(CheckpointCorruptionError, match="crc32"):
        CheckpointStore._verify_crc(d, "out0", cols, {"a": 0})
    assert issubclass(CheckpointCorruptionError, StageFailedError)
    assert issubclass(JobFailedError, StageFailedError)
    from dryad_tpu_torch.exec.executor import StageFailedError as Reexported

    assert Reexported is StageFailedError


def test_checkpoint_gc_lease(tmp_path):
    rng = np.random.default_rng(0)
    names = {}
    for pkg in PKGS:
        cdir = str(tmp_path / pkg)
        ctx = _ctx(pkg, cdir, checkpoint_retain_seconds=0.2)
        ctx.from_arrays({"k": rng.integers(0, 8, 128).astype(np.int32)}).group_by(
            "k", {"c": ("count", None)}).collect()
        assert len(_dirs(cdir)) >= 1
        time.sleep(0.3)
        ctx = _ctx(pkg, cdir, checkpoint_retain_seconds=0.2)
        ctx.from_arrays({"v": np.arange(64, dtype=np.float32)}).where(lambda c: c["v"] > 10).collect()
        names[pkg] = [d.rsplit("-", 1)[0] for d in _dirs(cdir)]
        assert all("group_by" not in n for n in names[pkg]), names[pkg]
        assert "checkpoint_gc" in [e["kind"] for e in ctx.events.events()]
    assert names["port"] == names["ref"]
