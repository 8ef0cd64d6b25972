"""The port stands alone: importing dryad_tpu_torch loads neither jax nor
the JAX package, no module of it (nor chip_smoke.py) imports them, and
its entry point never picks the CPU by itself."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "dryad_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "dryad_tpu")


def _forbidden(name: str) -> bool:
    # "dryad_tpu_torch" must not match "dryad_tpu": compare whole dotted heads
    return name.split(".")[0] in FORBIDDEN


def _port_files():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_forbidden_match_is_exact():
    assert _forbidden("dryad_tpu") and _forbidden("dryad_tpu.ops.sort")
    assert _forbidden("jax.numpy")
    assert not _forbidden("dryad_tpu_torch") and not _forbidden("dryad_tpu_torch.ops")


def test_no_module_imports_jax_or_the_jax_package():
    bad = []
    for path in _port_files():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            elif (
                isinstance(node, ast.Call)
                and getattr(node.func, "attr", getattr(node.func, "id", None))
                in ("import_module", "__import__")
                and node.args and isinstance(node.args[0], ast.Constant)
            ):
                names = [str(node.args[0].value)]
            bad += [f"{path}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert not bad, bad


def test_scan_covers_every_module_of_the_port():
    """The AST scan above reads each module of the package, the join
    operators (ops/join.py), the decomposable aggregates
    (api/decomposable.py), the stage kernels and executor that drive
    them, and the stores, codecs, providers, event log, fusion decision,
    explain, the WebHDFS stub, the samples, the out-of-core stream
    path (obs/, spill, pipeline, partial, combine tree, the driver) and
    the serving slice (serve/, views/, checkpoints, the failure types,
    the trace context, critical path, flight recorder and logging)
    and the fault-tolerance and cluster slice (stats, job packages,
    cluster/, the control plane, redundancy/, diagnosis, gang
    telemetry) included."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("ops/join.py", "ops/segmented.py", "exec/kernels.py", "exec/executor.py",
                "parallel/partition.py", "plan/lower.py", "plan/infer.py", "api/query.py",
                "api/context.py", "api/decomposable.py", "columnar/io.py",
                "columnar/codecs.py", "columnar/chunked.py", "columnar/uri.py",
                "columnar/webhdfs.py", "columnar/azblob.py", "exec/events.py", "plan/fuse.py",
                "tools/explain.py", "tools/webhdfs_stub.py", "runtime/bindings.py",
                "samples/wordcount.py", "samples/terasort.py", "samples/join_groupby.py",
                "samples/pagerank_dowhile.py", "samples/top_words.py",
                "samples/topk_per_key_hdfs.py", "obs/span.py", "obs/metrics.py",
                "obs/telemetry.py", "exec/spill.py", "exec/pipeline.py", "exec/partial.py",
                "exec/combinetree.py", "exec/outofcore.py",
                "serve/__init__.py", "serve/admission.py", "serve/cache.py", "serve/router.py",
                "serve/service.py", "views/__init__.py", "views/matview.py",
                "exec/checkpoint.py", "exec/failure.py", "exec/faults.py", "obs/tracectx.py",
                "obs/critpath.py", "obs/flightrec.py", "utils/logging.py",
                "exec/stats.py", "exec/jobpackage.py", "cluster/interfaces.py",
                "cluster/scheduler.py", "cluster/service.py", "cluster/partcache.py",
                "cluster/worker.py", "cluster/localjob.py", "parallel/multihost.py",
                "redundancy/coding.py", "redundancy/policy.py", "redundancy/reconstruct.py",
                "obs/diagnose.py", "obs/gang.py"):
        assert os.path.join("dryad_tpu_torch", mod) in scanned, mod
    assert "chip_smoke.py" in scanned


def test_import_in_fresh_process_loads_no_jax():
    code = (
        "import sys, dryad_tpu_torch, dryad_tpu_torch.interop\n"
        "import dryad_tpu_torch.ops.bucket, dryad_tpu_torch.exec.executor\n"
        "import dryad_tpu_torch.ops.join, dryad_tpu_torch.exec.kernels\n"
        "import dryad_tpu_torch.api.decomposable\n"
        "import dryad_tpu_torch.columnar.uri, dryad_tpu_torch.columnar.codecs\n"
        "import dryad_tpu_torch.tools.explain, dryad_tpu_torch.tools.webhdfs_stub\n"
        "import dryad_tpu_torch.samples.topk_per_key_hdfs, dryad_tpu_torch.samples.top_words\n"
        "import dryad_tpu_torch.exec.outofcore, dryad_tpu_torch.exec.combinetree\n"
        "import dryad_tpu_torch.exec.pipeline, dryad_tpu_torch.exec.spill\n"
        "import dryad_tpu_torch.exec.partial, dryad_tpu_torch.obs.span\n"
        "import dryad_tpu_torch.obs.metrics, dryad_tpu_torch.obs.telemetry\n"
        "import dryad_tpu_torch.serve, dryad_tpu_torch.serve.service, dryad_tpu_torch.views\n"
        "import dryad_tpu_torch.exec.checkpoint, dryad_tpu_torch.exec.failure\n"
        "import dryad_tpu_torch.exec.faults, dryad_tpu_torch.obs.tracectx\n"
        "import dryad_tpu_torch.obs.critpath, dryad_tpu_torch.obs.flightrec\n"
        "import dryad_tpu_torch.utils.logging, dryad_tpu_torch.exec.stats\n"
        "import dryad_tpu_torch.exec.jobpackage, dryad_tpu_torch.cluster.localjob\n"
        "import dryad_tpu_torch.cluster.worker, dryad_tpu_torch.cluster.partcache\n"
        "import dryad_tpu_torch.parallel.multihost, dryad_tpu_torch.redundancy\n"
        "import dryad_tpu_torch.obs.diagnose, dryad_tpu_torch.obs.gang\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_context_without_gpu_raises(monkeypatch):
    import torch

    import dryad_tpu_torch as T

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.DryadContext()
    assert T.DryadContext(device="cpu").device.type == "cpu"


def test_collect_stream_is_ported():
    """``Query.collect_stream`` is the port's own method (it was the
    last pending Query method), and a stream plan's pieces come out of
    the out-of-core driver."""
    import numpy as np

    import dryad_tpu_torch as T
    from dryad_tpu_torch.api import query

    assert not hasattr(query, "_PENDING_METHODS")
    assert T.Query.collect_stream.__qualname__ == "Query.collect_stream"
    ctx = T.DryadContext(device="cpu")
    chunks = [{"x": np.arange(i, i + 3, dtype=np.int32)} for i in (0, 3)]
    pieces = list(ctx.from_stream(iter(chunks)).collect_stream())
    assert [p["x"].tolist() for p in pieces] == [[0, 1, 2], [3, 4, 5]]


@pytest.mark.parametrize("name", ["FleetClient", "ReplicaRunner", "ServeFleet"])
def test_serving_fleet_names_raise_naming_their_item(name):
    """The serve package exports the reference's names, the fleet's
    among them (``serve/fleet.py``); an unknown name raises
    AttributeError."""
    from dryad_tpu_torch import serve
    from dryad_tpu_torch.serve import fleet

    assert name in serve.__all__
    assert getattr(serve, name) is getattr(fleet, name)
    with pytest.raises(AttributeError):
        serve.NoSuchName  # noqa: B018
    for kept in ("QueryService", "TenantSession", "QueryFuture", "QueryRejected",
                 "TenantQuota", "ResultCache"):
        assert kept in serve.__all__ and getattr(serve, kept)


def test_worker_process_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A port worker process, after announcing and running a vertex task,
    holds neither ``jax`` nor ``dryad_tpu`` in ``sys.modules`` (it writes
    the forbidden names it holds at exit)."""
    import numpy as np

    import dryad_tpu_torch as T
    from dryad_tpu_torch.cluster.localjob import LocalJobSubmission, SubprocessLauncher

    report = str(tmp_path / "modules.txt")

    class Reporting(SubprocessLauncher):
        def start(self, spec):
            code = (
                "import atexit, runpy, sys\n"
                "def _report():\n"
                f"    open({report!r}, 'w').write(repr(sorted(m for m in sys.modules "
                f"if m.split('.')[0] in {FORBIDDEN!r})))\n"
                "atexit.register(_report)\n"
                f"sys.argv = ['worker'] + {spec['argv'][3:]!r}\n"
                "runpy.run_module('dryad_tpu_torch.cluster.worker', run_name='__main__')\n"
            )
            assert spec["argv"][1:3] == ["-m", "dryad_tpu_torch.cluster.worker"]
            return super().start(dict(spec, argv=[sys.executable, "-c", code]))

    with LocalJobSubmission(num_workers=1, device="cpu", launcher=Reporting()) as sub:
        ctx = T.DryadContext(num_partitions_=1, device="cpu")
        q = ctx.from_arrays({"k": np.arange(64, dtype=np.int32) % 4}).group_by(
            "k", {"c": ("count", None)})
        out = sub.submit_partitioned(q, nparts=2)
        assert sorted(out["c"].tolist()) == [16] * 4
    assert open(report).read() == "[]"


def test_worker_without_its_device_fails_the_job_naming_why():
    """Workers asked for CUDA where there is none announce the reason
    and fail every vertex with it: the job fails, nothing falls back to
    the CPU."""
    import numpy as np
    import torch

    import dryad_tpu_torch as T
    from dryad_tpu_torch.cluster.localjob import LocalJobSubmission
    from dryad_tpu_torch.exec.failure import JobFailedError

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the failure path needs none")
    with LocalJobSubmission(num_workers=1, device="cuda") as sub:
        ctx = T.DryadContext(num_partitions_=1, device="cpu")
        q = ctx.from_arrays({"k": np.arange(16, dtype=np.int32)}).project(["k"])
        with pytest.raises(JobFailedError, match="cannot open device 'cuda'"):
            sub.submit_partitioned(q, nparts=1)
        (meta,) = sub.worker_devices().values()
        assert "cannot open device 'cuda'" in meta["device_error"]
