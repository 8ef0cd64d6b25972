"""The port's samples run (``python -m dryad_tpu_torch.samples.<name>
--device cpu``) and print what the reference's samples print: the
strings ``tests/test_samples.py`` checks, and for WordCount and Top-K
words the reference sample's whole output (node and stage ids of the
explain text renumbered, as in ``tests/test_torch_events_explain.py``).
Exact: the printed counts and words are integers and strings."""

import os
import subprocess
import sys

import pytest
from test_torch_events_explain import renumber

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, **env):
    out = subprocess.run(
        [sys.executable, *args], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT, **env),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


@pytest.mark.parametrize(
    "name,args,expect",
    [
        ("wordcount", [], "the"),
        ("terasort", ["20000"], "sorted 20000 rows"),
        ("join_groupby", [], "region 0:"),
        ("pagerank_dowhile", [], "top node matches numpy PageRank: OK"),
        ("topk_per_key_hdfs", [], "ranked reviews considered: 100"),
        ("top_words", [], "== fusion =="),
        ("analytics_cached", [], "rows persisted+reread via hdfs:// gateway: 2000"),
    ],
)
def test_port_sample_runs_on_the_cpu(name, args, expect):
    out = _run(["-m", f"dryad_tpu_torch.samples.{name}", *args, "--device", "cpu"])
    assert expect in out


@pytest.mark.parametrize("name", ["wordcount", "top_words"])
def test_port_sample_prints_the_reference_samples_output(name):
    port = _run(["-m", f"dryad_tpu_torch.samples.{name}", "--device", "cpu"])
    ref = _run([os.path.join(ROOT, "samples", f"{name}.py")], JAX_PLATFORMS="cpu")
    assert renumber(port) == renumber(ref)
    assert len(port.splitlines()) >= 10
