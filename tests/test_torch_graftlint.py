"""The port's graftlint (``dryad_tpu_torch/analysis/``,
``dryad_tpu_torch/tools/lint.py``): the whole-registry gate over the
port's tree, the registry, the CLI, ``explain_lint`` and the
configuration schema, each held against the reference's
(``dryad_tpu/analysis/``, ``tests/test_graftlint.py``).

The gate is the port's static-analysis entry in tier-1: every
registered checker runs over ``dryad_tpu_torch/`` and
``tests/test_torch_*.py`` and must come back with zero unsuppressed
findings, the invariant ``python -m dryad_tpu_torch.tools.lint``
enforces with its exit status and the ``lint`` phase of
``chip_smoke.py`` enforces on the card's machine.
"""

import dataclasses
import glob
import json
import os
import pathlib
import re

import pytest

import dryad_tpu as J
import dryad_tpu_torch as T
from dryad_tpu import analysis as ranalysis
from dryad_tpu.analysis import core as RC
from dryad_tpu.tools import explain as jexplain
from dryad_tpu.tools import lint as rlint
from dryad_tpu.utils import config as RCFG
from dryad_tpu_torch.analysis import core as TC
from dryad_tpu_torch.analysis import engine
from dryad_tpu_torch.analysis.core import all_checkers, known_rules
from dryad_tpu_torch.tools import explain as texplain
from dryad_tpu_torch.tools import lint as lint_cli
from dryad_tpu_torch.utils import config as TCFG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_report():
    """The whole registry over the port's tree, run once for the module:
    the gate, the small-rule cases and the panels read this report."""
    return engine.run_repo()


@pytest.fixture
def cached_gate(monkeypatch, port_report):
    """``engine.run_repo`` of the whole tree answers with the module's
    report, so the CLI and the panel render it without a new run."""
    real = engine.run_repo

    def run_repo(rules=None, root=None):
        return port_report if rules is None and root is None else real(rules=rules, root=root)

    monkeypatch.setattr(engine, "run_repo", run_repo)


@pytest.mark.lint
def test_whole_registry_clean_over_the_port(port_report):
    report = port_report
    assert set(report.rules_run) == set(all_checkers())
    assert report.ok, "\n".join(f.render() for f in report.unsuppressed())
    for s in report.suppressions:
        assert s.reason, f"{s.path}:{s.line}: suppression without reason"
        assert s.used_rules, f"{s.path}:{s.line}: unused suppression"
        assert s.path.startswith("dryad_tpu_torch/"), s.path


def test_gate_scans_the_port_and_only_the_ports_tests():
    files = set(engine.load_project().files)
    pkg = {
        os.path.relpath(p, ROOT)
        for p in glob.glob(os.path.join(ROOT, "dryad_tpu_torch", "**", "*.py"), recursive=True)
        if "__pycache__" not in p and not p.startswith(os.path.join(ROOT, "dryad_tpu_torch", "_build"))
    }
    tests = {os.path.relpath(p, ROOT) for p in glob.glob(os.path.join(ROOT, "tests", "test_torch_*.py"))}
    assert files == pkg | tests
    assert "dryad_tpu_torch/analysis/core.py" in files
    assert not any(f.startswith("dryad_tpu/") for f in files)
    assert engine.repo_root() == pathlib.Path(ROOT).resolve()


def test_no_port_test_line_reads_as_a_suppression():
    """The reference's gate scans every file under tests/: a port test
    line in the suppression grammar would count there as unused or bad
    (fixtures build such text by concatenation)."""
    for path in glob.glob(os.path.join(ROOT, "tests", "test_torch_*.py")):
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                assert not TC._SUPPRESS_RE.search(line), f"{path}:{i}"
    assert TC._SUPPRESS_RE.pattern == RC._SUPPRESS_RE.pattern


def test_registry_has_the_reference_rules():
    assert set(all_checkers()) == set(ranalysis.all_checkers())
    assert len(all_checkers()) == 20
    assert TC.FRAMEWORK_RULES == RC.FRAMEWORK_RULES == ("bad-suppression", "unused-suppression")
    assert set(known_rules()) == set(RC.known_rules())


# -- CLI ---------------------------------------------------------------------


def test_cli_exits_zero_on_the_clean_tree(cached_gate, capsys):
    assert lint_cli.main([]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s)" in out and "20 rule(s) run" in out


def test_cli_json_report_has_the_references_keys(cached_gate, tmp_path, capsys):
    assert lint_cli.main(["--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] is True and doc["counts"] == {}
    assert doc["suppressions"] and all(s["reason"] for s in doc["suppressions"])
    # the keys of both reports over twin trees with a finding and a suppression
    port = _tree(tmp_path / "t", "dryad_tpu_torch", _DIRTY)
    ref = _tree(tmp_path / "j", "dryad_tpu", _DIRTY)
    assert lint_cli.main(["--json", "--root", port]) == 1
    dirty = json.loads(capsys.readouterr().out)
    assert rlint.main(["--json", "--root", ref]) == 1
    ref = json.loads(capsys.readouterr().out)
    assert set(doc) == set(dirty) == set(ref)
    assert set(doc["suppressions"][0]) == set(ref["suppressions"][0])
    assert set(dirty["findings"][0]) == set(ref["findings"][0])


def test_cli_rule_filter_and_list(capsys):
    assert lint_cli.main(["--rule", "event-schema", "--rule", "host-transfer"]) == 0
    assert "2 rule(s) run" in capsys.readouterr().out
    assert lint_cli.main(["--list-rules"]) == 0
    port = [ln.split(":")[0] for ln in capsys.readouterr().out.splitlines()]
    assert rlint.main(["--list-rules"]) == 0
    ref = [ln.split(":")[0] for ln in capsys.readouterr().out.splitlines()]
    assert port == ref and len(port) == 22


def test_cli_unknown_rule_is_a_usage_error(capsys):
    assert lint_cli.main(["--rule", "no-such-rule"]) == 2 == rlint.main(["--rule", "no-such-rule"])
    err = capsys.readouterr().err
    assert err.count("unknown rule(s): ['no-such-rule']") == 2


def _tree(root, pkg, text):
    d = root / pkg / "ops"
    d.mkdir(parents=True)
    (d / "fixture.py").write_text(text)
    return str(root)


_SUP = "# graftlint" + ": disable="
_DIRTY = (
    "import time\n\n\ndef f():\n    return time.time()\n\n\n"
    "def g():\n    return time.monotonic()  " + _SUP + "kernel-determinism -- fixture\n"
)


def test_cli_exits_one_on_findings_like_the_reference(tmp_path, capsys):
    port = _tree(tmp_path / "t", "dryad_tpu_torch", _DIRTY)
    ref = _tree(tmp_path / "j", "dryad_tpu", _DIRTY)
    assert lint_cli.main(["--root", port]) == 1 == rlint.main(["--root", ref])
    out = capsys.readouterr().out.splitlines()
    first = "dryad_tpu_torch/ops/fixture.py:5: [kernel-determinism] wall-clock read time.time()"
    assert out[0].startswith(first)
    assert out[1] == "graftlint: 1 finding(s), 1 suppressed, 20 rule(s) run"
    assert [ln.replace("dryad_tpu/", "dryad_tpu_torch/") for ln in out[2:]] == out[:2]


# -- the reference's small lint tests, over the port --------------------------


@pytest.mark.parametrize("module, rule", [
    ("coded", "coded-linearity"), ("coded", "layer-imports"),
    ("combinetree", "layer-imports"), ("combinetree", "placement-snapshot"),
    ("combinetree", "host-transfer"),
    ("fuse", "fuse-classification"), ("fuse", "host-transfer"),
    ("operand", "operand-registry"), ("event_schema", "event-schema"),
])
def test_reference_small_lint_rule_clean_over_the_port(port_report, module, rule):
    assert rule in port_report.rules_run
    dirty = [f.render() for f in port_report.unsuppressed() if f.rule == rule]
    assert not dirty, "\n".join(dirty)


def test_payload_table_covers_every_kind():
    from dryad_tpu_torch.exec.events import EVENT_KINDS, EVENT_PAYLOADS

    assert set(EVENT_PAYLOADS) == set(EVENT_KINDS)


def test_operand_params_sit_beside_the_kernels():
    """A plain literal in exec/kernels.py, the reference's pairs, each
    naming a registered kernel; the executor reads the same object."""
    from dryad_tpu.exec import kernels as jk
    from dryad_tpu_torch.exec import executor, kernels

    assert kernels.OPERAND_PARAMS == jk.OPERAND_PARAMS
    assert executor.OPERAND_PARAMS is kernels.OPERAND_PARAMS
    assert all(kind in kernels._KERNELS for kind, _ in kernels.OPERAND_PARAMS)


# -- explain_lint --------------------------------------------------------------


def test_explain_lint_panel_equals_the_references(tmp_path):
    port = _tree(tmp_path / "t", "dryad_tpu_torch", _DIRTY)
    ref = _tree(tmp_path / "j", "dryad_tpu", _DIRTY)
    panel = texplain.explain_lint(root=port)
    assert panel.replace("dryad_tpu_torch", "dryad_tpu") == jexplain.explain_lint(root=ref)
    lines = panel.split("\n")
    assert "  kernel-determinism     FINDINGS=1  suppressed=1" in lines
    assert lines[-1].startswith("  TREE DIRTY: 1 unsuppressed finding(s)")
    assert lines[-1].endswith("run python -m dryad_tpu_torch.tools.lint")


def test_explain_lint_over_the_port_is_clean(cached_gate):
    panel = texplain.explain_lint().split("\n")
    assert panel[0] == "== static analysis (graftlint) ==" and panel[-1] == "  tree clean"
    assert len([ln for ln in panel if re.match(r"  [a-z-]+ +ok", ln)]) == 20
    sup = [ln for ln in panel if ln.startswith("    dryad_tpu_torch/")]
    assert len(sup) == 5 and all(" -- " in ln for ln in sup)


# -- configuration schema ------------------------------------------------------


def test_config_keys_mirror_the_dataclass_and_the_reference():
    """The port's schema, its pending keys and the keys nothing reads
    split the reference's schema; keys are compared, not docs (each
    package words its docs for itself)."""
    fields = {f.name for f in dataclasses.fields(TCFG.DryadConfig)}
    assert set(TCFG.CONFIG_KEYS) == fields
    parts = [set(TCFG.CONFIG_KEYS), set(TCFG.PENDING_CONFIG_KEYS), set(TCFG.UNREAD_CONFIG_KEYS)]
    assert sum(map(len, parts)) == len(set().union(*parts))
    assert set().union(*parts) == set(RCFG.CONFIG_KEYS)
    # the staged exchange brought the last two (exchange_window,
    # exchange_hbm_budget_mb)
    assert TCFG.PENDING_CONFIG_KEYS == {}
    # and every documented event kind has its emitter: xla_compile, the
    # last, since the stage programs (exec/programs.py)
    from dryad_tpu_torch.exec.events import PENDING_KINDS

    assert PENDING_KINDS == {}
    assert {"exchange_window", "exchange_hbm_budget_mb"} <= fields
    assert not any(w in doc for doc in TCFG.CONFIG_KEYS.values() for w in ("XLA", "JAX", "MXU", "SPMD"))


def test_added_keys_default_as_in_the_reference():
    assert TCFG.DryadConfig().plan_fuse is RCFG.DryadConfig().plan_fuse is True


@pytest.mark.parametrize("key", sorted(TCFG.UNREAD_CONFIG_KEYS))
def test_unread_keys_are_refused_and_may_not_be_read(key):
    """A key of the reference that nothing reads is no field here: a
    configuration that sets it fails to build instead of being ignored,
    and a read of it in the port is a ``config-key`` finding."""
    value = getattr(RCFG.DryadConfig(), key)
    with pytest.raises(TypeError, match=key):
        T.DryadConfig(**{key: value})
    config = os.path.join(ROOT, "dryad_tpu_torch", "utils", "config.py")
    project = TC.Project.from_sources({
        "dryad_tpu_torch/utils/config.py": open(config).read(),
        "dryad_tpu_torch/exec/reader.py": f"def f(self):\n    return self.config.{key}\n",
    })
    found = [(f.path, f.line) for f in TC.run(project, rules=["config-key"]).unsuppressed()]
    assert found == [("dryad_tpu_torch/exec/reader.py", 2)]


def test_reference_config_constructs_in_the_port():
    """Every reference key the port has round-trips: a reference
    configuration of those keys builds a port context."""
    ref = J.DryadConfig(plan_fuse=False, overflow_sync_depth=2, topk_limit=77)
    kw = {k: getattr(ref, k) for k in TCFG.CONFIG_KEYS}
    ctx = T.DryadContext(num_partitions_=2, config=T.DryadConfig(**kw), device="cpu")
    assert (ctx.config.plan_fuse, ctx.config.overflow_sync_depth, ctx.config.topk_limit) == (False, 2, 77)
