"""The port's graftlint checkers against the reference's
(``dryad_tpu/analysis/``), on synthetic trees.

Three kinds of case:

- *Parity.* Every project the reference's own checker self-tests and
  suppression-grammar tests build (``tests/test_graftlint_selftest.py``,
  ``tests/test_graftlint.py``) goes through both registries: the
  reference's on its ``dryad_tpu/`` paths, the port's with the package
  names swapped (``dryad_tpu`` -> ``dryad_tpu_torch``, ``jax`` ->
  ``torch``).  Both give the same findings (rule, path, line,
  suppressed), the suppression framework's included, for every rule
  but the four whose constructs are the port's own (:data:`TORCH_RULES`).
  The projects are collected by running those tests with
  ``Project.from_sources`` recording what it is given, one case per
  project.
- *Torch counterparts.*  Each PyTorch construct that a rule names in
  place of a JAX one fires on a seeded mutation, stays quiet on its
  clean twin, and fires on the same line as its JAX twin does under
  the reference's rule.
- *Pending kinds.*  ``exec/events.py``'s ``PENDING_KINDS`` lets a kind
  go without an emit site and fires once the kind gains one.
"""

import importlib.util
import inspect
import itertools
import os
import re

import pytest

from dryad_tpu.analysis import core as RC
from dryad_tpu_torch.analysis import core as TC
from dryad_tpu_torch.analysis import engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# rules whose constructs the port names in torch's terms: proven by the
# counterpart cases below, left out of the parity comparison
TORCH_RULES = frozenset({
    "host-transfer", "sync-in-dispatch-loop", "recompile-hazard",
    "collective-order",
})


# -- parity over the reference's self-test projects ---------------------------


class _NoRepo(Exception):
    pass


def _param_sets(fn):
    """Keyword sets of a test's ``parametrize`` marks (their product)."""
    axes = []
    for m in getattr(fn, "pytestmark", []):
        if m.name != "parametrize":
            continue
        names = m.args[0]
        names = [n.strip() for n in names.split(",")] if isinstance(names, str) else list(names)
        vals = []
        for v in m.args[1]:
            v = getattr(v, "values", v)  # pytest.param(...)
            vals.append(dict(zip(names, v if len(names) > 1 else (v,))))
        axes.append(vals)
    for combo in itertools.product(*axes):
        kw = {}
        for d in combo:
            kw.update(d)
        yield kw


def _reference_projects(modname):
    """(case id, sources) of every project the reference test module's
    tests build; tests that scan the real tree are skipped."""
    spec = importlib.util.spec_from_file_location(
        "_ref_" + modname, os.path.join(ROOT, "tests", modname + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    from_sources, from_root = RC.Project.from_sources, RC.Project.from_root
    out = []
    for name, fn in sorted(vars(mod).items()):
        if not (name.startswith("test_") and inspect.isfunction(fn)):
            continue
        params = set(inspect.signature(fn).parameters)
        for i, kw in enumerate(_param_sets(fn)):
            if params - set(kw):
                continue  # wants fixtures: a CLI or whole-tree test
            seen = []

            def record(cls, sources, _seen=seen):
                _seen.append(dict(sources))
                return from_sources.__func__(cls, sources)

            def refuse(cls, *a, **k):
                raise _NoRepo

            RC.Project.from_sources = classmethod(record)
            RC.Project.from_root = classmethod(refuse)
            try:
                fn(**kw)
            except _NoRepo:
                pass
            finally:
                RC.Project.from_sources = from_sources
                RC.Project.from_root = from_root
            out += [(f"{name}[{i}]#{k}", src) for k, src in enumerate(seen)]
    return out


PROJECTS = _reference_projects("test_graftlint_selftest") + _reference_projects("test_graftlint")

_PKG = re.compile(r"\bdryad_tpu\b")
_JAX = re.compile(r"\bjax\b")


def to_port(text: str) -> str:
    return _JAX.sub("torch", _PKG.sub("dryad_tpu_torch", text))


def _findings(report, rename=False):
    return sorted(
        (f.rule, _PKG.sub("dryad_tpu_torch", f.path) if rename else f.path, f.line, f.suppressed)
        for f in report.findings
        if f.rule not in TORCH_RULES
    )


def test_parity_collects_every_reference_self_test():
    names = {cid.split("[")[0] for cid, _ in PROJECTS}
    assert len(PROJECTS) >= 140
    assert {"test_event_schema_fires", "test_kernel_determinism_fires",
            "test_mailbox_discipline_fires", "test_routing_hash_fires",
            "test_unused_suppression_is_reported"} <= names


@pytest.mark.lint
@pytest.mark.parametrize("sources", [s for _, s in PROJECTS], ids=[c for c, _ in PROJECTS])
def test_port_registry_finds_what_the_reference_finds(sources):
    ref = RC.run(RC.Project.from_sources(sources))
    port = TC.run(TC.Project.from_sources(
        {to_port(rel): to_port(text) for rel, text in sources.items()}))
    assert _findings(port) == _findings(ref, rename=True)


# -- torch counterparts -------------------------------------------------------

HOST = """import numpy as np
{imp}


def gather(x):
    y = x + 1
    {line}
    return y
"""

DISPATCH = """import numpy as np
{imp}


class DispatchWindow:
    def submit(self, y):
        y = y + 1
        {line}
        return y
"""

DET = """import random
import numpy as np
{imp}


def draw(seed, p):
    g = None
    {line}
    return g
"""

OPERAND_CLASS = """import numpy as np
{imp}


class Table:
    operand_arity = 2

    def build(self, keys):
        n = len(keys)
        {line}
        return out
"""

DEVICE_BODY = """import numpy as np
{imp}


def {fn}(ctx, p, cols):
    n = 8
    {line}
    return out


_KERNELS = {{"select": _k_sel}}
"""

COLLECTIVES = """{imp}


def exchange(x, y, xs, ys, ops):
    {a}
    {b}
    return x
"""

TORCH = {"imp": "import torch"}
JAXI = {"imp": "import jax; import jax.numpy as jnp"}
DIST = {"imp": "import torch; import torch.distributed as dist"}
LAX = {"imp": "from jax import lax"}


def _case(rule, rel, tmpl, port, ref, clean, base=(TORCH, JAXI)):
    return pytest.param(rule, rel, tmpl, {**base[0], **port}, {**base[1], **ref},
                        {**base[0], **clean}, id=f"{rule}:{'|'.join(port.values())}")


_HT = ("host-transfer", "ops/join.py", HOST)
_HT_CLEAN = {"line": "y = torch.as_tensor(x)"}
_SY = ("sync-in-dispatch-loop", "exec/pipeline.py", DISPATCH)
_SY_CLEAN = {"line": "y = torch.asarray(y)"}
_KD = ("kernel-determinism", "ops/det.py", DET)
_KD_CLEAN = {"line": "g = torch.rand(4, generator=torch.Generator().manual_seed(seed))"}
_RO = ("recompile-hazard", "ops/table.py", OPERAND_CLASS)
_RO_CLEAN = {"line": "out = torch.zeros(palette_domain(n))"}
_RK = ("recompile-hazard", "exec/kernels.py", DEVICE_BODY)
_RK_CLEAN = {"fn": "_k_sel", "line": "out = torch.zeros((n, 16))"}
_CO = ("collective-order", "ops/shuffle.py", COLLECTIVES)
_CO_CLEAN = {"a": "dist.send(x, 1)", "b": "dist.all_reduce(x)"}

COUNTERPARTS = [
    _case(*_HT, {"line": "y = x.item()"}, {"line": "y = x.item()"}, _HT_CLEAN),
    _case(*_HT, {"line": "y = x.cpu()"}, {"line": "y = jax.device_get(x)"}, _HT_CLEAN),
    _case(*_HT, {"line": "y = x.tolist()"}, {"line": "y = np.asarray(x)"}, _HT_CLEAN),
    _case(*_HT, {"line": "y = x.numpy()"}, {"line": "y = np.asarray(x)"}, _HT_CLEAN),
    _case(*_HT, {"line": 'y = x.to("cpu")'}, {"line": "y = jax.device_get(x)"}, _HT_CLEAN),
    _case(*_HT, {"line": 'y = x.to(device=torch.device("cpu"))'},
          {"line": "y = jax.device_get(x)"}, _HT_CLEAN),
    _case(*_HT, {"line": "torch.cuda.synchronize()"}, {"line": "y = jax.device_get(y)"}, _HT_CLEAN),
    _case(*_HT, {"line": "y = np.asarray(x)"}, {"line": "y = np.asarray(x)"}, _HT_CLEAN),
    _case(*_HT, {"line": "y = np.array(x)"}, {"line": "y = np.asarray(x)"}, _HT_CLEAN),
    _case(*_HT, {"line": "y = float(torch.sum(x))"}, {"line": "y = float(jnp.sum(x))"}, _HT_CLEAN),
    _case(*_HT, {"line": "y = int(torch.max(x))"}, {"line": "y = int(jnp.max(x))"}, _HT_CLEAN),
    _case(*_HT, {"line": "y = bool(torch.any(x))"}, {"line": "y = int(jnp.any(x))"},
          {"line": 'y = x.to("cuda")'}),
    _case(*_SY, {"line": "torch.cuda.synchronize()"}, {"line": "y.block_until_ready()"}, _SY_CLEAN),
    _case(*_SY, {"line": "self.done.synchronize()"}, {"line": "y.block_until_ready()"}, _SY_CLEAN),
    _case(*_SY, {"line": "y = y.item()"}, {"line": "y = y.item()"}, _SY_CLEAN),
    _case(*_SY, {"line": "y = y.cpu()"}, {"line": "y = jax.device_get(y)"}, _SY_CLEAN),
    _case(*_SY, {"line": "y = y.tolist()"}, {"line": "y = np.asarray(y)"}, _SY_CLEAN),
    _case(*_SY, {"line": "y = y.numpy()"}, {"line": "y = np.asarray(y)"}, _SY_CLEAN),
    _case(*_SY, {"line": 'y = y.to("cpu")'}, {"line": "y = device_get(y)"}, _SY_CLEAN),
    _case(*_SY, {"line": "y = np.array(y)"}, {"line": "y = numpy.asarray(y)"},
          {"line": "y = torch.as_tensor(y)"}),
    _case(*_KD, {"line": "g = torch.rand(4)"}, {"line": "g = np.random.rand(4)"}, _KD_CLEAN),
    _case(*_KD, {"line": "g = torch.randn(4)"}, {"line": "g = np.random.randn(4)"}, _KD_CLEAN),
    _case(*_KD, {"line": "g = torch.randint(0, 9, (4,))"}, {"line": "g = np.random.randint(0, 9, 4)"},
          _KD_CLEAN),
    _case(*_KD, {"line": "g = torch.randperm(8)"}, {"line": "g = np.random.permutation(8)"}, _KD_CLEAN),
    _case(*_KD, {"line": "g = torch.normal(0.0, 1.0, (4,))"},
          {"line": "g = np.random.normal(0.0, 1.0, 4)"}, _KD_CLEAN),
    _case(*_KD, {"line": "g = torch.bernoulli(p)"}, {"line": "g = np.random.binomial(1, p)"}, _KD_CLEAN),
    _case(*_KD, {"line": "g = torch.multinomial(p, 2)"}, {"line": "g = np.random.choice(4, 2, p=p)"},
          _KD_CLEAN),
    _case(*_KD, {"line": "g = p.uniform_()"}, {"line": "g = random.random()"},
          {"line": "g = p.uniform_(generator=torch.Generator().manual_seed(seed))"}),
    _case(*_KD, {"line": "g = torch.Generator()"}, {"line": "g = np.random.default_rng()"},
          {"line": "g = torch.Generator().manual_seed(seed)"}),
    _case(*_RO, {"line": "out = torch.zeros(len(keys))"}, {"line": "out = jnp.zeros(len(keys))"},
          _RO_CLEAN),
    _case(*_RO, {"line": "out = torch.zeros(n, 4)"}, {"line": "out = jnp.zeros((n, 4))"}, _RO_CLEAN),
    _case(*_RO, {"line": "out = torch.full((n,), -1)"}, {"line": "out = jnp.full((n,), -1)"},
          _RO_CLEAN),
    _case(*_RK, {"fn": "_k_sel", "line": "out = torch.zeros((n, 17))"},
          {"fn": "_k_sel", "line": "out = jnp.zeros((n, 17))"}, _RK_CLEAN),
    _case(*_RK, {"fn": "_k_sel", "line": "out = torch.empty(n, 24)"},
          {"fn": "_k_sel", "line": "out = jnp.empty((n, 24))"}, _RK_CLEAN),
    _case(*_RK, {"fn": "_k_sel", "line": "out = torch.ones(len(cols))"},
          {"fn": "_k_sel", "line": "out = jnp.ones(len(cols))"}, _RK_CLEAN),
    _case(*_RK, {"fn": "_k_sel", "line": "out = np.arange(n)"},
          {"fn": "_k_sel", "line": "out = np.arange(n)"}, _RK_CLEAN),
    _case(*_RK, {"fn": "run_ops", "line": "out = torch.full((len(cols),), 0)"},
          {"fn": "build_stage_fn", "line": "out = jnp.full((len(cols),), 0)"},
          {"fn": "run_ops", "line": "out = torch.full((n,), 0)"}),
    _case(*_RK, {"fn": "apply_op", "line": "out = np.zeros(n)"},
          {"fn": "build_fused_fn", "line": "out = np.zeros(n)"},
          {"fn": "apply_op", "line": "out = torch.zeros(n)"}),
    _case(*_CO, {"a": "dist.all_reduce(x)", "b": "dist.all_to_all_single(y, x)"},
          {"a": "x = lax.psum(x, 'i')", "b": "y = lax.all_to_all(x, 'i', 0, 0)"}, _CO_CLEAN,
          base=(DIST, LAX)),
    _case(*_CO, {"a": "dist.all_gather_into_tensor(y, x)", "b": "dist.send(x, 1)"},
          {"a": "y = lax.all_gather(x, 'i')", "b": "y = lax.ppermute(x, 'i', [(0, 1)])"},
          _CO_CLEAN, base=(DIST, LAX)),
    _case(*_CO, {"a": "dist.reduce_scatter_tensor(y, x)", "b": "dist.all_gather(ys, x)"},
          {"a": "y = lax.psum_scatter(x, 'i')", "b": "y = lax.all_gather(x, 'i')"},
          _CO_CLEAN, base=(DIST, LAX)),
    _case(*_CO, {"a": "torch.distributed.all_to_all(ys, xs)", "b": "dist.batch_isend_irecv(ops)"},
          {"a": "y = lax.all_to_all(x, 'i', 0, 0)", "b": "y = jax.lax.ppermute(x, 'i', [(0, 1)])"},
          {"a": "dist.recv(x, 0)", "b": "torch.distributed.all_to_all(ys, xs)"}, base=(DIST, LAX)),
]


def _fired(mod, rel, text, rule):
    report = mod.run(mod.Project.from_sources({rel: text}), rules=[rule])
    return [(f.rule, f.line) for f in report.unsuppressed()]


@pytest.mark.lint
@pytest.mark.parametrize("rule, rel, tmpl, port, ref, clean", COUNTERPARTS)
def test_torch_construct_fires_where_its_jax_twin_does(rule, rel, tmpl, port, ref, clean):
    fired = _fired(TC, "dryad_tpu_torch/" + rel, tmpl.format(**port), rule)
    assert fired and {r for r, _ in fired} == {rule}
    assert fired == _fired(RC, "dryad_tpu/" + rel, tmpl.format(**ref), rule)
    assert _fired(TC, "dryad_tpu_torch/" + rel, tmpl.format(**clean), rule) == []


def test_generator_seeded_through_its_binding_is_quiet():
    src = DET.format(imp="import torch", line="""g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    self.gen = torch.Generator()
    self.gen.manual_seed(seed + 1)
    x = torch.randperm(8, generator=g) + torch.rand(8, generator=self.gen)""")
    assert _fired(TC, "dryad_tpu_torch/ops/det.py", src, "kernel-determinism") == []
    unseeded = src.replace("    self.gen.manual_seed(seed + 1)\n", "")
    assert _fired(TC, "dryad_tpu_torch/ops/det.py", unseeded, "kernel-determinism") == [
        ("kernel-determinism", 10)]


def test_host_transfer_keeps_its_anchors_on_the_port():
    """The streaming driver's merge closure and the device methods of
    the code tables are scanned on the port's paths too."""
    ooc = """def _group_partial_tree(self, node):
    def merge_local(a, b):
        return (a + b).cpu()
    return merge_local
"""
    sc = """class CodeTable:
    def lookup(self, h0, h1, operands=None):
        return h0.tolist()

    def build(self, words):
        return words.tolist()
"""
    rep = TC.run(TC.Project.from_sources({"dryad_tpu_torch/exec/outofcore.py": ooc,
                                          "dryad_tpu_torch/ops/stringcode.py": sc}),
                 rules=["host-transfer"])
    assert [(f.path, f.line) for f in rep.unsuppressed()] == [
        ("dryad_tpu_torch/exec/outofcore.py", 3), ("dryad_tpu_torch/ops/stringcode.py", 3)]


# -- pending kinds ----------------------------------------------------------------

EVENTS = "dryad_tpu_torch/exec/events.py"
EMITTER = "dryad_tpu_torch/exec/executor.py"

PENDING_FIXTURE = {
    EVENTS: """\
EVENT_KINDS = {
    "tick": "one tick; n",
    "gang_tick": "a gang tick; n",
    "round": "one round; n",
}
EVENT_PAYLOADS = {
    "tick": (("n",), ()),
    "gang_tick": (("n",), ()),
    "round": (("n",), ("qid",)),
}
QUERY_SCOPED_KINDS = ("round",)
PENDING_KINDS = {
    "gang_tick": "ROADMAP queue 1 item 11",
    "round": "ROADMAP queue 1 item 11",
}
""",
    EMITTER: """\
def go(log, self):
    log.emit("tick", n=1)
    self._note("tick", "name", 1, n=2)
""",
}


def _mutated(path, old, new):
    out = dict(PENDING_FIXTURE)
    assert old in out[path]
    out[path] = out[path].replace(old, new)
    return out


def _unsuppressed(sources, rules=("event-schema", "trace-context")):
    rep = TC.run(TC.Project.from_sources(sources), rules=list(rules))
    return [(f.rule, f.path, f.line) for f in rep.unsuppressed()]


def test_pending_kinds_need_no_emit_site():
    assert _unsuppressed(PENDING_FIXTURE) == []


@pytest.mark.parametrize("path, old, new, expect", [
    # a pending kind gains an emit site, through emit or the executor's _note
    (EMITTER, 'log.emit("tick", n=1)', 'log.emit("gang_tick", n=1)',
     [("event-schema", EMITTER, 2)]),
    (EMITTER, 'self._note("tick", "name", 1, n=2)', 'self._note("gang_tick", "name", 1, n=2)',
     [("event-schema", EMITTER, 3)]),
    (EMITTER, 'self._note("tick", "name", 1, n=2)', 'self._note("round", "name", 1, n=2, qid=None)',
     [("event-schema", EMITTER, 3)]),
    # a _note site's keywords are the kind's payload
    (EMITTER, 'self._note("tick", "name", 1, n=2)', 'self._note("tick", "name", 1, m=2)',
     [("event-schema", EMITTER, 3), ("event-schema", EMITTER, 3)]),
    # an entry that is not a documented kind, or names no item
    (EVENTS, '"round": "ROADMAP queue 1 item 11",\n}', '"round": "ROADMAP queue 1 item 11",\n    "nope": "x",\n}',
     [("event-schema", EVENTS, 15)]),
    (EVENTS, '"gang_tick": "ROADMAP queue 1 item 11"', '"gang_tick": ""',
     [("event-schema", EVENTS, 13)]),
    # not a plain literal
    (EVENTS, 'PENDING_KINDS = {\n    "gang_tick": "ROADMAP queue 1 item 11",\n    "round": "ROADMAP queue 1 item 11",\n}',
     "PENDING_KINDS = dict(gang_tick='item 11', round='item 11')",
     [("event-schema", EVENTS, 12), ("event-schema", EVENTS, 1), ("event-schema", EVENTS, 1),
      ("trace-context", EVENTS, 11)]),
    # a kind dropped from the list is stale again, in both rules
    (EVENTS, '    "round": "ROADMAP queue 1 item 11",\n', "",
     [("event-schema", EVENTS, 1), ("trace-context", EVENTS, 11)]),
])
def test_pending_kinds_fire(path, old, new, expect):
    assert sorted(_unsuppressed(_mutated(path, old, new))) == sorted(expect)


def test_pending_kinds_of_the_port_are_exactly_its_unemitted_kinds():
    """The list is empty: every documented kind has an emit site, so the
    event rules find no stale entry; put back, ``xla_compile`` (the last
    kind to gain its site, ``exec/programs.py``) is reported as emitted,
    and it is not query-scoped."""
    from dryad_tpu_torch.exec.events import PENDING_KINDS, QUERY_SCOPED_KINDS

    assert PENDING_KINDS == {}
    project = engine.load_project()
    assert not TC.run(project, rules=["event-schema", "trace-context"]).unsuppressed()
    src = project.files[EVENTS]
    line = "PENDING_KINDS: Dict[str, str] = {}"
    assert src.text.count(line) == 1
    project.files[EVENTS] = TC.SourceFile(EVENTS, src.text.replace(
        line, 'PENDING_KINDS: Dict[str, str] = {"xla_compile": "ROADMAP queue 1 item 10"}'))
    rep = TC.run(project, rules=["event-schema", "trace-context"])
    stale = {"event-schema": set(), "trace-context": set()}
    for f in rep.unsuppressed():
        stale[f.rule].add(re.search(r"'(\w+)'", f.message).group(1))
    assert stale["event-schema"] == {"xla_compile"}
    assert stale["trace-context"] == {"xla_compile"} & set(QUERY_SCOPED_KINDS) == set()
