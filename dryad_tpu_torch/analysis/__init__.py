"""graftlint: the port's static-analysis subsystem.

The counterpart of ``dryad_tpu/analysis/``, aimed at ``dryad_tpu_torch/``
and the port's tests (``tests/test_torch_*.py``).  Every contract the
runtime's fault-tolerance story leans on — deterministic vertex
re-execution, no host sync on the device path, shape discipline of the
operand cache, registry/schema coherence — is mechanically checkable
from the AST.  The rules keep the reference's ids; where a rule names
a JAX construct, the port's names its PyTorch counterpart.  This
package holds the checker framework (:mod:`.core`), shared AST helpers
(:mod:`.astutil`), the built-in checkers, and the repo-level runner
(:mod:`.engine`).

Entry points:

- ``python -m dryad_tpu_torch.tools.lint`` — the CLI;
- :func:`dryad_tpu_torch.analysis.engine.run_repo` — programmatic runs;
- ``tests/test_torch_graftlint.py`` — the tier-1 gate (whole registry
  over the port, zero unsuppressed findings), and the ``lint`` phase of
  ``chip_smoke.py``.

Suppression grammar (reason REQUIRED, unused suppressions reported)::

    risky_line()  # graftlint: disable=<rule>[,<rule>] -- <reason>
"""

from dryad_tpu_torch.analysis.core import (  # noqa: F401
    Checker,
    FileChecker,
    Finding,
    Project,
    Report,
    SourceFile,
    Suppression,
    all_checkers,
    known_rules,
    register,
    run,
)
