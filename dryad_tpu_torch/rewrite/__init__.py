"""Runtime plan rewriting — the diagnosis→replan loop, closed.

The reference GM's defining capability was *acting* on runtime
statistics: dynamic connection managers re-planned exchanges from
observed key distributions, oversized vertices split mid-job, and
pipelines re-shaped while running.  This package is that policy
layer for the TPU engine: a :class:`RewriteController` subscribes to
the live event stream (the same tap surface the diagnosis engine
folds), turns ``diagnosis`` events into typed
:class:`RewriteAction`\\ s, and the drivers apply them at safe
boundaries — chunk/window boundaries in ``exec/outofcore.py``, stage
dispatch in ``exec/executor.py``.

The rule set is deliberately small and auditable (see
``controller.py``); every decision and application is a structured
``plan_rewrite`` event, so jobview/JobMetrics can always answer
"what did the rewriter change, and why".

Layering: this package is POLICY only.  It consumes event, diagnosis,
and plan surfaces (``exec.events``, ``obs``, ``plan``, ``utils``) and
never imports ``cluster/`` or jax — the drivers own the mechanisms
(spill re-routing, re-dispatch) and merely consult the controller.
The graftlint ``rewrite-layering`` rule enforces this.
"""

from dryad_tpu_torch.rewrite.actions import ACTIONS, RewriteAction
from dryad_tpu_torch.rewrite.controller import RewriteController

__all__ = ["ACTIONS", "RewriteAction", "RewriteController"]
