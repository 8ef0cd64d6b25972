"""Checker: the async-dispatch hot path must never block.

``sync-in-dispatch-loop``: the dispatch window (``exec/pipeline.py``
``DispatchWindow`` and the ``_AsyncDispatcher`` that wraps it in
``exec/outofcore.py``) exists so the driver thread only *dispatches*
and the collector thread only *fetches* — the one sanctioned blocking
point is the fetch closure handed to ``submit`` (it resolves to
``fetch_host`` when the collector calls it).  A synchronizing call
anywhere else in a dispatch class silently re-serializes the window:
every dispatch then waits for the previous readback, the depth knob
stops doing anything, and the card idles between chunks.  Flagged
primitives (:func:`astutil.transfer_call`):

- ``torch.cuda.synchronize()`` / ``<stream or event>.synchronize()``
  — the literal re-serializer;
- ``<x>.item()`` / ``.cpu()`` / ``.tolist()`` / ``.numpy()`` /
  ``.to("cpu")`` — a device-to-host copy that waits on the stream;
- ``np.asarray(...)`` / ``np.array(...)`` on a device value — the
  sneaky one: looks like a cheap view, is a blocking copy
  (``torch.as_tensor`` / ``torch.asarray`` stay on the device and are
  exempt).

The rule scans every class whose name contains "dispatch" (case
insensitive), nested closures included.  As a structural-drift guard,
a real ``exec/pipeline.py`` that no longer defines ``DispatchWindow``
is itself a finding — the rule must not go silent because its anchor
moved.
"""

from __future__ import annotations

import ast
from typing import Iterator, Tuple

from dryad_tpu_torch.analysis import astutil
from dryad_tpu_torch.analysis.core import Checker, Finding, Project, register

PIPELINE_PATH = "dryad_tpu_torch/exec/pipeline.py"


def _dispatch_classes(tree: ast.Module) -> Iterator[ast.ClassDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and "dispatch" in node.name.lower():
            yield node


def _sync_calls(cls: ast.ClassDef) -> Iterator[Tuple[int, str]]:
    """(lineno, description) for every blocking primitive in the class
    body, nested defs/closures included."""
    for node in ast.walk(cls):
        if isinstance(node, ast.Call):
            what = astutil.transfer_call(node)
            if what is not None:
                yield node.lineno, f"{what} waits for the device"


@register
class SyncInDispatchLoopChecker(Checker):
    rule = "sync-in-dispatch-loop"
    summary = (
        "no blocking readback primitives inside async-dispatch "
        "classes; the submitted fetch closure is the only drain site"
    )
    hint = (
        "move the readback into the fetch closure handed to "
        "DispatchWindow.submit (the collector's sanctioned blocking "
        "point), or do it after drain() on host data"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        for src in project.package_files():
            classes = list(_dispatch_classes(src.tree))
            if src.rel == PIPELINE_PATH and astutil.find_class(
                src.tree, "DispatchWindow"
            ) is None:
                # structural drift: the anchor class moved or was
                # renamed — fail loudly instead of scanning nothing
                yield self.finding(
                    src.rel,
                    1,
                    "exec/pipeline.py no longer defines DispatchWindow; "
                    "sync-in-dispatch-loop has lost its anchor",
                    hint="re-point the checker at the new async "
                    "dispatch surface",
                )
            for cls in classes:
                for line, what in _sync_calls(cls):
                    yield self.finding(
                        src.rel,
                        line,
                        f"{what} inside dispatch class {cls.name}; "
                        "this re-serializes the dispatch window",
                    )
