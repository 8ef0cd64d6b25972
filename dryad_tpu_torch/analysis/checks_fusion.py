"""Checkers: fuser allowlist coherence and the host-transfer ban.

``fuse-classification``: every op kind ``plan.fuse.FUSABLE_OPS`` admits must have a registered
device kernel, every registered kernel must be consciously classified
(fusable or driver-evaluated), and the two classes are disjoint.

``host-transfer`` scans the ENTIRE kernel registry and the device
combine path: one ``.item()`` / ``.cpu()`` / ``.tolist()`` /
``.numpy()`` / ``.to("cpu")`` / ``synchronize()`` / ``np.asarray`` /
``float()``-of-a-device-value inside any ``apply_op``-reachable kernel
is a per-dispatch device-to-host stall that drains the CUDA stream (the
executor's speculative window then stops overlapping anything).
``torch.as_tensor`` / ``torch.asarray`` stay on the device and are
exempt.  Scope:

- ``exec/kernels.py`` — the whole module (every kernel, ``apply_op`` /
  ``run_ops``, StageContext);
- ``plan/fuse.py`` and ``exec/combinetree.py`` — whole modules;
- the streaming driver's ``merge_local`` closure (the function the
  combine tree calls per merge);
- device-facing ops modules (hash/join/segmented/shuffle/sort/...);
- ``ops/stringcode.py`` — only the device methods (those taking an
  ``operands=`` parameter); the host-side table builders legitimately
  use numpy.
"""

from __future__ import annotations

import ast
from typing import Iterator

from dryad_tpu_torch.analysis import astutil
from dryad_tpu_torch.analysis.core import Checker, Finding, Project, register
from dryad_tpu_torch.analysis.checks_operands import KERNELS_PATH

FUSE_PATH = "dryad_tpu_torch/plan/fuse.py"
COMBINETREE_PATH = "dryad_tpu_torch/exec/combinetree.py"
OUTOFCORE_PATH = "dryad_tpu_torch/exec/outofcore.py"
STRINGCODE_PATH = "dryad_tpu_torch/ops/stringcode.py"

# whole-module device scope: everything here runs on the
# device path, so host transfers are banned outright
DEVICE_MODULES = (
    KERNELS_PATH,
    FUSE_PATH,
    COMBINETREE_PATH,
    "dryad_tpu_torch/plan/xchgplan.py",
    "dryad_tpu_torch/ops/hash.py",
    "dryad_tpu_torch/ops/join.py",
    "dryad_tpu_torch/ops/segmented.py",
    "dryad_tpu_torch/ops/shuffle.py",
    "dryad_tpu_torch/ops/sort.py",
    "dryad_tpu_torch/ops/sortkeys.py",
)


@register
class FuseClassificationChecker(Checker):
    rule = "fuse-classification"
    summary = (
        "FUSABLE_OPS/DRIVER_OPS partition the kernel registry: no "
        "unkernelled admits, no unclassified kernels, no overlap"
    )
    hint = "classify the op kind in plan.fuse (fusable or driver)"

    def check(self, project: Project) -> Iterator[Finding]:
        ksrc = project.file(KERNELS_PATH)
        fsrc = project.file(FUSE_PATH)
        if ksrc is None or fsrc is None:
            return
        kernels = astutil.literal_dict(ksrc.tree, "_KERNELS")
        fusable = astutil.literal_str_set(fsrc.tree, "FUSABLE_OPS")
        driver = astutil.literal_str_set(fsrc.tree, "DRIVER_OPS")
        if kernels is None or fusable is None or driver is None:
            yield self.finding(
                fsrc.rel,
                1,
                "could not parse FUSABLE_OPS / DRIVER_OPS / _KERNELS "
                "literals",
                hint="keep the registries as plain literals",
            )
            return
        f_stmt = astutil.find_assign(fsrc.tree, "FUSABLE_OPS")
        d_stmt = astutil.find_assign(fsrc.tree, "DRIVER_OPS")
        f_line = f_stmt.lineno if f_stmt is not None else 1
        for kind in sorted(fusable - set(kernels)):
            yield self.finding(
                fsrc.rel,
                f_line,
                f"fuser admits op kind {kind!r} with no registered "
                "device kernel — would raise inside a fused region's "
                "run",
            )
        for kind in sorted(set(kernels) - fusable - driver):
            yield self.finding(
                fsrc.rel,
                f_line,
                f"device kernel {kind!r} is neither fusable nor "
                "driver-evaluated — it silently fell out of fusion "
                "coverage",
            )
        for kind in sorted(fusable & driver):
            yield self.finding(
                fsrc.rel,
                d_stmt.lineno if d_stmt is not None else 1,
                f"op kind {kind!r} is both fusable and driver-evaluated",
            )


@register
class HostTransferChecker(Checker):
    rule = "host-transfer"
    summary = (
        "no .item()/.cpu()/.tolist()/.numpy()/.to('cpu')/synchronize/"
        "np.asarray/float(device value) anywhere on the device path "
        "(kernels, fuser, combine tree, ops)"
    )
    hint = (
        "keep the value on-device (torch.as_tensor is fine) or move "
        "the transfer out of the per-dispatch path"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        for rel in DEVICE_MODULES:
            src = project.file(rel)
            if src is None:
                continue
            for ln, call in astutil.host_transfer_calls(src.tree):
                yield self.finding(
                    src.rel, ln, f"host-transfer call {call} on the "
                    "device path"
                )

        # the streaming driver's per-merge closure
        ooc = project.file(OUTOFCORE_PATH)
        if ooc is not None:
            driver = astutil.find_function(ooc.tree, "_group_partial_tree")
            closure = (
                astutil.find_function(driver, "merge_local")
                if driver is not None
                else None
            )
            if closure is None:
                yield self.finding(
                    ooc.rel,
                    driver.lineno if driver is not None else 1,
                    "merge_local closure not found in "
                    "_group_partial_tree — host-transfer scan lost its "
                    "anchor",
                    hint="re-anchor the scan to the tree-merge function",
                )
            else:
                for ln, call in astutil.host_transfer_calls(closure):
                    yield self.finding(
                        ooc.rel,
                        ln,
                        f"host-transfer call {call} inside the tree "
                        "merge closure — would sync EVERY tree level",
                    )

        # stringcode: device methods only (operands= is the marker)
        sc = project.file(STRINGCODE_PATH)
        if sc is not None:
            for fn in astutil.function_defs(sc.tree).values():
                arg_names = {a.arg for a in fn.args.args} | {
                    a.arg for a in fn.args.kwonlyargs
                }
                if "operands" not in arg_names:
                    continue
                for ln, call in astutil.host_transfer_calls(fn):
                    yield self.finding(
                        sc.rel,
                        ln,
                        f"host-transfer call {call} inside device "
                        f"table method {fn.name}()",
                    )
