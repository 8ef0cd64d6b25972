"""Dispatch-depth resolution (``resolve_depth`` of
``dryad_tpu/obs/telemetry.py``).  The port has no resource monitor yet
(ROADMAP queue 1 item 14): the reference's adaptive depth (-1) picks a
tier from measured device headroom, and without a measurement takes
its default, which is what -1 resolves to here."""

from __future__ import annotations

# the window drains in submit order, so any depth gives the serial
# loop's bytes
_DEFAULT_ADAPTIVE_DEPTH = 2


def resolve_depth(config_depth: int) -> int:
    """``config_depth >= 1`` is returned as is; ``-1`` (adaptive) is
    the reference's no-measurement default, 2."""
    d = int(config_depth)
    return _DEFAULT_ADAPTIVE_DEPTH if d == -1 else d
