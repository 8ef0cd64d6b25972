"""Structured leveled logging (a copy of ``dryad_tpu/utils/logging.py``).

A stdlib logger namespace ``dryad_tpu_torch`` configured once, with its
level from ``DRYAD_TPU_LOGGING_LEVEL``.
"""

from __future__ import annotations

import logging
import sys

from dryad_tpu_torch.utils.config import StaticConfig

_CONFIGURED = False


def get_logger(name: str = "dryad_tpu_torch") -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        root = logging.getLogger("dryad_tpu_torch")
        if not root.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(
                logging.Formatter(
                    "%(asctime)s %(levelname).1s %(name)s "
                    "[%(filename)s:%(lineno)d] %(message)s"
                )
            )
            root.addHandler(handler)
        root.setLevel(getattr(logging, StaticConfig.logging_level.upper(), logging.INFO))
        root.propagate = False
        _CONFIGURED = True
    return logging.getLogger(name)
