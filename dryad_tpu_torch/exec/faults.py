"""Fault injection: the checkpoint-corruption hook of
``dryad_tpu/exec/faults.py``.

:meth:`_Registry.maybe_corrupt_checkpoint` runs after every checkpoint
publish (``exec/checkpoint.py``); armed by
:func:`set_fake_checkpoint_corruption`, it flips a payload byte of the
next ``count`` published checkpoints (silent bit rot that only the CRC
check can see).  The reference's stage-failure, delay, kill and seeded
chaos-plan hooks come with the retry path (ROADMAP queue 1 item 13).
"""

from __future__ import annotations

import glob
import os
import random
import threading


class _Registry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._corrupt_count = 0
        self._corrupt_rng = random.Random(0xC0FFEE)

    def set_fake_checkpoint_corruption(self, count: int = 1) -> None:
        """Corrupt the next ``count`` checkpoint saves (payload byte
        flips after publish)."""
        with self._lock:
            self._corrupt_count = int(count)

    def clear(self) -> None:
        with self._lock:
            self._corrupt_count = 0

    def maybe_corrupt_checkpoint(self, directory: str) -> bool:
        """Flip payload bytes in one partition file of a just-published
        checkpoint — after the header line, so the file still parses
        and only the CRC verification can tell."""
        with self._lock:
            if self._corrupt_count <= 0:
                return False
            self._corrupt_count -= 1
        return _flip_payload_bytes(directory, self._corrupt_rng)


def _flip_payload_bytes(directory: str, rng) -> bool:
    """XOR a byte in the first ``.dpf`` payload under ``directory``."""
    for path in sorted(glob.glob(os.path.join(directory, "*.dpf"))):
        with open(path, "rb") as fh:
            buf = bytearray(fh.read())
        nl = buf.find(b"\n")
        if nl < 0 or nl + 1 >= len(buf):
            continue  # no payload to corrupt; try the next file
        at = nl + 1 + rng.randrange(len(buf) - nl - 1)
        buf[at] ^= 0xFF
        with open(path, "wb") as fh:
            fh.write(buf)
        return True
    return False


registry = _Registry()
set_fake_checkpoint_corruption = registry.set_fake_checkpoint_corruption
clear_faults = registry.clear
