"""Stage duration statistics and outlier detection.

Port of the *logic* (not code) of the reference's speculative-duplication
model (``GraphManager/stagemanager/DrStageStatistics.cpp``): a robust
Gaussian fit over completed task durations — trimming the top 20% as
suspected outliers — with an outlier threshold at mean + 3 sigma
(``DrStageStatistics.cpp:24-25,93,490-558``).  Intra-pod SPMD steps are
lockstep so speculation is moot there; the driver uses this for
multi-slice / DCN stage retries and for surfacing stragglers in the
event log.
"""

from __future__ import annotations

import math
from typing import List, Optional

TRIM_FRACTION = 0.2  # reference: top 20% trimmed before fitting
DEFAULT_SIGMAS = 3.0  # reference: 3-sigma outlier threshold
MIN_SAMPLES = 3
# Multiplicative floor on the outlier threshold: with fewer than 4
# samples the trimmed fit keeps 1-3 points and the variance
# degenerates toward 0, so mean + 3*sigma collapses onto the mean and
# flags EVERY subsequent attempt a straggler.  Clamping to
# floor_ratio x the trimmed mean keeps the model usable from the very
# first completions (seeded test: tests/test_quarantine.py).
FLOOR_RATIO = 1.5


class StageStatistics:
    """Robust duration model for one stage's attempts."""

    def __init__(
        self,
        outlier_sigmas: float = DEFAULT_SIGMAS,
        floor_ratio: float = FLOOR_RATIO,
    ):
        self.durations: List[float] = []
        self.outlier_sigmas = outlier_sigmas
        self.floor_ratio = floor_ratio

    def record(self, seconds: float) -> None:
        self.durations.append(float(seconds))

    def _trimmed(self) -> List[float]:
        d = sorted(self.durations)
        k = int(len(d) * (1.0 - TRIM_FRACTION))
        return d[: max(k, 1)]

    def mean_std(self) -> Optional[tuple]:
        if len(self.durations) < MIN_SAMPLES:
            return None
        t = self._trimmed()
        m = sum(t) / len(t)
        var = sum((x - m) ** 2 for x in t) / max(len(t) - 1, 1)
        return m, math.sqrt(var)

    def outlier_threshold(self) -> Optional[float]:
        """Duration beyond which an attempt counts as a straggler,
        clamped to ``floor_ratio`` x the trimmed mean (see FLOOR_RATIO:
        the fit degenerates with < 4 samples)."""
        ms = self.mean_std()
        if ms is None:
            return None
        m, s = ms
        return max(m + self.outlier_sigmas * s, m * self.floor_ratio)

    def spare_threshold(self) -> Optional[float]:
        """Coarse spare-launch trigger for coded redundancy.

        Duplication must IDENTIFY the straggling attempt, so it waits
        for the full robust model (>= MIN_SAMPLES completions).  Coded
        parity covers whichever r vertices are slow — any k completions
        reconstruct — so it may act on a much weaker signal: from the
        FIRST completed sample, ``floor_ratio x max(completed)``."""
        thr = self.outlier_threshold()
        if thr is not None:
            return thr
        if not self.durations:
            return None
        return max(self.durations) * self.floor_ratio

    def is_outlier(self, seconds: float) -> bool:
        thr = self.outlier_threshold()
        return thr is not None and seconds > thr


class FailureWindow:
    """Sliding-window failure counter — the machine-level failure
    accounting behind computer quarantine (the reference blacklists
    computers whose recent failure count crosses a threshold,
    ``DrGraph.h:42`` m_maxActiveFailureCount at machine scope).

    Timestamps come from the caller's clock, so schedulers with an
    injectable clock stay fully fake-time testable."""

    def __init__(self, window_seconds: float):
        self.window = float(window_seconds)
        self._times: List[float] = []

    def record(self, now: float) -> int:
        """Record one failure at ``now``; returns the in-window count."""
        self._times.append(float(now))
        return self.count(now)

    def count(self, now: float) -> int:
        """Failures inside (now - window, now]; prunes expired entries."""
        cutoff = float(now) - self.window
        self._times = [t for t in self._times if t > cutoff]
        return len(self._times)

    def clear(self) -> None:
        self._times.clear()
