"""Observability of the port, over the ``exec/events.py`` stream (the
counterpart of ``dryad_tpu/obs``):

- :mod:`~dryad_tpu_torch.obs.span`: thread-safe hierarchical spans
  (monotonic clocks, context manager and decorator, parent ids) that
  serialize as ``span`` events;
- :mod:`~dryad_tpu_torch.obs.metrics`: the counter/histogram registry
  and the :class:`JobMetrics` snapshot of where a job's time and bytes
  went;
- :mod:`~dryad_tpu_torch.obs.trace`: the Chrome-trace (Perfetto)
  export of an event stream;
- :mod:`~dryad_tpu_torch.obs.telemetry`: the continuous plane, the
  live resource sampler with its measured :class:`HeadroomProvider`,
  and the rolling SLO store with its Prometheus/JSON export;
- :mod:`~dryad_tpu_torch.obs.diagnose`, ``critpath``, ``tracectx``,
  ``flightrec`` and ``gang``: the online diagnosis rules, the per-query
  critical path, query trace contexts, the crash-time flight recorder
  and the worker telemetry merge.
"""

from dryad_tpu_torch.obs.metrics import JobMetrics, MetricsRegistry
from dryad_tpu_torch.obs.span import Span, Tracer
from dryad_tpu_torch.obs.telemetry import (
    HeadroomProvider,
    ResourceMonitor,
    RollingStore,
)
from dryad_tpu_torch.obs.trace import chrome_trace, write_chrome_trace

__all__ = [
    "HeadroomProvider",
    "JobMetrics",
    "MetricsRegistry",
    "ResourceMonitor",
    "RollingStore",
    "Span",
    "Tracer",
    "chrome_trace",
    "write_chrome_trace",
]
