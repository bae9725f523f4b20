"""Observability plane: the tracer, its injected wall clock, the metrics
registry and its HTTP exporter, and the sampled dispatch profiler.

Port of ``pivot_tpu/obs/__init__.py``, cut to what the simulation and
serving paths read: :class:`ObsClock`, the causal :class:`Tracer`, the
:class:`MetricsRegistry`, :class:`MetricsHTTPServer` and the
:class:`DispatchProfiler`.  The XLA cost attribution is not ported
(ROADMAP.md, Queue 1 item 12).
"""

from pivot_tpu_torch.obs.clock import ObsClock
from pivot_tpu_torch.obs.metrics_http import MetricsHTTPServer
from pivot_tpu_torch.obs.profiler import DispatchProfiler
from pivot_tpu_torch.obs.registry import MetricsRegistry
from pivot_tpu_torch.obs.tracer import NULL_TRACER, TERMINAL_STAGES, Tracer

__all__ = ["ObsClock", "Tracer", "NULL_TRACER", "TERMINAL_STAGES",
           "MetricsRegistry", "MetricsHTTPServer", "DispatchProfiler"]
