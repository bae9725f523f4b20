"""Observability plane: the tracer and its injected wall clock.

Port of ``pivot_tpu/obs/__init__.py``, cut to what the simulation path
reads: :class:`ObsClock` and the causal :class:`Tracer`.  The metrics
registry, the HTTP exporter and the dispatch profiler are not ported yet.
"""

from pivot_tpu_torch.obs.clock import ObsClock
from pivot_tpu_torch.obs.tracer import NULL_TRACER, TERMINAL_STAGES, Tracer

__all__ = ["ObsClock", "Tracer", "NULL_TRACER", "TERMINAL_STAGES"]
