"""Observability plane: the tracer, its injected wall clock, the metrics
registry and its HTTP exporter, and the sampled dispatch profiler.

Port of ``pivot_tpu/obs/__init__.py``: :class:`ObsClock`, the causal
:class:`Tracer`, the :class:`MetricsRegistry`,
:class:`MetricsHTTPServer`, the :class:`DispatchProfiler` and
:func:`attach_compile_observer`.  The cost
attribution over the port's device entry points is
``pivot_tpu_torch/obs/costattr.py`` (imported on its own: it reads the
analysis suite).
"""

from typing import Callable, Optional

from pivot_tpu_torch.obs.clock import ObsClock
from pivot_tpu_torch.obs.metrics_http import MetricsHTTPServer
from pivot_tpu_torch.obs.profiler import DispatchProfiler
from pivot_tpu_torch.obs.registry import MetricsRegistry
from pivot_tpu_torch.obs.tracer import NULL_TRACER, TERMINAL_STAGES, Tracer

__all__ = ["ObsClock", "Tracer", "NULL_TRACER", "TERMINAL_STAGES",
           "MetricsRegistry", "MetricsHTTPServer", "DispatchProfiler",
           "attach_compile_observer"]


def attach_compile_observer(
    registry: Optional[MetricsRegistry] = None,
    tracer: Optional[Tracer] = None,
    sim_time: Optional[Callable[[], float]] = None,
) -> Callable[[], None]:
    """Make kernel builds and CUDA-graph captures *visible*: publish each
    into the registry (``pivot_compile_events_total{kind=...}``, the
    port's name for the reference's ``pivot_jax_compile_events_total``;
    kinds ``kernel_build`` / ``graph_capture``,
    ``utils/compile_counter.py``) and stamp an instant event on the
    trace timeline (``cat="compile"``).

    ``sim_time`` (optional, e.g. ``lambda: env.now``) anchors the
    instant on the sim timeline as well; without it the event is
    wall-only.  Returns a detach callable — call it when the observed
    window ends.
    """
    from pivot_tpu_torch.utils import compile_counter

    if registry is not None:
        registry.counter(
            "pivot_compile_events_total",
            "kernel builds and CUDA-graph captures observed by the "
            "compile counter (zero after warmup is the steady-state "
            "hypothesis)",
            labelnames=("kind",),
        )

    def _observe(kind: str) -> None:
        if registry is not None:
            registry.inc("pivot_compile_events_total", kind=kind)
        if tracer is not None and tracer.enabled:
            sim = sim_time() if sim_time is not None else None
            if sim is not None:
                tracer.emit("compile", kind, sim)
            else:
                tracer.mark("compile", kind)

    compile_counter.add_observer(_observe)

    def detach() -> None:
        compile_counter.remove_observer(_observe)

    return detach
