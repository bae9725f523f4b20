"""Online serving layer: streaming arrivals, admission control, and
SLO-metered continuous scheduling.

Port of ``pivot_tpu/serve/__init__.py``: an unbounded stream of job
arrivals (:mod:`~pivot_tpu_torch.serve.arrivals`) flows through a bounded
admission queue with configurable backpressure
(:mod:`~pivot_tpu_torch.serve.admission`) into G always-on scheduling
sessions (:mod:`~pivot_tpu_torch.serve.session`) whose per-tick
placement dispatches coalesce into single flushes through idle-aware,
deadline-flushed ``DispatchBatcher`` slots (``sched/batch.py``: a
coalesced Cost-Aware flush is one per-row launch of ``greedy_place``),
all coordinated by the stream driver (:mod:`~pivot_tpu_torch.serve.driver`)
and metered by :class:`~pivot_tpu_torch.infra.meter.SloMeter` — with
tiers, preemption, least-loaded routing, the session supervisor and the
SLO-driven autoscaler (:mod:`~pivot_tpu_torch.serve.autoscale`).

Entry points: ``python -m pivot_tpu_torch.experiments.cli serve`` and the
classes below.  A served schedule equals the same job set run through
batch-mode ``ExperimentRun`` (``tests/test_torch_serve.py``).  The
recovery plane's config (``RecoveryConfig``) rides this namespace as in
the reference, and so do the elastic-mesh classes (``ElasticConfig``,
``ElasticMeshManager``: ``ServeDriver(elastic=...)``,
:mod:`~pivot_tpu_torch.serve.elastic`).
"""

from pivot_tpu_torch.serve.admission import (
    ADMITTED,
    BLOCKED,
    SHED,
    SPILLED,
    AdmissionQueue,
)
from pivot_tpu_torch.serve.arrivals import (
    TIER_NAMES,
    JobArrival,
    mixed_tier_arrivals,
    poisson_arrivals,
    synthetic_app_factory,
    trace_arrivals,
)
from pivot_tpu_torch.serve.autoscale import AutoscaleConfig, SloAutoscaler
from pivot_tpu_torch.serve.driver import ServeDriver, closed_loop_source
from pivot_tpu_torch.serve.elastic import ElasticConfig, ElasticMeshManager
from pivot_tpu_torch.serve.session import STOP, PreemptRequest, ServeSession

# Crash-safe serving: the recovery plane's config rides the serve
# namespace so `ServeDriver(recovery=RecoveryConfig(...))` is one import
# away from the driver it arms.
from pivot_tpu_torch.recover import RecoveryConfig

__all__ = [
    "ADMITTED",
    "AdmissionQueue",
    "AutoscaleConfig",
    "BLOCKED",
    "ElasticConfig",
    "ElasticMeshManager",
    "JobArrival",
    "PreemptRequest",
    "RecoveryConfig",
    "SHED",
    "SPILLED",
    "STOP",
    "ServeDriver",
    "ServeSession",
    "SloAutoscaler",
    "TIER_NAMES",
    "closed_loop_source",
    "mixed_tier_arrivals",
    "poisson_arrivals",
    "synthetic_app_factory",
    "trace_arrivals",
]
