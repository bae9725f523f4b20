"""The one injected wall-clock source of the observability plane.

Before round 14, every telemetry object kept a *private* wall epoch —
``Meter._wall_start`` and ``SloMeter._wall_start`` each called
``time.perf_counter()`` at construction, so two snapshots taken from
the same run at the same instant reported *different* elapsed wall
times (they disagreed by however long the constructors were apart).
Worse, wall reads were scattered across modules, which is exactly how
a wall read eventually creeps into a determinism-scoped module (the
graftcheck ``determinism`` pass bans ``time.*`` in ``des/``, ``sched/``,
``ops/``, the fault/market engines).

:class:`ObsClock` fixes both: it owns ONE epoch, and every consumer —
meters, tracers, report renderers — is handed the clock instead of
calling ``time`` itself.  Snapshots from objects sharing a clock agree
exactly on elapsed wall time, and the wall capture has one auditable
home inside ``pivot_tpu/obs`` (the ``obs-boundary`` pass pins that the
determinism-scoped modules never import this module — hooks there emit
sim-time payloads and the obs layer stamps the wall side).
"""

from __future__ import annotations

import time

__all__ = ["ObsClock"]


class ObsClock:
    """A monotonic wall clock with a fixed epoch.

    ``elapsed()`` is seconds since the clock's construction — hand the
    same instance to a run's :class:`~pivot_tpu_torch.infra.meter.Meter` and
    :class:`~pivot_tpu_torch.infra.meter.SloMeter` and their ``wall_clock``
    snapshots agree to the read instant.  ``now()`` is the raw
    monotonic reading (for interval measurement where the epoch is
    irrelevant, e.g. span durations).
    """

    __slots__ = ("_epoch",)

    def __init__(self):
        self._epoch = time.perf_counter()

    def now(self) -> float:
        """Raw monotonic seconds (epoch-free; subtract two reads)."""
        return time.perf_counter()

    def elapsed(self) -> float:
        """Seconds since this clock's construction."""
        return time.perf_counter() - self._epoch
