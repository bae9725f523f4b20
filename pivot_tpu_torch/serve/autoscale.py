"""SLO-driven autoscaling of the ``ServeSession`` pool.

The serving pool (PR 2) was a fixed G chosen at launch; this module
closes the loop against the *measured* service level instead: a
supervisor thread samples the governed tier's p99 decision latency over
the window since its last check (``SloMeter.tier_decision_p99_since`` —
windowed, not lifetime, so an hour of calm cannot drown a fresh breach)
and resizes the pool between ``g_min`` and ``g_max``:

  * **grow** — ``breach_checks`` consecutive windows over the target
    spawn one factory session on a fresh ``DispatchBatcher`` slot
    (``respawn_client`` — the same machinery supervisor restarts use,
    so growth composes with self-healing);
  * **shrink** — ``calm_checks`` consecutive windows under
    ``shrink_factor × target`` begin a **drain-then-retire**: the least
    loaded session stops receiving new work (the router skips
    ``retiring`` sessions) and is finalized — STOP, scheduler stopped,
    batcher slot closed — only once its live set and inbox are empty.
    In-flight jobs are never moved or lost by a scale-down; a session
    that *crashes* mid-drain is settled by the driver's retire-crash
    path (jobs requeued, slot retired exactly once).

Hysteresis is deliberate and triple: consecutive-check counts in both
directions, a wall-clock ``cooldown_s`` between any two scaling events,
and the shrink threshold sitting well under the grow threshold — the
classic guard against limit-cycling the pool on a noisy latency signal.
Every action lands in :attr:`SloAutoscaler.events` (and the SLO meter's
``scale_up_events`` / ``scale_down_events`` counters), so a soak report
shows *when* and *why* the pool moved.

Defaults are inert: ``ServeDriver(autoscale=None)`` never starts the
thread, preserving the fixed-pool behavior bit for bit.

JAX-free copy of ``pivot_tpu/serve/autoscale.py``, import paths rewritten.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

from pivot_tpu_torch.utils import LogMixin

__all__ = ["AutoscaleConfig", "SloAutoscaler"]


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Pool bounds + the latency SLO the pool is sized against."""

    g_min: int = 1
    g_max: int = 8
    #: p99 decision-latency target (wall seconds) for the governed tier.
    slo_p99_s: float = 0.05
    #: Which tier's latency governs scaling (0 = the serving tier).
    tier: int = 0
    #: Wall seconds between control-loop checks (one latency window).
    check_interval_s: float = 0.05
    #: Consecutive breached windows before growing.
    breach_checks: int = 2
    #: Consecutive calm windows before shrinking.
    calm_checks: int = 8
    #: A window is "calm" when p99 < shrink_factor × slo_p99_s (empty
    #: windows count as calm — an idle service shrinks toward g_min).
    shrink_factor: float = 0.3
    #: Minimum wall gap between any two scaling events.
    cooldown_s: float = 0.25
    #: At g_max with the SLO still breached, shed pressure instead of
    #: capacity: ask the driver to preempt one admitted-but-unplaced
    #: job of a lower tier per breached window (requires the driver's
    #: ``preempt=True``).  The last resort of "degrade, never fail".
    preempt_on_breach: bool = False

    def __post_init__(self):
        if self.g_min < 1:
            raise ValueError(f"g_min must be >= 1, got {self.g_min}")
        if self.g_max < self.g_min:
            raise ValueError(
                f"g_max ({self.g_max}) must be >= g_min ({self.g_min})"
            )
        if not self.slo_p99_s > 0:
            raise ValueError("slo_p99_s must be positive")
        if not self.check_interval_s > 0:
            raise ValueError("check_interval_s must be positive")
        if self.breach_checks < 1 or self.calm_checks < 1:
            raise ValueError("breach_checks/calm_checks must be >= 1")
        if not 0 < self.shrink_factor <= 1:
            raise ValueError(
                f"shrink_factor must be in (0, 1], got {self.shrink_factor}"
            )
        if self.cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")


class SloAutoscaler(LogMixin):
    """The control loop.  Owned and started by ``ServeDriver.run`` when
    the driver is built with an :class:`AutoscaleConfig`; all pool
    mutations go through driver methods under the driver's lock."""

    def __init__(self, driver, config: AutoscaleConfig):
        self.driver = driver
        self.config = config
        #: Scaling-event log: dicts with wall time, action, pool sizes,
        #: and the measured p99 that triggered the move.
        self.events: List[dict] = []
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="serve-autoscaler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join()

    def record(self, action: str, p99: float, pool: int,
               detail: str = "") -> None:
        self.events.append(
            {
                "wall_s": round(self.driver.slo.wall_clock, 4),
                "action": action,
                "p99_s": round(p99, 6),
                "target_s": self.config.slo_p99_s,
                "pool": pool,
                "detail": detail,
            }
        )
        # Observability (round 14): every scaling action is a wall-
        # domain instant on the shared trace timeline — pool moves read
        # in context with the dispatch spans that triggered them.
        self.driver.tracer.mark(
            "autoscale", action, p99_s=round(p99, 6), pool=pool,
            detail=detail,
        )

    def _loop(self) -> None:
        cfg = self.config
        driver = self.driver
        baseline = driver.slo.tier_decision_baseline(cfg.tier)
        breach = calm = 0
        last_event = -float("inf")
        while not self._stop_evt.wait(cfg.check_interval_s):
            # graftcheck: ignore[thread-guard] -- monotonic stop flag; a stale read costs one control-loop tick, and every pool mutation below re-validates under the driver's cv
            if driver._stop:
                return
            # Finalize any retiring session whose drain completed —
            # polling here (not on completions) keeps the retire path
            # single-threaded and simple.
            driver.finish_drained_retires()
            p99 = driver.slo.tier_decision_p99_since(cfg.tier, baseline)
            baseline = driver.slo.tier_decision_baseline(cfg.tier)
            if p99 > cfg.slo_p99_s:
                breach += 1
                calm = 0
            else:
                calm += 1
                breach = 0
            now = time.perf_counter()
            if now - last_event < cfg.cooldown_s:
                continue
            pool = driver.pool_size()
            if breach >= cfg.breach_checks:
                breach = 0
                if pool < cfg.g_max:
                    if driver.grow_pool(reason=f"p99 {p99:.4f}s > SLO"):
                        self.record("grow", p99, pool + 1)
                        last_event = now
                elif cfg.preempt_on_breach:
                    if driver.shed_pressure(cfg.tier):
                        self.record(
                            "preempt", p99, pool,
                            detail="at g_max; shedding a lower tier",
                        )
                        last_event = now
            elif (
                calm >= cfg.calm_checks
                and p99 < cfg.shrink_factor * cfg.slo_p99_s
                and pool > cfg.g_min
            ):
                calm = 0
                victim = driver.begin_retire()
                if victim is not None:
                    self.record(
                        "shrink", p99, pool - 1,
                        detail=f"draining {victim.label}",
                    )
                    last_event = now
        # One last sweep so sessions already drained retire cleanly
        # before the driver joins threads.
        driver.finish_drained_retires()
