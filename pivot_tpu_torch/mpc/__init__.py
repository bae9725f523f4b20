"""Model-predictive serving: the simulator runs inside the server.

Everything before this package used the fitness estimator
(``search/fitness.py``) *offline* — tune weights, sweep scenarios,
report regret.  ``pivot_tpu_torch.mpc`` closes the loop: a serving driver
built with an :class:`MpcConfig` runs a control thread that forecasts
the arrival stream it is serving (``forecast``), scores a menu of
candidate actions with seeded shadow rollouts of the predicted next
horizon — ONE evaluator call per decision window (``planner``)
— executes the predicted-best action through the driver's existing
pool machinery, re-fits :class:`~pivot_tpu_torch.search.weights.PolicyWeights`
in a background CEM worker gated by the exact-oracle regret bound
(``tuner``), and promotes winners through a shadow → canary → fleet
rollout with automatic SLO rollback (``rollout``).

The default is OFF and bit-identical: ``ServeDriver(mpc=None)`` never
imports this package, and weight promotions are attribute swaps
(``Policy.apply_weights``), so a promotion changes VALUES, not code.

A port of ``pivot_tpu/mpc/``: :class:`MpcConfig` and the lazy
re-exports as the reference has them.  The planner renders and scores
on the serving policies' torch device (``cuda`` for a numpy policy),
float64 on the CPU, float32 on the card.  On the card every window
replays the evaluator's captured CUDA graphs
(``parallel/ensemble/tick.py``), captured once at the controller's
warm-up (``MpcController.warmup``) before the serving threads start.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = [
    "MpcConfig",
    "MpcController",
    "MpcTuner",
    "TierForecaster",
    "WeightRollout",
]


@dataclasses.dataclass(frozen=True)
class MpcConfig:
    """Knobs for the model-predictive control loop.

    The config deliberately mirrors ``AutoscaleConfig``'s shape (pool
    bounds, governed tier, check interval) plus the model side: the
    forecast/rollout horizon, the rendered environment's pinned size
    (``env_apps`` — fixed so every window reuses one captured graph
    per shape), the tuner budget, and the staged-rollout thresholds.
    ``dry_run=True`` scores and records every window but never touches
    an actuator — the observe-only mode A/B soaks compare against.
    """

    # -- control loop ------------------------------------------------------
    check_interval_s: float = 0.05
    #: Shadow-rollout horizon (sim seconds) each window predicts over.
    horizon: float = 300.0
    tick: float = 5.0
    #: Seeded rollouts per candidate action (the K in K-shadow-rollouts).
    n_replicas: int = 4
    #: Apps in the rendered environment — FIXED so operand shapes pin.
    env_apps: int = 6
    seed: int = 0
    #: Minimum forecaster observations before the first plan.
    min_observations: int = 4
    #: Wall seconds between actuations (not charged for hold/observe).
    cooldown_s: float = 0.2
    #: $-per-sim-second weight on predicted makespan in the objective.
    latency_weight: float = 0.01
    #: Per-replica eviction-plan redraws in the rendered env.
    redraw_faults: bool = True
    #: Replay the plan dispatch bitwise every Nth window (0 = off).
    referee_every: int = 8
    #: Score + record only; never actuate.
    dry_run: bool = False
    backend: str = "rollout"

    # -- pool bounds + governed tier ---------------------------------------
    g_min: int = 1
    g_max: int = 8
    tier: int = 0
    n_tiers: int = 3

    # -- forecaster --------------------------------------------------------
    bucket_s: float = 20.0
    alpha: float = 0.5

    # -- background tuner --------------------------------------------------
    tune: bool = True
    tune_interval_s: float = 0.2
    tune_generations: int = 2
    tune_popsize: int = 6
    #: Oracle-gate bound ($ from the proven optimum) on challengers.
    max_regret: float = 1.0

    # -- staged rollout ----------------------------------------------------
    canary_checks: int = 2
    watch_checks: int = 2
    regression_factor: float = 1.5

    # -- template world (optional injection) -------------------------------
    #: Render template cluster/market; None builds a synthetic cluster
    #: sized like the pool's and generates a market from its meta.
    cluster: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    market: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def __post_init__(self):
        if not self.check_interval_s > 0:
            raise ValueError("check_interval_s must be positive")
        if not self.horizon > 0 or not self.tick > 0:
            raise ValueError("horizon and tick must be positive")
        if self.n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {self.n_replicas}")
        if self.env_apps < 1:
            raise ValueError(f"env_apps must be >= 1, got {self.env_apps}")
        if self.g_min < 1:
            raise ValueError(f"g_min must be >= 1, got {self.g_min}")
        if self.g_max < self.g_min:
            raise ValueError(
                f"g_max ({self.g_max}) must be >= g_min ({self.g_min})"
            )
        if not 0 <= self.tier < self.n_tiers:
            raise ValueError(
                f"tier must be in [0, {self.n_tiers}), got {self.tier}"
            )
        if self.min_observations < 1:
            raise ValueError("min_observations must be >= 1")
        if self.cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")
        if self.latency_weight < 0:
            raise ValueError("latency_weight must be >= 0")
        if self.referee_every < 0:
            raise ValueError("referee_every must be >= 0")
        if self.tune_generations < 1 or self.tune_popsize < 2:
            raise ValueError(
                "tune_generations must be >= 1 and tune_popsize >= 2"
            )
        if self.max_regret < 0:
            raise ValueError("max_regret must be >= 0")
        if self.canary_checks < 1 or self.watch_checks < 1:
            raise ValueError("canary_checks/watch_checks must be >= 1")
        if self.regression_factor <= 1.0:
            raise ValueError("regression_factor must be > 1")


def __getattr__(name):
    # Lazy re-exports: importing MpcConfig (the driver's type check)
    # must not drag the torch planner/controller stack along.
    if name == "MpcController":
        from pivot_tpu_torch.mpc.controller import MpcController

        return MpcController
    if name == "MpcTuner":
        from pivot_tpu_torch.mpc.tuner import MpcTuner

        return MpcTuner
    if name == "TierForecaster":
        from pivot_tpu_torch.mpc.forecast import TierForecaster

        return TierForecaster
    if name == "WeightRollout":
        from pivot_tpu_torch.mpc.rollout import WeightRollout

        return WeightRollout
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
