"""The model-predictive control loop: forecast → plan → act.

The :class:`MpcController` is the serving pool's *proactive* twin of
``serve/autoscale.py``'s reactive supervisor, with the same ownership
shape — a daemon thread started/stopped by ``ServeDriver.run``, every
pool mutation routed through the driver's thread-safe surface
(``grow_pool`` / ``begin_retire`` / ``shed_pressure``), every action on
the shared trace timeline — but a different decision rule: instead of
reacting to a p99 already breached, each window it

1. fits the arrival forecaster from the stream the driver has admitted
   so far (``mpc/forecast.py``),
2. renders the predicted next horizon into the fitness estimator's
   operands with the live market's hazard segments — one FIXED
   environment shape (pinned ``env_apps`` / seed / fault plan), so
   every window reuses the evaluator's one captured CUDA graph per
   shape and only the operands (arrival spacing, tier masks, scenario
   key) change,
3. scores the full action menu (hold / grow / drain / shed-tier /
   challenger weights) as ONE ``evaluate_rows`` call
   (``mpc/planner.py``), and
4. executes the predicted-best action — including handing a winning
   challenger to the staged rollout machine (``mpc/rollout.py``).

The proactive-drain trigger this replaces was a flat ``risk_weight``
bias: hazard now enters as the rendered environment's per-replica
eviction plans, so "drain before the spot market turns" wins exactly
when the shadow rollouts price it cheaper — a model decision, not a
hand-tuned constant.

Determinism boundary: the *scoring* path (``forecast``/``planner``)
is in the determinism manifest; this module — like the autoscaler —
does wall-clock pacing and is not.  The planner's :func:`referee_check`
runs every ``referee_every`` windows; a referee failure permanently
disables actuation (observe-only) and is recorded, so nondeterministic
scoring can never keep driving the pool.

A port of ``pivot_tpu/mpc/controller.py``.  The window's scenario key
is the threefry twin's ``prng.fold_in(prng.PRNGKey(seed), plans)``
(JAX's key bit for bit).  The planner and the tuner render and score on
the first session policy's torch device (``cuda`` for a numpy policy).  On the card the evaluator's norm
snapshot is a CUDA graph per operand shape (``parallel/ensemble/
tick.py``): :meth:`MpcController.warmup`, which the driver calls before
any serving thread starts, captures the planner's and the tuner's
shapes, so that no capture runs beside the serving threads
(:meth:`MpcController.captures_after_warmup` counts any that did).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from pivot_tpu_torch.mpc.forecast import (
    TierForecast,
    TierForecaster,
    render_env,
)
from pivot_tpu_torch.mpc.planner import (
    WEIGHTS,
    enumerate_actions,
    plan,
    referee_check,
)
from pivot_tpu_torch.mpc.rollout import WeightRollout
from pivot_tpu_torch.mpc.tuner import MpcTuner
from pivot_tpu_torch.search.weights import DEFAULT_WEIGHTS
from pivot_tpu_torch.utils import LogMixin

__all__ = ["MpcController"]


class MpcController(LogMixin):
    """One model-predictive supervisor per driver.  Owned and started
    by ``ServeDriver.run`` when the driver is built with an
    :class:`~pivot_tpu_torch.mpc.MpcConfig`; owns the forecaster, the
    background tuner, and the rollout state machine."""

    def __init__(self, driver, config):
        self.driver = driver
        self.config = config
        self.forecaster = TierForecaster(
            n_tiers=config.n_tiers,
            bucket_s=config.bucket_s,
            alpha=config.alpha,
        )
        self.tuner = (
            MpcTuner(
                seed=config.seed,
                generations=config.tune_generations,
                popsize=config.tune_popsize,
                max_regret=config.max_regret,
                interval_s=config.tune_interval_s,
                backend=config.backend,
            )
            if config.tune else None
        )
        self.rollout = WeightRollout(
            driver,
            tier=config.tier,
            canary_checks=config.canary_checks,
            watch_checks=config.watch_checks,
            regression_factor=config.regression_factor,
        )
        #: Planner decision log: one dict per executed window.
        self.events: List[dict] = []
        self.rounds = 0          # windows with a scored plan
        self.plans = 0           # fused planner dispatches issued
        self.disabled = False    # referee tripped: observe-only forever
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._template_cluster = None
        self._template_market = None
        self._key = None
        self._captures0 = None  # graph captures at the end of warmup()

    @property
    def device(self):
        """Where the planner and the tuner render and score: the serving
        policies' torch device, ``cuda`` for a numpy policy."""
        import torch

        dev = getattr(self.driver.sessions[0].policy, "device", None)
        return torch.device(dev if dev is not None else "cuda")

    # -- template world -----------------------------------------------------
    def _ensure_template(self) -> None:
        """Build the render template once: the config's injected
        cluster/market, else a fresh synthetic cluster the size of the
        serving pool's (WITHOUT ``reset_ids`` — fresh ids must not
        collide with the sessions' live apps) and a market generated
        from its meta.  One template for the controller's lifetime is
        what pins the compiled shadow-rollout shape."""
        if self._template_cluster is not None:
            return
        cfg = self.config
        if cfg.cluster is not None:
            self._template_cluster = cfg.cluster
        else:
            from pivot_tpu_torch.utils.config import ClusterConfig, build_cluster

            n_hosts = len(self.driver.sessions[0].cluster.hosts)
            self._template_cluster = build_cluster(
                ClusterConfig(n_hosts=n_hosts, seed=cfg.seed)
            )
        if cfg.market is not None:
            self._template_market = cfg.market
        else:
            from pivot_tpu_torch.infra.market import MarketSchedule

            self._template_market = MarketSchedule.generate(
                self._template_cluster.meta,
                seed=cfg.seed,
                horizon=cfg.horizon,
            )

    # -- observability ------------------------------------------------------
    def record(self, action: str, objective: float, pool: int,
               detail: str = "") -> None:
        self.events.append(
            {
                "wall_s": round(self.driver.slo.wall_clock, 4),
                "action": action,
                "objective": round(float(objective), 6),
                "pool": pool,
                "detail": detail,
            }
        )
        self.driver.tracer.mark(
            "mpc", action, objective=round(float(objective), 6),
            pool=pool, detail=detail,
        )

    def action_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for evt in list(self.events):
            counts[evt["action"]] = counts.get(evt["action"], 0) + 1
        return counts

    def summary(self) -> dict:
        fc = self.forecaster.snapshot()
        return {
            "rounds": self.rounds,
            "plans": self.plans,
            "disabled": self.disabled,
            "dry_run": self.config.dry_run,
            "forecast": {
                "rates": [round(r, 6) for r in fc.rates],
                "mix": [round(m, 4) for m in fc.mix],
                "n_observed": fc.n_observed,
            },
            "events": list(self.events),
            "tuner": (
                {
                    "rounds": self.tuner.rounds,
                    "eligible": sum(
                        1 for r in list(self.tuner.results) if r.eligible
                    ),
                }
                if self.tuner is not None else None
            ),
            "rollout": {
                "promotions": self.rollout.promotions,
                "rollbacks": self.rollout.rollbacks,
                "stage": self.rollout.stage,
                "events": list(self.rollout.events),
            },
        }

    # -- lifecycle ----------------------------------------------------------
    def _render(self, forecast):
        cfg = self.config
        self._ensure_template()
        return render_env(
            forecast,
            cluster=self._template_cluster,
            market=self._template_market,
            horizon=cfg.horizon,
            seed=cfg.seed,
            n_replicas=cfg.n_replicas,
            tick=cfg.tick,
            max_apps=cfg.env_apps,
            n_apps=cfg.env_apps,
            redraw_faults=cfg.redraw_faults,
            device=self.device,
        )

    def warmup(self) -> None:
        """Capture, on the calling thread, the evaluator's graphs of
        every shape the windows will score: the planner's five-slot menu
        and, with the tuner on, its CEM population.  A no-op off the
        card.  The driver calls it before any serving thread starts; the
        scores are thrown away and nothing of the controller's state
        moves (no plan is counted, no key is drawn from ``plans``)."""
        from pivot_tpu_torch.parallel.ensemble.tick import SNAPSHOT_GRAPHS
        from pivot_tpu_torch.search.fitness import evaluate_rows

        cfg = self.config
        if self.device.type == "cuda":
            rate = (cfg.env_apps / cfg.horizon,) + (0.0,) * (cfg.n_tiers - 1)
            env, _, task_tiers = self._render(TierForecast(
                rates=rate, mix=(1.0,) + (0.0,) * (cfg.n_tiers - 1),
                n_observed=cfg.min_observations, window=cfg.horizon))
            actions = enumerate_actions(
                1, g_min=1, g_max=2, incumbent=DEFAULT_WEIGHTS)
            plan(actions, env, task_tiers, 1, backend=cfg.backend)
            if self.tuner is not None:
                evaluate_rows([DEFAULT_WEIGHTS] * self.tuner.popsize, env,
                              backend=cfg.backend)
        self._captures0 = SNAPSHOT_GRAPHS.captures

    def captures_after_warmup(self) -> Optional[int]:
        """CUDA graph captures in the process since :meth:`warmup`
        (None before it)."""
        from pivot_tpu_torch.parallel.ensemble.tick import SNAPSHOT_GRAPHS

        if self._captures0 is None:
            return None
        return SNAPSHOT_GRAPHS.captures - self._captures0

    def start(self) -> None:
        if self.tuner is not None:
            self.tuner.start()
        self._thread = threading.Thread(
            target=self._loop, name="serve-mpc", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join()
        if self.tuner is not None:
            self.tuner.stop()

    # -- the control loop ---------------------------------------------------
    def _incumbent(self):
        pool = self.driver.policy_pool()
        if pool:
            w = getattr(pool[0][1], "weights", None)
            if w is not None:
                return w
        return DEFAULT_WEIGHTS

    def _loop(self) -> None:
        cfg = self.config
        driver = self.driver
        baseline = driver.slo.tier_decision_baseline(cfg.tier)
        last_event = -float("inf")
        while not self._stop_evt.wait(cfg.check_interval_s):
            # graftcheck: ignore[thread-guard] -- monotonic stop flag; a stale read costs one control window, and every pool mutation below re-validates under the driver's cv
            if driver._stop:
                break
            driver.finish_drained_retires()
            p99 = driver.slo.tier_decision_p99_since(cfg.tier, baseline)
            baseline = driver.slo.tier_decision_baseline(cfg.tier)
            # Staged rollout verdicts come first: a regression rolls
            # back in the same window it is measured.
            self.rollout.check(p99)
            forecast = self.forecaster.snapshot()
            if forecast.n_observed < cfg.min_observations:
                continue
            try:
                result, actions = self._plan_window(forecast)
            except Exception as e:  # pragma: no cover - defensive
                self.log.warning("mpc planning failed: %s", e)
                self.record("error", float("inf"), driver.pool_size(),
                            detail=str(e))
                continue
            if result is None:
                continue
            self.rounds += 1
            now = time.perf_counter()
            if (
                cfg.dry_run
                or self.disabled
                or now - last_event < cfg.cooldown_s
            ):
                self.record(
                    "observe", result.objectives[result.index],
                    driver.pool_size(), detail=result.chosen.kind,
                )
                continue
            if self._execute(result, p99):
                last_event = now

    def _plan_window(self, forecast):
        """Render the forecast and score the menu (one evaluator call)."""
        from pivot_tpu_torch.parallel.ensemble import prng

        cfg = self.config
        driver = self.driver
        env, _, task_tiers = self._render(forecast)
        incumbent = self._incumbent()
        if self.tuner is not None:
            self.tuner.submit(env, incumbent)
        challenger = (
            self.tuner.take_challenger()
            if self.tuner is not None and self.rollout.stage == "idle"
            else None
        )
        # The highest tier with forecast traffic is the sheddable one;
        # tier 0 is lossless and never enters the menu.
        shed_tier = None
        for t in range(cfg.n_tiers - 1, 0, -1):
            if forecast.rates[t] > 0:
                shed_tier = t
                break
        pool = driver.pool_size()
        actions = enumerate_actions(
            pool,
            g_min=cfg.g_min,
            g_max=cfg.g_max,
            incumbent=incumbent,
            shed_tier=shed_tier,
            challenger=challenger,
        )
        # Scenario draws refresh per window but replay per (seed,
        # round): the window index folds into the env-seed key.
        key = prng.fold_in(prng.PRNGKey(cfg.seed), self.plans)
        self.plans += 1
        kw = dict(
            latency_weight=cfg.latency_weight, key=key,
            backend=cfg.backend,
        )
        if cfg.referee_every > 0 and self.plans % cfg.referee_every == 1:
            if not referee_check(actions, env, task_tiers, pool, **kw):
                self.disabled = True
                self.driver.slo.count("mpc_referee_failures")
                self.record(
                    "referee_failed", float("inf"), pool,
                    detail="bitwise replay mismatch; actuation disabled",
                )
                return None, actions
        return plan(actions, env, task_tiers, pool, **kw), actions

    def _execute(self, result, p99: float) -> bool:
        """Drive the chosen action through the driver's thread-safe
        surface.  Returns True when an actuator actually moved (the
        cooldown only charges real actions)."""
        driver = self.driver
        chosen = result.chosen
        obj = float(result.objectives[result.index])
        pool = driver.pool_size()
        plane = getattr(driver, "_recovery", None)
        if plane is not None:
            # Write-ahead: the actuation intent hits the journal before
            # the actuator moves — a crash between record and effect is
            # a journaled intent a replay can reconcile, never a silent
            # pool mutation.
            plane.journal_mpc(chosen.kind, pool)
        if chosen.kind == "grow":
            if driver.grow_pool(reason=f"mpc predicted obj {obj:.4f}"):
                driver.slo.count("mpc_grows")
                self.record("grow", obj, pool + 1)
                return True
        elif chosen.kind == "drain":
            victim = driver.begin_retire()
            if victim is not None:
                driver.slo.count("mpc_drains")
                self.record(
                    "drain", obj, pool - 1,
                    detail=f"draining {victim.label}",
                )
                return True
        elif chosen.kind == "shed":
            # shed_pressure victims are tiers STRICTLY below its
            # argument, so shedding tier t passes t − 1.
            if driver.shed_pressure(chosen.shed_tier - 1):
                driver.slo.count("mpc_sheds")
                self.record(
                    "shed", obj, pool, detail=f"tier {chosen.shed_tier}",
                )
                return True
        elif chosen.kind == WEIGHTS:
            if self.rollout.propose(chosen.weights, p99):
                self.record("canary", obj, pool)
                return True
        else:
            self.record("hold", obj, pool)
            return False
        # The actuator declined (no spare session, no victim, rollout
        # busy): recorded so a soak report shows the planner's intent
        # even when the pool could not follow it.
        self.record(f"{chosen.kind}_noop", obj, pool)
        return False
