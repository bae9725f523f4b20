"""Arrival forecasting for model-predictive serving.

The reactive serving stack (``serve/autoscale.py``) only ever looks
backward: it scales on the p99 *already measured*, so every response is
one breach window late by construction.  Model-predictive serving
closes that gap by running the simulator's own fitness estimator
(``search/fitness.py``) *inside* the server — and the forecaster here
is the bridge: it fits a small, seeded, replayable model of the recent
arrival stream and renders it into the exact ensemble operands
(:class:`~pivot_tpu_torch.search.fitness.SearchEnv`) the estimator scores,
so the planner's shadow rollouts predict the next horizon instead of
re-measuring the last one.

A port of ``pivot_tpu/mpc/forecast.py``: :class:`TierForecaster` is the
reference's numpy, copied; :func:`render_env` renders on ``device``
(the card unless the caller asks for the CPU) in float64 on the CPU and
float32 on the card (float64 score exponents are host-only,
``libm.require_host``).

Two deliberate properties:

* **Deterministic.**  A :class:`TierForecast` is a pure function of the
  observed ``(sim_ts, tier)`` pairs — per-tier exponentially-weighted
  bucket rates over the observation window, no wall clocks, no
  unseeded randomness — and :func:`render_env` is a pure function of
  ``(forecast, cluster, market, seed)``.  The same observations always
  render the same environment bit for bit (``tests/test_mpc.py`` pins
  the replay), which is what makes every planner decision auditable
  after the fact.

* **Live-world injection.**  ``render_env`` hands the controller's
  *template* cluster and the live :class:`MarketSchedule` straight to
  ``make_search_env(cluster=..., market=...)`` — the injection path
  added for this module — so the shadow rollouts price placements with
  the SAME hazard segments and price multipliers the serving sessions
  are experiencing, not a synthetic market drawn from a different seed.
"""

from __future__ import annotations

import math
import threading
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["TierForecast", "TierForecaster", "render_env"]


class TierForecast(NamedTuple):
    """Fitted per-tier arrival rates (jobs / sim-second) plus the
    window they were fitted over.  ``mix`` is the normalized tier
    distribution (sums to 1 when any traffic was seen)."""

    rates: Tuple[float, ...]   # per-tier jobs/sim-s
    mix: Tuple[float, ...]     # per-tier fraction of traffic
    n_observed: int            # observations in the fit window
    window: float              # sim-seconds the fit covered

    @property
    def total_rate(self) -> float:
        return float(sum(self.rates))


class TierForecaster:
    """Per-tier arrival-rate estimator over a sliding stream window.

    ``observe`` is called from the driver's admission path (producer
    thread) with the arrival's *sim* timestamp and tier; ``snapshot``
    fits from the controller thread.  The fit is an exponentially-
    weighted mean of per-bucket counts — newer buckets dominate, so a
    burst shows up within one bucket width — computed over at most
    ``max_obs`` retained arrivals.  Everything is sim-time: the
    forecaster never reads a wall clock (``analysis/determinism.py``
    holds this file to that).
    """

    def __init__(
        self,
        n_tiers: int = 3,
        bucket_s: float = 20.0,
        alpha: float = 0.5,
        max_obs: int = 4096,
    ):
        if n_tiers < 1:
            raise ValueError(f"n_tiers must be >= 1, got {n_tiers}")
        if not bucket_s > 0:
            raise ValueError(f"bucket_s must be positive, got {bucket_s}")
        if not 0 < alpha <= 1:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.n_tiers = n_tiers
        self.bucket_s = float(bucket_s)
        self.alpha = float(alpha)
        self.max_obs = int(max_obs)
        self._lock = threading.Lock()
        self._obs: List[Tuple[float, int]] = []

    def observe(self, ts: float, tier: int) -> None:
        """Record one arrival (sim timestamp, tier).  Thread-safe;
        out-of-range tiers clamp into the forecast's last bucket rather
        than dropping traffic silently."""
        t = min(max(int(tier), 0), self.n_tiers - 1)
        with self._lock:
            self._obs.append((float(ts), t))
            if len(self._obs) > self.max_obs:
                # Keep the newest window; admission order is
                # timestamp order, so a slice is the window.
                del self._obs[: len(self._obs) - self.max_obs]

    def snapshot(self) -> TierForecast:
        """Fit the current window.  Empty stream ⇒ zero rates."""
        with self._lock:
            obs = list(self._obs)
        if not obs:
            z = (0.0,) * self.n_tiers
            return TierForecast(rates=z, mix=z, n_observed=0, window=0.0)
        t0 = obs[0][0]
        t1 = obs[-1][0]
        # At least one full bucket so a single arrival yields a finite
        # rate instead of a division by zero.
        span = max(t1 - t0, self.bucket_s)
        n_buckets = int(math.ceil(span / self.bucket_s))
        counts = np.zeros((n_buckets, self.n_tiers), dtype=np.float64)
        for ts, tier in obs:
            b = min(int((ts - t0) / self.bucket_s), n_buckets - 1)
            counts[b, tier] += 1.0
        # EWMA over buckets, oldest → newest: rate_k = α·x_k + (1−α)·
        # rate_{k−1}, seeded with the first bucket.
        rate = counts[0] / self.bucket_s
        for k in range(1, n_buckets):
            rate = self.alpha * (counts[k] / self.bucket_s) + (
                1.0 - self.alpha
            ) * rate
        total = float(rate.sum())
        mix = (
            tuple(float(r) / total for r in rate)
            if total > 0 else (0.0,) * self.n_tiers
        )
        return TierForecast(
            rates=tuple(float(r) for r in rate),
            mix=mix,
            n_observed=len(obs),
            window=float(span),
        )


def render_env(
    forecast: TierForecast,
    *,
    cluster,
    market,
    horizon: float,
    seed: int,
    n_replicas: int = 4,
    tick: float = 5.0,
    max_apps: int = 12,
    n_apps: Optional[int] = None,
    redraw_faults: bool = True,
    perturb: float = 0.1,
    device="cuda",
    dtype=None,
):
    """Render a forecast into scoring operands: ``(SearchEnv,
    app_tiers [A], task_tiers [T])``.

    The predicted horizon carries ``ceil(total_rate × horizon)`` apps
    (clamped to ``[1, max_apps]`` — the environment is a *model*, and
    its cost is one fused dispatch over B×R rollouts, so it must stay
    small), evenly spaced at the predicted inter-arrival gap.  Passing
    ``n_apps`` pins the app count instead — the controller does, every
    window, so the rendered operand SHAPES never change and one warm
    captured graph serves every plan (the predicted rate then enters
    through the arrival spacing, which is data, not shape).  ``dtype``
    (None: float64 on the CPU, float32 elsewhere) and ``device`` go to
    ``make_search_env``.  Each app
    is assigned a tier by largest-remainder apportionment of the
    forecast mix — deterministic, and exact in expectation — and every
    task inherits its app's tier (``workload.app_of``), so the
    planner's shed masks drop whole DAGs: masking a mid-graph task
    would strand its active successors as permanently unfinished and
    corrupt the score.
    """
    from pivot_tpu_torch.search.fitness import make_search_env

    lam = forecast.total_rate
    if n_apps is None:
        n_apps = int(min(max(math.ceil(lam * horizon), 1), max_apps))
    n_apps = int(n_apps)
    if n_apps < 1:
        raise ValueError(f"n_apps must be >= 1, got {n_apps}")
    # Predicted inter-arrival gap, clamped into the horizon so a lull
    # cannot push the whole rendered stream past the scoring window.
    spacing = (
        min(max(1.0 / lam, 0.0), horizon / n_apps) if lam > 0 else 0.0
    )
    env = make_search_env(
        n_hosts=len(cluster.hosts),
        seed=seed,
        n_apps=n_apps,
        horizon=horizon,
        tick=tick,
        n_replicas=n_replicas,
        perturb=perturb,
        arrival_spacing=spacing,
        redraw_faults=redraw_faults,
        cluster=cluster,
        market=market,
        dtype=render_dtype(device) if dtype is None else dtype,
        device=device,
    )
    app_tiers = _apportion_tiers(forecast.mix, n_apps)
    app_of = env.workload.app_of.cpu().numpy()
    task_tiers = app_tiers[app_of]
    return env, app_tiers, task_tiers


def render_dtype(device):
    """The rendered environment's float type: float64 on the CPU (the
    parity path), float32 on the card."""
    import torch

    return (torch.float64 if torch.device(device).type == "cpu"
            else torch.float32)


def _apportion_tiers(mix: Tuple[float, ...], n_apps: int) -> np.ndarray:
    """[A] i32 tier per app by largest-remainder apportionment of
    ``mix`` (ties to the lower tier — deterministic).  A zero mix
    (no traffic observed) assigns everything tier 0."""
    m = np.asarray(mix, dtype=np.float64)
    if m.sum() <= 0:
        return np.zeros(n_apps, dtype=np.int32)
    m = m / m.sum()
    quota = m * n_apps
    base = np.floor(quota).astype(np.int64)
    short = n_apps - int(base.sum())
    if short > 0:
        remainder = quota - base
        # Stable argsort descending remainder; ties favor lower tiers.
        order = np.argsort(-remainder, kind="stable")
        for k in range(short):
            base[order[k]] += 1
    tiers = np.repeat(np.arange(len(m), dtype=np.int32), base)
    return tiers[:n_apps].astype(np.int32)
