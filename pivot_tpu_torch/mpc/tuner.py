"""Background weight tuning with a regret gate.

The policy-search subsystem (``search/``) tunes
:class:`~pivot_tpu_torch.search.weights.PolicyWeights` offline; this module
runs the SAME machinery as a background worker inside the serving
process.  The controller submits each freshly rendered forecast
environment; the worker re-fits a small CEM search against it
(``search/cem.py`` — replayed recent traffic, seeded scenario draws)
and publishes the best vector as a *challenger*.

A challenger is only eligible for the planner's WEIGHTS slot after the
**regret gate**: the candidate's greedy placement on a small oracle
instance derived from the same environment must sit within
``max_regret`` dollars of the branch-and-bound optimum
(``search/oracle.py``).  The gate bounds distance-from-optimal *before*
any live traffic sees the vector — a CEM run that wandered into a
pathological corner of weight space is rejected here, not by the canary
rollback.

The worker thread does wall-clock pacing and therefore lives OUTSIDE
the determinism manifest (like ``serve/``); each ``tune_once`` call is
itself deterministic in its arguments.

A port of ``pivot_tpu/mpc/tuner.py`` onto the port's ``search/cem.py``
and ``search/oracle.py``; the gate reads the environment's tensors to
the host.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import numpy as np

from pivot_tpu_torch.search.weights import DEFAULT_WEIGHTS, PolicyWeights
from pivot_tpu_torch.utils import LogMixin

__all__ = ["TunerResult", "MpcTuner", "tune_once", "gate_regret"]


class TunerResult(NamedTuple):
    """One finished tuning round."""

    weights: PolicyWeights
    score: float           # CEM best fitness (cost/completed task)
    init_score: float      # incumbent's fitness, same scenarios
    regret: float          # oracle-gate regret ($), inf if gate failed
    eligible: bool         # beat the incumbent AND passed the gate
    seed: int


def gate_regret(
    env,
    weights: PolicyWeights,
    *,
    n_tasks: int = 5,
    max_nodes: int = 200_000,
) -> float:
    """Regret ($) of ``weights``'s greedy placement against the exact
    optimum on the root wave of ``env``'s workload.

    The instance is the first ``n_tasks`` tasks placed against the
    environment's initial availability — small enough for
    branch-and-bound to prove the optimum, derived from the same
    operands the rollouts scored.  The oracle raising (node budget,
    degenerate instance) gates the candidate OUT (``inf``): an
    unverifiable candidate is treated like a bad one.
    """
    from pivot_tpu_torch.search.oracle import (
        greedy_placement,
        instance_from_wave,
        regret,
        solve_instance,
    )

    T = env.n_tasks
    mask = np.zeros(T, dtype=bool)
    mask[: min(n_tasks, T)] = True
    hazard = None
    if env.hazard is not None:
        # Price eviction exposure at the horizon's FIRST hazard segment
        # — the wave the gate scores is the first wave placed.
        hazard = env.hazard[1][0].cpu().numpy()
    try:
        inst = instance_from_wave(
            env.workload,
            env.topo,
            env.avail0.cpu().numpy().astype(np.float64),
            np.full(T, -1, dtype=np.int64),
            mask,
            hazard=hazard,
            weights=weights,
        )
        _, optimum, _ = solve_instance(inst, max_nodes=max_nodes)
        return float(
            regret(inst, greedy_placement(inst, weights), optimum)
        )
    except (ValueError, RuntimeError):
        return float("inf")


def tune_once(
    env,
    *,
    incumbent: Optional[PolicyWeights] = None,
    seed: int = 0,
    generations: int = 2,
    popsize: int = 6,
    max_regret: float = 1.0,
    backend: str = "rollout",
) -> TunerResult:
    """One deterministic tuning round: CEM over ``env`` anchored at the
    incumbent, then the regret gate.  Eligibility requires BOTH a
    strictly better fitness than the incumbent under the same scenarios
    and a gate regret within ``max_regret``."""
    from pivot_tpu_torch.search.cem import cem_search

    incumbent = (incumbent or DEFAULT_WEIGHTS).validate()
    result = cem_search(
        env, generations=generations, popsize=popsize, seed=seed,
        init=incumbent, backend=backend,
    )
    best = result.best.validate()
    improved = result.best_score < result.init_score
    reg = gate_regret(env, best, max_nodes=200_000) if improved else float(
        "inf"
    )
    return TunerResult(
        weights=best,
        score=float(result.best_score),
        init_score=float(result.init_score),
        regret=reg,
        eligible=bool(improved and reg <= max_regret),
        seed=seed,
    )


class MpcTuner(LogMixin):
    """The background worker.  The controller hands it rendered
    environments (:meth:`submit`); the worker re-fits on the newest one
    and publishes the latest :class:`TunerResult`; the controller takes
    an eligible challenger (:meth:`take_challenger`) when building the
    planner menu — taking clears it, so one tuning round backs at most
    one promotion attempt."""

    def __init__(
        self,
        *,
        seed: int = 0,
        generations: int = 2,
        popsize: int = 6,
        max_regret: float = 1.0,
        interval_s: float = 0.2,
        backend: str = "rollout",
    ):
        self.seed = int(seed)
        self.generations = int(generations)
        self.popsize = int(popsize)
        self.max_regret = float(max_regret)
        self.interval_s = float(interval_s)
        self.backend = backend
        self.rounds = 0
        self.results: list = []      # TunerResult log, newest last
        self._pending = None          # (env, incumbent) slot
        self._challenger: Optional[TunerResult] = None
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- controller-facing surface ----------------------------------------
    def submit(self, env, incumbent: PolicyWeights) -> None:
        """Queue the newest environment for the next tuning round
        (newest-wins: stale forecasts are not worth fitting)."""
        with self._lock:
            self._pending = (env, incumbent)

    def take_challenger(self) -> Optional[PolicyWeights]:
        """Pop the eligible challenger, if one is published."""
        with self._lock:
            res, self._challenger = self._challenger, None
        return res.weights if res is not None else None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="mpc-tuner", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join()

    def _loop(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            with self._lock:
                work, self._pending = self._pending, None
            if work is None:
                continue
            env, incumbent = work
            # Each round re-seeds deterministically: round k of a
            # seed-s tuner always fits with seed s + k.
            res = tune_once(
                env,
                incumbent=incumbent,
                seed=self.seed + self.rounds,
                generations=self.generations,
                popsize=self.popsize,
                max_regret=self.max_regret,
                backend=self.backend,
            )
            self.rounds += 1
            with self._lock:
                self.results.append(res)
                if res.eligible:
                    self._challenger = res
