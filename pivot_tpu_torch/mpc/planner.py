"""The model-predictive planner: one evaluator call scores every action.

Each decision window the controller enumerates a small, FIXED-SIZE menu
of candidate actions — hold, grow the pool, drain a session, shed the
lowest forecast tier, promote the tuner's challenger weights — and
scores *all of them at once* as one ``evaluate_rows`` call over K
seeded shadow rollouts of the forecast horizon
(``search/fitness.py``).  The actions ride the two per-candidate
channels added for this subsystem:

* ``cap_rows[b]``   — capacity scale: ``(pool + Δ_b) / pool`` prices a
  grow/drain as proportionally more/less availability in the rollout;
* ``active_rows[b]`` — admit mask: a shed action deactivates every
  task of the shed tier's apps, so the score trades the lost
  throughput against the saved cost *inside the same number*.

The menu size never changes (infeasible slots are scored as clones of
HOLD and excluded from the argmin), so every plan has one operand
shape: on the card, after the controller's warm-up, every plan replays
the evaluator's captured CUDA graph and captures none.  Scoring is
deterministic end to end (seeded draws, one fixed reduction order, no
float atomics); :func:`referee_check` replays a plan and demands
bitwise equality — the per-tick referee that guards the controller
against nondeterministic scoring ever reaching an actuator.

A port of ``pivot_tpu/mpc/planner.py`` onto the port's
``evaluate_rows`` (``search/fitness.py``); ``key`` is threefry key data
(``parallel/ensemble/prng.py``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from pivot_tpu_torch.search.weights import PolicyWeights

__all__ = [
    "CandidateAction",
    "PlanResult",
    "enumerate_actions",
    "plan",
    "referee_check",
]

#: Action kinds, in menu order — the argmin tie-break is this order, so
#: HOLD (slot 0) wins every tie: the planner never moves on a wash.
HOLD, GROW, DRAIN, SHED, WEIGHTS = "hold", "grow", "drain", "shed", "weights"


class CandidateAction(NamedTuple):
    """One slot of the planner menu."""

    kind: str
    pool_delta: int                  # +1 grow / −1 drain / 0 otherwise
    shed_tier: Optional[int]         # tasks of tiers >= this are masked
    weights: PolicyWeights           # scoring vector this slot rolls with
    feasible: bool                   # infeasible slots pad the menu only


def enumerate_actions(
    pool: int,
    *,
    g_min: int,
    g_max: int,
    incumbent: PolicyWeights,
    shed_tier: Optional[int] = None,
    challenger: Optional[PolicyWeights] = None,
) -> List[CandidateAction]:
    """The fixed five-slot menu for one decision window.

    Slots: ``[hold, grow, drain, shed, weights]`` — always five, in
    that order, so the scoring call keeps one operand shape.
    Infeasible slots (at ``g_max``, at ``g_min``, nothing sheddable, no
    eligible challenger) are emitted as HOLD clones with
    ``feasible=False``.  ``shed_tier`` must be >= 1: tier 0 is the
    lossless tier and is never sheddable (the acceptance criterion).
    """
    if pool < 1:
        raise ValueError(f"pool must be >= 1, got {pool}")
    if shed_tier is not None and shed_tier < 1:
        raise ValueError(
            f"tier 0 is lossless — shed_tier must be >= 1, got {shed_tier}"
        )
    incumbent = incumbent.validate()
    hold = CandidateAction(HOLD, 0, None, incumbent, True)
    grow = (
        CandidateAction(GROW, 1, None, incumbent, True)
        if pool < g_max else hold._replace(kind=GROW, feasible=False)
    )
    drain = (
        CandidateAction(DRAIN, -1, None, incumbent, True)
        if pool > g_min else hold._replace(kind=DRAIN, feasible=False)
    )
    shed = (
        CandidateAction(SHED, 0, int(shed_tier), incumbent, True)
        if shed_tier is not None
        else hold._replace(kind=SHED, feasible=False)
    )
    wts = (
        CandidateAction(WEIGHTS, 0, None, challenger.validate(), True)
        if challenger is not None
        else hold._replace(kind=WEIGHTS, feasible=False)
    )
    return [hold, grow, drain, shed, wts]


class PlanResult(NamedTuple):
    """One scored decision window."""

    chosen: CandidateAction
    index: int                 # menu slot of the winner
    objectives: np.ndarray     # [B] combined objective (inf = infeasible)
    scores: np.ndarray         # [B] cost per completed task
    details: dict              # evaluate_rows detail block


def _action_channels(actions, task_tiers, pool):
    """(W [B,5], cap_rows [B], active_rows [B,T]) for one menu.  Both
    channels are ALWAYS materialized — a None would take the
    evaluator's other path on the first real grow/shed."""
    tiers = np.asarray(task_tiers)
    B, T = len(actions), tiers.shape[0]
    W = PolicyWeights.stack([a.weights for a in actions])
    cap_rows = np.asarray(
        [(pool + a.pool_delta) / pool for a in actions], dtype=np.float64
    )
    active_rows = np.ones((B, T), dtype=bool)
    for b, a in enumerate(actions):
        if a.feasible and a.shed_tier is not None:
            active_rows[b] = tiers < a.shed_tier
            if not active_rows[b].any():
                # A mask that sheds EVERYTHING scores 0/0; keep the
                # slot shaped but force it infeasible via the caller.
                active_rows[b] = True
    return W, cap_rows, active_rows


def plan(
    actions: List[CandidateAction],
    env,
    task_tiers,
    pool: int,
    *,
    latency_weight: float = 0.0,
    key=None,
    backend: str = "rollout",
    tick_order: str = "fifo",
) -> PlanResult:
    """Score the menu with ONE evaluator call and pick the winner.

    The objective is ``cost_per_completed + latency_weight × makespan``
    — dollars per task with a configurable latency term, both produced
    by the same rollout.  Infeasible slots score ``inf``; ties break to
    the lowest slot index (HOLD first), so an indifferent model holds.
    """
    from pivot_tpu_torch.search.fitness import evaluate_rows

    if not actions:
        raise ValueError("planner needs a non-empty action menu")
    W, cap_rows, active_rows = _action_channels(actions, task_tiers, pool)
    scores, details = evaluate_rows(
        W, env, key=key, backend=backend, tick_order=tick_order,
        cap_rows=cap_rows, active_rows=active_rows,
    )
    objectives = np.asarray(scores, dtype=np.float64) + (
        float(latency_weight) * np.asarray(details["makespan"], np.float64)
    )
    feasible = np.asarray([a.feasible for a in actions], dtype=bool)
    masked = np.where(feasible, objectives, np.inf)
    if not np.isfinite(masked).any():
        index = 0  # every slot infeasible or diverged: hold
    else:
        index = int(np.argmin(masked))  # first minimum = menu order
    return PlanResult(
        chosen=actions[index],
        index=index,
        objectives=objectives,
        scores=np.asarray(scores, dtype=np.float64),
        details=details,
    )


def referee_check(
    actions: List[CandidateAction],
    env,
    task_tiers,
    pool: int,
    *,
    latency_weight: float = 0.0,
    key=None,
    backend: str = "rollout",
    tick_order: str = "fifo",
) -> bool:
    """Deterministic-scoring referee: replay the plan call and
    demand bitwise-identical objectives AND the same winning slot.
    The controller runs this every ``referee_every`` windows; a failure
    means the scoring path picked up nondeterminism (exactly what must
    never drive an actuator) and disables the controller's actions."""
    a = plan(
        actions, env, task_tiers, pool, latency_weight=latency_weight,
        key=key, backend=backend, tick_order=tick_order,
    )
    b = plan(
        actions, env, task_tiers, pool, latency_weight=latency_weight,
        key=key, backend=backend, tick_order=tick_order,
    )
    return bool(
        np.array_equal(a.objectives, b.objectives) and a.index == b.index
    )
