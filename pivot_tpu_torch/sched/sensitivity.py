"""Sensitivity-gated dispatch: hold placements that are not noise-robust.

Port of ``pivot_tpu/sched/sensitivity.py``.  ``placement_sensitivity``
of a device policy (``sched/cuda.py``) scores each tick's decision
against ±perturb noise in the host-availability snapshot — replica 0 is
the exact production decision, replicas 1..R−1 re-run the whole batched
pass under multiplicative noise, and ``stability[t]`` is the fraction
agreeing with the nominal host.  This module gives that signal a
dispatcher: a policy wrapper that HOLDS (leaves unplaced for one tick)
any task whose nominal placement is below a stability threshold.

The experiment around it (``experiments/cli.py sensitivity``) pairs this
arm against the identical un-gated policy on the same (trace, cluster,
seed) and reports the egress / runtime / makespan deltas across seeds.
On the card, a gated Cost-Aware tick is one launch of the replica-batched
``greedy_place`` kernel; the First-Fit / Best-Fit arms run the batched
torch passes of ``ops/kernels.py``.

:func:`evaluate_candidates` is the batched evaluator over *candidate
weight vectors* that the policy search drives: it delegates to
``search/fitness.py::evaluate_rows`` (the ensemble's row runner).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from pivot_tpu_torch.sched import Policy, TickContext

__all__ = ["SensitivityGatedCostAware", "evaluate_candidates"]


def evaluate_candidates(weights, env, **kw) -> np.ndarray:
    """Score a ``[B]`` population of scoring-weight vectors under a
    seeded market environment: ``scores[b]`` is candidate b's mean
    cost-per-completed-task over the environment's R paired Monte-Carlo
    rollouts (lower is better).

    The library surface of the search loop (``pivot_tpu_torch.search.es``
    / ``pivot_tpu_torch.search.cem``), as
    ``pivot_tpu/sched/sensitivity.py:34`` is.  ``weights`` is a ``[B,
    5]`` matrix (:meth:`pivot_tpu_torch.search.PolicyWeights.stack`) or a
    sequence of :class:`~pivot_tpu_torch.search.PolicyWeights`; ``env`` a
    :class:`~pivot_tpu_torch.search.fitness.SearchEnv`.  Keyword
    arguments (``key``, ``backend``, ``mesh``, ``tick_order``,
    ``cap_rows``, ``active_rows``) pass through to
    :func:`pivot_tpu_torch.search.fitness.evaluate_rows`: the population
    is one row batch of the ensemble rollout on the environment's
    device, or (``backend="sharded_rollout"``, ``mesh``) its rows in
    blocks over a replica mesh's ``replica`` axis — the same scores.

    Imported lazily so this module never drags the search/ensemble
    stack in by itself.
    """
    from pivot_tpu_torch.search.fitness import evaluate_rows

    scores, _details = evaluate_rows(weights, env, **kw)
    return scores


class SensitivityGatedCostAware(Policy):
    """Placement with low-stability decisions held one tick.

    Wraps any device policy exposing ``placement_sensitivity`` (the
    cost-aware arm by default; pass ``inner=CudaFirstFitPolicy(
    decreasing=True)`` for the VBP arm); each tick runs ONE batched
    sensitivity call (replica 0 of which is the production decision, so
    gating adds no second placement pass) and overrides to −1 any placed
    task with ``stability < threshold`` that has not already been held
    ``max_holds`` times.  Held tasks re-enter through the scheduler's wait
    queue and are re-scored — with fresh noise — next tick; after
    ``max_holds`` holds the nominal decision goes through regardless, so
    a permanently-marginal task cannot starve.  The wrapper has no
    ``place_span``: the scheduler serves it tick by tick.
    """

    name = "cost_aware_sensitivity_gated"  # refined per-inner in __init__

    def __init__(
        self,
        threshold: float = 0.7,
        n_replicas: int = 256,
        perturb: float = 0.05,
        max_holds: int = 1,
        noise_seed: int = 0,
        inner: Optional[object] = None,
        **inner_kwargs,
    ):
        from pivot_tpu_torch.sched.cuda import CudaCostAwarePolicy

        if inner is not None and inner_kwargs:
            raise ValueError("pass inner or inner_kwargs, not both")
        self.inner = inner or CudaCostAwarePolicy(**inner_kwargs)
        if not hasattr(self.inner, "placement_sensitivity"):
            raise TypeError(
                f"{type(self.inner).__name__} has no placement_sensitivity"
                " — the gate needs the batched noise-replica kernel"
            )
        inner_name = getattr(self.inner, "name", type(self.inner).__name__)
        self.name = f"{inner_name}_sensitivity_gated"
        self.threshold = threshold
        self.n_replicas = n_replicas
        self.perturb = perturb
        self.max_holds = max_holds
        self.noise_seed = noise_seed
        self._holds: dict = {}
        self.stats = {
            "ticks": 0,
            "decisions": 0,
            "placed_nominal": 0,
            "held": 0,
            "forced_through": 0,  # low-stability but hold budget exhausted
            "stability_sum": 0.0,
            "min_stability": 1.0,
            # Wall seconds spent inside the batched sensitivity calls —
            # the gate's own price.
            "sensitivity_wall_s": 0.0,
        }

    def bind(self, scheduler) -> None:
        self.inner.bind(scheduler)

    def place(self, ctx: TickContext) -> np.ndarray:
        # Fresh noise per tick (seed keyed on the tick ordinal): a held
        # task is re-judged against new draws, not the sample that
        # flagged it.
        t0 = time.perf_counter()  # graftcheck: ignore[determinism] -- feeds only the sensitivity_wall_s meter; placements derive from the seeded noise draws alone
        nominal, stability, _ = self.inner.placement_sensitivity(
            ctx,
            n_replicas=self.n_replicas,
            perturb=self.perturb,
            seed=self.noise_seed + ctx.tick_seq,
        )
        self.stats["sensitivity_wall_s"] += time.perf_counter() - t0  # graftcheck: ignore[determinism] -- meter bookkeeping only (same window)
        placements = np.asarray(nominal, dtype=np.int64).copy()
        st = self.stats
        st["ticks"] += 1
        st["decisions"] += ctx.n_tasks
        for i, task in enumerate(ctx.tasks):
            if placements[i] < 0:
                continue
            st["placed_nominal"] += 1
            s = float(stability[i])
            st["stability_sum"] += s
            if s < st["min_stability"]:
                st["min_stability"] = s
            if s < self.threshold:
                held = self._holds.get(task, 0)
                if held < self.max_holds:
                    self._holds[task] = held + 1
                    placements[i] = -1
                    st["held"] += 1
                else:
                    st["forced_through"] += 1
            if placements[i] >= 0:
                self._holds.pop(task, None)  # placed: forget hold history
        return placements

    def summary(self) -> dict:
        st = dict(self.stats)
        st["mean_stability"] = (
            st.pop("stability_sum") / st["placed_nominal"]
            if st["placed_nominal"]
            else None
        )
        st["sensitivity_wall_s"] = round(st["sensitivity_wall_s"], 3)
        st["sensitivity_wall_per_tick_s"] = (
            round(st["sensitivity_wall_s"] / st["ticks"], 4)
            if st["ticks"] else None
        )
        return st
