"""Evolution-strategies search over :class:`PolicyWeights` space.

Port of ``pivot_tpu/search/es.py``, a numpy copy with the import paths
rewritten.

OpenAI-ES shape: antithetic Gaussian perturbations around a center
``theta``, rank-shaped utilities, a gradient *estimate* from the
utility-weighted noise — the population-based mirror of the CEM
optimizer, trading CEM's distribution refits for a smoother trajectory
on noisy fitness (both share the fused-dispatch evaluator and the
replay contract; see ``search/loop.py``).  ``theta`` itself rides along
as the last candidate every generation, so the incumbent is always
re-scored and the result's ``best`` is always an *evaluated* vector.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pivot_tpu_torch.search.loop import SearchResult, score_population, trace_entry
from pivot_tpu_torch.search.weights import (
    DEFAULT_WEIGHTS,
    PolicyWeights,
    SearchSpace,
)

__all__ = ["es_search"]


def es_search(
    env,
    *,
    generations: int = 8,
    popsize: int = 16,
    seed: int = 0,
    init: Optional[PolicyWeights] = None,
    space: Optional[SearchSpace] = None,
    sigma0: float = 0.2,
    lr: float = 0.5,
    backend: str = "rollout",
    mesh=None,
    tick_order: str = "fifo",
) -> SearchResult:
    """Minimize cost-per-completed-task over ``env`` with antithetic ES.

    ``popsize`` counts evaluated candidates per generation: ``popsize −
    1`` antithetic perturbations (rounded down to an even count) plus
    the incumbent ``theta``.  ``sigma0`` is the per-dimension noise
    scale as a fraction of the search box width; ``lr`` the step size
    on the rank-shaped gradient estimate.
    """
    if popsize < 3:
        raise ValueError(f"popsize must be >= 3 (2 antithetic + theta), got {popsize}")
    if generations < 1:
        raise ValueError(f"generations must be >= 1, got {generations}")
    half = (popsize - 1) // 2
    space = space if space is not None else SearchSpace.default()
    init = (init if init is not None else DEFAULT_WEIGHTS).validate()
    anchor = init.to_array()
    D = PolicyWeights.DIM
    rng = np.random.default_rng(seed)
    width = space.hi - space.lo
    sigma = np.where(space.frozen, 0.0, sigma0 * width)
    theta = space.clip(anchor[None], anchor)[0]

    best_vec = theta.copy()
    best_score = np.inf
    init_score = None
    trace = []
    for g in range(generations):
        eps = rng.standard_normal((half, D))
        pop = np.concatenate(
            [
                theta[None, :] + sigma[None, :] * eps,
                theta[None, :] - sigma[None, :] * eps,
                theta[None, :],
            ]
        )
        pop = space.clip(pop, anchor)
        scores = score_population(
            pop, env, g, backend=backend, mesh=mesh, tick_order=tick_order
        )
        if init_score is None:
            init_score = float(scores[-1])  # theta_0, generation 0
        k = int(np.argmin(scores))
        if scores[k] < best_score:
            best_score = float(scores[k])
            best_vec = pop[k].copy()
        # Rank-shaped utilities over the 2·half perturbed candidates
        # (theta excluded): centered in [−0.5, 0.5], best (lowest
        # score) highest — robust to the fitness scale and to the inf
        # scores incomplete rollouts produce.
        pair_scores = scores[: 2 * half]
        ranks = np.argsort(np.argsort(pair_scores, kind="stable"))
        util = 0.5 - ranks / max(2 * half - 1, 1)
        grad = (util[:half] - util[half:]) @ eps / max(half, 1)  # [D]
        theta = space.clip(
            (theta + lr * sigma * grad)[None], anchor
        )[0]
        entry = trace_entry(g, pop, scores)
        entry["theta"] = [float(x) for x in theta]
        entry["best_so_far"] = float(best_score)
        trace.append(entry)
    return SearchResult(
        best=PolicyWeights.from_array(best_vec),
        best_score=float(best_score),
        init_score=float(init_score),
        trace=trace,
        method="es",
        seed=seed,
        generations=generations,
        popsize=popsize,
        backend=backend,
    )
