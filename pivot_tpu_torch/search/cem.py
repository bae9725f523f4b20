"""Cross-entropy-method search over :class:`PolicyWeights` space.

Port of ``pivot_tpu/search/cem.py``, a numpy copy with the import paths
rewritten.

The simplest robust optimizer for a 5-dimensional, noisy,
simulation-defined fitness surface: sample a Gaussian population, keep
the elite quantile, refit the Gaussian, repeat.  Every generation's
population — the current mean rides along as candidate 0, so the
incumbent is always re-scored under the generation's scenarios — is
scored by ONE fused ensemble dispatch
(``sched.sensitivity.evaluate_candidates``).  Deterministic end to end:
population sampling from ``default_rng(seed)``, scenario draws from the
env-keyed generation keys (``search/loop.py``).
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

__all__ = ["cem_search"]


def cem_search(
    env,
    *,
    generations: int = 8,
    popsize: int = 16,
    elite_frac: float = 0.25,
    seed: int = 0,
    init: Optional[PolicyWeights] = None,
    space: Optional[SearchSpace] = None,
    sigma0: float = 0.25,
    min_sigma: float = 0.02,
    alpha: float = 0.7,
    backend: str = "rollout",
    mesh=None,
    tick_order: str = "fifo",
    anchors=None,
) -> SearchResult:
    """Minimize cost-per-completed-task over ``env`` with CEM.

    ``sigma0`` / ``min_sigma`` are fractions of each dimension's box
    width (``space.hi − space.lo``); ``alpha`` is the distribution
    update momentum.  The result's ``best`` is the best candidate ever
    *evaluated* (never a merely-predicted mean), and ``init_score`` is
    the initial vector's fitness under generation 0's scenarios — the
    "beats a deliberately-bad initial vector" smoke gate compares the
    two directly.

    ``anchors`` warm-starts the search: the given vectors (e.g. the
    hand-tuned arms) replace the first sampled rows of generation 0
    only — same popsize, same compiled program — so the elite refit
    can move straight to the best known region instead of spending
    generations rediscovering it, and the best-evaluated result can
    never lose to an anchor on the training scenarios.
    """
    if popsize < 2:
        raise ValueError(f"popsize must be >= 2, got {popsize}")
    if generations < 1:
        raise ValueError(f"generations must be >= 1, got {generations}")
    anchors = [PolicyWeights(*a).validate() for a in (anchors or [])]
    if len(anchors) > popsize - 1:
        raise ValueError(
            f"{len(anchors)} anchors do not fit a popsize-{popsize} "
            "generation (row 0 is the incumbent mean)"
        )
    n_elite = max(1, int(round(elite_frac * popsize)))
    space = space if space is not None else SearchSpace.default()
    init = (init if init is not None else DEFAULT_WEIGHTS).validate()
    anchor = init.to_array()
    if anchors and bool(space.frozen[4]) and not bool(space.frozen[3]):
        # The risk pair only enters fitness as its product, so an
        # anchor expressed as (risk_weight, rework_cost) re-expresses
        # losslessly in a frozen-rework space as (product / frozen
        # rework, frozen rework) — without this, clipping the frozen
        # dim back to the init value would silently gut the anchor's
        # risk term (e.g. the hand-tuned (1, 50) arm becoming (1, 1)).
        rw = init.rework_cost if init.rework_cost > 0 else 1.0
        anchors = [
            a._replace(
                risk_weight=a.risk_coefficient() / rw, rework_cost=rw
            )
            for a in anchors
        ]
    D = PolicyWeights.DIM
    rng = np.random.default_rng(seed)
    width = space.hi - space.lo
    mean = space.clip(anchor[None], anchor)[0]
    sigma = np.where(space.frozen, 0.0, sigma0 * width)

    best_vec = mean.copy()
    best_score = np.inf
    init_score = None
    trace = []
    for g in range(generations):
        pop = mean[None, :] + sigma[None, :] * rng.standard_normal((popsize, D))
        pop[0] = mean  # the incumbent always re-scores this generation
        if g == 0:
            for i, a in enumerate(anchors):
                pop[1 + i] = a.to_array()
        pop = space.clip(pop, anchor)
        scores = score_population(
            pop, env, g, backend=backend, mesh=mesh, tick_order=tick_order
        )
        if init_score is None:
            init_score = float(scores[0])  # the initial mean, generation 0
        k = int(np.argmin(scores))
        if scores[k] < best_score:
            best_score = float(scores[k])
            best_vec = pop[k].copy()
        elite = pop[np.argsort(scores, kind="stable")[:n_elite]]
        mean = space.clip(
            (alpha * elite.mean(axis=0) + (1 - alpha) * mean)[None], anchor
        )[0]
        sigma = np.where(
            space.frozen,
            0.0,
            np.maximum(
                alpha * elite.std(axis=0) + (1 - alpha) * sigma,
                min_sigma * width,
            ),
        )
        entry = trace_entry(g, pop, scores)
        entry["mean"] = [float(x) for x in mean]
        entry["sigma"] = [float(x) for x in sigma]
        entry["best_so_far"] = float(best_score)
        trace.append(entry)
    return SearchResult(
        best=PolicyWeights.from_array(best_vec),
        best_score=float(best_score),
        init_score=float(init_score),
        trace=trace,
        method="cem",
        seed=seed,
        generations=generations,
        popsize=popsize,
        backend=backend,
    )
