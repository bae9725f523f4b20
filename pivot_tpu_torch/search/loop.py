"""Shared search-loop scaffolding: result type, key discipline, tracing.

Port of ``pivot_tpu/search/loop.py``.  The scenario keys are the port's
threefry twin (``parallel/ensemble/prng.py``): ``uint32[2]`` key data,
bit-equal to ``jax.random``'s on the same seed and generation.

Both optimizers (``search/es.py``, ``search/cem.py``) drive the same
fitness surface — :func:`pivot_tpu_torch.sched.sensitivity.evaluate_candidates`
over a :class:`~pivot_tpu_torch.search.fitness.SearchEnv` — and share the
replay contract this module pins down:

  * **population sampling** comes from one ``np.random.default_rng(seed)``
    owned by the optimizer;
  * **scenario draws** for generation ``g`` come from
    ``fold_in(PRNGKey(env.seed), g)`` — a pure function of the
    environment and the generation index, NOT of the optimizer seed, so
    two methods (or two seeds of one method) face the identical
    scenario sequence and their traces compare paired;
  * the **trace** records every generation's population statistics and
    the best-so-far vector, so "same seed ⇒ identical winning weight
    vector and identical generation-by-generation fitness trace" is a
    plain equality test across runs (``tests/test_torch_search.py``).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from pivot_tpu_torch.search.weights import PolicyWeights

__all__ = ["SearchResult", "generation_key", "score_population",
           "trace_entry"]


class SearchResult(NamedTuple):
    """Outcome of one search run (JSON-serializable via :meth:`to_dict`)."""

    best: PolicyWeights          # best candidate ever evaluated
    best_score: float            # its fitness (cost per completed task)
    init_score: float            # the initial vector's fitness, generation 0
    trace: List[dict]            # per-generation record
    method: str
    seed: int
    generations: int
    popsize: int
    backend: str

    def to_dict(self) -> dict:
        return {
            "method": self.method,
            "seed": self.seed,
            "generations": self.generations,
            "popsize": self.popsize,
            "backend": self.backend,
            "best_weights": dict(zip(PolicyWeights.NAMES, self.best)),
            "best_score": self.best_score,
            "init_score": self.init_score,
            "trace": self.trace,
        }


def generation_key(env, gen: int):
    """Scenario key for generation ``gen`` — env-seeded, optimizer-blind
    (see the module docstring): ``fold_in(PRNGKey(env.seed), gen)``."""
    from pivot_tpu_torch.parallel.ensemble import prng

    return prng.fold_in(prng.PRNGKey(env.seed), gen)


def score_population(
    pop: np.ndarray,
    env,
    gen: int,
    *,
    backend: str = "rollout",
    mesh=None,
    tick_order: str = "fifo",
) -> np.ndarray:
    """One generation's fitness call: the [B] population through the
    library evaluator (``sched.sensitivity.evaluate_candidates``) under
    this generation's scenario key — one row batch of the rollout."""
    from pivot_tpu_torch.sched.sensitivity import evaluate_candidates

    return np.asarray(
        evaluate_candidates(
            pop, env, key=generation_key(env, gen), backend=backend,
            mesh=mesh, tick_order=tick_order,
        ),
        dtype=np.float64,
    )


def trace_entry(gen: int, pop: np.ndarray, scores: np.ndarray) -> dict:
    """One generation's trace record — plain floats/lists so traces are
    JSON round-trippable and directly comparable across runs."""
    k = int(np.argmin(scores))
    return {
        "gen": gen,
        "pop_best_score": float(scores[k]),
        "pop_best": [float(x) for x in pop[k]],
        "pop_mean_score": float(np.mean(scores)),
        "pop_worst_score": float(np.max(scores)),
    }
