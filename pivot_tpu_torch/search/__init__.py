"""Policy search: learned scheduling weights with a regret oracle.

Port of ``pivot_tpu/search/__init__.py``:

  * :mod:`~pivot_tpu_torch.search.weights` — :class:`PolicyWeights`, the
    typed scoring-weight vector every backend accepts;
  * :mod:`~pivot_tpu_torch.search.fitness` — :class:`SearchEnv`, a seeded
    spot-market evaluation environment, and the population evaluator
    behind ``pivot_tpu_torch.sched.sensitivity.evaluate_candidates``: a
    [B] candidate population × R seeded Monte-Carlo rollouts as one row
    batch of the ensemble rollout, on the card by default;
  * :mod:`~pivot_tpu_torch.search.es` / :mod:`~pivot_tpu_torch.search.cem`
    — evolution-strategies and cross-entropy-method optimizers over that
    evaluator, seed-replayable end to end;
  * :mod:`~pivot_tpu_torch.search.oracle` — the exact small-instance
    branch-and-bound solver, so "learned beats hand-tuned" is reported as
    regret against an optimum.

The ``"sharded_rollout"`` fitness backend splits the population's rows
over a replica mesh (``parallel/mesh.py``) with the ``"rollout"``
backend's scores bit for bit; the model-predictive controller
(``pivot_tpu_torch.mpc``) scores its action menus through this
evaluator.

The package ``__init__`` stays import-light on purpose: ``sched``
imports :class:`PolicyWeights` from here, so the optimizer/fitness stack
loads lazily via PEP 562 — importing ``pivot_tpu_torch.search`` loads
only :mod:`weights`.
"""

from __future__ import annotations

from pivot_tpu_torch.search.weights import (  # noqa: F401
    DEFAULT_WEIGHTS,
    PolicyWeights,
    SearchSpace,
)

__all__ = [
    "DEFAULT_WEIGHTS",
    "PolicyWeights",
    "SearchSpace",
    "SearchEnv",
    "make_search_env",
    "evaluate_candidates",
    "cem_search",
    "es_search",
    "OracleInstance",
    "solve_instance",
    "placement_objective",
    "greedy_placement",
    "regret",
]

#: Lazily-resolved public names → defining submodule.
#: ``evaluate_candidates`` resolves through ``sched.sensitivity``, so the
#: two surfaces are one function.
_LAZY = {
    "SearchEnv": "pivot_tpu_torch.search.fitness",
    "make_search_env": "pivot_tpu_torch.search.fitness",
    "evaluate_candidates": "pivot_tpu_torch.sched.sensitivity",
    "cem_search": "pivot_tpu_torch.search.cem",
    "es_search": "pivot_tpu_torch.search.es",
    "OracleInstance": "pivot_tpu_torch.search.oracle",
    "solve_instance": "pivot_tpu_torch.search.oracle",
    "placement_objective": "pivot_tpu_torch.search.oracle",
    "greedy_placement": "pivot_tpu_torch.search.oracle",
    "regret": "pivot_tpu_torch.search.oracle",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
