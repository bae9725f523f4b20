"""Policy-search experiment harness: learn, hold out, report regret.

Port of ``pivot_tpu/experiments/search.py``.  The ``search`` CLI
(``python -m pivot_tpu_torch.experiments.cli search``) drives this
module; its environments live on ``device`` (the card by default) in
``dtype`` (float32 there; float64 is the CPU parity path).  One run:

  1. **Train** — build the seeded train :class:`SearchEnv` (market
     hazards + the hazard-drawn preemption plan) and run the chosen
     optimizer (:func:`~pivot_tpu_torch.search.cem.cem_search` /
     :func:`~pivot_tpu_torch.search.es.es_search`); every generation scores
     its whole candidate population as one row batch of the ensemble
     rollout.
  2. **Hold out** — rebuild fresh environments at unseen seeds (new
     market draw, new workload, new preemption plan) and score the
     learned vector against the hand-tuned arms through the SAME
     evaluator: the headline ``learned_beats_hand_tuned`` compares
     mean cost-per-completed-task over the held-out seeds.
  3. **Regret** — on a small single-wave instance the branch-and-bound
     oracle can solve exactly (``search/oracle.py``), report each
     arm's greedy-placement objective as regret against the proven
     optimum, not just as a delta between heuristics.
  4. optionally **DES-validate** — play learned vs hand-tuned through
     the exact simulator (``experiments/spot.py`` with ``weights=``)
     under the held-out market, billing the true piecewise price
     integral.

Everything is seeded and replayable: same config ⇒ bit-identical
report (``chip_smoke.py`` phase 8 runs the committed
``data/search/ci_seed.json`` config twice and compares).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from pivot_tpu_torch.search.weights import DEFAULT_WEIGHTS, PolicyWeights

__all__ = [
    "BAD_INIT",
    "HAND_TUNED_ARMS",
    "run_search_experiment",
    "small_oracle_instance",
]

#: The hand-tuned reference arms every learned vector must beat —
#: today's shipped configurations as weight vectors: the reference
#: cost-aware score, and the PR-9 risk-aware arm at its bench knobs.
HAND_TUNED_ARMS: Dict[str, PolicyWeights] = {
    "hand_tuned_default": DEFAULT_WEIGHTS,
    "hand_tuned_risk_aware": PolicyWeights(risk_weight=1.0, rework_cost=50.0),
}

#: The deliberately-bad initial vector the smoke gate starts from: all
#: score exponents zeroed (every host scores 1.0 ⇒ the argmin
#: degenerates to host 0 — maximal crowding, egress-blind) and the risk
#: term off under a hazardous market.  Any competent sample beats it.
BAD_INIT = PolicyWeights(w_cost=0.0, w_bw=0.0, w_norm=0.0, risk_weight=0.0)


def small_oracle_instance(seed: int, *, n_hosts: int = 6, n_apps: int = 4,
                          hazard_scale: float = 10.0,
                          tightness: float = 1.6, device="cuda",
                          dtype=torch.float32):
    """A small, exactly-solvable consumer wave derived from the seeded
    spot world: the two-stage DAGs' producer instances land round-robin
    across hosts (a fixed, placement-history-like context), the
    consumer wave is the decision to optimize, and the hazard row is
    the market's t=0 per-host trace (scaled so the risk dimension has
    bite at wave scale).  ``tightness`` shrinks each host's snapshot to
    ~``tightness / H`` of the wave's total demand so capacity actually
    binds (a slack wave makes every arm trivially optimal and the
    regret report says nothing).  The environment lives on ``device`` in
    ``dtype``.  Returns ``(instance, env)``."""
    from pivot_tpu_torch.search.fitness import make_search_env
    from pivot_tpu_torch.search.oracle import instance_from_wave

    env = make_search_env(
        n_hosts=n_hosts, seed=seed, n_apps=n_apps, horizon=200.0,
        n_replicas=2, device=device, dtype=dtype,
    )
    wl = env.workload
    group_of = wl.group_of.cpu().numpy()
    pred = wl.pred_group.cpu().numpy()
    # Producer groups: no predecessors.  Consumers: everything else.
    is_root_group = pred.sum(axis=1) == 0
    producer_mask = is_root_group[group_of]
    T = wl.n_tasks
    pp = np.full(T, -1, dtype=np.int64)
    prod_idx = np.nonzero(producer_mask)[0]
    pp[prod_idx] = np.arange(len(prod_idx)) % n_hosts
    consumer_mask = ~producer_mask
    hazard = None
    if env.hazard is not None:
        hazard = hazard_scale * env.hazard[1][0].cpu().numpy()  # t=0 row
    avail = env.avail0.cpu().numpy().astype(np.float64)
    dem = wl.demands.cpu().numpy().astype(np.float64)[consumer_mask]
    cap = dem.sum(axis=0) * (tightness / n_hosts)
    # Resources the wave never asks for keep the snapshot's value (a
    # zeroed row would fail the greedy arm's strict fit on 0 > 0).
    binds = cap > 0
    avail[:, binds] = np.minimum(avail[:, binds], cap[binds][None, :])
    inst = instance_from_wave(
        wl, env.topo, avail, pp, consumer_mask,
        hazard=hazard, weights=DEFAULT_WEIGHTS,
    )
    return inst, env


def _holdout_scores(
    arms: Dict[str, PolicyWeights],
    seeds: List[int],
    env_kw: dict,
) -> Dict[str, dict]:
    """Each arm's mean cost-per-completed-task over fresh environments
    at the held-out seeds — one population dispatch per seed (all arms
    ride one batch: paired comparisons).  Always the unsharded backend:
    the tiny fixed-arm batch (3 × R rows) rarely divides a mesh and
    never amortizes one."""
    from pivot_tpu_torch.search.fitness import make_search_env
    from pivot_tpu_torch.sched.sensitivity import evaluate_candidates

    names = list(arms)
    pop = PolicyWeights.stack([arms[n] for n in names])
    per_seed = {n: [] for n in names}
    for s in seeds:
        env = make_search_env(seed=s, **env_kw)
        scores = evaluate_candidates(pop, env)
        for n, sc in zip(names, scores):
            per_seed[n].append(float(sc))
    return {
        n: {
            "mean_cost_per_task": float(np.mean(per_seed[n])),
            "per_seed": per_seed[n],
        }
        for n in names
    }


def run_search_experiment(
    *,
    method: str = "cem",
    generations: int = 6,
    popsize: int = 12,
    seed: int = 5,
    n_hosts: int = 12,
    n_apps: int = 8,
    horizon: float = 600.0,
    n_replicas: int = 8,
    holdout: int = 2,
    backend: str = "rollout",
    mesh=None,
    bad_init: bool = False,
    oracle: bool = True,
    des_validate: bool = False,
    search_kw: Optional[dict] = None,
    device="cuda",
    dtype=torch.float32,
) -> dict:
    """Run the full learn → hold out → regret pipeline; returns the
    JSON-serializable report (see the module docstring).  The train and
    held-out environments and the oracle's instance live on ``device`` in
    ``dtype``."""
    from pivot_tpu_torch.search.cem import cem_search
    from pivot_tpu_torch.search.es import es_search
    from pivot_tpu_torch.search.fitness import make_search_env

    if method not in ("cem", "es"):
        raise ValueError(f"method must be cem|es, got {method!r}")
    env_kw = dict(
        n_hosts=n_hosts, n_apps=n_apps, horizon=horizon,
        n_replicas=n_replicas, device=device, dtype=dtype,
    )
    train_env = make_search_env(seed=seed, **env_kw)
    init = BAD_INIT if bad_init else DEFAULT_WEIGHTS
    search_fn = cem_search if method == "cem" else es_search
    search_kw = dict(search_kw or {})
    if method == "cem" and not bad_init:
        # Warm-start from the hand-tuned arms (generation-0 anchor
        # rows): the search's job is to BEAT the best known vectors,
        # not to rediscover them from scratch; the bad-init smoke mode
        # deliberately skips this so the gate proves real search
        # progress.
        search_kw.setdefault("anchors", list(HAND_TUNED_ARMS.values()))
    result = search_fn(
        train_env, generations=generations, popsize=popsize, seed=seed,
        init=init, backend=backend, mesh=mesh, **search_kw,
    )
    learned = result.best

    holdout_seeds = [seed + 1 + i for i in range(holdout)]
    arms = dict(HAND_TUNED_ARMS)
    arms["learned"] = learned
    holdout_report = (
        _holdout_scores(arms, holdout_seeds, env_kw)
        if holdout > 0 else {}
    )
    report = {
        "config": {
            "method": method, "generations": generations,
            "popsize": popsize, "seed": seed, "n_hosts": n_hosts,
            "n_apps": n_apps, "horizon": horizon,
            "n_replicas": n_replicas, "holdout": holdout,
            "backend": backend, "bad_init": bad_init,
        },
        "search": result.to_dict(),
        "beats_bad_init": bool(result.best_score < result.init_score),
        "holdout_seeds": holdout_seeds,
        "holdout": holdout_report,
    }
    if holdout_report:
        hand = {
            n: holdout_report[n]["mean_cost_per_task"]
            for n in HAND_TUNED_ARMS
        }
        best_hand = min(hand, key=hand.get)
        report["best_hand_tuned_arm"] = best_hand
        report["learned_beats_hand_tuned"] = bool(
            holdout_report["learned"]["mean_cost_per_task"] < hand[best_hand]
        )

    if oracle:
        from pivot_tpu_torch.search.oracle import (
            greedy_placement,
            placement_objective,
            solve_instance,
        )

        inst, _ = small_oracle_instance(seed + 101, n_hosts=min(n_hosts, 6),
                                        device=device, dtype=dtype)
        opt_p, opt_obj, stats = solve_instance(inst)
        regrets = {}
        for name, w in arms.items():
            p = greedy_placement(inst, w)
            regrets[name] = float(placement_objective(inst, p) - opt_obj)
        report["oracle"] = {
            "optimum_objective": float(opt_obj),
            "optimum_placement": [int(h) for h in opt_p],
            "nodes": stats["nodes"],
            "n_tasks": inst.n_tasks,
            "n_hosts": inst.n_hosts,
            "regret": regrets,
        }

    if des_validate and holdout:
        from pivot_tpu_torch.experiments.spot import run_spot_arm, spot_market

        s = holdout_seeds[0]
        market = spot_market(n_hosts, seed=s, horizon=horizon)
        des = {}
        for name, w in arms.items():
            r = run_spot_arm(
                market, n_hosts=n_hosts, seed=s, n_apps=n_apps,
                weights=w, proactive=True,
            )
            des[name] = {
                "cost_per_completed_task": r["cost_per_completed_task"],
                "dead_letter_rate": r["dead_letter_rate"],
                "audit_violations": r["audit_violations"],
            }
        report["des_validation"] = des
    return report


def load_config(path: str) -> dict:
    """Read a committed search config (the replay anchor,
    ``data/search/ci_seed.json``) into :func:`run_search_experiment`
    keyword arguments."""
    with open(path) as fh:
        cfg = json.load(fh)
    allowed = {
        "method", "generations", "popsize", "seed", "n_hosts", "n_apps",
        "horizon", "n_replicas", "holdout", "backend", "bad_init",
        "oracle", "des_validate",
    }
    unknown = set(cfg) - allowed
    if unknown:
        raise ValueError(
            f"unknown search-config keys {sorted(unknown)} in {path}"
        )
    return cfg
