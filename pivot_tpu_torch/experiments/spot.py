"""Spot-market survival harness: one seeded arm of the eviction game.

Port of ``pivot_tpu/experiments/spot.py``, a copy with the import paths
rewritten: a CPU DES path in both packages (the cost-aware numpy policy,
no device work).  The search's DES validation
(``experiments/search.py``) and ``python -m
pivot_tpu_torch.tools.market_replay`` drive it.  It plays the same seeded
world twice:

  * **hazard-blind** (``risk_weight=0``, ``proactive=False``) — the
    pre-market scheduler: cost-aware placement packs work onto the
    cheapest zones, which under a spot market are exactly the most
    evictable ones; preemptions are discovered reactively when the abort
    kills the host, and every lost execution re-enters the retry loop.
  * **risk-aware + proactive** (``risk_weight>0``, ``proactive=True``) —
    placement prices eviction risk into every score
    (``policies.resolve_risk``), and the preemption *warning* triggers
    the drain → migrate → restart handler
    (``GlobalScheduler.on_preempt_warning``): queued tasks re-decide off
    the doomed host, provably-doomed residents restart immediately
    instead of burning the lead window.

Both arms run under the IDENTICAL :class:`MarketSchedule` and the
identical hazard-drawn fault plan (``MarketSchedule.spot_schedule`` is a
pure function of cluster topology, market, and seed — placement cannot
perturb it), so the delta is attributable to the survival machinery
alone.  The report's headline metrics are **cost per completed task**
(price-trace-integrated instance cost + metered egress, over finished
tasks) and the **dead-letter rate** (Bamboo / SpotServe's collapse axis,
PAPERS.md).

Everything is seeded and replayable: same (market, seed, arm knobs) ⇒
bit-identical fault log, task outcomes, and meter snapshot —
``python -m pivot_tpu_torch.tools.market_replay diff`` holds it to that.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from pivot_tpu_torch.infra.market import MarketSchedule

__all__ = ["run_spot_arm", "spot_market", "synthetic_spot_apps"]


def spot_market(
    n_hosts: int,
    seed: int,
    horizon: float = 600.0,
    *,
    n_segments: int = 6,
    hot_fraction: float = 0.4,
    hot_hazard: float = 2e-2,
    hot_discount: float = 0.65,
    base_hazard: float = 5e-4,
    price_vol: float = 0.15,
) -> MarketSchedule:
    """The experiment's seeded market, drawn against the same synthetic
    cluster :func:`run_spot_arm` builds (``utils.config.build_cluster``
    is deterministic per (n_hosts, seed), so the zone catalog matches by
    construction).  Defaults bias toward the adversarial shape: a large
    discounted-and-hazardous spot pool next to calm on-demand zones."""
    from pivot_tpu_torch.utils import reset_ids
    from pivot_tpu_torch.utils.config import ClusterConfig, build_cluster

    reset_ids()
    cluster = build_cluster(ClusterConfig(n_hosts=n_hosts, seed=seed))
    return MarketSchedule.generate(
        cluster.meta,
        seed=seed,
        horizon=horizon,
        n_segments=n_segments,
        hot_fraction=hot_fraction,
        hot_hazard=hot_hazard,
        hot_discount=hot_discount,
        base_hazard=base_hazard,
        price_vol=price_vol,
    )


def synthetic_spot_apps(n_apps: int, seed: int) -> List:
    """Seeded two-stage DAGs (same shape as the chaos-replay workload:
    a fan-out source feeding one sink) — long enough that a mid-run
    preemption costs real rework, numerous enough that placement spreads
    across zones."""
    from pivot_tpu_torch.workload import Application, TaskGroup

    rng = np.random.default_rng(seed)
    apps = []
    for i in range(n_apps):
        src = TaskGroup(
            "src", cpus=4, mem=256, runtime=float(rng.uniform(60, 140)),
            output_size=float(rng.uniform(100, 400)),
            instances=int(rng.integers(2, 5)),
        )
        dst = TaskGroup(
            "dst", cpus=4, mem=256, runtime=float(rng.uniform(40, 80)),
            dependencies=["src"],
        )
        apps.append(Application(f"spot-app-{i}", [src, dst]))
    return apps


def run_spot_arm(
    market: MarketSchedule,
    *,
    n_hosts: int = 12,
    seed: int = 0,
    n_apps: int = 10,
    risk_weight: float = 0.0,
    rework_cost: float = 1.0,
    proactive: bool = False,
    lead: float = 15.0,
    outage: float = 100.0,
    horizon: Optional[float] = None,
    max_retries: int = 1,
    breaker_k: Optional[int] = None,
    interval: float = 5.0,
    rate_per_hour: float = 1.0,
    fault_seed: Optional[int] = None,
    arrival_spacing: float = 40.0,
    weights=None,
) -> dict:
    """Run ONE arm of the spot-survival game to completion and report.

    Builds the seeded synthetic world (cluster, cost-aware CPU policy,
    retry governor), attaches ``market`` to the scheduler (time-varying
    cost matrix + per-tick hazard vector), draws the hazard-proportional
    preemption plan (``fault_seed`` defaults to ``seed`` — pass the same
    value to every arm so they face the identical fault plan), replays
    it through a :class:`FaultInjector`, and drives the workload dry.

    Returns a JSON-serializable report: the fault log, meter summary,
    audit violations (conservation + cluster + meter, rework included),
    and the headline ``cost_per_completed_task`` / ``dead_letter_rate``.
    """
    from pivot_tpu_torch.infra.audit import (
        audit_cluster,
        audit_conservation,
        audit_meter,
    )
    from pivot_tpu_torch.infra.faults import FaultInjector
    from pivot_tpu_torch.infra.meter import Meter
    from pivot_tpu_torch.sched import (
        GlobalScheduler,
        HostCircuitBreaker,
        RetryPolicy,
    )
    from pivot_tpu_torch.sched.policies import CostAwarePolicy
    from pivot_tpu_torch.utils import reset_ids
    from pivot_tpu_torch.utils.config import ClusterConfig, build_cluster

    from pivot_tpu_torch.des import Environment

    reset_ids()  # host-N ids must match across arms and replays
    proto = build_cluster(ClusterConfig(n_hosts=n_hosts, seed=seed))
    env = Environment()
    meter = Meter(env, proto.meta)
    # Clone with the meter attached so every host bills its busy
    # intervals (a post-hoc ``cluster.meter = ...`` never reaches the
    # already-constructed hosts — the instance-cost integral would read
    # an empty ledger).
    cluster = proto.clone(env, meter)
    # ``weights`` (a search-learned PolicyWeights vector) supersedes the
    # legacy risk-knob pair — the round-16 DES validation path: play a
    # learned vector through the exact simulator under the same market.
    if weights is not None:
        policy = CostAwarePolicy(weights=weights)
        # The resolved vector (resolve_weights coerces array-likes), not
        # the raw argument — the report below reads its _fields.
        weights = policy.weights
        risk_weight = policy.risk_weight
        rework_cost = policy.rework_cost
    else:
        policy = CostAwarePolicy(
            risk_weight=risk_weight, rework_cost=rework_cost
        )
    scheduler = GlobalScheduler(
        cluster.env,
        cluster,
        policy,
        interval=interval,
        seed=seed,
        meter=meter,
        retry=RetryPolicy(max_retries=max_retries, base=1.0, seed=seed),
        breaker=(
            HostCircuitBreaker(k=breaker_k, cooldown=60.0)
            if breaker_k else None
        ),
        market=market,
    )
    cluster.start()
    scheduler.start()

    injector = FaultInjector(cluster, seed=seed)
    spot_plan = market.spot_schedule(
        cluster,
        seed=seed if fault_seed is None else fault_seed,
        lead=lead,
        outage=outage,
        horizon=horizon,
    )
    injector.apply_schedule(spot_plan)
    if proactive:
        scheduler.enable_proactive_drain(injector)

    # Staggered arrivals: app i enters at i × spacing, so the workload
    # overlaps the whole price/hazard trace instead of draining before
    # the first preemption fires (the reactive arm must actually live
    # through the market it is blind to).
    apps = synthetic_spot_apps(n_apps, seed)
    for i, app in enumerate(apps):
        if i == 0 or arrival_spacing <= 0:
            scheduler.submit(app)
        else:
            env.schedule_callback_at(
                i * arrival_spacing,
                (lambda a: (lambda: scheduler.submit(a)))(app),
            )
    scheduler.stop()
    cluster.env.run()

    tasks = [t for a in apps for g in a.groups for t in g.tasks]
    # Rate denominator: the SPEC's task count, not the materialized one —
    # a failed app cancels downstream groups before their tasks exist,
    # and a shrinking denominator would flatter the arm that failed.
    n_tasks = sum(g.instances for a in apps for g in a.groups)
    n_done = sum(t.is_finished for t in tasks)
    n_dead = len(scheduler.dead_letters)
    instance_cost = market.billed_instance_cost(
        meter, cluster, rate_per_hour=rate_per_hour, end=cluster.env.now
    )
    summary = meter.summary()
    summary.pop("wall_clock", None)  # the one non-deterministic field
    egress = summary["egress_cost"]
    violations = (
        audit_cluster(cluster)
        + audit_conservation(scheduler, apps)
        + audit_meter(meter)
    )
    return {
        "arm": {
            "risk_weight": risk_weight,
            "rework_cost": rework_cost,
            **(
                {"weights": {k: float(v) for k, v in
                             zip(type(weights)._fields, weights)}}
                if weights is not None else {}
            ),
            "proactive": proactive,
            "n_hosts": n_hosts,
            "seed": seed,
            "n_apps": n_apps,
            "max_retries": max_retries,
            "lead": lead,
            "outage": outage,
        },
        "n_preemptions": len(spot_plan),
        "fault_log": [[t, target, ev] for t, target, ev in injector.log],
        "n_tasks": n_tasks,
        "n_completed_tasks": n_done,
        "n_dead_letters": n_dead,
        "dead_letter_rate": (n_dead / n_tasks) if n_tasks else 0.0,
        "finished_apps": sum(a.is_finished for a in apps),
        "failed_apps": sum(a.failed for a in apps),
        "n_migrated": scheduler.n_migrated,
        "n_proactive_restarts": scheduler.n_proactive_restarts,
        "instance_cost": instance_cost,
        "egress_cost": egress,
        "total_cost": instance_cost + egress,
        # None (not inf) when nothing completed: json.dump would emit the
        # non-standard ``Infinity`` token and break strict JSON consumers.
        "cost_per_completed_task": (
            (instance_cost + egress) / n_done if n_done else None
        ),
        "rework_seconds": meter.rework_seconds,
        "makespan": float(cluster.env.now),
        "meter": summary,
        "audit_violations": violations,
    }
