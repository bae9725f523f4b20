"""The search loop's fitness environment and population evaluator.

Port of ``pivot_tpu/search/fitness.py``.  A :class:`SearchEnv` is one
seeded spot-market evaluation world, rendered into torch tensors on one
device:

  * a synthetic cluster + two-stage DAG workload (the spot-survival
    shape, ``experiments/spot.py``), flattened to an
    :class:`~pivot_tpu_torch.parallel.ensemble.EnsembleWorkload`;
  * the seeded :class:`~pivot_tpu_torch.infra.market.MarketSchedule`
    rendered twice — its per-host piecewise hazard trace ``([P], [P, H])``
    feeds the tick body's risk term, and its hazard-drawn
    :class:`~pivot_tpu_torch.infra.faults.ChaosSchedule` preemption plan
    (``spot_schedule``) is converted to the ensemble's fault triple, so
    every candidate lives through the *identical* eviction game (common
    random numbers: between-candidate variance excludes the fault
    scenario);
  * billing constants for the cost-per-completed-task score.

:func:`evaluate_rows` scores a ``[B]`` candidate population of
:class:`~pivot_tpu_torch.search.weights.PolicyWeights` vectors under R
seeded Monte-Carlo rollouts each — ``B × R`` rows through the ensemble's
row runner (``parallel/ensemble/sweeps.py::_run_rows``) as one tick loop
over ``[B·R, ...]`` tensors.  Per-candidate reductions happen on the
host, in float64, in ``pivot_tpu``'s fixed order.

One backend runs: ``"rollout"``.  ``pivot_tpu``'s ``"sharded_rollout"``
(its ``_sharded_fitness_fn`` jit over a replica mesh) has no counterpart
here; asking for it raises ``NotImplementedError`` (ROADMAP.md Queue 1
item 9, sharding).  Neither have ``pivot_tpu``'s jit wrappers
(``_draw_rows``, ``_fitness_rows`` are plain functions: the port's tick
loop runs on the host).

Every candidate rides the score-exponent ``pow`` path
(``parallel/ensemble/libm.py``), so float64 is the CPU parity path: off
the CPU it raises (``libm.require_host``).  The card runs float32.

The public library surface is
:func:`pivot_tpu_torch.sched.sensitivity.evaluate_candidates`; the
optimizers (``search/es.py``, ``search/cem.py``) call it, and it
delegates here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pivot_tpu_torch.ops.kernels import DeviceTopology, resolve_device
from pivot_tpu_torch.parallel.ensemble.draws import _perturbations
from pivot_tpu_torch.parallel.ensemble.sweeps import _run_rows, _tile_rows
from pivot_tpu_torch.search.weights import PolicyWeights

__all__ = [
    "SearchEnv",
    "chaos_to_faults",
    "evaluate_rows",
    "make_search_env",
]

#: Fitness backends of ``pivot_tpu``; the port runs the first.
BACKENDS = ("rollout", "sharded_rollout")


class SearchEnv(NamedTuple):
    """One seeded fitness world, tensor-ready.  Built by
    :func:`make_search_env`; consumed by :func:`evaluate_rows` and the
    optimizers.  The tensor members live on ``device``; the environment
    is immutable across generations, so staging happens once."""

    workload: object           # EnsembleWorkload
    topo: DeviceTopology
    avail0: torch.Tensor       # [H, 4]
    storage_zones: torch.Tensor  # [S] int64
    hazard: Optional[Tuple[torch.Tensor, torch.Tensor]]  # ([P], [P, H])
    # Shared-plan mode: [F] triple (every replica lives the same
    # eviction game).  Redraw mode (``redraw_faults=True``): [R, F]
    # triple, one seeded plan per replica, padded with inert rows.
    faults: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    tick: float
    max_ticks: int
    n_replicas: int
    perturb: float
    rate_per_hour: float
    price_scale: float         # time-mean market price multiplier
    incomplete_penalty: float  # $ per task still pending at the horizon
    seed: int
    n_preemptions: int         # diagnostics: events in the fault plan
    device: torch.device

    @property
    def n_tasks(self) -> int:
        return self.workload.n_tasks


def chaos_to_faults(schedule, cluster):
    """Render a :class:`ChaosSchedule` into the ensemble's fault triple
    ``([F] host index, [F] fail_at, [F] recover_at)`` as numpy arrays.

    Preemptions abort at ``at + lead`` (the warning window is the DES's
    proactive-drain affordance; the estimator has no drain machinery,
    so the abort instant is the fault) and recover after ``duration``
    (None ⇒ never); plain host outages abort at ``at``.  Stragglers and
    partitions have no tick-resolution analog in the estimator and are
    skipped.  Events sort by abort time for a stable layout.  Returns
    None for an event-free plan.
    """
    index = {h.id: i for i, h in enumerate(cluster.hosts)}
    rows = []
    for ev in schedule.events:
        if ev.kind == "preemption":
            fail = ev.at + ev.lead
        elif ev.kind == "host_outage":
            fail = ev.at
        else:
            continue
        rec = fail + ev.duration if ev.duration is not None else np.inf
        rows.append((fail, index[ev.target], rec))
    if not rows:
        return None
    rows.sort()
    host = np.asarray([r[1] for r in rows], dtype=np.int32)
    fail = np.asarray([r[0] for r in rows], dtype=np.float64)
    rec = np.asarray([r[2] for r in rows], dtype=np.float64)
    return host, fail, rec


def make_search_env(
    n_hosts: int = 12,
    seed: int = 3,
    n_apps: int = 8,
    horizon: float = 600.0,
    *,
    tick: float = 5.0,
    max_ticks: Optional[int] = None,
    n_replicas: int = 8,
    perturb: float = 0.1,
    rate_per_hour: float = 1.0,
    incomplete_penalty: float = 1.0,
    arrival_spacing: float = 40.0,
    lead: float = 15.0,
    outage: float = 100.0,
    fault_seed: Optional[int] = None,
    redraw_faults: bool = False,
    cluster=None,
    market=None,
    dtype=torch.float32,
    device="cuda",
    # MarketSchedule.generate knobs — the spot-survival defaults
    # (experiments/spot.py): a large discounted-and-hazardous pool next
    # to calm on-demand zones, so the risk dimension has signal.
    n_segments: int = 6,
    hot_fraction: float = 0.4,
    hot_hazard: float = 2e-2,
    hot_discount: float = 0.65,
    base_hazard: float = 5e-4,
    price_vol: float = 0.15,
) -> SearchEnv:
    """Build one seeded fitness world on ``device`` (the card unless the
    caller asks for the CPU; ``cuda`` without a card raises).  A pure
    function of its arguments: the cluster, workload, market, and
    preemption plan are all derived from ``seed`` (``fault_seed``
    defaults to it), so two calls yield tensor-identical environments.
    Held-out evaluation is just this function at different seeds.

    ``redraw_faults=True`` draws R *independent* seeded preemption
    plans (seeds ``fault_seed + r``) instead of one shared plan:
    candidate b's replica r faces the same plan as candidate b′'s
    replica r, but fitness variance now includes eviction-plan risk.

    ``cluster``/``market`` inject a live world instead of generating a
    synthetic one.  Injecting a cluster skips the global id reset.

    Every evaluation rides the score-exponent ``pow`` path, so
    ``dtype=torch.float64`` runs on the CPU only (``libm.require_host``).
    """
    from pivot_tpu_torch.experiments.spot import synthetic_spot_apps
    from pivot_tpu_torch.infra.market import MarketSchedule
    from pivot_tpu_torch.parallel.ensemble import EnsembleWorkload
    from pivot_tpu_torch.parallel.ensemble.libm import require_host
    from pivot_tpu_torch.utils import reset_ids
    from pivot_tpu_torch.utils.config import ClusterConfig, build_cluster

    require_host(dtype, device, "search scores (score exponents)")
    dev = resolve_device(device)
    if cluster is None:
        reset_ids()  # deterministic host-N ids per (n_hosts, seed)
        cluster = build_cluster(ClusterConfig(n_hosts=n_hosts, seed=seed))
    if market is None:
        market = MarketSchedule.generate(
            cluster.meta, seed=seed, horizon=horizon,
            n_segments=n_segments, hot_fraction=hot_fraction,
            hot_hazard=hot_hazard, hot_discount=hot_discount,
            base_hazard=base_hazard, price_vol=price_vol,
        )
    apps = synthetic_spot_apps(n_apps, seed)
    arrivals = [
        (i * arrival_spacing if arrival_spacing > 0 else 0.0)
        for i in range(len(apps))
    ]
    workload = EnsembleWorkload.from_applications(
        apps, arrivals=arrivals, dtype=dtype, device=dev
    )
    topo = DeviceTopology.from_cluster(cluster, dtype, device=dev)

    def put(x, dt=dtype):
        # Through numpy float64, like ``jnp.asarray(x, dtype)``.
        return torch.as_tensor(np.asarray(x)).to(device=dev, dtype=dt)

    avail0 = put(cluster.availability_matrix())
    storage_zones = put(cluster.storage_zone_vector(), torch.int64)

    host_zones = topo.host_zone.cpu().numpy()
    hz_rows = market.hazard[:, host_zones]  # [P, H]
    hazard = None
    if hz_rows.any():
        hazard = (put(market.times), put(hz_rows))

    fs = seed if fault_seed is None else fault_seed
    faults = None
    n_preempt = 0
    if redraw_faults:
        # One seeded plan per replica, padded to a common event count
        # with inert rows (``fail_at = inf`` never fires inside the
        # horizon, so padding is shape-only).  Replica r's seed is
        # ``fs + r``.
        triples = [
            chaos_to_faults(
                market.spot_schedule(
                    cluster, seed=fs + r, lead=lead, outage=outage,
                    horizon=horizon,
                ),
                cluster,
            )
            for r in range(n_replicas)
        ]
        sizes = [0 if t is None else int(t[0].shape[0]) for t in triples]
        n_preempt = sum(sizes)
        F = max(sizes)
        if F > 0:
            host = np.zeros((n_replicas, F), dtype=np.int32)
            fail = np.full((n_replicas, F), np.inf, dtype=np.float64)
            rec = np.full((n_replicas, F), np.inf, dtype=np.float64)
            for r, t in enumerate(triples):
                if t is None:
                    continue
                k = t[0].shape[0]
                host[r, :k], fail[r, :k], rec[r, :k] = t
            faults = (put(host, torch.int64), put(fail), put(rec))
    else:
        plan = market.spot_schedule(
            cluster, seed=fs, lead=lead, outage=outage, horizon=horizon,
        )
        triple = chaos_to_faults(plan, cluster)
        if triple is not None:
            host, fail, rec = triple
            n_preempt = int(host.shape[0])
            faults = (put(host, torch.int64), put(fail), put(rec))

    # Time-mean price multiplier: the estimator's busy integral is one
    # scalar per rollout (no per-zone attribution), so instance dollars
    # bill at the market's duration-weighted mean multiplier.  The DES
    # harness (experiments/search.py) re-validates winners under the
    # exact piecewise-price integral (billed_instance_cost).
    bounds = np.append(market.times, horizon)
    durs = np.maximum(np.diff(bounds), 0.0)
    total = float(durs.sum())
    price_scale = (
        float((durs * market.price.mean(axis=1)).sum() / total)
        if total > 0 else 1.0
    )

    if max_ticks is None:
        # Horizon plus slack for preemption rework; the tick loop stops
        # once every task is done, so slack is free.
        max_ticks = int(np.ceil(horizon / tick)) * 2

    return SearchEnv(
        workload=workload,
        topo=topo,
        avail0=avail0,
        storage_zones=storage_zones,
        hazard=hazard,
        faults=faults,
        tick=float(tick),
        max_ticks=int(max_ticks),
        n_replicas=int(n_replicas),
        perturb=float(perturb),
        rate_per_hour=float(rate_per_hour),
        price_scale=price_scale,
        incomplete_penalty=float(incomplete_penalty),
        seed=int(seed),
        n_preemptions=n_preempt,
        device=dev,
    )


# -- the population programs --------------------------------------------------


def _draw_rows(key, workload, avail0, storage_zones, n_candidates: int,
               n_replicas: int, perturb: float):
    """[B × R] candidate-major draw rows (runtimes, arrivals, anchors):
    the R Monte-Carlo scenarios drawn ONCE and tiled across candidates
    (paired comparisons — common random numbers)."""
    rt, arr, ra = _perturbations(key, workload, storage_zones, n_replicas,
                                 perturb, avail0.dtype)
    B = n_candidates
    return _tile_rows(rt, B), _tile_rows(arr, B), _tile_rows(ra, B)


def _fitness_rows(
    rt_rows,       # [B·R, T] tiled perturbed runtimes (_draw_rows)
    arr_rows,      # [B·R, T] tiled perturbed arrivals
    ra_rows,       # [B·R, T] int64 tiled root anchors
    warr,          # [B, 5] float64 candidate PolicyWeights matrix (host)
    avail0,        # [H, 4]
    workload,
    topo: DeviceTopology,
    hazard,        # ([P], [P, H]) or None — replica-shared market trace
    faults,        # ([F]×3) shared plan or ([R, F]×3) per-replica plans
    cap_rows,      # [B] float64 capacity scale per candidate, or None
    active_rows,   # [B, T] bool admit mask per candidate, or None
    tick: float,
    max_ticks: int,
    forms: str,
    tick_order: str,
    stats: Optional[dict] = None,
):
    """[B × R] candidate rows to slim per-row metrics.

    Row layout is candidate-major (row b = candidate ``b // R``, replica
    ``b % R``).  Every candidate's exponents ride the ``score_params``
    pow path and its risk product the ``risk_coeff`` channel — the
    hand-tuned anchors included, so candidate deltas never come from
    path divergence.  The weights and ``cap_rows`` are cast to the
    environment's dtype before ``warr[:, 3] * warr[:, 4]`` and the
    capacity multiply, as ``pivot_tpu`` casts them.  ``cap_rows`` /
    ``active_rows`` are the model-predictive planner's action channels.
    Returns ``(egress, instance_hours, n_unfinished, makespan)``, each
    ``[B × R]``, on the device; ``stats`` as in ``_run_rows``.
    """
    dtype, dev = avail0.dtype, avail0.device
    B = warr.shape[0]
    n_rows = rt_rows.shape[0]
    R = n_rows // B
    # graftcheck: ignore[host-sync] -- warr, cap_rows and active_rows are host operands, staged once a call
    warr = torch.as_tensor(np.asarray(warr, np.float64)).to(dev, dtype)
    avail_rows = avail0.expand((B * R,) + tuple(avail0.shape))
    if cap_rows is not None:
        # graftcheck: ignore[host-sync] -- a host operand, staged once a call
        scale = torch.as_tensor(np.asarray(cap_rows, np.float64)).to(
            dev, dtype).repeat_interleave(R)
        avail_rows = avail_rows * scale[:, None, None]
    # graftcheck: ignore[host-sync] -- a host operand, staged once a call
    active = (
        torch.as_tensor(np.asarray(active_rows, bool)).to(dev)
        .repeat_interleave(R, 0)
        if active_rows is not None else None
    )
    sp = warr[:, :3].repeat_interleave(R, 0)  # [B·R, 3] exponents
    # The risk channel rides only when the environment has a hazard
    # trace — without one the term is disengaged for every candidate.
    rc = (
        (warr[:, 3] * warr[:, 4]).repeat_interleave(R)  # [B·R] risk coeff
        if hazard is not None else None
    )
    fault_rows = None
    totals = None
    if faults is not None:
        fh, ff, fr = faults
        F = fh.shape[-1]
        if fh.dim() == 2:
            # Per-replica redrawn plans [R, F]: tile candidate-major to
            # match the draw rows — row b·R + r gets replica r's plan
            # for EVERY candidate b, so comparisons stay paired.
            fault_rows = (
                _tile_rows(fh, B), _tile_rows(ff, B), _tile_rows(fr, B)
            )
        else:
            fault_rows = tuple(x.expand(B * R, F) for x in (fh, ff, fr))
        totals = avail_rows
    res = _run_rows(
        avail_rows, rt_rows, arr_rows, ra_rows,
        workload, topo, tick, max_ticks, None,
        "cost-aware", False, False,
        faults=fault_rows,
        totals=totals,
        score_params=sp,
        risk_coeff=rc,
        active=active,
        hazard=hazard,
        forms=forms,
        tick_order=tick_order,
        stats=stats,
    )
    return (
        res.egress_cost, res.instance_hours, res.n_unfinished, res.makespan
    )


def evaluate_rows(
    weights,
    env: SearchEnv,
    *,
    key=None,
    backend: str = "rollout",
    mesh=None,
    forms: Optional[str] = None,
    tick_order: str = "fifo",
    cap_rows=None,
    active_rows=None,
) -> Tuple[np.ndarray, dict]:
    """Score a candidate population under ``env``.

    ``weights`` is a ``[B, 5]`` matrix (``PolicyWeights.stack``) or a
    sequence of :class:`PolicyWeights`.  Returns ``(scores [B],
    details)`` where ``scores[b]`` is candidate b's mean
    cost-per-completed-task over the R paired rollouts (lower is
    better; incomplete rollouts pay ``env.incomplete_penalty`` per
    pending task) and ``details`` carries the per-candidate metric
    breakdown.  ``key`` (threefry key data, ``prng.PRNGKey``) defaults
    to ``PRNGKey(env.seed)``; optimizers fold the generation index in
    so draws refresh while staying seed-replayable.

    ``backend="sharded_rollout"`` raises ``NotImplementedError``: the
    sharded backend is ROADMAP.md Queue 1 item 9 (``mesh`` is accepted
    for the same call signature and unused).

    ``cap_rows`` ([B], capacity scale) and ``active_rows`` ([B, T]
    bool, admit masks) attach per-candidate *actions* to the rollout —
    the model-predictive planner's channels.  Shed tasks (mask False)
    never run and don't bill the incomplete penalty; scores divide by
    each candidate's admitted-and-completed count.
    """
    from pivot_tpu_torch.parallel.ensemble import prng
    from pivot_tpu_torch.parallel.ensemble.state import _resolve_forms

    if backend not in BACKENDS:
        raise ValueError(
            f"unknown fitness backend {backend!r} — one of {BACKENDS}"
        )
    if backend == "sharded_rollout":
        raise NotImplementedError(
            "the 'sharded_rollout' fitness backend is not ported to "
            "pivot_tpu_torch yet (ROADMAP.md Queue 1 item 9, sharding); "
            "use backend='rollout'")
    warr = (
        np.asarray(weights, dtype=np.float64)
        if isinstance(weights, np.ndarray)
        else PolicyWeights.stack(list(weights))
    )
    if warr.ndim != 2 or warr.shape[1] != PolicyWeights.DIM:
        raise ValueError(
            f"weights must be [B, {PolicyWeights.DIM}], got {warr.shape}"
        )
    if not np.all(np.isfinite(warr)):
        raise ValueError("candidate weights must be finite")
    B, R = warr.shape[0], env.n_replicas
    if cap_rows is not None:
        cap_rows = np.asarray(cap_rows, np.float64)
        if cap_rows.shape != (B,):
            raise ValueError(
                f"cap_rows must be [B={B}], got {cap_rows.shape}"
            )
        if not np.all(np.isfinite(cap_rows)) or np.any(cap_rows < 0):
            raise ValueError("cap_rows must be finite and non-negative")
    if active_rows is not None:
        active_rows = np.asarray(active_rows, dtype=bool)
        if active_rows.shape != (B, env.n_tasks):
            raise ValueError(
                f"active_rows must be [B={B}, T={env.n_tasks}], "
                f"got {active_rows.shape}"
            )
    if key is None:
        key = prng.PRNGKey(env.seed)
    forms = _resolve_forms(forms)
    rt_rows, arr_rows, ra_rows = _draw_rows(
        key, env.workload, env.avail0, env.storage_zones,
        n_candidates=B, n_replicas=R, perturb=env.perturb,
    )
    egress, ihours, unfin, makespan = _fitness_rows(
        rt_rows, arr_rows, ra_rows, warr, env.avail0, env.workload,
        env.topo, env.hazard, env.faults, cap_rows, active_rows,
        tick=env.tick, max_ticks=env.max_ticks, forms=forms,
        tick_order=tick_order,
    )

    # Host-side per-candidate reduction in ``pivot_tpu``'s fixed order
    # (the row loop returns per-row scalars).
    def host(x):
        return x.cpu().numpy().astype(np.float64).reshape(B, R)

    egress, ihours, unfin, makespan = (host(x) for x in (
        egress, ihours, unfin, makespan))
    T = env.n_tasks
    # Shed (inactive) tasks never run: they are neither unfinished nor
    # completed, so the divisor is each candidate's ADMITTED count.
    admitted = (
        np.broadcast_to(
            active_rows.sum(axis=1).astype(np.float64)[:, None], (B, R)
        )
        if active_rows is not None else float(T)
    )
    completed = admitted - unfin
    cost = (
        ihours * env.rate_per_hour * env.price_scale
        + egress
        + env.incomplete_penalty * unfin
    )
    per_row = np.where(completed > 0, cost / np.maximum(completed, 1.0),
                       np.inf)
    scores = per_row.mean(axis=1)
    details = {
        "scores": scores,
        "egress": egress.mean(axis=1),
        "instance_cost": (
            ihours * env.rate_per_hour * env.price_scale
        ).mean(axis=1),
        "unfinished": unfin.mean(axis=1),
        "makespan": makespan.mean(axis=1),
        "completed": completed.mean(axis=1),
        "admitted": np.broadcast_to(admitted, (B, R)).mean(axis=1),
        "n_rows": B * R,
        "backend": backend,
    }
    return scores, details
