"""Calibration harness: the ensemble estimator against the exact DES.

Port of ``pivot_tpu/experiments/calibrate.py``.  The Monte-Carlo rollout
(``pivot_tpu_torch.parallel.ensemble``) simplifies the discrete-event
simulation: fixed-tick time, zone-level transfer estimates, an optional
backlog-pipe congestion model instead of per-route service.  This module
runs the same (trace, cluster, policy) through both engines and reports
their metrics side by side with relative errors, for the static,
congested, realtime and host-pair transfer models
(:func:`calibrate`).  It also holds the trace→ensemble-inputs bridge
(:func:`ensemble_inputs_from_schedule`) the ``ensemble`` subcommand and
the sweeps share, and :func:`des_metrics`, the one metric definition the
sensitivity report shares with the harness.

The DES side runs the port's numpy policies on the host, by design, as in
the reference; the estimator runs on ``device`` (the card unless the
caller asks for the CPU).

Usage::

  python -m pivot_tpu_torch.experiments.cli calibrate --num-apps 50
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from pivot_tpu_torch.utils import get_logger

__all__ = ["calibrate", "des_metrics", "ensemble_inputs_from_schedule"]

logger = get_logger("calibrate")

_METRICS = ("avg_runtime", "egress_cost", "instance_hours", "makespan")


def ensemble_inputs_from_schedule(schedule, cluster, dtype=None,
                                  device="cuda"):
    """(workload, app_slices, arrivals, topo, avail0, storage_zones) for
    an ensemble rollout of ``schedule`` on ``cluster``, on ``device``.

    ``app_slices[i]`` is the ``slice`` of task rows owned by app ``i`` in
    the flattened workload.  Arrivals are rebased to the first submission
    (phase-exact: the DES trace replay submits its first bin at env time
    0, so the rollout's clock-from-0 tick grid matches it).  As in
    ``pivot_tpu``, ``dtype`` sets the topology and availability and the
    workload stays float32 (a float64 rollout promotes it)."""
    from pivot_tpu_torch.ops.kernels import DeviceTopology, resolve_device
    from pivot_tpu_torch.parallel.ensemble import EnsembleWorkload

    dev = resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype
    apps = schedule.apps
    arrivals = [ts for ts, bin_apps in schedule.bins for _ in bin_apps]
    t0 = arrivals[0] if arrivals else 0.0
    arrivals = [a - t0 for a in arrivals]  # rollout clock starts at 0
    workload = EnsembleWorkload.from_applications(
        apps, arrivals=arrivals, device=dev)

    app_slices: List[slice] = []
    offset = 0
    for app in apps:
        n = sum(g.instances for g in app.groups)
        app_slices.append(slice(offset, offset + n))
        offset += n

    topo = DeviceTopology.from_cluster(cluster, dtype, device=dev)
    avail0 = torch.as_tensor(cluster.availability_matrix(),
                             device=dev).to(dtype)
    storage_zones = torch.as_tensor(
        np.asarray(cluster.storage_zone_vector()), device=dev).long()
    return workload, app_slices, arrivals, topo, avail0, storage_zones


def des_metrics(summary: dict, schedule) -> dict:
    """The four comparison metrics from a finished DES run.  Makespan runs
    first submission → last app completion."""
    apps = schedule.apps
    t0 = min(a.start_time for a in apps)
    return {
        "avg_runtime": summary["avg_runtime"],
        "egress_cost": summary["egress_cost"],
        "instance_hours": summary["cum_instance_hours"],
        "makespan": max(a.end_time for a in apps) - t0,
    }


def _des_ground_truth(cluster, policy_name, trace_file, n_apps, scale_factor,
                      seed, interval, realtime=False):
    """Run the exact simulation (the port's numpy arm of ``policy_name``
    from ``reference_policy_set``, ``realtime_bw`` for ``realtime``);
    return its metric dict and the schedule its apps went through."""
    import dataclasses

    from pivot_tpu_torch.experiments.runner import ExperimentRun
    from pivot_tpu_torch.utils.config import (
        PolicyConfig,
        make_policy,
        reference_policy_set,
    )

    pc = next(
        (c for c in reference_policy_set("numpy") if c.name == policy_name),
        PolicyConfig(name=policy_name, device="numpy"),
    )
    if realtime:
        pc = dataclasses.replace(pc, realtime_bw=True)
    run = ExperimentRun(
        f"calibrate-{policy_name}", cluster, make_policy(pc), trace_file,
        output_size_scale_factor=scale_factor, n_apps=n_apps, seed=seed,
        interval=interval,
    )
    summary = run.run()
    schedule = run.schedule
    return des_metrics(summary, schedule), schedule


def _estimate(workload, app_slices, arrivals, topo, avail0, storage_zones,
              policy_name, seed, tick, max_ticks, replicas, perturb,
              congestion, realtime_scoring=False, tick_order="fifo",
              stats=None):
    """One ensemble rollout → metric dict (means over replicas)."""
    from pivot_tpu_torch.parallel.ensemble import prng, rollout

    res = rollout(
        prng.PRNGKey(seed), avail0, workload, topo, storage_zones,
        n_replicas=replicas, tick=tick, max_ticks=max_ticks,
        perturb=perturb, policy=policy_name, congestion=congestion,
        realtime_scoring=realtime_scoring, tick_order=tick_order,
        stats=stats,
    )
    finish = res.finish_time.cpu().numpy()  # [R, T]
    app_runtimes = np.stack(
        [finish[:, s].max(axis=1) - a for s, a in zip(app_slices, arrivals)],
        axis=1,
    )  # [R, A]
    return {
        "avg_runtime": float(app_runtimes.mean()),
        "egress_cost": float(res.egress_cost.cpu().numpy().mean()),
        "instance_hours": float(res.instance_hours.cpu().numpy().mean()),
        "makespan": float(res.makespan.cpu().numpy().mean()),
        "unfinished_max": int(res.n_unfinished.max().item()),
    }


def _with_errors(est: dict, des: dict) -> dict:
    """Attach signed relative errors vs the DES (None where the DES value
    is ~0).  A truncated rollout (tasks unfinished at the horizon) is
    flagged ``horizon_exceeded``, its non-finite metrics nulled and every
    relative error None."""
    out = dict(est)
    if est["unfinished_max"] > 0:
        logger.warning(
            "%d tasks unfinished at the rollout horizon — fidelity numbers "
            "are invalid; raise --max-ticks", est["unfinished_max"],
        )
        out["horizon_exceeded"] = True
        for k in _METRICS:
            if not np.isfinite(out[k]):
                out[k] = None
        out["rel_err"] = {k: None for k in _METRICS}
        return out
    out["rel_err"] = {
        k: (None if abs(des[k]) < 1e-12 else (est[k] - des[k]) / des[k])
        for k in _METRICS
    }
    return out


def calibrate(
    trace_file: str,
    cluster=None,
    n_hosts: int = 100,
    n_apps: Optional[int] = 50,
    policy: str = "cost-aware",
    scale_factor: float = 1000.0,
    seed: int = 0,
    tick: float = 5.0,
    max_ticks: int = 4096,
    replicas: int = 1,
    perturb: float = 0.0,
    modes: Optional[Sequence[str]] = None,
    realtime: bool = False,
    x64: bool = False,
    des_seeds: int = 1,
    cluster_seeds: int = 1,
    cluster_config=None,
    tick_order: str = "lifo",
    device="cuda",
    stats: Optional[dict] = None,
) -> dict:
    """DES ground truth vs ensemble estimates for one (trace, policy)
    pair: ``{"des": {...}, "static": {..., "rel_err": {...}},
    "congested": {...}, ...config keys...}``, ``pivot_tpu``'s report.

    ``replicas=1, perturb=0.0`` (the defaults) run the nominal scenario;
    more replicas with perturbation report the Monte-Carlo mean.  With
    ``realtime`` (cost-aware only) both engines run their
    bandwidth-aware variants (the DES's ``realtime_bw`` arm, the
    estimator's congestion + realtime scoring) and the one mode is
    ``"realtime"``.  ``modes`` picks among ``"static"``, ``"congested"``
    and ``"pairs"`` (default the first two).  ``des_seeds > 1`` runs the
    DES at that many consecutive seeds and calibrates against their mean
    (``des_per_seed`` / ``des_spread`` in the report); ``cluster_seeds >
    1`` repeats the comparison on that many generated clusters (seed +
    i) and summarises the relative errors per mode (``clusters``,
    ``cluster_summary``, ``recommended_mode``: the smallest |mean egress
    error|).  ``x64`` runs the estimator in float64 tensors (the
    workload stays float32, as in ``pivot_tpu``).  ``tick_order``
    defaults to the DES-faithful ``"lifo"``.

    The estimator runs on ``device``, with TF32 matmuls turned off (the
    egress bill's and the pull volumes' products are not exact in TF32).
    ``stats``, when given, gains each mode's rollout counts (``ticks``,
    ``place_steps``, ``host_syncs``, ``wall_s``, on the card
    ``event_span_ms``), added up over clusters and seeds."""
    from pivot_tpu_torch.ops.kernels import resolve_device
    from pivot_tpu_torch.utils.config import ClusterConfig, build_cluster

    if realtime and policy != "cost-aware":
        raise ValueError("realtime calibration applies to the cost-aware "
                         "arm only")
    if realtime and modes is not None:
        raise ValueError("realtime=True fixes the mode to ('realtime',) — "
                         "don't pass modes explicitly")
    if not realtime and modes is not None and "realtime" in modes:
        raise ValueError("mode 'realtime' needs realtime=True (otherwise "
                         "the DES side would not be the realtime_bw arm — "
                         "a mismatched comparison)")
    modes = (
        ("realtime",) if realtime
        else ("static", "congested") if modes is None else tuple(modes)
    )
    unknown = set(modes) - {"static", "congested", "realtime", "pairs"}
    if unknown:
        raise ValueError(f"unknown calibration mode(s): {sorted(unknown)}")
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    run = dict(n_apps=n_apps, policy=policy, scale_factor=scale_factor,
               tick=tick, max_ticks=max_ticks, replicas=replicas,
               perturb=perturb, modes=modes, realtime=realtime, x64=x64,
               des_seeds=des_seeds, tick_order=tick_order, device=device,
               stats=stats)
    if cluster_seeds > 1:
        if cluster is not None:
            raise ValueError("cluster_seeds > 1 generates its own clusters "
                             "— pass n_hosts or cluster_config, not a "
                             "prebuilt cluster")
        import dataclasses

        base_cfg = cluster_config or ClusterConfig(n_hosts=n_hosts, seed=seed)
        runs = [
            _calibrate_one(
                trace_file,
                build_cluster(dataclasses.replace(base_cfg, seed=seed + ci)),
                seed=seed + ci, **run)
            for ci in range(cluster_seeds)
        ]
        summary = {}
        for mode in modes:
            summary[mode] = {}
            for k in _METRICS:
                errs = [r[mode]["rel_err"][k] for r in runs]
                errs = [e for e in errs if e is not None]
                summary[mode][k] = {
                    "mean_rel_err": float(np.mean(errs)) if errs else None,
                    "std_rel_err": float(np.std(errs)) if errs else None,
                    "n": len(errs),
                }
        candidates = [
            (abs(summary[m]["egress_cost"]["mean_rel_err"]), m)
            for m in modes
            if summary[m]["egress_cost"]["mean_rel_err"] is not None
        ]
        recommended = min(candidates)[1] if candidates else None
        return {
            "trace": trace_file,
            "n_hosts": base_cfg.n_hosts,
            "policy": policy,
            "replicas": replicas,
            "perturb": perturb,
            "realtime_variant": realtime,
            "x64": x64,
            "cluster_seeds": cluster_seeds,
            "clusters": runs,
            "cluster_summary": summary,
            "recommended_mode": recommended,
        }
    if cluster is not None and cluster_config is not None:
        raise ValueError("pass cluster or cluster_config, not both")
    if cluster is None:
        cluster = build_cluster(
            cluster_config or ClusterConfig(n_hosts=n_hosts, seed=seed))
    return _calibrate_one(trace_file, cluster, seed=seed, **run)


def _calibrate_one(trace_file, cluster, n_apps, policy, scale_factor, seed,
                   tick, max_ticks, replicas, perturb, modes, realtime, x64,
                   des_seeds, tick_order="fifo", device="cuda", stats=None):
    """One (cluster, seed) paired DES↔estimator comparison (the body of
    :func:`calibrate`).  With ``des_seeds > 1`` the DES runs at that many
    consecutive policy seeds on the same trace and cluster, and the
    estimator is held against their mean."""
    per_seed = []
    schedule = None
    for i in range(max(des_seeds, 1)):
        d, s = _des_ground_truth(
            cluster, policy, trace_file, n_apps, scale_factor, seed + i,
            tick, realtime=realtime,
        )
        per_seed.append(d)
        if schedule is None:
            schedule = s
    des = {k: float(np.mean([d[k] for d in per_seed])) for k in _METRICS}
    inputs = ensemble_inputs_from_schedule(
        schedule, cluster, dtype=torch.float64 if x64 else None,
        device=device)
    report = _calibrate_modes(
        inputs, des, schedule, trace_file, cluster, policy, replicas,
        perturb, realtime, x64, modes, seed, tick, max_ticks,
        tick_order=tick_order, stats=stats,
    )
    if des_seeds > 1:
        report["des_seeds"] = des_seeds
        report["des_per_seed"] = per_seed
        report["des_spread"] = {
            k: {
                "std": float(np.std([d[k] for d in per_seed])),
                "min": float(min(d[k] for d in per_seed)),
                "max": float(max(d[k] for d in per_seed)),
            }
            for k in _METRICS
        }
    return report


def _calibrate_modes(inputs, des, schedule, trace_file, cluster, policy,
                     replicas, perturb, realtime, x64, modes, seed, tick,
                     max_ticks, tick_order="fifo", stats=None):
    """The report of one comparison: its configuration keys, the DES
    metrics and one estimate with relative errors per mode."""
    report = {
        "trace": trace_file,
        "n_hosts": len(cluster.hosts),
        "n_apps": len(schedule.apps),
        "n_tasks": inputs[0].n_tasks,
        "policy": policy,
        "replicas": replicas,
        "perturb": perturb,
        "realtime_variant": realtime,
        "x64": x64,
        "tick_order": tick_order,
        "des": des,
    }
    for mode in modes:
        est = _estimate(
            *inputs, policy, seed, tick, max_ticks, replicas, perturb,
            congestion=(
                "pairs" if mode == "pairs"
                else mode in ("congested", "realtime")
            ),
            realtime_scoring=(mode == "realtime"), tick_order=tick_order,
            stats=None if stats is None else stats.setdefault(mode, {}),
        )
        report[mode] = _with_errors(est, des)
        if report[mode].get("horizon_exceeded"):
            continue
        logger.info(
            "%s/%s: makespan %.0f vs DES %.0f (%+.0f%%), egress $%.2f vs "
            "$%.2f, inst-h %.1f vs %.1f",
            policy, mode, est["makespan"], des["makespan"],
            100 * (est["makespan"] / max(des["makespan"], 1e-9) - 1),
            est["egress_cost"], des["egress_cost"],
            est["instance_hours"], des["instance_hours"],
        )
    return report
