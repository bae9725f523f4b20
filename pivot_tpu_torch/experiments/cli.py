"""Experiment CLI of the port: ``overall``, ``num-apps`` and
``sensitivity``.

Port of ``pivot_tpu/experiments/cli.py``, cut to three subcommands:

  * ``overall`` (``:914``): the three reference scheduler arms
    (Opportunistic / VBP / Cost-Aware,
    ``utils/config.py::reference_policy_set``) over every trace file in
    the job directory, each writing ``general.json``, ``transfers.json``,
    ``scheduler.json`` and ``host_usage.json`` under
    ``<output-dir>/overall/<stamp>/data/<trace index>/<arm>/``;
  * ``num-apps`` (``:935``): the same grid once per ``--num-apps-list``
    entry, under ``<output-dir>/n_app/<stamp>/data/<n>/<trace index>/``;
  * ``sensitivity`` (``:1158``): the paired baseline / sensitivity-gated
    DES experiment (``sched/sensitivity.py``) on the first trace, over
    ``--des-seeds`` seeds, optionally under a saved spot market
    (``--market``); the report goes to stdout and
    ``<output-dir>/sensitivity/<stamp>/report.json``.  A gated
    Cost-Aware tick is one replica-batched launch of ``greedy_place``.

``--device`` picks the policy backend of ``overall`` / ``num-apps``:
``cuda`` (the default: the torch device policies, the Cost-Aware arm
through the hand-written kernel, every tick on the card unless
``--adaptive`` lets small ticks go to the numpy twin) or ``naive`` /
``numpy`` (the CPU policies); ``sensitivity`` always runs the device
policies.  The other subcommands, ``--network native``,
``--batch-runs`` and ``--profile-dir``, and the plots are not ported yet
(ROADMAP.md, port queue).

Usage:
  python -m pivot_tpu_torch.experiments.cli --num-hosts 600 overall \\
      --num-apps 1000
  python -m pivot_tpu_torch.experiments.cli num-apps \\
      --num-apps-list 100 500 1000
  python -m pivot_tpu_torch.experiments.cli --num-hosts 600 sensitivity \\
      --replicas 256 [--market FILE] [--policy cost-aware|vbp|best-fit]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import List, Optional, Tuple

from pivot_tpu_torch.experiments.runner import ExperimentRun, sentinel_path
from pivot_tpu_torch.utils import get_logger
from pivot_tpu_torch.utils.config import (
    ClusterConfig,
    HostShape,
    PolicyConfig,
    build_cluster,
    make_policy,
    reference_policy_set,
)

logger = get_logger("cli")


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """One (policy × trace) run, fully described by picklable values so
    it can cross a process boundary; the run rebuilds its cluster from
    the seeded config.  ``torch_device`` / ``dtype`` place the ``cuda``
    backend's torch tensors (``"cpu"`` in the tests)."""

    cluster: ClusterConfig
    policy: PolicyConfig
    trace: str
    data_dir: str
    n_apps: Optional[int]
    scale_factor: float
    seed: int
    trace_events: bool = False
    audit: bool = False
    torch_device: str = "cuda"
    dtype: str = "float32"


def _spec_identity(spec: RunSpec) -> dict:
    """Every knob that can change a run's results — what ``--resume``
    compares against a run's completion sentinel."""
    return {
        "label": spec.policy.display_label,
        "trace_file": os.path.abspath(spec.trace),
        "n_apps": spec.n_apps,
        "seed": spec.seed,
        "scale_factor": spec.scale_factor,
        "cluster": {
            k: v for k, v in dataclasses.asdict(spec.cluster).items()
            if k != "executor"  # result-neutral
        },
        "policy": dataclasses.asdict(spec.policy),
        "trace_events": spec.trace_events,
        "torch_device": spec.torch_device,
        "dtype": spec.dtype,
    }


def _is_complete(spec: RunSpec) -> bool:
    """True iff the run's completion sentinel exists, parses and
    describes this exact run."""
    marker = sentinel_path(spec.data_dir, spec.policy.display_label)
    if not os.path.exists(marker):
        return False
    try:
        with open(marker) as f:
            recorded = json.load(f)
    except (json.JSONDecodeError, OSError):
        return False
    if recorded == _spec_identity(spec):
        return True
    logger.warning("stale results in %s (different run spec) — rerunning",
                   spec.data_dir)
    return False


def _build_run(spec: RunSpec) -> ExperimentRun:
    """Materialize a spec: cluster + policy + ExperimentRun (not run)."""
    return ExperimentRun(
        spec.policy.display_label,
        build_cluster(spec.cluster),
        make_policy(spec.policy, torch_device=spec.torch_device,
                    dtype=spec.dtype),
        spec.trace,
        output_size_scale_factor=spec.scale_factor,
        n_apps=spec.n_apps,
        data_dir=spec.data_dir,
        seed=spec.seed,
        trace_events=spec.trace_events,
        identity=_spec_identity(spec),
        audit=spec.audit,
    )


def _execute_run(spec: RunSpec) -> Optional[dict]:
    """Run one spec unless its sentinel says it is complete; returns the
    run's summary, or None for a skipped run."""
    if _is_complete(spec):
        logger.info("skipping completed run %s (%s)",
                    spec.policy.display_label, spec.data_dir)
        return None
    return _build_run(spec).run()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Run cost-aware scheduling simulations on Alibaba traces "
                    "(PyTorch/CUDA port)"
    )
    parser.add_argument("--num-hosts", type=int, dest="n_hosts", default=600)
    parser.add_argument("--cpus", type=int, default=16)
    parser.add_argument("--mem", type=int, default=128 * 1024,
                        help="MB per host")
    parser.add_argument("--disk", type=int, default=100, help="GB per host")
    parser.add_argument("--gpus", type=int, default=1)
    parser.add_argument(
        "--job-dir", default=os.environ.get("JOB_DIR", "./data/jobs")
    )
    parser.add_argument(
        "--output-dir", default=os.environ.get("OUTPUT_DIR", "./output")
    )
    parser.add_argument(
        "--task-output-scale-factor", type=float, dest="scale_factor",
        default=1000,
    )
    parser.add_argument(
        "--device", choices=["naive", "numpy", "cuda"], default="cuda",
        help="policy backend (default cuda; naive / numpy are the CPU "
             "policies)",
    )
    parser.add_argument(
        "--adaptive", action="store_true", dest="adaptive",
        help="cuda backend: route each tick to the device or the "
             "in-process numpy twin, whichever is predicted faster "
             "(default: every tick goes to the device)",
    )
    parser.add_argument(
        "--no-adaptive", action="store_false", dest="adaptive",
        help="cuda backend: every tick goes to the device (the default)",
    )
    parser.set_defaults(adaptive=False)
    parser.add_argument(
        "--executor", choices=["fast", "process"], default="fast",
        help="task executor: 'fast' callback executor (default) or the "
             "reference-shaped one-process-per-execution 'process'; "
             "bit-identical trajectories",
    )
    parser.add_argument(
        "--network", choices=["python"], default="python",
        help="network fabric backend (the native C++ fabric is not "
             "ported yet)",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--audit", action="store_true",
                        help="audit simulation-state invariants every tick; "
                             "abort on violation")
    parser.add_argument("--trace-events", action="store_true",
                        help="write structured event traces per run")
    parser.add_argument("--workers", type=int, default=1,
                        help="process-parallel runs (1 = sequential)")
    parser.add_argument("--resume", default=None, metavar="EXP_DIR",
                        help="resume an interrupted sweep: reuse this "
                             "experiment directory and skip completed runs")
    parser.add_argument("--trace-limit", type=int, default=None,
                        help="use only the first N trace files")
    sub = parser.add_subparsers(dest="command", required=True)
    overall = sub.add_parser("overall", help="overall comparison experiment")
    overall.add_argument("--num-apps", type=int, dest="num_apps",
                         default=None)
    napps = sub.add_parser("num-apps", help="cost vs number of applications")
    napps.add_argument("--host-hourly-rate", type=float, default=0.932)
    napps.add_argument("--num-apps-list", nargs="+", type=int, required=True)
    sens = sub.add_parser(
        "sensitivity",
        help="sensitivity-gated dispatch experiment: score every tick's "
             "decision against R availability-noise replicas (one batched "
             "call — replica 0 IS the production decision), hold "
             "placements below a stability threshold for one tick, and "
             "report the egress/runtime/makespan deltas vs the identical "
             "un-gated arm on the same (trace, cluster, seed)s",
    )
    sens.add_argument("--num-apps", type=int, dest="num_apps", default=30)
    sens.add_argument("--policy", default="cost-aware",
                      choices=["cost-aware", "vbp", "best-fit"],
                      help="arm to gate: the canonical cost-aware policy, "
                           "the VBP arm (first-fit decreasing), or best-fit")
    sens.add_argument("--replicas", type=int, default=256,
                      help="noise replicas per tick (the batched kernel's "
                           "replica axis)")
    sens.add_argument("--perturb", type=float, default=0.05,
                      help="± multiplicative noise on the availability "
                           "snapshot")
    sens.add_argument("--threshold", type=float, default=0.7,
                      help="hold a placed task whose replica agreement is "
                           "below this fraction")
    sens.add_argument("--max-holds", type=int, default=1,
                      help="per-task hold budget; after this many holds "
                           "the nominal decision goes through")
    sens.add_argument("--des-seeds", type=int, default=5,
                      help="paired (gated vs baseline) DES runs at this "
                           "many consecutive seeds")
    sens.add_argument("--market", default=None, metavar="FILE",
                      help="attach a saved MarketSchedule: both arms score "
                           "egress against the time-varying price-scaled "
                           "cost tensor")
    return parser.parse_args(argv)


def _list_traces(job_dir: str, limit=None) -> List[str]:
    if not os.path.isdir(job_dir):
        raise SystemExit(
            f"error: job directory {job_dir!r} does not exist "
            "(set --job-dir or the JOB_DIR env var)"
        )
    names = sorted(
        f for f in os.listdir(job_dir) if f.endswith((".npz", ".yaml", ".yml"))
    )
    if not names:
        raise SystemExit(f"error: no .npz/.yaml traces in {job_dir!r}")
    stems = {}
    for n in names:  # prefer npz when both forms of a trace exist
        stem = n.rsplit(".", 1)[0]
        if stem not in stems or n.endswith(".npz"):
            stems[stem] = n
    out = [os.path.join(job_dir, n) for n in sorted(stems.values())]
    return out[:limit] if limit else out


def _run_grid(specs: List[RunSpec], workers: int) -> List[Optional[dict]]:
    """Execute runs sequentially, or across ``workers`` spawned
    processes (summaries are then not returned: ``None`` each)."""
    if workers <= 1:
        return [_execute_run(spec) for spec in specs]
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with ctx.Pool(workers) as pool:
        pool.map(_execute_run, specs)
    return [None] * len(specs)


def _cluster_config(args) -> ClusterConfig:
    return ClusterConfig(
        n_hosts=args.n_hosts,
        shape=HostShape(args.cpus, args.mem, args.disk, args.gpus),
        seed=args.seed,
        network=args.network,
        executor=args.executor,
    )


def _reference_grid(args, kind: str, counts, torch_device, dtype
                    ) -> Tuple[str, List[Optional[dict]]]:
    """Every ``(data subdirectory, app count)`` of ``counts`` × every
    trace × the three reference arms, under
    ``<output-dir>/<kind>/<stamp>/data/<subdirectory>/<trace index>/``.
    Returns ``(experiment dir, per-run summaries in spec order)``."""
    exp_dir = args.resume or os.path.join(
        args.output_dir, kind, str(int(time.time()))
    )
    os.makedirs(exp_dir, exist_ok=True)
    cluster_cfg = _cluster_config(args)
    traces = _list_traces(args.job_dir, args.trace_limit)
    policy_set = reference_policy_set(args.device, adaptive=args.adaptive)
    specs = [
        RunSpec(cluster_cfg, pc, trace,
                os.path.join(exp_dir, "data", *sub, str(i)),
                n, args.scale_factor, args.seed,
                args.trace_events, args.audit, str(torch_device), dtype)
        for sub, n in counts
        for i, trace in enumerate(traces)
        for pc in policy_set
    ]
    logger.info("%s: %d runs (%d traces × %d policies) → %s", kind,
                len(specs), len(traces), len(policy_set), exp_dir)
    return exp_dir, _run_grid(specs, args.workers)


def run_overall(args, torch_device: str = "cuda",
                dtype: str = "float32") -> Tuple[str, List[Optional[dict]]]:
    """The overall experiment: every trace × the three reference arms.
    Returns ``(experiment dir, per-run summaries in spec order)``."""
    return _reference_grid(args, "overall", [((), args.num_apps)],
                           torch_device, dtype)


def run_num_apps(args, torch_device: str = "cuda",
                 dtype: str = "float32") -> Tuple[str, List[Optional[dict]]]:
    """Cost vs number of applications: the overall grid once per
    ``--num-apps-list`` entry.  Returns ``(experiment dir, per-run
    summaries in spec order)``."""
    return _reference_grid(
        args, "n_app", [((str(n),), n) for n in args.num_apps_list],
        torch_device, dtype)


#: The arm each ``sensitivity --policy`` gates, with the ``decreasing``
#: flag the report records (VBP is first-fit DEcreasing, the reference's
#: arm; best-fit's canonical arm is plain).
_SENSITIVITY_ARMS = {
    "cost-aware": (PolicyConfig(name="cost-aware", bin_pack="first-fit",
                                sort_tasks=True, sort_hosts=True), None),
    "vbp": (PolicyConfig(name="first-fit", decreasing=True), True),
    "best-fit": (PolicyConfig(name="best-fit", decreasing=False), False),
}


def run_sensitivity(args, torch_device: str = "cuda",
                    dtype: str = "float32") -> dict:
    """Paired DES experiment: sensitivity-gated dispatch vs the identical
    un-gated arm (``sched/sensitivity.py``).

    Each seed runs BOTH arms on the same (trace, cluster): the baseline
    is the same device policy configuration the gated wrapper drives, so
    the only degree of freedom is the hold rule.  The report carries the
    mean signed deltas with per-seed detail, the gate's telemetry (holds,
    stability profile) and its price in wall time; it is printed and
    written to ``report.json``."""
    import numpy as np

    from pivot_tpu_torch.experiments.calibrate import des_metrics
    from pivot_tpu_torch.sched.sensitivity import SensitivityGatedCostAware

    trace = _list_traces(args.job_dir, 1)[0]
    policy_name = args.policy
    market = None
    if args.market:
        from pivot_tpu_torch.infra.market import MarketSchedule

        market = MarketSchedule.load(args.market)
    arm, decreasing = _SENSITIVITY_ARMS[policy_name]

    def one(seed: int, gated: bool):
        cluster = build_cluster(_cluster_config(args))
        pol = make_policy(arm, torch_device=torch_device, dtype=dtype)
        if gated:
            pol = SensitivityGatedCostAware(
                threshold=args.threshold,
                n_replicas=args.replicas,
                perturb=args.perturb,
                max_holds=args.max_holds,
                noise_seed=seed,
                inner=pol,
            )
        run = ExperimentRun(
            f"sensitivity-{'gated' if gated else 'base'}-{seed}",
            cluster, pol, trace,
            output_size_scale_factor=args.scale_factor,
            n_apps=args.num_apps, seed=seed, interval=5.0,
            market=market,
        )
        t0 = time.perf_counter()
        summary = run.run()
        wall = time.perf_counter() - t0
        return des_metrics(summary, run.schedule), (
            pol.summary() if gated else None
        ), round(wall, 2)

    per_seed = []
    for s in range(args.seed, args.seed + args.des_seeds):
        base, _, base_wall = one(s, gated=False)
        gated, gate_stats, gated_wall = one(s, gated=True)
        per_seed.append({
            "seed": s, "baseline": base, "gated": gated,
            "gate": gate_stats,
            "baseline_wall_s": base_wall,
            "gated_wall_s": gated_wall,
            "delta": {k: gated[k] - base[k] for k in base},
        })
    keys = ("avg_runtime", "egress_cost", "instance_hours", "makespan")
    deltas = {
        k: {
            "mean": float(np.mean([r["delta"][k] for r in per_seed])),
            "std": float(np.std([r["delta"][k] for r in per_seed])),
            "mean_rel": float(np.mean([
                r["delta"][k] / max(abs(r["baseline"][k]), 1e-12)
                for r in per_seed
            ])),
        }
        for k in keys
    }
    report = {
        "trace": trace,
        "policy": policy_name,
        **({"market": os.path.abspath(args.market)} if args.market else {}),
        **({"decreasing": decreasing} if decreasing is not None else {}),
        "n_hosts": args.n_hosts,
        "n_apps": args.num_apps,
        "gate_cost": {
            "mean_baseline_wall_s": float(
                np.mean([r["baseline_wall_s"] for r in per_seed])
            ),
            "mean_gated_wall_s": float(
                np.mean([r["gated_wall_s"] for r in per_seed])
            ),
            "mean_sensitivity_wall_per_tick_s": float(np.mean([
                r["gate"]["sensitivity_wall_per_tick_s"]
                for r in per_seed
                if r["gate"]["sensitivity_wall_per_tick_s"] is not None
            ])) if per_seed else None,
        },
        "replicas": args.replicas,
        "perturb": args.perturb,
        "threshold": args.threshold,
        "max_holds": args.max_holds,
        "des_seeds": args.des_seeds,
        "delta_gated_minus_baseline": deltas,
        "per_seed": per_seed,
    }
    out_dir = os.path.join(args.output_dir, "sensitivity",
                           str(int(time.time())))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))
    return report


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.command == "sensitivity":
        run_sensitivity(args)
        return
    run = run_num_apps if args.command == "num-apps" else run_overall
    exp_dir, _ = run(args)
    print(exp_dir)


if __name__ == "__main__":
    main()
