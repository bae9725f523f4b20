"""Experiment CLI of the port: ``overall``, ``num-apps``,
``sensitivity``, ``ensemble``, ``calibrate``, ``autotune``, ``capacity``,
``apps``, ``search``, ``serve`` and ``worker``.

Port of ``pivot_tpu/experiments/cli.py``:

  * ``overall`` (``:914``): the three reference scheduler arms
    (Opportunistic / VBP / Cost-Aware,
    ``utils/config.py::reference_policy_set``) over every trace file in
    the job directory, each writing ``general.json``, ``transfers.json``,
    ``scheduler.json`` and ``host_usage.json`` under
    ``<output-dir>/overall/<stamp>/data/<trace index>/<arm>/``, then the
    ``overall`` and ``transfer`` figures under ``plot/``;
  * ``num-apps`` (``:935``): the same grid once per ``--num-apps-list``
    entry, under ``<output-dir>/n_app/<stamp>/data/<n>/<trace index>/``,
    then the financial-cost figure;
  * ``sensitivity`` (``:1158``): the paired baseline / sensitivity-gated
    DES experiment (``sched/sensitivity.py``) on the first trace, over
    ``--des-seeds`` seeds, optionally under a saved spot market
    (``--market``); the report goes to stdout and
    ``<output-dir>/sensitivity/<stamp>/report.json``.  A gated
    Cost-Aware tick is one replica-batched launch of ``greedy_place``;
  * ``ensemble`` (``:995``): the Monte-Carlo ensemble rollout (BASELINE
    config 5, ``parallel/ensemble``) of the first trace's first
    ``--num-apps`` apps over ``--replicas`` perturbed replicas, writing
    ``rollout.npz`` and ``summary.json`` under
    ``<output-dir>/ensemble/<stamp>/``, with per-replica fault schedules
    (``--faults``, ``--fault-horizon``, ``--fault-mttr``), the congestion
    backlog model (``--congestion``), realtime scoring
    (``--realtime-score``) and checkpoint/resume (``--checkpoint``), and
    the makespan distribution figure; over a replica mesh of several
    shards (and no ``--checkpoint``) it runs ``sharded_rollout`` — on
    several distinct cards it runs unsharded, logged, as a mesh over
    them is ROADMAP.md Queue 1, several cards;
  * ``calibrate`` (``:1118``): the estimator against the exact DES on
    the first trace (``experiments/calibrate.py``), static and congested
    transfer models or ``--realtime``, over ``--des-seeds`` /
    ``--cluster-seeds``; the report goes to stdout (its first line) and
    ``<output-dir>/calibrate/<stamp>/report.json``, with the spread
    figure of a ``--des-seeds`` / ``--cluster-seeds`` report;
  * ``autotune`` (``:1309``), ``capacity`` (``:1404``) and ``apps``
    (``:1525``): the what-if sweeps of ``parallel/ensemble/sweeps.py``
    (cost-aware score exponents, cluster sizes with optional faults,
    app counts per policy arm), each writing ``summary.json`` under
    ``<output-dir>/<name>/<stamp>/``, ``capacity`` and ``apps`` with
    their figures.  They route through ``parallel.ensemble.shard_sweep``
    (``_maybe_shard_sweep``): on one card, the CPU or several distinct
    cards (Queue 1, several cards; logged) they run unsharded, in the
    reference's 256-tick segments;
  * ``search`` (``:484``, ``run_search_cli`` ``:1911``): the policy
    search (``experiments/search.py``): CEM or ES over scoring-weight
    vectors, each generation's ``--popsize × --replicas`` rows one batch
    of the ensemble's row runner under a seeded spot market and its
    preemption plan, then held-out seeds, the branch-and-bound oracle's
    regrets and, with ``--des-validate``, the exact DES
    (``experiments/spot.py``).  The report goes to stdout and ``--out``.
    ``--backend sharded_rollout`` splits each generation's rows over a
    replica mesh of the visible cards (one card: a mesh of one shard),
    with the same report.

``--device`` picks the policy backend of ``overall`` / ``num-apps``:
``cuda`` (the default: the torch device policies, the Cost-Aware arm
through the hand-written kernel, every tick on the card unless
``--adaptive`` lets small ticks go to the numpy twin) or ``naive`` /
``numpy`` (the CPU policies); ``sensitivity`` always runs the device
policies; ``ensemble``, the sweeps, ``calibrate``'s estimator and
``search`` run on the card (the ``torch_device`` of their ``run_*``
function).  ``--batch-runs G`` (``:773-786``, ``:821-899``) runs the
``overall`` / ``num-apps`` grid in lock-step chunks of G same-arm runs
(``runner.run_grid_lockstep``): their co-pending ticks and spans
coalesce, a Cost-Aware flush one per-row launch of ``greedy_place``; it
needs ``--device cuda``, refuses ``--workers > 1`` and forces
``--no-adaptive``.  ``serve`` (``:1614``) runs the online serving layer,
with serve spans (``--fuse-spans slo``), ragged span batching (the
default; ``--no-ragged`` for the A/B), resident span carries
(``--resident``, ``--splice-tier``), model-predictive serving
(``--mpc``) and the sampled dispatch profiler (``--profile-dispatch N``,
``--device cuda`` only).  ``--network native`` serves the network
fabric in the C++ co-simulator (``pivot_tpu_torch/native``; a failed
``g++`` build exits, it never falls back to the Python fabric);
``--profile-dir DIR`` captures a ``torch.profiler`` trace of each run
under ``DIR/<data-dir tail>/<arm>/trace.json`` (ignored, with a warning,
under ``--batch-runs``).  ``worker`` (``:716``, ``run_worker``
``:1834``) serves repeated requests from stdin in one warm process.

The figures are ``experiments/plots.py``'s.  Without matplotlib (the
card's machine has none) the CLI writes one line to stderr naming the
figures it did not draw; its exit code and data files do not change.

Usage:
  python -m pivot_tpu_torch.experiments.cli --num-hosts 600 overall \\
      --num-apps 1000
  python -m pivot_tpu_torch.experiments.cli --num-hosts 600 \\
      --trace-limit 4 --batch-runs 4 overall --num-apps 200
  python -m pivot_tpu_torch.experiments.cli serve --sessions 3 \\
      --jobs 300 --arrival-rate 25 --fuse-spans slo \\
      [--no-ragged | --resident --splice-tier 1]
  python -m pivot_tpu_torch.experiments.cli num-apps \\
      --num-apps-list 100 500 1000
  python -m pivot_tpu_torch.experiments.cli --num-hosts 600 sensitivity \\
      --replicas 256 [--market FILE] [--policy cost-aware|vbp|best-fit]
  python -m pivot_tpu_torch.experiments.cli ensemble --replicas 1024 \\
      [--policy cost-aware|first-fit|best-fit|opportunistic] \\
      [--faults 4 --fault-mttr 300]
  python -m pivot_tpu_torch.experiments.cli autotune --replicas 32
  python -m pivot_tpu_torch.experiments.cli capacity \\
      --host-counts 100 200 400 600 [--faults 4 --fault-mttr 300]
  python -m pivot_tpu_torch.experiments.cli apps --app-counts 10 25 50
  python -m pivot_tpu_torch.experiments.cli search --method cem \\
      --generations 6 --popsize 12 --replicas 8 --hosts 12 --seed 5 \\
      --holdout 2 --des-validate [--config data/search/ci_seed.json]
  echo '["--device", "numpy", "overall", "--num-apps", "8"]' | \
      python -m pivot_tpu_torch.experiments.cli worker
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
    backend's torch tensors (``"cpu"`` in the tests); ``profile_dir``
    (``--profile-dir``) captures a ``torch.profiler`` trace of the run
    under it.  Neither it nor ``audit`` is part of the run identity."""

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
    profile_dir: str = ""


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
    run's summary, or None for a skipped run.  With ``profile_dir`` the
    run is traced into ``<profile_dir>/<data-dir tail>/<arm>/``: the
    run's unique data-dir tail keys the directory, so concurrent runs
    sharing one ``--profile-dir`` never collide
    (``pivot_tpu/experiments/cli.py:137-157``)."""
    from pivot_tpu_torch.obs.tracer import device_profile

    if _is_complete(spec):
        logger.info("skipping completed run %s (%s)",
                    spec.policy.display_label, spec.data_dir)
        return None
    run = _build_run(spec)
    profile_dir = ""
    if spec.profile_dir:
        tail = spec.data_dir.split(os.sep + "data" + os.sep, 1)[-1]
        profile_dir = os.path.join(spec.profile_dir, tail,
                                   spec.policy.display_label)
    with device_profile(profile_dir):
        return run.run()


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
        "--network", choices=["python", "native"], default="python",
        help="network fabric backend (native = C++ co-simulator)",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--audit", action="store_true",
                        help="audit simulation-state invariants every tick; "
                             "abort on violation")
    parser.add_argument("--trace-events", action="store_true",
                        help="write structured event traces per run")
    parser.add_argument("--profile-dir", default="",
                        help="capture a torch.profiler device trace (CUDA "
                             "and CPU activities, Chrome trace JSON) of "
                             "each run into this directory")
    parser.add_argument("--workers", type=int, default=1,
                        help="process-parallel runs (1 = sequential)")
    parser.add_argument("--batch-runs", type=int, default=1, metavar="G",
                        help="advance G grid runs of one arm "
                             "tick-synchronously and coalesce their "
                             "placement calls and spans into shared "
                             "flushes (--device cuda only, implies "
                             "--no-adaptive; equal to sequential runs)")
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
    ens = sub.add_parser(
        "ensemble",
        help="Monte-Carlo ensemble: the scheduling rollout of every "
             "perturbed replica at once on the card (BASELINE config 5; "
             "the reference can only fork one OS process per scenario)",
    )
    ens.add_argument("--num-apps", type=int, dest="num_apps", default=50)
    ens.add_argument("--replicas", type=int, default=1024)
    ens.add_argument("--policy", default="cost-aware",
                     choices=["cost-aware", "first-fit", "best-fit",
                              "opportunistic"],
                     help="placement arm simulated by the rollout (the "
                          "reference's three comparison arms + cost-aware)")
    ens.add_argument("--perturb", type=float, default=0.1,
                     help="± multiplicative jitter on task runtimes and "
                          "arrival times per replica")
    ens.add_argument(
        "--tick-order", default="fifo", choices=["fifo", "lifo"],
        help="within-tick batch order: 'fifo' (task-index, bit-stable "
             "throughput default) or 'lifo' (exact DES popitem-queue "
             "emulation; default: fifo)",
    )
    ens.add_argument("--tick", type=float, default=5.0)
    ens.add_argument("--max-ticks", type=int, default=2048)
    ens.add_argument("--checkpoint", default=None, metavar="NPZ",
                     help="segmented rollout with checkpoint/resume: the "
                          "state goes to NPZ every 256 ticks and a rerun "
                          "with the same arguments continues from it")
    ens.add_argument("--replica-chunk", type=int, default=0, metavar="R",
                     help="run the ensemble in replica chunks of R (0 = "
                          "off); chunk c > 0 draws from fold_in(key, c), "
                          "a different (equally i.i.d.) sample set than "
                          "one call")
    ens.add_argument("--faults", type=int, default=0, metavar="N",
                     help="per-replica random host crashes (resilience "
                          "what-if: N crashes per replica)")
    ens.add_argument("--fault-horizon", type=float, default=None,
                     help="crash times drawn uniform in [0, horizon) "
                          "(default: tick x max-ticks)")
    ens.add_argument("--fault-mttr", type=float, default=None,
                     help="mean outage duration (Exp-distributed); "
                          "omit for permanent crashes")
    ens.add_argument("--congestion", action="store_true",
                     help="tick-resolution link-contention model: transfer "
                          "delays account for queued backlog on each "
                          "(src zone → dst host) pipe instead of assuming "
                          "uncontended bandwidth")
    ens.add_argument("--realtime-score", action="store_true",
                     dest="realtime_scoring",
                     help="cost-aware scoring reads the backlog-discounted "
                          "inbound bandwidth (the DES realtime_bw arm's "
                          "estimator analog; implies --congestion)")
    cal = sub.add_parser(
        "calibrate",
        help="quantify the ensemble estimator against DES ground truth: "
             "same (trace, cluster, policy) through both engines, "
             "side-by-side metrics with relative errors for the static "
             "and congestion-aware transfer models",
    )
    cal.add_argument("--num-apps", type=int, dest="num_apps", default=50)
    cal.add_argument("--policy", default="cost-aware",
                     choices=["cost-aware", "first-fit", "best-fit",
                              "opportunistic"])
    cal.add_argument("--replicas", type=int, default=1,
                     help="ensemble replicas (1 + --perturb 0 = nominal "
                          "scenario; more = Monte-Carlo mean)")
    cal.add_argument("--perturb", type=float, default=0.0)
    cal.add_argument("--tick", type=float, default=5.0)
    cal.add_argument("--max-ticks", type=int, default=4096)
    cal.add_argument("--des-seeds", type=int, default=1,
                     help="run the DES ground truth at this many "
                          "consecutive seeds and calibrate against the "
                          "seed MEAN (records des_per_seed/des_spread; "
                          "the right comparison for the order-chaotic "
                          "packing arms — pair with --replicas > 1; draws "
                          "the spread figure)")
    cal.add_argument("--cluster-seeds", type=int, default=1,
                     help="repeat the paired DES-vs-estimator comparison "
                          "on this many independently generated clusters "
                          "(fresh zone layout + bandwidth jitter) and "
                          "report mean/std rel err per metric, with the "
                          "spread figure)")
    cal.add_argument("--x64", action="store_true",
                     help="run the estimator in float64 like the DES")
    _add_tick_order(cal, default="lifo")
    cal.add_argument("--realtime", action="store_true",
                     help="calibrate the bandwidth-aware variants against "
                          "each other: DES realtime_bw arm vs estimator "
                          "congestion + realtime scoring (cost-aware only)")
    at = sub.add_parser(
        "autotune",
        help="scheduler-hyperparameter search: sweep the cost-aware score "
             "exponents cost^a / (norm^c × bw^b) over a grid, every "
             "candidate × Monte-Carlo replica in one batch on the card "
             "with paired draws",
    )
    at.add_argument("--num-apps", type=int, dest="num_apps", default=50)
    at.add_argument("--replicas", type=int, default=32,
                    help="Monte-Carlo replicas per candidate")
    at.add_argument("--perturb", type=float, default=0.1)
    _add_tick_order(at)
    at.add_argument("--tick", type=float, default=5.0)
    at.add_argument("--max-ticks", type=int, default=2048)
    at.add_argument("--exponents", nargs="+", type=float,
                    default=[0.5, 1.0, 2.0],
                    help="candidate values for each of the three "
                         "exponents; the grid is their cube (default "
                         "3^3 = 27 candidates) plus the reference shape "
                         "(1,1,1) if absent")
    at.add_argument("--objective", choices=["makespan", "egress"],
                    default="makespan",
                    help="winner selection: mean makespan or mean egress")
    at.add_argument("--congestion", action="store_true",
                    help="score candidates under the link-contention "
                         "transfer model")
    cap = sub.add_parser(
        "capacity",
        help="capacity planning: roll the workload out on K candidate "
             "cluster sizes × R Monte-Carlo replicas in one batch on the "
             "card (paired draws) and report the cost/makespan trade-off "
             "per size",
    )
    cap.add_argument("--num-apps", type=int, dest="num_apps", default=50)
    cap.add_argument("--host-counts", nargs="+", type=int, required=True,
                     help="candidate cluster sizes (each ≤ --num-hosts); "
                          "prefixes of the generated cluster, so zone "
                          "balance is preserved")
    cap.add_argument("--replicas", type=int, default=32)
    cap.add_argument("--perturb", type=float, default=0.1)
    _add_tick_order(cap)
    cap.add_argument("--tick", type=float, default=5.0)
    cap.add_argument("--max-ticks", type=int, default=2048)
    cap.add_argument("--host-hourly-rate", type=float, default=0.932,
                     help="$/host-hour for the total-cost column (ref "
                          "alibaba/sim.py:44-45)")
    cap.add_argument("--slo-makespan", type=float, default=None,
                     help="pick the cheapest size whose MEAN makespan "
                          "meets this bound (default: cheapest that "
                          "finishes the workload)")
    cap.add_argument("--policy", default="cost-aware",
                     choices=["cost-aware", "first-fit", "best-fit",
                              "opportunistic"])
    cap.add_argument("--congestion", action="store_true",
                     help="link-contention model")
    cap.add_argument("--realtime-score", action="store_true",
                     dest="realtime_scoring",
                     help="backlog-discounted cost-aware scoring (implies "
                          "--congestion)")
    cap.add_argument("--faults", type=int, default=0, metavar="N",
                     help="resilience-aware sizing: each replica draws an "
                          "independent N-crash schedule, applied as the "
                          "same physical failure trace to every candidate "
                          "size (a crash on a host a small candidate "
                          "doesn't have is a no-op there)")
    cap.add_argument("--fault-horizon", type=float, default=None,
                     help="crash times drawn uniform in [0, horizon) "
                          "(default: tick x max-ticks)")
    cap.add_argument("--fault-mttr", type=float, default=None,
                     help="mean outage duration (Exp-distributed); "
                          "omit for permanent crashes")
    aps = sub.add_parser(
        "apps",
        help="num-apps sweep: cost vs workload size for the three "
             "reference policy arms, each arm one batch over K app-counts "
             "× R Monte-Carlo replicas (paired draws) on the card",
    )
    aps.add_argument("--app-counts", nargs="+", type=int, required=True,
                     help="candidate workload sizes (first N apps of the "
                          "trace, in submission order)")
    aps.add_argument("--replicas", type=int, default=32)
    aps.add_argument("--perturb", type=float, default=0.1)
    _add_tick_order(aps)
    aps.add_argument("--tick", type=float, default=5.0)
    aps.add_argument("--max-ticks", type=int, default=4096)
    aps.add_argument("--host-hourly-rate", type=float, default=0.932)
    aps.add_argument("--policies", nargs="+",
                     default=["opportunistic", "first-fit", "cost-aware"],
                     choices=["cost-aware", "first-fit", "best-fit",
                              "opportunistic"],
                     help="arms to sweep (default: the reference's three)")
    aps.add_argument("--congestion", action="store_true",
                     help="link-contention model")
    sch = sub.add_parser(
        "search",
        help="policy search at ensemble scale (pivot_tpu_torch/search/): "
             "learn scoring weights (fit/egress/bw exponents + the risk "
             "pair) with CEM/ES — every generation's candidate population "
             "is one row batch of the ensemble rollout on the card under "
             "the seeded market + preemption environment — then score "
             "learned vs hand-tuned on held-out seeds and report regret "
             "against the exact branch-and-bound oracle; prints the "
             "report JSON",
    )
    sch.add_argument("--method", default="cem", choices=["cem", "es"])
    sch.add_argument("--generations", type=int, default=6)
    sch.add_argument("--popsize", type=int, default=12,
                     help="candidate weight vectors per generation")
    sch.add_argument("--replicas", type=int, default=8,
                     help="Monte-Carlo rollouts per candidate (the "
                          "population dispatch is popsize x replicas "
                          "rows)")
    sch.add_argument("--hosts", type=int, default=12)
    sch.add_argument("--num-apps", type=int, dest="num_apps", default=8)
    sch.add_argument("--horizon", type=float, default=600.0)
    sch.add_argument("--seed", type=int, default=5)
    sch.add_argument("--holdout", type=int, default=2,
                     help="held-out environment seeds for the "
                          "learned-vs-hand-tuned comparison")
    sch.add_argument("--backend", default="rollout",
                     choices=["rollout", "sharded_rollout"],
                     help="fitness backend: single-device rows, or rows "
                          "sharded over a replica mesh of the visible "
                          "cards (bit-identical scores)")
    sch.add_argument("--bad-init", action="store_true",
                     help="start from the deliberately-bad vector (the "
                          "smoke gate's shape) instead of the hand-tuned "
                          "default")
    sch.add_argument("--no-oracle", action="store_true",
                     help="skip the small-instance regret section")
    sch.add_argument("--des-validate", action="store_true",
                     help="also play learned vs hand-tuned through the "
                          "exact DES under the first held-out market")
    sch.add_argument("--config", default=None, metavar="FILE",
                     help="JSON config overriding the flags above (e.g. "
                          "the replay anchor data/search/ci_seed.json)")
    sch.add_argument("--out", default=None, metavar="FILE",
                     help="write the report JSON here as well")
    srv = sub.add_parser(
        "serve",
        help="online serving layer: stream Poisson/trace job arrivals "
             "through G always-on scheduling sessions — bounded admission "
             "queue with backpressure, shared batched device dispatch "
             "(--device cuda: a coalesced Cost-Aware flush is one per-row launch of greedy_place), SLO-metered (p50/p95/p99 decision latency, "
             "queue depth, shed counts); prints the service report JSON",
    )
    srv.add_argument("--sessions", type=int, default=2, metavar="G",
                     help="concurrent scheduling sessions multiplexed "
                          "onto one batched dispatch")
    srv.add_argument("--jobs", type=int, default=50,
                     help="jobs to serve before shutdown")
    srv.add_argument("--arrival-rate", type=float, default=0.2,
                     help="Poisson arrivals per sim-second (with "
                          "--source trace, 0 replays the recorded "
                          "submit times instead)")
    srv.add_argument("--source", choices=["poisson", "trace"],
                     default="poisson",
                     help="'poisson': synthetic chain-DAG jobs at "
                          "exponential gaps; 'trace': the first Alibaba "
                          "trace window in --job-dir, re-timed onto a "
                          "Poisson process at --arrival-rate")
    srv.add_argument("--queue-depth", type=int, default=64,
                     help="admission queue bound (admitted-but-"
                          "incomplete jobs)")
    srv.add_argument("--backpressure",
                     choices=["block", "shed", "spill"], default="shed",
                     help="policy when the admission queue is full: "
                          "block the stream, shed with a recorded "
                          "reason, or spill to the next scheduler tick")
    srv.add_argument("--flush-after-us", type=float, default=5000.0,
                     help="dispatch-batcher deadline flush in "
                          "microseconds (0 = quiescence-only, the batch "
                          "grid driver's behavior)")
    srv.add_argument("--closed-loop", type=int, default=0, metavar="C",
                     help="closed-loop load generator: keep C jobs in "
                          "flight (each completion injects the next) "
                          "instead of the open-loop arrival stream")
    srv.add_argument("--pace", type=float, default=0.0,
                     help="wall pacing in sim-seconds per wall-second "
                          "(0 = replay as fast as the sessions can "
                          "schedule)")
    srv.add_argument("--policy", default="cost-aware",
                     choices=["cost-aware", "first-fit", "best-fit",
                              "opportunistic"],
                     help="placement arm every session runs")
    srv.add_argument("--shard-hosts", type=int, default=0, metavar="S",
                     help="2-D mesh serving: shard every session's host "
                          "axis over S mesh shards AND coalesce "
                          "co-pending dispatches over the remaining "
                          "visible cards' replica axis "
                          "(build_hybrid_mesh(host_parallel=S); needs "
                          "--device cuda and n_hosts divisible by S; on "
                          "one card only S = 1 divides).  0 = off")
    srv.add_argument("--fuse-spans", choices=["off", "slo"],
                     default="off",
                     help="serve-span mode: 'off' keeps per-tick "
                          "dispatch (the bit-parity default); 'slo' "
                          "fuses multi-tick spans between SLO "
                          "checkpoints — spans bounded by the "
                          "admission window, one decision latency per "
                          "span")
    srv.add_argument("--no-ragged", action="store_true",
                     help="disable ragged span batching: by default "
                          "co-pending spans of different horizons pad "
                          "to one (K, B) bucket and share one flush "
                          "(trimmed per request, equal results); this "
                          "flag keeps same-shape-only coalescing for "
                          "A/B runs")
    srv.add_argument("--resident", action=argparse.BooleanOptionalAction,
                     default=False,
                     help="resident span carries: keep each session's "
                          "span state (availability, counts, live mask) "
                          "on the card between spans and ship only "
                          "mirror-diff edit rows (equal placements; "
                          "the sessions then run without the shared "
                          "batcher).  --no-resident pins the re-staged "
                          "path")
    srv.add_argument("--splice-tier", type=int, default=0,
                     help="with --resident: arrivals at or below this "
                          "priority tier may join a running span (a "
                          "re-run from the span-entry carry clone, its "
                          "committed prefix checked); higher tiers wait "
                          "for the span's end")
    srv.add_argument("--tenant-quota", type=float, default=0.0,
                     help="DRF tenant fairness within a tier: cap each "
                          "tenant's dominant-resource occupancy at "
                          "this share (0 < q <= 1) of its tier's "
                          "total, shedding/spilling over-quota "
                          "arrivals with reason 'tenant_quota'.  "
                          "0 = off")
    srv.add_argument("--tier-mix", default="",
                     help="multi-tenant arrival mix: comma-separated "
                          "tier weights, index = priority tier (0 = "
                          "serving, most important), e.g. "
                          "'0.25,0.35,0.40'.  Empty = single-tenant "
                          "tier-0 stream (the bit-parity default)")
    srv.add_argument("--tier-reserve", default="",
                     help="per-tier depth reservations, e.g. '0,2,4': "
                          "reserve[t] queue slots are off-limits to "
                          "tier t, so low tiers run out of queue first")
    srv.add_argument("--tier-policies", default="",
                     help="per-tier backpressure override, e.g. "
                          "'spill,shed,shed' (tier 0 lossless, lower "
                          "tiers shed).  Empty = --backpressure for all")
    srv.add_argument("--routing", choices=["rr", "least-loaded"],
                     default="rr",
                     help="job routing: deterministic round-robin (the "
                          "bit-parity default) or least-loaded over "
                          "inbox depth + recent decision latency")
    srv.add_argument("--preempt", action="store_true",
                     help="in-queue preemption: a high-tier arrival "
                          "meeting a full queue cancels an admitted-"
                          "but-unplaced lower-tier job (requeued to "
                          "the spill buffer) instead of degrading")
    srv.add_argument("--autoscale", default="", metavar="GMIN:GMAX",
                     help="SLO-driven session-pool autoscaling between "
                          "GMIN and GMAX (e.g. '1:8'): grow on p99 "
                          "decision-latency breach, drain-then-retire "
                          "on calm.  Empty = fixed pool")
    srv.add_argument("--slo-p99-ms", type=float, default=50.0,
                     help="tier-0 p99 decision-latency target (ms) the "
                          "autoscaler sizes the pool against")
    srv.add_argument("--mpc", action="store_true",
                     help="model-predictive serving (pivot_tpu_torch/mpc): "
                          "a control thread forecasts the arrival "
                          "stream, scores hold/grow/drain/shed/weight "
                          "actions with seeded shadow rollouts of the "
                          "predicted horizon (ONE evaluator call per "
                          "window, on the card with --device cuda), "
                          "executes the predicted best, and promotes "
                          "tuned PolicyWeights through a canary→fleet "
                          "rollout with automatic SLO rollback")
    srv.add_argument("--mpc-pool", default="", metavar="GMIN:GMAX",
                     help="pool bounds the MPC planner moves between "
                          "(e.g. '1:8'); empty pins the pool at the "
                          "launch size (plan actions limited to "
                          "hold/shed/weights)")
    srv.add_argument("--mpc-horizon", type=float, default=300.0,
                     help="shadow-rollout horizon (sim seconds) each "
                          "decision window predicts over")
    srv.add_argument("--mpc-interval-ms", type=float, default=50.0,
                     help="wall milliseconds between MPC decision "
                          "windows")
    srv.add_argument("--mpc-replicas", type=int, default=4,
                     help="seeded shadow rollouts per candidate action")
    srv.add_argument("--mpc-max-regret", type=float, default=1.0,
                     help="oracle regret gate ($ from the proven "
                          "optimum) a tuned weight vector must pass "
                          "before canary eligibility")
    srv.add_argument("--mpc-dry-run", action="store_true",
                     help="score and record every MPC window but never "
                          "actuate — the observe-only A/B arm")
    srv.add_argument("--mpc-no-tune", action="store_true",
                     help="disable the background CEM weight tuner "
                          "(plan pool/shed actions only)")
    srv.add_argument("--trace-out", default="", metavar="PATH",
                     help="write the service's causal trace timeline "
                          "(every job's arrival→completion chain, "
                          "dispatch spans, autoscaler actions) as "
                          "Perfetto/Chrome trace_event JSON to PATH "
                          "(plus PATH.jsonl raw events); render with "
                          "tools/obs_report.py or load in ui.perfetto.dev")
    srv.add_argument("--metrics-out", default="", metavar="PATH",
                     help="export the unified metrics registry "
                          "(SLO counters, latency summaries, dispatch "
                          "mix, autoscaler actions) as Prometheus text "
                          "exposition to PATH (plus PATH.json)")
    srv.add_argument("--metrics-port", type=int, default=0, metavar="N",
                     help="serve the registry's Prometheus text "
                          "exposition LIVE at http://127.0.0.1:N"
                          "/metrics (stdlib HTTP thread, thread-guarded "
                          "snapshot; /metrics.json for the JSON form). "
                          "0 = off")
    srv.add_argument("--profile-dispatch", type=int, default=0,
                     metavar="N",
                     help="sampled device-dispatch profiler: time every "
                          "Nth kernel dispatch to completion (a CUDA "
                          "event synchronised after it) at the dispatch "
                          "boundaries, publishing per-family latency "
                          "summaries into the registry and 'device' "
                          "lane spans into --trace-out.  Placements "
                          "are bit-identical either way.  0 = off")
    sub.add_parser(
        "worker",
        help="resident what-if worker: serve repeated CLI requests from "
             "stdin in one warm process (one JSON argv array per line), "
             "amortizing the torch import, the CUDA context, the kernel "
             "library's load and the graph captures across queries — see "
             "run_worker",
    )
    args = parser.parse_args(argv)
    if (
        getattr(args, "realtime_scoring", False)
        or getattr(args, "realtime", False)
    ) and args.policy != "cost-aware":
        parser.error(
            "--realtime-score/--realtime apply to the cost-aware arm only "
            "— no other policy scores on bandwidth"
        )
    if args.command == "serve":
        _check_serve_args(parser, args)
    if args.batch_runs > 1:
        if args.device != "cuda":
            parser.error("--batch-runs coalesces device-kernel dispatches — "
                         "it requires --device cuda")
        if args.workers > 1:
            parser.error("--batch-runs and --workers are mutually exclusive "
                         "(the lock-step driver already runs the grid "
                         "concurrently)")
        # Adaptive routing is timing-dependent: it would make batch
        # membership nondeterministic.
        args.adaptive = False
    if args.network == "native":
        from pivot_tpu_torch import native

        if not native.available():
            parser.exit(
                1,
                "error: --network native needs a working g++ toolchain "
                "(native build failed); use --network python\n",
            )
    return args


def _check_serve_args(parser, args) -> None:
    """The ``serve`` checks of ``pivot_tpu/experiments/cli.py:735-770``
    and ``:1650-1654`` (``--shard-hosts``, a run-time exit there), with
    ``cuda`` for ``tpu``."""
    if args.shard_hosts and args.device != "cuda":
        parser.error(
            "--shard-hosts needs a device-backed policy (--device cuda); "
            "numpy policies have no sharded form"
        )
    if args.tier_mix and (args.source == "trace" or args.closed_loop):
        parser.error(
            "--tier-mix generates its own synthetic mixed-tier Poisson "
            "stream — it cannot be combined with --source trace or "
            "--closed-loop (the trace/closed-loop jobs would be "
            "silently replaced)"
        )
    if args.mpc and args.autoscale:
        parser.error(
            "--mpc and --autoscale are mutually exclusive: two "
            "supervisors resizing the same pool would fight (the "
            "MPC planner subsumes the autoscaler's grow/drain)"
        )
    if not args.mpc and (
        args.mpc_pool or args.mpc_dry_run or args.mpc_no_tune
    ):
        parser.error("--mpc-* options require --mpc")
    if args.device == "cuda":
        # Shared-dispatch serving needs deterministic routing: adaptive
        # timing-based twin routing would make batch membership (and, in
        # float32, placements) nondeterministic.
        args.adaptive = False
    if args.profile_dispatch and args.device != "cuda":
        # The profiler brackets DEVICE dispatches; a numpy/naive policy
        # has none, so the run would silently produce an empty census.
        parser.error(
            "--profile-dispatch requires --device cuda (the numpy/naive "
            "policies dispatch no kernels for the profiler to bracket)"
        )


def _add_tick_order(sub_parser, default="fifo"):
    """The ``--tick-order`` flag of the estimator subcommands."""
    sub_parser.add_argument(
        "--tick-order", default=default, choices=["fifo", "lifo"],
        help="within-tick batch order: 'fifo' (task-index, bit-stable "
             "throughput default) or 'lifo' (exact DES popitem-queue "
             f"emulation; default: {default})",
    )


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


def _run_grid(specs: List[RunSpec], workers: int,
              batch_runs: int = 1) -> List[Optional[dict]]:
    """Execute runs sequentially, across ``workers`` spawned processes
    (summaries are then not returned: ``None`` each), or — with
    ``batch_runs > 1`` — in lock-step chunks (:func:`_run_grid_batched`).
    Summaries come back in spec order, ``None`` for a skipped run."""
    if batch_runs > 1:
        return _run_grid_batched(specs, batch_runs)
    if workers <= 1:
        return [_execute_run(spec) for spec in specs]
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with ctx.Pool(workers) as pool:
        pool.map(_execute_run, specs)
    return [None] * len(specs)


def _run_grid_batched(specs: List[RunSpec],
                      batch_runs: int) -> List[Optional[dict]]:
    """Lock-step chunks of ≤ ``batch_runs`` same-arm runs
    (``pivot_tpu/experiments/cli.py:869-899``): grouped by arm before
    chunking, since only same-kernel, same-config calls share a flush;
    completed runs are skipped up front."""
    from pivot_tpu_torch.experiments.runner import run_grid_lockstep

    results: List[Optional[dict]] = [None] * len(specs)
    by_label: dict = {}
    for i, spec in enumerate(specs):
        if _is_complete(spec):
            logger.info("skipping completed run %s (%s)",
                        spec.policy.display_label, spec.data_dir)
            continue
        by_label.setdefault(spec.policy.display_label, []).append(i)
    if any(specs[i].profile_dir for idxs in by_label.values()
           for i in idxs):
        logger.warning(
            "--profile-dir is ignored under --batch-runs (the device "
            "profiler is process-global; concurrent run sessions collide)"
        )
    for label, idxs in by_label.items():
        for i in range(0, len(idxs), batch_runs):
            chunk = idxs[i:i + batch_runs]
            stats: dict = {}
            out = run_grid_lockstep([_build_run(specs[j]) for j in chunk],
                                    stats_out=stats)
            for j, summary in zip(chunk, out):
                results[j] = summary
            logger.info("lockstep chunk %s[%d:%d]: %s",
                        label, i, i + len(chunk), stats)
    return results


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
                args.trace_events, args.audit, str(torch_device), dtype,
                args.profile_dir)
        for sub, n in counts
        for i, trace in enumerate(traces)
        for pc in policy_set
    ]
    logger.info("%s: %d runs (%d traces × %d policies) → %s", kind,
                len(specs), len(traces), len(policy_set), exp_dir)
    return exp_dir, _run_grid(specs, args.workers, args.batch_runs)


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


#: The sweeps' segment length: ``pivot_tpu``'s unsharded fallback
#: (``_maybe_shard_sweep``) runs them in 256-tick device calls; the port's
#: segments are loops of the same length, the same bits as one loop.
SWEEP_SEGMENT_TICKS = 256


def _replica_devices(device) -> list:
    """The devices the CLI's replica mesh spans for a run on ``device``:
    the visible cards when it is a card (``parallel.mesh.visible_cards``,
    ``pivot_tpu``'s ``jax.devices()``), none on the CPU (the reference
    runs its CPU backend unsharded: a mesh of CPU "devices" shares the
    cores)."""
    import torch

    from pivot_tpu_torch.parallel.mesh import visible_cards

    return visible_cards() if torch.device(device).type == "cuda" else []


def _maybe_shard_sweep(sweep_fn, device, **static_kw):
    """Shard a what-if sweep over the visible cards
    (``parallel.ensemble.shard_sweep``; ``pivot_tpu/experiments/
    cli.py:957-968``).  One card or the CPU — or, logged, an indivisible
    replica count or several distinct cards (a mesh over them is
    ROADMAP.md Queue 1, several cards) — falls back to the unsharded sweep in
    :data:`SWEEP_SEGMENT_TICKS`-tick segments."""
    from pivot_tpu_torch.parallel.ensemble import shard_sweep

    return shard_sweep(sweep_fn, fallback_segment_ticks=SWEEP_SEGMENT_TICKS,
                       devices=_replica_devices(device), **static_kw)


def _fault_outages(args) -> Optional[str]:
    """``"fault outages"`` where a run draws Exp(mttr) outages (the C
    library's ``log`` in float64), else None."""
    return "fault outages" if args.faults and args.fault_mttr is not None \
        else None


def _ensemble_setup(args, torch_device: str, dtype: str,
                    host_libm: Optional[str] = None):
    """``(trace, schedule, workload, topo, avail0, storage_zones)`` on
    ``torch_device``: the trace→tensors preamble of ``ensemble`` and the
    sweeps.  Refuses float64 off the CPU where the run needs the C
    library's float64 ``log`` / ``pow`` (``host_libm`` names the feature;
    ``parallel/ensemble/libm.py``), then resolves the device (no card, no
    run) and turns TF32 matmuls off: the egress bill's product is not
    exact in TF32."""
    import torch

    from pivot_tpu_torch.experiments.calibrate import (
        ensemble_inputs_from_schedule,
    )
    from pivot_tpu_torch.ops.kernels import resolve_device
    from pivot_tpu_torch.parallel.ensemble.libm import require_host
    from pivot_tpu_torch.workload.trace import load_trace_jobs

    if host_libm is not None:
        require_host(getattr(torch, dtype), torch_device, host_libm)
    device = resolve_device(torch_device)
    torch.backends.cuda.matmul.allow_tf32 = False
    trace = _list_traces(args.job_dir, 1)[0]
    schedule = load_trace_jobs(trace, args.scale_factor).take(args.num_apps)
    cluster = build_cluster(_cluster_config(args))
    workload, _slices, _arrivals, topo, avail0, storage_zones = (
        ensemble_inputs_from_schedule(schedule, cluster,
                                      dtype=getattr(torch, dtype),
                                      device=device))
    return trace, schedule, workload, topo, avail0, storage_zones


def _draw(*figures) -> List[str]:
    """Draw each ``(plots function name, *args)`` and return the paths.
    Without matplotlib, write one line to stderr naming the figures not
    drawn and return none: the run's data files and exit code stay as
    they are."""
    import importlib.util
    import sys

    if importlib.util.find_spec("matplotlib") is None:
        print("figures not drawn (matplotlib is not installed): "
              + ", ".join(f"{name}({', '.join(map(str, a))})"
                          for name, *a in figures), file=sys.stderr)
        return []
    from pivot_tpu_torch.experiments import plots

    return [getattr(plots, name)(*a) for name, *a in figures]


def _write_summary(args, name: str, summary: dict,
                   stats: Optional[dict]) -> str:
    out_dir = os.path.join(args.output_dir, name, str(int(time.time())))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    if stats is not None:
        stats["out_dir"] = out_dir
    return out_dir


def run_ensemble(args, torch_device: str = "cuda", dtype: str = "float32",
                 stats: Optional[dict] = None) -> dict:
    """BASELINE config 5: ``--replicas`` perturbed what-if replicas of a
    trace workload.  Routed as ``pivot_tpu/experiments/cli.py:1026-1066``:
    with ``--checkpoint``, one visible card or on the CPU it runs
    unsharded (``rollout_chunked``); over a mesh of several replica
    shards it runs ``sharded_rollout`` on ``replica_mesh`` and ignores
    ``--replica-chunk``, with a warning.  Several distinct cards run
    unsharded too, logged: a mesh over them is ROADMAP.md Queue 1,
    several cards.
    Writes ``rollout.npz`` and ``summary.json`` (the keys of
    ``pivot_tpu``'s) and returns the summary; ``stats``, when given,
    gains the rollout's tick-loop counts (``parallel.ensemble.rollout``).
    Draws the makespan distribution
    (``plots.plot_ensemble_distribution``)."""
    import numpy as np

    from pivot_tpu_torch.ops.shard import one_device
    from pivot_tpu_torch.parallel.ensemble import (
        prng,
        rollout_chunked,
        sharded_rollout,
    )
    from pivot_tpu_torch.parallel.mesh import replica_mesh

    trace, schedule, workload, topo, avail0, storage_zones = (
        _ensemble_setup(args, torch_device, dtype,
                        _fault_outages(args)))
    apps = schedule.apps
    key = prng.PRNGKey(args.seed)
    kw = dict(
        n_replicas=args.replicas,
        tick=args.tick,
        max_ticks=args.max_ticks,
        perturb=args.perturb,
        n_faults=args.faults,
        fault_horizon=args.fault_horizon,
        mttr=args.fault_mttr,
        policy=args.policy,
        congestion=args.congestion or args.realtime_scoring,
        realtime_scoring=args.realtime_scoring,
        tick_order=args.tick_order,
        stats=stats,
    )
    wall0 = time.perf_counter()
    devices = _replica_devices(avail0.device)
    single_device = bool(args.checkpoint) or len(devices) <= 1
    if not single_device and not one_device(devices):
        logger.info(
            "ensemble runs unsharded: %d distinct devices (a mesh over "
            "several cards is not ported yet: ROADMAP.md Queue 1, several "
            "cards)",
            len(devices))
        single_device = True
    replica_chunk = args.replica_chunk
    if replica_chunk and not single_device:
        # Chunking is a one-card working-set remedy; the sharded path
        # already splits the replica axis over the cards.
        logger.warning(
            "--replica-chunk ignored: %d-device mesh takes the sharded "
            "rollout path, which already splits replicas across chips",
            len(devices),
        )
        replica_chunk = 0
    if single_device:
        res = rollout_chunked(key, avail0, workload, topo, storage_zones,
                              args.checkpoint, replica_chunk, **kw)
    else:
        res = sharded_rollout(replica_mesh(devices=devices), key, avail0,
                              workload, topo, storage_zones, **kw)
    mk = res.makespan.cpu().numpy()
    eg = res.egress_cost.cpu().numpy()
    ih = res.instance_hours.cpu().numpy()
    finish = res.finish_time.cpu().numpy()
    placement = res.placement.cpu().numpy()
    unfinished = int(res.n_unfinished.max().item())
    wall = time.perf_counter() - wall0
    summary = {
        "trace": os.path.basename(trace),
        "n_apps": len(apps),
        "n_tasks": workload.n_tasks,
        "n_hosts": args.n_hosts,
        "replicas": args.replicas,
        "replica_chunk": replica_chunk,
        "perturb": args.perturb,
        "policy": args.policy,
        "faults": args.faults,
        "fault_horizon": args.fault_horizon,
        "fault_mttr": args.fault_mttr,
        "congestion": args.congestion or args.realtime_scoring,
        "realtime_scoring": args.realtime_scoring,
        "devices": max(len(devices), 1),
        "makespan_mean": float(mk.mean()),
        "makespan_p5": float(np.percentile(mk, 5)),
        "makespan_p95": float(np.percentile(mk, 95)),
        "egress_mean": float(eg.mean()),
        "egress_p95": float(np.percentile(eg, 95)),
        "instance_hours_mean": float(ih.mean()),
        "instance_hours_p95": float(np.percentile(ih, 95)),
        "unfinished_max": unfinished,
        "wall_s": round(wall, 3),
        "replica_rollouts_per_sec": round(args.replicas / wall, 2),
    }
    out_dir = _write_summary(args, "ensemble", summary, stats)
    np.savez(
        os.path.join(out_dir, "rollout.npz"),
        makespan=mk,
        egress_cost=eg,
        instance_hours=ih,
        finish_time=finish,
        placement=placement,
    )
    _draw(("plot_ensemble_distribution", out_dir))
    print(json.dumps(summary))
    return summary


def run_calibrate(args, torch_device: str = "cuda",
                  stats: Optional[dict] = None) -> dict:
    """Estimator-fidelity report: the DES against the ensemble on the
    first trace (``experiments/calibrate.py::calibrate``), the estimator
    on ``torch_device`` (TF32 off).  Writes ``report.json`` under
    ``<output-dir>/calibrate/<stamp>/`` and prints the report as the
    first line of stdout; returns it.  ``stats``, when given, gains each
    mode's rollout counts and ``out_dir``.  A ``--des-seeds`` /
    ``--cluster-seeds`` report's spread figure is drawn after the report
    (``plots.plot_calibration_spread``; its path is printed)."""
    from pivot_tpu_torch.experiments.calibrate import calibrate

    trace = _list_traces(args.job_dir, 1)[0]
    multi_cluster = args.cluster_seeds > 1
    report = calibrate(
        trace,
        cluster=None if multi_cluster else build_cluster(
            _cluster_config(args)),
        cluster_config=_cluster_config(args) if multi_cluster else None,
        n_apps=args.num_apps,
        policy=args.policy,
        scale_factor=args.scale_factor,
        seed=args.seed,
        tick=args.tick,
        max_ticks=args.max_ticks,
        replicas=args.replicas,
        perturb=args.perturb,
        realtime=args.realtime,
        x64=args.x64,
        des_seeds=args.des_seeds,
        cluster_seeds=args.cluster_seeds,
        tick_order=args.tick_order,
        device=torch_device,
        stats=stats,
    )
    out_dir = os.path.join(args.output_dir, "calibrate",
                           str(int(time.time())))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    if stats is not None:
        stats["out_dir"] = out_dir
    print(json.dumps(report))
    # The figure's path AFTER the JSON document: the first stdout line is
    # the report.
    if "clusters" in report or "des_per_seed" in report:
        for path in _draw(("plot_calibration_spread", out_dir)):
            print(path)
    return report


def _host(res):
    """A sweep's ``[K, R]`` results on the host: makespan, egress,
    instance-hours and the per-candidate worst unfinished count."""
    return (res.makespan.cpu().numpy(), res.egress_cost.cpu().numpy(),
            res.instance_hours.cpu().numpy(),
            res.n_unfinished.amax(1).cpu().numpy())


def run_autotune(args, torch_device: str = "cuda", dtype: str = "float32",
                 stats: Optional[dict] = None) -> dict:
    """K-candidate × R-replica search over the cost-aware score
    exponents (``score_param_sweep``), candidates paired on the same
    draws.  Writes ``summary.json`` with ``pivot_tpu``'s keys and values;
    the winner minimises ``--objective`` among the candidates that finish
    the workload.  No figure is drawn (as in the reference).  ``stats``
    as in ``run_ensemble``."""
    import itertools

    import numpy as np

    from pivot_tpu_torch.parallel.ensemble import prng, score_param_sweep

    trace, schedule, workload, topo, avail0, storage_zones = (
        _ensemble_setup(args, torch_device, dtype, "score exponents"))
    grid = list(itertools.product(args.exponents, repeat=3))
    if (1.0, 1.0, 1.0) not in grid:
        grid.append((1.0, 1.0, 1.0))  # the reference shape is measured
    grid = np.array(grid, dtype=np.float32)  # [K, 3] (w_cost, w_bw, w_norm)

    wall0 = time.perf_counter()
    sweep = _maybe_shard_sweep(
        score_param_sweep, avail0.device, n_replicas=args.replicas,
        tick=args.tick, max_ticks=args.max_ticks, perturb=args.perturb,
        congestion=args.congestion, tick_order=args.tick_order)
    res = sweep(prng.PRNGKey(args.seed), avail0, workload, topo,
                storage_zones, grid, stats=stats)
    mk, eg, _ih, unfinished = _host(res)
    wall = time.perf_counter() - wall0
    mk, eg = mk.mean(axis=1), eg.mean(axis=1)
    objective = mk if args.objective == "makespan" else eg
    objective = np.where(unfinished > 0, np.inf, objective)
    order = np.argsort(objective, kind="stable")
    ref_idx = int(np.where((grid == 1.0).all(axis=1))[0][0])

    def row(k):
        return {"exponents": [float(x) for x in grid[k]],
                "makespan_mean": float(mk[k]), "egress_mean": float(eg[k]),
                "unfinished_max": int(unfinished[k])}

    candidates = [row(k) for k in order]
    best = candidates[0] if np.isfinite(objective).any() else None
    if best is None:
        logger.warning("all %d candidates left tasks unfinished at the "
                       "horizon — no winner; raise --max-ticks", len(grid))
    summary = {
        "trace": os.path.basename(trace),
        "n_apps": len(schedule.apps),
        "n_tasks": workload.n_tasks,
        "n_hosts": args.n_hosts,
        "replicas": args.replicas,
        "perturb": args.perturb,
        "congestion": args.congestion,
        "objective": args.objective,
        "grid_size": len(grid),
        "rollouts": len(grid) * args.replicas,
        "wall_s": round(wall, 3),
        "best": best,
        "reference": row(ref_idx),
        "candidates": candidates,
    }
    _write_summary(args, "autotune", summary, stats)
    print(json.dumps({k: v for k, v in summary.items() if k != "candidates"}))
    return summary


def _clamped_makespan(args, mk, unfinished):
    """Mean makespan per candidate, clamped up to the horizon where a
    candidate left tasks unfinished (max finish over done tasks would
    understate it)."""
    import numpy as np

    return np.where(unfinished > 0,
                    np.maximum(mk.mean(axis=1), args.tick * args.max_ticks),
                    mk.mean(axis=1))


def run_capacity(args, torch_device: str = "cuda", dtype: str = "float32",
                 stats: Optional[dict] = None) -> dict:
    """K cluster sizes × R replicas in one batch (``capacity_sweep``);
    reports two cost columns per size — ``busy_cost_mean`` (busy
    instance-hours, the reference's financial model) and
    ``total_cost_mean`` (provisioned hosts × makespan + egress) — and
    picks the cheapest size by provisioned cost that finishes the
    workload (within ``--slo-makespan``).  Writes ``summary.json`` with
    ``pivot_tpu``'s keys and values, and draws the cost/makespan
    frontier (``plots.plot_capacity_frontier``)."""
    import numpy as np

    from pivot_tpu_torch.parallel.ensemble import (
        capacity_grid,
        capacity_sweep,
        prng,
    )

    if max(args.host_counts) > args.n_hosts:
        raise SystemExit(
            f"error: --host-counts max {max(args.host_counts)} exceeds "
            f"--num-hosts {args.n_hosts}")
    trace, schedule, workload, topo, avail0, storage_zones = (
        _ensemble_setup(args, torch_device, dtype,
                        _fault_outages(args)))
    grid = capacity_grid(avail0, args.host_counts)

    wall0 = time.perf_counter()
    sweep = _maybe_shard_sweep(
        capacity_sweep, avail0.device,
        n_replicas=args.replicas, tick=args.tick, max_ticks=args.max_ticks,
        perturb=args.perturb, policy=args.policy,
        congestion=args.congestion or args.realtime_scoring,
        realtime_scoring=args.realtime_scoring, n_faults=args.faults,
        fault_horizon=args.fault_horizon, mttr=args.fault_mttr,
        tick_order=args.tick_order)
    res = sweep(prng.PRNGKey(args.seed), grid, workload, topo,
                storage_zones, stats=stats)
    mk, eg, ih, unfinished = _host(res)
    wall = time.perf_counter() - wall0

    mk_mean = _clamped_makespan(args, mk, unfinished)
    hosts = np.asarray(args.host_counts, dtype=np.float64)
    busy_cost = ih.mean(axis=1) * args.host_hourly_rate + eg.mean(axis=1)
    provisioned_hours = hosts * mk_mean / 3600.0
    total_cost = provisioned_hours * args.host_hourly_rate + eg.mean(axis=1)
    candidates = [
        {
            "hosts": int(n),
            "makespan_mean": float(mk_mean[k]),
            "makespan_p95": float(np.percentile(mk[k], 95)),
            "egress_mean": float(eg[k].mean()),
            "instance_hours_mean": float(ih[k].mean()),
            "busy_cost_mean": float(busy_cost[k]),
            "provisioned_hours_mean": float(provisioned_hours[k]),
            "total_cost_mean": float(total_cost[k]),
            "unfinished_max": int(unfinished[k]),
        }
        for k, n in enumerate(args.host_counts)
    ]
    feasible = [c for c in candidates if c["unfinished_max"] == 0 and (
        args.slo_makespan is None
        or c["makespan_mean"] <= args.slo_makespan)]
    best = min(feasible, key=lambda c: c["total_cost_mean"], default=None)
    if best is None:
        logger.warning(
            "no candidate size finishes the workload%s — raise "
            "--host-counts or --max-ticks",
            "" if args.slo_makespan is None else " within the SLO")
    summary = {
        "trace": os.path.basename(trace),
        "n_apps": len(schedule.apps),
        "n_tasks": workload.n_tasks,
        "policy": args.policy,
        "replicas": args.replicas,
        "perturb": args.perturb,
        "congestion": args.congestion or args.realtime_scoring,
        "realtime_scoring": args.realtime_scoring,
        "faults": args.faults,
        "fault_horizon": args.fault_horizon,
        "fault_mttr": args.fault_mttr,
        "host_hourly_rate": args.host_hourly_rate,
        "slo_makespan": args.slo_makespan,
        "rollouts": len(args.host_counts) * args.replicas,
        "wall_s": round(wall, 3),
        "best": best,
        "candidates": candidates,
    }
    out_dir = _write_summary(args, "capacity", summary, stats)
    _draw(("plot_capacity_frontier", out_dir))
    print(json.dumps(summary))
    return summary


def run_apps(args, torch_device: str = "cuda", dtype: str = "float32",
             stats: Optional[dict] = None) -> dict:
    """Workload-size sweep per policy arm (``workload_sweep``): one batch
    per arm over the sorted, deduplicated app counts × R replicas; an
    arm's makespan is clamped to the horizon where it left tasks
    unfinished.  Writes ``summary.json`` with ``pivot_tpu``'s keys and
    values, and draws the cost-vs-apps figure (``plots.plot_apps_cost``)."""
    from pivot_tpu_torch.parallel.ensemble import prng, workload_sweep

    args.num_apps = max(args.app_counts)
    trace, schedule, workload, topo, avail0, storage_zones = (
        _ensemble_setup(args, torch_device, dtype))
    n_loaded = len(schedule.apps)
    counts = sorted({n for n in args.app_counts if n <= n_loaded})
    if len(counts) < len(set(args.app_counts)):
        logger.warning("trace has only %d apps — dropping larger counts",
                       n_loaded)

    wall0 = time.perf_counter()
    arms = {}
    for policy in args.policies:
        sweep = _maybe_shard_sweep(
            workload_sweep, avail0.device, n_replicas=args.replicas,
            tick=args.tick, max_ticks=args.max_ticks, perturb=args.perturb,
            policy=policy, congestion=args.congestion,
            tick_order=args.tick_order)
        res = sweep(prng.PRNGKey(args.seed), avail0, workload, topo,
                    storage_zones, counts, stats=stats)
        mk, eg, ih, unfinished = _host(res)
        mk_mean = _clamped_makespan(args, mk, unfinished)
        arms[policy] = [
            {
                "n_apps": int(n),
                "makespan_mean": float(mk_mean[k]),
                "egress_mean": float(eg[k].mean()),
                "instance_hours_mean": float(ih[k].mean()),
                "host_cost_mean": float(ih[k].mean()
                                        * args.host_hourly_rate),
                "unfinished_max": int(unfinished[k]),
            }
            for k, n in enumerate(counts)
        ]
    wall = time.perf_counter() - wall0
    summary = {
        "trace": os.path.basename(trace),
        "n_hosts": args.n_hosts,
        "app_counts": counts,
        "replicas": args.replicas,
        "perturb": args.perturb,
        "congestion": args.congestion,
        "host_hourly_rate": args.host_hourly_rate,
        "rollouts": len(counts) * args.replicas * len(args.policies),
        "wall_s": round(wall, 3),
        "arms": arms,
    }
    out_dir = _write_summary(args, "apps", summary, stats)
    _draw(("plot_apps_cost", out_dir))
    print(json.dumps(summary))
    return summary


def run_search_cli(args, torch_device: str = "cuda",
                   dtype: str = "float32") -> dict:
    """The ``search`` subcommand: run the learn → hold out → regret
    pipeline (``experiments/search.py``), print the report JSON and write
    it to ``--out`` when given; returns the report.  Its environments
    live on ``torch_device`` in ``dtype``.  Before anything runs or is
    written, float64 off the CPU raises (``libm.require_host``: every
    candidate rides the score-exponent pow path), ``cuda`` without a
    card raises, and TF32 matmuls are turned off (the egress bill's
    product is not exact in TF32).  ``--backend sharded_rollout`` builds
    a replica mesh over the visible cards (``pivot_tpu/experiments/
    cli.py:1939-1946``; on the CPU a mesh of one shard) and gives the
    ``rollout`` backend's report."""
    import torch

    from pivot_tpu_torch.experiments.search import (
        load_config,
        run_search_experiment,
    )
    from pivot_tpu_torch.ops.kernels import resolve_device
    from pivot_tpu_torch.parallel.ensemble.libm import require_host

    kw = dict(
        method=args.method,
        generations=args.generations,
        popsize=args.popsize,
        seed=args.seed,
        n_hosts=args.hosts,
        n_apps=args.num_apps,
        horizon=args.horizon,
        n_replicas=args.replicas,
        holdout=args.holdout,
        backend=args.backend,
        bad_init=args.bad_init,
        oracle=not args.no_oracle,
        des_validate=args.des_validate,
    )
    if args.config:
        kw.update(load_config(args.config))
    require_host(getattr(torch, dtype), torch_device,
                 "search scores (score exponents)")
    device = resolve_device(torch_device)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = None
    if kw["backend"] == "sharded_rollout":
        from pivot_tpu_torch.parallel.mesh import replica_mesh

        mesh = replica_mesh(devices=_replica_devices(device) or [device])
    report = run_search_experiment(device=device, mesh=mesh,
                                   dtype=getattr(torch, dtype), **kw)
    text = json.dumps(report, indent=2, sort_keys=True)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return report


def run_serve_stream(args, torch_device: str = "cuda",
                     dtype: str = "float32") -> dict:
    """The online serving layer (``pivot_tpu_torch.serve``,
    ``pivot_tpu/experiments/cli.py:1614``): G always-on scheduling
    sessions fed by a streaming arrival source through a bounded
    admission queue; device-backed sessions (``--device cuda``, the
    default, their torch tensors on ``torch_device`` in ``dtype``) share
    their co-pending per-tick dispatches — and, with ``--fuse-spans
    slo``, their spans, ragged unless ``--no-ragged`` — through
    idle-aware, deadline-flushed ``DispatchBatcher`` slots: a coalesced
    Cost-Aware flush is one per-row launch of ``greedy_place``.  With
    ``--resident`` the sessions run free, each on its resident span
    carry, arrivals up to ``--splice-tier`` joining running spans.  With
    ``--shard-hosts S`` every session is host-sharded over the hybrid
    ``replica × host`` mesh of the visible cards and the batcher runs on
    it (on one card only S = 1 divides).  Prints (and writes
    ``<output-dir>/serve/<stamp>/report.json``) the service report: SLO
    snapshot, batcher stats, per-session metrics."""
    from pivot_tpu_torch.obs import (
        DispatchProfiler,
        MetricsHTTPServer,
        MetricsRegistry,
        Tracer,
    )
    from pivot_tpu_torch.serve import (
        AutoscaleConfig,
        ServeDriver,
        ServeSession,
        closed_loop_source,
        mixed_tier_arrivals,
        poisson_arrivals,
        synthetic_app_factory,
        trace_arrivals,
    )

    arm = dict(name=args.policy, device=args.device, adaptive=args.adaptive)
    if args.policy == "cost-aware":
        arm.update(bin_pack="first-fit", sort_tasks=True, sort_hosts=True)
    elif args.policy == "first-fit":
        arm.update(decreasing=True)  # the reference's VBP arm
    pcfg = PolicyConfig(**arm)
    # 2-D mesh serving (``pivot_tpu/experiments/cli.py:1644-1665``):
    # --shard-hosts S builds the hybrid replica × host mesh once over the
    # visible devices (the cards; the one CPU device off the card),
    # shards every session policy's host axis over it and hands it to the
    # driver, whose batcher runs coalesced flushes on it.
    mesh = None
    if args.shard_hosts:
        import torch

        from pivot_tpu_torch.parallel.mesh import (
            build_hybrid_mesh,
            visible_cards,
        )

        dev = torch.device(torch_device)
        mesh = build_hybrid_mesh(
            host_parallel=args.shard_hosts,
            devices=visible_cards() if dev.type == "cuda" else [dev])
    fuse = "slo" if args.fuse_spans == "slo" else False

    def make_session(label):
        policy = make_policy(pcfg, torch_device=torch_device, dtype=dtype)
        if mesh is not None:
            policy.enable_sharding(mesh)
        return ServeSession(
            label,
            build_cluster(_cluster_config(args)),
            policy,
            seed=args.seed,
            fuse_spans=fuse,
        )

    sessions = [make_session(f"session-{g}") for g in range(args.sessions)]
    flush_after = (args.flush_after_us or 0) / 1e6 or None

    def _csv(text, cast):
        return tuple(cast(x) for x in text.split(",")) if text else None

    autoscale = None
    if args.autoscale:
        try:
            g_min, g_max = (int(x) for x in args.autoscale.split(":"))
        except ValueError:
            raise SystemExit(
                f"--autoscale wants GMIN:GMAX, got {args.autoscale!r}"
            )
        autoscale = AutoscaleConfig(
            g_min=g_min, g_max=g_max, slo_p99_s=args.slo_p99_ms / 1e3,
        )
    mpc = None
    if args.mpc:
        import torch

        from pivot_tpu_torch.mpc import MpcConfig

        if args.mpc_pool:
            try:
                mpc_min, mpc_max = (
                    int(x) for x in args.mpc_pool.split(":")
                )
            except ValueError:
                raise SystemExit(
                    f"--mpc-pool wants GMIN:GMAX, got {args.mpc_pool!r}"
                )
        else:
            mpc_min = mpc_max = args.sessions
        tier_weights = _csv(args.tier_mix, float)
        mpc = MpcConfig(
            check_interval_s=args.mpc_interval_ms / 1e3,
            horizon=args.mpc_horizon,
            n_replicas=args.mpc_replicas,
            seed=args.seed or 0,
            g_min=mpc_min,
            g_max=mpc_max,
            n_tiers=max(len(tier_weights), 1) if tier_weights else 1,
            max_regret=args.mpc_max_regret,
            dry_run=args.mpc_dry_run,
            tune=not args.mpc_no_tune,
        )
        # The planner's evaluator needs full-f32 products (its egress
        # bill), as ``search`` does: TF32 off for the whole service.
        torch.backends.cuda.matmul.allow_tf32 = False
    tracer = Tracer() if args.trace_out else None
    registry = (
        MetricsRegistry()
        if args.metrics_out or args.metrics_port else None
    )
    # --profile-dispatch N samples the device dispatches.
    profiler = (
        DispatchProfiler(
            sample_every=args.profile_dispatch, seed=args.seed or 0,
            registry=registry,
        )
        if args.profile_dispatch else None
    )
    driver = ServeDriver(
        sessions,
        queue_depth=args.queue_depth,
        backpressure=args.backpressure,
        flush_after=flush_after,
        tier_reserve=_csv(args.tier_reserve, int),
        tier_policies=_csv(args.tier_policies, str),
        routing=args.routing.replace("-", "_"),
        preempt=args.preempt,
        session_factory=(
            make_session if (autoscale or mpc) else None
        ),
        autoscale=autoscale,
        mpc=mpc,
        tracer=tracer,
        registry=registry,
        profiler=profiler,
        mesh=mesh,
        tenant_quota=args.tenant_quota or None,
        ragged=not args.no_ragged,
        resident=args.resident,
        splice_tier=args.splice_tier,
    )
    metrics_server = None
    if args.metrics_port:
        # Live scrape endpoint: every GET re-publishes the service's
        # current state into the registry and renders the exposition.
        def _render_text() -> str:
            driver.publish_metrics(registry)
            return registry.to_prometheus()

        def _render_json() -> dict:
            return driver.publish_metrics(registry) or {}

        metrics_server = MetricsHTTPServer(
            _render_text, _render_json, port=args.metrics_port
        )
        metrics_server.start()
    if args.closed_loop:
        arrivals = closed_loop_source(
            driver, synthetic_app_factory(seed=args.seed),
            args.closed_loop, args.jobs,
        )
    elif args.tier_mix:
        arrivals = mixed_tier_arrivals(
            args.arrival_rate, args.jobs,
            weights=_csv(args.tier_mix, float), seed=args.seed,
        )
    elif args.source == "trace":
        arrivals = trace_arrivals(
            _list_traces(args.job_dir, 1)[0], n_apps=args.jobs,
            scale_factor=args.scale_factor, rate=args.arrival_rate or None,
            seed=args.seed,
        )
    else:
        arrivals = poisson_arrivals(
            args.arrival_rate, args.jobs, seed=args.seed
        )
    wall0 = time.perf_counter()
    try:
        report = driver.run(arrivals, pace=args.pace or None)
    finally:
        if metrics_server is not None:
            metrics_server.stop()
    wall = time.perf_counter() - wall0
    report["wall_s"] = round(wall, 3)
    report["decisions_per_sec"] = round(
        report["slo"]["counters"]["decisions"] / max(wall, 1e-9), 1
    )
    out_dir = os.path.join(args.output_dir, "serve", str(int(time.time())))
    os.makedirs(out_dir, exist_ok=True)
    if tracer is not None:
        tracer.save_perfetto(args.trace_out)
        tracer.save_jsonl(args.trace_out + ".jsonl")
        report["trace_out"] = args.trace_out
        report["trace_events"] = len(tracer.events)
    if metrics_server is not None:
        report["metrics_port"] = metrics_server.port
    if registry is not None and args.metrics_out:
        driver.publish_metrics(registry)
        registry.save_prometheus(args.metrics_out)
        registry.save_json(args.metrics_out + ".json")
        report["metrics_out"] = args.metrics_out
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))
    return report


_serving = False


def run_worker() -> None:
    """Resident what-if worker (``pivot_tpu/experiments/cli.py:1834``):
    one process serves many CLI requests, paying the per-process costs
    once — the torch import, the CUDA context, the ``greedy_place``
    library's load (and its build on a fresh checkout) and the ensemble's
    CUDA-graph captures.  After the first request, repeated queries run
    warm.

    Protocol (the reference's): one JSON argv array per stdin line,
    exactly as the one-shot CLI would receive it, e.g.
    ``["--num-hosts", "100", "ensemble", "--num-apps", "25"]``.  The
    request's normal output prints to stdout, followed by one sentinel
    line ``{"served": n, "ok": ..., "wall_s": ...}``.  Id counters reset
    per request, so every report is bit-identical to the same request in
    a fresh process.  An argparse rejection or an exception answers
    ``ok: false`` (an exception also prints ``{"error": ...}``) and the
    loop goes on; a nested ``worker`` request is refused; ``quit`` or EOF
    ends the loop.
    """
    import sys

    from pivot_tpu_torch.utils import reset_ids

    global _serving
    if _serving:
        # A request whose parsed command is `worker` dispatches back here
        # through main(); reading stdin recursively would deadlock.
        raise RuntimeError("nested worker requests are not allowed")
    _serving = True
    served = 0
    try:
        for line in sys.stdin:
            line = line.strip()
            if line == "quit":
                break
            if not line:
                continue
            t0 = time.perf_counter()
            ok = True
            try:
                req = json.loads(line)
                if not isinstance(req, list) or not all(
                    isinstance(a, str) for a in req
                ):
                    raise ValueError(
                        "request must be a JSON array of argv strings"
                    )
                reset_ids()  # fresh-process determinism per request
                main(req)
            except SystemExit as exc:  # argparse rejection — keep serving
                ok = (exc.code or 0) == 0
            except Exception as exc:  # noqa: BLE001 — request isolation
                ok = False
                print(json.dumps(
                    {"error": f"{type(exc).__name__}: {exc}"[:300]}),
                    flush=True)
            served += 1
            print(json.dumps({
                "served": served,
                "ok": ok,
                "wall_s": round(time.perf_counter() - t0, 3),
            }), flush=True)
    finally:
        _serving = False


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.command == "worker":
        run_worker()
        return
    if args.command == "sensitivity":
        run_sensitivity(args)
        return
    if args.command == "search":
        run_search_cli(args)
        return
    if args.command == "serve":
        run_serve_stream(args)
        return
    sweeps = {"ensemble": run_ensemble, "calibrate": run_calibrate,
              "autotune": run_autotune, "capacity": run_capacity,
              "apps": run_apps}
    if args.command in sweeps:
        sweeps[args.command](args)
        return
    run = run_num_apps if args.command == "num-apps" else run_overall
    exp_dir, _ = run(args)
    print(exp_dir)
    if args.command == "overall":
        figures = (("plot_overall", exp_dir), ("plot_transfers", exp_dir))
    else:
        figures = (("plot_financial_cost", exp_dir, args.host_hourly_rate),)
    for path in _draw(*figures):
        print(path)


if __name__ == "__main__":
    main()
