"""Chaos-replay CLI: generate, re-run, and diff serialized ChaosSchedules.

Port of ``tools/chaos_replay.py``: the same subcommands, flags, exit
codes and JSON files, run as ``python -m
pivot_tpu_torch.tools.chaos_replay``.  A pure DES consumer over the
port's numpy policies (``pivot_tpu_torch/infra/faults.py``): no device
work.

  1. ``generate`` — draw a seeded :class:`ChaosSchedule` against the
     deterministic synthetic cluster and save it as JSON;
  2. ``run`` — rebuild the same seeded world, apply a saved schedule,
     drive a synthetic workload through a retry-governed scheduler to
     completion, audit it (``infra/audit.py``: cluster, conservation,
     meter), and write the report — the fault log, the meter summary,
     dead letters, breaker trips and audit violations.  Exit is non-zero
     when the audit flags anything;
  3. ``diff`` — compare two schedule files or two run reports.  For
     schedules, device events are also rendered as the per-device down
     windows (``DeviceFaultPlan``) the elastic serving gate consumes.  Two
     ``run`` reports from the same (schedule, seed, cluster, workload)
     must be IDENTICAL — any diff is a determinism regression, and the
     exit code says so.

Examples::

    python -m pivot_tpu_torch.tools.chaos_replay generate --seed 7 \
        --hosts 12 --out /tmp/chaos.json
    python -m pivot_tpu_torch.tools.chaos_replay run \
        --schedule /tmp/chaos.json --hosts 12 --seed 7 --out /tmp/rep_a.json
    python -m pivot_tpu_torch.tools.chaos_replay run \
        --schedule /tmp/chaos.json --hosts 12 --seed 7 --out /tmp/rep_b.json
    python -m pivot_tpu_torch.tools.chaos_replay diff /tmp/rep_a.json \
        /tmp/rep_b.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _build_world(n_hosts: int, seed: int, interval: float,
                 max_retries: int, breaker_k: int):
    from pivot_tpu_torch.infra.meter import Meter
    from pivot_tpu_torch.sched import (
        GlobalScheduler,
        HostCircuitBreaker,
        RetryPolicy,
    )
    from pivot_tpu_torch.sched.policies import FirstFitPolicy
    from pivot_tpu_torch.utils import reset_ids
    from pivot_tpu_torch.utils.config import ClusterConfig, build_cluster

    reset_ids()  # host-N ids must match across replays
    cluster = build_cluster(ClusterConfig(n_hosts=n_hosts, seed=seed))
    meter = Meter(cluster.env, cluster.meta)
    cluster.meter = meter
    scheduler = GlobalScheduler(
        cluster.env,
        cluster,
        FirstFitPolicy(),
        interval=interval,
        seed=seed,
        meter=meter,
        retry=RetryPolicy(max_retries=max_retries, base=1.0, seed=seed),
        breaker=HostCircuitBreaker(k=breaker_k, cooldown=60.0),
    )
    cluster.start()
    scheduler.start()
    return cluster, scheduler, meter


def _synthetic_apps(n_apps: int, seed: int):
    import numpy as np

    from pivot_tpu_torch.workload import Application, TaskGroup

    rng = np.random.default_rng(seed)
    apps = []
    for i in range(n_apps):
        src = TaskGroup(
            "src", cpus=1, mem=256, runtime=float(rng.uniform(20, 60)),
            output_size=float(rng.uniform(100, 500)),
            instances=int(rng.integers(1, 4)),
        )
        dst = TaskGroup(
            "dst", cpus=1, mem=256, runtime=float(rng.uniform(20, 60)),
            dependencies=["src"],
        )
        apps.append(Application(f"chaos-app-{i}", [src, dst]))
    return apps


def cmd_generate(args) -> int:
    from pivot_tpu_torch.infra.faults import ChaosSchedule
    from pivot_tpu_torch.utils.config import ClusterConfig, build_cluster

    cluster = build_cluster(ClusterConfig(n_hosts=args.hosts, seed=args.seed))
    schedule = ChaosSchedule.generate(
        cluster,
        seed=args.seed,
        horizon=args.horizon,
        n_domain_outages=args.zone_outages,
        domain_level="zone",
        outage_duration=args.outage_duration,
        n_preemptions=args.preemptions,
        preempt_lead=args.preempt_lead,
        preempt_outage=args.outage_duration,
        n_stragglers=args.stragglers,
        straggler_factor=args.straggler_factor,
        straggler_duration=args.outage_duration,
        n_partitions=args.partitions,
        partition_duration=args.outage_duration,
    )
    schedule.save(args.out)
    print(f"wrote {len(schedule)} events to {args.out}: {schedule.counts()}")
    return 0


def cmd_run(args) -> int:
    from pivot_tpu_torch.infra.audit import (
        audit_cluster,
        audit_conservation,
        audit_meter,
    )
    from pivot_tpu_torch.infra.faults import ChaosSchedule, FaultInjector

    schedule = ChaosSchedule.load(args.schedule)
    cluster, scheduler, meter = _build_world(
        args.hosts, args.seed, args.interval, args.max_retries,
        args.breaker_k,
    )
    injector = FaultInjector(cluster, seed=args.seed)
    injector.apply_schedule(schedule)
    apps = _synthetic_apps(args.apps, args.seed)
    for app in apps:
        scheduler.submit(app)
    scheduler.stop()
    cluster.env.run()

    violations = (
        audit_cluster(cluster)
        + audit_conservation(scheduler, apps)
        + audit_meter(meter)
    )
    report = {
        "schedule": os.path.abspath(args.schedule),
        "seed": args.seed,
        "n_hosts": args.hosts,
        "n_apps": args.apps,
        "fault_log": [[t, target, ev] for t, target, ev in injector.log],
        "meter": meter.summary(),
        "dead_letters": [
            {
                "task": d.task_id, "app": d.app_id, "host": d.host_id,
                "reason": d.reason, "at": d.at, "attempts": d.attempts,
            }
            for d in scheduler.dead_letters
        ],
        "n_cancelled": scheduler.n_cancelled,
        "breaker_trips": [list(t) for t in scheduler.breaker.trips],
        "finished_apps": sum(a.is_finished for a in apps),
        "failed_apps": sum(a.failed for a in apps),
        "audit_violations": violations,
    }
    # wall_clock is the one legitimately non-deterministic field.
    report["meter"].pop("wall_clock", None)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    status = "CLEAN" if not violations else f"{len(violations)} VIOLATIONS"
    print(
        f"run complete: {report['finished_apps']}/{args.apps} apps finished, "
        f"{len(report['dead_letters'])} dead-lettered, audit {status} "
        f"-> {args.out}"
    )
    return 0 if not violations else 1


def _device_windows(schedule):
    """A schedule's device events as the down windows they imply
    (``DeviceFaultPlan.describe``), over ordinals up to the largest one
    named."""
    from pivot_tpu_torch.infra.faults import (
        ChaosEvent,
        DeviceFaultPlan,
        device_ordinal,
    )

    dev = [e for e in schedule.events if e.kind in ChaosEvent.DEVICE_KINDS]
    if not dev:
        return []
    n = 1 + max(device_ordinal(e.target) for e in dev)
    return DeviceFaultPlan.from_schedule(schedule, n).describe()


def cmd_diff(args) -> int:
    with open(args.a) as f:
        a = json.load(f)
    with open(args.b) as f:
        b = json.load(f)
    if "events" in a and "events" in b:  # two schedules
        from pivot_tpu_torch.infra.faults import ChaosSchedule

        sa, sb = ChaosSchedule.from_dict(a), ChaosSchedule.from_dict(b)
        delta = sa.diff(sb)
        for line in delta:
            print(line)
        # Device events also render as resolved down windows — the form
        # the elastic serving gate consumes — so a restore moved by one
        # event shows as the window it reshapes.
        wa, wb = set(_device_windows(sa)), set(_device_windows(sb))
        for w in sorted(wa - wb):
            print(f"- window {w}")
        for w in sorted(wb - wa):
            print(f"+ window {w}")
        delta += sorted(wa ^ wb)
        print("schedules identical" if not delta else f"{len(delta)} diffs")
        return 0 if not delta else 1
    # Two run reports: field-by-field.
    keys = sorted(set(a) | set(b))
    diffs = [k for k in keys if a.get(k) != b.get(k)]
    for k in diffs:
        print(f"field {k!r} differs:\n  a: {a.get(k)!r}\n  b: {b.get(k)!r}")
    print("reports identical" if not diffs else f"{len(diffs)} fields differ")
    return 0 if not diffs else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="draw a seeded chaos schedule")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--hosts", type=int, default=12)
    g.add_argument("--horizon", type=float, default=400.0)
    g.add_argument("--zone-outages", type=int, default=1)
    g.add_argument("--preemptions", type=int, default=2)
    g.add_argument("--preempt-lead", type=float, default=10.0)
    g.add_argument("--stragglers", type=int, default=1)
    g.add_argument("--straggler-factor", type=float, default=4.0)
    g.add_argument("--partitions", type=int, default=1)
    g.add_argument("--outage-duration", type=float, default=90.0)
    g.add_argument("--out", required=True)
    g.set_defaults(fn=cmd_generate)

    r = sub.add_parser("run", help="replay a schedule; write an audit report")
    r.add_argument("--schedule", required=True)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--hosts", type=int, default=12)
    r.add_argument("--apps", type=int, default=6)
    r.add_argument("--interval", type=float, default=5.0)
    r.add_argument("--max-retries", type=int, default=20)
    r.add_argument("--breaker-k", type=int, default=3)
    r.add_argument("--out", required=True)
    r.set_defaults(fn=cmd_run)

    d = sub.add_parser("diff", help="diff two schedules or two run reports")
    d.add_argument("a")
    d.add_argument("b")
    d.set_defaults(fn=cmd_diff)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
