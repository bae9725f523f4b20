"""Market-replay CLI: generate, re-run, and diff serialized MarketSchedules.

Port of ``tools/market_replay.py``: the same subcommands, flags, exit
codes and JSON files, run as ``python -m
pivot_tpu_torch.tools.market_replay``.  A pure DES consumer
(``pivot_tpu_torch/experiments/spot.py``): no device work.

  1. ``generate`` — draw a seeded :class:`MarketSchedule` (per-zone
     piecewise-constant price multipliers + preemption hazards) against
     the deterministic synthetic cluster and save it as JSON;
  2. ``run`` — load a saved market, play one arm of the spot-survival
     game (``pivot_tpu_torch.experiments.spot.run_spot_arm``:
     hazard-drawn preemption plan, risk-aware placement and/or proactive
     drain/migrate per flags), and write the full report — fault log,
     meter snapshot, cost-per-completed-task, dead-letter rate, audit
     violations.  Exit is non-zero when the audits flag anything;
  3. ``diff`` — compare two market files (trace-level diff) or two run
     reports (field-by-field).  Two ``run`` reports from the same
     (market, seed, arm) must be IDENTICAL — any diff is a determinism
     regression, and the exit code says so.

Examples::

    python -m pivot_tpu_torch.tools.market_replay generate --seed 3 \
        --hosts 12 --horizon 600 --out /tmp/market.json
    python -m pivot_tpu_torch.tools.market_replay run \
        --market /tmp/market.json --hosts 12 --seed 3 --risk-weight 1.0 \
        --rework-cost 50 --proactive --out /tmp/arm_a.json
    python -m pivot_tpu_torch.tools.market_replay diff /tmp/arm_a.json \
        /tmp/arm_b.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def cmd_generate(args) -> int:
    from pivot_tpu_torch.experiments.spot import spot_market

    market = spot_market(
        args.hosts,
        seed=args.seed,
        horizon=args.horizon,
        n_segments=args.segments,
        hot_fraction=args.hot_fraction,
        hot_hazard=args.hot_hazard,
        hot_discount=args.hot_discount,
        base_hazard=args.base_hazard,
        price_vol=args.price_vol,
    )
    market.save(args.out)
    print(
        f"wrote {market.n_segments} segments x {len(market.zones)} zones "
        f"to {args.out} ({len(market.meta.get('hot_zones', []))} hot)"
    )
    return 0


def cmd_run(args) -> int:
    from pivot_tpu_torch.experiments.spot import run_spot_arm
    from pivot_tpu_torch.infra.market import MarketSchedule

    market = MarketSchedule.load(args.market)
    report = run_spot_arm(
        market,
        n_hosts=args.hosts,
        seed=args.seed,
        n_apps=args.apps,
        risk_weight=args.risk_weight,
        rework_cost=args.rework_cost,
        proactive=args.proactive,
        lead=args.lead,
        outage=args.outage,
        max_retries=args.max_retries,
        interval=args.interval,
    )
    report["market"] = os.path.abspath(args.market)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    violations = report["audit_violations"]
    status = "CLEAN" if not violations else f"{len(violations)} VIOLATIONS"
    cpt = report["cost_per_completed_task"]
    print(
        f"run complete: {report['n_completed_tasks']}/{report['n_tasks']} "
        f"tasks, {report['n_dead_letters']} dead-lettered, "
        f"cost/task {'n/a' if cpt is None else f'${cpt:.6f}'}, "
        f"audit {status} -> {args.out}"
    )
    return 0 if not violations else 1


def cmd_diff(args) -> int:
    with open(args.a) as f:
        a = json.load(f)
    with open(args.b) as f:
        b = json.load(f)
    if a.get("schema") == "market-schedule" and (
        b.get("schema") == "market-schedule"
    ):
        from pivot_tpu_torch.infra.market import MarketSchedule

        delta = MarketSchedule.from_dict(a).diff(MarketSchedule.from_dict(b))
        for line in delta:
            print(line)
        print("markets identical" if not delta else f"{len(delta)} diffs")
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

    g = sub.add_parser("generate", help="draw a seeded spot market")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--hosts", type=int, default=12)
    g.add_argument("--horizon", type=float, default=600.0)
    g.add_argument("--segments", type=int, default=6)
    g.add_argument("--hot-fraction", type=float, default=0.4)
    g.add_argument("--hot-hazard", type=float, default=2e-2)
    g.add_argument("--hot-discount", type=float, default=0.65)
    g.add_argument("--base-hazard", type=float, default=5e-4)
    g.add_argument("--price-vol", type=float, default=0.15)
    g.add_argument("--out", required=True)
    g.set_defaults(fn=cmd_generate)

    r = sub.add_parser(
        "run", help="play one spot-survival arm; write an audit report"
    )
    r.add_argument("--market", required=True)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--hosts", type=int, default=12)
    r.add_argument("--apps", type=int, default=10)
    r.add_argument("--risk-weight", type=float, default=0.0)
    r.add_argument("--rework-cost", type=float, default=1.0)
    r.add_argument("--proactive", action="store_true")
    r.add_argument("--lead", type=float, default=15.0)
    r.add_argument("--outage", type=float, default=100.0)
    r.add_argument("--max-retries", type=int, default=1)
    r.add_argument("--interval", type=float, default=5.0)
    r.add_argument("--out", required=True)
    r.set_defaults(fn=cmd_run)

    d = sub.add_parser("diff", help="diff two markets or two run reports")
    d.add_argument("a")
    d.add_argument("b")
    d.set_defaults(fn=cmd_diff)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
