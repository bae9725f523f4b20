"""Analysis plots over experiment output directories.

Port of ``pivot_tpu/experiments/plots.py`` (numpy and matplotlib only: a
copy with the import paths rewritten).  The experiment CLI draws them
where the reference's does; on a machine without matplotlib it names the
figures it did not draw on stderr and writes its data files as before
(``experiments/cli.py::_draw``).

Capability parity with the reference's three figures
(``alibaba/sim.py:55-165``), reading the same on-disk layout
(``<exp_dir>/data/<iter>/<label>/{general,transfers}.json``):

  * :func:`plot_overall`        — egress cost / host cost / app runtime per
    scheduler, normalized to the per-metric max (ref ``overall.pdf``).
  * :func:`plot_transfers`      — per-task data-transfer time split into
    transmission (propagation) vs congestion (queueing) (ref
    ``transfer.pdf``).
  * :func:`plot_financial_cost` — total host + egress $ vs number of apps
    (ref ``financial-cost.pdf``; host $ = instance-hours × hourly rate).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List

import numpy as np

__all__ = [
    "collect_general",
    "plot_overall",
    "plot_transfers",
    "plot_financial_cost",
    "plot_host_usage",
    "plot_resource_usage",
    "plot_ensemble_distribution",
    "plot_capacity_frontier",
    "plot_apps_cost",
    "plot_calibration_spread",
    "POLICY_ORDER",
]

POLICY_ORDER = ["Opportunistic", "Cost-Aware", "VBP"]
METRIC_ORDER = ["egress_cost", "cum_instance_hours", "avg_runtime"]
METRIC_LABELS = ["egress cost", "host cost", "app. runtime"]

#: Fixed per-policy colors (entity-stable: the same arm keeps its color no
#: matter which subset of arms a figure shows), covering both the display
#: labels the DES experiments use and the policy names the estimator uses.
ENTITY_COLORS = {
    "Opportunistic": "C0", "opportunistic": "C0",
    "Cost-Aware": "C1", "cost-aware": "C1",
    "VBP": "C2", "first-fit": "C2",
    "best-fit": "C3",
}


def _plot_cost_lines(series, ylabel: str, out: str) -> str:
    """Shared cost-vs-#apps renderer (solid = host $, dashed = egress $).

    ``series``: label → list of (n_apps, egress, host) rows, any order —
    rows are sorted by n_apps here.  Used by :func:`plot_financial_cost`
    (DES results) and :func:`plot_apps_cost` (estimator results) so the
    two analog figures cannot drift.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    markers = ["x", "+", "1", "2", "3"]
    plt.figure(figsize=(8, 5))
    items = sorted(series.items())
    # Solid (host) and dashed (egress) twins of one arm must share a
    # color; a label outside ENTITY_COLORS would otherwise get two
    # different auto-cycle colors (separate plot calls), so capture the
    # solid line's assigned color and reuse it for the dashed twin.
    label_colors = dict(ENTITY_COLORS)
    for solid in (True, False):
        for i, (label, rows) in enumerate(items):
            rows = sorted(rows)
            xs = [r[0] for r in rows]
            ys = [r[2] if solid else r[1] for r in rows]
            (line,) = plt.plot(
                xs, ys,
                ls="-" if solid else "--",
                color=label_colors.get(label),
                marker=markers[i % len(markers)], markersize=11,
                label=f"{label} ({'host' if solid else 'egress'})",
            )
            label_colors.setdefault(label, line.get_color())
    plt.xlabel("# of running applications", fontsize=13)
    plt.ylabel(ylabel, fontsize=13)
    plt.legend(ncol=2, frameon=False, fontsize=10)
    plt.tight_layout()
    plt.savefig(out)
    plt.close()
    return out


def _iterdirs(path: str) -> List[str]:
    return sorted(d for d in os.listdir(path) if os.path.isdir(os.path.join(path, d)))


def collect_general(data_dir: str) -> Dict[str, Dict[str, list]]:
    """label → metric → [value per iteration]."""
    metrics: Dict[str, Dict[str, list]] = defaultdict(lambda: defaultdict(list))
    for it in _iterdirs(data_dir):
        for label in _iterdirs(os.path.join(data_dir, it)):
            with open(os.path.join(data_dir, it, label, "general.json")) as f:
                for k, v in json.load(f).items():
                    metrics[label][k].append(v)
    return metrics


def plot_overall(exp_dir: str) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data_dir, plot_dir = os.path.join(exp_dir, "data"), os.path.join(exp_dir, "plot")
    os.makedirs(plot_dir, exist_ok=True)
    metrics = collect_general(data_dir)
    labels = [l for l in POLICY_ORDER if l in metrics] + [
        l for l in sorted(metrics) if l not in POLICY_ORDER
    ]
    # Tolerate partial grids (a crashed run): use the common iteration count.
    n_iter = min(len(metrics[l][METRIC_ORDER[0]]) for l in labels)
    if n_iter == 0:
        raise SystemExit(f"no complete iterations under {data_dir}")
    # Normalize each (metric, iteration) column to its max across labels.
    norm = {l: [] for l in labels}
    for key in METRIC_ORDER:
        per_label = {l: metrics[l][key] for l in labels}
        vals = np.zeros(len(labels))
        for i in range(n_iter):
            col_max = max(per_label[l][i] for l in labels)
            for j, l in enumerate(labels):
                vals[j] += per_label[l][i] / col_max if col_max else 0.0
        for j, l in enumerate(labels):
            norm[l].append(vals[j] / n_iter)

    width, gap = 0.25, 0.1
    hatches = ["/", "+", "-", "x", "."]
    x = np.arange(len(METRIC_ORDER)) * (width + gap) * len(labels)
    plt.figure(figsize=(7, 4))
    for j, label in enumerate(labels):
        plt.bar(x + width * j, norm[label], width=width, label=label,
                hatch=hatches[j % len(hatches)])
    plt.xticks(x + width * len(labels) / 2 - gap, METRIC_LABELS, fontsize=13)
    plt.ylim(0, 1.15)
    plt.ylabel("Cost/runtime norm. to max.", fontsize=13)
    plt.legend(ncol=3, frameon=False, fontsize=11)
    plt.tight_layout()
    out = os.path.join(plot_dir, "overall.pdf")
    plt.savefig(out, format="pdf")
    plt.close()
    return out


def plot_transfers(exp_dir: str) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data_dir, plot_dir = os.path.join(exp_dir, "data"), os.path.join(exp_dir, "plot")
    os.makedirs(plot_dir, exist_ok=True)
    split: Dict[str, list] = defaultdict(list)
    for it in _iterdirs(data_dir):
        for label in _iterdirs(os.path.join(data_dir, it)):
            with open(os.path.join(data_dir, it, label, "transfers.json")) as f:
                transfers = json.load(f)
            if not transfers:
                split[label].append((0.0, 0.0))
                continue
            prop = float(np.mean([t["propagation_delay"] for t in transfers]))
            queue = float(
                np.mean([t["total_delay"] - t["propagation_delay"] for t in transfers])
            )
            split[label].append((prop, queue))
    labels = [l for l in POLICY_ORDER if l in split] + [
        l for l in sorted(split) if l not in POLICY_ORDER
    ]
    prop = np.array([np.mean([v[0] for v in split[l]]) for l in labels])
    queue = np.array([np.mean([v[1] for v in split[l]]) for l in labels])

    y = np.arange(len(labels)) * 0.25
    plt.figure(figsize=(7, 3))
    plt.barh(y, prop, height=0.2, hatch="/", label="Transmission")
    plt.barh(y, queue, height=0.2, left=prop, hatch="-", label="Congestion")
    plt.yticks(y, labels, rotation=45, fontsize=12)
    plt.xlabel("Data transfer time per task (seconds)", fontsize=12)
    plt.legend(ncol=2, frameon=False, fontsize=11)
    plt.tight_layout()
    out = os.path.join(plot_dir, "transfer.pdf")
    plt.savefig(out, format="pdf")
    plt.close()
    return out


def plot_financial_cost(exp_dir: str, host_hourly_rate: float = 0.932) -> str:
    data_dir, plot_dir = os.path.join(exp_dir, "data"), os.path.join(exp_dir, "plot")
    os.makedirs(plot_dir, exist_ok=True)
    # layout: data/<n_apps>/<iter>/<label>/general.json
    metrics: Dict[str, Dict[int, list]] = defaultdict(lambda: defaultdict(list))
    for n_apps in _iterdirs(data_dir):
        for it in _iterdirs(os.path.join(data_dir, n_apps)):
            for label in _iterdirs(os.path.join(data_dir, n_apps, it)):
                with open(
                    os.path.join(data_dir, n_apps, it, label, "general.json")
                ) as f:
                    g = json.load(f)
                metrics[label][int(n_apps)].append(
                    (g["egress_cost"], g["cum_instance_hours"] * host_hourly_rate)
                )
    series = {
        label: [
            (
                n,
                float(np.mean([v[0] for v in vals])) / 1000,
                float(np.mean([v[1] for v in vals])) / 1000,
            )
            for n, vals in per_n.items()
        ]
        for label, per_n in metrics.items()
    }
    return _plot_cost_lines(
        series, "Total host/egress cost ($1K)",
        os.path.join(plot_dir, "cost.pdf"),
    )


def plot_ensemble_distribution(run_dir: str, out: str = None) -> str:
    """Replica-distribution figure for one ensemble run: the empirical CDF
    of makespan across Monte-Carlo replicas, with the p5/p50/p95 quantiles
    marked.  Reads the ``rollout.npz`` the ``ensemble`` subcommand writes.

    No reference analog: the reference has one trajectory per (seeded) run
    and nothing to take a distribution over.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with np.load(os.path.join(run_dir, "rollout.npz")) as arrs:
        mk = np.sort(np.asarray(arrs["makespan"], dtype=np.float64))
    frac = np.arange(1, len(mk) + 1) / len(mk)
    plt.figure(figsize=(7, 4))
    plt.step(mk, frac, where="post", linewidth=2)
    for q, name in ((5, "p5"), (50, "p50"), (95, "p95")):
        v = float(np.percentile(mk, q))
        plt.axvline(v, color="0.6", linewidth=1, linestyle=":")
        plt.text(v, 0.03, f" {name}={v:.0f}s", fontsize=10, color="0.35",
                 rotation=90, va="bottom")
    plt.xlabel(f"Makespan (s) across {len(mk)} replicas", fontsize=13)
    plt.ylabel("Fraction of replicas", fontsize=13)
    plt.ylim(0, 1.02)
    plt.grid(axis="y", color="0.9", linewidth=0.8)
    plt.tight_layout()
    out = out or os.path.join(run_dir, "makespan_cdf.pdf")
    plt.savefig(out)
    plt.close()
    return out


def plot_capacity_frontier(run_dir: str, out: str = None) -> str:
    """Cost/makespan frontier over candidate cluster sizes: provisioned
    total cost vs mean makespan, one point per size (direct-labeled),
    connected in host-count order.  Reads the ``summary.json`` the
    ``capacity`` subcommand writes.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    cands = sorted(summary["candidates"], key=lambda c: c["hosts"])
    done = [c for c in cands if c["unfinished_max"] == 0]
    trunc = [c for c in cands if c["unfinished_max"] > 0]
    plt.figure(figsize=(7, 4))
    # Only finished candidates form the frontier line; horizon-truncated
    # sizes (clamped lower bounds, not measurements) sit apart as ×.
    plt.plot([c["makespan_mean"] for c in done],
             [c["total_cost_mean"] for c in done],
             marker="o", markersize=8, linewidth=2)
    if trunc:
        plt.scatter([c["makespan_mean"] for c in trunc],
                    [c["total_cost_mean"] for c in trunc],
                    marker="x", s=80, color="0.45", zorder=3)
    plt.margins(x=0.15, y=0.15)  # keep point annotations inside the axes
    for c in cands:
        suffix = "" if c["unfinished_max"] == 0 else " (unfinished ≥)"
        plt.annotate(f'{c["hosts"]} hosts{suffix}',
                     (c["makespan_mean"], c["total_cost_mean"]), fontsize=10,
                     textcoords="offset points", xytext=(8, 6))
    best = summary.get("best")
    if best:
        plt.scatter([best["makespan_mean"]], [best["total_cost_mean"]],
                    s=160, facecolors="none", edgecolors="0.2", linewidths=1.5,
                    zorder=3)
    plt.xlabel("Mean makespan (s)", fontsize=13)
    plt.ylabel("Provisioned cost ($)", fontsize=13)
    plt.title("hosts × makespan × hourly rate + egress", fontsize=10,
              color="0.35")
    plt.grid(color="0.9", linewidth=0.8)
    plt.tight_layout()
    out = out or os.path.join(run_dir, "capacity_frontier.pdf")
    plt.savefig(out)
    plt.close()
    return out


def plot_calibration_spread(run_dir: str, out: str = None) -> str:
    """Distributional-calibration figure: DES vs estimator per sample.

    Reads the ``report.json`` a distributional ``calibrate`` run writes
    (``--cluster-seeds N``: one sample per generated cluster;
    ``--des-seeds N`` on one cluster: one sample per DES policy seed) and
    plots, per metric, the DES's per-sample values against the
    estimator's — making the bias-vs-chaos separation visible: a stable
    estimator line through a scattered DES cloud is bias; tracking
    scatter is fidelity.  No reference analog (single engine, no
    estimator to calibrate).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(os.path.join(run_dir, "report.json")) as f:
        report = json.load(f)

    metrics = ["egress_cost", "instance_hours", "avg_runtime"]
    labels = ["egress cost ($)", "instance hours", "app. runtime (s)"]
    if "clusters" in report:
        samples = report["clusters"]
        xlabel = "cluster seed sample"
        modes = [m for m in ("static", "congested", "realtime") if m in samples[0]]
        des_pts = {k: [c["des"][k] for c in samples] for k in metrics}
        est_pts = {
            (m, k): [c[m][k] for c in samples] for m in modes for k in metrics
        }
        summary = report.get("cluster_summary", {})
    elif "des_per_seed" in report:
        samples = report["des_per_seed"]
        xlabel = "DES policy seed sample"
        modes = [m for m in ("static", "congested", "realtime") if m in report]
        des_pts = {k: [d[k] for d in samples] for k in metrics}
        # One estimator run vs N DES seeds: a flat line per mode.
        est_pts = {
            (m, k): [report[m][k]] * len(samples)
            for m in modes
            for k in metrics
        }
        summary = {}
    else:
        raise ValueError(
            "report has neither 'clusters' nor 'des_per_seed' — run "
            "calibrate with --cluster-seeds or --des-seeds > 1"
        )

    x = np.arange(len(samples))
    mode_marks = {"static": "s", "congested": "^", "realtime": "v"}
    fig, axes = plt.subplots(1, len(metrics), figsize=(4 * len(metrics), 3.6))
    for ax, k, lab in zip(axes, metrics, labels):
        ax.plot(x, des_pts[k], marker="o", linewidth=1.5, color="0.25",
                label="DES")
        for m in modes:
            ax.plot(x, est_pts[(m, k)], marker=mode_marks[m], linewidth=1.2,
                    linestyle="--", label=f"estimator ({m})")
        title = lab
        s = summary.get(modes[0], {}).get(k) if summary else None
        if s and s.get("mean_rel_err") is not None:
            title += (
                f"\n{modes[0]} rel err {100 * s['mean_rel_err']:+.0f}%"
                f" ± {100 * s['std_rel_err']:.0f}%"
            )
        ax.set_title(title, fontsize=11)
        ax.set_xlabel(xlabel, fontsize=11)
        ax.set_xticks(x)
        ax.grid(color="0.9", linewidth=0.8)
    axes[0].legend(fontsize=9, frameon=False)
    fig.suptitle(
        f"{report['policy']} @ {report['n_hosts']} hosts — DES spread vs "
        "estimator", fontsize=12,
    )
    fig.tight_layout()
    out = out or os.path.join(run_dir, "calibration_spread.pdf")
    fig.savefig(out)
    plt.close(fig)
    return out


def plot_apps_cost(run_dir: str, out: str = None) -> str:
    """Estimator analog of the reference's financial-cost figure
    (``alibaba/sim.py:132-165``): host/egress $ vs workload size per
    policy arm, from the ``apps`` subcommand's ``summary.json`` —
    rendered through the same :func:`_plot_cost_lines` body as the DES
    figure, with entity-stable per-policy colors.
    """
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    series = {
        policy: [
            (r["n_apps"], r["egress_mean"], r["host_cost_mean"])
            for r in rows
        ]
        for policy, rows in summary["arms"].items()
    }
    return _plot_cost_lines(
        series, "Mean host/egress cost ($)",
        out or os.path.join(run_dir, "apps_cost.pdf"),
    )


def plot_host_usage(run_dir: str, out: str = None) -> str:
    """Busy-host count over time for one run — renders the curve the meter
    serializes as ``host_usage.json`` (ref ``resources/meter.py:135-148``).

    ``run_dir`` is a ``data/<iter>/<label>`` directory.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(os.path.join(run_dir, "host_usage.json")) as f:
        usage = json.load(f)
    xs = [end for _start, end in usage["timestamps"]]
    plt.figure(figsize=(8, 4))
    plt.step(xs, usage["n_hosts"], where="pre")
    plt.xlabel("Simulation time (s)", fontsize=13)
    plt.ylabel("# of busy hosts", fontsize=13)
    plt.tight_layout()
    out = out or os.path.join(run_dir, "host_usage.pdf")
    plt.savefig(out, format="pdf")
    plt.close()
    return out


def plot_resource_usage(meter, resources=("cpus", "mem"), out: str = "resource_usage.pdf") -> str:
    """Mean normalized per-dimension host utilization over time, from a live
    :class:`~pivot_tpu_torch.infra.meter.Meter` (ref ``resources/meter.py:150-159``
    — the reference likewise plots this from the in-memory meter; it is not
    part of the serialized four-file layout)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(8, 4))
    for res in resources:
        xs, ys = meter.resource_usage_curve(res)
        plt.plot(xs, ys, label=res)
    plt.xlabel("Simulation time (s)", fontsize=13)
    plt.ylabel("Mean normalized utilization", fontsize=13)
    plt.ylim(0, 1)
    plt.legend(frameon=False)
    plt.tight_layout()
    plt.savefig(out, format="pdf")
    plt.close()
    return out
