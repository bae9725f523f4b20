"""The DES comparison metrics shared by the experiments.

Port of ``pivot_tpu/experiments/calibrate.py``, cut to :func:`des_metrics`
(``:79-92``), the one metric definition the sensitivity report shares
with the calibration harness.  The rest of the calibration harness runs
on the ensemble rollouts and waits for them (ROADMAP.md, port queue).
"""

from __future__ import annotations

__all__ = ["des_metrics"]


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
