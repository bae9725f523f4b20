"""The DES comparison metrics and the trace→ensemble-inputs bridge.

Port of ``pivot_tpu/experiments/calibrate.py``, cut to
:func:`ensemble_inputs_from_schedule` (``:37-76``), the bridge the
``ensemble`` subcommand builds its rollout inputs with, and
:func:`des_metrics` (``:79-92``), the one metric definition the
sensitivity report shares with the calibration harness.  The harness
itself (``calibrate``) is not ported yet (ROADMAP.md Queue 1, the rest of
the ensemble).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

__all__ = ["des_metrics", "ensemble_inputs_from_schedule"]


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
