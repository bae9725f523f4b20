"""Alibaba 2018 cluster-trace workload loading.

Capability parity with the reference's ``TraceBasedApplicationGenerator``
(``alibaba/runner.py:55-136``):

  * Job YAML schema: ``{id, submit_time, finish_time, tasks: [{id, cpus, mem,
    n_instances, runtime, dependencies}]}`` (ref ``alibaba/jobs/*.yaml``).
  * ``MEM_SCALE_FACTOR = 7.68 * 1024``: trace memory demands are normalized;
    assuming 96-core / 768 GB machines (r5d.24xlarge-equivalent) makes them
    absolute MB values (rationale documented at ``alibaba/runner.py:56-69``).
  * ``output_size = mem * output_size_scale_factor`` (ref
    ``alibaba/runner.py:97-100``) — a task's output data volume is modeled
    as proportional to its memory demand.

The loader itself is pure (file → sorted submission schedule); replaying the
schedule into a scheduler is the job of ``pivot_tpu_torch.experiments.runner``.
"""

from __future__ import annotations

from bisect import insort
from typing import List, Tuple

from pivot_tpu_torch.utils import LogMixin
from pivot_tpu_torch.workload import Application, TaskGroup

__all__ = ["MEM_SCALE_FACTOR", "load_trace_jobs", "TraceSchedule"]

MEM_SCALE_FACTOR = 7.68 * 1024  # normalized trace mem -> absolute MB


def _job_to_application(job: dict, output_size_scale_factor: float) -> Application:
    groups = []
    for t in job["tasks"]:
        groups.append(
            TaskGroup(
                str(t["id"]),
                cpus=float(t["cpus"]),
                mem=float(t["mem"]) * MEM_SCALE_FACTOR,
                output_size=float(t["mem"]) * output_size_scale_factor,
                runtime=float(t["runtime"]),
                instances=int(t["n_instances"]),
                dependencies=[str(d) for d in t.get("dependencies", ())],
            )
        )
    return Application(str(job["id"]), groups)


class TraceSchedule:
    """Submission schedule: a time-sorted list of (submit_time, [apps])."""

    def __init__(self, bins: List[Tuple[float, List[Application]]]):
        self.bins = bins

    @property
    def apps(self) -> List[Application]:
        return [a for _, apps in self.bins for a in apps]

    def __len__(self) -> int:
        return sum(len(apps) for _, apps in self.bins)

    def take(self, n_apps: int) -> "TraceSchedule":
        """First ``n_apps`` applications in submission order."""
        out, count = [], 0
        for ts, apps in self.bins:
            if count >= n_apps:
                break
            chunk = apps[: n_apps - count]
            out.append((ts, chunk))
            count += len(chunk)
        return TraceSchedule(out)


def _iter_yaml_jobs(trace_file: str):
    import yaml

    with open(trace_file) as f:
        yield from yaml.safe_load(f)


def _iter_npz_jobs(trace_file: str):
    """Stream jobs out of the columnar archive (see workload/convert.py)."""
    import numpy as np

    with np.load(trace_file, allow_pickle=False) as data:
        job_id = data["job_id"]
        submit = data["submit_time"]
        finish = data["finish_time"]
        tstart = data["task_start"]
        task_id = data["task_id"]
        cpus = data["cpus"]
        mem = data["mem"]
        n_inst = data["n_instances"]
        runtime = data["runtime"]
        dstart = data["dep_start"]
        deps = data["deps"]
    for j in range(len(job_id)):
        lo, hi = int(tstart[j]), int(tstart[j + 1])
        tasks = [
            {
                "id": int(task_id[t]),
                "cpus": float(cpus[t]),
                "mem": float(mem[t]),
                "n_instances": int(n_inst[t]),
                "runtime": float(runtime[t]),
                "dependencies": [
                    int(d) for d in deps[int(dstart[t]) : int(dstart[t + 1])]
                ],
            }
            for t in range(lo, hi)
        ]
        yield {
            "id": str(job_id[j]),
            "submit_time": float(submit[j]),
            "finish_time": float(finish[j]),
            "tasks": tasks,
        }


def load_trace_jobs(
    trace_file: str, output_size_scale_factor: float = 1000.0
) -> TraceSchedule:
    """Parse a sampled Alibaba trace (``.yaml`` or columnar ``.npz``) into a
    time-sorted submission schedule."""
    if trace_file.endswith(".npz"):
        jobs = _iter_npz_jobs(trace_file)
    else:
        jobs = _iter_yaml_jobs(trace_file)
    times: List[float] = []
    index = {}
    for job in jobs:
        app = _job_to_application(job, output_size_scale_factor)
        ts = float(job["submit_time"])
        if ts in index:
            index[ts].append(app)
        else:
            index[ts] = [app]
            insort(times, ts)
    return TraceSchedule([(ts, index[ts]) for ts in times])
