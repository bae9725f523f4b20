"""Alibaba 2018 cluster-trace sampler: raw CSVs → windowed job files.

Capability parity with the reference's offline sampler
(``alibaba/sample.py:12-127``), which produced the bundled
``jobs-<n>-<p>-<start>-<end>`` files:

  * ``batch_task.csv`` rows carry the DAG in the task name — ``M1_2_3``
    means task id 1 depending on tasks 2 and 3; ``task...``/``MergeTask``
    names are standalone (ref ``:61-65``).  CPU demands are /100 (trace
    stores percent-of-core), memory stays normalized.
  * ``batch_instance.csv`` is streamed to attach per-task runtimes
    (mean-free: last instance wins, as in the reference ``:117-120``) and
    to filter jobs — instance runtime within [min, max], at least
    ``min_deps`` dependent tasks, fan-out ≤ ``max_parallel``, all declared
    dependencies present (ref ``:86-113``).
  * Surviving jobs are bucketed into ``interval``-second windows by first
    task start; each window holds at most ``n_jobs`` jobs and is written
    as ``jobs-{n}-{p}-{start}-{end}.yaml`` (ref ``:197-199``) and/or the
    framework's columnar ``.npz`` (``pivot_tpu_torch.workload.convert``).

Usage:
  python -m pivot_tpu_torch.experiments.sample -n 5000 -s 86400 -i 86400 \\
      --batch-task csv/batch_task.csv --batch-instance csv/batch_instance.csv \\
      -o data/jobs [--npz]

Port of ``pivot_tpu/experiments/sample.py`` (JAX-free, copied with its
import paths rewritten); ``yaml`` is imported where a file is written.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional

__all__ = ["parse_task_name", "load_job_dags", "sample_windows", "main"]


def parse_task_name(name: str):
    """Task name → (task_id, [dep ids]); None for standalone tasks."""
    if name.startswith("task") or name == "MergeTask":
        return name, []
    parts = [
        p for p in name[1:].strip().split("_") if p and not p.startswith("Stg")
    ]
    return int(parts[0]), [int(d) for d in parts[1:]]


def load_job_dags(batch_task_csv: str) -> Dict[str, dict]:
    """First pass: job DAG skeletons from batch_task.csv.

    A job with any Failed task row is excluded permanently — later rows of
    the same job must not resurrect it (exclusion is row-order independent).
    """
    jobs: Dict[str, dict] = {}
    failed = set()
    with open(batch_task_csv) as f:
        for line in f:
            fields = line.rstrip("\n").split(",")
            if len(fields) < 9:
                continue
            t_name, n_inst, j_name, _t_type, status, start, end, cpus, mem = fields[:9]
            if not (t_name and j_name and cpus and mem and start and end):
                continue
            if j_name in failed:
                continue
            if status == "Failed":
                failed.add(j_name)
                jobs.pop(j_name, None)
                continue
            job = jobs.setdefault(
                j_name,
                {"id": j_name, "tasks": {}, "submit_time": float("inf"), "finish_time": 0},
            )
            start, end = int(start), int(end)
            job["submit_time"] = min(job["submit_time"], start)
            job["finish_time"] = max(job["finish_time"], end)
            task_id, deps = parse_task_name(t_name)
            job["tasks"][task_id] = {
                "id": task_id,
                "cpus": float(cpus) / 100.0,
                "mem": float(mem),
                "n_instances": int(n_inst),
                "dependencies": deps,
                "start_time": start,
                "end_time": end,
            }
    return jobs


def _job_ok(job: dict, min_deps: int, max_parallel: int) -> bool:
    tasks = job["tasks"]
    if not tasks:
        return False
    if max(t["n_instances"] for t in tasks.values()) > max_parallel:
        return False
    if sum(1 for t in tasks.values() if t["dependencies"]) < min_deps:
        return False
    # Every declared dependency must resolve, and every task needs a runtime.
    for t in tasks.values():
        if "runtime" not in t or t["start_time"] >= t["end_time"]:
            return False
        for d in t["dependencies"]:
            if d not in tasks:
                return False
    return True


def sample_windows(
    batch_instance_csv: str,
    jobs: Dict[str, dict],
    n_jobs: int,
    start: int,
    interval: int,
    min_runtime: int = 60,
    max_runtime: int = 1000,
    min_deps: int = 1,
    max_parallel: int = 100,
    progress=None,
) -> Dict[int, list]:
    """Second pass: stream instances, attach runtimes, filter, window."""
    excluded = set()
    windows: Dict[int, dict] = {}
    placed_key: Dict[str, int] = {}
    with open(batch_instance_csv) as f:
        for line in f:
            fields = line.rstrip("\n").split(",")
            if len(fields) < 8:
                continue
            _, t_name, j_name, _, status, t_start, t_end, machine = fields[:8]
            if (
                not t_name
                or not j_name
                or j_name in excluded
                or j_name not in jobs
                or status == "Failed"
                or not t_start
                or not t_end
                or not machine
            ):
                continue
            t_start, t_end = int(t_start), int(t_end)
            if t_start <= 0 or t_end <= 0 or t_start >= t_end or t_end - t_start > max_runtime:
                excluded.add(j_name)
                for w in windows.values():
                    w.pop(j_name, None)
                continue
            job = jobs[j_name]
            task_id, _ = parse_task_name(t_name)
            task = job["tasks"].get(task_id)
            if task is None:
                excluded.add(j_name)
                continue
            task["start_time"], task["end_time"] = t_start, t_end
            task["runtime"] = t_end - t_start
            # Window membership is (re-)evaluated as runtimes accumulate.
            first = min(t["start_time"] for t in job["tasks"].values())
            last = max(t["end_time"] for t in job["tasks"].values())
            if first <= start or last - first < min_runtime:
                continue
            if not _job_ok(job, min_deps, max_parallel):
                continue
            key = first // interval * interval
            # A later instance row can shift the job's first start into a
            # different window — move it, never duplicate across windows.
            prev_key = placed_key.get(j_name)
            if prev_key is not None and prev_key != key:
                windows.get(prev_key, {}).pop(j_name, None)
                placed_key.pop(j_name)
            bucket = windows.setdefault(key, {})
            if j_name in bucket or len(bucket) < n_jobs:
                bucket[j_name] = job
                placed_key[j_name] = key
                if progress:
                    progress({k: len(v) for k, v in sorted(windows.items())})
            if windows and all(len(b) >= n_jobs for b in windows.values()):
                break
    # Finalize: strip bookkeeping fields.
    out: Dict[int, list] = {}
    for key, bucket in windows.items():
        fin = []
        for job in bucket.values():
            fin.append(
                {
                    "id": job["id"],
                    "submit_time": int(job["submit_time"]),
                    "finish_time": int(job["finish_time"]),
                    "tasks": [
                        {
                            "id": t["id"],
                            "cpus": t["cpus"],
                            "mem": t["mem"],
                            "n_instances": t["n_instances"],
                            "runtime": t["runtime"],
                            "dependencies": t["dependencies"],
                        }
                        for t in job["tasks"].values()
                    ],
                }
            )
        out[key] = fin
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--num-jobs", "-n", type=int, required=True)
    parser.add_argument("--min-runtime", "-l", type=int, default=60)
    parser.add_argument("--max-runtime", "-u", type=int, default=1000)
    parser.add_argument("--start", "-s", type=int, required=True)
    parser.add_argument("--interval", "-i", type=int, required=True)
    parser.add_argument("--min-deps", "-d", type=int, default=1)
    parser.add_argument("--max-parallel", "-p", type=int, default=100)
    parser.add_argument("--batch-task", default="csv/batch_task.csv")
    parser.add_argument("--batch-instance", default="csv/batch_instance.csv")
    parser.add_argument("--output-dir", "-o", required=True)
    parser.add_argument(
        "--npz", action="store_true", help="also write columnar .npz archives"
    )
    args = parser.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    print("loading job DAGs ...")
    jobs = load_job_dags(args.batch_task)
    print(f"{len(jobs)} candidate jobs; sampling ...")
    windows = sample_windows(
        args.batch_instance,
        jobs,
        args.num_jobs,
        args.start,
        args.interval,
        args.min_runtime,
        args.max_runtime,
        args.min_deps,
        args.max_parallel,
        progress=lambda c: print(f"\rsampled: {c}", end="", file=sys.stderr),
    )
    import yaml

    print(f"\nwriting {len(windows)} window files ...")
    for key, window_jobs in windows.items():
        base = f"jobs-{args.num_jobs}-{args.max_parallel}-{key}-{key + args.interval}"
        yaml_path = os.path.join(args.output_dir, base + ".yaml")
        with open(yaml_path, "w") as f:
            yaml.safe_dump(window_jobs, f, default_flow_style=False)
        if args.npz:
            from pivot_tpu_torch.workload.convert import convert_yaml_trace

            convert_yaml_trace(yaml_path, os.path.join(args.output_dir, base + ".npz"))
        print(f"  {base}: {len(window_jobs)} jobs")


if __name__ == "__main__":
    main()
