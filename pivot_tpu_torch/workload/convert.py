"""Convert sampled Alibaba job YAML traces into columnar ``.npz`` archives.

The YAML schema (one list entry per job — ref ``alibaba/jobs/*.yaml``,
``alibaba/sample.py:197-199``) parses slowly (~seconds per 3 MB file); the
columnar form loads in milliseconds and is the canonical on-disk workload
format of this framework.  Layout (all arrays index-aligned):

  jobs:   ``job_id`` [J] str, ``submit_time`` [J] f64, ``finish_time`` [J]
          f64, ``task_start`` [J+1] i64 (CSR offsets into the task arrays)
  tasks:  ``task_id`` [T] i64, ``cpus`` [T] f32, ``mem`` [T] f32,
          ``n_instances`` [T] i32, ``runtime`` [T] f32,
          ``dep_start`` [T+1] i64, ``deps`` [D] i64 (CSR of task-id deps)

Usage:  python -m pivot_tpu_torch.workload.convert SRC.yaml... --out-dir DIR

Port of ``pivot_tpu/workload/convert.py`` (JAX-free, copied with its
import paths rewritten); ``yaml`` is imported where a file is read.
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np

__all__ = ["convert_yaml_trace", "main"]


def convert_yaml_trace(yaml_path: str, npz_path: str) -> dict:
    import yaml

    with open(yaml_path) as f:
        jobs = yaml.safe_load(f)

    job_id: List[str] = []
    submit_time: List[float] = []
    finish_time: List[float] = []
    task_start = [0]
    task_id: List[int] = []
    cpus: List[float] = []
    mem: List[float] = []
    n_instances: List[int] = []
    runtime: List[float] = []
    dep_start = [0]
    deps: List[int] = []

    for j in jobs:
        job_id.append(str(j["id"]))
        submit_time.append(float(j["submit_time"]))
        finish_time.append(float(j.get("finish_time", 0)))
        for t in j["tasks"]:
            task_id.append(int(t["id"]))
            cpus.append(float(t["cpus"]))
            mem.append(float(t["mem"]))
            n_instances.append(int(t["n_instances"]))
            runtime.append(float(t["runtime"]))
            deps.extend(int(d) for d in t.get("dependencies", ()))
            dep_start.append(len(deps))
        task_start.append(len(task_id))

    arrays = {
        "job_id": np.array(job_id),
        "submit_time": np.array(submit_time, dtype=np.float64),
        "finish_time": np.array(finish_time, dtype=np.float64),
        "task_start": np.array(task_start, dtype=np.int64),
        "task_id": np.array(task_id, dtype=np.int64),
        "cpus": np.array(cpus, dtype=np.float32),
        "mem": np.array(mem, dtype=np.float32),
        "n_instances": np.array(n_instances, dtype=np.int32),
        "runtime": np.array(runtime, dtype=np.float32),
        "dep_start": np.array(dep_start, dtype=np.int64),
        "deps": np.array(deps, dtype=np.int64),
    }
    np.savez_compressed(npz_path, **arrays)
    return {"jobs": len(job_id), "tasks": len(task_id), "deps": len(deps)}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("sources", nargs="+", help="YAML trace files")
    parser.add_argument("--out-dir", required=True)
    args = parser.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for src in args.sources:
        base = os.path.splitext(os.path.basename(src))[0]
        dst = os.path.join(args.out_dir, base + ".npz")
        stats = convert_yaml_trace(src, dst)
        print(f"{src} -> {dst}: {stats}")


if __name__ == "__main__":
    main()
