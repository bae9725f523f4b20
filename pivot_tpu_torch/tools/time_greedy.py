"""Time ``greedy_place``'s R = 1 call on the card: the wrapper the main
path calls (``cost_aware_cuda``) and the bare launch (``_launch`` on
checked operands), by CUDA events over back-to-back calls, at a small
tick (T = 16, 11 tasks) and the largest main-path tick (T = 2048, 619
tasks), H = 600, first-fit with sorted hosts.

    python -m pivot_tpu_torch.tools.time_greedy [--reps 200]

Prints the card's ``nvidia-smi`` name and power limit and one JSON line.
To compare two trees, copy this file into the other tree's
``pivot_tpu_torch/tools/`` and run both in one call, alternating.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from pivot_tpu_torch.ops import cuda_kernels as ck

Z = 31


def _inputs(seed, T, H, device):
    """A seeded f32 tick: availability in [0, 16), sparse demands, 20%
    group entries (``chip_smoke.make_inputs``'s pattern)."""
    rng = np.random.default_rng(seed)
    avail = rng.uniform(0, 16, size=(H, 4)).astype(np.float32)
    demands = np.stack([
        rng.choice([0.0, 0.5, 1.0, 2.0, 4.0], size=T),
        rng.uniform(0, 4000, size=T), np.zeros(T), np.zeros(T),
    ], axis=1).astype(np.float32)
    valid = rng.random(T) < 0.9
    new_group = rng.random(T) < 0.2
    new_group[0] = True
    anchor = rng.integers(0, Z, size=T).astype(np.int32)
    cost = rng.uniform(0, 0.11, size=(Z, Z)).astype(np.float32)
    np.fill_diagonal(cost, 0.0)
    bw = rng.uniform(50, 15000, size=(Z, Z)).astype(np.float32)
    host_zone = rng.integers(0, Z, size=H).astype(np.int32)
    counts = rng.integers(0, 5, size=H).astype(np.int32)
    return [torch.from_numpy(x).to(device) for x in (
        avail, demands, valid, new_group, anchor, cost, bw, host_zone,
        counts)]


def _events_ms(fn, reps) -> float:
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=200)
    reps = ap.parse_args(argv).reps
    if not torch.cuda.is_available():
        raise SystemExit("time_greedy needs a CUDA card")
    dev = torch.device("cuda")
    out = {}
    for T, n_eff in ((16, 11), (2048, 619)):
        args = _inputs(5, T, 600, dev)
        a = [args[0][None], *args[1:]]
        R, T_, _H, n, cfg = ck._check(*a, "first-fit", None, None, n_eff)
        p = torch.empty((R, T_), dtype=torch.int32, device=dev)
        o = torch.empty_like(a[0])
        out[f"T{T}_n{n_eff}"] = dict(
            wrapper_ms=_events_ms(lambda: ck.cost_aware_cuda(
                *args, n_eff=n_eff), reps),
            kernel_ms=_events_ms(lambda: ck._launch(
                cfg, *a, None, None, p, o, n, True, True, False), reps))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
