#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``pivot_tpu_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, each fatal on failure:

  1. environment: the card (``nvidia-smi`` name and power limit), torch,
     CUDA and nvcc versions, the build of every hand-written kernel, and
     ``nvcc -Xptxas -v``'s registers, shared memory and spills for each
     build of ``greedy_place``; the wrapper's launch-shape tables must
     match the library's, and the kernel's straight-line square root and
     division must equal the IEEE intrinsics bit for bit on 2^27 hashed
     operand pairs each;
  2. ``greedy_place`` against its plain torch version on the card, float32:
     the five cost-aware modes over six (T, H) shapes, the edge cases
     (T = 0, nothing fits, invalid tasks, a ``live`` mask, a ``risk``
     row) and the replica-batched launch at R = 5 and R = 256, each on
     sparse inputs (few tasks fit) and dense ones (most place, with a
     floor on the placements made); the selection edge cases of
     ``tests/test_torch_greedy.py`` (score ties across warp boundaries,
     H = 1 / 33 / 100, ±0.0 risks, +inf and NaN scores) at several warp
     counts; every launch shape the phase-4 sweep times; and the
     shared-memory-state build at H = 9664.  Placements must be equal;
     availability within rtol 1e-6 / atol 1e-5;
  3. end to end: the ``overall`` experiment (Opportunistic, VBP,
     Cost-Aware) at 600 hosts x 1000 apps through the port's CLI entry
     point, on ``--device cuda --no-adaptive`` with fused spans (the
     default), again with fusion off, and on ``--device numpy``.  Every
     span of the fused run executes under
     ``torch.cuda.set_sync_debug_mode("error")`` (a host read inside a
     span raises) between CUDA events that time it.  Every Cost-Aware
     tick must be a kernel launch — launches = per-tick kernel ticks +
     span kernel ticks, with span ticks present — the arms' egress-cost
     and runtime rankings must agree with numpy's, and the script says
     whether fusion on and off write byte-identical files (if not, the
     first differing task and whether float32 ties of the demand norms
     can explain it).  A second Cost-Aware run shadows every kernel call,
     per-tick and in spans, with the plain version (identical placements
     required), holds every span against ``reference_tick_run`` on the
     same float32 operands with the plain version serving its ticks, and
     checks ``placement_sensitivity`` (R = 256) against the plain batched
     version at each new largest tick;
  4. sensitivity on the card: the ``sensitivity`` experiment through the
     port's CLI at 600 hosts, R = 256, under a spot market drawn by
     ``MarketSchedule.generate`` from the port's own cluster metadata —
     the Cost-Aware arm (300 apps: every gated tick must be one R = 256
     launch of ``greedy_place``, each held after the run against
     ``cost_aware_plain_batched`` on its own f32 operands) and the VBP
     arm (100 apps: the replica-batched torch First-Fit pass, its largest
     tick's first rows held against the unbatched pass); each baseline's
     four metrics within 0.5% of a numpy run of the same seed and
     market; the gate's telemetry, paired walls and a host-clock split
     of a gated tick (noise draw, staging, pass, fetch + unpad);
  5. times on the card by CUDA events: the wrapper the main path calls
     per tick (median over the run's ticks, and at T = 619 / 2048,
     H = 600), the R = 256 launch, the plain version, and the roofline
     bound; beside each wrapper time the bare launch (``kernel_ms``,
     ``_launch`` on checked operands) and its ns per task step; ns per
     step with one group entry, an entry at every task and best-fit, and
     the share of the main path's tasks that are group entries; the
     sweep of warps per replica at H = 600 that sets ``_launch_config``;
     and, where ``torch.profiler`` sees the card, one device kernel per
     wrapper call; and wrapper / bare-launch times of every gated
     R = 256 launch of phase 4;
  6. the Monte-Carlo ensemble on the card (no hand kernel: ``greedy_place``
     must make no launch): the refund's sum order on the trace's demands
     against the CPU; at R = 16 the cost-aware and first-fit arms against
     ``pivot_tpu``'s own CPU rollout (``tests/data/ensemble_r16_seed0.npz``)
     under torch's sync debug mode; the ``ensemble`` CLI at 600 hosts x 50
     apps, R = 1024, both arms — wall, replica rollouts/s, ticks,
     placement steps, host reads, CUDA-event ms of the tick loop, peak
     memory, its first 16 replicas equal to the R = 16 run; a
     ``torch.profiler`` window of ticks 600-650 per arm; the R = 16
     cost-aware run against the port on the CPU; best-fit, opportunistic
     and lifo at 10 apps, card against CPU.  Placements, finish times,
     makespans and unfinished counts must be equal, egress and
     instance-hours within rtol 1e-5.

The line before the last is a JSON ``kernels`` record (its ``launches``
split into the R = 1 and R = 256 launches of phases 3 and 4); the last
line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside a
checkout of the repository, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): f32 outside the
#: tensor cores, and HBM3 bandwidth.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
RTOL, ATOL = 1e-6, 1e-5  # tests/test_pallas.py's tolerance
Z = 31
MODES = [
    dict(bin_pack="first-fit", sort_hosts=True, host_decay=False),
    dict(bin_pack="first-fit", sort_hosts=True, host_decay=True),
    dict(bin_pack="first-fit", sort_hosts=False, host_decay=False),
    dict(bin_pack="best-fit", sort_hosts=True, host_decay=False),
    dict(bin_pack="best-fit", sort_hosts=True, host_decay=True),
]
SHAPES = [(37, 13), (300, 50), (5, 200), (700, 40), (619, 600), (2048, 600)]
TRACE = "data/jobs/jobs-5000-200-86400-172800.npz"
ARMS = ("Opportunistic", "VBP", "Cost-Aware")


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def ptxas_usage_start(build, tmp):
    """Start ``nvcc -Xptxas -v`` on ``greedy_place.cu`` (a cubin of the
    build's own flags) and return the process."""
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    src = os.path.join("pivot_tpu_torch", "csrc", "greedy_place.cu")
    return subprocess.Popen(
        [build._nvcc(), *flags, "-cubin", "-Xptxas", "-v", src, "-o",
         os.path.join(tmp, "greedy_place.cubin")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_usage_lines(proc):
    """One line per kernel build: hosts per thread K, where the state
    lives, registers, shared memory, stack and spills."""
    out, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"nvcc -Xptxas -v failed:\n{out}")
    lines, cur = [], None
    for raw in out.splitlines():
        m = re.search(r"greedy_place_kernelILi(\d+)ELb([01])E", raw)
        if "Compiling entry function" in raw and m:
            cur = dict(K=int(m.group(1)),
                       state="smem" if m.group(2) == "1" else "registers")
        elif cur is not None and "spill stores" in raw:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", raw)]
            cur.update(stack=nums[0], spill_stores=nums[1],
                       spill_loads=nums[2])
        elif cur is not None and "Used" in raw and "registers" in raw:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             raw).group(1))
            smem = re.search(r"(\d+) bytes smem", raw)
            cur["static_smem"] = int(smem.group(1)) if smem else 0
            lines.append(cur)
            cur = None
    if not lines:
        raise AssertionError(f"no ptxas usage found in:\n{out}")
    return [json.dumps(x) for x in sorted(
        lines, key=lambda x: (x["state"], x["K"]))]


def check_shape_tables(build, ck) -> None:
    """The wrapper's copy of the launch-shape tables must be the
    library's: thread limits, the shared-memory K, the smem formula."""
    lib = build.load("greedy_place")
    lib.greedy_place_smem_bytes.restype = ctypes.c_size_t
    for K in range(1, 33):
        for smem_state in (0, 1):
            want = (ck._REG_THREADS.get(K, 0) if not smem_state
                    else 1024 if K == ck._SMEM_K else 0)
            got = lib.greedy_place_max_threads(K, smem_state)
            if got != want:
                raise AssertionError(f"max threads of K={K} smem="
                                     f"{smem_state}: {got} in the library, "
                                     f"{want} in the wrapper")
    for z in (1, 7, 31):
        for W, G, K, s in ((1, 1, 1, 0), (2, 15, 10, 0), (4, 2, 5, 0),
                           (19, 1, 1, 0), (32, 1, ck._SMEM_K, 1)):
            if lib.greedy_place_smem_bytes(z, W, G, K, s) != \
                    ck._smem_bytes(z, W, G, K, bool(s)):
                raise AssertionError(f"smem bytes differ at {z, W, G, K, s}")
    log("  launch-shape tables: wrapper = library")


def arith_check(build, n=1 << 26) -> None:
    """The kernel's straight-line square root and division against the
    IEEE intrinsics (``greedy_place_arith_check``) on 2n hashed operand
    pairs each: bitwise equal wherever the kernel takes them."""
    lib = build.load("greedy_place")
    counts = torch.zeros(4, dtype=torch.int64, device="cuda")
    for seed in (1, 2):
        err = lib.greedy_place_arith_check(
            ctypes.c_uint(seed), ctypes.c_int(n),
            ctypes.c_void_p(counts.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise AssertionError(f"arith check launch failed: {err}")
    torch.cuda.synchronize()
    bad_div, bad_sqrt, n_div, n_sqrt = counts.tolist()
    log(f"  straight-line div / sqrt vs __fdiv_rn / __fsqrt_rn: {bad_div} / "
        f"{bad_sqrt} mismatches in {n_div} / {n_sqrt} operations taken")
    if bad_div or bad_sqrt or not n_div or not n_sqrt:
        raise AssertionError("straight-line arithmetic differs from IEEE")


def make_inputs(seed, T, H, device, frac_new_group=0.2, dense=False):
    """Seeded f32 tick inputs (the pattern of ``tests/test_pallas.py``).
    That pattern draws demand dimension 1 from [0, 4000) against
    availability in [0, 16), so few tasks fit anywhere; ``dense`` draws
    it from [0, 4) instead, so that most tasks place until the hosts
    fill and every score, tie-break and decrement is exercised."""
    rng = np.random.default_rng(seed)
    avail = rng.uniform(0, 16, size=(H, 4)).astype(np.float32)
    demands = np.stack([
        rng.choice([0.0, 0.5, 1.0, 2.0, 4.0], size=T),
        rng.uniform(0, 4 if dense else 4000, size=T), np.zeros(T),
        np.zeros(T),
    ], axis=1).astype(np.float32)
    valid = rng.random(T) < 0.9
    new_group = rng.random(T) < frac_new_group
    if T:
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


class Check:
    """Kernel-vs-plain comparisons: exact placements, availability within
    the tolerance; tracks the largest availability difference and the
    placements made."""

    def __init__(self):
        self.cases = 0
        self.placed = 0
        self.max_abs_err = 0.0

    def same(self, got, want, what, min_placed=0) -> None:
        """``min_placed``: the fewest placements the case must make, so
        that a dense case cannot pass on a handful of decisions."""
        (p, a), (pp, pa) = got, want
        torch.cuda.synchronize()
        if not torch.equal(p, pp):
            bad = (p != pp).nonzero()[:5].tolist()
            raise AssertionError(f"{what}: placements differ at {bad}")
        if not torch.allclose(a, pa, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"{what}: availability outside tolerance")
        if a.numel():
            self.max_abs_err = max(self.max_abs_err,
                                   float((a - pa).abs().max()))
        placed = int((p >= 0).sum())
        if placed < min_placed:
            raise AssertionError(f"{what}: {placed} placements, fewer than "
                                 f"the {min_placed} this case must make")
        self.placed += placed
        self.cases += 1


def dense_floor(args, R=1) -> int:
    """Placements a dense case must make: a quarter of its valid tasks
    in every replica."""
    return R * int(args[2].sum()) // 4


EDGE_CASES = ["ties", "h1", "h33", "h100", "risk_zeros", "zero_bw",
              "nan_only"]


def edge_inputs(name, device):
    """``tests/test_torch_greedy.py::edge_inputs`` on ``device``: a dense
    40-task tick on one selection edge case (ties across warp boundaries
    at hosts 31/32 and 63/64 = H − 1; H = 1, 33, 100; a risk row of ±0.0;
    +inf and NaN scores from zero bandwidth).  Returns the nine operands
    and the extra keyword tensors."""
    rng = np.random.default_rng(sum(map(ord, name)))
    H = {"h1": 1, "h33": 33, "h100": 100}.get(name, 65)
    T = 40
    avail = rng.uniform(0, 16, size=(H, 4)).astype(np.float32)
    demands = np.stack([rng.choice([0.0, 0.5, 1.0, 2.0], size=T),
                        rng.uniform(0, 4, size=T), np.zeros(T), np.zeros(T)],
                       axis=1).astype(np.float32)
    valid = rng.random(T) < 0.9
    new_group = rng.random(T) < 0.2
    new_group[0] = True
    anchor = rng.integers(0, Z, size=T).astype(np.int32)
    cost = rng.uniform(0, 0.11, size=(Z, Z)).astype(np.float32)
    np.fill_diagonal(cost, 0.0)
    bw = rng.uniform(50, 15000, size=(Z, Z)).astype(np.float32)
    host_zone = rng.integers(0, Z, size=H).astype(np.int32)
    counts = rng.integers(0, 5, size=H).astype(np.int32)
    kw = {}
    if name == "ties":
        avail[:] = 1.5
        avail[[31, 32, 63, 64]] = 9.0
        host_zone[:] = 3
        counts[:] = 2
    elif name == "risk_zeros":
        kw["risk"] = rng.choice([-0.0, 0.0, 0.25], size=H).astype(np.float32)
    elif name == "zero_bw":
        bw[5, :] = 0.0
        bw[:, 5] = 0.0
        host_zone[: H // 3] = 5
        anchor[::2] = 5
    elif name == "nan_only":
        bw[5, 5] = 0.0
        host_zone[:] = 5
        anchor[:] = 5
    args = [torch.from_numpy(x).to(device) for x in (
        avail, demands, valid, new_group, anchor, cost, bw, host_zone,
        counts)]
    return args, {k: torch.from_numpy(v).to(device) for k, v in kw.items()}


def bare_launch(ck, args, kw, warps=None):
    """The kernel alone: ``_check`` once, outputs allocated once, then a
    function that runs ``_launch`` (the wrapper's one launch site) in the
    default shape or with ``warps`` warps per replica, and returns the
    outputs as ``[R, T]`` / ``[R, H, 4]``.  Also returns the shape."""
    avail = args[0] if args[0].dim() == 3 else args[0][None]
    a = [avail, *args[1:]]
    live, risk = kw.get("live"), kw.get("risk")
    bin_pack = kw.get("bin_pack", "first-fit")
    R, T, H, n_eff, cfg = ck._check(*a, bin_pack, live, risk,
                                    kw.get("n_eff"))
    if warps is not None:
        cfg = ck._launch_config(R, H, a[5].shape[0], warps)
    placements = torch.empty((R, T), dtype=torch.int32, device=avail.device)
    out = torch.empty_like(avail)

    def go():
        ck._launch(cfg, *a, live, risk, placements, out, n_eff,
                   bin_pack == "first-fit", kw.get("sort_hosts", True),
                   kw.get("host_decay", False))
        return placements, out
    return go, cfg


#: Warps per replica the phase-4 sweep times at H = 600 (19 = the whole
#: block at H = 600, one host a thread).
SWEEP_WARPS = (1, 2, 3, 4, 5, 6, 8, 10, 19)


def phase_kernel_vs_plain(ck, device) -> Check:
    chk = Check()
    for dense in (False, True):
        for mode in MODES:
            for seed, (T, H) in enumerate(SHAPES):
                args = make_inputs(seed, T, H, device, dense=dense)
                chk.same(ck.cost_aware_cuda(*args, **mode),
                         ck.cost_aware_plain(*args, **mode),
                         (mode, T, H, "dense" if dense else "sparse"),
                         dense_floor(args) if dense else 0)
    # Edge cases.
    args = make_inputs(0, 0, 8, device)
    chk.same(ck.cost_aware_cuda(*args), ck.cost_aware_plain(*args), "T=0")
    args = make_inputs(1, 40, 24, device)
    none_fit = [torch.full_like(args[0], 0.5), torch.full_like(args[1], 99.0)]
    for mode in (MODES[0], MODES[3]):
        got = ck.cost_aware_cuda(*none_fit, *args[2:], **mode)
        chk.same(got, ck.cost_aware_plain(*none_fit, *args[2:], **mode),
                 ("no fit", mode))
        if int((got[0] >= 0).sum()):
            raise AssertionError("a task was placed where nothing fits")
    args = make_inputs(2, 300, 50, device, dense=True)
    args[2][::3] = False  # invalid tasks interspersed
    for mode in MODES:
        got = ck.cost_aware_cuda(*args, **mode)
        chk.same(got, ck.cost_aware_plain(*args, **mode), ("invalid", mode),
                 dense_floor(args))
        if bool((got[0][~args[2]] >= 0).any()):
            raise AssertionError("an invalid task was placed")
    rng = np.random.default_rng(1)
    live = np.ones(600, bool)
    live[rng.choice(600, size=60, replace=False)] = False
    live = torch.from_numpy(live).to(device)
    risk = torch.from_numpy(rng.choice([0.0, 0.4, 1.5], size=600)
                            .astype(np.float32)).to(device)
    for dense in (False, True):
        args = make_inputs(3, 619, 600, device, dense=dense)
        for mode in MODES:
            for kw in (dict(live=live), dict(risk=risk),
                       dict(live=live, risk=risk)):
                got = ck.cost_aware_cuda(*args, **mode, **kw)
                chk.same(got, ck.cost_aware_plain(*args, **mode, **kw),
                         ("live/risk", mode, sorted(kw), dense),
                         dense_floor(args) if dense else 0)
                if "live" in kw:
                    placed = got[0][got[0] >= 0].long()
                    if not bool(live[placed].all()):
                        raise AssertionError("placed on a masked host")
    # Replica-batched launches.
    for dense in (False, True):
        for R, (T, H) in ((5, (70, 40)), (256, (619, 600))):
            args = make_inputs(4, T, H, device, dense=dense)
            noise = torch.from_numpy(np.random.default_rng(9).uniform(
                0.5, 1.5, (R, H, 1)).astype(np.float32)).to(device)
            avail_r = (args[0][None] * noise).contiguous()
            for mode in MODES:
                chk.same(
                    ck.cost_aware_cuda_batched(avail_r, *args[1:], **mode),
                    ck.cost_aware_plain_batched(avail_r, *args[1:], **mode),
                    ("batched", R, mode, dense),
                    dense_floor(args, R) if dense else 0)
    # Selection edge cases, in the default shape and at 1 / 2 / 4 warps.
    for name in EDGE_CASES:
        args, kw = edge_inputs(name, device)
        for mode in MODES:
            want = ck.cost_aware_plain(*args, **mode, **kw)
            chk.same(ck.cost_aware_cuda(*args, **mode, **kw), want,
                     ("edge", name, mode))
            want = (want[0][None], want[1][None])
            for warps in (1, 2, 4):
                go, _cfg = bare_launch(ck, args, {**mode, **kw}, warps)
                chk.same(go(), want, ("edge", name, mode, warps))
            if name == "nan_only" and mode["sort_hosts"] and bool(
                    (want[0] >= 0).any()):
                raise AssertionError("a NaN minimum placed a task")
    # Every shape the phase-4 sweep times, and the shared-memory state.
    for dense in (False, True):
        for R, T, H in ((1, 619, 600), (256, 619, 600), (1, 64, 9664)):
            args = make_inputs(8, T, H, device, dense=dense)
            if R > 1:
                noise = torch.from_numpy(np.random.default_rng(9).uniform(
                    0.5, 1.5, (R, H, 1)).astype(np.float32)).to(device)
                args[0] = (args[0][None] * noise).contiguous()
            for mode in MODES if H > 600 or R == 1 else MODES[:1]:
                want = ck.cost_aware_plain_batched(
                    args[0] if R > 1 else args[0][None], *args[1:], **mode)
                for warps in SWEEP_WARPS if H == 600 else (None,):
                    go, cfg = bare_launch(ck, args, mode, warps)
                    chk.same(go(), want, ("shape", R, T, H, mode, cfg),
                             dense_floor(args, R) if dense and H == 600
                             else 0)
    return chk


def overall_argv(out, job_dir, device):
    return ["--device", device, "--no-adaptive", "--num-hosts", "600",
            "--job-dir", job_dir, "--output-dir", out, "--seed", "0",
            "overall", "--num-apps", "1000"]


def check_outputs(exp_dir) -> None:
    """The four reference output files of every arm, with finite metrics."""
    for arm in ARMS:
        d = os.path.join(exp_dir, "data", "0", arm)
        with open(os.path.join(d, "general.json")) as f:
            general = json.load(f)
        for key in ("egress_cost", "cum_instance_hours", "avg_runtime"):
            if not np.isfinite(general[key]):
                raise AssertionError(f"{arm}: {key} = {general[key]}")
        for name in ("transfers.json", "scheduler.json", "host_usage.json"):
            if not os.path.getsize(os.path.join(d, name)):
                raise AssertionError(f"{arm}: empty {name}")


def rankings_agree(cuda, numpy_, metric) -> None:
    """Pairwise order of the arms on ``metric`` must agree; two arms
    within 0.5% of each other in the numpy run count as tied."""
    for i, a in enumerate(ARMS):
        for b in ARMS[i + 1:]:
            na, nb = numpy_[a][metric], numpy_[b][metric]
            if abs(na - nb) <= 0.005 * max(abs(na), abs(nb)):
                log(f"  {metric}: {a} and {b} within 0.5% on numpy "
                    f"({na!r} vs {nb!r}) -- treated as tied")
                continue
            ca, cb = cuda[a][metric], cuda[b][metric]
            if (ca < cb) != (na < nb):
                raise AssertionError(
                    f"{metric} ranking differs: cuda {a}={ca!r} {b}={cb!r}, "
                    f"numpy {a}={na!r} {b}={nb!r}")


ARM_OF = {"opportunistic": "Opportunistic", "first-fit": "VBP",
          "cost-aware": "Cost-Aware"}


class SpanMeter:
    """Wraps ``sched.cuda.fused_tick_run`` while active: the device's
    sync debug mode is "error" around every span, so any host read inside
    one raises, and CUDA events around each call time the span on the
    device timeline (read after the run).  Its ``ticks_run`` is read after
    the span, beside the policy's own fetch."""

    def __init__(self, cuda_mod):
        self.mod, self.orig = cuda_mod, cuda_mod.fused_tick_run
        self.spans = []  # one dict per span

    def __call__(self, *a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = self.orig(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ev[1].record()
        self.spans.append(dict(arm=ARM_OF[kw["policy"]], k_dyn=a[3],
                               steps=sum(kw["n_bound"]),
                               ticks_run=int(res.ticks_run),
                               ready=int(res.n_ready.sum()), ev=ev))
        return res

    def __enter__(self):
        self.mod.fused_tick_run = self
        return self

    def __exit__(self, *exc):
        self.mod.fused_tick_run = self.orig

    def by_arm(self):
        """Per arm: spans, horizon ticks, executed ticks, pass steps
        walked, live steps (the executed ticks' ready sizes: what the
        per-tick path walks for them), and device ms per span (median,
        largest)."""
        torch.cuda.synchronize()
        out = {}
        for arm in ARMS:
            sp = [x for x in self.spans if x["arm"] == arm]
            ms = [x["ev"][0].elapsed_time(x["ev"][1]) for x in sp]
            out[arm] = dict(
                spans=len(sp), horizon_ticks=sum(x["k_dyn"] for x in sp),
                ticks_run=sum(x["ticks_run"] for x in sp),
                steps=sum(x["steps"] for x in sp),
                live_steps=sum(x["ready"] for x in sp),
                ms_median=statistics.median(ms) if ms else None,
                ms_max=max(ms) if ms else None, ms_sum=sum(ms))
        return out


class SpanReferee:
    """Wraps ``sched.cuda.fused_tick_run`` while active: every span's
    result is held against ``reference_tick_run`` on the same operands,
    the plain version serving its Cost-Aware ticks — equal placements,
    ready and placed counts, availability within the tolerance."""

    def __init__(self, cuda_mod, ck, tickloop):
        self.mod, self.orig = cuda_mod, cuda_mod.fused_tick_run
        self.ck, self.tickloop = ck, tickloop
        self.spans = 0
        self.max_abs_err = 0.0

    def __call__(self, avail, dem, arrive, k_dyn, **kw):
        res = self.orig(avail, dem, arrive, k_dyn, **kw)
        rkw = {k: v for k, v in kw.items() if k not in ("n_bound", "n_ticks")}
        if rkw.get("greedy") is not None:
            rkw["greedy"] = self.ck.cost_aware_plain
        p, n_ready, n_placed, a = self.tickloop.reference_tick_run(
            avail, dem, arrive, k_dyn, **rkw)
        ticks_run = int(res.ticks_run)
        if not (np.array_equal(res.placements[:k_dyn].cpu().numpy(), p)
                and np.array_equal(res.n_placed[:k_dyn].cpu().numpy(),
                                   n_placed)
                and np.array_equal(res.n_ready[:ticks_run].cpu().numpy(),
                                   n_ready[:ticks_run])):
            raise AssertionError(f"span {self.spans} differs from "
                                 "reference_tick_run")
        got = res.avail.cpu().numpy()
        if not np.allclose(got, a, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"span {self.spans}: availability outside "
                                 "tolerance of reference_tick_run")
        if got.size:
            self.max_abs_err = max(self.max_abs_err,
                                   float(np.abs(got - a).max()))
        self.spans += 1
        return res

    __enter__ = SpanMeter.__enter__
    __exit__ = SpanMeter.__exit__


def run_cli(cli, argv, device, fuse):
    """``run_overall`` on ``argv`` with fused spans on or off; returns
    ``(exp_dir, summaries, runs)`` — the ``ExperimentRun`` objects keep
    every task's placement."""
    runs, build = [], cli._build_run

    def build_run(spec):
        run = build(spec)
        run.fuse_spans = fuse
        runs.append(run)
        return run

    cli._build_run = build_run
    try:
        exp_dir, summaries = cli.run_overall(cli.parse_args(argv),
                                             torch_device=device)
    finally:
        cli._build_run = build
    return exp_dir, summaries, runs


def task_placements(run):
    return {(a.id, t.id): (t.placement, t.demand)
            for a in run.schedule.apps for g in a.groups for t in g.tasks}


def compare_outputs(dir_a, dir_b, runs_a, runs_b):
    """Per arm: None when the four files are byte-identical, else the
    first differing task (by app and task id) and whether a float32 tie
    of demand norms that float64 tells apart can explain it."""
    out = {}
    for arm, ra, rb in zip(ARMS, runs_a, runs_b):
        same = True
        for name in ("general.json", "transfers.json", "scheduler.json",
                     "host_usage.json"):
            paths = [os.path.join(d, "data", "0", arm, name)
                     for d in (dir_a, dir_b)]
            with open(paths[0], "rb") as fa, open(paths[1], "rb") as fb:
                same = same and fa.read() == fb.read()
        if same:
            out[arm] = None
            continue
        pa, pb = task_placements(ra), task_placements(rb)
        diff = sorted(k for k in pa if pa[k][0] != pb[k][0])
        first = diff[0] if diff else None
        norms = {k: float(np.sqrt(np.sum(np.square(v[1]))))
                 for k, v in pa.items()}
        tie = None
        if first is not None:
            n64 = norms[first]
            n32 = np.float32(n64)
            tie = any(np.float32(n) == n32 and n != n64
                      for n in norms.values())
        out[arm] = dict(differing_tasks=len(diff), first=first,
                        first_on=pa[first][0] if first else None,
                        first_off=pb[first][0] if first else None,
                        f32_norm_tie=tie)
    return out


def make_shadow_policy(cuda_mod, ck):
    base = cuda_mod.CudaCostAwarePolicy

    class ShadowCostAware(base):
        """The Cost-Aware device policy with every kernel call shadowed
        by the plain version on the same staged tensors."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.check = Check()
            self.ticks = []  # (args, kw) of every per-tick call, for timing
            self.span_ticks = []  # (args, kw) of every span tick
            self.in_span = False
            self.largest = 0
            self.sensitivity = None

        def _greedy(self, *args, **kw):
            got = super()._greedy(*args, **kw)
            ticks = self.span_ticks if self.in_span else self.ticks
            self.check.same(got, ck.cost_aware_plain(*args, **kw),
                            ("span tick" if self.in_span else "tick",
                             len(ticks)))
            ticks.append((args, kw))
            return got

        def _span_greedy(self, *args, **kw):
            self.in_span = True
            try:
                return super()._span_greedy(*args, **kw)
            finally:
                self.in_span = False

        def _greedy_batched(self, *args, **kw):
            got = super()._greedy_batched(*args, **kw)
            self.check.same(got, ck.cost_aware_plain_batched(*args, **kw),
                            "placement_sensitivity")
            return got

        def _device_place(self, ctx):
            out = super()._device_place(ctx)
            if ctx.n_tasks > self.largest:
                self.largest = ctx.n_tasks
                nominal, stability, placements = self.placement_sensitivity(
                    ctx, n_replicas=256, perturb=0.05, seed=0)
                if placements.shape != (256, ctx.n_tasks) or not (
                        nominal.tolist() == out.tolist()):
                    raise AssertionError("sensitivity replica 0 is not the "
                                         "production decision")
                self.sensitivity = (ctx.n_tasks, float(stability.mean()))
            return out

    return ShadowCostAware


def phase_end_to_end(device, n_hosts=600, n_apps=1000):
    from pivot_tpu_torch.experiments import cli, runner
    from pivot_tpu_torch.ops import cuda_kernels as ck
    from pivot_tpu_torch.ops import tickloop
    from pivot_tpu_torch.sched import cuda as cuda_mod
    from pivot_tpu_torch.utils.config import build_cluster

    res = {}
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        job_dir = os.path.join(tmp, "jobs")
        os.makedirs(job_dir)
        os.symlink(os.path.abspath(TRACE),
                   os.path.join(job_dir, os.path.basename(TRACE)))
        runs = {}
        for name, backend, fuse in (("cuda", "cuda", True),
                                    ("cuda_off", "cuda", False),
                                    ("numpy", "numpy", True)):
            argv = overall_argv(os.path.join(tmp, name), job_dir, backend)
            argv[argv.index("600")] = str(n_hosts)
            argv[-1] = str(n_apps)
            cluster_cfg = cli._cluster_config(cli.parse_args(argv))
            with SpanMeter(cuda_mod) as meter:
                ck.reset_launches()  # the main path's count starts here
                t0 = time.perf_counter()
                exp_dir, summaries, objs = run_cli(cli, argv, device, fuse)
                wall = time.perf_counter() - t0
                launches = ck.LAUNCHES["greedy_place"]
            check_outputs(exp_dir)
            runs[name] = dict(wall=wall, launches=launches, dir=exp_dir,
                              objs=objs, spans=meter.by_arm(),
                              arms={s["label"]: s for s in summaries})
        cuda, numpy_ = runs["cuda"]["arms"], runs["numpy"]["arms"]
        for name in ("cuda", "cuda_off"):
            ca = runs[name]["arms"]["Cost-Aware"]["dispatch"]
            fusion = "on" if name == "cuda" else "off"
            log(f"  cost-aware on cuda, fusion {fusion}: "
                f"{ca['device_ticks']} per-tick device ticks, "
                f"{ca['kernel_ticks']} served by greedy_place, "
                f"{ca['span_kernel_ticks']} span ticks launched on it, "
                f"{runs[name]['launches']} launches counted")
            if not (ca["device_ticks"] > 0
                    and ca["kernel_ticks"] == ca["device_ticks"]
                    and runs[name]["launches"]
                    == ca["kernel_ticks"] + ca["span_kernel_ticks"]):
                raise AssertionError("not every Cost-Aware tick was a launch")
            for arm in ARMS[:2]:
                d = runs[name]["arms"][arm]["dispatch"]
                if d["kernel_ticks"] or d["span_kernel_ticks"]:
                    raise AssertionError(f"{arm} went through the kernel")
        if not cuda["Cost-Aware"]["dispatch"]["span_kernel_ticks"]:
            raise AssertionError("no Cost-Aware span tick was served by "
                                 "greedy_place")
        if runs["cuda_off"]["arms"]["Cost-Aware"]["dispatch"][
                "span_kernel_ticks"] or any(
                x["spans"] for x in runs["cuda_off"]["spans"].values()):
            raise AssertionError("a span ran with fusion off")
        for metric in ("egress_cost", "avg_runtime"):
            rankings_agree(cuda, numpy_, metric)
        for arm in ARMS:
            log(f"  {arm:13s} cuda: egress_cost={cuda[arm]['egress_cost']!r} "
                f"avg_runtime={cuda[arm]['avg_runtime']!r} "
                f"wall_s={cuda[arm]['wall_clock']!r} | numpy: "
                f"egress_cost={numpy_[arm]['egress_cost']!r} "
                f"avg_runtime={numpy_[arm]['avg_runtime']!r} "
                f"wall_s={numpy_[arm]['wall_clock']!r}")
        res["same_files"] = compare_outputs(
            runs["cuda"]["dir"], runs["cuda_off"]["dir"], runs["cuda"]["objs"],
            runs["cuda_off"]["objs"])
        for r in runs.values():
            r.pop("objs")
        res["runs"] = runs

        # The shadowed Cost-Aware run: same cluster, trace, seed.
        Shadow = make_shadow_policy(cuda_mod, ck)
        pc = cli.reference_policy_set("cuda", adaptive=False)[2]
        policy = Shadow(bin_pack=pc.bin_pack, sort_tasks=pc.sort_tasks,
                        sort_hosts=pc.sort_hosts, device=device)
        with SpanReferee(cuda_mod, ck, tickloop) as referee:
            summary = runner.ExperimentRun(
                "Cost-Aware", build_cluster(cluster_cfg), policy, TRACE,
                n_apps=n_apps, seed=0).run()
        for key in ("egress_cost", "avg_runtime"):
            if summary[key] != cuda["Cost-Aware"][key]:
                raise AssertionError(f"shadowed run differs on {key}")
        if not (referee.spans and policy.span_ticks):
            raise AssertionError("the shadowed run served no span")
        log(f"  shadow: {len(policy.ticks)} per-tick and "
            f"{len(policy.span_ticks)} span-tick kernel calls, "
            f"{policy.check.cases} kernel-vs-plain comparisons, all "
            f"placements equal, max |avail diff| {policy.check.max_abs_err!r};"
            f" {referee.spans} spans equal to reference_tick_run (plain "
            f"ticks), max |avail diff| {referee.max_abs_err!r}; sensitivity "
            f"R=256 at largest tick T={policy.sensitivity[0]}: mean "
            f"stability {policy.sensitivity[1]!r}")
        res["shadow"] = policy
        res["referee"] = referee
    return res


#: Apps of each gated arm the sensitivity phase runs, and its replicas.
SENS_APPS = {"cost-aware": 300, "vbp": 100}
SENS_REPLICAS = 256
METRICS = ("avg_runtime", "egress_cost", "instance_hours", "makespan")


def sensitivity_argv(out, job_dir, policy, n_apps, market, n_hosts=600):
    return ["--num-hosts", str(n_hosts), "--job-dir", job_dir,
            "--output-dir", out, "--seed", "0", "sensitivity",
            "--policy", policy, "--replicas", str(SENS_REPLICAS),
            "--num-apps", str(n_apps), "--des-seeds", "1",
            "--market", market]


class GateMeter:
    """Instruments the sensitivity path of ``sched.cuda`` while active.
    Host clocks split each gated tick's ``_mc_sensitivity`` into the noise
    draw (``_replicas``), the one ``stage`` copy, the pass (the kernel
    wrapper's enqueue, or the batched torch pass) and the rest (the fetch,
    which waits for the device, and the unpad).  Every replica-batched
    ``greedy_place`` call is recorded with its staged operands and its
    outputs — fresh tensors the run never reuses — for the shadow check
    and the times taken after the run; CUDA events bracket every batched
    First-Fit pass, and the operands of the largest one are kept."""

    def __init__(self, cuda_mod):
        self.mod = cuda_mod
        self.base = cuda_mod._DevicePolicyBase
        self.ca = cuda_mod.CudaCostAwarePolicy
        self.calls = []  # (args, kw, outputs) of every batched kernel call
        self.parts = []  # host seconds per gated tick, by part
        self.ff_passes = []  # (events, n_bound) per batched First-Fit pass
        self.ff_largest = None  # (args, kw) of the largest of them

    def __enter__(self):
        mod, meter = self.mod, self
        saved = self.saved = dict(
            mc=self.base._mc_sensitivity, replicas=self.base._replicas,
            greedy=self.ca._greedy_batched, stage=mod.stage,
            ffb=mod.first_fit_batched)
        cur = {}

        def timed(key, fn):
            def f(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    cur[key] = cur.get(key, 0.0) + time.perf_counter() - t0
            return f

        def mc(pol, *a, **k):
            cur.clear()
            t0 = time.perf_counter()
            out = saved["mc"](pol, *a, **k)
            cur["total"] = time.perf_counter() - t0
            meter.parts.append(dict(cur))
            return out

        def greedy(pol, *a, **k):
            out = saved["greedy"](pol, *a, **k)
            meter.calls.append((a, k, out))
            return out

        def ffb(*a, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = saved["ffb"](*a, **k)
            ev[1].record()
            n = k["n_bound"]
            if not meter.ff_passes or n > max(x[1] for x in meter.ff_passes):
                meter.ff_largest = (a, k)
            meter.ff_passes.append((ev, n))
            return out

        self.base._mc_sensitivity = mc
        self.base._replicas = timed("noise", saved["replicas"])
        self.ca._greedy_batched = timed("pass", greedy)
        mod.stage = timed("stage", saved["stage"])
        mod.first_fit_batched = timed("pass", ffb)
        return self

    def __exit__(self, *exc):
        self.base._mc_sensitivity = self.saved["mc"]
        self.base._replicas = self.saved["replicas"]
        self.ca._greedy_batched = self.saved["greedy"]
        self.mod.stage = self.saved["stage"]
        self.mod.first_fit_batched = self.saved["ffb"]

    def part_sums(self):
        """Seconds summed over the gated ticks, by part."""
        out = {k: sum(p.get(k, 0.0) for p in self.parts)
               for k in ("noise", "stage", "pass", "total")}
        out["fetch_unpad"] = (out["total"] - out["noise"] - out["stage"]
                              - out["pass"])
        return out


def numpy_metrics(cli, policy, n_apps, market, cluster_cfg):
    """``des_metrics`` of the un-gated arm on ``--device numpy``, same
    trace, cluster, seed and market."""
    import dataclasses

    from pivot_tpu_torch.experiments.calibrate import des_metrics
    from pivot_tpu_torch.experiments.runner import ExperimentRun
    from pivot_tpu_torch.utils.config import build_cluster, make_policy

    arm = dataclasses.replace(cli._SENSITIVITY_ARMS[policy][0],
                              device="numpy")
    run = ExperimentRun("numpy", build_cluster(cluster_cfg),
                        make_policy(arm), TRACE, n_apps=n_apps, seed=0,
                        interval=5.0, market=market)
    return des_metrics(run.run(), run.schedule)


def phase_sensitivity(device, n_hosts=600, apps=None):
    """The ``sensitivity`` experiment through the port's CLI under a
    seeded spot market: the Cost-Aware arm (every gated tick one
    R = 256 launch of ``greedy_place``, each held against the plain
    version after the run) and the VBP arm (the batched torch First-Fit
    pass), each baseline against a numpy run of the same seed and
    market."""
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.infra.market import MarketSchedule
    from pivot_tpu_torch.ops import cuda_kernels as ck
    from pivot_tpu_torch.ops import kernels as pk
    from pivot_tpu_torch.sched import cuda as cuda_mod
    from pivot_tpu_torch.utils.config import build_cluster
    from pivot_tpu_torch.workload.trace import load_trace_jobs

    apps = apps or SENS_APPS
    res = {}
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        job_dir = os.path.join(tmp, "jobs")
        os.makedirs(job_dir)
        os.symlink(os.path.abspath(TRACE),
                   os.path.join(job_dir, os.path.basename(TRACE)))
        market_path = os.path.join(tmp, "market.json")
        argv = sensitivity_argv(tmp, job_dir, "cost-aware",
                                apps["cost-aware"], market_path, n_hosts)
        args = cli.parse_args(argv)
        cluster_cfg = cli._cluster_config(args)
        bins = load_trace_jobs(TRACE, args.scale_factor).take(
            apps["cost-aware"]).bins
        horizon = bins[-1][0] - bins[0][0]  # the last submission instant
        market = MarketSchedule.generate(build_cluster(cluster_cfg).meta,
                                         seed=0, horizon=horizon,
                                         n_segments=8)
        market.save(market_path)
        log(f"  market: {market.n_segments} segments over {horizon!r} s "
            f"(MarketSchedule.generate, seed 0), {len(market.zones)} zones")
        for policy, n_apps in apps.items():
            argv = sensitivity_argv(os.path.join(tmp, policy), job_dir,
                                    policy, n_apps, market_path, n_hosts)
            with GateMeter(cuda_mod) as gm:
                ck.reset_launches()  # this path's count starts here
                t0 = time.perf_counter()
                report = cli.run_sensitivity(cli.parse_args(argv),
                                             torch_device=device)
                wall = time.perf_counter() - t0
                launches = dict(ck.LAUNCHES_BY_REPLICAS)
            seed = report["per_seed"][0]
            gate = seed["gate"]
            want = numpy_metrics(cli, policy, n_apps, market, cluster_cfg)
            for k in METRICS:
                got = seed["baseline"][k]
                if not (np.isfinite(got) and np.isfinite(seed["gated"][k])):
                    raise AssertionError(f"{policy}: {k} not finite")
                if abs(got - want[k]) > 0.005 * max(abs(got), abs(want[k])):
                    raise AssertionError(
                        f"{policy} baseline {k}={got!r} is more than 0.5% "
                        f"from numpy's {want[k]!r}")
            log(f"  {policy}, {n_hosts} hosts x {n_apps} apps, R="
                f"{SENS_REPLICAS}: {gate['ticks']} gated ticks, "
                f"{gate['held']} held, {gate['forced_through']} forced "
                f"through, mean stability {gate['mean_stability']!r}, min "
                f"{gate['min_stability']!r}")
            log(f"    baseline cuda vs numpy: " + ", ".join(
                f"{k} {seed['baseline'][k]!r} / {want[k]!r}"
                for k in METRICS))
            log(f"    gated: " + ", ".join(
                f"{k} {seed['gated'][k]!r}" for k in METRICS))
            wall_per_tick = gate["sensitivity_wall_s"] / gate["ticks"]
            parts = gm.part_sums()
            log(f"    walls: baseline {seed['baseline_wall_s']!r} s, gated "
                f"{seed['gated_wall_s']!r} s, both with the report "
                f"{wall!r} s; sensitivity_wall_per_tick_s "
                f"{gate['sensitivity_wall_per_tick_s']!r} (unrounded "
                f"{wall_per_tick!r}); per gated tick, host ms: " + ", ".join(
                    f"{k} {v * 1e3 / gate['ticks']!r}"
                    for k, v in parts.items()))
            r = dict(report=report, wall=wall, launches=launches,
                     numpy=want, parts=parts, ticks=gate["ticks"])
            if policy == "cost-aware":
                if not (launches.get(SENS_REPLICAS) == gate["ticks"]
                        == len(gm.calls) > 0 and launches.get(1, 0) > 0
                        and set(launches) == {1, SENS_REPLICAS}):
                    raise AssertionError(
                        f"gated ticks {gate['ticks']} vs launches "
                        f"{launches}: not one R={SENS_REPLICAS} launch a "
                        "gated tick")
                for a, _k, _out in gm.calls:
                    if tuple(a[0].shape) != (SENS_REPLICAS, n_hosts, 4):
                        raise AssertionError(f"gated launch of shape "
                                             f"{tuple(a[0].shape)}")
                chk = Check()
                for i, (a, k, out) in enumerate(gm.calls):
                    chk.same(out, ck.cost_aware_plain_batched(*a, **k),
                             ("gated tick", i))
                log(f"    shadow: all {chk.cases} R={SENS_REPLICAS} launches "
                    f"equal to cost_aware_plain_batched ({chk.placed} "
                    f"placements), max |avail diff| {chk.max_abs_err!r}; "
                    f"launches R=1 {launches[1]}, R={SENS_REPLICAS} "
                    f"{launches[SENS_REPLICAS]}")
                r.update(check=chk, calls=gm.calls)
            else:
                if launches or len(gm.ff_passes) != gate["ticks"]:
                    raise AssertionError(
                        f"VBP: {len(gm.ff_passes)} batched passes for "
                        f"{gate['ticks']} gated ticks, launches {launches}")
                torch.cuda.synchronize()
                ms = [ev[0].elapsed_time(ev[1]) for ev, _n in gm.ff_passes]
                steps = [n for _ev, n in gm.ff_passes]
                (avail_r, dem, valid), k = gm.ff_largest
                got = pk.first_fit_batched(avail_r, dem, valid, **k)
                chk = Check()
                for row in range(4):
                    want_row = pk.first_fit_impl(
                        avail_r[row], dem, valid, strict=k["strict"],
                        risk=k["risk"])
                    chk.same((got[0][row], got[1][row]), want_row,
                             ("vbp row", row))
                r.update(ms_median=statistics.median(ms), ms_max=max(ms),
                         ms_sum=sum(ms), steps_median=statistics.median(
                             steps), steps_max=max(steps), check=chk)
                log(f"    batched First-Fit pass (R={SENS_REPLICAS}, H="
                    f"{n_hosts}, CUDA events): median {r['ms_median']!r} ms "
                    f"a tick at median {r['steps_median']} steps, largest "
                    f"{r['ms_max']!r} ms, sum {r['ms_sum']!r} ms over "
                    f"{len(ms)} ticks; largest tick ({max(steps)} steps) rows "
                    f"0-3 equal to the unbatched pass")
            res[policy] = r
    return res


def gated_times(ck, calls):
    """Wrapper ms and bare-launch ``kernel_ms`` of every recorded gated
    launch, by CUDA events, and the largest launch's bound and plain
    time."""
    wrapper = [_events_ms(lambda: ck.cost_aware_cuda_batched(*a, **k), 3)
               for a, k, _o in calls]
    kernel_ = [_events_ms(bare_launch(ck, list(a), k)[0], 3)
               for a, k, _o in calls]
    n_eff = [k["n_eff"] for _a, k, _o in calls]
    big = max(range(len(calls)), key=n_eff.__getitem__)
    a, k, _o = calls[big]
    b_ms, b_by = bound(list(a), k, a[0].shape[0], n_eff[big])
    return dict(
        ms_median=statistics.median(wrapper), ms_max=max(wrapper),
        ms_sum=sum(wrapper), kernel_ms_median=statistics.median(kernel_),
        kernel_ms_max=max(kernel_), kernel_ms_sum=sum(kernel_),
        n_eff_median=statistics.median(n_eff), largest=dict(
            n_eff=n_eff[big], ms=wrapper[big], kernel_ms=kernel_[big],
            plain_ms=_host_ms(lambda: ck.cost_aware_plain_batched(*a, **k),
                              1),
            bound_ms=b_ms, bound_by=b_by))


def _events_ms(fn, reps) -> float:
    """Mean device ms of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(fn, reps) -> float:
    """Mean wall ms of ``fn`` (synchronised) — for the plain version,
    whose Python loop sets its pace."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def bound(args, kw, R, n_eff):
    """Least time for one call of the wrapper at these inputs: the larger
    of the bytes over HBM bandwidth and the operations over the f32 peak.
    Bytes: each of the function's own inputs read once — availability
    ``[R, H, 4]``, the task stream up to ``n_eff`` (demands, valid,
    new_group, anchor_zone), the ``[Z, Z]`` cost and bandwidth tables,
    host_zone and the base counts ``[H]``, live / risk when given — and
    each output written once (placements ``[R, T]``, availability).
    Operations: building the two ``[Z, H]`` round-trip tables (one add
    per entry each), then per host and replica the fit test, select and
    min (6) every step, plus the first-fit group score at each group
    entry (10, +1 decay, +1 risk) or the best-fit score every step (15,
    +2 decay, +1 risk)."""
    avail, dem, ng, cost_zz = args[0], args[1], args[3], args[5]
    H, T, nz = avail.shape[-2], dem.shape[0], cost_zz.shape[0]
    first_fit = kw.get("bin_pack", "first-fit") == "first-fit"
    decay = kw.get("host_decay", False)
    risk = kw.get("risk") is not None
    nbytes = (2 * R * H * 16 + n_eff * (16 + 1 + 1 + 4) + 2 * nz * nz * 4
              + H * 4 + H * 4 + R * T * 4 + (H * 4 if risk else 0)
              + (H if kw.get("live") is not None else 0))
    if first_fit:
        entries = int(ng[:n_eff].sum()) if kw.get("sort_hosts", True) else 0
        per_host = 6 * n_eff + (10 + decay + risk) * entries
    else:
        per_host = (6 + 15 + 2 * decay + risk) * n_eff
    ops = 2 * nz * H + R * H * per_host
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32_OPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_times(ck, shadow, device):
    """Device time of the wrapper the main path calls (phase 1 and the
    ``greedy_place`` launch), by CUDA events; the plain version by host
    clock around a synchronised call."""
    def wrapper(args, kw):
        fn = (ck.cost_aware_cuda if args[0].dim() == 2
              else ck.cost_aware_cuda_batched)
        return lambda: fn(*args, **kw)

    def kernel(args, kw, n_eff, reps):
        """``kernel_ms`` (the bare launch) and its ns per task step."""
        ms = _events_ms(bare_launch(ck, args, kw)[0], reps)
        return dict(kernel_ms=ms, ns_per_step=ms * 1e6 / max(n_eff, 1))

    times = {}
    per_tick = [_events_ms(wrapper(a, k), 5) for a, k in shadow.ticks]
    n_tasks = [k["n_eff"] for _a, k in shadow.ticks]
    times["tick_median_ms"] = statistics.median(per_tick)
    times["tick_sum_ms"] = sum(per_tick)
    per_span_tick = [_events_ms(wrapper(a, k), 5) for a, k in
                     shadow.span_ticks]
    times["span_tick_median_ms"] = statistics.median(per_span_tick)
    times["span_tick_sum_ms"] = sum(per_span_tick)
    times["span_tick_n_eff_median"] = statistics.median(
        k["n_eff"] for _a, k in shadow.span_ticks)
    times["tick_n_eff_median"] = statistics.median(n_tasks)
    med = sorted(range(len(n_tasks)), key=per_tick.__getitem__)[
        len(n_tasks) // 2]
    times["tick_median_kernel"] = kernel(*shadow.ticks[med],
                                         n_tasks[med], 20)
    big = max(range(len(n_tasks)), key=n_tasks.__getitem__)
    a, k = shadow.ticks[big]
    times["largest_tick"] = dict(
        n_eff=n_tasks[big], bucket=a[1].shape[0], H=a[0].shape[0],
        ms=_events_ms(wrapper(a, k), 20), **kernel(a, k, n_tasks[big], 20),
        plain_ms=_host_ms(lambda: ck.cost_aware_plain(*a, **k), 3),
        max_abs_err=shadow.check.max_abs_err,
    )
    times["largest_tick"]["bound_ms"], times["largest_tick"]["bound_by"] = \
        bound(a, k, 1, n_tasks[big])
    mode = MODES[0]  # the Cost-Aware arm's mode (first-fit, sorted hosts)
    shapes = {}
    for T in (619, 2048):
        args = make_inputs(5, T, 600, device)
        b_ms, b_by = bound(args, mode, 1, T)
        shapes[f"T{T}_H600"] = (args, 1, T)
        times[f"T{T}_H600"] = dict(
            ms=_events_ms(wrapper(args, mode), 20), **kernel(args, mode, T, 20),
            plain_ms=_host_ms(lambda: ck.cost_aware_plain(*args, **mode), 3),
            bound_ms=b_ms, bound_by=b_by)
    args = make_inputs(6, 619, 600, device)
    noise = torch.from_numpy(np.random.default_rng(9).uniform(
        0.95, 1.05, (256, 600, 1)).astype(np.float32)).to(device)
    args[0] = (args[0][None] * noise).contiguous()
    b_ms, b_by = bound(args, mode, 256, 619)
    shapes["R256_T619_H600"] = (args, 256, 619)
    times["R256_T619_H600"] = dict(
        ms=_events_ms(wrapper(args, mode), 5), **kernel(args, mode, 619, 10),
        plain_ms=_host_ms(lambda: ck.cost_aware_plain_batched(
            *args, **mode), 1),
        bound_ms=b_ms, bound_by=b_by)
    # Where a step's time goes (default shape, T = 2048, H = 600, dense):
    # first-fit with one group entry, the main path's shape; a group entry
    # at every task, which puts K scores per thread on the chain; best-fit,
    # which scores every host every step.
    args = make_inputs(7, 2048, 600, device, dense=True)
    args[3] = torch.zeros_like(args[3])
    args[3][0] = True
    every = list(args)
    every[3] = torch.ones_like(args[3])
    times["step_ns"] = {
        name: kernel(a, kw, 2048, 10)["ns_per_step"] for name, a, kw in (
            ("first-fit, one entry", args, mode),
            ("first-fit, entry every task", every, mode),
            ("best-fit", args, MODES[3]))}
    entries = sum(int(a[3][:k["n_eff"]].sum()) for a, k in shadow.ticks)
    times["main_path_entry_share"] = entries / sum(n_tasks)
    # The sweep that sets _launch_config: warps per replica at H = 600.
    times["sweep"] = {}
    for key, (args, R, T) in shapes.items():
        row = {}
        for warps in SWEEP_WARPS:
            go, cfg = bare_launch(ck, args, mode, warps)
            row[warps] = dict(K=cfg.hosts_per_thread, groups=cfg.groups,
                              kernel_ms=_events_ms(go, 10 if R > 1 else 20))
        times["sweep"][key] = dict(
            default_warps=ck._launch_config(R, 600, Z).warps, by_warps=row)
    return times


def profile_kernels(ck, shadow, calls=10):
    """Device kernels ``torch.profiler`` records over ``calls`` wrapper
    calls at the largest tick: ``(greedy_place kernels, all kernels)``,
    or None when it records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    n_tasks = [k["n_eff"] for _a, k in shadow.ticks]
    a, k = shadow.ticks[max(range(len(n_tasks)), key=n_tasks.__getitem__)]
    ck.cost_aware_cuda(*a, **k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ck.cost_aware_cuda(*a, **k)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not names:
        return None
    return sum("greedy_place" in n for n in names), len(names)


ENS_REPLICAS = 1024
ENS_CHECK_REPLICAS = 16
ENS_SMALL_REPLICAS = 4  # the card-vs-CPU check of the other arms
ENS_ARMS = ("cost-aware", "first-fit")
ENS_FIXTURE = "tests/data/ensemble_r16_seed0.npz"
ENS_FIELDS = ("makespan", "egress_cost", "finish_time", "placement",
              "n_unfinished", "instance_hours")
ENS_RTOL = 1e-5


def ensemble_argv(out, *extra):
    return ["--job-dir", "data/jobs", "--output-dir", out, "ensemble", *extra]


def ensemble_inputs(cli, device, n_apps=None):
    """The ``ensemble`` defaults' rollout inputs on ``device`` (float32)
    and the parsed defaults."""
    from pivot_tpu_torch.experiments.calibrate import (
        ensemble_inputs_from_schedule,
    )
    from pivot_tpu_torch.workload.trace import load_trace_jobs

    args = cli.parse_args(ensemble_argv("unused"))
    trace = cli._list_traces(args.job_dir, 1)[0]
    sched = load_trace_jobs(trace, args.scale_factor).take(
        n_apps or args.num_apps)
    workload, _sl, _arr, topo, avail0, sz = ensemble_inputs_from_schedule(
        sched, cli.build_cluster(cli._cluster_config(args)),
        dtype=torch.float32, device=device)
    return args, (avail0, workload, topo, sz)


def ensemble_compare(got, want, what, rows=None) -> float:
    """Placements, finish times, makespans, instance-hours and unfinished
    counts equal; egress within ``ENS_RTOL`` (a GEMM whose rounding
    differs between cuBLAS and XLA:CPU).  Returns egress's largest
    relative difference."""
    worst = 0.0
    for f in ENS_FIELDS:
        if f not in got or f not in want:
            continue
        g = np.asarray(got[f])[:rows]
        w = np.asarray(want[f])[:rows]
        if g.shape != w.shape:
            raise AssertionError(f"{what}: {f} shape {g.shape} vs {w.shape}")
        if f == "egress_cost":
            rel = np.abs(g.astype(np.float64) - w) / np.maximum(
                np.abs(w.astype(np.float64)), 1e-30)
            worst = max(worst, float(rel.max(initial=0.0)))
            if not np.allclose(g, w, rtol=ENS_RTOL, atol=0):
                raise AssertionError(f"{what}: {f} beyond rtol {ENS_RTOL} "
                                     f"(largest {rel.max()!r})")
        elif not np.array_equal(g, w):
            bad = np.argwhere(g != w)
            raise AssertionError(f"{what}: {f} differs at {len(bad)} "
                                 f"entries, first {bad[0].tolist()}")
    return worst


def _result(res) -> dict:
    return {f: getattr(res, f).cpu().numpy() for f in res._fields}


def ensemble_profile(on_card, args, key, policy, skip=600, window=50):
    """Device time by operator over ``window`` ticks of the R = 1024 tick
    loop, after ``skip`` unprofiled ticks (the middle of the run, where
    the cluster is loaded), by ``torch.profiler``: the window's host wall
    (the profiler's own host overhead in it), the device's busy time
    summed over its kernels, their ratio (the busy share) and the ten
    largest operators by self device time.  ``None`` when the profiler
    records no device time."""
    from torch.profiler import ProfilerActivity, profile

    from pivot_tpu_torch.parallel.ensemble import (
        _init_state,
        _perturbations,
        _rollout_segment,
    )

    avail0, workload, topo, sz = on_card
    rt, arr, anchor = _perturbations(key, workload, sz, ENS_REPLICAS,
                                     args.perturb, avail0.dtype)
    state = _init_state(avail0, workload.n_tasks, topo.cost.shape[0],
                        ENS_REPLICAS)
    kw = dict(totals=avail0, policy=policy, tick_order=args.tick_order)
    state = _rollout_segment(state, rt, arr, anchor, workload, topo,
                             args.tick, skip, **kw)
    st = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _rollout_segment(state, rt, arr, anchor, workload, topo, args.tick,
                         window, stats=st, **kw)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    # Kernels are device events; operators are host events charged with
    # the device time of the kernels they launch.
    total = sum(dev_us(e) for e in events
                if str(e.device_type).endswith("CUDA")) / 1e3
    ops = [(e.key, dev_us(e) / 1e3, e.count) for e in events
           if not str(e.device_type).endswith("CUDA")]
    if not total:
        return None
    ops.sort(key=lambda r: -r[1])
    return dict(policy=policy, ticks=st["ticks"],
                place_steps=st["place_steps"], wall_ms=wall_ms,
                device_busy_ms=total, busy_share=total / wall_ms,
                top=[dict(op=k, ms=ms, calls=c) for k, ms, c in ops[:10]])


def phase_ensemble(device):
    """Phase 6: the Monte-Carlo ensemble on the card.  The refund's sum
    order and (c) the R = 16 runs against ``pivot_tpu``'s fixture first
    (they also warm the card up); then (a) the main path, the CLI at
    R = 1024 for the cost-aware and first-fit arms; (e) a profiled
    window of each; (b) the R = 16 cost-aware run against the port on
    the CPU; (d) the other arms and lifo, card against CPU, at 10
    apps."""
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.ops import cuda_kernels as ck
    from pivot_tpu_torch.parallel.ensemble import prng, rollout

    out = {"checks": {}, "arms": {}}
    args, on_card = ensemble_inputs(cli, device)
    kw = dict(n_replicas=ENS_CHECK_REPLICAS, tick=args.tick,
              max_ticks=args.max_ticks, perturb=args.perturb,
              tick_order=args.tick_order)
    key = prng.PRNGKey(args.seed)
    # The refund sums each host's retiring tasks in task-index order: the
    # trace's demands are not integers, so that order must hold on the
    # card too (index_put_ with accumulate: sort by row, then one
    # sequential pass per row).
    dem = on_card[1].demands
    rng = np.random.default_rng(0)
    for n_rows in (1, 7, 600, 600 * 64):
        rows = torch.from_numpy(rng.integers(0, n_rows, dem.shape[0]))
        card = torch.zeros((n_rows, 4), device=device).index_put_(
            (rows.to(device),), dem, accumulate=True).cpu()
        cpu = torch.zeros((n_rows, 4)).index_put_(
            (rows,), dem.cpu(), accumulate=True)
        if not torch.equal(card, cpu):
            raise AssertionError(f"refund sums over {n_rows} rows: the card "
                                 "adds in another order than the CPU")
    log("  refund sums of the trace's demands (1 to 38400 rows): the card "
        "equals the CPU bit for bit")
    with np.load(ENS_FIXTURE) as z:
        fixture = {arm: {f: z[f"{arm.replace('-', '_')}__{f}"]
                         for f in ENS_FIELDS} for arm in ENS_ARMS}
    card16 = {}
    for arm in ENS_ARMS:
        st = {}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                res = rollout(key, *on_card, policy=arm, stats=st, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        card16[arm] = _result(res)
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        worst = ensemble_compare(card16[arm], fixture[arm],
                                 f"(c) {arm} card R=16 vs pivot_tpu fixture",
                                 rows=ENS_CHECK_REPLICAS)
        out["checks"][f"{arm}_fixture"] = dict(
            max_rel=worst, ticks=st["ticks"], place_steps=st["place_steps"],
            host_syncs=st["host_syncs"], sync_debug_warnings=syncs,
            wall_s=st["wall_s"], event_span_ms=st["event_span_ms"])
        log(f"  (c) {arm} R={ENS_CHECK_REPLICAS} on the card vs pivot_tpu's "
            f"fixture: placements, finish times, makespans, instance-hours, "
            f"unfinished equal; egress largest rel diff {worst!r}; "
            f"{st['ticks']} ticks, {st['place_steps']} placement steps, "
            f"{st['host_syncs']} host reads counted, {syncs} synchronizing "
            f"calls flagged by torch's sync debug mode")

    # (a) the main path: the CLI on the card at R = 1024.
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        for arm in ENS_ARMS:
            st = {}
            ck.reset_launches()  # the ensemble runs no hand kernel
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # The entry must turn TF32 off itself: hand it on.
            torch.backends.cuda.matmul.allow_tf32 = True
            summary = cli.run_ensemble(cli.parse_args(ensemble_argv(
                tmp, "--replicas", str(ENS_REPLICAS), "--policy", arm)),
                stats=st)
            peak = torch.cuda.max_memory_allocated()
            if torch.backends.cuda.matmul.allow_tf32:
                raise AssertionError("run_ensemble left TF32 matmuls on")
            if ck.LAUNCHES["greedy_place"]:
                raise AssertionError("the ensemble launched greedy_place")
            with np.load(os.path.join(st["out_dir"], "rollout.npz")) as z:
                got = {k: z[k] for k in z.files}
            T = on_card[1].n_tasks
            if (got["placement"].shape != (ENS_REPLICAS, T)
                    or not np.isfinite(got["makespan"]).all()
                    or not np.isfinite(got["egress_cost"]).all()
                    or summary["unfinished_max"] != 0
                    or not np.isfinite(got["finish_time"]).all()):
                raise AssertionError(f"(a) {arm}: malformed rollout.npz")
            # The draws are prefix-stable: the first 16 replicas are the
            # R = 16 run checked above.
            worst = ensemble_compare(got, card16[arm],
                                     f"(a) {arm} R={ENS_REPLICAS} prefix vs "
                                     f"R={ENS_CHECK_REPLICAS}",
                                     rows=ENS_CHECK_REPLICAS)
            row = dict(
                wall_s=summary["wall_s"],
                replica_rollouts_per_sec=summary["replica_rollouts_per_sec"],
                loop_wall_s=st["wall_s"], event_span_ms=st["event_span_ms"],
                ticks=st["ticks"], place_steps=st["place_steps"],
                host_syncs=st["host_syncs"], peak_mem_bytes=peak,
                makespan_mean=summary["makespan_mean"],
                egress_mean=summary["egress_mean"],
                instance_hours_mean=summary["instance_hours_mean"],
                prefix_max_rel=worst)
            out["arms"][arm] = row
            log(f"  (a) {arm} R={ENS_REPLICAS} through the CLI on the card: "
                f"wall {row['wall_s']!r} s, "
                f"{row['replica_rollouts_per_sec']!r} replica rollouts/s; "
                f"{row['ticks']} ticks, "
                f"{row['place_steps']} placement steps, {row['host_syncs']} "
                f"host reads; tick loop {row['loop_wall_s']!r} s on the host "
                f"clock, {row['event_span_ms']!r} ms of stream time between "
                f"CUDA events (idle gaps included: not busy time); peak "
                f"memory {peak / 2**30!r} GiB; rows 0-"
                f"{ENS_CHECK_REPLICAS - 1} equal the R={ENS_CHECK_REPLICAS} "
                f"run (rel diff {worst!r}); makespan mean "
                f"{row['makespan_mean']!r} s, egress mean "
                f"{row['egress_mean']!r} $, instance-hours mean "
                f"{row['instance_hours_mean']!r}")

    # (e) where the device time of a loaded tick goes.
    for arm in ENS_ARMS:
        prof = ensemble_profile(on_card, args, key, arm)
        out["profile_" + arm] = prof
        if prof is None:
            log(f"  (e) {arm}: torch.profiler recorded no device time: "
                "not measured")
            continue
        log(f"  (e) {arm} R={ENS_REPLICAS}, ticks 600-{600 + prof['ticks']}"
            f" under torch.profiler: {prof['wall_ms']!r} ms of host wall "
            f"(profiler overhead included), device busy "
            f"{prof['device_busy_ms']!r} ms = {prof['busy_share']!r} of it, "
            f"{prof['place_steps']} placement steps; largest: " + ", ".join(
                f"{r['op']} {r['ms']!r} ms / {r['calls']}"
                for r in prof["top"]))

    # (b) the R = 16 run against the port on the CPU.
    _, on_cpu = ensemble_inputs(cli, "cpu")
    t0 = time.perf_counter()
    cpu16 = _result(rollout(key, *on_cpu, policy="cost-aware", **kw))
    cpu_s = time.perf_counter() - t0
    worst = ensemble_compare(card16["cost-aware"], cpu16,
                             "(b) cost-aware card R=16 vs the port on the CPU")
    out["checks"]["cost-aware_cpu"] = dict(max_rel=worst, cpu_wall_s=cpu_s)
    log(f"  (b) cost-aware R={ENS_CHECK_REPLICAS} on the card vs the port on "
        f"the CPU ({cpu_s!r} s there): placements, finish times, makespans, "
        f"instance-hours, unfinished equal; egress largest rel diff "
        f"{worst!r}")

    # (d) the other arms and lifo, card vs CPU, at 10 apps.
    _, small_card = ensemble_inputs(cli, device, n_apps=10)
    _, small_cpu = ensemble_inputs(cli, "cpu", n_apps=10)
    for arm, order in (("best-fit", "fifo"), ("opportunistic", "fifo"),
                       ("cost-aware", "lifo"), ("first-fit", "lifo")):
        kw10 = dict(kw, tick_order=order, n_replicas=ENS_SMALL_REPLICAS)
        st = {}
        got = _result(rollout(key, *small_card, policy=arm, stats=st,
                              **kw10))
        worst = ensemble_compare(got, _result(rollout(
            key, *small_cpu, policy=arm, **kw10)),
            f"(d) {arm} {order} card vs CPU at 10 apps")
        if got["n_unfinished"].max() != 0:
            raise AssertionError(f"(d) {arm} {order}: tasks unfinished")
        out["checks"][f"{arm}_{order}_10apps"] = dict(max_rel=worst,
                                                      ticks=st["ticks"])
        log(f"  (d) {arm} {order}, 10 apps "
            f"({small_card[1].n_tasks} tasks), R={ENS_SMALL_REPLICAS}: card "
            f"equals CPU, rel diff {worst!r}, {st['ticks']} ticks")

    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "smoke runs only on a machine with a CUDA card",
              file=sys.stderr)
        return 2
    if not os.path.isdir("pivot_tpu_torch"):
        print("chip_smoke: run from the root of a pivot_tpu checkout",
              file=sys.stderr)
        return 2
    from pivot_tpu_torch.ops import build
    from pivot_tpu_torch.ops import cuda_kernels as ck

    t_start = time.perf_counter()
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log("== 1. environment")
    log(card)
    nvcc = subprocess.run([build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True, timeout=60)
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {nvcc.stdout.strip().splitlines()[-1]}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ptxas = ptxas_usage_start(build, tmp)  # beside the build
        paths = build.build_all()
        log(f"  built {sorted(paths)} in {time.perf_counter() - t0:.2f} s "
            f"(nvcc {' '.join(build.NVCC_FLAGS)})")
        for line in ptxas_usage_lines(ptxas):
            log(f"  ptxas {line}")
    check_shape_tables(build, ck)
    arith_check(build)

    log("== 2. greedy_place vs plain on the card (f32)")
    chk = phase_kernel_vs_plain(ck, device)
    log(f"  {chk.cases} cases, {chk.placed} placements: all equal, max "
        f"|avail diff| {chk.max_abs_err!r} (rtol {RTOL}, atol {ATOL})")

    log("== 3. overall, 600 hosts x 1000 apps: cuda with fused spans, "
        "cuda with fusion off, numpy")
    e2e = phase_end_to_end(device)
    shadow = e2e["shadow"]

    log(f"== 4. sensitivity on the card: 600 hosts, R={SENS_REPLICAS}, "
        f"Cost-Aware x {SENS_APPS['cost-aware']} apps and VBP x "
        f"{SENS_APPS['vbp']} apps under a seeded spot market")
    sens = phase_sensitivity(device)
    ca = sens["cost-aware"]

    log("== 5. times on the card")
    times = phase_times(ck, shadow, device)
    gt = gated_times(ck, ca.pop("calls"))
    lt = times["largest_tick"]
    log(f"  [{card}]")
    mk = times["tick_median_kernel"]
    log(f"  wrapper per tick: median {times['tick_median_ms']!r} ms over "
        f"{len(shadow.ticks)} ticks (median n_eff "
        f"{times['tick_n_eff_median']}); kernel_ms at the median tick "
        f"{mk['kernel_ms']!r}, {mk['ns_per_step']!r} ns per step")
    log(f"  largest tick (n_eff={lt['n_eff']}, bucket {lt['bucket']}, "
        f"H={lt['H']}): wrapper {lt['ms']!r} ms, kernel_ms "
        f"{lt['kernel_ms']!r}, {lt['ns_per_step']!r} ns per step, plain "
        f"{lt['plain_ms']!r} ms, bound {lt['bound_ms']!r} ms "
        f"({lt['bound_by']})")
    for key in ("T619_H600", "T2048_H600", "R256_T619_H600"):
        t = times[key]
        log(f"  {key}: wrapper {t['ms']!r} ms, kernel_ms {t['kernel_ms']!r},"
            f" {t['ns_per_step']!r} ns per step, plain {t['plain_ms']!r} ms,"
            f" bound {t['bound_ms']!r} ms ({t['bound_by']})")
    log("  ns per step (T=2048, H=600, default shape): " + ", ".join(
        f"{k} {v!r}" for k, v in times["step_ns"].items())
        + f"; group entries are {times['main_path_entry_share']!r} of the "
        "main path's tasks")
    for key, row in times["sweep"].items():
        log(f"  sweep {key} (default W={row['default_warps']}): " + ", ".join(
            f"W={w} K={r['K']} G={r['groups']} {r['kernel_ms']!r} ms"
            for w, r in row["by_warps"].items()))
    prof = profile_kernels(ck, shadow)
    if prof is None:
        log("  torch.profiler recorded no device kernels: one-kernel check "
            "not made")
    else:
        log(f"  torch.profiler: {prof[0]} greedy_place kernels of "
            f"{prof[1]} device kernels over 10 wrapper calls")
        if prof != (10, 10):
            raise AssertionError("a wrapper call is not exactly one kernel")
    ca_wall = e2e["runs"]["cuda"]["arms"]["Cost-Aware"]["wall_clock"]
    log(f"  greedy_place busy: {times['tick_sum_ms']!r} ms of wrapper time "
        f"over the run's ticks = {times['tick_sum_ms'] / (ca_wall * 1e3)!r} "
        f"of the Cost-Aware arm's {ca_wall!r} s wall on cuda")
    log(f"  greedy_place in spans: median {times['span_tick_median_ms']!r}"
        f" ms of wrapper time over {len(shadow.span_ticks)} span ticks "
        f"(median n_eff {times['span_tick_n_eff_median']}), "
        f"{times['span_tick_sum_ms']!r} ms in all")
    for name in ("cuda", "cuda_off", "numpy"):
        r = e2e["runs"][name]
        log(f"  overall on {name}: {r['wall']!r} s for 3 arms; per arm "
            + ", ".join(f"{a} {r['arms'][a]['wall_clock']!r} s"
                        for a in ARMS))
    spans = {}
    for arm in ARMS:
        st = e2e["runs"]["cuda"]["arms"][arm]["spans"]
        dev = e2e["runs"]["cuda"]["spans"][arm]
        spans[arm] = dict(st, **dev, launches=(
            e2e["runs"]["cuda"]["arms"][arm]["dispatch"]))
        log(f"  spans {arm}: {st['fused_spans']} served, {st['fused_ticks']}"
            f" ticks replayed ({st['fused_ticks'] / max(st['fused_spans'], 1)!r}"
            f" a span), {st['span_aborts']} aborted, {st['spans_declined']} "
            f"declined, {st['ff_ticks']} ticks fast-forwarded; on the card "
            f"{dev['spans']} spans of {dev['horizon_ticks']} horizon ticks, "
            f"{dev['ticks_run']} executed, {dev['steps']} pass steps walked "
            f"for {dev['live_steps']} live ones; device "
            f"ms per span median {dev['ms_median']!r}, largest "
            f"{dev['ms_max']!r}, sum {dev['ms_sum']!r}; no host sync inside")
    for arm, d in e2e["same_files"].items():
        log(f"  fusion on vs off, {arm}: " + (
            "output files byte-identical" if d is None else
            f"files differ: {d['differing_tasks']} tasks placed "
            f"differently, first {d['first']} on {d['first_on']} (on) vs "
            f"{d['first_off']} (off); float32 tie of demand norms possible: "
            f"{d['f32_norm_tie']}"))
    gl = gt["largest"]
    log(f"  gated Cost-Aware tick (R={SENS_REPLICAS}, H=600, market cost "
        f"slice): wrapper median {gt['ms_median']!r} ms, largest "
        f"{gt['ms_max']!r}, sum {gt['ms_sum']!r} over {ca['ticks']} ticks; "
        f"kernel_ms median {gt['kernel_ms_median']!r}, largest "
        f"{gt['kernel_ms_max']!r}, sum {gt['kernel_ms_sum']!r}; median n_eff "
        f"{gt['n_eff_median']}; largest n_eff {gl['n_eff']}: wrapper "
        f"{gl['ms']!r} ms, kernel_ms {gl['kernel_ms']!r}, plain "
        f"{gl['plain_ms']!r} ms, bound {gl['bound_ms']!r} ms "
        f"({gl['bound_by']})")
    for policy, r in sens.items():
        per = {k: v * 1e3 / r["ticks"] for k, v in r["parts"].items()}
        log(f"  gated {policy} tick, host ms (noise / stage / pass enqueue /"
            f" fetch+unpad incl. the device wait / _mc_sensitivity total): "
            f"{per['noise']!r} / {per['stage']!r} / {per['pass']!r} / "
            f"{per['fetch_unpad']!r} / {per['total']!r}")
    log(f"== 6. the Monte-Carlo ensemble on the card: 600 hosts x 50 apps, "
        f"R={ENS_REPLICAS} ({', '.join(ENS_ARMS)}), checked at "
        f"R={ENS_CHECK_REPLICAS}")
    log(f"  [{card}]")
    ens = phase_ensemble(device)
    log(json.dumps({"times": times, "spans": spans, "ensemble": ens,
                    "same_files": e2e["same_files"], "gated_times": gt,
                    "sensitivity": {p: {k: v for k, v in r.items()
                                        if k != "check"}
                                    for p, r in sens.items()}},
                   default=str))

    record = {"kernels": [{
        "name": "greedy_place",
        "route": "cuda",
        "source": "pivot_tpu_torch/csrc/greedy_place.cu",
        "replaces": "pivot_tpu/ops/pallas_kernels.py:265",
        "launches": (e2e["runs"]["cuda"]["launches"]
                     + sum(ca["launches"].values())),
        "launches_r1": (e2e["runs"]["cuda"]["launches"]
                        + ca["launches"][1]),
        f"launches_r{SENS_REPLICAS}": ca["launches"][SENS_REPLICAS],
        "max_abs_err": max(chk.max_abs_err, shadow.check.max_abs_err,
                           e2e["referee"].max_abs_err,
                           ca["check"].max_abs_err),
        "ms": lt["ms"],
        "plain_ms": lt["plain_ms"],
        "bound_ms": lt["bound_ms"],
        "bound_by": lt["bound_by"],
        "library_ms": None,
        f"r{SENS_REPLICAS}_ms": gt["ms_median"],
        f"r{SENS_REPLICAS}_kernel_ms": gt["kernel_ms_median"],
    }]}
    log(f"  smoke wall: {time.perf_counter() - t_start!r} s")
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
