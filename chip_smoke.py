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
     point, on ``--device cuda --no-adaptive`` and on ``--device numpy``.
     Every Cost-Aware tick must be a kernel launch, the arms' egress-cost
     and runtime rankings must agree between the backends, and a second
     Cost-Aware run shadows every tick with the plain version (identical
     placements required) and checks ``placement_sensitivity`` (R = 256)
     against the plain batched version at each new largest tick;
  4. times on the card by CUDA events: the wrapper the main path calls
     per tick (median over the run's ticks, and at T = 619 / 2048,
     H = 600), the R = 256 launch, the plain version, and the roofline
     bound; beside each wrapper time the bare launch (``kernel_ms``,
     ``_launch`` on checked operands) and its ns per task step; ns per
     step with one group entry, an entry at every task and best-fit, and
     the share of the main path's tasks that are group entries; the
     sweep of warps per replica at H = 600 that sets ``_launch_config``;
     and, where ``torch.profiler`` sees the card, one device kernel per
     wrapper call.

The line before the last is a JSON ``kernels`` record; the last line is
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


def make_shadow_policy(cuda_mod, ck):
    base = cuda_mod.CudaCostAwarePolicy

    class ShadowCostAware(base):
        """The Cost-Aware device policy with every kernel call shadowed
        by the plain version on the same staged tensors."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.check = Check()
            self.ticks = []  # (args, kw) of every tick, for timing
            self.largest = 0
            self.sensitivity = None

        def _greedy(self, *args, **kw):
            got = super()._greedy(*args, **kw)
            self.check.same(got, ck.cost_aware_plain(*args, **kw),
                            ("tick", len(self.ticks)))
            self.ticks.append((args, kw))
            return got

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
    from pivot_tpu_torch.sched import cuda as cuda_mod
    from pivot_tpu_torch.utils.config import build_cluster

    res = {}
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        job_dir = os.path.join(tmp, "jobs")
        os.makedirs(job_dir)
        os.symlink(os.path.abspath(TRACE),
                   os.path.join(job_dir, os.path.basename(TRACE)))
        runs = {}
        for backend in ("cuda", "numpy"):
            argv = overall_argv(os.path.join(tmp, backend), job_dir, backend)
            argv[argv.index("600")] = str(n_hosts)
            argv[-1] = str(n_apps)
            args = cli.parse_args(argv)
            cluster_cfg = cli._cluster_config(args)
            ck.reset_launches()  # the main path's count starts here
            t0 = time.perf_counter()
            exp_dir, summaries = cli.run_overall(args, torch_device=device)
            wall = time.perf_counter() - t0
            launches = ck.LAUNCHES["greedy_place"]
            check_outputs(exp_dir)
            runs[backend] = dict(wall=wall, launches=launches,
                                 arms={s["label"]: s for s in summaries})
        cuda, numpy_ = runs["cuda"]["arms"], runs["numpy"]["arms"]
        ca = cuda["Cost-Aware"]["dispatch"]
        log(f"  cost-aware on cuda: {ca['device_ticks']} device ticks, "
            f"{ca['kernel_ticks']} served by greedy_place, "
            f"{runs['cuda']['launches']} launches counted")
        if not (ca["device_ticks"] > 0
                and runs["cuda"]["launches"] == ca["kernel_ticks"]
                == ca["device_ticks"]):
            raise AssertionError("not every Cost-Aware tick was a launch")
        for arm in ARMS[:2]:
            if cuda[arm]["dispatch"]["kernel_ticks"]:
                raise AssertionError(f"{arm} went through the kernel")
        for metric in ("egress_cost", "avg_runtime"):
            rankings_agree(cuda, numpy_, metric)
        for arm in ARMS:
            log(f"  {arm:13s} cuda: egress_cost={cuda[arm]['egress_cost']!r} "
                f"avg_runtime={cuda[arm]['avg_runtime']!r} "
                f"wall_s={cuda[arm]['wall_clock']!r} | numpy: "
                f"egress_cost={numpy_[arm]['egress_cost']!r} "
                f"avg_runtime={numpy_[arm]['avg_runtime']!r} "
                f"wall_s={numpy_[arm]['wall_clock']!r}")
        res["runs"] = runs

        # The shadowed Cost-Aware run: same cluster, trace, seed.
        Shadow = make_shadow_policy(cuda_mod, ck)
        pc = cli.reference_policy_set("cuda", adaptive=False)[2]
        policy = Shadow(bin_pack=pc.bin_pack, sort_tasks=pc.sort_tasks,
                        sort_hosts=pc.sort_hosts, device=device)
        summary = runner.ExperimentRun(
            "Cost-Aware", build_cluster(cluster_cfg), policy, TRACE,
            n_apps=n_apps, seed=0).run()
        for key in ("egress_cost", "avg_runtime"):
            if summary[key] != cuda["Cost-Aware"][key]:
                raise AssertionError(f"shadowed run differs on {key}")
        log(f"  shadow: {len(policy.ticks)} ticks, {policy.check.cases} "
            f"kernel-vs-plain comparisons, all placements equal, max "
            f"|avail diff| {policy.check.max_abs_err!r}; sensitivity R=256 "
            f"at largest tick T={policy.sensitivity[0]}: mean stability "
            f"{policy.sensitivity[1]!r}")
        res["shadow"] = policy
    return res


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

    log("== 3. overall, 600 hosts x 1000 apps, cuda and numpy")
    e2e = phase_end_to_end(device)
    shadow = e2e["shadow"]

    log("== 4. times on the card")
    times = phase_times(ck, shadow, device)
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
    for backend in ("cuda", "numpy"):
        r = e2e["runs"][backend]
        log(f"  overall on {backend}: {r['wall']!r} s for 3 arms; per arm "
            + ", ".join(f"{a} {r['arms'][a]['wall_clock']!r} s"
                        for a in ARMS))
    log(json.dumps({"times": times}))

    record = {"kernels": [{
        "name": "greedy_place",
        "route": "cuda",
        "source": "pivot_tpu_torch/csrc/greedy_place.cu",
        "replaces": "pivot_tpu/ops/pallas_kernels.py:265",
        "launches": e2e["runs"]["cuda"]["launches"],
        "max_abs_err": max(chk.max_abs_err, shadow.check.max_abs_err),
        "ms": lt["ms"],
        "plain_ms": lt["plain_ms"],
        "bound_ms": lt["bound_ms"],
        "bound_by": lt["bound_by"],
        "library_ms": None,
    }]}
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
