#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``pivot_tpu_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, each fatal on failure:

  1. environment: the card (``nvidia-smi`` name and power limit), torch,
     CUDA and nvcc versions, and the build of every hand-written kernel;
  2. ``greedy_place`` against its plain torch version on the card, float32:
     the five cost-aware modes over six (T, H) shapes, the edge cases
     (T = 0, nothing fits, invalid tasks, a ``live`` mask, a ``risk``
     row) and the replica-batched launch at R = 5 and R = 256, each on
     sparse inputs (few tasks fit) and dense ones (most place, with a
     floor on the placements made).  Placements must be equal;
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
     bound.

The line before the last is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside a
checkout of the repository, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
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

    times = {}
    per_tick = [_events_ms(wrapper(a, k), 5) for a, k in shadow.ticks]
    n_tasks = [k["n_eff"] for _a, k in shadow.ticks]
    times["tick_median_ms"] = statistics.median(per_tick)
    times["tick_sum_ms"] = sum(per_tick)
    times["tick_n_eff_median"] = statistics.median(n_tasks)
    big = max(range(len(n_tasks)), key=n_tasks.__getitem__)
    a, k = shadow.ticks[big]
    times["largest_tick"] = dict(
        n_eff=n_tasks[big], bucket=a[1].shape[0], H=a[0].shape[0],
        ms=_events_ms(wrapper(a, k), 20),
        plain_ms=_host_ms(lambda: ck.cost_aware_plain(*a, **k), 3),
        max_abs_err=shadow.check.max_abs_err,
    )
    times["largest_tick"]["bound_ms"], times["largest_tick"]["bound_by"] = \
        bound(a, k, 1, n_tasks[big])
    mode = MODES[0]  # the Cost-Aware arm's mode (first-fit, sorted hosts)
    for T in (619, 2048):
        args = make_inputs(5, T, 600, device)
        b_ms, b_by = bound(args, mode, 1, T)
        times[f"T{T}_H600"] = dict(
            ms=_events_ms(wrapper(args, mode), 20),
            plain_ms=_host_ms(lambda: ck.cost_aware_plain(*args, **mode), 3),
            bound_ms=b_ms, bound_by=b_by)
    args = make_inputs(6, 619, 600, device)
    noise = torch.from_numpy(np.random.default_rng(9).uniform(
        0.95, 1.05, (256, 600, 1)).astype(np.float32)).to(device)
    args[0] = (args[0][None] * noise).contiguous()
    b_ms, b_by = bound(args, mode, 256, 619)
    times["R256_T619_H600"] = dict(
        ms=_events_ms(wrapper(args, mode), 5),
        plain_ms=_host_ms(lambda: ck.cost_aware_plain_batched(
            *args, **mode), 1),
        bound_ms=b_ms, bound_by=b_by)
    return times


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
    paths = build.build_all()
    log(f"  built {sorted(paths)} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")

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
    log(f"  wrapper per tick: median {times['tick_median_ms']!r} ms over "
        f"{len(shadow.ticks)} ticks (median n_eff "
        f"{times['tick_n_eff_median']})")
    log(f"  largest tick (n_eff={lt['n_eff']}, bucket {lt['bucket']}, "
        f"H={lt['H']}): wrapper {lt['ms']!r} ms, plain {lt['plain_ms']!r} "
        f"ms, bound {lt['bound_ms']!r} ms ({lt['bound_by']})")
    for key in ("T619_H600", "T2048_H600", "R256_T619_H600"):
        t = times[key]
        log(f"  {key}: wrapper {t['ms']!r} ms, plain {t['plain_ms']!r} ms, "
            f"bound {t['bound_ms']!r} ms ({t['bound_by']})")
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
