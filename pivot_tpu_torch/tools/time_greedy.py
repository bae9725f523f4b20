"""Time ``greedy_place`` on the card through the wrappers the main path
calls, and compare two checkouts of the repo.

    python -m pivot_tpu_torch.tools.time_greedy [--reps 50]
    python -m pivot_tpu_torch.tools.time_greedy --against DIR

Alone, it times this tree's wrappers by CUDA events over back-to-back
calls (``--reps``), first-fit with sorted hosts (the Cost-Aware arm of
``overall``) on seeded f32 ticks: ``cost_aware_cuda`` at 600 hosts,
T = 619 and 2,048, ``cost_aware_cuda_batched`` at R = 256, T = 619 and
``cost_aware_cuda_rows`` at G = 2, T = 619 (row 1 bounded at 400
steps); and at 9,664 hosts (the one-CTA shared-memory build)
``cost_aware_cuda`` at T = 619 and ``cost_aware_cuda_rows`` at G = 2;
beside each wrapper the bare launch (``_check`` once, then ``_launch``,
``kernel_ms``).  Each output is held against the plain form on the same
inputs and hashed.  It prints the card's ``nvidia-smi`` name and power
limit and one JSON line (``--json-out FILE`` writes it there too).

With ``--against DIR`` (another checkout, e.g. a parent commit unpacked
by ``git archive`` into a directory ``.gitignore`` lists) it runs itself
as four processes, DIR, this tree, this tree, DIR (``abtime.compare``),
requires every output hash to agree across the four, and prints each
shape's mean ms of the two trees and their ratio (this tree over DIR's);
then it times the pod tick on this tree alone, H = 98,304 at T = 256
(``chip_smoke.py`` phase 15's tick), R = 1, beside the Cost-Aware torch
pass (``ops/kernels.py::cost_aware_impl``) it equals: a tree whose
kernel stops at 10,240 hosts cannot launch there.
"""

from __future__ import annotations

import numpy as np
import torch

if __package__:
    from pivot_tpu_torch.tools import abtime
else:  # a child of --against: the harness of this file's own tree
    import abtime

Z = 31
H_MAIN = 600
H_SMEM = 9664  # the one-CTA shared-memory build (K = 10, 1,024 threads)
R_GATE = 256
G_ROWS = 2
ROW_BOUND = 400
POD = (98304, 256)
MODE = dict(bin_pack="first-fit", sort_hosts=True, host_decay=False)


def _inputs(seed, T, H, device):
    """A seeded f32 tick: availability in [0, 16), demands on two lanes
    (dimension 1 in [0, 4), so that most tasks place), 20% group entries
    (``chip_smoke.make_inputs``'s dense pattern)."""
    rng = np.random.default_rng(seed)
    avail = rng.uniform(0, 16, size=(H, 4)).astype(np.float32)
    demands = np.stack([
        rng.choice([0.0, 0.5, 1.0, 2.0, 4.0], size=T),
        rng.uniform(0, 4, size=T), np.zeros(T), np.zeros(T),
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


def _rows(seed, H, device):
    """``G_ROWS`` seeded rows at T = 619, row 1 on bound ``ROW_BOUND``:
    ``(args, kw, steps)`` of ``cost_aware_cuda_rows``."""
    rows = [_inputs(seed + g, 619, H, "cpu") for g in range(G_ROWS)]
    bounds = [619] + [ROW_BOUND] * (G_ROWS - 1)
    for row, n in zip(rows, bounds):
        row[2][n:] = False  # the bound is one past the last valid task
    args = [torch.stack([row[i] for row in rows]).to(device)
            for i in range(9)]
    kw = dict(MODE, n_eff_g=torch.tensor(bounds, dtype=torch.int32,
                                         device=device))
    return args, kw, sum(bounds)


def shapes(device) -> dict:
    """``{key: (form, args, kw, steps)}`` of every timed shape; ``form``
    names the wrapper (``cost_aware_cuda[_batched|_rows]``)."""
    out = {}
    for T in (619, 2048):
        out[f"R=1 T={T} H={H_MAIN}"] = (
            "", _inputs(200 + T, T, H_MAIN, device), dict(MODE), T)
    args = _inputs(300, 619, H_MAIN, device)
    noise = torch.from_numpy(np.random.default_rng(9).uniform(
        0.95, 1.05, (R_GATE, H_MAIN, 1)).astype(np.float32)).to(device)
    args[0] = (args[0][None] * noise).contiguous()
    out[f"R={R_GATE} T=619 H={H_MAIN}"] = ("_batched", args, dict(MODE),
                                           619)
    out[f"G={G_ROWS} T=619 H={H_MAIN}"] = ("_rows", *_rows(400, H_MAIN,
                                                           device))
    out[f"R=1 T=619 H={H_SMEM}"] = (
        "", _inputs(500, 619, H_SMEM, device), dict(MODE), 619)
    out[f"G={G_ROWS} T=619 H={H_SMEM}"] = ("_rows", *_rows(600, H_SMEM,
                                                           device))
    return out


def _bare(ck, form, args, kw):
    """The kernel alone: ``_check`` (``_check_rows``) once, outputs
    allocated once, then ``_launch``, the wrapper's one launch site."""
    ff = kw["bin_pack"] == "first-fit"
    if form == "_rows":
        G, T, _H, cfg = ck._check_rows(*args, kw["bin_pack"], None, None,
                                       kw["n_eff_g"])
        p = torch.empty((G, T), dtype=torch.int32, device=args[0].device)
        o = torch.empty_like(args[0])
        return lambda: ck._launch(cfg, *args, None, None, p, o, T, ff,
                                  kw["sort_hosts"], kw["host_decay"],
                                  n_eff_rows=kw["n_eff_g"])
    a = [args[0] if args[0].dim() == 3 else args[0][None], *args[1:]]
    R, T, _H, n, cfg = ck._check(*a, kw["bin_pack"], None, None, None)
    p = torch.empty((R, T), dtype=torch.int32, device=a[0].device)
    o = torch.empty_like(a[0])
    return lambda: ck._launch(cfg, *a, None, None, p, o, n, ff,
                              kw["sort_hosts"], kw["host_decay"])


def measure(reps) -> dict:
    """This tree's times: ``{key: {ms, kernel_ms, reps, steps, inputs,
    outputs}}`` (``inputs`` / ``outputs`` are hashes)."""
    from pivot_tpu_torch.ops import cuda_kernels as ck

    device = torch.device("cuda")
    out = {}
    for key, (form, args, kw, steps) in shapes(device).items():
        fn = getattr(ck, f"cost_aware_cuda{form}")
        plain = getattr(ck, f"cost_aware_plain{form}")
        placements, avail = fn(*args, **kw)
        want_p, want_a = plain(*args, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(placements, want_p)
                and torch.allclose(avail, want_a, rtol=1e-6, atol=1e-5)):
            raise AssertionError(f"{key}: the kernel differs from the "
                                 "plain form")
        out[key] = dict(
            ms=abtime.events_ms(lambda: fn(*args, **kw), reps),
            kernel_ms=abtime.events_ms(_bare(ck, form, args, kw), reps),
            reps=reps, steps=steps,
            inputs=abtime.digest(*args, *(v for v in kw.values()
                                          if torch.is_tensor(v))),
            outputs=abtime.digest(placements, avail))
    return out


def measure_pod(reps) -> dict:
    """The pod tick on this tree: ``cost_aware_cuda`` (wrapper and bare
    launch) beside the Cost-Aware torch pass, which it must equal."""
    from pivot_tpu_torch.ops import cuda_kernels as ck
    from pivot_tpu_torch.ops.kernels import cost_aware_impl

    device = torch.device("cuda")
    H, T = POD
    args = _inputs(15, T, H, device)
    args[0] = (args[0] * torch.linspace(0.05, 1.0, H, device=device)[:, None]
               ).contiguous()  # low-index hosts fuller
    kw = dict(MODE, n_eff=T)
    got = ck.cost_aware_cuda(*args, **kw)
    want = cost_aware_impl(*args, **MODE)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0])
            and torch.allclose(got[1], want[1], rtol=1e-6, atol=1e-5)):
        raise AssertionError("the pod tick: greedy_place differs from the "
                             "torch pass")
    cfg = ck._launch_config(1, H, Z)
    return {f"R=1 T={T} H={H}": dict(
        ms=abtime.events_ms(lambda: ck.cost_aware_cuda(*args, **kw), reps),
        kernel_ms=abtime.events_ms(_bare(ck, "", args, MODE), reps),
        torch_ms=abtime.events_ms(lambda: cost_aware_impl(*args, **MODE),
                                  reps),
        reps=reps, steps=T, placed=int((got[0] >= 0).sum()),
        cluster=cfg.cluster, warps=cfg.warps, state=cfg.state)}


def main(argv=None) -> None:
    abtime.main(argv, script=__file__, doc=__doc__, measure=measure,
                reps=50, fields=("ms", "kernel_ms"),
                alone=lambda: {"pod": measure_pod(5)})


if __name__ == "__main__":
    main()
