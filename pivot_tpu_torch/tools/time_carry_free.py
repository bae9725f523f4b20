"""Time ``carry_free_place`` on the card through the wrappers the main
path calls, at the shapes its launch rule was judged on, and compare two
checkouts of the repo.

    python -m pivot_tpu_torch.tools.time_carry_free [--reps 20]
    python -m pivot_tpu_torch.tools.time_carry_free --against DIR

Alone, it times this tree's wrappers (``opportunistic_cuda``,
``first_fit_cuda``, ``best_fit_cuda`` and the two R-replica forms) by
CUDA events over back-to-back calls (``--reps``; 5 at the pod tick) on
seeded dense f32 ticks — H = 600 at T = 619 and 2,048, R = 256 at
T = 619, the pod tick H = 98,304 at T = 256 with the low half of the
hosts fuller (``chip_smoke.py`` phase 19's inputs, same seeds) — and on
the largest Opportunistic and VBP ticks of ``overall`` at 600 hosts x
100 apps on ``cuda`` (the run's calls recorded on ``sched.cuda``).  Each
output is held against the plain form on the same inputs, and hashed.
It prints the card's ``nvidia-smi`` name and power limit and one JSON
line (``--json-out FILE`` writes it there too).

With ``--against DIR`` (another checkout, e.g. a parent commit unpacked
by ``git archive`` into a directory ``.gitignore`` lists) it runs itself
as four processes, DIR, this tree, this tree, DIR, each on its own
tree's package and build, requires every output hash and recorded tick
to agree across the four, and prints each shape's mean ms of the two
trees and their ratio (this tree over DIR's; ``abtime.compare``).  The
wrappers' signatures are the interface, so DIR needs no copy of this
file.
"""

from __future__ import annotations

import functools
import os
import tempfile

import numpy as np
import torch

if __package__:
    from pivot_tpu_torch.tools import abtime
else:  # a child of --against: the harness of this file's own tree
    import abtime

H_MAIN = 600
R_GATE = 256
POD = (98304, 256)
TRACE = "data/jobs/jobs-5000-200-86400-172800.npz"
ARMS = ("opportunistic", "first-fit", "best-fit")
#: ``overall``'s arm label -> the wrapper its ticks call.
OVERALL_WRAPPERS = {"Opportunistic": "opportunistic_cuda",
                    "VBP": "first_fit_cuda"}


def _dense(seed, T, H, device, R=None):
    """A seeded dense tick (``chip_smoke.p19_inputs``' default case):
    availability in [0, 16), demands on three lanes, every task valid."""
    rng = np.random.default_rng(seed)
    avail = rng.uniform(0, 16, size=(H, 4) if R is None else (R, H, 4))
    dem = np.stack([rng.choice([0.0, 0.5, 1.0, 2.0], size=T),
                    rng.uniform(0, 4, size=T), rng.uniform(0, 2, size=T),
                    np.zeros(T)], axis=1)
    u = rng.uniform(size=T)
    x = dict(avail=avail.astype(np.float32), dem=dem.astype(np.float32),
             valid=np.ones(T, bool), u=u.astype(np.float32))
    return {k: torch.from_numpy(v).to(device) for k, v in x.items()}


def _call(ck, arm, x, form):
    """``arm``'s wrapper (``form`` "cuda") or plain form on ``x`` as
    positional operands and keywords: ``(fn, args, kw)``."""
    stem = arm.replace("-", "_")
    a, d, v = x["avail"], x["dem"], x["valid"]
    if a.dim() == 3:
        return getattr(ck, f"{stem}_{form}_batched"), (a, d, v), {}
    if arm == "opportunistic":
        return getattr(ck, f"opportunistic_{form}"), (a, d, v, x["u"]), {}
    return getattr(ck, f"{stem}_{form}"), (a, d, v), {}


def _overall_ticks(device) -> dict:
    """The largest (most steps) Opportunistic and VBP ticks of ``overall``
    at 600 hosts x 100 apps on ``device``, fused spans on: ``{label:
    (wrapper name, args, kw)}``, operands cloned when recorded."""
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.sched import cuda as cuda_mod

    best = {}  # wrapper name -> (steps, args, kw)

    def recorder(name, fn):
        @functools.wraps(fn)
        def recorded(*a, **k):
            steps = k.get("n_bound")
            steps = int(a[2].sum()) if steps is None else int(steps)
            if name not in best or steps > best[name][0]:
                best[name] = (steps, tuple(
                    t.clone() if torch.is_tensor(t) else t for t in a),
                    {n: v.clone() if torch.is_tensor(v) else v
                     for n, v in k.items()})
            return fn(*a, **k)
        return recorded

    saved = {n: getattr(cuda_mod, n) for n in OVERALL_WRAPPERS.values()}
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        jobs = os.path.join(tmp, "jobs")
        os.makedirs(jobs)
        os.symlink(os.path.abspath(TRACE),
                   os.path.join(jobs, os.path.basename(TRACE)))
        argv = ["--device", "cuda", "--no-adaptive", "--num-hosts",
                str(H_MAIN), "--job-dir", jobs, "--output-dir",
                os.path.join(tmp, "out"), "--seed", "0", "overall",
                "--num-apps", "100"]
        for n, fn in saved.items():
            setattr(cuda_mod, n, recorder(n, fn))
        try:
            cli.run_overall(cli.parse_args(argv), torch_device=device.type)
        finally:
            for n, fn in saved.items():
                setattr(cuda_mod, n, fn)
    return {label: (name, best[name][1], best[name][2])
            for label, name in OVERALL_WRAPPERS.items() if name in best}


def shapes(ck, device) -> dict:
    """``{key: (wrapper, plain, args, kw)}`` of every timed shape."""
    out = {}
    for T in (619, 2048):
        x = _dense(200 + T, T, H_MAIN, device)
        for arm in ARMS:
            out[f"{arm} T={T} H={H_MAIN}"] = (arm, x)
    x = _dense(300, 619, H_MAIN, device, R=R_GATE)
    for arm in ARMS[1:]:
        out[f"{arm} R={R_GATE} T=619 H={H_MAIN}"] = (arm, x)
    pod = _dense(7, POD[1], POD[0], device)
    pod["avail"][: POD[0] // 2] *= 0.25  # low-index hosts fuller
    for arm in ARMS:
        out[f"{arm} T={POD[1]} H={POD[0]}"] = (arm, pod)
    calls = {}
    for key, (arm, x) in out.items():
        fn, args, kw = _call(ck, arm, x, "cuda")
        plain = _call(ck, arm, x, "plain")[0]
        calls[key] = (fn, plain, args, kw)
    for label, (name, args, kw) in _overall_ticks(device).items():
        calls[f"largest {label} tick of overall"] = (
            getattr(ck, name), getattr(ck, name.replace("_cuda", "_plain")),
            args, kw)
    return calls


def measure(reps) -> dict:
    """This tree's times: ``{key: {ms, reps, steps, inputs, outputs}}``
    (``inputs`` / ``outputs`` are hashes)."""
    from pivot_tpu_torch.ops import cuda_kernels as ck

    device = torch.device("cuda")
    out = {}
    for key, (fn, plain, args, kw) in shapes(ck, device).items():
        placements, avail = fn(*args, **kw)
        want_p, want_a = plain(*args, **kw)
        if not (torch.equal(placements, want_p) and torch.equal(avail,
                                                                want_a)):
            raise AssertionError(f"{key}: the kernel differs from the "
                                 "plain form")
        n = 5 if args[0].shape[-2] > 10000 else reps
        steps = kw.get("n_bound")
        out[key] = dict(
            ms=abtime.events_ms(lambda: fn(*args, **kw), n), reps=n,
            steps=int(args[2].sum()) if steps is None else int(steps),
            inputs=abtime.digest(*(t for t in (*args, *kw.values())
                             if torch.is_tensor(t))),
            outputs=abtime.digest(placements, avail))
    return out


def main(argv=None) -> None:
    abtime.main(argv, script=__file__, doc=__doc__, measure=measure,
                reps=20)


if __name__ == "__main__":
    main()
