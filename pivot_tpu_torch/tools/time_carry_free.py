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
trees and their ratio (this tree over DIR's).  The wrappers' signatures
are the interface, so DIR needs no copy of this file.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

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


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


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
            ms=_events_ms(lambda: fn(*args, **kw), n), reps=n,
            steps=int(args[2].sum()) if steps is None else int(steps),
            inputs=_digest(*(t for t in (*args, *kw.values())
                             if torch.is_tensor(t))),
            outputs=_digest(placements, avail))
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def compare(other, reps) -> dict:
    """Four processes, ``other``, this tree, this tree, ``other``; returns
    ``{key: {base_ms, ms, ratio, runs}}`` with every hash agreeing."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    other = os.path.abspath(other)
    runs = []
    with tempfile.TemporaryDirectory(dir=here) as tmp:
        for i, tree in enumerate((other, here, here, other)):
            path = os.path.join(tmp, f"{i}.json")
            env = dict(os.environ, PYTHONPATH=tree)
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--reps", str(reps), "--json-out", path],
                           cwd=tree, env=env, check=True, timeout=1200)
            with open(path) as f:
                runs.append(json.load(f))
    out = {}
    for key in runs[0]:
        got = [r.get(key) for r in runs]
        if any(g is None for g in got) or len(
                {(g["inputs"], g["outputs"]) for g in got}) != 1:
            raise AssertionError(f"{key}: the two trees' inputs or outputs "
                                 "differ")
        t = [g["ms"] for g in got]
        base, ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        out[key] = dict(base_ms=base, ms=ms, ratio=ms / base, runs=t,
                        steps=got[0]["steps"])
        print(f"{key}: {other} {t[0]!r} / {t[3]!r} ms, this tree {t[1]!r} "
              f"/ {t[2]!r} ms, ratio {ms / base!r} ({got[0]['steps']} "
              "steps)", flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--against", metavar="DIR", default=None,
                    help="another checkout of the repo to time against, "
                         "alternated in four processes")
    ap.add_argument("--json-out", metavar="FILE", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_carry_free needs a CUDA card")
    out = (compare(args.against, args.reps) if args.against
           else measure(args.reps))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f)
    print(card_line())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
