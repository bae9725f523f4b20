"""Whether a ``device_profile`` trace holds every kernel launch, session
after session in one process: one large session first (``--big``
kernels), then every ``--every`` seconds for ``--seconds`` a session of
``--kernels`` small kernels launched back to back, in turn with no
warm-up (``plain``), with no warm-up but a 0.1 s sleep before the
launches and after their synchronise (``sleep``), with no warm-up but
``--kernels`` extra kernels launched and synchronised first
(``prelude``), and with ``device_profile``'s own warm-up (``warmup``).
Each session's :func:`trace_census` (launches, kernel records, missing
ones and where they stand, the first launch and kernel record from the
window's start, the least launch-to-kernel offset) is printed as one
JSON line beside the seconds since the first session.

    python -m pivot_tpu_torch.tools.trace_window [--seconds 240]

Prints the card's ``nvidia-smi`` name and power limit first.  Needs a
card: without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from pivot_tpu_torch.obs.tracer import device_profile


def _session(root, i, n, variant):
    x = torch.ones(1 << 16, device="cuda")
    torch.cuda.synchronize()
    kw = {} if variant == "warmup" else {"warmup": 0}
    with device_profile(os.path.join(root, str(i)), **kw) as rec:
        if variant == "sleep":
            time.sleep(0.1)
        if variant == "prelude":
            for _ in range(n):
                x.add_(1.0)
            torch.cuda.synchronize()
        for _ in range(n):
            x.add_(1.0)
        if variant == "sleep":
            torch.cuda.synchronize()
            time.sleep(0.1)
    return rec["census"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--every", type=float, default=30.0)
    ap.add_argument("--kernels", type=int, default=200)
    ap.add_argument("--big", type=int, default=20_000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        i = 0
        for n in ([args.big] if args.big else []) + [args.kernels]:
            census = _session(root, i, n, "plain")
            print(json.dumps(dict(session=i, t_s=time.perf_counter() - t0,
                                  kernels_launched=n, **census)),
                  flush=True)
            i += 1
        variants = ("plain", "sleep", "prelude", "warmup")
        while time.perf_counter() - t0 < args.seconds:
            time.sleep(args.every)
            variant = variants[i % len(variants)]
            census = _session(root, i, args.kernels, variant)
            print(json.dumps(dict(session=i, variant=variant,
                                  t_s=time.perf_counter() - t0,
                                  kernels_launched=args.kernels, **census)),
                  flush=True)
            i += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
