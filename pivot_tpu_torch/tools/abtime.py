"""The timing harness the ``time_*`` tools share: CUDA-event times,
output hashes, the card's name and power limit, and the comparison of
two checkouts of the repo in four alternated processes.

A tool supplies ``measure(reps) -> {key: {"ms": ..., [other "*_ms"
fields,] "steps", "inputs", "outputs"}}`` (``inputs`` / ``outputs`` are
:func:`digest` hashes) and hands it to :func:`main`.  Alone, ``main``
prints this tree's times; with ``--against DIR`` it runs the tool's own
file as four processes — DIR, this tree, this tree, DIR — each with its
tree's package first on ``PYTHONPATH`` (so each times its own kernels
and build), requires every hash to agree across the four, and reports
each key's mean of the two trees and their ratio (this tree over
DIR's).  The wrappers' signatures are the interface, so DIR needs no
copy of the tool or of this file: a child imports the harness from the
tool's own directory (see the tools' imports).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile

import torch

#: The root of the tree this file belongs to.
HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def events_ms(fn, reps) -> float:
    """Mean ms of ``fn`` over ``reps`` back-to-back calls between two CUDA
    events, after one warm-up call."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def compare(script, other, reps, fields=("ms",)) -> dict:
    """Four processes of ``script`` (a tool's file): ``other``, this
    tree, this tree, ``other``.  Returns ``{key: row}`` with every hash
    agreeing; for each field ``f`` of ``fields`` (``ms``, ``kernel_ms``,
    ...) with prefix ``p`` (``""``, ``"kernel_"``, ...) the row holds the
    four times ``{p}runs``, ``base_{f}`` (``other``'s mean), ``f`` (this
    tree's) and ``{p}ratio``, and ``steps``."""
    other = os.path.abspath(other)
    runs = []
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        for i, tree in enumerate((other, HERE, HERE, other)):
            path = os.path.join(tmp, f"{i}.json")
            env = dict(os.environ, PYTHONPATH=tree)
            subprocess.run([sys.executable, os.path.abspath(script),
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
        row = dict(steps=got[0]["steps"])
        for name in fields:
            prefix = name[:-2]  # "ms" -> "", "kernel_ms" -> "kernel_"
            t = [g[name] for g in got]
            base, ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            row.update({f"{prefix}runs": t, f"base_{name}": base, name: ms,
                        f"{prefix}ratio": ms / base})
        out[key] = row
        t = row["runs"]
        print(f"{key}: {other} {t[0]!r} / {t[3]!r} ms, this tree {t[1]!r} / "
              f"{t[2]!r} ms, ratio {row['ratio']!r}" + "".join(
                  f"; {name} ratio {row[name[:-2] + 'ratio']!r}"
                  for name in fields[1:])
              + f" ({row['steps']} steps)", flush=True)
    return out


def main(argv, *, script, doc, measure, reps, fields=("ms",),
         alone=None) -> None:
    """The tools' command line: ``[--reps N] [--against DIR] [--json-out
    FILE]``.  ``script`` is the tool's file, ``doc`` its docstring,
    ``reps`` the default repetitions; ``alone`` (optional) returns the
    measurements of this tree that ``--against`` adds beside the
    comparison, for shapes DIR's kernels cannot launch."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=reps)
    ap.add_argument("--against", metavar="DIR", default=None,
                    help="another checkout of the repo to time against, "
                         "alternated in four processes")
    ap.add_argument("--json-out", metavar="FILE", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit(f"{os.path.basename(script)} needs a CUDA card")
    if args.against:
        out = {"against": compare(script, args.against, args.reps, fields),
               **(alone() if alone else {})}
    else:
        out = measure(args.reps)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f)
    print(card_line())
    print(json.dumps(out))
