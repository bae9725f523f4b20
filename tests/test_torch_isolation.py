"""The port stands alone: no ``jax`` and nothing of ``pivot_tpu``.

The test process itself has imported ``jax`` (``tests/conftest.py``), so
the run-time check happens in a fresh subprocess: it imports the port,
runs one tiny ``overall`` and one tiny ``ensemble`` on the CPU, and
lists what is in ``sys.modules``.  A static AST scan covers every file
of the package and ``chip_smoke.py``.
"""

import ast
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "pivot_tpu")

PROBE = r"""
import json, sys, tempfile
from pivot_tpu_torch.experiments import calibrate, cli
from pivot_tpu_torch.infra import faults, market
from pivot_tpu_torch.ops import tickloop
from pivot_tpu_torch.sched import sensitivity
with tempfile.TemporaryDirectory() as out:
    args = cli.parse_args(
        ["--device", "cuda", "--no-adaptive", "--num-hosts", "8",
         "--trace-limit", "1", "--output-dir", out, "overall",
         "--num-apps", "3"])
    _, summaries = cli.run_overall(args, torch_device="cpu")
    ens = cli.run_ensemble(cli.parse_args(
        ["--num-hosts", "8", "--output-dir", out, "ensemble",
         "--num-apps", "3", "--replicas", "2", "--max-ticks", "256"]),
        torch_device="cpu")
print(json.dumps({
    "arms": [s["label"] for s in summaries],
    "ensemble_unfinished": ens["unfinished_max"],
    "modules": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "pivot_tpu")),
}))
"""


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_port_runs_without_jax_or_reference_modules():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["arms"] == ["Opportunistic", "VBP", "Cost-Aware"]
    assert report["ensemble_unfinished"] == 0
    assert report["modules"] == []


def _sources():
    pkg = os.path.join(ROOT, "pivot_tpu_torch")
    for dirpath, _dirs, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_file_of_the_port_imports_jax_or_reference():
    offenders = []
    seen = set()
    for path in _sources():
        seen.add(os.path.relpath(path, ROOT))
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, ROOT)}:{node.lineno} "
                          f"{name}" for name in names if _forbidden(name)]
    assert len(seen) > 20
    assert {"pivot_tpu_torch/ops/tickloop.py", "chip_smoke.py",
            "pivot_tpu_torch/infra/market.py",
            "pivot_tpu_torch/sched/sensitivity.py"} <= seen
    assert offenders == []
