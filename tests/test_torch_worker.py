"""The port's resident ``worker`` subcommand
(``pivot_tpu_torch/experiments/cli.py::run_worker``), the counterpart of
``tests/test_experiments.py::test_cli_worker_resident``: one process
serves repeated requests; two identical requests write files byte-equal
to a fresh process's one-shot run and to ``pivot_tpu``'s numpy run; a
malformed request and a nested ``worker`` request answer ``ok: false``
without ending the loop; ``quit`` ends it.  The requests run the CPU
policies (``--device numpy``); the card's run of the same protocol is
``chip_smoke.py`` phase 14 (e)."""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARMS = ("Opportunistic", "VBP", "Cost-Aware")
FILES = ("general.json", "transfers.json", "scheduler.json",
         "host_usage.json")


def _argv(out):
    return ["--device", "numpy", "--num-hosts", "8", "--seed", "3",
            "--trace-limit", "1", "--output-dir", str(out), "overall",
            "--num-apps", "3"]


def _files(exp_dir):
    out = {}
    for arm in ARMS:
        for name in FILES:
            with open(os.path.join(exp_dir, "data", "0", arm, name),
                      "rb") as f:
                out[arm, name] = f.read()
    return out


def _env():
    # One hash seed for every process: both packages' transfers files
    # follow Python's string-hash order (the same order in both, so a
    # fixed seed makes the runs comparable across processes).
    return dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
                PYTHONHASHSEED="0")


def _read_until_sentinel(proc, lines):
    while True:
        line = proc.stdout.readline()
        assert line, "the worker ended early"
        lines.append(line.rstrip("\n"))
        if line.startswith('{"served"'):
            return json.loads(line)


def _one_shot(pkg, out):
    return subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.experiments.cli", *_argv(out)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        cwd=ROOT, env=_env())


def _run_files(proc, out):
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-2000:]
    (stamp,) = os.listdir(out / "overall")
    return _files(out / "overall" / stamp)


def test_worker_serves_requests_equal_to_one_shot_and_reference(tmp_path):
    req = json.dumps(_argv(tmp_path / "worker"))
    # A fresh process's one-shot run of the same request, and pivot_tpu's
    # numpy run of the same experiment, beside the worker.
    one = _one_shot("pivot_tpu_torch", tmp_path / "oneshot")
    ref = _one_shot("pivot_tpu", tmp_path / "ref")
    try:
        _serve_and_compare(tmp_path, req, one, ref)
    finally:
        for p in (one, ref):
            if p.poll() is None:
                p.kill()
                p.wait()


def _serve_and_compare(tmp_path, req, one, ref):
    proc = subprocess.Popen(
        [sys.executable, "-m", "pivot_tpu_torch.experiments.cli", "worker"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, cwd=ROOT, env=_env())
    lines, sentinels = [], []
    try:
        for line in (req, req, '{"not": "argv"}', '["worker"]'):
            if sentinels and line == req:
                # The repeat stamps its own experiment directory
                # (<output-dir>/overall/<int(time.time())>).
                time.sleep(1.0 - time.time() % 1.0 + 0.01)
            proc.stdin.write(line + "\n")
            proc.stdin.flush()
            sentinels.append(_read_until_sentinel(proc, lines))
        proc.stdin.write("quit\n")
        proc.stdin.flush()
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert [s["served"] for s in sentinels] == [1, 2, 3, 4]
    assert [s["ok"] for s in sentinels] == [True, True, False, False]
    errors = [json.loads(ln) for ln in lines if ln.startswith('{"error"')]
    assert [e["error"].split(":")[0] for e in errors] == [
        "ValueError", "RuntimeError"]
    dirs = [ln for ln in lines
            if ln.startswith(str(tmp_path / "worker" / "overall"))
            and "/plot/" not in ln]
    assert len(dirs) == 2 and dirs[0] != dirs[1]
    served = [_files(d) for d in dirs]
    assert served[0] == served[1]

    assert _run_files(one, tmp_path / "oneshot") == served[0]
    assert _run_files(ref, tmp_path / "ref") == served[0]
