"""The port's ``autotune``, ``capacity`` and ``apps`` subcommands vs
``pivot_tpu``'s.

``run_autotune`` / ``run_capacity`` / ``run_apps(args,
torch_device="cpu", dtype="float64")`` and ``pivot_tpu``'s on the argv
of ``tests/test_experiments.py``'s end-to-end cases (plus faults, an
SLO no size meets, a horizon a size cannot finish in, unsorted repeated
app counts and the opportunistic arm): every key of ``summary.json``
equal but ``wall_s``, the egress columns within rtol 1e-12
(``tests/test_torch_ensemble.py`` says why).  ``pivot_tpu``'s trace
bridge is set to float64 (its CLI has no dtype flag) and its figures
are not drawn (the port draws none).  Also: the parsers' defaults
agree, each entry raises without a card before it writes anything,
float64 runs that need the C library's float64 ``log`` / ``pow`` are
refused off the CPU, and each entry turns TF32 matmuls off.
"""

from __future__ import annotations

import glob
import json
import os

import pytest
import torch

import jax.numpy as jnp

from pivot_tpu.experiments import calibrate as jcal
from pivot_tpu.experiments import cli as jcli
from pivot_tpu.experiments import plots as jplots
from pivot_tpu_torch.experiments import cli as pcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOBS = os.path.join(ROOT, "data", "jobs")
EGRESS = ("egress_mean", "busy_cost_mean", "total_cost_mean")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_f64(monkeypatch):
    bridge = jcal.ensemble_inputs_from_schedule
    monkeypatch.setattr(
        jcal, "ensemble_inputs_from_schedule",
        lambda s, c, dtype=None: bridge(s, c, dtype=jnp.float64))
    for name in ("plot_capacity_frontier", "plot_apps_cost"):
        monkeypatch.setattr(jplots, name, lambda out_dir: None)


def _same(p, j, path="summary"):
    """Equal key for key (``wall_s`` aside), the egress-derived columns
    within rtol 1e-12."""
    if isinstance(j, dict):
        assert set(p) == set(j), path
        for k in j:
            if k != "wall_s":
                _same(p[k], j[k], f"{path}.{k}")
    elif isinstance(j, list):
        assert len(p) == len(j), path
        for i, (a, b) in enumerate(zip(p, j)):
            _same(a, b, f"{path}[{i}]")
    elif path.rsplit(".", 1)[-1] in EGRESS and isinstance(j, float):
        assert p == pytest.approx(j, rel=1e-12, abs=0), path
    else:
        assert p == j, path


def _file(out, name):
    (run,) = glob.glob(os.path.join(out, name, "*"))
    with open(os.path.join(run, "summary.json")) as f:
        return json.load(f)


def _both(tmp_path, name, argv):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    run = f"run_{name}"
    jsum = getattr(jcli, run)(jcli.parse_args(
        ["--job-dir", JOBS, "--output-dir", jdir, *argv]))
    stats = {}
    torch.backends.cuda.matmul.allow_tf32 = True
    psum = getattr(pcli, run)(pcli.parse_args(
        ["--job-dir", JOBS, "--output-dir", pdir, *argv]),
        torch_device="cpu", dtype="float64", stats=stats)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert _file(pdir, name) == psum
    assert stats["ticks"] > 0
    _same(psum, jsum)
    return psum, stats


@pytest.mark.parametrize("argv", [
    ["--num-hosts", "8", "--seed", "3", "autotune", "--num-apps", "2",
     "--replicas", "4", "--max-ticks", "256", "--exponents", "0.5", "1.0"],
    ["--num-hosts", "8", "--seed", "3", "autotune", "--num-apps", "3",
     "--replicas", "2", "--max-ticks", "256", "--exponents", "2.0",
     "--objective", "egress", "--tick-order", "lifo"],
])
def test_autotune_matches_pivot_tpu(tmp_path, jax_f64, argv):
    summary, stats = _both(tmp_path, "autotune", argv)
    assert summary["best"] is not None
    assert [1.0, 1.0, 1.0] in [c["exponents"]
                               for c in summary["candidates"]]
    assert stats["host_syncs"] >= stats["ticks"] + 1


@pytest.mark.parametrize("argv", [
    ["--num-hosts", "16", "--seed", "4", "capacity", "--num-apps", "2",
     "--host-counts", "2", "8", "--replicas", "4", "--max-ticks", "256"],
    ["--num-hosts", "16", "--seed", "4", "capacity", "--num-apps", "2",
     "--host-counts", "2", "8", "--replicas", "4", "--max-ticks", "256",
     "--slo-makespan", "1.0"],
    ["--num-hosts", "8", "capacity", "--num-apps", "2", "--host-counts",
     "1", "8", "--replicas", "2", "--max-ticks", "16"],
    ["--num-hosts", "16", "--seed", "2", "capacity", "--num-apps", "3",
     "--host-counts", "4", "16", "--replicas", "3", "--max-ticks", "512",
     "--faults", "4", "--fault-mttr", "60", "--policy", "first-fit"],
])
def test_capacity_matches_pivot_tpu(tmp_path, jax_f64, argv):
    summary, _ = _both(tmp_path, "capacity", argv)
    if "--slo-makespan" in argv:
        assert summary["best"] is None
    if "16" == argv[argv.index("--max-ticks") + 1]:
        assert summary["candidates"][0]["unfinished_max"] > 0
        assert summary["candidates"][0]["makespan_mean"] >= 5.0 * 16


@pytest.mark.parametrize("argv", [
    ["--num-hosts", "8", "--seed", "5", "apps", "--app-counts", "1", "2",
     "--replicas", "2", "--max-ticks", "512", "--policies", "cost-aware",
     "first-fit"],
    ["--num-hosts", "8", "--seed", "5", "apps", "--app-counts", "3", "1",
     "3", "--replicas", "2", "--max-ticks", "512", "--policies",
     "opportunistic", "best-fit"],
])
def test_apps_matches_pivot_tpu(tmp_path, jax_f64, argv):
    summary, _ = _both(tmp_path, "apps", argv)
    assert summary["app_counts"] == sorted(set(summary["app_counts"]))


def test_ensemble_faults_match_pivot_tpu(tmp_path, jax_f64):
    """``ensemble --faults`` through ``run_ensemble``: the schedule is
    drawn as ``pivot_tpu``'s segmented CLI path draws it."""
    argv = ["--num-hosts", "40", "ensemble", "--num-apps", "5",
            "--replicas", "8", "--max-ticks", "512", "--faults", "3",
            "--fault-mttr", "40"]
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jsum = jcli.run_ensemble(jcli.parse_args(
        ["--job-dir", JOBS, "--output-dir", jdir, *argv]))
    psum = pcli.run_ensemble(pcli.parse_args(
        ["--job-dir", JOBS, "--output-dir", pdir, *argv]),
        torch_device="cpu", dtype="float64")
    for k in jsum:
        if k in ("wall_s", "replica_rollouts_per_sec", "devices"):
            continue
        if k.startswith("egress"):
            assert psum[k] == pytest.approx(jsum[k], rel=1e-12, abs=0), k
        else:
            assert psum[k] == jsum[k], k


@pytest.mark.parametrize("name,extra", [
    ("autotune", []), ("capacity", ["--host-counts", "4", "8"]),
    ("apps", ["--app-counts", "1", "2"]),
])
def test_sweeps_run_on_the_card_by_default(tmp_path, monkeypatch, name,
                                           extra):
    """No CPU fallback: without a card each entry raises before it
    writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = pcli.parse_args(["--num-hosts", "8", "--job-dir", JOBS,
                            "--output-dir", str(tmp_path), name, *extra])
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(pcli, f"run_{name}")(args)
    assert not os.path.exists(tmp_path / name)


@pytest.mark.parametrize("name,extra", [
    ("autotune", []),
    ("capacity", ["--host-counts", "4", "8", "--faults", "2",
                  "--fault-mttr", "30"]),
    ("ensemble", ["--faults", "2", "--fault-mttr", "30"]),
])
def test_float64_on_the_card_is_refused(tmp_path, name, extra):
    """Score exponents and Exp(mttr) outages round as the C library's
    float64 ``pow`` / ``log``, which the port calls on the host: float64
    is the CPU parity path, and a float64 run on the card raises before
    it loads or writes anything."""
    args = pcli.parse_args(["--num-hosts", "8", "--job-dir", JOBS,
                            "--output-dir", str(tmp_path), name, *extra])
    with pytest.raises(ValueError, match="CPU parity path"):
        getattr(pcli, f"run_{name}")(args, torch_device="cuda",
                                     dtype="float64")
    assert not os.path.exists(tmp_path / name)


@pytest.mark.parametrize("name,extra", [
    ("ensemble", ["--faults", "2"]), ("capacity", ["--host-counts", "4"]),
    ("apps", ["--app-counts", "1", "2"]),
])
def test_float64_without_host_calls_is_not_refused(tmp_path, monkeypatch,
                                                   name, extra):
    """Crashes that never recover and fault-free sweeps need neither host
    call: float64 on the card gets as far as the card check."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = pcli.parse_args(["--num-hosts", "8", "--job-dir", JOBS,
                            "--output-dir", str(tmp_path), name, *extra])
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(pcli, f"run_{name}")(args, torch_device="cuda",
                                     dtype="float64")


SUB_KEYS = {
    "autotune": ("num_apps", "replicas", "perturb", "tick_order", "tick",
                 "max_ticks", "exponents", "objective", "congestion"),
    "capacity": ("num_apps", "host_counts", "replicas", "perturb",
                 "tick_order", "tick", "max_ticks", "host_hourly_rate",
                 "slo_makespan", "policy", "congestion", "realtime_scoring",
                 "faults", "fault_horizon", "fault_mttr"),
    "apps": ("app_counts", "replicas", "perturb", "tick_order", "tick",
             "max_ticks", "host_hourly_rate", "policies", "congestion"),
}


@pytest.mark.parametrize("name,extra", [
    ("autotune", []), ("capacity", ["--host-counts", "4", "8"]),
    ("apps", ["--app-counts", "1", "2"]),
])
def test_parser_defaults_match_pivot_tpu(name, extra):
    jargs = vars(jcli.parse_args([name, *extra]))
    pargs = vars(pcli.parse_args([name, *extra]))
    for k in SUB_KEYS[name] + ("n_hosts", "seed", "scale_factor"):
        assert pargs[k] == jargs[k], k
    ens = set(vars(jcli.parse_args(["ensemble"])))
    assert set(jargs) - ens <= set(SUB_KEYS[name])


def test_congestion_raises(tmp_path, jax_f64):
    """``--congestion`` runs now (``capacity`` takes ``--realtime-score``
    too) and gives ``pivot_tpu``'s summaries; what raises is
    ``--realtime-score`` off the cost-aware arm, at parse time."""
    _both(tmp_path / "at", "autotune", [
        "--num-hosts", "8", "autotune", "--num-apps", "2", "--replicas",
        "2", "--max-ticks", "256", "--exponents", "1.0", "--congestion"])
    summary, _ = _both(tmp_path / "cap", "capacity", [
        "--num-hosts", "16", "capacity", "--num-apps", "2", "--host-counts",
        "2", "8", "--replicas", "2", "--max-ticks", "256", "--congestion",
        "--realtime-score"])
    assert summary["congestion"] and summary["realtime_scoring"]
    _both(tmp_path / "aps", "apps", [
        "--num-hosts", "8", "apps", "--app-counts", "1", "2", "--replicas",
        "2", "--max-ticks", "256", "--policies", "first-fit",
        "--congestion"])
    with pytest.raises(SystemExit):
        pcli.parse_args(["capacity", "--host-counts", "2",
                         "--realtime-score", "--policy", "first-fit"])
