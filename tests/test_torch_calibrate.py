"""The port's calibration harness vs ``pivot_tpu``'s.

``pivot_tpu``'s ``calibrate()`` imports ``jax.experimental.enable_x64``
(``pivot_tpu/experiments/calibrate.py:390``), which jax 0.9 does not
have, so it cannot run here as it is.  The reference side is therefore
composed from its own pieces: :func:`ref_calibrate_one` is its
``_calibrate_one`` with ``jax.enable_x64`` as the x64 scope
(``_des_ground_truth`` + ``ensemble_inputs_from_schedule`` +
``_calibrate_modes``), patched into its module so that its
``calibrate()`` (validation, the cluster-seed summary, the mode
recommendation) runs for real around it.  ``pivot_tpu/`` is not edited.

  * reports at 8 hosts × 2 apps: static / congested, realtime, pairs,
    ``des_seeds=2``, ``cluster_seeds=2`` (its ``cluster_summary`` and
    ``recommended_mode``), float32 and float64 (``x64``).  Everything is
    equal but the estimates' egress and its relative error (rtol 1e-5
    in float32, 1e-12 in float64);
  * ``test_calibrate_mode_combination_validation``'s errors;
  * the CLI's ``report.json`` (first stdout line, the file);
  * ``tests/data/calibrate_seed0.json``: ``pivot_tpu``'s reports of
    ``calibrate --num-apps 50`` and ``... --realtime`` at the CLI's
    defaults (600 hosts, cost-aware, R = 1, perturb 0, lifo, float32),
    made on the CPU with

        JAX_PLATFORMS=cpu python -c "from tests.test_torch_calibrate \\
            import make_fixture; make_fixture()"

    from the repository root (a few minutes); ``chip_smoke.py`` phase 9
    holds the card's CLI runs against it, and here the port's CLI on the
    CPU.
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pivot_tpu.experiments import calibrate as jcal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "calibrate_seed0.json")
# Relative to the repository root, where the tests run: the reports
# carry the trace's path.
JOBS = os.path.join("data", "jobs")
TRACE = os.path.join(JOBS, "jobs-5000-200-172800-259200.npz")
EGRESS_RTOL = {False: 1e-5, True: 1e-12}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_calibrate_one(trace_file, cluster, n_apps, policy, scale_factor,
                      seed, tick, max_ticks, replicas, perturb, modes,
                      realtime, x64, des_seeds, tick_order="fifo"):
    """``pivot_tpu``'s ``_calibrate_one``, its x64 scope
    ``jax.enable_x64(x64)``."""
    per_seed = []
    schedule = None
    for i in range(max(des_seeds, 1)):
        d, s = jcal._des_ground_truth(
            cluster, policy, trace_file, n_apps, scale_factor, seed + i,
            tick, realtime=realtime)
        per_seed.append(d)
        if schedule is None:
            schedule = s
    des = {k: float(np.mean([d[k] for d in per_seed])) for k in jcal._METRICS}
    with jax.enable_x64(x64):
        inputs = jcal.ensemble_inputs_from_schedule(
            schedule, cluster, dtype=jnp.float64 if x64 else None)
        report = jcal._calibrate_modes(
            inputs, des, schedule, trace_file, cluster, policy, replicas,
            perturb, realtime, x64, modes, seed, tick, max_ticks,
            tick_order=tick_order)
    if des_seeds > 1:
        report["des_seeds"] = des_seeds
        report["des_per_seed"] = per_seed
        report["des_spread"] = {
            k: {"std": float(np.std([d[k] for d in per_seed])),
                "min": float(min(d[k] for d in per_seed)),
                "max": float(max(d[k] for d in per_seed))}
            for k in jcal._METRICS}
    return report


@contextlib.contextmanager
def _reference():
    orig = jcal._calibrate_one
    jcal._calibrate_one = ref_calibrate_one
    try:
        yield jcal.calibrate
    finally:
        jcal._calibrate_one = orig


def assert_reports_equal(got, want, x64=False, path="report"):
    """Equal key for key; an estimate's egress (and the relative errors
    and summaries derived from it) within the egress rtol."""
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_reports_equal(got[k], want[k], x64, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_reports_equal(g, w, x64, f"{path}[{i}]")
    elif "egress_cost" in path and ".des" not in path \
            and not path.endswith(".n") and isinstance(want, float):
        assert got == pytest.approx(want, rel=EGRESS_RTOL[x64], abs=0), path
    else:
        assert got == want, path


def _small(**kw):
    from pivot_tpu.utils.config import ClusterConfig
    from pivot_tpu_torch.utils.config import ClusterConfig as PConfig
    from pivot_tpu_torch.utils.config import build_cluster as pbuild

    base = dict(n_apps=2, max_ticks=256)
    base.update(kw)
    if base.pop("prebuilt", True) and base.get("cluster_seeds", 1) == 1:
        from pivot_tpu.utils.config import build_cluster as jbuild

        jkw = dict(base, cluster=jbuild(ClusterConfig(n_hosts=8, seed=0)))
        pkw = dict(base, cluster=pbuild(PConfig(n_hosts=8, seed=0)))
    else:
        jkw = dict(base, n_hosts=8)
        pkw = dict(base, n_hosts=8)
    return jkw, pkw


CASES = {
    "modes": dict(),
    "realtime": dict(realtime=True),
    "pairs": dict(policy="first-fit", modes=("static", "congested",
                                             "pairs")),
    "des_seeds": dict(policy="first-fit", modes=("static",), replicas=4,
                      perturb=0.1, des_seeds=2),
    "cluster_seeds": dict(policy="first-fit",
                          modes=("static", "congested", "pairs"),
                          cluster_seeds=2),
    "best_fit_fifo": dict(policy="best-fit", modes=("static", "congested"),
                          tick_order="fifo"),
}


@pytest.mark.parametrize("x64", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_calibrate_matches_pivot_tpu(case, x64):
    from pivot_tpu_torch.experiments.calibrate import calibrate

    jkw, pkw = _small(x64=x64, **CASES[case])
    with _reference() as jcalibrate:
        want = jcalibrate(TRACE, **jkw)
    stats = {}
    got = calibrate(TRACE, device="cpu", stats=stats, **pkw)
    assert_reports_equal(got, want, x64)
    modes = CASES[case].get("modes") or (
        ("realtime",) if CASES[case].get("realtime") else
        ("static", "congested"))
    assert set(stats) == set(modes)
    assert all(s["ticks"] > 0 and s["place_steps"] > 0
               for s in stats.values())
    if case == "cluster_seeds":
        assert got["recommended_mode"] == want["recommended_mode"]
        assert got["cluster_summary"].keys() == want["cluster_summary"].keys()


def test_calibrate_mode_combination_validation():
    from pivot_tpu_torch.experiments.calibrate import calibrate

    for kw in (dict(realtime=True, modes=("static",)),
               dict(modes=("realtime",)),
               dict(modes=("static", "stattic")),
               dict(realtime=True, policy="first-fit")):
        with pytest.raises(ValueError):
            calibrate(TRACE, device="cpu", **kw)
    from pivot_tpu_torch.utils.config import ClusterConfig, build_cluster

    with pytest.raises(ValueError, match="cluster_seeds"):
        calibrate(TRACE, cluster=build_cluster(ClusterConfig(n_hosts=8)),
                  n_apps=2, cluster_seeds=2, device="cpu")


def test_calibrate_runs_on_the_card_by_default(monkeypatch):
    """No CPU fallback: without a card the default device raises before
    the DES runs."""
    from pivot_tpu_torch.experiments import calibrate as pcal

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pcal, "_des_ground_truth", None)
    with pytest.raises(RuntimeError, match="cuda"):
        pcal.calibrate(TRACE, n_hosts=8, n_apps=2)


def _cli_argv(out, *extra, n_hosts=8):
    return ["--num-hosts", str(n_hosts), "--job-dir", JOBS, "--output-dir",
            out,
            "calibrate", *extra]


def test_cli_report_json(tmp_path, capsys):
    from pivot_tpu.experiments import cli as jcli
    from pivot_tpu_torch.experiments import cli as pcli

    extra = ("--num-apps", "2", "--max-ticks", "256", "--policy",
             "first-fit", "--cluster-seeds", "2")
    jargs = jcli.parse_args(_cli_argv("unused", *extra))
    pargs = pcli.parse_args(_cli_argv(str(tmp_path), *extra))
    for k in ("num_apps", "max_ticks", "policy", "cluster_seeds",
              "n_hosts", "job_dir", "tick_order"):
        assert getattr(pargs, k) == getattr(jargs, k), k
    stats = {}
    report = pcli.run_calibrate(pargs, torch_device="cpu", stats=stats)
    first = capsys.readouterr().out.splitlines()[0]
    assert json.loads(first) == report
    with open(os.path.join(stats["out_dir"], "report.json")) as f:
        assert json.load(f) == report
    assert os.path.dirname(stats["out_dir"]) == str(tmp_path / "calibrate")
    with _reference() as jcalibrate:
        want = jcalibrate(
            jcli._list_traces(jargs.job_dir, 1)[0], n_apps=2,
            policy="first-fit", max_ticks=256, cluster_seeds=2,
            cluster_config=jcli._cluster_config(jargs), tick_order="lifo")
    assert_reports_equal(report, json.loads(json.dumps(want)))


def test_cli_parser_matches_pivot_tpu():
    from pivot_tpu.experiments import cli as jcli
    from pivot_tpu_torch.experiments import cli as pcli

    jargs = vars(jcli.parse_args(["calibrate"]))
    pargs = vars(pcli.parse_args(["calibrate"]))
    for k in ("num_apps", "policy", "replicas", "perturb", "tick",
              "max_ticks", "des_seeds", "cluster_seeds", "x64",
              "tick_order", "realtime", "n_hosts", "seed"):
        assert pargs[k] == jargs[k], k
    with pytest.raises(SystemExit):
        pcli.parse_args(["calibrate", "--realtime", "--policy", "best-fit"])


# -- the fixture at the CLI's defaults ------------------------------------

FIXTURE_RUNS = {"modes": (), "realtime": ("--realtime",)}


def make_fixture(path=FIXTURE):
    """Write ``pivot_tpu``'s reports at the CLI defaults (float32)."""
    from pivot_tpu.experiments import cli as jcli

    out = {}
    for name, extra in FIXTURE_RUNS.items():
        args = jcli.parse_args(_cli_argv("unused", *extra, n_hosts=600))
        with _reference() as jcalibrate:
            out[name] = jcalibrate(
                jcli._list_traces(args.job_dir, 1)[0],
                cluster=jcli.build_cluster(jcli._cluster_config(args)),
                n_apps=args.num_apps, policy=args.policy,
                scale_factor=args.scale_factor, seed=args.seed,
                tick=args.tick, max_ticks=args.max_ticks,
                replicas=args.replicas, perturb=args.perturb,
                realtime=args.realtime, x64=args.x64,
                tick_order=args.tick_order)
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")


def load_fixture(path=FIXTURE) -> dict:
    with open(path) as f:
        return json.load(f)


def test_fixture_shape():
    fx = load_fixture()
    assert set(fx) == set(FIXTURE_RUNS)
    assert {"static", "congested"} <= set(fx["modes"])
    assert "realtime" in fx["realtime"] and "static" not in fx["realtime"]
    for rep in fx.values():
        assert rep["n_hosts"] == 600 and rep["n_apps"] == 50
        assert rep["x64"] is False and rep["tick_order"] == "lifo"


@pytest.mark.parametrize("name", sorted(FIXTURE_RUNS))
def test_port_cli_matches_fixture(tmp_path, name):
    from pivot_tpu_torch.experiments import cli as pcli

    torch.set_num_threads(2)
    args = pcli.parse_args(_cli_argv(str(tmp_path), *FIXTURE_RUNS[name],
                                     n_hosts=600))
    report = pcli.run_calibrate(args, torch_device="cpu")
    assert_reports_equal(json.loads(json.dumps(report)),
                         load_fixture()[name])
