"""The port's ``ensemble`` subcommand vs ``pivot_tpu``'s.

``run_ensemble(args, torch_device="cpu", dtype=...)`` and ``pivot_tpu``'s
``run_ensemble`` on the same arguments (40 hosts, 5 apps, R = 8): the
``rollout.npz`` files are equal array for array and ``summary.json``
equal key for key, except the walls, the device count (the JAX side sees
the test's virtual 8-device mesh) and the egress bill, which is held to
rtol 1e-12 (``tests/test_torch_ensemble.py`` says why).  Float64 runs
set ``pivot_tpu``'s trace bridge to float64 (its CLI has no dtype flag).
Every option the port does not run yet raises ``NotImplementedError``.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pivot_tpu.experiments import calibrate as jcal
from pivot_tpu.experiments import cli as jcli
from pivot_tpu_torch.experiments import cli as pcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EGRESS = ("egress_cost", "egress_mean", "egress_p95")
NOT_COMPARED = ("wall_s", "replica_rollouts_per_sec", "devices")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast as eight here and
    does not fight the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(out, *extra):
    return ["--num-hosts", "40", "--job-dir", os.path.join(ROOT, "data",
                                                           "jobs"),
            "--output-dir", out, "ensemble", "--num-apps", "5",
            "--replicas", "8", "--max-ticks", "512", *extra]


def _files(out):
    (run,) = glob.glob(os.path.join(out, "ensemble", "*"))
    with open(os.path.join(run, "summary.json")) as f:
        summary = json.load(f)
    with np.load(os.path.join(run, "rollout.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return summary, arrays


@pytest.mark.parametrize("dtype,extra", [
    ("float64", ()),
    ("float64", ("--policy", "opportunistic", "--tick-order", "lifo")),
    ("float64", ("--policy", "first-fit", "--perturb", "0.3")),
    ("float64", ("--policy", "best-fit", "--replica-chunk", "3")),
    ("float32", ()),
])
def test_run_ensemble_matches_pivot_tpu(tmp_path, monkeypatch, dtype, extra):
    if dtype == "float64":
        bridge = jcal.ensemble_inputs_from_schedule
        monkeypatch.setattr(
            jcal, "ensemble_inputs_from_schedule",
            lambda s, c, dtype=None: bridge(s, c, dtype=jnp.float64))
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jsum = jcli.run_ensemble(jcli.parse_args(_argv(jdir, *extra)))
    stats = {}
    psum = pcli.run_ensemble(pcli.parse_args(_argv(pdir, *extra)),
                             torch_device="cpu", dtype=dtype, stats=stats)
    assert psum["devices"] == 1
    # One host read per tick, and one before the loop of each chunk.
    chunk = int(extra[extra.index("--replica-chunk") + 1]) \
        if "--replica-chunk" in extra else 0
    calls = -(-8 // chunk) if chunk else 1
    assert stats["ticks"] > 0
    assert stats["host_syncs"] == stats["ticks"] + calls
    (jfile, jarr), (pfile, parr) = _files(jdir), _files(pdir)
    assert pfile == psum and jfile == jsum
    assert set(pfile) == set(jfile)
    for k in jfile:
        if k in NOT_COMPARED:
            continue
        if k in EGRESS:
            assert pfile[k] == pytest.approx(jfile[k], rel=1e-12, abs=0), k
        else:
            assert pfile[k] == jfile[k], k
    assert set(parr) == set(jarr)
    for k in jarr:
        assert parr[k].dtype == jarr[k].dtype, k
        if k in EGRESS:
            np.testing.assert_allclose(parr[k], jarr[k], rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(parr[k], jarr[k], err_msg=k)


@pytest.mark.parametrize("flags", [
    ("--faults", "2"),
    ("--congestion",),
    ("--realtime-score",),
    ("--checkpoint", "ck.npz"),
])
def test_unported_flags_raise(tmp_path, flags):
    args = pcli.parse_args(_argv(str(tmp_path), *flags))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pcli.run_ensemble(args, torch_device="cpu")
    assert not os.path.exists(tmp_path / "ensemble")


def test_run_ensemble_runs_on_the_card_by_default(tmp_path, monkeypatch):
    """No CPU fallback: the default device is ``cuda``, and without a
    card the entry point raises before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = pcli.parse_args(_argv(str(tmp_path)))
    with pytest.raises(RuntimeError, match="cuda"):
        pcli.run_ensemble(args)
    assert not os.path.exists(tmp_path / "ensemble")


def test_parser_defaults_match_pivot_tpu():
    jargs = vars(jcli.parse_args(["ensemble"]))
    pargs = vars(pcli.parse_args(["ensemble"]))
    for k in ("num_apps", "replicas", "policy", "perturb", "tick_order",
              "tick", "max_ticks", "checkpoint", "replica_chunk", "faults",
              "fault_horizon", "fault_mttr", "congestion",
              "realtime_scoring", "n_hosts", "seed"):
        assert pargs[k] == jargs[k], k
