"""The port's ensemble at full width against a fixture ``pivot_tpu`` wrote.

``tests/data/ensemble_r16_seed0.npz`` holds ``pivot_tpu``'s own float32
rollout of the ``ensemble`` subcommand's default configuration (600
hosts, the first trace's first 50 apps, T = 3631 tasks, tick 5 s, 2048
ticks at most, perturb 0.1, fifo, seed 0) at R = 16 replicas, for the
``cost-aware`` and ``first-fit`` arms, made on the CPU with

    JAX_PLATFORMS=cpu python -c "from tests.test_torch_ensemble_fixture \\
        import make_fixture; make_fixture()"

from the repository root.  ``chip_smoke.py`` holds the card's R = 16 run
against it.  Here the port runs on the CPU in float32 at R = 2: the
draws are prefix-stable (threefry counters are flat element indices), so
its rows are the fixture's first two.  Placements, finish times,
makespans, instance-hours and unfinished counts are equal, on the card
too; the egress bill within rtol 1e-5 (XLA's CPU GEMM rounds by tile
position, ``pivot_tpu_torch/parallel/ensemble/bill.py``).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "ensemble_r16_seed0.npz")
ARMS = ("cost-aware", "first-fit")
FIELDS = ("makespan", "egress_cost", "finish_time", "placement",
          "n_unfinished", "instance_hours")
REPLICAS = 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast as eight here and
    does not fight the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(arm, field):
    return f"{arm.replace('-', '_')}__{field}"


def make_fixture(path=FIXTURE):
    """Write the fixture with ``pivot_tpu`` (JAX, float32)."""
    import jax

    from pivot_tpu.experiments import cli as jcli
    from pivot_tpu.parallel.ensemble import rollout

    args = jcli.parse_args(["--job-dir", os.path.join(ROOT, "data", "jobs"),
                            "ensemble", "--replicas", str(REPLICAS)])
    _trace, _sched, workload, topo, avail0, sz = jcli._ensemble_setup(args)
    out = {}
    for arm in ARMS:
        res = rollout(jax.random.PRNGKey(args.seed), avail0, workload, topo,
                      sz, n_replicas=REPLICAS, tick=args.tick,
                      max_ticks=args.max_ticks, perturb=args.perturb,
                      policy=arm, tick_order=args.tick_order)
        for field in FIELDS:
            out[_key(arm, field)] = np.asarray(getattr(res, field))
    np.savez_compressed(path, **out)


def load_fixture(path=FIXTURE):
    """``{arm: {field: array}}`` of the fixture."""
    with np.load(path) as z:
        return {arm: {f: z[_key(arm, f)] for f in FIELDS} for arm in ARMS}


def compare(got: dict, want: dict, rows=None):
    """Hold a result (``{field: array}``) against the fixture's first
    ``rows`` replicas: every field equal but the egress bill (rtol 1e-5).
    Returns the egress bill's largest relative difference."""
    worst = 0.0
    for field in FIELDS:
        w = want[field][:rows]
        g = np.asarray(got[field])
        assert g.shape == w.shape, field
        if field == "egress_cost":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0,
                                       err_msg=field)
            rel = np.abs(g.astype(np.float64) - w) / np.maximum(
                np.abs(w.astype(np.float64)), 1e-30)
            worst = max(worst, float(rel.max(initial=0.0)))
        else:
            np.testing.assert_array_equal(g, w, err_msg=field)
    return worst


def test_fixture_shape():
    fx = load_fixture()
    for arm in ARMS:
        assert fx[arm]["placement"].shape == (REPLICAS, 3631)
        assert fx[arm]["finish_time"].dtype == np.float32
        assert fx[arm]["n_unfinished"].max() == 0
    # The first-fit arm bills egress, so the bar on it bites.
    assert (fx["first-fit"]["egress_cost"] > 0).all()


@pytest.mark.parametrize("arm", ARMS)
def test_port_cpu_matches_fixture_prefix(arm):
    from pivot_tpu_torch.experiments import calibrate as pcal
    from pivot_tpu_torch.experiments import cli as pcli
    from pivot_tpu_torch.parallel.ensemble import prng, rollout
    from pivot_tpu_torch.workload.trace import load_trace_jobs

    args = pcli.parse_args(["--job-dir", os.path.join(ROOT, "data", "jobs"),
                            "ensemble"])
    trace = pcli._list_traces(args.job_dir, 1)[0]
    schedule = load_trace_jobs(trace, args.scale_factor).take(args.num_apps)
    workload, _sl, _arr, topo, avail0, sz = (
        pcal.ensemble_inputs_from_schedule(
            schedule, pcli.build_cluster(pcli._cluster_config(args)),
            dtype=torch.float32, device="cpu"))
    # The vote and fit tests are [G, R·H] here, not small: two threads
    # keep the case inside the tier's per-test budget under load.
    torch.set_num_threads(2)
    res = rollout(prng.PRNGKey(args.seed), avail0, workload, topo, sz,
                  n_replicas=2, tick=args.tick, max_ticks=args.max_ticks,
                  perturb=args.perturb, policy=arm,
                  tick_order=args.tick_order)
    got = {f: getattr(res, f).numpy() for f in FIELDS}
    compare(got, load_fixture()[arm], rows=2)
