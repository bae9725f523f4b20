"""The port's congestion model at full width against a fixture
``pivot_tpu`` wrote.

``tests/data/ensemble_congestion_seed0.npz`` holds ``pivot_tpu``'s own
float32 run of the README's command ``ensemble --policy opportunistic
--congestion`` at its defaults otherwise (600 hosts, the first trace's
first 50 apps, T = 3631 tasks, tick 5 s, 2048 ticks at most, perturb
0.1, fifo, seed 0), through the path ``--checkpoint`` takes
(``rollout_checkpointed``), at R = 16 replicas, made on the CPU with

    JAX_PLATFORMS=cpu python -c "from tests.test_torch_congestion_fixture \\
        import make_fixture; make_fixture()"

from the repository root (a few minutes).  ``chip_smoke.py`` phase 9
holds the card's R = 1024 CLI run's first 16 rows against it (the draws
are prefix-stable).  Here the port runs on the CPU in float32 at R = 2.
Placements, finish times, makespans, instance-hours and unfinished
counts are equal; the egress bill within rtol 1e-5
(``tests/test_torch_ensemble_fixture.py`` says why).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tests.test_torch_ensemble_fixture import FIELDS, compare

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data",
                       "ensemble_congestion_seed0.npz")
ARGV = ("--policy", "opportunistic", "--congestion")
REPLICAS = 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_fixture(path=FIXTURE):
    """Write the fixture with ``pivot_tpu`` (JAX, float32)."""
    import jax

    from pivot_tpu.experiments import cli as jcli
    from pivot_tpu.parallel.ensemble import rollout_checkpointed

    args = jcli.parse_args(["--job-dir", os.path.join(ROOT, "data", "jobs"),
                            "ensemble", "--replicas", str(REPLICAS), *ARGV])
    _trace, _sched, workload, topo, avail0, sz = jcli._ensemble_setup(args)
    res = rollout_checkpointed(
        jax.random.PRNGKey(args.seed), avail0, workload, topo, sz, None,
        n_replicas=REPLICAS, tick=args.tick, max_ticks=args.max_ticks,
        perturb=args.perturb, policy=args.policy, congestion=True,
        tick_order=args.tick_order)
    np.savez_compressed(path, **{f: np.asarray(getattr(res, f))
                                 for f in FIELDS})


def load_fixture(path=FIXTURE) -> dict:
    with np.load(path) as z:
        return {f: z[f] for f in FIELDS}


def test_fixture_shape():
    fx = load_fixture()
    assert fx["placement"].shape == (REPLICAS, 3631)
    assert fx["finish_time"].dtype == np.float32
    assert fx["n_unfinished"].max() == 0
    assert (fx["egress_cost"] > 0).all()


def test_port_cpu_matches_fixture_prefix():
    from pivot_tpu_torch.experiments import calibrate as pcal
    from pivot_tpu_torch.experiments import cli as pcli
    from pivot_tpu_torch.parallel.ensemble import prng, rollout_checkpointed
    from pivot_tpu_torch.workload.trace import load_trace_jobs

    args = pcli.parse_args(["--job-dir", os.path.join(ROOT, "data", "jobs"),
                            "ensemble", *ARGV])
    trace = pcli._list_traces(args.job_dir, 1)[0]
    schedule = load_trace_jobs(trace, args.scale_factor).take(args.num_apps)
    workload, _sl, _arr, topo, avail0, sz = (
        pcal.ensemble_inputs_from_schedule(
            schedule, pcli.build_cluster(pcli._cluster_config(args)),
            dtype=torch.float32, device="cpu"))
    torch.set_num_threads(2)
    res = rollout_checkpointed(
        prng.PRNGKey(args.seed), avail0, workload, topo, sz, None,
        n_replicas=2, tick=args.tick, max_ticks=args.max_ticks,
        perturb=args.perturb, policy=args.policy, congestion=True,
        tick_order=args.tick_order)
    compare({f: getattr(res, f).numpy() for f in FIELDS}, load_fixture(),
            rows=2)
