"""The port's fault ensemble and sweeps against a fixture ``pivot_tpu``
wrote.

``tests/data/ensemble_sweeps_seed0.npz`` holds ``pivot_tpu``'s own
float32 results (jax's default config: 32-bit integer draws) on the
CLI's default cluster (600 hosts, seed 0) and the first trace, tick 5 s,
perturb 0.1, fifo:

  * ``fault__<arm>__*``: ``rollout`` at 50 apps (T = 3631), R = 16,
    2048 ticks at most, 4 crashes per replica over the 10240 s horizon,
    Exp(300 s) outages, for ``cost-aware`` and ``first-fit``;
  * ``score__*``: ``score_param_sweep`` at 10 apps, the cube of
    {0.5, 2} plus (1, 1, 1) (9 candidates) × R = 4, 2048 ticks at most;
  * ``capacity__*``: ``capacity_sweep`` at 10 apps, host counts (100,
    300, 600) × R = 4, 4 crashes, Exp(300 s) outages, 2048 ticks at most;
  * ``apps__<arm>__*``: ``workload_sweep`` at app counts (3, 6, 10) ×
    R = 4, 4096 ticks at most, for ``opportunistic``, ``first-fit`` and
    ``cost-aware``;

made on the CPU with

    JAX_PLATFORMS=cpu python -c "from tests.test_torch_sweeps_fixture \\
        import make_fixture; make_fixture()"

from the repository root (the entries' configuration lives in
``chip_smoke.py``, ``SW_*`` and ``sw_cases``).  ``chip_smoke.py`` phase 7
holds the card to every row of it.  Here the port runs on the CPU in
float32 on the rows that take seconds: the sweeps' first replica of
every candidate
(candidates are rows of one batch; a row's results do not depend on the
others) and the fault rollout's first replica.  Placements, finish
times, makespans, instance-hours and unfinished counts are equal; the
egress bill within rtol 1e-5 (XLA's CPU GEMM rounds by tile position).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import chip_smoke as smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_fixture(path=None):
    """Write the fixture with ``pivot_tpu`` (JAX, float32)."""
    import jax

    from pivot_tpu.experiments import cli as jcli
    from pivot_tpu.parallel import ensemble as JE

    def setup(n_apps):
        args = jcli.parse_args(["--job-dir", os.path.join(ROOT, "data",
                                                          "jobs"),
                                "ensemble", "--num-apps", str(n_apps)])
        return args, jcli._ensemble_setup(args)[2:]

    out = {}
    args, (w, topo, a0, sz) = setup(50)
    key = jax.random.PRNGKey(args.seed)
    kw = dict(tick=args.tick, perturb=args.perturb,
              tick_order=args.tick_order)
    _, (w10, topo10, a010, sz10) = setup(smoke.SW_APPS)
    R = smoke.SW_REPLICAS
    for name, (kind, opt) in smoke.sw_cases().items():
        if kind == "fault":
            res = JE.rollout(key, a0, w, topo, sz,
                             n_replicas=smoke.SW_FAULT_REPLICAS,
                             max_ticks=2048, **smoke.SW_FAULTS, **opt, **kw)
        elif kind == "score":
            res = JE.score_param_sweep(key, a010, w10, topo10, sz10,
                                       smoke.sw_score_grid(), n_replicas=R,
                                       max_ticks=2048, **kw)
        elif kind == "capacity":
            res = JE.capacity_sweep(
                key, JE.capacity_grid(a010, smoke.SW_HOST_COUNTS), w10,
                topo10, sz10, n_replicas=R, max_ticks=2048,
                **smoke.SW_FAULTS, **kw)
        else:
            res = JE.workload_sweep(key, a010, w10, topo10, sz10,
                                    list(smoke.SW_APP_COUNTS), n_replicas=R,
                                    max_ticks=4096, **opt, **kw)
        for field in smoke.ENS_FIELDS:
            out[smoke.sw_key(name, field)] = np.asarray(getattr(res, field))
    np.savez_compressed(path or os.path.join(ROOT, smoke.SW_FIXTURE), **out)


@pytest.fixture(scope="module")
def inputs():
    from pivot_tpu_torch.experiments import cli as pcli

    cwd = os.getcwd()
    os.chdir(ROOT)  # the smoke's inputs read data/jobs from the root
    try:
        return {n: smoke.ensemble_inputs(pcli, "cpu", n_apps=n)
                for n in (smoke.SW_APPS, 50)}
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def fixture():
    return smoke.sw_load_fixture(os.path.join(ROOT, smoke.SW_FIXTURE))


@pytest.mark.parametrize("name", [n for n in smoke.sw_cases()
                                  if not n.startswith("fault__")]
                         + ["fault__first-fit"])
def test_port_cpu_f32_matches_fixture(inputs, fixture, name):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = smoke.sw_run(name, inputs, replicas=1)
    finally:
        torch.set_num_threads(n)
    smoke.sw_compare({f: getattr(got, f).numpy() for f in smoke.ENS_FIELDS},
                     fixture[name], name, 1)


def test_fixture_shapes(fixture):
    T = fixture["fault__cost-aware"]["placement"].shape[-1]
    assert T == 3631
    assert fixture["fault__cost-aware"]["placement"].shape == (
        smoke.SW_FAULT_REPLICAS, T)
    assert fixture["score"]["makespan"].shape == (9, smoke.SW_REPLICAS)
    assert fixture["capacity"]["makespan"].shape == (
        len(smoke.SW_HOST_COUNTS), smoke.SW_REPLICAS)
    for arm in smoke.SW_APP_ARMS:
        assert fixture[f"apps__{arm}"]["n_unfinished"].max() == 0
    assert np.isfinite(fixture["fault__first-fit"]["makespan"]).all()
