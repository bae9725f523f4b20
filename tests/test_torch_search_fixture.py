"""The port's search fitness against a fixture ``pivot_tpu`` wrote.

``tests/data/search_seed0.npz`` holds ``pivot_tpu``'s own float32 results
(jax's default config) of ``search/fitness.py``:

  * ``<env>__<variant>__g<gen>__*``: ``_fitness_rows``' per-row egress,
    instance-hours, unfinished count and makespan, and ``evaluate_rows``'
    scores, for the six candidates of ``chip_smoke.SR_VECTORS``
    (``DEFAULT_WEIGHTS``, the two hand-tuned arms, ``BAD_INIT``, (0.5, 2,
    1.5, 5, 1) and (3, 0, 0.25, 50, 1)) in two worlds: ``tiny`` (8 hosts,
    seed 3, 3 apps, horizon 300 s, R = 4) and ``readme`` (the README
    quickstart's: 12 hosts, seed 5, 8 apps, R = 8).  Variants: the shared
    preemption plan at generation keys 0 and 1; at key 0, one plan per
    replica (``redraw_faults``), no hazard trace, and capacity scales with
    admission masks (``chip_smoke.sr_actions``);
  * ``cem__*``: a two-generation CEM on the ``readme`` world anchored at
    the hand-tuned arms (``chip_smoke.SR_CEM``): each generation's
    population and scores, the best and the initial score;

made on the CPU with

    JAX_PLATFORMS=cpu python -c "from tests.test_torch_search_fixture \\
        import make_fixture; make_fixture()"

from the repository root (under a minute; the configuration lives in
``chip_smoke.py``, ``SR_*`` and ``sr_cases``).  ``chip_smoke.py`` phase 8
holds the card to every entry.  Here the port runs on the CPU in float32
on all of them: unfinished counts, makespans and instance-hours are
equal, egress and scores within rtol 1e-5 (XLA's CPU GEMM rounds the
egress bill by tile position), and the CEM's populations and each
generation's argmin are the fixture's.
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
    import jax.numpy as jnp

    from pivot_tpu.experiments.search import HAND_TUNED_ARMS
    from pivot_tpu.parallel.ensemble.state import _resolve_forms
    from pivot_tpu.search import cem
    from pivot_tpu.search import fitness as F

    envs = smoke.sr_envs(F.make_search_env)
    B = len(smoke.SR_VECTORS)
    out = {}
    for name in smoke.sr_cases():
        env, key, cap, act = smoke.sr_case_inputs(jax.random, name, envs)
        rows = F._draw_rows(key, env.workload, env.avail0, env.storage_zones,
                            n_candidates=B, n_replicas=env.n_replicas,
                            perturb=env.perturb)
        got = F._fitness_rows(
            *rows, jnp.asarray(smoke.SR_VECTORS), env.avail0, env.workload,
            env.topo, env.hazard, env.faults,
            None if cap is None else jnp.asarray(cap),
            None if act is None else jnp.asarray(act), tick=env.tick,
            max_ticks=env.max_ticks, forms=_resolve_forms(None),
            tick_order="fifo")
        for field, x in zip(smoke.SR_FIELDS, got):
            out[smoke.sr_key(name, field)] = np.asarray(x)
        scores, _ = F.evaluate_rows(smoke.SR_VECTORS, env, key=key,
                                    cap_rows=cap, active_rows=act)
        out[smoke.sr_key(name, "scores")] = scores
    res, pops, scores = smoke.sr_record_cem(
        cem, envs["readme"], list(HAND_TUNED_ARMS.values()))
    out.update(cem__pops=pops, cem__scores=scores,
               cem__best_score=np.float64(res.best_score),
               cem__init_score=np.float64(res.init_score))
    np.savez_compressed(path or os.path.join(ROOT, smoke.SR_FIXTURE), **out)


@pytest.fixture(scope="module")
def fixture():
    return smoke.sr_load_fixture(os.path.join(ROOT, smoke.SR_FIXTURE))


@pytest.fixture(scope="module")
def envs():
    from pivot_tpu_torch.search.fitness import make_search_env

    return smoke.sr_envs(make_search_env, device="cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fixture_vectors_are_the_named_arms():
    from pivot_tpu_torch.experiments.search import BAD_INIT, HAND_TUNED_ARMS
    from pivot_tpu_torch.search.weights import DEFAULT_WEIGHTS, PolicyWeights

    want = PolicyWeights.stack([DEFAULT_WEIGHTS,
                                *HAND_TUNED_ARMS.values(), BAD_INIT,
                                PolicyWeights(0.5, 2.0, 1.5, 5.0, 1.0),
                                PolicyWeights(3.0, 0.0, 0.25, 50.0, 1.0)])
    np.testing.assert_array_equal(smoke.SR_VECTORS, want)


@pytest.mark.parametrize("name", list(smoke.sr_cases()))
def test_port_cpu_f32_matches_fixture(fixture, envs, name):
    got = smoke.sr_run(name, envs)
    smoke.sr_compare(got, fixture[name], name)


def test_cem_matches_fixture(fixture, envs):
    from pivot_tpu_torch.experiments.search import HAND_TUNED_ARMS
    from pivot_tpu_torch.search import cem

    res, pops, scores = smoke.sr_record_cem(
        cem, envs["readme"], list(HAND_TUNED_ARMS.values()))
    smoke.sr_compare_cem(res, pops, scores, fixture["cem"])


def test_fixture_shapes(fixture):
    B = len(smoke.SR_VECTORS)
    for name, (env, _variant, _gen) in smoke.sr_cases().items():
        R = smoke.SR_ENVS[env]["n_replicas"]
        assert fixture[name]["makespan"].shape == (B * R,)
        assert fixture[name]["scores"].shape == (B,)
    G, P = smoke.SR_CEM["generations"], smoke.SR_CEM["popsize"]
    assert fixture["cem"]["pops"].shape == (G, P, 5)
    assert fixture["cem"]["scores"].shape == (G, P)
    # The capacity / admission case moved the candidates it touched.
    cap = fixture["readme__capact__g0"]["scores"]
    base = fixture["readme__shared__g0"]["scores"]
    assert cap[0] == base[0] and cap[1] != base[1]
