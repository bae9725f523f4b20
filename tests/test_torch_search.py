"""The port's optimizers and search harness against ``pivot_tpu``'s, on
the CPU in float64 under x64:

  * ``cem_search`` / ``es_search``: ``to_dict()`` (winner, scores,
    every generation's trace) equal to ``pivot_tpu``'s, anchored at the
    hand-tuned arms and from ``BAD_INIT``; seed replay;
  * ``run_search_experiment`` at ``data/search/ci_seed.json``'s config:
    the report equal to ``pivot_tpu``'s (floats within rtol 1e-12, every
    vector, placement and flag exactly), ``pivot_tpu``'s environments
    built in float64 (its ``make_search_env`` takes the dtype; the
    harness does not pass one);
  * ``tests/test_search.py``'s optimizer and harness cases on the port
    (its sharded-backend halves are in ``tests/test_torch_replica_mesh.py``).
"""

from __future__ import annotations

import functools
import json
import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pivot_tpu.search import cem as jcem
from pivot_tpu.search import es as jes
from pivot_tpu.search import fitness as JF
from pivot_tpu_torch.experiments.search import (
    BAD_INIT,
    HAND_TUNED_ARMS,
    load_config,
    run_search_experiment,
)
from pivot_tpu_torch.search import fitness as PF
from pivot_tpu_torch.search.cem import cem_search
from pivot_tpu_torch.search.es import es_search
from pivot_tpu_torch.search.weights import PolicyWeights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CI_SEED = os.path.join(ROOT, "data", "search", "ci_seed.json")
TINY = dict(n_hosts=8, seed=3, n_apps=3, horizon=300.0, n_replicas=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def envs():
    return (JF.make_search_env(dtype=jnp.float64, **TINY),
            PF.make_search_env(dtype=torch.float64, device="cpu", **TINY))


@pytest.fixture(scope="module")
def tiny_env(envs):
    return envs[1]


def assert_close_tree(got, want, path="report"):
    """Equal structure; floats within rtol 1e-12, everything else equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_close_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, float), path
        assert got == want or math.isclose(got, want, rel_tol=1e-12), (
            path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.mark.parametrize("case", ["cem_anchored", "cem_bad_init", "es",
                                  "es_bad_init"])
def test_optimizer_trace_matches(envs, case):
    je, pe = envs
    if case.startswith("cem"):
        kw = dict(generations=2, popsize=4, seed=5)
        if case == "cem_anchored":
            kw["anchors"] = list(HAND_TUNED_ARMS.values())
        want = jcem.cem_search(je, **kw, init=BAD_INIT if "bad" in case
                               else None)
        got = cem_search(pe, **kw, init=BAD_INIT if "bad" in case else None)
    else:
        kw = dict(generations=2, popsize=5, seed=7)
        want = jes.es_search(je, **kw, init=BAD_INIT if "bad" in case
                             else None)
        got = es_search(pe, **kw, init=BAD_INIT if "bad" in case else None)
    assert_close_tree(got.to_dict(), want.to_dict())
    assert got.best == PolicyWeights.from_array(list(want.best))


def test_cem_seed_replay_identical(tiny_env):
    a = cem_search(tiny_env, generations=2, popsize=4, seed=5)
    b = cem_search(tiny_env, generations=2, popsize=4, seed=5)
    assert a.to_dict() == b.to_dict()
    assert a.best == b.best
    assert json.loads(json.dumps(a.to_dict())) == a.to_dict()


def test_cem_beats_bad_init_quick(tiny_env):
    r = cem_search(tiny_env, generations=2, popsize=4, seed=5, init=BAD_INIT)
    assert r.best_score < r.init_score


def test_cem_anchor_warm_start(tiny_env):
    from pivot_tpu_torch.search.loop import generation_key

    arms = list(HAND_TUNED_ARMS.values())
    r = cem_search(tiny_env, generations=1, popsize=4, seed=5, anchors=arms)
    anchor_scores, _ = PF.evaluate_rows(
        PolicyWeights.stack(arms), tiny_env,
        key=generation_key(tiny_env, 0))
    assert r.best_score <= anchor_scores.min() + 1e-15
    with pytest.raises(ValueError, match="anchors do not fit"):
        cem_search(tiny_env, generations=1, popsize=2, seed=5,
                   anchors=arms * 2)


def test_es_improves_or_holds(tiny_env):
    r = es_search(tiny_env, generations=2, popsize=5, seed=7)
    assert r.best_score <= r.init_score
    assert len(r.trace) == 2


def test_optimizer_argument_checks(tiny_env):
    with pytest.raises(ValueError, match="popsize"):
        cem_search(tiny_env, popsize=1)
    with pytest.raises(ValueError, match="generations"):
        es_search(tiny_env, generations=0)
    with pytest.raises(ValueError, match="needs a replica mesh"):
        cem_search(tiny_env, generations=1, popsize=2,
                   backend="sharded_rollout")


def test_search_experiment_report_quick():
    """The harness end to end at smoke scale: learned beats the bad
    init, holdout + oracle sections present, report replays."""
    kw = dict(method="cem", generations=2, popsize=4, seed=5, n_hosts=8,
              n_apps=3, horizon=300.0, n_replicas=4, holdout=1,
              bad_init=True, device="cpu")
    r1 = run_search_experiment(**kw)
    assert r1["beats_bad_init"]
    assert "learned" in r1["holdout"]
    assert set(r1["oracle"]["regret"]) >= {"learned", "hand_tuned_default"}
    assert all(v >= -1e-12 for v in r1["oracle"]["regret"].values())
    r2 = run_search_experiment(**kw)
    assert r1 == r2
    with pytest.raises(ValueError, match="cem\\|es"):
        run_search_experiment(method="sgd", device="cpu")


@pytest.fixture
def jax_search_f64(monkeypatch):
    """``pivot_tpu``'s harness with its environments built in float64
    (the harness imports ``make_search_env`` at call time)."""
    monkeypatch.setattr(JF, "make_search_env", functools.partial(
        JF.make_search_env, dtype=jnp.float64))


def test_run_search_experiment_matches_ci_seed(jax_search_f64):
    from pivot_tpu.experiments.search import (
        run_search_experiment as jrun,
    )

    cfg = load_config(CI_SEED)
    want = jrun(**cfg)
    got = run_search_experiment(**cfg, device="cpu", dtype=torch.float64)
    assert_close_tree(json.loads(json.dumps(got)),
                      json.loads(json.dumps(want)))
    assert got["search"]["best_weights"] == want["search"]["best_weights"]
    assert got["oracle"]["optimum_placement"] == \
        want["oracle"]["optimum_placement"]


def test_run_search_experiment_des_validate_matches(jax_search_f64):
    """The DES validation rides ``experiments/spot.py`` (CPU in both
    packages): a one-generation ES run with it equals ``pivot_tpu``'s."""
    from pivot_tpu.experiments.search import (
        run_search_experiment as jrun,
    )

    kw = dict(method="es", generations=1, popsize=3, seed=4, n_hosts=8,
              n_apps=3, horizon=300.0, n_replicas=2, holdout=1,
              oracle=False, des_validate=True)
    want = jrun(**kw)
    got = run_search_experiment(**kw, device="cpu", dtype=torch.float64)
    assert_close_tree(json.loads(json.dumps(got)),
                      json.loads(json.dumps(want)))
    assert set(got["des_validation"]) == {"hand_tuned_default",
                                          "hand_tuned_risk_aware", "learned"}


def test_load_config_rejects_unknown_keys(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"method": "cem", "mesh": 8}))
    with pytest.raises(ValueError, match="mesh"):
        load_config(str(path))
    assert load_config(CI_SEED)["popsize"] == 4


def test_small_oracle_instance_matches():
    from pivot_tpu.experiments.search import (
        small_oracle_instance as jsmall,
    )
    from pivot_tpu_torch.experiments.search import small_oracle_instance

    for seed in (106, 107):
        want, _ = jsmall(seed)
        got, env = small_oracle_instance(seed, device="cpu")
        assert env.device == torch.device("cpu")
        for f in want._fields:
            a, b = getattr(got, f), getattr(want, f)
            if isinstance(b, float):
                assert a == b, f
            else:
                assert np.asarray(a).dtype == np.asarray(b).dtype, f
                np.testing.assert_array_equal(a, b, f)


def test_search_package_is_import_light_and_lazy():
    """``import pivot_tpu_torch.search`` loads :mod:`weights` only; the
    rest of the surface resolves on first use (PEP 562)."""
    import subprocess
    import sys

    probe = ("import sys, pivot_tpu_torch.search as s; "
             "print(sorted(m for m in sys.modules "
             "if m.startswith('pivot_tpu_torch.search')))")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["['pivot_tpu_torch.search',",
                                   "'pivot_tpu_torch.search.weights']"]
    import pivot_tpu_torch.search as S
    from pivot_tpu_torch.sched import sensitivity

    assert S.cem_search is cem_search and S.es_search is es_search
    assert S.evaluate_candidates is sensitivity.evaluate_candidates
    assert S.make_search_env is PF.make_search_env
    for name in S.__all__:
        assert getattr(S, name) is not None
    with pytest.raises(AttributeError):
        S.sharded_fitness
