"""Model-predictive serving in the port (``pivot_tpu_torch.mpc``) against
``pivot_tpu``'s (``tests/test_mpc.py``), on the CPU in float64.

  * **parity** — the same seeded inputs through both packages: the
    forecaster's ``TierForecast`` and the rendered environment's
    operands bitwise (``pivot_tpu``'s ``make_search_env`` patched to
    float64, as the search tests do), the five-slot menu and its
    channels bitwise, the window key ``prng.fold_in(prng.PRNGKey(s), n)``
    bitwise ``jax.random.fold_in``'s, ``plan`` objectives within rtol
    1e-5 (the egress bill's documented exception, ROADMAP.md Queue 3)
    with the same chosen slot, ``referee_check`` true, and a tuning
    round (CEM + regret gate) with the same winner;
  * **the reference's cases** on the port: forecaster determinism and
    hand cases, render determinism and pinned shapes, the menu, the
    planner's clone parity and tie-break, the staged rollout, the
    driver switch (``mpc=None`` and ``dry_run`` serve the same outcome
    as MPC off), and the soak;
  * **the graph pool** (``parallel/ensemble/tick.py::SNAPSHOT_GRAPHS``):
    with the capture faked on the CPU, windows of new forecasts, menus
    and keys after a warm-up capture nothing and score bitwise as
    without the pool; concurrent users never share a graph;
  * **write-ahead** — an MPC actuation is journaled before its effect;
    the CLI's ``--mpc*`` flags.

The reference's zero-recompile case counts JAX compiles; its port is the
graph-capture count.  Wall-clock soaks hold only properties that do not
depend on timing: planned at least once, never referee-disabled, tier 0
lossless, ``audit()`` clean.  Every thread a test starts ends with it.
"""

from __future__ import annotations

import contextlib
import functools
import io
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pivot_tpu.infra import market as jmarket
from pivot_tpu.mpc import forecast as JFc
from pivot_tpu.mpc import planner as JP
from pivot_tpu.mpc import tuner as JT
from pivot_tpu.search import fitness as JF
from pivot_tpu.search import weights as JW
from pivot_tpu.utils import config as jconfig
from pivot_tpu.utils import reset_ids as j_reset_ids
from pivot_tpu_torch.experiments import cli as pcli
from pivot_tpu_torch.infra.market import MarketSchedule
from pivot_tpu_torch.infra.meter import SloMeter
from pivot_tpu_torch.mpc import MpcConfig
from pivot_tpu_torch.mpc import controller as PC
from pivot_tpu_torch.mpc import tuner as PT
from pivot_tpu_torch.mpc.forecast import (
    TierForecast,
    TierForecaster,
    _apportion_tiers,
    render_env,
)
from pivot_tpu_torch.mpc.planner import (
    PlanResult,
    _action_channels,
    enumerate_actions,
    plan,
    referee_check,
)
from pivot_tpu_torch.mpc.rollout import WeightRollout
from pivot_tpu_torch.obs import NULL_TRACER
from pivot_tpu_torch.parallel.ensemble import bill, libm, prng, tick
from pivot_tpu_torch.recover import Journal, RecoveryConfig, RecoveryPlane
from pivot_tpu_torch.sched.policies import CostAwarePolicy
from pivot_tpu_torch.search import fitness as PF
from pivot_tpu_torch.search.weights import DEFAULT_WEIGHTS, PolicyWeights
from pivot_tpu_torch.serve import (
    ServeDriver,
    ServeSession,
    mixed_tier_arrivals,
    synthetic_app_factory,
)
from pivot_tpu_torch.utils import reset_ids
from pivot_tpu_torch.utils.config import (
    ClusterConfig,
    PolicyConfig,
    build_cluster,
    make_policy,
)

RENDER = dict(horizon=120.0, seed=9, n_replicas=2, n_apps=4)


@pytest.fixture(autouse=True)
def _join_threads():
    """Every thread a test starts (sessions, producer, the MPC's
    controller and tuner) has ended when the test ends."""
    before = set(threading.enumerate())
    yield
    left = [t for t in threading.enumerate() if t not in before]
    for t in left:
        t.join(timeout=30.0)
    assert not [t.name for t in left if t.is_alive()]


@pytest.fixture
def ref_f64(monkeypatch):
    """``pivot_tpu``'s renders in float64 (its harness builds float32
    environments; ``render_env`` imports ``make_search_env`` at call
    time)."""
    monkeypatch.setattr(JF, "make_search_env", functools.partial(
        JF.make_search_env, dtype=jnp.float64))


@pytest.fixture(scope="module")
def world():
    """The port's render template (cluster, market) of
    ``tests/test_mpc.py::world``."""
    reset_ids()
    cluster = build_cluster(ClusterConfig(n_hosts=8, seed=11))
    market = MarketSchedule.generate(cluster.meta, seed=11, horizon=240.0)
    return cluster, market


@pytest.fixture(scope="module")
def ref_world():
    """The same template from ``pivot_tpu``."""
    j_reset_ids()
    cluster = jconfig.build_cluster(jconfig.ClusterConfig(n_hosts=8,
                                                          seed=11))
    market = jmarket.MarketSchedule.generate(cluster.meta, seed=11,
                                             horizon=240.0)
    return cluster, market


def _forecast(rate=0.1, mix=(0.5, 0.25, 0.25), n=12, window=60.0):
    rates = tuple(rate * m for m in mix)
    return TierForecast(rates=rates, mix=tuple(mix), n_observed=n,
                        window=window)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _np_env(env):
    """The render's array operands, host-side, for bit comparisons."""
    out = {
        "avail0": _np(env.avail0),
        "arrival": _np(env.workload.arrival),
        "app_of": _np(env.workload.app_of),
        "runtime": _np(env.workload.runtime),
        "demands": _np(env.workload.demands),
    }
    if env.hazard is not None:
        out["hazard_edges"] = _np(env.hazard[0])
        out["hazard_rates"] = _np(env.hazard[1])
    if env.faults is not None:
        for i, arr in enumerate(env.faults):
            out[f"fault{i}"] = _np(arr)
    return out


def _render(world, fc, **kw):
    cluster, market = world
    return render_env(fc, cluster=cluster, market=market,
                      **dict(RENDER, device="cpu", **kw))


def _ref_render(ref_world, fc, **kw):
    cluster, market = ref_world
    jfc = JFc.TierForecast(*fc)
    return JFc.render_env(jfc, cluster=cluster, market=market,
                          **dict(RENDER, **kw))


def _jw(w: PolicyWeights):
    return JW.PolicyWeights(*w)


def _menus():
    """Menus of both packages, in pairs: every slot kind feasible, the
    pool bounds, and a challenger."""
    ch = (1.3, 0.8, 1.0, 0.0, 1.0)
    for pool, kw in ((2, dict(g_min=1, g_max=3, shed_tier=2,
                              challenger=ch)),
                     (1, dict(g_min=1, g_max=1)),
                     (3, dict(g_min=1, g_max=3, shed_tier=1))):
        c = kw.pop("challenger", None)
        yield pool, (
            enumerate_actions(pool, incumbent=DEFAULT_WEIGHTS,
                              challenger=c and PolicyWeights(*c), **kw),
            JP.enumerate_actions(pool, incumbent=JW.DEFAULT_WEIGHTS,
                                 challenger=c and JW.PolicyWeights(*c),
                                 **kw))


# -- parity with pivot_tpu ------------------------------------------------------


def test_forecast_matches_reference():
    """The same observation stream gives the same ``TierForecast`` bit for
    bit (the fit is the reference's numpy)."""
    rng = np.random.default_rng(5)
    ts = np.cumsum(rng.exponential(2.5, size=200))
    tiers = rng.integers(-1, 4, size=200)
    for bucket, alpha, max_obs in ((15.0, 0.4, 4096), (7.5, 1.0, 64)):
        fc = TierForecaster(n_tiers=3, bucket_s=bucket, alpha=alpha,
                            max_obs=max_obs)
        jfc = JFc.TierForecaster(n_tiers=3, bucket_s=bucket, alpha=alpha,
                                 max_obs=max_obs)
        for t, tier in zip(ts, tiers):
            fc.observe(float(t), int(tier))
            jfc.observe(float(t), int(tier))
        assert tuple(fc.snapshot()) == tuple(jfc.snapshot())


@pytest.mark.parametrize("redraw", [True, False])
def test_render_env_matches_reference(ref_f64, world, ref_world, redraw):
    """The rendered environment's operands, the app tiers and the task
    tiers equal ``pivot_tpu``'s bitwise."""
    fc = _forecast(rate=0.07, mix=(0.4, 0.35, 0.25))
    env, app_t, task_t = _render(world, fc, redraw_faults=redraw)
    jenv, japp_t, jtask_t = _ref_render(ref_world, fc, redraw_faults=redraw)
    np.testing.assert_array_equal(app_t, japp_t)
    np.testing.assert_array_equal(task_t, jtask_t)
    ops, jops = _np_env(env), _np_env(jenv)
    assert set(ops) == set(jops)
    for name, arr in jops.items():
        if arr.dtype.kind == "f":  # index arrays are int64 in the port
            assert ops[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(ops[name], arr, err_msg=name)
    assert env.avail0.dtype == torch.float64
    assert env.price_scale == jenv.price_scale
    assert env.n_preemptions == jenv.n_preemptions


def test_menu_and_channels_match_reference():
    tiers = np.array([0, 0, 1, 2, 2, 1, 0], dtype=np.int32)
    for pool, (menu, jmenu) in _menus():
        assert [(a.kind, a.pool_delta, a.shed_tier, a.feasible,
                 tuple(a.weights)) for a in menu] == \
            [(a.kind, a.pool_delta, a.shed_tier, a.feasible,
              tuple(a.weights)) for a in jmenu]
        for got, want in zip(_action_channels(menu, tiers, pool),
                             JP._action_channels(jmenu, tiers, pool)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 5, 2**33 + 7])
def test_window_key_matches_jax(seed):
    """The controller's window key, ``prng.fold_in(prng.PRNGKey(seed),
    plans)``, equals ``jax.random.fold_in(jax.random.PRNGKey(seed),
    plans)`` bit for bit."""
    for n in (0, 1, 7, 41, 2**31 + 3):
        got = prng.fold_in(prng.PRNGKey(seed), n)
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), n))
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def env_pair(world, ref_world):
    """One rendered window in both packages (float64)."""
    fc = _forecast(rate=0.06, mix=(0.5, 0.25, 0.25))
    env, _, tiers = _render(world, fc)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JF, "make_search_env", functools.partial(
            JF.make_search_env, dtype=jnp.float64))
        jenv, _, jtiers = _ref_render(ref_world, fc)
    np.testing.assert_array_equal(tiers, jtiers)
    return env, jenv, tiers


@pytest.mark.parametrize("menu_case", [0, 1, 2])
def test_plan_matches_reference(env_pair, menu_case):
    """``plan`` objectives within rtol 1e-5 of ``pivot_tpu``'s (the
    egress bill agrees to ulps) and the same chosen slot; the scores of
    the admitted/completed counts bitwise."""
    env, jenv, tiers = env_pair
    pool, (menu, jmenu) = list(_menus())[menu_case]
    for n in (0, 3):
        key = prng.fold_in(prng.PRNGKey(9), n)
        jkey = jax.random.fold_in(jax.random.PRNGKey(9), n)
        got = plan(menu, env, tiers, pool, latency_weight=0.01, key=key)
        want = JP.plan(jmenu, jenv, tiers, pool, latency_weight=0.01,
                       key=jkey)
        np.testing.assert_allclose(got.objectives, want.objectives,
                                   rtol=1e-5, atol=0)
        np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5,
                                   atol=0)
        assert got.index == want.index
        assert got.chosen.kind == want.chosen.kind
        for k in ("admitted", "completed", "unfinished", "makespan"):
            np.testing.assert_array_equal(got.details[k],
                                          np.asarray(want.details[k]), k)
        assert referee_check(menu, env, tiers, pool, latency_weight=0.01,
                             key=key)


def test_tune_once_matches_reference(env_pair):
    """A tuning round — CEM anchored at the incumbent, then the regret
    gate on the oracle — picks the same vector with the same verdict."""
    env, jenv, _ = env_pair
    inc = PolicyWeights(w_cost=1.1)
    got = PT.tune_once(env, incumbent=inc, seed=4, generations=1,
                       popsize=4)
    want = JT.tune_once(jenv, incumbent=_jw(inc), seed=4, generations=1,
                        popsize=4)
    assert tuple(got.weights) == tuple(want.weights)
    np.testing.assert_allclose(got.score, want.score, rtol=1e-5)
    np.testing.assert_allclose(got.init_score, want.init_score, rtol=1e-5)
    assert got.eligible == want.eligible
    if np.isfinite(want.regret):
        np.testing.assert_allclose(got.regret, want.regret, rtol=1e-9,
                                   atol=1e-12)
    else:
        assert not np.isfinite(got.regret)
    for w in (DEFAULT_WEIGHTS, PolicyWeights(w_cost=2.0, risk_weight=0.5)):
        g, j = PT.gate_regret(env, w), JT.gate_regret(jenv, _jw(w))
        assert g == pytest.approx(j, rel=1e-9, abs=1e-12)


# -- forecaster and render (tests/test_mpc.py) -----------------------------------


def test_forecaster_seed_replay_determinism():
    rng = np.random.default_rng(3)
    ts = np.cumsum(rng.exponential(4.0, size=60))
    tiers = rng.integers(0, 3, size=60)
    snaps = []
    for _ in range(2):
        fc = TierForecaster(n_tiers=3, bucket_s=15.0, alpha=0.4)
        for t, tier in zip(ts, tiers):
            fc.observe(float(t), int(tier))
        snaps.append(fc.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[0].n_observed == 60
    assert snaps[0].total_rate > 0
    assert sum(snaps[0].mix) == pytest.approx(1.0)


def test_forecaster_ewma_hand_case():
    fc = TierForecaster(n_tiers=2, bucket_s=10.0, alpha=0.5)
    for t in (0.0, 1.0, 2.0):
        fc.observe(t, 0)
    fc.observe(15.0, 0)
    snap = fc.snapshot()
    assert snap.rates[0] == pytest.approx(0.5 * 0.1 + 0.5 * 0.3)
    assert snap.rates[1] == 0.0
    assert snap.mix == (1.0, 0.0)
    assert snap.window == pytest.approx(15.0)


def test_forecaster_empty_and_tier_clamp():
    fc = TierForecaster(n_tiers=2, bucket_s=10.0)
    snap = fc.snapshot()
    assert snap.n_observed == 0 and snap.total_rate == 0.0
    fc.observe(1.0, 99)
    fc.observe(2.0, -3)
    snap = fc.snapshot()
    assert snap.n_observed == 2
    assert snap.rates[0] > 0 and snap.rates[1] > 0
    with pytest.raises(ValueError):
        TierForecaster(n_tiers=0)
    with pytest.raises(ValueError):
        TierForecaster(alpha=0.0)


def test_tier_apportionment_hand_cases():
    np.testing.assert_array_equal(
        _apportion_tiers((0.5, 0.25, 0.25), 4), [0, 0, 1, 2])
    np.testing.assert_array_equal(
        _apportion_tiers((0.34, 0.33, 0.33), 3), [0, 1, 2])
    np.testing.assert_array_equal(_apportion_tiers((0.0, 0.0), 3), [0, 0, 0])


def test_render_env_replay_determinism(world):
    fc = _forecast(rate=0.08)
    env_a, app_a, task_a = _render(world, fc)
    env_b, app_b, task_b = _render(world, fc)
    np.testing.assert_array_equal(app_a, app_b)
    np.testing.assert_array_equal(task_a, task_b)
    ops_a, ops_b = _np_env(env_a), _np_env(env_b)
    assert set(ops_a) == set(ops_b)
    for name, arr in ops_a.items():
        np.testing.assert_array_equal(arr, ops_b[name], err_msg=name)
    np.testing.assert_array_equal(task_a, app_a[ops_a["app_of"]])


def test_render_env_pins_shapes_rate_is_data(world):
    env_lo, _, tiers_lo = _render(world, _forecast(rate=0.02))
    env_hi, _, tiers_hi = _render(world, _forecast(rate=5.0))
    ops_lo, ops_hi = _np_env(env_lo), _np_env(env_hi)
    for name in ops_lo:
        assert ops_lo[name].shape == ops_hi[name].shape, name
    assert tiers_lo.shape == tiers_hi.shape
    assert not np.array_equal(ops_lo["arrival"], ops_hi["arrival"])


def test_render_env_device_rules(world):
    """The card unless the caller asks for the CPU; float64 is the CPU's
    (score exponents in float64 are host-only)."""
    cluster, market = world
    fc = _forecast()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            render_env(fc, cluster=cluster, market=market, **RENDER)
    with pytest.raises(ValueError):
        render_env(fc, cluster=cluster, market=market, device="meta",
                   dtype=torch.float64, **RENDER)
    env32, _, _ = _render(world, fc, dtype=torch.float32)
    assert env32.avail0.dtype == torch.float32


# -- planner (tests/test_mpc.py) --------------------------------------------------


def test_menu_is_always_five_slots():
    menu = enumerate_actions(2, g_min=1, g_max=3, incumbent=DEFAULT_WEIGHTS,
                             shed_tier=2, challenger=None)
    assert [a.kind for a in menu] == ["hold", "grow", "drain", "shed",
                                      "weights"]
    assert [a.feasible for a in menu] == [True, True, True, True, False]
    assert menu[1].pool_delta == 1 and menu[2].pool_delta == -1
    assert menu[3].shed_tier == 2
    assert menu[4].pool_delta == 0 and menu[4].weights == menu[0].weights
    at_max = enumerate_actions(3, g_min=1, g_max=3, incumbent=DEFAULT_WEIGHTS)
    assert not at_max[1].feasible and at_max[1].kind == "grow"
    at_min = enumerate_actions(1, g_min=1, g_max=3, incumbent=DEFAULT_WEIGHTS)
    assert not at_min[2].feasible and at_min[2].kind == "drain"
    assert len(at_max) == len(at_min) == 5
    with pytest.raises(ValueError):
        enumerate_actions(0, g_min=1, g_max=3, incumbent=DEFAULT_WEIGHTS)
    with pytest.raises(ValueError):
        enumerate_actions(2, g_min=1, g_max=3, incumbent=DEFAULT_WEIGHTS,
                          shed_tier=0)


def test_action_channels_hand_case():
    tiers = np.array([0, 0, 1, 2, 2], dtype=np.int32)
    challenger = PolicyWeights(w_cost=2.0)
    menu = enumerate_actions(2, g_min=1, g_max=4, incumbent=DEFAULT_WEIGHTS,
                             shed_tier=2, challenger=challenger)
    W, cap_rows, active_rows = _action_channels(menu, tiers, pool=2)
    assert W.shape == (5, PolicyWeights.DIM)
    np.testing.assert_array_equal(W[0], DEFAULT_WEIGHTS.to_array())
    np.testing.assert_array_equal(W[4], challenger.to_array())
    np.testing.assert_allclose(cap_rows, [1.0, 1.5, 0.5, 1.0, 1.0])
    np.testing.assert_array_equal(active_rows[3],
                                  [True, True, True, False, False])
    for b in (0, 1, 2, 4):
        assert active_rows[b].all()
    all_low = np.ones(5, dtype=np.int32) * 2
    menu1 = enumerate_actions(2, g_min=1, g_max=4, incumbent=DEFAULT_WEIGHTS,
                              shed_tier=1)
    _, _, rows = _action_channels(menu1, all_low, pool=2)
    assert rows[3].all()


def test_plan_clone_parity_and_hold_tiebreak(env_pair):
    env, _, tiers = env_pair
    menu = enumerate_actions(1, g_min=1, g_max=1, incumbent=DEFAULT_WEIGHTS)
    assert [a.feasible for a in menu] == [True, False, False, False, False]
    res = plan(menu, env, tiers, 1, key=prng.PRNGKey(0))
    for b in range(1, 5):
        assert res.scores[b] == res.scores[0]
    assert res.index == 0 and res.chosen.kind == "hold"
    assert np.isfinite(res.objectives[0])


def test_plan_replay_bitwise_and_referee(env_pair):
    env, _, tiers = env_pair
    menu = enumerate_actions(2, g_min=1, g_max=3, incumbent=DEFAULT_WEIGHTS,
                             shed_tier=2,
                             challenger=PolicyWeights(w_cost=1.3, w_bw=0.8))
    key = prng.PRNGKey(7)
    a = plan(menu, env, tiers, 2, latency_weight=0.01, key=key)
    b = plan(menu, env, tiers, 2, latency_weight=0.01, key=key)
    np.testing.assert_array_equal(a.objectives, b.objectives)
    assert a.index == b.index
    assert referee_check(menu, env, tiers, 2, latency_weight=0.01, key=key)
    feasible = np.asarray([act.feasible for act in menu])
    masked = np.where(feasible, a.objectives, np.inf)
    assert a.index == int(np.argmin(masked))
    admitted = np.asarray(a.details["admitted"], dtype=np.float64)
    assert admitted[3] < admitted[0]


# -- the graph pool: zero captures after warm-up -----------------------------------


def _fake_capture(self, key, avail, w_norm):
    """``_SnapshotGraphs._capture`` without CUDA: the same buffers and
    the same snapshot, called instead of replayed."""
    buf = torch.empty_like(avail)
    w_buf = None if w_norm is None else w_norm.clone()

    def snap():
        live = bill._fma_norms(buf)
        return live if w_buf is None else libm.xla_pow(live, w_buf)

    with self._lock:
        self.captures += 1
    return key, buf, w_buf, snap


@pytest.fixture
def cpu_graphs(monkeypatch):
    """A fresh graph pool that serves CPU tensors with a faked capture."""
    pool = tick._SnapshotGraphs()
    monkeypatch.setattr(tick._SnapshotGraphs, "_capture", _fake_capture)
    monkeypatch.setattr(tick, "SNAPSHOT_GRAPHS", pool)
    monkeypatch.setattr(tick, "_norm_snapshot", pool.take)
    return pool


def test_plan_zero_captures_after_warmup(world, env_pair, cpu_graphs):
    """The pinned-shape contract, measured: after one warm plan and one
    warm tuner population, windows with new forecasts, menus and keys
    capture nothing, and score bitwise as the rollout without the
    pool (the chain reuses the graph's buffers)."""
    env, _, tiers = env_pair
    menu = enumerate_actions(2, g_min=1, g_max=3, incumbent=DEFAULT_WEIGHTS,
                             shed_tier=2,
                             challenger=PolicyWeights(w_cost=1.3, w_bw=0.8))
    plan(menu, env, tiers, 2, key=prng.PRNGKey(0))  # warm: the planner
    PF.evaluate_rows([DEFAULT_WEIGHTS] * 4, env)  # warm: a population
    warm = cpu_graphs.captures
    assert warm == 2
    env2, _, tiers2 = _render(world, _forecast(rate=1.5,
                                               mix=(0.2, 0.3, 0.5)))
    menu2 = enumerate_actions(3, g_min=1, g_max=3,
                              incumbent=PolicyWeights(w_cost=1.1),
                              shed_tier=1)
    key2 = prng.fold_in(prng.PRNGKey(0), 41)
    got = plan(menu2, env2, tiers2, 3, key=key2)
    pop = PF.evaluate_rows([PolicyWeights(w_cost=0.5 + i) for i in range(4)],
                           env2, key=key2)
    assert cpu_graphs.captures == warm
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tick, "_norm_snapshot", _PLAIN_SNAPSHOT)
        want = plan(menu2, env2, tiers2, 3, key=key2)
        want_pop = PF.evaluate_rows(
            [PolicyWeights(w_cost=0.5 + i) for i in range(4)], env2,
            key=key2)
    np.testing.assert_array_equal(got.objectives, want.objectives)
    np.testing.assert_array_equal(pop[0], want_pop[0])


_PLAIN_SNAPSHOT = tick._norm_snapshot


def test_graph_pool_never_shares_a_graph(cpu_graphs):
    """Two concurrent users of one layout (the planner and the tuner at
    equal shapes) take two graphs; handed back, both are reused."""
    a = torch.ones((6, 5, 4), dtype=torch.float64)
    w = torch.full((6, 1), 0.5, dtype=torch.float64)
    buf1, _, g1 = cpu_graphs.take(a, w)
    buf2, _, g2 = cpu_graphs.take(a, w)
    assert buf1.data_ptr() != buf2.data_ptr()
    assert cpu_graphs.captures == 2
    cpu_graphs.give(g1)
    cpu_graphs.give(g2)
    _, _, g3 = cpu_graphs.take(a, w)
    _, _, g4 = cpu_graphs.take(a, w)
    assert {id(g3), id(g4)} == {id(g1), id(g2)}
    assert cpu_graphs.captures == 2
    _, _, g5 = cpu_graphs.take(a[:3], w[:3])  # another layout: a capture
    assert cpu_graphs.captures == 3
    for g in (g3, g4, g5):
        cpu_graphs.give(g)


def test_graph_pool_threads_never_hold_one_graph(cpu_graphs):
    """Eight threads taking and handing back graphs of one layout, under
    a short switch interval: no graph is held by two threads at once,
    and the pool captures at most one graph per concurrent holder."""
    import sys

    a = torch.ones((4, 3, 4), dtype=torch.float64)
    w = torch.full((4, 1), 0.5, dtype=torch.float64)
    held, lock, clashes = set(), threading.Lock(), []

    def worker():
        for _ in range(200):
            _, _, g = cpu_graphs.take(a, w)
            with lock:
                if id(g) in held:
                    clashes.append(id(g))
                held.add(id(g))
            with lock:
                held.discard(id(g))
            cpu_graphs.give(g)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not clashes
    assert 1 <= cpu_graphs.captures <= 8


# -- staged rollout (tests/test_mpc.py) --------------------------------------------


class _FakeDriver:
    def __init__(self, n=2):
        self.slo = SloMeter()
        self.tracer = NULL_TRACER
        self._pool = [(f"s{i}", CostAwarePolicy()) for i in range(n)]

    def policy_pool(self):
        return list(self._pool)


def test_rollout_canary_fleet_adopt():
    drv = _FakeDriver(n=3)
    ro = WeightRollout(drv, canary_checks=2, watch_checks=2)
    w = PolicyWeights(w_cost=1.25, risk_weight=0.2)
    incumbents = [p.weights for _, p in drv.policy_pool()]
    assert ro.propose(w, reference_p99=0.01)
    assert ro.stage == "canary"
    pool = drv.policy_pool()
    assert pool[0][1].weights == w
    assert pool[1][1].weights == incumbents[1]
    assert not ro.propose(PolicyWeights(w_cost=9.0), 0.01)
    assert ro.check(0.001) is None
    assert ro.check(0.001) == "promote"
    assert ro.stage == "fleet"
    assert all(p.weights == w for _, p in drv.policy_pool())
    assert ro.check(0.001) is None
    assert ro.check(0.001) == "adopt"
    assert ro.stage == "idle" and ro.incumbent == w
    assert ro.promotions == 1 and ro.rollbacks == 0
    counters = drv.slo.snapshot()["counters"]
    assert counters["mpc_canaries"] == 1
    assert counters["mpc_fleet_promotions"] == 1


def test_rollout_regression_rolls_back_every_policy():
    drv = _FakeDriver(n=2)
    ro = WeightRollout(drv, canary_checks=1, watch_checks=3,
                       regression_factor=1.5)
    saved = [p.weights for _, p in drv.policy_pool()]
    w = PolicyWeights(w_cost=2.0)
    assert ro.propose(w, reference_p99=0.01)
    assert ro.check(0.001) == "promote"
    assert all(p.weights == w for _, p in drv.policy_pool())
    assert ro.check(1.0) == "rollback"
    assert ro.stage == "idle" and ro.rollbacks == 1
    assert [p.weights for _, p in drv.policy_pool()] == saved
    assert drv.slo.snapshot()["counters"]["mpc_rollbacks"] == 1
    assert ro.propose(PolicyWeights(w_bw=1.4), 0.01)
    assert ro.check(5.0) == "rollback"
    assert [p.weights for _, p in drv.policy_pool()] == saved


def test_rollout_rejects_gated_policy_without_crashing():
    class _Gated(CostAwarePolicy):
        def apply_weights(self, weights):
            raise ValueError("learned exponents are gated here")

    drv = _FakeDriver(n=1)
    drv._pool = [("s0", _Gated())]
    ro = WeightRollout(drv)
    assert not ro.propose(PolicyWeights(w_cost=2.0), 0.01)
    assert ro.stage == "idle"
    assert any("rejected" in e["detail"] for e in ro.events)


def test_apply_weights_swaps_live_policy():
    p = CostAwarePolicy()
    w = PolicyWeights(w_cost=2.0, risk_weight=0.3, rework_cost=1.5)
    p.apply_weights(w)
    assert p.weights == w
    assert p.risk_weight == 0.3 and p.rework_cost == 1.5
    assert p._score_exp == (2.0, 1.0, 1.0)
    p.apply_weights(DEFAULT_WEIGHTS)
    assert p._score_exp is None
    with pytest.raises(ValueError):
        p.apply_weights(np.array([1.0, np.nan, 1.0, 0.0, 1.0]))


# -- the driver switch ------------------------------------------------------------


def _cpu_policy():
    """The Cost-Aware device policy on the CPU in float64: the MPC plans
    on the serving policies' device."""
    return make_policy(PolicyConfig(
        name="cost-aware", device="cuda", bin_pack="first-fit",
        sort_tasks=True, sort_hosts=True, adaptive=False),
        torch_device="cpu", dtype="float64")


def _session(label="s0", n_hosts=6, seed=1, policy=None):
    return ServeSession(
        label, build_cluster(ClusterConfig(n_hosts=n_hosts, seed=seed)),
        policy or _cpu_policy(), seed=seed)


def test_driver_mpc_config_validation():
    reset_ids()
    with pytest.raises(ValueError):
        ServeDriver([_session()], mpc=MpcConfig(g_max=2))
    reset_ids()
    with pytest.raises(ValueError):
        ServeDriver([_session()], mpc=MpcConfig(g_min=2, g_max=2))
    with pytest.raises(ValueError):
        MpcConfig(g_max=0)
    with pytest.raises(ValueError):
        MpcConfig(tier=3, n_tiers=3)
    with pytest.raises(ValueError):
        MpcConfig(regression_factor=1.0)


def _outcome(report):
    c = report["slo"]["counters"]
    return {k: c.get(k, 0) for k in ("arrived", "admitted", "completed",
                                     "shed", "decisions")}


def test_driver_mpc_off_and_dry_run_match():
    def run(mpc):
        reset_ids()
        driver = ServeDriver([_session()], queue_depth=16,
                             backpressure="shed", mpc=mpc)
        stream = mixed_tier_arrivals(0.5, 24, (0.5, 0.3, 0.2), seed=7)
        report = driver.run(stream)
        driver.audit()
        return driver, report

    drv_off, rep_off = run(None)
    assert drv_off._mpc is None and rep_off["mpc"] is None
    cfg = MpcConfig(g_min=1, g_max=1, dry_run=True, tune=False,
                    check_interval_s=0.01, min_observations=10**6)
    drv_dry, rep_dry = run(cfg)
    assert rep_dry["mpc"] is not None
    assert rep_dry["mpc"]["dry_run"] and rep_dry["mpc"]["rounds"] == 0
    assert (rep_dry["mpc"]["forecast"]["n_observed"]
            == rep_dry["slo"]["counters"]["arrived"])
    assert _outcome(rep_off) == _outcome(rep_dry)
    assert drv_dry._mpc.captures_after_warmup() == 0


def test_mpc_actuation_journaled_before_effect(tmp_path):
    """Write-ahead: the plane's ``mpc`` record is appended before the
    actuator moves (the driver's ``grow_pool`` sees it already there)."""
    plane = RecoveryPlane(RecoveryConfig(directory=str(tmp_path)))
    seen = []

    class _Drv(_FakeDriver):
        _recovery = plane
        sessions = []

        def pool_size(self):
            return 1

        def grow_pool(self, reason=""):
            seen.append(plane.journal.appended)
            return True

    drv = _Drv(n=1)
    ctl = PC.MpcController(drv, MpcConfig(g_max=2, tune=False))
    menu = enumerate_actions(1, g_min=1, g_max=2, incumbent=DEFAULT_WEIGHTS)
    res = PlanResult(
        chosen=menu[1], index=1, objectives=np.zeros(5),
        scores=np.zeros(5), details={})
    before = plane.journal.appended
    assert ctl._execute(res, 0.0)
    assert seen == [before + 1]
    assert ctl.events[-1]["action"] == "grow"
    plane.stop()
    records, _ = Journal.read(str(tmp_path / "journal.jsonl"))
    assert [(r["kind"], r.get("action"), r.get("pool"))
            for r in records[1:]] == [("mpc", "grow", 1)]


def _slow_policy(sleep_s):
    import time as _time

    policy = _cpu_policy()
    orig = policy.place

    def slow(ctx):
        _time.sleep(sleep_s)
        return orig(ctx)

    policy.place = slow
    return policy


def test_mpc_soak_plans_and_keeps_tier0_lossless(world):
    """The paced soak of ``tests/test_mpc.py`` with the sessions, the
    planner and the tuner on the CPU in float64 (pool 1→3, tuner on,
    referee every 4th window), held to what does not depend on wall timing: it planned,
    was never referee-disabled, the forecaster saw every arrival, tier 0
    lost nothing, the ledger audits clean, and no graph was captured."""
    cluster, market = world
    cfg = MpcConfig(
        check_interval_s=0.02, horizon=200.0, tick=5.0, n_replicas=2,
        env_apps=4, seed=5, min_observations=3, cooldown_s=0.0,
        latency_weight=0.05, referee_every=4, g_min=1, g_max=3,
        n_tiers=3, bucket_s=10.0, tune=True, tune_interval_s=0.05,
        tune_generations=1, tune_popsize=4, cluster=cluster, market=market,
    )
    reset_ids()
    make_app = synthetic_app_factory(seed=7, runtime=(60.0, 120.0),
                                     n_nodes=(2, 3))

    def make_session(label):
        return _session(label, n_hosts=8, policy=_slow_policy(0.004))

    driver = ServeDriver(
        [make_session("s0")], queue_depth=24, backpressure="shed",
        tier_policies=("spill", "shed", "shed"), preempt=True,
        session_factory=make_session, mpc=cfg)
    stream = mixed_tier_arrivals(0.4, 160, (0.4, 0.3, 0.3), seed=7,
                                 make_app=make_app)
    report = driver.run(stream, pace=120.0)
    driver.audit()
    mpc = report["mpc"]
    assert mpc["rounds"] > 0 and mpc["plans"] > 0
    assert not mpc["disabled"]
    assert mpc["forecast"]["n_observed"] == \
        report["slo"]["counters"]["arrived"]
    assert report["slo"]["tiers"]["0"]["counters"]["shed"] == 0
    assert driver._mpc.captures_after_warmup() == 0
    assert not driver._mpc._thread.is_alive()


# -- the CLI ------------------------------------------------------------------------


SERVE_MPC = ["--device", "cuda", "--num-hosts", "12", "serve", "--sessions",
             "1", "--jobs", "40", "--arrival-rate", "2.5", "--queue-depth",
             "16", "--tier-mix", "0.4,0.3,0.3", "--tier-policies",
             "spill,shed,shed", "--preempt"]


def test_cli_mpc_flag_checks():
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        pcli.parse_args(SERVE_MPC + ["--mpc", "--autoscale", "1:2"])
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        pcli.parse_args(SERVE_MPC + ["--mpc-dry-run"])
    args = pcli.parse_args(SERVE_MPC + ["--mpc", "--mpc-pool", "1:4"])
    assert (args.mpc_horizon, args.mpc_interval_ms, args.mpc_replicas,
            args.mpc_max_regret) == (300.0, 50.0, 4, 1.0)


def test_cli_serve_mpc_dry_run_serves_the_mpc_off_outcome():
    """``serve --mpc --mpc-dry-run`` (and ``--mpc``) report the controller;
    the dry run serves the outcome of the run without it; TF32 is off
    after ``--mpc``."""
    def run(extra):
        with contextlib.redirect_stdout(io.StringIO()):
            return pcli.run_serve_stream(
                pcli.parse_args(SERVE_MPC + extra), torch_device="cpu",
                dtype="float64")

    torch.backends.cuda.matmul.allow_tf32 = True
    off = run([])
    assert torch.backends.cuda.matmul.allow_tf32 is True
    dry = run(["--mpc", "--mpc-pool", "1:4", "--mpc-dry-run"])
    on = run(["--mpc", "--mpc-pool", "1:4"])
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert off["mpc"] is None and off["recovery"] is None
    assert dry["mpc"]["dry_run"] and not on["mpc"]["dry_run"]
    assert _outcome(dry) == _outcome(off)
    for rep in (dry, on):
        assert not rep["mpc"]["disabled"]
        assert rep["mpc"]["forecast"]["n_observed"] == 40
        assert rep["slo"]["tiers"]["0"]["counters"]["shed"] == 0
    assert all(e["action"] == "observe" for e in dry["mpc"]["events"])
