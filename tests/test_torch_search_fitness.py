"""The port's search fitness (``pivot_tpu_torch/search/fitness.py``)
against ``pivot_tpu``'s, on the CPU in float64 under x64:

  * ``chaos_to_faults`` and every operand of ``make_search_env`` (the
    workload, topology, availability, storage zones, hazard trace, shared
    and redrawn fault plans, price scale, preemption count) equal;
  * the sharp edges the evaluator stands on: the generation keys
    (``fold_in(PRNGKey(seed), g)``) and the seed word of a folded key,
    which draws the root anchors, bitwise ``jax.random``'s; the tiled
    draw rows bitwise ``pivot_tpu``'s own jitted ``_draw_rows`` in
    float32 and float64; the float32 ``pow`` twin bitwise XLA:CPU's on
    10**6 pairs from a search environment's tables with exponents
    uniform in [0, 3], 0 and 3 themselves, and bases whose results come
    near the float32 underflow and overflow;
  * ``evaluate_rows``' scores and every ``details`` entry for six
    candidates bitwise (egress within rtol 1e-12: XLA's CPU GEMM rounds
    the bill by tile position) with the shared plan, without the hazard
    trace, with redrawn plans and with capacity scales and admission
    masks;
  * ``tests/test_search.py``'s fitness cases on the port, the sharded
    backend's input checks included (its parity is in
    ``tests/test_torch_replica_mesh.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pivot_tpu.search import fitness as JF
from pivot_tpu_torch.parallel.ensemble import libm, prng
from pivot_tpu_torch.search import fitness as PF
from pivot_tpu_torch.search.weights import DEFAULT_WEIGHTS, PolicyWeights

TINY = dict(n_hosts=8, seed=3, n_apps=3, horizon=300.0, n_replicas=4)
SIX = np.array([
    [1.0, 1.0, 1.0, 0.0, 1.0],
    [1.0, 1.0, 1.0, 1.0, 50.0],
    [0.0, 0.0, 0.0, 0.0, 1.0],
    [0.5, 2.0, 1.5, 5.0, 1.0],
    [3.0, 0.0, 0.25, 50.0, 1.0],
    [1.2, 0.7, 2.6, 0.3, 4.0],
])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(dtype="float64", **kw):
    """The same environment from both packages."""
    kw = dict(TINY, **kw)
    return (JF.make_search_env(dtype=getattr(jnp, dtype), **kw),
            PF.make_search_env(dtype=getattr(torch, dtype), device="cpu",
                               **kw))


@pytest.fixture(scope="module")
def tiny_pair():
    return _pair()


@pytest.fixture(scope="module")
def redraw_pair():
    return _pair(redraw_faults=True)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_env_equal(je, pe):
    for f in ("demands", "runtime", "output_size", "arrival", "pred",
              "group_of", "group_onehot", "pred_group", "out_group",
              "app_of"):
        np.testing.assert_array_equal(_np(getattr(pe.workload, f)),
                                      _np(getattr(je.workload, f)), f)
    for f in ("cost", "bw", "host_zone", "totals"):
        np.testing.assert_array_equal(_np(getattr(pe.topo, f)),
                                      _np(getattr(je.topo, f)), f)
    np.testing.assert_array_equal(_np(pe.avail0), _np(je.avail0))
    assert pe.avail0.dtype == getattr(torch, str(je.avail0.dtype))
    np.testing.assert_array_equal(_np(pe.storage_zones),
                                  _np(je.storage_zones))
    assert (pe.hazard is None) == (je.hazard is None)
    if pe.hazard is not None:
        for a, b in zip(pe.hazard, je.hazard):
            np.testing.assert_array_equal(_np(a), _np(b))
    assert (pe.faults is None) == (je.faults is None)
    if pe.faults is not None:
        for a, b in zip(pe.faults, je.faults):
            np.testing.assert_array_equal(_np(a), _np(b))
    for f in ("tick", "max_ticks", "n_replicas", "perturb", "rate_per_hour",
              "price_scale", "incomplete_penalty", "seed", "n_preemptions"):
        assert getattr(pe, f) == getattr(je, f), f
    assert pe.n_tasks == je.n_tasks
    assert pe.device == torch.device("cpu")


# -- the environment ---------------------------------------------------------


def test_chaos_to_faults_matches():
    from pivot_tpu.infra.faults import ChaosEvent as JEvent
    from pivot_tpu.infra.faults import ChaosSchedule as JSchedule
    from pivot_tpu.utils import reset_ids as jreset
    from pivot_tpu.utils.config import ClusterConfig as JConfig
    from pivot_tpu.utils.config import build_cluster as jbuild
    from pivot_tpu_torch.infra.faults import ChaosEvent, ChaosSchedule
    from pivot_tpu_torch.utils import reset_ids
    from pivot_tpu_torch.utils.config import ClusterConfig, build_cluster

    jreset()
    jc = jbuild(JConfig(n_hosts=8, seed=4))
    reset_ids()
    pc = build_cluster(ClusterConfig(n_hosts=8, seed=4))
    for kw in (dict(n_preemptions=5, preempt_outage=None),
               dict(n_preemptions=4, n_stragglers=2, n_domain_outages=1)):
        js = JSchedule.generate(jc, seed=9, horizon=400.0, **kw)
        ps = ChaosSchedule.generate(pc, seed=9, horizon=400.0, **kw)
        want, got = JF.chaos_to_faults(js, jc), PF.chaos_to_faults(ps, pc)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # Host outages abort at ``at``; a preemption at ``at + lead``.
    hosts = [h.id for h in pc.hosts]
    ev = [("host_outage", 50.0, hosts[3], 20.0, 0.0),
          ("preemption", 10.0, hosts[1], None, 5.0),
          ("straggler", 5.0, hosts[2], 30.0, 0.0)]
    got = PF.chaos_to_faults(ChaosSchedule(
        [ChaosEvent(k, a, t, d, lead) for k, a, t, d, lead in ev]), pc)
    want = JF.chaos_to_faults(JSchedule(
        [JEvent(k, a, t, d, lead) for k, a, t, d, lead in ev]), jc)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], [15.0, 50.0])
    assert PF.chaos_to_faults(ChaosSchedule([]), pc) is None


@pytest.mark.parametrize("case", ["tiny", "redraw", "float32", "readme"])
def test_make_search_env_operands_match(tiny_pair, redraw_pair, case):
    if case == "tiny":
        je, pe = tiny_pair
    elif case == "redraw":
        je, pe = redraw_pair
        assert pe.faults[0].dim() == 2 and pe.n_preemptions > 0
    elif case == "float32":
        je, pe = _pair("float32", fault_seed=11)
    else:
        je, pe = _pair(n_hosts=12, seed=5, n_apps=8, horizon=600.0,
                       n_replicas=8)
    _assert_env_equal(je, pe)


def test_make_search_env_refuses():
    # Every search row rides the pow path: float64 is the CPU parity
    # path (``meta`` stands in for the card).
    with pytest.raises(ValueError, match="CPU parity path"):
        PF.make_search_env(**TINY, dtype=torch.float64, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            PF.make_search_env(**TINY)


# -- the sharp edges ---------------------------------------------------------


def test_generation_keys_and_seed_bits_bitwise():
    from pivot_tpu.parallel.ensemble.draws import _seed_bits as jseed
    from pivot_tpu.search.loop import generation_key as jgen
    from pivot_tpu_torch.parallel.ensemble.draws import _seed_bits
    from pivot_tpu_torch.search.loop import generation_key

    for seed in (0, 3, 5, 2**31 + 7):
        env = PF.SearchEnv(*([None] * 13), seed, 0, "cpu")
        for g in range(6):
            want = np.asarray(jgen(env, g))
            got = generation_key(env, g)
            np.testing.assert_array_equal(got, want, f"seed {seed} gen {g}")
            assert got.dtype == np.uint32
            assert _seed_bits(got) == int(jseed(jnp.asarray(want)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_draw_rows_bitwise(dtype):
    je, pe = _pair(dtype)
    for gen in (0, 1):
        jk = jax.random.fold_in(jax.random.PRNGKey(pe.seed), gen)
        pk = prng.fold_in(prng.PRNGKey(pe.seed), gen)
        want = JF._draw_rows(jk, je.workload, je.avail0, je.storage_zones,
                             n_candidates=3, n_replicas=pe.n_replicas,
                             perturb=pe.perturb)
        got = PF._draw_rows(pk, pe.workload, pe.avail0, pe.storage_zones,
                            n_candidates=3, n_replicas=pe.n_replicas,
                            perturb=pe.perturb)
        for name, a, b in zip(("runtime", "arrival", "anchor"), got, want):
            assert a.shape == (3 * pe.n_replicas, pe.n_tasks)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)


def test_powf_twin_continuous_exponents():
    """10**6 float32 pairs against XLA:CPU's ``x ** w``: bases from a
    600-host search environment's round-trip cost and bandwidth tables
    and norms of partly used hosts, and bases whose results land from
    2**-160 to 2**140 (flushed subnormal results, overflow to inf), a
    subnormal and a zero base; exponents uniform in [0, 3] with 0 and 3
    themselves."""
    from pivot_tpu_torch.parallel.ensemble.bill import _fma_norms

    env = PF.make_search_env(n_hosts=600, seed=5, n_apps=4, n_replicas=1,
                             device="cpu")
    hz = env.topo.host_zone.long()
    cost, bw = env.topo.cost, env.topo.bw
    tables = torch.cat([(cost[:, hz] + cost[hz, :].T).reshape(-1),
                        (bw[:, hz] + bw[hz, :].T).reshape(-1)])
    rng = np.random.default_rng(7)
    n = 10 ** 6
    used = torch.from_numpy(rng.random((n // 1200 + 1, 600, 4))
                            .astype(np.float32))
    norms = _fma_norms(env.avail0[None] * used).reshape(-1)
    w = rng.uniform(0.0, 3.0, n).astype(np.float32)
    w[:2000], w[2000:4000] = 0.0, 3.0
    lg = rng.uniform(-160.0, 140.0, n // 4) / np.maximum(w[-(n // 4):], 1e-3)
    with np.errstate(over="ignore"):
        edge = np.exp2(lg).astype(np.float32)  # inf past float32's range
    bases = np.concatenate([
        norms.numpy()[:n // 2],
        tables.numpy()[rng.integers(0, tables.numel(), n // 4)], edge])
    bases[:64] = 0.0
    bases[64:128] = np.float32(2.0 ** -130)
    want = np.asarray(jax.jit(lambda x, y: x ** y)(jnp.asarray(bases),
                                                   jnp.asarray(w)))
    got = libm.powf(torch.from_numpy(bases), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert np.isinf(want).any() and (want[-(n // 4):] == 0).any()
    assert not np.array_equal(torch.pow(torch.from_numpy(bases),
                                        torch.from_numpy(w)).numpy(), want)


# -- evaluate_rows -------------------------------------------------------------


def _assert_scores_equal(got, want):
    (gs, gd), (ws, wd) = got, want
    np.testing.assert_array_equal(gs, ws)
    assert set(gd) == set(wd)
    for k in wd:
        if k == "egress":
            np.testing.assert_allclose(gd[k], wd[k], rtol=1e-12, atol=0)
        elif k in ("n_rows", "backend"):
            assert gd[k] == wd[k]
        else:
            np.testing.assert_array_equal(gd[k], wd[k], k)


@pytest.mark.parametrize("case", ["shared", "no_hazard", "redraw",
                                  "cap_active"])
def test_evaluate_rows_matches(tiny_pair, redraw_pair, case):
    je, pe = redraw_pair if case == "redraw" else tiny_pair
    if case == "no_hazard":
        je, pe = je._replace(hazard=None), pe._replace(hazard=None)
    kw = {}
    if case == "cap_active":
        act = np.ones((len(SIX), pe.n_tasks), dtype=bool)
        act[1, -1] = False
        act[4, -3:] = False
        kw = dict(cap_rows=[1.0, 0.5, 1.0, 0.75, 1.25, 1.0],
                  active_rows=act)
    for gen in (0, 1):
        jk = jax.random.fold_in(jax.random.PRNGKey(pe.seed), gen)
        pk = prng.fold_in(prng.PRNGKey(pe.seed), gen)
        want = JF.evaluate_rows(SIX, je, key=jk, **kw)
        got = PF.evaluate_rows(SIX, pe, key=pk, **kw)
        _assert_scores_equal(got, want)
    assert np.isfinite(got[0]).all()


# -- tests/test_search.py's fitness cases, on the port --------------------------


@pytest.fixture(scope="module")
def tiny_env(tiny_pair):
    return tiny_pair[1]


def test_fitness_deterministic(tiny_env):
    pop = PolicyWeights.stack([DEFAULT_WEIGHTS,
                               PolicyWeights(risk_weight=5.0)])
    s1, d1 = PF.evaluate_rows(pop, tiny_env)
    s2, d2 = PF.evaluate_rows(pop, tiny_env)
    np.testing.assert_array_equal(s1, s2)
    for k in ("egress", "instance_cost", "unfinished", "completed"):
        np.testing.assert_array_equal(d1[k], d2[k], err_msg=k)
    assert d1["n_rows"] == 2 * tiny_env.n_replicas
    assert d1["backend"] == "rollout"


def test_fitness_risk_dimension_has_signal(tiny_env):
    pop = PolicyWeights.stack([DEFAULT_WEIGHTS,
                               PolicyWeights(risk_weight=5.0)])
    scores, _ = PF.evaluate_rows(pop, tiny_env)
    assert scores[1] < scores[0]


def test_fitness_zero_risk_hazard_parity(tiny_env):
    pop = PolicyWeights.stack([DEFAULT_WEIGHTS])
    with_h, _ = PF.evaluate_rows(pop, tiny_env)
    no_h, _ = PF.evaluate_rows(pop, tiny_env._replace(hazard=None))
    np.testing.assert_array_equal(with_h, no_h)


def test_fitness_input_validation(tiny_env):
    one = PolicyWeights.stack([DEFAULT_WEIGHTS])
    with pytest.raises(ValueError, match="unknown fitness backend"):
        PF.evaluate_rows(one, tiny_env, backend="nope")
    from pivot_tpu_torch.parallel.mesh import replica_mesh

    with pytest.raises(ValueError, match="needs a replica mesh"):
        PF.evaluate_rows(one, tiny_env, backend="sharded_rollout")
    with pytest.raises(ValueError, match="divide"):
        # 3 candidates x 4 replicas = 12 rows over 8 shards.
        PF.evaluate_rows(
            PolicyWeights.stack([DEFAULT_WEIGHTS] * 3), tiny_env,
            backend="sharded_rollout",
            mesh=replica_mesh(devices=[torch.device("cpu")] * 8))
    # A mesh over several distinct devices says where it stands.
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP\.md Queue 1, several cards"):
        PF.evaluate_rows(one, tiny_env, backend="sharded_rollout",
                         mesh=replica_mesh(devices=[torch.device("cpu"),
                                                    torch.device("meta")]))
    with pytest.raises(ValueError, match="finite"):
        PF.evaluate_rows(np.full((2, 5), np.nan), tiny_env)
    with pytest.raises(ValueError, match=r"\[B, 5\]"):
        PF.evaluate_rows(np.ones((2, 4)), tiny_env)


def test_sensitivity_evaluate_candidates_is_the_library_surface(tiny_env):
    from pivot_tpu_torch.sched.sensitivity import evaluate_candidates

    pop = [DEFAULT_WEIGHTS, PolicyWeights(risk_weight=2.0)]
    via_lib = evaluate_candidates(pop, tiny_env)
    direct, _ = PF.evaluate_rows(PolicyWeights.stack(pop), tiny_env)
    np.testing.assert_array_equal(via_lib, direct)


def test_redraw_faults_deterministic_per_replica_plans(redraw_pair):
    a = redraw_pair[1]
    b = PF.make_search_env(**TINY, redraw_faults=True,
                           dtype=torch.float64, device="cpu")
    for x, y in zip(a.faults, b.faults):
        assert torch.equal(x, y)
    host, fail, rec = (x.numpy() for x in a.faults)
    assert host.shape[0] == 4 and host.shape == fail.shape == rec.shape
    assert int(np.isfinite(fail).sum()) == a.n_preemptions > 0
    assert any(not np.array_equal(fail[0], fail[r]) for r in range(1, 4))


def test_redraw_faults_scores_replayable_and_diverge(tiny_env, redraw_pair):
    env = redraw_pair[1]
    pop = PolicyWeights.stack([DEFAULT_WEIGHTS,
                               PolicyWeights(risk_weight=5.0)])
    s1, _ = PF.evaluate_rows(pop, env)
    s2, _ = PF.evaluate_rows(pop, env)
    np.testing.assert_array_equal(s1, s2)
    shared, _ = PF.evaluate_rows(pop, tiny_env)
    assert not np.array_equal(s1, shared)


def test_planner_action_channels(tiny_env):
    pop = PolicyWeights.stack([DEFAULT_WEIGHTS, DEFAULT_WEIGHTS])
    T = tiny_env.n_tasks
    base, _ = PF.evaluate_rows(pop, tiny_env)
    inert, _ = PF.evaluate_rows(pop, tiny_env, cap_rows=np.ones(2),
                                active_rows=np.ones((2, T), dtype=bool))
    np.testing.assert_array_equal(base, inert)
    capped, _ = PF.evaluate_rows(pop, tiny_env,
                                 cap_rows=np.array([1.0, 0.5]))
    assert capped[0] == base[0]
    assert capped[1] != base[1]
    act = np.ones((2, T), dtype=bool)
    act[1, -1] = False
    shed, ds = PF.evaluate_rows(pop, tiny_env, active_rows=act)
    assert ds["admitted"][0] == T and ds["admitted"][1] == T - 1
    assert shed[0] == base[0]
    assert shed[1] != base[1]
    with pytest.raises(ValueError, match="cap_rows"):
        PF.evaluate_rows(pop, tiny_env, cap_rows=np.ones(3))
    with pytest.raises(ValueError, match="cap_rows"):
        PF.evaluate_rows(pop, tiny_env, cap_rows=np.array([1.0, -1.0]))
    with pytest.raises(ValueError, match="active_rows"):
        PF.evaluate_rows(pop, tiny_env,
                         active_rows=np.ones((2, T + 1), dtype=bool))


def test_fitness_rows_counts_the_row_loop(tiny_env):
    """``_fitness_rows`` hands ``stats`` to the row loop, which counts its
    ticks, placement steps and host reads; the rows it returns are the
    ones ``evaluate_rows`` reduces."""
    from pivot_tpu_torch.parallel.ensemble.state import _resolve_forms

    pop = PolicyWeights.stack([DEFAULT_WEIGHTS])
    env = tiny_env
    key = prng.PRNGKey(env.seed)
    rows = PF._draw_rows(key, env.workload, env.avail0, env.storage_zones,
                         n_candidates=1, n_replicas=env.n_replicas,
                         perturb=env.perturb)
    st = {}
    egress, ihours, unfin, makespan = PF._fitness_rows(
        *rows, pop, env.avail0, env.workload, env.topo, env.hazard,
        env.faults, None, None, tick=env.tick, max_ticks=env.max_ticks,
        forms=_resolve_forms(None), tick_order="fifo", stats=st)
    assert st["host_syncs"] == st["ticks"] + 1 and st["place_steps"] > 0
    assert st["wall_s"] > 0
    assert egress.shape == (env.n_replicas,)
    _, d = PF.evaluate_rows(pop, env, key=key)
    assert d["unfinished"][0] == unfin.numpy().astype(np.float64).mean()
    assert d["makespan"][0] == makespan.numpy().astype(np.float64).mean()
