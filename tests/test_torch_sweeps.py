"""The port's row runner and what-if sweeps vs ``pivot_tpu``'s.

  * parity on the CPU in float64 (``pivot_tpu`` under x64, its
    ``indexed`` tick-body form, and ``vector`` too for the score sweep
    and the opportunistic workload sweep): the port's
    ``score_param_sweep``, ``capacity_grid``, ``capacity_sweep`` (with and
    without faults, and on a grid whose live hosts are not a prefix),
    ``workload_sweep`` and ``_run_rows`` with the eviction-risk term
    (``risk_coeff`` with a ``MarketSchedule.generate`` hazard trace) and
    with an ``active`` mask, against the same calls of ``pivot_tpu``:
    placements, finish times, makespans, instance-hours and unfinished
    counts bit for bit, egress within rtol 1e-12
    (``tests/test_torch_ensemble.py`` says why);
  * ``segment_ticks`` (loops of that many ticks with a host read between
    them) equals one loop bit for bit, as ``pivot_tpu``'s
    ``test_segmented_sweeps_bit_identical`` holds its own;
  * the float32 ``pow`` twin against XLA:CPU on 10**6 (base, exponent)
    pairs from a 600-host cluster's score tables and norms, exponents
    0.5, 1, 2 and random ones; torch's own ``pow`` differs there;
  * ``tests/test_ensemble.py``'s sweep hand cases on the port (shapes
    and pairing, the capacity trade-off, faults paired across sizes, the
    workload sweep against a plain rollout).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pivot_tpu.parallel import ensemble as JE
from pivot_tpu_torch.des import Environment
from pivot_tpu_torch.infra import Cluster, Host, Storage
from pivot_tpu_torch.infra.locality import ResourceMetadata
from pivot_tpu_torch.infra.market import MarketSchedule
from pivot_tpu_torch.parallel import ensemble as E
from pivot_tpu_torch.parallel.ensemble import libm, prng
from pivot_tpu_torch.workload import Application, TaskGroup

from tests.test_ensemble import _random_apps
from tests.test_torch_ensemble import (
    POLICIES,
    _inputs,
    _pair_inputs,
    assert_results_equal,
    chain_app,
)
from tests.test_torch_ensemble import _cluster as _make_cluster


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_cluster():
    return _make_cluster(Environment, Host, Storage, Cluster,
                         ResourceMetadata)


@pytest.fixture(scope="module")
def jax_cluster():
    from pivot_tpu.des import Environment as JEnv
    from pivot_tpu.infra import Cluster as JCl
    from pivot_tpu.infra import Host as JHost
    from pivot_tpu.infra import Storage as JSt
    from pivot_tpu.infra.locality import ResourceMetadata as JMeta

    return _make_cluster(JEnv, JHost, JSt, JCl, JMeta)


@pytest.fixture(scope="module")
def pair(jax_cluster, port_cluster):
    """Four random apps (2-6 groups, some fan-out) on the 8-host
    cluster, float64 on both sides."""
    apps = _random_apps(np.random.default_rng(31), 4, (2, 6), name="s")
    return _pair_inputs(jax_cluster, port_cluster, apps,
                        [float(8 * i) for i in range(len(apps))], "float64")


KEY = 9
KW = dict(n_replicas=3, tick=5.0, max_ticks=160, perturb=0.1)


def _keys():
    return jax.random.PRNGKey(KEY), prng.PRNGKey(KEY)


@pytest.mark.parametrize("tick_order", ["fifo", "lifo"])
def test_score_param_sweep_parity(pair, tick_order):
    (jw, jtopo, ja0, jsz), (pw, ptopo, pa0, psz) = pair
    grid = np.array([[1, 1, 1], [0, 1, 1], [4, 1, 0], [0.5, 2, 1.5]],
                    np.float32)
    jk, pk = _keys()
    kw = dict(KW, tick_order=tick_order)
    stats = {}
    got = E.score_param_sweep(pk, pa0, pw, ptopo, psz, grid, stats=stats,
                              **kw)
    assert got.makespan.shape == (4, 3)
    assert stats["host_syncs"] == stats["ticks"] + 1
    for forms in ("vector", "indexed"):  # test_ensemble.py:1363's pair
        want = JE.score_param_sweep(jk, ja0, jw, jtopo, jsz, grid,
                                    forms=forms, **kw)
        assert_results_equal(got, want, f"forms={forms}")
    # The exponents move decisions.
    assert any(not torch.equal(got.placement[0], got.placement[k])
               for k in range(1, 4))


def test_capacity_grid_matches(pair):
    (_jw, _jt, ja0, _js), (_pw, _pt, pa0, _ps) = pair
    for counts in ([2, 8], [1, 5, 8], [8]):
        np.testing.assert_array_equal(
            E.capacity_grid(pa0, counts).numpy(),
            np.asarray(JE.capacity_grid(ja0, counts)))


@pytest.mark.parametrize("case", ["plain", "faults", "faults_nonprefix",
                                  "opportunistic_faults"])
def test_capacity_sweep_parity(pair, case):
    (jw, jtopo, ja0, jsz), (pw, ptopo, pa0, psz) = pair
    jk, pk = _keys()
    pgrid = E.capacity_grid(pa0, [3, 5, 8])
    if case == "faults_nonprefix":
        # Live hosts {1, 2, 4, 6} and {0, 4, 6, 7}: the union is not a
        # prefix, so a crash rank must map through the live hosts.
        keep = torch.tensor([[0, 1, 1, 0, 1, 0, 1, 0],
                             [1, 0, 0, 0, 1, 0, 1, 1]], dtype=torch.bool)
        pgrid = torch.where(keep[..., None], pa0[None], -1.0)
    jgrid = jnp.asarray(pgrid.numpy())
    kw = dict(KW, policy="opportunistic" if case.startswith("opp")
              else "cost-aware")
    if case != "plain":
        kw.update(n_faults=3, fault_horizon=90.0, mttr=25.0)
    got = E.capacity_sweep(pk, pgrid, pw, ptopo, psz, **kw)
    want = JE.capacity_sweep(jk, jgrid, jw, jtopo, jsz, forms="indexed",
                             **kw)
    assert_results_equal(got, want)
    if case == "faults_nonprefix":
        dead = ~keep
        for k in range(2):
            pl = got.placement[k]
            assert not dead[k][pl[pl >= 0].long()].any()


@pytest.mark.parametrize("policy", POLICIES)
def test_workload_sweep_parity(pair, policy):
    (jw, jtopo, ja0, jsz), (pw, ptopo, pa0, psz) = pair
    jk, pk = _keys()
    kw = dict(KW, policy=policy)
    got = E.workload_sweep(pk, pa0, pw, ptopo, psz, [1, 2, 4], **kw)
    forms = ("vector", "indexed") if policy == "opportunistic" else \
        ("indexed",)
    for f in forms:
        want = JE.workload_sweep(jk, ja0, jw, jtopo, jsz, [1, 2, 4],
                                 forms=f, **kw)
        assert_results_equal(got, want, f"forms={f}")
    assert got.n_unfinished.max().item() == 0


def _rows(pw, psz, jw, K, R, dtype=torch.float64):
    """Tiled draws on both sides, the port's converted to JAX arrays."""
    rt, arr, ra = E._perturbations(prng.PRNGKey(KEY), pw, psz, R, 0.1, dtype)
    p = tuple(E._tile_rows(x, K) for x in (rt, arr, ra))
    j = tuple(jnp.asarray(x.numpy().astype(np.int32) if x.dtype ==
                          torch.int64 else x.numpy()) for x in p)
    return p, j


def _hazard(port_cluster, ptopo, dtype=torch.float64):
    """A ``MarketSchedule.generate`` market's segment starts and hazard
    rows, plus a seeded per-host spread (the 8-host cluster's market
    prices one zone only, too few hosts for the risk to move every
    policy)."""
    market = MarketSchedule.generate(port_cluster.meta, seed=3,
                                     horizon=150.0, n_segments=4)
    rows = market.hazard[:, ptopo.host_zone.numpy()]
    rows = rows / max(rows.max(), 1e-30) + np.random.default_rng(6).random(
        rows.shape)
    times = torch.tensor(market.times, dtype=dtype)
    return (times, torch.tensor(rows * 100.0, dtype=dtype)), (
        jnp.asarray(times.numpy()), jnp.asarray(rows * 100.0))


@pytest.mark.parametrize("policy", POLICIES)
def test_run_rows_risk_parity(pair, port_cluster, policy):
    (jw, jtopo, ja0, jsz), (pw, ptopo, pa0, psz) = pair
    K, R = 2, 3
    (prt, parr, pra), (jrt, jarr, jra) = _rows(pw, psz, jw, K, R)
    phaz, jhaz = _hazard(port_cluster, ptopo)
    rc = np.repeat([0.0, 0.02], R)
    extra = {}
    jextra = {}
    if policy == "cost-aware":
        sp = np.repeat([[1, 1, 1], [1.5, 0.8, 0.5]], R, 0)
        extra["score_params"] = torch.tensor(sp)
        jextra["score_params"] = jnp.asarray(sp)
    if policy == "opportunistic":
        u = E._opportunistic_uniforms(prng.PRNGKey(KEY), R, pw.n_tasks,
                                      torch.float64, "cpu")
        extra["task_u"] = E._tile_rows(u, K)
        jextra["task_u"] = jnp.asarray(extra["task_u"].numpy())
    avail = pa0.expand(K * R, *pa0.shape)
    got = E._run_rows(avail, prt, parr, pra, pw, ptopo, 5.0, 160, None,
                      policy, False, False, risk_coeff=torch.tensor(rc),
                      hazard=phaz, **extra)
    want = JE._run_rows(jnp.broadcast_to(ja0, (K * R,) + ja0.shape), jrt,
                        jarr, jra, jw, jtopo, 5.0, 160, None, policy, False,
                        False, risk_coeff=jnp.asarray(rc), hazard=jhaz,
                        forms="indexed", **jextra)
    assert_results_equal(got, want)
    assert got.n_unfinished.max().item() == 0
    # Same draws in both candidates: the risk term moved placements.
    assert not torch.equal(got.placement[:R], got.placement[R:])


def test_run_rows_active_parity(pair):
    (jw, jtopo, ja0, jsz), (pw, ptopo, pa0, psz) = pair
    K, R = 2, 3
    (prt, parr, pra), (jrt, jarr, jra) = _rows(pw, psz, jw, K, R)
    rng = np.random.default_rng(4)
    # Whole apps in or out (a DAG's tasks share an app).
    app_in = rng.random((K * R, 4)) < 0.6
    act = app_in[:, pw.app_of.numpy()]
    parr = torch.where(torch.tensor(act), parr, float("inf"))
    got = E._run_rows(pa0.expand(K * R, *pa0.shape), prt, parr, pra, pw,
                      ptopo, 5.0, 160, None, "first-fit", False, False,
                      active=torch.tensor(act))
    want = JE._run_rows(jnp.broadcast_to(ja0, (K * R,) + ja0.shape), jrt,
                        jnp.asarray(parr.numpy()), jra, jw, jtopo, 5.0, 160,
                        None, "first-fit", False, False,
                        active=jnp.asarray(act), forms="indexed")
    assert_results_equal(got, want)
    assert got.n_unfinished.max().item() == 0
    assert (got.placement[torch.tensor(~act)] == -1).all()


def test_segmented_sweeps_bit_identical(pair):
    (jw, jtopo, ja0, jsz), (pw, ptopo, pa0, psz) = pair
    _jk, pk = _keys()
    kw = dict(KW, max_ticks=160)
    grid = E.capacity_grid(pa0, [3, 8])
    runs = [
        lambda **s: E.capacity_sweep(pk, grid, pw, ptopo, psz, n_faults=2,
                                     fault_horizon=60.0, mttr=20.0, **s,
                                     **kw),
        lambda **s: E.score_param_sweep(pk, pa0, pw, ptopo, psz,
                                        [[1, 1, 1], [2, 1, 0.5]], **s, **kw),
        lambda **s: E.workload_sweep(pk, pa0, pw, ptopo, psz, [2, 4],
                                     policy="best-fit", **s, **kw),
    ]
    for run in runs:
        one, st1 = run(stats={}), {}
        seg, st7 = run(segment_ticks=7, stats=st1), st1
        for name, a, b in zip(one._fields, one, seg):
            assert torch.equal(a, b), name
        # One host read before each segment's loop, one each tick.
        assert st7["host_syncs"] > st7["ticks"] + 1


def test_segmented_run_rows_match_pivot_tpu(pair):
    (jw, jtopo, ja0, jsz), (pw, ptopo, pa0, psz) = pair
    jk, pk = _keys()
    kw = dict(KW, n_faults=2, fault_horizon=60.0, mttr=20.0)
    got = E.capacity_sweep(pk, E.capacity_grid(pa0, [4, 8]), pw, ptopo,
                           psz, segment_ticks=32, **kw)
    want = JE.capacity_sweep(jk, JE.capacity_grid(ja0, [4, 8]), jw, jtopo,
                             jsz, segment_ticks=32, forms="indexed", **kw)
    assert_results_equal(got, want)


# -- the float32 pow twin ----------------------------------------------------


def test_powf_twin_on_score_tables():
    """10**6 (base, exponent) pairs from the score tables of the 600-host
    CLI cluster (round-trip costs and bandwidths, availability norms of
    partly filled hosts) against XLA:CPU's ``x ** w`` in float32."""
    from pivot_tpu_torch.experiments import cli as pcli
    from pivot_tpu_torch.parallel.ensemble.bill import _fma_norms

    args = pcli.parse_args(["ensemble"])
    cluster = pcli.build_cluster(pcli._cluster_config(args))
    topo, a0, _ = _inputs(cluster)
    hz = topo.host_zone.long()
    cost_rt = topo.cost[:, hz] + topo.cost[hz, :].T
    bw_rt = topo.bw[:, hz] + topo.bw[hz, :].T
    rng = np.random.default_rng(0)
    used = torch.from_numpy(rng.random((400, 600, 4)).astype(np.float32))
    norms = _fma_norms(a0[None] * used).reshape(-1)
    bases = torch.cat([cost_rt.reshape(-1), bw_rt.reshape(-1), norms])
    bases = bases[torch.from_numpy(rng.integers(0, bases.numel(), 10 ** 6))]
    jp = jax.jit(lambda x, w: x ** w)
    for w in (0.5, 1.0, 2.0, None):
        ws = (torch.from_numpy(rng.uniform(0.25, 3.0, bases.numel())
                               .astype(np.float32)) if w is None
              else torch.full_like(bases, w))
        want = np.asarray(jp(jnp.asarray(bases.numpy()),
                             jnp.asarray(ws.numpy())))
        got = libm.powf(bases, ws).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"w={w}")
        if w != 1.0:
            assert not np.array_equal(torch.pow(bases, ws).numpy(), want)


def test_pow64_is_the_c_library_pow():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(0, 2e5, 20000))
    w = torch.from_numpy(rng.uniform(0.25, 3.0, 20000))
    want = np.asarray(jax.jit(lambda a, b: a ** b)(jnp.asarray(x.numpy()),
                                                   jnp.asarray(w.numpy())))
    np.testing.assert_array_equal(libm.pow64(x, w).numpy(), want)


def test_float64_host_calls_refuse_card_tensors():
    """The float64 ``pow`` / ``log`` twins run on the host: they and the
    fault draw refuse tensors off the CPU (``meta`` stands in for the
    card) rather than copy them over; float32 and the CPU pass."""
    meta = dict(dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CPU parity path"):
        libm.pow64(torch.ones(3, **meta), torch.ones(3, **meta))
    with pytest.raises(ValueError, match="CPU parity path"):
        libm.xla_pow(torch.ones(3, **meta), torch.ones(1, **meta))
    with pytest.raises(ValueError, match="CPU parity path"):
        libm.neg_log1p_neg(torch.full((3,), 0.9, **meta))
    with pytest.raises(ValueError, match="CPU parity path"):
        E._fault_schedule(prng.PRNGKey(0), 2, 2, 8, 100.0, 30.0,
                          torch.float64, "meta", contract=False)
    libm.require_host(torch.float32, "cuda", "score exponents")
    libm.require_host(torch.float64, "cpu", "score exponents")


# -- tests/test_ensemble.py's sweep hand cases, on the port ---------------


def _hand(port_cluster, apps, arrivals=None):
    topo, a0, sz = _inputs(port_cluster)
    w = E.EnsembleWorkload.from_applications(apps, arrivals=arrivals,
                                             device="cpu")
    return a0, w, topo, sz


def test_score_param_sweep_shapes_and_pairing(port_cluster):
    apps = [chain_app(), Application("fan", [
        TaskGroup("s", cpus=2, mem=512, runtime=5, output_size=4000,
                  instances=4),
        TaskGroup("t", cpus=2, mem=512, runtime=5, dependencies=["s"],
                  instances=4)])]
    a0, w, topo, sz = _hand(port_cluster, apps)
    grid = [[1.0, 1.0, 1.0], [0.0, 1.0, 1.0], [4.0, 1.0, 0.0]]
    res = E.score_param_sweep(prng.PRNGKey(11), a0, w, topo, sz, grid,
                              n_replicas=8, tick=5.0, max_ticks=128,
                              perturb=0.1)
    assert res.makespan.shape == (3, 8)
    assert res.placement.shape == (3, 8, w.n_tasks)
    ref = E.rollout(prng.PRNGKey(11), a0, w, topo, sz, n_replicas=8,
                    tick=5.0, max_ticks=128, perturb=0.1)
    assert torch.equal(res.placement[0], ref.placement)


def test_capacity_sweep_tradeoff(port_cluster):
    app = Application("cap", [TaskGroup("g", cpus=8, mem=256, runtime=10,
                                        instances=16)])
    a0, w, topo, sz = _hand(port_cluster, [app])
    res = E.capacity_sweep(prng.PRNGKey(14), E.capacity_grid(a0, [2, 8]), w,
                           topo, sz, n_replicas=4, tick=5.0, max_ticks=128,
                           perturb=0.0, policy="first-fit")
    mk = res.makespan.numpy()
    assert res.n_unfinished.max().item() == 0
    assert (mk[0] > mk[1]).all()
    assert res.placement[0].max().item() < 2
    assert np.allclose(res.instance_hours[1].numpy(), 8 * 10.0 / 3600.0)


def test_capacity_sweep_with_faults_paired_across_sizes(port_cluster):
    app = Application("rz", [TaskGroup("g", cpus=8, mem=256, runtime=20,
                                       instances=8)])
    a0, w, topo, sz = _hand(port_cluster, [app])
    kw = dict(n_replicas=4, tick=5.0, max_ticks=256, perturb=0.0,
              policy="first-fit")
    grid = E.capacity_grid(a0, [2, 8])
    base = E.capacity_sweep(prng.PRNGKey(16), grid, w, topo, sz, **kw)
    zero = E.capacity_sweep(prng.PRNGKey(16), grid, w, topo, sz, n_faults=0,
                            **kw)
    assert torch.equal(base.makespan, zero.makespan)
    fkw = dict(kw, n_faults=3, fault_horizon=100.0, mttr=50.0)
    faulty = E.capacity_sweep(prng.PRNGKey(16), grid, w, topo, sz, **fkw)
    mk_f, mk_b = faulty.makespan.numpy(), base.makespan.numpy()
    assert faulty.n_unfinished.max().item() == 0
    assert (mk_f >= mk_b - 1e-5).all() and (mk_f > mk_b + 1e-5).any()
    solo = E.capacity_sweep(prng.PRNGKey(16), E.capacity_grid(a0, [8]), w,
                            topo, sz, **fkw)
    assert torch.equal(solo.makespan[0], faulty.makespan[1])


def test_workload_sweep_scales_with_app_count(port_cluster):
    apps = [Application(f"a{i}", [
        TaskGroup("p", cpus=1, mem=256, runtime=5, output_size=4000),
        TaskGroup("c", cpus=1, mem=256, runtime=5, instances=2,
                  dependencies=["p"])]) for i in range(4)]
    a0, w, topo, sz = _hand(port_cluster, apps, [0.0, 10.0, 20.0, 30.0])
    kw = dict(n_replicas=2, tick=5.0, max_ticks=128, perturb=0.0,
              policy="first-fit")
    res = E.workload_sweep(prng.PRNGKey(15), a0, w, topo, sz, [1, 2, 4],
                           **kw)
    assert res.makespan.shape == (3, 2)
    assert res.n_unfinished.max().item() == 0
    place = res.placement.numpy()
    assert (place[0, :, 3:] == -1).all() and (place[0, :, :3] >= 0).all()
    eg = res.egress_cost.numpy()
    assert (eg[0] <= eg[1] + 1e-9).all() and (eg[1] <= eg[2] + 1e-9).all()
    full = E.rollout(prng.PRNGKey(15), a0, w, topo, sz, **kw)
    assert np.array_equal(place[2], full.placement.numpy())
    assert torch.equal(res.makespan[2], full.makespan)
