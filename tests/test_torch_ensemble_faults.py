"""The port's fault ensembles vs ``pivot_tpu``'s.

  * the draws: ``prng.randint`` (32- and 64-bit, a tensor bound too) and
    ``prng.exponential`` bitwise equal to ``jax.random`` over many keys,
    shapes and bounds; the ``-log1p(-u)`` twin on every float32 uniform;
    ``draws._fault_schedule`` drawn eagerly (two roundings of
    ``fail_at + mttr · outage``) and inside a jitted program (one), in
    float32 (jax's default config) and float64 (under x64);
  * the fault rollout on the CPU in float64 against ``pivot_tpu``'s,
    every policy × {fifo, lifo} × both JAX tick-body forms, permanent
    crashes too (no ``mttr``): placements,
    finish times, makespans, instance-hours and unfinished counts bit for
    bit, egress within rtol 1e-12 (``tests/test_torch_ensemble.py`` says
    why);
  * ``tests/test_ensemble.py``'s hand cases on the port: zero faults is
    the fault-free run, every host down forever finishes nothing, a
    crash and recovery on a one-host cluster extends the chain to 105 s,
    and replicas draw different schedules.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pivot_tpu.parallel import ensemble as JE
from pivot_tpu.parallel.ensemble import draws as jdraws
from pivot_tpu_torch.des import Environment
from pivot_tpu_torch.infra import Cluster, Host, Storage
from pivot_tpu_torch.infra.locality import ResourceMetadata
from pivot_tpu_torch.ops.kernels import DeviceTopology
from pivot_tpu_torch.parallel import ensemble as E
from pivot_tpu_torch.parallel.ensemble import draws, libm, prng

from tests.test_torch_ensemble import (
    POLICIES,
    _inputs,
    _pair_inputs,
    _run,
    assert_results_equal,
    chain_app,
)
from tests.test_torch_ensemble import _cluster as _make_cluster
from tests.test_ensemble import _random_apps

SEEDS = (0, 1, 7, 0xDEADBEEF)


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


# -- the draws --------------------------------------------------------------


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_twin(seed, bits):
    jdt = jnp.int32 if bits == 32 else jnp.int64
    jk = jax.random.PRNGKey(seed)
    for shape in ((1,), (16, 4), (256, 4), (7, 5)):
        for lo, hi in ((0, 600), (0, 1), (3, 17), (5, 5), (9, 2), (0, 40),
                       (0, 1000003), (0, 2 ** 31 - 1)):
            want = np.asarray(jax.random.randint(jk, shape, lo, hi, jdt))
            got = prng.randint(prng.PRNGKey(seed), shape, lo, hi, bits)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{shape} [{lo}, {hi})")
        # A bound computed on the device, as capacity_sweep's is.
        want = np.asarray(jax.random.randint(jk, shape, 0,
                                             jnp.asarray(37, jdt), jdt))
        got = prng.randint(prng.PRNGKey(seed), shape, 0, torch.tensor(37),
                           bits)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("seed", SEEDS)
def test_exponential_twin(seed, dtype):
    jk = jax.random.PRNGKey(seed)
    for shape in ((1,), (4, 4), (16, 4), (256, 4), (7, 5), (3000,)):
        want = np.asarray(jax.random.exponential(jk, shape,
                                                 getattr(jnp, dtype)))
        got = prng.exponential(prng.PRNGKey(seed), shape,
                               getattr(torch, dtype))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(shape))


@pytest.mark.parametrize("quarter", range(4))
def test_neg_log1p_neg_every_float32_uniform(quarter):
    """XLA:CPU's ``-log1p(-u)`` on all 2**23 float32 uniforms k·2**-23, a
    quarter of them per case (torch's ``log1p`` differs on ~7%)."""
    u = (torch.arange(quarter << 21, (quarter + 1) << 21,
                      dtype=torch.float64) * 2.0 ** -23).float()
    want = np.asarray(jax.jit(lambda v: -jnp.log1p(-v))(
        jnp.asarray(u.numpy())))
    np.testing.assert_array_equal(libm.neg_log1p_neg(u).numpy(), want)
    assert not np.array_equal((-torch.log1p(-u)).numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fault_schedule_twin(dtype):
    """Eager draws (capacity_sweep's) and the jitted rollout's; float32
    under jax's default config (32-bit host draws), float64 under x64."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with jax.enable_x64(dtype == "float64"):
        for seed in range(5):
            for R, F, H, hor, mttr in ((16, 4, 600, 10240.0, 300.0),
                                       (4, 2, 40, 777.7, None),
                                       (3, 5, 9, 100.0, 12.3)):
                jk = jax.random.fold_in(jax.random.PRNGKey(seed), 0x0FA17)
                pk = prng.fold_in(prng.PRNGKey(seed), 0x0FA17)
                want = jdraws._fault_schedule(jk, R, F, H, hor, mttr, jdt)
                got = draws._fault_schedule(pk, R, F, H, hor, mttr, tdt,
                                              contract=False)
                for name, w, g in zip("host fail_at recover_at".split(),
                                      want, got):
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                                  err_msg=f"eager {name}")
                jitted = jax.jit(lambda k: jdraws._make_fault_schedule(
                    k, R, F, jnp.zeros((H, 4), jdt), 5.0, 2048, None,
                    mttr))(jax.random.PRNGKey(seed))
                got = draws._make_fault_schedule(
                    prng.PRNGKey(seed), R, F, torch.zeros(H, 4, dtype=tdt),
                    5.0, 2048, None, mttr, contract=True)
                for name, w, g in zip("host fail_at recover_at".split(),
                                      jitted, got):
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                                  err_msg=f"jit {name}")


# -- the fault rollout ----------------------------------------------------


def _fault_workload():
    apps = _random_apps(np.random.default_rng(21), 4, (2, 6), name="f")
    return apps, [float(9 * i) for i in range(len(apps))], "float64"


@pytest.mark.parametrize("policy,tick_order,mttr", [
    (p, o, 30.0) for p in POLICIES for o in ("fifo", "lifo")
] + [("cost-aware", "fifo", None), ("first-fit", "lifo", None)])
def test_fault_rollout_parity_f64(jax_cluster, port_cluster, policy,
                                  tick_order, mttr):
    apps, arrivals, wdtype = _fault_workload()
    (jw, jtopo, ja0, jsz), (pw, ptopo, pa0, psz) = _pair_inputs(
        jax_cluster, port_cluster, apps, arrivals, wdtype)
    kw = dict(n_replicas=4, tick=5.0, max_ticks=160, perturb=0.1,
              policy=policy, tick_order=tick_order, n_faults=3,
              fault_horizon=120.0, mttr=mttr)
    stats = {}
    got = E.rollout(prng.PRNGKey(5), pa0, pw, ptopo, psz, stats=stats, **kw)
    assert stats["host_syncs"] == stats["ticks"] + 1
    if mttr is not None:
        assert got.n_unfinished.max().item() == 0
    for forms in ("vector", "indexed"):
        want = JE.rollout(jax.random.PRNGKey(5), ja0, jw, jtopo, jsz,
                          forms=forms, **kw)
        assert_results_equal(got, want, f"forms={forms}")
    clean = E.rollout(prng.PRNGKey(5), pa0, pw, ptopo, psz,
                      **dict(kw, n_faults=0))
    assert not torch.equal(got.finish_time, clean.finish_time)


def test_single_rollout_with_faults_parity(jax_cluster, port_cluster):
    apps, arrivals, wdtype = _fault_workload()
    (jw, jtopo, ja0, jsz), (pw, ptopo, pa0, psz) = _pair_inputs(
        jax_cluster, port_cluster, apps, arrivals, wdtype)
    H = pa0.shape[0]
    host = np.array([0, 3, 5, 1], np.int32)
    fail = np.array([7.5, 21.0, 40.0, 66.0])
    rec = np.array([50.0, np.inf, 61.0, 90.0])
    got = E._single_rollout(
        pa0, pw.runtime.double(), pw.arrival.double(),
        torch.zeros(pw.n_tasks, dtype=torch.int64), pw, ptopo, 5.0, 160,
        faults=(torch.from_numpy(host).long(), torch.from_numpy(fail),
                torch.from_numpy(rec)))
    want = JE._single_rollout(
        ja0, jw.runtime, jw.arrival, jnp.zeros(jw.n_tasks, jnp.int32), jw,
        jtopo, 5.0, 160, faults=(jnp.asarray(host), jnp.asarray(fail),
                                 jnp.asarray(rec)))
    assert H > host.max()
    assert_results_equal(got, want)


# -- tests/test_ensemble.py's hand cases, on the port --------------------


def test_fault_rollout_zero_faults_identical(port_cluster):
    kw = dict(n_replicas=4, tick=5.0, max_ticks=64, perturb=0.0)
    a = _run(port_cluster, [chain_app()], seed=7, **kw)
    b = _run(port_cluster, [chain_app()], seed=7, n_faults=0, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_fault_rollout_all_hosts_down_forever(port_cluster):
    topo, a0, _ = _inputs(port_cluster)
    w = E.EnsembleWorkload.from_applications([chain_app()], device="cpu")
    H = a0.shape[0]
    faults = (torch.arange(H), torch.zeros(H),
              torch.full((H,), float("inf")))
    res = E._single_rollout(a0, w.runtime, w.arrival,
                            torch.zeros(w.n_tasks, dtype=torch.int64), w,
                            topo, 5.0, 32, faults=faults)
    assert int(res.n_unfinished) == w.n_tasks
    assert (res.placement == -1).all()


def test_fault_rollout_crash_and_recover_extends_makespan():
    meta = ResourceMetadata(seed=0, jitter=False)
    env = Environment()
    cluster = Cluster(env, hosts=[Host(env, 16, 1 << 17, 100, 4,
                                       locality=meta.zones[0])],
                      storage=[Storage(env, meta.zones[0])], meta=meta,
                      route_mode="meta", seed=0)
    topo, a0, _ = _inputs(cluster)
    w = E.EnsembleWorkload.from_applications([chain_app()], device="cpu")
    anchor = torch.zeros(w.n_tasks, dtype=torch.int64)
    base = E._single_rollout(a0, w.runtime, w.arrival, anchor, w, topo,
                             5.0, 128)
    # a places at 5 → 15; the only host crashes at 17 (b not placed yet)
    # and is back at 42: down through the t=40 tick, restored at 45; b
    # places at 45 → 65, c's pump fires at 70, it places at 75 → 105.
    res = E._single_rollout(a0, w.runtime, w.arrival, anchor, w, topo,
                            5.0, 128, faults=(torch.tensor([0]),
                                              torch.tensor([17.0]),
                                              torch.tensor([42.0])))
    assert int(res.n_unfinished) == 0
    assert float(res.makespan) > float(base.makespan)
    assert float(res.makespan) == pytest.approx(105.0)
    assert float(res.finish_time[0]) == pytest.approx(
        float(base.finish_time[0]))


def test_fault_rollout_replicas_differ(port_cluster):
    kw = dict(n_replicas=16, tick=5.0, max_ticks=128, perturb=0.0)
    res = _run(port_cluster, [chain_app()], seed=3, n_faults=4,
               fault_horizon=60.0, mttr=20.0, **kw)
    base = _run(port_cluster, [chain_app()], seed=3, **kw)
    ms = res.makespan.numpy()
    assert ms.min() >= base.makespan.numpy().min()
    assert len(np.unique(ms)) > 1
