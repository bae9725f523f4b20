"""The port's Monte-Carlo ensemble rollout vs ``pivot_tpu``'s.

  * **hand-checkable cases** of ``tests/test_ensemble.py`` on the port's
    own cluster, workload and rollout (chain makespan 85, one parallel
    wave, capacity waves, transfer delay and egress, first-fit lowest
    index, best-fit tightest, opportunistic determinism, cost-aware
    winning on egress, instance-hours, the group-demand guard), the
    option combinations ``pivot_tpu`` refuses raising its ``ValueError``
    and a mesh over several distinct devices raising
    ``NotImplementedError`` (``tests/test_torch_replica_mesh.py`` holds
    the sharded rollout and sweeps);
  * **parity on the CPU in float64**: the port's ``rollout`` and
    ``pivot_tpu``'s on the same inputs, every policy × {fifo, lifo},
    against both JAX tick-body forms (``vector`` and ``indexed``).
    Placements, finish times, makespans, instance-hours and unfinished
    counts are equal bit for bit.  The egress bill is held to rtol 1e-12:
    XLA's CPU GEMM rounds one (group, zone) product differently depending
    on the task column it lands in, so no fixed summation order matches
    it everywhere (``parallel/ensemble/bill.py``);
  * replicas that finish many ticks apart (perturb 0.4): each prefix of
    the ensemble equals the smaller ensemble (the draws are prefix-stable
    and a finished replica stays frozen), and the run equals JAX's;
  * ``rollout_chunked`` at ``replica_chunk=4`` of R = 10 against JAX's;
  * ``ensemble_inputs_from_schedule`` on a 40-host, 5-app trace window;
  * the refund sums: the trace's demands are not integers, so the refund
    adds each host's retiring tasks in task-index order, as JAX does on
    the CPU; the vote and zone counts are integers, exact in any order.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pivot_tpu.des import Environment as JEnvironment
from pivot_tpu.infra import Cluster as JCluster
from pivot_tpu.infra import Host as JHost
from pivot_tpu.infra import Storage as JStorage
from pivot_tpu.infra.locality import ResourceMetadata as JMeta
from pivot_tpu.ops.kernels import DeviceTopology as JTopology
from pivot_tpu.parallel import ensemble as JE
from pivot_tpu_torch.des import Environment
from pivot_tpu_torch.infra import Cluster, Host, Storage
from pivot_tpu_torch.infra.locality import ResourceMetadata
from pivot_tpu_torch.ops.kernels import DeviceTopology
from pivot_tpu_torch.parallel import ensemble as E
from pivot_tpu_torch.parallel.ensemble import prng
from pivot_tpu_torch.workload import Application, TaskGroup

from tests.test_ensemble import _forms_workload, _random_apps

POLICIES = ("cost-aware", "first-fit", "best-fit", "opportunistic")
EGRESS_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast as eight here and
    does not fight the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cluster(env_cls, host_cls, storage_cls, cluster_cls, meta_cls,
             cpus=16, n=8):
    meta = meta_cls(seed=0, jitter=False)
    env = env_cls()
    hosts = [host_cls(env, cpus, 1 << 17, 100, 4,
                      locality=meta.zones[i % 4]) for i in range(n)]
    storage = [storage_cls(env, z)
               for z in dict.fromkeys(h.locality for h in hosts)]
    return cluster_cls(env, hosts=hosts, storage=storage, meta=meta,
                       route_mode="meta", seed=0)


@pytest.fixture(scope="module")
def port_cluster():
    return _cluster(Environment, Host, Storage, Cluster, ResourceMetadata)


@pytest.fixture(scope="module")
def jax_cluster():
    return _cluster(JEnvironment, JHost, JStorage, JCluster, JMeta)


def _inputs(cluster, dtype=torch.float32):
    topo = DeviceTopology.from_cluster(cluster, dtype, device="cpu")
    avail0 = torch.tensor(cluster.availability_matrix(), dtype=dtype)
    sz = torch.as_tensor(np.asarray(cluster.storage_zone_vector())).long()
    return topo, avail0, sz


def _run(cluster, apps, seed=0, arrivals=None, avail0=None, **kw):
    topo, a0, sz = _inputs(cluster)
    w = E.EnsembleWorkload.from_applications(apps, arrivals=arrivals,
                                             device="cpu")
    return E.rollout(prng.PRNGKey(seed), a0 if avail0 is None else avail0,
                     w, topo, sz, **kw)


def chain_app():
    return Application("chain", [
        TaskGroup("a", cpus=1, mem=256, runtime=10, output_size=0),
        TaskGroup("b", cpus=1, mem=256, runtime=20, output_size=0,
                  dependencies=["a"]),
        TaskGroup("c", cpus=1, mem=256, runtime=30, output_size=0,
                  dependencies=["b"]),
    ])


def _port_apps(apps):
    """The same applications built from the port's classes."""
    return [Application(a.id, [
        TaskGroup(g.id, cpus=g.cpus, mem=g.mem, disk=g.disk, gpus=g.gpus,
                  runtime=g.runtime, output_size=g.output_size,
                  instances=g.instances, dependencies=list(g.dependencies))
        for g in a.groups]) for a in apps]


# -- hand-checkable cases -------------------------------------------------


def test_workload_flattening():
    app = Application("w", [
        TaskGroup("a", cpus=1, mem=1, runtime=1, instances=3, output_size=5),
        TaskGroup("b", cpus=2, mem=2, runtime=2, instances=2,
                  dependencies=["a"]),
    ])
    w = E.EnsembleWorkload.from_applications([app], device="cpu")
    assert w.n_tasks == 5 and w.n_groups == 2
    pred = w.pred.numpy()
    assert pred[3, :3].tolist() == [1, 1, 1]
    assert pred[4, :3].tolist() == [1, 1, 1]
    assert pred[:3].sum() == 0
    assert w.pred_group.numpy().tolist() == [[0, 0], [1, 0]]


def test_group_demand_invariant_guard():
    app = Application("w", [TaskGroup("a", cpus=1, mem=1, runtime=1,
                                      instances=3)])
    w = E.EnsembleWorkload.from_applications([app], device="cpu")
    w.check_group_demands()
    dem = w.demands.clone()
    dem[1, 0] = 2.0
    with pytest.raises(ValueError, match="vary within a group"):
        w._replace(demands=dem).check_group_demands()


def test_rollout_chain_makespan(port_cluster):
    """a places at t=5 → 15; b's pump passes strictly after 15 (t=20) and
    it places at 25 → 45; c places at 55 → 85."""
    res = _run(port_cluster, [chain_app()], n_replicas=4, tick=5.0,
               max_ticks=64, perturb=0.0)
    assert res.n_unfinished.tolist() == [0, 0, 0, 0]
    assert np.allclose(res.makespan.numpy(), 85.0)


def test_rollout_parallel_groups(port_cluster):
    app = Application("par", [TaskGroup("g", cpus=1, mem=256, runtime=30,
                                        instances=16)])
    res = _run(port_cluster, [app], seed=1, n_replicas=2, tick=5.0,
               max_ticks=32, perturb=0.0)
    assert res.n_unfinished.tolist() == [0, 0]
    assert np.allclose(res.makespan.numpy(), 35.0)


def test_rollout_respects_capacity(port_cluster):
    """48 × 8-cpu tasks on 8 × 16 cpus: at least three waves."""
    app = Application("big", [TaskGroup("g", cpus=8, mem=256, runtime=10,
                                        instances=48)])
    res = _run(port_cluster, [app], seed=2, n_replicas=2, tick=5.0,
               max_ticks=128, perturb=0.0)
    assert res.n_unfinished.tolist() == [0, 0]
    assert res.makespan.numpy().min() >= 30.0
    # No host ever held more than 2 tasks at once: starts per (host, tick)
    # never exceed the 16-cpu capacity.
    start = (res.finish_time - 10.0).numpy()
    place = res.placement.numpy()
    for r in range(2):
        for t in np.unique(start[r]):
            on = place[r][start[r] == t]
            assert np.bincount(on).max() <= 2


def test_rollout_transfer_delay_and_egress(port_cluster):
    app = Application("xfer", [
        TaskGroup("a", cpus=1, mem=256, runtime=10, output_size=8000),
        TaskGroup("b", cpus=1, mem=256, runtime=10, dependencies=["a"]),
    ])
    res = _run(port_cluster, [app], seed=3, n_replicas=4, tick=5.0,
               max_ticks=64, perturb=0.0)
    assert res.n_unfinished.tolist() == [0] * 4
    assert (res.makespan.numpy() >= 20.0).all()
    topo, _, _ = _inputs(port_cluster)
    hz, cost, bw = (topo.host_zone.numpy(), topo.cost.numpy(),
                    topo.bw.numpy())
    place, fin = res.placement.numpy(), res.finish_time.numpy()
    for r in range(4):
        za, zb = hz[place[r, 0]], hz[place[r, 1]]
        assert res.egress_cost[r].item() == pytest.approx(
            cost[za, zb] * 8000 / 8000, rel=1e-5)
        # b starts on a tick and runs size / bw longer than its runtime.
        delay = fin[r, 1] - 10.0 - np.floor((fin[r, 1] - 10.0) / 5.0) * 5.0
        assert delay == pytest.approx(np.float32(8000.0) / bw[za, zb],
                                      rel=1e-5)


def test_first_fit_rollout_packs_lowest_index(port_cluster):
    app = Application("ff", [TaskGroup("g", cpus=1, mem=256, runtime=10,
                                       instances=4)])
    res = _run(port_cluster, [app], n_replicas=2, tick=5.0, max_ticks=32,
               perturb=0.0, policy="first-fit")
    assert (res.placement.numpy() == 0).all()
    assert res.n_unfinished.tolist() == [0, 0]


def test_best_fit_rollout_picks_tightest(port_cluster):
    app = Application("bf", [TaskGroup("g", cpus=1, mem=256, runtime=10)])
    _, a0, _ = _inputs(port_cluster)
    a0[3, 0], a0[3, 1] = 2.0, 512.0  # a nearly full host
    res = _run(port_cluster, [app], avail0=a0, n_replicas=2, tick=5.0,
               max_ticks=32, perturb=0.0, policy="best-fit")
    assert (res.placement.numpy() == 3).all()


def test_opportunistic_rollout_spreads_and_is_deterministic(port_cluster):
    app = Application("op", [TaskGroup("g", cpus=1, mem=256, runtime=10,
                                       instances=24)])
    kw = dict(n_replicas=4, tick=5.0, max_ticks=64, perturb=0.0,
              policy="opportunistic")
    a = _run(port_cluster, [app], seed=5, **kw)
    b = _run(port_cluster, [app], seed=5, **kw)
    np.testing.assert_array_equal(a.placement.numpy(), b.placement.numpy())
    pl = a.placement.numpy()
    assert len(np.unique(pl[0])) > 2
    assert not np.array_equal(pl[0], pl[1])
    assert a.n_unfinished.max().item() == 0


def test_policy_comparison_cost_aware_wins_egress(port_cluster):
    app = Application("cmp", [
        TaskGroup("s", cpus=2, mem=512, runtime=5, output_size=4000,
                  instances=6),
        TaskGroup("t", cpus=2, mem=512, runtime=5, dependencies=["s"],
                  instances=6),
    ])
    eg = {}
    for policy in ("cost-aware", "opportunistic", "first-fit"):
        res = _run(port_cluster, [app], seed=2, n_replicas=8, tick=5.0,
                   max_ticks=64, perturb=0.1, policy=policy)
        assert res.n_unfinished.max().item() == 0
        eg[policy] = res.egress_cost.mean().item()
    assert eg["opportunistic"] > 0
    assert eg["cost-aware"] <= eg["opportunistic"]
    assert eg["first-fit"] <= eg["opportunistic"]


@pytest.mark.parametrize("case", ["chain", "wave", "subtick"])
def test_instance_hours(port_cluster, case):
    """One host busy for the chain's 60 s; 16 one-cpu tasks first-fit
    onto one host for 30 s; a 7 s task bills 7 s, not two ticks."""
    if case == "chain":
        apps, kw, want = [chain_app()], dict(seed=10), 60.0
    elif case == "wave":
        apps = [Application("par", [TaskGroup(
            "g", cpus=1, mem=256, runtime=30, instances=16)])]
        kw, want = dict(seed=11, policy="first-fit"), 30.0
    else:
        apps = [Application("sub", [TaskGroup(
            "g", cpus=1, mem=256, runtime=7, output_size=0)])]
        kw, want = dict(seed=13), 7.0
    res = _run(port_cluster, apps, n_replicas=2, tick=5.0, max_ticks=64,
               perturb=0.0, **kw)
    assert np.allclose(res.instance_hours.numpy(), want / 3600.0)


@pytest.mark.parametrize("option", [
    dict(congestion="zones"), dict(congestion="pairs", realtime_scoring=True),
    dict(realtime_scoring=True),
])
def test_unported_options_raise(port_cluster, option):
    """The congestion model and realtime scoring run now
    (``tests/test_torch_ensemble_congestion.py``); what still raises is a
    combination ``pivot_tpu`` refuses too, with its ``ValueError``."""
    with pytest.raises(ValueError):
        _run(port_cluster, [chain_app()], n_replicas=2, max_ticks=8,
             **option)


def test_fault_option_runs_and_matches_pivot_tpu(jax_cluster, port_cluster):
    """``n_faults`` runs (``tests/test_torch_ensemble_faults.py`` holds it
    over every policy and order)."""
    apps, arrivals, wdtype = _workload("3")
    (jw, jtopo, ja0, jsz), (pw, ptopo, pa0, psz) = _pair_inputs(
        jax_cluster, port_cluster, apps, arrivals, wdtype)
    kw = dict(n_replicas=4, tick=5.0, max_ticks=96, perturb=0.1,
              n_faults=2, fault_horizon=60.0, mttr=20.0)
    got = E.rollout(prng.PRNGKey(2), pa0, pw, ptopo, psz, **kw)
    want = JE.rollout(jax.random.PRNGKey(2), ja0, jw, jtopo, jsz,
                      forms="indexed", **kw)
    assert_results_equal(got, want)


def test_checkpoint_path_raises(port_cluster, tmp_path):
    """Checkpoint files run now (``tests/test_torch_checkpoint.py``); a
    segment length that could never advance raises, and a sharded
    rollout over a mesh of several distinct devices (ROADMAP.md Queue 1,
    several cards) raises ``NotImplementedError``, where a sweep over
    them runs unsharded."""
    topo, a0, sz = _inputs(port_cluster)
    w = E.EnsembleWorkload.from_applications([chain_app()], device="cpu")
    path = str(tmp_path / "ck.npz")
    res = E.rollout_chunked(prng.PRNGKey(0), a0, w, topo, sz, path, 0,
                            n_replicas=2, max_ticks=64, segment_ticks=4)
    assert res.n_unfinished.tolist() == [0, 0]
    with pytest.raises(ValueError, match="segment_ticks"):
        E.rollout_chunked(prng.PRNGKey(0), a0, w, topo, sz, path, 0,
                          n_replicas=2, segment_ticks=0)
    from pivot_tpu_torch.parallel.mesh import replica_mesh

    two = replica_mesh(devices=[torch.device("cpu"), torch.device("meta")])
    with pytest.raises(NotImplementedError, match="Queue 1, several cards"):
        E.sharded_rollout(two, prng.PRNGKey(0), a0, w, topo, sz,
                          n_replicas=2)
    sweep = E.shard_sweep(E.capacity_sweep, force_mesh=True,
                          devices=list(two.devices.flat), n_replicas=2)
    res = sweep(prng.PRNGKey(0), E.capacity_grid(a0, [8]), w, topo, sz)
    assert res.n_unfinished.tolist() == [[0, 0]]


# -- parity with pivot_tpu (float64) -----------------------------------------


def _pair_inputs(jax_cluster, port_cluster, apps, arrivals, wdtype):
    """The same workload and cluster on both sides: JAX arrays under x64
    and port tensors on the CPU, float64 availability and topology; the
    workload in ``wdtype`` (float32 is what ``from_applications`` builds
    and the rollout promotes)."""
    jw = JE.EnsembleWorkload.from_applications(apps, arrivals=arrivals)
    pw = E.EnsembleWorkload.from_applications(
        _port_apps(apps), arrivals=arrivals, dtype=getattr(torch, wdtype),
        device="cpu")
    if wdtype == "float64":
        jw = JE.EnsembleWorkload(*[x.astype(jnp.float64)
                                   if x.dtype == jnp.float32 else x
                                   for x in jw])
    jtopo = JTopology.from_cluster(jax_cluster, jnp.float64)
    ja0 = jnp.asarray(jax_cluster.availability_matrix(), dtype=jnp.float64)
    jsz = jnp.asarray(jax_cluster.storage_zone_vector())
    ptopo, pa0, psz = _inputs(port_cluster, torch.float64)
    for j, p in zip(jtopo[:3], ptopo[:3]):
        np.testing.assert_array_equal(np.asarray(j), p.numpy())
    np.testing.assert_array_equal(np.asarray(ja0), pa0.numpy())
    return (jw, jtopo, ja0, jsz), (pw, ptopo, pa0, psz)


def assert_results_equal(port_res, jax_res, what=""):
    for name, p, j in zip(port_res._fields, port_res, jax_res):
        j = np.asarray(j)
        p = p.numpy()
        assert p.shape == j.shape, (name, what)
        if name == "egress_cost":
            np.testing.assert_allclose(p, j, rtol=EGRESS_RTOL, atol=0,
                                       err_msg=f"{name} {what}")
        else:
            np.testing.assert_array_equal(p, j, err_msg=f"{name} {what}")


def _workload(kind):
    if kind == "forms":
        apps = _random_apps(np.random.default_rng(99), 3, 4, chain=True,
                            name="fp")
        return apps, [0.0, 10.0, 25.0], "float32"
    apps = _random_apps(np.random.default_rng(int(kind)), 4, (2, 6),
                        name="p")
    return apps, [float(7 * i) for i in range(len(apps))], "float64"


@pytest.mark.parametrize("tick_order", ["fifo", "lifo"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("kind", ["forms", "3"])
def test_rollout_parity_f64(jax_cluster, port_cluster, kind, policy,
                            tick_order):
    apps, arrivals, wdtype = _workload(kind)
    (jw, jtopo, ja0, jsz), (pw, ptopo, pa0, psz) = _pair_inputs(
        jax_cluster, port_cluster, apps, arrivals, wdtype)
    kw = dict(n_replicas=6, tick=5.0, max_ticks=96, perturb=0.1,
              policy=policy, tick_order=tick_order)
    stats = {}
    got = E.rollout(prng.PRNGKey(42), pa0, pw, ptopo, psz, stats=stats, **kw)
    assert got.n_unfinished.max().item() == 0
    assert stats["host_syncs"] == stats["ticks"] + 1
    for forms in ("vector", "indexed"):
        want = JE.rollout(jax.random.PRNGKey(42), ja0, jw, jtopo, jsz,
                          forms=forms, **kw)
        assert_results_equal(got, want, f"forms={forms}")


def test_forms_workload_matches_test_ensemble():
    """The parity workload above is ``tests/test_ensemble.py``'s."""
    apps, arrivals, _ = _workload("forms")
    a = JE.EnsembleWorkload.from_applications(apps, arrivals=arrivals)
    for x, y in zip(a, _forms_workload()):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_frozen_replicas(jax_cluster, port_cluster):
    """perturb 0.4 spreads the replicas' makespans over many ticks.  Each
    prefix of the R = 8 ensemble equals the ensemble of that size (the
    draws are prefix-stable and the tick loop freezes a finished replica:
    its clock, busy integral and every other field), and the run equals
    JAX's under vmap."""
    apps = _random_apps(np.random.default_rng(5), 2, 8, chain=True,
                        name="z")
    (jw, jtopo, ja0, jsz), (pw, ptopo, pa0, psz) = _pair_inputs(
        jax_cluster, port_cluster, apps, [0.0, 30.0], "float64")
    kw = dict(tick=5.0, max_ticks=256, perturb=0.4, policy="cost-aware")
    full = E.rollout(prng.PRNGKey(7), pa0, pw, ptopo, psz, n_replicas=8,
                     **kw)
    mk = full.makespan.numpy()
    assert full.n_unfinished.max().item() == 0
    assert mk.max() - mk.min() > 3 * kw["tick"]
    for r in (1, 3, 5):
        part = E.rollout(prng.PRNGKey(7), pa0, pw, ptopo, psz, n_replicas=r,
                         **kw)
        for name, a, b in zip(full._fields, full, part):
            np.testing.assert_array_equal(a[:r].numpy(), b.numpy(),
                                          err_msg=name)
    want = JE.rollout(jax.random.PRNGKey(7), ja0, jw, jtopo, jsz,
                      n_replicas=8, forms="indexed", **kw)
    assert_results_equal(full, want)


@pytest.mark.parametrize("policy", ["cost-aware", "opportunistic"])
def test_single_rollout_parity(jax_cluster, port_cluster, policy):
    """One replica on given draws, unbatched results."""
    apps, arrivals, wdtype = _workload("6")
    (jw, jtopo, ja0, jsz), (pw, ptopo, pa0, psz) = _pair_inputs(
        jax_cluster, port_cluster, apps, arrivals, wdtype)
    key = prng.PRNGKey(3)
    rt, arr, anchor = E._perturbations(key, pw, psz, 2, 0.2, torch.float64)
    u = E._opportunistic_uniforms(key, 2, pw.n_tasks, torch.float64, "cpu")
    kw = dict(tick=5.0, max_ticks=128, policy=policy)
    for r in range(2):
        task_u = u[r] if policy == "opportunistic" else None
        got = E._single_rollout(pa0, rt[r], arr[r], anchor[r], pw, ptopo,
                                task_u=task_u, **kw)
        want = JE._single_rollout(
            ja0, jnp.asarray(rt[r].numpy()), jnp.asarray(arr[r].numpy()),
            jnp.asarray(anchor[r].numpy().astype(np.int32)), jw, jtopo,
            task_u=None if task_u is None else jnp.asarray(task_u.numpy()),
            **kw)
        assert got.makespan.shape == ()
        assert_results_equal(got, want, f"replica {r}")


def test_rollout_chunked_parity(jax_cluster, port_cluster):
    apps, arrivals, wdtype = _workload("4")
    (jw, jtopo, ja0, jsz), (pw, ptopo, pa0, psz) = _pair_inputs(
        jax_cluster, port_cluster, apps, arrivals, wdtype)
    kw = dict(n_replicas=10, tick=5.0, max_ticks=128, perturb=0.15,
              policy="cost-aware")
    got = E.rollout_chunked(prng.PRNGKey(11), pa0, pw, ptopo, psz, None, 4,
                            **kw)
    want = JE.rollout_chunked(jax.random.PRNGKey(11), ja0, jw, jtopo, jsz,
                              None, 4, **kw)
    assert got.makespan.shape == (10,)
    assert_results_equal(got, want)
    # replica_chunk <= 0 is one rollout.
    one = E.rollout_chunked(prng.PRNGKey(11), pa0, pw, ptopo, psz, None, 0,
                            **kw)
    plain = E.rollout(prng.PRNGKey(11), pa0, pw, ptopo, psz, **kw)
    for a, b in zip(one, plain):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# -- the trace bridge -----------------------------------------------------


def _trace_inputs(n_hosts=40, n_apps=5):
    from pivot_tpu.experiments import calibrate as jcal
    from pivot_tpu.experiments import cli as jcli
    from pivot_tpu.workload.trace import load_trace_jobs as jload
    from pivot_tpu_torch.experiments import calibrate as pcal
    from pivot_tpu_torch.experiments import cli as pcli
    from pivot_tpu_torch.workload.trace import load_trace_jobs as pload

    argv = ["--num-hosts", str(n_hosts), "ensemble", "--num-apps",
            str(n_apps)]
    ja, pa = jcli.parse_args(argv), pcli.parse_args(argv)
    trace = jcli._list_traces(ja.job_dir, 1)[0]
    assert pcli._list_traces(pa.job_dir, 1)[0] == trace
    jres = jcal.ensemble_inputs_from_schedule(
        jload(trace, ja.scale_factor).take(n_apps),
        jcli.build_cluster(jcli._cluster_config(ja)))
    pres = pcal.ensemble_inputs_from_schedule(
        pload(trace, pa.scale_factor).take(n_apps),
        pcli.build_cluster(pcli._cluster_config(pa)), device="cpu")
    return jres, pres


def test_ensemble_inputs_from_schedule():
    (jw, jslices, jarr, jtopo, ja0, jsz), (pw, pslices, parr, ptopo, pa0,
                                          psz) = _trace_inputs()
    assert pw.n_tasks == jw.n_tasks and pslices == jslices
    assert parr == jarr
    for name, j, p in zip(jw._fields, jw, pw):
        j = np.asarray(j)
        assert p.numpy().dtype.kind == j.dtype.kind, name
        np.testing.assert_array_equal(p.numpy(), j, err_msg=name)
    assert pw.demands.dtype == torch.float32
    for name, j, p in zip(jtopo._fields, jtopo, ptopo):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j),
                                      err_msg=name)
    assert pa0.dtype == torch.float32
    np.testing.assert_array_equal(pa0.numpy(), np.asarray(ja0))
    np.testing.assert_array_equal(psz.numpy(), np.asarray(jsz))


def test_refund_sums_in_task_order_and_counts_exact():
    """The trace's demands are not integers (0.5 CPUs, 2359.2961 MB), so a
    float sum of them depends on its order.  The refund sums each host's
    retiring tasks in task-index order, as JAX's ``segment_sum`` does on
    the CPU: ``index_put_`` with ``accumulate`` is a sequential loop on
    the CPU and, on the card, a stable sort by row followed by one
    sequential pass per row (no atomics; ``chip_smoke.py`` phase 6 holds
    the card to the CPU bit for bit).  The vote and zone counts add 0/1
    and stay below 2**24, so they are exact in any order."""
    (jw, *_), (pw, _s, _a, ptopo, pa0, _z) = _trace_inputs(600, 50)
    dem = pw.demands.numpy()
    assert dem.dtype == np.float32
    assert not np.array_equal(dem, np.round(dem))
    np.testing.assert_array_equal(dem, np.asarray(jw.demands))
    rng = np.random.default_rng(0)
    for n_rows in (1, 7, 600):
        rows = rng.integers(0, n_rows, dem.shape[0])
        seq = np.zeros((n_rows, 4), np.float32)
        for t, r in enumerate(rows):
            seq[r] += dem[t]
        got = torch.zeros((n_rows, 4)).index_put_(
            (torch.from_numpy(rows),), torch.from_numpy(dem),
            accumulate=True).numpy()
        want = np.asarray(jax.ops.segment_sum(
            jnp.asarray(dem), jnp.asarray(rows), num_segments=n_rows))
        np.testing.assert_array_equal(got, seq)
        np.testing.assert_array_equal(got, want)
    assert pw.n_tasks < 2 ** 24
