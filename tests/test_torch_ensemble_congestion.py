"""The port's congestion backlog model and realtime scoring vs
``pivot_tpu``'s.

  * **parity on the CPU**, float64 (under x64) and float32 (jax's
    default config): the port's ``rollout`` and ``pivot_tpu``'s
    (``forms="indexed"``, and ``"vector"`` once) with ``congestion=True``
    for every policy × {fifo, lifo}, ``congestion="pairs"``, realtime
    scoring, congestion with faults; ``capacity_sweep`` and
    ``workload_sweep`` with congestion, ``capacity_sweep`` with realtime
    scoring, ``score_param_sweep`` with congestion.  Placements, finish
    times, makespans, instance-hours and unfinished counts are equal bit
    for bit; the egress bill is held to rtol 1e-12 (float64) / 1e-5
    (float32) (``tests/test_torch_ensemble.py`` says why);
  * **the pull volumes** ``pull_frac @ counts``: XLA:CPU's product rounds
    by tile position and the port's does not reproduce it (ROADMAP.md
    Queue 3).  With XLA's own product swapped into
    ``tick._pull_volumes`` the port's rollout on the trace (600 hosts,
    10 apps, float32) equals ``pivot_tpu``'s in every field but the
    egress bill; on the trace's own tables the two products differ by at
    most one rounding;
  * **the drain** ``max(q − bw · tick, 0)`` is one fused multiply-add in
    XLA:CPU's jitted code: the port's pipe step equals it on 200,000
    values of each float width, where the twice-rounded form does not;
  * ``tests/test_ensemble.py``'s congestion, host-pair and realtime cases
    on the port (``:686-900``, ``:1113-1200``).
"""

from __future__ import annotations

import threading

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
from pivot_tpu_torch.parallel.ensemble import tick as ptick
from pivot_tpu_torch.workload import Application, TaskGroup

from tests.test_ensemble import _random_apps
from tests.test_torch_ensemble import (
    POLICIES,
    _cluster,
    _inputs,
    _port_apps,
    chain_app,
)

DTYPES = ("float64", "float32")
EGRESS_RTOL = {"float64": 1e-12, "float32": 1e-5}


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """``pivot_tpu``'s sweeps (``score_param_sweep``, ``capacity_sweep``,
    ``workload_sweep``) leave JAX's caches in a state where a jitted
    function first traced afterwards retraces on every call: run later in
    the same process, ``tests/test_jitcheck.py`` counts those traces and
    fails.  Clear the caches when this module ends."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clusters():
    return (_cluster(JEnvironment, JHost, JStorage, JCluster, JMeta),
            _cluster(Environment, Host, Storage, Cluster, ResourceMetadata))


def _apps(seed=3):
    """Sparse random DAGs with fan-out and 0 / 500 / 4000 MB outputs,
    staggered arrivals: transfers that share pipes."""
    apps = _random_apps(np.random.default_rng(seed), 4, (2, 6), name="c")
    return apps, [float(7 * i) for i in range(len(apps))]


def _jax_inputs(jax_cluster, apps, arrivals, dtype):
    """``pivot_tpu``'s inputs; call inside the dtype's x64 scope."""
    jd = getattr(jnp, dtype)
    return (JE.EnsembleWorkload.from_applications(apps, arrivals=arrivals),
            JTopology.from_cluster(jax_cluster, jd),
            jnp.asarray(jax_cluster.availability_matrix(), dtype=jd),
            jnp.asarray(jax_cluster.storage_zone_vector()))


def _port_inputs(port_cluster, apps, arrivals, dtype):
    w = E.EnsembleWorkload.from_applications(_port_apps(apps),
                                             arrivals=arrivals, device="cpu")
    topo, a0, sz = _inputs(port_cluster, getattr(torch, dtype))
    return w, topo, a0, sz


def _jax_run(fn, jax_cluster, apps, arrivals, dtype, *args, seed=42,
             host_counts=None, **kw):
    """``fn(key, avail0, workload, topo, sz, *args, **kw)`` of
    ``pivot_tpu`` in ``dtype``'s config (``avail0`` its capacity grid
    with ``host_counts``); numpy results."""
    with jax.enable_x64(dtype == "float64"):
        jw, jtopo, ja0, jsz = _jax_inputs(jax_cluster, apps, arrivals, dtype)
        if host_counts is not None:
            ja0 = JE.capacity_grid(ja0, host_counts)
        res = fn(jax.random.PRNGKey(seed), ja0, jw, jtopo, jsz, *args, **kw)
        return [np.asarray(x) for x in res]


def assert_equal(got, want, dtype, what=""):
    for name, p, j in zip(E.RolloutResult._fields, got, want):
        p = p.numpy()
        assert p.shape == j.shape, (name, what)
        if name == "egress_cost":
            np.testing.assert_allclose(p, j, rtol=EGRESS_RTOL[dtype], atol=0,
                                       err_msg=f"{name} {what}")
        else:
            np.testing.assert_array_equal(p, j, err_msg=f"{name} {what}")


def _pair(clusters, dtype, seed=42, apps=None, **kw):
    jc, pc = clusters
    apps, arrivals = apps or _apps()
    want = _jax_run(JE.rollout, jc, apps, arrivals, dtype, seed=seed,
                    forms=kw.pop("forms", "indexed"), **kw)
    pw, ptopo, pa0, psz = _port_inputs(pc, apps, arrivals, dtype)
    got = E.rollout(prng.PRNGKey(seed), pa0, pw, ptopo, psz, **kw)
    return got, want


ROLL = dict(n_replicas=5, tick=5.0, max_ticks=128, perturb=0.1)


# -- parity with pivot_tpu ------------------------------------------------


@pytest.mark.parametrize("tick_order", ["fifo", "lifo"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_congestion_parity(clusters, dtype, policy, tick_order):
    got, want = _pair(clusters, dtype, policy=policy, tick_order=tick_order,
                      congestion=True, **ROLL)
    assert got.n_unfinished.max().item() == 0
    base, _ = _pair(clusters, dtype, policy=policy, tick_order=tick_order,
                    **ROLL)
    # The pipes did delay something: the model is engaged.
    assert not torch.equal(base.finish_time, got.finish_time)
    assert_equal(got, want, dtype)


def test_congestion_parity_vector_form(clusters):
    """``pivot_tpu``'s one-hot ``"vector"`` tick body, whose pipe sums run
    as HIGHEST-precision matmuls, gives the same bits here too."""
    got, want = _pair(clusters, "float64", forms="vector", congestion=True,
                      **ROLL)
    assert_equal(got, want, "float64")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_pairs_parity(clusters, dtype, policy):
    got, want = _pair(clusters, dtype, policy=policy, congestion="pairs",
                      tick_order="lifo", **ROLL)
    assert got.n_unfinished.max().item() == 0
    assert_equal(got, want, dtype)


@pytest.mark.parametrize("tick_order", ["fifo", "lifo"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_realtime_parity(clusters, dtype, tick_order):
    got, want = _pair(clusters, dtype, congestion=True, tick_order=tick_order,
                      realtime_scoring=True, **ROLL)
    assert got.n_unfinished.max().item() == 0
    assert_equal(got, want, dtype)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_congestion_with_faults_parity(clusters, dtype, policy):
    """A crash empties the struck host's inbound pipes."""
    got, want = _pair(clusters, dtype, seed=5, policy=policy,
                      congestion=True, n_faults=3, fault_horizon=80.0,
                      mttr=30.0, **ROLL)
    assert_equal(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pairs_with_faults_parity(clusters, dtype):
    """Host-pair rows also drop the struck host's outbound pipes."""
    got, want = _pair(clusters, dtype, seed=6, congestion="pairs",
                      n_faults=3, fault_horizon=80.0, **ROLL)
    assert_equal(got, want, dtype)


def _sweep_pair(clusters, dtype, jfn, pfn, *args, host_counts=None, **kw):
    jc, pc = clusters
    apps, arrivals = _apps()
    want = _jax_run(jfn, jc, apps, arrivals, dtype, *args, seed=9,
                    host_counts=host_counts, forms="indexed", **kw)
    pw, ptopo, pa0, psz = _port_inputs(pc, apps, arrivals, dtype)
    if host_counts is not None:
        pa0 = E.capacity_grid(pa0, host_counts)
    got = pfn(prng.PRNGKey(9), pa0, pw, ptopo, psz, *args, **kw)
    return got, want


SWEEP = dict(n_replicas=3, tick=5.0, max_ticks=128, perturb=0.1)


@pytest.mark.parametrize("realtime", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_capacity_sweep_congestion_parity(clusters, dtype, realtime):
    got, want = _sweep_pair(clusters, dtype, JE.capacity_sweep,
                            E.capacity_sweep, host_counts=[3, 8],
                            congestion=True,
                            realtime_scoring=realtime, segment_ticks=7,
                            **SWEEP)
    assert got.makespan.shape == (2, 3)
    assert_equal(got, want, dtype)


@pytest.mark.parametrize("policy", ["first-fit", "cost-aware"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_workload_sweep_congestion_parity(clusters, dtype, policy):
    got, want = _sweep_pair(clusters, dtype, JE.workload_sweep,
                            E.workload_sweep, [1, 3, 4], policy=policy,
                            congestion=True, **SWEEP)
    assert got.makespan.shape == (3, 3)
    assert_equal(got, want, dtype)


def test_score_param_sweep_congestion_parity(clusters):
    grid = np.array([[1.0, 1.0, 1.0], [0.5, 2.0, 1.0]])
    got, want = _sweep_pair(clusters, "float64", JE.score_param_sweep,
                            E.score_param_sweep, grid,
                            congestion=True, **SWEEP)
    assert_equal(got, want, "float64")


# -- the pull-volume product and the drain ---------------------------------


def _trace_pair(n_apps=10, n_hosts=600):
    """The ``ensemble`` defaults' float32 inputs (trace window, 600-host
    cluster) on both sides."""
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
    jres = jcal.ensemble_inputs_from_schedule(
        jload(trace, ja.scale_factor).take(n_apps),
        jcli.build_cluster(jcli._cluster_config(ja)))
    pres = pcal.ensemble_inputs_from_schedule(
        pload(trace, pa.scale_factor).take(n_apps),
        pcli.build_cluster(pcli._cluster_config(pa)), device="cpu")
    return jres, pres


_xla_pull = jax.jit(jax.vmap(lambda c, pf: pf @ c, in_axes=(0, None)))


def xla_pull_volumes(pull_frac, counts):
    """XLA:CPU's own batched product, as ``pivot_tpu``'s vmapped tick body
    forms it (an unbatched ``[G, G]`` table against ``[R, G, S]``)."""
    return torch.from_numpy(np.array(_xla_pull(
        jnp.asarray(counts.numpy()), jnp.asarray(pull_frac.numpy()))))


@pytest.fixture(scope="module")
def trace_pair_f32():
    """:func:`_trace_pair`'s float32 inputs, built once for both cases
    of the trace test."""
    with jax.enable_x64(False):
        return _trace_pair()


@pytest.mark.parametrize("realtime", [False, True])
def test_trace_congestion_bitwise_with_xla_product(monkeypatch, realtime,
                                                   trace_pair_f32):
    """With XLA's product in ``_pull_volumes``, every output field of the
    port equals ``pivot_tpu``'s on the trace (float32, 600 hosts, 10
    apps, the calibrate order lifo), egress within rtol 1e-5."""
    monkeypatch.setattr(ptick, "_pull_volumes", xla_pull_volumes)
    kw = dict(n_replicas=2, tick=5.0, max_ticks=2048, perturb=0.1,
              tick_order="lifo", congestion=True,
              realtime_scoring=realtime)
    (jw, _s, _a, jtopo, ja0, jsz), (pw, _ps, _pa, ptopo, pa0, psz) = \
        trace_pair_f32
    want = []

    def reference():
        # XLA runs pivot_tpu's rollout beside the port's (its own thread:
        # the x64 switch is per thread).
        with jax.enable_x64(False):
            want.extend(np.asarray(x) for x in JE.rollout(
                jax.random.PRNGKey(0), ja0, jw, jtopo, jsz,
                forms="indexed", **kw))

    side = threading.Thread(target=reference)
    side.start()
    try:
        with jax.enable_x64(False):  # XLA's product in the port's ticks
            got = E.rollout(prng.PRNGKey(0), pa0, pw, ptopo, psz, **kw)
    finally:
        side.join(timeout=300)
    assert not side.is_alive() and want
    assert got.n_unfinished.max().item() == 0
    assert_equal(got, want, "float32")


def test_pull_product_differs_from_xla_by_one_rounding():
    """On the trace's own pull table (50 apps: 283 groups, rows of 0-6
    predecessors) against done counts drawn like a tick's, torch's
    product and XLA:CPU's differ in a few entries, by at most one
    rounding of the float32 result (ROADMAP.md Queue 3 records the
    size)."""
    from pivot_tpu_torch.parallel.ensemble.bill import _sampling_table

    _j, (pw, *_rest) = _trace_pair(50)
    inst, samp = _sampling_table(pw)
    pull_frac = pw.pred_group * samp * (pw.out_group / inst)[None, :]
    G = pull_frac.shape[0]
    rng = np.random.default_rng(0)
    counts = torch.from_numpy(rng.integers(0, 4, (8, G, 31)).astype(
        np.float32))
    got = ptick._pull_volumes(pull_frac, counts).numpy()
    with jax.enable_x64(False):
        want = xla_pull_volumes(pull_frac, counts).numpy()
    diff = got != want
    rel = np.abs(got[diff].astype(np.float64) - want[diff]) / np.abs(
        want[diff])
    assert diff.sum() < 0.05 * (want != 0).sum()
    assert rel.max(initial=0.0) <= 2.0 ** -23


@pytest.mark.parametrize("dtype", DTYPES)
def test_drain_is_one_fused_multiply_add(dtype):
    """XLA:CPU computes the jitted drain ``max(q − bw · tick, 0)`` with one
    rounding; the port's pipe step gives its bits on 200,000 values near
    the cancellation, where rounding twice differs."""
    rng = np.random.default_rng(0)
    bw = rng.uniform(1.0, 2e4, (1, 400, 500)).astype(dtype)
    q = (bw * 5.0 * rng.uniform(0.5, 2.0, bw.shape)).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(jax.jit(
            lambda q, bw: jnp.maximum(q - bw[0] * 5.0, 0.0))(q, bw))
    td = getattr(torch, dtype)
    tq, tbw = torch.from_numpy(q), torch.from_numpy(bw[0])
    empty = torch.zeros((1, 0), dtype=torch.int64)
    got, cong = ptick._pipe_step(
        tq, torch.zeros((1, 0, 400), dtype=td), empty, empty.bool(),
        torch.where(tbw > 0, 1.0 / tbw, 0.0), -tbw,
        torch.tensor(5.0, dtype=td))
    assert cong.shape == (1, 0)
    np.testing.assert_array_equal(got.numpy(), want)
    twice = np.maximum(q - bw[0] * np.asarray(5.0, dtype), 0.0)
    assert (twice != want).sum() > 0


# -- tests/test_ensemble.py's cases on the port -----------------------------


def _run(pc, apps, seed, arrivals=None, **kw):
    w = E.EnsembleWorkload.from_applications(apps, arrivals=arrivals,
                                             device="cpu")
    topo, a0, sz = _inputs(pc)
    return E.rollout(prng.PRNGKey(seed), a0, w, topo, sz, **kw)


def test_congestion_noop_without_transfers(clusters):
    kw = dict(n_replicas=4, tick=5.0, max_ticks=64, perturb=0.1)
    base = _run(clusters[1], [chain_app()], 7, **kw)
    cong = _run(clusters[1], [chain_app()], 7, congestion=True, **kw)
    for f in ("makespan", "placement", "instance_hours"):
        assert torch.equal(getattr(base, f), getattr(cong, f)), f


def test_congestion_slows_contended_fanout(clusters):
    app = Application("fan", [
        TaskGroup("src", cpus=1, mem=256, runtime=5, output_size=40000),
        TaskGroup("snk", cpus=1, mem=256, runtime=5, instances=16,
                  dependencies=["src"]),
    ])
    kw = dict(n_replicas=2, tick=5.0, max_ticks=256, perturb=0.0,
              policy="first-fit")
    base = _run(clusters[1], [app], 8, **kw)
    cong = _run(clusters[1], [app], 8, congestion=True, **kw)
    assert cong.n_unfinished.max().item() == 0
    assert (cong.makespan > base.makespan).all()
    assert torch.equal(base.placement, cong.placement)


def test_congestion_delay_hand_computed(clusters):
    """Two 16-cpu consumers land on separate hosts, each with its own
    pipe carrying one full pull: congested equals static."""
    app = Application("h", [
        TaskGroup("a", cpus=1, mem=256, runtime=5, output_size=30000.0),
        TaskGroup("b", cpus=16, mem=256, runtime=5, instances=2,
                  dependencies=["a"]),
    ])
    kw = dict(n_replicas=1, tick=5.0, max_ticks=128, perturb=0.0,
              policy="first-fit")
    base = _run(clusters[1], [app], 9, **kw)
    cong = _run(clusters[1], [app], 9, congestion=True, **kw)
    assert cong.n_unfinished.max().item() == 0
    assert cong.makespan[0].item() == pytest.approx(base.makespan[0].item())


def test_congestion_ignores_zero_output_predecessors(clusters):
    app = Application("mix", [
        TaskGroup("a", cpus=1, mem=256, runtime=5, output_size=40000),
        TaskGroup("b", cpus=1, mem=256, runtime=5, instances=8,
                  dependencies=["a"]),
        TaskGroup("z", cpus=1, mem=256, runtime=5, output_size=0),
        TaskGroup("y", cpus=1, mem=256, runtime=5, dependencies=["z"]),
    ])
    kw = dict(n_replicas=2, tick=5.0, max_ticks=256, perturb=0.0,
              policy="first-fit")
    base = _run(clusters[1], [app], 12, **kw)
    cong = _run(clusters[1], [app], 12, congestion=True, **kw)
    assert cong.n_unfinished.max().item() == 0
    ft_b, ft_c = base.finish_time.numpy(), cong.finish_time.numpy()
    assert np.array_equal(ft_b[:, -1], ft_c[:, -1])
    assert (ft_c[:, 1:9] > ft_b[:, 1:9]).any()


def _meta_cluster(zone_of):
    meta = ResourceMetadata(seed=0, jitter=False)
    env = Environment()
    hosts = [Host(env, 16, 1 << 17, 100, 4, locality=meta.zones[z])
             for z in zone_of]
    storage = [Storage(env, z)
               for z in dict.fromkeys(h.locality for h in hosts)]
    return Cluster(env, hosts=hosts, storage=storage, meta=meta,
                   route_mode="meta", seed=0)


def test_congestion_pairs_equals_zone_on_singleton_zones():
    """One host per zone: the host-pair pipes are the zone pipes."""
    pc = _meta_cluster(range(5))
    app = Application("p", [
        TaskGroup("a", cpus=1, mem=64, runtime=30, output_size=500,
                  instances=6),
        TaskGroup("b", cpus=2, mem=128, runtime=20, dependencies=["a"],
                  instances=4),
    ])
    kw = dict(n_replicas=4, tick=5.0, max_ticks=64, perturb=0.1)
    rz = _run(pc, [app], 0, congestion=True, **kw)
    rp = _run(pc, [app], 0, congestion="pairs", **kw)
    for f in ("makespan", "placement", "finish_time", "egress_cost",
              "instance_hours"):
        assert torch.equal(getattr(rz, f), getattr(rp, f)), f


def test_congestion_pairs_splits_same_zone_sources():
    """Two producers on two hosts of one zone feed one consumer: the
    zone pipe adds both volumes, the host pipes drain them side by side,
    so the host-pair transfer completes strictly earlier."""
    pc = _meta_cluster([0, 0, 1])
    app = Application("split", [
        TaskGroup("a", cpus=16, mem=256, runtime=5, output_size=30000,
                  instances=2),
        TaskGroup("b", cpus=16, mem=256, runtime=5, dependencies=["a"]),
    ])
    kw = dict(n_replicas=1, tick=5.0, max_ticks=256, perturb=0.0,
              policy="first-fit")
    rz = _run(pc, [app], 1, congestion=True, **kw)
    rp = _run(pc, [app], 1, congestion="pairs", **kw)
    assert rz.n_unfinished.max().item() == 0
    assert rp.n_unfinished.max().item() == 0
    assert torch.equal(rz.placement, rp.placement)
    assert rp.makespan[0] < rz.makespan[0]


def test_congestion_pairs_rejected_by_sweeps(clusters):
    w = E.EnsembleWorkload.from_applications([chain_app()], device="cpu")
    topo, a0, sz = _inputs(clusters[1])
    with pytest.raises(ValueError, match="host-pair"):
        E.workload_sweep(prng.PRNGKey(0), a0, w, topo, sz, app_counts=[1],
                         n_replicas=2, congestion="pairs")


def test_realtime_scoring_steers_around_backlog(clusters):
    """Backlog on the winner's inbound pipe flips the cost-aware choice;
    empty pipes change nothing; no congestion state, no realtime."""
    pc = clusters[1]
    app = Application("rts", [TaskGroup("g", cpus=1, mem=256, runtime=5,
                                        output_size=10)])
    w = E.EnsembleWorkload.from_applications([app], device="cpu")
    topo, a0, sz = _inputs(pc)
    Z = topo.cost.shape[0]
    rt = torch.tensor([[5.0]])
    arr = torch.tensor([[0.0]])
    ra = torch.tensor([[10]])  # a zone with no hosts: all cross-zone

    def two_ticks(state):
        return E._rollout_segment(state, rt, arr, ra, w, topo, 5.0, 2,
                                  policy="cost-aware", congestion=True,
                                  realtime_scoring=True)

    state0 = E._init_state(a0, 1, Z, 1, congestion=True)
    h_free = int(two_ticks(state0).place[0, 0])
    assert h_free >= 0
    q = state0.q.clone()
    q[0, 10, h_free] = 1e9
    h_steered = int(two_ticks(state0._replace(q=q)).place[0, 0])
    assert h_steered >= 0 and h_steered != h_free

    kw = dict(n_replicas=2, tick=5.0, max_ticks=64, perturb=0.0)
    a = _run(pc, [chain_app()], 18, congestion=True, **kw)
    b = _run(pc, [chain_app()], 18, congestion=True, realtime_scoring=True,
             **kw)
    assert torch.equal(a.placement, b.placement)
    with pytest.raises(ValueError):
        _run(pc, [chain_app()], 18, realtime_scoring=True, **kw)


@pytest.mark.parametrize("option", [
    dict(policy="first-fit", congestion=True, realtime_scoring=True),
    dict(congestion="pairs", realtime_scoring=True),
    dict(congestion="zones"),
])
def test_realtime_scoring_guards(clusters, option):
    """Non-cost-aware arms, host-pair pipes and unknown congestion modes
    raise ``pivot_tpu``'s ``ValueError``; so do realtime scoring with
    score exponents."""
    with pytest.raises(ValueError):
        _run(clusters[1], [chain_app()], 0, n_replicas=2, max_ticks=16,
             **option)
    w = E.EnsembleWorkload.from_applications([chain_app()], device="cpu")
    topo, a0, sz = _inputs(clusters[1])
    with pytest.raises(ValueError, match="mutually exclusive"):
        E._run_rows(a0.expand(2, -1, -1), torch.ones(2, 3),
                    torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.long),
                    w, topo, 5.0, 8, None, "cost-aware", True, True,
                    score_params=torch.ones(2, 3))


def test_congestion_state_shapes(clusters):
    """``q`` is ``[R, Z, H]`` zone pipes, ``[R, H, H]`` host pipes, None
    without the model (``pivot_tpu``'s ``state.py:215-231``)."""
    topo, a0, _ = _inputs(clusters[1])
    Z, H = topo.cost.shape[0], a0.shape[0]
    assert E._init_state(a0, 3, Z, 2, congestion=True).q.shape == (2, Z, H)
    assert E._init_state(a0, 3, Z, 2, congestion="pairs").q.shape == \
        (2, H, H)
    assert E._init_state(a0, 3, Z, 2).q is None
