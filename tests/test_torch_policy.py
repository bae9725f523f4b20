"""The port's device policies vs ``pivot_tpu``'s and vs the numpy policies.

``pivot_tpu_torch.sched.cuda.Cuda*Policy`` on the CPU in float64 against
``pivot_tpu.sched.tpu.Tpu*Policy`` under x64 (conftest enables it) and
against the numpy policies of both packages, on the ``make_ctx`` tick
contexts of ``tests/test_policies.py`` (built twice: once from each
package's own classes, from the same seeds).  Placements must be
bitwise equal — the port keeps the reference's task order, tie rule and
arithmetic.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pivot_tpu.infra.locality import ResourceMetadata as JMeta
from pivot_tpu.ops.kernels import DeviceTopology as JTopology
from pivot_tpu.sched import policies as jpol
from pivot_tpu.sched.tpu import (
    TpuBestFitPolicy,
    TpuCostAwarePolicy,
    TpuFirstFitPolicy,
    TpuOpportunisticPolicy,
)
from pivot_tpu_torch.des import Environment as PEnv
from pivot_tpu_torch.infra import Cluster as PCluster
from pivot_tpu_torch.infra import Host as PHost
from pivot_tpu_torch.infra import Storage as PStorage
from pivot_tpu_torch.infra.locality import ResourceMetadata as PMeta
from pivot_tpu_torch.ops import cuda_kernels as ck
from pivot_tpu_torch.ops.kernels import DeviceTopology as PTopology
from pivot_tpu_torch.ops.kernels import topology_from_numpy
from pivot_tpu_torch.sched import GlobalScheduler as PScheduler
from pivot_tpu_torch.sched import TickContext as PContext
from pivot_tpu_torch.sched import cuda as pcuda
from pivot_tpu_torch.sched import policies as ppol
from pivot_tpu_torch.workload import Application as PApp
from pivot_tpu_torch.workload import TaskGroup as PGroup
from pivot_tpu_torch.utils.config import PolicyConfig, make_policy

from tests.test_kernels import random_groups
from tests.test_policies import SHAPES, make_ctx


@pytest.fixture(scope="module")
def metas():
    return JMeta(seed=0), PMeta(seed=0)


@pytest.fixture(autouse=True)
def _reset_port_ids():
    from pivot_tpu_torch.utils import reset_ids

    reset_ids()
    yield


def port_make_ctx(meta, shapes, groups, seed=0, placements=None):
    """``tests/test_policies.py::make_ctx`` built from the port's classes."""
    env = PEnv()
    zones = meta.zones
    hosts = [PHost(env, *shape, locality=zones[i % len(zones)])
             for i, shape in enumerate(shapes)]
    storage = [PStorage(env, z)
               for z in dict.fromkeys(h.locality for h in hosts)]
    cluster = PCluster(env, hosts=hosts, storage=storage, meta=meta,
                       route_mode="meta", seed=seed)
    app = PApp("app", groups)
    tasks = []
    for g in app.groups:
        tasks.extend(g.materialize_tasks())
    if placements:
        for t in tasks:
            if t.id in placements:
                t.placement = placements[t.id]
                t.set_finished()
    ready = [t for t in tasks if t.is_nascent]
    scheduler = PScheduler(env, cluster, ppol.FirstFitPolicy(), seed=seed)
    return PContext(scheduler, ready, tick_seq=0)


def port_groups(jax_groups):
    """The port's TaskGroups with the fields of ``pivot_tpu`` ones."""
    return [
        PGroup(g.id, cpus=g.cpus, mem=g.mem, disk=g.disk, gpus=g.gpus,
               runtime=g.runtime, output_size=g.output_size,
               instances=g.instances, dependencies=list(g.dependencies))
        for g in jax_groups
    ]


def ctx_pair(metas, groups_fn, seed, shapes=None, placements=None):
    """The same tick context in both packages, host ids aligned."""
    from pivot_tpu.utils import reset_ids as jreset
    from pivot_tpu_torch.utils import reset_ids as preset

    shapes = shapes or SHAPES * 4
    jreset()
    preset()
    jctx = make_ctx(metas[0], shapes, groups_fn(), seed,
                    placements=placements)
    pctx = port_make_ctx(metas[1], shapes, port_groups(groups_fn()), seed,
                         placements=placements)
    return jctx, pctx


def place_all(metas, jax_np, jax_dev, port_np, port_dev, groups_fn, seed,
              **kw):
    """Placements (and visit orders) of the four policies on one tick."""
    out = []
    for pol, side, bind in ((jax_np, 0, False), (jax_dev, 0, True),
                            (port_np, 1, False), (port_dev, 1, True)):
        ctx = ctx_pair(metas, groups_fn, seed, **kw)[side]
        if bind:
            pol.bind(ctx.scheduler)
        out.append((np.asarray(pol.place(ctx)).tolist(), ctx.visit_order))
    return out


def assert_all_equal(results):
    ref = results[0]
    for r in results[1:]:
        assert r == ref, (ref, r)


def port_dev(cls, **kw):
    pol = cls(device="cpu", **kw)
    pol.dtype = torch.float64
    return pol


def jax_dev(cls, **kw):
    pol = cls(**kw)
    pol.dtype = jnp.float64
    return pol


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_opportunistic_policy_parity(metas, seed):
    assert_all_equal(place_all(
        metas, jpol.OpportunisticPolicy("numpy"),
        jax_dev(TpuOpportunisticPolicy),
        ppol.OpportunisticPolicy("numpy"),
        port_dev(pcuda.CudaOpportunisticPolicy), random_groups(seed), seed,
    ))


@pytest.mark.parametrize("decreasing", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_first_fit_policy_parity(metas, seed, decreasing):
    assert_all_equal(place_all(
        metas, jpol.FirstFitPolicy(decreasing=decreasing, mode="numpy"),
        jax_dev(TpuFirstFitPolicy, decreasing=decreasing),
        ppol.FirstFitPolicy(decreasing=decreasing, mode="numpy"),
        port_dev(pcuda.CudaFirstFitPolicy, decreasing=decreasing),
        random_groups(seed), seed,
    ))


@pytest.mark.parametrize("decreasing", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_best_fit_policy_parity(metas, seed, decreasing):
    assert_all_equal(place_all(
        metas, jpol.BestFitPolicy(decreasing=decreasing, mode="numpy"),
        jax_dev(TpuBestFitPolicy, decreasing=decreasing),
        ppol.BestFitPolicy(decreasing=decreasing, mode="numpy"),
        port_dev(pcuda.CudaBestFitPolicy, decreasing=decreasing),
        random_groups(seed), seed,
    ))


CA_KWARGS = [
    dict(sort_tasks=True, sort_hosts=True),
    dict(sort_tasks=False, sort_hosts=True),
    dict(sort_tasks=True, sort_hosts=False),
    dict(bin_pack="best-fit", sort_tasks=True),
    dict(sort_hosts=True, host_decay=True),
    dict(bin_pack="best-fit", host_decay=True),
]


@pytest.mark.parametrize("kwargs", CA_KWARGS)
@pytest.mark.parametrize("seed", [0, 5])
def test_cost_aware_policy_parity(metas, seed, kwargs):
    assert_all_equal(place_all(
        metas, jpol.CostAwarePolicy(mode="numpy", **kwargs),
        jax_dev(TpuCostAwarePolicy, **kwargs),
        ppol.CostAwarePolicy(mode="numpy", **kwargs),
        port_dev(pcuda.CudaCostAwarePolicy, **kwargs),
        random_groups(seed), seed,
    ))


@pytest.mark.parametrize("phase2", ["scan", "slim"])
def test_cost_aware_policy_parity_phase2_modes(metas, phase2):
    kw = dict(sort_tasks=True, sort_hosts=True)
    assert_all_equal(place_all(
        metas, jpol.CostAwarePolicy(mode="numpy", **kw),
        jax_dev(TpuCostAwarePolicy, phase2=phase2, **kw),
        ppol.CostAwarePolicy(mode="numpy", **kw),
        port_dev(pcuda.CudaCostAwarePolicy, phase2=phase2, **kw),
        random_groups(1), 1,
    ))


@pytest.mark.parametrize("kwargs", [CA_KWARGS[0], CA_KWARGS[5]])
def test_cost_aware_learned_exponent_parity(metas, kwargs):
    from pivot_tpu.search.weights import PolicyWeights as JW
    from pivot_tpu_torch.search.weights import PolicyWeights as PW

    w = dict(w_cost=1.7, w_bw=0.6, w_norm=1.4, risk_weight=0.5)
    assert_all_equal(place_all(
        metas, jpol.CostAwarePolicy(mode="numpy", weights=JW(**w), **kwargs),
        jax_dev(TpuCostAwarePolicy, weights=JW(**w), **kwargs),
        ppol.CostAwarePolicy(mode="numpy", weights=PW(**w), **kwargs),
        port_dev(pcuda.CudaCostAwarePolicy, weights=PW(**w), **kwargs),
        random_groups(2), 2,
    ))


def test_cost_aware_parity_with_placed_predecessors(metas):
    """Anchors from majority votes of placed predecessors."""
    from pivot_tpu.workload import TaskGroup as JGroup

    groups = [
        JGroup("src", cpus=1, mem=512, runtime=1, output_size=100,
               instances=5),
        JGroup("mid", cpus=1, mem=512, runtime=1, output_size=50,
               dependencies=["src"], instances=3),
        JGroup("dst", cpus=2, mem=1024, runtime=1, dependencies=["mid"]),
    ]
    placements = {"src/0": "host-1", "src/1": "host-1", "src/2": "host-2",
                  "src/3": "host-5", "src/4": "host-1",
                  "mid/0": "host-2", "mid/1": "host-2", "mid/2": "host-7"}
    kw = dict(sort_tasks=True, sort_hosts=True)
    assert_all_equal(place_all(
        metas, jpol.CostAwarePolicy(mode="numpy", **kw),
        jax_dev(TpuCostAwarePolicy, **kw),
        ppol.CostAwarePolicy(mode="numpy", **kw),
        port_dev(pcuda.CudaCostAwarePolicy, **kw),
        lambda: [g.clone() for g in groups], 2, shapes=SHAPES * 3,
        placements=placements,
    ))


def test_cost_aware_realtime_bw_with_queued_routes(metas):
    """Live route-queue bandwidth rows (``rt_bw_rows``) steer the port's
    torch form exactly as they steer the numpy policy."""
    groups_fn = random_groups(3)
    kw = dict(sort_tasks=True, sort_hosts=True, realtime_bw=True)
    out = []
    for pol, side in ((jpol.CostAwarePolicy(mode="numpy", **kw), 0),
                      (ppol.CostAwarePolicy(mode="numpy", **kw), 1),
                      (port_dev(pcuda.CudaCostAwarePolicy, **kw), 1)):
        ctx = ctx_pair(metas, groups_fn, 5)[side]
        for s in ctx.cluster.storage:
            for h in ctx.cluster.hosts[::2]:
                route = ctx.cluster.get_route(s.id, h.id)
                route.send(50 * route.bw, ctx.cluster.env.event())
                route.send(50 * route.bw, ctx.cluster.env.event())
        pol.bind(ctx.scheduler)
        out.append(np.asarray(pol.place(ctx)).tolist())
    assert out[0] == out[1] == out[2]
    static = ppol.CostAwarePolicy(mode="numpy", sort_tasks=True,
                                  sort_hosts=True)
    assert static.place(ctx_pair(metas, groups_fn, 5)[1]).tolist() != out[0]


def test_kernel_path_on_cpu_matches_torch_form(metas):
    """In float32 on CPU tensors, the kernel path (its wrapper runs the
    plain version) and the two-phase torch form place identically; the
    kernel path is counted in ``kernel_ticks`` and launches nothing."""
    ck.reset_launches()
    for kwargs in CA_KWARGS:
        got = []
        for use_kernel in (True, False):
            pol = pcuda.CudaCostAwarePolicy(device="cpu",
                                            use_kernel=use_kernel, **kwargs)
            ctx = ctx_pair(metas, random_groups(4), 4)[1]
            pol.bind(ctx.scheduler)
            got.append(pol.place(ctx).tolist())
            assert pol.dispatch_stats() == {
                "device_ticks": 1, "twin_ticks": 0,
                "kernel_ticks": int(use_kernel), "span_kernel_ticks": 0,
            }
        assert got[0] == got[1], kwargs
    assert ck.LAUNCHES["greedy_place"] == 0


def test_kernel_choice_rules():
    """The reference's auto rule and its explicit-override rejections."""
    from pivot_tpu_torch.search.weights import PolicyWeights

    assert not pcuda.CudaCostAwarePolicy(device="cpu")._kernel_serves()
    with pytest.raises(ValueError, match="live-bandwidth"):
        pcuda.CudaCostAwarePolicy(device="cpu", realtime_bw=True,
                                  use_kernel=True)
    w = PolicyWeights(w_cost=1.7, w_bw=0.6, w_norm=1.4)
    with pytest.raises(ValueError, match="exponent"):
        pcuda.CudaCostAwarePolicy(device="cpu", weights=w, use_kernel=True)
    pol = pcuda.CudaCostAwarePolicy(device="cpu", use_kernel=True)
    pol.dtype = torch.float64
    with pytest.raises(ValueError, match="float32"):
        pol._kernel_serves()
    with pytest.raises(ValueError, match="exponent"):
        pcuda.CudaCostAwarePolicy(device="cpu",
                                  use_kernel=True).apply_weights(w)


def test_topology_from_numpy_matches_from_cluster(metas):
    jctx, pctx = ctx_pair(metas, random_groups(0), 0)
    jt = JTopology.from_cluster(jctx.cluster, jnp.float64)
    via_numpy = topology_from_numpy(*(np.asarray(a) for a in jt),
                                    dtype=torch.float64, device="cpu")
    direct = PTopology.from_cluster(pctx.cluster, torch.float64, "cpu")
    for a, b, c in zip(jt, via_numpy, direct):
        assert b.dtype == c.dtype and b.device.type == "cpu"
        assert np.array_equal(np.asarray(a), b.numpy())
        assert torch.equal(b, c)
    assert via_numpy.host_zone.dtype == torch.int32
    assert via_numpy.n_hosts == len(pctx.hosts)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    for cls in (pcuda.CudaOpportunisticPolicy, pcuda.CudaFirstFitPolicy,
                pcuda.CudaBestFitPolicy, pcuda.CudaCostAwarePolicy):
        with pytest.raises(RuntimeError, match="cuda"):
            cls()
    with pytest.raises(RuntimeError, match="cuda"):
        make_policy(PolicyConfig(device="cuda"))
    pol = make_policy(PolicyConfig(device="cuda"), torch_device="cpu",
                      dtype="float64")
    assert pol.device.type == "cpu" and pol.dtype == torch.float64


def test_features_of_later_slices_raise(metas):
    """Spans and chunk commit are ported: the device policies are
    span-capable by the reference's rule and ``phase2=8`` is served.
    Batching, sharding, the resident carry, the fault gate and the
    profiler still raise."""
    pol = pcuda.CudaCostAwarePolicy(device="cpu")
    assert pol.span_capable()
    for cls in (pcuda.CudaOpportunisticPolicy, pcuda.CudaFirstFitPolicy,
                pcuda.CudaBestFitPolicy, pcuda.CudaCostAwarePolicy):
        assert cls(device="cpu").span_capable()
        assert not cls(device="cpu", adaptive=True).span_capable()
    assert not pcuda.CudaCostAwarePolicy(
        device="cpu", realtime_bw=True).span_capable()
    assert not pcuda.CudaCostAwarePolicy(
        device="cpu", use_kernel=True).span_capable()
    assert pcuda.CudaCostAwarePolicy(
        device="cpu", use_kernel=False).span_capable()
    for attach in (pol.enable_batching, pol.enable_sharding,
                   pol.enable_fault_gate, pol.enable_profiler):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            attach(None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pol.enable_resident()
    got = []
    for phase2 in (8, "slim"):
        ff = port_dev(pcuda.CudaFirstFitPolicy, phase2=phase2)
        ctx = ctx_pair(metas, random_groups(0), 0)[1]
        ff.bind(ctx.scheduler)
        got.append(ff.place(ctx).tolist())
    assert got[0] == got[1]
    assert any(h >= 0 for h in got[0])


def test_adaptive_small_tick_routes_to_numpy_twin(metas):
    """With a high device floor a small tick is served by the twin, and
    the placements are the numpy policy's."""
    kw = dict(sort_tasks=True, sort_hosts=True)
    pol = pcuda.CudaCostAwarePolicy(device="cpu", adaptive=True, **kw)
    ctx = ctx_pair(metas, random_groups(1), 1)[1]
    pol.bind(ctx.scheduler)
    assert pol._device_floor > 0.0
    pol._device_floor = 10.0
    got = pol.place(ctx).tolist()
    want = ppol.CostAwarePolicy(mode="numpy", **kw).place(
        ctx_pair(metas, random_groups(1), 1)[1]).tolist()
    assert got == want
    assert pol.dispatch_stats()["twin_ticks"] == 1


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_placement_sensitivity_parity(metas, dtype):
    """Monte-Carlo sensitivity: the same numpy noise draw through the
    port (float32: the replica-batched kernel's plain version; float64:
    the torch form per replica) and through ``pivot_tpu``'s policy."""
    kw = dict(sort_tasks=True, sort_hosts=True)
    jctx, pctx = ctx_pair(metas, random_groups(4), 4)
    jp = TpuCostAwarePolicy(**kw)
    pp = pcuda.CudaCostAwarePolicy(device="cpu",
                                   use_kernel=dtype == "float32", **kw)
    if dtype == "float64":
        jp.dtype, pp.dtype = jnp.float64, torch.float64
    jp.bind(jctx.scheduler)
    pp.bind(pctx.scheduler)
    ref = jp.placement_sensitivity(jctx, n_replicas=8, perturb=0.15, seed=1)
    got = pp.placement_sensitivity(pctx, n_replicas=8, perturb=0.15, seed=1)
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), b)
    assert np.any(got[1] < 1.0)
    with pytest.raises(ValueError):
        pcuda.CudaCostAwarePolicy(device="cpu", realtime_bw=True) \
            .placement_sensitivity(pctx)
