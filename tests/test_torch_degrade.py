"""The degrade guard of the port's device policies (``degrade_after``).

``pivot_tpu_torch/sched/cuda.py::_DegradeGuard`` against
``pivot_tpu/sched/tpu.py::_DegradeGuard``:

  * the three cases of ``tests/test_chaos.py`` (degradation to the
    numpy twin, the guard off keeping a kernel fault fatal, the
    half-open probe promoting the device back) on the port;
  * one fault schedule — a fixed list of device-call numbers that raise
    — through ``pivot_tpu``'s guard (its device policy in float64) and
    the port's (torch on the CPU in float64): ``kernel_failures``,
    ``probes``, ``promotions``, the ``degraded`` flag after every tick
    and every task's placement equal, for each of the four arms;
  * ``span_capable()`` False while degraded, True again after the
    promotion;
  * a policy on the card refusing the guard: its kernel failures are
    never moved to the CPU twin.
"""

import jax.numpy as jnp
import pytest
import torch

from pivot_tpu_torch.des import Environment
from pivot_tpu_torch.infra import Cluster, Host, Storage
from pivot_tpu_torch.infra.locality import ResourceMetadata
from pivot_tpu_torch.infra.meter import Meter
from pivot_tpu_torch.sched import GlobalScheduler
from pivot_tpu_torch.sched import cuda as pcuda
from pivot_tpu_torch.utils import reset_ids
from pivot_tpu_torch.workload import Application, TaskGroup

INTERVAL = 5


@pytest.fixture(scope="module")
def meta():
    return ResourceMetadata(seed=0)


def build(meta, host_shapes, seed=0, policy=None, pkg=None):
    """``tests/test_chaos.py::build`` over either package's layers."""
    if pkg is None:
        env_cls, meter_cls, host_cls, storage_cls, cluster_cls, sched_cls = (
            Environment, Meter, Host, Storage, Cluster, GlobalScheduler)
    else:
        env_cls, meter_cls, host_cls, storage_cls, cluster_cls, sched_cls = pkg
    env = env_cls()
    meter = meter_cls(env, meta)
    zones = meta.zones
    hosts = [
        host_cls(env, *shape, locality=zones[i % len(zones)], meter=meter)
        for i, shape in enumerate(host_shapes)
    ]
    storage = [storage_cls(env, z)
               for z in dict.fromkeys(h.locality for h in hosts)]
    cluster = cluster_cls(
        env, hosts=hosts, storage=storage, meta=meta, meter=meter,
        route_mode="meta", seed=seed,
    )
    scheduler = sched_cls(env, cluster, policy, interval=INTERVAL,
                          seed=seed, meter=meter)
    cluster.start()
    scheduler.start()
    return env, cluster, scheduler


def port_policy(cls=pcuda.CudaFirstFitPolicy, **kw):
    p = cls(adaptive=False, device="cpu", **kw)
    p.dtype = torch.float64
    return p


# -- the three cases of tests/test_chaos.py ---------------------------------


def test_device_kernel_degradation_to_cpu_twin(meta):
    """After ``degrade_after`` consecutive device-kernel failures the
    policy serves every tick from its numpy twin: placements stay
    valid, the run completes, the failure counters are visible."""
    policy = port_policy(degrade_after=2)
    boom = {"left": 3}
    orig = policy._device_place

    def flaky(ctx):
        if boom["left"] > 0:
            boom["left"] -= 1
            raise RuntimeError("injected kernel fault")
        return orig(ctx)

    policy._device_place = flaky
    env, cluster, sched = build(meta, [(4, 4096, 10, 0)] * 2, policy=policy)
    app = Application(
        "deg",
        [
            TaskGroup("g1", cpus=1, mem=256, runtime=10),
            TaskGroup("g2", cpus=1, mem=256, runtime=10,
                      dependencies=["g1"]),
            TaskGroup("g3", cpus=1, mem=256, runtime=10,
                      dependencies=["g2"]),
        ],
    )
    sched.submit(app)
    sched.stop()
    env.run()
    assert app.is_finished
    assert policy.degraded
    assert policy.kernel_failures == 2  # degraded at the 2nd consecutive
    assert boom["left"] == 1  # twin serves everything after degradation
    for group in app.groups:
        assert all(t.placement is not None for t in group.tasks)
    assert (policy._degrade.probes, policy._degrade.promotions) == (0, 0)
    assert policy.dispatch_stats()["twin_ticks"] == 3  # 2 failed + 1 degraded


def test_degradation_disabled_raises(meta):
    """``degrade_after=None`` (the default) keeps kernel faults fatal."""
    policy = port_policy()
    assert policy.degrade_after is None

    def flaky(ctx):
        raise RuntimeError("injected kernel fault")

    policy._device_place = flaky
    env, cluster, sched = build(meta, [(4, 4096, 10, 0)], policy=policy)
    app = Application("f", [TaskGroup("g", cpus=1, mem=256, runtime=5)])
    sched.submit(app)
    sched.stop()
    with pytest.raises(RuntimeError, match="injected kernel fault"):
        env.run()
    assert policy.kernel_failures == 0 and not policy.degraded


def test_degradation_half_open_promotes_device_back(meta):
    """A TRANSIENT device fault degrades the policy to its twin; once
    the device heals, a half-open probe (shadow-run, diffed against the
    twin, never served) matches and promotes the device back.

    Timeline with ``degrade_after=2``, ``probe_every=2`` and a fault
    that clears after 3 device calls: fail, fail (degrade), twin, twin +
    probe (raises), twin, twin + probe (matches — promote), device."""
    policy = port_policy(degrade_after=2)
    policy._degrade.probe_every = 2
    boom = {"left": 3}
    served = {"device": 0}
    orig = policy._device_place

    def flaky(ctx):
        if boom["left"] > 0:
            boom["left"] -= 1
            raise RuntimeError("injected transient fault")
        out = orig(ctx)
        served["device"] += 1
        return out

    policy._device_place = flaky
    env, cluster, sched = build(meta, [(4, 4096, 10, 0)] * 2, policy=policy)
    groups = [TaskGroup("g1", cpus=1, mem=256, runtime=10)]
    for i in range(2, 8):  # 7 chained groups => 7 placement ticks
        groups.append(TaskGroup(f"g{i}", cpus=1, mem=256, runtime=10,
                                dependencies=[f"g{i - 1}"]))
    app = Application("halfopen", list(groups))
    sched.submit(app)
    sched.stop()
    env.run()
    assert app.is_finished
    guard = policy._degrade
    assert not policy.degraded  # promoted back, not stranded on the CPU
    assert guard.probes == 2  # one raised, one matched
    assert guard.promotions == 1
    assert boom["left"] == 0
    assert served["device"] >= 2
    for group in app.groups:
        assert all(t.placement is not None for t in group.tasks)


# -- one fault schedule through both packages' guards -----------------------

#: Device calls that raise (0-based, counting probes): two failures
#: degrade, the first probe raises, the second promotes; two more
#: failures degrade again and a probe promotes again.
FAILING = frozenset({0, 1, 2, 6, 7})
ARMS = {
    "opportunistic": ("CudaOpportunisticPolicy", "TpuOpportunisticPolicy",
                      {}),
    "first-fit": ("CudaFirstFitPolicy", "TpuFirstFitPolicy",
                  {"decreasing": True}),
    "best-fit": ("CudaBestFitPolicy", "TpuBestFitPolicy", {}),
    "cost-aware": ("CudaCostAwarePolicy", "TpuCostAwarePolicy",
                   {"bin_pack": "first-fit", "sort_tasks": True,
                    "sort_hosts": True}),
}


def _faulty(policy, log):
    """Wrap ``policy``'s device dispatch to raise on the calls in
    :data:`FAILING`, and its ``place`` to log the guard after every
    tick."""
    orig_device, orig_place = policy._device_place, policy.place
    calls = {"n": 0}

    def device_place(ctx):
        n = calls["n"]
        calls["n"] += 1
        if n in FAILING:
            raise RuntimeError(f"injected kernel fault at call {n}")
        return orig_device(ctx)

    def place(ctx):
        out = orig_place(ctx)
        log.append(bool(policy.degraded))
        return out

    policy._device_place = device_place
    policy.place = place
    return calls


def _chained_app(app_mod, n_groups=14):
    groups = [app_mod.TaskGroup("g1", cpus=1, mem=256, runtime=10,
                                instances=3)]
    for i in range(2, n_groups + 1):
        groups.append(app_mod.TaskGroup(
            f"g{i}", cpus=1 + i % 3, mem=256 * (1 + i % 2), runtime=10,
            instances=2 + i % 3, dependencies=[f"g{i - 1}"]))
    return app_mod.Application("sched", groups)


def _run(meta, policy, pkg, app_mod):
    log: list = []
    calls = _faulty(policy, log)
    env, cluster, sched = build(meta, [(4, 4096, 10, 1)] * 3 + [
        (8, 8192, 10, 1)] * 2, policy=policy, pkg=pkg)
    app = _chained_app(app_mod)
    sched.submit(app)
    sched.stop()
    env.run()
    assert app.is_finished
    placements = [(t.id, t.placement) for g in app.groups for t in g.tasks]
    g = policy._degrade
    return dict(failures=g.kernel_failures, probes=g.probes,
                promotions=g.promotions, degraded=log,
                device_calls=calls["n"], placements=placements)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_fault_schedule_matches_reference_guard(meta, monkeypatch, arm):
    """The same fault schedule through ``pivot_tpu``'s guard (float64
    device policy) and the port's (torch on the CPU, float64): equal
    failure, probe and promotion counts, the same ``degraded`` flag
    after every tick, the same device calls and the same placement for
    every task."""
    import pivot_tpu.workload as jworkload
    from pivot_tpu import des as jdes
    from pivot_tpu import infra as jinfra
    from pivot_tpu.infra import meter as jmeter
    from pivot_tpu.sched import GlobalScheduler as JScheduler
    from pivot_tpu.sched import tpu as jtpu
    from pivot_tpu.utils import reset_ids as jreset_ids

    import pivot_tpu_torch.workload as pworkload

    monkeypatch.setattr(jtpu._DevicePolicyBase, "dtype", jnp.float64)
    port_cls, ref_cls, kw = ARMS[arm]
    jreset_ids()
    ref = getattr(jtpu, ref_cls)(adaptive=False, degrade_after=2, **kw)
    ref._degrade.probe_every = 2
    want = _run(meta, ref, (jdes.Environment, jmeter.Meter, jinfra.Host,
                            jinfra.Storage, jinfra.Cluster, JScheduler),
                jworkload)
    reset_ids()
    port = port_policy(getattr(pcuda, port_cls), degrade_after=2, **kw)
    port._degrade.probe_every = 2
    got = _run(meta, port, None, pworkload)
    # Best-fit's device pass and its numpy twin place differently on
    # this workload in BOTH packages, so its probes diverge and never
    # promote; the other arms promote after each outage.
    assert want["promotions"] == (0 if arm == "best-fit" else 2)
    assert want["probes"] >= 3 and want["failures"] >= 2
    assert got == want


def test_span_capable_follows_the_guard(meta):
    """A degraded policy declines spans (its twin serves per tick); the
    promotion makes it span-capable again."""
    policy = port_policy(degrade_after=1)
    policy._degrade.probe_every = 1
    assert policy.span_capable()
    policy._degrade.note_failure(RuntimeError("x"), policy.logger)
    assert policy.degraded and not policy.span_capable()
    assert policy._degrade.should_probe()
    policy._degrade.note_probe(True, policy.logger)
    assert not policy.degraded and policy.span_capable()
    assert (policy.kernel_failures, policy._degrade.promotions) == (1, 1)


@pytest.mark.parametrize("cls", [pcuda.CudaOpportunisticPolicy,
                                 pcuda.CudaFirstFitPolicy,
                                 pcuda.CudaBestFitPolicy,
                                 pcuda.CudaCostAwarePolicy])
def test_card_policy_refuses_the_guard(monkeypatch, cls):
    """On a ``cuda`` policy ``degrade_after`` raises, at construction and
    through the setter; ``None`` stays accepted.  (The card's device is
    named without a card: the constructor allocates nothing.)"""
    monkeypatch.setattr(pcuda, "resolve_device", torch.device)
    with pytest.raises(NotImplementedError, match="never moves a card"):
        cls(adaptive=False, device="cuda", degrade_after=2)
    policy = cls(adaptive=False, device="cuda")
    assert policy.device.type == "cuda" and policy.degrade_after is None
    with pytest.raises(NotImplementedError, match="the CPU twin"):
        policy.degrade_after = 1
    policy.degrade_after = None
    assert policy.degrade_after is None and not policy.degraded
