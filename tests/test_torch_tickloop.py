"""Fused tick spans: the port's ``ops/tickloop.py`` vs ``pivot_tpu``'s.

  * **driver parity** — the port's ``fused_tick_run`` on the CPU in
    float64 is bit-identical to ``pivot_tpu``'s under x64 and to the
    port's sequential ``reference_tick_run`` (placements, availability,
    ``n_ready[:ticks_run]``, ``n_placed``, ``ticks_run``,
    ``n_stack_final``, ``stackpos``) for the seven span configurations of
    ``tests/test_tickloop.py`` × ``phase2`` ∈ {scan, slim, 8}; K ∈ {1, 4}
    in tier 1, K ∈ {8, 16} slow;
  * **the kernel-served Cost-Aware span** — in float32 with the hand
    kernel's wrapper (its plain version on CPU tensors) against the same
    span through ``cost_aware_impl``;
  * **no host reads inside a span** — with every tensor→host path
    patched to raise, the carry-free arms (slim) and the Cost-Aware arm
    through a stub launch run whole spans;
  * **DES parity** — the chain-workload simulation of
    ``tests/test_tickloop.py`` built from the port's own modules with
    ``Cuda*Policy(device="cpu")``: fusion on equals fusion off, spans
    engage, and both equal ``pivot_tpu``'s ``Tpu*Policy`` run.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pivot_tpu.ops import tickloop as jt
from pivot_tpu_torch.ops import cuda_kernels as ck
from pivot_tpu_torch.ops import tickloop as tt

from tests.test_tickloop import (
    B,
    H,
    _POLICY_CONFIGS,
    _ca_tables,
    _run_full_sim,
    _span_inputs,
)

FIELDS = ("placements", "n_ready", "n_placed", "ticks_run", "n_stack_final",
          "stackpos", "avail")


@pytest.fixture(autouse=True)
def _reset_port_ids():
    from pivot_tpu_torch.utils import reset_ids

    reset_ids()
    yield


def _t(x, dtype=None):
    x = torch.from_numpy(np.array(x))
    return x if dtype is None else x.to(dtype)


def span_kwargs(config, n_ticks, phase2, seed=0):
    """``(avail, dem, arrive, kw)`` of ``tests/test_tickloop.py``'s span
    inputs as numpy, with the JAX keyword arguments."""
    avail, dem, arrive, norms, uniforms = _span_inputs(seed)
    kw = dict(_POLICY_CONFIGS[config], phase2=phase2,
              sort_norm=jnp.asarray(norms))
    if kw["policy"] == "opportunistic":
        kw["uniforms"] = uniforms[:tt.span_bucket(n_ticks)]
    if kw["policy"] == "cost-aware":
        kw.update(_ca_tables())
    return avail, dem, arrive, kw


def to_port(kw, dtype=None):
    """The JAX keyword arguments as port tensors (floats in ``dtype``)."""
    out = {}
    for k, v in kw.items():
        if not hasattr(v, "shape"):
            out[k] = v
            continue
        x = _t(v)
        out[k] = x.to(dtype) if dtype is not None and x.is_floating_point() \
            else x
    return out


def bits(x):
    x = np.asarray(x)
    return x.view(np.uint64) if x.dtype == np.float64 else x


def assert_span_parity(config, n_ticks, phase2, live=None):
    avail, dem, arrive, kw = span_kwargs(config, n_ticks, phase2)
    K = tt.span_bucket(n_ticks)
    want = jt.fused_tick_run(
        jnp.asarray(avail), jnp.asarray(dem), jnp.asarray(arrive),
        jnp.asarray(n_ticks, jnp.int32), n_ticks=K,
        live=None if live is None else jnp.asarray(live), **kw)
    pkw = to_port(kw)
    plive = None if live is None else _t(live)
    got = tt.fused_tick_run(_t(avail), _t(dem), _t(arrive), n_ticks,
                            n_ticks=K, live=plive, **pkw)
    ticks_run = int(want.ticks_run)
    assert int(got.ticks_run) == ticks_run
    for f in FIELDS:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if f == "n_ready":
            a, b = a[:ticks_run], b[:ticks_run]
        assert a.shape == b.shape and np.array_equal(bits(a), bits(b)), (
            config, phase2, n_ticks, f)
    ref_p, ref_nr, ref_np, ref_avail = tt.reference_tick_run(
        _t(avail), _t(dem), _t(arrive), K, live=plive, **pkw)
    assert np.array_equal(ref_p, got.placements.numpy())
    assert np.array_equal(bits(ref_avail), bits(got.avail.numpy()))
    assert np.array_equal(ref_np, got.n_placed.numpy())
    assert np.array_equal(ref_nr[:ticks_run], got.n_ready[:ticks_run].numpy())
    # The skipped tail is a provable no-op; its ready size is the final
    # stack size.
    for k in range(ticks_run, K):
        if ref_nr[k]:
            assert ref_nr[k] == int(got.n_stack_final)
        assert ref_np[k] == 0


@pytest.mark.parametrize("n_ticks", [1, 4])
@pytest.mark.parametrize("phase2", ["scan", "slim", 8])
@pytest.mark.parametrize("config", sorted(_POLICY_CONFIGS))
def test_fused_span_matches_jax_and_referee(config, phase2, n_ticks):
    assert_span_parity(config, n_ticks, phase2)


@pytest.mark.slow
@pytest.mark.parametrize("n_ticks", [8, 16])
@pytest.mark.parametrize("phase2", ["scan", "slim", 8])
@pytest.mark.parametrize("config", sorted(_POLICY_CONFIGS))
def test_fused_span_matches_jax_and_referee_long(config, phase2, n_ticks):
    assert_span_parity(config, n_ticks, phase2)


@pytest.mark.parametrize("config", ["cost_aware_ff", "first_fit",
                                    "opportunistic"])
def test_fused_span_live_mask(config):
    """A span-constant quarantine mask is folded into the carry once and
    restored at the end, as the per-tick kernels' ``live`` handling."""
    live = np.ones(H, bool)
    live[3] = live[7] = False
    assert_span_parity(config, 8, "slim", live=live)


def test_fused_span_stalled_early_exit():
    """Nothing fits and no cohort remains: the span is done after its
    first tick; every later tick is a dead row left at −1 / 0."""
    avail = np.full((H, 4), 0.1)
    dem = np.full((B, 4), 1.0)
    arrive = np.zeros(B, np.int32)
    res = tt.fused_tick_run(_t(avail), _t(dem), _t(arrive), 8, n_ticks=8,
                            policy="first-fit", strict=False)
    want = jt.fused_tick_run(jnp.asarray(avail), jnp.asarray(dem),
                             jnp.asarray(arrive), jnp.asarray(8, jnp.int32),
                             n_ticks=8, policy="first-fit", strict=False)
    assert int(res.ticks_run) == int(want.ticks_run) == 1
    assert int(res.n_stack_final) == B
    assert bool((res.placements == -1).all())
    assert res.n_ready.tolist() == [B] + [0] * 7
    assert res.n_placed.tolist() == [0] * 8
    assert np.array_equal(res.avail.numpy(), avail)
    assert np.array_equal(res.stackpos.numpy(), np.asarray(want.stackpos))


def test_span_step_bounds():
    arrive = np.array([0, 0, 2, 5, 2, 0, 9])
    assert tt.span_step_bounds(arrive, 6) == [3, 3, 5, 5, 5, 6]
    assert [tt.span_bucket(k) for k in (1, 3, 5, 32, 33)] == [1, 4, 8, 32,
                                                              64]


@pytest.mark.parametrize("config", ["cost_aware_ff", "cost_aware_bf_decay"])
def test_kernel_served_cost_aware_span_f32(config):
    """The Cost-Aware span in float32 served tick by tick by the hand
    kernel's wrapper (on CPU tensors: its plain version; no launch is
    counted) equals the same span through ``cost_aware_impl``: equal
    placements, availability within rtol 1e-6 / atol 1e-5."""
    avail, dem, arrive, kw = span_kwargs(config, 8, "slim")
    pkw = to_port(kw, torch.float32)
    args = (_t(avail, torch.float32), _t(dem, torch.float32), _t(arrive), 8)
    ck.reset_launches()
    got = tt.fused_tick_run(*args, n_ticks=8, greedy=ck.cost_aware_cuda,
                            **pkw)
    want = tt.fused_tick_run(*args, n_ticks=8, **pkw)
    assert ck.LAUNCHES["greedy_place"] == 0
    assert torch.equal(got.placements, want.placements)
    assert int((got.placements >= 0).sum()) >= B // 4
    for f in ("n_ready", "n_placed", "ticks_run", "n_stack_final",
              "stackpos"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.allclose(got.avail, want.avail, rtol=1e-6, atol=1e-5)
    ref_p, _nr, _np, ref_avail = tt.reference_tick_run(
        args[0], args[1], args[2], 8, greedy=ck.cost_aware_plain, **pkw)
    assert np.array_equal(ref_p, got.placements.numpy())
    assert np.allclose(ref_avail, got.avail.numpy(), rtol=1e-6, atol=1e-5)


# -- no host reads inside a span ---------------------------------------------


class HostRead(AssertionError):
    pass


@contextlib.contextmanager
def no_host_reads():
    """Every tensor→host path of the Python API raises while active."""
    names = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
             "__float__")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def refuse(name):
        def f(self, *a, **k):
            raise HostRead(f"Tensor.{name} inside a span")
        return f

    try:
        for n in names:
            setattr(torch.Tensor, n, refuse(n))
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


def stub_greedy(avail, demands, valid, new_group, anchor_zone, cost_zz,
                bw_zz, host_zone, base_task_counts, bin_pack="first-fit",
                sort_hosts=True, host_decay=False, live=None, risk=None,
                n_eff=None):
    """``cost_aware_cuda``'s argument contract (checked by the wrapper's
    own ``_check``) with a stand-in launch made of device ops: each valid
    task below ``n_eff`` goes to host ``j mod H``."""
    ck._check(avail[None], demands, valid, new_group, anchor_zone, cost_zz,
              bw_zz, host_zone, base_task_counts, bin_pack, live, risk,
              n_eff)
    T, H = demands.shape[0], avail.shape[0]
    j = torch.arange(T, device=avail.device)
    placed = valid & (j < n_eff)
    return torch.where(placed, j % H, -1).to(torch.int32), avail.clone()


@pytest.mark.parametrize("config", ["opportunistic", "first_fit_decreasing",
                                    "cost_aware_ff"])
def test_span_reads_nothing_from_the_device(config):
    """The three arms ``overall`` runs, as its policies run them (slim,
    host step bounds; Cost-Aware through the kernel's wrapper contract):
    a whole span with no tensor→host read between staging and fetch."""
    with pytest.raises(HostRead):
        with no_host_reads():
            torch.zeros(1).item()
    avail, dem, arrive, kw = span_kwargs(config, 8, "auto")
    dtype = torch.float32 if config == "cost_aware_ff" else torch.float64
    pkw = to_port(kw, dtype)
    if config == "cost_aware_ff":
        pkw["greedy"] = stub_greedy
    args = (_t(avail, dtype), _t(dem, dtype), _t(arrive))
    n_bound = tt.span_step_bounds(arrive, 8)
    with no_host_reads():
        res = tt.fused_tick_run(*args, 8, n_ticks=8, n_bound=n_bound, **pkw)
    assert int((res.placements >= 0).sum()) > 0
    if config != "cost_aware_ff":
        want = tt.fused_tick_run(*args, 8, n_ticks=8, **pkw)
        for f in FIELDS:
            assert torch.equal(getattr(res, f), getattr(want, f)), f


# -- DES parity ----------------------------------------------------------------


def _port_full_sim(policy_fn, fuse, n_apps=3, n_hosts=4, cpus=4.0):
    """``tests/test_tickloop.py::_run_full_sim`` (without chaos) from the
    port's own modules (``n_hosts``, ``cpus``: ``_build_cluster``'s)."""
    from pivot_tpu_torch.des import Environment
    from pivot_tpu_torch.infra import Cluster, Host, Storage
    from pivot_tpu_torch.infra.locality import ResourceMetadata
    from pivot_tpu_torch.infra.meter import Meter
    from pivot_tpu_torch.sched import GlobalScheduler
    from pivot_tpu_torch.utils import reset_ids
    from pivot_tpu_torch.workload import Application, TaskGroup

    reset_ids()
    env = Environment()
    meta = ResourceMetadata(seed=0)
    meter = Meter(env, meta)
    zones = meta.zones
    hosts = [Host(env, cpus, 1024, 100, 1, locality=zones[i % 2], meter=meter,
                  id=f"h{i}") for i in range(n_hosts)]
    storage = [Storage(env, z) for z in dict.fromkeys(h.locality
                                                      for h in hosts)]
    cluster = Cluster(env, hosts=hosts, storage=storage, meta=meta,
                      meter=meter, route_mode="meta", seed=0,
                      executor_backend="fast")
    policy = policy_fn()
    sched = GlobalScheduler(env, cluster, policy, seed=3, meter=meter,
                            fuse_spans=fuse)
    cluster.start()
    sched.start()
    apps = [
        Application(f"app{i}", [
            TaskGroup("a", cpus=1, mem=64, runtime=17.0, output_size=400,
                      instances=10),
            TaskGroup("b", cpus=2, mem=64, runtime=9.0, dependencies=["a"],
                      instances=6),
            TaskGroup("c", cpus=1, mem=32, runtime=5.0, dependencies=["b"],
                      instances=8),
        ])
        for i in range(n_apps)
    ]
    for a in apps:
        sched.submit(a)
    sched.stop()
    env.run()
    placements = sorted(
        (t.id, t.placement) for a in apps for g in a.groups for t in g.tasks)
    summary = (placements, [a.end_time for a in apps], sched._tick_seq,
               meter.total_scheduling_ops, env.now)
    return summary, sched.span_stats, policy


def _f64(pol):
    pol.dtype = torch.float64
    return pol


def _port_policy(name):
    from pivot_tpu_torch.sched import cuda as pc

    return {
        "ff": lambda: _f64(pc.CudaFirstFitPolicy(device="cpu")),
        "ffd": lambda: _f64(pc.CudaFirstFitPolicy(decreasing=True,
                                                  device="cpu")),
        "bf": lambda: _f64(pc.CudaBestFitPolicy(device="cpu")),
        "opp": lambda: _f64(pc.CudaOpportunisticPolicy(device="cpu")),
        "ca": lambda: _f64(pc.CudaCostAwarePolicy(
            sort_tasks=True, sort_hosts=True, device="cpu")),
    }[name]


def _jax_policy(name):
    from pivot_tpu.sched import tpu as jp

    def f64(pol):
        pol.dtype = jnp.float64
        return pol

    return {
        "ff": lambda: f64(jp.TpuFirstFitPolicy()),
        "ffd": lambda: f64(jp.TpuFirstFitPolicy(decreasing=True)),
        "bf": lambda: f64(jp.TpuBestFitPolicy()),
        "opp": lambda: f64(jp.TpuOpportunisticPolicy()),
        "ca": lambda: f64(jp.TpuCostAwarePolicy(sort_tasks=True,
                                                 sort_hosts=True)),
    }[name]


@pytest.mark.parametrize("name", ["ff", "ffd", "bf", "opp", "ca"])
def test_des_fused_spans_match_per_tick_and_reference(name):
    """Pump-delivery windows served as spans leave placements, end times,
    tick counts and meter totals bit-identical to per-tick dispatch and
    to ``pivot_tpu``'s device policy, and spans do engage."""
    fused, stats, pol = _port_full_sim(_port_policy(name), fuse=True)
    plain, plain_stats, _ = _port_full_sim(_port_policy(name), fuse=False)
    assert fused == plain
    assert stats["fused_spans"] > 0
    assert stats["fused_ticks"] > stats["fused_spans"]
    assert plain_stats["fused_spans"] == 0
    assert pol.dispatch_stats()["span_kernel_ticks"] == 0  # f64: no kernel
    ref, ref_stats = _run_full_sim(_jax_policy(name), fuse=True)
    assert fused == ref
    assert (stats["fused_spans"], stats["fused_ticks"]) == (
        ref_stats["fused_spans"], ref_stats["fused_ticks"])


def test_des_kernel_served_spans_f32():
    """In float32 with the kernel forced on (its plain version on the
    CPU), Cost-Aware span ticks go through the kernel's wrapper and are
    counted apart from the per-tick kernel ticks; the run equals the
    float32 torch-form run."""
    from pivot_tpu_torch.sched import cuda as pc

    class AutoKernel(pc.CudaCostAwarePolicy):
        def _kernel_serves(self):
            return True  # the auto rule's verdict on a card

    kw = dict(sort_tasks=True, sort_hosts=True, device="cpu")
    got, stats, pol = _port_full_sim(lambda: AutoKernel(**kw), fuse=True)
    want, _, ref = _port_full_sim(
        lambda: pc.CudaCostAwarePolicy(use_kernel=False, **kw), fuse=True)
    assert got == want
    d = pol.dispatch_stats()
    assert d["span_kernel_ticks"] >= stats["fused_ticks"] > 0
    assert d["kernel_ticks"] == d["device_ticks"] > 0
    assert ref.dispatch_stats()["span_kernel_ticks"] == 0
