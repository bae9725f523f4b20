"""Resident span carries: the port's ``resident_span_run`` and its policy
tier (``sched/cuda.py``) against ``pivot_tpu``'s.

After ``tests/test_resident.py:193-334`` and its DES section:

  * **kernel parity** — on the CPU in float64, ``resident_span_run``
    (edit rows, the carry's own count histogram, risk rows gathered from
    a once-staged table) equals the port's ``fused_tick_run`` on the
    re-staged state and ``pivot_tpu``'s ``resident_span_run`` under x64,
    bit for bit: placements, availability, ``n_placed``, ``ticks_run``,
    ``n_stack_final`` and the carry;
  * **carry helpers** — a clone survives its parent being consumed, an
    exported carry restores to the same span results, ``init`` copies;
  * **DES parity** — with ``enable_resident()`` the simulation
    (placements, end times, tick count, meter total, clock) equals the
    re-staged span path and ``pivot_tpu``'s resident run, in the
    ``phase2`` modes, under a chaos preemption (mirror-diff edit rows)
    and under a market's risk rows;
  * **splice parity** — a mid-run submission joined into a running span
    leaves the simulation equal to the ``fuse_spans=False`` referee, and
    ``splice=False`` never splices.

Exact unless a case says otherwise.  ``pivot_tpu``'s zero-recompile case
(``count_compiles``) has no counterpart here: torch compiles nothing.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pivot_tpu.ops import tickloop as jt
from pivot_tpu_torch.ops import cuda_kernels as ck
from pivot_tpu_torch.ops import tickloop as tt

from tests import test_resident as jr

H, B = jr.H, jr.B


@pytest.fixture(autouse=True)
def _reset_port_ids():
    from pivot_tpu_torch.utils import reset_ids

    reset_ids()
    yield


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_kw(kw):
    return {k: _t(v) if hasattr(v, "shape") else v for k, v in kw.items()}


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint64) if x.dtype == np.float64 else x


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(_bits(a), _bits(b))


def _assert_same(res, ref, carry=None):
    for f in ("placements", "avail", "n_placed", "ticks_run",
              "n_stack_final"):
        assert _equal(getattr(res, f), getattr(ref, f)), f
    if carry is not None:
        assert _equal(carry.avail, ref.avail)


def _resident_case(config, n_ticks=8, live=None, risk=False, seed=0):
    """One span three ways: the port's re-staged ``fused_tick_run``, the
    port's ``resident_span_run`` and ``pivot_tpu``'s."""
    avail, dem, arrive, norms, uniforms = jr._span_inputs(seed=seed)
    kw, fused_kw, res_kw, counts = jr._split_kw(
        jr._POLICY_CONFIGS[config], n_ticks, "auto", norms, uniforms,
        risk=risk)
    live_np = np.ones(H, bool) if live is None else np.asarray(live)
    K = tt.span_bucket(n_ticks)
    want = tt.fused_tick_run(
        _t(avail), _t(dem), _t(arrive), n_ticks, n_ticks=K,
        base_task_counts=_t(counts),
        live=None if live is None else _t(live_np),
        **_port_kw(fused_kw), **_port_kw(kw))
    carry = tt.resident_carry_init(avail, counts, live_np, device="cpu")
    got, carry = tt.resident_span_run(
        carry, _t(dem), _t(arrive), n_ticks, n_ticks=K,
        **_port_kw(res_kw), **_port_kw(kw))
    _assert_same(got, want, carry)
    jcarry = jt.resident_carry_init(jnp.asarray(avail), counts, live_np)
    ref, jcarry = jt.resident_span_run(
        jcarry, jnp.asarray(dem), jnp.asarray(arrive),
        jnp.asarray(n_ticks, jnp.int32), n_ticks=K, **res_kw, **kw)
    _assert_same(got, ref)
    for f in ("avail", "counts", "live"):
        assert _equal(getattr(carry, f), getattr(jcarry, f)), f


@pytest.mark.parametrize("config", sorted(jr._POLICY_CONFIGS))
def test_resident_span_parity_quick(config):
    _resident_case(config)


def test_resident_span_parity_live_and_risk():
    live = np.ones(H, bool)
    live[3] = live[7] = False
    for config in ("cost_aware_ff", "first_fit"):
        _resident_case(config, live=live)
        _resident_case(config, risk=True)


def test_resident_kernel_served_cost_aware_f32():
    """The span's Cost-Aware ticks through the hand kernel's wrapper (its
    plain version on CPU tensors), counts from the carry: equal
    placements to the re-staged kernel-served span, availability within
    rtol 1e-6 / atol 1e-5 (the same plain arithmetic: exact here)."""
    avail, dem, arrive, norms, uniforms = jr._span_inputs()
    kw, _f, _r, counts = jr._split_kw(
        jr._POLICY_CONFIGS["cost_aware_ff"], 8, "auto", norms, uniforms)
    pkw = {k: (v.to(torch.float32) if v.is_floating_point() else v)
           if torch.is_tensor(v) else v for k, v in _port_kw(kw).items()}
    f32 = lambda x: _t(x).to(torch.float32)  # noqa: E731
    want = tt.fused_tick_run(f32(avail), f32(dem), _t(arrive), 8, n_ticks=8,
                             base_task_counts=_t(counts),
                             greedy=ck.cost_aware_cuda, **pkw)
    carry = tt.resident_carry_init(f32(avail), counts)
    got, carry = tt.resident_span_run(carry, f32(dem), _t(arrive), 8,
                                      n_ticks=8, greedy=ck.cost_aware_cuda,
                                      **pkw)
    assert torch.equal(got.placements, want.placements)
    assert int((got.placements >= 0).sum()) > 0
    assert torch.allclose(got.avail, want.avail, rtol=1e-6, atol=1e-5)


def test_resident_edit_rows_repair():
    """Edit rows (pad entries at index H dropped) repair the carry to the
    post-edit host state: the span equals a re-stage of that state, and
    ``pivot_tpu``'s resident span with the same edits."""
    avail, dem, arrive, norms, uniforms = jr._span_inputs()
    kw, _, _, counts = jr._split_kw(
        jr._POLICY_CONFIGS["cost_aware_ff"], 8, "auto", norms, uniforms)
    post = avail.copy()
    post[2] += 0.7
    post[9] += 1.3
    post_counts = counts.copy()
    post_counts[2] -= 1
    post_live = np.ones(H, bool)
    post_live[4] = False
    edits = dict(
        edit_idx=np.array([2, 9, 4, H, H], np.int32),
        edit_avail=np.stack([post[2], post[9], post[4], np.zeros(4),
                             np.zeros(4)]).astype(post.dtype),
        edit_counts=np.array([post_counts[2], post_counts[9],
                              post_counts[4], 0, 0], np.int32),
        edit_live=np.array([True, True, False, True, True]),
    )
    want = tt.fused_tick_run(
        _t(post), _t(dem), _t(arrive), 8, n_ticks=8,
        base_task_counts=_t(post_counts), live=_t(post_live),
        **_port_kw(kw))
    carry = tt.resident_carry_init(avail, counts, device="cpu")
    got, carry = tt.resident_span_run(
        carry, _t(dem), _t(arrive), 8, n_ticks=8, **_port_kw(edits),
        **_port_kw(kw))
    _assert_same(got, want, carry)
    assert carry.live.tolist() == post_live.tolist()
    ref, _ = jt.resident_span_run(
        jt.resident_carry_init(jnp.asarray(avail), counts),
        jnp.asarray(dem), jnp.asarray(arrive), jnp.asarray(8, jnp.int32),
        n_ticks=8, **{k: jnp.asarray(v) for k, v in edits.items()}, **kw)
    _assert_same(got, ref)


def test_resident_multi_span_chain():
    """Four spans chained through the carry — its counts fold each
    span's placement histogram — equal four re-stagings with the
    histogram applied on the host."""
    avail, _, arrive, _, _ = jr._span_inputs()
    dems = np.random.default_rng(3).uniform(0.1, 0.8, (4, B, 4))
    host_avail = avail.copy()
    counts = np.zeros(H, np.int32)
    carry = tt.resident_carry_init(avail, counts, device="cpu")
    for i in range(4):
        norms = np.sqrt((dems[i] * dems[i]).sum(1))
        kw, _, _, _ = jr._split_kw(jr._POLICY_CONFIGS["cost_aware_ff"], 8,
                                   "auto", norms, jnp.zeros((8, B)))
        want = tt.fused_tick_run(
            _t(host_avail), _t(dems[i]), _t(arrive), 8, n_ticks=8,
            base_task_counts=_t(counts), **_port_kw(kw))
        got, carry = tt.resident_span_run(carry, _t(dems[i]), _t(arrive), 8,
                                          n_ticks=8, **_port_kw(kw))
        _assert_same(got, want, carry)
        host_avail = want.avail.numpy()
        pl = want.placements.numpy()
        np.add.at(counts, pl[pl >= 0], 1)
        assert carry.counts.tolist() == counts.tolist()
    assert int(counts.sum()) > 0


def test_resident_carry_clone_is_independent():
    """A splice checkpoint survives its parent being consumed: the clone
    re-runs the span to the same result."""
    avail, dem, arrive, norms, _ = jr._span_inputs()
    kw, _, _, _ = jr._split_kw(jr._POLICY_CONFIGS["first_fit"], 8, "auto",
                               norms, jnp.zeros((8, B)))
    carry = tt.resident_carry_init(avail, device="cpu")
    ckpt = tt.resident_carry_clone(carry)
    res1, after = tt.resident_span_run(carry, _t(dem), _t(arrive), 8,
                                       n_ticks=8, **_port_kw(kw))
    res2, _ = tt.resident_span_run(ckpt, _t(dem), _t(arrive), 8, n_ticks=8,
                                   **_port_kw(kw))
    _assert_same(res2, res1)
    assert not _equal(after.avail, avail)  # the span placed something
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(after, ckpt))


def test_resident_export_restore_round_trip():
    """An exported carry restores to an equal carry (copied, not
    aliased), and the chain continues from it exactly as from the
    original; ``init`` never aliases the caller's numpy."""
    avail, dem, arrive, norms, _ = jr._span_inputs()
    kw, _, _, _ = jr._split_kw(jr._POLICY_CONFIGS["best_fit"], 8, "auto",
                               norms, jnp.zeros((8, B)))
    host = avail.copy()
    carry = tt.resident_carry_init(host, device="cpu")
    host[:] = 0.0
    assert _equal(carry.avail, avail)
    _, carry = tt.resident_span_run(carry, _t(dem), _t(arrive), 8,
                                    n_ticks=8, **_port_kw(kw))
    snap = tt.resident_carry_export(carry)
    assert set(snap) == {"avail", "counts", "live"}
    restored = tt.resident_carry_restore(snap["avail"], snap["counts"],
                                         snap["live"], device="cpu")
    snap["avail"][:] = -1.0
    a, _ = tt.resident_span_run(carry, _t(dem * 0.5), _t(arrive), 8,
                                n_ticks=8, **_port_kw(kw))
    b, _ = tt.resident_span_run(restored, _t(dem * 0.5), _t(arrive), 8,
                                n_ticks=8, **_port_kw(kw))
    _assert_same(b, a)
    assert tt.edit_bucket(0) == 0 and tt.edit_bucket(9) == 32
    assert tt.edit_bucket(600) == 1024


# -- DES parity ----------------------------------------------------------------


def _port_sim(policy_fn, fuse, resident=False, splice=True, chaos=False,
              market=False, late_at=None, n_hosts=4):
    """``tests/test_resident.py::_run_full_sim`` from the port's modules."""
    from pivot_tpu_torch.des import Environment
    from pivot_tpu_torch.infra import Cluster, Host, Storage
    from pivot_tpu_torch.infra.faults import FaultInjector
    from pivot_tpu_torch.infra.locality import ResourceMetadata
    from pivot_tpu_torch.infra.market import MarketSchedule
    from pivot_tpu_torch.infra.meter import Meter
    from pivot_tpu_torch.sched import GlobalScheduler
    from pivot_tpu_torch.utils import reset_ids
    from pivot_tpu_torch.workload import Application, TaskGroup

    reset_ids()
    env = Environment()
    meta = ResourceMetadata(seed=0)
    meter = Meter(env, meta)
    zones = meta.zones
    hosts = [Host(env, 4.0, 1024, 100, 1, locality=zones[i % 2],
                  meter=meter, id=f"h{i}") for i in range(n_hosts)]
    storage = [Storage(env, z)
               for z in dict.fromkeys(h.locality for h in hosts)]
    cluster = Cluster(env, hosts=hosts, storage=storage, meta=meta,
                      meter=meter, route_mode="meta", seed=0,
                      executor_backend="fast")
    policy = policy_fn()
    if resident:
        policy.enable_resident(splice=splice)
    mkt = None
    if market:
        mkt = MarketSchedule.generate(
            meta, seed=5, horizon=400.0, n_segments=4, hot_fraction=0.3,
            hot_hazard=1e-2, base_hazard=1e-4)
    sched = GlobalScheduler(env, cluster, policy, seed=3, meter=meter,
                            fuse_spans=fuse, market=mkt)
    cluster.start()
    sched.start()
    if chaos:
        FaultInjector(cluster, seed=0).preempt_host(
            cluster.hosts[1].id, at=27.0, lead=6.0, outage=25.0)
    apps = [
        Application(f"app{i}", [
            TaskGroup("a", cpus=1, mem=64, runtime=17.0, output_size=400,
                      instances=10),
            TaskGroup("b", cpus=2, mem=64, runtime=9.0, dependencies=["a"],
                      instances=6),
            TaskGroup("c", cpus=1, mem=32, runtime=5.0, dependencies=["b"],
                      instances=8),
        ])
        for i in range(3)
    ]
    for a in apps:
        sched.submit(a)
    if late_at is not None:
        env.run(until=late_at)
        late = Application("late", [
            TaskGroup("z", cpus=1, mem=32, runtime=4.0, instances=3)])
        sched.submit(late)
        apps = apps + [late]
    sched.stop()
    env.run()
    placements = sorted((t.id, t.placement)
                        for a in apps for g in a.groups for t in g.tasks)
    summary = (placements, [a.end_time for a in apps], sched._tick_seq,
               meter.total_scheduling_ops, env.now)
    return summary, dict(sched.span_stats), policy


def _f64(pol):
    pol.dtype = torch.float64
    return pol


def _port_policy(name, **kw):
    from pivot_tpu_torch.sched import cuda as pc

    make = {
        "first_fit": lambda: pc.CudaFirstFitPolicy(device="cpu", **kw),
        "first_fit_decreasing": lambda: pc.CudaFirstFitPolicy(
            decreasing=True, device="cpu", **kw),
        "best_fit": lambda: pc.CudaBestFitPolicy(device="cpu", **kw),
        "opportunistic": lambda: pc.CudaOpportunisticPolicy(device="cpu",
                                                             **kw),
        "cost_aware": lambda: pc.CudaCostAwarePolicy(
            sort_tasks=True, sort_hosts=True, device="cpu", **kw),
    }[name]
    return lambda: _f64(make())


def _jax_policy(name, **kw):
    from pivot_tpu.sched import tpu as jp

    make = {
        "first_fit": lambda: jp.TpuFirstFitPolicy(**kw),
        "opportunistic": lambda: jp.TpuOpportunisticPolicy(**kw),
        "cost_aware": lambda: jp.TpuCostAwarePolicy(
            sort_tasks=True, sort_hosts=True, **kw),
    }[name]

    def f64():
        pol = make()
        pol.dtype = jnp.float64
        return pol

    return f64


def _assert_des_resident_parity(name, ref=True, **sim_kw):
    base, stats0, _ = _port_sim(_port_policy(name), fuse=True, **sim_kw)
    got, stats1, pol = _port_sim(_port_policy(name), fuse=True,
                                 resident=True, **sim_kw)
    assert got == base
    assert stats0 == stats1
    assert pol.dispatch_stats()["resident"]["spans"] == \
        stats1["fused_spans"] > 0
    if ref:
        want, _, _ = jr._run_full_sim(_jax_policy(name), fuse=True,
                                      resident=True, **sim_kw)
        assert got == want
    return stats1, pol


@pytest.mark.parametrize("name", ["first_fit", "first_fit_decreasing",
                                  "best_fit", "opportunistic",
                                  "cost_aware"])
def test_des_resident_bit_parity(name):
    _assert_des_resident_parity(
        name, ref=name in ("first_fit", "opportunistic", "cost_aware"))


@pytest.mark.parametrize("phase2", ["slim", 8])
def test_des_resident_phase2_parity(phase2):
    from pivot_tpu_torch.sched import cuda as pc

    def mk():
        return _f64(pc.CudaCostAwarePolicy(sort_tasks=True, sort_hosts=True,
                                           phase2=phase2, device="cpu"))

    base, _, _ = _port_sim(mk, fuse=True)
    got, _, pol = _port_sim(mk, fuse=True, resident=True)
    assert got == base and pol.dispatch_stats()["resident"]["spans"] > 0


def test_des_resident_chaos_parity():
    """A chaos preemption flips the live mask mid-run: the flip and the
    completions surface as mirror-diff edit rows, results unchanged."""
    _, pol = _assert_des_resident_parity("cost_aware", chaos=True)
    rs = pol.dispatch_stats()["resident"]
    assert rs["edit_rows"] > 0 and rs["d2h_bytes"] > 0


def test_des_resident_market_risk_parity():
    """Risk rows gathered from the once-staged [P, H] table equal the
    re-staged host-rendered rows through a whole market run."""
    def port():
        return _port_policy("cost_aware", risk_weight=0.5)()

    base, _, _ = _port_sim(port, fuse=True, market=True)
    got, _, pol = _port_sim(port, fuse=True, resident=True, market=True)
    assert got == base
    assert pol._resident.risk_table_np is not None
    want, _, _ = jr._run_full_sim(_jax_policy("cost_aware", risk_weight=0.5),
                                  fuse=True, resident=True, market=True)
    assert got == want


def test_resident_refusals():
    from pivot_tpu_torch.sched import cuda as pc

    with pytest.raises(ValueError, match="adaptive"):
        pc.CudaFirstFitPolicy(device="cpu", adaptive=True).enable_resident()
    with pytest.raises(ValueError, match="use_kernel"):
        pc.CudaCostAwarePolicy(device="cpu",
                               use_kernel=True).enable_resident()
    with pytest.raises(ValueError, match="realtime_bw"):
        pc.CudaCostAwarePolicy(device="cpu",
                               realtime_bw=True).enable_resident()
    batched = pc.CudaFirstFitPolicy(device="cpu")
    batched.enable_batching(object())
    with pytest.raises(ValueError, match="batcher"):
        batched.enable_resident()
    resident = pc.CudaFirstFitPolicy(device="cpu")
    resident.enable_resident()
    with pytest.raises(ValueError, match="resident"):
        resident.enable_batching(object())


# -- mid-span splice -------------------------------------------------------------


def test_resident_splice_parity():
    """Timed mid-run submissions across the reference's band of instants:
    every run equals the ``fuse_spans=False`` referee and ``pivot_tpu``'s
    resident run, and some instant joins a running span."""
    total = 0
    for t in jr._SPLICE_INSTANTS:
        plain, _, _ = _port_sim(_port_policy("first_fit"), fuse=False,
                                late_at=t)
        got, stats, pol = _port_sim(_port_policy("first_fit"), fuse=True,
                                    resident=True, late_at=t)
        assert got == plain, f"splice parity broke at t={t}"
        assert stats["span_splices"] == \
            pol.dispatch_stats()["resident"]["splices"]
        total += stats["span_splices"]
        if stats["span_splices"]:
            want, ref_stats, _ = jr._run_full_sim(
                _jax_policy("first_fit"), fuse=True, resident=True,
                late_at=t)
            assert got == want
            assert ref_stats["span_splices"] == stats["span_splices"]
            break
    assert total > 0, "no submission instant produced a splice"


def test_resident_splice_off_never_splices():
    for t in (22.0, 27.0):
        plain, _, _ = _port_sim(_port_policy("first_fit"), fuse=False,
                                late_at=t)
        got, stats, _ = _port_sim(_port_policy("first_fit"), fuse=True,
                                  resident=True, splice=False, late_at=t)
        assert got == plain
        assert stats["span_splices"] == 0
