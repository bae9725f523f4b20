"""Host sharding: the port's ``ops/shard.py`` and ``parallel/mesh.py``.

``pivot_tpu``'s own sharded forms cannot run here (``shard_map`` rejects
their ``check_rep=`` under this jax), but their contract is that sharding
changes nothing: the two-stage argmin keeps the flat argmin's result bit
for bit (``pivot_tpu/ops/shard.py:15-40``).  So the port's sharded forms,
on meshes of S logical shards on the CPU, are held in float64 against
``pivot_tpu``'s UNSHARDED kernels under x64, its span driver and its
single-device policy:

  * **kernels** — the four arms × S ∈ {1, 2, 4, 8} × the per-step pass
    (``phase2="auto"``) and the chunk commit (C = 8) × the live mask off
    and on, at H = 1024, against ``*_kernel`` in ``phase2`` ∈ {scan,
    slim, 8} and the ``*_kernel_ref`` oracles; the contended batch, the
    Cost-Aware flag grid and the risk operands.  Placements and
    availability bit-equal (the bar of ``tests/test_shard.py``);
  * **validation** — the reference's cases, the empty-batch passthrough
    and the refusal of a mesh over two distinct devices;
  * **spans** — ``sharded_fused_tick_run`` against ``fused_tick_run``
    and ``reference_tick_run`` in every span configuration at 8 ticks,
    with a live mask and with the market operands;
  * **policy** — ``enable_sharding`` against ``TpuCostAwarePolicy``
    unsharded on one bench batch, the validation matrix, and full DES
    runs with fused spans at S ∈ {4, 8};
  * **mesh** — shapes, axis sizes and the reference's errors.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pivot_tpu.ops import kernels as jk
from pivot_tpu.ops import tickloop as jt
from pivot_tpu_torch.ops import shard as sh
from pivot_tpu_torch.parallel import mesh as pm

from tests.test_torch_kernels import CA_ARGS, as_torch, assert_same
from tests.test_two_phase import CA_MODES, contended_inputs, make_inputs

CPU = torch.device("cpu")
SHARDS = (1, 2, 4, 8)
#: The unsharded modes every sharded output is held against.
PHASE2_MODES = ("scan", "slim", 8)
#: The sharded modes: the per-step pass and the chunk commit.
SHARDED_MODES = ("auto", 8)


@pytest.fixture(autouse=True)
def _reset_port_ids():
    from pivot_tpu_torch.utils import reset_ids

    reset_ids()
    yield


def mesh(S):
    return pm.host_sharded_mesh(devices=[CPU] * S)


def live_mask(H, seed=0):
    rng = np.random.default_rng(seed)
    live = np.ones(H, bool)
    live[rng.choice(H, size=max(H // 4, 1), replace=False)] = False
    return live


def _jax_runs(policy, x, live, risk, modes, ca_modes):
    """``pivot_tpu``'s unsharded outputs: ``{(mode, tag): out}`` for each
    phase-2 mode and the scan oracle; every one must equal the oracle
    (else the referee itself is off)."""
    kw = dict(live=None if live is None else jnp.asarray(live),
              risk=None if risk is None else jnp.asarray(risk))
    out = {}
    if policy == "opportunistic":
        args = (x["avail"], x["dem"], x["valid"], x["u"])
        runs = {("ref", None): jk.opportunistic_kernel_ref(*args, **kw)}
        runs.update({(p2, None): jk.opportunistic_kernel(*args, phase2=p2,
                                                         **kw)
                     for p2 in modes})
    elif policy in ("first_fit", "first_fit_strict"):
        strict = policy == "first_fit_strict"
        args = (x["avail"], x["dem"], x["valid"])
        runs = {("ref", None): jk.first_fit_kernel_ref(*args, strict=strict,
                                                       **kw)}
        runs.update({(p2, None): jk.first_fit_kernel(
            *args, strict=strict, totals=x["totals"], phase2=p2, **kw)
            for p2 in modes})
    elif policy == "best_fit":
        args = (x["avail"], x["dem"], x["valid"])
        runs = {("ref", None): jk.best_fit_kernel_ref(*args, **kw)}
        runs.update({(p2, None): jk.best_fit_kernel(
            *args, totals=x["totals"], phase2=p2, **kw) for p2 in modes})
    else:
        args = tuple(x[k] for k in CA_ARGS)
        runs = {}
        for i, mode in enumerate(ca_modes):
            runs[("ref", i)] = jk.cost_aware_kernel_ref(*args, **mode, **kw)
            runs.update({(p2, i): jk.cost_aware_kernel(
                *args, **mode, totals=x["totals"], phase2=p2, **kw)
                for p2 in modes})
    for (p2, i), got in runs.items():
        ref = runs[("ref", i)]
        assert np.array_equal(np.asarray(got[0]), np.asarray(ref[0])), (
            policy, p2, i)
        assert np.array_equal(np.asarray(got[1]), np.asarray(ref[1])), (
            policy, p2, i)
        out[(p2, i)] = got
    return out


def _port_sharded(policy, m, t, live, risk, sp2, mode=None):
    kw = dict(live=None if live is None else torch.from_numpy(live),
              risk=None if risk is None else torch.from_numpy(risk),
              phase2=sp2)
    if policy == "opportunistic":
        return sh.opportunistic_kernel_sharded(
            m, t["avail"], t["dem"], t["valid"], t["u"], **kw)
    if policy in ("first_fit", "first_fit_strict"):
        return sh.first_fit_kernel_sharded(
            m, t["avail"], t["dem"], t["valid"],
            strict=policy == "first_fit_strict", totals=t["totals"], **kw)
    if policy == "best_fit":
        return sh.best_fit_kernel_sharded(
            m, t["avail"], t["dem"], t["valid"], totals=t["totals"], **kw)
    return sh.cost_aware_kernel_sharded(
        m, *(t[k] for k in CA_ARGS), **mode, totals=t["totals"], **kw)


def sweep(policy, x, shards, live_opts=(False, True), risk=None,
          modes=PHASE2_MODES, ca_modes=(CA_MODES[0], CA_MODES[4]),
          jax_cache=None):
    """The port's sharded outputs at each S × sharded mode × live option
    against every ``pivot_tpu`` unsharded mode's output."""
    t = as_torch(x)
    H = t["avail"].shape[0]
    for lv_opt in live_opts:
        live = live_mask(H) if lv_opt else None
        key = (policy, lv_opt)
        if jax_cache is not None and key in jax_cache:
            singles = jax_cache[key]
        else:
            singles = _jax_runs(policy, x, live, risk, modes, ca_modes)
            if jax_cache is not None:
                jax_cache[key] = singles
        for S in shards:
            m = mesh(S)
            for sp2 in SHARDED_MODES:
                for i, mode in (enumerate(ca_modes)
                                if policy == "cost_aware" else [(None, None)]):
                    got = _port_sharded(policy, m, t, live, risk, sp2, mode)
                    for (p2, j), want in singles.items():
                        if j == i:
                            assert_same(want, got, (policy, S, sp2, p2, i,
                                                    lv_opt))


@functools.lru_cache(maxsize=None)
def _h1024_inputs():
    return make_inputs(11, T=96, H=1024, B=128, group_size=8)


_H1024_JAX: dict = {}


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("policy", ["opportunistic", "first_fit", "best_fit",
                                    "cost_aware"])
def test_sharded_kernels_h1024_bit_equal(policy, S):
    """The H = 1024 acceptance: each arm at S shards, per-step and chunk
    (C = 8), live mask off and on, against ``pivot_tpu``'s scan, slim
    and chunked kernels and its scan oracle."""
    sweep(policy, _h1024_inputs(), (S,), jax_cache=_H1024_JAX)


def test_sharded_contended_small():
    """Every task fits exactly one host: the two-stage reduce picks the
    same only-fit host as the flat argmin, every step."""
    x = contended_inputs(48, 16)
    for policy in ("opportunistic", "first_fit", "first_fit_strict",
                   "best_fit", "cost_aware"):
        sweep(policy, x, (2, 4, 8), live_opts=(False,), modes=("slim",),
              ca_modes=(CA_MODES[0], CA_MODES[3]))


def test_sharded_cost_aware_flag_grid():
    """The whole Cost-Aware flag grid (both bin packs × sort_hosts ×
    host_decay) at a small shape."""
    sweep("cost_aware", make_inputs(5, T=40, H=64, B=64, group_size=5),
          (4, 8), modes=("slim",), ca_modes=tuple(CA_MODES))


@pytest.mark.parametrize("policy", ["opportunistic", "first_fit",
                                    "first_fit_strict", "best_fit",
                                    "cost_aware"])
def test_sharded_risk_operands(policy):
    """A tiered eviction-risk vector: the minimum-risk tier and the
    lexicographic (risk, global index) order cross shard boundaries."""
    x = make_inputs(7, T=48, H=64, B=64, group_size=5)
    risk = np.random.default_rng(13).choice([0.0, 0.4, 1.5], size=64)
    sweep(policy, x, (2, 8), risk=risk, modes=("slim",),
          ca_modes=(CA_MODES[0], CA_MODES[2], CA_MODES[3]))


def test_sharded_masked_hosts_excluded_and_untouched():
    x = as_torch(make_inputs(2, T=48, H=64, B=64, group_size=5))
    live = live_mask(64)
    p, a = sh.first_fit_kernel_sharded(
        mesh(8), x["avail"], x["dem"], x["valid"],
        live=torch.from_numpy(live))
    placed = p.numpy()
    assert (placed >= 0).any()
    assert live[placed[placed >= 0]].all()
    assert torch.equal(a[~torch.from_numpy(live)],
                       x["avail"][~torch.from_numpy(live)])


def test_sharded_kernel_validation():
    m = mesh(8)
    x = as_torch(make_inputs(0, T=8, H=12, B=16))  # 12 % 8 != 0
    with pytest.raises(ValueError, match="does not divide"):
        sh.first_fit_kernel_sharded(m, x["avail"], x["dem"], x["valid"])
    x = as_torch(make_inputs(0, T=8, H=16, B=16))
    with pytest.raises(ValueError, match="phase2"):
        sh.first_fit_kernel_sharded(m, x["avail"], x["dem"], x["valid"],
                                    phase2="bogus")
    with pytest.raises(ValueError, match="realtime"):
        sh.cost_aware_kernel_sharded(
            m, *(x[k] for k in CA_ARGS),
            rt_bw_rows=torch.ones((2, 16), dtype=torch.float64),
            rt_bw_idx=torch.zeros(16, dtype=torch.int32))
    two = pm.host_sharded_mesh(devices=[CPU, torch.device("meta")])
    with pytest.raises(NotImplementedError, match="Queue 1, several cards"):
        sh.best_fit_kernel_sharded(two, x["avail"], x["dem"], x["valid"])
    with pytest.raises(ValueError, match="mesh names the device"):
        sh.best_fit_kernel_sharded(
            pm.host_sharded_mesh(devices=[torch.device("meta")] * 2),
            x["avail"], x["dem"], x["valid"])
    assert sh.sharded_twin_of(sh.cost_aware_impl) is \
        sh.cost_aware_kernel_sharded
    assert sh.sharded_twin_of(sh.cost_aware_impl, ("rt_bw_rows",)) is None
    assert sh.sharded_twin_of(object()) is None
    assert sh.sharded_twin_of(sh.fused_tick_run, (),
                              {"greedy": object()}) is None


def test_sharded_empty_batch_passthrough():
    x = as_torch(make_inputs(0, T=0, H=16, B=0))
    p, a = sh.best_fit_kernel_sharded(mesh(8), x["avail"], x["dem"],
                                      x["valid"])
    assert p.shape == (0,) and p.dtype == torch.int32
    assert torch.equal(a, x["avail"])


def test_two_stage_argmin_ties_and_nan():
    """Ties across shard boundaries go to the lowest global index, a NaN
    wins as the flat ``argmin``'s does, nothing fitting gives (0, False)."""
    inf = float("inf")
    offset = torch.arange(4) * 3
    for row in ([inf, 2.0, 5.0, 1.0, 7.0, 1.0, inf, 1.0, 9.0, 3.0, 1.0, 8.0],
                [4.0, 4.0, inf, 9.0, float("nan"), 2.0, float("nan"), 1.0,
                 0.5, 0.5, 6.0, 7.0],
                [inf] * 12):
        flat = torch.tensor(row, dtype=torch.float64)
        fit = flat < inf
        h, ok = sh._two_stage_argmin(flat.view(4, 3), fit.view(4, 3), offset)
        assert bool(ok) == bool(fit.any())
        assert int(h) == (int(torch.argmin(flat)) if bool(fit.any()) else 0)


# -- spans -------------------------------------------------------------------

_H_SPAN, _B_SPAN, _Z = 16, 32, 3

_SPAN_CONFIGS = {
    "opportunistic": dict(policy="opportunistic"),
    "first_fit": dict(policy="first-fit", strict=False),
    "first_fit_decreasing": dict(policy="first-fit", strict=False,
                                 decreasing=True),
    "best_fit": dict(policy="best-fit"),
    "cost_aware_ff": dict(policy="cost-aware", bin_pack="first-fit",
                          sort_tasks=True),
    "cost_aware_bf_decay": dict(policy="cost-aware", bin_pack="best-fit",
                                host_decay=True),
}

_SPAN_FIELDS = ("placements", "n_ready", "n_placed", "ticks_run",
                "n_stack_final", "stackpos", "avail")


def _span_inputs(H, B, k_max, seed=0):
    """``tests/test_shard.py::_span_inputs`` as numpy."""
    rng = np.random.default_rng(seed)
    avail = rng.uniform(1, 6, (H, 4))
    dem = rng.uniform(0.3, 2.5, (B, 4))
    arrive = np.zeros(B, np.int32)
    arrive[B - 12:B - 6] = 2
    arrive[B - 6:] = 5
    norms = np.sqrt((dem * dem).sum(1))
    uniforms = rng.random((k_max, B))
    tables = dict(
        cost_zz=rng.uniform(0.01, 0.2, (_Z, _Z)),
        bw_zz=rng.uniform(50, 500, (_Z, _Z)),
        host_zone=rng.integers(0, _Z, H).astype(np.int32),
        base_task_counts=rng.integers(0, 3, H).astype(np.int32),
        anchor_zone=rng.integers(0, _Z, B).astype(np.int32),
        bucket_id=rng.integers(0, 5, B).astype(np.int32),
    )
    return avail, dem, arrive, norms, uniforms, tables


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint64) if x.dtype == np.float64 else x


def assert_span_parity(config_kw, n_ticks, S, H=_H_SPAN, B=_B_SPAN,
                       live=None, check_reference=True):
    K = jt.span_bucket(n_ticks)
    avail, dem, arrive, norms, uniforms, tables = _span_inputs(H, B, K)
    kw = dict(config_kw)
    if kw["policy"] == "opportunistic":
        kw["uniforms"] = uniforms
    kw["sort_norm"] = norms
    if kw["policy"] == "cost-aware":
        kw.update(tables)
    kw["live"] = live
    host = {"cost_seg"}  # a host operand (``SPAN_HOST_OPERANDS``)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    pkw = {k: (torch.from_numpy(np.array(v))
               if isinstance(v, np.ndarray) and k not in host else v)
           for k, v in kw.items()}
    want = jt.fused_tick_run(jnp.asarray(avail), jnp.asarray(dem),
                             jnp.asarray(arrive),
                             jnp.asarray(n_ticks, jnp.int32), n_ticks=K,
                             **jkw)
    got = sh.sharded_fused_tick_run(
        mesh(S), torch.from_numpy(avail), torch.from_numpy(dem),
        torch.from_numpy(arrive), n_ticks, n_ticks=K, **pkw)
    ticks_run = int(want.ticks_run)
    for f in _SPAN_FIELDS:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if f == "n_ready":
            a, b = a[:ticks_run], b[:ticks_run]
        assert np.array_equal(_bits(a), _bits(b)), (config_kw, S, f)
    if check_reference:
        ref_p, _nr, ref_np, ref_avail = jt.reference_tick_run(
            avail, dem, arrive, K, **jkw)
        assert np.array_equal(np.asarray(ref_p), got.placements.numpy())
        assert np.array_equal(_bits(ref_avail), _bits(got.avail.numpy()))
        assert np.array_equal(np.asarray(ref_np), got.n_placed.numpy())


@pytest.mark.parametrize("S", [2, 8])
@pytest.mark.parametrize("config", sorted(_SPAN_CONFIGS))
def test_sharded_span_matches_jax_and_referee(config, S):
    assert_span_parity(_SPAN_CONFIGS[config], 8, S)


def test_sharded_span_live_mask():
    live = np.ones(_H_SPAN, bool)
    live[3] = live[10] = False
    for config in ("cost_aware_ff", "first_fit", "opportunistic"):
        assert_span_parity(_SPAN_CONFIGS[config], 8, 4, live=live)


def test_sharded_span_market_operands():
    """The market operands: host-sharded [K, H] risk rows, the [P, Z, Z]
    cost stack with its host [K] segment row."""
    K = jt.span_bucket(8)
    rng = np.random.default_rng(23)
    risk_rows = rng.choice([0.0, 0.3, 1.0], size=(K, _H_SPAN))
    market = dict(risk_rows=risk_rows,
                  cost_stack=rng.uniform(0.01, 0.3, (3, _Z, _Z)),
                  cost_seg=np.clip(np.arange(K) // 3, 0, 2).astype(np.int32))
    assert_span_parity(dict(_SPAN_CONFIGS["cost_aware_ff"], **market), 8, 8)
    assert_span_parity(dict(_SPAN_CONFIGS["first_fit"], risk_rows=risk_rows),
                       8, 4)
    assert_span_parity(dict(_SPAN_CONFIGS["opportunistic"],
                            risk_rows=risk_rows), 8, 2)


def test_sharded_span_h1024():
    assert_span_parity(_SPAN_CONFIGS["first_fit"], 8, 8, H=1024,
                       check_reference=False)


# -- policy -----------------------------------------------------------------


def _port_bench_batch(n_hosts, n_tasks, seed):
    """``bench._build_batch`` built from the port's own modules."""
    from pivot_tpu_torch.des import Environment
    from pivot_tpu_torch.infra.gen import RandomClusterGenerator
    from pivot_tpu_torch.infra.locality import ResourceMetadata
    from pivot_tpu_torch.sched import GlobalScheduler, TickContext
    from pivot_tpu_torch.sched.policies import CostAwarePolicy
    from pivot_tpu_torch.workload import Application, TaskGroup

    rng = np.random.default_rng(seed)
    meta = ResourceMetadata(seed=seed)
    gen = RandomClusterGenerator(
        Environment(), (16, 16), (128 * 1024,) * 2, (100, 100), (1, 1),
        meta=meta, seed=seed,
    )
    cluster = gen.generate(n_hosts)
    groups, remaining, gi = [], n_tasks, 0
    while remaining > 0:
        inst = int(min(remaining, rng.integers(1, 64)))
        groups.append(TaskGroup(
            str(gi), cpus=float(rng.choice([0.5, 1.0, 2.0, 4.0])),
            mem=float(rng.uniform(0.05, 0.9)) * 7864.32,
            runtime=float(rng.integers(1, 300)),
            output_size=float(rng.uniform(0, 0.9)) * 1000, instances=inst))
        remaining -= inst
        gi += 1
    app = Application("bench", groups)
    tasks = [t for g in app.groups for t in g.materialize_tasks()]
    for h in cluster.hosts:
        r = h.resource
        frac = rng.uniform(0, 0.7)
        r.cpus -= frac * r.t_cpus
        r.mem -= frac * r.t_mem
    scheduler = GlobalScheduler(cluster.env, cluster,
                                CostAwarePolicy(mode="naive"), seed=seed)
    return TickContext(scheduler, tasks, tick_seq=0)


def _f64(pol):
    pol.dtype = torch.float64
    return pol


def test_policy_enable_sharding_place_parity():
    """``enable_sharding`` through the whole policy path (grouping,
    padding, staging, unpadding) places as ``pivot_tpu``'s unsharded
    ``TpuCostAwarePolicy`` on one bench batch."""
    from conftest import load_root_module
    from pivot_tpu.sched.tpu import TpuCostAwarePolicy
    from pivot_tpu.utils import reset_ids as jreset
    from pivot_tpu_torch.sched.cuda import CudaCostAwarePolicy
    from pivot_tpu_torch.utils import reset_ids as preset

    bench = load_root_module("bench")
    jreset()
    jctx = bench._build_batch(64, 40, seed=3)
    single = TpuCostAwarePolicy(sort_tasks=True, sort_hosts=True)
    single.dtype = jnp.float64
    single.bind(jctx.scheduler)
    want = np.asarray(single.place(jctx))
    for S in (2, 8):
        preset()
        pctx = _port_bench_batch(64, 40, 3)
        pol = _f64(CudaCostAwarePolicy(sort_tasks=True, sort_hosts=True,
                                       device="cpu"))
        pol.enable_sharding(mesh(S))
        pol.bind(pctx.scheduler)
        assert np.array_equal(np.asarray(pol.place(pctx)), want), S
        assert pol.kernel_ticks == 0


def test_enable_sharding_validation():
    from pivot_tpu_torch.sched import cuda as pc
    from pivot_tpu_torch.sched.batch import DispatchBatcher
    from pivot_tpu_torch.search.weights import PolicyWeights

    m = mesh(8)
    with pytest.raises(ValueError, match="adaptive"):
        pc.CudaFirstFitPolicy(adaptive=True, device="cpu").enable_sharding(m)
    with pytest.raises(ValueError, match="use_kernel"):
        pc.CudaCostAwarePolicy(use_kernel=True,
                               device="cpu").enable_sharding(m)
    with pytest.raises(ValueError, match="realtime"):
        pc.CudaCostAwarePolicy(realtime_bw=True,
                               device="cpu").enable_sharding(m)
    learned = PolicyWeights(w_cost=2.0)
    with pytest.raises(ValueError, match="learned score exponents"):
        pc.CudaCostAwarePolicy(weights=learned,
                               device="cpu").enable_sharding(m)
    sharded_ca = pc.CudaCostAwarePolicy(device="cpu")
    sharded_ca.enable_sharding(m)
    with pytest.raises(ValueError, match="host-sharded"):
        sharded_ca.apply_weights(learned)
    # Batching × sharding needs a batcher on a 2-D mesh whose host axis
    # matches: a meshless batcher is refused in either order, with no
    # partial state left; a matching 2-D one composes.
    pol = pc.CudaFirstFitPolicy(device="cpu")
    pol.enable_batching(DispatchBatcher(1, device="cpu").client())
    with pytest.raises(ValueError, match="2-D replica x host mesh"):
        pol.enable_sharding(m)
    assert pol._mesh is None
    pol2 = pc.CudaFirstFitPolicy(device="cpu")
    pol2.enable_sharding(m)
    with pytest.raises(ValueError, match="2-D replica x host mesh"):
        pol2.enable_batching(DispatchBatcher(1, device="cpu").client())
    assert pol2._batch_client is None and pol2._mesh is m
    pol2.enable_batching(DispatchBatcher(1, mesh=pm.build_hybrid_mesh(
        host_parallel=8, devices=[CPU] * 16)).client())
    assert pol2._batch_client is not None
    # The sharded resident carry composes, in either order.
    pol2b = pc.CudaFirstFitPolicy(device="cpu")
    pol2b.enable_sharding(m)
    pol2b.enable_resident()
    assert pol2b._resident is not None and pol2b._mesh is m
    pol3 = pc.CudaFirstFitPolicy(device="cpu")
    pol3.enable_resident()
    pol3.enable_sharding(m)
    assert pol3._mesh is m and pol3._resident is not None
    # A mesh over two devices, or on another device than the policy's.
    with pytest.raises(NotImplementedError, match="Queue 1, several cards"):
        pc.CudaFirstFitPolicy(device="cpu").enable_sharding(
            pm.host_sharded_mesh(devices=[CPU, torch.device("meta")]))
    with pytest.raises(ValueError, match="mesh names the device"):
        pc.CudaFirstFitPolicy(device="cpu").enable_sharding(
            pm.host_sharded_mesh(devices=[torch.device("meta")] * 2))
    # H must divide the host axis — caught at bind.
    pol4 = pc.CudaFirstFitPolicy(device="cpu")
    pol4.enable_sharding(m)
    ctx = _port_bench_batch(12, 8, 3)  # 12 % 8 != 0
    with pytest.raises(ValueError, match="not divisible"):
        pol4.bind(ctx.scheduler)


#: The full DES run's cluster and workload: 8 hosts of 3 cpus (S = 8
#: divides it; the tasks queue, so pump-delivery windows become spans).
SIM = dict(n_hosts=8, cpus=3.0, n_apps=4)


def _jax_sim(policy_fn, n_hosts, cpus, n_apps):
    """``tests/test_shard.py``'s full DES run, unsharded."""
    from pivot_tpu.des import Environment
    from pivot_tpu.infra.locality import ResourceMetadata
    from pivot_tpu.infra.meter import Meter
    from pivot_tpu.sched import GlobalScheduler
    from pivot_tpu.utils import reset_ids

    from tests.test_tickloop import _build_cluster, _chain_apps

    reset_ids()
    env = Environment()
    meter = Meter(env, ResourceMetadata(seed=0))
    cluster = _build_cluster(env, meter, n_hosts=n_hosts, cpus=cpus)
    sched = GlobalScheduler(env, cluster, policy_fn(), seed=3, meter=meter,
                            fuse_spans=True)
    cluster.start()
    sched.start()
    apps = _chain_apps(n_apps)
    for a in apps:
        sched.submit(a)
    sched.stop()
    env.run()
    placements = sorted(
        (t.id, t.placement) for a in apps for g in a.groups for t in g.tasks)
    return (placements, [a.end_time for a in apps], sched._tick_seq,
            meter.total_scheduling_ops, env.now)


@functools.lru_cache(maxsize=None)
def _jax_sim_of(name):
    from pivot_tpu.sched import tpu as jp

    def f64(pol):
        pol.dtype = jnp.float64
        return pol

    return _jax_sim({
        "ff": lambda: f64(jp.TpuFirstFitPolicy(decreasing=True)),
        "ca": lambda: f64(jp.TpuCostAwarePolicy(sort_tasks=True,
                                                 sort_hosts=True)),
        "opp": lambda: f64(jp.TpuOpportunisticPolicy()),
    }[name], **SIM)


@pytest.mark.parametrize("S", [4, 8])
@pytest.mark.parametrize("name", ["ff", "ca", "opp"])
def test_policy_sharded_des_full_sim_parity(name, S):
    """A full DES run with the sharded tier (fused spans on) equals
    ``pivot_tpu``'s single-device run — placements, app end times, tick
    count, meter totals, ``env.now`` — and spans engage."""
    from pivot_tpu_torch.sched import cuda as pc

    from tests.test_torch_tickloop import _port_full_sim

    def policy():
        pol = _f64({
            "ff": lambda: pc.CudaFirstFitPolicy(decreasing=True,
                                                device="cpu"),
            "ca": lambda: pc.CudaCostAwarePolicy(
                sort_tasks=True, sort_hosts=True, device="cpu"),
            "opp": lambda: pc.CudaOpportunisticPolicy(device="cpu"),
        }[name]())
        pol.enable_sharding(mesh(S))
        return pol

    got, stats, pol = _port_full_sim(policy, fuse=True, **SIM)
    assert got == _jax_sim_of(name)
    assert stats["fused_spans"] > 0
    assert pol.dispatch_stats()["kernel_ticks"] == 0
    assert pol.dispatch_stats()["span_kernel_ticks"] == 0


# -- mesh -------------------------------------------------------------------


def test_mesh_shapes_and_errors():
    from pivot_tpu.parallel import mesh as jm

    m = pm.host_sharded_mesh(devices=[CPU] * 8)
    assert m.shape == dict(jm.host_sharded_mesh(8).shape) == {
        "replica": 1, "host": 8}
    assert pm.host_axis_size(m) == 8 and m.axis_names == ("replica", "host")
    assert m.devices.shape == (1, 8)
    assert pm.host_sharded_mesh(4, devices=[CPU] * 8).shape["host"] == 4
    r = pm.replica_mesh(devices=[CPU] * 8)
    assert r.shape == dict(jm.replica_mesh(8).shape) == {"replica": 8,
                                                         "host": 1}
    b = pm.build_mesh(devices=[CPU] * 8, host_parallel=2)
    assert b.shape == dict(jm.build_mesh(host_parallel=2).shape)
    assert pm.build_mesh(4, devices=[CPU] * 8).shape == {"replica": 4,
                                                         "host": 1}
    hyb = pm.build_hybrid_mesh(host_parallel=4, devices=[CPU] * 8)
    assert hyb.shape == dict(jm.build_hybrid_mesh(host_parallel=4).shape) \
        == {"replica_dcn": 1, "replica": 2, "host": 4}
    assert sh.mesh_is_2d(b) and not sh.mesh_is_2d(r)
    assert sh.mesh_device(m) == CPU
    with pytest.raises(ValueError, match=r"host_parallel=3 does not divide "
                                         r"8 devices"):
        pm.build_mesh(devices=[CPU] * 8, host_parallel=3)
    with pytest.raises(ValueError, match=r"host_parallel=3 does not divide "
                                         r"the 8 per-process devices"):
        pm.build_hybrid_mesh(host_parallel=3, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="axis names"):
        pm.Mesh([CPU, CPU], ("replica", "host"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pm.host_sharded_mesh(4)
