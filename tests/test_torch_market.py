"""The port's spot market vs ``pivot_tpu``'s (``infra/market.py``).

  * **the environment** — ``pivot_tpu_torch.infra.market.MarketSchedule``
    draws the same market from the same seed as ``pivot_tpu``'s (equal
    ``dumps()``), carries a reference market over unchanged
    (``loads(dumps())``), and gives bitwise-equal segment rows, hazard
    vectors, cost slices and cost stacks; ``ChaosSchedule.generate`` and
    ``spot_schedule`` give equal plans;
  * **market ticks** — the four ``Cuda*Policy`` classes on the CPU in
    float64 with a market attached, at ``risk_weight`` ∈ {0, 0.5} and
    several segments, place exactly as ``pivot_tpu``'s ``Tpu*Policy``
    under x64;
  * **market spans** — the port's ``fused_tick_run`` with ``risk_rows``
    and (Cost-Aware) ``cost_stack`` / ``cost_seg`` equals ``pivot_tpu``'s
    and the port's ``reference_tick_run`` bitwise
    (``tests/test_market.py::test_fused_span_market_parity``), and reads
    nothing from the device inside the span;
  * **a whole run** — a DES run under a live market and the risk term
    writes output files byte-identical to ``pivot_tpu``'s numpy arm, with
    spans engaged.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pivot_tpu.infra.faults import ChaosSchedule as JChaos
from pivot_tpu.infra.locality import ResourceMetadata as JMeta
from pivot_tpu.infra.market import MarketSchedule as JMarket
from pivot_tpu.ops import tickloop as jt
from pivot_tpu.sched import tpu as jtpu
from pivot_tpu_torch.infra.faults import ChaosSchedule as PChaos
from pivot_tpu_torch.infra.locality import ResourceMetadata as PMeta
from pivot_tpu_torch.infra.market import MarketSchedule as PMarket
from pivot_tpu_torch.ops import tickloop as tt
from pivot_tpu_torch.sched import cuda as pcuda

from tests.test_kernels import random_groups
from tests.test_torch_policy import ctx_pair, jax_dev, port_dev
from tests.test_torch_tickloop import HostRead, bits, no_host_reads

CI_MARKET = "data/market/ci_seed.json"


@pytest.fixture(scope="module")
def metas():
    return JMeta(seed=0), PMeta(seed=0)


@pytest.fixture(autouse=True)
def _reset_port_ids():
    from pivot_tpu_torch.utils import reset_ids

    reset_ids()
    yield


def market_pair(metas, seed=5, horizon=400.0, **kw):
    """The same generated market from each package."""
    kw = dict(dict(n_segments=4, hot_fraction=0.3, hot_hazard=1e-2,
                   base_hazard=1e-4), **kw)
    return (JMarket.generate(metas[0], seed=seed, horizon=horizon, **kw),
            PMarket.generate(metas[1], seed=seed, horizon=horizon, **kw))


# -- the environment -----------------------------------------------------------


@pytest.mark.parametrize("seed,n_segments", [(0, 1), (5, 4), (11, 8)])
def test_market_generate_matches_reference(metas, seed, n_segments):
    jm, pm = market_pair(metas, seed=seed, n_segments=n_segments)
    assert pm.dumps() == jm.dumps()
    assert PMarket.loads(jm.dumps()) == pm
    assert pm.diff(PMarket.loads(jm.dumps())) == []


def test_ci_market_arrays_match_reference(metas):
    jm, pm = JMarket.load(CI_MARKET), PMarket.load(CI_MARKET)
    assert PMarket.loads(jm.dumps()).dumps() == pm.dumps()
    ts = np.concatenate([np.linspace(-5.0, 900.0, 97), jm.times])
    assert np.array_equal(pm.segment_indices(ts), jm.segment_indices(ts))
    host_zones = np.arange(len(metas[0].zones)).repeat(3)
    for t in ts[::7]:
        assert pm.segment(t) == jm.segment(t)
        assert np.array_equal(bits(pm.hazard_vector(t, host_zones)),
                              bits(jm.hazard_vector(t, host_zones)))
        assert np.array_equal(bits(pm.cost_matrix_at(t, metas[1])),
                              bits(jm.cost_matrix_at(t, metas[0])))
    assert np.array_equal(bits(pm.cost_tensor(metas[1])),
                          bits(jm.cost_tensor(metas[0])))


def test_chaos_and_spot_schedules_match_reference(metas):
    jctx, pctx = ctx_pair(metas, random_groups(1), 1)
    jc, pc = jctx.scheduler.cluster, pctx.scheduler.cluster
    kw = dict(n_domain_outages=2, n_preemptions=5, n_stragglers=3,
              n_partitions=1)
    assert (PChaos.generate(pc, seed=4, horizon=500.0, **kw).dumps()
            == JChaos.generate(jc, seed=4, horizon=500.0, **kw).dumps())
    jm, pm = market_pair(metas, hot_hazard=5e-2, base_hazard=1e-3)
    want = jm.spot_schedule(jc, seed=2)
    assert len(want.events) > 0
    assert pm.spot_schedule(pc, seed=2).dumps() == want.dumps()


# -- market ticks ----------------------------------------------------------------


POLICIES = [
    (jtpu.TpuOpportunisticPolicy, pcuda.CudaOpportunisticPolicy, {}),
    (jtpu.TpuFirstFitPolicy, pcuda.CudaFirstFitPolicy, dict(decreasing=True)),
    (jtpu.TpuBestFitPolicy, pcuda.CudaBestFitPolicy, {}),
    (jtpu.TpuCostAwarePolicy, pcuda.CudaCostAwarePolicy,
     dict(sort_tasks=True, sort_hosts=True)),
    (jtpu.TpuCostAwarePolicy, pcuda.CudaCostAwarePolicy,
     dict(bin_pack="best-fit", host_decay=True)),
]


@pytest.mark.parametrize("risk_weight", [0.0, 0.5])
@pytest.mark.parametrize("pols", POLICIES,
                         ids=lambda p: f"{p[1].__name__}{sorted(p[2])}")
def test_market_ticks_match_reference(metas, pols, risk_weight):
    """Per-tick placements under a market, at instants in three of its
    segments: bitwise those of ``pivot_tpu``'s device policy."""
    jcls, pcls, kw = pols
    jm, pm = market_pair(metas, hot_hazard=0.5, base_hazard=0.05)
    jp = jax_dev(jcls, risk_weight=risk_weight, rework_cost=3.0, **kw)
    pp = port_dev(pcls, risk_weight=risk_weight, rework_cost=3.0, **kw)
    got, want = [], []
    for seed, t in enumerate((0.0, 150.0, 399.0)):
        jctx, pctx = ctx_pair(metas, random_groups(seed + 4), seed + 4)
        for ctx, market, pol in ((jctx, jm, jp), (pctx, pm, pp)):
            ctx.scheduler.market = market
            ctx.env_now = t
            pol.bind(ctx.scheduler)
        want.append(np.asarray(jp.place(jctx)).tolist())
        got.append(pp.place(pctx).tolist())
        if risk_weight:
            assert pctx.hazard_vector is not None
    assert got == want
    if pcls is pcuda.CudaCostAwarePolicy:  # the last tick's segment, staged
        assert list(pp._market_cost_dev) == [pm.segment(399.0)]


# -- market spans ----------------------------------------------------------------


H, B, Z, P = 24, 24, 4, 3

SPAN_CONFIGS = [
    dict(policy="opportunistic"),
    dict(policy="first-fit"),
    dict(policy="best-fit", decreasing=True),
    dict(policy="cost-aware", bin_pack="first-fit", sort_tasks=True),
    dict(policy="cost-aware", bin_pack="best-fit", host_decay=True),
]


def market_span_inputs(config, K=8, seed=11):
    """``tests/test_market.py::test_fused_span_market_parity``'s inputs as
    numpy: ``(avail, dem, arrive, Kb, kw)``; ``cost_seg`` stays a host
    array."""
    rng = np.random.default_rng(seed)
    avail = rng.uniform(1, 6, (H, 4))
    dem = rng.uniform(0.3, 2.2, (B, 4))
    arrive = np.zeros(B, np.int32)
    arrive[12:18] = 2
    arrive[18:24] = 4
    Kb = tt.span_bucket(K)
    kw = dict(config)
    kw["risk_rows"] = rng.choice([0.0, 0.3, 1.0], size=(Kb, H))
    if kw["policy"] == "opportunistic":
        kw["uniforms"] = rng.random((Kb, B))
    kw["sort_norm"] = np.sqrt((dem * dem).sum(1))
    if kw["policy"] == "cost-aware":
        r = np.random.default_rng(3)
        kw.update(
            cost_zz=r.uniform(0.01, 0.2, (Z, Z)),
            bw_zz=r.uniform(50, 500, (Z, Z)),
            host_zone=r.integers(0, Z, H).astype(np.int32),
            base_task_counts=r.integers(0, 3, H).astype(np.int32),
            anchor_zone=rng.integers(0, Z, B).astype(np.int32),
            bucket_id=rng.integers(0, 5, B).astype(np.int32),
            cost_stack=rng.uniform(0.01, 0.3, (P, Z, Z)),
            cost_seg=np.clip(np.arange(Kb) // 3, 0, P - 1).astype(np.int32),
        )
    return avail, dem, arrive, K, Kb, kw


def port_kw(kw, dtype=torch.float64):
    return {k: (v if k == "cost_seg" or not isinstance(v, np.ndarray)
                else torch.from_numpy(v).to(dtype)
                if v.dtype == np.float64 else torch.from_numpy(v))
            for k, v in kw.items()}


@pytest.mark.parametrize("config", SPAN_CONFIGS,
                         ids=lambda c: c["policy"] + c.get("bin_pack", ""))
def test_market_span_matches_reference_and_referee(config):
    avail, dem, arrive, K, Kb, kw = market_span_inputs(config)
    want = jt.fused_tick_run(
        jnp.asarray(avail), jnp.asarray(dem), jnp.asarray(arrive),
        jnp.asarray(K, jnp.int32), n_ticks=Kb,
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    pkw = port_kw(kw)
    args = (torch.from_numpy(avail), torch.from_numpy(dem),
            torch.from_numpy(arrive))
    got = tt.fused_tick_run(*args, K, n_ticks=Kb, **pkw)
    for f in ("placements", "n_placed", "ticks_run", "stackpos", "avail"):
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert np.array_equal(bits(a), bits(b)), f
    ref_p, _nr, ref_np, ref_avail = tt.reference_tick_run(*args, Kb, **pkw)
    assert np.array_equal(ref_p, got.placements.numpy())
    assert np.array_equal(ref_np, got.n_placed.numpy())
    assert np.array_equal(bits(ref_avail), bits(got.avail.numpy()))
    if config["policy"] == "cost-aware":
        # The stack is read: a flat stack equal to cost_zz changes the run.
        flat = dict(pkw, cost_stack=pkw["cost_zz"][None].expand(P, Z, Z))
        plain = tt.fused_tick_run(*args, K, n_ticks=Kb, **flat)
        assert not torch.equal(plain.placements, got.placements)


@pytest.mark.parametrize("config", [SPAN_CONFIGS[1], SPAN_CONFIGS[3]],
                         ids=["first-fit", "cost-aware"])
def test_market_span_reads_nothing_from_the_device(config):
    """Risk rows and the cost stack indexed by the host segment row: a
    whole span with every tensor→host path patched to raise."""
    from tests.test_torch_tickloop import stub_greedy

    avail, dem, arrive, K, Kb, kw = market_span_inputs(config)
    dtype = torch.float32 if config["policy"] == "cost-aware" else \
        torch.float64
    pkw = port_kw(kw, dtype)
    if config["policy"] == "cost-aware":
        pkw["greedy"] = stub_greedy
    args = (torch.from_numpy(avail).to(dtype), torch.from_numpy(dem).to(dtype),
            torch.from_numpy(arrive))
    n_bound = tt.span_step_bounds(arrive, K)
    if config["policy"] == "cost-aware":  # the guard bites a device row
        with pytest.raises(HostRead):
            with no_host_reads():
                tt.fused_tick_run(
                    *args, K, n_ticks=Kb, n_bound=n_bound,
                    **dict(pkw, cost_seg=torch.from_numpy(kw["cost_seg"])))
    with no_host_reads():
        res = tt.fused_tick_run(*args, K, n_ticks=Kb, n_bound=n_bound, **pkw)
    assert int((res.placements >= 0).sum()) > 0


# -- a whole run -------------------------------------------------------------------


def _outputs(d):
    out = {}
    for name in ("general.json", "transfers.json", "scheduler.json",
                 "host_usage.json"):
        with open(os.path.join(d, "mparity", name), "rb") as f:
            out[name] = f.read()
    return out


def test_full_sim_market_matches_reference_numpy(metas, tmp_path):
    """``tests/test_market.py::test_full_sim_market_parity_cpu_vs_device``
    through the port: the Cost-Aware device policy on the CPU in float64
    under a live market with the risk term (per-tick cost slices and
    hazard vectors, span risk rows and cost stack) writes the same four
    files as ``pivot_tpu``'s numpy policy, byte for byte."""
    from pivot_tpu.des import Environment as JEnv
    from pivot_tpu.experiments.runner import ExperimentRun as JRun
    from pivot_tpu.infra.gen import RandomClusterGenerator as JGen
    from pivot_tpu.sched.policies import CostAwarePolicy
    from pivot_tpu.utils import reset_ids as jreset
    from pivot_tpu_torch.des import Environment as PEnv
    from pivot_tpu_torch.experiments.runner import ExperimentRun as PRun
    from pivot_tpu_torch.infra.gen import RandomClusterGenerator as PGen
    from pivot_tpu_torch.utils import reset_ids as preset

    jm, pm = market_pair(metas, hot_hazard=2e-2, base_hazard=1e-3,
                         horizon=3000.0, n_segments=8)
    trace = "data/jobs/jobs-5000-200-86400-172800.npz"
    shape = ((16, 16), (128 * 1024,) * 2, (100, 100), (1, 1))
    risk = dict(risk_weight=1.0, rework_cost=50.0)

    jreset()
    jcluster = JGen(JEnv(), *shape, meta=metas[0], seed=0).generate(16)
    JRun("mparity", jcluster, CostAwarePolicy(
        sort_tasks=True, sort_hosts=True, mode="numpy", **risk), trace,
        n_apps=30, seed=9, market=jm, data_dir=str(tmp_path / "ref")).run()
    preset()
    pcluster = PGen(PEnv(), *shape, meta=metas[1], seed=0).generate(16)
    pol = port_dev(pcuda.CudaCostAwarePolicy, sort_tasks=True,
                   sort_hosts=True, **risk)
    summary = PRun("mparity", pcluster, pol, trace, n_apps=30, seed=9,
                   market=pm, data_dir=str(tmp_path / "port")).run()
    assert _outputs(tmp_path / "port") == _outputs(tmp_path / "ref")
    assert summary["spans"]["fused_spans"] > 0
    assert len(pol._market_cost_dev) > 1  # ticks in several segments
    assert pol._market_stack_dev is not None  # spans scored on the stack
