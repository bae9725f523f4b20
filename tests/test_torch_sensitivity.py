"""Sensitivity-gated dispatch in the port vs ``pivot_tpu``.

  * **the gate** — ``tests/test_sensitivity.py``'s hold-rule tests on
    ``pivot_tpu_torch.sched.sensitivity.SensitivityGatedCostAware``;
  * **the replica-batched passes** — ``first_fit_batched`` /
    ``best_fit_batched`` at R ∈ {1, 8}: every row bitwise equal to the
    unbatched port pass on that row and to ``jax.vmap`` of
    ``pivot_tpu``'s kernels under x64;
  * **``placement_sensitivity``** of the First-Fit, Best-Fit and
    Cost-Aware arms on the CPU in float64, with and without a market:
    bitwise ``pivot_tpu``'s on the same tick and seed;
  * **the experiments** — ``run_sensitivity`` at 8 hosts, 3 apps, R = 8,
    one seed, for the three ``--policy`` arms, with and without
    ``--market data/market/ci_seed.json``: every report field but the
    walls equals ``pivot_tpu``'s; ``num-apps`` writes files
    byte-identical to ``pivot_tpu``'s numpy arms.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pivot_tpu.experiments import cli as jcli
from pivot_tpu.infra.market import MarketSchedule as JMarket
from pivot_tpu.ops.kernels import best_fit_kernel, first_fit_kernel
from pivot_tpu.sched import tpu as jtpu
from pivot_tpu_torch.experiments import cli as pcli
from pivot_tpu_torch.infra.market import MarketSchedule as PMarket
from pivot_tpu_torch.ops import kernels as pk
from pivot_tpu_torch.sched import cuda as pcuda
from pivot_tpu_torch.sched.sensitivity import (
    SensitivityGatedCostAware,
    evaluate_candidates,
)

from tests.test_kernels import random_groups
from tests.test_torch_policy import ctx_pair, jax_dev, port_dev
from tests.test_torch_tickloop import bits

CI_MARKET = "data/market/ci_seed.json"


@pytest.fixture(autouse=True)
def _reset_port_ids():
    from pivot_tpu_torch.utils import reset_ids

    reset_ids()
    yield


# -- the gate (``tests/test_sensitivity.py`` on the port's classes) ----------


class _FakeInner:
    """Scripted placement_sensitivity: returns canned (nominal, stability)."""

    def __init__(self, script):
        self.script = list(script)
        self.calls = []

    def bind(self, scheduler):
        pass

    def placement_sensitivity(self, ctx, n_replicas, perturb, seed):
        self.calls.append(seed)
        nominal, stability = self.script.pop(0)
        placements = np.tile(nominal, (n_replicas, 1))
        return np.asarray(nominal), np.asarray(stability), placements


class _FakeCtx:
    def __init__(self, tasks, tick_seq):
        self.tasks = tasks
        self.tick_seq = tick_seq

    @property
    def n_tasks(self):
        return len(self.tasks)


def test_gate_holds_low_stability_then_forces_through():
    t0, t1 = object(), object()
    pol = SensitivityGatedCostAware(
        threshold=0.8, n_replicas=4, perturb=0.05, max_holds=1,
        inner=_FakeInner([([3, 5], [1.0, 0.5]), ([7], [0.4])]),
    )
    assert pol.place(_FakeCtx([t0, t1], 0)).tolist() == [3, -1]
    assert pol.place(_FakeCtx([t1], 1)).tolist() == [7]
    s = pol.summary()
    assert s["held"] == 1 and s["forced_through"] == 1
    assert s["placed_nominal"] == 3
    assert abs(s["mean_stability"] - (1.0 + 0.5 + 0.4) / 3) < 1e-12
    assert s["min_stability"] == 0.4
    assert s["ticks"] == 2 and s["sensitivity_wall_per_tick_s"] is not None


def test_gate_placement_clears_hold_history():
    t = object()
    pol = SensitivityGatedCostAware(
        threshold=0.8, max_holds=1,
        inner=_FakeInner([([2], [0.1]), ([2], [0.9]), ([4], [0.1])]),
    )
    assert pol.place(_FakeCtx([t], 0)).tolist() == [-1]
    assert pol.place(_FakeCtx([t], 1)).tolist() == [2]
    assert pol.place(_FakeCtx([t], 2)).tolist() == [-1]
    assert pol.summary()["held"] == 2


def test_gate_fresh_noise_seed_per_tick():
    inner = _FakeInner([([0], [1.0]), ([0], [1.0])])
    pol = SensitivityGatedCostAware(noise_seed=100, inner=inner)
    pol.place(_FakeCtx([object()], 0))
    pol.place(_FakeCtx([object()], 7))
    assert inner.calls == [100, 107]


@pytest.mark.parametrize("cls", [pcuda.CudaFirstFitPolicy,
                                 pcuda.CudaBestFitPolicy])
def test_vbp_placement_sensitivity_replica0_is_production(cls):
    """Replica 0's placements ARE the production ``place()`` decision,
    stability ∈ [0, 1]."""
    from pivot_tpu.infra.locality import ResourceMetadata as JMeta
    from pivot_tpu_torch.infra.locality import ResourceMetadata as PMeta

    ctx = ctx_pair((JMeta(seed=0), PMeta(seed=0)), random_groups(3), 3)[1]
    pol = port_dev(cls, decreasing=True)
    pol.bind(ctx.scheduler)
    avail0 = ctx.avail.copy()
    nominal, stability, placements = pol.placement_sensitivity(
        ctx, n_replicas=8, perturb=0.2, seed=0)
    ctx.avail[:] = avail0
    assert nominal.tolist() == pol.place(ctx).tolist()
    assert placements.shape == (8, ctx.n_tasks)
    assert 0.0 <= float(stability.min()) <= float(stability.max()) <= 1.0
    assert (stability[nominal >= 0] >= 1.0 / 8).all()


def test_gate_wraps_vbp_inner():
    pol = SensitivityGatedCostAware(
        inner=pcuda.CudaFirstFitPolicy(decreasing=True, device="cpu"))
    assert pol.name == "first_fit_cuda_sensitivity_gated"
    assert SensitivityGatedCostAware(
        device="cpu").name == "cost_aware_cuda_sensitivity_gated"
    with pytest.raises(TypeError):
        SensitivityGatedCostAware(inner=object())
    with pytest.raises(ValueError):
        SensitivityGatedCostAware(inner=object(), device="cpu")
    # evaluate_candidates is the search's library surface: on a tiny CPU
    # environment it returns evaluate_rows' scores.
    from pivot_tpu_torch.search.fitness import evaluate_rows, make_search_env

    env = make_search_env(n_hosts=6, seed=2, n_apps=2, horizon=200.0,
                          n_replicas=2, dtype=torch.float64, device="cpu")
    pop = np.array([[1.0, 1.0, 1.0, 0.0, 1.0], [2.0, 0.5, 1.0, 3.0, 1.0]])
    want, _ = evaluate_rows(pop, env)
    np.testing.assert_array_equal(evaluate_candidates(pop, env), want)
    assert np.isfinite(want).all()


# -- the replica-batched passes ------------------------------------------------


def batched_inputs(R, seed=0, H=24, T=40):
    rng = np.random.default_rng(seed)
    avail = rng.uniform(0.5, 6, (H, 4))
    avail_r = avail[None] * rng.uniform(0.8, 1.2, (R, H, 1))
    avail_r[0] = avail
    dem = rng.uniform(0.2, 2.0, (T, 4))
    valid = rng.random(T) < 0.85
    risk = rng.choice([0.0, 0.4, 1.5], size=H)
    return avail_r, dem, valid, risk


@pytest.mark.parametrize("with_risk", [False, True])
@pytest.mark.parametrize("R", [1, 8])
@pytest.mark.parametrize("kind", ["first-fit", "first-fit-strict",
                                  "best-fit"])
def test_batched_pass_matches_rows_and_jax_vmap(kind, R, with_risk):
    avail_r, dem, valid, risk = batched_inputs(R, seed=R)
    risk = risk if with_risk else None
    t = torch.from_numpy
    prisk = None if risk is None else t(risk)
    jrisk = None if risk is None else jnp.asarray(risk)
    if kind == "best-fit":
        got_p, got_a = pk.best_fit_batched(t(avail_r), t(dem), t(valid),
                                           risk=prisk)
        rows = [pk.best_fit_impl(t(a), t(dem), t(valid), risk=prisk)
                for a in avail_r]
        want = jax.vmap(lambda a: best_fit_kernel(
            a, jnp.asarray(dem), jnp.asarray(valid), risk=jrisk))(
                jnp.asarray(avail_r))
    else:
        strict = kind == "first-fit-strict"
        got_p, got_a = pk.first_fit_batched(t(avail_r), t(dem), t(valid),
                                            strict=strict, risk=prisk)
        rows = [pk.first_fit_impl(t(a), t(dem), t(valid), strict=strict,
                                  risk=prisk) for a in avail_r]
        want = jax.vmap(lambda a: first_fit_kernel(
            a, jnp.asarray(dem), jnp.asarray(valid), strict=strict,
            risk=jrisk))(jnp.asarray(avail_r))
    assert got_p.shape == (R, dem.shape[0]) and got_a.shape == avail_r.shape
    for r, (p, a) in enumerate(rows):
        assert torch.equal(got_p[r], p), r
        assert np.array_equal(bits(got_a[r].numpy()), bits(a.numpy())), r
    assert np.array_equal(got_p.numpy(), np.asarray(want[0]))
    assert np.array_equal(bits(got_a.numpy()), bits(np.asarray(want[1])))
    assert int((got_p >= 0).sum()) >= R * int(valid.sum()) // 4
    # A host step bound (the sensitivity path's n_eff) changes nothing.
    n = int(np.flatnonzero(valid)[-1]) + 1
    fn = pk.best_fit_batched if kind == "best-fit" else (
        lambda *a, **k: pk.first_fit_batched(
            *a, strict=kind == "first-fit-strict", **k))
    bound_p, _ = fn(t(avail_r), t(dem), t(valid), risk=prisk, n_bound=n)
    assert torch.equal(bound_p, got_p)


# -- placement_sensitivity of the three arms ------------------------------------


ARMS = [
    (jtpu.TpuFirstFitPolicy, pcuda.CudaFirstFitPolicy, dict(decreasing=True)),
    (jtpu.TpuFirstFitPolicy, pcuda.CudaFirstFitPolicy, {}),
    (jtpu.TpuBestFitPolicy, pcuda.CudaBestFitPolicy, {}),
    (jtpu.TpuCostAwarePolicy, pcuda.CudaCostAwarePolicy,
     dict(sort_tasks=True, sort_hosts=True)),
]


@pytest.mark.parametrize("market", [False, True])
@pytest.mark.parametrize("arm", ARMS,
                         ids=lambda a: f"{a[1].__name__}{sorted(a[2])}")
def test_placement_sensitivity_matches_reference(arm, market):
    """The same numpy noise draw through both packages' batched passes
    (float64); with a market, at a late segment and with the risk term,
    so the Cost-Aware replicas score with the price-scaled slice."""
    from pivot_tpu.infra.locality import ResourceMetadata as JMeta
    from pivot_tpu_torch.infra.locality import ResourceMetadata as PMeta

    jcls, pcls, kw = arm
    metas = JMeta(seed=0), PMeta(seed=0)
    if market:
        kw = dict(kw, risk_weight=0.5, rework_cost=3.0)
    jp, pp = jax_dev(jcls, **kw), port_dev(pcls, **kw)
    jctx, pctx = ctx_pair(metas, random_groups(5), 5)
    if market:
        jctx.scheduler.market = JMarket.load(CI_MARKET)
        pctx.scheduler.market = PMarket.load(CI_MARKET)
        jctx.env_now = pctx.env_now = 500.0
    jp.bind(jctx.scheduler)
    pp.bind(pctx.scheduler)
    want = jp.placement_sensitivity(jctx, n_replicas=8, perturb=0.15, seed=3)
    got = pp.placement_sensitivity(pctx, n_replicas=8, perturb=0.15, seed=3)
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b)
    assert jctx.visit_order == pctx.visit_order
    assert np.any(got[1] < 1.0)
    if market and pcls is pcuda.CudaCostAwarePolicy:
        assert list(pp._market_cost_dev) == [
            pctx.scheduler.market.segment(500.0)]


# -- the experiments ---------------------------------------------------------------


def _without_walls(report):
    r = json.loads(json.dumps(report))
    r.pop("gate_cost")
    for s in r["per_seed"]:
        for k in ("baseline_wall_s", "gated_wall_s"):
            s.pop(k)
        for k in ("sensitivity_wall_s", "sensitivity_wall_per_tick_s"):
            s["gate"].pop(k)
    return r


@pytest.mark.parametrize("market", [False, True])
@pytest.mark.parametrize("policy", ["cost-aware", "vbp", "best-fit"])
def test_run_sensitivity_matches_reference(tmp_path, monkeypatch, policy,
                                           market):
    """The paired experiment through the port's CLI on the CPU in float64
    and through ``pivot_tpu``'s under x64: the same report, walls aside,
    and ``report.json`` on disk."""
    from pivot_tpu.utils import reset_ids as jreset
    from pivot_tpu_torch.utils import reset_ids as preset

    argv = ("--num-hosts 8 --job-dir ./data/jobs --output-dir {out} "
            "sensitivity --num-apps 3 --replicas 8 --des-seeds 1 "
            f"--policy {policy}").split()
    if market:
        argv += ["--market", CI_MARKET]
    monkeypatch.setattr(jtpu._DevicePolicyBase, "dtype", jnp.float64)
    jreset()
    want = jcli.run_sensitivity(jcli.parse_args(
        [a.format(out=tmp_path / "ref") for a in argv]))
    preset()
    got = pcli.run_sensitivity(pcli.parse_args(
        [a.format(out=tmp_path / "port") for a in argv]),
        torch_device="cpu", dtype="float64")
    assert _without_walls(got) == _without_walls(want)
    assert got["per_seed"][0]["gate"]["ticks"] > 0
    assert got["gate_cost"]["mean_sensitivity_wall_per_tick_s"] is not None
    (stamp,) = os.listdir(tmp_path / "port" / "sensitivity")
    with open(tmp_path / "port" / "sensitivity" / stamp / "report.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))


def test_num_apps_matches_reference_numpy(tmp_path):
    """``num-apps`` on ``--device cuda`` (CPU tensors, float64) writes
    every arm's four files byte-identical to ``pivot_tpu``'s numpy arms,
    at each entry of ``--num-apps-list``."""
    args = ("--num-hosts 12 --seed 2 --trace-limit 1 --output-dir {out} "
            "{dev} num-apps --num-apps-list 4 9").split()

    def parse(mod, out, dev):
        return mod.parse_args([a.format(out=out, dev=dev) for a in args
                               if a.format(out=out, dev=dev)])

    ref_dir = jcli.run_num_apps(parse(jcli, tmp_path / "ref",
                                      "--device=numpy"))
    exp_dir, summaries = pcli.run_num_apps(
        parse(pcli, tmp_path / "port", "--device=cuda"),
        torch_device="cpu", dtype="float64")
    assert len(summaries) == 6
    assert all(s["dispatch"]["device_ticks"] > 0 for s in summaries)
    n_files = 0
    for n in ("4", "9"):
        for arm in ("Opportunistic", "VBP", "Cost-Aware"):
            for name in ("general.json", "transfers.json", "scheduler.json",
                         "host_usage.json"):
                paths = [os.path.join(d, "data", n, "0", arm, name)
                         for d in (ref_dir, exp_dir)]
                with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
                    assert a.read() == b.read(), paths[1]
                n_files += 1
    assert n_files == 24
    assert pcli.parse_args(["num-apps", "--num-apps-list", "5"]) \
        .host_hourly_rate == 0.932
