"""The ensemble rollout's placement chain: the plain chain, its tables and
the hand kernel's wrapper (``csrc/ensemble_chain.cu``, which runs only on
the card: ``chip_smoke.py`` phases 6 and 20 hold it against the plain
chain there).

  * **parity on the CPU in float64**: ``_rollout_segment`` runs its chain
    through ``parallel/ensemble/tick.py::_chain_plain`` (a spy counts the
    calls; the wrapper's CPU route on the recorded operands gives the
    same bits, its own snapshot against the pooled one) and equals
    ``pivot_tpu``'s rollout bit for bit (egress within rtol 1e-12,
    ``tests/test_torch_ensemble.py`` says why) — the four arms with and
    without the eviction-risk row (``_run_rows`` with a
    ``MarketSchedule.generate`` hazard), cost-aware with score exponents
    and cost-aware with realtime scoring; 24 hosts, 6 apps, R = 4;
  * **the round-trip tables**: the ``[Z, Z]`` tables the chain takes,
    gathered by zone, are the ``[Z, H]`` tables bit for bit (and under
    ``xla_pow`` the ``[R, Z, H]`` ones), in float32 and float64;
  * **the wrapper's contract**: wrong dtypes, shapes and operands raise on
    CPU tensors, another device raises, and the launch site refuses CPU
    tensors; on the CPU the wrapper is the plain chain and counts no
    launch;
  * **the launch shape** ``_chain_config``: the form at each H (the
    shared-memory form up to its largest H at the CLI's 31 zones, global
    memory one host past it), its shared bytes under the H100's opt-in
    and equal to the CUDA source's own formula (``analysis/
    kernel_budget.py`` evaluates it).
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
from pivot_tpu.parallel import ensemble as JE
from pivot_tpu_torch.analysis import kernel_budget
from pivot_tpu_torch.des import Environment
from pivot_tpu_torch.infra import Cluster, Host, Storage
from pivot_tpu_torch.infra.locality import ResourceMetadata
from pivot_tpu_torch.ops import cuda_kernels as ck
from pivot_tpu_torch.ops.kernels import DeviceTopology
from pivot_tpu_torch.parallel import ensemble as E
from pivot_tpu_torch.parallel.ensemble import libm, prng, tick

from tests.test_ensemble import _random_apps
from tests.test_torch_ensemble import (
    POLICIES,
    _cluster,
    _pair_inputs,
    assert_results_equal,
)
from tests.test_torch_sweeps import _hazard, _rows

N_HOSTS = 24
N_APPS = 6
R = 4


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """``pivot_tpu``'s row runner leaves JAX's caches in a state where a
    jitted function first traced afterwards retraces on every call
    (``tests/test_torch_sweeps.py`` says so): clear them when this module
    ends."""
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
    return (_cluster(JEnvironment, JHost, JStorage, JCluster, JMeta,
                     n=N_HOSTS),
            _cluster(Environment, Host, Storage, Cluster, ResourceMetadata,
                     n=N_HOSTS))


@pytest.fixture(scope="module")
def pair(clusters):
    apps = _random_apps(np.random.default_rng(23), N_APPS, (2, 5),
                        name="k")
    return _pair_inputs(*clusters, apps,
                        [float(6 * i) for i in range(len(apps))], "float64")


class ChainSpy:
    """Wraps ``tick._chain_plain``: counts its calls and keeps the
    operands (cloned before the call) and outputs of the first few that
    place, so that the wrapper's CPU route can be held against them."""

    keep = 4

    def __init__(self, monkeypatch):
        self.calls = 0
        self.kept = []
        plain = tick._chain_plain

        def spy(policy, avail, *args, **kw):
            self.calls += 1
            before = avail.clone()
            out = plain(policy, avail, *args, **kw)
            if len(self.kept) < self.keep and bool((out[0] >= 0).any()):
                self.kept.append((policy, before, args, {
                    k: v for k, v in kw.items()
                    if k not in ("n_steps", "snap")}, out, avail.clone()))
            return out
        monkeypatch.setattr(tick, "_chain_plain", spy)

    def check_wrapper(self):
        """The wrapper's CPU route (the plain chain with its own snapshot
        and step count) on each kept call's operands: the same bits, and
        no launch counted."""
        assert self.calls and self.kept
        ck.reset_launches()
        for policy, before, args, kw, (pl, delay), after in self.kept:
            avail = before.clone()
            got_pl, got_delay = ck.ensemble_chain_cuda(policy, avail, *args,
                                                       **kw)
            assert torch.equal(got_pl, pl) and torch.equal(got_delay, delay)
            assert torch.equal(avail, after)
        assert ck.LAUNCHES["ensemble_chain"] == 0 and not ck.LAUNCHES_CHAIN


@pytest.mark.parametrize("risk", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_chain_plain_parity_f64(pair, clusters, monkeypatch, policy, risk):
    """Each arm with and without the risk row, through the row runner."""
    (jw, jtopo, ja0, jsz), (pw, ptopo, pa0, psz) = pair
    spy = ChainSpy(monkeypatch)
    (prt, parr, pra), (jrt, jarr, jra) = _rows(pw, psz, jw, 1, R)
    extra, jextra = {}, {}
    if risk:
        phaz, jhaz = _hazard(clusters[1], ptopo)
        rc = np.full(R, 0.02)
        extra.update(risk_coeff=torch.tensor(rc), hazard=phaz)
        jextra.update(risk_coeff=jnp.asarray(rc), hazard=jhaz)
    if policy == "opportunistic":
        u = E._opportunistic_uniforms(prng.PRNGKey(9), R, pw.n_tasks,
                                      torch.float64, "cpu")
        extra["task_u"] = u
        jextra["task_u"] = jnp.asarray(u.numpy())
    avail = pa0.expand(R, *pa0.shape)
    got = E._run_rows(avail, prt, parr, pra, pw, ptopo, 5.0, 160, None,
                      policy, False, False, **extra)
    want = JE._run_rows(jnp.broadcast_to(ja0, (R,) + ja0.shape), jrt, jarr,
                        jra, jw, jtopo, 5.0, 160, None, policy, False, False,
                        forms="indexed", **jextra)
    assert_results_equal(got, want)
    assert got.n_unfinished.max().item() == 0
    spy.check_wrapper()


def test_chain_plain_parity_f64_score_exponents(pair, monkeypatch):
    """Cost-aware with per-row score exponents: ``[R, Z, Z]`` pow tables
    and the snapshot's ``norm ** w_norm``."""
    (jw, jtopo, ja0, jsz), (pw, ptopo, pa0, psz) = pair
    spy = ChainSpy(monkeypatch)
    (prt, parr, pra), (jrt, jarr, jra) = _rows(pw, psz, jw, 1, R)
    sp = np.array([[1, 1, 1], [1.5, 0.8, 0.5], [0.0, 2.0, 3.0],
                   [0.5, 0.0, 0.0]])
    avail = pa0.expand(R, *pa0.shape)
    got = E._run_rows(avail, prt, parr, pra, pw, ptopo, 5.0, 160, None,
                      "cost-aware", False, False,
                      score_params=torch.tensor(sp))
    want = JE._run_rows(jnp.broadcast_to(ja0, (R,) + ja0.shape), jrt, jarr,
                        jra, jw, jtopo, 5.0, 160, None, "cost-aware", False,
                        False, forms="indexed", score_params=jnp.asarray(sp))
    assert_results_equal(got, want)
    spy.check_wrapper()
    Z = ptopo.cost.shape[0]
    assert all(kw["cost_zz"].shape == (R, Z, Z) and kw["w_norm"] is not None
               for *_a, kw, _o, _v in spy.kept)


def test_chain_plain_parity_f64_realtime(pair, monkeypatch):
    """Cost-aware with realtime scoring: the bandwidth operand is the
    tick's ``[R, Z, H]`` backlog-discounted table."""
    (jw, jtopo, ja0, jsz), (pw, ptopo, pa0, psz) = pair
    spy = ChainSpy(monkeypatch)
    kw = dict(n_replicas=R, tick=5.0, max_ticks=160, perturb=0.1,
              congestion=True, realtime_scoring=True)
    got = E.rollout(prng.PRNGKey(4), pa0, pw, ptopo, psz, **kw)
    want = JE.rollout(jax.random.PRNGKey(4), ja0, jw, jtopo, jsz,
                      forms="indexed", **kw)
    assert_results_equal(got, want)
    spy.check_wrapper()
    assert all(k["score_bw"] is not None for *_a, k, _o, _v in spy.kept)


# -- the round-trip tables ------------------------------------------------


def _topology(Z, H, dtype, seed=0):
    """A random topology: asymmetric costs and bandwidths (some zero),
    hosts in random zones."""
    rng = np.random.default_rng(seed)
    cost = rng.choice([0.0, 0.01, 0.02, 0.09, 0.12], (Z, Z))
    bw = rng.choice([0.0, 50.0, 100.0, 900.0, 2500.0], (Z, Z))
    hz = rng.integers(0, Z, H)
    return DeviceTopology(torch.tensor(cost, dtype=dtype),
                          torch.tensor(bw, dtype=dtype), torch.tensor(hz),
                          None)


@pytest.mark.parametrize("exponents", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_round_trip_tables_gather_to_zone_host_tables(dtype, exponents):
    topo = _topology(7, 40, dtype)
    hz = topo.host_zone.long()
    cost_rt = topo.cost[:, hz] + topo.cost[hz, :].T  # the [Z, H] form
    bw_rt = topo.bw[:, hz] + topo.bw[hz, :].T
    sp = None
    if exponents:
        sp = torch.tensor([[1.0, 1.0, 1.0], [0.5, 2.0, 0.0],
                           [3.0, 0.0, 1.5]], dtype=dtype)
        cost_rt = libm.xla_pow(cost_rt[None], sp[:, 0, None, None])
        bw_rt = libm.xla_pow(bw_rt[None], sp[:, 1, None, None])
    cost_zz, bw_zz = tick._round_trips(topo, sp, dtype)
    assert cost_zz.shape == ((3, 7, 7) if exponents else (7, 7))
    for zz, rt in ((cost_zz, cost_rt), (bw_zz, bw_rt)):
        got = zz[..., hz]
        assert got.dtype == dtype and torch.equal(
            got.view(torch.int64 if dtype == torch.float64 else torch.int32),
            rt.view(torch.int64 if dtype == torch.float64 else torch.int32))


# -- the wrapper's contract ---------------------------------------------------


def _chain_args(policy, R=2, T=6, H=5, G=3, Z=2, risk=False, seed=1):
    """Small valid float32 operands of one tick's chain."""
    rng = np.random.default_rng(seed)
    f32 = torch.float32
    args = dict(
        avail=torch.from_numpy(rng.integers(0, 4, (R, H, 4))).to(f32),
        g_p=torch.from_numpy(rng.integers(0, G, (R, T))),
        az_p=torch.from_numpy(rng.integers(0, Z, (R, T))),
        bf_p=torch.from_numpy(np.sort(rng.integers(0, T, (R, T)), 1)),
        order=torch.stack([torch.from_numpy(rng.permutation(T))
                           for _ in range(R)]),
        n_ready=torch.tensor([T, 2][:R] + [0] * max(R - 2, 0)),
        dem_group=torch.from_numpy(rng.integers(0, 2, (G, 4))).to(f32),
        cd=torch.from_numpy(rng.random((R, G, Z))).to(f32),
        host_zone=torch.from_numpy(rng.integers(0, Z, H)),
    )
    kw = {}
    if policy == "cost-aware":
        kw["cost_zz"] = torch.ones((Z, Z), dtype=f32)
        kw["bw_zz"] = torch.full((Z, Z), 2.0, dtype=f32)
    if policy == "opportunistic":
        kw["u_p"] = torch.from_numpy(rng.random((R, T))).to(f32)
        kw["weyl_rot"] = torch.zeros(R, dtype=f32)
    if risk:
        kw["risk_row"] = torch.from_numpy(rng.random((R, H))).to(f32)
    return args, kw


@pytest.mark.parametrize("policy", POLICIES)
def test_wrapper_on_cpu_is_the_plain_chain(policy):
    args, kw = _chain_args(policy, risk=True)
    a1, a2 = args["avail"].clone(), args["avail"].clone()
    rest = [args[k] for k in ("g_p", "az_p", "bf_p", "order", "n_ready",
                              "dem_group", "cd", "host_zone")]
    ck.reset_launches()
    got = ck.ensemble_chain_cuda(policy, a1, *rest, **kw)
    want = tick._chain_plain(policy, a2, *rest, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(a1, a2) and (got[0] >= 0).any()
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.float32
    assert ck.LAUNCHES["ensemble_chain"] == 0 and not ck.LAUNCHES_CHAIN


def _call(policy, args, kw):
    return ck.ensemble_chain_cuda(
        policy, *[args[k] for k in ("avail", "g_p", "az_p", "bf_p", "order",
                                    "n_ready", "dem_group", "cd",
                                    "host_zone")], **kw)


@pytest.mark.parametrize("edit,exc,match", [
    (lambda a, k: a.update(g_p=a["g_p"].int()), TypeError, "g_p must be"),
    (lambda a, k: a.update(order=a["order"][:, :4].contiguous()), ValueError,
     "g_p must have shape"),
    (lambda a, k: a.update(n_ready=a["n_ready"].float()), TypeError,
     "n_ready must be"),
    (lambda a, k: a.update(avail=a["avail"][:, :, :3].contiguous()),
     ValueError, "avail must be"),
    (lambda a, k: a.update(avail=a["avail"].half()), TypeError,
     "float32 or float64"),
    (lambda a, k: a.update(dem_group=a["dem_group"].double()), TypeError,
     "dem_group must be"),
    (lambda a, k: a.update(cd=a["cd"][:, :, :1].contiguous()), ValueError,
     "cost_zz must have shape"),
    (lambda a, k: a.update(host_zone=a["host_zone"][:3]), ValueError,
     "host_zone must have shape"),
    (lambda a, k: a.update(
        avail=a["avail"].transpose(0, 1).contiguous().transpose(0, 1)),
     ValueError, "avail must be contiguous"),
    (lambda a, k: k.pop("bw_zz"), ValueError, "needs cost_zz and bw_zz"),
    (lambda a, k: k.update(u_p=a["cd"]), ValueError, "opportunistic chain's"),
    (lambda a, k: k.update(risk_row=torch.zeros(2, 4)), ValueError,
     "risk_row must have shape"),
    (lambda a, k: k.update(w_norm=torch.ones(2)), ValueError,
     "w_norm must have shape"),
    (lambda a, k: k.update(score_bw=torch.ones(2, 2, 5, dtype=torch.float64)),
     TypeError, "score_bw must be"),
    (lambda a, k: a.update(avail=a["avail"].to("meta")), ValueError,
     "g_p is on cpu, avail on meta"),
    (lambda a, k: [d.update({n: t.to("meta") for n, t in d.items()})
                   for d in (a, k)], ValueError,
     "runs on cuda or \\(plain\\) cpu tensors"),
])
def test_wrapper_checks_raise(edit, exc, match):
    args, kw = _chain_args("cost-aware")
    edit(args, kw)
    with pytest.raises(exc, match=match):
        _call("cost-aware", args, kw)


def test_wrapper_checks_per_arm():
    args, kw = _chain_args("first-fit")
    with pytest.raises(ValueError, match="policy must be"):
        _call("worst-fit", args, kw)
    with pytest.raises(ValueError, match="cost-aware chain's"):
        _call("first-fit", args, dict(cost_zz=torch.ones(2, 2),
                                      bw_zz=torch.ones(2, 2)))
    with pytest.raises(ValueError, match="needs u_p and weyl_rot"):
        _call("opportunistic", args, kw)
    args, kw = _chain_args("opportunistic")
    kw["weyl_rot"] = torch.zeros(3)
    with pytest.raises(ValueError, match="weyl_rot must have shape"):
        _call("opportunistic", args, kw)


def test_launch_site_refuses_cpu_tensors():
    args, kw = _chain_args("first-fit")
    R, T = args["order"].shape
    cfg = ck._chain_config(args["avail"].shape[1], 2, "first-fit", False)
    with pytest.raises(ValueError, match="launches on cuda tensors"):
        ck._chain_launch(cfg, "first-fit", *[args[k] for k in (
            "avail", "g_p", "az_p", "bf_p", "order", "n_ready", "dem_group",
            "cd", "host_zone")], None, None, None, None, None, None, None,
            torch.empty((R, T), dtype=torch.int64), torch.empty((R, T)))
    assert ck.LAUNCHES["ensemble_chain"] == 0


# -- the launch shape ---------------------------------------------------------

OPTIN = 232448


def _largest_shared(policy, risk, Z=31):
    """The largest H the shared form holds at ``Z`` zones."""
    H = 1
    while ck._chain_config(H * 2, Z, policy, risk).form == ck._CHAIN_SHARED:
        H *= 2
    lo, hi = H, H * 2
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if ck._chain_config(mid, Z, policy, risk).form == ck._CHAIN_SHARED:
            lo = mid
        else:
            hi = mid
    return lo


LARGEST = {("cost-aware", True): 8856, ("cost-aware", False): 10544,
           ("first-fit", True): 10910, ("first-fit", False): 13477}


@pytest.mark.parametrize("risk", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_launch_config_forms_and_bytes(policy, risk):
    model = kernel_budget.chain_model()
    arm = ck._CHAIN_ARMS.index(policy)
    top = _largest_shared(policy, risk)
    assert top == LARGEST[("cost-aware" if arm == 0 else "first-fit", risk)]
    for H in (1, 33, 100, 255, 256, 257, 600, 4096, top, top + 1, 98304):
        cfg = ck._chain_config(H, 31, policy, risk)
        want_form = ck._CHAIN_SHARED if H <= top else ck._CHAIN_GLOBAL
        assert cfg.form == want_form, H
        assert cfg.warps == (min(32, -(-H // 256)) if H <= top else 32)
        assert cfg.threads <= model.max_threads == 1024
        assert cfg.smem_bytes <= ck._SMEM_LIMIT == OPTIN
        assert cfg.smem_bytes == ck._chain_smem_bytes(H, 31, cfg.form, arm,
                                                      risk)
        assert cfg.smem_bytes == model.smem_bytes(H, 31, cfg.form, arm,
                                                  int(risk))
    # The boundary: one host more than the shared form holds outgrows the
    # opt-in.
    assert ck._chain_smem_bytes(top + 1, 31, ck._CHAIN_SHARED, arm,
                                risk) > OPTIN >= ck._chain_smem_bytes(
        top, 31, ck._CHAIN_SHARED, arm, risk)
    # R = 1024 replicas at H = 600 fit one resident wave: 8 CTAs an SM.
    assert 8 * (ck._chain_config(600, 31, policy, risk).smem_bytes
                + 1024) <= 233472


def test_launch_config_zones():
    """More zones than a byte holds take the global form; cost-aware
    tables past the opt-in raise."""
    assert ck._chain_config(600, 257, "first-fit", False).form == \
        ck._CHAIN_GLOBAL
    assert ck._chain_config(600, 169, "cost-aware", True).form == \
        ck._CHAIN_GLOBAL
    with pytest.raises(ValueError, match="outgrow ensemble_chain"):
        ck._chain_config(600, 170, "cost-aware", False)
    with pytest.raises(ValueError, match="policy must be"):
        ck._chain_config(600, 31, "vbp", False)
