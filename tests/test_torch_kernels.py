"""Bit-parity: the port's torch kernels vs ``pivot_tpu.ops.kernels``.

The same numpy inputs (made from a seed) go through the JAX scan oracles
and two-phase kernels under x64 and through their torch counterparts in
``pivot_tpu_torch.ops.kernels`` on the CPU in float64.  Placements AND
availability must be bitwise equal — the port keeps the reference's
operand association, tie rule and decrement, so no tolerance applies.
Input patterns are those of ``tests/test_two_phase.py`` (random grouped
batches, the adversarial contended batch) at tier-1 sizes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pivot_tpu.ops import kernels as jk
from pivot_tpu_torch.ops import kernels as tk

from tests.test_two_phase import CA_MODES, contended_inputs, make_inputs

CA_ARGS = ("avail", "dem", "valid", "ng", "az", "cost", "bw", "hz", "counts")


def as_torch(x):
    return {k: torch.from_numpy(np.array(v)) for k, v in x.items()}


def assert_same(ref, new, ctx):
    (p_ref, a_ref), (p_new, a_new) = ref, new
    assert np.array_equal(np.asarray(p_ref), p_new.numpy()), (
        ctx, np.asarray(p_ref)[:16].tolist(), p_new[:16].tolist(),
    )
    a_ref, a_new = np.asarray(a_ref), a_new.numpy()
    assert a_ref.dtype == a_new.dtype == np.float64, ctx
    assert np.array_equal(a_ref.view(np.int64), a_new.view(np.int64)), ctx


def check_all(x, ca_modes=CA_MODES, live=None, risk=None, phase2s=("slim",)):
    """Every torch form (oracle + each phase-2 mode) vs the JAX oracle."""
    t = as_torch(x)
    jl = None if live is None else jnp.asarray(live)
    tl = None if live is None else torch.from_numpy(live)
    jr = None if risk is None else jnp.asarray(risk)
    tr = None if risk is None else torch.from_numpy(risk)
    kw_j, kw_t = dict(live=jl, risk=jr), dict(live=tl, risk=tr)

    ref = jk.opportunistic_kernel_ref(x["avail"], x["dem"], x["valid"], x["u"],
                                      **kw_j)
    assert_same(ref, tk.opportunistic_kernel_ref(
        t["avail"], t["dem"], t["valid"], t["u"], **kw_t), "opp-ref")
    for ph in phase2s:
        assert_same(ref, tk.opportunistic_impl(
            t["avail"], t["dem"], t["valid"], t["u"], phase2=ph, **kw_t),
            ("opp", ph))

    for strict in (False, True):
        ref = jk.first_fit_kernel_ref(x["avail"], x["dem"], x["valid"],
                                      strict=strict, **kw_j)
        assert_same(ref, tk.first_fit_kernel_ref(
            t["avail"], t["dem"], t["valid"], strict=strict, **kw_t),
            ("ff-ref", strict))
        for ph in phase2s:
            assert_same(ref, tk.first_fit_impl(
                t["avail"], t["dem"], t["valid"], strict=strict,
                totals=t["totals"], phase2=ph, **kw_t), ("ff", strict, ph))

    ref = jk.best_fit_kernel_ref(x["avail"], x["dem"], x["valid"], **kw_j)
    assert_same(ref, tk.best_fit_kernel_ref(
        t["avail"], t["dem"], t["valid"], **kw_t), "bf-ref")
    for ph in phase2s:
        assert_same(ref, tk.best_fit_impl(
            t["avail"], t["dem"], t["valid"], totals=t["totals"], phase2=ph,
            **kw_t), ("bf", ph))

    for mode in ca_modes:
        ref = jk.cost_aware_kernel_ref(*(x[k] for k in CA_ARGS), **mode,
                                       **kw_j)
        assert_same(ref, tk.cost_aware_kernel_ref(
            *(t[k] for k in CA_ARGS), **mode, **kw_t), ("ca-ref", mode))
        for ph in phase2s:
            assert_same(ref, tk.cost_aware_impl(
                *(t[k] for k in CA_ARGS), **mode, totals=t["totals"],
                phase2=ph, **kw_t), ("ca", mode, ph))


@pytest.fixture(autouse=True)
def _reset_port_ids():
    from pivot_tpu_torch.utils import reset_ids

    reset_ids()
    yield


@pytest.mark.parametrize(
    "seed,T,H,B,gs",
    [(0, 5, 4, 8, 2), (1, 28, 12, 32, 5), (2, 60, 16, 64, 7)],
)
def test_torch_kernels_bitwise(seed, T, H, B, gs):
    check_all(make_inputs(seed, T, H, B, group_size=gs),
              phase2s=("slim", "scan"))


def test_torch_kernels_contended():
    """Every task fits exactly one host, every host one of its two
    suitors: the adversarial batch of ``tests/test_two_phase.py``."""
    check_all(contended_inputs(24, 8))


def test_torch_kernels_live_mask():
    x = make_inputs(3, 28, 12, 32, group_size=5)
    rng = np.random.default_rng(0)
    live = np.ones(12, bool)
    live[rng.choice(12, size=3, replace=False)] = False
    check_all(x, live=live)


def test_torch_kernels_risk():
    """Tiered risk rows exercise the score-add, the (risk, index) order and
    the opportunistic minimum-risk tier."""
    x = make_inputs(4, 28, 12, 32, group_size=5)
    risk = np.random.default_rng(17).choice([0.0, 0.4, 1.5], size=12)
    check_all(x, risk=risk)


def test_torch_kernels_interspersed_invalid_and_no_fit():
    x = make_inputs(5, 28, 12, 32, group_size=5)
    valid = np.asarray(x["valid"]).copy()
    valid[3] = valid[11] = valid[17] = False
    x["valid"] = jnp.asarray(valid)
    dem = np.asarray(x["dem"]).copy()
    dem[5] = 99.0  # fits nowhere
    x["dem"] = jnp.asarray(dem)
    check_all(x)


def test_torch_kernels_empty_and_all_invalid():
    check_all(make_inputs(0, 0, 6, 8, group_size=2), ca_modes=CA_MODES[:1])
    x0 = as_torch(make_inputs(0, 0, 6, 0))
    p, a = tk.cost_aware_impl(*(x0[k] for k in CA_ARGS), phase2="slim")
    assert p.shape == (0,)
    assert torch.equal(a, x0["avail"])


def test_torch_kernels_rt_bw_rows():
    x = make_inputs(3, 28, 12, 32, group_size=5)
    t = as_torch(x)
    rng = np.random.default_rng(9)
    rows = rng.uniform(50, 15000, size=(4, 12))
    ridx = (np.arange(32) % 4).astype(np.int32)
    for mode in (CA_MODES[0], CA_MODES[3]):
        ref = jk.cost_aware_kernel_ref(
            *(x[k] for k in CA_ARGS), **mode, rt_bw_rows=jnp.asarray(rows),
            rt_bw_idx=jnp.asarray(ridx))
        for ph in ("slim", "scan"):
            assert_same(ref, tk.cost_aware_impl(
                *(t[k] for k in CA_ARGS), **mode,
                rt_bw_rows=torch.from_numpy(rows),
                rt_bw_idx=torch.from_numpy(ridx), phase2=ph), (mode, ph))


@pytest.mark.parametrize("mode", [CA_MODES[1], CA_MODES[4]])
def test_torch_kernels_score_exp(mode):
    """Learned (w_cost, w_bw, w_norm) exponents pow the phase-1 tables and
    the norm at the score sites, as in the JAX kernels."""
    x = make_inputs(6, 28, 12, 32, group_size=5)
    t = as_torch(x)
    exp = np.array([1.7, 0.6, 1.4])
    ref = jk.cost_aware_kernel_ref(*(x[k] for k in CA_ARGS), **mode,
                                   score_exp=jnp.asarray(exp))
    for ph in ("slim", "scan"):
        assert_same(ref, tk.cost_aware_impl(
            *(t[k] for k in CA_ARGS), **mode, score_exp=torch.from_numpy(exp),
            phase2=ph), ph)
    with pytest.raises(ValueError, match="realtime_bw"):
        tk.cost_aware_impl(*(t[k] for k in CA_ARGS), **mode,
                           score_exp=torch.from_numpy(exp),
                           rt_bw_rows=torch.ones(1, 12),
                           rt_bw_idx=torch.zeros(32, dtype=torch.int32))


def test_torch_phase2_validation():
    """A chunk size is a phase-2 mode (speculative chunk commit, held
    bitwise in ``tests/test_torch_two_phase.py``); zero, a bool and an
    unknown name are refused."""
    t = as_torch(make_inputs(0, 5, 4, 8))
    chunked = tk.first_fit_impl(t["avail"], t["dem"], t["valid"], phase2=8)
    slim = tk.first_fit_impl(t["avail"], t["dem"], t["valid"], phase2="slim")
    assert torch.equal(chunked[0], slim[0])
    assert torch.equal(chunked[1], slim[1])
    for bad in (0, True, "bogus"):
        with pytest.raises(ValueError, match="phase2"):
            tk.first_fit_impl(t["avail"], t["dem"], t["valid"], phase2=bad)


def test_topology_from_numpy_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid device here")
    with pytest.raises(RuntimeError, match="cuda"):
        tk.topology_from_numpy(np.zeros((2, 2)), np.ones((2, 2)),
                               np.zeros(3, np.int32), np.ones((3, 4)),
                               device="cuda")
