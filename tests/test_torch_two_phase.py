"""Speculative chunk commit: the port's ``phase2=int`` vs ``pivot_tpu``'s.

The inputs of ``tests/test_two_phase.py`` (random grouped batches, the
adversarial contended batch where every task fits one host and every host
one of its two suitors) go through the JAX kernels with ``phase2=C`` under
x64 and through the port's ``*_impl`` with the same C on the CPU in
float64, at C ∈ {1, 3, 8, 64}.  Placements and availability must be
bitwise equal: speculation only moves the commit boundary, the commit
itself is the scan's own fold.

Where the JAX chunked kernel disagrees with its own scan oracle (it does
at C = 1 for cost-aware first-fit with sorted hosts on the seed-2 batch,
and for best-fit with decay and learned exponents — a fault of the
reference, ROADMAP.md Queue 3), the port is held to the oracle, which is
what the chunked form promises.  So in every case the port equals the
scan.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pivot_tpu.ops import kernels as jk
from pivot_tpu_torch.ops import kernels as tk

from tests.test_torch_kernels import CA_ARGS, as_torch, assert_same
from tests.test_two_phase import CA_MODES, contended_inputs, make_inputs

CHUNKS = (1, 3, 8, 64)


@pytest.fixture(autouse=True)
def _reset_port_ids():
    from pivot_tpu_torch.utils import reset_ids

    reset_ids()
    yield


def _bits(out):
    p, a = out
    return np.asarray(p).tolist(), np.asarray(a).tobytes()


def held_to(chunked, oracle):
    """The JAX chunked result where it equals the JAX scan oracle, else
    the oracle."""
    return chunked if _bits(chunked) == _bits(oracle) else oracle


def check_chunked(x, C, ca_modes=CA_MODES, live=None, risk=None,
                  totals=True):
    """Every port kernel with ``phase2=C`` vs the JAX kernel with the same
    C, or vs the JAX scan oracle where the two disagree (:func:`held_to`)."""
    t = as_torch(x)
    kw_j = dict(live=None if live is None else jnp.asarray(live),
                risk=None if risk is None else jnp.asarray(risk))
    kw_t = dict(live=None if live is None else torch.from_numpy(live),
                risk=None if risk is None else torch.from_numpy(risk))
    tot_j = x["totals"] if totals else None
    tot_t = t["totals"] if totals else None

    assert_same(held_to(
        jk.opportunistic_kernel(x["avail"], x["dem"], x["valid"], x["u"],
                                phase2=C, **kw_j),
        jk.opportunistic_kernel_ref(x["avail"], x["dem"], x["valid"],
                                    x["u"], **kw_j)),
        tk.opportunistic_impl(t["avail"], t["dem"], t["valid"], t["u"],
                              phase2=C, **kw_t), ("opp", C))
    for strict in (False, True):
        assert_same(held_to(
            jk.first_fit_kernel(x["avail"], x["dem"], x["valid"],
                                strict=strict, totals=tot_j, phase2=C,
                                **kw_j),
            jk.first_fit_kernel_ref(x["avail"], x["dem"], x["valid"],
                                    strict=strict, **kw_j)),
            tk.first_fit_impl(t["avail"], t["dem"], t["valid"],
                              strict=strict, totals=tot_t, phase2=C,
                              **kw_t), ("ff", strict, C))
    assert_same(held_to(
        jk.best_fit_kernel(x["avail"], x["dem"], x["valid"], totals=tot_j,
                           phase2=C, **kw_j),
        jk.best_fit_kernel_ref(x["avail"], x["dem"], x["valid"], **kw_j)),
        tk.best_fit_impl(t["avail"], t["dem"], t["valid"], totals=tot_t,
                         phase2=C, **kw_t), ("bf", C))
    for mode in ca_modes:
        assert_same(held_to(
            jk.cost_aware_kernel(*(x[k] for k in CA_ARGS), **mode,
                                 totals=tot_j, phase2=C, **kw_j),
            jk.cost_aware_kernel_ref(*(x[k] for k in CA_ARGS), **mode,
                                     **kw_j)),
            tk.cost_aware_impl(*(t[k] for k in CA_ARGS), **mode,
                               totals=tot_t, phase2=C, **kw_t),
            ("ca", mode, C))


@pytest.mark.parametrize("C", CHUNKS)
@pytest.mark.parametrize("seed,T,H,B,gs",
                         [(0, 5, 4, 8, 2), (1, 28, 12, 32, 5),
                          (2, 60, 16, 64, 7)])
def test_chunk_commit_matches_jax(seed, T, H, B, gs, C):
    check_chunked(make_inputs(seed, T, H, B, group_size=gs), C)


@pytest.mark.parametrize("C", CHUNKS)
def test_chunk_commit_contended(C):
    """Speculation conflicts on every second task: the commit degrades to
    the exact sequential replay."""
    check_chunked(contended_inputs(24, 8), C)


@pytest.mark.parametrize("C", CHUNKS)
def test_chunk_commit_interspersed_invalid(C):
    """Invalid rows mid-batch are −1 no-ops; one demand fits nowhere."""
    x = make_inputs(5, 28, 12, 32, group_size=5)
    valid = np.asarray(x["valid"]).copy()
    valid[3] = valid[11] = valid[17] = False
    x["valid"] = jnp.asarray(valid)
    dem = np.asarray(x["dem"]).copy()
    dem[5] = 99.0
    x["dem"] = jnp.asarray(dem)
    check_chunked(x, C, totals=C != 3)


@pytest.mark.parametrize("C", (3, 8))
def test_chunk_commit_live_mask_and_risk(C):
    """A quarantine mask and tiered risk rows through every chunked
    kernel: masked rows pass through, the risk order steers the fill."""
    x = make_inputs(3, 28, 12, 32, group_size=5)
    rng = np.random.default_rng(0)
    live = np.ones(12, bool)
    live[rng.choice(12, size=3, replace=False)] = False
    risk = np.random.default_rng(17).choice([0.0, 0.4, 1.5], size=12)
    check_chunked(x, C, live=live)
    check_chunked(x, C, risk=risk, ca_modes=(CA_MODES[0], CA_MODES[2],
                                             CA_MODES[4]))


@pytest.mark.parametrize("C", (1, 8))
def test_chunk_commit_rt_bw_rows_and_score_exp(C):
    """Realtime bandwidth rows and learned exponents reach the chunked
    cost-aware speculation and recheck."""
    x = make_inputs(3, 28, 12, 32, group_size=5)
    t = as_torch(x)
    rng = np.random.default_rng(9)
    rows = rng.uniform(50, 15000, size=(4, 12))
    ridx = (np.arange(32) % 4).astype(np.int32)
    rt = dict(rt_bw_rows=jnp.asarray(rows), rt_bw_idx=jnp.asarray(ridx))
    for mode in (CA_MODES[0], CA_MODES[4]):
        assert_same(held_to(
            jk.cost_aware_kernel(*(x[k] for k in CA_ARGS), **mode, **rt,
                                 phase2=C),
            jk.cost_aware_kernel_ref(*(x[k] for k in CA_ARGS), **mode,
                                     **rt)),
            tk.cost_aware_impl(*(t[k] for k in CA_ARGS), **mode,
                               rt_bw_rows=torch.from_numpy(rows),
                               rt_bw_idx=torch.from_numpy(ridx), phase2=C),
            ("rt", mode, C))
    exp = np.array([1.7, 0.6, 1.4])
    for mode in (CA_MODES[1], CA_MODES[4]):
        assert_same(held_to(
            jk.cost_aware_kernel(*(x[k] for k in CA_ARGS), **mode,
                                 score_exp=jnp.asarray(exp), phase2=C),
            jk.cost_aware_kernel_ref(*(x[k] for k in CA_ARGS), **mode,
                                     score_exp=jnp.asarray(exp))),
            tk.cost_aware_impl(*(t[k] for k in CA_ARGS), **mode,
                               score_exp=torch.from_numpy(exp), phase2=C),
            ("exp", mode, C))


def test_chunk_commit_empty_and_all_invalid():
    x = make_inputs(0, 0, 6, 8, group_size=2)
    check_chunked(x, 4, ca_modes=CA_MODES[:1])
    x0 = as_torch(make_inputs(0, 0, 6, 0))
    p, a = tk.cost_aware_impl(*(x0[k] for k in CA_ARGS), phase2=4)
    assert p.shape == (0,)
    assert torch.equal(a, x0["avail"])


def test_fill_model_predicts_identical_demand_runs():
    """The fill model itself: identical demands fill hosts in score order
    up to their capacity, and ranks past the total are not ok."""
    avail = torch.tensor([[3.0, 9, 9, 9], [1.0, 9, 9, 9], [2.5, 9, 9, 9]],
                         dtype=torch.float64)
    demand = torch.tensor([1.0, 0, 0, 0], dtype=torch.float64)
    caps = tk._fill_capacity(avail, demand, False, None)
    assert caps.tolist() == [3, 1, 2]
    assert tk._fill_capacity(avail, demand, True, None).tolist() == [2, 0, 2]
    h, ok = tk._fill_pick(torch.tensor([2.0, 0.0, 1.0]), caps,
                          torch.arange(7))
    assert h[ok].tolist() == [1, 2, 2, 0, 0, 0]
    assert ok.tolist() == [True] * 6 + [False]
