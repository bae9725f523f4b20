"""The per-row form of the port's greedy pass vs the reference's vmap.

``pivot_tpu_torch.ops.cuda_kernels.cost_aware_plain_rows`` — the plain
version of ``greedy_place``'s per-row launch, and what
``cost_aware_cuda_rows`` runs on CPU tensors — against

  * ``cost_aware_plain`` row by row (bitwise: the per-row pass is that
    pass on each row's own operands, each row's step bound its own);
  * ``jax.vmap`` of ``pivot_tpu``'s scan oracle ``cost_aware_kernel_ref``
    over the same float32 rows — what a coalesced Cost-Aware flush of
    ``pivot_tpu/sched/batch.py`` computes.  Placements exactly equal,
    availability within rtol 1e-6 / atol 1e-5 (``tests/test_pallas.py``'s
    tolerance).

Rows differ in their streams, anchors, tables, host rows and task counts
(a row's tasks past its count are invalid, its step bound one past its
last task); some rows carry a real live mask or risk row, others an
all-live mask or zero risk.  The kernel itself runs only on the card:
``chip_smoke.py`` holds it against this plain version there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pivot_tpu.ops.kernels import cost_aware_kernel_ref
from pivot_tpu_torch.ops import cuda_kernels as ck

from tests.test_pallas import MODES, make_inputs


def rows_inputs(seed, G, T, H, live=False, risk=False):
    """G rows of ``make_inputs`` (demand dimension 1 dense enough that
    most tasks place), row r keeping its first T_r tasks valid, and the
    per-row step bounds T_r; row 0 runs all T.  With ``live`` / ``risk``
    the even rows carry a real mask / risk row and the odd rows an
    all-live mask / zero risk."""
    rng = np.random.default_rng(seed)
    rows = []
    for r in range(G):
        args = [np.array(a) for a in make_inputs(seed * 31 + r, T, H)]
        args[1][:, 1] = rng.uniform(0, 4, T)
        rows.append(args)
    n_eff = rng.integers(0, T + 1, size=G).astype(np.int32)
    n_eff[0] = T
    for r in range(G):
        rows[r][2][n_eff[r]:] = False
    cols = [np.stack([row[i] for row in rows]) for i in range(9)]
    kw = {}
    if live:
        mask = rng.random((G, H)) < 0.75
        mask[1::2] = True
        kw["live"] = mask
    if risk:
        rk = rng.choice([0.0, 0.4, 1.5], size=(G, H)).astype(np.float32)
        rk[1::2] = 0.0
        kw["risk"] = rk
    return cols, kw, n_eff


def as_torch(cols, kw, n_eff):
    return ([torch.from_numpy(c) for c in cols],
            {k: torch.from_numpy(v) for k, v in kw.items()},
            torch.from_numpy(n_eff))


CASES = [(1, 37, 13), (2, 300, 50), (3, 5, 200), (5, 70, 40)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("G,T,H", CASES)
@pytest.mark.parametrize("extras", ["none", "live", "risk", "both"])
def test_plain_rows_equals_plain_row_by_row(mode, G, T, H, extras):
    cols, kw, n_eff = rows_inputs(G * 7 + T, G, T, H,
                                  live=extras in ("live", "both"),
                                  risk=extras in ("risk", "both"))
    args, tkw, tn = as_torch(cols, kw, n_eff)
    p, a = ck.cost_aware_plain_rows(*args, **mode, **tkw, n_eff_g=tn)
    assert p.shape == (G, T) and a.shape == (G, H, 4)
    assert p.dtype == torch.int32 and a.dtype == torch.float32
    for r in range(G):
        rp, ra = ck.cost_aware_plain(
            *(x[r] for x in args), **mode, n_eff=int(n_eff[r]),
            **{k: v[r] for k, v in tkw.items()})
        assert torch.equal(p[r], rp), (mode, r)
        assert torch.equal(a[r], ra), (mode, r)
        assert bool((p[r][int(n_eff[r]):] == -1).all())
    # The wrapper on CPU tensors is the plain version, and counts nothing.
    ck.reset_launches()
    pw, aw = ck.cost_aware_cuda_rows(*args, **mode, **tkw, n_eff_g=tn)
    assert torch.equal(pw, p) and torch.equal(aw, a)
    assert ck.LAUNCHES == {"greedy_place": 0} and ck.LAUNCHES_ROWS == {}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("G,T,H", CASES)
@pytest.mark.parametrize("extras", ["none", "both"])
def test_plain_rows_equals_vmap_of_reference_oracle(mode, G, T, H, extras):
    cols, kw, n_eff = rows_inputs(G * 11 + H, G, T, H,
                                  live=extras == "both",
                                  risk=extras == "both")
    names = sorted(kw)

    def one(*xs):
        return cost_aware_kernel_ref(*xs[:9], **mode,
                                     **dict(zip(names, xs[9:])))

    ref_p, ref_a = jax.vmap(one)(*(jnp.asarray(c) for c in cols),
                                 *(jnp.asarray(kw[k]) for k in names))
    args, tkw, tn = as_torch(cols, kw, n_eff)
    p, a = ck.cost_aware_plain_rows(*args, **mode, **tkw, n_eff_g=tn)
    assert np.asarray(ref_p).tolist() == p.tolist(), mode
    np.testing.assert_allclose(np.asarray(ref_a), a.numpy(), rtol=1e-6,
                               atol=1e-5)
    assert int((p >= 0).sum()) > 0


def test_all_live_and_zero_risk_rows_equal_rows_without_them():
    """An all-live mask and a zero risk row place like no mask and no
    risk (the batcher keys ticks with and without them apart, so both
    forms must agree for a session's placements to be composition-free)."""
    cols, kw, n_eff = rows_inputs(5, 4, 60, 30, live=True, risk=True)
    args, tkw, tn = as_torch(cols, kw, n_eff)
    for mode in MODES:
        p, _ = ck.cost_aware_plain_rows(*args, **mode, **tkw, n_eff_g=tn)
        bare, _ = ck.cost_aware_plain_rows(*args, **mode, n_eff_g=tn)
        assert torch.equal(p[1::2], bare[1::2]), mode


def test_rows_wrapper_rejects_mismatched_row_shapes():
    cols, _kw, n_eff = rows_inputs(1, 3, 20, 10)
    args, _, tn = as_torch(cols, {}, n_eff)
    with pytest.raises(ValueError, match="valid"):
        ck.cost_aware_cuda_rows(*args[:2], args[2][:, :-1], *args[3:],
                                n_eff_g=tn)
    with pytest.raises(ValueError, match="demands"):
        ck.cost_aware_cuda_rows(args[0], args[1][:2], *args[2:])
    with pytest.raises(ValueError, match="per-row form"):
        ck.cost_aware_cuda_rows(*args[:5], args[5][0], *args[6:])
    with pytest.raises(ValueError, match="host_zone"):
        ck.cost_aware_cuda_rows(*args[:7], args[7][:, :-1], args[8])
    with pytest.raises(ValueError, match="live"):
        ck.cost_aware_cuda_rows(*args, live=torch.ones(3, 9, dtype=torch.bool))
    with pytest.raises(ValueError, match="n_eff"):
        ck.cost_aware_cuda_rows(*args, n_eff_g=tn[:2])
    with pytest.raises(TypeError, match="n_eff"):
        ck.cost_aware_cuda_rows(*args, n_eff_g=tn.long())
    with pytest.raises(TypeError, match="demands"):
        ck.cost_aware_cuda_rows(args[0], args[1].double(), *args[2:])
    with pytest.raises(ValueError, match="bin_pack"):
        ck.cost_aware_cuda_rows(*args, bin_pack="worst-fit")


def test_rows_launch_shape_is_one_row_a_block():
    cfg = ck._rows_config(16, 600, 31)
    assert cfg.groups == 1 and cfg.blocks == 16
    assert cfg.threads == 32 * cfg.warps
    assert cfg.smem_bytes == ck._smem_bytes(31, cfg.warps, 1,
                                            cfg.hosts_per_thread,
                                            cfg.smem_state)
    one = ck._launch_config(1, 600, 31)
    assert (cfg.warps, cfg.hosts_per_thread) == (one.warps,
                                                 one.hosts_per_thread)
