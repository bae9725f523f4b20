"""The port's greedy pass vs the Pallas kernel it replaces.

``pivot_tpu_torch.ops.cuda_kernels.cost_aware_plain(_batched)`` — the
plain torch version of the hand-written CUDA kernel, and what its
wrappers run on CPU tensors — against ``pivot_tpu``'s
``cost_aware_pallas(_batched)`` run in the Mosaic interpreter on the CPU,
as ``tests/test_pallas.py`` runs it.  Same f32 inputs from a seeded numpy
RNG (``tests/test_pallas.py::make_inputs``).  Placements must be exactly
equal; availability within rtol 1e-6 / atol 1e-5, the tolerance of
``tests/test_pallas.py`` (the two sides subtract the same demands in the
same order, but the interpreter's f32 lowering is not held to bitwise).

The kernel itself runs only on the card: ``chip_smoke.py`` holds it
against the plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pivot_tpu.ops.kernels import cost_aware_kernel
from pivot_tpu.ops.pallas_kernels import (
    cost_aware_pallas,
    cost_aware_pallas_batched,
)
from pivot_tpu_torch.ops import cuda_kernels as ck

from tests.test_pallas import MODES, make_inputs


@pytest.fixture(autouse=True)
def _reset_port_ids():
    from pivot_tpu_torch.utils import reset_ids

    reset_ids()
    yield


def as_torch(args):
    return [torch.from_numpy(np.array(a)) for a in args]


def assert_close(ref, new, ctx):
    (p_ref, a_ref), (p_new, a_new) = ref, new
    assert np.asarray(p_ref).tolist() == p_new.tolist(), ctx
    assert a_new.dtype == torch.float32, ctx
    np.testing.assert_allclose(np.asarray(a_ref), a_new.numpy(), rtol=1e-6,
                               atol=1e-5, err_msg=str(ctx))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "seed,T,H", [(0, 37, 13), (1, 300, 50), (2, 5, 200)],
)
def test_plain_matches_pallas(mode, seed, T, H):
    args = make_inputs(seed, T, H)
    ref = cost_aware_pallas(*args, **mode, interpret=True)
    assert_close(ref, ck.cost_aware_plain(*as_torch(args), **mode),
                 (mode, seed, T, H))


def test_plain_matches_pallas_long_tick():
    """T=700 crosses the Pallas kernel's 256-task chunks; the plain pass
    has no chunks, so the carried state must agree across them."""
    args = make_inputs(7, 700, 40, frac_new_group=0.02)
    mode = MODES[0]
    ref = cost_aware_pallas(*args, **mode, interpret=True)
    new = ck.cost_aware_plain(*as_torch(args), **mode)
    assert_close(ref, new, "T=700")
    assert int((new[0] >= 0).sum()) > 0


@pytest.mark.parametrize("mode", MODES)
def test_plain_batched_matches_pallas(mode):
    """R=5 replicas with different availability share one task stream."""
    R, T, H = 5, 70, 40
    args = make_inputs(3, T, H)
    rng = np.random.default_rng(9)
    avail_r = (np.asarray(args[0])[None]
               * rng.uniform(0.5, 1.5, (R, H, 1))).astype(np.float32)
    ref = cost_aware_pallas_batched(jnp.asarray(avail_r), *args[1:], **mode,
                                    interpret=True)
    new = ck.cost_aware_plain_batched(
        torch.from_numpy(avail_r), *as_torch(args[1:]), **mode)
    assert new[0].shape == (R, T) and new[1].shape == (R, H, 4)
    assert_close(ref, new, mode)


def dense(args, seed):
    """``make_inputs``' tick with demand dimension 1 drawn from [0, 4)
    instead of [0, 4000): against availability in [0, 16) most tasks
    then place, so every score, tie-break and decrement is exercised."""
    d = np.array(args[1])
    d[:, 1] = np.random.default_rng(seed).uniform(0, 4, len(d))
    return (args[0], jnp.asarray(d), *args[2:])


def placed_enough(p, valid, R=1):
    """A dense case places at least a quarter of its valid tasks per
    replica."""
    assert int((p >= 0).sum()) >= R * int(np.asarray(valid).sum()) // 4


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed,T,H", [(1, 300, 50), (7, 700, 40)])
def test_plain_matches_pallas_dense(mode, seed, T, H):
    args = dense(make_inputs(seed, T, H), seed)
    ref = cost_aware_pallas(*args, **mode, interpret=True)
    new = ck.cost_aware_plain(*as_torch(args), **mode)
    assert_close(ref, new, (mode, seed, T, H))
    placed_enough(new[0], args[2])


@pytest.mark.parametrize("mode", MODES)
def test_plain_dense_live_risk_batched_matches_pallas(mode):
    """Dense ticks with a live mask and a risk row, at R=5 replicas."""
    R, T, H = 5, 120, 40
    args = dense(make_inputs(8, T, H), 8)
    rng = np.random.default_rng(2)
    live = np.ones(H, bool)
    live[rng.choice(H, size=8, replace=False)] = False
    risk = rng.choice([0.0, 0.4, 1.5], size=H).astype(np.float32)
    avail_r = (np.asarray(args[0])[None]
               * rng.uniform(0.5, 1.5, (R, H, 1))).astype(np.float32)
    ref = cost_aware_pallas_batched(
        jnp.asarray(avail_r), *args[1:], **mode, live=jnp.asarray(live),
        risk=jnp.asarray(risk), interpret=True)
    new = ck.cost_aware_plain_batched(
        torch.from_numpy(avail_r), *as_torch(args[1:]), **mode,
        live=torch.from_numpy(live), risk=torch.from_numpy(risk))
    assert_close(ref, new, mode)
    placed_enough(new[0], args[2], R)
    assert live[new[0][new[0] >= 0].numpy()].all()


EDGE_CASES = ["ties", "h1", "h33", "h100", "risk_zeros", "zero_bw",
              "nan_only"]
#: The edge cases of a replica split over CTAs (past 10,240 hosts).
CTA_EDGE_CASES = ["cta_ties", "cta_last", "cta_masked", "cta_risk",
                  "cta_nan"]
#: Their host count here: a cluster of 4 CTAs of ⌈H / 4⌉ = 5,121 hosts,
#: the last one 5,118 (``chip_smoke.py`` runs them at every C and in the
#: global form).
CTA_EDGE_H = 20481


def cta_slice(H):
    """Hosts a CTA of ``H`` hosts' launch shape holds, ⌈H / C⌉; the global
    form (no CTA split) takes the 16-CTA cluster's width."""
    cfg = ck._launch_config(1, H, 31)
    return -(-H // (cfg.cluster if cfg.cluster > 1 else ck.MAX_CLUSTER))


def edge_inputs(name, H=None):
    """A dense 40-task tick on one selection edge case the kernel's
    ordered-key argmin must keep (``chip_smoke.py`` builds the same):

    ties        H = 65; hosts 31/32 and 63/64 (= H − 1) identical and the
                roomiest, all in one zone, so their scores tie exactly
                across warp boundaries;
    h1, h33, h100  one host, one past a warp, not a multiple of 32;
    risk_zeros  a risk row of −0.0, +0.0 and 0.25: equal risks, and the
                two zeros must tie;
    zero_bw     zone 5 has no bandwidth: anchor-5 tasks score hosts of
                zone 5 0/0 = NaN and the others c/0 = +inf;
    nan_only    every host and anchor in zone 5 with no bandwidth: every
                sorted score is NaN, so every such step gives −1;

    and at ``H`` hosts (default ``CTA_EDGE_H``), the CTAs of the launch
    shape holding ``w`` = :func:`cta_slice` hosts each:

    cta_ties    the two hosts on each side of every CTA boundary (w·c − 1
                and w·c) identical and the roomiest, all in one zone:
                ties across CTAs go to the lower host;
    cta_last    every host before the last CTA nearly full: the winners
                lie in the last CTA;
    cta_masked  the first CTA's hosts the roomiest and all ``live``-masked;
    cta_risk    a risk row of −0.0, +0.0 and 0.25: the zeros tie across
                CTAs;
    cta_nan     the same with NaN on one small host of the last CTA: a
                step it fits is poisoned (−1).

    Returns the nine numpy operands and the extra keyword arrays."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name in CTA_EDGE_CASES:
        H = H or CTA_EDGE_H
    else:
        H = {"h1": 1, "h33": 33, "h100": 100}.get(name, 65)
    T, Z = 40, 31
    avail = rng.uniform(0, 16, size=(H, 4)).astype(np.float32)
    demands = np.stack([rng.choice([0.0, 0.5, 1.0, 2.0], size=T),
                        rng.uniform(0, 4, size=T), np.zeros(T), np.zeros(T)],
                       axis=1).astype(np.float32)
    valid = rng.random(T) < 0.9
    new_group = rng.random(T) < 0.2
    new_group[0] = True
    anchor = rng.integers(0, Z, size=T).astype(np.int32)
    cost = rng.uniform(0, 0.11, size=(Z, Z)).astype(np.float32)
    np.fill_diagonal(cost, 0.0)
    bw = rng.uniform(50, 15000, size=(Z, Z)).astype(np.float32)
    host_zone = rng.integers(0, Z, size=H).astype(np.int32)
    counts = rng.integers(0, 5, size=H).astype(np.int32)
    kw = {}
    if name == "ties":
        avail[:] = 1.5
        avail[[31, 32, 63, 64]] = 9.0
        host_zone[:] = 3
        counts[:] = 2
    elif name == "risk_zeros":
        kw["risk"] = rng.choice([-0.0, 0.0, 0.25], size=H).astype(np.float32)
    elif name == "zero_bw":
        bw[5, :] = 0.0
        bw[:, 5] = 0.0
        host_zone[: H // 3] = 5
        anchor[::2] = 5
    elif name == "nan_only":
        bw[5, 5] = 0.0
        host_zone[:] = 5
        anchor[:] = 5
    elif name in CTA_EDGE_CASES:
        w = cta_slice(H)
        starts = list(range(w, H, w))  # the first host of each later CTA
        if name == "cta_ties":
            avail[:] = 1.5
            for b in starts:
                avail[[b - 1, b]] = 9.0
            host_zone[:] = 3
            counts[:] = 2
        elif name == "cta_last":
            avail[: starts[-1]] = 0.25
        elif name == "cta_masked":
            avail[:w] = 15.5
            live = np.ones(H, bool)
            live[:w] = False
            kw["live"] = live
        else:
            risk = rng.choice([-0.0, 0.0, 0.25], size=H).astype(np.float32)
            if name == "cta_nan":
                risk[H - 2] = np.nan
                avail[H - 2] = [0.75, 0.75, 1.0, 1.0]
            kw["risk"] = risk
    return (avail, demands, valid, new_group, anchor, cost, bw, host_zone,
            counts), kw


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", EDGE_CASES)
def test_plain_matches_pallas_selection_edges(case, mode):
    args, kw = edge_inputs(case)
    ref = cost_aware_pallas(*map(jnp.asarray, args), **mode, interpret=True,
                            **{k: jnp.asarray(v) for k, v in kw.items()})
    new = ck.cost_aware_plain(*map(torch.from_numpy, args), **mode,
                              **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert_close(ref, new, (case, mode))
    placed = set(new[0].tolist())
    if case == "ties":
        assert {31, 32, 63, 64} <= placed
    if case == "nan_only" and mode["sort_hosts"]:
        assert placed == {-1}  # a NaN minimum never places
    if case == "zero_bw":
        assert -1 in placed


def owned_hosts(cfg, H):
    """The hosts each thread of ``cfg``'s replica owns, all CTAs of it
    together, in the kernel's layout: CTA c of C holds [c·w, c·w + w),
    w = ⌈H / C⌉, and its thread t the hosts c·w + K·t + k, k < K (one
    CTA: C = 1, w = H); the global form's thread t the hosts t, t + 1024,
    ...  Returns the sorted array (with repeats, if any)."""
    if cfg.state == "global":
        t = np.arange(cfg.threads)
        return np.sort(np.concatenate(
            [np.arange(i, H, cfg.threads) for i in t]))
    C = cfg.cluster
    w = -(-H // C)
    K = cfg.hosts_per_thread
    slots = (np.arange(32 * cfg.warps)[:, None] * K
             + np.arange(K)[None, :]).ravel()
    out = []
    for c in range(C):
        c0, c1 = min(c * w, H), min(c * w + w, H)
        h = c0 + slots
        out.append(h[h < c1])
    return np.sort(np.concatenate(out))


@pytest.mark.parametrize("R", [1, 5, 256])
@pytest.mark.parametrize("H", [1, 31, 32, 33, 600, 9664, 10240, 10241,
                               20480, 98304, ck.CLUSTER_MAX_HOSTS,
                               ck.CLUSTER_MAX_HOSTS + 1, 262144])
def test_launch_config_owns_every_host_once(H, R):
    """The kernel's layout covers every host exactly once, across the
    CTAs of a cluster: one CTA (thread t of a W-warp group owns the hosts
    K·t + k, k < K) up to ``MAX_HOSTS``, a cluster of C ∈ {2, 4, 8, 16}
    CTAs (a power of two) up to ``CLUSTER_MAX_HOSTS``, then the global
    form; each block within 1,024 threads and 227 KB of shared
    memory."""
    cfg = ck._launch_config(R, H, 31)
    W, K, C = cfg.warps, cfg.hosts_per_thread, cfg.cluster
    assert np.array_equal(owned_hosts(cfg, H), np.arange(H))
    assert cfg.threads == 32 * W * cfg.groups <= 1024
    assert cfg.smem_bytes <= 232448
    assert C in (1, 2, 4, 8, 16)
    if H <= ck.MAX_HOSTS:
        assert C == 1 and cfg.state != "global"
        assert cfg.groups * cfg.blocks >= R > (cfg.blocks - 1) * cfg.groups
    elif H <= ck.CLUSTER_MAX_HOSTS:
        assert cfg.state == "shared" and C > 1
        assert -(-H // C) <= ck.MAX_HOSTS < -(-H // (C // 2)) or C == 2
        assert cfg.blocks == R * C and cfg.groups == 1
    else:
        assert cfg.state == "global" and cfg.blocks == R
        assert cfg.threads == 1024 and cfg.groups == 1
    if cfg.smem_state:
        assert K == ck._SMEM_K and cfg.groups == 1
    elif cfg.state == "registers":
        assert cfg.threads <= ck._REG_THREADS[K]
    if W > 1 and cfg.state == "registers":
        assert cfg.groups <= 15  # named barriers 1..15, one per group


def test_launch_config_takes_every_host_count():
    """Every H from 1 to 400,000 at R ∈ {1, 5, 256} gets a shape whose
    CTAs hold at least H hosts between them, each CTA at least its slice
    and within the opt-in; only tables that outgrow shared memory
    raise."""
    launch_config = ck._launch_config.__wrapped__  # no cache churn
    for R in (1, 5, 256):
        for H in range(1, 400_001):
            cfg = launch_config(R, H, 31)
            if cfg.state == "global":
                assert H > ck.CLUSTER_MAX_HOSTS and cfg.threads == 1024
                continue
            per_cta = 32 * cfg.warps * cfg.hosts_per_thread
            assert per_cta >= -(-H // cfg.cluster), (R, H, cfg)
            assert cfg.smem_bytes <= ck._SMEM_LIMIT, (R, H, cfg)
    with pytest.raises(ValueError, match="227 KB"):
        launch_config(1, 600, 171)
    assert launch_config(1, 600, 170).state == "global"


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CTA_EDGE_CASES)
def test_plain_matches_pallas_cta_edges(case, mode):
    """The edge cases of a replica split over a cluster's CTAs, past
    10,240 hosts: the plain version against ``cost_aware_pallas`` in
    f32 (interpret mode) and ``cost_aware_kernel`` (x64 configured, f32
    operands).  ``cta_nan`` is held against the Pallas kernel alone: on
    a NaN minimum the XLA form places on the last host where the Pallas
    kernel, which ``greedy_place`` ports, gives −1."""
    args, kw = edge_inputs(case)
    jargs = [jnp.asarray(a) for a in args]
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    new = ck.cost_aware_plain(*map(torch.from_numpy, args), **mode,
                              **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert_close(cost_aware_pallas(*jargs, **mode, interpret=True, **jkw),
                 new, (case, mode, "pallas"))
    if case != "cta_nan":
        assert_close(cost_aware_kernel(*jargs, **mode, **jkw), new,
                     (case, mode, "xla"))
    H, w = len(args[0]), cta_slice(len(args[0]))
    placed = new[0][new[0] >= 0].numpy()
    if case == "cta_ties":
        order = new[0].tolist()
        pairs = [b for b in range(w, H, w) if b in order]
        assert pairs or not mode["sort_hosts"]
        for b in pairs:  # the tie's lower host (CTA c − 1's) first
            assert b - 1 in order[:order.index(b)]
    elif case == "cta_last":
        assert placed.size and (placed >= (H - 1) // w * w).all()
    elif case == "cta_masked":
        assert placed.size and (placed >= w).all()
        assert torch.equal(new[1][:w], torch.from_numpy(args[0][:w]))
    elif case == "cta_nan":
        assert H - 2 not in placed.tolist()
        assert (new[0][np.asarray(args[2])] == -1).any()


def test_plain_empty_tick():
    args = make_inputs(0, 0, 8)
    p, a = ck.cost_aware_plain(*as_torch(args), **MODES[0])
    assert p.shape == (0,)
    assert torch.equal(a, torch.from_numpy(np.array(args[0])))
    avail_r = np.stack([np.asarray(args[0])] * 2)
    p, a = ck.cost_aware_plain_batched(torch.from_numpy(avail_r),
                                       *as_torch(args[1:]))
    assert p.shape == (2, 0)
    assert torch.equal(a, torch.from_numpy(avail_r))


def test_plain_no_fit_and_invalid():
    """Unplaceable and invalid tasks yield −1 and leave avail alone."""
    args = as_torch(make_inputs(0, 4, 6))
    avail = torch.full((6, 4), 0.5)
    demands = torch.full((4, 4), 99.0)
    valid = torch.tensor([True, True, False, False])
    for mode in (MODES[0], MODES[3]):
        p, out = ck.cost_aware_plain(avail, demands, valid, *args[3:], **mode)
        assert p.tolist() == [-1, -1, -1, -1]
        assert torch.equal(out, avail)


def test_plain_live_mask_matches_pallas():
    args = make_inputs(4, 64, 24)
    rng = np.random.default_rng(1)
    live = np.ones(24, bool)
    live[rng.choice(24, size=6, replace=False)] = False
    for mode in (MODES[0], MODES[3]):
        ref = cost_aware_pallas(*args, **mode, interpret=True,
                                live=jnp.asarray(live))
        new = ck.cost_aware_plain(*as_torch(args), **mode,
                                  live=torch.from_numpy(live))
        assert_close(ref, new, mode)
        placed = new[0][new[0] >= 0].numpy()
        assert live[placed].all()
        assert torch.equal(new[1][~torch.from_numpy(live)],
                           torch.from_numpy(np.array(args[0]))[~live])


@pytest.mark.parametrize(
    "mode", [MODES[0], MODES[2], MODES[4]], ids=["ff-sorted", "ff-index",
                                                  "bf-decay"],
)
def test_plain_risk_matches_pallas(mode):
    args = make_inputs(5, 90, 40)
    risk = np.random.default_rng(17).choice([0.0, 0.4, 1.5], size=40)
    risk = risk.astype(np.float32)
    ref = cost_aware_pallas(*args, **mode, risk=jnp.asarray(risk),
                            interpret=True)
    assert_close(ref, ck.cost_aware_plain(*as_torch(args), **mode,
                                          risk=torch.from_numpy(risk)), mode)


def test_plain_n_eff_stops_after_last_valid():
    """Walking to one past the last valid task gives the full walk's
    result — the contract the policy relies on when it passes n_eff."""
    args = as_torch(make_inputs(6, 128, 30))
    args[2][100:] = False
    for mode in MODES:
        full = ck.cost_aware_plain(*args, **mode)
        cut = ck.cost_aware_plain(*args, **mode, n_eff=100)
        assert torch.equal(full[0], cut[0]) and torch.equal(full[1], cut[1])
    with pytest.raises(ValueError, match="n_eff"):
        ck.cost_aware_plain(*args, n_eff=129)


def test_wrapper_on_cpu_is_plain_and_counts_no_launch():
    args = as_torch(make_inputs(2, 60, 20))
    ck.reset_launches()
    for mode in MODES:
        got = ck.cost_aware_cuda(*args, **mode)
        want = ck.cost_aware_plain(*args, **mode)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    avail_r = torch.stack([args[0], args[0] * 0.5])
    got = ck.cost_aware_cuda_batched(avail_r, *args[1:])
    want = ck.cost_aware_plain_batched(avail_r, *args[1:])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ck.LAUNCHES["greedy_place"] == 0


def test_wrapper_checks_its_arguments():
    args = as_torch(make_inputs(0, 9, 8))
    with pytest.raises(TypeError, match="avail"):
        ck.cost_aware_cuda(args[0].double(), *args[1:])
    with pytest.raises(TypeError, match="base_task_counts"):
        ck.cost_aware_cuda(*args[:8], args[8].long())
    with pytest.raises(ValueError, match="shape"):
        ck.cost_aware_cuda(args[0], args[1][:3], *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        ck.cost_aware_cuda(args[0], *args[1:5], args[5].T, *args[6:])
    with pytest.raises(ValueError, match="bin_pack"):
        ck.cost_aware_cuda(*args, bin_pack="worst-fit")
    wide = torch.zeros(171, 171)  # 233,928 B of tables: past 227 KB
    with pytest.raises(ValueError, match="227 KB"):
        ck.cost_aware_cuda(*args[:5], wide, wide, *args[7:])
    with pytest.raises(ValueError, match="meta"):
        ck.cost_aware_cuda(*(a.to("meta") for a in args))
