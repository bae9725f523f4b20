"""The 2-D ``replica × host`` mesh of the port: the ``[G]``-batched
host-sharded twins of ``ops/shard.py`` and the dispatch batcher's 2-D
routing (``sched/batch.py``), on the CPU in float64 under x64.

``pivot_tpu``'s 2-D forms cannot run here (``shard_map(check_rep=)``
under this jax), but their contract is that each 2-D row is
bit-identical to the unsharded form on that row
(``pivot_tpu/ops/shard.py:15-40``, ``:1626-1628``).  So the port's 2-D
forms, on meshes of ``[cpu] * 8`` laid out (1, 4, 2) and (1, 2, 2), are
held against what runs in ``pivot_tpu``:

  * **twins** — the four ``*_kernel_sharded_batched`` (per-step and
    chunk, the live mask and a risk row) row by row against the
    reference's unsharded kernels; ``sharded_batched_tick_run`` on
    ragged spans (mixed horizons padded to one (K′, B′), the market
    operands, a live mask) against its solo spans and the reference's
    unsharded ``batch_execute`` of ``fused_tick_run``; the
    ``_check_g_axis`` / ``_check_host_axis`` messages word for word;
  * **batcher** — ``_plan_mesh``'s ``(gb, mesh?, host_ok)`` and
    ``_fallback_cause`` against the reference's (they call no
    ``shard_map``) on its 8-device mesh; ``batch_execute(mesh=2-D)``
    and ``DispatchBatcher`` flushes against the reference's unsharded
    ``batch_execute``; ``run_grid_lockstep(mesh=2-D)``; the policy with
    batching × sharding composed.
"""

from __future__ import annotations

import functools
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pivot_tpu.ops import kernels as jk
from pivot_tpu.ops import shard as jsh
from pivot_tpu.ops import tickloop as jt
from pivot_tpu.ops.pallas_kernels import cost_aware_pallas
from pivot_tpu.parallel.mesh import replica_mesh as j_replica_mesh
from pivot_tpu.sched import batch as jb
from pivot_tpu_torch.ops import cuda_kernels as ck
from pivot_tpu_torch.ops import kernels as tk
from pivot_tpu_torch.ops import shard as sh
from pivot_tpu_torch.ops import tickloop as tt
from pivot_tpu_torch.parallel import mesh as pm
from pivot_tpu_torch.sched import batch as pb

from tests.test_torch_kernels import CA_ARGS, assert_same
from tests.test_torch_lockstep import ref_f64  # noqa: F401  (fixture)
from tests.test_torch_ragged import (
    _assert_span_equal,
    _dispatch_all,
    _merge,
    _port_solo,
    _span,
)
from tests.test_two_phase import CA_MODES, make_inputs

CPU = torch.device("cpu")
#: (replica, host) layouts of the CPU meshes.
LAYOUTS = ((4, 2), (2, 2))
MESH_KEYS = ("mesh_dispatches", "mesh_fallbacks",
             "mesh_fallback_unshardable", "mesh_fallback_mixed_shapes",
             "mesh_fallback_indivisible")


def mesh2d(R, S):
    """``build_hybrid_mesh(host_parallel=S)`` over ``[cpu] * (R·S)``."""
    return pm.build_hybrid_mesh(host_parallel=S, devices=[CPU] * (R * S))


def ref_mesh2d(R, S):
    """The reference's hybrid mesh layout over R·S of its CPU devices."""
    devs = np.array(jax.devices()[:R * S]).reshape(1, R, S)
    return jax.sharding.Mesh(devs, ("replica_dcn", "replica", "host"))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _live(H, seed):
    live = np.ones(H, bool)
    live[np.random.default_rng(seed).choice(H, H // 4, replace=False)] = False
    return live


# -- the batched twins ------------------------------------------------------

#: arm → (batched twin, the reference's unsharded kernel).
TWINS = {
    "opportunistic": (sh.opportunistic_kernel_sharded_batched,
                      jk.opportunistic_kernel),
    "first_fit": (sh.first_fit_kernel_sharded_batched, jk.first_fit_kernel),
    "best_fit": (sh.best_fit_kernel_sharded_batched, jk.best_fit_kernel),
    "cost_aware": (sh.cost_aware_kernel_sharded_batched,
                   jk.cost_aware_kernel),
}


def _arm_args(arm, x):
    if arm == "opportunistic":
        return (x["avail"], x["dem"], x["valid"], x["u"])
    if arm == "cost_aware":
        return tuple(x[k] for k in CA_ARGS)
    return (x["avail"], x["dem"], x["valid"])


def _arm_kw(arm, mode):
    if arm == "first_fit":
        return dict(strict=False)
    return dict(mode) if arm == "cost_aware" else {}


@functools.lru_cache(maxsize=None)
def _twin_rows(G=4, H=16, T=24, B=32):
    """G ticks, one a row: numpy operands per row."""
    return tuple(make_inputs(40 + g, T=T, H=H, B=B, group_size=5)
                 for g in range(G))


_REF_ROWS: dict = {}


def _reference_row(arm, g, mode_i, live, risk):
    """The reference's unsharded kernel on row ``g`` (cached)."""
    key = (arm, g, mode_i, live, risk)
    if key not in _REF_ROWS:
        x = _twin_rows()[g]
        H = x["avail"].shape[0]
        kw = dict(_arm_kw(arm, CA_MODES[mode_i]), phase2="slim")
        if live:
            kw["live"] = jnp.asarray(_live(H, g))
        if risk:
            kw["risk"] = jnp.asarray(np.random.default_rng(g).choice(
                [0.0, 0.4, 1.5], size=H))
        _REF_ROWS[key] = TWINS[arm][1](*_arm_args(arm, x), **kw)
    return _REF_ROWS[key]


@pytest.mark.parametrize("phase2", ["auto", 8])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arm", sorted(TWINS))
def test_batched_twins_rows_equal_reference_unsharded(arm, layout, phase2):
    """Each row of the batched twin equals the reference's unsharded
    kernel on that row, with the live mask and a risk row off and on."""
    rows = _twin_rows()
    G = len(rows)
    stacked = {k: torch.from_numpy(np.stack([np.asarray(x[k]) for x in rows]))
               for k in rows[0]}
    m = mesh2d(*layout)
    modes = (0, 3) if arm == "cost_aware" else (0,)
    for live in (False, True):
        for risk in (False, True):
            kw = {}
            if live:
                kw["live"] = torch.from_numpy(np.stack(
                    [_live(16, g) for g in range(G)]))
            if risk:
                kw["risk"] = torch.from_numpy(np.stack([
                    np.random.default_rng(g).choice([0.0, 0.4, 1.5], size=16)
                    for g in range(G)]))
            for mi in modes:
                p, a = TWINS[arm][0](
                    m, *_arm_args(arm, stacked), phase2=phase2,
                    **_arm_kw(arm, CA_MODES[mi]), **kw)
                assert p.shape == (G, 32) and a.shape == (G, 16, 4)
                for g in range(G):
                    assert_same(_reference_row(arm, g, mi, live, risk),
                                (p[g], a[g]), (arm, layout, phase2, g, live,
                                               risk, mi))


def test_batched_twin_empty_batch_passthrough():
    avail = torch.ones((2, 8, 4), dtype=torch.float64)
    dem = torch.zeros((2, 0, 4), dtype=torch.float64)
    p, a = sh.best_fit_kernel_sharded_batched(
        mesh2d(2, 2), avail, dem, torch.zeros((2, 0), dtype=torch.bool))
    assert p.shape == (2, 0) and p.dtype == torch.int32 and a is avail


def test_2d_batched_wrapper_validation():
    """The eager divisibility errors (``tests/test_shard.py::
    test_2d_batched_wrapper_validation``): H must divide the host axis,
    G the replica axis — the reference's ``ValueError`` texts word for
    word; the realtime rows and a bad ``phase2`` are refused."""
    rng = np.random.default_rng(0)
    m, ref = mesh2d(4, 2), ref_mesh2d(4, 2)
    bad_h = (torch.from_numpy(rng.uniform(1, 4, (4, 15, 4))),
             torch.from_numpy(rng.uniform(0.3, 1.0, (4, 8, 4))),
             torch.ones((4, 8), dtype=torch.bool))
    with pytest.raises(ValueError, match="host shards") as got:
        sh.first_fit_kernel_sharded_batched(m, *bad_h)
    with pytest.raises(ValueError) as want:
        jsh._check_host_axis(15, ref)
    assert str(got.value) == str(want.value)
    bad_g = (torch.from_numpy(rng.uniform(1, 4, (3, 16, 4))),
             torch.from_numpy(rng.uniform(0.3, 1.0, (3, 8, 4))),
             torch.ones((3, 8), dtype=torch.bool))
    with pytest.raises(ValueError, match="replica shards") as got:
        sh.first_fit_kernel_sharded_batched(m, *bad_g)
    with pytest.raises(ValueError) as want:
        jsh._check_g_axis(ref, 3)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        sh._check_g_axis(mesh2d(2, 2), 5)
    with pytest.raises(ValueError) as want:
        jsh._check_g_axis(ref_mesh2d(2, 2), 5)
    assert str(got.value) == str(want.value)
    ok = (torch.from_numpy(rng.uniform(1, 4, (4, 16, 4))),
          torch.from_numpy(rng.uniform(0.3, 1.0, (4, 8, 4))),
          torch.ones((4, 8), dtype=torch.bool))
    with pytest.raises(ValueError, match="phase2"):
        sh.best_fit_kernel_sharded_batched(m, *ok, phase2="bogus")
    x = make_inputs(0, T=8, H=16, B=8)
    ca = [torch.from_numpy(np.stack([np.asarray(x[k])] * 4))
          for k in CA_ARGS]
    with pytest.raises(ValueError, match="realtime"):
        sh.cost_aware_kernel_sharded_batched(
            m, *ca, rt_bw_rows=torch.ones((4, 2, 16), dtype=torch.float64),
            rt_bw_idx=torch.zeros((4, 8), dtype=torch.int32))


# -- the batched span driver -------------------------------------------------

#: Ragged rows: (n_ticks, slot bucket, seed), four of them (G divides
#: both layouts' replica axes).
_MIX4 = ((3, 8, 3), (11, 32, 4), (1, 8, 5), (6, 16, 6))


def _ragged_rows(config, market, live):
    lv = None
    if live:
        lv = np.ones(16, bool)
        lv[5] = lv[11] = False
    reqs = [_span(config, n, b, s, market, lv) for n, b, s in _MIX4]
    padded, static_kw, trims = _merge(reqs)
    return reqs, padded, static_kw, trims


@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("market", [False, True])
@pytest.mark.parametrize("config", ["opportunistic", "first_fit_decreasing",
                                    "best_fit", "cost_aware_ff",
                                    "cost_aware_bf_decay"])
def test_sharded_batched_tick_run_ragged_rows(config, market, live):
    """G = 4 spans of different horizons padded to one (K′, B′): each row
    of ``sharded_batched_tick_run`` (``n_ticks_dyn`` a [G] operand, step
    bounds read from ``arrive``) trimmed back equals its solo span, its
    solo ``sharded_fused_tick_run`` and the reference's unsharded
    ``batch_execute`` row."""
    reqs, padded, static_kw, trims = _ragged_rows(config, market, live)
    want = jb.batch_execute(jt.fused_tick_run, padded, static_kw)
    names = sorted(padded[0][1])
    stacked = [torch.from_numpy(np.stack([r[0][i] for r in padded]))
               for i in range(3)]
    kw = {k: (np.stack([r[1][k] for r in padded])
              if k in tt.SPAN_HOST_OPERANDS else
              torch.from_numpy(np.stack([r[1][k] for r in padded])))
          for k in names}
    horizons = np.array([int(r[0][3]) for r in padded], np.int32)
    for layout in LAYOUTS:
        m = mesh2d(*layout)
        got = sh.sharded_batched_tick_run(m, *stacked, horizons, **kw,
                                          **static_kw)
        for g, ((args, arr_kw, own), (k, b)) in enumerate(zip(reqs, trims)):
            row = tt.SpanResult(*(f[g] for f in got))
            trimmed = tt.ragged_span_trim(row, k, b)
            _assert_span_equal(trimmed, _port_solo(args, arr_kw, own),
                               (config, layout, g))
            _assert_span_equal(trimmed, jt.ragged_span_trim(want[g], k, b),
                               (config, layout, g))
            hkw = {key: v if key in tt.SPAN_HOST_OPERANDS
                   else torch.from_numpy(np.array(v))
                   for key, v in arr_kw.items()}
            solo = sh.sharded_fused_tick_run(
                m, *(torch.from_numpy(np.array(a)) for a in args[:3]),
                int(args[3]), **hkw, **own)
            _assert_span_equal(trimmed, solo, (config, layout, g))


# -- the batcher's 2-D routing ---------------------------------------------

#: (port form, the reference's) pairs the routing grid walks: three with
#: a host-sharded twin, and the hand kernel (the Pallas kernel) without.
_KERNEL_PAIRS = (
    (tk.first_fit_impl, jk.first_fit_kernel),
    (tk.cost_aware_impl, jk.cost_aware_kernel),
    (tt.fused_tick_run, jt.fused_tick_run),
    (ck.cost_aware_cuda, cost_aware_pallas),
)
_ARR_KW = ((), ("live",), ("rt_bw_idx", "rt_bw_rows"))


def test_plan_mesh_2d_equals_reference():
    """``_plan_mesh``'s ``(padded bucket, mesh?, host_ok)`` equal the
    reference's on its 2-D CPU meshes — and on a replica-only mesh and
    none — for a grid of (form, g, H, array keywords)."""
    meshes = [(mesh2d(R, S), ref_mesh2d(R, S)) for R, S in LAYOUTS]
    meshes += [(pm.replica_mesh(devices=[CPU] * 4), j_replica_mesh(4)),
               (None, None)]
    n = 0
    for port_mesh, ref_mesh in meshes:
        for pk, rk in _KERNEL_PAIRS:
            for H in (8, 12, 16):
                args0 = (np.zeros((H, 4)),)
                for keys in _ARR_KW:
                    for g in range(1, 10):
                        gb, fm, ok = pb._plan_mesh(port_mesh, pk, g, args0,
                                                   keys)
                        rgb, rfm, rok = jb._plan_mesh(ref_mesh, rk, g, args0,
                                                      keys)
                        assert (gb, fm is not None, ok) == (
                            rgb, rfm is not None, rok), (pk, H, keys, g)
                        n += ok
    assert n > 0
    # A 3-row group on replica 2 pads to 4 and rides the 2-D program.
    m = mesh2d(2, 2)
    assert pb._plan_mesh(m, tk.first_fit_impl, 3, (np.zeros((8, 4)),)) == (
        4, m, True)
    # A span served by greedy_place has no twin: the replica-only path.
    assert pb._plan_mesh(m, tt.fused_tick_run, 3, (np.zeros((8, 4)),), (),
                         {"greedy": ck.cost_aware_cuda}) == (4, m, False)


def _cause_request(mod, kernel, keys):
    args = (np.zeros((16, 4)),)
    return mod._Request(0, kernel, args, {k: np.zeros(2) for k in keys}, {})


def test_fallback_cause_equals_reference():
    """The three fallback causes (unshardable, mixed shapes,
    indivisible) equal the reference batcher's on a 2-D and on a
    replica-only mesh."""
    for (pm_, rm) in ((mesh2d(4, 2), ref_mesh2d(4, 2)),
                      (pm.replica_mesh(devices=[CPU] * 4), j_replica_mesh(4))):
        port, ref = pb.DispatchBatcher(2, mesh=pm_), jb.DispatchBatcher(
            2, mesh=rm)
        for pk, rk in _KERNEL_PAIRS:
            for keys in _ARR_KW:
                for fragmented in (False, True):
                    assert port._fallback_cause(
                        _cause_request(pb, pk, keys), fragmented) == \
                        ref._fallback_cause(_cause_request(jb, rk, keys),
                                            fragmented), (pk, keys)
    span = pb._Request(0, tt.fused_tick_run, (np.zeros((16, 4)),), {},
                       {"greedy": ck.cost_aware_cuda})
    assert pb.DispatchBatcher(2, mesh=mesh2d(4, 2))._fallback_cause(
        span, True) == "unshardable"


def _requests(arm, seeds, H=16, T=24, B=32, live=False):
    """``tests/test_shard.py::_2d_requests`` for the port: (port form,
    reference kernel, requests as host numpy, static keywords)."""
    reqs = []
    for s in seeds:
        x = make_inputs(s, T=T, H=H, B=B, group_size=5)
        kw = {}
        if live:
            kw["live"] = _live(H, s)
        if arm != "opportunistic":
            kw["totals"] = np.asarray(x["totals"])
        reqs.append((tuple(np.asarray(a) for a in _arm_args(arm, x)), kw))
    impl = {"opportunistic": tk.opportunistic_impl,
            "first_fit": tk.first_fit_impl, "best_fit": tk.best_fit_impl,
            "cost_aware": tk.cost_aware_impl}[arm]
    return impl, TWINS[arm][1], reqs, _arm_kw(arm, CA_MODES[0])


def _assert_outs_equal(got, want, ctx):
    for (p, a), (rp, ra) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(p), np.asarray(rp),
                                      err_msg=str(ctx))
        ra = np.asarray(ra)
        assert np.array_equal(a.numpy().view(np.int64), ra.view(np.int64)), \
            ctx


@pytest.mark.parametrize("g", [1, 2, 3, 5])
@pytest.mark.parametrize("arm", sorted(TWINS))
def test_batch_execute_2d_matches_reference_unsharded(arm, g, monkeypatch):
    """``batch_execute(mesh=2-D)`` against the reference's unsharded
    ``batch_execute`` and the port's meshless flush, the live mask on:
    a group runs its batched twin (padded to the replica axis), a lone
    request its 1-D twin."""
    impl, ref, reqs, static = _requests(arm, range(g), live=True)
    calls = []
    for table, key in ((sh._BATCHED_TWINS, "batched"),
                       (sh._SHARDED_TWINS, "twin")):
        orig = table[impl]

        def spy(*a, _orig=orig, _key=key, **k):
            calls.append((_key, a[1].shape[0] if _key == "batched" else 1))
            return _orig(*a, **k)

        monkeypatch.setitem(table, impl, spy)
    got = pb.batch_execute(impl, reqs, static, mesh=mesh2d(4, 2))
    want = jb.batch_execute(
        ref, [(tuple(jnp.asarray(a) for a in r), k) for r, k in reqs],
        static)
    plain = pb.batch_execute(impl, reqs, static, device="cpu")
    _assert_outs_equal(got, want, (arm, g))
    _assert_outs_equal(plain, want, (arm, g, "meshless"))
    assert calls == ([("twin", 1)] if g == 1
                     else [("batched", -(-g // 4) * 4)])


def test_2d_small_group_pads_onto_mesh():
    """A group smaller than the replica axis still rides the 2-D mesh
    (``tests/test_shard.py::test_2d_small_group_pads_onto_mesh``): 2
    requests pad to bucket 4 on replica 4, bit-identically, and the
    batcher's counters agree (one mesh dispatch, no fallback)."""
    impl, ref, reqs, static = _requests("first_fit", [0, 1], H=64)
    m = mesh2d(4, 2)
    gb, fn_mesh, host_ok = pb._plan_mesh(m, impl, 2, reqs[0][0])
    assert (gb, host_ok) == (4, True) and fn_mesh is m
    seq = [jb.batch_execute(ref, [r], static)[0] for r in reqs]
    _assert_outs_equal(pb.batch_execute(impl, reqs, static, mesh=m), seq, 0)
    batcher = pb.DispatchBatcher(2, mesh=m)
    requests = [pb._Request(i, impl, r[0], r[1], static)
                for i, r in enumerate(reqs)]
    batcher._flush(requests)
    assert batcher.stats["mesh_dispatches"] == 1
    assert batcher.stats["mesh_fallbacks"] == 0
    _assert_outs_equal([r.result for r in requests], seq, 1)


def test_2d_g1_flush_runs_host_sharded_twin(monkeypatch):
    """A lone request on a 2-D mesh runs the 1-D host-sharded twin, not
    the unsharded call — through ``batch_execute`` and through a
    batcher's single-live-slot fast path — bit-identically."""
    impl, ref, reqs, static = _requests("first_fit", [3])
    seen = []
    orig = sh._SHARDED_TWINS[impl]

    def twin(mesh, *a, **k):
        seen.append(dict(mesh.shape))
        return orig(mesh, *a, **k)

    monkeypatch.setitem(sh._SHARDED_TWINS, impl, twin)
    want = jb.batch_execute(ref, reqs, static)
    m = mesh2d(4, 2)
    _assert_outs_equal(pb.batch_execute(impl, reqs, static, mesh=m), want, 0)
    client = pb.DispatchBatcher(1, mesh=m).client()
    out = client.dispatch(impl, reqs[0][0], reqs[0][1], static)
    _assert_outs_equal([out], want, 1)
    assert seen == [m.shape] * 2


def test_mesh_fallback_metered_and_logged_once():
    """A coalesced flush whose padded bucket does not divide the replica
    axis drops the mesh (``tests/test_shard.py::
    test_mesh_fallback_metered_and_logged_once``): metered, logged once,
    the outputs equal to the sequential oracle."""
    impl, ref, reqs, static = _requests("first_fit", [0, 1, 2], H=64)
    batcher = pb.DispatchBatcher(3, mesh=pm.replica_mesh(devices=[CPU] * 8))
    records = []
    handler = logging.Handler(level=logging.WARNING)
    handler.emit = records.append
    log = logging.getLogger(pb.__name__)
    log.addHandler(handler)
    try:
        seq = [jb.batch_execute(ref, [r], static)[0] for r in reqs]
        for flush in (1, 2):
            requests = [pb._Request(i, impl, r[0], r[1], static)
                        for i, r in enumerate(reqs)]
            batcher._flush(requests)  # bucket 4 does not divide replica 8
            _assert_outs_equal([r.result for r in requests], seq, flush)
            assert batcher.stats["mesh_fallbacks"] == flush
            assert batcher.stats["mesh_fallback_indivisible"] == flush
            assert batcher.stats["mesh_dispatches"] == 0
    finally:
        log.removeHandler(handler)
    assert len([r for r in records
                if "mesh_fallbacks" in r.getMessage()]) == 1


def _ca_request(seed, T_used, T=32, H=16):
    """A float32 Cost-Aware kernel request (``tests/test_pallas.py``'s
    operands), ``T_used`` of its T tasks valid."""
    from tests.test_pallas import make_inputs as kernel_inputs

    args = [np.array(a) for a in kernel_inputs(seed, T, H)]
    args[2][T_used:] = False
    return tuple(args), {"n_eff": np.int32(T_used)}


@pytest.mark.parametrize("g", [2, 3])
def test_unshardable_kernel_group_keeps_replica_path(g, monkeypatch):
    """The Cost-Aware kernel call has no host-sharded twin (the
    reference's Pallas exclusion): on a 2-D batcher its group is one
    per-row call over the padded bucket when the bucket divides the
    replica axis (3 rows → 4 on replica 4), else it falls back with the
    cause ``unshardable`` (2 rows → 2 on replica 4).  Rows equal the
    meshless flush's."""
    make = [_ca_request(s, T) for s, T in zip(range(g), (32, 7, 19))]
    mode = dict(bin_pack="first-fit", sort_hosts=True, host_decay=False)
    calls = []
    orig = ck.cost_aware_cuda_rows

    def counting(*a, **k):
        calls.append(a[0].shape[0])
        return orig(*a, **k)

    monkeypatch.setattr(ck, "cost_aware_cuda_rows", counting)
    batcher = pb.DispatchBatcher(g, mesh=mesh2d(4, 2))
    requests = [pb._Request(i, ck.cost_aware_cuda, a, k, mode)
                for i, (a, k) in enumerate(make)]
    batcher._flush(requests)
    plain = pb.batch_execute(ck.cost_aware_cuda, make, mode, device="cpu")
    assert calls == [pb.group_bucket(g)] * 2
    for r, (pp, pa) in zip(requests, plain):
        np.testing.assert_array_equal(r.result[0], pp)
        assert torch.equal(r.result[1], pa)
    st = batcher.stats
    assert st["mesh_dispatches"] == (g == 3)
    assert st["mesh_fallback_unshardable"] == (g == 2)
    assert st["mesh_fallbacks"] == sum(
        st[f"mesh_fallback_{c}"] for c in ("unshardable", "mixed_shapes",
                                           "indivisible"))


def test_realtime_bw_requests_stay_on_single_device_program():
    """Requests carrying the realtime-bandwidth rows have no sharded form
    (``tests/test_serve_2d.py::
    test_realtime_bw_requests_stay_on_single_device_program``): on a 2-D
    mesh they keep the unsharded call, groups and a lone request alike,
    equal to the reference's unsharded flush."""
    H, B, Z, G = 16, 16, 3, 2

    def req(seed):
        r = np.random.default_rng(seed)
        dem = np.zeros((B, 4))
        dem[:10] = r.uniform(0.3, 1.5, (10, 4))
        valid = np.zeros(B, bool)
        valid[:10] = True
        ng = np.zeros(B, bool)
        ng[0] = True
        return ((r.uniform(1, 6, (H, 4)), dem, valid, ng,
                 r.integers(0, Z, B).astype(np.int32),
                 r.uniform(0.01, 0.2, (Z, Z)), r.uniform(50, 500, (Z, Z)),
                 r.integers(0, Z, H).astype(np.int32),
                 r.integers(0, 3, H).astype(np.int32)),
                {"rt_bw_rows": r.uniform(50, 500, (2, H)),
                 "rt_bw_idx": np.zeros(B, np.int32)})

    reqs = [req(s) for s in range(G)]
    static = dict(bin_pack="first-fit", sort_hosts=True)
    m = mesh2d(4, 2)
    assert not pb._plan_mesh(m, tk.cost_aware_impl, G, reqs[0][0],
                             reqs[0][1])[2]
    want = jb.batch_execute(
        jk.cost_aware_kernel,
        [(tuple(jnp.asarray(a) for a in r), {k: jnp.asarray(v)
                                             for k, v in kw.items()})
         for r, kw in reqs], static)
    _assert_outs_equal(pb.batch_execute(tk.cost_aware_impl, reqs, static,
                                        mesh=m), want, "group")
    _assert_outs_equal(pb.batch_execute(tk.cost_aware_impl, reqs[:1], static,
                                        mesh=m), want[:1], "lone")


def test_ragged_mesh_flush_rides_mesh_where_sameshape_falls_back():
    """``tests/test_ragged.py::
    test_ragged_mesh_flush_rides_mesh_where_sameshape_falls_back`` on the
    port's 2-D mesh: a mixed-horizon pair that the exact-shape path
    splits into two singleton keys (``mesh_fallback_mixed_shapes``) rides
    the mesh as one merged 2-D dispatch under ragged, with the same
    bits."""
    reqs = [_span("cost_aware_ff", 3, 8, 3), _span("cost_aware_ff", 11, 32, 4)]
    solo = [_port_solo(*r) for r in reqs]
    frag = pb.DispatchBatcher(2, mesh=mesh2d(4, 2), ragged=False)
    for o, s in zip(_dispatch_all(frag, reqs), solo):
        _assert_span_equal(o, s)
    assert frag.stats["mesh_fallbacks"] == 2
    assert frag.stats["mesh_fallback_mixed_shapes"] == 2
    assert frag.stats["mesh_dispatches"] == 0
    merged = pb.DispatchBatcher(2, mesh=mesh2d(4, 2), ragged=True)
    for o, s in zip(_dispatch_all(merged, reqs), solo):
        _assert_span_equal(o, s)
    assert merged.stats["mesh_fallbacks"] == 0
    assert merged.stats["mesh_dispatches"] == 1
    assert merged.stats["ragged_merges"] == 1


# -- the policy and the lock-step grid --------------------------------------


def test_2d_policy_compose_place_parity():
    """Batching × sharding composed, in either order, through the whole
    policy path (``tests/test_shard.py::test_2d_policy_compose_place_
    parity``): a solo policy's ``place`` (the batcher's single-slot fast
    path → the 1-D twin) equals ``pivot_tpu``'s unsharded policy."""
    from conftest import load_root_module
    from pivot_tpu.sched.tpu import TpuCostAwarePolicy
    from pivot_tpu.utils import reset_ids as jreset
    from pivot_tpu_torch.sched.cuda import CudaCostAwarePolicy
    from pivot_tpu_torch.utils import reset_ids as preset

    from tests.test_torch_shard import _port_bench_batch

    bench = load_root_module("bench")
    jreset()
    jctx = bench._build_batch(64, 40, seed=3)
    single = TpuCostAwarePolicy(sort_tasks=True, sort_hosts=True)
    single.dtype = jnp.float64
    single.bind(jctx.scheduler)
    want = np.asarray(single.place(jctx))
    m = mesh2d(4, 2)
    for sharding_first in (True, False):
        preset()
        pctx = _port_bench_batch(64, 40, 3)
        pol = CudaCostAwarePolicy(sort_tasks=True, sort_hosts=True,
                                  device="cpu")
        pol.dtype = torch.float64
        client = pb.DispatchBatcher(1, mesh=m).client()
        if sharding_first:
            pol.enable_sharding(m)
            pol.enable_batching(client)
        else:
            pol.enable_batching(client)
            pol.enable_sharding(m)
        pol.bind(pctx.scheduler)
        np.testing.assert_array_equal(np.asarray(pol.place(pctx)), want)


def test_batching_times_sharding_checks_the_host_axis():
    """A sharded policy needs a 2-D batcher mesh whose host axis matches
    its own — the reference's text; a mismatch is refused in either
    order and leaves no partial state."""
    from pivot_tpu_torch.sched import cuda as pc

    hosts2 = pm.host_sharded_mesh(devices=[CPU] * 2)
    for bmesh in (mesh2d(2, 4), None, pm.replica_mesh(devices=[CPU] * 2)):
        client = pb.DispatchBatcher(
            1, device="cpu", **({} if bmesh is None else {"mesh": bmesh})
        ).client()
        pol = pc.CudaFirstFitPolicy(device="cpu")
        pol.enable_sharding(hosts2)
        with pytest.raises(ValueError, match="build_hybrid_mesh") as exc:
            pol.enable_batching(client)
        assert "host axis matches enable_sharding's (2 shards)" in str(
            exc.value)
        assert pol._batch_client is None
        pol2 = pc.CudaFirstFitPolicy(device="cpu")
        pol2.enable_batching(client)
        with pytest.raises(ValueError, match="2-D replica x host mesh"):
            pol2.enable_sharding(hosts2)
        assert pol2._mesh is None
    pol = pc.CudaFirstFitPolicy(device="cpu")
    pol.enable_sharding(hosts2)
    pol.enable_batching(pb.DispatchBatcher(1, mesh=mesh2d(4, 2)).client())
    assert pol._batch_client is not None and pol._mesh is hosts2


def test_lockstep_grid_on_the_2d_mesh(ref_f64, monkeypatch):
    """``run_grid_lockstep(mesh=2-D)``: each coalesced flush runs the 2-D
    program; per-tick placements and summaries equal the meshless grid
    and ``pivot_tpu``'s meshless ``run_grid_lockstep``."""
    from pivot_tpu.experiments.runner import run_grid_lockstep as jlock
    from pivot_tpu.utils import config as jconfig
    from pivot_tpu.utils import reset_ids as j_reset
    from pivot_tpu_torch.experiments.runner import run_grid_lockstep
    from pivot_tpu_torch.utils import reset_ids

    from tests.test_torch_lockstep import (
        assert_logs_equal,
        grid_runs,
        port_policy,
        record,
        strip,
    )

    batched = []
    for form in (tk.cost_aware_impl, tt.fused_tick_run):
        def spy(*a, _orig=sh._BATCHED_TWINS[form], **k):
            batched.append(a[1].shape[0])
            return _orig(*a, **k)

        monkeypatch.setitem(sh._BATCHED_TWINS, form, spy)
    results = {}
    for name, mesh in (("plain", None), ("mesh", mesh2d(2, 2))):
        reset_ids()
        runs = grid_runs("pivot_tpu_torch",
                         lambda: port_policy("cost-aware"), 3, n_hosts=8,
                         n_apps=2)
        logs = [record(r) for r in runs]
        stats: dict = {}
        sums = run_grid_lockstep(runs, stats_out=stats, mesh=mesh)
        results[name] = logs, sums, stats
    j_reset()
    runs = grid_runs("pivot_tpu", lambda: jconfig.make_policy(
        jconfig.PolicyConfig(device="tpu", adaptive=False, name="cost-aware",
                             bin_pack="first-fit", sort_tasks=True,
                             sort_hosts=True)), 3, n_hosts=8, n_apps=2)
    ref_logs = [record(r) for r in runs]
    ref_sums = jlock(runs)
    logs, sums, stats = results["mesh"]
    assert_logs_equal(logs, results["plain"][0])
    assert_logs_equal(logs, ref_logs)
    for a, b, c in zip(sums, results["plain"][1], ref_sums):
        assert strip(a) == strip(b)
        keys = set(strip(c)) & set(strip(a))
        assert strip(a, keys) == strip(c, keys)
    assert stats["mesh_dispatches"] > 0 and batched
    assert all(b % 2 == 0 for b in batched)  # padded to the replica axis
    assert stats["mesh_fallbacks"] == sum(
        stats[f"mesh_fallback_{c}"] for c in ("unshardable", "mixed_shapes",
                                              "indivisible"))
    assert all(results["plain"][2][k] == 0 for k in MESH_KEYS)


def test_mesh_refusals_2d():
    """The 2-D mesh is accepted where a replica mesh is; a mesh over
    several distinct devices is not (ROADMAP.md Queue 1, several
    cards)."""
    two_d = mesh2d(2, 2)
    batcher = pb.DispatchBatcher(2, mesh=two_d)
    assert batcher.device == CPU and batcher.client().mesh is two_d
    distinct = pm.build_hybrid_mesh(
        host_parallel=2, devices=[CPU, torch.device("meta")] * 2)
    with pytest.raises(NotImplementedError, match="several cards"):
        pb.DispatchBatcher(2, mesh=distinct)
    with pytest.raises(NotImplementedError, match=sh.SEVERAL_CARDS):
        sh.first_fit_kernel_sharded_batched(
            distinct, torch.ones((2, 8, 4)), torch.ones((2, 4, 4)),
            torch.ones((2, 4), dtype=torch.bool))
