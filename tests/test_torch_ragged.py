"""Ragged span batching and the batched span driver: the port's
``ops/tickloop.py`` ragged helpers, ``fused_tick_run_rows`` and the
batcher's span flushes (``sched/batch.py``) against ``pivot_tpu``'s.

  * **ragged helpers** — ``RAGGED_AXES`` / ``RAGGED_INVARIANT`` equal
    ``pivot_tpu``'s and cover every array operand of the port's
    ``fused_tick_run`` (its ``greedy`` callable and host ``n_bound`` are
    not operands); ``ragged_span_signature`` and ``ragged_span_pad``
    give equal results on the same numpy operands; a padded span trimmed
    back equals its solo span;
  * **batched span driver** — for the four arms, with and without a
    market's risk rows and cost stack and a live mask, at mixed
    horizons padded to one (K′, B′), each row of ``fused_tick_run_rows``
    equals its own ``fused_tick_run`` and ``pivot_tpu``'s
    ``batch_execute`` of the same requests (``jax.vmap(fused_tick_run)``).
    Float64, exact; the Cost-Aware rows served by
    ``cost_aware_cuda_rows`` (its plain version on the CPU) run in
    float32 and equal the per-row ``cost_aware_cuda`` spans exactly and
    ``pivot_tpu``'s float32 spans on placements, availability within
    rtol 1e-6 / atol 1e-5;
  * **batcher** — mixed horizons merge into one device call
    (``ragged_merges`` = 1, ``ragged_rows`` = 2, ``coalesced`` = 2, after
    ``tests/test_ragged.py:253``), ``ragged=False`` fragments them, a
    same-shape flush is untouched; every result equals its solo span.

``pivot_tpu``'s zero-recompile case (``count_compiles``) has no
counterpart here (torch compiles nothing); its mesh case is
``tests/test_torch_mesh_2d.py::test_ragged_mesh_flush_rides_mesh_where_
sameshape_falls_back``.
"""

from __future__ import annotations

import inspect
import threading

import numpy as np
import pytest
import torch

from pivot_tpu.ops import tickloop as jt
from pivot_tpu.sched import batch as jb
from pivot_tpu_torch.ops import cuda_kernels as ck
from pivot_tpu_torch.ops import tickloop as tt
from pivot_tpu_torch.sched.batch import DispatchBatcher, batch_execute

from tests.test_ragged import _CONFIGS, _H, _Z, _staged_span

FIELDS = ("placements", "n_ready", "n_placed", "ticks_run", "n_stack_final",
          "stackpos", "avail")
_P = 4  # market segments


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint64) if x.dtype == np.float64 else x


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(_bits(a), _bits(b))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_span_equal(a, b, label="", tol=False):
    for f in FIELDS:
        x, y = _np(getattr(a, f)), _np(getattr(b, f))
        if tol and f == "avail":
            assert np.allclose(x, y, rtol=1e-6, atol=1e-5), (label, f)
        else:
            assert _equal(x, y), (label, f)


def _t(x):
    return torch.from_numpy(np.array(x))


def _span(config, n_ticks, B, seed, market=False, live=None,
          dtype=np.float64):
    """One staged span request (host numpy, ``tests/test_ragged.py``'s
    layout) with optional market operands, floats in ``dtype``."""
    args, arr_kw, static_kw = _staged_span(_CONFIGS[config], n_ticks, B,
                                           live=live, seed=seed)
    K = static_kw["n_ticks"]
    rng = np.random.default_rng(100 + seed)
    if market:
        arr_kw["risk_rows"] = rng.uniform(0.0, 0.3, (K, _H))
        if static_kw["policy"] == "cost-aware":
            arr_kw["cost_stack"] = rng.uniform(0.01, 0.2, (_P, _Z, _Z))
            arr_kw["cost_seg"] = rng.integers(0, _P, K).astype(np.int32)

    def cast(x):
        return x.astype(dtype) if x.dtype.kind == "f" else x

    args = tuple(cast(a) if getattr(a, "ndim", 0) else a for a in args)
    return args, {k: cast(v) for k, v in arr_kw.items()}, static_kw


def _port_solo(args, arr_kw, static_kw):
    """The port's own span on the request's host operands."""
    kw = {k: v if k in tt.SPAN_HOST_OPERANDS else _t(v)
          for k, v in arr_kw.items()}
    return tt.fused_tick_run(_t(args[0]), _t(args[1]), _t(args[2]),
                             int(args[3]), **kw, **static_kw)


def _merge(reqs):
    """Pad every request to the group's (K′, B′); returns the padded
    requests, the shared statics and each request's own (K, B)."""
    k2 = max(s["n_ticks"] for _, _, s in reqs)
    b2 = max(a[1].shape[0] for a, _, _ in reqs)
    padded, trims = [], []
    for args, arr_kw, static_kw in reqs:
        trims.append((static_kw["n_ticks"], args[1].shape[0]))
        padded.append(tt.ragged_span_pad(args, arr_kw, k2, b2))
    return padded, dict(reqs[0][2], n_ticks=k2), trims


# -- the ragged helpers ----------------------------------------------------------


def test_ragged_tables_equal_reference():
    assert tt.RAGGED_AXES == jt.RAGGED_AXES
    assert tt.RAGGED_INVARIANT == jt.RAGGED_INVARIANT


def test_ragged_axis_tables_cover_span_operands():
    """Every array operand of the port's ``fused_tick_run`` is classified
    (K/B-padded or invariant); ``greedy`` (a callable) and ``n_bound``
    (host step bounds, made from the host ``arrive`` by the batcher) are
    not array operands."""
    sig = inspect.signature(tt.fused_tick_run)
    knobs = {n for n, p in sig.parameters.items()
             if p.kind is p.KEYWORD_ONLY and p.default is None}
    covered = set(tt.RAGGED_AXES) | set(tt.RAGGED_INVARIANT)
    assert knobs - {"greedy", "n_bound"} == covered
    assert tt.SPAN_HOST_OPERANDS <= covered


@pytest.mark.parametrize("market", [False, True])
def test_ragged_signature_and_pad_equal_reference(market):
    a1, k1, s1 = _span("cost_aware_ff", 3, 8, 0, market)
    a2, k2, s2 = _span("cost_aware_ff", 11, 32, 1, market)
    assert tt.ragged_span_signature(a1, k1, s1) == \
        jt.ragged_span_signature(a1, k1, s1)
    assert tt.ragged_span_signature(a1, k1, s1) == \
        tt.ragged_span_signature(a2, k2, s2)
    a3, k3, s3 = _span("best_fit", 3, 8, 0, market)
    assert tt.ragged_span_signature(a3, k3, s3) != \
        tt.ragged_span_signature(a1, k1, s1)
    assert tt.ragged_span_signature(a1[:2], k1, s1) is None
    assert tt.ragged_span_signature(a1, {"bogus": a1[0]}, s1) is None
    pa, pk = tt.ragged_span_pad(a1, k1, 16, 32)
    ja, jk = jt.ragged_span_pad(a1, k1, 16, 32)
    assert all(_equal(x, y) for x, y in zip(pa, ja))
    assert set(pk) == set(jk) and all(_equal(pk[n], jk[n]) for n in pk)
    assert pa[2][8:].tolist() == [16] * 24  # pad slots arrive past K′


@pytest.mark.parametrize("config", ["opportunistic", "first_fit_decreasing",
                                    "cost_aware_ff"])
def test_ragged_pad_trim_parity(config):
    """A span padded to a larger (K′, B′) and trimmed back equals its solo
    span, and the sequential referee."""
    live = np.ones(_H, bool)
    live[3] = False
    for lv in (None, live):
        args, arr_kw, static_kw = _span(config, 3, 8, 0, live=lv)
        solo = _port_solo(args, arr_kw, static_kw)
        pargs, pkw = tt.ragged_span_pad(args, arr_kw, 16, 32)
        padded = _port_solo(pargs, pkw, dict(static_kw, n_ticks=16))
        _assert_span_equal(tt.ragged_span_trim(padded, 4, 8), solo, config)
        ref_p, _nr, _np_, ref_avail = tt.reference_tick_run(
            _t(args[0]), _t(args[1]), _t(args[2]), 3,
            **{k: _t(v) for k, v in arr_kw.items()},
            **{k: v for k, v in static_kw.items() if k != "n_ticks"})
        assert np.array_equal(solo.placements.numpy()[:3], ref_p)
        assert _equal(solo.avail, ref_avail)


# -- the batched span driver -----------------------------------------------------

#: Mixed horizons: (n_ticks, slot bucket, seed) per row.
_MIX = ((3, 8, 3), (11, 32, 4), (1, 8, 5))


def _rows_case(config, market, live, dtype=np.float64, greedy=False):
    lv = None
    if live:
        lv = np.ones(_H, bool)
        lv[5] = lv[11] = False
    reqs = [_span(config, n, b, s, market, lv, dtype) for n, b, s in _MIX]
    padded, static_kw, trims = _merge(reqs)
    if greedy:
        static_kw = dict(static_kw, greedy=ck.cost_aware_cuda)
    got = batch_execute(tt.fused_tick_run, padded, static_kw, device="cpu")
    ref = jb.batch_execute(jt.fused_tick_run, padded,
                           {k: v for k, v in static_kw.items()
                            if k != "greedy"})
    for (args, arr_kw, own), out, want, (k, b) in zip(reqs, got, ref, trims):
        solo = _port_solo(args, arr_kw, dict(
            own, **({"greedy": ck.cost_aware_cuda} if greedy else {})))
        _assert_span_equal(tt.ragged_span_trim(out, k, b), solo, config)
        _assert_span_equal(tt.ragged_span_trim(out, k, b),
                           jt.ragged_span_trim(want, k, b), config,
                           tol=greedy)
    return got


@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("market", [False, True])
@pytest.mark.parametrize("config", ["opportunistic", "first_fit_decreasing",
                                    "best_fit", "cost_aware_ff"])
def test_batched_span_rows_equal_solo_and_reference(config, market, live):
    _rows_case(config, market, live)


@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("market", [False, True])
@pytest.mark.parametrize("config", ["cost_aware_ff", "cost_aware_bf_decay"])
def test_batched_span_rows_kernel_served_f32(config, market, live):
    """Kernel-served Cost-Aware rows: one ``cost_aware_cuda_rows`` call
    per span tick over the G rows (its plain version here; no launch)."""
    calls = []
    orig = ck.cost_aware_cuda_rows

    def counted(*a, **kw):
        calls.append(kw["n_eff_g"].tolist())
        return orig(*a, **kw)

    ck.reset_launches()
    ck.cost_aware_cuda_rows = counted
    try:
        got = _rows_case(config, market, live, np.float32, greedy=True)
    finally:
        ck.cost_aware_cuda_rows = orig
    assert len(calls) == 11  # the longest row's horizon
    assert [len(c) for c in calls] == [3] * 11
    # A row past its own horizon has step bound 0.
    assert calls[-1][0] == 0 and calls[-1][2] == 0 and calls[0][2] > 0
    assert ck.LAUNCHES["greedy_place"] == 0
    assert sum(int((o.placements >= 0).sum()) for o in got) > 0


def test_batched_span_driver_direct_rows():
    """``fused_tick_run_rows`` called on stacked tensors with host bounds
    equals it with bounds read from ``arrive`` and the rows one by one."""
    reqs = [_span("cost_aware_ff", 6, 32, s, True, None, np.float32)
            for s in (1, 2)]
    cols = lambda i: torch.stack([_t(r[0][i]) for r in reqs])  # noqa: E731
    kw = {k: torch.stack([_t(r[1][k]) for r in reqs]) for k in reqs[0][1]}
    kw["cost_seg"] = np.stack([r[1]["cost_seg"] for r in reqs])
    static = dict(reqs[0][2], greedy=ck.cost_aware_cuda_rows)
    a = tt.fused_tick_run_rows(cols(0), cols(1), cols(2), [6, 5],
                               **kw, **static)
    b = tt.fused_tick_run_rows(
        cols(0), cols(1), cols(2), [6, 5],
        n_bound=[tt.span_step_bounds(r[0][2], n) for r, n in
                 zip(reqs, (6, 5))], **kw, **static)
    _assert_span_equal(a, b)
    for g, n in enumerate((6, 5)):
        solo = _port_solo(reqs[g][0][:3] + (n,), reqs[g][1],
                          dict(reqs[g][2], greedy=ck.cost_aware_cuda))
        _assert_span_equal(type(a)(*(f[g] for f in a)), solo)


def test_batched_span_on_other_devices_raises():
    """No fallback hides the card: the per-row pass refuses tensors that
    are neither on the card nor on the CPU."""
    reqs = [_span("cost_aware_ff", 4, 8, s, dtype=np.float32) for s in (0, 1)]
    meta = lambda x: _t(x).to("meta")  # noqa: E731
    cols = lambda i: torch.stack([meta(r[0][i]) for r in reqs])  # noqa: E731
    kw = {k: torch.stack([meta(r[1][k]) for r in reqs]) for k in reqs[0][1]}
    with pytest.raises(ValueError, match="cuda or"):
        tt.fused_tick_run_rows(
            cols(0), cols(1), cols(2), [4, 4],
            n_bound=[tt.span_step_bounds(r[0][2], 4) for r in reqs],
            greedy=ck.cost_aware_cuda_rows, **kw, **reqs[0][2])


# -- the batcher ---------------------------------------------------------------


def _dispatch_all(batcher, reqs):
    clients = [batcher.client() for _ in reqs]
    out, errs = [None] * len(reqs), []

    def work(i):
        try:
            out[i] = clients[i].dispatch(tt.fused_tick_run, *reqs[i])
        except BaseException as exc:  # noqa: BLE001 — surfaced below
            errs.append(exc)
        finally:
            clients[i].close()

    threads = [threading.Thread(target=work, args=(i,), daemon=True)
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    batcher.serve()
    for t in threads:
        t.join(timeout=60)
    assert not errs, errs
    return out


def _mixed(greedy, market=False):
    dtype = np.float32 if greedy else np.float64
    reqs = [_span("cost_aware_ff", 3, 8, 3, market, dtype=dtype),
            _span("cost_aware_ff", 11, 32, 4, market, dtype=dtype)]
    if greedy:
        reqs = [(a, k, dict(s, greedy=ck.cost_aware_cuda))
                for a, k, s in reqs]
    return reqs


@pytest.mark.parametrize("market", [False, True])
@pytest.mark.parametrize("greedy", [False, True])
def test_ragged_batcher_merges_mixed_horizons(greedy, market):
    reqs = _mixed(greedy, market)
    solo = [_port_solo(*r) for r in reqs]
    batcher = DispatchBatcher(2, device="cpu", ragged=True)
    out = _dispatch_all(batcher, reqs)
    for o, s in zip(out, solo):
        _assert_span_equal(o, s)
        assert isinstance(o.placements, np.ndarray)
    st = batcher.stats
    assert st["ragged_merges"] == 1 and st["ragged_rows"] == 2
    assert st["ragged_pad_cells"] == 2 * 16 * 32 - 4 * 8 - 16 * 32
    assert st["device_calls"] == 1 and st["coalesced"] == 2


@pytest.mark.parametrize("market", [False, True])
@pytest.mark.parametrize("greedy", [False, True])
def test_ragged_off_pins_fragmentation(greedy, market):
    """Each shape its own device call (the request's unbatched span, its
    market segments read on the host), results equal to the solo span."""
    reqs = _mixed(greedy, market)
    solo = [_port_solo(*r) for r in reqs]
    batcher = DispatchBatcher(2, device="cpu", ragged=False)
    out = _dispatch_all(batcher, reqs)
    for o, s in zip(out, solo):
        _assert_span_equal(o, s)
    st = batcher.stats
    assert st["ragged_merges"] == 0 and st["ragged_rows"] == 0
    assert st["device_calls"] == 2 and st["coalesced"] == 0


def test_ragged_same_shape_flush_untouched():
    reqs = [_span("first_fit", 5, 8, 7), _span("first_fit", 5, 8, 8)]
    solo = [_port_solo(*r) for r in reqs]
    batcher = DispatchBatcher(2, device="cpu", ragged=True)
    out = _dispatch_all(batcher, reqs)
    for o, s in zip(out, solo):
        _assert_span_equal(o, s)
    assert batcher.stats["ragged_merges"] == 0
    assert batcher.stats["device_calls"] == 1
    assert batcher.stats["coalesced"] == 2


def test_batch_execute_refuses_a_resident_carry():
    carry = tt.resident_carry_init(np.ones((4, 4)), device="cpu")
    with pytest.raises(TypeError, match="resident"):
        batch_execute(tt.fused_tick_run, [((carry,), {})], {}, device="cpu")
