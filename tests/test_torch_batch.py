"""The port's cross-run dispatch batcher (``pivot_tpu_torch.sched.batch``).

Counterparts of ``tests/test_batch_dispatch.py:139-353`` — crash safety
of a flush, the deadline flush, idle slots, the single-live-slot fast
path, ``batch_execute`` against individual calls, ``enable_batching``'s
refusal of the adaptive twin — plus what is the port's own: a coalesced
Cost-Aware flush is ONE call of the per-row form (its plain version on
the CPU), a torch arm's flush runs its rows in sequence, the Cost-Aware
step bound is a per-row operand (ticks of different task counts share a
key), and the stats keys are ``pivot_tpu``'s.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pivot_tpu_torch.ops import cuda_kernels as ck
from pivot_tpu_torch.ops.kernels import (
    best_fit_impl,
    first_fit_impl,
    opportunistic_impl,
)
from pivot_tpu_torch.sched.batch import (
    DispatchBatcher,
    _request_key,
    batch_execute,
    group_bucket,
)

from tests.test_pallas import MODES, make_inputs


def _serve_in_thread(batcher):
    server = threading.Thread(target=batcher.serve, daemon=True)
    server.start()
    return server


def test_flush_exception_propagates_to_owning_slots():
    def boom(x):
        raise RuntimeError("kernel exploded")

    batcher = DispatchBatcher(2, device="cpu")
    clients = [batcher.client() for _ in range(2)]
    x = np.ones((4,), dtype=np.float32)
    results = {}

    def work(slot):
        try:
            try:
                clients[slot].dispatch(boom, (x,))
                results[slot] = "no error"
            except RuntimeError as exc:
                results[slot] = str(exc)
        finally:
            clients[slot].close()

    threads = [threading.Thread(target=work, args=(s,), daemon=True)
               for s in range(2)]
    for t in threads:
        t.start()
    batcher.serve()  # must return — a deadlock here hangs the test
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads), "parked thread leaked"
    assert results == {0: "kernel exploded", 1: "kernel exploded"}


def test_flush_exception_spares_other_groups():
    def boom(x):
        raise RuntimeError("kernel exploded")

    def good(x):
        return x + 1

    batcher = DispatchBatcher(2, device="cpu")
    clients = [batcher.client() for _ in range(2)]
    x = np.ones((4,), dtype=np.float32)
    out = {}

    def work(slot, kernel):
        try:
            try:
                out[slot] = clients[slot].dispatch(kernel, (x,))
            except RuntimeError as exc:
                out[slot] = str(exc)
        finally:
            clients[slot].close()

    threads = [
        threading.Thread(target=work, args=(0, boom), daemon=True),
        threading.Thread(target=work, args=(1, good), daemon=True),
    ]
    for t in threads:
        t.start()
    batcher.serve()
    for t in threads:
        t.join(timeout=30)
    assert out[0] == "kernel exploded"
    np.testing.assert_array_equal(out[1], x + 1)


def test_deadline_flush_with_single_occupied_slot():
    batcher = DispatchBatcher(2, flush_after=0.05, device="cpu")
    c0 = batcher.client()
    c1 = batcher.client()  # claimed, silent: a busy straggler
    server = _serve_in_thread(batcher)
    t0 = time.perf_counter()
    out = c0.dispatch(lambda x: x * 2, (np.arange(4.0),))
    waited = time.perf_counter() - t0
    np.testing.assert_array_equal(out, np.arange(4.0) * 2)
    assert waited < 5.0, "deadline flush did not fire"
    assert batcher.stats["deadline_flushes"] >= 1
    c0.close()
    c1.close()
    server.join(timeout=30)
    assert not server.is_alive()


def test_idle_slot_excluded_from_quiescence():
    batcher = DispatchBatcher(2, device="cpu")  # quiescence-only
    c0 = batcher.client()
    c1 = batcher.client()
    c1.set_idle(True)
    server = _serve_in_thread(batcher)
    out = c0.dispatch(lambda x: x + 3, (np.arange(3.0),))
    np.testing.assert_array_equal(out, np.arange(3.0) + 3)
    assert batcher.stats["deadline_flushes"] == 0
    c0.close()
    c1.close()
    server.join(timeout=30)
    assert not server.is_alive()


def _ff_args(seed=0, H=8, T=16):
    rng = np.random.default_rng(seed)
    return (rng.uniform(1, 8, (H, 4)), rng.uniform(0.2, 2.0, (T, 4)),
            np.ones(T, dtype=bool))


def test_single_live_slot_fast_path_parity():
    args = _ff_args()
    direct_p, direct_a = first_fit_impl(
        *(torch.from_numpy(a) for a in args), strict=False)

    batcher = DispatchBatcher(1, device="cpu")
    coord = threading.Thread(target=batcher.serve)
    coord.start()
    client = batcher.client()
    out_p, out_a = client.dispatch(first_fit_impl, args,
                                   static_kw={"strict": False})
    client.close()
    coord.join(timeout=10)
    assert not coord.is_alive()
    assert isinstance(out_p, np.ndarray)  # placements come back fetched
    np.testing.assert_array_equal(direct_p.numpy(), out_p)
    np.testing.assert_array_equal(direct_a.numpy(), np.asarray(out_a))
    assert batcher.stats["single_fast_path"] == 1
    assert batcher.stats["dispatches"] == 1
    assert batcher.stats["device_calls"] == 1
    assert batcher.stats["coalesced"] == 0

    # The last survivor of a G=2 batcher takes the fast path too.
    batcher2 = DispatchBatcher(2, device="cpu")
    coord2 = threading.Thread(target=batcher2.serve)
    coord2.start()
    c_a, c_b = batcher2.client(), batcher2.client()
    c_b.close()
    out_p2, _ = c_a.dispatch(first_fit_impl, args,
                             static_kw={"strict": False})
    c_a.close()
    coord2.join(timeout=10)
    assert not coord2.is_alive()
    np.testing.assert_array_equal(direct_p.numpy(), out_p2)
    assert batcher2.stats["single_fast_path"] == 1


def test_group_bucket_matches_reference():
    from pivot_tpu.sched.batch import group_bucket as ref_bucket

    for g in (1, 2, 3, 4, 5, 8, 9, 16, 17, 40, 200):
        assert group_bucket(g) == ref_bucket(g), g


def _ca_request(seed, T_used, T=32, H=12, live=False):
    """One Cost-Aware kernel request as a batched policy stages it: host
    f32 operands at a T bucket, the step bound a 0-d per-row operand."""
    args = [np.array(a) for a in make_inputs(seed, T, H)]
    args[1][:, 1] = np.random.default_rng(seed).uniform(0, 4, T)
    args[2][T_used:] = False
    kw = {"n_eff": np.int32(T_used)}
    if live:
        kw["live"] = np.random.default_rng(seed + 1).random(H) < 0.8
    return tuple(args), kw


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("g", [1, 2, 3, 5])
@pytest.mark.parametrize("live", [False, True])
def test_batch_execute_cost_aware_rows_matches_individual_calls(mode, g,
                                                                live):
    """A Cost-Aware flush of g rows (different task counts, padded 3 → 4,
    5 → 8) is one call of the per-row form — on CPU f32 its plain version
    — and returns exactly what each row's unbatched call returns."""
    reqs = [_ca_request(s, T_used, live=live)
            for s, T_used in zip(range(g), (32, 7, 19, 1, 25))]
    keys = {_request_key(ck.cost_aware_cuda, a, k, mode) for a, k in reqs}
    assert len(keys) == 1  # different task counts share one key
    calls = []
    orig = ck.cost_aware_cuda_rows

    def counting(*a, **k):
        calls.append(a[0].shape[0])
        return orig(*a, **k)

    ck.cost_aware_cuda_rows = counting
    try:
        outs = batch_execute(ck.cost_aware_cuda, reqs, mode, device="cpu")
    finally:
        ck.cost_aware_cuda_rows = orig
    assert calls == ([] if g == 1 else [group_bucket(g)])
    assert len(outs) == g
    for (args, kw), (p, a) in zip(reqs, outs):
        targs = [torch.from_numpy(x) for x in args]
        tkw = {k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()
               if k != "n_eff"}
        want_p, want_a = ck.cost_aware_cuda(*targs, **mode, **tkw,
                                            n_eff=int(kw["n_eff"]))
        assert isinstance(p, np.ndarray)
        np.testing.assert_array_equal(want_p.numpy(), p)
        assert torch.equal(want_a, a)


@pytest.mark.parametrize("arm", ["first-fit", "best-fit", "opportunistic"])
def test_batch_execute_torch_arm_matches_individual_and_reference(arm):
    """A torch arm's flush runs its rows in sequence through the
    unbatched call (3 rows: no padding), each row equal to its own call
    and to ``pivot_tpu``'s vmapped flush of the reference kernel."""
    from pivot_tpu.ops import kernels as jk
    from pivot_tpu.sched.batch import batch_execute as ref_execute

    rng = np.random.default_rng(4)
    reqs = []
    for s in range(3):
        avail, dem, valid = _ff_args(s, H=10, T=24)
        valid[18:] = False
        args = (avail, dem, valid)
        if arm == "opportunistic":
            args += (rng.uniform(0, 1, 24),)
        reqs.append((args, {}))
    impl, ref, static = {
        "first-fit": (first_fit_impl, jk.first_fit_kernel,
                      {"strict": False}),
        "best-fit": (best_fit_impl, jk.best_fit_kernel, {}),
        "opportunistic": (opportunistic_impl, jk.opportunistic_kernel, {}),
    }[arm]
    outs = batch_execute(impl, reqs, static, device="cpu")
    refs = ref_execute(ref, [(tuple(jnp.asarray(a) for a in r), k)
                             for r, k in reqs], static)
    for (args, _), (p, a), (rp, ra) in zip(reqs, outs, refs):
        want_p, want_a = impl(*(torch.from_numpy(x) for x in args), **static)
        np.testing.assert_array_equal(want_p.numpy(), p)
        assert torch.equal(want_a, a)
        np.testing.assert_array_equal(np.asarray(rp), p)
        np.testing.assert_array_equal(np.asarray(ra), a.numpy())


def test_flush_counts_one_call_for_rows_form_and_g_for_a_torch_arm():
    """``device_calls``: one per coalesced Cost-Aware group (one per-row
    launch), one per row of a torch arm's group."""
    batcher = DispatchBatcher(3, device="cpu")
    clients = [batcher.client() for _ in range(3)]
    reqs = [_ca_request(s, T) for s, T in zip(range(3), (32, 9, 4))]
    ff = [(_ff_args(s), {}) for s in range(3)]
    gate = threading.Barrier(3)
    got = {}

    def work(slot):
        try:
            gate.wait()
            got[slot, "ca"] = clients[slot].dispatch(
                ck.cost_aware_cuda, reqs[slot][0], reqs[slot][1], MODES[0])
            gate.wait()
            got[slot, "ff"] = clients[slot].dispatch(
                first_fit_impl, ff[slot][0], None, {"strict": False})
        finally:
            clients[slot].close()

    threads = [threading.Thread(target=work, args=(s,), daemon=True)
               for s in range(3)]
    for t in threads:
        t.start()
    batcher.serve()
    for t in threads:
        t.join(timeout=30)
    st = batcher.stats
    assert st["dispatches"] == 6 and st["coalesced"] == 6
    assert st["max_group"] == 3
    assert st["device_calls"] == 1 + 3
    assert st["retired_slots"] == 3 and st["single_fast_path"] == 0


def test_enable_batching_rejects_adaptive():
    from pivot_tpu_torch.sched.cuda import (
        CudaCostAwarePolicy,
        CudaFirstFitPolicy,
    )

    for cls in (CudaCostAwarePolicy, CudaFirstFitPolicy):
        pol = cls(adaptive=True, device="cpu")
        with pytest.raises(ValueError, match="adaptive"):
            pol.enable_batching(object())
        plain = cls(device="cpu")
        plain.enable_batching(object())  # deterministic routing: accepted


def test_stats_keys_equal_reference():
    from pivot_tpu.sched.batch import DispatchBatcher as RefBatcher
    from pivot_tpu_torch.infra.meter import SloMeter

    ours, ref = DispatchBatcher(2, device="cpu"), RefBatcher(2)
    assert set(ours.stats) == set(ref.stats) == set(SloMeter.DISPATCH_KEYS)
    assert ours.stats == ref.stats
    c = ours.respawn_client()
    assert c.slot == 0 and ours.live_slots == 3
    assert ours.stats["runs"] == 3 and ours.stats["respawns"] == 1


def test_closed_client_refuses_dispatch():
    batcher = DispatchBatcher(1, device="cpu")
    c = batcher.client()
    c.close()
    with pytest.raises(RuntimeError, match="closed"):
        c.dispatch(lambda x: x, (np.zeros(2),))
    with pytest.raises(ValueError, match="slots"):
        batcher.client()
        batcher.client()


def test_concurrent_slots_stress():
    """Sixteen slots dispatching 40 calls each, with a short switch
    interval: every call is served exactly once with its own row, and the
    stats lose no update (the counters are taken under the batcher's
    lock)."""
    import sys

    n_slots, n_calls = 16, 40
    batcher = DispatchBatcher(n_slots, flush_after=0.001, device="cpu")
    clients = [batcher.client() for _ in range(n_slots)]
    bad = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def plus_half(v):
        return v + 0.5

    def work(slot):
        try:
            for i in range(n_calls):
                x = np.full(3, slot * 1000 + i, dtype=np.float64)
                out = clients[slot].dispatch(plus_half, (x,))
                if not np.array_equal(out, x + 0.5):
                    bad.append((slot, i))
        finally:
            clients[slot].close()

    try:
        threads = [threading.Thread(target=work, args=(s,), daemon=True)
                   for s in range(n_slots)]
        for t in threads:
            t.start()
        batcher.serve()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert bad == []
    st = batcher.stats
    assert st["dispatches"] == n_slots * n_calls
    assert st["device_calls"] == st["dispatches"]  # no batched form
    assert st["coalesced"] > 0 and st["max_group"] > 1
    assert st["retired_slots"] == n_slots and batcher.live_slots == 0


def test_build_and_load_are_serialised(monkeypatch):
    """Session threads may reach the kernel's first use together: the
    build and the load run once, one thread at a time, and every thread
    gets the same library and entry points."""
    import types

    from pivot_tpu_torch.ops import build

    state = {"now": 0, "max": 0, "builds": 0}

    def slow_build(names):
        state["now"] += 1
        state["max"] = max(state["max"], state["now"])
        time.sleep(0.05)
        state["builds"] += 1
        state["now"] -= 1
        return {n: f"/nowhere/lib{n}.so" for n in names}

    def fake_lib(path):
        return types.SimpleNamespace(
            path=path, greedy_place_launch=lambda *a: 0,
            greedy_place_launch_rows=lambda *a: 0)

    monkeypatch.setattr(build, "_build_all", slow_build)
    monkeypatch.setattr(build.ctypes, "CDLL", fake_lib)
    build._load.cache_clear()
    ck._entries.cache_clear()
    got = []
    try:
        threads = [threading.Thread(
            target=lambda: got.append(ck.load_library()), daemon=True)
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert len(got) == 8 and state["builds"] == 1 and state["max"] == 1
        assert all(g == got[0] for g in got)
    finally:
        build._load.cache_clear()
        ck._entries.cache_clear()
