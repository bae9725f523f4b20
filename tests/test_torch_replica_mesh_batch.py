"""The dispatch batcher's replica mesh against ``pivot_tpu``'s, on the
CPU in float64 under x64.

``pivot_tpu`` shards a coalesced flush's stacked ``[G]`` rows over the
``replica`` axis of its virtual 8-device CPU mesh; the port's mesh names
the CPU S times (``replica_mesh(devices=[cpu] * S)``):

  * ``batch_execute(mesh=)`` against ``pivot_tpu``'s ``batch_execute(...,
    mesh=replica_mesh(4))`` for each arm's torch kernel, the Cost-Aware
    kernel call (one call of the per-row form, its plain version on the
    CPU) and a fused span — flushes of 1 row and of an indivisible
    bucket (2 rows on 4 shards) falling back, bit-identical;
  * the batcher's mesh counters and their causes against the reference
    batcher's for the same flush, and its one-time log line;
  * ``run_grid_lockstep(mesh=)``: placements and summaries equal to the
    meshless grid and to ``pivot_tpu``'s ``run_grid_lockstep(mesh=)``,
    and ``--batch-runs`` files byte-equal to ``pivot_tpu``'s;
  * the refusals: a mesh over several distinct devices, a mesh on
    another device than the batcher's, and host sharding beside a
    replica-only batcher; a 2-D mesh is taken
    (``tests/test_torch_mesh_2d.py`` holds it).
"""

from __future__ import annotations

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pivot_tpu.ops import kernels as jk
from pivot_tpu.ops import tickloop as jt
from pivot_tpu.parallel.mesh import replica_mesh as j_replica_mesh
from pivot_tpu.sched import batch as jb
from pivot_tpu_torch.ops import cuda_kernels as ck
from pivot_tpu_torch.ops import kernels as tk
from pivot_tpu_torch.ops import tickloop as tt
from pivot_tpu_torch.parallel.mesh import build_mesh, replica_mesh
from pivot_tpu_torch.sched import batch as pb

from tests.test_pallas import make_inputs
from tests.test_torch_lockstep import (  # noqa: F401  (fixtures)
    ARGV,
    STATS_KEYS,
    assert_logs_equal,
    batch_runs_reference,
    grid_runs,
    outputs,
    port_policy,
    record,
    ref_f64,
    strip,
)
from tests.test_torch_ragged import _assert_span_equal, _span

CPU = torch.device("cpu")
MESH_KEYS = ("mesh_dispatches", "mesh_fallbacks",
             "mesh_fallback_unshardable", "mesh_fallback_mixed_shapes",
             "mesh_fallback_indivisible")


def cpu_mesh(S):
    return replica_mesh(devices=[CPU] * S)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f64(x):
    x = np.array(x)
    return x.astype(np.float64) if x.dtype.kind == "f" else x


def _arm_request(arm, seed, H=12, T=24):
    """One unbatched tick's operands for ``arm``, float64 host arrays."""
    x = [_f64(a) for a in make_inputs(seed, T, H)]
    x[2][18:] = False
    if arm == "cost-aware":
        return tuple(x)
    args = (x[0], x[1], x[2])
    if arm == "opportunistic":
        args += (np.random.default_rng(seed).uniform(0, 1, T),)
    return args


ARMS = {
    "first-fit": (tk.first_fit_impl, jk.first_fit_kernel, {"strict": False}),
    "best-fit": (tk.best_fit_impl, jk.best_fit_kernel, {}),
    "opportunistic": (tk.opportunistic_impl, jk.opportunistic_kernel, {}),
    "cost-aware": (tk.cost_aware_impl, jk.cost_aware_kernel,
                   {"bin_pack": "first-fit", "sort_hosts": True}),
}


@pytest.mark.parametrize("g", [1, 2, 3, 5])
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_batch_execute_mesh_matches_reference(arm, g):
    """3 and 5 rows pad to buckets of 4 and 8, which divide the 4 shards;
    1 row and 2 rows fall back.  Every row equals the meshless flush,
    its own unbatched call and the reference's mesh flush."""
    impl, ref, static = ARMS[arm]
    reqs = [(_arm_request(arm, s), {}) for s in range(g)]
    got = pb.batch_execute(impl, reqs, static, mesh=cpu_mesh(4))
    plain = pb.batch_execute(impl, reqs, static, device="cpu")
    want = jb.batch_execute(
        ref, [(tuple(jnp.asarray(a) for a in r), k) for r, k in reqs],
        static, mesh=j_replica_mesh(4))
    assert (pb._plan_mesh(cpu_mesh(4), impl, g, reqs[0][0])[1] is None) == (
        g < 3)
    for (args, _), (p, a), (pp, pa), (rp, ra) in zip(reqs, got, plain, want):
        own_p, own_a = impl(*(torch.from_numpy(x) for x in args), **static)
        for x in (p, pp):
            np.testing.assert_array_equal(own_p.numpy(), x)
            np.testing.assert_array_equal(np.asarray(rp), x)
        assert torch.equal(a, own_a) and torch.equal(pa, own_a)
        np.testing.assert_array_equal(np.asarray(ra), a.numpy())


def _ca_request(seed, T_used, T=32, H=12):
    args = [np.array(a) for a in make_inputs(seed, T, H)]
    args[2][T_used:] = False
    return tuple(args), {"n_eff": np.int32(T_used)}


@pytest.mark.parametrize("g", [2, 3, 5])
def test_cost_aware_kernel_mesh_flush_is_one_rows_call(g, monkeypatch):
    """A coalesced Cost-Aware flush on the mesh is still ONE call of the
    per-row form over the padded bucket (the blocks share it), with the
    meshless flush's rows."""
    reqs = [_ca_request(s, T) for s, T in zip(range(g), (32, 7, 19, 1, 25))]
    mode = dict(bin_pack="first-fit", sort_hosts=True, host_decay=False)
    calls = []
    orig = ck.cost_aware_cuda_rows

    def counting(*a, **k):
        calls.append(a[0].shape[0])
        return orig(*a, **k)

    monkeypatch.setattr(ck, "cost_aware_cuda_rows", counting)
    got = pb.batch_execute(ck.cost_aware_cuda, reqs, mode, mesh=cpu_mesh(4))
    plain = pb.batch_execute(ck.cost_aware_cuda, reqs, mode, device="cpu")
    assert calls == [pb.group_bucket(g)] * 2
    for (p, a), (pp, pa) in zip(got, plain):
        np.testing.assert_array_equal(p, pp)
        assert torch.equal(a, pa)


@pytest.mark.parametrize("config", ["first_fit_decreasing", "cost_aware_ff"])
def test_span_mesh_flush_matches_reference(config):
    """Three same-shape spans on a 4-shard mesh (their bucket of 4
    divides it), each equal to the meshless flush and to the reference's
    ``batch_execute(..., mesh=)`` of ``jax.vmap(fused_tick_run)``."""
    reqs = [_span(config, 4, 8, s) for s in range(3)]
    static = reqs[0][2]
    flush = [(a, k) for a, k, _ in reqs]
    got = pb.batch_execute(tt.fused_tick_run, flush, static,
                           mesh=cpu_mesh(4))
    plain = pb.batch_execute(tt.fused_tick_run, flush, static, device="cpu")
    want = jb.batch_execute(jt.fused_tick_run, flush, static,
                            mesh=j_replica_mesh(4))
    for out, p, w in zip(got, plain, want):
        _assert_span_equal(out, p, config)
        _assert_span_equal(out, w, config)


def _flush_stats(mod, kernels, mesh, device=None):
    """One flush of a hand-made co-pending batch through ``mod``'s
    batcher: 3 first-fit rows of one shape (bucket 4: on the mesh), 1 of
    another shape (the kernel fragmented: mixed shapes), 2 best-fit rows
    (bucket 2: indivisible), 1 opportunistic row (alone: no fallback)."""
    kw = {} if device is None else {"device": device}
    batcher = mod.DispatchBatcher(7, mesh=mesh, **kw)
    conv = (lambda a: a) if mod is pb else jnp.asarray
    spec = ([("first-fit", s, 24) for s in range(3)]
            + [("first-fit", 3, 16)]
            + [("best-fit", s, 24) for s in range(2)]
            + [("opportunistic", 0, 24)])
    reqs = []
    for slot, (arm, seed, T) in enumerate(spec):
        args = tuple(conv(a) for a in _arm_request(arm, seed, T=T))
        reqs.append(mod._Request(slot, kernels[arm], args, {},
                                 dict(ARMS[arm][2])))
    batcher._flush(reqs)
    for r in reqs:
        assert r.done.is_set() and r.error is None, r.error
    return batcher.stats, [r.result for r in reqs]


def test_flush_mesh_counters_match_reference():
    port = {a: v[0] for a, v in ARMS.items()}
    ref = {a: v[1] for a, v in ARMS.items()}
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger(pb.__name__)
    log.addHandler(handler)
    try:
        got, outs = _flush_stats(pb, port, cpu_mesh(4))
        _flush_stats(pb, port, cpu_mesh(4))  # another batcher logs again
    finally:
        log.removeHandler(handler)
    want, ref_outs = _flush_stats(jb, ref, j_replica_mesh(4))
    assert {k: got[k] for k in MESH_KEYS} == {k: want[k] for k in MESH_KEYS}
    assert got["mesh_dispatches"] == 1 and got["mesh_fallbacks"] == 2
    assert got["mesh_fallback_mixed_shapes"] == 1
    assert got["mesh_fallback_indivisible"] == 1
    assert got["mesh_fallback_unshardable"] == 0
    assert got["dispatches"] == want["dispatches"] == 7
    assert got["coalesced"] == want["coalesced"] == 5
    # One log line a batcher, naming the cause.
    assert len(records) == 2
    assert "cannot ride the mesh (mixed_shapes)" in records[0].getMessage()
    for (p, a), (rp, ra) in zip(outs, ref_outs):
        np.testing.assert_array_equal(p, np.asarray(rp))
        np.testing.assert_array_equal(a.numpy(), np.asarray(ra))
    meshless, _ = _flush_stats(pb, port, None, device="cpu")
    assert all(meshless[k] == 0 for k in MESH_KEYS)


def test_lockstep_grid_on_the_mesh(ref_f64):
    """``run_grid_lockstep(mesh=)`` over 2 logical shards: per-tick
    placements and summaries equal to the meshless grid and to
    ``pivot_tpu``'s ``run_grid_lockstep(mesh=replica_mesh(2))``, its
    coalesced flushes on the mesh."""
    from pivot_tpu.experiments.runner import run_grid_lockstep as jlock
    from pivot_tpu.utils import config as jconfig
    from pivot_tpu.utils import reset_ids as j_reset
    from pivot_tpu_torch.experiments.runner import run_grid_lockstep
    from pivot_tpu_torch.utils import reset_ids

    results = {}
    for name, mesh in (("plain", None), ("mesh", cpu_mesh(2))):
        reset_ids()
        runs = grid_runs("pivot_tpu_torch",
                         lambda: port_policy("cost-aware"), 2, n_hosts=8,
                         n_apps=2)
        logs = [record(r) for r in runs]
        stats: dict = {}
        sums = run_grid_lockstep(runs, stats_out=stats, mesh=mesh)
        results[name] = logs, sums, stats
    j_reset()
    runs = grid_runs("pivot_tpu", lambda: jconfig.make_policy(
        jconfig.PolicyConfig(device="tpu", adaptive=False, name="cost-aware",
                             bin_pack="first-fit", sort_tasks=True,
                             sort_hosts=True)), 2, n_hosts=8, n_apps=2)
    ref_logs = [record(r) for r in runs]
    ref_stats: dict = {}
    ref_sums = jlock(runs, stats_out=ref_stats, mesh=j_replica_mesh(2))
    logs, sums, stats = results["mesh"]
    assert_logs_equal(logs, results["plain"][0])
    assert_logs_equal(logs, ref_logs)
    for a, b, c in zip(sums, results["plain"][1], ref_sums):
        assert strip(a) == strip(b)
        keys = set(strip(c)) & set(strip(a))
        assert strip(a, keys) == strip(c, keys)
    assert set(stats) == set(ref_stats) == STATS_KEYS
    assert stats["mesh_dispatches"] > 0
    assert stats["mesh_dispatches"] + stats["mesh_fallbacks"] >= 1
    assert all(results["plain"][2][k] == 0 for k in MESH_KEYS)


@pytest.mark.parametrize("extra", ["--device cuda --batch-runs 2"])
def test_cli_batch_runs_on_the_mesh_files_equal_reference(
        tmp_path, batch_runs_reference, monkeypatch, extra):
    """``--batch-runs 2`` with each lock-step grid on a 2-shard mesh
    writes ``pivot_tpu``'s files byte for byte."""
    from pivot_tpu_torch.experiments import cli as pcli
    from pivot_tpu_torch.experiments import runner as prunner
    from pivot_tpu_torch.utils import reset_ids as p_reset

    seen = []
    orig = prunner.run_grid_lockstep

    def on_mesh(runs, stats_out=None):
        stats = {} if stats_out is None else stats_out
        out = orig(runs, stats_out=stats, mesh=cpu_mesh(2))
        seen.append(stats)
        return out

    monkeypatch.setattr(prunner, "run_grid_lockstep", on_mesh)
    p_reset()
    exp_dir, sums = pcli.run_overall(
        pcli.parse_args(ARGV.format(out=tmp_path, extra=extra).split()),
        torch_device="cpu", dtype="float64")
    assert seen and sum(s.get("mesh_dispatches", 0) for s in seen) > 0
    got = outputs(exp_dir)
    for key, want in batch_runs_reference.items():
        assert got[key] == want, key


def test_mesh_refusals():
    """A 2-D mesh, once refused, is taken: ``DispatchBatcher``,
    ``batch_execute`` and ``run_grid_lockstep`` run on it.  A mesh over
    several distinct devices still raises, under its ROADMAP label."""
    two_d = build_mesh(devices=[CPU] * 4, host_parallel=2)
    req = [(_arm_request("first-fit", 0), {})]
    assert pb.DispatchBatcher(2, mesh=two_d).client().mesh is two_d
    got = pb.batch_execute(tk.first_fit_impl, req * 2, {"strict": False},
                           mesh=two_d)
    want = pb.batch_execute(tk.first_fit_impl, req * 2, {"strict": False},
                            device="cpu")
    for (p, a), (pp, pa) in zip(got, want):
        np.testing.assert_array_equal(p, pp)
        assert torch.equal(a, pa)
    distinct = replica_mesh(devices=[CPU, torch.device("meta")])
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP\.md Queue 1, several cards"):
        pb.DispatchBatcher(2, mesh=distinct)
    with pytest.raises(ValueError, match="mesh names the device"):
        pb.DispatchBatcher(2, mesh=cpu_mesh(2), device="meta")
    batcher = pb.DispatchBatcher(2, mesh=cpu_mesh(2))
    assert batcher.device == CPU and batcher.client().mesh.shape == {
        "replica": 2, "host": 1}
    assert pb.DispatchBatcher(1, device="cpu").client().mesh is None

    from pivot_tpu_torch.experiments.runner import run_grid_lockstep

    runs = grid_runs("pivot_tpu_torch", lambda: port_policy("first-fit"), 2,
                     n_hosts=8, n_apps=2)
    stats: dict = {}
    sums = run_grid_lockstep(runs, stats_out=stats, mesh=two_d)
    assert len(sums) == 2 and stats["runs"] == 2


def test_host_sharding_beside_a_replica_mesh_batcher_still_refused():
    """Composing ``enable_sharding`` with a batcher needs a 2-D mesh
    whose host axis matches: a replica-only batcher mesh is refused in
    either order, with the reference's text."""
    from pivot_tpu_torch.parallel.mesh import host_sharded_mesh
    from pivot_tpu_torch.sched import cuda as pc

    hosts = host_sharded_mesh(devices=[CPU] * 2)
    client = pb.DispatchBatcher(2, mesh=cpu_mesh(2)).client()
    pol = pc.CudaFirstFitPolicy(device="cpu")
    pol.enable_batching(client)
    with pytest.raises(ValueError, match="2-D replica x host mesh") as exc:
        pol.enable_sharding(hosts)
    assert "host axis matches enable_sharding's (2 shards)" in str(
        exc.value)
    assert "build_hybrid_mesh" in str(exc.value) and pol._mesh is None
    pol2 = pc.CudaFirstFitPolicy(device="cpu")
    pol2.enable_sharding(hosts)
    with pytest.raises(ValueError, match="2-D replica x host mesh"):
        pol2.enable_batching(client)
    assert pol2._batch_client is None


def test_plan_mesh_is_the_reference_replica_rule():
    """The padded bucket and the routing of ``_plan_mesh`` equal
    ``pivot_tpu``'s on a replica-only mesh, for every group size up to
    40 on 2, 3, 4 and 8 shards (never the 2-D program there)."""
    args0 = (np.zeros((8, 4)),)
    for S in (2, 3, 4, 8):
        ref_mesh = j_replica_mesh(S)
        for g in range(1, 41):
            gb, fn_mesh, ok = pb._plan_mesh(cpu_mesh(S), tk.first_fit_impl,
                                            g, args0)
            rgb, rmesh, host_ok = jb._plan_mesh(ref_mesh, jk.first_fit_kernel,
                                                g, args0)
            assert (gb, fn_mesh is not None, ok) == \
                (rgb, rmesh is not None, host_ok), (S, g)
            assert not ok
    assert pb._plan_mesh(None, tk.first_fit_impl, 5, args0) == (8, None,
                                                                False)


def test_batcher_mesh_stats_through_threads():
    """Through the coordinator and client threads: a 3-run grid of
    co-pending first-fit ticks on a 2-shard mesh — every coalesced
    flush on the mesh, nothing falling back."""
    import threading

    batcher = pb.DispatchBatcher(3, mesh=cpu_mesh(2))
    clients = [batcher.client() for _ in range(3)]
    out = {}

    def work(slot):
        try:
            out[slot] = clients[slot].dispatch(
                tk.first_fit_impl, _arm_request("first-fit", slot), None,
                {"strict": False})
        finally:
            clients[slot].close()

    threads = [threading.Thread(target=work, args=(s,), daemon=True)
               for s in range(3)]
    for t in threads:
        t.start()
    batcher.serve()
    for t in threads:
        t.join(timeout=30)
    assert batcher.stats["mesh_dispatches"] == 1
    assert batcher.stats["mesh_fallbacks"] == 0
    for slot in range(3):
        want, _ = tk.first_fit_impl(
            *(torch.from_numpy(a) for a in _arm_request("first-fit", slot)),
            strict=False)
        np.testing.assert_array_equal(out[slot][0], want.numpy())

