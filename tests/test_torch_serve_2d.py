"""2-D mesh serving in the port: ``ServeDriver(mesh=)`` and ``serve
--shard-hosts``, against ``pivot_tpu``'s serving referees.

``pivot_tpu``'s own 2-D serve tests fail under this jax
(``shard_map(check_rep=)``), so the port's 2-D serving — host-sharded
device policies (``enable_sharding``) whose co-pending dispatches the
shared batcher coalesces on a ``replica × host`` mesh of CPU shards,
fused ``slo`` spans on — is held against what runs in ``pivot_tpu``
(``tests/test_serve_2d.py``):

  * the same seeded stream served per tick, unsharded and meshless by
    ``pivot_tpu`` (its ``_serve_arm(False, False, None)``, float64):
    equal final placements and run meters;
  * the realtime-bandwidth requests, a mesh without a replica axis, a
    sharded pool without a driver mesh (it runs free), no kernel build
    or graph capture on a replayed stream (``utils/compile_counter.py``);
  * ``serve --shard-hosts``: its argument checks, and ``S = 1`` over the
    one visible device served to its end through the CLI.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pivot_tpu_torch import serve as pserve
from pivot_tpu_torch.parallel import mesh as pm
from pivot_tpu_torch.sched import batch as pbatch
from pivot_tpu_torch.utils import config as pconfig
from pivot_tpu_torch.utils import reset_ids as p_reset_ids

from tests.test_torch_serve import SUMMARY_KEYS
from tests.test_torch_serve_spans import (  # noqa: F401  (fixtures)
    CA,
    _join_threads,
    ref_f64,
    serve_arm,
    span_activity,
)

CPU = torch.device("cpu")
#: The reference's referee keys (``tests/test_serve_2d.py:158-161``).
METERS = ("egress_cost", "cum_instance_hours", "n_apps", "avg_runtime",
          "total_scheduling_ops")
CAUSES = ("unshardable", "mixed_shapes", "indivisible")


def mesh2d(R=2, S=2):
    return pm.build_hybrid_mesh(host_parallel=S, devices=[CPU] * (R * S))


def sharded_policy(mesh, arm=CA):
    pol = pconfig.make_policy(
        pconfig.PolicyConfig(device="cuda", adaptive=False, **arm),
        torch_device="cpu", dtype="float64")
    if mesh is not None:
        pol.enable_sharding(mesh)
    return pol


def arm_2d(mesh, sharded=True, fuse="slo", n_jobs=10, rate=0.5, G=2,
           driver_mesh=True, **kw):
    """The port's 2-D arm of ``tests/test_serve_2d.py::_serve_arm``:
    sorted final placements, the report and the pool."""
    return serve_arm(
        pserve, pconfig, p_reset_ids,
        lambda: sharded_policy(mesh if sharded else None), fuse,
        n_jobs=n_jobs, rate=rate, G=G, flush_after=None,
        mesh=mesh if driver_mesh else None, **kw)


def _reference_per_tick():
    """``pivot_tpu``'s per-tick unsharded meshless referee arm."""
    from tests import test_serve_2d as jref

    pool, _driver, report = jref._serve_arm(False, False, None)
    return jref._final_placements(pool), [s.summary() for s in pool], report


def test_2d_slo_serve_bit_identical_to_per_tick_referee(ref_f64):
    """THE referee bar (``tests/test_serve_2d.py::
    test_2d_slo_serve_bit_identical_to_per_tick_referee``): the 2-D arm
    (sharded sessions on a (1, 2, 2) mesh, fused spans) gives
    ``pivot_tpu``'s per-tick unsharded placements and run meters, its
    flushes ride the mesh and the fallback causes add up."""
    m = mesh2d()
    got, report, pool = arm_2d(m)
    want, ref_sums, ref_report = _reference_per_tick()
    assert got == want and len(got) > 0
    for s, b in zip(pool, ref_sums):
        a = s.summary()
        assert {k: a[k] for k in METERS} == {k: b[k] for k in METERS}
    assert report["mesh"] == {"replica_dcn": 1, "replica": 2, "host": 2}
    assert ref_report["mesh"] is None
    assert report["slo"]["counters"]["completed"] == 10
    st = report["batcher"]
    assert st["mesh_dispatches"] > 0
    assert st["mesh_fallbacks"] == sum(st[f"mesh_fallback_{c}"]
                                       for c in CAUSES)
    assert span_activity(pool) > 0
    assert all(s.policy.dispatch_stats()["kernel_ticks"] == 0 for s in pool)


def test_2d_serve_three_sessions_pad_onto_the_mesh(monkeypatch):
    """Three sessions on replica 2: a 3-request group pads to 4 and runs
    the batched twin; the service equals the per-tick unsharded
    meshless run of the same stream."""
    from pivot_tpu_torch.ops import shard as sh

    sizes = []
    for form, twin in list(sh._BATCHED_TWINS.items()):
        def spy(*a, _twin=twin, **k):
            sizes.append(a[1].shape[0])
            return _twin(*a, **k)

        monkeypatch.setitem(sh._BATCHED_TWINS, form, spy)
    got, report, pool = arm_2d(mesh2d(), G=3, n_jobs=30, rate=25.0)
    want, _, _ = arm_2d(None, sharded=False, fuse=False, G=3, n_jobs=30,
                        rate=25.0)
    assert got == want and sizes and all(g in (2, 4) for g in sizes)
    assert report["batcher"]["mesh_dispatches"] > 0


def test_sharded_pool_without_driver_mesh_runs_free():
    """A sharded pool without a compatible driver mesh runs free: 1-D
    sharded per-session dispatches, no batcher, the same placements."""
    m = mesh2d()
    got, report, pool = arm_2d(m, driver_mesh=False)
    assert report["batcher"] is None and report["mesh"] is None
    want, _, _ = arm_2d(None, sharded=False, fuse=False, driver_mesh=False)
    assert got == want
    # A host axis that does not match the sessions' declines batching too.
    other = pm.build_hybrid_mesh(host_parallel=4, devices=[CPU] * 4)
    driver = pserve.ServeDriver(
        [pserve.ServeSession(
            "x", pconfig.build_cluster(pconfig.ClusterConfig(n_hosts=8)),
            sharded_policy(m))], mesh=other)
    with driver._cv:
        assert not driver._batching_compatible()


def test_driver_mesh_without_replica_axis_declines_batching():
    """``tests/test_serve_2d.py::
    test_driver_mesh_without_replica_axis_declines_batching``: a host-only
    mesh cannot carry the batcher's [G] axis — the driver declines
    batching and the policy refuses the batcher."""
    from pivot_tpu_torch.sched.cuda import CudaFirstFitPolicy

    host_only = pm.Mesh(np.array([CPU, CPU], dtype=object), ("host",))
    p_reset_ids()
    driver = pserve.ServeDriver(
        [pserve.ServeSession(
            "h0", pconfig.build_cluster(pconfig.ClusterConfig(n_hosts=8)),
            sharded_policy(mesh2d()))], mesh=host_only)
    with driver._cv:
        assert not driver._batching_compatible()
    pol = CudaFirstFitPolicy(device="cpu")
    pol.enable_sharding(mesh2d())
    with pytest.raises(ValueError, match="2-D replica x host mesh"):
        pol.enable_batching(
            pbatch.DispatchBatcher(1, mesh=host_only).client())


def test_driver_mesh_and_elastic():
    """``mesh=`` constructs and reports its axes; with ``elastic=`` it
    keeps the reference's refusal; ``elastic=`` alone needs a session
    factory (``tests/test_torch_elastic_serve.py`` serves it)."""
    ss = [pserve.ServeSession(
        "s", pconfig.build_cluster(pconfig.ClusterConfig(n_hosts=8)),
        sharded_policy(mesh2d()))]
    driver = pserve.ServeDriver(ss, mesh=mesh2d(4, 2))
    assert driver.report()["mesh"] == {"replica_dcn": 1, "replica": 4,
                                       "host": 2}
    with pytest.raises(ValueError, match="does not compose"):
        pserve.ServeDriver(ss, mesh=mesh2d(), elastic=object())
    with pytest.raises(ValueError, match="session_factory"):
        pserve.ServeDriver(ss, elastic=object())


def test_serve_2d_zero_builds_after_warmup():
    """``tests/test_serve_2d.py::test_serve_2d_zero_recompiles_after_warmup``
    in the port's terms: a replayed stream through the 2-D path records
    no kernel build and no graph capture."""
    from pivot_tpu_torch.utils.compile_counter import count_compiles

    def serve_once():
        _got, report, _pool = arm_2d(mesh2d(), G=1, n_jobs=6, rate=0.1)
        assert report["slo"]["counters"]["completed"] == 6

    serve_once()
    with count_compiles() as counter:
        serve_once()
    assert counter.kernel_builds == 0 and counter.graph_captures == 0


def _serve_argv(out, extra=(), device="cuda"):
    return ["--num-hosts", "12", "--seed", "3", "--device", device,
            "--output-dir", str(out), "serve", "--sessions", "2", "--jobs",
            "10", "--arrival-rate", "0.5", *extra]


def test_cli_serve_shard_hosts(tmp_path, capsys):
    """``serve --shard-hosts``: off the device it exits with the
    reference's text (``cuda`` for ``tpu``); ``S = 1`` over the one
    visible device serves the stream to its end, every session sharded,
    with the unsharded run's schedule; ``S = 2`` does not divide one
    device (``build_hybrid_mesh``'s error)."""
    from pivot_tpu_torch.experiments import cli as pcli

    with pytest.raises(SystemExit):
        pcli.parse_args(_serve_argv(tmp_path, ("--shard-hosts", "2"),
                                    device="numpy"))
    assert ("--shard-hosts needs a device-backed policy (--device cuda)"
            in capsys.readouterr().err)
    seen = []
    orig = pserve.ServeDriver.__init__

    def capture(self, sessions, **kw):
        seen.append([s.policy._mesh for s in sessions])
        orig(self, sessions, **kw)

    pserve.ServeDriver.__init__ = capture
    try:
        p_reset_ids()
        report = pcli.run_serve_stream(
            pcli.parse_args(_serve_argv(tmp_path / "s1",
                                        ("--shard-hosts", "1"))),
            torch_device="cpu", dtype="float64")
    finally:
        pserve.ServeDriver.__init__ = orig
    assert report["mesh"] == {"replica_dcn": 1, "replica": 1, "host": 1}
    assert report["slo"]["counters"]["completed"] == 10
    assert seen and all(m is not None for m in seen[0])
    p_reset_ids()
    plain = pcli.run_serve_stream(
        pcli.parse_args(_serve_argv(tmp_path / "plain")),
        torch_device="cpu", dtype="float64")
    for a, b in zip(report["per_session"], plain["per_session"]):
        assert {k: a[k] for k in SUMMARY_KEYS} == {k: b[k]
                                                  for k in SUMMARY_KEYS}
    with pytest.raises(ValueError, match="does not divide"):
        pcli.run_serve_stream(
            pcli.parse_args(_serve_argv(tmp_path / "s2",
                                        ("--shard-hosts", "2"))),
            torch_device="cpu", dtype="float64")
