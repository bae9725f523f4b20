"""Elastic serving in the port — ``ServeDriver(elastic=...)``,
``is_device_loss`` — and ``pivot_tpu_torch.tools.chaos_replay``, against
``pivot_tpu``.

``pivot_tpu``'s elastic soak (``tests/test_elastic.py::_elastic_soak``)
builds host-sharded session policies, which fail under this jax
(``shard_map(check_rep=)``); built with an UNSHARDED session policy it
runs, and it is the referee here.  On the CPU in float64, sessions of 8
hosts over meshes of 8 logical CPU shards:

  * **the kill arm** — a seeded plan kills shard 3 at t = 6 for 200 s:
    the reference's own assertions (``tests/test_elastic.py:461-491``)
    hold — every job completes, losses and restarts counted, the serve
    audit clean, shrink → probe → regrow, every loss names ``(3,)``;
  * **the healthy arm** — an armed manager with an empty plan serves the
    placements and counters of ``elastic=None`` and of the reference's
    unsharded soak, with no kernel build or graph capture once warm;
  * **a real loss** — a CUDA runtime error naming an unavailable device
    is classified (``is_device_loss``), counted and served around;
  * the driver's guards;
  * **chaos_replay** — ``generate`` / ``run`` / ``diff`` write the
    reference tool's JSON and print its diff, device windows included.
"""

from __future__ import annotations

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pivot_tpu.utils import config as jconfig
from pivot_tpu_torch import serve as ps
from pivot_tpu_torch.infra import faults as pf
from pivot_tpu_torch.infra.audit import audit_serve
from pivot_tpu_torch.infra.market import MarketSchedule
from pivot_tpu_torch.parallel import mesh as pm
from pivot_tpu_torch.serve.elastic import is_device_loss
from pivot_tpu_torch.utils import reset_ids as p_reset_ids
from pivot_tpu_torch.utils.compile_counter import count_compiles
from pivot_tpu_torch.utils.config import (
    ClusterConfig,
    PolicyConfig,
    build_cluster,
    make_policy,
)
from pivot_tpu_torch.workload import Application, TaskGroup

from tests import test_elastic as je
from tests.test_torch_serve_spans import _join_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CA = dict(name="cost-aware", bin_pack="first-fit", sort_tasks=True,
          sort_hosts=True, adaptive=False)
N_JOBS = 18


def port_policy(sharded=True):
    """``tests/test_elastic.py::_elastic_policy`` in the port, float64,
    over 8 logical CPU shards."""
    pol = make_policy(PolicyConfig(device="cuda", **CA), torch_device="cpu",
                      dtype="float64")
    if sharded:
        pol.enable_sharding(pm.host_sharded_mesh(devices=[CPU] * 8))
    return pol


def soak_arrivals(n_jobs):
    """``tests/test_elastic.py::_soak_arrivals`` from the port's modules."""
    p_reset_ids()
    arrs = list(ps.mixed_tier_arrivals(
        rate=20.0, n_jobs=n_jobs, weights=(0.5, 0.3, 0.2), seed=7,
        make_app=ps.synthetic_app_factory(seed=11)))
    straggler = Application("straggler", [
        TaskGroup("s", cpus=1, mem=32, runtime=2.0, instances=1)])
    arrs.append(ps.JobArrival(ts=10_000.0, app=straggler, tier=0))
    return arrs


def port_soak(elastic, n_jobs=N_JOBS, chaos=True, market=True,
              max_restarts=4, sharded=True, resident=True, wrap=None):
    """``tests/test_elastic.py::_elastic_soak`` from the port's modules;
    ``wrap(label, session)`` may instrument a session."""
    arrs = soak_arrivals(n_jobs)

    def factory(label):
        s = ps.ServeSession(
            label, build_cluster(ClusterConfig(n_hosts=8, seed=0)),
            port_policy(sharded), seed=0, fuse_spans="slo")
        if chaos:
            pf.FaultInjector(s.cluster, seed=0).preempt_host(
                s.cluster.hosts[2].id, at=8.0, lead=6.0, outage=25.0)
        if market:
            s.scheduler.market = MarketSchedule.generate(
                s.cluster.meta, seed=5, horizon=400.0, n_segments=4,
                hot_fraction=0.3, hot_hazard=1e-2, base_hazard=1e-4)
        if wrap is not None:
            wrap(label, s)
        return s

    driver = ps.ServeDriver(
        [factory("s0")], queue_depth=64, backpressure="shed",
        flush_after=0.02, resident=resident, splice_tier=2,
        session_factory=factory, max_restarts=max_restarts,
        elastic=elastic)
    report = driver.run(iter(arrs))
    return arrs, driver, report


def ref_soak(monkeypatch, chaos, market):
    """The reference's soak with an UNSHARDED float64 session policy."""
    def unsharded():
        pol = jconfig.make_policy(jconfig.PolicyConfig(device="tpu", **CA))
        pol.dtype = jnp.float64
        return pol

    monkeypatch.setattr(je, "_elastic_policy", unsharded)
    return je._elastic_soak(None, chaos=chaos, market=market)


def placements_of(arrs):
    return je._placements_of(arrs)


def test_elastic_soak_kill_shrink_regrow():
    """THE referee (``tests/test_elastic.py::test_elastic_serve_referee``,
    its assertions): a seeded ``device_fault`` kills shard 3 mid-soak; the
    driver shrinks through the supervisor's requeue and keeps serving,
    then the straggler's far-future dispatch, after the restore, regrows
    the full mesh through a passing shadow probe."""
    schedule = pf.ChaosSchedule(seed=13, events=[
        pf.ChaosEvent(kind="device_fault", at=6.0, target="device:3",
                      duration=200.0)])
    mgr = ps.ElasticMeshManager(ps.ElasticConfig(schedule=schedule))
    arrs, driver, report = port_soak(mgr)
    c = report["slo"]["counters"]
    assert c["arrived"] == N_JOBS + 1
    assert c["completed"] == N_JOBS + 1, "elastic soak lost jobs"
    assert c.get("failed_jobs", 0) == 0
    assert c.get("device_losses", 0) >= 1
    assert c.get("session_restarts", 0) >= 1
    assert audit_serve(driver) == []
    assert mgr.shrinks >= 1, "the fault window never hit a dispatch"
    assert mgr.regrows >= 1, "the straggler dispatch never regrew"
    assert mgr.probes >= 1 and mgr.probe_failures == 0
    kinds = [kind for _, kind, _ in mgr.events]
    assert kinds[0] == "loss" and kinds[-1] == "regrow"
    for _t, kind, ordinals in mgr.events:
        if kind == "loss":
            assert ordinals == (3,)
    # The pool ends on the full mesh.
    live = [s for s in driver.sessions if not s.abandoned]
    assert [mgr._mesh_key(s.policy._mesh) for s in live] == [tuple(range(8))]
    assert "shrinks: " in mgr.describe() and "device:3 down [6, 206)" in (
        mgr.describe())


@pytest.mark.parametrize("chaos_market", [False, True],
                         ids=["calm", "chaos_market"])
def test_empty_plan_equals_elastic_none_and_reference(monkeypatch,
                                                      chaos_market):
    """``tests/test_elastic.py::test_elastic_none_is_inert_and_empty_plan_
    matches`` held against the reference's unsharded soak: ``elastic=
    None`` builds nothing; an armed manager with an EMPTY plan serves the
    same placements and counters, and so does the reference; the gated
    run after a warm one builds no kernel and captures no graph."""
    arrs_ref, _drv, rep_ref = ref_soak(monkeypatch, chaos_market,
                                       chaos_market)
    want = placements_of(arrs_ref)
    arrs_none, drv_none, rep_none = port_soak(None, chaos=chaos_market,
                                              market=chaos_market)
    assert drv_none._elastic is None
    mgr = ps.ElasticMeshManager()
    with count_compiles() as counter:
        arrs_gated, drv_gated, rep_gated = port_soak(
            mgr, chaos=chaos_market, market=chaos_market)
    assert counter.kernel_builds == 0 and counter.graph_captures == 0
    assert (mgr.shrinks, mgr.regrows, mgr.probes, mgr.events) == (
        0, 0, 0, [])
    assert placements_of(arrs_gated) == placements_of(arrs_none) == want
    assert len(want) > 0
    c_ref = rep_ref["slo"]["counters"]
    assert rep_gated["slo"]["counters"] == rep_none["slo"]["counters"]
    assert rep_gated["slo"]["counters"] == c_ref
    assert c_ref["completed"] == N_JOBS + 1
    assert audit_serve(drv_gated) == []


def test_real_cuda_loss_is_classified_and_served():
    """A CUDA runtime error naming an unavailable device, raised by the
    first session's first span, is a device loss: counted in
    ``device_losses``, logged by ``note_loss``, and served around by the
    supervisor's restart; no gate window was hit."""
    armed = {"s0": True}

    def wrap(label, session):
        pol = session.policy
        real = pol.place_span

        def place_span(ctx, plan):
            if armed.pop(label, False):
                raise torch.AcceleratorError(
                    "CUDA error: CUDA-capable device(s) is/are busy or "
                    "unavailable")
            return real(ctx, plan)

        pol.place_span = place_span

    mgr = ps.ElasticMeshManager()
    _arrs, driver, report = port_soak(mgr, chaos=False, market=False,
                                      wrap=wrap)
    c = report["slo"]["counters"]
    assert not armed
    assert c["device_losses"] == 1 and c["session_restarts"] == 1
    assert c["completed"] == c["arrived"] == N_JOBS + 1
    assert mgr.shrinks == 0 and mgr.events == []
    assert audit_serve(driver) == []


def test_is_device_loss():
    """Injected losses, and torch's CUDA runtime errors whose text names
    a lost or unavailable device; a kernel's own fault is not a loss."""
    assert is_device_loss(pf.DeviceLostError([1], 2.0))
    cases = [
        ("CUDA error: CUDA-capable device(s) is/are busy or unavailable",
         True),
        ("CUDA error: no CUDA-capable device is detected", True),
        ("CUDA error: the device was lost", True),
        ("CUDA error: an illegal memory access was encountered", False),
        ("CUDA error: device-side assert triggered", False),
        ("CUDA error: unspecified launch failure", False),
    ]
    for text, want in cases:
        assert is_device_loss(RuntimeError(text)) is want, text
        assert is_device_loss(torch.AcceleratorError(text)) is want, text
    assert not is_device_loss(RuntimeError("device lost"))  # not CUDA's
    assert not is_device_loss(ValueError("CUDA error: device lost"))
    assert not is_device_loss(RuntimeError("injected kernel fault"))


def test_driver_elastic_guards():
    """``elastic=`` takes a manager, a config or a schedule; it needs a
    session factory (``test_driver_elastic_needs_factory``) and refuses
    ``mesh=``; an unsharded pool is refused when the manager attaches; an
    elastic pool never rides the batcher."""
    def session(sharded=True):
        return ps.ServeSession(
            "s0", build_cluster(ClusterConfig(n_hosts=8, seed=0)),
            port_policy(sharded), seed=0)

    with pytest.raises(ValueError, match="session_factory"):
        ps.ServeDriver([session()], elastic=ps.ElasticConfig())
    with pytest.raises(ValueError, match="session_factory"):
        ps.ServeDriver([session()], elastic=pf.ChaosSchedule(seed=1,
                                                             events=[]))
    with pytest.raises(ValueError, match="does not compose"):
        ps.ServeDriver([session()], session_factory=lambda label: None,
                       mesh=pm.build_hybrid_mesh(host_parallel=2,
                                                 devices=[CPU] * 4),
                       elastic=ps.ElasticConfig())
    mgr = ps.ElasticMeshManager()
    cfg = ps.ElasticConfig(probe_every=5)
    schedule = pf.ChaosSchedule(seed=1, events=[])
    f = lambda label: None  # noqa: E731
    assert ps.ServeDriver([session()], session_factory=f,
                          elastic=mgr)._elastic is mgr
    assert ps.ServeDriver([session()], session_factory=f,
                          elastic=cfg)._elastic.config is cfg
    assert ps.ServeDriver([session()], session_factory=f,
                          elastic=schedule)._elastic.config.schedule is (
        schedule)
    unsharded = ps.ServeDriver([session(False)], session_factory=f,
                               elastic=ps.ElasticConfig())
    with pytest.raises(ValueError, match="enable_sharding"):
        unsharded.run(iter([]))
    _arrs, _drv, report = port_soak(ps.ElasticConfig(), n_jobs=4,
                                    chaos=False, market=False,
                                    resident=False)
    assert report["batcher"] is None
    assert report["slo"]["counters"]["completed"] == 5


# -- chaos_replay ----------------------------------------------------------------


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "reference_chaos_replay", os.path.join(ROOT, "tools",
                                               "chaos_replay.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _device_schedules(base_path, faults):
    """The generated schedule plus device windows, and a second one whose
    explicit restore moved by 5 s (one window reshaped)."""
    with open(base_path) as fh:
        base = faults.ChaosSchedule.from_dict(json.load(fh))
    out = []
    for restore in (40.0, 45.0):
        out.append(faults.ChaosSchedule(seed=base.seed, events=list(
            base.events) + [
            faults.ChaosEvent(kind="device_fault", at=5.0,
                              target="device:3", duration=20.0),
            faults.ChaosEvent(kind="device_fault", at=10.0,
                              target="device:1"),
            faults.ChaosEvent(kind="device_restore", at=restore,
                              target="device:1"),
        ]))
    return out


def test_chaos_replay_matches_reference_tool(tmp_path, capsys):
    """The README's commands (``README.md:260-263``) through the port's
    tool and the reference's: identical schedule and report files,
    identical diffs and exit codes — for two run reports, and for two
    schedules carrying device-fault windows."""
    from pivot_tpu.infra import faults as jf
    from pivot_tpu.utils import reset_ids as j_reset_ids
    from pivot_tpu_torch.tools import chaos_replay as port

    ref = _reference_tool()
    p = lambda name: str(tmp_path / name)  # noqa: E731
    for tool, tag in ((port, "port"), (ref, "ref")):
        # ``generate`` names hosts by the process's id counters (a fresh
        # process in the README's commands): start both from zero.
        j_reset_ids()
        p_reset_ids()
        assert tool.main(["generate", "--seed", "7", "--hosts", "12",
                          "--out", p(f"{tag}.json")]) == 0
    assert open(p("port.json")).read() == open(p("ref.json")).read()
    for tool, tag in ((port, "port_a"), (port, "port_b"), (ref, "ref_a")):
        assert tool.main(["run", "--schedule", p("port.json"), "--hosts",
                          "12", "--seed", "7", "--out",
                          p(f"{tag}.json")]) == 0
    assert open(p("port_a.json")).read() == open(p("ref_a.json")).read()
    assert json.load(open(p("port_a.json")))["finished_apps"] == 6
    capsys.readouterr()
    outs = []
    for tool in (port, ref):
        rc = tool.main(["diff", p("port_a.json"), p("port_b.json")])
        outs.append((rc, capsys.readouterr().out))
    assert outs[0] == outs[1] == (0, "reports identical\n")

    for faults, tag in ((pf, "port"), (jf, "ref")):
        a, b = _device_schedules(p("port.json"), faults)
        a.save(p(f"{tag}_dev_a.json"))
        b.save(p(f"{tag}_dev_b.json"))
    for x in ("a", "b"):
        assert (open(p(f"port_dev_{x}.json")).read()
                == open(p(f"ref_dev_{x}.json")).read())
    outs = []
    for tool in (port, ref):
        rc = tool.main(["diff", p("port_dev_a.json"), p("port_dev_b.json")])
        outs.append((rc, capsys.readouterr().out))
    assert outs[0] == outs[1]
    rc, text = outs[0]
    assert rc == 1
    assert "- window device:1 down [10, 40)" in text
    assert "+ window device:1 down [10, 45)" in text
    for tool, tag in ((port, "port_dev_run"), (ref, "ref_dev_run")):
        assert tool.main(["run", "--schedule", p("port_dev_a.json"),
                          "--hosts", "12", "--seed", "7", "--out",
                          p(f"{tag}.json")]) == 0
    assert (open(p("port_dev_run.json")).read()
            == open(p("ref_dev_run.json")).read())
    rc = port.main(["diff", p("port_dev_a.json"), p("port_dev_a.json")])
    assert rc == 0 and "schedules identical" in capsys.readouterr().out
