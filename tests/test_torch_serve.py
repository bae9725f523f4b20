"""The port's online serving layer (``pivot_tpu_torch.serve``) against
``pivot_tpu``'s.

The same seeded arrivals (each package's ``reset_ids()`` before its run)
go into the port's ``ServeDriver`` — its device policies with torch
tensors on the CPU in float64, or the Cost-Aware kernel path in float32
whose coalesced flushes run the per-row form's plain version — and into
``pivot_tpu``'s, with its device policy on the JAX CPU backend under
x64 (``_DevicePolicyBase.dtype`` set to float64) or its numpy policy.
Per-session per-tick placements and the summary keys of
``tests/test_serve.py:137-141`` must be equal, and the port's served
schedule must equal its own batch-mode ``ExperimentRun`` — the
reference's parity bar.  Then: the arrival generators against
``pivot_tpu``'s, the shed / spill / block paths, the closed-loop source,
a supervisor restart onto a fresh batcher slot, and ``cli serve`` on the
CPU.
"""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp

from pivot_tpu import serve as jserve
from pivot_tpu.sched import tpu as jtpu
from pivot_tpu.utils import config as jconfig
from pivot_tpu.utils import reset_ids as j_reset_ids
from pivot_tpu_torch import serve as pserve
from pivot_tpu_torch.ops import cuda_kernels as ck
from pivot_tpu_torch.utils import config as pconfig
from pivot_tpu_torch.utils import reset_ids as p_reset_ids

TRACE = "data/jobs/jobs-5000-200-172800-259200.npz"
SUMMARY_KEYS = (
    "egress_cost", "cum_instance_hours", "avg_congestion_delay",
    "total_scheduling_ops", "avg_scheduling_turnover", "avg_runtime",
    "n_apps",
)
COUNTERS = ("arrived", "admitted", "completed", "shed", "decisions",
            "placed")
ARMS = {
    "cost-aware": dict(name="cost-aware", bin_pack="first-fit",
                       sort_tasks=True, sort_hosts=True),
    "first-fit": dict(name="first-fit", decreasing=True),
    "best-fit": dict(name="best-fit"),
    "opportunistic": dict(name="opportunistic"),
}


@pytest.fixture
def ref_f64(monkeypatch):
    """``pivot_tpu``'s device policies in float64 (x64 is on in tests)."""
    monkeypatch.setattr(jtpu._DevicePolicyBase, "dtype", jnp.float64)


def port_policy(arm="cost-aware", kernel=False):
    """The port's device policy on the CPU: float64, or float32 on the
    Cost-Aware kernel path (its plain version on CPU tensors)."""
    pol = pconfig.make_policy(
        pconfig.PolicyConfig(device="cuda", adaptive=False, **ARMS[arm]),
        torch_device="cpu", dtype="float32" if kernel else "float64")
    if kernel:
        pol.use_kernel = True
    return pol


def ref_policy(device, arm="cost-aware"):
    return jconfig.make_policy(
        jconfig.PolicyConfig(device=device, adaptive=False, **ARMS[arm]))


def record(policy):
    log = []
    orig = policy.place

    def recorder(ctx):
        p = orig(ctx)
        log.append(np.asarray(p).copy())
        return p

    policy.place = recorder
    return log


def sessions(pkg, config, make_pol, n, n_hosts=8):
    return [
        pkg.ServeSession(
            f"s{g}",
            config.build_cluster(config.ClusterConfig(n_hosts=n_hosts,
                                                      seed=0)),
            make_pol(), seed=0)
        for g in range(n)
    ]


def arrivals(pkg, n_jobs=8, rate=0.05):
    return list(pkg.poisson_arrivals(
        rate=rate, n_jobs=n_jobs, seed=7,
        make_app=pkg.synthetic_app_factory(seed=11)))


def serve(pkg, config, reset, make_pol, G=2, n_jobs=8, rate=0.05, **kw):
    """One seeded served run: per-session placement logs, summaries and
    the report."""
    reset()
    arrs = arrivals(pkg, n_jobs, rate)
    ss = sessions(pkg, config, make_pol, G)
    logs = [record(s.policy) for s in ss]
    report = pkg.ServeDriver(ss, queue_depth=32, backpressure="shed",
                             **kw).run(iter(arrs))
    return logs, [s.summary() for s in ss], report


def assert_same_schedule(logs_a, sums_a, logs_b, sums_b):
    for g, (la, lb) in enumerate(zip(logs_a, logs_b)):
        assert len(la) == len(lb), g
        for tick, (a, b) in enumerate(zip(la, lb)):
            np.testing.assert_array_equal(a, b,
                                          err_msg=f"session {g} tick {tick}")
    for sa, sb in zip(sums_a, sums_b):
        assert {k: sa[k] for k in SUMMARY_KEYS} == {
            k: sb[k] for k in SUMMARY_KEYS}


@pytest.mark.parametrize("ref_device", ["tpu", "numpy"])
@pytest.mark.parametrize("arm", ["cost-aware", "first-fit"])
def test_served_schedule_equals_reference_serve(ref_f64, ref_device, arm):
    logs, sums, report = serve(pserve, pconfig, p_reset_ids,
                               lambda: port_policy(arm))
    rlogs, rsums, rreport = serve(jserve, jconfig, j_reset_ids,
                                  lambda: ref_policy(ref_device, arm))
    assert report["slo"]["counters"]["completed"] == 8
    assert report["batcher"]["coalesced"] > 0
    assert_same_schedule(logs, sums, rlogs, rsums)
    for k in COUNTERS:
        assert report["slo"]["counters"][k] == rreport["slo"]["counters"][k]
    if ref_device == "tpu":
        assert rreport["batcher"]["coalesced"] > 0


@pytest.mark.parametrize("arm,kernel", [
    ("cost-aware", False), ("cost-aware", True), ("first-fit", False),
    ("best-fit", False), ("opportunistic", False)])
def test_served_schedule_equals_batch_mode(arm, kernel, monkeypatch):
    """The parity bar of ``tests/test_serve.py:101-170`` on the port:
    every session's per-tick placements and summary equal a batch-mode
    ``ExperimentRun`` of its round-robin subset.  On the kernel path each
    coalesced flush is one call of the per-row form."""
    from pivot_tpu_torch.experiments.runner import ExperimentRun
    from pivot_tpu_torch.workload.trace import TraceSchedule

    rows_calls = []
    orig = ck.cost_aware_cuda_rows

    def counting(*a, **k):
        rows_calls.append(a[0].shape[0])
        return orig(*a, **k)

    monkeypatch.setattr(ck, "cost_aware_cuda_rows", counting)
    G, N = 2, 8
    logs, sums, report = serve(pserve, pconfig, p_reset_ids,
                               lambda: port_policy(arm, kernel), G, N)
    stats = report["batcher"]
    assert report["slo"]["counters"]["completed"] == N
    assert stats["coalesced"] > 0 and stats["max_group"] == 2
    if kernel:
        # One per-row call per coalesced group, none for groups of one.
        assert len(rows_calls) == stats["coalesced"] // 2 > 0
        assert stats["device_calls"] < stats["dispatches"]
    else:
        assert rows_calls == []
        assert stats["device_calls"] == stats["dispatches"]

    p_reset_ids()
    arrs = arrivals(pserve, N)
    for g in range(G):
        subset = arrs[g::G]  # the driver's round-robin assignment
        schedule = TraceSchedule(
            [(0.0, [])] + [(a.ts, [a.app]) for a in subset])
        policy = port_policy(arm, kernel)
        run = ExperimentRun(
            f"batch-{g}",
            pconfig.build_cluster(pconfig.ClusterConfig(n_hosts=8, seed=0)),
            policy, schedule=schedule, seed=0, interval=5.0,
            fuse_spans=False,
        )
        batch_log = record(policy)
        batch_sum = run.run()
        assert_same_schedule([logs[g]], [sums[g]], [batch_log], [batch_sum])


def app_shape(app):
    return [(g.id, g.cpus, g.mem, g.disk, g.gpus, g.runtime, g.output_size,
             g.instances, tuple(g.dependencies))
            for g in app._groups.values()]


def arrival_rows(arrs):
    return [(a.ts, a.tier, a.tenant, app_shape(a.app)) for a in arrs]


@pytest.mark.parametrize("source", ["poisson", "trace", "trace-retimed",
                                    "mixed-tier"])
def test_arrivals_equal_reference(source):
    def make(pkg, reset):
        reset()
        if source == "poisson":
            return list(pkg.poisson_arrivals(0.3, 12, seed=4, tier=1))
        if source == "trace":
            return list(pkg.trace_arrivals(TRACE, n_apps=6))
        if source == "trace-retimed":
            return list(pkg.trace_arrivals(TRACE, n_apps=6, rate=0.5,
                                           seed=3, scale_factor=1000))
        return list(pkg.mixed_tier_arrivals(
            2.5, 30, weights=(0.25, 0.35, 0.40), seed=1))

    got = arrival_rows(make(pserve, p_reset_ids))
    want = arrival_rows(make(jserve, j_reset_ids))
    assert got == want
    assert len(got) in (6, 12, 30)


def long_jobs(pkg, runtime, n_jobs):
    make_app = pkg.synthetic_app_factory(seed=5, runtime=runtime)
    return pkg.poisson_arrivals(rate=1.0, n_jobs=n_jobs, seed=2,
                                make_app=make_app)


def numpy_policy():
    return pconfig.make_policy(pconfig.PolicyConfig(
        name="cost-aware", device="numpy", sort_tasks=True,
        sort_hosts=True))


def test_queue_full_shed_path():
    p_reset_ids()
    driver = pserve.ServeDriver(
        sessions(pserve, pconfig, numpy_policy, 1), queue_depth=2,
        backpressure="shed")
    report = driver.run(long_jobs(pserve, (200.0, 300.0), 8))
    c = report["slo"]["counters"]
    assert c["arrived"] == 8 and c["shed"] > 0
    assert report["slo"]["shed_reasons"].get("queue_full") == c["shed"]
    assert c["completed"] == c["admitted"] == 8 - c["shed"]
    assert report["slo"]["queue_depth"]["max"] >= 2
    driver.audit()


def test_spill_backpressure_is_lossless():
    p_reset_ids()
    driver = pserve.ServeDriver(
        sessions(pserve, pconfig, port_policy, 1), queue_depth=2,
        backpressure="spill")
    report = driver.run(long_jobs(pserve, (200.0, 300.0), 8))
    c = report["slo"]["counters"]
    assert c["spilled"] > 0 and c["shed"] == 0 and c["completed"] == 8
    driver.audit()


def test_block_backpressure_is_lossless():
    p_reset_ids()
    driver = pserve.ServeDriver(
        sessions(pserve, pconfig, numpy_policy, 1), queue_depth=2,
        backpressure="block")
    report = driver.run(long_jobs(pserve, (100.0, 200.0), 6))
    c = report["slo"]["counters"]
    assert c["shed"] == 0 and c["spilled"] == 0
    assert c["admitted"] == c["completed"] == 6
    assert c["blocked_waits"] > 0
    driver.audit()


def test_spill_reoffers_preserve_arrival_order():
    p_reset_ids()
    driver = pserve.ServeDriver(
        sessions(pserve, pconfig, numpy_policy, 1), queue_depth=1,
        backpressure="spill")
    order = []
    driver.add_completion_hook(lambda _s, app, _now: order.append(app.id))
    arrs = list(long_jobs(pserve, (20.0, 40.0), 7))
    report = driver.run(iter(arrs))
    assert report["slo"]["counters"]["spilled"] > 0
    assert order == [a.app.id for a in arrs]


def test_closed_loop_load_generator():
    p_reset_ids()
    driver = pserve.ServeDriver(
        sessions(pserve, pconfig, port_policy, 2), queue_depth=8,
        backpressure="shed")
    src = pserve.closed_loop_source(
        driver, pserve.synthetic_app_factory(seed=9), concurrency=3,
        n_jobs=7)
    report = driver.run(src)
    c = report["slo"]["counters"]
    assert c["completed"] == 7 and c["shed"] == 0
    assert report["slo"]["queue_depth"]["max"] <= 3
    assert report["batcher"]["dispatches"] > 0


def test_supervisor_restart_on_fresh_batcher_slot():
    p_reset_ids()
    ss = sessions(pserve, pconfig, port_policy, 2)
    orig = ss[1].policy.place
    calls = {"n": 0}

    def crashing(ctx):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected session crash")
        return orig(ctx)

    ss[1].policy.place = crashing

    def factory(label):
        return sessions(pserve, pconfig, port_policy, 1)[0]

    driver = pserve.ServeDriver(
        ss, queue_depth=16, backpressure="shed", flush_after=0.2,
        session_factory=factory, max_restarts=2)
    report = driver.run(pserve.poisson_arrivals(rate=0.2, n_jobs=8, seed=5))
    c = report["slo"]["counters"]
    assert report["restarts"] == 1 and c["session_restarts"] == 1
    assert c["completed"] == 8 and c["shed"] == 0
    assert report["batcher"]["runs"] == 3  # 2 original slots + 1 respawned
    assert report["batcher"]["respawns"] == 1
    driver.audit()


def test_not_ported_options_raise(tmp_path):
    """The options of later slices raise naming their item; the resident
    pool and serve spans (item 4), the recovery plane (item 8), the MPC
    (item 5) and the dispatch profiler (item 12) are ported and construct
    (``tests/test_torch_serve_spans.py``, ``test_torch_recovery.py``,
    ``test_torch_mpc.py`` and ``test_torch_profiler.py`` run them)."""
    from pivot_tpu_torch.mpc import MpcConfig
    from pivot_tpu_torch.obs import DispatchProfiler

    ss = sessions(pserve, pconfig, numpy_policy, 1)
    import torch

    from pivot_tpu_torch.parallel.mesh import build_hybrid_mesh

    # The 2-D serving mesh is ported (tests/test_torch_serve_2d.py runs
    # it); elastic serving is ported (tests/test_torch_elastic_serve.py),
    # needs a session factory and is refused beside a mesh.
    mesh = build_hybrid_mesh(host_parallel=2,
                             devices=[torch.device("cpu")] * 4)
    assert pserve.ServeDriver(ss, mesh=mesh).report()["mesh"] == {
        "replica_dcn": 1, "replica": 2, "host": 2}
    with pytest.raises(ValueError, match="session_factory"):
        pserve.ServeDriver(ss, elastic=object())
    with pytest.raises(ValueError, match="does not compose"):
        pserve.ServeDriver(ss, mesh=mesh, elastic=object())
    prof = DispatchProfiler(4)
    profiled = pserve.ServeDriver(ss, profiler=prof)
    assert profiled.report()["profiler"] == prof.summary()
    with pytest.raises(TypeError, match="RecoveryConfig"):
        pserve.ServeDriver(ss, recovery=object())
    armed = pserve.ServeDriver(
        ss, mpc=MpcConfig(g_max=1),
        recovery=pserve.RecoveryConfig(directory=str(tmp_path)))
    assert armed.report()["recovery"]["journal"]["records"] == 1
    armed._recovery.stop()
    assert armed.mpc.g_max == 1 and armed.report()["mpc"] is None
    driver = pserve.ServeDriver(ss, resident=True, splice_tier=1)
    assert driver.report()["resident"] is True
    assert driver.report()["splice_tier"] == 1
    s = pserve.ServeSession(
        "x", pconfig.build_cluster(pconfig.ClusterConfig(n_hosts=4)),
        numpy_policy(), fuse_spans="slo")
    assert s.fuse_spans == "slo" and s.scheduler.fuse_spans
    with pytest.raises(ValueError, match="fuse_spans"):
        pserve.ServeSession(
            "y", pconfig.build_cluster(pconfig.ClusterConfig(n_hosts=4)),
            numpy_policy(), fuse_spans=True)


def serve_argv(out, device, extra=()):
    return ["--num-hosts", "12", "--seed", "3", "--device", device,
            "--output-dir", str(out), "serve", "--sessions", "2", "--jobs",
            "10", "--arrival-rate", "0.5", *extra]


@pytest.mark.parametrize("extra", [(), ("--policy", "first-fit",
                                        "--closed-loop", "3")])
def test_cli_serve_report_has_reference_keys(tmp_path, capsys, extra):
    from pivot_tpu.experiments import cli as jcli
    from pivot_tpu_torch.experiments import cli as pcli

    p_reset_ids()
    report = pcli.run_serve_stream(
        pcli.parse_args(serve_argv(tmp_path / "port", "cuda", extra)),
        torch_device="cpu", dtype="float64")
    j_reset_ids()
    ref = jcli.run_serve_stream(
        jcli.parse_args(serve_argv(tmp_path / "ref", "numpy", extra)))
    assert set(report) == set(ref)
    assert set(report["slo"]) == set(ref["slo"])
    assert report["slo"]["counters"]["completed"] == 10
    assert report["batcher"]["coalesced"] > 0
    stamp = os.listdir(tmp_path / "port" / "serve")
    with open(tmp_path / "port" / "serve" / stamp[0] / "report.json") as f:
        assert json.load(f)["slo"]["counters"]["completed"] == 10
    if not extra:  # open loop: the same schedule as the reference's
        for a, b in zip(report["per_session"], ref["per_session"]):
            assert {k: a[k] for k in SUMMARY_KEYS} == {
                k: b[k] for k in SUMMARY_KEYS}
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["decisions_per_sec"] > 0


@pytest.mark.parametrize("flags,item", [
    (["--shard-hosts", "2"], "needs a device-backed policy (--device cuda)"),
    (["--mpc", "--autoscale", "1:2"], "mutually exclusive"),
    (["--mpc-dry-run"], "require --mpc"),
    (["--profile-dispatch", "4"], "requires --device cuda")])
def test_cli_serve_not_ported_flags_exit_naming_item(flags, item, capsys):
    """Refused serve flags exit naming why; ``--profile-dispatch`` and
    ``--shard-hosts`` are ported and exit only off the device."""
    from pivot_tpu_torch.experiments import cli as pcli

    device = (["--device", "numpy"]
              if {"--profile-dispatch", "--shard-hosts"} & set(flags) else [])
    with pytest.raises(SystemExit):
        pcli.parse_args([*device, "serve", *flags])
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--fuse-spans", "slo"], ["--resident"],
    ["--fuse-spans", "slo", "--resident", "--splice-tier", "1"]])
def test_cli_serve_span_flags_run(tmp_path, flags):
    """The item-4 flags, once refused, now serve: the report carries them
    and every job completes."""
    from pivot_tpu_torch.experiments import cli as pcli

    p_reset_ids()
    report = pcli.run_serve_stream(
        pcli.parse_args(serve_argv(tmp_path, "cuda", flags)),
        torch_device="cpu", dtype="float64")
    assert report["slo"]["counters"]["completed"] == 10
    assert report["resident"] is ("--resident" in flags)
    assert report["splice_tier"] == (1 if "--splice-tier" in flags else 0)
    assert report["ragged"] is True
    assert (report["batcher"] is None) is ("--resident" in flags)


def test_cli_serve_defaults_to_the_card_without_adaptive():
    from pivot_tpu_torch.experiments import cli as pcli

    args = pcli.parse_args(["--adaptive", "serve"])
    assert args.device == "cuda" and args.adaptive is False


def test_publish_metrics_equal_reference_families(tmp_path):
    """The port's metrics registry gets the reference's families and
    sample names from a served run (numpy sessions on both sides), and
    ``--metrics-out`` writes the Prometheus text and its JSON twin."""
    from pivot_tpu.obs import MetricsRegistry as JRegistry
    from pivot_tpu_torch.obs import MetricsRegistry as PRegistry

    def run(pkg, config, reset, registry):
        reset()
        ss = sessions(pkg, config, lambda: config.make_policy(
            config.PolicyConfig(name="cost-aware", device="numpy",
                                sort_tasks=True, sort_hosts=True)), 2)
        driver = pkg.ServeDriver(ss, queue_depth=8, registry=registry)
        return driver.run(iter(arrivals(pkg, 6, 0.2)))

    port = run(pserve, pconfig, p_reset_ids, PRegistry())
    ref = run(jserve, jconfig, j_reset_ids, JRegistry())

    def shape(report):
        """Family → (kind, sorted label sets of its samples)."""
        return {name: (fam["kind"], sorted(
                    json.dumps(x["labels"], sort_keys=True)
                    for x in fam["samples"]))
                for name, fam in report["metrics"]["metrics"].items()}

    assert shape(port) == shape(ref)
    assert len(shape(port)) > 5

    from pivot_tpu_torch.experiments import cli as pcli

    out = tmp_path / "m.prom"
    pcli.run_serve_stream(pcli.parse_args(
        serve_argv(tmp_path, "numpy", ("--metrics-out", str(out)))))
    text = out.read_text()
    families = json.loads((tmp_path / "m.prom.json").read_text())["metrics"]
    assert families and all(f"# TYPE {name} " in text for name in families)
