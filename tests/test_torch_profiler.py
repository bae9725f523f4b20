"""The port's sampled dispatch profiler, its roofline model and
``--profile-dir`` against ``pivot_tpu``'s.

  * the profiler cases of ``tests/test_profiler.py`` with a torch
    meaning: the cadence and its replay, passthrough when disabled, the
    ``sample_every`` check, and the profiled serve soak — decisions,
    meters and SLO counters bit-identical to the unprofiled soak, the
    ``device`` spans nested in their flush spans (``pivot_tpu``'s
    ``tools/obs_report.py --check`` on the port's trace);
  * ``sampled_indices`` equal to ``pivot_tpu``'s for 3 seeds x 4
    families, and the summary's keys equal to ``pivot_tpu``'s;
  * the policy boundary: a run with the profiler attached to its device
    policy (direct dispatches) decides as one without it, its census
    under the reference's family names;
  * ``serve --profile-dispatch`` refused off the device, with the CLI's
    message, and built on it;
  * ``placement_cost`` / ``serial_model`` / ``fused_loop_model`` /
    ``annotate`` equal to ``pivot_tpu``'s ``infra/roofline.py`` over a
    grid of (kind, T, H, R), and ``backend_peaks("cuda")`` the H100's;
  * ``--profile-dir``: a ``torch.profiler`` Chrome trace per run under
    the reference's per-run directory naming, ignored under
    ``--batch-runs``.

All on the CPU: a sampled dispatch whose outputs are CPU tensors or host
arrays needs no wait (the CUDA-event wait is exercised on the card by
``chip_smoke.py`` phase 13).
"""

import importlib.util
import itertools
import json
import os

import numpy as np
import pytest

from pivot_tpu.obs import DispatchProfiler as JProfiler
from pivot_tpu_torch.infra import roofline
from pivot_tpu_torch.obs import (
    DispatchProfiler,
    MetricsRegistry,
    Tracer,
)
from pivot_tpu_torch.obs import profiler as pprof
from pivot_tpu_torch.serve import ServeDriver, ServeSession, poisson_arrivals
from pivot_tpu_torch.utils import reset_ids
from pivot_tpu_torch.utils.config import (
    ClusterConfig,
    PolicyConfig,
    build_cluster,
    make_policy,
)

FAMILIES = ("cost_aware_pallas", "first_fit", "fused_tick_run",
            "cost_aware_pallas_batched")


def _load_tool(name: str):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- cadence: deterministic, seed-replayable, zero-cost off -----------------


def test_sampling_cadence_is_deterministic_and_seed_replayable():
    a = DispatchProfiler(sample_every=8, seed=13)
    b = DispatchProfiler(sample_every=8, seed=13)
    assert a.sampled_indices("cost_aware", 100) == b.sampled_indices(
        "cost_aware", 100
    )
    sampled = []
    for i in range(64):
        before = a._stats.get("cost_aware")
        before_n = before.sampled if before else 0
        a.profile("cost_aware", lambda: 1)
        if a._stats["cost_aware"].sampled > before_n:
            sampled.append(i)
    assert sampled == a.sampled_indices("cost_aware", 64)
    assert len(sampled) == 8  # 64 calls at 1-in-8
    c = DispatchProfiler(sample_every=8, seed=14)
    assert any(
        c.sampled_indices(fam, 64) != a.sampled_indices(fam, 64)
        for fam in ("cost_aware", "first_fit", "fused_tick_run")
    )
    counts = a.summary()["families"]["cost_aware"]
    assert counts["calls"] == 64 and counts["sampled"] == 8


def test_disabled_profiler_is_passthrough():
    prof = DispatchProfiler(sample_every=1, enabled=False)
    calls = []
    out = prof.profile("x", lambda: calls.append(1) or "result")
    assert out == "result" and calls == [1]
    assert prof.summary()["families"] == {}
    reg = MetricsRegistry()
    prof.publish_metrics(reg)
    assert "pivot_dispatch_calls_total" in reg.families()


def test_sample_every_validation():
    with pytest.raises(ValueError):
        DispatchProfiler(sample_every=0)


@pytest.mark.parametrize("seed", [0, 5, 13])
def test_sampled_indices_equal_reference(seed):
    for every, fam in itertools.product((1, 4, 16), FAMILIES):
        assert DispatchProfiler(every, seed).sampled_indices(fam, 200) == \
            JProfiler(every, seed).sampled_indices(fam, 200), (every, fam)


def test_summary_keys_equal_reference():
    """The same calls through both profilers: the summary's top-level
    keys and every family row's keys are the reference's (the numbers
    are wall times and differ)."""
    port, ref = DispatchProfiler(2, 3), JProfiler(2, 3)
    shape = {"h": 600, "b": 32}
    for prof in (port, ref):
        for i in range(9):
            prof.profile("cost_aware_pallas", lambda: np.zeros(4),
                         shape=shape, h2d_bytes=64 * (i + 1))
            prof.profile("first_fit", lambda: np.zeros(4), shape=shape)
    got, want = port.summary(), ref.summary()
    assert got.keys() == want.keys()
    assert got["families"].keys() == want["families"].keys()
    for fam, row in want["families"].items():
        assert got["families"][fam].keys() == row.keys(), fam
        for k in ("calls", "sampled", "h2d_bytes_total",
                  "h2d_bytes_per_call"):
            assert got["families"][fam].get(k) == row.get(k), (fam, k)
    assert got["backend"] == "cpu"


def test_port_family_names():
    """The port's callables carry the reference's family names."""
    from pivot_tpu_torch.ops import cuda_kernels, kernels, tickloop
    from pivot_tpu_torch.sched import cuda as pcuda

    pol = pcuda.CudaCostAwarePolicy(device="cpu")
    for fn, family in (
            (cuda_kernels.cost_aware_cuda, "cost_aware_pallas"),
            (pol._greedy, "cost_aware_pallas"),
            (cuda_kernels.cost_aware_cuda_batched,
             "cost_aware_pallas_batched"),
            (cuda_kernels.cost_aware_cuda_rows, "cost_aware_pallas_batched"),
            (kernels.first_fit_impl, "first_fit"),
            (kernels.opportunistic_impl, "opportunistic"),
            (kernels.best_fit_impl, "best_fit"),
            (kernels.cost_aware_impl, "cost_aware"),
            (tickloop.fused_tick_run, "fused_tick_run"),
            (tickloop.resident_span_run, "resident_span_run")):
        assert pprof.family_of(fn) == family, fn
    assert pprof._model_kind("cost_aware_pallas") == "pallas_rb"
    assert pprof._model_kind("first_fit") == "slim"
    assert pprof._model_kind("fused_tick_run") == "scan"


# -- the acceptance soak: profiler on is bit-identical, spans nest ----------


def _device_policy(kernel=False):
    pol = make_policy(
        PolicyConfig(name="cost-aware", device="cuda", bin_pack="first-fit",
                     sort_tasks=True, sort_hosts=True, adaptive=False),
        torch_device="cpu", dtype="float32" if kernel else "float64")
    if kernel:
        pol.use_kernel = True  # the plain version serves CPU tensors
    return pol


def _profiled_soak(profiler, tracer=None, kernel=False):
    reset_ids()
    sessions = [
        ServeSession(f"s{g}", build_cluster(ClusterConfig(n_hosts=8, seed=0)),
                     _device_policy(kernel), seed=0)
        for g in range(2)
    ]
    driver = ServeDriver(sessions, queue_depth=32, backpressure="shed",
                         tracer=tracer, profiler=profiler)
    report = driver.run(poisson_arrivals(0.5, 10, seed=3))
    placements = [
        (s.label, [(a.id, round(a.start_time, 9), round(a.end_time, 9))
                   for a in s.completed])
        for s in driver.sessions
    ]
    meters = []
    for s in driver.sessions:
        summary = s.meter.summary()
        summary.pop("wall_clock")
        meters.append((s.label, summary))
    return report, placements, meters


@pytest.mark.parametrize("kernel", [False, True])
def test_profiled_soak_bit_identical_and_device_spans_nest(tmp_path, kernel):
    """Profiler-on serve soak bit-identical to profiler-off (placements,
    meters, SLO counters); the device spans carry shape args, nest in
    their flush spans, and the report carries the census."""
    obs_report = _load_tool("obs_report")
    report_off, placements_off, meters_off = _profiled_soak(
        None, kernel=kernel)
    tracer = Tracer()
    prof = DispatchProfiler(sample_every=2, seed=0)
    report_on, placements_on, meters_on = _profiled_soak(
        prof, tracer=tracer, kernel=kernel)

    assert placements_on == placements_off
    assert meters_on == meters_off
    assert report_on["slo"]["counters"] == report_off["slo"]["counters"]
    assert "profiler" not in report_off

    fams = prof.summary()["families"]
    assert sum(f["sampled"] for f in fams.values()) > 0
    assert report_on["profiler"]["families"] == fams
    assert ("cost_aware_pallas" if kernel else "cost_aware") in fams

    dev = [e for e in tracer.events if e["cat"] == "device"]
    assert dev, "sampled dispatches must land on the device lane"
    for e in dev:
        args = e["args"]
        assert "backend" in args and "h" in args
        assert args.get("in_flush") or "b" in args
    path = str(tmp_path / "profiled.perfetto.json")
    tracer.save_perfetto(path)
    events = obs_report.load_events(path)
    assert obs_report.check_events(events) == []
    dd = obs_report.build_report(events)["device_dispatch"]
    assert dd["sampled_spans"] == len(dev)
    reg = MetricsRegistry()
    prof.publish_metrics(reg)
    text = reg.to_prometheus()
    assert "pivot_dispatch_latency_seconds" in text
    assert "pivot_dispatch_calls_total" in text


def test_policy_boundary_profiles_direct_dispatches():
    """A batch ``ExperimentRun`` whose device policies carry a profiler
    (every call sampled) decides as the unprofiled run: the per-tick
    kernels land under their families, fused spans under
    ``fused_tick_run``, the Cost-Aware kernel path under
    ``cost_aware_pallas``."""
    from pivot_tpu_torch.experiments.runner import ExperimentRun

    trace = "data/jobs/jobs-5000-200-172800-259200.npz"

    def run(arm, prof, kernel=False):
        reset_ids()
        cfg = dict(
            opportunistic=dict(name="opportunistic"),
            vbp=dict(name="first-fit", decreasing=True),
            ca=dict(name="cost-aware", bin_pack="first-fit",
                    sort_tasks=True, sort_hosts=True))[arm]
        pol = make_policy(PolicyConfig(device="cuda", adaptive=False, **cfg),
                          torch_device="cpu",
                          dtype="float32" if kernel else "float64")
        if kernel:
            pol.use_kernel = True
        if prof is not None:
            pol.enable_profiler(prof)
        s = ExperimentRun(arm, build_cluster(ClusterConfig(n_hosts=20,
                                                           seed=3)),
                          pol, trace, n_apps=8, seed=3).run()
        s.pop("wall_clock")
        return s

    for arm, kernel, fams in (
            ("opportunistic", False, {"opportunistic", "fused_tick_run"}),
            ("vbp", False, {"first_fit", "fused_tick_run"}),
            ("ca", True, {"cost_aware_pallas"})):
        prof = DispatchProfiler(sample_every=1)
        assert run(arm, prof, kernel) == run(arm, None, kernel)
        census = prof.summary()["families"]
        assert set(census) == fams, (arm, census)
        assert all(r["calls"] == r["sampled"] > 0 for r in census.values())


# -- the CLI ------------------------------------------------------------------


@pytest.mark.parametrize("device", ["numpy", "naive"])
def test_profile_dispatch_refused_off_the_device(device, capsys):
    from pivot_tpu_torch.experiments import cli

    with pytest.raises(SystemExit) as exc:
        cli.parse_args(["--device", device, "serve", "--profile-dispatch",
                        "4"])
    assert exc.value.code == 2
    assert ("--profile-dispatch requires --device cuda (the numpy/naive "
            "policies dispatch no kernels for the profiler to bracket)"
            in capsys.readouterr().err)


def test_serve_profile_dispatch_builds_the_census(tmp_path):
    """``serve --profile-dispatch 2`` on the cuda policies (torch on the
    CPU): the report carries the census, the decisions equal the
    unprofiled run's."""
    from pivot_tpu_torch.experiments import cli

    def report(extra):
        reset_ids()
        args = cli.parse_args(
            f"--num-hosts 8 --seed 0 --output-dir {tmp_path} serve "
            f"--sessions 2 --jobs 12 --arrival-rate 0.5 {extra}".split())
        return cli.run_serve_stream(args, torch_device="cpu",
                                    dtype="float64")

    on, off = report("--profile-dispatch 2"), report("")
    assert on["profiler"]["sample_every"] == 2
    assert on["profiler"]["families"]
    assert "profiler" not in off
    assert on["slo"]["counters"] == off["slo"]["counters"]
    strip = [{k: v for k, v in s.items() if k != "wall_clock"}
             for s in off["per_session"]]
    assert [{k: v for k, v in s.items() if k != "wall_clock"}
            for s in on["per_session"]] == strip


# -- the roofline model ------------------------------------------------------


@pytest.mark.parametrize("kind", ["scan", "slim", "chunked", "pallas_rb"])
def test_placement_cost_equal_reference(kind):
    from pivot_tpu.infra import roofline as jroof

    for T, H, R, db, ng in itertools.product(
            (1, 16, 619, 2048), (1, 33, 600, 9664), (1, 4, 256),
            (4, 8), (None, 3)):
        assert roofline.placement_cost(kind, T, H, R, db, ng) == \
            jroof.placement_cost(kind, T, H, R, db, ng), (T, H, R, db, ng)
        peaks = {"bw_gbps": 100.0, "flops_peak_gflops": 1000.0}
        assert roofline.annotate(1e-3, kind, T, H, R, dtype_bytes=db,
                                 n_groups=ng, peaks=peaks) == \
            jroof.annotate(1e-3, kind, T, H, R, dtype_bytes=db,
                           n_groups=ng, peaks=peaks)
    with pytest.raises(ValueError):
        roofline.placement_cost("bogus", 1, 1)


def test_serial_and_fused_loop_models_equal_reference():
    from pivot_tpu.infra import roofline as jroof

    for n, step in itertools.product((1, 37, 2048), (3.4e-7, 1e-3, 0.5)):
        assert roofline.serial_model(n, step) == jroof.serial_model(n, step)
        assert roofline.fused_loop_model(n, step, 2e-5) == \
            jroof.fused_loop_model(n, step, 2e-5)


def test_backend_peaks_cuda_are_the_h100s():
    peaks = roofline.backend_peaks("cuda")
    assert roofline.PEAK_F32_OPS == 67e12 and roofline.PEAK_BYTES == 3.35e12
    assert peaks["flops_peak_gflops"] == 67_000.0
    assert peaks["bw_gbps"] == 3_350.0
    cpu = roofline.backend_peaks("cpu")
    assert cpu["bw_gbps"] > 0 and cpu["flops_peak_gflops"] > 0
    # The prediction reads the same table.
    pred = pprof.predicted_seconds("cost_aware_pallas", {"h": 600, "b": 32},
                                   "cuda", 1e-5)
    cost = roofline.placement_cost("pallas_rb", 32, 600, dtype_bytes=4)
    assert pred == 1e-5 + max(cost["flops"] / 67e12, cost["bytes"] / 3.35e12)
    assert pprof.predicted_seconds("unknown", {"h": 1, "b": 1}, "cuda",
                                   0.0) is None


def test_chip_smoke_reads_the_peaks_from_the_roofline_module():
    """One source for the H100's peaks: ``chip_smoke.py`` keeps no copy."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "chip_smoke.py")) as f:
        src = f.read()
    assert "from pivot_tpu_torch.infra.roofline import" in src
    assert "67e12" not in src and "3.35e12" not in src


# -- --profile-dir -------------------------------------------------------------


def test_profile_dir_writes_one_chrome_trace_per_run(tmp_path):
    """``overall --profile-dir`` (numpy policies here) writes a
    ``torch.profiler`` Chrome trace per run, under
    ``<profile-dir>/<trace index>/<arm>/trace.json``, and the files of
    the run equal an unprofiled run's."""
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.obs.tracer import PROFILE_TRACE_FILE

    def run(sub, extra):
        reset_ids()
        args = cli.parse_args(
            f"--num-hosts 8 --seed 3 --trace-limit 1 --device numpy "
            f"--output-dir {tmp_path / sub} {extra} overall "
            "--num-apps 3".split())
        return cli.run_overall(args)[0]

    prof_dir = tmp_path / "prof"
    on = run("on", f"--profile-dir {prof_dir}")
    off = run("off", "")
    for arm in ("Opportunistic", "VBP", "Cost-Aware"):
        path = prof_dir / "0" / arm / PROFILE_TRACE_FILE
        with open(path) as f:
            doc = json.load(f)
        assert isinstance(doc.get("traceEvents"), list)
        with open(os.path.join(on, "data", "0", arm, "general.json")) as a, \
                open(os.path.join(off, "data", "0", arm,
                                  "general.json")) as b:
            assert a.read() == b.read()


def _chrome_trace(path, launched, recorded, window=(0.0, 100.0),
                  warmup_end=None):
    """A Chrome trace as ``torch.profiler`` writes it: one launch call
    per correlation id in ``launched`` (at ts = id), one kernel record
    per id in ``recorded`` (2 us later), and ``device_profile``'s
    warm-up range from ts 0 to ``warmup_end``."""
    from pivot_tpu_torch.obs.tracer import WARMUP_RANGE

    ev = [{"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
           "ts": window[0], "dur": window[1] - window[0]}]
    if warmup_end is not None:
        ev.append({"ph": "X", "cat": "user_annotation", "name": WARMUP_RANGE,
                   "ts": 0.0, "dur": warmup_end, "args": {}})
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": float(c), "dur": 1.0, "args": {"correlation": c}}
           for c in launched]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
            "ts": 90.0, "dur": 1.0, "args": {"correlation": 999}},
           {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1.0,
            "dur": 1.0, "args": {}}]
    ev += [{"ph": "X", "cat": "kernel", "name": "void k()",
            "ts": c + 2.0, "dur": 1.0, "args": {"correlation": c}}
           for c in recorded]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


@pytest.mark.parametrize("recorded,warmup_end,launches,missing,missing_at", [
    (range(10, 20), None, 10, 0, []),
    (range(10, 17), None, 10, 3, [7, 8, 9]),
    (range(12, 20), None, 10, 2, [0, 1]),
    (range(12, 20), 11.5, 8, 0, []),
])
def test_trace_census_counts_launches_without_kernel_records(
        tmp_path, recorded, warmup_end, launches, missing, missing_at):
    """``trace_census`` pairs each one-kernel launch call with its kernel
    record by correlation id; the ones with none are counted and placed
    in launch order (a memcpy call is not a launch), and the launches
    of the warm-up range are left out."""
    from pivot_tpu_torch.obs.tracer import trace_census

    path = tmp_path / "trace.json"
    _chrome_trace(path, range(10, 20), recorded, warmup_end=warmup_end)
    got = trace_census(str(path))
    first = 10.0 if warmup_end is None else 12.0
    assert got == dict(launches=launches, kernels=len(recorded),
                       missing=missing, missing_at=missing_at,
                       window_us=(0.0, 100.0), first_launch_us=first,
                       first_kernel_us=recorded[0] + 2.0,
                       min_launch_to_kernel_us=2.0)


def test_profile_dir_ignored_under_batch_runs(tmp_path):
    import logging

    from pivot_tpu_torch.experiments import cli

    class Keep(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    keep = Keep()
    cli.logger.addHandler(keep)  # the port's loggers do not propagate
    try:
        args = cli.parse_args(
            f"--num-hosts 8 --seed 3 --trace-limit 1 --device cuda "
            f"--batch-runs 2 --profile-dir {tmp_path / 'p'} --output-dir "
            f"{tmp_path / 'o'} overall --num-apps 2".split())
        cli.run_overall(args, torch_device="cpu", dtype="float64")
    finally:
        cli.logger.removeHandler(keep)
    assert any("--profile-dir is ignored under --batch-runs" in line
               for line in keep.lines)
    assert not (tmp_path / "p").exists()


@pytest.mark.parametrize("tail,recorded,want", [
    (None, range(10, 20), dict(launches=0, recorded=False, skew_us=None,
                               margin_us=None)),
    ((18.5, 19.5), range(10, 20), dict(launches=1, recorded=True,
                                       skew_us=2.0, margin_us=78.0)),
    ((17.5, 19.5), range(10, 19), dict(launches=2, recorded=False,
                                       skew_us=None, margin_us=None)),
])
def test_trace_tail_reads_the_sentinel(tmp_path, tail, recorded, want):
    """``trace_tail`` takes the launches of ``device_profile``'s tail
    range: recorded only when each has its kernel record, the largest
    launch-to-kernel time, and the window's end less their records'."""
    from pivot_tpu_torch.obs.tracer import TAIL_RANGE, trace_tail

    path = tmp_path / "trace.json"
    _chrome_trace(path, range(10, 20), recorded)
    if tail is not None:
        with open(path) as f:
            doc = json.load(f)
        doc["traceEvents"].append({
            "ph": "X", "cat": "user_annotation", "name": TAIL_RANGE,
            "ts": tail[0], "dur": tail[1] - tail[0], "args": {}})
        with open(path, "w") as f:
            json.dump(doc, f)
    assert trace_tail(str(path)) == want
