"""The port stands alone: no ``jax`` and nothing of ``pivot_tpu``.

The test process itself has imported ``jax`` (``tests/conftest.py``), so
the run-time check happens in a fresh subprocess: it imports the port,
runs one tiny ``overall``, one tiny ``ensemble`` with faults, one with
congestion and a checkpoint file, one tiny ``capacity`` sweep (the row
runner, ``sweeps.py``), a tiny ``calibrate``, a one-generation CEM
``search`` (fitness, optimizer, held-out seeds, oracle, DES validation),
the market-replay tool, the workload generators, a tiny ``serve``
(two sessions on the dispatch batcher, with tiers and the metrics
registry), a lock-step ``overall --batch-runs 2``, ``serve`` with
serve spans (``--fuse-spans slo``) and resident carries (``--resident
--splice-tier 1``), ``serve --mpc`` with one planner window scored, and
a resident serve with the recovery plane armed, on the CPU, imports the
trace converter and sampler, and lists what is in ``sys.modules``; a
second probe runs ``overall --network native`` (the C++ fabric), one
device policy degraded by an injected kernel fault and promoted back by
a half-open probe, and ``serve --profile-dispatch``.  A static AST scan covers
every file of the package — ``serve/``, ``sched/batch.py``, ``obs/``
(``obs/profiler.py`` among them), ``search/``, ``experiments/search.py``,
``experiments/spot.py``, ``experiments/sample.py``, ``workload/``,
``parallel/ensemble/``, ``mpc/``, ``recover/``, ``native/``,
``infra/roofline.py``, ``analysis/``, ``obs/costattr.py``,
``utils/compile_counter.py``, ``experiments/plots.py`` and ``tools/``
among them — and ``chip_smoke.py``.  A third probe runs the tooling:
the graftcheck suite and its compile check, cost attribution, the
compile counter's observer and the ``worker`` subcommand, and one
host-sharded pass on a mesh of logical shards (``ops/shard.py``,
``parallel/mesh.py``).  A fourth runs elastic serving (``serve/
elastic.py``: a shard killed mid-soak, the pool shrunk and regrown) and
the chaos-replay tool (``tools/chaos_replay.py``).
"""

import ast
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "pivot_tpu")

PROBE = r"""
import json, sys, tempfile
from pivot_tpu_torch.experiments import calibrate, cli
from pivot_tpu_torch.infra import faults, market
from pivot_tpu_torch.ops import tickloop
from pivot_tpu_torch.sched import sensitivity
from pivot_tpu_torch.experiments import sample
from pivot_tpu_torch.parallel.ensemble import checkpoint
from pivot_tpu_torch.workload import convert, gen
with tempfile.TemporaryDirectory() as out:
    args = cli.parse_args(
        ["--device", "cuda", "--no-adaptive", "--num-hosts", "8",
         "--trace-limit", "1", "--output-dir", out, "overall",
         "--num-apps", "3"])
    _, summaries = cli.run_overall(args, torch_device="cpu")
    ens = cli.run_ensemble(cli.parse_args(
        ["--num-hosts", "8", "--output-dir", out, "ensemble",
         "--num-apps", "3", "--replicas", "2", "--max-ticks", "256",
         "--faults", "2", "--fault-mttr", "20"]),
        torch_device="cpu")
    cong = cli.run_ensemble(cli.parse_args(
        ["--num-hosts", "8", "--output-dir", out, "ensemble",
         "--num-apps", "3", "--replicas", "2", "--max-ticks", "256",
         "--congestion", "--realtime-score", "--checkpoint",
         out + "/ck.npz"]), torch_device="cpu")
    cal = cli.run_calibrate(cli.parse_args(
        ["--num-hosts", "8", "--output-dir", out, "calibrate",
         "--num-apps", "2", "--max-ticks", "256"]), torch_device="cpu")
    app = gen.SequentialApplicationGenerator(
        (3, 3), gen._RangeSpec(cpus=(1, 2), mem=(64, 128),
                               runtime=(1, 10)), seed=0).generate()
    cap = cli.run_capacity(cli.parse_args(
        ["--num-hosts", "8", "--output-dir", out, "capacity",
         "--num-apps", "2", "--host-counts", "4", "8", "--replicas", "2",
         "--max-ticks", "256"]), torch_device="cpu")
    search = cli.run_search_cli(cli.parse_args(
        ["search", "--generations", "1", "--popsize", "3", "--replicas",
         "2", "--hosts", "6", "--num-apps", "2", "--horizon", "200",
         "--holdout", "1", "--des-validate", "--out", out + "/s.json"]),
        torch_device="cpu")
    from pivot_tpu_torch.tools import market_replay
    replay = market_replay.main(["generate", "--hosts", "6", "--out",
                                 out + "/m.json"])
    serve = cli.run_serve_stream(cli.parse_args(
        ["--num-hosts", "8", "--output-dir", out, "serve", "--sessions",
         "2", "--jobs", "6", "--arrival-rate", "0.5", "--tier-mix",
         "0.5,0.5", "--metrics-out", out + "/metrics.prom"]),
        torch_device="cpu")
    _, lock = cli.run_overall(cli.parse_args(
        ["--num-hosts", "8", "--trace-limit", "2", "--batch-runs", "2",
         "--output-dir", out, "overall", "--num-apps", "3"]),
        torch_device="cpu")
    spans = [cli.run_serve_stream(cli.parse_args(
        ["--num-hosts", "8", "--output-dir", out, "serve", "--sessions",
         "2", "--jobs", "6", "--arrival-rate", "5", "--fuse-spans", "slo",
         *extra]), torch_device="cpu")
        for extra in ((), ("--resident", "--splice-tier", "1"))]
    mpc = cli.run_serve_stream(cli.parse_args(
        ["--num-hosts", "8", "--output-dir", out, "serve", "--sessions",
         "1", "--jobs", "8", "--arrival-rate", "2.5", "--tier-mix",
         "0.4,0.3,0.3", "--mpc", "--mpc-pool", "1:2"]), torch_device="cpu")
    from pivot_tpu_torch.mpc import forecast, planner
    from pivot_tpu_torch.search.weights import DEFAULT_WEIGHTS
    from pivot_tpu_torch.serve import (
        RecoveryConfig, ServeDriver, ServeSession, poisson_arrivals)
    from pivot_tpu_torch.utils.config import (
        ClusterConfig, PolicyConfig, build_cluster, make_policy)
    tpl = build_cluster(ClusterConfig(n_hosts=6, seed=1))
    env, _, tiers = forecast.render_env(
        forecast.TierForecast((0.05, 0.0, 0.0), (1.0, 0.0, 0.0), 4, 60.0),
        cluster=tpl, market=market.MarketSchedule.generate(
            tpl.meta, seed=1, horizon=60.0),
        horizon=60.0, seed=1, n_replicas=2, n_apps=2, device="cpu")
    window = planner.plan(planner.enumerate_actions(
        1, g_min=1, g_max=2, incumbent=DEFAULT_WEIGHTS), env, tiers, 1)
    drv = ServeDriver(
        [ServeSession("s0", build_cluster(ClusterConfig(n_hosts=6, seed=0)),
                      make_policy(PolicyConfig(
                          name="cost-aware", device="cuda", adaptive=False,
                          bin_pack="first-fit", sort_tasks=True,
                          sort_hosts=True), torch_device="cpu"),
                      seed=0, fuse_spans="slo")],
        resident=True, splice_tier=1,
        recovery=RecoveryConfig(directory=out + "/rec", snapshot_every=1))
    rec = drv.run(poisson_arrivals(5.0, 6, seed=0))
print(json.dumps({
    "arms": [s["label"] for s in summaries],
    "ensemble_unfinished": ens["unfinished_max"],
    "congestion_unfinished": cong["unfinished_max"],
    "calibrate_modes": sorted(m for m in ("static", "congested")
                              if cal[m]["unfinished_max"] == 0),
    "generated_groups": len(app.groups),
    "yaml_loaded": "yaml" in sys.modules,
    "capacity_best": cap["best"] is not None,
    "search_regret": sorted(search["oracle"]["regret"]),
    "search_des": sorted(search["des_validation"]),
    "market_replay": replay,
    "serve_completed": serve["slo"]["counters"]["completed"],
    "serve_coalesced": serve["batcher"]["coalesced"],
    "lockstep_runs": len([x for x in lock if x is not None]),
    "span_serve_completed": [r["slo"]["counters"]["completed"]
                             for r in spans],
    "span_serve_resident": [r["resident"] for r in spans],
    "mpc_observed": mpc["mpc"]["forecast"]["n_observed"],
    "mpc_window_slots": len(window.objectives),
    "recovery_completed": rec["slo"]["counters"]["completed"],
    "recovery_journal": rec["recovery"]["journal"]["records"],
    "modules": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "pivot_tpu")),
}))
"""


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_port_runs_without_jax_or_reference_modules():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["arms"] == ["Opportunistic", "VBP", "Cost-Aware"]
    assert report["ensemble_unfinished"] == 0
    assert report["congestion_unfinished"] == 0
    assert report["calibrate_modes"] == ["congested", "static"]
    assert report["generated_groups"] == 3
    # The card's machine has no PyYAML: importing the converter and the
    # sampler must not need it.
    assert report["yaml_loaded"] is False
    assert report["capacity_best"]
    assert report["search_regret"] == report["search_des"] == [
        "hand_tuned_default", "hand_tuned_risk_aware", "learned"]
    assert report["market_replay"] == 0
    assert report["serve_completed"] == 6
    assert report["serve_coalesced"] > 0
    assert report["lockstep_runs"] == 6
    assert report["span_serve_completed"] == [6, 6]
    assert report["span_serve_resident"] == [False, True]
    assert report["mpc_observed"] == 8
    assert report["mpc_window_slots"] == 5
    assert report["recovery_completed"] == 6
    assert report["recovery_journal"] > 6
    assert report["modules"] == []


#: The native fabric, the degrade guard and the dispatch profiler, in a
#: probe of their own (the first probe is near the per-test budget).
PROBE_12 = r"""
import json, sys, tempfile
from pivot_tpu_torch.experiments import cli
from pivot_tpu_torch.experiments.runner import ExperimentRun
from pivot_tpu_torch.utils.config import (
    ClusterConfig, PolicyConfig, build_cluster, make_policy)
with tempfile.TemporaryDirectory() as out:
    _, native_runs = cli.run_overall(cli.parse_args(
        ["--device", "numpy", "--num-hosts", "8", "--trace-limit", "1",
         "--network", "native", "--output-dir", out, "overall",
         "--num-apps", "3"]))
    deg = make_policy(PolicyConfig(name="first-fit", device="cuda",
                                   adaptive=False), torch_device="cpu",
                      dtype="float64")
    deg.degrade_after, deg._degrade.probe_every = 1, 1
    flaky, left = deg._device_place, [1]
    def device_place(ctx):
        if left[0]:
            left[0] -= 1
            raise RuntimeError("injected kernel fault")
        return flaky(ctx)
    deg._device_place = device_place
    ExperimentRun("deg", build_cluster(ClusterConfig(n_hosts=8, seed=0)),
                  deg, "data/jobs/jobs-5000-200-172800-259200.npz",
                  n_apps=3, seed=0).run()
    prof = cli.run_serve_stream(cli.parse_args(
        ["--num-hosts", "8", "--output-dir", out, "serve", "--sessions",
         "2", "--jobs", "6", "--arrival-rate", "0.5",
         "--profile-dispatch", "2"]), torch_device="cpu")
print(json.dumps({
    "native_arms": [s["label"] for s in native_runs],
    "degrade": [deg.kernel_failures, deg._degrade.probes,
                deg._degrade.promotions, deg.degraded],
    "profiled_families": sorted(prof["profiler"]["families"]),
    "modules": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "pivot_tpu")),
}))
"""


def test_native_guard_profiler_run_without_jax_or_reference_modules():
    """``overall --network native``, a device policy degraded by an
    injected kernel fault and promoted back by a half-open probe, and
    ``serve --profile-dispatch`` load neither ``jax`` nor ``pivot_tpu``."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", PROBE_12], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["native_arms"] == ["Opportunistic", "VBP", "Cost-Aware"]
    failures, probes, promotions, degraded = report["degrade"]
    assert (failures, promotions, degraded) == (1, 1, False)
    assert probes >= 1
    assert report["profiled_families"] == ["cost_aware"]
    assert report["modules"] == []


#: The tooling: the graftcheck suite (static passes and the
#: compile check), the compile counter's observer, cost attribution, the
#: figures and the resident worker.
PROBE_13 = r"""
import contextlib, io, json, sys, tempfile
from pivot_tpu_torch import analysis
from pivot_tpu_torch.experiments import cli, plots
from pivot_tpu_torch.obs import MetricsRegistry, attach_compile_observer
from pivot_tpu_torch.obs.costattr import cost_attribution
from pivot_tpu_torch.utils import compile_counter
import torch
from pivot_tpu_torch.ops.shard import first_fit_kernel_sharded
from pivot_tpu_torch.parallel.mesh import host_sharded_mesh
sharded, _ = first_fit_kernel_sharded(
    host_sharded_mesh(devices=[torch.device("cpu")] * 2), torch.ones(4, 4),
    torch.full((3, 4), 0.6), torch.tensor([True, True, False]))
detach = attach_compile_observer(MetricsRegistry())
compile_counter.record("graph_capture")
detach()
static_rc = analysis.main([])
check = analysis.compile_check(quick=True, device="cpu")
ca = cost_attribution(device="cpu")
with tempfile.TemporaryDirectory() as out:
    argv = ["--device", "numpy", "--num-hosts", "8", "--trace-limit", "1",
            "--output-dir", out, "overall", "--num-apps", "2"]
    sys.stdin = io.StringIO(json.dumps(argv) + "\nquit\n")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.run_worker()
    served = [json.loads(ln) for ln in buf.getvalue().splitlines()
              if ln.startswith('{"served"')]
print(json.dumps({
    "static_rc": static_rc,
    "steady": check["steady"],
    "complete": ca["complete"],
    "served": served[0]["ok"],
    "sharded": sharded.tolist(),
    "modules": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "pivot_tpu")),
}))
"""


def test_tooling_runs_without_jax_or_reference_modules():
    """The graftcheck suite, the compile check, cost attribution and the
    worker (serving one ``overall`` request, figures drawn) load neither
    ``jax`` nor ``pivot_tpu``."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", PROBE_13], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["static_rc"] == 0
    assert report["steady"] == {"kernel_build": 0, "graph_capture": 0}
    assert report["complete"] is True
    assert report["served"] is True
    assert report["sharded"] == [0, 1, -1]
    assert report["modules"] == []


#: Elastic serving and the chaos-replay tool.
PROBE_18 = r"""
import json, sys, tempfile
import torch
from pivot_tpu_torch import serve
from pivot_tpu_torch.infra.faults import ChaosEvent, ChaosSchedule
from pivot_tpu_torch.parallel.mesh import host_sharded_mesh
from pivot_tpu_torch.tools import chaos_replay
from pivot_tpu_torch.utils.config import (
    ClusterConfig, PolicyConfig, build_cluster, make_policy)

def factory(label):
    pol = make_policy(PolicyConfig(
        name="cost-aware", device="cuda", adaptive=False,
        bin_pack="first-fit", sort_tasks=True, sort_hosts=True),
        torch_device="cpu")
    pol.enable_sharding(host_sharded_mesh(devices=[torch.device("cpu")] * 4))
    return serve.ServeSession(
        label, build_cluster(ClusterConfig(n_hosts=8, seed=0)), pol,
        seed=0, fuse_spans="slo")

mgr = serve.ElasticMeshManager(serve.ElasticConfig(schedule=ChaosSchedule(
    seed=1, events=[ChaosEvent(kind="device_fault", at=2.0,
                               target="device:1", duration=100.0)])))
arrivals = list(serve.poisson_arrivals(2.0, 6, seed=0)) + [
    serve.JobArrival(ts=5000.0, app=serve.synthetic_app_factory(seed=3)(),
                     tier=0)]
driver = serve.ServeDriver([factory("s0")], resident=True,
                           session_factory=factory, max_restarts=2,
                           elastic=mgr)
report = driver.run(iter(arrivals))
from pivot_tpu_torch.utils import reset_ids
reset_ids()  # generate names hosts by the process's id counters
with tempfile.TemporaryDirectory() as out:
    rcs = [chaos_replay.main(["generate", "--hosts", "6", "--out",
                              out + "/c.json"])]
    for tag in "ab":
        rcs.append(chaos_replay.main(["run", "--schedule", out + "/c.json",
                                      "--hosts", "6", "--apps", "2",
                                      "--out", out + f"/{tag}.json"]))
    rcs.append(chaos_replay.main(["diff", out + "/a.json", out + "/b.json"]))
print(json.dumps({
    "completed": report["slo"]["counters"]["completed"],
    "events": [kind for _, kind, _ in mgr.events],
    "chaos_replay": rcs,
    "modules": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "pivot_tpu")),
}))
"""


def test_elastic_and_chaos_replay_run_without_jax_or_reference_modules():
    """Elastic serving (a logical shard lost mid-soak: shrink, then regrow
    after a probe) and ``chaos_replay`` generate / run / diff load
    neither ``jax`` nor ``pivot_tpu``."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", PROBE_18], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["completed"] == 7
    assert report["events"] == ["loss", "regrow"]
    assert report["chaos_replay"] == [0, 0, 0, 0]
    assert report["modules"] == []


def _sources():
    pkg = os.path.join(ROOT, "pivot_tpu_torch")
    for dirpath, _dirs, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_file_of_the_port_imports_jax_or_reference():
    offenders = []
    seen = set()
    for path in _sources():
        seen.add(os.path.relpath(path, ROOT))
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, ROOT)}:{node.lineno} "
                          f"{name}" for name in names if _forbidden(name)]
    assert len(seen) > 20
    assert {"pivot_tpu_torch/ops/tickloop.py", "chip_smoke.py",
            "pivot_tpu_torch/ops/shard.py",
            "pivot_tpu_torch/parallel/mesh.py",
            "pivot_tpu_torch/infra/market.py",
            "pivot_tpu_torch/sched/sensitivity.py",
            "pivot_tpu_torch/parallel/ensemble/sweeps.py",
            "pivot_tpu_torch/parallel/ensemble/libm.py",
            "pivot_tpu_torch/search/fitness.py",
            "pivot_tpu_torch/search/loop.py",
            "pivot_tpu_torch/search/cem.py",
            "pivot_tpu_torch/search/es.py",
            "pivot_tpu_torch/search/oracle.py",
            "pivot_tpu_torch/experiments/search.py",
            "pivot_tpu_torch/experiments/spot.py",
            "pivot_tpu_torch/tools/market_replay.py",
            "pivot_tpu_torch/parallel/ensemble/checkpoint.py",
            "pivot_tpu_torch/experiments/calibrate.py",
            "pivot_tpu_torch/experiments/sample.py",
            "pivot_tpu_torch/workload/gen.py",
            "pivot_tpu_torch/workload/convert.py",
            "pivot_tpu_torch/sched/batch.py",
            "pivot_tpu_torch/sched/cuda.py",
            "pivot_tpu_torch/experiments/runner.py",
            "pivot_tpu_torch/experiments/cli.py",
            "pivot_tpu_torch/serve/__init__.py",
            "pivot_tpu_torch/serve/admission.py",
            "pivot_tpu_torch/serve/arrivals.py",
            "pivot_tpu_torch/serve/autoscale.py",
            "pivot_tpu_torch/serve/driver.py",
            "pivot_tpu_torch/serve/session.py",
            "pivot_tpu_torch/obs/registry.py",
            "pivot_tpu_torch/obs/metrics_http.py",
            "pivot_tpu_torch/mpc/__init__.py",
            "pivot_tpu_torch/mpc/controller.py",
            "pivot_tpu_torch/mpc/forecast.py",
            "pivot_tpu_torch/mpc/planner.py",
            "pivot_tpu_torch/mpc/rollout.py",
            "pivot_tpu_torch/mpc/tuner.py",
            "pivot_tpu_torch/recover/__init__.py",
            "pivot_tpu_torch/recover/journal.py",
            "pivot_tpu_torch/recover/snapshot.py",
            "pivot_tpu_torch/recover/watchdog.py",
            "pivot_tpu_torch/native/__init__.py",
            "pivot_tpu_torch/obs/profiler.py",
            "pivot_tpu_torch/infra/roofline.py",
            "pivot_tpu_torch/analysis/__init__.py",
            "pivot_tpu_torch/analysis/__main__.py",
            "pivot_tpu_torch/analysis/determinism.py",
            "pivot_tpu_torch/analysis/dtype.py",
            "pivot_tpu_torch/analysis/entrymap.py",
            "pivot_tpu_torch/analysis/hostsync.py",
            "pivot_tpu_torch/analysis/kernel_budget.py",
            "pivot_tpu_torch/analysis/obsbound.py",
            "pivot_tpu_torch/analysis/parity.py",
            "pivot_tpu_torch/analysis/profbound.py",
            "pivot_tpu_torch/analysis/threadguard.py",
            "pivot_tpu_torch/obs/costattr.py",
            "pivot_tpu_torch/utils/compile_counter.py",
            "pivot_tpu_torch/experiments/plots.py",
            "pivot_tpu_torch/serve/elastic.py",
            "pivot_tpu_torch/tools/chaos_replay.py"} <= seen
    assert offenders == []
