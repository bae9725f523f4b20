"""The port's native network fabric (``pivot_tpu_torch/native``).

Three parts:

  * the 14 cases of ``tests/test_native.py`` on the port: the port's C++
    engine against the port's Python ``Route`` — completion times bit
    for bit (same double arithmetic), meter metrics to the reference's
    ``approx`` tolerances;
  * ``overall --network native`` through the port's CLI (on ``--device
    numpy``, and on ``--device cuda`` with the torch tensors on the CPU
    in float64), 30 hosts x 30 apps: every arm's four files
    byte-identical to ``pivot_tpu``'s run of the same command;
  * the build: into ``pivot_tpu_torch/_build/native/`` (ignored by git),
    atomically renamed into place, and a missing ``g++`` exiting the CLI
    with the reference's message — never a silent fallback to the
    Python fabric.

The port's build needs ``g++``; tier 1 runs where one is installed.
"""

import os
import subprocess

import numpy as np
import pytest

from pivot_tpu_torch import native
from pivot_tpu_torch.des import Environment
from pivot_tpu_torch.infra.locality import Locality, ResourceMetadata
from pivot_tpu_torch.infra.meter import Meter
from pivot_tpu_torch.infra.network import NativeRoute, Route


class FakeNode:
    def __init__(self, id, locality):
        self.id = id
        self.locality = locality


ZONE_A = Locality("aws", "us-east-1", "a")
ZONE_B = Locality("gcp", "us-west1", "a")


def completion_times(env, events):
    out = {}
    for name, evt in events.items():
        evt.callbacks.append(lambda _e, n=name: out.setdefault(n, env.now))
    env.run()
    return out


def build_pair(bws, meter_cls=None, meta=None):
    """Matching (python, native) route sets over fresh envs."""
    env_py, env_nat = Environment(), Environment()
    meter_py = meter_cls(env_py, meta) if meter_cls else None
    meter_nat = meter_cls(env_nat, meta) if meter_cls else None
    engine = native.NativeNetworkEngine(env_nat)
    if meter_nat is not None:
        meter_nat.add_native_source(engine)
    py_routes, nat_routes = [], []
    for i, bw in enumerate(bws):
        src = FakeNode(f"s{i}", ZONE_A)
        dst = FakeNode(f"d{i}", ZONE_B)
        py_routes.append(Route(env_py, src, dst, bw, meter=meter_py))
        nat_routes.append(
            NativeRoute(env_nat, src, dst, bw, engine, meter=meter_nat)
        )
    return (env_py, py_routes, meter_py), (env_nat, nat_routes, meter_nat)


def test_single_transfer_bit_parity():
    (env_py, [r_py], _), (env_nat, [r_nat], _) = build_pair([777.0])
    t_py = completion_times(env_py, {"x": r_py.send(2500.0)})
    t_nat = completion_times(env_nat, {"x": r_nat.send(2500.0)})
    assert t_py == t_nat  # bit-identical doubles
    assert t_nat["x"] == 1000.0 / 777.0 + 1000.0 / 777.0 + 500.0 / 777.0


def test_round_robin_fair_sharing_parity():
    # Two concurrent multi-chunk transfers interleave chunks round-robin.
    (env_py, [r_py], _), (env_nat, [r_nat], _) = build_pair([1000.0])
    ev_py = {"a": r_py.send(3000.0), "b": r_py.send(2000.0)}
    ev_nat = {"a": r_nat.send(3000.0), "b": r_nat.send(2000.0)}
    t_py = completion_times(env_py, ev_py)
    t_nat = completion_times(env_nat, ev_nat)
    assert t_py == t_nat
    # a: chunks at [0,1],[2,3],[4,5]; b: [1,2],[3,4] -> a@5, b@4.
    assert t_nat == {"a": 5.0, "b": 4.0}


def test_staggered_sends_parity():
    """Sends issued at different sim times through driver processes."""

    def driver(env, routes, record):
        def proc():
            e1 = routes[0].send(2500.0)
            e1.callbacks.append(lambda _e: record.setdefault("e1", env.now))
            yield env.timeout(0.7)
            e2 = routes[0].send(1500.0)
            e2.callbacks.append(lambda _e: record.setdefault("e2", env.now))
            e3 = routes[1].send(400.0)
            e3.callbacks.append(lambda _e: record.setdefault("e3", env.now))

        env.process(proc())
        env.run()

    (env_py, py_routes, _), (env_nat, nat_routes, _) = build_pair([900.0, 333.0])
    rec_py, rec_nat = {}, {}
    driver(env_py, py_routes, rec_py)
    driver(env_nat, nat_routes, rec_nat)
    assert rec_py == rec_nat
    assert set(rec_nat) == {"e1", "e2", "e3"}


def test_random_schedule_parity():
    """Fuzz: a random send schedule yields identical completion times."""
    rng = np.random.default_rng(42)
    n_routes = 5
    sends = []  # (delay_before, route_idx, size)
    for _ in range(60):
        sends.append(
            (
                float(rng.uniform(0, 3)),
                int(rng.integers(0, n_routes)),
                float(rng.uniform(1, 4000)),
            )
        )

    def run(env, routes):
        rec = {}

        def proc():
            for i, (gap, ri, size) in enumerate(sends):
                yield env.timeout(gap)
                evt = routes[ri].send(size)
                evt.callbacks.append(lambda _e, k=i: rec.setdefault(k, env.now))

        env.process(proc())
        env.run()
        return rec

    bws = [500.0, 1000.0, 250.0, 4000.0, 50.0]
    (env_py, py_routes, _), (env_nat, nat_routes, _) = build_pair(bws)
    assert run(env_py, py_routes) == run(env_nat, nat_routes)


def test_queued_mb_and_realtime_bw_parity():
    (env_py, [r_py], _), (env_nat, [r_nat], _) = build_pair([1000.0])
    samples_py, samples_nat = [], []

    def probe(env, route, samples):
        def proc():
            route.send(3000.0)
            route.send(2000.0)
            for _ in range(6):
                samples.append((env.now, route.queued_mb, route.realtime_bw))
                yield env.timeout(0.9)

        env.process(proc())
        env.run()

    probe(env_py, r_py, samples_py)
    probe(env_nat, r_nat, samples_nat)
    assert samples_py == samples_nat


def test_meter_egress_and_congestion_parity():
    meta = ResourceMetadata(seed=0)
    pair = build_pair([800.0, 800.0], meter_cls=Meter, meta=meta)
    (env_py, py_routes, meter_py), (env_nat, nat_routes, meter_nat) = pair
    for routes, env in ((py_routes, env_py), (nat_routes, env_nat)):
        routes[0].send(2500.0)
        routes[0].send(1200.0)
        routes[1].send(999.0)
        env.run()
    assert meter_py.total_network_traffic_cost > 0
    assert meter_py.total_network_traffic_cost == pytest.approx(
        meter_nat.total_network_traffic_cost, rel=1e-12
    )
    assert meter_py.average_congestion_delay > 0
    assert meter_py.average_congestion_delay == pytest.approx(
        meter_nat.average_congestion_delay, rel=1e-12
    )


def test_unmetered_routes_excluded():
    meta = ResourceMetadata(seed=0)
    env = Environment()
    meter = Meter(env, meta)
    engine = native.NativeNetworkEngine(env)
    meter.add_native_source(engine)
    metered = NativeRoute(
        env, FakeNode("a", ZONE_A), FakeNode("b", ZONE_B), 500.0, engine, meter=meter
    )
    unmetered = NativeRoute(
        env, FakeNode("c", ZONE_A), FakeNode("d", ZONE_B), 500.0, engine, meter=None
    )
    metered.send(1000.0)
    unmetered.send(9000.0)
    env.run()
    stats = engine.metered_route_stats()
    assert [r for r, *_ in stats] == [metered]
    cost_metered_only = meta.calc_network_traffic_cost(ZONE_A, ZONE_B, 1000.0)
    assert meter.total_network_traffic_cost == pytest.approx(cost_metered_only)


def test_send_at_exact_completion_instant():
    """A send landing exactly on a chunk boundary queues AFTER the chunk
    that completes at that instant (engine drained to `now` first), so the
    in-flight transfer keeps its round-robin turn.  The pure-Python fabric
    breaks this exact tie by event-heap seq interleaving instead (either
    order can win depending on when the sender's wait was scheduled); the
    native convention is the deterministic one."""

    def run(env, routes):
        rec = {}

        def proc():
            e_old = routes[0].send(3000.0)  # chunks end at t=1,2,3
            e_old.callbacks.append(lambda _e: rec.setdefault("old", env.now))
            routes[1].send(1500.0)  # re-arms the pump mid-flight
            yield env.timeout(2.0)  # lands exactly on old's chunk-2 boundary
            e_new = routes[0].send(1000.0)
            e_new.callbacks.append(lambda _e: rec.setdefault("new", env.now))

        env.process(proc())
        env.run()
        return rec

    (_, _, _), (env_nat, nat_routes, _) = build_pair([1000.0, 1000.0])
    rec_nat = run(env_nat, nat_routes)
    # old's chunk 3 is re-enqueued before new -> old@3, new@4.
    assert rec_nat == {"old": 3.0, "new": 4.0}
    # (In this construction the Python fabric happens to order the send
    # first -> {new: 3, old: 4}; totals and all meter metrics agree.)


def test_pump_callbacks_bounded():
    """Superseded wakes die inert: total scheduled callbacks stay O(sends +
    distinct completion instants), not O(sends x chunks)."""
    env = Environment()
    scheduled = [0]
    orig = env.schedule_callback_at

    def counting(at, fn, priority=1):
        scheduled[0] += 1
        return orig(at, fn)

    env.schedule_callback_at = counting
    engine = native.NativeNetworkEngine(env)
    slow = NativeRoute(
        env, FakeNode("a", ZONE_A), FakeNode("b", ZONE_B), 10.0, engine
    )
    fast = NativeRoute(
        env, FakeNode("c", ZONE_A), FakeNode("d", ZONE_B), 1e6, engine
    )

    def proc():
        slow.send(50_000.0)  # 50 chunks, 100 s each
        for _ in range(40):  # fast sends that each preempt the slow wake
            yield env.timeout(1.0)
            fast.send(1.0)

    env.process(proc())
    env.run()
    chunks = engine.total_chunks
    assert chunks == 50 + 40
    # One live wake per completion instant + one per preempting send;
    # without the arm-seq guard this blows past 1000 (observed ~1538).
    assert scheduled[0] <= 2 * chunks + 45


def test_cancel_queued_transfer_parity():
    """Cancelling a waiting transfer removes it eagerly on both fabrics:
    queued_mb drops immediately, the survivor speeds up, done never fires."""

    def run(env, routes):
        rec = {}

        def proc():
            e_live = routes[0].send(3000.0)
            e_live.callbacks.append(lambda _e: rec.setdefault("live", env.now))
            e_dead = routes[0].send(5000.0)
            e_dead.callbacks.append(lambda _e: rec.setdefault("dead", env.now))
            yield env.timeout(0.5)  # mid-chunk-1 of live
            routes[0].cancel(e_dead)
            rec["queued_after"] = routes[0].queued_mb
            rec["rt_bw_after"] = routes[0].realtime_bw

        env.process(proc())
        env.run()
        return rec

    (env_py, py_routes, _), (env_nat, nat_routes, _) = build_pair([1000.0])
    rec_py = run(env_py, py_routes)
    rec_nat = run(env_nat, nat_routes)
    assert rec_py == rec_nat
    # dead cancelled while waiting: zero of its chunks served, live runs
    # uncontended -> 3 chunks back-to-back.
    assert rec_nat["live"] == 3.0
    assert "dead" not in rec_nat
    # Queue is empty the instant dead is cancelled (live is *in service*,
    # and in-service MB is excluded from queued_mb on both fabrics), so
    # realtime_bw recovers to the full link rate immediately.
    assert rec_nat["queued_after"] == 0.0
    assert rec_nat["rt_bw_after"] == 1000.0


def test_cancel_in_service_transfer_parity():
    """Cancelling the in-service transfer: its current chunk (data on the
    wire) finishes and is metered, nothing further is served."""
    from pivot_tpu_torch.infra.meter import Meter
    from pivot_tpu_torch.infra.locality import ResourceMetadata

    meta = ResourceMetadata(seed=0, jitter=False)
    (env_py, [r_py], m_py), (env_nat, [r_nat], m_nat) = build_pair(
        [1000.0], meter_cls=Meter, meta=meta
    )

    def run(env, route):
        rec = {}

        def proc():
            e_dead = route.send(3000.0)  # in service from t=0
            e_dead.callbacks.append(lambda _e: rec.setdefault("dead", env.now))
            e_live = route.send(2000.0)
            e_live.callbacks.append(lambda _e: rec.setdefault("live", env.now))
            yield env.timeout(0.5)  # mid dead's chunk 1
            route.cancel(e_dead)

        env.process(proc())
        env.run()
        return rec

    rec_py = run(env_py, r_py)
    rec_nat = run(env_nat, r_nat)
    assert rec_py == rec_nat
    # dead's chunk 1 finishes at t=1 (on the wire), then live's two chunks.
    assert rec_nat == {"live": 3.0}
    # Served-MB metering identical: 3000 MB (1 dead + 2 live chunks) hit
    # the wire on both fabrics, so the billed egress matches exactly.
    s_py = m_py.summary()
    s_nat = m_nat.summary()
    assert s_py["egress_cost"] == s_nat["egress_cost"] > 0.0


def test_cancel_completed_transfer_noop():
    """Cancel after completion is a no-op on both fabrics (done fired)."""

    def run(env, route):
        rec = {}

        def proc():
            evt = route.send(500.0)
            evt.callbacks.append(lambda _e: rec.setdefault("done", env.now))
            yield env.timeout(2.0)  # completes at 0.5
            route.cancel(evt)
            rec["queued_after"] = route.queued_mb

        env.process(proc())
        env.run()
        return rec

    (env_py, [r_py], _), (env_nat, [r_nat], _) = build_pair([1000.0])
    rec_py = run(env_py, r_py)
    rec_nat = run(env_nat, r_nat)
    assert rec_py == rec_nat == {"done": 0.5, "queued_after": 0.0}


def test_zero_size_send_rejected():
    (_, _, _), (env_nat, [r_nat], _) = build_pair([100.0])
    with pytest.raises(ValueError):
        r_nat.send(0)


def test_full_sim_parity_native_vs_python():
    """End-to-end: the canonical experiment with both fabrics agrees on
    every summary metric (identical event trajectories)."""
    from pivot_tpu_torch.experiments.runner import ExperimentRun
    from pivot_tpu_torch.utils.config import (
        ClusterConfig,
        HostShape,
        PolicyConfig,
        build_cluster,
        make_policy,
    )

    trace = "data/jobs/jobs-5000-200-172800-259200.npz"
    summaries = {}
    for network in ("python", "native"):
        cfg = ClusterConfig(
            n_hosts=20, shape=HostShape(16, 128 * 1024, 100, 1), seed=3,
            network=network,
        )
        cluster = build_cluster(cfg)
        policy = make_policy(PolicyConfig(name="cost-aware", device="numpy"))
        s = ExperimentRun(
            f"native-parity-{network}", cluster, policy, trace, n_apps=25, seed=3
        ).run()
        summaries[network] = s
    py, nat = summaries["python"], summaries["native"]
    assert py["avg_runtime"] == pytest.approx(nat["avg_runtime"], rel=1e-9)
    assert py["egress_cost"] == pytest.approx(nat["egress_cost"], rel=1e-9)
    assert py["avg_congestion_delay"] == pytest.approx(
        nat["avg_congestion_delay"], rel=1e-9
    )
    assert py["sim_time"] == pytest.approx(nat["sim_time"], rel=1e-12)


# -- overall --network native through both packages' CLIs -------------------

ARGS = ("--num-hosts 30 --seed 3 --trace-limit 1 --network native "
        "--output-dir {out} {extra} overall --num-apps 30")
FILES = ("general.json", "transfers.json", "scheduler.json",
         "host_usage.json")
ARMS = ("Opportunistic", "VBP", "Cost-Aware")


def _outputs(exp_dir):
    out = {}
    for arm in ARMS:
        for name in FILES:
            with open(os.path.join(exp_dir, "data", "0", arm, name),
                      "rb") as f:
                out[arm, name] = f.read()
    return out


@pytest.mark.parametrize("device", ["numpy", "cuda"])
def test_overall_network_native_matches_reference(tmp_path, device):
    """The port's ``overall --network native`` (numpy policies, or the
    cuda policies with torch on the CPU in float64) writes every arm's
    four files byte-identical to ``pivot_tpu``'s ``--network native``
    run of the same command, and the runs really served their routes
    in the C++ engine."""
    from pivot_tpu.experiments import cli as jcli
    from pivot_tpu_torch.experiments import cli as pcli
    from pivot_tpu_torch.utils import reset_ids

    ref = _outputs(jcli.run_overall(jcli.parse_args(ARGS.format(
        out=tmp_path / "ref", extra="--device numpy").split())))
    reset_ids()
    args = pcli.parse_args(ARGS.format(
        out=tmp_path / device,
        extra=f"--device {device} --no-adaptive").split())
    assert args.network == "native"
    engines = []
    build = pcli._build_run

    def build_run(spec):
        run = build(spec)
        engines.append(run.cluster.network_backend)
        return run

    pcli._build_run = build_run
    try:
        exp_dir, summaries = pcli.run_overall(
            args, torch_device="cpu", dtype="float64")
    finally:
        pcli._build_run = build
    assert engines == ["native"] * 3
    got = _outputs(exp_dir)
    for key, want in ref.items():
        assert got[key] == want, key
    assert [s["label"] for s in summaries] == list(ARMS)


def test_native_build_lands_in_the_ignored_directory(tmp_path, monkeypatch):
    """The library builds under ``pivot_tpu_torch/_build/native/``
    (``.gitignore`` lists ``pivot_tpu_torch/_build/``), keyed by source
    hash; a fresh build compiles to a private path and renames it into
    place, leaving no temporary file behind."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
    assert native._BUILD_DIR == os.path.join(pkg, "_build", "native")
    with open(os.path.join(os.path.dirname(pkg), ".gitignore")) as f:
        assert "pivot_tpu_torch/_build/" in f.read().split()
    native.load_library()
    built = os.listdir(native._BUILD_DIR)
    assert f"libpivotnet-{native._source_hash()}.so" in built
    assert not [n for n in built if ".tmp." in n]
    # A fresh build in another directory: the same name, atomically.
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_error", None)
    lib = native.load_library()
    assert lib is not None
    assert os.listdir(tmp_path / "b") == [
        f"libpivotnet-{native._source_hash()}.so"]


def test_missing_gpp_exits_with_the_reference_message(tmp_path, monkeypatch,
                                                      capsys):
    """With no ``g++`` on ``PATH`` (and no library built yet) the engine
    raises :class:`BuildError`, ``available()`` is False, and the CLI's
    ``--network native`` exits 1 with ``pivot_tpu``'s message instead of
    falling back to the Python fabric."""
    from pivot_tpu_torch.experiments import cli as pcli

    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_error", None)
    with pytest.raises(native.BuildError, match="native build failed"):
        native.NativeNetworkEngine(Environment())
    assert not native.available()
    with pytest.raises(SystemExit) as exc:
        pcli.parse_args("--network native overall".split())
    assert exc.value.code == 1
    assert capsys.readouterr().err == (
        "error: --network native needs a working g++ toolchain "
        "(native build failed); use --network python\n")


def test_missing_gpp_cli_run_in_a_fresh_process(tmp_path):
    """The same refusal end to end: ``python -m
    pivot_tpu_torch.experiments.cli --network native overall`` in a
    fresh interpreter whose ``PATH`` has no ``g++`` and whose build
    directory is empty exits 1 with the message and writes no output."""
    empty = tmp_path / "bin"
    empty.mkdir()
    code = (
        "import sys; from pivot_tpu_torch import native; "
        f"native._BUILD_DIR = {str(tmp_path / 'b')!r}; "
        "from pivot_tpu_torch.experiments import cli; "
        "sys.argv = ['cli', '--network', 'native', '--device', 'numpy', "
        f"'--output-dir', {str(tmp_path / 'out')!r}, 'overall']; "
        "cli.main()"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PATH=str(empty), PYTHONPATH=repo)
    import sys

    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    assert proc.stderr.endswith(
        "error: --network native needs a working g++ toolchain "
        "(native build failed); use --network python\n")
    assert not (tmp_path / "out").exists()
