"""The replica axis of the port's mesh: the sharded ensemble, sweeps and
search against ``pivot_tpu``'s, on the CPU in float64 under x64.

``pivot_tpu`` shards these with ``NamedSharding`` over its virtual
8-device CPU mesh (``tests/conftest.py``); the port's mesh names the CPU
S times (``replica_mesh(devices=[cpu] * S)``), S logical shards of one
device:

  * ``sharded_rollout`` against ``pivot_tpu``'s on ``build_mesh(8)``
    (after ``tests/test_ensemble.py:302``), every policy with perturbed
    runtimes, faults with and without ``mttr`` (the contracted draw) and
    the congestion model — bit for bit, the egress bill within rtol
    1e-12 (XLA's CPU GEMM, ``parallel/ensemble/bill.py``) — and bit for
    bit against the port's unsharded ``rollout``; a case whose row
    blocks finish many ticks apart; the indivisible replica count's
    ``ValueError``;
  * ``shard_sweep`` over ``capacity_sweep`` (with and without faults),
    ``workload_sweep`` and ``score_param_sweep`` with ``force_mesh=True``
    against ``pivot_tpu``'s (after ``tests/test_ensemble.py:1054-1110``),
    and its fallbacks in the reference's order with the reasons it logs;
  * the ``sharded_rollout`` fitness backend: ``evaluate_rows`` against
    ``pivot_tpu``'s sharded backend and bit-identical to the ``rollout``
    backend (after ``tests/test_search.py:176``, ``:326``), the CEM and
    ES searches on both backends, and ``search --backend
    sharded_rollout`` through the CLI against ``pivot_tpu``'s report;
  * the CLI's routing of ``ensemble`` and the sweeps over a replica mesh.

The batcher's replica mesh is ``tests/test_torch_replica_mesh_batch.py``.
"""

from __future__ import annotations

import functools
import json
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pivot_tpu.parallel import ensemble as JE
from pivot_tpu.parallel.mesh import build_mesh as j_build_mesh
from pivot_tpu.search import fitness as JF
from pivot_tpu_torch.parallel import ensemble as E
from pivot_tpu_torch.parallel.ensemble import prng
from pivot_tpu_torch.parallel.mesh import replica_mesh
from pivot_tpu_torch.search import fitness as PF
from pivot_tpu_torch.search.weights import DEFAULT_WEIGHTS, PolicyWeights

from tests.test_torch_ensemble import (  # noqa: F401  (fixtures)
    POLICIES,
    _pair_inputs,
    _random_apps,
    _workload,
    assert_results_equal,
    jax_cluster,
    port_cluster,
)

CPU = torch.device("cpu")
#: Two distinct cards, named only: nothing runs on them.
CARDS = [torch.device("cuda", 0), torch.device("cuda", 1)]
TINY = dict(n_hosts=8, seed=3, n_apps=3, horizon=300.0, n_replicas=4)


def cpu_mesh(S):
    return replica_mesh(devices=[CPU] * S)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """``pivot_tpu``'s sweeps leave JAX's caches retracing later
    functions of this process (ROADMAP.md Queue 3, flake 1)."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def mesh8():
    return j_build_mesh(8, ("replica", "host"))


@pytest.fixture(scope="module")
def pair(jax_cluster, port_cluster):
    apps, arrivals, wdtype = _workload("3")
    return _pair_inputs(jax_cluster, port_cluster, apps, arrivals, wdtype)


class LogRecords(logging.Handler):
    """The records of one of the port's loggers (they print to stdout and
    do not propagate to the root logger)."""

    def __init__(self, name):
        super().__init__(logging.INFO)
        self.records = []
        self.logger = logging.getLogger(f"pivot_tpu_torch.{name}")

    def emit(self, record):
        self.records.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self.records

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


def assert_bitwise(a, b, what=""):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), (name, what)


# -- sharded_rollout ----------------------------------------------------------

OPTIONS = {
    "perturb": dict(perturb=0.2),
    "faults": dict(n_faults=3, fault_horizon=60.0),
    "faults_mttr": dict(n_faults=3, fault_horizon=60.0, mttr=20.0),
    "congestion": dict(congestion=True, n_faults=2, fault_horizon=60.0,
                       mttr=15.0),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("policy", POLICIES)
def test_sharded_rollout_equals_reference(pair, mesh8, policy, option):
    (jw, jtopo, ja0, jsz), (pw, ptopo, pa0, psz) = pair
    kw = dict(n_replicas=16, tick=5.0, max_ticks=96, perturb=0.1,
              policy=policy)
    kw.update(OPTIONS[option])
    got = E.sharded_rollout(cpu_mesh(8), prng.PRNGKey(2), pa0, pw, ptopo,
                            psz, **kw)
    want = JE.sharded_rollout(mesh8, jax.random.PRNGKey(2), ja0, jw, jtopo,
                              jsz, **kw)
    assert len(want.makespan.sharding.device_set) == 8
    assert_results_equal(got, want, f"{policy} {option}")
    assert_bitwise(got, E.rollout(prng.PRNGKey(2), pa0, pw, ptopo, psz,
                                  **kw), "unsharded")


def test_sharded_rollout_blocks_finishing_apart(jax_cluster, port_cluster,
                                                mesh8):
    """perturb 0.4 with faults and outages spreads the replicas over many
    ticks, and the blocks of the 4-shard layout end at different ticks:
    the one tick loop runs until the last block is done, a finished
    replica stays frozen, and every block equals its rows of the
    reference's sharded run and of the unsharded rollout."""
    apps = _random_apps(np.random.default_rng(5), 2, 8, chain=True,
                        name="z")
    (jw, jtopo, ja0, jsz), (pw, ptopo, pa0, psz) = _pair_inputs(
        jax_cluster, port_cluster, apps, [0.0, 30.0], "float64")
    kw = dict(n_replicas=16, tick=5.0, max_ticks=256, perturb=0.4,
              n_faults=2, fault_horizon=80.0, mttr=25.0,
              policy="cost-aware")
    stats = {}
    mesh = cpu_mesh(4)
    got = E.sharded_rollout(mesh, prng.PRNGKey(7), pa0, pw, ptopo, psz,
                            stats=stats, **kw)
    assert got.n_unfinished.max().item() == 0
    last = [got.makespan[b].max().item()
            for b in E.sweep_out_shardings(mesh).makespan.blocks(16)]
    assert len(set(last)) == 4 and max(last) - min(last) > 2 * kw["tick"]
    assert stats["ticks"] >= max(last) / kw["tick"]
    want = JE.sharded_rollout(mesh8, jax.random.PRNGKey(7), ja0, jw, jtopo,
                              jsz, **kw)
    assert_results_equal(got, want, "blocks apart")
    assert_bitwise(got, E.rollout(prng.PRNGKey(7), pa0, pw, ptopo, psz,
                                  **kw), "unsharded")


def test_sharded_rollout_refusals(pair):
    _, (pw, ptopo, pa0, psz) = pair
    with pytest.raises(ValueError, match="n_replicas=6 does not divide "
                       "over the mesh's 4 replica shards"):
        E.sharded_rollout(cpu_mesh(4), prng.PRNGKey(0), pa0, pw, ptopo, psz,
                          n_replicas=6)
    with pytest.raises(ValueError, match="mesh names the device"):
        E.sharded_rollout(replica_mesh(devices=[torch.device("meta")] * 2),
                          prng.PRNGKey(0), pa0, pw, ptopo, psz, n_replicas=2)


def test_row_sharding_layout():
    from pivot_tpu_torch.ops.shard import check_row_divisibility, row_sharding

    rows = row_sharding(cpu_mesh(4))
    assert rows.n_shards == 4 and rows.device() == CPU
    assert rows.blocks(8) == [slice(0, 2), slice(2, 4), slice(4, 6),
                              slice(6, 8)]
    with pytest.raises(ValueError, match="12 rows do not divide over the "
                       "mesh's 8 replica shards"):
        check_row_divisibility(cpu_mesh(8), 12)
    res = E.sweep_out_shardings(cpu_mesh(2))
    assert res._fields == E.RolloutResult._fields
    assert all(r.n_shards == 2 for r in res)


# -- shard_sweep --------------------------------------------------------------

SWEEP_KW = dict(n_replicas=16, tick=5.0, max_ticks=64, perturb=0.1)


def _sweep_args(which, pkg_inputs, port):
    w, topo, a0, sz = pkg_inputs
    if which == "capacity":
        grid = (E.capacity_grid(a0, [4, 8]) if port
                else JE.capacity_grid(a0, [4, 8]))
        return (grid, w, topo, sz)
    if which == "workload":
        return (a0, w, topo, sz, [1, 3])
    return (a0, w, topo, sz, np.array([[1.0, 1.0, 1.0], [2.0, 1.0, 0.5]],
                                      np.float32))


SWEEPS = {
    "capacity": ("capacity_sweep", {}),
    "capacity_faults": ("capacity_sweep", dict(n_faults=3,
                                               fault_horizon=60.0,
                                               mttr=20.0)),
    "workload": ("workload_sweep", dict(policy="first-fit")),
    "score": ("score_param_sweep", {}),
}


@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_shard_sweep_equals_reference(pair, case):
    jin, pin = pair
    name, extra = SWEEPS[case]
    which = case.split("_")[0]
    kw = dict(SWEEP_KW, **extra)
    sweep = E.shard_sweep(getattr(E, name), force_mesh=True,
                          devices=[CPU] * 8, **kw)
    assert type(sweep).__name__ == "_ShardedSweep"
    got = sweep(prng.PRNGKey(17), *_sweep_args(which, pin, True))
    want = JE.shard_sweep(getattr(JE, name), force_mesh=True, **kw)(
        jax.random.PRNGKey(17), *_sweep_args(which, jin, False))
    assert len(want.makespan.sharding.device_set) == 8
    assert_results_equal(got, want, case)
    plain = getattr(E, name)(prng.PRNGKey(17), *_sweep_args(which, pin, True),
                             **kw)
    if case != "capacity_faults":
        assert_bitwise(got, plain, case)


def test_shard_sweep_fallbacks_log_the_reference_reasons(pair):
    """The fallback order and reasons of ``pivot_tpu``'s ``shard_sweep``
    (one device, an explicit ``segment_ticks``, an indivisible replica
    count — the sweep's own default counted — and the CPU without
    ``force_mesh``), then the port's own (several distinct cards:
    ROADMAP.md Queue 1, several cards), each an unsharded
    ``functools.partial``."""
    _, (pw, ptopo, pa0, psz) = pair
    cases = [
        (dict(devices=[CPU]), dict(n_replicas=16), None),
        (dict(devices=[CPU] * 8, force_mesh=True),
         dict(n_replicas=16, segment_ticks=8),
         "explicit segment_ticks requests the host-side segmented loop"),
        (dict(devices=[CPU] * 8, force_mesh=True), dict(n_replicas=6),
         "replicas (6) not divisible by 8 devices"),
        (dict(devices=[CPU] * 3, force_mesh=True), {},
         "replicas (32) not divisible by 3 devices"),
        (dict(devices=[CPU] * 8), dict(n_replicas=16),
         "CPU backend (forced-host-device meshes share the physical "
         "cores; pass force_mesh=True to shard anyway)"),
        (dict(devices=CARDS), dict(n_replicas=16),
         "2 distinct devices (a mesh over several cards is not ported "
         "yet: ROADMAP.md Queue 1, several cards)"),
    ]
    for opts, kw, reason in cases:
        with LogRecords("ensemble") as logged:
            fn = E.shard_sweep(E.capacity_sweep, fallback_segment_ticks=32,
                               **opts, **dict(kw, tick=5.0, max_ticks=64))
        assert isinstance(fn, functools.partial), opts
        assert fn.keywords["segment_ticks"] == kw.get("segment_ticks", 32)
        assert logged == ([] if reason is None
                          else [f"sweep runs unsharded: {reason}"]), opts
    # The n_replicas=6 fallback runs (unsharded, 6 replicas).
    fb = E.shard_sweep(E.capacity_sweep, force_mesh=True, devices=[CPU] * 8,
                       n_replicas=6, tick=5.0, max_ticks=64, perturb=0.1)
    res = fb(prng.PRNGKey(17), E.capacity_grid(pa0, [4, 8]), pw, ptopo, psz)
    assert tuple(res.makespan.shape) == (2, 6)
    # No visible card here: the default device list is empty.
    assert isinstance(E.shard_sweep(E.capacity_sweep), functools.partial)


# -- the sharded_rollout fitness backend --------------------------------------


@pytest.fixture(scope="module")
def envs():
    return (JF.make_search_env(dtype=jnp.float64, **TINY),
            PF.make_search_env(dtype=torch.float64, device="cpu", **TINY))


def test_fitness_sharded_backend_equals_reference(envs, mesh8):
    je, pe = envs
    pop = PolicyWeights.stack([DEFAULT_WEIGHTS,
                               PolicyWeights(risk_weight=5.0)])
    want, wd = JF.evaluate_rows(pop, je, backend="sharded_rollout",
                                mesh=mesh8)
    s_rows, d_rows = PF.evaluate_rows(pop, pe)
    for S in (1, 2, 8):
        got, gd = PF.evaluate_rows(pop, pe, backend="sharded_rollout",
                                   mesh=cpu_mesh(S))
        np.testing.assert_array_equal(got, s_rows)
        for k in ("egress", "instance_cost", "unfinished", "completed",
                  "makespan", "admitted"):
            np.testing.assert_array_equal(gd[k], d_rows[k], err_msg=k)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        for k in ("instance_cost", "unfinished", "completed", "makespan"):
            np.testing.assert_array_equal(gd[k], wd[k], err_msg=k)
        assert gd["backend"] == wd["backend"] == "sharded_rollout"
        assert gd["n_rows"] == wd["n_rows"] == 8


def test_fitness_sharded_input_validation(envs, mesh8):
    """``tests/test_search.py:212-227``'s sharded cases, the same
    exception and message on both packages."""
    je, pe = envs
    one = PolicyWeights.stack([DEFAULT_WEIGHTS])
    three = PolicyWeights.stack([DEFAULT_WEIGHTS] * 3)
    for mod, env, mesh in ((JF, je, mesh8), (PF, pe, cpu_mesh(8))):
        with pytest.raises(ValueError, match="needs a replica mesh"):
            mod.evaluate_rows(one, env, backend="sharded_rollout")
        with pytest.raises(ValueError, match="12 rows do not divide over "
                           "the mesh's 8 replica shards"):
            mod.evaluate_rows(three, env, backend="sharded_rollout",
                              mesh=mesh)
        with pytest.raises(ValueError, match="finite"):
            mod.evaluate_rows(np.full((2, 5), np.nan), env,
                              backend="sharded_rollout", mesh=mesh)


@pytest.mark.parametrize("method", ["cem", "es"])
def test_search_identical_across_fitness_backends(envs, mesh8, method):
    """After ``tests/test_search.py:326``: the same winner and trace on
    both backends, and the reference's sharded search's."""
    from pivot_tpu.search import cem as jcem
    from pivot_tpu.search import es as jes
    from pivot_tpu_torch.search.cem import cem_search
    from pivot_tpu_torch.search.es import es_search

    from tests.test_torch_search import assert_close_tree

    je, pe = envs
    if method == "cem":
        run, ref, kw = cem_search, jcem.cem_search, dict(generations=2,
                                                         popsize=4, seed=5)
    else:
        # 5 candidates x 8 replicas = 40 rows over 8 shards.
        je, pe = je._replace(n_replicas=8), pe._replace(n_replicas=8)
        run, ref, kw = es_search, jes.es_search, dict(generations=2,
                                                      popsize=5, seed=5)
    a = run(pe, **kw)
    b = run(pe, backend="sharded_rollout", mesh=cpu_mesh(8), **kw)
    want = ref(je, backend="sharded_rollout", mesh=mesh8, **kw)
    assert a.best == b.best
    da, db = a.to_dict(), b.to_dict()
    assert da.pop("backend") == "rollout"
    assert db["backend"] == "sharded_rollout"
    assert_close_tree(db, want.to_dict())
    db.pop("backend")
    assert da == db


def test_search_cli_sharded_backend_equals_reference(tmp_path, monkeypatch,
                                                     capsys):
    """``search --backend sharded_rollout`` at the tiny size: the port's
    report (a mesh of the CPU) equals ``pivot_tpu``'s (its 8-device
    mesh), its environments in float64."""
    from pivot_tpu.experiments import cli as jcli
    from pivot_tpu_torch.experiments import cli as pcli

    from tests.test_torch_search import assert_close_tree

    monkeypatch.setattr(JF, "make_search_env", functools.partial(
        JF.make_search_env, dtype=jnp.float64))
    argv = ["search", "--method", "cem", "--generations", "2", "--popsize",
            "4", "--replicas", "4", "--hosts", "8", "--num-apps", "3",
            "--horizon", "300", "--holdout", "1", "--bad-init",
            "--no-oracle", "--backend", "sharded_rollout"]
    jout, pout = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    jcli.run_search_cli(jcli.parse_args(argv + ["--out", jout]))
    got = pcli.run_search_cli(pcli.parse_args(argv + ["--out", pout]),
                              torch_device="cpu", dtype="float64")
    capsys.readouterr()
    with open(jout) as f:
        want = json.load(f)
    with open(pout) as f:
        assert json.load(f) == json.loads(json.dumps(got))
    assert got["config"]["backend"] == "sharded_rollout"
    assert_close_tree(json.loads(json.dumps(got)), want)


# -- the CLI's routing ---------------------------------------------------------


ENS_ARGV = ("--num-hosts 12 --seed 1 --output-dir {out} ensemble "
            "--num-apps 3 --replicas 8 --max-ticks 400 --faults 2 "
            "--fault-mttr 40")


def test_cli_ensemble_routes_over_the_replica_mesh(tmp_path, monkeypatch):
    """With several devices (four logical CPU shards stand in for the
    cards) ``ensemble`` runs ``sharded_rollout`` and ignores
    ``--replica-chunk`` with the reference's warning; with
    ``--checkpoint`` it runs unsharded.  The sharded run's results are
    the contracted rollout's; the unsharded CLI draws the eager
    schedule, and the two agree here field by field."""
    from pivot_tpu_torch.experiments import cli as pcli

    def run(extra, devices):
        monkeypatch.setattr(pcli, "_replica_devices",
                            lambda device: devices)
        out = tmp_path / (extra[:4] or "none")
        args = pcli.parse_args((ENS_ARGV.format(out=out) + " "
                                + extra).split())
        summary = pcli.run_ensemble(args, torch_device="cpu",
                                    dtype="float64")
        out = sorted((out / "ensemble").iterdir())[-1]
        return summary, dict(np.load(out / "rollout.npz"))

    calls = []
    import pivot_tpu_torch.parallel.ensemble as ens

    orig = ens.sharded_rollout

    def spy(mesh, *a, **k):
        calls.append(mesh)
        return orig(mesh, *a, **k)

    monkeypatch.setattr(ens, "sharded_rollout", spy)
    with LogRecords("cli") as logged:
        sharded, s_arr = run("--replica-chunk 2", [CPU] * 4)
    assert len(calls) == 1 and calls[0].shape == {"replica": 4, "host": 1}
    assert any("--replica-chunk ignored: 4-device mesh" in m
               for m in logged)
    assert sharded["devices"] == 4 and sharded["replica_chunk"] == 0
    ck = tmp_path / "ck.npz"
    plain, p_arr = run(f"--checkpoint {ck}", [CPU] * 4)
    assert len(calls) == 1 and plain["devices"] == 4
    chunked, _ = run("--replica-chunk 2", [])
    assert chunked["devices"] == 1 and chunked["replica_chunk"] == 2
    one, o_arr = run("", [CPU])
    assert one["devices"] == 1 and one["replica_chunk"] == 0
    for key in p_arr:
        np.testing.assert_array_equal(s_arr[key], p_arr[key], err_msg=key)
        np.testing.assert_array_equal(o_arr[key], p_arr[key], err_msg=key)
    skip = ("wall_s", "replica_rollouts_per_sec", "devices", "replica_chunk")
    assert {k: v for k, v in sharded.items() if k not in skip} == \
        {k: v for k, v in plain.items() if k not in skip}


def test_cli_sweeps_route_through_shard_sweep(monkeypatch):
    """``_maybe_shard_sweep``: over a mesh of logical shards of one card a
    sharded sweep; on the CPU, one card or several distinct cards (a
    mesh over them is ROADMAP.md Queue 1, several cards) the unsharded
    sweep in 256-tick segments."""
    from pivot_tpu_torch.experiments import cli as pcli

    for devices, sharded in (([], False), (CARDS[:1], False),
                             (CARDS, False), (CARDS[:1] * 4, True)):
        monkeypatch.setattr(pcli, "_replica_devices",
                            lambda device, d=devices: d)
        fn = pcli._maybe_shard_sweep(E.capacity_sweep, CPU, n_replicas=8)
        if sharded:
            assert type(fn).__name__ == "_ShardedSweep"
            assert fn.mesh.shape == {"replica": 4, "host": 1}
            assert "segment_ticks" not in fn.keywords
        else:
            assert isinstance(fn, functools.partial)
            assert fn.keywords["segment_ticks"] == pcli.SWEEP_SEGMENT_TICKS
    monkeypatch.undo()
    assert pcli._replica_devices(CPU) == []


def test_cli_runs_unsharded_over_distinct_cards(tmp_path, monkeypatch):
    """Over two distinct cards (named, not used: the runs are on the CPU)
    ``ensemble`` and ``capacity`` complete unsharded, each logging why —
    the results of the run with no card."""
    from pivot_tpu_torch.experiments import cli as pcli

    calls = []
    orig = E.sharded_rollout
    monkeypatch.setattr(E, "sharded_rollout",
                        lambda *a, **k: calls.append(a) or orig(*a, **k))

    def ensemble(devices):
        monkeypatch.setattr(pcli, "_replica_devices", lambda d: devices)
        out = tmp_path / f"ens{len(devices)}"
        summary = pcli.run_ensemble(pcli.parse_args(
            ENS_ARGV.format(out=out).split()), torch_device="cpu",
            dtype="float64")
        run = sorted((out / "ensemble").iterdir())[-1]
        return summary, dict(np.load(run / "rollout.npz"))

    def capacity(devices):
        monkeypatch.setattr(pcli, "_replica_devices", lambda d: devices)
        return pcli.run_capacity(pcli.parse_args(
            ["--num-hosts", "8", "--output-dir",
             str(tmp_path / f"cap{len(devices)}"), "capacity", "--num-apps",
             "2", "--host-counts", "4", "8", "--replicas", "4",
             "--max-ticks", "256"]), torch_device="cpu", dtype="float64")

    with LogRecords("cli") as logged:
        two, two_arr = ensemble(CARDS)
    assert logged == ["ensemble runs unsharded: 2 distinct devices (a mesh "
                      "over several cards is not ported yet: ROADMAP.md "
                      "Queue 1, several cards)"]
    none, none_arr = ensemble([])
    assert not calls and two["devices"] == 2 and none["devices"] == 1
    for key in none_arr:
        np.testing.assert_array_equal(two_arr[key], none_arr[key],
                                      err_msg=key)
    with LogRecords("ensemble") as logged:
        cap_two = capacity(CARDS)
    assert logged == ["sweep runs unsharded: 2 distinct devices (a mesh "
                      "over several cards is not ported yet: ROADMAP.md "
                      "Queue 1, several cards)"]
    cap_none = capacity([])
    skip = ("wall_s", "devices", "replica_chunk", "replica_rollouts_per_sec")
    assert {k: v for k, v in two.items() if k not in skip} == \
        {k: v for k, v in none.items() if k not in skip}
    assert {k: v for k, v in cap_two.items() if k != "wall_s"} == \
        {k: v for k, v in cap_none.items() if k != "wall_s"}
