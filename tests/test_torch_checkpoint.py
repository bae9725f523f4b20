"""Checkpoint/resume: the port's segmented ensemble rollouts and
grid-level resume, ``tests/test_checkpoint.py``'s thirteen cases on the
port, and the port's files against ``pivot_tpu``'s.

  * a checkpointed run equals an uninterrupted one bit for bit at any
    ``segment_ticks`` (1, 7, 256) and across a kill; a resumed run
    continues from the file; a file of other arguments restarts the run;
    faults, every policy arm, congestion and realtime scoring thread
    through; replica chunks (``rollout_chunked``) with and without files;
    the ``overall`` grid's ``--resume``; ``ensemble --checkpoint``;
  * ``pivot_tpu``'s ``test_forms_mismatch_restarts`` becomes: both form
    names give one fingerprint and one result (the port has one tick
    body);
  * against ``pivot_tpu`` (float32, jax's default config): the results of
    ``rollout_checkpointed`` and the checkpoint file after the first
    segment, field by field (integer fields cast), and the fingerprint.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pivot_tpu.des import Environment as JEnvironment
from pivot_tpu.infra import Cluster as JCluster
from pivot_tpu.infra import Host as JHost
from pivot_tpu.infra import Storage as JStorage
from pivot_tpu.infra.locality import ResourceMetadata as JMeta
from pivot_tpu.ops.kernels import DeviceTopology as JTopology
from pivot_tpu.parallel import ensemble as JE
from pivot_tpu.workload import Application as JApplication
from pivot_tpu.workload import TaskGroup as JTaskGroup
from pivot_tpu_torch.des import Environment
from pivot_tpu_torch.infra import Cluster, Host, Storage
from pivot_tpu_torch.infra.locality import ResourceMetadata
from pivot_tpu_torch.ops.kernels import DeviceTopology
from pivot_tpu_torch.parallel import ensemble as E
from pivot_tpu_torch.parallel.ensemble import prng
from pivot_tpu_torch.workload import Application, TaskGroup

CFG = dict(n_replicas=8, tick=5.0, max_ticks=64, perturb=0.1)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(env_cls, host_cls, storage_cls, cluster_cls, meta_cls, app_cls,
           group_cls):
    meta = meta_cls(seed=0)
    env = env_cls()
    hosts = [host_cls(env, 16, 1 << 16, 100, 2, locality=meta.zones[i % 5])
             for i in range(8)]
    storage = [storage_cls(env, z)
               for z in dict.fromkeys(h.locality for h in hosts)]
    cluster = cluster_cls(env, hosts=hosts, storage=storage, meta=meta,
                          route_mode="meta", seed=0)
    app = app_cls("ck", [
        group_cls("a", cpus=1, mem=64, runtime=30, output_size=200,
                  instances=6),
        group_cls("b", cpus=2, mem=128, runtime=20, dependencies=["a"],
                  instances=4),
        group_cls("c", cpus=1, mem=64, runtime=10, dependencies=["b"],
                  instances=2),
    ])
    return cluster, app


@pytest.fixture(scope="module")
def setup():
    """``tests/test_checkpoint.py``'s world on the port (float32)."""
    cluster, app = _build(Environment, Host, Storage, Cluster,
                          ResourceMetadata, Application, TaskGroup)
    topo = DeviceTopology.from_cluster(cluster, torch.float32, device="cpu")
    workload = E.EnsembleWorkload.from_applications([app], device="cpu")
    avail0 = torch.tensor(cluster.availability_matrix(), dtype=torch.float32)
    sz = torch.as_tensor(np.asarray(cluster.storage_zone_vector())).long()
    return avail0, workload, topo, sz


def _jax_setup():
    """The same world on ``pivot_tpu``; call under ``enable_x64(False)``."""
    cluster, app = _build(JEnvironment, JHost, JStorage, JCluster, JMeta,
                          JApplication, JTaskGroup)
    return (jnp.asarray(cluster.availability_matrix(), dtype=jnp.float32),
            JE.EnsembleWorkload.from_applications([app]),
            JTopology.from_cluster(cluster, jnp.float32),
            jnp.asarray(cluster.storage_zone_vector()))


def _assert_same(a, b):
    for f in ("makespan", "placement", "finish_time", "egress_cost",
              "instance_hours", "n_unfinished"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)


def _assert_matches_jax(port, want):
    for f in ("makespan", "placement", "finish_time", "instance_hours",
              "n_unfinished"):
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_allclose(port.egress_cost.numpy(),
                               np.asarray(want.egress_cost), rtol=1e-5)


class _Dies:
    """Wraps the package's segment step: the process "dies" (raises) at
    the call after ``after`` segments; counts the calls it let through."""

    def __init__(self, orig, after=None):
        self.orig, self.after, self.calls = orig, after, []

    def __call__(self, *args, **kw):
        if self.after is not None and len(self.calls) >= self.after:
            raise KeyboardInterrupt("killed mid-run")
        self.calls.append(args[7])
        return self.orig(*args, **kw)


def test_checkpointed_matches_plain(setup, tmp_path):
    avail0, workload, topo, sz = setup
    key = prng.PRNGKey(3)
    plain = E.rollout(key, avail0, workload, topo, sz, **CFG)
    ckpt = str(tmp_path / "roll.npz")
    seg = E.rollout_checkpointed(key, avail0, workload, topo, sz, ckpt,
                                 segment_ticks=7, **CFG)
    _assert_same(plain, seg)
    assert os.path.exists(ckpt)


@pytest.mark.parametrize("segment_ticks", [1, 7, 256])
@pytest.mark.parametrize("congestion", [False, True])
def test_any_segment_length_same_bits(setup, tmp_path, segment_ticks,
                                      congestion):
    avail0, workload, topo, sz = setup
    key = prng.PRNGKey(8)
    kw = dict(CFG, policy="opportunistic", congestion=congestion,
              tick_order="lifo")
    plain = E.rollout(key, avail0, workload, topo, sz, **kw)
    seg = E.rollout_checkpointed(key, avail0, workload, topo, sz,
                                 str(tmp_path / "r.npz"),
                                 segment_ticks=segment_ticks, **kw)
    _assert_same(plain, seg)


def test_resume_after_interrupt(setup, tmp_path, monkeypatch):
    """A run killed mid-flight, resumed from its partial checkpoint with
    the same arguments, gives the bits of an uninterrupted run."""
    avail0, workload, topo, sz = setup
    key = prng.PRNGKey(4)
    plain = E.rollout(key, avail0, workload, topo, sz, **CFG)
    ckpt = str(tmp_path / "roll.npz")
    orig = E._segment_step
    monkeypatch.setattr(E, "_segment_step", _Dies(orig, after=1))
    with pytest.raises(KeyboardInterrupt):
        E.rollout_checkpointed(key, avail0, workload, topo, sz, ckpt,
                               segment_ticks=5, **CFG)
    with np.load(ckpt) as f:
        assert 0 < int(f["ticks_done"]) < CFG["max_ticks"]
    monkeypatch.setattr(E, "_segment_step", orig)
    res = E.rollout_checkpointed(key, avail0, workload, topo, sz, ckpt,
                                 segment_ticks=5, **CFG)
    _assert_same(plain, res)


def test_resume_continues_not_restarts(setup, tmp_path, monkeypatch):
    avail0, workload, topo, sz = setup
    key = prng.PRNGKey(5)
    ckpt = str(tmp_path / "roll.npz")
    counting = _Dies(E._segment_step)
    monkeypatch.setattr(E, "_segment_step", counting)
    E.rollout_checkpointed(key, avail0, workload, topo, sz, ckpt,
                           segment_ticks=8, **CFG)
    n_first = len(counting.calls)
    assert n_first >= 1
    with np.load(ckpt) as f:
        done = int(f["ticks_done"])
    counting.calls.clear()
    res = E.rollout_checkpointed(key, avail0, workload, topo, sz, ckpt,
                                 segment_ticks=8, **CFG)
    assert len(counting.calls) < n_first or done >= CFG["max_ticks"]
    _assert_same(E.rollout(key, avail0, workload, topo, sz, **CFG), res)


def test_fingerprint_mismatch_restarts(setup, tmp_path):
    avail0, workload, topo, sz = setup
    ckpt = str(tmp_path / "roll.npz")
    E.rollout_checkpointed(prng.PRNGKey(1), avail0, workload, topo, sz, ckpt,
                           segment_ticks=16, **CFG)
    res = E.rollout_checkpointed(prng.PRNGKey(2), avail0, workload, topo, sz,
                                 ckpt, segment_ticks=16, **CFG)
    _assert_same(E.rollout(prng.PRNGKey(2), avail0, workload, topo, sz,
                           **CFG), res)


def test_forms_mismatch_restarts(setup, tmp_path, monkeypatch):
    """The port has one tick body: ``forms="vector"`` and ``"indexed"``
    give one fingerprint, so a file of either resumes under the other
    (strictly fewer segment calls than a cold run), with one result."""
    avail0, workload, topo, sz = setup
    key = prng.PRNGKey(6)
    args = (key, CFG["n_replicas"], CFG["tick"], CFG["max_ticks"],
            CFG["perturb"], workload, topo, avail0, sz)
    assert E._fingerprint(*args, forms="vector") == \
        E._fingerprint(*args, forms="indexed")
    ckpt = str(tmp_path / "roll.npz")
    counting = _Dies(E._segment_step)
    monkeypatch.setattr(E, "_segment_step", counting)
    first = E.rollout_checkpointed(key, avail0, workload, topo, sz, ckpt,
                                   segment_ticks=8, forms="vector", **CFG)
    n_cold = len(counting.calls)
    counting.calls.clear()
    again = E.rollout_checkpointed(key, avail0, workload, topo, sz, ckpt,
                                   segment_ticks=8, forms="indexed", **CFG)
    assert len(counting.calls) < n_cold
    _assert_same(first, again)
    _assert_same(E.rollout(key, avail0, workload, topo, sz, forms="indexed",
                           **CFG), again)
    with pytest.raises(ValueError, match="forms"):
        E.rollout_checkpointed(key, avail0, workload, topo, sz, None,
                               forms="tiled", **CFG)


def test_cli_grid_resume(tmp_path):
    """``--resume`` reuses the experiment directory and skips completed
    runs; a changed run spec or cluster shape, a truncated sentinel and a
    missing one re-run (the numpy arms, as ``pivot_tpu``'s test)."""
    import json

    from pivot_tpu_torch.experiments import cli

    out = str(tmp_path / "out")
    argv = ["--num-hosts", "8", "--trace-limit", "1", "--output-dir", out,
            "--job-dir", "./data/jobs", "--device", "numpy"]
    exp_dir, _ = cli.run_overall(cli.parse_args(
        argv + ["overall", "--num-apps", "3"]))
    markers = [os.path.join(r, f) for r, _d, fs in os.walk(exp_dir)
               for f in fs if f == "general.json"]
    assert len(markers) == 3
    stamps = {m: os.path.getmtime(m) for m in markers}

    exp_dir2, _ = cli.run_overall(cli.parse_args(
        argv + ["--resume", exp_dir, "overall", "--num-apps", "3"]))
    assert exp_dir2 == exp_dir
    for m, ts in stamps.items():
        assert os.path.getmtime(m) == ts

    cli.run_overall(cli.parse_args(
        argv + ["--resume", exp_dir, "overall", "--num-apps", "2"]))
    assert {m: os.path.getmtime(m) for m in stamps} != stamps

    shaped = ["--cpus", "32"] + argv + ["--resume", exp_dir, "overall",
                                        "--num-apps", "2"]
    before = {m: os.path.getmtime(m) for m in stamps}
    cli.run_overall(cli.parse_args(shaped))
    assert {m: os.path.getmtime(m) for m in stamps} != before

    sentinels = sorted(os.path.join(r, f) for r, _d, fs in os.walk(exp_dir)
                       for f in fs if f == "complete.json")
    assert len(sentinels) == 3
    with open(sentinels[0], "w") as f:
        f.write('{"label": "Oppor')  # truncated JSON
    cli.run_overall(cli.parse_args(shaped))
    with open(sentinels[0]) as f:
        json.load(f)

    removed, intact = sentinels[0], sentinels[1:]
    os.remove(removed)
    mtimes = {s: os.path.getmtime(os.path.join(os.path.dirname(s),
                                               "general.json"))
              for s in sentinels}
    cli.run_overall(cli.parse_args(shaped))
    assert os.path.exists(removed)
    assert os.path.getmtime(os.path.join(os.path.dirname(removed),
                                         "general.json")) > mtimes[removed]
    for s in intact:
        g = os.path.join(os.path.dirname(s), "general.json")
        assert os.path.getmtime(g) == mtimes[s]


def test_checkpointed_fault_rollout_matches_plain(setup, tmp_path):
    """Fault schedules thread through the segments bit-identically (drawn
    eagerly: ``_rollout(contract=False)`` is the one-loop twin), and the
    faults engage."""
    avail0, workload, topo, sz = setup
    fcfg = dict(n_faults=3, fault_horizon=100.0, mttr=40.0)
    key = prng.PRNGKey(5)
    plain = E._rollout(key, avail0, workload, topo, sz, contract=False,
                       **CFG, **fcfg)
    seg = E.rollout_checkpointed(key, avail0, workload, topo, sz,
                                 checkpoint_path=str(tmp_path / "f.npz"),
                                 segment_ticks=7, **CFG, **fcfg)
    _assert_same(plain, seg)
    base = E.rollout(key, avail0, workload, topo, sz, **CFG)
    assert not torch.equal(base.makespan, plain.makespan)


def test_checkpointed_policy_arm_matches_plain(setup, tmp_path):
    avail0, workload, topo, sz = setup
    for policy in ("first-fit", "opportunistic"):
        plain = E.rollout(prng.PRNGKey(9), avail0, workload, topo, sz,
                          policy=policy, **CFG)
        seg = E.rollout_checkpointed(
            prng.PRNGKey(9), avail0, workload, topo, sz,
            checkpoint_path=str(tmp_path / f"{policy}.npz"),
            segment_ticks=9, policy=policy, **CFG)
        _assert_same(plain, seg)


def test_checkpointed_congestion_rollout_matches_plain(setup, tmp_path):
    """The backlog pipes ``q`` ride the checkpoint; realtime scoring
    too."""
    avail0, w, topo, sz = setup
    for realtime in (False, True):
        kw = dict(n_replicas=4, tick=5.0, max_ticks=64, perturb=0.1,
                  congestion=True, realtime_scoring=realtime)
        plain = E.rollout(prng.PRNGKey(3), avail0, w, topo, sz, **kw)
        ck = E.rollout_checkpointed(prng.PRNGKey(3), avail0, w, topo, sz,
                                    str(tmp_path / f"c{realtime}.npz"),
                                    segment_ticks=7, **kw)
        _assert_same(plain, ck)
        with np.load(str(tmp_path / f"c{realtime}.npz")) as f:
            assert f["q"].shape == (4, topo.cost.shape[0], 8)


def test_chunked_first_chunk_matches_plain(setup):
    avail0, w, topo, sz = setup
    key = prng.PRNGKey(9)
    chunked = E.rollout_chunked(key, avail0, w, topo, sz, None,
                                replica_chunk=3, **CFG)
    head = E.rollout(key, avail0, w, topo, sz, **{**CFG, "n_replicas": 3})
    for f in ("makespan", "placement", "finish_time", "egress_cost"):
        assert torch.equal(getattr(chunked, f)[:3], getattr(head, f)), f


def test_chunked_shapes_determinism_and_ragged_tail(setup):
    avail0, w, topo, sz = setup
    key = prng.PRNGKey(9)
    a = E.rollout_chunked(key, avail0, w, topo, sz, None, replica_chunk=3,
                          **CFG)
    b = E.rollout_chunked(key, avail0, w, topo, sz, None, replica_chunk=3,
                          **CFG)
    assert a.makespan.shape == (CFG["n_replicas"],)
    assert a.finish_time.shape[0] == CFG["n_replicas"]
    _assert_same(a, b)
    ft = a.finish_time
    assert not torch.equal(ft[0:3], ft[3:6])


def test_chunked_disabled_matches_checkpointed(setup, tmp_path):
    avail0, w, topo, sz = setup
    key = prng.PRNGKey(5)
    base = E.rollout_checkpointed(key, avail0, w, topo, sz, None,
                                  segment_ticks=16, **CFG)
    off = E.rollout_chunked(key, avail0, w, topo, sz, None, 0,
                            segment_ticks=16, **CFG)
    big = E.rollout_chunked(key, avail0, w, topo, sz, None, 64,
                            segment_ticks=16, **CFG)
    filed = E.rollout_chunked(key, avail0, w, topo, sz,
                              str(tmp_path / "one.npz"), 0,
                              segment_ticks=16, **CFG)
    _assert_same(base, off)
    _assert_same(base, big)
    _assert_same(base, filed)
    assert os.path.exists(str(tmp_path / "one.npz"))


def test_chunked_checkpoint_resume(setup, tmp_path):
    avail0, w, topo, sz = setup
    key = prng.PRNGKey(7)
    ckpt = str(tmp_path / "chunk.npz")
    first = E.rollout_chunked(key, avail0, w, topo, sz, ckpt,
                              replica_chunk=4, segment_ticks=16, **CFG)
    assert os.path.exists(str(tmp_path / "chunk.c0.npz"))
    assert os.path.exists(str(tmp_path / "chunk.c1.npz"))
    again = E.rollout_chunked(key, avail0, w, topo, sz, ckpt,
                              replica_chunk=4, segment_ticks=16, **CFG)
    _assert_same(first, again)
    # Chunks draw like chunked rollouts without files (contract=True
    # per chunk there; no faults here, so the same bits).
    _assert_same(first, E.rollout_chunked(key, avail0, w, topo, sz, None,
                                          replica_chunk=4, **CFG))


def test_segment_ticks_must_be_positive(setup):
    avail0, w, topo, sz = setup
    with pytest.raises(ValueError, match="segment_ticks"):
        E.rollout_checkpointed(prng.PRNGKey(0), avail0, w, topo, sz, None,
                               segment_ticks=0, **CFG)


# -- against pivot_tpu ------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(),
    dict(policy="first-fit", tick_order="lifo", congestion=True),
    dict(n_faults=3, fault_horizon=100.0, mttr=40.0, congestion="pairs"),
    dict(congestion=True, realtime_scoring=True),
], ids=["plain", "ff-lifo-congestion", "faults-pairs", "realtime"])
def test_matches_pivot_tpu_and_file_after_first_segment(setup, tmp_path,
                                                        monkeypatch, kw):
    """Kill both packages after their first segment of 7 ticks: the two
    files hold the same state, field by field (``pivot_tpu``'s int32
    fields, ``q`` zeros without congestion), and the same fingerprint;
    resumed, the results are ``pivot_tpu``'s."""
    avail0, w, topo, sz = setup
    kw = dict(CFG, **kw)
    pfile, jfile = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    monkeypatch.setattr(E, "_segment_step", _Dies(E._segment_step, 1))
    with pytest.raises(KeyboardInterrupt):
        E.rollout_checkpointed(prng.PRNGKey(11), avail0, w, topo, sz, pfile,
                               segment_ticks=7, **kw)
    orig = JE._segment_step
    calls = []

    def dying(*args, **k):
        if calls:
            raise KeyboardInterrupt("killed mid-run")
        calls.append(1)
        return orig(*args, **k)

    with jax.enable_x64(False):
        ja0, jw, jtopo, jsz = _jax_setup()
        monkeypatch.setattr(JE, "_segment_step", dying)
        with pytest.raises(KeyboardInterrupt):
            JE.rollout_checkpointed(jax.random.PRNGKey(11), ja0, jw, jtopo,
                                    jsz, jfile, segment_ticks=7,
                                    forms="indexed", **kw)
        with np.load(jfile) as j:
            first = {f: j[f] for f in j.files}
        monkeypatch.setattr(JE, "_segment_step", orig)
        want = JE.rollout_checkpointed(jax.random.PRNGKey(11), ja0, jw,
                                       jtopo, jsz, jfile, segment_ticks=7,
                                       forms="indexed", **kw)
    j = first
    with np.load(pfile) as p:
        assert set(p.files) == set(j)
        assert int(p["ticks_done"]) == int(j["ticks_done"]) == 7
        assert str(p["fingerprint"]) == str(j["fingerprint"])
        for f in E.RolloutState._fields:
            assert p[f].dtype == j[f].dtype, f
            np.testing.assert_array_equal(p[f], j[f], err_msg=f)
    monkeypatch.undo()
    got = E.rollout_checkpointed(prng.PRNGKey(11), avail0, w, topo, sz,
                                 pfile, segment_ticks=7, **kw)
    _assert_matches_jax(got, want)


def test_cli_ensemble_checkpoint_resumes(tmp_path, monkeypatch):
    """``ensemble --checkpoint F``: the file is written, a rerun resumes
    it (no segment runs) and both runs write ``pivot_tpu``'s arrays."""
    from pivot_tpu.experiments import cli as jcli
    from pivot_tpu_torch.experiments import cli as pcli

    ckpt = str(tmp_path / "roll.npz")

    def argv(out, path):
        return ["--num-hosts", "16", "--job-dir", "data/jobs",
                "--output-dir", out, "--seed", "2", "ensemble",
                "--num-apps", "3", "--replicas", "8", "--max-ticks", "256",
                "--checkpoint", path, "--congestion"]

    stats = {}
    first = pcli.run_ensemble(pcli.parse_args(argv(str(tmp_path / "a"),
                                                   ckpt)),
                              torch_device="cpu", stats=stats)
    assert first["unfinished_max"] == 0 and first["congestion"] is True
    assert os.path.exists(ckpt) and stats["ticks"] > 0
    counting = _Dies(E._segment_step)
    monkeypatch.setattr(E, "_segment_step", counting)
    again = pcli.run_ensemble(pcli.parse_args(argv(str(tmp_path / "b"),
                                                   ckpt)),
                              torch_device="cpu")
    assert counting.calls == []
    for k in ("makespan_mean", "egress_mean", "instance_hours_mean"):
        assert again[k] == first[k], k
    monkeypatch.undo()
    with jax.enable_x64(False):
        want = jcli.run_ensemble(jcli.parse_args(argv(str(tmp_path / "j"),
                                                      str(tmp_path / "j.npz"))))
    for k in ("makespan_mean", "instance_hours_mean", "unfinished_max"):
        assert first[k] == want[k], k
    assert first["egress_mean"] == pytest.approx(want["egress_mean"],
                                                 rel=1e-5)
