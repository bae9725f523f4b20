"""The lock-step grid: the port's ``run_grid_lockstep`` and
``--batch-runs`` against sequential runs and ``pivot_tpu``'s.

After ``tests/test_batch_dispatch.py:67-137``: G runs advanced
tick-synchronously through one ``DispatchBatcher`` give per-tick
placements and summaries equal to the same runs executed one after
another, and to ``pivot_tpu``'s ``run_grid_lockstep`` (its device
policies under x64 in float64); ``stats_out`` carries the reference's key
set.  On the Cost-Aware kernel path (the plain version of
``greedy_place`` on the CPU) each coalesced tick is one call of the
per-row form.  ``--batch-runs`` writes files byte-identical to
``pivot_tpu``'s ``--batch-runs`` run and to the port's sequential grid.
Exact throughout.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pivot_tpu.sched import tpu as jtpu
from pivot_tpu_torch.ops import cuda_kernels as ck
from pivot_tpu_torch.sched import batch as pbatch
from pivot_tpu_torch.sched import cuda as pcuda

TRACE = "data/jobs/jobs-5000-200-172800-259200.npz"
#: ``stats_out``'s keys (``tests/test_batch_dispatch.py:117-125``).
STATS_KEYS = {
    "runs", "dispatches", "device_calls", "coalesced", "max_group",
    "deadline_flushes", "single_fast_path", "mesh_dispatches",
    "mesh_fallbacks", "mesh_fallback_unshardable",
    "mesh_fallback_mixed_shapes", "mesh_fallback_indivisible",
    "ragged_merges", "ragged_rows", "ragged_pad_cells", "respawns",
    "retired_slots",
}
ARMS = {
    "cost-aware": dict(name="cost-aware", bin_pack="first-fit",
                       sort_tasks=True, sort_hosts=True),
    "first-fit": dict(name="first-fit", decreasing=True),
    "opportunistic": dict(name="opportunistic"),
}


@pytest.fixture
def ref_f64(monkeypatch):
    monkeypatch.setattr(jtpu._DevicePolicyBase, "dtype", jnp.float64)


class _KernelCostAware(pcuda.CudaCostAwarePolicy):
    """The auto rule's verdict on a card: the kernel serves every tick."""

    def _kernel_serves(self):
        return True


def port_policy(arm, kernel=False):
    from pivot_tpu_torch.utils.config import PolicyConfig, make_policy

    if kernel:
        return _KernelCostAware(bin_pack="first-fit", sort_tasks=True,
                                sort_hosts=True, device="cpu")
    return make_policy(PolicyConfig(device="cuda", adaptive=False,
                                    **ARMS[arm]),
                       torch_device="cpu", dtype="float64")


def grid_runs(pkg, make_policy, n_runs, n_hosts=16, n_apps=4):
    """``tests/test_batch_dispatch.py::_grid_runs`` for either package."""
    import importlib

    runner = importlib.import_module(f"{pkg}.experiments.runner")
    config = importlib.import_module(f"{pkg}.utils.config")
    return [
        runner.ExperimentRun(
            f"run-{seed}",
            config.build_cluster(config.ClusterConfig(n_hosts=n_hosts,
                                                      seed=seed)),
            make_policy(), TRACE, n_apps=n_apps, seed=seed, interval=5.0)
        for seed in range(n_runs)
    ]


def record(run):
    log = []
    orig = run.policy.place

    def recorder(ctx):
        p = orig(ctx)
        log.append(np.asarray(p).copy())
        return p

    run.policy.place = recorder
    return log


def strip(summary, keys=None):
    out = {k: v for k, v in summary.items() if k != "wall_clock"}
    return out if keys is None else {k: out[k] for k in keys}


def assert_logs_equal(a, b):
    assert len(a) == len(b)
    for g, (la, lb) in enumerate(zip(a, b)):
        assert len(la) == len(lb), g
        for tick, (x, y) in enumerate(zip(la, lb)):
            np.testing.assert_array_equal(x, y, err_msg=f"run {g} {tick}")


def port_lockstep(make_policy, n_runs=4, **kw):
    from pivot_tpu_torch.experiments.runner import run_grid_lockstep
    from pivot_tpu_torch.utils import reset_ids

    reset_ids()
    seq = grid_runs("pivot_tpu_torch", make_policy, n_runs, **kw)
    seq_logs = [record(r) for r in seq]
    seq_sums = [r.run() for r in seq]
    reset_ids()
    bat = grid_runs("pivot_tpu_torch", make_policy, n_runs, **kw)
    bat_logs = [record(r) for r in bat]
    stats: dict = {}
    bat_sums = run_grid_lockstep(bat, stats_out=stats)
    assert_logs_equal(seq_logs, bat_logs)
    for a, b in zip(seq_sums, bat_sums):
        assert strip(a) == strip(b)
    return bat_logs, bat_sums, stats


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_lockstep_grid_equals_sequential(arm):
    _, _, stats = port_lockstep(lambda: port_policy(arm))
    assert set(stats) == STATS_KEYS
    assert stats["max_group"] == 4 and stats["coalesced"] > 0
    assert stats["deadline_flushes"] == 0
    assert stats["retired_slots"] == 4 and stats["respawns"] == 0


def test_lockstep_kernel_path_is_one_per_row_call_per_tick(monkeypatch):
    """Each coalesced Cost-Aware tick is one call of the per-row form
    over its runs; a coalesced span flush is one batched span, one call
    of the per-row form per span tick (ragged spans merged first)."""
    tick_rows, span_rows, span_flushes, in_span = [], [], [], []
    orig_rows, orig_exec = ck.cost_aware_cuda_rows, pbatch.batch_execute
    driver = pbatch.fused_tick_run_rows

    def rows(*a, **k):
        (span_rows if in_span else tick_rows).append(a[0].shape[0])
        return orig_rows(*a, **k)

    def span_driver(*a, **k):
        in_span.append(True)
        try:
            return driver(*a, **k)
        finally:
            in_span.pop()

    def execute(kernel, requests, static_kw=None, device="cuda"):
        if kernel is pbatch.fused_tick_run and len(requests) > 1:
            span_flushes.append(len(requests))
        return orig_exec(kernel, requests, static_kw, device)

    monkeypatch.setattr(ck, "cost_aware_cuda_rows", rows)
    monkeypatch.setattr(pbatch, "fused_tick_run_rows", span_driver)
    monkeypatch.setattr(pbatch, "batch_execute", execute)
    _, sums, stats = port_lockstep(lambda: port_policy("cost-aware", True),
                                   n_apps=20)
    assert tick_rows and stats["device_calls"] < stats["dispatches"]
    assert span_flushes and span_rows
    assert all(g >= 2 for g in tick_rows + span_rows)
    assert sum(s["spans"]["fused_spans"] for s in sums) > 0
    assert sum(s["dispatch"]["kernel_ticks"] for s in sums) > 0
    assert ck.LAUNCHES["greedy_place"] == 0  # CPU: no launch counted


def test_lockstep_grid_equals_reference(ref_f64):
    from pivot_tpu.experiments.runner import run_grid_lockstep as jlock
    from pivot_tpu.utils import config as jconfig
    from pivot_tpu.utils import reset_ids as j_reset

    logs, sums, stats = port_lockstep(lambda: port_policy("cost-aware"),
                                      n_runs=2, n_hosts=8, n_apps=2)
    j_reset()
    runs = grid_runs("pivot_tpu", lambda: jconfig.make_policy(
        jconfig.PolicyConfig(device="tpu", adaptive=False,
                             **ARMS["cost-aware"])), 2, n_hosts=8, n_apps=2)
    ref_logs = [record(r) for r in runs]
    ref_stats: dict = {}
    ref_sums = jlock(runs, stats_out=ref_stats)
    assert_logs_equal(logs, ref_logs)
    for a, b in zip(sums, ref_sums):
        keys = set(strip(b)) & set(strip(a))
        assert keys >= {"egress_cost", "cum_instance_hours", "avg_runtime",
                        "total_scheduling_ops", "n_apps"}
        assert strip(a, keys) == strip(b, keys)
    assert set(stats) == set(ref_stats) == STATS_KEYS
    assert stats["runs"] == ref_stats["runs"] == 2


def test_lockstep_runs_sequentially_what_it_cannot_batch():
    """A numpy-policy run and an adaptive device run are executed before
    the lock-step group; with nothing batchable only ``runs = 0`` is
    written."""
    from pivot_tpu_torch.experiments.runner import run_grid_lockstep
    from pivot_tpu_torch.utils.config import PolicyConfig, make_policy

    def numpy_pol():
        return make_policy(PolicyConfig(device="numpy",
                                        **ARMS["first-fit"]))

    runs = grid_runs("pivot_tpu_torch", numpy_pol, 2, n_hosts=8, n_apps=2)
    stats: dict = {}
    sums = run_grid_lockstep(runs, stats_out=stats)
    assert stats == {"runs": 0}
    assert [s["label"] for s in sums] == ["run-0", "run-1"]
    one = grid_runs("pivot_tpu_torch", lambda: port_policy("first-fit"), 1,
                    n_hosts=8, n_apps=2)
    stats = {}
    assert run_grid_lockstep(one, stats_out=stats)[0]["n_apps"] == 2
    assert stats == {"runs": 0}


# -- --batch-runs ----------------------------------------------------------------

ARGV = "--num-hosts 12 --seed 3 --trace-limit 2 --output-dir {out} {extra} " \
       "overall --num-apps 6"
FILES = ("general.json", "transfers.json", "scheduler.json",
         "host_usage.json")


def outputs(exp_dir, n_traces=2):
    out = {}
    for i in range(n_traces):
        for arm in ("Opportunistic", "VBP", "Cost-Aware"):
            for name in FILES:
                path = os.path.join(exp_dir, "data", str(i), arm, name)
                with open(path, "rb") as f:
                    out[i, arm, name] = f.read()
    return out


@pytest.fixture(scope="module")
def batch_runs_reference(tmp_path_factory):
    """``pivot_tpu``'s ``--batch-runs 2`` grid (its device policies in
    float64), run once for both port grids below."""
    from pivot_tpu.experiments import cli as jcli
    from pivot_tpu.utils import reset_ids as j_reset

    out = tmp_path_factory.mktemp("batch_runs_reference")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtpu._DevicePolicyBase, "dtype", jnp.float64)
        j_reset()
        ref_dir = jcli.run_overall(jcli.parse_args(ARGV.format(
            out=out, extra="--device tpu --batch-runs 2").split()))
    return outputs(ref_dir)


@pytest.mark.parametrize("extra", [
    "--device cuda --batch-runs 2", "--device cuda --no-adaptive"],
    ids=["batched", "sequential"])
def test_cli_batch_runs_files_equal_reference(tmp_path, batch_runs_reference,
                                              extra):
    """The port's lock-step grid and its sequential grid each write
    ``pivot_tpu``'s ``--batch-runs 2`` files byte for byte."""
    from pivot_tpu_torch.experiments import cli as pcli
    from pivot_tpu_torch.utils import reset_ids as p_reset

    p_reset()
    exp_dir, sums = pcli.run_overall(
        pcli.parse_args(ARGV.format(out=tmp_path, extra=extra).split()),
        torch_device="cpu", dtype="float64")
    assert len(sums) == 6 and all(s is not None for s in sums)
    got = outputs(exp_dir)
    for key, want in batch_runs_reference.items():
        assert got[key] == want, key


@pytest.mark.parametrize("extra,msg", [
    ("--device numpy --batch-runs 2", "--device cuda"),
    ("--batch-runs 2 --workers 2", "mutually exclusive")])
def test_cli_batch_runs_refusals(tmp_path, capsys, extra, msg):
    from pivot_tpu_torch.experiments import cli as pcli

    with pytest.raises(SystemExit):
        pcli.parse_args(ARGV.format(out=tmp_path, extra=extra).split())
    assert msg in capsys.readouterr().err


def test_cli_batch_runs_forces_no_adaptive_and_needs_the_card(
        tmp_path, monkeypatch):
    from pivot_tpu_torch.experiments import cli as pcli

    args = pcli.parse_args(ARGV.format(
        out=tmp_path, extra="--adaptive --batch-runs 2").split())
    assert args.adaptive is False and args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        pcli.run_overall(args)
