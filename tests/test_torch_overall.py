"""A whole ``overall`` experiment through the port vs through ``pivot_tpu``.

The port's CLI path (``pivot_tpu_torch.experiments.cli.run_overall``)
runs the three reference arms — on ``--device cuda`` with the torch
tensors on the CPU in float64, or on ``--device numpy`` — and
``pivot_tpu``'s CLI path runs its numpy arms on the same trace and
cluster.  Every arm's four output files (``general.json`` with
``avg_runtime``, ``transfers.json``, ``scheduler.json``,
``host_usage.json``) must be byte-identical across the three.

Size: 30 hosts × 30 apps of the first trace in ``data/jobs`` — a few
hundred ticks per arm, inside the tier-1 per-test budget.
"""

import json
import os

import pytest
import torch

from pivot_tpu.experiments import cli as jcli
from pivot_tpu_torch.experiments import cli as pcli

ARGS = "--num-hosts 30 --seed 3 --trace-limit 1 --output-dir {out} {extra} " \
       "overall --num-apps 30"
FILES = ("general.json", "transfers.json", "scheduler.json",
         "host_usage.json")
ARMS = ("Opportunistic", "VBP", "Cost-Aware")


@pytest.fixture(autouse=True)
def _reset_port_ids():
    from pivot_tpu_torch.utils import reset_ids

    reset_ids()
    yield


def outputs(exp_dir):
    out = {}
    for arm in ARMS:
        for name in FILES:
            with open(os.path.join(exp_dir, "data", "0", arm, name),
                      "rb") as f:
                out[arm, name] = f.read()
    return out


def argv(tmp_path, sub, extra):
    return ARGS.format(out=tmp_path / sub, extra=extra).split()


@pytest.mark.parametrize("device", ["cuda", "numpy"])
def test_overall_port_matches_reference(tmp_path, device):
    ref = outputs(jcli.run_overall(jcli.parse_args(
        argv(tmp_path, "ref", "--device numpy"))))
    exp_dir, summaries = pcli.run_overall(
        pcli.parse_args(argv(tmp_path, device,
                             f"--device {device} --no-adaptive")),
        torch_device="cpu", dtype="float64",
    )
    got = outputs(exp_dir)
    for key, want in ref.items():
        assert got[key] == want, key

    assert [s["label"] for s in summaries] == list(ARMS)
    for s in summaries:
        assert s["spans"]["ff_ticks"] > 0
        if device == "numpy":
            assert "dispatch" not in s
            assert s["spans"]["fused_spans"] == 0  # no device spans
            continue
        d = s["dispatch"]
        assert d["device_ticks"] > 0 and d["twin_ticks"] == 0
        assert d["kernel_ticks"] == 0  # the kernel serves cuda f32 only
        assert d["span_kernel_ticks"] == 0
        # Pump-delivery windows were served as spans, and the files
        # above are byte-identical all the same.
        assert s["spans"]["fused_spans"] > 0
        assert s["spans"]["fused_ticks"] > s["spans"]["fused_spans"]


@pytest.mark.parametrize("extra,adaptive", [
    ("", False), ("--no-adaptive", False), ("--adaptive", True)])
def test_cli_defaults_to_the_card(tmp_path, extra, adaptive):
    """With no ``--device`` the CLI runs the cuda policies with every tick
    on the device; ``--adaptive`` is the opt-in to the host twin.  On a
    machine without a card that default raises instead of running on
    the CPU."""
    args = pcli.parse_args(argv(tmp_path, "d", extra))
    assert (args.device, args.adaptive) == ("cuda", adaptive)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            pcli.run_overall(args)


def test_overall_resume_skips_completed_runs(tmp_path):
    args = pcli.parse_args(argv(tmp_path, "r", "--device numpy"))
    exp_dir, first = pcli.run_overall(args)
    assert all(s is not None for s in first)
    args.resume = exp_dir
    _, again = pcli.run_overall(args)
    assert again == [None, None, None]


def test_overall_workers_run_in_spawned_processes(tmp_path):
    """``--workers 2``: runs execute in spawned worker processes and write
    the same metrics as the sequential grid.  ``transfers.json`` lists
    each transfer's sources in set order, which follows the process's
    string-hash seed, so it is compared as parsed sets of sources."""
    seq_dir, _ = pcli.run_overall(pcli.parse_args(
        "--num-hosts 8 --trace-limit 1 --device numpy --output-dir "
        f"{tmp_path / 'seq'} overall --num-apps 3".split()))
    par_dir, summaries = pcli.run_overall(pcli.parse_args(
        "--num-hosts 8 --trace-limit 1 --device numpy --workers 2 "
        f"--output-dir {tmp_path / 'par'} overall --num-apps 3".split()))
    assert summaries == [None, None, None]
    seq, par = outputs(seq_dir), outputs(par_dir)
    for (arm, name), want in seq.items():
        if name != "transfers.json":
            assert par[arm, name] == want, (arm, name)
            continue
        got, want = json.loads(par[arm, name]), json.loads(want)
        for rec in got + want:
            rec["from"] = sorted(map(tuple, rec["from"]))
        assert got == want, arm
