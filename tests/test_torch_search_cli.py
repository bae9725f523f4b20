"""The port's ``search`` subcommand (``pivot_tpu_torch/experiments/
cli.py``) against ``pivot_tpu``'s:

  * the subcommand's parser: the same flags, destinations, defaults,
    types and choices as ``pivot_tpu``'s;
  * ``run_search_cli`` on the CPU in float64 at ``data/search/
    ci_seed.json``: the printed report and the ``--out`` file equal
    ``pivot_tpu``'s ``run_search_cli`` output with its environments in
    float64 (floats within rtol 1e-12, everything else exactly);
  * the entry's guards: without a card it raises before it writes
    anything, float64 off the CPU raises, TF32 matmuls are off after it,
    and ``--backend sharded_rollout`` gives the ``rollout`` backend's
    report (a mesh over several distinct devices names ROADMAP.md Queue 1,
    several cards).
"""

from __future__ import annotations

import functools
import json
import os

import pytest
import torch

import jax.numpy as jnp

from pivot_tpu.experiments import cli as jcli
from pivot_tpu.search import fitness as JF
from pivot_tpu_torch.experiments import cli as pcli

from tests.test_torch_search import CI_SEED, assert_close_tree


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _search_actions(parser):
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     tuple(a.choices) if a.choices else None,
                     a.__class__.__name__, a.nargs, a.required)
            for a in sub.choices["search"]._actions}


def test_parser_matches_pivot_tpu(monkeypatch):
    """Both CLIs build their parser inside ``parse_args``: capture it."""
    import argparse

    built = []
    real = argparse.ArgumentParser.parse_args

    def capture(self, *a, **k):
        built.append(self)
        return real(self, *a, **k)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    jargs = jcli.parse_args(["search"])
    pargs = pcli.parse_args(["search"])
    jp, pp = built[0], built[-1]
    assert _search_actions(pp) == _search_actions(jp)
    keys = set(_search_actions(jp)) - {"help"}
    assert {k: getattr(pargs, k) for k in keys} == \
        {k: getattr(jargs, k) for k in keys}
    assert pargs.seed == jargs.seed == 5
    argv = ["search", "--method", "es", "--popsize", "7", "--bad-init",
            "--no-oracle", "--des-validate", "--backend", "sharded_rollout",
            "--config", CI_SEED, "--out", "x.json"]
    assert {k: getattr(pcli.parse_args(argv), k) for k in keys} == \
        {k: getattr(jcli.parse_args(argv), k) for k in keys}


def test_search_cli_matches_pivot_tpu_at_ci_seed(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.setattr(JF, "make_search_env", functools.partial(
        JF.make_search_env, dtype=jnp.float64))
    jout, pout = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    jcli.run_search_cli(jcli.parse_args(
        ["search", "--config", CI_SEED, "--out", jout]))
    jprinted = capsys.readouterr().out
    report = pcli.run_search_cli(pcli.parse_args(
        ["search", "--config", CI_SEED, "--out", pout]),
        torch_device="cpu", dtype="float64")
    pprinted = capsys.readouterr().out
    with open(jout) as f:
        want = json.load(f)
    with open(pout) as f:
        got = json.load(f)
    assert json.loads(pprinted) == got == json.loads(json.dumps(report))
    assert json.loads(jprinted) == want
    assert_close_tree(got, want)
    assert got["config"] == want["config"]
    assert got["beats_bad_init"] and got["config"]["bad_init"]


def test_search_cli_raises_without_a_card_and_writes_nothing(tmp_path):
    out = tmp_path / "report.json"
    args = pcli.parse_args(["search", "--config", CI_SEED, "--out",
                            str(out)])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default entry runs on it")
    with pytest.raises(RuntimeError, match="cuda"):
        pcli.run_search_cli(args)
    assert not out.exists()
    # Float64 is the CPU parity path: refused off the CPU before any
    # work (``meta`` stands in for the card).
    with pytest.raises(ValueError, match="CPU parity path"):
        pcli.run_search_cli(args, torch_device="meta", dtype="float64")
    assert not out.exists()


def test_search_cli_turns_tf32_off(tmp_path, capsys):
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        pcli.run_search_cli(pcli.parse_args(
            ["search", "--generations", "1", "--popsize", "3",
             "--replicas", "2", "--hosts", "6", "--num-apps", "2",
             "--horizon", "200", "--holdout", "0", "--no-oracle"]),
            torch_device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert json.loads(capsys.readouterr().out)["config"]["holdout"] == 0


def test_search_cli_sharded_backend_points_to_roadmap(tmp_path,
                                                     monkeypatch):
    """The sharded backend runs over a mesh of the CPU (one shard) and
    reports what the rollout backend reports; a mesh over several
    distinct devices raises naming its ROADMAP.md item."""
    argv = ["search", "--generations", "1", "--popsize", "3", "--replicas",
            "2", "--hosts", "6", "--num-apps", "2", "--holdout", "0",
            "--no-oracle"]
    reports = {}
    for backend in ("rollout", "sharded_rollout"):
        out = tmp_path / f"{backend}.json"
        reports[backend] = pcli.run_search_cli(pcli.parse_args(
            argv + ["--backend", backend, "--out", str(out)]),
            torch_device="cpu", dtype="float64")
        assert json.loads(out.read_text()) == reports[backend]
    for backend, report in reports.items():
        for section in ("config", "search"):
            assert report[section].pop("backend") == backend
    assert reports["sharded_rollout"] == reports["rollout"]
    monkeypatch.setattr(pcli, "_replica_devices", lambda device: [
        torch.device("cpu"), torch.device("meta")])
    out = tmp_path / "r.json"
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP\.md Queue 1, several cards"):
        pcli.run_search_cli(pcli.parse_args(
            argv + ["--backend", "sharded_rollout", "--out", str(out)]),
            torch_device="cpu", dtype="float64")
    assert not out.exists()


def test_main_dispatches_search(monkeypatch):
    seen = []
    monkeypatch.setattr(pcli, "run_search_cli", seen.append)
    pcli.main(["search", "--seed", "9"])
    assert len(seen) == 1 and seen[0].seed == 9
    assert os.path.basename(pcli.__file__) == "cli.py"
