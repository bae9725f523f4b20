"""The port's spot-survival harness (``pivot_tpu_torch/experiments/
spot.py``) and ``python -m pivot_tpu_torch.tools.market_replay`` against
``pivot_tpu``'s:

  * ``spot_market`` equal, and ``run_spot_arm``'s report JSON-equal to
    ``pivot_tpu``'s for the hazard-blind arm, the risk-aware + proactive
    arm and a ``weights=`` arm (a learned-looking vector);
  * ``tests/test_market.py``'s spot-survival cases on the port: the
    acceptance (risk-aware + proactive beats blind, clean audits) and
    replay determinism through the JSON round trip;
  * the market-replay CLI: ``generate``, ``run`` and ``diff`` write the
    same files as ``tools/market_replay.py`` and exit with its codes
    (a corrupted report or market diffs non-zero); ``python -m`` runs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from pivot_tpu.experiments import spot as jspot
from pivot_tpu_torch.experiments.spot import run_spot_arm, spot_market
from pivot_tpu_torch.infra.market import MarketSchedule
from pivot_tpu_torch.search.weights import PolicyWeights
from pivot_tpu_torch.tools import market_replay

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARMS = {
    "blind": {},
    "aware": dict(risk_weight=1.0, rework_cost=50.0, proactive=True),
    "weights": dict(weights=PolicyWeights(0.5, 2.0, 1.5, 5.0, 1.0),
                    proactive=True),
}


def _dump(report) -> str:
    return json.dumps(report, sort_keys=True, default=float)


@pytest.fixture(scope="module")
def markets():
    return spot_market(12, seed=3), jspot.spot_market(12, seed=3)


def test_spot_market_matches(markets):
    got, want = markets
    assert got.to_dict() == want.to_dict()
    assert spot_market(8, seed=5, horizon=300.0, n_segments=4).to_dict() \
        == jspot.spot_market(8, seed=5, horizon=300.0,
                             n_segments=4).to_dict()


@pytest.mark.parametrize("arm", list(ARMS))
def test_run_spot_arm_matches_pivot_tpu(markets, arm):
    from pivot_tpu.infra.market import MarketSchedule as JMarket
    from pivot_tpu.search.weights import PolicyWeights as JWeights

    got_m, want_m = markets
    kw = dict(ARMS[arm])
    jkw = dict(kw)
    if "weights" in jkw:
        jkw["weights"] = JWeights(*jkw["weights"])
    got = run_spot_arm(got_m, n_hosts=12, seed=3, n_apps=6, **kw)
    want = jspot.run_spot_arm(JMarket.from_dict(want_m.to_dict()),
                              n_hosts=12, seed=3, n_apps=6, **jkw)
    assert _dump(got) == _dump(want)
    assert got["n_preemptions"] > 0
    assert got["audit_violations"] == []


def test_spot_survival_acceptance_quick(markets):
    """Under the identical market and hazard-drawn plan, risk-aware +
    proactive has strictly lower cost per completed task and dead-letter
    rate than the blind arm, every audit clean in both."""
    market = markets[0]
    kw = dict(n_hosts=12, seed=3, n_apps=10)
    blind = run_spot_arm(market, **kw)
    aware = run_spot_arm(market, risk_weight=1.0, rework_cost=50.0,
                         proactive=True, **kw)
    assert blind["audit_violations"] == [] == aware["audit_violations"]
    assert blind["n_preemptions"] == aware["n_preemptions"] > 0
    assert blind["rework_seconds"] > aware["rework_seconds"]
    assert aware["cost_per_completed_task"] < \
        blind["cost_per_completed_task"]
    assert aware["dead_letter_rate"] < blind["dead_letter_rate"]
    assert aware["n_proactive_restarts"] + aware["n_migrated"] > 0


def test_spot_survival_replay_deterministic(markets, tmp_path):
    market = markets[0]
    path = tmp_path / "market.json"
    market.save(str(path))
    loaded = MarketSchedule.load(str(path))
    assert loaded == market
    kw = dict(n_hosts=12, seed=3, n_apps=6)
    assert _dump(run_spot_arm(market, **kw)) == \
        _dump(run_spot_arm(loaded, **kw))


def _reference_cli(argv) -> int:
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import market_replay as ref
    finally:
        sys.path.pop(0)
    return ref.main(argv)


def test_market_replay_files_match_reference(tmp_path):
    d = str(tmp_path)
    gen = ["generate", "--seed", "3", "--hosts", "12", "--horizon", "500",
           "--segments", "5"]
    assert market_replay.main(gen + ["--out", f"{d}/m.json"]) == 0
    assert _reference_cli(gen + ["--out", f"{d}/m_ref.json"]) == 0
    with open(f"{d}/m.json", "rb") as a, open(f"{d}/m_ref.json", "rb") as b:
        assert a.read() == b.read()
    run = ["run", "--market", f"{d}/m.json", "--hosts", "12", "--seed", "3",
           "--apps", "4", "--risk-weight", "1.0", "--rework-cost", "50",
           "--proactive"]
    assert market_replay.main(run + ["--out", f"{d}/a.json"]) == 0
    assert _reference_cli(run + ["--out", f"{d}/a_ref.json"]) == 0
    with open(f"{d}/a.json", "rb") as a, open(f"{d}/a_ref.json", "rb") as b:
        assert a.read() == b.read()
    assert market_replay.main(["diff", f"{d}/a.json", f"{d}/a_ref.json"]) \
        == 0


def test_market_replay_cli_roundtrip(tmp_path):
    mpath = str(tmp_path / "m.json")
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    assert market_replay.main(
        ["generate", "--seed", "3", "--hosts", "12", "--out", mpath]) == 0
    run = ["run", "--market", mpath, "--hosts", "12", "--seed", "3",
           "--apps", "4"]
    assert market_replay.main(run + ["--out", a]) == 0
    assert market_replay.main(run + ["--out", b]) == 0
    assert market_replay.main(["diff", a, b]) == 0
    with open(b) as f:
        rep = json.load(f)
    if rep["fault_log"]:
        rep["fault_log"][0][0] += 1.0
    else:
        rep["n_completed_tasks"] += 1
    with open(b, "w") as f:
        json.dump(rep, f)
    assert market_replay.main(["diff", a, b]) == 1
    m2 = str(tmp_path / "m2.json")
    with open(mpath) as f:
        md = json.load(f)
    md["price"][0][0] *= 2.0
    with open(m2, "w") as f:
        json.dump(md, f)
    assert market_replay.main(["diff", mpath, m2]) == 1
    assert market_replay.main(["diff", mpath, mpath]) == 0


def test_market_replay_runs_as_a_module(tmp_path):
    out = str(tmp_path / "m.json")
    proc = subprocess.run(
        [sys.executable, "-m", "pivot_tpu_torch.tools.market_replay",
         "generate", "--seed", "1", "--hosts", "8", "--out", out],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "segments" in proc.stdout
    assert MarketSchedule.load(out) == spot_market(8, seed=1)
