"""The port's figures (``pivot_tpu_torch/experiments/plots.py``) against
``pivot_tpu/experiments/plots.py``: each figure function draws the same
series as the reference's on the same experiment files.  One stub
``matplotlib.pyplot`` in ``sys.modules`` records both packages' calls;
each figure is then drawn once for real.  The CLI's figures without
matplotlib (the card's machine has none) are named on stderr, and the
run's data files and exit code do not change."""

import json
import os
import pathlib
import sys
import types

import numpy as np
import pytest

from pivot_tpu.experiments import plots as ref_plots
from pivot_tpu_torch.experiments import cli
from pivot_tpu_torch.experiments import plots

ARMS = ("Opportunistic", "VBP", "Cost-Aware")


def _plain(x):
    if isinstance(x, np.ndarray):
        return [_plain(v) for v in x.tolist()]
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if isinstance(x, (int, float, str, bool)) or x is None:
        return x
    return type(x).__name__


class _Recorder(types.ModuleType):
    """``matplotlib.pyplot`` (and its axes and figures) recording every
    call with its arguments."""

    def __init__(self, log, name="matplotlib.pyplot"):
        super().__init__(name)
        self._log = log

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)

        def call(*args, **kwargs):
            self._log.append((self.__name__, attr, _plain(args),
                              {k: _plain(v) for k, v in sorted(
                                  kwargs.items())}))
            if attr == "plot":
                line = types.SimpleNamespace(get_color=lambda: "C9")
                return [line]
            if attr == "subplots":
                n = args[1] if len(args) > 1 else 1
                axes = [_Recorder(self._log, f"ax{i}") for i in range(n)]
                return _Recorder(self._log, "fig"), axes
            return None
        return call


@pytest.fixture
def recorder(monkeypatch):
    log = []
    mpl = types.ModuleType("matplotlib")
    mpl.use = lambda *a, **k: None
    mpl.pyplot = _Recorder(log)
    monkeypatch.setitem(sys.modules, "matplotlib", mpl)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", mpl.pyplot)
    return log


def _dump(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def _general(rng):
    return {"egress_cost": float(rng.uniform(0, 50)),
            "cum_instance_hours": float(rng.uniform(10, 90)),
            "avg_runtime": float(rng.uniform(100, 400))}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Experiment files of every kind a figure reads, from a seed."""
    root = tmp_path_factory.mktemp("plots")
    rng = np.random.default_rng(7)
    exp = root / "overall"
    for it in ("0", "1"):
        for arm in ARMS:
            d = exp / "data" / it / arm
            _dump(str(d / "general.json"), _general(rng))
            _dump(str(d / "transfers.json"), [
                {"propagation_delay": float(p),
                 "total_delay": float(p + q)}
                for p, q in rng.uniform(0, 5, (6, 2))] if arm != "VBP"
                or it == "0" else [])
    nap = root / "n_app"
    for n in ("10", "20", "40"):
        for it in ("0", "1"):
            for arm in ARMS:
                _dump(str(nap / "data" / n / it / arm / "general.json"),
                      _general(rng))
    ens = root / "ensemble"
    ens.mkdir()
    np.savez(str(ens / "rollout.npz"), makespan=rng.uniform(1e3, 5e3, 64))
    cap = root / "capacity"
    cands = [{"hosts": h, "makespan_mean": float(rng.uniform(1e3, 9e3)),
              "total_cost_mean": float(rng.uniform(10, 90)),
              "unfinished_max": int(h < 200)} for h in (100, 300, 600)]
    _dump(str(cap / "summary.json"), {"candidates": cands,
                                      "best": cands[1]})
    apps = root / "apps"
    _dump(str(apps / "summary.json"), {"arms": {
        p: [{"n_apps": n, "egress_mean": float(rng.uniform(0, 9)),
             "host_cost_mean": float(rng.uniform(1, 9))}
            for n in (3, 6, 10)]
        for p in ("opportunistic", "first-fit", "cost-aware")}})
    metrics = ("egress_cost", "instance_hours", "avg_runtime")
    cal = root / "calibrate"
    _dump(str(cal / "report.json"), {
        "policy": "cost-aware", "n_hosts": 40,
        "clusters": [{"des": {k: float(rng.uniform(1, 9)) for k in metrics},
                      "static": {k: float(rng.uniform(1, 9))
                                 for k in metrics},
                      "congested": {k: float(rng.uniform(1, 9))
                                    for k in metrics}} for _ in range(3)],
        "cluster_summary": {"static": {k: {"mean_rel_err": 0.1,
                                           "std_rel_err": 0.05}
                                       for k in metrics}}})
    cal2 = root / "calibrate_seeds"
    _dump(str(cal2 / "report.json"), {
        "policy": "first-fit", "n_hosts": 40,
        "des_per_seed": [{k: float(rng.uniform(1, 9)) for k in metrics}
                         for _ in range(3)],
        "static": {k: 2.0 for k in metrics},
        "realtime": {k: 3.0 for k in metrics}})
    run = root / "overall" / "data" / "0" / "VBP"
    _dump(str(run / "host_usage.json"), {
        "timestamps": [[float(t), float(t + 5)] for t in range(0, 50, 5)],
        "n_hosts": [int(x) for x in rng.integers(0, 9, 10)]})
    return root


class _Meter:
    """A meter's usage curves (``infra/meter.py::resource_usage_curve``)."""

    def resource_usage_curve(self, res):
        xs = np.linspace(0, 100, 11)
        return xs, (np.sin(xs + len(res)) + 1) / 2


def _figures(data):
    """case → (figure function, arguments)."""
    def out(d):
        return str(data / d / "fig.pdf")
    return {
        "overall": ("plot_overall", (str(data / "overall"),)),
        "transfers": ("plot_transfers", (str(data / "overall"),)),
        "financial_cost": ("plot_financial_cost", (str(data / "n_app"), 0.5)),
        "ensemble": ("plot_ensemble_distribution",
                     (str(data / "ensemble"), out("ensemble"))),
        "capacity": ("plot_capacity_frontier",
                     (str(data / "capacity"), out("capacity"))),
        "apps": ("plot_apps_cost", (str(data / "apps"), out("apps"))),
        "calibration_clusters": ("plot_calibration_spread", (
            str(data / "calibrate"), out("calibrate"))),
        "calibration_seeds": ("plot_calibration_spread", (
            str(data / "calibrate_seeds"), out("calibrate_seeds"))),
        "host_usage": ("plot_host_usage", (
            str(data / "overall/data/0/VBP"), out("overall/data/0/VBP"))),
        "resource_usage": ("plot_resource_usage", (
            _Meter(), ("cpus", "mem"), out("overall"))),
    }


CASES = sorted(_figures(pathlib.Path("/unused")))


def test_every_reference_figure_is_ported():
    assert [n for n in ref_plots.__all__] == [n for n in plots.__all__]
    assert len([n for n in plots.__all__ if n.startswith("plot_")]) == 9


@pytest.mark.parametrize("case", CASES)
def test_figure_series_equal_the_reference(recorder, data, case):
    fn, args = _figures(data)[case]
    getattr(ref_plots, fn)(*args)
    want, recorder[:] = list(recorder), []
    getattr(plots, fn)(*args)
    assert recorder == want
    assert any(call[1] in ("plot", "bar", "barh", "step")
               for call in want)


def test_each_figure_draws_for_real(data, tmp_path):
    pytest.importorskip("matplotlib")
    for case, (fn, args) in _figures(data).items():
        args = tuple(str(tmp_path / f"{case}.pdf")
                     if isinstance(a, str) and a.endswith("fig.pdf") else a
                     for a in args)
        path = getattr(plots, fn)(*args)
        assert os.path.getsize(path) > 1000, case


def test_cli_names_the_figures_it_skips_without_matplotlib(
        tmp_path, monkeypatch, capsys):
    """``overall`` on a machine without matplotlib: one stderr line
    naming both figures; the data files are written as with it."""
    import importlib.util

    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        None if name == "matplotlib" else find_spec(name, *a)))
    argv = ["--device", "numpy", "--num-hosts", "8", "--trace-limit", "1",
            "--output-dir", str(tmp_path), "overall", "--num-apps", "2"]
    cli.main(argv)
    captured = capsys.readouterr()
    skipped = [ln for ln in captured.err.splitlines()
               if ln.startswith("figures not drawn")]
    assert len(skipped) == 1
    assert "plot_overall(" in skipped[0] and "plot_transfers(" in skipped[0]
    (exp,) = os.listdir(tmp_path / "overall")
    exp_dir = tmp_path / "overall" / exp
    assert not (exp_dir / "plot").exists()
    for arm in ARMS:
        assert (exp_dir / "data" / "0" / arm / "general.json").exists()
