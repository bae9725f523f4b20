"""Cost attribution of the port (``pivot_tpu_torch/obs/costattr.py``)
against ``pivot_tpu/obs/costattr.py``: register-or-flag coverage of the
entry map, a row for every reference entry point, and the work model's
numbers at the reference's canonical shape (T = 32, H = 16).  The torch
rows are measured on the CPU here (dispatched ops, bytes, flops); the
hand kernel's rows are timed on the card (``chip_smoke.py`` phase 14)."""

import pytest

from pivot_tpu.infra import roofline as ref_roofline
from pivot_tpu.obs import costattr as ref_ca
from pivot_tpu_torch.obs import costattr


@pytest.fixture(scope="module")
def attribution():
    return costattr.cost_attribution(device="cpu")


def test_coverage_is_complete(attribution):
    assert costattr.coverage_problems() == []
    assert attribution["complete"] is True
    assert attribution["coverage_problems"] == []
    assert attribution["backend"] == "cpu"
    assert attribution["entries"] == len(costattr.ENTRY_POINTS)
    assert attribution["measured"] + attribution["flagged"] == len(
        attribution["rows"]) == len(costattr.ENTRY_POINTS)


def test_every_reference_entry_point_has_a_port_row(attribution):
    assert set(costattr.REFERENCE) == set(ref_ca.ENTRY_POINTS)
    rows = attribution["rows"]
    for (_path, name), port in costattr.REFERENCE.items():
        got = attribution["reference"][name]
        if port[0] == "flag":
            assert got["flagged"], name
        else:
            assert got["port"] in rows, name
    # The sharded entries wait for ROADMAP.md Queue 1 item 9.
    for (path, name), port in costattr.REFERENCE.items():
        if path == "pivot_tpu/ops/shard.py":
            assert port[0] == "flag" and "item 9" in port[1], name


def _reference_model(name):
    """The reference's (kind, steps factor) for one of its measured
    entries, from its own builder table (two-phase kinds resolve to
    "slim" on the CPU, as the reference resolves them there)."""
    key = ref_ca.ENTRY_POINTS[next(k for k in ref_ca.ENTRY_POINTS
                                   if k[1] == name)][1]
    _fn, _args, _kw, kind = ref_ca._BUILDERS[key](ref_ca._operands())
    k = 4 if key in ("fused_tick_run", "resident_span_run") else 1
    return kind or "slim", k


def test_analytic_numbers_equal_the_reference_model(attribution):
    rows = attribution["rows"]
    checked = 0
    for (_p, ref_name), port in costattr.REFERENCE.items():
        if port[0] == "flag" or port[1] not in rows or \
                ref_ca.ENTRY_POINTS[(_p, ref_name)][0] != "measure":
            continue
        kind, k = _reference_model(ref_name)
        want = ref_roofline.placement_cost(kind, 32 * k, 16, dtype_bytes=4)
        row = rows[port[1]]
        assert row["kind"] == kind, ref_name
        assert (row["analytic_flops"], row["analytic_bytes"]) == (
            want["flops"], want["bytes"]), ref_name
        checked += 1
    assert checked == 10
    # The port's own forms: the batched passes at R = 4.
    want = ref_roofline.placement_cost("slim", 32, 16, 4, dtype_bytes=4)
    assert rows["first_fit_batched"]["analytic_flops"] == want["flops"]


def test_torch_rows_are_measured(attribution):
    rows = attribution["rows"]
    for name, row in rows.items():
        if "flagged" in row:
            continue
        assert row["ops"] > 0 and row["bytes"] > 0 and row["flops"] > 0
        assert row["flops_vs_model"] > 0 and row["bytes_vs_model"] > 0
        assert "device_ms" not in row  # a CPU run has no device time
    # A span of 4 ticks dispatches more than one tick's pass.
    assert rows["fused_tick_run"]["ops"] > rows["first_fit_impl"]["ops"]
    kernel = {n: r for n, r in rows.items()
              if n.startswith("cost_aware_cuda")}
    assert sorted(kernel) == ["cost_aware_cuda", "cost_aware_cuda_batched",
                              "cost_aware_cuda_rows"]
    assert all("kernel-budget" in r["flagged"] for r in kernel.values())


def test_kernel_rows_hold_the_plain_version():
    """The card's hand-kernel row, driven through the CPU wrapper (which
    takes the plain version): launches, bytes and the hold."""
    import torch

    o = costattr._operands(32, 16, torch.device("cpu"))
    for key in ("r1", "r4", "rows"):
        wrapper, plain, args, kw, R = costattr._kernel_form(key, o)
        p, a = wrapper(*args, **kw)
        pp, pa = plain(*args, **kw)
        assert torch.equal(p, pp) and torch.equal(a, pa)
        assert p.shape[0] == (32 if key == "r1" else R)


def test_flags_unregistered_and_stale_sites(monkeypatch):
    """Register-or-flag (``tests/test_profiler.py``'s falsifier): an
    entry point missing from the manifest is a coverage problem, and a
    stale manifest entry equally."""
    trimmed = dict(costattr.ENTRY_POINTS)
    del trimmed[("pivot_tpu_torch/ops/kernels.py", "cost_aware_impl")]
    monkeypatch.setattr(costattr, "ENTRY_POINTS", trimmed)
    problems = costattr.coverage_problems()
    assert any("cost_aware_impl" in p for p in problems)
    stale = dict(costattr.ENTRY_POINTS)
    stale[("pivot_tpu_torch/ops/kernels.py", "no_such_kernel")] = (
        "flag", "gone")
    monkeypatch.setattr(costattr, "ENTRY_POINTS", stale)
    problems = costattr.coverage_problems()
    assert any("no_such_kernel" in p and "stale" in p for p in problems)
