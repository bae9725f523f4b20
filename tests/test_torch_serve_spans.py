"""Serve spans, ragged span flushes and the resident pool of the port's
serving layer (``pivot_tpu_torch.serve``) against ``pivot_tpu``'s.

After ``tests/test_ragged.py:343-419``: the same seeded stream served
with ``fuse_spans="slo"`` — ragged span batching on, or off (the A/B
arm), or the resident pool with mid-span splices — gives the same final
placements as the per-tick, non-ragged referee and as ``pivot_tpu``'s
service under the same options (its device policies under x64 in
float64).  A served span is one decision-latency sample
(``SloMeter.record_span_decision``).  On the Cost-Aware kernel path (the
plain version of ``greedy_place`` on the CPU) a coalesced span flush is
one per-row call per span tick.  ``cli serve`` reports the reference's
keys, ``ragged`` / ``resident`` / ``splice_tier`` included.  Exact
throughout.
"""

from __future__ import annotations

import threading

import pytest
import torch

import jax.numpy as jnp

from pivot_tpu import serve as jserve
from pivot_tpu.sched import tpu as jtpu
from pivot_tpu.utils import config as jconfig
from pivot_tpu.utils import reset_ids as j_reset_ids
from pivot_tpu_torch import serve as pserve
from pivot_tpu_torch.ops import cuda_kernels as ck
from pivot_tpu_torch.sched import batch as pbatch
from pivot_tpu_torch.sched import cuda as pcuda
from pivot_tpu_torch.utils import config as pconfig
from pivot_tpu_torch.utils import reset_ids as p_reset_ids

CA = dict(name="cost-aware", bin_pack="first-fit", sort_tasks=True,
          sort_hosts=True)
#: A span-heavy stream: co-pending spans of different horizons.
HEAVY = dict(n_jobs=30, rate=25.0)


@pytest.fixture(autouse=True)
def _join_threads():
    """Every thread a test starts (either package's sessions, producer
    and batcher) has ended when the test ends: a reference thread left
    running would compile JAX programs inside a later test's window."""
    before = set(threading.enumerate())
    yield
    left = [t for t in threading.enumerate() if t not in before]
    for t in left:
        t.join(timeout=30.0)
    assert not [t.name for t in left if t.is_alive()]


@pytest.fixture
def ref_f64(monkeypatch):
    """``pivot_tpu``'s device policies in float64 (x64 is on in tests)."""
    monkeypatch.setattr(jtpu._DevicePolicyBase, "dtype", jnp.float64)


class _KernelCostAware(pcuda.CudaCostAwarePolicy):
    """The Cost-Aware policy as the auto rule serves it on a card: every
    tick and span tick through the kernel's wrapper (its plain version
    on CPU tensors)."""

    def _kernel_serves(self):
        return True


def port_policy(kernel=False):
    if kernel:
        return _KernelCostAware(bin_pack="first-fit", sort_tasks=True,
                                sort_hosts=True, device="cpu")
    return pconfig.make_policy(
        pconfig.PolicyConfig(device="cuda", adaptive=False, **CA),
        torch_device="cpu", dtype="float64")


def ref_policy():
    return jconfig.make_policy(
        jconfig.PolicyConfig(device="tpu", adaptive=False, **CA))


def serve_arm(pkg, config, reset, make_pol, fuse, n_jobs=12, rate=2.0,
              G=3, flush_after=0.05, **driver_kw):
    """``tests/test_ragged.py::_serve_arm`` for either package: sorted
    final placements, the report and the pool."""
    reset()
    pool = [
        pkg.ServeSession(
            f"s{g}",
            config.build_cluster(config.ClusterConfig(n_hosts=8, seed=0)),
            make_pol(), seed=0, fuse_spans=fuse)
        for g in range(G)
    ]
    driver = pkg.ServeDriver(pool, queue_depth=64, backpressure="shed",
                             flush_after=flush_after, **driver_kw)
    report = driver.run(pkg.poisson_arrivals(
        rate=rate, n_jobs=n_jobs, seed=7,
        make_app=pkg.synthetic_app_factory(seed=11)))
    driver.audit()
    placements = sorted(
        (app.id, task.id, task.placement)
        for s in pool for app in s._injected
        for group in app.groups for task in group.tasks)
    return placements, report, pool


def port_arm(fuse, kernel=False, **kw):
    return serve_arm(pserve, pconfig, p_reset_ids,
                     lambda: port_policy(kernel), fuse, **kw)


def span_activity(pool):
    return sum(s.summary()["span_stats"]["fused_spans"]
               + s.summary()["span_stats"]["ff_ticks"] for s in pool)


def test_ragged_serve_soak_equals_per_tick_referee():
    """The ragged ``slo`` service equals the per-tick non-ragged referee,
    fused spans, and meters one latency sample per served span."""
    got, report, pool = port_arm("slo", ragged=True)
    want, ref_report, _ = port_arm(False, ragged=False)
    assert got == want and len(got) > 0
    assert span_activity(pool) > 0
    c = report["slo"]["counters"]
    assert c["span_dispatches"] > 0
    assert c["span_ticks"] >= c["span_dispatches"]
    assert ref_report["slo"]["counters"]["span_dispatches"] == 0
    assert report["batcher"]["dispatches"] > 0
    assert report["ragged"] is True


@pytest.mark.parametrize("load", [{}, HEAVY])
@pytest.mark.parametrize("ragged", [True, False])
def test_slo_serve_equals_reference(ref_f64, ragged, load):
    got, report, _ = port_arm("slo", ragged=ragged, **load)
    want, ref_report, _ = serve_arm(jserve, jconfig, j_reset_ids, ref_policy,
                                    "slo", ragged=ragged, **load)
    assert got == want
    assert got == port_arm(False, ragged=False, **load)[0]
    for k in ("arrived", "admitted", "completed", "shed"):
        assert report["slo"]["counters"][k] == ref_report["slo"]["counters"][k]
    assert report["ragged"] is ref_report["ragged"] is ragged
    if not ragged:
        assert report["batcher"]["ragged_merges"] == 0
        assert report["batcher"]["ragged_rows"] == 0


def test_kernel_served_span_flushes_use_the_per_row_form(monkeypatch):
    """On the kernel path a coalesced span flush runs one per-row call a
    span tick, a lone span the R = 1 call, and the service equals the
    per-tick referee on the same kernel arithmetic."""
    rows_calls, in_span = [], []
    orig, driver = ck.cost_aware_cuda_rows, pbatch.fused_tick_run_rows

    def counting(*a, **k):
        if in_span:
            rows_calls.append(a[0].shape[0])
        return orig(*a, **k)

    def span_driver(*a, **k):
        in_span.append(True)
        try:
            return driver(*a, **k)
        finally:
            in_span.pop()

    monkeypatch.setattr(ck, "cost_aware_cuda_rows", counting)
    monkeypatch.setattr(pbatch, "fused_tick_run_rows", span_driver)
    # Quiescence-only flushes of a span-heavy stream: co-pending spans.
    got, report, pool = port_arm("slo", kernel=True, flush_after=None,
                                 **HEAVY)
    span_rows = list(rows_calls)
    want, _, _ = port_arm(False, kernel=True, ragged=False, **HEAVY)
    assert got == want
    assert span_activity(pool) > 0
    assert sum(s.policy.dispatch_stats()["span_kernel_ticks"]
               for s in pool) > 0
    assert span_rows and all(g >= 2 for g in span_rows)
    assert ck.LAUNCHES["greedy_place"] == 0  # CPU: no launch counted


@pytest.mark.parametrize("load", [{}, HEAVY])
@pytest.mark.parametrize("splice_tier", [0, 1])
def test_resident_pool_equals_referee_and_reference(ref_f64, splice_tier,
                                                    load):
    got, report, pool = port_arm("slo", resident=True,
                                 splice_tier=splice_tier, **load)
    want, _, _ = port_arm(False, ragged=False, **load)
    assert got == want
    assert report["batcher"] is None
    assert report["resident"] is True
    assert report["splice_tier"] == splice_tier
    stats = [s.policy.dispatch_stats()["resident"] for s in pool]
    assert sum(r["spans"] for r in stats) > 0
    ref, ref_report, _ = serve_arm(jserve, jconfig, j_reset_ids, ref_policy,
                                   "slo", resident=True,
                                   splice_tier=splice_tier, **load)
    assert got == ref
    assert ref_report["resident"] is True


def test_cli_serve_span_reports_have_reference_keys(tmp_path):
    from pivot_tpu.experiments import cli as jcli
    from pivot_tpu_torch.experiments import cli as pcli

    def argv(out, device, extra):
        return ["--num-hosts", "12", "--seed", "3", "--device", device,
                "--output-dir", str(out), "serve", "--sessions", "3",
                "--jobs", "12", "--arrival-rate", "2", "--fuse-spans",
                "slo", *extra]

    for extra in ((), ("--no-ragged",), ("--resident", "--splice-tier",
                                         "1")):
        p_reset_ids()
        report = pcli.run_serve_stream(
            pcli.parse_args(argv(tmp_path / "p", "cuda", extra)),
            torch_device="cpu", dtype="float64")
        j_reset_ids()
        ref = jcli.run_serve_stream(
            jcli.parse_args(argv(tmp_path / "j", "numpy", extra)))
        assert set(report) == set(ref)
        assert set(report["slo"]) == set(ref["slo"])
        if report["batcher"] is not None:
            assert set(report["batcher"]) >= {
                "ragged_merges", "ragged_rows", "ragged_pad_cells"}
        for k in ("ragged", "resident", "splice_tier"):
            assert report[k] == ref[k], k
        assert report["slo"]["counters"]["completed"] == 12
        assert report["slo"]["counters"]["span_dispatches"] > 0


def test_slo_spans_on_a_missing_card_raise(monkeypatch):
    """No fallback hides the card: the span and resident flags with the
    default ``--device cuda`` build card policies, which raise without
    one."""
    from pivot_tpu_torch.experiments import cli as pcli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in (["--fuse-spans", "slo"], ["--resident"]):
        args = pcli.parse_args(["serve", "--jobs", "2", *extra])
        with pytest.raises(RuntimeError, match="cuda"):
            pcli.run_serve_stream(args)
