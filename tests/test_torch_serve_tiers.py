"""Multi-tenant serving in the port (``pivot_tpu_torch.serve``): tier
reservations, per-tier policies, in-queue preemption, least-loaded
routing, the autoscaler's grow and drain, the crash-during-drain and
preempt-onto-retiring-slot races, and a mixed-tier chaos soak.

The port's sessions run its device policies with torch tensors on the
CPU in float64, so every case also runs the dispatch batcher.  Where the
outcome is deterministic (no wall-clock race decides it) it must equal
``pivot_tpu``'s on the same arrivals (its numpy policy; each package's
``reset_ids()`` first), and ``audit_serve`` must hold after every drain.
"""

import time as _time

import numpy as np
import pytest

from pivot_tpu import serve as jserve
from pivot_tpu.utils import config as jconfig
from pivot_tpu.utils import reset_ids as j_reset_ids
from pivot_tpu_torch import serve as pserve
from pivot_tpu_torch.infra.audit import audit_serve
from pivot_tpu_torch.utils import config as pconfig
from pivot_tpu_torch.utils import reset_ids as p_reset_ids

SIDES = {
    "port": (pserve, pconfig, p_reset_ids),
    "ref": (jserve, jconfig, j_reset_ids),
}


def make_policy(side):
    _pkg, config, _reset = SIDES[side]
    arm = dict(name="cost-aware", sort_tasks=True, sort_hosts=True)
    if side == "port":
        return config.make_policy(
            config.PolicyConfig(device="cuda", adaptive=False,
                                bin_pack="first-fit", **arm),
            torch_device="cpu", dtype="float64")
    return config.make_policy(config.PolicyConfig(device="numpy", **arm))


def session(side, label, n_hosts=8, decision_sleep=0.0, **kw):
    pkg, config, _reset = SIDES[side]
    policy = make_policy(side)
    if decision_sleep:
        orig = policy.place

        def slow(ctx):
            _time.sleep(decision_sleep)
            return orig(ctx)

        policy.place = slow
    return pkg.ServeSession(
        label, config.build_cluster(config.ClusterConfig(n_hosts=n_hosts,
                                                         seed=0)),
        policy, seed=0, **kw)


def sessions(side, n, **kw):
    return [session(side, f"s{g}", **kw) for g in range(n)]


def tier_counters(report):
    return {t: {k: v for k, v in s["counters"].items()}
            for t, s in report["slo"]["tiers"].items()}


def run_both(case):
    """Run ``case(side)`` on both packages; returns the two reports."""
    out = {}
    for side in ("port", "ref"):
        SIDES[side][2]()
        out[side] = case(side)
    return out["port"], out["ref"]


def test_tier_reservations_shed_low_tiers_first():
    def case(side):
        pkg = SIDES[side][0]
        driver = pkg.ServeDriver(sessions(side, 1), queue_depth=4,
                                 backpressure="shed", tier_reserve=(0, 2))
        make_app = pkg.synthetic_app_factory(seed=5, runtime=(300.0, 400.0))
        arrs, t = [], 0.0
        for tier in (1, 1, 0, 1, 0, 1, 1, 1):
            t += 0.1
            arrs.append(pkg.JobArrival(t, make_app(), tier=tier))
        report = driver.run(iter(arrs))
        driver.audit()
        return report

    port, ref = run_both(case)
    tiers = port["slo"]["tiers"]
    assert tiers["0"]["counters"]["shed"] == 0
    assert tiers["1"]["counters"]["shed"] > 0
    assert tier_counters(port) == tier_counters(ref)
    assert port["batcher"]["dispatches"] > 0


def test_tier_policies_spill_high_shed_low_preserving_order():
    order = {}

    def case(side):
        pkg = SIDES[side][0]
        driver = pkg.ServeDriver(sessions(side, 1), queue_depth=2,
                                 backpressure="shed",
                                 tier_policies=("spill", "shed"))
        done = order.setdefault(side, [])
        driver.add_completion_hook(lambda _s, app, _n: done.append(app.id))
        make_app = pkg.synthetic_app_factory(seed=3, runtime=(150.0, 250.0))
        arrs, t = [], 0.0
        for i in range(10):
            t += 0.2
            arrs.append(pkg.JobArrival(t, make_app(), tier=i % 2))
        report = driver.run(iter(arrs))
        t0_ids = [a.app.id for a in arrs if a.tier == 0]
        assert [i for i in done if i in set(t0_ids)] == t0_ids
        driver.audit()
        return report

    port, ref = run_both(case)
    tiers = port["slo"]["tiers"]
    assert tiers["0"]["counters"]["shed"] == 0
    assert tiers["0"]["counters"]["spilled"] > 0
    assert tiers["1"]["counters"]["shed"] > 0
    assert tier_counters(port) == tier_counters(ref)
    assert order["port"] == order["ref"]


def test_admission_queue_spill_buffer_is_tier_then_arrival_ordered():
    q = pserve.AdmissionQueue(2, "spill")
    arrs = [pserve.JobArrival(ts, None, tier=tier)
            for ts, tier in ((1.0, 2), (2.0, 0), (3.0, 2), (4.0, 1))]
    for arr in arrs:
        q.spill(arr)
    victim = pserve.JobArrival(0.5, None, tier=2)
    q.spill(victim, count=False)
    a, b, c, d = arrs
    assert [q.pop_spill() for _ in range(5)] == [b, d, victim, a, c]
    assert not q.spilled


def test_high_tier_arrival_preempts_unplaced_low_tier():
    def case(side):
        pkg = SIDES[side][0]
        driver = pkg.ServeDriver(sessions(side, 1), queue_depth=2,
                                 backpressure="shed",
                                 tier_policies=("block", "shed"),
                                 preempt=True)
        make_app = pkg.synthetic_app_factory(seed=9, runtime=(5.0, 15.0))
        arrs = [pkg.JobArrival(50.0, make_app(), tier=1),
                pkg.JobArrival(51.0, make_app(), tier=1),
                pkg.JobArrival(1.4, make_app(), tier=0)]
        report = driver.run(iter(arrs))
        driver.audit()
        return report

    port, ref = run_both(case)
    c = port["slo"]["counters"]
    assert c["preempted"] == c["preempt_requeued"] == 1
    assert c["shed"] == 0 and c["completed"] == 3
    assert port["slo"]["tiers"]["1"]["counters"]["admitted"] == 3
    for key in ("preempted", "preempt_requeued", "completed", "admitted",
                "shed"):
        assert c[key] == ref["slo"]["counters"][key], key
    assert tier_counters(port) == tier_counters(ref)


def test_preempt_miss_on_placed_job_falls_back():
    p_reset_ids()
    driver = pserve.ServeDriver(sessions("port", 1), queue_depth=1,
                                backpressure="shed",
                                tier_policies=("shed", "shed"),
                                preempt=True, preempt_timeout=0.3)
    make_app = pserve.synthetic_app_factory(seed=7, runtime=(30.0, 40.0))
    victim_app = make_app()

    def arrivals():
        yield pserve.JobArrival(1.0, victim_app, tier=1)
        yield pserve.JobArrival(39.0, make_app(), tier=1)
        deadline = _time.time() + 10.0
        while _time.time() < deadline and all(
                t.is_nascent for g in victim_app.groups for t in g.tasks):
            _time.sleep(0.005)
        yield pserve.JobArrival(40.0, make_app(), tier=0)

    report = driver.run(arrivals())
    c = report["slo"]["counters"]
    assert c["preempted"] == 0 and c["preempt_misses"] >= 1
    tiers = report["slo"]["tiers"]
    assert tiers["0"]["counters"]["shed"] == 1
    assert tiers["1"]["counters"]["shed"] == 1
    assert tiers["1"]["counters"]["completed"] == 1
    driver.audit()


def test_least_loaded_routing_balances_by_inbox_depth():
    p_reset_ids()
    driver = pserve.ServeDriver(sessions("port", 3), queue_depth=32,
                                backpressure="shed", routing="least_loaded")
    make_app = pserve.synthetic_app_factory(seed=2, runtime=(5.0, 20.0))
    report = driver.run(pserve.poisson_arrivals(
        rate=0.3, n_jobs=9, seed=6, make_app=make_app))
    assert report["routing"] == "least_loaded"
    served = [s.summary()["n_apps"] for s in driver.sessions]
    assert sum(served) == 9 and max(served) - min(served) <= 3
    driver.audit()


def test_autoscaler_grows_pool_on_slo_breach():
    p_reset_ids()
    driver = pserve.ServeDriver(
        [session("port", "s0", decision_sleep=0.03)], queue_depth=16,
        backpressure="shed",
        session_factory=lambda label: session("port", label,
                                              decision_sleep=0.03),
        autoscale=pserve.AutoscaleConfig(
            g_min=1, g_max=3, slo_p99_s=0.005, check_interval_s=0.03,
            breach_checks=2, calm_checks=50, cooldown_s=0.05))
    make_app = pserve.synthetic_app_factory(seed=4, runtime=(5.0, 15.0))
    report = driver.run(pserve.poisson_arrivals(
        rate=0.4, n_jobs=14, seed=8, make_app=make_app))
    c = report["slo"]["counters"]
    assert c["completed"] == 14 and c["shed"] == 0
    assert c["scale_up_events"] >= 1 and report["pool"]["final"] > 1
    assert any(e["action"] == "grow"
               for e in report["autoscaler"]["events"])
    # Grown sessions joined the batcher on fresh slots.
    assert report["batcher"]["respawns"] == report["pool"]["grown"] >= 1
    driver.audit()


def test_autoscaler_drains_and_retires_on_calm():
    p_reset_ids()
    driver = pserve.ServeDriver(
        sessions("port", 3), queue_depth=16, backpressure="shed",
        autoscale=pserve.AutoscaleConfig(
            g_min=1, g_max=3, slo_p99_s=0.5, check_interval_s=0.02,
            breach_checks=50, calm_checks=2, shrink_factor=0.9,
            cooldown_s=0.02))
    make_app = pserve.synthetic_app_factory(seed=4, runtime=(5.0, 10.0))
    report = driver.run(pserve.poisson_arrivals(
        rate=0.5, n_jobs=10, seed=3, make_app=make_app), pace=30.0)
    c = report["slo"]["counters"]
    assert c["completed"] == 10 and c["shed"] == 0
    assert c["scale_down_events"] >= 1
    assert report["pool"]["retired"] >= 1 and report["pool"]["final"] < 3
    assert report["batcher"]["retired_slots"] >= report["pool"]["retired"]
    driver.audit()


def test_session_crash_during_scale_down_drain_settles_once():
    p_reset_ids()
    ss = sessions("port", 2)
    orig = ss[1].policy.place

    def crash_when_retiring(ctx):
        if ss[1].retiring:
            raise RuntimeError("injected crash during retire drain")
        return orig(ctx)

    ss[1].policy.place = crash_when_retiring
    driver = pserve.ServeDriver(ss, queue_depth=8, backpressure="shed")
    make_app = pserve.synthetic_app_factory(seed=6, runtime=(10.0, 20.0))

    def arrivals():
        yield pserve.JobArrival(1.0, make_app())
        yield pserve.JobArrival(1.2, make_app())
        ss[1].retiring = True
        yield pserve.JobArrival(2.0, make_app())

    report = driver.run(arrivals())
    c = report["slo"]["counters"]
    assert c["completed"] == 3 and c["requeued"] >= 1
    assert report["restarts"] == 0
    assert ss[1]._retired and ss[1].abandoned
    assert report["pool"] == {"final": 1, "grown": 0, "retired": 0,
                              "abandoned": 1}
    assert driver.finish_drained_retires() == 0
    driver.audit()


def test_preempt_victim_requeued_onto_retiring_slot_settles_once():
    p_reset_ids()
    ss = sessions("port", 2)
    driver = pserve.ServeDriver(ss, queue_depth=2, backpressure="shed",
                                tier_policies=("block", "shed"),
                                preempt=True)
    make_app = pserve.synthetic_app_factory(seed=9, runtime=(5.0, 15.0))
    victim_app = make_app()
    seen = {"target": None, "offers": 0}
    for s in ss:
        def hooked(arrival, _s=s, _orig=s.offer):
            if arrival.app is victim_app:
                seen["offers"] += 1
                if seen["offers"] == 2:
                    _s.retiring = True
                    seen["target"] = _s
            return _orig(arrival)

        s.offer = hooked

    def arrivals():
        yield pserve.JobArrival(50.0, make_app(), tier=1)
        yield pserve.JobArrival(51.0, victim_app, tier=1)
        yield pserve.JobArrival(1.4, make_app(), tier=0)

    report = driver.run(arrivals())
    assert seen["target"] is not None
    c = report["slo"]["counters"]
    assert c["preempted"] == 1 and c["preempt_requeued"] == 1
    assert c["completed"] == 3
    driver.finish_drained_retires()
    assert driver.finish_drained_retires() == 0
    assert seen["target"]._retired
    driver.audit()


def test_arrival_validation_is_eager(tmp_path):
    with pytest.raises(ValueError, match="rate must be positive"):
        pserve.poisson_arrivals(0.0, 5)
    with pytest.raises(ValueError, match="weights"):
        pserve.mixed_tier_arrivals(1.0, 5, (0.0, 0.0))
    with pytest.raises(ValueError, match="rate must be positive"):
        pserve.trace_arrivals("data/jobs/jobs-5000-200-172800-259200.npz",
                              n_apps=4, rate=0.0)


def test_mixed_tier_chaos_soak_degrade_never_fail():
    """The reference's soak on the port: a seeded chaos schedule on every
    session's cluster, a mixed-tier stream at 2.5 jobs/s into a queue too
    small for it.  Tier 0 is never shed, preempted or dead-lettered;
    tiers 1-2 absorb the pressure; ``audit_serve`` holds."""
    from pivot_tpu_torch.infra.faults import ChaosSchedule, FaultInjector
    from pivot_tpu_torch.sched import HostCircuitBreaker, RetryPolicy

    p_reset_ids()
    retry = RetryPolicy(max_retries=12, base=0.5, seed=7,
                        tier_max_retries=(None, 12, 6))

    def make_sess(label):
        return session("port", label, n_hosts=10, retry=retry,
                       breaker=HostCircuitBreaker(k=3, cooldown=30.0))

    ss = [make_sess(f"soak{g}") for g in range(3)]
    injectors = [
        FaultInjector(s.cluster, seed=0).apply_schedule(
            ChaosSchedule.generate(
                s.cluster, seed=13 + i, horizon=50.0, n_domain_outages=1,
                domain_level="zone", outage_duration=20.0, n_preemptions=2,
                preempt_lead=5.0, preempt_outage=25.0, n_stragglers=2,
                straggler_factor=3.0, straggler_duration=15.0))
        for i, s in enumerate(ss)
    ]
    driver = pserve.ServeDriver(
        ss, queue_depth=10, backpressure="shed", tier_reserve=(0, 2, 4),
        tier_policies=("spill", "shed", "shed"), routing="least_loaded",
        preempt=True, session_factory=make_sess, max_restarts=2,
        autoscale=pserve.AutoscaleConfig(
            g_min=2, g_max=5, slo_p99_s=0.5, check_interval_s=0.05,
            calm_checks=8))
    report = driver.run(pserve.mixed_tier_arrivals(
        2.5, 60, weights=(0.25, 0.35, 0.40), seed=7,
        make_app=pserve.synthetic_app_factory(seed=11,
                                              runtime=(5.0, 30.0))))
    assert any(inj.log for inj in injectors)
    tiers = report["slo"]["tiers"]
    c0 = tiers["0"]["counters"]
    absorbed = sum(tiers[t]["counters"]["shed"]
                   + tiers[t]["counters"]["preempted"]
                   for t in tiers if t != "0")
    assert absorbed > 0
    assert c0["shed"] == c0["preempted"] == c0["failed_jobs"] == 0
    assert c0["completed"] == c0["admitted"] > 0
    assert report["batcher"]["coalesced"] > 0
    assert np.isfinite(tiers["0"]["decision_latency_s"]["p99"])
    assert audit_serve(driver) == []
