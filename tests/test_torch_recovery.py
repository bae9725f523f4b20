"""The crash-safe recovery plane in the port (``pivot_tpu_torch.recover``)
against ``pivot_tpu``'s (``tests/test_recovery.py``), on the CPU in
float64.

  * **parity** — the same records give a journal file byte-identical to
    ``pivot_tpu``'s (a resume over a torn tail too); ``fingerprint_arrays``
    gives the same digests; the kernel-level kill-and-resume chain of the
    port's ``resident_span_run`` equals the uninterrupted chain and
    ``pivot_tpu``'s under x64, placements and carry; a recovery-armed
    resident soak places as ``pivot_tpu``'s armed soak does;
  * **the reference's cases** on the port: the journal (tags, torn tails,
    resume, replay prefix), the snapshot store (fingerprint round trip,
    double buffer), the watchdog (bisection quarantine, failing rows,
    timeouts, the retry gate, the penalty box), a timeout during a
    pending splice leaving no partial state (through the port's seam
    ``_resident_dispatch``), the config checks, the driver's journal, and
    the kill-and-resume referee: a resident chaos + market soak killed
    after its first snapshot and resumed from journal + snapshot serves
    bit-identically to the uninterrupted run, whose placements and
    counters equal ``recovery=None``'s;
  * **the port's own seams** — one device→host copy a snapshot
    (``host_arrays``), the session hooks' order (the ``span`` record
    before the dispatch, the snapshot tap after it, the watchdog guard
    on its own thread), and a driver-level wedged resident dispatch:
    the armed watchdog times it out, retries it, and the service equals
    the no-fault run.

``pivot_tpu``'s zero-recompile pin has no counterpart: torch compiles
nothing.  Every thread a test starts ends with it.
"""

from __future__ import annotations

import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pivot_tpu.ops import tickloop as jtick
from pivot_tpu.recover import Journal as JJournal
from pivot_tpu.recover import fingerprint_arrays as j_fingerprint
from pivot_tpu.sched import tpu as jtpu
from pivot_tpu_torch.infra.faults import FaultInjector
from pivot_tpu_torch.infra.market import MarketSchedule
from pivot_tpu_torch.obs.registry import MetricsRegistry
from pivot_tpu_torch.ops.tickloop import (
    resident_carry_export,
    resident_carry_init,
    resident_carry_restore,
    resident_span_run,
)
from pivot_tpu_torch.recover import (
    DispatchFailed,
    DispatchTimeout,
    DispatchWatchdog,
    Journal,
    JournalError,
    PenaltyBox,
    RecoveryConfig,
    RecoveryPlane,
    SnapshotStore,
    fingerprint_arrays,
    replay_prefix_check,
)
from pivot_tpu_torch.recover.snapshot import host_arrays
from pivot_tpu_torch.sched.retry import RetryGate, RetryPolicy
from pivot_tpu_torch.serve import (
    JobArrival,
    ServeDriver,
    ServeSession,
    mixed_tier_arrivals,
    poisson_arrivals,
    synthetic_app_factory,
)
from pivot_tpu_torch.utils import reset_ids
from pivot_tpu_torch.utils.config import (
    ClusterConfig,
    PolicyConfig,
    build_cluster,
    make_policy,
)
from pivot_tpu_torch.workload import Application, TaskGroup

from tests import test_recovery as jrec


@pytest.fixture(autouse=True)
def _join_threads():
    """Every thread a test starts (sessions, producer, snapshot worker,
    watchdog workers) has ended when the test ends."""
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


def _device_policy():
    return make_policy(
        PolicyConfig(name="cost-aware", device="cuda", bin_pack="first-fit",
                     sort_tasks=True, sort_hosts=True, adaptive=False),
        torch_device="cpu", dtype="float64")


# -- journal --------------------------------------------------------------------


def test_journal_roundtrip_tags_and_torn_tail(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    j = Journal(path, seed=42, fsync_every=2)
    j.append("admit", ts=0.5, tier=1, tenant="acme", app="app-1")
    j.append("flush", groups=2, reqs=3)
    j.append("span", session="s0", sim=5.0, k=8, slots=4)
    j.close()
    records, torn = Journal.read(path)
    assert torn == 0
    assert [r["kind"] for r in records] == ["open", "admit", "flush", "span"]
    assert [r["seq"] for r in records] == [0, 1, 2, 3]
    admits = Journal.admissions(records)
    assert len(admits) == 1 and admits[0]["tenant"] == "acme"

    lines = (tmp_path / "journal.jsonl").read_text().splitlines()
    rec = json.loads(lines[1])
    rec["tier"] = 0
    lines[1] = json.dumps(rec, sort_keys=True, separators=(",", ":"))
    (tmp_path / "journal.jsonl").write_text("\n".join(lines) + "\n")
    with pytest.raises(JournalError, match="bad tag"):
        Journal.read(path)

    j2 = Journal(str(tmp_path / "j2.jsonl"), seed=1)
    j2.append("admit", ts=1.0, tier=0, tenant="default", app="a")
    j2.close()
    with open(tmp_path / "j2.jsonl", "a", encoding="utf-8") as f:
        f.write('{"seq": 2, "kind": "fl')
    records, torn = Journal.read(str(tmp_path / "j2.jsonl"))
    assert torn == 1
    assert [r["kind"] for r in records] == ["open", "admit"]


def test_journal_resume_amputates_torn_tail(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    j = Journal(path, seed=7)
    j.append("admit", ts=0.1, tier=0, tenant="default", app="a")
    j.append("admit", ts=0.2, tier=1, tenant="default", app="b")
    j.close()
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"torn":')
    j2 = Journal(path, seed=7, resume=True)
    j2.append("admit", ts=0.3, tier=0, tenant="default", app="c")
    j2.close()
    records, torn = Journal.read(path)
    assert torn == 0
    assert [r["kind"] for r in records] == ["open", "admit", "admit",
                                            "resume", "admit"]
    assert [r["seq"] for r in records] == list(range(5))
    assert records[3]["prior_records"] == 3
    assert len(Journal.admissions(records)) == 3


def test_journal_replay_prefix_check(tmp_path):
    def stream(seed):
        reset_ids()
        return list(mixed_tier_arrivals(
            rate=1.0, n_jobs=6, weights=(0.5, 0.3, 0.2), seed=seed,
            make_app=synthetic_app_factory(seed=11)))

    arrs = stream(3)
    path = str(tmp_path / "journal.jsonl")
    j = Journal(path, seed=0)
    for a in arrs[:4]:
        j.append("admit", ts=a.ts, tier=int(a.tier), tenant=a.tenant,
                 app=a.app.id)
    j.close()
    records, _ = Journal.read(path)
    assert replay_prefix_check(records, stream(3)) == 4
    with pytest.raises(JournalError, match="replay divergence"):
        replay_prefix_check(records, stream(4))


def _journal_records(journal_cls, path, seed, fsync_every, resume=False):
    j = journal_cls(path, seed=seed, fsync_every=fsync_every, resume=resume)
    j.append("admit", ts=0.5, tier=1, tenant="acme", app="app-1")
    j.append("flush", groups=2, reqs=3)
    j.append("span", session="s0", sim=5.000000000000001, k=8, slots=4)
    j.append("splice", session="s0", sim=35.0, k=3, n_new=2)
    j.append("mpc", action="grow", pool=2)
    j.close()


@pytest.mark.parametrize("seed,fsync_every", [(0, 32), (42, 2)])
def test_journal_bytes_equal_reference(tmp_path, seed, fsync_every):
    """The same records give the same file bytes, and so do a torn tail's
    resume and its appended records."""
    ours, theirs = str(tmp_path / "p.jsonl"), str(tmp_path / "j.jsonl")
    _journal_records(Journal, ours, seed, fsync_every)
    _journal_records(JJournal, theirs, seed, fsync_every)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    for path in (ours, theirs):
        with open(path, "a", encoding="utf-8") as f:
            f.write('{"seq": 99, "kind": "adm')
    _journal_records(Journal, ours, seed, fsync_every, resume=True)
    _journal_records(JJournal, theirs, seed, fsync_every, resume=True)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert Journal.read(ours)[0] == JJournal.read(theirs)[0]


# -- snapshots ----------------------------------------------------------------------


def _wait_written(store, n, timeout=10.0):
    deadline = time.monotonic() + timeout
    while store.written < n:
        assert time.monotonic() < deadline, (
            f"snapshot worker stalled at written={store.written}")
        time.sleep(0.005)


def test_snapshot_fingerprint_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    payload = {
        "avail": rng.uniform(0, 4, (8, 4)),
        "counts": rng.integers(0, 3, 8).astype(np.int32),
        "live": np.ones(8, bool),
    }
    store = SnapshotStore(str(tmp_path))
    store.start()
    store.submit(payload, {"span": 2, "policy_spans": 2})
    _wait_written(store, 1)
    store.stop()
    arrays, meta = store.latest()
    for k, v in payload.items():
        np.testing.assert_array_equal(arrays[k], np.asarray(v))
    assert meta["fingerprint"] == fingerprint_arrays(
        arrays, {"span": 2, "policy_spans": 2})
    assert meta["snapshot_seq"] == 0
    assert store.age_s is not None and store.age_s >= 0.0


def test_snapshot_double_buffer_survives_corruption(tmp_path):
    store = SnapshotStore(str(tmp_path))
    store.start()
    a0 = {"avail": np.full((4, 4), 1.0)}
    a1 = {"avail": np.full((4, 4), 2.0)}
    store.submit(a0, {"span": 2})
    _wait_written(store, 1)
    store.submit(a1, {"span": 4})
    _wait_written(store, 2)
    store.stop()
    arrays, meta = store.latest()
    assert meta["span"] == 4
    with open(store.paths[1], "wb") as f:
        f.write(b"not an npz")
    arrays, meta = store.latest()
    assert meta["span"] == 2 and meta["snapshot_seq"] == 0
    np.testing.assert_array_equal(arrays["avail"], a0["avail"])
    with open(store.paths[0], "wb") as f:
        f.write(b"also garbage")
    assert store.latest() is None


def test_fingerprints_equal_reference():
    rng = np.random.default_rng(3)
    for H in (1, 8, 33):
        arrays = {
            "avail": rng.uniform(0, 4, (H, 4)),
            "counts": rng.integers(0, 9, H).astype(np.int32),
            "live": rng.random(H) > 0.2,
            "risk": rng.uniform(0, 1, (3, H)).astype(np.float32),
        }
        meta = {"span": H, "policy_spans": 2 * H, "splices": 1,
                "journal_seq": 17}
        assert fingerprint_arrays(arrays, meta) == j_fingerprint(arrays,
                                                                 meta)
        tensors = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
        host, nbytes = host_arrays(tensors)
        assert nbytes == 0  # nothing came off a card
        assert fingerprint_arrays(host, meta) == j_fingerprint(arrays, meta)


def test_host_arrays_one_copy_round_trip():
    """A snapshot payload's tensors come to the host in one copy (bytes
    concatenated, one ``.cpu()``) with their dtypes and shapes; host
    arrays pass through."""
    carry = resident_carry_init(
        torch.arange(24, dtype=torch.float64).reshape(6, 4),
        counts=np.arange(6, dtype=np.int32),
        live=np.array([1, 0, 1, 1, 0, 1], bool), device="cpu")
    risk = np.linspace(0, 1, 12).reshape(2, 6).astype(np.float32)
    calls = []
    orig = torch.Tensor.cpu

    def counting_cpu(self, *a, **k):
        calls.append(self.shape)
        return orig(self, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "cpu", counting_cpu)
        host, _ = host_arrays({"avail": carry.avail, "counts": carry.counts,
                               "live": carry.live, "risk": risk})
    assert len(calls) == 1
    want = resident_carry_export(carry)
    for k in ("avail", "counts", "live"):
        assert host[k].dtype == want[k].dtype
        np.testing.assert_array_equal(host[k], want[k])
    np.testing.assert_array_equal(host["risk"], risk)


# -- watchdog -----------------------------------------------------------------------


def _rows(spec):
    return [SimpleNamespace(tenant=t, tier=k) for t, k in spec]


def test_watchdog_bisection_quarantines_nan_row():
    rows = _rows([("t0", 0), ("t0", 0), ("noisy", 2), ("t0", 0),
                  ("acme", 1), ("noisy", 2), ("t0", 0), ("acme", 1)])
    poison = 5
    calls = []

    def run_rows(idxs):
        calls.append(list(idxs))
        out = torch.ones(len(idxs), dtype=torch.float64)
        for j, i in enumerate(idxs):
            if i == poison:
                out[j] = float("nan")
        return out

    wd = DispatchWatchdog(policy=RetryPolicy(max_retries=1, base=0.0))
    results = wd.run_batch(rows, run_rows,
                           finite_of=lambda out, idxs: torch.isfinite(out),
                           tenant_of=lambda r: r.tenant,
                           tier_of=lambda r: r.tier)
    assert sorted(results) == [i for i in range(8) if i != poison]
    assert wd.penalty.counts() == {"noisy": 1}
    box = wd.penalty.rows()
    assert box[0]["row"] == poison and box[0]["reason"] == "nonfinite"
    assert box[0]["tier"] == 2
    assert [poison] in calls
    s = wd.summary()
    assert s["quarantined_rows"] == 1
    assert s["retry_concurrency_peak"] <= s["retry_concurrency_cap"]


def test_watchdog_failing_rows_bisect_and_timeout():
    rows = _rows([("a", 0), ("bad", 1), ("a", 0), ("a", 0)])

    def run_rows(idxs):
        if 1 in idxs:
            raise ValueError("poisoned program")
        return np.ones(len(idxs))

    wd = DispatchWatchdog(policy=RetryPolicy(max_retries=1, base=0.0))
    results = wd.run_batch(rows, run_rows, tenant_of=lambda r: r.tenant,
                           tier_of=lambda r: r.tier)
    assert sorted(results) == [0, 2, 3]
    assert wd.penalty.counts() == {"bad": 1}
    assert wd.penalty.rows()[0]["reason"] == "failing"
    assert wd.summary()["failures"] >= 1

    hang = threading.Event()
    wd2 = DispatchWatchdog(policy=RetryPolicy(max_retries=1, base=0.0),
                           timeout_s=0.05)
    with pytest.raises(DispatchFailed):
        wd2.guard(lambda: hang.wait(5.0), key="wedged")
    assert wd2.timeouts == 2
    assert wd2.retries_total == 1
    hang.set()

    state = {"n": 0}

    def flaky():
        state["n"] += 1
        if state["n"] == 1:
            raise DispatchTimeout("transient")
        return "ok"

    wd3 = DispatchWatchdog(policy=RetryPolicy(max_retries=2, base=0.0))
    assert wd3.guard(flaky, key="flaky") == "ok"
    assert wd3.retries_total == 1 and wd3.failures == 0


def _carry_fingerprint(carry):
    return fingerprint_arrays(resident_carry_export(carry),
                              {"kind": "resident-carry"})


@pytest.mark.parametrize("recovers", [True, False])
def test_watchdog_timeout_during_pending_splice_is_atomic(recovers):
    """A dispatch timeout inside ``span_splice`` (at the port's seam
    ``_resident_dispatch``) leaves the pending carry, the staged slot
    set and the splice count as they were; retried, the splice completes
    and the run equals the no-fault referee; exhausted, the splice
    declines and the run still equals it."""
    import tests.test_torch_resident as tr

    late_at = 33.0
    wd = DispatchWatchdog(
        policy=RetryPolicy(max_retries=1 if recovers else 0, base=0.0))
    trace = {"attempts": 0, "fp": [], "staged_s": [], "splices_seen": []}

    def policy_fn():
        policy = tr._port_policy("first_fit")()
        orig_splice = policy.span_splice
        orig_dispatch = policy._resident_dispatch
        in_splice = {"on": False}
        fail = {"left": 1 if recovers else 2}

        def wedged_dispatch(*a, **k):
            if in_splice["on"] and fail["left"] > 0:
                fail["left"] -= 1
                raise DispatchTimeout("injected wedged splice dispatch")
            return orig_dispatch(*a, **k)

        policy._resident_dispatch = wedged_dispatch

        def guarded_splice(ctx, plan, k, new_tasks):
            rs = policy._resident
            before = (_carry_fingerprint(rs.carry), rs.staging["S"],
                      rs.splices)

            def attempt():
                trace["attempts"] += 1
                in_splice["on"] = True
                try:
                    return orig_splice(ctx, plan, k, new_tasks)
                finally:
                    in_splice["on"] = False
                    if rs.splices == before[2]:
                        trace["fp"].append(
                            (_carry_fingerprint(rs.carry), before[0]))
                        trace["staged_s"].append((rs.staging["S"],
                                                  before[1]))

            try:
                out = wd.guard(attempt, key="splice")
            except DispatchFailed:
                out = None
            trace["splices_seen"].append(rs.splices - before[2])
            return out

        policy.span_splice = guarded_splice
        return policy

    plain, _, _ = tr._port_sim(tr._port_policy("first_fit"), fuse=False,
                               late_at=late_at)
    res, stats, _ = tr._port_sim(policy_fn, fuse=True, resident=True,
                                 late_at=late_at)
    assert res == plain
    assert trace["attempts"] == (2 if recovers else 1)
    assert trace["fp"]
    for got, want in trace["fp"]:
        assert got == want
    for got, want in trace["staged_s"]:
        assert got == want
    if recovers:
        assert stats["span_splices"] == 1
        assert wd.retries_total == 1 and wd.failures == 0
        assert 1 in trace["splices_seen"]
    else:
        assert stats["span_splices"] == 0
        assert wd.failures == 1
        assert trace["splices_seen"] == [0]


def test_retry_gate_caps_concurrency():
    gate = RetryGate(2)
    assert gate.acquire(timeout=0.0) and gate.acquire(timeout=0.0)
    assert not gate.acquire(timeout=0.0)
    assert gate.shed == 1
    gate.release()
    gate.release()
    with pytest.raises(RuntimeError):
        gate.release()
    gate2 = RetryGate(3)
    barrier = threading.Barrier(8)

    def worker():
        barrier.wait()
        for _ in range(20):
            if gate2.acquire(timeout=0.5):
                gate2.release()

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert 1 <= gate2.peak <= 3


def test_penalty_box_sheds_tier_zero_last():
    box = PenaltyBox()
    for i, tier in enumerate([2, 0, 1, 2, 0]):
        box.add(i, tenant=f"t{tier}", tier=tier)
    order = box.shed_order()
    assert [r["tier"] for r in order] == [2, 2, 1, 0, 0]
    assert [r["row"] for r in order] == [0, 3, 2, 1, 4]
    assert box.n == 5 and box.counts() == {"t2": 2, "t0": 2, "t1": 1}


def test_recovery_config_validation(tmp_path):
    with pytest.raises(ValueError, match="directory"):
        RecoveryConfig(directory="")
    with pytest.raises(ValueError, match="snapshot_every"):
        RecoveryConfig(directory=str(tmp_path), snapshot_every=-1)
    with pytest.raises(ValueError, match="fsync_every"):
        RecoveryConfig(directory=str(tmp_path), fsync_every=0)
    with pytest.raises(ValueError, match="dispatch_timeout_s"):
        RecoveryConfig(directory=str(tmp_path), dispatch_timeout_s=0.0)
    with pytest.raises(ValueError, match="max_concurrent_retries"):
        RecoveryConfig(directory=str(tmp_path), max_concurrent_retries=0)
    with pytest.raises(TypeError):
        RecoveryPlane({"directory": str(tmp_path)})


# -- kernel-level kill-and-resume ---------------------------------------------------


def _run_spans(carry, span_seeds):
    placements = []
    for s in span_seeds:
        dem, arrive, norms = jrec._kernel_span(s)
        res, carry = resident_span_run(
            carry, torch.from_numpy(dem), torch.from_numpy(arrive), 8,
            policy="first-fit", n_ticks=8, sort_norm=torch.from_numpy(norms))
        placements.append(res.placements.numpy())
    return placements, carry


def test_kernel_kill_and_resume_bit_identical(tmp_path):
    """A span chain killed after span 2, its pending carry snapshotted
    through the real store and restored, continues bit-identically to
    the uninterrupted chain — and both equal ``pivot_tpu``'s chain."""
    rng = np.random.default_rng(100)
    avail = rng.uniform(1, 6, (jrec._KH, 4))
    seeds = [1, 2, 3, 4]
    ref_placements, ref_carry = _run_spans(
        resident_carry_init(avail, device="cpu"), seeds)
    killed, pending = _run_spans(resident_carry_init(avail, device="cpu"),
                                 seeds[:2])
    store = SnapshotStore(str(tmp_path))
    store.start()
    store.submit({"avail": pending.avail, "counts": pending.counts,
                  "live": pending.live}, {"span": 2})
    _wait_written(store, 1)
    store.stop()
    del pending
    arrays, meta = SnapshotStore(str(tmp_path)).latest()
    assert meta["span"] == 2
    resumed = resident_carry_restore(arrays["avail"], arrays["counts"],
                                     arrays["live"], device="cpu")
    resumed_placements, resumed_carry = _run_spans(resumed, seeds[2:])
    for got, want in zip(killed + resumed_placements, ref_placements):
        np.testing.assert_array_equal(got, want)
    for field in ("avail", "counts", "live"):
        np.testing.assert_array_equal(getattr(resumed_carry, field).numpy(),
                                      getattr(ref_carry, field).numpy())
    j_placements, j_carry = jrec._run_spans(
        jtick.resident_carry_init(jnp.asarray(avail)), seeds)
    for got, want in zip(ref_placements, j_placements):
        np.testing.assert_array_equal(got, want)
    for field in ("avail", "counts", "live"):
        np.testing.assert_array_equal(getattr(ref_carry, field).numpy(),
                                      np.asarray(getattr(j_carry, field)))


# -- driver-level -----------------------------------------------------------------


def test_driver_recovery_journal_smoke(tmp_path):
    reset_ids()
    arrs = list(poisson_arrivals(rate=0.5, n_jobs=5, seed=3))
    session = ServeSession(
        "s0", build_cluster(ClusterConfig(n_hosts=8, seed=0)),
        _device_policy(), seed=0)
    cfg = RecoveryConfig(directory=str(tmp_path), snapshot_every=4,
                         fsync_every=4)
    driver = ServeDriver([session], queue_depth=32, backpressure="shed",
                         recovery=cfg)
    report = driver.run(iter(arrs))
    assert report["slo"]["counters"]["completed"] == 5
    rec = report["recovery"]
    assert rec["journal"]["records"] >= 6
    assert rec["journal"]["lag"] == 0
    records, torn = Journal.read(str(tmp_path / "journal.jsonl"))
    assert torn == 0
    kinds = [r["kind"] for r in records]
    assert {"open", "admit", "flush"} <= set(kinds)
    # The batcher's solo fast path journals a one-request flush.
    assert {(r["groups"], r["reqs"]) for r in records
            if r["kind"] == "flush"} == {(1, 1)}
    assert replay_prefix_check(records, arrs) == 5
    reg = MetricsRegistry()
    driver.publish_metrics(reg)
    assert reg.get("pivot_recover_journal_lag") == 0
    assert reg.get("pivot_recover_retries_total") == 0
    assert reg.get("pivot_recover_quarantined_rows", tenant="default") == 0


def _soak_arrivals(n_jobs):
    reset_ids()
    arrs = list(mixed_tier_arrivals(
        rate=20.0, n_jobs=n_jobs, weights=(0.5, 0.3, 0.2), seed=7,
        make_app=synthetic_app_factory(seed=11)))
    straggler = Application("straggler", [
        TaskGroup("s", cpus=1, mem=32, runtime=2.0, instances=1)])
    arrs.append(JobArrival(ts=10_000.0, app=straggler, tier=0))
    return arrs


def _placements_of(arrs):
    return sorted((t.id, t.placement) for a in (x.app for x in arrs)
                  for g in a.groups for t in g.tasks)


def _soak_run(recovery, n_jobs=18, source=None, chaos=True, market=True,
              policy=None):
    """``tests/test_recovery.py::_soak_run`` on the port: one resident
    ``slo``-fused session under a host preemption and a spot market."""
    arrs = _soak_arrivals(n_jobs)
    session = ServeSession(
        "s0", build_cluster(ClusterConfig(n_hosts=8, seed=0)),
        policy or _device_policy(), seed=0, fuse_spans="slo")
    if chaos:
        FaultInjector(session.cluster, seed=0).preempt_host(
            session.cluster.hosts[2].id, at=8.0, lead=6.0, outage=25.0)
    if market:
        session.scheduler.market = MarketSchedule.generate(
            session.cluster.meta, seed=5, horizon=400.0, n_segments=4,
            hot_fraction=0.3, hot_hazard=1e-2, base_hazard=1e-4)
    driver = ServeDriver(
        [session], queue_depth=64, backpressure="shed", flush_after=0.02,
        resident=True, splice_tier=2, recovery=recovery)
    src = iter(arrs) if source is None else source(arrs, driver)
    report = driver.run(src)
    return arrs, driver, report


def _kill_when_snapshotted(arrs, driver, timeout_s=120.0):
    def gen():
        yield from arrs
        plane = driver._recovery
        deadline = time.monotonic() + timeout_s
        while plane.snapshots.written < 1:
            if time.monotonic() > deadline:
                raise AssertionError("killed run never wrote a snapshot")
            time.sleep(0.01)
        raise RuntimeError("injected kill: process died mid-soak")

    return gen()


def test_kill_and_resume_referee(tmp_path):
    """Kill a recovery-armed chaos + market soak after its first
    snapshot, tear its journal tail, resume from snapshot + journal
    replay: the resumed service is bit-identical to the uninterrupted
    run, its re-reached carry fingerprints equal to the snapshot, and
    ``recovery=None`` equals the armed run."""
    n_jobs = 24
    d_ref, d_kill = str(tmp_path / "ref"), str(tmp_path / "kill")
    cfg_ref = RecoveryConfig(directory=d_ref, snapshot_every=2,
                             fsync_every=8)
    arrs_ref, drv_ref, rep_ref = _soak_run(cfg_ref, n_jobs)
    ref_placements = _placements_of(arrs_ref)
    ref_counters = rep_ref["slo"]["counters"]
    assert ref_counters["arrived"] == n_jobs + 1
    assert rep_ref["recovery"]["snapshots"]["written"] >= 1
    assert rep_ref["recovery"]["journal"]["records"] > n_jobs
    plane = drv_ref._recovery
    assert len(plane.clone_ms) >= plane.snapshots.written

    cfg_kill = RecoveryConfig(directory=d_kill, snapshot_every=2,
                              fsync_every=8)
    with pytest.raises(RuntimeError, match="injected kill"):
        _soak_run(cfg_kill, n_jobs, source=_kill_when_snapshotted)
    journal_path = str(tmp_path / "kill" / "journal.jsonl")
    with open(journal_path, "a", encoding="utf-8") as f:
        f.write('{"seq": 99999, "kind": "adm')
    records, torn = Journal.read(journal_path)
    assert torn == 1
    assert replay_prefix_check(records, _soak_arrivals(n_jobs)) == n_jobs + 1

    cfg_res = RecoveryConfig(directory=d_kill, snapshot_every=2,
                             fsync_every=8, resume=True)
    arrs_res, drv_res, rep_res = _soak_run(cfg_res, n_jobs)
    plane = drv_res._recovery
    assert plane.restored is not None
    assert plane.resume_verified is True
    assert _placements_of(arrs_res) == ref_placements
    assert rep_res["slo"]["counters"] == ref_counters
    records, torn = Journal.read(journal_path)
    assert torn == 0
    assert "resume" in {r["kind"] for r in records}

    arrs_pin, _, rep_pin = _soak_run(None, n_jobs)
    assert _placements_of(arrs_pin) == ref_placements
    assert rep_pin["slo"]["counters"] == ref_counters
    assert rep_pin["recovery"] is None


def test_recovery_soak_equals_reference(tmp_path, ref_f64):
    """The armed resident chaos + market soak places as ``pivot_tpu``'s
    armed soak does (its device policy in float64), with the same
    journal kinds and snapshot count."""
    got_arrs, _, got = _soak_run(RecoveryConfig(
        directory=str(tmp_path / "p"), snapshot_every=2), 18)
    want_arrs, _, want = jrec._soak_run(jrec.RecoveryConfig(
        directory=str(tmp_path / "j"), snapshot_every=2), 18)
    assert _placements_of(got_arrs) == _placements_of(want_arrs)
    for k in ("arrived", "admitted", "completed", "shed"):
        assert got["slo"]["counters"][k] == want["slo"]["counters"][k]
    p_kinds = [r["kind"] for r in
               Journal.read(str(tmp_path / "p" / "journal.jsonl"))[0]]
    j_kinds = [r["kind"] for r in
               JJournal.read(str(tmp_path / "j" / "journal.jsonl"))[0]]
    assert sorted(set(p_kinds)) == sorted(set(j_kinds))
    assert p_kinds.count("admit") == j_kinds.count("admit")
    assert set(got["recovery"]) == set(want["recovery"])


def test_watchdog_armed_driver_parity(tmp_path):
    n_jobs = 10
    arrs_plain, _, rep_plain = _soak_run(None, n_jobs, chaos=False,
                                         market=False)
    cfg = RecoveryConfig(directory=str(tmp_path), snapshot_every=4,
                         dispatch_timeout_s=120.0,
                         retry=RetryPolicy(max_retries=1, base=0.0))
    arrs_armed, _, rep_armed = _soak_run(cfg, n_jobs, chaos=False,
                                         market=False)
    assert _placements_of(arrs_armed) == _placements_of(arrs_plain)
    assert rep_armed["slo"]["counters"] == rep_plain["slo"]["counters"]
    wd = rep_armed["recovery"]["watchdog"]
    assert wd["retries_total"] == 0 and wd["timeouts"] == 0
    assert wd["quarantined_rows"] == 0
    assert wd["retry_concurrency_peak"] == 0


def test_wedged_resident_dispatch_times_out_and_retries(tmp_path):
    """A resident span dispatch that hangs (parked past the watchdog's
    timeout, before it consumes the carry) is abandoned and retried:
    the service equals the no-fault run, with one timeout and one
    retry."""
    n_jobs = 10
    arrs_plain, _, rep_plain = _soak_run(None, n_jobs)
    release = threading.Event()
    policy = _device_policy()
    orig = policy._resident_dispatch
    wedged = {"left": 1, "threads": []}

    def wedged_dispatch(*a, **k):
        if wedged["left"]:
            wedged["left"] -= 1
            wedged["threads"].append(threading.current_thread().name)
            release.wait(60.0)
            raise DispatchTimeout("wedged dispatch released")
        return orig(*a, **k)

    policy._resident_dispatch = wedged_dispatch
    cfg = RecoveryConfig(directory=str(tmp_path), snapshot_every=2,
                         dispatch_timeout_s=0.5,
                         retry=RetryPolicy(max_retries=1, base=0.0))
    try:
        arrs, drv, rep = _soak_run(cfg, n_jobs, policy=policy)
    finally:
        release.set()
    assert _placements_of(arrs) == _placements_of(arrs_plain)
    for k in ("arrived", "admitted", "completed", "shed", "decisions"):
        assert rep["slo"]["counters"][k] == rep_plain["slo"]["counters"][k]
    wd = rep["recovery"]["watchdog"]
    assert wd["timeouts"] == 1 and wd["retries_total"] == 1
    assert wd["failures"] == 0
    assert wedged["threads"][0].startswith("recover-dispatch-")


def test_session_hooks_journal_before_dispatch_and_snapshot_after(tmp_path):
    """``attach_recovery``: the ``span`` record is appended before the
    span dispatch runs and the snapshot tap fires after it; a ``splice``
    record precedes the splice; with the watchdog armed, the dispatch
    runs on the guard's worker thread."""
    for armed in (False, True):
        reset_ids()
        policy = _device_policy()
        session = ServeSession(
            "s0", build_cluster(ClusterConfig(n_hosts=4, seed=0)), policy,
            seed=0, fuse_spans="slo")
        plane = RecoveryPlane(RecoveryConfig(
            directory=str(tmp_path / str(armed)), snapshot_every=1,
            dispatch_timeout_s=5.0 if armed else None))
        seen = []

        def place_span(ctx, plan):
            seen.append(("span", plane.journal.appended, plane._spans,
                         threading.current_thread().name))
            return "out"

        def span_splice(ctx, plan, k, new_tasks):
            seen.append(("splice", plane.journal.appended))
            return "spliced"

        policy.place_span = place_span
        policy.span_splice = span_splice
        session.attach_recovery(plane)
        ctx = SimpleNamespace(env_now=12.5)
        plan = SimpleNamespace(n_ticks=4, slots=[1, 2, 3])
        assert policy.place_span(ctx, plan) == "out"
        assert policy.span_splice(ctx, plan, 2, [7]) == "spliced"
        plane.stop()
        assert seen[0][:3] == ("span", 2, 0)  # header + span record
        assert seen[1] == ("splice", 3)
        assert plane.summary()["spans_seen"] == 1
        assert plane.summary()["splices_seen"] == 1
        assert seen[0][3].startswith("recover-dispatch-") is armed
        records, _ = Journal.read(str(tmp_path / str(armed) /
                                      "journal.jsonl"))
        assert [(r["kind"], r.get("k")) for r in records] == [
            ("open", None), ("span", 4), ("splice", 2)]
        assert records[1]["sim"] == 12.5 and records[1]["slots"] == 3


def test_plane_snapshots_a_clone_not_the_carry(tmp_path):
    """``note_span`` submits a clone of the pending carry: the clone
    equals the carry and shares no memory with it."""
    plane = RecoveryPlane(RecoveryConfig(directory=str(tmp_path),
                                         snapshot_every=1))
    carry = resident_carry_init(np.full((5, 4), 3.0), device="cpu")
    rs = SimpleNamespace(carry=carry, risk_table_np=None, spans=1,
                         splices=0)
    submitted = []
    plane.snapshots.submit = lambda payload, meta: submitted.append(
        (payload, meta))
    plane.note_span(SimpleNamespace(_resident=rs))
    plane.stop()
    (payload, meta), = submitted
    assert meta["span"] == 1 and meta["policy_spans"] == 1
    for name, t in zip(("avail", "counts", "live"), carry):
        assert torch.equal(payload[name], t)
        assert payload[name].data_ptr() != t.data_ptr()
    assert len(plane.clone_ms) == 1
