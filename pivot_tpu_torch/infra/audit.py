"""Simulation-state invariant auditor — the framework's sanitizer.

The reference has **no race detection or sanitizers** (SURVEY.md §5); its
concurrency safety rests on SimPy's cooperative scheduling plus a mutex.
This framework's cooperative kernel gives the same atomicity, but resource
accounting bugs (double release, leaked admission, negative capacity,
ghost tasks on dead hosts) would corrupt results *silently* — placements
still happen, metrics still print.  The auditor makes the invariants
explicit and checkable at any dispatch point:

  * per host, per dimension: ``0 ≤ available ≤ total`` (up hosts);
  * the sum of resident tasks' demands equals the capacity in use;
  * down hosts hold no tasks (tasks whose abort has fired but not yet
    been delivered are tolerated — a legitimate transient between the
    failure event and the aborted process resuming);
  * down hosts report the −1 availability sentinel in
    ``availability_matrix`` (what keeps fit masks off them);
  * a Python-backend route is busy iff it has a transfer in service
    (native routes keep their queue in the C++ engine and are skipped).

Run it ad hoc (``violations = audit_cluster(cluster)``), or install it as
a kernel step observer (``start_periodic_audit``) to fail fast at the
first corrupted state — the DES analog of running under a sanitizer.
The observer never schedules events, so it cannot advance sim time or
change any metric.

Round 7 adds the **conservation and billing audits** the chaos soak is
refereed by: :func:`audit_conservation` (every admitted task terminates
exactly once — completed, dead-lettered, or cancelled with its failed
app — and no placement ever landed on a down or quarantined host) and
:func:`audit_meter` (busy-interval/billing well-formedness under any
fault schedule), combined by :func:`audit_run`.
"""

from __future__ import annotations

from typing import List

__all__ = [
    "AuditError",
    "audit_cluster",
    "audit_conservation",
    "audit_meter",
    "audit_run",
    "audit_serve",
    "check",
    "start_periodic_audit",
]

#: Relative tolerance for float accounting (fractional trace demands
#: accumulate rounding on acquire/release).
_RTOL = 1e-6


class AuditError(AssertionError):
    """Raised by the periodic auditor on the first invariant violation."""


def _close(a: float, b: float, scale: float) -> bool:
    return abs(a - b) <= _RTOL * max(scale, 1.0)


def check(cluster, context: str) -> None:
    """Audit and raise :class:`AuditError` (with ``context`` in the
    message) on any violation — the single raise path shared by the
    periodic observer and end-of-run checks."""
    violations = audit_cluster(cluster)
    if violations:
        raise AuditError(
            f"simulation state corrupted ({context}):\n  "
            + "\n  ".join(violations)
        )


def audit_cluster(cluster) -> List[str]:
    """Check every invariant; return human-readable violations (empty = ok)."""
    from pivot_tpu_torch.infra.network import NativeRoute

    violations: List[str] = []
    dims = ("cpus", "mem", "disk", "gpus")
    avail_mat = None
    for hi, host in enumerate(cluster.hosts):
        r = host.resource
        if not host.up:
            # In-flight completions that legitimately outlive the crash:
            # process executor — aborts already triggered in Host._aborts;
            # fast executor — due-completion tie-breaks kept resident by
            # abort_host for their one-hop conclusion (executor.py).
            fast_live = (
                {t for t, _staged in cluster.executor.resident(host)}
                if cluster.executor is not None
                else set()
            )
            stuck = [
                t for t in host._tasks
                if t not in fast_live
                and not (t in host._aborts and host._aborts[t].triggered)
            ]
            if stuck:
                violations.append(
                    f"{host.id}: down but holds {len(stuck)} task(s) with "
                    "no abort in flight"
                )
            if avail_mat is None:
                avail_mat = cluster.availability_matrix()
            if not (avail_mat[hi] == -1.0).all():
                violations.append(
                    f"{host.id}: down but availability row is "
                    f"{avail_mat[hi].tolist()}, not the -1 sentinel"
                )
            continue
        in_use = [0.0, 0.0, 0.0, 0.0]
        for task in host._tasks:
            g = task.group
            for i, d in enumerate((g.cpus, g.mem, g.disk, g.gpus)):
                in_use[i] += d
        for i, dim in enumerate(dims):
            avail = getattr(r, dim)
            total = getattr(r, "t_" + dim)
            if avail < -_RTOL * max(total, 1.0):
                violations.append(f"{host.id}: negative {dim} ({avail})")
            if avail > total * (1 + _RTOL):
                violations.append(
                    f"{host.id}: {dim} available {avail} exceeds total {total}"
                )
            if not _close(total - avail, in_use[i], total):
                violations.append(
                    f"{host.id}: {dim} in use {total - avail:.6g} != "
                    f"Σ resident demands {in_use[i]:.6g}"
                )
    for key, route in cluster._routes.items():
        if isinstance(route, NativeRoute):
            continue  # queue state lives in the C++ engine
        if route._busy != (route._in_service is not None):
            violations.append(
                f"route {key}: busy={route._busy} but "
                f"in_service={route._in_service!r}"
            )
    return violations


def start_periodic_audit(cluster, period: float = 5.0) -> None:
    """Audit at event boundaries, at most once per ``period`` sim-seconds;
    raise :class:`AuditError` with the full violation list the first time
    any invariant breaks.

    Installed as a kernel step observer (``Environment.add_step_observer``)
    rather than as heap events: the audit piggybacks on real events, so it
    cannot advance sim time past the last workload event, keep ``run()``
    alive, or perturb event ordering."""
    env = cluster.env
    last = [env.now]

    def _observe():
        if env.now - last[0] < period:
            return
        last[0] = env.now
        check(cluster, f"t={env.now:.3f}")

    env.add_step_observer(_observe)


# ---------------------------------------------------------------------------
# Conservation + billing audits (round 7 — the chaos soak's referee)
# ---------------------------------------------------------------------------


def audit_conservation(scheduler, apps) -> List[str]:
    """Task-conservation law under retry governance (``sched/retry.py``):
    after a run drains, every materialized task of every submitted app
    terminates **exactly once** —

      * a finished app: all tasks FINISHED, none dead-lettered;
      * a failed app: every task FINISHED (completed before the failure),
        DEAD (exactly the dead-letter queue's entries), or NASCENT
        (cancelled with the app — never placed again);
      * no task both finished and dead-lettered, no task left in the
        SUBMITTED/RUNNING limbo states;
      * each DEAD task has one dead-letter record, budget-exhausted
        entries consumed exactly ``max_retries + 1`` attempts, and no
        placement ever landed on a down or quarantined host
        (``scheduler.placement_violations``).

    Returns human-readable violations (empty = the law holds).
    """
    violations: List[str] = []
    # Keyed by (app, task): task ids are group-local ("src/1") and
    # collide across apps — a bare-task_id ledger would count app A's
    # dead letter against app B's finished twin of the same name.
    dead_ids = {}
    for entry in scheduler.dead_letters:
        key = (entry.app_id, entry.task_id)
        if key in dead_ids:
            violations.append(
                f"task {entry.task_id} (app {entry.app_id}): multiple "
                "dead-letter records (terminated more than once)"
            )
        dead_ids[key] = entry
    retry = scheduler.retry
    if retry is not None:
        for entry in scheduler.dead_letters:
            budget = retry.budget(getattr(entry, "tier", 0))
            if entry.reason == "retry_budget" and budget is not None and (
                entry.attempts != budget + 1
            ):
                violations.append(
                    f"task {entry.task_id}: dead-lettered after "
                    f"{entry.attempts} attempts, tier budget says "
                    f"{budget + 1}"
                )
    seen_dead = set()
    for app in apps:
        failed = bool(getattr(app, "failed", False))
        if failed and app.is_finished:
            violations.append(f"app {app.id}: both failed and finished")
        for group in app.groups:
            for task in group.tasks:
                state = task.state.value
                key = (app.id, task.id)
                if task.is_dead:
                    seen_dead.add(key)
                    if key not in dead_ids:
                        violations.append(
                            f"task {task.id}: DEAD with no dead-letter record"
                        )
                    if not failed:
                        violations.append(
                            f"task {task.id}: dead-lettered but app "
                            f"{app.id} not marked failed"
                        )
                elif task.is_finished:
                    if key in dead_ids:
                        violations.append(
                            f"task {task.id} (app {app.id}): both finished "
                            "and dead-lettered"
                        )
                elif state in ("submitted", "running"):
                    violations.append(
                        f"task {task.id}: still {state} after the run "
                        "drained (lost in flight)"
                    )
                elif state == "nascent" and not failed:
                    violations.append(
                        f"task {task.id}: nascent in a live app after the "
                        "run drained (lost before placement)"
                    )
    for app_id, task_id in dead_ids:
        if (app_id, task_id) not in seen_dead:
            violations.append(
                f"dead-letter record for {task_id} (app {app_id}) but "
                "task not DEAD"
            )
    violations.extend(scheduler.placement_violations)
    return violations


def audit_meter(meter, at_end: bool = True) -> List[str]:
    """Billing consistency: host busy intervals well-formed (closed when
    the run has drained, non-negative, chronologically ordered,
    non-overlapping) and scheduling turnovers non-negative — the
    invariants ``cumulative_instance_hours`` (the billing figure) rests
    on.  Chaos can legally reshape intervals (aborts close them early,
    recoveries reopen), but can never corrupt them."""
    violations: List[str] = []
    for host, intervals in meter._host_intervals.items():
        prev_end = None
        for iv in intervals:
            if len(iv) == 1:
                if at_end:
                    violations.append(
                        f"{host.id}: busy interval opened at {iv[0]:.6g} "
                        "never closed"
                    )
                continue
            start, end = iv
            if end < start:
                violations.append(
                    f"{host.id}: negative busy interval [{start:.6g}, {end:.6g}]"
                )
            if prev_end is not None and start < prev_end:
                violations.append(
                    f"{host.id}: overlapping busy intervals at {start:.6g}"
                )
            prev_end = end
    for t in meter._sched_turnovers:
        if t < 0:
            violations.append(f"negative scheduling turnover {t:.6g}")
            break
    # Rework accounting (spot survival): wasted task-seconds of aborted
    # executions.  Per-TASK time, so concurrency can legitimately push it
    # past the busy-interval wall clock (intervals merge co-resident
    # tasks) — but it can never be negative, and a world with no aborts
    # must bill zero rework.
    rework = getattr(meter, "rework_seconds", 0.0)
    if rework < 0:
        violations.append(f"negative rework accounting {rework:.6g}")
    return violations


def audit_serve(driver) -> List[str]:
    """Serve-layer conservation law (round 9 — the multi-tenant chaos
    soak's referee).  After a drained ``ServeDriver.run``:

      * capacity fully settled: zero in-flight, empty spill buffer,
        empty admission ledger;
      * globally and per tier, ``admitted == completed + failed_jobs +
        preempted`` — every admission terminates exactly once (a
        preemption *is* a termination of that admission; the victim's
        re-entry is a fresh ``admitted`` when the spill buffer
        readmits it);
      * every preempted job was requeued-to-spill exactly once
        (``preempted == preempt_requeued``), so with the spill buffer
        empty each victim re-entered and then terminated — nothing
        vanished, nothing terminated twice;
      * every surviving (non-abandoned) session's world passes the
        task-conservation, cluster-state, and billing audits.

    Returns human-readable violations (empty = the law holds).
    """
    violations: List[str] = []
    q = driver.queue
    if q.in_flight != 0:
        violations.append(
            f"admission queue drained with in_flight={q.in_flight}"
        )
    if q.spilled:
        violations.append(
            f"{len(q.spilled)} arrival(s) left in the spill buffer"
        )
    if driver._inflight:
        violations.append(
            f"{len(driver._inflight)} stale admission ledger entries"
        )
    # DRF tenant fairness (round 17): with a tenant quota on, every
    # admission charged its tenant's dominant-share occupancy and every
    # settlement must have given exactly that share back — a drained
    # service's per-(tier, tenant) ledger is zero.  A positive residue
    # is a leaked release (that tenant is permanently over-charged and
    # will be quota-shed forever); a negative one is a double release.
    if getattr(q, "tenant_quota", None) is not None:
        for (tier, tenant), occ in sorted(q.tenant_occupancy.items()):
            if abs(occ) > 1e-6:
                violations.append(
                    f"tenant {tenant!r} tier {tier}: dominant-share "
                    f"occupancy residue {occ:.6g} after drain "
                    "(leaked or double-released quota charge)"
                )

    def _check(counters, scope: str) -> None:
        admitted = counters.get("admitted", 0)
        settled = (
            counters.get("completed", 0)
            + counters.get("failed_jobs", 0)
            + counters.get("preempted", 0)
        )
        if admitted != settled:
            violations.append(
                f"{scope}: admitted {admitted} != completed + failed + "
                f"preempted {settled} (an admission terminated zero or "
                "multiple times)"
            )

    snap = driver.slo.snapshot()
    _check(snap["counters"], "service")
    if snap["counters"].get("preempted", 0) != snap["counters"].get(
        "preempt_requeued", 0
    ):
        violations.append(
            f"preempted {snap['counters'].get('preempted', 0)} != "
            f"preempt_requeued {snap['counters'].get('preempt_requeued', 0)}"
        )
    for tier, tsnap in snap.get("tiers", {}).items():
        _check(tsnap["counters"], f"tier {tier}")
    for s in driver.sessions + driver._retired:
        violations += [
            f"session {s.label}: {v}"
            for v in (
                audit_conservation(s.scheduler, s._injected)
                + audit_cluster(s.cluster)
                + audit_meter(s.meter)
            )
        ]
    return violations


def audit_run(
    scheduler, apps, context: str = "end of run",
    cluster=None, meter=None,
) -> None:
    """One-call referee for a drained (chaos) run: cluster-state,
    conservation, and billing audits; raises :class:`AuditError` with
    every violation on the first breach.  ``cluster``/``meter`` default
    to the scheduler's own."""
    cluster = cluster if cluster is not None else scheduler.cluster
    meter = meter if meter is not None else scheduler.meter
    violations = audit_cluster(cluster)
    violations += audit_conservation(scheduler, apps)
    if meter is not None:
        violations += audit_meter(meter)
    if violations:
        raise AuditError(
            f"simulation state corrupted ({context}):\n  "
            + "\n  ".join(violations)
        )
