"""Callback-based task executor — the cluster side of dispatch, flattened.

The reference executes every task instance as its own SimPy process
(``resources/__init__.py:119-135``: one ``_execute_task`` process wrapping
``Host.execute``, itself yielding through admission → staging barrier →
compute timeout).  This framework's ``process`` executor mirrors that shape
on the in-house kernel; it is faithful but pays generator machinery — a
``Process`` object, a bootstrap event, an ``any_of``/``all_of`` event pair,
and several resume round-trips — for **every one of the ~433k task
instances** in a full Alibaba trace window.

``FastExecutor`` keeps the observable semantics and the timing arithmetic
bit-identical while driving each execution with bare callbacks instead:

  * admission, meter check-in, and predecessor sampling run synchronously
    at dispatch (same instant, same RNG draw order as ``Host.execute``);
  * the staging barrier is a countdown object handed to ``Route.send`` in
    place of an ``Event`` — each chunk-service completion decrements it
    inside the route's own callback, with zero extra heap traffic;
  * compute is one ``schedule_callback(runtime)`` whose conclusion performs
    release / check-out / ``notify_q.put`` — one heap event per execution.

Host state (capacity vectors, resident-task sets) and every meter hook stay
on the Python objects, so the invariant auditor (``infra.audit``), the
dense exports (``Cluster.availability_matrix``), and all metrics observe
identical state at identical sim times.  Full-simulation bit parity with
the ``process`` executor is asserted in ``tests/test_executor.py``.

**Event-hop parity** (the subtle part): in the process executor a
completion at time T performs its release two event hops after the compute
timeout fires — the timeout event (scheduled at compute start, old seq)
carries no state change; the ``any_of`` race event it triggers gets a
*fresh* seq at T, so every event already pending at T with an older seq —
most importantly a scheduler tick scheduled at T−interval — observes host
state *before* the release.  The fast executor reproduces this exactly:
the compute timer fires a no-op hop whose only job is to schedule the
actual conclusion as a fresh zero-delay callback.  The admission-failure
notification is likewise deferred one hop to sit where the process
executor's bootstrap event would.

Fault semantics match ``Host.execute``'s abort race (``infra.faults``):
``abort_host`` cancels pending staging transfers (data already on the wire
finishes its chunk), closes the meter interval without refunding capacity
— the machine is gone; ``recover`` resets it wholesale — and surfaces each
resident task as ``(False, task)`` on ``notify_q`` for the retry loop.  A
compute completion due at or before the crash instant wins the tie (the
process executor's timeout event, with its older seq, fires before the
crash-triggered abort event resolves the race), so ``abort_host`` skips
executions whose conclusion is already due.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from pivot_tpu_torch.utils import LogMixin

__all__ = ["FastExecutor"]


class _StageDone:
    """Countdown token passed to ``Route.send`` instead of an ``Event``.

    Routes only ever call ``.succeed()`` on their completion hook (and
    ``cancel`` compares identity), so this quacks enough — and the
    decrement runs inside the route's chunk callback with no extra heap
    event, where the process executor pays a done-event → ``all_of`` →
    ``any_of`` → resume chain per predecessor transfer.
    """

    __slots__ = ("ex",)

    def __init__(self, ex: "_Exec"):
        self.ex = ex

    def succeed(self, value=None, priority=None):
        ex = self.ex
        ex.staging_remaining -= 1
        if ex.staging_remaining == 0 and not ex.aborted:
            ex.executor._staging_complete(ex)


class _Exec:
    """One in-flight task execution."""

    __slots__ = (
        "executor",
        "task",
        "host",
        "preds",
        "routes",
        "dones",
        "pull_start",
        "staging_remaining",
        "aborted",
        "conclude_at",
    )

    def __init__(self, executor: "FastExecutor", task, host):
        self.executor = executor
        self.task = task
        self.host = host
        self.preds: List = []
        self.routes: List = []
        self.dones: List[_StageDone] = []
        self.pull_start = 0.0
        self.staging_remaining = 0
        self.aborted = False
        self.conclude_at: Optional[float] = None


class FastExecutor(LogMixin):
    """Flattened executor for one cluster (``Cluster(executor='fast')``)."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.env = cluster.env
        # host id -> {task: exec}, insertion-ordered like Host._aborts so
        # abort order under a crash matches the process executor.
        self._resident: Dict[str, Dict[object, _Exec]] = {}

    # -- dispatch (synchronous, called from Cluster._dispatch_loop) -------
    def dispatch(self, task, host) -> None:
        """Admit and start ``task`` on ``host``; failures notify immediately.

        Mirrors ``Host.execute`` (ref ``resources/__init__.py:244-314``)
        step for step: liveness + all-or-nothing admission, meter check-in,
        predecessor sampling (same ``cluster.pyrng`` draw order), staging
        sends in predecessor order, then the compute timer.
        """
        env, meter, cluster = self.env, host.meter, self.cluster
        group = task.group
        if not host.up or not host.resource.try_acquire(
            group.cpus, group.mem, group.disk, group.gpus
        ):
            cluster.notify_q.put((False, task))
            return

        host._tasks.add(task)
        ex = _Exec(self, task, host)
        self._resident.setdefault(host.id, {})[task] = ex
        if meter:
            meter.host_check_in(host)
        task.set_running()

        ex.pull_start = env.now
        preds = host._sample_predecessor_inputs(task)
        if preds:
            ex.preds = preds
            ex.staging_remaining = len(preds)
            for p in preds:
                route = cluster.get_route(host._output_source(p, cluster), host.id)
                ex.routes.append(route)
                done = _StageDone(ex)
                ex.dones.append(done)
                route.send(p.output_size, done)
        else:
            self._start_compute(ex)

    # -- staging barrier → compute ----------------------------------------
    def _staging_complete(self, ex: _Exec) -> None:
        host = ex.host
        if host.meter:
            host._record_transfer(ex.task, ex.preds, ex.routes, ex.pull_start)
        self._start_compute(ex)

    def _start_compute(self, ex: _Exec) -> None:
        # Straggler fault model (``infra.faults.slow_host``): compute
        # started while the host straggles is stretched by the current
        # multiplier; in-flight compute keeps its original finish time
        # (the timer is already on the heap).  slowdown == 1.0 when
        # healthy, and x * 1.0 == x bitwise — the no-straggler
        # trajectory is unchanged, same as ``Host.execute``.
        duration = ex.task.runtime * ex.host.slowdown
        ex.conclude_at = self.env.now + duration
        self.env.schedule_callback(duration, lambda: self._compute_done(ex))

    def _compute_done(self, ex: _Exec) -> None:
        # No-op hop mirroring the process executor's timeout event: the
        # release happens one fresh-seq event later, so anything already
        # pending at this instant (a scheduler tick above all) sees host
        # state before the release — see the module docstring.
        if ex.aborted:
            return
        self.env.schedule_callback(0.0, lambda: self._conclude(ex))

    def _conclude(self, ex: _Exec) -> None:
        if ex.aborted:
            return
        task, host = ex.task, ex.host
        group = task.group
        host.resource.release(group.cpus, group.mem, group.disk, group.gpus)
        host._tasks.discard(task)
        live = self._resident.get(host.id)
        if live is not None:
            live.pop(task, None)
            if not live:
                del self._resident[host.id]
        if host.meter:
            host.meter.host_check_out(host)
        # Drop the staging graph: metered Transfers are retained as meter
        # keys for the whole run and reach this _Exec via their done hooks;
        # clearing the lists keeps the retained residue per transfer small.
        ex.preds = ex.routes = ex.dones = ()
        self.cluster.notify_q.put((True, task))

    # -- faults ------------------------------------------------------------
    def _abort_exec(self, ex, task, host, now: float) -> None:
        """Shared crash/eviction teardown for one resident execution:
        cancel staging, close the meter interval, bill the wasted work as
        rework, surface ``(False, task)`` to the governed retry loop."""
        ex.aborted = True
        for route, done in zip(ex.routes, ex.dones):
            route.cancel(done)
        host._tasks.discard(task)
        if host.meter:
            host.meter.host_check_out(host)
            host.meter.add_rework(now - ex.pull_start)
        ex.preds = ex.routes = ex.dones = ()
        self.cluster.notify_q.put((False, task))

    def abort_host(self, host) -> None:
        """Host crashed: abort every resident execution (``Host.fail``)."""
        live = self._resident.pop(host.id, None)
        if not live:
            return
        now = self.env.now
        for task, ex in live.items():
            if ex.conclude_at is not None and ex.conclude_at <= now:
                # Completion already due: the process executor's timeout
                # event outruns the abort race — let the conclusion land.
                self._resident.setdefault(host.id, {})[task] = ex
                continue
            self._abort_exec(ex, task, host, now)

    def evict_task(self, task, host) -> bool:
        """Proactively abort ONE resident execution on a LIVE host — the
        spot-drain restart path (``GlobalScheduler.on_preempt_warning``).
        Unlike :meth:`abort_host`, the machine keeps running, so the
        task's capacity IS refunded; the execution aborts exactly like a
        crash otherwise (staging cancelled, meter interval closed, the
        wasted work billed as rework, ``(False, task)`` surfaced for the
        governed retry loop).  Returns False — and touches nothing —
        when the task is not live here or its conclusion is already due
        (evicting a completed execution would turn a free success into a
        retry)."""
        live = self._resident.get(host.id)
        ex = live.get(task) if live else None
        if ex is None or ex.aborted or not host.up:
            return False
        now = self.env.now
        if ex.conclude_at is not None and ex.conclude_at <= now:
            return False
        group = task.group
        host.resource.release(group.cpus, group.mem, group.disk, group.gpus)
        live.pop(task, None)
        if not live:
            del self._resident[host.id]
        self._abort_exec(ex, task, host, now)
        return True

    def evict_doomed(self, host, deadline: float) -> List:
        """Evict every resident execution that provably cannot conclude
        before ``deadline`` (the preemption abort instant): compute-phase
        executions with ``conclude_at`` past it, and staging executions
        whose compute alone would overrun.  Residents that fit inside
        the lead are left to drain out.  Returns the evicted tasks."""
        live = self._resident.get(host.id)
        if not live:
            return []
        now = self.env.now
        doomed = []
        for task, ex in list(live.items()):
            if ex.aborted:
                continue
            if ex.conclude_at is None:
                eta = now + task.runtime * host.slowdown
            else:
                eta = ex.conclude_at
            if eta > deadline and self.evict_task(task, host):
                doomed.append(task)
        return doomed

    # -- introspection -----------------------------------------------------
    def resident(self, host) -> List[Tuple[object, bool]]:
        """(task, staging_done) for executions live on ``host``."""
        return [
            (t, ex.staging_remaining == 0)
            for t, ex in self._resident.get(host.id, {}).items()
        ]
