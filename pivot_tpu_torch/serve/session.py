"""One always-on scheduling session: a continuous DES under live arrivals.

A :class:`ServeSession` is the serving analog of one batch
``ExperimentRun``: the same construction — fresh event kernel, meter,
cluster clone, ``GlobalScheduler`` wired to a policy — but instead of
replaying a fixed schedule to event exhaustion, the session's thread
*drains on demand*: it blocks on a job inbox, injects admitted arrivals
at their sim-time instants, and steps the event kernel until the live
work completes, then goes idle again.  The scheduler is never
``stop()``-ed until shutdown, so its tick grid (``k × interval`` from
sim time 0) keeps running exactly as a batch run's would — idle ticks
are no-ops (empty ready batch ⇒ no policy call, no tick_seq advance,
no meter traffic), which is what makes a served schedule bit-comparable
to the same jobs through batch mode (``tests/test_serve.py``).

Two serving-specific couplings:

  * **dispatch batching** — when the driver hands the session a
    ``BatchClient``, every device placement call parks the thread at its
    tick boundary and coalesces with the other sessions' co-pending
    ticks (``sched/batch.py``); the session marks its slot idle while
    waiting for work so an empty session never stalls a busy one.
  * **the release gate** — an online scheduler may not simulate past
    "now": before stepping an event at sim time t the session waits for
    the driver's release frontier to reach t (the driver advances it as
    arrivals stream in, and to ∞ when the stream ends).  This is what
    guarantees an arrival is injected before the session's clock passes
    its timestamp — without the gate, a fast session could race ahead
    of the arrival stream and every later job would slip.

Port of ``pivot_tpu/serve/session.py``, with serve spans
(``fuse_spans="slo"``, ``:93-121``, ``:174-190``, ``:251-296``) and the
recovery plane's hooks (``attach_recovery``, ``:298-366``).
"""

from __future__ import annotations

import queue
import time
from typing import List, Optional

import numpy as np

from pivot_tpu_torch.des import Environment
from pivot_tpu_torch.infra.meter import Meter, SloMeter
from pivot_tpu_torch.obs import NULL_TRACER, ObsClock
from pivot_tpu_torch.sched import GlobalScheduler
from pivot_tpu_torch.utils import LogMixin

from pivot_tpu_torch.serve.arrivals import JobArrival

__all__ = ["STOP", "PreemptRequest", "ServeSession"]

#: Inbox sentinel: the driver ends a session's loop with this.
STOP = object()


class PreemptRequest:
    """Driver → session mailbox message: cancel ``app`` if it is still
    admitted-but-unplaced here (in-queue preemption).  Delivered through
    the inbox so it executes on the session thread — the only thread
    allowed to mutate this session's event kernel — and FIFO-after any
    arrival it targets.  The session answers via
    ``driver.on_preempt_result`` either way (hit or miss)."""

    __slots__ = ("app",)

    def __init__(self, app):
        self.app = app


def _is_batchable(policy) -> bool:
    """Device-backed, deterministic-routing policies may share a batched
    dispatch: the port's device policies (``sched/cuda.py``) without the
    adaptive twin."""
    return (
        hasattr(policy, "enable_batching")
        and not getattr(policy, "adaptive", False)
    )


class ServeSession(LogMixin):
    """One live scheduling context multiplexed by the serve driver."""

    def __init__(
        self,
        label: str,
        cluster,
        policy,
        seed: Optional[int] = None,
        interval: float = 5.0,
        slo: Optional[SloMeter] = None,
        retry=None,
        breaker=None,
        clock: Optional[ObsClock] = None,
        fuse_spans=False,
    ):
        if fuse_spans not in (False, "slo"):
            raise ValueError(
                'ServeSession fuse_spans must be False (per-tick '
                'dispatch, the bit-parity default) or "slo" (fused '
                "spans bounded by the driver's admission window, one "
                "SLO latency sample per span) — unbounded True is a "
                "batch-mode knob: an online scheduler may not "
                "speculate past the stream's revealed frontier "
                "without an SLO checkpoint"
            )
        self.label = label
        #: Serve-span mode: ``False`` keeps per-tick dispatch; ``"slo"``
        #: lets the scheduler fuse spans between SLO checkpoints — spans
        #: bounded by the driver's release frontier (inclusive:
        #: ``GlobalScheduler.span_horizon``, wired by the driver), the
        #: SLO meter recording ONE decision latency per span.
        #: Placements are identical either way.
        self.fuse_spans = fuse_spans
        self.policy = policy
        self.seed = seed
        self.interval = interval
        #: One injected obs wall clock for everything this session
        #: meters (round 14): the run Meter and the fallback SLO meter
        #: share it, so their wall snapshots agree exactly.
        self.clock = clock or ObsClock()
        self.slo = slo or SloMeter(clock=self.clock)
        #: Causal trace timeline — swapped for the service-wide tracer
        #: by the driver (like ``slo``); NULL = zero-cost.
        self.tracer = NULL_TRACER
        self.error: Optional[BaseException] = None
        self.completed: List = []
        self.failed: List = []  # dead-lettered (retry-governed) apps
        self._inbox: "queue.Queue" = queue.Queue()
        self._live: List = []  # injected, not yet finished apps
        self._injected: List = []  # every app ever injected, in order
        self._driver = None  # attached by ServeDriver
        self._client = None  # this session's BatchClient (driver-owned)
        self._recovery = None  # RecoveryPlane (driver-owned)
        self.slot = -1
        #: Supervisor liveness: wall clock of the last event-kernel step
        #: (or inbox wait) — the stall watchdog's heartbeat.
        self.last_progress = time.perf_counter()
        #: Set by the supervisor when this session is declared dead and
        #: replaced; an abandoned session's late callbacks are ignored.
        self.abandoned = False
        #: Drain-then-retire state (autoscaler scale-down): ``retiring``
        #: stops the router sending new work here; ``_retired`` guards
        #: the retire from ever being finalized twice (the finalize path
        #: and a crash-during-drain race on it under the driver's lock).
        self.retiring = False
        self._retired = False
        #: EWMA of recent decision latency (wall s) — the routing
        #: tie-breaker for least-loaded dispatch.  Written only by this
        #: session's decision tap, read by the router (stale reads are
        #: fine: it is a heuristic, not a correctness input).
        self.recent_decision_s = 0.0
        self._kernel_failures_seen = 0

        # Mirror ExperimentRun.run()'s construction exactly — the parity
        # contract depends on the two modes building identical worlds.
        self.env = Environment()
        self.meter = Meter(self.env, cluster.meta, clock=self.clock)
        self.cluster = cluster.clone(self.env, self.meter)
        self.scheduler = GlobalScheduler(
            self.env,
            self.cluster,
            policy,
            interval=interval,
            seed=seed,
            meter=self.meter,
            retry=retry,
            breaker=breaker,
            slo=self.slo,
            # Per-tick dispatch (fuse_spans=False): one decision latency
            # per dispatch, coalesced across sessions.  "slo" turns span
            # fusion on, each span bounded at the driver's release
            # frontier and metered once by the span tap below.
            fuse_spans=bool(fuse_spans),
        )
        self.cluster.start()
        self.scheduler.start()
        self._last_unfinished = 0
        self._install_decision_tap()
        if fuse_spans == "slo":
            self._install_span_tap()

    @property
    def batchable(self) -> bool:
        return _is_batchable(self.policy)

    def _install_decision_tap(self) -> None:
        """Wrap ``policy.place`` with the SLO decision-latency recorder.
        Measures the full wall duration of each placement call — batcher
        park time included, which is exactly the latency a caller of an
        online scheduler experiences."""
        orig = self.policy.place

        def timed_place(ctx):
            t0 = time.perf_counter()
            out = orig(ctx)
            dt = time.perf_counter() - t0
            arr = np.asarray(out)
            # Late-bound through the session: the driver swaps in the
            # service-wide SLO meter after construction.
            self.slo.record_decision(dt, int(arr.shape[0]),
                                     int((arr >= 0).sum()))
            if self.tracer.enabled:
                # The dispatch lane of the service timeline: one span
                # per placement call (batcher wait included) — what
                # obs_report's top-N slow dispatches ranks.
                self.tracer.record_span(
                    "dispatch", "place", dt, sim=ctx.env_now,
                    session=self.label, n_tasks=int(arr.shape[0]),
                    n_placed=int((arr >= 0).sum()),
                )
            # Per-tier attribution: the batch's latency counts toward
            # every tier with work in it (mixed-tier ticks are the
            # norm — a tier's histogram must see the latency its jobs
            # actually experienced).  Tier counts weight by tasks.
            tier_tasks = {}
            for t in ctx.tasks:
                tier = int(getattr(t.application, "_serve_tier", 0))
                tier_tasks[tier] = tier_tasks.get(tier, 0) + 1
            for tier, n in tier_tasks.items():
                self.slo.record_decision_tier(tier, dt, n_tasks=n)
            # Routing telemetry: EWMA over this session's recent calls.
            self.recent_decision_s = (
                0.8 * self.recent_decision_s + 0.2 * dt
            )
            # Degradation telemetry (device policies only): surface
            # kernel failures absorbed by the CPU-twin fallback and
            # ticks served degraded (``sched/tpu.py`` degrade_after).
            failures = getattr(self.policy, "kernel_failures", 0)
            if failures > self._kernel_failures_seen:
                self.slo.count(
                    "kernel_failures", failures - self._kernel_failures_seen
                )
                self._kernel_failures_seen = failures
            if getattr(self.policy, "degraded", False):
                self.slo.count("degraded_decisions")
            return out

        self.policy.place = timed_place

    def _install_span_tap(self) -> None:
        """Wrap ``policy.place_span`` with the SLO span recorder
        (``fuse_spans="slo"`` only): a served span is ONE dispatch, so it
        lands as one decision-latency sample plus the span length
        (``SloMeter.record_span_decision``); a declined span (None)
        records nothing — the per-tick path then serves the tick through
        the ordinary decision tap.  No-op for policies without a span
        tier (the numpy arms)."""
        orig = getattr(self.policy, "place_span", None)
        if orig is None:
            return

        def timed_place_span(ctx, plan):
            t0 = time.perf_counter()
            out = orig(ctx, plan)
            dt = time.perf_counter() - t0
            if out is None:
                return None
            k_dyn = plan.n_ticks
            n_placed = int((out.placements[:k_dyn] >= 0).sum())
            n_tasks = len(plan.slots)
            self.slo.record_span_decision(dt, k_dyn, n_tasks, n_placed)
            if self.tracer.enabled:
                self.tracer.record_span(
                    "dispatch", "place_span", dt, sim=ctx.env_now,
                    session=self.label, n_ticks=k_dyn, n_tasks=n_tasks,
                    n_placed=n_placed,
                )
            # Per-tier attribution, as the per-tick tap: the span's
            # latency counts toward every tier with slots in it.
            tier_tasks = {}
            for t in plan.slots:
                tier = int(getattr(t.application, "_serve_tier", 0))
                tier_tasks[tier] = tier_tasks.get(tier, 0) + 1
            for tier, n in tier_tasks.items():
                self.slo.record_decision_tier(tier, dt, n_tasks=n)
            self.recent_decision_s = 0.8 * self.recent_decision_s + 0.2 * dt
            return out

        self.policy.place_span = timed_place_span

    def attach_recovery(self, plane) -> None:
        """Wire the serve recovery plane into this session's
        dispatch path.  Three hooks, each honoring the write-ahead
        contract:

          * a ``span`` journal record is appended BEFORE each
            ``place_span`` dispatch, a ``splice`` record before each
            ``span_splice`` — the decision is durable-before-effective;
          * the snapshot cadence tap fires AFTER a span dispatch
            returns — the pending carry is the previous span's OUTPUT,
            the same safe window (before the next span consumes it) the
            resident mirror-diff reads in;
          * when the plane's watchdog is armed
            (``RecoveryConfig.dispatch_timeout_s``), the dispatch runs
            under its timeout + capped deterministic-backoff retries.

        Installed by the driver AFTER the session's own SLO taps, so
        the journal wraps the outermost dispatch surface — the latency
        the taps measure includes any watchdog retries, which is the
        latency the caller really experienced."""
        self._recovery = plane
        armed = plane.config.dispatch_timeout_s is not None
        orig_span = getattr(self.policy, "place_span", None)
        if orig_span is not None:

            def recovered_place_span(ctx, plan, _orig=orig_span):
                plane.journal_span(
                    self.label, ctx.env_now, plan.n_ticks,
                    len(plan.slots),
                )
                if armed:
                    out = plane.watchdog.guard(
                        lambda: _orig(ctx, plan),
                        key=f"{self.label}:span",
                    )
                else:
                    out = _orig(ctx, plan)
                if out is not None:
                    plane.note_span(self.policy)
                return out

            self.policy.place_span = recovered_place_span
        orig_splice = getattr(self.policy, "span_splice", None)
        if orig_splice is not None:

            def recovered_span_splice(ctx, plan, k, new_tasks,
                                      _orig=orig_splice):
                plane.journal_splice(
                    self.label, ctx.env_now, k, len(new_tasks)
                )
                out = _orig(ctx, plan, k, new_tasks)
                if out is not None:
                    plane.note_splice()
                return out

            self.policy.span_splice = recovered_span_splice
        if armed:
            orig_place = self.policy.place

            def guarded_place(ctx, _orig=orig_place):
                return plane.watchdog.guard(
                    lambda: _orig(ctx), key=f"{self.label}:place",
                )

            self.policy.place = guarded_place

    # -- driver-facing ----------------------------------------------------
    def offer(self, arrival: JobArrival) -> None:
        """Route one admitted arrival to this session (driver thread)."""
        self._inbox.put(arrival)

    def request_preempt(self, app) -> None:
        """Ask this session (driver thread) to cancel an admitted-but-
        unplaced app; answered asynchronously on the session thread."""
        self._inbox.put(PreemptRequest(app))

    @property
    def load(self) -> int:
        """Routing load signal: queued + live jobs on this session.
        Approximate by design (both ends mutate concurrently) — the
        least-loaded router only needs relative ordering."""
        return self._inbox.qsize() + len(self._live)

    def shutdown(self) -> None:
        self._inbox.put(STOP)

    # -- the session thread ----------------------------------------------
    def loop(self, client=None) -> None:
        """Thread body: wait for work, inject, drain, repeat until STOP."""
        try:
            while True:
                if client is not None:
                    client.set_idle(True)
                item = self._inbox.get()
                self.last_progress = time.perf_counter()
                if client is not None:
                    client.set_idle(False)
                if item is STOP or self.abandoned:
                    break
                if isinstance(item, PreemptRequest):
                    self._handle_preempt(item.app)
                    continue
                self._inject(item)
                self._drain(client)
        except BaseException as exc:  # noqa: BLE001 — surfaced by driver
            self.error = exc
            if self._driver is not None:
                self._driver.on_session_error(self, exc)
        finally:
            self.scheduler.stop()
            if client is not None:
                client.close()

    def _poll_inbox(self) -> None:
        while True:
            try:
                item = self._inbox.get_nowait()
            except queue.Empty:
                return
            if item is STOP:
                # Re-queue so the outer loop sees it after the drain.
                self._inbox.put(item)
                return
            if isinstance(item, PreemptRequest):
                self._handle_preempt(item.app)
                continue
            self._inject(item)

    def _handle_preempt(self, app) -> None:
        """Serve one preemption request on the session thread.  A hit
        requires the app to still be admitted-but-unplaced: either its
        submission callback has not fired yet (cancel it — the scheduler
        never saw the app) or every materialized task is still NASCENT
        (``GlobalScheduler.withdraw``).  Anything else — placed, running,
        finished, already reaped — is a miss; the job keeps its capacity
        and terminates through the normal paths."""
        ok = False
        if app in self._live:
            cb = getattr(app, "_serve_submit_cb", None)
            if cb is not None:
                # Submission still pending on the heap: cancel in place.
                cb.cancel()
                app._serve_submit_cb = None
                ok = True
            else:
                ok = self.scheduler.withdraw(app)
            if ok:
                self._live.remove(app)
                self._injected.remove(app)
        if self._driver is not None:
            self._driver.on_preempt_result(self, app, ok, self.env.now)

    def _inject(self, arrival: JobArrival) -> None:
        """Enter one job: submission scheduled at its sim-time instant,
        or immediately (a recorded *late injection*) when the session's
        clock has already passed it."""
        env = self.env
        app = arrival.app
        self._live.append(app)
        self._injected.append(app)
        app._serve_admit_ts = arrival.ts
        app._serve_tier = int(getattr(arrival, "tier", 0))
        app._serve_tenant = getattr(arrival, "tenant", "default")
        if self.tracer.enabled:
            trace = getattr(app, "_obs_trace", None)
            if trace is not None:
                self.tracer.stage(
                    trace, "injected",
                    sim=max(arrival.ts, env.now),
                    session=self.label, late=arrival.ts < env.now,
                )
        if arrival.ts >= env.now:
            # The callback handle rides on the app so an in-queue
            # preemption arriving before it fires can cancel the
            # submission outright (the cheapest possible victim).
            def _submit(app=app):
                app._serve_submit_cb = None
                self.scheduler.submit(app)

            app._serve_submit_cb = env.schedule_callback_at(
                arrival.ts, _submit
            )
        else:
            app._serve_submit_cb = None
            self.slo.count("late_injections")
            self.scheduler.submit(app)

    def _work_pending(self) -> bool:
        return bool(self._live)

    def _drain(self, client=None) -> None:
        env = self.env
        driver = self._driver
        while self._work_pending():
            if self.abandoned:
                return  # supervisor replaced this session mid-drain
            self._poll_inbox()
            t_next = env.peek()
            if t_next == float("inf"):
                break  # defensive: nothing scheduled at all
            if driver is not None and not driver.wait_released(
                self, t_next, client
            ):
                return  # shutdown requested mid-drain
            self._poll_inbox()  # arrivals routed while gated
            env.step()
            self.last_progress = time.perf_counter()
            if self.scheduler._n_unfinished != self._last_unfinished:
                self._last_unfinished = self.scheduler._n_unfinished
                self._reap_completions()
        # Close out the current instant (same-time meter/bookkeeping
        # events) so the idle state the session parks in is final.
        now = env.now
        while env.peek() <= now:
            env.step()
        self._reap_completions()

    def _reap_completions(self) -> None:
        done = [
            a for a in self._live
            if a.is_finished or getattr(a, "failed", False)
        ]
        if not done:
            return
        self._live = [a for a in self._live if a not in done]
        for app in done:
            if app.is_finished:
                self.completed.append(app)
                admit_ts = getattr(app, "_serve_admit_ts", app.start_time)
                self.slo.record_sojourn(
                    max(app.end_time - admit_ts, 0.0),
                    tier=int(getattr(app, "_serve_tier", 0)),
                )
            else:
                # Dead-lettered by retry governance: the job terminates
                # as failed — its admission capacity is still released
                # (the service must not wedge on a lost job).
                self.failed.append(app)
            if self._driver is not None:
                self._driver.on_completed(
                    self, app, self.env.now, failed=not app.is_finished
                )

    # -- reporting ---------------------------------------------------------
    def summary(self) -> dict:
        s = self.meter.summary()
        # Injection order, not completion order: the float sum must run
        # in the same order batch-mode ``ExperimentRun`` sums its
        # schedule, or avg_runtime drifts by an ULP (the parity test
        # compares exact values).
        runtimes = [
            a.end_time - a.start_time for a in self._injected
            if a.is_finished
        ]
        s["label"] = self.label
        s["n_apps"] = len(self.completed)
        s["avg_runtime"] = (
            sum(runtimes) / len(runtimes) if runtimes else 0.0
        )
        s["n_failed"] = len(self.failed)
        s["degraded"] = bool(getattr(self.policy, "degraded", False))
        # Span-fusion observability (fuse_spans="slo"): fused spans
        # served, ticks they covered, replay aborts, fast-forwarded
        # no-op ticks — all zero under per-tick dispatch.
        s["span_stats"] = dict(self.scheduler.span_stats)
        s["kernel_failures"] = int(
            getattr(self.policy, "kernel_failures", 0)
        )
        s["dead_letters"] = len(self.scheduler.dead_letters)
        return s
