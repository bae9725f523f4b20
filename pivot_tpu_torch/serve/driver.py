"""The stream driver: admission, routing, release gate, lifecycle.

Topology (docs/ARCHITECTURE.md "The online serving layer")::

    arrivals ──▶ AdmissionQueue ──▶ router (rr / least-loaded) ──▶ inboxes
    (Poisson /     (bounded, tiered;                               │ one
     trace-replay)  block/shed/spill                               ▼ thread
     × priority     + in-queue                           ServeSession event
       tiers)         preemption)                        loops │ placement
                                                               ▼ ticks
                                                   DispatchBatcher slots
                                              (idle-aware, deadline flush,
                                               autoscaler-resized)
                                                         │
                                                         ▼
                                           ONE [G]-vmapped device dispatch

The driver owns one condition variable that serializes every control
decision: admission (in-flight accounting + tier-ordered backpressure +
in-queue preemption), routing (deterministic round-robin by default —
what lets a served schedule be compared bit-for-bit against per-session
batch runs — or least-loaded over inbox depth + recent decision
latency), the **release gate** (sessions may not step an event past the
largest arrival timestamp the stream has revealed — an online scheduler
cannot simulate past "now"), completions (capacity release + spill
re-offers + closed-loop refill), pool resizing (supervisor restarts,
autoscaler grow/retire), and shutdown.

**Multi-tenant serving** (round 9): every arrival carries a priority
tier (0 = most important).  Under pressure the service *degrades, never
fails* (SpotServe, PAPERS.md): per-tier depth reservations and per-tier
backpressure policies shed/spill the low tiers first, and — with
``preempt=True`` — a high-tier arrival that would still degrade
preempts an admitted-but-unplaced lower-tier job instead: the victim is
cancelled on its session's thread (submission callback cancelled, or
``GlobalScheduler.withdraw`` if already submitted but never placed),
its capacity freed, and the victim requeued to the spill buffer, from
which it re-enters — original arrival order within its tier — once
pressure subsides.  Every preemption is metered per tier and reconciled
by the serve conservation audit (``infra/audit.py::audit_serve``):
every admitted or preempted job terminates exactly once.

Wall-clock pacing is optional (``pace`` sim-seconds per wall-second);
the default *replay* mode runs as fast as the sessions can step, which
is both the bench configuration and the deterministic one.

Port of ``pivot_tpu/serve/driver.py``: the supervisor, the stall
watchdog, tiers, preemption, routing, the autoscaler pool, ``report()``,
``audit()`` and ``publish_metrics()``, serve spans (each ``fuse_spans=
"slo"`` session's spans bounded at the release frontier), ragged span
batching (``ragged=True``, the default) and the resident pool
(``resident=True``: no batcher, each session's policy on its resident
carry, mid-span splices up to ``splice_tier``).  Where the reference
initialises its backend before any session thread starts, the port
initialises CUDA and builds and loads ``greedy_place`` on the caller's
thread (``policy.prepare()``), and warms the MPC's evaluator graphs up
there too (``MpcController.warmup``).  The model-predictive controller
(``mpc=``, ``pivot_tpu_torch.mpc``) and the recovery plane
(``recovery=``, ``pivot_tpu_torch.recover``) and the sampled dispatch
profiler (``profiler=``, ``pivot_tpu_torch.obs.DispatchProfiler``) are
the reference's, and so is the 2-D serving mesh (``mesh=``, a
``parallel.mesh.build_hybrid_mesh``): the shared batcher's flushes shard
their ``[G]`` rows over its replica axis and, for sessions whose
policies have ``enable_sharding`` on a matching host axis, each row's
hosts over its host axis (``sched/batch.py``).  On one card the mesh
names the card R·S times (logical shards).  Elastic serving
(``elastic=``, ``pivot_tpu_torch.serve.elastic``) is the reference's
too: a fault gate on every host-sharded session policy, a loss handled
by the supervisor's restart path, the replacement resharded onto the
surviving logical shards before its thread starts, and a regrow after a
shadow probe; an elastic pool runs without the batcher.
"""

from __future__ import annotations

import math
import queue as _pyqueue
import threading
from typing import Callable, Dict, Iterable, List, Optional

import time

from pivot_tpu_torch.infra.meter import SloMeter
from pivot_tpu_torch.obs import NULL_TRACER, ObsClock
from pivot_tpu_torch.utils import LogMixin

from pivot_tpu_torch.serve.admission import ADMITTED, BLOCKED, AdmissionQueue
from pivot_tpu_torch.serve.arrivals import JobArrival
from pivot_tpu_torch.serve.autoscale import AutoscaleConfig, SloAutoscaler
from pivot_tpu_torch.serve.session import STOP, PreemptRequest, ServeSession

__all__ = ["ServeDriver", "closed_loop_source"]

_ROUTINGS = ("rr", "least_loaded")


def _cluster_capacity(cluster) -> List[float]:
    """Total (cpus, mem, disk, gpus) of a cluster — the DRF dominant-
    share normalizer for tenant quotas (``serve/admission.py``)."""
    caps = [0.0, 0.0, 0.0, 0.0]
    for host in cluster.hosts:
        r = host.resource
        for i, dim in enumerate(("t_cpus", "t_mem", "t_disk", "t_gpus")):
            caps[i] += float(getattr(r, dim, 0.0) or 0.0)
    return caps


class _Inflight:
    """Ledger entry for one admitted job — what preemption victims are
    chosen from and what completions settle against."""

    __slots__ = ("app", "ts", "tier", "tenant", "seq", "session",
                 "requested", "preemptible", "dom")

    def __init__(self, app, ts, tier, tenant, seq, dom=1.0):
        self.app = app
        self.ts = ts
        self.tier = tier
        self.tenant = tenant
        self.seq = seq  # admission order (victim tie-break: youngest)
        self.session: Optional[ServeSession] = None
        self.requested = False  # a preempt request is in flight
        self.preemptible = True  # False after a miss (it placed/ran)
        #: Dominant share this admission charged against its tenant's
        #: DRF occupancy (1.0 when the quota is off) — what release
        #: gives back, surviving supervisor clones (the rec re-keys).
        self.dom = dom


class ServeDriver(LogMixin):
    """Always-on scheduling service over a (resizable) pool of sessions.

    **Session supervision** (round 7): when constructed with a
    ``session_factory``, the driver self-heals instead of fail-stopping —
    a session that crashes (its thread raises) or stalls past
    ``stall_timeout`` wall-seconds with live work is *abandoned*: its
    in-flight jobs (un-injected inbox arrivals plus a clone of every
    live, partially-run job) are requeued, a replacement session from the
    factory takes its place on a FRESH :class:`DispatchBatcher` slot
    (``respawn_client`` — the dead slot's state is never inherited), and
    the service keeps serving.  Requeued jobs retain their admission
    capacity across the restart: re-offering them past the backpressure
    bound could shed an already-admitted job, which would break the
    at-least-once contract the supervisor exists to provide; the
    admission queue still governs them (their completion releases
    capacity exactly once).  ``max_restarts`` bounds the recovery budget
    — exhausting it falls back to the fail-stop path.

    **Tiers, preemption, routing, autoscaling** (round 9): see the
    module docstring; all four knobs (``tier_reserve``/``tier_policies``,
    ``preempt``, ``routing``, ``autoscale``) default to off, under which
    the service is bit-identical to the single-tenant fixed-pool driver
    (the PR-2 parity tests run unmodified).
    """

    #: Wall seconds between capacity re-checks while a ``block``-policy
    #: producer (or a preempting admission) waits; each expiry also
    #: advances the release gate one scheduler tick so a blocked
    #: admission cannot freeze sim time.
    _BLOCK_POLL_S = 0.02

    def __init__(
        self,
        sessions: List[ServeSession],
        queue_depth: int = 64,
        backpressure: str = "shed",
        flush_after: Optional[float] = None,
        slo: Optional[SloMeter] = None,
        session_factory: Optional[Callable[[str], ServeSession]] = None,
        max_restarts: int = 2,
        stall_timeout: Optional[float] = None,
        tier_reserve=None,
        tier_policies=None,
        routing: str = "rr",
        preempt: bool = False,
        preempt_timeout: float = 5.0,
        autoscale: Optional[AutoscaleConfig] = None,
        mpc=None,
        tracer=None,
        registry=None,
        clock: Optional[ObsClock] = None,
        profiler=None,
        mesh=None,
        tenant_quota: Optional[float] = None,
        ragged: bool = True,
        resident: bool = False,
        splice_tier: int = 0,
        recovery=None,
        elastic=None,
    ):
        #: Elastic mesh serving (``serve/elastic.py``): ``elastic`` is an
        #: ``ElasticMeshManager``, an ``ElasticConfig``, a
        #: ``ChaosSchedule`` with device events, or None.  None — the
        #: default — builds nothing.  Otherwise the manager gates every
        #: session policy's dispatches against the device-fault plan: a
        #: covered dispatch raises ``DeviceLostError``, the supervisor
        #: requeues through its restart path, and the replacement is
        #: resharded onto the surviving shards before it serves.  An
        #: elastic pool runs resident or free, never on the batcher (its
        #: 2-D mesh is fixed at construction).
        self._elastic = None
        if elastic is not None:
            if mesh is not None:
                raise ValueError(
                    "elastic serving does not compose with the driver's "
                    "2-D batcher mesh (fixed at construction) — shard "
                    "the session policies instead (enable_sharding)"
                )
            if session_factory is None:
                raise ValueError(
                    "elastic serving needs a session_factory — a shrink "
                    "replaces the crashed session on the smaller mesh"
                )
            from pivot_tpu_torch.serve.elastic import (
                ElasticConfig,
                ElasticMeshManager,
            )

            if isinstance(elastic, ElasticMeshManager):
                self._elastic = elastic
            elif isinstance(elastic, ElasticConfig):
                self._elastic = ElasticMeshManager(elastic)
            else:  # a ChaosSchedule with device_fault / restore events
                self._elastic = ElasticMeshManager(
                    ElasticConfig(schedule=elastic))
        if not sessions:
            raise ValueError("ServeDriver needs at least one session")
        if stall_timeout is not None and stall_timeout <= 0:
            raise ValueError("stall_timeout must be positive (or None)")
        if routing not in _ROUTINGS:
            raise ValueError(
                f"unknown routing {routing!r} (use one of {_ROUTINGS})"
            )
        if preempt_timeout <= 0:
            raise ValueError("preempt_timeout must be positive")
        if autoscale is not None:
            if session_factory is None and autoscale.g_max > len(sessions):
                raise ValueError(
                    "autoscale growth (g_max > initial pool) needs a "
                    "session_factory"
                )
            if len(sessions) < autoscale.g_min:
                raise ValueError(
                    f"initial pool {len(sessions)} below autoscale.g_min "
                    f"{autoscale.g_min}"
                )
        if mpc is not None:
            if session_factory is None and mpc.g_max > len(sessions):
                raise ValueError(
                    "mpc growth (g_max > initial pool) needs a "
                    "session_factory"
                )
            if len(sessions) < mpc.g_min:
                raise ValueError(
                    f"initial pool {len(sessions)} below mpc.g_min "
                    f"{mpc.g_min}"
                )
        self.sessions = list(sessions)
        #: Observability plane (round 14).  ``tracer`` records the
        #: causal chain of every admitted job (arrival → admission →
        #: routing → injection → placement → completion) plus batcher
        #: flushes and autoscaler actions on the same timeline —
        #: ``None`` is the zero-cost NULL tracer, under which the
        #: service is bit-identical to the untraced driver (pinned by
        #: tests/test_obs.py replay parity).  ``registry`` receives the
        #: unified metrics snapshot at :meth:`report`.  ``clock`` is
        #: the one injected wall source the SLO meter reports through.
        self.tracer = tracer or NULL_TRACER
        self.registry = registry
        self.clock = clock or ObsClock()
        #: Sampled dispatch profiler (``obs/profiler.py``): attached to
        #: every device-backed session policy (direct dispatches) AND the
        #: shared batcher (coalesced flushes); its census lands in
        #: :meth:`publish_metrics` and :meth:`report`, its ``device``
        #: spans on the service trace timeline.  ``None`` = zero cost.
        self.profiler = profiler
        if profiler is not None and profiler.tracer is None:
            # Device spans land on the service-wide timeline unless the
            # caller attached a dedicated tracer explicitly.
            profiler.tracer = self.tracer
        self.slo = slo or SloMeter(clock=self.clock)
        #: DRF tenant fairness (round 17, ``serve/admission.py``): the
        #: dominant-share reference capacity is the first session's
        #: cluster totals — every session clones the same topology, and
        #: fairness only needs a consistent normalizer.
        capacity = None
        if tenant_quota is not None:
            capacity = _cluster_capacity(sessions[0].cluster)
        self.queue = AdmissionQueue(
            queue_depth, backpressure, self.slo,
            tier_reserve=tier_reserve, tier_policies=tier_policies,
            tenant_quota=tenant_quota, capacity=capacity,
        )
        self.flush_after = flush_after
        #: 2-D serving mesh: handed to the DispatchBatcher, so coalesced
        #: flushes shard ``[G]`` over ``replica`` and — for sessions whose
        #: policies have ``enable_sharding`` on — each row's hosts over
        #: ``host``.  ``None`` keeps the meshless flush.
        self.mesh = mesh
        self.routing = routing
        self.preempt = preempt
        self.preempt_timeout = preempt_timeout
        self.autoscale = autoscale
        self.interval = sessions[0].interval
        #: Ragged span batching: the batcher pads co-pending spans of
        #: different horizons into one (K′, B′) flush (``sched/batch.py``;
        #: equal results).  ``False`` keeps exact-shape coalescing — the
        #: A/B arm.
        self.ragged = bool(ragged)
        #: Resident span carries: every session policy keeps its [H] span
        #: state on the card between spans (``enable_resident``).  A
        #: flush re-stages every operand, so a resident pool runs its
        #: sessions free, without the batcher.  ``splice_tier`` gates
        #: mid-span admission: an arrival of at most this tier may join
        #: a running span (``GlobalScheduler.splice_gate``).
        self.resident = bool(resident)
        self.splice_tier = int(splice_tier)
        #: Crash-safe serving (``pivot_tpu_torch.recover``): ``recovery``
        #: is a ``RecoveryConfig`` or None.  None — the default — builds
        #: nothing and leaves the service bit-identical to the stack
        #: without it.  A config constructs the plane HERE (its
        #: write-ahead journal must be open before the first admission);
        #: the snapshot worker starts/stops inside :meth:`run`.
        self._recovery = None
        if recovery is not None:
            from pivot_tpu_torch.recover import RecoveryPlane

            self._recovery = RecoveryPlane(recovery, tracer=self.tracer)
        self.batcher = None
        self._cv = threading.Condition()
        self._released = 0.0
        self._stop = False
        #: Set (under the cv) once the stream has fully drained and the
        #: shutdown STOPs are being delivered: pool GROWTH past this
        #: point would spawn a session nobody ever stops (run()'s join
        #: loop would spin on it forever), so grow_pool refuses and a
        #: supervisor replacement immediately queues its own STOP
        #: behind the requeued jobs.
        self._draining = False
        self._errors: List[BaseException] = []
        self._rr = 0
        self._completion_hooks: List[Callable] = []
        #: Admission ledger: app.id -> _Inflight for every job currently
        #: holding queue capacity (preemption victims come from here).
        self._inflight: Dict[str, _Inflight] = {}
        self._admit_seq = 0
        #: Tier of the arrival the producer is currently parked on (the
        #: preempt dance / block wait): spill re-offers must not hand
        #: freed capacity to anything less important, or a preempted
        #: victim would re-enter the instant its preemption freed the
        #: slot it was preempted FOR (livelock).
        self._waiting_tier: Optional[int] = None
        self._preempt_outstanding = 0
        #: Supervisor state (inert when ``session_factory`` is None).
        self._session_factory = session_factory
        self._max_restarts = max_restarts
        self.stall_timeout = stall_timeout
        self._restarts = 0
        self._n_grown = 0
        #: (session, thread) for every session thread ever spawned.
        self._threads: List = []
        self._abandoned: List[ServeSession] = []
        self._retired: List[ServeSession] = []
        self._autoscaler: Optional[SloAutoscaler] = None
        self._watch_stop = threading.Event()
        #: Model-predictive serving (``pivot_tpu_torch.mpc``): the config
        #: is an ``MpcConfig`` or None.  ``None`` — the default — never
        #: imports the package, starts no thread, and leaves the reactive
        #: driver bit-identical.  The controller is built (and warmed up)
        #: in :meth:`run` before any serving thread starts, so ``_mpc`` is
        #: set-once-then-read (no lock).
        self.mpc = mpc
        self._mpc = None
        for slot, s in enumerate(self.sessions):
            s._driver = self
            s.slot = slot
            s.slo = self.slo  # one service-wide SLO meter
            s.scheduler.slo = self.slo  # dead-letter sheds land here too
            s.tracer = self.tracer  # one service-wide trace timeline
            s.scheduler.tracer = self.tracer
            # ONE wall epoch service-wide: the sessions' run meters
            # report through the driver's clock, so their wall
            # snapshots agree with the SLO meter's (the round-14
            # clock-unification contract).
            s.clock = self.clock
            s.meter.clock = self.clock
            if getattr(s, "fuse_spans", False) == "slo":
                # The SLO-checkpoint span bound: spans end at the
                # stream's revealed frontier (serve/session.py).
                s.scheduler.span_horizon = self.release_frontier
            if self.profiler is not None and hasattr(
                s.policy, "enable_profiler"
            ):
                s.policy.enable_profiler(self.profiler)

    def release_frontier(self) -> float:
        """The admission window's edge: the largest sim instant the
        arrival stream has revealed (∞ once it drains) — what
        ``fuse_spans="slo"`` sessions bound their spans at
        (``GlobalScheduler.span_horizon``)."""
        with self._cv:
            return self._released

    # -- gate + coordination ----------------------------------------------
    def wait_released(self, session: ServeSession, t: float,
                      client=None) -> bool:
        """Block ``session`` until the release frontier reaches sim time
        ``t`` (or new work lands in its inbox, or shutdown).  The
        session's batcher slot is marked idle for the duration so gated
        sessions never park co-pending dispatches.  Returns False on
        shutdown."""
        with self._cv:
            if self._released >= t or not session._inbox.empty():
                return not self._stop
            if client is not None:
                client.set_idle(True)
            try:
                self._cv.wait_for(
                    lambda: (
                        self._stop
                        or self._released >= t
                        or not session._inbox.empty()
                    )
                )
            finally:
                if client is not None:
                    client.set_idle(False)
            return not self._stop

    def _release_to(self, ts: float) -> None:
        if ts > self._released:
            self._released = ts
            self._cv.notify_all()

    def _next_tick(self, t: float) -> float:
        return (math.floor(t / self.interval) + 1) * self.interval

    def advance_gate(self) -> None:
        """Let sim time flow one scheduler tick with no new arrivals —
        the "time passes while we wait" primitive behind block-mode
        admission and the closed-loop load generator (both wait on
        completions that can only happen if the sessions may advance)."""
        with self._cv:
            if self._released != float("inf"):
                self._release_to(self._next_tick(self._released))

    # -- completions -------------------------------------------------------
    def add_completion_hook(self, fn: Callable) -> None:
        """``fn(session, app, sim_now)`` after every job completion —
        the closed-loop load generator's refill tap."""
        self._completion_hooks.append(fn)

    def on_completed(self, session: ServeSession, app, sim_now: float,
                     failed: bool = False):
        if session.abandoned:
            return  # a replaced session's stale thread reporting late
        with self._cv:
            rec = self._inflight.pop(app.id, None)
            tier = (
                rec.tier if rec is not None
                else int(getattr(app, "_serve_tier", 0))
            )
            self._release_one(rec, app, tier)
            key = "failed_jobs" if failed else "completed"
            self.slo.count(key)
            self.slo.count_tier(tier, key)
            if self.tracer.enabled:
                self._stage(app, "failed" if failed else "completed",
                            sim=sim_now, session=session.label)
            self._reoffer_spilled(after_sim=sim_now)
            self._cv.notify_all()
        for fn in self._completion_hooks:
            fn(session, app, sim_now)

    def _release_one(self, rec: Optional[_Inflight], app, tier: int) -> None:
        """Free one settled admission's capacity AND its tenant's DRF
        occupancy (cv held).  The (tenant, dominant share) pair comes
        from the ledger record when one survives, else from the app's
        cached share — either way the exact values the admission
        charged, so the occupancy ledger drains to zero
        (``audit_serve``)."""
        if rec is not None:
            tenant, share = rec.tenant, rec.dom
        else:
            tenant = getattr(app, "_serve_tenant", "default")
            share = getattr(app, "_serve_dom_share", None)
        self.queue.release(tier=tier, tenant=tenant, share=share)

    def on_session_error(self, session: ServeSession, exc) -> None:
        if session.abandoned:
            return  # already replaced by the supervisor; nothing to do
        # Snapshot the routing decision's inputs under the cv
        # (graftcheck thread-guard: unlocked reads of _stop/_restarts
        # here raced the producer's stop and concurrent crash handlers).
        # The snapshot is advisory — _restart_session re-validates the
        # stop flag AND the restart budget under the cv and reports a
        # lost race by returning False, in which case we fall through
        # to the fail-stop path below.
        with self._cv:
            stopped = self._stop
            can_restart = (
                self._session_factory is not None
                and self._restarts < self._max_restarts
            )
        if self._elastic is not None:
            from pivot_tpu_torch.serve.elastic import is_device_loss

            if is_device_loss(exc):
                # A mesh-level loss: record it, then let the supervisor
                # path below replace the session — _wire_and_start
                # reshards the replacement onto the survivors, and
                # _requeue sends its in-flight work back through the
                # admission queue (tier 0 first).
                self._elastic.note_loss(exc, session.label)
                self.slo.count("device_losses")
        if session.retiring and not stopped:
            # A crash DURING a scale-down drain: the retire was already
            # decided — settle it (requeue the in-flight jobs onto the
            # surviving pool, retire the slot exactly once) instead of
            # spawning a replacement we were about to drain anyway.
            self.logger.error(
                "session %s crashed mid-retire (%s) — settling retire",
                session.label, exc,
            )
            self._retire_crashed(session, close_client=False)
            return
        if can_restart and not stopped:
            self.logger.error(
                "session %s crashed (%s) — supervisor restarting",
                session.label, exc,
            )
            if self._restart_session(session, close_client=False):
                return
            if session.abandoned:
                return  # a concurrent handler replaced it first
        with self._cv:
            self._errors.append(exc)
            self._stop = True
            survivors = list(self.sessions) + list(self._abandoned)
            self._cv.notify_all()
        for s in survivors:
            s.shutdown()

    # -- the session supervisor --------------------------------------------
    def _recover_inflight(self, dead: ServeSession) -> List[JobArrival]:
        """Harvest a dead/retiring-crashed session's recoverable work
        (cv held): un-injected inbox arrivals keep their original
        timestamps and app objects; live (possibly partially-run) jobs
        are resubmitted as clones — the dead session's world is gone, so
        their execution restarts, but their admission capacity is
        retained (see class docstring).  Jobs that terminated inside the
        dead session but were never reaped are settled here — the
        abandoned thread's late reap is ignored by ``on_completed``, so
        skipping them would leak a queue slot per restart.  Pending
        preempt requests addressed to the dead session resolve as
        misses."""
        lost: List[JobArrival] = []
        while True:
            try:
                item = dead._inbox.get_nowait()
            except _pyqueue.Empty:
                break
            if item is STOP:
                continue
            if isinstance(item, PreemptRequest):
                self._preempt_outstanding -= 1
                self.slo.count("preempt_misses")
                rec = self._inflight.get(item.app.id)
                if rec is not None:
                    rec.requested = False
                continue
            lost.append(item)
        for app in dead._live:
            rec = self._inflight.pop(app.id, None)
            tier = (
                rec.tier if rec is not None
                else int(getattr(app, "_serve_tier", 0))
            )
            if app.is_finished or getattr(app, "failed", False):
                self._release_one(rec, app, tier)
                key = "completed" if app.is_finished else "failed_jobs"
                self.slo.count(key)
                self.slo.count_tier(tier, key)
                if self.tracer.enabled:
                    # Anchored at the dead session's sim clock: a
                    # sim-less terminal would export on the wall
                    # fallback BEFORE its sim-anchored parent and fail
                    # the obs_report --check parent-ordering gate.
                    self._stage(
                        app, "completed" if app.is_finished else "failed",
                        sim=dead.env.now, session=dead.label,
                        late_reap=True,
                    )
                continue
            ts = getattr(app, "_serve_admit_ts", 0.0)
            clone = app.clone()
            trace = self._trace_of(app)
            if trace is not None:
                # The clone continues the SAME causal chain — its
                # restart stages parent-link onto the dead session's.
                clone._obs_trace = trace
            if rec is not None:
                rec.app = clone
                rec.requested = False
                self._inflight[clone.id] = rec
            lost.append(
                JobArrival(
                    ts, clone, tier=tier,
                    tenant=getattr(app, "_serve_tenant", "default"),
                )
            )
        return lost

    def _requeue(self, lost: List[JobArrival]) -> None:
        """Route recovered jobs back into the pool (cv held), submission
        times never before the release frontier's next tick (a
        readmission cannot land in a session's past)."""
        floor_t = (
            self._released if self._released != float("inf") else None
        )
        for arr in lost:
            ts = (
                arr.ts if floor_t is None
                else max(arr.ts, self._next_tick(floor_t))
            )
            self.slo.count("requeued")
            if self.tracer.enabled:
                self._stage(arr.app, "requeued", sim=ts)
            self._route(
                JobArrival(ts, arr.app, tier=arr.tier, tenant=arr.tenant)
            )

    def _restart_session(self, dead: ServeSession,
                         close_client: bool) -> bool:
        """Replace a crashed/stalled session: requeue its in-flight jobs
        into a factory-fresh session on a fresh batcher slot.  Called
        from the dying session's own thread (crash path — its client
        closes itself in the loop's ``finally``) or from the watchdog
        (stall path — ``close_client=True``, the stalled thread may never
        reach its finally).  Returns False without acting when the
        restart lost a race — service stopped, session already replaced,
        or the recovery budget consumed by a CONCURRENT crash between
        the caller's check and this cv acquisition (the budget is
        re-validated here, under the cv, authoritatively); the caller
        then falls back to its no-restart path.

        Stall-path caveat (best effort by design): the wedged thread may
        still be mid-``env.step`` while this reads ``dead._live`` and
        clones its apps — Python threads cannot be paused, so a
        truly-concurrent mutation can tear a clone.  The crash path (the
        common case) has no such window: the dying thread is parked in
        its own except handler while it runs this."""
        with self._cv:
            if (
                self._stop or dead.abandoned
                or self._restarts >= self._max_restarts
            ):
                return False
            dead.abandoned = True
            self._restarts += 1
            self._abandoned.append(dead)
            self.slo.count("session_restarts")
            idx = self.sessions.index(dead)
            lost = self._recover_inflight(dead)
            self._reoffer_spilled()
            new = self._session_factory(f"{dead.label}-r{self._restarts}")
            new.slot = dead.slot
            self.sessions[idx] = new
            self._wire_and_start(new)
            self._requeue(lost)
            if self._draining:
                # The stream-end STOPs already went out; this
                # replacement must stop itself once the requeued jobs
                # (FIFO ahead of the STOP in its inbox) have drained.
                new.shutdown()
            self._cv.notify_all()
        # Unblock the dead session outside the lock: wake it if parked on
        # its inbox (it sees ``abandoned`` and exits), and reclaim its
        # batcher slot on the stall path.
        dead.shutdown()
        if close_client and getattr(dead, "_client", None) is not None:
            dead._client.close()
        return True

    def _wire_and_start(self, new: ServeSession) -> None:
        """Attach a factory session to the service and start its thread
        (cv held): service-wide SLO meter, a FRESH batcher slot when the
        pool is batched, thread registration.  Shared by the supervisor
        restart path and the autoscaler grow path — pool membership
        (``self.sessions``) is the caller's business."""
        new._driver = self
        new.slo = self.slo
        new.scheduler.slo = self.slo
        new.tracer = self.tracer
        new.scheduler.tracer = self.tracer
        new.clock = self.clock  # one wall epoch service-wide
        new.meter.clock = self.clock
        if getattr(new, "fuse_spans", False) == "slo":
            new.scheduler.span_horizon = self.release_frontier
        if self.profiler is not None and hasattr(
            new.policy, "enable_profiler"
        ):
            new.policy.enable_profiler(self.profiler)
        client = None
        if self.batcher is not None:
            client = self.batcher.respawn_client()
            new.policy.enable_batching(client)
            new.slot = client.slot
        elif self.resident:
            self._enable_resident(new)
        new._client = client
        if self._recovery is not None:
            # Supervisor replacements and MPC / autoscaler growth join the
            # recovery plane too — a restarted session's spans journal
            # and snapshot exactly like the original's.
            new.attach_recovery(self._recovery)
        if self._elastic is not None:
            # The factory-fresh policy is gated AND resharded onto the
            # current surviving-shard mesh here, before its thread
            # starts, or its first gated dispatch would hit the same
            # window and burn another restart.
            self._elastic.attach(new.policy)
        thread = threading.Thread(
            target=new.loop, args=(client,),
            name=f"serve-{new.label}", daemon=True,
        )
        self._threads.append((new, thread))
        thread.start()

    def _watchdog(self) -> None:
        """Stall detector: a session with live work whose event loop has
        not stepped for ``stall_timeout`` wall-seconds is declared dead
        and replaced (its wedged thread is abandoned — Python threads
        cannot be killed — and ignored when it eventually wakes)."""
        poll = self.stall_timeout / 4.0
        while not self._watch_stop.wait(poll):
            # graftcheck: ignore[thread-guard] -- monotonic stop flag; a stale read costs one extra poll, and the replace paths re-check under the cv
            if self._stop:
                return
            now = time.perf_counter()
            # graftcheck: ignore[thread-guard] -- snapshot iteration: list() copies under the GIL; pool surgery happens under the cv, so the worst case is judging a just-replaced session one poll late
            for s in list(self.sessions):
                if s.abandoned or s.error is not None or not s._live:
                    continue
                if now - s.last_progress <= self.stall_timeout:
                    continue
                if s.retiring:
                    # Wedged mid-retire: settle the retire, requeue.
                    self.logger.error(
                        "session %s stalled mid-retire — settling",
                        s.label,
                    )
                    self._retire_crashed(s, close_client=True)
                    continue
                if (
                    self._session_factory is None
                    # graftcheck: ignore[thread-guard] -- advisory budget read; _restarts only grows, so a stale value can at worst defer fail-stop by one poll (on_session_error re-reads it under the cv)
                    or self._restarts >= self._max_restarts
                ):
                    self.on_session_error(
                        s,
                        RuntimeError(
                            f"session {s.label} stalled "
                            f"> {self.stall_timeout}s with live work"
                        ),
                    )
                    return
                self.logger.error(
                    "session %s stalled > %.3fs — supervisor restarting",
                    s.label, self.stall_timeout,
                )
                self._restart_session(s, close_client=True)

    # -- autoscaler pool surgery -------------------------------------------
    def policy_pool(self) -> List:
        """``[(label, policy)]`` snapshot of the active pool (retiring
        and abandoned excluded) — the MPC rollout's promotion surface.
        The list is a snapshot; the policy objects are live (attribute
        swaps via ``Policy.apply_weights`` take effect on the session's
        next decision)."""
        with self._cv:
            return [
                (s.label, s.policy)
                for s in self.sessions
                if not s.retiring and not s.abandoned
            ]

    def pool_size(self) -> int:
        """Sessions currently accepting work (retiring excluded)."""
        with self._cv:
            return len(
                [s for s in self.sessions if not s.retiring]
            )

    def grow_pool(self, reason: str = "") -> bool:
        """Add one factory session to the pool (autoscaler thread)."""
        with self._cv:
            if (
                self._stop or self._draining
                or self._session_factory is None
            ):
                return False
            # Un-retire in preference to spawning: a session still
            # draining is warm capacity we were about to throw away.
            for s in self.sessions:
                if s.retiring and not s._retired and not s.abandoned:
                    s.retiring = False
                    self.slo.count("scale_up_events")
                    self.logger.info(
                        "autoscaler un-retired %s (%s)", s.label, reason
                    )
                    self._cv.notify_all()
                    return True
            self._n_grown += 1
            new = self._session_factory(f"scale-{self._n_grown}")
            new.slot = len(self.sessions)
            self.sessions.append(new)
            self._wire_and_start(new)
            self.slo.count("scale_up_events")
            self.logger.info(
                "autoscaler grew pool to %d (%s)",
                len(self.sessions), reason,
            )
            self._cv.notify_all()
        return True

    def begin_retire(self) -> Optional[ServeSession]:
        """Mark the least-loaded session retiring (drain-then-retire);
        the router stops feeding it immediately, the autoscaler
        finalizes once its live set drains.  Returns the victim, or
        None when no session can be spared."""
        with self._cv:
            active = [
                s for s in self.sessions
                if not s.retiring and not s.abandoned
            ]
            if self._stop or len(active) <= 1:
                return None
            victim = min(
                active, key=lambda s: (s.load, -s.slot)
            )
            victim.retiring = True
            self.slo.count("scale_down_events")
            self._cv.notify_all()
            return victim

    def finish_drained_retires(self) -> int:
        """Finalize every retiring session whose drain completed: STOP
        its loop (closing its batcher slot), move it to the retired
        list.  Idempotent; returns how many were finalized."""
        done: List[ServeSession] = []
        with self._cv:
            for s in list(self.sessions):
                if (
                    s.retiring and not s._retired and not s.abandoned
                    and not s._live and s._inbox.empty()
                ):
                    s._retired = True
                    self.sessions.remove(s)
                    self._retired.append(s)
                    done.append(s)
            if done:
                self._cv.notify_all()
        for s in done:
            s.shutdown()
        return len(done)

    def _retire_crashed(self, dead: ServeSession,
                        close_client: bool) -> None:
        """A retiring session crashed/stalled before its drain finished:
        complete the retire exactly once — requeue its in-flight jobs
        onto the surviving pool (capacity retained, same contract as a
        supervisor restart) and retire the slot, WITHOUT spawning a
        replacement (the pool was shrinking)."""
        with self._cv:
            if self._stop or dead.abandoned or dead._retired:
                return
            dead.abandoned = True
            dead._retired = True
            self._abandoned.append(dead)
            if dead in self.sessions:
                self.sessions.remove(dead)
            lost = self._recover_inflight(dead)
            self._requeue(lost)
            self._reoffer_spilled()
            self._cv.notify_all()
        dead.shutdown()
        if close_client and getattr(dead, "_client", None) is not None:
            dead._client.close()

    # -- in-queue preemption -----------------------------------------------
    def _try_preempt(self, tier: int) -> bool:
        """Request preemption of the least important, youngest
        admitted-but-unplaced job of a tier strictly below ``tier``
        (cv held).  Returns True when a request was dispatched."""
        victim: Optional[_Inflight] = None
        for rec in self._inflight.values():
            if (
                rec.tier <= tier or rec.requested or not rec.preemptible
                or rec.session is None or rec.session.abandoned
            ):
                continue
            if victim is None or (rec.tier, rec.seq) > (
                victim.tier, victim.seq
            ):
                victim = rec
        if victim is None:
            return False
        victim.requested = True
        self._preempt_outstanding += 1
        self.slo.count("preempt_requests")
        victim.session.request_preempt(victim.app)
        self._cv.notify_all()
        return True

    def on_preempt_result(self, session: ServeSession, app, ok: bool,
                          sim_now: float) -> None:
        """A session answered a preempt request (session thread).  A hit
        frees the victim's capacity and requeues it to the spill buffer
        (metered ``preempted``/``preempt_requeued``, NOT as a fresh
        spill); a miss marks the record non-preemptible so the victim
        search never retries it."""
        with self._cv:
            self._preempt_outstanding -= 1
            rec = self._inflight.get(app.id)
            if rec is None:
                # Completed (and settled) before the request landed.
                self.slo.count("preempt_misses")
                self._cv.notify_all()
                return
            rec.requested = False
            if not ok:
                rec.preemptible = False
                self.slo.count("preempt_misses")
                self._cv.notify_all()
                return
            del self._inflight[app.id]
            self._release_one(rec, app, rec.tier)
            self.slo.count("preempted")
            self.slo.count_tier(rec.tier, "preempted")
            if self.tracer.enabled:
                self._stage(app, "preempted", sim=sim_now,
                            tier=rec.tier)
            # Requeue-to-spill with the ORIGINAL arrival timestamp; the
            # re-offer path floors it to the next grid tick when it
            # finally readmits.  The app object is reused as-is — it
            # never executed (that is what made it a victim), so no
            # session state refers to it.
            self.queue.spill(
                JobArrival(rec.ts, rec.app, tier=rec.tier,
                           tenant=rec.tenant),
                count=False,
            )
            self.slo.count("preempt_requeued")
            self._cv.notify_all()

    def shed_pressure(self, tier: int) -> bool:
        """Autoscaler tap: at g_max with the SLO still breached, preempt
        one admitted-but-unplaced job below ``tier``."""
        if not self.preempt:
            return False
        with self._cv:
            if self._stop:
                return False
            return self._try_preempt(tier)

    # -- spill + routing ---------------------------------------------------
    def _reoffer_spilled(self, after_sim: Optional[float] = None) -> None:
        """Drain the spill buffer into freed capacity (cv held), in
        (tier, original arrival order).  A spilled job's submission
        lands no earlier than the scheduler grid point after the instant
        that freed its slot — the "spill to next tick" contract.
        ``after_sim`` is the freeing completion's sim time; the
        belt-and-braces call sites without one fall back to the release
        frontier so a readmission can never land in a session's past.
        While an admission is parked waiting for capacity, tiers less
        important than it stay spilled — the head check suffices because
        the buffer is tier-ordered."""
        while self.queue.spilled:
            # Pick the first admissible entry in (tier, arrival) order.
            # Room and the waiting-tier gate stop the scan (both are
            # monotone in buffer order); a QUOTA-blocked entry is
            # skipped instead — its tenant's occupancy blocking other
            # tenants' admissible jobs behind it would waste idle
            # capacity on fairness (the work-conserving contract;
            # review finding, round 17).  Quota off ⇒ the head is
            # always picked ⇒ bit-identical to the pre-quota loop.
            picked = None
            for i, arr in enumerate(self.queue.spilled):
                if (
                    self._waiting_tier is not None
                    and arr.tier > self._waiting_tier
                ):
                    break
                if not self.queue.has_room(arr.tier):
                    # Capacity frees on completions, and every
                    # completion re-runs this loop.
                    break
                if self.queue.over_quota(arr):
                    continue
                picked = i
                break
            if picked is None:
                break
            arr = self.queue.pop_spill(picked)
            floor_t = after_sim
            if floor_t is None and self._released != float("inf"):
                floor_t = self._released
            if floor_t is not None:
                arr = JobArrival(
                    max(arr.ts, self._next_tick(floor_t)), arr.app,
                    tier=arr.tier, tenant=arr.tenant,
                )
            self.queue.readmit(arr)
            if self.tracer.enabled:
                self._stage(arr.app, "readmitted", sim=arr.ts,
                            tier=arr.tier)
            self._register_inflight(arr)
            self._route(arr)

    def _register_inflight(self, arrival: JobArrival) -> None:
        """Ledger a freshly admitted/readmitted arrival (cv held)."""
        self._admit_seq += 1
        self._inflight[arrival.app.id] = _Inflight(
            arrival.app, arrival.ts, arrival.tier, arrival.tenant,
            self._admit_seq,
            dom=getattr(arrival.app, "_serve_dom_share", 1.0),
        )

    def _route(self, arrival: JobArrival) -> None:
        eligible = [
            s for s in self.sessions
            if not s.retiring and not s.abandoned
        ]
        if not eligible:  # every session retiring: least bad fallback
            eligible = [s for s in self.sessions if not s.abandoned]
        if not eligible:
            eligible = self.sessions
        if self.routing == "least_loaded":
            # Primary: queued + live jobs; tie-break: recent decision
            # latency EWMA, then slot order (deterministic given equal
            # telemetry — which is why "rr" stays the parity default).
            target = min(
                eligible,
                key=lambda s: (s.load, s.recent_decision_s, s.slot),
            )
        else:
            target = eligible[self._rr % len(eligible)]
            self._rr += 1
        rec = self._inflight.get(arrival.app.id)
        if rec is not None:
            rec.session = target
        if self.tracer.enabled:
            # Emitted BEFORE the inbox put: the session's "injected"
            # stage happens-after this append, so the chain order is
            # routed → injected on every interleaving.  Anchored at the
            # arrival's sim instant — the routing decision is part of
            # the admission instant on the sim timeline.
            self._stage(arrival.app, "routed", sim=arrival.ts,
                        session=target.label, slot=target.slot)
        target.offer(arrival)
        self._cv.notify_all()

    # -- admission ---------------------------------------------------------
    def _trace_of(self, app) -> Optional[int]:
        return getattr(app, "_obs_trace", None)

    def _stage(self, app, name: str, sim: Optional[float] = None,
               **args) -> None:
        """Causal-trace hook: one parent-linked stage of ``app``'s job
        chain (no-op when tracing is off or the app carries no trace —
        e.g. jobs admitted before a tracer was attached)."""
        trace = getattr(app, "_obs_trace", None)
        if trace is not None:
            self.tracer.stage(trace, name, sim=sim, **args)

    def _admit(self, arrival: JobArrival) -> None:
        tier = int(getattr(arrival, "tier", 0))
        if self._recovery is not None:
            # Write-ahead: the admission is journaled BEFORE any effect
            # (gate release, queue offer, routing) — after a crash the
            # journal tail is exactly the set of arrivals the dead
            # server had committed to.
            self._recovery.journal_admit(arrival)
        if self._mpc is not None:
            # Forecast tap: sim timestamp + tier, before any admission
            # verdict — shed/spilled arrivals are still demand.
            self._mpc.forecaster.observe(arrival.ts, tier)
        if self.tracer.enabled:
            # Trace ids are allocated in admission order (the producer
            # thread is the only allocator), so replaying a seeded
            # stream yields the same ids.  The id rides on the app —
            # every later layer (router, session, scheduler) links its
            # stages through it.
            trace = self.tracer.new_trace()
            arrival.app._obs_trace = trace
            self.tracer.stage(
                trace, "arrived", sim=arrival.ts, tier=tier,
                tenant=getattr(arrival, "tenant", "default"),
                app=arrival.app.id,
            )
        with self._cv:
            # An arrival at ts proves the stream silent before ts: time
            # may flow to it even while admission deliberates.
            self._release_to(arrival.ts)
            self._reoffer_spilled()
            if (
                self.preempt
                and not self.queue.has_room(tier)
                and not self._stop
            ):
                self._preempt_for(tier)
            status = self.queue.offer(arrival)
            if self.tracer.enabled:
                self._stage(arrival.app, status, sim=arrival.ts)
            try:
                self._waiting_tier = tier
                while (
                    status == BLOCKED
                    and not self._stop and not self._errors
                ):
                    self.slo.count("blocked_waits")
                    notified = self._cv.wait(timeout=self._BLOCK_POLL_S)
                    if not notified and self._released != float("inf"):
                        # No completion freed capacity: advance sim time
                        # one tick so in-flight work can progress.
                        self._release_to(
                            self._next_tick(self._released)
                        )
                    if self.preempt and not self.queue.has_room(tier):
                        # Keep one preempt request in flight while
                        # victims remain — block-policy high tiers drain
                        # the low tiers rather than waiting them out.
                        if self._preempt_outstanding == 0:
                            self._try_preempt(tier)
                    if self.queue.readmit(arrival):
                        # readmit re-checks room AND the tenant quota
                        # (a blocked over-quota arrival waits for its
                        # tenant's occupancy to drain, not just depth).
                        status = ADMITTED
                        if self.tracer.enabled:
                            self._stage(arrival.app, "admitted",
                                        sim=arrival.ts, after="blocked")
            finally:
                self._waiting_tier = None
            if status == ADMITTED:
                self._register_inflight(arrival)
                self._route(arrival)

    def _preempt_for(self, tier: int) -> None:
        """The preempt dance (cv held): keep a preemption in flight and
        wait — bounded by ``preempt_timeout`` wall seconds — until the
        arrival's tier has room or victims run out.  Falls back to the
        tier's configured backpressure policy on exhaustion."""
        deadline = time.perf_counter() + self.preempt_timeout
        self._waiting_tier = tier
        try:
            requested = self._try_preempt(tier)
            while (
                requested
                and not self.queue.has_room(tier)
                and not self._stop and not self._errors
                and time.perf_counter() < deadline
            ):
                notified = self._cv.wait(timeout=self._BLOCK_POLL_S)
                if not notified and self._released != float("inf"):
                    # Victim sessions may be gated: let sim time flow so
                    # their threads reach the preempt request.
                    self._release_to(self._next_tick(self._released))
                if (
                    self._preempt_outstanding == 0
                    and not self.queue.has_room(tier)
                ):
                    requested = self._try_preempt(tier)
        finally:
            self._waiting_tier = None

    def _produce(self, arrivals: Iterable[JobArrival],
                 pace: Optional[float]) -> None:
        wall0 = time.perf_counter()
        try:
            for arr in arrivals:
                # graftcheck: ignore[thread-guard] -- monotonic stop flag polled between admissions; _admit re-checks under the cv before blocking
                if self._stop:
                    return
                if pace:
                    lag = arr.ts / pace - (time.perf_counter() - wall0)
                    if lag > 0:
                        time.sleep(lag)
                self._admit(arr)
            # Stream exhausted: reveal the open horizon, wait for the
            # admitted work (and any spilled stragglers) to drain.
            with self._cv:
                self._release_to(float("inf"))
                while not self._stop and not self._errors and (
                    self.queue.in_flight > 0 or self.queue.spilled
                ):
                    self._reoffer_spilled()
                    if self.queue.in_flight == 0 and not self.queue.spilled:
                        break
                    self._cv.wait(timeout=0.5)
        except BaseException as exc:  # noqa: BLE001 — surfaced by run()
            with self._cv:
                self._errors.append(exc)
                self._stop = True
                self._cv.notify_all()
        finally:
            with self._cv:
                self._release_to(float("inf"))
                self._draining = True
                # Snapshot under the cv: grow_pool refuses once
                # _draining is set, so this list is the final pool.
                pool = list(self.sessions)
            for s in pool:
                s.shutdown()

    def _splice_gate(self, task) -> bool:
        """Mid-span admission predicate of every session's scheduler:
        only arrivals at or below ``splice_tier`` may join a running
        span; the rest wait for the span's end."""
        return (int(getattr(task.application, "_serve_tier", 0))
                <= self.splice_tier)

    def _enable_resident(self, s: ServeSession) -> None:
        """(cv held) The resident span tier for one session: the carry on
        its policy, the tier-gated splice on its scheduler.  Policies
        without the tier (the numpy arms) serve per-tick regardless."""
        if hasattr(s.policy, "enable_resident"):
            s.policy.enable_resident()
            s.scheduler.splice_gate = self._splice_gate

    def _batching_compatible(self) -> bool:
        """(cv held) Whether the pool can share a DispatchBatcher
        (``pivot_tpu/serve/driver.py:1224-1256``): every policy batchable
        (device-backed, deterministic routing) and on one device — a
        flush stages its rows on one device — and, when sharding is in
        play, the driver's mesh carrying both axes, its host axis
        agreeing with every sharded policy's.  A sharded pool without a
        compatible driver mesh runs free: 1-D host-sharded per-session
        dispatches, no coalescing."""
        if not all(s.batchable for s in self.sessions):
            return False
        if len({str(s.policy.device) for s in self.sessions}) != 1:
            return False
        # A mesh axis is a name and a size: no torch needed to read one.
        if self.mesh is not None and not {"replica", "host"} <= set(
                self.mesh.shape):
            # The flush machinery keys on both axes.
            return False
        for s in self.sessions:
            pmesh = getattr(s.policy, "_mesh", None)
            if pmesh is None:
                continue
            if self.mesh is None or (int(self.mesh.shape["host"])
                                     != int(pmesh.shape["host"])):
                return False
        return True

    # -- lifecycle ---------------------------------------------------------
    def run(self, arrivals: Iterable[JobArrival],
            pace: Optional[float] = None) -> dict:
        """Serve the stream to completion; returns the service report.

        Batching engages when every session's policy qualifies (device
        backend, deterministic routing — the ``run_grid_lockstep``
        criterion): each session gets a ``DispatchBatcher`` slot and the
        caller's thread runs the flush coordinator.  Otherwise sessions
        run free (numpy/naive policies have no dispatch to coalesce).
        """
        if self.mpc is not None:
            # Imported here, not at module scope: mpc=None serving must
            # never pay for (or depend on) the search/planner stack.
            # Built before any thread starts: its warm-up captures the
            # evaluator's CUDA graphs on this thread, and a failure
            # leaves nothing running.
            from pivot_tpu_torch.mpc.controller import MpcController

            self._mpc = MpcController(self, self.mpc)
            self._mpc.warmup()
        # Setup under the cv: no session/producer/watchdog thread
        # exists yet, so the lock is uncontended — holding it keeps the
        # thread-guard discipline checkable instead of exempting run()
        # wholesale (which would also hide the join loop below, where
        # the pass caught a real _threads iteration race).
        started: List[threading.Thread] = []
        with self._cv:
            clients = [None] * len(self.sessions)
            for s in self.sessions:
                # CUDA initialises, and greedy_place builds and loads,
                # here on the caller's thread before any session thread
                # dispatches.
                if hasattr(s.policy, "prepare"):
                    s.policy.prepare()
            if self.resident:
                # Resident pool: no batcher (see __init__); CUDA was
                # initialised above, on this thread.
                for s in self.sessions:
                    self._enable_resident(s)
            elif self._elastic is None and self._batching_compatible():
                from pivot_tpu_torch.sched.batch import DispatchBatcher

                self.batcher = DispatchBatcher(
                    len(self.sessions), flush_after=self.flush_after,
                    tracer=self.tracer, profiler=self.profiler,
                    device=self.sessions[0].policy.device, mesh=self.mesh,
                    ragged=self.ragged,
                    journal=(
                        self._recovery.journal
                        if self._recovery is not None else None
                    ),
                )
                clients = [self.batcher.client() for _ in self.sessions]
                for s, c in zip(self.sessions, clients):
                    s.policy.enable_batching(c)
                self.slo.attach_dispatch_stats(self.batcher.stats)
            if self._recovery is not None:
                self._recovery.start()
                for s in self.sessions:
                    s.attach_recovery(self._recovery)
            if self._elastic is not None:
                # Gate and align every launch policy before its thread
                # exists (attach may reshard; the cv is held).
                for s in self.sessions:
                    self._elastic.attach(s.policy)
            for s, c in zip(self.sessions, clients):
                s._client = c
                thread = threading.Thread(
                    target=s.loop, args=(c,),
                    name=f"serve-{s.label}", daemon=True,
                )
                self._threads.append((s, thread))
                started.append(thread)
        for t in started:
            t.start()
        watchdog = None
        if self.stall_timeout is not None:
            watchdog = threading.Thread(
                target=self._watchdog, name="serve-watchdog", daemon=True,
            )
            watchdog.start()
        if self.autoscale is not None:
            self._autoscaler = SloAutoscaler(self, self.autoscale)
            self._autoscaler.start()
        if self._mpc is not None:
            self._mpc.start()
        producer = threading.Thread(
            target=self._produce, args=(arrivals, pace),
            name="serve-producer", daemon=True,
        )
        producer.start()
        if self.batcher is not None:
            self.batcher.serve()
        # Supervisor restarts append replacement threads while we join —
        # loop until every NON-ABANDONED thread has exited.  Abandoned
        # sessions' threads are excluded: a permanently wedged thread is
        # exactly what the stall watchdog replaced (it cannot be killed,
        # only out-lived — daemon threads die with the process), and
        # waiting on it would hang the service shutdown the restart just
        # saved.
        while True:
            # Snapshot under the cv: supervisor restarts and autoscaler
            # growth append to _threads concurrently with this loop.
            with self._cv:
                pending = [
                    t for s, t in self._threads
                    if t.is_alive() and not s.abandoned
                ]
            if not pending:
                break
            for t in pending:
                t.join(timeout=0.5)
        producer.join()
        self._watch_stop.set()
        if watchdog is not None:
            watchdog.join()
        if self._autoscaler is not None:
            self._autoscaler.stop()
        if self._mpc is not None:
            self._mpc.stop()
        if self._recovery is not None:
            # Drain the pending snapshot and fsync the journal tail —
            # runs on the error path too (the whole point is that the
            # journal is trustworthy after ANY exit).
            self._recovery.stop()
        with self._cv:
            errors = self._errors + [
                s.error
                for s in self.sessions + self._retired
                if s.error is not None
            ]
        if errors:
            raise errors[0]
        return self.report()

    def publish_metrics(self, registry=None) -> Optional[dict]:
        """Publish the service's full metrics state into the unified
        registry (``pivot_tpu_torch.obs.MetricsRegistry``) — the SLO meter
        (counters, tiers, distributions, dispatch mix), the autoscaler
        action log, per-session run meters, and the dispatch-profiler
        census — and return the JSON snapshot.  Uses the driver's
        attached registry when none is passed; None when neither
        exists.

        Scrape-safe (round 15, ``serve --metrics-port``): callable
        mid-run from the HTTP endpoint's worker thread — the mutable
        pool state is snapshotted under the cv, the SLO meter and
        registry lock internally, and publish-style ``set`` makes
        republishing idempotent."""
        registry = registry or self.registry
        if registry is None:
            return None
        self.slo.publish_metrics(registry)
        with self._cv:
            sessions = list(self.sessions) + list(self._retired)
        if self._autoscaler is not None:
            registry.counter(
                "pivot_autoscale_actions_total",
                "autoscaler actions (grow/shrink/preempt)",
                labelnames=("action",),
            )
            actions: Dict[str, int] = {}
            for evt in list(self._autoscaler.events):
                actions[evt["action"]] = actions.get(evt["action"], 0) + 1
            for action, n in actions.items():
                registry.set(
                    "pivot_autoscale_actions_total", n, action=action
                )
        if self._mpc is not None:
            registry.counter(
                "pivot_mpc_actions_total",
                "mpc planner actions (hold/grow/drain/shed/canary)",
                labelnames=("action",),
            )
            for action, n in self._mpc.action_counts().items():
                registry.set("pivot_mpc_actions_total", n, action=action)
            registry.counter(
                "pivot_mpc_stage_events_total",
                "mpc rollout stage transitions",
                labelnames=("stage",),
            )
            stages: Dict[str, int] = {}
            for evt in list(self._mpc.rollout.events):
                stages[evt["stage"]] = stages.get(evt["stage"], 0) + 1
            for stage, n in stages.items():
                registry.set("pivot_mpc_stage_events_total", n, stage=stage)
        for s in sessions:
            s.meter.publish_metrics(registry, run=s.label)
        if self.profiler is not None:
            self.profiler.publish_metrics(registry)
        if self._recovery is not None:
            self._recovery.publish(registry)
        return registry.to_json()

    def report(self) -> dict:
        """The service report, with the reference's keys (``"mesh"``:
        the serving mesh's axis sizes, or None)."""
        return {
            "sessions": len(self.sessions),
            "backpressure": self.queue.policy,
            "queue_depth": self.queue.depth,
            "flush_after_s": self.flush_after,
            "ragged": self.ragged,
            "resident": self.resident,
            "splice_tier": self.splice_tier,
            "routing": self.routing,
            "preempt": self.preempt,
            "tenant_quota": self.queue.tenant_quota,
            "mesh": (
                {str(k): int(v) for k, v in self.mesh.shape.items()}
                if self.mesh is not None else None
            ),
            "tier_reserve": (
                list(self.queue.tier_reserve)
                if self.queue.tier_reserve else None
            ),
            "tier_policies": (
                list(self.queue.tier_policies)
                if self.queue.tier_policies else None
            ),
            "restarts": self._restarts,
            "pool": {
                "final": len(self.sessions),
                "grown": self._n_grown,
                "retired": len(self._retired),
                "abandoned": len(self._abandoned),
            },
            "autoscaler": (
                {
                    "g_min": self.autoscale.g_min,
                    "g_max": self.autoscale.g_max,
                    "slo_p99_s": self.autoscale.slo_p99_s,
                    "events": list(self._autoscaler.events),
                }
                if self._autoscaler is not None else None
            ),
            "mpc": (
                self._mpc.summary() if self._mpc is not None else None
            ),
            # Recovery plane: journal / snapshot / watchdog state when
            # crash-safety is armed; None = the stack without it.
            "recovery": (
                self._recovery.summary()
                if self._recovery is not None else None
            ),
            "slo": self.slo.snapshot(),
            "batcher": dict(self.batcher.stats) if self.batcher else None,
            # Dispatch-profiler census: per-family sampled latency and
            # model-ratio medians; present when profiling.
            **(
                {"profiler": self.profiler.summary()}
                if self.profiler is not None else {}
            ),
            "per_session": [
                s.summary() for s in self.sessions + self._retired
            ],
            **(
                {"metrics": self.publish_metrics()}
                if self.registry is not None else {}
            ),
        }

    def audit(self, context: str = "serve drain") -> None:
        """Raise ``AuditError`` unless the drained service satisfies the
        serve conservation law (``infra/audit.py::audit_serve``): every
        admitted or preempted job terminated exactly once, capacity and
        spill fully drained, and every surviving session's world passes
        the cluster/conservation/billing audits."""
        from pivot_tpu_torch.infra.audit import AuditError, audit_serve

        violations = audit_serve(self)
        if violations:
            raise AuditError(
                f"serve state corrupted ({context}):\n  "
                + "\n  ".join(violations)
            )


def closed_loop_source(
    driver: ServeDriver,
    make_app: Callable,
    concurrency: int,
    n_jobs: int,
    stagger: float = 1e-3,
):
    """Closed-loop load generator: keep ``concurrency`` jobs in flight;
    every completion injects the next job at the scheduler grid point
    after the completing session's clock — the N-users-think-time-zero
    model, the complement of the open-loop Poisson stream."""
    import queue as _queue

    feed: "_queue.Queue" = _queue.Queue()
    produced = {"n": 0}
    lock = threading.Lock()

    def emit(ts: float) -> None:
        with lock:
            if produced["n"] >= n_jobs:
                return
            produced["n"] += 1
        feed.put(JobArrival(ts, make_app()))

    for i in range(min(concurrency, n_jobs)):
        emit(stagger * (i + 1))
    driver.add_completion_hook(
        lambda _s, _a, sim_now: emit(driver._next_tick(sim_now))
    )

    def gen():
        yielded = 0
        while yielded < n_jobs:
            # graftcheck: ignore[thread-guard] -- monotonic stop flag polled by the feed loop; the producer thread consuming this generator re-checks under the cv
            if driver._stop:
                return
            try:
                item = feed.get(timeout=0.02)
            except _queue.Empty:
                # No completion yet: the in-flight jobs need sim time to
                # finish, and only the producer can grant it.
                driver.advance_gate()
                continue
            yield item
            yielded += 1

    return gen()
