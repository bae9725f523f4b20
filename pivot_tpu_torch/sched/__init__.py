"""Two-level scheduler runtime: global tick loop + per-application local schedulers.

Capability parity with the reference's ``scheduler/__init__.py``:

  * ``GlobalScheduler``  — tick loop every ``interval`` sim-seconds: drain
    wait queue (LIFO) and submit queue into the ready batch, snapshot host
    state, invoke the placement policy, route placed tasks to the cluster's
    ``dispatch_q`` and unplaced tasks to the wait queue (ref ``:87-118``);
    completion listener that finishes tasks, releases DAG successors, and
    resubmits failed tasks — the infinite retry loop (ref ``:120-147``).
  * ``LocalScheduler``   — per-app: seeds the ready stack with DAG sources,
    pumps ready tasks (LIFO, matching the reference's OrderedDict.popitem)
    to the global submit queue every ``interval`` ticks (ref ``:150-222``).

The **policy boundary** is redesigned for the TPU backend: instead of the
reference's ``schedule(tasks)`` mutating task objects against a dict
snapshot, a policy receives a :class:`TickContext` — dense ``[T,4]`` demand
and ``[H,4]`` availability arrays plus zone vectors — and returns an ``[T]``
array of host indices (−1 = unplaced).  The same context feeds the naive
Python, vectorized numpy, and fused TPU implementations, which is what makes
placement-parity testing across backends possible.

Documented deviations from the reference (quirks fixed deliberately, see
SURVEY.md §4):
  * The reference caps the number of submit-queue items drained per tick at
    ``len(submit_q) - len(wait_q)`` (``scheduler/__init__.py:96-99``), so a
    non-empty wait queue starves fresh submissions; here the ready batch is
    wait queue + everything currently submitted.
  * Finished applications are actually removed from the local-scheduler
    registry (the reference pops by the wrong key, ``:145``, and rescans
    every app's DAG each tick).

**Retry governance** (round 7, ``sched/retry.py``): the reference's
resubmit-forever loop is now *governed* when the scheduler is built with
a :class:`~pivot_tpu_torch.sched.retry.RetryPolicy` (per-task budgets +
deterministically-jittered exponential backoff; budget exhaustion
dead-letters the task, fails its application, and records the shed
reason) and/or a :class:`~pivot_tpu_torch.sched.retry.HostCircuitBreaker`
(K consecutive failures quarantine a host for a cooldown; the ``[H]``
live mask in :attr:`TickContext.live_mask` — quarantines plus
spot-preemption drain flags — is fused into every placement backend's
fit mask).  Both default to ``None``, which keeps the loop bit-identical
to the reference-parity behavior above.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from pivot_tpu_torch.des import Callback, Environment, Store
from pivot_tpu_torch.infra import Cluster, Host
from pivot_tpu_torch.infra.meter import Meter, SloMeter
from pivot_tpu_torch.sched.retry import DeadLetter, HostCircuitBreaker, RetryPolicy
from pivot_tpu_torch.utils import LogMixin
from pivot_tpu_torch.utils.trace import NULL_TRACER, Tracer
from pivot_tpu_torch.workload import Application, Task, TaskState

__all__ = [
    "TickContext",
    "Policy",
    "GlobalScheduler",
    "LocalScheduler",
    "DeadLetter",
    "HostCircuitBreaker",
    "RetryPolicy",
]


class TickContext:
    """Dense batch view of one scheduling tick — the policy/kernel feed.

    Arrays are index-aligned with ``tasks`` (rows) and the cluster host
    order (columns / host indices).
    """

    def __init__(
        self,
        scheduler: "GlobalScheduler",
        tasks: List[Task],
        tick_seq: int,
    ):
        cluster = scheduler.cluster
        self.scheduler = scheduler
        self.cluster = cluster
        self.meta = cluster.meta
        self.env_now = scheduler.env.now
        self.tick_seq = tick_seq
        self.tasks = tasks
        self.hosts: List[Host] = cluster.hosts
        # Mutable working copy: policies decrement as they assign within the
        # tick (greedy sequential semantics, ref scheduler snapshots).
        self.avail = cluster.availability_matrix()
        self.demands = (
            np.stack([t.demand for t in tasks])
            if tasks
            else np.zeros((0, 4), dtype=np.float64)
        )
        self._host_zones: Optional[np.ndarray] = None
        self._host_task_counts: Optional[np.ndarray] = None
        self._live_mask: Optional[np.ndarray] = None
        self._live_mask_set = False
        self._hazard: Optional[np.ndarray] = None
        self._hazard_set = False
        # Policies that iterate the batch in a different order than given
        # (the VBP decreasing arms) record it here: the reference's tick
        # loop consumes ``schedule(ready_q)``'s RETURN list — the sorted
        # one — so dispatch and wait-queue insertion follow the policy's
        # visit order, not batch order (ref ``scheduler/__init__.py:102-115``,
        # ``vbp.py:17,42``).  ``None`` means batch order (opportunistic
        # returns ``list(tasks)``, cost-aware returns ``tasks`` unsorted —
        # its sort happens per anchor bucket on a copy, ref
        # ``cost_aware.py:28-43``).
        self.visit_order: Optional[List[int]] = None

    @property
    def n_tasks(self) -> int:
        return len(self.tasks)

    @property
    def n_hosts(self) -> int:
        return len(self.hosts)

    @property
    def host_zones(self) -> np.ndarray:
        if self._host_zones is None:
            self._host_zones = self.cluster.host_zone_vector()
        return self._host_zones

    @property
    def host_task_counts(self) -> np.ndarray:
        """[H] number of tasks currently resident per host (decay factor)."""
        if self._host_task_counts is None:
            self._host_task_counts = np.array(
                [h.n_tasks for h in self.hosts], dtype=np.int32
            )
        return self._host_task_counts

    @property
    def live_mask(self) -> Optional[np.ndarray]:
        """[H] bool quarantine mask for this tick — False marks hosts
        excluded from NEW placements: circuit-breaker quarantines
        (``scheduler.breaker``) and spot-preemption drain flags
        (``Host.draining``).  ``None`` = every host live, the
        allocation-free common case.  Down hosts are *not* represented
        here — the availability snapshot's −1 sentinel already keeps
        every fit mask off them.  CPU policies fold the mask into the
        availability working copy (``policies.fold_quarantine``); device
        policies pass it to the kernels' ``live`` argument — identical
        fit masks either way."""
        if self._live_mask_set:
            return self._live_mask
        self._live_mask_set = True
        breaker = getattr(self.scheduler, "breaker", None)
        now = self.env_now
        mask = None
        for i, h in enumerate(self.hosts):
            if getattr(h, "draining", False) or (
                breaker is not None and breaker.is_quarantined(h.id, now)
            ):
                if mask is None:
                    mask = np.ones(len(self.hosts), dtype=bool)
                mask[i] = False
        self._live_mask = mask
        return mask

    @property
    def hazard_vector(self) -> Optional[np.ndarray]:
        """[H] per-host spot-preemption hazard (events/host/sim-second) at
        this tick's instant, gathered from the scheduler's
        :class:`~pivot_tpu_torch.infra.market.MarketSchedule` through the
        cluster's host→zone map — the feed of the risk-aware scoring term
        (``policies.resolve_risk``).  ``None`` when the scheduler carries
        no market environment: the exact pre-market code path, no hazard
        arrays anywhere downstream."""
        if not self._hazard_set:
            self._hazard_set = True
            market = getattr(self.scheduler, "market", None)
            if market is not None:
                self._hazard = market.hazard_vector(
                    self.env_now, self.host_zones
                )
        return self._hazard

    @property
    def cost_matrix(self) -> np.ndarray:
        """The tick's ``[Z, Z]`` egress-cost matrix: the market-scaled
        slice of the ``[P, Z, Z]`` tensor when a
        :class:`~pivot_tpu_torch.infra.market.MarketSchedule` is attached
        (``MarketSchedule.cost_matrix_at`` — cached per segment, so ticks
        inside one price segment share the identical ndarray), else the
        static ``meta.cost_matrix`` object itself — bit-identical to
        every pre-market caller."""
        market = getattr(self.scheduler, "market", None)
        if market is None:
            return self.meta.cost_matrix
        return market.cost_matrix_at(self.env_now, self.meta)


class Policy(LogMixin):
    """A placement policy: consumes a TickContext, returns host indices."""

    name = "abstract"

    def place(self, ctx: TickContext) -> np.ndarray:
        """Return [T] int array of host indices; −1 leaves a task unplaced."""
        raise NotImplementedError

    def bind(self, scheduler: "GlobalScheduler") -> None:
        """Called once when attached to a scheduler (override to warm up)."""

    def apply_weights(self, weights) -> None:
        """Hot-swap the scoring-weight vector on a LIVE policy.

        The promotion surface of model-predictive serving
        (``pivot_tpu/mpc``): every concrete policy resolves its risk
        term per :meth:`place` call (``policies.resolve_risk``), so
        swapping the attributes here takes effect on the next decision
        without re-binding or recompiling anything.  Subclasses that
        cache derived scoring state (``_score_exp``) or own a CPU twin
        override and extend this.
        """
        from pivot_tpu_torch.search.weights import PolicyWeights

        w = (
            weights
            if isinstance(weights, PolicyWeights)
            else PolicyWeights.from_array(weights)
        ).validate()
        self.weights = w
        self.risk_weight = w.risk_weight
        self.rework_cost = w.rework_cost


class LocalScheduler(LogMixin):
    """Per-application scheduler: DAG readiness tracking + submission pump.

    Pump wake-ups land on the reference's tick grid — ``start_time + k·
    interval`` (ref ``scheduler/__init__.py:185-194``) — but are scheduled
    *on demand*: when the ready stack is empty nothing ticks, removing the
    reference's per-app idle polling without changing submission times.
    """

    def __init__(
        self,
        env: Environment,
        app: Application,
        submit_q: Store,
        interval: float = 5,
        scheduler: Optional["GlobalScheduler"] = None,
    ):
        self.env = env
        self.application = app
        self.submit_q = submit_q
        self.interval = interval
        self.scheduler = scheduler
        self._ready_stack: List[Task] = []
        self._start_time = 0.0
        self._wake_armed = False
        #: The armed pump's heap entry — tagged with ``owner=self`` so the
        #: pure-tick-run extractor (``GlobalScheduler._extract_span``) can
        #: recognize, snapshot, and absorb the delivery into a fused span
        #: (cancelling the entry so it cannot double-deliver).
        self._wake_cb: Optional[Callback] = None

    def start(self) -> None:
        env, app = self.env, self.application
        app.start_time = env.now
        self._start_time = env.now
        for group in app.get_sources():
            for task in group.materialize_tasks():
                self._ready_stack.append(task)
        # First pump fires immediately (grid point k = 0).
        self._wake_armed = True
        self._wake_cb = env.schedule_callback(0.0, self._pump)
        self._wake_cb.owner = self
        if self.scheduler is not None:
            self.scheduler._armed_pumps += 1

    def _pump(self) -> None:
        self._wake_armed = False
        self._wake_cb = None
        if self.scheduler is not None:
            self.scheduler._armed_pumps -= 1
            # Submissions mutate the ready set a fused span speculated
            # over — an un-absorbed pump firing mid-replay must abort the
            # remaining span ticks (``_replay_span``'s epoch check).
            self.scheduler._span_epoch += 1
        submit = self.submit_q.put
        stack = self._ready_stack
        while stack:
            task = stack.pop()  # LIFO, ref popitem()
            if task.is_nascent:
                submit(task)

    def pump_snapshot(self) -> List[Task]:
        """The tasks the armed pump will deliver when it fires, in
        delivery order.  Valid across a pure window: stack membership
        only changes via completions (which abort fused spans before the
        affected tick) and nascency only via placement (stack tasks are
        unplaced until delivered) — so the span extractor can fold this
        as the pump's future delivery without touching the pump itself."""
        return [t for t in reversed(self._ready_stack) if t.is_nascent]

    def _arm_wake(self) -> None:
        """Schedule the next pump at the first grid point after now."""
        if self._wake_armed or not self._ready_stack:
            return
        elapsed = self.env.now - self._start_time
        k = int(elapsed // self.interval) + 1
        delay = self._start_time + k * self.interval - self.env.now
        self._wake_armed = True
        self._wake_cb = self.env.schedule_callback(delay, self._pump)
        self._wake_cb.owner = self
        if self.scheduler is not None:
            self.scheduler._armed_pumps += 1

    def notify(self, task: Task) -> None:
        """Called by the global listener when one of our tasks finishes.

        Failed tasks never reach here — the listener resubmits them to the
        global queue directly (the retry loop lives in the global
        scheduler, not here).
        """
        assert task.is_finished
        group = task.group
        if group.is_finished:
            for succ in self.application.get_ready_successors(group.id):
                for t in succ.materialize_tasks():
                    self._ready_stack.append(t)
        self._arm_wake()


class SpanPlan:
    """One extracted pure tick run, priced and served as a single fused
    device dispatch (``ops/tickloop.py``).

    ``slots`` is the span's task universe: the tick-0 ready batch in
    batch order, then each in-window pump delivery (cohort) in fire
    order; ``arrive[s]`` is the tick index at which slot ``s`` joins the
    ready pool.  ``outcome`` is filled by the policy's ``place_span``
    (slot-indexed per-tick placements).  The plan never mutates DES
    state: the folded pumps stay armed and fire normally during replay —
    the fused program merely *pre-computed* what they will deliver.
    """

    __slots__ = (
        "ctx", "grid", "slots", "arrive", "pump_ticks", "epoch", "disturb",
        "outcome",
    )

    def __init__(self, ctx, grid, slots, arrive, pump_ticks, epoch,
                 disturb=0):
        self.ctx = ctx
        self.grid = grid  # [K] exact tick instants (iterated fl-adds)
        self.slots = slots  # [S] Task — ready batch, then cohorts
        self.arrive = arrive  # [S] int — delivery tick per slot
        self.pump_ticks = pump_ticks  # delivery tick per folded pump
        self.epoch = epoch  # span epoch at extraction
        self.disturb = disturb  # disturbance epoch at extraction
        self.outcome = None

    @property
    def n_ticks(self) -> int:
        return len(self.grid)


class GlobalScheduler(LogMixin):
    """The global tick loop + completion listener around a pluggable policy."""

    def __init__(
        self,
        env: Environment,
        cluster: Cluster,
        policy: Policy,
        interval: float = 5,
        seed: Optional[int] = None,
        meter: Optional[Meter] = None,
        tracer: Optional[Tracer] = None,
        retry: Optional[RetryPolicy] = None,
        breaker: Optional[HostCircuitBreaker] = None,
        slo: Optional[SloMeter] = None,
        fuse_spans: bool = True,
        market=None,
    ):
        self.env = env
        self.cluster = cluster
        self.policy = policy
        self.interval = interval
        self.seed = seed
        self.meter = meter
        self.tracer = tracer or NULL_TRACER
        #: Spot-market environment (``infra/market.py``): per-zone
        #: time-varying price multipliers and preemption hazards.  When
        #: set, every :class:`TickContext` exposes the tick's [H] hazard
        #: vector (risk-aware scoring) and the market-scaled egress-cost
        #: matrix.  ``None`` (default) keeps the static-world code paths
        #: bit-identical to pre-market behavior.
        self.market = market
        if market is not None and getattr(cluster, "meta", None) is not None:
            # Eager catalog check: a schedule generated against a different
            # locality file would otherwise surface deep inside a tick as
            # an IndexError (hazard gather) or, worse, silently score every
            # host with the wrong zone's hazard.
            market.check_zones(cluster.meta)
        #: Retry governance (``sched/retry.py``) — both None by default,
        #: which preserves the reference-parity resubmit-forever loop
        #: bit for bit.  ``slo`` (serving layer) receives shed reasons
        #: for dead-lettered tasks.
        self.retry = retry
        self.breaker = breaker
        self.slo = slo
        #: Terminal dead-letter queue, in dead-lettering order.
        self.dead_letters: List[DeadLetter] = []
        #: Tasks of failed applications dropped before (re)placement.
        self.n_cancelled = 0
        #: Placements that landed on a down or quarantined host — the
        #: invariant auditor asserts this stays empty (infra/audit.py).
        self.placement_violations: List[str] = []
        #: Proactive-survival counters (``on_preempt_warning``): queued
        #: tasks migrated off a draining host before starting, and doomed
        #: running tasks restarted at the warning instead of wasting the
        #: whole lead window.
        self.n_migrated = 0
        self.n_proactive_restarts = 0
        self._attempts: Dict[Task, int] = {}  # failures per live task
        self._failed_apps: set = set()
        self.randomizer = np.random.RandomState(seed)
        self.submit_q = Store(env)
        self._wait_stack: List[Task] = []
        # First dispatch tick that saw each still-unplaced task — the
        # submit→placement turnover clock (see _dispatch_loop).
        self._pending_since: Dict[Task, float] = {}
        self._local: Dict[str, LocalScheduler] = {}
        self._n_submitted = 0  # monotone; feeds keyed root-anchor ordinals
        self._n_unfinished = 0
        self._stopped = False
        self._tick_seq = 0
        #: Pure-tick-run fusion (round 8).  When on, the dispatch loop
        #: (a) fast-forwards across windows of provably no-op ticks
        #: instead of paying one policy dispatch each (availability only
        #: decreases within a pure window, so a tick that leaves tasks
        #: unplaced proves every later in-window tick places nothing),
        #: and (b) hands whole windows WITH in-window pump deliveries to
        #: a span-capable device policy (``place_span``) as ONE fused
        #: device program (``ops/tickloop.py``).  Placements, meters, and
        #: wait-queue order are bit-identical either way — asserted by
        #: ``tests/test_tickloop.py``'s DES parity tests.
        self.fuse_spans = fuse_spans
        #: Monotone counter of scheduler-visible mutations (completions,
        #: submissions, un-absorbed pump fires).  A fused span's replay
        #: commits precomputed ticks only while this stays unchanged; any
        #: bump aborts the remaining span (the committed prefix is exact).
        self._span_epoch = 0
        #: Disturbance sub-counter (round 20): the epoch bumps that are
        #: NOT pure arrivals — completions, withdrawals, preemption
        #: drains.  A span-epoch mismatch with this unchanged means the
        #: only in-window mutations were submissions + pump fires, which
        #: is the mid-span-splice qualifying condition: the new work can
        #: be JOINED into the running span (``_try_splice``) instead of
        #: aborting it.  Any disturbance still aborts exactly as before.
        self._disturb_epoch = 0
        #: Mid-span-splice admission gate: an optional ``task -> bool``
        #: predicate every mid-span arrival must pass before the running
        #: span re-runs with it joined.  ServeDriver points this at
        #: its tier policy (tier-0 latency-critical sessions splice;
        #: batch tiers wait for the flush boundary).  ``None`` admits
        #: every arrival (when the policy has splice enabled at all).
        self.splice_gate = None
        #: Serving's SLO-checkpoint span bound (round 17,
        #: ``fuse_spans="slo"``): an optional zero-arg callable returning
        #: a sim-time horizon spans must not cross.  ServeDriver
        #: points it at its release frontier, so a fused span never
        #: speculates past the last revealed arrival — each span ends at
        #: an admission checkpoint where the SLO meter records exactly
        #: one decision latency (``serve/session.py``).  ``None`` (the
        #: batch default) leaves span extraction unchanged.
        self.span_horizon = None
        self._ff_evt = None  # pending fast-forward wake (early-wakeable)
        self._ff_cb: Optional[Callback] = None
        self._ff_anchor = 0.0  # tick-grid anchor of the pending wake
        self._ff_rescheduled = False  # a submit pulled the wake earlier
        self._ff_target = float("inf")
        #: Armed local-pump count — the O(1) gate on span extraction
        #: (maintained by LocalScheduler arm/fire).
        self._armed_pumps = 0
        #: Fusion observability: fast-forwarded no-op ticks, fused spans
        #: served / their tick count, replay aborts, declined plans.
        self.span_stats: Dict[str, int] = {
            "ff_ticks": 0,
            "fused_spans": 0,
            "fused_ticks": 0,
            "span_aborts": 0,
            "spans_declined": 0,
            # Span-length observability (round 18): the longest span
            # extracted and the sum of extracted lengths — fragmentation
            # diagnostics for the ragged batcher (extracted length is
            # what the K-bucket ladder quantises; committed ticks are
            # ``fused_ticks``).  Always present, zero under per-tick
            # dispatch, so summary key sets match across serve arms.
            "span_ticks_max": 0,
            "span_ticks_sum": 0,
            # Mid-span splices committed (round 20): arrivals joined into
            # a RUNNING span without waiting for the flush boundary.
            "span_splices": 0,
        }
        policy.bind(self)

    def _stage_task(self, task: Task, name: str, **args) -> None:
        """Causal-trace hook (round 14): link a task-level event into
        its serve job's parent-linked chain when the app carries a
        trace id (stamped by ServeDriver at admission).  Call
        sites gate on ``self.tracer.enabled`` so the disabled path
        costs nothing; the payload is sim-time only — the wall side is
        stamped inside ``pivot_tpu/obs`` (the determinism boundary)."""
        trace = getattr(task.application, "_obs_trace", None)
        if trace is not None:
            self.tracer.stage(
                trace, name, sim=self.env.now, task=task.id, **args
            )

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        self.env.process(self._dispatch_loop())
        self.env.process(self._listen_loop())

    def stop(self) -> None:
        self._stopped = True

    @property
    def is_active(self) -> bool:
        return not self._stopped or self._n_unfinished > 0

    def submit(self, app: Application) -> None:
        if app.id in self._local:
            self.logger.error("application %s already exists", app.id)
            return
        # Submission ordinal: the stable identity the keyed root-anchor
        # draw uses (policies.resolve_root_anchor); equals the app's row
        # index in EnsembleWorkload, so DES and estimator key identically.
        # Monotone — ``_local`` drops finished apps, so its size recycles.
        app._submit_ordinal = self._n_submitted
        self._n_submitted += 1
        self._span_epoch += 1
        local = LocalScheduler(
            self.env, app, self.submit_q, self.interval, scheduler=self
        )
        self._local[app.id] = local
        self._n_unfinished += 1
        local.start()
        # A submission while the dispatch loop sleeps across a
        # fast-forwarded window (serve-mode thread injection) must pull
        # the wake back to the next grid tick, or the new app would wait
        # out the whole window.
        if self._ff_evt is not None and not self._ff_evt.triggered:
            self._reschedule_ff_wake()

    def get_local(self, app_id: str) -> Optional[LocalScheduler]:
        return self._local.get(app_id)

    def can_withdraw(self, app: Application) -> bool:
        """True iff ``app`` is *admitted-but-unplaced*: it is live here
        and no materialized task has ever left NASCENT (none submitted,
        running, finished — and none ever failed, which would leave a
        backed-off resubmission callback in flight).  Only such apps are
        preemptible: withdrawing them cancels pure bookkeeping, no
        in-flight execution or heap event refers to them afterwards."""
        if self._local.get(app.id) is None:
            return False
        for group in app.groups:
            for task in group.tasks:
                if not task.is_nascent or task in self._attempts:
                    return False
        return True

    def withdraw(self, app: Application) -> bool:
        """In-queue preemption (round 9, ServeDriver's victim path):
        remove an admitted-but-unplaced application from the scheduler —
        its armed local pump is cancelled, its tasks are purged from the
        wait stack and submit queue, and the app stops counting toward
        ``_n_unfinished`` — as if it had never been submitted.  Returns
        False (and mutates nothing) when the app is not withdrawable
        (already placed / running / finished / unknown).  Must run on
        the thread that owns this scheduler's event kernel."""
        if not self.can_withdraw(app):
            return False
        local = self._local.pop(app.id)
        if local._wake_armed and local._wake_cb is not None:
            local._wake_cb.cancel()
            local._wake_armed = False
            local._wake_cb = None
            self._armed_pumps -= 1
        mine = {t for g in app.groups for t in g.tasks}
        self._wait_stack = [t for t in self._wait_stack if t not in mine]
        self.submit_q.items[:] = [
            t for t in self.submit_q.items if t not in mine
        ]
        for t in mine:
            self._pending_since.pop(t, None)
        self._n_unfinished -= 1
        # Withdrawal mutates the ready universe a fused span may have
        # speculated over — and wakes the loop's fast-forward sleep path
        # conservatively via the epoch bump at its next check.
        self._span_epoch += 1
        self._disturb_epoch += 1
        self.tracer.emit("app", "withdrawn", self.env.now, id=app.id)
        return True

    # -- proactive spot survival (round 11, ``infra/market.py``) -----------
    def enable_proactive_drain(self, injector) -> None:
        """Register this scheduler's proactive-survival handler on a
        :class:`~pivot_tpu_torch.infra.faults.FaultInjector`: every
        spot-preemption *warning* (after ``Host.draining`` is set, so the
        live mask already excludes the host from new placements) runs
        :meth:`on_preempt_warning`.  Without this call the scheduler is
        purely reactive — the warning drains, the abort kills, the retry
        loop restarts — which is the hazard-blind baseline the
        ``spot_survival`` bench compares against."""
        if getattr(self.cluster, "executor", None) is None:
            # Only the 'fast' executor backend exposes eviction; on the
            # 'process' backend warnings still migrate queued tasks, but
            # doomed residents burn their whole lead window — results
            # diverge from the 'fast' backend.
            self.logger.warning(
                "proactive drain: cluster executor backend has no "
                "eviction support (ClusterConfig.executor != 'fast'); "
                "doomed running tasks will not be restarted early"
            )
        injector.add_warning_hook(self.on_preempt_warning)

    def on_preempt_warning(self, host, lead: float = 0.0) -> None:
        """The drain → migrate → restart half of spot survival (Bamboo /
        SpotServe shape, PAPERS.md), run at the preemption WARNING:

          * **migrate**: tasks already *placed* on the doomed host but not
            yet started (sitting in the cluster's dispatch queue) are
            pulled back to NASCENT and resubmitted for a re-decision next
            tick — they never touch the host, consume no retry attempt,
            and re-place with the drain mask (and the risk term) active;
          * **restart**: running residents that provably cannot conclude
            before the abort (``now + lead``) are evicted NOW — capacity
            refunded (the machine is alive), the execution aborted, and
            the task surfaced as a governed retry — instead of burning
            the whole lead window on doomed compute that the abort would
            waste anyway (the reactive arm's rework bill).

        Residents that CAN finish inside the lead are left to drain out —
        evicting them would turn free completions into retries.  The
        scheduler-visible mutations bump the span epoch, so any fused
        span speculating over this instant aborts exactly."""
        env = self.env
        # Migrate queued-not-yet-started tasks back to a re-decision.
        dispatch_q = self.cluster.dispatch_q
        mine = [
            t for t in dispatch_q.items
            if isinstance(t, Task) and t.placement == host.id
        ]
        if mine:
            dispatch_q.items[:] = [
                t for t in dispatch_q.items if t not in mine
            ]
            for task in mine:
                task.set_nascent()
                task.placement = None
                self.submit_q.put(task)
                self.n_migrated += 1
                self.tracer.emit(
                    "task", "migrated", env.now, id=task.id, host=host.id
                )
            self._span_epoch += 1
            self._disturb_epoch += 1
        # Restart doomed running residents under the retry governor.
        executor = getattr(self.cluster, "executor", None)
        if executor is not None and lead >= 0:
            evicted = executor.evict_doomed(host, env.now + lead)
            if evicted:
                self.n_proactive_restarts += len(evicted)
                for task in evicted:
                    self.tracer.emit(
                        "task", "proactive_restart", env.now,
                        id=task.id, host=host.id,
                    )
                self._span_epoch += 1
                self._disturb_epoch += 1

    # -- the tick loop ---------------------------------------------------
    def _dispatch_loop(self):
        env, cluster = self.env, self.cluster
        while self.is_active:
            at_boundary = False
            ready: List[Task] = []
            while self._wait_stack:
                ready.append(self._wait_stack.pop())  # LIFO, ref popitem()
            ready.extend(self.submit_q.drain())
            if self._failed_apps and ready:
                # A dead-lettered task fails its whole application;
                # sibling tasks still circulating (wait queue, submit
                # queue, late local-scheduler pumps) are cancelled here
                # rather than placed — the conservation auditor accounts
                # them via ``n_cancelled``.
                kept: List[Task] = []
                for task in ready:
                    app = task.application
                    if app is not None and app.id in self._failed_apps:
                        self._cancel_task(task)
                    else:
                        kept.append(task)
                ready = kept
            if ready:
                if self.meter:
                    self.meter.increment_scheduling_ops(len(ready))
                    # Turnover clock starts at the first dispatch tick that
                    # sees a task (≤1 tick after its Store put) and runs
                    # across wait-queue residency; a retry after an
                    # execution failure restarts it (the placement decision
                    # being timed is the new one).
                    now = env.now
                    for task in ready:
                        self._pending_since.setdefault(task, now)
                ctx = TickContext(self, ready, self._tick_seq)
                plan = (
                    self._extract_span(ctx) if self.fuse_spans else None
                )
                if plan is not None:
                    at_boundary = yield from self._serve_span(ctx, plan)
                else:
                    with self.tracer.span(
                        "scheduler", "tick", env.now, n_ready=len(ready)
                    ) as span_args:
                        placements = self.policy.place(ctx)
                        if self.tracer.enabled:
                            span_args["n_placed"] = int(
                                sum(1 for h in placements if h >= 0)
                            )
                    self._tick_seq += 1
                    # Reference parity: consume placements in the
                    # policy's visit order (``schedule()``'s return
                    # order) — it sets both the within-tick dispatch
                    # sequence and, decisively, the wait-queue insertion
                    # order that next tick's LIFO drain reverses (ref
                    # ``scheduler/__init__.py:102-115``).
                    visit = (
                        ctx.visit_order
                        if ctx.visit_order is not None
                        else range(len(ready))
                    )
                    self._dispatch_tick(ctx, ready, placements, visit)
            if at_boundary:
                # A span replay aborted at a fresh, unprocessed tick
                # instant: run that tick now, without sleeping.
                continue
            if self.fuse_spans:
                yield from self._sleep_to_next_tick()
            else:
                yield env.timeout(self.interval)

    def _dispatch_tick(self, ctx, ready, placements, visit) -> None:
        """Consume one tick's placements in visit order: dispatch placed
        tasks, re-stack unplaced ones — the half of the tick the fused
        span replay shares with the per-tick path."""
        env, cluster = self.env, self.cluster
        live = ctx.live_mask
        for i in visit:
            task, h_idx = ready[i], placements[i]
            if not task.is_nascent:
                self.logger.error("task %s not nascent at dispatch", task.id)
                continue
            if h_idx < 0:
                task.placement = None
                self._wait_stack.append(task)
            else:
                host = ctx.hosts[int(h_idx)]
                if not host.up or (
                    live is not None and not live[int(h_idx)]
                ):
                    self.placement_violations.append(
                        f"t={env.now:.3f}: task {task.id} placed on "
                        f"{'down' if not host.up else 'quarantined'} "
                        f"host {host.id}"
                    )
                task.placement = host.id
                cluster.dispatch_q.put(task)
                task.set_submitted()
                if self.tracer.enabled:
                    self._stage_task(task, "placed", host=host.id)
                if self.meter:
                    self.meter.add_scheduling_turnover(
                        env.now - self._pending_since.pop(task, env.now)
                    )

    # -- pure-tick-run fusion (round 8) -----------------------------------
    #
    # A *pure tick run* is a window of upcoming ticks whose scheduler
    # inputs are computable now: the event heap holds nothing before the
    # window's end except local-pump deliveries (whose payloads are
    # snapshot-stable over the window), no quarantine expires inside it,
    # and therefore availability / live mask / ready sets evolve only by
    # this scheduler's own placements.  Two exploits:
    #
    #   * ``_sleep_to_next_tick`` — after ANY tick, the unplaced remainder
    #     provably cannot place until the window ends (availability only
    #     decreases within it, and a task that had no fitting host at its
    #     own step availability — a superset of every later snapshot —
    #     never gains one), so the in-window ticks are exact no-ops: the
    #     loop accounts their meters/wait-queue churn in O(1) kernel
    #     dispatches (zero) and sleeps to the first potentially-productive
    #     tick.  The sleep is early-wakeable by ``submit`` (serve-mode
    #     thread injection).
    #   * ``_extract_span``/``_serve_span`` — when pump deliveries land
    #     INSIDE the window, placements genuinely evolve across ticks;
    #     a span-capable device policy executes the whole window as one
    #     fused device program (``place_span`` → ``ops/tickloop.py``) and
    #     the loop replays the precomputed decisions tick by tick.  The
    #     folded pumps are never touched — they fire normally during the
    #     replay (each bump of ``_span_epoch`` is *expected*); any
    #     UNexpected epoch bump (completion, foreign submission) aborts
    #     the remaining span before the affected tick, which is exact:
    #     committed ticks saw precisely the state the device assumed.

    def _quarantine_bound(self, now: float) -> float:
        if self.breaker is None:
            return float("inf")
        return self.breaker.next_expiry(now)

    def _pump_allow(self):
        """Heap-scan predicate approving OUR locals' armed pump entries."""
        def allow(ev) -> bool:
            owner = getattr(ev, "owner", None)
            return (
                type(ev) is Callback
                and isinstance(owner, LocalScheduler)
                and self._local.get(owner.application.id) is owner
            )
        return allow

    def _extract_span(self, ctx: "TickContext") -> Optional[SpanPlan]:
        """Try to extract (and device-price) a fused span starting at the
        current tick.  Returns a plan with ``outcome`` filled, or None —
        in which case NOTHING was mutated and the per-tick path serves
        the tick.  Spans need a span-capable policy AND at least one
        non-empty in-window pump delivery; windows without deliveries are
        the fast-forward path's business (strictly cheaper)."""
        policy = self.policy
        place_span = getattr(policy, "place_span", None)
        if place_span is None or not policy.span_capable():
            return None
        if self._armed_pumps == 0:
            # O(1) bail before the O(heap) scan: spans exist to fold
            # in-window pump deliveries; with no pump armed there is
            # nothing to fold (fast-forward owns delivery-free windows).
            return None
        env = self.env
        now = env.now
        t_foreign, allowed = env.scan_window(allow=self._pump_allow())
        if not allowed:
            return None
        t_bound = min(t_foreign, self._quarantine_bound(now))
        # Serving's admission-window bound (``fuse_spans="slo"``): never
        # speculate past the stream's revealed frontier.  INCLUSIVE,
        # unlike the foreign/quarantine bounds: a tick landing exactly on
        # the frontier is safe — arrivals at that instant are already
        # revealed (``wait_released`` admits at ``released >= t`` for the
        # same reason), and anything revealed later bumps ``_span_epoch``
        # and aborts the replay before the affected tick.  Exclusive
        # truncation here is what used to clip mixed-horizon groups to
        # their minimum frontier and fragment the ragged batcher's
        # K-buckets.
        t_horizon = (
            self.span_horizon() if self.span_horizon is not None
            else float("inf")
        )
        cap = int(getattr(policy, "span_cap", 32))
        # Exact grid: iterated float adds, the same op sequence the
        # sequential timeout chain performs — anchor + k*interval can
        # differ by an ulp and shift every in-window event comparison.
        grid = [now]
        t = now
        for _ in range(cap - 1):
            t = t + self.interval
            if t >= t_bound or t > t_horizon:
                break
            grid.append(t)
        if len(grid) < 2:
            return None
        k_span = len(grid)
        slots: List[Task] = list(ctx.tasks)
        arrive: List[int] = [0] * len(slots)
        pump_ticks: List[int] = []
        any_delivery = False
        for (t_p, _prio, _seq, cb) in allowed:
            if t_p > grid[-1]:
                continue  # delivers beyond the span; stays armed
            # Delivery tick: first grid instant at-or-after the pump.  A
            # pump landing EXACTLY on a grid instant fires BEFORE that
            # tick — any in-window pump was armed before the span
            # started, so its heap seq precedes the replay timeout
            # scheduled one interval earlier (identical ordering to the
            # sequential chain's per-tick timeouts).
            tick_i = next(i for i in range(1, k_span) if grid[i] >= t_p)
            pump_ticks.append(tick_i)
            snap = cb.owner.pump_snapshot()
            if snap:
                any_delivery = True
            slots.extend(snap)
            arrive.extend([tick_i] * len(snap))
        if not any_delivery:
            return None
        plan = SpanPlan(ctx, grid, slots, arrive, pump_ticks,
                        self._span_epoch, self._disturb_epoch)
        outcome = place_span(ctx, plan)
        if outcome is None:
            self.span_stats["spans_declined"] += 1
            return None
        plan.outcome = outcome
        return plan

    def _serve_span(self, ctx: "TickContext", plan: SpanPlan):
        """Replay a priced span: commit the precomputed placements tick
        by tick, sleeping the normal interval in between so in-window
        events (transfers, the folded pumps themselves) fire exactly as
        they would sequentially.  Yields from ``_dispatch_loop``; returns
        True when the replay aborted at a fresh unprocessed tick instant
        (the caller re-enters its loop body without sleeping)."""
        env = self.env
        outcome = plan.outcome
        placements = outcome.placements  # [K, B] slot-indexed, host numpy
        slots = plan.slots
        slot_of = {task: s for s, task in enumerate(slots)}
        decreasing = bool(getattr(self.policy, "decreasing", False))
        if decreasing:
            dem = np.stack([t.demand for t in slots])
            norms = np.sqrt(np.sum(dem * dem, axis=1))
        self.span_stats["fused_spans"] += 1
        self.span_stats["span_ticks_sum"] += plan.n_ticks
        if plan.n_ticks > self.span_stats["span_ticks_max"]:
            self.span_stats["span_ticks_max"] = plan.n_ticks
        ready_k = list(ctx.tasks)
        for k in range(plan.n_ticks):
            if k > 0:
                yield env.timeout(self.interval)
                expected = plan.epoch + sum(
                    1 for pt in plan.pump_ticks if pt <= k
                )
                if self._span_epoch != expected or not self.is_active:
                    new = self._try_splice(plan, k, slot_of)
                    if new is None:
                        self.span_stats["span_aborts"] += 1
                        return True
                    # Splice committed: the running span's universe now
                    # includes the mid-span arrivals (joined at tick k)
                    # and the outcome matrix was re-run from the resident
                    # checkpoint — adopt both and keep replaying.
                    slots = plan.slots
                    for t in new:
                        slot_of[t] = len(slot_of)
                    placements = plan.outcome.placements
                    if decreasing:
                        dem = np.stack([t.demand for t in slots])
                        norms = np.sqrt(np.sum(dem * dem, axis=1))
                ready_k = []
                while self._wait_stack:
                    ready_k.append(self._wait_stack.pop())
                ready_k.extend(self.submit_q.drain())
                if any(t not in slot_of for t in ready_k):
                    # Defensive: the batch diverged from the speculation
                    # (should be unreachable under the epoch check) —
                    # serve this tick live and end the span.
                    self.span_stats["span_aborts"] += 1
                    sub_ctx = TickContext(self, ready_k, self._tick_seq)
                    with self.tracer.span(
                        "scheduler", "tick", env.now, n_ready=len(ready_k)
                    ) as span_args:
                        live_placements = self.policy.place(sub_ctx)
                        if self.tracer.enabled:
                            span_args["n_placed"] = int(
                                sum(1 for h in live_placements if h >= 0)
                            )
                    self._tick_seq += 1
                    visit = (
                        sub_ctx.visit_order
                        if sub_ctx.visit_order is not None
                        else range(len(ready_k))
                    )
                    self._dispatch_tick(
                        sub_ctx, ready_k, live_placements, visit
                    )
                    return False
                if not ready_k:
                    continue  # pool drained, cohort still ahead
                if self.meter:
                    self.meter.increment_scheduling_ops(len(ready_k))
                    now = env.now
                    for task in ready_k:
                        self._pending_since.setdefault(task, now)
            row = placements[k]
            pl = [int(row[slot_of[t]]) for t in ready_k]
            if self.tracer.enabled:
                with self.tracer.span(
                    "scheduler", "tick", env.now, n_ready=len(ready_k)
                ) as span_args:
                    span_args["n_placed"] = int(
                        sum(1 for h in pl if h >= 0)
                    )
            self._tick_seq += 1
            self.span_stats["fused_ticks"] += 1
            if decreasing:
                bn = norms[[slot_of[t] for t in ready_k]]
                visit = [int(j) for j in np.argsort(-bn, kind="stable")]
            else:
                visit = list(range(len(ready_k)))
            self._dispatch_tick(ctx, ready_k, pl, visit)
        return False

    def _try_splice(self, plan: SpanPlan, k: int, slot_of) -> Optional[list]:
        """Attempt a mid-span splice at replay tick ``k`` (round 20).

        Runs inside ``_serve_span``'s epoch-mismatch branch: the span
        speculated past a scheduler-visible mutation.  When that
        mutation is PURELY new arrivals (submissions + their pump
        fires — the disturbance epoch unchanged), the arrivals can be
        joined into the RUNNING span instead of aborting it: the policy
        re-runs the span from its resident span-entry checkpoint with
        the new slots joined at ``arrive = k``
        (``sched/tpu.py:span_splice``), verifies the committed prefix
        bit-identical, and hands back the extended placements matrix.
        On success the plan's universe/outcome are extended in place,
        the epoch re-anchored, and the replay continues — batch
        membership changed INSIDE the span.  Returns the joined tasks,
        or None to decline (the caller aborts exactly as before; the
        queues are only PEEKED here, never drained, so a decline leaves
        every task where the live tick expects it).

        Declines when: the policy has no splice support or checkpoint,
        any disturbance landed (completions / withdraw / preempt
        drain), a folded cohort also lands at tick ``k`` (its
        submit-queue drain order would interleave with the arrivals,
        while slot order cannot), the gate rejects an arrival, or the
        prefix check fails."""
        policy_splice = getattr(self.policy, "span_splice", None)
        if policy_splice is None or not self.is_active:
            return None
        if self._disturb_epoch != plan.disturb:
            return None
        if any(pt == k for pt in plan.pump_ticks):
            return None
        if any(t not in slot_of for t in self._wait_stack):
            return None  # foreign task in the wait stack — not a pure join
        new = [t for t in self.submit_q.items if t not in slot_of]
        if not new or any(not t.is_nascent for t in new):
            return None
        gate = self.splice_gate
        if gate is not None and not all(gate(t) for t in new):
            return None
        pl = policy_splice(plan.ctx, plan, k, new)
        if pl is None:
            return None
        plan.slots = list(plan.slots) + new
        plan.arrive = list(plan.arrive) + [k] * len(new)
        plan.outcome.placements = pl
        # Re-anchor: future expected-epoch checks count folded pumps
        # STRICTLY AFTER k on top of the epoch as of this commit.
        plan.epoch = self._span_epoch - sum(
            1 for pt in plan.pump_ticks if pt <= k
        )
        self.span_stats["span_splices"] += 1
        self.tracer.emit(
            "scheduler", "span_splice", self.env.now, tick=k,
            joined=len(new),
        )
        return new

    def _reschedule_ff_wake(self) -> None:
        """Pull a pending fast-forward wake back to the first grid tick
        strictly after now (a submission injected work mid-window).  The
        woken loop processes that tick IMMEDIATELY — it is the first tick
        that can see the new work, exactly when the sequential chain
        would have drained it."""
        env = self.env
        t = self._ff_anchor
        while t <= env.now:
            t = t + self.interval
        if self._ff_rescheduled and t >= self._ff_target:
            return  # an earlier submission already pulled the wake ≤ t
        if self._ff_cb is not None:
            self._ff_cb.cancel()
        self._ff_rescheduled = True
        self._ff_target = t
        evt = self._ff_evt
        self._ff_cb = env.schedule_callback_at(
            t, lambda: None if evt.triggered else evt.succeed()
        )

    def _noop_tick_churn(self, stack: List[Task]) -> List[Task]:
        """Wait-stack state after one provably-no-op tick: drain
        (LIFO-reversed), visit in the policy's order, push back.  The
        decreasing VBP arms visit norm-descending (``_sort_decreasing``
        semantics — stable on ties); everything else visits in batch
        order, i.e. the stack simply reverses."""
        ready = list(reversed(stack))
        if getattr(self.policy, "decreasing", False):
            dem = np.stack([t.demand for t in ready])
            norms = np.sqrt(np.sum(dem * dem, axis=1))
            order = np.argsort(-norms, kind="stable")
            return [ready[int(i)] for i in order]
        return ready

    def _sleep_to_next_tick(self):
        """Sleep to the next tick that could possibly make progress,
        accounting the provably-no-op ticks in between without paying a
        policy dispatch for any of them.  The last hop is a plain
        ``timeout(interval)`` issued from the final skipped instant, so
        same-instant event ordering at the productive tick is identical
        to the sequential chain's."""
        env = self.env
        interval = self.interval
        anchor = env.now
        # O(1) bail before the O(heap) scan: an event due before the
        # next tick makes that tick the first potentially-productive one
        # — nothing to skip (the overwhelmingly common case in busy
        # phases, where the heap is at its largest).
        if env.peek() < anchor + interval:
            yield env.timeout(interval)
            return
        t_foreign, _ = env.scan_window()
        t_bound = min(t_foreign, self._quarantine_bound(anchor))
        # First grid tick at-or-after the bound may see input — run it.
        # Everything strictly before is a no-op: empty-ready if the wait
        # stack is empty, a zero-placement re-scan otherwise.
        n_skip = 0
        t = anchor + interval
        if t_bound != float("inf"):
            while t < t_bound and n_skip < 1_000_000:
                n_skip += 1
                t = t + interval
        if n_skip == 0:
            yield env.timeout(interval)
            return
        self._ff_anchor = anchor
        self._ff_rescheduled = False
        self._ff_target = float("inf")
        evt = env.event()
        self._ff_evt = evt
        # Wake at the LAST no-op instant (one interval short of the
        # productive tick); the final timeout below is issued from that
        # instant exactly like the sequential chain's last timeout, so
        # same-instant event ordering at the productive tick matches.
        last_noop = anchor
        for _ in range(n_skip):
            last_noop = last_noop + interval
        self._ff_cb = env.schedule_callback_at(
            last_noop, lambda: None if evt.triggered else evt.succeed()
        )
        yield evt
        self._ff_evt = None
        self._ff_cb = None
        rescheduled = self._ff_rescheduled
        self._ff_rescheduled = False
        # Lazily account what was actually skipped — an early wake via
        # ``submit`` shortens the window, and its wake instant is the
        # first tick that can SEE the submission: it is processed, not
        # skipped.  A normal wake's instant is itself a provable no-op;
        # the trailing timeout then reaches the productive tick.
        now = env.now
        skipped = 0
        t = anchor + interval
        while t < now:
            skipped += 1
            t = t + interval
        if not rescheduled:
            skipped += 1  # the wake instant itself (t == now)
        stack = self._wait_stack
        if skipped > 0:
            self.span_stats["ff_ticks"] += skipped
        if skipped > 0 and stack:
            if self.meter:
                self.meter.increment_scheduling_ops(skipped * len(stack))
            if self.tracer.enabled:
                t = anchor
                for _ in range(skipped):
                    t = t + interval
                    with self.tracer.span(
                        "scheduler", "tick", t, n_ready=len(stack)
                    ) as span_args:
                        span_args["n_placed"] = 0
            self._tick_seq += skipped
            # Stack churn has period 2 after the first tick (a stable
            # sort of a reversed sorted list flips tie runs; flipping
            # again restores them), so two explicit churns cover any m.
            s1 = self._noop_tick_churn(stack)
            if skipped == 1:
                final = s1
            else:
                s2 = self._noop_tick_churn(s1)
                final = s1 if skipped % 2 == 1 else s2
            self._wait_stack = final
        if not rescheduled:
            yield env.timeout(interval)

    # -- the completion listener -----------------------------------------
    def _listen_loop(self):
        env = self.env
        notify_q = self.cluster.notify_q
        while self.is_active:
            item = yield notify_q.get()
            self._handle_notification(item)
            # Same-instant batching: notifications already queued (e.g. a
            # whole admission-failure batch) are handled in FIFO order
            # without one get-event round-trip each.
            for queued in notify_q.drain():
                self._handle_notification(queued)

    def _handle_notification(self, item):
        env = self.env
        self._span_epoch += 1  # completions invalidate speculated spans
        self._disturb_epoch += 1
        success, task = item
        app = task.application
        if app is None:
            self.logger.error("task %s has no application", task.id)
            return
        local = self._local.get(app.id)
        if local is None:
            if app.id in self._failed_apps:
                # Late notification for a dead-lettered application: an
                # in-flight sibling concluded after the app failed.
                # Account it so the conservation audit still balances.
                if success:
                    task.set_finished()
                else:
                    task.set_nascent()
                    task.placement = None
                    self._cancel_task(task)
                return
            self.logger.error("application %s unknown", app.id)
            return
        if success:
            if self.breaker is not None and task.placement is not None:
                self.breaker.record_success(task.placement)
            if self.retry is not None:
                self._attempts.pop(task, None)
            task.set_finished()
            self.tracer.emit(
                "task", "finished", env.now, id=task.id, host=task.placement
            )
            if self.tracer.enabled:
                self._stage_task(task, "task_finished")
            local.notify(task)
        else:
            failed_host = task.placement
            if self.breaker is not None and failed_host is not None:
                if self.breaker.record_failure(failed_host, env.now):
                    self.tracer.emit(
                        "host", "quarantined", env.now, id=failed_host,
                        until=env.now + self.breaker.cooldown,
                    )
            task.set_nascent()
            task.placement = None
            if self.retry is not None:
                attempts = self._attempts.get(task, 0) + 1
                self._attempts[task] = attempts
                # Tier-aware budget: multi-tenant serving stamps the
                # app's priority tier at injection; batch apps default
                # to tier 0, which resolves to the classic budget.
                tier = int(getattr(app, "_serve_tier", 0))
                if self.retry.exhausted(attempts, tier):
                    self._dead_letter(task, failed_host, attempts)
                    return
                self.tracer.emit("task", "retry", env.now, id=task.id)
                if self.tracer.enabled:
                    self._stage_task(task, "retry", attempt=attempts)
                delay = self.retry.backoff(attempts, task.id)
                if delay > 0.0:
                    # Backed-off resubmission: the task re-enters the
                    # submit queue only after its (deterministically
                    # jittered) delay — de-synchronizing the retry wave
                    # a correlated outage creates.
                    env.schedule_callback(
                        delay, lambda t=task: self.submit_q.put(t)
                    )
                else:
                    self.submit_q.put(task)
            else:
                self.tracer.emit("task", "retry", env.now, id=task.id)
                if self.tracer.enabled:
                    self._stage_task(task, "retry")
                self.submit_q.put(task)
        if app.is_finished:
            app.end_time = env.now
            self.tracer.emit("app", "finished", env.now, id=app.id)
            self.logger.debug(
                "[%.3f] application %s finished in %.3f s",
                env.now,
                app.id,
                app.end_time - app.start_time,
            )
            self._local.pop(app.id, None)
            self._n_unfinished -= 1

    # -- retry governance (``sched/retry.py``) ----------------------------
    def _cancel_task(self, task: Task) -> None:
        """Drop a task whose application has already failed: it is never
        (re)placed; its pending bookkeeping is released."""
        self.n_cancelled += 1
        self._pending_since.pop(task, None)
        self._attempts.pop(task, None)
        self.tracer.emit("task", "cancelled", self.env.now, id=task.id)

    def _dead_letter(
        self, task: Task, host_id: Optional[str], attempts: int,
        reason: str = "retry_budget",
    ) -> None:
        """Terminal path for a budget-exhausted task: record it, shed the
        reason to the SLO meter, and fail its application (a DAG with a
        permanently lost task can never finish — leaving it live would
        keep the scheduler loop alive forever, the reference's wedge)."""
        task.set_dead()
        self._attempts.pop(task, None)
        self._pending_since.pop(task, None)
        entry = DeadLetter(
            task.id, task.application.id, host_id, reason, self.env.now,
            attempts, tier=int(getattr(task.application, "_serve_tier", 0)),
        )
        self.dead_letters.append(entry)
        if self.slo is not None:
            self.slo.record_shed(reason)
        self.tracer.emit(
            "task", "dead_letter", self.env.now, id=task.id, reason=reason,
            attempts=attempts, host=host_id,
        )
        if self.tracer.enabled:
            self._stage_task(
                task, "dead_letter", reason=reason, attempts=attempts
            )
        self.logger.warning(
            "[%.3f] task %s dead-lettered after %d attempts (%s)",
            self.env.now, task.id, attempts, reason,
        )
        self._fail_application(task.application)

    def _fail_application(self, app: Application) -> None:
        if app.id in self._failed_apps:
            return
        self._failed_apps.add(app.id)
        app.failed = True
        app.end_time = self.env.now
        self.tracer.emit("app", "failed", self.env.now, id=app.id)
        if self._local.pop(app.id, None) is not None:
            self._n_unfinished -= 1
