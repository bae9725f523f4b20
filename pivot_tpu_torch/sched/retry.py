"""Retry governance: bounded backoff retries, dead-lettering, host quarantine.

The reference's only failure semantics are *resubmit forever*: a failed
task is reset to NASCENT and re-queued unconditionally
(``scheduler/__init__.py:136-139``), every tick, for as long as the
simulation runs.  That is the textbook retry-storm shape — a workload
that cannot ever fit (or a host that kills everything placed on it)
consumes scheduler ticks and placement bandwidth forever, and a single
poisoned task wedges its application into an unfinishable state that
keeps the whole run alive.  Production schedulers bound exactly this
machinery (Borg's per-task retry limits and machine quarantine,
PAPERS.md); this module supplies the three governance pieces the
scheduler loop wires in (``sched/__init__.py``):

  * :class:`RetryPolicy` — per-task retry budgets and exponential
    backoff with **deterministic jitter**: the jitter draw is a pure
    hash of ``(seed, task id, attempt)``, so two runs of the same seeded
    simulation back off identically (no hidden RNG stream, no
    cross-contamination with workload/cluster draws).
  * :class:`DeadLetter` / the scheduler's dead-letter queue — a task
    that exhausts its budget terminates *exactly once* as dead-lettered
    (new terminal ``TaskState.DEAD``), its application is marked failed,
    and the shed reason reaches the serving SLO meter.  The invariant
    auditor (``infra/audit.py``) checks the conservation law this
    creates: admitted ⇒ completed | dead-lettered | cancelled-with-app.
  * :class:`HostCircuitBreaker` — K *consecutive* task failures on one
    host quarantine it for a cooldown.  Quarantine is advisory state on
    the scheduler (the host object is untouched — it may be perfectly
    healthy and is still running already-resident tasks): it surfaces as
    the ``[H]`` live mask every placement backend fuses into its fit
    mask (``TickContext.live_mask`` → ``sched/policies.fold_quarantine``
    / the kernels' ``live`` argument), so no NEW placement lands on a
    quarantined host while the cooldown runs.
  * :class:`RetryGate` — a process-wide cap on *concurrent* retries
    (round 21, the serve recovery plane): backoff spreads a retry wave
    in time, the gate bounds its width, so a degraded device cannot
    amplify one slow dispatch into a metastable retry storm.

All of these are inert by default — ``GlobalScheduler(retry=None,
breaker=None)`` keeps the reference-parity resubmit-forever loop
bit-identical to before this module existed.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

__all__ = ["DeadLetter", "HostCircuitBreaker", "RetryGate", "RetryPolicy"]


def _unit_hash(*parts) -> float:
    """Deterministic uniform in [0, 1) from a tuple of hashable parts —
    the jitter source.  blake2b, not ``hash()``: Python string hashing
    is salted per process and would break run-to-run reproducibility."""
    digest = hashlib.blake2b(
        ":".join(str(p) for p in parts).encode(), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big") / 2.0**64


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded, backed-off retries for failed task executions.

    ``max_retries`` is the per-task retry budget: a task may fail at most
    ``max_retries`` times and still be resubmitted; failure number
    ``max_retries + 1`` dead-letters it (``None`` = unbounded, the
    reference's semantics, but with backoff still applied).  Backoff for
    failure ``attempt`` (1-based) is ``min(base · factor^(attempt−1),
    cap)`` sim-seconds, multiplied by ``1 ± jitter·u`` where ``u`` is the
    deterministic per-(task, attempt) hash draw — de-synchronizing the
    retry wave a correlated outage creates (every task aborted by a zone
    failure would otherwise land on the same future tick, the classic
    retry-storm resonance) without sacrificing reproducibility.
    """

    max_retries: Optional[int] = 3
    base: float = 0.0
    factor: float = 2.0
    cap: float = 300.0
    jitter: float = 0.1
    seed: int = 0
    #: Optional per-tier retry budgets for multi-tenant serving
    #: (``pivot_tpu_torch.serve``): index = priority tier (0 = most important,
    #: tiers beyond the tuple use its last entry), value = that tier's
    #: ``max_retries`` (``None`` = unbounded).  Production cells spend
    #: far more retry budget on serving work than on best-effort batch
    #: (Borg-NG, PAPERS.md); this is that knob.  ``None`` (default) uses
    #: ``max_retries`` for every tier — bit-identical to pre-tier runs.
    tier_max_retries: Optional[tuple] = None

    def __post_init__(self):
        if self.max_retries is not None and self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.base < 0 or self.cap < 0:
            raise ValueError("backoff base/cap must be >= 0")
        if self.factor < 1.0:
            raise ValueError(f"backoff factor must be >= 1, got {self.factor}")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")
        if self.tier_max_retries is not None:
            t = tuple(self.tier_max_retries)
            if not t or any(b is not None and b < 0 for b in t):
                raise ValueError(
                    f"tier_max_retries must be a non-empty tuple of "
                    f"budgets >= 0 (or None), got {self.tier_max_retries!r}"
                )
            object.__setattr__(self, "tier_max_retries", t)

    def budget(self, tier: int = 0) -> Optional[int]:
        """Effective retry budget for ``tier`` (``None`` = unbounded)."""
        if self.tier_max_retries is None:
            return self.max_retries
        return self.tier_max_retries[
            min(tier, len(self.tier_max_retries) - 1)
        ]

    def exhausted(self, attempts: int, tier: int = 0) -> bool:
        """True once ``attempts`` failures have overdrawn ``tier``'s
        budget (tier 0 with no per-tier table = the classic budget)."""
        budget = self.budget(tier)
        return budget is not None and attempts > budget

    def max_attempts(self, tier: int = 0) -> Optional[int]:
        """Explicit total-attempt bound for ``tier``: the initial try
        plus its retry budget (``None`` = unbounded).  The recovery
        plane's dispatch watchdog sizes its loop off THIS, not off the
        raw retry budget, so "how many times may this run at all" is a
        stated number rather than an off-by-one folklore."""
        budget = self.budget(tier)
        return None if budget is None else budget + 1

    def backoff(self, attempt: int, key: str) -> float:
        """Sim-seconds to wait before resubmitting failure ``attempt`` of
        the task identified by ``key`` (its id).  Deterministic: the
        jitter draw is the seeded ``_unit_hash(seed, key, attempt)`` —
        never an ambient RNG — so a journaled replay backs off
        identically to the run it replays."""
        if self.base <= 0.0:
            return 0.0
        delay = min(self.base * self.factor ** (attempt - 1), self.cap)
        if self.jitter > 0.0:
            u = _unit_hash(self.seed, key, attempt)
            delay *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return delay


class RetryGate:
    """Cap on CONCURRENT retries — the metastable-failure guard.

    Backoff de-synchronizes a retry wave in *time*; this gate bounds it
    in *width*.  Bronson et al. ("Metastable Failures", PAPERS.md): a
    degraded device that slows every dispatch turns unbounded retry
    concurrency into a sustaining feedback loop — retries of slow work
    make the work slower, which makes more of it retry.  Admission to a
    retry therefore goes through this gate: at most ``max_concurrent``
    retries may be in flight across the process at once, and a caller
    that cannot get a slot within its patience *sheds* (fails fast)
    rather than queueing more load onto a plane that is already
    drowning.

    Thread-safe; shared by every dispatch path of one recovery plane.
    ``peak`` records the high-water mark (the soak test's cap
    assertion), ``shed`` the fast-failed acquisitions.
    """

    def __init__(self, max_concurrent: int = 2):
        if max_concurrent < 1:
            raise ValueError(
                f"max_concurrent must be >= 1, got {max_concurrent}"
            )
        self.max_concurrent = int(max_concurrent)
        self._cv = threading.Condition()
        self._in_flight = 0
        self.peak = 0
        self.shed = 0

    def acquire(self, timeout: Optional[float] = 0.0) -> bool:
        """Take a retry slot; False (a shed) when none frees up within
        ``timeout`` wall seconds (0 = fail fast, None = wait forever)."""
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self._in_flight < self.max_concurrent,
                timeout=timeout,
            )
            if not ok:
                self.shed += 1
                return False
            self._in_flight += 1
            self.peak = max(self.peak, self._in_flight)
            return True

    def release(self) -> None:
        with self._cv:
            if self._in_flight <= 0:
                raise RuntimeError("RetryGate.release without acquire")
            self._in_flight -= 1
            self._cv.notify()

    @property
    def in_flight(self) -> int:
        with self._cv:
            return self._in_flight


@dataclass(frozen=True)
class DeadLetter:
    """One dead-lettered task: the terminal record the audit reconciles."""

    task_id: str
    app_id: str
    host_id: Optional[str]  # last placement that failed (None: never placed)
    reason: str  # "retry_budget" | "app_failed"
    at: float  # sim time of dead-lettering
    attempts: int  # failures consumed (== budget(tier) + 1 on exhaustion)
    tier: int = 0  # the app's serving tier (0 outside multi-tenant serving)


class HostCircuitBreaker:
    """Quarantine a host after K consecutive task failures on it.

    Failure streaks count *consecutive* failures — any successful
    completion on the host resets its streak, so a transient blip never
    trips the breaker.  Tripping quarantines the host for ``cooldown``
    sim-seconds and resets the streak (the host re-enters placement
    clean when the cooldown expires; if it keeps killing tasks it trips
    again — repeated trips are visible in :attr:`trips`).

    Purely scheduler-side state: consult :meth:`is_quarantined` /
    :meth:`live_mask` at decision time.  Not thread-safe; each scheduler
    (session) owns its own breaker.
    """

    def __init__(self, k: int = 3, cooldown: float = 60.0):
        if k < 1:
            raise ValueError(f"breaker threshold k must be >= 1, got {k}")
        if cooldown <= 0:
            raise ValueError(f"cooldown must be > 0, got {cooldown}")
        self.k = k
        self.cooldown = cooldown
        self._streak: Dict[str, int] = {}
        self._until: Dict[str, float] = {}
        #: (sim time, host id, quarantined-until) per trip, in trip order.
        self.trips: List[Tuple[float, str, float]] = []

    def record_failure(self, host_id: str, now: float) -> bool:
        """One task failure attributed to ``host_id``; returns True when
        this failure trips the breaker (host newly quarantined)."""
        streak = self._streak.get(host_id, 0) + 1
        if streak >= self.k:
            self._streak[host_id] = 0
            self._until[host_id] = now + self.cooldown
            self.trips.append((now, host_id, now + self.cooldown))
            return True
        self._streak[host_id] = streak
        return False

    def record_success(self, host_id: str) -> None:
        """A task completed on ``host_id`` — its failure streak resets.
        An existing quarantine runs its cooldown out regardless (the
        success is an already-resident task finishing, not evidence the
        next placement is safe)."""
        if self._streak.get(host_id):
            self._streak[host_id] = 0

    def is_quarantined(self, host_id: str, now: float) -> bool:
        until = self._until.get(host_id)
        if until is None:
            return False
        if now >= until:
            del self._until[host_id]  # expired: prune so the dict stays small
            return False
        return True

    @property
    def n_quarantined(self) -> int:
        """Hosts with a (possibly expired, not yet pruned) quarantine."""
        return len(self._until)

    def next_expiry(self, now: float) -> float:
        """Earliest instant a live quarantine expires, or ``+inf``.

        Quarantine expiry is the one scheduler-visible state change that
        happens by CLOCK rather than by event (``is_quarantined`` just
        compares ``now``), so the pure-tick-run extractor must bound its
        fused windows by it: a tick at or past an expiry sees a larger
        live mask and is no longer a provable no-op."""
        live = [u for u in self._until.values() if u > now]
        return min(live) if live else float("inf")
