"""Bounded, tier-aware admission control for the stream driver.

The admission queue bounds **in-flight work** — jobs admitted into a
scheduling session but not yet completed.  (A buffer of *unrouted*
arrivals would always be drained instantly by the router and never
exert backpressure; what an always-on scheduler must bound is the work
it has accepted responsibility for.)  ``depth`` is therefore the
service's concurrent-job capacity, and the queue-depth histogram the
SLO meter records at each offer is the in-flight count.

Three backpressure policies when the queue is full:

  * ``shed``  — reject the arrival, recording the reason
    (``queue_full``) in the SLO meter.  Lossy, latency-protecting.
  * ``spill`` — defer the arrival to a spill buffer; the driver
    re-offers it at the next completion boundary with its submission
    time pushed to the following scheduler grid point ("spill to next
    tick").  Lossless, order-preserving, latency-paying.
  * ``block`` — the producer waits for capacity.  Lossless with the
    original timestamps, but couples the arrival loop to completion
    wall-time; in replay mode the driver advances the sim-release gate
    while blocked so the wait can resolve deterministically.

**Priority tiers** (round 9, the Borg-NG batch/serving split —
PAPERS.md): every :class:`~pivot_tpu_torch.serve.arrivals.JobArrival` carries
a ``tier`` (0 = most important), and the queue can be built with

  * ``tier_reserve`` — per-tier depth reservations: ``reserve[t]``
    slots are off-limits to arrivals of tier ``t`` (tiers beyond the
    sequence use its last entry), so tier t's effective depth is
    ``depth − reserve[t]``.  Tier 0 conventionally reserves 0: under
    load the low tiers run out of queue *first*, which is exactly the
    "shed low tiers before blocking high ones" ordering.
  * ``tier_policies`` — per-tier backpressure override (same indexing),
    e.g. ``("spill", "shed", "shed")``: tier 0 is lossless while lower
    tiers absorb the sheds.

The spill buffer re-offers in **(tier, arrival-timestamp) order** — the
highest surviving tier first, original arrival order within a tier,
*including* preemption victims re-entering at their original arrival
position (the single-tier case degenerates to pure FIFO, the documented
re-offer ordering guarantee ``tests/test_serve.py`` pins).  Both tier
knobs default to off, under which every decision, counter, and re-offer
is bit-identical to the single-tenant queue.

**Tenant fairness within a tier** (round 17, the DRF shape — Ghodsi et
al.'s dominant-resource fairness under Borg's quota/priority split,
PAPERS.md): tiers order *importance classes*, but inside one tier every
tenant competes for the same reservation, and a single chatty tenant
can occupy a tier's whole effective depth.  With ``tenant_quota=q``
(0 < q ≤ 1) the queue tracks each tenant's **dominant-resource
occupancy** per tier — the sum of its in-flight jobs' dominant shares,
where a job's dominant share is ``max_r(demand_r / capacity_r)``
against the ``capacity`` reference vector (job-count shares when no
capacity is given) — and an arrival whose admission would push its
tenant past ``q`` of the tier's total occupancy is *over quota*: it is
shed/spilled by the tier's backpressure policy with the recorded
reason ``tenant_quota``.  Work-conserving: a tenant alone in its tier
is never quota-limited (idle capacity is not wasted on fairness), and
occupancy releases exactly when the admission settles, so the serve
conservation audit (``infra/audit.py::audit_serve``) can assert the
ledger drains to zero.  ``tenant_quota=None`` (default) keeps every
decision bit-identical to the quota-free queue.

Decisions are returned as module constants (``ADMITTED`` / ``SHED`` /
``SPILLED`` / ``BLOCKED``); the blocking dance itself lives in the
driver, which owns the condition variable the completions notify (as
does in-queue *preemption*, which frees low-tier in-flight capacity
when a high-tier arrival would otherwise degrade — ``serve/driver.py``).

JAX-free copy of ``pivot_tpu/serve/admission.py``, import paths rewritten.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

from pivot_tpu_torch.infra.meter import SloMeter

__all__ = [
    "ADMITTED",
    "AdmissionQueue",
    "BLOCKED",
    "SHED",
    "SPILLED",
    "dominant_share",
]


def dominant_share(app, capacity: Optional[Sequence[float]]) -> float:
    """A job's DRF dominant share: its total demand's largest fraction
    of the ``capacity`` reference vector (cpus, mem, disk, gpus).
    Falls back to 1.0 — job-count shares — when no capacity vector or
    demand is available (synthetic/unit-test apps)."""
    if capacity is None or app is None:
        return 1.0
    totals = [0.0, 0.0, 0.0, 0.0]
    for group in getattr(app, "groups", ()) or ():
        n = len(getattr(group, "tasks", ()) or ())
        for i, dim in enumerate(("cpus", "mem", "disk", "gpus")):
            totals[i] += n * float(getattr(group, dim, 0.0) or 0.0)
    share = 0.0
    for used, cap in zip(totals, capacity):
        if cap and cap > 0:
            share = max(share, used / float(cap))
    return share if share > 0 else 1.0

ADMITTED = "admitted"
SHED = "shed"
SPILLED = "spilled"
BLOCKED = "blocked"

_POLICIES = ("block", "shed", "spill")


class AdmissionQueue:
    """In-flight bound + backpressure decision.  NOT thread-safe on its
    own: the driver serializes every call under its coordination lock
    (the same lock completions notify), so decision + counter update are
    atomic with respect to releases."""

    def __init__(self, depth: int, policy: str = "shed",
                 slo: Optional[SloMeter] = None,
                 tier_reserve: Optional[Sequence[int]] = None,
                 tier_policies: Optional[Sequence[str]] = None,
                 tenant_quota: Optional[float] = None,
                 capacity: Optional[Sequence[float]] = None):
        if depth < 1:
            raise ValueError("admission queue depth must be >= 1")
        if policy not in _POLICIES:
            raise ValueError(
                f"unknown backpressure policy {policy!r} (use one of "
                f"{_POLICIES})"
            )
        if tier_reserve is not None:
            tier_reserve = tuple(int(r) for r in tier_reserve)
            if not tier_reserve or any(r < 0 for r in tier_reserve):
                raise ValueError(
                    f"tier_reserve must be non-empty, non-negative, got "
                    f"{tier_reserve!r}"
                )
            if max(tier_reserve) >= depth:
                raise ValueError(
                    f"tier_reserve {tier_reserve!r} leaves no capacity at "
                    f"depth {depth}"
                )
        if tier_policies is not None:
            tier_policies = tuple(tier_policies)
            bad = [p for p in tier_policies if p not in _POLICIES]
            if not tier_policies or bad:
                raise ValueError(
                    f"tier_policies must be drawn from {_POLICIES}, got "
                    f"{tier_policies!r}"
                )
        if tenant_quota is not None and not (0.0 < tenant_quota <= 1.0):
            raise ValueError(
                f"tenant_quota must be in (0, 1], got {tenant_quota!r}"
            )
        if capacity is not None:
            capacity = tuple(float(c) for c in capacity)
            if len(capacity) != 4 or any(c < 0 for c in capacity):
                raise ValueError(
                    "capacity must be 4 non-negative totals "
                    f"(cpus, mem, disk, gpus), got {capacity!r}"
                )
        self.depth = depth
        self.policy = policy
        self.tier_reserve = tier_reserve
        self.tier_policies = tier_policies
        #: DRF tenant fairness (module docstring): a tenant's dominant-
        #: resource occupancy within a tier may not exceed this share of
        #: the tier's total occupancy.  None = quota off (bit-parity).
        self.tenant_quota = tenant_quota
        self.capacity = capacity
        #: (tier, tenant) → in-flight dominant-share occupancy.  Only
        #: maintained when the quota is on; audited to drain to zero.
        self.tenant_occupancy: Dict[Tuple[int, str], float] = {}
        self.slo = slo or SloMeter()
        self.in_flight = 0
        #: Spill buffer, kept sorted by (tier, arrival ts): re-offers
        #: serve the most important surviving tier first and preserve
        #: original arrival order within a tier.
        self.spilled: List = []
        self._spill_keys: List[tuple] = []
        self._arrival_seq = 0

    @staticmethod
    def _tier_of(arrival) -> int:
        return int(getattr(arrival, "tier", 0))

    @staticmethod
    def _tenant_of(arrival) -> str:
        return str(getattr(arrival, "tenant", "default"))

    def _dom_of(self, arrival) -> float:
        """The arrival's dominant share, computed once and cached on the
        app (preemption victims and spill re-offers reuse the SAME
        share their admission charged, so occupancy balances exactly)."""
        app = getattr(arrival, "app", None)
        if app is None:
            return 1.0
        d = getattr(app, "_serve_dom_share", None)
        if d is None:
            d = dominant_share(app, self.capacity)
            try:
                app._serve_dom_share = d
            except AttributeError:
                pass  # slotted test double; recompute next time
        return d

    def over_quota(self, arrival) -> bool:
        """Would admitting ``arrival`` push its tenant past its DRF
        share of the tier's occupancy?  Work-conserving: False whenever
        the tenant is alone in the tier (no other occupancy to be
        unfair to).  Always False with the quota off."""
        if self.tenant_quota is None:
            return False
        tier = self._tier_of(arrival)
        tenant = self._tenant_of(arrival)
        d = self._dom_of(arrival)
        mine = self.tenant_occupancy.get((tier, tenant), 0.0)
        total = sum(
            v for (t, _), v in self.tenant_occupancy.items() if t == tier
        )
        others = total - mine
        if others <= 1e-12:
            return False
        return (mine + d) > self.tenant_quota * (total + d) + 1e-9

    def admissible(self, arrival) -> bool:
        """Room at the arrival's tier AND within its tenant's quota —
        the one predicate the driver's readmission paths consult."""
        return self.has_room(self._tier_of(arrival)) and not (
            self.over_quota(arrival)
        )

    def _per_tier(self, table, tier: int, default):
        if table is None:
            return default
        return table[min(tier, len(table) - 1)]

    def reserve_for(self, tier: int) -> int:
        return self._per_tier(self.tier_reserve, tier, 0)

    def policy_for(self, tier: int) -> str:
        return self._per_tier(self.tier_policies, tier, self.policy)

    @property
    def full(self) -> bool:
        return self.in_flight >= self.depth

    def has_room(self, tier: int) -> bool:
        """Capacity check at ``tier``'s effective depth (reservations for
        more-important tiers subtracted)."""
        return self.in_flight < self.depth - self.reserve_for(tier)

    def offer(self, arrival) -> str:
        """One admission decision.  ``ADMITTED`` increments the in-flight
        count (the caller routes the job); ``BLOCKED`` means the caller
        must wait for capacity and re-offer.  An arrival with room at
        its tier but OVER its tenant's quota takes the tier's
        backpressure policy with the shed reason ``tenant_quota``."""
        tier = self._tier_of(arrival)
        self.slo.count("arrived")
        self.slo.count_tier(tier, "arrived")
        self.slo.record_queue_depth(self.in_flight)
        if self.has_room(tier):
            if self.over_quota(arrival):
                policy = self.policy_for(tier)
                if policy == "shed":
                    self.slo.record_shed("tenant_quota", tier=tier)
                    return SHED
                if policy == "spill":
                    self.spill(arrival)
                    return SPILLED
                return BLOCKED
            self._admit_one(arrival)
            return ADMITTED
        policy = self.policy_for(tier)
        if policy == "shed":
            self.slo.record_shed("queue_full", tier=tier)
            return SHED
        if policy == "spill":
            self.spill(arrival)
            return SPILLED
        return BLOCKED

    def _admit_one(self, arrival) -> None:
        tier = self._tier_of(arrival)
        self.in_flight += 1
        self.slo.count("admitted")
        self.slo.count_tier(tier, "admitted")
        if self.tenant_quota is not None:
            key = (tier, self._tenant_of(arrival))
            self.tenant_occupancy[key] = (
                self.tenant_occupancy.get(key, 0.0) + self._dom_of(arrival)
            )

    def spill(self, arrival, count: bool = True) -> None:
        """Park an arrival in the spill buffer, sorted by (tier,
        original arrival timestamp, insertion seq): re-offers serve the
        most important surviving tier first and ORIGINAL arrival order
        within a tier.  Keying on the arrival's own timestamp (not
        insertion order) is what keeps the guarantee through
        preemption — a victim requeued here re-enters at its original
        arrival position, ahead of same-tier jobs that arrived later
        but spilled earlier.  ``count=False`` skips the ``spilled``
        counters — the preemption path meters its victim as
        ``preempted``, not as a fresh spill."""
        tier = self._tier_of(arrival)
        key = (tier, float(getattr(arrival, "ts", 0.0)), self._arrival_seq)
        self._arrival_seq += 1
        idx = bisect.bisect(self._spill_keys, key)
        self._spill_keys.insert(idx, key)
        self.spilled.insert(idx, arrival)
        if count:
            self.slo.count("spilled")
            self.slo.count_tier(tier, "spilled")

    def peek_spill(self):
        """Head of the spill buffer (highest tier, oldest) or None."""
        return self.spilled[0] if self.spilled else None

    def pop_spill(self, idx: int = 0):
        """Remove and return the ``idx``-th spilled arrival (head by
        default; the driver's re-offer loop passes an index to skip
        past quota-blocked tenants without disturbing the order of
        what stays spilled)."""
        self._spill_keys.pop(idx)
        return self.spilled.pop(idx)

    def readmit(self, arrival) -> bool:
        """Re-offer a spilled/blocked arrival (no double counting of the
        ``arrived`` counter).  True = admitted; quota-aware like
        :meth:`offer` (a re-entering victim must not dodge its tenant's
        share)."""
        if not self.admissible(arrival):
            return False
        self._admit_one(arrival)
        return True

    def release(self, n: int = 1, tier: Optional[int] = None,
                tenant: Optional[str] = None,
                share: Optional[float] = None) -> None:
        """A job completed (or was preempted) — free its capacity.
        Depth reservations are headroom carved out of the shared bound,
        so the in-flight count is tier-blind; the DRF occupancy ledger
        is NOT — when the quota is on, the settling admission's
        (tier, tenant, dominant share) must come back so the tenant's
        occupancy drains exactly (``audit_serve`` asserts the residue
        is zero).  The tier-blind call shape stays valid for quota-free
        services (today's call sites, bit-identical)."""
        self.in_flight -= n
        assert self.in_flight >= 0, "admission release underflow"
        if self.tenant_quota is not None and tier is not None:
            key = (int(tier), tenant or "default")
            left = self.tenant_occupancy.get(key, 0.0) - (
                share if share is not None else 1.0
            )
            if abs(left) < 1e-9:
                self.tenant_occupancy.pop(key, None)
            else:
                self.tenant_occupancy[key] = left
