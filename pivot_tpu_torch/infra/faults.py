"""Fault injection: host crash/recovery and bandwidth fluctuation.

The reference has **no fault model** (SURVEY.md §5): its only "failure" is
admission rejection, its ``NetworkRoute._fluctuate`` is an empty stub
(``resources/network.py:102-103``), and no host or link ever goes down.
It does, however, ship a complete failure-handling path — failed tasks are
reset to NASCENT and resubmitted forever (``scheduler/__init__.py:136-139``).
This module supplies the missing fault *sources* so that path (mirrored by
``GlobalScheduler._listen_loop``) is exercised as elastic recovery:

  * **Host crash** — ``Host.fail()`` aborts every resident task mid-flight
    (staging or compute) via abort events raced inside ``Host.execute``;
    each surfaces as ``(False, task)`` on ``notify_q`` and is rescheduled
    elsewhere by the existing retry loop.  Down hosts report zero
    availability, so no fit mask can select them.  ``Host.recover()``
    returns a fresh machine.
  * **Bandwidth fluctuation** — periodic multiplicative resampling of live
    route bandwidth (the reference's intended-but-unimplemented
    ``_fluctuate``), applied between chunks so in-flight transfers see the
    new rate from their next chunk on.

All draws come from a dedicated seeded RNG, so fault schedules are
deterministic and independent of workload/cluster RNG streams.

**The chaos engine** (round 7) grows the independent-fault injector into
a failure-domain model — the four production fault classes a resilient
scheduler must absorb (Borg / Bamboo / chaos-engineering lineage,
PAPERS.md):

  * **Correlated domain outages** — :meth:`FaultInjector.fail_domain`
    takes down every host sharing a failure domain (a zone, or a whole
    cloud region) in one draw, using the same locality topology the
    placement kernels score with.
  * **Spot preemption with a warning lead** —
    :meth:`FaultInjector.preempt_host`: at the warning instant the host
    starts *draining* (``Host.draining`` — still running and admitting
    its residents, but excluded from NEW placements via the scheduler's
    live mask), and the abort fires only after the lead window, so
    short tasks drain out the way real spot workloads do.
  * **Transient stragglers** — :meth:`FaultInjector.slow_host`: a
    multiplicative compute slowdown for a window; compute *started*
    during the window is stretched, in-flight compute keeps its
    already-scheduled finish time.
  * **Region-pair network partitions** —
    :meth:`FaultInjector.partition_regions`: every route between two
    cloud regions suspends (in-wire chunks finish, queues park, nothing
    is dropped) until the partition heals; lazily materialized routes
    are caught by a cluster route hook.

All of it is drivable from a :class:`ChaosSchedule` — a serializable,
seeded event list that can be saved, replayed, and diffed
(``tools/chaos_replay.py``), which is what makes chaos runs regression-
testable: same schedule ⇒ bit-identical fault log and meter snapshot
(``tests/test_chaos.py``).

Copy of ``pivot_tpu/infra/faults.py`` (JAX-free there too), with the
import paths rewritten to the port's own layers.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from pivot_tpu_torch.des import Environment
from pivot_tpu_torch.utils import LogMixin
from pivot_tpu_torch.utils.trace import NULL_TRACER, Tracer

__all__ = [
    "ChaosEvent", "ChaosSchedule", "DeviceFaultPlan", "DeviceLostError",
    "FaultInjector", "check_schema_header", "device_ordinal",
]


class DeviceLostError(RuntimeError):
    """A dispatch targeted a mesh device that is down — raised
    deterministically at the dispatch boundary by the elastic fault gate
    (``serve/elastic.py``) when a :class:`DeviceFaultPlan` window covers
    the dispatch instant, or by real-loss classification.  Carries the
    dead ordinals so the elastic manager can shrink around them.  NOT
    swallowed by the ``degrade_after`` guard: device loss is a
    mesh-level event (shrink + reshard), not kernel flakiness (CPU-twin
    fallback)."""

    def __init__(self, ordinals, at: float):
        self.ordinals = tuple(sorted(int(o) for o in ordinals))
        self.at = float(at)
        super().__init__(
            f"mesh device(s) {list(self.ordinals)} down at t={self.at:g}"
        )


def device_ordinal(target: str) -> int:
    """Parse a ``"device:<ordinal>"`` chaos target into its ordinal.
    Raises ``ValueError`` on anything else — device events address mesh
    device slots (the compute plane), not DES hosts, and a host id
    leaking into a device event must fail at load, not replay."""
    s = str(target)
    if not s.startswith("device:"):
        raise ValueError(
            f"device event target must be 'device:<ordinal>', got {target!r}"
        )
    try:
        ordinal = int(s.split(":", 1)[1])
    except ValueError:
        raise ValueError(
            f"device event target must be 'device:<ordinal>', got {target!r}"
        ) from None
    if ordinal < 0:
        raise ValueError(f"device ordinal must be >= 0, got {ordinal}")
    return ordinal


class FaultInjector(LogMixin):
    """Schedules host crashes, recoveries, and bandwidth fluctuation on a
    cluster's event kernel.

    Create it after the cluster, before ``env.run()``; faults fire at their
    scheduled sim times.  ``tracer`` (optional) records structured
    ``host.failed`` / ``host.recovered`` events.
    """

    def __init__(
        self,
        cluster,
        seed: Optional[int] = None,
        tracer: Optional[Tracer] = None,
    ):
        self.cluster = cluster
        self.env: Environment = cluster.env
        self.rng = np.random.default_rng(seed)
        self.tracer = tracer or NULL_TRACER
        #: (sim_time, host_id, event) log of injected faults.
        self.log: List[Tuple[float, str, str]] = []
        # host_id -> sim time until which the host must stay down.
        # Overlapping outages extend to the union (max end), never truncate.
        self._down_until: dict = {}
        # Active region-pair partitions: frozenset of two (cloud, region)
        # tuples each.  Lazily materialized routes consult this through a
        # cluster route hook (installed on first partition).
        self._partitions: set = set()
        self._partition_hook_installed = False
        # Called with the Host at each spot-preemption WARNING instant
        # (after ``Host.draining`` is set): the proactive-survival hook
        # point — the scheduler registers its drain/migrate handler here
        # (``GlobalScheduler.on_preempt_warning``).  Empty by default, so
        # reactive worlds are untouched.
        self._warning_hooks: List = []
        # Called with (ordinal, kind, sim_now) at every device_fault /
        # device_restore instant — the elastic serving layer registers its
        # shrink/regrow trigger here.  Device events address mesh device
        # slots, not DES hosts, so the injector only logs and relays them.
        self._device_hooks: List = []

    def add_warning_hook(self, hook) -> None:
        """Register ``hook(host, lead)`` to run at every spot-preemption
        warning instant, after the host's drain flag is set (``lead`` is
        the seconds until the abort fires)."""
        self._warning_hooks.append(hook)

    def add_device_hook(self, hook) -> None:
        """Register ``hook(ordinal, kind, now)`` to run at every
        ``device_fault`` / ``device_restore`` instant (``kind`` is the
        event kind string).  The serving stack's elastic manager is the
        intended consumer; the DES-side cluster is untouched."""
        self._device_hooks.append(hook)

    # -- device (compute-plane) faults -------------------------------------
    def _device_event(self, ordinal: int, kind: str, at: float) -> None:
        """Schedule a device-plane event: log + tracer + relay to the
        registered device hooks.  Unlike host faults there is no DES-side
        state to mutate — the dispatch layer consults the
        :class:`DeviceFaultPlan` (and/or these hooks) directly."""

        def _fire():
            label = f"device:{ordinal}"
            self.log.append((self.env.now, label, kind))
            self.tracer.emit("device", kind, self.env.now, id=label)
            self.logger.debug("[%.3f] %s %s", self.env.now, label, kind)
            for hook in self._device_hooks:
                hook(ordinal, kind, self.env.now)

        self.env.schedule_callback_at(at, _fire)

    def fail_device(
        self, ordinal: int, at: float, duration: Optional[float] = None
    ) -> None:
        """Kill mesh device slot ``ordinal`` at sim time ``at``; restore
        it ``duration`` seconds later (never, if ``duration`` is None).
        The DES cluster is untouched — targeted dispatches raise through
        the :class:`DeviceFaultPlan` consulted at the dispatch boundary."""
        if ordinal < 0:
            raise ValueError(f"device ordinal must be >= 0, got {ordinal}")
        if duration is not None and duration <= 0:
            raise ValueError(
                f"device outage duration must be > 0 (or None for "
                f"permanent), got {duration}"
            )
        self._device_event(int(ordinal), "device_fault", at)
        if duration is not None:
            self._device_event(int(ordinal), "device_restore", at + duration)

    # -- host faults -----------------------------------------------------
    def fail_host(self, host_id: str, at: float, duration: Optional[float] = None):
        """Crash ``host_id`` at sim time ``at``; recover it ``duration``
        seconds later (never, if ``duration`` is None)."""
        host = self.cluster.get_host(host_id)
        if host is None:
            raise KeyError(f"unknown host {host_id!r}")
        if duration is not None and duration <= 0:
            raise ValueError(
                f"outage duration must be > 0 (or None for permanent), "
                f"got {duration}"
            )

        recover_at = at + duration if duration is not None else float("inf")

        def _fail():
            self._down_until[host.id] = max(
                self._down_until.get(host.id, 0.0), recover_at
            )
            if not host.up:  # already down: outage extended, no new event
                return
            n_resident = host.n_tasks
            host.fail()
            self.log.append((self.env.now, host.id, "failed"))
            self.tracer.emit(
                "host", "failed", self.env.now, id=host.id, n_aborted=n_resident
            )
            self.logger.debug(
                "[%.3f] host %s failed (%d tasks aborted)",
                self.env.now, host.id, n_resident,
            )

        def _recover():
            # Only the recovery matching the *latest* outage end fires —
            # overlapping outages union (a shorter second outage must not
            # resurrect the host mid-way through a longer first one).
            if self.env.now < self._down_until.get(host.id, 0.0):
                return
            if host.up:
                return
            host.recover()
            self.log.append((self.env.now, host.id, "recovered"))
            self.tracer.emit("host", "recovered", self.env.now, id=host.id)

        self.env.schedule_callback_at(at, _fail)
        if duration is not None:
            self.env.schedule_callback_at(recover_at, _recover)

    def random_host_failures(
        self,
        n_failures: int,
        horizon: float,
        mttr: Optional[float] = None,
        start: float = 0.0,
    ) -> List[Tuple[float, str]]:
        """Schedule ``n_failures`` crashes at uniform times in
        ``[start, horizon)`` on uniformly drawn hosts; each recovers after
        an Exp(mean=``mttr``) outage (never, if ``mttr`` is None).
        Returns the (time, host_id) schedule for assertions/reporting."""
        hosts = self.cluster.hosts
        if not hosts:
            raise ValueError(
                "random_host_failures needs a cluster with at least one "
                "host (rng.integers(0, 0) would otherwise fail opaquely)"
            )
        times = np.sort(self.rng.uniform(start, horizon, size=n_failures))
        picks = self.rng.integers(0, len(hosts), size=n_failures)
        schedule = []
        for t, hi in zip(times, picks):
            duration = (
                float(self.rng.exponential(mttr)) if mttr is not None else None
            )
            self.fail_host(hosts[int(hi)].id, float(t), duration)
            schedule.append((float(t), hosts[int(hi)].id))
        return schedule

    # -- correlated / failure-domain faults -------------------------------
    def _domain_members(self, domain: str) -> List:
        """Hosts inside failure domain ``domain`` — ``"cloud/region/zone"``
        (one zone) or ``"cloud/region"`` (every zone of a region)."""
        parts = str(domain).split("/")
        if len(parts) == 3:
            match = lambda loc: (loc.cloud, loc.region, loc.zone) == tuple(parts)  # noqa: E731
        elif len(parts) == 2:
            match = lambda loc: (loc.cloud, loc.region) == tuple(parts)  # noqa: E731
        else:
            raise ValueError(
                f"failure domain must be 'cloud/region' or "
                f"'cloud/region/zone', got {domain!r}"
            )
        return [h for h in self.cluster.hosts if match(h.locality)]

    def fail_domain(
        self, domain: str, at: float, duration: Optional[float] = None
    ) -> List[str]:
        """Correlated outage: one draw takes down EVERY host in ``domain``
        at sim time ``at`` (all recover together after ``duration``).
        Returns the member host ids.  The log carries a ``domain_outage``
        marker ahead of the per-host ``failed`` events."""
        members = self._domain_members(domain)
        if not members:
            raise ValueError(f"failure domain {domain!r} has no hosts")

        def _mark():
            self.log.append((self.env.now, str(domain), "domain_outage"))
            self.tracer.emit(
                "domain", "outage", self.env.now, id=str(domain),
                n_hosts=len(members),
            )

        self.env.schedule_callback_at(at, _mark)
        for h in members:
            self.fail_host(h.id, at, duration)
        return [h.id for h in members]

    def preempt_host(
        self,
        host_id: str,
        at: float,
        lead: float,
        outage: Optional[float] = None,
    ) -> None:
        """Spot preemption with a warning lead: at ``at`` the host starts
        *draining* (no NEW placements via the scheduler live mask; its
        residents keep running — tasks shorter than the lead drain out),
        and at ``at + lead`` the abort fires (``fail_host`` semantics;
        ``outage`` None = the capacity never comes back)."""
        host = self.cluster.get_host(host_id)
        if host is None:
            raise KeyError(f"unknown host {host_id!r}")
        if lead < 0:
            raise ValueError(f"preemption lead must be >= 0, got {lead}")

        def _warn():
            if not host.up:
                return  # already down: the preemption is moot
            host.draining = True
            self.log.append((self.env.now, host.id, "preempt_warning"))
            self.tracer.emit(
                "host", "preempt_warning", self.env.now, id=host.id,
                lead=lead,
            )
            for hook in self._warning_hooks:
                hook(host, lead)

        self.env.schedule_callback_at(at, _warn)
        self.fail_host(host_id, at + lead, outage)

    def spot_preemptions(
        self,
        n_preemptions: int,
        horizon: float,
        lead: float,
        outage: Optional[float] = None,
        zone_rates: Optional[Dict[str, float]] = None,
        start: float = 0.0,
    ) -> List[Tuple[float, str]]:
        """Schedule ``n_preemptions`` spot preemptions at uniform times in
        ``[start, horizon)``.  Victims are drawn per ``zone_rates`` — a
        ``{"cloud/region/zone": relative rate}`` map (unlisted zones get
        rate 0; ``None`` = uniform over hosts) — so capacity pools with
        hot spot markets are preempted proportionally more often.
        Returns the (warning time, host id) schedule."""
        hosts = self.cluster.hosts
        if not hosts:
            raise ValueError("spot_preemptions needs a non-empty cluster")
        if zone_rates is None:
            weights = np.ones(len(hosts))
        else:
            weights = np.array(
                [zone_rates.get(repr(h.locality), 0.0) for h in hosts],
                dtype=np.float64,
            )
            if weights.sum() <= 0:
                raise ValueError(
                    "zone_rates assigns zero total rate to this cluster's "
                    f"zones (keys must be locality strings like "
                    f"{next(iter(hosts)).locality!r})"
                )
        weights = weights / weights.sum()
        times = np.sort(self.rng.uniform(start, horizon, size=n_preemptions))
        picks = self.rng.choice(len(hosts), size=n_preemptions, p=weights)
        schedule = []
        for t, hi in zip(times, picks):
            self.preempt_host(hosts[int(hi)].id, float(t), lead, outage)
            schedule.append((float(t), hosts[int(hi)].id))
        return schedule

    def slow_host(
        self, host_id: str, at: float, duration: float, factor: float
    ) -> None:
        """Transient straggler: compute STARTED on ``host_id`` during
        ``[at, at + duration)`` is stretched by ``factor``; compute
        already in flight keeps its scheduled finish time (its timer is
        on the heap).  Overlapping windows: last writer wins, and the
        earliest expiry restores full speed — straggle windows are for
        chaos schedules, not precise overlap algebra (documented)."""
        host = self.cluster.get_host(host_id)
        if host is None:
            raise KeyError(f"unknown host {host_id!r}")
        if duration <= 0:
            raise ValueError(f"straggler duration must be > 0, got {duration}")
        if factor <= 1.0:
            raise ValueError(
                f"straggler factor must be > 1 (a slowdown), got {factor}"
            )

        def _start():
            if not host.up:
                return
            host.slowdown = factor
            self.log.append((self.env.now, host.id, "straggler_start"))
            self.tracer.emit(
                "host", "straggler_start", self.env.now, id=host.id,
                factor=factor,
            )

        def _end():
            if host.slowdown == 1.0:
                return  # crashed + recovered mid-window, or already ended
            host.slowdown = 1.0
            self.log.append((self.env.now, host.id, "straggler_end"))
            self.tracer.emit("host", "straggler_end", self.env.now, id=host.id)

        self.env.schedule_callback_at(at, _start)
        self.env.schedule_callback_at(at + duration, _end)

    # -- network partitions ------------------------------------------------
    @staticmethod
    def _region_of(node) -> Tuple[str, str]:
        return (node.locality.cloud, node.locality.region)

    def _route_partitioned(self, route) -> bool:
        key = frozenset((self._region_of(route.src), self._region_of(route.dst)))
        return key in self._partitions

    def partition_regions(
        self, region_a: str, region_b: str, at: float, duration: float
    ) -> None:
        """Partition the network between two cloud regions
        (``"cloud/region"`` strings) for ``[at, at + duration)``: every
        route crossing the pair suspends — in-wire chunks finish, queued
        transfers park, nothing is dropped — and resumes at heal time.
        Routes materialized during the partition are caught by a cluster
        route hook.  Python network backend only (native routes serve
        their queue in the C++ engine)."""
        if self.cluster.network_backend != "python":
            raise ValueError(
                "network partitions require network_backend='python' "
                "(native routes serve their queue in the C++ engine)"
            )
        if duration <= 0:
            raise ValueError(f"partition duration must be > 0, got {duration}")
        regs = []
        for r in (region_a, region_b):
            parts = str(r).split("/")
            if len(parts) != 2:
                raise ValueError(
                    f"partition endpoints are regions ('cloud/region'), got {r!r}"
                )
            regs.append(tuple(parts))
        if regs[0] == regs[1]:
            raise ValueError("a partition needs two distinct regions")
        pair = frozenset(regs)
        label = "|".join(sorted("/".join(r) for r in regs))
        if not self._partition_hook_installed:
            self.cluster.add_route_hook(
                lambda route: route.suspend()
                if self._route_partitioned(route)
                else None
            )
            self._partition_hook_installed = True

        def _cut():
            self._partitions.add(pair)
            for route in self.cluster._routes.values():
                if self._route_partitioned(route):
                    route.suspend()
            self.log.append((self.env.now, label, "partition_start"))
            self.tracer.emit("network", "partition_start", self.env.now, id=label)

        def _heal():
            self._partitions.discard(pair)
            for route in self.cluster._routes.values():
                if route.suspended and not self._route_partitioned(route):
                    route.resume()
            self.log.append((self.env.now, label, "partition_end"))
            self.tracer.emit("network", "partition_end", self.env.now, id=label)

        self.env.schedule_callback_at(at, _cut)
        self.env.schedule_callback_at(at + duration, _heal)

    # -- schedule replay ---------------------------------------------------
    def apply_schedule(self, schedule: "ChaosSchedule") -> "FaultInjector":
        """Install every event of a (possibly deserialized)
        :class:`ChaosSchedule` — the replay entry point: same schedule on
        the same seeded world ⇒ identical fault log and meter snapshot."""
        for ev in schedule.events:
            if ev.kind == "host_outage":
                self.fail_host(ev.target, ev.at, ev.duration)
            elif ev.kind == "domain_outage":
                self.fail_domain(ev.target, ev.at, ev.duration)
            elif ev.kind == "preemption":
                self.preempt_host(ev.target, ev.at, ev.lead, ev.duration)
            elif ev.kind == "straggler":
                self.slow_host(ev.target, ev.at, ev.duration, ev.factor)
            elif ev.kind == "partition":
                a, b = ev.target.split("|")
                self.partition_regions(a, b, ev.at, ev.duration)
            elif ev.kind == "device_fault":
                self.fail_device(device_ordinal(ev.target), ev.at, ev.duration)
            elif ev.kind == "device_restore":
                self._device_event(
                    device_ordinal(ev.target), "device_restore", ev.at
                )
            else:
                raise ValueError(f"unknown chaos event kind {ev.kind!r}")
        return self

    # -- network faults --------------------------------------------------
    def fluctuate_bandwidth(
        self,
        period: float,
        amplitude: float = 0.05,
        until: Optional[float] = None,
    ) -> None:
        """Every ``period`` sim-seconds, resample every *materialized*
        route's bandwidth as ``base × U(1−amplitude, 1+amplitude)``
        (the reference's empty ``_fluctuate`` stub, made real).

        Python network backend only: native routes pin their rate in the
        C++ engine at creation.
        """
        if self.cluster.network_backend != "python":
            raise ValueError(
                "bandwidth fluctuation requires network_backend='python' "
                "(native routes pin their rate in the C++ engine)"
            )
        if period <= 0:
            raise ValueError(f"period must be > 0, got {period}")
        if not 0.0 <= amplitude < 1.0:
            raise ValueError(
                f"amplitude must be in [0, 1), got {amplitude} "
                "(>= 1 could resample a route to non-positive bandwidth)"
            )
        base: dict = {}

        def _tick():
            # The window is half-open [start, until): a tick landing ON the
            # horizon must not resample (it could race the restore below).
            if until is not None and self.env.now >= until:
                return
            for key, route in self.cluster._routes.items():
                b = base.setdefault(key, route.bw)
                route.bw = b * float(
                    self.rng.uniform(1.0 - amplitude, 1.0 + amplitude)
                )
            if until is None or self.env.now + period <= until:
                self.env.schedule_callback(period, _tick)

        def _restore():
            # Bound the perturbation to the configured window: without the
            # restore, the final random draw would persist as a permanent
            # bias for the rest of the simulation.
            for key, b in base.items():
                self.cluster._routes[key].bw = b

        if until is None or period <= until:
            self.env.schedule_callback(period, _tick)
            if until is not None:
                self.env.schedule_callback_at(until, _restore)


# ---------------------------------------------------------------------------
# ChaosSchedule — the serializable, replayable fault plan
# ---------------------------------------------------------------------------


def check_schema_header(d: dict, schema: str, version: int, kind: str):
    """Validate the self-describing ``schema``/``schema_version`` header
    shared by :class:`ChaosSchedule` and ``MarketSchedule`` files — one
    implementation so the two loaders cannot drift.  Files without a
    ``schema`` field (pre-round-11) are accepted; ``version`` is the
    legacy fallback key."""
    got = d.get("schema")
    if got is not None and got != schema:
        raise ValueError(
            f"not a {kind} file: schema {got!r} (expected {schema!r})"
        )
    got_v = d.get("schema_version", d.get("version", 1))
    if got_v != version:
        raise ValueError(f"unsupported {kind} schema_version {got_v!r}")


@dataclass(frozen=True)
class ChaosEvent:
    """One fault in a :class:`ChaosSchedule`.

    ``kind`` selects the injector primitive; ``target`` is a host id, a
    failure-domain string (``"cloud/region"`` / ``"cloud/region/zone"``),
    or a sorted ``"regionA|regionB"`` pair for partitions.  ``duration``
    doubles as the preemption outage length (None = permanent) and is
    required for stragglers and partitions; ``lead`` / ``factor`` are the
    preemption warning lead and straggler slowdown."""

    kind: str  # host_outage | domain_outage | preemption | straggler | partition | device_fault | device_restore
    at: float
    target: str
    duration: Optional[float] = None
    lead: float = 0.0
    factor: float = 1.0

    KINDS = (
        "host_outage", "domain_outage", "preemption", "straggler",
        "partition", "device_fault", "device_restore",
    )
    #: Kinds addressing mesh device slots (the compute plane) rather than
    #: DES hosts — consumed by :class:`DeviceFaultPlan`, ignored by the
    #: DES-side injector primitives.
    DEVICE_KINDS = ("device_fault", "device_restore")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown chaos event kind {self.kind!r}")
        if self.at < 0:
            raise ValueError(f"event time must be >= 0, got {self.at}")
        # Fail at construction/deserialization, not deep inside
        # apply_schedule: stragglers and partitions are windowed faults —
        # duration=None has no meaning for them (unlike outages and
        # preemptions, where None = the capacity never comes back).
        if self.kind in ("straggler", "partition") and (
            self.duration is None or self.duration <= 0
        ):
            raise ValueError(
                f"{self.kind} events require a positive duration, "
                f"got {self.duration!r}"
            )
        if self.kind in self.DEVICE_KINDS:
            device_ordinal(self.target)  # 'device:<ordinal>' or ValueError
            if self.kind == "device_restore" and self.duration is not None:
                raise ValueError(
                    "device_restore is instantaneous (a fail window ends "
                    f"at its restore's time), got duration={self.duration!r}"
                )
            if self.kind == "device_fault" and (
                self.duration is not None and self.duration <= 0
            ):
                raise ValueError(
                    "device_fault duration must be > 0 (or None, ended by "
                    f"an explicit device_restore), got {self.duration!r}"
                )

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "at": self.at, "target": self.target}
        if self.duration is not None:
            d["duration"] = self.duration
        if self.lead:
            d["lead"] = self.lead
        if self.factor != 1.0:
            d["factor"] = self.factor
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ChaosEvent":
        # Eager schema validation: a malformed schedule file must fail at
        # load with a message naming the broken event, not deep inside
        # apply_schedule / replay (where a KeyError names nothing).
        for key in ("kind", "at", "target"):
            if key not in d:
                raise ValueError(f"chaos event missing {key!r}: {d!r}")
        try:
            at = float(d["at"])
        except (TypeError, ValueError):
            raise ValueError(
                f"chaos event time must be a number, got {d['at']!r}"
            ) from None
        return cls(
            kind=d["kind"],
            at=at,
            target=str(d["target"]),
            duration=(None if d.get("duration") is None else float(d["duration"])),
            lead=float(d.get("lead", 0.0)),
            factor=float(d.get("factor", 1.0)),
        )

    def describe(self) -> str:
        bits = [f"t={self.at:g}", self.kind, self.target]
        if self.duration is not None:
            bits.append(f"dur={self.duration:g}")
        if self.lead:
            bits.append(f"lead={self.lead:g}")
        if self.factor != 1.0:
            bits.append(f"x{self.factor:g}")
        return " ".join(bits)


class ChaosSchedule:
    """A seeded, serializable fault plan: generate once, save, replay, diff.

    Events are kept sorted by ``(at, kind, target)`` so two schedules
    with the same content compare equal regardless of construction
    order, and the JSON form is canonical (diffs are meaningful).
    Python's ``json`` round-trips floats exactly (repr-based), so a
    loaded schedule replays the *bit-identical* fault sequence — the
    determinism regression in ``tests/test_chaos.py`` holds a replayed
    run to the original's fault log and final meter snapshot.
    """

    SCHEMA = "chaos-schedule"
    VERSION = 1

    def __init__(
        self,
        events,
        seed: Optional[int] = None,
        meta: Optional[dict] = None,
    ):
        self.events: List[ChaosEvent] = sorted(
            events, key=lambda e: (e.at, e.kind, e.target)
        )
        self.seed = seed
        self.meta = dict(meta or {})

    def __len__(self) -> int:
        return len(self.events)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, ChaosSchedule) and self.events == other.events
        )

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    # -- (de)serialization -------------------------------------------------
    def to_dict(self) -> dict:
        return {
            # Self-describing header (shared convention with
            # MarketSchedule, via ``check_schema_header``): a chaos file
            # handed to the market loader — or vice versa — fails at load
            # with a schema message, not with an opaque shape error
            # later.  ``version`` is kept for pre-round-11 files.
            "schema": self.SCHEMA,
            "schema_version": self.VERSION,
            "version": self.VERSION,
            "seed": self.seed,
            "meta": self.meta,
            "events": [e.to_dict() for e in self.events],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ChaosSchedule":
        check_schema_header(d, cls.SCHEMA, cls.VERSION, "ChaosSchedule")
        return cls(
            [ChaosEvent.from_dict(e) for e in d.get("events", ())],
            seed=d.get("seed"),
            meta=d.get("meta"),
        )

    def dumps(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def loads(cls, text: str) -> "ChaosSchedule":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())

    @classmethod
    def load(cls, path: str) -> "ChaosSchedule":
        with open(path) as f:
            return cls.loads(f.read())

    def diff(self, other: "ChaosSchedule") -> List[str]:
        """Human-readable event diff (empty = identical fault plans).
        Multiplicity-aware: a plan with an event twice vs once IS a
        diff (a set-based compare would silently call them identical)."""
        def counted(events) -> Dict[str, int]:
            out: Dict[str, int] = {}
            for e in events:
                key = e.describe()
                out[key] = out.get(key, 0) + 1
            return out

        mine, theirs = counted(self.events), counted(other.events)
        out = []
        for key in sorted(set(mine) | set(theirs)):
            n_m, n_t = mine.get(key, 0), theirs.get(key, 0)
            out += [f"- {key}"] * max(n_m - n_t, 0)
            out += [f"+ {key}"] * max(n_t - n_m, 0)
        return out

    # -- generation --------------------------------------------------------
    @classmethod
    def generate(
        cls,
        cluster,
        seed: int,
        horizon: float,
        *,
        n_domain_outages: int = 0,
        domain_level: str = "zone",
        outage_duration: float = 120.0,
        n_preemptions: int = 0,
        preempt_lead: float = 10.0,
        preempt_outage: Optional[float] = 300.0,
        zone_rates: Optional[Dict[str, float]] = None,
        n_stragglers: int = 0,
        straggler_factor: float = 4.0,
        straggler_duration: float = 60.0,
        n_partitions: int = 0,
        partition_duration: float = 60.0,
    ) -> "ChaosSchedule":
        """Draw a seeded chaos plan against ``cluster``'s topology.

        All draws come from one ``default_rng(seed)`` in a fixed order,
        so the plan is a pure function of (cluster topology, seed,
        parameters).  Domain outages pick occupied zones (or regions);
        preemptions pick hosts weighted by ``zone_rates`` (uniform when
        None — same contract as :meth:`FaultInjector.spot_preemptions`);
        partitions pick distinct occupied region pairs.  Event times are
        uniform over ``[0, horizon)``.
        """
        rng = np.random.default_rng(seed)
        hosts = cluster.hosts
        if not hosts:
            raise ValueError("chaos generation needs a non-empty cluster")
        zones = sorted({repr(h.locality) for h in hosts})
        regions = sorted(
            {f"{h.locality.cloud}/{h.locality.region}" for h in hosts}
        )
        events: List[ChaosEvent] = []

        if n_domain_outages:
            if domain_level == "zone":
                pool = zones
            elif domain_level == "region":
                pool = regions
            else:
                raise ValueError(
                    f"domain_level must be 'zone' or 'region', got {domain_level!r}"
                )
            for t in rng.uniform(0, horizon, size=n_domain_outages):
                events.append(
                    ChaosEvent(
                        "domain_outage",
                        float(t),
                        pool[int(rng.integers(0, len(pool)))],
                        duration=outage_duration,
                    )
                )

        if n_preemptions:
            if zone_rates is None:
                weights = np.ones(len(hosts))
            else:
                weights = np.array(
                    [zone_rates.get(repr(h.locality), 0.0) for h in hosts]
                )
                if weights.sum() <= 0:
                    raise ValueError("zone_rates cover none of the cluster")
            weights = weights / weights.sum()
            times = rng.uniform(0, horizon, size=n_preemptions)
            picks = rng.choice(len(hosts), size=n_preemptions, p=weights)
            for t, hi in zip(times, picks):
                events.append(
                    ChaosEvent(
                        "preemption",
                        float(t),
                        hosts[int(hi)].id,
                        duration=preempt_outage,
                        lead=preempt_lead,
                    )
                )

        for _ in range(n_stragglers):
            t = float(rng.uniform(0, horizon))
            hi = int(rng.integers(0, len(hosts)))
            events.append(
                ChaosEvent(
                    "straggler",
                    t,
                    hosts[hi].id,
                    duration=straggler_duration,
                    factor=straggler_factor,
                )
            )

        if n_partitions:
            if len(regions) < 2:
                raise ValueError(
                    "partitions need hosts in at least two regions "
                    f"(cluster spans {regions})"
                )
            for _ in range(n_partitions):
                t = float(rng.uniform(0, horizon))
                a, b = rng.choice(len(regions), size=2, replace=False)
                pair = sorted((regions[int(a)], regions[int(b)]))
                events.append(
                    ChaosEvent(
                        "partition",
                        t,
                        "|".join(pair),
                        duration=partition_duration,
                    )
                )

        return cls(
            events,
            seed=seed,
            meta={
                "horizon": horizon,
                "n_hosts": len(hosts),
                "zones": zones,
                "regions": regions,
            },
        )


# ---------------------------------------------------------------------------
# DeviceFaultPlan — the compute-plane fault plan (elastic mesh serving)
# ---------------------------------------------------------------------------


class DeviceFaultPlan:
    """The device-plane view of a :class:`ChaosSchedule`: per-ordinal fail
    windows, validated eagerly and consulted at the dispatch boundary.

    A ``device_fault`` opens a window at ``at`` (closed by its own
    ``duration``, or by a later explicit ``device_restore``; never, if
    neither).  Windows are half-open ``[fail, restore)`` — a dispatch at
    exactly the restore instant sees a healthy device.  The plan is a pure
    function of the schedule, so replaying the same schedule reproduces
    the identical loss sequence bit-for-bit (the elastic referee's
    determinism contract).

    Load-hardening (all rejected at construction, naming the event):
      * unknown device index (``ordinal >= n_devices``)
      * ``device_restore`` with no open fail window on that ordinal
      * overlapping fail windows on one ordinal (a fault while down)
    """

    def __init__(self, windows: Dict[int, List[Tuple[float, float]]],
                 n_devices: int):
        #: ordinal -> sorted list of half-open (fail_at, restore_at)
        #: windows; ``restore_at`` is ``inf`` for permanent faults.
        self.windows = {k: sorted(v) for k, v in windows.items()}
        self.n_devices = int(n_devices)

    @classmethod
    def from_schedule(
        cls, schedule: "ChaosSchedule", n_devices: int
    ) -> "DeviceFaultPlan":
        if n_devices <= 0:
            raise ValueError(f"n_devices must be > 0, got {n_devices}")
        # Events arrive (at, kind, target)-sorted from ChaosSchedule; that
        # orders a same-instant restore BEFORE a same-instant fault
        # ('device_fault' < 'device_restore' lexically is false — fault
        # sorts first), so walk with explicit open-window bookkeeping.
        open_at: Dict[int, float] = {}
        windows: Dict[int, List[Tuple[float, float]]] = {}
        for ev in schedule.events:
            if ev.kind not in ChaosEvent.DEVICE_KINDS:
                continue
            ordinal = device_ordinal(ev.target)
            if ordinal >= n_devices:
                raise ValueError(
                    f"device event targets unknown device index {ordinal} "
                    f"(mesh has {n_devices} devices): {ev.describe()}"
                )
            if ev.kind == "device_fault":
                if ordinal in open_at:
                    raise ValueError(
                        f"overlapping fail windows on device {ordinal}: "
                        f"fault at t={ev.at:g} while already down since "
                        f"t={open_at[ordinal]:g}"
                    )
                if ev.duration is not None:
                    windows.setdefault(ordinal, []).append(
                        (ev.at, ev.at + ev.duration)
                    )
                else:
                    open_at[ordinal] = ev.at
            else:  # device_restore
                if ordinal not in open_at:
                    raise ValueError(
                        f"device_restore at t={ev.at:g} for device "
                        f"{ordinal} with no preceding open device_fault "
                        "(self-closing faults carry their own duration)"
                    )
                windows.setdefault(ordinal, []).append(
                    (open_at.pop(ordinal), ev.at)
                )
        for ordinal, at in open_at.items():
            windows.setdefault(ordinal, []).append((at, float("inf")))
        # A self-closing fault can still overlap a later window; check the
        # assembled per-ordinal timelines.
        for ordinal, spans in windows.items():
            spans.sort()
            for (a0, a1), (b0, _b1) in zip(spans, spans[1:]):
                if b0 < a1:
                    raise ValueError(
                        f"overlapping fail windows on device {ordinal}: "
                        f"[{a0:g}, {a1:g}) and one starting at t={b0:g}"
                    )
        return cls(windows, n_devices)

    def down_at(self, t: float) -> frozenset:
        """Ordinals whose fail window covers sim time ``t`` (half-open:
        down at the fault instant, healthy at the restore instant)."""
        return frozenset(
            ordinal
            for ordinal, spans in self.windows.items()
            if any(a <= t < b for a, b in spans)
        )

    def hit(self, t: float, ordinals) -> frozenset:
        """The subset of ``ordinals`` down at ``t`` — the dispatch-boundary
        check: non-empty means this execution targets a dead device and
        must raise (deterministically, every replay)."""
        return self.down_at(t) & frozenset(int(o) for o in ordinals)

    def events_in(self, t0: float, t1: float) -> List[Tuple[float, str, int]]:
        """Chronological (time, kind, ordinal) transitions in ``[t0, t1)``
        — what ``tools/chaos_replay.py diff`` renders for device events."""
        out: List[Tuple[float, str, int]] = []
        for ordinal, spans in self.windows.items():
            for a, b in spans:
                if t0 <= a < t1:
                    out.append((a, "device_fault", ordinal))
                if b != float("inf") and t0 <= b < t1:
                    out.append((b, "device_restore", ordinal))
        return sorted(out)

    def describe(self) -> List[str]:
        out = []
        for ordinal in sorted(self.windows):
            for a, b in self.windows[ordinal]:
                end = "inf" if b == float("inf") else f"{b:g}"
                out.append(f"device:{ordinal} down [{a:g}, {end})")
        return out
