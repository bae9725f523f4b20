"""Spot-market environment: time-varying prices and preemption hazards.

Every experiment before this module priced the world statically: one
``[Z, Z]`` egress-cost matrix loaded at start, and spot preemptions (the
chaos engine, ``infra/faults.py``) drawn uniformly or from a hand-written
``zone_rates`` map with no notion of time.  Real spot markets are neither
static nor uniform (Bamboo / SpotServe, PAPERS.md): prices move on
coarse timescales, and the cheap capacity pools are exactly the ones
evicted most — a cost-aware scheduler that ignores that correlation
packs its work onto the most evictable zones.

:class:`MarketSchedule` is the seeded, serializable environment that
makes the correlation explicit — the market twin of
:class:`~pivot_tpu_torch.infra.faults.ChaosSchedule`, with the same
generate / save / load / diff / replay lifecycle:

  * **piecewise-constant per-zone traces**: ``price[p, z]`` (a multiplier
    on the static egress-cost matrix and the per-zone instance rate) and
    ``hazard[p, z]`` (expected preemptions per host per sim-second),
    constant over segment ``[times[p], times[p+1])`` and extended past
    the last breakpoint;
  * **the time-varying cost tensor**: :meth:`cost_tensor` materializes
    the ``[P, Z, Z]`` egress-cost stack (base matrix × source-zone price
    — egress is billed by the *source* cloud), and
    :meth:`cost_matrix_at` hands any scheduling tick its ``[Z, Z]``
    slice.  The scheduling stack threads these through the CPU policies,
    the two-phase kernels, the Pallas kernel, the fused spans (a per-span
    ``[K]`` time-index row, the same pattern as the Philox uniform rows),
    and the host-sharded twins;
  * **the hazard vector**: :meth:`hazard_vector` maps the tick instant
    through host zones to the ``[H]`` per-host hazard the risk-aware
    scoring term consumes (``score += risk_weight × hazard ×
    expected-rework-cost`` — see ``sched/policies.py``);
  * **the preemption process**: :meth:`spot_schedule` samples a
    hazard-proportional piecewise-Poisson preemption plan — per segment
    and zone, ``Poisson(hazard × duration × hosts-in-zone)`` events at
    uniform times on uniformly-drawn zone members, each with the warning
    lead — and returns it as a plain :class:`ChaosSchedule`, so the
    existing ``FaultInjector`` replay / diff / audit machinery drives
    the market's faults unchanged.  Same (cluster, market, seed) ⇒
    bit-identical fault plan, fault log, and meter snapshot;
  * **spot billing**: :meth:`billed_instance_cost` integrates each
    host's metered busy intervals against its zone's price trace —
    the cost-per-completed-task numerator of the ``spot_survival``
    bench and the acceptance soak.

All draws come from one ``default_rng(seed)`` in a fixed order; JSON
round-trips floats exactly (repr-based), so a loaded schedule replays
bit-identically.  Files are self-describing (``schema`` +
``schema_version`` fields — shared convention with ``ChaosSchedule``).

Copy of ``pivot_tpu/infra/market.py`` (JAX-free there too), with the
import paths rewritten to the port's own layers;
``MarketSchedule.loads(reference_market.dumps())`` carries a reference
market into the port unchanged.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from pivot_tpu_torch.infra.faults import (
    ChaosEvent,
    ChaosSchedule,
    check_schema_header,
)

__all__ = ["MarketSchedule"]


class MarketSchedule:
    """A seeded, serializable spot-market plan: per-zone piecewise-constant
    price multipliers and preemption hazards.

    ``times`` is the sorted ``[P]`` list of segment start instants
    (``times[0]`` must be 0.0 so every sim time has a segment); ``zones``
    the ``[NZ]`` zone-name list (``"cloud/region/zone"`` strings, in the
    owning :class:`~pivot_tpu_torch.infra.locality.ResourceMetadata`'s zone
    order — what lets the ``[P, NZ]`` rows index straight into the
    kernels' zone axis); ``price``/``hazard`` the ``[P, NZ]`` traces.
    """

    SCHEMA = "market-schedule"
    VERSION = 1

    def __init__(
        self,
        times,
        zones: List[str],
        price,
        hazard,
        seed: Optional[int] = None,
        meta: Optional[dict] = None,
    ):
        self.times = np.asarray(times, dtype=np.float64)
        self.zones = [str(z) for z in zones]
        self.price = np.asarray(price, dtype=np.float64)
        self.hazard = np.asarray(hazard, dtype=np.float64)
        self.seed = seed
        self.meta = dict(meta or {})
        P, NZ = len(self.times), len(self.zones)
        if self.price.shape != (P, NZ) or self.hazard.shape != (P, NZ):
            raise ValueError(
                f"price/hazard must be [{P}, {NZ}] (segments × zones), got "
                f"{self.price.shape} / {self.hazard.shape}"
            )
        if P == 0:
            raise ValueError("a MarketSchedule needs at least one segment")
        if self.times[0] != 0.0:
            raise ValueError(
                f"times[0] must be 0.0 so every sim instant has a segment, "
                f"got {self.times[0]}"
            )
        if np.any(np.diff(self.times) <= 0):
            raise ValueError("segment times must be strictly increasing")
        if np.any(~np.isfinite(self.times)):
            raise ValueError("segment times must be finite")
        if np.any(self.price < 0) or np.any(~np.isfinite(self.price)):
            raise ValueError("price multipliers must be finite and >= 0")
        if np.any(self.hazard < 0) or np.any(~np.isfinite(self.hazard)):
            raise ValueError("hazards must be finite and >= 0")
        # Per-segment cost-matrix cache for the last-validated metadata
        # object (a strong reference — an id()-keyed cache could serve a
        # stale matrix if a dead meta's address were recycled); cleared
        # on rebind to a different metadata object.
        self._cost_meta = None
        self._cost_cache: Dict[int, np.ndarray] = {}

    # -- segment lookup ----------------------------------------------------
    @property
    def n_segments(self) -> int:
        return len(self.times)

    def segment(self, t: float) -> int:
        """Index of the segment covering sim time ``t`` (clamped to the
        first/last segment outside the breakpoint range)."""
        return int(
            np.clip(
                np.searchsorted(self.times, t, side="right") - 1,
                0,
                self.n_segments - 1,
            )
        )

    def segment_indices(self, ts) -> np.ndarray:
        """[K] i32 segment index per instant — the fused spans' per-span
        time-index row (one row per span, like the Philox uniform rows)."""
        return np.clip(
            np.searchsorted(self.times, np.asarray(ts), side="right") - 1,
            0,
            self.n_segments - 1,
        ).astype(np.int32)

    def emit_timeline(self, tracer) -> None:
        """Stamp every price-segment boundary onto a trace timeline
        (round 14, ``pivot_tpu_torch.obs``): each segment start becomes a
        ``market``/``price_segment`` instant carrying the segment's
        mean price multiplier and mean hazard, so cost/risk regime
        changes read in context with placements and chaos events.
        Deterministic — pure sim-time payloads; the tracer stamps the
        wall side inside ``obs/``."""
        if not getattr(tracer, "enabled", False):
            return
        for p in range(self.n_segments):
            tracer.emit(
                "market", "price_segment", float(self.times[p]),
                segment=p,
                mean_price=float(np.mean(self.price[p])),
                mean_hazard=float(np.mean(self.hazard[p])),
            )

    def price_row(self, t: float) -> np.ndarray:
        """[NZ] per-zone price multiplier at ``t``."""
        return self.price[self.segment(t)]

    def hazard_row(self, t: float) -> np.ndarray:
        """[NZ] per-zone preemption hazard (events/host/sec) at ``t``."""
        return self.hazard[self.segment(t)]

    def hazard_vector(self, t: float, host_zones) -> np.ndarray:
        """[H] per-host hazard at ``t``: the zone row gathered through the
        cluster's host→zone map — the risk term's kernel feed."""
        zones = np.asarray(host_zones)
        if zones.size and int(zones.max()) >= len(self.zones):
            raise ValueError(
                f"host zone index {int(zones.max())} is out of range for "
                f"this MarketSchedule's {len(self.zones)}-zone catalog; "
                "generate the schedule against the same locality file"
            )
        return self.hazard_row(t)[zones]

    # -- the time-varying egress-cost tensor -------------------------------
    def check_zones(self, meta) -> None:
        want = [repr(z) for z in meta.zones]
        if self.zones != want:
            raise ValueError(
                "MarketSchedule zones do not match the metadata's zone "
                f"catalog ({len(self.zones)} vs {len(want)} zones; "
                "generate the schedule against the same locality file)"
            )

    def cost_matrix_at(self, t: float, meta) -> np.ndarray:
        """[Z, Z] egress-cost matrix at sim time ``t``: the static matrix
        scaled by the SOURCE zone's price multiplier (egress is billed by
        the sending cloud).  Cached per segment — ticks inside one
        segment share the identical ndarray, so downstream staging can
        key on identity."""
        if meta is not self._cost_meta:
            # Validate once per metadata object, not per tick: the zone
            # catalog cannot change under an object we hold a reference to.
            self.check_zones(meta)
            self._cost_meta = meta
            self._cost_cache.clear()
        p = self.segment(t)
        mat = self._cost_cache.get(p)
        if mat is None:
            mat = meta.cost_matrix * self.price[p][:, None]
            mat.setflags(write=False)
            self._cost_cache[p] = mat
        return mat

    def cost_tensor(self, meta) -> np.ndarray:
        """The full ``[P, Z, Z]`` cost stack (segment-major) — the fused
        spans' device operand, indexed per tick by the ``[K]`` row from
        :meth:`segment_indices`."""
        self.check_zones(meta)
        return meta.cost_matrix[None, :, :] * self.price[:, :, None]

    # -- the preemption process --------------------------------------------
    def spot_schedule(
        self,
        cluster,
        seed: int,
        lead: float = 10.0,
        outage: Optional[float] = 300.0,
        horizon: Optional[float] = None,
    ) -> ChaosSchedule:
        """Draw the hazard-proportional spot-preemption plan against
        ``cluster``'s topology as a :class:`ChaosSchedule` of
        ``preemption`` events (warning at ``t``, abort at ``t + lead``,
        capacity back after ``outage`` — ``FaultInjector.apply_schedule``
        semantics).

        Per segment ``[t0, t1)`` and zone ``z``, the event count is
        ``Poisson(hazard[p, z] × (t1 − t0) × n_hosts_in_z)`` with event
        times uniform in the segment and victims uniform over the zone's
        hosts — a piecewise-constant Poisson process per host.  All
        draws come from one ``default_rng(seed)`` in (segment, zone)
        order, so the plan is a pure function of (cluster topology,
        market, seed, lead, outage, horizon).
        """
        if lead < 0:
            raise ValueError(f"preemption lead must be >= 0, got {lead}")
        hosts_by_zone: Dict[str, List] = {}
        for h in cluster.hosts:
            hosts_by_zone.setdefault(repr(h.locality), []).append(h)
        if horizon is None:
            horizon = self.meta.get("horizon")
        if horizon is None:
            # Falling back to times[-1] (the LAST segment's start) would
            # make the final segment's window empty and silently drop its
            # share of the expected preemptions.
            raise ValueError(
                "spot_schedule needs a horizon: this MarketSchedule "
                "records none (meta['horizon']); pass horizon= explicitly"
            )
        horizon = float(horizon)
        if horizon <= 0:
            raise ValueError(f"horizon must be > 0, got {horizon}")
        bounds = list(self.times) + [max(horizon, float(self.times[-1]))]
        rng = np.random.default_rng(seed)
        events: List[ChaosEvent] = []
        for p in range(self.n_segments):
            t0, t1 = bounds[p], min(bounds[p + 1], horizon)
            if t1 <= t0:
                continue
            for zi, zone in enumerate(self.zones):
                members = hosts_by_zone.get(zone)
                if not members:
                    continue
                lam = self.hazard[p, zi] * (t1 - t0) * len(members)
                n = int(rng.poisson(lam)) if lam > 0 else 0
                if n == 0:
                    continue
                ts = rng.uniform(t0, t1, size=n)
                picks = rng.integers(0, len(members), size=n)
                for t, hi in zip(ts, picks):
                    events.append(
                        ChaosEvent(
                            "preemption",
                            float(t),
                            members[int(hi)].id,
                            duration=outage,
                            lead=lead,
                        )
                    )
        return ChaosSchedule(
            events,
            seed=seed,
            meta={
                "source": "market",
                "market_seed": self.seed,
                "horizon": horizon,
                "lead": lead,
                "outage": outage,
            },
        )

    # -- spot billing -------------------------------------------------------
    def billed_instance_cost(
        self, meter, cluster, rate_per_hour: float = 1.0,
        end: Optional[float] = None,
    ) -> float:
        """$ cost of the run's metered busy intervals under this price
        trace: for every host interval ``[a, b)``, ``rate_per_hour / 3600
        × ∫ price(zone(host), t) dt`` — the exact piecewise-constant
        integral, so two replays of one run bill identically.  Intervals
        still open (crash-closed runs close them) are clamped to ``end``
        (default: the last breakpoint)."""
        zone_of = {h.id: repr(h.locality) for h in cluster.hosts}
        zidx = {z: i for i, z in enumerate(self.zones)}
        end = float(end if end is not None else self.times[-1])
        bounds = np.append(self.times, np.inf)
        total = 0.0
        for host, intervals in meter._host_intervals.items():
            zi = zidx.get(zone_of.get(host.id, ""), None)
            if zi is None:
                continue
            for iv in intervals:
                a = iv[0]
                b = iv[1] if len(iv) > 1 else max(end, a)
                for p in range(self.n_segments):
                    lo, hi = max(a, bounds[p]), min(b, bounds[p + 1])
                    if hi > lo:
                        total += (hi - lo) * self.price[p, zi]
        return total * rate_per_hour / 3600.0

    # -- (de)serialization --------------------------------------------------
    def __eq__(self, other) -> bool:
        return (
            isinstance(other, MarketSchedule)
            and np.array_equal(self.times, other.times)
            and self.zones == other.zones
            and np.array_equal(self.price, other.price)
            and np.array_equal(self.hazard, other.hazard)
        )

    def to_dict(self) -> dict:
        return {
            "schema": self.SCHEMA,
            "schema_version": self.VERSION,
            "seed": self.seed,
            "meta": self.meta,
            "times": self.times.tolist(),
            "zones": list(self.zones),
            "price": self.price.tolist(),
            "hazard": self.hazard.tolist(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MarketSchedule":
        check_schema_header(d, cls.SCHEMA, cls.VERSION, "MarketSchedule")
        for key in ("times", "zones", "price", "hazard"):
            if key not in d:
                raise ValueError(f"MarketSchedule file missing {key!r}")
        return cls(
            d["times"], d["zones"], d["price"], d["hazard"],
            seed=d.get("seed"), meta=d.get("meta"),
        )

    def dumps(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def loads(cls, text: str) -> "MarketSchedule":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())

    @classmethod
    def load(cls, path: str) -> "MarketSchedule":
        with open(path) as f:
            return cls.loads(f.read())

    def diff(self, other: "MarketSchedule") -> List[str]:
        """Human-readable trace diff (empty = identical markets)."""
        out: List[str] = []
        if self.zones != other.zones:
            out.append(f"- zones {self.zones}")
            out.append(f"+ zones {other.zones}")
            return out
        if not np.array_equal(self.times, other.times):
            out.append(f"- times {self.times.tolist()}")
            out.append(f"+ times {other.times.tolist()}")
            return out
        for name, a, b in (
            ("price", self.price, other.price),
            ("hazard", self.hazard, other.hazard),
        ):
            for p, z in zip(*np.nonzero(a != b)):
                out.append(
                    f"~ {name}[t={self.times[p]:g}, {self.zones[z]}]: "
                    f"{a[p, z]:g} -> {b[p, z]:g}"
                )
        return out

    # -- generation ---------------------------------------------------------
    @classmethod
    def generate(
        cls,
        meta,
        seed: int,
        horizon: float,
        *,
        n_segments: int = 8,
        base_hazard: float = 0.0,
        hot_fraction: float = 0.25,
        hot_hazard: float = 2e-3,
        hot_discount: float = 0.5,
        price_vol: float = 0.15,
    ) -> "MarketSchedule":
        """Draw a seeded spot market against ``meta``'s zone catalog.

        A ``hot_fraction`` of zones become *spot pools*: discounted to
        ``hot_discount`` of the on-demand price (cheap — exactly where
        cost-aware placement wants to pack) but carrying ``hot_hazard``
        preemptions/host/sec; the rest run at ~1.0× with ``base_hazard``.
        Every segment multiplies each zone's price by ``U(1 ± price_vol)``
        and jitters hot-zone hazard by ``U(0.5, 1.5)``, so both traces
        genuinely move over time.  Pure function of (meta zones, seed,
        params).
        """
        if n_segments < 1:
            raise ValueError(f"n_segments must be >= 1, got {n_segments}")
        if horizon <= 0:
            raise ValueError(f"horizon must be > 0, got {horizon}")
        if not 0.0 <= hot_fraction <= 1.0:
            raise ValueError(
                f"hot_fraction must be in [0, 1], got {hot_fraction}"
            )
        if not 0.0 <= price_vol < 1.0:
            raise ValueError(
                f"price_vol must be in [0, 1), got {price_vol} "
                "(>= 1 could draw a negative price)"
            )
        zones = [repr(z) for z in meta.zones]
        nz = len(zones)
        rng = np.random.default_rng(seed)
        n_hot = int(round(hot_fraction * nz))
        hot = np.zeros(nz, dtype=bool)
        if n_hot:
            hot[rng.choice(nz, size=n_hot, replace=False)] = True
        times = np.linspace(0.0, horizon, n_segments, endpoint=False)
        base_price = np.where(hot, hot_discount, 1.0)
        base_haz = np.where(hot, hot_hazard, base_hazard)
        price = base_price[None, :] * rng.uniform(
            1.0 - price_vol, 1.0 + price_vol, size=(n_segments, nz)
        )
        hazard = base_haz[None, :] * np.where(
            hot[None, :],
            rng.uniform(0.5, 1.5, size=(n_segments, nz)),
            1.0,
        )
        return cls(
            times, zones, price, hazard, seed=seed,
            meta={
                "horizon": horizon,
                "hot_zones": [z for z, h in zip(zones, hot) if h],
                "base_hazard": base_hazard,
                "hot_hazard": hot_hazard,
                "hot_discount": hot_discount,
            },
        )
