"""Metrics / telemetry subsystem.

Capability parity with the reference ``Meter`` (``resources/meter.py:13-187``):
host busy-interval tracking with merging, per-route per-chunk service logs,
per-task data-transfer records, scheduling-op counts, and the derived
metrics — cumulative instance hours, total network traffic (egress) cost,
average congestion delay — serialized as the same four JSON files
(``general.json`` / ``transfers.json`` / ``scheduler.json`` /
``host_usage.json``, ref ``resources/meter.py:108-133``).

Additions over the reference: wall-clock + decisions/sec counters for the
BENCH harness, ``summary()`` returning everything as a dict without
touching disk, and the serving-grade telemetry primitives behind
``pivot_tpu_torch.serve`` — :class:`StreamingHistogram` (fixed-memory
log-bucketed percentiles) and :class:`SloMeter` (thread-safe decision
latency / queue depth / admission counters with a JSON snapshot).
"""

from __future__ import annotations

import json
import math
import os
import threading
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from pivot_tpu_torch.obs.clock import ObsClock
from pivot_tpu_torch.utils import LogMixin, ceil_bucket, floor_bucket

__all__ = ["Meter", "SloMeter", "StreamingHistogram"]


class Meter(LogMixin):
    def __init__(self, env, meta, clock: Optional[ObsClock] = None):
        self.env = env
        self.meta = meta
        #: The injected obs wall clock (round 14): a run that hands the
        #: SAME clock to its Meter and SloMeter gets snapshots that
        #: agree exactly on elapsed wall time — before, each kept a
        #: private perf_counter start and disagreed by construction.
        self.clock = clock or ObsClock()
        # host -> list of [start] / [start, end] busy intervals
        self._host_intervals: Dict[object, List[list]] = defaultdict(list)
        # route -> transfer key -> list of [start, end, chunk_mb] service
        # slots; keys are whatever ``route_check_in`` was handed (the Python
        # fabric passes Transfer objects, identity-keyed).
        self._route_slots: Dict[object, Dict[object, List[list]]] = defaultdict(dict)
        # host -> [(t, cpu_frac, mem_frac, disk_frac, gpu_frac)]
        self._usage: Dict[object, list] = defaultdict(list)
        self._data_transfers: List[dict] = []
        self._sched_turnovers: List[float] = []
        self._n_sched_ops = 0
        # Wasted sim-seconds of aborted executions (host crashes, spot
        # preemptions, proactive evictions) — the rework half of the
        # spot-survival cost accounting.  Always inside some billed busy
        # interval, so rework is a breakdown of instance-hours, never an
        # addition to them (audit_meter checks exactly that).
        self._rework_s = 0.0
        # Native network engines whose per-route stats replace per-slot
        # logs (``NativeNetworkEngine.metered_route_stats``).
        self._native_sources: List[object] = []

    def add_native_source(self, engine) -> None:
        self._native_sources.append(engine)

    def _native_stats(self):
        for engine in self._native_sources:
            yield from engine.metered_route_stats()

    # -- derived metrics -------------------------------------------------
    @property
    def runtime(self) -> float:
        return self.env.now

    @property
    def wall_clock(self) -> float:
        return self.clock.elapsed()

    @property
    def total_scheduling_ops(self) -> int:
        return self._n_sched_ops

    @property
    def cumulative_instance_hours(self) -> float:
        total = 0.0
        for intervals in self._host_intervals.values():
            for iv in intervals:
                if len(iv) == 2:
                    total += iv[1] - iv[0]
        return total / 3600.0

    @property
    def total_network_traffic_cost(self) -> float:
        """$ egress over all metered routes (ref ``meter.py:34-41``)."""
        cost = 0.0
        for route, transfers in self._route_slots.items():
            size = sum(
                slot[2]
                for slots in transfers.values()
                for slot in slots
                if len(slot) == 3
            )
            cost += self.meta.calc_network_traffic_cost(
                route.src.locality, route.dst.locality, size
            )
        for route, served_mb, _n, _gap in self._native_stats():
            cost += self.meta.calc_network_traffic_cost(
                route.src.locality, route.dst.locality, served_mb
            )
        return cost

    @property
    def average_congestion_delay(self) -> float:
        """Mean gap between consecutive service slots of a transfer."""
        delay, n = 0.0, 0
        for transfers in self._route_slots.values():
            n += len(transfers)
            for slots in transfers.values():
                for i in range(1, len(slots)):
                    delay += slots[i][0] - slots[i - 1][1]
        for _route, _mb, n_transfers, gap_sum in self._native_stats():
            n += n_transfers
            delay += gap_sum
        return delay / n if n else 0.0

    # -- recording hooks -------------------------------------------------
    def host_check_in(self, host) -> None:
        intervals = self._host_intervals[host]
        self._track_resource_usage(host)
        now = self.env.now
        last = intervals[-1] if intervals else None
        if last is None:
            intervals.append([now])
        elif len(last) == 2:
            if now > last[-1]:
                intervals.append([now])
            else:
                last.pop()  # reopen the touching interval (merge)

    def host_check_out(self, host) -> None:
        intervals = self._host_intervals[host]
        self._track_resource_usage(host)
        now = self.env.now
        if not intervals:
            raise RuntimeError("host check-out before any check-in")
        last = intervals[-1]
        if len(last) == 1:
            last.append(now)
        elif now > last[-1]:
            last[-1] = now

    def route_check_in(self, route, transfer) -> None:
        """``transfer`` is any per-transfer key — the Python fabric passes
        the Transfer object itself (identity-keyed: cheaper than minting
        id strings on the chunk-service hot path)."""
        self._route_slots[route].setdefault(transfer, []).append([self.env.now])

    def route_check_out(self, route, transfer, chunk_mb: float) -> None:
        self._route_slots[route][transfer][-1] += [self.env.now, chunk_mb]

    def add_data_transfer(
        self,
        timepoint: float,
        sources,
        dst,
        data_amt: float,
        total_delay: float,
        prop_delay: float,
        avg_bw: float,
        avg_egress_cost: float,
    ) -> None:
        self._data_transfers.append(
            {
                "timestamp": timepoint,
                "from": [[s.cloud, s.region, s.zone] for s in sources],
                "to": [dst.cloud, dst.region, dst.zone],
                "data_amt": data_amt,
                "total_delay": total_delay,
                "propagation_delay": prop_delay,
                "avg_bw": avg_bw,
                "avg_egress_cost": avg_egress_cost,
            }
        )

    def add_scheduling_turnover(self, latency: float) -> None:
        """Submit→placement latency of one task, in sim-seconds.

        The reference declares this hook but never calls it
        (``resources/meter.py:102-103``); here the global scheduler feeds
        it on every successful placement (wait-queue residency included),
        making it a live scheduling-latency / starvation metric."""
        self._sched_turnovers.append(latency)

    def increment_scheduling_ops(self, n_ops: int) -> None:
        self._n_sched_ops += n_ops

    def add_rework(self, seconds: float) -> None:
        """Sim-seconds of work an aborted execution wasted (staging +
        compute since its admission) — fed by every abort path (crash,
        spot abort, proactive eviction), both executor backends.
        Accumulated unclamped: a negative delta is an accounting bug, and
        ``audit_meter``'s negative-rework check is what must catch it."""
        self._rework_s += float(seconds)

    @property
    def rework_seconds(self) -> float:
        """Total wasted compute-seconds across aborted executions."""
        return self._rework_s

    _USAGE_DIMS = {"cpus": 1, "mem": 2, "disk": 3, "gpus": 4}

    def _track_resource_usage(self, host) -> None:
        r = host.resource
        self._usage[host].append(
            (
                self.env.now,
                (r.t_cpus - r.cpus) / r.t_cpus if r.t_cpus else 0.0,
                (r.t_mem - r.mem) / r.t_mem if r.t_mem else 0.0,
                (r.t_disk - r.disk) / r.t_disk if r.t_disk else 0.0,
                (r.t_gpus - r.gpus) / r.t_gpus if r.t_gpus else 0.0,
            )
        )

    # -- aggregation / persistence ---------------------------------------
    def host_usage_curve(self, sample_size: float = 100.0):
        """Time-bucketed count of busy hosts (ref ``plot_host_usage``)."""
        counter: Dict[tuple, set] = {}
        for host, intervals in self._host_intervals.items():
            for iv in intervals:
                if len(iv) != 2:
                    continue
                start = floor_bucket(iv[0], sample_size)
                end = ceil_bucket(iv[1], sample_size)
                cur = min(start + sample_size, end)
                while cur < end:
                    counter.setdefault((cur - sample_size, cur), set()).add(host)
                    cur += sample_size
        x = sorted(counter)
        return x, [len(counter[k]) for k in x]

    def resource_usage_curve(self, resource: str, sample_size: float = 100.0):
        """Time-bucketed mean normalized utilization of one dimension."""
        dim = self._USAGE_DIMS[resource]
        counter: Dict[float, Dict[object, list]] = {}
        for host, recs in self._usage.items():
            for rec in recs:
                counter.setdefault(floor_bucket(rec[0], sample_size), {}).setdefault(
                    host, []
                ).append(rec[dim])
        x = sorted(counter)
        y = [
            float(np.mean([np.mean(v) for v in counter[t].values()])) for t in x
        ]
        return x, y

    def avg_host_usage(self, sample_size: float = 100.0) -> float:
        _, counts = self.host_usage_curve(sample_size)
        return float(np.mean(counts)) if counts else 0.0

    def avg_resource_usage(self, resource: str, sample_size: float = 100.0) -> float:
        _, vals = self.resource_usage_curve(resource, sample_size)
        return float(np.mean(vals)) if vals else 0.0

    def summary(self) -> dict:
        return {
            "egress_cost": self.total_network_traffic_cost,
            "cum_instance_hours": self.cumulative_instance_hours,
            "rework_seconds": self._rework_s,
            "avg_congestion_delay": self.average_congestion_delay,
            "total_scheduling_ops": self._n_sched_ops,
            "avg_scheduling_turnover": self.average_scheduling_turnover,
            "sim_time": self.runtime,
            "wall_clock": self.wall_clock,
        }

    @property
    def average_scheduling_turnover(self) -> float:
        """Mean submit→placement latency (sim-seconds) across placements."""
        if not self._sched_turnovers:
            return 0.0
        return float(np.mean(self._sched_turnovers))

    def publish_metrics(self, registry, run: str = "default") -> None:
        """Publish this run's derived metrics into the unified registry
        (``pivot_tpu_torch.obs.MetricsRegistry``), labeled by run — the batch
        half of the one-snapshot-shape contract (``SloMeter
        .publish_metrics`` is the serving half)."""
        g = [
            ("pivot_run_egress_cost_dollars",
             "total network egress cost over metered routes",
             self.total_network_traffic_cost),
            ("pivot_run_instance_hours",
             "cumulative billed instance hours",
             self.cumulative_instance_hours),
            ("pivot_run_rework_seconds",
             "sim-seconds of aborted-execution rework",
             self._rework_s),
            ("pivot_run_sim_seconds", "simulated time", self.runtime),
            ("pivot_run_wall_seconds",
             "wall seconds on the injected obs clock", self.wall_clock),
            ("pivot_run_avg_scheduling_turnover_seconds",
             "mean submit-to-placement latency (sim-seconds)",
             self.average_scheduling_turnover),
        ]
        for name, help_text, value in g:
            registry.gauge(name, help_text, labelnames=("run",))
            registry.set(name, value, run=run)
        registry.counter(
            "pivot_run_scheduling_ops_total",
            "placement decisions considered by the tick loop",
            labelnames=("run",),
        )
        registry.set(
            "pivot_run_scheduling_ops_total", self._n_sched_ops, run=run
        )

    def save(self, data_dir: str) -> None:
        """Write the reference-compatible four-file JSON layout."""
        os.makedirs(data_dir, exist_ok=True)
        with open(os.path.join(data_dir, "general.json"), "w") as f:
            json.dump(
                {
                    "egress_cost": self.total_network_traffic_cost,
                    "cum_instance_hours": self.cumulative_instance_hours,
                    "avg_scheduling_turnover": self.average_scheduling_turnover,
                },
                f,
            )
        with open(os.path.join(data_dir, "transfers.json"), "w") as f:
            json.dump(self._data_transfers, f)
        with open(os.path.join(data_dir, "scheduler.json"), "w") as f:
            json.dump(
                {
                    "turnovers": self._sched_turnovers,
                    "total_scheduling_ops": self._n_sched_ops,
                },
                f,
            )
        with open(os.path.join(data_dir, "host_usage.json"), "w") as f:
            x, y = self.host_usage_curve()
            json.dump({"timestamps": x, "n_hosts": y}, f)


class StreamingHistogram:
    """Fixed-memory log-bucketed histogram for unbounded value streams.

    The serving layer records one decision latency per scheduler tick and
    one queue-depth sample per arrival for the lifetime of the process —
    an always-on service cannot keep the raw samples the way
    ``Meter._sched_turnovers`` does for a finite batch run.  Geometric
    buckets (``bins_per_decade`` per power of ten between ``lo`` and
    ``hi``) give percentile estimates with bounded relative error
    (~``10^(1/bins_per_decade) − 1``, <4 % at the default 64) in O(1)
    memory and O(1) per record.

    Values below ``lo`` clamp into the first bucket, values above ``hi``
    into the last; exact ``min``/``max``/``sum``/``count`` moments are
    tracked alongside, so the snapshot's mean and extremes are exact even
    where the percentiles are bucketed.  Not thread-safe on its own —
    :class:`SloMeter` serializes access.
    """

    __slots__ = ("lo", "hi", "_scale", "_counts", "count", "_sum",
                 "_min", "_max")

    def __init__(
        self, lo: float = 1e-6, hi: float = 1e4, bins_per_decade: int = 64
    ):
        if not (0 < lo < hi):
            raise ValueError("need 0 < lo < hi")
        self.lo = lo
        self.hi = hi
        self._scale = bins_per_decade
        n = int(math.ceil((math.log10(hi) - math.log10(lo)) * bins_per_decade))
        self._counts = np.zeros(n + 1, dtype=np.int64)
        self.count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def record(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self._sum += v
        self._min = min(self._min, v)
        self._max = max(self._max, v)
        if v <= self.lo:
            idx = 0
        else:
            idx = int((math.log10(v) - math.log10(self.lo)) * self._scale) + 1
            idx = min(idx, len(self._counts) - 1)
        self._counts[idx] += 1

    def percentile(self, q: float) -> float:
        """Upper-edge estimate of the ``q``-th percentile (0 < q ≤ 100)."""
        if self.count == 0:
            return 0.0
        rank = max(int(math.ceil(q / 100.0 * self.count)), 1)
        cum = np.cumsum(self._counts)
        idx = int(np.searchsorted(cum, rank))
        if idx == 0:
            return min(self.lo, self._max)
        edge = self.lo * 10 ** (idx / self._scale)
        # An edge cannot overstate the true max (exactly tracked).
        return min(edge, self._max)

    def baseline(self) -> np.ndarray:
        """Bucket-count snapshot for windowed percentile queries — pair
        with :meth:`percentile_since`.  The autoscaler's breach detector
        needs *recent* latency, not lifetime latency: a service that ran
        calm for an hour would otherwise drown a fresh SLO breach in old
        samples."""
        return self._counts.copy()

    def percentile_since(self, baseline: np.ndarray, q: float) -> float:
        """Upper-edge ``q``-th percentile of the samples recorded since
        ``baseline`` was taken (0.0 when the window is empty).  The
        window's true max is unknown, so the estimate is the raw bucket
        edge — still bounded-relative-error."""
        delta = self._counts - baseline
        total = int(delta.sum())
        if total <= 0:
            return 0.0
        rank = max(int(math.ceil(q / 100.0 * total)), 1)
        idx = int(np.searchsorted(np.cumsum(delta), rank))
        if idx == 0:
            return self.lo
        return self.lo * 10 ** (idx / self._scale)

    @property
    def mean(self) -> float:
        return self._sum / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": int(self.count),
            "mean": self.mean,
            "min": self._min,
            "max": self._max,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


class SloMeter(LogMixin):
    """Serving-grade telemetry for the online layer (``pivot_tpu_torch.serve``).

    The batch :class:`Meter` is per-run and sim-time-centric; this meter
    is per-*service* and wall-clock-centric: decision latency (the wall
    duration of each placement call, batcher wait included), admission
    queue depth at each arrival, and admission-control counters
    (admitted / shed-by-reason / spilled / blocked / late injections).
    All hooks are thread-safe — sessions and the stream's ServeDriver record
    concurrently.  :meth:`snapshot` exports everything JSON-ready.
    """

    #: Counter keys always present in the snapshot (tests rely on these).
    #: The round-7 self-healing keys: ``failed_jobs`` (dead-lettered
    #: applications reaped by a session), ``session_restarts`` /
    #: ``requeued`` (supervisor recoveries and the in-flight jobs they
    #: re-admitted), ``kernel_failures`` / ``degraded_decisions`` (device
    #: kernel faults absorbed by CPU-twin degradation).  Round-9
    #: multi-tenant keys: ``preempted`` / ``preempt_requeued`` (in-queue
    #: preemptions and their spill re-entries), ``preempt_requests`` /
    #: ``preempt_misses`` (attempts and already-placed refusals),
    #: ``scale_up_events`` / ``scale_down_events`` (autoscaler actions).
    COUNTERS = (
        "arrived", "admitted", "completed", "shed", "spilled",
        "blocked_waits", "late_injections", "decisions", "placed",
        "failed_jobs", "session_restarts", "requeued",
        "kernel_failures", "degraded_decisions",
        "preempted", "preempt_requeued", "preempt_requests",
        "preempt_misses", "scale_up_events", "scale_down_events",
        # Round-17 fused serve spans (``fuse_spans="slo"``): whole-span
        # dispatches and the simulator ticks they covered — one
        # decision-latency sample per span (the SLO-checkpoint
        # contract), span lengths in the ``span_length`` histogram.
        "span_dispatches", "span_ticks",
    )

    #: The dispatch-path mix section of the snapshot mirrors the
    #: ``DispatchBatcher.stats`` documented key set (the ``stats_out``
    #: contract of ``run_grid_lockstep`` — ``sched/batch.py``), so bench
    #: rows and soak reports can attribute how placement calls reached
    #: the device: coalesced flushes vs the single-live-slot fast path.
    DISPATCH_KEYS = (
        "runs", "dispatches", "device_calls", "coalesced", "max_group",
        "deadline_flushes", "single_fast_path", "mesh_dispatches",
        "mesh_fallbacks", "mesh_fallback_unshardable",
        "mesh_fallback_mixed_shapes", "mesh_fallback_indivisible",
        "ragged_merges", "ragged_rows", "ragged_pad_cells",
        "respawns", "retired_slots",
    )

    #: Per-tier counter keys (each tier's section of the snapshot).
    TIER_COUNTERS = (
        "arrived", "admitted", "completed", "failed_jobs", "shed",
        "spilled", "preempted", "decisions",
    )

    def __init__(self, clock: Optional[ObsClock] = None):
        self._lock = threading.Lock()
        #: Injected obs wall clock (round 14) — share one instance with
        #: the run's :class:`Meter` and the two snapshots agree exactly
        #: on elapsed wall time (they used to keep duplicate private
        #: ``perf_counter`` starts).
        self.clock = clock or ObsClock()
        self.counters: Dict[str, int] = {k: 0 for k in self.COUNTERS}
        self.shed_reasons: Dict[str, int] = {}
        # Wall seconds per placement call (decision latency SLO).
        self.decision_latency = StreamingHistogram(1e-6, 1e4)
        # Admitted-but-incomplete jobs at each arrival instant.
        self.queue_depth = StreamingHistogram(1.0, 1e7, bins_per_decade=32)
        # Ticks per fused serve span (``fuse_spans="slo"``): how much
        # simulator time each one-latency-sample dispatch covered.
        self.span_length = StreamingHistogram(1.0, 1e4, bins_per_decade=32)
        # Sim-time job sojourn: admission timestamp -> app completion.
        self.sojourn_sim = StreamingHistogram(1e-3, 1e9, bins_per_decade=32)
        #: Per-tier telemetry, lazily created on first record for a tier
        #: (single-tenant services never allocate any).  Each entry:
        #: counters dict + shed reasons + decision-latency / sojourn
        #: histograms, serialized under ``snapshot()["tiers"]``.
        self._tiers: Dict[int, dict] = {}
        #: Live reference to the serving batcher's stats dict (attached
        #: by ``ServeDriver.run``); ``None`` snapshots as all-zero.
        self._dispatch_stats: Optional[dict] = None

    def _tier(self, tier: int) -> dict:
        """Per-tier slot (lock held by caller)."""
        t = self._tiers.get(tier)
        if t is None:
            t = {
                "counters": {k: 0 for k in self.TIER_COUNTERS},
                "shed_reasons": {},
                "decision_latency": StreamingHistogram(1e-6, 1e4),
                "sojourn_sim": StreamingHistogram(
                    1e-3, 1e9, bins_per_decade=32
                ),
            }
            self._tiers[tier] = t
        return t

    def attach_dispatch_stats(self, stats: dict) -> None:
        """Point the snapshot's ``dispatch`` section at the live
        ``DispatchBatcher.stats`` dict (the documented key set) so soak
        reports and bench rows carry the dispatch-path mix — notably
        ``single_fast_path``, which tells a reader whether decisions
        were coalesced across sessions or served same-thread."""
        with self._lock:
            self._dispatch_stats = stats

    def count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + n

    def count_tier(self, tier: int, key: str, n: int = 1) -> None:
        """Per-tier counter (also bumps nothing globally — call
        :meth:`count` separately when a key exists at both scopes)."""
        with self._lock:
            c = self._tier(tier)["counters"]
            c[key] = c.get(key, 0) + n

    def record_shed(self, reason: str, tier: Optional[int] = None) -> None:
        with self._lock:
            self.counters["shed"] += 1
            self.shed_reasons[reason] = self.shed_reasons.get(reason, 0) + 1
            if tier is not None:
                t = self._tier(tier)
                t["counters"]["shed"] += 1
                t["shed_reasons"][reason] = (
                    t["shed_reasons"].get(reason, 0) + 1
                )

    def record_decision(self, wall_s: float, n_tasks: int,
                        n_placed: int) -> None:
        """One placement call: wall latency + batch size + placements."""
        with self._lock:
            self.decision_latency.record(wall_s)
            self.counters["decisions"] += n_tasks
            self.counters["placed"] += n_placed

    def record_span_decision(self, wall_s: float, n_ticks: int,
                             n_tasks: int, n_placed: int) -> None:
        """One fused serve span (``fuse_spans="slo"``): the whole span
        is ONE decision-latency sample — the latency an admitted job
        actually experienced at the dispatch boundary — with the span
        length recorded separately so a reader can tell a 1-tick
        dispatch from a 32-tick one (the snapshot's ``span_length``
        section).  ``n_tasks`` counts the span's unique slots."""
        with self._lock:
            self.decision_latency.record(wall_s)
            self.span_length.record(max(n_ticks, 1))
            self.counters["span_dispatches"] += 1
            self.counters["span_ticks"] += n_ticks
            self.counters["decisions"] += n_tasks
            self.counters["placed"] += n_placed

    def record_decision_tier(self, tier: int, wall_s: float,
                             n_tasks: int = 0) -> None:
        """Attribute one placement call's wall latency to ``tier`` —
        called once per tier *present in the decided batch*, so a tier's
        histogram measures the latency its work actually experienced
        (mixed-tier batches count toward every tier they carried)."""
        with self._lock:
            t = self._tier(tier)
            t["decision_latency"].record(wall_s)
            t["counters"]["decisions"] += n_tasks

    def record_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depth.record(depth)

    def record_sojourn(self, sim_s: float, tier: Optional[int] = None) -> None:
        with self._lock:
            self.sojourn_sim.record(sim_s)
            if tier is not None:
                self._tier(tier)["sojourn_sim"].record(sim_s)

    def tier_decision_baseline(self, tier: int) -> "np.ndarray":
        """Windowed-percentile baseline for ``tier``'s decision-latency
        histogram (see :meth:`StreamingHistogram.baseline`)."""
        with self._lock:
            return self._tier(tier)["decision_latency"].baseline()

    def tier_decision_p99_since(self, tier: int, baseline) -> float:
        """p99 decision latency of ``tier``'s samples since ``baseline``
        (0.0 for an empty window) — the autoscaler's breach signal."""
        with self._lock:
            return self._tier(tier)["decision_latency"].percentile_since(
                baseline, 99
            )

    def tier_counter(self, tier: int, key: str) -> int:
        with self._lock:
            t = self._tiers.get(tier)
            return 0 if t is None else t["counters"].get(key, 0)

    @property
    def wall_clock(self) -> float:
        return self.clock.elapsed()

    def snapshot(self) -> dict:
        """JSON-ready view of the service's SLO state at this instant."""
        with self._lock:
            stats = self._dispatch_stats or {}
            return {
                "wall_s": round(self.wall_clock, 4),
                "counters": dict(self.counters),
                "shed_reasons": dict(self.shed_reasons),
                "decision_latency_s": self.decision_latency.snapshot(),
                "queue_depth": self.queue_depth.snapshot(),
                "span_length": self.span_length.snapshot(),
                "sojourn_sim_s": self.sojourn_sim.snapshot(),
                # The documented DispatchBatcher stats key set, zeros
                # when the service never engaged a batcher — fixed
                # schema either way (tests assert it).
                "dispatch": {
                    k: int(stats.get(k, 0)) for k in self.DISPATCH_KEYS
                },
                "tiers": {
                    str(tier): {
                        "counters": dict(t["counters"]),
                        "shed_reasons": dict(t["shed_reasons"]),
                        "decision_latency_s": t["decision_latency"].snapshot(),
                        "sojourn_sim_s": t["sojourn_sim"].snapshot(),
                    }
                    for tier, t in sorted(self._tiers.items())
                },
            }

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.snapshot(), f, indent=2)
        os.replace(tmp, path)

    @staticmethod
    def _publish_hist(registry, name: str, help_text: str,
                      hist: StreamingHistogram, **labels) -> None:
        registry.summary(name, help_text,
                         labelnames=tuple(sorted(labels)))
        registry.observe_summary(
            name,
            count=hist.count,
            total=hist._sum,
            quantiles={
                0.5: hist.percentile(50),
                0.95: hist.percentile(95),
                0.99: hist.percentile(99),
            },
            **labels,
        )

    def publish_metrics(self, registry) -> None:
        """Publish the service's SLO state into the unified registry
        (``pivot_tpu_torch.obs.MetricsRegistry``) — counters, shed reasons,
        per-tier counters, the three latency/depth distributions as
        summaries, and the dispatch-path mix.  Idempotent (set-style):
        republishing a later snapshot overwrites, never double-counts.
        One snapshot shape for every consumer instead of five."""
        with self._lock:
            counters = dict(self.counters)
            shed = dict(self.shed_reasons)
            tiers = {
                tier: dict(t["counters"])
                for tier, t in sorted(self._tiers.items())
            }
            stats = dict(self._dispatch_stats or {})
        registry.counter(
            "pivot_serve_events_total",
            "admission/serve lifecycle counters "
            "(SloMeter.COUNTERS key set)",
            labelnames=("event",),
        )
        for key, value in counters.items():
            registry.set("pivot_serve_events_total", value, event=key)
        registry.counter(
            "pivot_serve_shed_total",
            "jobs shed, by recorded reason",
            labelnames=("reason",),
        )
        for reason, value in shed.items():
            registry.set("pivot_serve_shed_total", value, reason=reason)
        registry.counter(
            "pivot_serve_tier_events_total",
            "per-tier lifecycle counters (SloMeter.TIER_COUNTERS)",
            labelnames=("event", "tier"),
        )
        for tier, tc in tiers.items():
            for key, value in tc.items():
                registry.set(
                    "pivot_serve_tier_events_total", value,
                    event=key, tier=tier,
                )
        registry.counter(
            "pivot_serve_dispatch_total",
            "dispatch-path mix (DispatchBatcher documented stats keys)",
            labelnames=("key",),
        )
        for key in self.DISPATCH_KEYS:
            registry.set(
                "pivot_serve_dispatch_total", int(stats.get(key, 0)),
                key=key,
            )
        self._publish_hist(
            registry, "pivot_serve_decision_latency_seconds",
            "wall latency of each placement call (batcher wait "
            "included)", self.decision_latency,
        )
        self._publish_hist(
            registry, "pivot_serve_queue_depth",
            "admitted-but-incomplete jobs at each arrival",
            self.queue_depth,
        )
        self._publish_hist(
            registry, "pivot_serve_sojourn_sim_seconds",
            "admission-to-completion sim-time sojourn per job",
            self.sojourn_sim,
        )
        registry.gauge(
            "pivot_serve_wall_seconds",
            "service wall clock on the injected obs clock",
        )
        registry.set("pivot_serve_wall_seconds", self.wall_clock)
