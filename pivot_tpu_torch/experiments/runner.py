"""Experiment runner: replay a trace into a scheduler over a cloned cluster.

Capability parity with the reference's ``ExperimentRun`` +
``TraceBasedApplicationGenerator`` (``alibaba/runner.py:13-136``): each run
gets a fresh event loop and meter, a cluster clone, a scheduler wired to a
policy, and a submission process that replays trace jobs with their
inter-arrival gaps, then stops the scheduler; the run executes to event
exhaustion and writes the meter's JSON output plus ``avg_runtime``.

Runs are plain callables — the grid in ``experiments.cli`` executes
them sequentially or via ``multiprocessing`` (the reference always forks; on
a single-core host sequential is faster).

Port of ``pivot_tpu/experiments/runner.py``.  The lock-step grid
(``run_grid_lockstep``) and the spot-market hook are not ported yet
(ROADMAP.md, port queue).
"""

from __future__ import annotations

import json
import os
from typing import Optional

from pivot_tpu_torch.des import Environment
from pivot_tpu_torch.infra import Cluster
from pivot_tpu_torch.infra.meter import Meter
from pivot_tpu_torch.sched import GlobalScheduler, Policy
from pivot_tpu_torch.utils import LogMixin
from pivot_tpu_torch.utils.trace import Tracer
from pivot_tpu_torch.workload.trace import TraceSchedule, load_trace_jobs

__all__ = [
    "ExperimentRun",
    "replay_schedule",
    "sentinel_path",
]


def sentinel_path(data_dir: str, label: str) -> str:
    """Completion-sentinel location for a run — the single definition shared
    by the writer (``ExperimentRun.run``) and the resume check
    (``experiments.cli``)."""
    return os.path.join(data_dir, label, "complete.json")


def replay_schedule(
    env: Environment,
    scheduler: GlobalScheduler,
    schedule: TraceSchedule,
    n_apps: Optional[int] = None,
):
    """Generator process: submit apps at trace inter-arrival gaps, then stop
    the scheduler (ref ``alibaba/runner.py:104-119``)."""
    last_ts = None
    counter = 0
    done = False
    for ts, apps in schedule.bins:
        if last_ts is not None:
            yield env.timeout(ts - last_ts)
        for app in apps:
            scheduler.submit(app)
            counter += 1
            if n_apps and counter == n_apps:
                done = True
                break
        if done:
            break
        last_ts = ts
    scheduler.stop()


class ExperimentRun(LogMixin):
    """One (policy × trace) simulation run."""

    def __init__(
        self,
        label: str,
        cluster: Cluster,
        policy: Policy,
        trace_file: Optional[str] = None,
        output_size_scale_factor: float = 1000.0,
        n_apps: Optional[int] = None,
        data_dir: Optional[str] = None,
        seed: Optional[int] = None,
        interval: float = 5,
        fuse_spans: bool = True,
        trace_events: bool = False,
        identity: Optional[dict] = None,
        audit: bool = False,
        schedule: Optional[TraceSchedule] = None,
    ):
        self.label = label
        self.cluster = cluster
        self.policy = policy
        self.trace_file = trace_file
        # In-memory submission schedule: bypasses the trace-file load —
        # the serving parity harness (tests/test_serve.py) compares a
        # served job subset against exactly this run.
        self._schedule = schedule
        if trace_file is None and schedule is None:
            raise ValueError("ExperimentRun needs a trace_file or schedule")
        self.output_size_scale_factor = output_size_scale_factor
        self.n_apps = n_apps
        self.data_dir = data_dir
        self.seed = seed
        self.interval = interval
        #: Pure-tick-run fusion (round 8): fast-forward provably no-op
        #: ticks and serve pump-delivery windows as fused device spans.
        #: Bit-identical outputs either way; off only for harnesses that
        #: compare per-tick policy-call logs (tests/test_serve.py).
        self.fuse_spans = fuse_spans
        # Structured event tracing (utils.trace); written next to the
        # meter's JSON when data_dir is set, kept on .tracer otherwise.
        self.trace_events = trace_events
        self.tracer: Optional[Tracer] = None
        self.identity = identity
        self.audit = audit

    def run_identity(self) -> dict:
        """What makes this run *this* run — compared on grid resume.

        The grid passes the full spec identity (cluster config,
        policy config including device/adaptive, flags) via ``identity``;
        the fallback fields cover direct ``ExperimentRun`` users."""
        if self.identity is not None:
            return self.identity
        return {
            "label": self.label,
            "trace_file": (
                os.path.abspath(self.trace_file) if self.trace_file else None
            ),
            "n_apps": self.n_apps,
            "seed": self.seed,
            "scale_factor": self.output_size_scale_factor,
        }

    def run(self) -> dict:
        env = Environment()
        self.tracer = Tracer(enabled=self.trace_events)
        # One injected obs clock per run: the meter's wall snapshot and
        # the tracer's wall timestamps share an epoch (round 14).
        meter = Meter(env, self.cluster.meta, clock=self.tracer.clock)
        cluster = self.cluster.clone(env, meter)
        scheduler = GlobalScheduler(
            env,
            cluster,
            self.policy,
            interval=self.interval,
            seed=self.seed,
            meter=meter,
            tracer=self.tracer,
            fuse_spans=self.fuse_spans,
        )
        if self._schedule is not None:
            schedule = self._schedule
        else:
            schedule = load_trace_jobs(
                self.trace_file, self.output_size_scale_factor
            )
        if self.n_apps:
            schedule = schedule.take(self.n_apps)
        # Kept for post-run inspection (app start/end times carry the
        # simulated timestamps) — the calibration harness reads these.
        self.schedule = schedule

        cluster.start()
        scheduler.start()
        if self.audit:
            from pivot_tpu_torch.infra.audit import start_periodic_audit

            start_periodic_audit(cluster, period=self.interval)
        env.process(replay_schedule(env, scheduler, schedule, self.n_apps))

        self.logger.info("running %s on %s", self.label, self.trace_file)
        env.run()
        if self.audit:
            # The periodic observer throttles to one audit per interval;
            # a final full check closes the last window so corruption
            # arising near event exhaustion cannot ship silently.
            from pivot_tpu_torch.infra import audit

            audit.check(cluster, f"final state after {self.label}")

        apps = schedule.apps
        runtimes = [a.end_time - a.start_time for a in apps]
        avg_runtime = sum(runtimes) / len(runtimes) if runtimes else 0.0
        summary = meter.summary()
        summary["avg_runtime"] = avg_runtime
        summary["n_apps"] = len(apps)
        summary["label"] = self.label
        dispatch_stats = getattr(self.policy, "dispatch_stats", None)
        if dispatch_stats is not None:
            # Device policies: ticks served by the device / the numpy
            # twin / the hand-written kernel (``sched/cuda.py``).
            summary["dispatch"] = dispatch_stats()
        # Pure-tick-run fusion: spans served, ticks inside them, ticks
        # fast-forwarded, spans aborted mid-replay or declined.
        summary["spans"] = {k: scheduler.span_stats[k] for k in (
            "fused_spans", "fused_ticks", "ff_ticks", "span_aborts",
            "spans_declined")}

        if self.data_dir:
            out = os.path.join(self.data_dir, self.label)
            meter.save(out)
            general_path = os.path.join(out, "general.json")
            with open(general_path) as f:
                general = json.load(f)
            general["avg_runtime"] = avg_runtime
            with open(general_path, "w") as f:
                json.dump(general, f)
            if self.trace_events:
                self.tracer.save_jsonl(os.path.join(out, "events.jsonl"))
                self.tracer.save_chrome(os.path.join(out, "events.chrome.json"))
                self.tracer.save_perfetto(
                    os.path.join(out, "events.perfetto.json")
                )
            # Completion sentinel — written LAST and atomically (a truncated
            # sentinel after a mid-write kill must read as "incomplete", not
            # crash the resumed sweep), carrying the run identity so grid
            # resume can (a) trust every other artifact exists and (b)
            # refuse to skip when the spec behind this dir changed.
            marker = sentinel_path(self.data_dir, self.label)
            tmp = marker + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.run_identity(), f)
            os.replace(tmp, marker)
        self.logger.info(
            "finished %s: avg_runtime=%.1f egress=$%.2f wall=%.2fs",
            self.label,
            avg_runtime,
            summary["egress_cost"],
            summary["wall_clock"],
        )
        return summary
