"""Arrival generators for the online serving layer.

A serving workload is a stream of :class:`JobArrival` items — an
:class:`~pivot_tpu_torch.workload.Application` stamped with the *sim-time*
instant at which it enters the system.  Two sources:

  * :func:`poisson_arrivals` — synthetic jobs from the
    ``workload/gen.py`` generators at exponential inter-arrival gaps
    (rate λ jobs per sim-second), the classic open-loop load model;
  * :func:`trace_arrivals` — replay of a sampled Alibaba trace window
    (YAML or the converter's columnar ``.npz``, ``workload/convert.py``)
    at its recorded submit times, optionally re-timed onto a Poisson
    process so a fixed trace can be replayed at any target load.

Both are plain generators: the stream driver consumes lazily, so an
unbounded stream (``n_jobs=None``) is just a generator that never ends.
Arrival times are drawn from a seeded ``numpy`` Generator — the stream
is deterministic per seed, which is what makes a served schedule
bit-comparable to the same jobs through batch-mode ``ExperimentRun``
(``tests/test_serve.py``).

JAX-free copy of ``pivot_tpu/serve/arrivals.py``, import paths rewritten.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from pivot_tpu_torch.workload import Application
from pivot_tpu_torch.workload.gen import (
    SequentialApplicationGenerator,
    _RangeSpec,
)

__all__ = [
    "JobArrival",
    "TIER_NAMES",
    "mixed_tier_arrivals",
    "poisson_arrivals",
    "synthetic_app_factory",
    "trace_arrivals",
]

#: Canonical tier vocabulary (Borg-NG's production split, PAPERS.md):
#: tier 0 = latency-sensitive serving (never shed), tier 1 = batch
#: (preemptible, retried), tier 2 = best-effort (first to go).  Tiers
#: are plain ints everywhere — smaller is more important — and this
#: tuple just names the conventional first three for CLI/docs/tenants.
TIER_NAMES = ("serving", "batch", "best_effort")


def tier_name(tier: int) -> str:
    return TIER_NAMES[tier] if 0 <= tier < len(TIER_NAMES) else f"tier{tier}"


@dataclasses.dataclass
class JobArrival:
    """One job entering the service at sim-time ``ts``.

    ``tier`` is the job's priority class (0 = most important — see
    :data:`TIER_NAMES`); ``tenant`` a free-form owner label for
    attribution.  Both default to the single-tenant values, under which
    the serving pipeline is bit-identical to its pre-tier behavior."""

    ts: float
    app: Application
    tier: int = 0
    tenant: str = "default"


def synthetic_app_factory(
    seed: int = 0,
    n_nodes=(2, 4),
    runtime=(5.0, 60.0),
    instances_hint: int = 4,
) -> Callable[[], Application]:
    """Deterministic factory of small chain-DAG applications.

    Alibaba-trace-like demands (fractional CPUs, fractional memory of a
    7.68 GB-normalized machine) via the same ``_RangeSpec`` sampling the
    batch generators use; suitable for load tests where the *arrival
    process*, not DAG structure, is under study.
    """
    spec = _RangeSpec(
        cpus=(0.5, 2.0),
        mem=(64, 2048),
        runtime=runtime,
        output_size=(0, 200),
    )
    gen = SequentialApplicationGenerator(n_nodes, spec, seed=seed)
    return gen.generate


def poisson_arrivals(
    rate: float,
    n_jobs: Optional[int],
    seed: int = 0,
    make_app: Optional[Callable[[], Application]] = None,
    start: float = 0.0,
    tier: int = 0,
    tenant: Optional[str] = None,
) -> Iterator[JobArrival]:
    """Open-loop Poisson stream: exponential gaps at ``rate`` jobs per
    sim-second, apps from ``make_app`` (default: the synthetic chain-DAG
    factory seeded with ``seed``).  ``n_jobs=None`` streams forever.
    Every arrival is stamped ``tier``/``tenant`` (defaults: tier 0).

    Validation is eager (this is a plain function returning a
    generator): a non-positive ``rate`` raises here, at the call site,
    not on first iteration — a silent zero-arrival stream looks exactly
    like a healthy drained service."""
    if not rate > 0:
        raise ValueError(
            f"arrival rate must be positive, got {rate!r} — a non-positive "
            "rate would silently produce a zero-arrival stream"
        )
    rng = np.random.default_rng(seed)
    if make_app is None:
        make_app = synthetic_app_factory(seed=seed)
    if tenant is None:
        tenant = tier_name(tier)

    def gen():
        t = float(start)
        produced = 0
        while n_jobs is None or produced < n_jobs:
            # Gap first: arrivals at start + Exp gaps, never exactly at
            # the scheduler's t=0 grid point (same-instant submission/
            # tick races are the one thing the bit-parity contract
            # cannot absorb).
            t += float(rng.exponential(1.0 / rate))
            yield JobArrival(t, make_app(), tier=tier, tenant=tenant)
            produced += 1

    return gen()


def mixed_tier_arrivals(
    rate: float,
    n_jobs: Optional[int],
    weights: Sequence[float],
    seed: int = 0,
    make_app: Optional[Callable[[], Application]] = None,
    start: float = 0.0,
) -> Iterator[JobArrival]:
    """One Poisson stream carrying several priority tiers: each arrival's
    tier is an independent seeded categorical draw over ``weights``
    (index = tier; weights need not sum to 1).  This is the multi-tenant
    load model the chaos soak and the ``serve_tiers`` bench row drive —
    a single arrival process whose *mix* is under test, not per-tier
    processes (which would decorrelate tier pressure from total load).
    """
    if not rate > 0:
        raise ValueError(
            f"arrival rate must be positive, got {rate!r} — a non-positive "
            "rate would silently produce a zero-arrival stream"
        )
    w = np.asarray(list(weights), dtype=np.float64)
    if w.size == 0 or (w < 0).any() or w.sum() <= 0:
        raise ValueError(
            f"tier weights must be non-negative with a positive sum, got "
            f"{list(weights)!r}"
        )
    w = w / w.sum()
    rng = np.random.default_rng(seed)
    if make_app is None:
        make_app = synthetic_app_factory(seed=seed)

    def gen():
        t = float(start)
        produced = 0
        while n_jobs is None or produced < n_jobs:
            t += float(rng.exponential(1.0 / rate))
            tier = int(rng.choice(w.size, p=w))
            yield JobArrival(
                t, make_app(), tier=tier, tenant=tier_name(tier)
            )
            produced += 1

    return gen()


def trace_arrivals(
    trace_file: str,
    n_apps: Optional[int] = None,
    scale_factor: float = 1000.0,
    rate: Optional[float] = None,
    seed: int = 0,
) -> Iterator[JobArrival]:
    """Replay a sampled Alibaba trace window as an arrival stream.

    With ``rate=None`` jobs keep their recorded submit times (shifted so
    the first arrival lands at its absolute trace offset — the batch
    runner's schedule semantics).  With a ``rate``, the same job
    *sequence* is re-timed onto a seeded Poisson process, which turns
    one trace window into a load dial.

    An empty replay window (no jobs survive the load/``n_apps`` cut) and
    a non-positive re-timing ``rate`` both raise ``ValueError``, eagerly
    at the call site — either would otherwise produce a silent
    zero-arrival stream and a service that "drains instantly" while
    measuring nothing.
    """
    from pivot_tpu_torch.workload.trace import load_trace_jobs

    if rate is not None and not rate > 0:
        raise ValueError(
            f"trace re-timing rate must be positive, got {rate!r} (use "
            "rate=None to replay the recorded submit times)"
        )
    schedule = load_trace_jobs(trace_file, scale_factor)
    if n_apps:
        schedule = schedule.take(n_apps)
    n_jobs = sum(len(apps) for _ts, apps in schedule.bins)
    if n_jobs == 0:
        raise ValueError(
            f"trace replay window from {trace_file!r} is empty (n_apps="
            f"{n_apps!r}) — nothing would ever arrive"
        )

    def gen():
        if rate is None:
            for ts, apps in schedule.bins:
                for app in apps:
                    yield JobArrival(float(ts), app)
            return
        rng = np.random.default_rng(seed)
        t = 0.0
        for _ts, apps in schedule.bins:
            for app in apps:
                t += float(rng.exponential(1.0 / rate))
                yield JobArrival(t, app)

    return gen()
