"""Sampled device-dispatch profiler.

Port of ``pivot_tpu/obs/profiler.py``.  :class:`DispatchProfiler`
answers *how long do the device dispatches actually take, and is that
what the analytic device model predicts?*  It brackets kernel
dispatches at the boundaries where host control crosses into the card —
``sched/cuda.py`` ``_call_kernel`` (per-tick kernels), ``place_span``
and the resident tier's ``_resident_dispatch`` (fused spans), and
``DispatchBatcher._flush`` (coalesced serve / grid dispatches) — and
times a deterministic 1-in-N sample of them to completion.

Where the reference forces a sampled dispatch with
``jax.block_until_ready``, the port records a CUDA event on the current
stream after the thunk and synchronises THAT event: serving sessions
dispatch from several threads, and a device-wide
``torch.cuda.synchronize()`` would stall all of them.  A dispatch whose
outputs are host arrays or CPU tensors (a batcher flush fetches its
placements itself; the CPU path is synchronous) needs no wait.

Design pins (the reference's):

  * **wall capture lives HERE** — the boundary hooks hand the profiler
    a thunk; the profiler owns every ``time.perf_counter`` read, so
    ``sched/`` and ``ops/`` stay clock-free;
  * **zero-cost off, placements bit-identical either way** —
    ``profile()`` short-circuits on ``enabled`` before touching a clock
    or lock; sampling only *times* the thunk and never touches operands;
  * **deterministic cadence** — whether call #k of a family is sampled
    is a pure function of (seed, family, k): a per-family phase derived
    from ``crc32(seed:family)`` offsets a call counter, so two profiled
    replays of a seeded run sample the identical dispatches, and
    :meth:`DispatchProfiler.sampled_indices` gives the same list as
    ``pivot_tpu``'s.

Each sampled dispatch publishes into three sinks: per-family streaming
stats exported to the :class:`~pivot_tpu_torch.obs.registry.
MetricsRegistry` (:meth:`DispatchProfiler.publish_metrics`,
``pivot_dispatch_*`` families); a ``device``-lane span on the attached
tracer whose args carry the dispatch shape, the backend and the analytic
prediction; and a measured-vs-predicted ratio against the work model of
``infra/roofline.py`` (dispatch floor + max(flops/peak, bytes/bw)).

Family names.  The port's kernel callables carry the reference's family
names, so a census reads the same in both packages (:data:`PORT_FAMILIES`;
any other callable's name loses its ``_impl`` / ``_kernel`` suffix as
in the reference):

  =============================  ============================  ==========
  port callable                  family                        model kind
  =============================  ============================  ==========
  ``cost_aware_cuda``            ``cost_aware_pallas``         pallas_rb
  (``greedy_place``, R = 1)
  ``CudaCostAwarePolicy._greedy``  ``cost_aware_pallas``       pallas_rb
  ``cost_aware_cuda_batched``    ``cost_aware_pallas_batched`` pallas_rb
  ``cost_aware_cuda_rows``       ``cost_aware_pallas_batched`` pallas_rb
  ``opportunistic_impl``         ``opportunistic``             slim
  ``first_fit_impl``             ``first_fit``                 slim
  ``best_fit_impl``              ``best_fit``                  slim
  ``cost_aware_impl``            ``cost_aware``                slim
  ``fused_tick_run``             ``fused_tick_run``            scan
  ``resident_span_run``          ``resident_span_run``         scan
  =============================  ============================  ==========

The two-phase torch forms model as ``"slim"`` on every device: their
``phase2="auto"`` resolves to the slim early-exit pass everywhere in the
port (``ops/kernels.py``), where the reference's resolves to slim on the
CPU only.
"""

from __future__ import annotations

import threading
import time
import zlib
from statistics import median as _median
from typing import Any, Callable, Dict, List, Optional

__all__ = ["DispatchProfiler", "PORT_FAMILIES", "family_of",
           "predicted_seconds"]

#: The port's kernel callables under the reference's family names
#: (module docstring's table).
PORT_FAMILIES: Dict[str, str] = {
    "cost_aware_cuda": "cost_aware_pallas",
    "_greedy": "cost_aware_pallas",
    "cost_aware_cuda_batched": "cost_aware_pallas_batched",
    "cost_aware_cuda_rows": "cost_aware_pallas_batched",
}

_TWO_PHASE = {
    "opportunistic", "first_fit", "best_fit", "cost_aware",
}
_SCAN_ONLY = {
    "opportunistic_ref", "first_fit_ref", "best_fit_ref",
    "cost_aware_ref", "fused_tick_run", "resident_span_run",
}
_PALLAS = {"cost_aware_pallas", "cost_aware_pallas_batched"}


def family_of(kernel: Any) -> str:
    """Stable family name for a dispatched kernel callable: the port's
    names through :data:`PORT_FAMILIES`, else the callable's
    ``__name__`` with the ``_impl``/``_kernel`` plumbing suffixes
    stripped (``first_fit_impl`` → ``first_fit``,
    ``cost_aware_kernel_ref`` → ``cost_aware_ref``)."""
    name = getattr(kernel, "__name__", None) or type(kernel).__name__
    if name in PORT_FAMILIES:
        return PORT_FAMILIES[name]
    for suffix, repl in (
        ("_kernel_ref", "_ref"), ("_impl", ""), ("_kernel", ""),
    ):
        if name.endswith(suffix):
            return name[: -len(suffix)] + repl
    return name


def _model_kind(family: str) -> Optional[str]:
    if family in _PALLAS:
        return "pallas_rb"
    if family in _SCAN_ONLY:
        return "scan"
    if family in _TWO_PHASE:
        return "slim"
    return None


def predicted_seconds(
    family: str,
    shape: Dict[str, int],
    backend: str,
    floor_s: float,
    peaks: Optional[Dict[str, float]] = None,
) -> Optional[float]:
    """Analytic wall prediction for one dispatch: the probed per-call
    dispatch floor plus the roofline time bound of the estimated work
    (``max(flops/peak_flops, bytes/peak_bw)``) on ``backend``'s peaks
    (``"cuda"``: the H100's; ``"cpu"``: measured).  A trend-level model
    — its job is the ×-level drift verdict, not microsecond accuracy.
    None when the family has no work model (the ratio is then omitted
    rather than fabricated)."""
    kind = _model_kind(family)
    h = int(shape.get("h", 0))
    t = int(shape.get("t", shape.get("b", 0)))
    if kind is None or h <= 0 or t <= 0:
        return None
    from pivot_tpu_torch.infra import roofline

    k = int(shape.get("k", 1)) or 1
    r = int(shape.get("g", 1)) or 1
    peaks = peaks or roofline.backend_peaks(backend)
    cost = roofline.placement_cost(kind, t * k, h, R=r, dtype_bytes=4)
    work_s = max(
        cost["flops"] / (peaks["flops_peak_gflops"] * 1e9),
        cost["bytes"] / (peaks["bw_gbps"] * 1e9),
    )
    return floor_s + work_s


class _FamilyStats:
    """Streaming per-family latency stats + a bounded duration ring."""

    __slots__ = ("calls", "sampled", "total_s", "min_s", "max_s",
                 "durs", "ratios", "h2d_bytes")

    _RING = 1024  # bounded memory for quantiles on long soaks

    def __init__(self):
        self.calls = 0
        self.sampled = 0
        self.total_s = 0.0
        self.min_s = float("inf")
        self.max_s = 0.0
        self.durs: List[float] = []
        self.ratios: List[float] = []
        # Host→device bytes freshly staged for the dispatch, as declared
        # by the boundary hook: accumulated for EVERY call (an exact
        # caller-side count, not a sampled measurement).
        self.h2d_bytes = 0

    def record(self, dur: float, ratio: Optional[float]) -> None:
        self.sampled += 1
        self.total_s += dur
        self.min_s = min(self.min_s, dur)
        self.max_s = max(self.max_s, dur)
        if len(self.durs) < self._RING:
            self.durs.append(dur)
        else:
            self.durs[self.sampled % self._RING] = dur
        if ratio is not None:
            if len(self.ratios) < self._RING:
                self.ratios.append(ratio)
            else:
                self.ratios[self.sampled % self._RING] = ratio


def _first_tensor(out):
    """The first torch tensor in a dispatch's output (tuples, lists,
    dicts and named tuples walked in order), or None."""
    import torch

    stack = [out]
    while stack:
        x = stack.pop(0)
        if torch.is_tensor(x):
            return x
        if isinstance(x, dict):
            stack[:0] = list(x.values())
        elif isinstance(x, (tuple, list)):
            stack[:0] = list(x)
    return None


def _wait(out) -> None:
    """Force one dispatch's completion: a CUDA event recorded on the
    current stream of the output's card, then synchronised — this
    stream's work only, never the whole device.  Host outputs need no
    wait."""
    t = _first_tensor(out)
    if t is None or t.device.type != "cuda":
        return
    import torch

    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    ev.synchronize()


def _device_type(device) -> str:
    if device is None:
        return "cpu"
    return getattr(device, "type", None) or str(device).split(":")[0]


#: Per-process dispatch-floor cache, keyed by device: the floor is a
#: property of the process's link to the card, not of one profiler.
_FLOOR_CACHE: Dict[str, float] = {}
_FLOOR_LOCK = threading.Lock()


def _probe_floor(device) -> float:
    """Fixed per-call dispatch latency on ``device``: an empty dispatch
    (``x + 1`` on an 8-element tensor) forced to completion as a sampled
    dispatch is (:func:`_wait`), best of 3, probed once per (process,
    device)."""
    key = str(device)
    with _FLOOR_LOCK:
        cached = _FLOOR_CACHE.get(key)
        if cached is not None:
            return cached
        import torch

        x = torch.zeros(8, device=device)
        _wait(x + 1.0)  # first touch outside the timed reps
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            _wait(x + 1.0)
            best = min(best, time.perf_counter() - t0)
        _FLOOR_CACHE[key] = best
        return best


def _quantile(vals: List[float], q: float) -> float:
    s = sorted(vals)
    return s[min(int(q * len(s)), len(s) - 1)]


class DispatchProfiler:
    """Deterministically sampled, completion-forced dispatch timer.

    ``sample_every`` is the cadence N (1 = every dispatch); ``seed``
    fixes the per-family sampling phase; ``tracer`` (optional) receives
    one ``device``-lane span per sampled dispatch; ``registry``
    (optional) is the default :meth:`publish_metrics` sink.
    Thread-safe: serve sessions and the batcher coordinator share one
    profiler (counter advance + stats append run under one lock; the
    timed thunk itself does not).
    """

    def __init__(
        self,
        sample_every: int = 16,
        seed: int = 0,
        tracer=None,
        registry=None,
        enabled: bool = True,
    ):
        if sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        self.enabled = enabled
        self.sample_every = int(sample_every)
        self.seed = int(seed)
        self.tracer = tracer
        self.registry = registry
        self._lock = threading.Lock()
        self._stats: Dict[str, _FamilyStats] = {}
        self._phases: Dict[str, int] = {}
        self._backend: Optional[str] = None
        self._floor_s: Optional[float] = None
        self._peaks: Optional[Dict[str, float]] = None

    # -- deterministic cadence -------------------------------------------
    def _phase(self, family: str) -> int:
        phase = self._phases.get(family)
        if phase is None:
            phase = zlib.crc32(
                f"{self.seed}:{family}".encode()
            ) % self.sample_every
            self._phases[family] = phase
        return phase

    def _tick(self, family: str) -> bool:
        """Advance ``family``'s call counter; True iff this call is the
        deterministic 1-in-N sample (call under the lock)."""
        st = self._stats.get(family)
        if st is None:
            st = self._stats[family] = _FamilyStats()
        n = st.calls
        st.calls += 1
        return (n + self._phase(family)) % self.sample_every == 0

    def sampled_indices(self, family: str, n_calls: int) -> List[int]:
        """Which of ``n_calls`` consecutive calls WOULD be sampled — the
        pure cadence function."""
        phase = zlib.crc32(
            f"{self.seed}:{family}".encode()
        ) % self.sample_every
        return [
            i for i in range(n_calls)
            if (i + phase) % self.sample_every == 0
        ]

    # -- the boundary hook ------------------------------------------------
    def _lazy_floor(self, device) -> float:
        """The fixed per-call dispatch latency — the intercept of the
        analytic prediction.  Lazy (building a profiler never touches
        the card) and process-cached (:func:`_probe_floor`); the first
        sampled dispatch's device fixes the backend."""
        if self._floor_s is None:
            self._backend = _device_type(device)
            self._floor_s = _probe_floor(
                device if device is not None else "cpu")
        return self._floor_s

    def profile(
        self,
        family: str,
        fn: Callable[[], Any],
        shape: Optional[Dict[str, int]] = None,
        flush: bool = False,
        h2d_bytes: int = 0,
        device=None,
    ):
        """Run one dispatch thunk, timing it to completion when this
        call lands on the family's sampling cadence.

        Unsampled calls still advance the counter (the cadence is over
        *calls*, so it is replayable) but pay only a dict lookup and an
        increment.  Sampled calls force completion (:func:`_wait`: one
        CUDA event on the current stream, synchronised) and record a
        ``device`` span whose args carry the shape, backend and analytic
        prediction.  ``flush=True`` marks spans recorded inside a
        batcher flush (``in_flush``).  ``h2d_bytes`` is the caller's
        count of operand bytes freshly staged host→device for THIS
        dispatch, accumulated on every call.  ``device`` is the torch
        device the dispatch runs on (the backend of the prediction and
        of the floor probe; the CPU when None).
        """
        if not self.enabled:
            return fn()
        with self._lock:
            sampled = self._tick(family)
            if h2d_bytes:
                self._stats[family].h2d_bytes += int(h2d_bytes)
        if not sampled:
            return fn()
        floor_s = self._lazy_floor(device)
        backend = self._backend
        t0 = time.perf_counter()
        out = fn()
        _wait(out)
        dur = time.perf_counter() - t0
        shape = shape or {}
        pred = predicted_seconds(
            family, shape, backend, floor_s, self._peaks
        )
        ratio = dur / pred if pred and pred > 0 else None
        with self._lock:
            st = self._stats[family]
            # The family's FIRST sample may carry one-time costs (the
            # CUDA context, a kernel build or load): keep its duration
            # in the census but out of the model-ratio stats.
            cold = st.sampled == 0
            st.record(dur, None if cold else ratio)
        tracer = self.tracer
        if tracer is not None and tracer.enabled:
            args: Dict[str, Any] = {"backend": backend}
            args.update({k: int(v) for k, v in shape.items()})
            if pred is not None:
                args["pred_us"] = round(pred * 1e6, 3)
                if not cold:
                    args["model_ratio"] = round(ratio, 3)
            if cold:
                args["cold"] = True  # first sample: one-time costs
            if flush:
                args["in_flush"] = True
            if h2d_bytes:
                args["h2d_bytes"] = int(h2d_bytes)
            tracer.record_span("device", family, dur, **args)
        return out

    # -- reporting ---------------------------------------------------------
    def summary(self) -> dict:
        """Per-family latency census + model-ratio medians (what the
        serve report embeds), with ``pivot_tpu``'s keys."""
        with self._lock:
            fams = {}
            for family in sorted(self._stats):
                st = self._stats[family]
                row = {
                    "calls": st.calls,
                    "sampled": st.sampled,
                }
                if st.h2d_bytes:
                    row["h2d_bytes_total"] = st.h2d_bytes
                    row["h2d_bytes_per_call"] = round(
                        st.h2d_bytes / st.calls, 1
                    )
                if st.sampled:
                    row.update(
                        total_ms=round(st.total_s * 1e3, 3),
                        min_us=round(st.min_s * 1e6, 3),
                        max_us=round(st.max_s * 1e6, 3),
                        p50_us=round(_quantile(st.durs, 0.5) * 1e6, 3),
                        p95_us=round(_quantile(st.durs, 0.95) * 1e6, 3),
                    )
                if st.ratios:
                    row["model_ratio_p50"] = round(
                        _median(st.ratios), 3
                    )
                fams[family] = row
            return {
                "sample_every": self.sample_every,
                "seed": self.seed,
                "backend": self._backend,
                "dispatch_floor_us": (
                    round(self._floor_s * 1e6, 3)
                    if self._floor_s is not None else None
                ),
                "families": fams,
            }

    def publish_metrics(self, registry=None) -> None:
        """Publish the per-family census into the unified registry
        (publish-style: idempotent on republish).  Families:
        ``pivot_dispatch_calls_total`` / ``..._sampled_total`` counters,
        ``pivot_dispatch_latency_seconds`` summaries (p50/p95), the
        ``pivot_dispatch_model_ratio`` gauge and
        ``pivot_dispatch_h2d_bytes_total``."""
        registry = registry or self.registry
        if registry is None:
            return
        backend = self._backend or "unknown"
        registry.counter(
            "pivot_dispatch_calls_total",
            "kernel dispatches crossing a profiled boundary",
            labelnames=("family", "backend"),
        )
        registry.counter(
            "pivot_dispatch_sampled_total",
            "dispatches timed to completion by the sampler",
            labelnames=("family", "backend"),
        )
        registry.summary(
            "pivot_dispatch_latency_seconds",
            "sampled dispatch wall latency (forced to completion by a "
            "synchronised CUDA event)",
            labelnames=("family", "backend"),
        )
        registry.gauge(
            "pivot_dispatch_model_ratio",
            "median measured/predicted dispatch wall ratio vs the "
            "analytic roofline model (>2 or <0.5 = the device model "
            "is lying)",
            labelnames=("family", "backend"),
        )
        registry.counter(
            "pivot_dispatch_h2d_bytes_total",
            "operand bytes freshly staged host->device at profiled "
            "dispatch boundaries (cached device buffers excluded)",
            labelnames=("family", "backend"),
        )
        with self._lock:
            # Full snapshot under the lock: a --metrics-port scrape runs
            # concurrently with recording threads.
            items = [
                (
                    family, st.calls, st.sampled, st.total_s,
                    list(st.durs), list(st.ratios), st.h2d_bytes,
                )
                for family, st in sorted(self._stats.items())
            ]
        for family, calls, sampled, total_s, durs, ratios, h2d in items:
            labels = dict(family=family, backend=backend)
            registry.set("pivot_dispatch_calls_total", calls, **labels)
            registry.set(
                "pivot_dispatch_sampled_total", sampled, **labels
            )
            if h2d:
                registry.set(
                    "pivot_dispatch_h2d_bytes_total", h2d, **labels
                )
            if sampled:
                registry.observe_summary(
                    "pivot_dispatch_latency_seconds",
                    count=sampled,
                    total=total_s,
                    quantiles={
                        0.5: _quantile(durs, 0.5),
                        0.95: _quantile(durs, 0.95),
                    },
                    **labels,
                )
            if ratios:
                registry.set(
                    "pivot_dispatch_model_ratio",
                    round(_median(ratios), 6), **labels,
                )
