"""Roofline accounting for the placement kernels.

Port of ``pivot_tpu/infra/roofline.py`` (numpy only), with the NVIDIA
H100's peaks in place of the TPU v5e's:

  * **per-kernel work models** — analytic FLOP and memory-byte estimates
    per placement-kernel call as a function of the (T-bucket, H, R)
    shape (:func:`placement_cost`), with the reference's counting rules
    and work kinds unchanged (``"scan"``, ``"slim"``, ``"chunked"``,
    ``"pallas_rb"``: the same shape gives the same FLOPs and bytes in
    both packages; ``"pallas_rb"`` is the model of the replica-batched
    greedy pass, served here by ``greedy_place``);
  * **per-backend peak tables** — the CPU's peaks are *measured once per
    process* by a STREAM-style triad probe (bandwidth) and a BLAS GEMM
    probe (FLOPs) (:func:`cpu_peaks`); the card's come from the H100
    SXM data sheet (:data:`H100_PEAKS`, :data:`PEAK_F32_OPS`,
    :data:`PEAK_BYTES`);
  * **row annotation** — :func:`annotate` turns (shape, measured
    seconds) into achieved GFLOP/s / GB/s and %-of-peak columns plus a
    ``bound`` verdict;
  * **serialization model** — :func:`serial_model` prices a scan-form
    kernel as ``steps × per-step seconds``; :func:`fused_loop_model`
    prices a fused span as one dispatch floor plus its ticks.

The reference's v5e table and its Pallas VMEM budget constants
(``TPU_PEAKS``, ``V5E_SCOPED_VMEM_BYTES``, ``PALLAS_VMEM_BUDGET_BYTES``,
``PALLAS_PROVEN_HP``) have no CUDA meaning and are left out:
``greedy_place``'s own budget is registers and shared memory, which
``ptxas`` reports at build time (``chip_smoke.py`` phase 1 prints it).

This work model is the dispatch profiler's prediction
(``obs/profiler.py``): a trend-level estimate of the dominant dense ops
of one call, used for a measured/predicted drift ratio.  It is not the
bound ``chip_smoke.py`` reports beside a kernel's time — that one counts
the bytes the kernel function must move and the operations it does on
its actual inputs (PERF.md's definition), a different question; the
two share only the peak constants defined here.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

__all__ = [
    "H100_PEAKS",
    "PEAK_BYTES",
    "PEAK_F32_OPS",
    "annotate",
    "backend_peaks",
    "cpu_peaks",
    "fused_loop_model",
    "placement_cost",
    "serial_model",
]

#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): f32 operations
#: per second outside the tensor cores, and HBM3 bytes per second.  The
#: placement kernels are compares, selects and small reductions, so the
#: f32 vector peak is the one that applies (the tensor cores cannot run
#: this work).  ``chip_smoke.py``'s kernel bounds read these two.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

#: The peak table of the card, in :func:`annotate`'s units.
H100_PEAKS: Dict[str, float] = {
    "bw_gbps": PEAK_BYTES / 1e9,
    "flops_peak_gflops": PEAK_F32_OPS / 1e9,
    "source": "NVIDIA H100 SXM data sheet: f32 outside the tensor cores, "
              "HBM3 bandwidth",
}

_CPU_PEAKS_CACHE: Optional[Dict[str, float]] = None


def cpu_peaks(force: bool = False) -> Dict[str, float]:
    """One-shot measured CPU peaks: STREAM-triad bandwidth + GEMM FLOPs.

    Triad ``a = b + s·c`` over 2²² f64 per array, best of 3.  numpy
    cannot fuse it, so it runs as two ops (``a = 3·c`` then
    ``a = a + b``) touching FIVE 8-byte slots per element — read c,
    write a, read a, read b, write a — and the bandwidth figure counts
    all five (counting the classic fused-triad 3 would understate the
    peak ~40% and flip ``annotate``'s bound verdicts).  GEMM (512³ f64
    ``np.dot``, best of 3) counts 2·n³ FLOPs and measures whatever BLAS
    the numpy in this image carries — the honest ceiling for dense f64
    compute here.  Cached per process (~0.2 s once).
    """
    global _CPU_PEAKS_CACHE
    if _CPU_PEAKS_CACHE is not None and not force:
        return _CPU_PEAKS_CACHE
    n = 1 << 22
    b = np.random.default_rng(0).random(n)
    c = np.random.default_rng(1).random(n)
    a = np.empty_like(b)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        np.multiply(c, 3.0, out=a)
        np.add(a, b, out=a)
        best = min(best, time.perf_counter() - t0)
    bw_gbps = 5 * 8 * n / best / 1e9  # 5 accesses/element — see docstring
    m = 512
    x = np.random.default_rng(2).random((m, m))
    y = np.random.default_rng(3).random((m, m))
    np.dot(x, y)  # warm
    bestg = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        np.dot(x, y)
        bestg = min(bestg, time.perf_counter() - t0)
    _CPU_PEAKS_CACHE = {
        "bw_gbps": round(bw_gbps, 2),
        "flops_peak_gflops": round(2 * m**3 / bestg / 1e9, 2),
        "source": "measured: STREAM-style triad + f64 GEMM probe",
    }
    return _CPU_PEAKS_CACHE


def backend_peaks(backend: str) -> Dict[str, float]:
    """Peak table for a torch device type ("cpu" probes, "cuda" looks
    up the H100's)."""
    if backend == "cuda":
        return H100_PEAKS
    return cpu_peaks()


def placement_cost(
    kind: str,
    T: int,
    H: int,
    R: int = 1,
    dtype_bytes: int = 8,
    n_groups: Optional[int] = None,
) -> Dict[str, float]:
    """Estimated (flops, bytes) of ONE placement-kernel call.

    Counting rules (per task step over H hosts, 4 resource dims; compares
    and selects count as 1 op — they occupy the same vector issue slots
    as arithmetic):

      * fit test: 4H compares + 3H ANDs ≈ 7H
      * group-score row (cost-aware): 4H mul + 3H add + H sqrt + 2H div
        ≈ 10H — charged per STEP for the scan form (it recomputes the
        row under a select every step) but per GROUP for slim/chunked
        (phase 2 computes it at entries only)
      * masked argmin (or rank-select): ≈ 3H
      * availability update: ≈ 8·4 (scatter) — negligible vs the rows

    Bytes charge what a step streams when carries stay resident: the
    two [H] score-table rows it gathers (scan) plus the [H, 4]
    availability working set ONCE per call (it lives in
    registers / cache / shared memory across steps), and for chunked forms the
    [C, H, 4] prefix stack write+read.  ``R`` scales replicas (vmapped
    scan / pallas_rb share one task stream).

    kinds: "scan" | "slim" | "chunked" | "pallas_rb" (same model as
    "scan" with the score row charged per step — the Pallas kernel also
    recomputes it under ``pl.when`` — but zero per-step table gathers:
    phase-1 tiles stream once).
    """
    G = n_groups if n_groups is not None else max(T // 16, 1)
    fit = 7.0 * H
    score_row = 10.0 * H
    argmin = 3.0 * H
    place = 32.0
    if kind in ("scan", "pallas_rb"):
        per_task = fit + score_row + argmin + place
        flops = R * T * per_task
        gathers = 2 * H * dtype_bytes  # cost + bw rows per step
        if kind == "pallas_rb":
            gathers = 0  # phase-1 tiles stream once, charged below
        bytes_ = (
            R * T * gathers
            + R * 8 * H * dtype_bytes      # avail in + out, once per call
            + T * (2 * H) * dtype_bytes    # phase-1 tiles / tables, once
        )
    elif kind == "slim":
        flops = R * (T * (fit + argmin + place) + G * score_row)
        # Like the flops rule, table-row bytes are charged per GROUP: the
        # slim pass gathers the score rows only at group entries (the
        # per-step streams are the [4] demand + scalars — negligible).
        bytes_ = R * (
            G * 2 * H * dtype_bytes        # table rows per group entry
            + 8 * H * dtype_bytes
        )
    elif kind == "chunked":
        # spec + recheck ≈ 2 decision passes + the [C, H, 4] prefix
        # stack traffic (write in the fold, read in the recheck).
        flops = R * (T * 2 * (fit + argmin + place) + G * score_row)
        bytes_ = R * (
            T * 8 * H * dtype_bytes        # prefix stack write + read
            + 8 * H * dtype_bytes
        )
    else:
        raise ValueError(f"unknown kernel kind {kind!r}")
    return {"flops": float(flops), "bytes": float(bytes_)}


def annotate(
    seconds: float,
    kind: str,
    T: int,
    H: int,
    R: int = 1,
    backend: str = "cpu",
    dtype_bytes: int = 8,
    n_groups: Optional[int] = None,
    peaks: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """Roofline columns for one measured call: estimated work, achieved
    GFLOP/s / GB/s, %-of-peak for both, and which bound (if any) binds.

    ``bound`` is "compute" or "bandwidth" when the achieved fraction
    exceeds 33% of that peak; otherwise "serialization" — neither
    roofline explains the wall, the sequential chain does (pair with
    :func:`serial_model`).
    """
    peaks = peaks or backend_peaks(backend)
    cost = placement_cost(kind, T, H, R, dtype_bytes, n_groups)
    gflops = cost["flops"] / seconds / 1e9
    gbs = cost["bytes"] / seconds / 1e9
    pf = gflops / peaks["flops_peak_gflops"]
    pb = gbs / peaks["bw_gbps"]
    if pf >= max(pb, 0.33):
        bound = "compute"
    elif pb >= 0.33:
        bound = "bandwidth"
    else:
        bound = "serialization"
    return {
        "kind": kind,
        "est_flops": cost["flops"],
        "est_bytes": cost["bytes"],
        "achieved_gflops": round(gflops, 3),
        "achieved_gbs": round(gbs, 3),
        "pct_peak_flops": round(100 * pf, 3),
        "pct_peak_bw": round(100 * pb, 3),
        "bound": bound,
    }


def serial_model(n_steps: int, step_seconds: float) -> Dict[str, float]:
    """Serialization price of a scan-form kernel: ``n_steps`` dependent
    iterations at the measured per-step wall (``pivot_tpu``'s ``bench.py``
    probes it with a short-T run at the same H).  If this lands within ~2× of the
    measured call, the kernel is serialization-bound — the chain, not
    the rooflines, sets the wall."""
    return {
        "n_steps": int(n_steps),
        "step_us": round(step_seconds * 1e6, 3),
        "predicted_s": round(n_steps * step_seconds, 6),
    }


def fused_loop_model(
    n_ticks: int,
    tick_seconds: float,
    dispatch_floor_s: float,
) -> Dict[str, float]:
    """Dispatch-amortization model of the fused tick driver
    (``ops/tickloop.py``): a span of ``n_ticks`` simulator ticks pays the
    fixed per-call dispatch floor ONCE, where the per-tick path pays it
    every tick — the fused-loop extension of :func:`serial_model` (which
    prices only the in-call serial chain).

      predicted wall(K)          = floor + K · tick_seconds
      predicted per-tick overhead = floor / K

    ``tick_seconds`` is the marginal device cost of ONE simulated tick
    (measured by a two-point difference over span lengths, so the floor
    cancels — the ``_scan_step_probe`` idiom); ``dispatch_floor_s`` is
    the probe-measured per-call round trip.  ``pivot_tpu``'s
    ``bench.py`` ``fused_tick`` row pairs these predictions with measured walls per
    K — the predicted-vs-measured column of the round-8 acceptance
    criterion (per-tick overhead amortizing toward zero as K grows).
    """
    predicted = dispatch_floor_s + n_ticks * tick_seconds
    return {
        "n_ticks": int(n_ticks),
        "tick_us": round(tick_seconds * 1e6, 3),
        "dispatch_floor_us": round(dispatch_floor_s * 1e6, 3),
        "predicted_s": round(predicted, 9),
        "predicted_per_tick_s": round(predicted / n_ticks, 9),
        "predicted_overhead_per_tick_us": round(
            dispatch_floor_s / n_ticks * 1e6, 3
        ),
    }
