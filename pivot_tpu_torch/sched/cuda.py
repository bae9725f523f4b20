"""Device-backed placement policies: the ``device='cuda'`` policy variants.

Port of ``pivot_tpu/sched/tpu.py``.  Each policy wraps a placement pass
from :mod:`pivot_tpu_torch.ops`: per scheduling tick the runtime hands
over dense arrays (``TickContext``); the wrapper pads the task axis to a
bucket, stages the tick's operands on the device in ONE host→device copy,
runs the pass, and fetches the ``[T] int32`` placement vector back in one
device→host copy.  The ``[Z, Z]`` topology is staged once at bind time
(:class:`~pivot_tpu_torch.ops.kernels.DeviceTopology`).

The Cost-Aware arm's per-tick pass is the hand-written CUDA kernel
(``ops/cuda_kernels.py``) when the policy runs on ``cuda`` in float32
with the static bandwidth table and the reference score exponents — the
reference's Pallas auto rule (``sched/tpu.py:2100-2123``).  Every other
configuration, and the Opportunistic / First-Fit / Best-Fit arms, run
the two-phase torch forms of ``ops/kernels.py``.

Cross-backend parity: the policies consume the same Philox uniforms and
the same task pre-ordering as the numpy policies, so on the CPU in
float64 their placements are bit-identical to the numpy policies' and to
``pivot_tpu``'s device policies under x64; in float32 on the card,
near-boundary fits may round differently, and the acceptance criterion
is identical cost and makespan rankings.

Adaptive dispatch (``adaptive=True``) is the reference's online latency
router: twin cost = cells × per-cell EMA; device cost = probed round-trip
floor + cells × per-cell EMA; each tick goes to the side predicted
decisively faster, with symmetric exploration.  The device side's cell
count is the true ``T × H``: both the slim torch pass and the kernel stop
at the last valid task.  It is opt-in (the CLI's ``--adaptive``); by
default every tick goes to the device.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
``cuda`` without a card raises.

Fused spans (``place_span``, ``pivot_tpu/sched/tpu.py:980-1087``): when
the scheduler extracts a pure tick run, a span-capable policy serves the
whole window with ``ops.tickloop.fused_tick_run`` — one staging copy of
the span operands, the ticks on the device, one fetch of the ``[K, B]``
placements.  The Cost-Aware arm's span ticks launch the hand kernel
under the same auto rule as its per-tick ticks, counted apart
(``span_kernel_ticks``).  Declined spans fall back to the per-tick path,
bit-identically.

Not in this slice (ROADMAP.md, port queue): cross-run batching, host
sharding, the resident carry, the degrade guard, the fault gate and the
spot market — the methods that would attach them raise
``NotImplementedError``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from pivot_tpu_torch.ops.cuda_kernels import (
    cost_aware_cuda,
    cost_aware_cuda_batched,
)
from pivot_tpu_torch.ops.kernels import (
    DeviceTopology,
    best_fit_impl,
    cost_aware_impl,
    first_fit_impl,
    opportunistic_impl,
    resolve_device,
)
from pivot_tpu_torch.ops.tickloop import (
    fused_tick_run,
    span_bucket,
    span_step_bounds,
)
from pivot_tpu_torch.sched import Policy, TickContext
from pivot_tpu_torch.sched.policies import (
    BestFitPolicy,
    CostAwarePolicy,
    FirstFitPolicy,
    OpportunisticPolicy,
    _sort_decreasing,
    resolve_risk,
    resolve_root_anchor,
    resolve_weights,
)
from pivot_tpu_torch.sched.rand import tick_uniforms

__all__ = [
    "CudaOpportunisticPolicy",
    "CudaFirstFitPolicy",
    "CudaBestFitPolicy",
    "CudaCostAwarePolicy",
    "pad_bucket",
    "stage",
]

_BUCKETS = (8, 32, 128, 512, 2048, 8192)

_TORCH_DTYPE = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
}


def pad_bucket(n: int) -> int:
    """Smallest bucket ≥ n (``pivot_tpu/sched/tpu.py:121``)."""
    for b in _BUCKETS:
        if n <= b:
            return b
    return ((n + 8191) // 8192) * 8192


def stage(device: torch.device, **arrays) -> Dict[str, torch.Tensor]:
    """Stage named host arrays on ``device`` in ONE host→device copy:
    they are packed at 16-byte-aligned offsets into one byte buffer,
    copied, and viewed back as typed tensors of their own shapes.  A
    ``None`` stays ``None``.  On the CPU the views alias the (fresh) host
    buffer and nothing is copied."""
    given = {k: np.ascontiguousarray(a) for k, a in arrays.items()
             if a is not None}
    offsets, total = {}, 0
    for k, a in given.items():
        total = -(-total // 16) * 16
        offsets[k] = total
        total += a.nbytes
    buf = np.empty(total, dtype=np.uint8)
    for k, a in given.items():
        buf[offsets[k]:offsets[k] + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = torch.from_numpy(buf).to(device)
    out = dict.fromkeys(arrays)
    for k, a in given.items():
        o = offsets[k]
        out[k] = dev[o:o + a.nbytes].view(_TORCH_DTYPE[a.dtype]).view(a.shape)
    return out


def _probe_device_floor(device: torch.device) -> float:
    """The fixed per-call device latency: a trivial op on ``device`` plus
    the fetch of its result (the fetch is what waits for the device)."""
    x = torch.zeros(8, device=device)
    (x + 1.0).cpu()  # first touch outside the timed reps
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        (x + 1.0).cpu()
        best = min(best, time.perf_counter() - t0)
    return best


class _SpanOutcome:
    """A priced span: slot-indexed per-tick placements, host-fetched."""

    __slots__ = ("placements",)

    def __init__(self, placements: np.ndarray):
        self.placements = placements


class _DevicePolicyBase(Policy):
    """Shared bind/pad/stage/adaptive-dispatch machinery
    (``pivot_tpu/sched/tpu.py:334``)."""

    dtype = torch.float32

    #: Twin cost-model seed, s per task×host cell (refined online).
    _CELL_COST_SEED = 5e-8
    #: Only ticks of at least this many cells update the cell-cost EMAs.
    _CELL_COST_MIN_SAMPLE = 1 << 18
    #: The device serves only when predicted this many times faster.
    _DEVICE_ADVANTAGE = 2.0
    #: Device per-cell cost seed, s per cell (refined online).
    _DEVICE_CELL_COST_SEED = 1.5e-8
    #: Every Nth routed tick explores the other side.
    _EXPLORE_EVERY = 16
    #: Exploration only inside this factor of the crossover.
    _EXPLORE_MARGIN = 8.0

    def __init__(self, adaptive: bool = False, phase2="auto",
                 risk_weight: float = 0.0, rework_cost: float = 1.0,
                 weights=None, device="cuda"):
        self.device = resolve_device(device)
        self.topology: Optional[DeviceTopology] = None
        self._scheduler = None
        self.adaptive = adaptive
        self.weights = resolve_weights(weights, risk_weight, rework_cost)
        self.risk_weight = self.weights.risk_weight
        self.rework_cost = self.weights.rework_cost
        #: Phase-2 mode of the two-phase torch forms: "auto"/"slim" or
        #: "scan" (``ops/kernels.py``).
        self.phase2 = phase2
        self._cpu_twin: Optional[Policy] = None  # set by subclasses
        self._cpu_cell_cost = self._CELL_COST_SEED
        self._device_floor = 0.0
        self._device_cell_cost = self._DEVICE_CELL_COST_SEED
        self._device_routed = 0
        self._twin_routed = 0
        # Buckets whose first call (CUDA context, kernel build) has run:
        # a first call must not poison the per-cell EMA.
        self._warm_buckets: set = set()
        #: Ticks served by the device path / by the numpy twin / by the
        #: hand-written kernel, and span ticks launched on the hand kernel
        #: — what :meth:`dispatch_stats` reports.
        self.device_ticks = 0
        self.twin_ticks = 0
        self.kernel_ticks = 0
        self.span_kernel_ticks = 0

    @property
    def np_dtype(self):
        return np.float32 if self.dtype == torch.float32 else np.float64

    def apply_weights(self, weights) -> None:
        """Live weight promotion, forwarded to the numpy twin."""
        super().apply_weights(weights)
        if self._cpu_twin is not None:
            self._cpu_twin.apply_weights(self.weights)

    def bind(self, scheduler) -> None:
        if getattr(scheduler, "market", None) is not None:
            raise NotImplementedError(
                "the spot market is not ported to pivot_tpu_torch yet "
                "(ROADMAP.md, port queue: market and risk wiring)"
            )
        self._scheduler = scheduler
        self.topology = DeviceTopology.from_cluster(
            scheduler.cluster, self.dtype, self.device
        )
        if self._cpu_twin is not None:
            self._cpu_twin.bind(scheduler)
        if self.adaptive:
            self._device_floor = _probe_device_floor(self.device)

    def dispatch_stats(self) -> dict:
        """Where this policy's ticks were served."""
        return {"device_ticks": self.device_ticks,
                "twin_ticks": self.twin_ticks,
                "kernel_ticks": self.kernel_ticks,
                "span_kernel_ticks": self.span_kernel_ticks}

    # -- fused span tier (``pivot_tpu/sched/tpu.py:980-1087``) -------------
    #
    # ``place_span`` (a whole pure tick run as one device program) above
    # ``place`` (one tick per dispatch) above the adaptive numpy twin.  Any
    # declined span falls back to the per-tick path, bit-identically.

    #: Maximum ticks fused per span (the K axis of the tick driver).
    span_cap = 32

    def span_capable(self) -> bool:
        """Spans need deterministic device routing (no adaptive twin),
        span-constant inputs (no realtime bandwidth), and the tick-loop
        kernel family — forcing ``use_kernel=True`` opts out, as
        ``use_pallas=True`` does in the reference."""
        return not (
            self.adaptive
            or getattr(self, "realtime_bw", False)
            or getattr(self, "use_kernel", None) is True
        )

    def _span_kw(self, ctx: TickContext, plan, dem_host: np.ndarray,
                 B: int, K: int) -> Optional[dict]:
        """Policy-specific driver arguments (None declines the span):
        host arrays, staged with the span's other operands in one copy,
        and static values."""
        raise NotImplementedError

    def _span_market_kw(self, ctx: TickContext, plan, K: int) -> dict:
        """The span's market operands: none, since a scheduler with a
        market is refused at bind."""
        return {}

    def _span_norms(self, dem_host: np.ndarray, B: int) -> np.ndarray:
        """Demand norms padded to the slot bucket: the per-tick sort keys,
        computed in f64 and rounded once into the policy dtype."""
        norms = np.zeros(B, dtype=self.np_dtype)
        norms[: dem_host.shape[0]] = np.sqrt(
            np.sum(dem_host * dem_host, axis=1))
        return norms

    def place_span(self, ctx: TickContext, plan) -> Optional[_SpanOutcome]:
        """Serve a whole pure tick run as one device program: one staging
        copy of the span operands, :func:`fused_tick_run`, one fetch of
        the ``[K, B]`` slot-indexed placements (−1 unplaced).  Returns
        None to decline; the scheduler then serves the tick per-tick."""
        slots = plan.slots
        S = len(slots)
        B = pad_bucket(S)
        k_dyn = plan.n_ticks
        K = span_bucket(k_dyn)
        dem_host = np.stack([t.demand for t in slots])
        kw = self._span_kw(ctx, plan, dem_host, B, K)
        if kw is None:
            return None
        kw.update(self._span_market_kw(ctx, plan, K))
        dem = np.zeros((B, 4), dtype=self.np_dtype)
        dem[:S] = dem_host
        arrive = np.full(B, K, dtype=np.int32)
        arrive[:S] = plan.arrive
        host = {k: v for k, v in kw.items() if isinstance(v, np.ndarray)}
        st = stage(self.device, avail=np.asarray(ctx.avail, self.np_dtype),
                   dem=dem, arrive=arrive, live=self._live_np(ctx), **host)
        kw.update((k, st[k]) for k in host)
        res = fused_tick_run(
            st["avail"], st["dem"], st["arrive"], k_dyn, n_ticks=K,
            n_bound=span_step_bounds(plan.arrive, k_dyn), live=st["live"],
            **kw,
        )
        # One fetch: the placements are the span's whole host-visible
        # output (the scheduler's replay derives the meters from them).
        return _SpanOutcome(res.placements.cpu().numpy())

    # -- features of later slices ------------------------------------------
    def _not_ported(self, what: str):
        raise NotImplementedError(
            f"{what} is not ported to pivot_tpu_torch yet (ROADMAP.md, "
            "port queue)"
        )

    def enable_batching(self, client) -> None:
        self._not_ported("cross-run batching")

    def enable_sharding(self, mesh) -> None:
        self._not_ported("host sharding")

    def enable_resident(self, splice: bool = True) -> None:
        self._not_ported("the resident span carry")

    def enable_fault_gate(self, gate) -> None:
        self._not_ported("the elastic fault gate")

    def enable_profiler(self, profiler) -> None:
        self._not_ported("the sampled dispatch profiler")

    # -- per-tick operands ---------------------------------------------------
    def _live_np(self, ctx: TickContext):
        live = ctx.live_mask
        return None if live is None else np.asarray(live, dtype=bool)

    def _risk_np(self, ctx: TickContext):
        """The tick's [H] risk vector (``resolve_risk``, shared with the
        numpy twins) in the policy dtype, or None when disengaged."""
        risk = resolve_risk(ctx, self.risk_weight, self.rework_cost)
        return None if risk is None else np.asarray(risk, self.np_dtype)

    def _padded(self, ctx: TickContext, order: Optional[List[int]] = None):
        """Host ``(avail [H,4], demands [B,4], valid [B])`` in the policy
        dtype, the task axis padded to a bucket; ``order`` permutes the
        tasks.  Staged in the policy dtype: an f32 buffer would quantize
        f64 demands and break the f64 parity contract."""
        T = ctx.n_tasks
        B = pad_bucket(T)
        demands = ctx.demands if order is None else ctx.demands[order]
        dem = np.zeros((B, 4), dtype=self.np_dtype)
        dem[:T] = demands
        valid = np.zeros(B, dtype=bool)
        valid[:T] = True
        return np.asarray(ctx.avail, self.np_dtype), dem, valid

    @staticmethod
    def _unpad(placements, T: int,
               order: Optional[List[int]] = None) -> np.ndarray:
        """The first ``T`` placements, fetched in one device→host copy,
        returned in ctx task order."""
        out = placements[:T].cpu().numpy().astype(np.int64)
        if order is None:
            return out
        unscrambled = np.full(T, -1, dtype=np.int64)
        unscrambled[np.asarray(order)] = out
        return unscrambled

    # -- adaptive dispatch (``pivot_tpu/sched/tpu.py:1408-1500``) ----------
    def place(self, ctx: TickContext) -> np.ndarray:
        if not (self.adaptive and self._cpu_twin is not None):
            self.device_ticks += 1
            return self._device_place(ctx)
        cells = ctx.n_tasks * ctx.n_hosts
        bucket = pad_bucket(ctx.n_tasks)
        pred_twin = cells * self._cpu_cell_cost
        pred_device = self._device_floor + cells * self._device_cell_cost
        twin_predicted = pred_twin <= self._DEVICE_ADVANTAGE * pred_device
        big = cells >= self._CELL_COST_MIN_SAMPLE
        explore_twin = (
            not twin_predicted
            and big
            and pred_twin <= self._EXPLORE_MARGIN * self._device_floor
            and self._device_routed % self._EXPLORE_EVERY
            == self._EXPLORE_EVERY - 1
        )
        explore_device = (
            twin_predicted
            and big
            and bucket in self._warm_buckets
            and pred_device <= self._EXPLORE_MARGIN * pred_twin
            and self._twin_routed % self._EXPLORE_EVERY
            == self._EXPLORE_EVERY - 1
        )
        if (twin_predicted and not explore_device) or explore_twin:
            t0 = time.perf_counter()
            out = self._cpu_twin.place(ctx)
            dt = time.perf_counter() - t0
            if big:
                self._cpu_cell_cost = 0.5 * (self._cpu_cell_cost + dt / cells)
            if explore_twin:
                self._device_routed += 1
            else:
                self._twin_routed += 1
            self.twin_ticks += 1
            return out
        t0 = time.perf_counter()
        out = self._device_place(ctx)
        dt = time.perf_counter() - t0
        if big and bucket in self._warm_buckets:
            self._device_cell_cost = 0.5 * (
                self._device_cell_cost
                + max(dt - self._device_floor, 0.0) / cells
            )
        self._warm_buckets.add(bucket)
        if explore_device:
            self._twin_routed += 1
        else:
            self._device_routed += 1
        self.device_ticks += 1
        return out

    def _device_place(self, ctx: TickContext) -> np.ndarray:
        raise NotImplementedError

    def _mc_sensitivity(self, ctx, order, batched_place, n_replicas,
                        perturb, seed):
        """Monte-Carlo scaffolding of ``placement_sensitivity``
        (``pivot_tpu/sched/tpu.py:1529``): replica 0 carries the exact
        snapshot (its placements ARE the production decision), replicas
        1..R−1 draw ±``perturb`` multiplicative noise, and
        ``stability[t]`` is the fraction of replicas agreeing with the
        nominal host.  ``batched_place(avail_r, dem, valid, T)`` returns
        the ``[R, B]`` placements.  Returns ``(nominal [T], stability
        [T], placements [R, T])`` in ctx task order."""
        T = ctx.n_tasks
        avail, dem, valid = self._padded(ctx, order)
        rng = np.random.default_rng(seed)
        noise = rng.uniform(1 - perturb, 1 + perturb,
                            size=(n_replicas, avail.shape[0], 1))
        noise[0] = 1.0  # replica 0 = the production decision
        avail_r = (avail[None] * noise).astype(self.np_dtype)
        st = stage(self.device, avail_r=avail_r, dem=dem, valid=valid)
        p = batched_place(st["avail_r"], st["dem"], st["valid"], T)
        p = p.cpu().numpy()  # [R, B]
        placements = np.stack(
            [self._unpad(torch.from_numpy(row), T, order) for row in p]
        )
        nominal = placements[0]
        stability = (placements == nominal[None, :]).mean(axis=0)
        return nominal, stability, placements


class CudaOpportunisticPolicy(_DevicePolicyBase):
    """Uniformly random fitting host (``TpuOpportunisticPolicy``,
    ``pivot_tpu/sched/tpu.py:1562``)."""

    name = "opportunistic_cuda"

    def __init__(self, adaptive: bool = False, phase2="auto",
                 risk_weight: float = 0.0, rework_cost: float = 1.0,
                 weights=None, device="cuda"):
        super().__init__(adaptive, phase2, risk_weight, rework_cost, weights,
                         device)
        self._cpu_twin = OpportunisticPolicy(mode="numpy",
                                             weights=self.weights)

    def _span_kw(self, ctx, plan, dem_host, B, K):
        # [K, B] positional Philox rows: span tick k draws
        # ``tick_uniforms(seed, tick_seq + k, ·)`` like the per-tick path
        # (prefix property), rounded once into the policy dtype.
        seed = ctx.scheduler.seed or 0
        u = np.zeros((K, B), dtype=self.np_dtype)
        for k in range(plan.n_ticks):
            u[k] = tick_uniforms(seed, ctx.tick_seq + k, B)
        return dict(policy="opportunistic", uniforms=u, phase2=self.phase2)

    def _device_place(self, ctx: TickContext) -> np.ndarray:
        T = ctx.n_tasks
        avail, dem, valid = self._padded(ctx)
        u = np.zeros(valid.shape[0], dtype=self.np_dtype)
        u[:T] = tick_uniforms(ctx.scheduler.seed or 0, ctx.tick_seq, T)
        st = stage(self.device, avail=avail, dem=dem, valid=valid, u=u,
                   live=self._live_np(ctx), risk=self._risk_np(ctx))
        placements, _ = opportunistic_impl(
            st["avail"], st["dem"], st["valid"], st["u"], phase2=self.phase2,
            live=st["live"], risk=st["risk"],
        )
        return self._unpad(placements, T)


class CudaFirstFitPolicy(_DevicePolicyBase):
    """Lowest-index fitting host, optionally over demand-decreasing task
    order — the VBP arm (``TpuFirstFitPolicy``,
    ``pivot_tpu/sched/tpu.py:1604``)."""

    name = "first_fit_cuda"

    def __init__(self, decreasing: bool = False, adaptive: bool = False,
                 phase2="auto", risk_weight: float = 0.0,
                 rework_cost: float = 1.0, weights=None, device="cuda"):
        super().__init__(adaptive, phase2, risk_weight, rework_cost, weights,
                         device)
        self.decreasing = decreasing
        self._cpu_twin = FirstFitPolicy(decreasing=decreasing, mode="numpy",
                                        weights=self.weights)

    def _span_kw(self, ctx, plan, dem_host, B, K):
        return dict(
            policy="first-fit", strict=False, decreasing=self.decreasing,
            sort_norm=(self._span_norms(dem_host, B) if self.decreasing
                       else None),
            totals=self.topology.totals, phase2=self.phase2,
        )

    def _order(self, ctx: TickContext):
        if not self.decreasing:
            return None
        order = _sort_decreasing(ctx.demands, list(range(ctx.n_tasks)))
        ctx.visit_order = order  # ref returns the sorted list (vbp.py:17)
        return order

    def _device_place(self, ctx: TickContext) -> np.ndarray:
        order = self._order(ctx)
        avail, dem, valid = self._padded(ctx, order)
        st = stage(self.device, avail=avail, dem=dem, valid=valid,
                   live=self._live_np(ctx), risk=self._risk_np(ctx))
        placements, _ = first_fit_impl(
            st["avail"], st["dem"], st["valid"], strict=False,
            totals=self.topology.totals, phase2=self.phase2,
            live=st["live"], risk=st["risk"],
        )
        return self._unpad(placements, ctx.n_tasks, order)


class CudaBestFitPolicy(_DevicePolicyBase):
    """Min residual-L2 host among strict fits (``TpuBestFitPolicy``,
    ``pivot_tpu/sched/tpu.py:1670``)."""

    name = "best_fit_cuda"

    def __init__(self, decreasing: bool = False, adaptive: bool = False,
                 phase2="auto", risk_weight: float = 0.0,
                 rework_cost: float = 1.0, weights=None, device="cuda"):
        super().__init__(adaptive, phase2, risk_weight, rework_cost, weights,
                         device)
        self.decreasing = decreasing
        self._cpu_twin = BestFitPolicy(decreasing=decreasing, mode="numpy",
                                       weights=self.weights)

    def _span_kw(self, ctx, plan, dem_host, B, K):
        return dict(
            policy="best-fit", decreasing=self.decreasing,
            sort_norm=(self._span_norms(dem_host, B) if self.decreasing
                       else None),
            totals=self.topology.totals, phase2=self.phase2,
        )

    _order = CudaFirstFitPolicy._order

    def _device_place(self, ctx: TickContext) -> np.ndarray:
        order = self._order(ctx)
        avail, dem, valid = self._padded(ctx, order)
        st = stage(self.device, avail=avail, dem=dem, valid=valid,
                   live=self._live_np(ctx), risk=self._risk_np(ctx))
        placements, _ = best_fit_impl(
            st["avail"], st["dem"], st["valid"], totals=self.topology.totals,
            phase2=self.phase2, live=st["live"], risk=st["risk"],
        )
        return self._unpad(placements, ctx.n_tasks, order)


class CudaCostAwarePolicy(_DevicePolicyBase):
    """Cost-aware (PIVOT) placement on the device
    (``TpuCostAwarePolicy``, ``pivot_tpu/sched/tpu.py:1733``).

    Anchor grouping stays on the host (it walks the DAG, memoized per
    task group — ``CostAwarePolicy.group_tasks``); the O(T × H) pass runs
    on the device: the hand-written kernel (``use_kernel``) or the
    two-phase torch form."""

    name = "cost_aware_cuda"

    def __init__(self, bin_pack: str = "first-fit", sort_tasks: bool = False,
                 sort_hosts: bool = False, host_decay: bool = False,
                 realtime_bw: bool = False, use_kernel: Optional[bool] = None,
                 adaptive: bool = False, phase2="auto",
                 risk_weight: float = 0.0, rework_cost: float = 1.0,
                 weights=None, device="cuda"):
        super().__init__(adaptive, phase2, risk_weight, rework_cost, weights,
                         device)
        if bin_pack not in ("first-fit", "best-fit"):
            raise ValueError(f"bin_pack must be 'first-fit' or 'best-fit', "
                             f"got {bin_pack!r}")
        #: Learned score exponents (w_cost, w_bw, w_norm), or None at the
        #: reference (1, 1, 1) shape.
        self._score_exp = self.weights.score_exponents()
        if self._score_exp is not None and realtime_bw:
            raise ValueError(
                "learned score exponents pow the static phase-1 bandwidth "
                "table; realtime_bw rows bypass that table — score with the "
                "static topology (realtime_bw=False) or the reference "
                "exponents"
            )
        if use_kernel and self._score_exp is not None:
            raise ValueError(
                "the greedy_place kernel scores with the reference exponent "
                "shape — learned w_cost/w_bw/w_norm are served by the "
                "two-phase torch form; drop use_kernel=True"
            )
        if use_kernel and realtime_bw:
            raise ValueError(
                "realtime_bw is served by the two-phase torch form only — "
                "the greedy_place kernel has no live-bandwidth input; drop "
                "use_kernel=True"
            )
        self.bin_pack = bin_pack
        self.sort_tasks = sort_tasks
        self.sort_hosts = sort_hosts
        self.host_decay = host_decay
        self.realtime_bw = realtime_bw
        #: True: always the hand-written kernel (f32 only); False: always
        #: the torch form; None: the kernel on ``cuda`` in float32 without
        #: realtime bandwidth or learned exponents.
        self.use_kernel = use_kernel
        # Grouping logic shared verbatim with the numpy policy, which also
        # serves as the adaptive twin and the realtime-bandwidth sampler.
        self._grouper = CostAwarePolicy(
            bin_pack=bin_pack, sort_tasks=sort_tasks, sort_hosts=sort_hosts,
            host_decay=host_decay, realtime_bw=realtime_bw,
            weights=self.weights,
        )
        self._cpu_twin = self._grouper

    def apply_weights(self, weights) -> None:
        """Live promotion, rejecting learned exponents where the scoring
        path has no exponent input (the kernel, realtime bandwidth)."""
        from pivot_tpu_torch.search.weights import PolicyWeights

        w = (weights if isinstance(weights, PolicyWeights)
             else PolicyWeights.from_array(weights)).validate()
        exps = w.score_exponents()
        if exps is not None and self.realtime_bw:
            raise ValueError("cannot promote learned score exponents onto a "
                             "realtime_bw policy")
        if exps is not None and self.use_kernel:
            raise ValueError("cannot promote learned score exponents onto a "
                             "greedy_place-kernel policy")
        super().apply_weights(w)
        self._score_exp = exps

    def _kernel_serves(self) -> bool:
        """The reference's auto rule, with ``cuda`` for the TPU backend."""
        if self.use_kernel is not None:
            if self.use_kernel and self.dtype != torch.float32:
                raise ValueError("the greedy_place kernel is float32 only; "
                                 "drop use_kernel=True for a float64 policy")
            return self.use_kernel
        return (self.device.type == "cuda" and self.dtype == torch.float32
                and not self.realtime_bw and self._score_exp is None)

    # The two calls into the hand-written kernel.
    def _greedy(self, *args, **kw):
        return cost_aware_cuda(*args, **kw)

    def _greedy_batched(self, *args, **kw):
        return cost_aware_cuda_batched(*args, **kw)

    def _span_greedy(self, *args, **kw):
        """A span tick served by the hand kernel."""
        self.span_kernel_ticks += 1
        return self._greedy(*args, **kw)

    def _span_kw(self, ctx, plan, dem_host, B, K):
        if self.realtime_bw:
            return None  # live route-queue samples are per-tick host state
        # Per-slot anchor identity and zone: anchors are span-constant, so
        # one grouping walk covers every tick; fused_tick_run re-derives each
        # tick's first-seen bucket order from its own batch order.
        span_ctx = TickContext(ctx.scheduler, list(plan.slots), ctx.tick_seq)
        storage = ctx.cluster.storage
        az = np.zeros(B, dtype=np.int32)
        bucket = np.zeros(B, dtype=np.int32)
        groups = self._grouper.group_tasks(span_ctx)
        for bi, (anchor, idxs) in enumerate(groups.items()):
            if not hasattr(anchor, "locality"):  # root group → keyed storage
                anchor = storage[resolve_root_anchor(span_ctx, anchor,
                                                     len(storage))]
            az[idxs] = ctx.meta.zone_index[anchor.locality]
            bucket[idxs] = bi
        topo = self.topology
        kw = dict(
            policy="cost-aware", bin_pack=self.bin_pack,
            sort_tasks=self.sort_tasks, sort_hosts=self.sort_hosts,
            host_decay=self.host_decay,
            sort_norm=(self._span_norms(dem_host, B) if self.sort_tasks
                       else None),
            anchor_zone=az, bucket_id=bucket, cost_zz=topo.cost,
            bw_zz=topo.bw, host_zone=topo.host_zone,
            base_task_counts=np.asarray(ctx.host_task_counts, np.int32),
            totals=topo.totals, phase2=self.phase2,
        )
        if self._kernel_serves():
            kw["greedy"] = self._span_greedy
        elif self._score_exp is not None:
            kw["score_exp"] = np.asarray(self._score_exp, self.np_dtype)
        return kw

    def _anchor_stream(self, ctx: TickContext):
        """The per-task anchor stream ``(order, az [B] i32, ng [B] bool,
        group_rows, row_idx)``: grouping walked on the host exactly like
        the numpy twin, tasks laid out bucket-major
        (``pivot_tpu/sched/tpu.py:1967``)."""
        T = ctx.n_tasks
        meta = ctx.meta
        storage = ctx.cluster.storage
        order: List[int] = []
        anchor_zone, new_group = [], []
        group_rows = [] if self.realtime_bw else None
        row_idx = [] if self.realtime_bw else None
        for anchor, idxs in self._grouper.group_tasks(ctx).items():
            if not hasattr(anchor, "locality"):  # root group → keyed storage
                anchor = storage[resolve_root_anchor(ctx, anchor,
                                                     len(storage))]
            if self.sort_tasks:
                idxs = _sort_decreasing(ctx.demands, idxs)
            az = meta.zone_index[anchor.locality]
            if group_rows is not None:
                _, bw_rt = self._grouper._roundtrip_vectors(ctx, anchor)
                group_rows.append(bw_rt)
            for j, i in enumerate(idxs):
                order.append(i)
                anchor_zone.append(az)
                new_group.append(j == 0)
                if row_idx is not None:
                    row_idx.append(len(group_rows) - 1)
        B = pad_bucket(T)
        az_arr = np.zeros(B, dtype=np.int32)
        az_arr[:T] = anchor_zone
        ng_arr = np.zeros(B, dtype=bool)
        ng_arr[:T] = new_group
        return order, az_arr, ng_arr, group_rows, row_idx

    def _device_place(self, ctx: TickContext) -> np.ndarray:
        T = ctx.n_tasks
        order, az_arr, ng_arr, group_rows, row_idx = self._anchor_stream(ctx)
        avail, dem, valid = self._padded(ctx, order)
        counts = np.asarray(ctx.host_task_counts, dtype=np.int32)
        rows = idx = None
        if group_rows is not None:
            # One [H] row per anchor group + a per-task row index, the
            # group axis padded to a bucket (``sched/tpu.py:2125-2138``).
            G = pad_bucket(max(len(group_rows), 1))
            rows = np.ones((G, ctx.n_hosts), dtype=self.np_dtype)
            if group_rows:
                rows[: len(group_rows)] = np.stack(group_rows)
            idx = np.zeros(az_arr.shape[0], dtype=np.int32)
            idx[:T] = row_idx
        score_exp = (None if self._score_exp is None
                     else np.asarray(self._score_exp, self.np_dtype))
        st = stage(self.device, avail=avail, dem=dem, valid=valid, ng=ng_arr,
                   az=az_arr, counts=counts, live=self._live_np(ctx),
                   risk=self._risk_np(ctx), rows=rows, idx=idx,
                   score_exp=score_exp)
        topo = self.topology
        args = (st["avail"], st["dem"], st["valid"], st["ng"], st["az"],
                topo.cost, topo.bw, topo.host_zone, st["counts"])
        mode = dict(bin_pack=self.bin_pack, sort_hosts=self.sort_hosts,
                    host_decay=self.host_decay, live=st["live"],
                    risk=st["risk"])
        if self._kernel_serves():
            placements, _ = self._greedy(*args, **mode, n_eff=T)
            self.kernel_ticks += 1
        else:
            placements, _ = cost_aware_impl(
                *args, **mode, rt_bw_rows=st["rows"], rt_bw_idx=st["idx"],
                totals=topo.totals, phase2=self.phase2,
                score_exp=st["score_exp"],
            )
        return self._unpad(placements, T, order)

    def placement_sensitivity(self, ctx: TickContext, n_replicas: int = 256,
                              perturb: float = 0.05, seed: int = 0):
        """Monte-Carlo robustness of THIS tick's placement decision
        (``pivot_tpu/sched/tpu.py:2010``): ``n_replicas`` perturbed
        availability snapshots share the tick's task stream — one launch
        of the replica-batched kernel when the kernel serves this policy,
        else one torch pass per replica.  Returns ``(nominal [T],
        stability [T], placements [R, T])``."""
        if self.realtime_bw:
            raise ValueError(
                "placement_sensitivity scores on the static topology tables "
                "(the greedy_place kernel has no live-bandwidth input)"
            )
        if self.topology is None:
            raise RuntimeError("bind() the policy to a scheduler first")
        order, az_arr, ng_arr, _gr, _ri = self._anchor_stream(ctx)
        counts = np.asarray(ctx.host_task_counts, dtype=np.int32)
        score_exp = (None if self._score_exp is None
                     else np.asarray(self._score_exp, self.np_dtype))
        st = stage(self.device, ng=ng_arr, az=az_arr, counts=counts,
                   risk=self._risk_np(ctx), score_exp=score_exp)
        topo = self.topology
        mode = dict(bin_pack=self.bin_pack, sort_hosts=self.sort_hosts,
                    host_decay=self.host_decay, risk=st["risk"])

        def batched(avail_r, dem, valid, T):
            args = (dem, valid, st["ng"], st["az"], topo.cost, topo.bw,
                    topo.host_zone, st["counts"])
            if self._kernel_serves():
                return self._greedy_batched(avail_r, *args, **mode,
                                            n_eff=T)[0]
            return torch.stack([
                cost_aware_impl(a, *args, **mode,
                                score_exp=st["score_exp"])[0]
                for a in avail_r
            ])

        return self._mc_sensitivity(ctx, order, batched, n_replicas,
                                    perturb, seed)
