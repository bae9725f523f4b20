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
reference's Pallas auto rule (``sched/tpu.py:2100-2123``).  The
Opportunistic / First-Fit / Best-Fit arms' pass is the second hand
kernel, ``carry_free_place`` (``opportunistic_cuda`` / ``first_fit_cuda``
/ ``best_fit_cuda``, and the R-replica forms for ``placement_
sensitivity``), under the static rule :meth:`_DevicePolicyBase.
_carry_free_serves`: ``cuda``, float32, no mesh, no batch client, and
``phase2`` of ``"auto"`` or ``"slim"`` — the reference's device program
for those arms is its slim XLA loop.  Every other configuration runs the
two-phase torch forms of ``ops/kernels.py``.  A kernel that fails to
build or launch raises: no torch form stands in for it.

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
placements.  Each arm's span ticks launch its hand kernel under the
same rule as its per-tick ticks (``greedy=`` for Cost-Aware,
``carry_free=`` for the other three), counted apart
(``span_kernel_ticks``).  Declined spans fall back to the per-tick path,
bit-identically.

Spot market (``infra/market.py``, ``pivot_tpu/sched/tpu.py:869-931``):
when the scheduler carries a :class:`MarketSchedule`, every policy gets
the tick's ``[H]`` risk vector (``risk_weight`` set) and the Cost-Aware
arm scores with the market's price-scaled ``[Z, Z]`` cost slice, staged
once per segment; a span gets ``[K, H]`` risk rows and, for Cost-Aware,
the ``[P, Z, Z]`` cost stack (staged once per market) with the span's
``[K]`` segment row on the host.

Replica-batched sensitivity (``placement_sensitivity``, every arm but
Opportunistic): one shared task stream × R perturbed availability
snapshots, the Cost-Aware arm on one launch of the batched kernel, the
First-Fit / Best-Fit arms on one launch of ``carry_free_place``'s
R-replica form where the rule holds, else the batched torch passes of
``ops/kernels.py``.

Cross-run batching (``enable_batching``, ``pivot_tpu/sched/tpu.py:534``):
with a :class:`~pivot_tpu_torch.sched.batch.BatchClient` attached, a
tick's operands stay host numpy and its kernel call goes through the
batcher (``_call_kernel``), which coalesces co-pending ticks of the
lock-step grid's runs or the serving sessions into one flush.  The
Cost-Aware kernel call is dispatched as the module-level
``cost_aware_cuda`` with its step bound ``n_eff`` a per-row array, so
that every run's tick shares one key and a coalesced flush is one
per-row launch of ``greedy_place``.  A span goes through the batcher
too (``pivot_tpu/sched/tpu.py:1074-1082``), its operands host numpy and
its Cost-Aware ``greedy`` the module-level ``cost_aware_cuda``: a
coalesced span flush is one per-row launch per span tick.

Resident span carries (``enable_resident``,
``pivot_tpu/sched/tpu.py:1091-1390``): the span carry — availability,
task counts, live mask — stays on the device from span to span
(``ops.tickloop.resident_span_run``); each span ships the rows where the
DES truth differs from the pending carry (a mirror-diff: one fetch of
the carry), its slot operands and, under a market, a [K] segment row
into a once-staged [P, H] risk table.  With ``splice=True`` a clone of
each span-entry carry lets a mid-span arrival join the running span
(``span_splice``).

Graceful degradation (``degrade_after=N``,
``pivot_tpu/sched/tpu.py:143-232``): after N consecutive device-kernel
failures a policy serves from its numpy twin; every
``_DegradeGuard.PROBE_EVERY`` twin decisions a half-open probe
shadow-runs the device and promotes it back on an exact placement match.
A probe never changes a placement.  ``None`` (the default) keeps a
kernel failure fatal: batch experiments must not mask a broken kernel
as twin output.  The guard is accepted only on a policy whose torch
device is the CPU: a kernel failure on the card never moves the card's
work to the CPU twin, so a ``cuda`` policy refuses ``degrade_after``
with ``NotImplementedError``.

Sampled dispatch profiling (``enable_profiler``,
``pivot_tpu_torch/obs/profiler.py``): a deterministic 1-in-N sample of
the policy's direct dispatches — per-tick kernels through
``_call_kernel``, fused spans, resident spans — is timed to completion.
Batched dispatches are timed at the batcher's flush instead.

Host sharding (``enable_sharding``, ``pivot_tpu/sched/tpu.py:594-647``):
with a host-axis mesh (``parallel/mesh.py``) every placement dispatch —
the per-tick passes and the fused spans — runs through the 1-D sharded
forms of ``ops/shard.py`` on the ``[S, H/S]`` host blocks, bit-identical
to the unsharded forms.  A Cost-Aware policy with a mesh runs the
sharded torch pass and never launches ``greedy_place`` (the reference's
Pallas exclusion, ``:2115-2125``); it runs on the policy's device or
fails.  Refused with the adaptive twin, ``use_kernel=True``,
``realtime_bw`` and learned score exponents.  It composes, in either
order, with the batcher (``pivot_tpu/sched/tpu.py:534-592``): the
batcher must carry a 2-D ``replica × host`` mesh whose host axis matches
the policy's, and the policy's dispatches go through it as the
unsharded forms, which the batcher's 2-D mesh resolves to their
``[G]``-batched twins (a lone request to its 1-D twin).  It composes
with the resident tier (``pivot_tpu/sched/tpu.py:1091-1300``): the span
carry lives host-sharded (``ops/shard.py::sharded_resident_span_run``),
its splice checkpoints too.

Elastic meshes (``reshard``, ``enable_fault_gate``,
``pivot_tpu/sched/tpu.py:649-767``): ``reshard(mesh)`` swaps a sharded
policy onto another rung of the elastic ladder mid-serve, or back to
the unsharded layout with ``None``.  Where the true host count does not
divide the new shard count, every staged ``[H]`` operand is padded to
the elastic extent with dead-sentinel rows (``ops/shard.py``'s elastic
helpers: ``DEAD_AVAIL`` availability, a False live mask, zero counts,
risk and zone), which no pass can select, so placements equal an
unpadded run's.  A pending resident carry is folded onto the new layout
(``elastic_fold_carry``); the splice checkpoint, the span staging and
the staged risk table are dropped.  ``enable_fault_gate(gate)`` installs
a callable ``gate(env_now)`` that runs at the top of every ``place`` and
``place_span``: the elastic manager's gate (``serve/elastic.py``) raises
:class:`~pivot_tpu_torch.infra.faults.DeviceLostError` when a fault
window covers a shard of the policy's mesh.  That error passes through
the degrade guard to the serving supervisor, which shrinks the pool's
mesh and requeues; no twin serves it.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from pivot_tpu_torch.infra.faults import DeviceLostError
from pivot_tpu_torch.ops.cuda_kernels import (
    best_fit_cuda,
    best_fit_cuda_batched,
    cost_aware_cuda,
    cost_aware_cuda_batched,
    first_fit_cuda,
    first_fit_cuda_batched,
    load_carry_free_library,
    load_library,
    opportunistic_cuda,
)
from pivot_tpu_torch.ops.kernels import (
    DeviceTopology,
    best_fit_batched,
    best_fit_impl,
    cost_aware_impl,
    first_fit_batched,
    first_fit_impl,
    opportunistic_impl,
    resolve_device,
)
from pivot_tpu_torch.ops.shard import (
    DEAD_AVAIL,
    HOST_AXIS,
    REPLICA_AXIS,
    best_fit_kernel_sharded,
    cost_aware_kernel_sharded,
    elastic_fold_carry,
    elastic_host_extent,
    elastic_pad_rows,
    first_fit_kernel_sharded,
    mesh_device,
    opportunistic_kernel_sharded,
    sharded_fused_tick_run,
    sharded_resident_carry_init,
    sharded_resident_span_run,
)
from pivot_tpu_torch.ops.tickloop import (
    SPAN_HOST_OPERANDS,
    edit_bucket,
    fused_tick_run,
    resident_carry_clone,
    resident_carry_init,
    resident_span_run,
    span_bucket,
    span_step_bounds,
)
from pivot_tpu_torch.parallel.mesh import host_axis_size
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

# graftcheck: ignore[dtype] -- the staging table's dtype map; a float64 policy is the CPU parity path
_TORCH_DTYPE = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
}
_NP_OF = {t: n for n, t in _TORCH_DTYPE.items()}


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
    dev = torch.from_numpy(buf).to(device)  # graftcheck: ignore[dtype] -- a uint8 byte buffer; each view below takes its array's own dtype
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
        t0 = time.perf_counter()  # graftcheck: ignore[determinism] -- latency probe seeding the adaptive cost model; the route is placement-neutral (twin parity)
        (x + 1.0).cpu()
        best = min(best, time.perf_counter() - t0)  # graftcheck: ignore[determinism] -- same probe window
    return best


def _dispatch_shape(args, kw) -> dict:
    """Shape labels of one kernel dispatch for the profiler's device
    spans and prediction (``pivot_tpu/sched/tpu.py:300``): H from the
    [H, 4] availability operand, B from the padded batch, K from a fused
    span's static tick count."""
    shape = {}
    if args and hasattr(args[0], "shape") and len(args[0].shape) == 2:
        shape["h"] = int(args[0].shape[0])
    if len(args) > 1 and hasattr(args[1], "shape") and args[1].shape:
        shape["b"] = int(args[1].shape[0])
    n_ticks = kw.get("n_ticks")
    if isinstance(n_ticks, (int, np.integer)):
        shape["k"] = int(n_ticks)
    return shape


def _nbytes(*arrays) -> int:
    """Bytes of the host arrays among ``arrays`` (what a staging copy
    moves to the device)."""
    return sum(int(a.nbytes) for a in arrays if isinstance(a, np.ndarray))


class _SpanOutcome:
    """A priced span: slot-indexed per-tick placements, host-fetched."""

    __slots__ = ("placements",)

    def __init__(self, placements: np.ndarray):
        self.placements = placements


class _DegradeGuard:
    """Graceful-degradation state machine: closed → degraded → half-open
    (``pivot_tpu/sched/tpu.py:143-232``).

    *Closed*: the device kernel serves; ``after`` CONSECUTIVE failures
    trip the guard to *degraded* (any success resets the streak;
    individual failures are served by the numpy twin per tick).
    *Degraded*: the twin serves every decision.  Every ``probe_every``
    twin-served decisions the guard goes *half-open* for one decision:
    the device kernel is shadow-run and its placements diffed against
    the twin's.  The decision is served by the TWIN either way — a probe
    can never change a placement — and an exact match promotes the
    device back to closed; a mismatch or a raise keeps the twin serving
    and restarts the probe countdown.  ``probe_every=None`` makes the
    fallback permanent.

    ``after=None`` disables the guard entirely — kernel exceptions stay
    fatal (the batch-experiment default)."""

    #: Twin-served decisions between half-open probes.
    PROBE_EVERY = 64

    __slots__ = ("after", "probe_every", "degraded", "kernel_failures",
                 "consecutive", "since_probe", "probes", "promotions")

    def __init__(self, after: Optional[int],
                 probe_every: Optional[int] = PROBE_EVERY):
        self.after = after
        self.probe_every = probe_every
        self.degraded = False
        self.kernel_failures = 0
        self.consecutive = 0
        self.since_probe = 0
        self.probes = 0
        self.promotions = 0

    def note_success(self) -> None:
        self.consecutive = 0

    def note_failure(self, exc: BaseException, logger) -> None:
        self.kernel_failures += 1
        self.consecutive += 1
        if self.consecutive >= self.after:
            self.degraded = True
            self.since_probe = 0
            logger.error(
                "device kernel failed %d times consecutively — degrading "
                "to the numpy twin%s: %s",
                self.consecutive,
                (" permanently" if self.probe_every is None
                 else f" (half-open probe every {self.probe_every})"),
                exc,
            )
        else:
            logger.warning(
                "device kernel failed (%d/%d before degradation): %s",
                self.consecutive, self.after, exc,
            )

    def should_probe(self) -> bool:
        """Call once per degraded (twin-served) decision; True on the
        decision that should shadow-run the device kernel."""
        if not self.degraded or self.probe_every is None:
            return False
        self.since_probe += 1
        if self.since_probe >= self.probe_every:
            self.since_probe = 0
            return True
        return False

    def note_probe(self, ok: bool, logger,
                   exc: Optional[BaseException] = None) -> None:
        self.probes += 1
        if ok:
            self.degraded = False
            self.consecutive = 0
            self.promotions += 1
            logger.info(
                "half-open probe matched the numpy twin — promoting the "
                "device kernel back (probe %d)", self.probes,
            )
        elif exc is not None:
            logger.warning(
                "half-open probe raised — device still down: %s", exc,
            )
        else:
            logger.warning(
                "half-open probe DIVERGED from the numpy twin — keeping "
                "the twin (probe %d)", self.probes,
            )


class _ResidentState:
    """The resident span tier's bookkeeping
    (``pivot_tpu/sched/tpu.py:239-262``): the pending carry, the splice
    checkpoint and the span's host operands, the once-staged risk table,
    and the counts ``dispatch_stats`` reports.  Reset at bind."""

    __slots__ = ("splice", "carry", "checkpoint", "staging",
                 "risk_table_np", "risk_table_dev", "spans", "splices",
                 "edit_rows", "d2h_bytes")

    def __init__(self, splice: bool):
        self.splice = splice
        self.reset()

    def reset(self) -> None:
        self.carry = None
        self.checkpoint = None
        self.staging = None
        self.risk_table_np = None
        self.risk_table_dev = None
        self.spans = 0
        self.splices = 0
        self.edit_rows = 0
        self.d2h_bytes = 0


class _SplicePlan:
    """A span plan with a splice's extended slot set."""

    __slots__ = ("slots", "arrive", "n_ticks", "grid")

    def __init__(self, slots, arrive, n_ticks, grid):
        self.slots = slots
        self.arrive = arrive
        self.n_ticks = n_ticks
        self.grid = grid


def _fetch_carry(carry) -> tuple:
    """The carry's three buffers on the host in one device→host copy:
    ``(avail, counts, live, bytes fetched)``."""
    parts = [t.reshape(-1).view(torch.uint8) for t in carry]
    host = torch.cat(parts).cpu().numpy()
    out, o = [], 0
    for t, p in zip(carry, parts):
        n = p.numel()
        out.append(host[o:o + n].view(_NP_OF[t.dtype]).reshape(t.shape))
        o += n
    return (*out, int(host.nbytes))


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
                 weights=None, device="cuda",
                 degrade_after: Optional[int] = None):
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
        #: arm's hand-written kernel, and span ticks launched on it — what
        #: :meth:`dispatch_stats` reports.
        self.device_ticks = 0
        self.twin_ticks = 0
        self.kernel_ticks = 0
        self.span_kernel_ticks = 0
        # Market operands on the device: the [Z, Z] cost slice per
        # segment and the [P, Z, Z] stack, reset at bind.
        self._market_cost_dev: Dict[int, torch.Tensor] = {}
        self._market_stack_dev: Optional[torch.Tensor] = None
        #: The cross-run batcher's client, when attached; then the host
        #: copy of the topology the flushes stage (fetched once a bind).
        self._batch_client = None
        self._topology_host: Optional[DeviceTopology] = None
        #: The resident span tier, when enabled (``enable_resident``).
        self._resident: Optional[_ResidentState] = None
        #: The host-sharding mesh, when enabled (``enable_sharding``):
        #: every placement dispatch runs host-sharded over its host axis.
        self._mesh = None
        #: The elastic pad extent (``reshard``): every staged [H] operand
        #: is padded to it with dead-sentinel rows; None when unsharded
        #: or when the host count divides the mesh.  Then the zone row
        #: padded once a reshard (``_host_zone_arg``).
        self._host_extent: Optional[int] = None
        self._padded_host_zone = None
        #: The elastic fault gate (``enable_fault_gate``): a callable
        #: ``gate(env_now)`` run at the top of every ``place`` /
        #: ``place_span``; None costs nothing.
        self._fault_gate = None
        #: Graceful degradation (module docstring): after
        #: ``degrade_after`` CONSECUTIVE device-kernel failures the
        #: policy serves from its numpy twin, probing the device back
        #: half-open; individual failures are served by the twin too and
        #: counted in ``kernel_failures``.  ``None`` (default) keeps
        #: kernel exceptions fatal; only a CPU-device policy accepts it.
        self._degrade = _DegradeGuard(self._guard_allowed(degrade_after))
        #: The sampled dispatch profiler, when attached
        #: (``enable_profiler``); consulted on the direct dispatch path
        #: only (batched dispatches are timed at the batcher's flush).
        self._profiler = None

    # -- degrade-guard views (``pivot_tpu/sched/tpu.py:466-499``) ----------
    @property
    def degrade_after(self) -> Optional[int]:
        return self._degrade.after

    @degrade_after.setter
    def degrade_after(self, value: Optional[int]) -> None:
        self._degrade.after = self._guard_allowed(value)

    def _guard_allowed(self, value: Optional[int]) -> Optional[int]:
        """``value`` if this policy may run the guard: always for
        ``None``; otherwise only when its torch device is the CPU, where
        the twin's plain decision stands in for a plain torch pass on a
        CPU tensor.  On the card a kernel failure must reach the caller:
        moving the card's work to the CPU twin would hide it."""
        if value is not None and self.device.type != "cpu":
            raise NotImplementedError(
                f"degrade_after={value!r} on a {self.device.type} policy: "
                "the port never moves a card policy's work to the CPU "
                "twin when its kernel fails; the guard runs only on a "
                "policy whose torch device is the CPU")
        return value

    @property
    def degraded(self) -> bool:
        return self._degrade.degraded

    @property
    def kernel_failures(self) -> int:
        return self._degrade.kernel_failures

    @property
    def np_dtype(self):
        return np.float32 if self.dtype == torch.float32 else np.float64  # graftcheck: ignore[dtype] -- the policy's own dtype: float64 policies are the CPU parity path

    def apply_weights(self, weights) -> None:
        """Live weight promotion, forwarded to the numpy twin."""
        super().apply_weights(weights)
        if self._cpu_twin is not None:
            self._cpu_twin.apply_weights(self.weights)

    def bind(self, scheduler) -> None:
        self._scheduler = scheduler
        self._market_cost_dev = {}  # a rebind may bring another market
        self._market_stack_dev = None
        self._topology_host = None
        if self._resident is not None:
            self._resident.reset()  # a new cluster: a new [H] layout
        self.topology = DeviceTopology.from_cluster(
            scheduler.cluster, self.dtype, self.device
        )
        self._padded_host_zone = None  # padded from the new topology
        if self._mesh is not None:
            if self._host_extent is not None:
                # A resharded (padded) policy re-derives its extent for
                # the new host count: pad rows are inert either way.
                self._refresh_host_extent()
            else:
                self._check_mesh_hosts(self._mesh)  # rebind: re-validate
        if self._cpu_twin is not None:
            self._cpu_twin.bind(scheduler)
        if self.adaptive:
            self._device_floor = _probe_device_floor(self.device)

    def dispatch_stats(self) -> dict:
        """Where this policy's ticks were served; with the resident tier
        on, also its ``spans``, ``splices``, ``edit_rows`` (the
        reference's names) and the mirror-diff's fetched ``d2h_bytes``."""
        out = {"device_ticks": self.device_ticks,
               "twin_ticks": self.twin_ticks,
               "kernel_ticks": self.kernel_ticks,
               "span_kernel_ticks": self.span_kernel_ticks}
        rs = self._resident
        if rs is not None:
            out["resident"] = {"spans": rs.spans, "splices": rs.splices,
                               "edit_rows": rs.edit_rows,
                               "d2h_bytes": rs.d2h_bytes}
        return out

    # -- fused span tier (``pivot_tpu/sched/tpu.py:980-1087``) -------------
    #
    # ``place_span`` (a whole pure tick run as one device program) above
    # ``place`` (one tick per dispatch) above the adaptive numpy twin.  Any
    # declined span falls back to the per-tick path, bit-identically.

    #: Maximum ticks fused per span (the K axis of the tick driver).
    span_cap = 32

    def span_capable(self) -> bool:
        """Spans need deterministic device routing (no adaptive twin), a
        healthy kernel (not degraded), span-constant inputs (no realtime
        bandwidth), and the tick-loop kernel family — forcing
        ``use_kernel=True`` opts out, as ``use_pallas=True`` does in the
        reference."""
        return not (
            self.adaptive
            or self.degraded
            or getattr(self, "realtime_bw", False)
            or getattr(self, "use_kernel", None) is True
        )

    def _span_kw(self, ctx: TickContext, plan, dem_host: np.ndarray,
                 B: int, K: int) -> Optional[dict]:
        """Policy-specific driver arguments (None declines the span):
        host arrays, staged with the span's other operands in one copy,
        and static values."""
        raise NotImplementedError

    def _span_market_kw(self, ctx: TickContext, plan, K: int,
                        risk: bool = True) -> dict:
        """The span's market operands (``pivot_tpu/sched/tpu.py:898``):
        ``risk_rows`` [K, H], the per-tick risk over the span's exact
        grid instants (the values ``resolve_risk`` feeds the per-tick
        path), built in the policy dtype so the f64 products round once.
        Empty without a market, or with ``risk=False`` (the resident
        tier gathers its rows on the device)."""
        market = getattr(ctx.scheduler, "market", None)
        if market is None or not self.risk_weight or not risk:
            return {}
        hz = ctx.host_zones
        k_dyn = plan.n_ticks
        # Pad columns (the elastic extent) stay zero: their hosts are
        # dead sentinels.
        rows = np.zeros((K, self._host_extent or len(hz)),
                        dtype=self.np_dtype)
        seg = market.segment_indices(np.asarray(plan.grid[:k_dyn]))
        rows[:k_dyn, :len(hz)] = (self.risk_weight * self.rework_cost
                                  * market.hazard[seg][:, hz])
        return {"risk_rows": rows} if rows.any() else {}

    def _span_norms(self, dem_host: np.ndarray, B: int) -> np.ndarray:
        """Demand norms padded to the slot bucket: the per-tick sort keys,
        computed in f64 and rounded once into the policy dtype."""
        norms = np.zeros(B, dtype=self.np_dtype)
        norms[: dem_host.shape[0]] = np.sqrt(
            np.sum(dem_host * dem_host, axis=1))
        return norms

    def _span_operands(self, dem_host: np.ndarray, arrive, S: int, B: int,
                       K: int):
        """The span's ``[B, 4]`` demands and ``[B]`` arrival ticks, pad
        slots arriving at the bucket ``K`` (past any horizon)."""
        dem = np.zeros((B, 4), dtype=self.np_dtype)
        dem[:S] = dem_host
        arr = np.full(B, K, dtype=np.int32)
        arr[:S] = arrive
        return dem, arr

    def place_span(self, ctx: TickContext, plan) -> Optional[_SpanOutcome]:
        """Serve a whole pure tick run as one device program: one staging
        copy of the span operands, :func:`fused_tick_run`, one fetch of
        the ``[K, B]`` slot-indexed placements (−1 unplaced).  Through
        the batcher when a client is attached (co-pending spans of G runs
        coalesce, ``sched/batch.py``), on the resident carry when the
        resident tier is on.  Returns None to decline; the scheduler then
        serves the tick per-tick."""
        if self._fault_gate is not None:
            self._fault_gate(ctx.env_now)
        if self._resident is not None:
            return self._place_span_resident(ctx, plan)
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
        dem, arrive = self._span_operands(dem_host, plan.arrive, S, B, K)
        avail = self._pad_avail_np(ctx.avail)
        if self._batch_client is not None:
            if kw.get("greedy") is not None:
                # The module-level call: one key for every run's span.
                kw["greedy"] = cost_aware_cuda
                self.span_kernel_ticks += k_dyn
            res = self._call_kernel(fused_tick_run, avail, dem, arrive,
                                    np.int32(k_dyn), n_ticks=K,
                                    live=self._live_np(ctx), **kw)
            return _SpanOutcome(np.asarray(res.placements))
        host = {k: v for k, v in kw.items()
                if isinstance(v, np.ndarray) and k not in SPAN_HOST_OPERANDS}
        st = stage(self.device, avail=avail, dem=dem, arrive=arrive,
                   live=self._live_np(ctx), **host)
        kw.update((k, st[k]) for k in host)
        if self._mesh is not None:
            # The host-sharded span driver: the [S, H/S] carry stays in
            # its blocks between ticks (``pivot_tpu/sched/tpu.py:1069``).
            res = sharded_fused_tick_run(
                self._mesh, st["avail"], st["dem"], st["arrive"], k_dyn,
                n_ticks=K, n_bound=span_step_bounds(plan.arrive, k_dyn),
                live=st["live"], **kw,
            )
            return _SpanOutcome(res.placements.cpu().numpy())
        res = self._profiled(
            "fused_tick_run",
            lambda: fused_tick_run(
                st["avail"], st["dem"], st["arrive"], k_dyn, n_ticks=K,
                n_bound=span_step_bounds(plan.arrive, k_dyn),
                live=st["live"], **kw,
            ),
            lambda: (dict(h=avail.shape[0], b=B, k=K),
                     _nbytes(avail, dem, arrive, self._live_np(ctx),
                             *host.values())),
        )
        # One fetch: the placements are the span's whole host-visible
        # output (the scheduler's replay derives the meters from them).
        return _SpanOutcome(res.placements.cpu().numpy())

    # -- resident span tier (``pivot_tpu/sched/tpu.py:1091-1390``) ---------
    def enable_resident(self, splice: bool = True) -> None:
        """Keep the span carry on the device between consecutive
        ``place_span`` calls (module docstring); ``splice=True`` keeps a
        clone of each span-entry carry for :meth:`span_splice`.  Composes
        with :meth:`enable_sharding` (the carry lives host-sharded).
        Refused with the adaptive twin, with ``realtime_bw``, with the
        batcher attached (a flush re-stages every operand from host
        numpy), and with ``use_kernel=True``, which opts out of spans as
        ``use_pallas=True`` does in the reference."""
        if self.adaptive:
            raise ValueError(
                "resident span carries need deterministic dispatch — "
                "construct the policy with adaptive=False"
            )
        if getattr(self, "use_kernel", None) is True:
            raise ValueError(
                "use_kernel=True opts out of the span tier, and so of its "
                "resident form; drop use_kernel=True"
            )
        if getattr(self, "realtime_bw", False):
            raise ValueError(
                "realtime_bw samples per-tick host state — there is no "
                "resident form to carry it in"
            )
        if self._batch_client is not None:
            raise ValueError(
                "resident span carries cannot ride the cross-run batcher "
                "(it re-stages every operand at the flush boundary) — "
                "detach the batcher first"
            )
        self._resident = _ResidentState(bool(splice))

    def _resident_risk_kw(self, ctx: TickContext, plan, K: int) -> dict:
        """The resident form of the span's risk rows: the [P, H]
        per-segment table (hazard × risk_weight × rework_cost, rounded
        once into the policy dtype, as the re-staged rows are) staged
        once per bind, and this span's [K] segment row; the device
        gathers ``table[seg[k]]``.  Empty when the span's rows are all
        calm, as the re-staged arm's ``rows.any()``."""
        market = getattr(ctx.scheduler, "market", None)
        if market is None or not self.risk_weight:
            return {}
        rs = self._resident
        if rs.risk_table_np is None:
            hz = ctx.host_zones
            table = np.zeros((market.hazard.shape[0], len(hz)),
                             dtype=self.np_dtype)
            table[:] = (self.risk_weight * self.rework_cost
                        * market.hazard[:, hz])
            rs.risk_table_np = table
        k_dyn = plan.n_ticks
        seg = np.zeros(K, dtype=np.int32)
        seg[:k_dyn] = market.segment_indices(np.asarray(plan.grid[:k_dyn]))
        if not rs.risk_table_np[seg[:k_dyn]].any():
            return {}
        if rs.risk_table_dev is None:
            # Padded on its host axis under the elastic extent.
            rs.risk_table_dev = torch.tensor(
                self._pad_tail(rs.risk_table_np), device=self.device)
        return {"risk_table": rs.risk_table_dev, "risk_seg": seg}

    def _resident_dispatch(self, carry, dem, arrive, k_dyn: int, K: int,
                           run_kw: dict):
        """One resident span (the reference's seam of the same name,
        ``pivot_tpu/sched/tpu.py:1288-1300``): the host operands of
        ``run_kw`` staged with ``dem`` / ``arrive`` in one copy, then
        :func:`resident_span_run`, or with a mesh its host-sharded twin
        (``ops/shard.py::sharded_resident_span_run``).  ``carry`` is
        consumed."""
        host = {k: v for k, v in run_kw.items()
                if isinstance(v, np.ndarray) and k not in SPAN_HOST_OPERANDS}
        st = stage(self.device, dem=dem, arrive=arrive, **host)
        kw = dict(run_kw)
        kw.update((k, st[k]) for k in host)
        run = (resident_span_run if self._mesh is None
               else functools.partial(sharded_resident_span_run, self._mesh))
        return self._profiled(
            "resident_span_run",
            lambda: run(
                carry, st["dem"], st["arrive"], k_dyn, n_ticks=K,
                n_bound=span_step_bounds(arrive, k_dyn), **kw),
            lambda: (dict(h=carry.avail.shape[0], b=dem.shape[0], k=K),
                     _nbytes(dem, arrive, *host.values())),
        )

    def _place_span_resident(self, ctx: TickContext, plan):
        """The resident tier's ``place_span``: mirror-diff → edit rows →
        one span on the carry (``pivot_tpu/sched/tpu.py:1172-1286``),
        host-sharded with a mesh (the carry keeps its flat ``[H]``
        layout, so the mirror-diff and the splice checkpoints are the
        unsharded path's)."""
        rs = self._resident
        slots = plan.slots
        S = len(slots)
        B = pad_bucket(S)
        k_dyn = plan.n_ticks
        K = span_bucket(k_dyn)
        dem_host = np.stack([t.demand for t in slots])
        kw = self._span_kw(ctx, plan, dem_host, B, K)
        if kw is None:
            return None
        kw.pop("base_task_counts", None)  # carried on the device
        kw.update(self._span_market_kw(ctx, plan, K, risk=False))
        kw.update(self._resident_risk_kw(ctx, plan, K))
        host_avail = np.asarray(ctx.avail, self.np_dtype)
        H = host_avail.shape[0]
        host_counts = np.asarray(ctx.host_task_counts, np.int32)
        lm = ctx.live_mask
        host_live = np.ones(H, bool) if lm is None else np.asarray(lm, bool)
        if self._host_extent is not None:
            # The elastic pad layout: the mirror, the carry, the edit
            # rows' drop sentinel and the geometry check live at the
            # padded extent; pad rows never diff (their truth is fixed).
            H = self._host_extent
            host_avail = elastic_pad_rows(host_avail, H, DEAD_AVAIL)
            host_counts = elastic_pad_rows(host_counts, H, 0)
            host_live = elastic_pad_rows(host_live, H, False)
        carry = rs.carry
        if carry is not None and carry.avail.shape[0] != H:
            carry = None  # the cluster's geometry changed: re-stage
        edits: dict = {}
        if carry is None:
            # The one full [H] staging the resident path pays.
            carry = (resident_carry_init(host_avail, host_counts, host_live,
                                         device=self.device)
                     if self._mesh is None else sharded_resident_carry_init(
                         self._mesh, host_avail, host_counts, host_live))
        else:
            # Mirror-diff: the DES truth against the pending carry, exact.
            # The span's own placements were folded in on the device, so
            # a steady state diffs empty; completions, quarantine flips
            # and aborted span replays become repair rows.
            d_avail, d_counts, d_live, nbytes = _fetch_carry(carry)
            rs.d2h_bytes += nbytes
            diff = ((d_avail != host_avail).any(axis=1)
                    | (d_counts != host_counts) | (d_live != host_live))
            rows = np.nonzero(diff)[0].astype(np.int32)
            if rows.size:
                n = int(rows.size)
                E = edit_bucket(n)
                edits = dict(
                    edit_idx=np.full(E, H, np.int32),
                    edit_avail=np.zeros((E, 4), self.np_dtype),
                    edit_counts=np.zeros(E, np.int32),
                    edit_live=np.ones(E, bool),
                )
                edits["edit_idx"][:n] = rows
                edits["edit_avail"][:n] = host_avail[rows]
                edits["edit_counts"][:n] = host_counts[rows]
                edits["edit_live"][:n] = host_live[rows]
                rs.edit_rows += n
        dem, arrive = self._span_operands(dem_host, plan.arrive, S, B, K)
        ckpt = resident_carry_clone(carry) if rs.splice else None
        res, rs.carry = self._resident_dispatch(carry, dem, arrive, k_dyn,
                                                K, {**kw, **edits})
        rs.checkpoint = ckpt
        rs.spans += 1
        rs.staging = (
            dict(S=S, B=B, K=K, k_dyn=k_dyn, dem_host=dem_host,
                 arrive0=np.asarray(plan.arrive, np.int32), kw=kw,
                 edits=edits)
            if rs.splice else None
        )
        # One fetch, as the re-staged arm.
        return _SpanOutcome(res.placements.cpu().numpy())

    def span_splice(self, ctx: TickContext, plan, k: int, new_tasks):
        """Join ``new_tasks`` into the running span at tick ``k``
        (``pivot_tpu/sched/tpu.py:1313-1391``): the whole span re-runs
        from a clone of the span-entry carry with the new slots arriving
        at ``k``; ticks ``[0, k)`` of the re-run must equal the committed
        placements (checked) before it is adopted.  Returns the spliced
        ``[K, B]`` placements, or None to decline — the committed span
        and the pending carry stay as they were.  ``ctx`` is the
        span-start context (``plan.ctx``)."""
        rs = self._resident
        if (rs is None or not rs.splice or rs.checkpoint is None
                or rs.staging is None):
            return None
        st = rs.staging
        S0, B, K, k_dyn = st["S"], st["B"], st["K"], st["k_dyn"]
        n_new = len(new_tasks)
        if n_new == 0 or S0 + n_new > B or not 0 < k < k_dyn:
            return None
        S1 = S0 + n_new
        dem_host = np.concatenate(
            [st["dem_host"], np.stack([t.demand for t in new_tasks])])
        arrive0 = np.concatenate(
            [st["arrive0"], np.full(n_new, k, np.int32)]).astype(np.int32)
        proxy = _SplicePlan(tuple(plan.slots) + tuple(new_tasks), arrive0,
                            k_dyn, plan.grid)
        kw = self._span_kw(ctx, proxy, dem_host, B, K)
        if kw is None:
            return None
        kw.pop("base_task_counts", None)
        for key in ("risk_table", "risk_seg", "cost_stack", "cost_seg"):
            if key in st["kw"]:
                kw[key] = st["kw"][key]
        dem, arrive = self._span_operands(dem_host, arrive0, S1, B, K)
        res, new_carry = self._resident_dispatch(
            resident_carry_clone(rs.checkpoint), dem, arrive, k_dyn, K,
            {**kw, **st["edits"]})
        pl = res.placements.cpu().numpy()
        if not np.array_equal(pl[:k], plan.outcome.placements[:k]):
            # The extended slot set moved a committed tick (a grouping
            # walk reordered an old bucket): keep the committed span; the
            # arrival waits for the span's end.
            return None
        rs.carry = new_carry
        rs.splices += 1
        st.update(S=S1, dem_host=dem_host, arrive0=arrive0, kw=kw)
        return pl

    # -- cross-run batching (``pivot_tpu/sched/tpu.py:534-592``) ------------
    def enable_batching(self, client) -> None:
        """Attach a :class:`~pivot_tpu_torch.sched.batch.BatchClient`: the
        per-tick kernel calls block at the tick boundary and coalesce with
        the other sessions' co-pending ticks (``sched/batch.py``).
        Requires deterministic routing: the adaptive twin routes on
        measured latencies, which would make batch membership
        timing-dependent (``pivot_tpu/sched/tpu.py:534-566``).  Beside
        :meth:`enable_sharding` the batcher must carry a matching 2-D
        mesh (``_check_batch_mesh``)."""
        if self.adaptive:
            raise ValueError(
                "cross-run batching needs deterministic dispatch — "
                "construct the policy with adaptive=False"
            )
        if self._resident is not None:
            raise ValueError(
                "resident span carries cannot ride the cross-run batcher "
                "— it re-stages every operand from host numpy at the "
                "flush boundary, the staging the resident tier removes; "
                "drop enable_resident() or the batcher"
            )
        if self._mesh is not None:
            self._check_batch_mesh(client)
        self._batch_client = client

    def _check_batch_mesh(self, client, mesh=None) -> None:
        """Batching × sharding needs a batcher on a 2-D ``replica ×
        host`` mesh whose host axis matches this policy's, so the
        coalesced 2-D program and a lone request's 1-D twin partition
        the same ``[H]`` layout (``pivot_tpu/sched/tpu.py:568-592``).
        ``mesh``: the policy's host mesh (default: the one enabled)."""
        bmesh = getattr(client, "mesh", None)
        n = host_axis_size(mesh or self._mesh)
        if (bmesh is None or HOST_AXIS not in bmesh.shape
                # No replica axis: nothing to stack the [G] run axis over.
                or REPLICA_AXIS not in bmesh.shape
                or host_axis_size(bmesh) != n):
            raise ValueError(
                "composing host sharding with cross-run batching needs "
                "a DispatchBatcher built on a 2-D replica x host mesh "
                f"whose host axis matches enable_sharding's ({n} "
                "shards) — build one with parallel.mesh."
                "build_hybrid_mesh(host_parallel=...) and pass it as "
                "DispatchBatcher(mesh=...)"
            )

    def prepare(self) -> None:
        """Initialise CUDA on this policy's device now, on the calling
        thread (the serving driver calls it before any session thread
        dispatches), and build and load ``carry_free_place`` when it
        serves this policy.  A no-op on the CPU."""
        if self.device.type == "cuda":
            torch.cuda.init()
            torch.zeros(1, device=self.device)
            if self._carry_free_serves():
                load_carry_free_library()

    #: The arm of ``carry_free_place`` this policy's pass is, or None
    #: (Cost-Aware: ``greedy_place``).
    _carry_free_arm: Optional[str] = None

    def _carry_free_serves(self) -> bool:
        """The static rule for ``carry_free_place`` (modelled on
        :meth:`CudaCostAwarePolicy._kernel_serves`): a carry-free arm on
        ``cuda`` in float32 (the kernel is float32 only), with no mesh
        (no sharded form yet), no batch client (a coalesced flush runs its
        G rows through the torch forms) and ``phase2`` of ``"auto"`` or
        ``"slim"`` (the kernel is the slim pass; a chunk size or
        ``"scan"`` asks for another algorithm)."""
        return (self._carry_free_arm is not None
                and self.device.type == "cuda"
                and self.dtype == torch.float32
                and self._mesh is None and self._batch_client is None
                and isinstance(self.phase2, str)
                and self.phase2 in ("auto", "slim"))

    def _carry_free(self, *args, **kw):
        """One launch of the arm's ``carry_free_place`` wrapper."""
        raise NotImplementedError

    def _span_carry_free(self, *args, **kw):
        """A span tick served by ``carry_free_place``."""
        self.span_kernel_ticks += 1
        return self._carry_free(*args, **kw)

    # -- host sharding (``pivot_tpu/sched/tpu.py:594-647``) -----------------
    def enable_sharding(self, mesh) -> None:
        """Run every placement dispatch host-sharded over ``mesh``'s
        ``host`` axis (``ops/shard.py``): the per-tick passes and the
        fused spans on the ``[S, H/S]`` host blocks, the argmin a
        two-stage reduce — placements bit-identical to the unsharded
        forms.  ``mesh`` must place its shards on this policy's device
        (logical shards: ``host_sharded_mesh(devices=[device] * S)``).

        Refused with the adaptive twin (its latency model prices the
        unsharded pass), ``use_kernel=True`` and ``realtime_bw`` (no
        sharded form).  Composes with :meth:`enable_batching` when the
        batcher carries a matching 2-D mesh, and with
        :meth:`enable_resident` (the carry lives host-sharded)."""
        if self.adaptive:
            raise ValueError(
                "host sharding needs deterministic dispatch — construct "
                "the policy with adaptive=False"
            )
        if getattr(self, "use_kernel", None) is True:
            raise ValueError(
                "the greedy_place kernel keeps the whole tick in one "
                "block — it has no sharded form; drop use_kernel=True"
            )
        if getattr(self, "realtime_bw", False):
            raise ValueError(
                "realtime_bw has no sharded form (per-tick sampled "
                "[G, H] rows would reshard every dispatch)"
            )
        if host_axis_size(mesh) < 1:
            raise ValueError("mesh has an empty host axis")
        if self._batch_client is not None:
            self._check_batch_mesh(self._batch_client, mesh)
        mesh_device(mesh, self.device)
        if self.topology is not None:
            self._check_mesh_hosts(mesh)
        self._mesh = mesh

    def _check_mesh_hosts(self, mesh) -> None:
        H = self.topology.n_hosts
        n = host_axis_size(mesh)
        if H % n:
            raise ValueError(
                f"cluster has H={H} hosts, not divisible over the "
                f"mesh's {n} host shards — pad the cluster to a "
                f"multiple of {n} hosts"
            )

    def _kernel_for(self, kernel, sharded_kernel):
        """The dispatch rung for one placement call
        (``pivot_tpu/sched/tpu.py:771-783``): the unsharded form through
        the batcher when one is attached (on a sharded policy the
        batcher's 2-D mesh resolves it to its twin), the host-sharded
        twin when only a mesh is enabled, else the unsharded form."""
        if self._batch_client is not None:
            return functools.partial(self._call_kernel, kernel)
        if self._mesh is not None:
            return functools.partial(sharded_kernel, self._mesh)
        return functools.partial(self._call_kernel, kernel)

    # -- elastic meshes (``pivot_tpu/sched/tpu.py:649-767``) ----------------
    def reshard(self, mesh) -> None:
        """Swap the host-sharding mesh for another shape mid-serve — the
        shrink / regrow step of elastic serving (``serve/elastic.py``).
        ``mesh`` is a rung of the elastic ladder, or None for the
        unsharded layout.  Where the true host count does not divide the
        new shard count, the staged [H] operands pad to the elastic extent
        with inert dead-sentinel rows.  A pending resident carry is folded
        onto the new layout (``ops/shard.py::elastic_fold_carry``, equal
        on the true host rows); the splice checkpoint cannot cross a
        reshard and is dropped, and the next mirror-diff repairs any
        divergence from the DES truth.  Refused with the adaptive twin,
        with the batcher attached (its 2-D mesh is fixed), and onto a
        mesh with ``use_kernel=True`` or ``realtime_bw`` (no sharded
        form) or an empty host axis; the mesh must place its shards on
        this policy's device, as in :meth:`enable_sharding`."""
        if self.adaptive:
            raise ValueError(
                "elastic resharding needs deterministic dispatch — "
                "construct the policy with adaptive=False"
            )
        if self._batch_client is not None:
            raise ValueError(
                "elastic resharding does not compose with the cross-run "
                "batcher (its 2-D mesh is fixed at construction) — "
                "detach the batcher first"
            )
        if mesh is not None:
            if getattr(self, "use_kernel", None) is True:
                raise ValueError(
                    "the greedy_place kernel has no sharded form; drop "
                    "use_kernel=True"
                )
            if getattr(self, "realtime_bw", False):
                raise ValueError(
                    "realtime_bw has no sharded form (per-tick sampled "
                    "rows would reshard every dispatch)"
                )
            if host_axis_size(mesh) < 1:
                raise ValueError("mesh has an empty host axis")
            mesh_device(mesh, self.device)
        self._mesh = mesh
        self._padded_host_zone = None
        self._refresh_host_extent()
        rs = self._resident
        if rs is not None:
            if rs.carry is not None and self.topology is not None:
                rs.carry = elastic_fold_carry(
                    rs.carry, self.topology.n_hosts, mesh)
            rs.checkpoint = None
            rs.staging = None
            rs.risk_table_dev = None  # re-staged (padded) on the next span

    def enable_fault_gate(self, gate) -> None:
        """Install (or clear, ``None``) the elastic fault gate: a callable
        ``gate(env_now)`` run at the top of every ``place`` /
        ``place_span``.  The elastic manager's gate raises
        :class:`DeviceLostError` when a device-fault window covers the
        dispatch instant; the error passes through the degrade guard to
        the serving supervisor (``serve/elastic.py``)."""
        self._fault_gate = gate

    def _refresh_host_extent(self) -> None:
        """The elastic pad extent of the current (mesh, topology) pair:
        None when unsharded, unbound, or when the host count divides the
        mesh (no padding)."""
        if self._mesh is None or self.topology is None:
            self._host_extent = None
            return
        H = self.topology.n_hosts
        extent = elastic_host_extent(H, host_axis_size(self._mesh))
        self._host_extent = None if extent == H else extent

    def _pad_avail_np(self, avail) -> np.ndarray:
        """``[H, 4]`` availability in the policy dtype, padded to the
        elastic extent with :data:`DEAD_AVAIL` rows."""
        avail = np.asarray(avail, self.np_dtype)
        if self._host_extent is None:
            return avail
        return elastic_pad_rows(avail, self._host_extent, DEAD_AVAIL)

    def _pad_h(self, arr, fill):
        """An ``[H]`` host vector padded to the elastic extent with
        ``fill``."""
        if self._host_extent is None:
            return arr
        return elastic_pad_rows(arr, self._host_extent, fill)

    def _pad_tail(self, arr):
        """An ``[..., H]`` array zero-padded on its trailing axis to the
        elastic extent (the risk table's layout)."""
        if self._host_extent is None:
            return arr
        pad = self._host_extent - arr.shape[-1]
        if pad <= 0:
            return arr
        widths = [(0, 0)] * (arr.ndim - 1) + [(0, pad)]
        return np.pad(arr, widths, constant_values=0)

    def _host_zone_arg(self, topo):
        """The ``[H]`` host→zone row of a dispatch: the bind-time row, or
        under the elastic extent a copy padded with zone 0 (a dead
        sentinel is never selected), made once a reshard — on the device
        with no host read, or in numpy for the batcher's host copy."""
        if self._host_extent is None:
            return topo.host_zone
        if self._padded_host_zone is None:
            hz = topo.host_zone
            if torch.is_tensor(hz):
                self._padded_host_zone = torch.cat(
                    [hz, hz.new_zeros(self._host_extent - hz.shape[0])])
            else:
                self._padded_host_zone = elastic_pad_rows(
                    hz, self._host_extent, 0)
        return self._padded_host_zone

    # -- sampled dispatch profiling (``pivot_tpu/sched/tpu.py:786``) -------
    def enable_profiler(self, profiler) -> None:
        """Attach a :class:`pivot_tpu_torch.obs.DispatchProfiler`: a
        deterministic 1-in-N sample of this policy's direct device
        dispatches (per-tick kernels through :meth:`_call_kernel`, fused
        and resident spans) is timed to completion and published as
        per-family latency summaries and ``device``-lane trace spans.
        Placements are untouched; ``None`` detaches.  With the batcher
        attached the flush boundary owns the timing instead
        (``DispatchBatcher(profiler=...)``)."""
        self._profiler = profiler

    def _profiled(self, family: str, thunk, meta):
        """``thunk()``, through the profiler when one is attached;
        ``meta()`` gives the dispatch's ``(shape, h2d_bytes)`` and runs
        only then, so a run without a profiler pays nothing for it."""
        prof = self._profiler
        if prof is None or not prof.enabled:
            return thunk()
        shape, h2d_bytes = meta()
        return prof.profile(family, thunk, shape=shape, h2d_bytes=h2d_bytes,
                            device=self.device)

    # -- kernel-call indirection (``pivot_tpu/sched/tpu.py:798-838``) ------
    def _call_kernel(self, kernel, *args, **kw):
        """Direct when unbatched, through the batcher when a client is
        attached: array keywords batch with the positional arrays, plain
        keywords stay static (a ``None`` operand is static too, so ticks
        with and without a live mask or risk row fall into different
        groups).  A direct call goes through the profiler when one is
        attached, under the kernel's family (``obs.profiler.family_of``):
        the profiler owns the clock and the sampling decision."""
        if self._batch_client is None:
            if self._profiler is None:
                return kernel(*args, **kw)
            from pivot_tpu_torch.obs.profiler import family_of

            return self._profiled(family_of(kernel),
                                  lambda: kernel(*args, **kw),
                                  lambda: (_dispatch_shape(args, kw), 0))
        arr_kw = {k: v for k, v in kw.items() if hasattr(v, "shape")}
        static_kw = {k: v for k, v in kw.items() if k not in arr_kw}
        return self._batch_client.dispatch(kernel, args, arr_kw, static_kw)

    def _stage(self, **arrays) -> dict:
        """A tick's host operands: on the device in one copy when
        unbatched; left on the host when batched — the batcher stacks the
        flush's rows and stages them in one copy."""
        if self._batch_client is not None:
            return arrays
        return stage(self.device, **arrays)

    def _staged_topology(self) -> DeviceTopology:
        """The topology operands of a tick: the bind-time device tensors,
        or their host copy (fetched once a bind) when batched."""
        if self._batch_client is None:
            return self.topology
        if self._topology_host is None:
            self._topology_host = DeviceTopology(
                *(t.cpu().numpy() for t in self.topology))
        return self._topology_host

    # -- per-tick operands ---------------------------------------------------
    def _live_np(self, ctx: TickContext):
        """The tick's ``[H]`` quarantine mask, or None when every host is
        live.  Under the elastic extent it is always made: None would
        mean "all live" and take in the dead-sentinel pad rows."""
        live = ctx.live_mask
        if self._host_extent is not None:
            full = np.zeros(self._host_extent, dtype=bool)
            full[: ctx.n_hosts] = (True if live is None
                                   else np.asarray(live, bool))
            return full
        return None if live is None else np.asarray(live, dtype=bool)

    def _market_cost_arg(self, ctx: TickContext) -> torch.Tensor:
        """The tick's ``[Z, Z]`` egress-cost operand
        (``pivot_tpu/sched/tpu.py:880``): the bind-time table without a
        market, else the market's price-scaled slice for this tick's
        segment — computed in f64 on the host, rounded once into the
        policy dtype and staged once per segment (kept on the host when
        batched)."""
        market = getattr(ctx.scheduler, "market", None)
        if market is None:
            return self._staged_topology().cost
        seg = market.segment(ctx.env_now)
        buf = self._market_cost_dev.get(seg)
        if buf is None:
            buf = np.asarray(market.cost_matrix_at(ctx.env_now, ctx.meta),
                             self.np_dtype)
            if self._batch_client is None:
                buf = torch.tensor(buf, device=self.device)
            self._market_cost_dev[seg] = buf
        return buf

    def _risk_np(self, ctx: TickContext):
        """The tick's [H] risk vector (``resolve_risk``, shared with the
        numpy twins) in the policy dtype, or None when disengaged."""
        risk = resolve_risk(ctx, self.risk_weight, self.rework_cost)
        return (None if risk is None
                else self._pad_h(np.asarray(risk, self.np_dtype), 0.0))

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
        return self._pad_avail_np(ctx.avail), dem, valid

    @staticmethod
    def _unpad(placements, T: int,
               order: Optional[List[int]] = None) -> np.ndarray:
        """The first ``T`` placements, fetched in one device→host copy
        (already on the host from a batched flush), returned in ctx task
        order."""
        if torch.is_tensor(placements):
            placements = placements[:T].cpu().numpy()
        out = np.asarray(placements[:T]).astype(np.int64)
        if order is None:
            return out
        unscrambled = np.full(T, -1, dtype=np.int64)
        unscrambled[np.asarray(order)] = out
        return unscrambled

    # -- adaptive dispatch (``pivot_tpu/sched/tpu.py:1408-1500``) ----------
    def place(self, ctx: TickContext) -> np.ndarray:
        if self._fault_gate is not None:
            self._fault_gate(ctx.env_now)
        if self.degraded and self._cpu_twin is not None:
            self.twin_ticks += 1
            return self._degraded_place(ctx)
        if not (self.adaptive and self._cpu_twin is not None):
            return self._guarded_device_place(ctx)
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
            t0 = time.perf_counter()  # graftcheck: ignore[determinism] -- adaptive-routing EMA sample; which side serves a tick is timing-dependent by design, placements are route-invariant (twin parity)
            out = self._cpu_twin.place(ctx)
            dt = time.perf_counter() - t0  # graftcheck: ignore[determinism] -- same EMA sample window
            if big:
                self._cpu_cell_cost = 0.5 * (self._cpu_cell_cost + dt / cells)
            if explore_twin:
                self._device_routed += 1
            else:
                self._twin_routed += 1
            self.twin_ticks += 1
            return out
        t0 = time.perf_counter()  # graftcheck: ignore[determinism] -- adaptive-routing EMA sample (device side); see the twin side above
        if self.degrade_after is not None:
            try:
                out = self._device_place(ctx)
            except DeviceLostError:
                raise  # mesh loss is the elastic supervisor's
            except Exception as exc:  # noqa: BLE001 — degradation guard
                # Twin fallback; no EMA update (the sample measures
                # neither side's healthy cost).
                self._note_kernel_failure(exc)
                self.twin_ticks += 1
                return self._cpu_twin.place(ctx)
            self._degrade.note_success()
        else:
            out = self._device_place(ctx)
        dt = time.perf_counter() - t0  # graftcheck: ignore[determinism] -- same EMA sample window (device side)
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

    # -- graceful degradation (``pivot_tpu/sched/tpu.py:933-977``) ---------
    def _note_kernel_failure(self, exc: BaseException) -> None:
        self._degrade.note_failure(exc, self.logger)

    def _degraded_place(self, ctx: TickContext) -> np.ndarray:
        """A twin-served decision while degraded, with the half-open
        probe: on the probe cadence the device kernel is SHADOW-run and
        its placements diffed against the twin's — an exact match
        promotes the device back (:class:`_DegradeGuard`).  The decision
        returned is always the twin's, whatever the probe's verdict."""
        out = self._cpu_twin.place(ctx)
        if self._degrade.should_probe():
            try:
                shadow = self._device_place(ctx)
            except Exception as exc:  # noqa: BLE001 — probe of a dead device
                self._degrade.note_probe(False, self.logger, exc)
            else:
                self._degrade.note_probe(
                    np.array_equal(np.asarray(shadow), np.asarray(out)),
                    self.logger,
                )
        return out

    def _guarded_device_place(self, ctx: TickContext) -> np.ndarray:
        """Device dispatch with the degradation guard: a failing kernel
        call is served by the numpy twin for this tick (the twin consumes
        the same per-tick Philox stream, so on the CPU in float64 the
        placements are the device's bit for bit); ``degrade_after``
        consecutive failures make the fallback sticky until a half-open
        probe matches.  Guard disabled (``degrade_after=None``):
        exceptions propagate unchanged.  :class:`DeviceLostError` — the
        loss of a mesh shard, raised by the elastic fault gate
        (``serve/elastic.py``) — always propagates: the elastic
        supervisor handles it, not the twin."""
        if self.degrade_after is None or self._cpu_twin is None:
            self.device_ticks += 1
            return self._device_place(ctx)
        try:
            out = self._device_place(ctx)
        except DeviceLostError:
            raise
        except Exception as exc:  # noqa: BLE001 — the guard's whole point
            self._note_kernel_failure(exc)
            self.twin_ticks += 1
            return self._cpu_twin.place(ctx)
        self._degrade.note_success()
        self.device_ticks += 1
        return out

    def _replicas(self, avail: np.ndarray, n_replicas: int, perturb: float,
                  seed: int) -> np.ndarray:
        """``[R, H, 4]`` availability replicas: replica 0 the exact
        snapshot, replicas 1..R−1 under ±``perturb`` multiplicative noise
        per host from ``default_rng(seed)`` (the reference's draws), the
        f64 products rounded once into the policy dtype."""
        rng = np.random.default_rng(seed)
        noise = rng.uniform(1 - perturb, 1 + perturb,
                            size=(n_replicas, avail.shape[0], 1))
        noise[0] = 1.0  # replica 0 = the production decision
        return (avail[None] * noise).astype(self.np_dtype)

    def _mc_sensitivity(self, ctx, order, batched_place, n_replicas,
                        perturb, seed, **operands):
        """Monte-Carlo scaffolding of ``placement_sensitivity``
        (``pivot_tpu/sched/tpu.py:1529``): replica 0 carries the exact
        snapshot (its placements ARE the production decision), replicas
        1..R−1 draw ±``perturb`` multiplicative noise, and
        ``stability[t]`` is the fraction of replicas agreeing with the
        nominal host.  The replicas, the task stream and the policy's own
        host ``operands`` go to the device in ONE staging copy;
        ``batched_place(st, T)`` gets the staged dict (``avail_r``,
        ``dem``, ``valid`` and the operands) and returns the ``[R, B]``
        placements, fetched in one copy.  Returns ``(nominal [T],
        stability [T], placements [R, T])`` in ctx task order."""
        T = ctx.n_tasks
        avail, dem, valid = self._padded(ctx, order)
        st = stage(self.device,
                   avail_r=self._replicas(avail, n_replicas, perturb, seed),
                   dem=dem, valid=valid, **operands)
        p = batched_place(st, T)[:, :T].cpu().numpy().astype(np.int64)
        if order is None:
            placements = p
        else:
            placements = np.full((n_replicas, T), -1, dtype=np.int64)
            placements[:, np.asarray(order, dtype=np.int64)] = p
        nominal = placements[0]
        stability = (placements == nominal[None, :]).mean(axis=0)
        return nominal, stability, placements


class CudaOpportunisticPolicy(_DevicePolicyBase):
    """Uniformly random fitting host (``TpuOpportunisticPolicy``,
    ``pivot_tpu/sched/tpu.py:1562``)."""

    name = "opportunistic_cuda"
    _carry_free_arm = "opportunistic"

    def __init__(self, adaptive: bool = False, phase2="auto",
                 risk_weight: float = 0.0, rework_cost: float = 1.0,
                 weights=None, device="cuda",
                 degrade_after: Optional[int] = None):
        super().__init__(adaptive, phase2, risk_weight, rework_cost, weights,
                         device, degrade_after)
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
        kw = dict(policy="opportunistic", uniforms=u, phase2=self.phase2)
        if self._carry_free_serves():
            kw["carry_free"] = self._span_carry_free
        return kw

    def _carry_free(self, *args, **kw):
        return opportunistic_cuda(*args, **kw)

    def _device_place(self, ctx: TickContext) -> np.ndarray:
        T = ctx.n_tasks
        avail, dem, valid = self._padded(ctx)
        u = np.zeros(valid.shape[0], dtype=self.np_dtype)
        u[:T] = tick_uniforms(ctx.scheduler.seed or 0, ctx.tick_seq, T)
        st = self._stage(avail=avail, dem=dem, valid=valid, u=u,
                         live=self._live_np(ctx), risk=self._risk_np(ctx))
        if self._carry_free_serves():
            placements, _ = self._call_kernel(
                opportunistic_cuda, st["avail"], st["dem"], st["valid"],
                st["u"], live=st["live"], risk=st["risk"], n_bound=T)
            self.kernel_ticks += 1
        else:
            placements, _ = self._kernel_for(
                opportunistic_impl, opportunistic_kernel_sharded)(
                st["avail"], st["dem"], st["valid"], st["u"],
                phase2=self.phase2, live=st["live"], risk=st["risk"],
            )
        return self._unpad(placements, T)


class CudaFirstFitPolicy(_DevicePolicyBase):
    """Lowest-index fitting host, optionally over demand-decreasing task
    order — the VBP arm (``TpuFirstFitPolicy``,
    ``pivot_tpu/sched/tpu.py:1604``)."""

    name = "first_fit_cuda"
    _carry_free_arm = "first-fit"

    def __init__(self, decreasing: bool = False, adaptive: bool = False,
                 phase2="auto", risk_weight: float = 0.0,
                 rework_cost: float = 1.0, weights=None, device="cuda",
                 degrade_after: Optional[int] = None):
        super().__init__(adaptive, phase2, risk_weight, rework_cost, weights,
                         device, degrade_after)
        self.decreasing = decreasing
        self._cpu_twin = FirstFitPolicy(decreasing=decreasing, mode="numpy",
                                        weights=self.weights)

    def _span_kw(self, ctx, plan, dem_host, B, K):
        kw = dict(
            policy="first-fit", strict=False, decreasing=self.decreasing,
            sort_norm=(self._span_norms(dem_host, B) if self.decreasing
                       else None),
            totals=self._staged_topology().totals, phase2=self.phase2,
        )
        if self._carry_free_serves():
            kw["carry_free"] = self._span_carry_free
        return kw

    def _carry_free(self, *args, **kw):
        return first_fit_cuda(*args, **kw)

    def _order(self, ctx: TickContext):
        if not self.decreasing:
            return None
        order = _sort_decreasing(ctx.demands, list(range(ctx.n_tasks)))
        ctx.visit_order = order  # ref returns the sorted list (vbp.py:17)
        return order

    def _device_place(self, ctx: TickContext) -> np.ndarray:
        order = self._order(ctx)
        avail, dem, valid = self._padded(ctx, order)
        st = self._stage(avail=avail, dem=dem, valid=valid,
                         live=self._live_np(ctx), risk=self._risk_np(ctx))
        if self._carry_free_serves():
            placements, _ = self._call_kernel(
                first_fit_cuda, st["avail"], st["dem"], st["valid"],
                strict=False, live=st["live"], risk=st["risk"],
                n_bound=ctx.n_tasks)
            self.kernel_ticks += 1
        else:
            placements, _ = self._kernel_for(
                first_fit_impl, first_fit_kernel_sharded)(
                st["avail"], st["dem"], st["valid"],
                strict=False, totals=self._staged_topology().totals,
                phase2=self.phase2, live=st["live"], risk=st["risk"],
            )
        return self._unpad(placements, ctx.n_tasks, order)

    def placement_sensitivity(self, ctx: TickContext, n_replicas: int = 256,
                              perturb: float = 0.05, seed: int = 0):
        """Monte-Carlo robustness of this tick's first-fit decision
        (``pivot_tpu/sched/tpu.py:1644``), the contract of
        :meth:`CudaCostAwarePolicy.placement_sensitivity`, scored with one
        launch of :func:`first_fit_cuda_batched` where the carry-free rule
        holds, else :func:`first_fit_batched` — one pass over the
        ``[R, H]`` replicas, the live mask not applied, as in the
        reference."""
        batched = (first_fit_cuda_batched if self._carry_free_serves()
                   else first_fit_batched)
        return self._mc_sensitivity(
            ctx, self._order(ctx),
            lambda st, T: batched(
                st["avail_r"], st["dem"], st["valid"], strict=False,
                risk=st["risk"], n_bound=T)[0],
            n_replicas, perturb, seed, risk=self._risk_np(ctx),
        )


class CudaBestFitPolicy(_DevicePolicyBase):
    """Min residual-L2 host among strict fits (``TpuBestFitPolicy``,
    ``pivot_tpu/sched/tpu.py:1670``)."""

    name = "best_fit_cuda"
    _carry_free_arm = "best-fit"

    def __init__(self, decreasing: bool = False, adaptive: bool = False,
                 phase2="auto", risk_weight: float = 0.0,
                 rework_cost: float = 1.0, weights=None, device="cuda",
                 degrade_after: Optional[int] = None):
        super().__init__(adaptive, phase2, risk_weight, rework_cost, weights,
                         device, degrade_after)
        self.decreasing = decreasing
        self._cpu_twin = BestFitPolicy(decreasing=decreasing, mode="numpy",
                                       weights=self.weights)

    def _span_kw(self, ctx, plan, dem_host, B, K):
        kw = dict(
            policy="best-fit", decreasing=self.decreasing,
            sort_norm=(self._span_norms(dem_host, B) if self.decreasing
                       else None),
            totals=self._staged_topology().totals, phase2=self.phase2,
        )
        if self._carry_free_serves():
            kw["carry_free"] = self._span_carry_free
        return kw

    def _carry_free(self, *args, **kw):
        return best_fit_cuda(*args, **kw)

    _order = CudaFirstFitPolicy._order

    def _device_place(self, ctx: TickContext) -> np.ndarray:
        order = self._order(ctx)
        avail, dem, valid = self._padded(ctx, order)
        st = self._stage(avail=avail, dem=dem, valid=valid,
                         live=self._live_np(ctx), risk=self._risk_np(ctx))
        if self._carry_free_serves():
            placements, _ = self._call_kernel(
                best_fit_cuda, st["avail"], st["dem"], st["valid"],
                live=st["live"], risk=st["risk"], n_bound=ctx.n_tasks)
            self.kernel_ticks += 1
        else:
            placements, _ = self._kernel_for(
                best_fit_impl, best_fit_kernel_sharded)(
                st["avail"], st["dem"], st["valid"],
                totals=self._staged_topology().totals, phase2=self.phase2,
                live=st["live"], risk=st["risk"],
            )
        return self._unpad(placements, ctx.n_tasks, order)

    def placement_sensitivity(self, ctx: TickContext, n_replicas: int = 256,
                              perturb: float = 0.05, seed: int = 0):
        """Monte-Carlo robustness of this tick's best-fit decision
        (``pivot_tpu/sched/tpu.py:1710``), scored with
        :func:`best_fit_cuda_batched` where the carry-free rule holds, else
        :func:`best_fit_batched`."""
        batched = (best_fit_cuda_batched if self._carry_free_serves()
                   else best_fit_batched)
        return self._mc_sensitivity(
            ctx, self._order(ctx),
            lambda st, T: batched(
                st["avail_r"], st["dem"], st["valid"], risk=st["risk"],
                n_bound=T)[0],
            n_replicas, perturb, seed, risk=self._risk_np(ctx),
        )


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
                 weights=None, device="cuda",
                 degrade_after: Optional[int] = None):
        super().__init__(adaptive, phase2, risk_weight, rework_cost, weights,
                         device, degrade_after)
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
        if exps is not None and self._mesh is not None:
            raise ValueError("cannot promote learned score exponents onto a "
                             "host-sharded policy (ops/shard.py exemption)")
        if exps is not None and getattr(self._batch_client, "mesh",
                                        None) is not None:
            raise ValueError("cannot promote learned score exponents onto a "
                             "2-D-mesh-batched policy (ops/shard.py "
                             "exemption)")
        super().apply_weights(w)
        self._score_exp = exps

    def enable_sharding(self, mesh) -> None:
        if self._score_exp is not None:
            raise ValueError(
                "the host-sharded passes (ops/shard.py) have not been "
                "threaded for learned score exponents (a declared "
                "exemption in analysis/parity.py) — serve learned "
                "exponents unsharded, or keep the reference shape"
            )
        super().enable_sharding(mesh)

    def reshard(self, mesh) -> None:
        if mesh is not None and self._score_exp is not None:
            raise ValueError(
                "the host-sharded passes have not been threaded for "
                "learned score exponents — reshard only a policy at the "
                "reference shape"
            )
        super().reshard(mesh)

    def _kernel_serves(self) -> bool:
        """The reference's auto rule, with ``cuda`` for the TPU backend;
        never with a mesh (the kernel has no sharded form)."""
        if self._mesh is not None:
            return False
        if self.use_kernel is not None:
            if self.use_kernel and self.dtype != torch.float32:
                raise ValueError("the greedy_place kernel is float32 only; "
                                 "drop use_kernel=True for a float64 policy")
            return self.use_kernel
        return (self.device.type == "cuda" and self.dtype == torch.float32
                and not self.realtime_bw and self._score_exp is None)

    def prepare(self) -> None:
        """Initialise CUDA, and build and load ``greedy_place`` when it
        serves this policy, on the calling thread."""
        super().prepare()
        if self._kernel_serves() and self.device.type == "cuda":
            load_library()

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
        topo = self._staged_topology()
        kw = dict(
            policy="cost-aware", bin_pack=self.bin_pack,
            sort_tasks=self.sort_tasks, sort_hosts=self.sort_hosts,
            host_decay=self.host_decay,
            sort_norm=(self._span_norms(dem_host, B) if self.sort_tasks
                       else None),
            anchor_zone=az, bucket_id=bucket, cost_zz=topo.cost,
            bw_zz=topo.bw, host_zone=self._host_zone_arg(topo),
            base_task_counts=self._pad_h(
                np.asarray(ctx.host_task_counts, np.int32), 0),
            totals=topo.totals, phase2=self.phase2,
        )
        if self._kernel_serves():
            kw["greedy"] = self._span_greedy
        elif self._score_exp is not None:
            kw["score_exp"] = np.asarray(self._score_exp, self.np_dtype)
        return kw

    def _span_market_kw(self, ctx, plan, K, risk=True):
        """The base class's risk rows plus the price-scaled cost operands
        (``pivot_tpu/sched/tpu.py:1949-1964``): the ``[P, Z, Z]``
        ``cost_stack`` (f64 on the host, rounded once, staged once per
        market; kept on the host when batched) and the span's ``[K]``
        segment row, host ints — tick k scores with
        ``cost_stack[cost_seg[k]]``, the per-tick path's
        ``cost_matrix_at`` slice."""
        kw = super()._span_market_kw(ctx, plan, K, risk)
        market = getattr(ctx.scheduler, "market", None)
        if market is None:
            return kw
        if self._market_stack_dev is None:
            stack = np.asarray(market.cost_tensor(ctx.meta), self.np_dtype)
            self._market_stack_dev = (
                stack if self._batch_client is not None
                else torch.tensor(stack, device=self.device))
        seg = np.zeros(K, dtype=np.int32)
        seg[: plan.n_ticks] = market.segment_indices(plan.grid[: plan.n_ticks])
        kw.update(cost_stack=self._market_stack_dev, cost_seg=seg)
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
        counts = self._pad_h(np.asarray(ctx.host_task_counts, np.int32), 0)
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
        st = self._stage(avail=avail, dem=dem, valid=valid, ng=ng_arr,
                         az=az_arr, counts=counts, live=self._live_np(ctx),
                         risk=self._risk_np(ctx), rows=rows, idx=idx,
                         score_exp=score_exp)
        topo = self._staged_topology()
        args = (st["avail"], st["dem"], st["valid"], st["ng"], st["az"],
                self._market_cost_arg(ctx), topo.bw,
                self._host_zone_arg(topo), st["counts"])
        mode = dict(bin_pack=self.bin_pack, sort_hosts=self.sort_hosts,
                    host_decay=self.host_decay, live=st["live"],
                    risk=st["risk"])
        if self._kernel_serves():
            if self._batch_client is None:
                placements, _ = self._call_kernel(self._greedy, *args,
                                                  **mode, n_eff=T)
            else:
                # The module-level call, one key for every session; the
                # step bound a per-row operand, or T would split flushes.
                placements, _ = self._call_kernel(
                    cost_aware_cuda, *args, **mode, n_eff=np.int32(T))
            self.kernel_ticks += 1
        else:
            exps = ({} if st["score_exp"] is None
                    else {"score_exp": st["score_exp"]})
            placements, _ = self._kernel_for(
                cost_aware_impl, cost_aware_kernel_sharded)(
                *args, **mode, rt_bw_rows=st["rows"], rt_bw_idx=st["idx"],
                totals=topo.totals, phase2=self.phase2, **exps,
            )
        return self._unpad(placements, T, order)

    def placement_sensitivity(self, ctx: TickContext, n_replicas: int = 256,
                              perturb: float = 0.05, seed: int = 0):
        """Monte-Carlo robustness of THIS tick's placement decision
        (``pivot_tpu/sched/tpu.py:2010``): ``n_replicas`` perturbed
        availability snapshots share the tick's task stream — one launch
        of the replica-batched kernel when the kernel serves this policy,
        else one torch pass per replica — scored with the tick's cost
        operand (the market's slice when one is attached), so replica 0
        stays the production decision.  Returns ``(nominal [T],
        stability [T], placements [R, T])``."""
        if self.realtime_bw:
            raise ValueError(
                "placement_sensitivity scores on the static topology tables "
                "(the greedy_place kernel has no live-bandwidth input)"
            )
        if self.topology is None:
            raise RuntimeError("bind() the policy to a scheduler first")
        order, az_arr, ng_arr, _gr, _ri = self._anchor_stream(ctx)
        topo = self.topology
        cost = self._market_cost_arg(ctx)
        mode = dict(bin_pack=self.bin_pack, sort_hosts=self.sort_hosts,
                    host_decay=self.host_decay)
        kernel = self._kernel_serves()

        host_zone = self._host_zone_arg(topo)

        def batched(st, T):
            args = (st["dem"], st["valid"], st["ng"], st["az"], cost,
                    topo.bw, host_zone, st["counts"])
            if kernel:
                return self._greedy_batched(st["avail_r"], *args, **mode,
                                            risk=st["risk"], n_eff=T)[0]
            return torch.stack([
                cost_aware_impl(a, *args, **mode, risk=st["risk"],
                                score_exp=st["score_exp"])[0]
                for a in st["avail_r"]
            ])

        score_exp = (None if self._score_exp is None
                     else np.asarray(self._score_exp, self.np_dtype))
        return self._mc_sensitivity(
            ctx, order, batched, n_replicas, perturb, seed, ng=ng_arr,
            az=az_arr,
            counts=self._pad_h(np.asarray(ctx.host_task_counts, np.int32), 0),
            risk=self._risk_np(ctx), score_exp=score_exp,
        )
