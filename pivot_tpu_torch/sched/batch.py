"""Cross-run dispatch batching: co-pending ticks of many runs, one flush.

Port of ``pivot_tpu/sched/batch.py`` with its mesh, replica-only or
2-D ``replica × host``; with the recovery plane's write-ahead journal
(``DispatchBatcher(journal=)``: each flush's composition is journaled
before its first device call, a solo dispatch as a one-request flush)
and the sampled dispatch profiler (``DispatchBatcher(profiler=)``: it
brackets each group's :func:`batch_execute` inside the flush). G
concurrently stepped DES runs — the lock-step grid's runs
(``experiments.runner.run_grid_lockstep``) or the serving sessions of
``pivot_tpu_torch.serve`` — submit their placement calls, per-tick
kernel calls and whole fused spans alike, to a :class:`DispatchBatcher`;
the coordinator coalesces co-pending calls of one (kernel, shape, static
config) key into one flush and hands each run back its own row.

What a flush of G same-key requests runs (:func:`batch_execute`):

  * every operand column is stacked on the host (``np.stack``) and the
    whole flush is staged on the device in ONE host→device copy
    (``sched.cuda.stage``), and only the placements come back, in ONE
    device→host copy; the span operands read on the host (a span's
    market segments, ``ops.tickloop.SPAN_HOST_OPERANDS``) and the span
    horizons stay on the host, and each span's step bounds are computed
    from its host ``arrive``;
  * a kernel with a batched form in the registry (``_BATCHED``) runs it
    once over the ``[G, ...]`` columns.  The Cost-Aware kernel call
    (``ops.cuda_kernels.cost_aware_cuda``) becomes one per-row launch of
    ``greedy_place`` (``cost_aware_cuda_rows``), each row its own
    stream, host rows, tables and step bound — what ``jax.vmap`` of the
    kernel computes in the reference; its rows pad to
    :func:`group_bucket` with copies of row 0, as the reference stages.
    A fused span (``ops.tickloop.fused_tick_run``) becomes one call of
    the batched span driver (``fused_tick_run_rows``): a kernel-served
    Cost-Aware span is one per-row launch of ``greedy_place`` per span
    tick over the G rows, the torch arms' spans run their rows one after
    another (their batched hand kernel is ROADMAP Queue 2 item 1);
  * any other callable — the torch arms ``first_fit_impl``,
    ``best_fit_impl``, ``opportunistic_impl`` and ``cost_aware_impl`` off
    the kernel among them — runs its rows one after another through the
    same call as an unbatched tick, on row views of the staged columns:
    bit-identical by construction;
  * a group of one runs the unbatched call, as the reference does.

Ragged spans (``DispatchBatcher(ragged=True)``, the default): co-pending
span requests that differ only in their span bucket K and slot bucket B
are padded to one (K′, B′) = (max K, max B) on the host
(``ops.tickloop.ragged_span_pad``), ride one flush, and each result is
sliced back to its own buckets (``ragged_span_trim``) — bit-identical to
the request's solo dispatch by the inert-tail contract.

Correctness contract (``tests/test_torch_batch.py``,
``tests/test_torch_ragged.py``): a run's placements are identical
whether its tick or span was served alone or inside any flush — the
kernels are pure functions of their per-tick inputs, and a row of the
per-row launch is the unbatched launch of that row (``chip_smoke.py``
holds every coalesced launch against its plain version on the card).

The mesh (``DispatchBatcher(mesh=)``, ``batch_execute(mesh=)``;
``parallel.mesh.replica_mesh`` or ``build_hybrid_mesh``) must name one
device, the flush device (``ops/shard.py::mesh_device``): a batcher
checks it at construction, and ``batch_execute`` against the device it
is handed.  :func:`_plan_mesh` is the one routing decision, which the
batcher's mesh counters read:

  * on a replica-only mesh, a coalesced group whose padded bucket
    divides the ``replica`` axis runs its rows in contiguous blocks of
    that bucket over it (``ops/shard.py::row_sharding``) — on one card,
    S logical shards whose blocks share the one call, so a Cost-Aware
    mesh flush is still ONE per-row launch of ``greedy_place`` and a
    torch arm's rows still run one after another, pad rows never run.
    A bucket that does not divide the axis, or a 1-row batch, falls
    back to the unsharded call; rows never communicate, so both give
    the same bits, and on one device both are the same call;
  * on a 2-D mesh (a ``host`` axis above 1), a group of a form with a
    host-sharded twin (``ops/shard.py::sharded_twin_of``) whose H
    divides the host axis pads to the smallest multiple of the replica
    axis ≥ g and runs the ``[G]``-batched 2-D twin
    (``ops/shard.py::batched_sharded_call``); a lone request runs its
    1-D twin.  Every other group — the Cost-Aware kernel call and a span
    it serves (``greedy_place`` has no sharded form: the reference's
    Pallas exclusion), the realtime-bandwidth rows
    (``ops/shard.py::UNSHARDABLE_KW``) — keeps the replica-only path, and
    where that falls back the batcher counts the cause ``unshardable``.

Operands arrive as host numpy (the policies stage to the host when a
client is attached, ``sched/cuda.py``); a 0-d operand (the Cost-Aware
step bound ``n_eff``, a span's horizon) is a per-row scalar: a ``[G]``
column of the batched form, a host int of an unbatched call.
"""

from __future__ import annotations

import functools
import logging
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pivot_tpu_torch.ops import cuda_kernels
from pivot_tpu_torch.ops.shard import (
    batched_sharded_call,
    mesh_device,
    mesh_is_2d,
    sharded_twin_of,
)
from pivot_tpu_torch.ops.tickloop import (
    SPAN_HOST_OPERANDS,
    ResidentCarry,
    fused_tick_run,
    fused_tick_run_rows,
    ragged_span_pad,
    ragged_span_signature,
    ragged_span_trim,
    span_step_bounds,
)
from pivot_tpu_torch.parallel.mesh import host_axis_size
from pivot_tpu_torch.sched.cuda import pad_bucket, stage

__all__ = [
    "BatchClient",
    "DispatchBatcher",
    "batch_execute",
    "group_bucket",
]

#: Small-G buckets below the task-axis bucket ladder
#: (``pivot_tpu/sched/batch.py:96``).
_G_BUCKETS = (2, 4, 8, 16)


def group_bucket(g: int) -> int:
    """Smallest batch bucket ≥ g; 1 is its own bucket (a lone request
    runs the unbatched call)."""
    if g <= 1:
        return 1
    for b in _G_BUCKETS:
        if g <= b:
            return b
    return pad_bucket(g)


def _cost_aware_rows(args, kw, static_kw):
    """The batched form of the Cost-Aware kernel call: one per-row launch
    (``n_eff``, a per-row operand, becomes ``n_eff_g``)."""
    kw = dict(kw)
    n_eff = kw.pop("n_eff", None)
    return cuda_kernels.cost_aware_cuda_rows(*args, **kw, **static_kw,
                                             n_eff_g=n_eff)


def _rows_form(greedy):
    """The per-row form of a span's one-row greedy pass (looked up when
    called, as :func:`_cost_aware_rows` does), or None."""
    if greedy is cuda_kernels.cost_aware_cuda:
        return cuda_kernels.cost_aware_cuda_rows
    return None


def _span_rows(args, kw, static_kw):
    """The batched form of a fused span: the batched span driver, the
    span's ``greedy`` swapped for its per-row form."""
    static_kw = dict(static_kw)
    greedy = static_kw.pop("greedy", None)
    rows = _rows_form(greedy)
    if greedy is not None and rows is None:
        raise ValueError(f"a span's greedy pass {greedy!r} has no per-row "
                         "form to serve a coalesced flush")
    return fused_tick_run_rows(*args, **kw, **static_kw, greedy=rows)


#: Batched forms by kernel callable; any other callable runs its rows in
#: sequence (module docstring).
_BATCHED = {cuda_kernels.cost_aware_cuda: _cost_aware_rows,
            fused_tick_run: _span_rows}
#: Batched forms whose rows pad to :func:`group_bucket`.
_PADDED = frozenset({cuda_kernels.cost_aware_cuda})


def _row(out, r: int):
    """Row ``r`` of a batched output (a tuple keeps its type)."""
    vals = tuple(o[r] for o in out)
    return type(out)(*vals) if hasattr(out, "_fields") else vals


def _with_first(out, first):
    """``out`` with its first element replaced."""
    vals = (first, *out[1:])
    return type(out)(*vals) if hasattr(out, "_fields") else vals


def _fetch(outs: list) -> list:
    """Each request's output with its placements — the whole output, or
    the first element of a tuple — on the host, fetched for all requests
    in one device→host copy; other elements stay where the kernel left
    them."""
    first = [o[0] if isinstance(o, tuple) else o for o in outs]
    if torch.is_tensor(first[0]):
        host = torch.stack(first).cpu().numpy()
        first = list(host)
    return [
        _with_first(o, f) if isinstance(o, tuple) else f
        for f, o in zip(first, outs)
    ]


def _replica_mesh_for(mesh, gb: int):
    """The mesh to shard a ``gb``-row batch over, or None
    (``pivot_tpu/sched/batch.py:171-184``): the replica axis must divide
    the padded group bucket (contiguous row blocks), and a 1-row batch
    has nothing to spread.  None on a real mesh is a fallback to the
    unsharded call — bit-identical, and metered by the batcher
    (``mesh_fallbacks``)."""
    if mesh is None or gb <= 1:
        return None
    return mesh if gb % int(mesh.shape["replica"]) == 0 else None


def _hosts_divide(mesh, args0) -> bool:
    """Whether the request's host axis (its first operand's rows)
    divides the mesh's host axis."""
    return bool(args0) and hasattr(args0[0], "shape") and (
        args0[0].shape[0] % host_axis_size(mesh) == 0)


def _plan_mesh(mesh, kernel, g: int, args0=(), arr_kw_keys=(),
               static_kw=None):
    """One coalesced group's ``(padded bucket, mesh or None, host_ok)``
    — the ONE routing decision :func:`batch_execute` executes and the
    batcher's counters mirror (``pivot_tpu/sched/batch.py:187-227``).
    On a 2-D mesh a group of a form with a host-sharded twin whose host
    axis divides the mesh's pads to the smallest multiple of the replica
    axis ≥ g (a 3-row group on replica 2 pads to 4) and runs the 2-D
    program (``host_ok``).  ``static_kw``: the group's static keywords
    (a span served by ``greedy_place`` has no twin)."""
    gb = group_bucket(g)
    host_ok = False
    if (mesh is not None and g > 1 and mesh_is_2d(mesh)
            and sharded_twin_of(kernel, arr_kw_keys, static_kw) is not None
            and _hosts_divide(mesh, args0)):
        r = int(mesh.shape["replica"])
        gb = -(-g // r) * r
        host_ok = True
    fn_mesh = _replica_mesh_for(mesh, gb)
    return gb, fn_mesh, host_ok and fn_mesh is not None


def batch_execute(
    kernel,
    requests: Sequence[Tuple[tuple, dict]],
    static_kw: Optional[dict] = None,
    device=None,
    mesh=None,
) -> list:
    """Serve N same-shaped kernel requests as one flush on ``device``
    (default: ``mesh``'s device, else ``cuda``).

    ``requests`` is a sequence of ``(args, arr_kw)`` pairs of host arrays
    whose shapes and dtypes match pairwise (the caller groups by
    :func:`_request_key`).  Returns one output per request, in order,
    with its placements on the host (:func:`_fetch`).  The flush stages
    its columns in one copy and fetches the placements in one copy;
    module docstring for what runs in between, and for ``mesh``."""
    static_kw = dict(static_kw or {})
    g = len(requests)
    if g == 0:
        return []
    if mesh is not None:
        device = mesh_device(mesh, device)
    device = torch.device("cuda" if device is None else device)
    for args, arr_kw in requests:
        if any(isinstance(a, ResidentCarry)
               for a in (*args, *arr_kw.values())):
            raise TypeError(
                "batch_execute cannot serve a resident-carry dispatch: a "
                "flush re-stages its operands from host numpy — call "
                "ops.tickloop.resident_span_run directly (the resident "
                "tier and the cross-run batcher are mutually exclusive)"
            )
    kw_keys = tuple(sorted(requests[0][1]))
    n_args = len(requests[0][0])
    cols = [np.stack([np.asarray(r[0][i]) for r in requests])
            for i in range(n_args)]
    cols += [np.stack([np.asarray(r[1][k]) for r in requests])
             for k in kw_keys]
    names = [str(i) for i in range(n_args)] + list(kw_keys)
    span = kernel is fused_tick_run
    # Host-side operands: a span's host segments, and — in every form —
    # the 0-d per-row scalars, except a batched form's kernel bound.
    on_host = [name in SPAN_HOST_OPERANDS for name in names]
    if span:
        # A span's horizon (args: avail, demands, arrive, n_ticks_dyn)
        # stays on the host: its step bounds come from its host arrive,
        # so the span reads nothing from the device.
        on_host[3] = True
    gb, _fn_mesh, host_ok = _plan_mesh(mesh, kernel, g, requests[0][0],
                                       kw_keys, static_kw)
    # A mesh's row blocks share this one call: they all live on the one
    # device.  A 2-D group runs the [G]-batched twin.
    batched = None
    if host_ok:
        batched = batched_sharded_call  # bound below, with the bounds
    elif g > 1:
        batched = _BATCHED.get(kernel)
        if kernel not in _PADDED:
            gb = g
    if batched is not None:
        if gb > g:
            # Pad rows replicate row 0: same shapes, finite values; their
            # output rows are dropped below.
            cols = [np.concatenate([c, np.repeat(c[:1], gb - g, axis=0)])
                    for c in cols]
        if span:
            static_kw["n_bound"] = [span_step_bounds(cols[2][r],
                                                     int(cols[3][r]))
                                    for r in range(gb)]
        st = stage(device, **{str(i): c for i, c in enumerate(cols)
                              if not on_host[i]})
        cols = [c if on_host[i] else st[str(i)] for i, c in enumerate(cols)]
        if host_ok:
            out = batched(mesh, kernel, static_kw, n_args, kw_keys)(*cols)
        else:
            out = batched(tuple(cols[:n_args]),
                          dict(zip(kw_keys, cols[n_args:])), static_kw)
        return _fetch([_row(out, r) for r in range(g)])
    call = kernel
    if g == 1 and mesh is not None and mesh_is_2d(mesh):
        twin = sharded_twin_of(kernel, kw_keys, static_kw)
        if twin is not None and _hosts_divide(mesh, requests[0][0]):
            # A lone request on a 2-D mesh still runs host-sharded,
            # through its 1-D twin (``pivot_tpu/sched/batch.py:289-309``).
            call = functools.partial(twin, mesh)
    # Row by row: 0-d operands (a [G] column here) stay host scalars.
    scalar = [on_host[i] or c.ndim == 1 for i, c in enumerate(cols)]
    st = stage(device, **{str(i): c for i, c in enumerate(cols)
                          if not scalar[i]})
    outs = []
    for r in range(g):
        row = [(cols[i][r].item() if cols[i].ndim == 1 else cols[i][r])
               if scalar[i] else st[str(i)][r] for i in range(len(cols))]
        kw = dict(zip(kw_keys, row[n_args:]))
        if span:
            kw["n_bound"] = span_step_bounds(cols[2][r], int(cols[3][r]))
        outs.append(call(*row[:n_args], **kw, **static_kw))
    return _fetch(outs)


def _request_key(kernel, args, arr_kw, static_kw) -> tuple:
    """Requests with equal keys may share one flush."""
    return (
        kernel,
        tuple(sorted(static_kw.items())),
        tuple((tuple(np.shape(a)), str(np.asarray(a).dtype)) for a in args),
        tuple(
            (k, tuple(np.shape(v)), str(np.asarray(v).dtype))
            for k, v in sorted(arr_kw.items())
        ),
    )


class _Request:
    __slots__ = ("slot", "kernel", "args", "arr_kw", "static_kw", "key",
                 "done", "result", "error", "trim")

    def __init__(self, slot, kernel, args, arr_kw, static_kw):
        self.slot = slot
        self.kernel = kernel
        self.args = args
        self.arr_kw = arr_kw
        self.static_kw = static_kw
        self.key = _request_key(kernel, args, arr_kw, static_kw)
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        #: The (K, B) buckets a span request was staged at, set when the
        #: ragged repack pads it into a merged (K′, B′) flush: the demux
        #: slices its result back to these.
        self.trim: Optional[Tuple[int, int]] = None


class BatchClient:
    """One run's handle on the batcher: ``dispatch`` blocks the run's
    thread at its tick boundary until the coordinator serves the batch."""

    def __init__(self, batcher: "DispatchBatcher", slot: int):
        self._batcher = batcher
        self.slot = slot
        self._closed = False
        self._idle = False

    @property
    def mesh(self):
        """The owning batcher's mesh (None, replica-only or 2-D): what
        ``sched.cuda`` checks host sharding against when a policy
        composes batching with sharding."""
        return self._batcher._mesh

    def dispatch(self, kernel, args, arr_kw=None, static_kw=None):
        if self._closed:
            # An abandoned (stall-supervised) session thread waking up
            # after its slot was reclaimed must not re-enter the barrier.
            raise RuntimeError("batch client is closed")
        batcher = self._batcher
        with batcher._cond:
            # Single-live-slot fast path: the one open slot with nothing
            # pending has nobody to coalesce with — serve the call on
            # this thread (a one-request flush, bit-identical).
            solo = batcher._open == 1 and not batcher._pending
            if solo:
                batcher.stats["dispatches"] += 1
                batcher.stats["device_calls"] += 1
                batcher.stats["single_fast_path"] += 1
        if solo:
            if batcher._journal is not None:
                # Write-ahead parity with _flush: a solo dispatch is a
                # one-request flush and journals as one before the
                # device call commits it.
                batcher._journal.append("flush", groups=1, reqs=1)
            # The batcher's mesh rides along: a lone slot on a 2-D mesh
            # still dispatches host-sharded (the 1-D twin).
            return batch_execute(
                kernel, [(tuple(args), dict(arr_kw or {}))],
                dict(static_kw or {}), device=batcher.device,
                mesh=batcher._mesh,
            )[0]
        req = _Request(
            self.slot, kernel, tuple(args), dict(arr_kw or {}),
            dict(static_kw or {}),
        )
        batcher._submit(req)
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def set_idle(self, idle: bool) -> None:
        """Declare this slot idle (excluded from the quiescence count) or
        busy again.  Idempotent; a closed client ignores the call."""
        if self._closed or idle == self._idle:
            return
        self._idle = idle
        self._batcher._set_idle(1 if idle else -1)

    def close(self) -> None:
        """Mark this run finished (idempotent) — the coordinator stops
        waiting for it.  MUST be called (``finally``) or the barrier
        deadlocks."""
        if not self._closed:
            self._closed = True
            self._batcher._close_slot(was_idle=self._idle)


class DispatchBatcher:
    """Tick-synchronous barrier + coalescer for G concurrent runs
    (``pivot_tpu/sched/batch.py:457``).

    Each run executes in its own thread; a placement dispatch parks the
    thread.  The coordinator (:meth:`serve`, on the driver thread) waits
    for quiescence — every live, non-idle run parked on a request — or,
    with ``flush_after`` seconds set, at most that long once a request is
    pending, then flushes: co-pending requests with identical keys become
    one :func:`batch_execute` call.

    ``stats`` has the reference's keys (``SloMeter.DISPATCH_KEYS``):
    ``runs``, ``dispatches`` (kernel calls requested), ``device_calls``
    (kernel calls made: one per group with a batched form — a span
    group's is one call of the batched span driver, a 2-D group's one
    call of its batched twin, each running a torch arm's rows one after
    another — one per request for a group run row by row),
    ``coalesced`` (requests served
    inside a group of more than one), ``max_group``,
    ``deadline_flushes``, ``single_fast_path``, ``respawns``,
    ``retired_slots``, and the ragged trio ``ragged_merges``
    (mixed-horizon span groups merged into one (K′, B′) bucket),
    ``ragged_rows`` (requests that rode a merged flush) and
    ``ragged_pad_cells`` (K×B cells run beyond the members' own
    buckets), and the mesh counters: ``mesh_dispatches`` (groups whose
    ``[G]`` rows went over the mesh's replica axis) and
    ``mesh_fallbacks`` (groups that lost the mesh — coalesced, or
    fragmented into several shape keys of one kernel, but not sharded),
    partitioned exactly by ``mesh_fallback_unshardable`` (a 2-D mesh
    and no host-sharded twin: 0 on a replica-only mesh),
    ``mesh_fallback_mixed_shapes`` and ``mesh_fallback_indivisible``
    (the bucket does not divide the axis) — :meth:`_fallback_cause`;
    the first fallback is logged.  At any instant ``live_slots == runs
    − retired_slots``.

    ``mesh`` (``parallel.mesh.replica_mesh``, e.g. ``replica_mesh(
    devices=[torch.device("cuda", 0)] * 2)``, or a 2-D
    ``build_hybrid_mesh(host_parallel=S, devices=...)``) shards each
    coalesced flush's ``[G]`` rows over its ``replica`` axis and, on a
    2-D mesh, each row's hosts over its ``host`` axis (module
    docstring); the flush device is the mesh's.

    ``ragged=True`` (the default) turns on the ragged span repack
    (module docstring); ``ragged=False`` keeps exact-shape coalescing,
    the A/B arm.  ``journal`` (a ``pivot_tpu_torch.recover.Journal``)
    receives one ``flush`` record per flush before its device calls.
    ``profiler`` (a ``pivot_tpu_torch.obs.DispatchProfiler``) times a
    sample of the flushes' device calls (:meth:`_execute`).
    """

    def __init__(self, n_slots: int, flush_after: Optional[float] = None,
                 tracer=None, device=None, ragged: bool = True,
                 journal=None, profiler=None, mesh=None):
        if n_slots < 1:
            raise ValueError("DispatchBatcher needs at least one slot")
        if flush_after is not None and flush_after <= 0:
            raise ValueError("flush_after must be positive (or None)")
        if tracer is None:
            from pivot_tpu_torch.obs.tracer import NULL_TRACER

            tracer = NULL_TRACER
        self.tracer = tracer
        if mesh is not None:
            device = mesh_device(mesh, device)
        self.device = torch.device("cuda" if device is None else device)
        #: The mesh, replica-only or 2-D: coalesced flushes shard their
        #: ``[G]`` rows over its replica axis and, on a 2-D mesh, each
        #: row's hosts over its host axis (``batch_execute``).
        self._mesh = mesh
        self._mesh_fallback_logged = False
        self._ragged = bool(ragged)
        #: Write-ahead journal: when the serve driver runs a recovery
        #: plane, every flush appends a ``flush`` record (groups,
        #: requests) BEFORE its first device call.  ``None`` (default) =
        #: no recovery plane, zero cost.
        self._journal = journal
        #: Sampled dispatch profiler (``pivot_tpu/sched/batch.py:531``):
        #: the flush boundary is where batched kernel calls hit the card,
        #: so the profiler brackets ``batch_execute`` HERE — the policy's
        #: ``_call_kernel`` hook stands down when a batch client is
        #: attached (it would time slot park time, not the dispatch).
        #: ``None`` = zero cost.
        self.profiler = profiler
        self._cond = threading.Condition()
        self._n_slots = n_slots
        self._open = n_slots
        self._idle = 0
        self._flush_after = flush_after
        self._pending: List[_Request] = []
        self._clients = 0
        self.stats: Dict[str, int] = {"runs": n_slots, **dict.fromkeys((
            "dispatches", "device_calls", "coalesced", "max_group",
            "deadline_flushes", "single_fast_path", "mesh_dispatches",
            "mesh_fallbacks", "mesh_fallback_unshardable",
            "mesh_fallback_mixed_shapes", "mesh_fallback_indivisible",
            "ragged_merges", "ragged_rows", "ragged_pad_cells", "respawns",
            "retired_slots",
        ), 0)}

    def client(self) -> BatchClient:
        with self._cond:
            if self._clients >= self._n_slots:
                raise ValueError(
                    f"all {self._n_slots} batcher slots already claimed"
                )
            slot = self._clients
            self._clients += 1
        return BatchClient(self, slot)

    def respawn_client(self) -> BatchClient:
        """Open a FRESH slot beyond the construction-time count — the
        supervisor's restart path and the autoscaler's growth path."""
        with self._cond:
            slot = self._clients
            self._clients += 1
            self._n_slots += 1
            self._open += 1
            self.stats["runs"] = self._n_slots
            self.stats["respawns"] += 1
            self._cond.notify_all()
        return BatchClient(self, slot)

    @property
    def live_slots(self) -> int:
        """Open (not yet retired) slots."""
        with self._cond:
            return self._open

    # -- run-thread side --------------------------------------------------
    def _submit(self, req: _Request) -> None:
        with self._cond:
            self._pending.append(req)
            self._cond.notify_all()

    def _close_slot(self, was_idle: bool = False) -> None:
        with self._cond:
            self._open -= 1
            self.stats["retired_slots"] += 1
            if was_idle:
                self._idle -= 1
            self._cond.notify_all()

    def _set_idle(self, delta: int) -> None:
        with self._cond:
            self._idle += delta
            self._cond.notify_all()

    # -- coordinator side -------------------------------------------------
    def _quiescent(self) -> bool:
        # Every live, non-idle run is parked on a request.
        if self._open == 0:
            return True
        if not self._pending:
            return False
        return len(self._pending) >= max(self._open - self._idle, 0)

    def serve(self) -> None:
        """Coordinator loop: flush batches until every run finished."""
        while True:
            with self._cond:
                self._cond.wait_for(
                    lambda: self._pending or self._open == 0
                )
                if self._open == 0 and not self._pending:
                    return
                quiesced = self._cond.wait_for(
                    self._quiescent, timeout=self._flush_after
                )
                if not self._pending:
                    continue
                if not quiesced:
                    self.stats["deadline_flushes"] += 1
                batch, self._pending = self._pending, []
            self._flush(batch)

    def _ragged_regroup(self, batch: List[_Request]) -> None:
        """Merge co-pending span requests that differ only in their
        (K, B) buckets into one (K′, B′) = (max K, max B) bucket
        (``pivot_tpu/sched/batch.py:767-816``): their keys are rewritten
        in place, so the exact-key grouping coalesces them; each result
        is sliced back through ``req.trim``."""
        cand: Dict[tuple, List[_Request]] = {}
        for req in batch:
            if req.kernel is not fused_tick_run:
                continue
            sig = ragged_span_signature(req.args, req.arr_kw, req.static_kw)
            if sig is not None:
                cand.setdefault(sig, []).append(req)
        for reqs in cand.values():
            if len(reqs) < 2 or len({r.key for r in reqs}) < 2:
                continue  # solo or already same-shape: nothing to merge
            k2 = max(int(r.static_kw["n_ticks"]) for r in reqs)
            b2 = max(int(r.args[1].shape[0]) for r in reqs)
            pad_cells = 0
            for r in reqs:
                k, b = int(r.static_kw["n_ticks"]), int(r.args[1].shape[0])
                r.args, r.arr_kw = ragged_span_pad(r.args, r.arr_kw, k2, b2)
                r.static_kw = dict(r.static_kw, n_ticks=k2)
                r.trim = (k, b)
                r.key = _request_key(r.kernel, r.args, r.arr_kw,
                                     r.static_kw)
                pad_cells += k2 * b2 - k * b
            with self._cond:
                self.stats["ragged_merges"] += 1
                self.stats["ragged_rows"] += len(reqs)
                self.stats["ragged_pad_cells"] += pad_cells

    def _execute(self, reqs: List[_Request]) -> list:
        """One flush call for a same-key request group — through the
        sampled profiler when one is attached
        (``pivot_tpu/sched/batch.py:700-747``): its span carries
        ``in_flush``, the group size ``g``, H, B, a span's K, the ragged
        pad cells and the operand bytes staged for it."""
        def call():
            return batch_execute(
                reqs[0].kernel, [(r.args, r.arr_kw) for r in reqs],
                reqs[0].static_kw, device=self.device, mesh=self._mesh,
            )

        prof = self.profiler
        if prof is None or not prof.enabled:
            return call()
        from pivot_tpu_torch.obs.profiler import family_of
        from pivot_tpu_torch.sched.cuda import _dispatch_shape

        shape = {"g": len(reqs),
                 **_dispatch_shape(reqs[0].args, reqs[0].static_kw)}
        n_ticks = shape.get("k")
        # Ragged attribution: the K×B cells this merged dispatch runs
        # beyond its members' own buckets (zero on exact-shape groups).
        pad = sum(
            n_ticks * shape.get("b", 0) - t[0] * t[1]
            for t in (r.trim for r in reqs) if t is not None
        )
        if pad:
            shape["ragged_pad_cells"] = pad
        h2d = sum(
            int(getattr(a, "nbytes", 0))
            for r in reqs
            for a in (*r.args, *r.arr_kw.values())
        )
        return prof.profile(
            family_of(reqs[0].kernel), call, shape=shape, flush=True,
            h2d_bytes=h2d, device=self.device,
        )

    def _fallback_cause(self, req: _Request, fragmented: bool) -> str:
        """Root cause of one mesh fallback
        (``pivot_tpu/sched/batch.py:750-766``) — the three causes
        partition ``mesh_fallbacks`` exactly: ``unshardable`` (a 2-D mesh
        and no host-sharded twin, or operands the sharded forms reject),
        ``mixed_shapes`` (the flush held this kernel under ≥ 2 shape
        keys), ``indivisible`` (the padded bucket does not divide the
        replica axis)."""
        if mesh_is_2d(self._mesh) and sharded_twin_of(
                req.kernel, req.arr_kw, req.static_kw) is None:
            return "unshardable"
        if fragmented:
            return "mixed_shapes"
        return "indivisible"

    def _flush(self, batch: List[_Request]) -> None:
        # Groups in first-key-seen order, rows in slot order.
        try:
            if self._ragged:
                self._ragged_regroup(batch)
            groups: Dict[tuple, List[_Request]] = {}
            for req in batch:
                groups.setdefault(req.key, []).append(req)
            # Shape keys per kernel in THIS flush: a group that lost the
            # mesh while its kernel rode other keys fragmented.
            kernel_keys: Dict[object, set] = {}
            for key in groups:
                kernel_keys.setdefault(key[0], set()).add(key)
            if self._journal is not None and batch:
                # Write-ahead: the flush's composition hits the journal
                # before its first device call, so a crash mid-flush
                # leaves a record of what was committed.
                self._journal.append(
                    "flush", groups=len(groups), reqs=len(batch),
                )
            for reqs in groups.values():
                reqs.sort(key=lambda r: r.slot)
                fragmented = len(kernel_keys[reqs[0].kernel]) > 1
                # The SAME routing decision batch_execute makes for this
                # group: the counters cannot disagree with the flush.
                gb, grp_mesh, host_ok = _plan_mesh(
                    self._mesh, reqs[0].kernel, len(reqs), reqs[0].args,
                    reqs[0].arr_kw, reqs[0].static_kw)
                calls = (1 if len(reqs) > 1 and (
                    host_ok or reqs[0].kernel in _BATCHED) else len(reqs))
                cause = None
                with self._cond:
                    self.stats["dispatches"] += len(reqs)
                    self.stats["device_calls"] += calls
                    self.stats["max_group"] = max(
                        self.stats["max_group"], len(reqs)
                    )
                    if len(reqs) > 1:
                        self.stats["coalesced"] += len(reqs)
                    if grp_mesh is not None:
                        self.stats["mesh_dispatches"] += 1
                    elif self._mesh is not None and (
                        len(reqs) > 1 or fragmented
                    ):
                        cause = self._fallback_cause(reqs[0], fragmented)
                        self.stats["mesh_fallbacks"] += 1
                        self.stats["mesh_fallback_" + cause] += 1
                        if self._mesh_fallback_logged:
                            cause = None
                        self._mesh_fallback_logged = True
                if cause is not None:
                    logging.getLogger(__name__).warning(
                        "DispatchBatcher: %d-request flush (bucket %d) "
                        "cannot ride the mesh (%s) — serving unsharded; "
                        "further fallbacks counted in "
                        "stats['mesh_fallbacks'] and the per-cause "
                        "mesh_fallback_* counters", len(reqs), gb, cause)
                try:
                    with self.tracer.wall_span(
                        "dispatch", "flush", group=len(reqs),
                        slots=[r.slot for r in reqs],
                    ):
                        outs = self._execute(reqs)
                except BaseException as exc:  # noqa: BLE001 — deliver, don't hang
                    for r in reqs:
                        r.error = exc
                        r.done.set()
                    continue
                for r, out in zip(reqs, outs):
                    r.result = (ragged_span_trim(out, *r.trim)
                                if r.trim is not None else out)
                    r.done.set()
        except BaseException as exc:  # noqa: BLE001 — coordinator crash-safety
            # A failure outside the per-group call must still reach every
            # owning slot, or its run thread parks forever.
            for r in batch:
                if not r.done.is_set():
                    r.error = exc
                    r.done.set()
