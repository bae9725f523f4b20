"""Multi-tick scheduler driver: K scheduling ticks as one device program.

Port of ``pivot_tpu/ops/tickloop.py``: ``span_bucket``, the slot
algebra, ``SpanResult``, ``fused_tick_run``, the sequential referee
``reference_tick_run``, the resident carry (``resident_span_run`` and its
helpers, edit buckets) and the ragged pad/trim helpers.  The port's own
:func:`fused_tick_run_rows` is the batched span driver: G spans in one
call, what the reference's batcher gets from ``jax.vmap(fused_tick_run)``.

A span is a *pure tick run* (``GlobalScheduler._extract_span``): a window
of upcoming ticks in which the ready set evolves only by the span's
own placements and by local-pump deliveries snapshotted up front as
cohorts — ``arrive[b]`` is the tick at which slot ``b`` joins the ready
pool.  Unplaced tasks re-enter the wait stack in visit order and drain
LIFO next tick, which the loop carry reproduces.  The ``[H, 4]``
availability, the wait-stack permutation and the resident-task counts
stay on the device between ticks; the caller stages the operands once
and fetches ``placements`` once.

**Bit-parity.**  Each tick runs the same two-phase kernel core as the
per-tick path (``ops/kernels.py`` ``*_impl``) on an identically ordered
task stream, so a span is bit-identical — placements, availability and
meter counts — to K single-tick dispatches in every ``phase2`` mode, to
:func:`reference_tick_run`, and on the CPU in float64 to
``pivot_tpu``'s ``fused_tick_run`` under x64.

**No host synchronisation on the card.**  The JAX loop is a
``while_loop`` with an early exit on a device-side ``done`` flag.  Here
the horizon ``n_ticks_dyn`` is a host int, the loop runs every tick of
it, and each state write is gated on a device-side ``alive`` flag exactly
as the JAX body gates dead rows under ``vmap``: ticks at or past
``ticks_run`` leave their rows at −1/0.  Each tick's pass takes its step
bound from the host, ``n_bound[k] = #{slots with arrive ≤ k}``, which is
at least that tick's ready count (a wait-stack slot always arrived
earlier).  So, with no read of the device between the caller's staging
copy and its fetch:

  * Opportunistic, First-Fit and Best-Fit in ``phase2="auto"``/
    ``"slim"`` run the slim pass with that bound (``"scan"`` walks the
    whole bucket and reads nothing either);
  * Cost-Aware with ``greedy`` given (the hand kernel,
    ``ops/cuda_kernels.py::cost_aware_cuda``, or anything with its
    contract) launches it once per tick with ``n_eff = n_bound[k]``.

Every other configuration reads the device once per tick or more: the
Cost-Aware arm through :func:`cost_aware_impl` (float64, learned score
exponents, ``realtime_bw`` is never a span) reads its control stream
once per tick, and any ``phase2=int`` reads its commit position once per
chunk.  On a dead tick the stream is all invalid, so the passes place
nothing and the kernel's steps are cheap.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from pivot_tpu_torch.ops.kernels import (
    _apply_live,
    best_fit_impl,
    cost_aware_impl,
    first_fit_impl,
    opportunistic_impl,
    resolve_device,
)

__all__ = [
    "RAGGED_AXES",
    "RAGGED_INVARIANT",
    "ResidentCarry",
    "SPAN_HOST_OPERANDS",
    "SpanResult",
    "edit_bucket",
    "fused_tick_run",
    "fused_tick_run_rows",
    "ragged_span_pad",
    "ragged_span_signature",
    "ragged_span_trim",
    "reference_tick_run",
    "resident_carry_clone",
    "resident_carry_export",
    "resident_carry_init",
    "resident_carry_restore",
    "resident_span_run",
    "span_bucket",
    "span_step_bounds",
]

#: Span-length buckets: the K axis of a span is padded to one of these.
_K_BUCKETS = (1, 2, 4, 8, 16, 32)


def span_bucket(k: int) -> int:
    """Smallest span bucket ≥ k."""
    for b in _K_BUCKETS:
        if k <= b:
            return b
    return ((k + 31) // 32) * 32


def span_step_bounds(arrive, n_ticks: int) -> list:
    """Host step bound of each tick: ``#{slots with arrive ≤ k}`` for
    ``k < n_ticks`` (``arrive`` a host array)."""
    arrive = np.sort(np.asarray(arrive))
    return np.searchsorted(arrive, np.arange(n_ticks), side="right").tolist()


# ---------------------------------------------------------------------------
# Span slot-axis algebra (``pivot_tpu/ops/tickloop.py:116-204``).  Integer
# work on the [B] slot axis only, along the last axis: one span's [B], or
# the [G, B] rows of :func:`fused_tick_run_rows`.
# ---------------------------------------------------------------------------


def _lexsort(keys, iota):
    """Indices that sort by ``keys`` (most significant first) along the
    last axis: successive stable sorts, least significant key first.
    Every sort this module makes ends with a key unique among active
    slots (the batch position), so the order of active slots is total and
    equals ``lax.sort``'s; inactive slots tie at the back, where their
    order changes no result.  Keys and ``iota`` share one shape: ``[B]``,
    or ``[R, B]`` to sort R rows at once (the ensemble rollout)."""
    perm = iota
    for key in reversed(keys):
        idx = torch.sort(key.gather(-1, perm), stable=True).indices
        perm = perm.gather(-1, idx)
    return perm


def _inverse(perm, iota):
    """``zeros.at[perm].set(iota)``: the inverse permutation (along the
    last axis)."""
    return torch.empty_like(perm).scatter_(-1, perm, iota)


def _span_ready_batch(arrive, k: int, stackpos, n_stack, big: int):
    """Tick ``k``'s ready batch: LIFO re-drain of the wait stack, then the
    tick's arriving cohort in delivery order.  One span's ``[B]`` slots
    with a 0-dim ``n_stack``, or G spans' ``[G, B]`` rows with ``n_stack``
    ``[G, 1]``.  Returns ``(batch_pos, in_batch bool, t_k)``, ``t_k``
    shaped like ``n_stack``."""
    arriving = arrive == k
    arr_rank = torch.cumsum(arriving, dim=-1) - 1
    in_stack = stackpos >= 0
    batch_pos = torch.where(
        in_stack, n_stack - 1 - stackpos,
        torch.where(arriving, n_stack + arr_rank, big),
    )
    in_batch = in_stack | arriving
    t_k = n_stack + arriving.sum(-1, keepdim=n_stack.dim() > 0)
    return batch_pos, in_batch, t_k


def _span_stream_order(policy, decreasing, sort_tasks, in_batch, batch_pos,
                       sort_norm, bucket_id, iota_b, big: int):
    """Kernel-stream order: batch order; norm-descending for the
    decreasing VBP arms (``sort_norm`` is the host-computed norm the
    per-tick sort keys on); for cost-aware, anchor buckets in first-seen
    batch order, batch-ordered or norm-descending within a bucket."""
    inactive = (~in_batch).to(torch.int64)
    if policy == "cost-aware":
        bf_bucket = torch.full(bucket_id.shape, big, dtype=batch_pos.dtype,
                               device=batch_pos.device).scatter_reduce(
            -1, bucket_id, torch.where(in_batch, batch_pos, big), "amin",
            include_self=False,
        )
        key3 = -sort_norm if sort_tasks else batch_pos
        return _lexsort((inactive, bf_bucket.gather(-1, bucket_id), key3,
                         batch_pos), iota_b)
    if decreasing:
        return _lexsort((inactive, -sort_norm, batch_pos), iota_b)
    return _lexsort((inactive, batch_pos), iota_b)


def _span_group_entries(bucket_id, order, iota_b):
    """Per-position group-entry flags of the permuted cost-aware stream."""
    b_p = bucket_id.gather(-1, order)
    return (iota_b == 0) | (b_p != torch.roll(b_p, 1, dims=-1))


def _span_requeue(decreasing, in_batch, placed, batch_pos, order, iota_b,
                  big: int):
    """Wait-stack rebuild: unplaced batch members re-enter in visit order
    (the kernel-stream order for the decreasing VBP arms, the batch order
    otherwise).  Returns ``(new_stackpos, new_n_stack)``: ``[B]`` and
    0-dim for one span, ``[G, B]`` and ``[G, 1]`` for G rows."""
    visit_pos = _inverse(order, iota_b) if decreasing else batch_pos
    unplaced = in_batch & ~placed
    srt = _lexsort((torch.where(unplaced, visit_pos, big),), iota_b)
    ranks = _inverse(srt, iota_b)
    return (torch.where(unplaced, ranks, -1),
            unplaced.sum(-1, keepdim=unplaced.dim() > 1))


class SpanResult(NamedTuple):
    """One span's outputs (K = tick bucket, B = slot bucket).

    ``placements`` rows are indexed by slot (tick-0 ready batch first in
    batch order, then cohorts in delivery order); −1 = unplaced that tick
    or not in its batch.  Rows at index ≥ ``ticks_run`` are provable
    no-ops (all −1): if ``n_stack_final`` > 0 the span stalled (those
    ticks still present ``n_stack_final`` ready tasks to the meter and
    place none), otherwise the pool drained."""

    placements: torch.Tensor  # [K, B] i32 host index per slot, −1 unplaced
    n_ready: torch.Tensor  # [K] i32 ready-batch size per executed tick
    n_placed: torch.Tensor  # [K] i32 placements per executed tick
    ticks_run: torch.Tensor  # 0-dim i32: ticks actually executed
    n_stack_final: torch.Tensor  # 0-dim i32: wait-stack size at exit
    stackpos: torch.Tensor  # [B] i32 final wait-stack position, −1 = out
    avail: torch.Tensor  # [H, 4] availability carry at exit


def _tick_cost(cost_zz, cost_stack, cost_seg, k: int):
    """Tick ``k``'s ``[Z, Z]`` cost operand: the static table, or the
    market's slice ``cost_stack[cost_seg[k]]`` taken with a host int."""
    if cost_stack is None:
        return cost_zz
    return cost_stack[int(cost_seg[k])]


def _cohort_ahead(n_bound, n_dyn: int) -> list:
    """Per tick ``k < n_dyn``: whether a cohort still arrives inside the
    horizon after tick ``k`` — a host fact, since ``n_bound`` counts the
    slots arrived by each tick."""
    n_in = n_bound[n_dyn - 1] if n_dyn else 0
    return [n < n_in for n in n_bound[:n_dyn]]


def _cost_aware_stream(avail, cum, order, dem_p, valid_p, bucket_id,
                       anchor_zone, cost, bw_zz, host_zone, base_task_counts,
                       iota):
    """A Cost-Aware span tick's pass operands in kernel-stream order, over
    one span's ``[B]`` slots or G spans' ``[G, B]`` rows: the stream, its
    group entries and anchor zones, the tick's cost table, and the base
    counts plus the span's own placements so far."""
    return (avail, dem_p, valid_p, _span_group_entries(bucket_id, order, iota),
            anchor_zone.gather(-1, order).to(torch.int32), cost, bw_zz,
            host_zone, base_task_counts + cum)


def _span_tick(k, state, out, alive, settle, place, policy, decreasing,
               sort_tasks, demands, arrive, sort_norm, bucket_id, iota,
               offset=None):
    """One span tick of :func:`fused_tick_run` (one span: ``[B]`` slots,
    0-dim flags) or :func:`fused_tick_run_rows` (G spans: ``[G, B]``
    rows, ``[G, 1]`` flags).  ``state`` is ``(done, stackpos, n_stack,
    avail, cum)``; ``out`` the ``(placements, n_ready, n_placed,
    ticks_run)`` buffers, tick ``k`` written in place.  ``alive`` gates
    every write, as the reference's body gates dead rows under ``vmap``;
    ``settle`` is False where a cohort still arrives inside the horizon;
    ``place(k, avail, cum, order, dem_p, valid_p)`` runs the tick's pass
    and returns ``(placements in stream order, availability)``.  On a
    host-sharded span (``ops/shard.py``) ``avail`` is ``[S, H/S, 4]``,
    ``cum`` ``[S, H/S]`` and ``offset`` the ``[S]`` first global host of
    each shard's block.  Returns the new state."""
    done, stackpos, n_stack, avail, cum = state
    big = 2 * iota.shape[-1] + 2  # > any real batch position
    # 1. This tick's ready batch.
    batch_pos, in_batch, t_k = _span_ready_batch(arrive, k, stackpos,
                                                 n_stack, big)
    # 2. Kernel-stream order.
    order = _span_stream_order(policy, decreasing, sort_tasks, in_batch,
                               batch_pos, sort_norm, bucket_id, iota, big)
    dem_p = demands.gather(
        -2, order[..., None].expand(order.shape + demands.shape[-1:]))
    # A dead tick presents an all-invalid stream: it places nothing.
    valid_p = in_batch.gather(-1, order) & alive
    # 3. One pass per tick.
    p_ord, new_avail = place(k, avail, cum, order, dem_p, valid_p)
    row = torch.empty_like(order, dtype=torch.int32).scatter_(
        -1, order, p_ord.to(torch.int32))
    placed = row >= 0
    n_placed = placed.sum(-1, keepdim=placed.dim() > 1).to(torch.int32)
    # 4. Wait-stack rebuild.
    new_stackpos, new_n_stack = _span_requeue(
        decreasing, in_batch, placed, batch_pos, order, iota, big)
    # 5. Span-cumulative resident-task counts (the host-decay base); a
    #    host-sharded span folds each placement into its owner's block.
    H = cum.shape[-1]
    mine, host = placed, row
    if offset is not None:
        host = row - offset[:, None]
        mine = placed & (host >= 0) & (host < H)
    # graftcheck: ignore[determinism] -- int32 counts: exact in any order
    cum_new = torch.zeros(cum.shape[:-1] + (H + 1,), dtype=torch.int32,
                          device=cum.device).scatter_add_(
        -1, torch.where(mine, host, H).long(), mine.to(torch.int32)
    )[..., :H] + cum
    # 6. Provable-no-op exit: no cohort ahead and nothing left or nothing
    #    placed (availability only decreases inside a span).
    done_new = ((new_n_stack == 0) | (n_placed == 0)) & settle
    p_out, nr_out, np_out, ticks_run = out
    p_out[..., k, :] = torch.where(alive, row, -1)
    nr_out[..., k] = torch.where(alive, t_k, 0).view(nr_out.shape[:-1])
    np_out[..., k] = torch.where(alive, n_placed, 0).view(np_out.shape[:-1])
    ticks_run += alive.view(ticks_run.shape)
    return (torch.where(alive, done_new, done),
            torch.where(alive, new_stackpos, stackpos),
            torch.where(alive, new_n_stack, n_stack),
            torch.where(alive[..., None], new_avail, avail),
            torch.where(alive, cum_new, cum))


def fused_tick_run(
    avail,
    demands,
    arrive,
    n_ticks_dyn: int,
    *,
    policy: str,
    n_ticks: int,
    n_bound: Optional[Sequence[int]] = None,
    uniforms=None,
    sort_norm=None,
    anchor_zone=None,
    bucket_id=None,
    cost_zz=None,
    bw_zz=None,
    host_zone=None,
    base_task_counts=None,
    totals=None,
    live=None,
    risk_rows=None,
    cost_stack=None,
    cost_seg=None,
    score_exp=None,
    greedy=None,
    strict: bool = False,
    decreasing: bool = False,
    bin_pack: str = "first-fit",
    sort_tasks: bool = False,
    sort_hosts: bool = True,
    host_decay: bool = False,
    phase2="auto",
) -> SpanResult:
    """Run up to ``n_ticks_dyn`` scheduling ticks on the device.

    Inputs (B = slot bucket, K = ``n_ticks`` span bucket, H hosts), all
    tensors on one device:
      avail            [H, 4]  availability carry at span start
      demands          [B, 4]  per-slot demand (pad slots get
                               ``arrive >= n_ticks``)
      arrive           [B] i32 tick index at which each slot joins the pool
      n_ticks_dyn      host int, the span horizon (≤ ``n_ticks``)
      n_bound          host step bound per tick (:func:`span_step_bounds`
                       of the host ``arrive``); None reads ``arrive`` to
                       the host once
      uniforms         [K, B]  positional Philox draws (opportunistic)
      sort_norm        [B]     host-computed demand L2 norms (decreasing /
                               ``sort_tasks`` arms)
      anchor_zone      [B] i32 per-slot anchor zone (cost-aware)
      bucket_id        [B] i32 per-slot anchor-bucket identity < B
      cost_zz/bw_zz/host_zone/base_task_counts/totals — the cost-aware
                       topology operands (``DeviceTopology``)
      live             [H] bool span-constant quarantine mask (or None)
      risk_rows        [K, H]  per-tick eviction-risk rows (or None)
      cost_stack       [P, Z, Z] price-scaled egress-cost tensor (a spot
                       market, or None): cost-aware tick k scores with
                       ``cost_stack[cost_seg[k]]`` in place of ``cost_zz``
      cost_seg         [K] host ints, each tick's segment of
                       ``cost_stack`` (known on the host: indexing with
                       them reads nothing from the device)
      score_exp        [3]     learned score exponents (or None)
      greedy           cost-aware only: a callable with the contract of
                       ``cost_aware_cuda`` that serves each tick (the
                       live mask is folded into the carry, so it gets
                       ``live=None``); None runs ``cost_aware_impl``

    Static config mirrors the per-tick kernels.  Returns a
    :class:`SpanResult`; bit-identical to :func:`reference_tick_run` on
    the same inputs.
    """
    B, H = demands.shape[0], avail.shape[0]
    K = n_ticks
    dev = avail.device
    if n_bound is None:
        n_bound = span_step_bounds(arrive.cpu().numpy(), n_ticks_dyn)
    avail, restore = _apply_live(avail, live)
    arrive = arrive.long()
    iota_b = torch.arange(B, device=dev)
    if bucket_id is not None:
        bucket_id = bucket_id.long()
    i32 = dict(dtype=torch.int32, device=dev)
    state = (torch.zeros((), dtype=torch.bool, device=dev),  # done
             torch.full((B,), -1, dtype=torch.int64, device=dev),  # stackpos
             torch.zeros((), dtype=torch.int64, device=dev),  # n_stack
             avail, torch.zeros((H,), **i32))  # avail, cum
    out = (torch.full((K, B), -1, **i32), torch.zeros((K,), **i32),
           torch.zeros((K,), **i32), torch.zeros((), **i32))
    ahead = _cohort_ahead(n_bound, n_ticks_dyn)

    def place(k, avail, cum, order, dem_p, valid_p):
        risk_k = None if risk_rows is None else risk_rows[k]
        if policy == "opportunistic":
            return opportunistic_impl(avail, dem_p, valid_p, uniforms[k],
                                      phase2=phase2, risk=risk_k,
                                      n_bound=n_bound[k])
        if policy == "first-fit":
            return first_fit_impl(avail, dem_p, valid_p, strict=strict,
                                  totals=totals, phase2=phase2, risk=risk_k,
                                  n_bound=n_bound[k])
        if policy == "best-fit":
            return best_fit_impl(avail, dem_p, valid_p, totals=totals,
                                 phase2=phase2, risk=risk_k,
                                 n_bound=n_bound[k])
        if policy != "cost-aware":
            raise ValueError(f"unknown span policy {policy!r}")
        ca_args = _cost_aware_stream(
            avail, cum, order, dem_p, valid_p, bucket_id, anchor_zone,
            _tick_cost(cost_zz, cost_stack, cost_seg, k), bw_zz, host_zone,
            base_task_counts, iota_b)
        mode = dict(bin_pack=bin_pack, sort_hosts=sort_hosts,
                    host_decay=host_decay, risk=risk_k)
        if greedy is not None:
            return greedy(*ca_args, **mode, live=None, n_eff=n_bound[k])
        return cost_aware_impl(*ca_args, **mode, totals=totals,
                               phase2=phase2, score_exp=score_exp)

    for k in range(n_ticks_dyn):
        state = _span_tick(k, state, out, ~state[0], not ahead[k], place,
                           policy, decreasing, sort_tasks, demands, arrive,
                           sort_norm, bucket_id, iota_b)
    _done, stackpos, n_stack, avail, _cum = state
    return SpanResult(*out, n_stack.to(torch.int32),
                      stackpos.to(torch.int32), restore(avail))


def _host_table(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host int table on ``device``, copied from pinned memory
    without a synchronising copy (the caching host allocator keeps the
    buffer until the copy has run)."""
    t = torch.from_numpy(arr)  # graftcheck: ignore[dtype] -- every caller's table is np.int32 by construction
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _stack_spans(results: Sequence[SpanResult]) -> SpanResult:
    """G one-span results as one result with a leading ``[G]`` axis."""
    return SpanResult(*(torch.stack(f) for f in zip(*results)))


def fused_tick_run_rows(
    avail,
    demands,
    arrive,
    n_ticks_dyn: Sequence[int],
    *,
    policy: str,
    n_ticks: int,
    n_bound: Optional[Sequence[Sequence[int]]] = None,
    uniforms=None,
    sort_norm=None,
    anchor_zone=None,
    bucket_id=None,
    cost_zz=None,
    bw_zz=None,
    host_zone=None,
    base_task_counts=None,
    totals=None,
    live=None,
    risk_rows=None,
    cost_stack=None,
    cost_seg=None,
    score_exp=None,
    greedy=None,
    strict: bool = False,
    decreasing: bool = False,
    bin_pack: str = "first-fit",
    sort_tasks: bool = False,
    sort_hosts: bool = True,
    host_decay: bool = False,
    phase2="auto",
) -> SpanResult:
    """G independent spans in one call: what ``jax.vmap(fused_tick_run)``
    computes when the reference's batcher stacks span requests
    (``pivot_tpu/sched/batch.py:118-168``, ``_batched_fn``).

    Every operand of :func:`fused_tick_run` gains a leading ``[G]`` row
    axis (``avail`` [G, H, 4], ``demands`` [G, B, 4], ``arrive`` [G, B],
    ``cost_stack`` [G, P, Z, Z], …); ``n_ticks_dyn`` is each row's host
    horizon, ``n_bound`` each row's host step bounds
    (:func:`span_step_bounds` of its host ``arrive``; None reads
    ``arrive`` to the host once) and ``cost_seg`` each row's host
    segment row ([G, K]).  Row ``g`` of the result is
    :func:`fused_tick_run` on row ``g`` of every operand.

    Cost-Aware with ``greedy`` — a per-row pass with the contract of
    ``ops/cuda_kernels.py::cost_aware_cuda_rows`` — runs the slot
    algebra over ``[G, B]`` and serves each tick with ONE call of
    ``greedy`` over the G rows: each row's stream in stream order,
    ``base_task_counts + cum``, its tick cost table, its risk row and
    ``n_eff_g[g] = n_bound[g][k]``.  The loop runs the longest row's
    horizon; a row past its own horizon is dead and its step bound is 0.
    Every bound is a host fact, copied to the device once before the
    loop, so the loop reads nothing from the device.  Every other
    configuration (the torch arms, Cost-Aware through
    ``cost_aware_impl``) runs its rows one after another through
    :func:`fused_tick_run`: bit-identical by construction."""
    # graftcheck: ignore[host-sync] -- the rows' horizons are host ints, read before the loop
    n_dyn = [int(x) for x in np.asarray(n_ticks_dyn).reshape(-1)]
    G = len(n_dyn)
    if n_bound is None:
        # graftcheck: ignore[host-sync] -- a caller without host step bounds pays one read of arrive before the loop, none inside it
        arr_host = arrive.cpu().numpy()
        n_bound = [span_step_bounds(arr_host[g], n_dyn[g]) for g in range(G)]
    static = dict(policy=policy, n_ticks=n_ticks, strict=strict,
                  decreasing=decreasing, bin_pack=bin_pack,
                  sort_tasks=sort_tasks, sort_hosts=sort_hosts,
                  host_decay=host_decay, phase2=phase2)
    operands = dict(uniforms=uniforms, sort_norm=sort_norm,
                    anchor_zone=anchor_zone, bucket_id=bucket_id,
                    cost_zz=cost_zz, bw_zz=bw_zz, host_zone=host_zone,
                    base_task_counts=base_task_counts, totals=totals,
                    live=live, risk_rows=risk_rows, cost_stack=cost_stack,
                    cost_seg=cost_seg, score_exp=score_exp)
    if policy != "cost-aware" or greedy is None:
        return _stack_spans([
            fused_tick_run(avail[g], demands[g], arrive[g], n_dyn[g],
                           n_bound=n_bound[g], **static,
                           **{k: None if v is None else v[g]
                              for k, v in operands.items()})
            for g in range(G)
        ])

    B, H = demands.shape[1], avail.shape[1]
    K = n_ticks
    dev = avail.device
    n_loop = max(n_dyn, default=0)
    # Per tick and row: the step bound (0 past the row's horizon), inside
    # the horizon, a cohort still ahead, the tick's cost segment.
    tab = np.zeros((4, n_loop, G), dtype=np.int32)
    for g, nd in enumerate(n_dyn):
        if nd:
            tab[0, :nd, g] = n_bound[g][:nd]
            tab[1, :nd, g] = 1
            tab[2, :nd, g] = _cohort_ahead(n_bound[g], nd)
            if cost_stack is not None:
                # graftcheck: ignore[host-sync] -- cost_seg is a host operand (SPAN_HOST_OPERANDS), tabled before the loop
                tab[3, :nd, g] = np.asarray(cost_seg[g])[:nd]
    tab = _host_table(tab, dev)
    bounds, in_horizon, ahead = tab[0], tab[1] != 0, tab[2] != 0
    costs = (None if cost_stack is None else
             cost_stack[torch.arange(G, device=dev), tab[3].long()])
    risk_kg = (None if risk_rows is None
               else risk_rows.transpose(0, 1).contiguous())
    avail, restore = _apply_live(avail, live)
    arrive = arrive.long()
    bucket_id = bucket_id.long()
    iota = torch.arange(B, device=dev).expand(G, B)
    i32 = dict(dtype=torch.int32, device=dev)
    state = (torch.zeros((G, 1), dtype=torch.bool, device=dev),  # done
             torch.full((G, B), -1, dtype=torch.int64, device=dev),
             torch.zeros((G, 1), dtype=torch.int64, device=dev),  # n_stack
             avail, torch.zeros((G, H), **i32))  # avail, cum
    out = (torch.full((G, K, B), -1, **i32), torch.zeros((G, K), **i32),
           torch.zeros((G, K), **i32), torch.zeros((G,), **i32))
    mode = dict(bin_pack=bin_pack, sort_hosts=sort_hosts,
                host_decay=host_decay)

    def place(k, avail, cum, order, dem_p, valid_p):
        return greedy(*_cost_aware_stream(
            avail, cum, order, dem_p, valid_p, bucket_id, anchor_zone,
            cost_zz if costs is None else costs[k], bw_zz, host_zone,
            base_task_counts, iota), **mode, live=None,
            risk=None if risk_kg is None else risk_kg[k], n_eff_g=bounds[k])

    for k in range(n_loop):
        state = _span_tick(k, state, out, ~state[0] & in_horizon[k][:, None],
                           ~ahead[k][:, None], place, policy, decreasing,
                           sort_tasks, demands, arrive, sort_norm, bucket_id,
                           iota)
    _done, stackpos, n_stack, avail, _cum = state
    return SpanResult(*out, n_stack[:, 0].to(torch.int32),
                      stackpos.to(torch.int32), restore(avail))


# ---------------------------------------------------------------------------
# Resident span carries (``pivot_tpu/ops/tickloop.py:574-878``).
#
# The span carry — availability, per-host task counts, live mask — stays
# on the device between consecutive spans, and each span takes a small
# host-built delta: sparse host-row edits (from the caller's mirror-diff;
# pad entries carry index H and are dropped), the per-span slot operands,
# and a [K] market-segment row gathered against a once-staged [P, H] risk
# table.  Torch has no buffer donation: a carry passed to
# :func:`resident_span_run` is consumed by contract (the caller uses the
# returned one), every function here returns tensors of its own, and
# ``init`` / ``restore`` copy, so a carry never aliases the caller's
# numpy.  A mid-span splice re-runs the whole span from a clone of the
# span-entry carry with the new slots joined at ``arrive = k``.
# ---------------------------------------------------------------------------

#: Edit-row buckets: the edit operands pad to one of these.  0 = no edit.
_EDIT_BUCKETS = (0, 8, 32, 128, 512)


def edit_bucket(n: int) -> int:
    """Smallest edit-row bucket ≥ n."""
    for b in _EDIT_BUCKETS:
        if n <= b:
            return b
    return ((n + 511) // 512) * 512


class ResidentCarry(NamedTuple):
    """Device-resident span state carried between consecutive spans.
    ``live`` is always materialized: an all-True mask is bitwise identity
    through ``_apply_live``."""

    avail: torch.Tensor  # [H, 4] availability
    counts: torch.Tensor  # [H] i32 resident-task counts (cost-aware decay)
    live: torch.Tensor  # [H] bool quarantine mask (all-True when unused)


def _owned(x, device, dtype=None) -> torch.Tensor:
    """A tensor of ``x`` on ``device`` in memory of its own (never a view
    of the caller's array or tensor)."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype or x.dtype, copy=True)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def resident_carry_init(avail, counts=None, live=None, *,
                        device=None) -> ResidentCarry:
    """A :class:`ResidentCarry` copied from host (or device) state:
    ``counts`` defaults to zeros, ``live`` to all-True.  ``device``
    defaults to ``avail``'s for a tensor and to ``cuda`` for host arrays
    (``cuda`` without a card raises)."""
    if device is None:
        device = avail.device if torch.is_tensor(avail) else "cuda"
    device = resolve_device(device)
    avail = _owned(avail, device)
    H = avail.shape[0]
    counts = (torch.zeros((H,), dtype=torch.int32, device=device)
              if counts is None else _owned(counts, device, torch.int32))
    live = (torch.ones((H,), dtype=torch.bool, device=device)
            if live is None else _owned(live, device, torch.bool))
    return ResidentCarry(avail, counts, live)


def resident_carry_clone(carry: ResidentCarry) -> ResidentCarry:
    """An independent copy of ``carry`` (a splice checkpoint)."""
    return ResidentCarry(*(t.clone() for t in carry))


def resident_carry_export(carry: ResidentCarry) -> dict:
    """Host numpy copies of a carry's buffers."""
    return {name: t.to("cpu", copy=True).numpy()
            for name, t in zip(ResidentCarry._fields, carry)}


def resident_carry_restore(avail, counts, live, *,
                           device=None) -> ResidentCarry:
    """A carry re-made from exported host arrays (copied, as
    :func:`resident_carry_init`)."""
    return resident_carry_init(avail, counts=counts, live=live,
                               device=device)


def _set_rows(x, idx, rows):
    """``x.at[idx].set(rows, mode="drop")`` for indices in ``[0, H]``:
    rows aimed at index H land in a scratch row that is cut away."""
    ext = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return ext.index_copy_(0, idx.long(), rows.to(x.dtype))[:-1]


def resident_span_run(
    carry: ResidentCarry,
    demands,
    arrive,
    n_ticks_dyn: int,
    *,
    policy: str,
    n_ticks: int,
    n_bound: Optional[Sequence[int]] = None,
    edit_idx=None,
    edit_avail=None,
    edit_counts=None,
    edit_live=None,
    uniforms=None,
    sort_norm=None,
    anchor_zone=None,
    bucket_id=None,
    cost_zz=None,
    bw_zz=None,
    host_zone=None,
    totals=None,
    risk_table=None,
    risk_seg=None,
    cost_stack=None,
    cost_seg=None,
    score_exp=None,
    greedy=None,
    strict: bool = False,
    decreasing: bool = False,
    bin_pack: str = "first-fit",
    sort_tasks: bool = False,
    sort_hosts: bool = True,
    host_decay: bool = False,
    phase2="auto",
):
    """One span against a resident carry
    (``pivot_tpu/ops/tickloop.py:787-877``).

      carry        ResidentCarry — consumed: use the returned carry next
      edit_idx     [E] i32 host rows to repair before the span (pad
                   entries = H, dropped), or None
      edit_avail   [E, 4] replacement availability rows
      edit_counts  [E] i32 replacement task counts
      edit_live    [E] bool replacement mask entries
      risk_table   [P, H] per-market-segment risk rows (or None)
      risk_seg     [K] i32 device segment row into ``risk_table`` (or
                   None: no risk this span)

    The slot operands, ``n_bound``, ``cost_seg`` (host ints), ``greedy``
    and the static configuration are :func:`fused_tick_run`'s;
    ``base_task_counts`` and ``live`` come from the carry.  The span's
    own placements fold into the carry's counts (a ``scatter_add_``
    histogram), so a steady state needs no edit rows.  Returns
    ``(SpanResult, ResidentCarry)``, the result equal to
    :func:`fused_tick_run` on the post-edit state."""
    avail, counts, live = carry
    H = avail.shape[0]
    if edit_idx is not None:
        avail = _set_rows(avail, edit_idx, edit_avail)
        counts = _set_rows(counts, edit_idx, edit_counts)
        live = _set_rows(live, edit_idx, edit_live)
    else:
        live = live.clone()
    risk_rows = (None if risk_seg is None
                 else risk_table.index_select(0, risk_seg.long()))
    res = fused_tick_run(
        avail, demands, arrive, n_ticks_dyn, policy=policy, n_ticks=n_ticks,
        n_bound=n_bound, uniforms=uniforms, sort_norm=sort_norm,
        anchor_zone=anchor_zone, bucket_id=bucket_id, cost_zz=cost_zz,
        bw_zz=bw_zz, host_zone=host_zone, base_task_counts=counts,
        totals=totals, live=live, risk_rows=risk_rows,
        cost_stack=cost_stack, cost_seg=cost_seg, score_exp=score_exp,
        greedy=greedy, strict=strict, decreasing=decreasing,
        bin_pack=bin_pack, sort_tasks=sort_tasks, sort_hosts=sort_hosts,
        host_decay=host_decay, phase2=phase2,
    )
    placed = res.placements >= 0
    tgt = torch.where(placed, res.placements, H).reshape(-1).long()
    # graftcheck: ignore[determinism] -- int32 counts: exact in any order
    hist = torch.zeros((H + 1,), dtype=torch.int32,
                       device=counts.device).scatter_add_(
        0, tgt, placed.reshape(-1).to(torch.int32))[:H]
    return res, ResidentCarry(res.avail, counts + hist, live)


def reference_tick_run(
    avail,
    demands,
    arrive,
    n_ticks: int,
    *,
    policy: str,
    uniforms=None,
    sort_norm=None,
    anchor_zone=None,
    bucket_id=None,
    cost_zz=None,
    bw_zz=None,
    host_zone=None,
    base_task_counts=None,
    totals=None,
    live=None,
    risk_rows=None,
    cost_stack=None,
    cost_seg=None,
    score_exp=None,
    greedy=None,
    strict: bool = False,
    decreasing: bool = False,
    bin_pack: str = "first-fit",
    sort_tasks: bool = False,
    sort_hosts: bool = True,
    host_decay: bool = False,
    phase2="auto",
):
    """Sequential referee for :func:`fused_tick_run`: the same span
    semantics driven tick by tick with one public kernel call per tick
    (``*_impl``, or ``greedy`` for cost-aware) and the wait-stack algebra
    in plain Python.  Returns ``(placements [K, B] i64, n_ready [K],
    n_placed [K], avail [H, 4])`` as host numpy, the no-op tail rows
    materialized."""
    B = demands.shape[0]
    dev = avail.device
    arrive = arrive.cpu().numpy()
    placements = np.full((n_ticks, B), -1, dtype=np.int64)
    n_ready = np.zeros(n_ticks, dtype=np.int64)
    n_placed = np.zeros(n_ticks, dtype=np.int64)
    dem_host = demands.cpu().numpy()
    bucket = None if bucket_id is None else bucket_id.cpu().numpy()
    norm = None if sort_norm is None else sort_norm.cpu().numpy()
    cum = np.zeros(avail.shape[0], dtype=np.int32)
    stack: list = []

    def put(x):
        # graftcheck: ignore[dtype] -- the sequential referee keeps each host operand's own dtype (the caller's policy dtype)
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    for k in range(n_ticks):
        batch = list(reversed(stack)) + [
            int(b) for b in np.flatnonzero(arrive == k)]
        if not batch:
            continue
        n_ready[k] = len(batch)
        if policy == "cost-aware":
            first_seen: dict = {}
            for pos, b in enumerate(batch):
                first_seen.setdefault(int(bucket[b]), pos)
            key = ((lambda pos: (first_seen[int(bucket[batch[pos]])],
                                 -float(norm[batch[pos]]), pos))
                   if sort_tasks else
                   (lambda pos: (first_seen[int(bucket[batch[pos]])], pos)))
            order = [batch[pos] for pos in sorted(range(len(batch)),
                                                  key=key)]
        elif decreasing:
            order = sorted(batch, key=lambda b: -float(norm[b]))
        else:
            order = batch
        dem_p = np.zeros_like(dem_host)
        dem_p[: len(order)] = dem_host[order]
        valid_p = np.zeros(B, dtype=bool)
        valid_p[: len(order)] = True
        dem_t, valid_t = put(dem_p), put(valid_p)
        kw = dict(live=live)
        if risk_rows is not None:
            kw["risk"] = risk_rows[k]
        if policy == "opportunistic":
            p_ord, avail = opportunistic_impl(avail, dem_t, valid_t,
                                              uniforms[k], phase2=phase2,
                                              **kw)
        elif policy == "first-fit":
            p_ord, avail = first_fit_impl(avail, dem_t, valid_t,
                                          strict=strict, totals=totals,
                                          phase2=phase2, **kw)
        elif policy == "best-fit":
            p_ord, avail = best_fit_impl(avail, dem_t, valid_t,
                                         totals=totals, phase2=phase2, **kw)
        else:
            az_p = np.zeros(B, dtype=np.int32)
            az_p[: len(order)] = anchor_zone.cpu().numpy()[order]
            ng_p = np.zeros(B, dtype=bool)
            prev = None
            for j, b in enumerate(order):
                ng_p[j] = prev is None or int(bucket[b]) != prev
                prev = int(bucket[b])
            ca_args = (avail, dem_t, valid_t, put(ng_p), put(az_p),
                       _tick_cost(cost_zz, cost_stack, cost_seg, k), bw_zz,
                       host_zone, base_task_counts + put(cum))
            mode = dict(bin_pack=bin_pack, sort_hosts=sort_hosts,
                        host_decay=host_decay, **kw)
            if greedy is not None:
                p_ord, avail = greedy(*ca_args, **mode, n_eff=len(order))
            else:
                p_ord, avail = cost_aware_impl(*ca_args, **mode,
                                               totals=totals, phase2=phase2,
                                               score_exp=score_exp)
        p_host = p_ord.cpu().numpy()
        for j, b in enumerate(order):
            placements[k, b] = p_host[j]
        visit = order if decreasing else batch
        stack = [b for b in visit if placements[k, b] < 0]
        placed_hosts = [int(placements[k, b]) for b in order
                        if placements[k, b] >= 0]
        np.add.at(cum, placed_hosts, 1)
        n_placed[k] = len(placed_hosts)
    return placements, n_ready, n_placed, avail.cpu().numpy()


# ---------------------------------------------------------------------------
# Ragged span repack (``pivot_tpu/ops/tickloop.py:1063-1160``): host numpy
# in, host numpy out.  Co-pending span requests whose shapes differ only in
# their (K, B) buckets pad to one (K′, B′) and ride one device call; each
# result is sliced back.  The padded tails are inert: a row's loop ends at
# its own ``n_ticks_dyn`` (so K-tail rows of the per-tick streams are never
# read), and a pad slot arrives at K′ ≥ ``n_ticks_dyn``, so it never joins
# a ready batch and sorts after every active slot.
# ---------------------------------------------------------------------------

#: Array operand → (K axis, B axis) the ragged repack pads (None = the
#: operand lacks that axis).
RAGGED_AXES = {
    "uniforms": (0, 1),
    "risk_rows": (0, None),
    "cost_seg": (0, None),
    "sort_norm": (None, 0),
    "anchor_zone": (None, 0),
    "bucket_id": (None, 0),
}

#: Span operands with no K or B axis: stacked per row, never padded.
RAGGED_INVARIANT = frozenset({
    "cost_zz", "bw_zz", "host_zone", "base_task_counts", "totals",
    "live", "cost_stack", "score_exp",
})

#: Span operands read on the host (each tick's market segment, indexed
#: with host ints): a flush keeps them on the host instead of staging.
SPAN_HOST_OPERANDS = frozenset({"cost_seg"})


def ragged_span_signature(args, arr_kw, static_kw):
    """Coalescing key for mixed-horizon span requests: the request key
    with the span bucket K (the ``n_ticks`` static) and the slot-bucket
    width B normalized out.  None when the operands do not have the span
    family's layout."""
    if len(args) != 4:
        return None
    avail, demands, arrive, _n_dyn = args
    if (
        getattr(avail, "ndim", None) != 2
        or getattr(demands, "ndim", None) != 2
        or getattr(arrive, "ndim", None) != 1
        or "n_ticks" not in static_kw
    ):
        return None
    for name in arr_kw:
        if name not in RAGGED_AXES and name not in RAGGED_INVARIANT:
            return None
    statics = tuple(sorted(
        (k, v) for k, v in static_kw.items() if k != "n_ticks"
    ))
    names = tuple(sorted(arr_kw))
    dtypes = tuple(str(arr_kw[n].dtype) for n in names)
    invariant_shapes = tuple(
        tuple(arr_kw[n].shape) for n in names if n in RAGGED_INVARIANT
    )
    return (
        tuple(avail.shape), str(avail.dtype), str(demands.dtype),
        str(arrive.dtype), names, dtypes, invariant_shapes, statics,
    )


def _ragged_pad_to(arr, shape):
    out = np.zeros(shape, arr.dtype)
    out[tuple(slice(0, s) for s in arr.shape)] = arr
    return out


def ragged_span_pad(args, arr_kw, k2: int, b2: int):
    """Pad one host span request from its own (K, B) buckets to the
    merged ``(k2, b2)``: new pad slots arrive at ``k2`` and every K / B
    tail is zero-filled.  Returns ``(args, arr_kw)``; operands already at
    the target shape pass through untouched."""
    avail, demands, arrive, n_ticks_dyn = args
    b = demands.shape[0]
    if b != b2:
        demands = _ragged_pad_to(demands, (b2,) + demands.shape[1:])
        arr2 = np.full((b2,), k2, arrive.dtype)
        arr2[:b] = arrive
        arrive = arr2
    out_kw = {}
    for name, v in arr_kw.items():
        k_ax, b_ax = RAGGED_AXES.get(name, (None, None))
        shape = list(v.shape)
        if k_ax is not None:
            shape[k_ax] = k2
        if b_ax is not None:
            shape[b_ax] = b2
        shape = tuple(shape)
        out_kw[name] = v if shape == v.shape else _ragged_pad_to(v, shape)
    return (avail, demands, arrive, n_ticks_dyn), out_kw


def ragged_span_trim(res: SpanResult, k: int, b: int) -> SpanResult:
    """Slice a merged-bucket :class:`SpanResult` back to the request's own
    (K, B) buckets; the scalars and the [H, 4] carry are exact already."""
    return SpanResult(
        placements=res.placements[:k, :b],
        n_ready=res.n_ready[:k],
        n_placed=res.n_placed[:k],
        ticks_run=res.ticks_run,
        n_stack_final=res.n_stack_final,
        stackpos=res.stackpos[:b],
        avail=res.avail,
    )
