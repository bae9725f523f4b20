"""Multi-tick scheduler driver: K scheduling ticks as one device program.

Port of ``pivot_tpu/ops/tickloop.py`` (``span_bucket``, the slot algebra,
``SpanResult``, ``fused_tick_run`` and the sequential referee
``reference_tick_run``; the ragged pad/trim, edit buckets and resident
carry are not ported yet).

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
)

__all__ = [
    "SpanResult",
    "fused_tick_run",
    "reference_tick_run",
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
# work on the replicated [B] slot axis only.
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
    tick's arriving cohort in delivery order.  Returns ``(batch_pos [B],
    in_batch [B] bool, t_k 0-dim)``."""
    arriving = arrive == k
    arr_rank = torch.cumsum(arriving, dim=0) - 1
    in_stack = stackpos >= 0
    batch_pos = torch.where(
        in_stack, n_stack - 1 - stackpos,
        torch.where(arriving, n_stack + arr_rank, big),
    )
    in_batch = in_stack | arriving
    t_k = n_stack + arriving.sum()
    return batch_pos, in_batch, t_k


def _span_stream_order(policy, decreasing, sort_tasks, in_batch, batch_pos,
                       sort_norm, bucket_id, iota_b, big: int):
    """Kernel-stream order: batch order; norm-descending for the
    decreasing VBP arms (``sort_norm`` is the host-computed norm the
    per-tick sort keys on); for cost-aware, anchor buckets in first-seen
    batch order, batch-ordered or norm-descending within a bucket."""
    inactive = (~in_batch).to(torch.int64)
    if policy == "cost-aware":
        B = iota_b.shape[0]
        bf_bucket = torch.full((B,), big, dtype=batch_pos.dtype,
                               device=batch_pos.device).scatter_reduce(
            0, bucket_id, torch.where(in_batch, batch_pos, big), "amin",
            include_self=False,
        )
        key3 = -sort_norm if sort_tasks else batch_pos
        return _lexsort((inactive, bf_bucket[bucket_id], key3, batch_pos),
                        iota_b)
    if decreasing:
        return _lexsort((inactive, -sort_norm, batch_pos), iota_b)
    return _lexsort((inactive, batch_pos), iota_b)


def _span_group_entries(bucket_id, order, iota_b):
    """Per-position group-entry flags of the permuted cost-aware stream."""
    b_p = bucket_id[order]
    return (iota_b == 0) | (b_p != torch.roll(b_p, 1))


def _span_requeue(decreasing, in_batch, placed, batch_pos, order, iota_b,
                  big: int):
    """Wait-stack rebuild: unplaced batch members re-enter in visit order
    (the kernel-stream order for the decreasing VBP arms, the batch order
    otherwise).  Returns ``(new_stackpos [B], new_n_stack 0-dim)``."""
    visit_pos = _inverse(order, iota_b) if decreasing else batch_pos
    unplaced = in_batch & ~placed
    srt = _lexsort((torch.where(unplaced, visit_pos, big),), iota_b)
    ranks = _inverse(srt, iota_b)
    return torch.where(unplaced, ranks, -1), unplaced.sum()


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
    big = 2 * B + 2  # > any real batch position
    if bucket_id is not None:
        bucket_id = bucket_id.long()
    i32 = dict(dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    stackpos = torch.full((B,), -1, dtype=torch.int64, device=dev)
    n_stack = torch.zeros((), dtype=torch.int64, device=dev)
    cum = torch.zeros((H,), **i32)
    p_out = torch.full((K, B), -1, **i32)
    nr_out = torch.zeros((K,), **i32)
    np_out = torch.zeros((K,), **i32)
    ticks_run = torch.zeros((), **i32)
    # Whether a cohort still arrives inside the horizon after tick k: a
    # host fact, since n_bound counts the slots arrived by each tick.
    n_in = n_bound[n_ticks_dyn - 1] if n_ticks_dyn else 0
    future = [n < n_in for n in n_bound[:n_ticks_dyn]]

    for k in range(n_ticks_dyn):
        alive = ~done
        # 1. This tick's ready batch.
        batch_pos, in_batch, t_k = _span_ready_batch(
            arrive, k, stackpos, n_stack, big)
        # 2. Kernel-stream order.
        order = _span_stream_order(policy, decreasing, sort_tasks, in_batch,
                                   batch_pos, sort_norm, bucket_id, iota_b,
                                   big)
        dem_p = demands[order]
        # A dead tick presents an all-invalid stream: it places nothing.
        valid_p = in_batch[order] & alive
        risk_k = None if risk_rows is None else risk_rows[k]
        # 3. One two-phase kernel core per tick.
        if policy == "opportunistic":
            p_ord, new_avail = opportunistic_impl(
                avail, dem_p, valid_p, uniforms[k], phase2=phase2,
                risk=risk_k, n_bound=n_bound[k])
        elif policy == "first-fit":
            p_ord, new_avail = first_fit_impl(
                avail, dem_p, valid_p, strict=strict, totals=totals,
                phase2=phase2, risk=risk_k, n_bound=n_bound[k])
        elif policy == "best-fit":
            p_ord, new_avail = best_fit_impl(
                avail, dem_p, valid_p, totals=totals, phase2=phase2,
                risk=risk_k, n_bound=n_bound[k])
        elif policy == "cost-aware":
            ng_p = _span_group_entries(bucket_id, order, iota_b)
            ca_args = (avail, dem_p, valid_p, ng_p,
                       anchor_zone[order].to(torch.int32),
                       _tick_cost(cost_zz, cost_stack, cost_seg, k), bw_zz,
                       host_zone, base_task_counts + cum)
            mode = dict(bin_pack=bin_pack, sort_hosts=sort_hosts,
                        host_decay=host_decay, risk=risk_k)
            if greedy is not None:
                p_ord, new_avail = greedy(*ca_args, **mode, live=None,
                                          n_eff=n_bound[k])
            else:
                p_ord, new_avail = cost_aware_impl(
                    *ca_args, **mode, totals=totals, phase2=phase2,
                    score_exp=score_exp)
        else:
            raise ValueError(f"unknown span policy {policy!r}")
        row = torch.empty((B,), **i32).scatter_(0, order,
                                                p_ord.to(torch.int32))
        placed = row >= 0
        n_placed = placed.sum().to(torch.int32)

        # 4. Wait-stack rebuild.
        new_stackpos, new_n_stack = _span_requeue(
            decreasing, in_batch, placed, batch_pos, order, iota_b, big)

        # 5. Span-cumulative resident-task counts (the host-decay base).
        cum_new = torch.zeros((H + 1,), **i32).scatter_add_(
            0, torch.where(placed, row, H).long(), placed.to(torch.int32)
        )[:H] + cum

        # 6. Provable-no-op exit: no cohort ahead and nothing left or
        #    nothing placed (availability only decreases inside a span).
        done_new = (new_n_stack == 0) | (n_placed == 0)
        if future[k]:
            done_new = torch.zeros_like(done_new)

        done = torch.where(alive, done_new, done)
        stackpos = torch.where(alive, new_stackpos, stackpos)
        n_stack = torch.where(alive, new_n_stack, n_stack)
        avail = torch.where(alive, new_avail, avail)
        cum = torch.where(alive, cum_new, cum)
        p_out[k] = torch.where(alive, row, -1)
        nr_out[k] = torch.where(alive, t_k, 0)
        np_out[k] = torch.where(alive, n_placed, 0)
        ticks_run += alive
    return SpanResult(p_out, nr_out, np_out, ticks_run,
                      n_stack.to(torch.int32), stackpos.to(torch.int32),
                      restore(avail))


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
