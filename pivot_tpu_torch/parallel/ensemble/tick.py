"""The tick body of the ensemble rollout, batched over replicas.

Port of ``pivot_tpu/parallel/ensemble/tick.py::_rollout_segment``.  JAX
runs one replica's ``lax.while_loop`` over ticks and vmaps it; here every
tensor carries the replica axis ``R`` in front and the loops run on the
host:

  * the tick loop runs while any replica has a task not done (and at most
    ``n_ticks`` ticks).  A replica whose own loop would have stopped is
    frozen, as under ``vmap``: its clock and busy integral stop, and
    nothing else of it can change (it has no running, ready or waiting
    task left);
  * the placement chain of a tick walks max-over-replicas ``n_ready``
    steps; a step past a replica's own ``n_ready`` places nothing there;
  * each tick reads the device once: ``[max n_ready, any replica alive
    next tick]`` in one copy, after the sort (a task only becomes done in
    the retire step, so the next tick's loop condition is known by then).

The body is the JAX package's ``"indexed"`` form (segment sums, gathers
and scatters), which its tests hold bit-identical to the ``"vector"``
form; ``forms`` is accepted for signature parity.  Float roundings follow
XLA's CPU backend (``bill.py``).  The refund adds each host's retiring
tasks in task-index order, as ``segment_sum`` does there: the trace's
demands are not integers (0.5 CPUs, 2359.2961 MB), so the order shows
in the bits.  ``index_put_`` with ``accumulate`` gives that order on
both devices (a sequential loop on the CPU; a stable sort by row and one
sequential pass per row on the card, no atomics).  Counts use
``index_add_`` (0/1 operands, integer sums below 2**24: exact in any
order), maxima ``scatter_reduce`` (exact in any order), the busy
integral ``_ordered_sum`` (XLA:CPU's order on both devices: the same
bits on the card as on the CPU).

Not ported yet (each raises ``NotImplementedError``; ROADMAP.md Queue 1,
the rest of the ensemble): fault schedules, the congestion backlog model
(``True`` and ``"pairs"``), realtime scoring, score exponents, the
eviction-risk term and the active-task mask.
"""

from __future__ import annotations

from typing import Optional

import torch

from pivot_tpu_torch.ops.kernels import _first_true, _place_replicas
from pivot_tpu_torch.ops.tickloop import _inverse, _lexsort
from pivot_tpu_torch.parallel.ensemble.bill import (
    _fma_norms,
    _ordered_sum,
    _recip,
)
from pivot_tpu_torch.parallel.ensemble.prng import fma
from pivot_tpu_torch.parallel.ensemble.state import (
    _DONE,
    _PENDING,
    _RUNNING,
    EnsembleWorkload,
    RolloutState,
    _resolve_forms,
)

_LATER = "(ROADMAP.md Queue 1, the rest of the ensemble)"
POLICIES = ("cost-aware", "first-fit", "best-fit", "opportunistic")


def check_supported(n_faults=0, congestion=False, realtime_scoring=False,
                    score_params=None, risk_coeff=None, hazard=None,
                    active=None, checkpoint_path=None) -> None:
    """Raise ``NotImplementedError`` for an option of the JAX rollout the
    port does not run yet, naming where it stands in the roadmap."""
    for name, asked in (
        ("fault schedules (n_faults > 0)", n_faults),
        ("the congestion backlog model", congestion),
        ("realtime scoring", realtime_scoring),
        ("score exponents (score_params)", score_params is not None),
        ("the eviction-risk term (hazard / risk_coeff)",
         hazard is not None or risk_coeff is not None),
        ("the active-task mask", active is not None),
        ("checkpointed rollouts", checkpoint_path),
    ):
        if asked:
            raise NotImplementedError(
                f"{name} is not ported to pivot_tpu_torch yet {_LATER}")


def _pred_lists(pred_group: torch.Tensor) -> torch.Tensor:
    """``[G, P]`` predecessor groups of each group, padded with ``G`` (a
    pad row the caller appends).  One host read, once per rollout."""
    G = pred_group.shape[0]
    adj = pred_group.cpu() > 0
    rows = [torch.nonzero(adj[g]).reshape(-1).tolist() for g in range(G)]
    width = max([1] + [len(r) for r in rows])
    table = torch.full((G, width), G, dtype=torch.int64)
    for g, r in enumerate(rows):
        table[g, :len(r)] = torch.tensor(r, dtype=torch.int64)
    return table.to(pred_group.device)


def _rollout_segment(
    state: RolloutState,
    runtime,  # [R, T] perturbed
    arrival,  # [R, T] perturbed
    root_anchor,  # [R, T] random storage zone per task (used for roots)
    workload: EnsembleWorkload,
    topo,
    tick: float,
    n_ticks: int,
    faults=None,
    totals=None,
    score_params=None,
    policy: str = "cost-aware",
    task_u=None,  # [R, T] uniforms of the opportunistic arm
    congestion=False,
    realtime_scoring: bool = False,
    active=None,
    forms: Optional[str] = None,
    tick_order: str = "fifo",
    risk_coeff=None,
    hazard=None,
    stats: Optional[dict] = None,
) -> RolloutState:
    """Advance R replicas' rollouts by at most ``n_ticks`` ticks (stops
    once every replica's tasks are done).  ``stats``, when given, gains
    ``ticks``, ``place_steps`` and ``host_syncs``."""
    check_supported(n_faults=faults is not None, congestion=congestion,
                    realtime_scoring=realtime_scoring,
                    score_params=score_params, risk_coeff=risk_coeff,
                    hazard=hazard, active=active)
    _resolve_forms(forms)
    if tick_order not in ("fifo", "lifo"):
        raise ValueError(
            f"tick_order must be 'fifo' or 'lifo', got {tick_order!r}")
    if policy not in POLICIES:
        raise ValueError(f"unknown ensemble policy {policy!r}")
    lifo = tick_order == "lifo"
    t, stage, finish, place, avail, busy, q, qpos = state
    R, T = stage.shape
    H = avail.shape[1]
    Z = topo.cost.shape[0]
    G = workload.n_groups
    dtype, dev = avail.dtype, avail.device
    zero = torch.zeros((), dtype=dtype, device=dev)
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)
    tick_t = torch.tensor(tick, dtype=dtype, device=dev)
    inv_tick = _recip(tick, dtype, dev)
    host_zone = topo.host_zone.long()
    group_of = workload.group_of.expand(R, T)
    has_pred = (workload.pred != 0).any(1)  # [T]
    # The workload may be float32 under a float64 state, as in the JAX
    # package (``from_applications`` defaults to float32); elementwise ops
    # promote, the matmuls and the demand sums take exact float64 copies
    # (the demand norms, sort keys only, stay in the workload's dtype).
    demands = workload.demands.to(dtype)
    pred_t = workload.pred.to(dtype).T
    pred_group = workload.pred_group.to(dtype)
    iota = torch.arange(T, device=dev)
    iota_r = iota.expand(R, T)
    rep = torch.arange(R, device=dev)
    miss_row = R * H + rep[:, None] * T + iota  # [R, T] dropped refund rows
    # [Z, H] round-trip score tables (pure topology).
    cost_rt = topo.cost[:, host_zone] + topo.cost[host_zone, :].T
    bw_rt = topo.bw[:, host_zone] + topo.bw[host_zone, :].T
    if policy in ("first-fit", "cost-aware"):
        dem_norms = _fma_norms(workload.demands)
        task_order = torch.sort(-dem_norms, stable=True).indices
    else:
        task_order = iota
    task_rank = _inverse(task_order, iota)
    dem_group = torch.zeros((G, 4), dtype=dtype, device=dev)
    dem_group[workload.group_of] = demands
    pred_idx = _pred_lists(workload.pred_group)  # [G, P], pad = G
    inv_bw = torch.where(topo.bw > 0, 1.0 / topo.bw, zero)  # [Z, Z]
    strict = policy in ("cost-aware", "best-fit")  # ref :124 / vbp :45
    fits = torch.gt if strict else torch.ge
    if policy == "opportunistic":
        golden = torch.tensor(0.6180339887498949, dtype=dtype, device=dev)
    counts = stats if stats is not None else {}
    for k in ("ticks", "place_steps", "host_syncs"):
        counts.setdefault(k, 0)

    alive = (stage != _DONE).any(1)  # [R] the loop condition per replica
    go = n_ticks > 0 and R > 0 and bool(alive.any())
    counts["host_syncs"] += 1
    i = 0
    while go and i < n_ticks:
        # 1. Retire finished tasks and refund their resources: an index-
        #    ordered sum per host.  Each miss adds 0 to a dropped row of
        #    its own past the R·H host rows: on the card the accumulate
        #    walks each run of equal rows in one thread, and one shared
        #    dropped row would be a run of R·T.
        newly_done = (stage == _RUNNING) & (finish <= t[:, None])
        rows = torch.where(newly_done, rep[:, None] * H + place, miss_row)
        refund = torch.zeros((R * H + R * T, 4), dtype=dtype, device=dev)
        refund.index_put_(
            (rows.reshape(-1),),
            torch.where(newly_done[..., None], demands, zero).reshape(-1, 4),
            accumulate=True)
        avail = avail + refund[:R * H].reshape(R, H, 4)
        stage = torch.where(newly_done, _DONE, stage)
        alive_next = (stage != _DONE).any(1)

        # 2. Readiness: every predecessor instance done, and the DES
        #    dispatch pipeline's pump time (strictly after the last
        #    predecessor's finish, on the app's tick phase) passed.
        done = stage == _DONE
        done_f = done.to(dtype)
        unfinished_preds = torch.matmul(1.0 - done_f, pred_t)
        fin_done = torch.where(done, finish, -inf)
        gf = torch.full((R, G), float("-inf"), dtype=dtype, device=dev)
        gf.scatter_reduce_(1, group_of, fin_done, "amax", include_self=True)
        gf = torch.cat([gf, gf.new_full((R, 1), float("-inf"))], 1)
        tau_g = gf[:, pred_idx].amax(-1)  # [R, G] (−inf for root groups)
        tau = tau_g.gather(1, group_of)
        pump = fma(torch.floor((tau - arrival) * inv_tick) + 1.0, tick_t,
                   arrival)
        ready_time = torch.where(has_pred, pump, arrival)
        ready = ((stage == _PENDING) & (ready_time < t[:, None])
                 & (unfinished_preds == 0))

        # 2b. Batch rank under "lifo": the wait cohort re-drains in
        #     reverse of its previous positions, fresh tasks follow by
        #     pump time, app, then descending index.
        if lifo:
            wait_c = (qpos >= 0) & ready
            k1 = torch.where(ready, torch.where(wait_c, -qpos, 1), 2)
            app = workload.app_of.expand(R, T)
            border = _lexsort((k1, ready_time, app, -iota_r), iota_r)
            brank = _inverse(border, iota_r)
        else:
            brank = iota_r

        # 3. Done-instance counts per (group, zone) — and, for cost-aware,
        #    per (group, host) — then the per-host majority vote over
        #    predecessor placements; roots keep their keyed anchor.  A task
        #    not done adds 0 to the slot of its (clamped) host, so no one
        #    slot collects the misses' atomics.
        host_c = place.clamp(0, H - 1)
        slot = (rep[:, None] * G + group_of) * Z + host_zone[host_c]
        zc = torch.zeros(R * G * Z, dtype=dtype, device=dev).index_add_(
            0, slot.reshape(-1), done_f.reshape(-1)).reshape(R, G, Z)
        if policy == "cost-aware":
            # [G, R, H] layout: the vote is one [G, G] @ [G, R·H] product.
            slot = (group_of * R + rep[:, None]) * H + host_c
            hv = torch.zeros(G * R * H, dtype=dtype, device=dev).index_add_(
                0, slot.reshape(-1), done_f.reshape(-1))
            votes = torch.matmul(pred_group, hv.reshape(G, R * H))
            majority_host = votes.reshape(G, R, H).argmax(-1).T  # [R, G]
            majority_zone = host_zone[majority_host].gather(1, group_of)
            anchor = torch.where(has_pred, majority_zone, root_anchor)
        else:
            anchor = root_anchor

        # 4. Eligibility: ready, with a fitting host at tick start (the
        #    fit test is exact at group level: demands are group-constant).
        fit_g = fits(avail[:, None, :, 0], dem_group[None, :, None, 0])
        for k in range(1, 4):
            fit_g &= fits(avail[:, None, :, k], dem_group[None, :, None, k])
        eligible = ready & fit_g.any(-1).gather(1, group_of)
        del fit_g
        if policy == "cost-aware":
            bucket = torch.where(has_pred, anchor, Z + workload.app_of)
            ready_idx = torch.where(ready, brank, T)
            fib = torch.full((R, Z + G), torch.iinfo(torch.int64).max,
                             dtype=torch.int64, device=dev)
            fib.scatter_reduce_(1, bucket, ready_idx, "amin",
                                include_self=True)
            bfirst = fib.gather(1, bucket)
            key3 = (-dem_norms).expand(R, T)
        else:
            bfirst = torch.zeros((R, T), dtype=torch.int64, device=dev)
            if policy == "first-fit":
                key3 = (-dem_norms).expand(R, T) if lifo else \
                    task_rank.expand(R, T)
            else:
                key3 = bfirst if lifo else task_rank.expand(R, T)
        order = _lexsort(((~eligible).long(), bfirst, key3, brank), iota_r)
        bf_p = bfirst.gather(1, order)
        az_p = anchor.gather(1, order)
        g_p = group_of.gather(1, order)
        u_p = task_u.gather(1, order) if task_u is not None else None
        n_ready = eligible.sum(1)
        n_steps, go_next = torch.stack(
            [n_ready.max(), alive_next.any().long()]).tolist()
        counts["host_syncs"] += 1

        # 5a. Transfer-delay table: GD[g, z] = out_g × max over zones s
        #     holding a done g-instance of 1/bw[s, z]; CD[c, z] = max over
        #     c's predecessor groups.
        present = zc > 0
        gd = torch.where(present[..., None], inv_bw, zero).amax(2) \
            * workload.out_group[None, :, None]  # [R, G, Z]
        gd = torch.cat([gd, gd.new_zeros((R, 1, Z))], 1)
        cd = gd[:, pred_idx].amax(2)  # [R, G, Z]
        if policy == "opportunistic" and task_u is not None:
            tick_idx = (t * inv_tick).to(torch.int32)
            weyl_rot = tick_idx.to(dtype) * golden  # [R]

        # 5b. The placement chain: step j places each replica's j-th
        #     eligible task (a no-op past that replica's n_ready).
        pl = torch.full((R, T), -1, dtype=torch.int64, device=dev)
        delay = torch.zeros((R, T), dtype=dtype, device=dev)
        place_row = _place_replicas(avail)
        if policy == "cost-aware":
            norm_snap = _fma_norms(avail)
            prev_bf = torch.full((R,), -1, dtype=torch.int64, device=dev)
        for j in range(n_steps):
            g = g_p[:, j]
            demand = dem_group[g]  # [R, 4]
            fit = fits(avail, demand[:, None, :]).all(-1)  # [R, H]
            if policy == "cost-aware":
                # Host scores frozen per anchor bucket (availability at
                # bucket start), live fit checks.
                bf_j = bf_p[:, j]
                norm_snap = torch.where((bf_j != prev_bf)[:, None],
                                        _fma_norms(avail), norm_snap)
                prev_bf = bf_j
                az = az_p[:, j]
                score = cost_rt[az] / (norm_snap * bw_rt[az])
                h = torch.where(fit, score, inf).argmin(1)
            elif policy == "first-fit":
                h = _first_true(fit)
            elif policy == "best-fit":
                score = _fma_norms(avail - demand[:, None, :])
                h = torch.where(fit, score, inf).argmin(1)
            else:  # opportunistic: uniform among fits, Weyl-rotated per tick
                u_eff = torch.fmod(u_p[:, j] + weyl_rot, 1.0)
                n_fit = fit.sum(1)
                k = torch.minimum((u_eff * n_fit.to(dtype)).to(torch.int64),
                                  n_fit - 1)
                rank = torch.cumsum(fit, 1) - 1
                h = _first_true(fit & (rank == k[:, None]))
            ok = fit.any(1) & (n_ready > j)
            place_row(avail, demand, h, ok)
            at = order[:, j:j + 1]
            pl.scatter_(1, at, torch.where(ok, h, -1)[:, None])
            d_j = cd[rep, g, host_zone[h]]
            delay.scatter_(1, at, torch.where(ok, d_j, zero)[:, None])
        placed = pl >= 0
        if lifo:
            # Wait-queue carry: an unplaced ready task re-enters at its
            # position in the policy's schedule-return order.
            if policy == "first-fit":
                sord = _lexsort(((~ready).long(), (-dem_norms).expand(R, T),
                                 brank), iota_r)
                srank = _inverse(sord, iota_r)
            else:
                srank = brank
            qpos = torch.where(ready & ~placed, srank, -1)

        stage = torch.where(placed, _RUNNING, stage)
        place = torch.where(placed, pl, place)
        finish = torch.where(placed, (t[:, None] + delay) + runtime, finish)

        # 6. Busy-host integral: per host, the latest resident finish
        #    within this window (a max: exact in any order).
        running = stage == _RUNNING
        contrib = torch.where(
            running, torch.clamp(finish - t[:, None], 0.0, tick), zero)
        slot = rep[:, None] * H + place.clamp(0, H - 1)  # misses add max 0
        busy_host = torch.zeros(R * H, dtype=dtype, device=dev)
        busy_host.scatter_reduce_(0, slot.reshape(-1), contrib.reshape(-1),
                                  "amax", include_self=True)
        busy = torch.where(
            alive, busy + _ordered_sum(busy_host.reshape(R, H)), busy)
        t = torch.where(alive, t + tick_t, t)
        alive = alive_next
        go = bool(go_next)
        counts["ticks"] += 1
        counts["place_steps"] += n_steps
        i += 1
    return RolloutState(t, stage, finish, place, avail, busy, q, qpos)
