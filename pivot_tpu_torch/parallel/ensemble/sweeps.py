"""Grid sweeps: K candidates × R replicas of the rollout in one batch.

Port of ``pivot_tpu/parallel/ensemble/sweeps.py``.  Every sweep flattens
its (candidate, replica) grid to ``B = K·R`` rows, candidate-major (row
``b`` is candidate ``b // R``, replica ``b % R``), and runs them through
:func:`_run_rows`: one tick loop over ``[B, ...]`` tensors, the per-row
channels (faults, score exponents, the active-task mask, per-row
availability and recovery targets, the risk coefficient) handed to the
tick body as tensors with the row axis in front.  Candidates share the
replicas' Monte-Carlo draws, so their comparisons are paired.

``pivot_tpu``'s jit and donation twins (``_row_segment_step``,
``_row_segment_step_carry``) and its double-buffered segment pipeline
(``checkpoint._run_segments_pipelined``) are XLA machinery: the port's
tick loop already runs on the host, so a segmented run is a plain loop
of :func:`_rollout_segment` calls with one host read between segments.
"""

from __future__ import annotations

from typing import Optional

import torch

from pivot_tpu_torch.parallel.ensemble import prng
from pivot_tpu_torch.parallel.ensemble.bill import _finalize
from pivot_tpu_torch.parallel.ensemble.draws import (
    _fault_schedule,
    _opportunistic_uniforms,
    _perturbations,
)
from pivot_tpu_torch.parallel.ensemble.state import (
    _DONE,
    RolloutResult,
    _init_state,
)
from pivot_tpu_torch.parallel.ensemble.tick import (
    _rollout_segment,
    loop_clock,
)

__all__ = ["capacity_grid", "capacity_sweep", "score_param_sweep",
           "workload_sweep"]


def _run_rows(
    avail_rows,  # [B, H, 4] initial availability per row
    rt, arr, ra,  # [B, T] perturbed inputs per row
    workload, topo, tick, max_ticks, segment_ticks,
    policy, congestion, realtime_scoring,
    faults=None,  # ([B, F] host, [B, F] fail_at, [B, F] recover_at)
    task_u=None,  # [B, T]
    totals=None,  # [B, H, 4] fault recovery target
    score_params=None,  # [B, 3]
    active=None,  # [B, T] bool
    forms: Optional[str] = None,
    tick_order: str = "fifo",
    risk_coeff=None,  # [B] risk_weight × rework_cost per row
    hazard=None,  # ([P], [P, H]) market hazard trace, shared by the rows
    stats: Optional[dict] = None,
) -> RolloutResult:
    """Run B rows to the horizon and finalize them.

    ``segment_ticks=None`` is one tick loop of at most ``max_ticks``
    ticks (it stops once every row's active tasks are done).  An integer
    runs loops of that many ticks, reading the device once between two
    of them to stop early: the same bits as one loop (the state carries
    everything a tick reads).  ``stats`` as in ``rollout`` (``ticks``,
    ``place_steps``, ``host_syncs``, ``wall_s``, ``event_span_ms``)."""
    if congestion == "pairs":
        raise ValueError(
            "the host-pair congestion rung is a calibration diagnostic, "
            "not a sweep mode")
    workload.check_group_demands()
    B = avail_rows.shape[0]
    state = _init_state(avail_rows, workload.n_tasks, topo.cost.shape[0], B,
                        congestion=congestion)
    kw = dict(faults=faults, totals=totals, score_params=score_params,
              policy=policy, task_u=task_u, congestion=congestion,
              realtime_scoring=realtime_scoring, active=active, forms=forms,
              tick_order=tick_order, risk_coeff=risk_coeff, hazard=hazard,
              stats=stats)
    with loop_clock(stats, avail_rows.device):
        ticks = 0
        seg_len = segment_ticks or max_ticks
        while ticks < max_ticks:
            seg = min(seg_len, max_ticks - ticks)
            state = _rollout_segment(state, rt, arr, ra, workload, topo,
                                     tick, seg, **kw)
            ticks += seg
            if ticks >= max_ticks:
                break
            left = state.stage != _DONE
            if active is not None:
                left = left & active
            if not bool(left.any()):
                break
    return _finalize(state, workload, topo, active=active)


def _reshape_rows(res: RolloutResult, K: int, R: int) -> RolloutResult:
    """``[B, ...]`` row results back to ``[K, R, ...]``."""
    return RolloutResult(*(x.reshape((K, R) + tuple(x.shape[1:]))
                           for x in res))


def _tile_rows(x, K):
    """Tile a per-replica tensor to per-row (candidate-major)."""
    return x.repeat((K,) + (1,) * (x.dim() - 1))


# -- policy autotuning ------------------------------------------------------


def score_param_sweep(
    key,
    avail0,  # [H, 4] full host capacity
    workload,
    topo,
    storage_zones,  # [S]
    param_grid,  # [K, 3] exponents (w_cost, w_bw, w_norm) per candidate
    n_replicas: int = 32,
    tick: float = 5.0,
    max_ticks: int = 512,
    perturb: float = 0.1,
    congestion: bool = False,
    segment_ticks: Optional[int] = None,
    forms: Optional[str] = None,
    tick_order: str = "fifo",
    stats: Optional[dict] = None,
) -> RolloutResult:
    """Sweep the cost-aware score ``cost^w_cost / (norm^w_norm ×
    bw^w_bw)`` over ``param_grid`` (``(1, 1, 1)`` is the reference
    shape, ``scheduler/cost_aware.py:104-119``): ``[K, R]``-leading
    results, every candidate on the same R replicas' draws."""
    grid = torch.as_tensor(param_grid, dtype=avail0.dtype,
                           device=avail0.device)
    K, R = grid.shape[0], n_replicas
    rt, arr, root_anchor = _perturbations(
        key, workload, storage_zones, n_replicas, perturb, avail0.dtype)
    res = _run_rows(
        avail0.expand((K * R,) + tuple(avail0.shape)),
        _tile_rows(rt, K), _tile_rows(arr, K), _tile_rows(root_anchor, K),
        workload, topo, tick, max_ticks, segment_ticks,
        policy="cost-aware", congestion=congestion, realtime_scoring=False,
        score_params=grid.repeat_interleave(R, 0), forms=forms,
        tick_order=tick_order, stats=stats,
    )
    return _reshape_rows(res, K, R)


# -- capacity planning -------------------------------------------------------


def capacity_grid(avail0, host_counts) -> torch.Tensor:
    """``[K, H, 4]`` candidate capacity matrices: candidate k keeps the
    first ``host_counts[k]`` hosts and masks the rest with the −1
    down-host sentinel (a prefix keeps the generator's round-robin zone
    balance)."""
    H = avail0.shape[0]
    counts = torch.as_tensor(host_counts, dtype=torch.int64,
                             device=avail0.device)
    keep = torch.arange(H, device=avail0.device)[None, :] < counts[:, None]
    return torch.where(keep[:, :, None], avail0[None],
                       torch.full((), -1.0, dtype=avail0.dtype,
                                  device=avail0.device))


def capacity_sweep(
    key,
    avail_grid,  # [K, H, 4] candidate capacity matrices (capacity_grid)
    workload,
    topo,
    storage_zones,
    n_replicas: int = 32,
    tick: float = 5.0,
    max_ticks: int = 512,
    perturb: float = 0.1,
    policy: str = "cost-aware",
    congestion: bool = False,
    realtime_scoring: bool = False,
    n_faults: int = 0,
    fault_horizon: Optional[float] = None,
    mttr: Optional[float] = None,
    segment_ticks: Optional[int] = None,
    forms: Optional[str] = None,
    tick_order: str = "fifo",
    stats: Optional[dict] = None,
    contract: bool = False,
) -> RolloutResult:
    """The workload on K candidate cluster sizes × R replicas:
    ``[K, R]``-leading results.  With ``n_faults > 0`` each replica
    draws one crash schedule, applied to every candidate (the same
    physical failure trace; a crash on a host a candidate does not have
    is a no-op there).  Crashes are drawn over the union of the
    candidates' live hosts: the draw is a rank among them, mapped to a
    host by ``searchsorted(cumsum(alive), rank + 1)`` (the identity for
    ``capacity_grid``'s prefixes, right for any grid).  ``contract``:
    the schedule's ``fail_at + mttr · outage`` rounded once, as inside
    ``pivot_tpu``'s jit (``shard_sweep``'s sharded call), or twice, as
    its eager sweep draws it (the default)."""
    K, R = avail_grid.shape[0], n_replicas
    dtype, dev = avail_grid.dtype, avail_grid.device
    rt, arr, root_anchor = _perturbations(
        key, workload, storage_zones, n_replicas, perturb, dtype)
    task_u = _opportunistic_uniforms(
        key, n_replicas, workload.n_tasks, dtype, dev,
    ) if policy == "opportunistic" else None
    avail_rows = avail_grid.repeat_interleave(R, 0)  # [B, H, 4]
    faults = None
    if n_faults:
        alive = (avail_grid[:, :, 0] >= 0).any(0)  # [H]
        cum = torch.cumsum(alive.long(), 0)
        horizon = fault_horizon if fault_horizon is not None else \
            tick * max_ticks
        rank, fail_at, recover_at = _fault_schedule(
            prng.fold_in(key, 0x0FA17), n_replicas, n_faults, cum[-1],
            horizon, mttr, dtype, dev, contract=contract)
        host = torch.searchsorted(cum, rank + 1)
        faults = tuple(_tile_rows(f, K) for f in (host, fail_at, recover_at))
    res = _run_rows(
        avail_rows,
        _tile_rows(rt, K), _tile_rows(arr, K), _tile_rows(root_anchor, K),
        workload, topo, tick, max_ticks, segment_ticks,
        policy=policy, congestion=congestion,
        realtime_scoring=realtime_scoring, faults=faults,
        task_u=_tile_rows(task_u, K) if task_u is not None else None,
        totals=avail_rows if faults is not None else None,
        forms=forms, tick_order=tick_order, stats=stats,
    )
    return _reshape_rows(res, K, R)


# -- workload size -----------------------------------------------------------


def workload_sweep(
    key,
    avail0,  # [H, 4]
    workload,
    topo,
    storage_zones,
    app_counts,  # [K] — candidate k runs the first app_counts[k] apps
    n_replicas: int = 32,
    tick: float = 5.0,
    max_ticks: int = 2048,
    perturb: float = 0.1,
    policy: str = "cost-aware",
    congestion: bool = False,
    realtime_scoring: bool = False,
    segment_ticks: Optional[int] = None,
    forms: Optional[str] = None,
    tick_order: str = "fifo",
    stats: Optional[dict] = None,
) -> RolloutResult:
    """Cost and makespan against the number of applications: candidate k
    activates the first ``app_counts[k]`` apps (later apps' tasks arrive
    at ∞ and do not count as unfinished).  ``workload`` carries the full
    app set; DAG edges never cross apps, so masked tasks neither gate
    readiness nor bill egress."""
    dtype, dev = avail0.dtype, avail0.device
    counts = torch.as_tensor(app_counts, dtype=torch.int64, device=dev)
    K, R = counts.shape[0], n_replicas
    rt, arr, root_anchor = _perturbations(
        key, workload, storage_zones, n_replicas, perturb, dtype)
    task_u = _opportunistic_uniforms(
        key, n_replicas, workload.n_tasks, dtype, dev,
    ) if policy == "opportunistic" else None
    act = workload.app_of[None, :] < counts[:, None]  # [K, T]
    act_rows = act.repeat_interleave(R, 0)  # [B, T]
    arr_rows = torch.where(act_rows, _tile_rows(arr, K),
                           torch.full((), float("inf"), dtype=dtype,
                                      device=dev))
    res = _run_rows(
        avail0.expand((K * R,) + tuple(avail0.shape)),
        _tile_rows(rt, K), arr_rows, _tile_rows(root_anchor, K),
        workload, topo, tick, max_ticks, segment_ticks,
        policy=policy, congestion=congestion,
        realtime_scoring=realtime_scoring,
        task_u=_tile_rows(task_u, K) if task_u is not None else None,
        active=act_rows, forms=forms, tick_order=tick_order, stats=stats,
    )
    return _reshape_rows(res, K, R)
