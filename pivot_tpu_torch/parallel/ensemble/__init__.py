"""Monte-Carlo ensemble rollouts of DAG scheduling, batched over replicas.

Port of ``pivot_tpu/parallel/ensemble`` (BASELINE config 5): R perturbed
what-if replicas of a trace workload — task runtimes and arrivals
jittered by ``±perturb``, independent keyed root anchors — each scheduled
tick by tick (readiness, anchor vote, greedy placement, transfer timing,
busy integral), all R on one device at once.  The execution model is the
JAX package's (module docstring of ``pivot_tpu.parallel.ensemble``);
``tick.py`` says how the vmapped ``while_loop`` becomes a host loop over
``[R, ...]`` tensors.

Module map (as in the JAX package): ``state.py`` workload encoding and
rollout state, ``tick.py`` the tick body, ``bill.py`` finalization and
the egress bill, ``draws.py`` the Monte-Carlo draws (perturbations,
fault schedules), ``prng.py`` the threefry twin of ``jax.random`` they
draw from, ``libm.py`` XLA:CPU's ``log1p`` and ``pow``, ``sweeps.py``
the row runner and the score, capacity and workload sweeps,
``checkpoint.py`` segmented runs with checkpoint files and replica
chunks.

Runs: fault schedules (``n_faults``, ``fault_horizon``, ``mttr``), the
congestion backlog model (``congestion=True`` or ``"pairs"``), realtime
scoring, checkpoint files (``rollout_checkpointed``), and through the
row runner per-row score exponents, the eviction-risk term, the
active-task mask and per-row initial availability.  Sharding
(``sharded_rollout``, ``shard_sweep``) raises ``NotImplementedError``
(ROADMAP.md Queue 1 item 9d).

Results on the CPU in float64 equal ``pivot_tpu``'s bit for bit, except
the egress bill, which agrees to a few ulps (``bill.py``), and, with the
congestion model, the pull-volume product (``tick._pull_volumes``,
ROADMAP.md Queue 3).  Entry points
run where ``avail0`` lives; float64 with Exp(mttr) outages or score
exponents runs on the CPU only (the C library's ``log`` / ``pow``:
``libm.py``), the card runs float32.  Build the inputs with
``pivot_tpu_torch.experiments.calibrate.ensemble_inputs_from_schedule``.
"""

from __future__ import annotations

from typing import Optional

from pivot_tpu_torch.parallel.ensemble import prng  # noqa: F401
from pivot_tpu_torch.parallel.ensemble.bill import (  # noqa: F401
    _finalize,
    _sampled_egress,
    _sampling_table,
)
from pivot_tpu_torch.parallel.ensemble.checkpoint import (  # noqa: F401
    _fingerprint,
    _segment_step,
    rollout_checkpointed,
    rollout_chunked,
)
from pivot_tpu_torch.parallel.ensemble.draws import (  # noqa: F401
    _fault_schedule,
    _keyed_storage_index,
    _make_fault_schedule,
    _opportunistic_uniforms,
    _perturbations,
    _seed_bits,
)
from pivot_tpu_torch.parallel.ensemble.state import (  # noqa: F401
    _DONE,
    _PENDING,
    _RUNNING,
    EnsembleWorkload,
    RolloutResult,
    RolloutState,
    _init_state,
    _resolve_forms,
)
from pivot_tpu_torch.parallel.ensemble.sweeps import (  # noqa: F401
    _reshape_rows,
    _run_rows,
    _tile_rows,
    capacity_grid,
    capacity_sweep,
    score_param_sweep,
    workload_sweep,
)
from pivot_tpu_torch.parallel.ensemble.tick import (  # noqa: F401
    _rollout_segment,
    check_supported,
    loop_clock,
)

__all__ = [
    "EnsembleWorkload",
    "RolloutResult",
    "RolloutState",
    "capacity_grid",
    "capacity_sweep",
    "rollout",
    "rollout_checkpointed",
    "rollout_chunked",
    "score_param_sweep",
    "shard_sweep",
    "sharded_rollout",
    "workload_sweep",
]


def _single_rollout(
    avail0,  # [H, 4]
    runtime,  # [T] perturbed
    arrival,  # [T] perturbed
    root_anchor,  # [T] random storage zone per task (used for roots)
    workload: EnsembleWorkload,
    topo,
    tick: float,
    max_ticks: int,
    faults=None,
    score_params=None,
    policy: str = "cost-aware",
    task_u=None,
    congestion=False,
    realtime_scoring: bool = False,
    active=None,
    forms: Optional[str] = None,
    tick_order: str = "fifo",
) -> RolloutResult:
    """One replica's rollout on given draws (``faults`` a triple of
    ``[F]`` tensors, ``active`` ``[T]``): unbatched results."""
    state = _init_state(avail0, workload.n_tasks, topo.cost.shape[0], 1,
                        congestion=congestion)
    if faults is not None:
        faults = tuple(f[None] for f in faults)
    if score_params is not None:
        score_params = score_params[None]
    if active is not None:
        active = active[None]
    state = _rollout_segment(
        state, runtime[None], arrival[None], root_anchor[None].long(),
        workload, topo, tick, max_ticks, faults=faults, totals=avail0,
        score_params=score_params, policy=policy,
        task_u=None if task_u is None else task_u[None],
        congestion=congestion, realtime_scoring=realtime_scoring,
        active=active, forms=forms, tick_order=tick_order,
    )
    return RolloutResult(*(x[0] for x in _finalize(state, workload, topo,
                                                   active=active)))


def _rollout_states(
    key,
    avail0,
    workload: EnsembleWorkload,
    topo,
    storage_zones,
    n_replicas: int,
    tick: float,
    max_ticks: int,
    perturb: float,
    n_faults: int = 0,
    fault_horizon: Optional[float] = None,
    mttr: Optional[float] = None,
    policy: str = "cost-aware",
    congestion=False,
    realtime_scoring: bool = False,
    forms: Optional[str] = None,
    tick_order: str = "fifo",
    stats: Optional[dict] = None,
    *,
    contract: bool,
) -> RolloutState:
    """The rollout body: the R replicas' final states (no finalize).
    ``contract``: the fault draw's rounding (``draws._fault_schedule``)."""
    dtype = avail0.dtype
    rt, arr, root_anchor = _perturbations(
        key, workload, storage_zones, n_replicas, perturb, dtype)
    task_u = _opportunistic_uniforms(
        key, n_replicas, workload.n_tasks, dtype, avail0.device,
    ) if policy == "opportunistic" else None
    faults = _make_fault_schedule(
        key, n_replicas, n_faults, avail0, tick, max_ticks, fault_horizon,
        mttr, contract=contract) if n_faults else None
    state = _init_state(avail0, workload.n_tasks, topo.cost.shape[0],
                        n_replicas, congestion=congestion)
    return _rollout_segment(
        state, rt, arr, root_anchor, workload, topo, tick, max_ticks,
        faults=faults, totals=avail0, policy=policy, task_u=task_u,
        congestion=congestion,
        realtime_scoring=realtime_scoring, forms=forms,
        tick_order=tick_order, stats=stats,
    )


def rollout(
    key,
    avail0,  # [H, 4] initial availability (shared base)
    workload: EnsembleWorkload,
    topo,
    storage_zones,  # [S] candidate root-anchor zones
    n_replicas: int = 64,
    tick: float = 5.0,
    max_ticks: int = 512,
    perturb: float = 0.1,
    n_faults: int = 0,
    fault_horizon: Optional[float] = None,
    mttr: Optional[float] = None,
    policy: str = "cost-aware",
    congestion=False,
    realtime_scoring: bool = False,
    forms: Optional[str] = None,
    tick_order: str = "fifo",
    stats: Optional[dict] = None,
) -> RolloutResult:
    """Monte-Carlo rollout of ``n_replicas`` replicas: ``[R]``-leading
    results.  ``key`` is a threefry key (``prng.PRNGKey(seed)``, the key
    data of ``jax.random.PRNGKey(seed)``).

    With ``n_faults > 0`` each replica draws an independent crash
    schedule (``n_faults`` crashes uniform in ``[0, fault_horizon)``,
    Exp(``mttr``) outages, never recovering without ``mttr``);
    ``fault_horizon`` defaults to ``tick × max_ticks``.  ``avail0`` must
    be full host capacity: a recovered host gets it back.  The schedule
    rounds as ``pivot_tpu``'s jitted ``rollout`` draws it
    (``recover_at = fail_at + mttr · outage`` contracted: one rounding).

    ``stats``, when given, gains the run's ``ticks``, ``place_steps``
    (placement-chain steps walked), ``host_syncs`` (device→host reads of
    the tick loop), ``wall_s`` and, on the card, ``event_span_ms`` (the
    stream's elapsed time between CUDA events around the tick loop, idle
    gaps included: not the device's busy time); counts add up over calls.

    Matmuls run under the caller's ``torch.backends`` settings: the
    egress bill's product needs full float32 (``allow_tf32`` off, torch's
    default; the ``ensemble`` CLI sets it).
    """
    return _rollout(key, avail0, workload, topo, storage_zones,
                    n_replicas=n_replicas, tick=tick, max_ticks=max_ticks,
                    perturb=perturb, n_faults=n_faults,
                    fault_horizon=fault_horizon, mttr=mttr, policy=policy,
                    congestion=congestion,
                    realtime_scoring=realtime_scoring, forms=forms,
                    tick_order=tick_order, stats=stats, contract=True)


def _rollout(key, avail0, workload, topo, storage_zones, *, contract,
             stats=None, **kw) -> RolloutResult:
    """:func:`rollout` with the fault draw's rounding chosen:
    ``contract=False`` rounds ``fail_at + mttr · outage`` twice, as
    ``pivot_tpu``'s ``rollout_checkpointed`` (the ``ensemble`` CLI's
    path) draws the schedule eagerly."""
    workload.check_group_demands()
    counts = stats if stats is not None else {}
    with loop_clock(counts, avail0.device):
        states = _rollout_states(key, avail0, workload, topo, storage_zones,
                                 stats=counts, contract=contract, **kw)
    return _finalize(states, workload, topo)


def sharded_rollout(*args, **kwargs):
    """``pivot_tpu``'s mesh-sharded rollout: not ported yet."""
    check_supported()


def shard_sweep(*args, **kwargs):
    """``pivot_tpu``'s mesh-sharded sweeps: not ported yet."""
    check_supported()
