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
the egress bill, ``draws.py`` the Monte-Carlo draws, ``prng.py`` the
threefry twin of ``jax.random`` they draw from.

Results on the CPU in float64 equal ``pivot_tpu``'s bit for bit, except
the egress bill, which agrees to a few ulps (``bill.py``).  Entry points
run where ``avail0`` lives; build the inputs with
``pivot_tpu_torch.experiments.calibrate.ensemble_inputs_from_schedule``.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from pivot_tpu_torch.parallel.ensemble import prng
from pivot_tpu_torch.parallel.ensemble.bill import (  # noqa: F401
    _finalize,
    _sampled_egress,
    _sampling_table,
)
from pivot_tpu_torch.parallel.ensemble.draws import (  # noqa: F401
    _keyed_storage_index,
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
from pivot_tpu_torch.parallel.ensemble.tick import (  # noqa: F401
    _rollout_segment,
    check_supported,
)

__all__ = [
    "EnsembleWorkload",
    "RolloutResult",
    "RolloutState",
    "rollout",
    "rollout_chunked",
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
    """One replica's rollout on given draws: unbatched results."""
    state = _init_state(avail0, workload.n_tasks, topo.cost.shape[0], 1,
                        congestion=congestion)
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
) -> RolloutState:
    """The rollout body: the R replicas' final states (no finalize).
    ``_rollout_segment`` checks the options it does not run yet; the
    fault schedule is drawn here, so ``n_faults`` is checked here."""
    check_supported(n_faults=n_faults)
    dtype = avail0.dtype
    rt, arr, root_anchor = _perturbations(
        key, workload, storage_zones, n_replicas, perturb, dtype)
    task_u = _opportunistic_uniforms(
        key, n_replicas, workload.n_tasks, dtype, avail0.device,
    ) if policy == "opportunistic" else None
    state = _init_state(avail0, workload.n_tasks, topo.cost.shape[0],
                        n_replicas)
    return _rollout_segment(
        state, rt, arr, root_anchor, workload, topo, tick, max_ticks,
        totals=avail0, policy=policy, task_u=task_u, congestion=congestion,
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

    ``stats``, when given, gains the run's ``ticks``, ``place_steps``
    (placement-chain steps walked), ``host_syncs`` (device→host reads of
    the tick loop), ``wall_s`` and, on the card, ``event_span_ms`` (the
    stream's elapsed time between CUDA events around the tick loop, idle
    gaps included: not the device's busy time); counts add up over calls.

    Matmuls run under the caller's ``torch.backends`` settings: the
    egress bill's product needs full float32 (``allow_tf32`` off, torch's
    default; the ``ensemble`` CLI sets it).
    """
    workload.check_group_demands()
    counts = stats if stats is not None else {}
    cuda = avail0.is_cuda
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
    wall0 = time.perf_counter()
    states = _rollout_states(
        key, avail0, workload, topo, storage_zones,
        n_replicas=n_replicas, tick=tick, max_ticks=max_ticks,
        perturb=perturb, n_faults=n_faults, policy=policy,
        congestion=congestion, realtime_scoring=realtime_scoring,
        forms=forms, tick_order=tick_order, stats=counts,
    )
    if cuda:
        end.record()
        end.synchronize()
        counts["event_span_ms"] = counts.get("event_span_ms", 0.0) + \
            start.elapsed_time(end)
    counts["wall_s"] = counts.get("wall_s", 0.0) + \
        time.perf_counter() - wall0
    return _finalize(states, workload, topo)


def rollout_chunked(
    key,
    avail0,
    workload: EnsembleWorkload,
    topo,
    storage_zones,
    checkpoint_path: Optional[str],
    replica_chunk: int,
    n_replicas: int = 64,
    segment_ticks: int = 256,
    resume: bool = True,
    **kw,
) -> RolloutResult:
    """Ensemble rollout in replica chunks of ``replica_chunk``: chunk 0
    uses ``key`` verbatim, chunk ``c > 0`` draws from ``fold_in(key, c)``.
    ``replica_chunk <= 0`` (or ``>= n_replicas``) is one :func:`rollout`
    (``pivot_tpu``'s segmented path equals it bit for bit).  Checkpoint
    files are not ported yet."""
    check_supported(checkpoint_path=checkpoint_path)
    if replica_chunk <= 0 or n_replicas <= replica_chunk:
        return rollout(key, avail0, workload, topo, storage_zones,
                       n_replicas=n_replicas, **kw)
    parts = []
    done = 0
    while done < n_replicas:
        c = len(parts)
        n = min(replica_chunk, n_replicas - done)
        ck = key if c == 0 else prng.fold_in(key, c)
        parts.append(rollout(ck, avail0, workload, topo, storage_zones,
                             n_replicas=n, **kw))
        done += n
    return RolloutResult(*(torch.cat(xs, 0) for xs in zip(*parts)))
