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
active-task mask and per-row initial availability.  Sharding over a
replica mesh (``parallel/mesh.py``): ``sharded_rollout`` splits the
replica axis in contiguous blocks over the mesh's ``replica`` axis and
``shard_sweep`` binds a sweep to the same layout
(``ops/shard.py::row_sharding``).  Nothing crosses replicas, so on one
device (S logical shards of a card) the sharded program is the
unsharded ``[R]`` batch viewed as ``[S, R/S]``: the same draws, the same
tick loop, the same bits.

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

import functools
import inspect
from typing import Optional

import torch

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


def sharded_rollout(
    mesh,
    key,
    avail0,
    workload: EnsembleWorkload,
    topo,
    storage_zones,
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
    tick_order: str = "fifo",
    stats: Optional[dict] = None,
) -> RolloutResult:
    """:func:`rollout` with the replica axis sharded over ``mesh``'s
    ``replica`` axis (``pivot_tpu/parallel/ensemble/__init__.py:308``).

    Replica ``r`` lives in block ``r // (R/S)`` (``ops/shard.py::
    row_sharding``); inputs are replicated and no replica reads
    another's state.  The blocks are slices of ONE ensemble: they take
    their rows of the full-R draws (perturbations, anchors, fault
    schedules, opportunistic uniforms), never draws of their own, and
    they share the tick loop, which runs until every replica of every
    block is done — as XLA's partition of the reference's vmapped
    ``while_loop`` does (its predicate reduces over all R).  So the
    result equals :func:`rollout`'s bit for bit, the contracted fault
    draw included.  The mesh must name ``avail0``'s device (S logical
    shards of one card, or of the CPU in the tests); a mesh over several
    distinct devices raises ``NotImplementedError``.  ``stats`` as in
    :func:`rollout`.
    """
    from pivot_tpu_torch.ops.shard import REPLICA_AXIS, mesh_device

    n_rep_axis = int(mesh.shape[REPLICA_AXIS])
    if n_replicas % n_rep_axis:
        raise ValueError(
            f"n_replicas={n_replicas} does not divide over the mesh's "
            f"{n_rep_axis} replica shards — NamedSharding partitions the "
            f"[R] axis into equal contiguous blocks; round the ensemble "
            f"up to a multiple of {n_rep_axis}"
        )
    mesh_device(mesh, avail0.device)
    return rollout(key, avail0, workload, topo, storage_zones,
                   n_replicas=n_replicas, tick=tick, max_ticks=max_ticks,
                   perturb=perturb, n_faults=n_faults,
                   fault_horizon=fault_horizon, mttr=mttr, policy=policy,
                   congestion=congestion, realtime_scoring=realtime_scoring,
                   tick_order=tick_order, stats=stats)


def sweep_out_shardings(mesh) -> RolloutResult:
    """The ``[K, R, ...]`` what-if sweeps' result layout
    (``pivot_tpu/parallel/ensemble/__init__.py:345``): each field's
    replica axis (axis 1) cut by ``ops/shard.py::row_sharding``, the
    candidate and task axes whole.  Most callers want
    :func:`shard_sweep`."""
    from pivot_tpu_torch.ops.shard import row_sharding

    rows = row_sharding(mesh)
    return RolloutResult(*([rows] * len(RolloutResult._fields)))


class _ShardedSweep:
    """A sweep bound to its static config and to ``mesh``'s replica
    layout: each call checks that the replica count divides the
    ``replica`` axis and that the mesh names the inputs' device, then
    runs the sweep in ONE tick loop (no segments, as the reference's
    jitted sharded sweep).  Its fault schedule is drawn as inside
    ``pivot_tpu``'s jit: ``fail_at + mttr · outage`` contracted."""

    def __init__(self, sweep_fn, mesh, static_kw):
        self.func = sweep_fn
        self.mesh = mesh
        self.keywords = static_kw

    def __call__(self, key, avail, *args, **kw):
        from pivot_tpu_torch.ops.shard import (
            check_row_divisibility,
            mesh_device,
        )

        kw = {**self.keywords, **kw}
        n_replicas = kw.get("n_replicas", _default_replicas(self.func))
        check_row_divisibility(self.mesh, n_replicas)
        mesh_device(self.mesh, avail.device)
        if "contract" in _params(self.func):
            kw["contract"] = True
        return self.func(key, avail, *args, **kw)


def _params(fn) -> dict:
    return inspect.signature(fn).parameters


def _default_replicas(sweep_fn):
    """The replica count a sweep runs with when the caller gives none:
    its own default (None when it has none)."""
    try:
        default = _params(sweep_fn)["n_replicas"].default
    except (KeyError, TypeError, ValueError):
        return None
    return None if default is inspect.Parameter.empty else default


def shard_sweep(sweep_fn, fallback_segment_ticks=None, force_mesh=False,
                devices=None, **static_kw):
    """Bind a what-if sweep's static config and shard its replica axis
    over a replica mesh of ``devices`` (default: the visible cards)
    (``pivot_tpu/parallel/ensemble/__init__.py:366-430``).

    Falls back to the unsharded call — a ``functools.partial`` of
    ``sweep_fn`` — in the reference's order: on one device or none
    (silently), on an explicit ``segment_ticks`` (the segmented loop is
    the unsharded path's), on a replica count that does not divide the
    devices (the sweep's own default counted when the caller gives
    none), and on the CPU unless ``force_mesh=True`` (a mesh of CPU
    "devices" shares the cores; tests force it to validate the layout).
    Past the reference's reasons the port has one of its own: devices
    that are not all one device (several cards) — a mesh over distinct
    devices is ROADMAP.md Queue 1, several cards.  Each fallback but the
    first logs its reason; on the fallback, ``fallback_segment_ticks``
    (when set and not already in the config) runs the sweep in segments
    of that many ticks.  ``devices`` may name one device several times
    (logical shards).
    """
    from pivot_tpu_torch.ops.shard import one_device
    from pivot_tpu_torch.parallel.mesh import replica_mesh, visible_cards
    from pivot_tpu_torch.utils import get_logger

    devs = list(devices) if devices is not None else visible_cards()
    n_dev = len(devs)
    n_replicas = static_kw.get("n_replicas")
    if n_replicas is None:
        n_replicas = _default_replicas(sweep_fn)
    reason = None
    if n_dev <= 1:
        pass  # nothing to shard over — not worth a log line
    elif static_kw.get("segment_ticks") is not None:
        reason = "explicit segment_ticks requests the host-side segmented loop"
    elif n_replicas is None or n_replicas % n_dev:
        reason = (
            f"replicas ({n_replicas}) not divisible by {n_dev} devices"
        )
    elif all(torch.device(d).type == "cpu" for d in devs) and not force_mesh:
        reason = (
            "CPU backend (forced-host-device meshes share the physical "
            "cores; pass force_mesh=True to shard anyway)"
        )
    elif not one_device(devs):
        reason = (
            f"{n_dev} distinct devices (a mesh over several cards is not "
            "ported yet: ROADMAP.md Queue 1, several cards)"
        )
    if n_dev <= 1 or reason is not None:
        if reason is not None:
            get_logger("ensemble").info("sweep runs unsharded: %s", reason)
        if fallback_segment_ticks is not None:
            static_kw.setdefault("segment_ticks", fallback_segment_ticks)
        return functools.partial(sweep_fn, **static_kw)
    return _ShardedSweep(sweep_fn, replica_mesh(devices=devs), static_kw)
