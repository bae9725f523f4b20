"""Checkpoint/resume and chunked variants of the ensemble rollout.

Port of ``pivot_tpu/parallel/ensemble/checkpoint.py``.  The rollout runs
in segments of ``segment_ticks`` ticks; after each one the replicas'
:class:`RolloutState` goes to an ``.npz`` file, written atomically (a
temporary file, then ``os.replace``).  A rerun with the same arguments
resumes from it; a file written with other arguments (its fingerprint
differs) or missing a state field is ignored and the run restarts.  The
result is the same bits for any ``segment_ticks`` and across a kill: the
Monte-Carlo draws are a pure function of the key, made once per call,
and the state carries everything a tick reads.

The file holds ``fingerprint``, ``ticks_done`` and ``pivot_tpu``'s
``RolloutState`` fields, the integer ones as int32 and ``q`` as zeros
``[R, Z, H]`` without the congestion model, so a port's file and
``pivot_tpu``'s after the same segment can be compared field by field.
``pivot_tpu``'s jitted twins (``_segment_step_carry``, the double-buffered
``_run_segments_pipelined``) are XLA machinery: here a segment is one
call of the tick loop, which already runs on the host.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np
import torch

from pivot_tpu_torch.parallel.ensemble import prng
from pivot_tpu_torch.parallel.ensemble.bill import _finalize
from pivot_tpu_torch.parallel.ensemble.draws import (
    _make_fault_schedule,
    _opportunistic_uniforms,
    _perturbations,
)
from pivot_tpu_torch.parallel.ensemble.state import (
    _DONE,
    EnsembleWorkload,
    RolloutResult,
    RolloutState,
    _init_state,
    _resolve_forms,
)
from pivot_tpu_torch.parallel.ensemble.tick import (
    _rollout_segment,
    check_options,
    loop_clock,
)

#: The state fields stored as int32 (``pivot_tpu``'s width).
_INT_FIELDS = ("stage", "place", "qpos")


def _segment_step(state, rt, arr, root_anchor, workload, topo, tick,
                  segment_ticks, **kw) -> RolloutState:
    """One checkpoint segment: at most ``segment_ticks`` ticks of the
    replicas' tick loop.  :func:`rollout_checkpointed` reaches it through
    the package (``pivot_tpu_torch.parallel.ensemble._segment_step``), so
    a caller can wrap it, as ``pivot_tpu``'s tests wrap theirs."""
    return _rollout_segment(state, rt, arr, root_anchor, workload, topo,
                            tick, segment_ticks, **kw)


def _fingerprint(
    key, n_replicas, tick, max_ticks, perturb, workload, topo, avail0,
    storage_zones, fault_cfg=(0, None, None), policy="cost-aware",
    congestion=False, realtime_scoring=False, tick_order="fifo",
    forms="indexed",
) -> str:
    """Hash of every input that determines the trajectory, array contents
    included: ``pivot_tpu``'s fields and compatibility rules (a token is
    appended only where an option departs from its default).  The port
    has one tick-body form, so ``forms`` resolves to ``"indexed"`` and
    adds no token.  Integer tensors are hashed as int32, the reference's
    width under jax's default config: on the same float32 inputs the
    port's fingerprint is ``pivot_tpu``'s."""
    congestion = "pairs" if congestion == "pairs" else bool(congestion)
    base = ("v2", np.asarray(key).tolist(), n_replicas, tick, max_ticks,
            perturb)
    if policy != "cost-aware":
        base = base + (policy,)
    if fault_cfg[0]:
        base = base + (fault_cfg,)
    if congestion:
        base = base + (("congestion",) if congestion is True
                       else (("congestion", congestion),))
    if realtime_scoring:
        base = base + ("realtime_scoring",)
    if tick_order != "fifo":
        base = base + (("tick_order", tick_order),)
        if policy == "first-fit":
            base = base + (("qpos", "return-order"),)
    _resolve_forms(forms)  # one tick body: every name hashes as "indexed"
    h = hashlib.sha256(repr(base).encode())
    for arr in (*workload, *topo, avail0, storage_zones):
        a = arr.detach().cpu()
        if not a.is_floating_point() and a.dtype != torch.bool:
            a = a.to(torch.int32)
        a = np.ascontiguousarray(a.numpy())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _load_state(path, fp, congestion, device) -> Optional[tuple]:
    """``(state, ticks_done)`` from the checkpoint at ``path`` when its
    fingerprint is ``fp`` and it holds every state field, else None."""
    with np.load(path, allow_pickle=False) as ckpt:
        if str(ckpt["fingerprint"]) != fp or \
                not set(RolloutState._fields) <= set(ckpt.files):
            return None
        fields = {}
        for f in RolloutState._fields:
            x = torch.from_numpy(np.array(ckpt[f])).to(device)  # graftcheck: ignore[dtype] -- each field comes back in the dtype the run saved it in (the run's own state dtype)
            fields[f] = x.long() if f in _INT_FIELDS else x
        if not congestion:
            fields["q"] = None
        return RolloutState(**fields), int(ckpt["ticks_done"])


def _save_state(path, fp, ticks_done, state, n_zones) -> None:
    """Write the checkpoint atomically: a temporary file, then a rename."""
    arrays = {}
    for f, v in zip(RolloutState._fields, state):
        if v is None:  # no congestion model: empty zone pipes
            R, _T = state.stage.shape
            v = torch.zeros((R, n_zones, state.avail.shape[1]),
                            dtype=state.avail.dtype)
        v = v.detach().cpu()
        arrays[f] = (v.to(torch.int32) if f in _INT_FIELDS else v).numpy()
    tmp = path + ".tmp.npz"  # np.savez keeps an .npz suffix
    np.savez(tmp, fingerprint=fp, ticks_done=ticks_done, **arrays)
    os.replace(tmp, path)


def rollout_checkpointed(
    key,
    avail0,
    workload: EnsembleWorkload,
    topo,
    storage_zones,
    checkpoint_path: Optional[str],
    n_replicas: int = 64,
    tick: float = 5.0,
    max_ticks: int = 512,
    perturb: float = 0.1,
    segment_ticks: int = 256,
    resume: bool = True,
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
    """:func:`rollout` in segments of ``segment_ticks`` ticks, writing the
    state to ``checkpoint_path`` (``.npz``) after each one and, with
    ``resume``, continuing from a file of the same arguments.  The
    result is bit-identical to one uninterrupted run at any
    ``segment_ticks``.  ``checkpoint_path=None`` runs the same segments
    without touching the disk.  The fault schedule is drawn once, eagerly
    (``fail_at + mttr · outage`` rounded twice, as ``pivot_tpu`` draws it
    here).  ``stats`` as in :func:`rollout`."""
    if segment_ticks <= 0:
        raise ValueError(f"segment_ticks must be positive, got "
                         f"{segment_ticks}")
    check_options(congestion, realtime_scoring, policy)
    workload.check_group_demands()
    forms = _resolve_forms(forms)
    fp = _fingerprint(
        key, n_replicas, tick, max_ticks, perturb, workload, topo, avail0,
        storage_zones, fault_cfg=(n_faults, fault_horizon, mttr),
        policy=policy, congestion=congestion,
        realtime_scoring=realtime_scoring, tick_order=tick_order,
        forms=forms)
    Z = topo.cost.shape[0]
    loaded = None
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        loaded = _load_state(checkpoint_path, fp, congestion, avail0.device)
    if loaded is not None:
        state, ticks_done = loaded
    else:
        state, ticks_done = _init_state(avail0, workload.n_tasks, Z,
                                        n_replicas, congestion=congestion), 0

    dtype, dev = avail0.dtype, avail0.device
    rt, arr, root_anchor = _perturbations(
        key, workload, storage_zones, n_replicas, perturb, dtype)
    faults = _make_fault_schedule(
        key, n_replicas, n_faults, avail0, tick, max_ticks, fault_horizon,
        mttr, contract=False) if n_faults else None
    task_u = _opportunistic_uniforms(
        key, n_replicas, workload.n_tasks, dtype, dev,
    ) if policy == "opportunistic" else None

    # Late-bound through the package, so that a wrapper installed there
    # sees every segment.
    from pivot_tpu_torch.parallel import ensemble as _pkg

    counts = stats if stats is not None else {}
    with loop_clock(counts, dev):
        while ticks_done < max_ticks and bool((state.stage != _DONE).any()):
            seg = min(segment_ticks, max_ticks - ticks_done)
            state = _pkg._segment_step(
                state, rt, arr, root_anchor, workload, topo, tick, seg,
                faults=faults, totals=avail0, policy=policy, task_u=task_u,
                congestion=congestion, realtime_scoring=realtime_scoring,
                forms=forms, tick_order=tick_order, stats=counts)
            ticks_done += seg
            if checkpoint_path:
                _save_state(checkpoint_path, fp, ticks_done, state, Z)
    return _finalize(state, workload, topo)


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
    ``replica_chunk <= 0`` (or ``>= n_replicas``) is one run: with a
    ``checkpoint_path``, :func:`rollout_checkpointed`; without one, one
    tick loop, the same bits (``pivot_tpu``'s segmented path, its fault
    schedule drawn eagerly: ``_rollout(contract=False)``).  With a
    ``checkpoint_path`` each chunk runs checkpointed at
    ``<root>.c<c><ext>``; without one, each chunk is one
    :func:`rollout`."""
    from pivot_tpu_torch.parallel import ensemble as _pkg

    if replica_chunk <= 0 or n_replicas <= replica_chunk:
        if checkpoint_path:
            return rollout_checkpointed(
                key, avail0, workload, topo, storage_zones, checkpoint_path,
                n_replicas=n_replicas, segment_ticks=segment_ticks,
                resume=resume, **kw)
        return _pkg._rollout(key, avail0, workload, topo, storage_zones,
                             n_replicas=n_replicas, contract=False, **kw)
    root, ext = os.path.splitext(checkpoint_path) if checkpoint_path \
        else ("", "")
    parts = []
    done = 0
    while done < n_replicas:
        c = len(parts)
        n = min(replica_chunk, n_replicas - done)
        ck = key if c == 0 else prng.fold_in(key, c)
        if checkpoint_path:
            parts.append(rollout_checkpointed(
                ck, avail0, workload, topo, storage_zones,
                f"{root}.c{c}{ext}", n_replicas=n,
                segment_ticks=segment_ticks, resume=resume, **kw))
        else:
            parts.append(_pkg.rollout(ck, avail0, workload, topo,
                                      storage_zones, n_replicas=n, **kw))
        done += n
    return RolloutResult(*(torch.cat(xs, 0) for xs in zip(*parts)))
