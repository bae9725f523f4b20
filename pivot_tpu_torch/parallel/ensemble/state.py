"""Ensemble state types: workload encoding, rollout state and result.

Port of ``pivot_tpu/parallel/ensemble/state.py``.  The tensors live on
one torch device; every per-replica field carries a leading replica axis
``R`` (the JAX package vmaps an unbatched state instead).
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from pivot_tpu_torch.ops.kernels import resolve_device

# check_group_demands verdict cache: (id(demands), id(group_of)) →
# (weakref(demands), weakref(group_of)); an entry counts only while both
# refs still point at the same live tensors.
_checked_demands: dict = {}


class EnsembleWorkload(NamedTuple):
    """Dense, instance-level workload description (static across
    replicas): every task-group instance is one row, with the workload's
    group structure alongside the instance-level ``pred`` matrix."""

    demands: torch.Tensor  # [T, 4]
    runtime: torch.Tensor  # [T]
    output_size: torch.Tensor  # [T]
    arrival: torch.Tensor  # [T] submission time of the owning app
    pred: torch.Tensor  # [T, T] — pred[i, p] = 1 iff p precedes i
    group_of: torch.Tensor  # [T] int64 — owning group index per instance
    group_onehot: torch.Tensor  # [T, G] — one_hot(group_of)
    pred_group: torch.Tensor  # [G, G] — group-level adjacency
    out_group: torch.Tensor  # [G] per-group output size (MB)
    app_of: torch.Tensor  # [T] int64 — owning application index

    @property
    def n_tasks(self) -> int:
        return self.runtime.shape[0]

    @property
    def n_groups(self) -> int:
        return self.out_group.shape[0]

    def check_group_demands(self) -> None:
        """Raise if any group's instances disagree on their demand vector
        (the rollout's group-level fit test relies on it).  The verdict is
        cached per live demands tensor."""
        key = (id(self.demands), id(self.group_of))
        refs = _checked_demands.get(key)
        if (refs is not None and refs[0]() is self.demands
                and refs[1]() is self.group_of):
            return
        dem = self.demands.cpu().numpy()
        go = self.group_of.cpu().numpy()
        table = np.zeros((self.n_groups, dem.shape[1]), dem.dtype)
        table[go] = dem
        if not np.array_equal(table[go], dem):
            bad = np.nonzero(np.any(table[go] != dem, axis=1))[0]
            raise ValueError(
                "EnsembleWorkload demands vary within a group (first "
                f"offending task rows: {bad[:5].tolist()}); the rollout's "
                "group-level fit test requires group-constant demands — "
                "build workloads via EnsembleWorkload.from_applications"
            )
        if len(_checked_demands) > 256:  # prune dead refs, bound growth
            for k in [k for k, (rd, rg) in _checked_demands.items()
                      if rd() is None or rg() is None]:
                del _checked_demands[k]
        _checked_demands[key] = (weakref.ref(self.demands),
                                 weakref.ref(self.group_of))

    @classmethod
    def from_applications(cls, apps, arrivals=None, dtype=torch.float32,
                          device="cuda") -> "EnsembleWorkload":
        """Flatten applications to instance level.  Every instance of a
        group depends on every instance of each predecessor group."""
        dev = resolve_device(device)
        demands, runtime, output, arrival = [], [], [], []
        group_of, out_group, app_of = [], [], []
        offset = 0
        gi = 0
        edges = []
        group_edges = []
        for ai, app in enumerate(apps):
            at = float(arrivals[ai]) if arrivals is not None else 0.0
            index = {}
            for g in app.groups:
                index[g.id] = (offset, g.instances, gi)
                out_group.append(g.output_size)
                for _ in range(g.instances):
                    demands.append([g.cpus, g.mem, g.disk, g.gpus])
                    runtime.append(g.runtime)
                    output.append(g.output_size)
                    arrival.append(at)
                    group_of.append(gi)
                    app_of.append(ai)
                offset += g.instances
                gi += 1
            for g in app.groups:
                gs, gn, gg = index[g.id]
                for dep in g.dependencies:
                    ps, pn, pg = index[dep]
                    edges.append(((gs, gn), (ps, pn)))
                    group_edges.append((gg, pg))
        T, G = offset, gi
        pred = np.zeros((T, T), dtype=np.float32)
        for (gs, gn), (ps, pn) in edges:
            pred[gs: gs + gn, ps: ps + pn] = 1.0
        pred_group = np.zeros((G, G), dtype=np.float32)
        for gg, pg in group_edges:
            pred_group[gg, pg] = 1.0
        group_of_arr = np.asarray(group_of, dtype=np.int64)
        group_onehot = np.zeros((T, G), dtype=np.float32)
        group_onehot[np.arange(T), group_of_arr] = 1.0

        def put(x, dt=dtype):
            # Through float64 numpy, like ``jnp.asarray(np.array(x), dtype)``.
            return torch.as_tensor(np.asarray(x), device=dev).to(dt)

        return cls(
            demands=put(np.array(demands, dtype=np.float64).reshape(T, 4)),
            runtime=put(np.array(runtime, dtype=np.float64)),
            output_size=put(np.array(output, dtype=np.float64)),
            arrival=put(np.array(arrival, dtype=np.float64)),
            pred=put(pred),
            group_of=put(group_of_arr, torch.int64),
            group_onehot=put(group_onehot),
            pred_group=put(pred_group),
            out_group=put(np.array(out_group, dtype=np.float64)),
            app_of=put(np.asarray(app_of, dtype=np.int64), torch.int64),
        )


class RolloutResult(NamedTuple):
    makespan: torch.Tensor  # [R]
    egress_cost: torch.Tensor  # [R]
    finish_time: torch.Tensor  # [R, T]
    placement: torch.Tensor  # [R, T] host index (int32)
    n_unfinished: torch.Tensor  # [R] tasks still pending at the horizon
    instance_hours: torch.Tensor  # [R] busy host-hours (tick-resolution)


class RolloutState(NamedTuple):
    """The full mutable state of R replicas' rollouts."""

    t: torch.Tensor  # [R] sim time
    stage: torch.Tensor  # [R, T] int64
    finish: torch.Tensor  # [R, T]
    place: torch.Tensor  # [R, T] int64
    avail: torch.Tensor  # [R, H, 4]
    busy: torch.Tensor  # [R] busy host-seconds accumulator
    q: Optional[torch.Tensor]  # [R, Z, H] queued MB per (src zone → dst
    # host) pipe, [R, H, H] per (src host → dst host) under
    # congestion="pairs"; None without the congestion model
    qpos: torch.Tensor  # [R, T] int64 last-batch position of a waiting
    # task (−1 otherwise) — the wait-queue order carry of tick_order="lifo"


# Task stages.
_PENDING, _RUNNING, _DONE = 0, 1, 2


def _resolve_forms(forms: Optional[str]) -> str:
    """The JAX package's tick body has a one-hot ``"vector"`` form and a
    gather/segment ``"indexed"`` form, held bit-identical to each other.
    The port implements the indexed semantics once; both names (and the
    default ``None``) select it."""
    if forms not in (None, "vector", "indexed"):
        raise ValueError(f"forms must be 'vector' or 'indexed', got {forms!r}")
    return "indexed"


def _init_state(avail0, T: int, Z: int, n_replicas: int = 1,
                congestion=False) -> RolloutState:
    """The initial state of ``n_replicas`` rows on ``avail0``: ``[H, 4]``
    shared by every row, or ``[R, H, 4]`` one per row (the capacity
    sweep's candidates differ by row).  With ``congestion`` the backlog
    pipes start empty: rows are source zones, or source hosts for
    ``"pairs"``, columns destination hosts (``pivot_tpu``'s
    ``state.py:215-231``); without it ``q`` is None."""
    dtype, dev = avail0.dtype, avail0.device
    R = n_replicas
    H = avail0.shape[-2]
    if avail0.dim() == 3 and avail0.shape[0] != R:
        raise ValueError(f"per-row availability has {avail0.shape[0]} rows "
                         f"for {R} replicas")
    return RolloutState(
        t=torch.zeros(R, dtype=dtype, device=dev),
        stage=torch.full((R, T), _PENDING, dtype=torch.int64, device=dev),
        finish=torch.full((R, T), float("inf"), dtype=dtype, device=dev),
        place=torch.full((R, T), -1, dtype=torch.int64, device=dev),
        avail=avail0.expand(R, *avail0.shape[-2:]).clone(),
        busy=torch.zeros(R, dtype=dtype, device=dev),
        q=torch.zeros((R, H if congestion == "pairs" else Z, H), dtype=dtype,
                      device=dev) if congestion else None,
        qpos=torch.full((R, T), -1, dtype=torch.int64, device=dev),
    )
