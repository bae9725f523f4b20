"""Monte-Carlo draws.

Port of ``pivot_tpu/parallel/ensemble/draws.py`` without the fault
schedules (``_fault_schedule`` / ``_make_fault_schedule`` need
``randint`` and ``exponential`` twins: ROADMAP.md Queue 1).  Every draw
comes from the threefry twin (``prng.py``), bit-equal to ``jax.random``
on the same key; the keyed root-anchor draw is
``pivot_tpu_torch.sched.rand.keyed_storage_index`` in uint32 math.
``pivot_tpu``'s packed-extras convention (``_pack_extras``) has no
counterpart: it flattens the optional per-replica operands for
``vmap``'s ``in_axes``, and the port passes each as a tensor with the
replica axis in front.
"""

from __future__ import annotations

import numpy as np
import torch

from pivot_tpu_torch.parallel.ensemble import prng

_M32 = 0xFFFFFFFF


def _opportunistic_uniforms(key, n_replicas, n_tasks, dtype, device):
    """Base uniform per (replica, task) for the opportunistic arm, drawn
    from ``fold_in(key, 0x09901)`` so the other arms' streams stay
    untouched."""
    return prng.uniform(prng.fold_in(key, 0x09901), (n_replicas, n_tasks),
                        dtype=dtype, device=device)


def _seed_bits(key) -> int:
    """uint32 seed word of a key: for ``PRNGKey(s)`` exactly ``s``."""
    return int(np.asarray(key, dtype=np.uint32).reshape(-1)[-1])


def _keyed_storage_index(seed_bits, app_ids, n_storage: int, salt):
    """Torch twin of :func:`pivot_tpu_torch.sched.rand.
    keyed_storage_index`: the same uint32 math, in int64 masked to 32
    bits.  ``app_ids`` and ``salt`` are int64 tensors (broadcast)."""
    a, b, c = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35
    x = ((((int(seed_bits) & _M32) * a) & _M32) + salt) & _M32
    x = x ^ (x >> 16)
    x = (x * b + (app_ids & _M32) * a) & _M32
    x = x ^ (x >> 13)
    x = (x * c) & _M32
    x = x ^ (x >> 16)
    return x % n_storage


def _perturbations(key, workload, storage_zones, n_replicas, perturb,
                   dtype):
    """Per-replica draws: runtimes and arrivals jittered by ``±perturb``
    and the keyed root anchors (replica salt r; r = 0 is the DES's draw).
    The key is split in three and the third key stays unused, as in
    ``pivot_tpu``."""
    T = workload.n_tasks
    dev = workload.runtime.device
    k_rt, k_arr, _k_retired = prng.split(key, 3)
    lo, hi = 1 - perturb, 1 + perturb
    rt = workload.runtime[None, :] * prng.uniform(
        k_rt, (n_replicas, T), dtype, lo, hi, dev)
    arr = workload.arrival[None, :] * prng.uniform(
        k_arr, (n_replicas, T), dtype, lo, hi, dev)
    salts = torch.arange(n_replicas, dtype=torch.int64, device=dev)
    anchor_idx = _keyed_storage_index(
        _seed_bits(key), workload.app_of[None, :], storage_zones.shape[0],
        salts[:, None])
    root_anchor = storage_zones.long()[anchor_idx]
    return rt, arr, root_anchor

