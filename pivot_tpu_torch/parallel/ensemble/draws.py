"""Monte-Carlo draws.

Port of ``pivot_tpu/parallel/ensemble/draws.py``.  Every draw comes from
the threefry twin (``prng.py``), bit-equal to ``jax.random`` on the same
key: the perturbations, the opportunistic uniforms and the fault
schedules (``randint`` and ``exponential`` twins); the keyed
root-anchor draw is ``pivot_tpu_torch.sched.rand.keyed_storage_index``
in uint32 math.  ``pivot_tpu``'s packed-extras convention
(``_pack_extras`` / ``_unpack_extras``) has no counterpart: it flattens
the optional per-replica operands for ``vmap``'s ``in_axes``, and the
port's tick body takes each as a ``[B, ...]`` tensor directly.
"""

from __future__ import annotations

import numpy as np
import torch

from pivot_tpu_torch.parallel.ensemble import libm, prng

_M32 = 0xFFFFFFFF


def _fault_schedule(key, n_replicas, n_faults, n_hosts, horizon, mttr,
                    dtype, device="cpu", *, contract):
    """Per-replica random crash schedules ``(host [R, F] int64, fail_at
    [R, F], recover_at [R, F])``, mirroring
    ``FaultInjector.random_host_failures``: ``n_faults`` crashes at
    uniform times in ``[0, horizon)`` on uniformly drawn hosts, each
    recovering after an Exp(mean=``mttr``) outage (never, if ``mttr`` is
    None).  ``n_hosts`` may be a 0-d tensor.  The host draw's integer
    width follows the float width, as jax's ``randint`` follows
    ``jax_enable_x64`` (the float64 runs pair with x64).
    ``recover_at = fail_at + mttr · outage`` rounds once where ``pivot_tpu``
    draws inside a jitted program (``rollout``: XLA:CPU contracts the
    multiply-add, ``contract=True``) and twice where it draws eagerly, one
    jitted call per op (``capacity_sweep``, ``rollout_checkpointed``:
    ``contract=False``)."""
    if mttr is not None:
        libm.require_host(dtype, device, "fault outages")
    k_t, k_h, k_d = prng.split(key, 3)
    shape = (n_replicas, n_faults)
    fail_at = prng.uniform(k_t, shape, dtype, 0.0, horizon, device)
    host = prng.randint(k_h, shape, 0, n_hosts,
                        bits=64 if dtype == torch.float64 else 32,
                        device=device)
    if mttr is None:
        recover_at = torch.full(shape, float("inf"), dtype=dtype,
                                device=device)
    else:
        outage = prng.exponential(k_d, shape, dtype, device)
        mttr = float(np.float32(mttr)) if dtype == torch.float32 else \
            float(mttr)
        recover_at = prng.fma(outage, mttr, fail_at) if contract else \
            fail_at + outage * mttr
    return host, fail_at, recover_at


def _make_fault_schedule(key, n_replicas, n_faults, avail0, tick,
                         max_ticks, fault_horizon, mttr, *, contract):
    """The rollout's fault draws: ``fold_in(key, 0x0FA17)`` (not split),
    so fault-free draws keep their bits.  ``contract``: drawn as inside
    ``pivot_tpu``'s jitted ``rollout`` (True) or as its
    ``rollout_checkpointed`` draws them, eagerly (False)."""
    horizon = fault_horizon if fault_horizon is not None else \
        tick * max_ticks
    return _fault_schedule(prng.fold_in(key, 0x0FA17), n_replicas,
                           n_faults, avail0.shape[-2], horizon, mttr,
                           avail0.dtype, avail0.device, contract=contract)


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

