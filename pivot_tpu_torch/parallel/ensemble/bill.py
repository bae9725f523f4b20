"""Result finalization, the sampled egress bill, and the float helpers
that keep the port's roundings those of the JAX package on the CPU.

Port of ``pivot_tpu/parallel/ensemble/bill.py``.  Two facts of XLA's CPU
backend decide the roundings of ``pivot_tpu``'s rollout, and the port
reproduces both:

  * a multiply that feeds an add inside one fused loop is contracted to a
    fused multiply-add (``_fma``): the uniform draws' scaling, the pump
    times, and every ``sum(x * x)`` norm;
  * a sum over more than 32 elements is rewritten into sums of 32-wide
    windows, the padding split evenly between the two ends, and then a sum
    of the window sums (``_ordered_sum``); up to 32 elements it is a
    left-to-right sum from 0.

One rounding is not reproduced: the ``[G, Z] @ [Z, T]`` product of the
egress bill runs in XLA through a blocked GEMM whose rounding depends on
where an entry falls in the CPU's register tile — the same (group, zone)
pair comes out different in different task columns — so no fixed order
matches it.  The port bills per (group, zone) once and gathers, and its
egress bill agrees with ``pivot_tpu``'s to a few ulps, not bitwise.  On
the card the sums here are the CPU's (``_ordered_sum``) and the products
cuBLAS's fixed-order GEMMs, never an atomic: run to run the bill is the
same bits.
"""

from __future__ import annotations

import torch

from pivot_tpu_torch.ops.kernels import DeviceTopology
from pivot_tpu_torch.parallel.ensemble.prng import fma as _fma
from pivot_tpu_torch.parallel.ensemble.state import (
    _DONE,
    EnsembleWorkload,
    RolloutResult,
    RolloutState,
)

def _fma_norms(mat):
    """L2 norm over the last (size-4) axis as XLA computes
    ``sqrt(sum(x * x))``: a chain of fused multiply-adds from x0²."""
    acc = mat[..., 0] * mat[..., 0]
    for k in range(1, mat.shape[-1]):
        acc = _fma(mat[..., k], mat[..., k], acc)
    return torch.sqrt(acc)


def _ordered_sum(x):
    """Sum over the last axis in XLA:CPU's order (see the module
    docstring), on either device: elementwise adds, no atomics, so the
    card's sums are the CPU's bits."""
    n = x.shape[-1]
    if n > 32:
        nw = -(-n // 32)
        pad = nw * 32 - n
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = x.reshape(*x.shape[:-1], nw, 32)
        return _ordered_sum(_window_sum(x))
    return _window_sum(x)


def _window_sum(x):
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def _recip(value: float, dtype, device):
    """``1 / value`` rounded to ``dtype``: XLA turns a division by a
    constant into a multiplication by its reciprocal."""
    return torch.ones((), dtype=dtype, device=device) / value


def _sampling_table(workload: EnsembleWorkload):
    """(inst, samp): per-group instance counts and the DES pull-sample
    table ``samp[c, g] = max(round(inst[g] / inst[c]), 1)`` (banker's
    rounding, as ``jnp.round``)."""
    inst = torch.clamp_min(_ordered_sum(workload.group_onehot.T), 1.0)
    samp = torch.clamp_min(torch.round(inst[None, :] / inst[:, None]), 1.0)
    return inst, samp


def _sampled_egress(workload, topo, zcp, pz, placed):
    """DES-faithful egress estimate, batched over replicas: one bill per
    sampled pull, the source distributed like the producer's placed
    instances (``zcp`` [R, G, Z] counts; ``pz`` [R, T] consumer zones;
    ``placed`` [R, T] bool)."""
    n_placed_g = _ordered_sum(zcp)[..., None]  # [R, G, 1]
    src_frac = torch.where(n_placed_g > 0,
                           zcp / torch.clamp_min(n_placed_g, 1.0),
                           torch.zeros((), dtype=zcp.dtype,
                                       device=zcp.device))
    w = src_frac * workload.out_group[None, :, None]  # [R, G, Z]
    # d[g, i] = Σ_z w[g, z] · cost[z, zone(i)] depends on task i only
    # through its zone: one [G, Z] @ [Z, Z] product per replica.
    d_gz = torch.matmul(w, topo.cost)  # [R, G, Z]
    _, samp = _sampling_table(workload)
    pull = (workload.pred_group * samp).to(zcp.dtype)  # consumer × producer
    per_gz = torch.matmul(pull, d_gz)  # [R, G, Z]: per-pull cost per
    # consumer group and consumer zone
    R, G, Z = per_gz.shape
    T = pz.shape[1]
    flat = (workload.group_of[None, :] * Z + pz)  # [R, T]
    per_task = per_gz.reshape(R, G * Z).gather(1, flat)
    billed = torch.where(placed, per_task, torch.zeros((), dtype=zcp.dtype,
                                                       device=zcp.device))
    return _ordered_sum(billed) * _recip(8000.0, zcp.dtype, zcp.device)


def _finalize(state: RolloutState, workload: EnsembleWorkload,
              topo: DeviceTopology, active=None) -> RolloutResult:
    """Result metrics of R final replica states; with ``active`` (``[R,
    T]`` or ``[T]`` bool) only active tasks count as unfinished."""
    H = state.avail.shape[1]
    dtype, dev = state.avail.dtype, state.avail.device
    finish, place, stage = state.finish, state.place, state.stage
    R, T = stage.shape
    Z = topo.cost.shape[0]
    G = workload.n_groups
    done = stage == _DONE
    zero = torch.zeros((), dtype=dtype, device=dev)
    makespan = torch.where(done, finish, zero).amax(1) if T else \
        torch.zeros(R, dtype=dtype, device=dev)
    pz = topo.host_zone.long()[place.clamp(0, H - 1)]
    placed = place >= 0
    # [R, G, Z] placed-instance counts: integer-valued, exact in any order.
    slot = (torch.arange(R, device=dev)[:, None] * (G * Z)
            + workload.group_of[None, :] * Z + pz)
    slot = torch.where(placed, slot, R * G * Z)
    # graftcheck: ignore[determinism] -- integer-valued counts: exact in any order
    zcp = torch.zeros(R * G * Z + 1, dtype=dtype, device=dev).index_add_(
        0, slot.reshape(-1), placed.reshape(-1).to(dtype))[:-1]
    egress = _sampled_egress(workload, topo, zcp.reshape(R, G, Z), pz,
                             placed)
    return RolloutResult(
        makespan=makespan,
        egress_cost=egress,
        finish_time=finish,
        placement=place.to(torch.int32),
        n_unfinished=(~done if active is None else ~done & active).sum(-1),
        instance_hours=state.busy * _recip(3600.0, dtype, dev),
    )
