"""The greedy-placement pass as a hand-written CUDA kernel.

Replaces ``pivot_tpu/ops/pallas_kernels.py``: ``cost_aware_cuda_batched``
stands for ``cost_aware_pallas_batched`` (``:265``, body
``_greedy_body_batched`` ``:131``) and ``cost_aware_cuda`` for its R = 1
case ``cost_aware_pallas`` (``:78``), with the same argument contract.
Both launch ``greedy_place`` (``csrc/greedy_place.cu``): one CTA per
replica, the replica's availability, frozen group scores and best-fit
counters in shared memory for the whole pass.

What bounds the kernel on the card: a T-step serial chain of block-wide
(value, index) reductions — each task's choice feeds the next task's fit
test — so it is latency-bound, not FLOP- or byte-bound.  The design keeps
all carried state on chip and gives each replica its own CTA, so the
R = 256 Monte-Carlo launch fills the card's SMs with independent chains.

Phase 1 — the ``[Z, H]`` round-trip cost and bandwidth tables — is built
with torch outside the kernel, as the JAX package builds it outside its
``pallas_call``; the kernel reads row ``anchor_zone[i]`` per step and no
``[T, H]`` table is ever materialized.

Beside the kernel, ``cost_aware_plain_batched`` / ``cost_aware_plain`` are
the same pass as a straightforward torch loop over tasks with the
kernel's arithmetic.  The wrappers take the plain version for tensors on
the CPU — and only then: on a CUDA tensor they launch the kernel or raise.

``LAUNCHES["greedy_place"]`` counts kernel launches (never plain calls).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

__all__ = [
    "LAUNCHES",
    "MAX_HOSTS",
    "reset_launches",
    "cost_aware_cuda",
    "cost_aware_cuda_batched",
    "cost_aware_plain",
    "cost_aware_plain_batched",
]

#: Kernel launches since the last :func:`reset_launches`, by kernel name.
LAUNCHES = {"greedy_place": 0}

_BIG = 1e30
_NEG = -1e30
#: Shared memory one CTA may opt into on Hopper (227 KB).
_SMEM_LIMIT = 232448
#: 24 bytes per host (four availability lanes, one frozen score, one
#: counter) plus 512 bytes of reduction slots — ``greedy_place_smem_bytes``.
MAX_HOSTS = (_SMEM_LIMIT - 512) // 24


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(avail_r, demands, valid, new_group, anchor_zone, cost_zz, bw_zz,
           host_zone, base_task_counts, bin_pack, live, risk, n_eff):
    """Validate the argument contract; returns ``(R, T, H, n_eff)``."""
    if bin_pack not in ("first-fit", "best-fit"):
        raise ValueError(f"bin_pack must be 'first-fit' or 'best-fit', "
                         f"got {bin_pack!r}")
    if avail_r.dim() != 3 or avail_r.shape[2] != 4:
        raise ValueError(f"avail must be [R, H, 4], got {tuple(avail_r.shape)}")
    R, H = avail_r.shape[0], avail_r.shape[1]
    T = demands.shape[0]
    Z = cost_zz.shape[0]
    spec = [
        ("avail", avail_r, torch.float32, (R, H, 4)),
        ("demands", demands, torch.float32, (T, 4)),
        ("valid", valid, torch.bool, (T,)),
        ("new_group", new_group, torch.bool, (T,)),
        ("anchor_zone", anchor_zone, torch.int32, (T,)),
        ("cost_zz", cost_zz, torch.float32, (Z, Z)),
        ("bw_zz", bw_zz, torch.float32, (Z, Z)),
        ("host_zone", host_zone, torch.int32, (H,)),
        ("base_task_counts", base_task_counts, torch.int32, (H,)),
    ]
    if live is not None:
        spec.append(("live", live, torch.bool, (H,)))
    if risk is not None:
        spec.append(("risk", risk, torch.float32, (H,)))
    for name, t, dtype, shape in spec:
        if t.device != avail_r.device:
            raise ValueError(f"{name} is on {t.device}, avail on "
                             f"{avail_r.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if H < 1:
        raise ValueError("the greedy pass needs at least one host")
    if H > MAX_HOSTS:
        raise ValueError(
            f"H={H} hosts need {24 * H + 512} bytes of shared memory per "
            f"CTA, above the {_SMEM_LIMIT}-byte (227 KB) opt-in limit of "
            f"one Hopper CTA; at most {MAX_HOSTS} hosts fit"
        )
    if n_eff is None:
        n_eff = T
    elif not 0 <= n_eff <= T:
        raise ValueError(f"n_eff must be in [0, {T}], got {n_eff}")
    return R, T, H, n_eff


def _phase1(cost_zz, bw_zz, host_zone):
    """The ``[Z, H]`` round-trip tables (``pallas_kernels.py:398-403``)."""
    hz = host_zone.long()
    cost_rt = (cost_zz[:, hz] + cost_zz[hz, :].T).contiguous()
    bw_rt = (bw_zz[:, hz] + bw_zz[hz, :].T).contiguous()
    return cost_rt, bw_rt


# ---------------------------------------------------------------------------
# The plain version: the kernel's pass as a torch loop over tasks.
# ---------------------------------------------------------------------------


def cost_aware_plain_batched(avail_r, demands, valid, new_group, anchor_zone,
                             cost_zz, bw_zz, host_zone, base_task_counts,
                             bin_pack: str = "first-fit",
                             sort_hosts: bool = True,
                             host_decay: bool = False, live=None, risk=None,
                             n_eff: Optional[int] = None):
    """The greedy pass of :func:`cost_aware_cuda_batched` as a torch loop
    over tasks, vectorized over ``[R, H]``, with the kernel's arithmetic
    in the kernel's operand order.  Walks tasks ``[0, n_eff)`` (default
    all ``T``); ``n_eff`` must be at least one past the last valid task.
    Returns ``([R, T] int32 placements, [R, H, 4] availability)``."""
    R, T, H, n_eff = _check(avail_r, demands, valid, new_group, anchor_zone,
                            cost_zz, bw_zz, host_zone, base_task_counts,
                            bin_pack, live, risk, n_eff)
    dev = avail_r.device
    placements = torch.full((R, T), -1, dtype=torch.int32, device=dev)
    if T == 0 or R == 0:
        return placements, avail_r.clone()
    first_fit = bin_pack == "first-fit"
    cost_rt, bw_rt = _phase1(cost_zz, bw_zz, host_zone)
    base = base_task_counts.to(torch.float32)
    a = avail_r.clone()
    if live is not None:
        a = torch.where(live[None, :, None], a, a.new_full((), _NEG))
    a = [a[:, :, k].clone() for k in range(4)]  # four [R, H] lanes
    lane = torch.arange(H, device=dev)
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    frozen = torch.zeros(R, H, dtype=torch.float32, device=dev)
    extra = torch.zeros(R, H, dtype=torch.float32, device=dev)
    # The per-task control stream, read on the host once.
    valid_h = valid[:n_eff].tolist()
    ng_h = new_group[:n_eff].tolist()
    az_h = anchor_zone[:n_eff].tolist()
    for j in range(n_eff):
        d = demands[j]
        if first_fit:
            if ng_h[j]:
                if sort_hosts:
                    norms = torch.sqrt(
                        ((a[0] * a[0] + a[1] * a[1]) + a[2] * a[2])
                        + a[3] * a[3]
                    )
                    num = cost_rt[az_h[j]]
                    if host_decay:
                        num = num * torch.clamp_min(base, 1.0)
                    frozen = num / (norms * bw_rt[az_h[j]])
                    if risk is not None:
                        frozen = frozen + risk
                elif risk is not None:
                    frozen = risk.expand(R, H)
                else:
                    frozen = lane.to(torch.float32).expand(R, H)
            fit = (a[0] > d[0]) & (a[1] > d[1]) & (a[2] > d[2]) & (a[3] > d[3])
            cand = torch.where(fit & valid_h[j], frozen, big)
        else:
            r = [a[k] - d[k] for k in range(4)]
            residual = torch.sqrt(
                ((r[0] * r[0] + r[1] * r[1]) + r[2] * r[2]) + r[3] * r[3]
            )
            decay = (torch.clamp_min(base + extra, 1.0) if host_decay
                     else 1.0)
            score = cost_rt[az_h[j]] * residual * decay / bw_rt[az_h[j]]
            if risk is not None:
                score = score + risk
            fit = ((a[0] >= d[0]) & (a[1] >= d[1]) & (a[2] >= d[2])
                   & (a[3] >= d[3]))
            cand = torch.where(fit & valid_h[j], score, big)
        m = cand.min(dim=1, keepdim=True).values  # NaN propagates, as in JAX
        ok = m < _BIG
        h = torch.where(cand == m, lane, H).min(dim=1, keepdim=True).values
        onehot = ((lane == h) & ok).to(torch.float32)
        a = [a[k] - d[k] * onehot for k in range(4)]
        if not first_fit:
            extra = extra + onehot
        placements[:, j] = torch.where(ok, h, -1)[:, 0].to(torch.int32)
    out = torch.stack(a, dim=2)
    if live is not None:
        out = torch.where(live[None, :, None], out, avail_r)
    return placements, out


def cost_aware_plain(avail, demands, valid, new_group, anchor_zone, cost_zz,
                     bw_zz, host_zone, base_task_counts,
                     bin_pack: str = "first-fit", sort_hosts: bool = True,
                     host_decay: bool = False, live=None, risk=None,
                     n_eff: Optional[int] = None):
    """One replica of :func:`cost_aware_plain_batched`:
    ``[H, 4]`` → ``([T] int32, [H, 4])``."""
    p, a = cost_aware_plain_batched(
        avail[None], demands, valid, new_group, anchor_zone, cost_zz, bw_zz,
        host_zone, base_task_counts, bin_pack=bin_pack, sort_hosts=sort_hosts,
        host_decay=host_decay, live=live, risk=risk, n_eff=n_eff,
    )
    return p[0], a[0]


# ---------------------------------------------------------------------------
# The kernel.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _launcher():
    """``greedy_place_launch`` of the built library, typed: twelve
    pointers, seven ints, the stream."""
    from pivot_tpu_torch.ops.build import load

    fn = load("greedy_place").greedy_place_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return fn


def cost_aware_cuda_batched(avail_r, demands, valid, new_group, anchor_zone,
                            cost_zz, bw_zz, host_zone, base_task_counts,
                            bin_pack: str = "first-fit",
                            sort_hosts: bool = True,
                            host_decay: bool = False, live=None, risk=None,
                            n_eff: Optional[int] = None):
    """Replica-batched greedy pass, ``R`` replicas sharing one task stream
    — the contract of ``pivot_tpu``'s ``cost_aware_pallas_batched``:

      avail_r [R, H, 4] f32, demands [T, 4] f32, valid / new_group [T]
      bool, anchor_zone [T] i32, cost_zz / bw_zz [Z, Z] f32, host_zone
      [H] i32, base_task_counts [H] i32, optional live [H] bool and risk
      [H] f32, all contiguous and on one device.

    Returns ``([R, T] int32 placements, [R, H, 4] f32 availability)``.
    ``n_eff`` (default ``T``) stops the pass after task ``n_eff − 1``; a
    caller that knows its last valid task passes one past it.

    CUDA tensors launch ``greedy_place`` on the current stream (outputs
    from ``torch.empty``, no synchronisation); CPU tensors take
    :func:`cost_aware_plain_batched`; anything else raises."""
    args = (avail_r, demands, valid, new_group, anchor_zone, cost_zz, bw_zz,
            host_zone, base_task_counts)
    if avail_r.device.type == "cpu":
        return cost_aware_plain_batched(
            *args, bin_pack=bin_pack, sort_hosts=sort_hosts,
            host_decay=host_decay, live=live, risk=risk, n_eff=n_eff,
        )
    if avail_r.device.type != "cuda":
        raise ValueError(f"greedy_place runs on cuda or (plain) cpu tensors, "
                         f"got {avail_r.device}")
    R, T, H, n_eff = _check(*args, bin_pack, live, risk, n_eff)
    placements = torch.empty((R, T), dtype=torch.int32, device=avail_r.device)
    avail_out = torch.empty_like(avail_r)
    if T == 0 or R == 0:
        avail_out.copy_(avail_r)
        return placements, avail_out
    cost_rt, bw_rt = _phase1(cost_zz, bw_zz, host_zone)
    base = base_task_counts.to(torch.float32)
    with torch.cuda.device(avail_r.device):
        err = _launcher()(
            avail_r.data_ptr(), demands.data_ptr(), valid.data_ptr(),
            new_group.data_ptr(), anchor_zone.data_ptr(), cost_rt.data_ptr(),
            bw_rt.data_ptr(), base.data_ptr(),
            None if risk is None else risk.data_ptr(),
            None if live is None else live.data_ptr(),
            placements.data_ptr(), avail_out.data_ptr(),
            R, T, n_eff, H, int(bin_pack == "first-fit"), int(sort_hosts),
            int(host_decay), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"greedy_place launch failed: CUDA error {err}")
    LAUNCHES["greedy_place"] += 1
    return placements, avail_out


def cost_aware_cuda(avail, demands, valid, new_group, anchor_zone, cost_zz,
                    bw_zz, host_zone, base_task_counts,
                    bin_pack: str = "first-fit", sort_hosts: bool = True,
                    host_decay: bool = False, live=None, risk=None,
                    n_eff: Optional[int] = None):
    """One tick: the R = 1 launch of :func:`cost_aware_cuda_batched`
    (``pivot_tpu``'s ``cost_aware_pallas``): ``[H, 4]`` → ``([T] int32
    placements, [H, 4] availability)``."""
    p, a = cost_aware_cuda_batched(
        avail[None], demands, valid, new_group, anchor_zone, cost_zz, bw_zz,
        host_zone, base_task_counts, bin_pack=bin_pack, sort_hosts=sort_hosts,
        host_decay=host_decay, live=live, risk=risk, n_eff=n_eff,
    )
    return p[0], a[0]
