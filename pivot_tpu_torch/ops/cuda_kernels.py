"""The greedy-placement pass as a hand-written CUDA kernel.

Replaces ``pivot_tpu/ops/pallas_kernels.py``: ``cost_aware_cuda_batched``
stands for ``cost_aware_pallas_batched`` (``:265``, body
``_greedy_body_batched`` ``:131``) and ``cost_aware_cuda`` for its R = 1
case ``cost_aware_pallas`` (``:78``), with the same argument contract.
Both launch ``greedy_place`` (``csrc/greedy_place.cu``) once, on the
operands as given: the kernel forms phase 1's round trips from the
``[Z, Z]`` tables itself, so a call issues no other device operation.

What bounds the kernel on the card: a T-step serial chain of argmins —
each task's choice feeds the next task's fit test — so it is
latency-bound, not FLOP- or byte-bound.  The kernel keeps each host's
state in registers of the thread that owns it, stages the task stream in
shared memory a chunk ahead, and reduces with ``redux.sync``; a replica
is a group of W warps, several groups to a block.  :func:`_launch_config`
picks W, the hosts per thread K and the groups per block.

Beside the kernel, ``cost_aware_plain_batched`` / ``cost_aware_plain`` are
the same pass as a straightforward torch loop over tasks with the
kernel's arithmetic, phase 1 as torch ops.  The wrappers take the plain
version for tensors on the CPU — and only then: on a CUDA tensor they
launch the kernel or raise.

``LAUNCHES["greedy_place"]`` counts kernel launches (never plain calls).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

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
_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
#: Shared memory one block may opt into on Hopper (227 KB).
_SMEM_LIMIT = 232448
#: SMs of an H100 SXM; replica groups spread over about this many blocks.
_SMS = 132
#: Hosts per thread the kernel is built for with per-host state in
#: registers, and each build's thread limit per block (``max_threads`` in
#: ``csrc/greedy_place.cu``, its ``__launch_bounds__``): K hosts of state
#: must fit the 64K-register file.
_REG_THREADS = {1: 1024, 2: 1024, 3: 768, 4: 640, 5: 512, 6: 512, 8: 384,
                10: 320, 12: 256, 16: 256, 20: 256}
#: Hosts per thread once the state outgrows the register file and moves to
#: shared memory (20 bytes a host), at up to 1,024 threads.
_SMEM_K = 10
#: The most hosts a replica can have: 1,024 threads of ``_SMEM_K`` hosts,
#: the largest K whose shared-memory state fits 227 KB beside the tables.
MAX_HOSTS = 32 * 32 * _SMEM_K
#: The default shape's step model: a warp issues K host evaluations per
#: thread, warps beyond four share a scheduler, and W > 1 adds one
#: cross-warp exchange that costs about this many host evaluations.
_EXCHANGE_HOSTS = 4


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class _Config(NamedTuple):
    """One launch shape of ``greedy_place``."""

    warps: int             # W: warps per replica group
    hosts_per_thread: int  # K
    smem_state: bool       # per-host state in shared memory, not registers
    groups: int            # G: replica groups per block
    threads: int           # 32·W·G
    blocks: int            # ⌈R / G⌉
    smem_bytes: int


def _smem_bytes(Z, W, G, K, smem_state) -> int:
    """``greedy_place_smem_bytes``: the [Z, Z] tables, per group the
    double-buffered task chunk (40 B a task) and the cross-warp slots,
    and shared-memory state (20 B a host slot)."""
    def align16(n):
        return -(-n // 16) * 16
    chunk = min(32 * W, 256)
    return (align16(8 * Z * Z) + G * align16(40 * chunk + 16 * W)
            + (20 * K * 32 * W if smem_state else 0))


def _limit_message(H, Z) -> str:
    return (
        f"H={H} hosts at Z={Z} outgrow greedy_place: past the register "
        f"file each host keeps 20 bytes of state in shared memory beside "
        f"the {8 * Z * Z}-byte [Z, Z] tables, and one Hopper CTA may opt "
        f"into at most {_SMEM_LIMIT} bytes (227 KB) of it; at most "
        f"{MAX_HOSTS} hosts fit (1024 threads x {_SMEM_K} hosts)"
    )


@functools.lru_cache(maxsize=1024)
def _launch_config(R: int, H: int, Z: int,
                   warps: Optional[int] = None) -> _Config:
    """The launch shape for ``R`` replicas of ``H`` hosts and ``Z`` zones.

    By default the register-resident shape (W warps a replica, K hosts a
    thread, 32·W·K ≥ H) with the shortest modelled step, K·⌈W/4⌉ plus
    ``_EXCHANGE_HOSTS`` when W > 1 (from the sweep at H = 600 in
    ``PERF.md``); ``warps`` forces W.  Past the register file, ⌈H/320⌉
    warps of ``_SMEM_K`` hosts in shared memory.  Replica groups share a
    block up to ⌈R / 132⌉, so R = 256 fills the SMs with small blocks.
    Raises ValueError when H or Z outgrow the kernel."""
    if H > MAX_HOSTS:
        raise ValueError(_limit_message(H, Z))
    shapes = []
    for W in ([warps] if warps else range(1, 33)):
        need = -(-H // (32 * W))
        K = min((k for k in _REG_THREADS if k >= need), default=None)
        if K is not None and 32 * W <= _REG_THREADS[K]:
            cost = K * -(-W // 4) + (_EXCHANGE_HOSTS if W > 1 else 0)
            shapes.append((cost, W, K))
    if shapes:
        _cost, W, K = min(shapes)
        smem_state = False
        per_block = min(_REG_THREADS[K] // (32 * W), 15 if W > 1 else 32)
    else:
        W, K, smem_state = warps or -(-H // (32 * _SMEM_K)), _SMEM_K, True
        if 32 * W * K < H or W > 32:
            raise ValueError(f"no {W}-warp shape of greedy_place holds "
                             f"{H} hosts")
        per_block = 1
    G = max(1, min(per_block, -(-R // _SMS)))
    while G > 1 and _smem_bytes(Z, W, G, K, smem_state) > _SMEM_LIMIT:
        G -= 1
    smem = _smem_bytes(Z, W, G, K, smem_state)
    if smem > _SMEM_LIMIT:
        raise ValueError(_limit_message(H, Z))
    return _Config(W, K, smem_state, G, 32 * W * G, -(-R // G), smem)


def _want(name, t, device, dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, avail on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check(avail_r, demands, valid, new_group, anchor_zone, cost_zz, bw_zz,
           host_zone, base_task_counts, bin_pack, live, risk, n_eff):
    """Validate the argument contract in one pass; returns ``(R, T, H,
    n_eff, launch config)``."""
    if bin_pack not in ("first-fit", "best-fit"):
        raise ValueError(f"bin_pack must be 'first-fit' or 'best-fit', "
                         f"got {bin_pack!r}")
    if avail_r.dim() != 3 or avail_r.shape[2] != 4:
        raise ValueError(f"avail must be [R, H, 4], got {tuple(avail_r.shape)}")
    R, H = avail_r.shape[0], avail_r.shape[1]
    T, Z = demands.shape[0], cost_zz.shape[0]
    dev = avail_r.device
    _want("avail", avail_r, dev, _F32, (R, H, 4))
    _want("demands", demands, dev, _F32, (T, 4))
    _want("valid", valid, dev, _BOOL, (T,))
    _want("new_group", new_group, dev, _BOOL, (T,))
    _want("anchor_zone", anchor_zone, dev, _I32, (T,))
    _want("cost_zz", cost_zz, dev, _F32, (Z, Z))
    _want("bw_zz", bw_zz, dev, _F32, (Z, Z))
    _want("host_zone", host_zone, dev, _I32, (H,))
    _want("base_task_counts", base_task_counts, dev, _I32, (H,))
    if live is not None:
        _want("live", live, dev, _BOOL, (H,))
    if risk is not None:
        _want("risk", risk, dev, _F32, (H,))
    if H < 1:
        raise ValueError("the greedy pass needs at least one host")
    if n_eff is None:
        n_eff = T
    elif not 0 <= n_eff <= T:
        raise ValueError(f"n_eff must be in [0, {T}], got {n_eff}")
    return R, T, H, n_eff, _launch_config(R, H, Z)


def _phase1(cost_zz, bw_zz, host_zone):
    """The ``[Z, H]`` round-trip tables (``pallas_kernels.py:398-403``) of
    the plain version; the kernel forms the same sums per host."""
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
    R, T, H, n_eff, _cfg = _check(avail_r, demands, valid, new_group,
                                  anchor_zone, cost_zz, bw_zz, host_zone,
                                  base_task_counts, bin_pack, live, risk,
                                  n_eff)
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
    """``greedy_place_launch`` of the built library, typed once: thirteen
    pointers, twelve ints, the stream."""
    from pivot_tpu_torch.ops.build import load

    fn = load("greedy_place").greedy_place_launch
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 12 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(cfg, avail_r, demands, valid, new_group, anchor_zone, cost_zz,
            bw_zz, host_zone, base_task_counts, live, risk, placements,
            avail_out, n_eff, first_fit, sort_hosts, host_decay) -> None:
    """Launch ``greedy_place`` once, in shape ``cfg``, on the current
    stream of ``avail_r``'s device, on operands :func:`_check` has passed,
    into ``placements`` / ``avail_out``; count the launch, and raise if
    CUDA refused it.  The kernel's one launch site."""
    dev = avail_r.device
    args = (
        avail_r.data_ptr(), demands.data_ptr(), valid.data_ptr(),
        new_group.data_ptr(), anchor_zone.data_ptr(), cost_zz.data_ptr(),
        bw_zz.data_ptr(), host_zone.data_ptr(), base_task_counts.data_ptr(),
        None if risk is None else risk.data_ptr(),
        None if live is None else live.data_ptr(),
        placements.data_ptr(), avail_out.data_ptr(),
        avail_r.shape[0], demands.shape[0], n_eff, avail_r.shape[1],
        cost_zz.shape[0], first_fit, sort_hosts, host_decay,
        cfg.hosts_per_thread, cfg.smem_state, cfg.warps, cfg.groups,
        torch._C._cuda_getCurrentRawStream(dev.index),  # current_stream()'s
    )
    if dev.index == torch.cuda.current_device():
        err = _launcher()(*args)
    else:
        with torch.cuda.device(dev):
            err = _launcher()(*args)
    if err != 0:
        raise RuntimeError(f"greedy_place launch failed: CUDA error {err}")
    LAUNCHES["greedy_place"] += 1


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
      [H] f32, all contiguous and on one device; zones in [0, Z).

    Returns ``([R, T] int32 placements, [R, H, 4] f32 availability)``.
    ``n_eff`` (default ``T``) stops the pass after task ``n_eff − 1``; a
    caller that knows its last valid task passes one past it.

    CUDA tensors launch ``greedy_place`` once on the current stream into
    two outputs from ``torch.empty`` — no other device operation, no
    synchronisation; CPU tensors take :func:`cost_aware_plain_batched`;
    anything else raises."""
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
    R, T, _H, n_eff, cfg = _check(*args, bin_pack, live, risk, n_eff)
    placements = torch.empty((R, T), dtype=torch.int32, device=avail_r.device)
    avail_out = torch.empty_like(avail_r)
    if R:
        _launch(cfg, *args, live, risk, placements, avail_out, n_eff,
                bin_pack == "first-fit", sort_hosts, host_decay)
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
