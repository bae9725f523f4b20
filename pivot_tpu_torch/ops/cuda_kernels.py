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
is a group of W warps, several groups to a block.  Past the register
file the state moves to the CTA's shared memory (``MAX_HOSTS`` = 10,240
hosts), past one CTA to the shared memory of a thread-block cluster of
up to 16 CTAs (``CLUSTER_MAX_HOSTS`` = 163,840 hosts at the CLI's 31
zones), and past that to global memory, so every host count the
reference takes has a shape.  :func:`_launch_config` picks the form, W,
the hosts per thread K, the groups per block and the cluster size C.

``cost_aware_cuda_rows`` is the kernel's per-row form: G rows, each with
its own task stream, host rows, ``[Z, Z]`` tables and step bound, in one
launch — what ``jax.vmap`` of the kernel computes over G serving
sessions' ticks (``pivot_tpu/sched/batch.py:118-168``), and what a
coalesced Cost-Aware flush of the serving batcher (``sched/batch.py``)
runs.

Beside the kernel, ``cost_aware_plain_batched`` / ``cost_aware_plain`` /
``cost_aware_plain_rows`` are the same pass as a straightforward torch
loop over tasks with the kernel's arithmetic, phase 1 as torch ops.  The
wrappers take the plain version for tensors on the CPU — and only then:
on a CUDA tensor they launch the kernel or raise.

``LAUNCHES["greedy_place"]`` counts kernel launches (never plain calls);
``LAUNCHES_BY_REPLICAS`` the shared-stream launches by their replica
count R, and ``LAUNCHES_ROWS`` the per-row launches by their row count
G.  Session threads launch concurrently: the counts, the build and the
load are taken under locks.

The carry-free placement pass (Opportunistic, First-Fit, Best-Fit) is
the second hand kernel, ``carry_free_place`` (``csrc/carry_free_place.
cu``).  It ports no Pallas kernel but the XLA loop the reference runs
for those arms (``pivot_tpu/ops/kernels.py``'s slim ``opportunistic_impl``
/ ``first_fit_impl`` / ``best_fit_impl`` and their ``jax.vmap`` over
replicas): ``opportunistic_cuda``, ``first_fit_cuda``, ``best_fit_cuda``
(one tick) and ``first_fit_cuda_batched`` / ``best_fit_cuda_batched`` (R
replicas sharing one task stream) each launch it once, in the launch
shape :func:`_cf_config` picks: a replica's host state in registers
(a group of warps, several groups a block at large R), in the shared
memory of a thread-block cluster of up to 16 CTAs, or past 211,968
hosts in global memory.  Beside each, a ``*_plain`` function is the port's slim torch
form of the same pass (``ops/kernels.py``), which the wrapper takes for
CPU tensors, and only then.  ``LAUNCHES["carry_free_place"]`` counts its
launches and ``LAUNCHES_CARRY_FREE`` splits them by (arm, R).

The ensemble rollout's placement chain is the third,
``ensemble_chain`` (``csrc/ensemble_chain.cu``): it ports the XLA loop
``pivot_tpu/parallel/ensemble/tick.py:720-890`` (``place_body`` under the
rollout's ``vmap``), every arm, risk row, score exponent and realtime
table.  ``ensemble_chain_cuda`` launches it once a tick for all R
replicas, each walking its own steps, in the shape :func:`_chain_config`
picks (a replica's state in its CTA's shared memory, or in place in
global memory); its plain version is the rollout's torch chain
(``parallel/ensemble/tick.py::_chain_plain``), taken for CPU tensors.
``LAUNCHES["ensemble_chain"]`` counts its launches and
``LAUNCHES_CHAIN`` splits them by (policy, R).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional

import torch

from pivot_tpu_torch.infra.roofline import H100_SMEM_OPTIN_BYTES
from pivot_tpu_torch.ops.kernels import (
    best_fit_batched,
    best_fit_impl,
    first_fit_batched,
    first_fit_impl,
    opportunistic_impl,
)

__all__ = [
    "LAUNCHES",
    "LAUNCHES_BY_REPLICAS",
    "LAUNCHES_CARRY_FREE",
    "LAUNCHES_CHAIN",
    "LAUNCHES_ROWS",
    "CLUSTER_MAX_HOSTS",
    "MAX_HOSTS",
    "load_carry_free_library",
    "load_library",
    "reset_launches",
    "best_fit_cuda",
    "best_fit_cuda_batched",
    "best_fit_plain",
    "best_fit_plain_batched",
    "cost_aware_cuda",
    "cost_aware_cuda_batched",
    "cost_aware_cuda_rows",
    "cost_aware_plain",
    "cost_aware_plain_batched",
    "cost_aware_plain_rows",
    "ensemble_chain_cuda",
    "load_ensemble_chain_library",
    "first_fit_cuda",
    "first_fit_cuda_batched",
    "first_fit_plain",
    "first_fit_plain_batched",
    "opportunistic_cuda",
    "opportunistic_plain",
]

#: Kernel launches since the last :func:`reset_launches`, by kernel name.
LAUNCHES = {"greedy_place": 0, "carry_free_place": 0, "ensemble_chain": 0}
#: The shared-stream launches of ``greedy_place``, by replica count R.
LAUNCHES_BY_REPLICAS: dict = {}
#: The per-row launches of ``greedy_place``, by row count G.
LAUNCHES_ROWS: dict = {}
#: The launches of ``carry_free_place``, by (arm, replica count R).
LAUNCHES_CARRY_FREE: dict = {}
#: The launches of ``ensemble_chain``, by (policy, replica count R).
LAUNCHES_CHAIN: dict = {}
#: Guards the counts (session threads launch concurrently).
_COUNT_LOCK = threading.Lock()
#: Guards the typing of the library's entry points.
_LOAD_LOCK = threading.Lock()

_BIG = 1e30
_NEG = -1e30
_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
#: Shared memory one block may opt into on Hopper (227 KB).
_SMEM_LIMIT = H100_SMEM_OPTIN_BYTES
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
#: The most hosts one CTA holds: 1,024 threads of ``_SMEM_K`` hosts, the
#: largest K whose shared-memory state fits 227 KB beside the tables.
MAX_HOSTS = 32 * 32 * _SMEM_K
#: CTAs a replica may take in the cluster form (``kMaxCluster``; 16 is
#: Hopper's non-portable cluster size).
MAX_CLUSTER = 16
#: The most hosts the cluster form holds: 16 CTAs of ``MAX_HOSTS`` hosts,
#: 163,840 (each CTA's 223,504 B fit the opt-in up to Z = 45 zones).  Past
#: it, the per-host state lives in global memory.
CLUSTER_MAX_HOSTS = MAX_CLUSTER * MAX_HOSTS
#: Threads of the global form's CTA (``max_threads(kSmemK, true)``).
_GLOBAL_THREADS = 1024
#: The default shape's step model: a warp issues K host evaluations per
#: thread, warps beyond four share a scheduler, and W > 1 adds one
#: cross-warp exchange that costs about this many host evaluations.
_EXCHANGE_HOSTS = 4


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        LAUNCHES_BY_REPLICAS.clear()
        LAUNCHES_ROWS.clear()
        LAUNCHES_CARRY_FREE.clear()
        LAUNCHES_CHAIN.clear()


#: The kernel's ``state`` argument, by where a replica's per-host state
#: lives.
_STATES = ("registers", "shared", "global")


class _Config(NamedTuple):
    """One launch shape of ``greedy_place``."""

    warps: int             # W: warps per replica group (a CTA's, cluster)
    hosts_per_thread: int  # K (the global form: ⌈H / 1024⌉, a loop)
    state: str             # "registers", "shared" or "global"
    groups: int            # G: replica groups per block
    threads: int           # 32·W·G
    blocks: int            # ⌈R / G⌉, R·C in the cluster form
    smem_bytes: int        # dynamic shared memory of one block (CTA)
    cluster: int = 1       # C: CTAs a replica (shared state over a cluster)

    @property
    def smem_state(self) -> bool:
        """Per-host state in shared memory (one CTA's or a cluster's)."""
        return self.state == "shared"


def _smem_bytes(Z, W, G, K, smem_state, C=1) -> int:
    """``greedy_place_smem_bytes``: the [Z, Z] tables, per group the
    double-buffered task chunk (40 B a task) and the cross-warp slots,
    shared-memory state (20 B a host slot), and in a cluster of C > 1
    CTAs the [2][C] (key, host) slots its peers push into."""
    def align16(n):
        return -(-n // 16) * 16
    chunk = min(32 * W, 256)
    return (align16(8 * Z * Z) + G * align16(40 * chunk + 16 * W)
            + (20 * K * 32 * W if smem_state else 0)
            + (16 * C if C > 1 else 0))


def _global_smem_bytes(Z) -> int:
    """``greedy_place_smem_bytes`` of the global form: the [Z, Z] tables
    and [2][32] (key, host) warp slots."""
    return -(-8 * Z * Z // 16) * 16 + 16 * 32


def _limit_message(H, Z) -> str:
    return (
        f"H={H} hosts at Z={Z} outgrow greedy_place: its {8 * Z * Z}-byte "
        f"[Z, Z] tables live in shared memory, and one Hopper CTA may opt "
        f"into at most {_SMEM_LIMIT} bytes (227 KB) of it; even the "
        f"global-memory form, whose per-host state is off chip, needs "
        f"{_global_smem_bytes(Z)} bytes"
    )


def _cta_config(R: int, H: int, Z: int, warps: Optional[int]):
    """One CTA a replica group, ``H`` ≤ ``MAX_HOSTS``: the register shapes,
    else ``_SMEM_K`` hosts a thread in shared memory; None when its shared
    memory outgrows the opt-in."""
    shapes = []
    for W in ([warps] if warps else range(1, 33)):
        need = -(-H // (32 * W))
        K = min((k for k in _REG_THREADS if k >= need), default=None)
        if K is not None and 32 * W <= _REG_THREADS[K]:
            cost = K * -(-W // 4) + (_EXCHANGE_HOSTS if W > 1 else 0)
            shapes.append((cost, W, K))
    if shapes:
        _cost, W, K = min(shapes)
        state = "registers"
        per_block = min(_REG_THREADS[K] // (32 * W), 15 if W > 1 else 32)
    else:
        W, K, state = warps or -(-H // (32 * _SMEM_K)), _SMEM_K, "shared"
        if 32 * W * K < H or W > 32:
            raise ValueError(f"no {W}-warp shape of greedy_place holds "
                             f"{H} hosts")
        per_block = 1
    smem_state = state == "shared"
    G = max(1, min(per_block, -(-R // _SMS)))
    while G > 1 and _smem_bytes(Z, W, G, K, smem_state) > _SMEM_LIMIT:
        G -= 1
    smem = _smem_bytes(Z, W, G, K, smem_state)
    if smem > _SMEM_LIMIT:
        return None
    return _Config(W, K, state, G, 32 * W * G, -(-R // G), smem)


@functools.lru_cache(maxsize=1024)
def _launch_config(R: int, H: int, Z: int,
                   warps: Optional[int] = None) -> _Config:
    """The launch shape for ``R`` replicas of ``H`` hosts and ``Z`` zones:

    ==================  ============================================
    H                   form (where the state lives), W, K, G, C
    ==================  ============================================
    ≤ 10,240            one CTA: the register shape (W warps a replica,
                        K hosts a thread, 32·W·K ≥ H) with the shortest
                        modelled step, K·⌈W/4⌉ plus ``_EXCHANGE_HOSTS``
                        when W > 1 (the sweep at H = 600 in
                        ``PERF.md``); past the register file ⌈H/320⌉
                        warps of ``_SMEM_K`` hosts in shared memory.
                        Replica groups share a block up to ⌈R / 132⌉,
                        so R = 256 fills the SMs with small blocks
    ≤ 163,840           shared memory over a cluster: C the least power
                        of two with ⌈H / C⌉ ≤ ``MAX_HOSTS`` (at most 16),
                        each CTA ⌈Hc / 320⌉ warps of ``_SMEM_K`` hosts;
                        G = 1
    above               global memory: one CTA of 1,024 threads
    ==================  ============================================

    A form whose shared memory outgrows the opt-in at this Z passes to
    the next (a larger C, then global memory), so only tables that
    outgrow shared memory raise ValueError.  ``warps`` forces W (a CTA's,
    in the cluster form); ``CLUSTER_MAX_HOSTS`` is the 163,840-host
    limit."""
    if H <= MAX_HOSTS:
        cfg = _cta_config(R, H, Z, warps)
        if cfg is not None:
            return cfg
    C = 2
    while C < MAX_CLUSTER and -(-H // C) > MAX_HOSTS:
        C *= 2
    while C <= MAX_CLUSTER:
        hc = -(-H // C)
        W = warps or -(-hc // (32 * _SMEM_K))
        smem = _smem_bytes(Z, W, 1, _SMEM_K, True, C)
        if W <= 32 and 32 * W * _SMEM_K >= hc and smem <= _SMEM_LIMIT:
            return _Config(W, _SMEM_K, "shared", 1, 32 * W, R * C, smem, C)
        C *= 2
    smem = _global_smem_bytes(Z)
    if smem > _SMEM_LIMIT:
        raise ValueError(_limit_message(H, Z))
    return _Config(_GLOBAL_THREADS // 32, -(-H // _GLOBAL_THREADS), "global",
                   1, _GLOBAL_THREADS, R, smem)


def _rows_config(G: int, H: int, Z: int) -> _Config:
    """The per-row launch shape: :func:`_launch_config`'s form, W, K and C
    for ``H`` hosts, one row a block (a cluster, in the cluster form;
    each block copies its own row's tables; the kernel refuses a per-row
    launch with more groups to a block)."""
    cfg = _launch_config(1, H, Z)
    return cfg._replace(blocks=G * cfg.cluster)


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


def _check_rows(avail_g, demands_g, valid_g, new_group_g, anchor_zone_g,
                cost_zz_g, bw_zz_g, host_zone_g, base_task_counts_g,
                bin_pack, live, risk, n_eff_g):
    """Validate the per-row contract (every operand with a leading ``[G]``
    row axis); returns ``(G, T, H, launch config)``."""
    if bin_pack not in ("first-fit", "best-fit"):
        raise ValueError(f"bin_pack must be 'first-fit' or 'best-fit', "
                         f"got {bin_pack!r}")
    if avail_g.dim() != 3 or avail_g.shape[2] != 4:
        raise ValueError(f"avail must be [G, H, 4], got "
                         f"{tuple(avail_g.shape)}")
    G, H = avail_g.shape[0], avail_g.shape[1]
    if demands_g.dim() != 3 or cost_zz_g.dim() != 3:
        raise ValueError("the per-row form takes demands [G, T, 4] and "
                         "cost_zz / bw_zz [G, Z, Z]")
    T, Z = demands_g.shape[1], cost_zz_g.shape[1]
    dev = avail_g.device
    _want("avail", avail_g, dev, _F32, (G, H, 4))
    _want("demands", demands_g, dev, _F32, (G, T, 4))
    _want("valid", valid_g, dev, _BOOL, (G, T))
    _want("new_group", new_group_g, dev, _BOOL, (G, T))
    _want("anchor_zone", anchor_zone_g, dev, _I32, (G, T))
    _want("cost_zz", cost_zz_g, dev, _F32, (G, Z, Z))
    _want("bw_zz", bw_zz_g, dev, _F32, (G, Z, Z))
    _want("host_zone", host_zone_g, dev, _I32, (G, H))
    _want("base_task_counts", base_task_counts_g, dev, _I32, (G, H))
    if live is not None:
        _want("live", live, dev, _BOOL, (G, H))
    if risk is not None:
        _want("risk", risk, dev, _F32, (G, H))
    if n_eff_g is not None:
        _want("n_eff", n_eff_g, dev, _I32, (G,))
    if H < 1:
        raise ValueError("the greedy pass needs at least one host")
    return G, T, H, _rows_config(G, H, Z)


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


def cost_aware_plain_rows(avail_g, demands_g, valid_g, new_group_g,
                          anchor_zone_g, cost_zz_g, bw_zz_g, host_zone_g,
                          base_task_counts_g, bin_pack: str = "first-fit",
                          sort_hosts: bool = True, host_decay: bool = False,
                          live=None, risk=None, n_eff_g=None):
    """The per-row pass of :func:`cost_aware_cuda_rows`: row ``r`` is
    :func:`cost_aware_plain` on row ``r`` of every operand, walking tasks
    ``[0, n_eff_g[r])`` (clamped to ``[0, T]``; default all ``T``).
    Returns ``([G, T] int32 placements, [G, H, 4] availability)``."""
    G, T, _H, _cfg = _check_rows(avail_g, demands_g, valid_g, new_group_g,
                                 anchor_zone_g, cost_zz_g, bw_zz_g,
                                 host_zone_g, base_task_counts_g, bin_pack,
                                 live, risk, n_eff_g)
    bounds = [T] * G if n_eff_g is None else n_eff_g.tolist()
    rows = [
        cost_aware_plain(
            avail_g[r], demands_g[r], valid_g[r], new_group_g[r],
            anchor_zone_g[r], cost_zz_g[r], bw_zz_g[r], host_zone_g[r],
            base_task_counts_g[r], bin_pack=bin_pack, sort_hosts=sort_hosts,
            host_decay=host_decay, live=None if live is None else live[r],
            risk=None if risk is None else risk[r],
            n_eff=min(max(int(bounds[r]), 0), T),
        )
        for r in range(G)
    ]
    if not rows:
        return (torch.empty((0, T), dtype=torch.int32,
                            device=avail_g.device), avail_g.clone())
    return (torch.stack([p for p, _ in rows]),
            torch.stack([a for _, a in rows]))


# ---------------------------------------------------------------------------
# The kernel.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _entries():
    """The built library's two launch entry points, typed once:
    ``greedy_place_launch`` (fourteen pointers, thirteen ints, the
    stream) and ``greedy_place_launch_rows`` (fifteen pointers, eleven
    ints, the stream)."""
    from pivot_tpu_torch.ops.build import load

    lib = load("greedy_place")
    shared, rows = lib.greedy_place_launch, lib.greedy_place_launch_rows
    shared.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 13 + [
        ctypes.c_void_p
    ]
    rows.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p
    ]
    shared.restype = rows.restype = ctypes.c_int
    return shared, rows


def load_library():
    """Build (if needed) and load ``greedy_place`` now, on the calling
    thread; returns its two typed entry points.  The serving driver calls
    it before any session thread dispatches."""
    with _LOAD_LOCK:
        return _entries()


def _launch(cfg, avail_r, demands, valid, new_group, anchor_zone, cost_zz,
            bw_zz, host_zone, base_task_counts, live, risk, placements,
            avail_out, n_eff, first_fit, sort_hosts, host_decay,
            n_eff_rows=None) -> None:
    """Launch ``greedy_place`` once, in shape ``cfg``, on the current
    stream of ``avail_r``'s device, on operands :func:`_check` (or, with
    ``n_eff_rows``, the per-row form of :func:`_check_rows`) has passed,
    into ``placements`` / ``avail_out``; count the launch, and raise if
    CUDA refused it.  The kernel's one launch site.  ``n_eff_rows`` (an
    int32 ``[G]`` tensor, or the string ``"all"`` for T each) selects the
    per-row form, whose rows' bounds it holds; ``n_eff`` is then
    unused."""
    dev = avail_r.device
    R = avail_r.shape[0]
    rows = n_eff_rows is not None
    ptrs = (
        avail_r.data_ptr(), demands.data_ptr(), valid.data_ptr(),
        new_group.data_ptr(), anchor_zone.data_ptr(), cost_zz.data_ptr(),
        bw_zz.data_ptr(), host_zone.data_ptr(), base_task_counts.data_ptr(),
        None if risk is None else risk.data_ptr(),
        None if live is None else live.data_ptr(),
    )
    stream = torch._C._cuda_getCurrentRawStream(dev.index)  # current_stream()'s
    # The global form's frozen keys / best-fit counts, a row a replica.
    scratch = (torch.empty(avail_r.shape[:2], dtype=_F32, device=dev)
               if cfg.state == "global" else None)
    outs = (placements.data_ptr(), avail_out.data_ptr(),
            None if scratch is None else scratch.data_ptr())
    mode = (first_fit, sort_hosts, host_decay, cfg.hosts_per_thread,
            _STATES.index(cfg.state), cfg.warps)
    shared, per_row = load_library()
    if rows:
        bounds = (None if isinstance(n_eff_rows, str)
                  else n_eff_rows.data_ptr())
        fn = per_row
        args = (*ptrs, bounds, *outs, R, demands.shape[1],
                avail_r.shape[1], cost_zz.shape[1], *mode, cfg.cluster,
                stream)
    else:
        fn = shared
        args = (*ptrs, *outs, R, demands.shape[0], n_eff, avail_r.shape[1],
                cost_zz.shape[0], *mode, cfg.groups, cfg.cluster, stream)
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"greedy_place launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        LAUNCHES["greedy_place"] += 1
        counts = LAUNCHES_ROWS if rows else LAUNCHES_BY_REPLICAS
        counts[R] = counts.get(R, 0) + 1


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


def cost_aware_cuda_rows(avail_g, demands_g, valid_g, new_group_g,
                         anchor_zone_g, cost_zz_g, bw_zz_g, host_zone_g,
                         base_task_counts_g, bin_pack: str = "first-fit",
                         sort_hosts: bool = True, host_decay: bool = False,
                         live=None, risk=None, n_eff_g=None):
    """The per-row greedy pass: G rows, each one tick of its own —

      avail_g [G, H, 4] f32, demands_g [G, T, 4] f32, valid_g /
      new_group_g [G, T] bool, anchor_zone_g [G, T] i32, cost_zz_g /
      bw_zz_g [G, Z, Z] f32, host_zone_g / base_task_counts_g [G, H] i32,
      optional live [G, H] bool and risk [G, H] f32, optional n_eff_g [G]
      i32 (each row's step bound, clamped to [0, T]; default T), all
      contiguous and on one device; zones in [0, Z).

    Row ``r`` of the result is :func:`cost_aware_cuda` on row ``r`` of
    every operand: ``([G, T] int32 placements, [G, H, 4] f32
    availability)``.  CUDA tensors launch ``greedy_place`` once on the
    current stream (one row a block), with no other device operation and
    no synchronisation; CPU tensors take :func:`cost_aware_plain_rows`;
    anything else raises."""
    args = (avail_g, demands_g, valid_g, new_group_g, anchor_zone_g,
            cost_zz_g, bw_zz_g, host_zone_g, base_task_counts_g)
    if avail_g.device.type == "cpu":
        return cost_aware_plain_rows(
            *args, bin_pack=bin_pack, sort_hosts=sort_hosts,
            host_decay=host_decay, live=live, risk=risk, n_eff_g=n_eff_g,
        )
    if avail_g.device.type != "cuda":
        raise ValueError(f"greedy_place runs on cuda or (plain) cpu tensors, "
                         f"got {avail_g.device}")
    G, T, _H, cfg = _check_rows(*args, bin_pack, live, risk, n_eff_g)
    placements = torch.empty((G, T), dtype=torch.int32, device=avail_g.device)
    avail_out = torch.empty_like(avail_g)
    if G:
        _launch(cfg, *args, live, risk, placements, avail_out, T,
                bin_pack == "first-fit", sort_hosts, host_decay,
                n_eff_rows="all" if n_eff_g is None else n_eff_g)
    return placements, avail_out


# ---------------------------------------------------------------------------
# The carry-free placement pass: ``carry_free_place``.
# ---------------------------------------------------------------------------

#: The kernel's arms, in the order of its ``arm`` argument.
_CF_ARMS = ("opportunistic", "first-fit", "best-fit")
#: Tasks a staging buffer of the kernel holds at most (``kChunk``).
_CF_CHUNK = 256
#: Threads a rows-form CTA may run (``kMaxThreads``).
_CF_MAX_THREADS = 512
#: The forms of the kernel's ``form`` argument: K hosts a thread in
#: registers for each K of ``_CF_REG_THREADS`` (``kForm = K``), the rows
#: in shared memory over a cluster (``kRowsShared``) and in global memory
#: (``kRowsGlobal``).
_CF_ROWS_SHARED = 0
_CF_ROWS_GLOBAL = -1
#: The register builds, each with its thread limit a block
#: (``max_threads`` in the source, its ``__launch_bounds__``: no spill).
_CF_REG_THREADS = {2: 768, 4: 512, 8: 512}
#: Cluster sizes the kernel takes (16: Hopper's non-portable size) and
#: the slots a replica may have (``kMaxCluster``, ``kMaxSlots``).
_CF_CLUSTERS = (1, 2, 4, 8, 16)
_CF_MAX_SLOTS = 256
#: Hosts a thread keeps in registers before a replica takes another warp,
#: by arm, for one replica and for R > 1 replicas, and the replica groups
#: a block at R > 1 (``chip_smoke.py --cf-sweep``, PERF.md §6).
_CF_REG_K = {"opportunistic": 2, "first-fit": 4, "best-fit": 2}
_CF_REG_K_REPLICAS = {"opportunistic": 4, "first-fit": 4, "best-fit": 2}
_CF_GROUPS_REPLICAS = {"opportunistic": 1, "first-fit": 1, "best-fit": 2}
#: The cluster form: hosts a CTA aims at (C the least power of two that
#: brings ⌈H / C⌉ down to it, at most 16), and the fewest and most warps
#: a CTA, W = ⌈Hc / (32·``_CF_ROWS_THREAD_HOSTS``)⌉ between them
#: (``--cf-sweep`` at H = 8,192, 20,000 and the pod tick).
_CF_CTA_HOSTS = 1024
_CF_ROWS_THREAD_HOSTS = 8
_CF_ROWS_WARPS = (8, 16)


def _cf_smem_bytes(H, form, warps, groups, cluster) -> int:
    """``carry_free_place_smem_bytes``: per replica group the staged
    tasks (two buffers of min(32·W, ``_CF_CHUNK``) tasks, 24 B each), the
    slots (two buffers of C·W, 16 B each), and in the cluster form the
    CTA's ⌈H / C⌉ rows (16 B a host)."""
    chunk = min(32 * warps, _CF_CHUNK)
    state = -(-H // cluster) if form == _CF_ROWS_SHARED else 0
    return groups * 48 * chunk + 32 * groups * cluster * warps + 16 * state


class _CfConfig(NamedTuple):
    """One launch shape of ``carry_free_place``."""

    form: int        # K (registers), _CF_ROWS_SHARED or _CF_ROWS_GLOBAL
    warps: int       # W: warps a replica group (a CTA, in the rows forms)
    groups: int      # G: replica groups a block (register form)
    cluster: int     # C: CTAs a replica (rows in shared memory)
    smem_bytes: int

    @property
    def threads(self) -> int:
        """Threads a block: 32·W·G."""
        return 32 * self.warps * self.groups

    @property
    def state(self) -> str:
        """Where a replica's per-host state lives."""
        return ("registers" if self.form > 0 else "shared"
                if self.form == _CF_ROWS_SHARED else "global")


def _cf_rows_config(H: int, cluster: int) -> _CfConfig:
    """The cluster form of ``cluster`` CTAs a replica."""
    hc = -(-H // cluster)
    lo, hi = _CF_ROWS_WARPS
    W = max(lo, min(hi, -(-hc // (32 * _CF_ROWS_THREAD_HOSTS))))
    return _CfConfig(_CF_ROWS_SHARED, W, 1, cluster,
                     _cf_smem_bytes(H, _CF_ROWS_SHARED, W, 1, cluster))


#: The most hosts the cluster form holds (16 CTAs of 16 warps, each CTA's
#: rows beside its staging and slots in the 227 KB opt-in): 211,968.
#: Past it, the rows in global memory.
_CF_CLUSTER_MAX_HOSTS = 16 * ((_SMEM_LIMIT - _cf_smem_bytes(
    0, _CF_ROWS_SHARED, _CF_ROWS_WARPS[1], 1, 16)) // 16)


@functools.lru_cache(maxsize=1024)
def _cf_config(H: int, arm: str, R: int = 1) -> _CfConfig:
    """The launch shape of ``arm`` for ``R`` replicas of ``H`` hosts:

    ==================  ============================================
    H                   form (where the state lives), W, G, C
    ==================  ============================================
    ≤ 4,096             registers: K the arm's ``_CF_REG_K`` (R = 1) or
                        ``_CF_REG_K_REPLICAS`` (R > 1), doubled until
                        ⌈H / 32K⌉ warps fit K's thread limit
                        (``_CF_REG_THREADS``: 1,536 hosts at K = 2,
                        2,048 at 4, 4,096 at 8); W =
                        ⌈H / 32K⌉; G the arm's ``_CF_GROUPS_REPLICAS`` at
                        R > 1 within the limit, else 1; C = 1
    ≤ 211,968           shared memory over a cluster: C the least power
                        of two with ⌈H / C⌉ ≤ ``_CF_CTA_HOSTS`` (at most
                        16); W = ⌈Hc / 256⌉ within ``_CF_ROWS_WARPS``
                        (8-16); G = 1
    above               global memory: one CTA of 16 warps
    ==================  ============================================

    ``_CF_CLUSTER_MAX_HOSTS`` is the 211,968-host limit."""
    k = _CF_REG_K[arm] if R == 1 else _CF_REG_K_REPLICAS[arm]
    for K, limit in sorted(_CF_REG_THREADS.items()):
        W = max(1, -(-H // (32 * K)))
        if K < k or 32 * W > limit:
            continue
        G = 1
        if R > 1:
            G = max(1, min(_CF_GROUPS_REPLICAS[arm], limit // (32 * W),
                           15 if W > 1 else R))
        return _CfConfig(K, W, G, 1, _cf_smem_bytes(H, K, W, G, 1))
    if H <= _CF_CLUSTER_MAX_HOSTS:
        C = 1
        while C < _CF_CLUSTERS[-1] and -(-H // C) > _CF_CTA_HOSTS:
            C *= 2
        return _cf_rows_config(H, C)
    return _CfConfig(_CF_ROWS_GLOBAL, _CF_ROWS_WARPS[1], 1, 1,
                     _cf_smem_bytes(H, _CF_ROWS_GLOBAL, _CF_ROWS_WARPS[1],
                                    1, 1))


def _cf_check(arm, avail_r, demands, valid, uniforms, live, risk, n_bound):
    """Validate the carry-free contract in one pass — ``avail_r``
    [R, H, 4], ``demands`` [T, 4] in avail's float dtype, ``valid`` [T]
    bool, ``uniforms`` [T] (opportunistic), optional ``live`` [H] bool and
    ``risk`` [H], contiguous and on one device, H ≥ 1, ``n_bound`` ≥ 0 or
    None; returns ``(R, T, H, the kernel's step bound or −1)``."""
    if arm not in _CF_ARMS:
        raise ValueError(f"arm must be one of {_CF_ARMS}, got {arm!r}")
    if avail_r.dim() != 3 or avail_r.shape[2] != 4:
        raise ValueError(f"avail must be [H, 4] (or [R, H, 4] replicas), "
                         f"got {tuple(avail_r.shape[1:])} per replica")
    R, H = avail_r.shape[0], avail_r.shape[1]
    T = demands.shape[0] if demands.dim() else 0
    dtype, dev = avail_r.dtype, avail_r.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"avail must be float32 or float64, got {dtype}")
    _want("avail", avail_r, dev, dtype, (R, H, 4))
    _want("demands", demands, dev, dtype, (T, 4))
    _want("valid", valid, dev, _BOOL, (T,))
    if arm == "opportunistic":
        if uniforms is None:
            raise ValueError("the opportunistic pass needs uniforms [T]")
        _want("uniforms", uniforms, dev, dtype, (T,))
    if live is not None:
        _want("live", live, dev, _BOOL, (H,))
    if risk is not None:
        _want("risk", risk, dev, dtype, (H,))
    if H < 1:
        raise ValueError("the carry-free pass needs at least one host")
    if n_bound is None:
        return R, T, H, -1
    if int(n_bound) < 0:
        raise ValueError(f"n_bound must be >= 0, got {n_bound}")
    return R, T, H, min(int(n_bound), T)


# -- the plain version: the port's slim torch forms -------------------------


def opportunistic_plain(avail, demands, valid, uniforms, live=None,
                        risk=None, n_bound=None):
    """The pass of :func:`opportunistic_cuda` as the port's slim torch
    form (``ops/kernels.py::opportunistic_impl``, ``phase2="slim"``):
    ``[H, 4]`` → ``([T] int32 placements, [H, 4] availability)``;
    ``n_bound`` caps the steps and must be at least one past the last
    valid task."""
    _cf_check("opportunistic", avail[None], demands, valid, uniforms, live,
              risk, n_bound)
    return opportunistic_impl(avail, demands, valid, uniforms,
                              phase2="slim", live=live, risk=risk,
                              n_bound=n_bound)


def first_fit_plain(avail, demands, valid, strict: bool = False, live=None,
                    risk=None, n_bound=None):
    """The pass of :func:`first_fit_cuda` as the slim torch form
    (``first_fit_impl``, ``phase2="slim"``)."""
    _cf_check("first-fit", avail[None], demands, valid, None, live, risk,
              n_bound)
    return first_fit_impl(avail, demands, valid, strict=strict,
                          phase2="slim", live=live, risk=risk,
                          n_bound=n_bound)


def best_fit_plain(avail, demands, valid, live=None, risk=None,
                   n_bound=None):
    """The pass of :func:`best_fit_cuda` as the slim torch form
    (``best_fit_impl``, ``phase2="slim"``)."""
    _cf_check("best-fit", avail[None], demands, valid, None, live, risk,
              n_bound)
    return best_fit_impl(avail, demands, valid, phase2="slim", live=live,
                         risk=risk, n_bound=n_bound)


def first_fit_plain_batched(avail_r, demands, valid, strict: bool = False,
                            risk=None, n_bound=None):
    """The pass of :func:`first_fit_cuda_batched` as the torch form
    ``ops/kernels.py::first_fit_batched``: ``[R, H, 4]`` → ``([R, T]
    int32, [R, H, 4])``."""
    _cf_check("first-fit", avail_r, demands, valid, None, None, risk,
              n_bound)
    return first_fit_batched(avail_r, demands, valid, strict=strict,
                             risk=risk, n_bound=n_bound)


def best_fit_plain_batched(avail_r, demands, valid, risk=None, n_bound=None):
    """The pass of :func:`best_fit_cuda_batched` as the torch form
    ``ops/kernels.py::best_fit_batched``."""
    _cf_check("best-fit", avail_r, demands, valid, None, None, risk, n_bound)
    return best_fit_batched(avail_r, demands, valid, risk=risk,
                            n_bound=n_bound)


# -- the kernel -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _cf_entry():
    """The built library's launch entry point, typed once:
    ``carry_free_place_launch`` (eight pointers, ten ints, the
    stream)."""
    from pivot_tpu_torch.ops.build import load

    fn = load("carry_free_place").carry_free_place_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return fn


def load_carry_free_library():
    """Build (if needed) and load ``carry_free_place`` now, on the calling
    thread; returns its typed entry point."""
    with _LOAD_LOCK:
        return _cf_entry()


def _cf_launch(cfg, arm, avail_r, demands, valid, uniforms, strict, live,
               risk, n_bound, placements, avail_out) -> None:
    """Launch ``carry_free_place`` once, in shape ``cfg``, on the current
    stream of ``avail_r``'s device, on operands :func:`_cf_check` has
    passed (float32, 16-byte aligned), into ``placements`` /
    ``avail_out``; count the launch, and raise if CUDA refused it.  The
    kernel's one launch site; ``n_bound`` is the checked bound (−1 for
    none)."""
    dev = avail_r.device
    R, T, H = avail_r.shape[0], demands.shape[0], avail_r.shape[1]
    args = (avail_r.data_ptr(), demands.data_ptr(), valid.data_ptr(),
            None if uniforms is None else uniforms.data_ptr(),
            None if risk is None else risk.data_ptr(),
            None if live is None else live.data_ptr(),
            placements.data_ptr(), avail_out.data_ptr(),
            R, T, H, n_bound, _CF_ARMS.index(arm), int(bool(strict)),
            cfg.form, cfg.warps, cfg.groups, cfg.cluster,
            torch._C._cuda_getCurrentRawStream(dev.index))
    fn = load_carry_free_library()
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"carry_free_place launch failed: CUDA error "
                           f"{err}")
    with _COUNT_LOCK:
        LAUNCHES["carry_free_place"] += 1
        LAUNCHES_CARRY_FREE[arm, R] = LAUNCHES_CARRY_FREE.get((arm, R),
                                                              0) + 1


def _cf_call(arm, avail_r, demands, valid, uniforms=None, strict=False,
             live=None, risk=None, n_bound=None):
    """One launch on CUDA operands: check, allocate the outputs with
    ``torch.empty``, launch; ``([R, T] int32, [R, H, 4] f32)``."""
    if avail_r.device.type != "cuda":
        raise ValueError(f"carry_free_place runs on cuda or (plain) cpu "
                         f"tensors, got {avail_r.device}")
    R, T, H, n_bound = _cf_check(arm, avail_r, demands, valid, uniforms,
                                 live, risk, n_bound)
    if avail_r.dtype != _F32:
        raise TypeError(f"carry_free_place is float32 only, got "
                        f"{avail_r.dtype}")
    for name, t in (("avail", avail_r), ("demands", demands)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned: the kernel "
                             "reads its rows as float4")
    placements = torch.empty((R, T), dtype=torch.int32, device=avail_r.device)
    avail_out = torch.empty_like(avail_r)
    if R:
        _cf_launch(_cf_config(H, arm, R), arm, avail_r, demands, valid,
                   uniforms, strict, live, risk, n_bound, placements,
                   avail_out)
    return placements, avail_out


def opportunistic_cuda(avail, demands, valid, uniforms, live=None,
                       risk=None, n_bound=None):
    """One Opportunistic tick — the contract of ``pivot_tpu``'s
    ``opportunistic_impl`` in slim form:

      avail [H, 4] f32, demands [T, 4] f32, valid [T] bool, uniforms [T]
      f32, optional live [H] bool and risk [H] f32, all contiguous and on
      one device; ``n_bound`` (default: the device's own bound) at least
      one past the last valid task.

    Returns ``([T] int32 placements, [H, 4] f32 availability)``.  CUDA
    tensors launch ``carry_free_place`` once on the current stream — no
    other device operation, no synchronisation; CPU tensors take
    :func:`opportunistic_plain`; anything else raises."""
    if avail.device.type == "cpu":
        return opportunistic_plain(avail, demands, valid, uniforms,
                                   live=live, risk=risk, n_bound=n_bound)
    p, a = _cf_call("opportunistic", avail[None], demands, valid, uniforms,
                    live=live, risk=risk, n_bound=n_bound)
    return p[0], a[0]


def first_fit_cuda(avail, demands, valid, strict: bool = False, live=None,
                   risk=None, n_bound=None):
    """One First-Fit tick (``first_fit_impl``'s contract, slim form): the
    contract of :func:`opportunistic_cuda` without ``uniforms``, with
    ``strict``."""
    if avail.device.type == "cpu":
        return first_fit_plain(avail, demands, valid, strict=strict,
                               live=live, risk=risk, n_bound=n_bound)
    p, a = _cf_call("first-fit", avail[None], demands, valid, strict=strict,
                    live=live, risk=risk, n_bound=n_bound)
    return p[0], a[0]


def best_fit_cuda(avail, demands, valid, live=None, risk=None,
                  n_bound=None):
    """One Best-Fit tick (``best_fit_impl``'s contract, slim form)."""
    if avail.device.type == "cpu":
        return best_fit_plain(avail, demands, valid, live=live, risk=risk,
                              n_bound=n_bound)
    p, a = _cf_call("best-fit", avail[None], demands, valid, live=live,
                    risk=risk, n_bound=n_bound)
    return p[0], a[0]


def first_fit_cuda_batched(avail_r, demands, valid, strict: bool = False,
                           risk=None, n_bound=None):
    """First-Fit over ``R`` availability replicas sharing one task stream
    — ``jax.vmap`` of the reference's first-fit pass over ``avail_r [R, H,
    4]`` (``pivot_tpu/sched/tpu.py:1659-1666``), no live mask: one launch
    for all R.  Returns ``([R, T] int32, [R, H, 4] f32)``, each
    row bitwise the unbatched pass on that row; CPU tensors take
    :func:`first_fit_plain_batched`."""
    if avail_r.device.type == "cpu":
        return first_fit_plain_batched(avail_r, demands, valid,
                                       strict=strict, risk=risk,
                                       n_bound=n_bound)
    return _cf_call("first-fit", avail_r, demands, valid, strict=strict,
                    risk=risk, n_bound=n_bound)


def best_fit_cuda_batched(avail_r, demands, valid, risk=None, n_bound=None):
    """Best-Fit over ``R`` replicas sharing one task stream
    (``pivot_tpu/sched/tpu.py:1724-1729``); the contract of
    :func:`first_fit_cuda_batched`."""
    if avail_r.device.type == "cpu":
        return best_fit_plain_batched(avail_r, demands, valid, risk=risk,
                                      n_bound=n_bound)
    return _cf_call("best-fit", avail_r, demands, valid, risk=risk,
                    n_bound=n_bound)


# ---------------------------------------------------------------------------
# The ensemble's placement chain: ``ensemble_chain``.
# ---------------------------------------------------------------------------

#: The kernel's arms, in the order of its ``arm`` argument.
_CHAIN_ARMS = ("cost-aware", "first-fit", "best-fit", "opportunistic")
#: Its forms: a replica's rows in its CTA's shared memory
#: (``kFormShared``) or in place in global memory (``kFormGlobal``).
_CHAIN_SHARED = 0
_CHAIN_GLOBAL = 1
#: Steps a staging buffer holds (``kChunk``), warps a CTA at most
#: (``kMaxWarps``) and the zones the shared form keeps a byte each
#: (``kMaxZones``).
_CHAIN_CHUNK = 64
_CHAIN_MAX_WARPS = 32
_CHAIN_MAX_ZONES = 256
#: Hosts a thread owns in the shared form at most, before the replica
#: takes another warp: W = ⌈H / 256⌉, so H = 600 runs 3 warps a replica
#: and R = 1024 replicas of ~23 KB stay resident in one wave on 132 SMs.
_CHAIN_THREAD_HOSTS = 8


def _chain_smem_bytes(H, Z, form, arm, risk) -> int:
    """``ensemble_chain_smem_bytes``: two buffers of a 16-byte slot a
    warp, the staged steps (36 B each), the two ``[Z, Z]`` tables
    (cost-aware, arm 0) and, in the shared form, 17 B a host (+4 the
    cost-aware snapshot, +4 the risk)."""
    def align16(n):
        return -(-n // 16) * 16
    host = 17 + (4 if arm == 0 else 0) + (4 if risk else 0)
    return (32 * _CHAIN_MAX_WARPS + 36 * _CHAIN_CHUNK
            + (align16(8 * Z * Z) if arm == 0 else 0)
            + (align16(H * host) if form == _CHAIN_SHARED else 0))


class _ChainConfig(NamedTuple):
    """One launch shape of ``ensemble_chain``: one CTA a replica."""

    form: int        # _CHAIN_SHARED or _CHAIN_GLOBAL
    warps: int       # W: warps of a replica's CTA
    smem_bytes: int  # dynamic shared memory of one CTA

    @property
    def threads(self) -> int:
        return 32 * self.warps

    @property
    def state(self) -> str:
        """Where a replica's per-host state lives."""
        return "shared" if self.form == _CHAIN_SHARED else "global"


def _chain_limit(H, Z, policy) -> str:
    return (f"H={H} hosts at Z={Z} outgrow ensemble_chain ({policy}): its "
            f"{8 * Z * Z}-byte [Z, Z] tables live in shared memory, and one "
            f"Hopper CTA may opt into at most {_SMEM_LIMIT} bytes of it")


@functools.lru_cache(maxsize=1024)
def _chain_config(H: int, Z: int, policy: str, risk: bool) -> _ChainConfig:
    """The launch shape for replicas of ``H`` hosts over ``Z`` zones:

    =====================  =========================================
    shape                  form, W
    =====================  =========================================
    shared bytes ≤ 227 KB  rows in the CTA's shared memory;
    and Z ≤ 256            W = ⌈H / 256⌉ (at most 32)
    otherwise              rows in place in global memory; W = 32
    =====================  =========================================

    At Z = 31 the shared form holds up to 8,856 hosts (cost-aware with
    risk), 10,544 (cost-aware), 10,910 (the other arms with risk) and
    13,477 (without).  Only cost-aware tables past the opt-in (Z ≥ 170)
    raise ValueError."""
    if policy not in _CHAIN_ARMS:
        raise ValueError(f"policy must be one of {_CHAIN_ARMS}, got "
                         f"{policy!r}")
    arm = _CHAIN_ARMS.index(policy)
    W = min(_CHAIN_MAX_WARPS, max(1, -(-H // (32 * _CHAIN_THREAD_HOSTS))))
    smem = _chain_smem_bytes(H, Z, _CHAIN_SHARED, arm, risk)
    if smem <= _SMEM_LIMIT and Z <= _CHAIN_MAX_ZONES:
        return _ChainConfig(_CHAIN_SHARED, W, smem)
    smem = _chain_smem_bytes(H, Z, _CHAIN_GLOBAL, arm, risk)
    if smem > _SMEM_LIMIT:
        raise ValueError(_chain_limit(H, Z, policy))
    return _ChainConfig(_CHAIN_GLOBAL, _CHAIN_MAX_WARPS, smem)


_I64 = torch.int64


def _chain_check(policy, avail, g_p, az_p, bf_p, order, n_ready, dem_group,
                 cd, host_zone, cost_zz, bw_zz, u_p, risk_row, w_norm,
                 weyl_rot, score_bw):
    """Validate the chain's contract in one pass (``ensemble_chain_cuda``'s
    docstring); returns ``(R, T, H, G, Z)``."""
    if policy not in _CHAIN_ARMS:
        raise ValueError(f"policy must be one of {_CHAIN_ARMS}, got "
                         f"{policy!r}")
    if avail.dim() != 3 or avail.shape[2] != 4:
        raise ValueError(f"avail must be [R, H, 4], got {tuple(avail.shape)}")
    R, H = avail.shape[0], avail.shape[1]
    if order.dim() != 2 or cd.dim() != 3 or dem_group.dim() != 2:
        raise ValueError("the chain takes order [R, T], dem_group [G, 4] and "
                         "cd [R, G, Z]")
    T, G, Z = order.shape[1], dem_group.shape[0], cd.shape[2]
    dtype, dev = avail.dtype, avail.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"avail must be float32 or float64, got {dtype}")
    _want("avail", avail, dev, dtype, (R, H, 4))
    for name, t in (("g_p", g_p), ("az_p", az_p), ("bf_p", bf_p),
                    ("order", order)):
        _want(name, t, dev, _I64, (R, T))
    _want("n_ready", n_ready, dev, _I64, (R,))
    _want("dem_group", dem_group, dev, dtype, (G, 4))
    _want("cd", cd, dev, dtype, (R, G, Z))
    _want("host_zone", host_zone, dev, _I64, (H,))
    cost_aware = policy == "cost-aware"
    opp = policy == "opportunistic"
    if cost_aware:
        if cost_zz is None or bw_zz is None:
            raise ValueError("the cost-aware chain needs cost_zz and bw_zz")
        shape = (Z, Z) if cost_zz.dim() == 2 else (R, Z, Z)
        _want("cost_zz", cost_zz, dev, dtype, shape)
        _want("bw_zz", bw_zz, dev, dtype, shape)
        if w_norm is not None:
            _want("w_norm", w_norm, dev, dtype, (R, 1))
        if score_bw is not None:
            _want("score_bw", score_bw, dev, dtype, (R, Z, H))
    for name, t in (("cost_zz", cost_zz), ("bw_zz", bw_zz),
                    ("w_norm", w_norm), ("score_bw", score_bw)):
        if t is not None and not cost_aware:
            raise ValueError(f"{name} is the cost-aware chain's, not "
                             f"{policy}'s")
    if opp:
        if u_p is None or weyl_rot is None:
            raise ValueError("the opportunistic chain needs u_p and weyl_rot")
        _want("u_p", u_p, dev, dtype, (R, T))
        _want("weyl_rot", weyl_rot, dev, dtype, (R,))
    elif u_p is not None or weyl_rot is not None:
        raise ValueError(f"u_p and weyl_rot are the opportunistic chain's, "
                         f"not {policy}'s")
    if risk_row is not None:
        _want("risk_row", risk_row, dev, dtype, (R, H))
    if H < 1 or G < 1 or Z < 1:
        raise ValueError("the chain needs at least one host, group and zone")
    return R, T, H, G, Z


@functools.lru_cache(maxsize=None)
def _chain_entry():
    """The built library's launch entry point, typed once:
    ``ensemble_chain_launch`` (nineteen pointers, nine ints, the
    stream)."""
    from pivot_tpu_torch.ops.build import load

    fn = load("ensemble_chain").ensemble_chain_launch
    fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return fn


def load_ensemble_chain_library():
    """Build (if needed) and load ``ensemble_chain`` now, on the calling
    thread; returns its typed entry point."""
    with _LOAD_LOCK:
        return _chain_entry()


def _chain_launch(cfg, policy, avail, g_p, az_p, bf_p, order, n_ready,
                  dem_group, cd, host_zone, cost_zz, bw_zz, u_p, risk_row,
                  w_norm, weyl_rot, score_bw, pl, delay) -> None:
    """Launch ``ensemble_chain`` once, in shape ``cfg``, on the current
    stream of ``avail``'s device, on CUDA operands :func:`_chain_check`
    has passed (float32, ``avail`` and ``dem_group`` 16-byte aligned),
    ``avail`` updated in place, into ``pl`` / ``delay``; count the launch,
    and raise if CUDA refused it.  The kernel's one launch site."""
    dev = avail.device
    if dev.type != "cuda":
        raise ValueError(f"ensemble_chain launches on cuda tensors, got "
                         f"{dev}")
    R, T, H = order.shape[0], order.shape[1], avail.shape[1]
    G, Z = dem_group.shape[0], cd.shape[2]
    snap_rows = (torch.empty((R, H), dtype=_F32, device=dev)
                 if cfg.form == _CHAIN_GLOBAL and policy == "cost-aware"
                 else None)

    def ptr(t):
        return None if t is None else t.data_ptr()
    args = (ptr(avail), ptr(g_p), ptr(az_p), ptr(bf_p), ptr(order), ptr(u_p),
            ptr(n_ready), ptr(dem_group), ptr(cd), ptr(host_zone),
            ptr(cost_zz), ptr(bw_zz), ptr(risk_row), ptr(w_norm),
            ptr(weyl_rot), ptr(score_bw), ptr(snap_rows), ptr(pl),
            ptr(delay), R, T, H, G, Z,
            int(cost_zz is not None and cost_zz.dim() == 3),
            _CHAIN_ARMS.index(policy), cfg.form, cfg.warps,
            torch._C._cuda_getCurrentRawStream(dev.index))
    fn = load_ensemble_chain_library()
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"ensemble_chain launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        LAUNCHES["ensemble_chain"] += 1
        LAUNCHES_CHAIN[policy, R] = LAUNCHES_CHAIN.get((policy, R), 0) + 1


def ensemble_chain_cuda(policy, avail, g_p, az_p, bf_p, order, n_ready,
                        dem_group, cd, host_zone, cost_zz=None, bw_zz=None,
                        u_p=None, risk_row=None, w_norm=None, weyl_rot=None,
                        score_bw=None):
    """One tick's placement chain for ``R`` replicas — the reference's
    ``place_body`` loop (``pivot_tpu/parallel/ensemble/tick.py:720-890``)
    under its ``vmap``:

      avail [R, H, 4] (updated in place); the tick's ordered streams
      g_p / az_p / bf_p / order [R, T] int64 (group, anchor zone, anchor
      bucket's first rank, task index of step j); n_ready [R] int64 (each
      replica's steps); dem_group [G, 4]; cd [R, G, Z] (transfer delays);
      host_zone [H] int64; cost-aware: the round-trip tables cost_zz /
      bw_zz [Z, Z] (or [R, Z, Z] under score exponents), optional w_norm
      [R, 1] (the snapshot's exponent) and score_bw [R, Z, H] (realtime
      scoring's bandwidth); opportunistic: u_p [R, T] and weyl_rot [R];
      optional risk_row [R, H]; all contiguous, on one device, floats in
      avail's dtype; groups in [0, G), zones in [0, Z), order a
      permutation of each row, n_ready in [0, T].

    Returns ``(pl [R, T] int64, delay [R, T])``: each placed task's host
    and transfer delay, −1 and 0 elsewhere.  CUDA tensors (float32 only)
    launch ``ensemble_chain`` once on the current stream — outputs from
    ``torch.empty``, no other device operation, no synchronisation; CPU
    tensors take the plain chain
    (``parallel/ensemble/tick.py::_chain_plain``); anything else
    raises."""
    R, T, H, G, Z = _chain_check(policy, avail, g_p, az_p, bf_p, order,
                                 n_ready, dem_group, cd, host_zone, cost_zz,
                                 bw_zz, u_p, risk_row, w_norm, weyl_rot,
                                 score_bw)
    kw = dict(cost_zz=cost_zz, bw_zz=bw_zz, u_p=u_p, risk_row=risk_row,
              w_norm=w_norm, weyl_rot=weyl_rot, score_bw=score_bw)
    args = (avail, g_p, az_p, bf_p, order, n_ready, dem_group, cd,
            host_zone)
    if avail.device.type == "cpu":
        from pivot_tpu_torch.parallel.ensemble.tick import _chain_plain

        return _chain_plain(policy, *args, **kw)
    if avail.device.type != "cuda":
        raise ValueError(f"ensemble_chain runs on cuda or (plain) cpu "
                         f"tensors, got {avail.device}")
    if avail.dtype != _F32:
        raise TypeError(f"ensemble_chain is float32 only, got {avail.dtype} "
                        "(float64 runs the plain chain)")
    for name, t in (("avail", avail), ("dem_group", dem_group)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned: the kernel "
                             "reads its rows as float4")
    pl = torch.empty((R, T), dtype=_I64, device=avail.device)
    delay = torch.empty((R, T), dtype=_F32, device=avail.device)
    if R:
        _chain_launch(_chain_config(H, Z, policy, risk_row is not None),
                      policy, *args, cost_zz, bw_zz, u_p, risk_row, w_norm,
                      weyl_rot, score_bw, pl, delay)
    return pl, delay
