"""Fit / score / argmin placement kernels in plain torch.

Port of ``pivot_tpu/ops/kernels.py``.  Each scheduling tick evaluates all
ready-task × host placements for one policy; the greedy *sequential*
semantics of the reference policies (each placement decrements the
availability the next task sees — ``scheduler/vbp.py``,
``scheduler/cost_aware.py:99-127``) are kept exactly.

Two forms per policy, as in the JAX package:

  * the scan oracles ``*_kernel_ref`` walk every row of the padded task
    axis and recompute the full fit/score/argmin row at each step;
  * the two-phase ``*_impl`` forms hoist everything that does not depend
    on the availability carry out of the loop (phase 1: the ``[Z, H]``
    round-trip tables, the host-decay prescale), then run the residual
    sequential pass (phase 2), selected by ``phase2``:

      - ``"scan"`` — the oracle's loop;
      - ``"slim"`` — stops at the last valid task and computes the
        cost-aware group score only at group-entry steps;
      - ``"auto"`` — ``"slim"``.

    Speculative chunk commit (``phase2=int`` in the JAX package) is not
    ported yet and raises ``NotImplementedError``.

Bit-parity discipline: every operation keeps the reference's operand
association.  ``_norms`` is the explicit sum ``((x0² + x1²) + x2²) + x3²``
(the order XLA and numpy use for four terms), ties go to the lowest host
index (``torch.argmin``/``argmax`` return the first extremum), and a
placement decrements one row in place.  On the CPU in float64 these forms
are bit-identical to the JAX kernels under x64 (``tests/test_torch_
kernels.py``).

The loops run eagerly on whatever device their tensors live on.  The
slim pass reads the ``[B]`` valid and group-entry flags to the host once
per call (one device→host copy) and never synchronises inside the loop.
On the card they serve the Opportunistic and VBP arms; the Cost-Aware
arm's per-tick pass is the hand-written kernel of ``ops/cuda_kernels.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "DeviceTopology",
    "resolve_device",
    "topology_from_numpy",
    "opportunistic_kernel_ref",
    "first_fit_kernel_ref",
    "best_fit_kernel_ref",
    "cost_aware_kernel_ref",
    "opportunistic_impl",
    "first_fit_impl",
    "best_fit_impl",
    "cost_aware_impl",
]


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on; ``cuda`` without a card
    raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


class DeviceTopology(NamedTuple):
    """Device-resident cluster topology, pushed once per experiment
    (``pivot_tpu/ops/kernels.py::DeviceTopology``)."""

    cost: torch.Tensor  # [Z, Z] egress $ / GB
    bw: torch.Tensor  # [Z, Z] Mbps
    host_zone: torch.Tensor  # [H] i32
    totals: torch.Tensor  # [H, 4]

    @classmethod
    def from_cluster(cls, cluster, dtype=torch.float32,
                     device="cuda") -> "DeviceTopology":
        meta = cluster.meta
        return topology_from_numpy(
            meta.cost_matrix, meta.bw_matrix, cluster.host_zone_vector(),
            cluster.totals_matrix(), dtype=dtype, device=device,
        )

    @property
    def n_hosts(self) -> int:
        return self.host_zone.shape[0]


def topology_from_numpy(cost, bw, host_zone, totals, dtype=torch.float32,
                        device="cuda") -> DeviceTopology:
    """The port's topology from numpy arrays — e.g. ``np.asarray`` of each
    field of the JAX package's ``DeviceTopology``."""
    dev = resolve_device(device)

    def put(x, dt):
        return torch.tensor(np.asarray(x), dtype=dt, device=dev)

    return DeviceTopology(
        cost=put(cost, dtype), bw=put(bw, dtype),
        host_zone=put(host_zone, torch.int32), totals=put(totals, dtype),
    )


def _fits(avail, demand, strict: bool):
    """[H] fit mask: every dimension satisfies avail (>|>=) demand."""
    if strict:
        return (avail > demand).all(dim=-1)
    return (avail >= demand).all(dim=-1)


def _apply_live(avail, live):
    """Optional [H] quarantine mask: masked rows get the −1 sentinel no
    fit test can select; ``restore`` writes their original rows back into
    the availability output (``pivot_tpu`` ``_apply_live``)."""
    if live is None:
        return avail, lambda out: out
    orig = avail
    masked = torch.where(live[:, None], avail, avail.new_full((), -1.0))
    return masked, lambda out: torch.where(live[:, None], out, orig)


def _norms(mat):
    """L2 norm over the last (size-4) axis, summed in the reference's
    left-to-right order."""
    sq = mat * mat
    return torch.sqrt(((sq[..., 0] + sq[..., 1]) + sq[..., 2]) + sq[..., 3])


# -- the risk term (``pivot_tpu/ops/kernels.py`` module comment) -------------


def _risk_key(fit, risk):
    """Masked-argmin key for lexicographic (risk, index) selection."""
    return torch.where(fit, risk, risk.new_full((), float("inf")))


def _risk_restrict(fit, risk):
    """Opportunistic rule: narrow ``fit`` to its minimum-risk tier."""
    if risk is None:
        return fit
    rmin = _risk_key(fit, risk).min(dim=-1, keepdim=True).values
    return fit & (risk == rmin)


def _risk_score(score, risk):
    """Score rule: ``score += risk``."""
    if risk is None:
        return score
    return score + risk


def _place(avail, demand, h, ok):
    """In place: row ``h`` −= ``demand`` when ``ok`` (a 0-dim bool tensor).
    ``x + (−d)`` is bit-identical to ``x − d`` and ``x + (−0)`` to ``x``;
    ``h`` indexes as a 1-element tensor, so nothing syncs with the host."""
    delta = torch.where(ok, demand, torch.zeros_like(demand))
    avail.index_add_(0, h.reshape(1), (-delta).reshape(1, -1))


def _bump_count(counts, h, ok):
    """In place: ``counts[h] += 1`` when ``ok``."""
    counts.index_add_(0, h.reshape(1), ok.reshape(1).to(counts.dtype))


def _first_true(mask):
    """Index of the first True (0 when none) — ``jnp.argmax`` of a mask."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _set_placement(placements, j: int, h, ok):
    placements[j] = torch.where(ok, h.to(torch.int32),
                                placements.new_full((), -1))


def _host_rows(valid, *streams):
    """Host copies of the ``[B]`` per-task control streams — one
    device→host copy per call.  Returns ``(n_eff, rows)`` where ``n_eff``
    is one past the last valid task (``pivot_tpu`` ``_effective_len``)
    and ``rows`` holds each of ``streams`` as a list of ints."""
    host = torch.stack(
        [valid.to(torch.int64)] + [s.to(torch.int64) for s in streams]
    ).cpu().numpy()
    idx = np.flatnonzero(host[0])
    n_eff = int(idx[-1]) + 1 if idx.size else 0
    return n_eff, [row.tolist() for row in host[1:]]


# ---------------------------------------------------------------------------
# Scan oracles: one full fit/score/argmin row per step over the padded axis.
# ---------------------------------------------------------------------------


def _opportunistic_scan(avail, demands, valid, uniforms, risk=None):
    avail = avail.clone()
    B = demands.shape[0]
    placements = torch.full((B,), -1, dtype=torch.int32, device=avail.device)
    for j in range(B):
        demand = demands[j]
        h, ok = _opportunistic_row(avail, demand, valid[j], uniforms[j], risk)
        _place(avail, demand, h, ok)
        _set_placement(placements, j, h, ok)
    return placements, avail


def _opportunistic_row(avail, demand, valid_j, u, risk):
    fit = _fits(avail, demand, strict=False) & valid_j
    fit = _risk_restrict(fit, risk)
    n_fit = fit.sum()
    k = torch.minimum((u * n_fit).to(torch.int32), (n_fit - 1).to(torch.int32))
    rank = torch.cumsum(fit, dim=0)  # 1-based rank among fitting hosts
    h = _first_true(fit & (rank == k + 1))
    return h, n_fit > 0


def opportunistic_kernel_ref(avail, demands, valid, uniforms, live=None,
                             risk=None):
    """Uniformly random fitting host per task (ref opportunistic.py:11-20):
    the k-th fitting host, k = ⌊u·n_fit⌋.  Returns ([T] int32 placements,
    [H, 4] new availability)."""
    avail, restore = _apply_live(avail, live)
    p, a = _opportunistic_scan(avail, demands, valid, uniforms, risk)
    return p, restore(a)


def _first_fit_row(avail, demand, valid_j, strict, risk):
    fit = _fits(avail, demand, strict) & valid_j
    if risk is None:
        h = _first_true(fit)
    else:
        h = torch.argmin(_risk_key(fit, risk))
    return h, fit.any()


def _first_fit_scan(avail, demands, valid, strict, risk=None):
    avail = avail.clone()
    B = demands.shape[0]
    placements = torch.full((B,), -1, dtype=torch.int32, device=avail.device)
    for j in range(B):
        h, ok = _first_fit_row(avail, demands[j], valid[j], strict, risk)
        _place(avail, demands[j], h, ok)
        _set_placement(placements, j, h, ok)
    return placements, avail


def first_fit_kernel_ref(avail, demands, valid, strict=False, live=None,
                         risk=None):
    """Lowest-index fitting host per task (ref vbp.py:6-29)."""
    avail, restore = _apply_live(avail, live)
    p, a = _first_fit_scan(avail, demands, valid, strict, risk)
    return p, restore(a)


def _best_fit_row(avail, demand, valid_j, risk):
    fit = _fits(avail, demand, strict=True) & valid_j
    residual = _risk_score(_norms(avail - demand), risk)
    h = torch.argmin(torch.where(fit, residual,
                                 residual.new_full((), float("inf"))))
    return h, fit.any()


def _best_fit_scan(avail, demands, valid, risk=None):
    avail = avail.clone()
    B = demands.shape[0]
    placements = torch.full((B,), -1, dtype=torch.int32, device=avail.device)
    for j in range(B):
        h, ok = _best_fit_row(avail, demands[j], valid[j], risk)
        _place(avail, demands[j], h, ok)
        _set_placement(placements, j, h, ok)
    return placements, avail


def best_fit_kernel_ref(avail, demands, valid, live=None, risk=None):
    """Min residual-L2 host among strict fits (ref vbp.py:32-49)."""
    avail, restore = _apply_live(avail, live)
    p, a = _best_fit_scan(avail, demands, valid, risk)
    return p, restore(a)


def _check_exp_rows(score_exp, rt_bw_rows):
    if score_exp is not None and rt_bw_rows is not None:
        raise ValueError(
            "learned score exponents pow the static phase-1 bandwidth "
            "table; realtime_bw rows bypass that table — the combination "
            "is rejected at the policy layer (sched/cuda.py)"
        )


def _cost_aware_scan(avail, demands, valid, new_group, anchor_zone, cost_zz,
                     bw_zz, host_zone, base_task_counts, bin_pack, sort_hosts,
                     host_decay, rt_bw_rows, rt_bw_idx, risk=None,
                     score_exp=None):
    _check_exp_rows(score_exp, rt_bw_rows)
    avail = avail.clone()
    H = avail.shape[0]
    B = demands.shape[0]
    dtype = avail.dtype
    big = avail.new_full((), float("inf"))
    first_fit = bin_pack == "first-fit"
    base_counts = base_task_counts.to(dtype)
    w_norm = None if score_exp is None else score_exp[2]
    cost_rt, bw_rt, _ = _ca_phase1(
        cost_zz, bw_zz, host_zone, base_counts, prescale_decay=False,
        score_exp=score_exp,
    )
    iota_h = torch.arange(H, dtype=dtype, device=avail.device)

    def group_score(cost_row, bw_row):
        if not sort_hosts:
            return risk if risk is not None else iota_h
        decay = torch.clamp_min(base_counts, 1.0) if host_decay else 1.0
        norms = _norms(avail)
        if w_norm is not None:
            norms = norms ** w_norm
        return _risk_score(cost_row * decay / (norms * bw_row), risk)

    frozen = torch.zeros(H, dtype=dtype, device=avail.device)
    extra = torch.zeros(H, dtype=torch.int32, device=avail.device)
    placements = torch.full((B,), -1, dtype=torch.int32, device=avail.device)
    for j in range(B):
        demand = demands[j]
        az = anchor_zone[j]
        bw_row = bw_rt[az] if rt_bw_rows is None else rt_bw_rows[rt_bw_idx[j]]
        cost_row = cost_rt[az]
        if first_fit:
            frozen = torch.where(new_group[j], group_score(cost_row, bw_row),
                                 frozen)
            fit = _fits(avail, demand, strict=True) & valid[j]
            h = torch.argmin(torch.where(fit, frozen, big))
        else:
            residual = _norms(avail - demand)
            if w_norm is not None:
                residual = residual ** w_norm
            decay = (
                torch.clamp_min(base_counts + extra.to(dtype), 1.0)
                if host_decay else 1.0
            )
            per_task = _risk_score(cost_row * residual * decay / bw_row, risk)
            fit = _fits(avail, demand, strict=False) & valid[j]
            h = torch.argmin(torch.where(fit, per_task, big))
        ok = fit.any()
        _place(avail, demand, h, ok)
        if not first_fit:
            _bump_count(extra, h, ok)
        _set_placement(placements, j, h, ok)
    return placements, avail


def cost_aware_kernel_ref(avail, demands, valid, new_group, anchor_zone,
                          cost_zz, bw_zz, host_zone, base_task_counts,
                          bin_pack: str = "first-fit", sort_hosts: bool = True,
                          host_decay: bool = False, rt_bw_rows=None,
                          rt_bw_idx=None, live=None, risk=None,
                          score_exp=None):
    """The PIVOT cost-aware placement (ref cost_aware.py:28-127), the
    reference-shaped scan retained as the parity oracle — argument
    contract as ``pivot_tpu.ops.kernels.cost_aware_kernel_ref``.

    First-fit: the group's host score ``cost·decay / (‖avail‖·bw)`` frozen
    at group entry, strict fits, masked argmin.  Best-fit: per-task score
    ``cost·‖avail−d‖·decay / bw`` over non-strict fits, with a live
    placement counter in the decay."""
    avail, restore = _apply_live(avail, live)
    p, a = _cost_aware_scan(
        avail, demands, valid, new_group, anchor_zone, cost_zz, bw_zz,
        host_zone, base_task_counts, bin_pack, sort_hosts, host_decay,
        rt_bw_rows, rt_bw_idx, risk, score_exp,
    )
    return p, restore(a)


# ---------------------------------------------------------------------------
# Two-phase machinery
# ---------------------------------------------------------------------------


def _ca_phase1(cost_zz, bw_zz, host_zone, base_counts, prescale_decay,
               score_exp=None):
    """Cost-aware phase-1 tables: the ``[Z, H]`` round-trip cost and
    bandwidth tables and the optional exact host-decay prescale of the
    cost table (``pivot_tpu`` ``_ca_phase1``)."""
    hz = host_zone.long()
    cost_rt = cost_zz[:, hz] + cost_zz[hz, :].T
    bw_rt = bw_zz[:, hz] + bw_zz[hz, :].T
    if score_exp is not None:
        cost_rt = cost_rt ** score_exp[0]
        bw_rt = bw_rt ** score_exp[1]
    if prescale_decay:
        num_rt = cost_rt * torch.clamp_min(base_counts, 1.0)[None, :]
    else:
        num_rt = cost_rt
    return cost_rt, bw_rt, num_rt


def _ca_group_score(num_row, avail, bw_row, w_norm=None):
    """First-fit group score row ``num / (‖avail‖^wₙ·bw)``."""
    norms = _norms(avail)
    if w_norm is not None:
        norms = norms ** w_norm
    return num_row / (norms * bw_row)


def _ca_best_fit_score(cost_row, avail, demand, decay, bw_row, w_norm=None):
    """Best-fit per-task score ``cost·‖avail−d‖^wₙ·decay/bw``."""
    residual = _norms(avail - demand)
    if w_norm is not None:
        residual = residual ** w_norm
    return cost_row * residual * decay / bw_row


def _resolve_phase2(phase2) -> str:
    if phase2 in ("auto", "slim"):
        return "slim"
    if phase2 == "scan":
        return "scan"
    if isinstance(phase2, int) and not isinstance(phase2, bool) and phase2 >= 1:
        raise NotImplementedError(
            "speculative chunk commit (phase2=int) is not ported to "
            "pivot_tpu_torch yet — ROADMAP.md, port queue item "
            "'chunk speculation'; use phase2='slim' or 'scan'"
        )
    raise ValueError(
        f"phase2 must be 'auto', 'scan', 'slim', or a chunk size >= 1; "
        f"got {phase2!r}"
    )


def _slim_drive(avail, demands, valid, decide_row):
    """Slim phase 2 for the carry-free kernels: stop at the last valid
    task; ``decide_row(avail, j, demand) -> (h, ok)`` is the oracle's
    step."""
    avail = avail.clone()
    B = demands.shape[0]
    placements = torch.full((B,), -1, dtype=torch.int32, device=avail.device)
    n_eff, _ = _host_rows(valid)
    for j in range(n_eff):
        h, ok = decide_row(avail, j, demands[j])
        _place(avail, demands[j], h, ok)
        _set_placement(placements, j, h, ok)
    return placements, avail


def opportunistic_impl(avail, demands, valid, uniforms, phase2="auto",
                       live=None, risk=None):
    """Two-phase form of :func:`opportunistic_kernel_ref`, bit-identical
    to it in every mode."""
    mode = _resolve_phase2(phase2)
    avail, restore = _apply_live(avail, live)
    if mode == "scan":
        p, a = _opportunistic_scan(avail, demands, valid, uniforms, risk)
        return p, restore(a)
    p, a = _slim_drive(
        avail, demands, valid,
        lambda avail, j, demand: _opportunistic_row(
            avail, demand, valid[j], uniforms[j], risk),
    )
    return p, restore(a)


def first_fit_impl(avail, demands, valid, strict=False, totals=None,
                   phase2="auto", live=None, risk=None):
    """Two-phase form of :func:`first_fit_kernel_ref`.  ``totals`` steers
    only the chunked form's speculation in the JAX package, so it cannot
    change a placement; it is accepted for the same argument contract."""
    mode = _resolve_phase2(phase2)
    avail, restore = _apply_live(avail, live)
    if mode == "scan":
        p, a = _first_fit_scan(avail, demands, valid, strict, risk)
        return p, restore(a)
    p, a = _slim_drive(
        avail, demands, valid,
        lambda avail, j, demand: _first_fit_row(
            avail, demand, valid[j], strict, risk),
    )
    return p, restore(a)


def best_fit_impl(avail, demands, valid, totals=None, phase2="auto",
                  live=None, risk=None):
    """Two-phase form of :func:`best_fit_kernel_ref`."""
    mode = _resolve_phase2(phase2)
    avail, restore = _apply_live(avail, live)
    if mode == "scan":
        p, a = _best_fit_scan(avail, demands, valid, risk)
        return p, restore(a)
    p, a = _slim_drive(
        avail, demands, valid,
        lambda avail, j, demand: _best_fit_row(avail, demand, valid[j], risk),
    )
    return p, restore(a)


def cost_aware_impl(avail, demands, valid, new_group, anchor_zone, cost_zz,
                    bw_zz, host_zone, base_task_counts,
                    bin_pack: str = "first-fit", sort_hosts: bool = True,
                    host_decay: bool = False, rt_bw_rows=None, rt_bw_idx=None,
                    totals=None, phase2="auto", live=None, risk=None,
                    score_exp=None):
    """Two-phase form of :func:`cost_aware_kernel_ref` — argument contract
    as ``pivot_tpu.ops.kernels.cost_aware_impl``.  Phase 1 hoists the
    ``[Z, H]`` round-trip tables and the host-decay prescale of the cost
    table (the same two operands multiply, so the product is bit-equal);
    the slim phase 2 recomputes the group score only at group entries."""
    mode = _resolve_phase2(phase2)
    _check_exp_rows(score_exp, rt_bw_rows)
    avail, restore = _apply_live(avail, live)
    if mode == "scan":
        p, a = _cost_aware_scan(
            avail, demands, valid, new_group, anchor_zone, cost_zz, bw_zz,
            host_zone, base_task_counts, bin_pack, sort_hosts, host_decay,
            rt_bw_rows, rt_bw_idx, risk, score_exp,
        )
        return p, restore(a)
    avail = avail.clone()
    B, H = demands.shape[0], avail.shape[0]
    first_fit = bin_pack == "first-fit"
    dtype = avail.dtype
    big = avail.new_full((), float("inf"))
    base_counts = base_task_counts.to(dtype)
    track_extra = (not first_fit) and host_decay
    w_norm = None if score_exp is None else score_exp[2]

    # ---- phase 1 ----
    cost_rt, bw_rt, num_rt = _ca_phase1(
        cost_zz, bw_zz, host_zone, base_counts,
        first_fit and sort_hosts and host_decay, score_exp=score_exp,
    )
    iota_h = torch.arange(H, dtype=dtype, device=avail.device)
    row_src = bw_rt if rt_bw_rows is None else rt_bw_rows
    row_idx = anchor_zone if rt_bw_rows is None else rt_bw_idx

    # ---- phase 2 (slim) ----
    placements = torch.full((B,), -1, dtype=torch.int32, device=avail.device)
    frozen = torch.zeros(H, dtype=dtype, device=avail.device)
    extra = torch.zeros(H, dtype=torch.int32, device=avail.device)
    n_eff, (ng, az, ri) = _host_rows(valid, new_group, anchor_zone, row_idx)
    for j in range(n_eff):
        demand = demands[j]
        if first_fit:
            if ng[j]:
                if sort_hosts:
                    frozen = _risk_score(_ca_group_score(
                        num_rt[az[j]], avail, row_src[ri[j]], w_norm,
                    ), risk)
                else:
                    frozen = iota_h if risk is None else risk
            fit = _fits(avail, demand, strict=True) & valid[j]
            h = torch.argmin(torch.where(fit, frozen, big))
        else:
            decay = (
                torch.clamp_min(base_counts + extra.to(dtype), 1.0)
                if host_decay else 1.0
            )
            per_task = _risk_score(_ca_best_fit_score(
                cost_rt[az[j]], avail, demand, decay, row_src[ri[j]], w_norm,
            ), risk)
            fit = _fits(avail, demand, strict=False) & valid[j]
            h = torch.argmin(torch.where(fit, per_task, big))
        ok = fit.any()
        _place(avail, demand, h, ok)
        if track_extra:
            _bump_count(extra, h, ok)
        _set_placement(placements, j, h, ok)
    return placements, restore(avail)
