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
      - ``int C`` — speculative chunk commit: a chunk of C tasks is
        placed against chunk-entry availability with a capacity-aware
        fill model, the exact ``[H, 4]`` carry fold is replayed over the
        speculated placements, every chunk task is re-decided against
        its exact prefix availability in one vectorized pass, and the
        chunk commits through the first disagreement
        (:func:`_speculate_commit`).  Placements and availability are
        bit-identical to the scan whatever the speculation proposes.
        Opt-in: on the card its outer loop reads the commit position to
        the host once per chunk;
      - ``"auto"`` — ``"slim"`` (never a chunk size).

Bit-parity discipline: every operation keeps the reference's operand
association.  ``_norms`` is the explicit sum ``((x0² + x1²) + x2²) + x3²``
(the order XLA and numpy use for four terms), ties go to the lowest host
index (``torch.argmin``/``argmax`` return the first extremum), and a
placement decrements one row in place.  On the CPU in float64 these forms
are bit-identical to the JAX kernels under x64 (``tests/test_torch_
kernels.py``).

The loops run eagerly on whatever device their tensors live on.  The
slim pass reads the ``[B]`` valid and group-entry flags to the host once
per call (one device→host copy) and never synchronises inside the loop;
given a host step bound ``n_bound`` (the fused span driver,
``ops/tickloop.py``), the carry-free slim passes read nothing at all.
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
    "first_fit_batched",
    "best_fit_batched",
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
    """Optional [H] quarantine mask (``[G, H]`` for ``[G, H, 4]`` rows):
    masked rows get the −1 sentinel no fit test can select; ``restore``
    writes their original rows back into the availability output
    (``pivot_tpu`` ``_apply_live``)."""
    if live is None:
        return avail, lambda out: out
    orig = avail
    masked = torch.where(live[..., None], avail, avail.new_full((), -1.0))
    return masked, lambda out: torch.where(live[..., None], out, orig)


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
    avail.index_add_(0, h.reshape(1), (-delta).reshape(1, -1))  # graftcheck: ignore[determinism] -- one index: no colliding adds


def _bump_count(counts, h, ok):
    """In place: ``counts[h] += 1`` when ``ok``."""
    counts.index_add_(0, h.reshape(1), ok.reshape(1).to(counts.dtype))  # graftcheck: ignore[determinism] -- one index, an integer count


def _first_true(mask):
    """Index of the first True (0 when none) — ``jnp.argmax`` of a mask."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _place_replicas(avail):
    """:func:`_place` for ``R`` replica carries ``avail [R, H, 4]``: row
    ``h[r]`` of replica ``r`` −= ``demand`` where ``ok[r]``, one
    ``index_add_`` over the flattened rows (the same ``x + (−d)``)."""
    R, H = avail.shape[0], avail.shape[1]
    rows = avail.view(R * H, 4)
    base = torch.arange(R, device=avail.device) * H

    def place(avail, demand, h, ok):
        delta = torch.where(ok[:, None], demand, torch.zeros_like(demand))
        rows.index_add_(0, base + h, -delta)  # graftcheck: ignore[determinism] -- one row a replica (base + h): indices never collide
    return place


def _set_placement(placements, j: int, h, ok):
    placements[..., j] = torch.where(ok, h.to(torch.int32),
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
    """One step on ``[H, 4]`` — or on ``[R, H, 4]``, every replica at once
    (the host axis is the last but one; ``h`` and ``ok`` gain an ``[R]``
    axis)."""
    fit = _fits(avail, demand, strict) & valid_j
    if risk is None:
        h = _first_true(fit)
    else:
        h = torch.argmin(_risk_key(fit, risk), dim=-1)
    return h, fit.any(dim=-1)


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
    """One step on ``[H, 4]`` or ``[R, H, 4]`` (:func:`_first_fit_row`)."""
    fit = _fits(avail, demand, strict=True) & valid_j
    residual = _risk_score(_norms(avail - demand), risk)
    h = torch.argmin(torch.where(fit, residual,
                                 residual.new_full((), float("inf"))),
                     dim=-1)
    return h, fit.any(dim=-1)


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
    cost table (``pivot_tpu`` ``_ca_phase1``).  ``host_zone`` may carry
    leading axes (the host-sharded ``[S, H/S]`` blocks of
    ``ops/shard.py``); the tables then have them after ``Z``."""
    hz = host_zone.long()
    cost_rt = cost_zz[:, hz] + cost_zz[hz, :].movedim(-1, 0)
    bw_rt = bw_zz[:, hz] + bw_zz[hz, :].movedim(-1, 0)
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


def _resolve_phase2(phase2):
    """``"auto"``/``"slim"`` → ``"slim"``; ``"scan"``; an int chunk size
    ≥ 1 as itself."""
    if phase2 in ("auto", "slim"):
        return "slim"
    if phase2 == "scan":
        return "scan"
    if isinstance(phase2, int) and not isinstance(phase2, bool) and phase2 >= 1:
        return phase2
    raise ValueError(
        f"phase2 must be 'auto', 'scan', 'slim', or a chunk size >= 1; "
        f"got {phase2!r}"
    )


def _at(x, i):
    """``x[i]`` for a 0-dim device index without a host read (a 0-dim
    tensor subscript may be turned into a Python int)."""
    return x.index_select(0, i.reshape(1).long())[0]


def _static_viable(totals, demand, strict):
    """Phase-1 demand-vs-total pre-filter row [H]: hosts whose full
    capacity cannot hold ``demand``.  Steers the speculation only."""
    if totals is None:
        return None
    return _fits(totals, demand, strict)


def _fill_capacity(avail, demand, strict, viable):
    """[H] fill model: how many back-to-back copies of ``demand`` each
    host's availability holds.  Division-based, so it can be off by one
    at ulp boundaries — speculation only, the re-decision referees."""
    inf = avail.new_full((), float("inf"))
    q = torch.where(demand > 0, avail / demand, inf).min(dim=1).values
    q = torch.where(torch.isfinite(q), q, q.new_full((), 2.0 ** 31))
    n = torch.ceil(q) - 1 if strict else torch.floor(q)
    n = n.clamp(0, 1 << 30).to(torch.int32)
    if viable is not None:
        n = torch.where(viable, n, torch.zeros_like(n))
    return n


def _fill_pick(score_row, caps, ranks):
    """Predict placements for ``ranks`` [C] of identical-demand tasks that
    fill hosts in ``score_row`` order (stable: ties to the lowest host,
    like the masked argmin).  Returns ``(h [C], ok [C])``; negative ranks
    are inert.  The running capacity sums are int64 (the JAX package's
    wrap at int32); either way only the commit width can move."""
    hid_s = torch.sort(score_row, stable=True).indices
    return _fill_pick_sorted(caps[hid_s], hid_s, ranks)


def _fill_pick_by_index(caps, ranks):
    """:func:`_fill_pick` for score == host index (plain first-fit)."""
    iota = torch.arange(caps.shape[0], device=caps.device)
    return _fill_pick_sorted(caps, iota, ranks)


def _fill_pick_sorted(caps_s, hid_s, ranks):
    H = caps_s.shape[0]
    cum = torch.cumsum(caps_s, dim=0)
    j = (cum[None, :] <= ranks[:, None]).sum(dim=1)
    ok = (j < H) & (ranks >= 0)
    h = torch.where(ok, hid_s[j.clamp(max=H - 1)], torch.zeros_like(j))
    return h, ok


def _speculate_commit(avail, extra, track_extra, dem_c, h_s, ok_s, recheck,
                      place=_place, bump=_bump_count):
    """The exact core of speculative chunk commit
    (``pivot_tpu/ops/kernels.py::_speculate_commit``).

    Replays the exact carry fold over the speculated placements — one
    :func:`_place` per position, the scan's own op, so every prefix
    availability ``a_pre[k]`` is bit-identical to the sequential pass —
    then ``recheck(a_pre, ex_pre)`` re-decides every position against its
    exact prefix state in one vectorized pass.  With ``fc`` the first
    position whose re-decision differs from the speculation, the
    decisions at positions ≤ fc are the true sequential ones, so any
    prefix of length ≤ fc + 1 may be committed.

    Returns ``(p_c, h_c, ok_c, fc, commit_state)``; ``commit_state(n)``
    (a host int n ≥ 1) gives the exact availability and extra counter
    after committing the first n positions.  ``place`` / ``bump`` are the
    carry fold's ops (the host-sharded passes give their shard-local
    forms)."""
    C = dem_c.shape[0]
    a = avail.clone()
    a_pre = avail.new_empty((C,) + tuple(avail.shape))
    ex = ex_pre = None
    if track_extra:
        ex = extra.clone()
        ex_pre = extra.new_empty((C,) + tuple(extra.shape))
    for k in range(C):
        a_pre[k] = a
        place(a, dem_c[k], h_s[k], ok_s[k])
        if track_extra:
            ex_pre[k] = ex
            bump(ex, h_s[k], ok_s[k])
    h_c, ok_c = recheck(a_pre, ex_pre)
    p_c = torch.where(ok_c, h_c, -1).to(torch.int32)
    p_s = torch.where(ok_s, h_s, -1).to(torch.int32)
    idx = torch.arange(C, device=avail.device)
    fc = torch.where(p_c != p_s, idx, torch.full_like(idx, C)).min()

    def commit_state(n_commit: int):
        # Positions < n_commit − 1 agree with the speculation, so
        # a_pre[cm] is the exact fold; one more exact _place with cm's
        # true decision finishes it.
        cm = min(n_commit - 1, C - 1)
        new_avail = a_pre[cm].clone()
        place(new_avail, dem_c[cm], h_c[cm], ok_c[cm])
        if not track_extra:
            return new_avail, extra
        new_extra = ex_pre[cm].clone()
        bump(new_extra, h_c[cm], ok_c[cm])
        return new_avail, new_extra

    return p_c, h_c, ok_c, fc, commit_state


def _pad_chunk(x, C):
    """Pad the task axis by C so a C-window at any position < B stays in
    bounds; the pad rows are ``valid=False`` no-ops."""
    pad = x.new_zeros((C,) + tuple(x.shape[1:]))
    return torch.cat([x, pad])


def _slim_drive(avail, demands, valid, decide_row, n_bound=None):
    """Slim phase 2 for the carry-free kernels; ``decide_row(avail, j,
    demand) -> (h, ok)`` is the oracle's step, which masks by the device
    ``valid[j]`` itself.  Walks ``j < n_bound`` when the caller gives a
    host bound (at least one past the last valid task) and reads nothing
    from the device; else it stops at the last valid task, read from the
    device once.  ``avail`` is one ``[H, 4]`` carry, or ``R`` replica
    carries ``[R, H, 4]`` sharing the task stream (``[R, B]``
    placements)."""
    avail = avail.clone()
    B = demands.shape[0]
    placements = torch.full(avail.shape[:-2] + (B,), -1, dtype=torch.int32,
                            device=avail.device)
    place = _place if avail.dim() == 2 else _place_replicas(avail)
    n = _host_rows(valid)[0] if n_bound is None else min(n_bound, B)
    for j in range(n):
        h, ok = decide_row(avail, j, demands[j])
        place(avail, demands[j], h, ok)
        _set_placement(placements, j, h, ok)
    return placements, avail


def _chunk_drive(avail, demands, valid, C, speculate, recheck):
    """Chunked phase 2 for the carry-free kernels.

    ``speculate(avail, dem_c, valid_c, pos) -> (h_s, ok_s)`` proposes a
    chunk's placements from chunk-entry state; ``recheck(a_pre, dem_c,
    valid_c, pos) -> (h_c, ok_c)`` re-decides every position against its
    exact prefix availability with the oracle's ops.  The commit position
    is a host int: one device→host read per chunk."""
    B = demands.shape[0]
    n_eff, _ = _host_rows(valid)
    demP, validP = _pad_chunk(demands, C), _pad_chunk(valid, C)
    placements = torch.full((B + C,), -1, dtype=torch.int32,
                            device=avail.device)
    pos = 0
    while pos < n_eff:
        dem_c, valid_c = demP[pos:pos + C], validP[pos:pos + C]
        h_s, ok_s = speculate(avail, dem_c, valid_c, pos)
        ok_s = ok_s & valid_c
        h_s = torch.where(ok_s, h_s, torch.zeros_like(h_s))
        p_c, _h, _ok, fc, commit_state = _speculate_commit(
            avail, None, False, dem_c, h_s, ok_s,
            lambda a_pre, _ex: recheck(a_pre, dem_c, valid_c, pos),
        )
        # graftcheck: ignore[host-sync] -- the chunk form (phase2=int) reads each chunk's committed prefix length: one read a chunk of C steps; the main path's "auto" is the slim form
        n_commit = min(int(fc) + 1, C)
        placements[pos:pos + C] = p_c
        avail, _ = commit_state(n_commit)
        pos += n_commit
    return placements[:B], avail


def _empty_result(avail, restore):
    return (torch.zeros((0,), dtype=torch.int32, device=avail.device),
            restore(avail))


def opportunistic_impl(avail, demands, valid, uniforms, phase2="auto",
                       live=None, risk=None, n_bound=None):
    """Two-phase form of :func:`opportunistic_kernel_ref`, bit-identical
    to it in every mode.  ``n_bound``: the slim pass's host step bound
    (:func:`_slim_drive`)."""
    mode = _resolve_phase2(phase2)
    avail, restore = _apply_live(avail, live)
    if mode == "scan":
        p, a = _opportunistic_scan(avail, demands, valid, uniforms, risk)
        return p, restore(a)
    if mode == "slim":
        p, a = _slim_drive(
            avail, demands, valid,
            lambda avail, j, demand: _opportunistic_row(
                avail, demand, valid[j], uniforms[j], risk),
            n_bound,
        )
        return p, restore(a)
    B = demands.shape[0]
    if B == 0:
        return _empty_result(avail, restore)
    C = min(mode, B)
    uP = _pad_chunk(uniforms, C)

    def decide(avail_c, dem_c, valid_c, pos):
        fit = (avail_c >= dem_c[:, None, :]).all(dim=2) & valid_c[:, None]
        fit = _risk_restrict(fit, risk)
        n_fit = fit.sum(dim=1)
        k = torch.minimum((uP[pos:pos + C] * n_fit).to(torch.int32),
                          (n_fit - 1).to(torch.int32))
        rank = torch.cumsum(fit, dim=1)
        h = _first_true(fit & (rank == (k + 1)[:, None]))
        return h, n_fit > 0

    # Random choices do not pile on, so the decision itself against the
    # chunk-entry availability commits wide.
    p, a = _chunk_drive(
        avail, demands, valid, C,
        lambda avail, dem_c, valid_c, pos: decide(avail[None], dem_c,
                                                  valid_c, pos),
        decide,
    )
    return p, restore(a)


def first_fit_impl(avail, demands, valid, strict=False, totals=None,
                   phase2="auto", live=None, risk=None, n_bound=None):
    """Two-phase form of :func:`first_fit_kernel_ref`.  ``totals`` (full
    host capacity) steers only the chunked form's speculation, so it
    cannot change a placement."""
    mode = _resolve_phase2(phase2)
    avail, restore = _apply_live(avail, live)
    if mode == "scan":
        p, a = _first_fit_scan(avail, demands, valid, strict, risk)
        return p, restore(a)
    if mode == "slim":
        p, a = _slim_drive(
            avail, demands, valid,
            lambda avail, j, demand: _first_fit_row(
                avail, demand, valid[j], strict, risk),
            n_bound,
        )
        return p, restore(a)
    B = demands.shape[0]
    if B == 0:
        return _empty_result(avail, restore)

    def speculate(avail, dem_c, valid_c, pos):
        # Fill in host-index order (or the risk order), capacity from the
        # leading demand: identical-demand runs commit whole chunks.
        viable = _static_viable(totals, dem_c[0], strict)
        caps = _fill_capacity(avail, dem_c[0], strict, viable)
        ranks = torch.arange(dem_c.shape[0], device=avail.device)
        if risk is None:
            return _fill_pick_by_index(caps, ranks)
        return _fill_pick(risk, caps, ranks)

    def recheck(a_pre, dem_c, valid_c, pos):
        fit = _fits(a_pre, dem_c[:, None, :], strict) & valid_c[:, None]
        if risk is None:
            h = _first_true(fit)
        else:
            h = torch.argmin(_risk_key(fit, risk), dim=1)
        return h, fit.any(dim=1)

    p, a = _chunk_drive(avail, demands, valid, min(mode, B), speculate,
                        recheck)
    return p, restore(a)


def best_fit_impl(avail, demands, valid, totals=None, phase2="auto",
                  live=None, risk=None, n_bound=None):
    """Two-phase form of :func:`best_fit_kernel_ref`."""
    mode = _resolve_phase2(phase2)
    avail, restore = _apply_live(avail, live)
    if mode == "scan":
        p, a = _best_fit_scan(avail, demands, valid, risk)
        return p, restore(a)
    if mode == "slim":
        p, a = _slim_drive(
            avail, demands, valid,
            lambda avail, j, demand: _best_fit_row(avail, demand, valid[j],
                                                   risk),
            n_bound,
        )
        return p, restore(a)
    B = demands.shape[0]
    if B == 0:
        return _empty_result(avail, restore)
    big = avail.new_full((), float("inf"))

    def speculate(avail, dem_c, valid_c, pos):
        # Best-fit piles onto its argmin host until the fit fails, then
        # moves to the next host in chunk-entry residual order.
        viable = _static_viable(totals, dem_c[0], strict=True)
        caps = _fill_capacity(avail, dem_c[0], True, viable)
        resid0 = _risk_score(_norms(avail - dem_c[0][None, :]), risk)
        return _fill_pick(resid0, caps,
                          torch.arange(dem_c.shape[0], device=avail.device))

    def recheck(a_pre, dem_c, valid_c, pos):
        fit = _fits(a_pre, dem_c[:, None, :], True) & valid_c[:, None]
        residual = _risk_score(_norms(a_pre - dem_c[:, None, :]), risk)
        h = torch.argmin(torch.where(fit, residual, big), dim=1)
        return h, fit.any(dim=1)

    p, a = _chunk_drive(avail, demands, valid, min(mode, B), speculate,
                        recheck)
    return p, restore(a)


# -- replica-batched passes (``jax.vmap`` of the per-tick kernels) ----------


def first_fit_batched(avail_r, demands, valid, strict=False, risk=None,
                      n_bound=None):
    """First fit over ``R`` availability replicas that share one task
    stream — the port of ``jax.vmap(first_fit_kernel)`` over the
    availability axis (``pivot_tpu/sched/tpu.py:1659-1666``):
    ``avail_r [R, H, 4]``, ``demands [B, 4]``, ``valid [B]``, optional
    ``risk [H]``.  One pass of task steps, each on ``[R, H]``; ``n_bound``
    as in :func:`_slim_drive`.  Returns ``([R, B] int32 placements,
    [R, H, 4] availability)``, each row bitwise the unbatched pass on that
    row."""
    return _slim_drive(
        avail_r, demands, valid,
        lambda avail, j, demand: _first_fit_row(avail, demand, valid[j],
                                                strict, risk),
        n_bound,
    )


def best_fit_batched(avail_r, demands, valid, risk=None, n_bound=None):
    """Best fit over ``R`` replicas sharing one task stream — the port of
    ``jax.vmap(best_fit_kernel)`` (``pivot_tpu/sched/tpu.py:1724-1729``);
    contract of :func:`first_fit_batched`."""
    return _slim_drive(
        avail_r, demands, valid,
        lambda avail, j, demand: _best_fit_row(avail, demand, valid[j], risk),
        n_bound,
    )


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
    the slim phase 2 recomputes the group score only at group entries and
    reads its control stream (valid, group entries, anchor zones) to the
    host once per call; the chunked phase 2 reads its commit position
    once per chunk."""
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
    B, H = demands.shape[0], avail.shape[0]
    if B == 0:
        return _empty_result(avail, restore)
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
    frozen = torch.zeros(H, dtype=dtype, device=avail.device)
    extra = torch.zeros(H, dtype=torch.int32, device=avail.device)

    if mode != "slim":
        return _cost_aware_chunks(
            avail, restore, demands, valid, new_group, anchor_zone, row_idx,
            min(mode, B), first_fit, sort_hosts, host_decay, track_extra,
            cost_rt, num_rt, row_src, base_counts, iota_h, frozen, extra,
            totals, risk, w_norm,
        )

    # ---- phase 2 (slim) ----
    avail = avail.clone()
    placements = torch.full((B,), -1, dtype=torch.int32, device=avail.device)
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


def _cost_aware_chunks(avail, restore, demands, valid, new_group,
                       anchor_zone, row_idx, C, first_fit, sort_hosts,
                       host_decay, track_extra, cost_rt, num_rt, row_src,
                       base_counts, iota_h, frozen, extra, totals, risk,
                       w_norm):
    """The chunked phase 2 of :func:`cost_aware_impl`
    (``pivot_tpu/ops/kernels.py:1125-1251``).

    First-fit chunks are segment-scored: positions before the chunk's
    first group entry e1 keep the carried frozen score, positions in
    [e1, e2) get the score frozen at e1 from the exact prefix
    availability, and the commit is capped at the second entry e2.
    Best-fit speculates by filling in the chunk-entry score order of the
    leading task and re-decides with the live decay counter."""
    B = demands.shape[0]
    dev = avail.device
    dtype = avail.dtype
    big = avail.new_full((), float("inf"))
    n_eff, _ = _host_rows(valid)
    demP, validP, ngP = (_pad_chunk(x, C)
                         for x in (demands, valid, new_group))
    azP, riP = _pad_chunk(anchor_zone, C), _pad_chunk(row_idx, C)
    idx = torch.arange(C, device=dev)
    placements = torch.full((B + C,), -1, dtype=torch.int32, device=dev)
    pos = 0
    while pos < n_eff:
        dem_c, valid_c = demP[pos:pos + C], validP[pos:pos + C]
        ng_c = ngP[pos:pos + C]
        az_c, ri_c = azP[pos:pos + C].long(), riP[pos:pos + C].long()
        if first_fit:
            e1 = torch.where(ng_c, idx, torch.full_like(idx, C)).min()
            e2 = torch.where(ng_c & (idx > e1), idx,
                             torch.full_like(idx, C)).min()
            e1c = e1.clamp(max=C - 1)
            num_e1, bw_e1 = _at(num_rt, _at(az_c, e1c)), _at(row_src,
                                                             _at(ri_c, e1c))
            dem_e1 = _at(dem_c, e1c)

            def group_row(a):
                if sort_hosts:
                    return _risk_score(
                        _ca_group_score(num_e1, a, bw_e1, w_norm), risk)
                return risk if risk is not None else iota_h

            row_spec = group_row(avail)
            capsA = _fill_capacity(
                avail, dem_c[0], True,
                _static_viable(totals, dem_c[0], strict=True))
            capsB = _fill_capacity(
                avail, dem_e1, True,
                _static_viable(totals, dem_e1, strict=True))
            hA, okA = _fill_pick(frozen, capsA,
                                 torch.where(idx < e1, idx, -1))
            hB, okB = _fill_pick(
                row_spec, capsB,
                torch.where((idx >= e1) & (idx < e2), idx - e1, -1))
            h_s = torch.where(idx < e1, hA, hB)
            ok_s = torch.where(idx < e1, okA, okB) & valid_c
            commit_cap = e2
            row_check = []

            def recheck(a_pre, _ex):
                row = group_row(_at(a_pre, e1c))
                row_check.append(row)
                score_rows = torch.where((idx >= e1)[:, None], row[None],
                                         frozen[None])
                fit = _fits(a_pre, dem_c[:, None, :], True) & valid_c[:, None]
                h = torch.argmin(torch.where(fit, score_rows, big), dim=1)
                return h, fit.any(dim=1)
        else:
            cost_rows, bw_rows = cost_rt[az_c], row_src[ri_c]  # [C, H]
            resid0 = _norms(avail - dem_c[0][None, :])
            if w_norm is not None:
                resid0 = resid0 ** w_norm
            dec0 = (torch.clamp_min(base_counts + extra.to(dtype), 1.0)
                    if host_decay else 1.0)
            row_spec = _risk_score(cost_rows[0] * resid0 * dec0 / bw_rows[0],
                                   risk)
            caps = _fill_capacity(
                avail, dem_c[0], False,
                _static_viable(totals, dem_c[0], strict=False))
            h_s, ok_s = _fill_pick(row_spec, caps, idx)
            ok_s = ok_s & valid_c
            commit_cap = None

            def recheck(a_pre, ex_pre):
                fit = (_fits(a_pre, dem_c[:, None, :], False)
                       & valid_c[:, None])
                residual = _norms(a_pre - dem_c[:, None, :])
                if w_norm is not None:
                    residual = residual ** w_norm
                decay = (
                    torch.clamp_min(base_counts[None] + ex_pre.to(dtype), 1.0)
                    if host_decay else 1.0
                )
                cand = _risk_score(cost_rows * residual * decay / bw_rows,
                                   risk)
                h = torch.argmin(torch.where(fit, cand, big), dim=1)
                return h, fit.any(dim=1)

        h_s = torch.where(ok_s, h_s, torch.zeros_like(h_s))
        p_c, _h, _ok, fc, commit_state = _speculate_commit(
            avail, extra, track_extra, dem_c, h_s, ok_s, recheck)
        n_commit = fc + 1
        if commit_cap is not None:
            n_commit = torch.minimum(n_commit, commit_cap)
        n_commit = max(min(int(n_commit), C), 1)  # the chunk's host read
        placements[pos:pos + C] = p_c
        avail, extra = commit_state(n_commit)
        if first_fit:
            frozen = torch.where(e1 < n_commit, row_check[0], frozen)
        pos += n_commit
    return placements[:B], restore(avail)
