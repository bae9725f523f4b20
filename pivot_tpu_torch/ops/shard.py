"""Host-axis-sharded placement passes — one cluster's hosts in S blocks.

Port of the 1-D forms of ``pivot_tpu/ops/shard.py``.  The reference
partitions the host axis of the placement hot path over the ``host``
axis of a ``jax.sharding.Mesh``: the ``[H, 4]`` availability carry, the
live mask, the risk row, the phase-1 score rows and the host-decay
counters live shard-resident (``[H/S, ...]`` per shard), each sequential
placement step runs its O(H) fit/score work shard-parallel, and a small
collective picks the winner.

The port keeps that single-controller program and runs it on one device
(``parallel/mesh.py``): every ``[H, ...]`` host operand is viewed as
``[S, H/S, ...]`` — shard s owns hosts ``[s·H/S, (s+1)·H/S)`` — the
per-shard body runs batched over the leading shard axis, and the
collectives are the reference's two stages, on the device:

  1. every shard takes a **local argmin** over its block (ties → lowest
     local index) and adds its offset ``s·H/S``;
  2. an argmin over the S ``(score, global index)`` pairs picks the
     winner (ties → lowest shard).

Lower shard ⇒ strictly lower global indices, so stage 2's first
occurrence composed with stage 1's is exactly "minimum ``(score, global
index)``" — the flat argmin's rule, bit for bit.  Every score element is
computed per host by the SAME helpers the unsharded forms use
(``ops/kernels.py``: ``_fits``, ``_apply_live``, ``_norms``,
``_risk_key``, ``_ca_phase1``, ``_ca_group_score``,
``_ca_best_fit_score``), each depending only on its own host, so
sharding cannot move a rounding.  First-fit's lowest-index fit is a min
over the per-shard first fits; the opportunistic arm's k-th fitting host
is a local integer cumsum plus the exclusive prefix of the shard totals
— exact.  A mesh whose devices are not all one device raises
``NotImplementedError``: a mesh over several cards waits for a machine
with several cards (:data:`SEVERAL_CARDS`).

**Phase-2 modes.**  ``"auto"``, ``"scan"`` and ``"slim"`` resolve to the
per-step pass: it reads the batch's step bound from the device once
(as ``kernels._slim_drive`` does), then walks the steps with no host
read.  ``phase2 = int C`` selects the sharded speculative chunk commit:
speculate every chunk position against chunk-entry state with one
batched two-stage reduce, replay the exact carry fold shard-locally,
re-decide all C positions against their exact prefixes in one batched
reduce, commit through the first disagreement
(``kernels._speculate_commit``'s induction) — one host read of the
commit position a chunk, like the unsharded chunk forms.  Every mode is
bit-identical to every unsharded mode.

**Fused spans.**  :func:`sharded_fused_tick_run` drives the span
algebra of ``ops/tickloop.py`` (``_span_tick``) with a sharded ``place``
callable: the ``[S, H/S, 4]`` availability and the ``[S, H/S]``
span-cumulative decay counts stay in the sharded layout between ticks.

**Rows over the replica axis.**  :func:`row_sharding` and
:func:`check_row_divisibility` are the one definition of how a leading
row or replica batch splits over the mesh's ``replica`` axis — the
ensemble's ``sharded_rollout`` and ``shard_sweep``, the search's
``sharded_rollout`` fitness backend and the dispatch batcher's mesh
flushes all use it.  Rows never communicate, so on one device the
sharded program is the unsharded ``[N]`` batch viewed as ``[S, N/S]``.

**The 2-D mesh.**  On a ``replica × host`` mesh the dispatch batcher
(``sched/batch.py``) serves a coalesced group of G same-key requests
through the ``[G]``-batched twins (``*_kernel_sharded_batched``,
:func:`sharded_batched_tick_run`; :func:`batched_sharded_call`): every
operand carries a leading ``[G]`` run axis over the ``replica`` axis and
each row's host axis keeps the 1-D layout.  Rows never communicate, and
on one card the replica blocks are one device, so the G rows run one
after another through the 1-D sharded body — the reference's ``vmap``,
row for row, each row bit-identical to the 1-D twin on that row.  A
lone request runs its 1-D twin (:func:`sharded_twin_of`).

**The sharded resident carry.**  :func:`sharded_resident_carry_init` and
:func:`sharded_resident_span_run` keep ``tickloop.resident_span_run``'s
delta contract on the host blocks: edits arrive as GLOBAL host indices
and each shard projects them into its own block (foreign and pad rows
drop), the risk rows are gathered per shard from the once-staged
``[P, H]`` table, and the span's placements fold into the shard-local
counts.  The carry's tensors stay in the flat ``[H, ...]`` layout
between spans (viewed as ``[S, H/S]`` inside), so
``resident_carry_clone`` / ``_export`` / ``_restore`` and the recovery
plane's snapshots take it unchanged.

**Elastic re-layout.**  When a mesh shard is lost mid-serve, the pool
shrinks onto the next rung of a declared ladder of mesh shapes
(:func:`mesh_shape_ladder`, the descending divisors of the launch shard
count; :func:`next_ladder_shape`) and regrows up it when the shard
returns (``serve/elastic.py``).  Host state re-lays from one rung onto
another on the host, in numpy (``pivot_tpu/ops/shard.py:1914-2078``):
:func:`elastic_trim_rows` cuts the old rung's pad rows back to the true
host count H, :func:`elastic_pad_rows` / :func:`elastic_pad_state` pad
to the new rung's extent (:func:`elastic_host_extent`, the smallest
multiple of the shard count ≥ H) with :data:`DEAD_AVAIL` availability, a
False live mask and zero counts, risk and zone.  A pad row can never be
chosen: no demand fits a negative availability and the live mask
excludes it, so placements on padded operands equal the unpadded run's.
:func:`elastic_fold_carry` moves a pending resident carry onto another
rung (or onto the unsharded layout).  These helpers run between device
programs, never inside one, and add no device body.

No pass here may read the device inside its step loop
(``analysis/hostsync.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from pivot_tpu_torch.ops.kernels import (
    _apply_live,
    _ca_best_fit_score,
    _ca_group_score,
    _ca_phase1,
    _at,
    _first_true,
    _fits,
    _host_rows,
    _norms,
    _pad_chunk,
    _resolve_phase2,
    _risk_key,
    _risk_score,
    _set_placement,
    _speculate_commit,
    best_fit_impl,
    cost_aware_impl,
    first_fit_impl,
    opportunistic_impl,
)
from pivot_tpu_torch.ops.tickloop import (
    ResidentCarry,
    SpanResult,
    _cohort_ahead,
    _cost_aware_stream,
    _span_tick,
    _stack_spans,
    _tick_cost,
    fused_tick_run,
    resident_carry_export,
    resident_carry_init,
    span_step_bounds,
)
from pivot_tpu_torch.parallel.mesh import host_axis_size

__all__ = [
    "HOST_AXIS",
    "REPLICA_AXIS",
    "RowSharding",
    "SEVERAL_CARDS",
    "UNSHARDABLE_KW",
    "batched_sharded_call",
    "best_fit_kernel_sharded",
    "best_fit_kernel_sharded_batched",
    "DEAD_AVAIL",
    "check_row_divisibility",
    "cost_aware_kernel_sharded",
    "cost_aware_kernel_sharded_batched",
    "elastic_fold_carry",
    "elastic_host_extent",
    "elastic_pad_rows",
    "elastic_pad_state",
    "elastic_trim_rows",
    "first_fit_kernel_sharded",
    "first_fit_kernel_sharded_batched",
    "mesh_device",
    "mesh_is_2d",
    "mesh_shape_ladder",
    "next_ladder_shape",
    "one_device",
    "opportunistic_kernel_sharded",
    "opportunistic_kernel_sharded_batched",
    "row_sharding",
    "sharded_batched_tick_run",
    "sharded_fused_tick_run",
    "sharded_resident_carry_init",
    "sharded_resident_span_run",
    "sharded_twin_of",
]

#: Mesh axis the host dimension shards over (``parallel/mesh.py``).
HOST_AXIS = "host"

#: Mesh axis row/replica batches shard over (``parallel/mesh.py``).
REPLICA_AXIS = "replica"

#: Integer sentinel above any host index — the "no candidate" value of
#: the min reduces.
_NO_HOST = 1 << 30

#: Where a mesh over several distinct cards stands: a machine with one
#: card can neither run nor test it.
SEVERAL_CARDS = "ROADMAP.md Queue 1, several cards"


def _check_host_axis(H: int, mesh) -> int:
    n = host_axis_size(mesh)
    if H % n:
        raise ValueError(
            f"host axis H={H} does not divide over the mesh's {n} host "
            f"shards — pad the cluster with DOWN-sentinel hosts (a -1 "
            f"availability row is never selected) to a multiple of {n}"
        )
    return n


def mesh_is_2d(mesh) -> bool:
    """True when ``mesh`` composes both program axes: a non-trivial
    ``host`` axis next to the ``replica`` axis."""
    return (
        HOST_AXIS in mesh.shape and REPLICA_AXIS in mesh.shape
        and int(mesh.shape[HOST_AXIS]) > 1
    )


def _check_g_axis(mesh, G: int) -> None:
    n = int(mesh.shape[REPLICA_AXIS])
    if G % n:
        raise ValueError(
            f"batch axis G={G} does not divide over the mesh's {n} "
            f"replica shards — the batcher's group bucket must be a "
            f"multiple of the replica axis (sched.batch.group_bucket)"
        )


def _sharded_mode(phase2):
    """The scan/slim family collapses to the per-step pass ("step"); an
    int chunk size selects the sharded chunk commit."""
    mode = _resolve_phase2(phase2)
    return mode if isinstance(mode, int) else "step"


def _same_device(d: torch.device) -> torch.device:
    """``d`` with its index made explicit (``cuda`` → ``cuda:<current>``)."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def one_device(devices) -> bool:
    """Whether every entry of ``devices`` names one device: the meshes
    :func:`mesh_device` accepts (S logical shards of one card)."""
    return len({_same_device(torch.device(d)) for d in devices}) == 1


def mesh_device(mesh, expect=None) -> torch.device:
    """The one device every shard of ``mesh`` lives on (checked against
    ``expect`` when given).  A mesh over several distinct devices raises:
    its passes would need a transfer between cards each step, which
    nothing here can run or test."""
    devs = {_same_device(torch.device(d)) for d in mesh.devices.flat}
    if len(devs) != 1:
        raise NotImplementedError(
            f"a mesh over {len(devs)} distinct devices "
            f"({sorted(map(str, devs))}) is not ported to pivot_tpu_torch "
            "yet — its shards must name one device (logical shards; "
            f"{SEVERAL_CARDS})"
        )
    dev = devs.pop()
    if expect is not None and _same_device(torch.device(expect)) != dev:
        raise ValueError(
            f"the mesh's shards live on {dev}, the work on {expect} — a "
            "mesh names the device its passes run on"
        )
    return dev


class RowSharding:
    """The port's ``NamedSharding(mesh, P(REPLICA_AXIS))``: a leading row
    axis cut into equal contiguous blocks, block ``s`` on the mesh's
    ``s``-th replica entry (``pivot_tpu/ops/shard.py:183-193``)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.n_shards = int(mesh.shape[REPLICA_AXIS])

    def device(self, expect=None) -> torch.device:
        """The one device the blocks live on (:func:`mesh_device`)."""
        return mesh_device(self.mesh, expect)

    def blocks(self, n_rows: int) -> list:
        """Block ``s``'s rows as a ``slice``, for each shard in order."""
        check_row_divisibility(self.mesh, n_rows)
        b = n_rows // self.n_shards
        return [slice(s * b, (s + 1) * b) for s in range(self.n_shards)]


def row_sharding(mesh) -> RowSharding:
    """How a leading row/batch axis shards over ``mesh``'s
    :data:`REPLICA_AXIS` — the one definition shared by the ensemble's
    row consumers (``sharded_rollout``, ``shard_sweep``, the search's
    candidate rows) and the dispatch batcher's ``[G]`` flushes, so "how
    rows shard" cannot drift between them."""
    return RowSharding(mesh)


def check_row_divisibility(mesh, n_rows: int) -> None:
    """Raise unless ``n_rows`` splits into equal contiguous blocks over
    the mesh's replica axis (``pivot_tpu/ops/shard.py:196-207``)."""
    n = int(mesh.shape[REPLICA_AXIS])
    if n < 1:
        raise ValueError("mesh has an empty replica axis")
    if n_rows % n:
        raise ValueError(
            f"{n_rows} rows do not divide over the mesh's {n} replica "
            f"shards — round the population/replica product up to a "
            f"multiple of {n}"
        )


def _layout(mesh, avail):
    """``(S, offset)`` for ``avail [H, 4]`` on ``mesh``: the shard count
    and the ``[S]`` int64 first global host of each block.  The operands
    must live on the mesh's device."""
    S = _check_host_axis(avail.shape[0], mesh)
    mesh_device(mesh, avail.device)
    Hl = avail.shape[0] // S
    return S, torch.arange(S, device=avail.device) * Hl


def _shard(x, S: int):
    """``[H, ...]`` → ``[S, H/S, ...]`` (contiguous blocks); None stays."""
    if x is None:
        return None
    return x.reshape((S, x.shape[0] // S) + tuple(x.shape[1:]))


# ---------------------------------------------------------------------------
# The collectives.  Each takes per-host rows ``[..., S, H/S]`` — one step's
# ``[S, H/S]``, or a chunk's ``[C, S, H/S]`` rows (the reference's
# ``_rows`` forms) — reduces them per shard (stage 1), then over the
# shard axis (stage 2).
# ---------------------------------------------------------------------------


def _two_stage_argmin(masked, fit, offset):
    """Exact decomposition of the flat ``argmin(masked)`` plus ``ok``:
    stage 1 a local argmin per shard, ties to the lowest local index,
    plus the shard's offset; stage 2 an argmin over the S minima, first
    occurrence (the lowest shard) winning.  ``ok`` is the global fit
    flag; ``h`` is 0 when nothing fits."""
    li = torch.argmin(masked, dim=-1)                          # [..., S]
    lmin = masked.gather(-1, li[..., None])[..., 0]
    s = torch.argmin(lmin, dim=-1, keepdim=True)               # [..., 1]
    h = (li + offset).gather(-1, s)[..., 0]
    ok = fit.any(dim=-1).any(dim=-1)
    return torch.where(ok, h, torch.zeros_like(h)), ok


def _first_index_of(fit, offset):
    """Lowest GLOBAL index with ``fit`` True — the sharded form of
    first-fit's ``argmax(fit)``: per-shard first fit, then a min over the
    shards' candidates."""
    cand = torch.where(fit.any(dim=-1), _first_true(fit) + offset,
                       offset.new_full((), _NO_HOST))
    h = cand.min(dim=-1).values
    ok = h < _NO_HOST
    return torch.where(ok, h, torch.zeros_like(h)), ok


def _opportunistic_pick(fit, u, offset):
    """The k-th fitting host (k = ⌊u·n_fit⌋): the global ``n_fit`` and
    the 1-based cumulative rank are local integer cumsums plus the
    exclusive prefix of the shard totals — exact.  The unique matching
    host reduces by a min like first-fit."""
    c = fit.sum(dim=-1)                                        # [..., S]
    n_fit = c.sum(dim=-1)
    prefix = torch.cumsum(c, dim=-1) - c
    k = torch.minimum((u * n_fit).to(torch.int32),
                      (n_fit - 1).to(torch.int32))
    rank = torch.cumsum(fit, dim=-1) + prefix[..., None]
    match = fit & (rank == (k + 1)[..., None, None])
    cand = torch.where(match.any(dim=-1), _first_true(match) + offset,
                       offset.new_full((), _NO_HOST))
    h = cand.min(dim=-1).values
    ok = n_fit > 0
    return torch.where(ok, h, torch.zeros_like(h)), ok


def _risk_restrict_sharded(fit, risk):
    """The opportunistic risk rule: narrow ``fit`` to the GLOBAL
    minimum-risk tier of fitting hosts (a min per shard, then over the
    shards; no-op when nothing fits, as +inf equals no finite risk)."""
    if risk is None:
        return fit
    rmin = _risk_key(fit, risk).min(dim=-1).values.min(dim=-1).values
    return fit & (risk == rmin[..., None, None])


def _place_local(avail, demand, h, ok, offset):
    """In place on ``avail [S, H/S, 4]``: the owner of global row ``h``
    subtracts ``demand`` from its local row; every other shard adds −0 to
    its row 0 (``x + (−0)`` is ``x``) — the flat ``_place``'s arithmetic
    on the same element."""
    h_local = h - offset
    local = ok & (h_local >= 0) & (h_local < avail.shape[-2])
    delta = torch.where(local[:, None], demand, torch.zeros_like(demand))
    # graftcheck: ignore[determinism] -- one row a shard: indices never collide
    avail.view(-1, avail.shape[-1]).index_add_(
        0, offset + torch.where(local, h_local, torch.zeros_like(h_local)),
        -delta)


def _bump_local(counts, h, ok, offset):
    """In place on ``counts [S, H/S]``: ``counts[h] += 1`` on the owner
    of ``h`` when ``ok``."""
    h_local = h - offset
    local = ok & (h_local >= 0) & (h_local < counts.shape[-1])
    # graftcheck: ignore[determinism] -- one row a shard, integer counts
    counts.view(-1).index_add_(
        0, offset + torch.where(local, h_local, torch.zeros_like(h_local)),
        local.to(counts.dtype))


# ---------------------------------------------------------------------------
# Sharded per-step passes (avail is the [S, H/S, 4] view)
# ---------------------------------------------------------------------------


def _carry_free_sharded_pass(avail, demands, valid, decide, offset,
                             n_bound=None):
    """Sharded ``kernels._slim_drive``: ``decide(avail, j, demand) ->
    (h, ok)`` already reduced over the shards; the step bound is read
    once before the loop (or given by the host, ``n_bound``)."""
    avail = avail.clone()
    B = demands.shape[0]
    placements = torch.full((B,), -1, dtype=torch.int32, device=avail.device)
    n = _host_rows(valid)[0] if n_bound is None else min(n_bound, B)
    for j in range(n):
        h, ok = decide(avail, j, demands[j])
        _place_local(avail, demands[j], h, ok, offset)
        _set_placement(placements, j, h, ok)
    return placements, avail


def _opportunistic_sharded_pass(avail, demands, valid, uniforms, offset,
                                risk=None, n_bound=None):
    def decide(avail, j, demand):
        fit = _fits(avail, demand, strict=False) & valid[j]
        fit = _risk_restrict_sharded(fit, risk)
        return _opportunistic_pick(fit, uniforms[j], offset)

    return _carry_free_sharded_pass(avail, demands, valid, decide, offset,
                                    n_bound)


def _first_fit_sharded_pass(avail, demands, valid, strict, offset, risk=None,
                            n_bound=None):
    def decide(avail, j, demand):
        fit = _fits(avail, demand, strict) & valid[j]
        if risk is None:
            return _first_index_of(fit, offset)
        # Risk-aware first fit: lexicographic (risk, global index), the
        # two-stage argmin's composed tie rule.
        return _two_stage_argmin(_risk_key(fit, risk), fit, offset)

    return _carry_free_sharded_pass(avail, demands, valid, decide, offset,
                                    n_bound)


def _best_fit_sharded_pass(avail, demands, valid, offset, risk=None,
                           n_bound=None):
    big = avail.new_full((), float("inf"))

    def decide(avail, j, demand):
        fit = _fits(avail, demand, strict=True) & valid[j]
        residual = _risk_score(_norms(avail - demand), risk)
        return _two_stage_argmin(torch.where(fit, residual, big), fit, offset)

    return _carry_free_sharded_pass(avail, demands, valid, decide, offset,
                                    n_bound)


# ---------------------------------------------------------------------------
# Sharded speculative chunk commit (phase2 = int C)
# ---------------------------------------------------------------------------


def _shard_fold(offset):
    """The carry fold's ``place`` / ``bump`` ops for
    ``kernels._speculate_commit`` on the sharded layout."""
    return (lambda a, d, h, ok: _place_local(a, d, h, ok, offset),
            lambda c, h, ok: _bump_local(c, h, ok, offset))


def _sharded_chunk_drive(avail, demands, valid, C, decide_rows, offset):
    """Sharded ``kernels._chunk_drive``: ``decide_rows(a_rows [C, S, H/S,
    4], dem_c, valid_c, pos) -> (h [C], ok [C])`` is the exact batched
    per-position decision; speculation calls it on chunk-entry rows, the
    re-decision on the exact prefix rows.  One host read a chunk (the
    commit position)."""
    B = demands.shape[0]
    n_eff, _ = _host_rows(valid)
    demP, validP = _pad_chunk(demands, C), _pad_chunk(valid, C)
    placements = torch.full((B + C,), -1, dtype=torch.int32,
                            device=avail.device)
    place, bump = _shard_fold(offset)
    pos = 0
    while pos < n_eff:
        dem_c, valid_c = demP[pos:pos + C], validP[pos:pos + C]
        h_s, ok_s = decide_rows(avail.expand((C,) + tuple(avail.shape)),
                                dem_c, valid_c, pos)
        ok_s = ok_s & valid_c
        h_s = torch.where(ok_s, h_s, torch.zeros_like(h_s))
        p_c, _h, _ok, fc, commit_state = _speculate_commit(
            avail, None, False, dem_c, h_s, ok_s,
            lambda a_pre, _ex: decide_rows(a_pre, dem_c, valid_c, pos),
            place=place, bump=bump,
        )
        # graftcheck: ignore[host-sync] -- the chunk form (phase2=int) reads each chunk's committed prefix length: one read a chunk of C steps, as the unsharded chunk forms
        n_commit = min(int(fc) + 1, C)
        placements[pos:pos + C] = p_c
        avail, _ = commit_state(n_commit)
        pos += n_commit
    return placements[:B], avail


def _opportunistic_sharded_chunk(avail, demands, valid, uniforms, C, offset,
                                 risk=None):
    uP = _pad_chunk(uniforms, C)

    def decide_rows(a_rows, dem_c, valid_c, pos):
        fit = (_fits(a_rows, dem_c[:, None, None, :], strict=False)
               & valid_c[:, None, None])
        fit = _risk_restrict_sharded(fit, risk)
        return _opportunistic_pick(fit, uP[pos:pos + C], offset)

    return _sharded_chunk_drive(avail, demands, valid, C, decide_rows, offset)


def _first_fit_sharded_chunk(avail, demands, valid, C, strict, offset,
                             risk=None):
    def decide_rows(a_rows, dem_c, valid_c, pos):
        fit = (_fits(a_rows, dem_c[:, None, None, :], strict)
               & valid_c[:, None, None])
        if risk is None:
            return _first_index_of(fit, offset)
        return _two_stage_argmin(_risk_key(fit, risk), fit, offset)

    return _sharded_chunk_drive(avail, demands, valid, C, decide_rows, offset)


def _best_fit_sharded_chunk(avail, demands, valid, C, offset, risk=None):
    big = avail.new_full((), float("inf"))

    def decide_rows(a_rows, dem_c, valid_c, pos):
        fit = (_fits(a_rows, dem_c[:, None, None, :], strict=True)
               & valid_c[:, None, None])
        residual = _risk_score(_norms(a_rows - dem_c[:, None, None, :]), risk)
        return _two_stage_argmin(torch.where(fit, residual, big), fit, offset)

    return _sharded_chunk_drive(avail, demands, valid, C, decide_rows, offset)


def _cost_aware_sharded_pass(avail, demands, valid, new_group, anchor_zone,
                             cost_zz, bw_zz, host_zone, base_task_counts,
                             offset, bin_pack, sort_hosts, host_decay,
                             risk=None):
    """Sharded Cost-Aware per-step pass — the slim phase 2 of
    ``kernels.cost_aware_impl`` with every host-row expression on the
    ``[S, H/S]`` blocks (``host_zone``, ``base_task_counts`` and ``risk``
    in that layout) and the argmin swapped for the two-stage reduce.
    Reads the control stream (valid, group entries, anchor zones) to the
    host once, as the slim pass does."""
    B = demands.shape[0]
    dtype = avail.dtype
    first_fit = bin_pack == "first-fit"
    big = avail.new_full((), float("inf"))
    base_counts = base_task_counts.to(dtype)
    track_extra = (not first_fit) and host_decay
    cost_rt, bw_rt, num_rt = _ca_phase1(
        cost_zz, bw_zz, host_zone, base_counts,
        first_fit and sort_hosts and host_decay,
    )                                                       # [Z, S, H/S]
    Hl = avail.shape[1]
    # The identity host order: the GLOBAL index (exact in any float).
    iota_h = (offset[:, None]
              + torch.arange(Hl, device=avail.device)).to(dtype)
    avail = avail.clone()
    frozen = torch.zeros_like(base_counts)
    extra = torch.zeros(base_counts.shape, dtype=torch.int32,
                        device=avail.device)
    placements = torch.full((B,), -1, dtype=torch.int32, device=avail.device)
    n_eff, (ng, az) = _host_rows(valid, new_group, anchor_zone)
    for j in range(n_eff):
        demand = demands[j]
        if first_fit:
            if ng[j]:
                if sort_hosts:
                    frozen = _risk_score(_ca_group_score(
                        num_rt[az[j]], avail, bw_rt[az[j]]), risk)
                else:
                    frozen = iota_h if risk is None else risk
            fit = _fits(avail, demand, strict=True) & valid[j]
            h, ok = _two_stage_argmin(torch.where(fit, frozen, big), fit,
                                      offset)
        else:
            decay = (
                torch.clamp_min(base_counts + extra.to(dtype), 1.0)
                if host_decay else 1.0
            )
            per_task = _risk_score(_ca_best_fit_score(
                cost_rt[az[j]], avail, demand, decay, bw_rt[az[j]]), risk)
            fit = _fits(avail, demand, strict=False) & valid[j]
            h, ok = _two_stage_argmin(torch.where(fit, per_task, big), fit,
                                      offset)
        _place_local(avail, demand, h, ok, offset)
        if track_extra:
            _bump_local(extra, h, ok, offset)
        _set_placement(placements, j, h, ok)
    return placements, avail


def _cost_aware_sharded_chunk_pass(avail, demands, valid, new_group,
                                   anchor_zone, cost_zz, bw_zz, host_zone,
                                   base_task_counts, C, offset, bin_pack,
                                   sort_hosts, host_decay, risk=None):
    """Sharded Cost-Aware chunk commit: shard-local score and fold
    arithmetic, the batched two-stage reduce for the speculation (against
    chunk-entry state) and for the exact re-decision.  First-fit keeps
    the unsharded form's segment capping: the commit never crosses the
    chunk's SECOND group entry, and the entry score row is recomputed
    from the exact prefix state."""
    B = demands.shape[0]
    S, Hl = avail.shape[0], avail.shape[1]
    dev, dtype = avail.device, avail.dtype
    first_fit = bin_pack == "first-fit"
    big = avail.new_full((), float("inf"))
    base_counts = base_task_counts.to(dtype)
    track_extra = (not first_fit) and host_decay
    cost_rt, bw_rt, num_rt = _ca_phase1(
        cost_zz, bw_zz, host_zone, base_counts,
        first_fit and sort_hosts and host_decay,
    )
    iota_h = (offset[:, None] + torch.arange(Hl, device=dev)).to(dtype)
    n_eff, _ = _host_rows(valid)
    demP, validP, ngP = (_pad_chunk(x, C) for x in (demands, valid, new_group))
    azP = _pad_chunk(anchor_zone, C)
    idx = torch.arange(C, device=dev)
    placements = torch.full((B + C,), -1, dtype=torch.int32, device=dev)
    frozen = torch.zeros_like(base_counts)
    extra = torch.zeros((S, Hl), dtype=torch.int32, device=dev)
    place, bump = _shard_fold(offset)
    pos = 0
    while pos < n_eff:
        dem_c, valid_c = demP[pos:pos + C], validP[pos:pos + C]
        ng_c, az_c = ngP[pos:pos + C], azP[pos:pos + C].long()
        fit_of = (lambda a_rows, strict: _fits(
            a_rows, dem_c[:, None, None, :], strict) & valid_c[:, None, None])
        if first_fit:
            e1 = torch.where(ng_c, idx, torch.full_like(idx, C)).min()
            e2 = torch.where(ng_c & (idx > e1), idx,
                             torch.full_like(idx, C)).min()
            e1c = e1.clamp(max=C - 1)
            az_e1 = _at(az_c, e1c)
            seg = (idx >= e1)[:, None, None]
            row_check = []

            def group_row(entry_avail):
                if sort_hosts:
                    return _risk_score(_ca_group_score(
                        _at(num_rt, az_e1), entry_avail, _at(bw_rt, az_e1)),
                        risk)
                return risk if risk is not None else iota_h

            def decide(a_rows, row):
                fit = fit_of(a_rows, True)
                score_rows = torch.where(seg, row[None], frozen[None])
                return _two_stage_argmin(torch.where(fit, score_rows, big),
                                         fit, offset)

            h_s, ok_s = decide(avail.expand((C,) + tuple(avail.shape)),
                               group_row(avail))
            commit_cap = e2

            def recheck(a_pre, _ex):
                row = group_row(_at(a_pre, e1c))
                row_check.append(row)
                return decide(a_pre, row)
        else:
            cost_rows, bw_rows = cost_rt[az_c], bw_rt[az_c]  # [C, S, H/S]

            def recheck(a_rows, ex_rows):
                fit = fit_of(a_rows, False)
                residual = _norms(a_rows - dem_c[:, None, None, :])
                decay = (
                    torch.clamp_min(base_counts[None] + ex_rows.to(dtype), 1.0)
                    if host_decay else 1.0
                )
                cand = _risk_score(cost_rows * residual * decay / bw_rows,
                                   risk)
                return _two_stage_argmin(torch.where(fit, cand, big), fit,
                                         offset)

            h_s, ok_s = recheck(avail.expand((C,) + tuple(avail.shape)),
                                extra.expand((C, S, Hl)))
            commit_cap = None
        ok_s = ok_s & valid_c
        h_s = torch.where(ok_s, h_s, torch.zeros_like(h_s))
        p_c, _h, _ok, fc, commit_state = _speculate_commit(
            avail, extra, track_extra, dem_c, h_s, ok_s, recheck,
            place=place, bump=bump)
        n_commit = fc + 1
        if commit_cap is not None:
            n_commit = torch.minimum(n_commit, commit_cap)
        # graftcheck: ignore[host-sync] -- the chunk form (phase2=int) reads each chunk's committed prefix length: one read a chunk, as cost_aware_impl's chunks
        n_commit = max(min(int(n_commit), C), 1)
        placements[pos:pos + C] = p_c
        avail, extra = commit_state(n_commit)
        if first_fit:
            frozen = torch.where(e1 < n_commit, row_check[0], frozen)
        pos += n_commit
    return placements[:B], avail


# ---------------------------------------------------------------------------
# Public sharded kernels
# ---------------------------------------------------------------------------


def _sharded_call(mesh, avail, demands, live, body):
    """The shared wrapper of the four kernels: the host-axis checks, the
    empty-batch passthrough, the live mask on the ``[S, H/S]`` blocks,
    and ``body(avail [S, H/S, 4], S, offset) -> (placements, avail)``;
    the availability comes back as ``[H, 4]``."""
    S, offset = _layout(mesh, avail)
    if demands.shape[0] == 0:
        return (torch.zeros((0,), dtype=torch.int32, device=avail.device),
                avail)
    a, restore = _apply_live(_shard(avail, S), _shard(live, S))
    p, out = body(a, S, offset)
    return p, restore(out).reshape(avail.shape)


def opportunistic_kernel_sharded(mesh, avail, demands, valid, uniforms,
                                 phase2="auto", live=None, risk=None):
    """Host-sharded ``kernels.opportunistic_impl`` — bit-identical to it
    in every ``phase2`` mode.  ``risk`` (optional [H] eviction-risk
    vector) narrows the random choice to the global minimum-risk tier."""
    mode = _sharded_mode(phase2)

    def body(a, S, offset):
        r = _shard(risk, S)
        if mode == "step":
            return _opportunistic_sharded_pass(a, demands, valid, uniforms,
                                               offset, r)
        return _opportunistic_sharded_chunk(
            a, demands, valid, uniforms, min(mode, demands.shape[0]),
            offset, r)

    return _sharded_call(mesh, avail, demands, live, body)


def first_fit_kernel_sharded(mesh, avail, demands, valid, strict=False,
                             totals=None, phase2="auto", live=None,
                             risk=None):
    """Host-sharded ``kernels.first_fit_impl``.  ``totals`` (the chunked
    form's speculation pre-filter) is accepted and ignored: the sharded
    chunk speculates against chunk-entry state, and the pre-filter can
    never change a placement.  ``risk`` swaps the index order for the
    lexicographic (risk, global index) order."""
    mode = _sharded_mode(phase2)

    def body(a, S, offset):
        r = _shard(risk, S)
        if mode == "step":
            return _first_fit_sharded_pass(a, demands, valid, bool(strict),
                                           offset, r)
        return _first_fit_sharded_chunk(
            a, demands, valid, min(mode, demands.shape[0]), bool(strict),
            offset, r)

    return _sharded_call(mesh, avail, demands, live, body)


def best_fit_kernel_sharded(mesh, avail, demands, valid, totals=None,
                            phase2="auto", live=None, risk=None):
    """Host-sharded ``kernels.best_fit_impl`` (``totals`` accepted and
    ignored; ``risk`` adds the shared ``score += risk`` term)."""
    mode = _sharded_mode(phase2)

    def body(a, S, offset):
        r = _shard(risk, S)
        if mode == "step":
            return _best_fit_sharded_pass(a, demands, valid, offset, r)
        return _best_fit_sharded_chunk(
            a, demands, valid, min(mode, demands.shape[0]), offset, r)

    return _sharded_call(mesh, avail, demands, live, body)


def cost_aware_kernel_sharded(
    mesh,
    avail,
    demands,
    valid,
    new_group,
    anchor_zone,
    cost_zz,
    bw_zz,
    host_zone,
    base_task_counts,
    bin_pack: str = "first-fit",
    sort_hosts: bool = True,
    host_decay: bool = False,
    rt_bw_rows=None,
    rt_bw_idx=None,
    totals=None,
    phase2="auto",
    live=None,
    risk=None,
):
    """Host-sharded ``kernels.cost_aware_impl`` — the same argument
    contract minus the realtime-bandwidth rows (per-tick sampled host
    state; the device policy declines sharding for ``realtime_bw``) and
    the learned score exponents (``enable_sharding`` refuses them).
    ``risk`` applies the shared rules (``score += risk``;
    ``sort_hosts=False`` order → lexicographic (risk, global index))."""
    mode = _sharded_mode(phase2)
    if rt_bw_rows is not None or rt_bw_idx is not None:
        raise ValueError(
            "realtime_bw has no sharded form — the per-tick sampled "
            "[G, H] rows would reshard every dispatch; use the "
            "single-device kernel for realtime scoring"
        )

    def body(a, S, offset):
        ca = (a, demands, valid, new_group, anchor_zone, cost_zz, bw_zz,
              _shard(host_zone, S), _shard(base_task_counts, S))
        r = _shard(risk, S)
        if mode == "step":
            return _cost_aware_sharded_pass(*ca, offset, bin_pack,
                                            bool(sort_hosts),
                                            bool(host_decay), r)
        return _cost_aware_sharded_chunk_pass(
            *ca, min(mode, demands.shape[0]), offset, bin_pack,
            bool(sort_hosts), bool(host_decay), r)

    return _sharded_call(mesh, avail, demands, live, body)


# ---------------------------------------------------------------------------
# [G]-batched 2-D twins (the batcher's coalesced flushes on a 2-D mesh)
# ---------------------------------------------------------------------------


def _row(x, g: int):
    """Row ``g`` of a ``[G, ...]`` operand; None stays."""
    return None if x is None else x[g]


def _batched_rows(mesh, avail, demands, one_row):
    """The shared wrapper of the four batched twins: the host- and
    G-axis checks, the empty-batch passthrough, then ``one_row(g) ->
    (placements, avail)`` — the 1-D twin on row ``g`` — for each row in
    order, stacked to ``([G, T], [G, H, 4])``."""
    _check_host_axis(avail.shape[1], mesh)
    _check_g_axis(mesh, avail.shape[0])
    if demands.shape[0] == 0 or demands.shape[1] == 0:
        return (torch.zeros(demands.shape[:2], dtype=torch.int32,
                            device=avail.device), avail)
    outs = [one_row(g) for g in range(avail.shape[0])]
    return (torch.stack([p for p, _ in outs]),
            torch.stack([a for _, a in outs]))


def opportunistic_kernel_sharded_batched(mesh, avail, demands, valid,
                                         uniforms, phase2="auto",
                                         live=None, risk=None):
    """[G]-batched :func:`opportunistic_kernel_sharded`: every operand
    carries a leading run axis over the mesh's ``replica`` axis, the host
    axis keeps the 1-D twin's layout; row ``g`` is the 1-D twin on row
    ``g`` of every operand."""
    _sharded_mode(phase2)
    return _batched_rows(mesh, avail, demands, lambda g: (
        opportunistic_kernel_sharded(
            mesh, avail[g], demands[g], valid[g], uniforms[g], phase2,
            _row(live, g), _row(risk, g))))


def first_fit_kernel_sharded_batched(mesh, avail, demands, valid,
                                     strict=False, totals=None,
                                     phase2="auto", live=None, risk=None):
    """[G]-batched :func:`first_fit_kernel_sharded` (``totals`` accepted
    and ignored like the 1-D twin)."""
    _sharded_mode(phase2)
    return _batched_rows(mesh, avail, demands, lambda g: (
        first_fit_kernel_sharded(
            mesh, avail[g], demands[g], valid[g], strict, phase2=phase2,
            live=_row(live, g), risk=_row(risk, g))))


def best_fit_kernel_sharded_batched(mesh, avail, demands, valid,
                                    totals=None, phase2="auto", live=None,
                                    risk=None):
    """[G]-batched :func:`best_fit_kernel_sharded` (``totals`` accepted
    and ignored like the 1-D twin)."""
    _sharded_mode(phase2)
    return _batched_rows(mesh, avail, demands, lambda g: (
        best_fit_kernel_sharded(
            mesh, avail[g], demands[g], valid[g], phase2=phase2,
            live=_row(live, g), risk=_row(risk, g))))


def cost_aware_kernel_sharded_batched(
    mesh,
    avail,
    demands,
    valid,
    new_group,
    anchor_zone,
    cost_zz,
    bw_zz,
    host_zone,
    base_task_counts,
    bin_pack: str = "first-fit",
    sort_hosts: bool = True,
    host_decay: bool = False,
    rt_bw_rows=None,
    rt_bw_idx=None,
    totals=None,
    phase2="auto",
    live=None,
    risk=None,
):
    """[G]-batched :func:`cost_aware_kernel_sharded` (the same
    realtime-bandwidth exclusion, the same ignored ``totals``); the
    ``[Z, Z]`` tables are ``[G, Z, Z]``, one a row."""
    _sharded_mode(phase2)
    if rt_bw_rows is not None or rt_bw_idx is not None:
        raise ValueError(
            "realtime_bw has no sharded form — the per-tick sampled "
            "[G, H] rows would reshard every dispatch; use the "
            "single-device kernel for realtime scoring"
        )
    return _batched_rows(mesh, avail, demands, lambda g: (
        cost_aware_kernel_sharded(
            mesh, avail[g], demands[g], valid[g], new_group[g],
            anchor_zone[g], cost_zz[g], bw_zz[g], host_zone[g],
            base_task_counts[g], bin_pack, sort_hosts, host_decay,
            phase2=phase2, live=_row(live, g), risk=_row(risk, g))))


# ---------------------------------------------------------------------------
# Sharded fused span driver
# ---------------------------------------------------------------------------


def sharded_fused_tick_run(
    mesh,
    avail,
    demands,
    arrive,
    n_ticks_dyn: int,
    *,
    policy: str,
    n_ticks: int,
    n_bound: Optional[Sequence[int]] = None,
    uniforms=None,
    sort_norm=None,
    anchor_zone=None,
    bucket_id=None,
    cost_zz=None,
    bw_zz=None,
    host_zone=None,
    base_task_counts=None,
    totals=None,
    live=None,
    risk_rows=None,
    cost_stack=None,
    cost_seg=None,
    strict: bool = False,
    decreasing: bool = False,
    bin_pack: str = "first-fit",
    sort_tasks: bool = False,
    sort_hosts: bool = True,
    host_decay: bool = False,
    phase2="auto",
) -> SpanResult:
    """Host-sharded ``tickloop.fused_tick_run`` — the same contract and
    :class:`SpanResult` (``avail`` back as ``[H, 4]``), the availability
    carry and the span-cumulative decay counts kept in the ``[S, H/S]``
    layout between ticks.  Each tick is the span algebra's
    ``_span_tick`` with the per-step sharded passes placing: the
    carry-free arms walk ``n_bound[k]`` steps with no device read (the
    host step bounds of :func:`tickloop.span_step_bounds`; None reads
    ``arrive`` once), Cost-Aware reads its control stream once a tick as
    ``cost_aware_impl`` does.  ``totals`` / ``phase2`` are accepted for
    the signature (every mode is the per-step pass).  The market operands
    follow ``fused_tick_run``: ``risk_rows`` [K, H] rides the host axis
    like ``live``; ``cost_stack`` [P, Z, Z] with host ``cost_seg`` [K]."""
    _resolve_phase2(phase2)
    S, offset = _layout(mesh, avail)
    B, H = demands.shape[0], avail.shape[0]
    dev = avail.device
    n_dyn = n_ticks_dyn
    if n_bound is None:
        # graftcheck: ignore[host-sync] -- a caller without host step bounds pays one read of arrive before the loop, none inside it
        n_bound = span_step_bounds(arrive.cpu().numpy(), n_dyn)
    a, restore = _apply_live(_shard(avail, S), _shard(live, S))
    hz, base = _shard(host_zone, S), _shard(base_task_counts, S)
    arrive = arrive.long()
    iota_b = torch.arange(B, device=dev)
    if bucket_id is not None:
        bucket_id = bucket_id.long()
    i32 = dict(dtype=torch.int32, device=dev)
    state = (torch.zeros((), dtype=torch.bool, device=dev),  # done
             torch.full((B,), -1, dtype=torch.int64, device=dev),  # stackpos
             torch.zeros((), dtype=torch.int64, device=dev),  # n_stack
             a, torch.zeros((S, H // S), **i32))  # avail, cum
    out = (torch.full((n_ticks, B), -1, **i32), torch.zeros((n_ticks,), **i32),
           torch.zeros((n_ticks,), **i32), torch.zeros((), **i32))
    ahead = _cohort_ahead(n_bound, n_dyn)

    def place(k, avail, cum, order, dem_p, valid_p):
        risk_k = None if risk_rows is None else _shard(risk_rows[k], S)
        if policy == "opportunistic":
            return _opportunistic_sharded_pass(
                avail, dem_p, valid_p, uniforms[k], offset, risk_k,
                n_bound=n_bound[k])
        if policy == "first-fit":
            return _first_fit_sharded_pass(
                avail, dem_p, valid_p, strict, offset, risk_k,
                n_bound=n_bound[k])
        if policy == "best-fit":
            return _best_fit_sharded_pass(avail, dem_p, valid_p, offset,
                                          risk_k, n_bound=n_bound[k])
        if policy != "cost-aware":
            raise ValueError(f"unknown span policy {policy!r}")
        ca = _cost_aware_stream(
            avail, cum, order, dem_p, valid_p, bucket_id, anchor_zone,
            _tick_cost(cost_zz, cost_stack, cost_seg, k), bw_zz, hz, base,
            iota_b)
        return _cost_aware_sharded_pass(*ca, offset, bin_pack, sort_hosts,
                                        host_decay, risk_k)

    for k in range(n_dyn):
        state = _span_tick(k, state, out, ~state[0], not ahead[k], place,
                           policy, decreasing, sort_tasks, demands, arrive,
                           sort_norm, bucket_id, iota_b, offset=offset)
    _done, stackpos, n_stack, a, _cum = state
    return SpanResult(*out, n_stack.to(torch.int32), stackpos.to(torch.int32),
                      restore(a).reshape(H, avail.shape[1]))


def sharded_batched_tick_run(
    mesh,
    avail,
    demands,
    arrive,
    n_ticks_dyn,
    *,
    policy: str,
    n_ticks: int,
    n_bound: Optional[Sequence[Sequence[int]]] = None,
    uniforms=None,
    sort_norm=None,
    anchor_zone=None,
    bucket_id=None,
    cost_zz=None,
    bw_zz=None,
    host_zone=None,
    base_task_counts=None,
    totals=None,
    live=None,
    risk_rows=None,
    cost_stack=None,
    cost_seg=None,
    strict: bool = False,
    decreasing: bool = False,
    bin_pack: str = "first-fit",
    sort_tasks: bool = False,
    sort_hosts: bool = True,
    host_decay: bool = False,
    phase2="auto",
) -> SpanResult:
    """[G]-batched :func:`sharded_fused_tick_run`: G coalesced fused
    spans on the 2-D ``replica × host`` mesh.  Every operand carries a
    leading ``[G]`` run axis (``avail`` [G, H, 4], ``risk_rows`` [G, K,
    H], ``cost_seg`` [G, K] host ints, …); row ``g`` of the result is
    :func:`sharded_fused_tick_run` on row ``g`` of every operand.

    The ragged contract (``pivot_tpu/ops/shard.py:1571-1581``):
    ``n_ticks_dyn`` is a ``[G]`` operand of host horizons and ``n_bound``
    each row's host step bounds (:func:`tickloop.span_step_bounds`; None
    reads ``arrive`` to the host once), so each row walks its own
    horizon and bounds; the static ``n_ticks`` is the shared K bucket,
    and the padded K and B extents of a row stay inert."""
    _resolve_phase2(phase2)
    _check_host_axis(avail.shape[1], mesh)
    _check_g_axis(mesh, avail.shape[0])
    if torch.is_tensor(n_ticks_dyn):
        # graftcheck: ignore[host-sync] -- the rows' horizons, read before any step loop
        n_ticks_dyn = n_ticks_dyn.cpu().numpy()
    # graftcheck: ignore[host-sync] -- the rows' horizons are host ints, read before the loop
    n_dyn = [int(x) for x in np.asarray(n_ticks_dyn).reshape(-1)]
    if n_bound is None:
        # graftcheck: ignore[host-sync] -- a caller without host step bounds pays one read of arrive before the loop, none inside it
        arr_host = arrive.cpu().numpy()
        n_bound = [span_step_bounds(arr_host[g], nd)
                   for g, nd in enumerate(n_dyn)]
    static = dict(policy=policy, n_ticks=n_ticks, strict=strict,
                  decreasing=decreasing, bin_pack=bin_pack,
                  sort_tasks=sort_tasks, sort_hosts=sort_hosts,
                  host_decay=host_decay, phase2=phase2)
    operands = dict(uniforms=uniforms, sort_norm=sort_norm,
                    anchor_zone=anchor_zone, bucket_id=bucket_id,
                    cost_zz=cost_zz, bw_zz=bw_zz, host_zone=host_zone,
                    base_task_counts=base_task_counts, totals=totals,
                    live=live, risk_rows=risk_rows, cost_stack=cost_stack,
                    cost_seg=cost_seg)
    return _stack_spans([
        sharded_fused_tick_run(
            mesh, avail[g], demands[g], arrive[g], nd, n_bound=n_bound[g],
            **static, **{k: _row(v, g) for k, v in operands.items()})
        for g, nd in enumerate(n_dyn)
    ])


# ---------------------------------------------------------------------------
# Sharded resident span driver (the ``tickloop.resident_span_run`` twin)
# ---------------------------------------------------------------------------


def _set_rows_local(x, local, rows):
    """Each shard's edit of its own block: ``x`` [H, ...] viewed as
    ``[S, H/S, ...]``, ``local`` [S, E] the edit rows' local indices
    (H/S where the row is foreign to the shard or a pad), ``rows`` [E,
    ...] the replacement rows.  Out-of-block entries land in a scratch
    row per shard that is cut away."""
    S, E = local.shape
    Hl = x.shape[0] // S
    tail = tuple(x.shape[1:])
    ext = torch.cat([x.reshape((S, Hl) + tail),
                     x.new_zeros((S, 1) + tail)], dim=1)
    flat = (torch.arange(S, device=x.device)[:, None] * (Hl + 1)
            + local).reshape(-1)
    ext.view((S * (Hl + 1),) + tail).index_copy_(
        0, flat, rows.to(x.dtype).expand((S,) + tuple(rows.shape))
        .reshape((S * E,) + tail))
    return ext[:, :Hl].reshape(x.shape)


def sharded_resident_carry_init(mesh, avail, counts=None,
                                live=None) -> ResidentCarry:
    """A :class:`ResidentCarry` for the host-sharded resident path,
    copied from host (or device) state onto the mesh's device — the one
    full ``[H]`` staging of the path.  The tensors keep the flat ``[H,
    ...]`` layout (module docstring)."""
    _check_host_axis(avail.shape[0], mesh)
    return resident_carry_init(avail, counts, live, device=mesh_device(mesh))


def sharded_resident_span_run(
    mesh,
    carry: ResidentCarry,
    demands,
    arrive,
    n_ticks_dyn: int,
    *,
    policy: str,
    n_ticks: int,
    n_bound: Optional[Sequence[int]] = None,
    edit_idx=None,
    edit_avail=None,
    edit_counts=None,
    edit_live=None,
    uniforms=None,
    sort_norm=None,
    anchor_zone=None,
    bucket_id=None,
    cost_zz=None,
    bw_zz=None,
    host_zone=None,
    totals=None,
    risk_table=None,
    risk_seg=None,
    cost_stack=None,
    cost_seg=None,
    strict: bool = False,
    decreasing: bool = False,
    bin_pack: str = "first-fit",
    sort_tasks: bool = False,
    sort_hosts: bool = True,
    host_decay: bool = False,
    phase2="auto",
):
    """Host-sharded :func:`tickloop.resident_span_run` — the same delta
    contract and ``(SpanResult, ResidentCarry)`` return
    (``pivot_tpu/ops/shard.py:1794-1850``).  ``edit_idx`` holds GLOBAL
    host indices (pad entries = H): each shard projects them into its
    own block and drops foreign and pad rows.  The risk rows are
    gathered per shard from the once-staged ``[P, H]`` ``risk_table``
    by the span's ``risk_seg`` row; after the span each shard folds the
    placements' histogram into its counts.  ``carry`` is consumed.  The
    result equals :func:`sharded_fused_tick_run` on the post-edit state,
    and so :func:`tickloop.resident_span_run` bit for bit."""
    _resolve_phase2(phase2)
    S, offset = _layout(mesh, carry.avail)
    H = carry.avail.shape[0]
    Hl = H // S
    avail, counts, live = carry
    if edit_idx is not None:
        local = edit_idx.long()[None, :] - offset[:, None]       # [S, E]
        local = torch.where((local >= 0) & (local < Hl), local, Hl)
        avail = _set_rows_local(avail, local, edit_avail)
        counts = _set_rows_local(counts, local, edit_counts)
        live = _set_rows_local(live, local, edit_live)
    else:
        live = live.clone()
    risk_rows = None
    if risk_seg is not None:
        blocks = risk_table.reshape(risk_table.shape[0], S, Hl)
        risk_rows = blocks.index_select(0, risk_seg.long()).reshape(-1, H)
    res = sharded_fused_tick_run(
        mesh, avail, demands, arrive, n_ticks_dyn, policy=policy,
        n_ticks=n_ticks, n_bound=n_bound, uniforms=uniforms,
        sort_norm=sort_norm, anchor_zone=anchor_zone, bucket_id=bucket_id,
        cost_zz=cost_zz, bw_zz=bw_zz, host_zone=host_zone,
        base_task_counts=counts, totals=totals, live=live,
        risk_rows=risk_rows, cost_stack=cost_stack, cost_seg=cost_seg,
        strict=strict, decreasing=decreasing, bin_pack=bin_pack,
        sort_tasks=sort_tasks, sort_hosts=sort_hosts, host_decay=host_decay,
        phase2=phase2,
    )
    # Each shard's histogram of the span's placements on its own block.
    p = res.placements.reshape(-1).long()
    local = p[None, :] - offset[:, None]                          # [S, KB]
    mine = (p >= 0)[None, :] & (local >= 0) & (local < Hl)
    # graftcheck: ignore[determinism] -- int32 counts: exact in any order
    hist = torch.zeros((S, Hl + 1), dtype=torch.int32,
                       device=counts.device).scatter_add_(
        1, torch.where(mine, local, Hl), mine.to(torch.int32))[:, :Hl]
    return res, ResidentCarry(res.avail, counts + hist.reshape(H), live)


# ---------------------------------------------------------------------------
# Unsharded form → its host-sharded twin
# ---------------------------------------------------------------------------

#: Unsharded public form → its 1-D host-sharded twin: what a lone
#: request on a 2-D batcher mesh runs.
_SHARDED_TWINS = {
    opportunistic_impl: opportunistic_kernel_sharded,
    first_fit_impl: first_fit_kernel_sharded,
    best_fit_impl: best_fit_kernel_sharded,
    cost_aware_impl: cost_aware_kernel_sharded,
    fused_tick_run: sharded_fused_tick_run,
}

#: Unsharded public form → its [G]-batched 2-D form: what a coalesced
#: flush on a 2-D batcher mesh runs.
_BATCHED_TWINS = {
    opportunistic_impl: opportunistic_kernel_sharded_batched,
    first_fit_impl: first_fit_kernel_sharded_batched,
    best_fit_impl: best_fit_kernel_sharded_batched,
    cost_aware_impl: cost_aware_kernel_sharded_batched,
    fused_tick_run: sharded_batched_tick_run,
}

#: Array-kwarg names that disqualify a dispatch from the sharded forms:
#: the realtime-bandwidth rows are per-tick host state (the sharded
#: Cost-Aware forms raise on them).
UNSHARDABLE_KW = frozenset({"rt_bw_rows", "rt_bw_idx"})


def sharded_twin_of(kernel, arr_kw_keys=(), static_kw=None):
    """The 1-D host-sharded twin of an unsharded public form, or None
    when the form has none (e.g. the ``greedy_place`` wrappers, or a
    span served by them: ``greedy=`` set) or the request carries
    operands the sharded forms reject (:data:`UNSHARDABLE_KW`)."""
    if UNSHARDABLE_KW & set(arr_kw_keys):
        return None
    if static_kw and static_kw.get("greedy") is not None:
        return None
    return _SHARDED_TWINS.get(kernel)


def batched_sharded_call(mesh, kernel, static_kw, n_args, kw_keys):
    """A coalesced batch of ``kernel`` dispatches as its 2-D ``replica ×
    host`` form, or None when ``kernel`` has none
    (``pivot_tpu/ops/shard.py:1911-1933``).  The callable takes the
    batcher's flat columns — the stacked positional arguments first, the
    stacked array keywords in ``kw_keys`` order after."""
    batched = _BATCHED_TWINS.get(kernel)
    if batched is None:
        return None

    def call(*cols):
        return batched(mesh, *cols[:n_args],
                       **dict(zip(kw_keys, cols[n_args:])), **static_kw)

    return call


# ---------------------------------------------------------------------------
# Elastic re-layout (``pivot_tpu/ops/shard.py:1914-2078``; module docstring)
# ---------------------------------------------------------------------------

#: Availability of a dead-sentinel pad host: below any demand (demands
#: are >= 0), so a pad row fails every fit test even before its False
#: live mask excludes it.
DEAD_AVAIL = -1.0


def mesh_shape_ladder(n_devices: int) -> tuple:
    """The declared elastic shapes of an ``n_devices`` launch mesh: its
    divisors, descending (8 → ``(8, 4, 2, 1)``).  A shrink walks down to
    the largest rung the survivors fill, a regrow walks back up."""
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"mesh ladder needs n_devices >= 1, got {n}")
    return tuple(s for s in range(n, 0, -1) if n % s == 0)


def next_ladder_shape(ladder, n_live: int) -> int:
    """The largest rung of ``ladder`` that ``n_live`` surviving devices
    fill — the shrink target after a loss.  Raises when none survives."""
    for s in ladder:
        if s <= n_live:
            return int(s)
    raise ValueError(
        f"no ladder rung <= {n_live} surviving devices (ladder {ladder})"
    )


def elastic_host_extent(H: int, n_shards: int) -> int:
    """The smallest multiple of ``n_shards`` >= ``H``: the padded host
    extent a non-dividing host count re-lays onto."""
    if H < 1 or n_shards < 1:
        raise ValueError(
            f"elastic extent needs H >= 1 and n_shards >= 1, "
            f"got H={H}, n_shards={n_shards}"
        )
    return -(-H // n_shards) * n_shards


def elastic_pad_rows(arr, extent: int, fill):
    """``arr``'s leading host axis padded to ``extent`` with ``fill`` rows
    (``arr`` itself when already there).  numpy in, numpy out."""
    arr = np.asarray(arr)
    H = arr.shape[0]
    if H > extent:
        raise ValueError(f"host axis {H} exceeds elastic extent {extent}")
    if H == extent:
        return arr
    pad = np.full((extent - H,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def elastic_trim_rows(arr, H: int):
    """The first ``H`` host rows of a padded array (the inverse of
    :func:`elastic_pad_rows`)."""
    arr = np.asarray(arr)
    if arr.shape[0] < H:
        raise ValueError(
            f"cannot trim to H={H}: array has {arr.shape[0]} host rows"
        )
    return arr[:H]


def elastic_pad_state(H: int, n_shards: int, *, avail=None, counts=None,
                      live=None, risk_rows=None, host_zone=None,
                      base_task_counts=None):
    """Global host-state arrays (true host count ``H``) re-laid onto an
    ``n_shards`` mesh: ``(extent, dict)`` with every array given padded to
    the elastic extent — :data:`DEAD_AVAIL` availability, False live
    mask, zero counts, risk and zone.  ``live`` defaults to all-True over
    ``H`` when padding occurs and ``avail`` is given: a None live mask
    means "every host selectable", pad rows included.  ``risk_rows`` pads
    its TRAILING axis (the ``[K, H]`` layout)."""
    extent = elastic_host_extent(H, n_shards)
    out = {}
    if avail is not None:
        avail = np.asarray(avail)
        if avail.shape[0] != H:
            raise ValueError(
                f"avail has {avail.shape[0]} host rows, expected H={H}"
            )
        out["avail"] = elastic_pad_rows(avail, extent, DEAD_AVAIL)
        if live is None and extent != H:
            live = np.ones((H,), bool)
    if counts is not None:
        out["counts"] = elastic_pad_rows(
            np.asarray(counts, np.int32), extent, 0
        )
    if live is not None:
        out["live"] = elastic_pad_rows(np.asarray(live, bool), extent, False)
    if risk_rows is not None:
        risk_rows = np.asarray(risk_rows)
        if risk_rows.shape[-1] != H:
            raise ValueError(
                f"risk_rows trailing axis {risk_rows.shape[-1]} != H={H}"
            )
        pad = extent - H
        if pad:
            widths = [(0, 0)] * (risk_rows.ndim - 1) + [(0, pad)]
            risk_rows = np.pad(risk_rows, widths, constant_values=0.0)
        out["risk_rows"] = risk_rows
    if host_zone is not None:
        out["host_zone"] = elastic_pad_rows(
            np.asarray(host_zone, np.int32), extent, 0
        )
    if base_task_counts is not None:
        out["base_task_counts"] = elastic_pad_rows(
            np.asarray(base_task_counts, np.int32), extent, 0
        )
    return extent, out


def elastic_fold_carry(carry: ResidentCarry, H: int, mesh) -> ResidentCarry:
    """A resident span carry re-laid onto ``mesh`` (the unsharded layout
    on the carry's device when ``mesh`` is None): one device→host export,
    the old rung's pad rows trimmed back to the true host count ``H``,
    padded to the new rung's extent, copied back as a new carry.  The
    result equals the source on the true host rows: a fold moves state,
    it changes no decision.  ``carry`` must be a pending carry or a clone
    (``tickloop.resident_carry_export``)."""
    snap = resident_carry_export(carry)
    trimmed = {k: elastic_trim_rows(snap[k], H)
               for k in ("avail", "counts", "live")}
    if mesh is None:
        return resident_carry_init(
            trimmed["avail"], counts=trimmed["counts"],
            live=trimmed["live"], device=carry.avail.device)
    _, padded = elastic_pad_state(H, host_axis_size(mesh), **trimmed)
    return sharded_resident_carry_init(
        mesh, padded["avail"], counts=padded["counts"], live=padded["live"]
    )
