"""Placement policies: opportunistic, first-fit, best-fit, cost-aware.

Each policy supports two CPU modes sharing the :class:`TickContext` feed:

  * ``mode='naive'`` — reference-faithful per-task/per-host Python loops,
    the measured performance baseline (mirrors ``scheduler/opportunistic.py``,
    ``scheduler/vbp.py``, ``scheduler/cost_aware.py`` in the reference).
  * ``mode='numpy'`` — vectorized over hosts; bit-identical placements to
    the TPU kernels in ``pivot_tpu_torch.ops`` (which consume the same Philox
    uniform stream and the same tie-breaking rules).

Deliberate, documented fixes of reference quirks (SURVEY.md §4):
  * ``decreasing`` is a real boolean (the reference's ``str(False)`` is
    always truthy, ``scheduler/vbp.py:9,35`` — so its first-fit *always*
    sorted; experiments pass ``decreasing=True`` anyway).
  * Best-fit keeps the reference's strict ``>`` fit test
    (``scheduler/vbp.py:45``) and cost-aware first-fit its strict ``>``
    (``scheduler/cost_aware.py:124``) — both preserved since they shape
    behavior; ties in argmin resolve to the lowest host index (the
    reference breaks ties by uuid string order, which is unreproducible).
  * Best-fit + ``host_decay`` works here (the reference's
    ``_best_fit`` dereferences an uninitialized ``None`` counter,
    ``scheduler/cost_aware.py:26,67``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

from pivot_tpu_torch.sched import Policy, TickContext
from pivot_tpu_torch.sched.rand import keyed_storage_index, tick_uniforms
from pivot_tpu_torch.search.weights import PolicyWeights


def resolve_root_anchor(ctx: TickContext, app, n_storage: int) -> int:
    """Storage index anchoring ``app``'s root task groups — the keyed
    draw (:func:`pivot_tpu_torch.sched.rand.keyed_storage_index`) shared by
    every policy backend AND the ensemble estimator, keyed on the app's
    submission ordinal.  An app that never went through
    ``GlobalScheduler.submit`` (direct-policy unit harnesses) keys as
    ordinal 0."""
    seed = ctx.scheduler.seed or 0
    ordinal = getattr(app, "_submit_ordinal", 0)
    return int(keyed_storage_index(seed, ordinal, n_storage))

__all__ = [
    "OpportunisticPolicy",
    "FirstFitPolicy",
    "BestFitPolicy",
    "CostAwarePolicy",
    "fold_quarantine",
    "resolve_risk",
    "resolve_weights",
]


def resolve_weights(
    weights: Optional[PolicyWeights],
    risk_weight: float = 0.0,
    rework_cost: float = 1.0,
) -> PolicyWeights:
    """Fold a policy constructor's scoring knobs into the ONE typed
    vector (round 16, ``pivot_tpu/search/weights.py``).

    Every backend now carries ``self.weights`` as the source of truth;
    the legacy ``risk_weight`` / ``rework_cost`` constructor knobs stay
    accepted (they populate the vector's risk dims) but may not be
    combined with an explicit ``weights=`` — two sources for one knob
    is exactly the scatter this refactor removes.  The score exponents
    (``w_cost``/``w_bw``/``w_norm``) parameterize the cost-aware score
    terms; policies whose selections have no such terms (first-fit's
    index order, best-fit's residual norm, the opportunistic draw) are
    exponent-invariant by construction and consume only the risk dims.
    """
    if weights is None:
        return PolicyWeights(
            risk_weight=risk_weight, rework_cost=rework_cost
        ).validate()
    if not isinstance(weights, PolicyWeights):
        weights = PolicyWeights.from_array(np.asarray(weights, dtype=float))
    if (risk_weight, rework_cost) != (0.0, 1.0):
        raise ValueError(
            "pass weights= OR the legacy risk_weight/rework_cost knobs, "
            "not both — the typed vector is the one source of truth"
        )
    return weights.validate()


def resolve_risk(ctx: TickContext, risk_weight: float,
                 rework_cost: float) -> Optional[np.ndarray]:
    """The tick's ``[H]`` risk penalty vector — ``risk_weight × hazard ×
    rework_cost`` per host, where ``hazard`` is the spot-market's per-host
    preemption rate at the tick instant (``TickContext.hazard_vector``)
    and ``rework_cost`` prices the expected loss of a placement on an
    evicted host (lost compute-seconds × restart overhead, a scalar knob).

    Returns ``None`` — the exact-bit-parity path, no risk ops traced or
    evaluated anywhere downstream — when the weight is zero, there is no
    market environment, or every hazard is zero.  One resolver shared by
    the CPU policies and the device wrappers, so the two sides can never
    disagree about when the risk term engages.

    How the vector is consumed (the shared cross-backend rule, mirrored
    exactly by ``ops/kernels.py``):

      * score-based selections (best-fit residual, cost-aware scores)
        add it: ``score += risk``;
      * index-ordered selections (plain first-fit; cost-aware first-fit
        with ``sort_hosts=False``) replace the index order with the
        lexicographic ``(risk, host index)`` order — the masked-argmin
        tie rule gives exactly this for a score of ``risk``;
      * the opportunistic random choice restricts to the minimum-risk
        tier of fitting hosts (same Philox draw, narrower support).
    """
    if not risk_weight:
        return None
    hazard = ctx.hazard_vector
    if hazard is None:
        return None
    risk = risk_weight * rework_cost * hazard
    if not risk.any():
        return None
    return risk


def fold_quarantine(ctx: TickContext) -> None:
    """Fold the tick's quarantine/drain mask into the availability
    working copy: masked hosts get the −1 sentinel — the same mechanism
    that already excludes DOWN hosts from every fit test (demands are
    ≥ 0, so no strict or non-strict comparison can select a −1 row,
    zero-demand tasks included).  Reusing the sentinel keeps every
    naive/numpy inner loop and incremental fast path untouched, and is
    placement-identical to the device kernels' fused ``live`` mask: the
    two produce the same fit masks, and scores of *fitting* (live,
    untouched) hosts are computed from identical rows.  No-op when every
    host is live."""
    live = ctx.live_mask
    if live is not None:
        ctx.avail[~live] = -1.0


def _norms(mat: np.ndarray) -> np.ndarray:
    return np.sqrt(np.sum(mat * mat, axis=-1))


_NO_EXTRA = 0  # broadcast-zero "no placements yet" for frozen decay


def _same_demand(d, prev_d) -> bool:
    """Scalar 4-component equality for the identical-demand run fast paths
    (``prev_d`` may be None).  One definition so the strict/non-strict fit
    helpers below stay visually distinct from it."""
    return prev_d is not None and (
        d[0] == prev_d[0]
        and d[1] == prev_d[1]
        and d[2] == prev_d[2]
        and d[3] == prev_d[3]
    )


def _row_fits(row, d) -> bool:
    """Non-strict scalar fit (FirstFit/Opportunistic mask semantics)."""
    return row[0] >= d[0] and row[1] >= d[1] and row[2] >= d[2] and row[3] >= d[3]


def _row_fits_strict(row, d) -> bool:
    """Strict scalar fit (BestFit/CostAware mask semantics, ref :124/:45)."""
    return row[0] > d[0] and row[1] > d[1] and row[2] > d[2] and row[3] > d[3]




def _sort_decreasing(demands: np.ndarray, idxs: List[int]) -> List[int]:
    """Stable sort of task indices by descending demand L2 norm."""
    norms = _norms(demands[idxs])
    order = np.argsort(-norms, kind="stable")
    return [idxs[i] for i in order]


class OpportunisticPolicy(Policy):
    """Uniformly random choice among fitting hosts (ref opportunistic.py:11-20)."""

    name = "opportunistic"

    def __init__(self, mode: str = "numpy", risk_weight: float = 0.0,
                 rework_cost: float = 1.0,
                 weights: Optional[PolicyWeights] = None):
        assert mode in ("naive", "numpy")
        self.mode = mode
        self.weights = resolve_weights(weights, risk_weight, rework_cost)
        self.risk_weight = self.weights.risk_weight
        self.rework_cost = self.weights.rework_cost

    def place(self, ctx: TickContext) -> np.ndarray:
        fold_quarantine(ctx)
        risk = resolve_risk(ctx, self.risk_weight, self.rework_cost)
        placements = np.full(ctx.n_tasks, -1, dtype=np.int64)
        avail, demands = ctx.avail, ctx.demands
        if self.mode == "naive":
            rnd = ctx.scheduler.randomizer
            for i in range(ctx.n_tasks):
                fits = [
                    h for h in range(ctx.n_hosts) if np.all(avail[h] >= demands[i])
                ]
                if fits and risk is not None:
                    # Risk-aware: the random choice narrows to the
                    # minimum-risk tier of fitting hosts (same draw).
                    rmin = min(risk[h] for h in fits)
                    fits = [h for h in fits if risk[h] == rmin]
                if fits:
                    h = int(rnd.choice(fits))
                    avail[h] -= demands[i]
                    placements[i] = h
        else:
            u = tick_uniforms(ctx.scheduler.seed or 0, ctx.tick_seq, ctx.n_tasks)
            # Incremental fit mask over runs of identical demand vectors
            # (instances of one group are adjacent in submission order):
            # placing a task only mutates one host row, so only that mask
            # entry can change for the next identical demand.  The risk
            # tier is applied at SELECTION time against the cached mask,
            # so the incremental update stays exact.
            prev_d = None
            mask = None
            for i in range(ctx.n_tasks):
                d = demands[i]
                if not _same_demand(d, prev_d):
                    mask = np.all(avail >= d, axis=1)
                    prev_d = d
                n_fit = int(mask.sum())
                if n_fit:
                    fits = np.nonzero(mask)[0]
                    if risk is not None:
                        r = risk[fits]
                        fits = fits[r == r.min()]
                        n_fit = len(fits)
                    h = int(fits[min(int(u[i] * n_fit), n_fit - 1)])
                    avail[h] -= d
                    row = avail[h]
                    mask[h] = _row_fits(row, d)
                    placements[i] = h
        return placements


class FirstFitPolicy(Policy):
    """First host in cluster order that fits (ref vbp.py:6-29)."""

    name = "first_fit"

    def __init__(self, decreasing: bool = False, mode: str = "numpy",
                 risk_weight: float = 0.0, rework_cost: float = 1.0,
                 weights: Optional[PolicyWeights] = None):
        assert mode in ("naive", "numpy")
        self.decreasing = decreasing
        self.mode = mode
        self.weights = resolve_weights(weights, risk_weight, rework_cost)
        self.risk_weight = self.weights.risk_weight
        self.rework_cost = self.weights.rework_cost

    def place(self, ctx: TickContext) -> np.ndarray:
        fold_quarantine(ctx)
        risk = resolve_risk(ctx, self.risk_weight, self.rework_cost)
        placements = np.full(ctx.n_tasks, -1, dtype=np.int64)
        avail, demands = ctx.avail, ctx.demands
        idxs = list(range(ctx.n_tasks))
        if self.decreasing:
            idxs = _sort_decreasing(demands, idxs)
            ctx.visit_order = idxs  # ref returns the sorted list (vbp.py:17)
        if risk is not None:
            # Risk-aware first fit: the host visit order becomes the
            # lexicographic (risk, index) order — argmin over fits of the
            # risk vector, ties to the lowest index (resolve_risk's
            # shared rule; identical to the kernels' masked argmin).
            for i in idxs:
                d = demands[i]
                mask = np.all(avail >= d, axis=1)
                if not mask.any():
                    continue
                h = int(np.argmin(np.where(mask, risk, np.inf)))
                avail[h] -= d
                placements[i] = h
            return placements
        if self.mode == "naive":
            for i in idxs:
                for h in range(ctx.n_hosts):
                    if np.all(avail[h] >= demands[i]):
                        avail[h] -= demands[i]
                        placements[i] = h
                        break
        else:
            # Scan-resume over runs of identical demands (see CostAware
            # ``_first_fit``): rows before the previous hit were rejected
            # against the same demand and are unmutated.
            prev_d = None
            start = 0
            for i in idxs:
                d = demands[i]
                if not _same_demand(d, prev_d):
                    start = 0
                    prev_d = d
                if start < 0:
                    continue
                row = avail[start]
                if _row_fits(row, d):
                    h = start
                else:
                    mask = np.all(avail[start:] >= d, axis=1)
                    if not mask.any():
                        start = -1
                        continue
                    h = start + int(np.argmax(mask))
                avail[h] -= d
                placements[i] = h
                start = h
        return placements


class BestFitPolicy(Policy):
    """Min residual-L2 host among strict fits (ref vbp.py:32-49)."""

    name = "best_fit"

    def __init__(self, decreasing: bool = False, mode: str = "numpy",
                 risk_weight: float = 0.0, rework_cost: float = 1.0,
                 weights: Optional[PolicyWeights] = None):
        assert mode in ("naive", "numpy")
        self.decreasing = decreasing
        self.mode = mode
        self.weights = resolve_weights(weights, risk_weight, rework_cost)
        self.risk_weight = self.weights.risk_weight
        self.rework_cost = self.weights.rework_cost

    def place(self, ctx: TickContext) -> np.ndarray:
        fold_quarantine(ctx)
        risk = resolve_risk(ctx, self.risk_weight, self.rework_cost)
        placements = np.full(ctx.n_tasks, -1, dtype=np.int64)
        avail, demands = ctx.avail, ctx.demands
        idxs = list(range(ctx.n_tasks))
        if self.decreasing:
            idxs = _sort_decreasing(demands, idxs)
            ctx.visit_order = idxs  # ref returns the sorted list (vbp.py:42)
        if self.mode == "naive":
            for i in idxs:
                best, best_score = -1, np.inf
                for h in range(ctx.n_hosts):
                    if np.all(avail[h] > demands[i]):  # strict, ref :45
                        score = float(np.linalg.norm(avail[h] - demands[i]))
                        if risk is not None:
                            score = score + risk[h]
                        if score < best_score:
                            best, best_score = h, score
                if best >= 0:
                    avail[best] -= demands[i]
                    placements[i] = best
        else:
            # Incremental residual vector over runs of identical demands:
            # placing mutates one host row, so one residual entry updates.
            prev_d = None
            residual = None
            for i in idxs:
                d = demands[i]
                if not _same_demand(d, prev_d):
                    mask = np.all(avail > d, axis=1)  # strict, ref :45
                    residual = _norms(avail - d)
                    if risk is not None:
                        residual = residual + risk  # score += risk term
                    residual[~mask] = np.inf
                    prev_d = d
                h = int(np.argmin(residual))  # lowest index on ties
                if residual[h] == np.inf:
                    continue
                avail[h] -= d
                row = avail[h]
                if _row_fits_strict(row, d):
                    r = row - d  # same ops as _norms(avail - d) row-wise
                    residual[h] = np.sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2] + r[3] * r[3])
                    if risk is not None:
                        residual[h] = residual[h] + risk[h]
                else:
                    residual[h] = np.inf
                placements[i] = h
        return placements


class CostAwarePolicy(Policy):
    """Data-locality / egress-cost-aware placement — the PIVOT policy
    (ref cost_aware.py:11-127).

    Tasks are grouped by *anchor*: the zone-local storage at the majority
    predecessor placement locality (``_group_tasks``, ref ``:45-58``); root
    tasks anchor to a random storage per application.  Within a group,
    hosts are scored by round-trip egress cost × crowding decay /
    (residual-capacity norm × round-trip bandwidth) and greedily
    first-fit in score order (or best-fit per task).
    """

    name = "cost_aware"

    def __init__(
        self,
        bin_pack: str = "first-fit",
        sort_tasks: bool = False,
        sort_hosts: bool = False,
        realtime_bw: bool = False,
        host_decay: bool = False,
        mode: str = "numpy",
        risk_weight: float = 0.0,
        rework_cost: float = 1.0,
        weights: Optional[PolicyWeights] = None,
    ):
        assert bin_pack in ("first-fit", "best-fit")
        assert mode in ("naive", "numpy")
        self.bin_pack = bin_pack
        self.sort_tasks = sort_tasks
        self.sort_hosts = sort_hosts
        self.realtime_bw = realtime_bw
        self.host_decay = host_decay
        self.mode = mode
        self.weights = resolve_weights(weights, risk_weight, rework_cost)
        self.risk_weight = self.weights.risk_weight
        self.rework_cost = self.weights.rework_cost
        #: (w_cost, w_bw, w_norm) when any score exponent departs from
        #: the reference shape, else None — the None branch keeps the
        #: exact unparameterized score expressions below (no ``pow``),
        #: which is the default vector's bit-parity contract.
        self._score_exp = self.weights.score_exponents()

    def apply_weights(self, weights) -> None:
        super().apply_weights(weights)
        self._score_exp = self.weights.score_exponents()

    # -- grouping --------------------------------------------------------
    def group_tasks(
        self, ctx: TickContext
    ) -> "OrderedDict[object, List[int]]":
        """Anchor → task indices, in first-seen order (ref ``:45-58``).

        Keys are Storage nodes, or the Application for root task groups
        (resolved to a random storage at placement time).
        """
        cluster = ctx.cluster
        groups: "OrderedDict[object, List[int]]" = OrderedDict()
        for i, task in enumerate(ctx.tasks):
            group = task.group
            # Anchor memo: once a group is ready its predecessors are all
            # finished with immutable placements, so the majority vote is a
            # fixed function — compute it once per group, not per instance
            # per tick (the reference recomputes it for every task, every
            # tick: cost_aware.py:45-58).
            anchor = group.__dict__.get("_anchor_memo")
            if anchor is None:
                app = group.application
                pred_tasks = [
                    t
                    for p in app.get_predecessors(group.id)
                    for t in p.tasks
                    if t.placement is not None
                ]
                if pred_tasks:
                    # Majority placement; ties resolve to first occurrence,
                    # matching Counter insertion order in the reference.
                    counts: "OrderedDict[str, int]" = OrderedDict()
                    for t in pred_tasks:
                        counts[t.placement] = counts.get(t.placement, 0) + 1
                    majority = max(counts.items(), key=lambda kv: kv[1])[0]
                    locality = cluster.get_host(majority).locality
                    anchor = cluster.get_storage_by_locality(locality)
                else:
                    anchor = app
                group.__dict__["_anchor_memo"] = anchor
            groups.setdefault(anchor, []).append(i)
        return groups

    # -- scoring ---------------------------------------------------------
    def _roundtrip_vectors(
        self, ctx: TickContext, anchor
    ) -> Tuple[np.ndarray, np.ndarray]:
        """([H] roundtrip $ cost, [H] roundtrip bw) anchor↔host.

        The cost matrix comes from ``ctx.cost_matrix`` — the market's
        time-varying ``[Z, Z]`` slice when a spot-market environment is
        attached, the static ``meta.cost_matrix`` object itself (same
        ndarray, bit-identical scores) otherwise."""
        meta = ctx.meta
        az = meta.zone_index[anchor.locality]
        hz = ctx.host_zones
        cm = ctx.cost_matrix
        cost_rt = cm[az, hz] + cm[hz, az]
        if self.realtime_bw:
            bw_rt = np.array(
                [
                    ctx.cluster.get_route(anchor.id, h.id).realtime_bw
                    + ctx.cluster.get_route(h.id, anchor.id).realtime_bw
                    for h in ctx.hosts
                ]
            )
        else:
            bw_rt = meta.bw_matrix[az, hz] + meta.bw_matrix[hz, az]
        return cost_rt, bw_rt

    def _decay(self, ctx: TickContext, extra_tasks: np.ndarray) -> np.ndarray:
        """[H] crowding decay factor (ref ``:81,115``)."""
        if not self.host_decay:
            return np.ones(ctx.n_hosts)
        return np.maximum(ctx.host_task_counts + extra_tasks, 1).astype(np.float64)

    # -- placement -------------------------------------------------------
    def place(self, ctx: TickContext) -> np.ndarray:
        fold_quarantine(ctx)
        risk = resolve_risk(ctx, self.risk_weight, self.rework_cost)
        placements = np.full(ctx.n_tasks, -1, dtype=np.int64)
        avail, demands = ctx.avail, ctx.demands
        storage = ctx.cluster.storage
        extra_tasks = np.zeros(ctx.n_hosts, dtype=np.int32)  # placed this tick
        for anchor, idxs in self.group_tasks(ctx).items():
            if not hasattr(anchor, "locality"):  # root group: keyed storage
                anchor = storage[resolve_root_anchor(ctx, anchor, len(storage))]
            if self.sort_tasks:
                idxs = _sort_decreasing(demands, idxs)
            cost_rt, bw_rt = self._roundtrip_vectors(ctx, anchor)
            if self.bin_pack == "first-fit":
                self._first_fit(
                    ctx, idxs, avail, demands, cost_rt, bw_rt, placements,
                    risk,
                )
            else:
                self._best_fit(
                    ctx, idxs, avail, demands, cost_rt, bw_rt, extra_tasks,
                    placements, risk,
                )
        return placements

    def _first_fit(self, ctx, idxs, avail, demands, cost_rt, bw_rt,
                   placements, risk=None) -> None:
        """Hosts sorted once per group by score, then greedy first strict fit
        (ref ``:99-127``; scores use availability at sort time).

        The decay factor is the host task count at *tick start* — the
        reference reads ``len(h.tasks)``, which cannot change during a
        synchronous schedule() call (``cost_aware.py:115``) — unlike
        best-fit's live within-tick counter.
        """
        if self.sort_hosts:
            with np.errstate(divide="ignore"):
                if self._score_exp is None:
                    score = (
                        cost_rt
                        * self._decay(ctx, _NO_EXTRA)
                        / (_norms(avail) * bw_rt)
                    )
                else:
                    # Searchable exponents (PolicyWeights): pow form,
                    # engaged only off the default vector.
                    wc, wb, wn = self._score_exp
                    score = (
                        cost_rt ** wc
                        * self._decay(ctx, _NO_EXTRA)
                        / (_norms(avail) ** wn * bw_rt ** wb)
                    )
            if risk is not None:
                score = score + risk  # the shared score += risk rule
            order = np.argsort(score, kind="stable")
        elif risk is not None:
            # sort_hosts=False is an index-ordered selection: the risk
            # term replaces it with the lexicographic (risk, index) order
            # (resolve_risk's shared rule — the kernels' masked argmin
            # over a score of ``risk`` gives exactly this).
            order = np.argsort(risk, kind="stable")
        else:
            order = np.arange(ctx.n_hosts)
        if self.mode == "naive":
            for i in idxs:
                for h in order:
                    if np.all(avail[h] > demands[i]):  # strict, ref :124
                        avail[h] -= demands[i]
                        placements[i] = h
                        break
        else:
            # Gather once; placing at sorted position p only mutates row p,
            # so the working copy stays exact with one row write per task.
            avail_sorted = avail[order]
            # Start-pointer for runs of identical demand vectors (instances
            # of one task group, adjacent after the stable decreasing
            # sort): rows before the previous hit were rejected against the
            # same demand and have not changed since, so the scan resumes
            # there — bit-identical placements, O(remaining) per task.
            prev_d = None
            start = 0
            for i in idxs:
                d = demands[i]
                if not _same_demand(d, prev_d):
                    start = 0
                    prev_d = d
                if start < 0:  # previous identical demand found no fit
                    continue
                # Constant-time fast path: the run's previous hit row still
                # fits — rows before it were rejected against this same
                # demand and are unmutated, so it IS the first fit.
                row = avail_sorted[start]
                if _row_fits_strict(row, d):
                    p = start
                else:
                    mask = (avail_sorted[start:] > d).all(axis=1)
                    if not mask.any():
                        start = -1
                        continue
                    p = start + int(np.argmax(mask))
                h = int(order[p])
                avail[h] -= d
                avail_sorted[p] = avail[h]
                placements[i] = h
                start = p

    def _best_fit(
        self, ctx, idxs, avail, demands, cost_rt, bw_rt, extra_tasks,
        placements, risk=None,
    ) -> None:
        """Per-task min of cost × residual × decay / bw among non-strict fits
        (ref ``:63-97``); ``+ risk`` per host when the risk term engages."""
        if self.mode == "naive":
            for i in idxs:
                best, best_score = -1, np.inf
                for h in range(ctx.n_hosts):
                    if not np.all(avail[h] >= demands[i]):  # non-strict, ref :87
                        continue
                    r = float(np.linalg.norm(avail[h] - demands[i]))
                    decay = (
                        max(int(ctx.host_task_counts[h]) + int(extra_tasks[h]), 1)
                        if self.host_decay
                        else 1.0
                    )
                    if self._score_exp is None:
                        score = cost_rt[h] * r * decay / bw_rt[h]
                    else:
                        wc, wb, wn = self._score_exp
                        score = (
                            cost_rt[h] ** wc * r ** wn * decay
                            / bw_rt[h] ** wb
                        )
                    if risk is not None:
                        score = score + risk[h]
                    if score < best_score:
                        best, best_score = h, score
                if best >= 0:
                    avail[best] -= demands[i]
                    placements[i] = best
                    extra_tasks[best] += 1
        else:
            for i in idxs:
                mask = np.all(avail >= demands[i], axis=1)  # non-strict, ref :87
                if not mask.any():
                    continue
                residual = _norms(avail - demands[i])
                with np.errstate(divide="ignore", invalid="ignore"):
                    if self._score_exp is None:
                        score = (
                            cost_rt * residual
                            * self._decay(ctx, extra_tasks) / bw_rt
                        )
                    else:
                        wc, wb, wn = self._score_exp
                        score = (
                            cost_rt ** wc * residual ** wn
                            * self._decay(ctx, extra_tasks) / bw_rt ** wb
                        )
                if risk is not None:
                    score = score + risk  # the shared score += risk rule
                score[~mask] = np.inf
                h = int(np.argmin(score))
                avail[h] -= demands[i]
                placements[i] = h
                extra_tasks[h] += 1
