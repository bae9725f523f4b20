"""Exact small-instance placement solver — the search's regret reference.

Port of ``pivot_tpu/search/oracle.py``, a numpy copy.  One call differs:
:func:`instance_from_wave` takes the port's torch workload and topology
(on any device) and reads the pull-sample table through the port's
``parallel/ensemble/bill.py::_sampling_table``, brought to float64 numpy
on the host.

Every headline of the policy-search subsystem before this module is a
*delta between heuristics* ("learned beats hand-tuned").  The oracle
turns that into **regret against an optimum**: for instances small
enough to solve exactly, branch-and-bound over the integer program

    minimize    Σ_placed  egress(t, zone(h_t)) + risk_coeff · hazard[h_t]
                + penalty · #unplaced
    subject to  Σ_{t on h} demand_t ≤ avail_h   (per host, 4 resources)

— the same fit + egress + risk objective the simulator meters, over a
single decision wave.  :func:`placement_objective` IS the objective
(one definition, used by the solver, the brute-force referee, and the
regret report), and :func:`instance_from_wave` derives the egress
coefficients from the ensemble's own sampled-pull bill
(``parallel.ensemble.bill._sampled_egress``'s expected-cost-per-pull
formula), so the oracle's dollars are the estimator meter's dollars
for the same placement — ``tests/test_oracle.py`` pins both the
optimality (brute-force cross-check) and the no-objective-drift match.

Scope, stated honestly: the oracle solves ONE wave's placement (ready
tasks against a frozen availability snapshot) — the greedy policies'
actual decision point — not the full multi-tick scheduling game; and
its ``risk_coeff × hazard`` term prices eviction exposure exactly like
``policies.resolve_risk`` does at a tick, not the realized rework of a
specific fault draw.  Branch-and-bound is exact within that scope: it
either returns the proven optimum or raises when the node budget is
exhausted (it never silently degrades to a heuristic).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional, Tuple

import numpy as np

from pivot_tpu_torch.search.weights import DEFAULT_WEIGHTS, PolicyWeights

__all__ = [
    "OracleInstance",
    "brute_force",
    "greedy_placement",
    "instance_from_wave",
    "placement_objective",
    "regret",
    "solve_instance",
]


class OracleInstance(NamedTuple):
    """One placement decision wave, objective-ready.

    ``egress_tz[t, z]`` is the expected egress dollars of landing task
    ``t`` in zone ``z`` (built by :func:`instance_from_wave` from the
    ensemble's sampled-pull bill, or synthetically in tests);
    ``anchor_zone`` / ``cost_zz`` / ``bw_zz`` additionally feed the
    greedy heuristic arm's cost-aware score.  ``risk_coeff`` is
    ``risk_weight × rework_cost`` and ``hazard`` the per-host rate —
    the PR-9 risk term at this wave's instant.
    """

    avail: np.ndarray        # [H, 4] availability snapshot
    demands: np.ndarray      # [T, 4]
    host_zone: np.ndarray    # [H] i32
    egress_tz: np.ndarray    # [T, Z] $ by destination zone
    hazard: np.ndarray       # [H] preemption rate per host
    risk_coeff: float        # risk_weight × rework_cost
    unplaced_penalty: float  # $ per task left unplaced
    anchor_zone: np.ndarray  # [T] i32 (greedy scoring)
    cost_zz: np.ndarray      # [Z, Z] egress-cost matrix (greedy scoring)
    bw_zz: np.ndarray        # [Z, Z] bandwidth matrix (greedy scoring)

    @property
    def n_tasks(self) -> int:
        return self.demands.shape[0]

    @property
    def n_hosts(self) -> int:
        return self.avail.shape[0]

    def cost_matrix(self) -> np.ndarray:
        """[T, H] per-placement objective cost (egress + risk)."""
        ez = self.egress_tz[:, self.host_zone]  # [T, H]
        return ez + self.risk_coeff * np.asarray(self.hazard)[None, :]


def placement_objective(inst: OracleInstance, placement) -> float:
    """THE objective — one definition for solver, referee, and reports.
    ``placement`` is [T] host indices, −1 = unplaced.  Infeasible
    placements (capacity overflow) raise: the objective is only defined
    on the feasible set, and silently scoring an infeasible vector
    would corrupt every regret built on it."""
    p = np.asarray(placement, dtype=np.int64)
    if p.shape != (inst.n_tasks,):
        raise ValueError(
            f"placement must be [{inst.n_tasks}], got {p.shape}"
        )
    used = np.zeros_like(np.asarray(inst.avail, dtype=np.float64))
    C = inst.cost_matrix()
    total = 0.0
    for t in range(inst.n_tasks):
        h = int(p[t])
        if h < 0:
            total += inst.unplaced_penalty
            continue
        used[h] += inst.demands[t]
        total += float(C[t, h])
    over = used - np.asarray(inst.avail, dtype=np.float64)
    if np.any(over > 1e-9):
        bad = int(np.argmax(np.max(over, axis=1)))
        raise ValueError(
            f"infeasible placement: host {bad} over capacity by "
            f"{np.max(over[bad]):.6g}"
        )
    return total


def _host(x, dtype=None) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def instance_from_wave(
    workload,
    topo,
    avail,
    producer_placement,
    consumer_mask,
    *,
    hazard: Optional[np.ndarray] = None,
    weights: PolicyWeights = DEFAULT_WEIGHTS,
    unplaced_penalty: float = 1.0,
) -> OracleInstance:
    """Build the oracle instance for one consumer wave of an
    :class:`~pivot_tpu_torch.parallel.ensemble.EnsembleWorkload`.

    ``producer_placement`` is the [T] host vector of already-finished
    instances (−1 = not placed / not done); ``consumer_mask`` the [T]
    bool mask of the wave to place now.  ``egress_tz`` reproduces the
    ensemble bill's expected cost per sampled pull: consumer instance
    of group c pulls ``samp[c, g]`` instances of each predecessor
    group g, each pull costing ``out_g × Σ_s src_frac[g, s] ×
    cost[s, z] / 8000`` with sources distributed like the producer's
    placed instances (``bill._sampled_egress``) — so the oracle's
    egress for a placement equals the estimator meter's, pinned by
    ``tests/test_oracle.py``.
    """
    from pivot_tpu_torch.parallel.ensemble.bill import _sampling_table

    pred_group = _host(workload.pred_group, np.float64)
    out_group = _host(workload.out_group, np.float64)
    group_of = _host(workload.group_of)
    host_zone = _host(topo.host_zone)
    cost = _host(topo.cost, np.float64)
    bw = _host(topo.bw, np.float64)
    Z = cost.shape[0]
    pp = np.asarray(producer_placement, dtype=np.int64)
    cm = np.asarray(consumer_mask, dtype=bool)

    # [G, Z] placed-producer counts → source distribution per group.
    G = pred_group.shape[0]
    zcp = np.zeros((G, Z), dtype=np.float64)
    for t in np.nonzero(pp >= 0)[0]:
        zcp[group_of[t], host_zone[pp[t]]] += 1.0
    n_placed = zcp.sum(axis=1, keepdims=True)
    src_frac = np.where(n_placed > 0, zcp / np.maximum(n_placed, 1.0), 0.0)
    _, samp = _sampling_table(workload)
    samp = _host(samp, np.float64)
    # d[g, z]: $ of one pull from group g into zone z (output-scaled).
    d = (src_frac * out_group[:, None]) @ cost  # [G, Z]
    pulls = (pred_group * samp)[group_of]  # [T, G]
    egress_tz = (pulls @ d) / 8000.0  # [T, Z]

    idx = np.nonzero(cm)[0]
    demands = _host(workload.demands, np.float64)[idx]
    H = host_zone.shape[0]
    if hazard is None:
        hazard = np.zeros(H, dtype=np.float64)
    # Consumer anchors for the greedy arm: the majority producer zone
    # (the DES vote), ties to the lowest zone index.
    anchor = np.zeros(len(idx), dtype=np.int32)
    for j, t in enumerate(idx):
        votes = pred_group[group_of[t]] @ zcp  # [Z]
        anchor[j] = int(np.argmax(votes)) if votes.any() else 0
    return OracleInstance(
        avail=_host(avail, np.float64),
        demands=demands,
        host_zone=host_zone.astype(np.int32),
        egress_tz=egress_tz[idx],
        hazard=_host(hazard, np.float64),
        risk_coeff=float(weights.risk_coefficient()),
        unplaced_penalty=float(unplaced_penalty),
        anchor_zone=anchor,
        cost_zz=cost,
        bw_zz=bw,
    )


# -- solvers -----------------------------------------------------------------


def brute_force(inst: OracleInstance) -> Tuple[np.ndarray, float]:
    """Exhaustive optimum over every (H+1)^T assignment — the test
    referee for :func:`solve_instance`; refuses instances too large to
    enumerate."""
    T, H = inst.n_tasks, inst.n_hosts
    if (H + 1) ** T > 2_000_000:
        raise ValueError(
            f"brute force over {(H + 1) ** T} assignments is not a test "
            "any more — shrink the instance"
        )
    best, best_obj = None, np.inf
    for combo in itertools.product(range(-1, H), repeat=T):
        p = np.asarray(combo, dtype=np.int64)
        try:
            obj = placement_objective(inst, p)
        except ValueError:
            continue  # infeasible
        if obj < best_obj - 1e-15:
            best, best_obj = p, obj
    return best, float(best_obj)


def solve_instance(
    inst: OracleInstance,
    *,
    max_nodes: int = 2_000_000,
) -> Tuple[np.ndarray, float, dict]:
    """Branch-and-bound optimum: ``(placement [T], objective, stats)``.

    Exact: the admissible bound (each remaining task pays at least its
    capacity-ignoring cheapest option) only ever prunes provably
    dominated subtrees, and the search raises if ``max_nodes`` runs out
    — it never degrades to a heuristic silently.  Tasks branch in
    descending demand-norm order (tight tasks first ⇒ early capacity
    conflicts ⇒ smaller trees); children best-cost-first so the greedy
    incumbent lands early.
    """
    T, H = inst.n_tasks, inst.n_hosts
    C = inst.cost_matrix()  # [T, H]
    pen = inst.unplaced_penalty
    demands = np.asarray(inst.demands, dtype=np.float64)
    order = np.argsort(
        -np.sqrt(np.sum(demands * demands, axis=1)), kind="stable"
    )
    # Admissible per-task floor and its suffix sums along the branch
    # order: cheapest option ignoring capacity (unplaced included).
    floor = np.minimum(C.min(axis=1), pen)
    suffix = np.zeros(T + 1, dtype=np.float64)
    for i in range(T - 1, -1, -1):
        suffix[i] = suffix[i + 1] + floor[order[i]]

    # Greedy incumbent: cheapest feasible option per task in branch
    # order — feasible by construction, so the bound has a target.
    inc = np.full(T, -1, dtype=np.int64)
    avail = np.asarray(inst.avail, dtype=np.float64).copy()
    inc_obj = 0.0
    for t in order:
        fits = np.all(avail >= demands[t], axis=1)
        choice = -1
        cost_t = pen
        if fits.any():
            h = int(np.argmin(np.where(fits, C[t], np.inf)))
            if C[t, h] <= pen:
                choice, cost_t = h, float(C[t, h])
        if choice >= 0:
            avail[choice] -= demands[t]
        inc[t] = choice
        inc_obj += cost_t

    best = inc.copy()
    best_obj = inc_obj
    nodes = 0
    placement = np.full(T, -1, dtype=np.int64)
    avail = np.asarray(inst.avail, dtype=np.float64).copy()

    def dfs(i: int, acc: float):
        nonlocal nodes, best, best_obj
        nodes += 1
        if nodes > max_nodes:
            raise RuntimeError(
                f"branch-and-bound exhausted its {max_nodes}-node budget "
                f"on a T={T}, H={H} instance — shrink the instance or "
                "raise max_nodes (the oracle never returns a heuristic)"
            )
        if i == T:
            if acc < best_obj - 1e-15:
                best, best_obj = placement.copy(), acc
            return
        t = order[i]
        fits = np.all(avail >= demands[t], axis=1)
        # Children: feasible hosts + the unplaced arm, best-first.
        opts = [(float(C[t, h]), int(h)) for h in np.nonzero(fits)[0]]
        opts.append((pen, -1))
        opts.sort()
        for cost_t, h in opts:
            if acc + cost_t + suffix[i + 1] >= best_obj - 1e-15:
                break  # sorted: every later child is dominated too
            placement[t] = h
            if h >= 0:
                avail[h] -= demands[t]
            dfs(i + 1, acc + cost_t)
            if h >= 0:
                avail[h] += demands[t]
            placement[t] = -1

    dfs(0, 0.0)
    return best, float(best_obj), {"nodes": nodes, "incumbent": inc_obj}


def greedy_placement(
    inst: OracleInstance,
    weights: PolicyWeights = DEFAULT_WEIGHTS,
    *,
    bin_pack: str = "best-fit",
) -> np.ndarray:
    """The heuristic arm: cost-aware greedy placement of the instance
    under ``weights`` — the single-wave mirror of ``CostAwarePolicy``'s
    two bin-pack modes, so regret reports compare the *policy family
    the search tunes* against the optimum, not a strawman.  Tasks run
    demand-decreasing; per mode (matching ``sched/policies.py``):

      * ``"first-fit"`` — score ``cost_rt^w_cost / (norm^w_norm ×
        bw_rt^w_bw)`` of the LIVE availability, pick the best host
        among **strict** fits (ref ``cost_aware.py:124``);
      * ``"best-fit"`` — score ``cost_rt^w_cost × residual^w_norm /
        bw_rt^w_bw`` (residual = norm of ``avail − demand``), pick the
        best host among **non-strict** fits (ref ``:87``; the decay
        factor is 1 — a single wave has no resident-task counts).

    Both add the shared ``+ risk`` term.
    """
    if bin_pack not in ("first-fit", "best-fit"):
        raise ValueError(f"bin_pack must be first-fit|best-fit, got {bin_pack}")
    T, H = inst.n_tasks, inst.n_hosts
    demands = np.asarray(inst.demands, dtype=np.float64)
    avail = np.asarray(inst.avail, dtype=np.float64).copy()
    hz = inst.host_zone
    cost_rt = inst.cost_zz[:, hz] + inst.cost_zz[hz, :].T  # [Z, H]
    bw_rt = inst.bw_zz[:, hz] + inst.bw_zz[hz, :].T
    risk = (
        weights.risk_coefficient() * np.asarray(inst.hazard)
        if weights.risk_coefficient() > 0 else None
    )
    placement = np.full(T, -1, dtype=np.int64)
    order = np.argsort(
        -np.sqrt(np.sum(demands * demands, axis=1)), kind="stable"
    )
    exps = weights.score_exponents()
    wc, wb, wn = exps if exps is not None else (1.0, 1.0, 1.0)
    for t in order:
        if bin_pack == "first-fit":
            fits = np.all(avail > demands[t], axis=1)  # strict, ref :124
        else:
            fits = np.all(avail >= demands[t], axis=1)  # non-strict, :87
        if not fits.any():
            continue
        cr = cost_rt[inst.anchor_zone[t]]
        br = bw_rt[inst.anchor_zone[t]]
        with np.errstate(divide="ignore", invalid="ignore"):
            if bin_pack == "first-fit":
                norm = np.sqrt(np.sum(avail * avail, axis=1))
                if exps is None:
                    score = cr / (norm * br)
                else:
                    score = cr ** wc / (norm ** wn * br ** wb)
            else:
                residual = np.sqrt(
                    np.sum((avail - demands[t]) ** 2, axis=1)
                )
                if exps is None:
                    score = cr * residual / br
                else:
                    score = cr ** wc * residual ** wn / br ** wb
        if risk is not None:
            score = score + risk
        h = int(np.argmin(np.where(fits, score, np.inf)))
        avail[h] -= demands[t]
        placement[t] = h
    return placement


def regret(
    inst: OracleInstance, placement, optimum: Optional[float] = None
) -> float:
    """``objective(placement) − objective(optimum)`` — ≥ 0 by
    optimality; ``optimum`` may be passed to amortize one solve across
    several arms."""
    if optimum is None:
        _, optimum, _ = solve_instance(inst)
    return placement_objective(inst, placement) - optimum
