"""The tick body of the ensemble rollout, batched over replicas.

Port of ``pivot_tpu/parallel/ensemble/tick.py::_rollout_segment``.  JAX
runs one replica's ``lax.while_loop`` over ticks and vmaps it; here every
tensor carries the replica axis ``R`` in front and the loops run on the
host:

  * the tick loop runs while any replica has a task not done (and at most
    ``n_ticks`` ticks).  A replica whose own loop would have stopped is
    frozen, as under ``vmap``: its clock and busy integral stop, and
    nothing else of it can change (it has no running, ready or waiting
    task left);
  * the placement chain of a tick walks max-over-replicas ``n_ready``
    steps; a step past a replica's own ``n_ready`` places nothing there;
  * each tick reads the device once: ``[max n_ready, any replica alive
    next tick]`` in one copy, after the sort (a task only becomes done in
    the retire step, so the next tick's loop condition is known by then).

The body is the JAX package's ``"indexed"`` form (segment sums, gathers
and scatters), which its tests hold bit-identical to the ``"vector"``
form; ``forms`` is accepted for signature parity.  Float roundings follow
XLA's CPU backend (``bill.py``).  The refund adds each host's retiring
tasks in task-index order, as ``segment_sum`` does there: the trace's
demands are not integers (0.5 CPUs, 2359.2961 MB), so the order shows
in the bits.  ``index_put_`` with ``accumulate`` gives that order on
both devices (a sequential loop on the CPU; a stable sort by row and one
sequential pass per row on the card, no atomics).  Counts use
``index_add_`` (0/1 operands, integer sums below 2**24: exact in any
order), maxima ``scatter_reduce`` (exact in any order), the busy
integral ``_ordered_sum`` (XLA:CPU's order on both devices: the same
bits on the card as on the CPU).

Per-row channels (the row runner of ``sweeps.py`` feeds them, ``B``
rows in front): fault schedules ``([B, F] host, fail_at, recover_at)``
with ``totals`` ``[H, 4]`` or ``[B, H, 4]`` (recovery target), score
exponents ``[B, 3]`` (pow tables hoisted per call, ``norm ** w_norm``
taken once per snapshot, all with XLA:CPU's ``pow``: ``libm.py``;
float64 on the CPU only), the
eviction-risk term (``risk_coeff [B]`` with a row-shared ``hazard``) and
the active-task mask ``[B, T]``.

The congestion backlog model (``congestion=True``: one FIFO pipe per
(source zone → destination host), ``"pairs"``: per (source host →
destination host)) and realtime scoring follow ``pivot_tpu``'s indexed
form (``tick.py:923-1030``): a tick's placements join the pipes as a
segment sum in task-index order (``index_put_`` with ``accumulate``, as
the refund), a placed task waits for the backlog of every pipe it pulls
from, and the pipes drain by ``bw · tick``, one fused multiply-add as
XLA:CPU computes ``q − bw · tick``.  The pull volumes ``pull_frac @
counts`` are one product (:func:`_pull_volumes`) whose rounding is not
XLA:CPU's (ROADMAP.md Queue 3).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Optional

import torch

from pivot_tpu_torch.ops.kernels import _first_true, _place_replicas
from pivot_tpu_torch.ops.tickloop import _inverse, _lexsort
from pivot_tpu_torch.utils import compile_counter
from pivot_tpu_torch.parallel.ensemble.bill import (
    _fma_norms,
    _ordered_sum,
    _recip,
    _sampling_table,
)
from pivot_tpu_torch.parallel.ensemble.libm import require_host, xla_pow
from pivot_tpu_torch.parallel.ensemble.prng import fma
from pivot_tpu_torch.parallel.ensemble.state import (
    _DONE,
    _PENDING,
    _RUNNING,
    EnsembleWorkload,
    RolloutState,
    _resolve_forms,
)

POLICIES = ("cost-aware", "first-fit", "best-fit", "opportunistic")


def check_options(congestion, realtime_scoring, policy,
                  score_params=None) -> None:
    """``pivot_tpu``'s argument checks of the congestion model and
    realtime scoring (``tick.py:119-141``), with its exception types."""
    if congestion not in (False, True, "pairs"):
        raise ValueError(
            f"congestion must be False, True, or 'pairs', got {congestion!r}")
    if realtime_scoring and not congestion:
        raise ValueError("realtime_scoring needs congestion=True (the "
                         "backlog state is the bandwidth signal)")
    if realtime_scoring and congestion == "pairs":
        raise ValueError("realtime_scoring reads zone-resolution backlog "
                         "(the score tables are [Z, H]); use "
                         "congestion=True with it")
    if realtime_scoring and policy != "cost-aware":
        raise ValueError("realtime_scoring applies to the cost-aware arm "
                         "only — no other policy scores on bandwidth")
    if realtime_scoring and score_params is not None:
        raise ValueError("realtime_scoring and parameterized score "
                         "exponents are mutually exclusive")


def _pull_volumes(pull_frac, counts):
    """``[R, G, S]`` MB a consumer instance of each group pulls from each
    source (zone, or host for ``"pairs"``): ``pull_frac @ counts`` per
    replica (``pivot_tpu``'s ``tick.py:935`` / ``:962``).  XLA:CPU's
    vmapped product accumulates as the batch width lays out its GEMM
    tiles (an ascending fused multiply-add chain at some widths, the
    chain split in two at others), which no fixed order can follow
    (ROADMAP.md Queue 3); the tests swap in XLA's own product here to
    hold everything else bitwise."""
    return torch.matmul(pull_frac, counts)


def _pipe_step(q, vol, dst, valid, inv_bw, neg_bw, tick):
    """One tick of the backlog pipes ``q`` ``[R, S, H]`` (source rows,
    destination-host columns), given this tick's placed tasks in
    task-index order per replica: ``vol`` ``[R, n, S]`` the MB each pulls
    from each source, ``dst`` ``[R, n]`` its host, ``valid`` ``[R, n]``
    (false on padding).  The volumes join the pipes as a segment sum in
    that order; a task's congested delay is the largest ``q_now / bw``
    over the sources it pulls a nonzero volume from.  Returns the drained
    pipes ``max(q_now − bw · tick, 0)`` (one fused multiply-add, as
    XLA:CPU computes it) and the delays ``[R, n]``."""
    R, S, H = q.shape
    n = dst.shape[1]
    dev = q.device
    rep = torch.arange(R, device=dev)[:, None]
    # Padding adds to dropped rows of its own past the R·H pipe rows (the
    # refund's reason: one shared dropped row would be one long run).
    rows = torch.where(valid, rep * H + dst,
                       R * H + rep * n + torch.arange(n, device=dev))
    acc = torch.zeros((R * H + R * n, S), dtype=q.dtype, device=dev)
    # graftcheck: ignore[determinism] -- index_put_'s accumulate adds each row's run in index order on both devices (module docstring: a sort by row and one sequential pass a row on the card, no atomics)
    acc.index_put_((rows.reshape(-1),), vol.reshape(-1, S), accumulate=True)
    q_now = q + acc[:R * H].reshape(R, H, S).transpose(1, 2)
    ratio = (q_now * inv_bw).transpose(1, 2)[rep, dst]  # [R, n, S]
    zero = torch.zeros((), dtype=q.dtype, device=dev)
    cong = torch.where(vol > 0, ratio, zero).amax(-1)
    drained = fma(neg_bw.expand_as(q_now), tick, q_now)
    return torch.clamp_min(drained, 0.0), cong


@contextlib.contextmanager
def loop_clock(counts: Optional[dict], device):
    """Add a run's ``wall_s`` (host clock) and, on the card,
    ``event_span_ms`` (the stream's elapsed time between CUDA events
    around it, idle gaps included: not busy time) to ``counts``."""
    counts = counts if counts is not None else {}
    cuda = torch.device(device).type == "cuda"
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
    wall0 = time.perf_counter()  # graftcheck: ignore[determinism] -- the run's wall_s counter only; no result reads it
    yield
    if cuda:
        end.record()
        end.synchronize()
        counts["event_span_ms"] = counts.get("event_span_ms", 0.0) + \
            start.elapsed_time(end)
    # graftcheck: ignore[determinism] -- the run's wall_s counter only
    counts["wall_s"] = counts.get("wall_s", 0.0) + \
        time.perf_counter() - wall0


def _pred_lists(pred_group: torch.Tensor) -> torch.Tensor:
    """``[G, P]`` predecessor groups of each group, padded with ``G`` (a
    pad row the caller appends).  One host read, once per rollout."""
    G = pred_group.shape[0]
    adj = pred_group.cpu() > 0
    rows = [torch.nonzero(adj[g]).reshape(-1).tolist() for g in range(G)]
    width = max([1] + [len(r) for r in rows])
    table = torch.full((G, width), G, dtype=torch.int64)
    for g, r in enumerate(rows):
        table[g, :len(r)] = torch.tensor(r, dtype=torch.int64)
    return table.to(pred_group.device)


class _SnapshotGraphs:
    """The captured norm-snapshot graphs of the process, keyed by the
    operands' layout ``(avail shape, dtype, device, w_norm shape)``.  A
    rollout checks a graph of its layout out for the whole call
    (:meth:`take`) and hands it back at its end (:meth:`give`): it runs
    its chain on the graph's own ``avail`` buffer and copies its
    exponents into the graph's ``w_norm`` buffer.  A layout with no free
    graph captures one, so two threads (the MPC's planner and tuner)
    never share a graph, and a graph captured on one thread (a warm-up
    before the serving threads start) is replayed on another.  At most
    :attr:`keep` free graphs are kept (least recently returned dropped
    first).  Each capture is a ``graph_capture`` of
    ``utils/compile_counter.py``."""

    keep = 8

    def __init__(self):
        self._lock = threading.Lock()
        self._free = collections.OrderedDict()  # (key, id) -> entry

    def take(self, avail, w_norm):
        """``(chain buffer, snap, entry)`` for this layout."""
        key = (tuple(avail.shape), avail.dtype, str(avail.device),
               None if w_norm is None else tuple(w_norm.shape))
        with self._lock:
            slot = next((k for k in self._free if k[0] == key), None)
            entry = self._free.pop(slot) if slot is not None else None
        if entry is None:
            entry = self._capture(key, avail, w_norm)
        _, buf, w_buf, replay = entry
        if w_buf is not None:
            w_buf.copy_(w_norm)
        return buf, replay, entry

    def give(self, entry) -> None:
        """Return a graph taken by :meth:`take`."""
        with self._lock:
            self._free[(entry[0], id(entry))] = entry
            while len(self._free) > self.keep:
                self._free.popitem(last=False)

    def _capture(self, key, avail, w_norm):
        buf = torch.empty_like(avail)
        w_buf = None if w_norm is None else w_norm.clone()

        def snap():
            live = _fma_norms(buf)
            return live if w_buf is None else xla_pow(live, w_buf)

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            snap()  # warm-up: lazy tables and allocations outside it
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # "thread_local": the serving threads may allocate and read the
        # card while this thread captures.
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = snap()
        compile_counter.record("graph_capture")

        def replay():
            graph.replay()
            return out
        return key, buf, w_buf, replay


SNAPSHOT_GRAPHS = _SnapshotGraphs()


def _norm_snapshot(avail, w_norm):
    """The cost-aware chain's per-step host norm term, ``‖avail‖`` (``**
    w_norm`` with score exponents).  Returns ``(buffer, snap, graph)``:
    the chain copies its availability into ``buffer``, updates it there
    in place, and ``snap() -> [R, H]`` reads it.  On the card its ~90
    launches (~390 with the pow twin) are one CUDA graph replay, the
    graph checked out of :data:`SNAPSHOT_GRAPHS` (``graph``: hand it back
    with ``SNAPSHOT_GRAPHS.give`` when the rollout ends; None on the
    CPU): the same kernels on the same buffers, so the same bits, at a
    fraction of the host's launch time; ``snap()`` returns the graph's
    own output buffer, rewritten by the next call."""
    if avail.is_cuda:
        return SNAPSHOT_GRAPHS.take(avail, w_norm)
    buf = avail.clone()

    def snap():
        live = _fma_norms(buf)
        return live if w_norm is None else xla_pow(live, w_norm)
    return buf, snap, None


def _rollout_segment(
    state: RolloutState,
    runtime,  # [R, T] perturbed
    arrival,  # [R, T] perturbed
    root_anchor,  # [R, T] random storage zone per task (used for roots)
    workload: EnsembleWorkload,
    topo,
    tick: float,
    n_ticks: int,
    faults=None,  # ([R, F] host, [R, F] fail_at, [R, F] recover_at)
    totals=None,  # [H, 4] or [R, H, 4]: what a recovered host gets back
    score_params=None,  # [R, 3] exponents (w_cost, w_bw, w_norm)
    policy: str = "cost-aware",
    task_u=None,  # [R, T] uniforms of the opportunistic arm
    congestion=False,
    realtime_scoring: bool = False,
    active=None,  # [R, T] bool: inactive tasks do not keep a row going
    forms: Optional[str] = None,
    tick_order: str = "fifo",
    risk_coeff=None,  # [R] risk_weight × rework_cost
    hazard=None,  # ([P] segment starts, [P, H] per-host hazards), shared
    stats: Optional[dict] = None,
) -> RolloutState:
    """Advance R replicas' rollouts by at most ``n_ticks`` ticks (stops
    once every replica's active tasks are done).  ``stats``, when given,
    gains ``ticks``, ``place_steps`` and ``host_syncs``.

    Faults follow ``pivot_tpu``'s tick semantics: after the window's
    completions retire, a crash in the window aborts the host's running
    tasks back to PENDING (no refund), a down host carries the −1
    sentinel (re-applied every tick) and a recovery hands back the row's
    ``totals``.  With ``risk_coeff`` and ``hazard``, each tick prices the
    market's hazard row at ``t`` (``searchsorted(times, t, right) - 1``,
    clipped): cost-aware and best-fit add it to the score, first-fit
    takes the lowest-risk fitting host (ties to the lowest index) and
    opportunistic draws among the fitting hosts of least risk.

    With ``congestion`` the state's ``q`` carries the backlog pipes; a
    crash empties the struck host's inbound pipes (and, for ``"pairs"``,
    its outbound ones), and with ``realtime_scoring`` the cost-aware
    score reads the inbound bandwidth discounted by the tick-start
    backlog, ``bw_in / (q + 1)`` (``pivot_tpu``'s ``tick.py:643-655``)."""
    check_options(congestion, realtime_scoring, policy, score_params)
    pairs = congestion == "pairs"
    if (hazard is None) != (risk_coeff is None):
        raise ValueError("the risk term needs both hazard and risk_coeff")
    _resolve_forms(forms)
    if tick_order not in ("fifo", "lifo"):
        raise ValueError(
            f"tick_order must be 'fifo' or 'lifo', got {tick_order!r}")
    if policy not in POLICIES:
        raise ValueError(f"unknown ensemble policy {policy!r}")
    lifo = tick_order == "lifo"
    t, stage, finish, place, avail, busy, q, qpos = state
    R, T = stage.shape
    H = avail.shape[1]
    Z = topo.cost.shape[0]
    G = workload.n_groups
    dtype, dev = avail.dtype, avail.device
    zero = torch.zeros((), dtype=dtype, device=dev)
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)
    tick_t = torch.tensor(tick, dtype=dtype, device=dev)
    inv_tick = _recip(tick, dtype, dev)
    host_zone = topo.host_zone.long()
    group_of = workload.group_of.expand(R, T)
    has_pred = (workload.pred != 0).any(1)  # [T]
    # The workload may be float32 under a float64 state, as in the JAX
    # package (``from_applications`` defaults to float32); elementwise ops
    # promote, the matmuls and the demand sums take exact float64 copies
    # (the demand norms, sort keys only, stay in the workload's dtype).
    demands = workload.demands.to(dtype)
    pred_t = workload.pred.to(dtype).T
    pred_group = workload.pred_group.to(dtype)
    iota = torch.arange(T, device=dev)
    iota_r = iota.expand(R, T)
    rep = torch.arange(R, device=dev)
    miss_row = R * H + rep[:, None] * T + iota  # [R, T] dropped refund rows
    # [Z, H] round-trip score tables (pure topology).
    cost_rt = topo.cost[:, host_zone] + topo.cost[host_zone, :].T
    bw_rt = topo.bw[:, host_zone] + topo.bw[host_zone, :].T
    if policy in ("first-fit", "cost-aware"):
        dem_norms = _fma_norms(workload.demands)
        task_order = torch.sort(-dem_norms, stable=True).indices
    else:
        task_order = iota
    task_rank = _inverse(task_order, iota)
    dem_group = torch.zeros((G, 4), dtype=dtype, device=dev)
    dem_group[workload.group_of] = demands
    pred_idx = _pred_lists(workload.pred_group)  # [G, P], pad = G
    inv_bw = torch.where(topo.bw > 0, 1.0 / topo.bw, zero)  # [Z, Z]
    strict = policy in ("cost-aware", "best-fit")  # ref :124 / vbp :45
    fits = torch.gt if strict else torch.ge
    if policy == "opportunistic":
        golden = torch.tensor(0.6180339887498949, dtype=dtype, device=dev)
    if faults is not None:
        fail_at, recover_at = faults[1], faults[2]
        fault_idx = torch.where(faults[0] >= 0, faults[0].long(), H)
        F = fault_idx.shape[1]
        tot = totals.expand(R, H, 4)

        def scatter_hosts(hit):  # [R, F] bool → [R, H] bool (misses → H)
            m = torch.zeros((R, H + 1), dtype=torch.bool, device=dev)
            m.scatter_(1, torch.where(hit, fault_idx, H),
                       torch.ones((R, F), dtype=torch.bool, device=dev))
            return m[:, :H]
    if score_params is not None:
        require_host(dtype, dev, "score exponents")
        # Per-row pow tables, hoisted (pure topology × exponents); the
        # norm's pow is taken once per snapshot in the chain.
        sp = score_params.to(dtype)
        cost_rt = xla_pow(cost_rt[None], sp[:, 0, None, None])  # [R, Z, H]
        bw_rt = xla_pow(bw_rt[None], sp[:, 1, None, None])
        w_norm = sp[:, 2:3]
    if congestion:
        # Pipe tables (pure topology, hoisted): the bandwidth of each
        # (source → destination host) pipe, its reciprocal, and the pull
        # volume of a consumer instance per done producer instance (the
        # DES's pull-sample rule, ``bill._sampling_table``).
        bw_zh = topo.bw[:, host_zone]  # [Z, H]
        inv_zh = torch.where(bw_zh > 0, 1.0 / bw_zh, zero)
        # Host pipes: row s is source host s, with its zone's bandwidth.
        bw_pipe, inv_pipe = (bw_zh[host_zone], inv_zh[host_zone]) if pairs \
            else (bw_zh, inv_zh)
        neg_bw = -bw_pipe
        inst, samp = _sampling_table(workload)
        pull_frac = (workload.pred_group * samp
                     * (workload.out_group / inst)[None, :]).to(dtype)
    if hazard is not None:
        h_times, h_rows = hazard
        kind = torch.promote_types(h_times.dtype, dtype)
        h_times = h_times.to(kind)
        risk_c = risk_coeff[:, None]
    counts = stats if stats is not None else {}
    for k in ("ticks", "place_steps", "host_syncs"):
        counts.setdefault(k, 0)

    def pending(stage):  # [R] the loop condition per replica
        left = stage != _DONE
        return (left & active if active is not None else left).any(1)

    alive = pending(stage)
    snap = graph = None  # the chain's norm snapshot, built on first use
    # graftcheck: ignore[host-sync] -- the rollout's first host read, counted in counts["host_syncs"]
    go = n_ticks > 0 and R > 0 and bool(alive.any())
    counts["host_syncs"] += 1
    i = 0
    while go and i < n_ticks:
        # A replica whose loop has ended (``alive`` false) sits the tick
        # out whole, as a row of ``pivot_tpu``'s vmapped while_loop does:
        # under an active mask its inactive tasks may still be running or
        # ready, so ``live`` gates every state change at its source
        # (retire, abort, fault, eligibility, the lifo carry).  Without a
        # mask such a replica has nothing left to change.
        live = alive[:, None]
        # 1. Retire finished tasks and refund their resources: an index-
        #    ordered sum per host.  Each miss adds 0 to a dropped row of
        #    its own past the R·H host rows: on the card the accumulate
        #    walks each run of equal rows in one thread, and one shared
        #    dropped row would be a run of R·T.
        newly_done = (stage == _RUNNING) & (finish <= t[:, None]) & live
        rows = torch.where(newly_done, rep[:, None] * H + place, miss_row)
        refund = torch.zeros((R * H + R * T, 4), dtype=dtype, device=dev)
        # graftcheck: ignore[determinism] -- the refund's task-index order per host (module docstring): index_put_'s accumulate, a sequential pass a row on both devices
        refund.index_put_(
            (rows.reshape(-1),),
            torch.where(newly_done[..., None], demands, zero).reshape(-1, 4),
            accumulate=True)
        avail = avail + refund[:R * H].reshape(R, H, 4)
        stage = torch.where(newly_done, _DONE, stage)

        # 1b. Faults strike after this window's completions retire.  A
        #     frozen replica's hosts stay as they are.
        if faults is not None:
            t_prev = (t - tick_t)[:, None]
            tc = t[:, None]
            struck = scatter_hosts((fail_at > t_prev) & (fail_at <= tc))
            down = scatter_hosts((fail_at <= tc) & (tc < recover_at))
            prev_down = scatter_hosts((fail_at <= t_prev)
                                      & (t_prev < recover_at))
            aborted = ((stage == _RUNNING) & (place >= 0) & live
                       & struck.gather(1, place.clamp(0, H - 1)))
            stage = torch.where(aborted, _PENDING, stage)
            place = torch.where(aborted, -1, place)
            finish = torch.where(aborted, inf, finish)
            recovered = (prev_down | struck) & ~down & live
            avail = torch.where(recovered[..., None], tot, avail)
            avail = torch.where((down & live)[..., None], -1.0, avail)
            if congestion:
                # A crash cancels the host's queued inbound transfers;
                # host-pair rows cancel its outbound ones too.
                hit = struck & live
                q = torch.where(hit[:, None, :], 0.0, q)
                if pairs:
                    q = torch.where(hit[:, :, None], 0.0, q)
        alive_next = pending(stage)

        # 2. Readiness: every predecessor instance done, and the DES
        #    dispatch pipeline's pump time (strictly after the last
        #    predecessor's finish, on the app's tick phase) passed.
        done = stage == _DONE
        done_f = done.to(dtype)
        unfinished_preds = torch.matmul(1.0 - done_f, pred_t)
        fin_done = torch.where(done, finish, -inf)
        gf = torch.full((R, G), float("-inf"), dtype=dtype, device=dev)
        gf.scatter_reduce_(1, group_of, fin_done, "amax", include_self=True)
        gf = torch.cat([gf, gf.new_full((R, 1), float("-inf"))], 1)
        tau_g = gf[:, pred_idx].amax(-1)  # [R, G] (−inf for root groups)
        tau = tau_g.gather(1, group_of)
        pump = fma(torch.floor((tau - arrival) * inv_tick) + 1.0, tick_t,
                   arrival)
        ready_time = torch.where(has_pred, pump, arrival)
        ready = ((stage == _PENDING) & (ready_time < t[:, None])
                 & (unfinished_preds == 0))

        # 2b. Batch rank under "lifo": the wait cohort re-drains in
        #     reverse of its previous positions, fresh tasks follow by
        #     pump time, app, then descending index.
        if lifo:
            wait_c = (qpos >= 0) & ready
            k1 = torch.where(ready, torch.where(wait_c, -qpos, 1), 2)
            app = workload.app_of.expand(R, T)
            border = _lexsort((k1, ready_time, app, -iota_r), iota_r)
            brank = _inverse(border, iota_r)
        else:
            brank = iota_r

        # 3. Done-instance counts per (group, zone) — and, for cost-aware,
        #    per (group, host) — then the per-host majority vote over
        #    predecessor placements; roots keep their keyed anchor.  A task
        #    not done adds 0 to the slot of its (clamped) host, so no one
        #    slot collects the misses' atomics.
        host_c = place.clamp(0, H - 1)
        slot = (rep[:, None] * G + group_of) * Z + host_zone[host_c]
        # graftcheck: ignore[determinism] -- 0/1 operands, integer sums below 2**24: exact in any order
        zc = torch.zeros(R * G * Z, dtype=dtype, device=dev).index_add_(
            0, slot.reshape(-1), done_f.reshape(-1)).reshape(R, G, Z)
        if policy == "cost-aware":
            # [G, R, H] layout: the vote is one [G, G] @ [G, R·H] product.
            slot = (group_of * R + rep[:, None]) * H + host_c
            # graftcheck: ignore[determinism] -- 0/1 operands, integer sums below 2**24: exact in any order
            hv = torch.zeros(G * R * H, dtype=dtype, device=dev).index_add_(
                0, slot.reshape(-1), done_f.reshape(-1))
            votes = torch.matmul(pred_group, hv.reshape(G, R * H))
            majority_host = votes.reshape(G, R, H).argmax(-1).T  # [R, G]
            majority_zone = host_zone[majority_host].gather(1, group_of)
            anchor = torch.where(has_pred, majority_zone, root_anchor)
        else:
            anchor = root_anchor
        if pairs:  # [R, G, H] done counts per (group, host)
            slot = (rep[:, None] * G + group_of) * H + host_c
            # graftcheck: ignore[determinism] -- 0/1 operands, integer sums below 2**24: exact in any order
            hv_g = torch.zeros(R * G * H, dtype=dtype, device=dev).index_add_(
                0, slot.reshape(-1), done_f.reshape(-1)).reshape(R, G, H)

        # 4. Eligibility: ready, with a fitting host at tick start (the
        #    fit test is exact at group level: demands are group-constant).
        fit_g = fits(avail[:, None, :, 0], dem_group[None, :, None, 0])
        for k in range(1, 4):
            fit_g &= fits(avail[:, None, :, k], dem_group[None, :, None, k])
        eligible = ready & live & fit_g.any(-1).gather(1, group_of)
        del fit_g
        if policy == "cost-aware":
            bucket = torch.where(has_pred, anchor, Z + workload.app_of)
            ready_idx = torch.where(ready, brank, T)
            fib = torch.full((R, Z + G), torch.iinfo(torch.int64).max,
                             dtype=torch.int64, device=dev)
            fib.scatter_reduce_(1, bucket, ready_idx, "amin",
                                include_self=True)
            bfirst = fib.gather(1, bucket)
            key3 = (-dem_norms).expand(R, T)
        else:
            bfirst = torch.zeros((R, T), dtype=torch.int64, device=dev)
            if policy == "first-fit":
                key3 = (-dem_norms).expand(R, T) if lifo else \
                    task_rank.expand(R, T)
            else:
                key3 = bfirst if lifo else task_rank.expand(R, T)
        order = _lexsort(((~eligible).long(), bfirst, key3, brank), iota_r)
        bf_p = bfirst.gather(1, order)
        az_p = anchor.gather(1, order)
        g_p = group_of.gather(1, order)
        u_p = task_u.gather(1, order) if task_u is not None else None
        n_ready = eligible.sum(1)
        # graftcheck: ignore[host-sync] -- the one host read a tick (the chain's step count and the loop's end), counted in counts["host_syncs"]
        n_steps, go_next = torch.stack(
            [n_ready.max(), alive_next.any().long()]).tolist()
        counts["host_syncs"] += 1

        # 5a. Transfer-delay table: GD[g, z] = out_g × max over zones s
        #     holding a done g-instance of 1/bw[s, z]; CD[c, z] = max over
        #     c's predecessor groups.
        present = zc > 0
        gd = torch.where(present[..., None], inv_bw, zero).amax(2) \
            * workload.out_group[None, :, None]  # [R, G, Z]
        gd = torch.cat([gd, gd.new_zeros((R, 1, Z))], 1)
        cd = gd[:, pred_idx].amax(2)  # [R, G, Z]
        if policy == "opportunistic" and task_u is not None:
            tick_idx = (t * inv_tick).to(torch.int32)
            weyl_rot = tick_idx.to(dtype) * golden  # [R]
        # 5a'. The tick's eviction-risk row per replica.
        if hazard is not None:
            seg = torch.searchsorted(h_times, t.to(kind)[:, None],
                                     right=True)[:, 0] - 1
            risk_row = risk_c * h_rows[seg.clamp(0, h_rows.shape[0] - 1)]

        # 5a''. Realtime scoring: the inbound leg of the round trip
        #      discounted by the tick-start backlog (an empty pipe keeps
        #      the static entry's bits).
        if realtime_scoring:
            score_bw = torch.where(q > 0, bw_rt - bw_zh + bw_zh / (q + 1.0),
                                   bw_rt)  # [R, Z, H]

        # 5b. The placement chain: step j places each replica's j-th
        #     eligible task (a no-op past that replica's n_ready).
        pl = torch.full((R, T), -1, dtype=torch.int64, device=dev)
        delay = torch.zeros((R, T), dtype=dtype, device=dev)
        if policy == "cost-aware":
            # The chain runs on one buffer for the whole call, the
            # snapshot's input.
            if snap is None:
                chain_avail, snap, graph = _norm_snapshot(
                    avail, w_norm if score_params is not None else None)
            avail = chain_avail.copy_(avail)
            norm_snap = zero  # replaced at step 0 (bf_p ≥ 0 > prev_bf)
            prev_bf = torch.full((R,), -1, dtype=torch.int64, device=dev)
        place_row = _place_replicas(avail)
        for j in range(n_steps):
            g = g_p[:, j]
            demand = dem_group[g]  # [R, 4]
            fit = fits(avail, demand[:, None, :]).all(-1)  # [R, H]
            if policy == "cost-aware":
                # Host scores frozen per anchor bucket (availability at
                # bucket start), live fit checks.
                # A new snapshot where a row opens a bucket.  On the CPU
                # reading that flag costs nothing, so a step where no row
                # opens one skips the snapshot (the same values).
                bf_j = bf_p[:, j]
                opens = bf_j != prev_bf
                # graftcheck: ignore[host-sync] -- short-circuits on the card; read on the CPU only, where it is no device sync
                if dev.type != "cpu" or bool(opens.any()):
                    norm_snap = torch.where(opens[:, None], snap(),
                                            norm_snap)
                prev_bf = bf_j
                az = az_p[:, j]
                if realtime_scoring:
                    score = cost_rt[az] / (norm_snap * score_bw[rep, az])
                elif score_params is None:
                    score = cost_rt[az] / (norm_snap * bw_rt[az])
                else:
                    score = cost_rt[rep, az] / (norm_snap * bw_rt[rep, az])
                if hazard is not None:
                    score = score + risk_row
                h = torch.where(fit, score, inf).argmin(1)
            elif policy == "first-fit":
                h = _first_true(fit) if hazard is None else \
                    torch.where(fit, risk_row, inf).argmin(1)
            elif policy == "best-fit":
                score = _fma_norms(avail - demand[:, None, :])
                if hazard is not None:
                    score = score + risk_row
                h = torch.where(fit, score, inf).argmin(1)
            else:  # opportunistic: uniform among fits, Weyl-rotated per tick
                if hazard is not None:  # the least-risk tier of fits
                    rmin = torch.where(fit, risk_row, inf).amin(1)
                    fit = fit & (risk_row == rmin[:, None])
                u_eff = torch.fmod(u_p[:, j] + weyl_rot, 1.0)
                n_fit = fit.sum(1)
                k = torch.minimum((u_eff * n_fit.to(dtype)).to(torch.int64),
                                  n_fit - 1)
                rank = torch.cumsum(fit, 1) - 1
                h = _first_true(fit & (rank == k[:, None]))
            ok = fit.any(1) & (n_ready > j)
            place_row(avail, demand, h, ok)
            at = order[:, j:j + 1]
            pl.scatter_(1, at, torch.where(ok, h, -1)[:, None])
            d_j = cd[rep, g, host_zone[h]]
            delay.scatter_(1, at, torch.where(ok, d_j, zero)[:, None])
        placed = pl >= 0
        if lifo:
            # Wait-queue carry: an unplaced ready task re-enters at its
            # position in the policy's schedule-return order.
            if policy == "first-fit":
                sord = _lexsort(((~ready).long(), (-dem_norms).expand(R, T),
                                 brank), iota_r)
                srank = _inverse(sord, iota_r)
            else:
                srank = brank
            qpos = torch.where(live, torch.where(ready & ~placed, srank, -1),
                               qpos)

        if congestion:
            # 5c. The pipes: this tick's placements in task-index order
            #     per replica (at most n_steps each), their pull volumes,
            #     the congested delay (never below the static bound),
            #     then the drain.  A frozen replica's pipes stay as they
            #     are.
            cand = order[:, :n_steps]
            tasks = torch.sort(torch.where(pl.gather(1, cand) >= 0, cand, T),
                               1).values  # [R, n], T on padding
            valid = tasks < T
            tc = tasks.clamp(max=max(T - 1, 0))
            vols = _pull_volumes(pull_frac, hv_g if pairs else zc)
            vol = vols[rep[:, None], group_of.gather(1, tc)]  # [R, n, S]
            vol = torch.where(valid[..., None], vol, zero)
            q_next, cong = _pipe_step(q, vol, pl.gather(1, tc).clamp(min=0),
                                      valid, inv_pipe, neg_bw, tick_t)
            q = torch.where(alive[:, None, None], q_next, q)
            d_pad = torch.cat([delay, delay.new_zeros((R, 1))], 1)
            d_pad.scatter_(1, tasks, torch.maximum(d_pad.gather(1, tasks),
                                                    cong))
            delay = d_pad[:, :T]

        stage = torch.where(placed, _RUNNING, stage)
        place = torch.where(placed, pl, place)
        finish = torch.where(placed, (t[:, None] + delay) + runtime, finish)

        # 6. Busy-host integral: per host, the latest resident finish
        #    within this window (a max: exact in any order).
        running = stage == _RUNNING
        contrib = torch.where(
            running, torch.clamp(finish - t[:, None], 0.0, tick), zero)
        slot = rep[:, None] * H + place.clamp(0, H - 1)  # misses add max 0
        busy_host = torch.zeros(R * H, dtype=dtype, device=dev)
        busy_host.scatter_reduce_(0, slot.reshape(-1), contrib.reshape(-1),
                                  "amax", include_self=True)
        busy = torch.where(
            alive, busy + _ordered_sum(busy_host.reshape(R, H)), busy)
        t = torch.where(alive, t + tick_t, t)
        alive = alive_next
        go = bool(go_next)  # graftcheck: ignore[host-sync] -- a host int of the tick's one read above
        counts["ticks"] += 1
        counts["place_steps"] += n_steps
        i += 1
    if graph is not None:
        # The chain's buffer belongs to the snapshot graph, which the
        # next rollout of this layout reuses: the state owns a copy.
        avail = avail.clone()
        SNAPSHOT_GRAPHS.give(graph)
    return RolloutState(t, stage, finish, place, avail, busy, q, qpos)
