"""Cost attribution over the port's device entry points.

Port of ``pivot_tpu/obs/costattr.py``.  ``analysis/entrymap.py`` knows
every place the port's Python crosses into work on the card.  This
module closes the measurement loop: for each entry point it either
*measures* the call at a small canonical shape or carries an explicit
*flag* explaining why that site has no standalone attribution.

**Register-or-flag** (the reference's convention):
:func:`coverage_problems` diffs the entry map's discovery against
:data:`ENTRY_POINTS` both ways, and every key of the reference's
manifest has a port row in :data:`REFERENCE` — the port's entry point
that stands for it, or a flag with the reason.

How a row is measured.  XLA's ``cost_analysis()`` has no torch
counterpart, so the torch forms are walked under a
``TorchDispatchMode``:

  * ``ops`` — aten ops dispatched that do work (views, allocations and
    scalar reads left out): on the card, the launches of the call;
  * ``bytes`` — input plus output bytes of those ops;
  * ``flops`` — output elements of the arithmetic ops (compares and
    selects included, as the work model counts them).

On the card a row adds ``device_ms``: the median of 5 CUDA-event-timed
calls after a warm-up call.  The hand kernels ``greedy_place`` and
``carry_free_place`` are opaque to the walk: on the CPU their rows are
flagged (their time is the card's CUDA events, their budget the
``kernel-budget`` pass); on the card they are timed by CUDA events —
``greedy_place`` at R = 1, R = 4 and per-row G = 2, ``carry_free_place``
for each arm at R = 1 and for First-Fit and Best-Fit at R = 4 — and
each launch is held against its plain version (``max_abs_err``).

Measured rows are joined against ``infra/roofline.py::placement_cost``
at the same shape (``analytic_flops`` / ``analytic_bytes``,
``flops_vs_model`` / ``bytes_vs_model``), the reference's join: the
ratios are recorded, not gated.
"""

from __future__ import annotations

import functools
import statistics
from typing import Callable, Dict, List, Tuple

__all__ = [
    "ENTRY_POINTS",
    "REFERENCE",
    "coverage_problems",
    "cost_attribution",
]

#: Canonical measurement shape (the reference's).
_T, _H = 32, 16
#: Replicas of the batched forms, rows of the per-row form, ticks of a
#: span (the reference's span rows model T · 4 steps), logical host
#: shards of the sharded forms.
_R, _G, _K, _S = 4, 2, 4, 4
_KERNELS = "pivot_tpu_torch/ops/kernels.py"
_TICKLOOP = "pivot_tpu_torch/ops/tickloop.py"
_SHARD = "pivot_tpu_torch/ops/shard.py"
_CUDA = "pivot_tpu_torch/ops/cuda_kernels.py"
_REF_KERNELS = "pivot_tpu/ops/kernels.py"
_REF_TICKLOOP = "pivot_tpu/ops/tickloop.py"
_REF_SHARD = "pivot_tpu/ops/shard.py"
_REF_PALLAS = "pivot_tpu/ops/pallas_kernels.py"
_REF_ENS = "pivot_tpu/parallel/ensemble"


def _operands(T: int, H: int, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=device)
    avail = torch.as_tensor(rng.uniform(2.0, 8.0, (H, 4)), **f32)
    dem = torch.as_tensor(rng.uniform(0.1, 1.0, (T, 4)), **f32)
    u = torch.as_tensor(rng.uniform(size=T), **f32)
    i32 = dict(dtype=torch.int32, device=device)
    return dict(
        avail=avail, dem=dem, u=u,
        valid=torch.ones(T, dtype=torch.bool, device=device),
        ng=torch.as_tensor(np.arange(T) % 4 == 0, device=device),
        az=torch.zeros(T, **i32),
        cost=torch.ones((2, 2), **f32), bw=torch.ones((2, 2), **f32),
        hz=torch.zeros(H, **i32), counts=torch.zeros(H, **i32),
        totals=avail.sum(0),
        arrive=torch.as_tensor(np.arange(T) % _K, **i32),
    )


def _ca_args(o):
    return (o["avail"], o["dem"], o["valid"], o["ng"], o["az"], o["cost"],
            o["bw"], o["hz"], o["counts"])


_CA_KW = dict(bin_pack="first-fit", sort_hosts=True, host_decay=False)


def _b_ref(name):
    def build(o):
        from pivot_tpu_torch.ops import kernels as k

        fn = getattr(k, name)
        if name.startswith("cost_aware"):
            return lambda: fn(*_ca_args(o), **_CA_KW)
        args = (o["avail"], o["dem"], o["valid"])
        if name.startswith("opportunistic"):
            return lambda: fn(*args, o["u"])
        if name.startswith("first_fit"):
            return lambda: fn(*args, strict=False)
        return lambda: fn(*args)
    return build


def _b_impl(name, form=None):
    """The two-phase ``name`` (or ``form(o)``, called as it is)."""
    def build(o):
        from pivot_tpu_torch.ops import kernels as k

        fn = getattr(k, name) if form is None else form(o)
        if name.startswith("cost_aware"):
            return lambda: fn(*_ca_args(o), **_CA_KW, totals=o["totals"],
                              phase2="auto")
        args = (o["avail"], o["dem"], o["valid"])
        if name.startswith("opportunistic"):
            return lambda: fn(*args, o["u"], phase2="auto")
        kw = dict(totals=o["totals"], phase2="auto")
        if name.startswith("first_fit"):
            kw["strict"] = False
        return lambda: fn(*args, **kw)
    return build


def _sharded_form(name):
    """``o`` → the 1-D host-sharded form ``name`` bound to a mesh of
    ``_S`` logical shards on the operands' device."""
    def form(o):
        from pivot_tpu_torch.ops import shard
        from pivot_tpu_torch.parallel.mesh import host_sharded_mesh

        return functools.partial(
            getattr(shard, name),
            host_sharded_mesh(devices=[o["avail"].device] * _S))
    return form


def _mesh_2d(device):
    """A ``replica × host`` mesh of ``_G`` × ``_S`` logical shards."""
    from pivot_tpu_torch.parallel.mesh import build_hybrid_mesh

    return build_hybrid_mesh(host_parallel=_S, devices=[device] * (_G * _S))


def _rows_of(o) -> dict:
    """``o``'s operands stacked to ``_G`` rows."""
    import torch

    return {k: torch.stack([v] * _G) for k, v in o.items()}


def _b_sharded_batched(stem):
    """The ``[G]``-batched 2-D twin of ``{stem}_impl`` on ``_G`` rows."""
    def build(o):
        from pivot_tpu_torch.ops import shard

        fn = functools.partial(
            getattr(shard, f"{stem}_kernel_sharded_batched"),
            _mesh_2d(o["avail"].device))
        return _b_impl(f"{stem}_impl", lambda _o: fn)(_rows_of(o))
    return build


def _b_sharded_span_rows(o):
    from pivot_tpu_torch.ops.shard import sharded_batched_tick_run

    r, mesh = _rows_of(o), _mesh_2d(o["avail"].device)
    return lambda: sharded_batched_tick_run(
        mesh, r["avail"], r["dem"], r["arrive"], [_K] * _G,
        policy="first-fit", n_ticks=_K)


def _b_sharded_resident(o):
    from pivot_tpu_torch.ops.shard import (
        sharded_resident_carry_init,
        sharded_resident_span_run,
    )
    from pivot_tpu_torch.parallel.mesh import host_sharded_mesh

    mesh = host_sharded_mesh(devices=[o["avail"].device] * _S)
    carry = sharded_resident_carry_init(mesh, o["avail"])
    return lambda: sharded_resident_span_run(
        mesh, carry, o["dem"], o["arrive"], _K, policy="first-fit",
        n_ticks=_K)


def _b_batched(name):
    def build(o):
        from pivot_tpu_torch.ops import kernels as k

        fn = getattr(k, name)
        avail_r = o["avail"].expand(_R, -1, -1).contiguous()
        return lambda: fn(avail_r, o["dem"], o["valid"])
    return build


def _b_fused(o, form=None):
    from pivot_tpu_torch.ops.tickloop import fused_tick_run

    run = fused_tick_run if form is None else form(o)
    return lambda: run(o["avail"], o["dem"], o["arrive"], _K,
                       policy="first-fit", n_ticks=_K)


def _b_resident(o):
    from pivot_tpu_torch.ops.tickloop import (
        resident_carry_init,
        resident_span_run,
    )

    carry = resident_carry_init(o["avail"])
    return lambda: resident_span_run(
        carry, o["dem"], o["arrive"], _K, policy="first-fit", n_ticks=_K)


#: The carry-free kernel's forms: key → (wrapper, plain version, arm
#: operands beyond (avail, dem, valid), replicas).
_CF_FORMS = {
    "cf_opportunistic": ("opportunistic_cuda", "opportunistic_plain", 1),
    "cf_first_fit": ("first_fit_cuda", "first_fit_plain", 1),
    "cf_best_fit": ("best_fit_cuda", "best_fit_plain", 1),
    "cf_first_fit_r4": ("first_fit_cuda_batched", "first_fit_plain_batched",
                        _R),
    "cf_best_fit_r4": ("best_fit_cuda_batched", "best_fit_plain_batched",
                       _R),
}


#: The hand kernels' launch forms: (wrapper, plain version, operands,
#: keywords, replicas or rows).
def _kernel_form(key: str, o):
    import torch

    from pivot_tpu_torch.ops import cuda_kernels as ck

    if key in _CF_FORMS:
        wrapper, plain, R = _CF_FORMS[key]
        avail = (o["avail"] if R == 1
                 else o["avail"].expand(R, -1, -1).contiguous())
        args = (avail, o["dem"], o["valid"])
        if key == "cf_opportunistic":
            args += (o["u"],)
        kw = {"strict": False} if "first_fit" in key else {}
        return getattr(ck, wrapper), getattr(ck, plain), args, kw, R
    args = _ca_args(o)
    if key == "r1":
        return ck.cost_aware_cuda, ck.cost_aware_plain, args, _CA_KW, 1
    if key == "r4":
        a_r = args[0].expand(_R, -1, -1).contiguous()
        return (ck.cost_aware_cuda_batched, ck.cost_aware_plain_batched,
                (a_r, *args[1:]), _CA_KW, _R)
    rows = tuple(torch.stack([a] * _G).contiguous() for a in args)
    return ck.cost_aware_cuda_rows, ck.cost_aware_plain_rows, rows, \
        _CA_KW, _G


#: key → (builder of a no-argument call, work-model kind, model R,
#: model steps factor).
_BUILDERS: Dict[str, Tuple[Callable, str, int, int]] = {
    **{f"{s}_kernel_ref": (_b_ref(f"{s}_kernel_ref"), "scan", 1, 1)
       for s in ("opportunistic", "first_fit", "best_fit", "cost_aware")},
    **{f"{s}_impl": (_b_impl(f"{s}_impl"), "slim", 1, 1)
       for s in ("opportunistic", "first_fit", "best_fit", "cost_aware")},
    **{f"{s}_batched": (_b_batched(f"{s}_batched"), "slim", _R, 1)
       for s in ("first_fit", "best_fit")},
    "fused_tick_run": (_b_fused, "scan", 1, _K),
    "resident_span_run": (_b_resident, "scan", 1, _K),
    **{f"{s}_kernel_sharded": (
        _b_impl(f"{s}_impl", _sharded_form(f"{s}_kernel_sharded")), "slim",
        1, 1)
       for s in ("opportunistic", "first_fit", "best_fit", "cost_aware")},
    "sharded_fused_tick_run": (
        functools.partial(_b_fused,
                          form=_sharded_form("sharded_fused_tick_run")),
        "scan", 1, _K),
    **{f"{s}_kernel_sharded_batched": (_b_sharded_batched(s), "slim", _G, 1)
       for s in ("opportunistic", "first_fit", "best_fit", "cost_aware")},
    "sharded_batched_tick_run": (_b_sharded_span_rows, "scan", _G, _K),
    "sharded_resident_span_run": (_b_sharded_resident, "scan", 1, _K),
}

_KERNEL_FLAG = (
    "the hand kernels (greedy_place, carry_free_place) are opaque to the "
    "dispatch walk: their time is the card's CUDA events, their budget "
    "the kernel-budget pass (pivot_tpu_torch/analysis/kernel_budget.py)"
)


def measure(key: str) -> Tuple[str, str]:
    if key not in _BUILDERS:
        raise KeyError(key)
    return ("measure", key)


def kernel(key: str) -> Tuple[str, str]:
    """The hand kernel's row: timed on the card, flagged on the CPU."""
    return ("kernel", key)


def flag(reason: str) -> Tuple[str, str]:
    return ("flag", reason)


#: Every entry point of ``analysis/entrymap.py``: measured, the hand
#: kernel, or flagged with the reason it has no standalone row.
ENTRY_POINTS: Dict[Tuple[str, str], Tuple[str, str]] = {
    **{(_KERNELS, k): measure(k) for k in _BUILDERS
       if k not in ("fused_tick_run", "resident_span_run")
       and "sharded" not in k},
    **{(_SHARD, k): measure(k) for k in _BUILDERS if "sharded" in k},
    (_TICKLOOP, "fused_tick_run"): measure("fused_tick_run"),
    (_TICKLOOP, "resident_span_run"): measure("resident_span_run"),
    (_TICKLOOP, "reference_tick_run"): flag(
        "the sequential span referee: a host loop of the per-tick forms "
        "(their rows), the tests' oracle for fused_tick_run"
    ),
    (_TICKLOOP, "fused_tick_run_rows"): flag(
        "G span rows: Cost-Aware rows are one per-row greedy_place "
        "launch a tick (the cost_aware_cuda_rows row), the torch arms "
        "run fused_tick_run row after row (G x its row)"
    ),
    (_CUDA, "cost_aware_cuda"): kernel("r1"),
    (_CUDA, "cost_aware_cuda_batched"): kernel("r4"),
    (_CUDA, "cost_aware_cuda_rows"): kernel("rows"),
    (_CUDA, "opportunistic_cuda"): kernel("cf_opportunistic"),
    (_CUDA, "first_fit_cuda"): kernel("cf_first_fit"),
    (_CUDA, "best_fit_cuda"): kernel("cf_best_fit"),
    (_CUDA, "first_fit_cuda_batched"): kernel("cf_first_fit_r4"),
    (_CUDA, "best_fit_cuda_batched"): kernel("cf_best_fit_r4"),
    ("pivot_tpu_torch/sched/cuda.py", "CudaCostAwarePolicy._greedy"): flag(
        "the Cost-Aware policy's bound call of cost_aware_cuda (its "
        "topology fixed) — see the cost_aware_cuda row"
    ),
    (_CUDA, "ensemble_chain_cuda"): flag(
        "the ensemble rollout's placement chain (the hand kernel "
        "ensemble_chain, one launch a tick for every replica): timed at "
        "its real shape (R = 1024, 600 hosts) by CUDA events in "
        "chip_smoke.py phase 20 and inside the rollouts of phases 6-9"
    ),
    ("pivot_tpu_torch/parallel/ensemble/tick.py",
     "_SnapshotGraphs._capture"): flag(
        "the plain chain's norm-snapshot CUDA graph (float64 rollouts on "
        "the card; float32 ones snapshot inside ensemble_chain): its "
        "replays are part of the rollout; its captures are counted by "
        "utils/compile_counter.py (graph_capture)"
    ),
}

_ENSEMBLE = (
    "the ensemble rollout (parallel/ensemble): torch passes attributed at "
    "their real shape by chip_smoke.py phases 6-9 (CUDA events, the "
    "profiler's busy share)"
)

#: Every key of ``pivot_tpu/obs/costattr.py::ENTRY_POINTS`` → the port's
#: entry point that stands for it, or a flag with the reason.
REFERENCE: Dict[Tuple[str, str], object] = {
    **{(_REF_KERNELS, f"{s}_kernel_ref"): (_KERNELS, f"{s}_kernel_ref")
       for s in ("opportunistic", "first_fit", "best_fit", "cost_aware")},
    **{(_REF_KERNELS, f"{s}_kernel"): (_KERNELS, f"{s}_impl")
       for s in ("opportunistic", "first_fit", "best_fit", "cost_aware")},
    (_REF_TICKLOOP, "_fused_tick_run"): (_TICKLOOP, "fused_tick_run"),
    (_REF_TICKLOOP, "_resident_span_run"): (_TICKLOOP, "resident_span_run"),
    (_REF_TICKLOOP, "_resident_carry_init"): flag(
        "ops/tickloop.py::resident_carry_init: O(H) carry staging, one "
        "call a bind — not a device entry point of its own"
    ),
    (_REF_TICKLOOP, "_resident_carry_clone"): flag(
        "ops/tickloop.py::resident_carry_clone: O(H) device copies before "
        "a spliceable span — dwarfed by the span it brackets"
    ),
    **{(_REF_SHARD, f"_{s}_sharded_fn"): (_SHARD, f"{s}_kernel_sharded")
       for s in ("opportunistic", "first_fit", "best_fit", "cost_aware")},
    (_REF_SHARD, "_sharded_span_fn"): (_SHARD, "sharded_fused_tick_run"),
    **{(_REF_SHARD, f"_{s}_sharded_batched_fn"):
       (_SHARD, f"{s}_kernel_sharded_batched")
       for s in ("opportunistic", "first_fit", "best_fit", "cost_aware")},
    (_REF_SHARD, "_sharded_span_batched_fn"):
        (_SHARD, "sharded_batched_tick_run"),
    (_REF_SHARD, "_sharded_resident_span_fn"):
        (_SHARD, "sharded_resident_span_run"),
    (_REF_SHARD, "_sharded_resident_init_fn"): flag(
        "ops/shard.py::sharded_resident_carry_init: O(H) carry staging, "
        "one call a bind — not a device entry point of its own"
    ),
    (_REF_PALLAS, "cost_aware_pallas"): (_CUDA, "cost_aware_cuda"),
    (_REF_PALLAS, "cost_aware_pallas_batched"):
        (_CUDA, "cost_aware_cuda_batched"),
    ("pivot_tpu/sched/tpu.py", "f"): flag(
        "the x + 1 latency probe: the port's is sched/cuda.py's floor "
        "probe (plain torch ops and a fetch) — its cost IS the dispatch "
        "floor"
    ),
    ("pivot_tpu/obs/profiler.py", "f"): flag(
        "the profiler's x + 1 floor probe — same trivial program as the "
        "sched probe"
    ),
    ("pivot_tpu/sched/batch.py", "_batched_fn"): flag(
        "the vmap of a placement kernel over a flush's G runs: the port "
        "launches one per-row greedy_place (the cost_aware_cuda_rows row) "
        "or runs the torch arms' rows in sequence"
    ),
    (f"{_REF_ENS}/__init__.py", "_sharded_rollout_fn"): flag(
        "parallel/ensemble/__init__.py::sharded_rollout: the rollout's "
        "[R] batch in row blocks over the replica mesh, the unsharded "
        "tick loop on one card (chip_smoke.py phase 16 (a), (b))"
    ),
    (f"{_REF_ENS}/__init__.py", "shard_sweep"): flag(
        "parallel/ensemble/__init__.py::shard_sweep: a sweep's replica "
        "axis in row blocks over the replica mesh, the unsharded row "
        "runner on one card (chip_smoke.py phase 16 (d))"
    ),
    **{(f"{_REF_ENS}/{f}", n): flag(_ENSEMBLE) for f, n in (
        ("__init__.py", "_rollout_states"),
        ("checkpoint.py", "_segment_step"),
        ("checkpoint.py", "_segment_step_carry"),
        ("sweeps.py", "_row_segment_step"),
        ("sweeps.py", "_row_segment_step_carry"),
        ("bill.py", "_finalize_batch"),
    )},
    ("pivot_tpu/search/fitness.py", "_draw_rows"): flag(
        "search/fitness.py::_draw_rows: the per-generation draws, "
        "negligible beside the population rollout (chip_smoke.py phase 8)"
    ),
    ("pivot_tpu/search/fitness.py", "_fitness_rows"): flag(
        "search/fitness.py::_fitness_rows: the population's rollout rows, "
        "attributed at scale by chip_smoke.py phase 8 (generations/s)"
    ),
    ("pivot_tpu/search/fitness.py", "_sharded_fitness_fn"): flag(
        "search/fitness.py::evaluate_rows(backend='sharded_rollout'): the "
        "population's rows in blocks over the replica mesh — _fitness_rows' "
        "program, attributed at scale by chip_smoke.py phases 8 and 16 (c)"
    ),
}


def coverage_problems() -> List[str]:
    """Register-or-flag diff of the entry map's discovery against
    :data:`ENTRY_POINTS` (empty = every entry point has a cost story).
    Pure AST work — no torch import."""
    from pivot_tpu_torch.analysis import _Cache, repo_root
    from pivot_tpu_torch.analysis.entrymap import collect_entries

    entries, findings, _scanned = collect_entries(_Cache(repo_root()))
    problems = [str(f) for f in findings]
    discovered = {(e.path, e.name) for es in entries.values() for e in es}
    for key in sorted(discovered - set(ENTRY_POINTS)):
        problems.append(
            f"entry point {key[1]} ({key[0]}) has no cost-attribution "
            "entry — add it to pivot_tpu_torch/obs/costattr.py "
            "ENTRY_POINTS (measure or flag with a reason)"
        )
    for key in sorted(set(ENTRY_POINTS) - discovered):
        problems.append(
            f"stale cost-attribution entry {key[1]} ({key[0]}): no such "
            "entry point — renamed/deleted? update ENTRY_POINTS"
        )
    for ref, port in sorted(REFERENCE.items()):
        if port[0] != "flag" and port not in ENTRY_POINTS:
            problems.append(
                f"reference entry {ref[1]} ({ref[0]}) maps to {port[1]} "
                f"({port[0]}), which is not an entry point"
            )
    return problems


_NO_LAUNCH = {
    "view", "_unsafe_view", "_reshape_alias", "expand", "permute",
    "transpose", "t", "select", "slice", "unsqueeze", "squeeze", "alias",
    "detach", "as_strided", "split", "split_with_sizes", "unbind",
    "narrow", "lift_fresh", "diagonal", "unfold", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "_local_scalar_dense",
    "is_nonzero", "sym_size", "sym_stride", "sym_numel",
}
_ARITH = {
    "add", "sub", "rsub", "mul", "div", "sqrt", "rsqrt", "neg", "abs",
    "reciprocal", "pow", "exp", "log", "log1p", "minimum", "maximum",
    "clamp", "clamp_min", "clamp_max", "where", "lt", "le", "gt", "ge",
    "eq", "ne", "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor", "sum",
    "amax", "amin", "max", "min", "argmax", "argmin", "cumsum", "mm",
    "bmm", "addmm", "fmod", "remainder", "floor_divide", "any", "all",
    "addcmul", "lerp", "sign", "floor", "ceil", "trunc", "mean", "prod",
    "index_add", "scatter_add", "scatter_reduce", "masked_fill",
    "nonzero", "sort", "topk", "cumprod", "fma",
}


def _walk(call) -> Dict[str, float]:
    """``call()`` under a dispatch walk: ops, bytes, flops."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    def nbytes(x) -> int:
        return sum(t.numel() * t.element_size() for t in tree_flatten(x)[0]
                   if isinstance(t, torch.Tensor))

    class Walk(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = self.bytes = self.flops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name not in _NO_LAUNCH:
                self.ops += 1
                self.bytes += nbytes((args, kwargs)) + nbytes(out)
                if name in _ARITH:
                    self.flops += sum(
                        t.numel() for t in tree_flatten(out)[0]
                        if isinstance(t, torch.Tensor))
            return out

    with Walk() as w:
        call()
    return {"ops": w.ops, "bytes": float(w.bytes), "flops": float(w.flops)}


def _device_ms(call, reps: int = 5, check=None) -> float:
    """Median of ``reps`` CUDA-event-timed calls after one warm-up.
    ``check``, when given, is called with each call's result (the
    warm-up's too) after its events have been read."""
    import torch

    out = call()
    if check is not None:
        check(out)
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        out = call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        if check is not None:
            check(out)
    return statistics.median(times)


def _join(row: dict, kind: str, T: int, H: int, R: int) -> dict:
    from pivot_tpu_torch.infra import roofline

    analytic = roofline.placement_cost(kind, T, H, R, dtype_bytes=4)
    row.update(kind=kind, analytic_flops=analytic["flops"],
               analytic_bytes=analytic["bytes"])
    if row.get("flops") and analytic["flops"]:
        row["flops_vs_model"] = round(row["flops"] / analytic["flops"], 4)
    if row.get("bytes") and analytic["bytes"]:
        row["bytes_vs_model"] = round(row["bytes"] / analytic["bytes"], 4)
    return row


def _kernel_row(key: str, o, T: int, H: int) -> dict:
    """One hand-kernel form on the card: CUDA-event time of the wrapper,
    its launches, its operand bytes, and every launch (the timed ones
    too) held against the plain version on the same inputs."""
    import torch

    from pivot_tpu_torch.ops import cuda_kernels as ck

    wrapper, plain, args, kw, R = _kernel_form(key, o)
    name = "carry_free_place" if key in _CF_FORMS else "greedy_place"
    p_p, a_p = plain(*args, **kw)
    errs, outs = [], []

    def check(out):
        p_k, a_k = out
        if not torch.equal(p_k, p_p) or not torch.allclose(
                a_k, a_p, rtol=1e-6, atol=1e-5):
            raise AssertionError(f"{name} {key}: launch differs from its "
                                 "plain version")
        errs.append(float((a_k - a_p).abs().max()))
        outs[:] = out

    n0 = ck.LAUNCHES[name]
    ms = _device_ms(lambda: wrapper(*args, **kw), check=check)
    io = sum(t.numel() * t.element_size() for t in args)
    io += sum(t.numel() * t.element_size() for t in outs)
    row = {"kernel": name, "form": key, "device_ms": ms,
           "launches": ck.LAUNCHES[name] - n0,
           "compared": len(errs), "bytes": float(io),
           "max_abs_err": max(errs)}
    return _join(row, "slim" if key in _CF_FORMS else "pallas_rb", T, H, R)


def cost_attribution(T: int = _T, H: int = _H, device: str = "cuda") -> dict:
    """Measure every manifest entry at the canonical shape on ``device``
    and join against the analytic work model.

    Returns ``{"t", "h", "backend", "device", "entries", "measured",
    "flagged", "coverage_problems", "complete", "rows": {name: row},
    "reference": {reference name: port name or {"flagged": reason}}}``.
    A measured row carries ``{path, kind, ops, bytes, flops,
    analytic_flops, analytic_bytes, flops_vs_model, bytes_vs_model}``
    (plus ``device_ms`` on the card); a hand-kernel row on the card
    ``{path, kernel, form, device_ms, launches, compared, bytes,
    max_abs_err, analytic_*}``; a flagged row ``{path, flagged: reason}``.
    ``complete``: every entry point and every reference entry has a row
    and no coverage problem or row error exists."""
    import torch

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    problems = coverage_problems()
    o = _operands(T, H, dev)
    rows: Dict[str, dict] = {}
    for (path, name), (kind, payload) in sorted(ENTRY_POINTS.items()):
        if kind == "flag" or (kind == "kernel" and not on_card):
            rows[name] = {"path": path,
                          "flagged": payload if kind == "flag"
                          else _KERNEL_FLAG}
            continue
        try:
            if kind == "kernel":
                rows[name] = {"path": path, **_kernel_row(payload, o, T, H)}
                continue
            build, model, R, k = _BUILDERS[payload]
            call = build(o)
            row = {"path": path, **_walk(call)}
            if on_card:
                row["device_ms"] = _device_ms(call)
            rows[name] = _join(row, model, T * k, H, R)
        except Exception as exc:  # noqa: BLE001 — row-level isolation
            rows[name] = {"path": path,
                          "error": f"{type(exc).__name__}: {exc}"[:200]}
            problems.append(f"cost attribution failed for {name}: {exc}")
    reference = {}
    for (rpath, rname), port in sorted(REFERENCE.items()):
        if port[0] == "flag":
            reference[rname] = {"path": rpath, "flagged": port[1]}
        else:
            reference[rname] = {"path": rpath, "port": port[1]}
    return {
        "t": T,
        "h": H,
        "backend": dev.type,
        "device": (torch.cuda.get_device_name(dev) if on_card else "cpu"),
        "entries": len(ENTRY_POINTS),
        "measured": sum(1 for r in rows.values() if "ops" in r
                        or "device_ms" in r),
        "flagged": sum(1 for r in rows.values() if "flagged" in r),
        "coverage_problems": problems,
        "complete": not problems,
        "rows": rows,
        "reference": reference,
    }
