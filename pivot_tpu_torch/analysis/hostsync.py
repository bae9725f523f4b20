"""Host-sync lint for the fused device hot paths.

Port of ``pivot_tpu/analysis/hostsync.py``.  The dispatch floor creeps
back in through ONE line of code: a host synchronisation inside a device
loop body — each forces a device→host round trip per iteration and
turns a launch queue the host runs ahead of into one it waits on.  On
the card the port's span driver promises no host read inside a span
(PERF.md §6); this pass holds that promise statically.

Hot bodies are found by **naming convention** (:data:`DISCOVER`), as in
the reference: every top-level function matching a hot-path pattern in
the registered files is a lint target the moment it is written, and
:data:`REQUIRED` keeps the rename protection.  ``ops/shard.py``'s
sharded passes, reduces and span driver are targets as in the reference
(``pivot_tpu/ops/shard.py:88-89``).

Banned constructs (in a discovered body, nested closures included):
the reference's — ``.block_until_ready()`` / ``.item()`` /
``.tolist()``, numpy host materialisation (``np.asarray`` /
``np.array`` / …), ``jax.device_get``, ``float`` / ``int`` / ``bool`` on
a non-literal, and ``print`` — and their torch forms: ``.cpu()``,
``.numpy()`` and ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import ast
import fnmatch
from typing import Dict, List, NamedTuple, Sequence, Tuple

from pivot_tpu_torch.analysis import Finding, SourceFile

RULE = "host-sync"

#: repo-relative file → fnmatch patterns of top-level hot-path bodies.
DISCOVER: Dict[str, Tuple[str, ...]] = {
    "pivot_tpu_torch/ops/kernels.py": (
        "*_impl", "_*_scan", "_slim_drive", "_chunk_drive",
        "_speculate_commit", "_ca_*",
    ),
    "pivot_tpu_torch/ops/tickloop.py": (
        # The span tick (solo and G-row spans), the batched span driver
        # and the resident span run: a host read inside any of them
        # would fetch device state every tick of a span.
        "_span_*", "fused_tick_run_rows", "resident_span_run",
    ),
    "pivot_tpu_torch/ops/shard.py": (
        # The sharded passes and chunk drives, the two-stage reduces, the
        # sharded span drivers (solo, [G]-batched, resident) and the
        # batched twins' row loop.
        "*_sharded_pass", "*_sharded_chunk*", "_sharded_chunk_drive",
        "_two_stage_argmin", "_first_index_of", "_opportunistic_pick",
        "_risk_restrict_sharded", "_place_local", "_bump_local",
        "sharded_fused_tick_run", "sharded_batched_tick_run",
        "sharded_resident_span_run", "_batched_rows", "_set_rows_local",
        # Elastic meshes add no device body (``pivot_tpu/analysis/
        # hostsync.py:64-71``): every rung reuses the bodies above.  The
        # ``elastic_*`` / ``mesh_shape_ladder`` helpers are host-side on
        # purpose (a fold exports the carry) and stay out of the
        # patterns.
    ),
    # The tick body and its plain placement chain (the reference's one
    # body: ``_chain_plain`` is its step loop, lifted out for the hand
    # kernel's route).
    "pivot_tpu_torch/parallel/ensemble/tick.py": ("_rollout_segment",
                                                  "_chain_plain"),
    # The reference's ``*_impl`` bodies are the port's eager functions.
    "pivot_tpu_torch/search/fitness.py": ("_fitness_rows", "_draw_rows"),
}

#: Anchor bodies that MUST be discovered per file — a rename that
#: dodges the patterns is flagged instead of silently dropping out.
REQUIRED: Dict[str, Tuple[str, ...]] = {
    "pivot_tpu_torch/ops/kernels.py": (
        "opportunistic_impl", "first_fit_impl", "best_fit_impl",
        "cost_aware_impl", "_speculate_commit", "_slim_drive",
    ),
    "pivot_tpu_torch/ops/tickloop.py": (
        "_span_tick", "fused_tick_run_rows", "resident_span_run",
    ),
    "pivot_tpu_torch/ops/shard.py": (
        "_two_stage_argmin", "_cost_aware_sharded_pass",
        "sharded_fused_tick_run", "sharded_batched_tick_run",
        "sharded_resident_span_run",
    ),
    "pivot_tpu_torch/parallel/ensemble/tick.py": ("_rollout_segment",),
    "pivot_tpu_torch/search/fitness.py": ("_fitness_rows",),
}

_SYNC_ATTRS = {"block_until_ready", "item", "tolist", "cpu", "numpy"}
_NUMPY_ALIASES = {"np", "numpy", "onp"}
_NUMPY_HOST_FNS = {"asarray", "array", "copyto", "savetxt"}
_COERCIONS = {"float", "int", "bool"}


class Violation(NamedTuple):
    """One violation inside a named body (the reference's shape)."""

    path: str
    func: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: in {self.func}(): {self.message}"


def _is_literal(node: ast.AST) -> bool:
    """Constant-ish argument — coercing it cannot touch a device value.
    Covers signed numeric literals (``-1`` parses as UnaryOp(USub,
    Constant))."""
    if isinstance(node, ast.UnaryOp) and isinstance(
        node.op, (ast.USub, ast.UAdd)
    ):
        return _is_literal(node.operand)
    return isinstance(node, ast.Constant)


def _check_call(node: ast.Call, path: str, func: str) -> List[Violation]:
    out: List[Violation] = []
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr in _SYNC_ATTRS:
            out.append(Violation(
                path, func, node.lineno,
                f"host-sync call .{f.attr}() inside a fused hot path",
            ))
        elif (
            isinstance(f.value, ast.Name)
            and f.value.id in _NUMPY_ALIASES
            and f.attr in _NUMPY_HOST_FNS
        ):
            out.append(Violation(
                path, func, node.lineno,
                f"host materialization {f.value.id}.{f.attr}(...) inside "
                "a fused hot path",
            ))
        elif (
            f.attr == "synchronize"
            and isinstance(f.value, ast.Attribute)
            and f.value.attr == "cuda"
            and isinstance(f.value.value, ast.Name)
            and f.value.value.id == "torch"
        ):
            out.append(Violation(
                path, func, node.lineno,
                "torch.cuda.synchronize() inside a fused hot path",
            ))
        elif (
            isinstance(f.value, ast.Name)
            and f.value.id == "jax"
            and f.attr == "device_get"
        ):
            out.append(Violation(
                path, func, node.lineno,
                "jax.device_get(...) inside a fused hot path",
            ))
    elif isinstance(f, ast.Name):
        if f.id in _COERCIONS and node.args and not all(
            _is_literal(a) for a in node.args
        ):
            out.append(Violation(
                path, func, node.lineno,
                f"scalar coercion {f.id}(...) on a non-literal inside a "
                "fused hot path (blocks on the traced value)",
            ))
        elif f.id == "print":
            out.append(Violation(
                path, func, node.lineno,
                "print(...) inside a fused hot path (stringification "
                "fetches)",
            ))
    return out


def lint_tree(
    tree: ast.AST, path: str, func_names: Sequence[str]
) -> List[Violation]:
    """Scan the named function bodies (nested closures included) of a
    parsed module.  A registered name that does not exist is itself a
    violation — a silently renamed hot path would otherwise drop out of
    coverage without anyone noticing."""
    found: set = set()
    out: List[Violation] = []
    for node in ast.walk(tree):
        if (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name in func_names
        ):
            found.add(node.name)
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    out.extend(_check_call(sub, path, node.name))
    for missing in sorted(set(func_names) - found):
        out.append(Violation(
            path, missing, 0,
            "registered hot-path function not found — update the "
            "hot-path registration after renames",
        ))
    return out


def discover_targets(src: SourceFile, patterns: Sequence[str]) -> List[str]:
    """Top-level function names matching the hot-path patterns, in
    definition order."""
    return [
        node.name
        for node in src.tree.body
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        and any(fnmatch.fnmatchcase(node.name, p) for p in patterns)
    ]


#: Union of every per-file pattern — used to sweep ops files the
#: DISCOVER dict does not know yet: a hot-path-shaped body in a NEW
#: file must be flagged for registration, not silently skipped (every
#: recent backend PR introduced its bodies in a new file).
_ALL_PATTERNS = tuple(
    sorted({p for pats in DISCOVER.values() for p in pats})
)


def collect(cache) -> Tuple[List[Finding], List[str]]:
    import os

    out: List[Finding] = []
    scanned: List[str] = []
    ops_dir = os.path.join(cache.root, "pivot_tpu_torch/ops")
    if os.path.isdir(ops_dir):
        for name in sorted(os.listdir(ops_dir)):
            rel = f"pivot_tpu_torch/ops/{name}"
            if not name.endswith(".py") or rel in DISCOVER:
                continue
            src = cache.get(rel)
            if src is None:
                continue
            scanned.append(rel)
            for fn in discover_targets(src, _ALL_PATTERNS):
                out.append(Finding(
                    RULE, rel, 1,
                    f"hot-path-shaped body {fn}() in a file the lint "
                    f"does not cover — add {rel} to "
                    "pivot_tpu_torch/analysis/hostsync.py DISCOVER",
                ))
    for rel, patterns in DISCOVER.items():
        src = cache.get(rel)
        if src is None:
            out.append(Finding(
                RULE, rel, 0,
                f"registered hot-path file {rel} is missing — renamed/"
                "deleted? update hostsync DISCOVER/REQUIRED (its bodies "
                "lost all lint coverage)",
            ))
            continue
        scanned.append(rel)
        names = discover_targets(src, patterns)
        if not names:
            out.append(Finding(
                RULE, rel, 1,
                "no hot-path bodies discovered — the naming patterns "
                "match nothing; update pivot_tpu_torch/analysis/hostsync.py",
            ))
        missing = [
            name for name in REQUIRED.get(rel, ()) if name not in names
        ]
        for name in missing:
            out.append(Finding(
                RULE, rel, 1,
                f"required hot-path body {name}() not discovered — "
                "renamed away from the conventions? update REQUIRED/"
                "DISCOVER in pivot_tpu_torch/analysis/hostsync.py",
            ))
        for v in lint_tree(src.tree, rel, names):
            out.append(Finding(RULE, v.path, v.line, v.message))
    return out, scanned
