"""profiler-boundary lint: where the dispatch profiler may hook in.

Port of ``pivot_tpu/analysis/profbound.py`` (``sched/tpu.py`` is the
port's ``sched/cuda.py``); the reference's text follows.

The sampled dispatch profiler (``pivot_tpu_torch/obs/profiler.py``, round 15)
is safe precisely because it brackets dispatches at the three
registered host↔device boundaries and nowhere else.  Every erosion mode
is one convenient line away:

  * a ``profiler.profile(...)`` call inside a jitted/Pallas body would
    trace once and lie (or force a host sync per iteration) — the same
    failure class the ``obs-boundary`` pass pins for tracer hooks;
  * a profiler hook at a NEW, unregistered call site would silently
    time something that is not a device dispatch (a lock wait, a
    batcher park) and poison the per-family census the regression
    tooling trusts;
  * the boundary bodies themselves could be renamed away, leaving the
    registry pointing at nothing while dispatches go unprofiled.

This pass enforces the register-or-flag discipline (the jitmap/parity
convention):

  * :data:`BOUNDARIES` is the registry of (file, function) bodies
    allowed to invoke the profiler's recording surface
    (``.profile(...)``).  Any ``*.profile(...)`` call in the package —
    outside ``pivot_tpu_torch/obs`` (the profiler's home) and
    ``pivot_tpu_torch/analysis`` (this suite) — that is not lexically inside
    a registered body is a finding;
  * every registered boundary body must still EXIST (rename
    protection — a silently renamed boundary drops out of coverage);
  * the device layer (``pivot_tpu_torch/ops/``) may not import
    ``pivot_tpu_torch.obs.profiler`` at all (explicit here even though the
    broader ``obs-boundary`` import pin also covers it: the finding
    message should name the profiler contract, not a generic one).

The wall-capture side needs no new rule: the profiler owns every
``time.*`` read (the ``determinism`` pass bans them in scope), and
``ObsClock`` ownership is already pinned by ``obs-boundary``.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Tuple

from pivot_tpu_torch.analysis import Finding, SourceFile

RULE = "profiler-boundary"

#: (repo-relative file) → function bodies allowed to call
#: ``profiler.profile(...)``.  ``_call_kernel`` is the per-policy
#: direct-dispatch rung (``place_span`` and the per-tick kernels both
#: route through it); ``_execute`` is the batcher flush's per-group
#: device call (``DispatchBatcher._flush`` delegates to it so the
#: profiled span nests inside the flush span).
#: ``_resident_dispatch`` is the resident tier's dispatch rung (round
#: 20): it cannot route through ``_call_kernel`` because the donated
#: carry must be threaded positionally and the returned carry captured
#: — but it brackets exactly one device call, same as the others.
#: In the port ``_profiled`` is the one bracket every ``sched/cuda.py``
#: dispatch goes through (``_call_kernel``, ``place_span`` and the
#: resident tier's ``_resident_dispatch`` call it).
BOUNDARIES: Dict[str, Tuple[str, ...]] = {
    "pivot_tpu_torch/sched/cuda.py": ("_call_kernel", "_profiled"),
    "pivot_tpu_torch/sched/batch.py": ("_execute",),
}

#: Package subtrees excluded from the call sweep: the profiler's home
#: (it calls itself) and this analysis suite (pattern strings in
#: checks/tests).
_EXEMPT_PREFIXES = ("pivot_tpu_torch/obs", "pivot_tpu_torch/analysis")

_SWEEP_ROOT = "pivot_tpu_torch"


def _profile_calls(src: SourceFile) -> List[Tuple[int, str]]:
    """(lineno, innermost enclosing function name) of every
    ``X.profile(...)`` call in the file ('<module>' at top level)."""
    out: List[Tuple[int, str]] = []

    def walk(node: ast.AST, func: str) -> None:
        for child in ast.iter_child_nodes(node):
            scope = func
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope = child.name
            if (
                isinstance(child, ast.Call)
                and isinstance(child.func, ast.Attribute)
                and child.func.attr == "profile"
            ):
                out.append((child.lineno, func))
            walk(child, scope)

    walk(src.tree, "<module>")
    return out


def _has_function(src: SourceFile, name: str) -> bool:
    return any(
        isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        and node.name == name
        for node in ast.walk(src.tree)
    )


def _scan_ops_imports(src: SourceFile) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(src.tree):
        hit = False
        if isinstance(node, ast.Import):
            hit = any(
                alias.name.startswith("pivot_tpu_torch.obs.profiler")
                for alias in node.names
            )
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            names = {alias.name for alias in node.names}
            hit = mod.startswith("pivot_tpu_torch.obs.profiler") or (
                mod == "pivot_tpu_torch.obs"
                and ("profiler" in names or "DispatchProfiler" in names)
            )
        if hit:
            out.append(Finding(
                RULE, src.path, node.lineno,
                "device-layer module imports the dispatch profiler — "
                "profiling brackets dispatches at the registered host "
                "boundaries (sched/cuda._call_kernel, sched/batch."
                "_execute), never inside the jitted/Pallas layer",
            ))
    return out


def collect(cache) -> Tuple[List[Finding], List[str]]:
    out: List[Finding] = []
    scanned: List[str] = []

    # 1) Boundary registry: allowed call sites + rename protection.
    for rel, funcs in sorted(BOUNDARIES.items()):
        src = cache.get(rel)
        if src is None:
            out.append(Finding(
                RULE, rel, 0,
                f"registered profiler boundary file {rel} is missing — "
                "renamed/deleted? update pivot_tpu_torch/analysis/profbound.py "
                "BOUNDARIES",
            ))
            continue
        scanned.append(rel)
        for fn in funcs:
            if not _has_function(src, fn):
                out.append(Finding(
                    RULE, rel, 1,
                    f"registered profiler boundary {fn}() no longer "
                    f"exists in {rel} — renamed? update BOUNDARIES (its "
                    "dispatches lost profiler coverage)",
                ))

    # 2) Package sweep: .profile(...) calls outside registered bodies.
    root = os.path.join(cache.root, _SWEEP_ROOT)
    if os.path.isdir(root):
        for dirpath, _dirs, files in sorted(os.walk(root)):
            for fname in sorted(files):
                if not fname.endswith(".py"):
                    continue
                rel = os.path.relpath(
                    os.path.join(dirpath, fname), cache.root
                )
                if any(rel.startswith(p) for p in _EXEMPT_PREFIXES):
                    continue
                src = cache.get(rel)
                if src is None or ".profile(" not in src.text:
                    continue
                if rel not in scanned:
                    scanned.append(rel)
                allowed = BOUNDARIES.get(rel, ())
                for lineno, func in _profile_calls(src):
                    if func in allowed:
                        continue
                    out.append(Finding(
                        RULE, rel, lineno,
                        f"profiler recording call .profile() in "
                        f"{func}() — not a registered dispatch "
                        "boundary; register (file, function) in "
                        "pivot_tpu_torch/analysis/profbound.py BOUNDARIES "
                        "if this genuinely brackets a device dispatch",
                    ))

    # 3) Device layer: no profiler imports under pivot_tpu_torch/ops/.
    ops_dir = os.path.join(cache.root, "pivot_tpu_torch/ops")
    if os.path.isdir(ops_dir):
        for name in sorted(os.listdir(ops_dir)):
            if not name.endswith(".py"):
                continue
            rel = f"pivot_tpu_torch/ops/{name}"
            src = cache.get(rel)
            if src is None:
                continue
            if rel not in scanned:
                scanned.append(rel)
            out.extend(_scan_ops_imports(src))

    return out, scanned
