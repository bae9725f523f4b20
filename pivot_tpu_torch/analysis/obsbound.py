"""obs-boundary lint: the observability plane's hot-path/determinism pins.

Port of ``pivot_tpu/analysis/obsbound.py``, over the port's device layer
(``pivot_tpu_torch/ops/``), the host-sync pass's hot bodies and the
determinism scope; the reference's text follows.

Round 14's tentpole (``pivot_tpu_torch/obs``) makes two structural promises
that are trivially easy to erode one convenient line at a time:

  * **no instrumentation inside the device layer** — trace events are
    emitted at dispatch *boundaries* only.  A tracer hook inside a
    jitted/Pallas body would either trace once and record nothing (the
    call happens at trace time, not run time) or force a host sync per
    iteration — both silent lies.  Enforced two ways: the device-layer
    files (``pivot_tpu_torch/ops/``) may not import ``pivot_tpu_torch.obs`` (or
    the ``utils.trace`` shim) at all, and the host-sync pass's
    auto-discovered hot bodies (:data:`pivot_tpu_torch.analysis.hostsync
    .DISCOVER` — the registration the obs hooks share) may not call a
    tracer recording method (``tracer.emit`` / ``.stage`` / ``.span``
    / ``.wall_span`` / ``.record_span`` / ``.mark``);
  * **wall capture lives inside ``obs/``** — hooks in the
    determinism-scoped modules (:data:`pivot_tpu_torch.analysis.determinism
    .SCOPE`) pass sim-time payloads and let the tracer stamp the wall
    side.  The determinism pass already bans literal ``time.*`` reads
    there; this pass closes the obs-shaped loophole — constructing an
    :class:`~pivot_tpu_torch.obs.clock.ObsClock` or calling ``clock.now()``
    / ``clock.elapsed()`` in scope is the same wall read wearing a
    new name.

Calling a *tracer* from a determinism-scoped module is fine (that is
the designed boundary: ``sched/batch.py`` wraps its flush in
``tracer.wall_span``); owning a *clock* there is not.
"""

from __future__ import annotations

import ast
import os
from typing import List, Tuple

from pivot_tpu_torch.analysis import Finding, SourceFile
from pivot_tpu_torch.analysis import determinism as _determinism
from pivot_tpu_torch.analysis import hostsync as _hostsync

RULE = "obs-boundary"

#: Tracer recording methods banned inside discovered hot bodies.
_TRACER_METHODS = {
    "emit", "stage", "span", "wall_span", "record_span", "mark",
}

#: Wall-clock methods banned on a ``clock``-named base in determinism
#: scope (the ObsClock surface).
_CLOCK_METHODS = {"now", "elapsed"}


def _is_obs_import(node: ast.AST) -> Tuple[bool, str]:
    """Any spelling that brings the obs package (or its ``utils.trace``
    shim) into scope — dotted imports, aliased imports, and the
    ``from pivot_tpu_torch import obs`` / ``from pivot_tpu_torch.utils import
    trace`` package-member forms (the bypasses a prefix-only check
    missed, review round 14)."""
    if isinstance(node, ast.Import):
        for alias in node.names:
            if alias.name.startswith("pivot_tpu_torch.obs") or (
                alias.name == "pivot_tpu_torch.utils.trace"
            ):
                return True, alias.name
    elif isinstance(node, ast.ImportFrom):
        mod = node.module or ""
        names = {alias.name for alias in node.names}
        if mod.startswith("pivot_tpu_torch.obs") or mod == "pivot_tpu_torch.utils.trace":
            return True, mod
        if mod == "pivot_tpu_torch" and "obs" in names:
            return True, "pivot_tpu_torch.obs"
        if mod == "pivot_tpu_torch.utils" and "trace" in names:
            return True, "pivot_tpu_torch.utils.trace"
    return False, ""


def _base_is(node: ast.AST, name: str) -> bool:
    """True when an attribute chain ends in ``<...>.name`` or ``name``."""
    if isinstance(node, ast.Name):
        return node.id == name
    if isinstance(node, ast.Attribute):
        return node.attr == name
    return False


def _scan_ops_file(src: SourceFile) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(src.tree):
        hit, mod = _is_obs_import(node)
        if hit:
            out.append(Finding(
                RULE, src.path, node.lineno,
                f"device-layer module imports {mod} — instrumentation "
                "belongs at dispatch boundaries (sched/serve), never "
                "inside the jitted/Pallas layer",
            ))
    return out


def _scan_hot_bodies(src: SourceFile, names: List[str]) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(src.tree):
        if not (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name in names
        ):
            continue
        for sub in ast.walk(node):
            if not (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in _TRACER_METHODS
                and _base_is(sub.func.value, "tracer")
            ):
                continue
            out.append(Finding(
                RULE, src.path, sub.lineno,
                f"tracer hook .{sub.func.attr}() inside hot-path body "
                f"{node.name}() — events are emitted at dispatch "
                "boundaries only (a hook here traces once and lies, "
                "or host-syncs per iteration)",
            ))
    return out


def _scan_determinism_file(src: SourceFile) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Import):
            # `import pivot_tpu_torch.obs.clock [as oc]` — the aliased form
            # would make every later `oc.ObsClock()` invisible to the
            # call checks below, so the import itself is the finding
            # (the determinism pass hardened against exactly this
            # evasion class in round 12).
            for alias in node.names:
                if alias.name.startswith("pivot_tpu_torch.obs.clock"):
                    out.append(Finding(
                        RULE, src.path, node.lineno,
                        f"`import {alias.name}` in a determinism-"
                        "scoped module — the obs wall clock may not "
                        "live here (hooks pass sim-time payloads; the "
                        "tracer stamps the wall side)",
                    ))
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            names = {alias.name for alias in node.names}
            if (
                mod == "pivot_tpu_torch.obs.clock"
                or (mod.startswith("pivot_tpu_torch.obs") and "ObsClock" in names)
                or (mod == "pivot_tpu_torch.obs" and "clock" in names)
            ):
                out.append(Finding(
                    RULE, src.path, node.lineno,
                    "ObsClock import in a determinism-scoped module — "
                    "wall capture lives inside pivot_tpu_torch/obs; hooks "
                    "here pass sim-time payloads only",
                ))
        elif isinstance(node, ast.Call):
            f = node.func
            if (
                isinstance(f, ast.Name) and f.id == "ObsClock"
            ) or (
                isinstance(f, ast.Attribute) and f.attr == "ObsClock"
            ):
                out.append(Finding(
                    RULE, src.path, node.lineno,
                    "ObsClock() constructed in a determinism-scoped "
                    "module — the obs wall clock may not live here",
                ))
            elif (
                isinstance(f, ast.Attribute)
                and f.attr in _CLOCK_METHODS
                and _base_is(f.value, "clock")
            ):
                out.append(Finding(
                    RULE, src.path, node.lineno,
                    f"wall read clock.{f.attr}() in a determinism-"
                    "scoped module — the obs clock is a wall clock "
                    "wearing a new name; emit sim-time payloads and "
                    "let the tracer stamp the wall side",
                ))
    return out


def collect(cache) -> Tuple[List[Finding], List[str]]:
    out: List[Finding] = []
    scanned: List[str] = []

    # 1) Device layer: no obs imports anywhere under pivot_tpu_torch/ops/.
    ops_dir = os.path.join(cache.root, "pivot_tpu_torch/ops")
    if os.path.isdir(ops_dir):
        for name in sorted(os.listdir(ops_dir)):
            if not name.endswith(".py"):
                continue
            rel = f"pivot_tpu_torch/ops/{name}"
            src = cache.get(rel)
            if src is None:
                continue
            scanned.append(rel)
            out.extend(_scan_ops_file(src))

    # 2) Hot bodies: reuse the host-sync pass's discovery so the obs
    # hooks are registered with the SAME body set — a new hot body is
    # covered by both passes the moment hostsync discovers it.
    for rel, patterns in _hostsync.DISCOVER.items():
        src = cache.get(rel)
        if src is None:
            continue  # hostsync itself reports the missing file
        if rel not in scanned:
            scanned.append(rel)
        names = _hostsync.discover_targets(src, patterns)
        out.extend(_scan_hot_bodies(src, names))

    # 3) Determinism scope: no obs wall clock (sim-time payloads only).
    for rel in _determinism._scope_files(cache.root):
        src = cache.get(rel)
        if src is None:
            continue
        if rel not in scanned:
            scanned.append(rel)
        out.extend(_scan_determinism_file(src))

    return out, scanned
