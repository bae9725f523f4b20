"""Dtype lint: no float64 across the device boundary.

Port of ``pivot_tpu/analysis/dtype.py``.  The card is a **float32
world**: a float64 tensor there doubles memory and takes the slow f64
pipes, and its results no longer pair with the f32 fixtures the chip
runs are held to.  Float64 stays legitimate on the CPU parity path (the
tests run the port in float64 against ``pivot_tpu`` under x64;
``parallel/ensemble/libm.py::require_host`` refuses a float64 run off
the CPU where it needs the C library).  In the device-boundary modules
(:data:`SCOPE`):

  * **float64 on the boundary** (the reference's check, unchanged) — an
    ``np.float64`` / ``jnp.float64`` reference, a ``"float64"`` dtype
    string, or ``.astype("float64")``.  A justified site (the CPU parity
    path, a host-side reduction) carries an ``ignore[dtype]``
    suppression saying so.
  * **numpy's float64 inherited** (the torch form of the reference's
    weak-type fork) — ``torch.as_tensor(x)`` / ``torch.from_numpy(x)``
    without a ``dtype=`` takes ``x``'s numpy dtype, float64 for a host
    float array, silently.  Give the dtype, or cast at once
    (``.to(device, dtype)``, ``.float()``, ``.long()``, …).
"""

from __future__ import annotations

import ast
from typing import List, Tuple

from pivot_tpu_torch.analysis import Finding, SourceFile

RULE = "dtype"

#: Device-boundary modules: files whose numpy arrays get staged onto
#: the accelerator.  The CPU twins (``sched/policies.py``), the DES,
#: and the converters stay out of scope — f64 is their contract.
SCOPE = (
    "pivot_tpu_torch/ops",
    "pivot_tpu_torch/sched/cuda.py",
    "pivot_tpu_torch/sched/batch.py",
    "pivot_tpu_torch/parallel",
)

_ARRAY_MODS = {"np", "numpy", "onp", "jnp"}


def _is_float64_ref(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Attribute)
        and node.attr == "float64"
        and isinstance(node.value, ast.Name)
        and node.value.id in _ARRAY_MODS
    )


def scan_boundary(src: SourceFile) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(src.tree):
        if _is_float64_ref(node):
            out.append(Finding(
                RULE, src.path, node.lineno,
                "float64 on a device-boundary path — under x64 this "
                "stages a double-width buffer and forks the compile "
                "cache per dtype; build in the policy dtype at source "
                "(np.dtype(self.dtype)) so f64 math rounds once on "
                "assignment",
            ))
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "astype"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "float64"
        ):
            out.append(Finding(
                RULE, src.path, node.lineno,
                'astype("float64") on a device-boundary path — see the '
                "cast-at-source rule",
            ))
        elif isinstance(node, ast.keyword) and node.arg == "dtype" and (
            isinstance(node.value, ast.Constant)
            and node.value.value == "float64"
        ):
            out.append(Finding(
                RULE, src.path, node.lineno,
                'dtype="float64" on a device-boundary path — see the '
                "cast-at-source rule",
            ))
    return out


#: Casts that fix a tensor's dtype right after its construction.
_CASTS = {"float", "double", "long", "int", "bool", "half", "short",
          "byte"}


def _cast_now(parent: ast.AST, node: ast.AST) -> bool:
    """``node`` is the receiver of a cast that names a dtype:
    ``.to(device, dtype)`` / ``.to(dtype=...)`` / ``.to(torch.x)`` /
    ``.float()`` / ``.long()`` / …."""
    if not (isinstance(parent, ast.Attribute) and parent.value is node):
        return False
    if parent.attr in _CASTS:
        return True
    return parent.attr == "to"


def _inherit_findings(src: SourceFile) -> List[Finding]:
    out: List[Finding] = []
    parents = {}
    for node in ast.walk(src.tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    for node in ast.walk(src.tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "torch"
            and node.func.attr in {"as_tensor", "from_numpy"}
        ):
            continue
        if any(kw.arg == "dtype" for kw in node.keywords):
            continue
        parent = parents.get(node)
        if _cast_now(parent, node):
            call = parents.get(parent)
            if parent.attr != "to" or (
                isinstance(call, ast.Call) and (
                    any(kw.arg == "dtype" for kw in call.keywords)
                    or len(call.args) >= 2
                    or (len(call.args) == 1 and isinstance(
                        call.args[0], ast.Attribute)
                        and isinstance(call.args[0].value, ast.Name)
                        and call.args[0].value.id == "torch"))):
                continue
        out.append(Finding(
            RULE, src.path, node.lineno,
            f"torch.{node.func.attr}(...) without dtype= on a "
            "device-boundary path inherits the numpy array's dtype "
            "(float64 for a host float array) — pass dtype= or cast at "
            "once",
        ))
    return out


def _scope_files(root: str) -> List[str]:
    import os

    rels: List[str] = []
    for entry in SCOPE:
        abspath = os.path.join(root, entry)
        if os.path.isfile(abspath):
            rels.append(entry)
        elif os.path.isdir(abspath):
            for dirpath, _dirs, files in sorted(os.walk(abspath)):
                for name in sorted(files):
                    if name.endswith(".py"):
                        rels.append(os.path.relpath(
                            os.path.join(dirpath, name), root
                        ))
    return rels


def collect(cache) -> Tuple[List[Finding], List[str]]:
    import os

    out: List[Finding] = []
    scanned: List[str] = []
    for entry in SCOPE:
        if not os.path.exists(os.path.join(cache.root, entry)):
            out.append(Finding(
                RULE, entry, 0,
                f"device-boundary scope entry {entry} is missing — "
                "renamed/deleted? update dtype SCOPE (it lost all lint "
                "coverage)",
            ))
    for rel in _scope_files(cache.root):
        src = cache.get(rel)
        if src is None:
            continue
        scanned.append(rel)
        out.extend(scan_boundary(src))
        out.extend(_inherit_findings(src))
    return out, scanned
