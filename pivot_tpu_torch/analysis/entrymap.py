"""Device entry-point discovery: where the port's Python crosses into
work on the card.

Counterpart of ``pivot_tpu/analysis/jitmap.py``.  ``jitmap`` finds the
places a Python function crosses into XLA (``jax.jit`` sites).  The port
has no ``jax.jit``: it dispatches torch operators eagerly and launches
one hand-written kernel, so its entry points are found by its own
shapes:

  * **kernel** — the public functions that reach a launch of a library
    loaded through ``ops/build.py::load``: a function that binds the
    result of a loader (a function calling ``load(...)``) and calls what
    it bound is a launch site, and every public top-level function of
    the file whose calls reach a launch site is an entry point (the
    wrappers of ``ops/cuda_kernels.py``: ``greedy_place``'s
    ``cost_aware_cuda[_batched|_rows]`` and ``carry_free_place``'s
    ``opportunistic_cuda``, ``first_fit_cuda[_batched]`` and
    ``best_fit_cuda[_batched]``, each reaching its own library's
    loader);
  * **graph** — the functions that capture a CUDA graph
    (``torch.cuda.graph(...)`` / ``torch.cuda.CUDAGraph()``), named
    ``Class.method`` inside a class;
  * **family** — the torch forms the dispatch profiler's census names
    (``obs/profiler.py``'s docstring table): the public ``*_impl``,
    ``*_kernel_ref`` and ``*_batched`` forms of ``ops/kernels.py``, the
    span drivers of ``ops/tickloop.py`` (``*tick_run``,
    ``*tick_run_rows``, ``*span_run``), the host-sharded twins of
    ``ops/shard.py`` (``*_kernel_sharded[_batched]``, ``*tick_run``,
    ``*span_run``),
    and each key of ``PORT_FAMILIES`` where it is defined.

:data:`ENTRY_FILES` is the registry of files allowed to host entry
points.  The sweep flags a package file outside it that loads a kernel
library or captures a graph — the reference's register-or-flag rule.
Cost attribution (``obs/costattr.py``) and the parity pass read this
module, as both of the reference's consumers read ``jitmap``; its
registry findings are the parity pass's (``backend-parity``).  Pure AST
work: no ``torch`` import.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, NamedTuple, Set, Tuple

from pivot_tpu_torch.analysis import Finding, SourceFile

#: Files registered to host device entry points.
ENTRY_FILES: Tuple[str, ...] = (
    "pivot_tpu_torch/ops/kernels.py",
    "pivot_tpu_torch/ops/tickloop.py",
    "pivot_tpu_torch/ops/shard.py",
    "pivot_tpu_torch/ops/cuda_kernels.py",
    "pivot_tpu_torch/sched/cuda.py",
    "pivot_tpu_torch/parallel/ensemble/tick.py",
)

_PROFILER_FILE = "pivot_tpu_torch/obs/profiler.py"
_SWEEP_ROOT = "pivot_tpu_torch"
_FAMILY_PATTERNS = {
    "pivot_tpu_torch/ops/kernels.py":
        re.compile(r"^[a-z]\w*_(impl|kernel_ref|batched)$"),
    "pivot_tpu_torch/ops/tickloop.py":
        re.compile(r"^[a-z]\w*(tick_run|tick_run_rows|span_run)$"),
    "pivot_tpu_torch/ops/shard.py":
        re.compile(r"^[a-z]\w*(_kernel_sharded(_batched)?|tick_run|"
                   r"span_run)$"),
}


class EntryPoint(NamedTuple):
    """One device entry point."""

    path: str    # repo-relative file
    name: str    # function, or Class.method
    lineno: int
    kind: str    # "kernel" | "graph" | "family"


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _is_graph_call(node: ast.Call) -> bool:
    f = node.func
    return (
        isinstance(f, ast.Attribute)
        and f.attr in {"graph", "CUDAGraph"}
        and isinstance(f.value, ast.Attribute)
        and f.value.attr == "cuda"
        and isinstance(f.value.value, ast.Name)
        and f.value.value.id == "torch"
    )


def _functions(tree: ast.Module):
    """``(qualified name, def)`` of every top-level function and method
    (a nested def belongs to the function around it)."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, node
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield f"{node.name}.{item.name}", item


def _bound_names(fn: ast.AST, sources: Set[str]) -> Set[str]:
    """Names bound (directly, or through another bound name) from a call
    to one of ``sources``."""
    bound: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            v = node.value
            hit = (isinstance(v, ast.Call) and _call_name(v) in sources) or (
                isinstance(v, ast.Name) and v.id in bound)
            if not hit:
                continue
            for tgt in node.targets:
                for n in ast.walk(tgt):
                    if isinstance(n, ast.Name) and n.id not in bound:
                        bound.add(n.id)
                        changed = True
    return bound


def _kernel_entries(src: SourceFile) -> List[EntryPoint]:
    funcs = dict(_functions(src.tree))
    calls = {
        q: {_call_name(n) for n in ast.walk(fn) if isinstance(n, ast.Call)}
        for q, fn in funcs.items()
    }
    # Loaders: call ``load(...)`` (ops/build.py) — and what calls them
    # and returns their result.
    loaders = {q for q, c in calls.items() if "load" in c}
    if not loaders:
        return []
    grew = True
    while grew:
        grew = False
        for q, fn in funcs.items():
            if q in loaders:
                continue
            if any(isinstance(n, ast.Return) and isinstance(n.value, ast.Call)
                   and _call_name(n.value) in loaders
                   for n in ast.walk(fn)):
                loaders.add(q)
                grew = True
    launchers = set()
    for q, fn in funcs.items():
        bound = _bound_names(fn, loaders)
        if any(isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
               and n.func.id in bound for n in ast.walk(fn)):
            launchers.add(q)
    reach = set(launchers)
    grew = True
    while grew:
        grew = False
        for q, c in calls.items():
            if q not in reach and c & reach:
                reach.add(q)
                grew = True
    return [
        EntryPoint(src.path, q, funcs[q].lineno, "kernel")
        for q in funcs
        if q in reach and "." not in q and not q.startswith("_")
        and q not in loaders
    ]


def _graph_entries(src: SourceFile) -> List[EntryPoint]:
    return [
        EntryPoint(src.path, q, fn.lineno, "graph")
        for q, fn in _functions(src.tree)
        if any(isinstance(n, ast.Call) and _is_graph_call(n)
               for n in ast.walk(fn))
    ]


def port_family_names(cache) -> List[str]:
    """The keys of ``obs/profiler.py::PORT_FAMILIES`` (a dict literal)."""
    src = cache.get(_PROFILER_FILE)
    if src is None:
        return []
    for node in src.tree.body:
        tgt = (node.targets[0] if isinstance(node, ast.Assign)
               and len(node.targets) == 1 else
               node.target if isinstance(node, ast.AnnAssign) else None)
        if isinstance(tgt, ast.Name) and tgt.id == "PORT_FAMILIES" and \
                isinstance(node.value, ast.Dict):
            return [k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)]
    return []


def entries_in(src: SourceFile, families=()) -> List[EntryPoint]:
    """Every device entry point of one parsed file (``families``: the
    profiler's port callables, matched by function or method name)."""
    out = _kernel_entries(src) + _graph_entries(src)
    seen = {e.name for e in out}
    pat = _FAMILY_PATTERNS.get(src.path)
    for q, fn in _functions(src.tree):
        short = q.rsplit(".", 1)[-1]
        if q in seen:
            continue
        if (pat is not None and "." not in q and pat.match(q)) or \
                short in families:
            out.append(EntryPoint(src.path, q, fn.lineno, "family"))
            seen.add(q)
    return out


def _uses_device_entry(src: SourceFile) -> bool:
    text = src.text
    if "torch.cuda.graph" not in text and "CUDAGraph" not in text and \
            "ops.build import load" not in text and "build.load(" not in text:
        return False
    return bool(_kernel_entries(src) or _graph_entries(src))


def collect_entries(cache) -> Tuple[
    Dict[str, List[EntryPoint]], List[Finding], List[str]
]:
    """All entry points per registered file, plus registry findings
    (a missing registered file; a file outside :data:`ENTRY_FILES` that
    loads a kernel library or captures a graph) and the scanned files."""
    findings: List[Finding] = []
    scanned: List[str] = []
    entries: Dict[str, List[EntryPoint]] = {}
    families = set(port_family_names(cache))
    for rel in ENTRY_FILES:
        src = cache.get(rel)
        if src is None:
            findings.append(Finding(
                "backend-parity", rel, 0,
                f"registered entry file {rel} is missing — renamed/"
                "deleted? update pivot_tpu_torch/analysis/entrymap.py "
                "ENTRY_FILES",
            ))
            continue
        scanned.append(rel)
        entries[rel] = entries_in(src, families)
    root = os.path.join(cache.root, _SWEEP_ROOT)
    if os.path.isdir(root):
        for dirpath, _dirs, files in sorted(os.walk(root)):
            for fname in sorted(files):
                if not fname.endswith(".py"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fname),
                                      cache.root)
                if rel in ENTRY_FILES or rel.startswith(
                        "pivot_tpu_torch/analysis"):
                    continue
                src = cache.get(rel)
                if src is None or not _uses_device_entry(src):
                    continue
                scanned.append(rel)
                findings.append(Finding(
                    "backend-parity", rel, 1,
                    "device entry point (a kernel-library launch or a "
                    "CUDA-graph capture) in a file the entry map does not "
                    f"cover — add {rel} to pivot_tpu_torch/analysis/"
                    "entrymap.py ENTRY_FILES",
                ))
    return entries, findings, scanned
