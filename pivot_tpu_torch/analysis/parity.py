"""Backend feature-parity matrix: every knob reaches every kernel form.

Port of ``pivot_tpu/analysis/parity.py``, over the port's forms.  Each
placement policy is one *family* served by several forms — the scan
oracle (``*_kernel_ref``), the two-phase ``*_impl``, the replica-batched
``first_fit_batched`` / ``best_fit_batched`` (the reference's
``jax.vmap`` of the per-tick kernel), and for cost-aware the hand
kernel's wrappers (``cost_aware_cuda[_batched|_rows]``, the port of
``cost_aware_pallas[_batched]``) and their plain versions
(``cost_aware_plain[_batched|_rows]``) — plus the span-driver family
(``fused_tick_run`` / ``reference_tick_run`` / ``fused_tick_run_rows`` /
``resident_span_run``), the host-sharded twins of ``ops/shard.py``
(``*_kernel_sharded``, the ``[G]``-batched ``*_kernel_sharded_batched``,
``sharded_fused_tick_run``, ``sharded_batched_tick_run``,
``sharded_resident_span_run``) and the ``sched/cuda.py`` routing
layer.  A knob that reaches some forms but not
others is a silent parity break.

The reference's four checks, unchanged: the signature matrix (modulo
each form's declared exemptions in :data:`MANIFEST`), auto-discovery of
unregistered forms in ``ops/``, the routing layer's forwarding
(``_device_place``; the span route ``place_span`` / ``_span_kw`` /
``_span_market_kw``), and the ragged axis tables' coverage of the span
driver's array knobs.

A reference form the port does not have is declared in :data:`ABSENT`
with the reason, not dropped silently (none today).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from pivot_tpu_torch.analysis import Finding, SourceFile

RULE = "backend-parity"

#: Knobs tracked for the per-tick kernel families (parameter names).
KNOBS = frozenset({
    "live", "risk", "totals", "phase2", "strict", "uniforms",
    "bin_pack", "sort_hosts", "host_decay", "rt_bw_rows", "rt_bw_idx",
    "score_exp",
})

#: Knobs tracked for the span-driver family.
SPAN_KNOBS = frozenset({
    "uniforms", "sort_norm", "anchor_zone", "bucket_id", "totals",
    "live", "risk_rows", "cost_stack", "cost_seg", "strict",
    "decreasing", "bin_pack", "sort_tasks", "sort_hosts", "host_decay",
    "phase2", "score_exp",
})

_KERNELS = "pivot_tpu_torch/ops/kernels.py"
_CUDA = "pivot_tpu_torch/ops/cuda_kernels.py"
_TICKLOOP = "pivot_tpu_torch/ops/tickloop.py"
_SHARD = "pivot_tpu_torch/ops/shard.py"
_ROUTING_FILE = "pivot_tpu_torch/sched/cuda.py"

#: The scan oracles have no two-phase machinery: ``phase2``/``totals``
#: would be dead parameters on the reference form.
_REF_EXEMPT = frozenset({"phase2", "totals"})
#: The hand kernel (the reference's Pallas exemption): the whole tick in
#: one block — no speculation (``totals``/``phase2``), no live-bandwidth
#: rows, no learned score exponents (``sched/cuda.py`` serves those on
#: ``cost_aware_impl``).  Its plain versions share its signature.
_KERNEL_EXEMPT = frozenset({
    "phase2", "totals", "rt_bw_rows", "rt_bw_idx", "score_exp",
})
#: The replica-batched passes of the gated tick: one slim pass (no
#: ``phase2``/``totals``) over replicas whose live mask is not applied,
#: as in the reference's ``jax.vmap`` sensitivity pass
#: (``pivot_tpu/sched/tpu.py:1659-1666``).
_BATCHED_EXEMPT = frozenset({"live", "phase2", "totals"})
#: The sharded twins have not been threaded for learned exponents —
#: ``enable_sharding`` refuses non-default ``score_exponents()`` at the
#: policy layer (the reference's exemption).
_SHARD_EXEMPT = frozenset({"score_exp"})

#: family stem → {form name: (repo-relative file, exempt knobs)}.
#: Registering a form here is a statement that its knob set matches the
#: family union minus the listed, justified exemptions.
MANIFEST: Dict[str, Dict[str, Tuple[str, FrozenSet[str]]]] = {
    "opportunistic": {
        "opportunistic_kernel_ref": (_KERNELS, _REF_EXEMPT),
        "opportunistic_impl": (_KERNELS, frozenset()),
        "opportunistic_kernel_sharded": (_SHARD, frozenset()),
        "opportunistic_kernel_sharded_batched": (_SHARD, frozenset()),
    },
    "first_fit": {
        "first_fit_kernel_ref": (_KERNELS, _REF_EXEMPT),
        "first_fit_impl": (_KERNELS, frozenset()),
        "first_fit_batched": (_KERNELS, _BATCHED_EXEMPT),
        "first_fit_kernel_sharded": (_SHARD, frozenset()),
        "first_fit_kernel_sharded_batched": (_SHARD, frozenset()),
    },
    "best_fit": {
        "best_fit_kernel_ref": (_KERNELS, _REF_EXEMPT),
        "best_fit_impl": (_KERNELS, frozenset()),
        "best_fit_batched": (_KERNELS, _BATCHED_EXEMPT),
        "best_fit_kernel_sharded": (_SHARD, frozenset()),
        "best_fit_kernel_sharded_batched": (_SHARD, frozenset()),
    },
    "cost_aware": {
        "cost_aware_kernel_ref": (_KERNELS, _REF_EXEMPT),
        "cost_aware_impl": (_KERNELS, frozenset()),
        "cost_aware_cuda": (_CUDA, _KERNEL_EXEMPT),
        "cost_aware_cuda_batched": (_CUDA, _KERNEL_EXEMPT),
        "cost_aware_cuda_rows": (_CUDA, _KERNEL_EXEMPT),
        "cost_aware_plain": (_CUDA, _KERNEL_EXEMPT),
        "cost_aware_plain_batched": (_CUDA, _KERNEL_EXEMPT),
        "cost_aware_plain_rows": (_CUDA, _KERNEL_EXEMPT),
        "cost_aware_kernel_sharded": (_SHARD, _SHARD_EXEMPT),
        "cost_aware_kernel_sharded_batched": (_SHARD, _SHARD_EXEMPT),
    },
}

#: The reference's form each port form stands for, where the names
#: differ (the hand kernel's wrappers for the Pallas kernels).
REFERENCE_FORM: Dict[str, str] = {
    "cost_aware_cuda": "cost_aware_pallas",
    "cost_aware_cuda_batched": "cost_aware_pallas_batched",
}

#: The resident span form carries ``live`` INSIDE its carry (edited by
#: sparse ``edit_live`` rows) and gathers its risk rows from a
#: once-staged table: the knobs are absent because their state moved to
#: the device (the reference's exemption, ``tests/test_torch_resident.py``
#: pins their parity against the re-staged driver).
_RESIDENT_EXEMPT = frozenset({"live", "risk_rows"})

#: Elastic meshes register no span form here (``pivot_tpu/analysis/
#: parity.py:144``): a shrink or regrow runs the ``sharded_*`` entries
#: below on another rung of the ladder (``ops.shard.mesh_shape_ladder``),
#: and the ``elastic_*`` re-layout helpers are host-side numpy between
#: device programs, invisible to the discovery patterns.
SPAN_MANIFEST: Dict[str, Tuple[str, FrozenSet[str]]] = {
    "fused_tick_run": (_TICKLOOP, frozenset()),
    "reference_tick_run": (_TICKLOOP, frozenset()),
    "fused_tick_run_rows": (_TICKLOOP, frozenset()),
    "resident_span_run": (_TICKLOOP, _RESIDENT_EXEMPT),
    "sharded_fused_tick_run": (_SHARD, _SHARD_EXEMPT),
    "sharded_batched_tick_run": (_SHARD, _SHARD_EXEMPT),
    "sharded_resident_span_run": (_SHARD, _RESIDENT_EXEMPT | _SHARD_EXEMPT),
}

#: The reference's forms with no port counterpart yet, and why.
ABSENT: Dict[str, str] = {}

#: Keyword-only span-driver parameters defaulting to None that are not
#: device array operands, so the ragged tables do not classify them.
SPAN_NON_ARRAY: Dict[str, str] = {
    "n_bound": "the host step bounds of each tick, read before the loop",
    "greedy": "the Cost-Aware placement callable (the hand kernel's "
              "wrapper), not an operand",
}

#: Knobs the routing layer must forward per family (∩ the family's
#: actual knob union — a family without ``totals`` isn't required to
#: route it).
ROUTING_KNOBS = frozenset({"live", "risk", "totals", "phase2", "score_exp"})
#: Market/quarantine operands ``place_span``/``_span_kw``/
#: ``_span_market_kw`` must stage for the span drivers.
SPAN_ROUTING_KNOBS = frozenset({
    "live", "risk_rows", "cost_stack", "cost_seg", "score_exp",
})
_SPAN_ROUTING_FUNCS = ("place_span", "_span_kw", "_span_market_kw")

#: Other names the routing layer references for each family.
_FORM_ALIASES: Dict[str, str] = {}

#: Discovery patterns: (regex with a ``stem`` group, form label).  Any
#: public top-level function matching one of these in a manifest file
#: is a backend form and must be registered.
_DISCOVER = (
    (re.compile(r"^(?P<stem>[a-z]\w*)_kernel_ref$"), "kernel_ref"),
    (re.compile(r"^(?P<stem>[a-z]\w*)_kernel_sharded$"), "kernel_sharded"),
    (re.compile(r"^(?P<stem>[a-z]\w*)_impl$"), "impl"),
    (re.compile(r"^(?P<stem>[a-z]\w*)_batched$"), "batched"),
    (re.compile(r"^(?P<stem>[a-z]\w*)_(cuda|plain)(_batched|_rows)?$"),
     "kernel"),
)
_DISCOVER_SPAN = re.compile(r"^[a-z]\w*(tick_run|tick_run_rows|span_run)$")


def _param_names(fn: ast.FunctionDef) -> Set[str]:
    a = fn.args
    return {p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)}


def _top_level_functions(src: SourceFile) -> Dict[str, ast.FunctionDef]:
    return {
        node.name: node
        for node in src.tree.body
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
    }


def _matrix_findings(
    family: str,
    forms: Dict[str, Tuple[str, FrozenSet[str]]],
    knob_universe: FrozenSet[str],
    funcs_by_file: Dict[str, Dict[str, ast.FunctionDef]],
) -> Tuple[List[Finding], Dict[str, Set[str]]]:
    """Signature-matrix check for one family.  Returns findings plus
    each found form's knob set (the routing check reuses the union)."""
    out: List[Finding] = []
    knob_sets: Dict[str, Set[str]] = {}
    lines: Dict[str, Tuple[str, int]] = {}
    for name, (rel, _exempt) in forms.items():
        funcs = funcs_by_file.get(rel)
        if funcs is None:
            continue  # file absent from this tree: nothing to check
        fn = funcs.get(name)
        if fn is None:
            out.append(Finding(
                RULE, rel, 1,
                f"registered backend form {name}() of family "
                f"{family!r} not found — update the parity manifest "
                "after renames",
            ))
            continue
        knob_sets[name] = _param_names(fn) & knob_universe
        lines[name] = (rel, fn.lineno)
    if not knob_sets:
        return out, knob_sets
    union: Set[str] = set().union(*knob_sets.values())
    for name, knobs in knob_sets.items():
        rel, lineno = lines[name]
        missing = union - knobs - forms[name][1]
        if missing:
            out.append(Finding(
                RULE, rel, lineno,
                f"{name}() is missing family {family!r} knob(s) "
                f"{sorted(missing)} — every backend form must accept "
                "every family knob (or declare an exemption in the "
                "manifest with a justification)",
            ))
    return out, knob_sets


def _discovery_findings(
    funcs_by_file: Dict[str, Dict[str, ast.FunctionDef]],
) -> List[Finding]:
    registered = {
        name for forms in MANIFEST.values() for name in forms
    } | set(SPAN_MANIFEST)
    out: List[Finding] = []
    for rel, funcs in funcs_by_file.items():
        for name, fn in funcs.items():
            if name.startswith("_") or name in registered:
                continue
            hit = any(pat.match(name) for pat, _ in _DISCOVER)
            if not hit:
                hit = bool(_DISCOVER_SPAN.match(name))
            if hit:
                out.append(Finding(
                    RULE, rel, fn.lineno,
                    f"unregistered backend form {name}() — a new kernel/"
                    "span form must join the parity manifest "
                    "(pivot_tpu_torch/analysis/parity.py) so the knob matrix "
                    "covers it",
                ))
    return out


# ---------------------------------------------------------------------------
# Routing-layer check
# ---------------------------------------------------------------------------

def _forwarded_names(fn: ast.AST) -> Set[str]:
    """Every keyword-ish name a function can forward to a kernel call:
    explicit call keywords, dict-literal string keys, ``dict(...)``
    keywords, and ``kw["name"] = ...`` subscript staging."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg is not None:
                    out.add(kw.arg)
        elif isinstance(node, ast.Dict):
            for key in node.keys:
                if isinstance(key, ast.Constant) and isinstance(
                    key.value, str
                ):
                    out.add(key.value)
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (
                    isinstance(tgt, ast.Subscript)
                    and isinstance(tgt.slice, ast.Constant)
                    and isinstance(tgt.slice.value, str)
                ):
                    out.add(tgt.slice.value)
    return out


def _referenced_families(fn: ast.AST) -> Set[str]:
    members = dict(_FORM_ALIASES)
    for family, forms in MANIFEST.items():
        for name in forms:
            members[name] = family
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and node.id in members:
            out.add(members[node.id])
    return out


def _routing_findings(
    src: SourceFile, family_unions: Dict[str, Set[str]]
) -> List[Finding]:
    out: List[Finding] = []
    span_vocab: Set[str] = set()
    span_seen = False
    references_span = False
    for node in ast.walk(src.tree):
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if (
                    isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and item.name == "_device_place"
                ):
                    vocab = _forwarded_names(item)
                    for family in sorted(_referenced_families(item)):
                        required = ROUTING_KNOBS & family_unions.get(
                            family, set()
                        )
                        missing = required - vocab
                        if missing:
                            out.append(Finding(
                                RULE, src.path, item.lineno,
                                f"{node.name}._device_place does not "
                                f"forward knob(s) {sorted(missing)} to "
                                f"the {family!r} kernels — the routing "
                                "layer must thread every routing knob",
                            ))
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name in _SPAN_ROUTING_FUNCS:
                span_seen = True
                span_vocab |= _forwarded_names(node)
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Name) and sub.id in SPAN_MANIFEST:
                        references_span = True
    if span_seen and references_span:
        missing = SPAN_ROUTING_KNOBS - span_vocab
        if missing:
            out.append(Finding(
                RULE, src.path, 1,
                f"the span route ({'/'.join(_SPAN_ROUTING_FUNCS)}) never "
                f"stages span knob(s) {sorted(missing)} for the fused "
                "tick drivers",
            ))
    return out


# ---------------------------------------------------------------------------
# Pass entry point
# ---------------------------------------------------------------------------

#: Directory swept for backend forms living in files the manifest does
#: not know yet — every recent backend PR introduced its forms in a NEW
#: file (tickloop.py, pallas_kernels.py, shard.py), so discovery must
#: not be limited to already-registered files.
_OPS_DIR = "pivot_tpu_torch/ops"


def _set_literal_names(node: ast.AST) -> Optional[Set[str]]:
    """String elements of a ``{...}`` / ``frozenset({...})`` literal, or
    None when the node is not one (the check then reports it rather than
    guessing)."""
    if isinstance(node, ast.Call) and len(node.args) == 1:
        func = node.func
        if isinstance(func, ast.Name) and func.id == "frozenset":
            node = node.args[0]
    if isinstance(node, ast.Set):
        elts = node.elts
    elif isinstance(node, ast.Dict):
        elts = [k for k in node.keys if k is not None]
    else:
        return None
    out: Set[str] = set()
    for e in elts:
        if not (isinstance(e, ast.Constant) and isinstance(e.value, str)):
            return None
        out.add(e.value)
    return out


def _ragged_findings(
    funcs_by_file: Dict[str, Dict[str, ast.FunctionDef]],
    tickloop_src: Optional[SourceFile],
) -> List[Finding]:
    """Check 4: RAGGED_AXES ∪ RAGGED_INVARIANT partitions the span
    family's array knobs (kwonly ``fused_tick_run`` params defaulting
    to None) — every operand the ragged repack may see is classified
    exactly once as padded-per-axis or shape-invariant."""
    if tickloop_src is None:
        return []  # the missing-file finding already fired
    fn = funcs_by_file.get(_TICKLOOP, {}).get("fused_tick_run")
    if fn is None:
        return []  # span-manifest check already reports the vanish
    array_knobs = {
        p.arg
        for p, d in zip(fn.args.kwonlyargs, fn.args.kw_defaults)
        if isinstance(d, ast.Constant) and d.value is None
    } - set(SPAN_NON_ARRAY)
    tables: Dict[str, Optional[Set[str]]] = {
        "RAGGED_AXES": None, "RAGGED_INVARIANT": None,
    }
    lines: Dict[str, int] = {}
    for node in tickloop_src.tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if isinstance(tgt, ast.Name) and tgt.id in tables:
            tables[tgt.id] = _set_literal_names(node.value)
            lines[tgt.id] = node.lineno
    out: List[Finding] = []
    for name, names in tables.items():
        if names is None:
            out.append(Finding(
                RULE, _TICKLOOP, lines.get(name, 0),
                f"{name} is missing or not a string-keyed literal — the "
                "ragged axis-coverage check cannot read it statically",
            ))
    axes, invariant = tables["RAGGED_AXES"], tables["RAGGED_INVARIANT"]
    if axes is None or invariant is None:
        return out
    overlap = axes & invariant
    if overlap:
        out.append(Finding(
            RULE, _TICKLOOP, lines["RAGGED_AXES"],
            "ragged tables overlap (operand classified twice): "
            f"{sorted(overlap)}",
        ))
    uncovered = array_knobs - axes - invariant
    if uncovered:
        out.append(Finding(
            RULE, _TICKLOOP, lines["RAGGED_AXES"],
            "span array knob(s) missing from both ragged tables — the "
            "repack would drop them from the coalescing key and leave "
            f"them unpadded: {sorted(uncovered)} (add to RAGGED_AXES "
            "with (K, B) axis positions, or to RAGGED_INVARIANT if the "
            "operand has neither axis)",
        ))
    stale = (axes | invariant) - array_knobs
    if stale:
        out.append(Finding(
            RULE, _TICKLOOP, lines["RAGGED_AXES"],
            "ragged table entries with no matching fused_tick_run "
            f"array knob (renamed/removed?): {sorted(stale)}",
        ))
    return out


def _ops_files(root: str) -> List[str]:
    import os

    abspath = os.path.join(root, _OPS_DIR)
    if not os.path.isdir(abspath):
        return []
    return [
        f"{_OPS_DIR}/{name}"
        for name in sorted(os.listdir(abspath))
        if name.endswith(".py")
    ]


def collect(cache) -> Tuple[List[Finding], List[str]]:
    registered = sorted(
        {rel for forms in MANIFEST.values() for rel, _ in forms.values()}
        | {rel for rel, _ in SPAN_MANIFEST.values()}
        | {_ROUTING_FILE}
    )
    files = sorted(set(registered) | set(_ops_files(cache.root)))
    funcs_by_file: Dict[str, Dict[str, ast.FunctionDef]] = {}
    scanned: List[str] = []
    missing: List[Finding] = []
    for rel in files:
        src = cache.get(rel)
        if src is None:
            # A registered file that vanished takes ALL of its forms'
            # coverage with it — loud failure, not a silent skip (the
            # old lint raised FileNotFoundError here; review finding,
            # round 12).
            missing.append(Finding(
                RULE, rel, 0,
                f"registered file {rel} is missing — renamed/deleted? "
                "update the parity manifest (its forms lost all static "
                "coverage)",
            ))
            continue
        scanned.append(rel)
        if rel != _ROUTING_FILE:
            funcs_by_file[rel] = _top_level_functions(src)

    out: List[Finding] = list(missing)
    family_unions: Dict[str, Set[str]] = {}
    for family, forms in MANIFEST.items():
        findings, knob_sets = _matrix_findings(
            family, forms, KNOBS, funcs_by_file
        )
        out.extend(findings)
        if knob_sets:
            family_unions[family] = set().union(*knob_sets.values())
    span_findings, _span_sets = _matrix_findings(
        "span", SPAN_MANIFEST, SPAN_KNOBS, funcs_by_file
    )
    out.extend(span_findings)
    out.extend(_ragged_findings(funcs_by_file, cache.get(_TICKLOOP)))
    out.extend(_discovery_findings(funcs_by_file))

    routing = cache.get(_ROUTING_FILE)
    if routing is not None:
        out.extend(_routing_findings(routing, family_unions))
    entry_findings, entry_scanned = _entry_findings(cache)
    out.extend(entry_findings)
    scanned.extend(r for r in entry_scanned if r not in scanned)
    return out, scanned


def _entry_findings(cache) -> Tuple[List[Finding], List[str]]:
    """The entry map's registry findings (a file outside its
    ``ENTRY_FILES`` hosting a device entry point), and every device
    entry point it finds in ``ops/`` that is not a registered form (the
    map and the manifest cannot drift apart; names the discovery
    patterns match are reported by the discovery check)."""
    from pivot_tpu_torch.analysis.entrymap import collect_entries

    registered = {
        name for forms in MANIFEST.values() for name in forms
    } | set(SPAN_MANIFEST)
    entries, findings, scanned = collect_entries(cache)
    return [Finding(RULE, f.path, f.line, f.message) for f in findings] + [
        Finding(
            RULE, e.path, e.lineno,
            f"device entry point {e.name}() ({e.kind}, analysis/"
            "entrymap.py) is not a registered backend form — add it to "
            "the parity manifest",
        )
        for rel, es in sorted(entries.items()) if rel.startswith(_OPS_DIR)
        for e in es if e.name not in registered
        and not any(pat.match(e.name) for pat, _ in _DISCOVER)
        and not _DISCOVER_SPAN.match(e.name)
    ], scanned
