"""graftcheck: the static-analysis suite of the port.

Port of ``pivot_tpu/analysis/__init__.py``: the same framework
(:class:`Finding`, :class:`SourceFile` with one parse a run, the
registry, ``# graftcheck: ignore[rule] -- reason`` suppressions, the
:func:`run` driver and :func:`main`), with the passes that have a torch
meaning, each the counterpart of the reference module of the same name
scoped to ``pivot_tpu_torch/`` paths.  A pass keeps its reference's rule
name and checks and adds only the torch form of the same hazard:

  * **backend-parity** (``parity.py``) — every scheduling knob reaches
    every declared form of its kernel family: the scan oracles, the
    two-phase ``*_impl``, ``first_fit_batched`` / ``best_fit_batched``,
    the ``greedy_place`` wrappers and their ``*_plain`` versions, the
    span drivers and the ``sched/cuda.py`` routing;
  * **determinism** (``determinism.py``) — wall clock, process-global
    RNG and hash-ordered iteration in the replay-critical modules, plus
    torch's global generator and the accumulate ops whose order on the
    card is atomic;
  * **thread-guard** (``threadguard.py``) — the declared guarded-by
    maps of the threaded serve / batch layer;
  * **host-sync** (``hostsync.py``) — no host synchronisation inside
    the fused device bodies (``.item()``, ``.tolist()``, ``.cpu()``,
    ``.numpy()``, scalar coercions, ``torch.cuda.synchronize()``);
  * **dtype** (``dtype.py``) — no float64 typing what crosses to the
    card, and no ``torch.as_tensor`` / ``torch.from_numpy`` of a host
    float array without a ``dtype=`` (numpy's float64 inherited);
  * **kernel-budget** (``kernel_budget.py``, counterpart of
    ``pallas_budget.py``) — ``greedy_place``'s shared memory and thread
    limits recomputed from ``csrc/greedy_place.cu`` and held to the
    Python sizer and the H100's constants in ``infra/roofline.py``;
  * **obs-boundary** (``obsbound.py``) and **profiler-boundary**
    (``profbound.py``) — the observability plane's and the dispatch
    profiler's structural pins.

``entrymap.py`` (counterpart of ``jitmap.py``) finds the port's device
entry points for the parity pass and the cost attribution
(``obs/costattr.py``).

Not ported: ``retrace``, ``donation`` and ``jitmap``'s XLA forms.  They
reason about ``jax.jit`` static keys and ``donate_argnums``, and the
port has neither (torch dispatches eagerly and donates nothing).  Their
runtime observable has a counterpart, the compile counter
(``utils/compile_counter.py``: kernel builds and CUDA-graph captures),
behind ``--compile-check``.  The static passes import no ``torch``, as
the reference's import no ``jax``.

Suppression contract (the reference's): the comment suppresses findings
of the named rule(s) on its own line, on the line directly below (the
comment-above form), or — when it trails a later line of a multi-line
*simple* statement — at that statement's first line, where findings
anchor::

    t0 = time.perf_counter()  # graftcheck: ignore[determinism] -- why

A reason is required, a suppression that matches no finding is itself a
finding, and the meta-rule ``suppression`` is not itself suppressible.
"""

from __future__ import annotations

import ast
import os
import re
import sys
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding",
    "SourceFile",
    "REGISTRY",
    "repo_root",
    "run",
    "compile_check",
    "main",
]


class Finding(NamedTuple):
    """One static-analysis violation, repo-relative."""

    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class SourceFile:
    """A parsed source file: text, lines, AST — parsed once per run and
    shared by every pass through the run cache (one parse per file, not
    one per pass — the round-13 wall-clock budget depends on it)."""

    def __init__(self, abspath: str, relpath: str):
        self.abspath = abspath
        self.path = relpath
        with open(abspath) as fh:
            self.text = fh.read()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=abspath)
        self._stmt_spans: Optional[List[Tuple[int, int]]] = None

    @property
    def stmt_spans(self) -> List[Tuple[int, int]]:
        """(lineno, end_lineno) of every SIMPLE statement — computed
        once per file and shared by all suppression-scope lookups
        (previously one full AST walk per suppression comment)."""
        if self._stmt_spans is None:
            self._stmt_spans = [
                (node.lineno, node.end_lineno or node.lineno)
                for node in ast.walk(self.tree)
                if isinstance(node, ast.stmt)
                and not isinstance(node, _COMPOUND_STMTS)
            ]
        return self._stmt_spans


class _Cache:
    """Per-run SourceFile cache so passes sharing files parse once."""

    def __init__(self, root: str):
        self.root = root
        self._files: Dict[str, SourceFile] = {}

    def get(self, rel: str) -> Optional[SourceFile]:
        if rel not in self._files:
            abspath = os.path.join(self.root, rel)
            if not os.path.isfile(abspath):
                self._files[rel] = None
            else:
                self._files[rel] = SourceFile(abspath, rel)
        return self._files[rel]


def repo_root() -> str:
    """The repository root (two levels above this package)."""
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------

#: ``# graftcheck: ignore[rule1,rule2] -- reason`` (reason mandatory).
_SUPPRESS_RE = re.compile(
    r"#\s*graftcheck:\s*ignore\[(?P<rules>[^\]]*)\]"
    r"(?:\s*--\s*(?P<reason>\S.*))?"
)


class Suppression(NamedTuple):
    path: str
    line: int
    rules: Tuple[str, ...]
    reason: Optional[str]


def find_suppressions(src: SourceFile) -> List[Suppression]:
    """Suppression comments in ``src`` — matched against actual COMMENT
    tokens, not raw lines, so suppression syntax *quoted* inside a
    docstring or string literal (e.g. documentation of the idiom) is
    never parsed as a live suppression."""
    import io
    import tokenize

    out: List[Suppression] = []
    try:
        tokens = list(
            tokenize.generate_tokens(io.StringIO(src.text).readline)
        )
    except (tokenize.TokenError, IndentationError):  # pragma: no cover
        # The file ast-parsed, so this should be unreachable; fail
        # open (no suppressions) rather than crash the run.
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if m is None:
            continue
        rules = tuple(
            r.strip() for r in m.group("rules").split(",") if r.strip()
        )
        out.append(
            Suppression(src.path, tok.start[0], rules, m.group("reason"))
        )
    return out


_COMPOUND_STMTS = (
    ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.If,
    ast.For, ast.AsyncFor, ast.While, ast.With, ast.AsyncWith, ast.Try,
)


def _suppression_scope(
    sup: Suppression, src: Optional[SourceFile]
) -> Set[int]:
    """Line numbers a suppression covers: its own line, the next line,
    and the FULL span of the closest SIMPLE statement it attaches to —
    either the one its line sits inside (a trailing comment on any line
    of a multi-line call) or the one starting directly below it (the
    comment-above form over a multi-line statement, whose findings can
    anchor on inner lines).  Compound statements are excluded so a
    comment inside a function body cannot blanket the whole def."""
    cover = {sup.line, sup.line + 1}
    if src is not None:
        best = None  # innermost simple statement containing sup.line
        for lineno, end in src.stmt_spans:
            if lineno <= sup.line <= end:
                if best is None or lineno > best[0]:
                    best = (lineno, end)
            elif lineno == sup.line + 1:
                # Comment-above form: cover the whole statement below.
                cover.update(range(lineno, end + 1))
        if best is not None:
            cover.update(range(best[0], best[1] + 1))
    return cover


# ---------------------------------------------------------------------------
# Registry + runner
# ---------------------------------------------------------------------------

def _registry():
    # Imported lazily so ``import pivot_tpu_torch.analysis`` stays cheap
    # and the pass modules can import framework types from here.
    from pivot_tpu_torch.analysis import (
        determinism,
        dtype,
        hostsync,
        kernel_budget,
        obsbound,
        parity,
        profbound,
        threadguard,
    )

    return {
        parity.RULE: parity,
        determinism.RULE: determinism,
        threadguard.RULE: threadguard,
        hostsync.RULE: hostsync,
        dtype.RULE: dtype,
        kernel_budget.RULE: kernel_budget,
        obsbound.RULE: obsbound,
        profbound.RULE: profbound,
    }


#: Rule name → pass module (each exposes ``RULE`` and
#: ``collect(cache) -> (findings, scanned_relpaths)``).
REGISTRY = _registry


def run(
    root: Optional[str] = None,
    rules: Optional[Iterable[str]] = None,
) -> List[Finding]:
    """Run the requested passes (default: all) over the tree at ``root``
    (default: this repo), apply suppressions, flag bad/stale
    suppressions, and return the surviving findings sorted by location.
    """
    root = root or repo_root()
    registry = REGISTRY()
    selected = list(registry) if rules is None else list(rules)
    unknown = [r for r in selected if r not in registry]
    if unknown:
        raise ValueError(
            f"unknown rule(s) {unknown}; known: {sorted(registry)}"
        )
    cache = _Cache(root)

    findings: List[Finding] = []
    scanned_by_rule: Dict[str, Set[str]] = {}
    for rule in selected:
        pass_findings, scanned = registry[rule].collect(cache)
        findings.extend(pass_findings)
        scanned_by_rule[rule] = set(scanned)

    # Suppression processing over every file any pass scanned.
    all_scanned = sorted(set().union(*scanned_by_rule.values(), set()))
    suppressions: List[Suppression] = []
    for rel in all_scanned:
        src = cache.get(rel)
        if src is not None:
            suppressions.extend(find_suppressions(src))

    known_rules = set(registry)
    scopes = [
        _suppression_scope(sup, cache.get(sup.path))
        for sup in suppressions
    ]
    used: Set[Tuple[int, str]] = set()  # (index into suppressions, rule)
    kept: List[Finding] = []
    for f in findings:
        suppressed = False
        for idx, sup in enumerate(suppressions):
            if (
                sup.path == f.path
                and f.rule in sup.rules
                and sup.reason
                and f.line in scopes[idx]
            ):
                used.add((idx, f.rule))
                suppressed = True
        if not suppressed:
            kept.append(f)

    # Bad / stale suppressions are findings of the (unsuppressible)
    # meta-rule ``suppression``.
    for idx, sup in enumerate(suppressions):
        if not sup.reason:
            kept.append(Finding(
                "suppression", sup.path, sup.line,
                "suppression without a justification — write "
                "`# graftcheck: ignore[rule] -- reason`",
            ))
            continue
        for rule in sup.rules:
            if rule not in known_rules:
                kept.append(Finding(
                    "suppression", sup.path, sup.line,
                    f"suppression names unknown rule {rule!r} "
                    f"(known: {sorted(known_rules)})",
                ))
            elif (
                rule in scanned_by_rule
                and sup.path in scanned_by_rule[rule]
                and (idx, rule) not in used
            ):
                kept.append(Finding(
                    "suppression", sup.path, sup.line,
                    f"stale suppression: no [{rule}] finding in its "
                    "scope (this line, the line below, or the span of "
                    "the simple statement it attaches to) — the "
                    "violation it excused is gone; delete the comment",
                ))

    kept.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return kept


def _span_once(device, H: int, B: int, K: int, seed: int, k_dyn: int):
    """One fused First-Fit span of the reference's compile-check shape
    (``pivot_tpu/analysis/__init__.py::_compile_check``)."""
    import numpy as np
    import torch

    from pivot_tpu_torch.ops.tickloop import fused_tick_run, span_bucket

    r0 = np.random.default_rng(0)
    avail = r0.uniform(1, 6, (H, 4))
    dem = r0.uniform(0.3, 2.0, (B, 4))
    r = np.random.default_rng(seed)
    res = fused_tick_run(
        torch.as_tensor(avail * r.uniform(0.9, 1.1, avail.shape),
                        dtype=torch.float32, device=device),
        torch.as_tensor(dem, dtype=torch.float32, device=device),
        torch.zeros(B, dtype=torch.int32, device=device), k_dyn,
        policy="first-fit", n_ticks=span_bucket(K),
    )
    return res.placements.cpu()


def _serve_once(device, n_hosts: int, n_jobs: int) -> dict:
    """The reference's serve dispatch path (``tests/test_jitcheck.py::
    _serve_once``): one Cost-Aware session, a seeded Poisson stream.  On
    the card every tick is a ``greedy_place`` launch."""
    from pivot_tpu_torch.serve.arrivals import poisson_arrivals
    from pivot_tpu_torch.serve.driver import ServeDriver
    from pivot_tpu_torch.serve.session import ServeSession
    from pivot_tpu_torch.utils import reset_ids
    from pivot_tpu_torch.utils.config import (
        ClusterConfig,
        PolicyConfig,
        build_cluster,
        make_policy,
    )

    reset_ids()
    session = ServeSession(
        "s0",
        build_cluster(ClusterConfig(n_hosts=n_hosts, seed=0)),
        make_policy(PolicyConfig(
            name="cost-aware", device="cuda", bin_pack="first-fit",
            sort_tasks=True, sort_hosts=True, adaptive=False,
        ), torch_device=str(device)),
        seed=0,
    )
    driver = ServeDriver([session], queue_depth=32, backpressure="shed")
    report = driver.run(poisson_arrivals(rate=0.1, n_jobs=n_jobs, seed=3))
    if report["slo"]["counters"]["completed"] != n_jobs:
        raise AssertionError(f"compile-check serve run completed "
                             f"{report['slo']['counters']['completed']} "
                             f"of {n_jobs} jobs")
    return report


def _snapshot_once(device, R: int, H: int) -> None:
    """Check one ensemble norm-snapshot graph of layout ``[R, H, 4]`` out
    of the pool and back (a capture the first time, on the card)."""
    import torch

    from pivot_tpu_torch.parallel.ensemble import tick

    avail = torch.ones((R, H, 4), dtype=torch.float32, device=device)
    buf, snap, entry = tick._norm_snapshot(avail, None)
    buf.copy_(avail)
    snap()
    if entry is not None:
        tick.SNAPSHOT_GRAPHS.give(entry)


def compile_check(quick: bool, device: str = "cuda") -> dict:
    """The falsifying runtime twin of the reference's ``retrace`` pass,
    in the port's terms: warm the fused span driver, the serve dispatch
    path and (``quick`` off) one ensemble norm-snapshot shape, then
    repeat them with new data in a steady window under
    :func:`~pivot_tpu_torch.utils.compile_counter.count_compiles`.
    Returns ``{"device", "warmup": {kind: n}, "steady": {kind: n}}``;
    the steady counts must be zero."""
    import torch

    from pivot_tpu_torch.utils.compile_counter import count_compiles

    dev = torch.device(device)
    H, B, K = (8, 8, 4) if quick else (64, 32, 8)
    n_hosts, n_jobs = (8, 3) if quick else (8, 6)
    with count_compiles() as warm:
        _span_once(dev, H, B, K, 0, K)
        _serve_once(dev, n_hosts, n_jobs)
        if not quick:
            _snapshot_once(dev, 4, H)
    with count_compiles() as steady:
        for seed in range(1, 4):
            _span_once(dev, H, B, K, seed, K - 1 - seed % 2)
        _serve_once(dev, n_hosts, n_jobs)
        if not quick:
            _snapshot_once(dev, 4, H)
    return {
        "device": str(dev),
        "warmup": {"kernel_build": warm.kernel_builds,
                   "graph_capture": warm.graph_captures},
        "steady": {"kernel_build": steady.kernel_builds,
                   "graph_capture": steady.graph_captures},
    }


def _compile_check(quick: bool, device: str) -> int:
    res = compile_check(quick, device)
    steady = res["steady"]
    if any(steady.values()):
        print(
            f"compile-check: FAILED — {steady['kernel_build']} kernel "
            f"build(s), {steady['graph_capture']} graph capture(s) after "
            f"warmup on {res['device']} (steady state must be zero)",
            file=sys.stderr,
        )
        return 1
    print(
        f"compile-check: zero kernel builds and graph captures after "
        f"warmup on {res['device']} (fused-span and serve dispatch paths"
        f"{'' if quick else ', ensemble snapshot'}; warm-up counted "
        f"{res['warmup']['kernel_build']} build(s), "
        f"{res['warmup']['graph_capture']} capture(s))"
    )
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI: exit 1 on findings.  ``--rules a,b`` filters passes (unknown
    names exit 2 listing the valid set); ``--json`` prints the findings
    machine-readably; ``--root`` points at another tree (tests use
    this); ``--compile-check`` runs the runtime harness on ``--device``
    (``cuda`` unless ``--device cpu`` is given)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="graftcheck",
        description="static analysis of pivot_tpu_torch: backend knob "
        "parity, replay determinism, thread-guard discipline, host-sync "
        "lint, dtype, the greedy_place kernel budget, and the "
        "observability and profiler boundary pins",
    )
    parser.add_argument(
        "--rules",
        help="comma-separated rule subset (default: all); unknown "
        "names error listing the valid rule set",
    )
    parser.add_argument("--root", help="tree to analyze (default: repo)")
    parser.add_argument(
        "--list-rules", action="store_true", help="list rules and exit"
    )
    parser.add_argument(
        "--json", action="store_true",
        help="machine-readable findings on stdout: {rule, path, line, "
        "message} per finding (CI annotates per file:line from this)",
    )
    parser.add_argument(
        "--compile-check", nargs="?", const="quick", default=None,
        choices=("quick", "full"),
        help="run the runtime compile-counter harness (imports torch): "
        "warm the fused span driver and the serve dispatch path (full: "
        "and one ensemble snapshot shape), then assert ZERO kernel "
        "builds and CUDA-graph captures in steady state",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of --compile-check (default cuda)",
    )
    args = parser.parse_args(argv)
    registry = REGISTRY()
    if args.list_rules:
        if args.json:
            import json

            print(json.dumps({
                rule: (mod.__doc__ or "").strip().splitlines()[0]
                for rule, mod in registry.items()
            }, indent=2))
            return 0
        for rule, mod in registry.items():
            doc = (mod.__doc__ or "").strip().splitlines()
            print(f"{rule}: {doc[0] if doc else ''}")
        return 0
    if args.compile_check is not None:
        return _compile_check(args.compile_check == "quick", args.device)
    rules = (
        [r.strip() for r in args.rules.split(",") if r.strip()]
        if args.rules else None
    )
    try:
        findings = run(root=args.root, rules=rules)
    except ValueError as exc:
        print(f"graftcheck: {exc}", file=sys.stderr)
        return 2
    if args.json:
        import json

        print(json.dumps(
            {
                "clean": not findings,
                "rules": rules or sorted(registry),
                "findings": [f._asdict() for f in findings],
            },
            indent=2,
        ))
        return 1 if findings else 0
    for f in findings:
        print(f, file=sys.stderr)
    if findings:
        print(
            f"graftcheck: {len(findings)} finding(s)", file=sys.stderr
        )
        return 1
    n = len(rules) if rules else len(registry)
    print(f"graftcheck: clean ({n} pass(es))")
    return 0
