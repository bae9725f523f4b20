"""Thread-guard discipline: declared guarded-by maps, checked lexically.

Port of ``pivot_tpu/analysis/threadguard.py``: the reference's
:data:`GUARDS` rewritten to the port's classes (``sched/batch.py``,
``serve/driver.py``, ``mpc/controller.py``, ``serve/autoscale.py``),
plus the port's own threaded state that holds a lock
(``recover/watchdog.py``).  The reference's text follows.

The threaded serve/batch layer (session threads, the producer, the
flush coordinator, the watchdog, the autoscaler) serializes its shared
state behind per-object condition variables — ``ServeDriver._cv`` and
``DispatchBatcher._cond``.  The discipline is documented in docstrings
("cv held") and enforced by nothing; a new code path reading
``self._inflight`` without the lock compiles, passes the determinism
suites (races are timing-dependent by definition), and corrupts a
ledger once a quarter.

This pass makes the guarded-by relation *declared data*
(:data:`GUARDS`) and checks it lexically: every load/store of a
declared guarded field must sit inside a ``with self.<lock>:`` block
(or inside a ``lambda`` under one — ``Condition.wait_for`` predicates
run with the lock held), or in a method declared ``held`` (documented
lock-held helpers: the "(cv held)" docstring convention, now
machine-checked against the map) or ``exempt`` (single-threaded
lifecycle phases: constructors before any thread exists, ``run``'s
setup/teardown around its join barrier).  Accesses of guarded fields
through a *foreign* object (``driver._stop`` from the autoscaler
thread) are checked the same way against the owning class's lock.

Lexical scope is the deliberate precision limit: a nested ``def``
body is treated as UNguarded even under a ``with`` (closures execute
later, the lock may be long released), while ``lambda`` keeps the
enclosing guard state (the wait-predicate idiom).  What the pass
cannot prove, code must either restructure or suppress with a written
justification — the suppression inventory IS the audit of benign
racy reads (monotonic stop flags, snapshot iteration).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from pivot_tpu_torch.analysis import Finding, SourceFile

RULE = "thread-guard"

#: repo-relative file → {class name: guard spec}.  ``fields`` are the
#: attributes the class's lock guards; ``held`` methods are documented
#: to run with the lock already held (their call sites are inside
#: ``with`` blocks — the "(cv held)" docstring convention); ``exempt``
#: methods are single-threaded by lifecycle (no concurrent thread can
#: exist while they run).
GUARDS: Dict[str, Dict[str, dict]] = {
    "pivot_tpu_torch/sched/batch.py": {
        "DispatchBatcher": {
            "lock": "_cond",
            "fields": (
                "_pending", "_open", "_idle", "_clients", "_n_slots",
                "stats",
            ),
            # _quiescent is the coordinator's wait_for predicate —
            # Condition.wait_for evaluates it with the lock held.
            "held": ("_quiescent",),
            "exempt": ("__init__",),
        },
    },
    "pivot_tpu_torch/serve/driver.py": {
        "ServeDriver": {
            "lock": "_cv",
            "fields": (
                "_released", "_stop", "_draining", "_errors", "_rr",
                "_inflight", "_admit_seq", "_waiting_tier",
                "_preempt_outstanding", "_restarts", "_n_grown",
                "sessions", "_threads", "_abandoned", "_retired",
            ),
            # The "(cv held)" helpers: called only under the cv by
            # their docstring contract.
            "held": (
                "_release_to", "_recover_inflight", "_requeue",
                "_wire_and_start", "_try_preempt", "_reoffer_spilled",
                "_register_inflight", "_route", "_preempt_for",
                "_release_one", "_batching_compatible",
            ),
            # Single-threaded lifecycle phases: __init__ precedes every
            # thread; report/audit run on the drained service.
            # publish_metrics is NOT exempt since round 15 — the
            # --metrics-port scrape endpoint calls it mid-run, so its
            # pool-state reads must (and do) snapshot under the cv.
            # run() is NOT exempt — its setup section is pre-thread
            # (per-line suppressions say so), but its join loop runs
            # concurrently with supervisor restarts and stays checked
            # (that is where this pass caught the _threads iteration
            # race).
            "exempt": ("__init__", "report", "audit"),
        },
    },
    "pivot_tpu_torch/mpc/controller.py": {
        # Same shape as the autoscaler below: the MPC controller owns
        # no guarded state (its forecaster/tuner/rollout lock or
        # thread-confine internally; every pool mutation goes through
        # ServeDriver methods).  The entry puts the file in scope so
        # foreign reads of driver fields (``driver._stop``) are
        # checked and its suppressions staleness-tracked.
        "MpcController": {
            "lock": None,
            "fields": (),
            "held": (),
            "exempt": ("__init__",),
        },
    },
    "pivot_tpu_torch/recover/watchdog.py": {
        # The recovery plane's watchdog: the serving and batcher threads
        # dispatch through one watchdog, so its counters and the
        # penalty box's rows sit behind their own locks.
        "PenaltyBox": {
            "lock": "_lock",
            "fields": ("_rows",),
            "held": (),
            "exempt": ("__init__",),
        },
        "DispatchWatchdog": {
            "lock": "_lock",
            "fields": ("timeouts", "failures", "sheds", "retries_total"),
            "held": (),
            "exempt": ("__init__",),
        },
    },
    "pivot_tpu_torch/serve/autoscale.py": {
        # The autoscaler owns no guarded state of its own: every pool
        # mutation goes through ServeDriver methods (which take the
        # driver's cv), its event log is autoscaler-thread-confined
        # until ``stop()`` joins the thread, and its stop flag is a
        # threading.Event.  The entry exists so the file is in scope:
        # foreign reads of ServeDriver fields (``driver._stop``) are
        # checked here, and suppressions in it are staleness-tracked.
        "SloAutoscaler": {
            "lock": None,
            "fields": (),
            "held": (),
            "exempt": ("__init__",),
        },
    },
}


def _lock_items(node: ast.With, lock: str) -> bool:
    for item in node.items:
        expr = item.context_expr
        if (
            isinstance(expr, ast.Attribute)
            and expr.attr == lock
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
        ):
            return True
    return False


class _GuardVisitor(ast.NodeVisitor):
    """Walk one method body tracking lexical ``with <base>.<lock>``
    nesting; record unguarded accesses of guarded fields."""

    def __init__(self, src: SourceFile, lock: Optional[str],
                 fields: Set[str], method: str,
                 foreign_owners: Dict[str, Tuple[str, str]]):
        self.src = src
        self.lock = lock
        self.fields = fields
        self.method = method
        #: guarded-field name → (owning class, its lock) for foreign
        #: (non-self) accesses.
        self.foreign_owners = foreign_owners
        self.depth_self = 0
        #: (foreign base name, lock attr) → with-nesting depth
        self.depth_foreign: Dict[Tuple[str, str], int] = {}
        self.findings: List[Finding] = []

    # -- scope rules ------------------------------------------------------
    def visit_FunctionDef(self, node: ast.FunctionDef):
        # Nested def: executes later; the enclosing lock may be
        # released.  Reset guard state for its body.
        saved_self, saved_foreign = self.depth_self, self.depth_foreign
        self.depth_self, self.depth_foreign = 0, {}
        self.generic_visit(node)
        self.depth_self, self.depth_foreign = saved_self, saved_foreign

    visit_AsyncFunctionDef = visit_FunctionDef

    # Lambdas keep the enclosing guard state: the dominant use is the
    # ``cv.wait_for(lambda: ...)`` predicate, which runs lock-held.

    def visit_With(self, node: ast.With):
        held_self = self.lock is not None and _lock_items(node, self.lock)
        all_locks = {lock for _cls, lock in self.foreign_owners.values()}
        held_foreign: List[Tuple[str, str]] = []
        for item in node.items:
            expr = item.context_expr
            if (
                isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id != "self"
                and expr.attr in all_locks
            ):
                held_foreign.append((expr.value.id, expr.attr))
        if held_self:
            self.depth_self += 1
        for key in held_foreign:
            self.depth_foreign[key] = self.depth_foreign.get(key, 0) + 1
        self.generic_visit(node)
        if held_self:
            self.depth_self -= 1
        for key in held_foreign:
            self.depth_foreign[key] -= 1

    visit_AsyncWith = visit_With

    # -- the accesses -----------------------------------------------------
    def visit_Attribute(self, node: ast.Attribute):
        if isinstance(node.value, ast.Name):
            base = node.value.id
            if base == "self" and node.attr in self.fields:
                if self.depth_self == 0:
                    self.findings.append(Finding(
                        RULE, self.src.path, node.lineno,
                        f"self.{node.attr} accessed outside `with "
                        f"self.{self.lock}:` in {self.method}() — the "
                        "guarded-by map declares it lock-protected",
                    ))
            elif base != "self" and node.attr in self.foreign_owners:
                cls, lock = self.foreign_owners[node.attr]
                if self.depth_foreign.get((base, lock), 0) == 0:
                    self.findings.append(Finding(
                        RULE, self.src.path, node.lineno,
                        f"{base}.{node.attr} ({cls}-guarded field) "
                        f"accessed outside `with {base}.{lock}:` in "
                        f"{self.method}()",
                    ))
        self.generic_visit(node)


def _foreign_owner_map(
    exclude_fields: Set[str],
) -> Dict[str, Tuple[str, str]]:
    """guarded-field name → (owning class, lock), across every mapped
    class — how ``driver._stop`` in another file gets checked.  Fields
    guarded by the class under inspection are excluded (those are the
    ``self`` path)."""
    owners: Dict[str, Tuple[str, str]] = {}
    for classes in GUARDS.values():
        for cls, spec in classes.items():
            for field in spec["fields"]:
                if field not in exclude_fields:
                    owners.setdefault(field, (cls, spec["lock"]))
    return owners


def check_source(
    src: SourceFile, class_guards: Dict[str, dict]
) -> List[Finding]:
    """Check one file against its class guard specs (exposed separately
    so the seeded-violation tests can drive synthetic files)."""
    out: List[Finding] = []
    found: Set[str] = set()
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        spec = class_guards.get(node.name)
        if spec is None:
            continue
        found.add(node.name)
        fields = set(spec["fields"])
        skip = set(spec.get("held", ())) | set(spec.get("exempt", ()))
        foreign = _foreign_owner_map(exclude_fields=fields)
        for item in node.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if item.name in skip:
                continue
            visitor = _GuardVisitor(
                src, spec["lock"], fields, item.name, foreign
            )
            # Visit the body directly (not the def node) so the
            # method's own def doesn't reset the guard state.
            for stmt in item.body:
                visitor.visit(stmt)
            out.extend(visitor.findings)
    # Module-level and unmapped-class code in a mapped file still gets
    # the foreign-field check (closed_loop_source reads driver._stop).
    foreign_all = _foreign_owner_map(exclude_fields=set())
    mapped_classes = set(class_guards)

    class _Module(ast.NodeVisitor):
        def __init__(self):
            self.findings: List[Finding] = []

        def visit_ClassDef(self, node: ast.ClassDef):
            if node.name in mapped_classes:
                return  # handled above with the class's own spec
            self._scan(node)

        def _scan(self, node):
            visitor = _GuardVisitor(
                src, None, set(), "<module>", foreign_all
            )
            for stmt in (
                node.body if hasattr(node, "body") else [node]
            ):
                visitor.visit(stmt)
            self.findings.extend(visitor.findings)

        def visit_FunctionDef(self, node):
            self._scan(node)

        visit_AsyncFunctionDef = visit_FunctionDef

    mod = _Module()
    for stmt in src.tree.body:
        mod.visit(stmt)
    out.extend(mod.findings)
    for cls in set(class_guards) - found:
        out.append(Finding(
            RULE, src.path, 1,
            f"guarded class {cls} not found — update the guarded-by "
            "map (pivot_tpu_torch/analysis/threadguard.py) after renames",
        ))
    return out


def collect(cache) -> Tuple[List[Finding], List[str]]:
    out: List[Finding] = []
    scanned: List[str] = []
    for rel, class_guards in GUARDS.items():
        src = cache.get(rel)
        if src is None:
            out.append(Finding(
                RULE, rel, 0,
                f"guard-mapped file {rel} is missing — renamed/deleted? "
                "update the guarded-by map (its classes lost all "
                "static coverage)",
            ))
            continue
        scanned.append(rel)
        out.extend(check_source(src, class_guards))
    return out, scanned
