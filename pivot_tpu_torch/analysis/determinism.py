"""Determinism lint: the replay=bit-identical contract, statically.

Port of ``pivot_tpu/analysis/determinism.py``, with the reference's
scope rewritten to the port's modules and its rules unchanged: replaying
a seeded schedule on a seeded world must reproduce the fault log, the
meter and every placement bit for bit, and the CPU parity tests hold the
port to ``pivot_tpu`` bit for bit.  Both promises die the moment
replay-critical code reads a wall clock, consumes process-global RNG
state, or iterates a hash-ordered container:

  * **wall-clock reads** — ``time.time()`` / ``monotonic()`` /
    ``perf_counter()`` / … and ``datetime.now()``-family calls (pure
    measurement uses carry ``ignore[determinism]`` suppressions saying
    so);
  * **global / unseeded RNG** — ``random.*`` module state and
    ``np.random.*`` module-state calls (the seeded constructors stay
    allowed);
  * **hash-ordered iteration** — iteration over set expressions and
    ``os.environ``.

The torch forms of the same hazards:

  * **torch's global generator** — ``torch.manual_seed`` /
    ``torch.seed`` / ``torch.set_rng_state``, and ``torch.rand`` /
    ``rand_like`` / ``randn`` / ``randn_like`` / ``randint`` /
    ``randint_like`` / ``randperm`` / ``bernoulli`` / ``multinomial`` /
    ``normal`` / ``poisson`` (and the tensor methods ``.bernoulli_`` /
    ``.uniform_`` / ``.normal_`` / ``.exponential_`` /
    ``.random_``) without a ``generator=`` — the port draws from its own
    Philox twins (``sched/rand.py``, ``parallel/ensemble/prng.py``);
  * **order-free accumulation** — ``index_add_`` / ``index_add``,
    ``scatter_add_`` / ``scatter_add``, ``index_put_`` / ``index_put``
    with ``accumulate=True``, and ``scatter_reduce`` with ``"sum"`` /
    ``"mean"``: on the card the floating-point adds of colliding indices
    need not follow the inputs' order (atomics), so the sum's bits are
    not a function of the inputs.  A site whose order is argued (integer
    or 0/1 operands, indices that never collide, ``index_put_``'s
    sort-ordered accumulate) carries that argument as its suppression's
    reason.

The scope adds ``parallel/`` (the ensemble's rollout, whose results the
tests hold bitwise to ``pivot_tpu``'s) to the reference's.
"""

from __future__ import annotations

import ast
import os
from typing import List, Tuple

from pivot_tpu_torch.analysis import Finding, SourceFile

RULE = "determinism"

#: Replay-critical modules (repo-relative files or directories).
SCOPE = (
    "pivot_tpu_torch/des",
    "pivot_tpu_torch/infra/faults.py",
    "pivot_tpu_torch/infra/market.py",
    "pivot_tpu_torch/sched",
    "pivot_tpu_torch/ops",
    # The policy-search subsystem (round 16): search runs must replay —
    # same seed + same env ⇒ identical winning vector and fitness trace
    # — so its optimizers and fitness plumbing live under the same lint
    # as the DES core (seeded generators only, no wall-clock reads).
    "pivot_tpu_torch/search",
    # Model-predictive serving (round 19): the SCORING half of the MPC
    # loop — the forecaster's fit and the planner's fused action
    # dispatch — must replay bit-for-bit (every actuation is auditable
    # from its recorded inputs).  The controller/tuner/rollout threads
    # do wall-clock pacing and stay outside, like serve/.
    "pivot_tpu_torch/mpc/forecast.py",
    "pivot_tpu_torch/mpc/planner.py",
    # The ensemble rollout and its sweeps (held bitwise to pivot_tpu's
    # fixtures): where the port's order-free accumulate sites live.
    "pivot_tpu_torch/parallel",
)

_WALL_FNS = {
    "time", "time_ns", "monotonic", "monotonic_ns",
    "perf_counter", "perf_counter_ns", "process_time",
    "process_time_ns",
}
_DATETIME_FNS = {"now", "utcnow", "today"}
_NUMPY_ALIASES = {"np", "numpy", "onp"}
#: Seeded-generator constructors: the sanctioned numpy RNG idiom.
_SEEDED_OK = {
    "default_rng", "Generator", "RandomState", "SeedSequence",
    "Philox", "PCG64", "PCG64DXSM", "MT19937", "SFC64", "BitGenerator",
}
#: torch's global-generator state calls, and the sampling functions
#: that draw from it unless given ``generator=``.
_TORCH_GLOBAL_STATE = {"manual_seed", "seed", "set_rng_state"}
_TORCH_SAMPLERS = {
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "bernoulli", "multinomial", "normal", "poisson",
}
_TENSOR_SAMPLERS = {
    "bernoulli_", "uniform_", "normal_", "exponential_", "random_",
    "cauchy_", "geometric_", "log_normal_",
}
#: Accumulating scatters whose float adds are atomic on the card.
_ACCUMULATE = {"index_add_", "index_add", "scatter_add_", "scatter_add"}
_INDEX_PUT = {"index_put_", "index_put"}
_SCATTER_REDUCE = {"scatter_reduce", "scatter_reduce_"}

#: Consuming one of these around a set expression leaks hash order.
_ORDER_SENSITIVE_CALLS = {"list", "tuple", "iter", "enumerate", "reversed"}


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id in {"set", "frozenset"}
    )


def _is_os_environ(node: ast.AST) -> bool:
    if (
        isinstance(node, ast.Attribute)
        and node.attr == "environ"
        and isinstance(node.value, ast.Name)
        and node.value.id == "os"
    ):
        return True
    # os.environ.keys()/values()/items()
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in {"keys", "values", "items"}
        and _is_os_environ(node.func.value)
    )


def _check_call(node: ast.Call, path: str) -> List[Finding]:
    out: List[Finding] = []
    f = node.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        base, attr = f.value.id, f.attr
        if base == "time" and attr in _WALL_FNS:
            out.append(Finding(
                RULE, path, node.lineno,
                f"wall-clock read time.{attr}() in a replay-critical "
                "module — replay must be a pure function of "
                "(seed, schedule)",
            ))
        elif base == "datetime" and attr in _DATETIME_FNS:
            out.append(Finding(
                RULE, path, node.lineno,
                f"wall-clock read datetime.{attr}() in a "
                "replay-critical module",
            ))
        elif base == "random" and attr != "Random":
            out.append(Finding(
                RULE, path, node.lineno,
                f"global-state RNG random.{attr}() — use a seeded "
                "np.random generator (or random.Random(seed))",
            ))
    if (
        isinstance(f, ast.Attribute)
        and isinstance(f.value, ast.Attribute)
        and isinstance(f.value.value, ast.Name)
    ):
        # np.random.<fn>(...) / datetime.datetime.now(...)
        root, mid, attr = f.value.value.id, f.value.attr, f.attr
        if (
            root in _NUMPY_ALIASES
            and mid == "random"
            and attr not in _SEEDED_OK
        ):
            out.append(Finding(
                RULE, path, node.lineno,
                f"module-state RNG {root}.random.{attr}() — seed a "
                f"generator ({root}.random.default_rng(seed)) instead",
            ))
        elif root == "datetime" and mid in {
            "datetime", "date"
        } and attr in _DATETIME_FNS:
            out.append(Finding(
                RULE, path, node.lineno,
                f"wall-clock read datetime.{mid}.{attr}() in a "
                "replay-critical module",
            ))
    return out


def _kw(node: ast.Call, name: str):
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_true(node) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _check_torch_call(node: ast.Call, path: str) -> List[Finding]:
    """torch's global generator and the order-free accumulate ops."""
    out: List[Finding] = []
    f = node.func
    if not isinstance(f, ast.Attribute):
        return out
    attr = f.attr
    is_torch = isinstance(f.value, ast.Name) and f.value.id == "torch"
    if is_torch and attr in _TORCH_GLOBAL_STATE:
        out.append(Finding(
            RULE, path, node.lineno,
            f"torch.{attr}() touches torch's process-global generator — "
            "draw from a seeded torch.Generator or the port's Philox "
            "twins instead",
        ))
    elif ((is_torch and attr in _TORCH_SAMPLERS)
          or (not is_torch and attr in _TENSOR_SAMPLERS)) and (
            _kw(node, "generator") is None):
        shown = f"torch.{attr}" if is_torch else f".{attr}"
        out.append(Finding(
            RULE, path, node.lineno,
            f"{shown}(...) without generator= draws from torch's "
            "process-global generator — pass a seeded torch.Generator",
        ))
    elif attr in _ACCUMULATE or (
        attr in _INDEX_PUT and _is_true(
            node.args[2] if len(node.args) > 2 else _kw(node, "accumulate"))
    ) or (
        attr in _SCATTER_REDUCE
        and any(isinstance(a, ast.Constant) and a.value in ("sum", "mean")
                for a in [*node.args, *(k.value for k in node.keywords)])
    ):
        out.append(Finding(
            RULE, path, node.lineno,
            f".{attr}(...) is an accumulating scatter: on the card its "
            "floating-point adds need not follow the inputs' order "
            "(atomics) — use an ordered reduction, or suppress with the "
            "argument (integer or 0/1 operands, indices that never "
            "collide, a sort-ordered accumulate)",
        ))
    return out


def _check_import(node: ast.AST, path: str) -> List[Finding]:
    """The call checks above key on literal base names (``time.X``,
    ``random.X``, ``np.random.X``); an aliased or from-import would
    bypass them silently, so the import statements themselves are
    banned in scope — import the module unaliased and call through it
    (review finding, round 12)."""
    out: List[Finding] = []
    if isinstance(node, ast.Import):
        for alias in node.names:
            if alias.name in {"time", "random"} and alias.asname:
                out.append(Finding(
                    RULE, path, node.lineno,
                    f"aliased import `import {alias.name} as "
                    f"{alias.asname}` defeats the determinism lint — "
                    "import it unaliased so the call checks see it",
                ))
            elif alias.name == "numpy.random" or (
                alias.name == "numpy"
                and alias.asname not in (None, *_NUMPY_ALIASES)
            ):
                shown = alias.name + (
                    f" as {alias.asname}" if alias.asname else ""
                )
                out.append(Finding(
                    RULE, path, node.lineno,
                    f"`import {shown}` defeats the determinism lint — "
                    "use `import numpy as np` and the np.random.* "
                    "seeded constructors",
                ))
    elif isinstance(node, ast.ImportFrom):
        names = {alias.name for alias in node.names}
        if node.module == "time" and names & _WALL_FNS:
            out.append(Finding(
                RULE, path, node.lineno,
                f"`from time import {', '.join(sorted(names & _WALL_FNS))}`"
                " defeats the determinism lint — import the module and "
                "call through it (so bans and suppressions attach to "
                "the call sites)",
            ))
        elif node.module == "random" and names - {"Random"}:
            out.append(Finding(
                RULE, path, node.lineno,
                "`from random import ...` pulls module-state RNG into "
                "scope — use a seeded generator",
            ))
        elif node.module == "numpy.random" and names - _SEEDED_OK:
            out.append(Finding(
                RULE, path, node.lineno,
                "`from numpy.random import "
                f"{', '.join(sorted(names - _SEEDED_OK))}` pulls "
                "module-state RNG into scope — seed a generator instead",
            ))
        elif node.module == "numpy" and "random" in names:
            out.append(Finding(
                RULE, path, node.lineno,
                "`from numpy import random` defeats the determinism "
                "lint — use `import numpy as np`",
            ))
        elif node.module == "datetime" and names & {"datetime", "date"}:
            # ``datetime.now()`` on the from-imported class matches the
            # two-level attribute check, so only note the import when
            # it renames.
            for alias in node.names:
                if alias.name in {"datetime", "date"} and alias.asname:
                    out.append(Finding(
                        RULE, path, node.lineno,
                        f"aliased `from datetime import {alias.name} as "
                        f"{alias.asname}` defeats the determinism lint",
                    ))
    return out


def _iter_message(path: str, lineno: int, what: str) -> Finding:
    return Finding(
        RULE, path, lineno,
        f"iteration over {what} is hash-ordered (env-dependent) — "
        "sort it (sorted(...)) or use an order-preserving container",
    )


def scan_source(src: SourceFile) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(src.tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out.extend(_check_import(node, src.path))
        elif isinstance(node, ast.Call):
            out.extend(_check_call(node, src.path))
            out.extend(_check_torch_call(node, src.path))
            if (
                isinstance(node.func, ast.Name)
                and node.func.id in _ORDER_SENSITIVE_CALLS
                and node.args
                and _is_set_expr(node.args[0])
            ):
                out.append(_iter_message(
                    src.path, node.lineno,
                    f"a set expression via {node.func.id}(...)",
                ))
        elif isinstance(node, ast.For):
            if _is_set_expr(node.iter):
                out.append(_iter_message(
                    src.path, node.lineno, "a set expression"
                ))
            elif _is_os_environ(node.iter):
                out.append(_iter_message(
                    src.path, node.lineno, "os.environ"
                ))
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                if _is_set_expr(gen.iter):
                    out.append(_iter_message(
                        src.path, node.lineno,
                        "a set expression (comprehension)",
                    ))
                elif _is_os_environ(gen.iter):
                    out.append(_iter_message(
                        src.path, node.lineno, "os.environ"
                    ))
    return out


def _scope_files(root: str) -> List[str]:
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
    import os as _os

    out: List[Finding] = []
    scanned: List[str] = []
    for entry in SCOPE:
        if not _os.path.exists(_os.path.join(cache.root, entry)):
            out.append(Finding(
                RULE, entry, 0,
                f"replay-critical scope entry {entry} is missing — "
                "renamed/deleted? update determinism SCOPE (it lost "
                "all lint coverage)",
            ))
    for rel in _scope_files(cache.root):
        src = cache.get(rel)
        if src is None:
            continue
        scanned.append(rel)
        out.extend(scan_source(src))
    return out, scanned
