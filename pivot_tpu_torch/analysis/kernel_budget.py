"""Kernel-budget pass: the hand kernels' shared memory and threads.

Recomputed from their CUDA sources: ``greedy_place`` (below),
``carry_free_place`` (:func:`collect_carry_free`: its sizing functions
— ``smem_bytes``, ``max_threads``, ``host_range`` — translated from the
CUDA text and evaluated, and its named constants, held against the wrapper's
``_cf_smem_bytes`` / ``_CF_CHUNK`` / ``_CF_MAX_THREADS`` and against the
card's opt-in shared memory and threads per block) and
``ensemble_chain`` (:func:`collect_ensemble_chain`: the same for its
``smem_bytes`` / ``max_threads`` and constants against the wrapper's
``_chain_smem_bytes`` / ``_CHAIN_*``).
Counterpart of ``pivot_tpu/analysis/pallas_budget.py``.  The reference
recomputes each Pallas kernel's VMEM footprint from its BlockSpecs and
holds it against the hand formulas the auto-sizer trusts and the
roofline's budget.  ``greedy_place`` sizes its launch against tables
that exist twice — once in ``csrc/greedy_place.cu`` (``table_bytes`` /
``group_bytes`` / ``cluster_bytes`` / ``smem_bytes`` / ``global_bytes``,
``max_threads``, ``kMaxCluster``, the instantiated K of ``dispatch``)
and once in the Python sizer ``ops/cuda_kernels.py`` (``_smem_bytes``,
``_global_smem_bytes``, ``_REG_THREADS``, ``_SMEM_K``, ``MAX_CLUSTER``,
``_GLOBAL_THREADS``, ``_SMEM_LIMIT``).  A copy edited without the other
launches a block the kernel refuses, or one whose shared memory overruns
its opt-in.  This pass closes the loop without a card:

  1. **Read** the CUDA source: its named constants (``kSmemK``,
     ``kMaxCluster``, ``kMaxChunk``) and its sizing functions
     (``align16``, ``chunk_of``, ``table_bytes``, ``group_bytes``,
     ``cluster_bytes``, ``smem_bytes``, ``global_bytes``,
     ``max_threads``), translated to Python and evaluated as
     ``carry_free_place``'s are.  A formula rewritten past what the
     pass can read is itself a finding.
  2. **Drift check**: the Python sizers equal the CUDA formulas at every
     probe point (one CTA, each cluster size, the global form), and the
     thread tables, instantiated K and cluster limit agree.
  3. **Budget check**: the wrapper's ``_SMEM_LIMIT`` equals the H100's
     opt-in shared memory per block in ``infra/roofline.py``
     (``H100_SMEM_OPTIN_BYTES``), and the largest block the wrapper can
     ask for — a CTA of the 16-CTA cluster, ``MAX_HOSTS`` hosts of it,
     at the CLI's 31 zones — fits it.
  4. **Registers**: ``max_threads(K) × registers ≤ 65,536``
     (``H100_REGS_PER_BLOCK``) wherever a register count is known — the
     static run knows none; ``register_findings`` takes ``ptxas``'s
     counts (``chip_smoke.py`` phases 1 and 14).

The pass imports neither ``torch`` nor the wrapper: the Python sizer is
evaluated from its own AST in an empty namespace.
"""

from __future__ import annotations

import ast
import re
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

from pivot_tpu_torch.analysis import Finding, SourceFile

RULE = "kernel-budget"

_CU_FILE = "pivot_tpu_torch/csrc/greedy_place.cu"
_WRAPPER_FILE = "pivot_tpu_torch/ops/cuda_kernels.py"
_ROOFLINE_FILE = "pivot_tpu_torch/infra/roofline.py"
_CF_CU_FILE = "pivot_tpu_torch/csrc/carry_free_place.cu"
_CHAIN_CU_FILE = "pivot_tpu_torch/csrc/ensemble_chain.cu"
_BUDGET_CONSTS = ("H100_SMEM_OPTIN_BYTES", "H100_REGS_PER_BLOCK",
                  "H100_MAX_THREADS_PER_BLOCK")

#: Zones of the CLI's default cluster (``infra/gen.py``'s 31 regions):
#: the largest table the shipped configurations stage.
_CLI_ZONES = 31
_Z_PROBES = (1, 7, 31, 64)
_W_PROBES = (1, 2, 4, 19, 32)
_G_PROBES = (1, 2, 15)
_C_PROBES = (1, 2, 4, 8, 16)


class CudaModel(NamedTuple):
    """``greedy_place.cu``'s sizing: its constants and its sizing
    functions, evaluated from the source's own text."""

    smem_k: int                  # kSmemK
    max_cluster: int             # kMaxCluster
    ks: Tuple[int, ...]          # register-state K of dispatch()
    launch_bounded: bool         # __launch_bounds__(max_threads(K, kSmem), 1)
    fns: Dict[str, Callable]     # _GP_FUNCTIONS, translated to Python

    def max_threads(self, K: int, smem_state: bool) -> int:
        """``max_threads`` of the CUDA source."""
        return self.fns["max_threads"](K, smem_state)

    @property
    def threads_smem(self) -> int:
        """The shared-memory (and global-form) builds' thread limit."""
        return self.max_threads(self.smem_k, True)

    def smem_bytes(self, Z: int, W: int, G: int, K: int,
                   smem_state: bool, C: int = 1) -> int:
        """``smem_bytes`` of the CUDA source (C CTAs a cluster)."""
        return self.fns["smem_bytes"](Z, W, G, K, smem_state, C)

    def global_bytes(self, Z: int) -> int:
        """``global_bytes`` of the CUDA source: the global form's block."""
        return self.fns["global_bytes"](Z)


#: The named constants ``greedy_place.cu``'s sizing reads, and the sizing
#: functions the pass evaluates, each with arguments it is probed at when
#: read (:func:`_c_function`, the evaluator ``carry_free_place`` uses).
_GP_CONSTS = ("kSmemK", "kMaxCluster", "kMaxChunk")
_GP_FUNCTIONS = {"ceil_div": (7, 2), "align16": (17,), "chunk_of": (5,),
                 "table_bytes": (31,), "group_bytes": (5,),
                 "cluster_bytes": (2,), "smem_bytes": (31, 5, 1, 10, True, 2),
                 "global_bytes": (31,), "max_threads": (4, False)}


def parse_cuda(text: str) -> Tuple[Optional[CudaModel], List[str]]:
    """The sizing of ``greedy_place.cu``: its named constants, and its
    sizing functions (``_GP_FUNCTIONS``) translated and evaluated; or
    None and the list of what the pass could not read."""
    consts, missing = _c_consts(text, _GP_CONSTS)
    ns = _c_namespace(text, _GP_FUNCTIONS, consts, missing, _CU_FILE)
    pairs = re.findall(
        r"case\s+(\d+)\s*:\s*return\s+launch<\s*(\d+)\s*,\s*false\s*>",
        text)
    if not pairs or any(a != b for a, b in pairs):
        missing.append("dispatch")
    if missing:
        return None, missing
    return CudaModel(
        smem_k=consts["kSmemK"],
        max_cluster=consts["kMaxCluster"],
        ks=tuple(sorted(int(a) for a, _ in pairs)),
        launch_bounded=re.search(
            r"__launch_bounds__\(\s*max_threads\(\s*K\s*,\s*kSmem\s*\)\s*,"
            r"\s*1\s*\)\s*greedy_place_kernel", text) is not None,
        fns={name: ns[name] for name in _GP_FUNCTIONS},
    ), []


def _module_values(src: SourceFile, names) -> Dict[str, ast.AST]:
    out: Dict[str, ast.AST] = {}
    for node in src.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name) and tgt.id in names:
                out[tgt.id] = node.value
        elif isinstance(node, ast.AnnAssign) and isinstance(
                node.target, ast.Name) and node.target.id in names:
            out[node.target.id] = node.value
    return out


def _literal(node: Optional[ast.AST]):
    try:
        return ast.literal_eval(node) if node is not None else None
    except ValueError:
        return None


def _python_sizer(src: SourceFile, name: str = "_smem_bytes",
                  consts: Optional[dict] = None):
    """A sizer of the wrapper (``_smem_bytes`` by default), compiled from
    its own AST into an empty namespace (it is pure integer arithmetic
    on its arguments and ``consts``)."""
    for node in src.tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            fn = ast.FunctionDef(
                name=node.name, args=node.args, body=node.body,
                decorator_list=[], returns=None, type_comment=None,
                type_params=[],
            )
            mod = ast.fix_missing_locations(ast.Module([fn], []))
            ns: dict = {"__builtins__": {"min": min, "max": max},
                        **(consts or {})}
            exec(compile(mod, src.path, "exec"), ns)  # noqa: S102
            return ns[node.name], node.lineno
    return None, 0


def _roofline_consts(cache) -> Tuple[Dict[str, int], List[Finding]]:
    src = cache.get(_ROOFLINE_FILE)
    if src is None:
        return {}, [Finding(RULE, _ROOFLINE_FILE, 0,
                            "roofline file missing — the H100 budget "
                            "constants live there")]
    vals = _module_values(src, _BUDGET_CONSTS)
    out: Dict[str, int] = {}
    problems: List[Finding] = []
    for name in _BUDGET_CONSTS:
        v = _literal(vals.get(name))
        if not isinstance(v, int):
            problems.append(Finding(
                RULE, _ROOFLINE_FILE, 1,
                f"budget constant {name} missing or not an int literal in "
                f"{_ROOFLINE_FILE}",
            ))
        else:
            out[name] = v
    return out, problems


def _cu_text(root: str, rel: str = _CU_FILE) -> Optional[str]:
    """A CUDA source (C++, so not a :class:`SourceFile`), or None."""
    import os

    path = os.path.join(root, rel)
    if not os.path.isfile(path):
        return None
    with open(path) as fh:
        return fh.read()


def cuda_model(root: Optional[str] = None) -> Optional[CudaModel]:
    """The parsed model of the tree's ``greedy_place.cu`` (None when it
    is missing or unreadable; :func:`collect` says why)."""
    from pivot_tpu_torch.analysis import repo_root

    text = _cu_text(root or repo_root())
    return None if text is None else parse_cuda(text)[0]


def register_findings(usage, regs_per_block: int) -> List[Finding]:
    """``max_threads(K) × registers ≤ regs_per_block`` for each
    instantiation of ``usage``: rows of ``ptxas -v`` as
    ``chip_smoke.py`` prints them (``K``, ``state`` — ``registers``,
    ``smem``, ``cluster`` or ``global`` —, ``registers``)."""
    model = cuda_model()
    out: List[Finding] = []
    if model is None:
        return [Finding(RULE, _CU_FILE, 0, "greedy_place.cu unreadable")]
    for row in usage:
        smem = row["state"] != "registers"
        threads = model.max_threads(row["K"], smem)
        if row["registers"] * threads > regs_per_block:
            out.append(Finding(
                RULE, _CU_FILE, 1,
                f"greedy_place K={row['K']} ({row['state']}): "
                f"{row['registers']} registers x {threads} threads > "
                f"{regs_per_block} — the launch bound does not fit the "
                "register file",
            ))
    return out


def collect(cache) -> Tuple[List[Finding], List[str]]:
    out, scanned = _collect_greedy(cache)
    for more in (collect_carry_free, collect_ensemble_chain):
        found, also = more(cache)
        out += found
        scanned += [r for r in also if r not in scanned]
    return out, scanned


def _collect_greedy(cache) -> Tuple[List[Finding], List[str]]:
    out: List[Finding] = []
    scanned: List[str] = []
    cu = _cu_text(cache.root)
    wrapper = cache.get(_WRAPPER_FILE)
    for rel, src in ((_CU_FILE, cu), (_WRAPPER_FILE, wrapper)):
        if src is None:
            out.append(Finding(
                RULE, rel, 0,
                f"{rel} is missing — renamed/deleted? update "
                "pivot_tpu_torch/analysis/kernel_budget.py",
            ))
    if cu is None or wrapper is None:
        return out, scanned
    scanned.append(_WRAPPER_FILE)
    consts, problems = _roofline_consts(cache)
    out.extend(problems)
    if cache.get(_ROOFLINE_FILE) is not None:
        scanned.append(_ROOFLINE_FILE)

    model, unread = parse_cuda(cu)
    for what in unread:
        out.append(Finding(
            RULE, _CU_FILE, 1,
            f"cannot read greedy_place.cu's {what!r} formula — rewritten? "
            "update pivot_tpu_torch/analysis/kernel_budget.py with it",
        ))
    if model is None:
        return out, scanned
    if not model.launch_bounded:
        out.append(Finding(
            RULE, _CU_FILE, 1,
            "greedy_place_kernel lost __launch_bounds__(max_threads(K, "
            "kSmem), 1): its register budget per thread is no longer tied "
            "to the thread table",
        ))

    vals = _module_values(wrapper, ("_SMEM_LIMIT", "_SMEM_K",
                                    "_REG_THREADS", "MAX_HOSTS",
                                    "MAX_CLUSTER", "_GLOBAL_THREADS"))
    line = {n: v.lineno for n, v in vals.items()}
    reg_threads = _literal(vals.get("_REG_THREADS"))
    smem_k = _literal(vals.get("_SMEM_K"))
    max_cluster = _literal(vals.get("MAX_CLUSTER"))
    global_threads = _literal(vals.get("_GLOBAL_THREADS"))
    if not all(isinstance(v, int) for v in (smem_k, max_cluster,
                                             global_threads)) \
            or not isinstance(reg_threads, dict):
        out.append(Finding(
            RULE, _WRAPPER_FILE, 1,
            "_REG_THREADS / _SMEM_K / MAX_CLUSTER / _GLOBAL_THREADS missing "
            "or not literals — the pass cannot hold the wrapper's tables "
            "to the kernel's",
        ))
        return out, scanned

    # -- thread tables and instantiations --------------------------------
    if tuple(sorted(reg_threads)) != model.ks:
        out.append(Finding(
            RULE, _WRAPPER_FILE, line["_REG_THREADS"],
            f"_REG_THREADS covers K={sorted(reg_threads)} but the kernel "
            f"instantiates K={list(model.ks)} (dispatch in "
            f"{_CU_FILE})",
        ))
    for K, threads in sorted(reg_threads.items()):
        if model.max_threads(K, False) != threads:
            out.append(Finding(
                RULE, _WRAPPER_FILE, line["_REG_THREADS"],
                f"_REG_THREADS[{K}] = {threads} but greedy_place.cu's "
                f"max_threads({K}) = {model.max_threads(K, False)}",
            ))
    if smem_k != model.smem_k:
        out.append(Finding(
            RULE, _WRAPPER_FILE, line["_SMEM_K"],
            f"_SMEM_K = {smem_k} but greedy_place.cu's kSmemK = "
            f"{model.smem_k}",
        ))
    if max_cluster != model.max_cluster:
        out.append(Finding(
            RULE, _WRAPPER_FILE, line["MAX_CLUSTER"],
            f"MAX_CLUSTER = {max_cluster} but greedy_place.cu's "
            f"kMaxCluster = {model.max_cluster}",
        ))
    if global_threads != model.threads_smem:
        out.append(Finding(
            RULE, _WRAPPER_FILE, line["_GLOBAL_THREADS"],
            f"_GLOBAL_THREADS = {global_threads} but greedy_place.cu's "
            f"global form runs max_threads(kSmemK, true) = "
            f"{model.threads_smem} threads",
        ))
    if model.threads_smem < 32 * 32:
        out.append(Finding(
            RULE, _CU_FILE, 1,
            f"shared-memory state allows {model.threads_smem} threads, "
            f"below the 32 warps the wrapper sizes it for",
        ))

    # -- the sizer against the kernel's formula ---------------------------
    sizer, sizer_line = _python_sizer(wrapper)
    if sizer is None:
        out.append(Finding(RULE, _WRAPPER_FILE, 1,
                           "_smem_bytes not found in the wrapper"))
    else:
        bad = []
        for Z in _Z_PROBES:
            for W in _W_PROBES:
                for G in _G_PROBES:
                    for K in model.ks:
                        if sizer(Z, W, G, K, False) != model.smem_bytes(
                                Z, W, G, K, False):
                            bad.append((Z, W, G, K, False))
                for C in _C_PROBES:
                    if sizer(Z, W, 1, model.smem_k, True, C) != \
                            model.smem_bytes(Z, W, 1, model.smem_k, True, C):
                        bad.append((Z, W, 1, model.smem_k, True, C))
        if bad:
            out.append(Finding(
                RULE, _WRAPPER_FILE, sizer_line,
                f"_smem_bytes disagrees with greedy_place.cu's smem_bytes "
                f"at {len(bad)} probe(s), first (Z, W, G, K, smem_state"
                f"[, C]) = {bad[0]}",
            ))
    gsizer, gline = _python_sizer(wrapper, "_global_smem_bytes")
    if gsizer is None:
        out.append(Finding(RULE, _WRAPPER_FILE, 1,
                           "_global_smem_bytes not found in the wrapper"))
    else:
        bad = [Z for Z in _Z_PROBES if gsizer(Z) != model.global_bytes(Z)]
        if bad:
            out.append(Finding(
                RULE, _WRAPPER_FILE, gline,
                f"_global_smem_bytes disagrees with greedy_place.cu's "
                f"global_bytes at Z = {bad}",
            ))

    # -- the budget ---------------------------------------------------------
    optin = consts.get("H100_SMEM_OPTIN_BYTES")
    limit_node = vals.get("_SMEM_LIMIT")
    limit = _literal(limit_node)
    if isinstance(limit_node, ast.Name):
        limit = optin if limit_node.id == "H100_SMEM_OPTIN_BYTES" else None
    if optin is not None:
        if limit != optin:
            out.append(Finding(
                RULE, _WRAPPER_FILE, line.get("_SMEM_LIMIT", 1),
                f"_SMEM_LIMIT ({limit}) is not the H100's opt-in shared "
                f"memory per block, H100_SMEM_OPTIN_BYTES = {optin} "
                f"({_ROOFLINE_FILE})",
            ))
        biggest = model.smem_bytes(_CLI_ZONES, 32, 1, model.smem_k, True,
                                   model.max_cluster)
        if biggest > optin:
            out.append(Finding(
                RULE, _WRAPPER_FILE, line.get("MAX_HOSTS", 1),
                f"the largest block (a CTA of the {model.max_cluster}-CTA "
                f"cluster, MAX_HOSTS hosts of shared-memory state, "
                f"{_CLI_ZONES} zones) needs {biggest} B of shared memory, "
                f"above the {optin} B opt-in",
            ))
    return out, scanned


# ---------------------------------------------------------------------------
# carry_free_place
# ---------------------------------------------------------------------------


class CfModel(NamedTuple):
    """``carry_free_place.cu``'s sizing: its constants and its sizing
    functions, evaluated from the source's own text."""

    chunk: int            # kChunk: tasks a staging buffer holds at most
    max_threads: int      # kMaxThreads: a rows-form CTA's thread limit
    max_cluster: int      # kMaxCluster: CTAs a replica at most
    max_slots: int        # kMaxSlots: C·W slots a replica at most
    rows_shared: int      # kRowsShared: the cluster form's form number
    rows_global: int      # kRowsGlobal: the global-rows form's number
    reg_threads: Dict[int, int]  # built K -> its thread limit
    launch_bounded: bool  # __launch_bounds__(max_threads(kForm), 1)
    fns: Dict[str, Callable]  # _CF_FUNCTIONS, translated to Python

    def smem_bytes(self, H: int, form: int, W: int, G: int, C: int) -> int:
        """``smem_bytes`` of the CUDA source."""
        return self.fns["smem_bytes"](H, form, W, G, C)

    def form_threads(self, form: int) -> int:
        """A form's thread limit a block (``max_threads(form)``)."""
        return self.fns["max_threads"](form)

    def host_ranges(self, H: int, threads: int, C: int = 1,
                    K: Optional[int] = None) -> List[Tuple[int, int]]:
        """Each (rank, thread)'s hosts ``[h0, h1)``, rank-major, by the
        CUDA source's ``host_range``."""
        rng = self.fns["host_range"]
        out = []
        for rank in range(C):
            for t in range(threads):
                _c0, _kt, h0, h1 = rng(H, C, rank, threads, t, K or 0)
                out.append((h0, h1))
        return out


def _owns_each_once(ranges, H: int) -> bool:
    """``ranges`` own the hosts ``0..H−1`` each once, in index order."""
    end = 0
    for h0, h1 in ranges:
        if h0 != end or h1 < h0:
            return False
        end = h1
    return end == H


#: The named constants the sizing reads, and the sizing functions the
#: pass evaluates, each with arguments it is probed at when read.
_CF_CONSTS = {"chunk": "kChunk", "max_threads": "kMaxThreads",
              "max_cluster": "kMaxCluster", "max_slots": "kMaxSlots",
              "rows_shared": "kRowsShared", "rows_global": "kRowsGlobal"}
_CF_FUNCTIONS = {"ceil_div": (7, 2), "chunk_of": (5,),
                 "stage_bytes": (5,), "slot_bytes": (10,),
                 "smem_bytes": (600, 0, 5, 1, 2), "max_threads": (2,),
                 "host_range": (600, 2, 1, 64, 3, 0)}
_CF_H_PROBES = (1, 7, 600, 4096, 4097, 14096, 98304, 211968, 250000)
_CF_C_PROBES = (1, 2, 4, 8, 16)
_CF_W_PROBES = (1, 5, 16, 32)
#: What a translated body may hold once casts are gone: integer
#: arithmetic, bitwise and / not, comparisons, the conditional operator,
#: calls and braces (no logical ``&&``).
_C_EXPR = re.compile(r"(?:[\w\s+\-*/(),<>=!?:{}~]|&(?!&))*")


def _c_expr(e: str) -> str:
    """A C integer expression as Python: ``static_cast`` dropped, ``/``
    floor division (the operands are never negative), braces a tuple,
    ``a ? b : c`` at the top level a conditional expression."""
    e = " ".join(re.sub(r"static_cast<\w+>", "", e).split())
    if not _C_EXPR.fullmatch(e):
        raise ValueError(e)
    depth, q = 0, -1
    for i, ch in enumerate(e):
        depth += ch in "({"
        depth -= ch in ")}"
        if ch == "?" and depth == 0:
            q = i
            break
    if q >= 0:
        depth, nest = 0, 0
        for i in range(q + 1, len(e)):
            ch = e[i]
            depth += ch in "({"
            depth -= ch in ")}"
            nest += ch == "?" and depth == 0
            if ch == ":" and depth == 0:
                if nest == 0:
                    return (f"(({_c_expr(e[q + 1:i])}) if ({_c_expr(e[:q])})"
                            f" else ({_c_expr(e[i + 1:])}))")
                nest -= 1
        raise ValueError(e)
    e = e.replace("/", "//")
    return "(" + e[1:-1] + ",)" if e.startswith("{") else "(" + e + ")"


def _c_function(text: str, name: str) -> Optional[str]:
    """The Python source of the CUDA function ``name``: its parameters
    and body of ``const T x = …;`` statements and one ``return``; None
    when it is absent or holds anything else."""
    m = re.search(rf"\b(?:int|size_t|HostRange)\s+{name}\s*\(([^)]*)\)\s*\{{",
                  text)
    if m is None:
        return None
    depth, i = 1, m.end()
    while depth and i < len(text):
        depth += text[i] == "{"
        depth -= text[i] == "}"
        i += 1
    body = re.sub(r"//[^\n]*", "", text[m.end():i - 1])
    params = [p.split()[-1] for p in m.group(1).split(",") if p.strip()]
    lines = [f"def {name}({', '.join(params)}):"]
    try:
        for stmt in filter(None, (x.strip() for x in body.split(";"))):
            let = re.fullmatch(r"const\s+\w+\s+(\w+)\s*=\s*(.+)", stmt, re.S)
            ret = re.fullmatch(r"return\s+(.+)", stmt, re.S)
            if let:
                lines.append(f"    {let.group(1)} = {_c_expr(let.group(2))}")
            elif ret:
                lines.append(f"    return {_c_expr(ret.group(1))}")
            else:
                return None
    except ValueError:
        return None
    return "\n".join(lines)


def _c_consts(text: str, names) -> Tuple[Dict[str, int], List[str]]:
    """The ``constexpr int`` constants ``names`` of a CUDA source, and the
    names it lacks."""
    consts: Dict[str, int] = {}
    missing: List[str] = []
    for name in names:
        m = re.search(rf"constexpr\s+int\s+{name}\s*=\s*(-?\d+)\s*;",
                      text)
        if m is None:
            missing.append(name)
        else:
            consts[name] = int(m.group(1))
    return consts, missing


def _c_namespace(text: str, functions, consts, missing, path) -> dict:
    """The CUDA functions ``functions`` (``{name: probe arguments}``) of
    ``text`` translated by :func:`_c_function` into one namespace with
    ``consts``; each one that is absent, does not translate or fails its
    probe is appended to ``missing``."""
    ns: dict = {"__builtins__": {"min": min, "max": max}, **consts}
    for name in functions:
        src = _c_function(text, name)
        if src is None:
            missing.append(name)
            continue
        try:
            exec(compile(src, path, "exec"), ns)  # noqa: S102
        except SyntaxError:
            missing.append(name)
    for name, probe in functions.items():
        if name not in missing:
            try:
                ns[name](*probe)
            except Exception:  # an unknown name or operator in the body
                missing.append(name)
    return ns


def parse_carry_free(text: str) -> Tuple[Optional[CfModel], List[str]]:
    """The sizing of ``carry_free_place.cu``: its named constants, and its
    sizing functions (``_CF_FUNCTIONS``) translated and evaluated; or
    None and the list of what the pass could not read."""
    consts, missing = _c_consts(text, _CF_CONSTS.values())
    ns = _c_namespace(text, _CF_FUNCTIONS, consts, missing, _CF_CU_FILE)
    builds = [int(k) for k in re.findall(
        r"case\s+(\d+)\s*:\s*return\s+launch<kArm,\s*kRisk,\s*\1>", text)]
    if not builds:
        missing.append("register builds")
    if missing:
        return None, missing
    fns = {name: ns[name] for name in _CF_FUNCTIONS}
    return CfModel(
        **{field: consts[name] for field, name in _CF_CONSTS.items()},
        reg_threads={K: fns["max_threads"](K) for K in builds},
        launch_bounded=re.search(
            r"__launch_bounds__\(\s*max_threads\(\s*kForm\s*\)\s*,\s*1\s*\)",
            text) is not None,
        fns=fns,
    ), []


def cf_model(root: Optional[str] = None) -> Optional[CfModel]:
    """The parsed model of the tree's ``carry_free_place.cu``."""
    from pivot_tpu_torch.analysis import repo_root

    text = _cu_text(root or repo_root(), _CF_CU_FILE)
    return None if text is None else parse_carry_free(text)[0]


def cf_register_findings(usage, regs_per_block: int) -> List[Finding]:
    """``max_threads(form) × registers ≤ regs_per_block`` for each
    instantiation of ``carry_free_place`` in ``usage`` (rows of ``ptxas
    -v`` with a ``registers`` count and the build's ``form``, as
    ``chip_smoke.py`` prints them)."""
    model = cf_model()
    if model is None:
        return [Finding(RULE, _CF_CU_FILE, 0,
                        "carry_free_place.cu unreadable")]
    out = []
    for row in usage:
        threads = model.form_threads(row.get("form", model.rows_shared))
        if row["registers"] * threads > regs_per_block:
            out.append(Finding(
                RULE, _CF_CU_FILE, 1,
                f"carry_free_place {row.get('build', '?')}: "
                f"{row['registers']} registers x {threads} threads > "
                f"{regs_per_block} — the launch bound does not fit the "
                "register file",
            ))
    return out


def collect_carry_free(cache) -> Tuple[List[Finding], List[str]]:
    """``carry_free_place``'s formulas against the wrapper's and the
    card's: the chunk, thread limits, register builds, cluster limit,
    slot limit and form numbers equal the wrapper's, the sizer equals the
    kernel's formula at every probe, the (rank, thread) host ranges own
    every host once at every probe, cluster size and block size, and the
    thread limits and the largest cluster CTA fit the card."""
    out: List[Finding] = []
    cu = _cu_text(cache.root, _CF_CU_FILE)
    wrapper = cache.get(_WRAPPER_FILE)
    if cu is None:
        return [Finding(
            RULE, _CF_CU_FILE, 0,
            f"{_CF_CU_FILE} is missing — renamed/deleted? update "
            "pivot_tpu_torch/analysis/kernel_budget.py",
        )], []
    if wrapper is None:
        return out, []  # the greedy_place check reports the missing file
    model, unread = parse_carry_free(cu)
    for what in unread:
        out.append(Finding(
            RULE, _CF_CU_FILE, 1,
            f"cannot read carry_free_place.cu's {what!r} formula — "
            "rewritten? update the patterns of pivot_tpu_torch/analysis/"
            "kernel_budget.py with it",
        ))
    if model is None:
        return out, [_WRAPPER_FILE]
    if not model.launch_bounded:
        out.append(Finding(
            RULE, _CF_CU_FILE, 1,
            "carry_free_kernel lost __launch_bounds__(max_threads(kForm), "
            "1): its register budget per thread is no longer tied to its "
            "thread limit",
        ))
    names = ("_CF_CHUNK", "_CF_MAX_THREADS", "_CF_REG_THREADS",
             "_CF_CLUSTERS", "_CF_MAX_SLOTS", "_CF_ROWS_SHARED",
             "_CF_ROWS_GLOBAL", "_CF_ROWS_WARPS")
    vals = _module_values(wrapper, names)
    line = {n: v.lineno for n, v in vals.items()}
    got = {n: _literal(vals.get(n)) for n in names}
    if any(got[n] is None for n in names):
        out.append(Finding(
            RULE, _WRAPPER_FILE, 1,
            f"{', '.join(n for n in names if got[n] is None)} missing or "
            "not literals — the pass cannot hold the wrapper's sizer to "
            "the kernel's",
        ))
        return out, [_WRAPPER_FILE]
    want = {
        "_CF_CHUNK": model.chunk, "_CF_MAX_THREADS": model.max_threads,
        "_CF_REG_THREADS": model.reg_threads,
        "_CF_MAX_SLOTS": model.max_slots,
        "_CF_ROWS_SHARED": model.rows_shared,
        "_CF_ROWS_GLOBAL": model.rows_global,
    }
    for n, v in want.items():
        if got[n] != v:
            out.append(Finding(
                RULE, _WRAPPER_FILE, line[n],
                f"{n} = {got[n]} but carry_free_place.cu has {v}",
            ))
    clusters = tuple(got["_CF_CLUSTERS"])
    if max(clusters) != model.max_cluster or any(
            c & (c - 1) for c in clusters):
        out.append(Finding(
            RULE, _WRAPPER_FILE, line["_CF_CLUSTERS"],
            f"_CF_CLUSTERS = {clusters}: powers of two up to "
            f"carry_free_place.cu's kMaxCluster = {model.max_cluster}",
        ))
    slots = max(clusters) * max(got["_CF_ROWS_WARPS"])
    if slots > model.max_slots:
        out.append(Finding(
            RULE, _WRAPPER_FILE, line["_CF_ROWS_WARPS"],
            f"_CF_ROWS_WARPS gives {slots} C·W slots at the largest "
            f"cluster, above kMaxSlots = {model.max_slots}",
        ))
    sizer, sizer_line = _python_sizer(
        wrapper, "_cf_smem_bytes",
        {"_CF_CHUNK": model.chunk, "_CF_ROWS_SHARED": model.rows_shared})
    if sizer is None:
        out.append(Finding(RULE, _WRAPPER_FILE, 1,
                           "_cf_smem_bytes not found in the wrapper"))
    else:
        forms = (*model.reg_threads, model.rows_shared, model.rows_global)
        bad = [(H, f, W, C) for H in _CF_H_PROBES for f in forms
               for W in _CF_W_PROBES for C in _CF_C_PROBES
               if sizer(H, f, W, 1, C) != model.smem_bytes(H, f, W, 1, C)]
        if bad:
            out.append(Finding(
                RULE, _WRAPPER_FILE, sizer_line,
                f"_cf_smem_bytes disagrees with carry_free_place.cu's "
                f"smem_bytes at {len(bad)} probe(s), first (H, form, W, C) "
                f"= {bad[0]}",
            ))
    split = [(H, n, C) for H in _CF_H_PROBES for C in _CF_C_PROBES
             for n in (32, 96, 512, model.max_threads)
             if not _owns_each_once(model.host_ranges(H, n, C), H)]
    split += [(H, 32 * W, K) for K in model.reg_threads
              for W in _CF_W_PROBES for H in _CF_H_PROBES
              if H <= 32 * W * K
              and not _owns_each_once(model.host_ranges(H, 32 * W, 1, K),
                                      H)]
    if split:
        out.append(Finding(
            RULE, _CF_CU_FILE, 1,
            f"the (rank, thread) host ranges of host_range do not own "
            f"every host once at {len(split)} probe(s), first (H, threads, "
            f"C or K) = {split[0]}",
        ))
    consts, _problems = _roofline_consts(cache)  # reported by greedy's
    limit = consts.get("H100_MAX_THREADS_PER_BLOCK")
    top = max(model.max_threads, *model.reg_threads.values())
    if limit is not None and top > limit:
        out.append(Finding(
            RULE, _CF_CU_FILE, 1,
            f"a thread limit of {top} is above the card's {limit} threads "
            "per block",
        ))
    optin = consts.get("H100_SMEM_OPTIN_BYTES")
    if optin is not None:
        smallest = model.smem_bytes(1, model.rows_global, 32, 1, 1)
        if smallest > optin:
            out.append(Finding(
                RULE, _CF_CU_FILE, 1,
                f"the global-state block needs {smallest} B of shared "
                f"memory, above the {optin} B opt-in",
            ))
    return out, [_WRAPPER_FILE]


# ---------------------------------------------------------------------------
# ensemble_chain
# ---------------------------------------------------------------------------


class ChainModel(NamedTuple):
    """``ensemble_chain.cu``'s sizing: its constants and its sizing
    functions, evaluated from the source's own text."""

    consts: Dict[str, int]    # _CHAIN_CONSTS' values, by CUDA name
    launch_bounded: bool      # __launch_bounds__(kMaxThreads)
    fns: Dict[str, Callable]  # _CHAIN_FUNCTIONS, translated to Python

    def smem_bytes(self, H: int, Z: int, form: int, arm: int,
                   risk: int) -> int:
        """``smem_bytes`` of the CUDA source."""
        return self.fns["smem_bytes"](H, Z, form, arm, risk)

    @property
    def max_threads(self) -> int:
        """A CTA's thread limit (``max_threads()``)."""
        return self.fns["max_threads"]()


#: The wrapper's constant for each named constant of the source.
_CHAIN_CONSTS = {"kChunk": "_CHAIN_CHUNK", "kMaxWarps": "_CHAIN_MAX_WARPS",
                 "kMaxZones": "_CHAIN_MAX_ZONES",
                 "kFormShared": "_CHAIN_SHARED",
                 "kFormGlobal": "_CHAIN_GLOBAL",
                 "kMaxThreads": None, "kCostAware": None}
_CHAIN_FUNCTIONS = {"ceil_div": (7, 2), "align16": (17,),
                    "max_threads": (), "table_bytes": (31,),
                    "slot_bytes": (), "stage_bytes": (),
                    "host_bytes": (0, 1), "smem_bytes": (600, 31, 0, 0, 1)}
_CHAIN_H_PROBES = (1, 7, 600, 8856, 8857, 13477, 13478, 98304)
_CHAIN_Z_PROBES = (1, 4, 31, 170)


def parse_ensemble_chain(text: str) -> Tuple[Optional[ChainModel],
                                             List[str]]:
    """The sizing of ``ensemble_chain.cu``: its named constants, and its
    sizing functions (``_CHAIN_FUNCTIONS``) translated and evaluated; or
    None and the list of what the pass could not read."""
    consts, missing = _c_consts(text, _CHAIN_CONSTS)
    ns = _c_namespace(text, _CHAIN_FUNCTIONS, consts, missing,
                      _CHAIN_CU_FILE)
    if missing:
        return None, missing
    return ChainModel(
        consts=consts,
        launch_bounded=re.search(
            r"__launch_bounds__\(\s*kMaxThreads\s*\)\s*ensemble_chain_kernel",
            text) is not None,
        fns={name: ns[name] for name in _CHAIN_FUNCTIONS},
    ), []


def chain_model(root: Optional[str] = None) -> Optional[ChainModel]:
    """The parsed model of the tree's ``ensemble_chain.cu``."""
    from pivot_tpu_torch.analysis import repo_root

    text = _cu_text(root or repo_root(), _CHAIN_CU_FILE)
    return None if text is None else parse_ensemble_chain(text)[0]


def chain_register_findings(usage, regs_per_block: int) -> List[Finding]:
    """``max_threads() × registers ≤ regs_per_block`` for each
    instantiation of ``ensemble_chain`` in ``usage`` (rows of ``ptxas
    -v`` with a ``registers`` count, as ``chip_smoke.py`` prints them)."""
    model = chain_model()
    if model is None:
        return [Finding(RULE, _CHAIN_CU_FILE, 0,
                        "ensemble_chain.cu unreadable")]
    return [Finding(
        RULE, _CHAIN_CU_FILE, 1,
        f"ensemble_chain {row.get('build', '?')}: {row['registers']} "
        f"registers x {model.max_threads} threads > {regs_per_block} — "
        "the launch bound does not fit the register file")
        for row in usage
        if row["registers"] * model.max_threads > regs_per_block]


def collect_ensemble_chain(cache) -> Tuple[List[Finding], List[str]]:
    """``ensemble_chain``'s formulas against the wrapper's and the
    card's: the chunk, warp limit, zone limit and form numbers equal the
    wrapper's, the wrapper's arm order puts cost-aware at ``kCostAware``,
    the sizer equals the kernel's formula at every probe, the thread
    limit fits the card, and the global form's block (the two ``[Z,
    Z]`` tables at the CLI's 31 zones) fits the opt-in."""
    out: List[Finding] = []
    cu = _cu_text(cache.root, _CHAIN_CU_FILE)
    wrapper = cache.get(_WRAPPER_FILE)
    if cu is None:
        return [Finding(
            RULE, _CHAIN_CU_FILE, 0,
            f"{_CHAIN_CU_FILE} is missing — renamed/deleted? update "
            "pivot_tpu_torch/analysis/kernel_budget.py",
        )], []
    if wrapper is None:
        return out, []
    model, unread = parse_ensemble_chain(cu)
    for what in unread:
        out.append(Finding(
            RULE, _CHAIN_CU_FILE, 1,
            f"cannot read ensemble_chain.cu's {what!r} formula — "
            "rewritten? update the patterns of pivot_tpu_torch/analysis/"
            "kernel_budget.py with it",
        ))
    if model is None:
        return out, [_WRAPPER_FILE]
    if not model.launch_bounded:
        out.append(Finding(
            RULE, _CHAIN_CU_FILE, 1,
            "ensemble_chain_kernel lost __launch_bounds__(kMaxThreads): "
            "its register budget per thread is no longer tied to its "
            "thread limit",
        ))
    names = [n for n in _CHAIN_CONSTS.values() if n] + ["_CHAIN_ARMS"]
    vals = _module_values(wrapper, names)
    line = {n: v.lineno for n, v in vals.items()}
    got = {n: _literal(vals.get(n)) for n in names}
    if any(got[n] is None for n in names):
        out.append(Finding(
            RULE, _WRAPPER_FILE, 1,
            f"{', '.join(n for n in names if got[n] is None)} missing or "
            "not literals — the pass cannot hold the wrapper's sizer to "
            "the kernel's",
        ))
        return out, [_WRAPPER_FILE]
    for cname, pname in _CHAIN_CONSTS.items():
        if pname and got[pname] != model.consts[cname]:
            out.append(Finding(
                RULE, _WRAPPER_FILE, line[pname],
                f"{pname} = {got[pname]} but ensemble_chain.cu has "
                f"{cname} = {model.consts[cname]}",
            ))
    ca = model.consts["kCostAware"]
    arms = tuple(got["_CHAIN_ARMS"])
    if ca >= len(arms) or arms[ca] != "cost-aware":
        out.append(Finding(
            RULE, _WRAPPER_FILE, line["_CHAIN_ARMS"],
            f"_CHAIN_ARMS = {arms}: ensemble_chain.cu's kCostAware = {ca} "
            "names another arm",
        ))
    sizer, sizer_line = _python_sizer(
        wrapper, "_chain_smem_bytes",
        {p: got[p] for p in _CHAIN_CONSTS.values() if p})
    forms = (model.consts["kFormShared"], model.consts["kFormGlobal"])
    if sizer is None:
        out.append(Finding(RULE, _WRAPPER_FILE, 1,
                           "_chain_smem_bytes not found in the wrapper"))
    else:
        bad = [(H, Z, f, a, r) for H in _CHAIN_H_PROBES
               for Z in _CHAIN_Z_PROBES for f in forms for a in range(4)
               for r in (0, 1)
               if sizer(H, Z, f, a, r) != model.smem_bytes(H, Z, f, a, r)]
        if bad:
            out.append(Finding(
                RULE, _WRAPPER_FILE, sizer_line,
                f"_chain_smem_bytes disagrees with ensemble_chain.cu's "
                f"smem_bytes at {len(bad)} probe(s), first (H, Z, form, "
                f"arm, risk) = {bad[0]}",
            ))
    consts, _problems = _roofline_consts(cache)  # reported by greedy's
    limit = consts.get("H100_MAX_THREADS_PER_BLOCK")
    if limit is not None and model.max_threads > limit:
        out.append(Finding(
            RULE, _CHAIN_CU_FILE, 1,
            f"ensemble_chain's thread limit {model.max_threads} is above "
            f"the card's {limit} threads per block",
        ))
    optin = consts.get("H100_SMEM_OPTIN_BYTES")
    if optin is not None:
        need = model.smem_bytes(1, _CLI_ZONES, forms[1], ca, 1)
        if need > optin:
            out.append(Finding(
                RULE, _CHAIN_CU_FILE, 1,
                f"the global-form block at {_CLI_ZONES} zones needs {need} "
                f"B of shared memory, above the {optin} B opt-in",
            ))
    return out, [_WRAPPER_FILE]
