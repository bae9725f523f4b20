"""The port's graftcheck suite (``pivot_tpu_torch/analysis``) against
``pivot_tpu/analysis``.

* Suppression parsing and scoping equal the reference's on the same
  source texts.
* Each rule shared with the reference gives the same findings (rule,
  line, message class) for one violating snippet, placed under
  ``pivot_tpu/...`` for the reference's pass and under
  ``pivot_tpu_torch/...`` for the port's, in a tmp tree given by
  ``--root``.
* Each torch-only addition has a falsifier; a suppression without a
  reason is a finding.
* The port's own tree is clean under every pass, and the parity pass's
  per-family knob sets equal the reference's, every host-sharded form
  (1-D, ``[G]``-batched 2-D, resident) included.
"""

import json
import os
import shutil
import textwrap

import pytest

from pivot_tpu import analysis as ref
from pivot_tpu.analysis import parity as ref_parity
from pivot_tpu_torch import analysis as port
from pivot_tpu_torch.analysis import entrymap, kernel_budget
from pivot_tpu_torch.analysis import parity as port_parity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(root, rel, text):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(textwrap.dedent(text))
    return path


def _norm(message: str) -> str:
    """A message's class: the text before its explanation, with the
    package names made equal."""
    return message.replace("pivot_tpu_torch", "pivot_tpu").split(" — ")[0]


def _findings(pkg, root, rule, rel):
    mod = ref if pkg == "pivot_tpu" else port
    return sorted((f.rule, f.line, _norm(f.message))
                  for f in mod.run(root=root, rules=[rule])
                  if f.path == rel and f.line > 1)


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------

SUPPRESSION_TEXTS = [
    """\
    import time
    t0 = time.perf_counter()  # graftcheck: ignore[determinism] -- meter only
    """,
    """\
    # graftcheck: ignore[thread-guard] -- snapshot read
    for s in list(
            self.sessions):
        pass
    x = f(a,
          b)  # graftcheck: ignore[host-sync,dtype] -- two rules
    """,
    '''\
    def f():
        """Quoted, not live: # graftcheck: ignore[determinism] -- doc"""
        y = g(  # graftcheck: ignore[determinism]
            1,
            2)
        return y
    ''',
    """\
    # graftcheck: ignore[] -- empty rule list
    a = 1
    # graftcheck: ignore[no-such-rule] -- unknown
    b = (1,
         2)
    """,
]


@pytest.mark.parametrize("i", range(len(SUPPRESSION_TEXTS)))
def test_suppressions_parse_and_scope_as_the_reference(tmp_path, i):
    path = _write(str(tmp_path), "x.py", SUPPRESSION_TEXTS[i])
    src_r, src_p = ref.SourceFile(path, "x.py"), port.SourceFile(path, "x.py")
    sup_r, sup_p = ref.find_suppressions(src_r), port.find_suppressions(src_p)
    assert [tuple(s) for s in sup_r] == [tuple(s) for s in sup_p]
    assert sup_r  # every text holds at least one live suppression
    assert src_r.stmt_spans == src_p.stmt_spans
    for a, b in zip(sup_r, sup_p):
        assert ref._suppression_scope(a, src_r) == \
            port._suppression_scope(b, src_p)


# ---------------------------------------------------------------------------
# Shared rules: the same findings for the same snippet
# ---------------------------------------------------------------------------

SHARED = {
    "determinism": ("des/snippet.py", """\
        import time
        import random
        import numpy as np
        import numpy.random as npr
        from time import perf_counter
        t = time.time()
        u = random.random()
        v = np.random.rand(3)
        w = np.random.default_rng(0)
        for x in {1, 2}:
            pass
        ys = [y for y in set([1, 2])]
        z = list({3, 4})
        for k in os.environ:
            pass
        """),
    "host-sync": ("ops/kernels.py", """\
        import numpy as np
        def opportunistic_impl(x):
            return x
        def first_fit_impl(x):
            y = x.item()
            z = np.asarray(x)
            print(x)
            return float(x) + int(-1) + y.tolist()
        def best_fit_impl(x):
            return x.block_until_ready()
        def cost_aware_impl(x):
            return jax.device_get(x)
        def _speculate_commit(x):
            return x
        def _slim_drive(x):
            return bool(x)
        """),
    "thread-guard": ("serve/autoscale.py", """\
        class SloAutoscaler:
            def __init__(self, driver):
                self.driver = driver
            def _loop(self, driver):
                if driver._stop:
                    return
                with driver._cv:
                    return driver._inflight
        """),
    "dtype": ("ops/snippet.py", """\
        import numpy as np
        a = np.float64(1.0)
        b = np.zeros(3, dtype="float64")
        c = b.astype("float64")
        d = np.zeros(3, dtype=np.float32)
        """),
    "obs-boundary": ("ops/snippet.py", """\
        import {pkg}.obs
        from {pkg} import obs
        from {pkg}.utils import trace
        def first_fit_impl(tracer):
            tracer.emit("x", "y", 0.0)
        """),
    "profiler-boundary": ("serve/snippet.py", """\
        def dispatch(prof, thunk):
            return prof.profile("cost_aware", thunk)
        def _execute(prof, thunk):
            return prof.profile("cost_aware", thunk)
        """),
    "backend-parity": ("ops/kernels.py", """\
        def first_fit_kernel_ref(avail, demands, valid, strict=False,
                                 live=None, risk=None):
            pass
        def first_fit_impl(avail, demands, valid, strict=False,
                           totals=None, phase2="auto", live=None):
            pass
        def weird_kernel_ref(avail):
            pass
        """),
}


@pytest.mark.parametrize("rule", sorted(SHARED))
def test_shared_rule_finds_what_the_reference_finds(tmp_path, rule):
    rel, text = SHARED[rule]
    found = {}
    for pkg in ("pivot_tpu", "pivot_tpu_torch"):
        root = str(tmp_path / pkg)
        _write(root, f"{pkg}/{rel}", text.replace("{pkg}", pkg))
        found[pkg] = _findings(pkg, root, rule, f"{pkg}/{rel}")
    assert found["pivot_tpu"], rule  # the snippet violates the rule
    assert found["pivot_tpu"] == found["pivot_tpu_torch"]


# ---------------------------------------------------------------------------
# Torch additions: falsifiers
# ---------------------------------------------------------------------------

def _port(tmp_path, rel, text, rule):
    root = str(tmp_path)
    _write(root, f"pivot_tpu_torch/{rel}", text)
    return [f for f in port.run(root=root, rules=[rule])
            if f.path == f"pivot_tpu_torch/{rel}"]


def test_determinism_torch_forms(tmp_path):
    got = _port(tmp_path, "ops/snippet.py", """\
        import torch
        torch.manual_seed(0)
        a = torch.rand(3)
        b = torch.rand(3, generator=g)
        c = torch.randperm(4)
        x.bernoulli_()
        y.uniform_(generator=g)
        acc.index_add_(0, idx, v)
        acc.scatter_add_(0, idx, v)
        acc.index_put_((idx,), v, accumulate=True)
        acc.index_put_((idx,), v)
        r = acc.scatter_reduce(0, idx, v, "sum")
        m = acc.scatter_reduce(0, idx, v, "amax")
        t = acc.scatter_reduce(0, idx, v, reduce="mean")
        """, "determinism")
    assert sorted(f.line for f in got) == [2, 3, 5, 6, 8, 9, 10, 12, 14]


def test_determinism_parallel_scope_and_suppression_reason(tmp_path):
    got = _port(tmp_path, "parallel/ensemble/x.py", """\
        acc.index_add_(0, idx, v)  # graftcheck: ignore[determinism] -- 0/1 counts

        acc.index_add_(0, idx, v)  # graftcheck: ignore[determinism]
        """, "determinism")
    assert [(f.rule, f.line) for f in got] == [
        ("determinism", 3), ("suppression", 3)]


def test_hostsync_torch_forms(tmp_path):
    got = _port(tmp_path, "ops/tickloop.py", """\
        import torch
        def _span_tick(x):
            a = x.cpu()
            b = x.numpy()
            torch.cuda.synchronize()
            return a, b
        def fused_tick_run_rows(x):
            return x
        def resident_span_run(x):
            return x
        """, "host-sync")
    assert sorted((f.line, f.message.split(" inside")[0]) for f in got) == [
        (3, "host-sync call .cpu()"), (4, "host-sync call .numpy()"),
        (5, "torch.cuda.synchronize()")]


def test_hostsync_required_body_renamed_away(tmp_path):
    got = _port(tmp_path, "ops/tickloop.py", """\
        def _span_tick(x):
            return x
        """, "host-sync")
    assert {f.message.split(" not")[0] for f in got} == {
        "required hot-path body fused_tick_run_rows()",
        "required hot-path body resident_span_run()"}


def test_hostsync_sharded_bodies(tmp_path):
    """``ops/shard.py``'s passes, reduces and span driver are hot paths,
    as in the reference (``pivot_tpu/ops/shard.py:88-89``)."""
    got = _port(tmp_path, "ops/shard.py", """\
        def _two_stage_argmin(m):
            return m.item()
        def _cost_aware_sharded_pass(x):
            return x.tolist()
        def sharded_fused_tick_run(x):
            return x
        def _opportunistic_sharded_chunk(x):
            return int(x)
        def _helper(x):
            return x.cpu()
        def sharded_batched_tick_run(x):
            return x
        def sharded_resident_span_run(x):
            return int(x)
        """, "host-sync")
    assert sorted(f.line for f in got) == [2, 4, 8, 14]
    got = _port(tmp_path, "ops/shard.py", """\
        def _two_stage_argmin(x):
            return x
        """, "host-sync")
    assert {f.message.split(" not")[0] for f in got} == {
        "required hot-path body _cost_aware_sharded_pass()",
        "required hot-path body sharded_fused_tick_run()",
        "required hot-path body sharded_batched_tick_run()",
        "required hot-path body sharded_resident_span_run()"}


def test_entry_map_lists_the_sharded_forms():
    entries, findings, _s = entrymap.collect_entries(port._Cache(ROOT))
    assert findings == []
    assert sorted((e.name, e.kind) for e in
                  entries["pivot_tpu_torch/ops/shard.py"]) == [
        (name, "family") for name in (
            "best_fit_kernel_sharded", "best_fit_kernel_sharded_batched",
            "cost_aware_kernel_sharded", "cost_aware_kernel_sharded_batched",
            "first_fit_kernel_sharded", "first_fit_kernel_sharded_batched",
            "opportunistic_kernel_sharded",
            "opportunistic_kernel_sharded_batched",
            "sharded_batched_tick_run", "sharded_fused_tick_run",
            "sharded_resident_span_run")]


def test_parity_flags_an_unregistered_sharded_form(tmp_path):
    root = str(tmp_path)
    _write(root, "pivot_tpu_torch/ops/shard.py", """\
        def greedy_kernel_sharded(mesh, avail):
            return avail
        def sharded_replay_tick_run(mesh, avail):
            return avail
        """)
    got = [f.message for f in port.run(root=root, rules=["backend-parity"])
           if f.path == "pivot_tpu_torch/ops/shard.py"]
    for name in ("greedy_kernel_sharded", "sharded_replay_tick_run"):
        assert any(m.startswith(f"unregistered backend form {name}()")
                   for m in got), (name, got)


def test_dtype_torch_inherit(tmp_path):
    got = _port(tmp_path, "ops/snippet.py", """\
        import torch
        a = torch.as_tensor(x)
        b = torch.as_tensor(x, dtype=torch.float32)
        c = torch.from_numpy(x).float()
        d = torch.from_numpy(x).to(dev)
        e = torch.from_numpy(x).to(dev, torch.float32)
        f = torch.from_numpy(x).to(torch.int64)
        g = torch.as_tensor(x, device=dev).to(dtype=torch.float32)
        """, "dtype")
    assert sorted(f.line for f in got) == [2, 5]


def test_threadguard_watchdog_guards(tmp_path):
    got = _port(tmp_path, "recover/watchdog.py", """\
        class PenaltyBox:
            def __init__(self):
                self._rows = []
            def n(self):
                return len(self._rows)
        class DispatchWatchdog:
            def __init__(self):
                self.timeouts = 0
            def bump(self):
                with self._lock:
                    self.timeouts += 1
            def peek(self):
                return self.failures
        """, "thread-guard")
    assert sorted(f.line for f in got) == [5, 13]


def test_parity_port_forms(tmp_path):
    root = str(tmp_path)
    _write(root, "pivot_tpu_torch/ops/cuda_kernels.py", """\
        import torch
        def cost_aware_cuda(avail, bin_pack="first-fit", sort_hosts=True,
                            host_decay=False, live=None):
            return load_library()
        def cost_aware_plain(avail, bin_pack="first-fit", sort_hosts=True,
                             host_decay=False, live=None, risk=None):
            pass
        def best_fit_cuda_rows(avail):
            pass
        """)
    got = [(f.line, _norm(f.message).split(" — ")[0])
           for f in port.run(root=root, rules=["backend-parity"])
           if f.path == "pivot_tpu_torch/ops/cuda_kernels.py" and f.line > 1]
    assert (2, "cost_aware_cuda() is missing family 'cost_aware' knob(s) "
               "['risk']") in got
    assert any(line == 8 and m.startswith("unregistered backend form "
                                          "best_fit_cuda_rows()")
               for line, m in got)


def test_parity_reads_the_entry_map(tmp_path):
    """A function that reaches a kernel library's launch in ``ops/`` is a
    device entry point; unregistered in the manifest, it is a finding."""
    root = str(tmp_path)
    _write(root, "pivot_tpu_torch/ops/cuda_kernels.py", """\
        def _entries():
            from pivot_tpu_torch.ops.build import load
            return load("greedy_place").greedy_place_launch
        def _launch(x):
            fn = _entries()
            return fn(x)
        def place_now(x):
            return _launch(x)
        """)
    entries, _f, _s = entrymap.collect_entries(port._Cache(root))
    assert [(e.name, e.kind) for e in
            entries["pivot_tpu_torch/ops/cuda_kernels.py"]] == [
        ("place_now", "kernel")]
    got = [f.message for f in port.run(root=root, rules=["backend-parity"])
           if f.path == "pivot_tpu_torch/ops/cuda_kernels.py"]
    assert any(m.startswith("device entry point place_now() (kernel")
               for m in got)


def test_entry_map_flags_a_graph_outside_its_files(tmp_path):
    root = str(tmp_path)
    _write(root, "pivot_tpu_torch/serve/graphs.py", """\
        import torch
        class Pool:
            def capture(self):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    pass
        """)
    _entries, findings, _s = entrymap.collect_entries(port._Cache(root))
    assert [(f.path, f.line) for f in findings
            if f.path.startswith("pivot_tpu_torch/serve")] == [
        ("pivot_tpu_torch/serve/graphs.py", 1)]


def _budget_tree(tmp_path):
    root = str(tmp_path)
    for rel in (kernel_budget._CU_FILE, kernel_budget._CF_CU_FILE,
                kernel_budget._CHAIN_CU_FILE, kernel_budget._WRAPPER_FILE,
                kernel_budget._ROOFLINE_FILE):
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        shutil.copy(os.path.join(ROOT, rel), os.path.join(root, rel))
    return root


def _edit(root, rel, old, new):
    path = os.path.join(root, rel)
    with open(path) as f:
        text = f.read()
    assert old in text
    with open(path, "w") as f:
        f.write(text.replace(old, new, 1))


@pytest.mark.parametrize("rel,old,new,expect", [
    (kernel_budget._CU_FILE, "static_cast<size_t>(20) * K",
     "static_cast<size_t>(24) * K", "_smem_bytes disagrees"),
    (kernel_budget._CU_FILE, "K <= 3   ? 768", "K <= 3   ? 736",
     "_REG_THREADS[3] = 768"),
    (kernel_budget._CU_FILE, "constexpr int kSmemK = 10;",
     "constexpr int kSmemK = 9;", "_SMEM_K = 10"),
    (kernel_budget._CU_FILE, "case 20: return launch<20, false>(p, s);",
     "", "_REG_THREADS covers"),
    (kernel_budget._CU_FILE, "__launch_bounds__(max_threads(K, kSmem), 1)",
     "", "greedy_place_kernel lost __launch_bounds__"),
    (kernel_budget._CU_FILE, "align16(static_cast<size_t>(8) * Z * Z)",
     "align16(sizeof(float2) * Z * Z)", "cannot read"),
    (kernel_budget._CU_FILE, "return 32 * W < kMaxChunk ? 32 * W",
     "return 16 * W < kMaxChunk ? 16 * W", "_smem_bytes disagrees"),
    (kernel_budget._CU_FILE, "C > 1 ? static_cast<size_t>(16) * C : 0",
     "C > 1 ? static_cast<size_t>(24) * C : 0", "_smem_bytes disagrees"),
    (kernel_budget._CU_FILE, "constexpr int kMaxCluster = 16;",
     "constexpr int kMaxCluster = 8;", "MAX_CLUSTER = 16"),
    (kernel_budget._CU_FILE, "table_bytes(Z) + static_cast<size_t>(16) * 32",
     "table_bytes(Z) + static_cast<size_t>(16) * 16",
     "_global_smem_bytes disagrees"),
    (kernel_budget._WRAPPER_FILE, "_SMEM_LIMIT = H100_SMEM_OPTIN_BYTES",
     "_SMEM_LIMIT = 101376", "_SMEM_LIMIT (101376)"),
    (kernel_budget._ROOFLINE_FILE, "H100_SMEM_OPTIN_BYTES = 232448",
     "H100_SMEM_OPTIN_BYTES = 202752", "the largest block"),
])
def test_kernel_budget_falsifiers(tmp_path, rel, old, new, expect):
    root = _budget_tree(tmp_path)
    assert port.run(root=root, rules=["kernel-budget"]) == []
    _edit(root, rel, old, new)
    got = port.run(root=root, rules=["kernel-budget"])
    assert any(expect in f.message for f in got), [str(f) for f in got]


@pytest.mark.parametrize("rel,old,new,expect", [
    (kernel_budget._CHAIN_CU_FILE, "return 17 + snap + rk;",
     "return 16 + snap + rk;", "_chain_smem_bytes disagrees"),
    (kernel_budget._CHAIN_CU_FILE, "return 36 * kChunk;",
     "return 40 * kChunk;", "_chain_smem_bytes disagrees"),
    (kernel_budget._CHAIN_CU_FILE, "constexpr int kChunk = 64;",
     "constexpr int kChunk = 32;", "_CHAIN_CHUNK = 64"),
    (kernel_budget._CHAIN_CU_FILE, "constexpr int kMaxZones = 256;",
     "constexpr int kMaxZones = 128;", "_CHAIN_MAX_ZONES = 256"),
    (kernel_budget._CHAIN_CU_FILE, "constexpr int kFormGlobal = 1;",
     "constexpr int kFormGlobal = 2;", "_CHAIN_GLOBAL = 1"),
    (kernel_budget._CHAIN_CU_FILE, "__launch_bounds__(kMaxThreads)", "",
     "ensemble_chain_kernel lost __launch_bounds__"),
    (kernel_budget._CHAIN_CU_FILE, "constexpr int kMaxThreads = 1024;",
     "constexpr int kMaxThreads = 2048;", "above the card's 1024"),
    (kernel_budget._CHAIN_CU_FILE, "constexpr int kCostAware = 0;",
     "constexpr int kCostAware = 3;", "names another arm"),
    (kernel_budget._CHAIN_CU_FILE, "return align16(8 * Z * Z);",
     "return align16(sizeof(float2) * Z * Z);", "cannot read"),
    (kernel_budget._WRAPPER_FILE, "_CHAIN_MAX_WARPS = 32",
     "_CHAIN_MAX_WARPS = 16", "_CHAIN_MAX_WARPS = 16"),
    (kernel_budget._WRAPPER_FILE, "host = 17 + (4 if arm == 0 else 0)",
     "host = 17 + (8 if arm == 0 else 0)", "_chain_smem_bytes disagrees"),
])
def test_kernel_budget_reads_ensemble_chain(tmp_path, rel, old, new, expect):
    root = _budget_tree(tmp_path)
    assert port.run(root=root, rules=["kernel-budget"]) == []
    _edit(root, rel, old, new)
    got = port.run(root=root, rules=["kernel-budget"])
    assert any(expect in f.message for f in got), [str(f) for f in got]


def test_kernel_budget_ensemble_chain_missing_and_registers(tmp_path):
    root = _budget_tree(tmp_path)
    os.remove(os.path.join(root, kernel_budget._CHAIN_CU_FILE))
    got = port.run(root=root, rules=["kernel-budget"])
    assert any("ensemble_chain.cu is missing" in f.message for f in got)
    model = kernel_budget.chain_model()
    assert model.max_threads == 1024 and model.launch_bounded
    assert kernel_budget.chain_register_findings(
        [dict(build="cost-aware/shared", registers=64)], 65536) == []
    bad = kernel_budget.chain_register_findings(
        [dict(build="cost-aware/global", registers=72)], 65536)
    assert len(bad) == 1 and "72 registers x 1024 threads" in bad[0].message


def test_every_kernel_source_builds_as_a_kernel_build(tmp_path, monkeypatch):
    """``build_all()`` compiles every source of ``SOURCES`` (the three
    hand kernels, each a ``csrc/<name>.cu`` of the package) with one nvcc
    each, and the compile counter records each library written as one
    ``kernel_build`` (a stand-in compiler here)."""
    from pivot_tpu_torch.ops import build
    from pivot_tpu_torch.utils.compile_counter import count_compiles

    assert build.SOURCES == ("greedy_place", "carry_free_place",
                             "ensemble_chain")
    for name in build.SOURCES:
        assert os.path.isfile(os.path.join(build._CSRC, f"{name}.cu"))
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(build, "_BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    with count_compiles() as first:
        paths = build.build_all()
    assert sorted(paths) == sorted(build.SOURCES)
    assert first.kernel_builds == 3
    with count_compiles() as again:
        build.build_all(("ensemble_chain",))
    assert again.kernel_builds == 0


def test_kernel_budget_registers():
    ok = [dict(K=k, state="registers", registers=65536 // t)
          for k, t in ((1, 1024), (4, 640), (20, 256))]
    assert kernel_budget.register_findings(ok, 65536) == []
    bad = kernel_budget.register_findings(
        [dict(K=4, state="registers", registers=103)], 65536)
    assert len(bad) == 1 and "103 registers x 640 threads" in bad[0].message


# ---------------------------------------------------------------------------
# The port's own tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule", sorted(port.REGISTRY()))
def test_port_tree_is_clean(rule):
    assert [str(f) for f in port.run(rules=[rule])] == []


def test_cli_json_and_rules(capsys):
    assert port.main(["--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["clean"] and rep["rules"] == sorted(port.REGISTRY())
    assert port.main(["--rules", "retrace"]) == 2  # not ported
    assert port.main(["--list-rules"]) == 0


def test_compile_check_quick_on_the_cpu(capsys):
    assert port.main(["--compile-check", "quick", "--device", "cpu"]) == 0
    assert "zero kernel builds and graph captures" in capsys.readouterr().out


def _knob_sets(mod, root):
    cache = (ref if mod is ref_parity else port)._Cache(root)
    funcs = {}
    for forms in [*mod.MANIFEST.values(), mod.SPAN_MANIFEST]:
        for rel, _ex in forms.values():
            src = cache.get(rel)
            if src is not None:
                funcs[rel] = mod._top_level_functions(src)
    out = {}
    for family, forms in mod.MANIFEST.items():
        _f, sets = mod._matrix_findings(family, forms, mod.KNOBS, funcs)
        out.update(sets)
    _f, sets = mod._matrix_findings("span", mod.SPAN_MANIFEST,
                                    mod.SPAN_KNOBS, funcs)
    out.update(sets)
    return out


def test_parity_knob_sets_equal_the_reference_less_sharded():
    ref_sets = _knob_sets(ref_parity, ROOT)
    port_sets = _knob_sets(port_parity, ROOT)
    as_ref = {port_parity.REFERENCE_FORM.get(n, n): s
              for n, s in port_sets.items()}
    for name, knobs in ref_sets.items():
        assert name not in port_parity.ABSENT
        assert as_ref[name] == knobs, name
    assert {"cost_aware_kernel_sharded", "sharded_fused_tick_run",
            "cost_aware_kernel_sharded_batched", "sharded_batched_tick_run",
            "sharded_resident_span_run"} <= set(port_sets)
    # Every reference form has its port form: nothing is declared absent.
    assert port_parity.ABSENT == {}
