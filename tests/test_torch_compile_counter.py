"""The port's compile counter (``pivot_tpu_torch/utils/compile_counter.py``)
and ``obs.attach_compile_observer``, against the reference's contract
(``pivot_tpu/utils/compile_counter.py``, ``pivot_tpu/obs/__init__.py``).

A fresh native-fabric build counts one ``kernel_build`` and a second use
none; ``ops/build.py``'s nvcc build counts one a source written (a stand-in
compiler here: there is no nvcc on the CPU).  CUDA-graph captures are held
on the card (``chip_smoke.py`` phase 14 (d): 0 in a steady window, 1 for
a new snapshot shape)."""

import os
import stat
import threading

import pytest

from pivot_tpu_torch import native
from pivot_tpu_torch.obs import MetricsRegistry, Tracer, attach_compile_observer
from pivot_tpu_torch.ops import build
from pivot_tpu_torch.utils import compile_counter
from pivot_tpu_torch.utils.compile_counter import count_compiles


def test_native_build_counts_one_kernel_build(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "native"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_error", None)
    with count_compiles() as first:
        native.load_library()
    assert (first.kernel_builds, first.graph_captures) == (1, 0)
    with count_compiles() as cached:
        native.load_library()  # the loaded handle
    monkeypatch.setattr(native, "_lib", None)
    with count_compiles() as on_disk:
        native.load_library()  # a new process: the library is on disk
    assert cached.kernel_builds == on_disk.kernel_builds == 0


def test_nvcc_build_counts_each_source_written(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setattr(build, "_CSRC", str(csrc))
    monkeypatch.setattr(build, "_BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    with count_compiles() as first:
        paths = build.build_all(("a", "b"))
    assert first.kernel_builds == 2
    assert all(os.path.exists(p) for p in paths.values())
    with count_compiles() as again:
        assert build.build_all(("a", "b")) == paths
    assert again.kernel_builds == 0


def test_windows_nest_and_totals_grow():
    t0 = compile_counter.totals()
    with count_compiles() as outer:
        compile_counter.record("kernel_build")
        with count_compiles() as inner:
            compile_counter.record("graph_capture")
    compile_counter.record("graph_capture")  # outside every window
    assert (outer.kernel_builds, outer.graph_captures) == (1, 1)
    assert (inner.kernel_builds, inner.graph_captures) == (0, 1)
    t1 = compile_counter.totals()
    assert t1["kernel_build"] - t0["kernel_build"] == 1
    assert t1["graph_capture"] - t0["graph_capture"] == 2
    with pytest.raises(ValueError):
        compile_counter.record("backend_compile")


def test_observer_publishes_registry_counter_and_trace_instant():
    registry, tracer = MetricsRegistry(), Tracer()
    detach = attach_compile_observer(registry, tracer, sim_time=lambda: 7.0)
    try:
        compile_counter.record("graph_capture")
        compile_counter.record("kernel_build")
        compile_counter.record("graph_capture")
    finally:
        detach()
    compile_counter.record("graph_capture")  # detached: not published
    assert registry.get("pivot_compile_events_total",
                        kind="graph_capture") == 2
    assert registry.get("pivot_compile_events_total",
                        kind="kernel_build") == 1
    events = tracer.by_category("compile")
    assert [e["name"] for e in events] == [
        "graph_capture", "kernel_build", "graph_capture"]


def test_records_from_threads_all_count():
    with count_compiles() as c:
        threads = [threading.Thread(
            target=lambda: [compile_counter.record("graph_capture")
                            for _ in range(200)]) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert c.graph_captures == 1600


def test_mpc_capture_count_reads_the_counter():
    from pivot_tpu_torch.mpc.controller import MpcController

    ctl = MpcController.__new__(MpcController)
    ctl._captures0 = None
    assert ctl.captures_after_warmup() is None
    ctl._captures0 = compile_counter.totals()["graph_capture"]
    assert ctl.captures_after_warmup() == 0
    compile_counter.record("graph_capture")
    assert ctl.captures_after_warmup() == 1
