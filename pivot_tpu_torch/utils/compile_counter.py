"""Compile counter: observe kernel builds and CUDA-graph captures
instead of assuming none.

Port of ``pivot_tpu/utils/compile_counter.py``.  The reference counts
XLA's recompiles through ``jax.monitoring`` events; the port has no
JIT compiler, and what plays that part is the work a warm process must
never repeat:

  =====================================  =======================
  reference event                        port event (kind)
  =====================================  =======================
  ``backend_compile``                    ``kernel_build``
  (``/jax/core/compile/                  an ``nvcc`` run of
  backend_compile_duration``)            ``ops/build.py::_build_all``
                                         or the native fabric's
                                         ``g++`` build
                                         (``native/__init__.py``)
  ``jaxpr_trace``                        ``graph_capture``
  (``/jax/core/compile/                  a ``torch.cuda.graph``
  jaxpr_trace_duration``)                capture (``parallel/ensemble/
                                         tick.py::_SnapshotGraphs``)
  =====================================  =======================

A build whose library is already on disk, a loaded library and a graph
checked out of the pool (the steady state) record nothing.  There is no
listener to install: the build and capture sites call :func:`record`
themselves.

Usage::

    with count_compiles() as counter:
        serve_many_ticks()
    assert counter.kernel_builds == 0 and counter.graph_captures == 0

Observers (:func:`add_observer`) are called with the event kind under
the module lock on every event — how an event becomes a registry
counter bump and a trace instant (``obs.attach_compile_observer``).
Keep them O(1) and non-reentrant.  :func:`totals` counts every event of
the process since import.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Iterator, List

__all__ = [
    "KINDS",
    "CompileCounter",
    "add_observer",
    "count_compiles",
    "record",
    "remove_observer",
    "totals",
]

#: The event kinds, in the reference's order (compile, then trace).
KINDS = ("kernel_build", "graph_capture")

_lock = threading.Lock()
_active: List["CompileCounter"] = []
_observers: List[Callable[[str], None]] = []
_totals: Dict[str, int] = dict.fromkeys(KINDS, 0)


class CompileCounter:
    """Counts of kernel builds and CUDA-graph captures in a window."""

    def __init__(self) -> None:
        self.kernel_builds = 0
        self.graph_captures = 0

    def _record(self, kind: str) -> None:
        if kind == "kernel_build":
            self.kernel_builds += 1
        else:
            self.graph_captures += 1


def record(kind: str) -> None:
    """Count one event of ``kind`` (one of :data:`KINDS`) in every
    active window, the process totals and every observer."""
    if kind not in _totals:
        raise ValueError(f"compile event kind must be one of {KINDS}, "
                         f"got {kind!r}")
    with _lock:
        _totals[kind] += 1
        for counter in _active:
            counter._record(kind)
        for fn in _observers:
            fn(kind)


def totals() -> Dict[str, int]:
    """Events of each kind in the process so far."""
    with _lock:
        return dict(_totals)


def add_observer(fn: Callable[[str], None]) -> None:
    """Register an observer (called with the event kind, under the
    module lock); pair with :func:`remove_observer`."""
    with _lock:
        _observers.append(fn)


def remove_observer(fn: Callable[[str], None]) -> None:
    with _lock:
        try:
            _observers.remove(fn)
        except ValueError:
            pass


@contextlib.contextmanager
def count_compiles() -> Iterator[CompileCounter]:
    """Count kernel builds and graph captures while the block runs.
    Nestable; each context gets its own counter."""
    counter = CompileCounter()
    with _lock:
        _active.append(counter)
    try:
        yield counter
    finally:
        with _lock:
            _active.remove(counter)
