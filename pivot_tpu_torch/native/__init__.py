"""Native (C++) runtime components, bound via ctypes.

Port of ``pivot_tpu/native/__init__.py`` (JAX-free: a copy with the
import paths rewritten).  The only native component is the network
co-simulator (``pivot_net.cpp``, a copy of the reference's): chunk
service is the simulator's dominant event source, and the C++ engine
keeps the whole chunk-service loop out of the Python event kernel.  The
shared library is compiled on first use with ``g++`` into
``pivot_tpu_torch/_build/native/`` (listed in ``.gitignore``) and cached
by source hash.  Construction fails fast with :class:`BuildError` when no
toolchain is present; the experiment CLI checks :func:`available` up
front and exits — it never falls back to the Python fabric on its own.
A build counts one ``kernel_build`` (``utils/compile_counter.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from math import inf
from typing import Dict, List, Optional, Tuple

from pivot_tpu_torch.utils import compile_counter

__all__ = ["available", "load_library", "NativeNetworkEngine", "BuildError"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "pivot_net.cpp")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build",
    "native",
)

_lib = None
_lib_error: Optional[str] = None


class BuildError(RuntimeError):
    pass


def _source_hash() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the native library; caches the handle."""
    global _lib, _lib_error
    if _lib is not None:
        return _lib
    if _lib_error is not None:
        raise BuildError(_lib_error)
    so_path = os.path.join(_BUILD_DIR, f"libpivotnet-{_source_hash()}.so")
    if not os.path.exists(so_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        # Compile to a private temp path, then rename atomically — concurrent
        # worker processes may race to build the same library, and a CDLL of
        # a half-written .so is a crash.
        tmp_path = f"{so_path}.tmp.{os.getpid()}"
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp_path]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.replace(tmp_path, so_path)
            compile_counter.record("kernel_build")
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            detail = getattr(e, "stderr", str(e))
            _lib_error = f"native build failed: {detail}"
            raise BuildError(_lib_error) from e
        finally:
            if os.path.exists(tmp_path):
                try:
                    os.remove(tmp_path)
                except OSError:
                    pass
    lib = ctypes.CDLL(so_path)
    lib.net_create.restype = ctypes.c_void_p
    lib.net_destroy.argtypes = [ctypes.c_void_p]
    lib.net_add_route.restype = ctypes.c_int32
    lib.net_add_route.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.net_send.restype = ctypes.c_int64
    lib.net_send.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.c_double,
        ctypes.c_double,
    ]
    lib.net_peek.restype = ctypes.c_double
    lib.net_peek.argtypes = [ctypes.c_void_p]
    lib.net_advance.restype = ctypes.c_int64
    lib.net_advance.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.net_collect_done.restype = ctypes.c_int64
    lib.net_collect_done.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
    ]
    lib.net_cancel.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.net_queued_mb.restype = ctypes.c_double
    lib.net_queued_mb.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.net_route_stats.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.net_total_chunks.restype = ctypes.c_int64
    lib.net_total_chunks.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    """True if the native library can be built/loaded on this machine."""
    try:
        load_library()
        return True
    except BuildError:
        return False


class NativeNetworkEngine:
    """ctypes wrapper + event-kernel bridge for the C++ co-simulator.

    The bridge keeps exactly one *live* wake armed at the engine's next
    chunk-completion instant.  Each armed callback carries an arm-sequence
    tag; re-arming bumps the sequence, so a superseded callback dies inert
    on arrival (one no-op, never a duplicate chain).  The pump advances the
    engine to ``now``, succeeds the done-events of finished transfers, and
    re-arms.  ``send`` first drains completions due at ``now`` so the new
    transfer queues behind engine state that is current — at an exact
    same-instant tie this deterministically orders completions before the
    send.  (The pure-Python fabric breaks such ties by event-heap seq
    interleaving instead, so tie order can differ between fabrics; totals
    and meter metrics are unaffected, and full-sim parity holds on the
    canonical experiments.)
    """

    _COLLECT_CAP = 4096

    def __init__(self, env):
        self._h = None
        self._lib = load_library()
        self._h = ctypes.c_void_p(self._lib.net_create())
        self.env = env
        self._done_events: Dict[int, object] = {}
        self._tid_by_event: Dict[object, int] = {}  # reverse map for cancel
        self._routes: List[object] = []  # route facade per native index
        self._armed_time: float = inf  # completion instant of the live wake
        self._arm_seq = 0  # tag of the live wake; older tags are inert
        self._ids_buf = (ctypes.c_int64 * self._COLLECT_CAP)()
        self._times_buf = (ctypes.c_double * self._COLLECT_CAP)()

    def __del__(self):
        h = getattr(self, "_h", None)
        self._h = None
        if h and getattr(self, "_lib", None) is not None:
            self._lib.net_destroy(h)

    # -- route registration ----------------------------------------------
    def add_route(self, bw: float, facade) -> int:
        idx = self._lib.net_add_route(self._h, float(bw))
        self._routes.append(facade)
        return idx

    # -- data plane -------------------------------------------------------
    def send(self, route_idx: int, size_mb: float, done_event) -> int:
        # Bring engine state up to `now` first: a chunk completing at this
        # exact instant must vacate the route before the new transfer
        # queues, or completion order diverges from the Python fabric.
        self._drain()
        tid = self._lib.net_send(
            self._h, route_idx, float(size_mb), float(self.env.now)
        )
        self._done_events[tid] = done_event
        self._tid_by_event[done_event] = tid
        self._sync_wake()
        return tid

    def cancel(self, done_event) -> None:
        """Cancel the live transfer whose completion event is ``done_event``.

        Drains first, so a completion due at exactly ``now`` fires rather
        than being cancelled — the same completions-before-caller tie
        policy ``send`` documents.  A transfer that already completed is a
        no-op, matching the Python fabric's cancel scan finding nothing.
        """
        self._drain()
        tid = self._tid_by_event.pop(done_event, None)
        if tid is None:
            return
        self._done_events.pop(tid, None)
        self._lib.net_cancel(self._h, tid)

    def queued_mb(self, route_idx: int) -> float:
        return self._lib.net_queued_mb(self._h, route_idx)

    @property
    def total_chunks(self) -> int:
        return int(self._lib.net_total_chunks(self._h))

    # -- pump -------------------------------------------------------------
    def _drain(self) -> None:
        """Process completions due at or before ``env.now``."""
        n = self._lib.net_advance(self._h, self.env.now)
        while n > 0:
            got = self._lib.net_collect_done(
                self._h, self._ids_buf, self._times_buf, self._COLLECT_CAP
            )
            for i in range(got):
                evt = self._done_events.pop(self._ids_buf[i])
                self._tid_by_event.pop(evt, None)
                evt.succeed()
            n -= got

    def _sync_wake(self) -> None:
        """Ensure the one live wake matches the engine's next completion."""
        t = self._lib.net_peek(self._h)
        if t == self._armed_time:
            return
        self._arm_seq += 1
        self._armed_time = t
        if t != inf:
            seq = self._arm_seq
            self.env.schedule_callback_at(t, lambda: self._pump(seq))

    def _pump(self, arm_seq: int) -> None:
        if arm_seq != self._arm_seq:
            return  # superseded wake — die inert, the live chain re-arms
        self._drain()
        self._armed_time = inf  # consumed; recompute from the engine
        self._sync_wake()

    # -- meter integration -------------------------------------------------
    def metered_route_stats(self) -> List[Tuple[object, float, int, float]]:
        """(route_facade, served_mb, n_transfers, gap_sum) for metered routes."""
        out = []
        buf = (ctypes.c_double * 3)()
        for idx, facade in enumerate(self._routes):
            if getattr(facade, "meter", None) is None:
                continue
            self._lib.net_route_stats(self._h, idx, buf)
            out.append((facade, buf[0], int(buf[1]), buf[2]))
        return out
