"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, ``_build/lib<name>-<hash>.so``,
keyed by a hash of the source and the flags (the pattern of
``pivot_tpu/native/__init__.py``'s g++ build), and loads with ``ctypes``.
No PyTorch headers are compiled, so a build takes seconds.

Contraction is off (``--fmad=false``) and fast math is not enabled, so
division and square root round to nearest as IEEE specifies — the
kernels' results depend on it (``csrc/greedy_place.cu``,
``csrc/carry_free_place.cu``, ``csrc/ensemble_chain.cu``).

``nvcc`` is ``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else
the one on ``PATH``.

A build and a load hold one lock: serving session threads may reach a
kernel's first use together.  Each ``nvcc`` run that writes a library
counts one ``kernel_build`` (``utils/compile_counter.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

from pivot_tpu_torch.utils import compile_counter

__all__ = ["SOURCES", "NVCC_FLAGS", "BuildError", "build_all", "load"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(_PKG, "_build")

#: Every kernel source of the package, by library name.
SOURCES = ("greedy_place", "carry_free_place", "ensemble_chain")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)


#: Held across a build and a load (re-entrant: a load builds first).
_LOCK = threading.RLock()


class BuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError(
            f"nvcc not found (looked in {path} and on PATH): the CUDA "
            "kernels build only on a machine with the CUDA toolkit"
        )
    return found


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    with open(os.path.join(_CSRC, f"{name}.cu"), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that has no library yet — one ``nvcc``
    per source, all started together — and return ``{name: .so path}``.
    Each compiles to a private temporary path and is renamed into place,
    so a concurrent build never loads a half-written library."""
    with _LOCK:
        return _build_all(names)


def _build_all(names: Iterable[str]) -> Dict[str, str]:
    paths = {name: _lib_path(name) for name in names}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    try:
        for name, path in todo.items():
            tmp = f"{path}.tmp.{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, os.path.join(_CSRC, f"{name}.cu"),
                   "-o", tmp]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, todo[name])
                compile_counter.record("kernel_build")
        if failed:
            raise BuildError("nvcc failed: " + "\n".join(failed))
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        return _load(name)


@functools.lru_cache(maxsize=None)
def _load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(build_all((name,))[name])
