"""Device meshes for the port: a named grid of torch devices.

Port of ``pivot_tpu/parallel/mesh.py``.  The reference builds a
``jax.sharding.Mesh`` whose axes are

  * ``replica`` — Monte-Carlo replicas / independent runs (data
    parallel);
  * ``host`` — the simulated-host dimension of the state arrays
    (``[H, 4]`` availability, ``[T, H]`` score rows), partitioned into
    contiguous index blocks (``ops/shard.py``).

The port keeps the reference's single-controller shape: one Python
process runs the DES, and a sharded pass runs its per-shard body batched
over a leading shard axis (``pivot_tpu_torch/ops/shard.py``).  So a
:class:`Mesh` here is only a grid of ``torch.device`` objects with axis
names; it holds no process group.  A mesh may name one device several
times: ``host_sharded_mesh(devices=[torch.device("cuda", 0)] * 4)`` is
four logical host shards on one card, the counterpart of the reference's
forced host-device CPU mesh (``tests/conftest.py``).  With
``devices=None`` the devices are the visible CUDA devices.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "Mesh",
    "build_hybrid_mesh",
    "build_mesh",
    "host_axis_size",
    "host_sharded_mesh",
    "replica_mesh",
    "visible_cards",
]


class Mesh:
    """A grid of torch devices with one name per axis.

    ``devices`` is an object array of ``torch.device`` (repeats allowed:
    logical shards on one device); ``shape`` maps each axis name to its
    size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices, axis_names: Sequence[str]):
        given = np.asarray(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(given[idx])
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(
                f"a {grid.ndim}-D device grid needs {grid.ndim} axis names, "
                f"got {axis_names}")
        self.devices = grid
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        dims = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        return f"Mesh({dims}; {sorted({str(d) for d in self.devices.flat})})"


def visible_cards() -> list:
    """The visible CUDA devices, one ``torch.device`` each (none without
    a card): the devices a default mesh spans, the port's
    ``jax.devices()``."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def _visible_devices() -> list:
    """:func:`visible_cards`; without a card there is no default mesh
    (pass ``devices=`` — e.g. ``[torch.device("cpu")] * S``)."""
    devs = visible_cards()
    if not devs:
        raise RuntimeError(
            "no CUDA device is visible (torch.cuda.is_available() is "
            "False); pass devices= to build a mesh on the CPU")
    return devs


def build_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, str] = ("replica", "host"),
    host_parallel: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A 2-D (replica × host) mesh over ``devices`` (default: the visible
    CUDA devices).  ``host_parallel`` fixes the host-axis size and must
    divide the device count; by default the mesh is replica-only (host
    axis = 1)."""
    devs = list(devices) if devices is not None else _visible_devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    hp = host_parallel or 1
    if n % hp != 0:
        raise ValueError(f"host_parallel={hp} does not divide {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(n // hp, hp), axis_names)


def replica_mesh(
    n_devices: Optional[int] = None, devices: Optional[Sequence] = None
) -> Mesh:
    """Replica-only (data-parallel) mesh: every device on the ``replica``
    axis, host axis = 1."""
    return build_mesh(n_devices, ("replica", "host"), host_parallel=1,
                      devices=devices)


def host_sharded_mesh(
    n_shards: Optional[int] = None, devices: Optional[Sequence] = None
) -> Mesh:
    """Host-only (model-parallel) mesh: every selected device on the
    ``host`` axis, replica axis = 1 — the layout of the host-sharded
    placement passes (``ops/shard.py``): one cluster's ``[H]`` state in
    contiguous index blocks, the per-step argmin a two-stage reduce."""
    devs = list(devices) if devices is not None else _visible_devices()
    n = n_shards if n_shards is not None else len(devs)
    return build_mesh(n, ("replica", "host"), host_parallel=n, devices=devs)


def host_axis_size(mesh: Mesh) -> int:
    """Size of ``mesh``'s host axis (1 on a replica-only mesh)."""
    return int(mesh.shape["host"])


def build_hybrid_mesh(
    host_parallel: int = 1,
    axis_names: Tuple[str, str, str] = ("replica_dcn", "replica", "host"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """The reference's 3-D ``replica_dcn × replica × host`` mesh in its
    single-process form: ``replica_dcn = 1`` and the process's devices
    (default: the visible CUDA devices) laid out as ``per_process /
    host_parallel`` replicas × ``host_parallel`` host shards."""
    devs = list(devices) if devices is not None else _visible_devices()
    per_proc = len(devs)
    if per_proc % host_parallel != 0:
        raise ValueError(
            f"host_parallel={host_parallel} does not divide the "
            f"{per_proc} per-process devices"
        )
    grid = np.empty(per_proc, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(1, per_proc // host_parallel, host_parallel),
                axis_names)
