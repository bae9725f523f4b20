"""Random cluster generation.

Capability parity with the reference ``RandomClusterGenerator``
(``resources/gen.py:11-74``): hosts round-robin across the 31 zones, one
storage node per occupied locality, uniform or per-host-sampled shapes drawn
from the same stepped ranges (cpus step 2, mem/disk step 1024, gpus
integer).  Routes are lazy (see ``pivot_tpu_torch.infra.Cluster``) instead of the
reference's eager O(N²) construction.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from pivot_tpu_torch.des import Environment
from pivot_tpu_torch.infra import Cluster, Host, Storage
from pivot_tpu_torch.infra.locality import ResourceMetadata
from pivot_tpu_torch.infra.meter import Meter
from pivot_tpu_torch.utils import LogMixin

__all__ = ["RandomClusterGenerator"]


class RandomClusterGenerator(LogMixin):
    def __init__(
        self,
        env: Environment,
        cpus: Tuple[float, float],
        mem: Tuple[float, float],
        disk: Tuple[float, float],
        gpus: Tuple[int, int],
        meta: Optional[ResourceMetadata] = None,
        meter: Optional[Meter] = None,
        seed: Optional[int] = None,
        network_backend: str = "python",
        executor_backend: str = "fast",
    ):
        assert 0 < cpus[0] <= cpus[1]
        assert 0 < mem[0] <= mem[1]
        assert 0 <= disk[0] <= disk[1]
        assert 0 <= gpus[0] <= gpus[1]
        self.env = env
        self.cpus, self.mem, self.disk, self.gpus = cpus, mem, disk, gpus
        self.meta = meta if meta is not None else ResourceMetadata()
        self.meter = meter
        self.network_backend = network_backend
        self.executor_backend = executor_backend
        self.rng = np.random.default_rng(seed)

    def _sample_shape(self) -> Tuple[int, int, int, int]:
        rng = self.rng
        cpus = int(rng.choice(np.arange(self.cpus[0], self.cpus[1] + 2, 2)))
        mem = int(rng.choice(np.arange(self.mem[0], self.mem[1] + 1024, 1024)))
        disk = int(rng.choice(np.arange(self.disk[0], self.disk[1] + 1024, 1024)))
        gpus = int(rng.integers(self.gpus[0], self.gpus[1] + 1))
        return cpus, mem, disk, gpus

    def generate(self, n_hosts: int, uniform: bool = True, seed: Optional[int] = None) -> Cluster:
        assert isinstance(n_hosts, int) and n_hosts > 0
        meta, meter, env = self.meta, self.meter, self.env
        if seed is None:
            # Derive the cluster's executor-RNG seed from the generator's
            # stream so a seeded generator yields a fully seeded cluster.
            seed = int(self.rng.integers(0, 2**31 - 1))
        zones = meta.zones
        if uniform:
            shape = self._sample_shape()
            hosts = [
                Host(env, *shape, locality=zones[i % len(zones)], meter=meter)
                for i in range(n_hosts)
            ]
        else:
            hosts = [
                Host(
                    env,
                    *self._sample_shape(),
                    locality=zones[i % len(zones)],
                    meter=meter,
                )
                for i in range(n_hosts)
            ]
        occupied = []
        seen = set()
        for h in hosts:
            if h.locality not in seen:
                seen.add(h.locality)
                occupied.append(h.locality)
        storage = [Storage(env, locality=l) for l in occupied]
        return Cluster(
            env,
            hosts=hosts,
            storage=storage,
            meta=meta,
            meter=meter,
            route_mode="local",
            seed=seed,
            network_backend=self.network_backend,
            executor_backend=self.executor_backend,
        )
