"""Synthetic application generators.

Port of ``pivot_tpu/workload/gen.py`` (JAX-free, copied with its import
paths rewritten).

Capability parity with the reference's ``application/gen.py``:
random-DAG apps (``:12-77``), sequential chains (``:80-122``), and
data-parallel stage DAGs (``:125-195``).  All generators take an explicit
``numpy.random.Generator`` — no hidden global seeding (the reference calls
``rnd.seed`` in constructors, ``application/gen.py:30``) — so ensembles can
fan out over independent streams.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from pivot_tpu_torch.utils import LogMixin, fresh_id
from pivot_tpu_torch.workload import Application, TaskGroup

__all__ = [
    "random_dag_edges",
    "RandomApplicationGenerator",
    "SequentialApplicationGenerator",
    "DataParallelApplicationGenerator",
]


def random_dag_edges(
    rng: np.random.Generator, n_nodes: int, edge_density: float
) -> List[Tuple[int, int]]:
    """Random DAG edge list: keep gnp edges (u, v) with u < v.

    Same construction as the reference's RandomDAGGenerator
    (``application/gen.py:33-36``) — sampling a directed gnp graph and
    keeping only forward edges guarantees acyclicity.
    """
    mask = rng.random((n_nodes, n_nodes)) < edge_density
    upper = np.triu(mask, k=1)
    return [(int(u), int(v)) for u, v in zip(*np.nonzero(upper))]


class _RangeSpec:
    """Bounds holder for group attribute sampling."""

    def __init__(
        self,
        cpus: Tuple[float, float],
        mem: Tuple[float, float],
        disk: Tuple[float, float] = (0, 0),
        gpus: Tuple[int, int] = (0, 0),
        runtime: Tuple[float, float] = (1, 1),
        output_size: Tuple[float, float] = (0, 0),
    ):
        assert 0 < cpus[0] <= cpus[1]
        assert 0 < mem[0] <= mem[1]
        assert 0 <= disk[0] <= disk[1]
        assert 0 <= gpus[0] <= gpus[1]
        assert 0 < runtime[0] <= runtime[1]
        assert 0 <= output_size[0] <= output_size[1]
        self.cpus, self.mem, self.disk, self.gpus = cpus, mem, disk, gpus
        self.runtime, self.output_size = runtime, output_size

    def sample_group(self, rng: np.random.Generator, gid: str) -> TaskGroup:
        return TaskGroup(
            gid,
            cpus=float(rng.uniform(*self.cpus)),
            mem=float(rng.integers(self.mem[0], self.mem[1] + 1)),
            disk=float(rng.integers(self.disk[0], self.disk[1] + 1)),
            gpus=float(rng.integers(self.gpus[0], self.gpus[1] + 1)),
            runtime=float(rng.uniform(*self.runtime)),
            output_size=float(
                rng.integers(self.output_size[0], self.output_size[1] + 1)
            ),
        )


class RandomApplicationGenerator(LogMixin):
    """Applications over random gnp DAGs (ref ``application/gen.py:39-77``)."""

    def __init__(
        self,
        n_nodes: Tuple[int, int],
        edge_density: Tuple[float, float],
        spec: _RangeSpec,
        seed: Optional[int] = None,
    ):
        assert 1 < n_nodes[0] <= n_nodes[1]
        assert 0 < edge_density[0] <= edge_density[1] <= 1
        self._n_nodes = n_nodes
        self._edge_density = edge_density
        self._spec = spec
        self._rng = np.random.default_rng(seed)

    def generate(self) -> Application:
        rng = self._rng
        n = int(rng.integers(self._n_nodes[0], self._n_nodes[1] + 1))
        density = float(rng.uniform(*self._edge_density))
        edges = random_dag_edges(rng, n, density)
        groups = {i: self._spec.sample_group(rng, str(i)) for i in range(n)}
        for u, v in edges:
            groups[v].add_dependencies(str(u))
        return Application(fresh_id("app"), list(groups.values()))


class SequentialApplicationGenerator(LogMixin):
    """Chain-DAG applications (ref ``application/gen.py:80-122``)."""

    def __init__(
        self, n_nodes: Tuple[int, int], spec: _RangeSpec, seed: Optional[int] = None
    ):
        assert 0 < n_nodes[0] <= n_nodes[1]
        self._n_nodes = n_nodes
        self._spec = spec
        self._rng = np.random.default_rng(seed)

    def generate(self) -> Application:
        rng = self._rng
        n = int(rng.integers(self._n_nodes[0], self._n_nodes[1] + 1))
        groups = [self._spec.sample_group(rng, str(i)) for i in range(n)]
        for i in range(1, n):
            groups[i].add_dependencies(str(i - 1))
        return Application(fresh_id("app"), groups)


class DataParallelApplicationGenerator(LogMixin):
    """Alternating sequential / fan-out stages (ref ``application/gen.py:125-195``).

    Each stage is either one group (sequential) or ``parallel_level`` groups
    (parallel); every group in a stage depends round-robin on the groups of
    the previous stage, mirroring the reference's modulo wiring
    (``application/gen.py:180-189``).
    """

    def __init__(
        self,
        seq_steps: Tuple[int, int],
        parallel_steps: Tuple[int, int],
        parallel_level: Tuple[int, int],
        spec: _RangeSpec,
        seed: Optional[int] = None,
    ):
        assert 0 <= seq_steps[0] <= seq_steps[1]
        assert 0 <= parallel_steps[0] <= parallel_steps[1]
        assert 1 < parallel_level[0] <= parallel_level[1]
        self._seq_steps = seq_steps
        self._parallel_steps = parallel_steps
        self._parallel_level = parallel_level
        self._spec = spec
        self._rng = np.random.default_rng(seed)

    def generate(self) -> Application:
        rng = self._rng
        n_seq = int(rng.integers(self._seq_steps[0], self._seq_steps[1] + 1))
        n_par = int(rng.integers(self._parallel_steps[0], self._parallel_steps[1] + 1))
        total = n_seq + n_par
        assert total > 0, "at least one stage required"
        p_seq = n_seq / total
        stage_kinds = rng.random(total) < p_seq

        groups: List[TaskGroup] = []
        last_stage: List[str] = []
        next_id = 1
        for is_seq in stage_kinds:
            if is_seq:
                g = self._spec.sample_group(rng, str(next_id))
                g.output_size = g.output_size * g.runtime
                g.add_dependencies(*last_stage)
                groups.append(g)
                last_stage = [g.id]
                next_id += 1
            else:
                level = (
                    int(
                        rng.integers(
                            self._parallel_level[0], self._parallel_level[1] + 1
                        )
                    )
                    if len(last_stage) < 2
                    else len(last_stage)
                )
                stage_ids = []
                for i in range(level):
                    g = self._spec.sample_group(rng, str(next_id + i))
                    g.output_size = g.output_size * g.runtime
                    # Round-robin wiring onto the previous stage.
                    g.add_dependencies(*last_stage[i % max(level, 1) :: level])
                    groups.append(g)
                    stage_ids.append(g.id)
                last_stage = stage_ids
                next_id += level
        return Application(fresh_id("app"), groups)
