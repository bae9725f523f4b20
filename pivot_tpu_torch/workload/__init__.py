"""Workload model: Application DAGs of task groups fanned out into tasks.

Capability parity with the reference's ``application/__init__.py``:
  * ``Application``  — a DAG of task groups with readiness semantics
    (ref ``application/__init__.py:15-156``).
  * ``TaskGroup``    — one DAG node: a task *type* replicated into
    ``instances`` identical tasks (ref "Container",
    ``application/__init__.py:215-326``).
  * ``Task``         — the schedulable unit (ref ``:167-212``).

Differences by design (TPU-first):
  * The DAG is stored as plain predecessor/successor index lists — no
    networkx.  Cycle detection is a Kahn topological sort.  Dense integer
    indices are the native currency of the placement kernels
    (``pivot_tpu_torch.ops``), so the DAG also exports its structure as numpy
    arrays (``demand_matrix``, ``pred_matrix``) for device-resident rollouts.
  * ``Task.set_nascent`` actually resets state (the reference has a
    no-op ``==`` typo at ``application/__init__.py:203``; the retry path
    still works there only because ``placement`` is cleared — we implement
    the evident intent and test the retry path explicitly).
"""

from __future__ import annotations

import enum
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from pivot_tpu_torch.utils import LogMixin, fresh_id

__all__ = ["TaskState", "Task", "TaskGroup", "Application", "DagError", "Dataflow"]


class DagError(ValueError):
    """Raised when a task-group dependency graph is not a DAG."""


class TaskState(enum.Enum):
    NASCENT = "nascent"
    SUBMITTED = "submitted"
    RUNNING = "running"
    FINISHED = "finished"
    #: Terminal dead-letter state (retry governance, ``sched/retry.py``):
    #: the task exhausted its retry budget and will never be resubmitted.
    #: Not FINISHED — a dead task never counts toward group completion,
    #: so its application cannot silently "finish" around a lost task.
    DEAD = "dead"


class Task:
    """One replica instance of a task group — the unit of placement.

    Composite id ``<group_id>/<ordinal>`` as in the reference
    (``application/__init__.py:182-184``).
    """

    __slots__ = ("group", "ordinal", "placement", "state", "runtime")

    def __init__(self, group: "TaskGroup", ordinal: int):
        self.group = group
        self.ordinal = ordinal
        self.placement: Optional[str] = None
        self.state = TaskState.NASCENT
        # Per-task runtime enables Monte-Carlo perturbation of individual
        # replicas; defaults to the group's runtime.
        self.runtime = group.runtime

    @property
    def id(self) -> str:
        return f"{self.group.id}/{self.ordinal}"

    @property
    def application(self) -> "Application":
        return self.group.application

    @property
    def cpus(self) -> float:
        return self.group.cpus

    @property
    def mem(self) -> float:
        return self.group.mem

    @property
    def disk(self) -> float:
        return self.group.disk

    @property
    def gpus(self) -> float:
        return self.group.gpus

    @property
    def output_size(self) -> float:
        return self.group.output_size

    @property
    def demand(self) -> np.ndarray:
        """[4] demand vector (shared with the group; do not mutate)."""
        return self.group.demand_np

    @property
    def is_nascent(self) -> bool:
        return self.state == TaskState.NASCENT

    @property
    def is_finished(self) -> bool:
        return self.state == TaskState.FINISHED

    @property
    def is_dead(self) -> bool:
        return self.state == TaskState.DEAD

    def _leave_finished(self) -> None:
        if self.state == TaskState.FINISHED:
            self.group._n_finished -= 1

    def set_nascent(self) -> None:
        self._leave_finished()
        self.state = TaskState.NASCENT

    def set_submitted(self) -> None:
        self._leave_finished()
        self.state = TaskState.SUBMITTED

    def set_running(self) -> None:
        self._leave_finished()
        self.state = TaskState.RUNNING

    def set_finished(self) -> None:
        if self.state != TaskState.FINISHED:
            self.group._n_finished += 1
        self.state = TaskState.FINISHED

    def set_dead(self) -> None:
        """Dead-letter terminal transition (see ``TaskState.DEAD``)."""
        self._leave_finished()
        self.state = TaskState.DEAD

    def __repr__(self) -> str:
        return f"Task({self.id}@{self.placement})"


class TaskGroup(LogMixin):
    """A DAG node: one task type fanned out into ``instances`` replicas."""

    def __init__(
        self,
        id: str,
        cpus: float,
        mem: float,
        disk: float = 0.0,
        gpus: float = 0.0,
        runtime: float = 0.0,
        output_size: float = 0.0,
        instances: int = 1,
        dependencies: Sequence[str] = (),
    ):
        if instances < 1:
            raise ValueError(f"instances must be >= 1, got {instances}")
        self.id = str(id)
        self.cpus = float(cpus)
        self.mem = float(mem)
        self.disk = float(disk)
        self.gpus = float(gpus)
        self.runtime = float(runtime)
        self.output_size = float(output_size)
        self.instances = int(instances)
        self.dependencies: List[str] = [str(d) for d in dependencies]
        self.application: Optional["Application"] = None
        self._tasks: List[Task] = []
        self._demand_np: Optional[np.ndarray] = None
        self._n_finished = 0  # maintained by Task state setters

    @property
    def demand_np(self) -> np.ndarray:
        """Cached [4] demand vector shared by all task instances (treat as
        immutable — the group's shape never changes after construction)."""
        if self._demand_np is None:
            self._demand_np = np.array(
                [self.cpus, self.mem, self.disk, self.gpus], dtype=np.float64
            )
        return self._demand_np

    @property
    def tasks(self) -> List[Task]:
        return list(self._tasks)

    @property
    def is_finished(self) -> bool:
        # A group with no materialized tasks is NOT finished (ref
        # ``application/__init__.py:297-299``).  O(1) via the counter.
        return 0 < len(self._tasks) == self._n_finished

    def materialize_tasks(self) -> List[Task]:
        """Create (once) and return the group's task replicas."""
        while len(self._tasks) < self.instances:
            self._tasks.append(Task(self, len(self._tasks)))
        return list(self._tasks)

    def add_dependencies(self, *group_ids: str) -> None:
        self.dependencies = sorted(set(self.dependencies) | set(map(str, group_ids)))

    def clone(self) -> "TaskGroup":
        return TaskGroup(
            self.id,
            self.cpus,
            self.mem,
            self.disk,
            self.gpus,
            self.runtime,
            self.output_size,
            self.instances,
            self.dependencies,
        )

    def __repr__(self) -> str:
        return f"TaskGroup({self.id} x{self.instances})"


class Application(LogMixin):
    """A DAG of task groups — the unit of submission.

    Readiness semantics mirror the reference: a group is ready when every
    predecessor group is finished (``application/__init__.py:101-105``); the
    app is finished when all sink groups are finished (``:66-68``).
    """

    def __init__(self, id: str, groups: Iterable[TaskGroup]):
        self.id = str(id)
        self._groups: Dict[str, TaskGroup] = {}
        for g in groups:
            if g.id in self._groups:
                raise ValueError(f"duplicate task group id {g.id!r}")
            self._groups[g.id] = g
            g.application = self
        self._order: List[str] = list(self._groups)  # insertion order -> index
        self._index: Dict[str, int] = {gid: i for i, gid in enumerate(self._order)}
        self._preds: List[List[int]] = [[] for _ in self._order]
        self._succs: List[List[int]] = [[] for _ in self._order]
        for gid, g in self._groups.items():
            i = self._index[gid]
            for dep in g.dependencies:
                if dep not in self._index:
                    raise DagError(f"unknown dependency {dep!r} of group {gid!r}")
                j = self._index[dep]
                if i not in self._succs[j]:
                    self._succs[j].append(i)
                    self._preds[i].append(j)
        self._check_acyclic()
        self.start_time: float = 0.0
        self.end_time: float = 0.0
        #: Set by retry governance when a task of this app is
        #: dead-lettered: the DAG can never finish, the scheduler stops
        #: tracking it, and the serving layer reaps it as a failed job.
        self.failed: bool = False

    # -- structure -------------------------------------------------------
    def _check_acyclic(self) -> None:
        indeg = [len(p) for p in self._preds]
        frontier = [i for i, d in enumerate(indeg) if d == 0]
        seen = 0
        while frontier:
            node = frontier.pop()
            seen += 1
            for s in self._succs[node]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    frontier.append(s)
        if seen != len(self._order):
            raise DagError(f"dependencies of application {self.id!r} form a cycle")

    @property
    def groups(self) -> List[TaskGroup]:
        return [self._groups[gid] for gid in self._order]

    # Reference-familiar alias ("containers").
    containers = groups

    @property
    def avg_output_size(self) -> float:
        return float(np.mean([g.output_size for g in self.groups]))

    def get_group(self, gid: str) -> Optional[TaskGroup]:
        return self._groups.get(str(gid))

    def get_predecessors(self, gid: str) -> List[TaskGroup]:
        i = self._require_index(gid)
        return [self._groups[self._order[j]] for j in self._preds[i]]

    def get_successors(self, gid: str) -> List[TaskGroup]:
        i = self._require_index(gid)
        return [self._groups[self._order[j]] for j in self._succs[i]]

    def get_unfinished_predecessors(self, gid: str) -> List[TaskGroup]:
        return [p for p in self.get_predecessors(gid) if not p.is_finished]

    def get_ready_successors(self, gid: str) -> List[TaskGroup]:
        return [
            s
            for s in self.get_successors(gid)
            if not self.get_unfinished_predecessors(s.id)
        ]

    def get_sources(self) -> List[TaskGroup]:
        return [
            self._groups[self._order[i]]
            for i in range(len(self._order))
            if not self._preds[i]
        ]

    def get_sinks(self) -> List[TaskGroup]:
        return [
            self._groups[self._order[i]]
            for i in range(len(self._order))
            if not self._succs[i]
        ]

    @property
    def is_finished(self) -> bool:
        return all(s.is_finished for s in self.get_sinks())

    def clone(self) -> "Application":
        return Application(fresh_id("app"), [g.clone() for g in self.groups])

    def _require_index(self, gid: str) -> int:
        i = self._index.get(str(gid))
        if i is None:
            raise KeyError(f"unknown task group {gid!r}")
        return i

    # -- analytics -------------------------------------------------------
    def critical_path_runtime(self) -> float:
        """Longest runtime path through the DAG (lower bound on makespan).

        The reference's never-called ``estimate_local_runtime``
        (``application/__init__.py:115-126``) computes the same quantity; here
        it is a clean longest-path DP in topological order and *is* used (by
        the ensemble rollout engine as a normalization reference).
        """
        n = len(self._order)
        finish = [0.0] * n
        indeg = [len(p) for p in self._preds]
        frontier = [i for i, d in enumerate(indeg) if d == 0]
        while frontier:
            i = frontier.pop()
            g = self._groups[self._order[i]]
            base = max((finish[j] for j in self._preds[i]), default=0.0)
            finish[i] = base + g.runtime
            for s in self._succs[i]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    frontier.append(s)
        return max(finish, default=0.0)

    # -- dense exports for the TPU kernels -------------------------------
    def demand_matrix(self) -> np.ndarray:
        """[G, 4] per-group resource demand (cpus, mem, disk, gpus)."""
        return np.array(
            [[g.cpus, g.mem, g.disk, g.gpus] for g in self.groups], dtype=np.float32
        )

    def pred_matrix(self) -> np.ndarray:
        """[G, G] boolean: entry (i, j) true iff group j is a predecessor of i."""
        n = len(self._order)
        mat = np.zeros((n, n), dtype=bool)
        for i, preds in enumerate(self._preds):
            mat[i, preds] = True
        return mat

    def group_vectors(self) -> Dict[str, np.ndarray]:
        """Runtime / output-size / instance-count vectors, index-aligned."""
        groups = self.groups
        return {
            "runtime": np.array([g.runtime for g in groups], dtype=np.float32),
            "output_size": np.array([g.output_size for g in groups], dtype=np.float32),
            "instances": np.array([g.instances for g in groups], dtype=np.int32),
        }

    def __repr__(self) -> str:
        return f"Application({self.id}, {len(self._order)} groups)"


# Reference-familiar alias.
Container = TaskGroup


class Dataflow:
    """A (source group, destination group, data size) edge record.

    API-parity shim for the reference's ``Dataflow``
    (``application/__init__.py:329-352``), which is dead code there — never
    instantiated; edge weight is carried by ``Container.output_size``
    instead.  Kept here (equally unused by the framework) so code written
    against the reference's full surface imports cleanly; prefer
    ``TaskGroup.output_size``.
    """

    __slots__ = ("src", "dst", "data_size")

    def __init__(self, src: str, dst: str, data_size: float = 0.0):
        self.src = src
        self.dst = dst
        self.data_size = data_size

    def __eq__(self, other):
        return (
            isinstance(other, Dataflow)
            and (self.src, self.dst, self.data_size)
            == (other.src, other.dst, other.data_size)
        )

    def __hash__(self):
        return hash((self.src, self.dst, self.data_size))

    def __repr__(self):
        return f"Dataflow({self.src} -> {self.dst}, {self.data_size} MB)"
