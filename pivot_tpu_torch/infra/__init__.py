"""Simulated cross-cloud infrastructure: hosts, storage, cluster, executor.

Capability parity with the reference's ``resources/__init__.py``:

  * ``HostResource``  — 4-dim (cpus, mem, disk, gpus) capacity vector with
    all-or-nothing admission (ref ``:370-461``).  The reference guards four
    SimPy Containers with a mutex because its ``subscribe`` yields between
    checks; here admission is a single synchronous check-and-reserve, atomic
    by cooperative scheduling — same observable semantics, no locks.
  * ``Host.execute``  — the executor hot path (ref ``:244-314``): admit →
    meter check-in → pull predecessor outputs over the network fabric
    (with per-instance input sampling) → barrier → timed compute → release.
  * ``Cluster``       — the scheduler↔executor broker with the
    ``dispatch_q`` / ``notify_q`` queue pair (ref ``:40,119-135``) — the
    plugin boundary of the whole framework.

Redesigns (TPU-first):
  * **Lazy routes**: the reference pre-creates O(N²) route objects + one
    SimPy process each (``resources/gen.py:61-73``); here routes materialize
    on first use from the dense zone matrices.  An idle pair costs nothing.
  * **Dense state exports**: ``availability_matrix()`` ([H,4] f32) and
    ``host_zone_vector()`` ([H] i32) feed the placement kernels directly.
  * ``clone()`` re-derives *all* route bandwidth from zone metadata and
    meters every route, matching the reference's clone behavior
    (``resources/__init__.py:110-117`` — note this intentionally replaces
    generator-assigned self-route bandwidth with the intra-zone value, a
    reference quirk we preserve since every experiment runs on a clone).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pivot_tpu_torch.des import Environment, Event, Store
from pivot_tpu_torch.infra.locality import Locality, ResourceMetadata
from pivot_tpu_torch.infra.meter import Meter
from pivot_tpu_torch.infra.network import NativeRoute, Route
from pivot_tpu_torch.utils import LogMixin, fresh_id
from pivot_tpu_torch.workload import Task

__all__ = [
    "Node",
    "Host",
    "HostResource",
    "Storage",
    "Cluster",
    "LOCAL_BW",
]

#: Same-host loopback bandwidth in Mbps (ref ``resources/gen.py:13``).
LOCAL_BW = 2e5

RESOURCE_DIMS = ("cpus", "mem", "disk", "gpus")


class Node(LogMixin):
    """A network endpoint with a locality."""

    def __init__(self, env: Environment, locality: Locality, id: Optional[str] = None):
        self.env = env
        self.id = str(id) if id is not None else fresh_id(type(self).__name__.lower())
        self.locality = locality
        self.cluster: Optional["Cluster"] = None

    def __repr__(self) -> str:
        return self.id

    def __hash__(self) -> int:
        return hash(self.id)

    def __eq__(self, other) -> bool:
        return isinstance(other, Node) and self.id == other.id


class HostResource:
    """Multi-dimensional host capacity with atomic acquire/release.

    Scalars, not arrays: admission runs once per task execution on the
    simulator's hottest path, where four float compares beat numpy
    dispatch overhead by ~10×.  Dense views are built per scheduling tick
    by ``Cluster.availability_matrix``.
    """

    __slots__ = (
        "t_cpus", "t_mem", "t_disk", "t_gpus",
        "cpus", "mem", "disk", "gpus",
        "_cache",
    )

    def __init__(self, cpus: float, mem: float, disk: float, gpus: float):
        self.t_cpus, self.t_mem, self.t_disk, self.t_gpus = (
            float(cpus),
            float(mem),
            float(disk),
            float(gpus),
        )
        self.cpus, self.mem, self.disk, self.gpus = self.t_cpus, self.t_mem, self.t_disk, self.t_gpus
        # Optional write-through row of the owning cluster's [H,4]
        # availability cache (``Cluster.availability_matrix``): scalars
        # stay authoritative, the row mirrors them after every mutation.
        self._cache = None

    def _sync_cache(self) -> None:
        c = self._cache
        if c is not None:
            c[0] = self.cpus
            c[1] = self.mem
            c[2] = self.disk
            c[3] = self.gpus

    @property
    def totals(self) -> np.ndarray:
        return np.array([self.t_cpus, self.t_mem, self.t_disk, self.t_gpus])

    @property
    def available(self) -> np.ndarray:
        return np.array([self.cpus, self.mem, self.disk, self.gpus])

    @property
    def used(self) -> np.ndarray:
        return self.totals - self.available

    def try_acquire(self, cpus: float, mem: float, disk: float, gpus: float) -> bool:
        """All-or-nothing admission (ref ``subscribe``, ``:433-449``)."""
        if (
            cpus < 0
            or mem < 0
            or disk < 0
            or gpus < 0
            or cpus > self.cpus
            or mem > self.mem
            or disk > self.disk
            or gpus > self.gpus
        ):
            return False
        self.cpus -= cpus
        self.mem -= mem
        self.disk -= disk
        self.gpus -= gpus
        self._sync_cache()
        return True

    def reset(self) -> None:
        """Restore full capacity (fresh machine after fault recovery)."""
        self.cpus, self.mem, self.disk, self.gpus = (
            self.t_cpus, self.t_mem, self.t_disk, self.t_gpus,
        )
        self._sync_cache()

    def release(self, cpus: float, mem: float, disk: float, gpus: float) -> None:
        """Refund, clamped per-dimension to what is actually in use (ref
        ``unsubscribe``, ``:451-461`` — but clamped with ``min`` rather than
        dropped outright: with fractional trace demands, float rounding can
        leave used capacity one ULP below the refund, and dropping it would
        leak host capacity permanently)."""
        if cpus > 0:
            self.cpus += min(cpus, max(self.t_cpus - self.cpus, 0.0))
        if mem > 0:
            self.mem += min(mem, max(self.t_mem - self.mem, 0.0))
        if disk > 0:
            self.disk += min(disk, max(self.t_disk - self.disk, 0.0))
        if gpus > 0:
            self.gpus += min(gpus, max(self.t_gpus - self.gpus, 0.0))
        self._sync_cache()


class Storage(Node):
    """Zone-local object store — anchor for cost-aware grouping."""

    def clone(self, env: Environment) -> "Storage":
        return Storage(env, self.locality, id=self.id)


class Host(Node):
    """A simulated machine: admission control, data staging, timed compute."""

    def __init__(
        self,
        env: Environment,
        cpus: float,
        mem: float,
        disk: float,
        gpus: float,
        locality: Locality,
        meter: Optional[Meter] = None,
        id: Optional[str] = None,
    ):
        super().__init__(env, locality, id)
        self.resource = HostResource(cpus, mem, disk, gpus)
        self.meter = meter
        self._tasks: set = set()
        #: Liveness flag — flipped by fault injection (``infra.faults``).
        #: A down host admits nothing and reports zero availability.
        self.up = True
        #: Spot-preemption drain flag (``infra.faults.preempt_host``):
        #: a draining host still runs its residents and still ADMITS (the
        #: machine is alive), but the scheduler's live mask excludes it
        #: from NEW placements so work drains ahead of the abort.
        self.draining = False
        #: Straggler multiplier (``infra.faults.slow_host``): compute
        #: started while > 1 takes ``runtime × slowdown`` sim-seconds.
        #: Exactly 1.0 when healthy — ``x * 1.0 == x`` bitwise, so the
        #: no-straggler trajectory is unchanged.
        self.slowdown = 1.0
        # task -> abort Event raced against its compute/staging waits.
        self._aborts: Dict[Task, Event] = {}

    @property
    def tasks(self) -> List[Task]:
        return list(self._tasks)

    @property
    def n_tasks(self) -> int:
        return len(self._tasks)

    @property
    def in_use(self) -> bool:
        return bool(self._tasks)

    def clone(self, env: Environment, meter: Optional[Meter]) -> "Host":
        t = self.resource.totals
        return Host(env, t[0], t[1], t[2], t[3], self.locality, meter, id=self.id)

    def execute(self, task: Task):
        """Generator: run one task on this host (ref ``:244-314``).

        Driven via ``yield from`` inside the cluster's execute process — no
        separate Process object per task execution.
        """
        env, meter, cluster = self.env, self.meter, self.cluster
        group = task.group
        resource = self.resource
        if not self.up:
            return False
        if not resource.try_acquire(group.cpus, group.mem, group.disk, group.gpus):
            return False

        self._tasks.add(task)
        abort = self._aborts[task] = env.event()
        if meter:
            meter.host_check_in(self)
        task.set_running()

        # Stage input data from predecessor task outputs.  Both the staging
        # barrier and the compute timeout race the abort event so a host
        # failure fails the task *now*, not at its original finish time.
        pull_start = env.now
        preds = self._sample_predecessor_inputs(task)
        if preds:
            done_events = []
            routes = []
            for p in preds:
                route = cluster.get_route(
                    self._output_source(p, cluster), self.id
                )
                routes.append(route)
                done_events.append(route.send(p.output_size))
            fired = yield env.any_of([env.all_of(done_events), abort])
            if fired is abort:
                # Cancel orphaned pulls so they stop round-robin-stealing
                # bandwidth from live transfers on shared routes.
                for route, evt in zip(routes, done_events):
                    route.cancel(evt)
                return self._conclude_aborted(task, pull_start)
            if meter:
                self._record_transfer(task, preds, routes, pull_start)

        # Timed compute (stretched while the host straggles).
        fired = yield env.any_of([env.timeout(task.runtime * self.slowdown), abort])
        if fired is abort:
            return self._conclude_aborted(task, pull_start)

        resource.release(group.cpus, group.mem, group.disk, group.gpus)
        self._tasks.discard(task)
        self._aborts.pop(task, None)
        if meter:
            meter.host_check_out(self)
        return True

    @staticmethod
    def _output_source(pred: Task, cluster: "Cluster") -> str:
        """Node serving ``pred``'s output: its host, or — if that host has
        crashed — the producing zone's storage node.

        Task outputs are durably staged to zone-local storage (the
        reference's intended storage-mediated pull path,
        ``resources/__init__.py:137-149`` — dead code there), so a finished
        predecessor's data survives its host.  Zone bw/cost matrices make
        the transfer parameters identical either way; only the metering
        source differs."""
        src = cluster.get_host(pred.placement)
        if src is not None and not src.up:
            store = cluster.get_storage_by_locality(src.locality)
            if store is not None:
                return store.id
        return pred.placement

    def _conclude_aborted(self, task: Task, started: float) -> bool:
        """This execution aborted mid-flight (host death, or a proactive
        ``FastExecutor.evict_task``): no resource refund here — a dead
        machine's capacity resets wholesale on ``recover``, and
        ``evict_task`` refunds BEFORE triggering the abort — but the
        meter interval closes so
        instance-hours stay correct, and the wasted work since ``started``
        is billed as rework (the spot-survival cost accounting)."""
        self._tasks.discard(task)
        self._aborts.pop(task, None)
        if self.meter:
            self.meter.host_check_out(self)
            self.meter.add_rework(self.env.now - started)
        return False

    def fail(self) -> None:
        """Take the host down, aborting every resident task (they surface as
        ``(False, task)`` on ``notify_q`` — the scheduler's existing retry
        path reschedules them elsewhere)."""
        if not self.up:
            return
        self.up = False
        # Fast-executor residents abort synchronously; process-executor
        # residents abort via their raced events.  At most one path has
        # live entries — they are mutually exclusive per cluster.
        if self.cluster is not None and self.cluster.executor is not None:
            self.cluster.executor.abort_host(self)
        for abort in list(self._aborts.values()):
            if not abort.triggered:
                abort.succeed()

    def recover(self) -> None:
        """Bring the host back as a fresh machine: full capacity, no
        tasks, no drain flag, no straggler slowdown."""
        if self.up:
            return
        self.up = True
        self.draining = False
        self.slowdown = 1.0
        self.resource.reset()
        self._tasks.clear()
        self._aborts.clear()

    def _sample_predecessor_inputs(self, task: Task) -> List[Task]:
        """Predecessor tasks to pull from, sampled per instance count.

        A group with n replicas pulls from ~1/n of each predecessor group's
        tasks (with replacement), mirroring ref ``:263-267``.
        """
        group = task.group
        app = group.application
        rng = self.cluster.pyrng
        sampled: List[Task] = []
        for pred_group in app.get_predecessors(group.id):
            if pred_group.output_size <= 0:
                continue
            ptasks = pred_group.tasks
            if not ptasks:
                continue
            if group.instances > 1:
                n = len(ptasks)
                k = max(round(n / group.instances), 1)
                sampled.extend(ptasks[rng.randrange(n)] for _ in range(k))
            else:
                sampled.extend(ptasks)
        return sampled

    def _record_transfer(
        self, task: Task, preds: List[Task], routes: List["Route"], pull_start: float
    ) -> None:
        env, cluster, meter = self.env, self.cluster, self.meter
        meta = cluster.meta
        sum_bw = sum_cost = max_prop = total_amt = 0.0
        sources = set()
        for p, route in zip(preds, routes):
            sum_bw += route.bw
            sum_cost += meta.cost(route.src.locality, self.locality)
            if route.bw > 0:
                prop = p.output_size / route.bw
                if prop > max_prop:
                    max_prop = prop
            total_amt += p.output_size
            sources.add(route.src.locality)
        n = len(preds)
        meter.add_data_transfer(
            env.now,
            sources,
            self.locality,
            total_amt,
            env.now - pull_start,
            max_prop,
            sum_bw / n,
            sum_cost / n,
        )


class Cluster(LogMixin):
    """The simulated fabric and the scheduler↔executor message broker."""

    def __init__(
        self,
        env: Environment,
        hosts: Sequence[Host] = (),
        storage: Sequence[Storage] = (),
        meta: Optional[ResourceMetadata] = None,
        meter: Optional[Meter] = None,
        route_mode: str = "local",
        seed: Optional[int] = None,
        network_backend: str = "python",
        executor_backend: str = "fast",
    ):
        """``route_mode``: 'local' gives same-host loopback routes LOCAL_BW
        and meters only host↔storage pairs (generator behavior, ref
        ``resources/gen.py:61-73``); 'meta' derives every route from zone
        metadata and meters all routes (clone behavior, ref ``:110-117``).

        ``network_backend``: 'python' serves chunks on the event kernel;
        'native' runs the whole chunk-service loop in the C++ co-simulator
        (``pivot_tpu_torch.native``) — same completion times, far fewer events.

        ``executor_backend``: 'fast' drives each task execution with bare
        callbacks (``infra.executor.FastExecutor``); 'process' mirrors the
        reference's one-process-per-execution shape (``Host.execute``
        driven by ``_execute_task``).  Bit-identical trajectories — the
        parity suite in ``tests/test_executor.py`` holds both to it.
        """
        if route_mode not in ("local", "meta"):
            raise ValueError(f"unknown route_mode {route_mode!r}")
        if network_backend not in ("python", "native"):
            raise ValueError(f"unknown network_backend {network_backend!r}")
        if executor_backend not in ("process", "fast"):
            raise ValueError(f"unknown executor_backend {executor_backend!r}")
        self.env = env
        self.meta = meta if meta is not None else ResourceMetadata()
        self.meter = meter
        self.route_mode = route_mode
        self.network_backend = network_backend
        self.net_engine = None
        if network_backend == "native":
            raise NotImplementedError(
                "network_backend='native' (the C++ network co-simulator of "
                "pivot_tpu/native/) is not ported to pivot_tpu_torch yet; "
                "use network_backend='python' (ROADMAP.md, port queue)"
            )
        self.executor_backend = executor_backend
        self.executor = None
        if executor_backend == "fast":
            from pivot_tpu_torch.infra.executor import FastExecutor

            self.executor = FastExecutor(self)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        # Python RNG for the per-task predecessor sampling hot path (each
        # draw is a scalar; random.Random beats numpy dispatch ~10×).
        self.pyrng = random.Random(seed)
        self._hosts: Dict[str, Host] = {}
        self._host_list: List[Host] = []
        # Write-through [H,4] f64 availability mirror; (re)built lazily by
        # ``availability_matrix`` and invalidated when membership changes.
        self._avail_cache: Optional[np.ndarray] = None
        self._storage: Dict[str, Storage] = {}
        self._storage_by_locality: Dict[Locality, Storage] = {}
        self._routes: Dict[Tuple[str, str], Route] = {}
        # Called with each newly materialized route.  Routes are lazy, so
        # state that must cover the whole fabric (an active network
        # partition, ``infra.faults``) registers here to catch links that
        # materialize while it is in force.
        self._route_hooks: List = []
        for h in hosts:
            self.add_host(h)
        for s in storage:
            self.add_storage(s)
        self.dispatch_q = Store(env)
        self.notify_q = Store(env)

    # -- membership ------------------------------------------------------
    @property
    def hosts(self) -> List[Host]:
        return list(self._host_list)

    @property
    def storage(self) -> List[Storage]:
        return list(self._storage.values())

    def add_host(self, host: Host) -> None:
        if host.id in self._hosts:
            raise ValueError(f"host {host.id!r} already exists")
        host.cluster = self
        self._hosts[host.id] = host
        self._host_list.append(host)
        self._avail_cache = None  # membership changed; rebuild lazily

    def add_storage(self, storage: Storage) -> None:
        storage.cluster = self
        self._storage[storage.id] = storage
        self._storage_by_locality[storage.locality] = storage

    def get_host(self, hid: str) -> Optional[Host]:
        return self._hosts.get(hid)

    def get_storage(self, sid: str) -> Optional[Storage]:
        return self._storage.get(sid)

    def get_storage_by_locality(self, locality: Locality) -> Optional[Storage]:
        return self._storage_by_locality.get(locality)

    def _node(self, nid: str) -> Node:
        node = self._hosts.get(nid) or self._storage.get(nid)
        if node is None:
            raise KeyError(f"unknown node {nid!r}")
        return node

    def get_route(self, src_id: str, dst_id: str) -> Route:
        """Lazily materialize the directed route between two nodes."""
        key = (str(src_id), str(dst_id))
        route = self._routes.get(key)
        if route is None:
            src, dst = self._node(key[0]), self._node(key[1])
            if self.route_mode == "local" and src.id == dst.id:
                bw = LOCAL_BW
            else:
                bw = self.meta.bw(src.locality, dst.locality)
            if self.route_mode == "meta":
                metered = self.meter
            else:
                host_storage_pair = (
                    isinstance(src, Host) and isinstance(dst, Storage)
                ) or (isinstance(src, Storage) and isinstance(dst, Host))
                metered = self.meter if host_storage_pair else None
            if self.net_engine is not None:
                route = NativeRoute(
                    self.env, src, dst, bw, self.net_engine, meter=metered
                )
            else:
                route = Route(self.env, src, dst, bw, meter=metered)
            self._routes[key] = route
            for hook in self._route_hooks:
                hook(route)
        return route

    def add_route_hook(self, hook) -> None:
        """Register ``hook(route)`` to run on every future lazy route
        materialization (existing routes are the caller's to walk)."""
        self._route_hooks.append(hook)

    # -- lifecycle -------------------------------------------------------
    def clone(
        self,
        env: Environment,
        meter: Optional[Meter],
        seed: Optional[int] = None,
        network_backend: Optional[str] = None,
        executor_backend: Optional[str] = None,
    ) -> "Cluster":
        hosts = [h.clone(env, meter) for h in self._host_list]
        storage = [s.clone(env) for s in self._storage.values()]
        return Cluster(
            env,
            hosts=hosts,
            storage=storage,
            meta=self.meta,
            meter=meter,
            route_mode="meta",
            seed=self.seed if seed is None else seed,
            network_backend=network_backend or self.network_backend,
            executor_backend=executor_backend or self.executor_backend,
        )

    def start(self) -> None:
        self.env.process(self._dispatch_loop())

    def _dispatch_loop(self):
        while True:
            task = yield self.dispatch_q.get()
            # Same-instant batching: items put synchronously with the one
            # just handed off start in FIFO order without paying one
            # get-event round-trip each.
            batch = [task]
            batch.extend(self.dispatch_q.drain())
            if self.executor is not None:
                # One-hop deferral mirroring the process executor's
                # bootstrap events: admission/check-in must get a fresh seq
                # here so same-instant conclusions (older-seq events)
                # release first.  One callback covers the whole batch: the
                # only work that could interleave between per-task
                # bootstraps (URGENT listener resumes on admission failure)
                # touches no state dispatch reads, so batching is exact.
                executor = self.executor
                self.env.schedule_callback(
                    0.0, lambda b=batch: self._dispatch_batch(executor, b)
                )
            else:
                for item in batch:
                    self._dispatch_one(item)

    def _dispatch_batch(self, executor, batch) -> None:
        for task in batch:
            host = self._validate(task)
            if host is not None:
                executor.dispatch(task, host)

    def _validate(self, task) -> Optional[Host]:
        if not isinstance(task, Task):
            self.logger.error("dispatched non-task item: %r", task)
            return None
        host = self._hosts.get(task.placement)
        if host is None:
            self.logger.error("unrecognized host %r", task.placement)
            return None
        return host

    def _dispatch_one(self, task) -> None:
        host = self._validate(task)
        if host is None:
            return
        self.env.process(self._execute_task(task, host))

    def _execute_task(self, task: Task, host: Host):
        # ``yield from`` runs the host's generator inside this process —
        # one Process object per execution instead of two.
        success = yield from host.execute(task)
        self.notify_q.put((success, task))

    # -- dense exports for the decision kernels --------------------------
    def availability_matrix(self, dtype=np.float64) -> np.ndarray:
        """[H, 4] current per-host availability snapshot.

        Down hosts report −1 per dimension: every demand is ≥ 0, so no fit
        test (strict or non-strict) can select them — including zero-demand
        tasks, which a zero row would admit and livelock on a dead host.
        The sentinel is finite so downstream residual/norm arithmetic in
        the f32 kernels stays finite."""
        hosts = self._host_list
        if self._avail_cache is None or len(self._avail_cache) != len(hosts):
            cache = np.empty((len(hosts), 4), dtype=np.float64)
            for i, h in enumerate(hosts):
                h.resource._cache = cache[i]
                h.resource._sync_cache()
            self._avail_cache = cache
        out = self._avail_cache.astype(dtype, copy=True)
        for i, h in enumerate(hosts):
            if not h.up:
                out[i] = -1.0
        return out

    def totals_matrix(self, dtype=np.float64) -> np.ndarray:
        hosts = self._host_list
        out = np.empty((len(hosts), 4), dtype=dtype)
        for i, h in enumerate(hosts):
            r = h.resource
            out[i, 0] = r.t_cpus
            out[i, 1] = r.t_mem
            out[i, 2] = r.t_disk
            out[i, 3] = r.t_gpus
        return out

    def host_zone_vector(self) -> np.ndarray:
        """[H] int32 zone index per host."""
        return self.meta.zone_vector([h.locality for h in self._host_list])

    def storage_zone_vector(self) -> np.ndarray:
        """[S] int32 zone index per storage node."""
        return self.meta.zone_vector([s.locality for s in self.storage])
