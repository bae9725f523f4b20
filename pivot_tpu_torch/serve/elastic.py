"""Elastic mesh serving: survive the loss of a mesh shard mid-span.

Port of ``pivot_tpu/serve/elastic.py``.  ``enable_sharding`` pins a
session policy to a fixed set of host shards; this module makes that set
ELASTIC — the pool shrinks around a lost shard, keeps serving on the
survivors, and regrows when the shard returns:

* :class:`ElasticConfig` — the knobs ``ServeDriver(elastic=...)`` takes.
  Device faults come from a seeded, serializable
  :class:`~pivot_tpu_torch.infra.faults.ChaosSchedule`
  (``device_fault`` / ``device_restore`` events), compiled to a
  :class:`~pivot_tpu_torch.infra.faults.DeviceFaultPlan` of half-open
  down windows per launch ordinal.

* :class:`ElasticMeshManager` — owns the launch shard set, the ladder of
  mesh shapes (the descending divisors of the launch shard count), one
  mesh per surviving-ordinal tuple, and the shrink / regrow state
  machine.  It installs a fault gate on every session policy
  (``enable_fault_gate``) that runs at each dispatch:

  - **loss**: the dispatch instant falls inside a down window of a
    shard of the policy's CURRENT mesh → raise
    :class:`~pivot_tpu_torch.infra.faults.DeviceLostError`.  The session
    crashes, the driver's supervisor requeues its in-flight work and
    builds a replacement, which this manager reshards onto the
    survivors' mesh before it serves a decision.
  - **regrow**: the down-set at the service-wide frontier no longer
    covers an excluded shard and the ladder admits a larger rung →
    shadow-probe the candidate mesh (a seeded first-fit span on it,
    compared bit for bit against the unsharded ``fused_tick_run``) and,
    on an exact match, reshard in the session's own thread at the
    dispatch boundary.  A failed probe holds the shard out and is
    retried after ``probe_every`` gated dispatches.

On one card a "device" of the plan is a logical shard: every shard of a
mesh names the same ``torch.device``, so neither the devices' values nor
their identities tell the shards apart, and a port ``Mesh`` has no
equality.  The manager therefore records, for each mesh it builds or
adopts, the tuple of launch ordinals that mesh covers — the launch mesh
(and a factory's fresh mesh of the launch devices) covers ``0..n-1``, a
rung built from the survivors covers theirs — and compares meshes by
that tuple.

The contract: a shrink changes where state lives, never what is
decided.  The sharded passes equal the unsharded ones on every mesh
shape (``ops/shard.py``), and pad rows of a non-dividing rung are inert,
so placements after a shrink equal a run on the smaller mesh, and the
wall-clock timing of a regrow cannot change a decision.  No torch
program is compiled per shape here, so revisiting a rung builds nothing.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pivot_tpu_torch.infra.faults import (
    ChaosSchedule,
    DeviceFaultPlan,
    DeviceLostError,
)

__all__ = [
    "DeviceLostError",
    "ElasticConfig",
    "ElasticMeshManager",
    "is_device_loss",
]

#: Lower-cased texts of torch's CUDA runtime errors that name a lost or
#: unavailable device: ``cudaErrorDevicesUnavailable`` ("CUDA-capable
#: device(s) is/are busy or unavailable"), ``cudaErrorNoDevice`` ("no
#: CUDA-capable device is detected"), and any text that says the device
#: was lost.  A kernel's own fault ("an illegal memory access", "device-
#: side assert triggered", "unspecified launch failure") is not a device
#: loss: it stays a session error.
_LOST_DEVICE_TEXTS = ("busy or unavailable", "no cuda-capable device",
                      "device lost", "lost device", "device was lost")


def is_device_loss(exc: BaseException) -> bool:
    """Whether a session error is the loss of a device.  An injected
    fault arrives as :class:`DeviceLostError` (the gate's own type).  A
    real loss surfaces as torch's CUDA runtime error — a
    ``torch.AcceleratorError`` where the installed torch has it, else a
    ``RuntimeError`` whose text begins ``CUDA error`` — and counts only
    when its text names a lost or unavailable device
    (:data:`_LOST_DEVICE_TEXTS`); the reference matches XLA's
    ``XlaRuntimeError`` the same way."""
    if isinstance(exc, DeviceLostError):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    text = str(exc)
    cuda_error = ((accel is not None and isinstance(exc, accel))
                  or (isinstance(exc, RuntimeError)
                      and text.startswith("CUDA error")))
    low = text.lower()
    return cuda_error and any(t in low for t in _LOST_DEVICE_TEXTS)


@dataclass
class ElasticConfig:
    """Elastic serving knobs (``ServeDriver(elastic=...)``).

    ``schedule``: a :class:`ChaosSchedule` whose ``device_fault`` /
    ``device_restore`` events define the injected down windows.
    ``plan`` wins over ``schedule`` when both are given (a pre-built
    :class:`DeviceFaultPlan`).  Neither → no injected faults; the manager
    still classifies real losses and serves ``mark_dead``.

    ``probe``: shadow-probe a returning shard before promoting the larger
    mesh.  ``probe_every``: a failed probe is retried after this many
    gated dispatches.  ``probe_ticks`` / ``probe_tasks``: the probe
    span's (K, B); ``seed`` seeds its operands."""

    schedule: Optional[ChaosSchedule] = None
    plan: Optional[DeviceFaultPlan] = None
    probe: bool = True
    probe_every: int = 64
    probe_ticks: int = 2
    probe_tasks: int = 3
    seed: int = 0


class ElasticMeshManager:
    """The shrink / reshard / regrow state machine behind
    ``ServeDriver(elastic=)``.

    Threads: ``attach`` / ``align`` run under the driver's cv (pool
    surgery), the gates on the session threads.  The manager's own state
    (meshes and their ordinals, probe verdicts, counters, frontier) is
    guarded by ``_lock``; a POLICY is resharded only by its own session
    thread (the gate) or under the cv before its thread starts
    (``attach``) — never concurrently."""

    def __init__(self, config: Optional[ElasticConfig] = None):
        self.config = config or ElasticConfig()
        self.logger = logging.getLogger("pivot_tpu_torch.serve.elastic")
        self._lock = threading.Lock()
        #: Launch devices in ordinal order, from the first attached
        #: policy's mesh: ordinal i is the plan's ordinal i.
        self.devices: Optional[List[torch.device]] = None
        self.ladder: Tuple[int, ...] = ()
        self.plan: Optional[DeviceFaultPlan] = None
        #: One mesh per chosen surviving-ordinal tuple (bounded by the
        #: ladder and the survivor choices).
        self._meshes: Dict[Tuple[int, ...], object] = {}
        #: ``id(mesh)`` → ``(mesh, ordinal tuple)`` for every mesh built
        #: or adopted: the mesh identity of the port (module docstring).
        #: The mesh is held so its id is never reused.
        self._ordinals: Dict[int, Tuple[object, Tuple[int, ...]]] = {}
        #: Ordinals marked dead by hand (real losses, tests); the plan's
        #: windows are time-indexed and need no marking.
        self._dead: set = set()
        #: The largest dispatch instant any gate has seen: where a regrow
        #: is judged and a replacement session is aligned (its own clock
        #: restarts behind it).
        self._frontier = 0.0
        #: Probe verdict per candidate tuple: True = promoted once (never
        #: re-probed), int = gated dispatches until the half-open retry.
        self._probe_state: Dict[Tuple[int, ...], object] = {}
        self.events: List[Tuple[float, str, Tuple[int, ...]]] = []
        self.shrinks = 0
        self.regrows = 0
        self.probes = 0
        self.probe_failures = 0

    # -- wiring ------------------------------------------------------------
    def attach(self, policy) -> None:
        """Adopt a session policy: take the launch shard set from the
        first mesh seen, build the fault plan against it, install the
        dispatch gate, and align the policy onto the current target mesh
        (a replacement built after a shrink must come up on the survivors,
        or its first gated dispatch would crash it again)."""
        mesh = getattr(policy, "_mesh", None)
        if mesh is None:
            raise ValueError(
                "elastic serving needs host-sharded session policies — "
                "call enable_sharding(host_sharded_mesh(...)) in the "
                "session factory"
            )
        from pivot_tpu_torch.ops.shard import REPLICA_AXIS, mesh_shape_ladder

        if int(mesh.shape.get(REPLICA_AXIS, 1)) > 1:
            raise ValueError(
                "elastic serving shrinks the 1-D host axis; a mesh with "
                "a non-trivial replica axis (the batcher's 2-D layout) "
                "is fixed at construction"
            )
        with self._lock:
            if self.devices is None:
                self.devices = list(np.asarray(mesh.devices).ravel())
                n = len(self.devices)
                self.ladder = mesh_shape_ladder(n)
                self._meshes[tuple(range(n))] = mesh
                cfg = self.config
                if cfg.plan is not None:
                    self.plan = cfg.plan
                elif cfg.schedule is not None:
                    self.plan = DeviceFaultPlan.from_schedule(cfg.schedule,
                                                              n)
                else:
                    self.plan = DeviceFaultPlan({}, n)
            self._adopt(mesh)
            frontier = self._frontier
        policy.enable_fault_gate(self._gate_for(policy))
        self.align(policy, frontier)

    def _adopt(self, mesh) -> None:
        """Record a policy's mesh (lock held): a mesh already known keeps
        its ordinals; an unknown one must name the launch devices in
        ordinal order — a factory's fresh launch-shaped mesh — and covers
        ``0..n-1``."""
        if id(mesh) in self._ordinals:
            return
        devs = list(np.asarray(mesh.devices).ravel())
        if devs != self.devices:
            raise ValueError(
                f"a session policy's mesh {mesh!r} is neither a mesh of "
                f"this manager nor one over the launch devices "
                f"{[str(d) for d in self.devices]} in order"
            )
        self._ordinals[id(mesh)] = (mesh, tuple(range(len(self.devices))))

    def align(self, policy, now: float) -> None:
        """Reshard ``policy`` onto the target mesh of the down-set at sim
        time ``now`` (nothing when it is there).  No probe: a shrink is
        always safe, and a replacement session has no in-flight work."""
        key = self._survivor_key(self._down_at(now))
        if self._mesh_key(policy._mesh) != key:
            policy.reshard(self._mesh_of(key))

    # -- the down-set ------------------------------------------------------
    def _down_at(self, now: float) -> frozenset:
        plan_down = self.plan.down_at(now) if self.plan is not None else ()
        with self._lock:
            dead = frozenset(self._dead)
        return frozenset(plan_down) | dead

    def mark_dead(self, ordinal: int) -> None:
        """Record a loss that no plan window carries (a real loss, a
        watchdog timeout)."""
        with self._lock:
            self._dead.add(int(ordinal))

    def mark_restored(self, ordinal: int) -> None:
        with self._lock:
            self._dead.discard(int(ordinal))

    # -- mesh geometry -----------------------------------------------------
    def _survivor_key(self, down: frozenset) -> Tuple[int, ...]:
        """The surviving-ordinal tuple of a down-set: the first ``shape``
        survivors in ordinal order, ``shape`` the largest rung their
        count fills — deterministic, so a replayed plan rebuilds the same
        meshes."""
        survivors = [o for o in range(len(self.devices)) if o not in down]
        if not survivors:
            raise DeviceLostError(sorted(down), self._frontier)
        from pivot_tpu_torch.ops.shard import next_ladder_shape

        shape = next_ladder_shape(self.ladder, len(survivors))
        return tuple(survivors[:shape])

    def _mesh_of(self, key: Tuple[int, ...]):
        """The mesh of a surviving-ordinal tuple, built once:
        ``host_sharded_mesh(len(key), devices=[launch[o] for o in
        key])``."""
        with self._lock:
            mesh = self._meshes.get(key)
            if mesh is None:
                from pivot_tpu_torch.parallel.mesh import host_sharded_mesh

                mesh = host_sharded_mesh(
                    len(key), devices=[self.devices[o] for o in key])
                self._meshes[key] = mesh
            self._ordinals.setdefault(id(mesh), (mesh, key))
        return mesh

    def _mesh_key(self, mesh) -> Tuple[int, ...]:
        """The launch ordinals ``mesh`` covers, in order."""
        with self._lock:
            entry = self._ordinals.get(id(mesh))
        if entry is None:
            raise ValueError(f"mesh {mesh!r} is not one of this manager's")
        return entry[1]

    # -- the dispatch gate -------------------------------------------------
    def _gate_for(self, policy):
        """The dispatch gate of one policy (runs on its session thread
        only)."""

        def _gate(now: float) -> None:
            now = float(now)
            with self._lock:
                if now > self._frontier:
                    self._frontier = now
                frontier = self._frontier
            down = self._down_at(now)
            have = self._mesh_key(policy._mesh)
            hit = down & frozenset(have)
            if hit:
                with self._lock:
                    self.shrinks += 1
                    self.events.append((now, "loss", tuple(sorted(hit))))
                raise DeviceLostError(hit, now)
            # A regrow is judged at the SERVICE-WIDE frontier, not this
            # session's clock: a replacement replays sim times from
            # before the window, and promoting on those "healthy past"
            # instants would march the pool back onto the dead shard.  A
            # loss above stays on ``now``: a dispatch before the window
            # is healthy and serves.
            down_front = self._down_at(frontier)
            key = self._survivor_key(down_front)
            if key != have and not (down_front & frozenset(have)):
                self._try_promote(policy, key, frontier)

        return _gate

    def _try_promote(self, policy, key: Tuple[int, ...], now: float) -> None:
        target = self._mesh_of(key)
        with self._lock:
            state = self._probe_state.get(key)
            # ``state`` is True, an int cooldown or None — test True
            # first (a bool is an int to isinstance).
            if state is not True and isinstance(state, int) and state > 0:
                self._probe_state[key] = state - 1
                return  # a failed probe cooling down (half-open cadence)
        if state is not True and self.config.probe:
            ok = self.shadow_probe(policy, target)
            with self._lock:
                self.probes += 1
                if not ok:
                    self.probe_failures += 1
                    self._probe_state[key] = int(self.config.probe_every)
                    self.events.append((now, "probe_failed", key))
                    return
                self._probe_state[key] = True
        policy.reshard(target)
        with self._lock:
            self.regrows += 1
            self.events.append((now, "regrow", key))
        self.logger.info(
            "elastic regrow: mesh promoted to %d shard(s) at t=%g",
            len(key), now,
        )

    # -- the shadow probe --------------------------------------------------
    def shadow_probe(self, policy, mesh) -> bool:
        """A seeded first-fit span on the CANDIDATE mesh, its placements
        compared bit for bit with the unsharded ``fused_tick_run`` of the
        same operands on the policy's device — the oracle the sharded
        parity tests hold every mesh shape to.  An exact match certifies
        the returning shard; a mismatch or a raise holds it out."""
        from pivot_tpu_torch.ops.shard import (
            mesh_device,
            sharded_fused_tick_run,
        )
        from pivot_tpu_torch.ops.tickloop import fused_tick_run
        from pivot_tpu_torch.parallel.mesh import host_axis_size

        cfg = self.config
        S = host_axis_size(mesh)
        topo = getattr(policy, "topology", None)
        H = topo.n_hosts if topo is not None else S * 4
        H = -(-H // S) * S  # a rung need not divide the cluster
        dtype = np.dtype(getattr(policy, "np_dtype", None)
                         or getattr(policy, "dtype", np.float64))
        rng = np.random.default_rng(cfg.seed)
        K, B = int(cfg.probe_ticks), int(cfg.probe_tasks)
        avail = rng.uniform(1.0, 4.0, size=(H, 4)).astype(dtype)
        demands = rng.uniform(0.1, 0.9, size=(B, 4)).astype(dtype)
        arrive = np.zeros(B, dtype=np.int32)
        kw = dict(policy="first-fit", n_ticks=K)
        try:
            dev = getattr(policy, "device", None) or mesh_device(mesh)
            ops = [torch.tensor(x, device=dev)
                   for x in (avail, demands, arrive)]
            want = fused_tick_run(*ops, K, **kw)
            got = sharded_fused_tick_run(mesh, *ops, K, **kw)
            return bool(torch.equal(want.placements.cpu(),
                                    got.placements.cpu()))
        except Exception as exc:  # noqa: BLE001 — a dead probe holds out
            self.logger.warning("elastic shadow probe raised: %s", exc)
            return False

    # -- reporting ---------------------------------------------------------
    def note_loss(self, exc, label: str = "?") -> None:
        """Log a classified device loss from the supervisor path (the
        gate recorded injected ones; real losses land here)."""
        ordinals = tuple(getattr(exc, "ordinals", ()))
        self.logger.error(
            "session %s lost device(s) %s — shrinking mesh",
            label, list(ordinals) or "?",
        )

    def describe(self) -> str:
        lines = [
            f"ladder: {list(self.ladder)}",
            f"shrinks: {self.shrinks}  regrows: {self.regrows}  "
            f"probes: {self.probes} ({self.probe_failures} failed)",
        ]
        if self.plan is not None:
            lines.extend(self.plan.describe())
        return "\n".join(lines)
