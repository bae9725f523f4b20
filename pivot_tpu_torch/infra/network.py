"""Simulated network fabric: per-route chunked fair-share packet service.

Behavioral parity with the reference's ``NetworkRoute``/``Packet``
(``resources/network.py:10-103``):

  * A transfer is served one ``CHUNK_MB``-sized chunk at a time at
    ``chunk / bw`` sim-seconds per chunk; an unfinished transfer re-enters
    the tail of the queue after each chunk, so concurrent transfers share
    the route round-robin and **congestion emerges** from queueing.
  * ``realtime_bw`` estimates effective bandwidth as ``bw / (queued_mb + 1)``
    (ref ``resources/network.py:70-73``).

Redesign (the reference spawns one SimPy generator process per route —
~360k processes for a 600-host all-pairs fabric): a ``Route`` here is a
**passive service**: it keeps a deque and schedules bare completion
callbacks on the event kernel only while transfers are in flight.  Routes
are also created lazily by the cluster, so an idle pair costs nothing.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

from pivot_tpu_torch.des import Environment, Event
from pivot_tpu_torch.utils import LogMixin

__all__ = ["Route", "NativeRoute", "Transfer", "CHUNK_MB"]

#: Chunk granularity in MB (ref ``Packet.PACKET_SIZE``, network.py:12).
CHUNK_MB = 1000.0


class Transfer:
    """An in-flight data transfer on one route."""

    __slots__ = ("remaining_mb", "done", "cancelled")

    def __init__(self, size_mb: float, done: Event):
        if size_mb <= 0:
            raise ValueError(f"transfer size must be > 0, got {size_mb}")
        self.remaining_mb = float(size_mb)
        self.done = done
        self.cancelled = False


class Route(LogMixin):
    """A directed (src, dst) link with FIFO round-robin chunk service."""

    __slots__ = (
        "env", "src", "dst", "bw", "meter", "_queue", "_busy",
        "_in_service", "_suspended",
    )

    def __init__(self, env: Environment, src, dst, bw: float, meter=None):
        self.env = env
        self.src = src
        self.dst = dst
        self.bw = float(bw)
        self.meter = meter
        self._queue: deque = deque()
        self._busy = False
        self._in_service: Optional[Transfer] = None
        # Network-partition state (``infra.faults.partition_regions``):
        # a suspended route parks its queue — the chunk already on the
        # wire finishes, nothing further is served until resume().
        self._suspended = False

    @property
    def queued_mb(self) -> float:
        """MB waiting in queue (excludes the chunk currently in service)."""
        return sum(t.remaining_mb for t in self._queue)

    @property
    def realtime_bw(self) -> float:
        """Congestion-discounted bandwidth estimate (ref network.py:70-73)."""
        return self.bw / (self.queued_mb + 1.0)

    def send(self, size_mb: float, done: Optional[Event] = None) -> Event:
        """Enqueue a transfer; returns the completion event."""
        if done is None:
            done = self.env.event()
        self._queue.append(Transfer(size_mb, done))
        if not self._busy:
            self._serve_next()
        return done

    def cancel(self, done: Event) -> None:
        """Drop the queued transfer whose completion event is ``done``.

        Used when a consumer dies mid-staging (host crash,
        ``pivot_tpu_torch.infra.faults``): without cancellation the orphaned
        transfer would keep round-robin-stealing bandwidth from live
        transfers until served to completion.  The chunk currently in
        service (if any) finishes — data already on the wire — but nothing
        further is served and ``done`` never fires."""
        # Eager removal keeps queued_mb / realtime_bw exact immediately —
        # a lazily flagged dead transfer would inflate congestion estimates
        # (and steer bandwidth-aware placement) until it rotated to the
        # queue front.
        survivors = [t for t in self._queue if t.done is not done]
        if len(survivors) != len(self._queue):
            self._queue = deque(survivors)
        # The in-service transfer is not in the queue; its current chunk
        # (data already on the wire) finishes, then it is dropped.
        if self._in_service is not None and self._in_service.done is done:
            self._in_service.cancelled = True

    def suspend(self) -> None:
        """Partition this link: the in-service chunk (data already on the
        wire) completes, then service parks.  Queued transfers are kept,
        not dropped — a partition delays, a crash cancels."""
        self._suspended = True

    def resume(self) -> None:
        """Heal the partition; parked transfers resume round-robin."""
        if not self._suspended:
            return
        self._suspended = False
        if not self._busy and self._queue:
            self._serve_next()

    @property
    def suspended(self) -> bool:
        return self._suspended

    def _serve_next(self) -> None:
        if self._suspended or not self._queue:
            self._busy = False
            self._in_service = None
            return
        self._busy = True
        transfer = self._queue.popleft()
        self._in_service = transfer
        chunk = min(transfer.remaining_mb, CHUNK_MB)
        if self.meter:
            self.meter.route_check_in(self, transfer)
        service_time = chunk / self.bw if self.bw > 0 else 0.0
        self.env.schedule_callback(
            service_time, lambda: self._finish_chunk(transfer, chunk)
        )

    def _finish_chunk(self, transfer: Transfer, chunk: float) -> None:
        if self.meter:
            self.meter.route_check_out(self, transfer, chunk)
        transfer.remaining_mb -= chunk
        if transfer.cancelled:
            pass  # dropped: no completion, no re-enqueue
        elif transfer.remaining_mb <= 0:
            transfer.done.succeed()
        else:
            self._queue.append(transfer)  # round-robin fairness
        self._serve_next()

    def __repr__(self) -> str:
        return f"Route({self.src.id} -> {self.dst.id} @ {self.bw:.0f} Mbps)"


class NativeRoute(Route):
    """Route facade over the C++ co-simulator (``pivot_tpu_torch.native``).

    Same queueing semantics and bit-identical completion times (the engine
    uses the same double arithmetic, ``start + chunk/bw``); the chunk
    service loop lives in native code, so a transfer costs the Python event
    kernel one wake callback instead of one event per chunk.  Per-slot
    meter logs are replaced by engine-accumulated per-route stats that the
    meter reads at summary time (``Meter.add_native_source``).
    """

    __slots__ = ("engine", "index")

    def __init__(self, env, src, dst, bw: float, engine, meter=None):
        super().__init__(env, src, dst, bw, meter)
        self.engine = engine
        self.index = engine.add_route(self.bw, self)

    @property
    def queued_mb(self) -> float:
        return self.engine.queued_mb(self.index)

    def suspend(self) -> None:
        raise NotImplementedError(
            "network partitions require network_backend='python' "
            "(native routes serve their queue inside the C++ engine)"
        )

    resume = suspend

    def send(self, size_mb: float, done: Optional[Event] = None) -> Event:
        if size_mb <= 0:
            raise ValueError(f"transfer size must be > 0, got {size_mb}")
        if done is None:
            done = self.env.event()
        self.engine.send(self.index, size_mb, done)
        return done

    def cancel(self, done: Event) -> None:
        """Drop the queued transfer whose completion event is ``done``.

        Same semantics as :meth:`Route.cancel`: a waiting transfer leaves
        the queue eagerly (``queued_mb`` stays exact), the in-service
        chunk — data already on the wire — finishes and the transfer is
        then dropped, and ``done`` never fires.  The queue surgery happens
        inside the engine (``net_cancel``)."""
        self.engine.cancel(done)
