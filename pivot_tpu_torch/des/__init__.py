"""A minimal, deterministic discrete-event simulation kernel.

This replaces SimPy (which the reference builds on — ``requirements.txt:2``)
with a purpose-built core designed for this framework:

  * **Deterministic total order**: every scheduled event carries a
    ``(time, priority, seq)`` key; ``seq`` is a monotonically increasing
    counter, so simulations are bit-reproducible run-to-run.
  * **Hookable dispatch points**: processes are plain Python generators that
    yield ``Event`` objects; the scheduler tick is just another process, so
    the TPU decision backend can be invoked synchronously at tick boundaries
    without leaving the event loop.
  * **Passive services**: components like network routes do not need a
    dedicated generator process each (the reference spawns one SimPy process
    per route — ~16k at 100 hosts, ``resources/network.py:56``); they can
    schedule bare callbacks instead, which is how
    ``pivot_tpu_torch.infra.network.Route`` implements chunked fair sharing.

Public surface: ``Environment``, ``Event``, ``Timeout``, ``Process``,
``Store`` (FIFO queue with blocking get), ``Callback`` (bare passive-service
heap entry), and ``Interrupt``-free cooperative semantics (the reference
never interrupts processes either).
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, Generator, Iterable, Optional

__all__ = ["Environment", "Event", "Timeout", "Process", "Store", "Callback", "SimError"]


class SimError(Exception):
    """Raised for invalid kernel usage (double trigger, yield of non-event)."""


#: Priority bands — lower runs first at equal timestamps.  URGENT is used for
#: store hand-offs so a put at time t is visible to a getter woken at t.
URGENT, NORMAL = 0, 1


class Event:
    """A one-shot occurrence; callbacks fire when the event is processed."""

    __slots__ = ("env", "callbacks", "_value", "_staged", "_scheduled", "_ok")

    _PENDING = object()

    def __init__(self, env: "Environment"):
        self.env = env
        self.callbacks: Optional[list] = []
        self._value: Any = Event._PENDING
        # Value applied when the event is processed (used by Timeout,
        # which is "triggered" only once it fires).
        self._staged: Any = Event._PENDING
        self._scheduled = False
        self._ok = True

    @property
    def triggered(self) -> bool:
        return self._value is not Event._PENDING

    @property
    def processed(self) -> bool:
        return self.callbacks is None

    @property
    def value(self) -> Any:
        if self._value is Event._PENDING:
            raise SimError("event value not yet available")
        return self._value

    def succeed(self, value: Any = None, priority: int = NORMAL) -> "Event":
        if self.triggered:
            raise SimError("event already triggered")
        self._value = value
        self.env._schedule(self, priority)
        return self

    def fail(self, exc: BaseException, priority: int = NORMAL) -> "Event":
        if self.triggered:
            raise SimError("event already triggered")
        self._ok = False
        self._value = exc
        self.env._schedule(self, priority)
        return self


class Timeout(Event):
    """An event that fires ``delay`` sim-seconds after creation."""

    __slots__ = ()

    def __init__(self, env: "Environment", delay: float, value: Any = None):
        if delay < 0:
            raise SimError(f"negative delay {delay}")
        super().__init__(env)
        self._staged = value
        env._schedule(self, NORMAL, delay)


class Process(Event):
    """Runs a generator; each yielded Event suspends it until that event fires.

    The Process is itself an Event that succeeds with the generator's return
    value, so processes can wait on each other.
    """

    __slots__ = ("_gen",)

    def __init__(self, env: "Environment", gen: Generator):
        super().__init__(env)
        self._gen = gen
        # Bootstrap: start executing at the current time, after already
        # scheduled events at this instant (matches cooperative semantics).
        init = Event(env)
        init.callbacks.append(self._resume)
        init.succeed()

    def _resume(self, trigger: Event) -> None:
        if not trigger._ok:
            try:
                target = self._gen.throw(trigger._value)
            except StopIteration as stop:
                self._conclude(stop.value)
                return
        else:
            try:
                target = self._gen.send(trigger._value if trigger is not None else None)
            except StopIteration as stop:
                self._conclude(stop.value)
                return
        if not isinstance(target, Event):
            raise SimError(f"process yielded non-event: {target!r}")
        if target.callbacks is None:  # already processed -> resume immediately
            immediate = Event(self.env)
            immediate.callbacks.append(self._resume)
            immediate._value = target._value
            immediate._ok = target._ok
            self.env._schedule(immediate, URGENT)
        else:
            target.callbacks.append(self._resume)

    def _conclude(self, value: Any) -> None:
        self._value = value
        self.env._schedule(self, NORMAL)


class Callback:
    """Lightweight heap entry: a bare function fired at its instant.

    The passive-service primitive behind ``schedule_callback`` — no Event
    allocation, no callbacks list, no staged value.  On the hottest paths
    (route chunk service, executor compute timers: hundreds of thousands
    per run) this halves per-event kernel overhead.  Not awaitable: a
    process cannot yield one (``Process._resume`` rejects it), which is
    exactly the contract — passive services never have waiters.

    ``owner`` is an optional tag a scheduler component may attach to
    recognize its own entries during a heap scan (the pure-tick-run
    extractor classifies local-pump callbacks by it, ``scan_window``).
    :meth:`cancel` disarms the entry in place — popping from the middle
    of a heap is O(n), so cancelled entries stay queued and ``step``
    skips them.  The fast-forward sleep uses this to move its wake when
    a submission lands mid-window (``GlobalScheduler
    ._reschedule_ff_wake``).  Note that folded pump deliveries are NOT
    cancelled — a fused span leaves them armed and firing (their epoch
    bumps are expected by the replay), which is what keeps event
    ordering identical to sequential execution.
    """

    __slots__ = ("fn", "owner")

    def __init__(self, fn: Callable[[], None], owner: Any = None):
        self.fn = fn
        self.owner = owner

    def cancel(self) -> None:
        self.fn = None

    @property
    def cancelled(self) -> bool:
        return self.fn is None


class StoreGet(Event):
    __slots__ = ()


class Store:
    """Unbounded FIFO queue with blocking ``get`` and immediate ``put``.

    Mirrors the two-queue plugin boundary of the reference (``dispatch_q`` /
    ``notify_q``, ``resources/__init__.py:40``): puts never block; gets yield
    until an item is available.  Hand-offs are scheduled URGENT so an item
    put at time t is consumed at time t ahead of NORMAL events.
    """

    __slots__ = ("env", "items", "_getters")

    def __init__(self, env: "Environment"):
        self.env = env
        self.items: list = []
        self._getters: list = []

    def __len__(self) -> int:
        return len(self.items)

    def put(self, item: Any) -> None:
        """Enqueue an item; never blocks (the store is unbounded).

        Unlike SimPy there is no put-event to wait on — an unbounded FIFO
        cannot reject a put, so producers just call this and move on.  This
        removes one heap round-trip per message on the hottest queues.
        """
        self.items.append(item)
        self._dispatch()

    def get(self) -> StoreGet:
        evt = StoreGet(self.env)
        self._getters.append(evt)
        self._dispatch()
        return evt

    def drain(self) -> list:
        """Synchronously take every queued item (no events).

        Valid only from the consuming side at a dispatch point; equivalent
        to get-ing ``len(items)`` times in a row at one instant.
        """
        items, self.items = self.items, []
        return items

    def _dispatch(self) -> None:
        while self.items and self._getters:
            getter = self._getters.pop(0)
            getter.succeed(self.items.pop(0), priority=URGENT)


class Environment:
    """The event loop: a heap of ``(time, priority, seq, event)`` entries."""

    def __init__(self, initial_time: float = 0.0):
        self._now = float(initial_time)
        self._heap: list = []
        self._seq = 0
        self._observers: list = []

    @property
    def now(self) -> float:
        return self._now

    # -- scheduling ------------------------------------------------------
    def _schedule(
        self,
        event: Event,
        priority: int = NORMAL,
        delay: float = 0.0,
        at: Optional[float] = None,
    ) -> None:
        if event._scheduled:
            raise SimError("event already scheduled")
        event._scheduled = True
        when = self._now + delay if at is None else at
        heapq.heappush(self._heap, (when, priority, self._seq, event))
        self._seq += 1

    def schedule_callback(
        self, delay: float, fn: Callable[[], None], priority: int = NORMAL
    ) -> Callback:
        """Run ``fn()`` after ``delay`` — the passive-service primitive."""
        if delay < 0:
            raise SimError(f"negative delay {delay}")
        cb = Callback(fn)
        heapq.heappush(self._heap, (self._now + delay, priority, self._seq, cb))
        self._seq += 1
        return cb

    def schedule_callback_at(
        self, at: float, fn: Callable[[], None], priority: int = NORMAL
    ) -> Callback:
        """Run ``fn()`` at absolute sim time ``at`` (must be >= now).

        Unlike ``schedule_callback(at - now, ...)`` this avoids the
        relative-delay round-trip ``fl(now + fl(at - now))``, which can land
        one ulp past ``at`` — co-simulators (``pivot_tpu_torch.native``) need
        their wake to fire at *exactly* the completion instant.
        """
        if at < self._now:
            raise SimError(f"cannot schedule at {at} < now {self._now}")
        cb = Callback(fn)
        heapq.heappush(self._heap, (at, priority, self._seq, cb))
        self._seq += 1
        return cb

    # -- public factory methods -----------------------------------------
    def process(self, gen: Generator) -> Process:
        return Process(self, gen)

    def timeout(self, delay: float, value: Any = None) -> Timeout:
        return Timeout(self, delay, value)

    def event(self) -> Event:
        return Event(self)

    def store(self) -> Store:
        return Store(self)

    def all_of(self, events: Iterable[Event]) -> Event:
        """Barrier: succeeds once every event in ``events`` has fired."""
        events = list(events)
        barrier = Event(self)
        remaining = [len(events)]
        if remaining[0] == 0:
            barrier.succeed()
            return barrier

        def _arm(evt: Event) -> None:
            def _on_fire(_e: Event) -> None:
                remaining[0] -= 1
                if remaining[0] == 0:
                    barrier.succeed([e._value for e in events])

            if evt.callbacks is None:
                remaining[0] -= 1
                if remaining[0] == 0:
                    barrier.succeed([e._value for e in events])
            else:
                evt.callbacks.append(_on_fire)

        for e in events:
            _arm(e)
        return barrier

    def any_of(self, events: Iterable[Event]) -> Event:
        """Race: succeeds when the FIRST of ``events`` fires, with that
        event as its value.  Later finishers are ignored (their own
        callbacks still run).  The primitive behind abortable waits —
        e.g. compute racing a host-failure abort
        (``pivot_tpu_torch.infra.faults``)."""
        events = list(events)
        race = Event(self)
        if not events:
            raise SimError("any_of of no events")

        def _settle(fired: Event) -> None:
            if race.triggered:
                return
            if fired._ok:
                race.succeed(fired)
            else:  # propagate the loser-less failure, don't swallow it
                race.fail(fired._value)

        def _arm(evt: Event) -> None:
            if evt.callbacks is None:  # already processed
                _settle(evt)
            else:
                evt.callbacks.append(_settle)

        for e in events:
            _arm(e)
        return race

    # -- execution -------------------------------------------------------
    def add_step_observer(self, fn: Callable[[], None]) -> None:
        """Register ``fn`` to run after every processed event (the
        hookable-dispatch-point design goal): zero heap traffic, never
        advances sim time, sees state only at event boundaries — which is
        where state can change.  Used by the invariant auditor."""
        self._observers.append(fn)

    def step(self) -> None:
        t, _prio, _seq, event = heapq.heappop(self._heap)
        self._now = t
        if type(event) is Callback:
            if event.fn is not None:  # cancelled entries are inert
                event.fn()
        else:
            if event._value is Event._PENDING:
                event._value = (
                    event._staged if event._staged is not Event._PENDING else None
                )
            callbacks, event.callbacks = event.callbacks, None
            for cb in callbacks:
                cb(event)
        if self._observers:
            for ob in self._observers:
                ob()

    def run(self, until: Optional[float] = None) -> None:
        """Run to event exhaustion, or until sim time reaches ``until``."""
        if until is not None:
            limit = float(until)
            while self._heap and self._heap[0][0] <= limit:
                self.step()
            # Sim time always lands exactly on the limit (SimPy-compatible),
            # regardless of whether later events remain.
            self._now = max(self._now, limit)
        else:
            while self._heap:
                self.step()

    def peek(self) -> float:
        """Timestamp of the next scheduled event, or +inf if none."""
        return self._heap[0][0] if self._heap else float("inf")

    def scan_window(self, exclude=(), allow=None):
        """Classify the pending heap for pure-tick-run extraction.

        Returns ``(t_foreign, allowed)`` where ``t_foreign`` is the
        earliest scheduled instant of any entry that is neither in
        ``exclude`` (identity membership) nor approved by the ``allow``
        predicate, or ``+inf`` when no such entry exists; ``allowed`` is
        every approved entry scheduled STRICTLY before ``t_foreign``, as
        ``(time, priority, seq, event)`` tuples in firing order.  An
        approved entry at or after the first foreign instant is dropped
        from ``allowed`` — its firing order against the foreign event is
        the heap's business, not the caller's.

        Cancelled callbacks are invisible (they fire as no-ops).  One
        O(heap) pass, no mutation — the caller decides what to do with
        the window (``GlobalScheduler`` fuses scheduling ticks across
        it).
        """
        t_foreign = float("inf")
        allowed: list = []
        for t, prio, seq, ev in self._heap:
            if type(ev) is Callback and ev.fn is None:
                continue
            if any(ev is x for x in exclude):
                continue
            if allow is not None and allow(ev):
                allowed.append((t, prio, seq, ev))
                continue
            if t < t_foreign:
                t_foreign = t
        allowed = [e for e in allowed if e[0] < t_foreign]
        allowed.sort(key=lambda e: (e[0], e[1], e[2]))
        return t_foreign, allowed
