"""Causal task tracing on dual clocks — the observability plane's spine.

Grown from the round-1 seed tracer (``pivot_tpu/utils/trace.py``, now a
compatibility shim over this module).  Three event families share one
append-only log:

  * **instants** (:meth:`Tracer.emit`) — a named point on the sim
    timeline (task finished, host quarantined, price-segment change);
  * **spans** (:meth:`Tracer.span` / :meth:`Tracer.wall_span`) — a
    wall-clock duration (one policy invocation, one batcher flush);
    ``span`` anchors on a sim instant, ``wall_span`` is sim-less (for
    dispatch-boundary work with no single sim time, e.g. a coalesced
    flush serving several sessions' ticks at once);
  * **causal stages** (:meth:`Tracer.stage`) — parent-linked events of
    one *trace* (a serve job's life): every stage records the previous
    stage of its trace as ``parent``, so the full
    arrival → admission/queue/spill → routing → injection → placement
    → completion chain is reconstructable by walking parent links
    (``tools/obs_report.py`` and ``tests/test_obs.py`` do exactly
    that).

Every event carries BOTH clocks where both exist: ``sim`` (discrete-
event virtual seconds — *what the simulated system did*) and ``wall``
(host seconds since tracer creation — *what the framework paid to
compute it*).

**Hot-path contract** (the tentpole's third pillar):

  * zero-cost when disabled — every recording method short-circuits on
    ``self.enabled`` before touching a clock, a lock, or a dict;
  * the wall capture lives HERE, inside ``pivot_tpu/obs`` — hooks in
    the determinism-scoped modules (``des/``, ``sched/``, ``ops/``,
    the fault/market engines) pass sim-time payloads only, and the
    graftcheck ``obs-boundary`` pass pins that they never read a wall
    clock or import this package's clock;
  * no instrumentation inside jitted/Pallas bodies — events are emitted
    at dispatch *boundaries* only; the ``obs-boundary`` pass reuses the
    host-sync discovery to flag a tracer hook inside a fused hot body.

Thread safety: the serve layer records from ServeDriver, session, and
autoscaler threads concurrently; the log append + id allocation run
under one lock.  Recording never blocks on I/O — serialization
(:meth:`save_jsonl` / :meth:`save_chrome` / :meth:`save_perfetto`) is
explicit and post-hoc.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Any, Dict, List, Optional

from pivot_tpu_torch.obs.clock import ObsClock

__all__ = ["Tracer", "NULL_TRACER", "TERMINAL_STAGES"]

#: Stage names that end a job's causal chain — used by the Perfetto
#: exporter (async-span close) and the report/check walkers.  Exactly
#: one of these must terminate every admitted job's trace.
TERMINAL_STAGES = frozenset(
    {"completed", "failed", "shed", "dead_letter"}
)


class _Span:
    """Hand-rolled span context manager — the per-tick hot hook.

    A ``@contextlib.contextmanager`` generator costs ~2× this class per
    entry (generator frame + throw/close protocol); the tick loop opens
    one span per scheduler tick, so the entry cost IS the tracer-on
    overhead the ``obs_overhead`` bench row gates.  ``sim=None`` makes
    it the sim-less ``wall_span`` variant.
    """

    __slots__ = ("_tracer", "_cat", "_name", "_sim", "_args", "_t0")

    def __init__(self, tracer: "Tracer", cat: str, name: str,
                 sim: Optional[float], args: Dict[str, Any]):
        self._tracer = tracer
        self._cat = cat
        self._name = name
        self._sim = sim
        self._args = args
        self._t0: Optional[float] = None

    def __enter__(self) -> Dict[str, Any]:
        if self._tracer.enabled:
            self._t0 = time.perf_counter()
        return self._args

    def __exit__(self, exc_type, exc, tb) -> bool:
        tr = self._tracer
        t0 = self._t0
        if not tr.enabled or t0 is None:
            return False
        evt: Dict[str, Any] = {
            "cat": self._cat,
            "name": self._name,
            "wall": t0 - tr._wall0,
            "dur": time.perf_counter() - t0,
        }
        if self._sim is not None:
            evt["sim"] = self._sim
        if self._args:
            evt["args"] = self._args
        with tr._lock:
            tr.events.append(evt)
        return False


class Tracer:
    """Append-only structured event log with sim + wall timestamps."""

    __slots__ = (
        "enabled", "events", "clock", "_wall0", "_lock", "_seq",
        "_trace_seq", "_trace_tail",
    )

    def __init__(self, enabled: bool = True,
                 clock: Optional[ObsClock] = None):
        self.enabled = enabled
        self.events: List[Dict[str, Any]] = []
        #: The injected obs clock — the EPOCH the meters share; inside
        #: this module the hot paths read ``time.perf_counter()``
        #: directly (``ObsClock.now`` is a passthrough; the indirection
        #: costs ~1µs/event, which the obs_overhead gate charges).
        self.clock = clock or ObsClock()
        self._wall0 = time.perf_counter()
        self._lock = threading.Lock()
        self._seq = 0  # stage event ids (parent-link targets)
        self._trace_seq = 0  # trace ids (admission order)
        #: trace id -> event id of its most recent stage (parent links).
        self._trace_tail: Dict[int, int] = {}

    # -- recording -------------------------------------------------------
    # Only causal *stages* carry event ids (they are what parent links
    # point at); instants and spans append id-free — per-event id
    # bookkeeping on the tick hot path would be pure overhead.

    def emit(self, cat: str, name: str, sim: float, **args: Any) -> None:
        """Record an instant event at sim time ``sim``."""
        if not self.enabled:
            return
        evt: Dict[str, Any] = {
            "cat": cat,
            "name": name,
            "sim": sim,
            "wall": time.perf_counter() - self._wall0,
        }
        if args:
            evt["args"] = args
        with self._lock:
            self.events.append(evt)

    def span(self, cat: str, name: str, sim: float, **args: Any) -> _Span:
        """Record a wall-clock duration span (e.g. one policy invocation).

        The span's ``dur`` is *wall* seconds — sim time does not advance
        inside a synchronous block.  Mutations to ``args`` made inside the
        block (e.g. recording the number of placed tasks once known) are
        captured because the dict is attached at exit.
        """
        return _Span(self, cat, name, sim, args)

    def record_span(self, cat: str, name: str, dur: float,
                    sim: Optional[float] = None, **args: Any) -> None:
        """Record an already-measured wall duration (the caller timed
        the work itself, e.g. the serve decision tap) as a span ending
        now — so dispatch latencies land on the timeline without the
        tracer owning the measurement."""
        if not self.enabled:
            return
        end = time.perf_counter() - self._wall0
        evt: Dict[str, Any] = {
            "cat": cat,
            "name": name,
            "wall": max(end - dur, 0.0),
            "dur": dur,
        }
        if sim is not None:
            evt["sim"] = sim
        if args:
            evt["args"] = args
        with self._lock:
            self.events.append(evt)

    def mark(self, cat: str, name: str, **args: Any) -> None:
        """A wall-only instant — framework events with no sim anchor
        (a recompile observed mid-dispatch, a watchdog action)."""
        if not self.enabled:
            return
        evt: Dict[str, Any] = {
            "cat": cat,
            "name": name,
            "wall": time.perf_counter() - self._wall0,
        }
        if args:
            evt["args"] = args
        with self._lock:
            self.events.append(evt)

    def wall_span(self, cat: str, name: str, **args: Any) -> _Span:
        """A sim-less measurement span for dispatch boundaries.

        A coalesced batcher flush serves several sessions' ticks — it
        has no single sim instant, only a wall duration.  Call sites in
        determinism-scoped modules use THIS instead of reading
        ``time.perf_counter()`` themselves: the wall capture stays
        inside ``obs/`` (the determinism boundary the ``obs-boundary``
        pass pins)."""
        return _Span(self, cat, name, None, args)

    # -- causal task tracing ---------------------------------------------
    def new_trace(self) -> int:
        """Allocate a trace id (one per serve job, in admission order —
        deterministic under ServeDriver's serialized admission)."""
        with self._lock:
            tid = self._trace_seq
            self._trace_seq += 1
            return tid

    def stage(self, trace: int, name: str, sim: Optional[float] = None,
              cat: str = "job", **args: Any) -> Optional[int]:
        """One parent-linked stage of a job's causal chain.

        The event records the trace's previous stage as ``parent``;
        walking parents from a terminal stage reconstructs the full
        arrival→completion chain.  ``sim`` is optional — wall-domain
        stages (routing decisions made between sim instants) carry the
        wall clock only.  Returns the event id (None when disabled).
        """
        if not self.enabled:
            return None
        evt: Dict[str, Any] = {
            "cat": cat,
            "name": name,
            "wall": time.perf_counter() - self._wall0,
            "trace": trace,
        }
        if sim is not None:
            evt["sim"] = sim
        if args:
            evt["args"] = args
        with self._lock:
            eid = self._seq
            self._seq += 1
            evt["id"] = eid
            parent = self._trace_tail.get(trace)
            if parent is not None:
                evt["parent"] = parent
            self._trace_tail[trace] = eid
            self.events.append(evt)
            return eid

    # -- serialization ---------------------------------------------------
    def save_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for evt in self.events:
                f.write(json.dumps(evt) + "\n")

    def _ts(self, evt: Dict[str, Any], timeline: str) -> float:
        """Event's position on the chosen timeline, in µs.  Wall-only
        events (sim-less spans/stages) fall back to the wall clock on
        the sim timeline — they are framework work, not sim events, but
        dropping them would hide dispatch costs from the default view."""
        if timeline == "sim" and "sim" in evt:
            return evt["sim"] * 1e6
        return evt["wall"] * 1e6

    def _record(self, evt: Dict[str, Any], timeline: str,
                rich: bool) -> Dict[str, Any]:
        """One ``trace_event`` record for an event — the single record
        shape both exporters share (two hand-maintained copies would
        drift).  ``rich`` hoists the causal fields (``id``/``trace``/
        ``parent``) and the sim anchor into args for the Perfetto
        artifact obs_report walks."""
        rec: Dict[str, Any] = {
            "name": evt["name"],
            "cat": evt["cat"],
            "pid": 0,
            "tid": evt["cat"],
            "ts": self._ts(evt, timeline),
        }
        if "dur" in evt:
            rec["ph"] = "X"
            rec["dur"] = max(evt["dur"] * 1e6, 1.0)
        else:
            rec["ph"] = "i"
            rec["s"] = "t"
        if rich:
            args = dict(evt.get("args", ()))
            for key in ("id", "trace", "parent"):
                if key in evt:
                    args[key] = evt[key]
            if "sim" in evt:
                args["sim"] = evt["sim"]
            if args:
                rec["args"] = args
        elif "args" in evt:
            rec["args"] = evt["args"]
        return rec

    def save_chrome(self, path: str, timeline: str = "sim") -> None:
        """Write a Chrome/Perfetto trace (``chrome://tracing`` loadable).

        ``timeline='sim'`` places events at their simulated time (µs = sim
        seconds × 1e6, so 1 simulated second reads as 1 s in the viewer);
        ``timeline='wall'`` places them at host time — use this to inspect
        where the framework itself spends wall clock (policy spans carry
        real durations on either timeline).
        """
        assert timeline in ("sim", "wall")
        out = [self._record(evt, timeline, rich=False)
               for evt in self.events]
        with open(path, "w") as f:
            json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f)

    def save_perfetto(self, path: str, timeline: str = "sim") -> None:
        """Write the full observability timeline as Perfetto/Chrome
        ``trace_event`` JSON: one lane (``tid``) per category, causal
        stages carrying ``trace``/``parent``/``id`` in their args, and
        one *async span* per job trace (``ph: b``/``e`` keyed by trace
        id) stretching from its first stage to its last — so a job's
        whole life reads as one bar with its stages nested under it.
        Events are sorted by timestamp (``tools/obs_report.py --check``
        verifies monotonicity per lane).
        """
        assert timeline in ("sim", "wall")
        out: List[Dict[str, Any]] = []
        first_last: Dict[int, List[Dict[str, Any]]] = {}
        for evt in self.events:
            rec = self._record(evt, timeline, rich=True)
            out.append(rec)
            trace = evt.get("trace")
            if trace is not None:
                span = first_last.setdefault(trace, [rec, rec])
                span[1] = rec
        for trace, (first, last) in sorted(first_last.items()):
            base = {
                "cat": "job",
                "pid": 0,
                "tid": "jobs",
                "id": str(trace),
                "name": f"job-{trace}",
            }
            out.append(dict(base, ph="b", ts=first["ts"]))
            out.append(dict(base, ph="e", ts=max(last["ts"], first["ts"])))
        out.sort(key=lambda r: r["ts"])
        with open(path, "w") as f:
            json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f)

    # -- analysis helpers ------------------------------------------------
    def by_category(self, cat: str) -> List[Dict[str, Any]]:
        return [e for e in self.events if e["cat"] == cat]

    def by_trace(self, trace: int) -> List[Dict[str, Any]]:
        """The causal chain of one trace, in append (stage) order."""
        return [e for e in self.events if e.get("trace") == trace]

    def traces(self) -> List[int]:
        """Every trace id that recorded at least one stage, sorted."""
        return sorted({
            e["trace"] for e in self.events if "trace" in e
        })

    def total_dur(self, cat: str, name: Optional[str] = None) -> float:
        """Σ wall-clock duration of matching spans (e.g. total policy time)."""
        return sum(
            e.get("dur", 0.0)
            for e in self.events
            if e["cat"] == cat and (name is None or e["name"] == name)
        )


NULL_TRACER = Tracer(enabled=False)
