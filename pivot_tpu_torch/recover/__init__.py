"""Crash-safe serving: the recovery plane (``pivot_tpu_torch.recover``).

Resident-carry serving made the hot path device-persistent — and
thereby crash-naked: span state lives in device tensors that each span
consumes, with deliberately no host copy, so a process kill, a hung
dispatch, or one non-finite row loses the pool's state outright.  This package is
the opt-in recovery plane ``ServeDriver(recovery=RecoveryConfig(...))``
wires around that stack, three mechanisms plus a referee:

  * :mod:`~pivot_tpu_torch.recover.journal` — a write-ahead journal: every
    admission, flush, span splice, and MPC actuation appends a compact
    seeded record *before* it takes effect (fsync-batched; journal +
    world seeds replay the service deterministically).
  * :mod:`~pivot_tpu_torch.recover.snapshot` — amortized resident-carry
    snapshots: every N spans the pending device carry is cloned on the
    span boundary and written host-side by a background worker
    (double-buffered, checkpoint-fingerprinted, never blocking a
    dispatch).
  * :mod:`~pivot_tpu_torch.recover.watchdog` — a dispatch timeout with
    bounded deterministic-jitter retries behind a concurrent-retry cap,
    plus batch bisection that corners poisoned rows into a per-tenant,
    tier-aware penalty box.
  * the kill-and-resume referee (``tests/test_recovery.py``): a server
    killed mid-soak and resumed from snapshot + journal-tail replay
    must be **bit-identical** per tick to an uninterrupted run — and
    ``recovery=None`` stays bit-identical to the stack without it.

Module-scope imports need no torch: a pure-numpy serving stack can
construct the whole plane; only the resident snapshot hook touches
device tensors (a clone on the dispatch thread, one ``.cpu()`` of it
on the snapshot worker).  A port of ``pivot_tpu/recover/__init__.py``
(import paths rewritten): ``note_span`` clones with the port's
``resident_carry_clone`` and times the clone on the dispatch thread
(:attr:`RecoveryPlane.clone_ms`); ``_verify_resume`` reads the live
carry with ``.cpu()``.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

from pivot_tpu_torch.recover.journal import Journal, JournalError
from pivot_tpu_torch.recover.journal import replay_prefix_check
from pivot_tpu_torch.recover.snapshot import SnapshotStore, fingerprint_arrays
from pivot_tpu_torch.recover.watchdog import (
    DispatchFailed,
    DispatchTimeout,
    DispatchWatchdog,
    PenaltyBox,
)
from pivot_tpu_torch.sched.retry import RetryPolicy

__all__ = [
    "DispatchFailed",
    "DispatchTimeout",
    "DispatchWatchdog",
    "Journal",
    "JournalError",
    "PenaltyBox",
    "RecoveryConfig",
    "RecoveryPlane",
    "SnapshotStore",
    "fingerprint_arrays",
    "replay_prefix_check",
]


@dataclass(frozen=True)
class RecoveryConfig:
    """Knobs for one serve recovery plane.

    ``directory`` holds the journal (``journal.jsonl``) and the two
    snapshot buffers.  ``snapshot_every`` is the span cadence (0
    disables snapshots; the default 8 measured ≤5% serve throughput
    overhead — the ``serve_recovery`` bench row's gate).
    ``dispatch_timeout_s=None`` (default) keeps the watchdog's
    thread-per-dispatch machinery off the hot path — journal +
    snapshots only; set it to arm the timeout/retry/bisect guard.
    ``resume=True`` appends to an existing journal and loads the latest
    valid snapshot for fingerprint verification against the replayed
    state (the kill-and-resume referee's restore half).
    """

    directory: str
    snapshot_every: int = 8
    fsync_every: int = 32
    seed: int = 0
    resume: bool = False
    dispatch_timeout_s: Optional[float] = None
    retry: Optional[RetryPolicy] = None
    max_concurrent_retries: int = 2

    def __post_init__(self):
        if not self.directory:
            raise ValueError("RecoveryConfig.directory is required")
        if self.snapshot_every < 0:
            raise ValueError(
                f"snapshot_every must be >= 0, got {self.snapshot_every}"
            )
        if self.fsync_every < 1:
            raise ValueError(
                f"fsync_every must be >= 1, got {self.fsync_every}"
            )
        if (
            self.dispatch_timeout_s is not None
            and self.dispatch_timeout_s <= 0
        ):
            raise ValueError(
                "dispatch_timeout_s must be positive (or None), got "
                f"{self.dispatch_timeout_s}"
            )
        if self.max_concurrent_retries < 1:
            raise ValueError(
                "max_concurrent_retries must be >= 1, got "
                f"{self.max_concurrent_retries}"
            )


class RecoveryPlane:
    """One driver's recovery wiring: journal + snapshots + watchdog.

    Constructed by ``ServeDriver.__init__`` when ``recovery`` is not
    None; the journal opens immediately (admissions must be journalable
    before ``run()``), the snapshot worker starts/stops with the
    service.  All hooks are cheap no-ops along dimensions the config
    leaves off (no snapshots without a resident carry, no watchdog
    threads without a timeout).
    """

    def __init__(self, config: RecoveryConfig, tracer=None):
        if not isinstance(config, RecoveryConfig):
            raise TypeError(
                "ServeDriver(recovery=...) takes a RecoveryConfig, got "
                f"{type(config).__name__}"
            )
        self.config = config
        self.tracer = tracer
        os.makedirs(config.directory, exist_ok=True)
        self.journal = Journal(
            os.path.join(config.directory, "journal.jsonl"),
            seed=config.seed, fsync_every=config.fsync_every,
            resume=config.resume,
        )
        self.snapshots = SnapshotStore(
            config.directory, seed=config.seed,
        )
        self.watchdog = DispatchWatchdog(
            policy=config.retry, timeout_s=config.dispatch_timeout_s,
            max_concurrent_retries=config.max_concurrent_retries,
            seed=config.seed,
        )
        self._lock = threading.Lock()
        self._spans = 0
        self._splices = 0
        #: Host ms of each snapshot clone on the dispatch thread (the
        #: snapshot's whole hot-path cost: the clone is queued on the
        #: stream, nothing waits for it).
        self.clone_ms: list = []
        #: Resume verification (the referee's restore half): the latest
        #: valid snapshot of the KILLED run, fingerprint-checked against
        #: the replayed carry when the resumed run reaches the same span.
        self.restored = None
        self.resume_verified: Optional[bool] = None
        if config.resume:
            self.restored = self.snapshots.latest()
            if self.restored is not None:
                self.resume_verified = False  # pending until re-reached

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self.config.snapshot_every:
            self.snapshots.start()

    def stop(self) -> None:
        self.snapshots.stop()
        self.journal.close()

    # -- journal hooks (each BEFORE its effect) ----------------------------
    def journal_admit(self, arrival) -> None:
        self.journal.append(
            "admit", ts=arrival.ts,
            tier=int(getattr(arrival, "tier", 0)),
            tenant=getattr(arrival, "tenant", "default"),
            app=arrival.app.id,
        )

    def journal_flush(self, n_groups: int, n_reqs: int) -> None:
        self.journal.append(
            "flush", groups=int(n_groups), reqs=int(n_reqs),
        )

    def journal_span(self, label: str, sim: float, k: int,
                     slots: int) -> None:
        self.journal.append(
            "span", session=label, sim=float(sim), k=int(k),
            slots=int(slots),
        )

    def journal_splice(self, label: str, sim: float, k: int,
                       n_new: int) -> None:
        self.journal.append(
            "splice", session=label, sim=float(sim), k=int(k),
            n_new=int(n_new),
        )

    def journal_mpc(self, action: str, pool: int) -> None:
        self.journal.append("mpc", action=str(action), pool=int(pool))

    # -- snapshot hook (span boundary, post-dispatch) ----------------------
    def note_span(self, policy) -> None:
        """Span-cadence snapshot tap: called AFTER a span dispatch
        returns, i.e. inside the same safe window the resident
        mirror-diff reads in — the pending carry is the previous span's
        OUTPUT, not yet consumed by the next one.  The plane never keeps
        a reference to the carry itself, only to its clone.  The device-side
        clone is the only hot-path cost; D2H + fingerprint + write all
        happen on the snapshot worker."""
        every = self.config.snapshot_every
        with self._lock:
            self._spans += 1
            n = self._spans
        if not every or n % every:
            return
        rs = getattr(policy, "_resident", None)
        if rs is None or rs.carry is None:
            return
        from pivot_tpu_torch.ops.tickloop import resident_carry_clone

        t0 = time.perf_counter()
        clone = resident_carry_clone(rs.carry)
        self.clone_ms.append((time.perf_counter() - t0) * 1e3)
        payload = {
            "avail": clone.avail, "counts": clone.counts,
            "live": clone.live,
        }
        if rs.risk_table_np is not None:
            payload["risk"] = rs.risk_table_np
        meta = dict(
            span=n, policy_spans=int(rs.spans),
            splices=int(rs.splices), journal_seq=self.journal.appended,
        )
        self._verify_resume(payload, meta)
        self.snapshots.submit(payload, meta)
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.mark("recover", "snapshot", span=n)

    def _verify_resume(self, payload, meta) -> None:
        """Referee discipline on resume: when the replayed service
        reaches the span the killed run last snapshotted, the live
        carry must fingerprint bit-identically to the restored
        snapshot — proof the snapshot IS the replayed state (and could
        seed a kernel-level warm resume, ``resident_carry_restore``)."""
        if self.restored is None:
            return
        arrays, rmeta = self.restored
        if meta["span"] != rmeta.get("span"):
            return
        import numpy as np

        from pivot_tpu_torch.recover.snapshot import host_arrays

        live, _ = host_arrays(payload)
        # Re-fingerprint the LIVE state under the restored snapshot's
        # own submit-side meta: identical digests ⟺ bit-identical
        # arrays under the same config view (belt: the digest; braces:
        # the element-wise compare, which localizes a mismatch).
        submit_meta = {
            k: v for k, v in rmeta.items()
            if k not in ("fingerprint", "snapshot_seq")
        }
        self.resume_verified = bool(
            set(live) == set(arrays)
            and fingerprint_arrays(live, submit_meta)
            == rmeta.get("fingerprint")
            and all(np.array_equal(live[k], arrays[k]) for k in arrays)
        )

    def note_splice(self) -> None:
        with self._lock:
            self._splices += 1

    # -- metrics / reporting -----------------------------------------------
    def publish(self, registry) -> None:
        from pivot_tpu_torch.obs.registry import declare_recovery_metrics

        declare_recovery_metrics(registry)
        age = self.snapshots.age_s
        if age is not None:
            registry.set("pivot_recover_snapshot_age_s", age)
        registry.set("pivot_recover_journal_lag", self.journal.lag)
        registry.set(
            "pivot_recover_retries_total", self.watchdog.retries_total
        )
        counts = self.watchdog.penalty.counts()
        if counts:
            for tenant, n in counts.items():
                registry.set(
                    "pivot_recover_quarantined_rows", n, tenant=tenant
                )
        else:
            registry.set(
                "pivot_recover_quarantined_rows", 0, tenant="default"
            )

    def summary(self) -> dict:
        with self._lock:
            spans, splices = self._spans, self._splices
        return {
            "journal": {
                "path": self.journal.path,
                "records": self.journal.appended,
                "fsyncs": self.journal.fsyncs,
                "lag": self.journal.lag,
            },
            "snapshots": self.snapshots.summary(),
            "watchdog": self.watchdog.summary(),
            "spans_seen": spans,
            "splices_seen": splices,
            "resume": self.config.resume,
            "resume_verified": self.resume_verified,
        }
