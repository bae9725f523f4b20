"""Dispatch watchdog: timeout, bounded seeded retry, bisect, quarantine.

A device dispatch on the serving hot path can fail three ways the DES
fault machinery (``infra/faults.py`` — *simulated* host kills) never
models: it can hang (a wedged runtime), it can raise (a poisoned
program or transient backend error), or it can *succeed with garbage*
(one non-finite row silently corrupting every decision built on it).
This module is the serve recovery plane's answer to all three:

  * :meth:`DispatchWatchdog.guard` runs one dispatch under a wall-clock
    timeout with bounded retries.  Backoff delays come from
    ``sched/retry.py::RetryPolicy.backoff`` — jitter is a pure hash of
    ``(seed, key, attempt)``, so a journaled replay backs off
    identically — and every retry must win a slot from a shared
    :class:`~pivot_tpu_torch.sched.retry.RetryGate` first: total retry
    concurrency is CAPPED, and a dispatch that cannot get a slot sheds
    instead of piling onto a degraded device (the metastable-failure
    guard).
  * :meth:`DispatchWatchdog.run_batch` isolates poison: when a batch
    fails (or validates non-finite) it is bisected — halves, quarters,
    singletons — until the failing rows are cornered; those rows go to
    a per-tenant, tier-aware :class:`PenaltyBox` and the surviving rows
    are re-served, so one poisoned tenant row costs its own slot, never
    the pool's (tier 0 is shed last, mirroring the admission queue's
    priority contract).

Timeout mechanics: the guarded callable runs on a daemon worker
thread; on timeout the watchdog abandons the thread (Python threads
cannot be killed — the same abandonment contract the serve driver's
stall supervisor already documents) and counts/raises.  A truly wedged
dispatch therefore leaks one parked thread, which dies with the
process — the price of keeping the flush loop alive.

Finiteness validation is the caller's ``finite_of`` callback over
whatever result type its dispatch returns; a tensor verdict is read to
the host with one ``.cpu()``.  A port of ``pivot_tpu/recover/watchdog.py``
(import paths rewritten; the verdict's host read, ``:305``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from pivot_tpu_torch.sched.retry import RetryGate, RetryPolicy

__all__ = [
    "DispatchFailed",
    "DispatchTimeout",
    "DispatchWatchdog",
    "PenaltyBox",
]


class DispatchTimeout(RuntimeError):
    """One guarded dispatch exceeded its wall timeout."""


class DispatchFailed(RuntimeError):
    """A guarded dispatch exhausted its retry budget (or was shed by
    the concurrent-retry cap) — the caller's failure path owns it."""


class PenaltyBox:
    """Per-tenant quarantine for poisoned rows (tier-aware).

    A row lands here when the bisection corners it as non-finite or
    repeatedly failing.  Quarantine is bookkeeping, not enforcement —
    the caller decides what a quarantined row means (drop the request,
    dead-letter the app, bill the tenant); the box supplies the counts
    the ``pivot_recover_quarantined_rows`` gauge publishes and a shed
    order that releases tier 0 LAST (the admission queue's priority
    contract, applied to eviction).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: List[dict] = []

    def add(self, row: Any, tenant: str = "default", tier: int = 0,
            reason: str = "nonfinite") -> None:
        with self._lock:
            self._rows.append(dict(
                row=row, tenant=str(tenant), tier=int(tier),
                reason=str(reason), order=len(self._rows),
            ))

    @property
    def n(self) -> int:
        with self._lock:
            return len(self._rows)

    def counts(self) -> Dict[str, int]:
        """Quarantined rows per tenant (the metrics label set)."""
        out: Dict[str, int] = {}
        with self._lock:
            for rec in self._rows:
                out[rec["tenant"]] = out.get(rec["tenant"], 0) + 1
        return out

    def rows(self) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._rows]

    def shed_order(self) -> List[dict]:
        """Eviction order under pressure: highest tier (least
        important) first, tier 0 last; FIFO within a tier."""
        with self._lock:
            return sorted(
                (dict(r) for r in self._rows),
                key=lambda r: (-r["tier"], r["order"]),
            )


class DispatchWatchdog:
    """Timeout + bounded deterministic retry + bisection quarantine."""

    def __init__(
        self,
        policy: Optional[RetryPolicy] = None,
        timeout_s: Optional[float] = None,
        max_concurrent_retries: int = 2,
        acquire_timeout_s: float = 0.0,
        seed: int = 0,
        sleep: Callable[[float], None] = None,
    ):
        if timeout_s is not None and timeout_s <= 0:
            raise ValueError(
                f"timeout_s must be positive (or None), got {timeout_s}"
            )
        #: base=0.0 keeps retries immediate by default — wall backoff is
        #: an operator knob (RecoveryConfig.retry), not a hidden sleep.
        self.policy = policy or RetryPolicy(seed=seed, base=0.0)
        self.timeout_s = timeout_s
        self.gate = RetryGate(max_concurrent_retries)
        self.acquire_timeout_s = acquire_timeout_s
        self.penalty = PenaltyBox()
        self._sleep = sleep or time.sleep
        self._lock = threading.Lock()
        self.retries_total = 0
        self.timeouts = 0
        self.failures = 0
        self.sheds = 0

    # -- one guarded call --------------------------------------------------
    def _call(self, fn: Callable[[], Any], key: str) -> Any:
        if self.timeout_s is None:
            return fn()
        box: dict = {}
        done = threading.Event()

        def _run():
            try:
                box["out"] = fn()
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                box["exc"] = exc
            finally:
                done.set()

        t = threading.Thread(
            target=_run, name=f"recover-dispatch-{key}", daemon=True,
        )
        t.start()
        if not done.wait(self.timeout_s):
            with self._lock:
                self.timeouts += 1
            raise DispatchTimeout(
                f"dispatch {key!r} exceeded {self.timeout_s}s — worker "
                "thread abandoned"
            )
        if "exc" in box:
            raise box["exc"]
        return box["out"]

    def guard(self, fn: Callable[[], Any], key: str = "dispatch",
              tier: int = 0) -> Any:
        """Run ``fn`` with timeout + capped, seeded-backoff retries.

        The FIRST attempt never consults the gate (normal traffic must
        not contend on the retry cap); every retry holds a gate slot
        for its whole backoff + re-dispatch, which is what makes
        ``gate.peak`` the honest concurrency high-water mark.
        """
        try:
            return self._call(fn, key)
        except BaseException as exc:  # noqa: BLE001 — governed below
            last = exc
        attempt = 1
        while not self.policy.exhausted(attempt, tier):
            if not self.gate.acquire(timeout=self.acquire_timeout_s):
                with self._lock:
                    self.sheds += 1
                raise DispatchFailed(
                    f"dispatch {key!r} shed: concurrent-retry cap "
                    f"{self.gate.max_concurrent} saturated (metastable-"
                    "storm guard)"
                ) from last
            try:
                delay = self.policy.backoff(attempt, key)
                if delay > 0.0:
                    self._sleep(delay)
                with self._lock:
                    self.retries_total += 1
                return self._call(fn, key)
            except BaseException as exc:  # noqa: BLE001 — loop re-judges
                last = exc
                attempt += 1
            finally:
                self.gate.release()
        with self._lock:
            self.failures += 1
        bound = self.policy.max_attempts(tier)
        raise DispatchFailed(
            f"dispatch {key!r} failed after {attempt} attempt(s) "
            f"(tier {tier} bound: {bound})"
        ) from last

    # -- poison isolation --------------------------------------------------
    def run_batch(
        self,
        rows: Sequence[Any],
        run_rows: Callable[[List[int]], Any],
        finite_of: Optional[Callable[[Any, List[int]], Any]] = None,
        key: str = "batch",
        tenant_of: Optional[Callable[[Any], str]] = None,
        tier_of: Optional[Callable[[Any], int]] = None,
    ) -> Dict[int, Any]:
        """Serve ``rows`` through ``run_rows``, cornering poison.

        ``run_rows(idxs)`` dispatches the subset of row indices and
        returns its result; ``finite_of(result, idxs)`` returns a
        per-row validity mask (or a scalar bool for "all good/bad").
        A failing or poisoned subset is bisected down to singletons;
        cornered rows are quarantined (per-tenant, tier-aware — tier 0
        gets its full per-tier retry budget before quarantine) and the
        healthy survivors re-served.  Returns ``{row index: subset
        result}`` for every healthy subset served — poisoned rows are
        absent, present in :attr:`penalty` instead.
        """
        results: Dict[int, Any] = {}
        self._bisect(
            list(range(len(rows))), rows, run_rows, finite_of, key,
            tenant_of or (lambda r: getattr(r, "tenant", "default")),
            tier_of or (lambda r: int(getattr(r, "tier", 0))),
            results,
        )
        return results

    def _bisect(self, idxs, rows, run_rows, finite_of, key,
                tenant_of, tier_of, results) -> None:
        if not idxs:
            return
        tier = min(tier_of(rows[i]) for i in idxs)
        sub_key = f"{key}[{idxs[0]}:{idxs[-1] + 1}]"
        try:
            out = self.guard(
                lambda: run_rows(list(idxs)), key=sub_key, tier=tier,
            )
        except DispatchFailed:
            if len(idxs) == 1:
                i = idxs[0]
                self.penalty.add(
                    i, tenant=tenant_of(rows[i]), tier=tier_of(rows[i]),
                    reason="failing",
                )
                return
            mid = len(idxs) // 2
            self._bisect(idxs[:mid], rows, run_rows, finite_of, key,
                         tenant_of, tier_of, results)
            self._bisect(idxs[mid:], rows, run_rows, finite_of, key,
                         tenant_of, tier_of, results)
            return
        bad = self._bad_mask(out, idxs, finite_of)
        if not bad.any():
            for i in idxs:
                results[i] = out
            return
        if len(idxs) == 1:
            i = idxs[0]
            self.penalty.add(
                i, tenant=tenant_of(rows[i]), tier=tier_of(rows[i]),
                reason="nonfinite",
            )
            return
        # The validity mask names the poison directly: quarantine those
        # rows via singleton re-judgement (their own retry budget — a
        # transient NaN deserves the same patience as a transient
        # failure) and re-serve the clean remainder WITHOUT the poison
        # (a non-finite row can contaminate cross-row reductions, so
        # the mixed result is discarded).
        bad_idxs = [i for i, b in zip(idxs, bad) if b]
        good_idxs = [i for i, b in zip(idxs, bad) if not b]
        for i in bad_idxs:
            self._bisect([i], rows, run_rows, finite_of, key,
                         tenant_of, tier_of, results)
        self._bisect(good_idxs, rows, run_rows, finite_of, key,
                     tenant_of, tier_of, results)

    @staticmethod
    def _bad_mask(out, idxs, finite_of) -> np.ndarray:
        if finite_of is None:
            return np.zeros(len(idxs), dtype=bool)
        verdict = finite_of(out, list(idxs))
        if hasattr(verdict, "cpu"):
            verdict = verdict.cpu().numpy()
        arr = np.asarray(verdict)
        if arr.shape == ():  # scalar: True = all valid
            return np.full(len(idxs), not bool(arr))
        if arr.shape[0] != len(idxs):
            raise ValueError(
                f"finite_of returned {arr.shape[0]} verdicts for "
                f"{len(idxs)} rows"
            )
        return ~arr.astype(bool)

    # -- reporting ---------------------------------------------------------
    def summary(self) -> dict:
        with self._lock:
            return {
                "retries_total": self.retries_total,
                "timeouts": self.timeouts,
                "failures": self.failures,
                "sheds": self.sheds + self.gate.shed,
                "retry_concurrency_peak": self.gate.peak,
                "retry_concurrency_cap": self.gate.max_concurrent,
                "quarantined_rows": self.penalty.n,
                "quarantined_by_tenant": self.penalty.counts(),
            }
