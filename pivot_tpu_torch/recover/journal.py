"""Write-ahead journal for the serve recovery plane.

Every externally-visible serving decision — an admission, a coalesced
flush, a mid-span splice, an MPC actuation — appends one compact record
HERE, *before* it takes effect.  The service's worlds are deterministic
discrete-event simulations (seeded streams, seeded policies, seeded
chaos), so the journal does not need to capture any world state: the
admission records plus the world seeds are sufficient to replay the
entire service bit-identically (``tests/test_recovery.py`` pins this —
the kill-and-resume referee).  What the journal buys over "just re-run
the generator" is crash truth: after an abrupt stop, the journal tail
says exactly which arrivals the dead server had admitted, in order, so
a resumed server can verify its regenerated stream against what
actually happened instead of trusting that nothing drifted.

Hot-path cost is amortized two ways:

  * records are buffered line-appends (one small ``dict`` → one JSON
    line); ``fsync`` runs every ``fsync_every`` records, not per record
    — the classic group-commit trade (a crash can lose at most the
    un-synced tail, and the referee's replay regenerates exactly that
    tail from the seeds);
  * each record carries a short blake2b tag chained from the journal
    seed, the sequence number, and the canonical payload — torn or
    hand-edited lines fail :func:`Journal.read` loudly instead of
    silently replaying a corrupted history.  A torn FINAL line is the
    expected crash artifact and is tolerated (reported, not raised).

Pure stdlib: the journal must be constructible from a pure-numpy
serving stack.  A copy of ``pivot_tpu/recover/journal.py`` (import paths
rewritten): the same records give the same bytes on disk.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["Journal", "JournalError"]


class JournalError(RuntimeError):
    """A journal failed integrity validation (bad tag, non-monotone
    sequence, unreadable header) — the history cannot be trusted."""


def _canonical(payload: dict) -> str:
    """Stable serialization for tagging: sorted keys, no whitespace."""
    return json.dumps(payload, sort_keys=True, separators=(",", ":"))


def _tag(seed: int, seq: int, kind: str, payload: dict) -> str:
    """Seeded per-record integrity tag (blake2b, 8 hex chars)."""
    digest = hashlib.blake2b(
        f"{seed}:{seq}:{kind}:{_canonical(payload)}".encode(),
        digest_size=4,
    )
    return digest.hexdigest()


class Journal:
    """Append-only, fsync-batched, seed-tagged decision log.

    Thread-safe: the producer (admissions), session threads (spans,
    splices), the batcher coordinator (flushes), and the MPC thread
    (actuations) all append under one lock — appends are a dict build
    plus a buffered write, so the lock is never held across I/O stalls
    longer than an ``fsync`` every ``fsync_every``-th record.
    """

    VERSION = 1

    def __init__(self, path: str, seed: int = 0, fsync_every: int = 32,
                 resume: bool = False):
        if fsync_every < 1:
            raise ValueError(
                f"fsync_every must be >= 1, got {fsync_every}"
            )
        self.path = path
        self.seed = int(seed)
        self.fsync_every = int(fsync_every)
        self._lock = threading.Lock()
        self._pending = 0  # records appended since the last fsync
        self.appended = 0  # records appended by THIS process
        self.fsyncs = 0
        self._seq = 0
        prior: List[dict] = []
        if resume and os.path.exists(path):
            prior, torn = Journal.read(path, seed=self.seed)
            if prior:
                self._seq = prior[-1]["seq"] + 1
            if torn:
                # The crash artifact: amputate the torn final line so
                # the resume header never lands mid-garbage.  Records
                # re-serialize byte-identically (_canonical is how they
                # were written), so the tags stay valid.
                with open(path, "w", encoding="utf-8") as f:
                    for rec in prior:
                        f.write(_canonical(rec) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
        self._f = open(path, "a" if resume else "w", encoding="utf-8")
        # The header is itself a journaled (tagged) record, so read()
        # validates the epoch boundary like any other decision.
        self.append(
            "resume" if prior else "open",
            version=self.VERSION, seed=self.seed,
            prior_records=len(prior),
        )
        self.sync()

    # -- writing -----------------------------------------------------------
    def append(self, kind: str, **fields) -> int:
        """Journal one decision BEFORE it takes effect; returns its seq.

        ``fields`` must be JSON-serializable and deterministic under the
        run's seeds (no wall-clock values — two seeded runs must produce
        byte-identical journals, which is what the replay-determinism
        test compares).
        """
        with self._lock:
            if self._f is None:
                raise JournalError(f"journal {self.path} is closed")
            seq = self._seq
            self._seq += 1
            rec = dict(fields)
            rec["seq"] = seq
            rec["kind"] = kind
            rec["tag"] = _tag(self.seed, seq, kind, fields)
            self._f.write(_canonical(rec) + "\n")
            self.appended += 1
            self._pending += 1
            if self._pending >= self.fsync_every:
                self._sync_locked()
            return seq

    def _sync_locked(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())
        self._pending = 0
        self.fsyncs += 1

    def sync(self) -> None:
        """Force the buffered tail to disk (span boundaries, shutdown)."""
        with self._lock:
            if self._f is not None:
                self._sync_locked()

    @property
    def lag(self) -> int:
        """Records appended but not yet fsynced — what a crash right now
        would lose (the ``pivot_recover_journal_lag`` gauge)."""
        with self._lock:
            return self._pending

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._sync_locked()
                self._f.close()
                self._f = None

    # -- reading -----------------------------------------------------------
    @staticmethod
    def read(path: str, seed: Optional[int] = None
             ) -> Tuple[List[dict], int]:
        """Load and validate a journal; returns ``(records, torn)``.

        ``torn`` counts unparseable trailing bytes (0 or 1 lines): a
        crash mid-append tears at most the final line, which is the one
        corruption read() forgives.  Anything else — a bad tag, a
        sequence gap, garbage in the middle — raises
        :class:`JournalError`.  ``seed`` defaults to the seed declared
        in the header record, so a reader needs only the path.
        """
        with open(path, "r", encoding="utf-8") as f:
            lines = f.read().splitlines()
        records: List[dict] = []
        torn = 0
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    torn = 1  # the expected crash artifact
                    break
                raise JournalError(
                    f"{path}:{i + 1}: unparseable mid-journal line"
                )
            records.append(rec)
        if not records:
            return records, torn
        head = records[0]
        if head.get("kind") not in ("open", "resume"):
            raise JournalError(
                f"{path}: first record is {head.get('kind')!r}, "
                "expected an open/resume header"
            )
        if seed is None:
            seed = int(head.get("seed", 0))
        for i, rec in enumerate(records):
            if rec.get("seq") != i and records[0]["seq"] == 0:
                raise JournalError(
                    f"{path}: sequence gap at record {i} "
                    f"(seq {rec.get('seq')})"
                )
            payload = {
                k: v for k, v in rec.items()
                if k not in ("seq", "kind", "tag")
            }
            want = _tag(seed, rec["seq"], rec["kind"], payload)
            if rec.get("tag") != want:
                raise JournalError(
                    f"{path}: bad tag on record seq={rec['seq']} "
                    f"({rec.get('tag')} != {want}) — corrupted or "
                    "wrong seed"
                )
        return records, torn

    @staticmethod
    def admissions(records: List[dict]) -> List[dict]:
        """The admission sub-history: what a resumed server verifies its
        regenerated arrival stream against (ts/tier/tenant/app in
        admission order)."""
        return [r for r in records if r["kind"] == "admit"]


def replay_prefix_check(records: List[dict], arrivals) -> int:
    """Verify journaled admissions against a regenerated arrival stream.

    ``arrivals`` is the full regenerated stream (same seeds as the
    killed run).  Each journaled admission must match the stream's
    arrival at the same position on (ts, tier, tenant, app id) — the
    deterministic-replay contract.  Returns the number of journaled
    admissions (the crash frontier: everything after it is fresh work),
    or raises :class:`JournalError` on the first divergence.
    """
    admits = Journal.admissions(records)
    for i, rec in enumerate(admits):
        if i >= len(arrivals):
            raise JournalError(
                f"journal has {len(admits)} admissions but the "
                f"regenerated stream only {len(arrivals)} arrivals"
            )
        a = arrivals[i]
        got = dict(
            ts=a.ts, tier=int(getattr(a, "tier", 0)),
            tenant=getattr(a, "tenant", "default"), app=a.app.id,
        )
        want = {k: rec.get(k) for k in got}
        if got != want:
            raise JournalError(
                f"replay divergence at admission {i}: journal {want} "
                f"vs regenerated stream {got} — the world seeds do not "
                "reproduce the killed run"
            )
    return len(admits)
