"""Amortized host-side snapshots of the resident serve carry.

The resident serving tier keeps the span carry on the device
(``ops/tickloop.py`` — [H, 4] availability, [H] decay counts, [H] live
mask): each span consumes it and returns the next, and it is never
re-staged from host, which means there is deliberately NO host copy to
fall back on after a crash.  This module restores one — off the hot path:

  * every N spans (``RecoveryConfig.snapshot_every``) the recovery
    plane clones the pending carry (``resident_carry_clone`` — a cheap
    device-side copy on the span boundary, the same safe window the
    mirror-diff already reads in) and *submits* the clone here;
  * a background worker thread performs the D2H fetch (every tensor of
    the snapshot in ONE ``.cpu()``, ordered after the clone by the
    stream: the clone and the copy run on the same default stream, and
    the copy synchronises with it), fingerprints the
    arrays with the same versioned-config + shape + ``tobytes`` sha256
    scheme ``parallel/ensemble/checkpoint.py`` uses, and writes a
    double-buffered ``.npz`` (tmp + ``os.replace``, alternating between
    two slots) — the dispatch loop never blocks on snapshot I/O, and a
    crash mid-write leaves the other slot's last good snapshot intact;
  * the submission queue holds ONE pending snapshot: if the worker is
    still writing when the next cadence fires, the older pending clone
    is dropped (latest-wins) — snapshots are a recovery floor, not a
    log, so falling behind degrades recovery-point age, never
    throughput.

Consumption safety: the worker only ever touches CLONES.  The pending
carry itself is consumed by the next span and must never be read after
that.

No torch import at module scope (host arrays pass through
``np.asarray``), so pure-numpy serving can import the recovery plane
freely.  A port of ``pivot_tpu/recover/snapshot.py``; the host copy
(``:161-162``, ``np.asarray``) is :func:`host_arrays`.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

__all__ = ["SnapshotStore", "fingerprint_arrays", "host_arrays"]

_STOP = object()


def host_arrays(payload: Mapping[str, Any]) -> Tuple[Dict[str, np.ndarray],
                                                     int]:
    """``(host arrays, bytes copied off the card)`` of one snapshot
    payload: host arrays as they are, and every tensor in ONE
    device→host copy (its bytes concatenated on the device, then one
    ``.cpu()``)."""
    dev = [k for k, v in payload.items() if hasattr(v, "cpu")]
    out = {k: np.asarray(v) for k, v in payload.items() if k not in dev}
    if not dev:
        return out, 0
    import torch

    tensors = [payload[k].detach().contiguous() for k in dev]
    parts = [t.reshape(-1).view(torch.uint8) for t in tensors]
    host = torch.cat(parts).cpu().numpy()
    o = 0
    for k, t, p in zip(dev, tensors, parts):
        n = p.numel()
        np_dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out[k] = host[o:o + n].view(np_dtype).reshape(tuple(t.shape))
        o += n
    off_card = sum(p.numel() for t, p in zip(tensors, parts)
                   if t.device.type != "cpu")
    return out, int(off_card)


def fingerprint_arrays(arrays: Mapping[str, np.ndarray],
                       meta: Mapping[str, Any]) -> str:
    """Content fingerprint of one snapshot (checkpoint.py scheme).

    sha256 over the repr of a versioned config tuple — the format
    version, the sorted array names, and the canonical meta — then each
    array's name, shape, dtype, and raw bytes; truncated to 16 hex
    chars.  Two snapshots of bit-identical state fingerprint
    identically (what the kill-and-resume referee compares), and any
    drift in layout or content changes the digest.
    """
    h = hashlib.sha256()
    cfg = (
        "v1",
        tuple(sorted(arrays)),
        json.dumps(dict(meta), sort_keys=True, separators=(",", ":")),
    )
    h.update(repr(cfg).encode())
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(repr((a.shape, str(a.dtype))).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


class SnapshotStore:
    """Double-buffered, fingerprinted, background-written snapshots."""

    def __init__(self, directory: str, seed: int = 0):
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.seed = int(seed)
        self.paths = (
            os.path.join(directory, "carry-a.npz"),
            os.path.join(directory, "carry-b.npz"),
        )
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.written = 0
        self.dropped = 0  # latest-wins replacements of a pending clone
        self.errors = 0
        self.d2h_bytes = 0  # bytes the worker copied off the card
        self.last_fingerprint: Optional[str] = None
        self.last_meta: Optional[dict] = None
        self._last_wall: Optional[float] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._worker, name="recover-snapshot", daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        """Drain the pending snapshot (if any) and join the worker."""
        if self._thread is None:
            return
        self._q.put(_STOP)
        self._thread.join()
        self._thread = None

    # -- hot-path side -----------------------------------------------------
    def submit(self, payload: Mapping[str, Any], meta: Dict[str, Any]
               ) -> bool:
        """Enqueue one snapshot without ever blocking the caller.

        ``payload`` maps array names to device (or host) arrays — for
        the resident path, a *clone* of the pending carry plus any
        host-side rows (risk table).  Returns False when an older
        pending snapshot was displaced (latest-wins).
        """
        item = (dict(payload), dict(meta))
        while True:
            try:
                self._q.put_nowait(item)
                return True
            except queue.Full:
                try:
                    stale = self._q.get_nowait()
                except queue.Empty:
                    continue  # worker grabbed it first — retry the put
                if stale is _STOP:
                    # Never displace shutdown: re-queue it after us is
                    # wrong (we are stopping) — drop the new snapshot.
                    self._q.put(stale)
                    return False
                self.dropped += 1

    # -- worker side -------------------------------------------------------
    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is _STOP:
                return
            payload, meta = item
            try:
                self._write(payload, meta)
            except Exception:  # noqa: BLE001 — snapshot loss ≠ crash
                # A failed snapshot degrades the recovery point; it must
                # never take the serving loop down with it.
                with self._lock:
                    self.errors += 1

    def _write(self, payload: Mapping[str, Any],
               meta: Dict[str, Any]) -> None:
        # The D2H fetch happens HERE, on the worker, overlapped with the
        # next dispatch.
        arrays, nbytes = host_arrays(payload)
        fp = fingerprint_arrays(arrays, meta)
        record = dict(meta)
        record["fingerprint"] = fp
        record["snapshot_seq"] = self.written
        path = self.paths[self.written % 2]
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(
                f, __meta__=np.array(
                    json.dumps(record, sort_keys=True)
                ),
                **arrays,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic: readers see old-or-new, never torn
        with self._lock:
            self.written += 1
            self.d2h_bytes += nbytes
            self.last_fingerprint = fp
            self.last_meta = record
            self._last_wall = time.monotonic()

    # -- read side ---------------------------------------------------------
    def latest(self) -> Optional[Tuple[Dict[str, np.ndarray], dict]]:
        """Newest VALID snapshot across both buffers, or None.

        Each candidate is re-fingerprinted on load; a corrupt or torn
        buffer is skipped (the double-buffer's whole point), and
        ``allow_pickle=False`` keeps the loader content-only.
        """
        best: Optional[Tuple[Dict[str, np.ndarray], dict]] = None
        for path in self.paths:
            if not os.path.exists(path):
                continue
            try:
                with np.load(path, allow_pickle=False) as z:
                    meta = json.loads(str(z["__meta__"]))
                    arrays = {
                        k: z[k] for k in z.files if k != "__meta__"
                    }
            except (OSError, ValueError, KeyError,
                    json.JSONDecodeError):
                continue
            want = meta.pop("fingerprint", None)
            seq = meta.get("snapshot_seq", -1)
            # The fingerprint was computed over the SUBMIT-side meta (no
            # fingerprint/snapshot_seq keys) — rebuild that view.
            submit_meta = {
                k: v for k, v in meta.items() if k != "snapshot_seq"
            }
            if fingerprint_arrays(arrays, submit_meta) != want:
                continue
            meta["fingerprint"] = want
            if best is None or seq > best[1].get("snapshot_seq", -1):
                best = (arrays, meta)
        return best

    @property
    def age_s(self) -> Optional[float]:
        """Wall seconds since the last completed snapshot (the
        ``pivot_recover_snapshot_age_s`` gauge); None before the
        first."""
        with self._lock:
            if self._last_wall is None:
                return None
            return time.monotonic() - self._last_wall

    def summary(self) -> dict:
        with self._lock:
            return {
                "written": self.written,
                "dropped": self.dropped,
                "errors": self.errors,
                "last_fingerprint": self.last_fingerprint,
                "last_meta": dict(self.last_meta or {}),
            }
