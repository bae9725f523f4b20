"""Unified metrics registry: one snapshot shape instead of five.

Before round 14 the system's metrics were a scatter of per-subsystem
JSON dumps — ``SloMeter.snapshot()``, the batcher's ``stats_out`` dict,
the autoscaler's event list, ``Meter.summary()``, and the compile
counter — each with its own schema, none correlatable without writing
a bespoke joiner.  Detecting metastable feedback (retry storms feeding
backpressure feeding autoscaling — Bronson et al., PAPERS.md) needs the
signals in ONE place with ONE shape.

:class:`MetricsRegistry` is that place: a thread-safe, label-aware
store of **counters** (monotone), **gauges** (point-in-time), and
**summaries** (count/sum/quantiles — the export shape of
:class:`~pivot_tpu_torch.infra.meter.StreamingHistogram` snapshots), exported
two ways:

  * :meth:`to_prometheus` — Prometheus text exposition (format 0.0.4):
    ``# HELP``/``# TYPE`` headers, label-escaped sample lines, summary
    quantile series plus ``_count``/``_sum`` — scrape-ready;
  * :meth:`to_json` — the same families as one JSON document (the
    snapshot shape tests pin).

Publishers do not push continuously; sources *publish* their current
state into the registry at snapshot points (``SloMeter
.publish_metrics``, ``Meter.publish_metrics``, ``ServeDriver.report``,
the compile-counter observer).  Publishing is idempotent — ``set`` on
a counter family records the source's monotone value, so republishing
a snapshot never double-counts.

Metric and label names are validated against the Prometheus grammar at
family creation, so a typo fails at declaration, not at scrape time.

JAX-free copy of ``pivot_tpu/obs/registry.py``, import paths rewritten.
"""

from __future__ import annotations

import json
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["MetricsRegistry", "declare_recovery_metrics"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_KINDS = ("counter", "gauge", "summary")


def _escape(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


class _Family:
    """One metric family: a kind, a help string, fixed label names, and
    samples keyed by label-value tuples."""

    __slots__ = ("name", "kind", "help", "labelnames", "samples")

    def __init__(self, name: str, kind: str, help: str,
                 labelnames: Tuple[str, ...]):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = labelnames
        # label values tuple -> float (counter/gauge) or summary dict
        self.samples: Dict[Tuple[str, ...], Any] = {}


class MetricsRegistry:
    """Thread-safe counters/gauges/summaries with labels."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    # -- declaration -----------------------------------------------------
    def _declare(self, name: str, kind: str, help: str,
                 labelnames: Sequence[str]) -> _Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind or fam.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name} re-declared as {kind}"
                    f"{tuple(labelnames)} (was {fam.kind}"
                    f"{fam.labelnames})"
                )
            if help and not fam.help:
                fam.help = help
            return fam
        fam = _Family(name, kind, help, tuple(labelnames))
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> "MetricsRegistry":
        with self._lock:
            self._declare(name, "counter", help, labelnames)
        return self

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> "MetricsRegistry":
        with self._lock:
            self._declare(name, "gauge", help, labelnames)
        return self

    def summary(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> "MetricsRegistry":
        with self._lock:
            self._declare(name, "summary", help, labelnames)
        return self

    # -- recording -------------------------------------------------------
    def _key(self, fam: _Family, labels: Dict[str, Any]) -> Tuple[str, ...]:
        if set(labels) != set(fam.labelnames):
            raise ValueError(
                f"{fam.name} wants labels {fam.labelnames}, got "
                f"{tuple(sorted(labels))}"
            )
        return tuple(str(labels[ln]) for ln in fam.labelnames)

    def _recording_family(self, name: str, kinds: Tuple[str, ...],
                          labels: Dict[str, Any]) -> _Family:
        """Family for a recording call (auto-declared as ``kinds[0]``
        on first use), kind-checked at RECORDING time — "a typo fails
        at declaration, not scrape time" must also hold for the write
        path, or a ``set()`` on a summary family stores a raw float
        that only explodes later inside ``to_prometheus()``."""
        fam = self._families.get(name)
        if fam is None:
            return self._declare(name, kinds[0], "", tuple(sorted(labels)))
        if fam.kind not in kinds:
            raise ValueError(
                f"{name} is a {fam.kind}; this recording method "
                f"serves {kinds}"
            )
        return fam

    def inc(self, name: str, value: float = 1.0, **labels: Any) -> None:
        """Increment a counter (auto-declared on first use)."""
        if value < 0:
            raise ValueError(f"counter {name} increment must be >= 0")
        with self._lock:
            fam = self._recording_family(name, ("counter",), labels)
            key = self._key(fam, labels)
            fam.samples[key] = fam.samples.get(key, 0.0) + float(value)

    def set(self, name: str, value: float, **labels: Any) -> None:
        """Record a value: point-in-time for gauges, the source's
        current monotone total for counters (publish-style — idempotent
        on republish, never double-counting)."""
        with self._lock:
            fam = self._recording_family(name, ("gauge", "counter"), labels)
            fam.samples[self._key(fam, labels)] = float(value)

    def observe_summary(self, name: str, count: int, total: float,
                        quantiles: Dict[float, float],
                        **labels: Any) -> None:
        """Publish a pre-aggregated distribution (the shape a
        ``StreamingHistogram.snapshot()`` reduces to): exact count and
        sum plus quantile estimates keyed by q in (0, 1]."""
        with self._lock:
            fam = self._recording_family(name, ("summary",), labels)
            fam.samples[self._key(fam, labels)] = {
                "count": int(count),
                "sum": float(total),
                "quantiles": {
                    float(q): float(v) for q, v in quantiles.items()
                },
            }

    # -- export ----------------------------------------------------------
    def to_prometheus(self) -> str:
        """Prometheus text exposition (0.0.4), families sorted by name."""
        lines: List[str] = []
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                if fam.help:
                    lines.append(f"# HELP {name} {_escape(fam.help)}")
                lines.append(f"# TYPE {name} {fam.kind}")
                for key in sorted(fam.samples):
                    label_str = ",".join(
                        f'{ln}="{_escape(v)}"'
                        for ln, v in zip(fam.labelnames, key)
                    )
                    if fam.kind == "summary":
                        s = fam.samples[key]
                        for q in sorted(s["quantiles"]):
                            qlabels = label_str + ("," if label_str else "")
                            lines.append(
                                f'{name}{{{qlabels}quantile="{q:g}"}} '
                                f"{s['quantiles'][q]:.9g}"
                            )
                        suffix = f"{{{label_str}}}" if label_str else ""
                        lines.append(
                            f"{name}_count{suffix} {s['count']}"
                        )
                        lines.append(f"{name}_sum{suffix} {s['sum']:.9g}")
                    else:
                        suffix = f"{{{label_str}}}" if label_str else ""
                        lines.append(
                            f"{name}{suffix} {fam.samples[key]:.9g}"
                        )
        return "\n".join(lines) + "\n"

    def to_json(self) -> dict:
        """The same families as one JSON document — the unified
        snapshot shape (``{"metrics": {name: {kind, help, samples:
        [{labels, value}]}}}``)."""
        with self._lock:
            metrics: Dict[str, Any] = {}
            for name in sorted(self._families):
                fam = self._families[name]
                metrics[name] = {
                    "kind": fam.kind,
                    "help": fam.help,
                    "samples": [
                        {
                            "labels": dict(zip(fam.labelnames, key)),
                            "value": fam.samples[key],
                        }
                        for key in sorted(fam.samples)
                    ],
                }
            return {"metrics": metrics}

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)

    def save_prometheus(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_prometheus())

    # -- convenience -----------------------------------------------------
    def families(self) -> List[str]:
        with self._lock:
            return sorted(self._families)

    def get(self, name: str, **labels: Any) -> Optional[Any]:
        """Current value of one sample (None when absent) — test hook."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return None
            try:
                return fam.samples.get(self._key(fam, labels))
            except ValueError:
                return None


def declare_recovery_metrics(registry: MetricsRegistry) -> None:
    """Declare the ``pivot_recover_*`` family (idempotent — declare is
    chainable and re-declaration with identical schema is a no-op).
    Published by ``pivot_tpu_torch.recover.RecoveryPlane.publish`` whenever a
    serve driver runs with a recovery plane attached:

      * ``pivot_recover_snapshot_age_s`` — seconds since the last
        resident-carry snapshot landed on disk (the recovery-point age).
      * ``pivot_recover_journal_lag`` — journaled records not yet
        fsynced (the write-ahead journal's durability lag).
      * ``pivot_recover_retries_total`` — watchdog dispatch retries.
      * ``pivot_recover_quarantined_rows`` — rows in the per-tenant
        penalty box, labelled by tenant.
    """
    registry.gauge(
        "pivot_recover_snapshot_age_s",
        "seconds since the last resident-carry snapshot was written",
    )
    registry.gauge(
        "pivot_recover_journal_lag",
        "journal records appended but not yet fsynced",
    )
    registry.counter(
        "pivot_recover_retries_total",
        "watchdog dispatch retries issued",
    )
    registry.gauge(
        "pivot_recover_quarantined_rows",
        "rows quarantined in the penalty box, per tenant",
        labelnames=("tenant",),
    )
