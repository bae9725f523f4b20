"""Shared utilities: logging, time bucketing, deterministic id generation.

Capability parity with the reference's ``util.py`` (Loggable / Singleton /
floor / ceil — reference ``util.py:5-34``) but organized as plain module
functions; no singleton metaclass is needed because metadata is passed
explicitly (see ``pivot_tpu_torch.infra.locality``).
"""

from __future__ import annotations

import itertools
import logging
import sys

_LOG_FORMAT = "%(name)s.%(funcName)s:%(lineno)s\t%(message)s"
_configured = False


def get_logger(name: str) -> logging.Logger:
    """Return a stdout logger configured once per process (INFO level)."""
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_LOG_FORMAT))
        root = logging.getLogger("pivot_tpu_torch")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _configured = True
    return logging.getLogger("pivot_tpu_torch." + name)


class LogMixin:
    """Per-class logger property, analogous to the reference ``Loggable``."""

    @property
    def logger(self) -> logging.Logger:
        return get_logger(type(self).__name__)


def floor_bucket(n: float, bucket: float) -> float:
    """Round ``n`` down to a multiple of ``bucket`` (meter time bucketing)."""
    return n // bucket * bucket


def ceil_bucket(n: float, bucket: float) -> float:
    """Round ``n`` up to the next multiple of ``bucket`` (exclusive upper)."""
    return (n // bucket + 1) * bucket


_id_counters = {}


def fresh_id(prefix: str) -> str:
    """Deterministic, process-local unique id (``prefix-N``).

    The reference uses random UUID4 node ids (``resources/__init__.py:170``);
    deterministic ids make simulations reproducible and placements loggable
    as dense integer indices, which is what the TPU kernels consume.
    """
    counter = _id_counters.setdefault(prefix, itertools.count())
    return f"{prefix}-{next(counter)}"


def reset_ids() -> None:
    """Reset id counters (used by tests for reproducibility)."""
    _id_counters.clear()
