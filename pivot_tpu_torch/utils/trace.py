"""Compatibility shim over :mod:`pivot_tpu_torch.obs.tracer`.

The round-1 seed tracer lived here; round 14 grew it into the
observability plane (``pivot_tpu/obs/`` — causal task tracing, the
unified metrics registry, Perfetto export).  Every existing import
(``from pivot_tpu_torch.utils.trace import Tracer, NULL_TRACER,
device_profile``) keeps working through this module; new code should
import from :mod:`pivot_tpu_torch.obs` directly.
"""

from __future__ import annotations

from pivot_tpu_torch.obs.tracer import (  # noqa: F401 — re-exports
    NULL_TRACER,
    TERMINAL_STAGES,
    Tracer,
    device_profile,
)

__all__ = ["Tracer", "NULL_TRACER", "TERMINAL_STAGES", "device_profile"]
