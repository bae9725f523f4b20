"""Deterministic counter-based random streams shared across policy backends.

The vectorized-numpy and TPU policy modes must make *identical* random
choices so placement parity is exact.  Philox is counter-based: the stream
for tick ``t`` is fully determined by ``(seed, t)`` with no sequential
state, so the CPU runtime can generate the tick's uniforms once and feed
the same array to either backend (the TPU kernel takes them as an input —
no on-device RNG divergence to worry about).
"""

from __future__ import annotations

import numpy as np

__all__ = ["tick_uniforms", "keyed_storage_index"]


def tick_uniforms(seed: int, tick_seq: int, n: int) -> np.ndarray:
    """[n] float64 uniforms in [0, 1) for one scheduling tick."""
    bitgen = np.random.Philox(key=seed, counter=[0, 0, 0, tick_seq])
    return np.random.Generator(bitgen).random(n)


# murmur3-style 32-bit finalizer constants; uint32 math only so the JAX
# twin (ensemble._keyed_storage_index_jax) runs on TPU, which has no u64.
_MIX_A = np.uint32(0x9E3779B9)
_MIX_B = np.uint32(0x85EBCA6B)
_MIX_C = np.uint32(0xC2B2AE35)


def keyed_storage_index(seed: int, app_ordinal, n_storage: int, salt: int = 0):
    """Root-anchor storage index for one application — an *entity-keyed*
    draw (pure function of ``(seed, app, salt)``), identical between the
    DES policies and the ensemble estimator.

    The reference redraws a root group's random storage anchor on every
    ``schedule()`` call (``scheduler/cost_aware.py:38-39``), i.e. the
    draw depends on stream *position* — unreproducible by an estimator
    with a different call pattern, which round 1 measured as the dominant
    cost-aware egress divergence.  Keying the draw on stable identity
    makes both engines agree exactly (and the retry path deterministic)
    while staying uniform over storages.  ``salt`` folds in the
    Monte-Carlo replica id (0 = the nominal draw the DES uses).

    ``app_ordinal`` may be a numpy int array (vectorized).
    """
    with np.errstate(over="ignore"):
        x = np.uint32(seed) * _MIX_A + np.uint32(salt)
        x ^= x >> np.uint32(16)
        x = x * _MIX_B + np.asarray(app_ordinal, np.uint32) * _MIX_A
        x ^= x >> np.uint32(13)
        x = x * _MIX_C
        x ^= x >> np.uint32(16)
    return (x % np.uint32(n_storage)).astype(np.int64)
