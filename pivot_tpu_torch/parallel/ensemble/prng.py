"""Threefry-2x32, bit-equal to ``jax.random`` with partitionable threefry.

The ensemble's Monte-Carlo draws (``draws.py``) must be the numbers the
JAX package draws from the same key, so the port carries its own
counter-based generator: the Threefry-2x32 hash of ``jax._src.prng``
(20 rounds, rotations ``(13, 15, 26, 6)`` / ``(17, 29, 16, 24)``, key
schedule with ``0x1BD11BDA``) and the derivations of ``jax.random`` as
jax runs them with ``jax_threefry_partitionable`` on (the default since
jax 0.5):

  * a key is the uint32 pair ``[seed >> 32, seed & 0xFFFFFFFF]``;
  * ``split(key, n)`` hashes the counter pairs ``(i >> 32, i & M)`` of
    ``i < n`` and key ``i`` is the pair of hash words;
  * ``fold_in(key, d)`` hashes the one counter pair ``(0, d)``;
  * ``random_bits`` hashes the counter pair of each element's flat index
    and returns ``w0 ^ w1`` (32 bits) or ``w0 << 32 | w1`` (64 bits);
  * ``uniform`` ORs the top mantissa bits into the bits of 1.0, subtracts
    1, computes ``floats * (maxval − minval) + minval`` and floors at
    ``minval``.  XLA's CPU backend contracts that multiply-add into one
    fused multiply-add, so the twin rounds it once (:func:`fma`).

Keys live on the host as numpy ``uint32[2]`` arrays (``key_data`` of a
JAX key).  Draws are computed on the requested device in ``int64``
holding uint32 values (masked after every add and shift), so a draw is
the same bits on the CPU and on the card: every float operation is its
own torch op, and the one fused multiply-add is emulated exactly.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["PRNGKey", "fma", "fold_in", "random_bits", "split", "uniform"]

_M32 = 0xFFFFFFFF
_SPLIT64 = 134217729.0  # 2**27 + 1, Dekker's splitter for float64
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash of counter words ``(x0, x1)`` under key
    ``(k0, k1)``.  Works on Python ints and on int64 tensors holding
    uint32 values alike; returns the two hash words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _two_prod(a, b):
    """``a * b`` as the unevaluated sum of two float64s (Dekker)."""
    p = a * b
    ca = a * _SPLIT64
    ahi = ca - (ca - a)
    alo = a - ahi
    cb = b * _SPLIT64
    bhi = cb - (cb - b)
    blo = b - bhi
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


def _two_sum(p, c):
    """``p + c`` as its float64 rounding and the exact remainder."""
    s = p + c
    bb = s - p
    return s, (p - (s - bb)) + (c - bb)


def fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``round(a * b + c)`` with one rounding, in the dtype of ``a``: the
    fused multiply-add XLA's CPU backend makes of a multiply that feeds an
    add.  Float32 goes through float64, where the product is exact, and
    rounds the sum to odd there, so the one rounding to float32 after it
    is the correct one (no double rounding); float64 adds the error-free
    product and sum transformations."""
    if a.dtype == torch.float32:
        p = a.double() * (b.double() if torch.is_tensor(b) else b)
        s, t = _two_sum(p, c.double())
        bits = s.view(torch.int64)
        inexact_even = (t != 0) & ((bits & 1) == 0)
        step = torch.where((t > 0) == (s > 0), 1, -1)
        return torch.where(inexact_even, bits + step, bits).view(
            torch.float64).float()
    p, e = _two_prod(a, b)
    s, t = _two_sum(p, c)
    # An infinite product or sum is its own result (the corrections are
    # NaN there).
    return torch.where(torch.isfinite(s), s + (t + e), s)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s key data: ``[seed >> 32, seed & M]``."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & _M32], dtype=np.uint32)


def _words(key) -> tuple:
    k = np.asarray(key, dtype=np.uint32).reshape(-1)
    return int(k[0]), int(k[1])


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``[num, 2]`` uint32 keys."""
    k0, k1 = _words(key)
    out = np.empty((num, 2), dtype=np.uint32)
    for i in range(num):
        out[i] = threefry2x32(k0, k1, i >> 32, i & _M32)
    return out


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    k0, k1 = _words(key)
    return np.array(threefry2x32(k0, k1, 0, int(data) & _M32),
                    dtype=np.uint32)


def _hash_words(key, shape: Sequence[int], device):
    k0, k1 = _words(key)
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    w0, w1 = threefry2x32(k0, k1, idx >> 32, idx & _M32)
    return w0.reshape(tuple(shape)), w1.reshape(tuple(shape))


def random_bits(key, bit_width: int, shape: Sequence[int],
                device="cpu") -> torch.Tensor:
    """``jax.random.bits`` of 32 or 64 bits, as int64 holding the same bit
    pattern (a 64-bit draw ≥ 2**63 reads negative)."""
    w0, w1 = _hash_words(key, shape, device)
    if bit_width == 32:
        return w0 ^ w1
    if bit_width == 64:
        return (w0 << 32) | w1  # wraps like the uint64 bit pattern
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


def uniform(key, shape: Sequence[int], dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0,
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``, float32
    or float64, bit for bit."""
    w0, w1 = _hash_words(key, shape, device)
    if dtype == torch.float32:
        mant = ((w0 ^ w1) >> 9) | 0x3F800000
        floats = mant.to(torch.int32).view(torch.float32)
    elif dtype == torch.float64:
        mant = (w0 << 20) | (w1 >> 12) | 0x3FF0000000000000
        floats = mant.view(torch.float64)
    else:
        raise ValueError(f"uniform draws float32 or float64, got {dtype}")
    floats = floats - torch.ones((), dtype=dtype, device=device)
    lo = torch.tensor(minval, dtype=dtype, device=device)
    hi = torch.tensor(maxval, dtype=dtype, device=device)
    return torch.maximum(lo, fma(floats, hi - lo, lo.expand(floats.shape)))
