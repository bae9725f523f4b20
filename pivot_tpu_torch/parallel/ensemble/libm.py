"""Twins of the transcendental functions XLA's CPU backend runs for the
ensemble, rounding as it rounds.

``pivot_tpu`` draws its fault outages with ``-log1p(-u)`` and raises the
score tables to per-row exponents with ``x ** w``.  Neither rounds as
torch's own ``log1p`` / ``pow`` do, on the CPU or on the card (measured
on 2**21 uniforms and 10**6 bases from the score tables: 5-11% and 1.7%
of the results differ), so the port computes them from elementary IEEE
operations, each its own torch op, and is the same bits on both devices:

  * ``log1p`` (:func:`neg_log1p_neg`): XLA emits it inline
    (``xla.log1p.*``): a Cephes rational approximation below
    ``sqrt(2) - 1`` and ``log(1 + x)`` above, the polynomials contracted
    into fused multiply-adds.  In float32 the log is XLA's own inline
    polynomial (also contracted), emulated here and held equal on all
    2**23 float32 uniforms; in float64 it is a call to the C library's
    ``log``, which the port makes on the host (``math.log``);
  * ``pow`` (:func:`powf`, :func:`pow64`): XLA calls the C library's
    ``powf`` / ``pow``.  glibc's ``powf`` (the ``__powf_fma`` build,
    tables below as glibc 2.28+ ships them) is not correctly rounded —
    rounding a float64 pow to float32 differs from it on ~0.06% of
    inputs — so :func:`powf` runs its algorithm: a 16-entry log2 table
    and polynomial, a 32-entry exp2 table and polynomial, in float64
    with the fused multiply-adds of the FMA build (``prng.fma``).
    Float64 ``pow`` is glibc's own, called on the host (``math.pow``).

Float64 is the CPU parity path: the two float64 host calls take CPU
tensors only, and :func:`require_host` refuses a float64 run on the card
that would need them (fault outages, score exponents) before it starts.
The card runs float32, whose twins are device ops.  Every helper takes
and returns tensors on one device; constants live in per-device caches,
so no host→device copy happens after the first call.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

from pivot_tpu_torch.parallel.ensemble.prng import fma

__all__ = ["neg_log1p_neg", "pow64", "powf", "require_host", "xla_pow"]


def require_host(dtype, device, what: str) -> None:
    """Raise ``ValueError`` where a float64 run off the CPU would need
    the C library's float64 ``log`` / ``pow`` (``what`` names the
    feature): those run on the host, so float64 is the CPU parity path
    and the card runs float32."""
    if dtype == torch.float64 and torch.device(device).type != "cpu":
        raise ValueError(
            f"float64 {what} round as the C library's float64 log/pow, "
            f"which run on the host: float64 is the CPU parity path "
            f"(torch_device='cpu'); use float32 on {torch.device(device)}")


def _h(text: str) -> float:
    """A float from the big-endian hex of its float64 bits (LLVM's
    spelling of a constant)."""
    return struct.unpack(">d", bytes.fromhex(text))[0]


# -- log1p: XLA's inline expansion ---------------------------------------

#: Cephes rational approximation of log1p below sqrt(2) - 1, Horner in
#: x = -u, leading coefficients first (float32 / float64 roundings of
#: the same constants).
_DEN = {
    torch.float32: [_h(s) for s in (
        "402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
        "4073519460000000", "406B0DB140000000", "404E0F3040000000")],
    torch.float64: [_h(s) for s in (
        "402E20359E903E37", "4054C30B52213498", "406BB86590FCFB56",
        "407351945DC908A5", "406B0DB13E48E066", "404E0F304466448E")],
}
_NUM = {
    torch.float32: [_h(s) for s in (
        "3F07BC0960000000", "3FDFE818A0000000", "401A509F40000000",
        "403DE97380000000", "404E798EC0000000", "404C8E75A0000000",
        "40340A2020000000")],
    torch.float64: [_h(s) for s in (
        "3F07BC0962B395CA", "3FDFE818A0FE1A83", "401A509F46F4FA53",
        "403DE9738B8CB9C9", "404E798EB86C3351", "404C8E7597479A10",
        "40340A202D99830A")],
}
_SMALL = {torch.float32: _h("3FDA8279A0000000"),
          torch.float64: _h("3FDA827999FCEF32")}
#: XLA's inline float32 log: the mantissa polynomial (three pipelined
#: pieces), the two parts of ln 2 and the sqrt(1/2) split point.
_LOG_A = [_h(s) for s in ("3FB2043760000000", "BFBD7A3700000000",
                          "3FBDE4A340000000")]
_LOG_B = [_h(s) for s in ("BFBFCBA9E0000000", "3FC23D37E0000000",
                          "BFC555CA00000000")]
_LOG_C = [_h(s) for s in ("3FC999D580000000", "BFCFFFFF80000000",
                          "3FD5555540000000")]
_LN2_LO = _h("BF2BD01060000000")
_LN2_HI = _h("3FE6300000000000")
_SQRT_HALF = _h("3FE6A09E60000000")


def _log_f32(y: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's inline float32 ``log`` of positive finite ``y``."""
    y = torch.clamp_min(y, 2.0 ** -126)
    bits = y.view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    low = m < _SQRT_HALF
    x = (m + -1.0) + torch.where(low, m, 0.0)
    e = torch.where(low, e - 1.0, e)
    z = x * x
    xc = z * x
    a = fma(fma(x, _LOG_A[0], torch.full_like(x, _LOG_A[1])), x,
            torch.full_like(x, _LOG_A[2]))
    b = fma(fma(x, _LOG_B[0], torch.full_like(x, _LOG_B[1])), x,
            torch.full_like(x, _LOG_B[2]))
    c = fma(fma(x, _LOG_C[0], torch.full_like(x, _LOG_C[1])), x,
            torch.full_like(x, _LOG_C[2]))
    b = fma(a, xc, b)
    c = fma(b, xc, c)
    r = fma(c, xc, e * _LN2_LO)
    s = fma(z, -0.5, x)
    return fma(e, _LN2_HI, s + r)


def _log_f64_host(y: torch.Tensor) -> torch.Tensor:
    """The C library's float64 ``log``, element by element, of a CPU
    tensor."""
    require_host(y.dtype, y.device, "fault outages")
    flat = y.detach().reshape(-1).tolist()
    out = torch.tensor([math.log(v) for v in flat], dtype=torch.float64)
    return out.reshape(y.shape)


def neg_log1p_neg(u: torch.Tensor) -> torch.Tensor:
    """``-log1p(-u)`` as XLA:CPU computes it, for ``u`` in ``[0, 1)``
    (``jax.random.exponential``'s transform of a uniform draw)."""
    dt = u.dtype
    if dt not in _DEN:
        raise ValueError(f"float32 or float64, got {dt}")
    den = torch.ones_like(u)
    for k in _DEN[dt]:
        den = fma(-u, den, torch.full_like(u, k))
    num = torch.full_like(u, _NUM[dt][0])
    for k in _NUM[dt][1:]:
        num = fma(-u, num, torch.full_like(u, k))
    u2 = u * u
    small = fma(u2, -0.5, -((u2 * u) * (num / den))) - u
    large = _log_f32(1.0 - u) if dt == torch.float32 else \
        _log_f64_host(1.0 - u)
    return -torch.where(u.abs() < _SMALL[dt], small, large)


# -- pow: glibc's powf (the FMA build) and pow ---------------------------

#: glibc ``__powf_log2_data``: (1/c, log2 c) over 16 subintervals of
#: [0x3f330000, 2·0x3f330000) and the log2(1 + r) polynomial.
_POWF_TAB = [(float.fromhex(a), float.fromhex(b)) for a, b in (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1.0000000000000p+0", "0x0.0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2"),
)]
_POWF_POLY = [float.fromhex(s) for s in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0")]
_POWF_OFF = 0x3F330000
#: glibc ``__exp2f_data``: 2**(i/32) with i << 47 taken off its bits,
#: the 2**r polynomial and the rounding shift 1.5·2**52 / 32.
_EXP2F_TAB = [int(s, 16) for s in (
    "3ff0000000000000", "3fefd9b0d3158574", "3fefb5586cf9890f",
    "3fef9301d0125b51", "3fef72b83c7d517b", "3fef54873168b9aa",
    "3fef387a6e756238", "3fef1e9df51fdee1", "3fef06fe0a31b715",
    "3feef1a7373aa9cb", "3feedea64c123422", "3feece086061892d",
    "3feebfdad5362a27", "3feeb42b569d4f82", "3feeab07dd485429",
    "3feea47eb03a5585", "3feea09e667f3bcd", "3fee9f75e8ec5f74",
    "3feea11473eb0187", "3feea589994cce13", "3feeace5422aa0db",
    "3feeb737b0cdc5e5", "3feec49182a3f090", "3feed503b23e255d",
    "3feee89f995ad3ad", "3feeff76f2fb5e47", "3fef199bdd85529c",
    "3fef3720dcef9069", "3fef5818dcfba487", "3fef7c97337b9b5f",
    "3fefa4afa2a490da", "3fefd0765b6e4540")]
_EXP2F_POLY = [float.fromhex(s) for s in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1")]
_EXP2F_SHIFT = float.fromhex("0x1.8p+47")

_tables: dict = {}


def _device_tables(device):
    """(log2 table [16, 2] float64, exp2 table [32] int64) on ``device``."""
    key = str(device)
    if key not in _tables:
        _tables[key] = (
            torch.tensor(_POWF_TAB, dtype=torch.float64, device=device),
            torch.tensor(np.array(_EXP2F_TAB, dtype=np.uint64).view(np.int64),
                         device=device),
        )
    return _tables[key]


def powf(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """glibc's ``powf(x, y)`` for float32 ``x >= 0`` and float32
    exponents ``y`` broadcasting against ``x``, as XLA:CPU calls it (the
    FMA build of glibc 2.28+, under XLA's denormals-are-zero and
    flush-to-zero modes): the same bits for zero, subnormal, normal and
    infinite bases and every exponent.  glibc normalises a subnormal
    base as ``bits(x · 2**23) − (23 << 23)``; with denormals read as
    zero the product is 0, so the twin takes ``−(23 << 23)`` there (not
    the base's power: XLA's own result).  A result below the smallest
    normal float32 is flushed to zero; an overflow rounds to ``inf`` by
    itself."""
    log2_tab, exp2_tab = _device_tables(x.device)
    ix = x.view(torch.int32).to(torch.int64)
    ix = torch.where(ix < 0x00800000, -(23 << 23), ix)
    # log2 x = log1p(z/c - 1)/ln 2 + log2 c + k, x = 2**k z.
    tmp = ix - _POWF_OFF
    i = (tmp >> 19) & 15
    top = tmp & -0x800000  # 0xff800000 as a sign-extended int32
    z = (ix - top).to(torch.int32).view(torch.float32).to(torch.float64)
    k = (top >> 23).to(torch.float64)
    row = log2_tab[i]
    r = fma(z, row[..., 0], torch.full_like(z, -1.0))
    y0 = row[..., 1] + k
    r2 = r * r
    a = fma(r, _POWF_POLY[0], torch.full_like(r, _POWF_POLY[1]))
    p = fma(r, _POWF_POLY[2], torch.full_like(r, _POWF_POLY[3]))
    r4 = r2 * r2
    q = fma(r, _POWF_POLY[4], y0)
    q = fma(p, r2, q)
    logx = fma(a, r4, q)
    xd = y.to(torch.float64) * logx
    # exp2: x = k/32 + r, 2**x = 2**(k/32) · 2**r.
    kd = xd + _EXP2F_SHIFT
    ki = kd.view(torch.int64)
    kd = kd - _EXP2F_SHIFT
    r = xd - kd
    s = (exp2_tab[ki & 31] + (ki << 47)).view(torch.float64)
    zc = fma(r, _EXP2F_POLY[0], torch.full_like(r, _EXP2F_POLY[1]))
    r2 = r * r
    w = fma(r, _EXP2F_POLY[2], torch.ones_like(r))
    out = (fma(zc, r2, w) * s).to(torch.float32)
    out = torch.where(out < 2.0 ** -126, 0.0, out)
    # Special cases: x == 0 (0, or inf for y < 0), x == inf (inf, or 0
    # for y < 0) and y == 0 (1).
    neg = y < 0
    out = torch.where(x == 0, torch.where(neg, float("inf"), 0.0), out)
    out = torch.where(x == float("inf"), torch.where(neg, 0.0,
                                                     float("inf")), out)
    return torch.where(y == 0, 1.0, out).to(torch.float32)


def pow64(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The C library's float64 ``pow``, element by element, of CPU
    tensors."""
    require_host(torch.float64, x.device, "score exponents")
    xb, yb = torch.broadcast_tensors(x.detach(),
                                     y.detach().to(torch.float64))
    out = np.frompyfunc(math.pow, 2, 1)(xb.numpy(), yb.numpy())
    return torch.from_numpy(np.asarray(out, dtype=np.float64))  # graftcheck: ignore[dtype] -- the CPU parity path: require_host above refuses it off the CPU


def xla_pow(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x ** y`` with XLA:CPU's rounding in ``x``'s dtype."""
    if x.dtype == torch.float32:
        return powf(x, y)
    if x.dtype == torch.float64:
        return pow64(x, y)
    raise ValueError(f"float32 or float64, got {x.dtype}")
