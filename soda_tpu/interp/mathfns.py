"""Composed f32 implementations of atan/asin/acos/atan2/sinh/cosh/expm1
for the pair-carrier namespace (interp/wide64.WideXP), which evaluates its
narrow f32 values with them and seeds its double-single asin from
`f32_asin`.

Built from elementary primitives only (sqrt, exp, div, where, abs,
copysign, signbit, isinf, comparisons), so the same code evaluates
bit-identically on every platform.  Accuracy ~1e-8 relative (beyond f32's 2^-24
ulp) on the primary domains; the NumPy oracle keeps native numpy fns and
the cross-backend gates absorb the ulp-level difference.

Algorithms mirror the DS versions in wide64.py (same reductions, f32
arithmetic): atan = reciprocal identity + two half-angle steps
z <- z/(1+sqrt(1+z^2)) + odd Taylor; asin = atan(x/sqrt((1-x)(1+x)));
acos = atan2(sqrt((1-x)(1+x)), x) (relatively accurate at x -> 1, unlike
pi/2 - asin); atan2 = atan(y/x) + IEEE quadrant/zero/inf fixups;
sinh/expm1 = odd/full Taylor at small |x| (keeps relative accuracy where
e^x - 1 cancels), exp form beyond; cosh = (e^|x| + e^-|x|)/2.
"""

from __future__ import annotations

import numpy as np

_PIO2 = np.float32(np.pi / 2.0)
_PI = np.float32(np.pi)

# atan Taylor (-1)^k/(2k+1), k = 5..1 (constant term applied in the last
# Horner step).  After the two half-angle steps |z| <= 0.199, so the
# truncated k=6 term is ~1.7e-9 relative — below f32 ulp.
_ATAN_COEF32 = [np.float32(-1.0 / 11.0), np.float32(1.0 / 9.0),
                np.float32(-1.0 / 7.0), np.float32(1.0 / 5.0),
                np.float32(-1.0 / 3.0)]


def f32_atan(xp, x):
    ax = xp.abs(x)
    inv = ax > np.float32(1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = xp.where(inv, np.float32(1.0) / ax, ax)
        one = np.float32(1.0)
        for _ in range(2):
            z = z / (one + xp.sqrt(one + z * z))
        z2 = z * z
        acc = xp.asarray(np.float32(1.0 / 13.0))
        for c in _ATAN_COEF32:
            acc = acc * z2 + c
        r = np.float32(4.0) * (z * (acc * z2 + one))
        r = xp.where(inv, _PIO2 - r, r)
    return xp.copysign(r, x)


def f32_asin(xp, x):
    with np.errstate(divide="ignore", invalid="ignore"):
        s = xp.sqrt((np.float32(1.0) - x) * (np.float32(1.0) + x))
        return f32_atan(xp, x / s)  # |x| = 1 -> +-inf -> +-pi/2 exactly


def f32_acos(xp, x):
    s = xp.sqrt((np.float32(1.0) - x) * (np.float32(1.0) + x))
    return f32_atan2(xp, s, x)  # range [0, pi]; accurate near x = 1


def f32_atan2(xp, y, x):
    with np.errstate(divide="ignore", invalid="ignore"):
        q = f32_atan(xp, y / x)
        sgn_y = xp.signbit(y)
        adj = xp.where(sgn_y, -_PI, _PI)
        r = xp.where(xp.signbit(x), q + adj, q)
        # x = +-0: +-pi/2 by y's sign (y = 0 refined below)
        r = xp.where(x == 0, xp.copysign(_PIO2, y), r)
        # y = +-0: magnitude pi when x's sign BIT is set (neg or -0)
        zmag = xp.where(xp.signbit(x), _PI, np.float32(0.0))
        r = xp.where(y == 0, xp.copysign(zmag, y), r)
        both = xp.isinf(y) & xp.isinf(x)
        diag = xp.where(xp.signbit(x), np.float32(3.0 * np.pi / 4.0),
                        np.float32(np.pi / 4.0))
        return xp.where(both, xp.copysign(diag, y), r)


# odd Taylor x + x^3/3! + ... + x^9/9! (sinh) and full x + x^2/2! + ...
# + x^8/8! (expm1): truncation < 3e-9 relative at the |x| < 1 / < 0.5
# switch points
_SINH_COEF = [np.float32(1.0 / 362880.0), np.float32(1.0 / 5040.0),
              np.float32(1.0 / 120.0), np.float32(1.0 / 6.0)]
_EXPM1_COEF = [np.float32(1.0 / 40320.0), np.float32(1.0 / 5040.0),
               np.float32(1.0 / 720.0), np.float32(1.0 / 120.0),
               np.float32(1.0 / 24.0), np.float32(1.0 / 6.0),
               np.float32(0.5)]


def f32_sinh(xp, x):
    ax = xp.abs(x)
    x2 = ax * ax
    acc = xp.asarray(_SINH_COEF[0])
    for c in _SINH_COEF[1:]:
        acc = acc * x2 + c
    small = ax * (acc * x2 + np.float32(1.0))
    e = xp.exp(ax)
    with np.errstate(over="ignore"):
        big = np.float32(0.5) * (e - np.float32(1.0) / e)
    v = xp.where(ax < np.float32(1.0), small, big)
    return xp.copysign(v, x)


def f32_cosh(xp, x):
    e = xp.exp(xp.abs(x))
    return np.float32(0.5) * (e + np.float32(1.0) / e)


def f32_expm1(xp, x):
    acc = xp.asarray(_EXPM1_COEF[0])
    for c in _EXPM1_COEF[1:]:
        acc = acc * x + c
    small = x * (acc * x + np.float32(1.0))
    big = xp.exp(x) - np.float32(1.0)
    return xp.where(xp.abs(x) < np.float32(0.5), small, big)


# DSL fn name -> composed impl
F32_IMPLS = {
    "atan": f32_atan, "asin": f32_asin, "acos": f32_acos,
    "sinh": f32_sinh, "cosh": f32_cosh, "expm1": f32_expm1,
}
F32_IMPLS2 = {"atan2": f32_atan2}
