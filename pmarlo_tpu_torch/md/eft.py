"""Error-free transformations: double-float (df32) arithmetic in float32.

Port of ``pmarlo_tpu/md/eft.py``. A value is carried as an unevaluated
(hi, lo) pair of float32 tensors with ~2x the mantissa bits (49 vs 24),
using only float32 adds and multiplies: Dekker/Knuth error-free transforms.
The smooth-PME spreading of ``md/pme.py`` uses them for the fractional
coordinates and the spline weights (``spread_charges_precise``).

Every transform assumes that each float32 operation rounds once. Eager
PyTorch ops do so on the CPU and on the card; a compiler that contracts
``a * b - p`` into a fused multiply-add would break ``two_prod``, so these
functions stay eager (no ``torch.compile``, no fused kernel).

References: Dekker 1971 (two_prod splitting), Knuth TAOCP v2 (two_sum).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

#: Dekker split constant for float32 (24-bit mantissa): 2^12 + 1
_SPLIT = 4097.0

Df = Tuple[torch.Tensor, torch.Tensor]  # (hi, lo) unevaluated sum


def two_sum(a, b) -> Df:
    """Knuth branch-free: a + b = s + e exactly (float32)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b) -> Df:
    """Dekker: requires |a| >= |b| (or a == 0); a + b = s + e exactly."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a) -> Df:
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b) -> Df:
    """Dekker: a * b = p + e exactly (no FMA needed)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# --- df32 arithmetic on (hi, lo) pairs --------------------------------------


def df(x) -> Df:
    """Lift a float32 tensor to df32 (exact)."""
    return x, torch.zeros_like(x)


def df_const(value: float, dtype=None) -> Tuple[float, float]:
    """Split a host float64 scalar into an exact (hi, lo) float32 pair.
    ``dtype`` is accepted and unused, as in JAX."""
    hi = np.float32(value)
    lo = np.float32(value - np.float64(hi))
    return float(hi), float(lo)


def df_add(x: Df, y: Df) -> Df:
    sh, se = two_sum(x[0], y[0])
    se = se + (x[1] + y[1])
    return fast_two_sum(sh, se)


def df_neg(x: Df) -> Df:
    return -x[0], -x[1]


def df_sub(x: Df, y: Df) -> Df:
    return df_add(x, df_neg(y))


def df_mul(x: Df, y: Df) -> Df:
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return fast_two_sum(p, e)


def df_scale(x: Df, c_hi, c_lo) -> Df:
    """Multiply by a split constant (c_hi, c_lo)."""
    p, e = two_prod(x[0], c_hi)
    e = e + (x[0] * c_lo + x[1] * c_hi)
    return fast_two_sum(p, e)


def df_inv(a) -> Df:
    """1/a as a df32 pair by one Newton residual step: y = fl(1/a),
    r = 1 - y a computed exactly (two_prod), correction y r. Relative
    accuracy ~2^-45: the fractional coordinates of a box that changes (the
    NPT path), where no host float64 split of S = Hinv K exists."""
    y = 1.0 / a
    p, e = two_prod(y, a)
    r = (1.0 - p) - e
    return fast_two_sum(y, y * r)


def df_where(cond, x: Df, y: Df) -> Df:
    return torch.where(cond, x[0], y[0]), torch.where(cond, x[1], y[1])


def df_abs(x: Df) -> Df:
    neg = x[0] < 0
    return df_where(neg, df_neg(x), x)


def df_max0(x: Df) -> Df:
    """max(x, 0) elementwise on the df32 value."""
    pos = (x[0] > 0) | ((x[0] == 0) & (x[1] > 0))
    z = torch.zeros_like(x[0])
    return df_where(pos, x, (z, z))


__all__ = [
    "Df", "two_sum", "fast_two_sum", "two_prod", "df", "df_const",
    "df_add", "df_sub", "df_neg", "df_mul", "df_scale", "df_where",
    "df_abs", "df_max0", "df_inv",
]
