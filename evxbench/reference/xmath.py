"""Copy of cairo_tpu.xmath (numpy only): exact C integer-arithmetic
semantics on arrays and Python ints.

- C `/` truncates toward zero (not floor) — `trunc_div`.
- `rounded_div` rounds half away from zero with sign-dependent bias
  (math.h:228-236).
- `sign` returns 0 for 0 (math.h:140-161).
- `round_out(n, a)` biases away from zero (math.h:65).
- `as_int16` wraps like a C int16 store.
"""

from __future__ import annotations

import numpy as np


def trunc_div(numer, denom):
    """C integer division: truncation toward zero."""
    q = abs(numer) // abs(denom)
    neg = (numer < 0) != (denom < 0)
    return np.where(neg, -q, q)


def rounded_div(numer, denom):
    """math.h:228-236 — round half away from zero (denom sign-aware)."""
    neg = (numer < 0) != (denom < 0)
    half = trunc_div(denom, 2)
    return np.where(neg, trunc_div(numer - half, denom),
                    trunc_div(numer + half, denom))


def sign(value):
    """Branchless sign with sign(0) == 0 (math.h:140-161)."""
    return np.where(value > 0, 1, 0) - np.where(value < 0, 1, 0)


def round_out(value, amount):
    """evx_round_out: bias away from zero; 0 biases positive (math.h:65)."""
    return np.where(value < 0, value - amount, value + amount)


def ilog2(value):
    """Integer log2 with log2(0) == 0 (math.h:88-138 LUT semantics)."""
    v = np.asarray(value)
    out = np.zeros_like(v)
    v = v.copy()
    for shift in (16, 8, 4, 2, 1):
        hit = v >= (1 << shift)
        out = out + np.where(hit, shift, 0)
        v = np.where(hit, v >> shift, v)
    return out


def clip_range(value, lo, hi):
    return np.where(value < lo, lo, np.where(value > hi, hi, value))


def saturate_u8(value):
    return clip_range(value, 0, 255)


def as_int16(value):
    """Wrap to int16 two's complement (C int16 store truncation)."""
    v = np.asarray(value).astype(np.int64) & 0xFFFF
    return np.where(v >= 0x8000, v - 0x10000, v).astype(np.int16)
