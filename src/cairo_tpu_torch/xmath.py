"""Copy of cairo_tpu.xmath (numpy only): the C integer helpers the port's host code calls."""

from __future__ import annotations

import numpy as np


def trunc_div(numer, denom):
    """C integer division: truncation toward zero."""
    q = abs(numer) // abs(denom)
    neg = (numer < 0) != (denom < 0)
    return np.where(neg, -q, q)


def clip_range(value, lo, hi):
    return np.where(value < lo, lo, np.where(value > hi, hi, value))

