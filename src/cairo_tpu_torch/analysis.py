"""Block analysis metrics on torch tensors: the counterpart of
cairo_tpu.analysis (analysis.h:40-221).

The codec pipeline computes SAD/MAD/variance2 inline (gpu/motion.py,
gpu/ops.py); this module exposes the full analysis.h surface as batched
tensor functions, with the as-built quirks kept: compute_block_variance
accumulates |x - mean| (the squared term is commented out in the
reference, analysis.h:170), compute_block_variance3 subtracts a mean that
is never assigned, i.e. zero (analysis.h:204-216), and the one-argument
SAD and the nonzero mean take the reference's saturating int16 abs.

Inputs are (..., 16, 16) luma (and (..., 8, 8) chroma for MAD) integer
tensors or arrays; every function reduces the trailing two axes and
returns int32 tensors. A tensor is computed on its own device; a numpy
array goes to `device` first. Sums are int32 and wrap as in the C: torch's
default sum of an int32 tensor is int64, so every reduction names its
dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from .gpu.ops import rounded_div_pos

I32 = torch.int32
DIMS = (-1, -2)


def _i32(a, device):
    """int32 with C's wrap, on the tensor's own device (an array on
    `device`)."""
    if not torch.is_tensor(a):
        a = torch.as_tensor(np.asarray(a), device=device)
    return a.to(torch.int64).to(I32)


def _home(device, *args):
    """The device of the first tensor argument, else `device`."""
    for a in args:
        if torch.is_tensor(a):
            return a.device
    return torch.device(device)


def _abs16(v):
    """The reference's saturating int16 abs: |-32768| = 32767
    (math.h:196-202); torch.abs leaves -32768 as it is."""
    return torch.where(v == -32768, 32767, torch.abs(v))


def block_sad(left, right=None, *, device="cuda"):
    """Sum of absolute differences, luma only (analysis.h:42-68).
    One-argument form treats `left` as a delta block, whose samples go
    through the int16-saturating abs."""
    dev = _home(device, left, right)
    if right is None:
        return _abs16(_i32(left, dev)).sum(DIMS, dtype=I32)
    d = _i32(left, dev) - _i32(right, dev)
    return torch.abs(d).sum(DIMS, dtype=I32)


def block_mse(left, right, *, device="cuda"):
    """Mean squared error: SSD >> 8 (analysis.h:71-84)."""
    return block_ssd(left, right, device=device) >> 8


def block_ssd(left, right, *, device="cuda"):
    """Sum of squared differences (analysis.h:86-100), int32 wrap."""
    dev = _home(device, left, right)
    d = _i32(left, dev) - _i32(right, dev)
    return (d * d).sum(DIMS, dtype=I32)


def block_mad(left_y, left_u, left_v, right_y, right_u, right_v, *,
              device="cuda"):
    """Maximum absolute difference INCLUDING chroma — the metric that
    gates skip decisions (analysis.h:103-125)."""
    dev = _home(device, left_y, left_u, left_v, right_y, right_u, right_v)
    m = None
    for a, b in ((left_y, right_y), (left_u, right_u), (left_v, right_v)):
        d = torch.abs(_i32(a, dev) - _i32(b, dev)).amax(DIMS)
        m = d if m is None else torch.maximum(m, d)
    return m


def block_mean(y, *, device="cuda"):
    """(sum + 128) >> 8 (analysis.h:128-139)."""
    s = _i32(y, _home(device, y)).sum(DIMS, dtype=I32)
    return (s + 128) >> 8


def nonzero_block_mean(y, *, device="cuda"):
    """rounded_div(sum |nonzero|, count), 0 if none (analysis.h:141-157),
    wrapped to the reference's int16 return type. Samples go through the
    int16-saturating abs."""
    v = _i32(y, _home(device, y))
    nz = v != 0
    s = torch.where(nz, _abs16(v), 0).sum(DIMS, dtype=I32)
    count = nz.sum(DIMS, dtype=I32)
    out = torch.where(count > 0,
                      rounded_div_pos(s, torch.clamp(count, min=1)), 0)
    return out.to(torch.int16).to(I32)


def block_variance(y, *, device="cuda"):
    """As built: the SQUARE is commented out in the reference, so this is
    (sum |x - mean| + 128) >> 8 (analysis.h:159-174)."""
    v = _i32(y, _home(device, y))
    mean = block_mean(v)
    s = torch.abs(v - mean[..., None, None]).sum(DIMS, dtype=I32)
    return (s + 128) >> 8


def block_variance2(y, *, device="cuda"):
    """Sum of squares minus rounded mean-square over nonzero non-DC cells
    (analysis.h:176-198), the adaptive-QP metric; sum*sum wraps in int32
    like the as-built reference (docs/FORMAT.md §5)."""
    v = _i32(y, _home(device, y))
    mask = v != 0
    mask[..., 0, 0] = False
    count = mask.sum(DIMS, dtype=I32)
    s = torch.where(mask, v, 0).sum(DIMS, dtype=I32)
    ss = torch.where(mask, v * v, 0).sum(DIMS, dtype=I32)
    var = ss - rounded_div_pos(s * s, torch.clamp(count, min=1))
    return torch.where(count > 0, var, 0)


def block_variance3(y, *, device="cuda"):
    """As built: starts from the nonzero mean but subtracts a `mean`
    variable that is never assigned (always 0), then rounded-divides by
    the nonzero non-DC count (analysis.h:200-221); int16 return type."""
    v = _i32(y, _home(device, y))
    nz = v != 0
    nz[..., 0, 0] = False
    s = nonzero_block_mean(v) + torch.where(nz, torch.abs(v), 0).sum(
        DIMS, dtype=I32)
    count = nz.sum(DIMS, dtype=I32)
    out = torch.where(count > 0,
                      rounded_div_pos(s, torch.clamp(count, min=1)), 0)
    return out.to(torch.int16).to(I32)


def format_macroblock(y, u=None, v=None) -> str:
    """print_macroblock equivalent (macroblock.h:104-155): a debug dump of
    the per-plane sample grids as text (host)."""
    parts = []
    for name, plane in (("Y", y), ("U", u), ("V", v)):
        if plane is None:
            continue
        if torch.is_tensor(plane):
            plane = plane.cpu().numpy()
        plane = np.asarray(plane)
        parts.append(f"{name} ({plane.shape[0]}x{plane.shape[1]}):")
        for row in plane:
            parts.append(" ".join(f"{int(x):6d}" for x in row))
    return "\n".join(parts)


def print_macroblock(y, u=None, v=None):
    print(format_macroblock(y, u, v))
