"""Copy of cairo_tpu.cpuref.transform: the integer 8x8 DCT-II forward/inverse,
batched over blocks (transform.cpp), and the 4x4 and 16x16 library transforms.

The wire format's "16x16" luma transform is four independent 8x8 DCTs on the
quadrants (transform.cpp:485-494), so the 8x8 block is the universal unit.

Exact semantics per line (transform.cpp:264-284, 330-349):
  forward:  t_i = sum_k src[k]*B[i,k];  DC row: (t*45)/128, AC: t/2 (both C
            truncating division); then rounded_div(t, 128); int16 store.
  inverse:  per-term scaling before accumulation — k==0: (v*B*45)/128,
            k>0: (v*B)/2; sum; rounded_div(sum, 128); int16 store.
Row pass then column pass for the forward; column pass then row pass for the
inverse. The intermediate is an int16 scratch block, so each pass wraps.
"""

from __future__ import annotations

import numpy as np

from . import tables
from .xmath import rounded_div, trunc_div

_B = tables.DCT_BASIS_8.astype(np.int32)  # B[i, k] = basis row i, sample k


def _fwd_1d(x: np.ndarray) -> np.ndarray:
    """Forward pass over the last axis of (..., 8) int32 samples."""
    t = x @ _B.T  # t[..., i] = sum_k x[..., k] * B[i, k]
    dc = trunc_div(t[..., :1] * 45, 128)
    ac = trunc_div(t[..., 1:], 2)
    return rounded_div(np.concatenate([dc, ac], axis=-1), 128).astype(np.int16)


def _inv_1d(v: np.ndarray) -> np.ndarray:
    """Inverse pass: (..., 8) coefficients -> (..., 8) samples."""
    terms = v[..., :, None] * _B[None, :, :]          # (..., k, i)
    total = trunc_div(terms[..., 0, :] * 45, 128) + trunc_div(terms[..., 1:, :], 2).sum(axis=-2)
    return rounded_div(total, 128).astype(np.int16)


def fdct8(blocks: np.ndarray) -> np.ndarray:
    """Forward 8x8 DCT over (..., 8, 8) int16 blocks (rows, then columns)."""
    t = _fwd_1d(blocks.astype(np.int32))
    return _fwd_1d(t.swapaxes(-1, -2).astype(np.int32)).swapaxes(-1, -2)


def idct8(blocks: np.ndarray) -> np.ndarray:
    """Inverse 8x8 DCT over (..., 8, 8) int16 blocks (columns, then rows)."""
    x = blocks.astype(np.int32)
    t = _inv_1d(x.swapaxes(-1, -2)).swapaxes(-1, -2).astype(np.int32)
    return _inv_1d(t)


# ---------------------------------------------------------------------------
# 4x4 family (transform.cpp:36-175) and true 16x16 line transforms
# (transform.cpp:455-496, 497-521). The pipeline never runs these — the
# wire's "16x16" is four 8x8 quadrants — but they are part of the library
# surface. The 4x4 composed transforms use the `_fast` line semantics
# (arithmetic shifts; products wrap in int32 like the as-built C).

_B4 = tables.DCT_BASIS_4.astype(np.int64)
_B16 = tables.DCT_BASIS_16.astype(np.int64)


def _wrap32(v: np.ndarray) -> np.ndarray:
    return ((v + 0x80000000) % 0x100000000 - 0x80000000).astype(np.int64)


def _fwd4_1d(x: np.ndarray) -> np.ndarray:
    """transform_4x4_line_fast: dc >>1; ac (total*2896)>>12 (both floor)."""
    t = _wrap32(x.astype(np.int64) @ _B4.T)
    dc = t[..., :1] >> 1
    ac = _wrap32(t[..., 1:] * 2896) >> 12
    return rounded_div(np.concatenate([dc, ac], axis=-1),
                       128).astype(np.int16)


def _inv4_1d(v: np.ndarray) -> np.ndarray:
    """inverse_transform_4x4_line_fast."""
    terms = _wrap32(v[..., :, None].astype(np.int64) * _B4[None, :, :])
    t0 = terms[..., 0, :] >> 1
    tk = (_wrap32(terms[..., 1:, :] * 2896) >> 12).sum(axis=-2)
    return rounded_div(_wrap32(t0 + tk), 128).astype(np.int16)


def fdct4(blocks: np.ndarray) -> np.ndarray:
    """Forward 4x4 DCT over (..., 4, 4) int16 blocks (transform_4x4)."""
    t = _fwd4_1d(blocks.astype(np.int64))
    return _fwd4_1d(t.swapaxes(-1, -2).astype(np.int64)).swapaxes(-1, -2)


def idct4(blocks: np.ndarray) -> np.ndarray:
    """Inverse 4x4 DCT over (..., 4, 4) blocks (inverse_transform_4x4:
    vertical pass, then horizontal)."""
    x = blocks.astype(np.int64)
    t = _inv4_1d(x.swapaxes(-1, -2)).swapaxes(-1, -2).astype(np.int64)
    return _inv4_1d(t)


def fdct16_line(lines: np.ndarray) -> np.ndarray:
    """transform_16x16_line over (..., 16) int16 sample vectors."""
    t = _wrap32(lines.astype(np.int64) @ _B16.T)
    dc = _wrap32(t[..., :1] * 32)
    dc = np.where(dc < 0, -((-dc) // 128), dc // 128)  # C trunc division
    ac = _wrap32(t[..., 1:] * 45)
    ac = np.where(ac < 0, -((-ac) // 128), ac // 128)
    return rounded_div(np.concatenate([dc, ac], axis=-1),
                       128).astype(np.int16)


def idct16_line(lines: np.ndarray) -> np.ndarray:
    """inverse_transform_16x16_line over (..., 16) coefficient vectors."""
    terms = _wrap32(lines[..., :, None].astype(np.int64) * _B16[None, :, :])
    t0 = _wrap32(terms[..., 0, :] * 32)
    t0 = np.where(t0 < 0, -((-t0) // 128), t0 // 128)
    tk = _wrap32(terms[..., 1:, :] * 45)
    tk = np.where(tk < 0, -((-tk) // 128), tk // 128)
    total = _wrap32(t0 + tk.sum(axis=-2))
    return rounded_div(total, 128).astype(np.int16)


def fdct16(blocks: np.ndarray) -> np.ndarray:
    """True 16x16 DCT composed from the line transform (rows then columns,
    mirroring the 4x4/8x8 composition order)."""
    t = fdct16_line(blocks.astype(np.int64))
    return fdct16_line(t.swapaxes(-1, -2).astype(np.int64)).swapaxes(-1, -2)


def idct16(blocks: np.ndarray) -> np.ndarray:
    """True 16x16 inverse DCT (columns then rows)."""
    x = blocks.astype(np.int64)
    t = idct16_line(x.swapaxes(-1, -2)).swapaxes(-1, -2).astype(np.int64)
    return idct16_line(t)
