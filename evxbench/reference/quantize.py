"""Copy of cairo_tpu.cpuref.quantize: variance-adaptive MPEG-style
quantization, batched over 8x8 blocks (quantize.cpp).

The intra path (used only by INTRA_DEFAULT blocks, quantize.cpp:357-367)
applies the intra QM plus a separate DC scale; everything else uses the inter
QM with a dead-zone. All arithmetic reproduces the C exactly, including the
int16 truncation of intermediate stores.
"""

from __future__ import annotations

import numpy as np

from . import tables
from .xmath import as_int16, clip_range, ilog2, rounded_div, sign, trunc_div

_SCALE = tables.QUANTIZER_SCALE_FACTOR
_INTRA_QM = tables.INTRA_QM_8x8.astype(np.int32)
_INTER_QM = tables.INTER_QM_8x8.astype(np.int32)


def _qp_col(qp):
    """Broadcasts per-block qp over (N, 8, 8)."""
    return np.asarray(qp, dtype=np.int32).reshape(-1, 1, 1)


def _fdiv(n, d, rounded):
    """Forward-quantization division: EVX_ROUNDED_QUANTIZATION selects
    round-half-away (quantize.cpp:88-173) vs plain truncation."""
    return rounded_div(n, d) if rounded else trunc_div(n, d)


def quantize_intra_8x8(blocks: np.ndarray, qp, is_luma: bool,
                       rounded: bool = True) -> np.ndarray:
    """quantize_{luma,chroma}_intra_block_8x8 (quantize.cpp:79-129)."""
    v = blocks.astype(np.int32)
    qp = _qp_col(qp)
    out = as_int16(_fdiv(_fdiv(v * _SCALE, _INTRA_QM, rounded), qp << 1,
                         rounded))
    dc_scale = (tables.luma_dc_scale if is_luma else tables.chroma_dc_scale)(
        np.asarray(qp, dtype=np.int16).reshape(-1))
    out[:, 0, 0] = as_int16(_fdiv(v[:, 0, 0], dc_scale.astype(np.int32),
                                  rounded))
    return out


def quantize_inter_8x8(blocks: np.ndarray, qp,
                       rounded: bool = True) -> np.ndarray:
    """Dead-zone inter quantization (quantize.cpp:146-163)."""
    v = blocks.astype(np.int32)
    qp = _qp_col(qp)
    qfactor = as_int16(_fdiv(v * _SCALE, _INTER_QM, rounded)).astype(np.int32)
    return as_int16(_fdiv(qfactor - sign(qfactor) * qp, qp << 1, rounded))


def inverse_quantize_intra_8x8(blocks: np.ndarray, qp, is_luma: bool) -> np.ndarray:
    """inverse_quantize_{luma,chroma}_intra_block_8x8 (quantize.cpp:182-212)."""
    v = blocks.astype(np.int32)
    qp = _qp_col(qp)
    out = as_int16(trunc_div(2 * v * _INTRA_QM * qp, _SCALE))
    dc_scale = (tables.luma_dc_scale if is_luma else tables.chroma_dc_scale)(
        np.asarray(qp, dtype=np.int16).reshape(-1))
    out[:, 0, 0] = as_int16(v[:, 0, 0] * dc_scale.astype(np.int32))
    return out


def inverse_quantize_inter_8x8(blocks: np.ndarray, qp) -> np.ndarray:
    v = blocks.astype(np.int32)
    qp = _qp_col(qp)
    return as_int16(trunc_div(2 * v * _INTER_QM * qp, _SCALE))


def quantize_intra_linear_8x8(blocks: np.ndarray, qp,
                              rounded: bool = True) -> np.ndarray:
    """H.263-style linear intra quantization (quantize.cpp:131-144; library
    parity — compiled out in the reference default config)."""
    return as_int16(_fdiv(blocks.astype(np.int32), _qp_col(qp) << 1, rounded))


def quantize_inter_linear_8x8(blocks: np.ndarray, qp,
                              rounded: bool = True) -> np.ndarray:
    """quantize.cpp:165-180."""
    v = blocks.astype(np.int32)
    qp = _qp_col(qp)
    qm = np.abs(v) - (qp >> 1)
    return as_int16(as_int16(_fdiv(qm, qp << 1, rounded)).astype(np.int32) * sign(v))


def inverse_quantize_linear_8x8(blocks: np.ndarray, qp) -> np.ndarray:
    """quantize.cpp:214-231."""
    v = blocks.astype(np.int32)
    qp = _qp_col(qp)
    mod_qp = (qp + 1) % 2
    qm = (np.abs(v) << 1) + 1
    out = (qm * qp - mod_qp) * sign(v)
    return as_int16(np.where(v == 0, 0, out))


def block_variance2(mb_y: np.ndarray) -> np.ndarray:
    """compute_block_variance2 over (N, 16, 16) luma MBs (analysis.h:176-198).

    Sum / sum-of-squares over nonzero coefficients, skipping position (0,0),
    with C int32 wraparound semantics.
    """
    v = mb_y.astype(np.int64)
    mask = v != 0
    mask[:, 0, 0] = False
    count = mask.sum(axis=(1, 2)).astype(np.int64)
    s = np.where(mask, v, 0).sum(axis=(1, 2))
    ss = np.where(mask, v * v, 0).sum(axis=(1, 2))
    # wrap accumulators to int32 like the C
    s32 = s.astype(np.int64).astype(np.uint64).astype(np.uint32).view(np.int32).astype(np.int64)
    ss32 = ss.astype(np.uint64).astype(np.uint32).view(np.int32).astype(np.int64)
    prod = (s32 * s32).astype(np.uint64).astype(np.uint32).view(np.int32).astype(np.int64)
    # sum*sum can overflow int32 — UB that gcc -O2 resolves by folding
    # rounded_div's sign test to the positive branch (a square "cannot" be
    # negative) while the multiply wraps. Match the as-built reference:
    # always-positive-branch rounding on the wrapped product.
    cnt = np.maximum(count, 1)
    var = ss32 - trunc_div(prod + trunc_div(cnt, 2), cnt)
    var32 = var.astype(np.uint64).astype(np.uint32).view(np.int32)
    return np.where(count > 0, var32, 0).astype(np.int32)


def adaptive_qp(quality: int, mb_y: np.ndarray) -> np.ndarray:
    """query_block_quantization_parameter over (N, 16, 16) transformed MBs
    (quantize.cpp:60-77). Returns (N,) uint8."""
    variance = block_variance2(mb_y)
    var_u32 = variance.view(np.uint32).astype(np.int64)
    index = clip_range(ilog2(var_u32) >> 1, 1, tables.MAX_QUANT_LEVELS - 1)
    q = int(quality)
    up = clip_range(q + ((index - q) >> 1), 1, tables.MAX_QUANT_LEVELS - 1)
    down = clip_range(q - ((q - index) >> 1), 1, tables.MAX_QUANT_LEVELS - 1)
    return np.where(index > q, up, np.where(index < q, down, q)).astype(np.uint8)
