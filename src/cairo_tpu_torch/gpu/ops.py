"""Exact-integer device primitives on torch tensors (counterpart of
cairo_tpu/tpu/ops.py).

Same C arithmetic contract (docs/FORMAT.md §5): truncating division,
rounded_div half away from zero, int16 intermediate wraps. Compute dtype
is int32 throughout; int16 wrap points are explicit. Two traps differ
from JAX and are handled here:
  * torch `//` floors: truncating division is built from the floor of
    non-negative operands exactly as the JAX package builds it (which
    also keeps abs(INT32_MIN) behaving the same);
  * CUDA has no integer matmul, and an int32 tensor mixed with an int64
    one promotes to int64 and loses the int32 wrap. The DCTs are explicit
    int32 sums, every constant is an int32 tensor, and every reduction
    names dtype=torch.int32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables

MB = tables.MACROBLOCK_SIZE
I32 = torch.int32


def settled(device, made):
    """`made`, once the current stream has written it. The cached device
    constants are read by the compute streams of every encoder and decoder
    (gpu/pipeline.py), which do not wait on the stream that made them."""
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return made


@functools.lru_cache(maxsize=None)
def _tables(device: str) -> dict:
    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return settled(device, dict(
        B=t(tables.DCT_BASIS_8), B4=t(tables.DCT_BASIS_4),
        B16=t(tables.DCT_BASIS_16), INTRA_QM=t(tables.INTRA_QM_8x8),
        INTER_QM=t(tables.INTER_QM_8x8),
        LUMA_DC=t(tables.luma_dc_scale(np.arange(256))),
        CHROMA_DC=t(tables.chroma_dc_scale(np.arange(256)))))


def consts(device) -> dict:
    return _tables(str(torch.device(device)))


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def trunc_div(numer, denom):
    """C integer division (truncation toward zero)."""
    q = _floordiv(torch.abs(numer), abs(denom))
    return torch.where((numer < 0) != (denom < 0), -q, q)


def trunc_div_pos(numer, denom_pos):
    """Truncating division for a positive divisor."""
    q = _floordiv(torch.abs(numer), denom_pos)
    return torch.where(numer < 0, -q, q)


def rounded_div_pos(numer, denom_pos):
    """math.h:228-236 for positive divisors."""
    half = _floordiv(denom_pos, 2) if torch.is_tensor(denom_pos) \
        else denom_pos // 2
    return trunc_div_pos(torch.where(numer < 0, numer - half, numer + half),
                         denom_pos)


def wrap16(v):
    """Wrap int32 -> int16 two's complement, kept as int32."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def round_out(v, amount):
    return torch.where(v < 0, v - amount, v + amount)


def sign(v):
    return torch.sign(v)


def ilog2_u32(v):
    """Integer log2 of a uint32-interpreted int32 value; log2(0)=0."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    out = torch.zeros(v.shape, dtype=I32, device=v.device)
    for shift in (16, 8, 4, 2, 1):
        hit = v >= (1 << shift)
        out = out + torch.where(hit, shift, 0).to(I32)
        v = torch.where(hit, v >> shift, v)
    return out


# --------------------------------------------------------------- transform

def fdct8(blocks):
    """Forward 8x8 integer DCT over (..., 8, 8) int32 blocks."""
    b = consts(blocks.device)["B"]

    def pass1d(x):
        t = (x[..., None, :] * b).sum(-1, dtype=I32)   # x @ B.T
        dc = trunc_div_pos(t[..., :1] * 45, 128)
        ac = trunc_div_pos(t[..., 1:], 2)
        return wrap16(rounded_div_pos(torch.cat([dc, ac], -1), 128))

    t = pass1d(blocks.to(I32))
    return pass1d(t.transpose(-1, -2)).transpose(-1, -2)


def idct8(blocks):
    """Inverse 8x8 integer DCT over (..., 8, 8) int32 coefficient blocks,
    with the reference's per-term scaling (transform.cpp:330-349)."""
    b = consts(blocks.device)["B"]

    def pass1d(v):
        terms = v[..., :, None] * b
        total = trunc_div_pos(terms[..., 0, :] * 45, 128) \
            + trunc_div_pos(terms[..., 1:, :], 2).sum(-2, dtype=I32)
        return wrap16(rounded_div_pos(total, 128))

    x = blocks.to(I32)
    t = pass1d(x.transpose(-1, -2)).transpose(-1, -2)
    return pass1d(t)


# -- 4x4 family and true 16x16 line transforms (library parity; the
#    counterparts of tpu/ops.py:153-218, transform.cpp:36-175, 455-521).
#    No path calls them: the wire's 16x16 is four 8x8 quadrants. int32
#    products and sums wrap like the as-built C; `>>` is arithmetic.

def _fwd4_1d(x, b4):
    t = (x[..., None, :] * b4).sum(-1, dtype=I32)     # x @ B4.T
    dc = t[..., :1] >> 1
    ac = (t[..., 1:] * 2896) >> 12
    return rounded_div_pos(torch.cat([dc, ac], -1), 128)


def _inv4_1d(v, b4):
    terms = v[..., :, None] * b4
    t0 = terms[..., 0, :] >> 1
    tk = ((terms[..., 1:, :] * 2896) >> 12).sum(-2, dtype=I32)
    return rounded_div_pos(t0 + tk, 128)


def fdct4(blocks):
    """Forward 4x4 DCT over (..., 4, 4) int blocks (transform_4x4)."""
    b4 = consts(blocks.device)["B4"]
    t = wrap16(_fwd4_1d(blocks.to(I32), b4))
    return wrap16(_fwd4_1d(t.transpose(-1, -2), b4).transpose(-1, -2))


def idct4(blocks):
    """Inverse 4x4 DCT (vertical pass then horizontal)."""
    b4 = consts(blocks.device)["B4"]
    x = blocks.to(I32)
    t = wrap16(_inv4_1d(x.transpose(-1, -2), b4).transpose(-1, -2))
    return wrap16(_inv4_1d(t, b4))


def fdct16_line(lines):
    """transform_16x16_line over (..., 16) int sample vectors."""
    b16 = consts(lines.device)["B16"]
    t = (lines.to(I32)[..., None, :] * b16).sum(-1, dtype=I32)
    dc = trunc_div_pos(t[..., :1] * 32, 128)
    ac = trunc_div_pos(t[..., 1:] * 45, 128)
    return wrap16(rounded_div_pos(torch.cat([dc, ac], -1), 128))


def idct16_line(lines):
    """inverse_transform_16x16_line over (..., 16) coefficient vectors."""
    b16 = consts(lines.device)["B16"]
    terms = lines.to(I32)[..., :, None] * b16
    t0 = trunc_div_pos(terms[..., 0, :] * 32, 128)
    tk = trunc_div_pos(terms[..., 1:, :] * 45, 128).sum(-2, dtype=I32)
    return wrap16(rounded_div_pos(t0 + tk, 128))


def fdct16(blocks):
    """True 16x16 DCT composed from the line transform (rows, then
    columns)."""
    t = fdct16_line(blocks)
    return fdct16_line(t.transpose(-1, -2)).transpose(-1, -2)


def idct16(blocks):
    """True 16x16 inverse DCT (columns, then rows)."""
    t = idct16_line(blocks.transpose(-1, -2)).transpose(-1, -2)
    return idct16_line(t)


# ---------------------------------------------------------------- quantize

def quantize_8x8(blocks, qp, intra: bool, is_luma: bool):
    """(N, 8, 8) int32 blocks, (N,) qp -> quantized int32 (int16-wrapped)."""
    c = consts(blocks.device)
    v = blocks.to(I32)
    qp = qp.to(I32)[:, None, None]
    if intra:
        out = wrap16(rounded_div_pos(
            rounded_div_pos(v * tables.QUANTIZER_SCALE_FACTOR, c["INTRA_QM"]),
            qp << 1))
        dc_scale = (c["LUMA_DC"] if is_luma else c["CHROMA_DC"])[
            qp[:, 0, 0].long()]
        out[:, 0, 0] = wrap16(rounded_div_pos(v[:, 0, 0], dc_scale))
        return out
    qf = wrap16(rounded_div_pos(v * tables.QUANTIZER_SCALE_FACTOR,
                                c["INTER_QM"]))
    return wrap16(rounded_div_pos(qf - sign(qf) * qp, qp << 1))


def dequantize_8x8(blocks, qp, intra: bool, is_luma: bool):
    c = consts(blocks.device)
    v = blocks.to(I32)
    qp = qp.to(I32)[:, None, None]
    if intra:
        out = wrap16(trunc_div_pos(2 * v * c["INTRA_QM"] * qp,
                                   tables.QUANTIZER_SCALE_FACTOR))
        dc_scale = (c["LUMA_DC"] if is_luma else c["CHROMA_DC"])[
            qp[:, 0, 0].long()]
        out[:, 0, 0] = wrap16(v[:, 0, 0] * dc_scale)
        return out
    return wrap16(trunc_div_pos(2 * v * c["INTER_QM"] * qp,
                                tables.QUANTIZER_SCALE_FACTOR))


def block_variance2(mb_y):
    """(N, 16, 16) transformed MBs -> int32 variance (FORMAT.md §5 UB rule:
    the square of the sum wraps in int32, like the as-built reference)."""
    v = mb_y.to(I32)
    mask = v != 0
    mask[:, 0, 0] = False
    count = mask.sum((1, 2), dtype=I32)
    s = torch.where(mask, v, 0).sum((1, 2), dtype=I32)
    ss = torch.where(mask, v * v, 0).sum((1, 2), dtype=I32)
    prod = s * s
    cnt = torch.clamp(count, min=1)
    var = ss - trunc_div_pos(prod + _floordiv(cnt, 2), cnt)
    return torch.where(count > 0, var, 0)


def adaptive_qp(quality, mb_y):
    """query_block_quantization_parameter over (N,16,16) transformed MBs.
    `quality` is an int32 scalar tensor or a Python int."""
    top = tables.MAX_QUANT_LEVELS - 1
    variance = block_variance2(mb_y)
    index = torch.clamp(ilog2_u32(variance) >> 1, 1, top)
    q = torch.as_tensor(quality, dtype=I32, device=mb_y.device)
    up = torch.clamp(q + ((index - q) >> 1), 1, top)
    down = torch.clamp(q - ((q - index) >> 1), 1, top)
    return torch.where(index > q, up, torch.where(index < q, down, q))


# ----------------------------------------------------------------- imaging

def rgb_to_yuv420(rgb):
    """(H, W, 3) uint8 -> (Y, U, V) int32 planes (convert.cpp semantics;
    tpu/ops.py:221-232), on the tensor's device: the tiled encode step
    converts its tile there (gpu/shard.py)."""
    r, g, b = (rgb[..., i].to(I32) for i in range(3))
    y = ((77 * r + 150 * g + 29 * b + 128) >> 8) + tables.LUMINANCE_SHIFT
    cu = trunc_div_pos(-43 * r - 85 * g + 128 * b + 128, 256) + 128
    cv = trunc_div_pos(128 * r - 107 * g - 21 * b + 128, 256) + 128
    height, width = r.shape
    u = (cu.reshape(height // 2, 2, width // 2, 2).sum(dim=(1, 3),
                                                       dtype=I32) + 2) >> 2
    v = (cv.reshape(height // 2, 2, width // 2, 2).sum(dim=(1, 3),
                                                       dtype=I32) + 2) >> 2
    return y, u, v


def yuv420_to_rgb(y, u, v):
    """int32 planes -> (H, W, 3) uint8."""
    yy = y.to(I32) - tables.LUMINANCE_SHIFT
    uu = (u.to(I32) - 128).repeat_interleave(2, 0).repeat_interleave(2, 1)
    vv = (v.to(I32) - 128).repeat_interleave(2, 0).repeat_interleave(2, 1)
    uu = uu[:yy.shape[0], :yy.shape[1]]
    vv = vv[:yy.shape[0], :yy.shape[1]]
    r = (256 * yy + 358 * vv + 128) >> 8
    g = (256 * yy - 88 * uu - 182 * vv + 128) >> 8
    b = (256 * yy + 452 * uu + 128) >> 8
    return torch.clamp(torch.stack([r, g, b], -1), 0, 255).to(torch.uint8)


def lerp_half(a, b):
    t = a.to(I32) + b.to(I32)
    return wrap16(trunc_div_pos(round_out(t, 1), 2))


def lerp_quarter(a, b):
    t = 3 * a.to(I32) + b.to(I32)
    return wrap16(trunc_div_pos(round_out(t, 2), 4))


# ------------------------------------------------------------ block layout

def plane_to_blocks(plane, size):
    """(H, W) -> (H//size * W//size, size, size), raster block order."""
    height, width = plane.shape
    return plane.reshape(height // size, size, width // size, size) \
        .transpose(1, 2).reshape(-1, size, size)


def blocks_to_plane(blocks, height, width):
    size = blocks.shape[-1]
    return blocks.reshape(height // size, width // size, size, size) \
        .transpose(1, 2).reshape(height, width)


def mb_quads(y_mbs):
    """(N, 16, 16) -> (N, 4, 8, 8) quadrants TL,TR,BL,BR."""
    n = y_mbs.shape[0]
    return y_mbs.reshape(n, 2, 8, 2, 8).permute(0, 1, 3, 2, 4) \
        .reshape(n, 4, 8, 8)


def quads_to_mb(quads):
    n = quads.shape[0]
    return quads.reshape(n, 2, 2, 8, 8).permute(0, 1, 3, 2, 4) \
        .reshape(n, 16, 16)
