"""Copy of cairo_tpu.tables: the evx1 wire-format constant tables."""

from __future__ import annotations

import numpy as np

MACROBLOCK_SIZE = 16
QUANTIZER_SCALE_FACTOR = 16  # quantize.cpp:9
MAX_QUANT_LEVELS = 32        # quantize.h:42

VERSION_MAJOR = 2            # version.h:36
VERSION_MINOR = 47
VERSION_WORD = ((VERSION_MAJOR & 0xFF) << 8) | (VERSION_MINOR & 0xFF)
REFERENCE_FRAME_COUNT = 4    # config.h:39
DEFAULT_QUALITY = 8          # config.h:40
PERIODIC_INTRA_RATE = 3600   # config.h:41

MOTION_SAD_THRESHOLD = 8 * 1024  # motion.cpp:19
MOTION_SEARCH_RADIUS = 16        # motion.cpp:24

LUMINANCE_SHIFT = 16         # convert.cpp:7
CHROMINANCE_SHIFT = 128      # convert.cpp:8


def _zigzag(n: int) -> np.ndarray:
    """Standard zigzag scan order for an n×n block (row-major flat indices)."""
    order = sorted(
        ((i, j) for i in range(n) for j in range(n)),
        key=lambda p: (p[0] + p[1],
                       p[1] if (p[0] + p[1]) % 2 == 0 else p[0]))
    return np.array([i * n + j for i, j in order], dtype=np.int32)


ZIGZAG_4x4 = _zigzag(4)
ZIGZAG_8x8 = _zigzag(8)

# The "16x16" zigzag is four 8x8 zigzags, one per quadrant in TL,TR,BL,BR
# order, with indices relative to a contiguous 16-wide buffer (scan.h:84-102).
_QUAD_OFFSETS = np.array([0, 8, 8 * 16, 8 * 16 + 8], dtype=np.int32)
_Z8_IN_16 = (ZIGZAG_8x8 // 8) * 16 + (ZIGZAG_8x8 % 8)
ZIGZAG_16x16 = np.concatenate([_Z8_IN_16 + off for off in _QUAD_OFFSETS])


def _dct_basis(n: int) -> np.ndarray:
    """cos(((2i+1)·jπ)/(2n)) scaled by 128 and rounded (xftables.h:40-47)."""
    j, i = np.mgrid[0:n, 0:n]
    return np.round(128.0 * np.cos((2 * i + 1) * j * np.pi / (2 * n))).astype(np.int16)


DCT_BASIS_4 = _dct_basis(4)
DCT_BASIS_8 = _dct_basis(8)
DCT_BASIS_16 = _dct_basis(16)

# Quantization matrices — wire-format constants (quantize.cpp:13-35).
INTRA_QM_8x8 = np.array([
    8, 17, 18, 19, 21, 23, 25, 27,
    17, 18, 19, 21, 23, 25, 27, 28,
    20, 21, 22, 23, 24, 26, 28, 30,
    21, 22, 23, 24, 26, 28, 30, 32,
    22, 23, 24, 26, 28, 30, 32, 35,
    23, 24, 26, 28, 30, 32, 35, 38,
    25, 26, 28, 30, 32, 35, 38, 41,
    27, 28, 30, 32, 35, 38, 41, 45], dtype=np.int16).reshape(8, 8)

INTER_QM_8x8 = np.array([
    16, 17, 18, 19, 20, 21, 22, 23,
    17, 18, 19, 20, 21, 22, 23, 24,
    18, 19, 20, 21, 22, 23, 24, 25,
    19, 20, 21, 22, 23, 24, 26, 27,
    20, 21, 22, 23, 25, 26, 27, 28,
    21, 22, 23, 24, 26, 27, 28, 30,
    22, 23, 24, 26, 27, 28, 30, 31,
    23, 24, 25, 27, 28, 30, 31, 33], dtype=np.int16).reshape(8, 8)


def luma_dc_scale(qp: np.ndarray) -> np.ndarray:
    """Intra luma DC quantizer scale (quantize.cpp:37-46)."""
    qp = np.asarray(qp, dtype=np.int16)
    return np.where(qp < 5, 8,
                    np.where(qp < 9, qp << 1,
                             np.where(qp < 25, qp + 8, (qp << 1) - 16))).astype(np.int16)


def chroma_dc_scale(qp: np.ndarray) -> np.ndarray:
    """Intra chroma DC quantizer scale (quantize.cpp:48-55)."""
    qp = np.asarray(qp, dtype=np.int16)
    return np.where(qp < 5, 8,
                    np.where(qp < 25, (qp + 13) >> 1, qp - 6)).astype(np.int16)


# In-loop deblocking thresholds per average QP — wire behavior constants
# (deblock.cpp:13-27).
DEBLOCK_ALPHA = np.array([
    0, 0, 0, 0, 0, 0, 0, 1,
    1, 1, 2, 2, 3, 3, 4, 5,
    6, 7, 8, 9, 10, 12, 14, 16,
    18, 20, 22, 24, 26, 29, 32, 35], dtype=np.int16)

DEBLOCK_BETA = np.array([
    0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 2, 3,
    3, 3, 4, 4, 4, 5, 5, 6,
    6, 7, 7, 8, 8, 9, 10, 11], dtype=np.int16)


def _reverse_bits(value: int, width: int) -> int:
    result = 0
    for _ in range(width):
        result = (result << 1) | (value & 1)
        value >>= 1
    return result


def unsigned_golomb_code(value: int) -> tuple[int, int]:
    """Exp-golomb code bits (LSB-first order) and bit count for value ≥ 0.

    Mirrors golomb.cpp:33-61: v = value+1 with b significant bits is emitted
    as b-1 zeros then reverse(v), packed LSB-first.
    """
    v = value + 1
    width = v.bit_length()
    return _reverse_bits(v, width) << (width - 1), 2 * width - 1


def signed_golomb_code(value: int) -> tuple[int, int]:
    """Signed exp-golomb: payload = (|v|<<1)|sign with 0 → 1 (golomb.cpp:63-91)."""
    if value == 0:
        v = 1
    else:
        v = (abs(int(value)) << 1) | (1 if value < 0 else 0)
    width = v.bit_length()
    return _reverse_bits(v, width) << (width - 1), 2 * width - 1


def _build_golomb_luts():
    # uint64: the code for -32768 is 33 bits (int32 abs in golomb.cpp:71).
    ucodes = np.zeros(256, dtype=np.uint64)
    usizes = np.zeros(256, dtype=np.uint8)
    scodes = np.zeros(65536, dtype=np.uint64)
    ssizes = np.zeros(65536, dtype=np.uint8)
    for i in range(256):
        ucodes[i], usizes[i] = unsigned_golomb_code(i)
    for i in range(65536):
        v = i - 65536 if i >= 32768 else i  # index by uint16 bit pattern
        scodes[i], ssizes[i] = signed_golomb_code(v)
    return ucodes, usizes, scodes, ssizes


UGOLOMB_CODES, UGOLOMB_SIZES, SGOLOMB_CODES, SGOLOMB_SIZES = _build_golomb_luts()
