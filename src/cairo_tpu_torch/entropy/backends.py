"""Copy of cairo_tpu.entropy.backends: the four evx1 lossless backends as
a public library API (stream.h parity).

1. Huffman: limited-range unary precoder for values 0-7 (stream.cpp:8-46;
   quirk preserved: value 7 is seven zeros with no terminator).
2. Golomb value streams: exp-golomb codes straight to a bitstream
   (stream.cpp:90-244).
3. Golomb -> ABAC: golomb bits fed through the adaptive binary arithmetic
   coder (stream.cpp:246-436), including the 4x4/8x8/16x16 zigzag block
   coders (stream.cpp:438-548).
4. RLE: last-nonzero-prefixed 8x8 zigzag blocks (stream.cpp:550-605).

The frame pipeline itself uses only golomb->ABAC + RLE (via the native C++
slice codec); these APIs exist for capability parity and for tooling. All
functions are bit-exact with cairo_tpu.entropy.backends
(tests/test_torch_entropy.py).
"""

from __future__ import annotations

import numpy as np

from .. import tables
from .abac import EntropyCoder
from .bitio import BitReader, BitWriter
from .slicecodec import (_decode_rle_8x8, _decode_sgolomb, _decode_ugolomb,
                         _encode_rle_8x8, _encode_sgolomb, _encode_ugolomb,
                         _wrap16)

_ZZ = {4: tables.ZIGZAG_4x4, 8: tables.ZIGZAG_8x8, 16: tables.ZIGZAG_16x16}

__all__ = [
    "huffman_encode_value", "huffman_decode_value",
    "huffman_encode_values", "huffman_decode_values",
    "golomb_encode_value", "golomb_decode_value",
    "golomb_encode_values", "golomb_decode_values",
    "entropy_encode_value", "entropy_decode_value",
    "entropy_encode_block", "entropy_decode_block",
    "entropy_rle_encode_8x8", "entropy_rle_decode_8x8",
    "EntropyCoder", "BitReader", "BitWriter",
]


# ------------------------------------------------------------------ huffman

def huffman_encode_value(value: int, out: BitWriter):
    """Unary code: `value` zeros then a one; 7 is seven zeros, unterminated
    (stream.cpp:8-30 writes the bits of 1<<value MSB-down, capped at 7)."""
    if not 0 <= value < 8:
        raise ValueError("huffman precoder supports values 0..7")
    bit = 1 << value
    count = 0
    while bit:
        out.write_bit(bit & 1)
        bit >>= 1
        count += 1
        if count >= 7:
            break


def huffman_decode_value(src: BitReader) -> int:
    value = 0
    for _ in range(7):
        if src.read_bit():
            break
        value += 1
    return value


def huffman_encode_values(values, out: BitWriter):
    for v in values:
        huffman_encode_value(int(v), out)


def huffman_decode_values(src: BitReader, count: int) -> np.ndarray:
    return np.asarray([huffman_decode_value(src) for _ in range(count)],
                      np.uint8)


# ----------------------------------------------------------- golomb streams

def golomb_encode_value(value: int, out: BitWriter, *, signed: bool = True):
    """Exp-golomb code straight to the bitstream (stream.cpp:90-120)."""
    if signed:
        code, count = tables.signed_golomb_code(int(value))
    else:
        code, count = tables.unsigned_golomb_code(int(value))
    out.write_bits(code, count)


def _read_golomb_payload(src: BitReader) -> tuple[int, int]:
    """Zero-run length prefix then payload bits, MSB-first accumulation
    (mirrors stream.cpp:164-203 / golomb.cpp decode)."""
    zero_count = 0
    bit = src.read_bit()
    while not bit:
        zero_count += 1
        bit = src.read_bit()
    payload = 0
    for i in range(zero_count + 1):
        payload = (payload << 1) | (bit & 1)
        if i < zero_count:
            bit = src.read_bit()
    return payload, zero_count


def golomb_decode_value(src: BitReader, *, signed: bool = True) -> int:
    payload, zero_count = _read_golomb_payload(src)
    if not signed:
        return (payload - 1) & 0xFFFF
    sign = 1 - 2 * (payload & 1)
    result = sign * ((payload >> 1) & 0x7FFF)
    # reference quirk: min-int16 escape (stream.cpp:425-432)
    if 2 * zero_count + 1 > 0x20:
        result = _wrap16(result | 0x8000)
    return _wrap16(result)


def golomb_encode_values(values, out: BitWriter, *, signed: bool = True):
    for v in values:
        golomb_encode_value(int(v), out, signed=signed)


def golomb_decode_values(src: BitReader, count: int, *,
                         signed: bool = True) -> np.ndarray:
    """Decodes `count` values. Note: for signed values the *reference's*
    plain-stream decoder is broken (golomb.cpp:150-158 seeks 3*zc+1 bits
    instead of 2*zc+1, desyncing after any nonzero value); this decoder is
    correct and round-trips both our and the reference's encodings."""
    vals = [golomb_decode_value(src, signed=signed) for _ in range(count)]
    if signed:
        return np.asarray(vals, np.int16)
    return np.asarray(vals, np.uint16).view(np.int16)


# ------------------------------------------------------------ golomb + ABAC

def entropy_encode_value(value: int, coder: EntropyCoder, out: BitWriter, *,
                         signed: bool = True):
    """Golomb code arithmetic-coded through the shared adaptive model
    (stream.cpp:246-290)."""
    if signed:
        _encode_sgolomb(coder, out, int(value))
    else:
        _encode_ugolomb(coder, out, int(value))


def entropy_decode_value(coder: EntropyCoder, src: BitReader, *,
                         signed: bool = True) -> int:
    if signed:
        return _decode_sgolomb(coder, src)
    return _decode_ugolomb(coder, src)


def entropy_encode_block(block: np.ndarray, coder: EntropyCoder,
                         out: BitWriter):
    """Zigzag block coder for 4x4 / 8x8 / 16x16 (stream.cpp:438-494).
    `block` is a row-major (n, n) int16 array."""
    size = block.shape[-1]
    flat = np.asarray(block, np.int16).reshape(-1)
    for idx in _ZZ[size]:
        _encode_sgolomb(coder, out, int(flat[idx]))


def entropy_decode_block(size: int, coder: EntropyCoder,
                         src: BitReader) -> np.ndarray:
    out = np.zeros(size * size, np.int16)
    for idx in _ZZ[size]:
        out[idx] = _decode_sgolomb(coder, src)
    return out.reshape(size, size)


# --------------------------------------------------------------------- RLE

def entropy_rle_encode_8x8(block: np.ndarray, coder: EntropyCoder,
                           out: BitWriter):
    """Run-length prefixed zigzag 8x8 (stream.cpp:550-581)."""
    flat = np.asarray(block, np.int16).reshape(-1)
    _encode_rle_8x8(coder, out, flat[tables.ZIGZAG_8x8])


def entropy_rle_decode_8x8(coder: EntropyCoder, src: BitReader) -> np.ndarray:
    return _decode_rle_8x8(coder, src).reshape(8, 8)
