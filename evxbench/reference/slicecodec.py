"""Copy of cairo_tpu.entropy.slicecodec: the frame-slice bitstream
serializer/deserializer in Python (the correctness anchor).

Slice layout — all sections flow through ONE adaptive ABAC coder
(serialize.cpp:319-340):
  1. block types, 3 bits/MB                      (serialize.cpp:156-166)
  2. prediction targets, 2 bits, inter MBs only  (serialize.cpp:168-184)
  3. MV deltas: all x then all y, signed golomb,
     running prediction across motion MBs        (serialize.cpp:186-219)
  4. sub-pel: enable bits, amount bits, 3-bit
     directions (three separate passes)          (serialize.cpp:221-266)
  5. QP deltas, signed golomb, non-copy MBs      (serialize.cpp:268-286)
  6. residuals: Y as 4×8×8 per MB then U then V,
     RLE + golomb, DC delta prediction           (serialize.cpp:10-154)
  final ABAC flush                               (serialize.cpp:337)

The port's C++ module in native/ implements the same layout at speed, and
this module shares nothing with it: tests/test_torch_entropy.py holds the
two to each other.
"""

from __future__ import annotations

import numpy as np

from . import tables
from .blocktypes import BlockTable, is_copy, is_intra, is_motion
from .abac import EntropyCoder
from .bitio import BitReader, BitWriter

MB = tables.MACROBLOCK_SIZE
_Z8 = tables.ZIGZAG_8x8


def _wrap16(value: int) -> int:
    """Two's-complement wrap to int16 (C int16 store)."""
    return ((int(value) + 0x8000) & 0xFFFF) - 0x8000


def _encode_sgolomb(coder: EntropyCoder, out: BitWriter, value: int):
    idx = int(value) & 0xFFFF
    code = int(tables.SGOLOMB_CODES[idx])
    count = int(tables.SGOLOMB_SIZES[idx])
    coder.encode_bits(code, count, out)


def _encode_ugolomb(coder: EntropyCoder, out: BitWriter, value: int):
    if value < 256:
        code = int(tables.UGOLOMB_CODES[value])
        count = int(tables.UGOLOMB_SIZES[value])
    else:
        code, count = tables.unsigned_golomb_code(int(value))
    coder.encode_bits(code, count, out)


def _decode_golomb_payload(coder: EntropyCoder, src: BitReader) -> tuple[int, int]:
    """Reads one exp-golomb payload through the coder.

    Returns (payload, total_bits): payload is `1` followed by zero_count more
    bits, assembled MSB-first (stream.cpp:292-357).
    """
    zero_count = 0
    bit = coder.decode_bit(src)
    while not bit:
        zero_count += 1
        bit = coder.decode_bit(src)
    result = 1
    for _ in range(zero_count):
        result = (result << 1) | coder.decode_bit(src)
    return result, 2 * zero_count + 1


def _decode_ugolomb(coder: EntropyCoder, src: BitReader) -> int:
    payload, _ = _decode_golomb_payload(coder, src)
    return (payload - 1) & 0xFFFF


def _decode_sgolomb(coder: EntropyCoder, src: BitReader) -> int:
    payload, nbits = _decode_golomb_payload(coder, src)
    sign = 1 - 2 * (payload & 1)
    result = sign * ((payload >> 1) & 0x7FFF)
    if nbits > 0x20:  # -32768 escape (stream.cpp:425-431)
        result = -32768 if result == 0 else result | ~0x7FFF
    return _wrap16(result)


def _encode_rle_8x8(coder: EntropyCoder, out: BitWriter, block_zz: np.ndarray):
    """RLE-codes one 8x8 block given its 64 zigzag-ordered coefficients."""
    nz = np.nonzero(block_zz)[0]
    run_length = int(nz[-1]) + 1 if len(nz) else 0
    _encode_ugolomb(coder, out, run_length)
    for k in range(run_length):
        _encode_sgolomb(coder, out, int(block_zz[k]))


def _decode_rle_8x8(coder: EntropyCoder, src: BitReader) -> np.ndarray:
    out = np.zeros(64, dtype=np.int16)
    run_length = _decode_ugolomb(coder, src)
    for k in range(run_length):
        out[_Z8[k]] = _decode_sgolomb(coder, src)
    return out


def _sub_block_zz(plane: np.ndarray, y: int, x: int) -> np.ndarray:
    return plane[y:y + 8, x:x + 8].ravel()[_Z8]


def encode_slice(bt: BlockTable, y_plane: np.ndarray, u_plane: np.ndarray,
                 v_plane: np.ndarray, out: BitWriter,
                 coder: EntropyCoder | None = None,
                 finish: bool = True) -> None:
    """Serializes the block table and residual planes into `out`."""
    if coder is None:
        coder = EntropyCoder()
        coder.clear()
    n = len(bt)

    # 1. block types
    for i in range(n):
        coder.encode_bits(int(bt.block_type[i]), 3, out)
    # 2. prediction targets (2 bits = log2(ref_count))
    for i in range(n):
        if not is_intra(bt.block_type[i]):
            coder.encode_bits(int(bt.prediction_target[i]), 2, out)
    # 3. motion vector deltas, x then y
    for comp in (bt.motion_x, bt.motion_y):
        last = 0
        for i in range(n):
            if not is_motion(bt.block_type[i]):
                continue
            _encode_sgolomb(coder, out, _wrap16(int(comp[i]) - last))
            last = int(comp[i])
    # 4. sub-pel parameters
    for i in range(n):
        if is_motion(bt.block_type[i]):
            coder.encode_bit(int(bt.sp_pred[i]), out)
    for i in range(n):
        if is_motion(bt.block_type[i]) and bt.sp_pred[i]:
            coder.encode_bit(int(bt.sp_amount[i]), out)
    for i in range(n):
        if is_motion(bt.block_type[i]) and bt.sp_pred[i]:
            coder.encode_bits(int(bt.sp_index[i]), 3, out)
    # 5. per-block QP deltas
    last = 0
    for i in range(n):
        if is_copy(bt.block_type[i]):
            continue
        _encode_sgolomb(coder, out, _wrap16(int(bt.q_index[i]) - last))
        last = int(bt.q_index[i])

    # 6. residuals: Y plane (4 sub-blocks/MB with chained DC deltas), then U, V
    height, width = y_plane.shape
    wb = width // MB
    for mb in range(n):
        if is_copy(bt.block_type[mb]):
            continue
        j, i = (mb // wb) * MB, (mb % wb) * MB
        if i >= MB:
            last_dc = int(y_plane[j, i - 8])       # left MB's TR sub-block DC
        elif j >= MB:
            last_dc = int(y_plane[j - 8, i])       # above MB's BL sub-block DC
        else:
            last_dc = 0
        tl = int(y_plane[j, i])
        bl = int(y_plane[j + 8, i])
        for (dy, dx), dc_pred in (((0, 0), last_dc), ((0, 8), tl),
                                  ((8, 0), tl), ((8, 8), bl)):
            zz = _sub_block_zz(y_plane, j + dy, i + dx).copy()
            zz[0] = _wrap16(int(zz[0]) - dc_pred)
            _encode_rle_8x8(coder, out, zz)

    for plane in (u_plane, v_plane):
        ch = MB // 2
        cwb = plane.shape[1] // ch
        for mb in range(n):
            if is_copy(bt.block_type[mb]):
                continue
            j, i = (mb // cwb) * ch, (mb % cwb) * ch
            if i >= ch:
                last_dc = int(plane[j, i - 8])
            elif j >= ch:
                last_dc = int(plane[j - 8, i])
            else:
                last_dc = 0
            zz = _sub_block_zz(plane, j, i).copy()
            zz[0] = _wrap16(int(zz[0]) - last_dc)
            _encode_rle_8x8(coder, out, zz)

    if finish:
        coder.finish_encode(out)


def decode_slice(src: BitReader, n_blocks: int, y_plane: np.ndarray,
                 u_plane: np.ndarray, v_plane: np.ndarray,
                 bt: BlockTable) -> None:
    """Deserializes one slice into `bt` and the given residual planes.

    State persistence is wire-critical: `bt` carries the previous frame's
    table (fields not re-sent keep their prior values), and the residual
    planes persist across frames — a copy block's region keeps stale
    coefficients which the *next* frame's DC-delta prediction may sample
    (serialize.cpp:59-72 reads the plane regardless of the neighbor's copy
    status; both sides stay in sync because both persist the planes).
    """
    height, width = y_plane.shape
    n = n_blocks
    coder = EntropyCoder()
    coder.clear()
    coder.start_decode(src)

    for i in range(n):
        bt.block_type[i] = coder.decode_bits(3, src)
    for i in range(n):
        if not is_intra(bt.block_type[i]):
            bt.prediction_target[i] = coder.decode_bits(2, src)
    for comp in (bt.motion_x, bt.motion_y):
        last = 0
        for i in range(n):
            if not is_motion(bt.block_type[i]):
                continue
            delta = _decode_sgolomb(coder, src)
            comp[i] = _wrap16(last + delta)
            last = int(comp[i])
    for i in range(n):
        if is_motion(bt.block_type[i]):
            bt.sp_pred[i] = bool(coder.decode_bit(src))
    for i in range(n):
        if is_motion(bt.block_type[i]) and bt.sp_pred[i]:
            bt.sp_amount[i] = bool(coder.decode_bit(src))
    for i in range(n):
        if is_motion(bt.block_type[i]) and bt.sp_pred[i]:
            bt.sp_index[i] = coder.decode_bits(3, src)
    last = 0
    for i in range(n):
        if is_copy(bt.block_type[i]):
            continue
        delta = _decode_sgolomb(coder, src)
        bt.q_index[i] = np.uint8((last + delta) & 0xFF)
        last = int(bt.q_index[i])

    wb = width // MB
    for mb in range(n):
        if is_copy(bt.block_type[mb]):
            continue
        j, i = (mb // wb) * MB, (mb % wb) * MB
        if i >= MB:
            last_dc = int(y_plane[j, i - 8])
        elif j >= MB:
            last_dc = int(y_plane[j - 8, i])
        else:
            last_dc = 0
        for dy, dx in ((0, 0), (0, 8), (8, 0), (8, 8)):
            blk = _decode_rle_8x8(coder, src).reshape(8, 8)
            if (dy, dx) == (0, 0):
                dc_pred = last_dc
            elif (dy, dx) in ((0, 8), (8, 0)):
                dc_pred = int(y_plane[j, i])
            else:
                dc_pred = int(y_plane[j + 8, i])
            blk[0, 0] = _wrap16(int(blk[0, 0]) + dc_pred)
            y_plane[j + dy:j + dy + 8, i + dx:i + dx + 8] = blk

    for plane in (u_plane, v_plane):
        ch = MB // 2
        cwb = plane.shape[1] // ch
        for mb in range(n):
            if is_copy(bt.block_type[mb]):
                continue
            j, i = (mb // cwb) * ch, (mb % cwb) * ch
            if i >= ch:
                last_dc = int(plane[j, i - 8])
            elif j >= ch:
                last_dc = int(plane[j - 8, i])
            else:
                last_dc = 0
            blk = _decode_rle_8x8(coder, src).reshape(8, 8)
            blk[0, 0] = _wrap16(int(blk[0, 0]) + last_dc)
            plane[j:j + 8, i:i + 8] = blk
