"""Copy of cairo_tpu.cpuref.engine: the frame encode/decode engine (numpy
correctness build).

Mirrors encode.cpp/decode.cpp exactly: classification -> encode -> inline
reconstruction per macroblock in raster order, writing into a 4-slot ring of
reconstruction frames (slot = frame_index % 4, common.cpp:192-195). The
encoder *contains* the decoder as its reconstruction path, which is what
makes encoder/decoder drift structurally impossible.
"""

from __future__ import annotations

import numpy as np

from . import tables
from .blocktypes import (BlockTable, FRAME_INTER, FRAME_INTRA,
                          INTRA_DEFAULT, SP_INDEX_TO_DIR,
                          is_copy, is_intra, is_motion)
from .xmath import as_int16
from . import deblock as deblock_mod
from . import motion as motion_mod
from . import quantize as quant_mod
from . import transform as transform_mod
from .imaging import rgb_to_yuv420, yuv420_to_rgb
from .motion import Planes

MB = tables.MACROBLOCK_SIZE


def _alloc_planes(width: int, height: int) -> Planes:
    return Planes(np.zeros((height, width), dtype=np.int16),
                  np.zeros((height // 2, width // 2), dtype=np.int16),
                  np.zeros((height // 2, width // 2), dtype=np.int16))


class CodecContext:
    """Shared encoder/decoder state (common.h:104-131)."""

    def __init__(self, width: int, height: int, config=None):
        from .config import CONFORMANCE
        self.config = config if config is not None else CONFORMANCE
        self.aligned_w = (width + MB - 1) // MB * MB
        self.aligned_h = (height + MB - 1) // MB * MB
        self.width_in_blocks = self.aligned_w // MB
        self.height_in_blocks = self.aligned_h // MB
        self.n_blocks = self.width_in_blocks * self.height_in_blocks
        self.input = _alloc_planes(self.aligned_w, self.aligned_h)
        self.output = _alloc_planes(self.aligned_w, self.aligned_h)
        self.recon = [_alloc_planes(self.aligned_w, self.aligned_h)
                      for _ in range(tables.REFERENCE_FRAME_COUNT)]
        self.block_table = BlockTable.zeros(self.n_blocks)

    def ring_slot(self, frame_index: int, offset: int) -> int:
        return (frame_index + tables.REFERENCE_FRAME_COUNT - offset) \
            % tables.REFERENCE_FRAME_COUNT


def _mb_quads(y_mb: np.ndarray) -> np.ndarray:
    """(16,16) -> (4,8,8) quadrants in TL,TR,BL,BR order."""
    return y_mb.reshape(2, 8, 2, 8).transpose(0, 2, 1, 3).reshape(4, 8, 8)


def _quads_to_mb(quads: np.ndarray) -> np.ndarray:
    return quads.reshape(2, 2, 8, 8).transpose(0, 2, 1, 3).reshape(16, 16)


def _prediction_block(ctx: CodecContext, frame_index: int, desc: dict,
                      i: int, j: int):
    """Builds the (possibly sub-pel interpolated) prediction macroblock.

    Stale-field rules (the decoder's table persists across frames and only
    transmitted fields refresh): intra blocks always predict from ring
    offset 0 (decode.cpp:30,53); non-motion blocks predict co-located and
    never consult mv/sp fields (decode.cpp:117,134).
    """
    block_type = desc["block_type"]
    offset = 0 if is_intra(block_type) else int(desc["prediction_target"])
    slot = ctx.ring_slot(frame_index, offset)
    pred = ctx.recon[slot]
    if not is_motion(block_type):
        return tuple(p.copy() for p in pred.block(i, j))
    bx, by = i + int(desc["motion_x"]), j + int(desc["motion_y"])
    beta = pred.block(bx, by)
    if desc["sp_pred"]:
        di, dj = SP_INDEX_TO_DIR[int(desc["sp_index"])]
        sp = pred.block(bx + int(di), by + int(dj))
        lerp = motion_mod.lerp_quarter if desc["sp_amount"] else motion_mod.lerp_half
        return tuple(lerp(a, b) for a, b in zip(beta, sp))
    return tuple(p.copy() for p in beta)


def _transform_mb(y_mb, u_blk, v_blk):
    quads = transform_mod.fdct8(_mb_quads(y_mb))
    return (_quads_to_mb(quads), transform_mod.fdct8(u_blk[None])[0],
            transform_mod.fdct8(v_blk[None])[0])


def encode_block(ctx: CodecContext, frame_type: int, frame_index: int,
                 quality: int, desc: dict, i: int, j: int):
    """encode.cpp:69-163: transform -> adaptive QP -> quantize into output."""
    block_type = desc["block_type"]
    if is_copy(block_type):
        return
    src = ctx.input.block(i, j)
    if block_type == INTRA_DEFAULT:
        residual = src
    else:
        pred = _prediction_block(ctx, frame_index, desc, i, j)
        residual = tuple(as_int16(a.astype(np.int32) - b.astype(np.int32))
                         for a, b in zip(src, pred))
    ty, tu, tv = _transform_mb(*residual)
    cfg = ctx.config
    desc["variance"] = int(np.int16(quant_mod.block_variance2(ty[None])[0]))
    quads = _mb_quads(ty)
    intra_qm = is_intra(block_type) and not is_motion(block_type)

    if not cfg.quantization_enabled:  # quantize.cpp:62-77 #else: qp = 0
        desc["q_index"] = 0
        qy, qu, qv = quads, tu, tv
    else:
        if cfg.adaptive_quantization:
            qp = int(quant_mod.adaptive_qp(quality, ty[None])[0])
        else:  # query_block_quantization_parameter #else: frame quality
            qp = int(quality)
        desc["q_index"] = qp
        r = cfg.rounded_quantization
        if cfg.linear_quantization:  # H.263 path (config.h:48)
            qfn = (quant_mod.quantize_intra_linear_8x8 if intra_qm
                   else quant_mod.quantize_inter_linear_8x8)
            qy = qfn(quads, [qp] * 4, rounded=r)
            qu = qfn(tu[None], [qp], rounded=r)[0]
            qv = qfn(tv[None], [qp], rounded=r)[0]
        elif intra_qm:
            qy = quant_mod.quantize_intra_8x8(quads, [qp] * 4, is_luma=True,
                                              rounded=r)
            qu = quant_mod.quantize_intra_8x8(tu[None], [qp], is_luma=False,
                                              rounded=r)[0]
            qv = quant_mod.quantize_intra_8x8(tv[None], [qp], is_luma=False,
                                              rounded=r)[0]
        else:
            qy = quant_mod.quantize_inter_8x8(quads, [qp] * 4, rounded=r)
            qu = quant_mod.quantize_inter_8x8(tu[None], [qp], rounded=r)[0]
            qv = quant_mod.quantize_inter_8x8(tv[None], [qp], rounded=r)[0]

    oy, ou, ov = ctx.output.block(i, j)
    oy[:] = _quads_to_mb(qy)
    ou[:] = qu
    ov[:] = qv


def decode_block(ctx: CodecContext, source: Planes, frame_index: int,
                 desc: dict, i: int, j: int):
    """decode.cpp:15-144: reconstruction into the current ring slot."""
    block_type = desc["block_type"]
    slot = ctx.ring_slot(frame_index, 0)
    dy, du, dv = ctx.recon[slot].block(i, j)

    if is_copy(block_type):
        if is_motion(block_type):
            pred = _prediction_block(ctx, frame_index, desc, i, j)
        else:  # INTER_COPY: co-located in the target ring slot
            tslot = ctx.ring_slot(frame_index, int(desc["prediction_target"]))
            pred = tuple(p.copy() for p in ctx.recon[tslot].block(i, j))
        dy[:], du[:], dv[:] = pred
        return

    sy, su, sv = source.block(i, j)
    cfg = ctx.config
    qp = int(desc["q_index"])
    quads = _mb_quads(sy)
    intra_qm = is_intra(block_type) and not is_motion(block_type)
    if not cfg.quantization_enabled:
        iy, iu, iv = quads, su, sv
    elif cfg.linear_quantization:
        iy = quant_mod.inverse_quantize_linear_8x8(quads, [qp] * 4)
        iu = quant_mod.inverse_quantize_linear_8x8(su[None], [qp])[0]
        iv = quant_mod.inverse_quantize_linear_8x8(sv[None], [qp])[0]
    elif intra_qm:
        iy = quant_mod.inverse_quantize_intra_8x8(quads, [qp] * 4, is_luma=True)
        iu = quant_mod.inverse_quantize_intra_8x8(su[None], [qp], is_luma=False)[0]
        iv = quant_mod.inverse_quantize_intra_8x8(sv[None], [qp], is_luma=False)[0]
    else:
        iy = quant_mod.inverse_quantize_inter_8x8(quads, [qp] * 4)
        iu = quant_mod.inverse_quantize_inter_8x8(su[None], [qp])[0]
        iv = quant_mod.inverse_quantize_inter_8x8(sv[None], [qp])[0]

    ry = _quads_to_mb(transform_mod.idct8(iy))
    ru = transform_mod.idct8(iu[None])[0]
    rv = transform_mod.idct8(iv[None])[0]

    if block_type == INTRA_DEFAULT:
        dy[:], du[:], dv[:] = ry, ru, rv
    else:
        pred = _prediction_block(ctx, frame_index, desc, i, j)
        dy[:] = as_int16(ry.astype(np.int32) + pred[0].astype(np.int32))
        du[:] = as_int16(ru.astype(np.int32) + pred[1].astype(np.int32))
        dv[:] = as_int16(rv.astype(np.int32) + pred[2].astype(np.int32))


def classify_block(ctx: CodecContext, frame_type: int, frame_index: int,
                   quality: int, i: int, j: int) -> tuple[int, dict]:
    """encode.cpp:17-67: intra candidate always; inter candidates on P-frames
    with copy-status priority, then lowest SAD."""
    src = ctx.input.block(i, j)
    intra_pred = ctx.recon[ctx.ring_slot(frame_index, 0)]
    best_sad, best = motion_mod.intra_prediction(quality, src, i, j, intra_pred)
    if frame_type == FRAME_INTER:
        for offset in range(1, ctx.config.reference_frame_count):
            pred = ctx.recon[ctx.ring_slot(frame_index, offset)]
            sad, desc = motion_mod.inter_prediction(quality, src, i, j, pred,
                                                    offset)
            if is_copy(desc["block_type"]) != is_copy(best["block_type"]):
                if is_copy(desc["block_type"]):
                    best, best_sad = desc, sad
            elif sad < best_sad:
                best, best_sad = desc, sad
    return best_sad, best


def _store_desc(bt: BlockTable, idx: int, desc: dict):
    bt.block_type[idx] = desc["block_type"]
    bt.prediction_target[idx] = desc["prediction_target"]
    bt.motion_x[idx] = desc["motion_x"]
    bt.motion_y[idx] = desc["motion_y"]
    bt.sp_pred[idx] = desc["sp_pred"]
    bt.sp_amount[idx] = desc["sp_amount"]
    bt.sp_index[idx] = desc["sp_index"]
    # copy blocks skip encode_block, so q_index/variance keep the table's
    # previous values — the reference's clear_block_desc zeroes only the
    # leading bytes (common.cpp:67-73) and every consumer gates on copy
    # status, so the stale fields are observable only through peek
    if "q_index" in desc:
        bt.q_index[idx] = desc["q_index"]
    if "variance" in desc:
        bt.variance[idx] = desc["variance"]


def encode_slice(ctx: CodecContext, frame_type: int, frame_index: int,
                 quality: int):
    """encode.cpp:165-203: raster classify -> encode -> reconstruct."""
    idx = 0
    for j in range(0, ctx.aligned_h, MB):
        for i in range(0, ctx.aligned_w, MB):
            _, desc = classify_block(ctx, frame_type, frame_index, quality, i, j)
            encode_block(ctx, frame_type, frame_index, quality, desc, i, j)
            decode_block(ctx, ctx.output, frame_index, desc, i, j)
            _store_desc(ctx.block_table, idx, desc)
            idx += 1


def decode_slice(ctx: CodecContext, frame_index: int):
    """decode.cpp:146-170 over the parsed block table + residual planes."""
    idx = 0
    bt = ctx.block_table
    for j in range(0, ctx.aligned_h, MB):
        for i in range(0, ctx.aligned_w, MB):
            desc = dict(block_type=int(bt.block_type[idx]),
                        prediction_target=int(bt.prediction_target[idx]),
                        motion_x=int(bt.motion_x[idx]),
                        motion_y=int(bt.motion_y[idx]),
                        sp_pred=bool(bt.sp_pred[idx]),
                        sp_amount=bool(bt.sp_amount[idx]),
                        sp_index=int(bt.sp_index[idx]),
                        q_index=int(bt.q_index[idx]))
            decode_block(ctx, ctx.input, frame_index, desc, i, j)
            idx += 1


def deblock_recon(ctx: CodecContext, frame_index: int):
    if not ctx.config.enable_deblocking:
        return
    slot = ctx.ring_slot(frame_index, 0)
    planes = ctx.recon[slot]
    deblock_mod.deblock_image_set(planes.y, planes.u, planes.v,
                                  ctx.block_table)


def load_input(ctx: CodecContext, rgb: np.ndarray):
    """convert_image into the padded input cache (pad region stays zero)."""
    height, width = rgb.shape[:2]
    y, u, v = rgb_to_yuv420(rgb)
    ctx.input.y[:height, :width] = y
    if ctx.config.enable_chroma:
        ctx.input.u[:height // 2, :width // 2] = u
        ctx.input.v[:height // 2, :width // 2] = v


def recon_to_rgb(ctx: CodecContext, frame_index: int, width: int,
                 height: int) -> np.ndarray:
    slot = ctx.ring_slot(frame_index, 0)
    planes = ctx.recon[slot]
    if not ctx.config.enable_chroma:  # convert.cpp:20-28 grayscale mode
        yy = planes.y[:height, :width].astype(np.int32) - 16
        g = np.clip((256 * yy + 128) >> 8, 0, 255).astype(np.uint8)
        return np.stack([g, g, g], axis=-1)
    return yuv420_to_rgb(planes.y, planes.u, planes.v, width, height)
