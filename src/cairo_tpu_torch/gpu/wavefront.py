"""Conformance-mode frame encoding (bit-exact against the reference
encoder) on torch tensors, by anti-diagonal wavefront scheduling
(counterpart of cairo_tpu/tpu/wavefront.py:1-677, the encode half).

The reference encodes macroblocks in raster order, and each block's intra
search reads the current frame's partially reconstructed pixels in the
causal region. Scheduling blocks in waves w = bi + 3*bj keeps exactly the
raster order's view of the frame while the members of a wave run
together (see cuda_wave and csrc/wave.cu). Inter candidates have no
raster dependency: they are searched for all blocks up front (K5), their
prediction blocks gathered from the ring at the reference's +-31 (+1
sub-pel) reach (K4 at pads 33/17), and the wave pass (K6) merges them
with the intra search, encodes and reconstructs every block.

The state is the recon ring, the persistent coefficient planes and the
block table's stale q_index / variance fields (copy blocks keep the
previous frame's values, common.cpp:67-73). The frame index and quality
travel in the source wire's 8-byte header and stay on the device.
"""

from __future__ import annotations

import torch

from .. import tables
from ..blocktypes import COPY_BIT, INTRA_BIT, MOTION_BIT
from . import cuda_inter, cuda_pred, cuda_wave, ops
from . import deblock as deblock_mod
from . import wire as wire_mod

MB = tables.MACROBLOCK_SIZE
RING = tables.REFERENCE_FRAME_COUNT
I32 = torch.int32
STATE_KEYS = ("ring_y", "ring_u", "ring_v", "coef_y", "coef_u", "coef_v",
              "stale_q", "stale_var")


def init_state(aligned_w: int, aligned_h: int, device="cuda"):
    """Ring, coefficient planes and stale table fields, zeroed (never
    written ring slots stay zero references for the first inter frames)."""
    n = (aligned_w // MB) * (aligned_h // MB)

    def z(*shape, dtype=torch.int16):
        return torch.zeros(shape, dtype=dtype, device=device)

    return dict(
        ring_y=z(RING, aligned_h, aligned_w),
        ring_u=z(RING, aligned_h // 2, aligned_w // 2),
        ring_v=z(RING, aligned_h // 2, aligned_w // 2),
        coef_y=z(aligned_h, aligned_w),
        coef_u=z(aligned_h // 2, aligned_w // 2),
        coef_v=z(aligned_h // 2, aligned_w // 2),
        stale_q=z(n, dtype=torch.uint8), stale_var=z(n))


def wide_gather_pred(state, frame_index, target, mx, my, sp_pred, sp_amount,
                     sp_index, zero):
    """Prediction blocks at the reference encoder's inter reach
    (wavefront._wide_gather_pred): K4 at pads 33/17."""
    slot_per_mb = (frame_index + RING - target) % RING
    py, pu, pv = cuda_pred.pred_planes(
        state["ring_y"], state["ring_u"], state["ring_v"], slot_per_mb, mx,
        my, sp_pred, sp_amount, sp_index, zero, cuda_pred.WIDE_YPAD,
        cuda_pred.WIDE_CPAD)
    return (ops.plane_to_blocks(py, MB), ops.plane_to_blocks(pu, MB // 2),
            ops.plane_to_blocks(pv, MB // 2))


def dense_inter(src, state, hdr):
    """Order-exact inter candidates for all MBs, folded across ring offsets
    1..RING-1 (K5), and the winners' prediction blocks (K4 at 33/17)
    (wavefront._dense_inter)."""
    ring = (state["ring_y"], state["ring_u"], state["ring_v"])
    best = cuda_inter.inter_search(src, ring, hdr)
    pred = wide_gather_pred(state, hdr[0], best["target"], best["motion_x"],
                            best["motion_y"], best["sp_pred"],
                            best["sp_amount"], best["sp_index"],
                            torch.zeros_like(best["is_intra"]))
    return best, pred


def conformance_encode_step(src_wire, state, *, aligned_w, aligned_h,
                            frame_w, frame_h, is_inter, src_fmt="yuv8"):
    """One frame, bit-exact against the reference encoder.

    src_wire: uint8 tensor on the state's device, the source wire
    (native.rgb_to_yuv8 / rgb_to_yuv5d) prefixed with the 8-byte
    [frame_index, quality] int32 header. Returns (state, outputs): the
    block table fields and coefficient planes of the frame; the state is
    updated in place."""
    hdr = src_wire[:8].view(I32)
    unpack = (wire_mod.unpack_yuv5d if src_fmt == "yuv5d"
              else wire_mod.unpack_yuv8)
    y_in, u_in, v_in = unpack(src_wire[8:], aligned_h, aligned_w, frame_w,
                              frame_h)
    src = (ops.plane_to_blocks(y_in, MB).contiguous(),
           ops.plane_to_blocks(u_in, MB // 2).contiguous(),
           ops.plane_to_blocks(v_in, MB // 2).contiguous())
    self_sad = src[0].abs().sum(dim=(1, 2), dtype=I32)
    if is_inter:
        inter_best, inter_pred = dense_inter(src, state, hdr)
    else:
        inter_best = inter_pred = None

    slot = (hdr[0] % RING).reshape(1).long()
    cur = tuple(state[k].index_select(0, slot)[0]
                for k in ("ring_y", "ring_u", "ring_v"))
    rec_y, rec_u, rec_v, desc, coef_blocks = cuda_wave.wave_pass(
        src, self_sad, inter_best, inter_pred, *cur, hdr[1],
        is_inter=is_inter)

    # copy blocks keep the previous frame's q_index / variance and
    # coefficients (the table persists across frames)
    keep = desc["is_copy"] != 0
    table = dict(
        block_type=(desc["is_intra"] * INTRA_BIT | desc["is_motion"]
                    * MOTION_BIT | desc["is_copy"] * COPY_BIT),
        prediction_target=desc["target"], motion_x=desc["motion_x"],
        motion_y=desc["motion_y"], sp_pred=desc["sp_pred"] != 0,
        sp_amount=desc["sp_amount"] != 0, sp_index=desc["sp_index"],
        q_index=torch.where(keep, state["stale_q"].to(I32), desc["q_index"]),
        variance=torch.where(keep, state["stale_var"].to(I32),
                             desc["variance"]))
    keep3 = keep[:, None, None]
    coef = []
    for key, blocks, size, h, w in (
            ("coef_y", coef_blocks[0], MB, aligned_h, aligned_w),
            ("coef_u", coef_blocks[1], MB // 2, aligned_h // 2,
             aligned_w // 2),
            ("coef_v", coef_blocks[2], MB // 2, aligned_h // 2,
             aligned_w // 2)):
        stale = ops.plane_to_blocks(state[key], size)
        coef.append(ops.blocks_to_plane(torch.where(keep3, stale, blocks),
                                        h, w))
    return _conformance_tail(rec_y, rec_u, rec_v, table, *coef, state, slot,
                             aligned_w, aligned_h)


def _conformance_tail(rec_y, rec_u, rec_v, table, coef_y, coef_u, coef_v,
                      state, slot, aligned_w, aligned_h):
    """Deblock, ring update and outputs (wavefront._conformance_tail)."""
    hb, wb = aligned_h // MB, aligned_w // MB
    copy_map = ((table["block_type"] & COPY_BIT) != 0).reshape(hb, wb)
    q_map = table["q_index"].reshape(hb, wb)
    rec_y, rec_u, rec_v = deblock_mod.deblock_frame(rec_y, rec_u, rec_v,
                                                    copy_map, q_map)
    for key, plane in (("ring_y", rec_y), ("ring_u", rec_u),
                       ("ring_v", rec_v)):
        state[key].index_copy_(0, slot, plane.to(torch.int16)[None])
    state["coef_y"] = coef_y.to(torch.int16)
    state["coef_u"] = coef_u.to(torch.int16)
    state["coef_v"] = coef_v.to(torch.int16)
    state["stale_q"] = table["q_index"].to(torch.uint8)
    state["stale_var"] = table["variance"].to(torch.int16)
    outputs = dict(
        block_type=table["block_type"].to(torch.uint8),
        prediction_target=table["prediction_target"].to(torch.uint8),
        motion_x=table["motion_x"].to(torch.int16),
        motion_y=table["motion_y"].to(torch.int16),
        sp_pred=table["sp_pred"], sp_amount=table["sp_amount"],
        sp_index=table["sp_index"].to(torch.uint8),
        q_index=state["stale_q"], variance=state["stale_var"],
        coef_y=state["coef_y"], coef_u=state["coef_u"],
        coef_v=state["coef_v"])
    return state, outputs
