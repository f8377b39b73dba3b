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

The decode half (counterpart of wavefront.py:680-1086) reconstructs the
frames of reference-origin streams on the device: every block that does
not read the current frame densely (K4 at pads 33/17, then K11 in
cuda_tail: the carry, the residual and the prediction add), then the
intra-motion blocks wave by wave over a schedule the host compacts to
the waves that hold them (K7, cuda_wavedec). Its state is the
fast-mode decoder's (engine.init_state): the ring and the coefficient
planes; the JAX state's win_* window caches belong to its XLA anchors.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tables
from ..blocktypes import COPY_BIT, INTRA_BIT, MOTION_BIT
from . import (cuda_deblock, cuda_inter, cuda_pred, cuda_tail, cuda_wave,
               cuda_wavedec, engine, ops)
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


def wide_pred_planes(state, frame_index, target, mx, my, sp_pred,
                     sp_amount, sp_index, zero):
    """Prediction planes at the reference encoder's inter reach: K4 at
    pads 33/17."""
    slot_per_mb = (frame_index + RING - target) % RING
    return cuda_pred.pred_planes(
        state["ring_y"], state["ring_u"], state["ring_v"], slot_per_mb, mx,
        my, sp_pred, sp_amount, sp_index, zero, cuda_pred.WIDE_YPAD,
        cuda_pred.WIDE_CPAD)


def wide_gather_pred(state, frame_index, target, mx, my, sp_pred, sp_amount,
                     sp_index, zero):
    """Prediction blocks at the reference encoder's inter reach
    (wavefront._wide_gather_pred): K4 at pads 33/17."""
    py, pu, pv = wide_pred_planes(state, frame_index, target, mx, my,
                                  sp_pred, sp_amount, sp_index, zero)
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
    if src_fmt == "yuv5d":
        src, self_sad = wire_mod.unpack_yuv5d_blocks(
            src_wire[8:], aligned_h, aligned_w, frame_w, frame_h)
    else:
        src, self_sad = wire_mod.source_blocks(*wire_mod.unpack_yuv8(
            src_wire[8:], aligned_h, aligned_w, frame_w, frame_h))
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
    rec_y, rec_u, rec_v = cuda_deblock.deblock_frame(rec_y, rec_u, rec_v,
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


# --------------------------------------------------------------------------
# Wavefront decode (wavefront.py:680-1086)

def decode_schedule(wb: int, hb: int):
    """Geometry of the compacted decode schedule (wavefront.decode_schedule):
    (n_waves, p), every wave w = bi + 3 bj of the frame, empty ones
    included, and the most members a wave has."""
    return (wb + cuda_wave.SKEW * (hb - 1),
            max(len(m) for m in cuda_wave.wave_members(wb, hb)))


def build_compact_schedule(block_type, wb: int, hb: int):
    """Host side (wavefront.build_compact_schedule): the waves that hold
    intra-motion blocks of one parsed frame, in wave order, their members
    in raster order. Returns (bi, bj, n_active): int16 (n_waves, p) block
    coordinates, -1 past each wave's members and in the rows past
    n_active."""
    n_waves, p = decode_schedule(wb, hb)
    bt = np.asarray(block_type, np.int32)
    idx = np.flatnonzero(((bt & INTRA_BIT) != 0) & ((bt & MOTION_BIT) != 0))
    bi = np.full((n_waves, p), -1, np.int16)
    bj = np.full((n_waves, p), -1, np.int16)
    if idx.size == 0:
        return bi, bj, 0
    waves = idx % wb + cuda_wave.SKEW * (idx // wb)
    order = np.lexsort((idx, waves))
    idx, waves = idx[order], waves[order]
    first = np.r_[True, waves[1:] != waves[:-1]]
    row = np.cumsum(first) - 1
    col = np.arange(idx.size) - np.flatnonzero(first)[row]
    bi[row, col] = idx % wb
    bj[row, col] = idx // wb
    return bi, bj, int(row[-1]) + 1


def conformance_decode_step(in_wire, state, *, n_active, n_members,
                            aligned_w, aligned_h, frame_w=None, frame_h=None,
                            deblock=True, coo_k=None, out_fmt="yuv8"):
    """Decodes one parsed frame that needs the wave loop
    (wavefront.conformance_decode_step): intra-motion blocks, or inter
    vectors beyond the fast reach.

    in_wire: uint8 tensor on the state's device, the JAX package's layout
    byte for byte: the 8-byte [frame_index, n_active] int32 header, the
    residual COO (coo_k int32 positions, coo_k int16 values), the packed
    block table and the compacted schedule (bi, then bj, int16). n_active
    (the header's) and n_members (the intra-motion blocks) come from the
    host as ints, so no wave launch waits on a device read. Returns
    (state, yuv wire); the state is updated in place."""
    k = coo_k if coo_k is not None else wire_mod.COO_K
    body = in_wire[8:]
    return _conformance_decode_core(
        in_wire[:8].view(I32)[0], n_active, n_members, body[6 * k:],
        engine.coo_planes(body, k, aligned_w, aligned_h), state,
        aligned_w=aligned_w, aligned_h=aligned_h, frame_w=frame_w,
        frame_h=frame_h, deblock=deblock, out_fmt=out_fmt)


def conformance_decode_step_dense(in_wire, cy_in, cu_in, cv_in, state, *,
                                  n_active, n_members, aligned_w, aligned_h,
                                  frame_w=None, frame_h=None, deblock=True,
                                  out_fmt="yuv8"):
    """conformance_decode_step with the residual coefficients as dense
    int16 planes cy/cu/cv, for frames whose nonzeros overflow the COO
    capacity (wavefront.conformance_decode_step_dense). in_wire: the
    8-byte header, the packed table and the compacted schedule."""
    return _conformance_decode_core(
        in_wire[:8].view(I32)[0], n_active, n_members, in_wire[8:],
        tuple(c.to(I32) for c in (cy_in, cu_in, cv_in)), state,
        aligned_w=aligned_w, aligned_h=aligned_h, frame_w=frame_w,
        frame_h=frame_h, deblock=deblock, out_fmt=out_fmt)


def _conformance_decode_core(frame_index, n_active, n_members, tail,
                             new_coef, state, *, aligned_w, aligned_h,
                             frame_w, frame_h, deblock, out_fmt):
    """wavefront._conformance_decode_core. tail: the wire from the packed
    table on; new_coef: the frame's int32 coefficient planes."""
    wb, hb = aligned_w // MB, aligned_h // MB
    n = wb * hb
    n_waves, p = decode_schedule(wb, hb)
    table = wire_mod.unpack_table_wire(tail[:10 * n], n)
    o = 10 * n
    bi_t = wire_mod._view(tail[o:o + 2 * n_waves * p], torch.int16) \
        .view(n_waves, p)
    o += 2 * n_waves * p
    bj_t = wire_mod._view(tail[o:o + 2 * n_waves * p], torch.int16) \
        .view(n_waves, p)

    block_type = table["block_type"].to(I32)
    is_intra = (block_type & INTRA_BIT) != 0
    is_motion = (block_type & MOTION_BIT) != 0
    is_copy = (block_type & COPY_BIT) != 0
    intra_motion = is_intra & is_motion
    intra_default = is_intra & ~is_motion

    # dense prediction and reconstruction of the blocks that do not read
    # the current frame (the intra-motion ones predict 0 here), from the
    # persistent coefficient planes (K11: the carry, the residual of every
    # block, kept for the wave loop, and the prediction add)
    qp = table["q_index"].to(I32)
    target = torch.where(is_intra, 0, table["prediction_target"].to(I32))
    mx = torch.where(is_motion, table["motion_x"].to(I32), 0)
    my = torch.where(is_motion, table["motion_y"].to(I32), 0)
    sp_pred = is_motion & table["sp_pred"]
    sp_index = table["sp_index"].to(I32)
    pred = wide_pred_planes(
        state, frame_index, target, torch.where(intra_motion, 0, mx),
        torch.where(intra_motion, 0, my), sp_pred & ~intra_motion,
        table["sp_amount"], sp_index, intra_default | intra_motion)
    rec0, coef, res = cuda_tail.decode_tail(
        new_coef, qp, intra_default, is_copy, pred,
        stale=(state["coef_y"], state["coef_u"], state["coef_v"]),
        residual=True)

    # the written planes: the dense blocks over the ring slot's content
    # before this frame (stale, copies of the slot: the ring is written
    # only after the deblock); the wave loop rebuilds the intra-motion
    # blocks in them
    slot = (frame_index % RING).reshape(1).long()
    stale = tuple(state[key].index_select(0, slot)[0]
                  for key in ("ring_y", "ring_u", "ring_v"))
    ymask = engine.mb_mask(~intra_motion, aligned_h, aligned_w)
    cmask = ymask[::2, ::2]
    written = tuple(
        torch.where(mask, r, old).to(torch.int16)
        for r, old, mask in zip(rec0, stale, (ymask, cmask, cmask)))
    if n_active:
        fields = torch.stack([mx, my, sp_pred.to(I32),
                              table["sp_amount"].to(I32), sp_index,
                              is_copy.to(I32)])
        cuda_wavedec.wave_decode(written, stale, res, fields, bi_t, bj_t,
                                 n_active, n_members)

    rec_y, rec_u, rec_v = engine.finish_planes(
        state, *(p.to(I32) for p in written), frame_index, is_copy, qp,
        deblock)
    state["coef_y"], state["coef_u"], state["coef_v"] = coef
    pack = (wire_mod.pack_yuv5d_wire if out_fmt == "yuv5d"
            else wire_mod.pack_yuv_wire)
    return state, pack(rec_y, rec_u, rec_v,
                       frame_w if frame_w is not None else aligned_w,
                       frame_h if frame_h is not None else aligned_h)
