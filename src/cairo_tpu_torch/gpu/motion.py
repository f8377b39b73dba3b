"""Batched fast-mode inter motion search (counterpart of the fast path of
cairo_tpu/tpu/motion.py, `inter_search` at motion.py:398-527).

Per reference frame: the chroma abs-max maps (K1) and the dense full-pel
search over [-16, 16]^2 (K2) pick each macroblock's offset; then the
sub-pel windows (K3) around it feed the reference's 8-direction half /
quarter refinement, whose acceptance folds in the reference's order.
"""

from __future__ import annotations

import torch

from .. import tables
from ..blocktypes import sp_dir_to_index
from . import cuda_motion, cuda_pred, ops

MB = tables.MACROBLOCK_SIZE
SAD_THRESHOLD = tables.MOTION_SAD_THRESHOLD
DENSE_R = tables.MOTION_SEARCH_RADIUS
Y_WPAD = cuda_pred.Y_PAD
C_WPAD = cuda_pred.C_PAD
I32 = torch.int32

# (di, dj, sp index) in the reference's evaluation order
SP_DIRS = [(di, dj, sp_dir_to_index(di, dj))
           for dj in (-1, 0, 1) for di in (-1, 0, 1) if (di, dj) != (0, 0)]


def _sad(src_y, cand_y):
    return (src_y - cand_y).abs().sum(dim=(1, 2), dtype=I32)


def _mad(src, cand):
    m = [(s - c).abs().amax(dim=(1, 2)) for s, c in zip(src, cand)]
    return torch.maximum(m[0], torch.maximum(m[1], m[2])).to(I32)


def _chroma_slice(win, cdx, cdy):
    """(N, 10, 10) windows -> (N, 8, 8) at per-MB shifts cdx/cdy in -1..1."""
    rows = [win[:, i:i + 8, :] for i in range(3)]
    r = torch.where((cdy == -1)[:, None, None], rows[0],
                    torch.where((cdy == 0)[:, None, None], rows[1], rows[2]))
    cols = [r[:, :, i:i + 8] for i in range(3)]
    return torch.where((cdx == -1)[:, None, None], cols[0],
                       torch.where((cdx == 0)[:, None, None], cols[1],
                                   cols[2]))


def inter_search(src, src_planes, ref_planes, ring, slot, px, py, quality,
                 *, x0=0, full_width=None):
    """Dense fast-mode search of every MB against one reference frame.

    src: per-MB (Y (N,16,16), U (N,8,8), V (N,8,8)) int32 blocks;
    src_planes: (y, u, v) int32 planes; ref_planes: (y, u, v) int16 planes
    of the same shapes; ring: (ring_y, ring_u, ring_v) stacks and `slot`
    the reference's ring slot (int32 scalar tensor) for the sub-pel
    windows; px/py: (N,) MB pixel
    coordinates; quality: int32 scalar tensor. `x0` is the tile's pixel
    origin and `full_width` the frame width, so candidate validity is
    judged against the whole frame while addressing stays tile-local."""
    height = src_planes[0].shape[0]
    width = full_width if full_width is not None else src_planes[0].shape[1]
    mad_thr = (quality >> 2) + 1

    cmax = cuda_motion.chroma_max_maps(src_planes[1], src_planes[2],
                                       ref_planes[1], ref_planes[2])
    mx, my, best_sad, best_mad, frozen = cuda_motion.dense_select(
        src_planes[0], ref_planes[0], cmax, x0, width, height, mad_thr)

    # ---- sub-pel refinement windows (per MB, centred on the best mv)
    ywin = cuda_pred.gather_windows(ring[0], slot, mx, my, MB + 2, Y_WPAD)
    uwin = cuda_pred.gather_windows(ring[1], slot, mx >> 1, my >> 1,
                                    MB // 2 + 2, C_WPAD)
    vwin = cuda_pred.gather_windows(ring[2], slot, mx >> 1, my >> 1,
                                    MB // 2 + 2, C_WPAD)
    best_y = ywin[:, 1:17, 1:17]
    best_u = uwin[:, 1:9, 1:9]
    best_v = vwin[:, 1:9, 1:9]

    n = px.shape[0]
    sad_s, mad_s = best_sad, best_mad
    sp_enabled = torch.zeros(n, dtype=torch.bool, device=px.device)
    sp_amount = torch.zeros_like(sp_enabled)
    sp_index = torch.zeros(n, dtype=I32, device=px.device)
    for di, dj, idx in SP_DIRS:
        tmx, tmy = mx + di, my + dj
        valid_sp = ((x0 + px + tmx >= 0) & (x0 + px + tmx <= width - MB) &
                    (py + tmy >= 0) & (py + tmy <= height - MB) & ~frozen)
        test_y = ywin[:, 1 + dj:1 + dj + MB, 1 + di:1 + di + MB]
        # the chroma neighbour's shift depends on the parity of mx/my
        cdx = ((mx + di) >> 1) - (mx >> 1)
        cdy = ((my + dj) >> 1) - (my >> 1)
        test_u = _chroma_slice(uwin, cdx, cdy)
        test_v = _chroma_slice(vwin, cdx, cdy)
        for amount, lerp in ((False, ops.lerp_half), (True, ops.lerp_quarter)):
            cy_ = lerp(best_y, test_y)
            c_sad = _sad(src[0], cy_)
            c_mad = _mad(src, (cy_, lerp(best_u, test_u),
                               lerp(best_v, test_v)))
            copy_branch = mad_s < mad_thr
            accept_copy = c_mad < mad_s
            accept_plain = ((c_sad < sad_s) & (c_sad < SAD_THRESHOLD)) | \
                (c_mad < mad_thr)
            accept = valid_sp & torch.where(copy_branch, accept_copy,
                                            accept_plain)
            sp_enabled = sp_enabled | accept
            sp_amount = torch.where(accept, amount, sp_amount)
            sp_index = torch.where(accept, idx, sp_index)
            sad_s = torch.where(accept, c_sad, sad_s)
            mad_s = torch.where(accept, c_mad, mad_s)

    motion = (mx != 0) | (my != 0) | sp_enabled
    return dict(sad=sad_s, mad=mad_s, motion_x=mx, motion_y=my,
                is_motion=motion, is_copy=mad_s < mad_thr,
                sp_pred=sp_enabled, sp_amount=sp_amount, sp_index=sp_index)
