"""Batched inter motion search (counterpart of cairo_tpu/tpu/motion.py).

Fast mode (`inter_search`, motion.py:398-527), per reference frame: the
chroma abs-max maps (K1) and the dense full-pel search over [-16, 16]^2
(K2) pick each macroblock's offset (`full_pel`); then the sub-pel
windows (K3) around it feed the reference's 8-direction half / quarter
refinement (K9), whose acceptance folds in the reference's order. The
fast encoder runs `full_pel` per reference and one K9 launch for all of
them, the classification merge included
(cuda_motion.subpel_classify).

Conformance mode (`inter_search_exact`, motion.py:86-236): the
reference's hill-climb replayed for every MB at once, the building block
of K5's plain version (cuda_inter.inter_search_plain), with
`merge_descs` as the classify merge across reference frames.
"""

from __future__ import annotations

import torch

from .. import tables
from . import cuda_motion, cuda_pred, extract, ops
from .cuda_motion import SP_DIRS, block_mad, block_sad, fold_subpel

MB = tables.MACROBLOCK_SIZE
SAD_THRESHOLD = tables.MOTION_SAD_THRESHOLD
DENSE_R = tables.MOTION_SEARCH_RADIUS
I32 = torch.int32


def accept_full(c_sad, c_mad, c_ssd, sad, mad, ssd, mad_thr):
    """Full-pel acceptance of a candidate against the best so far
    (motion.cpp:111-149; wavefront._eval_accept). Keeps the reference's
    C-precedence quirk: the SAD-tie term needs c_sad < SAD_THRESHOLD, and
    c_mad < mad_thr is OR-ed outside it."""
    copy = (c_mad < mad) | ((c_mad == mad) & (c_ssd < ssd))
    plain = (c_sad < sad) | \
        ((c_sad == sad) & (c_ssd < ssd) & (c_sad < SAD_THRESHOLD)) | \
        (c_mad < mad_thr)
    return torch.where(mad < mad_thr, copy, plain)


def fold_full(state, vals, ok, mad_thr):
    """Folds K full-pel candidates into the search state in scan order.
    state: (5, N) stacked [x, y, sad, mad, ssd]; vals: (5, N, K) the
    candidates' same fields; ok: (N, K) whether each may be taken."""
    for k in range(vals.shape[2]):
        c = vals[:, :, k]
        acc = ok[:, k] & accept_full(c[2], c[3], c[4], state[2], state[3],
                                     state[4], mad_thr)
        state = torch.where(acc, c, state)
    return state


def full_pel(src_planes, ref_planes, ring, slot, mad_thr, *, x0=0,
             full_width=None, halo=0):
    """The full-pel half of the fast search against one reference frame:
    the chroma abs-max maps (K1), the dense search (K2) and the sub-pel
    windows (K3) around its choice. Returns (wins, mx, my, best_sad,
    best_mad, frozen), what the sub-pel scan (K9) takes of a reference.
    mad_thr: (quality >> 2) + 1, an int32 scalar tensor; the other
    arguments as inter_search takes them."""
    height = src_planes[0].shape[0]
    width = full_width if full_width is not None else src_planes[0].shape[1]
    cmax = cuda_motion.chroma_max_maps(src_planes[1], src_planes[2],
                                       ref_planes[1], ref_planes[2],
                                       halo // 2)
    mx, my, best_sad, best_mad, frozen = cuda_motion.dense_select(
        src_planes[0], ref_planes[0], cmax, x0, width, height, mad_thr,
        halo)
    wins = cuda_pred.gather_windows_yuv(ring, slot, mx, my, halo)
    return wins, mx, my, best_sad, best_mad, frozen


def inter_search(src, src_planes, ref_planes, ring, slot, px, py, quality,
                 *, x0=0, full_width=None, halo=0):
    """Dense fast-mode search of every MB against one reference frame.

    src: per-MB (Y (N,16,16), U (N,8,8), V (N,8,8)) int32 blocks, as
    tpu.motion.inter_search takes them (the sub-pel scan, K9, reads the
    same samples from src_planes); src_planes: (y, u, v) int32 planes;
    ref_planes: (y, u, v) int16 planes of the same heights, carrying a
    horizontal margin of `halo` columns each side (halo // 2 in chroma; 0
    on a single card); ring: (ring_y, ring_u, ring_v) stacks of those
    planes and `slot` the reference's ring slot (int32 scalar tensor) for
    the sub-pel windows; px/py: (N,) MB pixel coordinates; quality: int32
    scalar tensor. Under tiling (gpu/shard.py), `x0` is the tile's pixel
    origin and `full_width` the aligned frame width, so candidate
    validity is judged against the whole frame while addressing stays
    tile-local, and the margin holds the neighbouring tiles' pixels
    (tpu/motion.py:398-445). The fast encoder's classification runs
    full_pel per reference and one sub-pel scan for all of them
    (engine._classify_inter)."""
    width = full_width if full_width is not None else src_planes[0].shape[1]
    mad_thr = (quality >> 2) + 1
    wins, mx, my, best_sad, best_mad, frozen = full_pel(
        src_planes, ref_planes, ring, slot, mad_thr, x0=x0,
        full_width=full_width, halo=halo)
    out = cuda_motion.subpel_scan(wins, src_planes, mx, my, best_sad,
                                  best_mad, frozen, px, py, x0, width,
                                  src_planes[0].shape[0], mad_thr)
    return dict(sad=out.pop("sad"), mad=out.pop("mad"), motion_x=mx,
                motion_y=my, **out)


# --------------------------------------------------------------------------
# Order-exact search (conformance encode; counterpart of tpu/motion.py:30-236)

INT32_MAX = 0x7FFFFFFF
Y_PAD = 2 * DENSE_R      # max cumulative ring offset is +-31, sub-pel +-1
C_PAD = DENSE_R + 1
RING_STEPS = (16, 8, 4, 2, 1)


def search_windows(ref_planes):
    """Per-MB search windows of one reference frame: Y (N, 80, 80),
    U/V (N, 42, 42), int32, zero outside the plane."""
    y, u, v = ref_planes
    return (extract.mb_windows(y.to(I32), MB, Y_PAD),
            extract.mb_windows(u.to(I32), MB // 2, C_PAD),
            extract.mb_windows(v.to(I32), MB // 2, C_PAD))


def window_blocks(wins, mx, my):
    """Candidate blocks at per-MB motion offset (mx, my) from the windows."""
    wy, wu, wv = wins
    return (extract.extract_blocks(wy, mx + Y_PAD, my + Y_PAD, MB),
            extract.extract_blocks(wu, (mx >> 1) + C_PAD, (my >> 1) + C_PAD,
                                   MB // 2),
            extract.extract_blocks(wv, (mx >> 1) + C_PAD, (my >> 1) + C_PAD,
                                   MB // 2))


def window_blocks_multi(wins, mx, my):
    """K candidates per MB at once: mx/my (N, K) -> (N, K, ...) blocks."""
    wy, wu, wv = wins
    return (extract.extract_blocks_multi(wy, mx + Y_PAD, my + Y_PAD, MB),
            extract.extract_blocks_multi(wu, (mx >> 1) + C_PAD,
                                         (my >> 1) + C_PAD, MB // 2),
            extract.extract_blocks_multi(wv, (mx >> 1) + C_PAD,
                                         (my >> 1) + C_PAD, MB // 2))


def sad_k(src_y, cand_y):
    return (src_y[:, None] - cand_y).abs().sum(dim=(2, 3), dtype=I32)


def mad_k(src, cand):
    m = [(s[:, None] - c).abs().amax(dim=(2, 3)) for s, c in zip(src, cand)]
    return torch.maximum(m[0], torch.maximum(m[1], m[2])).to(I32)


def merge_descs(a, b):
    """classify_block merge (encode.cpp:36-54; wavefront._merge_descs):
    copy status dominates, then strictly lower SAD; ties keep `a`."""
    take = torch.where(a["is_copy"] != b["is_copy"], b["is_copy"],
                       b["sad"] < a["sad"])
    return {k: torch.where(take, b[k], a[k]) for k in a}


def inter_search_exact(src, ref_planes, px, py, quality):
    """The reference's inter search (motion.cpp:421-494) for every MB
    against one reference frame, in its exact evaluation order: the
    co-located early-out, 5 rings x 9 candidates from the frozen
    ring-entry best, then 8 directions x {half, quarter} sub-pel.

    src: (Y (N,16,16), U (N,8,8), V (N,8,8)) int32 source blocks;
    ref_planes: (y, u, v) planes; px/py: (N,) MB pixel coordinates;
    quality: int32 scalar tensor."""
    height, width = ref_planes[0].shape
    mad_thr = (quality >> 2) + 1
    wins = search_windows(ref_planes)
    n = px.shape[0]
    zero = torch.zeros(n, dtype=I32, device=px.device)

    colocated = window_blocks(wins, zero, zero)
    co_sad = block_sad(src[0], colocated[0])
    co_mad = block_mad(src, colocated)
    frozen = co_mad < mad_thr

    def in_bounds(cx, cy):
        gx, gy = px[:, None] + cx, py[:, None] + cy
        return (gx >= 0) & (gx <= width - MB) & (gy >= 0) & \
            (gy <= height - MB)

    # best position, then sad, mad, ssd: one stacked state, so each
    # accepted candidate is one select
    state = torch.stack([zero, zero, co_sad, co_mad,
                         torch.full_like(zero, INT32_MAX)])
    for step in RING_STEPS:
        offs = torch.tensor([(i, j) for j in (-step, 0, step)
                             for i in (-step, 0, step)], dtype=I32,
                            device=px.device)
        cx = state[0][:, None] + offs[:, 0]    # frozen ring base (N, 9)
        cy = state[1][:, None] + offs[:, 1]
        ok = in_bounds(cx, cy) & ~frozen[:, None]
        cand = window_blocks_multi(wins, cx, cy)
        vals = torch.stack([cx, cy, sad_k(src[0], cand[0]), mad_k(src, cand),
                            cx * cx + cy * cy])
        state = fold_full(state, vals, ok, mad_thr)
    mx, my = state[0], state[1]
    best = window_blocks(wins, mx, my)

    def cands():
        for di, dj, idx in SP_DIRS:
            tx, ty = mx + di, my + dj
            ok = in_bounds(tx[:, None], ty[:, None])[:, 0] & ~frozen
            test = window_blocks(wins, tx, ty)
            for amount, lerp in ((False, ops.lerp_half),
                                 (True, ops.lerp_quarter)):
                cand = tuple(lerp(b, t) for b, t in zip(best, test))
                yield (ok, amount, idx, block_sad(src[0], cand[0]),
                       block_mad(src, cand))

    sad_s, mad_s, sp_enabled, sp_amount, sp_index = fold_subpel(
        state[2], state[3], cands(), mad_thr)

    motion = (mx != 0) | (my != 0) | sp_enabled
    return dict(sad=sad_s, mad=mad_s, motion_x=mx, motion_y=my,
                is_motion=motion, is_copy=mad_s < mad_thr,
                sp_pred=sp_enabled, sp_amount=sp_amount, sp_index=sp_index)
