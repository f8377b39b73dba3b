"""Copy of cairo_tpu.cpuref.motion: intra/inter motion estimation,
bit-exact with the reference search (motion.cpp).

The search is evaluation-order dependent (argmin ties break toward the first
candidate; each refinement ring re-bases on the current best), so the scan
order here mirrors the C loops exactly. The intra search is additionally
restricted to the causally available region of the *current* reconstruction —
including stale not-yet-overwritten pixels of the ring slot, which is why
encode is raster-sequential (see docs/FORMAT.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import tables
from .blocktypes import (COPY_BIT, INTRA_BIT, MOTION_BIT, sp_dir_to_index)
from .xmath import as_int16, round_out, trunc_div

MB = tables.MACROBLOCK_SIZE
SAD_THRESHOLD = tables.MOTION_SAD_THRESHOLD
RADIUS = tables.MOTION_SEARCH_RADIUS
INT32_MAX = 0x7FFFFFFF


def lerp_half(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """round-away((a+b)/2) (macroblock.h:203-221)."""
    t = a.astype(np.int32) + b.astype(np.int32)
    return as_int16(trunc_div(round_out(t, 1), 2))


def lerp_quarter(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """round-away((3a+b)/4) (macroblock.h:223-241)."""
    t = 3 * a.astype(np.int32) + b.astype(np.int32)
    return as_int16(trunc_div(round_out(t, 2), 4))


class Planes:
    """YUV420 plane triple with 16x16 block views at pixel coordinates."""

    __slots__ = ("y", "u", "v")

    def __init__(self, y, u, v):
        self.y, self.u, self.v = y, u, v

    @property
    def width(self):
        return self.y.shape[1]

    @property
    def height(self):
        return self.y.shape[0]

    def block(self, x: int, y: int):
        cx, cy = x >> 1, y >> 1
        return (self.y[y:y + MB, x:x + MB],
                self.u[cy:cy + 8, cx:cx + 8],
                self.v[cy:cy + 8, cx:cx + 8])


def block_sad(a, b) -> int:
    return int(np.abs(a[0].astype(np.int32) - b[0].astype(np.int32)).sum())


def block_sad_self(a) -> int:
    return int(np.abs(a[0].astype(np.int32)).sum())


def block_mad(a, b) -> int:
    mad = int(np.abs(a[0].astype(np.int32) - b[0].astype(np.int32)).max())
    mad_u = int(np.abs(a[1].astype(np.int32) - b[1].astype(np.int32)).max())
    mad_v = int(np.abs(a[2].astype(np.int32) - b[2].astype(np.int32)).max())
    return max(mad, mad_u, mad_v)


@dataclasses.dataclass
class Selection:
    best_x: int
    best_y: int
    best_sad: int
    best_mad: int
    best_ssd: int
    sp_index: int = 0
    sp_amount: bool = False
    sp_enabled: bool = False


def _evaluate_candidate(cx, cy, px, py, mad_thr, src, pred: Planes, sel: Selection):
    """motion.cpp:111-149 (including the C operator-precedence quirk)."""
    cand = pred.block(cx, cy)
    sad = block_sad(src, cand)
    ssd = (cx - px) ** 2 + (cy - py) ** 2
    mad = block_mad(src, cand)
    if sel.best_mad < mad_thr:
        accept = mad < sel.best_mad or (mad == sel.best_mad and ssd < sel.best_ssd)
    else:
        accept = (sad < sel.best_sad
                  or ((sad == sel.best_sad and ssd < sel.best_ssd)
                      and sad < SAD_THRESHOLD)
                  or mad < mad_thr)
    if accept:
        sel.best_x, sel.best_y = cx, cy
        sel.best_sad, sel.best_ssd, sel.best_mad = sad, ssd, mad


def _scan(left, top, right, bottom, step, px, py, mad_thr, src, pred, sel,
          causal: bool):
    base_x, base_y = sel.best_x, sel.best_y
    for j in range(top, bottom + 1, step):
        for i in range(left, right + 1, step):
            cx, cy = base_x + i, base_y + j
            if causal and cy > py - MB and cx > px - MB:
                continue
            if not (0 <= cx <= pred.width - MB and 0 <= cy <= pred.height - MB):
                continue
            _evaluate_candidate(cx, cy, px, py, mad_thr, src, pred, sel)


def _evaluate_subpel(tx, ty, di, dj, px, py, mad_thr, src, pred, best_block, sel):
    """motion.cpp:151-223: half- then quarter-pel lerp against the test block."""
    test = pred.block(tx, ty)
    for amount, fn in ((False, lerp_half), (True, lerp_quarter)):
        cache = tuple(fn(a, b) for a, b in zip(best_block, test))
        sad = block_sad(src, cache)
        mad = block_mad(src, cache)
        if sel.best_mad < mad_thr:
            accept = mad < sel.best_mad
        else:
            accept = (sad < sel.best_sad and sad < SAD_THRESHOLD) or mad < mad_thr
        if accept:
            sel.sp_enabled = True
            sel.sp_amount = amount
            sel.sp_index = sp_dir_to_index(di, dj)
            sel.best_sad, sel.best_mad = sad, mad


def _subpel_search(px, py, mad_thr, src, pred, sel, causal: bool):
    best_block = pred.block(sel.best_x, sel.best_y)
    sel.sp_index = 0
    sel.sp_amount = False
    sel.sp_enabled = False
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            tx, ty = sel.best_x + di, sel.best_y + dj
            if causal and ty > py - MB and tx > px - MB:
                continue
            if not (0 <= tx <= pred.width - MB and 0 <= ty <= pred.height - MB):
                continue
            _evaluate_subpel(tx, ty, di, dj, px, py, mad_thr, src, pred,
                             best_block, sel)


def _fill_desc(sel: Selection, px, py, pred_target, intra: bool,
               mad_thr: int) -> dict:
    block_type = INTRA_BIT if intra else 0
    if sel.best_x != px or sel.best_y != py or sel.sp_enabled:
        block_type |= MOTION_BIT
    if sel.best_mad < mad_thr:
        block_type |= COPY_BIT
    return dict(block_type=block_type, prediction_target=pred_target,
                motion_x=sel.best_x - px, motion_y=sel.best_y - py,
                sp_pred=sel.sp_enabled, sp_amount=sel.sp_amount,
                sp_index=sel.sp_index)


def intra_prediction(quality: int, src, px: int, py: int, pred: Planes):
    """calculate_intra_prediction (motion.cpp:354-419): triangle scan above/
    left at radius 16, halving refinement, then sub-pel. Returns (sad, desc)."""
    mad_thr = (quality >> 2) + 1
    sel = Selection(px, py, block_sad_self(src), INT32_MAX, INT32_MAX)
    _scan(-RADIUS, -(RADIUS << 1), RADIUS, 0, RADIUS, px, py, mad_thr, src,
          pred, sel, causal=True)
    step = RADIUS >> 1
    while step > 0:
        _scan(-step, -step, step, step, step, px, py, mad_thr, src, pred, sel,
              causal=True)
        step >>= 1
    _subpel_search(px, py, mad_thr, src, pred, sel, causal=True)
    return sel.best_sad, _fill_desc(sel, px, py, 0, intra=True, mad_thr=mad_thr)


def inter_prediction(quality: int, src, px: int, py: int, pred: Planes,
                     pred_offset: int):
    """calculate_inter_prediction (motion.cpp:421-494): co-located early-out,
    square scan at radii 16,8,4,2,1, then sub-pel. Returns (sad, desc)."""
    mad_thr = (quality >> 2) + 1
    colocated = pred.block(px, py)
    sel = Selection(px, py, block_sad(src, colocated), block_mad(src, colocated),
                    INT32_MAX)
    if sel.best_mad >= mad_thr:
        step = RADIUS
        while step > 0:
            _scan(-step, -step, step, step, step, px, py, mad_thr, src, pred,
                  sel, causal=False)
            step >>= 1
        _subpel_search(px, py, mad_thr, src, pred, sel, causal=False)
    return sel.best_sad, _fill_desc(sel, px, py, pred_offset, intra=False,
                                    mad_thr=mad_thr)
