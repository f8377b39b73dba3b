"""Copy of cairo_tpu.cpuref.deblock: the in-loop deblocking filter
(deblock.cpp) in its exact sequential edge order.

Edges are processed on an 8-px grid: first the top row band's vertical edges,
then per 8-row band: horizontal edge at column 0, then for each interior
column: horizontal edge, then vertical edge (deblock.cpp:201-254). Later
edges read pixels already rewritten by earlier edges (in-place), so the order
is part of the wire behavior. Within one 8-pixel edge segment the rows are
independent, so each segment is vectorized.

Strength: 0 if both adjacent blocks are copies, 1 if exactly one, else 2
(deblock.cpp:67-79). Average QP gates through alpha/beta threshold tables.
"""

from __future__ import annotations

import numpy as np

from . import tables
from .blocktypes import BlockTable, is_copy
from .xmath import rounded_div

STEP = 8


def _avg_qp(left_copy, right_copy, left_q, right_q) -> int:
    if not left_copy and not right_copy:
        return (int(left_q) + int(right_q)) >> 1
    if not left_copy:
        return int(left_q)
    if not right_copy:
        return int(right_q)
    return 0


def _filter_segment(p: np.ndarray, q: np.ndarray, avg_qp: int, strength: int,
                    is_luma: bool) -> tuple[np.ndarray, np.ndarray]:
    """Filters one edge segment.

    p: (8, 4) int32 samples [p0, p1, p2, p3] per row; q: (8, 4) [q0..q3].
    Returns updated (p, q) (only p0..p2/q0..q2 may change).
    """
    p0, p1, p2, p3 = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    q0, q1, q2, q3 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    alpha = int(tables.DEBLOCK_ALPHA[avg_qp])
    beta = int(tables.DEBLOCK_BETA[avg_qp])
    keep = ((np.abs(p0 - q0) >= alpha) | (np.abs(p1 - p0) >= beta)
            | (np.abs(q1 - q0) >= beta))

    new_p = p.copy()
    new_q = q.copy()
    if strength == 2:
        new_p[:, 0] = rounded_div(p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1, 8)
        new_p[:, 1] = rounded_div(p2 + p1 + p0 + q0, 4)
        new_q[:, 0] = rounded_div(p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2, 8)
        new_q[:, 1] = rounded_div(p0 + q0 + q1 + q2, 4)
        if is_luma:
            new_p[:, 2] = rounded_div(2 * p3 + 3 * p2 + p1 + p0 + q0, 8)
            new_q[:, 2] = rounded_div(2 * q3 + 3 * q2 + q1 + q0 + p0, 8)
    elif strength == 1:
        new_p[:, 0] = rounded_div((q0 + p0) * 4 + p1 - q1, 8)
        new_q[:, 0] = rounded_div((q0 + p0) * 4 + q1 - p1, 8)
        if is_luma:
            new_p[:, 1] = rounded_div(p2 * 4 + p0 * 2 + q0 * 2, 8)
            new_q[:, 1] = rounded_div(q2 * 4 + q0 * 2 + p0 * 2, 8)

    new_p[keep] = p[keep]
    new_q[keep] = q[keep]
    return new_p, new_q


def _edge_vertical(plane: np.ndarray, x: int, y: int, avg_qp: int,
                   strength: int, is_luma: bool):
    seg = plane[y:y + STEP, x - 4:x + 4].astype(np.int32)
    p = seg[:, ::-1][:, 4:]  # columns x-1..x-4 -> p0..p3
    q = seg[:, 4:]
    new_p, new_q = _filter_segment(p, q, avg_qp, strength, is_luma)
    plane[y:y + STEP, x - 4:x] = new_p[:, ::-1].astype(np.int16)
    plane[y:y + STEP, x:x + 4] = new_q.astype(np.int16)


def _edge_horizontal(plane: np.ndarray, x: int, y: int, avg_qp: int,
                     strength: int, is_luma: bool):
    seg = plane[y - 4:y + 4, x:x + STEP].astype(np.int32).T
    p = seg[:, ::-1][:, 4:]
    q = seg[:, 4:]
    new_p, new_q = _filter_segment(p, q, avg_qp, strength, is_luma)
    plane[y - 4:y, x:x + STEP] = new_p[:, ::-1].T.astype(np.int16)
    plane[y:y + 4, x:x + STEP] = new_q.T.astype(np.int16)


def deblock_plane(plane: np.ndarray, bt: BlockTable, mb_size: int,
                  is_luma: bool):
    """deblock_image (deblock.cpp:201-254) on one plane, in place."""
    height, width = plane.shape
    width_in_blocks = width // mb_size
    copy = is_copy(bt.block_type)
    q_index = bt.q_index

    def strength_qp(ai, aj, bi, bj):
        a = (ai // mb_size) + (aj // mb_size) * width_in_blocks
        b = (bi // mb_size) + (bj // mb_size) * width_in_blocks
        ca, cb = bool(copy[a]), bool(copy[b])
        qp = _avg_qp(ca, cb, q_index[a], q_index[b])
        strength = 0 if (ca and cb) else (1 if ca != cb else 2)
        return strength, qp

    for i in range(STEP, width, STEP):
        strength, qp = strength_qp(i - 1, 0, i, 0)
        if strength:
            _edge_vertical(plane, i, 0, qp, strength, is_luma)

    for j in range(STEP, height, STEP):
        strength, qp = strength_qp(0, j - 1, 0, j)
        if strength:
            _edge_horizontal(plane, 0, j, qp, strength, is_luma)
        for i in range(STEP, width, STEP):
            strength, qp = strength_qp(i, j - 1, i, j)
            if strength:
                _edge_horizontal(plane, i, j, qp, strength, is_luma)
            strength, qp = strength_qp(i - 1, j, i, j)
            if strength:
                _edge_vertical(plane, i, j, qp, strength, is_luma)


def deblock_image_set(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                      bt: BlockTable):
    """deblock_image_set (deblock.cpp:256-275): Y at MB granularity, chroma
    at half (same block-table indexing since chroma planes are half-size)."""
    deblock_plane(y, bt, tables.MACROBLOCK_SIZE, True)
    deblock_plane(u, bt, tables.MACROBLOCK_SIZE // 2, False)
    deblock_plane(v, bt, tables.MACROBLOCK_SIZE // 2, False)
