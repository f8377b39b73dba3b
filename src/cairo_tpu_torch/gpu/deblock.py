"""In-loop deblocking on torch tensors, band-scan formulation (counterpart
of cairo_tpu/tpu/deblock.py).

The reference's edge order (deblock.cpp:201-254) is band 0's vertical
edges, then per 8-row band its horizontal edges and then its vertical
edges. Within a band the horizontal edges are pairwise disjoint, and so
are the vertical ones, so each band runs as two vectorized passes. This
version keeps the reference's band order, band after band, updating the
plane in place: band b's horizontal edges read rows that band b-1's
vertical edges wrote. The order is deeper than the data dependence,
which is three parallel passes (csrc/deblock.cu's header); K8 runs
those, and this version, its oracle on the card, does not share that
formulation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables
from .ops import rounded_div_pos, settled

STEP = 8
I32 = torch.int32


@functools.lru_cache(maxsize=None)
def _thresholds(device: str):
    return settled(device, (
        torch.as_tensor(tables.DEBLOCK_ALPHA.astype(np.int32),
                        device=device),
        torch.as_tensor(tables.DEBLOCK_BETA.astype(np.int32),
                        device=device)))


def _edge_maps(copy_blocks, q_blocks, cells_y, cells_x, mb_cells):
    """Per-8px-cell strength and avg-QP maps: (vs, vqp) for vertical edges
    between cell columns, (hs, hqp) for horizontal edges between cell
    rows. copy_blocks/q_blocks: (hb, wb) per-MB tensors."""
    dev = copy_blocks.device
    cy = torch.arange(cells_y, device=dev) // mb_cells
    cx = torch.arange(cells_x, device=dev) // mb_cells
    copy_c = copy_blocks[cy][:, cx]
    q_c = q_blocks[cy][:, cx].to(I32)

    def strength_qp(copy_a, copy_b, qa, qb):
        strength = torch.where(copy_a & copy_b, 0,
                               torch.where(copy_a ^ copy_b, 1, 2)).to(I32)
        qp = torch.where(~copy_a & ~copy_b, (qa + qb) >> 1,
                         torch.where(~copy_a, qa,
                                     torch.where(~copy_b, qb, 0)))
        return strength, qp

    vs, vqp = strength_qp(copy_c[:, :-1], copy_c[:, 1:],
                          q_c[:, :-1], q_c[:, 1:])
    hs, hqp = strength_qp(copy_c[:-1, :], copy_c[1:, :],
                          q_c[:-1, :], q_c[1:, :])
    return vs, vqp, hs, hqp


def _filter(p3, p2, p1, p0, q0, q1, q2, q3, strength, qp, is_luma):
    """deblock_filter_values (deblock.cpp:81-129), element-wise."""
    alpha_t, beta_t = _thresholds(str(p0.device))
    qpl = qp.long()
    alpha = alpha_t[qpl]
    beta = beta_t[qpl]
    keep = (torch.abs(p0 - q0) >= alpha) | (torch.abs(p1 - p0) >= beta) | \
           (torch.abs(q1 - q0) >= beta) | (strength == 0)

    s2_p0 = rounded_div_pos(p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1, 8)
    s2_p1 = rounded_div_pos(p2 + p1 + p0 + q0, 4)
    s2_q0 = rounded_div_pos(p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2, 8)
    s2_q1 = rounded_div_pos(p0 + q0 + q1 + q2, 4)
    s1_p0 = rounded_div_pos((q0 + p0) * 4 + p1 - q1, 8)
    s1_q0 = rounded_div_pos((q0 + p0) * 4 + q1 - p1, 8)

    is2 = strength == 2
    new_p0 = torch.where(is2, s2_p0, s1_p0)
    new_q0 = torch.where(is2, s2_q0, s1_q0)
    if is_luma:
        s2_p2 = rounded_div_pos(2 * p3 + 3 * p2 + p1 + p0 + q0, 8)
        s2_q2 = rounded_div_pos(2 * q3 + 3 * q2 + q1 + q0 + p0, 8)
        s1_p1 = rounded_div_pos(p2 * 4 + p0 * 2 + q0 * 2, 8)
        s1_q1 = rounded_div_pos(q2 * 4 + q0 * 2 + p0 * 2, 8)
        new_p1 = torch.where(is2, s2_p1, s1_p1)
        new_q1 = torch.where(is2, s2_q1, s1_q1)
        new_p2 = torch.where(is2, s2_p2, p2)
        new_q2 = torch.where(is2, s2_q2, q2)
    else:
        new_p1 = torch.where(is2, s2_p1, p1)
        new_q1 = torch.where(is2, s2_q1, q1)
        new_p2, new_q2 = p2, q2

    def pick(new, old):
        return torch.where(keep, old, new)

    return (pick(new_p2, p2), pick(new_p1, p1), pick(new_p0, p0),
            pick(new_q0, q0), pick(new_q1, q1), pick(new_q2, q2))


def _vertical_pass(rows8, vs_row, vqp_row, is_luma):
    """All vertical edges of one band, in place. rows8: (8, W) view."""
    width = rows8.shape[1]
    nb = width // STEP - 1
    win = rows8[:, 4:width - 4].reshape(8, nb, STEP)
    taps = [win[:, :, i] for i in range(8)]
    new = _filter(*taps, vs_row[None, :], vqp_row[None, :], is_luma)
    win[:, :, 1:7] = torch.stack(new, -1)  # win is a view into the plane


def _horizontal_pass(rows8, hs_row, hqp_row, is_luma):
    """All horizontal edges of one band boundary, in place. rows8: (8, W)
    view of rows y-4..y+3; the edge sits between rows 3 and 4."""
    p0, p1, p2, p3 = rows8[3], rows8[2], rows8[1], rows8[0]
    q0, q1, q2, q3 = rows8[4], rows8[5], rows8[6], rows8[7]
    new = _filter(p3, p2, p1, p0, q0, q1, q2, q3,
                  hs_row.repeat_interleave(STEP),
                  hqp_row.repeat_interleave(STEP), is_luma)
    rows8[1:7] = torch.stack(new, 0)


def deblock_plane(plane, copy_blocks, q_blocks, mb_size, is_luma):
    """Runs the in-loop filter over one (H, W) int32 plane; returns a new
    plane."""
    plane = plane.to(I32).clone()
    height, width = plane.shape
    cells_y, cells_x = height // STEP, width // STEP
    vs, vqp, hs, hqp = _edge_maps(copy_blocks, q_blocks, cells_y, cells_x,
                                  mb_size // STEP)
    _vertical_pass(plane[0:STEP], vs[0], vqp[0], is_luma)
    for b in range(1, cells_y):
        y = b * STEP
        _horizontal_pass(plane[y - 4:y + 4], hs[b - 1], hqp[b - 1], is_luma)
        _vertical_pass(plane[y:y + STEP], vs[b], vqp[b], is_luma)
    return plane


def deblock_frame(y, u, v, copy_blocks, q_blocks):
    """Y at 16-px block granularity, chroma at 8 (deblock.cpp:256-275)."""
    return (deblock_plane(y, copy_blocks, q_blocks, 16, True),
            deblock_plane(u, copy_blocks, q_blocks, 8, False),
            deblock_plane(v, copy_blocks, q_blocks, 8, False))
