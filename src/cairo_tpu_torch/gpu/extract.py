"""Per-macroblock window extraction (counterpart of
cairo_tpu/tpu/extract.py), used by the plain versions of the prediction
kernels (cuda_pred), the exact inter search (motion.inter_search_exact,
K5's plain version) and the wave pass (K6's plain version).

The JAX package selects blocks from windows with one-hot matmuls because
TPU gathers are slow; here `extract_blocks` is a plain integer gather
with the same offset clamping, exact on every device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mb_windows(plane, mb_size: int, pad: int, prepad_x: int = 0):
    """(H, W + 2*prepad_x) plane -> (hb*wb, S, S) windows, S =
    mb_size+2*pad, over the (H, W) core.

    Window n covers core rows [py-pad, py+mb_size+pad) and columns
    [px-pad, px+mb_size+pad) for the MB at (px, py); out-of-plane area is
    zero. `prepad_x` marks a horizontal margin the plane already has (a
    tile's halo of its neighbours' columns, gpu/shard.py), read instead of
    zero padding (extract.py:26-46)."""
    height = plane.shape[0]
    width = plane.shape[1] - 2 * prepad_x
    size = mb_size + 2 * pad
    if prepad_x > pad:
        plane = plane[:, prepad_x - pad:plane.shape[1] - (prepad_x - pad)]
    padded = F.pad(plane, (max(pad - prepad_x, 0), max(pad - prepad_x, 0),
                           pad, pad))
    wins = padded.unfold(0, size, mb_size).unfold(1, size, mb_size)
    hb, wb = height // mb_size, width // mb_size
    return wins[:hb, :wb].reshape(hb * wb, size, size)


def extract_blocks(windows, ox, oy, block: int):
    """(N, block, block) blocks at per-window offsets (ox, oy), each
    clamped to the window (0 = top-left)."""
    n, size, _ = windows.shape
    ox = torch.clamp(ox.long(), 0, size - block)
    oy = torch.clamp(oy.long(), 0, size - block)
    iota = torch.arange(block, device=windows.device)
    rows = (oy[:, None] + iota)[:, :, None]
    cols = (ox[:, None] + iota)[:, None, :]
    return windows[torch.arange(n, device=windows.device)[:, None, None],
                   rows, cols]


def extract_blocks_multi(windows, ox, oy, block: int):
    """(N, K, block, block) blocks at K per-window offsets: ox/oy (N, K),
    each clamped to the window (counterpart of extract_blocks_multi,
    extract.py:99)."""
    n, size, _ = windows.shape
    ox = torch.clamp(ox.long(), 0, size - block)
    oy = torch.clamp(oy.long(), 0, size - block)
    iota = torch.arange(block, device=windows.device)
    rows = (oy[:, :, None] + iota)[:, :, :, None]
    cols = (ox[:, :, None] + iota)[:, :, None, :]
    return windows[torch.arange(n, device=windows.device)[:, None, None,
                                                          None], rows, cols]
