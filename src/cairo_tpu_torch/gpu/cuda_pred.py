"""Prediction-gather kernels K3 and K4 (counterpart of
cairo_tpu/tpu/pallas_pred.py), with their plain PyTorch versions.

Dispatch, one rule per wrapper: a CPU tensor takes the plain version; a
CUDA tensor launches the kernel of csrc/pred.cu or raises. Each launch
adds one to LAUNCHES[name].

  * gather_windows (K3) replaces pallas_pred.gather_windows
    (pallas_pred.py:313); plain version: extract.extract_blocks over
    extract.mb_windows, as motion.py:454-463 does.
  * pred_planes (K4) replaces pallas_pred.pred_planes (pallas_pred.py:221);
    plain version: the XLA branch of engine._gather_pred (engine.py:94-104)
    with motion.pred_block_from_windows (motion.py:374) at the fast-mode
    pads 17/9, and the XLA branch of wavefront._wide_gather_pred
    (wavefront.py:737-780) at the conformance pads 33/17.
"""

from __future__ import annotations

import torch

from .. import tables
from . import _build, extract, ops

MB = tables.MACROBLOCK_SIZE
RING = tables.REFERENCE_FRAME_COUNT
R = tables.MOTION_SEARCH_RADIUS
Y_PAD = R + 1          # fast-mode prediction window pad (mv +-16, sub-pel 1)
C_PAD = R // 2 + 1
WIDE_YPAD = 2 * R + 1  # conformance inter reach: +-31 full-pel + 1 sub-pel
WIDE_CPAD = R + 1
I32 = torch.int32
DIRS = ((-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0), (-1, 1), (0, 1), (1, 1))

# pred_planes counts its launches at the fast-mode pads and at the wide
# pads apart, so a run shows which of the two paths it took
LAUNCHES = {"gather_windows": 0, "pred_planes": 0, "pred_planes_wide": 0}


def _slot_index(slot, device):
    return torch.as_tensor(slot, dtype=I32, device=device).reshape(1)


# ----------------------------------------------------------------- K3

def gather_windows_plain(planes, slot, mx, my, block, pad):
    plane = planes.index_select(0, _slot_index(slot, planes.device))[0]
    wins = extract.mb_windows(plane.to(I32), block - 2, pad)
    return extract.extract_blocks(wins, mx + pad - 1, my + pad - 1, block)


def gather_windows(planes, slot, mx, my, block, pad):
    """(N, block, block) int32 per-MB windows at offset (mx - 1, my - 1)
    from ring slot `slot` (an int32 scalar tensor). planes: (RING, H, W)
    int16; block = mb_size + 2; pad = the prediction window pad."""
    if planes.device.type == "cpu":
        return gather_windows_plain(planes, slot, mx, my, block, pad)
    ring, h, w = planes.shape
    mb = block - 2
    if h % mb or w % mb:
        raise ValueError("gather_windows: plane dims must be multiples of "
                         "the block size")
    n = (h // mb) * (w // mb)
    dev = planes.device
    slot_t = _slot_index(slot, dev)
    _build.check(planes, "planes", torch.int16)
    _build.check(slot_t, "slot", I32, (1,))
    _build.check(mx, "mx", I32, (n,))
    _build.check(my, "my", I32, (n,))
    out = torch.empty((n, block, block), dtype=I32, device=dev)
    fn = _build.kernel_fn("cairo_gather_windows", "ppppiiiipp")
    _build.launch(fn, dev, planes.data_ptr(), slot_t.data_ptr(),
                  mx.data_ptr(), my.data_ptr(), h, w, block, pad,
                  out.data_ptr())
    LAUNCHES["gather_windows"] += 1
    return out


# ----------------------------------------------------------------- K4

def pred_block_from_windows(wins, mx, my, sp_pred, sp_amount, sp_index,
                            ypad=Y_PAD, cpad=C_PAD):
    """The (possibly sub-pel interpolated) prediction block of every MB
    from its windows of pads ypad/cpad (motion.pred_block_from_windows)."""
    wy, wu, wv = wins
    dirs = torch.tensor(DIRS, dtype=I32, device=mx.device)
    d = dirs[sp_index.long().clamp(0, 7)]
    beta_y = extract.extract_blocks(wy, mx + ypad, my + ypad, MB)
    beta_u = extract.extract_blocks(wu, (mx >> 1) + cpad, (my >> 1) + cpad,
                                    MB // 2)
    beta_v = extract.extract_blocks(wv, (mx >> 1) + cpad, (my >> 1) + cpad,
                                    MB // 2)
    tx, ty = mx + d[:, 0], my + d[:, 1]
    sp_y = extract.extract_blocks(wy, tx + ypad, ty + ypad, MB)
    sp_u = extract.extract_blocks(wu, (tx >> 1) + cpad, (ty >> 1) + cpad,
                                  MB // 2)
    sp_v = extract.extract_blocks(wv, (tx >> 1) + cpad, (ty >> 1) + cpad,
                                  MB // 2)
    use_sp = sp_pred.bool()[:, None, None]
    amount = sp_amount.bool()[:, None, None]
    out = []
    for b, t in ((beta_y, sp_y), (beta_u, sp_u), (beta_v, sp_v)):
        lerp = torch.where(amount, ops.lerp_quarter(b, t),
                           ops.lerp_half(b, t))
        out.append(torch.where(use_sp, lerp, b))
    return tuple(out)


def pred_planes_plain(ring_y, ring_u, ring_v, slot, mx, my, sp_pred,
                      sp_amount, sp_index, zero, ypad=Y_PAD, cpad=C_PAD):
    height, width = ring_y.shape[1:]
    slot = slot.to(I32)

    def pick(stack, block, pad):
        sel = None
        for s in range(RING):
            win = extract.mb_windows(stack[s].to(I32), block, pad)
            m = (slot == s)[:, None, None]
            sel = torch.where(m, win, 0 if sel is None else sel)
        return sel

    wins = (pick(ring_y, MB, ypad), pick(ring_u, MB // 2, cpad),
            pick(ring_v, MB // 2, cpad))
    pred = pred_block_from_windows(wins, mx.to(I32), my.to(I32), sp_pred,
                                   sp_amount, sp_index, ypad, cpad)
    zm = zero.bool()[:, None, None]
    py, pu, pv = (torch.where(zm, 0, p) for p in pred)
    return (ops.blocks_to_plane(py, height, width),
            ops.blocks_to_plane(pu, height // 2, width // 2),
            ops.blocks_to_plane(pv, height // 2, width // 2))


def pred_planes(ring_y, ring_u, ring_v, slot, mx, my, sp_pred, sp_amount,
                sp_index, zero, ypad=Y_PAD, cpad=C_PAD):
    """Prediction planes (pred_y, pred_u, pred_v), int32, of the ring plane
    shapes. ring_*: (RING, H, W) int16; slot/mx/my/sp_index: (N,) int;
    sp_pred/sp_amount/zero: (N,) bool. The motion reach clamps to the
    window pads: ypad/cpad, the fast-mode Y_PAD/C_PAD (17/9) by default;
    the conformance encoder passes WIDE_YPAD/WIDE_CPAD (33/17)."""
    if ring_y.device.type == "cpu":
        return pred_planes_plain(ring_y, ring_u, ring_v, slot, mx, my,
                                 sp_pred, sp_amount, sp_index, zero, ypad,
                                 cpad)
    ring, h, w = ring_y.shape
    if h % MB or w % MB:
        raise ValueError("pred_planes: plane dims must be multiples of 16")
    dev = ring_y.device
    n = (h // MB) * (w // MB)
    _build.check(ring_y, "ring_y", torch.int16, (RING, h, w))
    _build.check(ring_u, "ring_u", torch.int16, (RING, h // 2, w // 2))
    _build.check(ring_v, "ring_v", torch.int16, (RING, h // 2, w // 2))
    per_mb = [t.to(I32).contiguous() for t in
              (slot, mx, my, sp_pred, sp_amount, sp_index, zero)]
    for t, name in zip(per_mb, ("slot", "mx", "my", "sp_pred", "sp_amount",
                                "sp_index", "zero")):
        _build.check(t, name, I32, (n,))
    out_y = torch.empty((h, w), dtype=I32, device=dev)
    out_u = torch.empty((h // 2, w // 2), dtype=I32, device=dev)
    out_v = torch.empty((h // 2, w // 2), dtype=I32, device=dev)
    fn = _build.kernel_fn("cairo_pred_planes", "ppppppppppiiiipppp")
    _build.launch(fn, dev, ring_y.data_ptr(), ring_u.data_ptr(),
                  ring_v.data_ptr(), *(t.data_ptr() for t in per_mb),
                  h, w, ypad, cpad, out_y.data_ptr(), out_u.data_ptr(),
                  out_v.data_ptr())
    LAUNCHES["pred_planes" if (ypad, cpad) == (Y_PAD, C_PAD)
             else "pred_planes_wide"] += 1
    return out_y, out_u, out_v
