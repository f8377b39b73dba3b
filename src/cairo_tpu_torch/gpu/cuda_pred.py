"""Prediction-gather kernels K3 and K4 (counterpart of
cairo_tpu/tpu/pallas_pred.py), with their plain PyTorch versions.

Dispatch, one rule per wrapper: a CPU tensor takes the plain version; a
CUDA tensor launches the kernel of csrc/pred.cu or raises. Each launch
adds one to LAUNCHES[name].

  * gather_windows (K3) replaces pallas_pred.gather_windows
    (pallas_pred.py:313); plain version: extract.extract_blocks over
    extract.mb_windows, as motion.py:454-463 does. gather_windows_yuv
    launches the same kernel once for the three calls of motion.py:448-453
    (Y at 18/17, U and V at 10/9 with offsets (mx >> 1, my >> 1)); its
    plain version is those three calls.
  * pred_planes (K4) replaces pallas_pred.pred_planes (pallas_pred.py:221);
    plain version: the XLA branch of engine._gather_pred (engine.py:94-104)
    with motion.pred_block_from_windows (motion.py:374) at the fast-mode
    pads 17/9, and the XLA branch of wavefront._wide_gather_pred
    (wavefront.py:737-780) at the conformance pads 33/17.

gather_windows_yuv and pred_planes take a ring with a halo: (RING, H,
W + 2 halo) luma and (RING, H/2, W/2 + halo) chroma stacks whose core
column x lies at x + halo (x + halo/2 in chroma). Their windows and
planes are the (H, W) core's, as extract.mb_windows(prepad_x=halo) cuts
them (tpu/motion.py:366-371, the tiled path's windows). halo is 0 on a
single card and shard.HALO (32) on a tile's ring. Every launch with a
halo also adds one to HALO_LAUNCHES[name]. The single-plane
gather_windows takes no halo.
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
HALO_LAUNCHES = {"gather_windows": 0, "pred_planes": 0,
                 "pred_planes_wide": 0}


# the geometries the kernels are built for: K3's (block, pad), luma then
# chroma, and K4's (ypad, cpad)
WINDOWS = ((MB + 2, Y_PAD), (MB // 2 + 2, C_PAD))
PRED_PADS = ((Y_PAD, C_PAD), (WIDE_YPAD, WIDE_CPAD))
# K4's per-MB field types: ints as int32, flags as bytes (the first type
# of each is what another type is converted to)
_INT = (I32,)
_FLAG = (torch.bool, torch.uint8)


def _slot_index(slot, device):
    return torch.as_tensor(slot, dtype=I32, device=device).reshape(1)


def _check_ring(t, name, shape):
    """A ring stack as the kernels read it: addressed in 32 bits within a
    plane, rows of 4-sample words read as aligned 8-byte loads (K4)."""
    _build.check(t, name, torch.int16, shape)
    if shape[-2] * shape[-1] >= 2 ** 31:
        raise ValueError(f"{name}: planes of 2^31 samples or more")
    if t.data_ptr() % 8:
        raise ValueError(f"{name}: expected an 8-byte aligned tensor")


def _check_halo(halo, name):
    """A ring halo the kernels take: a non-negative multiple of 8, so
    that the chroma rows (W/2 + halo samples) stay whole 4-sample words
    that start 8-byte aligned (K4's row loads)."""
    if halo < 0 or halo % 8:
        raise ValueError(f"{name}: the ring halo must be a non-negative "
                         f"multiple of 8, got {halo}")


def _ring_core(ring_y, halo):
    """The core (H, W) of a luma ring stack (RING, H, W + 2 halo)."""
    return ring_y.shape[1], ring_y.shape[2] - 2 * halo


def _field(t, name, n, kinds):
    """A per-MB field as the kernel takes it: as it comes when its type is
    one of `kinds`, else converted to the first."""
    if t.dtype not in kinds or not t.is_contiguous():
        t = t.to(kinds[0]).contiguous()
    _build.check(t, name, t.dtype, (n,))
    return t


# ----------------------------------------------------------------- K3

def gather_windows_plain(planes, slot, mx, my, block, pad, halo=0):
    plane = planes.index_select(0, _slot_index(slot, planes.device))[0]
    wins = extract.mb_windows(plane.to(I32), block - 2, pad, prepad_x=halo)
    return extract.extract_blocks(wins, mx + pad - 1, my + pad - 1, block)


def gather_windows(planes, slot, mx, my, block, pad):
    """(N, block, block) int32 per-MB windows at offset (mx - 1, my - 1)
    from ring slot `slot` (an int32 scalar tensor). planes: (RING, H, W)
    int16; block = mb_size + 2; pad = the prediction window pad. The
    kernel is built for the luma and chroma geometries, WINDOWS."""
    if planes.device.type == "cpu":
        return gather_windows_plain(planes, slot, mx, my, block, pad)
    if (block, pad) not in WINDOWS:
        raise ValueError(f"gather_windows: (block, pad) must be one of "
                         f"{WINDOWS}, got {(block, pad)}")
    ring, h, w = planes.shape
    mb = block - 2
    if h % mb or w % mb:
        raise ValueError("gather_windows: plane dims must be multiples of "
                         "the block size")
    n = (h // mb) * (w // mb)
    dev = planes.device
    slot_t = _slot_index(slot, dev)
    _check_ring(planes, "planes", (ring, h, w))
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


def gather_windows_yuv_plain(ring, slot, mx, my, halo=0):
    (yb, yp), (cb, cp) = WINDOWS
    return (gather_windows_plain(ring[0], slot, mx, my, yb, yp, halo),
            gather_windows_plain(ring[1], slot, mx >> 1, my >> 1, cb, cp,
                                 halo // 2),
            gather_windows_plain(ring[2], slot, mx >> 1, my >> 1, cb, cp,
                                 halo // 2))


def gather_windows_yuv(ring, slot, mx, my, halo=0):
    """The sub-pel windows of one reference in all three planes, one
    launch: gather_windows over ring_y at 18/17 and over ring_u, ring_v
    at 10/9 with offsets (mx >> 1, my >> 1). ring: (ring_y, ring_u,
    ring_v) int16 stacks with a ring halo of `halo` luma columns;
    returns ((N, 18, 18), (N, 10, 10), (N, 10, 10)) int32 windows of the
    core, views of one buffer."""
    if ring[0].device.type == "cpu":
        return gather_windows_yuv_plain(ring, slot, mx, my, halo)
    _check_halo(halo, "gather_windows_yuv")
    h, w = _ring_core(ring[0], halo)
    if h % MB or w % MB:
        raise ValueError("gather_windows_yuv: plane dims must be multiples "
                         "of 16")
    n = (h // MB) * (w // MB)
    dev = ring[0].device
    slot_t = _slot_index(slot, dev)
    _check_ring(ring[0], "ring_y", (RING, h, w + 2 * halo))
    _check_ring(ring[1], "ring_u", (RING, h // 2, w // 2 + halo))
    _check_ring(ring[2], "ring_v", (RING, h // 2, w // 2 + halo))
    _build.check(slot_t, "slot", I32, (1,))
    _build.check(mx, "mx", I32, (n,))
    _build.check(my, "my", I32, (n,))
    (yb, _), (cb, _) = WINDOWS
    buf = torch.empty(n * (yb * yb + 2 * cb * cb), dtype=I32, device=dev)
    wy, wu, wv = buf.split([n * yb * yb, n * cb * cb, n * cb * cb])
    fn = _build.kernel_fn("cairo_gather_windows_yuv", "ppppppiiipppp")
    _build.launch(fn, dev, *(r.data_ptr() for r in ring), slot_t.data_ptr(),
                  mx.data_ptr(), my.data_ptr(), h, w, halo, wy.data_ptr(),
                  wu.data_ptr(), wv.data_ptr())
    LAUNCHES["gather_windows"] += 1
    if halo:
        HALO_LAUNCHES["gather_windows"] += 1
    return (wy.view(n, yb, yb), wu.view(n, cb, cb), wv.view(n, cb, cb))


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
                      sp_amount, sp_index, zero, ypad=Y_PAD, cpad=C_PAD,
                      halo=0):
    height, width = _ring_core(ring_y, halo)
    slot = slot.to(I32)

    def pick(stack, block, pad, prepad):
        sel = None
        for s in range(RING):
            win = extract.mb_windows(stack[s].to(I32), block, pad, prepad)
            m = (slot == s)[:, None, None]
            sel = torch.where(m, win, 0 if sel is None else sel)
        return sel

    wins = (pick(ring_y, MB, ypad, halo), pick(ring_u, MB // 2, cpad,
                                               halo // 2),
            pick(ring_v, MB // 2, cpad, halo // 2))
    pred = pred_block_from_windows(wins, mx.to(I32), my.to(I32), sp_pred,
                                   sp_amount, sp_index, ypad, cpad)
    zm = zero.bool()[:, None, None]
    py, pu, pv = (torch.where(zm, 0, p) for p in pred)
    return (ops.blocks_to_plane(py, height, width),
            ops.blocks_to_plane(pu, height // 2, width // 2),
            ops.blocks_to_plane(pv, height // 2, width // 2))


def pred_planes(ring_y, ring_u, ring_v, slot, mx, my, sp_pred, sp_amount,
                sp_index, zero, ypad=Y_PAD, cpad=C_PAD, halo=0):
    """Prediction planes (pred_y, pred_u, pred_v), int32, of the ring's
    core shapes. ring_*: (RING, H, W + 2 halo) and (RING, H/2, W/2 +
    halo) int16; slot/mx/my/sp_index: (N,) int;
    sp_pred/sp_amount/zero: (N,) bool or uint8. The kernel takes int32
    ints and bool or uint8 flags as they come and converts other types
    first. The motion reach clamps to the window pads: ypad/cpad, the
    fast-mode Y_PAD/C_PAD (17/9) by default; the conformance encoder
    passes WIDE_YPAD/WIDE_CPAD (33/17), PRED_PADS."""
    if ring_y.device.type == "cpu":
        return pred_planes_plain(ring_y, ring_u, ring_v, slot, mx, my,
                                 sp_pred, sp_amount, sp_index, zero, ypad,
                                 cpad, halo)
    _check_halo(halo, "pred_planes")
    h, w = _ring_core(ring_y, halo)
    if h % MB or w % MB:
        raise ValueError("pred_planes: plane dims must be multiples of 16")
    if (ypad, cpad) not in PRED_PADS:
        raise ValueError(f"pred_planes: (ypad, cpad) must be one of "
                         f"{PRED_PADS}, got {(ypad, cpad)}")
    dev = ring_y.device
    n = (h // MB) * (w // MB)
    _check_ring(ring_y, "ring_y", (RING, h, w + 2 * halo))
    _check_ring(ring_u, "ring_u", (RING, h // 2, w // 2 + halo))
    _check_ring(ring_v, "ring_v", (RING, h // 2, w // 2 + halo))
    per_mb = [_field(t, name, n, kinds) for t, name, kinds in (
        (slot, "slot", _INT), (mx, "mx", _INT), (my, "my", _INT),
        (sp_pred, "sp_pred", _FLAG), (sp_amount, "sp_amount", _FLAG),
        (sp_index, "sp_index", _INT), (zero, "zero", _FLAG))]
    cs = h * w // 4
    buf = torch.empty(h * w + 2 * cs, dtype=I32, device=dev)
    out_y, out_u, out_v = buf.split([h * w, cs, cs])
    fn = _build.kernel_fn("cairo_pred_planes", "ppppppppppiiiiipppp")
    _build.launch(fn, dev, ring_y.data_ptr(), ring_u.data_ptr(),
                  ring_v.data_ptr(), *(t.data_ptr() for t in per_mb),
                  h, w, halo, ypad, cpad, out_y.data_ptr(), out_u.data_ptr(),
                  out_v.data_ptr())
    name = "pred_planes" if (ypad, cpad) == (Y_PAD, C_PAD) \
        else "pred_planes_wide"
    LAUNCHES[name] += 1
    if halo:
        HALO_LAUNCHES[name] += 1
    return (out_y.view(h, w), out_u.view(h // 2, w // 2),
            out_v.view(h // 2, w // 2))
