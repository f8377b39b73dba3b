"""Fast-mode motion search kernels K1 and K2 (counterpart of
cairo_tpu/tpu/pallas_motion.py) and K9, with their plain PyTorch
versions.

Dispatch, one rule per wrapper: a CPU tensor takes the plain version; a
CUDA tensor launches the kernel of csrc/motion.cu (K1, K2) or
csrc/subpel.cu (K9) or raises. Each launch adds one to LAUNCHES[name].

  * chroma_max_maps (K1) replaces pallas_motion.chroma_max_maps
    (pallas_motion.py:314); plain version translated from
    motion._chroma_max_maps (motion.py:237).
  * dense_select (K2) replaces pallas_motion.dense_select
    (pallas_motion.py:212); plain version translated from
    motion._dense_select (motion.py:269).
  * subpel_scan (K9) replaces no Pallas kernel: it is the sub-pel
    refinement of the fast search, the lax.scan of sp_body over the 8
    neighbour directions (motion.py:476-521) that XLA fuses into a few
    kernels on the TPU; its plain version is that scan as torch ops.
    The sub-pel fold rules (SP_DIRS, accept_subpel, fold_subpel) live
    here too, since motion.inter_search_exact and cuda_wave's plain K6
    fold their sub-pel candidates the same way.

The port's chroma-map layout is (hb, wb, 17*17), offset index
(cdy+8)*17 + (cdx+8): only K2 reads it. A reference carries a margin of
its own, `margin` columns each side ((H, W + 2 margin), 0 for a
single-card ring plane, a tile's halo for a tiled one): source column x
reads reference column x + margin, and reads beyond the reference are
zero. The plain versions cut or zero-pad that margin to the search reach,
as motion.inter_search's hmargin does (motion.py:415-421); K1 and K2 read
the wide plane in place, which gives the same values because the reach
(8 chroma, 16 luma columns) stays inside a margin at least that wide.

Every launch with a margin also adds one to HALO_LAUNCHES[name], so a
run can show that the tiled path reached the kernels.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import tables
from ..blocktypes import COPY_BIT, INTRA_BIT, MOTION_BIT, sp_dir_to_index
from . import _build, ops

MB = tables.MACROBLOCK_SIZE
R = tables.MOTION_SEARCH_RADIUS     # 16
SPAN = 2 * R + 1                    # 33
NOFF = SPAN * SPAN                  # 1089
CENTER = R * SPAN + R
CR = R // 2                         # 8
CSPAN = 2 * CR + 1                  # 17
CNOFF = CSPAN * CSPAN               # 289
SAD_THRESHOLD = tables.MOTION_SAD_THRESHOLD
I32 = torch.int32
INT32_MAX = 0x7FFFFFFF
_NONE = torch.iinfo(torch.int64).max

LAUNCHES = {"chroma_max_maps": 0, "dense_select": 0, "subpel_scan": 0}
HALO_LAUNCHES = {"chroma_max_maps": 0, "dense_select": 0}


def _shifted(slab, n, width):
    """(n, H, width) stack of slab[:, d:d+width] for d in range(n)."""
    return torch.stack([slab[:, d:d + width] for d in range(n)])


def hmargin(plane, margin, reach):
    """(H, W + 2 margin) -> (H, W + 2 reach): the plane's own margin cut
    or zero-padded to `reach` columns each side (motion.py:415-421)."""
    if margin >= reach:
        return plane[:, margin - reach:plane.shape[1] - (margin - reach)]
    return F.pad(plane, (reach - margin, reach - margin))


def _check_margin(ref, name, dtype, h, w, margin):
    """A reference as K1 and K2 take it: (h, w + 2 margin), the margin a
    multiple of 8, so that a 16-byte staged chunk starts at a multiple of
    8 reference columns and lies wholly inside or outside the plane."""
    if margin < 0 or margin % 8:
        raise ValueError(f"{name}: the reference margin must be a "
                         f"non-negative multiple of 8, got {margin}")
    _build.check(ref, name, dtype, (h, w + 2 * margin))


# ----------------------------------------------------------------- K1

def chroma_max_maps_plain(src_u, src_v, ref_u, ref_v, margin=0):
    h, w = src_u.shape
    hb, wb = h // 8, w // 8
    pu, pv = (F.pad(hmargin(r.to(torch.int16).to(I32), margin, CR),
                    (0, 0, CR, CR)) for r in (ref_u, ref_v))
    su, sv = src_u.to(I32), src_v.to(I32)
    rows = []
    for dy in range(CSPAN):
        du = (su - _shifted(pu[dy:dy + h], CSPAN, w)).abs()
        dv = (sv - _shifted(pv[dy:dy + h], CSPAN, w)).abs()
        d = torch.maximum(du, dv).reshape(CSPAN, hb, 8, wb, 8)
        rows.append(d.amax(dim=(2, 4)))
    maps = torch.stack(rows)                       # (cdy, cdx, hb, wb)
    return maps.permute(2, 3, 0, 1).reshape(hb, wb, CNOFF).contiguous()


def chroma_max_maps(src_u, src_v, ref_u, ref_v, margin=0):
    """(hb, wb, 289) int32 chroma abs-max maps over offsets [-8, 8]^2.
    src_*: (H, W) int32 chroma planes with values in int16 range (source
    planes are 0..255; the kernel's float arithmetic is exact there);
    ref_*: (H, W + 2 margin) int16, source column x at x + margin."""
    if src_u.device.type == "cpu":
        return chroma_max_maps_plain(src_u, src_v, ref_u, ref_v, margin)
    h, w = src_u.shape
    if h % 8 or w % 8:
        raise ValueError("chroma_max_maps: plane dims must be multiples of 8")
    for t, name in ((src_u, "src_u"), (src_v, "src_v")):
        _build.check(t, name, I32, (h, w))
    for t, name in ((ref_u, "ref_u"), (ref_v, "ref_v")):
        _check_margin(t, name, torch.int16, h, w, margin)
    out = torch.empty((h // 8, w // 8, CNOFF), dtype=I32,
                      device=src_u.device)
    fn = _build.kernel_fn("cairo_chroma_max_maps", "ppppiiipp")
    _build.launch(fn, src_u.device, src_u.data_ptr(), src_v.data_ptr(),
                  ref_u.data_ptr(), ref_v.data_ptr(), h, w, margin,
                  out.data_ptr())
    LAUNCHES["chroma_max_maps"] += 1
    if margin:
        HALO_LAUNCHES["chroma_max_maps"] += 1
    return out


# ----------------------------------------------------------------- K2

def dense_select_plain(src_y, ref_y, cmax, x0, width, height, mad_thr,
                       margin=0):
    h, w = src_y.shape
    hb, wb = h // MB, w // MB
    dev = src_y.device
    padded = F.pad(hmargin(ref_y.to(torch.int16).to(I32), margin, R),
                   (0, 0, R, R))
    src = src_y.to(I32)
    thr = torch.as_tensor(mad_thr, dtype=I32, device=dev)
    px = torch.arange(wb, device=dev) * MB
    py = torch.arange(hb, device=dev) * MB
    offs = torch.arange(SPAN, device=dev)
    ox = offs - R
    cm = cmax.reshape(hb, wb, CSPAN, CSPAN)
    best_p = torch.full((hb, wb), _NONE, dtype=torch.int64, device=dev)
    best_c = best_p.clone()
    sads, mads = [], []
    # x validity per (dx, mb col) and y validity per mb row
    gx = x0 + px[None, :] + ox[:, None]
    x_ok = ((gx >= 0) & (gx <= width - MB))[:, None, :]
    for dy in range(SPAN):
        oy = dy - R
        d = (src - _shifted(padded[dy:dy + h], SPAN, w)).abs() \
            .reshape(SPAN, hb, MB, wb, MB)
        sad = d.sum(dim=(2, 4), dtype=I32)
        cm_row = cm[:, :, (oy >> 1) + CR, (ox >> 1) + CR].permute(2, 0, 1)
        mad = torch.maximum(d.amax(dim=(2, 4)), cm_row)
        gy = py + oy
        valid = x_ok & ((gy >= 0) & (gy <= height - MB))[None, :, None]
        tail = ((ox * ox + oy * oy) << 11 | (dy * SPAN + offs)) \
            .to(torch.int64)[:, None, None]
        kp = torch.where(valid, sad.to(torch.int64) << 21 | tail, _NONE)
        kc = torch.where(valid & (mad < thr), mad.to(torch.int64) << 21 | tail,
                         _NONE)
        best_p = torch.minimum(best_p, kp.amin(0))
        best_c = torch.minimum(best_c, kc.amin(0))
        sads.append(sad)
        mads.append(mad)
    sad_all = torch.cat(sads).reshape(NOFF, -1)
    mad_all = torch.cat(mads).reshape(NOFF, -1)
    best_p, best_c = best_p.reshape(-1), best_c.reshape(-1)

    def pick(key):
        has = key != _NONE
        off = torch.where(has, key & 2047, 0)
        sel = off[None, :]
        return (has, (off % SPAN - R).to(I32), (off // SPAN - R).to(I32),
                sad_all.gather(0, sel)[0], mad_all.gather(0, sel)[0])

    p_has, p_ox, p_oy, p_sad, p_mad = pick(best_p)
    p_sad = torch.where(p_has, p_sad, INT32_MAX)
    p_mad = torch.where(p_has, p_mad, INT32_MAX)
    c_has, c_ox, c_oy, c_sad, c_mad = pick(best_c)
    co_sad, co_mad = sad_all[CENTER], mad_all[CENTER]
    frozen = co_mad < thr
    use_copy = c_has & ~frozen
    mx = torch.where(frozen, 0, torch.where(use_copy, c_ox, p_ox))
    my = torch.where(frozen, 0, torch.where(use_copy, c_oy, p_oy))
    sad = torch.where(frozen, co_sad, torch.where(use_copy, c_sad, p_sad))
    mad = torch.where(frozen, co_mad, torch.where(use_copy, c_mad, p_mad))
    return mx, my, sad, mad, frozen


def dense_select(src_y, ref_y, cmax, x0, width, height, mad_thr,
                 margin=0):
    """Per-MB (mx, my, sad, mad, frozen) under the fast-mode policy.
    src_y: (H, W) int32 with values in int16 range (source planes are
    0..255; the kernel's float arithmetic is exact there); ref_y:
    (H, W + 2 margin) int16, source column x at x + margin; cmax from
    chroma_max_maps; x0: the tile's pixel origin; width/height: the frame
    the candidates must stay in; mad_thr: int32 scalar tensor."""
    if src_y.device.type == "cpu":
        return dense_select_plain(src_y, ref_y, cmax, x0, width, height,
                                  mad_thr, margin)
    h, w = src_y.shape
    if h % MB or w % MB:
        raise ValueError("dense_select: plane dims must be multiples of 16")
    hb, wb = h // MB, w // MB
    dev = src_y.device
    thr = torch.as_tensor(mad_thr, dtype=I32, device=dev).reshape(1)
    _build.check(src_y, "src_y", I32, (h, w))
    _check_margin(ref_y, "ref_y", torch.int16, h, w, margin)
    _build.check(cmax, "cmax", I32, (hb, wb, CNOFF))
    _build.check(thr, "mad_thr", I32, (1,))
    n = hb * wb
    mx, my, sad, mad = torch.empty((4, n), dtype=I32, device=dev).unbind(0)
    frozen = torch.empty(n, dtype=torch.bool, device=dev)
    fn = _build.kernel_fn("cairo_dense_select", "ppppiiiiiipppppp")
    _build.launch(fn, dev, src_y.data_ptr(), ref_y.data_ptr(),
                  cmax.data_ptr(), thr.data_ptr(), h, w, margin, int(x0),
                  int(width), int(height), mx.data_ptr(),
                  my.data_ptr(), sad.data_ptr(), mad.data_ptr(),
                  frozen.data_ptr())
    LAUNCHES["dense_select"] += 1
    if margin:
        HALO_LAUNCHES["dense_select"] += 1
    return mx, my, sad, mad, frozen


# ----------------------------------------------------------------- K9

# (di, dj, sp index) in the reference's evaluation order
SP_DIRS = [(di, dj, sp_dir_to_index(di, dj))
           for dj in (-1, 0, 1) for di in (-1, 0, 1) if (di, dj) != (0, 0)]


def block_sad(src_y, cand_y):
    return (src_y - cand_y).abs().sum(dim=(1, 2), dtype=I32)


def block_mad(src, cand):
    m = [(s - c).abs().amax(dim=(1, 2)) for s, c in zip(src, cand)]
    return torch.maximum(m[0], torch.maximum(m[1], m[2])).to(I32)


def accept_subpel(c_sad, c_mad, sad, mad, mad_thr):
    """Sub-pel acceptance (motion.cpp:277-352): in the copy branch a
    strictly lower MAD; otherwise a strictly lower SAD under the
    threshold, or a MAD below mad_thr."""
    return torch.where(mad < mad_thr, c_mad < mad,
                       ((c_sad < sad) & (c_sad < SAD_THRESHOLD))
                       | (c_mad < mad_thr))


def fold_subpel(sad, mad, cands, mad_thr):
    """Folds the sub-pel candidates in the reference's order (SP_DIRS,
    half before quarter). cands yields (ok, amount, sp_index, c_sad,
    c_mad) per candidate. Returns (sad, mad, sp_pred, sp_amount,
    sp_index)."""
    sp_pred = torch.zeros(sad.shape, dtype=torch.bool, device=sad.device)
    sp_amount = torch.zeros_like(sp_pred)
    sp_index = torch.zeros(sad.shape, dtype=I32, device=sad.device)
    for ok, amount, idx, c_sad, c_mad in cands:
        acc = ok & accept_subpel(c_sad, c_mad, sad, mad, mad_thr)
        sp_pred = sp_pred | acc
        sp_amount = torch.where(acc, amount, sp_amount)
        sp_index = torch.where(acc, idx, sp_index)
        sad = torch.where(acc, c_sad, sad)
        mad = torch.where(acc, c_mad, mad)
    return sad, mad, sp_pred, sp_amount, sp_index


def _chroma_slice(win, cdx, cdy):
    """(N, 10, 10) windows -> (N, 8, 8) at per-MB shifts cdx/cdy in -1..1."""
    rows = [win[:, i:i + 8, :] for i in range(3)]
    r = torch.where((cdy == -1)[:, None, None], rows[0],
                    torch.where((cdy == 0)[:, None, None], rows[1], rows[2]))
    cols = [r[:, :, i:i + 8] for i in range(3)]
    return torch.where((cdx == -1)[:, None, None], cols[0],
                       torch.where((cdx == 0)[:, None, None], cols[1],
                                   cols[2]))


def _src_blocks(src_planes, px, py):
    """Per-MB source blocks (Y (N,16,16), U, V (N,8,8)) of the planes at
    (px, py) (px/2, py/2 in chroma)."""
    out = []
    for plane, size, x, y in ((src_planes[0], MB, px, py),
                              (src_planes[1], MB // 2, px >> 1, py >> 1),
                              (src_planes[2], MB // 2, px >> 1, py >> 1)):
        r = torch.arange(size, device=px.device)
        out.append(plane[(y.long()[:, None] + r)[:, :, None],
                         (x.long()[:, None] + r)[:, None, :]])
    return tuple(out)


def subpel_scan_plain(wins, src_planes, mx, my, best_sad, best_mad, frozen,
                      px, py, x0, width, height, mad_thr):
    ywin, uwin, vwin = wins
    src = _src_blocks(src_planes, px, py)
    best_y = ywin[:, 1:17, 1:17]
    best_u = uwin[:, 1:9, 1:9]
    best_v = vwin[:, 1:9, 1:9]

    def cands():
        for di, dj, idx in SP_DIRS:
            tmx, tmy = mx + di, my + dj
            valid_sp = ((x0 + px + tmx >= 0) & (x0 + px + tmx <= width - MB)
                        & (py + tmy >= 0) & (py + tmy <= height - MB)
                        & ~frozen)
            test_y = ywin[:, 1 + dj:1 + dj + MB, 1 + di:1 + di + MB]
            # the chroma neighbour's shift depends on the parity of mx/my
            cdx = ((mx + di) >> 1) - (mx >> 1)
            cdy = ((my + dj) >> 1) - (my >> 1)
            test_u = _chroma_slice(uwin, cdx, cdy)
            test_v = _chroma_slice(vwin, cdx, cdy)
            for amount, lerp in ((False, ops.lerp_half),
                                 (True, ops.lerp_quarter)):
                cy_ = lerp(best_y, test_y)
                yield (valid_sp, amount, idx, block_sad(src[0], cy_),
                       block_mad(src, (cy_, lerp(best_u, test_u),
                                       lerp(best_v, test_v))))

    sad, mad, sp_pred, sp_amount, sp_index = fold_subpel(
        best_sad, best_mad, cands(), mad_thr)
    return dict(sad=sad, mad=mad,
                is_motion=(mx != 0) | (my != 0) | sp_pred,
                is_copy=mad < mad_thr, sp_pred=sp_pred,
                sp_amount=sp_amount, sp_index=sp_index)


def subpel_scan(wins, src_planes, mx, my, best_sad, best_mad, frozen, px,
                py, x0, width, height, mad_thr):
    """The fast search's sub-pel refinement of every MB against one
    reference (motion.py:466-527): the 8 directions of SP_DIRS, each a
    half- then a quarter-pel blend of the full-pel best block with its
    neighbour, folded in that order from K2's best. Returns the dict
    sad, mad (int32), is_motion, is_copy, sp_pred, sp_amount (bool),
    sp_index (int32).

    wins: K3's (ywin (N,18,18), uwin, vwin (N,10,10)) int32 windows
    around the full-pel best, values in int16 range (the ring is int16);
    src_planes: (y (H,W), u, v (H/2,W/2)) int32 planes, values in int16
    range, read at each MB's (px, py); mx, my, best_sad, best_mad (int32)
    and frozen (bool) from K2; px, py: (N,) int32 MB positions within the
    planes (the MB grid, raster order); x0, width, height: the tile's
    origin and the frame the candidates must stay in; mad_thr: int32
    scalar tensor, read on the device. On the card: K9 with one
    reference and the merge off."""
    if mx.device.type == "cpu":
        return subpel_scan_plain(wins, src_planes, mx, my, best_sad,
                                 best_mad, frozen, px, py, x0, width, height,
                                 mad_thr)
    n, dev, thr = _check_subpel(src_planes, px, py, mad_thr)
    _check_reference((wins, mx, my, best_sad, best_mad, frozen), n, "",
                     dev.index)
    sad, mad, sp_index = torch.empty((3, n), dtype=I32, device=dev).unbind(0)
    flags = torch.empty((4, n), dtype=torch.bool, device=dev)
    sp_pred, sp_amount, is_motion, is_copy = flags.unbind(0)
    _launch_subpel([(wins, mx, my, best_sad, best_mad, frozen)], False,
                   src_planes, px, py, thr, x0, width, height,
                   (sad, mad, sp_index, sp_pred, sp_amount, is_motion,
                    is_copy) + (None,) * 5)
    return dict(sad=sad, mad=mad, is_motion=is_motion, is_copy=is_copy,
                sp_pred=sp_pred, sp_amount=sp_amount, sp_index=sp_index)


# the fields of subpel_classify's best, in the order of the dict
# tpu/engine.py _classify_inter returns
CLASSIFY_FIELDS = ("sad", "is_copy", "is_motion", "is_intra", "target",
                   "motion_x", "motion_y", "sp_pred", "sp_amount",
                   "sp_index")


def subpel_classify_plain(refs, src_planes, px, py, x0, width, height,
                          mad_thr):
    """subpel_scan per reference, then the merge (encode.cpp:17-67;
    tpu/engine.py:107-157) in torch."""
    n, dev = px.shape[0], px.device
    zi = torch.zeros(n, dtype=I32, device=dev)
    zb = torch.zeros(n, dtype=torch.bool, device=dev)
    best = dict(sad=_src_blocks(src_planes, px, py)[0].abs().sum(
                    dim=(1, 2), dtype=I32),
                is_copy=zb, is_motion=zb,
                is_intra=torch.ones(n, dtype=torch.bool, device=dev),
                target=zi, motion_x=zi, motion_y=zi, sp_pred=zb,
                sp_amount=zb, sp_index=zi)
    # on CPU tensors through subpel_scan, whose CPU path is this same plain
    # scan, so that a count of its calls shows one scan per reference
    scan = subpel_scan if px.device.type == "cpu" else subpel_scan_plain
    for offset, (wins, mx, my, sad, mad, frozen) in enumerate(refs, 1):
        cand = scan(wins, src_planes, mx, my, sad, mad, frozen, px, py, x0,
                    width, height, mad_thr)
        cand.update(motion_x=mx, motion_y=my)
        take = torch.where(cand["is_copy"] != best["is_copy"],
                           cand["is_copy"], cand["sad"] < best["sad"])
        for k in ("sad", "is_copy", "is_motion", "motion_x", "motion_y",
                  "sp_pred", "sp_amount", "sp_index"):
            best[k] = torch.where(take, cand[k], best[k])
        best["is_intra"] = best["is_intra"] & ~take
        best["target"] = torch.where(take, offset, best["target"])
    best["block_type"] = (best["is_intra"].to(I32) * INTRA_BIT
                          | best["is_motion"].to(I32) * MOTION_BIT
                          | best["is_copy"].to(I32) * COPY_BIT
                          ).to(torch.uint8)
    return best


def subpel_classify(refs, src_planes, px, py, x0, width, height, mad_thr):
    """The fast classification of every MB (encode.cpp:17-67, fast mode;
    tpu/engine.py _classify_inter): the sub-pel scan of each reference
    (subpel_scan), in offset order, merged into a best that starts as
    intra with SAD sum |src_y| over the MB: a reference takes it where
    its copy status differs and it is a copy, or where the status is
    equal and its SAD is strictly lower. Returns the dict of
    CLASSIFY_FIELDS (sad, target, motion_x, motion_y, sp_index int32; the
    flags bool; target the offset 1..R, 0 where intra) and block_type
    (uint8: INTRA_BIT, MOTION_BIT, COPY_BIT).

    refs: for offsets 1..R (R <= 3; none leaves every MB intra), (wins,
    mx, my, best_sad, best_mad, frozen) as subpel_scan takes them; the
    other arguments as there. On the card: one K9 launch for every
    reference, merge and all."""
    if px.device.type == "cpu":
        return subpel_classify_plain(refs, src_planes, px, py, x0, width,
                                     height, mad_thr)
    if len(refs) > MAX_REFS:
        raise ValueError(f"subpel_classify: at most {MAX_REFS} references, "
                         f"got {len(refs)}")
    n, dev, thr = _check_subpel(src_planes, px, py, mad_thr)
    for i, ref in enumerate(refs):
        _check_reference(ref, n, f"refs[{i}].", dev.index)
    buf = torch.empty(26 * n, dtype=torch.uint8, device=dev)
    ints, flags, block_type = buf.split([20 * n, 5 * n, n])
    sad, target, motion_x, motion_y, sp_index = ints.view(I32).view(5, n) \
        .unbind(0)
    is_copy, is_motion, is_intra, sp_pred, sp_amount = \
        flags.view(torch.bool).view(5, n).unbind(0)
    _launch_subpel(refs, True, src_planes, px, py, thr, x0, width, height,
                   (sad, None, sp_index, sp_pred, sp_amount, is_motion,
                    is_copy, is_intra, target, motion_x, motion_y,
                    block_type))
    return dict(sad=sad, is_copy=is_copy, is_motion=is_motion,
                is_intra=is_intra, target=target, motion_x=motion_x,
                motion_y=motion_y, sp_pred=sp_pred, sp_amount=sp_amount,
                sp_index=sp_index, block_type=block_type)


MAX_REFS = 3    # csrc/subpel.cu MAX_REFS: the ring's references
SUBPEL_SIGNATURE = "piipppppp" + "i" * 8 + "pp"
_WIN = ((MB + 2, MB + 2), (MB // 2 + 2, MB // 2 + 2),
        (MB // 2 + 2, MB // 2 + 2))


def _check_subpel(src_planes, px, py, mad_thr):
    """Checks K9's per-frame arguments; returns (n, device, mad_thr as a
    (1,) device tensor)."""
    h, w = src_planes[0].shape
    if h % MB or w % MB:
        raise ValueError("subpel_scan: plane dims must be multiples of 16")
    n = (h // MB) * (w // MB)
    dev = px.device
    thr = torch.as_tensor(mad_thr, dtype=I32, device=dev).reshape(1)
    _build.check_many([(src_planes[0], "src_y", (I32,), (h, w)),
                       (src_planes[1], "src_u", (I32,), (h // 2, w // 2)),
                       (src_planes[2], "src_v", (I32,), (h // 2, w // 2)),
                       (px, "px", (I32,), (n,)), (py, "py", (I32,), (n,)),
                       (thr, "mad_thr", (I32,), (1,))], dev.index)
    return n, dev, thr


def _check_reference(ref, n, prefix, index):
    """Checks one reference's (wins, mx, my, best_sad, best_mad, frozen)."""
    wins, mx, my, sad, mad, frozen = ref
    _build.check_many(
        [(t, prefix + name, (I32,), (n, *shape))
         for t, name, shape in zip(wins, ("ywin", "uwin", "vwin"), _WIN)]
        + [(t, prefix + name, (I32,), (n,))
           for t, name in ((mx, "mx"), (my, "my"), (sad, "best_sad"),
                           (mad, "best_mad"))]
        + [(frozen, prefix + "frozen", (torch.bool,), (n,))], index)


def _launch_subpel(refs, merge, src_planes, px, py, thr, x0, width, height,
                   outs):
    """One K9 launch over `refs` (checked) into `outs`, the 12 outputs of
    csrc/subpel.cu's Outs (None where not asked)."""
    ptrs = [t.data_ptr() for wins, *rest in refs for t in (*wins, *rest)]
    ptrs += [None] * (8 * MAX_REFS - len(ptrs))
    h, w = src_planes[0].shape
    fn = _build.kernel_fn("cairo_subpel_scan", SUBPEL_SIGNATURE)
    _build.launch(fn, px.device, (ctypes.c_void_p * len(ptrs))(*ptrs),
                  len(refs), int(merge),
                  *(t.data_ptr() for t in (*src_planes, px, py, thr)),
                  (h // MB) * (w // MB), w, int(x0), int(width),
                  int(height), INTRA_BIT, MOTION_BIT, COPY_BIT,
                  (ctypes.c_void_p * 12)(*(None if t is None else
                                           t.data_ptr() for t in outs)))
    LAUNCHES["subpel_scan"] += 1
