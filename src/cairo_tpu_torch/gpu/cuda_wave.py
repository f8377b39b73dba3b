"""Wave-pass kernel K6 (counterpart of cairo_tpu/tpu/pallas_wave.py), with
its plain PyTorch version and the wave helpers that version is built from
(counterparts of cairo_tpu/tpu/wavefront.py:55-370).

Dispatch, one rule: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel of csrc/wave.cu or raises. One call of wave_pass
launches the kernel once (one persistent launch for the whole pass), and
LAUNCHES counts those launches.

  * wave_pass (K6) replaces pallas_wave.wave_pass (pallas_wave.py:1045);
    plain version: the XLA wave body of wavefront.conformance_encode_step
    (wavefront.py:481-611), one wave at a time, with the intra search of
    _intra_search_wave (:242-365).

Both return the same outputs: the reconstruction planes (int32), the
per-MB descriptor rows DESC_FIELDS (int32, q_index and variance as
computed, also for copy blocks) and the quantised coefficient blocks
(int16, also for copy blocks). The caller keeps the previous frame's
values for copy blocks (wavefront.conformance_encode_step).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import tables
from . import _build, cuda_inter, engine, extract, ops
from .cuda_motion import SP_DIRS, fold_subpel
from .motion import INT32_MAX, fold_full, mad_k, merge_descs, sad_k

MB = tables.MACROBLOCK_SIZE
# An MB's causal window: luma x in [px + WIN_X[0], px + WIN_X[1]) and y in
# [py + WIN_Y[0], py + WIN_Y[1]) (chroma halved). Its reach right of the
# MB, two MBs, sets the schedule: the plain version runs waves
# w = bi + SKEW * bj, and the kernel walks rows, waiting before MB (bi, bj)
# until row bj-1 has completed MB min(bi + LEAD, wb-1). The two are one
# order: (bi + LEAD, bj - 1) lies in wave w - 1. The kernel holds the
# same reach in MBs (wave.cu LEFT, RIGHT, UP, DOWN); wave_pass checks it.
WIN_X = (-32, 48)
WIN_Y = (-48, 32)
LEAD = (WIN_X[1] - MB) // MB       # 2
SKEW = LEAD + 1                    # 3
YPAD = 48            # window reach: x in [-32, 48), y in [-48, 16)
CPAD = 24
I32 = torch.int32
DESC_FIELDS = ("is_intra", "is_motion", "is_copy", "target", "motion_x",
               "motion_y", "sp_pred", "sp_amount", "sp_index", "q_index",
               "variance")

# full-pel intra rings: the triangle scan (motion.cpp:381-385), then
# refinement rings around the ring-entry best
INTRA_RINGS = [[(i, j) for j in (-32, -16, 0) for i in (-16, 0, 16)]] + [
    [(i, j) for j in (-s, 0, s) for i in (-s, 0, s)] for s in (8, 4, 2, 1)]

LAUNCHES = {"wave_pass": 0}


def window_reach():
    """The causal window's reach in MBs: (left, right, up, down)."""
    return (-WIN_X[0] // MB, WIN_X[1] // MB - 1, -WIN_Y[0] // MB,
            WIN_Y[1] // MB - 1)


@functools.lru_cache(maxsize=None)
def wave_members(wb: int, hb: int):
    """Per non-empty wave w = bi + 3*bj, in order, the raster MB indices
    of its members in bj order (the rows of wavefront.wave_schedule)."""
    members = [[] for _ in range(wb + SKEW * (hb - 1))]
    for bj in range(hb):
        for bi in range(wb):
            members[bi + SKEW * bj].append(bj * wb + bi)
    return tuple(tuple(m) for m in members if m)


def _wave_windows(pad_y, pad_u, pad_v, px, py):
    """Causal windows around each member (wavefront._wave_windows): Y
    (P, 80, 80) over [py-48, py+32) x [px-32, px+48), chroma halved;
    the pad planes carry a YPAD / CPAD zero margin."""
    dev = pad_y.device
    a80 = torch.arange(80, device=dev)
    a40 = torch.arange(40, device=dev)
    ywin = pad_y[(py[:, None] + a80)[:, :, None],
                 (px[:, None] + 16 + a80)[:, None, :]]
    cy, cx = py >> 1, px >> 1
    rows = (cy[:, None] + a40)[:, :, None]
    cols = (cx[:, None] + 8 + a40)[:, None, :]
    return ywin, pad_u[rows, cols], pad_v[rows, cols]


def _extract_cand_multi(wins, dx, dy):
    """K candidates per member at offsets dx/dy (P, K) from the windows."""
    ywin, uwin, vwin = wins
    return (extract.extract_blocks_multi(ywin, dx + 32, dy + 48, MB),
            extract.extract_blocks_multi(uwin, (dx >> 1) + 16,
                                         (dy >> 1) + 24, MB // 2),
            extract.extract_blocks_multi(vwin, (dx >> 1) + 16,
                                         (dy >> 1) + 24, MB // 2))


def intra_search_wave(wins, srcb, px, py, self_sad, quality, aligned_w,
                      aligned_h):
    """Exact replay of calculate_intra_prediction for one wave's members
    (wavefront._intra_search_wave). Candidate positions of a ring depend
    only on the ring-entry best, so a ring's 9 candidates are extracted
    together; the order-dependent acceptance folds over them one by one.
    Returns (descriptor dict, prediction blocks)."""
    dev = px.device
    mad_thr = (quality >> 2) + 1

    def causal_ok(dx, dy):
        cx, cy = px[:, None] + dx, py[:, None] + dy
        causal = (cy <= py[:, None] - MB) | (cx <= px[:, None] - MB)
        return causal & (cx >= 0) & (cx <= aligned_w - MB) & (cy >= 0) & \
            (cy <= aligned_h - MB)

    zero = torch.zeros_like(px)
    # best position, then sad, mad, ssd: one stacked state
    state = torch.stack([zero, zero, self_sad,
                         torch.full_like(zero, INT32_MAX),
                         torch.full_like(zero, INT32_MAX)])
    for ring in INTRA_RINGS:
        offs = torch.tensor(ring, dtype=I32, device=dev)
        dx = state[0][:, None] + offs[:, 0]   # frozen ring base (P, 9)
        dy = state[1][:, None] + offs[:, 1]
        ok = causal_ok(dx, dy)
        cand = _extract_cand_multi(wins, dx, dy)
        vals = torch.stack([dx, dy, sad_k(srcb[0], cand[0]),
                            mad_k(srcb, cand), dx * dx + dy * dy])
        state = fold_full(state, vals, ok, mad_thr)
    bx, by = state[0], state[1]
    best = tuple(b[:, 0] for b in
                 _extract_cand_multi(wins, bx[:, None], by[:, None]))

    # sub-pel: the 8 neighbours at once; the acceptance folds in the
    # reference's order (per direction: half, then quarter)
    dirs = torch.tensor([(di, dj) for di, dj, _ in SP_DIRS], dtype=I32,
                        device=dev)
    tx = bx[:, None] + dirs[:, 0]
    ty = by[:, None] + dirs[:, 1]
    ok8 = causal_ok(tx, ty)
    tests = _extract_cand_multi(wins, tx, ty)
    halves = tuple(ops.lerp_half(b[:, None], t) for b, t in zip(best, tests))
    quarters = tuple(ops.lerp_quarter(b[:, None], t)
                     for b, t in zip(best, tests))
    h_sad, h_mad = sad_k(srcb[0], halves[0]), mad_k(srcb, halves)
    q_sad, q_mad = sad_k(srcb[0], quarters[0]), mad_k(srcb, quarters)
    cands = ((ok8[:, d], amount, idx, c_sad[:, d], c_mad[:, d])
             for d, (_, _, idx) in enumerate(SP_DIRS)
             for amount, c_sad, c_mad in ((False, h_sad, h_mad),
                                          (True, q_sad, q_mad)))
    sad, mad, sp_en, sp_am, sp_ix = fold_subpel(state[2], state[3], cands,
                                                mad_thr)

    desc = dict(sad=sad, is_copy=mad < mad_thr,
                is_motion=(bx != 0) | (by != 0) | sp_en,
                is_intra=torch.ones_like(sp_en), target=zero, motion_x=bx,
                motion_y=by, sp_pred=sp_en, sp_amount=sp_am, sp_index=sp_ix)
    # the chosen sub-pel blend (sp_index is the direction's slot d)
    pick = sp_ix.long()[:, None, None, None]
    pred = tuple(
        torch.where(sp_en[:, None, None],
                    torch.where(sp_am[:, None, None],
                                torch.take_along_dim(q, pick, 1)[:, 0],
                                torch.take_along_dim(h, pick, 1)[:, 0]), b)
        for b, h, q in zip(best, halves, quarters))
    return desc, pred


def wave_pass_plain(src, self_sad, inter_best, inter_pred, cur_y, cur_u,
                    cur_v, quality, *, is_inter):
    aligned_h, aligned_w = cur_y.shape
    wb, hb = aligned_w // MB, aligned_h // MB
    n = wb * hb
    dev = cur_y.device
    pad_y = F.pad(cur_y.to(I32), (YPAD,) * 4)
    pad_u = F.pad(cur_u.to(I32), (CPAD,) * 4)
    pad_v = F.pad(cur_v.to(I32), (CPAD,) * 4)
    desc_out = torch.zeros((len(DESC_FIELDS), n), dtype=I32, device=dev)
    coef = (torch.zeros((n, MB, MB), dtype=torch.int16, device=dev),
            torch.zeros((n, MB // 2, MB // 2), dtype=torch.int16, device=dev),
            torch.zeros((n, MB // 2, MB // 2), dtype=torch.int16, device=dev))
    a16 = torch.arange(MB, device=dev)
    a8 = torch.arange(MB // 2, device=dev)

    for members in wave_members(wb, hb):
        m = torch.as_tensor(members, device=dev).long()
        px, py = ((m % wb) * MB).to(I32), ((m // wb) * MB).to(I32)
        wins = _wave_windows(pad_y, pad_u, pad_v, px, py)
        srcb = tuple(s[m] for s in src)
        desc, pred = intra_search_wave(wins, srcb, px, py, self_sad[m],
                                       quality, aligned_w, aligned_h)
        if is_inter:
            desc = merge_descs(desc, {k: v[m] for k, v in inter_best.items()})
            pred = tuple(torch.where(desc["is_intra"][:, None, None], a, b[m])
                         for a, b in zip(pred, inter_pred))
        intra_default = desc["is_intra"] & ~desc["is_motion"]
        pred = tuple(torch.where(intra_default[:, None, None], 0, p)
                     for p in pred)

        # ---- encode path (encode.cpp:69-163) and reconstruction
        res = tuple(ops.wrap16(s - p) for s, p in zip(srcb, pred))
        ty = ops.quads_to_mb(ops.fdct8(ops.mb_quads(res[0])))
        tu, tv = ops.fdct8(res[1]), ops.fdct8(res[2])
        qp = ops.adaptive_qp(quality, ty)
        qy, qu, qv = engine.quantize_planes(ty, tu, tv, qp, intra_default)
        rec = engine.reconstruct(qy, qu, qv, qp, intra_default, pred,
                                 desc["is_copy"])

        # ---- writes
        desc["q_index"] = qp
        desc["variance"] = ops.wrap16(ops.block_variance2(ty))
        desc_out[:, m] = torch.stack([desc[k].to(I32) for k in DESC_FIELDS])
        qy_mb = ops.quads_to_mb(qy.reshape(-1, 4, MB // 2, MB // 2))
        for out, q in zip(coef, (qy_mb, qu, qv)):
            out[m] = q.to(torch.int16)
        rows = (py[:, None] + YPAD + a16)[:, :, None]
        cols = (px[:, None] + YPAD + a16)[:, None, :]
        pad_y[rows, cols] = rec[0]
        rows = ((py >> 1)[:, None] + CPAD + a8)[:, :, None]
        cols = ((px >> 1)[:, None] + CPAD + a8)[:, None, :]
        pad_u[rows, cols] = rec[1]
        pad_v[rows, cols] = rec[2]

    rec_y = pad_y[YPAD:YPAD + aligned_h, YPAD:YPAD + aligned_w]
    rec_u = pad_u[CPAD:CPAD + aligned_h // 2, CPAD:CPAD + aligned_w // 2]
    rec_v = pad_v[CPAD:CPAD + aligned_h // 2, CPAD:CPAD + aligned_w // 2]
    return (rec_y, rec_u, rec_v,
            dict(zip(DESC_FIELDS, desc_out.unbind(0))), coef)


@functools.lru_cache(maxsize=None)
def _check_geometry():
    """Raises unless the kernel was built for this module's window (its
    reach in MBs, the right reach being the wait rule's LEAD)."""
    got = (ctypes.c_int * 4)()
    _build.kernel_fn("cairo_wave_geometry", "p")(ctypes.addressof(got))
    if tuple(got) != window_reach() or window_reach()[1] != LEAD:
        raise RuntimeError(f"wave.cu's window reach {tuple(got)} is not "
                           f"cuda_wave's {window_reach()} (lead {LEAD})")


@functools.lru_cache(maxsize=None)
def _consts(device: str):
    """The transform and quantiser tables wave.cu reads: DCT basis, intra
    and inter matrices, luma and chroma DC scales for qp 0..31."""
    c = ops.consts(device)
    return ops.settled(device, torch.cat([
        c["B"].reshape(-1), c["INTRA_QM"].reshape(-1),
        c["INTER_QM"].reshape(-1), c["LUMA_DC"][:32],
        c["CHROMA_DC"][:32]]).contiguous())


def wave_pass(src, self_sad, inter_best, inter_pred, cur_y, cur_u, cur_v,
              quality, *, is_inter):
    """The frame's whole wave pass: search, merge, encode, reconstruct.

    src: (Y (N,16,16), U (N,8,8), V (N,8,8)) int32 source blocks;
    self_sad: (N,) int32 sum |src Y|; inter_best / inter_pred: K5's fields
    and the winners' int32 prediction blocks (None on intra frames);
    cur_*: the current ring slot's planes at entry (H, W) / (H/2, W/2);
    quality: int32 scalar tensor. Returns (rec_y, rec_u, rec_v, desc,
    (coef_y, coef_u, coef_v) blocks), see the module docstring."""
    if cur_y.device.type == "cpu":
        return wave_pass_plain(src, self_sad, inter_best, inter_pred, cur_y,
                               cur_u, cur_v, quality, is_inter=is_inter)
    h, w = cur_y.shape
    if h % MB or w % MB:
        raise ValueError("wave_pass: plane dims must be multiples of 16")
    _check_geometry()
    dev = cur_y.device
    n = (h // MB) * (w // MB)
    _build.check(src[0], "src_y", I32, (n, MB, MB))
    _build.check(src[1], "src_u", I32, (n, MB // 2, MB // 2))
    _build.check(src[2], "src_v", I32, (n, MB // 2, MB // 2))
    _build.check(self_sad, "self_sad", I32, (n,))
    q = quality.reshape(1)
    _build.check(q, "quality", I32, (1,))
    # the frame as the kernel reads and updates it, int16 (ring values are
    # int16); the kernel writes every MB of the int32 reconstruction
    work = tuple(p.to(torch.int16, copy=True).contiguous()
                 for p in (cur_y, cur_u, cur_v))
    shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    for p, name, shape in zip(work, ("cur_y", "cur_u", "cur_v"), shapes):
        _build.check(p, name, torch.int16, shape)
    rec = tuple(torch.empty(shape, dtype=I32, device=dev) for shape in shapes)
    if is_inter:
        inter = torch.stack([inter_best[k].to(I32)
                             for k in cuda_inter.FIELDS])
        pred = tuple(p.contiguous() for p in inter_pred)
        _build.check(pred[0], "pred_y", I32, (n, MB, MB))
        _build.check(pred[1], "pred_u", I32, (n, MB // 2, MB // 2))
        _build.check(pred[2], "pred_v", I32, (n, MB // 2, MB // 2))
    else:  # never read on intra frames
        inter, pred = self_sad, src
    desc = torch.empty((len(DESC_FIELDS), n), dtype=I32, device=dev)
    coef = (torch.empty((n, MB, MB), dtype=torch.int16, device=dev),
            torch.empty((n, MB // 2, MB // 2), dtype=torch.int16, device=dev),
            torch.empty((n, MB // 2, MB // 2), dtype=torch.int16, device=dev))
    consts = _consts(str(dev))
    # the row ticket, then the MBs completed per row
    sync = torch.zeros(1 + h // MB, dtype=I32, device=dev)
    fn = _build.kernel_fn("cairo_wave_pass", "ppppppppppppppppiiipppppp")
    _build.launch(fn, dev, *(t.data_ptr() for t in src), self_sad.data_ptr(),
                  inter.data_ptr(), *(t.data_ptr() for t in pred),
                  *(t.data_ptr() for t in rec),
                  *(t.data_ptr() for t in work), q.data_ptr(),
                  consts.data_ptr(), h, w, int(bool(is_inter)),
                  sync.data_ptr(), desc.data_ptr(),
                  *(t.data_ptr() for t in coef))
    LAUNCHES["wave_pass"] += 1
    return (*rec, dict(zip(DESC_FIELDS, desc.unbind(0))), coef)
