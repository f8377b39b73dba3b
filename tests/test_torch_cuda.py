"""Card-only tests of the port: the CUDA kernels K1-K11 (K4 at both pad
sets; K1-K4 also with a tile's reference margin and ring halo) against
their plain versions, and the fast-mode and conformance encoders, the
wavefront decode and the tiled encoder and decoder on the card against
the CPU; analysis and the 4x4/16x16 transforms on the card against the
CPU, and the conformance encoder against the host reference engine
(Evx1Encoder). Each test is
marked `cuda` and skips without a CUDA card. The file imports neither jax
nor cairo_tpu, so it runs on a machine without them:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from cairo_tpu_torch.gpu import (_build, api, cuda_deblock, cuda_inter,
                                 cuda_motion, cuda_pred, cuda_tail, cuda_wave,
                                 cuda_wavedec, deblock, engine, motion, ops,
                                 shard, tiled, wavefront, wire)
from cairo_tpu_torch.synth import synth_frames
from util_deblock import KINDS, SIZES, TILE_SIZES, deblock_case
from util_wire import (CASES, content_frame, last_entries_only, rewritten,
                       yuv5d_wire)

RING = 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _eq(got, want):
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_kernels_match_plain(dev):
    rng = np.random.default_rng(6)
    h, w = 96, 160
    ref = [rng.integers(-300, 560, s) for s in ((h, w), (h // 2, w // 2),
                                                  (h // 2, w // 2))]
    src = [np.roll(r, (4, -6) if i == 0 else (2, -3), (0, 1)).clip(0, 255)
           for i, r in enumerate(ref)]
    src = [_t(p.astype(np.int32)).to(dev) for p in src]
    ref = [_t(p, torch.int16).to(dev) for p in ref]
    cmax = cuda_motion.chroma_max_maps(src[1], src[2], ref[1], ref[2])
    _eq(cmax, cuda_motion.chroma_max_maps_plain(src[1], src[2], ref[1],
                                                ref[2]))
    thr = torch.tensor(5, dtype=torch.int32, device=dev)
    for x0, width in ((0, w), (32, w + 96)):
        got = cuda_motion.dense_select(src[0], ref[0], cmax, x0, width, h,
                                       thr)
        want = cuda_motion.dense_select_plain(src[0], ref[0], cmax, x0,
                                              width, h, thr)
        for g, wnt in zip(got, want):
            _eq(g, wnt)

    n = (h // 16) * (w // 16)
    ring = _t(rng.integers(-600, 600, (RING, h, w)), torch.int16).to(dev)
    ring_c = _t(rng.integers(-600, 600, (RING, h // 2, w // 2)),
                torch.int16).to(dev)
    mx = _t(rng.integers(-20, 21, n).astype(np.int32)).to(dev)
    my = _t(rng.integers(-20, 21, n).astype(np.int32)).to(dev)
    slot = torch.tensor([2], dtype=torch.int32, device=dev)
    _eq(cuda_pred.gather_windows(ring, slot, mx, my, 18, 17),
        cuda_pred.gather_windows_plain(ring, slot, mx, my, 18, 17))
    per_mb = [_t(a).to(dev) for a in (
        rng.integers(0, 4, n).astype(np.int32), rng.random(n) < 0.5,
        rng.random(n) < 0.5, rng.integers(0, 8, n).astype(np.int32),
        rng.random(n) < 0.2)]
    args = (ring, ring_c, ring_c, per_mb[0], mx, my, *per_mb[1:])
    for g, wnt in zip(cuda_pred.pred_planes(*args),
                      cuda_pred.pred_planes_plain(*args)):
        _eq(g, wnt)


@pytest.mark.cuda
def test_card_chunks_match_cpu(dev):
    frames = synth_frames(120, 72, 4, seed=3)
    cpu, card = api.GpuEncoder(device="cpu"), api.GpuEncoder(device=dev)
    dec = api.GpuDecoder(device=dev)
    for i, f in enumerate(frames):
        a, b = cpu.encode(f), card.encode(f)
        assert a == b, f"frame {i}"
        np.testing.assert_array_equal(dec.decode(b), card.peek_destination())
    assert dec.host_frames == 0


@pytest.mark.cuda
def test_conformance_kernels_match_plain(dev):
    """K4 at 33/17, K5 and K6 (an intra and an inter pass) at 160x96."""
    rng = np.random.default_rng(8)
    h, w = 96, 160
    n = (h // 16) * (w // 16)
    shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    src_p = [_t(rng.integers(0, 256, s).astype(np.int32)).to(dev)
             for s in shapes]
    ring = []
    for p in src_p:   # slots 0-2 shifted copies, slot 3 with overshoot
        slots = [torch.roll(p, (2 * k, -3 * k), (0, 1)) for k in range(3)]
        slots.append(p + _t(rng.integers(-300, 300, p.shape)).to(dev))
        ring.append(torch.stack(slots).to(torch.int16).contiguous())
    src = tuple(ops.plane_to_blocks(p, s).contiguous()
                for p, s in zip(src_p, (16, 8, 8)))

    mx = _t(rng.integers(-40, 41, n).astype(np.int32)).to(dev)
    my = _t(rng.integers(-40, 41, n).astype(np.int32)).to(dev)
    per_mb = [_t(a).to(dev) for a in (
        rng.integers(0, 4, n).astype(np.int32), rng.random(n) < 0.5,
        rng.random(n) < 0.5, rng.integers(0, 8, n).astype(np.int32),
        rng.random(n) < 0.2)]
    args = (*ring, per_mb[0], mx, my, *per_mb[1:], cuda_pred.WIDE_YPAD,
            cuda_pred.WIDE_CPAD)
    for g, wnt in zip(cuda_pred.pred_planes(*args),
                      cuda_pred.pred_planes_plain(*args)):
        _eq(g, wnt)

    for level in (128, 96):     # flat: ties at SAD 0 and at SAD 8192
        flat_src = tuple(torch.full_like(b, 128) for b in src)
        flat = tuple(torch.full_like(r, level) for r in ring)
        hdr = torch.tensor([3, 16], dtype=torch.int32, device=dev)
        got = cuda_inter.inter_search(flat_src, flat, hdr)
        want = cuda_inter.inter_search_plain(flat_src, flat, hdr)
        for k in cuda_inter.FIELDS:
            _eq(got[k], want[k])

    for quality in (4, 16, 29):
        hdr = torch.tensor([3, quality], dtype=torch.int32, device=dev)
        best = cuda_inter.inter_search(src, ring, hdr)
        want = cuda_inter.inter_search_plain(src, ring, hdr)
        for k in cuda_inter.FIELDS + ("is_intra",):
            _eq(best[k], want[k])
        state = dict(ring_y=ring[0], ring_u=ring[1], ring_v=ring[2])
        pred = wavefront.wide_gather_pred(
            state, hdr[0], best["target"], best["motion_x"],
            best["motion_y"], best["sp_pred"], best["sp_amount"],
            best["sp_index"], torch.zeros_like(best["is_intra"]))
        self_sad = src[0].abs().sum(dim=(1, 2), dtype=torch.int32)
        cur = tuple(p[3] for p in ring)
        for inter in (None, (best, pred)):
            ib, ip = inter if inter else (None, None)
            got = cuda_wave.wave_pass(src, self_sad, ib, ip, *cur, hdr[1],
                                      is_inter=inter is not None)
            want = cuda_wave.wave_pass_plain(src, self_sad, ib, ip, *cur,
                                             hdr[1],
                                             is_inter=inter is not None)
            for g, wnt in zip(got[:3] + got[4], want[:3] + want[4]):
                _eq(g, wnt)
            for k in cuda_wave.DESC_FIELDS:
                _eq(got[3][k], want[3][k])


@pytest.mark.cuda
def test_conformance_card_chunks_match_cpu(dev):
    frames = synth_frames(120, 72, 3, seed=5)
    for quality in (4, 29):
        cpu = api.ConformanceGpuEncoder(device="cpu")
        card = api.ConformanceGpuEncoder(device=dev)
        for enc in (cpu, card):
            enc.set_quality(quality)
        for i, f in enumerate(frames):
            assert cpu.encode(f) == card.encode(f), f"q{quality} frame {i}"


def _k2_case(kind, h, w, rng):
    """Source and reference planes for K2: `flat` (every offset ties, so
    dist^2 and scan order decide), `period4` (a texture of period 4: ties
    at many offsets), `int16` (references over the whole int16 range)."""
    if kind == "flat":
        src = np.full((h, w), 128)
        ref = np.full((h, w), 128)
    elif kind == "period4":
        yy, xx = np.indices((h, w))
        src = ((xx % 4) * 40 + (yy % 4) * 10 + 20)
        ref = np.roll(src, (1, 1), (0, 1)) + rng.integers(0, 2, (h, w))
    else:
        src = rng.integers(0, 256, (h, w))
        ref = rng.integers(-32768, 32768, (h, w))
    return src.astype(np.int32), ref.astype(np.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flat", "period4", "int16"])
def test_dense_select_matches_plain(dev, kind):
    """K2 against its plain version where ties decide and where |src -
    ref| spans the range its float arithmetic must keep exact, at the
    frame origin and at a tile origin (x0, width)."""
    rng = np.random.default_rng(61)
    h, w = 96, 192
    src, ref = _k2_case(kind, h, w, rng)
    src_y, ref_y = _t(src).to(dev), _t(ref).to(dev)
    # flat chroma: the chroma map is 0 and the luma decides the MAD
    cu = torch.full((h // 2, w // 2), 128, dtype=torch.int32, device=dev)
    cmax = cuda_motion.chroma_max_maps(cu, cu, cu.to(torch.int16),
                                       cu.to(torch.int16))
    # no copy grade; copy grade (and co-located early-outs); all frozen
    for thr in (0, 5, 1 << 20):
        t_thr = torch.tensor(thr, dtype=torch.int32, device=dev)
        for x0, width in ((0, w), (48, w + 112)):
            got = cuda_motion.dense_select(src_y, ref_y, cmax, x0, width, h,
                                           t_thr)
            want = cuda_motion.dense_select_plain(src_y, ref_y, cmax, x0,
                                                  width, h, t_thr)
            for g, wnt in zip(got, want):
                _eq(g, wnt)


@pytest.mark.cuda
def test_wave_pass_pipelined_rows(dev):
    """K6 at 640x352 (40x22 MBs, many rows in flight at once), on an intra
    and an inter pass, against its plain version; three runs must give
    identical outputs, so an ordering race between rows would show."""
    rng = np.random.default_rng(66)
    h, w = 352, 640
    shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    src_p = [_t(rng.integers(0, 256, s).astype(np.int32)).to(dev)
             for s in shapes]
    ring = []
    for p in src_p:   # slots 0-2 shifted copies, slot 3 with overshoot
        slots = [torch.roll(p, (2 * k, -3 * k), (0, 1)) for k in range(3)]
        slots.append(p + _t(rng.integers(-300, 300, p.shape)).to(dev))
        ring.append(torch.stack(slots).to(torch.int16).contiguous())
    src = tuple(ops.plane_to_blocks(p, s).contiguous()
                for p, s in zip(src_p, (16, 8, 8)))
    hdr = torch.tensor([3, 16], dtype=torch.int32, device=dev)
    best = cuda_inter.inter_search(src, ring, hdr)
    state = dict(ring_y=ring[0], ring_u=ring[1], ring_v=ring[2])
    pred = wavefront.wide_gather_pred(
        state, hdr[0], best["target"], best["motion_x"], best["motion_y"],
        best["sp_pred"], best["sp_amount"], best["sp_index"],
        torch.zeros_like(best["is_intra"]))
    self_sad = src[0].abs().sum(dim=(1, 2), dtype=torch.int32)
    cur = tuple(p[3] for p in ring)

    def flat(o):
        return [*o[:3], *(o[3][k] for k in cuda_wave.DESC_FIELDS), *o[4]]

    for inter in (None, (best, pred)):
        ib, ip = inter if inter else (None, None)
        kw = dict(is_inter=inter is not None)
        runs = [flat(cuda_wave.wave_pass(src, self_sad, ib, ip, *cur, hdr[1],
                                         **kw)) for _ in range(3)]
        want = flat(cuda_wave.wave_pass_plain(src, self_sad, ib, ip, *cur,
                                              hdr[1], **kw))
        for run in runs:
            for g, wnt in zip(run, want):
                _eq(g, wnt)


@pytest.mark.cuda
def test_wave_kernel_built_for_the_modules_window(dev):
    """wave.cu's window reach (LEFT, RIGHT, UP, DOWN) is cuda_wave's
    WIN_X / WIN_Y, its right reach the wait rule's LEAD."""
    cuda_wave._check_geometry.cache_clear()
    cuda_wave._check_geometry()


# frame sizes for K5: one MB column, one MB row, and 13 MB columns (a
# masked tail after the last full run of inter.cu's RUN macroblocks)
K5_SIZES = [(16, 96), (96, 16), (208, 48)]


def _k5_case(kind, h, w, rng, dev):
    """Source blocks, ring and header for K5: `shifted` (shifted copies
    with noise), `flat0` / `flat8192` (flat planes: every candidate ties,
    at SAD 0 and at the SAD threshold), `frozen` (every reference equals
    the source: every MB freezes on the co-located candidate), `moving`
    (no co-located MAD under the threshold: no MB freezes)."""
    shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    src_p = [_t(rng.integers(0, 256, s).astype(np.int32)).to(dev)
             for s in shapes]
    if kind.startswith("flat"):
        src_p = [torch.full_like(p, 128) for p in src_p]
        level = 128 if kind == "flat0" else 96
        ring = [torch.full((RING,) + p.shape, level, dtype=torch.int16,
                           device=dev) for p in src_p]
    elif kind == "frozen":
        ring = [torch.stack([p] * RING).to(torch.int16).contiguous()
                for p in src_p]
    else:
        ring = []
        for i, p in enumerate(src_p):
            slots = []
            for k in range(RING):
                dy, dx = (3 * k - 4, 5 - 2 * k) if i == 0 else (k - 2, 2 - k)
                r = torch.roll(p, (dy, dx), (0, 1))
                noise = rng.integers(-2, 3, p.shape) if kind == "shifted" \
                    else rng.integers(40, 90, p.shape)
                slots.append(r + _t(noise.astype(np.int32)).to(dev))
            ring.append(torch.stack(slots).to(torch.int16).contiguous())
    src = tuple(ops.plane_to_blocks(p, s).contiguous()
                for p, s in zip(src_p, (16, 8, 8)))
    return src, tuple(ring)


def _colocated_frozen(src, ring, hdr):
    """Per MB and reference offset 1..3: co-located MAD below the
    threshold."""
    thr = (int(hdr[1]) >> 2) + 1
    out = []
    for off in range(1, RING):
        slot = (int(hdr[0]) - off) % RING
        co = [ops.plane_to_blocks(r[slot].to(torch.int32), s)
              for r, s in zip(ring, (16, 8, 8))]
        mad = torch.stack([(a - b).abs().amax(dim=(1, 2))
                           for a, b in zip(src, co)]).amax(0)
        out.append(mad < thr)
    return torch.stack(out)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["shifted", "flat0", "flat8192", "frozen",
                                  "moving"])
@pytest.mark.parametrize("size", K5_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_inter_search_edges(dev, size, kind):
    """K5 against its plain version at frame edges and a masked tail, where
    ties decide, with every MB frozen and with none; a second call gives
    identical outputs."""
    w, h = size
    rng = np.random.default_rng(w * 1000 + h)
    src, ring = _k5_case(kind, h, w, rng, dev)
    hdr = torch.tensor([3, 16], dtype=torch.int32, device=dev)
    frozen = _colocated_frozen(src, ring, hdr)
    if kind == "frozen":
        assert bool(frozen.all())
    if kind == "moving":
        assert not bool(frozen.any())
    got = cuda_inter.inter_search(src, ring, hdr)
    again = cuda_inter.inter_search(src, ring, hdr)
    want = cuda_inter.inter_search_plain(src, ring, hdr)
    for k in cuda_inter.FIELDS + ("is_intra",):
        _eq(got[k], want[k])
        _eq(again[k], got[k])


# chroma plane sizes (w, h) for K1: one chroma block column, widths of 40
# and 33 blocks (not multiples of motion.cu's run of 32) and 1080p chroma
K1_SIZES = [(8, 32), (320, 24), (264, 16), (960, 544)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "extremes"])
@pytest.mark.parametrize("size", K1_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_chroma_max_maps_edges(dev, size, kind):
    """K1 against its plain version at widths that leave a masked tail, and
    with source values 0 / 255 against references at -32768 / 32767 (the
    widest differences its fp32 arithmetic must keep exact)."""
    w, h = size
    rng = np.random.default_rng(w + 7 * h)
    if kind == "random":
        src = [rng.integers(0, 256, (h, w)) for _ in range(2)]
        ref = [rng.integers(-300, 560, (h, w)) for _ in range(2)]
    else:
        src = [rng.choice([0, 255], (h, w)) for _ in range(2)]
        ref = [rng.choice([-32768, 32767], (h, w)) for _ in range(2)]
    su, sv = (_t(a.astype(np.int32)).to(dev) for a in src)
    ru, rv = (_t(a, torch.int16).to(dev) for a in ref)
    _eq(cuda_motion.chroma_max_maps(su, sv, ru, rv),
        cuda_motion.chroma_max_maps_plain(su, sv, ru, rv))


# frame sizes (w, h) for K3 and K4: one MB column, one MB row, 1080p
PRED_SIZES = [(16, 96), (96, 16), (1920, 1088)]


def _pred_ring(rng, h, w, dev):
    return tuple(_t(rng.integers(-600, 600, (RING,) + s), torch.int16)
                 .to(dev) for s in ((h, w), (h // 2, w // 2),
                                    (h // 2, w // 2)))


def _windows_exact(ring, slot, mx, my):
    """K3's three-plane and single-plane launches against their plain
    versions, each called twice with identical outputs."""
    s = torch.tensor([slot], dtype=torch.int32, device=ring[0].device)
    want = cuda_pred.gather_windows_yuv_plain(ring, s, mx, my)
    for _ in range(2):
        for g, wnt in zip(cuda_pred.gather_windows_yuv(ring, s, mx, my),
                          want, strict=True):
            _eq(g, wnt)
        _eq(cuda_pred.gather_windows(ring[0], s, mx, my, 18, 17), want[0])
        _eq(cuda_pred.gather_windows(ring[1], s, mx >> 1, my >> 1, 10, 9),
            want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("slot", range(RING))
@pytest.mark.parametrize("size", PRED_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_gather_windows_edges(dev, size, slot):
    """K3 at one MB column, one MB row and 1080p, from each ring slot, with
    motion in [-20, 20] (the first MBs at +-40)."""
    w, h = size
    rng = np.random.default_rng(w + h + slot)
    ring = _pred_ring(rng, h, w, dev)
    n = (h // 16) * (w // 16)
    mx = rng.integers(-20, 21, n).astype(np.int32)
    my = rng.integers(-20, 21, n).astype(np.int32)
    mx[:max(1, n // 4)], my[:max(1, n // 4)] = 40, -40
    _windows_exact(ring, slot, _t(mx).to(dev), _t(my).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("reach", [-40, 40], ids=["low", "high"])
def test_gather_windows_all_clamped(dev, reach):
    """K3 with every MB's offset clamped by its window, low and high, on
    odd and even offsets (the chroma shift of -17 is -9)."""
    rng = np.random.default_rng(90 + reach)
    h, w = 96, 160
    ring = _pred_ring(rng, h, w, dev)
    n = (h // 16) * (w // 16)
    mx = np.where(rng.random(n) < 0.5, reach, np.sign(reach) * 17)
    my = np.where(rng.random(n) < 0.5, reach, np.sign(reach) * 19)
    _windows_exact(ring, 1, _t(mx.astype(np.int32)).to(dev),
                   _t(my.astype(np.int32)).to(dev))


def _k4_fields(kind, n, reach, rng, dev):
    """K4's per-MB fields: `slots` (slots -1..4, -1 and 4 give zero),
    `sp_index` (sp_index in -5..12, clamped to 0..7), `all_intra`,
    `no_intra`, `uint8` (the flags as uint8 instead of bool); each with
    sub-pel at both amounts and motion in [-reach, reach] and beyond."""
    lo, hi = (-1, 5) if kind == "slots" else (0, 4)
    slot = rng.integers(lo, hi, n).astype(np.int32)
    mx = rng.integers(-reach - 8, reach + 9, n).astype(np.int32)
    my = rng.integers(-reach - 8, reach + 9, n).astype(np.int32)
    spp, spa = rng.random(n) < 0.6, rng.random(n) < 0.5
    spi = rng.integers(*((-5, 13) if kind == "sp_index" else (0, 8)),
                       n).astype(np.int32)
    zero = {"all_intra": np.ones(n, bool),
            "no_intra": np.zeros(n, bool)}.get(kind, rng.random(n) < 0.2)
    flags = [spp, spa, zero]
    if kind == "uint8":
        flags = [f.astype(np.uint8) for f in flags]
    t = [_t(a).to(dev) for a in (slot, mx, my, *flags, spi)]
    return t[0], t[1], t[2], t[3], t[4], t[6], t[5]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["slots", "sp_index", "all_intra",
                                  "no_intra", "uint8"])
@pytest.mark.parametrize("pads", [(17, 9), (33, 17)],
                         ids=["17-9", "33-17"])
def test_pred_planes_edges(dev, pads, kind):
    """K4 at both pad sets against its plain version on bad slots,
    sub-pel indices outside 0..7, all and no MBs intra and flags passed
    as uint8, at 208x48 (39 MBs, a tail in every thread block's MB group)
    and at 1080p; a second call gives identical planes."""
    for w, h in ((208, 48), (1920, 1088)):
        rng = np.random.default_rng(w + pads[0] + len(kind))
        ring = _pred_ring(rng, h, w, dev)
        fields = _k4_fields(kind, (h // 16) * (w // 16), pads[0] - 2, rng,
                            dev)
        want = cuda_pred.pred_planes_plain(*ring, *fields, *pads)
        for _ in range(2):
            for g, wnt in zip(cuda_pred.pred_planes(*ring, *fields, *pads),
                              want, strict=True):
                _eq(g, wnt)


def _k7_inputs(rng, h, w, dev):
    """K7's arguments at (h, w): random planes and residuals, half the
    MBs intra-motion, vectors over and beyond the clip box (below-left
    ones among them), every sub-pel direction and indices outside 0..7,
    copies."""
    n = (h // 16) * (w // 16)
    shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    planes = tuple(_t(rng.integers(-300, 560, s), torch.int16).to(dev)
                   for s in shapes)
    stale = tuple(_t(rng.integers(-300, 560, s), torch.int16).to(dev)
                  for s in shapes)
    res = tuple(_t(rng.integers(-600, 600, (n, s, s)).astype(np.int32))
                .to(dev) for s in (16, 8, 8))
    fields = _t(np.stack([
        rng.integers(-40, 41, n), rng.integers(-56, 24, n),
        rng.random(n) < 0.6, rng.random(n) < 0.5,
        np.arange(n) % 10 - 1, rng.random(n) < 0.2]).astype(np.int32))
    bt = np.where(rng.random(n) < 0.5, 3, 1).astype(np.uint8)
    bi, bj, n_active = wavefront.build_compact_schedule(bt, w // 16, h // 16)
    return (planes, stale, res, fields.to(dev), _t(bi).to(dev),
            _t(bj).to(dev), n_active, int((bt == 3).sum()))


def _k7_check(args):
    """K7 on `args` twice from the same planes: each run equal to the
    plain version, so identical, and each one launch covering n_active
    waves and n_members members."""
    planes, *rest = args
    n_active, n_members = rest[-2:]
    want = cuda_wavedec.wave_decode_plain(tuple(p.clone() for p in planes),
                                          *rest)
    for _ in range(2):
        before = dict(cuda_wavedec.LAUNCHES)
        got = cuda_wavedec.wave_decode(tuple(p.clone() for p in planes),
                                       *rest)
        for g, wnt in zip(got, want, strict=True):
            _eq(g, wnt)
        grew = {k: cuda_wavedec.LAUNCHES[k] - before[k] for k in before}
        assert grew == {"wave_decode": int(n_active > 0),
                        "wave_decode_waves": n_active,
                        "wave_decode_members": n_members}


def _k7_frame(rng, h, w, dev, members, mx, my, sp_pred):
    """K7's arguments with the given members (bool (N,)) and vectors,
    random planes, residuals, sub-pel amounts and directions, copies."""
    n = (h // 16) * (w // 16)
    planes, stale, res, fields, *_ = _k7_inputs(rng, h, w, dev)
    fields[0], fields[1], fields[2] = (
        torch.as_tensor(np.broadcast_to(a, n).astype(np.int32))
        for a in (mx, my, sp_pred))
    bt = np.where(members, 3, 1).astype(np.uint8)
    bi, bj, n_active = wavefront.build_compact_schedule(bt, w // 16, h // 16)
    return (planes, stale, res, fields, _t(bi).to(dev), _t(bj).to(dev),
            n_active, int(members.sum()))


@pytest.mark.cuda
def test_wave_decode_matches_plain(dev):
    """K7 at 160x96 against its plain version; two runs from the same
    planes are identical, and the counts are one launch per call, the
    active waves and the members rebuilt."""
    _k7_check(_k7_inputs(np.random.default_rng(71), 96, 160, dev))


@pytest.mark.cuda
def test_wave_decode_row_chain_1080p(dev):
    """Every MB of a 1920x1088 frame a member reading 16 samples to its
    left, full-pel: each waits on its left neighbour, a chain as long as
    an MB row (120 members), twice, exact."""
    h, w = 1088, 1920
    n = (h // 16) * (w // 16)
    args = _k7_frame(np.random.default_rng(72), h, w, dev,
                     np.ones(n, bool), -16, 0, 0)
    assert cuda_wavedec.dependency_chain(args[3], args[4], args[5],
                                         args[6], h, w) == w // 16
    _k7_check(args)


@pytest.mark.cuda
def test_wave_decode_reads_only_stale(dev):
    """Members whose vectors point right of and below their block, full
    pel, read only stale samples: no member waits on another."""
    rng = np.random.default_rng(73)
    h, w = 192, 320
    n = (h // 16) * (w // 16)
    args = _k7_frame(rng, h, w, dev, rng.random(n) < 0.7,
                     rng.integers(0, 33, n), rng.integers(0, 17, n), 0)
    deps = cuda_wavedec.dependencies(args[3], args[4], args[5], args[6], h,
                                     w)
    assert (deps < 0).all()
    _k7_check(args)


@pytest.mark.cuda
def test_wave_decode_corner_members(dev):
    """One member at each corner of the frame, vectors over the clip box,
    sub-pel."""
    rng = np.random.default_rng(74)
    h, w = 96, 160
    wb, hb = w // 16, h // 16
    members = np.zeros(wb * hb, bool)
    members[[0, wb - 1, (hb - 1) * wb, hb * wb - 1]] = True
    args = _k7_frame(rng, h, w, dev, members, rng.integers(-40, 41, wb * hb),
                     rng.integers(-56, 24, wb * hb), 1)
    _k7_check(args)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 2])
def test_wave_decode_capped_grid(dev, blocks, monkeypatch):
    """K7 launched with one and with two blocks (cuda_wavedec.MAX_BLOCKS):
    the blocks take the tickets in order and each waits only on earlier
    tickets, so a grid of any size finishes, exactly."""
    monkeypatch.setattr(cuda_wavedec, "MAX_BLOCKS", blocks)
    rng = np.random.default_rng(75)
    _k7_check(_k7_inputs(rng, 96, 160, dev))
    h, w = 192, 320
    n = (h // 16) * (w // 16)
    _k7_check(_k7_frame(rng, h, w, dev, np.ones(n, bool),
                        rng.integers(-40, 41, n), rng.integers(-56, 24, n),
                        rng.random(n) < 0.6))


@pytest.mark.cuda
def test_wavefront_decode_card_matches_cpu(dev):
    """GpuDecoder on the card against device="cpu" on ConformanceGpuEncoder
    streams at q 4 and 29: identical RGB, no frame on the host, and K7
    rebuilt intra-motion blocks."""
    frames = synth_frames(120, 72, 3, seed=9)
    for quality in (4, 29):
        enc = api.ConformanceGpuEncoder(device="cpu")
        enc.set_quality(quality)
        chunks = [enc.encode(f) for f in frames]
        cpu, card = api.GpuDecoder(device="cpu"), api.GpuDecoder(device=dev)
        members = cuda_wavedec.LAUNCHES["wave_decode_members"]
        for i, c in enumerate(chunks):
            np.testing.assert_array_equal(card.decode(c), cpu.decode(c),
                                          err_msg=f"q{quality} frame {i}")
        assert card.host_frames == cpu.host_frames == 0
        assert cuda_wavedec.LAUNCHES["wave_decode_members"] > members


# ----------------------------------------------------------------- K8

def _k8_check(tensors):
    """K8 twice on the card, each run equal to the plain version on the
    same inputs, which stay as they were."""
    before = [t.clone() for t in tensors]
    launches = cuda_deblock.LAUNCHES["deblock_frame"]
    runs = [cuda_deblock.deblock_frame(*tensors) for _ in range(2)]
    assert cuda_deblock.LAUNCHES["deblock_frame"] == launches + 2
    want = deblock.deblock_frame(*tensors)
    for run in runs:
        for got, wnt in zip(run, want):
            assert got.dtype == torch.int32 and got.is_contiguous()
            _eq(got, wnt)
    for t, b in zip(tensors, before):
        _eq(t, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_deblock_frame_edges(dev, size, kind):
    _k8_check([_t(a).to(dev) for a in deblock_case(kind, *size)])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", TILE_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_deblock_frame_partial_tiles(dev, size, kind):
    """Planes that K8's tiles do not divide, and one a tile column wide."""
    _k8_check([_t(a).to(dev) for a in deblock_case(kind, *size)])


@pytest.mark.cuda
def test_deblock_frame_unaligned_planes(dev):
    """Contiguous planes that start off a 16-byte boundary (views into a
    flat buffer at an offset of 1, 2 and 3 samples) are taken as aligned
    copies."""
    y, u, v, copy, q = (_t(a).to(dev)
                        for a in deblock_case("mixed", 208, 400))
    views = []
    for i, p in enumerate((y, u, v)):
        flat = torch.zeros(p.numel() + 4, dtype=torch.int32, device=dev)
        view = flat[1 + i:1 + i + p.numel()].view(p.shape)
        view.copy_(p)
        assert view.is_contiguous() and view.data_ptr() % 16
        views.append(view)
    _k8_check([*views, copy, q])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mixed", "int16_range"])
def test_deblock_frame_1080p(dev, kind):
    _k8_check([_t(a).to(dev) for a in deblock_case(kind, 1088, 1920)])


@pytest.mark.cuda
def test_deblock_frame_strided_planes(dev):
    """Planes that are views into wider rows (as the conformance encoder's
    padded reconstruction is on the CPU) are taken as contiguous copies."""
    y, u, v, copy, q = (_t(a).to(dev)
                        for a in deblock_case("mixed", 272, 480))
    wide = [torch.zeros((p.shape[0], p.shape[1] + 40), dtype=torch.int32,
                        device=dev) for p in (y, u, v)]
    views = []
    for big, p in zip(wide, (y, u, v)):
        big[:, 24:24 + p.shape[1]] = p
        views.append(big[:, 24:24 + p.shape[1]])
    assert not views[0].is_contiguous()
    _k8_check([*views, copy, q])


@pytest.mark.cuda
def test_deblock_frame_device_mismatch(dev):
    y, u, v, copy, q = (_t(a) for a in deblock_case("mixed", 32, 48))
    with pytest.raises(ValueError, match="copy_blocks"):
        cuda_deblock.deblock_frame(y.to(dev), u.to(dev), v.to(dev), copy,
                                   q.to(dev))
    with pytest.raises(ValueError, match="u: expected a CUDA tensor"):
        cuda_deblock.deblock_frame(y.to(dev), u, v.to(dev), copy.to(dev),
                                   q.to(dev))


# ------------------------------------------------------ pipelined paths

def _cpu_reference(path, frames, quality):
    """The loop on device="cpu": a path's chunks and their RGB."""
    enc = (api.GpuEncoder if path == "fast" else api.ConformanceGpuEncoder)(
        device="cpu")
    enc.set_quality(quality)
    chunks = [enc.encode(f) for f in frames]
    dec = api.GpuDecoder(device="cpu")
    return chunks, [dec.decode(c) for c in chunks]


def _card_pipelined(path, frames, quality, dev):
    enc = (api.GpuEncoder if path == "fast" else api.ConformanceGpuEncoder)(
        device=dev)
    enc.set_quality(quality)
    chunks = list(enc.encode_many(frames))
    dec = api.GpuDecoder(device=dev)
    rgb = list(dec.decode_many(chunks))
    assert dec.host_frames == 0
    return chunks, rgb, enc, dec


def _same(got, want):
    assert got[0] == want[0]
    assert len(got[1]) == len(want[1])
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        np.testing.assert_array_equal(g, w, err_msg=f"frame {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fast", "conformance"])
def test_pipelined_card_matches_cpu_loop(dev, path):
    """encode_many and decode_many on the card (the conformance chunks
    through the wavefront decode) against a loop on the CPU; the state
    the encoder leaves behind too."""
    frames = synth_frames(176, 144, 6, seed=12)
    want = _cpu_reference(path, frames, 16)
    chunks, rgb, enc, _ = _card_pipelined(path, frames, 16, dev)
    _same((chunks, rgb), want)
    loop = (api.GpuEncoder if path == "fast" else api.ConformanceGpuEncoder)(
        device="cpu")
    loop.set_quality(16)
    for f in frames:
        loop.encode(f)
    (cm, ca), (lm, la) = enc.state_dict(), loop.state_dict()
    assert cm == lm
    for k in la:
        np.testing.assert_array_equal(ca[k], la[k], err_msg=k)
    if path == "fast":
        np.testing.assert_array_equal(enc.peek_destination(), rgb[-1])


@pytest.mark.cuda
def test_pipelined_card_1080p(dev):
    """The fast path at 1920x1080: encode_many and decode_many equal a loop
    over encode and decode on the card."""
    frames = synth_frames(1920, 1080, 4, seed=13)
    chunks, rgb, _, _ = _card_pipelined("fast", frames, 16, dev)
    enc, dec = api.GpuEncoder(device=dev), api.GpuDecoder(device=dev)
    enc.set_quality(16)
    want = [enc.encode(f) for f in frames]
    _same((chunks, rgb), (want, [dec.decode(c) for c in want]))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fast", "conformance"])
@pytest.mark.parametrize("case", ["tail", "coo", "yuv8", "yuv5d"])
def test_pipelined_card_cross_stream_reads(dev, monkeypatch, path, case):
    """Capacities forced small, so that the workers read device memory
    beyond the downloaded wire: the encode wire's COO tail ("tail"), the
    exact coefficient planes and the decoder's dense steps ("coo"), and
    the ring slot of a lossy YUV wire, 8-bit or 5-bit-delta. Equal to the
    CPU loop under the same capacities."""
    caps = dict(tail=dict(COO_SMALL=64), coo=dict(COO_K=256),
                yuv8=dict(EXC_K=2), yuv5d=dict(DEXC_K=2))[case]
    for name, cap in caps.items():
        monkeypatch.setattr(wire, name, cap)
    rng = np.random.default_rng(14)
    frames = [rng.integers(0, 255, (64, 80, 3)).astype(np.uint8)
              for _ in range(4)]
    quality = 1 if case in ("tail", "coo") else 31
    want = _cpu_reference(path, frames, quality)
    got = _card_pipelined(path, frames, quality, dev)
    _same(got[:2], want)


def _sleeping(step, cycles=20_000_000):
    """`step` behind some 10 ms of device sleep on the current stream."""
    def run(*args, **kwargs):
        torch.cuda._sleep(cycles)
        return step(*args, **kwargs)
    return run


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fast", "conformance"])
def test_pipelined_reads_wait_for_the_step(dev, monkeypatch, path):
    """Every step queued behind a device sleep on the compute stream: a
    worker read that did not wait on the frame's event would copy memory
    the step has not written yet."""
    for mod, name in ((api.engine, "encode_step"),
                      (api.engine, "decode_step_coo"),
                      (api.engine, "decode_step"),
                      (api.wavefront, "conformance_encode_step"),
                      (api.wavefront, "conformance_decode_step"),
                      (api.wavefront, "conformance_decode_step_dense")):
        monkeypatch.setattr(mod, name, _sleeping(getattr(mod, name)))
    monkeypatch.setattr(wire, "COO_SMALL", 64)
    frames = synth_frames(176, 144, 5, seed=15)
    want = _cpu_reference(path, frames, 16)
    _same(_card_pipelined(path, frames, 16, dev)[:2], want)


@pytest.mark.cuda
def test_two_pipelines_in_alternation(dev):
    """Two conformance encoders and two decoders pipelining in turns: K6
    and K7, persistent kernels that spin on flags, run from two compute
    streams at once."""
    frames = [synth_frames(176, 144, 5, seed=s) for s in (16, 17)]
    want = [_cpu_reference("conformance", f, q)
            for f, q in zip(frames, (8, 24))]
    encs = [api.ConformanceGpuEncoder(device=dev) for _ in range(2)]
    for enc, q in zip(encs, (8, 24)):
        enc.set_quality(q)
    gens = [enc.encode_many(f) for enc, f in zip(encs, frames)]
    chunks = [[], []]
    for _ in range(5):
        for i in (0, 1):
            chunks[i].append(next(gens[i]))
    decs = [api.GpuDecoder(device=dev) for _ in range(2)]
    gens = [d.decode_many(c) for d, c in zip(decs, chunks)]
    rgb = [[], []]
    for _ in range(5):
        for i in (0, 1):
            rgb[i].append(next(gens[i]))
    for i in (0, 1):
        _same((chunks[i], rgb[i]), want[i])
        assert decs[i].host_frames == 0


# ---------------------------------------------------------------- tiling

# (core width, height) of a tile: a quarter of 1080p (480 + 64 columns of
# halo in the ring), and small ones
HALO_SIZES = [(480, 1088), (64, 48), (16, 96)]


def _margined(rng, h, w, m, lo, hi, real, dev):
    """An (h, w + 2 m) int16 plane: random core, margin random or zero."""
    a = rng.integers(lo, hi, (h, w + 2 * m))
    if not real:
        a[:, :m] = 0
        a[:, w + m:] = 0
    return _t(a, torch.int16).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("real", [True, False], ids=["real", "zero"])
@pytest.mark.parametrize("halo", [0, shard.HALO])
@pytest.mark.parametrize("size", HALO_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_motion_kernels_with_a_margin(dev, size, halo, real):
    """K1 and K2 with the reference margin of a tile's ring (halo 32 luma,
    16 chroma) and without, at a tile origin inside a wider frame."""
    w, h = size
    rng = np.random.default_rng(w + h + halo)
    src = [_t(rng.integers(0, 256, s).astype(np.int32)).to(dev)
           for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    ref_y = _margined(rng, h, w, halo, -300, 560, real, dev)
    ref_u, ref_v = (_margined(rng, h // 2, w // 2, halo // 2, -300, 560,
                              real, dev) for _ in "uv")
    cmax = cuda_motion.chroma_max_maps(src[1], src[2], ref_u, ref_v,
                                       halo // 2)
    _eq(cmax, cuda_motion.chroma_max_maps_plain(src[1], src[2], ref_u,
                                                ref_v, halo // 2))
    thr = torch.tensor(5, dtype=torch.int32, device=dev)
    for x0 in (0, w, 2 * w):
        args = (src[0], ref_y, cmax, x0, 3 * w, h, thr, halo)
        for g, wnt in zip(cuda_motion.dense_select(*args),
                          cuda_motion.dense_select_plain(*args)):
            _eq(g, wnt)


@pytest.mark.cuda
@pytest.mark.parametrize("real", [True, False], ids=["real", "zero"])
@pytest.mark.parametrize("halo", [0, shard.HALO])
@pytest.mark.parametrize("size", HALO_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_pred_kernels_with_a_ring_halo(dev, size, halo, real):
    """K3's three-plane launch and K4 at both pad sets on a ring with a
    halo and without, motion within reach and clamped beyond it."""
    w, h = size
    rng = np.random.default_rng(3 * w + h + halo)
    ring = tuple(torch.stack([_margined(rng, ph, pw, m, -600, 600, real, dev)
                              for _ in range(RING)])
                 for ph, pw, m in ((h, w, halo), (h // 2, w // 2, halo // 2),
                                   (h // 2, w // 2, halo // 2)))
    n = (h // 16) * (w // 16)
    mx = rng.integers(-20, 21, n).astype(np.int32)
    my = rng.integers(-20, 21, n).astype(np.int32)
    mx[:max(1, n // 8)], my[:max(1, n // 8)] = -40, 40
    mx, my = _t(mx).to(dev), _t(my).to(dev)
    slot = torch.tensor([1], dtype=torch.int32, device=dev)
    for g, wnt in zip(cuda_pred.gather_windows_yuv(ring, slot, mx, my, halo),
                      cuda_pred.gather_windows_yuv_plain(ring, slot, mx, my,
                                                         halo), strict=True):
        _eq(g, wnt)
    per_mb = [_t(a).to(dev) for a in (
        rng.integers(0, 4, n).astype(np.int32), rng.random(n) < 0.5,
        rng.random(n) < 0.5, rng.integers(0, 8, n).astype(np.int32),
        rng.random(n) < 0.2)]
    args = (*ring, per_mb[0], mx, my, *per_mb[1:])
    for pads in cuda_pred.PRED_PADS:
        for g, wnt in zip(cuda_pred.pred_planes(*args, *pads, halo=halo),
                          cuda_pred.pred_planes_plain(*args, *pads,
                                                      halo=halo),
                          strict=True):
            _eq(g, wnt)


@pytest.mark.cuda
def test_halo_wrappers_check_alignment(dev):
    ring = tuple(torch.zeros((RING, 16, 16 + 2 * 4), dtype=torch.int16,
                             device=dev) for _ in range(3))
    mx = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        cuda_pred.gather_windows_yuv(ring, 0, mx, mx, 4)
    src = torch.zeros((8, 8), dtype=torch.int32, device=dev)
    ref = torch.zeros((8, 8 + 2 * 4), dtype=torch.int16, device=dev)
    with pytest.raises(ValueError):
        cuda_motion.chroma_max_maps(src, src, ref, ref, 4)


def _tiled_run(devices, n_tiles, frames, quality=16):
    enc = tiled.TiledEncoder(n_tiles=n_tiles, devices=devices)
    enc.set_quality(quality)
    dec = tiled.TiledDecoder(devices=devices)
    chunks, rgb, recon = [], [], []
    for f in frames:
        chunks.append(enc.encode(f))
        recon.append(enc.recon_rgb())
        rgb.append(dec.decode(chunks[-1]))
    return chunks, rgb, recon


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 4])
def test_tiled_card_matches_cpu(dev, k):
    """TiledEncoder and TiledDecoder with k tiles on one card against the
    same on the CPU: chunks, decoded RGB and recon_rgb()."""
    frames = synth_frames(320, 96, 4, seed=20 + k)
    want = _tiled_run(["cpu"] * k, k, frames)
    got = _tiled_run(["cuda:0"] * k, k, frames)
    assert got[0] == want[0]
    for g, wnt, r in zip(got[1], want[1], got[2]):
        np.testing.assert_array_equal(g, wnt)
        np.testing.assert_array_equal(g, r)


@pytest.mark.cuda
def test_tiled_exchange_waits_for_the_neighbour(dev, monkeypatch):
    """Two tiles on one card run on two compute streams (a DeviceQueue
    each); tile 0's steps queue behind some 50 ms of device sleep and tile
    1's do not, so an exchange copy that did not wait on tile 0's event
    would take its strip before tile 0 wrote it: wrong bytes."""
    def sleeping(step):
        calls = [0]

        def run(*args, **kwargs):
            if calls[0] % 2 == 0:          # tile 0 of each frame
                torch.cuda._sleep(100_000_000)
            calls[0] += 1
            return step(*args, **kwargs)
        return run

    for name in ("tile_encode_step", "tile_decode_step"):
        monkeypatch.setattr(shard, name, sleeping(getattr(shard, name)))
    frames = synth_frames(128, 64, 4, seed=31)
    want = _tiled_run(["cpu"] * 2, 2, frames)
    got = _tiled_run(["cuda:0"] * 2, 2, frames)
    assert got[0] == want[0]
    for g, wnt in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, wnt)


# -- the library surface: analysis, the 4x4 and 16x16 transforms, and the
#    reference engine as the card's byte anchor

def _library_blocks(size, n, seed):
    rng = np.random.default_rng(seed)
    b = rng.integers(-32768, 32768, (n, size, size)).astype(np.int16)
    b[: n // 2] = rng.integers(-300, 301, (n // 2, size, size))
    b[0] = -32768
    b[1] = 0
    b[2, 0, 0] = 0
    b[3] = 32767
    return b


@pytest.mark.cuda
def test_analysis_card_matches_cpu(dev):
    """Every metric on the card against the CPU, exact, on tensors and on
    arrays sent to device=."""
    from cairo_tpu_torch import analysis

    y = [_library_blocks(16, 2048, s) for s in (1, 2)]
    c = [_library_blocks(8, 2048, s) for s in (3, 4, 5, 6)]
    calls = {
        "block_sad_delta": lambda y, c, kw: analysis.block_sad(y[0], **kw),
        "block_sad": lambda y, c, kw: analysis.block_sad(y[0], y[1], **kw),
        "block_mse": lambda y, c, kw: analysis.block_mse(y[0], y[1], **kw),
        "block_ssd": lambda y, c, kw: analysis.block_ssd(y[0], y[1], **kw),
        "block_mad": lambda y, c, kw: analysis.block_mad(
            y[0], c[0], c[1], y[1], c[2], c[3], **kw),
        "block_mean": lambda y, c, kw: analysis.block_mean(y[0], **kw),
        "nonzero_block_mean": lambda y, c, kw: analysis.nonzero_block_mean(
            y[0], **kw),
        "block_variance": lambda y, c, kw: analysis.block_variance(y[0],
                                                                   **kw),
        "block_variance2": lambda y, c, kw: analysis.block_variance2(y[0],
                                                                     **kw),
        "block_variance3": lambda y, c, kw: analysis.block_variance3(y[0],
                                                                     **kw),
    }
    ty = [_t(a).to(dev) for a in y]
    tc = [_t(a).to(dev) for a in c]
    for name, fn in calls.items():
        want = fn(y, c, {"device": "cpu"})
        got = fn(ty, tc, {})
        assert got.device.type == "cuda" and got.dtype == torch.int32, name
        _eq(got, want)
        _eq(fn(y, c, {}), want)          # arrays go to "cuda" by default


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fdct4", "idct4", "fdct16_line",
                                  "idct16_line", "fdct16", "idct16"])
def test_library_transforms_card_match_cpu(dev, name):
    size = 4 if name.endswith("4") else 16
    x = _library_blocks(size, 4096, 7)
    if name.endswith("_line"):
        x = x.reshape(-1, 16)
    fn = getattr(ops, name)
    got = fn(_t(x).to(dev))
    assert got.device.type == "cuda"
    _eq(got, fn(_t(x)))


@pytest.mark.cuda
def test_reference_engine_anchors_card_conformance(dev):
    """ConformanceGpuEncoder on the card gives the port's host reference
    engine's bytes at 176x144, q 4, 16 and 29 (an intra inserted at q16),
    and GpuDecoder on the card decodes them, on the device path, to
    Evx1Decoder's RGB."""
    from cairo_tpu_torch import Evx1Decoder, Evx1Encoder

    for q in (4, 16, 29):
        frames = synth_frames(176, 144, 3, seed=40 + q)
        ref, card = Evx1Encoder(), api.ConformanceGpuEncoder(device=dev)
        rdec, cdec = Evx1Decoder(), api.GpuDecoder(device=dev)
        for enc in (ref, card):
            enc.set_quality(q)
        for i, f in enumerate(frames):
            if q == 16 and i == 2:
                ref.insert_intra()
                card.insert_intra()
            a, b = ref.encode(f), card.encode(f)
            assert a == b, f"q{q} frame {i}"
            np.testing.assert_array_equal(cdec.decode(b), rdec.decode(a))
        assert cdec.host_frames == 0


# ---- K9 subpel_scan

SUBPEL_FIELDS = ("sad", "mad", "is_motion", "is_copy", "sp_pred",
                 "sp_amount", "sp_index")


def _smooth_planes(rng, shape, lo, hi):
    """Smooth random planes of `shape` (slots first) in [lo, hi]: their
    sub-pel blends predict fractional shifts of them well."""
    yy, xx = np.mgrid[0:shape[-2], 0:shape[-1]]
    out = np.zeros(shape)
    for plane in out.reshape(-1, *shape[-2:]):
        for _ in range(3):
            fx, fy = rng.uniform(0.05, 0.3, 2)
            px, py = rng.uniform(0, 2 * np.pi, 2)
            plane += np.sin(fx * xx + px) * np.cos(fy * yy + py)
        plane -= plane.min()
        plane *= (hi - lo) / max(plane.max(), 1e-9)
    return np.rint(out + lo).astype(np.int64)


def _subpel_args(dev, rng, h, w, *, kind="search", lo=-300, hi=560, x0=0,
                 full_width=None, thr=5, mad0=None):
    """K9's arguments as motion.inter_search gives them: K3's windows of
    one reference (views at offsets into one buffer) of a smooth ring in
    [lo, hi], the source a quarter-pel shift of its slot 1 by (3, -2)
    plus noise, clipped to 0..255; the windows around K2's choice (kind
    "search"), or around random vectors with random best SAD/MAD and a
    fifth of the MBs frozen ("random"; "frozen": all of them; "flat": a
    constant ring and source, so that every candidate ties in the copy
    branch). mad0: the best MAD of every MB for the random kinds."""
    n = (h // 16) * (w // 16)
    shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    if kind == "flat":
        ring = [np.full((RING,) + s, 128) for s in shapes]
        src = [np.full(s, 128) for s in shapes]
    else:
        ring = [_smooth_planes(rng, (RING,) + s, lo, hi) for s in shapes]
        src = []
        for i, r in enumerate(ring):
            dx, dy = (3, -2) if i == 0 else (1, -1)
            a = np.roll(r[1], (-dy, -dx), (0, 1))
            b = np.roll(r[1], (-dy - 1, -dx - 1), (0, 1))
            src.append(np.clip((3 * a + b + 2) // 4
                               + rng.integers(-2, 3, a.shape), 0, 255))
    ring = [_t(r, torch.int16).to(dev) for r in ring]
    src = [_t(p.astype(np.int32)).to(dev) for p in src]
    slot = torch.tensor([1], dtype=torch.int32, device=dev)
    width = full_width if full_width is not None else w
    mad_thr = torch.tensor(thr, dtype=torch.int32, device=dev)
    if kind == "search":
        cmax = cuda_motion.chroma_max_maps(src[1], src[2], ring[1][1],
                                           ring[2][1])
        mx, my, sad, mad, frozen = cuda_motion.dense_select(
            src[0], ring[0][1], cmax, x0, width, h, mad_thr)
    else:
        def i32(lo_, hi_):
            return _t(rng.integers(lo_, hi_, n).astype(np.int32)).to(dev)
        mx, my = i32(-16, 17), i32(-16, 17)
        sad, mad = i32(0, 20000), i32(0, 12)
        frozen = _t(rng.random(n) < (1.0 if kind == "frozen" else 0.2)
                    ).to(dev)
        if kind == "flat":      # the flat content's own full-pel metrics
            sad, mad = torch.zeros_like(sad), torch.zeros_like(mad)
        if mad0 is not None:
            mad = torch.full_like(mad, mad0)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    px, py = (idx % (w // 16)) * 16, (idx // (w // 16)) * 16
    wins = cuda_pred.gather_windows_yuv(ring, slot, mx, my)
    return (wins, tuple(src), mx, my, sad, mad, frozen, px, py, x0, width,
            h, mad_thr)


def _check_subpel(args):
    """K9 against its plain version on the same card tensors, exact; the
    inputs unchanged and one launch counted. Returns the kernel's dict."""
    tensors = [t for a in args for t in (a if isinstance(a, tuple) else (a,))
               if torch.is_tensor(t)]
    before = [t.clone() for t in tensors]
    launches = cuda_motion.LAUNCHES["subpel_scan"]
    got = cuda_motion.subpel_scan(*args)
    assert cuda_motion.LAUNCHES["subpel_scan"] == launches + 1
    want = cuda_motion.subpel_scan_plain(*args)
    assert tuple(got) == SUBPEL_FIELDS
    for k in SUBPEL_FIELDS:
        assert got[k].dtype == want[k].dtype and got[k].is_cuda, k
        _eq(got[k], want[k])
    for t, b in zip(tensors, before):
        _eq(t, b)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(1088, 1920), (16, 16), (16, 112),
                                  (112, 16), (48, 80)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["search", "random"])
def test_subpel_scan_matches_plain(dev, size, kind):
    """At the 1080p grid, one MB, a 1 x 7 and a 7 x 1 grid and 15 MBs
    (neither a multiple of the kernel's 4 MBs a block), on windows read
    as views at offsets into K3's one buffer."""
    args = _subpel_args(dev, np.random.default_rng(size[0] + size[1]),
                        *size, kind=kind)
    wins = args[0]
    assert wins[1].storage_offset() > 0 and wins[2].storage_offset() > 0
    assert wins[0].untyped_storage().data_ptr() == \
        wins[2].untyped_storage().data_ptr()
    got = _check_subpel(args)
    if size == (1088, 1920):
        assert got["sp_pred"].any() and not got["sp_pred"].all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,lo,hi,thr", [
    ("random", -32768, 32768, 5), ("random", -32768, 32768, 1 << 20),
    ("search", -32768, 32768, 5), ("frozen", -300, 560, 5),
    ("flat", 0, 0, 5)])
def test_subpel_scan_edge_inputs(dev, kind, lo, hi, thr):
    """Windows over the whole int16 range (negatives: round_out and
    wrap16), at a MAD threshold so high that the copy branch takes every
    candidate of lower MAD, from a best MAD of 2^30, so that the outputs
    show the candidates' metrics; all MBs frozen (nothing taken), and
    flat content where every candidate ties in the copy branch (nothing
    taken either)."""
    args = _subpel_args(dev, np.random.default_rng(91), 96, 160, kind=kind,
                        lo=lo, hi=hi, thr=thr,
                        mad0=1 << 30 if thr > 5 else None)
    got = _check_subpel(args)
    if kind in ("frozen", "flat"):
        assert not got["sp_pred"].any()
    if thr > 5:   # most: some edge MBs have no candidate in the frame
        assert int(got["sp_pred"].sum()) > int((~args[6]).sum()) // 2


@pytest.mark.cuda
@pytest.mark.parametrize("x0,full_width", [(0, 640), (32, 160), (480, 1920)])
def test_subpel_scan_at_tile_origins(dev, x0, full_width):
    for kind in ("search", "random"):
        _check_subpel(_subpel_args(dev, np.random.default_rng(x0), 96, 160,
                                   kind=kind, x0=x0, full_width=full_width))


@pytest.mark.cuda
def test_subpel_scan_checks_its_arguments(dev):
    args = list(_subpel_args(dev, np.random.default_rng(3), 48, 80))
    bad = [
        (0, (args[0][0].to(torch.int16),) + args[0][1:]),
        (0, (args[0][0][:-1],) + args[0][1:]),
        (1, (args[1][0][:, :64],) + args[1][1:]),
        (2, args[2].to(torch.int64)),
        (6, args[6].to(torch.int32)),
        (3, args[3][:-1]),
        (7, args[7][:-1]),
    ]
    launches = cuda_motion.LAUNCHES["subpel_scan"]
    for i, value in bad:
        call = list(args)
        call[i] = value
        with pytest.raises(ValueError):
            cuda_motion.subpel_scan(*call)
    assert cuda_motion.LAUNCHES["subpel_scan"] == launches


# ---- K10 encode_tail, K11 decode_tail

TAIL_SIZES = [(1088, 1920), (16, 16), (16, 112), (112, 16), (1088, 480)]


def _one_buffer(planes, dtype, dev):
    """Y, U, V numpy planes as views into one card buffer, as K4 gives its
    prediction."""
    buf = torch.as_tensor(np.concatenate([p.reshape(-1) for p in planes])) \
        .to(dev, dtype)
    out, o = [], 0
    for p in planes:
        out.append(buf[o:o + p.size].view(p.shape))
        o += p.size
    return tuple(out)


def _tail_case(rng, h, w, kind):
    """(src, pred) numpy planes: "mixed", sources 0..271 over predictions
    of recon overshoot; "extreme", residuals at 32767, -32767, 32768
    (wrapping to -32768) and across the int16 range; "wrap", full-scale
    +-32767 residuals, whose transformed MBs' s * s and sum of squares
    wrap int32."""
    shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    src = [rng.integers(0, 272, s) for s in shapes]
    if kind == "mixed":
        pred = [rng.integers(-300, 560, s) for s in shapes]
    elif kind == "extreme":
        pred = [np.clip(np.choose(rng.integers(0, 4, s.shape), [
            s - 32767, s + 32767, s - 32768,
            rng.integers(-32768, 32768, s.shape)]), -32768, 32767)
            for s in src]
    else:
        pred = [s - np.where(rng.random(s.shape) < 0.5, -1, 1) * 32767
                for s in src]
    return src, pred


def _tail_flags(rng, n, dev):
    """is_intra, is_motion, is_copy: every combination the tail meets."""
    kinds = np.array([(1, 0, 0), (1, 1, 0), (0, 0, 0), (0, 1, 0), (0, 0, 1),
                      (0, 1, 1)])[rng.integers(0, 6, n)]
    return tuple(torch.as_tensor(kinds[:, i].astype(bool)).to(dev)
                 for i in range(3))


def _encode_tail_args(dev, rng, h, w, kind="mixed", quality=16,
                      adaptive=True):
    n = (h // 16) * (w // 16)
    src, pred = _tail_case(rng, h, w, kind)
    coef = [rng.integers(-32768, 32768, p.shape) for p in src]
    quality = torch.tensor(quality, dtype=torch.int32, device=dev)
    return (_one_buffer(src, torch.int32, dev),
            _one_buffer(pred, torch.int32, dev), *_tail_flags(rng, n, dev),
            quality, adaptive, _one_buffer(coef, torch.int16, dev))


def _decode_tail_args(dev, rng, h, w, kind="coded"):
    n = (h // 16) * (w // 16)
    shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    if kind == "coded":
        coef = [np.where(rng.random(s) < 0.3, rng.integers(-40, 41, s), 0)
                for s in shapes]
    else:
        coef = [rng.integers(-32768, 32768, s) for s in shapes]
    is_intra, is_motion, is_copy = _tail_flags(rng, n, dev)
    qp = torch.as_tensor(rng.integers(0, 32, n).astype(np.int32)).to(dev)
    qp = torch.where(is_copy, 0, qp)
    pred = [rng.integers(-300, 560, s) for s in shapes]
    stale = [rng.integers(-32768, 32768, s) for s in shapes]
    return (_one_buffer(coef, torch.int32, dev), qp, is_intra & ~is_motion,
            is_copy, _one_buffer(pred, torch.int32, dev),
            _one_buffer(stale, torch.int16, dev))


def _flat_tensors(args):
    return [t for a in args for t in (a if isinstance(a, tuple) else (a,))
            if torch.is_tensor(t)]


def _same_outputs(got, want):
    if want is None or torch.is_tensor(want):
        assert (got is None) == (want is None)
        if want is not None:
            assert got.dtype == want.dtype and got.is_cuda
            _eq(got, want)
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_outputs(g, w)


def _check_tail(name, args, **kw):
    """K10 or K11 against its plain version on the same card tensors,
    exact, twice; the inputs unchanged and one launch counted a call.
    Returns the kernel's outputs."""
    kern = getattr(cuda_tail, name)
    plain = getattr(cuda_tail, name + "_plain")
    tensors = _flat_tensors(args)
    before = [t.clone() for t in tensors]
    launches = cuda_tail.LAUNCHES[name]
    got = kern(*args, **kw)
    again = kern(*args, **kw)
    assert cuda_tail.LAUNCHES[name] == launches + 2
    want = plain(*args, **kw)
    _same_outputs(got, want)
    _same_outputs(again, want)
    for t, b in zip(tensors, before):
        _eq(t, b)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("size", TAIL_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_encode_tail_matches_plain(dev, size):
    """At the 1080p grid, one MB, a 1 x 7 and a 7 x 1 grid and a 480-wide
    tile, adaptive QP on and off."""
    rng = np.random.default_rng(size[0] * 7 + size[1])
    for adaptive in (True, False):
        _check_tail("encode_tail", _encode_tail_args(
            dev, rng, *size, adaptive=adaptive))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mixed", "extreme", "wrap"])
@pytest.mark.parametrize("quality", [1, 16, 31])
def test_encode_tail_edge_inputs(dev, kind, quality):
    """Residuals at the int16 edges and transformed MBs whose variance
    sums wrap int32, at q 1, 16 and 31, adaptive and not."""
    rng = np.random.default_rng(quality)
    for adaptive in (True, False):
        got = _check_tail("encode_tail", _encode_tail_args(
            dev, rng, 96, 160, kind, quality, adaptive))
        if not adaptive:
            assert (got[1] == quality).all()


@pytest.mark.cuda
@pytest.mark.parametrize("size", TAIL_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["coded", "int16_range"])
def test_decode_tail_matches_plain(dev, size, kind):
    """With and without the carry and the residual blocks, at the sizes
    of K10's test, on coefficients as a quantizer writes them and over
    the whole int16 range."""
    args = _decode_tail_args(dev, np.random.default_rng(size[1]), *size,
                             kind)
    for stale in (args[5], None):
        for residual in (True, False):
            _check_tail("decode_tail", args[:5], stale=stale,
                        residual=residual)


@pytest.mark.cuda
def test_decode_tail_residual_is_what_the_wave_decode_reads(dev):
    """K11's residual blocks equal the ones the wave decode gave K7
    before K11 (engine.carry_coef, coef_blocks and residual as torch ops
    on the card), and pass K7's checks."""
    coef, qp, intra_default, is_copy, pred, stale = _decode_tail_args(
        dev, np.random.default_rng(5), 1088, 1920)
    _, carried, res = cuda_tail.decode_tail(coef, qp, intra_default, is_copy,
                                            pred, stale, residual=True)
    old = engine.carry_coef(stale, is_copy, coef)
    want = engine.residual(*engine.coef_blocks(*old), qp, intra_default)
    for g, w, c, o in zip(res, want, carried, old):
        _eq(g, w.contiguous())
        _eq(c, o.to(torch.int16))
    n = qp.numel()
    for t, size in zip(res, (16, 8, 8)):
        _build.check(t, "res", torch.int32, (n, size, size))


@pytest.mark.cuda
def test_tail_wrappers_check_their_arguments(dev):
    rng = np.random.default_rng(8)
    enc = list(_encode_tail_args(dev, rng, 48, 80))
    dec = list(_decode_tail_args(dev, rng, 48, 80))
    src, pred, coef = enc[0], enc[1], enc[7]
    bad_enc = [
        (0, (src[0].to(torch.int16),) + src[1:]),
        (0, (src[0][:-16],) + src[1:]),
        (1, (pred[0].t().contiguous().t(),) + pred[1:]),
        (1, (pred[0][:, :64],) + pred[1:]),
        (2, enc[2].to(torch.int32)),
        (4, enc[4][:-1]),
        (7, (coef[0].to(torch.int32),) + coef[1:]),
        (7, (coef[0].cpu(),) + coef[1:]),
    ]
    bad_dec = [
        (0, (dec[0][0].to(torch.int16),) + dec[0][1:]),
        (1, dec[1].to(torch.int64)),
        (1, dec[1][:-1]),
        (2, dec[2].to(torch.int32)),
        (4, (dec[4][0][:, ::2].contiguous(),) + dec[4][1:]),
        (5, (dec[5][0].to(torch.int32),) + dec[5][1:]),
    ]
    launches = dict(cuda_tail.LAUNCHES)
    for i, value in bad_enc:
        call = list(enc)
        call[i] = value
        with pytest.raises(ValueError):
            cuda_tail.encode_tail(*call)
    for i, value in bad_dec:
        call = list(dec)
        call[i] = value
        with pytest.raises(ValueError):
            cuda_tail.decode_tail(*call[:5], stale=call[5])
    assert cuda_tail.LAUNCHES == launches


# ---- K9 with every reference and the classification merge
# (cuda_motion.subpel_classify)

CLASSIFY_KEYS = cuda_motion.CLASSIFY_FIELDS + ("block_type",)


def _classify_args(dev, rng, h, w, n_refs, *, kind="search", lo=-300,
                   hi=560, x0=0, full_width=None, halo=0, thr=5, mad0=None):
    """subpel_classify's arguments for references at offsets 1..n_refs - 1
    of frame 3 (ring slots 2, 1, 0): a smooth ring in [lo, hi] whose
    slots the source shows at other full- and quarter-pel shifts (so that
    the references' results differ and each merge rule decides
    something), with `halo` columns of margin; each reference's K1-K3 run
    on its slot (kind "search"), or random vectors, metrics and a fifth
    of the MBs frozen around which K3 gathers ("random"). mad0: every
    MB's best MAD for "random"."""
    n = (h // 16) * (w // 16)
    wide = w + 2 * halo
    shapes = ((h, wide), (h // 2, wide // 2), (h // 2, wide // 2))
    ring = [_smooth_planes(rng, (RING,) + s, lo, hi) for s in shapes]
    src = []
    for i, r in enumerate(ring):
        m = halo if i == 0 else halo // 2
        core = r[2][:, m:r.shape[2] - m]
        dx, dy = (3, -2) if i == 0 else (1, -1)
        a = np.roll(core, (-dy, -dx), (0, 1))
        b = np.roll(core, (-dy - 1, -dx - 1), (0, 1))
        src.append(np.clip((3 * a + b + 2) // 4
                           + rng.integers(-2, 3, a.shape), 0, 255))
    ring = [_t(r, torch.int16).to(dev) for r in ring]
    src = tuple(_t(p.astype(np.int32)).to(dev) for p in src)
    width = full_width if full_width is not None else w
    mad_thr = torch.tensor(thr, dtype=torch.int32, device=dev)
    refs = []
    for offset in range(1, n_refs):
        slot = torch.tensor([(3 + RING - offset) % RING], dtype=torch.int32,
                            device=dev)
        if kind == "search":
            refs.append(motion.full_pel(
                src, tuple(r[slot[0]] for r in ring), tuple(ring), slot,
                mad_thr, x0=x0, full_width=full_width, halo=halo))
            continue

        def i32(lo_, hi_):
            return _t(rng.integers(lo_, hi_, n).astype(np.int32)).to(dev)
        mx, my = i32(-16, 17), i32(-16, 17)
        sad = i32(0, 20000)
        mad = i32(0, 12) if mad0 is None else torch.full_like(sad, mad0)
        frozen = _t(rng.random(n) < 0.2).to(dev)
        wins = cuda_pred.gather_windows_yuv(tuple(ring), slot, mx, my, halo)
        refs.append((wins, mx, my, sad, mad, frozen))
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    px, py = (idx % (w // 16)) * 16, (idx // (w // 16)) * 16
    return refs, src, px, py, x0, width, h, mad_thr


def _check_classify(args):
    """The merged K9 against its plain version on the same card tensors,
    exact; the inputs unchanged and one launch counted. Returns the
    kernel's dict."""
    tensors = [t for ref in args[0] for a in ref
               for t in (a if isinstance(a, tuple) else (a,))]
    tensors += [t for a in args[1:] for t in (a if isinstance(a, tuple)
                                             else (a,))
                if torch.is_tensor(t)]
    before = [t.clone() for t in tensors]
    launches = cuda_motion.LAUNCHES["subpel_scan"]
    got = cuda_motion.subpel_classify(*args)
    assert cuda_motion.LAUNCHES["subpel_scan"] == launches + 1
    want = cuda_motion.subpel_classify_plain(*args)
    assert tuple(got) == CLASSIFY_KEYS and tuple(want) == CLASSIFY_KEYS
    for k in CLASSIFY_KEYS:
        assert got[k].dtype == want[k].dtype and got[k].is_cuda, k
        _eq(got[k], want[k])
    for t, b in zip(tensors, before):
        _eq(t, b)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(1088, 1920), (16, 16), (16, 112),
                                  (112, 16), (48, 80)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("n_refs", [2, 3, 4])
@pytest.mark.parametrize("kind", ["search", "random"])
def test_subpel_classify_matches_plain(dev, size, n_refs, kind):
    """Every reference count the fast encoder takes, at the 1080p grid and
    at grids that are not whole blocks of the kernel's 4 MBs; on the
    1080p search more than one reference wins somewhere and some MBs take
    a sub-pel candidate."""
    args = _classify_args(dev, np.random.default_rng(size[1] + n_refs),
                          *size, n_refs, kind=kind)
    got = _check_classify(args)
    if size == (1088, 1920) and kind == "search" and n_refs > 2:
        assert len(np.unique(got["target"].cpu().numpy())) >= 2
        assert got["sp_pred"].any()


@pytest.mark.cuda
@pytest.mark.parametrize("x0,full_width,halo", [(0, 640, 32), (32, 160, 32),
                                                (480, 1920, 64)])
def test_subpel_classify_at_tile_origins(dev, x0, full_width, halo):
    for kind in ("search", "random"):
        _check_classify(_classify_args(
            dev, np.random.default_rng(x0 + halo), 96, 160, 4, kind=kind,
            x0=x0, full_width=full_width, halo=halo))


@pytest.mark.cuda
@pytest.mark.parametrize("thr,mad0", [(5, None), (1 << 20, 1 << 30)])
def test_subpel_classify_int16_windows(dev, thr, mad0):
    """Windows over the whole int16 range, and a MAD threshold under which
    every searched reference is a copy, so that the merge picks by SAD
    alone."""
    for kind in ("search", "random"):
        got = _check_classify(_classify_args(
            dev, np.random.default_rng(thr), 96, 160, 4, kind=kind,
            lo=-32768, hi=32767, thr=thr, mad0=mad0))
        if thr > 5 and kind == "search":
            assert got["is_copy"].all()


@pytest.mark.cuda
def test_subpel_classify_no_reference_is_intra(dev):
    args = _classify_args(dev, np.random.default_rng(1), 48, 80, 1)
    got = _check_classify(args)
    assert got["is_intra"].all() and not got["target"].any()


@pytest.mark.cuda
def test_subpel_classify_checks_its_arguments(dev):
    args = list(_classify_args(dev, np.random.default_rng(4), 48, 80, 4))
    refs = args[0]
    wins, mx, my, sad, mad, frozen = refs[1]
    bad = [
        (0, refs + refs[:1]),
        (0, [refs[0], ((wins[0].to(torch.int16),) + wins[1:], mx, my, sad,
                       mad, frozen)]),
        (0, [refs[0], (wins, mx[:-1], my, sad, mad, frozen)]),
        (0, [refs[0], (wins, mx, my, sad.to(torch.int64), mad, frozen)]),
        (0, [refs[0], (wins, mx, my, sad, mad, frozen.to(torch.int32))]),
        (0, [(wins, mx, my, sad, mad, frozen.cpu())]),
        (1, (args[1][0][:, :64],) + args[1][1:]),
        (2, args[2][:-1]),
    ]
    launches = cuda_motion.LAUNCHES["subpel_scan"]
    for i, value in bad:
        call = list(args)
        call[i] = value
        with pytest.raises(ValueError):
            cuda_motion.subpel_classify(*call)
    assert cuda_motion.LAUNCHES["subpel_scan"] == launches


@pytest.mark.cuda
@pytest.mark.parametrize("n_tiles", [1, 2])
def test_k9_launches_once_per_inter_frame(dev, n_tiles):
    """The fast encoder launches K9 once per inter frame (per tile on the
    tiled path), for all its references, and its chunks equal the CPU's."""
    frames = synth_frames(128, 64, 3)
    if n_tiles == 1:
        card, cpu = api.GpuEncoder(), api.GpuEncoder(device="cpu")
    else:
        card = tiled.TiledEncoder(n_tiles=2, devices=["cuda:0"] * 2)
        cpu = tiled.TiledEncoder(n_tiles=2, devices=["cpu"] * 2)
    for i, f in enumerate(frames):
        before = cuda_motion.LAUNCHES["subpel_scan"]
        chunk = card.encode(f)
        torch.cuda.synchronize()
        assert cuda_motion.LAUNCHES["subpel_scan"] - before == \
            (n_tiles if i else 0)
        assert chunk == cpu.encode(f)


# ---- K10 redesigned: the quantizer's divisions at their edges

@pytest.mark.cuda
@pytest.mark.parametrize("quality", list(range(32)))
def test_encode_tail_every_quality(dev, quality):
    """Every quality, adaptive (qp 1..31 from the variance) and, from 1,
    not (qp the quality), on residuals at the int16 edges and on mixed
    ones, over MBs of every kind (intra, intra motion, inter, motion,
    copy)."""
    rng = np.random.default_rng(100 + quality)
    for kind in ("mixed", "extreme"):
        for adaptive in (True, False) if quality else (True,):
            _check_tail("encode_tail", _encode_tail_args(
                dev, rng, 48, 80, kind, quality, adaptive))


@pytest.mark.cuda
@pytest.mark.parametrize("quality", [1, 128, 255])
def test_encode_tail_qp_extremes(dev, quality):
    """qp at the ends of the reciprocal tables (adaptive QP off), where
    the dequantizer's products are largest."""
    rng = np.random.default_rng(quality)
    for kind in ("extreme", "wrap"):
        got = _check_tail("encode_tail", _encode_tail_args(
            dev, rng, 96, 160, kind, quality, False))
        assert (got[1] == quality).all()


@pytest.mark.cuda
def test_encode_tail_unaligned_planes(dev):
    """Planes that do not start on 16 bytes (views at an odd offset) give
    the aligned planes' outputs."""
    rng = np.random.default_rng(12)
    args = list(_encode_tail_args(dev, rng, 48, 80))

    def shifted(planes):
        out = []
        for p in planes:
            buf = torch.empty(p.numel() + 1, dtype=p.dtype, device=dev)
            v = buf[1:].view(p.shape)
            v.copy_(p)
            assert v.data_ptr() % 16
            out.append(v)
        return tuple(out)

    want = cuda_tail.encode_tail(*args)
    for i in (0, 1, 7):
        call = list(args)
        call[i] = shifted(args[i])
        _same_outputs(cuda_tail.encode_tail(*call), want)


# ---- K11 after its redesign: 48 threads an MB, rows in registers, the
# copy MBs' work skipped where no residual is asked

def _k11_args(dev, rng, h, w, copy_share, qp_value):
    """decode_tail's arguments over the whole int16 range (every 8x8
    block's corners at -32768 and 32767), a `copy_share` of the MBs copy
    (a random set of that size), the others intra-default or inter at
    random, every MB at qp_value; the stale planes last."""
    n = (h // 16) * (w // 16)
    shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    coef = [rng.integers(-32768, 32768, s) for s in shapes]
    stale = [rng.integers(-32768, 32768, s) for s in shapes]
    for planes in (coef, stale):
        for p in planes:
            p[::8, ::8], p[7::8, 7::8] = -32768, 32767
    is_copy = np.zeros(n, bool)
    is_copy[rng.permutation(n)[:int(round(n * copy_share))]] = True
    intra_default = ~is_copy & (rng.random(n) < 0.5)
    pred = [rng.integers(-300, 560, s) for s in shapes]
    return (_one_buffer(coef, torch.int32, dev),
            torch.full((n,), qp_value, dtype=torch.int32, device=dev),
            torch.as_tensor(intra_default).to(dev),
            torch.as_tensor(is_copy).to(dev),
            _one_buffer(pred, torch.int32, dev),
            _one_buffer(stale, torch.int16, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("qp", [0, 31])
@pytest.mark.parametrize("copy_share", [0.0, 0.5, 1.0],
                         ids=["copy0", "copy50", "copy100"])
@pytest.mark.parametrize("size", TAIL_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_tail_copy_shares(dev, size, copy_share, qp):
    """At the 1080p grid and TAIL_SIZES' odd grids, with no, half and
    every MB a copy, at qp 0 and 31, with each combination of the carry
    and the residual blocks: exact, twice, inputs unchanged, one launch a
    call."""
    rng = np.random.default_rng(size[0] + size[1] + int(copy_share * 10)
                                + qp)
    args = _k11_args(dev, rng, *size, copy_share, qp)
    for stale in (args[5], None):
        for residual in (True, False):
            rec, carried, res = _check_tail("decode_tail", args[:5],
                                            stale=stale, residual=residual)
            if copy_share == 1.0:   # every MB takes its prediction
                for r, p in zip(rec, args[4]):
                    _eq(r, p)
            if stale is not None and copy_share == 1.0:
                for c, s in zip(carried, stale):
                    _eq(c, s)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["coef", "pred", "stale"])
def test_decode_tail_unaligned_planes(dev, which):
    """Plane views that do not start on 16 bytes (the wrapper copies them)
    give the aligned planes' outputs, with the carry and the residual
    blocks, and leave the views as they were."""
    rng = np.random.default_rng(13)
    args = list(_k11_args(dev, rng, 48, 80, 0.5, 31))
    i = {"coef": 0, "pred": 4, "stale": 5}[which]
    shifted = []
    for p in args[i]:
        buf = torch.empty(p.numel() + 1, dtype=p.dtype, device=dev)
        v = buf[1:].view(p.shape)
        v.copy_(p)
        assert v.data_ptr() % 16
        shifted.append(v)
    want = cuda_tail.decode_tail(*args[:5], stale=args[5], residual=True)
    call = list(args)
    call[i] = tuple(shifted)
    _check_tail("decode_tail", call[:5], stale=call[5], residual=True)
    _same_outputs(cuda_tail.decode_tail(*call[:5], stale=call[5],
                                        residual=True), want)


# ------------------------------------------------- K12 unpack_yuv5d

UP_AW, UP_AH, UP_W, UP_H = 640, 512, 630, 500


def _check_unpack(dev, wire_np, ah, aw, fw, fh, plain_np=None):
    """K12 on the card in both layouts against the plain version over
    `plain_np` (the same wire by default), twice: two launches a call of
    the pair, outputs exact, contiguous int32, and the same on both
    runs."""
    buf = _t(wire_np[8:]).to(dev)
    ref = _t((wire_np if plain_np is None else plain_np)[8:]).to(dev)
    want_p = wire.unpack_yuv5d_plain(ref, ah, aw, fw, fh)
    want_b = wire.unpack_yuv5d_blocks_plain(ref, ah, aw, fw, fh)
    runs = []
    for _ in range(2):
        before = wire.LAUNCHES["unpack_yuv5d"]
        planes = wire.unpack_yuv5d(buf, ah, aw, fw, fh)
        blocks, sad = wire.unpack_yuv5d_blocks(buf, ah, aw, fw, fh)
        torch.cuda.synchronize()
        assert wire.LAUNCHES["unpack_yuv5d"] - before == 2
        runs.append((*planes, *blocks, sad))
    for got in runs:
        for g, w in zip(got, (*want_p, *want_b[0], want_b[1])):
            assert g.dtype == torch.int32 and g.is_contiguous()
            assert g.shape == w.shape
            _eq(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("content", ["synth", "edges", "noise"])
def test_unpack_yuv5d_matches_plain(dev, content):
    """The contents of test_torch_wire.py's uplink test; noise packs past
    UP_EXC_K exceptions, a zeroed section: 8192 entries at position 0."""
    frame = content_frame(content, UP_W, UP_H)
    _check_unpack(dev, yuv5d_wire(frame, UP_AW, UP_AH), UP_AH, UP_AW, UP_W,
                  UP_H)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["negative", "out_of_range", "duplicates",
                                  "column0", "crowded_rows", "full"])
def test_unpack_yuv5d_exception_positions(dev, case):
    """Negative, dropped and repeated exception positions: K12 on the raw
    wire against the plain version on the wire without the entries a
    later one overrides (the later entry wins, as in JAX's scatter)."""
    base = yuv5d_wire(content_frame("synth", UP_W, UP_H), UP_AW, UP_AH)
    raw = rewritten(base, UP_AW, UP_AH, case, seed=CASES.index(case))
    _check_unpack(dev, raw, UP_AH, UP_AW, UP_W, UP_H,
                  last_entries_only(raw, UP_AW, UP_AH))


@pytest.mark.cuda
@pytest.mark.parametrize("fh,fw", [(1080, 1920), (144, 176), (56, 72),
                                   (16, 16), (512, 16), (16, 640),
                                   (40, 2000)],
                         ids=lambda v: str(v))
def test_unpack_yuv5d_sizes(dev, fh, fw):
    """synth content at 1080p, at widths that are not whole 32-field
    groups or 128-column steps, one MB, one MB column, one MB row."""
    ah, aw = -(-fh // 16) * 16, -(-fw // 16) * 16
    frame = synth_frames(fw, fh, 2, seed=fh + fw)[1]
    _check_unpack(dev, yuv5d_wire(frame, aw, ah), ah, aw, fw, fh)


@pytest.mark.cuda
def test_unpack_yuv5d_checks_its_arguments(dev):
    """A wire of the wrong length or dims K12 does not take raise; a wire
    that does not start on 4 bytes is copied and unpacks the same; a CPU
    wire takes the plain version and launches nothing."""
    w = yuv5d_wire(content_frame("edges", UP_W, UP_H), UP_AW, UP_AH)
    buf = _t(w[8:]).to(dev)
    with pytest.raises(ValueError, match="expected shape"):
        wire.unpack_yuv5d(buf[:-20], UP_AH, UP_AW, UP_W, UP_H)
    with pytest.raises(ValueError, match="multiples of 16"):
        wire.unpack_yuv5d_blocks(buf, UP_AH - 8, UP_AW, UP_W, UP_H)
    with pytest.raises(ValueError, match="at most"):
        wire.unpack_yuv5d(torch.zeros(wire.yuv5d_nbytes(16, 16400),
                                      dtype=torch.uint8, device=dev),
                          16, 16400, 16400, 16)
    shifted = torch.empty(buf.numel() + 2, dtype=torch.uint8, device=dev)
    shifted[2:].copy_(buf)
    assert shifted[2:].data_ptr() % 4
    for g, r in zip(wire.unpack_yuv5d(shifted[2:], UP_AH, UP_AW, UP_W, UP_H),
                    wire.unpack_yuv5d(buf, UP_AH, UP_AW, UP_W, UP_H)):
        _eq(g, r)
    before = wire.LAUNCHES["unpack_yuv5d"]
    wire.unpack_yuv5d(buf.cpu(), UP_AH, UP_AW, UP_W, UP_H)
    assert wire.LAUNCHES["unpack_yuv5d"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["conformance", "fast"])
def test_k12_launches_once_a_frame_and_keeps_the_bytes(dev, path):
    """At 352x288 the frames upload the 5-bit wire: each encoded frame on
    the card launches K12 once (the conformance inter step included), and
    the chunks are the CPU encoder's, whose plain unpack is the torch
    sequence K12 replaces."""
    from cairo_tpu_torch import native

    frames = synth_frames(352, 288, 4, seed=5)
    assert all(native.rgb_to_yuv5d(f, 352, 288)[0] == "yuv5d"
               for f in frames)
    cls = api.ConformanceGpuEncoder if path == "conformance" \
        else api.GpuEncoder
    cpu, card = cls(device="cpu"), cls(device=dev)
    for i, f in enumerate(frames):
        before = wire.LAUNCHES["unpack_yuv5d"]
        chunk = card.encode(f)
        assert wire.LAUNCHES["unpack_yuv5d"] - before == 1, f"frame {i}"
        assert chunk == cpu.encode(f), f"frame {i}"
