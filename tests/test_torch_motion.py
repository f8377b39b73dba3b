"""The plain versions of kernels K1-K4 against their XLA anchors in
cairo_tpu, and gpu.motion.inter_search against tpu.motion.inter_search,
on the CPU with exact equality. Cases cover frame-edge MBs, a tile origin
x0 with full_width, frozen MBs, copy-grade shifts and ties. The kernels
themselves are held against the plain versions in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cairo_tpu.tpu import extract as jextract, motion as jmotion, ops as jops
from cairo_tpu_torch.gpu import cuda_motion, cuda_pred, motion as tmotion

RING = 4


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _eq(got, want, msg=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def _content(kind, h, w, seed):
    """(src_y, src_u, src_v, ref_y, ref_u, ref_v) int32 planes."""
    rng = np.random.default_rng(seed)
    ref = [rng.integers(0, 256, (h, w)), rng.integers(0, 256, (h // 2, w // 2)),
           rng.integers(0, 256, (h // 2, w // 2))]
    if kind == "random":
        src = [rng.integers(0, 256, p.shape) for p in ref]
    elif kind == "shift":       # copy-grade at luma (6, -4) + noise
        src = [np.roll(ref[0], (4, -6), (0, 1)) + rng.integers(-1, 2, (h, w)),
               np.roll(ref[1], (2, -3), (0, 1)), np.roll(ref[2], (2, -3), (0, 1))]
    elif kind == "frozen":      # co-located copy-grade nearly everywhere
        src = [p + rng.integers(-1, 2, p.shape) for p in ref]
    else:                       # "ties": flat source, checkerboard reference
        src = [np.full(p.shape, 128) for p in ref]
        ref = [(np.indices(p.shape).sum(0) % 2) * 40 + 100 for p in ref]
    return [np.asarray(p, np.int32) for p in src + ref]


KINDS = ["random", "shift", "frozen", "ties"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [1, 7, 12])
def test_chroma_max_maps_plain_matches_anchor(kind, seed):
    _, su, sv, _, ru, rv = _content(kind, 64, 80, seed)
    got = cuda_motion.chroma_max_maps_plain(
        _t(su), _t(sv), _t(ru, torch.int16), _t(rv, torch.int16))
    wide = ((0, 0), (8, 8))
    want = jmotion._chroma_max_maps(jnp.asarray(su), jnp.asarray(sv),
                                    jnp.asarray(np.pad(ru, wide)),
                                    jnp.asarray(np.pad(rv, wide)), 8)
    hb, wb = su.shape[0] // 8, su.shape[1] // 8
    _eq(got.reshape(hb, wb, 17, 17).permute(2, 0, 1, 3), want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("x0,full", [(0, None), (16, 128)])
@pytest.mark.parametrize("quality", [4, 16, 29])
def test_dense_select_plain_matches_anchor(kind, x0, full, quality):
    sy, su, sv, ry, ru, rv = _content(kind, 48, 80, 2)
    h, w = sy.shape
    width = full if full is not None else w
    thr = (quality >> 2) + 1
    cmax = cuda_motion.chroma_max_maps_plain(
        _t(su), _t(sv), _t(ru, torch.int16), _t(rv, torch.int16))
    got = cuda_motion.dense_select_plain(
        _t(sy), _t(ry, torch.int16), cmax, x0, width, h,
        torch.tensor(thr, dtype=torch.int32))
    jcmax = jnp.asarray(cmax.reshape(h // 16, w // 16, 17, 17)
                        .permute(2, 0, 1, 3).numpy())
    idx = np.arange((h // 16) * (w // 16))
    px = jnp.asarray((idx % (w // 16)) * 16, jnp.int32)
    py = jnp.asarray((idx // (w // 16)) * 16, jnp.int32)
    want = jmotion._dense_select(
        jnp.asarray(sy), jnp.asarray(np.pad(ry, ((0, 0), (16, 16)))), jcmax,
        px, py, x0, width, h, jnp.int32(thr), h // 16, w // 16)
    for name, g, wnt in zip(("mx", "my", "sad", "mad", "frozen"), got, want):
        _eq(g, wnt, name)


@pytest.mark.parametrize("block,pad", [(18, 17), (10, 9)])
def test_gather_windows_plain_matches_anchor(block, pad):
    rng = np.random.default_rng(3)
    mb = block - 2
    h, w = 3 * mb * 2, 5 * mb
    planes = rng.integers(-1200, 1200, (RING, h, w)).astype(np.int16)
    n = (h // mb) * (w // mb)
    mx = rng.integers(-20, 21, n).astype(np.int32)  # includes clamped reach
    my = rng.integers(-20, 21, n).astype(np.int32)
    for s in (0, 3):
        got = cuda_pred.gather_windows_plain(
            _t(planes), torch.tensor(s, dtype=torch.int32), _t(mx), _t(my),
            block, pad)
        want = jextract.extract_blocks(
            jextract.mb_windows(jnp.asarray(planes[s], jnp.int32), mb, pad),
            jnp.asarray(mx) + pad - 1, jnp.asarray(my) + pad - 1, block)
        _eq(got, want)


def _anchor_pred(ring, slot, mx, my, sp_pred, sp_amount, sp_index, zero):
    """The XLA anchor of K4: engine._gather_pred's XLA branch."""
    wins = []
    for stack, blk, pad in ((ring[0], 16, jmotion.Y_WPAD),
                            (ring[1], 8, jmotion.C_WPAD),
                            (ring[2], 8, jmotion.C_WPAD)):
        sel = None
        for s in range(RING):
            win = jextract.mb_windows(stack[s].astype(jnp.int32), blk, pad)
            sel = jnp.where((slot == s)[:, None, None], win,
                            0 if sel is None else sel)
        wins.append(sel)
    pred = jmotion.pred_block_from_windows(tuple(wins), mx, my, sp_pred,
                                           sp_amount, sp_index)
    return [jnp.where(zero[:, None, None], 0, p) for p in pred]


@pytest.mark.parametrize("reach", [16, 40])
def test_pred_planes_plain_matches_anchor(reach):
    """Motion within the search range, and beyond it where the window
    pads clamp the reach."""
    h, w = 64, 96
    rng = np.random.default_rng(11)
    n = (h // 16) * (w // 16)
    ring = [rng.integers(-1200, 1200, (RING, h, w)).astype(np.int16),
            rng.integers(-900, 900, (RING, h // 2, w // 2)).astype(np.int16),
            rng.integers(-900, 900, (RING, h // 2, w // 2)).astype(np.int16)]
    ring[0][0, 0, :6] = [-32768, 32767, -256, 255, 256, -257]
    slot = rng.integers(0, 4, n).astype(np.int32)
    mx = rng.integers(-reach, reach + 1, n).astype(np.int32)
    my = rng.integers(-reach, reach + 1, n).astype(np.int32)
    spp, spa = rng.random(n) < 0.5, rng.random(n) < 0.5
    spi = rng.integers(0, 8, n).astype(np.int32)
    zero = rng.random(n) < 0.25
    got = cuda_pred.pred_planes_plain(
        *map(_t, ring), *map(_t, (slot, mx, my, spp, spa, spi, zero)))
    want = _anchor_pred([jnp.asarray(r) for r in ring],
                        *map(jnp.asarray, (slot, mx, my, spp, spa, spi, zero)))
    for g, wnt, (hh, ww) in zip(got, want, ((h, w), (h // 2, w // 2),
                                            (h // 2, w // 2))):
        _eq(g, jops.blocks_to_plane(wnt, hh, ww))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("quality", [4, 16, 29])
def test_inter_search_matches(kind, quality):
    """Per-MB result fields of the whole fast-mode search, frame-edge MBs
    included (every MB of a 48x80 frame is within 16 px of an edge)."""
    sy, su, sv, ry, ru, rv = _content(kind, 48, 80, 4)
    _check_inter_search(sy, su, sv, ry, ru, rv, quality)


def test_inter_search_tile_origin():
    sy, su, sv, ry, ru, rv = _content("shift", 48, 80, 5)
    _check_inter_search(sy, su, sv, ry, ru, rv, 16, x0=32, full_width=160)


@pytest.mark.parametrize("slot", [0, 3])
def test_inter_search_gathers_windows_once(slot, monkeypatch):
    """motion.inter_search takes the sub-pel windows of Y, U and V from one
    gather_windows_yuv call (one K3 launch on the card) and no
    single-plane call, from the reference's ring slot while the other
    slots hold other content, and still equals tpu.motion.inter_search."""
    calls = []
    yuv = cuda_pred.gather_windows_yuv

    def counted(*args):
        calls.append(args)
        return yuv(*args)

    def single(*args):
        raise AssertionError("single-plane gather_windows called")

    monkeypatch.setattr(cuda_pred, "gather_windows_yuv", counted)
    monkeypatch.setattr(cuda_pred, "gather_windows", single)
    sy, su, sv, ry, ru, rv = _content("shift", 48, 80, 9)
    _check_inter_search(sy, su, sv, ry, ru, rv, 16, slot=slot,
                        others=np.random.default_rng(slot))
    assert len(calls) == 1


def _check_inter_search(sy, su, sv, ry, ru, rv, quality, x0=0,
                        full_width=None, slot=1, others=None):
    """`others`: a numpy Generator that fills the ring slots other than
    `slot` with random content (else they are zero)."""
    h, w = sy.shape
    n = (h // 16) * (w // 16)
    idx = np.arange(n)
    px = ((idx % (w // 16)) * 16).astype(np.int32)
    py = ((idx // (w // 16)) * 16).astype(np.int32)
    blocks = [jops.plane_to_blocks(jnp.asarray(p), b)
              for p, b in ((sy, 16), (su, 8), (sv, 8))]
    refs = [jnp.asarray(p) for p in (ry, ru, rv)]
    want = jmotion.inter_search(
        tuple(blocks), tuple(jnp.asarray(p) for p in (sy, su, sv)),
        tuple(refs), jmotion.pred_windows(tuple(refs)), jnp.asarray(px),
        jnp.asarray(py), quality, x0=x0, full_width=full_width)

    rings = []
    for p in (ry, ru, rv):
        stack = np.zeros((RING,) + p.shape, np.int16)
        if others is not None:
            stack[:] = others.integers(-300, 560, stack.shape)
        stack[slot] = p
        rings.append(_t(stack))
    got = tmotion.inter_search(
        tuple(_t(np.asarray(b)) for b in blocks),
        tuple(_t(p) for p in (sy, su, sv)),
        tuple(r[slot] for r in rings), tuple(rings),
        torch.tensor([slot], dtype=torch.int32), _t(px), _t(py),
        torch.tensor(quality, dtype=torch.int32), x0=x0,
        full_width=full_width)
    for key in want:
        _eq(got[key], want[key], key)
