"""The port's tiled path (gpu/shard.py, gpu/tiled.py) against cairo_tpu's
(tpu/shard.py, tpu/tiled.py) on the CPU, every case exact.

The port runs its tiles on devices=["cpu"] * k with the kernels' plain
versions; the JAX package runs on the 8-device virtual CPU mesh of
tests/conftest.py, as tests/test_tiled.py runs it. Held here:
ops.rgb_to_yuv420; the plain K1 and K2 with a reference margin against
the XLA anchors on hmargin-cut planes, and K3 and K4 with a ring halo
against extract.mb_windows(prepad_x=32) and pred_block_from_windows;
motion.inter_search with a halo and a tile origin; TiledEncoder's chunks
and per-tile state (rings with their halo columns, coefficient planes)
after every frame at 2 tiles, 1 tile (whose slices are GpuEncoder's), a
sprite crossing the tile edge, 2 GOPs x 2 tiles, a frame size that is no
multiple of 16, and set_quality / insert_intra mid-stream; TiledDecoder's
RGB against cairo_tpu's and recon_rgb(), its hostile-input cases, and
tile_state_from_numpy carrying a JAX encoder's state over mid-stream.
Each configuration encodes once, in a module-scoped fixture.
"""

import pathlib
import re
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cairo_tpu.tpu import extract as jextract, motion as jmotion, ops as jops
from cairo_tpu.tpu import tiled as jtiled
from cairo_tpu_torch.blocktypes import MOTION_BIT
from cairo_tpu_torch.gpu import api, cuda_motion, cuda_pred
from cairo_tpu_torch.gpu import motion as tmotion, ops as tops
from cairo_tpu_torch.gpu import shard, tiled as ptiled
from test_tiled import moving_frames

RING = 4
HALO = shard.HALO


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _eq(got, want, msg=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def _cpus(k):
    return ["cpu"] * k


# ------------------------------------------------------------- the pieces

def test_rgb_to_yuv420_matches_jax():
    rgb = np.random.default_rng(5).integers(0, 256, (48, 80, 3), np.uint8)
    rgb[0, :4] = [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 0, 255]]
    got = tops.rgb_to_yuv420(_t(rgb))
    want = jops.rgb_to_yuv420(jnp.asarray(rgb))
    for g, w, name in zip(got, want, "yuv"):
        assert g.dtype == torch.int32
        _eq(g, w, name)


def _wide(rng, h, w, margin, lo=0, hi=256):
    """An (h, w + 2 margin) int16 reference whose margin holds values."""
    return rng.integers(lo, hi, (h, w + 2 * margin)).astype(np.int16)


def _cut(plane, margin, reach):
    """The JAX package's hmargin: the margin cut to `reach` columns."""
    return plane[:, margin - reach:plane.shape[1] - (margin - reach)]


@pytest.mark.parametrize("seed", [1, 4])
def test_chroma_max_maps_margin_matches_anchor(seed):
    rng = np.random.default_rng(seed)
    h, w, m = 32, 32, HALO // 2
    su, sv = (rng.integers(0, 256, (h, w)).astype(np.int32) for _ in "uv")
    ru, rv = _wide(rng, h, w, m), _wide(rng, h, w, m)
    got = cuda_motion.chroma_max_maps_plain(_t(su), _t(sv), _t(ru), _t(rv),
                                            m)
    want = jmotion._chroma_max_maps(
        jnp.asarray(su), jnp.asarray(sv), jnp.asarray(_cut(ru, m, 8)),
        jnp.asarray(_cut(rv, m, 8)), 8)
    _eq(got.reshape(h // 8, w // 8, 17, 17).permute(2, 0, 1, 3), want)


@pytest.mark.parametrize("x0,full", [(0, 192), (64, 192), (128, 192)])
def test_dense_select_margin_matches_anchor(x0, full):
    """A 64x64 tile at origin x0 of a 192-wide frame, its reference with
    the 32-column halo: the source is the reference shifted by (7, -3),
    so the best vectors reach into the halo."""
    rng = np.random.default_rng(x0 + 3)
    h, w, m, thr = 64, 64, HALO, 5
    ref = _wide(rng, h, w, m)
    sy = (np.roll(ref, (3, -7), (0, 1))[:, m:m + w]
          + rng.integers(-1, 2, (h, w))).astype(np.int32)
    su, sv = (rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
              for _ in "uv")
    ru, rv = _wide(rng, h // 2, w // 2, m // 2), \
        _wide(rng, h // 2, w // 2, m // 2)
    cmax = cuda_motion.chroma_max_maps_plain(_t(su), _t(sv), _t(ru), _t(rv),
                                             m // 2)
    got = cuda_motion.dense_select_plain(
        _t(sy), _t(ref), cmax, x0, full, h,
        torch.tensor(thr, dtype=torch.int32), m)
    hb, wb = h // 16, w // 16
    idx = np.arange(hb * wb)
    want = jmotion._dense_select(
        jnp.asarray(sy), jnp.asarray(_cut(ref, m, 16)),
        jnp.asarray(cmax.reshape(hb, wb, 17, 17).permute(2, 0, 1, 3)
                    .numpy()),
        jnp.asarray((idx % wb) * 16, jnp.int32),
        jnp.asarray((idx // wb) * 16, jnp.int32), x0, full, h,
        jnp.int32(thr), hb, wb)
    for name, g, wnt in zip(("mx", "my", "sad", "mad", "frozen"), got, want):
        _eq(g, wnt, name)
    assert bool((got[0] != 0).any())


def _halo_ring(rng, h, w):
    return [rng.integers(-1200, 1200, (RING, h, w + 2 * HALO))
            .astype(np.int16),
            rng.integers(-900, 900, (RING, h // 2, w // 2 + HALO))
            .astype(np.int16),
            rng.integers(-900, 900, (RING, h // 2, w // 2 + HALO))
            .astype(np.int16)]


@pytest.mark.parametrize("slot", [0, 3])
def test_gather_windows_halo_matches_anchor(slot):
    """K3's plain version with a ring halo: the windows of JAX's tiled
    path (pred_windows(halo=32), then inter_search's extract_blocks)."""
    rng = np.random.default_rng(slot + 9)
    h, w = 48, 64
    ring = _halo_ring(rng, h, w)
    n = (h // 16) * (w // 16)
    mx = rng.integers(-20, 21, n).astype(np.int32)   # clamped reach too
    my = rng.integers(-20, 21, n).astype(np.int32)
    got = cuda_pred.gather_windows_yuv_plain(
        tuple(_t(r) for r in ring), torch.tensor(slot, dtype=torch.int32),
        _t(mx), _t(my), HALO)
    wy, wu, wv = jmotion.pred_windows(
        tuple(jnp.asarray(r[slot], jnp.int32) for r in ring), halo=HALO)
    jx, jy = jnp.asarray(mx), jnp.asarray(my)
    want = (jextract.extract_blocks(wy, jx + 16, jy + 16, 18),
            jextract.extract_blocks(wu, (jx >> 1) + 8, (jy >> 1) + 8, 10),
            jextract.extract_blocks(wv, (jx >> 1) + 8, (jy >> 1) + 8, 10))
    for g, wnt, name in zip(got, want, "yuv"):
        _eq(g, wnt, name)


@pytest.mark.parametrize("reach", [16, 40])
def test_pred_planes_halo_matches_anchor(reach):
    """K4's plain version with a ring halo against JAX's tiled
    prediction: pred_block_from_windows on pred_windows(halo=32) of each
    MB's slot, zero where `zero`."""
    rng = np.random.default_rng(reach)
    h, w = 48, 64
    ring = _halo_ring(rng, h, w)
    n = (h // 16) * (w // 16)
    slot = rng.integers(0, 4, n).astype(np.int32)
    mx = rng.integers(-reach, reach + 1, n).astype(np.int32)
    my = rng.integers(-reach, reach + 1, n).astype(np.int32)
    spp, spa = rng.random(n) < 0.5, rng.random(n) < 0.5
    spi = rng.integers(0, 8, n).astype(np.int32)
    zero = rng.random(n) < 0.2
    got = cuda_pred.pred_planes_plain(
        *(_t(r) for r in ring), _t(slot), _t(mx), _t(my), _t(spp), _t(spa),
        _t(spi), _t(zero), halo=HALO)
    preds = None
    for s in range(RING):
        wins = jmotion.pred_windows(
            tuple(jnp.asarray(r[s], jnp.int32) for r in ring), halo=HALO)
        blocks = jmotion.pred_block_from_windows(
            wins, jnp.asarray(mx), jnp.asarray(my), jnp.asarray(spp),
            jnp.asarray(spa), jnp.asarray(spi))
        pick = jnp.asarray(slot == s)[:, None, None]
        preds = tuple(jnp.where(pick, b, 0 if preds is None else p)
                      for b, p in zip(blocks, preds or blocks))
    zm = jnp.asarray(zero)[:, None, None]
    for g, p, (ph, pw) in zip(got, preds, ((h, w), (h // 2, w // 2),
                                           (h // 2, w // 2))):
        _eq(g, jops.blocks_to_plane(jnp.where(zm, 0, p), ph, pw))


@pytest.mark.parametrize("x0", [0, 64, 128])
def test_inter_search_halo_matches_jax(x0):
    """gpu/motion.inter_search(halo=32) against tpu/motion.inter_search
    (halo=32, wins=pred_windows(ref, halo=32)): a 64x48 tile at x0 of a
    192-wide frame whose content moved by (5, -2) from the reference,
    halo columns included."""
    rng = np.random.default_rng(x0 + 21)
    h, w, quality = 48, 64, 12
    ring = [r.clip(0, 255) for r in _halo_ring(rng, h, w)]
    slot = 2
    ref = [r[slot] for r in ring]
    src_planes = [
        (np.roll(ref[0], (2, -5), (0, 1))[:, HALO:HALO + w]
         + rng.integers(-2, 3, (h, w))).astype(np.int32),
        np.roll(ref[1], (1, -2), (0, 1))[:, 16:16 + w // 2].astype(np.int32),
        np.roll(ref[2], (1, -2), (0, 1))[:, 16:16 + w // 2].astype(np.int32)]
    src = [tops.plane_to_blocks(_t(p), s) for p, s in
           zip(src_planes, (16, 8, 8))]
    n = (h // 16) * (w // 16)
    idx = np.arange(n)
    px = ((idx % (w // 16)) * 16).astype(np.int32)
    py = ((idx // (w // 16)) * 16).astype(np.int32)
    got = tmotion.inter_search(
        src, tuple(_t(p) for p in src_planes), tuple(_t(r) for r in ref),
        tuple(_t(r) for r in ring), torch.tensor([slot], dtype=torch.int32),
        _t(px), _t(py), torch.tensor(quality, dtype=torch.int32), x0=x0,
        full_width=192, halo=HALO)
    jref = tuple(jnp.asarray(r, jnp.int32) for r in ref)
    want = jmotion.inter_search(
        tuple(jnp.asarray(s.numpy()) for s in src),
        tuple(jnp.asarray(p) for p in src_planes), jref,
        jmotion.pred_windows(jref, halo=HALO), jnp.asarray(px),
        jnp.asarray(py), quality, x0=x0, full_width=192, halo=HALO)
    for k in want:
        _eq(got[k], want[k], k)
    assert bool(got["is_motion"].any())


def test_kernel_entries_match_the_ctypes_signatures():
    """Every literal ctypes signature a wrapper binds has one letter per
    parameter of its C entry, a pointer for each pointer and the stream
    (K1-K4 gained their margin and halo ints here)."""
    gpu = pathlib.Path(cuda_pred.__file__).parent
    entries = {}
    for cu in sorted((gpu / "csrc").glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       cu.read_text()):
            entries[name] = "".join("p" if "*" in q else "i"
                                    for q in params.split(","))
    bound = []
    for py in sorted(gpu.glob("cuda_*.py")):
        bound += re.findall(r'kernel_fn\("(\w+)", "([pi]+)"\)',
                            py.read_text())
    assert {"cairo_chroma_max_maps", "cairo_dense_select",
            "cairo_gather_windows_yuv", "cairo_pred_planes"} <= \
        {name for name, _ in bound}
    for name, sig in bound:
        assert entries[name] == sig, name


# ------------------------------------------------------- TiledEncoder runs

def _state_np(enc):
    return {key: {k: v.numpy().copy() for k, v in st.items()}
            for key, st in enc._state.items()}


def _encode_both(frames, n_tiles, quality, n_gops=1, controls=None):
    """Runs cairo_tpu's TiledEncoder and the port's over the same frames
    (one list per GOP); records chunks and state after every frame."""
    je = jtiled.TiledEncoder(n_tiles=n_tiles, n_gops=n_gops)
    pe = ptiled.TiledEncoder(n_tiles=n_tiles, n_gops=n_gops,
                             devices=_cpus(n_tiles * n_gops))
    run = dict(j=[], p=[], jstate=[], pstate=[], recon=[], pe=pe,
               n_tiles=n_tiles, n_gops=n_gops)
    for e in (je, pe):
        e.set_quality(quality)
    for i, batch in enumerate(zip(*frames)):
        for ctl in (controls or {}).get(i, ()):
            ctl(je)
            ctl(pe)
        run["j"].append(je.encode_batch(list(batch)))
        run["p"].append(pe.encode_batch(list(batch)))
        run["jstate"].append({k: np.asarray(v) for k, v in je._state.items()})
        run["pstate"].append(_state_np(pe))
        run["recon"].append([pe.recon_rgb(g) for g in range(n_gops)])
    return run


def _sprite_frames(shift=12):
    rng = np.random.default_rng(0)
    sprite = rng.integers(0, 255, (32, 32, 3), np.uint8)
    frames = []
    for t in range(2):
        f = np.full((64, 128, 3), 90, np.uint8)
        x0 = 40 + t * shift       # the sprite straddles the x=64 edge
        f[16:48, x0:x0 + 32] = sprite
        frames.append(f)
    return frames


@pytest.fixture(scope="module")
def two_tiles():
    return _encode_both([moving_frames(128, 64, 4)], 2, 12)


@pytest.fixture(scope="module")
def one_tile():
    return _encode_both([moving_frames(80, 64, 3)], 1, 16)


@pytest.fixture(scope="module")
def sprite():
    return _encode_both([_sprite_frames()], 2, 16)


@pytest.fixture(scope="module")
def gops():
    return _encode_both([moving_frames(64, 48, 3, seed=1),
                         moving_frames(64, 48, 3, seed=2, shift=7)], 2, 14,
                        n_gops=2)


@pytest.fixture(scope="module")
def odd_size():
    """120x56: aligned to 128x64 over 2 tiles; the pixels beyond the
    frame are zeroed after conversion in the last tile."""
    return _encode_both([[f[:56, :120] for f in moving_frames(128, 64, 3)]],
                        2, 12)


@pytest.fixture(scope="module")
def controls():
    return _encode_both(
        [moving_frames(128, 64, 5, seed=4)], 2, 12,
        controls={2: [lambda e: e.set_quality(20)],
                  3: [lambda e: e.insert_intra()]})


CONFIGS = ["two_tiles", "one_tile", "sprite", "gops", "odd_size", "controls"]


@pytest.mark.parametrize("config", CONFIGS)
def test_tiled_chunks_match_jax(request, config):
    run = request.getfixturevalue(config)
    for i, (j, p) in enumerate(zip(run["j"], run["p"])):
        assert p == j, f"frame {i}"


@pytest.mark.parametrize("config", CONFIGS)
def test_tiled_state_matches_jax(request, config):
    """Every tile's ring, halo columns included, and its coefficient
    planes equal JAX's after every frame."""
    run = request.getfixturevalue(config)
    for i, (js, ps) in enumerate(zip(run["jstate"], run["pstate"])):
        assert sorted(ps) == [(g, t) for g in range(run["n_gops"])
                              for t in range(run["n_tiles"])]
        for (g, t), st in ps.items():
            for k in shard.STATE_KEYS:
                _eq(st[k], js[k][g, t], f"frame {i} tile {(g, t)} {k}")


@pytest.mark.parametrize("config", ["two_tiles", "one_tile", "sprite",
                                    "odd_size", "controls"])
def test_tiled_decoder_matches_jax_and_recon(request, config):
    run = request.getfixturevalue(config)
    pd = ptiled.TiledDecoder(devices=_cpus(run["n_tiles"]))
    jd = jtiled.TiledDecoder()
    for i, chunks in enumerate(run["p"]):
        rgb = pd.decode(chunks[0])
        _eq(rgb, run["recon"][i][0], f"frame {i} against recon_rgb")
        _eq(rgb, jd.decode(chunks[0]), f"frame {i} against cairo_tpu")


def test_gops_decode_and_independence(gops):
    """Each GOP's stream decodes to its recon, and equals that GOP
    encoded alone."""
    for g in range(2):
        stream = [c[g] for c in gops["p"]]
        pd = ptiled.TiledDecoder(devices=_cpus(2))
        for i, c in enumerate(stream):
            _eq(pd.decode(c), gops["recon"][i][g], f"GOP {g} frame {i}")
        alone = ptiled.TiledEncoder(n_tiles=2, devices=_cpus(2))
        alone.set_quality(14)
        seq = moving_frames(64, 48, 3, seed=1) if g == 0 else \
            moving_frames(64, 48, 3, seed=2, shift=7)
        assert [alone.encode(f) for f in seq] == stream


def test_one_tile_slices_are_the_single_card_ones(one_tile):
    """A 1-tile stream carries exactly GpuEncoder's slices, and decodes
    to GpuDecoder's RGB (test_tiled.py:48-70)."""
    enc = api.GpuEncoder(device="cpu")
    enc.set_quality(16)
    dec_s = api.GpuDecoder(device="cpu")
    dec_t = ptiled.TiledDecoder(devices=_cpus(1))
    for i, (f, chunks) in enumerate(zip(moving_frames(80, 64, 3),
                                        one_tile["p"])):
        chunk_t, chunk_s = chunks[0], enc.encode(f)
        off_t = off_s = 0
        if i == 0:
            _, _, tiles, off_t = ptiled.parse_tiled_header(chunk_t)
            assert tiles == [80 // 16]
            off_s = 14
        assert chunk_t[off_t + 10 + 4:] == chunk_s[off_s + 10:]
        _eq(dec_t.decode(chunk_t), dec_s.decode(chunk_s), f"frame {i}")


def test_sprite_motion_reaches_into_the_neighbour(sprite):
    """The sprite moved +12 px across the tile edge: some MB of tile 1's
    first column takes a vector 12 px to the left, into tile 0's halo."""
    dec = ptiled.TiledDecoder(devices=_cpus(2))
    for c in sprite["p"]:
        dec.decode(c[0])
    bt = dec._bt[1]
    wb = dec.tile_w // 16
    col0 = np.arange(len(bt)) % wb == 0
    moved = (bt.block_type & MOTION_BIT).astype(bool) & (bt.motion_x == -12)
    assert np.any(moved & col0), (bt.motion_x[col0], bt.block_type[col0])


# ---------------------------------------------------------- hostile input

def test_tiled_decoder_rejects_corrupt_streams(two_tiles):
    """Bad magic raises; a bit-flipped chunk decodes or raises exactly as
    cairo_tpu's decoder does; the pristine stream still decodes."""
    chunks = [c[0] for c in two_tiles["p"]]
    with pytest.raises(ValueError):
        ptiled.TiledDecoder(devices=_cpus(2)).decode(b"EVXQ" + chunks[0][4:])
    for flip in (40, 80, len(chunks[0]) - 3):
        bad = bytearray(chunks[0])
        bad[flip] ^= 0x40
        outs = []
        for dec in (ptiled.TiledDecoder(devices=_cpus(2)),
                    jtiled.TiledDecoder()):
            try:
                outs.append(dec.decode(bytes(bad)))
            except ValueError:
                outs.append(None)
        assert (outs[0] is None) == (outs[1] is None), flip
        if outs[0] is not None:
            _eq(outs[0], outs[1], f"flip at {flip}")
    dec = ptiled.TiledDecoder(devices=_cpus(2))
    for i, c in enumerate(chunks):
        _eq(dec.decode(c), two_tiles["recon"][i][0], f"frame {i}")


def test_tiled_framing_bounds_and_width_uniformity(two_tiles):
    chunk = two_tiles["p"][0][0]
    with pytest.raises(ValueError):
        ptiled.pack_tiled_header(128, 64, [2, 6])
    _, _, tile_mbs, off = ptiled.parse_tiled_header(chunk)
    forged = bytearray(chunk)
    struct.pack_into("<H", forged, ptiled.HEADER_SIZE + 2, tile_mbs[0] + 1)
    with pytest.raises(ValueError):
        ptiled.TiledDecoder(devices=_cpus(2)).decode(bytes(forged))
    for evil in (0xFFFFFFFF, len(chunk) + 1, 0):
        bad = bytearray(chunk)
        struct.pack_into("<I", bad, off + ptiled.FRAME_DESC_SIZE, evil)
        with pytest.raises(ValueError):
            ptiled.TiledDecoder(devices=_cpus(2)).decode(bytes(bad))
    ptiled.TiledDecoder(devices=_cpus(2)).decode(chunk)


def test_tiled_decoder_state_in_sync_after_a_rejected_frame(two_tiles):
    """A frame whose second slice is cut short raises after the first
    slice parsed; nothing is committed, so the pristine frame decodes
    next and the stream goes on exactly."""
    chunks = [c[0] for c in two_tiles["p"]]
    dec = ptiled.TiledDecoder(devices=_cpus(2))
    _eq(dec.decode(chunks[0]), two_tiles["recon"][0][0])
    c1 = chunks[1]
    (n0,) = struct.unpack_from("<I", c1, ptiled.FRAME_DESC_SIZE)
    second = ptiled.FRAME_DESC_SIZE + 4 + n0
    bad = bytearray(c1)
    struct.pack_into("<I", bad, second, len(c1))
    for chunk in (bytes(bad), c1[:second + 2]):
        with pytest.raises(ValueError):
            dec.decode(chunk)
        assert dec.frame_index == 1
    for i, c in enumerate(chunks[1:], 1):
        _eq(dec.decode(c), two_tiles["recon"][i][0], f"frame {i}")
    with pytest.raises(ValueError):
        dec.decode(chunks[1])          # out of order


def test_encoder_errors():
    with pytest.raises(ValueError):
        ptiled.TiledEncoder(n_tiles=0)
    with pytest.raises(ValueError):
        ptiled.TiledEncoder(n_tiles=2, devices=_cpus(1)).encode(
            moving_frames(64, 32, 1)[0])
    enc = ptiled.TiledEncoder(n_tiles=1, n_gops=2, devices=_cpus(2))
    with pytest.raises(ValueError):
        enc.encode(moving_frames(64, 32, 1)[0])
    with pytest.raises(ValueError):
        enc.encode_batch(moving_frames(64, 32, 1))
    enc.encode_batch(moving_frames(64, 32, 2))
    with pytest.raises(ValueError):
        enc.encode_batch([f[:16] for f in moving_frames(64, 32, 2)])


# ------------------------------------------------------ state carried over

def test_tile_state_from_numpy_continues_a_jax_stream():
    """A JAX TiledEncoder's state after 2 frames, carried into the port:
    both go on for 2 frames with the same chunks."""
    frames = moving_frames(128, 64, 4, seed=8)
    je = jtiled.TiledEncoder(n_tiles=2)
    je.set_quality(12)
    for f in frames[:2]:
        je.encode(f)
    pe = ptiled.TiledEncoder(n_tiles=2, devices=_cpus(2))
    pe._init(128, 64)
    pe._state = shard.tile_state_from_numpy(
        {k: np.asarray(v) for k, v in je._state.items()}, pe._mesh)
    pe._stale = dict(je._stale)
    pe.frame_index, pe.frame_type, pe.quality = \
        je.frame_index, je.frame_type, je.quality
    for f in frames[2:]:
        assert pe.encode(f) == je.encode(f)
