"""The port's wavefront decode (cairo_tpu_torch.gpu.wavefront decode half,
cuda_wavedec's plain version of K7 and GpuDecoder's routing) against
cairo_tpu on the CPU, exactly:

  * decode_schedule / build_compact_schedule against the JAX ones;
  * the wave loop: members of a wave never read each other's blocks, so
    their order does not matter;
  * conformance_decode_step and conformance_decode_step_dense fed the
    same input wire and state as cairo_tpu.tpu.wavefront's: the same YUV
    wire, ring planes and coefficient planes;
  * GpuDecoder(device="cpu") against TpuDecoder(use_wavefront_decode=True)
    and cpuref.Evx1Decoder on reference-encoder and ConformanceGpuEncoder
    streams, a fast-mode stream continued by reference frames, a crafted
    below-left intra-motion read and a COO overflow, all on the device
    path; hostile vectors and use_wavefront_decode = False on the host
    path; a TpuDecoder checkpoint resumed in GpuDecoder; the lossy-wire
    refetch reads the ring views taken at dispatch.
Sizes 64x48, 96x64 and 88x56 (not a multiple of 16), q 2, 16 and 29.
"""

import pathlib
import re
import struct

import numpy as np
import pytest
import torch

from cairo_tpu import checkpoint as jcheckpoint
from cairo_tpu.cpuref.api import Evx1Decoder, Evx1Encoder
from cairo_tpu.tpu import engine as jengine, wavefront as jwf
from cairo_tpu.tpu.api import TpuDecoder
from cairo_tpu_torch import checkpoint as tcheckpoint, native
from cairo_tpu_torch.blocktypes import BlockTable, INTRA_BIT, MOTION_BIT
from cairo_tpu_torch.cpuref.stream import (FRAME_DESC_SIZE, HEADER_SIZE,
                                           _FRAME_FMT, pack_header,
                                           parse_header)
from cairo_tpu_torch.gpu import api, cuda_wavedec, wavefront as twf
from cairo_tpu_torch.gpu import wire as twire

from util_video import synth_frames

SIZES = [(64, 48), (96, 64), (88, 56)]
QUALITIES = [2, 16, 29]
FRAMES = 3
STREAMS = [f"ref_{w}x{h}_q{q}" for w, h in SIZES for q in QUALITIES]


def _crafted(w, h, im_blocks=(), inter_blocks=(), seed=3):
    """Two chunks: an INTRA_DEFAULT frame of random small coefficients,
    then one whose blocks are INTRA_DEFAULT but for `im_blocks`
    ((index, mx, my) intra-motion) and `inter_blocks` ((index, mx, my)
    inter motion from the previous frame), residuals random again."""
    wb, hb = (w + 15) // 16, (h + 15) // 16
    aw, ah = wb * 16, hb * 16
    rng = np.random.default_rng(seed)

    def frame(ftype, index, blocks):
        bt = BlockTable.zeros(wb * hb)
        bt.block_type[:] = INTRA_BIT
        bt.q_index[:] = 16
        for kind, (b, mx, my) in blocks:
            bt.block_type[b] = kind
            bt.prediction_target[b] = 0 if kind & INTRA_BIT else 1
            bt.motion_x[b], bt.motion_y[b] = mx, my
        coef = [rng.integers(-9, 10, s).astype(np.int16)
                for s in ((ah, aw), (ah // 2, aw // 2), (ah // 2, aw // 2))]
        payload, _ = native.encode_slice(bt, *coef)
        return struct.pack(_FRAME_FMT, ftype, index, 16) + payload

    blocks = [(INTRA_BIT | MOTION_BIT, b) for b in im_blocks] + \
        [(MOTION_BIT, b) for b in inter_blocks]
    return [pack_header(w, h) + frame(0, 0, []), frame(1, 1, blocks)]


def _reindex(chunks, first):
    """Reference chunks renumbered from `first`, stream header dropped."""
    out = []
    for k, c in enumerate(chunks):
        off = HEADER_SIZE if k == 0 else 0
        ftype, _, q = struct.unpack(_FRAME_FMT, c[off:off + FRAME_DESC_SIZE])
        out.append(struct.pack(_FRAME_FMT, ftype, first + k, q)
                   + c[off + FRAME_DESC_SIZE:])
    return out


@pytest.fixture(scope="module")
def streams():
    """Every stream of the file, built once: reference-encoder streams per
    size and quality, a ConformanceGpuEncoder stream, a fast-mode stream
    continued by reference frames, the below-left crafted stream, and
    crafted streams with vectors no conforming encoder emits."""
    out = {}
    for w, h in SIZES:
        frames = synth_frames(w, h, FRAMES, seed=w + h)
        for q in QUALITIES:
            enc = Evx1Encoder()
            enc.set_quality(q)
            out[f"ref_{w}x{h}_q{q}"] = [enc.encode(f) for f in frames]
    cenc = api.ConformanceGpuEncoder(device="cpu")
    cenc.set_quality(16)
    out["conformance_gpu"] = [cenc.encode(f)
                              for f in synth_frames(96, 64, FRAMES, seed=4)]
    frames = synth_frames(64, 48, 6)
    fast = api.GpuEncoder(device="cpu")
    fast.set_quality(16)
    ref = Evx1Encoder()
    ref.set_quality(16)
    out["mixed"] = [fast.encode(f) for f in frames[:3]] + _reindex(
        [ref.encode(f) for f in frames[3:]], 3)
    # block (bi=2, bj=0) of 96x64 reads below-left: cx = px-32, cy = py+8
    out["below_left"] = _crafted(96, 64, im_blocks=[(2, -32, 8)])
    out["im_beyond_reach"] = _crafted(96, 64, im_blocks=[(8, -16, 20)])
    out["inter_beyond_32"] = _crafted(96, 64, inter_blocks=[(6, 40, -8)])
    return out


def _decode_all(dec, chunks):
    return [dec.decode(c) for c in chunks]


def _check_decoders(chunks, host_frames=0, tdec=None):
    """GpuDecoder(device="cpu") RGB equals TpuDecoder's and Evx1Decoder's
    on every frame; returns the port's decoder."""
    tdec = tdec or api.GpuDecoder(device="cpu")
    want_j = _decode_all(TpuDecoder(), chunks)
    want_c = _decode_all(Evx1Decoder(), chunks)
    for i, c in enumerate(chunks):
        got = tdec.decode(c)
        np.testing.assert_array_equal(got, want_j[i], err_msg=f"frame {i}")
        np.testing.assert_array_equal(got, want_c[i],
                                      err_msg=f"frame {i} vs cpuref")
    assert tdec.host_frames == host_frames
    return tdec


# ---------------------------------------------------------------- schedule

@pytest.mark.parametrize("wb,hb", [(1, 5), (2, 3), (4, 3), (6, 4), (120, 68)])
def test_compact_schedule_matches_anchor(wb, hb):
    assert twf.decode_schedule(wb, hb) == jwf.decode_schedule(wb, hb)
    rng = np.random.default_rng(wb * hb)
    for share in (0.0, 0.05, 0.5, 1.0):
        bt = rng.integers(0, 8, wb * hb).astype(np.uint8)
        im = rng.random(wb * hb) < share
        bt[im] |= INTRA_BIT | MOTION_BIT
        bt[~im] &= ~np.uint8(MOTION_BIT)
        got = twf.build_compact_schedule(bt, wb, hb)
        want = jwf.build_compact_schedule(bt, wb, hb)
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g, wnt)
        assert got[0].dtype == got[1].dtype == np.int16


# ---------------------------------------------------------------- wave loop

def _wave_inputs(wb, hb, seed):
    """Random planes, residuals and every block intra-motion, with vectors
    over and beyond the clip box, every sub-pel direction and copies."""
    rng = np.random.default_rng(seed)
    h, w, n = hb * 16, wb * 16, wb * hb
    planes = tuple(torch.from_numpy(rng.integers(-300, 560, s)
                                    .astype(np.int16))
                   for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
    stale = tuple(torch.from_numpy(rng.integers(-300, 560, p.shape)
                                   .astype(np.int16)) for p in planes)
    res = tuple(torch.from_numpy(rng.integers(-600, 600, (n, s, s))
                                 .astype(np.int32)) for s in (16, 8, 8))
    fields = torch.from_numpy(np.stack([
        rng.integers(-40, 41, n), rng.integers(-56, 24, n),
        rng.random(n) < 0.6, rng.random(n) < 0.5, rng.integers(0, 9, n),
        rng.random(n) < 0.2]).astype(np.int32))
    bt = np.full(n, INTRA_BIT | MOTION_BIT, np.uint8)
    bi, bj, n_active = twf.build_compact_schedule(bt, wb, hb)
    return planes, stale, res, fields, bi, bj, n_active


@pytest.mark.parametrize("size", [16, 8], ids=["luma", "chroma"])
def test_wave_members_read_no_other_member(size):
    """Every sample a member can read from the written plane, over the
    whole clip box of vectors (sub-pel neighbours clip into it), lies
    outside the blocks of the other members of its wave."""
    wb, hb = 10, 7
    shift = 0 if size == 16 else 1
    dy, dx = torch.meshgrid(
        torch.arange(cuda_wavedec.DY[0], cuda_wavedec.DY[1] + 1),
        torch.arange(cuda_wavedec.DX[0], cuda_wavedec.DX[1] + 1),
        indexing="ij")
    oy, ox = (dy.reshape(-1) >> shift), (dx.reshape(-1) >> shift)
    checked = 0
    for members in twf.cuda_wave.wave_members(wb, hb):
        for m in members:
            by = torch.full_like(oy, m // wb * size)
            bx = torch.full_like(ox, m % wb * size)
            y, x, before = cuda_wavedec.sample_coords(by, bx, oy, ox, size)
            ys, xs = y[before], x[before]
            for other in members:
                if other == m:
                    continue
                oy0, ox0 = other // wb * size, other % wb * size
                hit = (ys >= oy0) & (ys < oy0 + size) & (xs >= ox0) & \
                    (xs < ox0 + size)
                assert not bool(hit.any()), (size, m, other)
                checked += 1
    assert checked > 50


def test_wave_members_run_in_any_order():
    """The plain wave loop with each wave's members together equals one
    member at a time, in reverse order within each wave."""
    wb, hb = 9, 6
    planes, stale, res, fields, bi, bj, n_active = _wave_inputs(wb, hb, 8)
    rows = [(int(a), int(b)) for w in range(n_active)
            for a, b in reversed(list(zip(bi[w], bj[w]))) if a >= 0]
    one_bi = np.full((len(rows), 1), -1, np.int16)
    one_bj = np.full((len(rows), 1), -1, np.int16)
    one_bi[:, 0], one_bj[:, 0] = zip(*rows)
    together = cuda_wavedec.wave_decode(
        tuple(p.clone() for p in planes), stale, res, fields,
        torch.from_numpy(bi), torch.from_numpy(bj), n_active, len(rows))
    alone = cuda_wavedec.wave_decode(
        tuple(p.clone() for p in planes), stale, res, fields,
        torch.from_numpy(one_bi), torch.from_numpy(one_bj), len(rows),
        len(rows))
    for a, b in zip(together, alone):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not torch.equal(together[0], planes[0])


def test_wave_decode_plain_reads_stale_below_left():
    """A member whose vector points below-left reads the stale plane there
    and the written plane above and left, sample by sample."""
    h, w = 48, 64
    planes = (torch.full((h, w), 100, dtype=torch.int16),
              torch.full((h // 2, w // 2), 100, dtype=torch.int16),
              torch.full((h // 2, w // 2), 100, dtype=torch.int16))
    stale = tuple(torch.full_like(p, 7) for p in planes)
    n = (h // 16) * (w // 16)
    res = (torch.zeros(n, 16, 16, dtype=torch.int32),
           torch.zeros(n, 8, 8, dtype=torch.int32),
           torch.zeros(n, 8, 8, dtype=torch.int32))
    fields = torch.zeros(6, n, dtype=torch.int32)
    m = 1 * 4 + 2                        # block (bi=2, bj=1): px 32, py 16
    fields[0, m], fields[1, m] = -32, 8  # rows 24..39, columns 0..15
    bi = torch.tensor([[2]], dtype=torch.int16)
    bj = torch.tensor([[1]], dtype=torch.int16)
    cuda_wavedec.wave_decode(planes, stale, res, fields, bi, bj, 1, 1)
    blk = planes[0][16:32, 32:48]
    # rows 24..31 are in the member's block row, left of it: written;
    # rows 32..39 are below it: stale
    assert bool((blk[:8] == 100).all()) and bool((blk[8:] == 7).all())


def test_kernel_source_matches_the_wrapper():
    """wavedec.cu clips vectors to cuda_wavedec's DX / DY, and the ctypes
    signature has one letter per parameter of its C entry, a pointer for
    each pointer and the stream."""
    src = (pathlib.Path(cuda_wavedec.__file__).parent / "csrc" /
           "wavedec.cu").read_text()
    clip = dict(re.findall(r"\b(D[XY]_(?:LO|HI)) = (-?\d+)", src))
    assert (int(clip["DX_LO"]), int(clip["DX_HI"])) == cuda_wavedec.DX
    assert (int(clip["DY_LO"]), int(clip["DY_HI"])) == cuda_wavedec.DY
    params = re.search(r'extern "C" int cairo_wave_decode\(([^)]*)\)',
                       src)[1].split(",")
    assert "".join("p" if "*" in q else "i" for q in params) == \
        cuda_wavedec.SIGNATURE
    assert params[-1].split()[-1] == "stream"


# ------------------------------------------------------------ decode steps

def _frame_inputs(chunks):
    """Per frame of a stream: (in_wire, dense in_wire, coefficient plane
    copies, n_active, n_members, coo_k), parsed on the host as GpuDecoder
    does."""
    width, height = parse_header(chunks[0][:HEADER_SIZE])
    aw, ah = -(-width // 16) * 16, -(-height // 16) * 16
    wb, hb = aw // 16, ah // 16
    bt = BlockTable.zeros(wb * hb)
    coef = [np.zeros((ah, aw), np.int16),
            np.zeros((ah // 2, aw // 2), np.int16),
            np.zeros((ah // 2, aw // 2), np.int16)]
    out = []
    for i, c in enumerate(chunks):
        off = HEADER_SIZE if i == 0 else 0
        _, index, _ = struct.unpack(_FRAME_FMT, c[off:off + FRAME_DESC_SIZE])
        native.decode_slice(c, (off + FRAME_DESC_SIZE) * 8, bt, *coef)
        pos, val, count = native.extract_coo(bt.block_type, wb, *coef,
                                             twire.COO_K)
        coo_k = twire.COO_SMALL
        assert count <= coo_k
        bi, bj, n_active = twf.build_compact_schedule(bt.block_type, wb, hb)
        head = np.array([index, n_active], np.int32).view(np.uint8)
        tail = [twire.pack_table_np(bt), bi.view(np.uint8).reshape(-1),
                bj.view(np.uint8).reshape(-1)]
        n_members = int((bi >= 0).sum())
        out.append((np.concatenate([head, pos[:coo_k].view(np.uint8),
                                    val[:coo_k].view(np.uint8), *tail]),
                    np.concatenate([head, *tail]), [p.copy() for p in coef],
                    n_active, n_members, coo_k))
    return (aw, ah, width, height), out


def _jax_state(aw, ah):
    """The decode state without the XLA anchors' window caches."""
    return {k: np.array(v) for k, v in jengine.init_state(aw, ah).items()
            if not k.startswith("win_")}


@pytest.mark.parametrize("name", STREAMS)
def test_decode_step_matches_anchor(streams, name):
    (aw, ah, width, height), frames = _frame_inputs(streams[name])
    geom = dict(aligned_w=aw, aligned_h=ah, frame_w=width, frame_h=height)
    jstate = _jax_state(aw, ah)
    waves = 0
    for i, (wire, _, _, n_active, n_members, coo_k) in enumerate(frames):
        tstate = api.state_from_numpy(jstate, "cpu")
        jstate, jyuv = jwf.conformance_decode_step(
            wire, dict(jstate), coo_k=coo_k, **geom)
        jstate = {k: np.array(v) for k, v in jstate.items()}
        tstate, tyuv = twf.conformance_decode_step(
            torch.from_numpy(wire), tstate, n_active=n_active,
            n_members=n_members, coo_k=coo_k, **geom)
        np.testing.assert_array_equal(tyuv.numpy(), np.asarray(jyuv),
                                      err_msg=f"frame {i} yuv wire")
        for k in api.STATE_KEYS:
            np.testing.assert_array_equal(tstate[k].numpy(), jstate[k],
                                          err_msg=f"frame {i} {k}")
        waves += n_active
    assert waves > 0


@pytest.mark.parametrize("quality", QUALITIES)
def test_dense_step_matches_anchor(streams, quality):
    (aw, ah, width, height), frames = _frame_inputs(
        streams[f"ref_64x48_q{quality}"])
    geom = dict(aligned_w=aw, aligned_h=ah, frame_w=width, frame_h=height)
    jstate = _jax_state(aw, ah)
    for i, (wire, dense, coef, n_active, n_members, coo_k) in \
            enumerate(frames):
        tstate = api.state_from_numpy(jstate, "cpu")
        coo_state, coo_yuv = twf.conformance_decode_step(
            torch.from_numpy(wire), api.state_from_numpy(jstate, "cpu"),
            n_active=n_active, n_members=n_members, coo_k=coo_k, **geom)
        jstate, jyuv = jwf.conformance_decode_step_dense(
            dense, *coef, dict(jstate), **geom)
        jstate = {k: np.array(v) for k, v in jstate.items()}
        tstate, tyuv = twf.conformance_decode_step_dense(
            torch.from_numpy(dense), *(torch.from_numpy(p) for p in coef),
            tstate, n_active=n_active, n_members=n_members, **geom)
        for got in (tyuv, coo_yuv):
            np.testing.assert_array_equal(got.numpy(), np.asarray(jyuv),
                                          err_msg=f"frame {i} yuv wire")
        for k in api.STATE_KEYS:
            for got in (tstate, coo_state):
                np.testing.assert_array_equal(got[k].numpy(), jstate[k],
                                              err_msg=f"frame {i} {k}")


# ---------------------------------------------------------------- decoder

@pytest.mark.parametrize("name", STREAMS + ["conformance_gpu", "mixed",
                                            "below_left"])
def test_decoder_matches_references(streams, name, monkeypatch):
    calls = []
    step = twf.conformance_decode_step
    monkeypatch.setattr(twf, "conformance_decode_step",
                        lambda *a, **k: calls.append(k) or step(*a, **k))
    dec = _check_decoders(streams[name])
    assert calls                               # the wave path ran
    if name in ("conformance_gpu", "below_left"):
        assert any(k["n_members"] for k in calls)
        assert dec.last_stats["path"] == "device"


def test_decoder_dense_on_coo_overflow(streams, monkeypatch):
    """At q2 the residuals overflow a COO capacity shrunk to 64: the wave
    frames beyond it (the intra frame) take the dense-plane step, still
    on the device path."""
    monkeypatch.setattr(twire, "COO_K", 64)
    monkeypatch.setattr(twire, "COO_SMALL", 64)
    calls = []
    step = twf.conformance_decode_step_dense
    monkeypatch.setattr(twf, "conformance_decode_step_dense",
                        lambda *a, **k: calls.append(1) or step(*a, **k))
    _check_decoders(streams["ref_64x48_q2"])
    assert calls


@pytest.mark.parametrize("name", ["im_beyond_reach", "inter_beyond_32"])
def test_hostile_vectors_take_the_host(streams, name):
    """Vectors no conforming encoder emits go to the native decoder (the
    intra frame before them decodes on the device)."""
    _check_decoders(streams[name], host_frames=1)


def test_wavefront_off_takes_the_host(streams):
    dec = api.GpuDecoder(device="cpu")
    dec.use_wavefront_decode = False
    chunks = streams["ref_96x64_q16"]
    _check_decoders(chunks, host_frames=len(chunks), tdec=dec)
    assert dec.last_stats == dict(path="host", host_frames=len(chunks))


def test_tpu_checkpoint_resumes_before_a_wave_frame(streams):
    chunks = streams["ref_96x64_q16"]
    jdec = TpuDecoder()
    jdec.decode(chunks[0])
    tdec = tcheckpoint.load_state(api.GpuDecoder(device="cpu"),
                                  jcheckpoint.dump_state(jdec))
    for i, c in enumerate(chunks[1:], 1):
        np.testing.assert_array_equal(tdec.decode(c), jdec.decode(c),
                                      err_msg=f"frame {i}")
        assert tdec.last_stats["waves"] > 0
    assert tdec.host_frames == 0


class _NoState(dict):
    def __getitem__(self, key):
        raise AssertionError("the live state was read after dispatch")


@pytest.mark.parametrize("kind", ["fast", "wave"])
def test_lossy_wire_refetches_the_dispatched_slot(kind, monkeypatch):
    """An overflowed exception list (capacity 2) refetches the exact
    planes from the ring views the dispatch took, never from the live
    state: the state is hidden between dispatch and finish."""
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 255, (64, 64, 3)).astype(np.uint8)
              for _ in range(3)]
    enc = api.GpuEncoder(device="cpu") if kind == "fast" else Evx1Encoder()
    enc.set_quality(31)
    chunks = [enc.encode(f) for f in frames]
    want = _decode_all(Evx1Decoder(), chunks)
    monkeypatch.setattr(twire, "EXC_K", 2)
    refetches = []
    exact = api.cpu_imaging.yuv420_to_rgb
    monkeypatch.setattr(api.cpu_imaging, "yuv420_to_rgb",
                        lambda *a: refetches.append(1) or exact(*a))
    dec = api.GpuDecoder(device="cpu")
    for i, c in enumerate(chunks):
        pending = dec._dispatch_decode(c)
        state, dec._state = dec._state, _NoState()
        got = dec._finish_decode(pending)
        dec._state = state
        np.testing.assert_array_equal(got, want[i], err_msg=f"frame {i}")
        assert (dec.last_stats["members"] > 0) == (kind == "wave")
    assert refetches and dec.host_frames == 0
