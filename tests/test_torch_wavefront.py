"""cairo_tpu_torch.gpu.wavefront and the plain versions of K4 at the wide
pads, K5 and K6 against cairo_tpu.tpu.wavefront on the CPU (its XLA
anchors: backend.use_pallas() is False here), exactly:

  * inter_search_plain, through the port's dense_inter, against
    wavefront._dense_inter (fields and prediction blocks, so the wide
    pred_planes_plain is pinned against the anchor's search_windows form),
    and motion.inter_search_exact on flat planes that force ties;
  * pred_planes_plain(..., 33, 17) against wavefront._wide_gather_pred;
  * the wave's intra search (K6's plain version is built on it) against
    wavefront._intra_search_wave, on windows that force SAD ties;
  * wave_pass_plain inside the port's conformance_encode_step against the
    JAX conformance_encode_step, outputs and state, over 3 frames of
    random wires.
The kernels are held against these plain versions in test_torch_cuda.py.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from cairo_tpu.tpu import wavefront as jwf, wire as jwire
from cairo_tpu_torch.gpu import cuda_inter, cuda_pred, cuda_wave, ops
from cairo_tpu_torch.gpu import wavefront as twf

RING = 4
QUALITIES = [4, 16, 29]


def _eq(got, want, msg=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def _inter_inputs(w, h, seed):
    """Smooth source planes (so the hill-climb converges) and a ring whose
    reference slots hold noisy shifted copies of them: one exact on its
    left half at an even shift (copy blocks), one with recon overshoot
    beyond 0..255."""
    rng = np.random.default_rng(seed)
    planes = []
    for i, (ph, pw) in enumerate(((h, w), (h // 2, w // 2), (h // 2, w // 2))):
        yy, xx = np.mgrid[0:ph, 0:pw] * (2 if i else 1)
        p = 128 + 60 * np.sin(xx * 0.13 + i) * np.cos(yy * 0.09 + seed)
        planes.append(p.astype(np.int64) + rng.integers(-2, 3, (ph, pw)))
    rings = []
    for i, p in enumerate(planes):
        slots = []
        for s, (dy, dx) in enumerate(((0, 0), (4, -6), (-7, 11), (13, -3))):
            if i:
                dy, dx = dy // 2, dx // 2
            r = np.roll(p, (dy, dx), (0, 1))
            noise = rng.integers(-6, 7, r.shape)
            if s == 1:      # exact on the left half only
                noise[:, :r.shape[1] // 2] = 0
            r = r + noise
            if s == 3:
                r[::5] += 300
            slots.append(r)
        rings.append(np.stack(slots).astype(np.int16))
    src = [p.astype(np.int32) for p in planes]
    return src, rings


@functools.lru_cache(maxsize=None)
def _jax_dense_inter(w, h):
    def f(src_blocks, src_planes, state, frame_index, quality):
        return jwf._dense_inter(src_blocks, src_planes, state, frame_index,
                                quality, RING)
    return jax.jit(f)


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("size", [(64, 48), (96, 64)])
def test_dense_inter_matches_anchor(size, quality):
    w, h = size
    src, rings = _inter_inputs(w, h, seed=w + quality)
    frame_index = 6                     # offsets 1..3 read slots 1, 0, 3
    jsrc = tuple(jwf.ops.plane_to_blocks(jax.numpy.asarray(p), s)
                 for p, s in zip(src, (16, 8, 8)))
    jstate = dict(ring_y=rings[0], ring_u=rings[1], ring_v=rings[2])
    jbest, jpred = _jax_dense_inter(w, h)(jsrc, tuple(src), jstate,
                                          frame_index, quality)
    tsrc = tuple(ops.plane_to_blocks(torch.from_numpy(p), s).contiguous()
                 for p, s in zip(src, (16, 8, 8)))
    tstate = dict(ring_y=torch.from_numpy(rings[0]),
                  ring_u=torch.from_numpy(rings[1]),
                  ring_v=torch.from_numpy(rings[2]))
    hdr = torch.tensor([frame_index, quality], dtype=torch.int32)
    tbest, tpred = twf.dense_inter(tsrc, tstate, hdr)
    for k in cuda_inter.FIELDS + ("is_intra",):
        _eq(tbest[k], jbest[k], k)
    for i, (g, wnt) in enumerate(zip(tpred, jpred)):
        _eq(g, wnt, f"pred[{i}]")
    # the content reaches the branches the comparison is meant to pin (at
    # q29, MAD threshold 8, it is copy-grade everywhere)
    assert bool(tbest["is_copy"].any()) and bool(tbest["is_motion"].any())
    assert quality == 29 or bool(tbest["sp_pred"].any())
    assert len(set(tbest["target"].tolist())) > 1


@pytest.mark.parametrize("ref_level", [128, 96])
def test_inter_search_exact_ties_match_anchor(ref_level):
    """Flat planes: every candidate ties, at SAD 0 (128) or at SAD 8192,
    the threshold the reference's C-precedence quirk tests (96)."""
    from cairo_tpu.tpu import motion as jmotion
    from cairo_tpu_torch.gpu import motion as tmotion

    h, w = 48, 64
    src = [np.full((h, w), 128, np.int32),
           np.full((h // 2, w // 2), 128, np.int32),
           np.full((h // 2, w // 2), 128, np.int32)]
    ref = [np.full(p.shape, ref_level, np.int32) for p in src]
    n = (h // 16) * (w // 16)
    px = (np.arange(n, dtype=np.int32) % (w // 16)) * 16
    py = (np.arange(n, dtype=np.int32) // (w // 16)) * 16
    blocks = [jwf.ops.plane_to_blocks(jax.numpy.asarray(p), s)
              for p, s in zip(src, (16, 8, 8))]
    want = jmotion.inter_search_exact(tuple(blocks), tuple(ref), px, py, 16)
    got = tmotion.inter_search_exact(
        tuple(ops.plane_to_blocks(torch.from_numpy(p), s)
              for p, s in zip(src, (16, 8, 8))),
        tuple(torch.from_numpy(p) for p in ref), torch.from_numpy(px),
        torch.from_numpy(py), torch.tensor(16, dtype=torch.int32))
    for k in want:
        _eq(got[k], want[k], k)


@pytest.mark.parametrize("seed", [3, 9])
def test_wide_pred_planes_plain_matches_anchor(seed):
    rng = np.random.default_rng(seed)
    h, w = 48, 80
    n = (h // 16) * (w // 16)
    rings = [rng.integers(-600, 600, (RING, h, w)).astype(np.int16),
             rng.integers(-600, 600, (RING, h // 2, w // 2)).astype(np.int16),
             rng.integers(-600, 600, (RING, h // 2, w // 2)).astype(np.int16)]
    target = rng.integers(0, 4, n).astype(np.int32)
    mx = rng.integers(-40, 41, n).astype(np.int32)   # beyond 32 clamps
    my = rng.integers(-40, 41, n).astype(np.int32)
    spp, spa, zero = (rng.random(n) < 0.5, rng.random(n) < 0.5,
                      rng.random(n) < 0.2)
    spi = rng.integers(0, 8, n).astype(np.int32)
    frame_index = 5
    jstate = dict(ring_y=rings[0], ring_u=rings[1], ring_v=rings[2])
    want = jwf._wide_gather_pred(jstate, frame_index, target, mx, my, spp,
                                 spa, spi, zero)
    slot = (frame_index + RING - target) % RING
    got = cuda_pred.pred_planes_plain(
        *(torch.from_numpy(r) for r in rings), torch.from_numpy(slot),
        torch.from_numpy(mx), torch.from_numpy(my), torch.from_numpy(spp),
        torch.from_numpy(spa), torch.from_numpy(spi), torch.from_numpy(zero),
        cuda_pred.WIDE_YPAD, cuda_pred.WIDE_CPAD)
    for i, (g, wnt, s) in enumerate(zip(got, want, (16, 8, 8))):
        _eq(ops.plane_to_blocks(g, s), wnt, f"plane {i}")


def _wave_inputs(kind, seed):
    """Windows, source blocks and positions of 3 wave members of a 96x64
    frame. "ties": zero windows and a flat source, so every candidate's
    SAD equals the starting sum |src| (>= SAD_THRESHOLD) and only the
    reference's C-precedence quirk rejects it; "shifted": windows holding
    the source at a causal offset (copy-grade candidates)."""
    rng = np.random.default_rng(seed)
    px = np.array([32, 80, 16], np.int32)
    py = np.array([16, 32, 48], np.int32)
    if kind == "ties":
        wins = [np.zeros((3, 80, 80), np.int32),
                np.zeros((3, 40, 40), np.int32),
                np.zeros((3, 40, 40), np.int32)]
        src = [np.full((3, 16, 16), 64, np.int32),
               np.full((3, 8, 8), 64, np.int32),
               np.full((3, 8, 8), 64, np.int32)]
        return wins, src, px, py
    wins = [rng.integers(-40, 300, (3, 80, 80)).astype(np.int32),
            rng.integers(-40, 300, (3, 40, 40)).astype(np.int32),
            rng.integers(-40, 300, (3, 40, 40)).astype(np.int32)]
    if kind == "random":
        src = [rng.integers(0, 256, (3, 16, 16)).astype(np.int32),
               rng.integers(0, 256, (3, 8, 8)).astype(np.int32),
               rng.integers(0, 256, (3, 8, 8)).astype(np.int32)]
    else:   # the candidate at (dx, dy) = (-16, -16) plus noise
        src = [wins[0][:, 32:48, 16:32] + rng.integers(-1, 2, (3, 16, 16)),
               wins[1][:, 16:24, 8:16], wins[2][:, 16:24, 8:16]]
    return wins, src, px, py


@pytest.mark.parametrize("kind", ["random", "ties", "shifted"])
def test_intra_search_wave_matches_anchor(kind):
    wins, src, px, py = _wave_inputs(kind, seed=5)
    self_sad = np.abs(src[0]).sum(axis=(1, 2)).astype(np.int32)
    quality = 16
    jdesc, jpred = jax.jit(functools.partial(
        jwf._intra_search_wave, aligned_w=96, aligned_h=64))(
        *wins, tuple(src), px, py, self_sad, quality)
    tdesc, tpred = cuda_wave.intra_search_wave(
        tuple(torch.from_numpy(w) for w in wins),
        tuple(torch.from_numpy(x) for x in src), torch.from_numpy(px),
        torch.from_numpy(py), torch.from_numpy(self_sad),
        torch.tensor(quality, dtype=torch.int32), 96, 64)
    for k in jdesc:
        _eq(tdesc[k], jdesc[k], k)
    for i, (g, wnt) in enumerate(zip(tpred, jpred)):
        _eq(g, wnt, f"pred[{i}]")
    if kind == "ties":      # the quirk keeps the starting point
        assert not bool(tdesc["is_motion"].any())
    if kind == "shifted":
        assert bool(tdesc["is_copy"].any())


def test_wave_schedule_matches_anchor():
    for wb, hb in ((4, 3), (1, 5), (120, 68)):
        bi, bj, valid = (np.asarray(t) for t in jwf.wave_schedule(wb, hb))
        want = [tuple(int(x) for x in (bj[w] * wb + bi[w])[valid[w]])
                for w in range(len(valid)) if valid[w].any()]
        assert list(cuda_wave.wave_members(wb, hb)) == want


W, H = 64, 48
FRAMES = 3


def _src_wires(quality):
    """Random source wires as tests/test_pallas_wave_tpu.py builds them."""
    rng = np.random.default_rng(7)
    wires = []
    for i in range(FRAMES):
        buf = rng.integers(0, 255, 8 + jwire.yuv8_nbytes(H, W),
                           np.uint8).astype(np.uint8)
        buf[:8] = np.array([i, quality], np.int32).view(np.uint8)
        wires.append(buf)
    return wires


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX conformance step's outputs and state per quality (one
    compile per frame kind, shared by the three qualities)."""
    runs = {}
    for quality in QUALITIES:
        state = jwf.init_state(W, H)
        outs, states = [], []
        for i, wire in enumerate(_src_wires(quality)):
            state, out = jwf.conformance_encode_step(
                wire, state, aligned_w=W, aligned_h=H, frame_w=W, frame_h=H,
                is_inter=i > 0)
            outs.append(jax.device_get(out))
            states.append(jax.device_get(state))
        runs[quality] = outs, states
    return runs


@pytest.mark.parametrize("quality", QUALITIES)
def test_conformance_step_matches_anchor(jax_steps, quality):
    outs, states = jax_steps[quality]
    state = twf.init_state(W, H, "cpu")
    for i, wire in enumerate(_src_wires(quality)):
        state, out = twf.conformance_encode_step(
            torch.from_numpy(wire), state, aligned_w=W, aligned_h=H,
            frame_w=W, frame_h=H, is_inter=i > 0)
        assert set(out) == set(outs[i])
        for k in out:
            _eq(out[k], outs[i][k], f"frame {i} output {k}")
        for k in twf.STATE_KEYS:
            _eq(state[k], states[i][k], f"frame {i} state {k}")
