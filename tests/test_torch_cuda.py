"""Card-only tests of the port: the CUDA kernels K1-K4 against their plain
versions, and the whole encoder on the card against the CPU. Each test is
marked `cuda` and skips without a CUDA card. The file imports neither jax
nor cairo_tpu, so it runs on a machine without them:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from cairo_tpu_torch.gpu import api, cuda_motion, cuda_pred
from cairo_tpu_torch.synth import synth_frames

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
