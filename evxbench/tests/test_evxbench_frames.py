"""The frame ring: the mix's content parameters alone make it; the run's
seed only chooses where the sessions start."""

import numpy as np

import tiny  # noqa: F401  (puts the harness and the port on the path)
from harness import frames

CONTENT = dict(seed=20261018, pan_px=3, sprites=6, sprite_px=40, noise=4)


def test_same_content_same_ring():
    a = frames.make_ring(160, 96, 5, CONTENT)
    b = frames.make_ring(160, 96, 5, CONTENT)
    assert a.dtype == np.uint8 and a.shape == (5, 96, 160, 3)
    assert np.array_equal(a, b)


def test_noise_seed_changes_only_the_noise():
    a = frames.make_ring(160, 96, 4, CONTENT).astype(int)
    b = frames.make_ring(160, 96, 4, dict(CONTENT, seed=2**40 + 5))
    b = b.astype(int)
    assert not np.array_equal(a, b)
    assert np.abs(a[..., 0] - b[..., 0]).max() <= 8


def test_run_seed_rotates_the_start_of_every_session():
    offs = [frames.session_offsets(240, 4, np.random.default_rng(seed))
            for seed in (1, 2**31 + 3, 2**40)]
    for o in offs:
        assert sorted((x - o[0]) % 240 for x in o) == [0, 60, 120, 180]
    assert len({o[0] for o in offs}) > 1
    again = frames.session_offsets(240, 4, np.random.default_rng(2**31 + 3))
    assert again == offs[1]


def test_content_pans_and_sprites_move():
    ring = frames.make_ring(640, 360, 2, dict(CONTENT, noise=0))
    luma = ring[..., 0].astype(int)
    assert np.array_equal(ring[..., 2], 255 - luma)
    assert np.array_equal(ring[:, 1:, :, 1], luma[:, :-1])
    # the last sprite, drawn on top: (5*137 + t*10) % 600, (5*83 + t*8) % 320
    assert (luma[0, 95:135, 85:125] == 180).all()
    assert (luma[1, 103:143, 95:135] == 180).all()
    # the background pans 3 px a frame
    assert np.array_equal(luma[1, 300:, 3:], luma[0, 300:, :-3])


def test_ring_length_and_offsets():
    mix = dict(ring_bytes=1_500_000_000)
    assert frames.ring_length(mix, 1920, 1080) == 241
    assert frames.ring_length(mix, 3840, 2160) == 60
