"""Synthetic game-stream-like video from a seed: a scrolling gradient with
moving sprites and a little noise (the content of the JAX package's
tests/util_video.synth_frames, kept here so the port needs nothing of
the tests)."""

from __future__ import annotations

import numpy as np


def synth_frames(width, height, n_frames, seed=7, noise=4):
    """n_frames (height, width, 3) uint8 frames."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    background = (128 + 80 * np.sin(xx * 0.05) * np.cos(yy * 0.07)) \
        .astype(np.int16)
    frames = []
    for t in range(n_frames):
        frame = np.roll(background, t * 3, axis=1).copy()
        for s in range(4):
            sx = int((s * 37 + t * (3 + s)) % max(1, width - 20))
            sy = int((s * 23 + t * (2 + s)) % max(1, height - 20))
            frame[sy:sy + 20, sx:sx + 20] = 30 + 40 * s
        if noise:
            frame = frame + rng.integers(-noise, noise + 1, frame.shape)
        luma = np.clip(frame, 0, 255).astype(np.uint8)
        rgb = np.stack([luma, np.roll(luma, 1, axis=0), 255 - luma], axis=-1)
        frames.append(np.ascontiguousarray(rgb))
    return frames
