"""The frame ring every session reads: game-stream-like synthetic video (the
content of the JAX package's benchmark and of the port's records): a
textured background panned a few pixels a frame, square sprites each
moving on its own path, and uniform noise. The mix file gives every
parameter, the noise's seed among them, so every run encodes the same
frames; the run's seed chooses where in the ring the sessions start, so
seeds ask the same work in another order.
"""

from __future__ import annotations

import numpy as np


def ring_length(mix: dict, width: int, height: int) -> int:
    """Frames in the ring: as many RGB frames as `ring_bytes` holds."""
    return max(2, int(mix["ring_bytes"]) // (width * height * 3))


def make_ring(width: int, height: int, n_frames: int,
              content: dict) -> np.ndarray:
    """(n_frames, height, width, 3) uint8 RGB frames. The last frame leads
    back to the first, which a session reading on past the end meets as a
    scene cut."""
    rng = np.random.default_rng(int(content["seed"]))
    x = np.arange(width)
    y = np.arange(height)
    background = (128 + 80 * np.sin(x * 0.05)[None, :]
                  * np.cos(y * 0.07)[:, None]).astype(np.int16)
    pan = int(content["pan_px"])
    size = int(content["sprite_px"])
    noise = int(content["noise"])
    # uniform noise in [-noise, noise]: a random byte b gives
    # (b * levels) >> 8, far cheaper than drawing bounded integers
    levels = 2 * noise + 1
    scaled = np.empty((height, width), np.uint16)
    ring = np.empty((n_frames, height, width, 3), np.uint8)
    luma = np.empty((height, width), np.int16)
    luma8 = np.empty((height, width), np.uint8)
    for t in range(n_frames):
        np.copyto(luma, np.roll(background, t * pan, axis=1))
        for s in range(int(content["sprites"])):
            sx = (s * 137 + t * (5 + s)) % (width - size)
            sy = (s * 83 + t * (3 + s)) % (height - size)
            luma[sy:sy + size, sx:sx + size] = 30 + 30 * s
        draw = np.frombuffer(rng.bytes(height * width), np.uint8)
        np.multiply(draw.reshape(height, width), levels, out=scaled,
                    dtype=np.uint16)
        luma += scaled >> 8
        luma -= noise
        np.clip(luma, 0, 255, out=luma)
        np.copyto(luma8, luma, casting="unsafe")
        frame = ring[t]
        frame[..., 0] = luma8
        frame[1:, :, 1] = luma8[:-1]
        frame[0, :, 1] = luma8[-1]
        np.subtract(255, luma8, out=frame[..., 2])
    return ring


def session_offsets(n_frames: int, sessions: int, rng) -> list[int]:
    """Each session's first frame in the ring: spread evenly from a start
    the run's seed draws."""
    base = int(rng.integers(n_frames))
    return [(base + s * n_frames // sessions) % n_frames
            for s in range(sessions)]
