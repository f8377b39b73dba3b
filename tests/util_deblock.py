"""Seeded inputs of the in-loop deblock (numpy only, no jax, no torch):
the cases K8 and its plain version are held to, on the CPU and the card."""

import numpy as np

# (height, width): one MB, one MB row, one MB column, a frame of 17 x 30
# MBs
SIZES = [(16, 16), (16, 176), (176, 16), (272, 480)]
# sizes that K8's 32 x 120 tiles do not divide: 208x400 in neither
# dimension, luma and chroma; 208x112 one tile column wide
TILE_SIZES = [(208, 400), (208, 112)]
KINDS = ["mixed", "all_copy", "no_copy", "q0", "q31", "int16_range",
         "uint8_q"]


def _content(rng, h, w):
    """Blocky content with small steps between 8x8 cells and some noise,
    so that edges both filter and keep; a little overshoot beyond
    0..255 (the reconstruction's)."""
    steps = rng.integers(-12, 13, (h // 8, w // 8))
    base = 128 + np.cumsum(steps, 0) + np.cumsum(steps, 1)
    plane = np.kron(base, np.ones((8, 8), np.int64))
    return (plane + rng.integers(-3, 4, (h, w))).astype(np.int32)


def deblock_case(kind, h, w, seed=0):
    """(y, u, v, copy_blocks, q_blocks) numpy arrays for a (h, w) frame:
    Y (h, w), U and V (h / 2, w / 2) int32; copy (h / 16, w / 16) bool;
    q int32 (uint8 for "uint8_q"), non-zero on copy MBs but for "q0"."""
    rng = np.random.default_rng([seed, h, w, KINDS.index(kind)])
    hb, wb = h // 16, w // 16
    y, u, v = (_content(rng, *s) for s in ((h, w), (h // 2, w // 2),
                                            (h // 2, w // 2)))
    copy = rng.random((hb, wb)) < 0.4
    q = rng.integers(1, 32, (hb, wb)).astype(np.int32)
    if kind == "all_copy":
        copy[:] = True
    elif kind == "no_copy":
        copy[:] = False
    elif kind == "q0":
        q[:] = 0
    elif kind == "q31":
        q[:] = 31
    elif kind == "int16_range":
        # far beyond int16, positive in the top half, negative below
        for p in (y, u, v):
            p += np.where(np.arange(p.shape[0]) < p.shape[0] // 2, 40000,
                          -40000).astype(np.int32)[:, None]
    elif kind == "uint8_q":
        q = q.astype(np.uint8)
    return y, u, v, copy, q
