"""cairo_tpu_torch.gpu.deblock against cairo_tpu.tpu.deblock on the CPU:
planes equal for random copy and q maps."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cairo_tpu.tpu import deblock as jdeblock
from cairo_tpu_torch.gpu import deblock as tdeblock


@pytest.mark.parametrize("seed,h,w,copy_frac", [(0, 64, 80, 0.3),
                                                (1, 48, 96, 0.0),
                                                (2, 32, 32, 1.0),
                                                (3, 96, 64, 0.6)])
def test_deblock_frame_matches(seed, h, w, copy_frac):
    rng = np.random.default_rng(seed)
    hb, wb = h // 16, w // 16
    # smooth content with block steps, so edges both filter and keep
    base = rng.integers(0, 256, (hb * 2, wb * 2)).astype(np.int32)
    y = np.kron(base, np.ones((8, 8), np.int32)) + \
        rng.integers(-3, 4, (h, w)).astype(np.int32)
    u = rng.integers(-20, 280, (h // 2, w // 2)).astype(np.int32)
    v = np.kron(base[::2, ::2], np.ones((8, 8), np.int32))
    copy = rng.random((hb, wb)) < copy_frac
    q = rng.integers(0, 32, (hb, wb)).astype(np.int32)
    q = np.where(copy, 0, q)
    got = tdeblock.deblock_frame(*(torch.from_numpy(p) for p in (y, u, v)),
                                 torch.from_numpy(copy), torch.from_numpy(q))
    want = jdeblock.deblock_frame(*(jnp.asarray(p) for p in (y, u, v)),
                                  jnp.asarray(copy), jnp.asarray(q))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    if copy_frac < 1.0:
        assert not np.array_equal(got[0].numpy(), y)  # the filter acted
