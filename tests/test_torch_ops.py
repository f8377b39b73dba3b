"""cairo_tpu_torch.gpu.ops against cairo_tpu.tpu.ops on the CPU: the same
seeded numpy inputs through both, exact equality (the codec is
integer-only)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cairo_tpu.tpu import ops as jops
from cairo_tpu_torch.gpu import ops as tops

I16_EDGES = np.array([-32768, -32767, -256, -1, 0, 1, 255, 256, 32767],
                     np.int32)


def _rand_blocks(seed, shape, lo=-32768, hi=32768):
    rng = np.random.default_rng(seed)
    a = rng.integers(lo, hi, shape).astype(np.int32)
    flat = a.reshape(-1)
    flat[:I16_EDGES.size] = I16_EDGES  # extremes always present
    return a


def _same(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("name", ["trunc_div", "trunc_div_pos",
                                  "rounded_div_pos"])
def test_division(name):
    rng = np.random.default_rng(1)
    numer = rng.integers(-2**31, 2**31, 4000).astype(np.int32)
    numer[:3] = [-2**31, 2**31 - 1, 0]
    denom = rng.integers(1, 300, 4000).astype(np.int32)
    if name == "trunc_div":
        denom = np.where(rng.random(4000) < 0.5, -denom, denom)
    got = getattr(tops, name)(torch.from_numpy(numer), torch.from_numpy(denom))
    want = getattr(jops, name)(jnp.asarray(numer), jnp.asarray(denom))
    _same(got, want)
    # python-int divisor, as most call sites pass it
    _same(getattr(tops, name)(torch.from_numpy(numer), 128),
          getattr(jops, name)(jnp.asarray(numer), 128))


@pytest.mark.parametrize("name", ["wrap16", "sign", "ilog2_u32"])
def test_elementwise(name):
    v = _rand_blocks(2, 5000, -2**31, 2**31)
    _same(getattr(tops, name)(torch.from_numpy(v)),
          getattr(jops, name)(jnp.asarray(v)))


def test_round_out():
    v = _rand_blocks(3, 2000)
    for amount in (1, 2, 64):
        _same(tops.round_out(torch.from_numpy(v), amount),
              jops.round_out(jnp.asarray(v), amount))


@pytest.mark.parametrize("name", ["fdct8", "idct8"])
def test_dct(name):
    blocks = _rand_blocks(4, (300, 8, 8))
    blocks[1:40] = _rand_blocks(5, (39, 8, 8), -300, 300)  # residual range
    _same(getattr(tops, name)(torch.from_numpy(blocks)),
          getattr(jops, name)(jnp.asarray(blocks)))


@pytest.mark.parametrize("intra", [True, False])
@pytest.mark.parametrize("is_luma", [True, False])
def test_quantize_dequantize(intra, is_luma):
    blocks = _rand_blocks(6, (400, 8, 8))
    qp = np.random.default_rng(7).integers(1, 32, 400).astype(np.int32)
    _same(tops.quantize_8x8(torch.from_numpy(blocks), torch.from_numpy(qp),
                            intra, is_luma),
          jops.quantize_8x8(jnp.asarray(blocks), jnp.asarray(qp), intra,
                            is_luma))
    coefs = _rand_blocks(8, (400, 8, 8), -2048, 2048)
    _same(tops.dequantize_8x8(torch.from_numpy(coefs), torch.from_numpy(qp),
                              intra, is_luma),
          jops.dequantize_8x8(jnp.asarray(coefs), jnp.asarray(qp), intra,
                              is_luma))


def test_block_variance_wraps_int32():
    mbs = _rand_blocks(9, (200, 16, 16), -600, 600)
    mbs[0] = 32767           # sum^2 and sum of squares overflow int32
    mbs[1] = -32768
    mbs[2] = 0               # no nonzero AC -> variance 0
    mbs[3] = 0
    mbs[3, 0, 0] = 500       # DC alone is excluded
    got = tops.block_variance2(torch.from_numpy(mbs))
    _same(got, jops.block_variance2(jnp.asarray(mbs)))
    # a constant block has variance 0 in exact arithmetic: the int32 wrap
    # of the reference makes it nonzero, and both ports must agree on it
    assert int(got[0]) != 0


@pytest.mark.parametrize("quality", [1, 4, 16, 29, 31])
def test_adaptive_qp(quality):
    mbs = _rand_blocks(10, (300, 16, 16), -400, 400)
    mbs[:50] //= 100  # low-variance blocks
    _same(tops.adaptive_qp(torch.tensor(quality, dtype=torch.int32),
                           torch.from_numpy(mbs)),
          jops.adaptive_qp(quality, jnp.asarray(mbs)))


@pytest.mark.parametrize("name", ["lerp_half", "lerp_quarter"])
def test_lerps(name):
    a = _rand_blocks(11, 3000)
    b = _rand_blocks(12, 3000)
    _same(getattr(tops, name)(torch.from_numpy(a), torch.from_numpy(b)),
          getattr(jops, name)(jnp.asarray(a), jnp.asarray(b)))


def test_block_layouts():
    plane = _rand_blocks(13, (48, 80))
    tp, jp = torch.from_numpy(plane), jnp.asarray(plane)
    for size in (8, 16):
        _same(tops.plane_to_blocks(tp, size), jops.plane_to_blocks(jp, size))
        blocks = tops.plane_to_blocks(tp, size)
        _same(tops.blocks_to_plane(blocks, 48, 80), plane)
    mbs = tops.plane_to_blocks(tp, 16)
    _same(tops.mb_quads(mbs), jops.mb_quads(jops.plane_to_blocks(jp, 16)))
    _same(tops.quads_to_mb(tops.mb_quads(mbs)), mbs.numpy())


def test_yuv420_to_rgb():
    rng = np.random.default_rng(14)
    y = rng.integers(-40, 320, (32, 48)).astype(np.int32)
    u = rng.integers(-40, 300, (16, 24)).astype(np.int32)
    v = rng.integers(-40, 300, (16, 24)).astype(np.int32)
    _same(tops.yuv420_to_rgb(*map(torch.from_numpy, (y, u, v))),
          jops.yuv420_to_rgb(*map(jnp.asarray, (y, u, v))))
