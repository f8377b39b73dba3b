"""cairo_tpu_torch.analysis against cairo_tpu.analysis, and the 4x4 and
16x16 library transforms of cairo_tpu_torch.gpu.ops against
cairo_tpu.tpu.ops and cairo_tpu.cpuref.transform, on the CPU, exact
(tolerance 0): seeded int16 blocks in the residual range, over the whole
int16 range with -32768 present (where the saturating abs and the int32
wraps bind), all zero and with a zero DC; numpy inputs on device="cpu"
and CPU tensors; format_macroblock's text."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cairo_tpu import analysis as ja
from cairo_tpu.cpuref import transform as jref
from cairo_tpu.tpu import ops as jops
from cairo_tpu_torch import analysis as ta
from cairo_tpu_torch.gpu import ops as tops

RANGES = {"residual": (-300, 301), "int16": (-32768, 32768),
          "small": (-2, 3)}
N = 256


def _blocks(kind, size, n=N, seed=0):
    rng = np.random.default_rng(seed + size)
    lo, hi = RANGES[kind]
    b = rng.integers(lo, hi, (n, size, size)).astype(np.int16)
    b[0] = -32768                   # |-32768| saturates in the C abs
    b[1] = 0
    b[2, 0, 0] = 0
    b[3, 5 % size, 2] = -32768
    b[4] = 32767
    return b


def _inputs(kind, seed=0):
    y = [_blocks(kind, 16, seed=seed + i) for i in range(2)]
    c = [_blocks(kind, 8, seed=seed + 2 + i) for i in range(4)]
    y[1][5] = y[0][5]               # a zero difference
    return y, c


METRICS = {
    "block_sad_delta": lambda m, y, c, kw: m.block_sad(y[0], **kw),
    "block_sad": lambda m, y, c, kw: m.block_sad(y[0], y[1], **kw),
    "block_mse": lambda m, y, c, kw: m.block_mse(y[0], y[1], **kw),
    "block_ssd": lambda m, y, c, kw: m.block_ssd(y[0], y[1], **kw),
    "block_mad": lambda m, y, c, kw: m.block_mad(y[0], c[0], c[1], y[1],
                                                 c[2], c[3], **kw),
    "block_mean": lambda m, y, c, kw: m.block_mean(y[0], **kw),
    "nonzero_block_mean": lambda m, y, c, kw: m.nonzero_block_mean(y[0],
                                                                   **kw),
    "block_variance": lambda m, y, c, kw: m.block_variance(y[0], **kw),
    "block_variance2": lambda m, y, c, kw: m.block_variance2(y[0], **kw),
    "block_variance3": lambda m, y, c, kw: m.block_variance3(y[0], **kw),
}


@pytest.mark.parametrize("kind", list(RANGES))
@pytest.mark.parametrize("name", list(METRICS))
def test_metric_matches_cairo_tpu(name, kind):
    y, c = _inputs(kind)
    want = np.asarray(METRICS[name](ja, y, c, {}))
    got = METRICS[name](ta, y, c, {"device": "cpu"})
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # CPU tensors in: computed where they lie, same values
    ty = [torch.from_numpy(a) for a in y]
    tc = [torch.from_numpy(a) for a in c]
    np.testing.assert_array_equal(METRICS[name](ta, ty, tc, {}).numpy(),
                                  want)


def test_quirks_bind():
    """The cases the quirks decide are in the data: the saturating abs,
    the |x - mean| variance and the int32 wrap of the squares."""
    y, c = _inputs("int16")
    assert int(ta.block_sad(y[0][:1], device="cpu")) == 256 * 32767
    assert int(ta.nonzero_block_mean(y[0][:1], device="cpu")) == 32767
    ssd = ta.block_ssd(y[0], y[1], device="cpu").numpy()
    exact = ((y[0].astype(np.int64) - y[1]) ** 2).sum(axis=(1, 2))
    assert (ssd != exact).any()
    flat = np.full((1, 16, 16), 7, np.int16)
    flat[0, 0, :8] = -9
    mean = int(ta.block_mean(flat, device="cpu"))
    want = (np.abs(flat.astype(np.int32) - mean).sum() + 128) >> 8
    assert int(ta.block_variance(flat, device="cpu")) == want


def test_single_block_and_batch_shapes():
    y, c = _inputs("residual")
    one = ta.block_variance2(y[0][7], device="cpu")
    assert one.shape == () and int(one) == int(ja.block_variance2(y[0][7]))
    grid = y[0][:12].reshape(3, 4, 16, 16)
    np.testing.assert_array_equal(
        ta.block_sad(grid, device="cpu").numpy(), ja.block_sad(grid))


def test_format_macroblock_text_matches():
    y, c = _inputs("int16")
    assert ta.format_macroblock(y[0][0], c[0][0], c[1][0]) == \
        ja.format_macroblock(y[0][0], c[0][0], c[1][0])
    assert ta.format_macroblock(torch.from_numpy(y[0][3])) == \
        ja.format_macroblock(y[0][3])


TRANSFORMS = {"fdct4": 4, "idct4": 4, "fdct16": 16, "idct16": 16}
LINES = ("fdct16_line", "idct16_line")


@pytest.mark.parametrize("kind", ["residual", "int16"])
@pytest.mark.parametrize("name", list(TRANSFORMS) + list(LINES))
def test_transform_matches_cairo_tpu(name, kind):
    size = TRANSFORMS.get(name, 16)
    x = _blocks(kind, size, n=1000, seed=5)
    if name in LINES:
        x = x.reshape(-1, 16)
    got = getattr(tops, name)(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == x.shape
    got = got.numpy()
    np.testing.assert_array_equal(
        got, np.asarray(getattr(jops, name)(jnp.asarray(x))))
    np.testing.assert_array_equal(got, getattr(jref, name)(x))
