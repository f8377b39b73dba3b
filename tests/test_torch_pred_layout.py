"""K3's and K4's thread layouts (csrc/pred.cu) modelled on the CPU, no
card needed.

Both kernels give one thread four consecutive output samples (one 16-byte
store). K3 gather_windows_kernel takes the 16-byte groups of the flat
(N, B, B) window output in order, so a group may straddle a window row;
its three-plane launch gives the first blocks to the luma windows, then U,
then V. K4 pred_planes_kernel takes, per MB of each plane, the groups of
its block rows in order (4 a luma row, 2 a chroma row), the planes split
by block index the same way. These tests model the launchers' grids and
the kernels' index arithmetic in PyTorch, with THREADS and the built
geometries read from pred.cu, and check that every output sample is
written exactly once with no index at or above 2^31, at one MB column,
one MB row, 1080p and an MB count that no block's MB group divides; then
that the modelled gathers equal the plain versions (gather_windows_plain,
pred_planes_plain), clamped offsets, bad slots and sub-pel indices
outside 0..7 included; and that gather_windows_yuv's plain version is the
three single-plane calls of motion.inter_search.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from cairo_tpu_torch.gpu import cuda_pred, ops

PRED_CU = (pathlib.Path(cuda_pred.__file__).parent / "csrc" /
           "pred.cu").read_text()
THREADS = int(re.search(r"constexpr int THREADS = (\d+);", PRED_CU)[1])
MB = 16
RING = 4
I64 = torch.int64
LIMIT = 2 ** 31

# (width, height): one MB column, one MB row, 1080p, and 13 x 3 = 39 MBs,
# which neither K4's luma group of 4 MBs a block nor its chroma group of
# 16 divides
SIZES = [(16, 96), (96, 16), (1920, 1088), (208, 48)]
SMALL = [s for s in SIZES if s != (1920, 1088)]


def _ids(s):
    return f"{s[0]}x{s[1]}"


def _blocks(groups):
    return -(-groups // THREADS)


def _threads(grid):
    """(block index, flat thread index within the plane's range) of every
    launched thread, as (grid, THREADS) int64 tensors."""
    blk = torch.arange(grid, dtype=I64)[:, None]
    return blk, blk * THREADS + torch.arange(THREADS, dtype=I64)[None]


def _split(grid, first, second):
    """pred.cu's plane split by block index: plane 0 for blocks below
    `first`, plane 1 for the next `second`, plane 2 for the rest; returns
    (plane, group index within the plane)."""
    blk, _ = _threads(grid)
    b = blk - first
    is_v = b >= second
    plane = torch.where(blk < first, 0, torch.where(is_v, 2, 1))
    local = torch.where(blk < first, blk, torch.where(is_v, b - second, b))
    tid = torch.arange(THREADS, dtype=I64)[None]
    return plane.expand(-1, THREADS), local * THREADS + tid


# ----------------------------------------------------------------- K3

# plane geometry per K3 launch kind: (block, pad, offset shift) per plane
K3_MODES = {
    "yuv": [(18, 17, 0), (10, 9, 1), (10, 9, 1)],
    "luma": [(18, 17, 0)],
    "chroma": [(10, 9, 0)],
}


def _k3_launch(mode, w, h):
    """The threads of one K3 launch that store: per plane, (plane shape,
    (block, pad, shift), wb, n_mb, g) with g the stored 16-byte groups."""
    if mode == "yuv":
        wb, n_mb = w // MB, (h // MB) * (w // MB)
        yb, cb = _blocks(n_mb * 81), _blocks(n_mb * 25)
        plane, g = _split(yb + 2 * cb, yb, cb)
        shapes = [(h, w), (h // 2, w // 2), (h // 2, w // 2)]
    else:
        ph, pw = (h, w) if mode == "luma" else (h // 2, w // 2)
        block = K3_MODES[mode][0][0]
        wb, n_mb = pw // (block - 2), (ph // (block - 2)) * (pw // (block - 2))
        _, g = _threads(_blocks(n_mb * block * block // 4))
        plane = torch.zeros_like(g)
        shapes = [(ph, pw)]
    out = []
    for p, (shape, geom) in enumerate(zip(shapes, K3_MODES[mode])):
        groups = geom[0] * geom[0] // 4
        sel = (plane == p) & (g // groups < n_mb)
        out.append((shape, geom, wb, n_mb, g[sel]))
    return out


@pytest.mark.parametrize("size", SIZES, ids=_ids)
@pytest.mark.parametrize("mode", list(K3_MODES))
def test_k3_threads_write_each_window_sample_once(mode, size):
    for shape, (block, _, _), _, n_mb, g in _k3_launch(mode, *size):
        flat = (4 * g[:, None] + torch.arange(4)).reshape(-1)
        assert int(flat.max()) < LIMIT and int(g.max()) * 4 < LIMIT
        counts = torch.bincount(flat, minlength=n_mb * block * block)
        assert counts.numel() == n_mb * block * block
        assert bool((counts == 1).all())
        # every sample address inside the plane is below 2^31 as well
        assert shape[0] * shape[1] < LIMIT


def _k3_model(mode, ring, slot, mx, my, w, h):
    """The windows as the modelled K3 threads of a launch for a w x h
    frame gather them from the stacks `ring`."""
    out = []
    for (ph, pw), (block, pad, shift), wb, n_mb, g in _k3_launch(mode, w, h):
        stack = ring[len(out)] if mode == "yuv" else ring[0]
        plane = stack[slot].long().reshape(-1)
        groups = block * block // 4
        n = g // groups
        f = (g - n * groups) * 4
        row = n // wb
        ox = ((mx.long()[n] >> shift) + pad - 1).clamp(0, 2 * pad - 2)
        oy = ((my.long()[n] >> shift) + pad - 1).clamp(0, 2 * pad - 2)
        y0 = row * (block - 2) - pad + oy
        x0 = (n - row * wb) * (block - 2) - pad + ox
        r, c = f // block, f - (f // block) * block
        win = torch.zeros(n_mb * block * block, dtype=I64)
        for j in range(4):
            y, x = y0 + r, x0 + c
            inside = (y >= 0) & (y < ph) & (x >= 0) & (x < pw)
            idx = torch.where(inside, y * pw + x, 0)
            win[4 * g + j] = torch.where(inside, plane[idx], 0)
            c = c + 1
            wrap = c == block
            c = torch.where(wrap, 0, c)
            r = torch.where(wrap, r + 1, r)
        out.append(win.to(torch.int32).reshape(n_mb, block, block))
    return out


def _ring(rng, h, w):
    return tuple(torch.from_numpy(rng.integers(-600, 600, (RING,) + s)
                                  .astype(np.int16))
                 for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))


def _motion(rng, n, reach):
    """(mx, my) int32 in [-reach, reach] with the first MBs at +-40, which
    every window clamps."""
    mx = rng.integers(-reach, reach + 1, n).astype(np.int32)
    my = rng.integers(-reach, reach + 1, n).astype(np.int32)
    mx[:n // 3] = 40
    my[n // 3:2 * n // 3] = -40
    return torch.from_numpy(mx), torch.from_numpy(my)


@pytest.mark.parametrize("size", SMALL, ids=_ids)
@pytest.mark.parametrize("mode", list(K3_MODES))
def test_k3_model_equals_plain(mode, size):
    w, h = size
    rng = np.random.default_rng(w * 7 + h)
    ring = _ring(rng, h, w)
    slot = torch.tensor([2], dtype=torch.int32)
    # one offset per MB; a chroma-only call takes chroma offsets
    mx, my = _motion(rng, (h // MB) * (w // MB), 10 if mode == "chroma"
                     else 20)
    if mode == "yuv":
        want = cuda_pred.gather_windows_yuv_plain(ring, slot, mx, my)
        got = _k3_model(mode, ring, 2, mx, my, w, h)
    else:
        (block, pad, _), = K3_MODES[mode]
        stack = ring[0] if mode == "luma" else ring[1]
        want = (cuda_pred.gather_windows_plain(stack, slot, mx, my, block,
                                               pad),)
        got = _k3_model(mode, (stack,), 2, mx, my, w, h)
    for g, wnt in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), wnt.numpy())


@pytest.mark.parametrize("slot", range(RING))
def test_gather_windows_yuv_cpu_is_three_plain_calls(slot):
    """gather_windows_yuv on the CPU equals the three single-plane calls
    motion.inter_search made before it, chroma at (mx >> 1, my >> 1)."""
    rng = np.random.default_rng(30 + slot)
    h, w = 48, 80
    ring = _ring(rng, h, w)
    mx, my = _motion(rng, (h // MB) * (w // MB), 20)
    s = torch.tensor([slot], dtype=torch.int32)
    got = cuda_pred.gather_windows_yuv(ring, s, mx, my)
    want = (cuda_pred.gather_windows_plain(ring[0], s, mx, my, 18, 17),
            cuda_pred.gather_windows_plain(ring[1], s, mx >> 1, my >> 1, 10,
                                           9),
            cuda_pred.gather_windows_plain(ring[2], s, mx >> 1, my >> 1, 10,
                                           9))
    for g, wnt in zip(got, want, strict=True):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), wnt.numpy())


# ----------------------------------------------------------------- K4

def _k4_launch(w, h):
    """The threads of one K4 launch that store: per plane, (plane shape,
    block size, dst index, MB n, block row, first column)."""
    wb, n_mb = w // MB, (h // MB) * (w // MB)
    yb, cb = _blocks(n_mb * 64), _blocks(n_mb * 16)
    plane, t = _split(yb + 2 * cb, yb, cb)
    out = []
    for p, (ph, pw) in enumerate(((h, w), (h // 2, w // 2),
                                  (h // 2, w // 2))):
        blk = MB if p == 0 else MB // 2
        gpr = blk // 4
        groups = blk * gpr
        tp = t[plane == p]
        n = tp // groups
        tp, n = tp[n < n_mb], n[n < n_mb]
        k = tp - n * groups
        row = n // wb
        y = row * blk + k // gpr
        x = (n - row * wb) * blk + (k % gpr) * 4
        out.append(((ph, pw), blk, y * pw + x, n, y, x))
    return out


@pytest.mark.parametrize("size", SIZES, ids=_ids)
def test_k4_threads_write_each_plane_sample_once(size):
    for (ph, pw), _, dst, _, y, x in _k4_launch(*size):
        assert bool((x % 4 == 0).all())      # 16-byte aligned stores
        flat = (dst[:, None] + torch.arange(4)).reshape(-1)
        assert int(flat.max()) < LIMIT
        counts = torch.bincount(flat, minlength=ph * pw)
        assert counts.numel() == ph * pw
        assert bool((counts == 1).all())
        # the sub-pel window reaches 33 samples past the plane at most
        assert (ph + 33) * pw < LIMIT


def _dir(d):
    """common.cuh's dir_x, dir_y."""
    e = d + (d >= 4).long()
    return e % 3 - 1, e // 3 - 1


def test_kernel_direction_formula_is_the_plain_table():
    dx, dy = _dir(torch.arange(8))
    assert list(zip(dx.tolist(), dy.tolist())) == list(cuda_pred.DIRS)


def _row4(words, s, y, x, ph, pw):
    """pred.cu's row4: samples x .. x + 3 of row y of slot s, from the two
    aligned 8-byte words at or after x & ~3 (each zero when it lies
    outside the plane) and a funnel shift. words: the ring stack's memory
    as (RING, ph, pw / 4) uint64 words."""
    xa = x & ~3
    sh = (16 * (x - xa)).astype(np.uint64)

    def word(xw):
        inside = (y >= 0) & (y < ph) & (xw >= 0) & (xw < pw)
        w = words[s.clip(0, RING - 1), y.clip(0, ph - 1),
                  (xw // 4).clip(0, pw // 4 - 1)]
        return np.where(inside, w, np.uint64(0))

    lo, hi = word(xa), word(xa + 4)
    with np.errstate(over="ignore"):
        both = (lo >> sh) | (hi << (np.uint64(64) - sh))
    bits = np.where(sh == 0, lo, both)
    return [((bits >> np.uint64(16 * j)) & np.uint64(0xFFFF)).astype(
        np.uint16).view(np.int16).astype(np.int64) for j in range(4)]


def _k4_model(ring, fields, ypad, cpad):
    slot, mx, my, spp, spa, spi, zero = (f.long().numpy() for f in fields)
    h, w = ring[0].shape[1:]
    out = []
    for p, ((ph, pw), blk, dst, n, y, x) in enumerate(_k4_launch(w, h)):
        dst, n, y, x = (a.numpy() for a in (dst, n, y, x))
        pad, shift = (ypad, 0) if p == 0 else (cpad, 1)
        words = ring[p].numpy().view(np.uint64)
        s = slot[n]
        live = (zero[n] == 0) & (s >= 0) & (s < RING)
        yb = y - pad + ((my[n] >> shift) + pad).clip(0, 2 * pad)
        xb = x - pad + ((mx[n] >> shift) + pad).clip(0, 2 * pad)
        ddx, ddy = (a.numpy() for a in _dir(torch.from_numpy(
            spi[n].clip(0, 7))))
        yn = y - pad + (((my[n] + ddy) >> shift) + pad).clip(0, 2 * pad)
        xn = x - pad + (((mx[n] + ddx) >> shift) + pad).clip(0, 2 * pad)
        plane = np.zeros(ph * pw, np.int64)
        base = _row4(words, s, yb, xb, ph, pw)
        nbr = _row4(words, s, yn, xn, ph, pw)
        for j in range(4):
            b, t = torch.from_numpy(base[j]), torch.from_numpy(nbr[j])
            v = torch.where(torch.from_numpy(spa[n] != 0),
                            ops.lerp_quarter(b, t), ops.lerp_half(b, t))
            v = torch.where(torch.from_numpy(spp[n] != 0), v, b)
            plane[dst + j] = np.where(live, v.numpy(), 0)
        out.append(plane.astype(np.int32).reshape(ph, pw))
    return out


@pytest.mark.parametrize("size", SMALL, ids=_ids)
@pytest.mark.parametrize("pads", cuda_pred.PRED_PADS,
                         ids=lambda p: f"{p[0]}-{p[1]}")
def test_k4_model_equals_plain(pads, size):
    """Every slot and the bad slots -1 and 4, sp_index outside 0..7, both
    lerp amounts, a fifth of the MBs intra, offsets the window clamps."""
    w, h = size
    rng = np.random.default_rng(w + 3 * h + pads[0])
    ring = _ring(rng, h, w)
    n = (h // MB) * (w // MB)
    mx, my = _motion(rng, n, pads[0] - 2)
    fields = (torch.from_numpy(rng.integers(-1, 5, n).astype(np.int32)), mx,
              my, torch.from_numpy(rng.random(n) < 0.6),
              torch.from_numpy(rng.random(n) < 0.5),
              torch.from_numpy(rng.integers(-3, 11, n).astype(np.int32)),
              torch.from_numpy(rng.random(n) < 0.2))
    got = _k4_model(ring, fields, *pads)
    want = cuda_pred.pred_planes_plain(*ring, *fields, *pads)
    for g, wnt in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, wnt.numpy())


def test_kernel_geometries_are_the_wrappers():
    """pred.cu builds K3 for cuda_pred.WINDOWS and K4 for
    cuda_pred.PRED_PADS, the geometries the wrappers let through."""
    y_pad = int(re.search(r"Y_WIN = MB \+ 2, Y_WPAD = (\d+);", PRED_CU)[1])
    c_pad = int(re.search(r"C_WIN = MB / 2 \+ 2, C_WPAD = (\d+);",
                          PRED_CU)[1])
    assert cuda_pred.WINDOWS == ((MB + 2, y_pad), (MB // 2 + 2, c_pad))
    built = {tuple(map(int, m)) for m in re.findall(
        r"pred_planes_kernel<(\d+), (\d+)><<<", PRED_CU)}
    assert built == set(cuda_pred.PRED_PADS)
