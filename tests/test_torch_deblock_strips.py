"""K8's design (csrc/deblock.cu) checked on the CPU, no card needed.

  * The plane falls into independent column strips [8k-4, 8k+4): on the
    port's plain deblock_plane, a strip's output does not change when
    every column outside it is randomized, luma and chroma, the two
    4-column edge strips included.
  * A numpy model of K8's walk, with STEP, LANES, THREADS and the alpha
    and beta tables read from deblock.cu: the launcher's grid (Y's warps,
    then U's, then V's), the lanes of each strip and the column each
    holds, the register window (4 rows above the band, the band's 8 rows,
    the next band's loaded ahead), the taps of a vertical edge from the
    strip's lanes as __shfl_sync gives them, strengths and QPs computed
    from the MB maps inline, and the points at which rows are stored. The
    model reads every input sample once, writes every output sample once,
    and equals cairo_tpu.tpu.deblock.deblock_frame, run with JAX on the
    CPU (for the one-band chroma of a frame one MB high, its band-0
    vertical pass: JAX's band loop does not trace there), at one MB, one
    MB row, one MB column and 272x480, with all, no and some copy MBs, q
    0 and 31, non-zero q on copy MBs, samples far beyond int16, and int32
    and uint8 q maps.
  * The same cases through cuda_deblock.deblock_frame on CPU tensors
    (its plain version) equal JAX too.
"""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cairo_tpu.tpu import deblock as jdeblock
from cairo_tpu_torch import tables
from cairo_tpu_torch.gpu import cuda_deblock, deblock
from util_deblock import KINDS, SIZES, deblock_case

CU = (pathlib.Path(cuda_deblock.__file__).parent / "csrc" /
      "deblock.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CU)[1])


def _table(name):
    body = re.search(rf"__constant__ int {name}\[QP_LEVELS\] = \{{([^}}]*)\}}",
                     CU)[1]
    return np.array([int(x) for x in body.split(",")], np.int32)


STEP, LANES, THREADS = _const("STEP"), _const("LANES"), _const("THREADS")
QP_LEVELS = _const("QP_LEVELS")
ALPHA, BETA = _table("ALPHA"), _table("BETA")
I32 = np.int32


def _ids(s):
    return f"{s[0]}x{s[1]}"


def test_kernel_constants():
    np.testing.assert_array_equal(ALPHA, tables.DEBLOCK_ALPHA)
    np.testing.assert_array_equal(BETA, tables.DEBLOCK_BETA)
    assert QP_LEVELS == len(tables.DEBLOCK_ALPHA) == len(tables.DEBLOCK_BETA)
    # a strip is one lane per column of [8k-4, 8k+4); a block is one warp
    # of whole strips
    assert STEP == deblock.STEP == LANES == 8
    assert THREADS == 32 and THREADS % LANES == 0


# ------------------------------------------------------ strip independence

def _strips(w):
    """The column ranges of the plane's strips, edge strips clipped."""
    return [(max(0, 8 * k - 4), min(w, 8 * k + 4)) for k in range(w // 8 + 1)]


@pytest.mark.parametrize("luma,frame", [(True, (64, 96)), (False, (96, 128))],
                         ids=["luma 64x96", "chroma 48x64"])
def test_strips_are_independent(luma, frame):
    rng = np.random.default_rng(5)
    y, u, _, copy, q = deblock_case("mixed", *frame, seed=5)
    plane, mb = (y, 16) if luma else (u, 8)
    copy, q = torch.from_numpy(copy), torch.from_numpy(q)
    want = deblock.deblock_plane(torch.from_numpy(plane), copy, q, mb,
                                 luma).numpy()
    assert not np.array_equal(want, plane)  # the filter acted
    strips = _strips(plane.shape[1])
    assert sum(b - a for a, b in strips) == plane.shape[1]
    for a, b in strips:
        noisy = rng.integers(-300, 600, plane.shape).astype(np.int32)
        noisy[:, a:b] = plane[:, a:b]
        got = deblock.deblock_plane(torch.from_numpy(noisy), copy, q, mb,
                                    luma).numpy()
        np.testing.assert_array_equal(got[:, a:b], want[:, a:b],
                                      err_msg=f"strip [{a}, {b})")


# ------------------------------------------------------ the model of K8

def warps_for(w):
    """cairo_deblock_frame's warps for a plane of width w."""
    return -(-(w // STEP + 1) * LANES // THREADS)


def grid(h, w):
    """The launch's blocks: (plane index, first block, blocks) for Y, U
    and V, in grid order."""
    wy, wc = warps_for(w), warps_for(w // 2)
    return [(0, 0, wy), (1, wy, wc), (2, wy + wc, wc)]


def _rdp(n, d):
    """ops.rounded_div_pos on int32 arrays, as common.cuh computes it."""
    half = d // 2
    m = np.where(n < 0, n - half, n + half)
    a = np.where(m < 0, -m, m)
    return np.where(m < 0, -(a // d), a // d).astype(I32)


def _filter(t, s, qp, luma):
    """deblock.cu's filter on int32 lane arrays: new p2 .. q2."""
    p3, p2, p1, p0, q0, q1, q2, q3 = t
    level = np.clip(qp, 0, QP_LEVELS - 1)
    alpha, beta = ALPHA[level], BETA[level]
    keep = ((np.abs(p0 - q0) >= alpha) | (np.abs(p1 - p0) >= beta)
            | (np.abs(q1 - q0) >= beta) | (s == 0))
    is2 = s == 2
    np0 = np.where(is2, _rdp(p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1, 8),
                   _rdp((q0 + p0) * 4 + p1 - q1, 8))
    nq0 = np.where(is2, _rdp(p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2, 8),
                   _rdp((q0 + p0) * 4 + q1 - p1, 8))
    if luma:
        np1 = np.where(is2, _rdp(p2 + p1 + p0 + q0, 4),
                       _rdp(p2 * 4 + p0 * 2 + q0 * 2, 8))
        nq1 = np.where(is2, _rdp(p0 + q0 + q1 + q2, 4),
                       _rdp(q2 * 4 + q0 * 2 + p0 * 2, 8))
        np2 = np.where(is2, _rdp(2 * p3 + 3 * p2 + p1 + p0 + q0, 8), p2)
        nq2 = np.where(is2, _rdp(2 * q3 + 3 * q2 + q1 + q0 + p0, 8), q2)
    else:
        np1 = np.where(is2, _rdp(p2 + p1 + p0 + q0, 4), p1)
        nq1 = np.where(is2, _rdp(p0 + q0 + q1 + q2, 4), q1)
        np2, nq2 = p2, q2
    return [np.where(keep, old, new) for old, new in
            ((p2, np2), (p1, np1), (p0, np0), (q0, nq0), (q1, nq1),
             (q2, nq2))]


def _strength_qp(ca, cb, qa, qb):
    s = np.where(ca & cb, 0, np.where(ca != cb, 1, 2))
    qp = np.where(~ca & ~cb, (qa + qb) >> 1,
                  np.where(~ca, qa, np.where(~cb, qb, 0)))
    return s, qp.astype(I32)


def model_plane(inp, copy, q, luma, lanes):
    """deblock.cu's walk over one plane, its `lanes` lanes at once;
    returns the output plane and per-sample read and write counts."""
    mbc = 2 if luma else 1
    h, w = inp.shape
    g = np.arange(lanes)
    x, k, tap = g - LANES // 2, g // LANES, g % LANES
    cells_x, bands = w // STEP, h // STEP
    valid = (x >= 0) & (x < w)
    edge = (k >= 1) & (k < cells_x)
    mx = np.where(valid, x // STEP // mbc, 0)
    ma = np.where(edge, (k - 1) // mbc, 0)
    mb = np.where(edge, k // mbc, 0)
    xs = x[valid]
    out = np.zeros((h, w), I32)
    reads = np.zeros((h, w), np.int64)
    writes = np.zeros((h, w), np.int64)

    def load(row):
        reads[row, xs] += 1
        v = np.zeros(lanes, I32)
        v[valid] = inp[row, xs]
        return v

    def store(row, v):
        writes[row, xs] += 1
        out[row, xs] = v[valid]

    def fields(r, c):
        return copy[r, c] != 0, q[r, c].astype(I32)

    def shfl(v, j):  # __shfl_sync(FULL, v, j, LANES)
        return v[g // LANES * LANES + j]

    cur = [load(i) for i in range(STEP)]
    (c_cur, q_cur), (ca, qa), (cb, qb) = (fields(0, c) for c in (mx, ma, mb))
    prev = c_prev = q_prev = nxt = None
    for b in range(bands):
        y = b * STEP
        if b + 1 < bands:
            nxt = [load(y + STEP + i) for i in range(STEP)]
            r = (b + 1) // mbc
            n_fields = [fields(r, c) for c in (mx, ma, mb)]
        if b > 0:
            s, qp = _strength_qp(c_prev, c_cur, q_prev, q_cur)
            n = _filter(prev + cur[:4], s, qp, luma)
            prev[1:4], cur[0:3] = n[0:3], n[3:6]
            for i in range(LANES // 2):
                store(y - LANES // 2 + i, prev[i])
        s, qp = _strength_qp(ca, cb, qa, qb)
        for i in range(STEP):
            n = _filter([shfl(cur[i], j) for j in range(LANES)], s, qp, luma)
            v = cur[i]
            for j in range(1, LANES - 1):
                v = np.where(tap == j, n[j - 1], v)
            cur[i] = np.where(edge, v, cur[i])
        for i in range(LANES // 2):
            store(y + i, cur[i])
        prev, cur = cur[LANES // 2:], nxt
        c_prev, q_prev = c_cur, q_cur
        if b + 1 < bands:
            (c_cur, q_cur), (ca, qa), (cb, qb) = n_fields
    for i in range(LANES // 2):
        store(h - LANES // 2 + i, prev[i])
    return out, reads, writes


def model_frame(y, u, v, copy, q):
    """The launch: each plane walked by the lanes of its blocks."""
    h, w = y.shape
    planes = (y, u, v)
    outs = []
    for plane, _, blocks in grid(h, w):
        out, reads, writes = model_plane(planes[plane], copy, q, plane == 0,
                                         blocks * THREADS)
        assert (reads == 1).all(), "an input sample read other than once"
        assert (writes == 1).all(), "an output sample written other than once"
        outs.append(out)
    return outs


@pytest.mark.parametrize("size", SIZES + [(1088, 1920)], ids=_ids)
def test_grid_covers_every_column_once(size):
    h, w = size
    blocks = grid(h, w)
    assert blocks[-1][1] + blocks[-1][2] == sum(b[2] for b in blocks)
    for plane, _, n in blocks:
        pw = w if plane == 0 else w // 2
        g = np.arange(n * THREADS)
        x = g - LANES // 2
        held = x[(x >= 0) & (x < pw)]
        np.testing.assert_array_equal(np.sort(held), np.arange(pw))
        # every strip's lanes in one warp
        assert (g // LANES * LANES // THREADS == g // THREADS).all()
    if size == (1088, 1920):   # 61 warps for Y, 31 each for U and V
        assert [b[2] for b in blocks] == [61, 31, 31]


def _jax_plane(plane, copy, q, mb, luma):
    if plane.shape[0] > STEP:
        return jdeblock.deblock_plane(plane, copy, q, mb, luma)
    # a one-band plane (the 8x8 chroma of a one-MB frame): JAX cannot
    # trace deblock_plane's band loop there (it indexes the empty map of
    # horizontal edges), so the reference is its band-0 vertical pass,
    # all the filtering such a plane has
    vs, vqp, _, _ = jdeblock._edge_maps(copy, q, 1, plane.shape[1] // STEP,
                                        mb // STEP)
    return jdeblock._vertical_pass(plane, vs[0], vqp[0], luma)


@functools.lru_cache(maxsize=None)
def _jax_frame(kind, h, w):
    """cairo_tpu.tpu.deblock.deblock_frame's planes, plane by plane."""
    y, u, v, copy, q = (jnp.asarray(a) for a in deblock_case(kind, h, w))
    if h > 2 * STEP:
        out = jdeblock.deblock_frame(y, u, v, copy, q)
    else:
        out = (_jax_plane(y, copy, q, 16, True),
               _jax_plane(u, copy, q, 8, False),
               _jax_plane(v, copy, q, 8, False))
    return tuple(np.asarray(p) for p in out)


def _check_filtered(kind, got, y):
    if kind not in ("q0", "all_copy") and y.shape != (16, 16):
        assert not np.array_equal(got[0], y)   # the filter acted


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", SIZES, ids=_ids)
def test_model_matches_jax(size, kind):
    y, u, v, copy, q = deblock_case(kind, *size)
    got = model_frame(y, u, v, copy, q)
    for name, g, want in zip("yuv", got, _jax_frame(kind, *size)):
        np.testing.assert_array_equal(g, want, err_msg=name)
    _check_filtered(kind, got, y)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", SIZES, ids=_ids)
def test_wrapper_on_cpu_matches_jax(size, kind):
    case = deblock_case(kind, *size)
    tensors = [torch.from_numpy(a) for a in case]
    before = cuda_deblock.LAUNCHES["deblock_frame"]
    got = cuda_deblock.deblock_frame(*tensors)
    assert cuda_deblock.LAUNCHES["deblock_frame"] == before
    for name, g, want in zip("yuv", got, _jax_frame(kind, *size)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), want, err_msg=name)
    for t, a in zip(tensors, case):   # the inputs stay as they were
        np.testing.assert_array_equal(t.numpy(), a)
    _check_filtered(kind, [g.numpy() for g in got], case[0])
