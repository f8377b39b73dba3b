"""K8's design (csrc/deblock.cu) checked on the CPU, no card needed.

  * The kernel's constants and the alpha and beta tables, read from
    deblock.cu.
  * The three-pass dependence: a vectorised numpy version of the passes
    (1: vertical edges on rows r % 8 >= 4 and band 0's rows 0 .. 3 of
    the input; 2: every horizontal edge, its p side from pass 1, its q
    side the input; 3: vertical edges on rows 8b .. 8b+3, b >= 1) equals
    cairo_tpu.tpu.deblock.deblock_frame, run with JAX on the CPU (for the
    one-band chroma of a frame one MB high, its band-0 vertical pass: JAX's
    band loop does not trace there), over the sizes and input kinds of
    tests/util_deblock.py. Filtering row y+3 before the horizontal edge
    at y does not.
  * On the port's plain deblock_plane, a tile's output does not change
    when every sample outside the tile and its 4-sample halo is
    randomised: corner, border and interior tiles, whole and cut by the
    plane, luma and chroma.
  * The launcher's grid (Y's tiles, then U's, then V's) covers every
    output sample once.
  * A numpy model of one block's work, with TH, TW, HALO, PITCH and the
    tables read from deblock.cu: staging in 16-byte chunks clipped to the
    plane, the three passes in place with the kernel's item order
    (every item reads only staged samples, the items of a pass touch
    disjoint samples, and the 8 items of a 16-byte phase of a vertical
    pass meet no bank twice), strengths and QPs from the MB maps per
    item, and the stores. Over the whole grid every output sample is
    written once, and the model equals JAX at every case.
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
from util_deblock import KINDS, SIZES, TILE_SIZES, deblock_case

CU = (pathlib.Path(cuda_deblock.__file__).parent / "csrc" /
      "deblock.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CU)[1])


def _table(name):
    body = re.search(rf"__constant__ int {name}\[QP_LEVELS\] = \{{([^}}]*)\}}",
                     CU)[1]
    return np.array([int(x) for x in body.split(",")], np.int32)


STEP, HALO, TH, TW = _const("STEP"), _const("HALO"), _const("TH"), _const("TW")
PITCH, THREADS, QP_LEVELS = (_const("PITCH"), _const("THREADS"),
                             _const("QP_LEVELS"))
SH, SW = TH + 2 * HALO, TW + 2 * HALO   # staged rows and columns
CHUNKS = SW // 4                         # 16-byte chunks a staged row
ALPHA, BETA = _table("ALPHA"), _table("BETA")
I32 = np.int32


def _ids(s):
    return f"{s[0]}x{s[1]}"


def test_kernel_constants():
    np.testing.assert_array_equal(ALPHA, tables.DEBLOCK_ALPHA)
    np.testing.assert_array_equal(BETA, tables.DEBLOCK_BETA)
    assert QP_LEVELS == len(tables.DEBLOCK_ALPHA) == len(tables.DEBLOCK_BETA)
    # an edge reads 4 samples on each side; tiles are whole cells
    assert STEP == deblock.STEP == 8 and HALO == STEP // 2
    assert TH % STEP == 0 and TW % STEP == 0
    # staged rows of whole 16-byte chunks, 16-byte aligned, an odd number
    # of chunks apart (neighbouring rows of a window in other banks)
    assert SW % 4 == 0 and SW <= PITCH and PITCH % 4 == 0
    assert (PITCH // 4) % 2 == 1
    assert THREADS % 32 == 0 and THREADS <= 1024
    # static shared memory: the staged tile and the alpha/beta table
    assert (SH * PITCH + 2 * QP_LEVELS) * 4 <= 48 * 1024


# ------------------------------------------------------ the filter in numpy

def _rdp(n, d):
    """ops.rounded_div_pos on int32 arrays, as common.cuh computes it."""
    half = d // 2
    m = np.where(n < 0, n - half, n + half)
    a = np.where(m < 0, -m, m)
    return np.where(m < 0, -(a // d), a // d).astype(I32)


def _filter(t, s, qp, luma):
    """deblock.cu's filter on int32 arrays: new p2 .. q2 of taps p3 .. q3,
    both strengths computed and one selected."""
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


def _mb_strength_qp(copy, q, ra, ca, rb, cb):
    """Strength and QP of edges between MBs (ra, ca) and (rb, cb), read
    from the per-MB maps as the kernel reads them."""
    c = copy != 0
    qq = q.astype(I32)
    return _strength_qp(c[ra, ca], c[rb, cb], qq[ra, ca], qq[rb, cb])


# ------------------------------------------------------ the three passes

def _vertical(rows, s, qp, luma):
    """All vertical edges of (R, W) rows, s and qp (R, W / 8 - 1)."""
    out = rows.copy()
    n, w = rows.shape
    nb = w // STEP - 1
    if nb > 0:
        win = out[:, HALO:w - HALO].reshape(n, nb, STEP)
        new = _filter([win[:, :, i].copy() for i in range(STEP)], s, qp,
                      luma)
        for i, v in enumerate(new, 1):
            win[:, :, i] = v
    return out


def three_passes(x, copy, q, luma, row3_late=True):
    """The deblocked plane as passes 1-3 compute it, each over the whole
    plane at once. With row3_late=False, row 8b+3's vertical edges run in
    pass 1 (before the horizontal edge at 8b reads it) instead of pass
    3."""
    h, w = x.shape
    mbc = 2 if luma else 1
    bands = h // STEP
    cy, cx = np.arange(bands) // mbc, np.arange(w // STEP) // mbc
    vs, vqp = _mb_strength_qp(copy, q, cy[:, None], cx[None, :-1],
                              cy[:, None], cx[None, 1:])
    r = np.arange(h)
    band, m = r // STEP, r % STEP
    early = (r >= STEP) & (m == 3) & (not row3_late)

    def vertical(plane, rows):
        out = plane.copy()
        out[rows] = _vertical(plane[rows], vs[band[rows]], vqp[band[rows]],
                              luma)
        return out

    # 1: rows 8b+4 .. 8b+7 and band 0 (and row 8b+3 if not late)
    a = vertical(x, (m >= HALO) | (r < STEP) | early)
    if bands > 1:
        # 2: every horizontal edge, p side pass 1's rows, q side as pass 1
        # left them (the input when row3_late)
        hs, hqp = _mb_strength_qp(copy, q, cy[:-1, None], cx[None, :],
                                  cy[1:, None], cx[None, :])
        s = np.repeat(hs, STEP, axis=1)
        qp = np.repeat(hqp, STEP, axis=1)
        b = a.copy()
        b3 = b.reshape(bands, STEP, w)
        taps = [b3[:-1, HALO + i].copy() for i in range(HALO)]
        taps += [b3[1:, i].copy() for i in range(HALO)]
        new = _filter(taps, s, qp, luma)
        for i in range(3):
            b3[:-1, HALO + 1 + i] = new[i]
            b3[1:, i] = new[3 + i]
        a = b
    # 3: rows 8b .. 8b+3 of bands b >= 1 (8b .. 8b+2 if not late)
    return vertical(a, (r >= STEP) & (m < HALO) & ~early)


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
def test_three_passes_match_jax(size, kind):
    y, u, v, copy, q = deblock_case(kind, *size)
    got = [three_passes(p, copy, q, i == 0) for i, p in enumerate((y, u, v))]
    for name, g, want in zip("yuv", got, _jax_frame(kind, *size)):
        np.testing.assert_array_equal(g, want, err_msg=name)
    _check_filtered(kind, got, y)


def test_row_below_the_edge_is_filtered_after_it():
    """Row y+3's vertical edges run after the horizontal edge at y, which
    reads the row as the input: filtering it first changes the result."""
    differ = []
    for kind in KINDS:
        for size in SIZES:
            y, u, v, copy, q = deblock_case(kind, *size)
            want = _jax_frame(kind, *size)
            for i, p in enumerate((y, u, v)):
                np.testing.assert_array_equal(
                    three_passes(p, copy, q, i == 0), want[i])
                early = three_passes(p, copy, q, i == 0, row3_late=False)
                if not np.array_equal(early, want[i]):
                    differ.append((kind, size, "yuv"[i]))
    assert differ, "filtering row y+3 first never changed the result"


# ------------------------------------------------------ tile independence

def tile_box(h, w, tile):
    """deblock_tile's origin, bands and columns for tile `tile` of an (h,
    w) plane."""
    tiles_x = -(-w // TW)
    y0, x0 = tile // tiles_x * TH, tile % tiles_x * TW
    return y0, x0, (min(y0 + TH, h) - y0) // STEP, min(x0 + TW, w) - x0


# a 208x400 frame: luma 208x400 in 7 x 4 tiles, the last row 16 high and
# the last column 40 wide; chroma 104x200 in 4 x 2, the last 8 x 80
TILE_CASES = [(True, 0, 0), (True, 0, 3), (True, 6, 0), (True, 6, 3),
              (True, 0, 1), (True, 3, 0), (True, 3, 2), (False, 0, 0),
              (False, 3, 1), (False, 1, 1), (False, 2, 0)]


@pytest.mark.parametrize("luma,ty,tx", TILE_CASES,
                         ids=[f"{'luma' if c[0] else 'chroma'} {c[1]},{c[2]}"
                              for c in TILE_CASES])
def test_tile_depends_on_its_halo_only(luma, ty, tx):
    frame = (208, 400)
    # seed 3: the filter acts in every tile of both planes
    y, u, _, copy, q = deblock_case("mixed", *frame, seed=3)
    plane, mb = (y, 16) if luma else (u, 8)
    h, w = plane.shape
    y0, x0, bands, cols = tile_box(h, w, ty * -(-w // TW) + tx)
    y1, x1 = y0 + STEP * bands, x0 + cols
    copy, q = torch.from_numpy(copy), torch.from_numpy(q)
    want = deblock.deblock_plane(torch.from_numpy(plane), copy, q, mb,
                                 luma).numpy()[y0:y1, x0:x1]
    assert not np.array_equal(want, plane[y0:y1, x0:x1])  # the filter acted
    rng = np.random.default_rng([ty, tx, luma])
    for _ in range(2):
        noisy = rng.integers(-300, 600, plane.shape).astype(I32)
        box = (slice(max(0, y0 - HALO), y1 + HALO),
               slice(max(0, x0 - HALO), x1 + HALO))
        noisy[box] = plane[box]
        got = deblock.deblock_plane(torch.from_numpy(noisy), copy, q, mb,
                                    luma).numpy()
        np.testing.assert_array_equal(got[y0:y1, x0:x1], want)


# ------------------------------------------------------ the model of K8

def tiles_for(h, w):
    """cairo_deblock_frame's blocks for an (h, w) plane."""
    return -(-h // TH) * -(-w // TW)


def grid(h, w):
    """The launch's blocks in order: (plane index, tile index)."""
    ty, tc = tiles_for(h, w), tiles_for(h // 2, w // 2)
    out = []
    for blk in range(ty + 2 * tc):
        if blk < ty:
            out.append((0, blk))
        else:
            is_v = blk >= ty + tc
            out.append((2 if is_v else 1, blk - ty - (tc if is_v else 0)))
    return out


@pytest.mark.parametrize("size", SIZES + TILE_SIZES + [(1088, 1920)],
                         ids=_ids)
def test_grid_covers_every_output_once(size):
    h, w = size
    blocks = grid(h, w)
    for plane in range(3):
        ph, pw = (h, w) if plane == 0 else (h // 2, w // 2)
        cover = np.zeros((ph, pw), np.int64)
        for p, tile in blocks:
            if p == plane:
                y0, x0, bands, cols = tile_box(ph, pw, tile)
                assert cols % 4 == 0 and bands >= 1
                cover[y0:y0 + STEP * bands, x0:x0 + cols] += 1
        assert (cover == 1).all()
    if size == (1088, 1920):   # 34 x 16 tiles for Y, 17 x 8 for U and V
        assert len(blocks) == 544 + 2 * 136
        assert [p for p, _ in blocks].count(0) == 544


class Shared:
    """A block's shared tile, with the samples staged so far."""

    def __init__(self):
        self.v = np.zeros((SH, PITCH), I32)
        self.staged = np.zeros((SH, PITCH), bool)

    def items(self, rows, cols):
        """Checks one pass's items, each the (rows, cols) grid of samples
        it reads and writes: every sample staged, no sample in two
        items."""
        flat = (rows * PITCH + cols).ravel()
        assert self.staged.ravel()[flat].all(), "an item reads past staging"
        assert np.unique(flat).size == flat.size, "two items share a sample"


def model_block(inp, out, writes, copy, q, luma, tile):
    """deblock_tile for one block: stages, filters and stores `tile` of
    the plane `inp` into `out`, counting each output sample's writes."""
    h, w = inp.shape
    mbc = 2 if luma else 1
    y0, x0, bands, cols = tile_box(h, w, tile)
    sm = Shared()

    # staging: 16-byte chunks, wholly inside the plane or skipped
    k = np.arange(SH * CHUNKS)
    i, c = k // CHUNKS, k % CHUNKS
    r, x = y0 - HALO + i, x0 - HALO + 4 * c
    ok = (r >= 0) & (r < h) & (x >= 0) & (x < w)
    assert (x[ok] + 3 < w).all()
    for d in range(4):
        sm.v[i[ok], 4 * c[ok] + d] = inp[r[ok], x[ok] + d]
        sm.staged[i[ok], 4 * c[ok] + d] = True

    def vertical_pass(edges, rows, row):
        quads = -(-edges // 4)
        k = np.arange(quads * 4 * rows)
        g = k >> 3
        e = (k & 3) + 4 * (g % quads)
        j = ((k >> 2) & 1) + 2 * (g // quads)
        assert np.unique(e * rows + j).size == k.size   # each item once
        r = row(j)
        x = x0 + STEP * e
        ok = (e < edges) & (r >= 0) & (x > 0) & (x < w)
        k, e, r, x = k[ok], e[ok], r[ok], x[ok]
        si = r - y0 + HALO
        # the 16-byte words an item reads first: 8 items of a phase (one
        # k >> 3) fall in 8 distinct groups of 4 banks
        word = (si * PITCH + STEP * e) // 4
        for phase in np.unique(k >> 3):
            banks = word[(k >> 3) == phase] % 8
            assert np.unique(banks).size == banks.size
        taps = np.arange(STEP)
        sm.items(si[:, None] + 0 * taps, STEP * e[:, None] + taps)
        mr, cell = r // STEP // mbc, x // STEP
        s, qp = _mb_strength_qp(copy, q, mr, (cell - 1) // mbc, mr,
                                cell // mbc)
        new = _filter([sm.v[si, STEP * e + t] for t in taps], s, qp, luma)
        for t, v in enumerate(new, 1):
            sm.v[si, STEP * e + t] = v

    # pass 1: rows 8n+4 .. 8n+7 of the band above and the tile's bands;
    # the band above the plane stands for band 0's rows 0 .. 3
    edges = cols // STEP + 1
    b0 = y0 // STEP

    def pass1_row(j):
        b = b0 - 1 + j // 4
        return np.where(b < 0, j % 4, STEP * b + 4 + j % 4)

    vertical_pass(edges, 4 * (bands + 1), pass1_row)

    # pass 2: horizontal edges at y0 + 8n, 0 < y < h, 4 staged columns an
    # item
    k = np.arange((bands + 1) * CHUNKS)
    n, c = k // CHUNKS, k % CHUNKS
    y, x = y0 + STEP * n, x0 - HALO + 4 * c
    ok = (y > 0) & (y < h) & (x >= 0) & (x < w)
    n, c, y, x = n[ok], c[ok], y[ok], x[ok]
    rows = STEP * n[:, None, None] + np.arange(STEP)[None, :, None]
    cols4 = 4 * c[:, None, None] + np.arange(4)[None, None, :]
    sm.items(rows + 0 * cols4, cols4 + 0 * rows)
    mc = x // STEP // mbc
    s, qp = _mb_strength_qp(copy, q, (y // STEP - 1) // mbc, mc,
                            y // STEP // mbc, mc)
    for d in range(4):
        new = _filter([sm.v[STEP * n + t, 4 * c + d] for t in range(STEP)],
                      s, qp, luma)
        for t, v in enumerate(new, 1):
            sm.v[STEP * n + t, 4 * c + d] = v

    # pass 3: rows 8b .. 8b+3 of the tile's bands b >= 1
    vertical_pass(edges, 4 * bands,
                  lambda j: np.where(y0 + STEP * (j // 4) + j % 4 < STEP, -1,
                                     y0 + STEP * (j // 4) + j % 4))

    # stores: the tile, 4 columns an item
    oc = cols // 4
    k = np.arange(STEP * bands * oc)
    i, c = k // oc, k % oc
    for d in range(4):
        assert sm.staged[HALO + i, HALO + 4 * c + d].all()
        out[y0 + i, x0 + 4 * c + d] = sm.v[HALO + i, HALO + 4 * c + d]
        np.add.at(writes, (y0 + i, x0 + 4 * c + d), 1)


def model_frame(y, u, v, copy, q):
    """The launch: every block of the grid, each output sample written
    once."""
    planes = (y, u, v)
    outs = [np.zeros_like(p) for p in planes]
    writes = [np.zeros(p.shape, np.int64) for p in planes]
    for plane, tile in grid(*y.shape):
        model_block(planes[plane], outs[plane], writes[plane], copy, q,
                    plane == 0, tile)
    for name, wr in zip("yuv", writes):
        assert (wr == 1).all(), f"{name}: a sample written other than once"
    return outs


MODEL_CASES = [(s, k) for s in SIZES for k in KINDS] + [
    (s, k) for s in TILE_SIZES for k in ("mixed", "int16_range")]


@pytest.mark.parametrize("size,kind", MODEL_CASES,
                         ids=[f"{_ids(s)}-{k}" for s, k in MODEL_CASES])
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
