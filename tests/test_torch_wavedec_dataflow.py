"""K7's dataflow launch modelled on the CPU (no card needed).

The kernel (csrc/wavedec.cu) rebuilds a frame's intra-motion members in
one launch: blocks take tickets in schedule order, ticket 0 marks the
members pending, and each thread of a member waits, for every sample it
reads from the written plane, until the MB holding the sample is no
longer pending. cuda_wavedec models those waits on the host (footprint,
dependencies, dependency_chain). These tests require:

  1. the footprint is exactly the MBs of the raster-before, in-frame
     samples that wave_decode_plain reads (cuda_wavedec.sample_coords),
     luma and chroma, over every vector of the clip box and beyond it,
     every sp_index with sp_pred on and off, members in the first and last
     MB row and column;
  2. every dependency has an earlier ticket (the wave order is a
     topological order of the waits), so no wait is on a later ticket;
  3. members run one at a time in seeded random orders that respect the
     waits (any ready member, and blocks holding tickets in order, as the
     kernel's G blocks do, G = 1, 2, 3, which never all wait) give
     wave_decode_plain's planes;
  4. dependency_chain is at most n_active and equals a brute-force
     longest path over sample-level reads; its model of a capped number
     of blocks takes every member in turn with one block and the chain
     with one block per member.

The clip box, the thread count and the sync layout are read from
wavedec.cu.
"""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

from cairo_tpu_torch.blocktypes import INTRA_BIT, MOTION_BIT
from cairo_tpu_torch.gpu import cuda_wavedec as cw, wavefront as twf

MB = cw.MB
SRC = (pathlib.Path(cw.__file__).parent / "csrc" / "wavedec.cu").read_text()


def _const(name):
    return int(re.search(rf"\b{name} = (-?\d+)", SRC)[1])


DX = (_const("DX_LO"), _const("DX_HI"))
DY = (_const("DY_LO"), _const("DY_HI"))


def test_constants_match_the_kernel():
    """The module's clip box and sync layout are the kernel's, and its 384
    threads own each output sample of Y, U and V once."""
    assert (DX, DY) == (cw.DX, cw.DY)
    assert _const("PENDING") == cw.SYNC_HEAD
    threads = int(re.search(r"THREADS = MB \* MB \+ 2 \* \(MB / 2\) \* "
                            r"\(MB / 2\);\s*// (\d+)", SRC)[1])
    assert threads == MB * MB + 2 * (MB // 2) ** 2 == 384


PLANES = {"luma": ((MB, 0),), "chroma": ((8, 1),),
          "both": ((MB, 0), (8, 1))}


def _read_mbs(col, row, mx, my, spp, spi, h, w, planes="both"):
    """(P, N) bool: the MBs holding a sample each member reads from the
    written plane (luma, chroma or both), enumerated sample by sample with
    wave_decode_plain's own sample_coords and clip."""
    wb, n = w // MB, (w // MB) * (h // MB)
    col, row = torch.as_tensor(col), torch.as_tensor(row)
    dx = torch.as_tensor(mx).clamp(*cw.DX)
    dy = torch.as_tensor(my).clamp(*cw.DY)
    d = torch.tensor(cw.DIRS)[torch.as_tensor(spi).clamp(0, 7)]
    tx, ty = (dx + d[:, 0]).clamp(*cw.DX), (dy + d[:, 1]).clamp(*cw.DY)
    out = torch.zeros(col.numel(), n + 1, dtype=torch.bool)
    p = torch.arange(col.numel())[:, None, None]
    for size, shift in PLANES[planes]:
        for vy, vx, on in ((dy, dx, torch.ones_like(col, dtype=torch.bool)),
                           (ty, tx, torch.as_tensor(spp) != 0)):
            y, x, before = cw.sample_coords(row * size, col * size,
                                            vy >> shift, vx >> shift, size)
            inside = (y >= 0) & (y < h >> shift) & (x >= 0) & \
                (x < w >> shift)
            hit = before & inside & on[:, None, None]
            q = torch.where(hit, y.div(size, rounding_mode="floor") * wb +
                            x.div(size, rounding_mode="floor"), n)
            out[p.expand_as(q), q] = True
    return out[:, :n].numpy()


def _footprint_mbs(col, row, mx, my, spp, spi, h, w, planes="both"):
    """_read_mbs from cuda_wavedec.footprint, whose first 16 columns are
    luma's and last 16 chroma's."""
    n = (w // MB) * (h // MB)
    fp = cw.footprint(mx, my, spp, spi, col, row, h, w)
    fp = dict(luma=fp[:, :16], chroma=fp[:, 16:], both=fp)[planes]
    out = np.zeros((fp.shape[0], n + 1), bool)
    out[np.arange(fp.shape[0])[:, None], np.where(fp >= 0, fp, n)] = True
    return out[:, :n]


@pytest.mark.parametrize("at", ["top_left", "top_right", "bottom_left",
                                "bottom_right", "middle", "left_column",
                                "top_row"])
def test_footprint_is_exactly_the_written_reads(at):
    """Over every vector of the clip box (and a margin beyond it, which
    clips into it), every sp_index 0..7 with sp_pred on and off (one of
    the 16 per vector, cycling), the footprint holds exactly the MBs of
    the written-plane samples the plain version reads, in luma, in chroma
    (odd negative vectors reach one chroma row or column further than
    luma halved) and in both."""
    wb, hb = 9, 6
    h, w = hb * MB, wb * MB
    col, row = dict(top_left=(0, 0), top_right=(wb - 1, 0),
                    bottom_left=(0, hb - 1), bottom_right=(wb - 1, hb - 1),
                    middle=(4, 3), left_column=(0, 3),
                    top_row=(4, 0))[at]
    vy, vx = np.meshgrid(np.arange(DY[0] - 3, DY[1] + 4),
                         np.arange(DX[0] - 3, DX[1] + 4), indexing="ij")
    mx, my = vx.reshape(-1), vy.reshape(-1)
    k = np.arange(mx.size)
    spi, spp = k % 8, (k // 8) % 2
    cols, rows = np.full_like(mx, col), np.full_like(mx, row)
    for planes in PLANES:
        want = _read_mbs(cols, rows, mx, my, spp, spi, h, w, planes)
        got = _footprint_mbs(cols, rows, mx, my, spp, spi, h, w, planes)
        np.testing.assert_array_equal(got, want, err_msg=planes)
    # at MB granularity chroma reaches no MB that luma does not
    luma = _read_mbs(cols, rows, mx, my, spp, spi, h, w, "luma")
    assert not (want & ~luma).any()
    # the top-left member reads nothing written; none reads its own MB or
    # a later one
    assert want.any() == (at != "top_left")
    assert not want[:, row * wb + col:].any()


def _frame(wb, hb, seed, share):
    """K7's arguments on a (wb, hb) MB frame: random planes and residuals,
    a `share` of the MBs intra-motion, vectors over and beyond the clip
    box (below-left ones among them), every sub-pel direction, indices
    outside 0..7, copies; as tests/test_torch_wavedec.py's _wave_inputs."""
    rng = np.random.default_rng(seed)
    h, w, n = hb * MB, wb * MB, wb * hb
    shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    planes = tuple(torch.from_numpy(rng.integers(-300, 560, s)
                                    .astype(np.int16)) for s in shapes)
    stale = tuple(torch.from_numpy(rng.integers(-300, 560, s)
                                   .astype(np.int16)) for s in shapes)
    res = tuple(torch.from_numpy(rng.integers(-600, 600, (n, s, s))
                                 .astype(np.int32)) for s in (16, 8, 8))
    fields = torch.from_numpy(np.stack([
        rng.integers(-40, 41, n), rng.integers(-56, 24, n),
        rng.random(n) < 0.6, rng.random(n) < 0.5, np.arange(n) % 10 - 1,
        rng.random(n) < 0.2]).astype(np.int32))
    bt = np.where(rng.random(n) < share, INTRA_BIT | MOTION_BIT,
                  INTRA_BIT).astype(np.uint8)
    bi, bj, n_active = twf.build_compact_schedule(bt, wb, hb)
    return planes, stale, res, fields, bi, bj, n_active


FRAMES = [(9, 6, 1.0), (10, 7, 0.5), (12, 4, 0.3), (3, 8, 1.0)]


@pytest.mark.parametrize("wb,hb,share", FRAMES)
def test_dependencies_have_earlier_tickets(wb, hb, share):
    """Every member a member waits on holds an earlier ticket: the
    schedule's wave order is a topological order of the waits."""
    for seed in range(3):
        _, _, _, fields, bi, bj, n_active = _frame(wb, hb, seed, share)
        deps = cw.dependencies(fields, bi, bj, n_active, hb * MB, wb * MB)
        k = np.arange(deps.shape[0])[:, None]
        assert (deps < k).all()
        assert (deps >= 0).any()


def _run_one(planes, stale, res, fields, col, row):
    """One member alone, through the plain version (a one-slot schedule)."""
    one = (np.array([[col]], np.int16), np.array([[row]], np.int16))
    cw.wave_decode_plain(planes, stale, res, fields,
                         torch.from_numpy(one[0]), torch.from_numpy(one[1]),
                         1, 1)


@pytest.mark.parametrize("blocks", [None, 1, 2, 3])
@pytest.mark.parametrize("wb,hb,share", FRAMES[:3])
def test_dataflow_orders_match_plain(wb, hb, share, blocks):
    """Members run one at a time in seeded random orders that respect
    the waits: any ready member (blocks=None), or, as the kernel runs,
    `blocks` blocks holding the next tickets in order, of which a random
    one whose waits are met runs and takes the next ticket (one always
    can). Every order gives the plain version's planes."""
    planes, stale, res, fields, bi, bj, n_active = _frame(wb, hb, 5, share)
    h, w = hb * MB, wb * MB
    want = cw.wave_decode_plain(tuple(p.clone() for p in planes), stale,
                                res, fields, torch.from_numpy(bi),
                                torch.from_numpy(bj), n_active, 0)
    col, row = cw.schedule_members(bi, bj, n_active)
    deps = cw.dependencies(fields, bi, bj, n_active, h, w)
    for seed in range(2):
        rng = np.random.default_rng(seed)
        got = tuple(p.clone() for p in planes)
        done = np.zeros(col.size + 1, bool)
        done[-1] = True   # deps' -1
        held = list(range(min(blocks or col.size, col.size)))
        nxt = len(held)
        while held:
            ready = [k for k in held if done[deps[k]].all()]
            assert ready, "every block waits: the ticket order deadlocks"
            k = ready[rng.integers(len(ready))]
            _run_one(got, stale, res, fields, int(col[k]), int(row[k]))
            done[k] = True
            held.remove(k)
            if nxt < col.size:
                held.append(nxt)
                nxt += 1
        for g, wnt in zip(got, want, strict=True):
            np.testing.assert_array_equal(g.numpy(), wnt.numpy())


def _brute_chain(fields, bi, bj, n_active, h, w):
    """The longest path over "b reads a's block": for every pair of
    members, whether a written-plane sample b reads (sample_coords) lies
    in a's block, then a memoised longest path."""
    col, row = cw.schedule_members(bi, bj, n_active)
    wb = w // MB
    m = row * wb + col
    f = fields.numpy()[:, m]
    reads = _read_mbs(col, row, f[0], f[1], f[2], f[4], h, w)
    preds = [[a for a in range(col.size) if reads[b, m[a]]]
             for b in range(col.size)]

    @functools.lru_cache(maxsize=None)
    def longest(b):
        return 1 + max((longest(a) for a in preds[b]), default=0)

    return max(longest(b) for b in range(col.size))


@pytest.mark.parametrize("wb,hb,share", FRAMES)
def test_dependency_chain_is_the_longest_path(wb, hb, share):
    """dependency_chain equals a brute-force longest path over the
    sample-level reads, and is at most the number of active waves."""
    for seed in range(2):
        _, _, _, fields, bi, bj, n_active = _frame(wb, hb, seed, share)
        h, w = hb * MB, wb * MB
        chain = cw.dependency_chain(fields, bi, bj, n_active, h, w)
        assert chain == _brute_chain(fields, bi, bj, n_active, h, w)
        assert 1 <= chain <= n_active
        # the ticket window: one block takes every member in turn, as many
        # blocks as members take the chain, and any number in between
        # takes at least the chain
        p = cw.schedule_members(bi, bj, n_active)[0].size
        steps = [cw.dependency_chain(fields, bi, bj, n_active, h, w, b)
                 for b in (1, 2, 5, p, 10 * p)]
        assert steps[0] == p and steps[3] == steps[4] == chain
        assert min(steps) == chain


def test_dependency_chain_of_a_row_of_left_reads():
    """Every MB a member reading 16 samples to its left: each waits on
    its left neighbour only, so the chain is a row long, where the waves
    number wb + 3 (hb - 1)."""
    wb, hb = 7, 4
    n = wb * hb
    fields = np.zeros((6, n), np.int32)
    fields[0] = -16
    bt = np.full(n, INTRA_BIT | MOTION_BIT, np.uint8)
    bi, bj, n_active = twf.build_compact_schedule(bt, wb, hb)
    assert n_active == wb + 3 * (hb - 1)
    assert cw.dependency_chain(fields, bi, bj, n_active, hb * MB,
                               wb * MB) == wb
