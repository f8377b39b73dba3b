"""K5's and K1's staged layouts against the anchor's windows, on the CPU
(no card needed).

K5 (csrc/inter.cu) stages, per block, one strip per reference for a run
of RUN macroblocks of one MB row, luma rows [py - REACH, py + 16 + REACH)
x columns [px0 - REACH, px0 + 16 RUN + REACH), chroma halved, copied in
chunks of 8 samples that lie wholly inside the plane or are zero; each
(MB, reference) warp then reads its candidates from that strip with no
clamp. K1 (csrc/motion.cu) takes runs of K1_RUN chroma blocks in the
flat (hb, wb) order, which may cross into the next block row, and stages
each run's reference rows [8 bi - 8, 8 bi + 16) the same way, one segment
of columns per block row with 8 columns of margin each side; it computes
in fp32. These tests model
that addressing in PyTorch and hold it against what the plain versions
read: extract.mb_windows (K5's anchor windows) and the zero padding of
cuda_motion.chroma_max_maps_plain (K1), at frame sizes with one MB column,
one MB row, 1080p and a masked tail; they walk every path of the search
to show the window clamp never acts, check that the lanes of each shared
load fall on distinct banks, and check K1's fp32 arithmetic over its whole
domain.
"""

import itertools
import pathlib
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cairo_tpu_torch.gpu import cuda_motion, extract, motion

CSRC = pathlib.Path(extract.__file__).parent / "csrc"
MB = 16


def _constexpr(name, src):
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / src).read_text())
    assert m, f"{src} defines no constexpr int {name}"
    return int(m.group(1))


RUN = _constexpr("RUN", "inter.cu")
REACH = _constexpr("REACH", "inter.cu")
CREACH = REACH // 2
K1_RUN = _constexpr("K1_RUN", "motion.cu")
CR = cuda_motion.CR
CSPAN = cuda_motion.CSPAN
# inter.cu's strip row strides (int16 samples)
YS = MB * RUN + 2 * REACH + 8
CS = MB // 2 * RUN + 2 * CREACH + 16
CROWS = MB // 2 + 2 * CREACH

# (width, height): one MB column, one MB row, 1080p, a width whose MB
# count leaves a tail after the last full run (and K1 run)
SIZES = [(16, 96), (96, 16), (1920, 1088), (208, 48)]


def _axis_candidates():
    """Every candidate offset along one axis on every path of the search:
    (ring, offset) pairs for the rings at RING_STEPS around the ring-entry
    best, and the sub-pel neighbours (ring 5) of the final best."""
    steps = torch.tensor(motion.RING_STEPS)
    choice = torch.tensor(list(itertools.product((-1, 0, 1),
                                                 repeat=len(steps))))
    bases = torch.cumsum(choice * steps, dim=1)      # best after each ring
    entry = torch.cat([torch.zeros(len(choice), 1, dtype=bases.dtype),
                       bases[:, :-1]], dim=1)
    cands = [entry[:, r:r + 1] + torch.tensor([-1, 0, 1]) * steps[r]
             for r in range(len(steps))]
    cands.append(bases[:, -1:] + torch.tensor([-1, 0, 1]))
    return torch.cat(cands, dim=1).unique()


def test_search_reach_is_the_kernels():
    """The largest offset any path reaches is REACH (16+8+4+2+1 and one
    sub-pel step), the margin K5's strips hold on each side."""
    offs = _axis_candidates()
    assert int(offs.abs().max()) == REACH


@pytest.mark.parametrize("plane", ["luma", "chroma"])
def test_every_candidate_stays_in_the_mbs_window(plane):
    """(a) Every candidate block on every path lies inside the MB's part
    of the staged strip, and the anchor's clamp to its window leaves it
    where it is, so reading the strip with no clamp reads what the anchor
    reads. Candidates move on both axes independently, so the axis sets
    bound every 2-D candidate."""
    offs = _axis_candidates()
    if plane == "luma":
        start, block, size = offs + REACH, MB, MB + 2 * REACH
        pad, anchor = motion.Y_PAD, MB + 2 * motion.Y_PAD
        anchor_start = offs + pad
    else:
        start, block = (offs >> 1) + CREACH, MB // 2
        size = MB // 2 + 2 * CREACH
        pad, anchor = motion.C_PAD, MB // 2 + 2 * motion.C_PAD
        anchor_start = (offs >> 1) + pad
    assert bool((start >= 0).all() and (start + block <= size).all())
    clamped = torch.clamp(anchor_start, 0, anchor - block)
    assert torch.equal(clamped, anchor_start)


def _chunk_strip(plane, rows, cols, chunk=8):
    """The strips a kernel stages: plane rows `rows` (R,) x columns `cols`
    (C,), both (B, R) / (B, C) per strip, copied in chunks of `chunk`
    samples whose first column is a multiple of `chunk`: a chunk is copied
    when its row is in the plane and all of it lies inside, else zero."""
    h, w = plane.shape
    assert bool((cols[:, ::chunk] % chunk == 0).all())
    first = cols - cols % chunk
    chunk_in = (first >= 0) & (first + chunk <= w)
    # a chunk is wholly inside or wholly outside the plane
    assert torch.equal(chunk_in, (cols >= 0) & (cols < w))
    ok = ((rows >= 0) & (rows < h))[:, :, None] & chunk_in[:, None, :]
    got = plane[rows.clamp(0, h - 1)[:, :, None],
                cols.clamp(0, w - 1)[:, None, :]]
    return torch.where(ok, got, torch.zeros_like(got))


def _k5_strips(plane, sub):
    """K5's strips of one plane for every (MB row, run): sub 1 for luma,
    2 for chroma. Returns (hb, runs, rows, cols)."""
    h, w = plane.shape
    mb, reach = MB // sub, REACH // sub
    hb, wb = h // mb, w // mb
    runs = -(-wb // RUN)
    cols = (torch.arange(runs)[:, None] * RUN * mb - reach
            + torch.arange(mb * RUN + 2 * reach))
    return torch.stack([
        _chunk_strip(plane, (bi * mb - reach
                             + torch.arange(mb + 2 * reach)).expand(runs, -1),
                     cols) for bi in range(hb)])


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_k5_strips_read_the_anchor_windows(size):
    """(b) Each MB's 80 x 80 (chroma 40 x 40) part of its run's strip is
    extract.mb_windows at pad 32 (16): the run, the strip origin, the zero
    fill and the masked tail of K5's staging."""
    w, h = size
    rng = np.random.default_rng(w * h)
    for sub in (1, 2):
        plane = torch.from_numpy(rng.integers(
            -32768, 32768, (h // sub, w // sub), dtype=np.int16))
        mb, reach = MB // sub, REACH // sub
        strips = _k5_strips(plane, sub)
        want = extract.mb_windows(plane, mb, reach)
        hb, wb = h // MB, w // MB
        span = mb + 2 * reach
        for m in range(RUN):
            cols = range(m, wb, RUN)          # MBs at place m of their run
            if not cols:
                continue
            got = strips[:, :len(cols), :, m * mb:m * mb + span]
            idx = (torch.arange(hb)[:, None] * wb
                   + torch.tensor(list(cols))).reshape(-1)
            assert torch.equal(got.reshape(-1, span, span), want[idx]), \
                f"sub {sub}, place {m} of the run"


def _banks_conflict_free(words):
    """words: (32,) the 32-bit word each lane of a warp reads; lanes that
    share a bank must read one word."""
    seen = {}
    for wd in words.tolist():
        if seen.setdefault(wd % 32, wd) != wd:
            return False
    return True


def test_k5_lanes_partition_the_block_and_miss_no_bank():
    """Lane l owns luma pixels (4 (l >> 4) + (k & 3) + 8 (k >> 2), l & 15),
    k < 8, and chroma pixels (l >> 3 + 4 k, l & 7), k < 2, of U and V:
    together every pixel of the 16x16 and two 8x8 blocks once. For every
    candidate alignment, the 32 lanes of each of the 12 shared loads fall
    on distinct banks (int16 samples, row strides YS and CS)."""
    lane = torch.arange(32)
    ly = torch.stack([4 * (lane >> 4) + (k & 3) + 8 * (k >> 2)
                      for k in range(8)])                        # (8, 32)
    lx = (lane & 15).expand(8, 32)
    assert len(set((ly * 16 + lx).reshape(-1).tolist())) == 256
    cy = torch.stack([(lane >> 3) + 4 * k for k in range(2)])
    cx = (lane & 7).expand(2, 32)
    assert len(set((cy * 8 + cx).reshape(-1).tolist())) == 64
    plane_u = 0
    plane_v = CROWS * CS
    for x in range(2 * 16):      # every alignment of the candidate column
        for k in range(8):
            words = ((ly[k] * YS + x + lx[k]) * 2) // 4
            assert _banks_conflict_free(words), (x, k)
        for base in (plane_u, plane_v):
            for k in range(2):
                words = ((base + cy[k] * CS + x + cx[k]) * 2) // 4
                assert _banks_conflict_free(words), (x, base, k)


def _k1_col(c):
    return c + (c >> 3)


def _k1_runs(h, w):
    """K1's runs: (first block n0, block count nb) in the flat (hb, wb)
    order, K1_RUN blocks long, or one block row when wb < K1_RUN."""
    wb, nblk = w // 8, (h // 8) * (w // 8)
    run = min(K1_RUN, wb)
    return [(n0, min(run, nblk - n0)) for n0 in range(0, nblk, run)]


def _k1_strip(ref, n0, nb):
    """One run's reference strip, (24, columns), and each lane's first
    strip column: segment 0 holds the blocks in the run's first block row
    with 8 columns of margin each side, segment 1 the rest, from the next
    row's column -8; lane b's window starts at 8 b + 16 seg(b)."""
    wb = ref.shape[1] // 8
    bi0, bj0 = divmod(n0, wb)
    na = min(nb, wb - bj0)
    segs = [(bi0, 8 * bj0 - CR, na + 2)]
    if nb > na:
        segs.append((bi0 + 1, -CR, nb - na + 2))
    assert len(segs) <= 2
    strip = torch.cat([
        _chunk_strip(ref, (8 * bi - CR + torch.arange(8 + 2 * CR))[None],
                     (x0 + torch.arange(8 * nq))[None])[0]
        for bi, x0, nq in segs], dim=1)
    assert strip.shape[1] <= 8 * K1_RUN + 4 * CR
    starts = [8 * b + (16 if b >= na else 0) for b in range(nb)]
    return strip, starts


K1_SIZES = [(8, 48), (320, 24), (960, 544), (104, 16), (264, 40)]


@pytest.mark.parametrize("size", K1_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_k1_strips_read_the_padded_reference(size):
    """(c) Lane b of each run reads its 24 x 24 window at strip columns
    [8 b + 16 seg(b), + 24): exactly the plain version's zero-padded
    reference around its block, for runs inside one block row, runs that
    cross into the next row, the last, short run, and frames narrower than
    a run."""
    w, h = size
    rng = np.random.default_rng(w + h)
    ref = torch.from_numpy(rng.integers(-32768, 32768, (h, w),
                                        dtype=np.int16))
    padded = F.pad(ref.to(torch.int32), (CR, CR, CR, CR))
    wb = w // 8
    covered = 0
    for n0, nb in _k1_runs(h, w):
        strip, starts = _k1_strip(ref, n0, nb)
        for b, c in enumerate(starts):
            bi, bj = divmod(n0 + b, wb)
            want = padded[8 * bi:8 * bi + 24, 8 * bj:8 * bj + 24]
            assert torch.equal(strip[:, c:c + 24].to(torch.int32), want), \
                f"run at {n0}, lane {b}"
        covered += nb
    assert covered == (h // 8) * wb


@pytest.mark.parametrize("size", [s for s in K1_SIZES if s != (960, 544)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_k1_model_equals_plain(size):
    """(c) K1's whole computation modelled as the kernel runs it (warp dy,
    lane b, 17 dx from the lane's 24-sample window row segment, fp32 sub,
    |.| and max, the run's maps written contiguously from block n0)
    equals chroma_max_maps_plain."""
    w, h = size
    rng = np.random.default_rng(3 * w + h)
    src = [torch.from_numpy(rng.integers(0, 256, (h, w)).astype(np.int32))
           for _ in range(2)]
    ref = [torch.from_numpy(rng.integers(-32768, 32768, (h, w),
                                         dtype=np.int16)) for _ in range(2)]
    hb, wb = h // 8, w // 8
    out = torch.full((hb * wb, CSPAN * CSPAN), -1, dtype=torch.int32)
    for n0, nb in _k1_runs(h, w):
        m = torch.zeros(nb, CSPAN, CSPAN)           # (lane, dy, dx)
        for p in range(2):
            strip, starts = _k1_strip(ref[p], n0, nb)
            strip = strip.to(torch.float32)
            for b, c in enumerate(starts):
                bi, bj = divmod(n0 + b, wb)
                blk = src[p][8 * bi:8 * bi + 8, 8 * bj:8 * bj + 8].float()
                for r in range(8):
                    seg = strip[r:r + CSPAN, c:c + 24]   # rows dy + r
                    for cc in range(8):
                        m[b] = torch.maximum(
                            m[b], (blk[r, cc] - seg[:, cc:cc + CSPAN]).abs())
        out[n0:n0 + nb] = m.to(torch.int32).reshape(nb, -1)
    want = cuda_motion.chroma_max_maps_plain(src[0], src[1], ref[0], ref[1])
    assert torch.equal(out.reshape(hb, wb, -1), want)


def test_k1_lanes_miss_no_bank():
    """Strip column c lives at c + c / 8: the 32 lanes of a run in one
    block row (chroma blocks 8 columns apart) fall on distinct banks for
    every window load (fp32 words); the source is stored [row][col][lane],
    so its loads are conflict-free too."""
    lane = torch.arange(32)
    for j in range(8 + CSPAN - 1):
        assert _banks_conflict_free(_k1_col(8 * lane + j)), j


@pytest.mark.parametrize("lo", [0, 128])
def test_k1_fp32_arithmetic_is_exact(lo):
    """(d) K1's fp32 sequence, FADD then FMNMX with |.|, equals the int32
    result for every source value in 0..255 against every int16
    reference, and the max of two such values too."""
    ref = torch.arange(-32768, 32768, dtype=torch.int32)
    rf = ref.to(torch.float32)
    for s in range(lo, lo + 128):
        want = (s - ref).abs()
        got = (torch.tensor(float(s)) - rf).abs()
        assert torch.equal(got.to(torch.int32), want), s
        # the running max against a second plane's difference
        other = (255 - s - ref.flip(0)).abs()
        both = torch.maximum(got, (torch.tensor(float(255 - s))
                                   - rf.flip(0)).abs())
        assert torch.equal(both.to(torch.int32), torch.maximum(want, other))
        assert bool((got == want.to(torch.float32)).all())
