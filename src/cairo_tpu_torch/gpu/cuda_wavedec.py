"""Wave-decode kernel K7 with its plain PyTorch version: the wave loop of
the conformance decode (counterpart of the jax.lax.while_loop in
cairo_tpu/tpu/wavefront.py:981-1047, which has no Pallas kernel).

A reference-origin frame's intra-motion blocks read the current frame's
reconstruction in raster order. The decode step reconstructs every other
block densely first; the wave loop then rebuilds the intra-motion blocks
wave by wave over the host's compacted schedule (waves w = bi + 3 bj that
hold such blocks, wavefront.build_compact_schedule). Each member:

  * takes its vector clipped to the window, dx in [-32, 32] and dy in
    [-48, 16], and its sub-pel neighbour dirs[sp_index], clipped again;
    chroma at (dx >> 1, dy >> 1), an arithmetic shift;
  * reads each sample from the *written* plane where it is raster-before
    the member (above its block row, or in it and left of the block) and
    from the *stale* plane, the ring slot before this frame, everywhere
    else; samples outside the aligned frame read 0. In the reference's
    80x80 / 40x40 window this is the static mask r < 48 | (r < 64 &
    c < 32) (chroma r < 24 | (r < 32 & c < 16));
  * predicts with lerp_half / lerp_quarter where sp_pred is set and
    writes copy ? pred : wrap16(res + pred) into the written plane.

Members of one wave never read each other's blocks: what a member reads
from the written plane lies in rows [py - 48, py) x columns [px - 32,
px + 48), or in rows [py, py + 16) left of px, and the other members of
its wave sit at (bi + 3k, bj - k): for k > 0 in columns from px + 48 on,
for k < 0 in rows from py + 16 on, outside both (chroma halves every
distance). So a wave's members run in any order, or all at once. A
member reads far less than that window, though: its base block and, for
sub-pel, its neighbour block. `footprint` gives the MBs those reads
touch in the written plane; a member depends only on the members among
them (`dependencies`), and the longest chain of such dependencies
(`dependency_chain`) is what the kernel's one launch takes in dependent
member steps, where the waves take one step each.

Dispatch, one rule: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel of csrc/wavedec.cu or raises. One call with active
waves launches the kernel once, a persistent dataflow over the members
(each waits only on the MBs of its footprint); LAUNCHES["wave_decode"]
counts those launches, LAUNCHES["wave_decode_waves"] the active waves
they cover and LAUNCHES["wave_decode_members"] the intra-motion blocks
they rebuild.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from .. import tables
from . import _build, ops
from .cuda_pred import DIRS
from .cuda_wave import WIN_X, WIN_Y

MB = tables.MACROBLOCK_SIZE
I32 = torch.int32
# a member's vector clip, luma samples: its block inside the causal
# window the encoder's intra search reads (cuda_wave), [-32, 32] x
# [-48, 16]
DX = (WIN_X[0], WIN_X[1] - MB)
DY = (WIN_Y[0], WIN_Y[1] - MB)
# the per-MB rows of `fields`, int32
FIELDS = ("motion_x", "motion_y", "sp_pred", "sp_amount", "sp_index",
          "is_copy")

LAUNCHES = {"wave_decode": 0, "wave_decode_waves": 0,
            "wave_decode_members": 0}
# the ctypes signature of csrc/wavedec.cu's cairo_wave_decode: 13
# pointers, 6 ints, the stream
SIGNATURE = "p" * 13 + "i" * 6 + "p"
# the most blocks one launch may have; 0: as many as fit on the card at
# once (the ticket order needs no particular number: tests set 1 and 2)
MAX_BLOCKS = 0
# the kernel's sync buffer: ticket, marks' flag, member count, then the
# pending flag of each MB and the member list
SYNC_HEAD = 3


def sample_coords(by, bx, oy, ox, size):
    """Where the members' blocks at offsets (oy, ox) from their block
    origins (by, bx), (P,) each, read: (y, x, before), (P, size, size)
    each; `before` marks the samples raster-before the member, which come
    from the written plane (the static window masks ym_np / cm_np of
    wavefront._conformance_decode_core, in member-relative coordinates)."""
    a = torch.arange(size, device=by.device)
    ry = (oy[:, None] + a)[:, :, None]
    rx = (ox[:, None] + a)[:, None, :]
    before = (ry < 0) | ((ry < size) & (rx < 0))
    return torch.broadcast_tensors(by[:, None, None] + ry,
                                   bx[:, None, None] + rx, before)


def _read(written, stale, by, bx, oy, ox, size):
    """The members' (P, size, size) int32 blocks at offsets (oy, ox), as
    wavefront._extract_cand cuts them from the composed windows of
    wavefront._wave_windows."""
    h, w = written.shape
    y, x, before = sample_coords(by, bx, oy, ox, size)
    inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
    yc, xc = y.clamp(0, h - 1), x.clamp(0, w - 1)
    v = torch.where(before, written[yc, xc], stale[yc, xc]).to(I32)
    return torch.where(inside, v, 0)


def wave_decode_plain(planes, stale, res, fields, bi, bj, n_active,
                      n_members):
    """The wave loop of wavefront._conformance_decode_core
    (wavefront.py:981-1047) in torch ops, vectorised over the members of
    a wave where the JAX loop writes them one by one (n_members is not
    read: only the kernel path counts)."""
    wb = planes[0].shape[1] // MB
    dirs = torch.tensor(DIRS, dtype=I32, device=bi.device)
    for w in range(n_active):
        keep = bi[w] >= 0
        col, row = bi[w][keep].long(), bj[w][keep].long()
        m = row * wb + col
        mx, my, spp, spa, spi, copy = fields[:, m]
        dx, dy = mx.clamp(*DX), my.clamp(*DY)
        d = dirs[spi.clamp(0, 7).long()]
        tx, ty = (dx + d[:, 0]).clamp(*DX), (dy + d[:, 1]).clamp(*DY)
        for plane, old, r, size in zip(planes, stale, res, (MB, 8, 8)):
            shift = 0 if size == MB else 1
            by, bx = row * size, col * size
            base = _read(plane, old, by, bx, dy >> shift, dx >> shift, size)
            nb = _read(plane, old, by, bx, ty >> shift, tx >> shift, size)
            pred = torch.where(
                spp[:, None, None] != 0,
                torch.where(spa[:, None, None] != 0,
                            ops.lerp_quarter(base, nb),
                            ops.lerp_half(base, nb)), base)
            out = torch.where(copy[:, None, None] != 0, pred,
                              ops.wrap16(r[m] + pred))
            a = torch.arange(size, device=bi.device)
            plane[(by[:, None] + a)[:, :, None],
                  (bx[:, None] + a)[:, None, :]] = out.to(plane.dtype)
    return planes


def _numpy(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def schedule_members(bi, bj, n_active):
    """The members of the first n_active schedule rows in the kernel's
    ticket order (wave by wave, the -1 slots dropped): (col, row), int64
    numpy (P,) each."""
    col = _numpy(bi)[:n_active].reshape(-1).astype(np.int64)
    row = _numpy(bj)[:n_active].reshape(-1).astype(np.int64)
    keep = col >= 0
    return col[keep], row[keep]


def footprint(mx, my, sp_pred, sp_index, col, row, h, w):
    """The MBs the kernel makes the members at MB (col, row) wait on:
    those holding a sample the member reads from the written plane
    (raster-before it and inside the frame), in luma and in chroma (U and
    V read alike), for its base block and, where sp_pred is set, its
    neighbour block, the vectors clipped as wave_decode_plain clips them.
    mx, my, sp_pred, sp_index, col, row: (P,) each (the FIELDS rows of
    the members); h, w: the luma plane. Returns int64 (P, 32), MB indices
    and -1 for none, luma's in columns 0-15 and chroma's in 16-31: each
    (plane, read) gives two rectangles of raster-before samples (the rows
    above the member's block row, and its block row left of it), each at
    most one block high and wide, so over at most 2 x 2 MBs. An odd
    negative vector makes chroma reach one sample further than luma
    halved, yet at MB granularity chroma's MBs are among luma's."""
    wb = w // MB
    col, row = np.asarray(col, np.int64), np.asarray(row, np.int64)
    dx = np.asarray(mx, np.int64).clip(*DX)
    dy = np.asarray(my, np.int64).clip(*DY)
    d = np.asarray(DIRS, np.int64)[np.asarray(sp_index, np.int64).clip(0, 7)]
    tx, ty = (dx + d[:, 0]).clip(*DX), (dy + d[:, 1]).clip(*DY)
    reads = ((dy, dx, np.ones(col.shape, bool)),
             (ty, tx, np.asarray(sp_pred) != 0))
    out = []
    for size, shift in ((MB, 0), (MB // 2, 1)):
        ph, pw = h >> shift, w >> shift
        by, bx = row * size, col * size
        for vy, vx, on in reads:
            oy, ox = vy >> shift, vx >> shift
            for ry0, ry1, rx1 in (
                    (oy, np.minimum(oy + size, 0), ox + size),
                    (np.maximum(oy, 0), np.minimum(oy + size, size),
                     np.minimum(ox + size, 0))):
                y0, y1 = np.maximum(by + ry0, 0), np.minimum(by + ry1, ph)
                x0, x1 = np.maximum(bx + ox, 0), np.minimum(bx + rx1, pw)
                ok = on & (y0 < y1) & (x0 < x1)
                for a in (0, 1):
                    for b in (0, 1):
                        r, c = y0 // size + a, x0 // size + b
                        hit = ok & (r <= (y1 - 1) // size) & \
                            (c <= (x1 - 1) // size)
                        out.append(np.where(hit, r * wb + c, -1))
    return np.stack(out, 1)


def dependencies(fields, bi, bj, n_active, h, w):
    """For each member in ticket order (schedule_members), the tickets of
    the members whose blocks it reads, the only waits of the kernel that
    can hold it: int64 (P, 32), -1 for none (footprint's columns)."""
    col, row = schedule_members(bi, bj, n_active)
    wb, n = w // MB, (w // MB) * (h // MB)
    ticket = np.full(n + 1, -1, np.int64)   # [n]: footprint's -1
    ticket[row * wb + col] = np.arange(col.size)
    f = _numpy(fields)[:, row * wb + col]
    return ticket[footprint(f[0], f[1], f[2], f[4], col, row, h, w)]


def dependency_chain(fields, bi, bj, n_active, h, w, blocks=None):
    """The longest chain of dependent members (each reading the block of
    the one before it) of a frame's wave loop: the kernel's critical path
    in member steps, at most n_active (every dependency lies in an earlier
    wave). Arguments as wave_decode's (torch tensors on any device, or
    numpy), h, w the luma plane's; runs on the host. With `blocks`, the
    steps the kernel's ticket order takes when only that many blocks hold
    tickets (list scheduling: each member one step, started when a block
    is free and its dependencies are done), at least the chain."""
    deps = dependencies(fields, bi, bj, n_active, h, w)
    free = [0] * min(blocks or len(deps), len(deps))
    done = np.zeros(len(deps) + 1, np.int64)   # [-1]: no dependency
    for k, d in enumerate(deps):
        if d.max(initial=-1) >= k:
            raise ValueError(f"member {k} depends on a later ticket")
        done[k] = max(heapq.heappop(free), done[d].max()) + 1
        heapq.heappush(free, done[k])
    return int(done.max())


def wave_decode(planes, stale, res, fields, bi, bj, n_active, n_members):
    """Rebuilds the intra-motion blocks of one frame in `planes`, in place;
    returns `planes`.

    planes: the written (Y, U, V) planes, int16 (H, W) / (H/2, W/2), with
    every block but the intra-motion ones reconstructed; stale: the ring
    slot's planes before this frame, same shapes and type; res: the
    residual blocks ((N, 16, 16), (N, 8, 8), (N, 8, 8)) int32; fields:
    (6, N) int32 rows FIELDS; bi, bj: the compacted schedule, (n_waves, p)
    int16, -1 past each wave's members; n_active: the waves to run and
    n_members: the members in them, both host ints (no device read;
    n_members sizes the launch and is counted)."""
    if planes[0].device.type == "cpu":
        return wave_decode_plain(planes, stale, res, fields, bi, bj,
                                 n_active, n_members)
    h, w = planes[0].shape
    if h % MB or w % MB:
        raise ValueError("wave_decode: plane dims must be multiples of 16")
    n = (h // MB) * (w // MB)
    n_waves, p = bi.shape
    if not 0 <= n_active <= n_waves:
        raise ValueError(f"wave_decode: n_active {n_active} outside 0.."
                         f"{n_waves}")
    shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    for name, group, dtype in (("planes", planes, torch.int16),
                               ("stale", stale, torch.int16)):
        for t, shape, plane in zip(group, shapes, "yuv"):
            _build.check(t, f"{name}_{plane}", dtype, shape)
    for t, size, plane in zip(res, (MB, 8, 8), "yuv"):
        _build.check(t, f"res_{plane}", I32, (n, size, size))
    _build.check(fields, "fields", I32, (len(FIELDS), n))
    _build.check(bi, "bi", torch.int16, (n_waves, p))
    _build.check(bj, "bj", torch.int16, (n_waves, p))
    if n_active:
        sync = torch.zeros(SYNC_HEAD + n + n_active * p, dtype=I32,
                           device=planes[0].device)
        fn = _build.kernel_fn("cairo_wave_decode", SIGNATURE)
        _build.launch(fn, planes[0].device,
                      *(t.data_ptr() for t in planes),
                      *(t.data_ptr() for t in stale),
                      *(t.data_ptr() for t in res), fields.data_ptr(),
                      bi.data_ptr(), bj.data_ptr(), sync.data_ptr(), p,
                      n_active, n_members, h, w, MAX_BLOCKS)
        LAUNCHES["wave_decode"] += 1
        LAUNCHES["wave_decode_waves"] += n_active
        LAUNCHES["wave_decode_members"] += n_members
    return planes
