"""Whether what the timed path produced is correct, by the plain reference
codec in evxbench/reference (numpy, nothing of the program).

The encoders are checked frame by frame. A frame's chunk depends on the
four reconstructions and the coefficient planes that the stream carries
into it, so the reference follows the program one step: a `Probe` copies
the program's state just before one frame of one session is dispatched
and just after, on the encoder's own stream, and after the window the
reference works that frame out again from the state before it:

  * the chunk's frame descriptor (type, index, quality) and, for the first
    frame, the stream header;
  * the slice parsed by the reference's slice decoder and serialised again
    by its slice encoder, byte for byte the chunk's (the entropy coder);
  * the parsed coefficient planes against the program's carried planes
    after the frame (the state the next frame's DC prediction reads);
  * on sampled tiles of macroblocks, the reconstruction: the reference
    decodes the frame (every macroblock in raster order where intra-motion
    blocks read the frame's own earlier blocks, else the tiles and their
    margins) and deblocks each tile within a margin of two macroblocks,
    beyond which the deblock does not reach; the tile against the
    program's reconstruction after the frame (K4, K8, K10, K11);
  * on the same macroblocks, the encoder's work (`decisions=True`): on
    the conformance path the reference encoder's own decision and
    quantised coefficients (its classify and encode at that point of its
    raster order); on the fast path the quantiser's q_index and
    coefficients for the decision the chunk carries. The fast search's
    own choice of decision is not worked out again here, so no fast-path
    cell stands on this check.

The same check runs on the sampled session's first frame from the zero
state, which needs nothing of the program: the start of the chain that
the one-step check follows from the program's state. Every other session
of a run has one frame of the window checked without the encoder's work
(the descriptor, the slice, the carried planes and the reconstruction on
the tiles), which needs the reference to decode only the tiles and their
margins.
"""

from __future__ import annotations

import struct
import time

import numpy as np

from reference import blocktypes as bty
from reference import deblock as ref_deblock
from reference import engine as ref_engine
from reference import slicecodec, stream, tables
from reference.bitio import BitReader, BitWriter
from reference.config import CodecConfig
from reference.motion import Planes

MB = tables.MACROBLOCK_SIZE
RING = tables.REFERENCE_FRAME_COUNT
STATE = ("ring_y", "ring_u", "ring_v", "coef_y", "coef_u", "coef_v")
DESC_FIELDS = ("block_type", "prediction_target", "motion_x", "motion_y",
               "sp_pred", "sp_amount", "sp_index", "q_index")


class Probe:
    """Copies one session's encoder state before and after the first frame
    it dispatches at or after `at` (host clock); `first=True` copies the
    state after frame 0 instead (the state before it is zero)."""

    def __init__(self, at: float, first: bool = False):
        self.at = at
        self.first = first
        self.frame = None
        self.pre = None
        self.post = None
        self._armed = False

    def _copy(self, enc):
        with enc._q.steps():
            return {k: enc._state[k].clone() for k in STATE}

    def before(self, session):
        if self.frame is not None:
            return
        enc = session.enc
        if self.first:
            if enc.frame_index == 0:
                self.frame, self._armed = 0, True
        elif time.perf_counter() >= self.at and enc._state is not None:
            self.frame, self._armed = enc.frame_index, True
            self.pre = self._copy(enc)

    def after(self, session):
        if self._armed:
            self._armed = False
            self.post = self._copy(session.enc)

    def host(self):
        """The copies as numpy arrays (after the window: they wait for the
        encoder's stream)."""
        def np_(d):
            return None if d is None else {
                k: v.cpu().numpy() for k, v in d.items()}
        return np_(self.pre), np_(self.post)


def tiles_for(rng, wb: int, hb: int, tile: int, count: int):
    """The tiles checked: the frame's four corner tiles and `count` more at
    random, each (i0, j0, i1, j1) in macroblocks."""
    tw, th = min(tile, wb), min(tile, hb)
    starts = {(0, 0), (wb - tw, 0), (0, hb - th), (wb - tw, hb - th)}
    for _ in range(count):
        starts.add((int(rng.integers(0, wb - tw + 1)),
                    int(rng.integers(0, hb - th + 1))))
    return sorted((i, j, i + tw, j + th) for i, j in starts)


def _desc(bt, idx) -> dict:
    return {k: (bool(getattr(bt, k)[idx]) if k in ("sp_pred", "sp_amount")
                else int(getattr(bt, k)[idx])) for k in DESC_FIELDS}


def _desc_diff(exp: dict, got: dict) -> bool:
    t = exp["block_type"]
    if t != got["block_type"]:
        return True
    keys = []
    if not bty.is_intra(t):
        keys.append("prediction_target")
    if bty.is_motion(t):
        keys += ["motion_x", "motion_y", "sp_pred"]
        if exp["sp_pred"]:
            keys += ["sp_amount", "sp_index"]
    if not bty.is_copy(t):
        keys.append("q_index")
    return any(int(exp[k]) != int(got[k]) for k in keys)


def _blocks_equal(a: Planes, b: Planes, i: int, j: int) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a.block(i, j),
                                                    b.block(i, j)))


def check_frame(path: str, chunk: bytes, frame_index: int, quality: int,
                rgb: np.ndarray, pre, post, codec: dict, rng,
                tile: int = 4, tiles: int = 4, margin: int = 2,
                decisions: bool = True) -> dict:
    """The reference's reading of one frame: counts of what differs from
    the program (all 0 when the frame is right); `decisions=False` leaves
    out the encoder's work on the tiles."""
    height, width = rgb.shape[:2]
    config = CodecConfig(**codec)
    ctx = ref_engine.CodecContext(width, height, config)
    wb, hb = ctx.width_in_blocks, ctx.height_in_blocks
    out = dict(descriptor=0, slice_bytes=0, coef_planes=0, decisions=0,
               recon=0)

    off = 0
    if frame_index == 0:
        try:
            dims = stream.parse_header(chunk[:stream.HEADER_SIZE],
                                       config.reference_frame_count)
        except ValueError:
            dims = None
        out["descriptor"] += dims != (width, height)
        off = stream.HEADER_SIZE
    ftype, index, q = struct.unpack(
        stream._FRAME_FMT, chunk[off:off + stream.FRAME_DESC_SIZE])
    want_type = bty.FRAME_INTRA if frame_index == 0 else bty.FRAME_INTER
    out["descriptor"] += (ftype, index, q) != (want_type, frame_index,
                                               quality)
    off += stream.FRAME_DESC_SIZE
    body = chunk[off:]

    if pre is not None:
        for s in range(RING):
            ctx.recon[s].y[:] = pre["ring_y"][s]
            ctx.recon[s].u[:] = pre["ring_u"][s]
            ctx.recon[s].v[:] = pre["ring_v"][s]
        coef = Planes(pre["coef_y"].copy(), pre["coef_u"].copy(),
                      pre["coef_v"].copy())
    else:
        coef = Planes(np.zeros_like(ctx.output.y), np.zeros_like(ctx.output.u),
                      np.zeros_like(ctx.output.v))
    bt = bty.BlockTable.zeros(ctx.n_blocks)
    try:
        slicecodec.decode_slice(BitReader(body), ctx.n_blocks, coef.y, coef.u,
                                coef.v, bt)
    except (ValueError, IndexError, EOFError) as e:
        out["slice_bytes"] = len(body) or 1
        out["parse_error"] = repr(e)[:200]
        return out
    writer = BitWriter()
    slicecodec.encode_slice(bt, coef.y, coef.u, coef.v, writer)
    again = writer.getvalue()
    n = min(len(again), len(body))
    out["slice_bytes"] = int(np.count_nonzero(
        np.frombuffer(again[:n], np.uint8) != np.frombuffer(body[:n], np.uint8))
        + abs(len(again) - len(body)))
    out["coef_planes"] = int(sum(np.count_nonzero(a != post[k]) for a, k in (
        (coef.y, "coef_y"), (coef.u, "coef_u"), (coef.v, "coef_v"))))

    ref_engine.load_input(ctx, rgb)
    boxes = tiles_for(rng, wb, hb, tile, tiles)
    sampled = np.zeros((hb, wb), bool)
    needed = np.zeros((hb, wb), bool)
    for i0, j0, i1, j1 in boxes:
        sampled[j0:j1, i0:i1] = True
        needed[max(0, j0 - margin):j1 + margin,
               max(0, i0 - margin):i1 + margin] = True
    intra_motion = bty.is_intra(bt.block_type) & bty.is_motion(bt.block_type)
    if (decisions and path == "conformance") or intra_motion.any():
        needed[:] = True
    for idx in np.flatnonzero(needed.reshape(-1)):
        j, i = divmod(int(idx), wb)
        desc = _desc(bt, idx)
        if decisions and sampled[j, i]:
            out["decisions"] += _check_block(path, ctx, ftype, frame_index,
                                             quality, desc, coef, i * MB,
                                             j * MB)
        ref_engine.decode_block(ctx, coef, frame_index, desc, i * MB, j * MB)

    cur = ctx.recon[ctx.ring_slot(frame_index, 0)]
    slot = frame_index % RING
    for i0, j0, i1, j1 in boxes:
        ci0, cj0 = max(0, i0 - margin), max(0, j0 - margin)
        ci1, cj1 = min(wb, i1 + margin), min(hb, j1 + margin)
        crop_bt = bty.BlockTable(**{
            k: getattr(bt, k).reshape(hb, wb)[cj0:cj1, ci0:ci1].reshape(-1)
            for k in bty.BlockTable.__dataclass_fields__})
        for plane, key, mb in ((cur.y, "ring_y", MB), (cur.u, "ring_u", MB // 2),
                               (cur.v, "ring_v", MB // 2)):
            crop = plane[cj0 * mb:cj1 * mb, ci0 * mb:ci1 * mb].copy()
            if config.enable_deblocking:
                ref_deblock.deblock_plane(crop, crop_bt, mb, mb == MB)
            got = post[key][slot][j0 * mb:j1 * mb, i0 * mb:i1 * mb]
            want = crop[(j0 - cj0) * mb:(j1 - cj0) * mb,
                        (i0 - ci0) * mb:(i1 - ci0) * mb]
            out["recon"] += int(np.count_nonzero(got != want))
    return out


def _check_block(path, ctx, ftype, frame_index, quality, got, coef, px, py):
    """1 if the reference's encode of the macroblock at (px, py) differs from
    what the chunk carries, else 0. Runs before the block is decoded, when
    the reference encoder would code it."""
    if path == "conformance":
        _, exp = ref_engine.classify_block(ctx, ftype, frame_index, quality,
                                           px, py)
    else:
        if bty.is_copy(got["block_type"]):
            return 0
        exp = {k: got[k] for k in DESC_FIELDS if k != "q_index"}
    exp = dict(exp)
    ref_engine.encode_block(ctx, ftype, frame_index, quality, exp, px, py)
    if _desc_diff(exp, got):
        return 1
    if bty.is_copy(exp["block_type"]):
        return 0
    return int(not _blocks_equal(ctx.output, coef, px, py))
