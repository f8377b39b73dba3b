"""Compact device<->host transfer wires (counterpart of
cairo_tpu/tpu/wire.py).

Every per-frame exchange is one uint8 buffer per direction, with layouts
byte-identical to the JAX package's, so the host converters of the native
library apply unchanged:
  * encoder source wire: 8-bit YUV (unpack_yuv8) or the 5-bit-delta
    packing (unpack_yuv5d), built on the host by native.rgb_to_yuv8/5d;
  * encoder output wire: the block table + the nonzero residuals of
    non-copy macroblocks as a COO list (pack_encode_wire), a COO_SMALL
    head plus a tail buffer fetched only when the count needs it;
  * decoder input: the packed block table + the residual COO;
  * decoder output wire: 8-bit YUV + exception list (pack_yuv_wire) or the
    5-bit-delta packing (pack_yuv5d_wire).
Device-side functions take and return torch tensors; the `*_np` helpers
and `unpack_encode_wire` / `apply_coo_np` run on the host in numpy.
Bit casts use `Tensor.view(dtype)` on contiguous little-endian buffers.

The 5-bit-delta source wire has a kernel, K12 (csrc/wire.cu), in place of
the XLA-fused unpack of cairo_tpu/tpu/wire.py. Dispatch, one rule per
wrapper: a CPU tensor takes the plain version, a CUDA tensor launches
K12 or raises; each launch adds one to LAUNCHES["unpack_yuv5d"].
unpack_yuv5d gives the planes engine.encode_step reads, and
unpack_yuv5d_blocks the conformance step's source blocks and self_sad
(source_blocks of the planes), each from one launch.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tables
from . import _build, ops

MB = tables.MACROBLOCK_SIZE
I32 = torch.int32
Y_SHIFT = 16          # yuv wire: Y stored as value-16 (legal [16, 271])
EXC_K = 4096          # yuv wire exception capacity (values off the window)
COO_K = 1 << 17       # residual COO capacity
COO_SMALL = 1 << 14   # encode-wire head / small decode-upload bucket
UP_EXC_K = 8192       # 5-bit-delta uplink exception capacity
DEXC_K = 16384        # 5-bit-delta downlink exception capacity
K12_MAX_WIDTH = 1 << 14   # K12's widest aligned frame (csrc/wire.cu)

LAUNCHES = {"unpack_yuv5d": 0}
# ctypes signature of csrc/wire.cu's cairo_unpack_yuv5d, the stream last
UNPACK_SIGNATURE = "piiiiippppp"


def _compact(vals, mask, k, val_dtype=torch.int16):
    """(positions, values, count) of the first k True elements of a flat
    mask, zero past the count. A stable sort of the not-mask key puts the
    True positions first in ascending order, the order JAX's chunked sort
    yields. No host synchronisation."""
    n = mask.shape[0]
    order = torch.sort((~mask).to(torch.int8), stable=True).indices
    if n < k:
        order = torch.cat([order, order.new_zeros(k - n)])
    order = order[:k]
    total = mask.sum(dtype=I32)
    ok = torch.arange(k, device=mask.device) < total
    pos = torch.where(ok, order.to(I32), 0)
    val = torch.where(ok, vals[order.clamp(max=max(n - 1, 0))], 0)
    return pos, val.to(val_dtype), total


def drop_out_of_range(idx, size):
    """Scatter indices as JAX's mode="drop" takes them: negative indices
    count from the end, and what is still outside [0, size) is dropped.
    Returns (normalized indices, keep mask)."""
    idx = torch.where(idx < 0, idx + size, idx)
    return idx, (idx >= 0) & (idx < size)


def _u8(x):
    """int16/int32 tensor -> flat uint8 little-endian byte stream."""
    return x.contiguous().reshape(-1).view(torch.uint8)


def _view(buf, dtype):
    """uint8 buffer slice -> the dtype it holds (copies when misaligned)."""
    size = torch.empty((), dtype=dtype).element_size()
    if buf.storage_offset() % size:
        buf = buf.clone()
    return buf.contiguous().view(dtype)


def _frame_mask(h, w, frame_h, frame_w, device):
    return ((torch.arange(h, device=device)[:, None] < frame_h)
            & (torch.arange(w, device=device)[None, :] < frame_w))


# --------------------------------------------------------------------------
# encoder output wire: block table + residual COO

def pack_encode_wire(table, coef_y, coef_u, coef_v, copy_mb):
    """Device side. table: dict of (N,) tensors; coef planes int16-valued;
    copy_mb: (N,) bool. Returns (head wire, tail buffer), uint8."""
    parts = [
        _u8(table["motion_x"].to(torch.int16)),
        _u8(table["motion_y"].to(torch.int16)),
        _u8(table["variance"].to(torch.int16)),
        table["block_type"].to(torch.uint8),
        table["prediction_target"].to(torch.uint8),
        table["sp_pred"].to(torch.uint8),
        table["sp_amount"].to(torch.uint8),
        table["sp_index"].to(torch.uint8),
        table["q_index"].to(torch.uint8),
    ]
    ah, aw = coef_y.shape
    ymask = copy_mb.reshape(ah // 16, aw // 16) \
        .repeat_interleave(16, 0).repeat_interleave(16, 1)
    cmask = ymask[::2, ::2]
    flat = torch.cat([
        torch.where(ymask, 0, coef_y.to(I32)).reshape(-1),
        torch.where(cmask, 0, coef_u.to(I32)).reshape(-1),
        torch.where(cmask, 0, coef_v.to(I32)).reshape(-1)])
    pos, val, count = _compact(flat, flat != 0, COO_K)
    parts += [_u8(count.reshape(1)), _u8(pos[:COO_SMALL]),
              _u8(val[:COO_SMALL])]
    tail = torch.cat([_u8(pos[COO_SMALL:]), _u8(val[COO_SMALL:])])
    return torch.cat(parts), tail


def unpack_encode_wire(buf, n, tail=None):
    """Host side (numpy). Returns (table dict, count, coo_pos, coo_val).
    `tail` is a callable returning the tail buffer bytes, invoked only
    when count exceeds the head capacity. The COO list is exact iff
    count <= COO_K."""
    buf = np.asarray(buf)
    o = 0

    def take(count, dtype):
        nonlocal o
        nbytes = count * np.dtype(dtype).itemsize
        out = buf[o:o + nbytes].view(dtype)
        o += nbytes
        return out

    table = dict(
        motion_x=take(n, np.int16), motion_y=take(n, np.int16),
        variance=take(n, np.int16), block_type=take(n, np.uint8),
        prediction_target=take(n, np.uint8),
        sp_pred=take(n, np.uint8).astype(bool),
        sp_amount=take(n, np.uint8).astype(bool),
        sp_index=take(n, np.uint8), q_index=take(n, np.uint8))
    count = int(take(1, np.int32)[0])
    small = min(COO_SMALL, COO_K)
    pos = take(small, np.int32)
    val = take(small, np.int16)
    if count > small and count <= COO_K and tail is not None:
        rest = np.asarray(tail())
        nrest = COO_K - small
        pos = np.concatenate([pos, rest[:4 * nrest].view(np.int32)])
        val = np.concatenate([val, rest[4 * nrest:].view(np.int16)])
    return table, count, pos, val


def apply_coo_np(coef_y, coef_u, coef_v, copy_mb, count, pos, val):
    """Host side: updates persistent int16 planes in place — zeroes all
    non-copy macroblocks, then scatters the COO values."""
    ah, aw = coef_y.shape
    copy_map = copy_mb.reshape(ah // 16, aw // 16)
    ymask = np.repeat(np.repeat(copy_map, 16, axis=0), 16, axis=1)
    cmask = ymask[::2, ::2]
    coef_y *= ymask
    coef_u *= cmask
    coef_v *= cmask
    k = min(count, COO_K)
    pos, val = pos[:k], val[:k]
    ys, cs = ah * aw, (ah // 2) * (aw // 2)
    sel = pos < ys
    coef_y.reshape(-1)[pos[sel]] = val[sel]
    sel = (pos >= ys) & (pos < ys + cs)
    coef_u.reshape(-1)[pos[sel] - ys] = val[sel]
    sel = pos >= ys + cs
    coef_v.reshape(-1)[pos[sel] - ys - cs] = val[sel]


# --------------------------------------------------------------------------
# encoder source wires

def yuv8_nbytes(ah, aw):
    return ah * aw + 2 * (ah // 2) * (aw // 2)


def unpack_yuv8(buf, ah, aw, frame_w, frame_h):
    """Device side: source wire -> (y, u, v) int32 planes. Re-applies the
    +16 luma shift on in-frame cells."""
    ys, cs = ah * aw, (ah // 2) * (aw // 2)
    y = buf[:ys].to(I32).reshape(ah, aw)
    y = torch.where(_frame_mask(ah, aw, frame_h, frame_w, buf.device),
                    y + 16, 0)
    u = buf[ys:ys + cs].to(I32).reshape(ah // 2, aw // 2)
    v = buf[ys + cs:ys + 2 * cs].to(I32).reshape(ah // 2, aw // 2)
    return y, u, v


def yuv5d_nbytes(ah, aw):
    total = ah * aw + 2 * (ah // 2) * (aw // 2)
    return 6 * UP_EXC_K + total * 5 // 8


def _fields5(words):
    """(G, 5) int32 words -> (G*32,) sign-extended 5-bit fields; field g at
    stream bits [5g, 5g+5), little-endian words."""
    w = words.to(torch.int64) & 0xFFFFFFFF  # logical shifts below
    fields = []
    for i in range(32):
        b = 5 * i
        k, s = b >> 5, b & 31
        raw = w[:, k] >> s
        if s > 27:
            raw = raw | (w[:, k + 1] << (32 - s))
        fields.append((raw & 31).to(I32))
    d = torch.stack(fields, 1).reshape(-1)
    return (d ^ 16) - 16


def _prefix_planes(d, ah, aw):
    """Delta stream -> planes: per-plane col-0 vertical cumsum, then a
    horizontal cumsum (int32 arithmetic)."""
    ys, cs = ah * aw, (ah // 2) * (aw // 2)

    def plane(dflat, h, w):
        g = dflat.reshape(h, w)
        c0 = torch.cumsum(g[:, :1], 0, dtype=I32)
        return torch.cumsum(torch.cat([c0, g[:, 1:]], 1), 1, dtype=I32)

    return (plane(d[:ys], ah, aw), plane(d[ys:ys + cs], ah // 2, aw // 2),
            plane(d[ys + cs:], ah // 2, aw // 2))


def unpack_yuv5d_plain(buf, ah, aw, frame_w, frame_h):
    """unpack_yuv5d as torch ops. A position listed twice among the
    exceptions takes either value here (torch's scatter leaves the order
    open); K12 and JAX's scatter take the later entry."""
    exc_pos = _view(buf[:4 * UP_EXC_K], I32).long()
    exc_val = _view(buf[4 * UP_EXC_K:6 * UP_EXC_K], torch.int16).to(I32)
    words = _view(buf[6 * UP_EXC_K:], I32).reshape(-1, 5)
    d = _fields5(words)
    exc_pos, keep = drop_out_of_range(exc_pos, d.shape[0])
    d[exc_pos[keep]] = exc_val[keep]
    y, u, v = _prefix_planes(d, ah, aw)
    y = torch.where(_frame_mask(ah, aw, frame_h, frame_w, buf.device),
                    y + 16, 0)
    return y, u, v


def source_blocks(y, u, v):
    """(y, u, v) int32 planes -> the conformance step's source: ((N, 16,
    16), (N, 8, 8), (N, 8, 8)) int32 blocks in raster MB order, and
    self_sad, the (N,) int32 sum of |Y| of each block."""
    src = (ops.plane_to_blocks(y, MB).contiguous(),
           ops.plane_to_blocks(u, MB // 2).contiguous(),
           ops.plane_to_blocks(v, MB // 2).contiguous())
    return src, src[0].abs().sum(dim=(1, 2), dtype=I32)


def unpack_yuv5d_blocks_plain(buf, ah, aw, frame_w, frame_h):
    return source_blocks(*unpack_yuv5d_plain(buf, ah, aw, frame_w, frame_h))


def unpack_yuv5d(buf, ah, aw, frame_w, frame_h):
    """Device side: 5-bit-delta source wire -> (y, u, v) int32 planes.
    Layout: [UP_EXC_K int32 exc_pos | UP_EXC_K int16 exc_val | packed
    5-bit fields]. Exceptions carry (flat position, true delta); sentinel
    positions past the planes are dropped."""
    if buf.device.type == "cpu":
        return unpack_yuv5d_plain(buf, ah, aw, frame_w, frame_h)
    return _launch_unpack(buf, ah, aw, frame_w, frame_h, blocks=False)


def unpack_yuv5d_blocks(buf, ah, aw, frame_w, frame_h):
    """Device side: 5-bit-delta source wire -> source_blocks of its
    planes: ((Y, U, V) blocks, self_sad)."""
    if buf.device.type == "cpu":
        return unpack_yuv5d_blocks_plain(buf, ah, aw, frame_w, frame_h)
    return _launch_unpack(buf, ah, aw, frame_w, frame_h, blocks=True)


def _launch_unpack(buf, ah, aw, frame_w, frame_h, blocks):
    """K12 over a CUDA wire, its outputs views into one allocation."""
    if ah % MB or aw % MB or not 0 < aw <= K12_MAX_WIDTH or ah <= 0:
        raise ValueError(f"unpack_yuv5d: aligned dims must be positive "
                         f"multiples of {MB}, the width at most "
                         f"{K12_MAX_WIDTH}; got {ah}x{aw}")
    ys, cs = ah * aw, (ah // 2) * (aw // 2)
    if 5 * (ys + 2 * cs) >= 2 ** 31:
        raise ValueError("unpack_yuv5d: 2^31 wire bits or more")
    _build.check(buf, "buf", torch.uint8, (yuv5d_nbytes(ah, aw),))
    if buf.data_ptr() % 4:   # the wire's words as aligned 4-byte loads
        buf = buf.clone()
    n = (ah // MB) * (aw // MB)
    out = torch.empty(ys + 2 * cs + (n if blocks else 0), dtype=I32,
                      device=buf.device)
    y, u, v = out[:ys], out[ys:ys + cs], out[ys + cs:ys + 2 * cs]
    sad = out[ys + 2 * cs:] if blocks else None
    fn = _build.kernel_fn("cairo_unpack_yuv5d", UNPACK_SIGNATURE)
    _build.launch(fn, buf.device, buf.data_ptr(), ah, aw, frame_w, frame_h,
                  int(blocks), y.data_ptr(), u.data_ptr(), v.data_ptr(),
                  sad.data_ptr() if blocks else None)
    LAUNCHES["unpack_yuv5d"] += 1
    if blocks:
        return ((y.view(n, MB, MB), u.view(n, MB // 2, MB // 2),
                 v.view(n, MB // 2, MB // 2)), sad)
    return y.view(ah, aw), u.view(ah // 2, aw // 2), v.view(ah // 2, aw // 2)


# --------------------------------------------------------------------------
# decoder input: packed block table + residual COO

def pack_table_np(bt):
    """Host side: BlockTable -> one uint8 buffer (10N bytes)."""
    return np.concatenate([
        np.ascontiguousarray(bt.motion_x, np.int16).view(np.uint8),
        np.ascontiguousarray(bt.motion_y, np.int16).view(np.uint8),
        np.ascontiguousarray(bt.block_type, np.uint8),
        np.ascontiguousarray(bt.prediction_target, np.uint8),
        bt.sp_pred.astype(np.uint8), bt.sp_amount.astype(np.uint8),
        np.ascontiguousarray(bt.sp_index, np.uint8),
        np.ascontiguousarray(bt.q_index, np.uint8)])


def unpack_table_wire(buf, n):
    """Device side: uint8 (10N,) -> dict of (N,) tensors."""
    return dict(
        motion_x=_view(buf[0:2 * n], torch.int16),
        motion_y=_view(buf[2 * n:4 * n], torch.int16),
        block_type=buf[4 * n:5 * n],
        prediction_target=buf[5 * n:6 * n],
        sp_pred=buf[6 * n:7 * n] != 0,
        sp_amount=buf[7 * n:8 * n] != 0,
        sp_index=buf[8 * n:9 * n],
        q_index=buf[9 * n:10 * n])


# --------------------------------------------------------------------------
# decoder output wires

def _in_frame_flat(y, u, frame_w, frame_h):
    ah, aw = y.shape
    ch, cw = u.shape
    yin = _frame_mask(ah, aw, frame_h, frame_w, y.device)
    cin = _frame_mask(ch, cw, (frame_h + 1) // 2, (frame_w + 1) // 2,
                      y.device)
    return torch.cat([yin.reshape(-1), cin.reshape(-1), cin.reshape(-1)])


def pack_yuv_wire(y, u, v, frame_w, frame_h):
    """Device side. y/u/v int32 recon planes -> one uint8 wire: the planes
    as bytes (Y minus its +16 offset, chroma as-is) + count + an exception
    list with the exact value of every in-frame pixel off the byte
    window. count > EXC_K makes the caller refetch the exact planes."""
    cat = torch.cat([p.reshape(-1) for p in (y, u, v)])
    shifted = cat.clone()
    shifted[:y.numel()] -= Y_SHIFT
    lo = torch.clamp(shifted, 0, 255).to(torch.uint8)
    mask = ((shifted < 0) | (shifted > 255)) & \
        _in_frame_flat(y, u, frame_w, frame_h)
    exc_pos, exc_val, count = _compact(cat, mask, EXC_K)
    return torch.cat([lo, _u8(count.reshape(1)), _u8(exc_pos),
                      _u8(exc_val)])


def yuv_wire_nbytes(ah, aw):
    total = ah * aw + 2 * (ah // 2) * (aw // 2)
    return total + 4 + 6 * EXC_K


def yuv5d_wire_nbytes(ah, aw):
    total = ah * aw + 2 * (ah // 2) * (aw // 2)
    return 4 + 6 * DEXC_K + total * 5 // 8


def _pack_fields5(st):
    """(G*32,) int32 fields in [-16, 15] -> (G*5,) int32 words."""
    f = (st & 31).to(torch.int64).reshape(-1, 32)
    words = [torch.zeros(f.shape[0], dtype=torch.int64, device=st.device)
             for _ in range(5)]
    for i in range(32):
        b = 5 * i
        k, s = b >> 5, b & 31
        words[k] = words[k] | (f[:, i] << s)
        if s > 27:
            words[k + 1] = words[k + 1] | (f[:, i] >> (32 - s))
    packed = torch.stack(words, 1).reshape(-1) & 0xFFFFFFFF
    return torch.where(packed >= 1 << 31, packed - (1 << 32), packed).to(I32)


def pack_yuv5d_wire(y, u, v, frame_w, frame_h):
    """Device side. y/u/v int32 recon planes -> one uint8 wire: [count i32
    | DEXC_K exc_pos i32 | DEXC_K exc_val i16 | packed fields]. Values are
    in the shifted space (Y minus its +16 offset); exceptions carry the
    exact absolute value of in-frame cells whose delta clipped."""
    def deltas(g):
        d = g.clone()
        d[:, 1:] = g[:, 1:] - g[:, :-1]
        d[1:, 0] = g[1:, 0] - g[:-1, 0]
        return d

    y_sh = y - Y_SHIFT
    d = torch.cat([deltas(p).reshape(-1) for p in (y_sh, u, v)])
    st = torch.clamp(d, -16, 15)
    cat = torch.cat([p.reshape(-1) for p in (y_sh, u, v)])
    mask = (st != d) & _in_frame_flat(y, u, frame_w, frame_h)
    exc_pos, exc_val, count = _compact(cat, mask, DEXC_K)
    return torch.cat([_u8(count.reshape(1)), _u8(exc_pos), _u8(exc_val),
                      _u8(_pack_fields5(st))])


def unpack_yuv_wire_np(buf, ah, aw):
    """Host-side numpy unpack of the 8-bit YUV wire. Returns (y, u, v int16
    planes, oob_count)."""
    buf = np.asarray(buf)
    total = ah * aw + 2 * (ah // 2) * (aw // 2)
    vals = buf[:total].astype(np.int32)
    vals[:ah * aw] += Y_SHIFT
    o = total
    count = int(buf[o:o + 4].view(np.int32)[0])
    exc_pos = buf[o + 4:o + 4 + 4 * EXC_K].view(np.int32)
    exc_val = buf[o + 4 + 4 * EXC_K:o + 4 + 6 * EXC_K].view(np.int16)
    if count > 0:
        k = min(count, EXC_K)
        vals[exc_pos[:k]] = exc_val[:k]
    y = vals[:ah * aw].reshape(ah, aw).astype(np.int16)
    cs = (ah // 2) * (aw // 2)
    u = vals[ah * aw:ah * aw + cs].reshape(ah // 2, aw // 2).astype(np.int16)
    v = vals[ah * aw + cs:].reshape(ah // 2, aw // 2).astype(np.int16)
    return y, u, v, count
