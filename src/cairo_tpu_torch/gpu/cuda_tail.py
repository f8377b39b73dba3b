"""The fast step's transform tail: kernels K10 encode_tail and K11
decode_tail, with their plain PyTorch versions.

Neither replaces a Pallas kernel: on the TPU the tail runs inside the jit
of the fast steps, and XLA fuses it into a few kernels
(cairo_tpu/tpu/engine.py:219-281, encode_step from the residual to the
reconstruction; :329-378, _decode_common's reconstruction, with
decode_step_coo's coefficient carry :453-465).

Dispatch, one rule per wrapper: a CPU tensor takes the plain version; a
CUDA tensor launches the kernel of csrc/tail.cu or raises. Each launch
adds one to LAUNCHES[name].

  * encode_tail (K10): source and prediction planes -> the residual, the
    forward DCT, the variance and adaptive QP, quantization, the
    coefficient planes (stale on copy MBs) and the reconstruction before
    the deblock. Its plain version is the torch chain engine.encode_planes
    ran, engine.quantize_planes and engine.reconstruct included.
  * decode_tail (K11): coefficient planes -> the optional stale carry of
    copy MBs (engine.carry_coef), dequantization, the inverse DCT
    (engine.residual) and the prediction add (engine.add_pred); on
    request also the residual blocks the wave decode (K7) reads. It reads
    the reciprocal table's divisors (reciprocals(), built once per
    device), as K10 does.

Planes go in and out; the kernels cut the MBs themselves. This module and
engine import each other: engine calls the wrappers, the plain versions
call engine's helpers, and neither reads the other at import.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables
from . import _build, engine, ops

MB = tables.MACROBLOCK_SIZE
I32 = torch.int32
I16 = torch.int16
TOP = tables.MAX_QUANT_LEVELS - 1
_FLAGS = (torch.bool, torch.uint8)
# the ctypes signatures of csrc/tail.cu's C entries, the stream last
ENCODE_SIGNATURE = "p" * 14 + "i" * 4 + "p" * 9
DECODE_SIGNATURE = "p" * 13 + "i" * 2 + "p" * 10

LAUNCHES = {"encode_tail": 0, "decode_tail": 0}


def _blocks(planes):
    """(Y, U, V) planes -> MB blocks ((N, 16, 16), (N, 8, 8), (N, 8, 8))."""
    return (ops.plane_to_blocks(planes[0], MB),
            ops.plane_to_blocks(planes[1], MB // 2),
            ops.plane_to_blocks(planes[2], MB // 2))


def _planes(blocks, h, w):
    return (ops.blocks_to_plane(blocks[0], h, w),
            ops.blocks_to_plane(blocks[1], h // 2, w // 2),
            ops.blocks_to_plane(blocks[2], h // 2, w // 2))


# ------------------------------------------------------------ plain versions

def encode_tail_plain(src, pred, is_intra, is_motion, is_copy, quality,
                      adaptive, coef):
    h, w = src[0].shape
    n = (h // MB) * (w // MB)
    is_intra, is_motion, copy_mb = (f.bool() for f in (is_intra, is_motion,
                                                       is_copy))
    pred = _blocks(pred)
    res = tuple(ops.wrap16(s - p) for s, p in zip(_blocks(src), pred))
    ty = ops.quads_to_mb(ops.fdct8(ops.mb_quads(res[0])))
    tu, tv = ops.fdct8(res[1]), ops.fdct8(res[2])
    variance = ops.block_variance2(ty)
    qp = ops.adaptive_qp(quality, ty) if adaptive else \
        torch.full((n,), 0, dtype=I32, device=ty.device) + quality
    intra_qm = is_intra & ~is_motion  # INTRA_DEFAULT only
    qy, qu, qv = engine.quantize_planes(ty, tu, tv, qp, intra_qm)

    # coefficient planes (stale persistence for copy blocks)
    copy3 = copy_mb[:, None, None]
    qy_mb = ops.quads_to_mb(qy.reshape(-1, 4, 8, 8))
    new_coef = tuple(
        ops.blocks_to_plane(torch.where(
            copy3, ops.plane_to_blocks(old, size).to(I32), q), *old.shape)
        .to(I16) for old, q, size in zip(coef, (qy_mb, qu, qv),
                                         (MB, MB // 2, MB // 2)))
    rec = engine.reconstruct(qy, qu, qv, qp, intra_qm, pred, copy_mb)
    return (new_coef, qp, ops.wrap16(variance).to(I16),
            _planes(rec, h, w))


def decode_tail_plain(coef, qp, intra_default, is_copy, pred, stale=None,
                      residual=False):
    h, w = coef[0].shape
    intra_default, is_copy = intra_default.bool(), is_copy.bool()
    if stale is not None:
        coef = engine.carry_coef(stale, is_copy, coef)
    res = engine.residual(*engine.coef_blocks(*coef), qp, intra_default)
    rec = engine.add_pred(res, _blocks(pred), is_copy)
    carried = None if stale is None else tuple(c.to(I16) for c in coef)
    return _planes(rec, h, w), carried, res if residual else None


# ----------------------------------------------------------------- checks

def _grid(plane, name):
    """(h, w, MBs) of a luma plane the kernels take."""
    h, w = plane.shape
    if h % MB or w % MB:
        raise ValueError(f"{name}: plane dims must be multiples of 16")
    if h * w >= 2 ** 31:
        raise ValueError(f"{name}: planes of 2^31 samples or more")
    return h, w, (h // MB) * (w // MB)


def _check_planes(planes, name, dtype, h, w, dev):
    for t, p, shape in zip(planes, "yuv", ((h, w), (h // 2, w // 2),
                                           (h // 2, w // 2))):
        _build.check(t, f"{name}_{p}", dtype, shape)
        _same_device(t, f"{name}_{p}", dev)


def _check_field(t, name, kinds, n, dev):
    if not torch.is_tensor(t) or t.dtype not in kinds:
        raise ValueError(f"{name}: expected a tensor of one of {kinds}")
    _build.check(t, name, t.dtype, (n,))
    _same_device(t, name, dev)


def _same_device(t, name, dev):
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, the planes on {dev}")


def _ptrs(ts):
    return tuple(t.data_ptr() for t in ts)


# ----------------------------------------------------------------- K10

# The layout of the reciprocal table (csrc/tail.cu, R_*), in int32 words:
# an int4 (m, s - 1, d, d // 2) per divisor d, its reciprocal (m, s) as
# reciprocal(d) gives it. K10 divides by the reciprocals; K11 reads the
# matrix entries and DC scales from the d words.
RECIP_LAYOUT = dict(QM=0, QP2=512, DCL=1536, DCC=2560, SF=3584, WORDS=3588)


def reciprocal(d):
    """The round-up reciprocal (m, s) of a divisor d >= 2: s =
    ceil(log2 d) and m = ceil(2^(32 + s) / d) - 2^32, so that floor(n / d)
    = floor(n (2^32 + m) / 2^(32 + s)) for every uint32 n (Granlund and
    Montgomery): 2^(32 + s) <= (2^32 + m) d <= 2^(32 + s) + 2^s."""
    d = int(d)
    if d < 2:
        raise ValueError(f"reciprocal: divisor {d} below 2")
    s = (d - 1).bit_length()
    return -(-(1 << (32 + s)) // d) - (1 << 32), s


def reciprocals():
    """The reciprocal table (RECIP_LAYOUT) as int32 words: every divisor
    K10's quantizer meets. The intra and inter matrices, qp << 1 for qp
    0..255 (qp 0 as 1: K10 never divides by 0, and the plain version
    cannot either), the LUMA_DC and CHROMA_DC scales by qp and the scale
    factor."""
    words = np.zeros(RECIP_LAYOUT["WORDS"], np.int64)

    def put(at, d):
        m, sh = reciprocal(d)
        words[at:at + 4] = m, sh - 1, int(d), int(d) // 2

    lay = RECIP_LAYOUT
    for k, qm in enumerate((tables.INTRA_QM_8x8, tables.INTER_QM_8x8)):
        for i, d in enumerate(np.asarray(qm).reshape(-1)):
            put(lay["QM"] + 4 * (64 * k + i), d)
    qp = np.arange(256)
    for at, ds in ((lay["QP2"], np.maximum(qp, 1) << 1),
                   (lay["DCL"], tables.luma_dc_scale(qp)),
                   (lay["DCC"], tables.chroma_dc_scale(qp))):
        for i, d in enumerate(ds):
            put(at + 4 * i, d)
    put(lay["SF"], tables.QUANTIZER_SCALE_FACTOR)
    return words.astype(np.uint32).view(np.int32)


@functools.lru_cache(maxsize=None)
def _recip(index: int):
    """reciprocals() on CUDA device `index`, made once."""
    dev = f"cuda:{index}"
    return ops.settled(dev, torch.as_tensor(reciprocals(), device=dev))


def _aligned(t):
    """t, or a copy of it where its data does not start on 16 bytes (K10's
    and K11's vector loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def encode_tail(src, pred, is_intra, is_motion, is_copy, quality, adaptive,
                coef):
    """The transform tail of one fast-mode frame (engine.encode_planes).
    Returns (coef, qp, variance, rec): the new coefficient planes, int16
    (a copy MB keeps the stale ones of `coef`); per-MB qp, int32, and the
    wrapped variance, int16; the reconstruction planes before the
    deblock, int32 (a copy MB's is its prediction). The outputs are views
    into one buffer.

    src, pred: (Y (H, W), U, V (H/2, W/2)) int32 planes, the source and
    K4's prediction (zero where intra); is_intra, is_motion, is_copy:
    (N,) bool or uint8 per MB; quality: the frame's quality, an int32
    scalar tensor read on the device, or an int; adaptive: whether qp
    adapts to each MB's variance (else it is the quality: 1..255 then);
    coef: the state's int16 coefficient planes. The inputs are left as
    they are."""
    if src[0].device.type == "cpu":
        return encode_tail_plain(src, pred, is_intra, is_motion, is_copy,
                                 quality, adaptive, coef)
    h, w, n = _grid(src[0], "encode_tail")
    dev = src[0].device
    index = dev.index
    ys, cs = (h, w), (h // 2, w // 2)
    if not (isinstance(quality, torch.Tensor) and quality.dtype == I32
            and quality.is_cuda):
        quality = torch.as_tensor(quality, dtype=I32, device=dev)
    _build.check_many([
        *((t, f"src_{p}", (I32,), s) for t, p, s in zip(src, "yuv",
                                                         (ys, cs, cs))),
        *((t, f"pred_{p}", (I32,), s) for t, p, s in zip(pred, "yuv",
                                                          (ys, cs, cs))),
        *((t, f"coef_{p}", (I16,), s) for t, p, s in zip(coef, "yuv",
                                                          (ys, cs, cs))),
        (is_intra, "is_intra", _FLAGS, (n,)),
        (is_motion, "is_motion", _FLAGS, (n,)),
        (is_copy, "is_copy", _FLAGS, (n,)),
        (quality, "quality", (I32,), quality.shape)], index)
    if quality.numel() != 1:
        raise ValueError(f"quality: expected one value, got shape "
                         f"{tuple(quality.shape)}")
    planes = [_aligned(t) for t in (*src, *pred, *coef)]
    hw, chw = h * w, h * w // 4
    buf = torch.empty(6 * hw + 3 * hw + 6 * n, dtype=torch.uint8,
                      device=dev)
    parts = buf.split([4 * hw, 4 * chw, 4 * chw, 2 * hw, 2 * chw, 2 * chw,
                       4 * n, 2 * n])
    rec = tuple(p.view(I32).view(s) for p, s in zip(parts[:3], (ys, cs, cs)))
    out = tuple(p.view(I16).view(s) for p, s in zip(parts[3:6],
                                                    (ys, cs, cs)))
    qp, variance = parts[6].view(I32), parts[7].view(I16)
    fn = _build.kernel_fn("cairo_encode_tail", ENCODE_SIGNATURE)
    _build.launch(fn, dev, *(t.data_ptr() for t in planes[:6]),
                  is_intra.data_ptr(), is_motion.data_ptr(),
                  is_copy.data_ptr(), quality.data_ptr(),
                  *(t.data_ptr() for t in planes[6:]),
                  _recip(index).data_ptr(), h, w,
                  int(bool(adaptive)), TOP, *(t.data_ptr() for t in out),
                  qp.data_ptr(), variance.data_ptr(),
                  *(t.data_ptr() for t in rec))
    LAUNCHES["encode_tail"] += 1
    return out, qp, variance, rec


# ----------------------------------------------------------------- K11

@functools.lru_cache(maxsize=None)
def _scale_factor():
    """K11's compile-time scale factor (csrc/tail.cu, k11::SF), checked
    once a process against tables.QUANTIZER_SCALE_FACTOR."""
    sf = _build.kernel_fn("cairo_decode_tail_sf", "")()
    if sf != tables.QUANTIZER_SCALE_FACTOR:
        raise RuntimeError(f"decode_tail: the kernel divides by {sf}, the "
                           f"tables by {tables.QUANTIZER_SCALE_FACTOR}")
    return sf


def _decode_messages(coef, qp, intra_default, is_copy, pred, stale, h, w,
                     n, dev):
    """Raises the message decode_tail gives for the first argument it
    cannot take (called once _build.check_many has refused one)."""
    _check_planes(coef, "coef", I32, h, w, dev)
    _check_planes(pred, "pred", I32, h, w, dev)
    if stale is not None:
        _check_planes(stale, "stale", I16, h, w, dev)
    _check_field(qp, "qp", (I32,), n, dev)
    for t, name in ((intra_default, "intra_default"), (is_copy, "is_copy")):
        _check_field(t, name, _FLAGS, n, dev)


def decode_tail(coef, qp, intra_default, is_copy, pred, stale=None,
                residual=False):
    """The reconstruction of one fast-mode frame before the deblock
    (engine.decode_planes). Returns (rec, carried, res): the int32
    reconstruction planes (a copy MB's is its prediction); where `stale`
    is given, the frame's coefficient planes after the carry, int16 (else
    None); where `residual` is set, the residual blocks ((N, 16, 16),
    (N, 8, 8), (N, 8, 8)) int32 that K7 reads (else None). The outputs
    are views into one buffer.

    coef: (Y (H, W), U, V (H/2, W/2)) int32 coefficient planes, int16
    values (csrc/tail.cu's domain); qp: (N,) int32, 0..255;
    intra_default, is_copy: (N,) bool or uint8; pred: int32 prediction
    planes; stale: the state's int16 coefficient planes, which copy MBs
    take in place of `coef` (decode_step_coo and the wave decode), or
    None. The inputs are left as they are."""
    if coef[0].device.type == "cpu":
        return decode_tail_plain(coef, qp, intra_default, is_copy, pred,
                                 stale, residual)
    h, w, n = _grid(coef[0], "decode_tail")
    dev = coef[0].device
    ys, cs = (h, w), (h // 2, w // 2)
    shapes = (ys, cs, cs)
    try:
        _build.check_many([
            *((t, f"coef_{p}", (I32,), s) for t, p, s in zip(coef, "yuv",
                                                              shapes)),
            *((t, f"pred_{p}", (I32,), s) for t, p, s in zip(pred, "yuv",
                                                              shapes)),
            *((t, f"stale_{p}", (I16,), s) for t, p, s in zip(
                stale or (), "yuv", shapes)),
            (qp, "qp", (I32,), (n,)),
            (intra_default, "intra_default", _FLAGS, (n,)),
            (is_copy, "is_copy", _FLAGS, (n,))], dev.index)
    except ValueError:
        _decode_messages(coef, qp, intra_default, is_copy, pred, stale, h,
                         w, n, dev)
        raise
    _scale_factor()
    planes = [_aligned(t) for t in (*coef, *pred, *(stale or ()))]
    hw, chw = h * w, h * w // 4
    sizes = [4 * hw, 4 * chw, 4 * chw]
    if stale is not None:
        sizes += [2 * hw, 2 * chw, 2 * chw]
    if residual:
        sizes += [4 * 256 * n, 4 * 64 * n, 4 * 64 * n]
    parts = torch.empty(sum(sizes), dtype=torch.uint8, device=dev) \
        .split(sizes)
    rec = tuple(p.view(I32).view(s) for p, s in zip(parts, shapes))
    carried = None if stale is None else tuple(
        p.view(I16).view(s) for p, s in zip(parts[3:6], shapes))
    res = None if not residual else tuple(
        p.view(I32).view(n, m, m) for p, m in zip(parts[-3:],
                                                  (MB, MB // 2, MB // 2)))
    none = (None, None, None)
    fn = _build.kernel_fn("cairo_decode_tail", DECODE_SIGNATURE)
    _build.launch(fn, dev, *_ptrs(planes[:3]), qp.data_ptr(),
                  intra_default.data_ptr(), is_copy.data_ptr(),
                  *_ptrs(planes[3:6]), *(_ptrs(planes[6:]) or none),
                  _recip(dev.index).data_ptr(), h, w, *_ptrs(rec),
                  *(none if carried is None else _ptrs(carried)),
                  *(none if res is None else _ptrs(res)))
    LAUNCHES["decode_tail"] += 1
    return rec, carried, res
