"""Copy of cairo_tpu.native: the C++ entropy coder, wire converters and sequential decoder, via ctypes."""

from __future__ import annotations

import ctypes

import numpy as np

from ..blocktypes import BlockTable

_lib = None


def lib():
    """The native library, built with g++ into the port's build directory
    (gpu/_build.py) on first use."""
    global _lib
    if _lib is None:
        from ..gpu import _build
        L = _build.load("native")
        u8 = ctypes.POINTER(ctypes.c_uint8)
        i16 = ctypes.POINTER(ctypes.c_int16)
        u = ctypes.c_uint
        u64 = ctypes.c_ulonglong
        L.evxn_encode_slice.restype = ctypes.c_longlong
        L.evxn_encode_slice.argtypes = [u, u, u] + [u8, u8, i16, i16, u8, u8, u8, u8] + \
            [i16, i16, i16, u, u, u8, u64]
        L.evxn_decode_slice.restype = ctypes.c_longlong
        L.evxn_decode_slice.argtypes = [u8, u64, u, u, u] + \
            [u8, u8, i16, i16, u8, u8, u8, u8] + [i16, i16, i16, u, u]
        i32 = ctypes.POINTER(ctypes.c_int)
        L.evxn_extract_coo.restype = ctypes.c_longlong
        L.evxn_extract_coo.argtypes = [u8, u, u, i16, i16, i16, u, u,
                                       i32, i16, ctypes.c_longlong]
        L.evxn_yuv_wire_to_rgb.restype = ctypes.c_longlong
        L.evxn_yuv_wire_to_rgb.argtypes = [u8, u, u, u, u, u, u8]
        L.evxn_rgb_to_yuv8.restype = ctypes.c_longlong
        L.evxn_rgb_to_yuv8.argtypes = [u8, u, u, u, u, u8]
        L.evxn_pack_yuv5d.restype = ctypes.c_longlong
        L.evxn_pack_yuv5d.argtypes = [u8, u, u, u, u8,
                                      ctypes.POINTER(ctypes.c_int), i16]
        L.evxn_yuv5d_wire_to_rgb.restype = ctypes.c_longlong
        L.evxn_yuv5d_wire_to_rgb.argtypes = [u8, u, u, u, u, u, i16, u8]
        p32 = ctypes.POINTER(ctypes.c_int32)
        vp = ctypes.c_void_p
        L.evxn_dec_create.restype = vp
        L.evxn_dec_create.argtypes = [u, u]
        L.evxn_dec_destroy.argtypes = [vp]
        L.evxn_dec_set_tables.argtypes = [p32] * 7
        L.evxn_dec_set_ring.argtypes = [vp, ctypes.c_int, i16, i16, i16]
        L.evxn_dec_get_ring.argtypes = [vp, ctypes.c_int, i16, i16, i16]
        L.evxn_dec_frame.restype = ctypes.c_longlong
        L.evxn_dec_frame.argtypes = [vp, ctypes.c_int] + \
            [u8, u8, i16, i16, u8, u8, u8, u8] + [i16, i16, i16, u, u, u8]
        _lib = L
    return _lib


def _p8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _p16(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def _bt_arrays(bt: BlockTable):
    """Contiguous uint8/int16 views of the table for the C ABI."""
    return (np.ascontiguousarray(bt.block_type, dtype=np.uint8),
            np.ascontiguousarray(bt.prediction_target, dtype=np.uint8),
            np.ascontiguousarray(bt.motion_x, dtype=np.int16),
            np.ascontiguousarray(bt.motion_y, dtype=np.int16),
            np.ascontiguousarray(bt.sp_pred, dtype=np.uint8),
            np.ascontiguousarray(bt.sp_amount, dtype=np.uint8),
            np.ascontiguousarray(bt.sp_index, dtype=np.uint8),
            np.ascontiguousarray(bt.q_index, dtype=np.uint8))


def encode_slice(bt: BlockTable, y: np.ndarray, u: np.ndarray, v: np.ndarray
                 ) -> tuple[bytes, int]:
    """Serializes one slice; returns (byte chunk, bit count)."""
    height, width = y.shape
    wb, hb = width // 16, height // 16
    n = len(bt)
    arrays = _bt_arrays(bt)
    y = np.ascontiguousarray(y, dtype=np.int16)
    u = np.ascontiguousarray(u, dtype=np.int16)
    v = np.ascontiguousarray(v, dtype=np.int16)
    cap = 4 * (width * height * 2 + 4096)
    out = np.zeros(cap, dtype=np.uint8)
    bits = lib().evxn_encode_slice(
        n, wb, hb, _p8(arrays[0]), _p8(arrays[1]), _p16(arrays[2]),
        _p16(arrays[3]), _p8(arrays[4]), _p8(arrays[5]), _p8(arrays[6]),
        _p8(arrays[7]), _p16(y), _p16(u), _p16(v), width, height,
        _p8(out), cap)
    if bits < 0:
        raise RuntimeError("slice overflowed output capacity")
    nbytes = (bits + 7) // 8
    return out[:nbytes].tobytes(), int(bits)


def decode_slice(data: bytes, bit_offset: int, bt: BlockTable, y: np.ndarray,
                 u: np.ndarray, v: np.ndarray) -> int:
    """Deserializes one slice starting at bit_offset (must be byte-aligned)
    into the persistent table/planes. Returns bits consumed."""
    assert bit_offset % 8 == 0
    height, width = y.shape
    wb, hb = width // 16, height // 16
    n = len(bt)
    buf = np.frombuffer(data, dtype=np.uint8)[bit_offset // 8:]
    buf = np.ascontiguousarray(buf)
    bit_limit = len(buf) * 8
    assert y.flags.c_contiguous and u.flags.c_contiguous and v.flags.c_contiguous
    a = _bt_arrays(bt)
    bits = lib().evxn_decode_slice(
        _p8(buf), bit_limit, n, wb, hb,
        _p8(a[0]), _p8(a[1]), _p16(a[2]), _p16(a[3]), _p8(a[4]), _p8(a[5]),
        _p8(a[6]), _p8(a[7]), _p16(y), _p16(u), _p16(v), width, height)
    if bits < 0:
        raise ValueError(
            "corrupt evx1 slice: illegal golomb code or coefficient count")
    # copy back into the table (views may have been copies)
    bt.block_type[:] = a[0]
    bt.prediction_target[:] = a[1]
    bt.motion_x[:] = a[2]
    bt.motion_y[:] = a[3]
    bt.sp_pred[:] = a[4].astype(bool)
    bt.sp_amount[:] = a[5].astype(bool)
    bt.sp_index[:] = a[6]
    bt.q_index[:] = a[7]
    return int(bits)


def extract_coo(block_type: np.ndarray, wb: int, y: np.ndarray,
                u: np.ndarray, v: np.ndarray, cap: int
                ) -> tuple[np.ndarray, np.ndarray, int]:
    """Nonzero residuals of non-copy MBs as (pos, val, count) over the
    concatenated Y|U|V plane space (decoder upload format, gpu/wire.py).
    count may exceed cap: caller must then use the dense path."""
    height, width = y.shape
    bt8 = np.ascontiguousarray(block_type, dtype=np.uint8)
    pos = np.zeros(cap, np.int32)
    val = np.zeros(cap, np.int16)
    n = len(bt8)
    count = lib().evxn_extract_coo(
        _p8(bt8), n, wb, _p16(y), _p16(u), _p16(v), width, height,
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), _p16(val), cap)
    return pos, val, int(count)


def rgb_to_yuv8(rgb: np.ndarray, aw: int, ah: int, frame_index: int = 0,
                quality: int = 0) -> np.ndarray:
    """Converts an (H, W, 3) uint8 frame to the 8-bit YUV source wire
    (gpu/wire.py layout) over the aligned (ah, aw) grid, prefixed with the
    8-byte [frame_index, quality] int32 header the device step reads."""
    height, width = rgb.shape[:2]
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    total = ah * aw + 2 * (ah // 2) * (aw // 2)
    out = np.empty(8 + total, np.uint8)
    out[:8] = np.array([frame_index, quality], np.int32).view(np.uint8)
    payload = out[8:]
    lib().evxn_rgb_to_yuv8(_p8(rgb), width, height, aw, ah, _p8(payload))
    return out


UP_EXC_K = 8192  # must match gpu.wire.UP_EXC_K


def yuv8_to_yuv5d(yuv8: np.ndarray, aw: int, ah: int):
    """Packs an 8-bit source wire (with its 8-byte header) into the
    5-bit-delta wire, whatever the frame size. Returns (exception count,
    wire); the wire is exact only when the count is <= UP_EXC_K."""
    total = ah * aw + 2 * (ah // 2) * (aw // 2)
    out = np.zeros(8 + 6 * UP_EXC_K + total * 5 // 8, np.uint8)
    out[:8] = yuv8[:8]
    exc_pos = np.empty(UP_EXC_K, np.int32)
    exc_val = np.zeros(UP_EXC_K, np.int16)
    payload = np.ascontiguousarray(yuv8[8:])
    packed = out[8 + 6 * UP_EXC_K:]
    n_exc = lib().evxn_pack_yuv5d(
        _p8(payload), aw, ah, UP_EXC_K, _p8(packed),
        exc_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        _p16(exc_val))
    if n_exc <= UP_EXC_K:
        exc_pos[n_exc:] = total  # out-of-range sentinel -> scatter drops
        out[8:8 + 4 * UP_EXC_K] = exc_pos.view(np.uint8)
        out[8 + 4 * UP_EXC_K:8 + 6 * UP_EXC_K] = exc_val.view(np.uint8)
    return int(n_exc), out


def rgb_to_yuv5d(rgb: np.ndarray, aw: int, ah: int, frame_index: int = 0,
                 quality: int = 0):
    """Converts a frame to the 5-bit-delta source wire (gpu/wire.py
    unpack_yuv5d layout). Returns (kind, wire): kind "yuv5d" on success,
    or "yuv8" with the plain wire when the frame is too small for the
    fixed exception section to pay off or the content needs more than
    UP_EXC_K exceptions."""
    yuv8 = rgb_to_yuv8(rgb, aw, ah, frame_index, quality)
    total = ah * aw + 2 * (ah // 2) * (aw // 2)
    if 6 * UP_EXC_K + total * 5 // 8 >= total:
        return "yuv8", yuv8  # tiny frames: the exception section dominates
    n_exc, out = yuv8_to_yuv5d(yuv8, aw, ah)
    if n_exc > UP_EXC_K:
        return "yuv8", yuv8
    return "yuv5d", out


class NativeDecoder:
    """Sequential C++ frame reconstruction (decoder.cpp): the runtime path
    for streams the batched device decoder cannot take (intra-motion blocks,
    i.e. reference-encoder streams). Mirrors cpuref.engine.decode_slice +
    deblock + RGB conversion; differentially tested against it."""

    _tables_set = False

    def __init__(self, aligned_w: int, aligned_h: int):
        from .. import tables
        L = lib()
        if not NativeDecoder._tables_set:
            def p32(a):
                a = np.ascontiguousarray(a, dtype=np.int32)
                return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            holds = [p32(x) for x in (
                tables.DCT_BASIS_8.reshape(-1),
                tables.INTRA_QM_8x8.reshape(-1),
                tables.INTER_QM_8x8.reshape(-1),
                tables.luma_dc_scale(np.arange(32)),
                tables.chroma_dc_scale(np.arange(32)),
                tables.DEBLOCK_ALPHA, tables.DEBLOCK_BETA)]
            L.evxn_dec_set_tables(*[h[1] for h in holds])
            NativeDecoder._tables_set = True
        self._h = L.evxn_dec_create(aligned_w, aligned_h)
        self.aw, self.ah = aligned_w, aligned_h

    def __del__(self):
        h = getattr(self, "_h", None)
        if h and _lib is not None:  # may run at interpreter shutdown
            _lib.evxn_dec_destroy(h)
            self._h = None

    def set_ring(self, slot: int, y: np.ndarray, u: np.ndarray,
                 v: np.ndarray):
        lib().evxn_dec_set_ring(
            self._h, slot, _p16(np.ascontiguousarray(y, np.int16)),
            _p16(np.ascontiguousarray(u, np.int16)),
            _p16(np.ascontiguousarray(v, np.int16)))

    def get_ring(self, slot: int):
        y = np.empty((self.ah, self.aw), np.int16)
        u = np.empty((self.ah // 2, self.aw // 2), np.int16)
        v = np.empty((self.ah // 2, self.aw // 2), np.int16)
        lib().evxn_dec_get_ring(self._h, slot, _p16(y), _p16(u), _p16(v))
        return y, u, v

    def decode_frame(self, bt: BlockTable, y: np.ndarray, u: np.ndarray,
                     v: np.ndarray, frame_index: int, width: int,
                     height: int) -> np.ndarray:
        a = _bt_arrays(bt)
        rgb = np.empty((height, width, 3), np.uint8)
        ret = lib().evxn_dec_frame(
            self._h, frame_index, _p8(a[0]), _p8(a[1]), _p16(a[2]),
            _p16(a[3]), _p8(a[4]), _p8(a[5]), _p8(a[6]), _p8(a[7]),
            _p16(np.ascontiguousarray(y, np.int16)),
            _p16(np.ascontiguousarray(u, np.int16)),
            _p16(np.ascontiguousarray(v, np.int16)),
            width, height, _p8(rgb))
        if ret == -2:
            raise ValueError(
                "corrupt evx1 block table: out-of-range q_index or motion "
                "vector reaching outside the frame")
        if ret != 0:
            raise RuntimeError("native decode failed")
        return rgb


def yuv_wire_to_rgb(wire: np.ndarray, aw: int, ah: int, width: int,
                    height: int, exc_k: int) -> tuple[np.ndarray, int]:
    """Converts the decoder's 8-bit YUV wire to (H, W, 3) uint8 RGB.
    Returns (rgb, exception_count); count > exc_k means the wire was not
    exact and the caller must refetch exact planes."""
    wire = np.ascontiguousarray(wire, dtype=np.uint8)
    rgb = np.empty((height, width, 3), np.uint8)
    count = lib().evxn_yuv_wire_to_rgb(_p8(wire), aw, ah, width, height,
                                       exc_k, _p8(rgb))
    return rgb, int(count)


def yuv5d_wire_to_rgb(wire: np.ndarray, aw: int, ah: int, width: int,
                      height: int, exc_k: int,
                      tmp: np.ndarray) -> tuple[np.ndarray, int]:
    """Converts the decoder's 5-bit-delta YUV wire (gpu/wire.py
    pack_yuv5d_wire) to (H, W, 3) uint8 RGB. `tmp` is a caller-owned
    int16 scratch of ah*aw + 2*(ah//2 * aw//2) elements. Returns
    (rgb, exception_count); count > exc_k means the wire was clipped and
    the caller must refetch exact planes (rgb is untouched then)."""
    wire = np.ascontiguousarray(wire, dtype=np.uint8)
    rgb = np.empty((height, width, 3), np.uint8)
    count = lib().evxn_yuv5d_wire_to_rgb(_p8(wire), aw, ah, width, height,
                                         exc_k, _p16(tmp), _p8(rgb))
    return rgb, int(count)
