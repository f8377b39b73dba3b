"""Host-side encoders/decoder around the torch pipeline and the native
entropy coder (counterpart of cairo_tpu/tpu/api.py: TpuEncoder,
ConformanceTpuEncoder and TpuDecoder).

GpuEncoder produces format-conformant evx1 streams in fast mode, byte-
identical to TpuEncoder's. ConformanceGpuEncoder produces the reference
encoder's own bytes (wavefront schedule), identical to
ConformanceTpuEncoder's and cpuref.Evx1Encoder's. GpuDecoder
reconstructs every conformant stream on the device, routing each frame
as TpuDecoder does: fast-mode frames through engine.decode_step_coo, and
frames with intra-motion blocks or inter vectors of |mv| in (16, 32]
(reference-encoder streams, the conformance encoder's among them)
through the wavefront decode (wavefront.conformance_decode_step, K7).
Vectors no conforming encoder emits, and every frame when
use_wavefront_decode is False, take the native sequential C++ decoder,
which the stream then keeps; `host_frames` counts those frames. All run
on `device` ("cuda" by default, which raises without a card; the tests
pass "cpu").

encode_many and decode_many pipeline as the JAX package's do
(gpu/pipeline.py): each instance enqueues its device work on a CUDA
stream of its own and downloads its outputs on a copy stream into pinned
memory, while worker threads fetch and entropy-code (or convert) the
previous frame and the encoders convert the next frame's RGB one frame
ahead; a decode holds at most two frames in flight. The encoders' chunks
are TpuEncoder.encode_many's and ConformanceTpuEncoder.encode_many's,
also when set_quality or insert_intra is called between yields (which
then land on the frame after the one a loop over encode gives); the
decoder's RGB is a loop's. encode() and decode() run one frame through
the same calls.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .. import metrics, native, tables
from ..blocktypes import BlockTable, COPY_BIT, FRAME_INTER, FRAME_INTRA, \
    INTRA_BIT, MOTION_BIT
from ..cpuref import imaging as cpu_imaging
from ..cpuref.stream import (FRAME_DESC_SIZE, HEADER_SIZE, _FRAME_FMT,
                             pack_header, parse_header)
from ..spans import SpanLog
from ..xmath import clip_range
from . import engine, wavefront
from . import wire as wire_mod
from .pipeline import DeviceQueue, pipelined_decode, pipelined_encode

MB = tables.MACROBLOCK_SIZE
RING = tables.REFERENCE_FRAME_COUNT
STATE_KEYS = ("ring_y", "ring_u", "ring_v", "coef_y", "coef_u", "coef_v")
_BT_FIELDS = ("block_type", "prediction_target", "motion_x", "motion_y",
              "sp_pred", "sp_amount", "sp_index", "q_index", "variance")


def _align(v):
    return (v + MB - 1) // MB * MB


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    return dev


def state_from_numpy(arrays, device, keys=STATE_KEYS) -> dict:
    """The port's state from the arrays of a state_dict of TpuEncoder,
    TpuDecoder or ConformanceTpuEncoder (or the port's own): ring and
    coefficient planes, and for the conformance encoder (keys =
    wavefront.STATE_KEYS) the stale q_index / variance fields; the
    XLA-only win_* window caches are dropped."""
    dtypes = dict(stale_q=np.uint8)
    return {k: torch.as_tensor(
        np.ascontiguousarray(arrays[k], dtypes.get(k, np.int16)),
        device=device).clone() for k in keys}


def _state_to_numpy(queue, state, keys=STATE_KEYS) -> dict:
    return {k: queue.read(state[k]) for k in keys}


# the encoders' spans (which lane records which: gpu/pipeline.py)

def _upload_source(enc, rgb, src_wire):
    """The frame's source wire on the device, converted here where none
    came ahead; records dispatch.convert and dispatch.upload."""
    log, frame = enc.spans, enc.frame_index
    if src_wire is None:
        begun = log.stamp()
        src_wire = native.rgb_to_yuv5d(rgb, enc._aw, enc._ah, frame,
                                       enc.quality)
        log.span("dispatch.convert", frame, "encode.dispatch", begun)
    src_fmt, src_buf = src_wire
    begun = log.stamp()
    src = enc._q.upload(src_buf, frame=frame)[0]
    log.span("dispatch.upload", frame, "encode.dispatch", begun)
    return src_fmt, src


def _dispatched(log, pending, begun):
    """Records encode.dispatch, begun at the stamp `begun`."""
    end = log.span("encode.dispatch", pending["frame_index"], None, begun)
    pending["dispatch_ms"] = (end[0] - begun[0]) * 1e3
    return pending


def _stage_ms(pending, begun, fetched, coded) -> dict:
    """last_stats["stage_ms"] of an encoded frame: the wall ms of its
    encode.dispatch, finish.fetch and finish.entropy spans."""
    return dict(dispatch=pending["dispatch_ms"],
                fetch=(fetched[0] - begun[0]) * 1e3,
                entropy=(coded[0] - fetched[0]) * 1e3)


def _finished(log, pending, begun, coded):
    """Records finish.stats (from the stamp `coded`) and encode.finish
    (from `begun`); the finish's end is where encode.yield_lag starts."""
    frame = pending["frame_index"]
    log.span("finish.stats", frame, "encode.finish", coded)
    pending["finished"] = log.span("encode.finish", frame, None, begun)[0]


class GpuEncoder:
    def __init__(self, config=None, device="cuda"):
        from ..config import CONFORMANCE
        self.config = config if config is not None else CONFORMANCE
        if not self.config.tpu_supported:
            raise NotImplementedError(
                "this CodecConfig combination is not supported by the fast "
                "path (cairo_tpu.cpuref.api.Evx1Encoder runs it)")
        self.device = resolve_device(device)
        self.spans = SpanLog()
        self._q = DeviceQueue(self.device, self.spans)
        self._state = None
        self._last_out = None
        self._last_rgb = None
        self._stale_q = None
        self._stale_var = None
        self.frame_type = FRAME_INTRA
        self.frame_index = 0
        self.quality = self.config.default_quality
        self.width = self.height = 0
        self.last_stats = None

    def set_quality(self, quality: int):
        self.quality = int(clip_range(quality, 1, 31))

    def insert_intra(self):
        self.frame_type = FRAME_INTRA

    def _begin_frame(self, rgb):
        height, width = rgb.shape[:2]
        header = b""
        if self._state is None:
            self.width, self.height = width, height
            self._aw, self._ah = _align(width), _align(height)
            self._state = engine.init_state(self._aw, self._ah, self.device)
            # host mirror of the device-persistent coefficient planes
            # (carries stale copy-block DCs for the serializer's DC chains)
            self._coef_y = np.zeros((self._ah, self._aw), np.int16)
            self._coef_u = np.zeros((self._ah // 2, self._aw // 2), np.int16)
            self._coef_v = np.zeros((self._ah // 2, self._aw // 2), np.int16)
            header = pack_header(width, height,
                                 self.config.reference_frame_count)
        if (width, height) != (self.width, self.height):
            raise ValueError("frame dimensions changed mid-stream")
        return header

    def _dispatch(self, rgb, src_wire=None):
        """Enqueues one frame's device work and the download of its output
        wire; returns what the entropy stage needs. `src_wire`: the
        frame's (format, source wire) from native.rgb_to_yuv5d, made with
        the frame index and quality this frame carries (encode_many
        converts one frame ahead). Records encode.dispatch and its
        children."""
        log, frame = self.spans, self.frame_index
        begun = log.stamp(cpu=True)
        with self._q.steps():
            header = self._begin_frame(rgb)
            frame_desc = struct.pack(_FRAME_FMT, self.frame_type,
                                     self.frame_index, self.quality)
            src_fmt, src = _upload_source(self, rgb, src_wire)
            stamp = log.stamp()
            self._state, out = engine.encode_step(
                src, self._state, aligned_w=self._aw,
                aligned_h=self._ah, frame_w=self.width, frame_h=self.height,
                is_inter=self.frame_type == FRAME_INTER,
                n_refs=self.config.reference_frame_count,
                deblock=self.config.enable_deblocking,
                adaptive=self.config.adaptive_quantization, src_fmt=src_fmt)
            stamp = log.span("dispatch.step", frame, "encode.dispatch", stamp)
        done = self._q.mark()
        pending = dict(header=header, frame_desc=frame_desc, out=out,
                       done=done,
                       wire=self._q.download({"wire": out["wire"]}, done,
                                             frame),
                       frame_index=self.frame_index,
                       frame_type=self.frame_type, quality=self.quality)
        log.span("dispatch.download", frame, "encode.dispatch", stamp)
        self._last_rgb = rgb
        if self.config.enable_inter_frames:
            self.frame_type = FRAME_INTER
        rate = self.config.periodic_intra_rate
        if rate and (self.frame_index + 1) % rate == 0:
            self.insert_intra()
        self.frame_index += 1
        return _dispatched(log, pending, begun)

    def _finish(self, pending) -> bytes:
        """Fetches one frame's output and entropy-codes it (on a worker
        under encode_many). Device tensors beyond the wire are read after
        the frame's event: the tail, the exact planes (their tensors are
        the frame's own, since each step rebinds the state's coefficient
        planes) and the self-check's fields. Records encode.finish and its
        children (finish.fetch also unpacks the wire)."""
        dev_out = pending["out"]
        log, frame = self.spans, pending["frame_index"]

        def fetch(key):
            return self._q.fetch(dev_out[key], pending["done"], frame)

        begun = log.stamp(cpu=True)
        buf = pending["wire"].wait()["wire"]
        n = (self._aw // MB) * (self._ah // MB)
        out, count, pos, val = wire_mod.unpack_encode_wire(
            buf, n, tail=lambda: fetch("wire_tail"))
        copy = (out["block_type"].astype(np.int32) & COPY_BIT) != 0
        if count <= wire_mod.COO_K:
            wire_mod.apply_coo_np(self._coef_y, self._coef_u, self._coef_v,
                                  copy, count, pos, val)
        else:  # COO overflow: take the exact planes
            np.copyto(self._coef_y, fetch("coef_y"))
            np.copyto(self._coef_u, fetch("coef_u"))
            np.copyto(self._coef_v, fetch("coef_v"))
        cy, cu, cv = self._coef_y, self._coef_u, self._coef_v
        if pending["frame_index"] == 0:
            # one-time wire self-check (guards the device byte order)
            assert np.array_equal(out["block_type"], fetch("block_type"))
            assert np.array_equal(out["variance"], fetch("variance"))
            assert np.array_equal(cy, fetch("coef_y"))
        fetched = log.span("finish.fetch", frame, "encode.finish", begun)

        bt = BlockTable(**{k: out[k] for k in _BT_FIELDS})
        slice_bytes, _ = native.encode_slice(bt, cy, cu, cv)
        coded = log.span("finish.entropy", frame, "encode.finish", fetched)
        # copy blocks keep the table's previous q_index/variance (the
        # reference's clear_block_desc quirk, common.cpp:67-73); peek-only:
        # the slice codes no copy block's q_index
        out = dict(out)
        if self._stale_q is not None:
            out["q_index"] = np.where(copy, self._stale_q, out["q_index"])
            out["variance"] = np.where(copy, self._stale_var, out["variance"])
        self._stale_q = out["q_index"]
        self._stale_var = out["variance"]
        self._last_out = out
        chunk = pending["header"] + pending["frame_desc"] + slice_bytes
        self.last_stats = metrics.frame_stats(
            pending["frame_index"], pending["frame_type"],
            pending["quality"], len(chunk), out["block_type"],
            out["q_index"], stage_ms=_stage_ms(pending, begun, fetched, coded))
        _finished(log, pending, begun, coded)
        return chunk

    def encode(self, rgb: np.ndarray) -> bytes:
        """Encodes an (H, W, 3) uint8 frame; returns its byte chunk."""
        return self._finish(self._dispatch(rgb))

    def encode_many(self, frames):
        """Pipelined encode (gpu/pipeline.py): yields one byte chunk per
        input frame."""
        return pipelined_encode(self, frames)

    # -- debug/peek views (evx1enc.cpp:170-305 parity) ---------------------

    def peek_source(self) -> np.ndarray:
        """Input frame round-tripped through YUV 4:2:0."""
        y, u, v = cpu_imaging.rgb_to_yuv420(self._last_rgb)
        return cpu_imaging.yuv420_to_rgb(y, u, v, self.width, self.height)

    def peek_destination(self) -> np.ndarray:
        """The last frame's reconstruction, as the decoder will see it."""
        slot = (self.frame_index - 1) % RING
        y, u, v = (self._q.read(self._state[k][slot])
                   for k in ("ring_y", "ring_u", "ring_v"))
        return cpu_imaging.yuv420_to_rgb(y, u, v, self.width, self.height)

    def _block_map(self, colors: np.ndarray) -> np.ndarray:
        img = colors.reshape(self._ah // MB, self._aw // MB, 3)
        img = img.astype(np.uint8).repeat(MB, axis=0).repeat(MB, axis=1)
        return img[:self.height, :self.width]

    def peek_block_table(self) -> np.ndarray:
        bt = self._last_out["block_type"].astype(np.int32)
        colors = np.stack([255 * (bt & 1), 255 * ((bt >> 1) & 1),
                           255 * ((bt >> 2) & 1)], axis=-1)
        return self._block_map(colors)

    def peek_quant_table(self) -> np.ndarray:
        bt = self._last_out["block_type"].astype(np.int32)
        qp = self._last_out["q_index"].astype(np.int32)
        level = (255 - 15 * qp).astype(np.uint8)
        colors = np.stack([level, level, level], axis=-1)
        colors[(bt & COPY_BIT) != 0] = (255, 0, 0)
        return self._block_map(colors)

    def peek_block_variance(self) -> np.ndarray:
        """Grayscale per-MB variance map; copy blocks red (evx1enc.cpp:248)."""
        bt = self._last_out["block_type"].astype(np.int32)
        var = self._last_out["variance"].astype(np.int32)
        level = np.clip(var // 30, 0, 255).astype(np.uint8)
        colors = np.stack([level, level, level], axis=-1)
        colors[(bt & COPY_BIT) != 0] = (255, 0, 0)
        return self._block_map(colors)

    def peek_spmp_table(self) -> np.ndarray:
        """Sub-pel motion map: blue=half, green=quarter (evx1enc.cpp:274)."""
        sp_pred = self._last_out["sp_pred"].astype(bool)
        sp_amount = self._last_out["sp_amount"].astype(bool)
        colors = np.zeros(sp_pred.shape + (3,), np.int32)
        colors[sp_pred & sp_amount] = (0, 255, 0)
        colors[sp_pred & ~sp_amount] = (0, 0, 255)
        return self._block_map(colors)

    # -- checkpoint / resume (checkpoint.py format, TpuEncoder-compatible) --

    def state_dict(self):
        meta = dict(kind="gpu_encoder", width=self.width, height=self.height,
                    frame_index=self.frame_index, frame_type=self.frame_type,
                    quality=self.quality, init=self._state is not None)
        arrays = _state_to_numpy(self._q, self._state) \
            if self._state is not None else {}
        return meta, arrays

    def load_state_dict(self, meta, arrays):
        """Resumes from a GpuEncoder or a TpuEncoder checkpoint."""
        self.frame_index = meta["frame_index"]
        self.frame_type = meta["frame_type"]
        self.quality = meta["quality"]
        if meta["init"]:
            self.width, self.height = meta["width"], meta["height"]
            self._aw, self._ah = _align(self.width), _align(self.height)
            with self._q.steps():
                self._state = state_from_numpy(arrays, self.device)
            self._coef_y = np.array(arrays["coef_y"], np.int16)
            self._coef_u = np.array(arrays["coef_u"], np.int16)
            self._coef_v = np.array(arrays["coef_v"], np.int16)


class ConformanceGpuEncoder:
    """Encoding bit-exact against the reference encoder, on the device
    (wavefront schedule, gpu/wavefront.py; counterpart of
    ConformanceTpuEncoder). Produces the same bytes as cpuref.Evx1Encoder
    and ConformanceTpuEncoder. Runs on `device` ("cuda" by default, which
    raises without a card; pass "cpu" for the plain PyTorch path)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.spans = SpanLog()
        self._q = DeviceQueue(self.device, self.spans)
        self._state = None
        self.frame_type = FRAME_INTRA
        self.frame_index = 0
        self.quality = tables.DEFAULT_QUALITY
        self.width = self.height = 0
        self.last_stats = None

    def set_quality(self, quality: int):
        self.quality = int(clip_range(quality, 1, 31))

    def insert_intra(self):
        self.frame_type = FRAME_INTRA

    def _dispatch(self, rgb, src_wire=None):
        """Enqueues one frame's wave pass and the download of all its
        outputs (`src_wire` as in GpuEncoder._dispatch). The outputs
        alias the state's stale fields and coefficient planes, which the
        next step rebinds and never writes in place, so they stay the
        frame's own. Records encode.dispatch and its children."""
        log, frame = self.spans, self.frame_index
        begun = log.stamp(cpu=True)
        height, width = rgb.shape[:2]
        header = b""
        with self._q.steps():
            if self._state is None:
                self.width, self.height = width, height
                self._aw, self._ah = _align(width), _align(height)
                self._state = wavefront.init_state(self._aw, self._ah,
                                                   self.device)
                header = pack_header(width, height)
            if (width, height) != (self.width, self.height):
                raise ValueError("frame dimensions changed mid-stream")
            frame_desc = struct.pack(_FRAME_FMT, self.frame_type,
                                     self.frame_index, self.quality)
            src_fmt, src = _upload_source(self, rgb, src_wire)
            stamp = log.stamp()
            self._state, out = wavefront.conformance_encode_step(
                src, self._state, aligned_w=self._aw,
                aligned_h=self._ah, frame_w=self.width, frame_h=self.height,
                is_inter=self.frame_type == FRAME_INTER, src_fmt=src_fmt)
            stamp = log.span("dispatch.step", frame, "encode.dispatch", stamp)
        pending = dict(header=header, frame_desc=frame_desc,
                       out=self._q.download(out, self._q.mark(), frame),
                       frame_index=self.frame_index,
                       frame_type=self.frame_type, quality=self.quality)
        log.span("dispatch.download", frame, "encode.dispatch", stamp)
        self.frame_type = FRAME_INTER
        if tables.PERIODIC_INTRA_RATE and \
                (self.frame_index + 1) % tables.PERIODIC_INTRA_RATE == 0:
            self.insert_intra()
        self.frame_index += 1
        return _dispatched(log, pending, begun)

    def _finish(self, pending) -> bytes:
        """Fetches one frame's outputs and entropy-codes them (on a worker
        under encode_many); records encode.finish and its children."""
        log, frame = self.spans, pending["frame_index"]
        begun = log.stamp(cpu=True)
        out = pending["out"].wait()
        fetched = log.span("finish.fetch", frame, "encode.finish", begun)
        bt = BlockTable(**{k: out[k] for k in _BT_FIELDS})
        slice_bytes, _ = native.encode_slice(bt, out["coef_y"],
                                             out["coef_u"], out["coef_v"])
        coded = log.span("finish.entropy", frame, "encode.finish", fetched)
        chunk = pending["header"] + pending["frame_desc"] + slice_bytes
        self.last_stats = metrics.frame_stats(
            pending["frame_index"], pending["frame_type"],
            pending["quality"], len(chunk), out["block_type"],
            out["q_index"], stage_ms=_stage_ms(pending, begun, fetched, coded))
        _finished(log, pending, begun, coded)
        return chunk

    def encode(self, rgb: np.ndarray) -> bytes:
        """Encodes an (H, W, 3) uint8 frame; returns its byte chunk."""
        return self._finish(self._dispatch(rgb))

    def encode_many(self, frames):
        """Pipelined encode (gpu/pipeline.py): yields one byte chunk per
        input frame."""
        return pipelined_encode(self, frames)

    # -- checkpoint / resume (checkpoint.py format) -------------------------

    def state_dict(self):
        meta = dict(kind="conformance_gpu_encoder", width=self.width,
                    height=self.height, frame_index=self.frame_index,
                    frame_type=self.frame_type, quality=self.quality,
                    init=self._state is not None)
        arrays = _state_to_numpy(self._q, self._state,
                                 wavefront.STATE_KEYS) \
            if self._state is not None else {}
        return meta, arrays

    def load_state_dict(self, meta, arrays):
        """Resumes from a ConformanceGpuEncoder or a ConformanceTpuEncoder
        checkpoint."""
        self.frame_index = meta["frame_index"]
        self.frame_type = meta["frame_type"]
        self.quality = meta["quality"]
        if meta["init"]:
            self.width, self.height = meta["width"], meta["height"]
            self._aw, self._ah = _align(self.width), _align(self.height)
            with self._q.steps():
                self._state = state_from_numpy(arrays, self.device,
                                               wavefront.STATE_KEYS)


class GpuDecoder:
    def __init__(self, config=None, device="cuda"):
        from ..config import CONFORMANCE
        self.config = config if config is not None else CONFORMANCE
        if not self.config.tpu_supported:
            raise NotImplementedError(
                "this CodecConfig combination is not supported by the fast "
                "path (cairo_tpu.cpuref.api.Evx1Decoder runs it)")
        self.device = resolve_device(device)
        self.spans = SpanLog()
        self._q = DeviceQueue(self.device, self.spans)
        self._state = None
        self._native = None  # sequential C++ decoder once a stream needs it
        # wave-path frames (intra-motion blocks, |mv| up to 32) decode on
        # the device; False sends them to the native sequential decoder
        self.use_wavefront_decode = True
        self.frame_index = 0
        self.host_frames = 0  # frames that took the native host decoder
        self.width = self.height = 0
        self.last_stats = None

    def _init(self, width, height):
        self.width, self.height = width, height
        self._aw, self._ah = _align(width), _align(height)
        with self._q.steps():
            self._state = engine.init_state(self._aw, self._ah, self.device)
        n = (self._aw // MB) * (self._ah // MB)
        self._bt = BlockTable.zeros(n)
        self._coef_y = np.zeros((self._ah, self._aw), np.int16)
        self._coef_u = np.zeros((self._ah // 2, self._aw // 2), np.int16)
        self._coef_v = np.zeros((self._ah // 2, self._aw // 2), np.int16)
        total = self._ah * self._aw + 2 * (self._ah // 2) * (self._aw // 2)
        self._yuv_tmp = np.empty(total, np.int16)
        # the delta wire only wins once its packed savings beat its fixed
        # exception section; small frames keep the 8-bit wire
        self._out_fmt = ("yuv5d"
                         if wire_mod.yuv5d_wire_nbytes(self._ah, self._aw)
                         < wire_mod.yuv_wire_nbytes(self._ah, self._aw)
                         else "yuv8")

    def _dispatch_decode(self, chunk: bytes) -> dict:
        """Parses one chunk and enqueues its device work and the download
        of its output. Frames that need the sequential decoder are
        reconstructed on the host here. The host planes that the parser
        rewrites reach the device only as copies (DeviceQueue.upload).
        Records decode.dispatch and its child dispatch.entropy."""
        log = self.spans
        begun = log.stamp(cpu=True)
        offset = 0
        if self._state is None:
            width, height = parse_header(
                chunk[:HEADER_SIZE], self.config.reference_frame_count)
            self._init(width, height)
            offset = HEADER_SIZE
        ftype, index, quality = struct.unpack(
            _FRAME_FMT, chunk[offset:offset + FRAME_DESC_SIZE])
        if index != self.frame_index:
            raise ValueError("out-of-order frame")
        offset += FRAME_DESC_SIZE
        stamp = log.stamp()
        native.decode_slice(chunk, offset * 8, self._bt, self._coef_y,
                            self._coef_u, self._coef_v)
        decoded = log.span("dispatch.entropy", index, "decode.dispatch", stamp)

        bt = self._bt
        im_mask = (((bt.block_type & INTRA_BIT) != 0)
                   & ((bt.block_type & MOTION_BIT) != 0))
        inter_motion = ((bt.block_type & MOTION_BIT) != 0) & ~im_mask
        inter_mx = np.abs(bt.motion_x[inter_motion])
        inter_my = np.abs(bt.motion_y[inter_motion])
        # fast-mode streams keep |mv| <= 16; the reference's inter search
        # reaches +-31 (+1 sub-pel), which the wave step's wide gather takes
        fast_mv = bool(np.all((inter_mx <= 16) & (inter_my <= 16)))
        wide_mv = bool(np.all((inter_mx <= 32) & (inter_my <= 32)))
        # intra-motion vectors a conforming encoder can emit (the wave
        # window's reach, cuda_wavedec); anything wilder goes to the
        # validating native decoder
        im_mx, im_my = bt.motion_x[im_mask], bt.motion_y[im_mask]
        im_reach_ok = bool(np.all((im_mx >= -32) & (im_mx <= 32)
                                  & (im_my >= -48) & (im_my <= 16)))
        needs_wave = bool(np.any(im_mask)) or not fast_mv
        self.frame_index += 1
        if self._native is not None or not wide_mv or not im_reach_ok or \
                (needs_wave and not self.use_wavefront_decode):
            self.host_frames += 1
            pending = dict(kind="host", rgb=self._decode_sequential(index),
                           host_frames=self.host_frames)
        else:
            with self._q.steps():
                pending = self._dispatch_device(index, bt, im_mask,
                                                needs_wave)
        pending.update(frame=index, t0=stamp[0], t_ent=decoded[0])
        pending["t_dispatch"] = log.span("decode.dispatch", index, None,
                                         begun)[0]
        return pending

    def _dispatch_device(self, index, bt, im_mask, needs_wave):
        """The device part of _dispatch_decode, on the compute stream."""
        pos, val, count = native.extract_coo(
            bt.block_type, self._aw // MB, self._coef_y, self._coef_u,
            self._coef_v, wire_mod.COO_K)
        # upload bucket: typical inter frames fit the small one
        small = min(wire_mod.COO_SMALL, wire_mod.COO_K)
        coo_k = small if count <= small else wire_mod.COO_K
        coo = [pos[:coo_k].view(np.uint8), val[:coo_k].view(np.uint8)]
        kw = dict(aligned_w=self._aw, aligned_h=self._ah,
                  frame_w=self.width, frame_h=self.height,
                  deblock=self.config.enable_deblocking,
                  out_fmt=self._out_fmt)
        if needs_wave:
            # wavefront device decode (reference-origin streams)
            bi, bj, n_active = wavefront.build_compact_schedule(
                bt.block_type, self._aw // MB, self._ah // MB)
            head = np.array([index, n_active], np.int32).view(np.uint8)
            tail = [wire_mod.pack_table_np(bt), bi.view(np.uint8).reshape(-1),
                    bj.view(np.uint8).reshape(-1)]
            kw.update(n_active=n_active, n_members=int(im_mask.sum()))
            if count <= wire_mod.COO_K:
                self._state, yuv = wavefront.conformance_decode_step(
                    self._q.upload(np.concatenate([head, *coo, *tail]))[0],
                    self._state, coo_k=coo_k, **kw)
            else:
                # COO overflow: the dense coefficient planes
                self._state, yuv = wavefront.conformance_decode_step_dense(
                    *self._q.upload(np.concatenate([head, *tail]),
                                    self._coef_y, self._coef_u,
                                    self._coef_v), self._state, **kw)
            return self._wire_pending(yuv, index, n_active,
                                      kw["n_members"])
        if count <= wire_mod.COO_K:
            head = np.array([index, 0], np.int32).view(np.uint8)
            self._state, yuv = engine.decode_step_coo(
                self._q.upload(np.concatenate(
                    [head, *coo, wire_mod.pack_table_np(bt)]))[0],
                self._state, coo_k=coo_k, **kw)
            return self._wire_pending(yuv, index, 0, 0)
        # dense fallback (residual volume beyond the COO capacity)
        fields = [k for k in _BT_FIELDS if k != "variance"]
        planes = ("coef_y", "coef_u", "coef_v")
        up = self._q.upload(*(getattr(bt, k) for k in fields),
                            *(getattr(self, "_" + k) for k in planes))
        self._state, rgb = engine.decode_step(
            dict(zip(fields, up)), dict(zip(planes, up[len(fields):])),
            self._state, index, width=self.width, height=self.height,
            aligned_w=self._aw, aligned_h=self._ah,
            deblock=self.config.enable_deblocking)
        return dict(kind="dense", host_frames=self.host_frames,
                    download=self._q.download({"rgb": rgb}, self._q.mark()))

    def _wire_pending(self, yuv, index, waves, members):
        """The pending record of a frame decoded to a YUV wire: the
        wire's download, and views of the ring slot the frame wrote
        (TpuDecoder._ring_slot_refs), the exact planes should the wire
        overflow, read after the frame's event. The slot is held, not
        cloned: decode_many keeps at most two frames in flight and a slot
        is rewritten only RING frames later."""
        slot = index % RING
        ring = tuple(self._state[k][slot] for k in ("ring_y", "ring_u",
                                                    "ring_v"))
        done = self._q.mark()
        return dict(kind="wire", download=self._q.download({"yuv": yuv}, done),
                    done=done, ring=ring, waves=waves, members=members,
                    host_frames=self.host_frames)

    def _fetch_decode(self, pending) -> dict:
        """The fetch lane: waits for the frame's download (its YUV wire,
        or the dense fallback's RGB); records decode.fetch."""
        if "download" in pending:
            begun = self.spans.stamp(cpu=True)
            pending["fetched"] = pending.pop("download").wait()
            pending["t_fetch"] = self.spans.span(
                "decode.fetch", pending["frame"], None, begun)[0]
        return pending

    def _finish_decode(self, pending) -> np.ndarray:
        """The convert lane: the frame's RGB."""
        self._fetch_decode(pending)
        kind = pending["kind"]
        stats = dict(path="host" if kind == "host" else "device",
                     host_frames=pending["host_frames"])
        if kind == "host":
            rgb = pending["rgb"]
        elif kind == "dense":
            rgb = pending["fetched"]["rgb"]
        else:
            rgb, stats["stage_ms"] = self._wire_to_rgb(pending)
            stats.update(waves=pending["waves"], members=pending["members"])
        self.last_stats = stats
        return rgb

    def _wire_to_rgb(self, pending):
        """Converts the fetched YUV wire on the host; returns (rgb, stage
        ms). An overflowed exception list means the wire was lossy: the
        exact reconstruction is fetched from the ring-slot views taken at
        dispatch (never from the live state). Records decode.convert; the
        stages are the wall ms between the frame's span stamps."""
        begun = self.spans.stamp(cpu=True)
        buf, t_fetch = pending["fetched"]["yuv"], pending["t_fetch"]
        if self._out_fmt == "yuv5d":
            rgb, exc_count = native.yuv5d_wire_to_rgb(
                buf, self._aw, self._ah, self.width, self.height,
                wire_mod.DEXC_K, self._yuv_tmp)
            exc_cap = wire_mod.DEXC_K
        else:
            rgb, exc_count = native.yuv_wire_to_rgb(
                buf, self._aw, self._ah, self.width, self.height,
                wire_mod.EXC_K)
            exc_cap = wire_mod.EXC_K
        if exc_count > exc_cap:
            y, u, v = (self._q.fetch(p, pending["done"])
                       for p in pending["ring"])
            rgb = cpu_imaging.yuv420_to_rgb(y, u, v, self.width, self.height)
        converted = self.spans.span("decode.convert", pending["frame"], None,
                                    begun)
        stage_ms = dict(
            entropy=(pending["t_ent"] - pending["t0"]) * 1e3,
            dispatch=(pending["t_dispatch"] - pending["t_ent"]) * 1e3,
            device_and_fetch=(t_fetch - pending["t_dispatch"]) * 1e3,
            convert=(converted[0] - t_fetch) * 1e3)
        return rgb, stage_ms

    def decode(self, chunk: bytes) -> np.ndarray:
        """Decodes one chunk; returns the (H, W, 3) uint8 frame."""
        return self._finish_decode(self._dispatch_decode(chunk))

    def decode_many(self, chunks):
        """Pipelined decode (gpu/pipeline.py): yields one RGB frame per
        chunk."""
        return pipelined_decode(self, chunks)

    # -- checkpoint / resume (checkpoint.py format, TpuDecoder-compatible) --

    def state_dict(self):
        meta = dict(kind="gpu_decoder", width=self.width, height=self.height,
                    frame_index=self.frame_index,
                    init=self._state is not None)
        arrays = {}
        if self._state is not None:
            arrays = _state_to_numpy(self._q, self._state)
            if self._native is not None:
                # host-side state is authoritative in sequential mode
                rings = [self._native.get_ring(s) for s in range(RING)]
                for i, k in enumerate(("ring_y", "ring_u", "ring_v")):
                    arrays[k] = np.stack([r[i] for r in rings])
                arrays["coef_y"] = self._coef_y.copy()
                arrays["coef_u"] = self._coef_u.copy()
                arrays["coef_v"] = self._coef_v.copy()
            arrays.update(
                host_coef_y=self._coef_y, host_coef_u=self._coef_u,
                host_coef_v=self._coef_v,
                **{f"bt_{k}": getattr(self._bt, k) for k in _BT_FIELDS})
        return meta, arrays

    def load_state_dict(self, meta, arrays):
        """Resumes from a GpuDecoder or a TpuDecoder checkpoint."""
        self.frame_index = meta["frame_index"]
        self._native = None  # resume on the device path until needed again
        if meta["init"]:
            self._init(meta["width"], meta["height"])
            with self._q.steps():
                self._state = state_from_numpy(arrays, self.device)
            self._coef_y[:] = arrays["host_coef_y"]
            self._coef_u[:] = arrays["host_coef_u"]
            self._coef_v[:] = arrays["host_coef_v"]
            for k in _BT_FIELDS:
                getattr(self._bt, k)[:] = arrays[f"bt_{k}"]

    def _decode_sequential(self, index: int) -> np.ndarray:
        """Native C++ decoder for frames the parallel path cannot batch
        (intra-motion blocks read the current frame's partially decoded
        pixels in raster order). On first use the ring moves to the host
        and the decoder stays sequential from then on."""
        if self._native is None:
            if not self.config.is_conformance:
                raise NotImplementedError(
                    "sequential decode (intra-motion streams) supports the "
                    "conformance config only")
            self._native = native.NativeDecoder(self._aw, self._ah)
            rings = [self._q.read(self._state[k])
                     for k in ("ring_y", "ring_u", "ring_v")]
            for s in range(RING):
                self._native.set_ring(s, rings[0][s], rings[1][s],
                                      rings[2][s])
        return self._native.decode_frame(
            self._bt, self._coef_y, self._coef_u, self._coef_v, index,
            self.width, self.height)
