"""Copy of cairo_tpu.cpuref.api: the public Evx1Encoder/Evx1Decoder API
(numpy engine), byte-compatible with evx1.

Stream layout (evx1enc.cpp:92-156): 14-byte header once (pack(2) layout,
common.h:53-62), then per frame a raw 10-byte frame descriptor followed by
the arithmetic-coded slice. Frames are emitted as byte-aligned chunks: the
reference decoder empties its input after every frame (evx1dec.cpp:120).

These are host engines, as in cairo_tpu: they take no device argument, and
no device path calls them. They share nothing with gpu/ or the native slice
coder, so they hold ConformanceGpuEncoder's bytes and GpuDecoder's RGB to an
independent reference (chip_smoke.py phase 9).
"""

from __future__ import annotations

import struct

import numpy as np

from .. import metrics
from ..blocktypes import FRAME_INTER, FRAME_INTRA, is_copy
from ..entropy.bitio import BitReader, BitWriter
from ..entropy.slicecodec import decode_slice, encode_slice
from ..xmath import clip_range
from . import engine
from .stream import (_FRAME_FMT, FRAME_DESC_SIZE, HEADER_SIZE, pack_header,
                     parse_header)

_BT_FIELDS = ("block_type", "prediction_target", "motion_x", "motion_y",
              "sp_pred", "sp_amount", "sp_index", "q_index", "variance")

class Evx1Encoder:
    def __init__(self, config=None):
        from ..config import CONFORMANCE
        self.config = config if config is not None else CONFORMANCE
        self._ctx: engine.CodecContext | None = None
        self.frame_type = FRAME_INTRA
        self.frame_index = 0
        self.quality = self.config.default_quality
        self.width = 0
        self.height = 0
        self.last_stats = None

    def set_quality(self, quality: int):
        self.quality = int(clip_range(quality, 1, 31))

    def insert_intra(self):
        self.frame_type = FRAME_INTRA

    def encode(self, rgb: np.ndarray) -> bytes:
        """Encodes an (H, W, 3) uint8 frame; returns the frame's byte chunk."""
        height, width = rgb.shape[:2]
        out = BitWriter()
        if self._ctx is None:
            self._ctx = engine.CodecContext(width, height, self.config)
            self.width, self.height = width, height
            out.write_bytes(pack_header(
                width, height, self.config.reference_frame_count))
        if (width, height) != (self.width, self.height):
            raise ValueError("frame dimensions changed mid-stream")

        out.write_bytes(struct.pack(_FRAME_FMT, self.frame_type,
                                    self.frame_index, self.quality))

        ctx = self._ctx
        engine.load_input(ctx, rgb)
        engine.encode_slice(ctx, self.frame_type, self.frame_index, self.quality)
        encode_slice(ctx.block_table, ctx.output.y, ctx.output.u, ctx.output.v,
                     out)
        engine.deblock_recon(ctx, self.frame_index)

        chunk = out.getvalue()
        self.last_stats = metrics.frame_stats(
            self.frame_index, self.frame_type, self.quality, len(chunk),
            ctx.block_table.block_type, ctx.block_table.q_index)

        if self.config.enable_inter_frames:
            self.frame_type = FRAME_INTER
        rate = self.config.periodic_intra_rate
        if rate and (self.frame_index + 1) % rate == 0:
            self.insert_intra()
        self.frame_index += 1
        return chunk

    # -- checkpoint / resume (checkpoint.py) ----------------------------------

    def _ctx_arrays(self):
        ctx = self._ctx
        arrays = {}
        for s, rec in enumerate(ctx.recon):
            arrays.update({f"recon{s}_y": rec.y, f"recon{s}_u": rec.u,
                           f"recon{s}_v": rec.v})
        for name, planes in (("input", ctx.input), ("output", ctx.output)):
            arrays.update({f"{name}_y": planes.y, f"{name}_u": planes.u,
                           f"{name}_v": planes.v})
        arrays.update({f"bt_{k}": getattr(ctx.block_table, k)
                       for k in _BT_FIELDS})
        return arrays

    def _ctx_restore(self, arrays):
        ctx = self._ctx
        for s, rec in enumerate(ctx.recon):
            rec.y[:] = arrays[f"recon{s}_y"]
            rec.u[:] = arrays[f"recon{s}_u"]
            rec.v[:] = arrays[f"recon{s}_v"]
        for name, planes in (("input", ctx.input), ("output", ctx.output)):
            planes.y[:] = arrays[f"{name}_y"]
            planes.u[:] = arrays[f"{name}_u"]
            planes.v[:] = arrays[f"{name}_v"]
        for k in _BT_FIELDS:
            getattr(ctx.block_table, k)[:] = arrays[f"bt_{k}"]

    def state_dict(self):
        meta = dict(kind="cpuref_encoder", width=self.width,
                    height=self.height, frame_index=self.frame_index,
                    frame_type=self.frame_type, quality=self.quality,
                    init=self._ctx is not None)
        return meta, (self._ctx_arrays() if self._ctx is not None else {})

    def load_state_dict(self, meta, arrays):
        self.frame_index = meta["frame_index"]
        self.frame_type = meta["frame_type"]
        self.quality = meta["quality"]
        if meta["init"]:
            self.width, self.height = meta["width"], meta["height"]
            self._ctx = engine.CodecContext(self.width, self.height)
            self._ctx_restore(arrays)

    # -- debug/peek views (evx1enc.cpp:170-305) ---------------------------

    def peek_source(self) -> np.ndarray:
        ctx = self._ctx
        return engine.yuv420_to_rgb(ctx.input.y, ctx.input.u, ctx.input.v,
                                    self.width, self.height)

    def peek_destination(self) -> np.ndarray:
        # note: offset 1 relative to the *post-increment* frame index
        return engine.recon_to_rgb(self._ctx, self.frame_index - 1,
                                   self.width, self.height)

    def peek_block_table(self) -> np.ndarray:
        ctx = self._ctx
        bt = ctx.block_table
        img = np.zeros((self.height, self.width, 3), dtype=np.uint8)
        for idx in range(ctx.n_blocks):
            j, i = divmod(idx, ctx.width_in_blocks)
            t = int(bt.block_type[idx])
            img[j * 16:(j + 1) * 16, i * 16:(i + 1) * 16] = (
                255 * (t & 1), 255 * ((t >> 1) & 1), 255 * ((t >> 2) & 1))
        return img[:self.height, :self.width]

    def peek_quant_table(self) -> np.ndarray:
        ctx = self._ctx
        bt = ctx.block_table
        img = np.zeros((self.height, self.width, 3), dtype=np.uint8)
        for idx in range(ctx.n_blocks):
            j, i = divmod(idx, ctx.width_in_blocks)
            if is_copy(bt.block_type[idx]):
                color = (255, 0, 0)
            else:
                level = np.uint8(255 - 15 * int(bt.q_index[idx]))
                color = (level, level, level)
            img[j * 16:(j + 1) * 16, i * 16:(i + 1) * 16] = color
        return img[:self.height, :self.width]

    def peek_block_variance(self) -> np.ndarray:
        """Grayscale per-MB variance; copy blocks red (evx1enc.cpp:248-271)."""
        ctx = self._ctx
        bt = ctx.block_table
        img = np.zeros((self.height, self.width, 3), dtype=np.uint8)
        for idx in range(ctx.n_blocks):
            j, i = divmod(idx, ctx.width_in_blocks)
            if is_copy(bt.block_type[idx]):
                color = (255, 0, 0)
            else:
                level = np.uint8(min(max(int(bt.variance[idx]) // 30, 0), 255))
                color = (level, level, level)
            img[j * 16:(j + 1) * 16, i * 16:(i + 1) * 16] = color
        return img[:self.height, :self.width]

    def peek_spmp_table(self) -> np.ndarray:
        """Sub-pel map: blue=half, green=quarter (evx1enc.cpp:274-299)."""
        ctx = self._ctx
        bt = ctx.block_table
        img = np.zeros((self.height, self.width, 3), dtype=np.uint8)
        for idx in range(ctx.n_blocks):
            j, i = divmod(idx, ctx.width_in_blocks)
            if bt.sp_pred[idx]:
                color = (0, 255, 0) if bt.sp_amount[idx] else (0, 0, 255)
                img[j * 16:(j + 1) * 16, i * 16:(i + 1) * 16] = color
        return img[:self.height, :self.width]


class Evx1Decoder:
    def __init__(self, config=None):
        from ..config import CONFORMANCE
        self.config = config if config is not None else CONFORMANCE
        self._ctx: engine.CodecContext | None = None
        self.frame_index = 0
        self.width = 0
        self.height = 0

    def decode(self, chunk: bytes) -> np.ndarray:
        src = BitReader(chunk)
        if self._ctx is None:
            self.width, self.height = parse_header(
                src.read_bytes(HEADER_SIZE),
                self.config.reference_frame_count)
            self._ctx = engine.CodecContext(self.width, self.height,
                                            self.config)
        ftype, index, quality = struct.unpack(
            _FRAME_FMT, src.read_bytes(FRAME_DESC_SIZE))
        if index != self.frame_index:
            raise ValueError(f"out-of-order frame {index} != {self.frame_index}")

        ctx = self._ctx
        decode_slice(src, ctx.n_blocks, ctx.input.y, ctx.input.u, ctx.input.v,
                     ctx.block_table)
        engine.decode_slice(ctx, index)
        engine.deblock_recon(ctx, index)
        rgb = engine.recon_to_rgb(ctx, index, self.width, self.height)
        self.frame_index += 1
        return rgb

    # -- checkpoint / resume (checkpoint.py) ----------------------------------

    def state_dict(self):
        meta = dict(kind="cpuref_decoder", width=self.width,
                    height=self.height, frame_index=self.frame_index,
                    init=self._ctx is not None)
        arrays = Evx1Encoder._ctx_arrays(self) if self._ctx is not None else {}
        return meta, arrays

    def load_state_dict(self, meta, arrays):
        self.frame_index = meta["frame_index"]
        if meta["init"]:
            self.width, self.height = meta["width"], meta["height"]
            self._ctx = engine.CodecContext(self.width, self.height)
            Evx1Encoder._ctx_restore(self, arrays)
