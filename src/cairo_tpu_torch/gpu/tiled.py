"""Tiled bitstream: container and host orchestration (counterpart of
cairo_tpu/tpu/tiled.py; docs/SHARDING.md).

    tiled_stream := tiled_header u16 tile_count (u16 tile_width_mbs)* frame*
    frame        := frame_desc (u32 tile_bytes tile_slice)*

All tile widths are equal, and both ends enforce it. The tiled header is
the 14-byte evx1 header with magic "EVXT", so plain-stream decoders
reject it. Each tile slice is a standard evx1 slice over one column of
macroblocks; motion vectors are tile-relative and may reach into the
neighbouring tile's halo (gpu/shard.py). Deblocking is tile-local, so
decoded pixels are defined per tiling.

TiledEncoder and TiledDecoder run the tile steps of gpu/shard.py over a
(gop, tile) mesh of torch devices and split and stitch the per-tile
slices on the host with the native entropy codec; the streams are
byte-identical to cairo_tpu's at the same tile and GOP counts. The gop
axis carries independent GOPs: encode_batch() encodes one frame for each
GOP a call. Across processes (gpu/cluster.py) each process runs and
entropy-codes its own tiles, and gathers the slice payloads only when a
GOP's tiles span processes.
"""

from __future__ import annotations

import struct

import numpy as np
import torch.distributed as dist

from .. import native, tables
from ..blocktypes import (BlockTable, COPY_BIT, FRAME_INTER, FRAME_INTRA,
                          INTRA_BIT, MOTION_BIT)
from ..cpuref import imaging as cpu_imaging
from ..cpuref.stream import FRAME_DESC_SIZE, HEADER_SIZE, _FRAME_FMT
from ..xmath import clip_range
from . import engine, ops, shard

MB = tables.MACROBLOCK_SIZE
_TILED_HEADER_FMT = "<4sHBxHHH"  # magic, size, ref_count, version, w, h
_BT_FIELDS = ("block_type", "prediction_target", "motion_x", "motion_y",
              "sp_pred", "sp_amount", "sp_index", "q_index", "variance")
_TABLE_FIELDS = _BT_FIELDS[:-1]
_COEF = ("coef_y", "coef_u", "coef_v")


def pack_tiled_header(width: int, height: int, tile_widths_mbs) -> bytes:
    if len(set(tile_widths_mbs)) != 1:
        raise ValueError("tiled streams require uniform tile widths "
                         "(docs/SHARDING.md)")
    head = struct.pack(_TILED_HEADER_FMT, b"EVXT", HEADER_SIZE,
                       tables.REFERENCE_FRAME_COUNT, tables.VERSION_WORD,
                       width, height)
    body = struct.pack("<H", len(tile_widths_mbs))
    body += b"".join(struct.pack("<H", t) for t in tile_widths_mbs)
    return head + body


def parse_tiled_header(data: bytes):
    magic, size, ref_count, version, width, height = struct.unpack(
        _TILED_HEADER_FMT, data[:HEADER_SIZE])
    if magic != b"EVXT" or size != HEADER_SIZE or \
            ref_count != tables.REFERENCE_FRAME_COUNT or \
            version != tables.VERSION_WORD:
        raise ValueError("invalid tiled evx1 header")
    (tile_count,) = struct.unpack_from("<H", data, HEADER_SIZE)
    tiles = [struct.unpack_from("<H", data, HEADER_SIZE + 2 + 2 * i)[0]
             for i in range(tile_count)]
    return width, height, tiles, HEADER_SIZE + 2 + 2 * tile_count


def _align_to(v: int, mult: int) -> int:
    return (v + mult - 1) // mult * mult


def _allgather_payloads(payloads: dict) -> dict:
    """The bitstream gather (tiled.py:96-129): every process contributes
    its tiles' slice payloads {(g, t): bytes}; every process returns the
    union, on torch.distributed.all_gather_object."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return payloads
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, payloads)
    full = {}
    for part in gathered:
        full.update(part)
    return full


def _init_states(queues, tile_w, aligned_h) -> dict:
    """Zeroed state for each tile, made on its queue."""
    states = {}
    for key, q in queues.items():
        with q.steps():
            states[key] = shard.init_tile_state(tile_w, aligned_h, q.device)
    return states


def _run_tiles(mesh, queues, states, frame_index, step):
    """Runs step(key, queue) -> (core planes, {name: tensor to download})
    for every local tile on its queue, then the halo exchange and the
    ring writes; returns {key: Download}."""
    cores, events, downloads = {}, {}, {}
    for key, q in queues.items():
        with q.steps():
            cores[key], fetch = step(key, q)
        events[key] = q.mark()
        downloads[key] = q.download(fetch, events[key])
    wide = shard.halo_exchange(mesh, queues, cores, events)
    for key, planes in wide.items():
        with queues[key].steps():
            engine.write_slot(states[key], planes, frame_index)
    return downloads


class TiledEncoder:
    """Spatially tiled encoder over a (gop, tile) mesh of torch devices
    (tiled.py:132-281). `devices`: as shard.make_mesh takes them, by
    default this process's CUDA devices; the tests pass ["cpu"] * k."""

    def __init__(self, n_tiles: int, n_gops: int = 1, devices=None):
        if n_tiles < 1 or n_gops < 1:
            raise ValueError("n_tiles and n_gops must be >= 1")
        self.n_tiles = n_tiles
        self.n_gops = n_gops
        self._devices = devices
        self._state = None
        self._stale = {}  # per-(gop, tile) stale q/variance carries
        self.frame_type = FRAME_INTRA
        self.frame_index = 0
        self.quality = tables.DEFAULT_QUALITY
        self.width = self.height = 0

    def set_quality(self, quality: int):
        self.quality = int(clip_range(quality, 1, 31))

    def insert_intra(self):
        self.frame_type = FRAME_INTRA

    def _init(self, width: int, height: int):
        self.width, self.height = width, height
        self._aw = _align_to(width, self.n_tiles * MB)
        self._ah = _align_to(height, MB)
        self.tile_w = self._aw // self.n_tiles
        self._mesh = shard.make_mesh(self.n_gops, self.n_tiles,
                                     self._devices)
        self._queues = shard.new_queues(self._mesh)
        self._state = _init_states(self._queues, self.tile_w, self._ah)

    def encode(self, rgb: np.ndarray) -> bytes:
        if self.n_gops != 1:
            raise ValueError("use encode_batch with n_gops > 1")
        return self.encode_batch([rgb])[0]

    def _tile_rgb(self, rgb, t):
        """Tile t's columns of a frame, zero-padded to the aligned size."""
        tile = np.zeros((self._ah, self.tile_w, 3), np.uint8)
        c0 = t * self.tile_w
        c1 = min(c0 + self.tile_w, self.width)
        if c1 > c0:
            tile[:self.height, :c1 - c0] = rgb[:, c0:c1]
        return tile

    def encode_batch(self, rgbs) -> list[bytes | None]:
        """Encodes one frame per GOP (len(rgbs) == n_gops); returns one
        tiled-stream byte chunk per GOP. Across processes every process
        passes the full frame list and entropy-codes its own tiles: a GOP
        whose tiles all live elsewhere gives None, unless the rows span
        processes, when the payloads are gathered and every process
        returns every chunk (tiled.py:183-268)."""
        if len(rgbs) != self.n_gops:
            raise ValueError("need one frame per GOP")
        height, width = rgbs[0].shape[:2]
        first = self._state is None
        if first:
            self._init(width, height)
        if (width, height) != (self.width, self.height):
            raise ValueError("frame dimensions changed mid-stream")

        is_inter = self.frame_type == FRAME_INTER

        def step(key, q):
            g, t = key
            rgb = q.upload(self._tile_rgb(rgbs[g], t))[0]
            out, core = shard.tile_encode_step(
                rgb, self._state[key], self.frame_index, self.quality,
                tile_w=self.tile_w, aligned_h=self._ah, full_width=self._aw,
                is_inter=is_inter, x0=t * self.tile_w, frame_w=self.width,
                frame_h=self.height)
            return core, {k: out[k] for k in _BT_FIELDS + _COEF}

        downloads = _run_tiles(self._mesh, self._queues, self._state,
                               self.frame_index, step)
        payloads = {}
        for key, download in downloads.items():
            fields = download.wait()
            # stale q_index/variance persistence per (gop, tile): the
            # reference's clear_block_desc quirk (common.cpp:67-73)
            copy = (fields["block_type"].astype(np.int32) & COPY_BIT) != 0
            if key in self._stale:
                sq, sv = self._stale[key]
                fields["q_index"] = np.where(copy, sq, fields["q_index"])
                fields["variance"] = np.where(copy, sv, fields["variance"])
            self._stale[key] = (fields["q_index"], fields["variance"])
            bt = BlockTable(**{k: fields[k] for k in _BT_FIELDS})
            payloads[key], _ = native.encode_slice(
                bt, *(fields[k] for k in _COEF))
        if self._mesh.rows_split():
            payloads = _allgather_payloads(payloads)

        frame_desc = struct.pack(_FRAME_FMT, self.frame_type,
                                 self.frame_index, self.quality)
        tile_mbs = [self.tile_w // MB] * self.n_tiles
        chunks: list[bytes | None] = [None] * self.n_gops
        for g in range(self.n_gops):
            if not all((g, t) in payloads for t in range(self.n_tiles)):
                continue
            parts = []
            if first:
                parts.append(pack_tiled_header(width, height, tile_mbs))
            parts.append(frame_desc)
            for t in range(self.n_tiles):
                payload = payloads[(g, t)]
                parts.append(struct.pack("<I", len(payload)))
                parts.append(payload)
            chunks[g] = b"".join(parts)

        self.frame_type = FRAME_INTER
        if tables.PERIODIC_INTRA_RATE and \
                (self.frame_index + 1) % tables.PERIODIC_INTRA_RATE == 0:
            self.insert_intra()
        self.frame_index += 1
        return chunks

    def recon_rgb(self, gop: int = 0) -> np.ndarray:
        """Stitched reconstruction of GOP `gop`'s last encoded frame (a
        conforming decoder reproduces it exactly); its tiles must live in
        this process."""
        keys = [(gop, t) for t in range(self.n_tiles)]
        if not all(self._mesh.is_local(k) for k in keys):
            raise ValueError(f"GOP {gop}'s tiles are not all in this process")
        slot = (self.frame_index - 1) % tables.REFERENCE_FRAME_COUNT
        planes = []
        for name, halo in zip(("ring_y", "ring_u", "ring_v"), shard.HALOS):
            cores = [self._queues[k].read(self._state[k][name][slot])
                     for k in keys]
            planes.append(np.concatenate(
                [c[:, halo:c.shape[1] - halo] for c in cores], axis=1))
        return cpu_imaging.yuv420_to_rgb(planes[0], planes[1], planes[2],
                                         self.width, self.height)


class TiledDecoder:
    """Decoder for tiled_stream chunks, one GOP per instance, its tiles on
    `devices` of this process (tiled.py:284-375)."""

    def __init__(self, devices=None):
        self._devices = devices
        self._state = None
        self.frame_index = 0
        self.width = self.height = 0

    def _init(self, width, height, tile_mbs):
        self.width, self.height = width, height
        self.tile_widths = [t * MB for t in tile_mbs]
        if len(set(self.tile_widths)) != 1:
            raise ValueError("tiled streams require uniform tile widths "
                             "(docs/SHARDING.md)")
        self.n_tiles = len(tile_mbs)
        self.tile_w = self.tile_widths[0]
        self._aw = self.tile_w * self.n_tiles
        self._ah = _align_to(height, MB)
        self._mesh = shard.make_mesh(1, self.n_tiles, self._devices)
        if len(self._mesh.local_keys()) != self.n_tiles:
            raise ValueError("TiledDecoder runs all its tiles in this "
                             "process")
        self._queues = shard.new_queues(self._mesh)
        self._state = _init_states(self._queues, self.tile_w, self._ah)
        n = (self.tile_w // MB) * (self._ah // MB)
        self._bt = [BlockTable.zeros(n) for _ in range(self.n_tiles)]
        self._coef = [
            (np.zeros((self._ah, self.tile_w), np.int16),
             np.zeros((self._ah // 2, self.tile_w // 2), np.int16),
             np.zeros((self._ah // 2, self.tile_w // 2), np.int16))
            for _ in range(self.n_tiles)]

    def decode(self, chunk: bytes) -> np.ndarray:
        offset = 0
        if self._state is None:
            width, height, tile_mbs, offset = parse_tiled_header(chunk)
            self._init(width, height, tile_mbs)
        ftype, index, quality = struct.unpack_from(_FRAME_FMT, chunk, offset)
        if ftype not in (FRAME_INTRA, FRAME_INTER):
            raise ValueError(f"invalid frame type {ftype}")
        if not 1 <= quality <= 31:
            raise ValueError(f"invalid frame quality {quality}")
        if index != self.frame_index:
            raise ValueError("out-of-order frame")
        offset += FRAME_DESC_SIZE

        # decode every tile slice into scratch state and validate BEFORE
        # committing: raising mid-frame must not desynchronize the
        # persistent per-tile tables/planes from the device rings
        scratch = []
        for t in range(self.n_tiles):
            if offset + 4 > len(chunk):
                raise ValueError("truncated tiled frame (missing length)")
            (nbytes,) = struct.unpack_from("<I", chunk, offset)
            offset += 4
            if nbytes == 0 or offset + nbytes > len(chunk):
                raise ValueError("tile slice length out of bounds")
            payload = chunk[offset:offset + nbytes]
            offset += nbytes
            bt = self._bt[t].copy()
            y, u, v = (p.copy() for p in self._coef[t])
            native.decode_slice(payload, 0, bt, y, u, v)
            if np.any((bt.block_type & INTRA_BIT).astype(bool)
                      & (bt.block_type & MOTION_BIT).astype(bool)):
                raise ValueError("tiled streams are fast-mode only "
                                 "(no intra-motion blocks)")
            scratch.append((bt, y, u, v))
        for t, (bt, y, u, v) in enumerate(scratch):
            self._bt[t] = bt
            self._coef[t] = (y, u, v)

        def step(key, q):
            t = key[1]
            up = q.upload(*(getattr(self._bt[t], k) for k in _TABLE_FIELDS),
                          *self._coef[t])
            core = shard.tile_decode_step(
                dict(zip(_TABLE_FIELDS, up)),
                dict(zip(_COEF, up[len(_TABLE_FIELDS):])), self._state[key],
                index)
            return core, {"rgb": ops.yuv420_to_rgb(*core)}

        downloads = _run_tiles(self._mesh, self._queues, self._state, index,
                               step)
        rgb = np.concatenate([downloads[(0, t)].wait()["rgb"]
                              for t in range(self.n_tiles)], axis=1)
        self.frame_index += 1
        return rgb[:self.height, :self.width]
