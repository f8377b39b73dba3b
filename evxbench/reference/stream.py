"""Copy of the stream-header helpers of cairo_tpu.cpuref.api (header and frame descriptor layout)."""

from __future__ import annotations

import struct

from . import tables

_HEADER_FMT = "<4sHBxHHH"  # magic, size, ref_count, pad, version, w, h
_FRAME_FMT = "<IIH"        # type, index, quality
HEADER_SIZE = struct.calcsize(_HEADER_FMT)
FRAME_DESC_SIZE = struct.calcsize(_FRAME_FMT)


def pack_header(width: int, height: int,
                ref_count: int = tables.REFERENCE_FRAME_COUNT) -> bytes:
    return struct.pack(_HEADER_FMT, b"EVX1", HEADER_SIZE,
                       ref_count, tables.VERSION_WORD, width, height)


def parse_header(data: bytes,
                 ref_count: int = tables.REFERENCE_FRAME_COUNT
                 ) -> tuple[int, int]:
    magic, size, refs, version, width, height = struct.unpack(
        _HEADER_FMT, data[:HEADER_SIZE])
    if magic != b"EVX1" or size != HEADER_SIZE or \
            refs != ref_count or version != tables.VERSION_WORD:
        raise ValueError("invalid evx1 header")
    return width, height
