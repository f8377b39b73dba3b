"""Copy of cairo_tpu.entropy.bitio: LSB-first bit I/O.

The evx1 wire format packs bits LSB-first within each byte
(bitstream.cpp:181-200): bit k of the stream lives at byte k>>3, bit k&7.
"""

from __future__ import annotations


class BitWriter:
    __slots__ = ("_bytes", "bit_count", "_cur", "_curbits")

    def __init__(self):
        self._bytes = bytearray()
        self.bit_count = 0
        self._cur = 0
        self._curbits = 0

    def write_bit(self, bit: int):
        self._cur |= (bit & 1) << self._curbits
        self._curbits += 1
        self.bit_count += 1
        if self._curbits == 8:
            self._bytes.append(self._cur)
            self._cur = 0
            self._curbits = 0

    def write_bits(self, value: int, count: int):
        """Writes `count` bits of `value`, LSB first."""
        for _ in range(count):
            self.write_bit(value & 1)
            value >>= 1

    def write_bytes(self, data: bytes):
        if self._curbits == 0:
            self._bytes.extend(data)
            self.bit_count += 8 * len(data)
        else:
            for b in data:
                self.write_bits(b, 8)

    def getvalue(self) -> bytes:
        """Byte image; unused high bits of a partial tail byte are zero."""
        out = bytes(self._bytes)
        if self._curbits:
            out += bytes([self._cur])
        return out


class BitReader:
    __slots__ = ("_data", "bit_pos", "bit_limit")

    def __init__(self, data: bytes, bit_limit: int | None = None):
        self._data = data
        self.bit_pos = 0
        self.bit_limit = bit_limit if bit_limit is not None else 8 * len(data)

    def is_empty(self) -> bool:
        return self.bit_pos >= self.bit_limit

    def read_bit(self) -> int:
        """Reads one bit; raises past the limit (callers gate on is_empty)."""
        if self.bit_pos >= self.bit_limit:
            raise EOFError("bit stream exhausted")
        byte = self._data[self.bit_pos >> 3]
        bit = (byte >> (self.bit_pos & 7)) & 1
        self.bit_pos += 1
        return bit

    def read_bits(self, count: int) -> int:
        """Reads `count` bits LSB-first into an int."""
        value = 0
        for k in range(count):
            value |= self.read_bit() << k
        return value

    def read_bytes(self, count: int) -> bytes:
        if (self.bit_pos & 7) == 0:
            start = self.bit_pos >> 3
            self.bit_pos += 8 * count
            if self.bit_pos > self.bit_limit:
                raise EOFError("bit stream exhausted")
            return bytes(self._data[start:start + count])
        return bytes(self.read_bits(8) for _ in range(count))


class BitStream:
    """Full bit_stream parity (bitstream.h:43-92, bitstream.cpp): a
    bit-granular FIFO with separate read/write indices, byte-aligned fast
    paths, peek/read/seek semantics and capacity-checked writes.

    The codec itself only needs BitWriter/BitReader above; this class
    exists for library-surface parity (including the documented quirk
    that seek() can run the read index past the write index,
    bitstream.cpp:87-95). Methods mirror the reference's status-code
    style: writes/reads return True on success, False on a capacity or
    occupancy violation (EVX_ERROR_CAPACITY_LIMIT / INVALID_RESOURCE)."""

    def __init__(self, size_in_bits: int = 0, data: bytes | None = None):
        self._store = bytearray()
        self._capacity_bytes = 0
        self.read_index = 0
        self.write_index = 0
        if data is not None:
            self.assign(data)
        elif size_in_bits:
            self.resize_capacity(size_in_bits)

    # -- queries -----------------------------------------------------------
    def query_data(self) -> bytes:
        return bytes(self._store)

    def query_capacity(self) -> int:
        return self._capacity_bytes << 3

    def query_occupancy(self) -> int:
        return self.write_index - self.read_index

    def query_byte_occupancy(self) -> int:
        return (self.query_occupancy() + 7) >> 3

    # -- lifecycle ---------------------------------------------------------
    def resize_capacity(self, size_in_bits: int) -> int:
        if size_in_bits == 0:
            return 0
        self.clear()
        byte_size = (size_in_bits + 7) >> 3
        self._store = bytearray(byte_size)
        self._capacity_bytes = byte_size
        return size_in_bits

    def assign(self, data: bytes) -> bool:
        """Copies an external buffer in and marks it fully written
        (bitstream.cpp:97-124)."""
        if not data:
            return False
        self.clear()
        self._store = bytearray(data)
        self._capacity_bytes = len(data)
        self.read_index = 0
        self.write_index = len(data) << 3
        return True

    def seek(self, offset: int):
        """Advances the read index. Reference quirk kept: if the target
        reaches or passes the write index, the read index lands at
        write_index + offset (bitstream.cpp:87-95)."""
        if self.read_index + offset >= self.write_index:
            self.read_index = self.write_index
        self.read_index += offset

    def clear(self):
        self.empty()
        self._store = bytearray()
        self._capacity_bytes = 0

    def empty(self):
        self.read_index = 0
        self.write_index = 0

    def is_empty(self) -> bool:
        return self.write_index == self.read_index

    def is_full(self) -> bool:
        return self.write_index == self.query_capacity()

    # -- writes ------------------------------------------------------------
    def write_bit(self, value: int) -> bool:
        if self.write_index + 1 > self.query_capacity():
            return False
        byte, bit = self.write_index >> 3, self.write_index & 7
        self._store[byte] = (self._store[byte] & ~(1 << bit)) | \
            ((value & 1) << bit)
        self.write_index += 1
        return True

    def write_byte(self, value: int) -> bool:
        if self.write_index + 8 > self.query_capacity():
            return False
        if self.write_index & 7 == 0:
            self._store[self.write_index >> 3] = value & 0xFF
            self.write_index += 8
        else:
            for i in range(8):
                self.write_bit((value >> i) & 1)
        return True

    def write_bits(self, data: bytes, bit_count: int) -> bool:
        """Writes bit_count bits from a byte buffer (LSB-first per byte)."""
        if not data or bit_count == 0:
            return False
        if self.write_index + bit_count > self.query_capacity():
            return False
        for k in range(bit_count):
            self.write_bit((data[k >> 3] >> (k & 7)) & 1)
        return True

    def write_bytes(self, data: bytes, count: int) -> bool:
        return self.write_bits(data, count << 3)

    # -- peeks / reads -----------------------------------------------------
    def peek_bit(self):
        if self.read_index >= self.write_index:
            return None
        return (self._store[self.read_index >> 3] >>
                (self.read_index & 7)) & 1

    def peek_byte(self):
        if self.read_index + 8 > self.write_index:
            return None
        out = 0
        for i in range(8):
            out |= ((self._store[(self.read_index + i) >> 3] >>
                     ((self.read_index + i) & 7)) & 1) << i
        return out

    def peek_bits(self, count: int):
        """Returns `count` bits as a bytes object (LSB-first), or None."""
        if count == 0 or self.read_index + count > self.write_index:
            return None
        out = bytearray((count + 7) >> 3)
        for k in range(count):
            pos = self.read_index + k
            bit = (self._store[pos >> 3] >> (pos & 7)) & 1
            out[k >> 3] |= bit << (k & 7)
        return bytes(out)

    def peek_bytes(self, count: int):
        return self.peek_bits(count << 3)

    def read_bit(self):
        out = self.peek_bit()
        if out is not None:
            self.read_index += 1
        return out

    def read_byte(self):
        out = self.peek_byte()
        if out is not None:
            self.read_index += 8
        return out

    def read_bits(self, count: int):
        out = self.peek_bits(count)
        if out is not None:
            self.read_index += count
        return out

    def read_bytes(self, count: int):
        return self.read_bits(count << 3)
