"""Copy of cairo_tpu.entropy.abac: the adaptive binary arithmetic coder
(ABAC), bit-exact with the evx1 format.

16-bit precision range coder with an adaptive 0/1 count model
(abac.cpp:5-12,28-41). One coder instance with one adaptive model spans an
entire frame slice (serialize.cpp:319-340), which makes the bit sequence
strictly serial — this Python implementation is the correctness anchor; the
C++ module in the port's native/ is the fast path.

Quirks preserved:
- 3QTR_RANGE is 3*(HALF>>1) = 0xBFFD, not 0xBFFF (abac.cpp:10).
- The decoder's refill bit is *sticky*: once the source is exhausted, the
  most recently read bit (0 at each call entry) is reused (abac.cpp:236,263-269).
- Encoder flush emits e3_count+1 disambiguation bits (abac.cpp:279-311).
"""

from __future__ import annotations

from .bitio import BitReader, BitWriter

PRECISION = 16
PREC_MAX = (1 << PRECISION) - 1          # 0xFFFF
HALF = PREC_MAX >> 1                     # 0x7FFF
QTR = HALF >> 1                          # 0x3FFF
THREE_QTR = 3 * QTR                      # 0xBFFD


class EntropyCoder:
    """Incremental ABAC encoder/decoder sharing one adaptive model."""

    __slots__ = ("h0", "h1", "e3", "low", "high", "value")

    def __init__(self):
        self.clear()

    def clear(self):
        self.h0 = 1
        self.h1 = 1
        self.e3 = 0
        self.low = 0
        self.high = PREC_MAX
        self.value = 0

    def _mid(self) -> int:
        return self.low + (self.high - self.low) * self.h0 // (self.h0 + self.h1)

    # -- encoding ---------------------------------------------------------

    def encode_bit(self, bit: int, out: BitWriter):
        mid = self._mid()
        if bit:
            self.low = mid + 1
            self.h1 += 1
        else:
            self.high = mid
            self.h0 += 1
        low, high, e3 = self.low, self.high, self.e3
        while True:
            if (high & 0x8000) == (low & 0x8000):
                msb = high >> 15
                if msb:
                    low -= HALF + 1
                    high -= HALF + 1
                out.write_bit(msb)
                inverse = msb ^ 1
                for _ in range(e3):
                    out.write_bit(inverse)
                e3 = 0
            elif high <= THREE_QTR and low > QTR:
                high -= QTR + 1
                low -= QTR + 1
                e3 += 1
            else:
                break
            high = ((high << 1) & PREC_MAX) | 1
            low = (low << 1) & PREC_MAX
        self.low, self.high, self.e3 = low, high, e3

    def encode_bits(self, value: int, count: int, out: BitWriter):
        for k in range(count):
            self.encode_bit((value >> k) & 1, out)

    def finish_encode(self, out: BitWriter):
        """Flush: one disambiguation bit + pending e3 inverse bits (abac.cpp:279)."""
        self.e3 += 1
        bit = 0 if self.low < QTR else 1
        out.write_bit(bit)
        inverse = bit ^ 1
        for _ in range(self.e3):
            out.write_bit(inverse)
        self.clear()

    # -- decoding ---------------------------------------------------------

    def start_decode(self, src: BitReader):
        self.clear()
        value = 0
        bit = 0
        for _ in range(PRECISION):
            if not src.is_empty():
                bit = src.read_bit()
            value = ((value << 1) | bit) & 0xFFFFFFFF
        self.value = value

    def decode_bit(self, src: BitReader) -> int:
        mid = self._mid()
        if self.low <= self.value <= mid:
            self.high = mid
            self.h0 += 1
            decoded = 0
        else:  # value in (mid, high]
            self.low = mid + 1
            self.h1 += 1
            decoded = 1
        low, high, value = self.low, self.high, self.value
        bit = 0
        while True:
            if high <= HALF:
                pass
            elif low > HALF:
                high -= HALF + 1
                low -= HALF + 1
                value -= HALF + 1
            elif high <= THREE_QTR and low > QTR:
                high -= QTR + 1
                low -= QTR + 1
                value -= QTR + 1
            else:
                break
            if not src.is_empty():
                bit = src.read_bit()
            high = ((high << 1) & PREC_MAX) | 1
            low = (low << 1) & PREC_MAX
            value = ((value << 1) & PREC_MAX) | bit
        self.low, self.high, self.value = low, high, value
        return decoded

    def decode_bits(self, count: int, src: BitReader) -> int:
        value = 0
        for k in range(count):
            value |= self.decode_bit(src) << k
        return value
