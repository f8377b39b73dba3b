// cairo-tpu native entropy backend: evx1 slice serializer/deserializer.
//
// Implements the slice format documented in docs/FORMAT.md (sections 1, 3-5)
// at host speed: LSB-first bit IO, the 16-bit adaptive binary arithmetic
// coder, exp-golomb value codes, zigzag RLE residual coding and DC-delta
// prediction. Operates on struct-of-arrays block tables and planar int16
// coefficient buffers, so the TPU pipeline can hand tensors straight in.
//
// This is an original implementation written against the format spec; the
// reference implementation (abac.cpp, stream.cpp, serialize.cpp) defines the
// wire behavior it must reproduce.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <initializer_list>
#include <thread>

namespace {

// ---------------------------------------------------------------- bit io

struct BitSink {
    uint8_t *out;
    uint64_t capacity_bits;
    uint64_t acc = 0;   // pending bits, LSB-first
    unsigned nacc = 0;
    uint64_t nbits = 0; // bits flushed + pending
    bool overflow = false;

    void push(uint64_t bits, unsigned count) {
        // count <= 48 so acc never overflows before a flush
        acc |= bits << nacc;
        nacc += count;
        nbits += count;
        if (nbits > capacity_bits) {
            overflow = true;
            return;
        }
        while (nacc >= 8) {
            out[(nbits - nacc) >> 3] = (uint8_t)(acc & 0xFF);
            acc >>= 8;
            nacc -= 8;
        }
    }

    void push_bit(unsigned bit) { push(bit & 1u, 1); }

    uint64_t finish() {
        if (nacc) {
            out[(nbits - nacc) >> 3] = (uint8_t)(acc & ((1u << nacc) - 1));
        }
        return nbits;
    }
};

struct BitSource {
    const uint8_t *data;
    uint64_t bit_pos = 0;
    uint64_t bit_limit;

    bool empty() const { return bit_pos >= bit_limit; }

    unsigned read_bit() {
        unsigned bit = (data[bit_pos >> 3] >> (bit_pos & 7)) & 1u;
        ++bit_pos;
        return bit;
    }
};

// ---------------------------------------------------------------- golomb

// code for signed int16 v: payload (|v|<<1 | neg, 0 -> 1) with b significant
// bits emitted as (b-1) zeros then payload MSB-first; we precompute the
// LSB-first packed image per 16-bit pattern.
struct GolombEntry {
    uint64_t code;
    uint8_t len;
};

GolombEntry signed_lut[65536];
GolombEntry unsigned_lut[512];
bool luts_ready = false;

GolombEntry make_code(uint64_t payload) {
    unsigned width = 0;
    for (uint64_t v = payload; v; v >>= 1) ++width;
    uint64_t rev = 0;
    for (unsigned k = 0; k < width; ++k) {
        rev = (rev << 1) | ((payload >> k) & 1);
    }
    GolombEntry e;
    e.code = rev << (width - 1);
    e.len = (uint8_t)(2 * width - 1);
    return e;
}

void init_luts() {
    if (luts_ready) return;
    for (int i = 0; i < 65536; ++i) {
        int v = (i >= 32768) ? i - 65536 : i;
        // int32 abs (the reference casts to int32 before abs, so -32768
        // maps to +32768 and produces a 33-bit code)
        int64_t a = v < 0 ? -(int64_t)v : v;
        uint64_t payload = (v == 0) ? 1 : ((uint64_t)a << 1) | (v < 0 ? 1 : 0);
        signed_lut[i] = make_code(payload);
    }
    for (int i = 0; i < 512; ++i) {
        unsigned_lut[i] = make_code((uint64_t)i + 1);
    }
    luts_ready = true;
}

// ---------------------------------------------------------------- ABAC

constexpr uint32_t kPrecMax = 0xFFFF;
constexpr uint32_t kHalf = 0x7FFF;
constexpr uint32_t kQtr = 0x3FFF;
constexpr uint32_t kThreeQtr = 3 * kQtr;  // 0xBFFD

struct Abac {
    uint32_t h0 = 1, h1 = 1;
    uint32_t e3 = 0;
    uint32_t low = 0, high = kPrecMax;
    uint32_t value = 0;

    uint32_t mid() const {
        return low + (uint32_t)((uint64_t)(high - low) * h0 / (h0 + h1));
    }

    void encode_bit(unsigned bit, BitSink &sink) {
        uint32_t m = mid();
        if (bit) {
            low = m + 1;
            ++h1;
        } else {
            high = m;
            ++h0;
        }
        for (;;) {
            if ((high & 0x8000u) == (low & 0x8000u)) {
                unsigned msb = high >> 15;
                if (msb) {
                    low -= kHalf + 1;
                    high -= kHalf + 1;
                }
                sink.push_bit(msb);
                unsigned inv = msb ^ 1u;
                for (uint32_t k = 0; k < e3; ++k) sink.push_bit(inv);
                e3 = 0;
            } else if (high <= kThreeQtr && low > kQtr) {
                high -= kQtr + 1;
                low -= kQtr + 1;
                ++e3;
            } else {
                break;
            }
            high = ((high << 1) & kPrecMax) | 1u;
            low = (low << 1) & kPrecMax;
        }
    }

    void encode_bits(uint64_t bits, unsigned count, BitSink &sink) {
        for (unsigned k = 0; k < count; ++k) {
            encode_bit((bits >> k) & 1u, sink);
        }
    }

    void finish(BitSink &sink) {
        ++e3;
        unsigned bit = (low < kQtr) ? 0u : 1u;
        sink.push_bit(bit);
        unsigned inv = bit ^ 1u;
        for (uint32_t k = 0; k < e3; ++k) sink.push_bit(inv);
    }

    void start_decode(BitSource &src) {
        unsigned bit = 0;
        value = 0;
        for (int k = 0; k < 16; ++k) {
            if (!src.empty()) bit = src.read_bit();
            value = (value << 1) | bit;
        }
    }

    unsigned decode_bit(BitSource &src) {
        uint32_t m = mid();
        unsigned decoded;
        if (value >= low && value <= m) {
            high = m;
            ++h0;
            decoded = 0;
        } else {
            low = m + 1;
            ++h1;
            decoded = 1;
        }
        unsigned bit = 0;  // sticky within this call (abac.cpp:236)
        for (;;) {
            if (high <= kHalf) {
                // renormalize below
            } else if (low > kHalf) {
                high -= kHalf + 1;
                low -= kHalf + 1;
                value -= kHalf + 1;
            } else if (high <= kThreeQtr && low > kQtr) {
                high -= kQtr + 1;
                low -= kQtr + 1;
                value -= kQtr + 1;
            } else {
                break;
            }
            if (!src.empty()) bit = src.read_bit();
            high = ((high << 1) & kPrecMax) | 1u;
            low = (low << 1) & kPrecMax;
            value = ((value << 1) & kPrecMax) | bit;
        }
        return decoded;
    }

    uint64_t decode_bits(unsigned count, BitSource &src) {
        uint64_t v = 0;
        for (unsigned k = 0; k < count; ++k) {
            v |= (uint64_t)decode_bit(src) << k;
        }
        return v;
    }
};

// ------------------------------------------------------------- residuals

// zigzag order for an 8x8 block (standard; matches scan.h:60-70)
const uint8_t kZigzag8[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

inline void encode_sgolomb(Abac &coder, BitSink &sink, int16_t v) {
    const GolombEntry &e = signed_lut[(uint16_t)v];
    coder.encode_bits(e.code, e.len, sink);
}

inline void encode_ugolomb(Abac &coder, BitSink &sink, unsigned v) {
    const GolombEntry &e = unsigned_lut[v];
    coder.encode_bits(e.code, e.len, sink);
}

// Reads one golomb payload through the coder; returns payload and writes
// the total significant bit count (for the -32768 escape).
//
// Adversarial-input bound: no legal evx1 code has more than 16 leading
// zeros (int16 values cap the payload at 17 significant bits — the
// -32768 escape, golomb.cpp:63-91). A corrupt or truncated stream can
// otherwise keep the zero-run spinning forever (the ABAC pads past EOF
// with sticky bits), so runs beyond the legal maximum set `err`.
constexpr unsigned kMaxGolombZeros = 16;

inline uint64_t decode_payload(Abac &coder, BitSource &src, unsigned *nbits,
                               bool *err) {
    unsigned zeros = 0;
    while (!coder.decode_bit(src)) {
        if (++zeros > kMaxGolombZeros) {
            *err = true;
            *nbits = 0;
            return 1;
        }
    }
    uint64_t payload = 1;
    for (unsigned k = 0; k < zeros; ++k) {
        payload = (payload << 1) | coder.decode_bit(src);
    }
    *nbits = 2 * zeros + 1;
    return payload;
}

inline unsigned decode_ugolomb(Abac &coder, BitSource &src, bool *err) {
    unsigned nbits;
    return (unsigned)((decode_payload(coder, src, &nbits, err) - 1) & 0xFFFF);
}

inline int16_t decode_sgolomb(Abac &coder, BitSource &src, bool *err) {
    unsigned nbits;
    uint64_t payload = decode_payload(coder, src, &nbits, err);
    int32_t sign = 1 - 2 * (int32_t)(payload & 1);
    int32_t result = sign * (int32_t)((payload >> 1) & 0x7FFF);
    if (nbits > 0x20) {
        result = (int16_t)(result | 0x8000);
    }
    return (int16_t)result;
}

// RLE-codes one 8x8 block (stride = row pitch of the plane) with DC delta.
void encode_block8(Abac &coder, BitSink &sink, const int16_t *block,
                   unsigned stride, int16_t dc_pred) {
    int16_t zz[64];
    for (int k = 0; k < 64; ++k) {
        unsigned p = kZigzag8[k];
        zz[k] = block[(p >> 3) * stride + (p & 7)];
    }
    zz[0] = (int16_t)(zz[0] - dc_pred);
    int last = 63;
    while (last >= 0 && zz[last] == 0) --last;
    unsigned run = (unsigned)(last + 1);
    encode_ugolomb(coder, sink, run);
    for (unsigned k = 0; k < run; ++k) {
        encode_sgolomb(coder, sink, zz[k]);
    }
}

void decode_block8(Abac &coder, BitSource &src, int16_t *block,
                   unsigned stride, int16_t dc_pred, bool *err) {
    int16_t zz[64];
    memset(zz, 0, sizeof(zz));
    unsigned run = decode_ugolomb(coder, src, err);
    if (run > 64) {  // no legal encoder emits more than 64 coefficients
        *err = true;
        run = 0;
    }
    for (unsigned k = 0; k < run && !*err; ++k) {
        zz[k] = decode_sgolomb(coder, src, err);
    }
    int16_t out[64];
    for (int k = 0; k < 64; ++k) {
        out[kZigzag8[k]] = zz[k];
    }
    out[0] = (int16_t)(out[0] + dc_pred);
    for (int r = 0; r < 8; ++r) {
        memcpy(block + r * stride, out + r * 8, 8 * sizeof(int16_t));
    }
}

struct BlockTableView {
    const uint8_t *type;
    const uint8_t *target;
    const int16_t *mx;
    const int16_t *my;
    const uint8_t *sp_pred;
    const uint8_t *sp_amount;
    const uint8_t *sp_index;
    const uint8_t *q_index;
};

inline bool t_intra(uint8_t t) { return t & 1; }
inline bool t_motion(uint8_t t) { return t & 2; }
inline bool t_copy(uint8_t t) { return t & 4; }

// DC predictor for the block at plane position (bx, by) in 8-px units:
// left block's DC at x-8, else above block's DC at y-8, else 0.
inline int16_t plane_dc_pred(const int16_t *plane, unsigned stride,
                             unsigned x, unsigned y) {
    if (x >= 8) return plane[y * stride + (x - 8)];
    if (y >= 8) return plane[(y - 8) * stride + x];
    return 0;
}

} // namespace

extern "C" {

// Serializes one slice. Returns the total bit count, or -1 on overflow.
long long evxn_encode_slice(
    unsigned n_blocks, unsigned wb, unsigned hb,
    const uint8_t *type, const uint8_t *target, const int16_t *mx,
    const int16_t *my, const uint8_t *sp_pred, const uint8_t *sp_amount,
    const uint8_t *sp_index, const uint8_t *q_index,
    const int16_t *yp, const int16_t *up, const int16_t *vp,
    unsigned yw, unsigned yh,
    uint8_t *out, unsigned long long out_capacity_bytes) {
    init_luts();
    BlockTableView bt{type, target, mx, my, sp_pred, sp_amount, sp_index, q_index};
    BitSink sink{out, out_capacity_bytes * 8};
    Abac coder;

    for (unsigned i = 0; i < n_blocks; ++i) {
        coder.encode_bits(bt.type[i] & 7u, 3, sink);
    }
    for (unsigned i = 0; i < n_blocks; ++i) {
        if (!t_intra(bt.type[i])) coder.encode_bits(bt.target[i] & 3u, 2, sink);
    }
    int16_t last = 0;
    for (unsigned i = 0; i < n_blocks; ++i) {
        if (!t_motion(bt.type[i])) continue;
        encode_sgolomb(coder, sink, (int16_t)(bt.mx[i] - last));
        last = bt.mx[i];
    }
    last = 0;
    for (unsigned i = 0; i < n_blocks; ++i) {
        if (!t_motion(bt.type[i])) continue;
        encode_sgolomb(coder, sink, (int16_t)(bt.my[i] - last));
        last = bt.my[i];
    }
    for (unsigned i = 0; i < n_blocks; ++i) {
        if (t_motion(bt.type[i])) coder.encode_bit(bt.sp_pred[i] & 1u, sink);
    }
    for (unsigned i = 0; i < n_blocks; ++i) {
        if (t_motion(bt.type[i]) && bt.sp_pred[i])
            coder.encode_bit(bt.sp_amount[i] & 1u, sink);
    }
    for (unsigned i = 0; i < n_blocks; ++i) {
        if (t_motion(bt.type[i]) && bt.sp_pred[i])
            coder.encode_bits(bt.sp_index[i] & 7u, 3, sink);
    }
    last = 0;
    for (unsigned i = 0; i < n_blocks; ++i) {
        if (t_copy(bt.type[i])) continue;
        encode_sgolomb(coder, sink, (int16_t)((int16_t)bt.q_index[i] - last));
        last = (int16_t)bt.q_index[i];
    }

    // residuals: Y (4 sub-blocks per MB), then U, then V
    for (unsigned b = 0; b < n_blocks; ++b) {
        if (t_copy(bt.type[b])) continue;
        unsigned x = (b % wb) * 16, y = (b / wb) * 16;
        const int16_t *mb = yp + y * yw + x;
        int16_t dc = plane_dc_pred(yp, yw, x, y);
        encode_block8(coder, sink, mb, yw, dc);
        encode_block8(coder, sink, mb + 8, yw, mb[0]);
        encode_block8(coder, sink, mb + 8 * yw, yw, mb[0]);
        encode_block8(coder, sink, mb + 8 * yw + 8, yw, mb[8 * yw]);
    }
    unsigned cw = yw >> 1;
    for (const int16_t *plane : {up, vp}) {
        for (unsigned b = 0; b < n_blocks; ++b) {
            if (t_copy(bt.type[b])) continue;
            unsigned x = (b % wb) * 8, y = (b / wb) * 8;
            int16_t dc = plane_dc_pred(plane, cw, x, y);
            encode_block8(coder, sink, plane + y * cw + x, cw, dc);
        }
    }

    coder.finish(sink);
    if (sink.overflow) return -1;
    return (long long)sink.finish();
}

// Deserializes one slice into the (persistent) table arrays and planes.
// Returns the number of bits consumed from the source, or -1 if the
// stream is structurally invalid (illegal golomb run / coefficient
// count) — corrupt or hostile input can otherwise spin the zero-run
// loops or flood the block tables. Bit reads past `bit_limit` follow the
// reference's zero-padding semantics (abac.cpp:367-380), so truncation
// alone is not an error unless it produces an illegal code.
long long evxn_decode_slice(
    const uint8_t *data, unsigned long long bit_limit,
    unsigned n_blocks, unsigned wb, unsigned hb,
    uint8_t *type, uint8_t *target, int16_t *mx, int16_t *my,
    uint8_t *sp_pred, uint8_t *sp_amount, uint8_t *sp_index,
    uint8_t *q_index,
    int16_t *yp, int16_t *up, int16_t *vp,
    unsigned yw, unsigned yh) {
    init_luts();
    BitSource src{data, 0, bit_limit};
    Abac coder;
    coder.start_decode(src);
    bool err = false;

    for (unsigned i = 0; i < n_blocks; ++i) {
        type[i] = (uint8_t)coder.decode_bits(3, src);
    }
    for (unsigned i = 0; i < n_blocks; ++i) {
        if (!t_intra(type[i])) target[i] = (uint8_t)coder.decode_bits(2, src);
    }
    int16_t last = 0;
    for (unsigned i = 0; i < n_blocks && !err; ++i) {
        if (!t_motion(type[i])) continue;
        mx[i] = (int16_t)(last + decode_sgolomb(coder, src, &err));
        last = mx[i];
    }
    last = 0;
    for (unsigned i = 0; i < n_blocks && !err; ++i) {
        if (!t_motion(type[i])) continue;
        my[i] = (int16_t)(last + decode_sgolomb(coder, src, &err));
        last = my[i];
    }
    for (unsigned i = 0; i < n_blocks; ++i) {
        if (t_motion(type[i])) sp_pred[i] = (uint8_t)coder.decode_bit(src);
    }
    for (unsigned i = 0; i < n_blocks; ++i) {
        if (t_motion(type[i]) && sp_pred[i])
            sp_amount[i] = (uint8_t)coder.decode_bit(src);
    }
    for (unsigned i = 0; i < n_blocks; ++i) {
        if (t_motion(type[i]) && sp_pred[i])
            sp_index[i] = (uint8_t)coder.decode_bits(3, src);
    }
    last = 0;
    for (unsigned i = 0; i < n_blocks && !err; ++i) {
        if (t_copy(type[i])) continue;
        q_index[i] = (uint8_t)(last + decode_sgolomb(coder, src, &err));
        last = (int16_t)q_index[i];
    }

    for (unsigned b = 0; b < n_blocks && !err; ++b) {
        if (t_copy(type[b])) continue;
        unsigned x = (b % wb) * 16, y = (b / wb) * 16;
        int16_t *mb = yp + y * yw + x;
        int16_t dc = plane_dc_pred(yp, yw, x, y);
        decode_block8(coder, src, mb, yw, dc, &err);
        decode_block8(coder, src, mb + 8, yw, mb[0], &err);
        decode_block8(coder, src, mb + 8 * yw, yw, mb[0], &err);
        decode_block8(coder, src, mb + 8 * yw + 8, yw, mb[8 * yw], &err);
    }
    unsigned cw = yw >> 1;
    for (int16_t *plane : {up, vp}) {
        for (unsigned b = 0; b < n_blocks && !err; ++b) {
            if (t_copy(type[b])) continue;
            unsigned x = (b % wb) * 8, y = (b / wb) * 8;
            int16_t dc = plane_dc_pred(plane, cw, x, y);
            decode_block8(coder, src, plane + y * cw + x, cw, dc, &err);
        }
    }
    if (err) return -1;
    return (long long)src.bit_pos;
}

// Collects the nonzero residual coefficients of non-copy macroblocks as a
// COO list over the concatenated Y|U|V plane space (device upload format,
// tpu/wire.py). Returns the true nonzero count; entries beyond `cap` are
// not written (the caller falls back to a dense upload).
long long evxn_extract_coo(
    const uint8_t *type, unsigned n_blocks, unsigned wb,
    const int16_t *yp, const int16_t *up, const int16_t *vp,
    unsigned yw, unsigned yh,
    int *coo_pos, int16_t *coo_val, long long cap) {
    long long cnt = 0;
    const unsigned cw = yw >> 1, chh = yh >> 1;
    const long long ubase = (long long)yw * yh;
    const long long vbase = ubase + (long long)cw * chh;
    for (unsigned b = 0; b < n_blocks; ++b) {
        if (t_copy(type[b])) continue;  // stays stale on device
        unsigned x = (b % wb) * 16, y = (b / wb) * 16;
        for (unsigned r = 0; r < 16; ++r) {
            const int16_t *row = yp + (long long)(y + r) * yw + x;
            long long base = (long long)(y + r) * yw + x;
            for (unsigned c = 0; c < 16; ++c) {
                if (row[c]) {
                    if (cnt < cap) {
                        coo_pos[cnt] = (int)(base + c);
                        coo_val[cnt] = row[c];
                    }
                    ++cnt;
                }
            }
        }
        unsigned cx = (b % wb) * 8, cy = (b / wb) * 8;
        const int16_t *planes[2] = {up, vp};
        const long long bases[2] = {ubase, vbase};
        for (int pl = 0; pl < 2; ++pl) {
            for (unsigned r = 0; r < 8; ++r) {
                const int16_t *row = planes[pl] + (long long)(cy + r) * cw + cx;
                long long base = bases[pl] + (long long)(cy + r) * cw + cx;
                for (unsigned c = 0; c < 8; ++c) {
                    if (row[c]) {
                        if (cnt < cap) {
                            coo_pos[cnt] = (int)(base + c);
                            coo_val[cnt] = row[c];
                        }
                        ++cnt;
                    }
                }
            }
        }
    }
    return cnt;
}

// Converts an RGB frame to the encoder's 8-bit YUV source wire:
// [y-16 bytes | u bytes | v bytes] over the aligned grid. Legal source
// values fit 8 bits exactly (y in [16, 271] -> y-16 in [0, 255]; chroma
// in [0, 255], convert.cpp:7-73). Pixels beyond the real frame are
// converted from rgb=0 (they contribute to edge chroma quads) and the
// planes are masked to 0 outside the frame; the device re-adds the +16
// luma shift only on in-frame cells (static mask), reproducing the
// single-chip padding semantics bit-exactly.
static void rgb_to_yuv8_rows(const uint8_t *rgb, unsigned width,
                             unsigned height, unsigned aw, unsigned ah,
                             uint8_t *wire, unsigned r0, unsigned r1);

long long evxn_rgb_to_yuv8(const uint8_t *rgb, unsigned width,
                           unsigned height, unsigned aw, unsigned ah,
                           uint8_t *wire) {
    const unsigned cw = aw >> 1;
    const long long ysz = (long long)aw * ah;
    const long long csz = (long long)cw * (ah >> 1);
    // the conversion sits on the encoder's critical path (~20 ms at
    // 1080p single-threaded); split the row range across two threads
    // for frames worth the spawn cost
    if (ah >= 256) {
        unsigned mid = ((ah / 2) >> 1) << 1;  // even split
        std::thread top(rgb_to_yuv8_rows, rgb, width, height, aw, ah,
                        wire, 0u, mid);
        rgb_to_yuv8_rows(rgb, width, height, aw, ah, wire, mid, ah);
        top.join();
    } else {
        rgb_to_yuv8_rows(rgb, width, height, aw, ah, wire, 0, ah);
    }
    return ysz + 2 * csz;
}

static void rgb_to_yuv8_rows(const uint8_t *rgb, unsigned width,
                             unsigned height, unsigned aw, unsigned ah,
                             uint8_t *wire, unsigned r0, unsigned r1) {
    const unsigned cw = aw >> 1;
    const long long ysz = (long long)aw * ah;
    const long long csz = (long long)cw * (ah >> 1);

    for (unsigned r = r0; r < r1; r += 2) {
        for (unsigned c = 0; c < aw; c += 2) {
            int usum = 0, vsum = 0;
            for (unsigned dy = 0; dy < 2; ++dy) {
                for (unsigned dx = 0; dx < 2; ++dx) {
                    unsigned py = r + dy, px = c + dx;
                    int rr = 0, gg = 0, bb = 0;
                    bool in = py < height && px < width;
                    if (in) {
                        const uint8_t *p = rgb + ((long long)py * width + px) * 3;
                        rr = p[0]; gg = p[1]; bb = p[2];
                    }
                    int y = (77 * rr + 150 * gg + 29 * bb + 128) >> 8;
                    int cu = (-43 * rr - 85 * gg + 128 * bb + 128) / 256 + 128;
                    int cv = (128 * rr - 107 * gg - 21 * bb + 128) / 256 + 128;
                    usum += cu;
                    vsum += cv;
                    wire[(long long)py * aw + px] = (uint8_t)(in ? y : 0);
                }
            }
            bool cin = r < height && c < width;
            long long cidx = (long long)(r >> 1) * cw + (c >> 1);
            wire[ysz + cidx] = (uint8_t)(cin ? ((usum + 2) >> 2) : 0);
            wire[ysz + csz + cidx] = (uint8_t)(cin ? ((vsum + 2) >> 2) : 0);
        }
    }
}

// Converts the decoder's 8-bit YUV output wire (tpu/wire.py layout) to RGB
// with the exact integer math of convert.cpp:75-93 (arithmetic shifts,
// final clip). The wire stores Y minus its +16 offset (legal Y spans
// [16, 271] = exactly one byte), chroma as-is; out-of-window values ride
// the exception list. Returns the wire's exception count; count > exc_k
// means the wire was clipped and the caller must refetch exact planes.
long long evxn_yuv_wire_to_rgb(
    const uint8_t *wire, unsigned aw, unsigned ah,
    unsigned width, unsigned height, unsigned exc_k, uint8_t *rgb) {
    const long long ysz = (long long)aw * ah;
    const unsigned cw = aw >> 1, chh = ah >> 1;
    const long long csz = (long long)cw * chh;
    const long long total = ysz + 2 * csz;
    const uint8_t *lo = wire;
    const uint8_t *tail = wire + total;
    int exc_count;
    memcpy(&exc_count, tail, 4);
    long long n_exc = exc_count < (int)exc_k ? exc_count : (long long)exc_k;

    // value lookup straight from the wire; exceptions resolved by a scan
    // of the (tiny, usually empty) list — avoids materializing a 6 MB
    // int16 temp on the (shared, contended) host cores
    auto wire_val = [&](long long i) -> int {
        return (int)lo[i] + (i < ysz ? 16 : 0);
    };
    auto exact_val = [&](long long i) -> int {
        for (long long k = 0; k < n_exc; ++k) {
            int pos;
            memcpy(&pos, tail + 4 + 4 * k, 4);
            if (pos == (int)i) {
                int16_t v;
                memcpy(&v, tail + 4 + 4 * (long long)exc_k + 2 * k, 2);
                return v;
            }
        }
        return wire_val(i);
    };
    auto emit = [&](unsigned r, unsigned c, int yv, int uv, int vv2) {
        int yy = yv - 16, uu = uv - 128, vv = vv2 - 128;
        int rr = (256 * yy + 358 * vv + 128) >> 8;
        int gg = (256 * yy - 88 * uu - 182 * vv + 128) >> 8;
        int bb = (256 * yy + 452 * uu + 128) >> 8;
        uint8_t *o = rgb + ((long long)r * width + c) * 3;
        o[0] = (uint8_t)(rr < 0 ? 0 : (rr > 255 ? 255 : rr));
        o[1] = (uint8_t)(gg < 0 ? 0 : (gg > 255 ? 255 : gg));
        o[2] = (uint8_t)(bb < 0 ? 0 : (bb > 255 ? 255 : bb));
    };

    auto rows = [&](unsigned rr0, unsigned rr1) {
        for (unsigned r = rr0; r < rr1; ++r) {
            const uint8_t *ylo = lo + (long long)r * aw;
            const long long urow = ysz + (long long)(r >> 1) * cw;
            const long long vrow = urow + csz;
            uint8_t *orow = rgb + (long long)r * width * 3;
            for (unsigned c = 0; c < width; ++c) {
                int yy = (int)ylo[c];  // wire Y is already value-16
                long long ui = urow + (c >> 1), vi = vrow + (c >> 1);
                int uu = wire_val(ui) - 128;
                int vv = wire_val(vi) - 128;
                int rr = (256 * yy + 358 * vv + 128) >> 8;
                int gg = (256 * yy - 88 * uu - 182 * vv + 128) >> 8;
                int bb = (256 * yy + 452 * uu + 128) >> 8;
                orow[3 * c + 0] =
                    (uint8_t)(rr < 0 ? 0 : (rr > 255 ? 255 : rr));
                orow[3 * c + 1] =
                    (uint8_t)(gg < 0 ? 0 : (gg > 255 ? 255 : gg));
                orow[3 * c + 2] =
                    (uint8_t)(bb < 0 ? 0 : (bb > 255 ? 255 : bb));
            }
        }
    };
    if (height >= 256) {  // split the bulk conversion across two threads
        unsigned mid = height / 2;
        std::thread top(rows, 0u, mid);
        rows(mid, height);
        top.join();
    } else {
        rows(0, height);
    }

    // fix up the pixels an exception touches (1 px for Y, a 2x2 quad for
    // chroma), recomputing every component through the exception list
    for (long long k = 0; k < n_exc; ++k) {
        int pos;
        memcpy(&pos, tail + 4 + 4 * k, 4);
        long long p = pos;
        if (p < ysz) {
            unsigned r = (unsigned)(p / aw), c = (unsigned)(p % aw);
            if (r < height && c < width)
                emit(r, c, exact_val(p),
                     exact_val(ysz + (long long)(r >> 1) * cw + (c >> 1)),
                     exact_val(ysz + csz + (long long)(r >> 1) * cw
                               + (c >> 1)));
        } else {
            long long cp = (p - ysz) % csz;
            unsigned cr = (unsigned)(cp / cw), cc = (unsigned)(cp % cw);
            for (unsigned dr = 0; dr < 2; ++dr)
                for (unsigned dc = 0; dc < 2; ++dc) {
                    unsigned r = 2 * cr + dr, c = 2 * cc + dc;
                    if (r < height && c < width)
                        emit(r, c, exact_val((long long)r * aw + c),
                             exact_val(ysz + (long long)cr * cw + cc),
                             exact_val(ysz + csz + (long long)cr * cw + cc));
                }
        }
    }
    return exc_count;
}

// Unpacks the decoder's 5-bit-delta YUV output wire (tpu/wire.py
// pack_yuv5d_wire) and converts to RGB with the exact integer math of
// convert.cpp:75-93. Wire: [count i32 | exc_k pos i32 | exc_k val i16 |
// packed fields]; fields hold clip(delta,-16,15) (horizontal; vertical
// at column 0) of the shifted-space planes (Y minus +16, chroma as-is);
// exceptions carry exact absolute values at ascending flat positions and
// are substituted during the sequential prefix scan. Returns the wire's
// exception count; count > exc_k means the wire was clipped and the
// caller must refetch exact planes. `tmp` must hold ah*aw + 2*(ah/2 *
// aw/2) int16 (scratch the caller owns, avoiding a per-frame alloc).
long long evxn_yuv5d_wire_to_rgb(
    const uint8_t *wire, unsigned aw, unsigned ah,
    unsigned width, unsigned height, unsigned exc_k,
    int16_t *tmp, uint8_t *rgb) {
    const unsigned cw = aw >> 1, chh = ah >> 1;
    const long long ysz = (long long)aw * ah;
    const long long csz = (long long)cw * chh;
    int exc_count;
    memcpy(&exc_count, wire, 4);
    if (exc_count > (int)exc_k) return exc_count;
    const uint8_t *exc_pos_b = wire + 4;
    const uint8_t *exc_val_b = wire + 4 + 4 * (long long)exc_k;
    const uint8_t *packed = wire + 4 + 6 * (long long)exc_k;

    auto field = [&](long long g) -> int {
        const long long bit = 5 * g;
        const int off = (int)(bit & 7);
        unsigned v = (unsigned)(packed[bit >> 3] >> off);
        if (off > 3) v |= (unsigned)packed[(bit >> 3) + 1] << (8 - off);
        v &= 31;
        return (int)((v ^ 16u) - 16u);  // sign-extend 5 bits
    };

    long long e = 0;  // exception cursor (positions ascend)
    auto exc_at = [&](long long pos) -> bool {
        if (e >= exc_count) return false;
        int p;
        memcpy(&p, exc_pos_b + 4 * e, 4);
        return p == (int)pos;
    };

    struct P { int16_t *out; unsigned w, h; long long base; };
    const P planes[3] = {{tmp, aw, ah, 0},
                         {tmp + ysz, cw, chh, ysz},
                         {tmp + ysz + csz, cw, chh, ysz + csz}};
    for (const P &pl : planes) {
        int prev_c0 = 0;
        for (unsigned r = 0; r < pl.h; ++r) {
            int16_t *row = pl.out + (long long)r * pl.w;
            const long long fbase = pl.base + (long long)r * pl.w;
            int prev = prev_c0;
            for (unsigned c = 0; c < pl.w; ++c) {
                int v = prev + field(fbase + c);
                if (exc_at(fbase + c)) {
                    int16_t ev;
                    memcpy(&ev, exc_val_b + 2 * e, 2);
                    v = ev;
                    ++e;
                }
                row[c] = (int16_t)v;
                prev = v;
                if (c == 0) prev_c0 = v;
            }
        }
    }

    auto rows = [&](unsigned rr0, unsigned rr1) {
        const int16_t *yp = tmp;
        const int16_t *up = tmp + ysz;
        const int16_t *vp = tmp + ysz + csz;
        for (unsigned r = rr0; r < rr1; ++r) {
            const int16_t *ylo = yp + (long long)r * aw;
            const int16_t *ulo = up + (long long)(r >> 1) * cw;
            const int16_t *vlo = vp + (long long)(r >> 1) * cw;
            uint8_t *orow = rgb + (long long)r * width * 3;
            for (unsigned c = 0; c < width; ++c) {
                int yy = (int)ylo[c];  // shifted space = y - 16 already
                int uu = (int)ulo[c >> 1] - 128;
                int vv = (int)vlo[c >> 1] - 128;
                int rr = (256 * yy + 358 * vv + 128) >> 8;
                int gg = (256 * yy - 88 * uu - 182 * vv + 128) >> 8;
                int bb = (256 * yy + 452 * uu + 128) >> 8;
                orow[3 * c + 0] =
                    (uint8_t)(rr < 0 ? 0 : (rr > 255 ? 255 : rr));
                orow[3 * c + 1] =
                    (uint8_t)(gg < 0 ? 0 : (gg > 255 ? 255 : gg));
                orow[3 * c + 2] =
                    (uint8_t)(bb < 0 ? 0 : (bb > 255 ? 255 : bb));
            }
        }
    };
    if (height >= 256) {
        unsigned mid = height / 2;
        std::thread top(rows, 0u, mid);
        rows(mid, height);
        top.join();
    } else {
        rows(0, height);
    }
    return exc_count;
}

// Packs the 8-bit YUV source wire (evxn_rgb_to_yuv8 payload) into the
// 5-bit-delta uplink wire: each value is stored as a 5-bit field holding
// clip(delta, -16, 15), where delta is the horizontal difference to the
// left neighbour (column 0 uses the vertical difference to the row above;
// row 0 / col 0 differences against 0). Deltas the field cannot hold ride
// the exception list as (flat position, true delta) pairs, so the device
// reconstruction (clipped-field scatter-set + cumsum, tpu/wire.py
// unpack_yuv5d) is bit-exact for ANY content; callers fall back to the
// plain 8-bit wire when n_exc > exc_k. Field g occupies stream bits
// [5g, 5g+5) little-endian, matching the device's u32-word unpack.
// `packed` must be zeroed and hold ceil(total*5/8) bytes. Returns the
// total exception count (may exceed exc_k; only exc_k entries written).
long long evxn_pack_yuv5d(const uint8_t *yuv, unsigned aw, unsigned ah,
                          unsigned exc_k, uint8_t *packed,
                          int *exc_pos, int16_t *exc_val) {
    const unsigned cw = aw >> 1, chh = ah >> 1;
    const long long ysz = (long long)aw * ah;
    const long long csz = (long long)cw * chh;
    struct PlaneRef { const uint8_t *p; unsigned w, h; long long base; };
    const PlaneRef planes[3] = {
        {yuv, aw, ah, 0},
        {yuv + ysz, cw, chh, ysz},
        {yuv + ysz + csz, cw, chh, ysz + csz}};
    long long n_exc = 0;
    for (const PlaneRef &pl : planes) {
        for (unsigned r = 0; r < pl.h; ++r) {
            const uint8_t *row = pl.p + (long long)r * pl.w;
            const long long fbase = pl.base + (long long)r * pl.w;
            int prev = r ? (int)row[-(long long)pl.w] : 0;  // col-0 vertical
            for (unsigned c = 0; c < pl.w; ++c) {
                int d = (int)row[c] - prev;
                prev = row[c];
                int st = d < -16 ? -16 : (d > 15 ? 15 : d);
                if (st != d) {
                    if (n_exc < (long long)exc_k) {
                        exc_pos[n_exc] = (int)(fbase + c);
                        exc_val[n_exc] = (int16_t)d;
                    }
                    ++n_exc;
                }
                const long long bit = 5 * (fbase + c);
                const int off = (int)(bit & 7);
                packed[bit >> 3] |= (uint8_t)((st & 31) << off);
                if (off > 3)
                    packed[(bit >> 3) + 1] |= (uint8_t)((unsigned)(st & 31)
                                                        >> (8 - off));
            }
        }
    }
    return n_exc;
}

} // extern "C"
