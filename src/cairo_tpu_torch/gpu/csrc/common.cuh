// Helpers shared by the prediction (pred.cu), inter-search (inter.cu),
// wave-pass (wave.cu) and wave-decode (wavedec.cu) kernels. The integer
// helpers repeat the C arithmetic of gpu/ops.py exactly, int32 wrap
// included: where a torch int32 op may wrap, the helper computes in
// uint32_t and casts back, because signed overflow is undefined in CUDA
// C++. The search helpers (acceptance rules, the frame test, sub-pel
// directions and blends) are the one copy of the reference's
// motion-search rules that K5 and K6 both run; Windows is K6's search
// window.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cairo {

constexpr int MB = 16;
constexpr int RING = 4;
constexpr int SAD_THRESHOLD = 8192;   // tables.MOTION_SAD_THRESHOLD
constexpr int INT32_MAX_ = 0x7FFFFFFF;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int add_w(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int sub_w(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

__device__ __forceinline__ int mul_w(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wrap16(int v) {
  return static_cast<int>(static_cast<int16_t>(static_cast<uint16_t>(v)));
}

// torch.div(a, d, rounding_mode="floor") for d > 0
__device__ __forceinline__ int floordiv_pos(int a, int d) {
  int q = a / d;
  if (a % d != 0 && a < 0) --q;
  return q;
}

// ops.trunc_div_pos: floor(abs(n) / d) with n's sign, where abs and the
// negation wrap as torch's int32 ops do (abs(INT32_MIN) == INT32_MIN)
__device__ __forceinline__ int trunc_div_pos(int n, int d) {
  const int q = floordiv_pos(n < 0 ? sub_w(0, n) : n, d);
  return n < 0 ? sub_w(0, q) : q;
}

// ops.rounded_div_pos (math.h:228-236), d > 0
__device__ __forceinline__ int rounded_div_pos(int n, int d) {
  const int half = d / 2;
  return trunc_div_pos(n < 0 ? sub_w(n, half) : add_w(n, half), d);
}

// ops.lerp_half: wrap16(trunc_div(round_out(a + b, 1), 2)) for int16
// a, b: (t + 1) / 2 truncates as (t + 1) >> 1 for t >= 0, and
// -((1 - t) / 2) truncated is t >> 1 for t < 0
__device__ __forceinline__ int lerp_half(int a, int b) {
  const int t = a + b;
  return wrap16((t + 1 + (t >> 31)) >> 1);
}

// ops.lerp_quarter: wrap16(trunc_div(round_out(3a + b, 2), 4)) for int16
// a, b: (t + 2) >> 2 for t >= 0 and (t + 1) >> 2 for t < 0
__device__ __forceinline__ int lerp_quarter(int a, int b) {
  const int t = 3 * a + b;
  return wrap16((t + 2 + (t >> 31)) >> 2);
}

// sample of an (h, w) plane, zero outside it (the anchor's zero padding)
template <typename T>
__device__ __forceinline__ int pix(const T* p, int h, int w, int y, int x) {
  return (y >= 0 && y < h && x >= 0 && x < w)
             ? static_cast<int>(p[static_cast<size_t>(y) * w + x])
             : 0;
}

// cp.async of 16 bytes, zero-filled where src_bytes is 0 (K5, K6)
__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// ---- waits across blocks of one persistent launch (K6 wave.cu, K7
// wavedec.cu): a poll reads with acquire semantics at GPU scope, sleeps
// between polls, and traps past SPIN_LIMIT polls (some seconds), so a
// deadlock is a launch error, not a hang

constexpr long long SPIN_LIMIT = 1ll << 25;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// ---- motion search (K5 inter.cu, K6 wave.cu)

// sub-pel direction d of motion.SP_DIRS (dy outer, dx inner, (0, 0)
// skipped)
__device__ __forceinline__ int dir_x(int d) { return (d + (d >= 4)) % 3 - 1; }
__device__ __forceinline__ int dir_y(int d) { return (d + (d >= 4)) / 3 - 1; }

// Column phase of a circular window (Windows<..., SLOTS>): the physical
// column of window column 0, luma and chroma. A window that is not
// circular ignores it.
struct Phase {
  int y = 0, c = 0;
};

// A macroblock's search windows in shared memory, int16: luma YW x YW
// with the macroblock's own position at (YOX, YOY), chroma CW x CW with
// it at (COX, COY). Pixel i of a 384-entry block is luma (16x16) for
// i < 256, then U, then V (8x8 each). Offsets clamp to the window, as the
// anchor's extract.extract_blocks clips. A circular window (SLOTS > 0)
// keeps its columns as a ring of SLOTS 16-column strips (chroma 8), window
// column x at physical column (x + phase) mod (16 SLOTS), so that a block
// walking a macroblock row replaces one strip per step instead of the
// whole window, and can fill the next strip while the current window is
// in use (K6).
template <int YW, int YOX, int YOY, int CW, int COX, int COY, int SLOTS = 0>
struct Windows {
  static constexpr int YS = SLOTS ? 16 * SLOTS : YW;   // row strides
  static constexpr int CS = SLOTS ? 8 * SLOTS : CW;
  int16_t y[YW * YS];
  int16_t u[CW * CS];
  int16_t v[CW * CS];

  // physical column of window column x (x + ph < 2 N) in a row of N
  template <int N>
  static __device__ __forceinline__ int col(int x, int ph) {
    if constexpr (SLOTS > 0) {
      x += ph;
      return x >= N ? x - N : x;
    } else {
      return x;
    }
  }

  // luma pixel i (0..255) of the block at full-pel offset (dx, dy) from
  // the macroblock
  __device__ __forceinline__ int luma(int dx, int dy, int i,
                                      Phase ph = {}) const {
    const int ox = clampi(dx + YOX, 0, YW - MB);
    const int oy = clampi(dy + YOY, 0, YW - MB);
    return y[(oy + (i >> 4)) * YS + col<YS>(ox + (i & 15), ph.y)];
  }

  // chroma pixel j (0..63) of the U (or V) block at (dx, dy)
  __device__ __forceinline__ int chroma(int dx, int dy, int j, bool is_v,
                                        Phase ph = {}) const {
    const int cx = clampi((dx >> 1) + COX, 0, CW - 8);
    const int cy = clampi((dy >> 1) + COY, 0, CW - 8);
    return (is_v ? v : u)[(cy + (j >> 3)) * CS + col<CS>(cx + (j & 7), ph.c)];
  }

  // pixel i of the 384-entry block at (dx, dy)
  __device__ __forceinline__ int at(int dx, int dy, int i,
                                    Phase ph = {}) const {
    return i < 256 ? luma(dx, dy, i, ph)
                   : chroma(dx, dy, (i - 256) & 63, i >= 320, ph);
  }

  // The pixels of the 3 x 3 candidates (ex + (k % 3 - 1) s, ey +
  // (k / 3 - 1) s), k < 9, that thread i of a 128-thread group owns: luma
  // pixels i and i + 128 (ya, yb) and chroma pixel i (c; U below 64, V
  // above). The candidates share three rows and three columns, so each
  // address is computed once. With s = 1 around the best block these are
  // the sub-pel neighbours: direction d is k = d + (d >= 4), the base k = 4.
  __device__ __forceinline__ void ring_px(int ex, int ey, int s, int i,
                                          Phase ph, int (&ya)[9],
                                          int (&yb)[9], int (&c)[9]) const {
    const int j = i & 63;
    int yr[3], yc[3], cr[3], cc[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int dx = ex + (a - 1) * s, dy = ey + (a - 1) * s;
      yc[a] = col<YS>(clampi(dx + YOX, 0, YW - MB) + (i & 15), ph.y);
      yr[a] = (clampi(dy + YOY, 0, YW - MB) + (i >> 4)) * YS;
      cc[a] = col<CS>(clampi((dx >> 1) + COX, 0, CW - 8) + (j & 7), ph.c);
      cr[a] = (clampi((dy >> 1) + COY, 0, CW - 8) + (j >> 3)) * CS;
    }
    const int16_t* cp = i < 64 ? u : v;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      ya[k] = y[yr[k / 3] + yc[k % 3]];
      yb[k] = y[yr[k / 3] + 8 * YS + yc[k % 3]];
      c[k] = cp[cr[k / 3] + cc[k % 3]];
    }
  }
};

// full-pel acceptance of a candidate against the best so far
// (motion.cpp:111-149; motion.accept_full), with the reference's
// C-precedence quirk: the SAD-tie term needs c_sad < SAD_THRESHOLD, and
// c_mad < mad_thr is OR-ed outside it. Written without branches: it sits
// on the serial fold of every search step.
__device__ __forceinline__ bool eval_accept(int sad, int mad, int ssd,
                                            int c_sad, int c_mad, int c_ssd,
                                            int mad_thr) {
  const bool by_mad = (c_mad < mad) | ((c_mad == mad) & (c_ssd < ssd));
  const bool by_sad = (c_sad < sad) |
                      ((c_sad == sad) & (c_ssd < ssd) &
                       (c_sad < SAD_THRESHOLD)) |
                      (c_mad < mad_thr);
  return mad < mad_thr ? by_mad : by_sad;
}

// sub-pel acceptance (motion.cpp:277-352; motion.accept_subpel)
__device__ __forceinline__ bool subpel_accept(int sad, int mad, int c_sad,
                                              int c_mad, int mad_thr) {
  const bool by_sad = ((c_sad < sad) & (c_sad < SAD_THRESHOLD)) |
                      (c_mad < mad_thr);
  return mad < mad_thr ? c_mad < mad : by_sad;
}

// the block at offset (dx, dy) from the macroblock at (px, py) lies
// inside the aligned (h, w) frame
__device__ __forceinline__ bool in_frame(int px, int py, int dx, int dy,
                                         int h, int w) {
  const int gx = px + dx, gy = py + dy;
  return gx >= 0 && gx <= w - MB && gy >= 0 && gy <= h - MB;
}

}  // namespace cairo
