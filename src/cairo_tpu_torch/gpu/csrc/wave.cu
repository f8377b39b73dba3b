// Wave-pass kernel for Hopper (sm_90a): K6.
//
// K6 wave_pass replaces cairo_tpu/tpu/pallas_wave.py wave_pass
// (_build_wave_kernel): the conformance encoder's sequential pass over the
// frame's macroblocks in raster order. Each MB runs, as the XLA wave body
// (wavefront.py:481-611) does:
//   * the causal intra search over the current frame's reconstruction:
//     the triangle ring (j in -32, -16, 0; i in -16, 0, 16) then rings of
//     step 8, 4, 2, 1 around the ring-entry best, from sad = sum |src|
//     and mad = ssd = INT32_MAX; a candidate counts only if cy <= py-16
//     or cx <= px-16 and it lies inside the frame; the acceptance keeps
//     the reference's C-precedence quirk (motion.cpp:111-149);
//   * sub-pel: 8 directions, half then quarter, with its own acceptance;
//   * the classify merge with K5's inter result (intra first, so a tie
//     keeps intra); INTRA_DEFAULT blocks predict from 0;
//   * fDCT -> variance -> adaptive QP -> quantise -> dequantise -> iDCT
//     with the reference's per-term truncation; a copy block's
//     reconstruction is its prediction;
//   * the reconstruction is written into the frame for later MBs.
//
// What bounds it on this card: the work is small (~62 candidate
// evaluations x 384 abs-diffs and ~6 x 1.5 k transform ops per MB, about
// 0.3 G ops and 51 MB per 1080p frame, some 15 us at the card's rates),
// but an MB reads the reconstruction of its raster predecessors, and the
// longest chain of dependent MBs from (0, 0) to (wb-1, hb-1) has
// wb + 3 (hb - 1) steps (321 at 1080p). The pass takes that chain times
// the latency of one MB step, a chain of dependent shared-memory reads,
// shuffles and barriers inside one block with no throughput to spare:
// every instruction on it shows.
//
// Design: one persistent launch. Each block takes the next MB row from an
// atomic ticket (rows are handed out in the order blocks arrive, so a
// block only ever waits on a row that a running block holds: no deadlock
// at any residency) and walks it left to right. MB (bi, bj) may start
// once row bj-1 has completed MB min(bi + RIGHT, wb-1), RIGHT = 2 the
// window's reach right of the MB in MBs (cuda_wave.LEAD): (bi+2, bj-1) is
// the last raster-earlier MB in the window [px-32, px+48) x [py-48, py+32)
// and every other one is done by transitivity, while row bj+1 has reached
// at most bi-3, so no raster-later MB of the window is written. This is
// the wave order w = bi + 3 bj turned into a wait. The window's reach
// (LEFT, RIGHT, UP, DOWN below) is the one constant the wait, the strip
// loader's schedule and the slot count derive from; cuda_wave checks it
// against WIN_X / WIN_Y (cairo_wave_geometry).
// Progress is published per row: the compute warps store the MB's
// reconstruction and meet at a barrier, then one thread __threadfence()s
// and stores the count atomically. Warp 7 alone reads the row above: it
// polls the count with an acquire load and __nanosleep backoff (a spin
// beyond a generous bound traps, so a deadlock is a launch error, not a
// hang) and copies each next 16-column window strip with cp.async, through
// L2 (L1 is not coherent across SMs), from an int16 working copy of the
// frame into one more slot of the block's circular int16 window
// (common.cuh Windows<..., SLOTS>), while the compute warps (0-6, their own
// named barrier) work on the current MB; a shared flag says which strips
// are in. So the wait and the strip's load leave the chain whenever the
// row above is ahead. The source block, self-SAD, K5's fields and the
// inter prediction of the next MB are prefetched with cp.async into a
// second buffer.
// The search runs in warps 0-3 with a named barrier once per step: thread
// i owns luma pixels i and i + 128 and chroma pixel i, a step's 9 (sub-pel
// 16) candidates share three window rows and columns (Windows::ring_px),
// each warp reduces them with warp-reduction instructions into partials
// (two buffers, alternating by step), and every thread folds the totals
// in the reference's order with branch-free acceptance rules, so no
// result is broadcast between steps (measured on this card: one warp
// alone, or shuffles instead of the reduction instructions, made the
// step longer). The transforms run one 8x8 block per warp (6 warps) with
// __syncwarp between passes, each lane holding its basis column and
// quantiser entries in registers; the quantiser divides through exact
// float reciprocals. Three barriers of the compute warps per MB remain
// (search done, variance, reconstruction stored), against some 30 in the
// launch-per-wave design this one replaced.

#include "common.cuh"

namespace {

using namespace cairo;

constexpr int THREADS = 256;
constexpr int TOP_Q = 31;                    // tables.MAX_QUANT_LEVELS - 1
constexpr int QSF = 16;                      // tables.QUANTIZER_SCALE_FACTOR
constexpr int NDESC = 11;
constexpr int NFIELD = 9;                    // cuda_inter.FIELDS
constexpr int NCONST = 256;  // basis, intra QM, inter QM, luma/chroma DC
constexpr int COMPUTE = 224;  // warps 0-6; warp 7 loads the strips

// The causal window's reach in MBs around the MB (cuda_wave.WIN_X,
// WIN_Y): luma [py - 16 UP, py + 16 (DOWN + 1)) x [px - 16 LEFT,
// px + 16 (RIGHT + 1)), chroma halved. RIGHT is the wait rule's lead. The
// window is SPAN strips of one MB column; strip c (MB column c) is first
// read by MB c - RIGHT and last by MB c + LEFT, and the loader fills one
// slot beyond the SPAN in use.
constexpr int LEFT = 2, RIGHT = 2, UP = 3, DOWN = 1;
constexpr int SPAN = LEFT + 1 + RIGHT;
constexpr int SLOTS = SPAN + 1;
static_assert(UP + 1 + DOWN == SPAN, "Windows holds square windows");
using Win = Windows<MB * SPAN, MB * LEFT, MB * UP, MB / 2 * SPAN,
                    MB / 2 * LEFT, MB / 2 * UP, SLOTS>;

// the ring slot of strip c (c >= -LEFT)
__device__ __forceinline__ int slot_of(int c) { return (c + LEFT) % SLOTS; }

// what one MB reads that does not depend on the frame's reconstruction
struct Pre {
  int src[384];    // Y 16x16, U 8x8, V 8x8
  int pred[384];   // the inter prediction (inter frames)
  int f[12];       // self_sad, then K5's nine fields
};

struct Smem {
  Win win;
  __align__(16) Pre pre[2];
  __align__(16) int part[2][2 * 16 * 4];  // the search's partials
  int sel[9];      // the search's result, for all warps
  __align__(16) int a[384];   // transform buffers, 8x8 block b at 64 b
  __align__(16) int b[384];
  int k[NCONST];
  int var[4][3];
  int row;
  volatile int strip_ready;   // the last window column loaded (warp 7)
  volatile int mb_done;       // MBs of the row completed (compute warps)
};

// index into the 384-entry MB block of pixel (r, c) of 8x8 block b (0-3
// luma quadrants TL, TR, BL, BR; 4 U; 5 V)
__device__ __forceinline__ int idx8(int b, int r, int c) {
  return b < 4 ? ((b >> 1) * 8 + r) * 16 + (b & 1) * 8 + c
               : 256 + (b - 4) * 64 + r * 8 + c;
}

// a candidate at offset (dx, dy) counts iff causal and inside the frame
__device__ __forceinline__ bool causal_ok(int px, int py, int dx, int dy,
                                          int h, int w) {
  return (dy <= -MB || dx <= -MB) && in_frame(px, py, dx, dy, h, w);
}

// ops.rounded_div_pos(n, d) for |n| < 2^20 and 0 < d < 2^16, given
// rd = 1/d rounded: the float quotient is within 1/8 of the true one, so
// one correction step makes the truncated quotient exact. A division by a
// runtime divisor is the slowest step of the quantiser's chain.
__device__ __forceinline__ int rounded_div_small(int n, int d, float rd) {
  const int a = n < 0 ? d / 2 - n : n + d / 2;   // |n| + d/2
  int q = __float2int_rz(__int2float_rn(a) * rd);
  const int r = a - q * d;
  q += (r >= d) - (r < 0);
  return n < 0 ? -q : q;
}

__device__ __forceinline__ int ilog2_u32(int v) {
  const unsigned u = static_cast<unsigned>(v);
  return u == 0 ? 0 : 31 - __clz(u);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(d), "l"(src) : "memory");
}

// lane 0 of the calling warp waits until *progress >= need; then the
// whole warp may read what the rows above published
__device__ __forceinline__ void wait_progress(const int* progress,
                                              int need) {
  if ((threadIdx.x & 31) == 0) {
    unsigned ns = 32;
    long long spins = 0;
    while (ld_acquire(progress) < need) {
      __nanosleep(ns);
      ns = ns < 128 ? ns * 2 : ns;
      if (++spins > SPIN_LIMIT) __trap();
    }
  }
  __syncwarp();
}

// the calling warp's lane 0 waits until the shared flag reaches need
__device__ __forceinline__ void wait_flag(const volatile int* flag, int need,
                                          unsigned sleep_ns) {
  if ((threadIdx.x & 31) == 0) {
    long long spins = 0;
    while (*flag < need) {
      if (sleep_ns) __nanosleep(sleep_ns);
      if (++spins > SPIN_LIMIT) __trap();
    }
  }
  __syncwarp();
  __threadfence_block();
}

// the compute warps' barrier (warp 7 never joins it)
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 2, %0;" :: "n"(COMPUTE) : "memory");
}

// cp.async by one warp of the window strip of MB column c from the int16
// working frame, through L2, into its ring slot: luma rows
// [py - 16 UP, py + 16 (DOWN + 1)) x [16c, 16c+16), chroma halved; zero
// outside the planes
__device__ __forceinline__ void load_strip(Win& win, const int16_t* wy,
                                           const int16_t* wu,
                                           const int16_t* wv, int h, int w,
                                           int py, int c) {
  constexpr int YROWS = MB * SPAN, CROWS = MB / 2 * SPAN;
  const int slot = slot_of(c);
  for (int j = threadIdx.x & 31; j < 2 * YROWS + 2 * CROWS; j += 32) {
    const int16_t* src;
    int16_t* dst;
    bool in;
    if (j < 2 * YROWS) {    // luma: rows of two 8-pixel chunks
      const int r = j >> 1, x = 16 * c + 8 * (j & 1), y = py - MB * UP + r;
      in = y >= 0 && y < h && x >= 0 && x < w;
      src = wy + (in ? static_cast<size_t>(y) * w + x : 0);
      dst = win.y + r * Win::YS + 16 * slot + 8 * (j & 1);
    } else {          // chroma: rows of one chunk, U then V
      const int k = j - 2 * YROWS, is_v = k >= CROWS, r = k % CROWS;
      const int x = 8 * c, y = py / 2 - MB / 2 * UP + r;
      in = y >= 0 && y < h / 2 && x >= 0 && x < w / 2;
      src = (is_v ? wv : wu) +
            (in ? static_cast<size_t>(y) * (w / 2) + x : 0);
      dst = (is_v ? win.v : win.u) + r * Win::CS + 8 * slot;
    }
    cp_async16z(dst, src, in ? 16 : 0);
  }
}

// Warp 7's loop: the first MB's strips, then each next strip c as soon as
// its slot is free (the old strip's last reader, MB c - SLOTS + LEFT, is
// done) and the row above allows it (the wait rule of its first reader,
// MB c - RIGHT); strip_ready announces each.
__device__ __forceinline__ void loader(Smem& s, const int16_t* wy,
                                       const int16_t* wu, const int16_t* wv,
                                       const int* progress, int h, int w,
                                       int bj) {
  const int wb = w / MB, py = bj * MB;
  for (int c = -LEFT; c < wb + RIGHT; ++c) {
    if (c - SLOTS + LEFT >= 0)
      wait_flag(&s.mb_done, c - SLOTS + LEFT + 1, 64);
    if (bj > 0 && c >= 0)
      wait_progress(progress + bj - 1,
                    min(max(c - RIGHT, 0) + RIGHT, wb - 1) + 1);
    load_strip(s.win, wy, wu, wv, h, w, py, c);
    if (c >= RIGHT) {
      cp_async_wait_all();
      __syncwarp();
      if ((threadIdx.x & 31) == 0) {
        __threadfence_block();
        s.strip_ready = c;
      }
    }
  }
}

// cp.async of what MB m reads besides the frame: source blocks, self-SAD
// and, on inter frames, K5's fields and the inter prediction
__device__ __forceinline__ void prefetch(Pre& p, int m, int nmb,
                                         int is_inter, const int* src_y,
                                         const int* src_u, const int* src_v,
                                         const int* self_sad,
                                         const int* inter, const int* pred_y,
                                         const int* pred_u,
                                         const int* pred_v) {
  const int t = threadIdx.x;
  if (t < 96) {   // 16-byte chunks: 64 luma, 16 U, 16 V
    const int* s = t < 64 ? src_y + static_cast<size_t>(m) * 256 + 4 * t
                          : (t < 80 ? src_u : src_v) +
                                static_cast<size_t>(m) * 64 + 4 * ((t - 64) & 15);
    cp_async16(p.src + 4 * t, s);
  } else if (t < 192) {
    if (is_inter) {
      const int u = t - 96;
      const int* s = u < 64 ? pred_y + static_cast<size_t>(m) * 256 + 4 * u
                            : (u < 80 ? pred_u : pred_v) +
                                  static_cast<size_t>(m) * 64 + 4 * ((u - 64) & 15);
      cp_async16(p.pred + 4 * u, s);
    }
  } else if (t == 192) {
    cp_async4(p.f, self_sad + m);
  } else if (t < 193 + NFIELD && is_inter) {
    const int i = t - 193;
    cp_async4(p.f + 1 + i, inter + static_cast<size_t>(i) * nmb + m);
  }
}

// the search's 128 threads (warps 0-3) meet at named barrier 1, so the
// other warps are never held
__device__ __forceinline__ void search_sync() {
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

// K candidates' SAD and MAD over the search group: each warp's partials by
// warp reductions into part (sad of k at part[4k + warp], mad at
// part[4 (K + k) + warp]), the group barrier, then lane k < K of every
// warp returns candidate k's totals. part alternates between two buffers
// from step to step, so no warp's next partials overtake another's reads.
template <int K>
__device__ __forceinline__ void group_totals(const int (&sad)[K],
                                             const int (&mad)[K], int* part,
                                             int& c_sad, int& c_mad) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const unsigned s = __reduce_add_sync(FULL, static_cast<unsigned>(sad[k]));
    const int m = __reduce_max_sync(FULL, mad[k]);
    if (lane == 0) {
      part[4 * k + warp] = static_cast<int>(s);
      part[4 * (K + k) + warp] = m;
    }
  }
  search_sync();
  c_sad = c_mad = 0;
  if (lane < K) {
    const int4 a = reinterpret_cast<const int4*>(part)[lane];
    const int4 b = reinterpret_cast<const int4*>(part)[K + lane];
    c_sad = a.x + a.y + a.z + a.w;
    c_mad = max(max(b.x, b.y), max(b.z, b.w));
  }
}

// The MB's causal intra search, sub-pel step and merge with K5's result,
// run by warps 0-3 (thread i owns luma pixels i and i + 128 and chroma
// pixel i). A step's 9 (sub-pel 16) candidates are reduced together, and
// every thread folds the totals in the reference's order, so no result is
// broadcast between steps. Thread 0 stores the merged descriptor fields
// (is_intra, is_motion, is_copy, target, mx, my, spp, spa, spi) in sel.
__device__ __forceinline__ void search(const Win& win, Phase ph,
                                       const Pre& pre, int px, int py, int h,
                                       int w, int mad_thr, int is_inter,
                                       int (*part)[2 * 16 * 4], int* sel) {
  const int i = threadIdx.x;
  const int s0 = pre.src[i], s1 = pre.src[i + 128], sc = pre.src[256 + i];

  // full-pel: the triangle ring (base (0, -16), step 16), then rings of
  // step 8, 4, 2, 1 around the ring-entry best
  int bx = 0, by = 0, sad = pre.f[0], mad = INT32_MAX_, ssd = INT32_MAX_;
#pragma unroll 1
  for (int ring = 0; ring < 5; ++ring) {
    const int step = 16 >> ring;
    const int ex = ring ? bx : 0, ey = ring ? by : -16;
    int ya[9], yb[9], c[9], vs[9], vm[9];
    win.ring_px(ex, ey, step, i, ph, ya, yb, c);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int da = abs(s0 - ya[k]), db = abs(s1 - yb[k]);
      vs[k] = da + db;
      vm[k] = max(max(da, db), abs(sc - c[k]));
    }
    int t_sad, t_mad;
    group_totals<9>(vs, vm, part[ring & 1], t_sad, t_mad);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int c_sad = __shfl_sync(FULL, t_sad, k);
      const int c_mad = __shfl_sync(FULL, t_mad, k);
      const int dx = ex + (k % 3 - 1) * step, dy = ey + (k / 3 - 1) * step;
      const int c_ssd = dx * dx + dy * dy;
      const bool take = causal_ok(px, py, dx, dy, h, w) &
                        eval_accept(sad, mad, ssd, c_sad, c_mad, c_ssd,
                                    mad_thr);
      bx = take ? dx : bx;
      by = take ? dy : by;
      sad = take ? c_sad : sad;
      mad = take ? c_mad : mad;
      ssd = take ? c_ssd : ssd;
    }
  }

  // sub-pel: candidate 2d the half-pel, 2d+1 the quarter-pel blend of the
  // best block with its neighbour in direction d
  int spp = 0, spa = 0, spi = 0;
  {
    int ya[9], yb[9], c[9], vs[16], vm[16];
    win.ring_px(bx, by, 1, i, ph, ya, yb, c);
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const int k = d + (d >= 4);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int da = abs(s0 - (q ? lerp_quarter(ya[4], ya[k])
                                   : lerp_half(ya[4], ya[k])));
        const int db = abs(s1 - (q ? lerp_quarter(yb[4], yb[k])
                                   : lerp_half(yb[4], yb[k])));
        const int dc = abs(sc - (q ? lerp_quarter(c[4], c[k])
                                   : lerp_half(c[4], c[k])));
        vs[2 * d + q] = da + db;
        vm[2 * d + q] = max(max(da, db), dc);
      }
    }
    int t_sad, t_mad;
    group_totals<16>(vs, vm, part[1], t_sad, t_mad);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int c_sad = __shfl_sync(FULL, t_sad, k);
      const int c_mad = __shfl_sync(FULL, t_mad, k);
      const int d = k >> 1;
      const bool take = causal_ok(px, py, bx + dir_x(d), by + dir_y(d), h, w) &
                        subpel_accept(sad, mad, c_sad, c_mad, mad_thr);
      spp = take ? 1 : spp;
      spa = take ? (k & 1) : spa;
      spi = take ? d : spi;
      sad = take ? c_sad : sad;
      mad = take ? c_mad : mad;
    }
  }

  // the merge with the inter result (a tie keeps intra); inter fields:
  // sad, is_copy, is_motion, target, mx, my, spp, spa, spi
  if (i == 0) {
    int f[9] = {1, (bx != 0 || by != 0 || spp) ? 1 : 0,
                mad < mad_thr ? 1 : 0, 0, bx, by, spp, spa, spi};
    if (is_inter) {
      const int i_sad = pre.f[1], i_copy = pre.f[2];
      const bool take = i_copy != f[2] ? i_copy != 0 : i_sad < sad;
      if (take) {
        f[0] = 0;
        f[1] = pre.f[3];
        f[2] = i_copy;
#pragma unroll
        for (int k = 3; k < 9; ++k) f[k] = pre.f[1 + k];
      }
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) sel[k] = f[k];
  }
}

__global__ void __launch_bounds__(THREADS, 1)
wave_kernel(const int* __restrict__ src_y, const int* __restrict__ src_u,
            const int* __restrict__ src_v, const int* __restrict__ self_sad,
            const int* __restrict__ inter, const int* __restrict__ pred_y,
            const int* __restrict__ pred_u, const int* __restrict__ pred_v,
            int* rec_y, int* rec_u, int* rec_v, int16_t* work_y,
            int16_t* work_u, int16_t* work_v,
            const int* __restrict__ quality_p,
            const int* __restrict__ consts, int h, int w, int is_inter,
            int* sync, int* __restrict__ desc,
            int16_t* __restrict__ coef_y, int16_t* __restrict__ coef_u,
            int16_t* __restrict__ coef_v) {
  __shared__ Smem s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wb = w / MB, hb = h / MB;
  const int nmb = hb * wb;
  const int cw = w / 2;
  int* progress = sync + 1;   // MBs completed per row

  if (t == 0) {
    s.row = atomicAdd(sync, 1);
    s.strip_ready = -LEFT - 1;
    s.mb_done = 0;
  }
  s.k[t] = consts[t];
  __syncthreads();   // the last barrier of all 256 threads
  const int bj = s.row;
  if (bj >= hb) return;
  const int py = bj * MB;
  if (warp == 7) {
    loader(s, work_y, work_u, work_v, progress, h, w, bj);
    return;
  }
  const int quality = *quality_p;
  const int mad_thr = (quality >> 2) + 1;
  const int* iqm = s.k + 64;
  const int* pqm = s.k + 128;
  const int* ldc = s.k + 192;
  const int* cdc = s.k + 224;
  // this lane's quantiser matrix entries (row lane & 7, columns
  // lane >> 3 and that + 4) with their reciprocals
  int iq[2], pq[2];
  float riq[2], rpq[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    iq[h2] = iqm[(lane & 7) * 8 + (lane >> 3) + 4 * h2];
    pq[h2] = pqm[(lane & 7) * 8 + (lane >> 3) + 4 * h2];
    riq[h2] = __frcp_rn(static_cast<float>(iq[h2]));
    rpq[h2] = __frcp_rn(static_cast<float>(pq[h2]));
  }
  // and its basis column k = lane & 7, forward and inverse
  int fb[8], ib[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    fb[j] = s.k[(lane & 7) * 8 + j];
    ib[j] = s.k[j * 8 + (lane & 7)];
  }

  prefetch(s.pre[0], bj * wb, nmb, is_inter, src_y, src_u, src_v, self_sad,
           inter, pred_y, pred_u, pred_v);
  cp_async_wait_all();
  compute_sync();
  for (int bi = 0; bi < wb; ++bi) {
    const int m = bj * wb + bi;
    const int px = bi * MB;
    const Pre& pre = s.pre[bi & 1];
    const int slot0 = slot_of(bi - LEFT);   // of window column 0
    const Phase ph{16 * slot0, 8 * slot0};
    if (bi + 1 < wb)   // its buffer's last reader, MB bi - 1, is done
      prefetch(s.pre[(bi + 1) & 1], m + 1, nmb, is_inter, src_y, src_u,
               src_v, self_sad, inter, pred_y, pred_u, pred_v);

    // ---- the window's new strip (warp 7 loads it when the row above
    // allows), then the search (warps 0-3)
    if (warp < 4) {
      wait_flag(&s.strip_ready, bi + RIGHT, 0);
      search(s.win, ph, pre, px, py, h, w, mad_thr, is_inter, s.part, s.sel);
    }
    compute_sync();  // S: the MB's descriptor is in s.sel
    int f[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) f[i] = s.sel[i];
    const int is_intra = f[0], is_copy = f[2];
    const bool intra_default = is_intra && !f[1];

    // ---- per warp, one 8x8 block: prediction, residual, forward DCT
    // lane: column k = lane & 7 of rows r0 and r0 + 4
    const int blk = warp, kk = lane & 7, r0 = lane >> 3;
    int* A = s.a + 64 * blk;
    int* B = s.b + 64 * blk;
    int p0 = 0, p1 = 0, v0 = 0, v1 = 0;
    if (blk < 6) {
      int pv[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int i = idx8(blk, r0 + 4 * h2, kk);
        int p = 0;
        if (!intra_default) {
          if (is_intra) {
            p = s.win.at(f[4], f[5], i, ph);
            if (f[6]) {
              const int tv = s.win.at(f[4] + dir_x(f[8]), f[5] + dir_y(f[8]),
                                      i, ph);
              p = f[7] ? lerp_quarter(p, tv) : lerp_half(p, tv);
            }
          } else {
            p = pre.pred[i];
          }
        }
        pv[h2] = p;
        A[(r0 + 4 * h2) * 8 + kk] = wrap16(pre.src[i] - p);
      }
      p0 = pv[0];
      p1 = pv[1];
      __syncwarp();
      // rows: out[r][k] = sum_j basis[k][j] in[r][j]
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = r0 + 4 * h2;
        int acc = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc += fb[j] * A[r * 8 + j];
        const int v = kk == 0 ? trunc_div_pos(acc * 45, 128)
                              : trunc_div_pos(acc, 2);
        B[r * 8 + kk] = wrap16(rounded_div_pos(v, 128));
      }
      __syncwarp();
      // columns: out[k][r] = sum_j basis[k][j] in[j][r]; this lane keeps
      // coefficients (row kk, columns r0 and r0 + 4)
      int cv[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = r0 + 4 * h2;
        int acc = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc += fb[j] * B[j * 8 + r];
        const int v = kk == 0 ? trunc_div_pos(acc * 45, 128)
                              : trunc_div_pos(acc, 2);
        cv[h2] = wrap16(rounded_div_pos(v, 128));
      }
      v0 = cv[0];
      v1 = cv[1];
      // ---- variance partials (ops.block_variance2, int32 wrap) over the
      // luma coefficients but the MB's first
      if (blk < 4) {
        unsigned sums[3] = {0, 0, 0};
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int v = h2 ? v1 : v0;
          const bool first = blk == 0 && kk == 0 && r0 + 4 * h2 == 0;
          if (v != 0 && !first) {
            sums[0] += 1;
            sums[1] += static_cast<unsigned>(v);
            sums[2] += static_cast<unsigned>(mul_w(v, v));
          }
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const unsigned tot = __reduce_add_sync(FULL, sums[q]);
          if (lane == 0) s.var[blk][q] = static_cast<int>(tot);
        }
      }
    }
    compute_sync();  // variance partials
    unsigned tot[3] = {0, 0, 0};
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int b4 = 0; b4 < 4; ++b4)
        tot[q] += static_cast<unsigned>(s.var[b4][q]);
    const int count = static_cast<int>(tot[0]), sum = static_cast<int>(tot[1]);
    const int sumsq = static_cast<int>(tot[2]);
    const int cnt = max(count, 1);
    const int var = count > 0
        ? sub_w(sumsq, trunc_div_pos(add_w(mul_w(sum, sum), cnt / 2), cnt))
        : 0;
    const int index = clampi(ilog2_u32(var) >> 1, 1, TOP_Q);
    const int qp = index > quality
        ? clampi(quality + ((index - quality) >> 1), 1, TOP_Q)
        : (index < quality
               ? clampi(quality - ((quality - index) >> 1), 1, TOP_Q)
               : quality);
    if (t == 0) {
      const int d[NDESC] = {f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7],
                            f[8], qp, wrap16(var)};
#pragma unroll
      for (int i = 0; i < NDESC; ++i)
        desc[static_cast<size_t>(i) * nmb + m] = d[i];
    }

    if (blk < 6) {
      // ---- quantise this lane's coefficients (row kk, columns r0, r0+4),
      // write them, dequantise into B (every numerator below is under 2^20:
      // v is int16-wrapped)
      const bool luma = blk < 4;
      const int q2 = qp << 1;
      const float rq2 = __frcp_rn(static_cast<float>(q2));
      const int dcs = luma ? ldc[qp] : cdc[qp];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = kk, c = r0 + 4 * h2;
        const int v = h2 ? v1 : v0;
        const bool dc = r == 0 && c == 0;
        int q, dq;
        if (intra_default) {
          const int qm = iq[h2];
          q = dc ? wrap16(rounded_div_pos(v, dcs))
                 : wrap16(rounded_div_small(
                       rounded_div_small(v * QSF, qm, riq[h2]), q2, rq2));
          dq = dc ? wrap16(q * dcs)
                  : wrap16(trunc_div_pos(2 * q * qm * qp, QSF));
        } else {
          const int qm = pq[h2];
          const int qf = wrap16(rounded_div_small(v * QSF, qm, rpq[h2]));
          const int sg = (qf > 0) - (qf < 0);
          q = wrap16(rounded_div_small(qf - sg * qp, q2, rq2));
          dq = wrap16(trunc_div_pos(2 * q * qm * qp, QSF));
        }
        const int i = idx8(blk, r, c);
        const int16_t q16 = static_cast<int16_t>(q);
        if (luma) coef_y[static_cast<size_t>(m) * 256 + i] = q16;
        else if (blk == 4) coef_u[static_cast<size_t>(m) * 64 + i - 256] = q16;
        else coef_v[static_cast<size_t>(m) * 64 + i - 320] = q16;
        B[r * 8 + c] = dq;
      }
      __syncwarp();
      // ---- inverse DCT (per-term truncation, transform.cpp:330-349):
      // columns, out[k][r] = sum_j in[j][r] basis[j][k]
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = r0 + 4 * h2;
        int total = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int term = B[j * 8 + r] * ib[j];
          total += j == 0 ? trunc_div_pos(term * 45, 128)
                          : trunc_div_pos(term, 2);
        }
        A[kk * 8 + r] = wrap16(rounded_div_pos(total, 128));
      }
      __syncwarp();
      // rows, out[r][k] = sum_j in[r][j] basis[j][k]: this lane's pixels
      // (r0, kk) and (r0 + 4, kk), whose predictions it holds
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = r0 + 4 * h2;
        int total = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int term = A[r * 8 + j] * ib[j];
          total += j == 0 ? trunc_div_pos(term * 45, 128)
                          : trunc_div_pos(term, 2);
        }
        const int p = h2 ? p1 : p0;
        const int v = is_copy ? p : wrap16(wrap16(rounded_div_pos(total, 128))
                                           + p);
        // ---- the reconstruction, into the frame and the window
        const int16_t v16 = static_cast<int16_t>(v);
        if (blk < 4) {
          const int yy = (blk >> 1) * 8 + r, xx = (blk & 1) * 8 + kk;
          const size_t o = static_cast<size_t>(py + yy) * w + px + xx;
          rec_y[o] = v;
          work_y[o] = v16;
          s.win.y[(MB * UP + yy) * Win::YS +
                  Win::col<Win::YS>(MB * LEFT + xx, ph.y)] = v16;
        } else {
          const size_t o = static_cast<size_t>(py / 2 + r) * cw + px / 2 + kk;
          (blk == 4 ? rec_u : rec_v)[o] = v;
          (blk == 4 ? work_u : work_v)[o] = v16;
          (blk == 4 ? s.win.u : s.win.v)[
              (MB / 2 * UP + r) * Win::CS +
              Win::col<Win::CS>(MB / 2 * LEFT + kk, ph.c)] = v16;
        }
      }
    }
    cp_async_wait_all();   // the next MB's prefetch
    compute_sync();  // C: the MB's reconstruction is stored
    if (t == 0) s.mb_done = bi + 1;   // its window strips may be reused
    if (t == 192) {   // warp 6, so that warp 0's search starts at once
      __threadfence();
      atomicExch(progress + bj, bi + 1);
    }
  }
}

}  // namespace

// One persistent launch for the whole pass: hb blocks, each taking MB
// rows from the ticket in sync[0] and publishing its progress in
// sync[1 + row]; `sync` (1 + hb int32) must be zero at launch. rec_*: int32
// planes and work_*: int16 planes, both holding the current ring slot at
// launch and updated in place (the kernel reads the frame from work_*).
// desc: (11, N) int32 rows is_intra, is_motion, is_copy, target,
// motion_x, motion_y, sp_pred, sp_amount, sp_index, q_index, variance.
// inter: (9, N) int32 (cuda_inter.FIELDS rows) and pred_*: int32 blocks,
// read only when is_inter. Returns the launch's CUDA error.
extern "C" int cairo_wave_pass(const void* src_y, const void* src_u,
                               const void* src_v, const void* self_sad,
                               const void* inter, const void* pred_y,
                               const void* pred_u, const void* pred_v,
                               void* rec_y, void* rec_u, void* rec_v,
                               void* work_y, void* work_u, void* work_v,
                               const void* quality, const void* consts,
                               int h, int w, int is_inter, void* sync, void* desc, void* coef_y,
                               void* coef_u, void* coef_v, void* stream) {
  wave_kernel<<<h / MB, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src_y), static_cast<const int*>(src_u),
      static_cast<const int*>(src_v), static_cast<const int*>(self_sad),
      static_cast<const int*>(inter), static_cast<const int*>(pred_y),
      static_cast<const int*>(pred_u), static_cast<const int*>(pred_v),
      static_cast<int*>(rec_y), static_cast<int*>(rec_u),
      static_cast<int*>(rec_v), static_cast<int16_t*>(work_y),
      static_cast<int16_t*>(work_u), static_cast<int16_t*>(work_v),
      static_cast<const int*>(quality), static_cast<const int*>(consts), h,
      w, is_inter, static_cast<int*>(sync), static_cast<int*>(desc),
      static_cast<int16_t*>(coef_y), static_cast<int16_t*>(coef_u),
      static_cast<int16_t*>(coef_v));
  return static_cast<int>(cudaGetLastError());
}

// The window's reach in MBs, {LEFT, RIGHT, UP, DOWN}, for cuda_wave to
// check against WIN_X / WIN_Y and LEAD. Returns 0.
extern "C" int cairo_wave_geometry(int* out) {
  out[0] = LEFT;
  out[1] = RIGHT;
  out[2] = UP;
  out[3] = DOWN;
  return 0;
}
