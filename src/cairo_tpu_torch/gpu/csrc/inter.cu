// Exact inter search kernel for Hopper (sm_90a): K5.
//
// K5 inter_search replaces cairo_tpu/tpu/pallas_inter.py inter_search
// (_build_kernel): the conformance encoder's replay of the reference's
// inter search (motion.cpp:421-494) for every macroblock against the ring
// slots at offsets 1 .. RING-1 from the current frame, folded across
// them by the classify merge (encode.cpp:29-54). Per reference, in the
// anchor's order (motion.inter_search_exact):
//   * the co-located candidate; MAD below the threshold freezes the MB
//     (no candidate is accepted afterwards);
//   * rings of 9 candidates at steps 16, 8, 4, 2, 1 around the best at
//     ring entry, scanned j outer, i inner, with strict comparisons; the
//     first ring's centre can reset the SSD from INT32_MAX on a tie;
//   * 8 directions, half then quarter sub-pel, against the final best.
// The per-reference winners merge in offset order: copy status dominates,
// then strictly lower SAD; ties keep the earlier reference.
//
// What bounds it on this card is integer work: per MB and reference the
// co-located candidate and, unless it freezes the MB, 5 rings of 8
// candidates besides the centre (the centre is the ring-entry best, whose
// SAD and MAD the search already holds) and 16 sub-pel blends, 57 x 384
// abs-diffs: about 0.54 G per 1080p call with no MB frozen (0.58 G with
// the centres recomputed), 16 us at one simple integer op per lane per
// clock, against some 32 MB of traffic. The 24,480 searches of a 1080p
// call are independent, so what counts is throughput across warps, not
// the latency of one search.
//
// Design: one warp per (macroblock, reference) search, with no barrier
// inside it; a frozen MB's warp stops after the co-located candidate, as
// it accepts nothing further. A block takes a run of RUN macroblocks of
// one MB row and all three references (3 RUN warps, two blocks an SM)
// and stages, per reference, the union of the run's windows once: luma
// rows [py - 32, py + 48) x columns [px0 - 32, px_last + 48), chroma
// halved, int16, with 16-byte cp.async (zero-filled outside the planes,
// the anchor's padding; px0 - 32 is a multiple of 16 and the width a
// multiple of 16, so a copied chunk lies wholly inside or outside a
// plane). Neighbouring MBs' windows overlap by 80 %, so this stages 23 KB
// per MB instead of the 57.6 KB of one window set per MB and reference.
// Every candidate lies within +-32 of the MB (16+8+4+2+1 and one sub-pel
// step), so it stays inside the MB's 80 x 80 part of the strip and the
// anchor's clamp to the window never acts (tests/test_torch_search_layout.py
// walks every path).
// Lane l owns luma pixels (4 (l >> 4) + (k & 3) + 8 (k >> 2), l & 15),
// k < 8, and chroma pixels (l >> 3 + 4 k, l & 7), k < 2, of U and V; its
// source pixels sit in registers. A candidate's 12 pixels are read at
// immediate offsets from two addresses (luma, chroma), and the row
// strides put the lanes of one load on distinct banks. SAD and MAD are
// warp reductions (__reduce_add_sync / __reduce_max_sync), and every lane
// folds the candidates in scan order with the branch-free acceptance
// rules of common.cuh (the rule is not associative, so the fold stays
// sequential), so the next ring's base needs no broadcast. After one
// barrier, thread m of the block merges macroblock m's three winners in
// offset order and writes its nine fields.
// On NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, 1080p, a third of the
// searches frozen): 0.145 ms of device time, against 0.92 ms for the
// design this one replaced (one 256-thread block per MB, thread 0
// folding, some 22 barriers per reference); 80 registers, no spill.
// clock64 stamps put about half of a block's time in staging and its
// wait, so staging, not the search, is what remains.

#include "common.cuh"

namespace {

using namespace cairo;

constexpr int RUN = 4;                    // macroblocks per block
constexpr int NREF = RING - 1;            // reference offsets 1..3
constexpr int THREADS = 32 * RUN * NREF;  // one warp per (MB, reference)
constexpr int NFIELDS = 9;
constexpr int REACH = 32;                 // 16+8+4+2+1, one sub-pel step
constexpr int CREACH = REACH / 2;

// luma strip: rows [py - REACH, py + MB + REACH), columns
// [px0 - REACH, px0 + MB RUN + REACH); a row stride of 68 words keeps
// rows 16-byte aligned and puts rows 4 apart (a load's two half-warps)
// 16 banks apart
constexpr int YROWS = MB + 2 * REACH;             // 80
constexpr int YCOLS = MB * RUN + 2 * REACH;       // 128
constexpr int YS = YCOLS + 8;                     // 136
// chroma strips, U then V: a row stride of 40 words puts a load's four
// rows 8 banks apart
constexpr int CROWS = MB / 2 + 2 * CREACH;        // 40
constexpr int CCOLS = MB / 2 * RUN + 2 * CREACH;  // 64
constexpr int CS = CCOLS + 16;                    // 80
static_assert(YS % 8 == 0 && (YS / 2 * 4) % 32 == 16, "luma row stride");
static_assert(CS % 8 == 0 && (CS / 2) % 32 == 8, "chroma row stride");

struct Strip {
  int16_t y[YROWS * YS];
  int16_t c[2 * CROWS * CS];
};

struct Smem {
  Strip ref[NREF];
  int res[NREF][RUN][NFIELDS];
};

// cp.async of one reference's strips for the run whose first MB is at
// (px0, py), in chunks of 8 samples (16 bytes)
__device__ __forceinline__ void stage(Strip& s, const int16_t* ry,
                                      const int16_t* ru, const int16_t* rv,
                                      int h, int w, int px0, int py) {
  constexpr int YCHUNKS = YROWS * YCOLS / 8;
  for (int i = threadIdx.x; i < YCHUNKS; i += THREADS) {
    const int row = i / (YCOLS / 8), col = 8 * (i % (YCOLS / 8));
    const int gy = py - REACH + row, gx = px0 - REACH + col;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const int16_t* src = in ? ry + static_cast<size_t>(gy) * w + gx : ry;
    cp_async16z(&s.y[row * YS + col], src, in ? 16 : 0);
  }
  constexpr int CCHUNKS = CROWS * CCOLS / 8;
  const int ch = h / 2, cw = w / 2;
  for (int i = threadIdx.x; i < 2 * CCHUNKS; i += THREADS) {
    const int p = i / CCHUNKS, j = i % CCHUNKS;
    const int row = j / (CCOLS / 8), col = 8 * (j % (CCOLS / 8));
    const int gy = py / 2 - CREACH + row, gx = px0 / 2 - CREACH + col;
    const bool in = gy >= 0 && gy < ch && gx >= 0 && gx < cw;
    const int16_t* plane = p ? rv : ru;
    const int16_t* src =
        in ? plane + static_cast<size_t>(gy) * cw + gx : plane;
    cp_async16z(&s.c[(p * CROWS + row) * CS + col], src, in ? 16 : 0);
  }
}

// row of the lane's luma pixel k below its pixel k = 0
__host__ __device__ constexpr int yrow(int k) {
  return (k & 3) + 8 * (k >> 2);
}

// The lane's part of one candidate: y points at its luma pixel k = 0 of
// the candidate, c at its U pixel k = 0; sy / sc its source pixels.
// Returns the candidate's SAD (luma) and MAD (Y, U, V) over the warp.
__device__ __forceinline__ void metrics(const int (&sy)[8],
                                        const int (&sc)[4],
                                        const int16_t* y, const int16_t* c,
                                        int& sad, int& mad) {
  int s = 0, m = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int d = abs(sy[k] - y[yrow(k) * YS]);
    s += d;
    m = max(m, d);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    m = max(m, abs(sc[k] - c[(k >> 1) * CROWS * CS + (k & 1) * 4 * CS]));
  sad = static_cast<int>(__reduce_add_sync(FULL, static_cast<unsigned>(s)));
  mad = __reduce_max_sync(FULL, m);
}

// the lane's 12 pixels of the block at (y, c) (as for metrics)
__device__ __forceinline__ void pixels(const int16_t* y, const int16_t* c,
                                       int (&py)[8], int (&pc)[4]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) py[k] = y[yrow(k) * YS];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    pc[k] = c[(k >> 1) * CROWS * CS + (k & 1) * 4 * CS];
}

// SAD and MAD over the warp of a blend of two blocks' pixels
template <bool QUARTER>
__device__ __forceinline__ void blend_metrics(const int (&sy)[8],
                                              const int (&sc)[4],
                                              const int (&by)[8],
                                              const int (&bc)[4],
                                              const int (&ty)[8],
                                              const int (&tc)[4], int& sad,
                                              int& mad) {
  int s = 0, m = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int p =
        QUARTER ? lerp_quarter(by[k], ty[k]) : lerp_half(by[k], ty[k]);
    const int d = abs(sy[k] - p);
    s += d;
    m = max(m, d);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p =
        QUARTER ? lerp_quarter(bc[k], tc[k]) : lerp_half(bc[k], tc[k]);
    m = max(m, abs(sc[k] - p));
  }
  sad = static_cast<int>(__reduce_add_sync(FULL, static_cast<unsigned>(s)));
  mad = __reduce_max_sync(FULL, m);
}

// The search of an MB that the co-located candidate did not freeze,
// from the co-located state (bx, by) = (0, 0), sad, mad: rings of 9
// candidates at steps 16 .. 1 around the ring-entry best, then the 16
// sub-pel blends around the final best. Updates bx, by, sad, mad and sets
// spp, spa, spi.
__device__ __forceinline__ void search(const int (&sy)[8], const int (&sc)[4],
                                       const int16_t* y0, const int16_t* c0,
                                       int px, int py, int h, int w,
                                       int mad_thr, int& bx, int& by,
                                       int& sad, int& mad, int& spp,
                                       int& spa, int& spi) {
  int ssd = INT32_MAX_;
#pragma unroll 1
  for (int step = 16; step >= 1; step >>= 1) {
    const int ex = bx, ey = by, e_sad = sad, e_mad = mad;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int dx = ex + (k % 3 - 1) * step, dy = ey + (k / 3 - 1) * step;
      int c_sad = e_sad, c_mad = e_mad;   // k = 4: the ring-entry best
      if (k != 4)
        metrics(sy, sc, y0 + dy * YS + dx, c0 + (dy >> 1) * CS + (dx >> 1),
                c_sad, c_mad);
      const int c_ssd = dx * dx + dy * dy;
      const bool take = in_frame(px, py, dx, dy, h, w) &
                        eval_accept(sad, mad, ssd, c_sad, c_mad, c_ssd,
                                    mad_thr);
      bx = take ? dx : bx;
      by = take ? dy : by;
      sad = take ? c_sad : sad;
      mad = take ? c_mad : mad;
      ssd = take ? c_ssd : ssd;
    }
  }

  // sub-pel: the half-pel, then the quarter-pel blend of the best block
  // with its neighbour in direction d
  int qy[8], qc[4];
  pixels(y0 + by * YS + bx, c0 + (by >> 1) * CS + (bx >> 1), qy, qc);
#pragma unroll 2   // fully unrolled, it spills at 80 registers
  for (int d = 0; d < 8; ++d) {
    const int dx = bx + dir_x(d), dy = by + dir_y(d);
    int ty[8], tc[4];
    pixels(y0 + dy * YS + dx, c0 + (dy >> 1) * CS + (dx >> 1), ty, tc);
    const bool ok = in_frame(px, py, dx, dy, h, w);
    int hs, hm, qs, qm;
    blend_metrics<false>(sy, sc, qy, qc, ty, tc, hs, hm);
    blend_metrics<true>(sy, sc, qy, qc, ty, tc, qs, qm);
    bool take = ok & subpel_accept(sad, mad, hs, hm, mad_thr);
    spp = take ? 1 : spp;
    spa = take ? 0 : spa;
    spi = take ? d : spi;
    sad = take ? hs : sad;
    mad = take ? hm : mad;
    take = ok & subpel_accept(sad, mad, qs, qm, mad_thr);
    spp = take ? 1 : spp;
    spa = take ? 1 : spa;
    spi = take ? d : spi;
    sad = take ? qs : sad;
    mad = take ? qm : mad;
  }
}

__global__ void __launch_bounds__(THREADS, 2)
inter_search_kernel(const int* __restrict__ src_y,
                    const int* __restrict__ src_u,
                    const int* __restrict__ src_v,
                    const int16_t* __restrict__ ring_y,
                    const int16_t* __restrict__ ring_u,
                    const int16_t* __restrict__ ring_v,
                    const int* __restrict__ hdr, int h, int w,
                    int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int wb = w / MB, nmb = (h / MB) * wb;
  const int bi = blockIdx.y, mb0 = blockIdx.x * RUN;
  const int px0 = mb0 * MB, py = bi * MB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp / RUN, m = warp % RUN;   // reference index, MB of run
  const int frame_index = hdr[0];
  const int mad_thr = (hdr[1] >> 2) + 1;
  const int ch = h / 2, cw = w / 2;

  for (int i = 0; i < NREF; ++i) {
    const int slot = ((frame_index + RING - 1 - i) % RING + RING) % RING;
    stage(s.ref[i], ring_y + static_cast<size_t>(slot) * h * w,
          ring_u + static_cast<size_t>(slot) * ch * cw,
          ring_v + static_cast<size_t>(slot) * ch * cw, h, w, px0, py);
  }

  const bool active = mb0 + m < wb;
  const int n = bi * wb + mb0 + m;
  const int px = px0 + m * MB;
  // the lane's source pixels, loaded while the strips arrive
  int sy[8] = {}, sc[4] = {};
  const int ly = 4 * (lane >> 4), lx = lane & 15;
  const int cyl = lane >> 3, cxl = lane & 7;
  if (active) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      sy[k] = src_y[static_cast<size_t>(n) * 256 + (ly + yrow(k)) * MB + lx];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      sc[k] = ((k >> 1) ? src_v : src_u)[static_cast<size_t>(n) * 64 +
                                         (cyl + 4 * (k & 1)) * 8 + cxl];
  }
  cp_async_wait_all();
  __syncthreads();

  if (active) {
    const Strip& st = s.ref[r];
    // the lane's pixel k = 0 of the candidate at offset (0, 0); the
    // candidate at (dx, dy) is at + dy YS + dx (chroma (dy >> 1) CS +
    // (dx >> 1))
    const int16_t* y0 = st.y + (REACH + ly) * YS + REACH + m * MB + lx;
    const int16_t* c0 = st.c + (CREACH + cyl) * CS + CREACH + m * 8 + cxl;

    // a frozen MB (co-located MAD below the threshold) accepts no other
    // candidate: its warp stops after the co-located one
    int bx = 0, by = 0, sad, mad, spp = 0, spa = 0, spi = 0;
    metrics(sy, sc, y0, c0, sad, mad);
    if (mad >= mad_thr)
      search(sy, sc, y0, c0, px, py, h, w, mad_thr, bx, by, sad, mad, spp,
             spa, spi);
    if (lane == 0) {
      int* f = s.res[r][m];
      f[0] = sad;
      f[1] = mad < mad_thr;
      f[2] = (bx != 0 || by != 0 || spp) ? 1 : 0;
      f[3] = r + 1;
      f[4] = bx;
      f[5] = by;
      f[6] = spp;
      f[7] = spa;
      f[8] = spi;
    }
  }
  __syncthreads();

  // the merge in offset order: copy status dominates, then strictly lower
  // SAD; a tie keeps the earlier reference
  const int t = threadIdx.x;
  if (t < RUN && mb0 + t < wb) {
    const int* best = s.res[0][t];
    for (int i = 1; i < NREF; ++i) {
      const int* c = s.res[i][t];
      if (c[1] != best[1] ? c[1] != 0 : c[0] < best[0]) best = c;
    }
    for (int f = 0; f < NFIELDS; ++f)
      out[static_cast<size_t>(f) * nmb + bi * wb + mb0 + t] = best[f];
  }
}

}  // namespace

// out: (9, N) int32 rows sad, is_copy, is_motion, target, motion_x,
// motion_y, sp_pred, sp_amount, sp_index. hdr: device [frame_index,
// quality]. ring_*: (RING, h, w) / (RING, h/2, w/2) int16.
extern "C" int cairo_inter_search(const void* src_y, const void* src_u,
                                  const void* src_v, const void* ring_y,
                                  const void* ring_u, const void* ring_v,
                                  const void* hdr, int h, int w,
                                  void* out, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      inter_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((w / MB + RUN - 1) / RUN, h / MB);
  inter_search_kernel<<<grid, THREADS, sizeof(Smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src_y), static_cast<const int*>(src_u),
      static_cast<const int*>(src_v), static_cast<const int16_t*>(ring_y),
      static_cast<const int16_t*>(ring_u), static_cast<const int16_t*>(ring_v),
      static_cast<const int*>(hdr), h, w, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
