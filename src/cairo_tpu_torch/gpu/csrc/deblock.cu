// In-loop deblock kernel for Hopper (sm_90a): K8.
//
// K8 deblock_frame replaces the in-loop deblock of cairo_tpu/tpu/deblock.py
// (deblock_frame, :143), which runs as one XLA fori_loop over the 8-row
// bands of each plane (deblock_plane, :117) inside the step's jit; no
// Pallas kernel runs it. Y is filtered at 16-px MBs with the luma filter,
// U and V at 8-px cells with the chroma filter: band 0's vertical edges,
// then for each band b >= 1 the horizontal edge at row 8b and band b's
// vertical edges. Strength and QP come from the two MBs an edge separates
// (deblock._edge_maps), alpha and beta from tables.DEBLOCK_ALPHA/BETA.
//
// What bounds it on this card: neither bytes nor operations. A 1080p
// frame is 3,133,440 int32 samples read once and written once, 25.1 MB or
// 7.5 us at 3.35 TB/s. The bands are a chain: band b's horizontal edge
// reads rows 8b-4 .. 8b-1 as band b-1's vertical edges left them, and
// band b's vertical edges read rows 8b .. 8b+2 as that horizontal edge
// left them, so a column is one sequential walk of H / 8 bands (136 for
// 1080p luma), each a dependent chain of integer arithmetic.
//
// Design: the plane splits into independent column strips. A vertical
// edge at column 8k reads columns 8k-4 .. 8k+3 of its band's rows and
// writes 8k-3 .. 8k+2; a horizontal edge reads and writes one column. So
// strip k holds columns [8k-4, 8k+4) (k = 0 .. W/8; strips 0 and W/8 keep
// only their 4 columns inside the plane and have no vertical edge), and
// no strip ever reads a sample another strip writes.
//   * Threads. Each strip is LANES = 8 lanes of a warp, one column each
//     (lane t of strip k holds column 8k-4+t, tap t of the edge: p3, p2,
//     p1, p0, q0, q1, q2, q3); a warp holds 4 strips, 32 consecutive
//     columns, so its row loads and stores coalesce. One warp is a block;
//     Y's strips come first in the grid, then U's, then V's: one launch
//     for the frame, no block or grid barrier.
//   * The walk. A thread keeps its column's rows in registers: the 4 rows
//     above the current band (as band b-1's vertical edges left them) and
//     the band's 8 rows, and loads band b+1's rows and MB fields while it
//     filters band b. The horizontal edge works on its own column; a
//     vertical edge gets a row's 8 taps from the strip's lanes with
//     __shfl_sync, and every lane of the strip filters and keeps its own
//     tap.
//   * Stores. A row is stored once, when it is final: rows 8b-4 .. 8b-1
//     after band b's horizontal edge, rows 8b .. 8b+3 after band b's
//     vertical edges, the plane's last 4 rows after the last band. Every
//     input sample is read once and every output sample written once,
//     into new planes (the inputs stay as they were).
//   * Strengths and QPs inline from the per-MB copy flags and q: 0 where
//     both MBs are copies, 1 where one is, 2 otherwise; QP the mean of two
//     coded MBs' q, the coded side's q beside a copy, 0 between copies (a
//     copy MB's own q is never read). q must be in 0 .. 31.
//   * Arithmetic. Samples may lie outside 0 .. 255 (recon overshoot); the
//     filter's sums are taken modulo 2^32 and divided as ops.py divides
//     (common.cuh), so any int32 input gives the plain version's int32
//     result.

#include "common.cuh"

namespace {

using namespace cairo;

constexpr int STEP = 8;       // cell edge and band height
constexpr int LANES = 8;      // lanes a strip: columns 8k-4 .. 8k+3
constexpr int THREADS = 32;   // one warp a block: 4 strips
constexpr int QP_LEVELS = 32;

// tables.DEBLOCK_ALPHA and tables.DEBLOCK_BETA
__constant__ int ALPHA[QP_LEVELS] = {
    0, 0, 0, 0, 0, 0, 0, 1,  1,  1,  2,  2,  3,  3,  4,  5,
    6, 7, 8, 9, 10, 12, 14, 16, 18, 20, 22, 24, 26, 29, 32, 35};
__constant__ int BETA[QP_LEVELS] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 3,
    3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 10, 11};

struct Plane {
  const int* in;   // (h, w) int32
  int* out;        // (h, w) int32
  int h, w;
};

__device__ __forceinline__ int abs_w(int v) { return v < 0 ? sub_w(0, v) : v; }

// strength and QP of an edge between MBs a and b (deblock._edge_maps)
__device__ __forceinline__ void strength_qp(bool ca, bool cb, int qa, int qb,
                                            int& s, int& qp) {
  s = ca && cb ? 0 : (ca != cb ? 1 : 2);
  qp = !ca && !cb ? (qa + qb) >> 1 : (!ca ? qa : (!cb ? qb : 0));
}

// deblock._filter: the new p2, p1, p0, q0, q1, q2 of one edge; ab holds
// alpha (0 .. 31) and beta (32 .. 63)
template <bool LUMA>
__device__ __forceinline__ void filter(const int* t, int s, int qp,
                                       const int* ab, int* n) {
  const int p3 = t[0], p2 = t[1], p1 = t[2], p0 = t[3];
  const int q0 = t[4], q1 = t[5], q2 = t[6], q3 = t[7];
  const uint32_t P3 = p3, P2 = p2, P1 = p1, P0 = p0;
  const uint32_t Q0 = q0, Q1 = q1, Q2 = q2, Q3 = q3;
  const int level = clampi(qp, 0, QP_LEVELS - 1);
  const int alpha = ab[level], beta = ab[QP_LEVELS + level];
  const bool keep = abs_w(sub_w(p0, q0)) >= alpha ||
                    abs_w(sub_w(p1, p0)) >= beta ||
                    abs_w(sub_w(q1, q0)) >= beta || s == 0;
  const bool is2 = s == 2;
  int np0, nq0, np1, nq1, np2 = p2, nq2 = q2;
  if (is2) {
    np0 = rounded_div_pos(
        static_cast<int>(P2 + 2 * P1 + 2 * P0 + 2 * Q0 + Q1), 8);
    nq0 = rounded_div_pos(
        static_cast<int>(P1 + 2 * P0 + 2 * Q0 + 2 * Q1 + Q2), 8);
    np1 = rounded_div_pos(static_cast<int>(P2 + P1 + P0 + Q0), 4);
    nq1 = rounded_div_pos(static_cast<int>(P0 + Q0 + Q1 + Q2), 4);
    if (LUMA) {
      np2 = rounded_div_pos(
          static_cast<int>(2 * P3 + 3 * P2 + P1 + P0 + Q0), 8);
      nq2 = rounded_div_pos(
          static_cast<int>(2 * Q3 + 3 * Q2 + Q1 + Q0 + P0), 8);
    }
  } else {
    np0 = rounded_div_pos(static_cast<int>((Q0 + P0) * 4 + P1 - Q1), 8);
    nq0 = rounded_div_pos(static_cast<int>((Q0 + P0) * 4 + Q1 - P1), 8);
    if (LUMA) {
      np1 = rounded_div_pos(static_cast<int>(P2 * 4 + P0 * 2 + Q0 * 2), 8);
      nq1 = rounded_div_pos(static_cast<int>(Q2 * 4 + Q0 * 2 + P0 * 2), 8);
    } else {
      np1 = p1;
      nq1 = q1;
    }
  }
  n[0] = keep ? p2 : np2;
  n[1] = keep ? p1 : np1;
  n[2] = keep ? p0 : np0;
  n[3] = keep ? q0 : nq0;
  n[4] = keep ? q1 : nq1;
  n[5] = keep ? q2 : nq2;
}

// the per-MB fields of MB (row r, column c)
__device__ __forceinline__ void mb_fields(const uint8_t* copy, const int* q,
                                          int wb, int r, int c, bool& cp,
                                          int& qv) {
  cp = __ldg(copy + r * wb + c) != 0;
  qv = __ldg(q + r * wb + c);
}

// One thread's walk down column x = g - LANES / 2 of the plane, g its
// lane index in the plane's strips. MBC: cells an MB edge (2 luma, 1
// chroma); the MB map is (h / STEP / MBC, wb).
template <bool LUMA>
__device__ __forceinline__ void walk(const Plane& p, const uint8_t* copy,
                                     const int* q, int wb, int g,
                                     const int* ab) {
  constexpr int MBC = LUMA ? 2 : 1;
  const int x = g - LANES / 2, k = g / LANES, tap = g % LANES;
  const int cells_x = p.w / STEP, bands = p.h / STEP;
  const bool valid = x >= 0 && x < p.w;
  const bool edge = k >= 1 && k < cells_x;   // strip k's vertical edge
  const int mx = valid ? x / STEP / MBC : 0;
  const int ma = edge ? (k - 1) / MBC : 0, mb = edge ? k / MBC : 0;

  int cur[STEP], nxt[STEP] = {}, prev[LANES / 2];
  bool c_cur, ca, cb, c_prev = false, n_c = false, n_ca = false, n_cb = false;
  int q_cur, qa, qb, q_prev = 0, n_q = 0, n_qa = 0, n_qb = 0;
#pragma unroll
  for (int i = 0; i < STEP; ++i) {
    cur[i] = valid ? __ldg(p.in + i * p.w + x) : 0;
  }
  mb_fields(copy, q, wb, 0, mx, c_cur, q_cur);
  mb_fields(copy, q, wb, 0, ma, ca, qa);
  mb_fields(copy, q, wb, 0, mb, cb, qb);

  for (int b = 0; b < bands; ++b) {
    const int y = b * STEP;
    // band b + 1's rows and fields, loaded while band b is filtered
    if (b + 1 < bands) {
      const int* row = p.in + (y + STEP) * p.w + x;
#pragma unroll
      for (int i = 0; i < STEP; ++i) {
        nxt[i] = valid ? __ldg(row + i * p.w) : 0;
      }
      const int r = (b + 1) / MBC;
      mb_fields(copy, q, wb, r, mx, n_c, n_q);
      mb_fields(copy, q, wb, r, ma, n_ca, n_qa);
      mb_fields(copy, q, wb, r, mb, n_cb, n_qb);
    }
    if (b > 0) {
      // the horizontal edge at row y: p3 .. p0 rows y-4 .. y-1, q0 .. q3
      // rows y .. y+3, this column alone
      int s, qp, n[6];
      strength_qp(c_prev, c_cur, q_prev, q_cur, s, qp);
      const int t[8] = {prev[0], prev[1], prev[2], prev[3],
                        cur[0],  cur[1],  cur[2],  cur[3]};
      filter<LUMA>(t, s, qp, ab, n);
      prev[1] = n[0];
      prev[2] = n[1];
      prev[3] = n[2];
      cur[0] = n[3];
      cur[1] = n[4];
      cur[2] = n[5];
      if (valid) {
#pragma unroll
        for (int i = 0; i < LANES / 2; ++i) {
          p.out[(y - LANES / 2 + i) * p.w + x] = prev[i];
        }
      }
    }
    // band b's vertical edges: row i's taps from the strip's 8 lanes
    int s, qp;
    strength_qp(ca, cb, qa, qb, s, qp);
#pragma unroll
    for (int i = 0; i < STEP; ++i) {
      int t[8], n[6];
#pragma unroll
      for (int j = 0; j < LANES; ++j) {
        t[j] = __shfl_sync(FULL, cur[i], j, LANES);
      }
      filter<LUMA>(t, s, qp, ab, n);
      int v = cur[i];
#pragma unroll
      for (int j = 1; j < LANES - 1; ++j) {
        v = tap == j ? n[j - 1] : v;
      }
      cur[i] = edge ? v : cur[i];
    }
    if (valid) {
#pragma unroll
      for (int i = 0; i < LANES / 2; ++i) p.out[(y + i) * p.w + x] = cur[i];
    }
#pragma unroll
    for (int i = 0; i < LANES / 2; ++i) prev[i] = cur[LANES / 2 + i];
#pragma unroll
    for (int i = 0; i < STEP; ++i) cur[i] = nxt[i];
    c_prev = c_cur;
    q_prev = q_cur;
    c_cur = n_c;
    q_cur = n_q;
    ca = n_ca;
    qa = n_qa;
    cb = n_cb;
    qb = n_qb;
  }
  if (valid) {
#pragma unroll
    for (int i = 0; i < LANES / 2; ++i) {
      p.out[(p.h - LANES / 2 + i) * p.w + x] = prev[i];
    }
  }
}

// grid: wy warps for Y's strips, then wc for U's and wc for V's
__global__ void __launch_bounds__(THREADS)
    deblock_kernel(const Plane py, const Plane pu, const Plane pv,
                   const uint8_t* copy, const int* q, int wb, int wy,
                   int wc) {
  __shared__ int ab[2 * QP_LEVELS];
  for (int i = threadIdx.x; i < QP_LEVELS; i += THREADS) {
    ab[i] = ALPHA[i];
    ab[QP_LEVELS + i] = BETA[i];
  }
  __syncthreads();
  const int blk = blockIdx.x;
  if (blk < wy) {
    walk<true>(py, copy, q, wb, blk * THREADS + threadIdx.x, ab);
    return;
  }
  const bool is_v = blk >= wy + wc;
  const Plane pc{is_v ? pv.in : pu.in, is_v ? pv.out : pu.out, pu.h, pu.w};
  walk<false>(pc, copy, q, wb, (blk - wy - (is_v ? wc : 0)) * THREADS +
                                    threadIdx.x, ab);
}

// warps that hold the LANES-lane strips of a plane of width w
int warps_for(int w) {
  return ((w / STEP + 1) * LANES + THREADS - 1) / THREADS;
}

}  // namespace

// One launch on `stream` for the frame's three planes, Y (h, w) and U
// and V (h / 2, w / 2), into new planes of the same shapes; copy (uint8
// or bool) and q (int32) are the (h / 16, w / 16) MB maps.
// Returns the launch's CUDA error.
extern "C" int cairo_deblock_frame(const void* y, const void* u,
                                   const void* v, const void* copy,
                                   const void* q, int h, int w, void* out_y,
                                   void* out_u, void* out_v, void* stream) {
  const Plane py{static_cast<const int*>(y), static_cast<int*>(out_y), h, w};
  const Plane pu{static_cast<const int*>(u), static_cast<int*>(out_u), h / 2,
                 w / 2};
  const Plane pv{static_cast<const int*>(v), static_cast<int*>(out_v), h / 2,
                 w / 2};
  const int wy = warps_for(w), wc = warps_for(w / 2);
  deblock_kernel<<<wy + 2 * wc, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      py, pu, pv, static_cast<const uint8_t*>(copy),
      static_cast<const int*>(q), w / cairo::MB, wy, wc);
  return static_cast<int>(cudaGetLastError());
}
