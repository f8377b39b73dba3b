// The fast search's sub-pel refinement for Hopper (sm_90a): K9.
//
// K9 subpel_scan replaces no Pallas kernel. It is the lax.scan of sp_body
// over the 8 neighbour directions in cairo_tpu/tpu/motion.py inter_search
// (motion.py:476-521), which XLA fuses into a few kernels on the TPU and
// the port once ran as some 1,400 torch ops a reference. Per MB it
// blends the full-pel best block (K3's windows at [1, 17), chroma [1, 9))
// with its neighbour in each direction of motion.SP_DIRS (dj outer, di
// inner), half-pel before quarter-pel, and folds the 16 candidates in
// that order from K2's best under the sub-pel acceptance rule
// (cairo::subpel_accept): each accept compares against the state the
// previous candidate left, ties never replace. The chroma neighbour of
// direction (di, dj) lies at ((mx + di) >> 1) - (mx >> 1) = (di + (mx &
// 1)) >> 1 columns (floor shifts of possibly negative ints) and likewise
// in rows. A candidate is valid when its full-pel position stays in the
// (height, width) frame, judged at the tile's origin x0, and the MB is not
// frozen.
//
// What bounds it on this card: integer operations, some 12 per sample
// (the blend, |src - blend|, the sum and the max) x 384 samples x 16
// candidates per MB, about 0.6 G for the 8,160 MBs of a 1080p frame
// (0.018 ms at 33.5 Tops/s) against some 30 MB of windows and source
// (0.009 ms at 3.35 TB/s).
//
// Design, simple first: one warp per MB, WARPS MBs a block. The 16
// candidates' metrics and the 8 validity flags depend only on the
// full-pel best and the direction, not on the fold, so every lane
// computes its share of all of them from registers: lane l takes luma
// row l / 2, columns 8 (l % 2) .. + 8, and keeps the 3 x 10 window patch
// those samples and their 8 neighbours read; chroma row l / 4, columns
// 2 (l % 4) .. + 2 of U and V, with 3 x 4 patches. The parity of mx and
// my is uniform over the warp, so the chroma shift is picked by selects
// and the patches stay in registers. __reduce_add_sync and
// __reduce_max_sync (exact on ints) give every lane each candidate's SAD
// and MAD; every lane folds the same values, and lane 0 writes.
//
// The blends are ops.lerp_half and ops.lerp_quarter written out:
// round_out, C truncation, and wrap16 as ((v + 0x8000) & 0xFFFF) -
// 0x8000. The windows hold recon samples of the int16 ring, which can be
// negative or beyond 255, and the source planes lie in int16 range, so no
// sum or difference here leaves int32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using cairo::FULL;
using cairo::MB;

constexpr int WARPS = 4;          // MBs per block, one warp each
constexpr int YW = MB + 2;        // luma window 18 x 18
constexpr int CW = MB / 2 + 2;    // chroma windows 10 x 10

__device__ __forceinline__ int wrap16(int v) {
  return ((v + 0x8000) & 0xFFFF) - 0x8000;
}

// C truncation of v / 2^s
__device__ __forceinline__ int trunc_shift(int v, int s) {
  return v < 0 ? -((-v) >> s) : v >> s;
}

// ops.lerp_half: wrap16(trunc(round_out(a + b, 1) / 2))
__device__ __forceinline__ int lerp_half(int a, int b) {
  const int t = a + b;
  return wrap16(trunc_shift(t < 0 ? t - 1 : t + 1, 1));
}

// ops.lerp_quarter: wrap16(trunc(round_out(3a + b, 2) / 4))
__device__ __forceinline__ int lerp_quarter(int a, int b) {
  const int t = 3 * a + b;
  return wrap16(trunc_shift(t < 0 ? t - 2 : t + 2, 2));
}

// p[1 + cy][1 + cx + K] for cy, cx in -1..1, by selects
template <int K>
__device__ __forceinline__ int shifted(const int (&p)[3][4], int cy, int cx) {
  int r[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    r[a] = cx < 0 ? p[a][K] : (cx == 0 ? p[a][K + 1] : p[a][K + 2]);
  return cy < 0 ? r[0] : (cy == 0 ? r[1] : r[2]);
}

// |src - blend| of one sample
template <bool QUARTER>
__device__ __forceinline__ int diff(int src, int best, int test) {
  return abs(src - (QUARTER ? lerp_quarter(best, test)
                            : lerp_half(best, test)));
}

// chroma sample K of the lane, U and V: folds both blends into their MADs
template <int K>
__device__ __forceinline__ void chroma(int su, const int (&up)[3][4], int sv,
                                       const int (&vp)[3][4], int cy, int cx,
                                       int& hm, int& qm) {
  const int ut = shifted<K>(up, cy, cx), vt = shifted<K>(vp, cy, cx);
  hm = max(hm, max(diff<false>(su, up[1][1 + K], ut),
                   diff<false>(sv, vp[1][1 + K], vt)));
  qm = max(qm, max(diff<true>(su, up[1][1 + K], ut),
                   diff<true>(sv, vp[1][1 + K], vt)));
}

__global__ void __launch_bounds__(WARPS * 32)
subpel_scan_kernel(const int* __restrict__ ywin,
                   const int* __restrict__ uwin,
                   const int* __restrict__ vwin,
                   const int* __restrict__ src_y,
                   const int* __restrict__ src_u,
                   const int* __restrict__ src_v,
                   const int* __restrict__ mx_in,
                   const int* __restrict__ my_in,
                   const int* __restrict__ sad_in,
                   const int* __restrict__ mad_in,
                   const uint8_t* __restrict__ frozen_in,
                   const int* __restrict__ px_in,
                   const int* __restrict__ py_in,
                   const int* __restrict__ mad_thr, int n, int w, int x0,
                   int width, int height, int* __restrict__ sad_out,
                   int* __restrict__ mad_out, int* __restrict__ index_out,
                   uint8_t* __restrict__ pred_out,
                   uint8_t* __restrict__ amount_out,
                   uint8_t* __restrict__ motion_out,
                   uint8_t* __restrict__ copy_out) {
  const int m = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (m >= n) return;  // the whole warp: m is uniform over it
  const int lane = threadIdx.x & 31;
  const int mx = mx_in[m], my = my_in[m], px = px_in[m], py = py_in[m];
  const bool frozen = frozen_in[m] != 0;
  const int thr = *mad_thr;

  // luma: row yr, columns yc .. yc + 8 of the block; window rows
  // yr .. yr + 2, columns yc .. yc + 9
  const int yr = lane >> 1, yc = (lane & 1) * 8;
  const int* yw = ywin + static_cast<size_t>(m) * YW * YW + yr * YW + yc;
  const int* sy = src_y + static_cast<size_t>(py + yr) * w + px + yc;
  int yp[3][10], ys[8];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 10; ++b) yp[a][b] = yw[a * YW + b];
#pragma unroll
  for (int k = 0; k < 8; ++k) ys[k] = sy[k];

  // chroma: row cr, columns cc .. cc + 2 of U and V; window rows
  // cr .. cr + 2, columns cc .. cc + 3
  const int cr = lane >> 2, cc = (lane & 3) * 2, cwp = w / 2;
  const size_t coff = static_cast<size_t>(m) * CW * CW + cr * CW + cc;
  const size_t soff =
      static_cast<size_t>((py >> 1) + cr) * cwp + (px >> 1) + cc;
  int up[3][4], vp[3][4], us[2], vs[2];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      up[a][b] = uwin[coff + a * CW + b];
      vp[a][b] = vwin[coff + a * CW + b];
    }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    us[k] = src_u[soff + k];
    vs[k] = src_v[soff + k];
  }

  int sad = sad_in[m], mad = mad_in[m], index = 0;
  bool pred = false, amount = false;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const int di = cairo::dir_x(d), dj = cairo::dir_y(d);
    const int cdx = (di + (mx & 1)) >> 1, cdy = (dj + (my & 1)) >> 1;
    const bool ok =
        !frozen && cairo::in_frame(x0 + px, py, mx + di, my + dj, height,
                                   width);
    int hs = 0, hm = 0, qs = 0, qm = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int b = yp[1][1 + k], t = yp[1 + dj][1 + di + k];
      const int h = diff<false>(ys[k], b, t), q = diff<true>(ys[k], b, t);
      hs += h;
      hm = max(hm, h);
      qs += q;
      qm = max(qm, q);
    }
    chroma<0>(us[0], up, vs[0], vp, cdy, cdx, hm, qm);
    chroma<1>(us[1], up, vs[1], vp, cdy, cdx, hm, qm);
    hs = __reduce_add_sync(FULL, hs);
    hm = __reduce_max_sync(FULL, hm);
    qs = __reduce_add_sync(FULL, qs);
    qm = __reduce_max_sync(FULL, qm);

    // the fold, half then quarter
    bool take = ok && cairo::subpel_accept(sad, mad, hs, hm, thr);
    pred = pred || take;
    amount = take ? false : amount;
    index = take ? d : index;
    sad = take ? hs : sad;
    mad = take ? hm : mad;
    take = ok && cairo::subpel_accept(sad, mad, qs, qm, thr);
    pred = pred || take;
    amount = take ? true : amount;
    index = take ? d : index;
    sad = take ? qs : sad;
    mad = take ? qm : mad;
  }
  if (lane == 0) {
    sad_out[m] = sad;
    mad_out[m] = mad;
    index_out[m] = index;
    pred_out[m] = pred;
    amount_out[m] = amount;
    motion_out[m] = mx != 0 || my != 0 || pred;
    copy_out[m] = mad < thr;
  }
}

}  // namespace

// windows: (n, 18, 18) and 2 x (n, 10, 10) int32; src planes: (h, w) and
// 2 x (h/2, w/2) int32, read at each MB's (px, py); mx, my, sad, mad
// int32, frozen bool, px, py int32, all (n,); mad_thr: device int32.
// Outputs (n,): sad, mad, sp_index int32; sp_pred, sp_amount, is_motion,
// is_copy bool.
extern "C" int cairo_subpel_scan(
    const void* ywin, const void* uwin, const void* vwin, const void* src_y,
    const void* src_u, const void* src_v, const void* mx, const void* my,
    const void* sad, const void* mad, const void* frozen, const void* px,
    const void* py, const void* mad_thr, int n, int w, int x0, int width,
    int height, void* sad_out, void* mad_out, void* index_out,
    void* pred_out, void* amount_out, void* motion_out, void* copy_out,
    void* stream) {
  if (n == 0) return 0;
  subpel_scan_kernel<<<(n + WARPS - 1) / WARPS, WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ywin), static_cast<const int*>(uwin),
      static_cast<const int*>(vwin), static_cast<const int*>(src_y),
      static_cast<const int*>(src_u), static_cast<const int*>(src_v),
      static_cast<const int*>(mx), static_cast<const int*>(my),
      static_cast<const int*>(sad), static_cast<const int*>(mad),
      static_cast<const uint8_t*>(frozen), static_cast<const int*>(px),
      static_cast<const int*>(py), static_cast<const int*>(mad_thr), n, w,
      x0, width, height, static_cast<int*>(sad_out),
      static_cast<int*>(mad_out), static_cast<int*>(index_out),
      static_cast<uint8_t*>(pred_out), static_cast<uint8_t*>(amount_out),
      static_cast<uint8_t*>(motion_out), static_cast<uint8_t*>(copy_out));
  return static_cast<int>(cudaGetLastError());
}
