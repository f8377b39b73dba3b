// Wave-pass kernel for Hopper (sm_90a): K6.
//
// K6 wave_pass replaces cairo_tpu/tpu/pallas_wave.py wave_pass
// (_build_wave_kernel): the conformance encoder's sequential pass over the
// frame's macroblocks in anti-diagonal waves w = bi + 3*bj (321 waves of
// up to 40 MBs at 1080p; wavefront.py:1-27). Each MB of a wave runs, as
// the XLA wave body (wavefront.py:481-611) does:
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
//   * the reconstruction is written into the frame for later waves.
//
// Design: one launch per wave, in order on one stream, one thread block of
// 256 threads per member; stream order makes wave w's writes visible to
// wave w+1. The frame's reconstruction lives in global memory (int32, the
// current ring slot's content at entry, updated in place), so pixels a
// member reads beyond the causal region hold the previous frame, as in
// raster order. A member reads [px-32, px+48) x [py-48, py+32) (chroma
// halved) and writes only its own 16x16 block; the other members of its
// wave sit at (bi+3k, bj-k), outside that window, so no block of a wave
// reads what another writes. Inside a block, every window load completes
// before the barrier that precedes the first write. The block stages its
// windows as int16 in shared memory (recon values are int16-wrapped) and
// evaluates the 9 (sub-pel: 16) candidates of a step together, thread t
// owning luma pixel t and, for t < 128, one chroma pixel; thread 0 folds
// the results in the reference's order. The windows, the candidate
// metrics and the acceptance rules are common.cuh's, shared with K5
// (inter.cu). The transforms are the __device__ functions below, one
// thread per coefficient.
//
// What bounds it on this card: the work is small (~62 candidate
// evaluations x 384 abs-diffs and ~6 x 1.5 k transform ops per MB, about
// 0.2 G ops per 1080p frame); the 321 dependent launches and the serial
// fold inside each block bound it. A persistent kernel or a CUDA graph
// over the waves is later work.

#include "common.cuh"

namespace {

using namespace cairo;

constexpr int THREADS = SEARCH_THREADS;
constexpr int NWARP = THREADS / 32;
constexpr int SKEW = 3;
constexpr int TOP_Q = 31;                    // tables.MAX_QUANT_LEVELS - 1
constexpr int QSF = 16;                      // tables.QUANTIZER_SCALE_FACTOR
constexpr int NDESC = 11;
constexpr int NCONST = 256;  // basis, intra QM, inter QM, luma/chroma DC

__constant__ int kRing0X[9] = {-16, 0, 16, -16, 0, 16, -16, 0, 16};
__constant__ int kRing0Y[9] = {-32, -32, -32, -16, -16, -16, 0, 0, 0};

// luma [py-48, py+32) x [px-32, px+48), chroma halved
using Win = Windows<80, 32, 48, 40, 16, 24>;

struct Smem {
  Win win;
  int src[384];    // Y 16x16, U 8x8, V 8x8
  int pred[384];
  int a[384];      // residual, then coefficients, then the inverse
  int b[384];      // transform scratch
  int k[NCONST];
  int red[2 * 16 * NWARP];
  int csad[16];
  int cmad[16];
  int st[12];      // fields broadcast by thread 0
};

// index into the 384-entry block of 8x8 block b (0-3 luma quadrants TL,
// TR, BL, BR of the 16x16 MB; 4 U; 5 V), row r, column c
__device__ __forceinline__ int idx8(int b, int r, int c) {
  return b < 4 ? ((b >> 1) * 8 + r) * 16 + (b & 1) * 8 + c
               : 256 + (b - 4) * 64 + r * 8 + c;
}

// a candidate at offset (dx, dy) counts iff causal and inside the frame
__device__ __forceinline__ bool causal_ok(int px, int py, int dx, int dy,
                                          int h, int w) {
  return (dy <= -MB || dx <= -MB) && in_frame(px, py, dx, dy, h, w);
}

// one pass of ops.fdct8 along rows (cols = false) or columns
__device__ void fdct_pass(const int* in, int* out, const int* basis,
                          bool cols) {
  for (int e = threadIdx.x; e < 384; e += THREADS) {
    const int b = e >> 6, r = (e >> 3) & 7, k = e & 7;
    int t = 0;
    for (int j = 0; j < 8; ++j)
      t += basis[k * 8 + j] * in[cols ? idx8(b, j, r) : idx8(b, r, j)];
    const int v = k == 0 ? trunc_div_pos(t * 45, 128) : trunc_div_pos(t, 2);
    out[cols ? idx8(b, k, r) : idx8(b, r, k)] = wrap16(rounded_div_pos(v, 128));
  }
}

// one pass of ops.idct8 (per-term truncation, transform.cpp:330-349)
__device__ void idct_pass(const int* in, int* out, const int* basis,
                          bool cols) {
  for (int e = threadIdx.x; e < 384; e += THREADS) {
    const int b = e >> 6, r = (e >> 3) & 7, k = e & 7;
    int total = 0;
    for (int j = 0; j < 8; ++j) {
      const int term = in[cols ? idx8(b, j, r) : idx8(b, r, j)] *
                       basis[j * 8 + k];
      total += j == 0 ? trunc_div_pos(term * 45, 128) : trunc_div_pos(term, 2);
    }
    out[cols ? idx8(b, k, r) : idx8(b, r, k)] =
        wrap16(rounded_div_pos(total, 128));
  }
}

__device__ __forceinline__ int ilog2_u32(int v) {
  const unsigned u = static_cast<unsigned>(v);
  return u == 0 ? 0 : 31 - __clz(u);
}

__global__ void __launch_bounds__(THREADS)
wave_kernel(const int* __restrict__ src_y, const int* __restrict__ src_u,
            const int* __restrict__ src_v, const int* __restrict__ self_sad,
            const int* __restrict__ inter, const int* __restrict__ pred_y,
            const int* __restrict__ pred_u, const int* __restrict__ pred_v,
            int* rec_y, int* rec_u, int* rec_v,
            const int* __restrict__ quality_p,
            const int* __restrict__ consts, int h, int w, int is_inter,
            int wave, int bj_lo, int* __restrict__ desc,
            int16_t* __restrict__ coef_y, int16_t* __restrict__ coef_u,
            int16_t* __restrict__ coef_v) {
  __shared__ Smem s;
  const int t = threadIdx.x;
  const int wb = w / MB;
  const int nmb = (h / MB) * wb;
  const int bj = bj_lo + blockIdx.x;
  const int bi = wave - SKEW * bj;
  const int m = bj * wb + bi;
  const int px = bi * MB, py = bj * MB;
  const int cw = w / 2;
  const int quality = *quality_p;
  const int mad_thr = (quality >> 2) + 1;
  const int* basis = s.k;
  const int* iqm = s.k + 64;
  const int* pqm = s.k + 128;
  const int* ldc = s.k + 192;
  const int* cdc = s.k + 224;

  // ---- loads: constants, source, the member's windows of the frame
  s.k[t] = consts[t];
  s.src[t] = src_y[static_cast<size_t>(m) * 256 + t];
  if (t < 64) s.src[256 + t] = src_u[static_cast<size_t>(m) * 64 + t];
  else if (t < 128)
    s.src[256 + t] = src_v[static_cast<size_t>(m) * 64 + t - 64];
  s.win.load(rec_y, rec_u, rec_v, h, w, px, py);
  if (t == 0) s.st[0] = s.st[1] = 0;
  __syncthreads();  // every read of the frame is done before any write

  // ---- causal intra search (thread 0 folds)
  int bx = 0, by = 0, sad = self_sad[m], mad = INT32_MAX_, ssd = INT32_MAX_;
  for (int ring = 0; ring < 5; ++ring) {
    const int step = 16 >> ring;  // 8, 4, 2, 1 for rings 1-4
    const int ex = s.st[0], ey = s.st[1];
    int y[9], c[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int dx = ring ? ex + (k % 3 - 1) * step : kRing0X[k];
      const int dy = ring ? ey + (k / 3 - 1) * step : kRing0Y[k];
      s.win.cand_px(dx, dy, y[k], c[k]);
    }
    cand_metrics<9, NWARP>(s.src, y, c, s.red, s.csad, s.cmad);
    if (t == 0) {
      for (int k = 0; k < 9; ++k) {
        const int dx = ring ? ex + (k % 3 - 1) * step : kRing0X[k];
        const int dy = ring ? ey + (k / 3 - 1) * step : kRing0Y[k];
        const int c_ssd = dx * dx + dy * dy;
        if (causal_ok(px, py, dx, dy, h, w) &&
            eval_accept(sad, mad, ssd, s.csad[k], s.cmad[k], c_ssd, mad_thr)) {
          bx = dx; by = dy; sad = s.csad[k]; mad = s.cmad[k]; ssd = c_ssd;
        }
      }
      s.st[0] = bx;
      s.st[1] = by;
    }
    __syncthreads();
  }
  bx = s.st[0];
  by = s.st[1];

  // ---- sub-pel: candidate 2d half, 2d+1 quarter in direction d
  {
    int y[16], c[16];
    s.win.subpel_px(bx, by, y, c);
    cand_metrics<16, NWARP>(s.src, y, c, s.red, s.csad, s.cmad);
  }
  if (t == 0) {
    int spp = 0, spa = 0, spi = 0;
    for (int k = 0; k < 16; ++k) {
      const int d = k >> 1;
      if (causal_ok(px, py, bx + dir_x(d), by + dir_y(d), h, w) &&
          subpel_accept(sad, mad, s.csad[k], s.cmad[k], mad_thr)) {
        spp = 1; spa = k & 1; spi = d; sad = s.csad[k]; mad = s.cmad[k];
      }
    }
    // intra descriptor, then the merge with the inter result (a tie
    // keeps intra)
    int f[9] = {1, (bx != 0 || by != 0 || spp) ? 1 : 0, mad < mad_thr ? 1 : 0,
                0, bx, by, spp, spa, spi};
    if (is_inter) {
      // inter rows: sad, is_copy, is_motion, target, mx, my, spp, spa, spi
      const int i_sad = inter[m], i_copy = inter[nmb + m];
      const bool take = i_copy != f[2] ? i_copy != 0 : i_sad < sad;
      if (take) {
        f[0] = 0;
        f[1] = inter[2 * nmb + m];
        f[2] = i_copy;
        for (int i = 3; i < 9; ++i)
          f[i] = inter[static_cast<size_t>(i) * nmb + m];
      }
    }
    for (int i = 0; i < 9; ++i) s.st[2 + i] = f[i];
  }
  __syncthreads();
  const int is_intra = s.st[2], is_motion = s.st[3], is_copy = s.st[4];
  const int mx = s.st[6], my = s.st[7];
  const int spp = s.st[8], spa = s.st[9], spi = s.st[10];
  const bool intra_default = is_intra && !is_motion;

  // ---- prediction and residual
  for (int i = t; i < 384; i += THREADS) {
    int p = 0;
    if (!intra_default) {
      if (is_intra) {
        p = s.win.at(mx, my, i);
        if (spp) {
          const int tv = s.win.at(mx + dir_x(spi), my + dir_y(spi), i);
          p = spa ? lerp_quarter(p, tv) : lerp_half(p, tv);
        }
      } else if (i < 256) {
        p = pred_y[static_cast<size_t>(m) * 256 + i];
      } else if (i < 320) {
        p = pred_u[static_cast<size_t>(m) * 64 + i - 256];
      } else {
        p = pred_v[static_cast<size_t>(m) * 64 + i - 320];
      }
    }
    s.pred[i] = p;
    s.a[i] = wrap16(s.src[i] - p);
  }
  __syncthreads();

  // ---- forward transform
  fdct_pass(s.a, s.b, basis, false);
  __syncthreads();
  fdct_pass(s.b, s.a, basis, true);
  __syncthreads();

  // ---- variance (ops.block_variance2, int32 wrap) and adaptive QP
  {
    const int v = s.a[t];  // luma coefficients in MB layout
    const bool on = v != 0 && t != 0;
    int sums[3] = {on ? 1 : 0, on ? v : 0, on ? mul_w(v, v) : 0};
    int maxs[3] = {0, 0, 0};
    block_sum_max<3, NWARP>(sums, maxs, s.red, s.csad, s.cmad);
  }
  const int count = s.csad[0], sum = s.csad[1], sumsq = s.csad[2];
  const int cnt = max(count, 1);
  const int var = count > 0
      ? sub_w(sumsq, trunc_div_pos(add_w(mul_w(sum, sum), cnt / 2), cnt))
      : 0;
  const int index = clampi(ilog2_u32(var) >> 1, 1, TOP_Q);
  const int qp = index > quality
      ? clampi(quality + ((index - quality) >> 1), 1, TOP_Q)
      : (index < quality ? clampi(quality - ((quality - index) >> 1), 1, TOP_Q)
                         : quality);
  __syncthreads();  // s.csad is reused below only after this point

  // ---- quantise, write the coefficient blocks, dequantise
  for (int e = t; e < 384; e += THREADS) {
    const int b = e >> 6, r = (e >> 3) & 7, c = e & 7;
    const int i = idx8(b, r, c);
    const int v = s.a[i];
    const bool luma = b < 4;
    const bool dc = r == 0 && c == 0;
    int q, dq;
    if (intra_default) {
      const int qm = iqm[r * 8 + c];
      const int dcs = luma ? ldc[qp] : cdc[qp];
      q = dc ? wrap16(rounded_div_pos(v, dcs))
             : wrap16(rounded_div_pos(rounded_div_pos(v * QSF, qm), qp << 1));
      dq = dc ? wrap16(q * dcs) : wrap16(trunc_div_pos(2 * q * qm * qp, QSF));
    } else {
      const int qm = pqm[r * 8 + c];
      const int qf = wrap16(rounded_div_pos(v * QSF, qm));
      const int sg = (qf > 0) - (qf < 0);
      q = wrap16(rounded_div_pos(qf - sg * qp, qp << 1));
      dq = wrap16(trunc_div_pos(2 * q * qm * qp, QSF));
    }
    const int16_t q16 = static_cast<int16_t>(q);
    if (i < 256) coef_y[static_cast<size_t>(m) * 256 + i] = q16;
    else if (i < 320) coef_u[static_cast<size_t>(m) * 64 + i - 256] = q16;
    else coef_v[static_cast<size_t>(m) * 64 + i - 320] = q16;
    s.b[i] = dq;
  }
  __syncthreads();

  // ---- inverse transform (columns, then rows) and reconstruction
  idct_pass(s.b, s.a, basis, true);
  __syncthreads();
  idct_pass(s.a, s.b, basis, false);
  __syncthreads();
  for (int i = t; i < 384; i += THREADS) {
    const int p = s.pred[i];
    const int v = is_copy ? p : wrap16(s.b[i] + p);
    if (i < 256) {
      rec_y[static_cast<size_t>(py + (i >> 4)) * w + px + (i & 15)] = v;
    } else {
      const int j = (i - 256) & 63;
      int* plane = i < 320 ? rec_u : rec_v;
      plane[static_cast<size_t>(py / 2 + (j >> 3)) * cw + px / 2 + (j & 7)] = v;
    }
  }
  if (t == 0) {
    const int f[NDESC] = {is_intra, is_motion, is_copy, s.st[5], mx, my,
                          spp, spa, spi, qp, wrap16(var)};
    for (int i = 0; i < NDESC; ++i)
      desc[static_cast<size_t>(i) * nmb + m] = f[i];
  }
}

}  // namespace

// One launch per non-empty wave, in order on `stream`. desc: (11, N) int32
// rows is_intra, is_motion, is_copy, target, motion_x, motion_y, sp_pred,
// sp_amount, sp_index, q_index, variance. rec_*: int32 planes, updated in
// place. inter: (9, N) int32 (cuda_inter.FIELDS rows) and pred_*: int32
// blocks, read only when is_inter. Returns the first CUDA error.
extern "C" int cairo_wave_pass(const void* src_y, const void* src_u,
                               const void* src_v, const void* self_sad,
                               const void* inter, const void* pred_y,
                               const void* pred_u, const void* pred_v,
                               void* rec_y, void* rec_u, void* rec_v,
                               const void* quality, const void* consts,
                               int h, int w, int is_inter, void* desc,
                               void* coef_y, void* coef_u, void* coef_v,
                               void* stream) {
  const int wb = w / MB, hb = h / MB;
  const int n_waves = wb + SKEW * (hb - 1);
  for (int wave = 0; wave < n_waves; ++wave) {
    const int lo = max(0, (wave - (wb - 1) + SKEW - 1) / SKEW);
    const int hi = min(hb - 1, wave / SKEW);
    if (hi < lo) continue;
    wave_kernel<<<hi - lo + 1, THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(src_y), static_cast<const int*>(src_u),
        static_cast<const int*>(src_v), static_cast<const int*>(self_sad),
        static_cast<const int*>(inter), static_cast<const int*>(pred_y),
        static_cast<const int*>(pred_u), static_cast<const int*>(pred_v),
        static_cast<int*>(rec_y), static_cast<int*>(rec_u),
        static_cast<int*>(rec_v), static_cast<const int*>(quality),
        static_cast<const int*>(consts), h, w, is_inter, wave, lo,
        static_cast<int*>(desc), static_cast<int16_t*>(coef_y),
        static_cast<int16_t*>(coef_u), static_cast<int16_t*>(coef_v));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

// The launch floor of cairo_wave_pass at geometry (h, w): the same
// sequence of launches and grids with an empty kernel, for measurement.
extern "C" int cairo_wave_launch_floor(int h, int w, void* stream) {
  const int wb = w / MB, hb = h / MB;
  for (int wave = 0; wave < wb + SKEW * (hb - 1); ++wave) {
    const int lo = max(0, (wave - (wb - 1) + SKEW - 1) / SKEW);
    const int hi = min(hb - 1, wave / SKEW);
    if (hi < lo) continue;
    empty_kernel<<<hi - lo + 1, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>();
  }
  return static_cast<int>(cudaGetLastError());
}
