// Dense fast-mode motion search kernels for Hopper (sm_90a): K1 and K2.
//
// K1 chroma_max_maps replaces cairo_tpu/tpu/pallas_motion.py
// chroma_max_maps (_chroma_kernel): for each 8x8 chroma block and each
// offset (cdx, cdy) in [-8, 8]^2, the block maximum of
// max(|u - u_ref|, |v - v_ref|). Output layout (hb, wb, 17*17), offset
// index (cdy+8)*17 + (cdx+8), so that K1 writes and K2 reads one
// contiguous row of 289 values per block.
//
// K2 dense_select replaces pallas_motion.py dense_select (_dense_kernel):
// per 16x16 macroblock, SAD and luma abs-max over all 33x33 offsets in
// [-16, 16]^2, MAD = max(luma abs-max, K1's map at (ox>>1, oy>>1)), then
// the fast-mode policy of motion._dense_select: co-located early-out
// (frozen); else the lexicographic minimum of (MAD, dist^2, scan) among
// copy-grade offsets; else of (SAD, dist^2, scan). Scan order is dy-major,
// so each thread folds its offsets into one packed 64-bit key
// (key << 21 | dist^2 << 11 | scan) and a block-wide min resolves ties
// exactly as the sequential scan's strict '<' does.
//
// Design: one thread block per (chroma) block / macroblock; the source
// block and the whole reference window (24x24 chroma, 48x48 luma) sit in
// shared memory as int32 and every thread evaluates whole offsets. Ring
// pixels are int16 and can leave 0..255 (recon overshoot), so the
// arithmetic is plain int32, not byte SIMD. What bounds them on the card
// is integer operations: K2 does 256 abs-diff-accumulates per offset per
// macroblock (~2.27 G per 1080p call) against ~22 MB of traffic.
// The reference is a plain ring plane of the source's shape; reads
// outside it are zero, matching the anchor's zero padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MB = 16;
constexpr int R = 16;
constexpr int SPAN = 2 * R + 1;       // 33
constexpr int NOFF = SPAN * SPAN;     // 1089
constexpr int CENTER = R * SPAN + R;  // offset (0, 0)
constexpr int YWIN = MB + 2 * R;      // 48
constexpr int CB = 8;
constexpr int CR = 8;
constexpr int CSPAN = 2 * CR + 1;     // 17
constexpr int CNOFF = CSPAN * CSPAN;  // 289
constexpr int CWIN = CB + 2 * CR;     // 24
constexpr int K1_THREADS = 128;
constexpr int K2_THREADS = 256;
constexpr unsigned long long NONE = ~0ull;

__device__ __forceinline__ int ref_at(const int16_t* ref, int rows, int cols,
                                      int y, int x) {
  return (y >= 0 && y < rows && x >= 0 && x < cols)
             ? static_cast<int>(ref[static_cast<size_t>(y) * cols + x])
             : 0;
}

__global__ void __launch_bounds__(K1_THREADS)
chroma_max_kernel(const int* __restrict__ su, const int* __restrict__ sv,
                  const int16_t* __restrict__ ru,
                  const int16_t* __restrict__ rv, int h, int w,
                  int* __restrict__ out) {
  __shared__ int s_u[CB][CB];
  __shared__ int s_v[CB][CB];
  __shared__ int r_u[CWIN][CWIN];
  __shared__ int r_v[CWIN][CWIN];
  const int bj = blockIdx.x, bi = blockIdx.y;
  const int y0 = bi * CB, x0 = bj * CB;
  for (int i = threadIdx.x; i < CB * CB; i += blockDim.x) {
    const int r = i / CB, c = i % CB;
    const size_t p = static_cast<size_t>(y0 + r) * w + x0 + c;
    s_u[r][c] = su[p];
    s_v[r][c] = sv[p];
  }
  for (int i = threadIdx.x; i < CWIN * CWIN; i += blockDim.x) {
    const int r = i / CWIN, c = i % CWIN;
    const int y = y0 - CR + r, x = x0 - CR + c;
    r_u[r][c] = ref_at(ru, h, w, y, x);
    r_v[r][c] = ref_at(rv, h, w, y, x);
  }
  __syncthreads();
  int* o = out + (static_cast<size_t>(bi) * (w / CB) + bj) * CNOFF;
  for (int off = threadIdx.x; off < CNOFF; off += blockDim.x) {
    const int dy = off / CSPAN, dx = off % CSPAN;
    int m = 0;
#pragma unroll
    for (int r = 0; r < CB; ++r) {
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        m = max(m, max(abs(s_u[r][c] - r_u[dy + r][dx + c]),
                       abs(s_v[r][c] - r_v[dy + r][dx + c])));
      }
    }
    o[off] = m;
  }
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = min(v, __shfl_down_sync(0xffffffffu, v, s));
  return v;
}

__global__ void __launch_bounds__(K2_THREADS)
dense_select_kernel(const int* __restrict__ src,
                    const int16_t* __restrict__ ref,
                    const int* __restrict__ cmax,
                    const int* __restrict__ mad_thr_p, int h, int w,
                    int x0, int width, int height,
                    int* __restrict__ mx_o, int* __restrict__ my_o,
                    int* __restrict__ sad_o, int* __restrict__ mad_o,
                    uint8_t* __restrict__ frozen_o) {
  __shared__ int s_src[MB][MB];
  __shared__ int s_ref[YWIN][YWIN];
  __shared__ int s_sad[NOFF];
  __shared__ int s_mad[NOFF];
  __shared__ unsigned long long s_red[2][K2_THREADS / 32];
  const int bj = blockIdx.x, bi = blockIdx.y;
  const int wb = w / MB;
  const int py = bi * MB, px = bj * MB;
  for (int i = threadIdx.x; i < MB * MB; i += blockDim.x) {
    const int r = i / MB, c = i % MB;
    s_src[r][c] = src[static_cast<size_t>(py + r) * w + px + c];
  }
  for (int i = threadIdx.x; i < YWIN * YWIN; i += blockDim.x) {
    const int r = i / YWIN, c = i % YWIN;
    s_ref[r][c] = ref_at(ref, h, w, py - R + r, px - R + c);
  }
  __syncthreads();

  const int thr = *mad_thr_p;
  const int* cm = cmax + (static_cast<size_t>(bi) * wb + bj) * CNOFF;
  unsigned long long best_p = NONE, best_c = NONE;
  for (int off = threadIdx.x; off < NOFF; off += blockDim.x) {
    const int dy = off / SPAN, dx = off % SPAN;
    const int oy = dy - R, ox = dx - R;
    int sad = 0, lmax = 0;
    for (int r = 0; r < MB; ++r) {
#pragma unroll
      for (int c = 0; c < MB; ++c) {
        const int d = abs(s_src[r][c] - s_ref[dy + r][dx + c]);
        sad += d;
        lmax = max(lmax, d);
      }
    }
    const int mad = max(lmax, cm[((oy >> 1) + CR) * CSPAN + (ox >> 1) + CR]);
    s_sad[off] = sad;
    s_mad[off] = mad;
    const int gx = x0 + px + ox, gy = py + oy;
    if (gx >= 0 && gx <= width - MB && gy >= 0 && gy <= height - MB) {
      const unsigned long long tail =
          (static_cast<unsigned long long>(ox * ox + oy * oy) << 11) | off;
      best_p = min(best_p, (static_cast<unsigned long long>(sad) << 21) | tail);
      if (mad < thr)
        best_c = min(best_c,
                     (static_cast<unsigned long long>(mad) << 21) | tail);
    }
  }
  best_p = warp_min(best_p);
  best_c = warp_min(best_c);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_red[0][warp] = best_p;
    s_red[1][warp] = best_c;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int i = 1; i < K2_THREADS / 32; ++i) {
    best_p = min(best_p, s_red[0][i]);
    best_c = min(best_c, s_red[1][i]);
  }
  // plain-branch running state starts at INT32_MAX, like the anchor's
  int p_ox = 0, p_oy = 0, p_sad = 0x7fffffff, p_mad = 0x7fffffff;
  if (best_p != NONE) {
    const int o = static_cast<int>(best_p & 2047);
    p_ox = o % SPAN - R;
    p_oy = o / SPAN - R;
    p_sad = s_sad[o];
    p_mad = s_mad[o];
  }
  const int co_sad = s_sad[CENTER], co_mad = s_mad[CENTER];
  const bool frozen = co_mad < thr;
  const bool use_copy = best_c != NONE && !frozen;
  int ox = p_ox, oy = p_oy, sad = p_sad, mad = p_mad;
  if (frozen) {
    ox = oy = 0;
    sad = co_sad;
    mad = co_mad;
  } else if (use_copy) {
    const int o = static_cast<int>(best_c & 2047);
    ox = o % SPAN - R;
    oy = o / SPAN - R;
    sad = s_sad[o];
    mad = s_mad[o];
  }
  const int n = bi * wb + bj;
  mx_o[n] = ox;
  my_o[n] = oy;
  sad_o[n] = sad;
  mad_o[n] = mad;
  frozen_o[n] = frozen ? 1 : 0;
}

}  // namespace

extern "C" int cairo_chroma_max_maps(const void* su, const void* sv,
                                     const void* ru, const void* rv, int h,
                                     int w, void* out, void* stream) {
  const dim3 grid(w / CB, h / CB);
  chroma_max_kernel<<<grid, K1_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(su), static_cast<const int*>(sv),
      static_cast<const int16_t*>(ru), static_cast<const int16_t*>(rv), h, w,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cairo_dense_select(const void* src, const void* ref,
                                  const void* cmax, const void* mad_thr,
                                  int h, int w, int x0, int width,
                                  int height, void* mx, void* my,
                                  void* sad, void* mad, void* frozen,
                                  void* stream) {
  const dim3 grid(w / MB, h / MB);
  dense_select_kernel<<<grid, K2_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), static_cast<const int16_t*>(ref),
      static_cast<const int*>(cmax), static_cast<const int*>(mad_thr), h, w,
      x0, width, height, static_cast<int*>(mx),
      static_cast<int*>(my), static_cast<int*>(sad), static_cast<int*>(mad),
      static_cast<uint8_t*>(frozen));
  return static_cast<int>(cudaGetLastError());
}
