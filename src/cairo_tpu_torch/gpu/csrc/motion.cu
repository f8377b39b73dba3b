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
// K1's design: one thread block per chroma block; the source block and
// the 24x24 reference window sit in shared memory as int32 and every
// thread evaluates whole offsets. Ring pixels are int16 and can leave
// 0..255 (recon overshoot), so the arithmetic is not byte SIMD.
//
// K2's design: what bounds it is arithmetic, 256 abs-diff-accumulates
// per offset per macroblock (~2.27 G per 1080p call) against ~22 MB of
// traffic. Three macroblocks share a block; each thread owns one dy and
// 11 consecutive dx of one macroblock (33 = 3 x 11, so 99 threads cover
// the 1089 offsets with no tail). For each of the 16 source rows it reads
// the source row once (uniform across the warp, 16-byte loads) and the
// 26-pixel window segment once, and does 11 x 16 abs-diffs from
// registers, so a shared load serves about 6 abs-diffs instead of half
// of one. The abs-diffs run in fp32: every value is an integer, the
// source planes lie in 0..255 (int16 range is enough) and the window is
// int16, so |src - ref| <= 65535 and a SAD is at most 256 x 65535 < 2^24,
// and every partial sum, |.| and max is exact in fp32. A step is then
// three FP32-pipe instructions, FADD, FADD with |.| folded as an operand
// modifier and FMNMX with |.| (confirmed in the SASS), against four int32
// ones before; each offset converts to int once. The window rows have an
// odd stride, so a warp's 32 consecutive dy hit distinct banks. Each
// thread keeps its best plain and copy-grade keys with the value the
// other field needs, and one warp per macroblock takes the block-wide
// minimum of the keys, unique by their scan index, with shuffles. K1's
// 289 chroma maxima for the block's macroblocks are staged in shared
// memory, and all staging loads are 16 bytes wide.
// The reference is a plain ring plane of the source's shape; reads
// outside it are zero, matching the anchor's zero padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MB = 16;
constexpr int R = 16;
constexpr int SPAN = 2 * R + 1;       // 33
constexpr int CENTER = R * SPAN + R;  // offset (0, 0)
constexpr int YWIN = MB + 2 * R;      // 48
constexpr int CB = 8;
constexpr int CR = 8;
constexpr int CSPAN = 2 * CR + 1;     // 17
constexpr int CNOFF = CSPAN * CSPAN;  // 289
constexpr int CWIN = CB + 2 * CR;     // 24
constexpr int K1_THREADS = 128;
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

// K2: K2_MBS macroblocks per block; thread t < K2_MBS * K2_UNITS owns
// macroblock t / K2_UNITS and, of it, unit u = t % K2_UNITS: the offsets
// dy = u % SPAN, dx in [K2_TILE * (u / SPAN), +K2_TILE).
constexpr int K2_TILE = 11;                   // SPAN = 3 x 11: no tail
constexpr int K2_UNITS = SPAN * SPAN / K2_TILE;   // 99 per macroblock
constexpr int K2_MBS = 3;
constexpr int K2_THREADS = (K2_MBS * K2_UNITS + 31) / 32 * 32;  // 320
constexpr int K2_RS = YWIN + 1;   // odd row stride: threads of a warp
                                  // (consecutive dy) hit distinct banks

__global__ void __launch_bounds__(K2_THREADS)
dense_select_kernel(const int* __restrict__ src,
                    const int16_t* __restrict__ ref,
                    const int* __restrict__ cmax,
                    const int* __restrict__ mad_thr_p, int h, int w,
                    int x0, int width, int height,
                    int* __restrict__ mx_o, int* __restrict__ my_o,
                    int* __restrict__ sad_o, int* __restrict__ mad_o,
                    uint8_t* __restrict__ frozen_o) {
  __shared__ __align__(16) float s_src[K2_MBS][MB * MB];
  __shared__ float s_ref[K2_MBS][YWIN * K2_RS];
  // per unit: its best plain key and that offset's MAD, its best
  // copy-grade key and that offset's SAD
  __shared__ unsigned long long s_kp[K2_MBS][K2_UNITS], s_kc[K2_MBS][K2_UNITS];
  __shared__ int s_pm[K2_MBS][K2_UNITS], s_cs[K2_MBS][K2_UNITS];
  __shared__ int s_co[K2_MBS][2];   // the co-located SAD and MAD
  __shared__ int s_cm[K2_MBS][CNOFF];  // K1's chroma maps
  const int t = threadIdx.x;
  const int wb = w / MB, nmb = (h / MB) * wb;
  const int n0 = blockIdx.x * K2_MBS;

  // ---- stage the blocks' sources and windows as floats (exact: every
  // value is an integer in int16 range), 16 bytes a load: a source row is
  // 4 loads, a window row 6 (px - 16 is a multiple of 16 and the width a
  // multiple of 16, so a chunk lies wholly inside or outside the plane)
  for (int i = t; i < K2_MBS * CNOFF; i += K2_THREADS) {
    const int n = n0 + i / CNOFF;
    s_cm[i / CNOFF][i % CNOFF] =
        n < nmb ? cmax[static_cast<size_t>(n0) * CNOFF + i] : 0;
  }
#pragma unroll 2
  for (int i = t; i < K2_MBS * MB * 4; i += K2_THREADS) {
    const int b = i / (MB * 4), r = (i / 4) % MB, q = i % 4;
    const int n = n0 + b;
    int4 v = make_int4(0, 0, 0, 0);
    if (n < nmb)
      v = *reinterpret_cast<const int4*>(
          src + static_cast<size_t>((n / wb) * MB + r) * w + (n % wb) * MB +
          4 * q);
    *reinterpret_cast<float4*>(&s_src[b][r * MB + 4 * q]) =
        make_float4(v.x, v.y, v.z, v.w);
  }
#pragma unroll 3
  for (int i = t; i < K2_MBS * YWIN * 6; i += K2_THREADS) {
    const int b = i / (YWIN * 6), r = (i / 6) % YWIN, q = i % 6;
    const int n = n0 + b;
    const int y = (n / wb) * MB - R + r, x = (n % wb) * MB - R + 8 * q;
    union {
      int4 v;
      int16_t e[8];
    } c;
    c.v = make_int4(0, 0, 0, 0);
    if (n < nmb && y >= 0 && y < h && x >= 0 && x < w)
      c.v = *reinterpret_cast<const int4*>(ref + static_cast<size_t>(y) * w +
                                           x);
    float* d = &s_ref[b][r * K2_RS + 8 * q];
#pragma unroll
    for (int j = 0; j < 8; ++j) d[j] = static_cast<float>(c.e[j]);
  }
  __syncthreads();

  const int b = t / K2_UNITS, u = t % K2_UNITS;
  const int n = n0 + b;
  const bool active = b < K2_MBS && n < nmb;
  const int dy = u % SPAN, dx0 = K2_TILE * (u / SPAN);
  const int thr = *mad_thr_p;
  float sad[K2_TILE], lmax[K2_TILE];
  if (active) {
    // ---- tile x 16 abs-diffs per source row from registers: fp32 add,
    // |.| and max on the FP32 pipe, exact below 2^24
#pragma unroll
    for (int k = 0; k < K2_TILE; ++k) sad[k] = lmax[k] = 0.f;
    const float* rp = s_ref[b] + dy * K2_RS + dx0;
    const float4* sp = reinterpret_cast<const float4*>(s_src[b]);
#pragma unroll 2
    for (int r = 0; r < MB; ++r) {
      float rv[MB + K2_TILE - 1];
#pragma unroll
      for (int j = 0; j < MB + K2_TILE - 1; ++j) rv[j] = rp[r * K2_RS + j];
      float sv[MB];
#pragma unroll
      for (int q = 0; q < MB / 4; ++q) {
        const float4 v = sp[r * (MB / 4) + q];
        sv[4 * q] = v.x; sv[4 * q + 1] = v.y;
        sv[4 * q + 2] = v.z; sv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int c = 0; c < MB; ++c) {
#pragma unroll
        for (int k = 0; k < K2_TILE; ++k) {
          const float d = sv[c] - rv[c + k];
          sad[k] += fabsf(d);
          lmax[k] = fmaxf(lmax[k], fabsf(d));
        }
      }
    }

    // ---- per offset: MAD with K1's chroma map, the packed keys
    const int bi = n / wb, bj = n % wb;
    const int py = bi * MB, px = bj * MB;
    const int* cm = s_cm[b];
    const int oy = dy - R;
    const bool y_ok = py + oy >= 0 && py + oy <= height - MB;
    unsigned long long best_p = NONE, best_c = NONE;
    int p_mad = 0, c_sad = 0;
#pragma unroll
    for (int k = 0; k < K2_TILE; ++k) {
      const int ox = dx0 + k - R, off = dy * SPAN + dx0 + k;
      const int isad = static_cast<int>(sad[k]);
      const int imad = max(static_cast<int>(lmax[k]),
                           cm[((oy >> 1) + CR) * CSPAN + (ox >> 1) + CR]);
      if (off == CENTER) {
        s_co[b][0] = isad;
        s_co[b][1] = imad;
      }
      const int gx = x0 + px + ox;
      if (y_ok && gx >= 0 && gx <= width - MB) {
        const unsigned long long tail =
            (static_cast<unsigned long long>(ox * ox + oy * oy) << 11) | off;
        const unsigned long long kp =
            (static_cast<unsigned long long>(isad) << 21) | tail;
        if (kp < best_p) {
          best_p = kp;
          p_mad = imad;
        }
        const unsigned long long kc =
            (static_cast<unsigned long long>(imad) << 21) | tail;
        if (imad < thr && kc < best_c) {
          best_c = kc;
          c_sad = isad;
        }
      }
    }
    s_kp[b][u] = best_p;
    s_kc[b][u] = best_c;
    s_pm[b][u] = p_mad;
    s_cs[b][u] = c_sad;
  }
  __syncthreads();

  // ---- warp b resolves macroblock b: the least keys (unique, as each
  // holds its scan index) and the values that ride with them
  const int warp = t >> 5, lane = t & 31;
  if (warp >= K2_MBS || n0 + warp >= nmb) return;
  unsigned long long kp = NONE, kc = NONE;
  int pm = 0, cs = 0;
  for (int i = lane; i < K2_UNITS; i += 32) {
    if (s_kp[warp][i] < kp) {
      kp = s_kp[warp][i];
      pm = s_pm[warp][i];
    }
    if (s_kc[warp][i] < kc) {
      kc = s_kc[warp][i];
      cs = s_cs[warp][i];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long okp = __shfl_xor_sync(0xffffffffu, kp, o);
    const int opm = __shfl_xor_sync(0xffffffffu, pm, o);
    const unsigned long long okc = __shfl_xor_sync(0xffffffffu, kc, o);
    const int ocs = __shfl_xor_sync(0xffffffffu, cs, o);
    if (okp < kp) {
      kp = okp;
      pm = opm;
    }
    if (okc < kc) {
      kc = okc;
      cs = ocs;
    }
  }
  if (lane != 0) return;
  const int m = n0 + warp;
  // plain-branch running state starts at INT32_MAX, like the anchor's
  int ox = 0, oy = 0, sad_v = 0x7fffffff, mad_v = 0x7fffffff;
  if (kp != NONE) {
    const int o = static_cast<int>(kp & 2047);
    ox = o % SPAN - R;
    oy = o / SPAN - R;
    sad_v = static_cast<int>(kp >> 21);
    mad_v = pm;
  }
  const bool frozen = s_co[warp][1] < thr;
  if (frozen) {
    ox = oy = 0;
    sad_v = s_co[warp][0];
    mad_v = s_co[warp][1];
  } else if (kc != NONE) {
    const int o = static_cast<int>(kc & 2047);
    ox = o % SPAN - R;
    oy = o / SPAN - R;
    sad_v = cs;
    mad_v = static_cast<int>(kc >> 21);
  }
  mx_o[m] = ox;
  my_o[m] = oy;
  sad_o[m] = sad_v;
  mad_o[m] = mad_v;
  frozen_o[m] = frozen ? 1 : 0;
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
  const int n = (h / MB) * (w / MB);
  dense_select_kernel<<<(n + K2_MBS - 1) / K2_MBS, K2_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), static_cast<const int16_t*>(ref),
      static_cast<const int*>(cmax), static_cast<const int*>(mad_thr), h, w,
      x0, width, height, static_cast<int*>(mx),
      static_cast<int*>(my), static_cast<int*>(sad), static_cast<int*>(mad),
      static_cast<uint8_t*>(frozen));
  return static_cast<int>(cudaGetLastError());
}
