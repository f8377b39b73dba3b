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
// K1's design: what bounds it on this card is arithmetic, 289 offsets x
// 64 pixels x 2 planes abs-diffs per chroma block, about 0.30 G per 1080p
// call (9 us at one op per lane per clock) against some 16 MB of traffic.
// A block takes a run of K1_RUN = 32 chroma blocks, one per lane, and
// warp dy (0..16) takes offset row dy - 8 and all 17 dx of its lane's
// block, so the 289 offsets tile with no idle tail round. Runs follow the
// flat (hb, wb) order and may cross into the next block row, so a 1080p
// call is 255 blocks, all resident at once at two an SM, where runs of
// one row would make 272 and a second, almost empty round (which cost a
// quarter of the time on the card). Each run stages its reference strips,
// rows [8 bi - 8, 8 bi + 16) of each block row it touches with 8 columns
// of margin each side, 16 bytes a load (a chunk starts at a multiple of 8
// columns and the plane width is a multiple of 8, so it lies wholly
// inside or outside the plane; outside is zero, the anchor's padding),
// and its source blocks, once. For each source row a thread reads the
// 24-pixel window row segment once into registers and does 8 x 17
// abs-diffs from them, so a shared load serves about 6 abs-diffs instead
// of half of one. Strip column c is stored at c + c / 8, so the lanes of
// a load, one chroma block (8 columns) apart, fall 9 banks apart. The
// abs-diffs run in fp32, FADD and FMNMX with |.| folded, two instructions
// each (the SASS holds exactly that): the source chroma lies in int16
// range (0..255 in the codec) and the reference is int16, so |src - ref|
// <= 65535 and every difference, |.| and max is exact. The 289 maxima of
// each block go out through shared memory, as one contiguous, coalesced
// range of the (hb, wb, 289) layout. Ring pixels are int16 and can leave
// 0..255 (recon overshoot), so the arithmetic is not byte SIMD.
// On NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, 1080p): 0.033 ms of
// device time against 0.11 ms for the design this one replaced (one
// 128-thread block per chroma block, 152 registers); 56 registers, no
// spill. FMNMX issues at half the FADD rate on this card, so the floor of
// this instruction mix is about 19 us.
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
//
// Both take the reference with a margin of its own: (H, W + 2 margin),
// read at column x + margin for source column x; reads outside it are
// zero, matching the anchor's zero padding. A single-card ring plane has
// margin 0; a tile's ring plane (gpu/shard.py) carries its neighbours'
// columns in a margin of 32 luma and 16 chroma columns, which the reach
// (16 luma, 8 chroma) never leaves, so reading the wide plane in place
// gives what the anchor's hmargin cut gives. A staged chunk starts at a
// multiple of 8 reference columns as long as the margin is a multiple of
// 8 (the wrappers check it), so it still lies wholly inside or outside
// the plane.

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
constexpr unsigned long long NONE = ~0ull;

// K1: a run of up to K1_RUN chroma blocks, consecutive in the flat (hb, wb)
// order, per thread block, one per lane; warp dy takes the offsets
// (dy - 8, -8 .. 8) of its lane's block. A run spans at most two block
// rows (segments): a frame narrower than K1_RUN blocks takes runs of one
// row, wb blocks long. Segment 0 holds the run's blocks in block row bi0,
// at strip columns [0, 8 na + 16), plane columns [8 bj0 - 8, 8 (bj0 + na)
// + 8); segment 1 the rest, in row bi0 + 1, from strip column 8 na + 16,
// plane columns [-8, 8 (nb - na) + 8). Lane b's window is strip columns
// [8 b + 16 seg(b), + 24).
constexpr int K1_RUN = 32;
constexpr int K1_THREADS = 32 * CSPAN;          // 544
constexpr int K1_COLS = CB * K1_RUN + 4 * CR;   // 288 strip columns

// shared-memory column of strip column c: lanes one chroma block (8
// columns) apart fall 9 banks apart
__host__ __device__ constexpr int k1_col(int c) { return c + (c >> 3); }

struct K1Smem {
  union {
    struct {
      float win[2][CWIN][k1_col(K1_COLS)];   // U, V reference strips
      float src[2][CB][CB][K1_RUN];          // U, V source: [row][col][lane]
    } in;
    int out[K1_RUN * CNOFF];                 // the run's maps
  };
};

__global__ void __launch_bounds__(K1_THREADS, 2)
chroma_max_kernel(const int* __restrict__ su, const int* __restrict__ sv,
                  const int16_t* __restrict__ ru,
                  const int16_t* __restrict__ rv, int h, int w, int margin,
                  int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char k1_raw[];
  K1Smem& s = *reinterpret_cast<K1Smem*>(k1_raw);
  const int t = threadIdx.x;
  const int wb = w / CB, nblk = (h / CB) * wb;
  const int run = min(K1_RUN, wb);
  const int n0 = blockIdx.x * run;
  const int nb = min(run, nblk - n0);          // blocks of this run
  const int bi0 = n0 / wb, bj0 = n0 % wb;
  const int na = min(nb, wb - bj0);            // of them in row bi0
  const int nq0 = na + 2;                      // segment 0's 8-column chunks
  const int nq = nq0 + (nb > na ? nb - na + 2 : 0);
  const int rw = w + 2 * margin;               // the reference's row pitch

  // ---- stage the reference strips (8-column chunks) and the lanes'
  // source blocks (4-column chunks) as floats
  for (int i = t; i < CWIN * nq; i += K1_THREADS) {
    const int r = i / nq, q = i % nq;
    const bool seg1 = q >= nq0;
    const int y = CB * (bi0 + seg1) - CR + r;
    const int x =
        (seg1 ? CB * (q - nq0) - CR : CB * (bj0 + q) - CR) + margin;
    union {
      int4 v;
      int16_t e[8];
    } cu, cv;
    cu.v = cv.v = make_int4(0, 0, 0, 0);
    if (y >= 0 && y < h && x >= 0 && x < rw) {
      const size_t o = static_cast<size_t>(y) * rw + x;
      cu.v = *reinterpret_cast<const int4*>(ru + o);
      cv.v = *reinterpret_cast<const int4*>(rv + o);
    }
    float* du = &s.in.win[0][r][k1_col(CB * q)];
    float* dv = &s.in.win[1][r][k1_col(CB * q)];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      du[j] = static_cast<float>(cu.e[j]);
      dv[j] = static_cast<float>(cv.e[j]);
    }
  }
  for (int i = t; i < CB * nb * 2; i += K1_THREADS) {
    const int r = i / (2 * nb), b = i % (2 * nb) / 2, c0 = 4 * (i % 2);
    const int n = n0 + b;
    const size_t o =
        static_cast<size_t>(CB * (n / wb) + r) * w + CB * (n % wb) + c0;
    const int4 a = *reinterpret_cast<const int4*>(su + o);
    const int4 e = *reinterpret_cast<const int4*>(sv + o);
    float(*pu)[K1_RUN] = s.in.src[0][r] + c0;
    float(*pv)[K1_RUN] = s.in.src[1][r] + c0;
    pu[0][b] = static_cast<float>(a.x);
    pu[1][b] = static_cast<float>(a.y);
    pu[2][b] = static_cast<float>(a.z);
    pu[3][b] = static_cast<float>(a.w);
    pv[0][b] = static_cast<float>(e.x);
    pv[1][b] = static_cast<float>(e.y);
    pv[2][b] = static_cast<float>(e.z);
    pv[3][b] = static_cast<float>(e.w);
  }
  __syncthreads();

  // ---- 17 offsets per thread from registers: fp32 sub, |.| and max,
  // exact in the stated domain
  const int dy = t >> 5, b = t & 31;
  float m[CSPAN];
#pragma unroll
  for (int k = 0; k < CSPAN; ++k) m[k] = 0.f;
  if (b < nb) {
    // k1_col(8 b + 16 seg + j) = 9 b + 18 seg + j + j / 8 for j < 24
    const int base = 9 * b + (b >= na ? 18 : 0);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll 2
      for (int r = 0; r < CB; ++r) {
        const float* wr = &s.in.win[p][dy + r][base];
        float wv[CB + CSPAN - 1];
#pragma unroll
        for (int j = 0; j < CB + CSPAN - 1; ++j) wv[j] = wr[j + (j >> 3)];
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          const float x = s.in.src[p][r][c][b];
#pragma unroll
          for (int k = 0; k < CSPAN; ++k)
            m[k] = fmaxf(m[k], fabsf(x - wv[c + k]));
        }
      }
    }
  }
  __syncthreads();   // the strips are done with: the maps reuse them

  // ---- the run's maps are one contiguous range of the output
  if (b < nb) {
#pragma unroll
    for (int k = 0; k < CSPAN; ++k)
      s.out[b * CNOFF + dy * CSPAN + k] = static_cast<int>(m[k]);
  }
  __syncthreads();
  int* o = out + static_cast<size_t>(n0) * CNOFF;
  for (int i = t; i < nb * CNOFF; i += K1_THREADS) o[i] = s.out[i];
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
                    int margin, int x0, int width, int height,
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
  const int rw = w + 2 * margin;   // the reference's row pitch

  // ---- stage the blocks' sources and windows as floats (exact: every
  // value is an integer in int16 range), 16 bytes a load: a source row is
  // 4 loads, a window row 6 (px - 16 + margin is a multiple of 8 and the
  // reference's width a multiple of 8, so a chunk lies wholly inside or
  // outside the plane)
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
    const int y = (n / wb) * MB - R + r;
    const int x = (n % wb) * MB - R + 8 * q + margin;
    union {
      int4 v;
      int16_t e[8];
    } c;
    c.v = make_int4(0, 0, 0, 0);
    if (n < nmb && y >= 0 && y < h && x >= 0 && x < rw)
      c.v = *reinterpret_cast<const int4*>(ref + static_cast<size_t>(y) * rw +
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
                                     int w, int margin, void* out,
                                     void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      chroma_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(K1Smem)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int wb = w / CB, run = wb < K1_RUN ? wb : K1_RUN;
  const int grid = ((h / CB) * wb + run - 1) / run;
  chroma_max_kernel<<<grid, K1_THREADS, sizeof(K1Smem),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(su), static_cast<const int*>(sv),
      static_cast<const int16_t*>(ru), static_cast<const int16_t*>(rv), h, w,
      margin, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cairo_dense_select(const void* src, const void* ref,
                                  const void* cmax, const void* mad_thr,
                                  int h, int w, int margin, int x0,
                                  int width,
                                  int height, void* mx, void* my,
                                  void* sad, void* mad, void* frozen,
                                  void* stream) {
  const int n = (h / MB) * (w / MB);
  dense_select_kernel<<<(n + K2_MBS - 1) / K2_MBS, K2_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), static_cast<const int16_t*>(ref),
      static_cast<const int*>(cmax), static_cast<const int*>(mad_thr), h, w,
      margin, x0, width, height, static_cast<int*>(mx),
      static_cast<int*>(my), static_cast<int*>(sad), static_cast<int*>(mad),
      static_cast<uint8_t*>(frozen));
  return static_cast<int>(cudaGetLastError());
}
