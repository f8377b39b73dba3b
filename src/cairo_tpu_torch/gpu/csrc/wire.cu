// The 5-bit-delta source wire's unpack for Hopper (sm_90a): K12
// unpack_yuv5d.
//
// It replaces no Pallas kernel. On the TPU cairo_tpu/tpu/wire.py
// unpack_yuv5d runs inside the jit of each encode step and XLA fuses it:
// the 32 field extractions of each 5-word group, the exception scatter
// (mode="drop"), the per-plane column-0 vertical cumsum and the row
// cumsums, and the luma frame mask. The port issued each as torch ops,
// some 137 launches a frame (gpu/wire.py unpack_yuv5d_plain), and the
// conformance step 5 more for its source blocks and self_sad. K12 does
// all of it in one launch, exactly as the plain versions do:
//   * the wire after its 8-byte header: EXC_K int32 exception positions,
//     EXC_K int16 values, then groups of 5 little-endian words holding 32
//     fields each; field g is stream bits [5g, 5g + 5), sign-extended;
//   * an exception sets the delta at its position: a negative position
//     counts from the end of the ah*aw*3/2 fields, a position still
//     outside them is dropped (the sentinels among them), and where one
//     position is listed twice the later entry wins, as JAX's scatter
//     leaves it (the native packer lists a position once);
//   * each plane's value at (y, x) is the int32 sum, wrapping, of the
//     column-0 deltas of rows 0..y and the deltas of row y at columns
//     1..x; luma in the frame takes +16, luma outside it 0.
// The layout is a template parameter: PLANES, the (ah, aw) and
// (ah/2, aw/2) int32 planes engine.encode_step reads; BLOCKS, the
// conformance step's (N, 16, 16) and (N, 8, 8) int32 source blocks in
// raster MB order and self_sad (N,), the wrapping int32 sum of |Y| of
// each MB (gpu/wavefront.py).
//
// What bounds it on this card: bytes. At 1080p it reads the 2.0 MB wire
// (the exception section 48 KB) and writes 12.5 MB of int32 samples, some
// 4.4 us at 3.35 TB/s; the arithmetic is a few integer operations a
// sample. A prefix sum over a whole plane does not split across blocks
// without a pass between them, so the design makes each block's start
// values its own work, and reads what it shares with other blocks from
// L2 (the exception list, a column of fields) rather than waiting on them:
//   * one block of 1024 threads per MB row: warp k scans row k of the
//     band (16 luma rows, 8 U, 8 V), so the BLOCKS layout's MBs and their
//     self_sad lie in one block and no block waits on another;
//   * a band's column-0 start values: each block sums the column-0 fields
//     of every row above its band itself (at most ah + ah/2 of them a
//     frame, two a thread at 1080p), then corrects the sum by each
//     column-0 exception above the band that no later entry overrides;
//   * the exceptions: each block reads the list from L2, 8 entries a
//     thread loaded at once and kept in registers, counts the entries
//     that fall in its band per row, and files them by row in shared
//     memory as (column << 13 | entry). A row's warp loads its
//     entries 32 at a time and, per 128-column step, a ballot picks those
//     in the step; the lane holding the column keeps the latest entry. A
//     row without exceptions (most rows) skips all of this;
//   * the scan: a lane takes 4 adjacent columns per step (20 bits of the
//     wire from one or two word loads, issued three steps ahead, the
//     first three before the exception passes, whose latency they share:
//     a block's time is mostly waiting on loads, not bandwidth), sums
//     them, and a 5-shuffle warp scan and a carry give each its prefix;
//     one 16-byte store per lane, so a warp's step stores 512 contiguous
//     bytes in PLANES and whole 32-byte sectors of MB rows in BLOCKS;
//   * self_sad: the 4 lanes of an MB's columns reduce by shuffles and add
//     into a shared count per MB (integer adds, so the order the warps
//     take does not change the sum); the block writes them at its end.
// Nothing depends on the order in which blocks or warps finish: every sum
// is an integer sum modulo 2^32, and a duplicate exception is resolved by
// its entry index, not by which thread saw it first.

#include "common.cuh"

namespace {

using namespace cairo;

constexpr int EXC_K = 8192;     // gpu/wire.py UP_EXC_K
constexpr int IDX_BITS = 13;    // an exception's entry index, < EXC_K
constexpr int IDX_MASK = (1 << IDX_BITS) - 1;
constexpr int ROWS = 32;        // a band: 16 luma rows, 8 U, 8 V
constexpr int THREADS = 32 * ROWS;
constexpr int STEP = 128;       // columns a warp scans per step
constexpr int AHEAD = 3;        // steps of a row's wire loaded ahead
constexpr int PER_THREAD = EXC_K / THREADS;   // exception entries a thread
constexpr int COL_BITS = 14;    // a column, < 16384 (the widest frame)
constexpr int COL_MASK = (1 << COL_BITS) - 1;

static_assert(EXC_K <= (1 << IDX_BITS), "an entry index fits its bits");
static_assert(EXC_K % THREADS == 0, "whole entries a thread");

enum Layout { PLANES = 0, BLOCKS = 1 };

struct Geo {
  int aw, cw;              // luma and chroma widths
  int ys, cs, total;       // luma and chroma plane sizes, all the fields
  int wb;                  // MBs a row
  int frame_w, frame_h;
};

// the plane, row and column of field p, 0 <= p < total
struct Cell {
  int plane, row, col;
};

__device__ __forceinline__ Cell locate(const Geo& g, int p) {
  int off = p, w = g.aw, plane = 0;
  if (p >= g.ys) {
    off -= g.ys;
    w = g.cw;
    plane = 1;
    if (off >= g.cs) {
      off -= g.cs;
      plane = 2;
    }
  }
  const int row = off / w;
  return Cell{plane, row, off - row * w};
}

// the band row of block j that holds (plane, row), or -1
__device__ __forceinline__ int band_row(int plane, int row, int j) {
  if (plane == 0) {
    const int k = row - MB * j;
    return static_cast<unsigned>(k) < MB ? k : -1;
  }
  const int k = row - (MB / 2) * j;
  return static_cast<unsigned>(k) < MB / 2 ? MB / 2 + (MB / 2) * plane + k
                                           : -1;
}

// an exception position as the scatter takes it: counted from the end
// when negative; -1 where it is dropped
__device__ __forceinline__ int normalized(int p, int total) {
  if (p < 0) p += total;   // no wrap: total < 2^31
  return static_cast<unsigned>(p) < static_cast<unsigned>(total) ? p : -1;
}

__device__ __forceinline__ int sext5(unsigned raw) {
  return static_cast<int>((raw & 31u) ^ 16u) - 16;
}

// the sign-extended field g
__device__ __forceinline__ int field5(const uint32_t* __restrict__ words,
                                      unsigned g) {
  const unsigned bit = 5u * g, k = bit >> 5, s = bit & 31u;
  unsigned raw = __ldg(words + k) >> s;
  if (s > 27) raw |= __ldg(words + k + 1) << (32 - s);
  return sext5(raw);
}

// bits 5g .. 5g + 19 of the stream (fields g .. g + 3) at bit 0; the
// second word only where they reach it, so never past the last word
__device__ __forceinline__ unsigned long long bits20(
    const uint32_t* __restrict__ words, unsigned g) {
  const unsigned bit = 5u * g, k = bit >> 5, s = bit & 31u;
  unsigned long long w = __ldg(words + k);
  if (s > 12) w |= static_cast<unsigned long long>(__ldg(words + k + 1)) << 32;
  return w >> s;
}

__device__ __forceinline__ unsigned warp_inclusive(unsigned v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// abs as torch's int32 abs: abs(INT32_MIN) == INT32_MIN
__device__ __forceinline__ unsigned abs_w(int v) {
  return v < 0 ? 0u - static_cast<unsigned>(v) : static_cast<unsigned>(v);
}

template <int LAYOUT>
__global__ void __launch_bounds__(THREADS, 1)
unpack_yuv5d_kernel(const uint8_t* __restrict__ wire, Geo g,
                    int* __restrict__ out_y, int* __restrict__ out_u,
                    int* __restrict__ out_v, int* __restrict__ self_sad) {
  // entries: first the column-0 exceptions above the band, then the
  // band's exceptions filed by row; then (BLOCKS) the band's self_sad
  extern __shared__ int smem[];
  int* list = smem;
  unsigned* sad = reinterpret_cast<unsigned*>(smem + EXC_K);
  __shared__ int row_count[ROWS], row_start[ROWS + 1], row_fill[ROWS];
  __shared__ int c0d[ROWS];
  __shared__ unsigned part[ROWS][3], band_sum[3];
  __shared__ int n_cand;

  const int* __restrict__ exc_pos = reinterpret_cast<const int*>(wire);
  const int16_t* __restrict__ exc_val =
      reinterpret_cast<const int16_t*>(wire + 4 * EXC_K);
  const uint32_t* __restrict__ words =
      reinterpret_cast<const uint32_t*>(wire + 6 * EXC_K);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = blockIdx.x;

  // warp k scans row k of the band; the wire of its first steps and its
  // column-0 field are loaded first, to arrive during the passes below
  const int k = warp;
  const int plane = k < MB ? 0 : (k < MB + MB / 2 ? 1 : 2);
  const int first = plane == 0 ? 0 : MB / 2 + (MB / 2) * plane;
  const int yb = k - first;                       // the row within the MB
  const int y = (plane == 0 ? MB : MB / 2) * j + yb;
  const int w = plane == 0 ? g.aw : g.cw;
  const unsigned fb = static_cast<unsigned>(
      plane == 0 ? 0 : g.ys + (plane - 1) * g.cs) +
      static_cast<unsigned>(y) * w;
  unsigned long long ahead[AHEAD];
#pragma unroll
  for (int a = 0; a < AHEAD; ++a) {
    const int x = a * STEP + 4 * lane;
    ahead[a] = x < w ? bits20(words, fb + x) : 0;
  }
  const int f0 = field5(words, fb);

  if (tid < ROWS) {
    row_count[tid] = 0;
    row_fill[tid] = 0;
  }
  if (tid == 0) n_cand = 0;
  if (LAYOUT == BLOCKS) {
    for (int i = tid; i < g.wb; i += THREADS) sad[i] = 0;
  }
  __syncthreads();

  // pass 1: count the band's exceptions per row, keeping each thread's
  // as (band row, column) for pass 2; list the column-0 ones above the
  // band; sum the column-0 fields above the band per plane
  int pos[PER_THREAD], filed[PER_THREAD];
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    pos[q] = __ldg(exc_pos + tid + q * THREADS);
  }
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    filed[q] = -1;
    const int p = normalized(pos[q], g.total);
    if (p < 0) continue;
    const Cell c = locate(g, p);
    const int kk = band_row(c.plane, c.row, j);
    if (kk >= 0) {
      atomicAdd(&row_count[kk], 1);
      filed[q] = (kk << COL_BITS) | c.col;
    } else if (c.col == 0 && c.row < (c.plane ? MB / 2 : MB) * j) {
      list[atomicAdd(&n_cand, 1)] = tid + q * THREADS;
    }
  }
  unsigned above[3] = {0, 0, 0};
#pragma unroll 4
  for (int t = tid; t < 2 * MB * j; t += THREADS) {
    if (t < MB * j) {
      above[0] += field5(words, static_cast<unsigned>(t) * g.aw);
    } else {
      const bool u = t < (MB + MB / 2) * j;   // else V
      const int row = t - (u ? MB : MB + MB / 2) * j;
      const unsigned f = field5(
          words, static_cast<unsigned>(g.ys + (u ? 0 : g.cs)) +
                     static_cast<unsigned>(row) * g.cw);
      above[1] += u ? f : 0;   // constant indices: above stays in registers
      above[2] += u ? 0 : f;
    }
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    above[q] = warp_sum(above[q]);
    if (lane == 0) part[warp][q] = above[q];
  }
  __syncthreads();

  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const unsigned s = warp_sum(part[lane][q]);
      if (lane == 0) band_sum[q] = s;
    }
  } else if (warp == 1) {
    const int n = row_count[lane];
    const int incl = static_cast<int>(warp_inclusive(n, lane));
    row_start[lane] = incl - n;
    if (lane == 31) row_start[ROWS] = incl;
  }
  __syncthreads();

  // the column-0 exceptions above the band: each that no later entry
  // overrides replaces its field in the band's start sum
  for (int c = tid; c < n_cand; c += THREADS) {
    const int i = list[c];
    const int p = normalized(__ldg(exc_pos + i), g.total);
    bool overridden = false;
    for (int c2 = 0; c2 < n_cand && !overridden; ++c2) {
      const int i2 = list[c2];
      overridden = i2 > i && normalized(__ldg(exc_pos + i2), g.total) == p;
    }
    if (!overridden) {
      atomicAdd(&band_sum[locate(g, p).plane],
                static_cast<unsigned>(__ldg(exc_val + i) -
                                      field5(words, static_cast<unsigned>(p))));
    }
  }
  __syncthreads();

  // pass 2: file the band's exceptions by row
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    if (filed[q] >= 0) {
      const int kk = filed[q] >> COL_BITS;
      list[row_start[kk] + atomicAdd(&row_fill[kk], 1)] =
          ((filed[q] & COL_MASK) << IDX_BITS) | (tid + q * THREADS);
    }
  }
  __syncthreads();

  const int e0 = row_start[k], n_exc = row_start[k + 1] - e0;

  // the row's column-0 delta, for the start values of its rows and those
  // below
  int latest = -1;
  for (int e = lane; e < n_exc; e += 32) {
    const int key = list[e0 + e];
    if ((key >> IDX_BITS) == 0) latest = max(latest, key & IDX_MASK);
  }
  latest = __reduce_max_sync(FULL, latest);
  if (lane == 0) c0d[k] = latest >= 0 ? __ldg(exc_val + latest) : f0;
  __syncthreads();

  unsigned carry = band_sum[plane];
  for (int r = first; r <= k; ++r) carry += static_cast<unsigned>(c0d[r]);

  int* out = plane == 0 ? out_y : (plane == 1 ? out_u : out_v);
  for (int x0 = 0; x0 < w; x0 += STEP) {
    const int x = x0 + 4 * lane;
    const bool on = x < w;
    const unsigned long long cur = ahead[0];
#pragma unroll
    for (int a = 0; a + 1 < AHEAD; ++a) ahead[a] = ahead[a + 1];
    const int xn = x + AHEAD * STEP;
    ahead[AHEAD - 1] = xn < w ? bits20(words, fb + xn) : 0;
    int d[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      d[q] = on ? sext5(static_cast<unsigned>(cur >> (5 * q))) : 0;
    }
    if (x == 0) d[0] = 0;   // column 0's delta is in the start value
    if (n_exc) {
      int best[4] = {-1, -1, -1, -1};
      const int lo = x0 > 0 ? x0 : 1;
      for (int c = 0; c < n_exc; c += 32) {
        const int key = c + lane < n_exc ? list[e0 + c + lane] : -1;
        const int col = key >> IDX_BITS;
        unsigned hit =
            __ballot_sync(FULL, key >= 0 && col >= lo && col < x0 + STEP);
        while (hit) {
          const int key_e = __shfl_sync(FULL, key, __ffs(hit) - 1);
          hit &= hit - 1;
          const int dc = (key_e >> IDX_BITS) - x;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (dc == q) best[q] = max(best[q], key_e & IDX_MASK);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (best[q] >= 0) d[q] = __ldg(exc_val + best[q]);
      }
    }
    unsigned s[4];
    s[0] = static_cast<unsigned>(d[0]);
#pragma unroll
    for (int q = 1; q < 4; ++q) s[q] = s[q - 1] + static_cast<unsigned>(d[q]);
    const unsigned incl = warp_inclusive(s[3], lane);
    const unsigned base = carry + incl - s[3];
    carry += __shfl_sync(FULL, incl, 31);
    int v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = static_cast<int>(base + s[q]);
      if (plane == 0) {
        v[q] = y < g.frame_h && x + q < g.frame_w ? add_w(v[q], 16) : 0;
      }
    }
    size_t o;
    if (LAYOUT == PLANES) {
      o = static_cast<size_t>(y) * w + x;
    } else if (plane == 0) {
      o = (static_cast<size_t>(j * g.wb + (x >> 4)) * MB + yb) * MB + (x & 15);
    } else {
      o = (static_cast<size_t>(j * g.wb + (x >> 3)) * (MB / 2) + yb) *
              (MB / 2) + (x & 7);
    }
    if (on) *reinterpret_cast<int4*>(out + o) = make_int4(v[0], v[1], v[2], v[3]);
    if (LAYOUT == BLOCKS && plane == 0) {
      unsigned a =
          on ? abs_w(v[0]) + abs_w(v[1]) + abs_w(v[2]) + abs_w(v[3]) : 0;
      a += __shfl_xor_sync(FULL, a, 1);
      a += __shfl_xor_sync(FULL, a, 2);
      if (on && (lane & 3) == 0) atomicAdd(&sad[x >> 4], a);
    }
  }

  if (LAYOUT == BLOCKS) {
    __syncthreads();
    for (int i = tid; i < g.wb; i += THREADS) {
      self_sad[j * g.wb + i] = static_cast<int>(sad[i]);
    }
  }
}

}  // namespace

// ah, aw: the aligned luma dims (multiples of 16, aw at most 16384, so a
// band's self_sad and its entries fit 48 KB of shared memory and a
// column fits its key); layout 0 PLANES, 1 BLOCKS (self_sad unused in
// PLANES)
extern "C" int cairo_unpack_yuv5d(const void* wire, int ah, int aw,
                                  int frame_w, int frame_h, int layout,
                                  void* out_y, void* out_u, void* out_v,
                                  void* self_sad, void* stream) {
  const int cw = aw / 2, ys = ah * aw, cs = (ah / 2) * cw;
  const Geo g{aw, cw, ys, cs, ys + 2 * cs, aw / MB, frame_w, frame_h};
  const size_t smem = (EXC_K + (layout == BLOCKS ? g.wb : 0)) * sizeof(int);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint8_t*>(wire);
  auto *y = static_cast<int*>(out_y), *u = static_cast<int*>(out_u),
       *v = static_cast<int*>(out_v), *sad = static_cast<int*>(self_sad);
  if (layout == PLANES) {
    unpack_yuv5d_kernel<PLANES><<<ah / MB, THREADS, smem, s>>>(w, g, y, u, v,
                                                               sad);
  } else if (layout == BLOCKS) {
    unpack_yuv5d_kernel<BLOCKS><<<ah / MB, THREADS, smem, s>>>(w, g, y, u, v,
                                                               sad);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
