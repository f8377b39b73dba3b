// Prediction-gather kernels for Hopper (sm_90a): K3 and K4.
//
// K3 gather_windows replaces cairo_tpu/tpu/pallas_pred.py gather_windows
// (_win_kernel): per-MB (B x B) int32 windows at window offset
// clamp(m + pad - 1, 0, 2*pad - 2) from one ring slot, where the slot is
// a device scalar read by the kernel (never synchronised to the host);
// reads outside the plane are zero, as the anchor's zero-padded windows
// give. B is 18 with pad 17 for luma, 10 with pad 9 for chroma. The fast
// inter search needs all three planes' windows of one reference, chroma
// at (mx >> 1, my >> 1): one launch does Y, U and V
// (cairo_gather_windows_yuv); cairo_gather_windows runs the same kernel
// over one plane.
//
// K4 pred_planes replaces pallas_pred.py pred_planes (_pred_kernel): the
// prediction planes for every macroblock. Each MB reads its ring slot,
// a base block at its clamped motion offset and, for sub-pel MBs, the
// neighbour at (mx+di, my+dj); applies the exact half or quarter lerp of
// ops.lerp_half / lerp_quarter; INTRA_DEFAULT blocks (`zero`) and slots
// outside the ring are 0. The offsets clamp to the window pads: [0,
// 2*pad] around -pad, as extract.extract_blocks clips to a window of that
// pad. The fast mode passes 17/9 (luma/chroma); the conformance encoder
// 33/17, the reference's +-31 full-pel reach plus 1 sub-pel
// (wavefront.py:733-780). One launch covers the Y, U and V planes.
//
// The three-plane K3 launch and K4 read a ring with a halo: (RING, H,
// W + 2 halo) luma and (RING, H/2, W/2 + halo) chroma, where the windows
// and prediction planes are those of the (H, W) core, whose column x is
// ring column x + halo (x + halo/2 in chroma), as extract.mb_windows(
// prepad_x=halo) cuts them. A single-card ring has halo 0; a tile's ring
// (gpu/shard.py) carries its neighbours' deblocked columns there, 32
// luma and 16 chroma. Reads outside the ring plane are zero, as before.
//
// What bounds both on this card is bytes: at 1080p a three-plane K3
// launch reads the slot's planes (6.3 MB) and the offsets once and writes
// 17.1 MB of windows, 23.4 MB in all, 7.0 us at 3.35 TB/s; a K4 call
// reads about 5 MB of ring samples (one per predicted pixel) and its
// fields (four int32 and three byte flags an MB) and writes 12.5 MB of
// planes, 17.7 MB, 5.3 us. The arithmetic is a few integer operations a sample. The
// design this one replaces ran one thread per output sample with 64-bit
// division by run-time divisors for its (MB, row, column), seven field
// loads per K4 sample and one 4-byte store each, at a sixth of these
// bounds; K3 ran three launches a reference, one per plane.
//
// Both now give one thread four consecutive output samples, one 16-byte
// store, with every index in 32 bits and every divisor but the MB-row
// width a compile-time constant (the window and pad sizes are template
// parameters). Consecutive threads take consecutive groups of one MB, so
// the lanes of a warp share the MB's fields (broadcast loads) and its
// clamped origin. A K3 window is B*B = 324 or 100 samples, a whole number
// of groups, and its groups run over the window's flat (row, column)
// order, straddling rows, so a window is 81 or 25 contiguous 16-byte
// stores; each sample is a 2-byte load checked against the plane. A K4
// group is a quarter (luma) or half (chroma) of one MB row of the output
// plane (row starts are 16-byte aligned because the plane widths are
// multiples of 8), and it reads its 4 samples, and its 4 sub-pel
// neighbours, as two aligned 8-byte words each and a funnel shift
// (`row4`), which halved its sample loads. The grid splits between the
// planes by block index, so no thread branches on its plane. Intra MBs
// and bad slots store zeros and read nothing.
//
// On NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, 1080p, device time):
// the three-plane K3 launch 0.0074 ms against 0.041 ms for the three
// launches it replaces, K4 0.0081-0.0082 ms at both pad sets against
// 0.030; no spill: K3 at 95 % of its byte bound, K4 at 64-65 %, held
// back by L1 traffic (seven field loads and two row gathers a thread).

#include "common.cuh"

namespace {

using namespace cairo;

constexpr int THREADS = 256;

// the (block, pad) window geometries K3 is built for
constexpr int Y_WIN = MB + 2, Y_WPAD = 17;
constexpr int C_WIN = MB / 2 + 2, C_WPAD = 9;

enum WinPlanes { LUMA = 0, CHROMA = 1, YUV = 2 };

// common.cuh's pix with 32-bit addressing (a plane holds fewer than 2^31
// samples, as the wrappers check) and one unsigned comparison per axis
__device__ __forceinline__ int pix32(const int16_t* p, int h, int w, int y,
                                     int x) {
  return (static_cast<unsigned>(y) < static_cast<unsigned>(h) &&
          static_cast<unsigned>(x) < static_cast<unsigned>(w))
             ? p[y * w + x]
             : 0;
}

// a ring stack (RING, h, w) int16 and its (n, B, B) int32 windows; core
// column x is ring column x + x_off
struct WinPlane {
  const int16_t* ring;
  int h, w, x_off;
  int* out;
};

// the 16-byte group g of the windows: flat samples 4g .. 4g + 3 of the
// (n, B, B) output, in MB n = g / (B*B/4), which may straddle a window
// row; offsets (mx >> SHIFT, my >> SHIFT)
template <int B, int PAD, int SHIFT>
__device__ __forceinline__ void window_group(const WinPlane& p, int slot,
                                             const int* __restrict__ mx,
                                             const int* __restrict__ my,
                                             int wb, int n_mb, int g) {
  static_assert(B * B % 4 == 0, "a window is whole 16-byte groups");
  constexpr int G = B * B / 4;
  const int n = g / G;
  if (n >= n_mb) return;
  const int f = (g - n * G) * 4;
  const int mb_row = n / wb;
  const int ox = clampi((__ldg(mx + n) >> SHIFT) + PAD - 1, 0, 2 * PAD - 2);
  const int oy = clampi((__ldg(my + n) >> SHIFT) + PAD - 1, 0, 2 * PAD - 2);
  const int y0 = mb_row * (B - 2) - PAD + oy;
  const int x0 = (n - mb_row * wb) * (B - 2) - PAD + ox + p.x_off;
  const int16_t* plane = p.ring + static_cast<size_t>(slot) * p.h * p.w;
  int r = f / B, c = f - r * B;
  int v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = pix32(plane, p.h, p.w, y0 + r, x0 + c);
    if (++c == B) {
      c = 0;
      ++r;
    }
  }
  reinterpret_cast<int4*>(p.out)[g] = make_int4(v[0], v[1], v[2], v[3]);
}

// PLANES = LUMA or CHROMA: one plane `a` at the luma or chroma geometry,
// offsets as given. PLANES = YUV: blocks [0, a_blocks) take the luma
// plane `a`, the next c_blocks U (`b`) and the rest V (`c`), chroma at
// (mx >> 1, my >> 1).
template <int PLANES>
__global__ void __launch_bounds__(THREADS)
gather_windows_kernel(WinPlane a, WinPlane b, WinPlane c,
                      const int* __restrict__ slot_p,
                      const int* __restrict__ mx, const int* __restrict__ my,
                      int wb, int n_mb, int a_blocks, int c_blocks) {
  const int slot = __ldg(slot_p);
  int blk = blockIdx.x;
  if constexpr (PLANES == CHROMA) {
    window_group<C_WIN, C_WPAD, 0>(a, slot, mx, my, wb, n_mb,
                                   blk * THREADS + threadIdx.x);
    return;
  }
  if (PLANES == LUMA || blk < a_blocks) {
    window_group<Y_WIN, Y_WPAD, 0>(a, slot, mx, my, wb, n_mb,
                                   blk * THREADS + threadIdx.x);
    return;
  }
  // two calls, not one on a selected plane: a WinPlane picked at run
  // time would go through local memory
  blk -= a_blocks;
  if (blk < c_blocks) {
    window_group<C_WIN, C_WPAD, 1>(b, slot, mx, my, wb, n_mb,
                                   blk * THREADS + threadIdx.x);
  } else {
    window_group<C_WIN, C_WPAD, 1>(c, slot, mx, my, wb, n_mb,
                                   (blk - c_blocks) * THREADS + threadIdx.x);
  }
}

// ---- K4

// a ring stack (RING, h, rw) int16 and its (h, w) int32 prediction
// plane; core column x is ring column x + x_off
struct PredPlane {
  const int16_t* ring;
  int h, w, rw, x_off;
  int* out;
};

// the per-MB fields, (N,) each: ints as int32, flags as bytes (bool or
// uint8, nonzero is true)
struct PredFields {
  const int* slot;
  const int* mx;
  const int* my;
  const int* spi;
  const uint8_t* spp;
  const uint8_t* spa;
  const uint8_t* zero;
};

// samples x .. x + 3 of row y of a plane, zero outside it, from two
// aligned 8-byte loads and a funnel shift. The plane's width is a
// multiple of 4 and its rows start 8-byte aligned, so each aligned word
// of 4 samples lies wholly inside or wholly outside the plane. A ring
// halo keeps this: its width (W + 2 halo, W/2 + halo) is a multiple of 4
// when halo is a multiple of 8, which the wrappers check.
__device__ __forceinline__ void row4(const int16_t* plane, int h, int w,
                                     int y, int x, int (&v)[4]) {
  const int xa = x & ~3;   // the aligned word at or left of x
  const int sh = 16 * (x - xa);
  unsigned long long lo = 0, hi = 0;
  if (static_cast<unsigned>(y) < static_cast<unsigned>(h)) {
    const auto* row =
        reinterpret_cast<const unsigned long long*>(plane + y * w + xa);
    if (static_cast<unsigned>(xa) < static_cast<unsigned>(w)) lo = __ldg(row);
    if (static_cast<unsigned>(xa + 4) < static_cast<unsigned>(w)) {
      hi = __ldg(row + 1);
    }
  }
  const unsigned long long s = sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = static_cast<int16_t>(static_cast<uint16_t>(s >> (16 * j)));
  }
}

// the 16-byte group t of a plane of BLK x BLK blocks: MB n = t / G,
// samples 4 k .. 4 k + 3 of one block row; offsets (mx >> SHIFT,
// my >> SHIFT) clamped to the pad PAD
template <int BLK, int PAD, int SHIFT>
__device__ __forceinline__ void pred_group(const PredPlane& p,
                                           const PredFields& f, int wb,
                                           int n_mb, int t) {
  constexpr int GPR = BLK / 4;   // groups per block row
  constexpr int G = BLK * GPR;   // groups per block
  const int n = t / G;
  if (n >= n_mb) return;
  const int k = t - n * G;
  const int mb_row = n / wb;
  const int y = mb_row * BLK + k / GPR;
  const int x = (n - mb_row * wb) * BLK + (k % GPR) * 4;
  int4* dst = reinterpret_cast<int4*>(p.out + y * p.w + x);
  const int s = __ldg(f.slot + n);
  // intra, or a slot the anchor's slot pick leaves at zero windows
  if (__ldg(f.zero + n) || s < 0 || s >= RING) {
    *dst = make_int4(0, 0, 0, 0);
    return;
  }
  const int16_t* plane = p.ring + static_cast<size_t>(s) * p.h * p.rw;
  const int m_x = __ldg(f.mx + n), m_y = __ldg(f.my + n);
  const int xr = x + p.x_off;   // the group's ring column
  const int yb = y - PAD + clampi((m_y >> SHIFT) + PAD, 0, 2 * PAD);
  const int xb = xr - PAD + clampi((m_x >> SHIFT) + PAD, 0, 2 * PAD);
  int v[4];
  row4(plane, p.h, p.rw, yb, xb, v);
  if (__ldg(f.spp + n)) {
    // the neighbour's chroma shift depends on the parity of mx, my
    const int d = clampi(__ldg(f.spi + n), 0, 7);
    const int yn =
        y - PAD + clampi(((m_y + dir_y(d)) >> SHIFT) + PAD, 0, 2 * PAD);
    const int xn =
        xr - PAD + clampi(((m_x + dir_x(d)) >> SHIFT) + PAD, 0, 2 * PAD);
    const bool quarter = __ldg(f.spa + n) != 0;
    int nb[4];
    row4(plane, p.h, p.rw, yn, xn, nb);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = quarter ? lerp_quarter(v[j], nb[j]) : lerp_half(v[j], nb[j]);
    }
  }
  *dst = make_int4(v[0], v[1], v[2], v[3]);
}

// blocks [0, y_blocks) take the luma plane, the next c_blocks U and the
// rest V
template <int YPAD, int CPAD>
__global__ void __launch_bounds__(THREADS)
pred_planes_kernel(PredPlane y, PredPlane u, PredPlane v, PredFields f,
                   int wb, int n_mb, int y_blocks, int c_blocks) {
  int blk = blockIdx.x;
  if (blk < y_blocks) {
    pred_group<MB, YPAD, 0>(y, f, wb, n_mb, blk * THREADS + threadIdx.x);
    return;
  }
  blk -= y_blocks;   // two calls, as in gather_windows_kernel
  if (blk < c_blocks) {
    pred_group<MB / 2, CPAD, 1>(u, f, wb, n_mb, blk * THREADS + threadIdx.x);
  } else {
    pred_group<MB / 2, CPAD, 1>(v, f, wb, n_mb,
                                (blk - c_blocks) * THREADS + threadIdx.x);
  }
}

int blocks_for(int groups) { return (groups + THREADS - 1) / THREADS; }

}  // namespace

extern "C" int cairo_gather_windows(const void* planes, const void* slot,
                                    const void* mx, const void* my, int h,
                                    int w, int block, int pad, void* out,
                                    void* stream) {
  const int wb = w / (block - 2), n = (h / (block - 2)) * wb;
  const WinPlane p{static_cast<const int16_t*>(planes), h, w, 0,
                   static_cast<int*>(out)};
  const int grid = blocks_for(n * (block * block / 4));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int *slot_p = static_cast<const int*>(slot),
            *mx_p = static_cast<const int*>(mx),
            *my_p = static_cast<const int*>(my);
  if (block == Y_WIN && pad == Y_WPAD) {
    gather_windows_kernel<LUMA><<<grid, THREADS, 0, s>>>(
        p, p, p, slot_p, mx_p, my_p, wb, n, grid, 0);
  } else if (block == C_WIN && pad == C_WPAD) {
    gather_windows_kernel<CHROMA><<<grid, THREADS, 0, s>>>(
        p, p, p, slot_p, mx_p, my_p, wb, n, grid, 0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// h, w: the core's luma dims; the ring's are (h, w + 2 halo) and
// (h / 2, w / 2 + halo)
extern "C" int cairo_gather_windows_yuv(const void* ry, const void* ru,
                                        const void* rv, const void* slot,
                                        const void* mx, const void* my,
                                        int h, int w, int halo, void* out_y,
                                        void* out_u, void* out_v,
                                        void* stream) {
  const int wb = w / cairo::MB, n = (h / cairo::MB) * wb;
  const int y_blocks = blocks_for(n * (Y_WIN * Y_WIN / 4));
  const int c_blocks = blocks_for(n * (C_WIN * C_WIN / 4));
  gather_windows_kernel<YUV><<<y_blocks + 2 * c_blocks, THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      WinPlane{static_cast<const int16_t*>(ry), h, w + 2 * halo, halo,
               static_cast<int*>(out_y)},
      WinPlane{static_cast<const int16_t*>(ru), h / 2, w / 2 + halo,
               halo / 2, static_cast<int*>(out_u)},
      WinPlane{static_cast<const int16_t*>(rv), h / 2, w / 2 + halo,
               halo / 2, static_cast<int*>(out_v)},
      static_cast<const int*>(slot), static_cast<const int*>(mx),
      static_cast<const int*>(my), wb, n, y_blocks, c_blocks);
  return static_cast<int>(cudaGetLastError());
}

// h, w: the core's luma dims, as in cairo_gather_windows_yuv
extern "C" int cairo_pred_planes(const void* ry, const void* ru,
                                 const void* rv, const void* slot,
                                 const void* mx, const void* my,
                                 const void* spp, const void* spa,
                                 const void* spi, const void* zero, int h,
                                 int w, int halo, int ypad, int cpad,
                                 void* out_y, void* out_u, void* out_v,
                                 void* stream) {
  const int wb = w / cairo::MB, n = (h / cairo::MB) * wb;
  const int y_blocks = blocks_for(n * cairo::MB * cairo::MB / 4);
  const int c_blocks = blocks_for(n * cairo::MB * cairo::MB / 16);
  const PredPlane py{static_cast<const int16_t*>(ry), h, w, w + 2 * halo,
                     halo, static_cast<int*>(out_y)};
  const PredPlane pu{static_cast<const int16_t*>(ru), h / 2, w / 2,
                     w / 2 + halo, halo / 2, static_cast<int*>(out_u)};
  const PredPlane pv{static_cast<const int16_t*>(rv), h / 2, w / 2,
                     w / 2 + halo, halo / 2, static_cast<int*>(out_v)};
  const PredFields f{static_cast<const int*>(slot),
                     static_cast<const int*>(mx),
                     static_cast<const int*>(my),
                     static_cast<const int*>(spi),
                     static_cast<const uint8_t*>(spp),
                     static_cast<const uint8_t*>(spa),
                     static_cast<const uint8_t*>(zero)};
  const int grid = y_blocks + 2 * c_blocks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ypad == 17 && cpad == 9) {
    pred_planes_kernel<17, 9><<<grid, THREADS, 0, s>>>(
        py, pu, pv, f, wb, n, y_blocks, c_blocks);
  } else if (ypad == 33 && cpad == 17) {
    pred_planes_kernel<33, 17><<<grid, THREADS, 0, s>>>(
        py, pu, pv, f, wb, n, y_blocks, c_blocks);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
