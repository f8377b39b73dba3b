// Prediction-gather kernels for Hopper (sm_90a): K3 and K4.
//
// K3 gather_windows replaces cairo_tpu/tpu/pallas_pred.py gather_windows
// (_win_kernel): per-MB (B x B) int32 windows at window offset
// clamp(m + pad - 1, 0, 2*pad - 2) from one ring slot, where the slot is
// a device scalar; reads outside the plane are zero, as the anchor's
// zero-padded windows give. B is 18 for luma and 10 for chroma.
//
// K4 pred_planes replaces pallas_pred.py pred_planes (_pred_kernel): the
// prediction planes for every macroblock. Each MB reads its ring slot,
// a base block at its clamped motion offset and, for sub-pel MBs, the
// neighbour at (mx+di, my+dj); applies the exact half or quarter lerp of
// ops.lerp_half / lerp_quarter; INTRA_DEFAULT blocks (`zero`) are 0. The
// offsets clamp to the window pads given as arguments: [0, 2*pad] around
// -pad, as extract.extract_blocks clips to a window of that pad. The fast
// mode passes 17/9 (luma/chroma); the conformance encoder 33/17, the
// reference's +-31 full-pel reach plus 1 sub-pel (wavefront.py:733-780).
// One launch covers the Y, U and V planes.
//
// Both are gathers bounded by memory traffic: one thread per output
// pixel, neighbouring threads on neighbouring pixels, so reads and writes
// coalesce along each block row. The TPU versions' one-hot band matmuls
// and hi/lo byte splits are not needed: these are plain integer loads.

#include "common.cuh"

namespace {

using namespace cairo;

constexpr int THREADS = 256;

__constant__ int kDirX[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
__constant__ int kDirY[8] = {-1, -1, -1, 0, 0, 1, 1, 1};

__global__ void __launch_bounds__(THREADS)
gather_windows_kernel(const int16_t* __restrict__ planes,
                      const int* __restrict__ slot_p,
                      const int* __restrict__ mx, const int* __restrict__ my,
                      int h, int w, int block, int pad,
                      int* __restrict__ out) {
  const int mb = block - 2;
  const int wb = w / mb;
  const size_t total = static_cast<size_t>(h / mb) * wb * block * block;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % block);
  const int r = static_cast<int>((i / block) % block);
  const int n = static_cast<int>(i / (static_cast<size_t>(block) * block));
  const int max_shift = 2 * pad - 2;
  const int ox = clampi(mx[n] + pad - 1, 0, max_shift);
  const int oy = clampi(my[n] + pad - 1, 0, max_shift);
  const int py = (n / wb) * mb, px = (n % wb) * mb;
  const int16_t* p = planes + static_cast<size_t>(*slot_p) * h * w;
  out[i] = pix(p, h, w, py - pad + oy + r, px - pad + ox + c);
}

__global__ void __launch_bounds__(THREADS)
pred_planes_kernel(const int16_t* __restrict__ ry,
                   const int16_t* __restrict__ ru,
                   const int16_t* __restrict__ rv,
                   const int* __restrict__ slot, const int* __restrict__ mx,
                   const int* __restrict__ my, const int* __restrict__ spp,
                   const int* __restrict__ spa, const int* __restrict__ spi,
                   const int* __restrict__ zero, int h, int w, int ypad,
                   int cpad, int* __restrict__ out_y,
                   int* __restrict__ out_u, int* __restrict__ out_v) {
  const size_t ys = static_cast<size_t>(h) * w;
  const size_t cs = ys / 4;
  size_t j = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= ys + 2 * cs) return;
  const int16_t* plane;
  int* out;
  int ph, pw, blk, pad;
  const bool luma = j < ys;
  if (luma) {
    plane = ry; out = out_y; ph = h; pw = w; blk = MB; pad = ypad;
  } else if (j < ys + cs) {
    j -= ys;
    plane = ru; out = out_u; ph = h / 2; pw = w / 2; blk = MB / 2; pad = cpad;
  } else {
    j -= ys + cs;
    plane = rv; out = out_v; ph = h / 2; pw = w / 2; blk = MB / 2; pad = cpad;
  }
  const int y = static_cast<int>(j / pw), x = static_cast<int>(j % pw);
  const int n = (y / blk) * (w / MB) + x / blk;
  if (zero[n]) {
    out[j] = 0;
    return;
  }
  const int s = slot[n];
  if (s < 0 || s >= RING) {  // the anchor's slot pick leaves zero windows
    out[j] = 0;
    return;
  }
  const int16_t* p = plane + static_cast<size_t>(s) * ph * pw;
  const int k = clampi(spi[n], 0, 7);
  const int m_x = mx[n], m_y = my[n];
  const int tx = m_x + kDirX[k], ty = m_y + kDirY[k];
  const int bx = clampi((luma ? m_x : m_x >> 1) + pad, 0, 2 * pad);
  const int by = clampi((luma ? m_y : m_y >> 1) + pad, 0, 2 * pad);
  const int y0 = (y / blk) * blk - pad + y % blk;
  const int x0 = (x / blk) * blk - pad + x % blk;
  const int b = pix(p, ph, pw, y0 + by, x0 + bx);
  int v = b;
  if (spp[n]) {
    const int nx = clampi((luma ? tx : tx >> 1) + pad, 0, 2 * pad);
    const int ny = clampi((luma ? ty : ty >> 1) + pad, 0, 2 * pad);
    const int t = pix(p, ph, pw, y0 + ny, x0 + nx);
    v = spa[n] ? lerp_quarter(b, t) : lerp_half(b, t);
  }
  out[j] = v;
}

unsigned blocks_for(size_t n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" int cairo_gather_windows(const void* planes, const void* slot,
                                    const void* mx, const void* my, int h,
                                    int w, int block, int pad, void* out,
                                    void* stream) {
  const int mb = block - 2;
  const size_t total =
      static_cast<size_t>(h / mb) * (w / mb) * block * block;
  gather_windows_kernel<<<blocks_for(total), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(planes), static_cast<const int*>(slot),
      static_cast<const int*>(mx), static_cast<const int*>(my), h, w, block,
      pad, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cairo_pred_planes(const void* ry, const void* ru,
                                 const void* rv, const void* slot,
                                 const void* mx, const void* my,
                                 const void* spp, const void* spa,
                                 const void* spi, const void* zero, int h,
                                 int w, int ypad, int cpad, void* out_y,
                                 void* out_u, void* out_v, void* stream) {
  const size_t total = static_cast<size_t>(h) * w * 3 / 2;
  pred_planes_kernel<<<blocks_for(total), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(ry), static_cast<const int16_t*>(ru),
      static_cast<const int16_t*>(rv), static_cast<const int*>(slot),
      static_cast<const int*>(mx), static_cast<const int*>(my),
      static_cast<const int*>(spp), static_cast<const int*>(spa),
      static_cast<const int*>(spi), static_cast<const int*>(zero), h, w,
      ypad, cpad, static_cast<int*>(out_y), static_cast<int*>(out_u),
      static_cast<int*>(out_v));
  return static_cast<int>(cudaGetLastError());
}
