// Wave-decode kernel for Hopper (sm_90a): K7.
//
// K7 wave_decode replaces the wave loop of the conformance decode, the
// jax.lax.while_loop of cairo_tpu/tpu/wavefront.py:981-1047 (no Pallas
// kernel runs it). The decode step has reconstructed every block but the
// intra-motion ones into the written planes; K7 rebuilds those, wave by
// wave over the host's compacted schedule (cuda_wavedec.py says what a
// member computes). A member's sample comes from the written plane where
// it is raster-before the member (above its block row, or in that row
// left of the block), from the stale plane (the ring slot before this
// frame) elsewhere, and is 0 outside the aligned frame.
//
// One launch per active wave, one block per schedule slot: a slot of -1
// returns at once. Launching a wave's members together is exact because
// they never read each other's blocks: a member reads the written plane
// only in rows [py - 48, py) x columns [px - 32, px + 48) and in rows
// [py, py + 16) left of px, while the other members of wave w = bi + 3 bj
// sit at (bi + 3k, bj - k), from column px + 48 on (k > 0) or from row
// py + 16 on (k < 0); chroma halves every distance. Reads of the stale
// plane and of a member's own block (always stale) see nothing any member
// writes. Successive waves are ordered by the stream.
//
// Each thread owns one output sample: threads 0-255 the luma block,
// 256-319 U, 320-383 V. It reads its base sample and, for a sub-pel
// member, the neighbour sample, applies ops.lerp_half / lerp_quarter,
// adds the residual (wrap16) unless the block is a copy, and stores the
// sample in the written plane. Planes are int16: every value is wrap16'd,
// so this is exact.
//
// What bounds it on this card: neither bytes nor operations. A 1080p
// intra frame rebuilds at most 8,160 members, some 3 KB each (the samples
// read, the int32 residual, the sample written): about 25 MB, 7.5 us at
// 3.35 TB/s, while its 321 dependent launches of at most 40 blocks cost a
// few microseconds each. A persistent launch that waits on per-row
// progress counts, as K6 does, is the redesign that removes them.

#include "common.cuh"

namespace {

using namespace cairo;

constexpr int THREADS = MB * MB + 2 * (MB / 2) * (MB / 2);   // 384
constexpr int DX_LO = -32, DX_HI = 32, DY_LO = -48, DY_HI = 16;

struct Plane {
  int16_t* written;
  const int16_t* stale;
  const int* res;   // (n, B, B) residual blocks
};

// sample (by + ry, bx + rx) of a plane as the member at block origin
// (by, bx) of block size B reads it
template <int B>
__device__ __forceinline__ int member_sample(const Plane& p, int h, int w,
                                             int by, int bx, int ry,
                                             int rx) {
  const int y = by + ry, x = bx + rx;
  if (static_cast<unsigned>(y) >= static_cast<unsigned>(h) ||
      static_cast<unsigned>(x) >= static_cast<unsigned>(w)) {
    return 0;
  }
  const bool before = ry < 0 || (ry < B && rx < 0);
  return before ? p.written[y * w + x] : p.stale[y * w + x];
}

// the thread's output sample i (row i / B, column i % B) of the member's
// B x B block at offset (oy, ox), sub-pel neighbour at (ty, tx)
template <int B>
__device__ __forceinline__ void member_block(const Plane& p, int h, int w,
                                             int m, int by, int bx, int i,
                                             int oy, int ox, int ty, int tx,
                                             bool spp, bool spa, bool copy) {
  const int r = i / B, c = i % B;
  int pred = member_sample<B>(p, h, w, by, bx, oy + r, ox + c);
  if (spp) {
    const int nb = member_sample<B>(p, h, w, by, bx, ty + r, tx + c);
    pred = spa ? lerp_quarter(pred, nb) : lerp_half(pred, nb);
  }
  const int out = copy ? pred : wrap16(pred + p.res[m * B * B + i]);
  p.written[(by + r) * w + bx + c] = static_cast<int16_t>(out);
}

__global__ void __launch_bounds__(THREADS)
wave_decode_kernel(Plane y, Plane u, Plane v, const int* __restrict__ fields,
                   const int16_t* __restrict__ bi_t,
                   const int16_t* __restrict__ bj_t, int first, int h,
                   int w) {
  const int bi = bi_t[first + blockIdx.x];
  if (bi < 0) return;
  const int bj = bj_t[first + blockIdx.x];
  const int wb = w / MB, n = wb * (h / MB);
  const int m = bj * wb + bi;
  // fields rows: motion_x, motion_y, sp_pred, sp_amount, sp_index, copy
  const int dx = clampi(__ldg(fields + m), DX_LO, DX_HI);
  const int dy = clampi(__ldg(fields + n + m), DY_LO, DY_HI);
  const bool spp = __ldg(fields + 2 * n + m) != 0;
  const bool spa = __ldg(fields + 3 * n + m) != 0;
  const int d = clampi(__ldg(fields + 4 * n + m), 0, 7);
  const bool copy = __ldg(fields + 5 * n + m) != 0;
  const int tx = clampi(dx + dir_x(d), DX_LO, DX_HI);
  const int ty = clampi(dy + dir_y(d), DY_LO, DY_HI);
  const int t = threadIdx.x;
  if (t < MB * MB) {
    member_block<MB>(y, h, w, m, bj * MB, bi * MB, t, dy, dx, ty, tx, spp,
                     spa, copy);
  } else if (t < MB * MB + 64) {   // two calls, not a plane picked at run
    member_block<MB / 2>(u, h / 2, w / 2, m, bj * 8, bi * 8, t - MB * MB,
                         dy >> 1, dx >> 1, ty >> 1, tx >> 1, spp, spa, copy);
  } else {
    member_block<MB / 2>(v, h / 2, w / 2, m, bj * 8, bi * 8,
                         t - MB * MB - 64, dy >> 1, dx >> 1, ty >> 1,
                         tx >> 1, spp, spa, copy);
  }
}

}  // namespace

// n_active launches on `stream`, wave k over schedule row k; returns the
// first launch error
extern "C" int cairo_wave_decode(void* wy, void* wu, void* wv,
                                 const void* sy, const void* su,
                                 const void* sv, const void* ry,
                                 const void* ru, const void* rv,
                                 const void* fields, const void* bi,
                                 const void* bj, int p, int n_active, int h,
                                 int w, void* stream) {
  const Plane y{static_cast<int16_t*>(wy), static_cast<const int16_t*>(sy),
                static_cast<const int*>(ry)};
  const Plane u{static_cast<int16_t*>(wu), static_cast<const int16_t*>(su),
                static_cast<const int*>(ru)};
  const Plane v{static_cast<int16_t*>(wv), static_cast<const int16_t*>(sv),
                static_cast<const int*>(rv)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int k = 0; k < n_active; ++k) {
    wave_decode_kernel<<<p, THREADS, 0, s>>>(
        y, u, v, static_cast<const int*>(fields),
        static_cast<const int16_t*>(bi), static_cast<const int16_t*>(bj),
        k * p, h, w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
