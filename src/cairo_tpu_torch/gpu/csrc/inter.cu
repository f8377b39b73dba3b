// Exact inter search kernel for Hopper (sm_90a): K5.
//
// K5 inter_search replaces cairo_tpu/tpu/pallas_inter.py inter_search
// (_build_kernel): the conformance encoder's replay of the reference's
// inter search (motion.cpp:421-494) for every macroblock against the ring
// slots at offsets 1 .. RING-1 from the current frame, folded across
// them by the classify merge (encode.cpp:29-54). Per reference, in the
// anchor's order (motion.inter_search_exact):
//   * the co-located candidate; MAD below the threshold freezes the MB
//     (no candidate is accepted afterwards);
//   * rings of 9 candidates at steps 16, 8, 4, 2, 1 around the best at
//     ring entry, scanned j outer, i inner, with strict comparisons; the
//     first ring's centre can reset the SSD from INT32_MAX on a tie;
//   * 8 directions, half then quarter sub-pel, against the final best.
// The per-reference winners merge in offset order: copy status dominates,
// then strictly lower SAD; ties keep the earlier reference.
//
// Design: one thread block of 256 threads per macroblock. The block
// stages the source blocks and, one reference at a time, the luma window
// [py-32, py+48) x [px-32, px+48) and the chroma windows [cy-16, cy+24) x
// [cx-16, cx+24) in shared memory as int16 (ring pixels are int16; reads
// outside the plane are zero, the anchor's padding). Every candidate
// offset lies within +-32 (16+8+4+2+1 plus sub-pel), so the windows hold
// all of them; offsets clamp to the window as extract.extract_blocks
// clips. Thread t owns luma pixel t and, for t < 128, one chroma pixel;
// the 9 (or 16 sub-pel) candidates of a step are evaluated together, SAD
// and MAD by warp reductions, and thread 0 folds them in scan order and
// publishes the next base. The windows, the candidate metrics and the
// acceptance rules are common.cuh's, shared with K6 (wave.cu). What
// bounds it on this card is integer work: about 62 candidate evaluations
// x 384 abs-diffs per MB and reference (~0.58 G ops per 1080p call)
// against ~32 MB of traffic; the serial
// fold and the barriers between steps keep it far above that bound.

#include "common.cuh"

namespace {

using namespace cairo;

constexpr int THREADS = SEARCH_THREADS;
constexpr int NWARP = THREADS / 32;
constexpr int NFIELDS = 9;

// luma [py-32, py+48) x [px-32, px+48), chroma [cy-16, cy+24) x
// [cx-16, cx+24)
using Win = Windows<80, 32, 32, 40, 16, 16>;

struct Smem {
  Win win;
  int src[384];         // Y 16x16, U 8x8, V 8x8
  int red[2 * 16 * NWARP];
  int csad[16];
  int cmad[16];
  int base[2];          // ring-entry best, broadcast by thread 0
};

__global__ void __launch_bounds__(THREADS)
inter_search_kernel(const int* __restrict__ src_y,
                    const int* __restrict__ src_u,
                    const int* __restrict__ src_v,
                    const int16_t* __restrict__ ring_y,
                    const int16_t* __restrict__ ring_u,
                    const int16_t* __restrict__ ring_v,
                    const int* __restrict__ hdr, int h, int w,
                    int* __restrict__ out) {
  __shared__ Smem s;
  const int t = threadIdx.x;
  const int n = blockIdx.x;
  const int nmb = (h / MB) * (w / MB);
  const int wb = w / MB;
  const int px = (n % wb) * MB, py = (n / wb) * MB;
  const int frame_index = hdr[0];
  const int mad_thr = (hdr[1] >> 2) + 1;

  s.src[t] = src_y[static_cast<size_t>(n) * 256 + t];
  if (t < 64) s.src[256 + t] = src_u[static_cast<size_t>(n) * 64 + t];
  else if (t < 128)
    s.src[256 + t] = src_v[static_cast<size_t>(n) * 64 + t - 64];

  // merged best across references (meaningful in thread 0 only)
  int b_sad = 0, b_copy = 0, b_motion = 0, b_target = 0, b_mx = 0, b_my = 0;
  int b_spp = 0, b_spa = 0, b_spi = 0;

  for (int offset = 1; offset < RING; ++offset) {
    const int slot = ((frame_index + RING - offset) % RING + RING) % RING;
    __syncthreads();  // the previous reference's windows are done with
    s.win.load(ring_y + static_cast<size_t>(slot) * h * w,
               ring_u + static_cast<size_t>(slot) * (h / 2) * (w / 2),
               ring_v + static_cast<size_t>(slot) * (h / 2) * (w / 2), h, w,
               px, py);
    __syncthreads();

    // co-located early-out
    {
      int y[1], c[1];
      s.win.cand_px(0, 0, y[0], c[0]);
      cand_metrics<1, NWARP>(s.src, y, c, s.red, s.csad, s.cmad);
    }
    const bool frozen = s.cmad[0] < mad_thr;
    int mx = 0, my = 0, sad = s.csad[0], mad = s.cmad[0], ssd = INT32_MAX_;
    if (t == 0) s.base[0] = s.base[1] = 0;
    __syncthreads();

    for (int step = 16; step >= 1; step >>= 1) {
      const int bx = s.base[0], by = s.base[1];
      int y[9], c[9];
#pragma unroll
      for (int k = 0; k < 9; ++k)
        s.win.cand_px(bx + (k % 3 - 1) * step, by + (k / 3 - 1) * step, y[k],
                      c[k]);
      cand_metrics<9, NWARP>(s.src, y, c, s.red, s.csad, s.cmad);
      if (t == 0) {
        for (int k = 0; k < 9; ++k) {
          const int cx = bx + (k % 3 - 1) * step, cy = by + (k / 3 - 1) * step;
          const int c_ssd = cx * cx + cy * cy;
          if (!frozen && in_frame(px, py, cx, cy, h, w) &&
              eval_accept(sad, mad, ssd, s.csad[k], s.cmad[k], c_ssd,
                          mad_thr)) {
            mx = cx; my = cy; sad = s.csad[k]; mad = s.cmad[k]; ssd = c_ssd;
          }
        }
        s.base[0] = mx;
        s.base[1] = my;
      }
      __syncthreads();
    }
    mx = s.base[0];
    my = s.base[1];

    // sub-pel: candidate 2d is the half-pel and 2d+1 the quarter-pel
    // blend of the best block with its neighbour in direction d
    {
      int y[16], c[16];
      s.win.subpel_px(mx, my, y, c);
      cand_metrics<16, NWARP>(s.src, y, c, s.red, s.csad, s.cmad);
    }
    if (t == 0) {
      int spp = 0, spa = 0, spi = 0;
      for (int k = 0; k < 16; ++k) {
        const int d = k >> 1;
        if (!frozen && in_frame(px, py, mx + dir_x(d), my + dir_y(d), h, w) &&
            subpel_accept(sad, mad, s.csad[k], s.cmad[k], mad_thr)) {
          spp = 1; spa = k & 1; spi = d; sad = s.csad[k]; mad = s.cmad[k];
        }
      }
      const int copy = mad < mad_thr;
      const bool take = offset == 1 ||
          (copy != b_copy ? copy != 0 : sad < b_sad);
      if (take) {
        b_sad = sad; b_copy = copy;
        b_motion = (mx != 0 || my != 0 || spp) ? 1 : 0;
        b_target = offset; b_mx = mx; b_my = my;
        b_spp = spp; b_spa = spa; b_spi = spi;
      }
    }
  }
  if (t == 0) {
    const int f[NFIELDS] = {b_sad, b_copy, b_motion, b_target, b_mx, b_my,
                            b_spp, b_spa, b_spi};
    for (int i = 0; i < NFIELDS; ++i)
      out[static_cast<size_t>(i) * nmb + n] = f[i];
  }
}

}  // namespace

// out: (9, N) int32 rows sad, is_copy, is_motion, target, motion_x,
// motion_y, sp_pred, sp_amount, sp_index. hdr: device [frame_index,
// quality]. ring_*: (RING, h, w) / (RING, h/2, w/2) int16.
extern "C" int cairo_inter_search(const void* src_y, const void* src_u,
                                  const void* src_v, const void* ring_y,
                                  const void* ring_u, const void* ring_v,
                                  const void* hdr, int h, int w,
                                  void* out, void* stream) {
  const int n = (h / MB) * (w / MB);
  inter_search_kernel<<<n, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src_y), static_cast<const int*>(src_u),
      static_cast<const int*>(src_v), static_cast<const int16_t*>(ring_y),
      static_cast<const int16_t*>(ring_u), static_cast<const int16_t*>(ring_v),
      static_cast<const int*>(hdr), h, w, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
