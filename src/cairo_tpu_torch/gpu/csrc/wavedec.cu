// Wave-decode kernel for Hopper (sm_90a): K7.
//
// K7 wave_decode replaces the wave loop of the conformance decode, the
// jax.lax.while_loop of cairo_tpu/tpu/wavefront.py:981-1047 (no Pallas
// kernel runs it). The decode step has reconstructed every block but the
// intra-motion ones into the written planes; K7 rebuilds those, the
// members of the host's compacted schedule (cuda_wavedec.py says what a
// member computes). A member's sample comes from the written plane where
// it is raster-before the member (above its block row, or in that row
// left of the block), from the stale plane (the ring slot before this
// frame) elsewhere, and is 0 outside the aligned frame.
//
// What bounds it on this card: neither bytes nor operations. A 1080p
// intra frame rebuilds at most 8,160 members, some 3 KB each (the samples
// read, the int32 residual, the sample written): about 25 MB, 7.5 us at
// 3.35 TB/s. What takes the time is the chain of members that read each
// other: a member reads the blocks of earlier members, which must be
// rebuilt first. Waves (w = bi + 3 bj) make every member wait on its
// whole causal window, wb + 3 (hb - 1) = 321 steps at 1080p; a member
// really reads only its base block and, sub-pel, its neighbour, and the
// longest chain of such reads is shorter (cuda_wavedec.dependency_chain:
// 202 members on a 1080p q16 intra frame of 320 waves), so the launch
// waits on those reads alone.
//
// Design: one persistent launch per frame, a dataflow over the members.
//   * Tickets. Blocks take tickets from an atomic counter. Ticket 0 marks:
//     its block writes the members, in schedule order (wave by wave, the
//     -1 slots dropped), into a list and sets each member's pending flag
//     (one int32 per MB; the wrapper zeroes them), then publishes. Ticket
//     k > 0 is member k - 1 of the list. A block finishes its ticket's
//     work before it takes the next.
//   * Waits. A member's thread, for each sample it reads from the written
//     plane, waits until the MB that holds the sample is not pending
//     (first until the marks are published): exactly the MBs the member
//     reads, no more. Every such MB lies in an earlier wave (bj' < bj and
//     bi' <= bi + 2, or bj' = bj and bi' < bi, both in luma and, at half
//     the distances, in chroma), so its member has an earlier ticket, held
//     by a running block or done: by induction over tickets, no wait is
//     on a block that cannot run, at any residency (K6's row ticket,
//     wave.cu). A poll is an acquire load with __nanosleep backoff and
//     traps past SPIN_LIMIT, so a deadlock is a launch error, not a hang.
//   * Publishing. The block stores its samples, meets at a barrier, and
//     one thread __threadfence()s and clears the member's flag.
//   * Memory. The written plane, the list and the flags change during the
//     launch: they are read through L2 (ld.global.cg, acquire loads),
//     never the non-coherent L1 path; the stale planes, residuals, fields
//     and schedule are read-only (__ldg). Stale samples, the residual and
//     the fields are loaded before a thread's waits.
// Each thread owns one output sample: threads 0-255 the luma block,
// 256-319 U, 320-383 V. It reads its base sample and, for a sub-pel
// member, the neighbour sample, applies ops.lerp_half / lerp_quarter,
// adds the residual (wrap16) unless the block is a copy, and stores the
// sample in the written plane. Planes are int16: every value is wrap16'd,
// so this is exact.

#include "common.cuh"

namespace {

using namespace cairo;

constexpr int THREADS = MB * MB + 2 * (MB / 2) * (MB / 2);   // 384
constexpr int DX_LO = -32, DX_HI = 32, DY_LO = -48, DY_HI = 16;
// sync: the ticket, the marks' flag, the member count, then the pending
// flags (N) and the member list (one entry per schedule slot at most)
constexpr int TICKET = 0, MARKED = 1, TOTAL = 2, PENDING = 3;

struct Plane {
  int16_t* written;
  const int16_t* stale;
  const int* res;   // (n, B, B) residual blocks
};

// Where the member at block origin (by, bx) of block size B reads sample
// (by + ry, bx + rx): `at` is its offset in the plane (-1 outside the
// frame: the sample is 0), `mb` the MB that holds it when it comes from
// the written plane (raster-before the member), else -1 (the stale plane).
struct Src {
  int at, mb;
};

template <int B>
__device__ __forceinline__ Src locate(int h, int w, int by, int bx, int ry,
                                      int rx) {
  const int y = by + ry, x = bx + rx;
  if (static_cast<unsigned>(y) >= static_cast<unsigned>(h) ||
      static_cast<unsigned>(x) >= static_cast<unsigned>(w)) {
    return {-1, -1};
  }
  const bool before = ry < 0 || (ry < B && rx < 0);
  return {y * w + x, before ? (y / B) * (w / B) + x / B : -1};
}

// the thread waits until *flag == want
__device__ __forceinline__ void wait_for(const int* flag, int want) {
  unsigned ns = 32;
  long long spins = 0;
  while (ld_acquire(flag) != want) {
    __nanosleep(ns);
    ns = ns < 128 ? ns * 2 : ns;
    if (++spins > SPIN_LIMIT) __trap();
  }
}

// a sample located by `s`: the stale plane's read before any wait, the
// written plane's after the wait on its MB
__device__ __forceinline__ int stale_sample(const Plane& p, Src s) {
  return s.at >= 0 && s.mb < 0 ? __ldg(p.stale + s.at) : 0;
}

__device__ __forceinline__ int written_sample(const Plane& p,
                                              const int* pending, Src s,
                                              int v) {
  if (s.mb < 0) return v;
  wait_for(pending + s.mb, 0);
  return __ldcg(p.written + s.at);
}

// the thread's output sample i (row i / B, column i % B) of the member's
// B x B block at offset (oy, ox), sub-pel neighbour at (ty, tx)
template <int B>
__device__ __forceinline__ void member_block(const Plane& p,
                                             const int* pending, int h,
                                             int w, int m, int by, int bx,
                                             int i, int oy, int ox, int ty,
                                             int tx, bool spp, bool spa,
                                             bool copy) {
  const int r = i / B, c = i % B;
  const Src a = locate<B>(h, w, by, bx, oy + r, ox + c);
  const Src b = spp ? locate<B>(h, w, by, bx, ty + r, tx + c) : Src{-1, -1};
  const int res = copy ? 0 : __ldg(p.res + m * B * B + i);
  int pred = stale_sample(p, a), nb = stale_sample(p, b);
  pred = written_sample(p, pending, a, pred);
  nb = written_sample(p, pending, b, nb);
  if (spp) pred = spa ? lerp_quarter(pred, nb) : lerp_half(pred, nb);
  const int out = copy ? pred : wrap16(pred + res);
  p.written[(by + r) * w + bx + c] = static_cast<int16_t>(out);
}

// ticket 0: the members of the n_slots schedule slots, in slot order, into
// the list and their pending flags; thread t takes a run of slots, and a
// block-wide exclusive scan of the runs' member counts places them
__device__ void mark(const int16_t* __restrict__ bi_t,
                     const int16_t* __restrict__ bj_t, int n_slots, int wb,
                     int* pending, int* list, int* sync, int* warp_sum) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int run = (n_slots + THREADS - 1) / THREADS;
  const int s0 = min(t * run, n_slots), s1 = min(s0 + run, n_slots);
  int count = 0;
#pragma unroll 4
  for (int s = s0; s < s1; ++s) count += __ldg(bi_t + s) >= 0;
  int incl = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int at = incl - count;
  for (int k = 0; k < warp; ++k) at += warp_sum[k];
#pragma unroll 4
  for (int s = s0; s < s1; ++s) {
    const int bi = __ldg(bi_t + s);
    if (bi >= 0) {
      const int m = __ldg(bj_t + s) * wb + bi;
      pending[m] = 1;
      list[at++] = m;
    }
  }
  if (t == THREADS - 1) sync[TOTAL] = at;
  __syncthreads();
  if (t == 0) {
    __threadfence();
    atomicExch(sync + MARKED, 1);
  }
}

__global__ void __launch_bounds__(THREADS)
wave_decode_kernel(Plane y, Plane u, Plane v, const int* __restrict__ fields,
                   const int16_t* __restrict__ bi_t,
                   const int16_t* __restrict__ bj_t, int n_slots, int h,
                   int w, int* sync) {
  __shared__ int ticket, total, warp_sum[THREADS / 32];
  const int t = threadIdx.x;
  const int wb = w / MB, n = wb * (h / MB);
  int* pending = sync + PENDING;
  int* list = pending + n;
  int members = -1;   // the list's length, once the marks are seen
  for (;;) {
    if (t == 0) ticket = atomicAdd(sync + TICKET, 1);
    __syncthreads();
    const int k = ticket;
    if (k == 0) {   // ends in a barrier: `ticket` is read
      mark(bi_t, bj_t, n_slots, wb, pending, list, sync, warp_sum);
      continue;
    }
    if (members < 0) {
      if (t == 0) {
        wait_for(sync + MARKED, 1);
        total = __ldcg(sync + TOTAL);
      }
      __syncthreads();
      members = total;
    }
    if (k > members) return;
    const int m = __ldcg(list + k - 1);
    const int bi = m % wb, bj = m / wb;
    // fields rows: motion_x, motion_y, sp_pred, sp_amount, sp_index, copy
    const int dx = clampi(__ldg(fields + m), DX_LO, DX_HI);
    const int dy = clampi(__ldg(fields + n + m), DY_LO, DY_HI);
    const bool spp = __ldg(fields + 2 * n + m) != 0;
    const bool spa = __ldg(fields + 3 * n + m) != 0;
    const int d = clampi(__ldg(fields + 4 * n + m), 0, 7);
    const bool copy = __ldg(fields + 5 * n + m) != 0;
    const int tx = clampi(dx + dir_x(d), DX_LO, DX_HI);
    const int ty = clampi(dy + dir_y(d), DY_LO, DY_HI);
    if (t < MB * MB) {
      member_block<MB>(y, pending, h, w, m, bj * MB, bi * MB, t, dy, dx, ty,
                       tx, spp, spa, copy);
    } else if (t < MB * MB + 64) {   // two calls, not a plane picked at run
      member_block<MB / 2>(u, pending, h / 2, w / 2, m, bj * 8, bi * 8,
                           t - MB * MB, dy >> 1, dx >> 1, ty >> 1, tx >> 1,
                           spp, spa, copy);
    } else {
      member_block<MB / 2>(v, pending, h / 2, w / 2, m, bj * 8, bi * 8,
                           t - MB * MB - 64, dy >> 1, dx >> 1, ty >> 1,
                           tx >> 1, spp, spa, copy);
    }
    __syncthreads();   // the block is stored; `ticket` is read
    if (t == 0) {
      __threadfence();
      atomicExch(pending + m, 0);
    }
  }
}

// *blocks: how many blocks of the kernel fit on the current device at once
cudaError_t resident_blocks(int* blocks) {
  static int cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, wave_decode_kernel, THREADS, 0);
    }
    if (err != cudaSuccess) return err;
    cached[dev] = sms * per_sm;
  }
  *blocks = cached[dev];
  return cudaSuccess;
}

}  // namespace

// One launch on `stream` for the members of the first n_active rows of
// the (n_waves, p) schedule bi / bj: min(n_members + 1, the blocks that
// fit on the card, max_blocks where > 0) blocks. sync (3 + N +
// n_active * p int32) must be zero at launch. Returns the launch's CUDA
// error.
extern "C" int cairo_wave_decode(void* wy, void* wu, void* wv,
                                 const void* sy, const void* su,
                                 const void* sv, const void* ry,
                                 const void* ru, const void* rv,
                                 const void* fields, const void* bi,
                                 const void* bj, void* sync, int p,
                                 int n_active, int n_members, int h, int w,
                                 int max_blocks, void* stream) {
  const Plane y{static_cast<int16_t*>(wy), static_cast<const int16_t*>(sy),
                static_cast<const int*>(ry)};
  const Plane u{static_cast<int16_t*>(wu), static_cast<const int16_t*>(su),
                static_cast<const int*>(ru)};
  const Plane v{static_cast<int16_t*>(wv), static_cast<const int16_t*>(sv),
                static_cast<const int*>(rv)};
  int resident = 0;
  const cudaError_t err = resident_blocks(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = n_members < resident ? (n_members > 0 ? n_members + 1 : 1)
                                   : resident;
  if (max_blocks > 0 && max_blocks < grid) grid = max_blocks;
  wave_decode_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      y, u, v, static_cast<const int*>(fields),
      static_cast<const int16_t*>(bi), static_cast<const int16_t*>(bj),
      n_active * p, h, w, static_cast<int*>(sync));
  return static_cast<int>(cudaGetLastError());
}
