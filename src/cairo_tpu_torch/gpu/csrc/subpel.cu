// The fast search's sub-pel refinement and the classification merge for
// Hopper (sm_90a): K9.
//
// K9 subpel_scan replaces no Pallas kernel. It is the lax.scan of sp_body
// over the 8 neighbour directions in cairo_tpu/tpu/motion.py inter_search
// (motion.py:476-521), which XLA fuses into a few kernels on the TPU and
// the port once ran as some 1,400 torch ops a reference, and the merge of
// the references' results in tpu/engine.py _classify_inter (:107-157),
// which the port once ran as some 68 torch ops a frame. Per MB and
// reference it blends the full-pel best block (K3's windows at [1, 17),
// chroma [1, 9)) with its neighbour in each direction of motion.SP_DIRS
// (dj outer, di inner), half-pel before quarter-pel, and folds the 16
// candidates in that order from K2's best under the sub-pel acceptance
// rule (cairo::subpel_accept): each accept compares against the state the
// previous candidate left, ties never replace. The chroma neighbour of
// direction (di, dj) lies at ((mx + di) >> 1) - (mx >> 1) = (di + (mx &
// 1)) >> 1 columns (floor shifts of possibly negative ints) and likewise
// in rows. A candidate is valid when its full-pel position stays in the
// (height, width) frame, judged at the tile's origin x0, and the MB is not
// frozen. With the merge on, the references run in offset order 1..R into
// one best, which starts as intra with the SAD sum |src_y| over the MB's
// luma: a reference's result replaces it when its copy status differs and
// it is a copy, or when the status is equal and its SAD is strictly
// lower (engine.py:139-153), so a tie keeps the earlier reference.
//
// What bounds it on this card: integer operations, 7 a luma and 6 a
// chroma sample of a candidate (dhalf and dquarter below, the sum and the
// max) x 16 candidates per MB and reference, about 1.0 G for the 8,160
// MBs of a 1080p frame and three references (0.030 ms at 33.5 Tops/s)
// against some 65 MB of windows, source and outputs (0.019 ms at 3.35
// TB/s).
//
// Design: one warp per MB, WARPS MBs a block (16 timed faster than 4
// and 8, tools/kernel_split.py), one launch for all the references. The 16 candidates' metrics and the 8 validity flags depend
// only on the full-pel best and the direction, not on the fold, so every
// lane computes its share of all of them from registers: lane l takes
// luma row l / 2, columns 8 (l % 2) .. + 8, and keeps the 3 x 10 window
// patch those samples and their 8 neighbours read; chroma row l / 4,
// columns 2 (l % 4) .. + 2 of U and V, with 3 x 4 patches. The lane's
// source samples are loaded once for all the references. The parity of
// mx and my is uniform over the warp, so each of its four values runs a
// copy of the scan in which every chroma neighbour is a fixed register
// (a uniform branch, no select). __reduce_add_sync and __reduce_max_sync
// (exact on ints) give every lane each candidate's SAD and MAD; every
// lane folds the same values and merges the same results, and lane 0
// writes.
//
// The blends are ops.lerp_half and ops.lerp_quarter for int16 samples,
// folded into |src - blend| (dhalf, dquarter), which saves the blend's
// own rounding steps. The windows hold
// recon samples of the int16 ring, which can be negative or beyond 255,
// and the source planes lie in int16 range, so no sum or difference here
// leaves int32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using cairo::FULL;
using cairo::MB;

constexpr int WARPS = 16;         // MBs per block, one warp each
constexpr int MAX_REFS = 3;       // references a launch: RING - 1
constexpr int YW = MB + 2;        // luma window 18 x 18
constexpr int CW = MB / 2 + 2;    // chroma windows 10 x 10

// one reference's K3 windows and K2 outputs, (n, ...) each
struct Ref {
  const int* ywin;
  const int* uwin;
  const int* vwin;
  const int* mx;
  const int* my;
  const int* sad;
  const int* mad;
  const uint8_t* frozen;
};

struct Refs {
  Ref r[MAX_REFS];
};

// outputs (n,), each null where not asked: the scan's (sad, mad, index,
// pred, amount, motion, copy) or the merge's best (sad, copy, motion,
// intra, target, motion_x, motion_y, pred, amount, index, block type)
struct Outs {
  int* sad;
  int* mad;
  int* index;
  uint8_t* pred;
  uint8_t* amount;
  uint8_t* motion;
  uint8_t* copy;
  uint8_t* intra;
  int* target;
  int* mvx;
  int* mvy;
  uint8_t* block_type;
};

// |src - lerp_half(b, t)| and |src - lerp_quarter(b, t)| for int16
// samples, from sb2 = 2 src - b and sb4 = 4 src + 1 - 3 b (per sample,
// the same for every direction). The half-pel blend is (b + t + 1 + s)
// >> 1 with s = (b + t) >> 31 (round away from zero, then truncate), so
// src - blend = (2 src - b - t - s) >> 1; the quarter-pel blend is (3 b
// + t + 2 + s) >> 2 with s = (3 b + t) >> 31, so src - blend = (4 src -
// 3 b - t + 1 - s) >> 2. The blend of two int16 samples stays in int16,
// so ops' wrap16 never acts on it.
__device__ __forceinline__ int dhalf(int sb2, int b, int t) {
  return abs((sb2 - t - ((b + t) >> 31)) >> 1);
}

__device__ __forceinline__ int dquarter(int sb4, int b, int t) {
  return abs((sb4 - t - ((3 * b + t) >> 31)) >> 2);
}

// chroma sample K of the lane, U and V, against the neighbour at (cx, cy)
// (-1..1, constants once the direction loop is unrolled): folds both
// blends into the direction's MADs; c2, c4: sb2 and sb4 of U (0) and V
// (1)
template <int K>
__device__ __forceinline__ void chroma(const int (&c2)[2][2],
                                       const int (&c4)[2][2],
                                       const int (&up)[3][4],
                                       const int (&vp)[3][4], int cx, int cy,
                                       int& hm, int& qm) {
  const int ub = up[1][1 + K], ut = up[1 + cy][1 + K + cx];
  const int vb = vp[1][1 + K], vt = vp[1 + cy][1 + K + cx];
  hm = max(hm, max(dhalf(c2[0][K], ub, ut), dhalf(c2[1][K], vb, vt)));
  qm = max(qm, max(dquarter(c4[0][K], ub, ut), dquarter(c4[1][K], vb, vt)));
}

// the fold of one reference (SP_DIRS order, half before quarter)
struct Fold {
  int sad, mad, index;
  bool pred, amount;
};

// The 16 candidates of one reference for an MB whose mx, my have
// parities PX, PY, folded into f; ok: bit d set where direction d may be
// taken.
template <int PX, int PY>
__device__ __forceinline__ void scan(const int (&yp)[3][10],
                                     const int (&ys)[8],
                                     const int (&up)[3][4],
                                     const int (&vp)[3][4],
                                     const int (&us)[2], const int (&vs)[2],
                                     unsigned ok, int thr, Fold& f) {
  int y2[8], y4[8], c2[2][2], c4[2][2];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    y2[k] = 2 * ys[k] - yp[1][1 + k];
    y4[k] = 4 * ys[k] + 1 - 3 * yp[1][1 + k];
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    c2[0][k] = 2 * us[k] - up[1][1 + k];
    c4[0][k] = 4 * us[k] + 1 - 3 * up[1][1 + k];
    c2[1][k] = 2 * vs[k] - vp[1][1 + k];
    c4[1][k] = 4 * vs[k] + 1 - 3 * vp[1][1 + k];
  }
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const int di = cairo::dir_x(d), dj = cairo::dir_y(d);
    int hs = 0, hm = 0, qs = 0, qm = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int b = yp[1][1 + k], t = yp[1 + dj][1 + di + k];
      const int h = dhalf(y2[k], b, t), q = dquarter(y4[k], b, t);
      hs += h;
      hm = max(hm, h);
      qs += q;
      qm = max(qm, q);
    }
    const int cx = (di + PX) >> 1, cy = (dj + PY) >> 1;
    chroma<0>(c2, c4, up, vp, cx, cy, hm, qm);
    chroma<1>(c2, c4, up, vp, cx, cy, hm, qm);
    hs = __reduce_add_sync(FULL, hs);
    hm = __reduce_max_sync(FULL, hm);
    qs = __reduce_add_sync(FULL, qs);
    qm = __reduce_max_sync(FULL, qm);

    const bool valid = (ok >> d) & 1;
    bool take = valid && cairo::subpel_accept(f.sad, f.mad, hs, hm, thr);
    f.pred = f.pred || take;
    f.amount = take ? false : f.amount;
    f.index = take ? d : f.index;
    f.sad = take ? hs : f.sad;
    f.mad = take ? hm : f.mad;
    take = valid && cairo::subpel_accept(f.sad, f.mad, qs, qm, thr);
    f.pred = f.pred || take;
    f.amount = take ? true : f.amount;
    f.index = take ? d : f.index;
    f.sad = take ? qs : f.sad;
    f.mad = take ? qm : f.mad;
  }
}

// reference i of refs, by selects (a kernel parameter indexed at run time
// would be copied to local memory)
__device__ __forceinline__ Ref pick(const Refs& refs, int i) {
  Ref r = refs.r[0];
  if (i == 1) r = refs.r[1];
  if (i == 2) r = refs.r[2];
  return r;
}

__global__ void __launch_bounds__(WARPS * 32)
subpel_scan_kernel(Refs refs, int nrefs, int merge,
                   const int* __restrict__ src_y,
                   const int* __restrict__ src_u,
                   const int* __restrict__ src_v,
                   const int* __restrict__ px_in,
                   const int* __restrict__ py_in,
                   const int* __restrict__ mad_thr, int n, int w, int x0,
                   int width, int height, int intra_bit, int motion_bit,
                   int copy_bit, Outs out) {
  const int m = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (m >= n) return;  // the whole warp: m is uniform over it
  const int lane = threadIdx.x & 31;
  const int px = px_in[m], py = py_in[m];
  const int thr = *mad_thr;

  // the lane's source samples, for every reference: luma row yr, columns
  // yc .. yc + 8; chroma row cr, columns cc .. cc + 2 of U and V
  const int yr = lane >> 1, yc = (lane & 1) * 8;
  const int cr = lane >> 2, cc = (lane & 3) * 2, cwp = w / 2;
  int ys[8], us[2], vs[2];
  const int* sy = src_y + static_cast<size_t>(py + yr) * w + px + yc;
#pragma unroll
  for (int k = 0; k < 8; ++k) ys[k] = sy[k];
  const size_t soff =
      static_cast<size_t>((py >> 1) + cr) * cwp + (px >> 1) + cc;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    us[k] = src_u[soff + k];
    vs[k] = src_v[soff + k];
  }

  // the best so far: intra, or the scan's result where the merge is off
  Fold best{0, 0, 0, false, false};
  bool b_copy = false, b_motion = false, b_intra = true;
  int b_target = 0, b_mx = 0, b_my = 0;
  if (merge) {
    int a = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) a += abs(ys[k]);
    best.sad = __reduce_add_sync(FULL, a);
  }

#pragma unroll 1
  for (int ri = 0; ri < nrefs; ++ri) {
    const Ref ref = pick(refs, ri);
    const int mx = ref.mx[m], my = ref.my[m];
    // luma window rows yr .. yr + 2, columns yc .. yc + 9; chroma rows
    // cr .. cr + 2, columns cc .. cc + 3
    const int* yw =
        ref.ywin + static_cast<size_t>(m) * YW * YW + yr * YW + yc;
    int yp[3][10];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 10; ++b) yp[a][b] = yw[a * YW + b];
    const size_t coff = static_cast<size_t>(m) * CW * CW + cr * CW + cc;
    int up[3][4], vp[3][4];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        up[a][b] = ref.uwin[coff + a * CW + b];
        vp[a][b] = ref.vwin[coff + a * CW + b];
      }
    unsigned ok = 0;
    if (!ref.frozen[m]) {
#pragma unroll
      for (int d = 0; d < 8; ++d)
        ok |= cairo::in_frame(x0 + px, py, mx + cairo::dir_x(d),
                              my + cairo::dir_y(d), height, width)
                  ? 1u << d : 0u;
    }

    Fold f{ref.sad[m], ref.mad[m], 0, false, false};
    switch ((mx & 1) | (my & 1) << 1) {   // uniform over the warp
      case 0: scan<0, 0>(yp, ys, up, vp, us, vs, ok, thr, f); break;
      case 1: scan<1, 0>(yp, ys, up, vp, us, vs, ok, thr, f); break;
      case 2: scan<0, 1>(yp, ys, up, vp, us, vs, ok, thr, f); break;
      default: scan<1, 1>(yp, ys, up, vp, us, vs, ok, thr, f); break;
    }
    const bool copy = f.mad < thr;
    const bool take = !merge ||
        (copy != b_copy ? copy : f.sad < best.sad);
    if (take) {
      best = f;
      b_copy = copy;
      b_motion = mx != 0 || my != 0 || f.pred;
      b_intra = false;
      b_target = ri + 1;
      b_mx = mx;
      b_my = my;
    }
  }
  if (lane == 0) {
    if (out.sad) out.sad[m] = best.sad;
    if (out.mad) out.mad[m] = best.mad;
    if (out.index) out.index[m] = best.index;
    if (out.pred) out.pred[m] = best.pred;
    if (out.amount) out.amount[m] = best.amount;
    if (out.motion) out.motion[m] = b_motion;
    if (out.copy) out.copy[m] = b_copy;
    if (out.intra) out.intra[m] = b_intra;
    if (out.target) out.target[m] = b_target;
    if (out.mvx) out.mvx[m] = b_mx;
    if (out.mvy) out.mvy[m] = b_my;
    if (out.block_type)
      out.block_type[m] = static_cast<uint8_t>(
          (b_intra ? intra_bit : 0) | (b_motion ? motion_bit : 0) |
          (b_copy ? copy_bit : 0));
  }
}

}  // namespace

// refs: MAX_REFS x (ywin (n, 18, 18), uwin, vwin (n, 10, 10) int32, mx,
// my, sad, mad int32, frozen bool, all (n,)), the first nrefs set, the
// rest null; src planes: (h, w) and 2 x (h/2, w/2) int32, read at each
// MB's (px, py); px, py int32 (n,); mad_thr: device int32. merge 0: one
// reference's scan into sad, mad, index (int32), pred, amount, motion,
// copy (bool); merge 1: the classification of nrefs references into sad,
// target, motion_x, motion_y, index (int32), copy, motion, intra, pred,
// amount (bool) and block_type (uint8, of the three bits given). An
// output not written is null.
extern "C" int cairo_subpel_scan(
    const void* const* refs, int nrefs, int merge, const void* src_y,
    const void* src_u, const void* src_v, const void* px, const void* py,
    const void* mad_thr, int n, int w, int x0, int width, int height,
    int intra_bit, int motion_bit, int copy_bit, void* const* outs,
    void* stream) {
  if (n == 0) return 0;
  if (nrefs < 0 || nrefs > MAX_REFS || (!merge && nrefs != 1)) return -1;
  Refs r{};
  for (int i = 0; i < nrefs; ++i) {
    const void* const* p = refs + 8 * i;
    r.r[i] = Ref{static_cast<const int*>(p[0]), static_cast<const int*>(p[1]),
                 static_cast<const int*>(p[2]), static_cast<const int*>(p[3]),
                 static_cast<const int*>(p[4]), static_cast<const int*>(p[5]),
                 static_cast<const int*>(p[6]),
                 static_cast<const uint8_t*>(p[7])};
  }
  const Outs o{static_cast<int*>(outs[0]), static_cast<int*>(outs[1]),
               static_cast<int*>(outs[2]), static_cast<uint8_t*>(outs[3]),
               static_cast<uint8_t*>(outs[4]), static_cast<uint8_t*>(outs[5]),
               static_cast<uint8_t*>(outs[6]), static_cast<uint8_t*>(outs[7]),
               static_cast<int*>(outs[8]), static_cast<int*>(outs[9]),
               static_cast<int*>(outs[10]), static_cast<uint8_t*>(outs[11])};
  subpel_scan_kernel<<<(n + WARPS - 1) / WARPS, WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      r, nrefs, merge, static_cast<const int*>(src_y),
      static_cast<const int*>(src_u), static_cast<const int*>(src_v),
      static_cast<const int*>(px), static_cast<const int*>(py),
      static_cast<const int*>(mad_thr), n, w, x0, width, height, intra_bit,
      motion_bit, copy_bit, o);
  return static_cast<int>(cudaGetLastError());
}
