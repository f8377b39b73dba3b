// The fast step's transform tail for Hopper (sm_90a): K10 encode_tail and
// K11 decode_tail.
//
// Neither replaces a Pallas kernel. On the TPU the tail runs inside the
// jit of the fast steps and XLA fuses it into a few kernels:
// encode_step's residual and forward DCT, variance, adaptive QP and
// quantization, stale coefficient carry, dequantization, inverse DCT and
// prediction add (cairo_tpu/tpu/engine.py:219-281), and the decode side's
// carry (decode_step_coo, :453-465) and reconstruction (_decode_common,
// :329-378). The port once issued each as torch ops, some 870 launches a
// frame (encode plus decode). Both kernels repeat the arithmetic of the
// plain versions in gpu/cuda_tail.py exactly, through common.cuh's
// wrapping helpers (gpu/ops.py's C rules: truncating division through the
// floor of abs(numer), INT32_MIN included; int32 products and sums that
// wrap; wrap16 after each pass):
//   * ops.fdct8: rows, then columns; the DC term of each 1-D pass scaled
//     * 45 / 128, the AC terms / 2, each truncated, then rounded / 128;
//   * ops.idct8: columns, then rows; each term truncated before the sum;
//   * ops.quantize_8x8 / dequantize_8x8: the intra matrices where the MB
//     is intra and not motion (INTRA_DEFAULT), with every 8x8's DC (the
//     four luma quadrants' too) at the LUMA_DC / CHROMA_DC scale of its
//     qp; the inter path subtracts sign(qf) * qp;
//   * ops.block_variance2 over the luma MB's 255 AC-and-quadrant-DC
//     coefficients, s * s and the sum of squares wrapping in int32, and
//     ops.adaptive_qp from it (ilog2 of the variance read as a uint32);
//   * a copy MB keeps the state's stale coefficients and takes the
//     prediction as it is.
//
// What bounds them on this card: bytes. K10 reads the int32 source and
// prediction planes (the stale int16 coefficients of copy MBs only) and
// writes int16 coefficient and int32 recon planes: some 44 MB at 1080p
// (0.013 ms at 3.35 TB/s), against some 97 integer operations a sample
// (0.30 G, 0.009 ms at 33.5 Tops/s). K11 reads int32 coefficients (a copy
// MB's int16 stale row in their place, or nothing where neither carry nor
// residual asks for it) and prediction and writes int32 recon (and, asked,
// the int16 carried coefficients and the int32 residual blocks): 44 MB on
// the COO decode, against 42 operations a sample (0.13 G).
//
// K10's design: 48 threads an MB, each one 8-sample row of one of the
// MB's six 8x8 blocks, MBS MBs a block. An MB's 32 luma rows (4
// quadrants x 8 rows) are one warp, and the chroma rows of two MBs (U and
// V, 8 rows each) another, so each 8x8 block lies within one warp. A
// thread loads its source and prediction rows with 16-byte loads, runs
// the forward DCT's row pass in registers, transposes through a padded
// per-warp area of shared memory (row pitch 9: the 32 lanes' stores and
// loads fall on 32 banks), and runs the column pass in registers: it then
// holds a column of coefficients. The variance is one warp reduction over
// the MB's luma warp; qp reaches the chroma warps through shared memory,
// the block's one barrier. Quantization and dequantization divide by
// multiplying: the reciprocal table (gpu/cuda_tail.reciprocals, built on
// the host once per device, read through the L1 cache) holds each
// divisor's round-up reciprocal, exact for every uint32 dividend; no
// dividend K10 meets reaches 2^31, so abs() never wraps and ops'
// INT32_MIN case lies outside its domain. A transpose turns the quantized
// column back into a row, stored with one 16-byte store. The inverse
// DCT's column pass, a transpose and its row pass leave the thread with
// its residual row, added to the prediction it kept in registers and
// stored with 16-byte stores. Two MBs a block (96 threads) timed faster
// than four and eight (tools/kernel_split.py). Both DCTs keep ops' terms:
// the forward pass truncates after each output's integer sum and the
// inverse truncates each term before it; the passes pair output k with
// 7 - k by the basis' symmetry, which changes neither a term nor a sum.
//
// K11's design is K10's without the forward half: the same 48 threads an
// MB in blocks of k11::MBS MBs, the same warps, an 8x8 block in 8 lanes
// of one warp, the same paired idct8 with the basis as immediates and the
// same padded transpose. A thread loads column r of its block's
// coefficients (for each of the 8 rows the block's 8 lanes read one
// 32-byte sector; a copy MB's int16 stale column where the carry asks)
// and stores it to the carried plane, dequantizes it, runs the column
// pass, transposes and runs the row pass; its residual row is stored in
// K7's block layout with two 16-byte stores where asked, added to the
// prediction row it loaded with 16-byte loads, and stored with 16-byte
// stores. A copy MB whose residual nobody asks for takes its prediction
// and copies its stale row to the carried plane (one 16-byte load and
// store), with no coefficient read, dequantization or pass. qp and the
// flags are read per MB, so no value crosses warps: the 8 lanes of a
// block synchronise among themselves (__syncwarp on their mask), lanes
// past the last MB leave as whole blocks, and the kernel has no
// block-wide barrier. Dequantization has no runtime division: the matrix
// entries and DC scales are the reciprocal table's d words, and the scale
// factor is the compile-time k11::SF (cuda_tail checks it against
// tables.QUANTIZER_SCALE_FACTOR once a process).
//
// The times behind it (tools/kernel_split.py k11 on the main path's 1080p
// inter frame, device ms, NVIDIA H100 80GB HBM3, 700.00 W): 0.0186-0.0187
// as built. The design not taken, rows loaded with 16-byte loads (the
// carried row one 16-byte store) and turned into columns by a second
// transpose, took 0.0198-0.0199. 4 MBs a block took 0.0179-0.0185, within
// the spread between turns, and 8 MBs 0.0190, so K10's 2 stay. 4-byte
// access to the prediction, the reconstruction and the residual took
// 0.0363. Without dequantization 0.0163-0.0164; with loads and stores only
// 0.0177, against 0.0131 for the bytes.
//
// K11's domain, on which C's truncating / equals ops.trunc_div_pos and no
// product wraps: coefficients int16-valued (-32768..32767) in int32, qp
// 0..255. Every producer gives that: engine.coo_planes scatters int16 COO
// values, each position written once by the parser (positions past the
// planes add 0); the dense decodes (engine.decode_step,
// wavefront.conformance_decode_step_dense, shard.tile_decode_step) widen
// int16 planes; the wave decode's new_coef is coo_planes' or the dense
// one's; the stale planes are int16; qp is the block table's uint8
// q_index. There |2 v qm qp| <= 2 * 32768 * 45 * 255 < 2^31 and the intra
// DC product |v dc| <= 32768 * 494 (tests/test_torch_decode_tail.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using cairo::add_w;
using cairo::clampi;
using cairo::FULL;
using cairo::MB;
using cairo::mul_w;
using cairo::sub_w;
using cairo::trunc_div_pos;
using cairo::wrap16;

// ---- shared by K10 and K11

constexpr int LD = 9;               // transpose row pitch, ints
constexpr int TB = 8 * LD;          // one 8x8 block's transpose area

// The reciprocal table (cuda_tail.reciprocals), int32 words, an int4 (m,
// s - 1, d, d / 2) per divisor d: m = ceil(2^(32 + s) / d) - 2^32 and s =
// ceil(log2 d). K11 reads the d words only.
constexpr int R_QM = 0;       // [2][64] INTRA_QM_8x8, INTER_QM_8x8
constexpr int R_QP2 = 512;    // [256] qp << 1 by qp (qp 0 as qp 1)
constexpr int R_DCL = 1536;   // [256] LUMA_DC by qp
constexpr int R_DCC = 2560;   // [256] CHROMA_DC by qp
constexpr int R_SF = 3584;    // QUANTIZER_SCALE_FACTOR
constexpr int R_WORDS = 3588;

// tables.DCT_BASIS_8, B[k][j] at 8 k + j, as compile-time constants: the
// passes multiply by immediates, and the compiler folds the divisions a
// constant makes exact (v * 126 / 2 is v * 63, v * 128 * 45 / 128 is v *
// 45)
__device__ __forceinline__ int B8(int i) {
  constexpr int b[64] = {
      128,  128,  128,  128,  128,  128,  128,  128,
      126,  106,   71,   25,  -25,  -71, -106, -126,
      118,   49,  -49, -118, -118,  -49,   49,  118,
      106,  -25, -126,  -71,   71,  126,   25, -106,
       91,  -91,  -91,   91,   91,  -91,  -91,   91,
       71, -126,   25,  106, -106,  -25,  126,  -71,
       49, -118,  118,  -49,  -49,  118, -118,   49,
       25,  -71,  106, -126,  126, -106,   71,  -25};
  return b[i];
}

// ops.rounded_div_pos(v, 128) for |v| < 2^30: C's / truncates as
// trunc_div_pos does wherever abs() does not wrap
__device__ __forceinline__ int rdiv128(int v) {
  return (v < 0 ? v - 64 : v + 64) / 128;
}

// ops.idct8's pass1d over 8 coefficients, in place: output k is the sum
// of the terms v_j B[j][k], scaled * 45 / 128 (j 0) or / 2, each truncated
// before the sum, then rounded / 128. B[j][7 - k] = (-1)^j B[j][k] and
// truncation is odd, so output 7 - k has the same terms, the odd j's
// negated: outputs k and 7 - k are E + O and E - O, E and O the sums of
// output k's even and odd terms (|v| <= 2^15: no term leaves 2^28).
__device__ __forceinline__ void idct8(int (&v)[8]) {
  int out[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int e = v[0] * B8(k) * 45 / 128, o = 0;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      const int t = v[j] * B8(8 * j + k) / 2;
      if (j & 1) {
        o += t;
      } else {
        e += t;
      }
    }
    out[k] = wrap16(rdiv128(e + o));
    out[7 - k] = wrap16(rdiv128(e - o));
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = out[k];
}

// The 8 x 8 block of the eight lanes r = 0..7 that share buf: each lane's
// 8 values in, its column r out. Lane (b, r) of a warp's four blocks
// stores word 72 b + 9 r + k and loads 72 b + 9 j + r, 32 banks either
// way. mask: the lanes that synchronise, at least the block's eight.
__device__ __forceinline__ void transpose(int (&v)[8], int* buf, int r,
                                          unsigned mask = FULL) {
  __syncwarp(mask);   // the last transpose's loads are done
#pragma unroll
  for (int k = 0; k < 8; ++k) buf[r * LD + k] = v[k];
  __syncwarp(mask);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = buf[j * LD + r];
}

// two int16 values in one word, the first in the low half
__device__ __forceinline__ int pack16(int lo, int hi) {
  return static_cast<int>((static_cast<unsigned>(lo) & 0xFFFFu) |
                          (static_cast<unsigned>(hi) << 16));
}

__device__ __forceinline__ void load8(const int* p, int (&v)[8]) {
  const int4 a = reinterpret_cast<const int4*>(p)[0];
  const int4 b = reinterpret_cast<const int4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(int* p, const int (&v)[8]) {
  reinterpret_cast<int4*>(p)[0] = make_int4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<int4*>(p)[1] = make_int4(v[4], v[5], v[6], v[7]);
}

template <typename T>
__device__ __forceinline__ T* plane_of(int blk, T* y, T* u, T* v) {
  return blk < 4 ? y : (blk == 4 ? u : v);
}

// ---- K10: 48 threads an MB, one 8-sample row of one of its 8x8 blocks
// each, MBS MBs a block (the header says why)

namespace k10 {

constexpr int MBS = 2;              // MBs a block, even
constexpr int BLOCK = 48 * MBS;     // MBS luma warps, then MBS / 2 chroma
static_assert(MBS % 2 == 0, "a chroma warp holds the rows of two MBs");

// floor(n / d) for every uint32 n and d >= 2, from d's reciprocal r:
// floor(n (2^32 + m) / 2^(32 + s)), the sum n + t halved as t + (n - t) / 2
// so that it stays in 32 bits (t = floor(n m / 2^32) <= n)
__device__ __forceinline__ unsigned udiv(unsigned n, int4 r) {
  const unsigned t = __umulhi(n, static_cast<unsigned>(r.x));
  return (t + ((n - t) >> 1)) >> r.y;
}

// ops.trunc_div_pos(n, d) for |n| < 2^31
__device__ __forceinline__ int tdiv(int n, int4 r) {
  const int q = static_cast<int>(udiv(static_cast<unsigned>(abs(n)), r));
  return n < 0 ? -q : q;
}

// ops.rounded_div_pos(n, d) for |n| + d / 2 < 2^31: n - d / 2 (n < 0) or
// n + d / 2 (n >= 0) truncated, that is sign(n) floor((|n| + d / 2) / d)
__device__ __forceinline__ int rdiv(int n, int4 r) {
  const int q =
      static_cast<int>(udiv(static_cast<unsigned>(abs(n) + r.w), r));
  return n < 0 ? -q : q;
}

// ops.fdct8's pass1d over 8 samples, in place: output k is
// fdct_out(sum_j x_j B[k][j]), the sum scaled * 45 / 128 (k 0) or / 2 and
// truncated, then rounded / 128. B[k][7 - j] = (-1)^k B[k][j], so even k
// sum (x_j + x_7-j) B[k][j] and odd k (x_j - x_7-j) B[k][j] over j < 4:
// the same integer sums (|x| <= 2^15, |B| <= 128: no sum leaves 2^26).
__device__ __forceinline__ void fdct8(int (&x)[8]) {
  int e[4], o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    e[j] = x[j] + x[7 - j];
    o[j] = x[j] - x[7 - j];
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int acc = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc += ((k & 1) ? o[j] : e[j]) * B8(8 * k + j);
    x[k] = wrap16(rdiv128(k == 0 ? acc * 45 / 128 : acc / 2));
  }
}

// ops.quantize_8x8 then dequantize_8x8 of coefficient v (ops.quantize_8x8
// of an intra block replaces its DC with the DC scale's): sets q, the
// quantized coefficient, and d, its dequantized value. qm, dcs, q2, sf:
// the reciprocals of the matrix entry, the plane's DC scale at qp, qp << 1
// (whose half is qp) and the scale factor. For qp 1..255 no dividend
// reaches 2^31: |v| <= 2^15, sf 16, qm <= 45, so |v sf| <= 2^19 and
// |2 q qm qp| < 2^30.
__device__ __forceinline__ void quant(int v, bool intra, bool dc, int qp,
                                      int4 qm, int4 dcs, int4 q2, int4 sf,
                                      int& q, int& d) {
  if (intra && dc) {
    q = wrap16(rdiv(v, dcs));
    d = wrap16(q * dcs.z);
    return;
  }
  if (intra) {
    q = wrap16(rdiv(rdiv(v * sf.z, qm), q2));
  } else {
    const int qf = wrap16(rdiv(v * sf.z, qm));
    const int sign = (qf > 0) - (qf < 0);
    q = wrap16(rdiv(qf - sign * qp, q2));
  }
  d = wrap16(tdiv(2 * q * qm.z * qp, sf));
}

}  // namespace k10

// The planes' 16-byte alignment is the wrapper's to ensure
// (cuda_tail.encode_tail copies a plane that is not so aligned).
__global__ void __launch_bounds__(k10::BLOCK)
encode_tail_kernel(const int* __restrict__ src_y,
                   const int* __restrict__ src_u,
                   const int* __restrict__ src_v,
                   const int* __restrict__ pred_y,
                   const int* __restrict__ pred_u,
                   const int* __restrict__ pred_v,
                   const uint8_t* __restrict__ is_intra,
                   const uint8_t* __restrict__ is_motion,
                   const uint8_t* __restrict__ is_copy,
                   const int* __restrict__ quality,
                   const int16_t* __restrict__ coef_y,
                   const int16_t* __restrict__ coef_u,
                   const int16_t* __restrict__ coef_v,
                   const int* __restrict__ recip, int n, int w,
                   int adaptive, int top, int16_t* __restrict__ out_y,
                   int16_t* __restrict__ out_u, int16_t* __restrict__ out_v,
                   int* __restrict__ qp_out, int16_t* __restrict__ var_out,
                   int* __restrict__ rec_y, int* __restrict__ rec_u,
                   int* __restrict__ rec_v) {
  using namespace k10;
  __shared__ int tr[BLOCK / 32][4 * TB];
  __shared__ int qp_s[MBS];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, r = lane & 7;

  // this thread's MB, block (0-3 the luma quadrants, 4 U, 5 V) and row r
  const bool luma = warp < MBS;
  const int local = luma ? warp : 2 * (warp - MBS) + (lane >> 4);
  const int mb = blockIdx.x * MBS + local;
  const bool live = mb < n;   // uniform over a luma warp
  const int blk = luma ? lane >> 3 : 4 + ((lane >> 3) & 1);
  const int wb = w / MB, bx = mb % wb, by = mb / wb;
  const int pitch = luma ? w : w / 2;
  const size_t corner =
      luma ? static_cast<size_t>(by * MB + 8 * (blk >> 1)) * w + bx * MB +
                 8 * (blk & 1)
           : static_cast<size_t>(by * 8) * pitch + bx * 8;
  const size_t at = corner + static_cast<size_t>(r) * pitch;

  int p[8] = {}, x[8] = {};
  bool intra = false, copy = false;
  if (live) {
    load8(plane_of(blk, pred_y, pred_u, pred_v) + at, p);
    load8(plane_of(blk, src_y, src_u, src_v) + at, x);
    intra = is_intra[mb] && !is_motion[mb];
    copy = is_copy[mb];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = wrap16(sub_w(x[j], p[j]));
  int* buf = tr[warp] + (lane >> 3) * TB;
  fdct8(x);              // rows
  transpose(x, buf, r);
  fdct8(x);              // columns: x[k] is the block's coefficient (k, r)

  if (luma) {
    // ops.block_variance2: the MB's nonzero coefficients but its [0][0]
    // (quadrant 0's DC), in wrapping int32 sums
    unsigned cnt = 0, sum = 0, sq = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const bool m = x[k] != 0 && (k | r | blk) != 0;
      cnt += m ? 1u : 0u;
      sum += m ? unsigned(x[k]) : 0u;
      sq += m ? unsigned(x[k]) * unsigned(x[k]) : 0u;
    }
    cnt = __reduce_add_sync(FULL, cnt);
    sum = __reduce_add_sync(FULL, sum);
    sq = __reduce_add_sync(FULL, sq);
    const int count = int(cnt), c1 = count > 0 ? count : 1;
    const int prod = mul_w(int(sum), int(sum));
    const int var = count > 0
        ? sub_w(int(sq), trunc_div_pos(add_w(prod, c1 / 2), c1)) : 0;
    const int q = *quality;
    int qp = q;
    if (adaptive) {   // ops.adaptive_qp
      const unsigned u = unsigned(var);
      const int index = clampi((u ? 31 - __clz(u) : 0) >> 1, 1, top);
      const int up = clampi(q + ((index - q) >> 1), 1, top);
      const int down = clampi(q - ((q - index) >> 1), 1, top);
      qp = index > q ? up : (index < q ? down : q);
    }
    if (lane == 0) {
      qp_s[local] = qp;
      if (live) {
        qp_out[mb] = qp;
        var_out[mb] = int16_t(wrap16(var));
      }
    }
  }
  __syncthreads();   // qp for the chroma warps

  const int qp = qp_s[local], qi = qp & 255;
  const int4* words = reinterpret_cast<const int4*>(recip);
  const int4* qmt = words + R_QM / 4 + (intra ? 0 : 64);
  const int4 dcs = __ldg(words + (luma ? R_DCL : R_DCC) / 4 + qi);
  const int4 q2 = __ldg(words + R_QP2 / 4 + qi);
  const int4 sf = __ldg(words + R_SF / 4);
  int c[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int q, d;
    quant(x[k], intra, k == 0 && r == 0, qp, __ldg(qmt + 8 * k + r), dcs, q2,
          sf, q, d);
    c[k] = q;
    x[k] = d;
  }
  transpose(c, buf, r);  // c: row r of the quantized block
  int16_t* out = plane_of(blk, out_y, out_u, out_v) + at;
  if (live) {   // a copy MB keeps the stale coefficients
    *reinterpret_cast<int4*>(out) =
        copy ? *reinterpret_cast<const int4*>(
                   plane_of(blk, coef_y, coef_u, coef_v) + at)
             : make_int4(pack16(c[0], c[1]), pack16(c[2], c[3]),
                         pack16(c[4], c[5]), pack16(c[6], c[7]));
  }
  idct8(x);              // columns
  transpose(x, buf, r);
  idct8(x);              // rows: x is the residual of row r
  if (live) {
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = copy ? p[j] : wrap16(add_w(x[j], p[j]));
    store8(plane_of(blk, rec_y, rec_u, rec_v) + at, x);
  }
}

// ---- K11: K10's threads and passes, the forward half left out (the
// header says why)

namespace k11 {

constexpr int MBS = 2;              // MBs a block, even
constexpr int BLOCK = 48 * MBS;     // MBS luma warps, then MBS / 2 chroma
static_assert(MBS % 2 == 0, "a chroma warp holds the rows of two MBs");
constexpr int SF = 16;              // tables.QUANTIZER_SCALE_FACTOR

}  // namespace k11

// The planes' 16-byte alignment is the wrapper's to ensure
// (cuda_tail.decode_tail copies a plane that is not so aligned).
__global__ void __launch_bounds__(k11::BLOCK)
decode_tail_kernel(const int* __restrict__ coef_y,
                   const int* __restrict__ coef_u,
                   const int* __restrict__ coef_v,
                   const int* __restrict__ qp_in,
                   const uint8_t* __restrict__ intra_default,
                   const uint8_t* __restrict__ is_copy,
                   const int* __restrict__ pred_y,
                   const int* __restrict__ pred_u,
                   const int* __restrict__ pred_v,
                   const int16_t* __restrict__ stale_y,
                   const int16_t* __restrict__ stale_u,
                   const int16_t* __restrict__ stale_v,
                   const int* __restrict__ recip, int n, int w,
                   int* __restrict__ rec_y, int* __restrict__ rec_u,
                   int* __restrict__ rec_v, int16_t* __restrict__ carried_y,
                   int16_t* __restrict__ carried_u,
                   int16_t* __restrict__ carried_v, int* __restrict__ res_y,
                   int* __restrict__ res_u, int* __restrict__ res_v) {
  using namespace k11;
  __shared__ int tr[BLOCK / 32][4 * TB];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, r = lane & 7;

  // this thread's MB, block (0-3 the luma quadrants, 4 U, 5 V) and row r
  const bool luma = warp < MBS;
  const int mb =
      blockIdx.x * MBS + (luma ? warp : 2 * (warp - MBS) + (lane >> 4));
  // whole 8-lane blocks leave: each transpose syncs only its block's lanes
  if (mb >= n) return;
  const int blk = luma ? lane >> 3 : 4 + ((lane >> 3) & 1);
  const int wb = w / MB, bx = mb % wb, by = mb / wb;
  const int pitch = luma ? w : w / 2;
  const size_t corner =
      luma ? static_cast<size_t>(by * MB + 8 * (blk >> 1)) * w + bx * MB +
                 8 * (blk & 1)
           : static_cast<size_t>(by * 8) * pitch + bx * 8;
  const size_t at = corner + static_cast<size_t>(r) * pitch;
  const unsigned lanes = 0xFFu << (lane & 24);   // this 8x8 block's
  const bool copy = is_copy[mb];
  const int qp = qp_in[mb];
  const bool intra = intra_default[mb];

  int p[8];
  load8(plane_of(blk, pred_y, pred_u, pred_v) + at, p);
  int* rec = plane_of(blk, rec_y, rec_u, rec_v) + at;
  if (copy && res_y == nullptr) {
    // no one reads its residual: the carry (engine.carry_coef keeps a copy
    // MB's stale coefficients; carried_y is given only with stale_y) and
    // the prediction, row for row
    if (carried_y != nullptr) {
      *reinterpret_cast<int4*>(plane_of(blk, carried_y, carried_u,
                                        carried_v) + at) =
          *reinterpret_cast<const int4*>(
              plane_of(blk, stale_y, stale_u, stale_v) + at);
    }
    store8(rec, p);
    return;
  }
  // column r of the block's coefficients (the stale ones of a copy MB
  // where the carry asks): for each j the 8 lanes read one 32-byte sector
  int v[8];
  const size_t col = corner + r;
  if (copy && stale_y != nullptr) {
    const int16_t* c = plane_of(blk, stale_y, stale_u, stale_v) + col;
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = c[j * pitch];
  } else {
    const int* c = plane_of(blk, coef_y, coef_u, coef_v) + col;
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = c[j * pitch];
  }
  if (carried_y != nullptr) {
    int16_t* c = plane_of(blk, carried_y, carried_u, carried_v) + col;
#pragma unroll
    for (int j = 0; j < 8; ++j) c[j * pitch] = static_cast<int16_t>(v[j]);
  }
  // ops.dequantize_8x8 of the coefficients (j, r) (the header's domain:
  // C's / is trunc_div_pos, no product wraps)
  const int* qm = recip + R_QM + (intra ? 0 : 256) + 2 + 4 * r;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = wrap16(intra && j == 0 && r == 0
        ? mul_w(v[j], __ldg(recip + (luma ? R_DCL : R_DCC) +
                            4 * (qp & 255) + 2))
        : mul_w(mul_w(2 * v[j], __ldg(qm + 32 * j)), qp) / SF);
  }
  idct8(v);                        // columns
  transpose(v, tr[warp] + (lane >> 3) * TB, r, lanes);
  idct8(v);                        // rows: v is the residual of row r
  if (res_y != nullptr) {          // (N, 16, 16) luma, (N, 8, 8) chroma
    store8(luma ? res_y + mb * 256 + (8 * (blk >> 1) + r) * 16 +
                      8 * (blk & 1)
                : plane_of(blk, res_y, res_u, res_v) + mb * 64 + r * 8,
           v);
  }
  if (!copy) {
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j] = wrap16(add_w(v[j], p[j]));
  }
  store8(rec, p);
}

}  // namespace

// planes as cuda_tail.encode_tail takes them, 16-byte aligned; recip: the
// R_WORDS reciprocal words
extern "C" int cairo_encode_tail(
    const int* src_y, const int* src_u, const int* src_v, const int* pred_y,
    const int* pred_u, const int* pred_v, const uint8_t* is_intra,
    const uint8_t* is_motion, const uint8_t* is_copy, const int* quality,
    const int16_t* coef_y, const int16_t* coef_u, const int16_t* coef_v,
    const int* recip, int h, int w, int adaptive, int top, int16_t* out_y,
    int16_t* out_u, int16_t* out_v, int* qp, int16_t* variance, int* rec_y,
    int* rec_u, int* rec_v, cudaStream_t stream) {
  const int n = (h / MB) * (w / MB);
  if (n == 0) return 0;
  encode_tail_kernel<<<(n + k10::MBS - 1) / k10::MBS, k10::BLOCK, 0,
                       stream>>>(
      src_y, src_u, src_v, pred_y, pred_u, pred_v, is_intra, is_motion,
      is_copy, quality, coef_y, coef_u, coef_v, recip, n, w, adaptive, top,
      out_y, out_u, out_v, qp, variance, rec_y, rec_u, rec_v);
  return static_cast<int>(cudaGetLastError());
}

// planes as cuda_tail.decode_tail takes them, 16-byte aligned (stale and
// carried both given or both null; res null or given); recip: the R_WORDS
// reciprocal words
extern "C" int cairo_decode_tail(
    const int* coef_y, const int* coef_u, const int* coef_v, const int* qp,
    const uint8_t* intra_default, const uint8_t* is_copy, const int* pred_y,
    const int* pred_u, const int* pred_v, const int16_t* stale_y,
    const int16_t* stale_u, const int16_t* stale_v, const int* recip, int h,
    int w, int* rec_y, int* rec_u, int* rec_v, int16_t* carried_y,
    int16_t* carried_u, int16_t* carried_v, int* res_y, int* res_u,
    int* res_v, cudaStream_t stream) {
  const int n = (h / MB) * (w / MB);
  if (n == 0) return 0;
  decode_tail_kernel<<<(n + k11::MBS - 1) / k11::MBS, k11::BLOCK, 0,
                       stream>>>(
      coef_y, coef_u, coef_v, qp, intra_default, is_copy, pred_y, pred_u,
      pred_v, stale_y, stale_u, stale_v, recip, n, w, rec_y, rec_u, rec_v,
      carried_y, carried_u, carried_v, res_y, res_u, res_v);
  return static_cast<int>(cudaGetLastError());
}

// K11's scale factor, which cuda_tail holds against
// tables.QUANTIZER_SCALE_FACTOR
extern "C" int cairo_decode_tail_sf() { return k11::SF; }
