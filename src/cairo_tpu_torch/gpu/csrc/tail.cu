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
// (0.013 ms at 3.35 TB/s), against some 116 integer operations a sample
// (0.36 G, 0.011 ms at 33.5 Tops/s: the two bounds are close). K11 reads
// int32 coefficients and prediction and writes int32 recon (and, asked,
// the int16 carried coefficients and the int32 residual blocks): 44 MB
// on the COO decode, against 63 operations a sample (0.2 G).
//
// Design, simple first: one block of 384 threads per MB, one thread per
// sample of its six 8x8 blocks (the four luma quadrants TL, TR, BL, BR,
// then U and V). Each 1-D pass is a sum of 8 products over a row or a
// column that the block stages in shared memory; the variance is a block
// reduction (warp reductions, then one thread), and qp is broadcast
// through shared memory before quantization. Planes in, planes out: a
// thread reads and writes its own sample of each plane (eight threads a
// 32-byte row segment), so no block layout is copied around a launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using cairo::add_w;
using cairo::clampi;
using cairo::FULL;
using cairo::MB;
using cairo::mul_w;
using cairo::rounded_div_pos;
using cairo::sub_w;
using cairo::trunc_div_pos;
using cairo::wrap16;

constexpr int THREADS = 384;   // 6 blocks of 64 samples: one MB
constexpr int LUMA = 256;      // the luma quadrants' threads

// ops.consts' tables (device pointers) and the quantizer's scale factor
struct Tables {
  const int* basis;      // DCT_BASIS_8, B[k][j] at 8 k + j
  const int* intra_qm;
  const int* inter_qm;
  const int* luma_dc;    // indexed by qp, 256 entries
  const int* chroma_dc;
  int sf;                // QUANTIZER_SCALE_FACTOR
};

// Thread t's sample of MB `mb` in a frame w luma samples wide: block
// b = t / 64, row r and column c inside it; `at` its index in its plane.
struct Sample {
  int b, r, c, at;

  __device__ Sample(int t, int mb, int w) {
    b = t >> 6;
    r = (t >> 3) & 7;
    c = t & 7;
    const int wb = w / MB, mx = mb % wb, my = mb / wb;
    at = b < 4 ? (my * MB + 8 * (b >> 1) + r) * w + mx * MB + 8 * (b & 1) + c
               : (my * 8 + r) * (w / 2) + mx * 8 + c;
  }

  template <typename T>
  __device__ T* of(T* y, T* u, T* v) const {
    return b < 4 ? y : (b == 4 ? u : v);
  }

  // index in the residual blocks: (N, 16, 16) luma, (N, 8, 8) chroma
  __device__ int block_at(int mb) const {
    return b < 4 ? mb * 256 + (8 * (b >> 1) + r) * 16 + 8 * (b & 1) + c
                 : mb * 64 + r * 8 + c;
  }

  __device__ bool dc() const { return r == 0 && c == 0; }
};

// ---- the 1-D passes, over the block of 64 samples staged at buf[base]

// ops.fdct8's pass1d output k from its sum of products
__device__ __forceinline__ int fdct_out(int acc, int k) {
  const int v = k == 0 ? trunc_div_pos(mul_w(acc, 45), 128)
                       : trunc_div_pos(acc, 2);
  return wrap16(rounded_div_pos(v, 128));
}

// ops.idct8's pass1d term j: v * B[j][k], the DC term (j 0) scaled
// * 45 / 128, the others / 2, each truncated before the sum
__device__ __forceinline__ int idct_term(int v, int bjk, int j) {
  const int p = mul_w(v, bjk);
  return j == 0 ? trunc_div_pos(mul_w(p, 45), 128) : trunc_div_pos(p, 2);
}

// ops.fdct8 of the block holding this thread's sample x: rows, then
// columns; returns the thread's coefficient. buf: 2 * THREADS ints.
__device__ int forward(int x, const Sample& s, int* buf, const int* B) {
  const int t = threadIdx.x, base = t & ~63;
  buf[t] = x;
  __syncthreads();
  int acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    acc = add_w(acc, mul_w(buf[base + s.r * 8 + j], B[s.c * 8 + j]));
  buf[THREADS + t] = fdct_out(acc, s.c);
  __syncthreads();
  acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    acc = add_w(acc, mul_w(B[s.r * 8 + j], buf[THREADS + base + j * 8 + s.c]));
  return fdct_out(acc, s.r);
}

// ops.idct8 of the block holding this thread's dequantized coefficient
// d: columns, then rows; returns the thread's residual sample.
__device__ int inverse(int d, const Sample& s, int* buf, const int* B) {
  const int t = threadIdx.x, base = t & ~63;
  __syncthreads();   // the previous pass's reads of buf are done
  buf[t] = d;
  __syncthreads();
  int acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    acc = add_w(acc, idct_term(buf[base + j * 8 + s.c], B[j * 8 + s.r], j));
  buf[THREADS + t] = wrap16(rounded_div_pos(acc, 128));
  __syncthreads();
  acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    acc = add_w(acc, idct_term(buf[THREADS + base + s.r * 8 + j],
                               B[j * 8 + s.c], j));
  return wrap16(rounded_div_pos(acc, 128));
}

// ---- quantization (ops.quantize_8x8 / dequantize_8x8 at one sample)

__device__ __forceinline__ int dc_scale(const Sample& s, const Tables& tb,
                                        int qp) {
  return (s.b < 4 ? tb.luma_dc : tb.chroma_dc)[qp & 255];
}

__device__ int quantize(int v, const Sample& s, bool intra, int qp,
                        const Tables& tb) {
  const int i = s.r * 8 + s.c;
  if (intra) {
    if (s.dc()) return wrap16(rounded_div_pos(v, dc_scale(s, tb, qp)));
    return wrap16(rounded_div_pos(
        rounded_div_pos(mul_w(v, tb.sf), tb.intra_qm[i]), qp << 1));
  }
  const int qf = wrap16(rounded_div_pos(mul_w(v, tb.sf), tb.inter_qm[i]));
  const int sign = (qf > 0) - (qf < 0);
  return wrap16(rounded_div_pos(sub_w(qf, mul_w(sign, qp)), qp << 1));
}

__device__ int dequantize(int v, const Sample& s, bool intra, int qp,
                          const Tables& tb) {
  const int i = s.r * 8 + s.c;
  if (intra && s.dc()) return wrap16(mul_w(v, dc_scale(s, tb, qp)));
  const int qm = (intra ? tb.intra_qm : tb.inter_qm)[i];
  return wrap16(trunc_div_pos(mul_w(mul_w(mul_w(2, v), qm), qp), tb.sf));
}

// stages the basis in shared memory
__device__ __forceinline__ void load_basis(int* B, const Tables& tb) {
  if (threadIdx.x < 64) B[threadIdx.x] = tb.basis[threadIdx.x];
}

// ---- K10

__global__ void __launch_bounds__(THREADS)
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
                   const int16_t* __restrict__ coef_v, Tables tb, int w,
                   int adaptive, int top, int16_t* __restrict__ out_y,
                   int16_t* __restrict__ out_u, int16_t* __restrict__ out_v,
                   int* __restrict__ qp_out, int16_t* __restrict__ var_out,
                   int* __restrict__ rec_y, int* __restrict__ rec_u,
                   int* __restrict__ rec_v) {
  __shared__ int buf[2 * THREADS];
  __shared__ int B[64];
  __shared__ unsigned red[LUMA / 32][3];
  __shared__ int qp_s;
  const int mb = blockIdx.x, t = threadIdx.x;
  const Sample s(t, mb, w);
  load_basis(B, tb);
  const int pred = s.of(pred_y, pred_u, pred_v)[s.at];
  const int x = wrap16(sub_w(s.of(src_y, src_u, src_v)[s.at], pred));
  const int v = forward(x, s, buf, B);

  // variance (ops.block_variance2): the luma MB's nonzero coefficients
  // but its [0][0], in wrapping int32 sums
  if (t < LUMA) {
    const bool m = v != 0 && t != 0;
    const unsigned cnt = __reduce_add_sync(FULL, m ? 1u : 0u);
    const unsigned sum = __reduce_add_sync(FULL, m ? unsigned(v) : 0u);
    const unsigned sq =
        __reduce_add_sync(FULL, m ? unsigned(mul_w(v, v)) : 0u);
    if ((t & 31) == 0) {
      red[t >> 5][0] = cnt;
      red[t >> 5][1] = sum;
      red[t >> 5][2] = sq;
    }
  }
  __syncthreads();
  if (t == 0) {
    unsigned cnt = 0, sum = 0, sq = 0;
    for (int i = 0; i < LUMA / 32; ++i) {
      cnt += red[i][0];
      sum += red[i][1];
      sq += red[i][2];
    }
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
    qp_s = qp;
    qp_out[mb] = qp;
    var_out[mb] = int16_t(wrap16(var));
  }
  __syncthreads();

  const int qp = qp_s;
  const bool intra = is_intra[mb] && !is_motion[mb];
  const bool copy = is_copy[mb];
  const int q = quantize(v, s, intra, qp, tb);
  s.of(out_y, out_u, out_v)[s.at] =
      copy ? s.of(coef_y, coef_u, coef_v)[s.at] : int16_t(q);
  const int res = inverse(dequantize(q, s, intra, qp, tb), s, buf, B);
  s.of(rec_y, rec_u, rec_v)[s.at] = copy ? pred : wrap16(add_w(res, pred));
}

// ---- K11

__global__ void __launch_bounds__(THREADS)
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
                   const int16_t* __restrict__ stale_v, Tables tb, int w,
                   int* __restrict__ rec_y, int* __restrict__ rec_u,
                   int* __restrict__ rec_v, int16_t* __restrict__ carried_y,
                   int16_t* __restrict__ carried_u,
                   int16_t* __restrict__ carried_v, int* __restrict__ res_y,
                   int* __restrict__ res_u, int* __restrict__ res_v) {
  __shared__ int buf[2 * THREADS];
  __shared__ int B[64];
  const int mb = blockIdx.x, t = threadIdx.x;
  const Sample s(t, mb, w);
  load_basis(B, tb);
  const bool copy = is_copy[mb];
  // the carry (engine.carry_coef): a copy MB keeps the stale coefficients
  int v;
  if (stale_y != nullptr && copy) {
    v = s.of(stale_y, stale_u, stale_v)[s.at];
  } else {
    v = s.of(coef_y, coef_u, coef_v)[s.at];
  }
  if (carried_y != nullptr)
    s.of(carried_y, carried_u, carried_v)[s.at] = int16_t(wrap16(v));
  const int res = inverse(dequantize(v, s, intra_default[mb], qp_in[mb], tb),
                          s, buf, B);
  if (res_y != nullptr) s.of(res_y, res_u, res_v)[s.block_at(mb)] = res;
  const int pred = s.of(pred_y, pred_u, pred_v)[s.at];
  s.of(rec_y, rec_u, rec_v)[s.at] = copy ? pred : wrap16(add_w(res, pred));
}

}  // namespace

extern "C" int cairo_encode_tail(
    const int* src_y, const int* src_u, const int* src_v, const int* pred_y,
    const int* pred_u, const int* pred_v, const uint8_t* is_intra,
    const uint8_t* is_motion, const uint8_t* is_copy, const int* quality,
    const int16_t* coef_y, const int16_t* coef_u, const int16_t* coef_v,
    const int* basis, const int* intra_qm, const int* inter_qm,
    const int* luma_dc, const int* chroma_dc, int h, int w, int adaptive,
    int sf, int top, int16_t* out_y, int16_t* out_u, int16_t* out_v,
    int* qp, int16_t* variance, int* rec_y, int* rec_u, int* rec_v,
    cudaStream_t stream) {
  const int n = (h / MB) * (w / MB);
  const Tables tb{basis, intra_qm, inter_qm, luma_dc, chroma_dc, sf};
  encode_tail_kernel<<<n, THREADS, 0, stream>>>(
      src_y, src_u, src_v, pred_y, pred_u, pred_v, is_intra, is_motion,
      is_copy, quality, coef_y, coef_u, coef_v, tb, w, adaptive, top, out_y,
      out_u, out_v, qp, variance, rec_y, rec_u, rec_v);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cairo_decode_tail(
    const int* coef_y, const int* coef_u, const int* coef_v, const int* qp,
    const uint8_t* intra_default, const uint8_t* is_copy, const int* pred_y,
    const int* pred_u, const int* pred_v, const int16_t* stale_y,
    const int16_t* stale_u, const int16_t* stale_v, const int* basis,
    const int* intra_qm, const int* inter_qm, const int* luma_dc,
    const int* chroma_dc, int h, int w, int sf, int* rec_y, int* rec_u,
    int* rec_v, int16_t* carried_y, int16_t* carried_u, int16_t* carried_v,
    int* res_y, int* res_u, int* res_v, cudaStream_t stream) {
  const int n = (h / MB) * (w / MB);
  const Tables tb{basis, intra_qm, inter_qm, luma_dc, chroma_dc, sf};
  decode_tail_kernel<<<n, THREADS, 0, stream>>>(
      coef_y, coef_u, coef_v, qp, intra_default, is_copy, pred_y, pred_u,
      pred_v, stale_y, stale_u, stale_v, tb, w, rec_y, rec_u, rec_v,
      carried_y, carried_u, carried_v, res_y, res_u, res_v);
  return static_cast<int>(cudaGetLastError());
}
