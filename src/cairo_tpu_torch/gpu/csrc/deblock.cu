// In-loop deblock kernel for Hopper (sm_90a): K8.
//
// K8 deblock_frame replaces the in-loop deblock of cairo_tpu/tpu/deblock.py
// (deblock_frame, :143), which runs as one XLA fori_loop over the 8-row
// bands of each plane (deblock_plane, :117) inside the step's jit; no
// Pallas kernel runs it. Y is filtered at 16-px MBs with the luma filter,
// U and V at 8-px cells with the chroma filter: band 0's vertical edges,
// then for each band b >= 1 the horizontal edge at row 8b and band b's
// vertical edges. Strength and QP come from the two MBs an edge separates
// (deblock._edge_maps), alpha and beta from tables.DEBLOCK_ALPHA/BETA.
//
// The dependence is three layers deep, not one per band. The horizontal
// edge at row y = 8b reads rows y-4 .. y+3 and writes y-3 .. y+2; a
// vertical edge reads and writes within one row. The rows it reads on its
// p side, y-4 .. y-1, are rows 4 .. 7 of band b-1, which the edge at
// y - 8 never writes: they hold the input after band b-1's vertical edges.
// Its q side, rows y .. y+3, is still the input when it runs. So the
// plane is three passes, each fully parallel:
//   1. vertical edges on every row r with r % 8 >= 4, and on band 0's
//      rows 0 .. 3, reading the input;
//   2. every horizontal edge y = 8b (b >= 1) on every column, reading
//      pass 1's rows y-4 .. y-1 and the input rows y .. y+3 (row y+3 the
//      unfiltered input: its vertical edges run after this edge);
//   3. vertical edges on rows 8b .. 8b+3 (b >= 1), reading pass 2's rows
//      8b .. 8b+2 and the input row 8b+3.
// An output tile's rows therefore depend on the input within 4 rows and
// 4 columns of it and on nothing else: tiles need no order and no waiting.
//
// What bounds it on this card: bytes. A 1080p frame is 3,133,440 int32
// samples read once and written once, 25.1 MB or 7.5 us at 3.35 TB/s;
// the filter is some 80 integer operations for each of 777,000 edge
// samples, about 2 us at one operation per lane and clock.
//
// Design: one block per output tile of TH x TW samples of one plane; Y's
// tiles first in the grid, then U's, then V's, one launch for the frame.
//   * Staging. The block copies input rows [Y0-4, Y0+TH+4) and columns
//     [X0-4, X0+TW+4), clipped to the plane, into shared memory with
//     16-byte cp.async (X0 - 4 and the plane width are multiples of 4,
//     so a 16-byte chunk lies wholly inside or outside the plane). Rows
//     are PITCH words apart, 33 chunks, so that two neighbouring rows of
//     one 8-column window fall in other banks.
//   * The three passes run in place in shared memory with a barrier
//     between them, one filter evaluation per (edge, row) item of passes
//     1 and 3 (taps read and written as two 16-byte words; 8 lanes that
//     share a 16-byte phase hold 4 edges of 2 rows, which meet no bank
//     twice), and one per column of pass 2 (a thread takes one edge over
//     4 columns, one 16-byte word a row). Pass 2 covers all staged
//     columns, since pass 3's edges at the tile's sides read the halo.
//     Items of one pass touch disjoint samples.
//   * Stores. Each output sample once, 16 bytes a thread, into new planes
//     (the inputs stay as they were).
//   * Strengths and QPs from the per-MB copy flags and q for each item:
//     0 where both MBs are copies, 1 where one is, 2 otherwise; QP the
//     mean of two coded MBs' q, the coded side's q beside a copy, 0
//     between copies (a copy MB's own q never reaches the result). q must
//     be in 0 .. 31.
//   * The filter computes the strength-1 and strength-2 results and
//     selects, so lanes of other strengths do not diverge. Samples may lie
//     outside 0 .. 255 (recon overshoot); the sums are taken modulo 2^32
//     and divided as ops.py divides (common.cuh), so any int32 input gives
//     the plain version's int32 result.
// Input planes must be 16-byte aligned (the wrapper copies one that is
// not).

#include "common.cuh"

namespace {

using namespace cairo;

constexpr int STEP = 8;       // cell edge and band height
constexpr int HALO = 4;       // taps an edge reads on each side
constexpr int TH = 32;        // tile rows: 4 bands
constexpr int TW = 120;       // tile columns: 15 cells
constexpr int PITCH = 132;    // shared words a staged row: 33 chunks
constexpr int THREADS = 256;
constexpr int QP_LEVELS = 32;

constexpr int SH = TH + 2 * HALO;   // staged rows
constexpr int SW = TW + 2 * HALO;   // staged columns
constexpr int CHUNKS = SW / 4;      // 16-byte chunks a staged row
static_assert(SW <= PITCH && PITCH % 4 == 0 && (PITCH / 4) % 2 == 1,
              "rows 16-byte aligned, neighbouring rows in other banks");

// tables.DEBLOCK_ALPHA and tables.DEBLOCK_BETA
__constant__ int ALPHA[QP_LEVELS] = {
    0, 0, 0, 0, 0, 0, 0, 1,  1,  1,  2,  2,  3,  3,  4,  5,
    6, 7, 8, 9, 10, 12, 14, 16, 18, 20, 22, 24, 26, 29, 32, 35};
__constant__ int BETA[QP_LEVELS] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 3,
    3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 10, 11};

struct Plane {
  const int* in;   // (h, w) int32, 16-byte aligned
  int* out;        // (h, w) int32
  int h, w;
};

// per-MB maps: copy flags and q, (rows, wb)
struct Maps {
  const uint8_t* copy;
  const int* q;
  int wb;
};

__device__ __forceinline__ int abs_w(int v) { return v < 0 ? sub_w(0, v) : v; }

// element i (0 .. 3, known at compile time) of a 16-byte word
__device__ __forceinline__ int& word(int4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// strength and QP of an edge between MBs (ra, ca) and (rb, cb)
// (deblock._edge_maps)
__device__ __forceinline__ void strength_qp(const Maps& m, int ra, int ca,
                                            int rb, int cb, int& s,
                                            int& qp) {
  const bool pa = __ldg(m.copy + ra * m.wb + ca) != 0;
  const bool pb = __ldg(m.copy + rb * m.wb + cb) != 0;
  const int qa = __ldg(m.q + ra * m.wb + ca), qb = __ldg(m.q + rb * m.wb + cb);
  s = pa && pb ? 0 : (pa != pb ? 1 : 2);
  qp = !pa && !pb ? (qa + qb) >> 1 : (!pa ? qa : (!pb ? qb : 0));
}

// deblock._filter: t holds p3 .. q3 on entry and the filtered p3 .. q3 on
// return (p3 and q3 unchanged); ab holds alpha (0 .. 31) and beta (32 ..
// 63). Both strengths' results are computed and one is selected.
template <bool LUMA>
__device__ __forceinline__ void filter(int (&t)[8], int s, int qp,
                                       const int* ab) {
  const int p2 = t[1], p1 = t[2], p0 = t[3];
  const int q0 = t[4], q1 = t[5], q2 = t[6];
  const uint32_t P3 = t[0], P2 = p2, P1 = p1, P0 = p0;
  const uint32_t Q0 = q0, Q1 = q1, Q2 = q2, Q3 = t[7];
  const int level = clampi(qp, 0, QP_LEVELS - 1);
  const int alpha = ab[level], beta = ab[QP_LEVELS + level];
  const bool keep = abs_w(sub_w(p0, q0)) >= alpha ||
                    abs_w(sub_w(p1, p0)) >= beta ||
                    abs_w(sub_w(q1, q0)) >= beta || s == 0;
  const bool is2 = s == 2;
  const int s2p0 = rounded_div_pos(
      static_cast<int>(P2 + 2 * P1 + 2 * P0 + 2 * Q0 + Q1), 8);
  const int s2q0 = rounded_div_pos(
      static_cast<int>(P1 + 2 * P0 + 2 * Q0 + 2 * Q1 + Q2), 8);
  const int s2p1 = rounded_div_pos(static_cast<int>(P2 + P1 + P0 + Q0), 4);
  const int s2q1 = rounded_div_pos(static_cast<int>(P0 + Q0 + Q1 + Q2), 4);
  const int s1p0 =
      rounded_div_pos(static_cast<int>((Q0 + P0) * 4 + P1 - Q1), 8);
  const int s1q0 =
      rounded_div_pos(static_cast<int>((Q0 + P0) * 4 + Q1 - P1), 8);
  int np2 = p2, nq2 = q2, np1, nq1;
  if constexpr (LUMA) {
    const int s1p1 =
        rounded_div_pos(static_cast<int>(P2 * 4 + P0 * 2 + Q0 * 2), 8);
    const int s1q1 =
        rounded_div_pos(static_cast<int>(Q2 * 4 + Q0 * 2 + P0 * 2), 8);
    const int s2p2 = rounded_div_pos(
        static_cast<int>(2 * P3 + 3 * P2 + P1 + P0 + Q0), 8);
    const int s2q2 = rounded_div_pos(
        static_cast<int>(2 * Q3 + 3 * Q2 + Q1 + Q0 + P0), 8);
    np1 = is2 ? s2p1 : s1p1;
    nq1 = is2 ? s2q1 : s1q1;
    np2 = is2 ? s2p2 : p2;
    nq2 = is2 ? s2q2 : q2;
  } else {
    np1 = is2 ? s2p1 : p1;
    nq1 = is2 ? s2q1 : q1;
  }
  t[1] = keep ? p2 : np2;
  t[2] = keep ? p1 : np1;
  t[3] = keep ? p0 : (is2 ? s2p0 : s1p0);
  t[4] = keep ? q0 : (is2 ? s2q0 : s1q0);
  t[5] = keep ? q1 : nq1;
  t[6] = keep ? q2 : nq2;
}

// The vertical edges of a pass on `rows` row slots: item k is edge e (at
// column X0 + 8 e, its taps at staged columns 8 e .. 8 e + 7) on row slot
// j, ordered so that the 8 items of a 16-byte phase are 4 edges of 2
// neighbouring slots. row(j) gives the slot's plane row, or -1 for none.
template <bool LUMA, typename Row>
__device__ __forceinline__ void vertical_pass(int* sm, const Plane& p,
                                              const Maps& m, int y0, int x0,
                                              int edges, int rows, Row row,
                                              const int* ab) {
  constexpr int MBC = LUMA ? 2 : 1;   // cells an MB edge
  const int quads = (edges + 3) / 4;
  for (int k = threadIdx.x; k < quads * 4 * rows; k += THREADS) {
    const int g = k >> 3;
    const int e = (k & 3) + 4 * (g % quads);
    const int j = ((k >> 2) & 1) + 2 * (g / quads);
    const int r = row(j);
    const int x = x0 + STEP * e;
    if (e >= edges || r < 0 || x <= 0 || x >= p.w) continue;
    int s, qp;
    const int mr = r / STEP / MBC, cell = x / STEP;
    strength_qp(m, mr, (cell - 1) / MBC, mr, cell / MBC, s, qp);
    int4* w = reinterpret_cast<int4*>(sm + (r - y0 + HALO) * PITCH +
                                      STEP * e);
    const int4 a = w[0], b = w[1];
    int t[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    filter<LUMA>(t, s, qp, ab);
    w[0] = make_int4(t[0], t[1], t[2], t[3]);
    w[1] = make_int4(t[4], t[5], t[6], t[7]);
  }
}

// One block's tile of one plane: tile index `tile` in raster order of the
// plane's ceil(h / TH) x ceil(w / TW) tiles.
template <bool LUMA>
__device__ __forceinline__ void deblock_tile(int* sm, const Plane& p,
                                             const Maps& m, int tile,
                                             const int* ab) {
  constexpr int MBC = LUMA ? 2 : 1;
  const int tiles_x = (p.w + TW - 1) / TW;
  const int y0 = tile / tiles_x * TH, x0 = tile % tiles_x * TW;
  const int bands = (min(y0 + TH, p.h) - y0) / STEP;   // the tile's bands
  const int cols = min(x0 + TW, p.w) - x0;

  // staged row i holds plane row y0 - HALO + i, staged column c plane
  // column x0 - HALO + c
  for (int k = threadIdx.x; k < SH * CHUNKS; k += THREADS) {
    const int i = k / CHUNKS, c = k % CHUNKS;
    const int r = y0 - HALO + i, x = x0 - HALO + 4 * c;
    if (r >= 0 && r < p.h && x >= 0 && x < p.w) {
      cp_async16z(sm + i * PITCH + 4 * c,
                  p.in + static_cast<size_t>(r) * p.w + x, 16);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // pass 1: rows 8n + 4 .. 8n + 7 of the band above the tile and of its
  // own bands; the band above the plane's first stands for band 0's rows
  // 0 .. 3
  const int edges = cols / STEP + 1;   // edges at X0, X0 + 8, .., X0 + cols
  const int b0 = y0 / STEP;
  vertical_pass<LUMA>(sm, p, m, y0, x0, edges, 4 * (bands + 1),
                      [b0](int j) {
                        const int b = b0 - 1 + j / 4;
                        return b < 0 ? j % 4 : STEP * b + 4 + j % 4;
                      }, ab);
  __syncthreads();

  // pass 2: the horizontal edges at rows y0 + 8n (0 < y < h), over every
  // staged column in the plane, 4 columns an item
  for (int k = threadIdx.x; k < (bands + 1) * CHUNKS; k += THREADS) {
    const int n = k / CHUNKS, c = k % CHUNKS;
    const int y = y0 + STEP * n, x = x0 - HALO + 4 * c;
    if (y <= 0 || y >= p.h || x < 0 || x >= p.w) continue;
    int s, qp;
    const int mc = x / STEP / MBC;
    strength_qp(m, (y / STEP - 1) / MBC, mc, y / STEP / MBC, mc, s, qp);
    int4* w = reinterpret_cast<int4*>(sm + STEP * n * PITCH + 4 * c);
    int4 v[STEP];
#pragma unroll
    for (int i = 0; i < STEP; ++i) v[i] = w[i * (PITCH / 4)];
#pragma unroll
    for (int col = 0; col < 4; ++col) {
      int t[8];
#pragma unroll
      for (int i = 0; i < STEP; ++i) t[i] = word(v[i], col);
      filter<LUMA>(t, s, qp, ab);
#pragma unroll
      for (int i = 1; i < STEP - 1; ++i) word(v[i], col) = t[i];
    }
#pragma unroll
    for (int i = 1; i < STEP - 1; ++i) w[i * (PITCH / 4)] = v[i];
  }
  __syncthreads();

  // pass 3: rows 8b .. 8b + 3 of the tile's bands b >= 1
  vertical_pass<LUMA>(sm, p, m, y0, x0, edges, 4 * bands,
                      [y0](int j) {
                        const int r = y0 + STEP * (j / 4) + j % 4;
                        return r < STEP ? -1 : r;
                      }, ab);
  __syncthreads();

  // stores: the tile's rows and columns, 4 columns an item
  const int out_chunks = cols / 4;
  for (int k = threadIdx.x; k < STEP * bands * out_chunks; k += THREADS) {
    const int i = k / out_chunks, c = k % out_chunks;
    const int4 v = *reinterpret_cast<const int4*>(
        sm + (HALO + i) * PITCH + HALO + 4 * c);
    *reinterpret_cast<int4*>(p.out + static_cast<size_t>(y0 + i) * p.w +
                             x0 + 4 * c) = v;
  }
}

// grid: ty blocks for Y's tiles, then tc for U's and tc for V's
__global__ void __launch_bounds__(THREADS, 4)
    deblock_kernel(const Plane py, const Plane pu, const Plane pv,
                   const Maps m, int ty, int tc) {
  __shared__ __align__(16) int sm[SH * PITCH];
  __shared__ int ab[2 * QP_LEVELS];
  for (int i = threadIdx.x; i < QP_LEVELS; i += THREADS) {
    ab[i] = ALPHA[i];
    ab[QP_LEVELS + i] = BETA[i];
  }
  const int blk = blockIdx.x;
  if (blk < ty) {
    deblock_tile<true>(sm, py, m, blk, ab);
    return;
  }
  // a chroma plane built from its fields: a struct picked at run time
  // would be copied to a stack frame
  const bool is_v = blk >= ty + tc;
  const Plane pc{is_v ? pv.in : pu.in, is_v ? pv.out : pu.out, pu.h, pu.w};
  deblock_tile<false>(sm, pc, m, blk - ty - (is_v ? tc : 0), ab);
}

// blocks for the tiles of an (h, w) plane
int tiles_for(int h, int w) {
  return ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
}

}  // namespace

// One launch on `stream` for the frame's three planes, Y (h, w) and U
// and V (h / 2, w / 2), into new planes of the same shapes; copy (uint8
// or bool) and q (int32) are the (h / 16, w / 16) MB maps. The planes
// must be 16-byte aligned.
// Returns the launch's CUDA error.
extern "C" int cairo_deblock_frame(const void* y, const void* u,
                                   const void* v, const void* copy,
                                   const void* q, int h, int w, void* out_y,
                                   void* out_u, void* out_v, void* stream) {
  const Plane py{static_cast<const int*>(y), static_cast<int*>(out_y), h, w};
  const Plane pu{static_cast<const int*>(u), static_cast<int*>(out_u), h / 2,
                 w / 2};
  const Plane pv{static_cast<const int*>(v), static_cast<int*>(out_v), h / 2,
                 w / 2};
  const Maps m{static_cast<const uint8_t*>(copy), static_cast<const int*>(q),
               w / cairo::MB};
  const int ty = tiles_for(h, w), tc = tiles_for(h / 2, w / 2);
  deblock_kernel<<<ty + 2 * tc, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(py, pu, pv, m, ty,
                                                        tc);
  return static_cast<int>(cudaGetLastError());
}
