// cairo-tpu native sequential decoder: full evx1 frame reconstruction on
// the host CPU (decode_block + in-loop deblock + RGB conversion).
//
// This is the fallback/runtime path for streams the parallel TPU decoder
// cannot batch — reference-encoder streams carry INTRA_MOTION_* blocks
// whose prediction reads the *current* frame's partially-reconstructed
// pixels in raster order (decode.cpp:15-144 in the reference defines the
// behavior; cpuref/engine.py is the tested Python anchor this file
// mirrors). Written as original code against docs/FORMAT.md semantics:
// planar int16 state, struct-of-arrays block table, table-driven exact
// integer math (rounded_div half-away-from-zero, truncating div, int16
// intermediate wraps).

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int MB = 16;
constexpr int RING = 4;
constexpr int SCALE = 16;  // QUANTIZER_SCALE_FACTOR

inline int rounded_div(int n, int d) {
    // math.h:228-236: round half away from zero (d > 0 here)
    int half = d / 2;
    int a = n < 0 ? n - half : n + half;
    return a / d;
}

inline int16_t wrap16(int v) { return (int16_t)v; }

inline bool t_intra(uint8_t t) { return t & 1; }
inline bool t_motion(uint8_t t) { return t & 2; }
inline bool t_copy(uint8_t t) { return t & 4; }

// wire-behavior constant tables (tables.py mirrors; values are format
// constants from quantize.cpp:13-55, deblock.cpp:13-27, xftables.h)
struct Tables {
    int32_t dct[8][8];        // DCT_BASIS_8 [i][k]
    int32_t intra_qm[64];
    int32_t inter_qm[64];
    int32_t luma_dc[32];      // per qp 0..31
    int32_t chroma_dc[32];
    int32_t alpha[32];
    int32_t beta[32];
    bool ready = false;
};
Tables g_tables;

// sub-pel direction index -> (dx, dy), blocktypes.SP_INDEX_TO_DIR
const int kSpDir[8][2] = {{-1, -1}, {0, -1}, {1, -1}, {-1, 0},
                          {1, 0},   {-1, 1}, {0, 1},  {1, 1}};

struct Ctx {
    unsigned aw, ah, wb, hb, n_blocks;
    // ring of 4 recon frames + residual input planes, planar int16
    int16_t *ring_y[RING], *ring_u[RING], *ring_v[RING];

    unsigned cw() const { return aw >> 1; }
    unsigned ch() const { return ah >> 1; }
};

// ------------------------------------------------------------- transforms

// inverse 8x8 DCT pass over one axis (transform.cpp:330-349 semantics):
// per-term scaling (k==0: *45/128 trunc, else /2 trunc), sum, then
// rounded_div(sum, 128), int16 store.
void idct8_block(const int16_t *in, unsigned in_stride, int16_t *out,
                 unsigned out_stride) {
    int16_t tmp[64];
    // column pass
    for (int c = 0; c < 8; ++c) {
        for (int i = 0; i < 8; ++i) {
            int total = 0;
            for (int k = 0; k < 8; ++k) {
                int term = (int)in[k * in_stride + c] * g_tables.dct[k][i];
                total += (k == 0) ? (term * 45) / 128 : term / 2;
            }
            tmp[i * 8 + c] = wrap16(rounded_div(total, 128));
        }
    }
    // row pass
    for (int r = 0; r < 8; ++r) {
        for (int i = 0; i < 8; ++i) {
            int total = 0;
            for (int k = 0; k < 8; ++k) {
                int term = (int)tmp[r * 8 + k] * g_tables.dct[k][i];
                total += (k == 0) ? (term * 45) / 128 : term / 2;
            }
            out[r * out_stride + i] = wrap16(rounded_div(total, 128));
        }
    }
}

// ----------------------------------------------------------- quantization

// inverse quantize one 8x8 block in place (quantize.cpp:182-254 semantics)
void inv_quant_block(const int16_t *in, unsigned stride, int16_t *out,
                     int qp, bool intra, bool luma) {
    const int32_t *qm = intra ? g_tables.intra_qm : g_tables.inter_qm;
    for (int r = 0; r < 8; ++r) {
        for (int c = 0; c < 8; ++c) {
            int v = in[r * stride + c];
            out[r * 8 + c] = wrap16((2 * v * qm[r * 8 + c] * qp) / SCALE);
        }
    }
    if (intra) {
        int dc = intra ? (luma ? g_tables.luma_dc[qp] : g_tables.chroma_dc[qp])
                       : 0;
        out[0] = wrap16((int)in[0] * dc);
    }
}

// --------------------------------------------------------------- predict

inline int16_t lerp_half(int a, int b) {
    int t = a + b;
    t = t < 0 ? t - 1 : t + 1;
    return wrap16(t / 2);
}

inline int16_t lerp_quarter(int a, int b) {
    int t = 3 * a + b;
    t = t < 0 ? t - 2 : t + 2;
    return wrap16(t / 4);
}

struct Desc {
    uint8_t type, target, sp_pred, sp_amount, sp_index, q_index;
    int mx, my;
};

// copies the (possibly sub-pel interpolated) prediction macroblock from
// plane `src` (one of the ring planes) into py/pu/pv 16x16/8x8 buffers
void build_pred(const Ctx &ctx, const int16_t *sy, const int16_t *su,
                const int16_t *sv, const Desc &d, int i, int j,
                int16_t *py, int16_t *pu, int16_t *pv) {
    int bx = i, by = j;
    if (t_motion(d.type)) {
        bx += d.mx;
        by += d.my;
    }
    unsigned aw = ctx.aw, cw = ctx.cw();
    if (t_motion(d.type) && d.sp_pred) {
        int tx = bx + kSpDir[d.sp_index][0], ty = by + kSpDir[d.sp_index][1];
        bool quarter = d.sp_amount;
        for (int r = 0; r < MB; ++r)
            for (int c = 0; c < MB; ++c) {
                int a = sy[(by + r) * aw + bx + c];
                int b = sy[(ty + r) * aw + tx + c];
                py[r * MB + c] = quarter ? lerp_quarter(a, b)
                                         : lerp_half(a, b);
            }
        int cbx = bx >> 1, cby = by >> 1, ctx2 = tx >> 1, cty = ty >> 1;
        for (int r = 0; r < 8; ++r)
            for (int c = 0; c < 8; ++c) {
                int au = su[(cby + r) * cw + cbx + c];
                int bu = su[(cty + r) * cw + ctx2 + c];
                int av = sv[(cby + r) * cw + cbx + c];
                int bv = sv[(cty + r) * cw + ctx2 + c];
                pu[r * 8 + c] = quarter ? lerp_quarter(au, bu)
                                        : lerp_half(au, bu);
                pv[r * 8 + c] = quarter ? lerp_quarter(av, bv)
                                        : lerp_half(av, bv);
            }
        return;
    }
    for (int r = 0; r < MB; ++r)
        memcpy(py + r * MB, sy + (by + r) * aw + bx, MB * sizeof(int16_t));
    int cbx = bx >> 1, cby = by >> 1;
    for (int r = 0; r < 8; ++r) {
        memcpy(pu + r * 8, su + (cby + r) * cw + cbx, 8 * sizeof(int16_t));
        memcpy(pv + r * 8, sv + (cby + r) * cw + cbx, 8 * sizeof(int16_t));
    }
}

// ----------------------------------------------------------- decode block

void decode_block(Ctx &ctx, const Desc &d, int frame_index,
                  const int16_t *in_y, const int16_t *in_u,
                  const int16_t *in_v, int i, int j) {
    unsigned aw = ctx.aw, cw = ctx.cw();
    int slot = frame_index % RING;
    int16_t *dy = ctx.ring_y[slot], *du = ctx.ring_u[slot],
            *dv = ctx.ring_v[slot];
    // prediction source slot: intra -> current frame's slot (offset 0),
    // inter -> target offset (decode.cpp:30,53)
    int offset = t_intra(d.type) ? 0 : d.target;
    int pslot = (frame_index + RING - offset) % RING;
    const int16_t *sy = ctx.ring_y[pslot], *su = ctx.ring_u[pslot],
                  *sv = ctx.ring_v[pslot];

    int16_t py[MB * MB], pu[64], pv[64];

    if (t_copy(d.type)) {
        build_pred(ctx, sy, su, sv, d, i, j, py, pu, pv);
        for (int r = 0; r < MB; ++r)
            memcpy(dy + (j + r) * aw + i, py + r * MB, MB * sizeof(int16_t));
        int ci = i >> 1, cj = j >> 1;
        for (int r = 0; r < 8; ++r) {
            memcpy(du + (cj + r) * cw + ci, pu + r * 8, 8 * sizeof(int16_t));
            memcpy(dv + (cj + r) * cw + ci, pv + r * 8, 8 * sizeof(int16_t));
        }
        return;
    }

    bool intra_qm = t_intra(d.type) && !t_motion(d.type);
    int qp = d.q_index;
    int16_t iq[64], ry[MB * MB], ru[64], rv[64];
    // Y: 4 quadrant 8x8s
    for (int qy = 0; qy < 2; ++qy)
        for (int qx = 0; qx < 2; ++qx) {
            const int16_t *src = in_y + (j + qy * 8) * aw + i + qx * 8;
            inv_quant_block(src, aw, iq, qp, intra_qm, true);
            int16_t out8[64];
            idct8_block(iq, 8, out8, 8);
            for (int r = 0; r < 8; ++r)
                memcpy(ry + (qy * 8 + r) * MB + qx * 8, out8 + r * 8,
                       8 * sizeof(int16_t));
        }
    int ci = i >> 1, cj = j >> 1;
    inv_quant_block(in_u + cj * cw + ci, cw, iq, qp, intra_qm, false);
    idct8_block(iq, 8, ru, 8);
    inv_quant_block(in_v + cj * cw + ci, cw, iq, qp, intra_qm, false);
    idct8_block(iq, 8, rv, 8);

    if (intra_qm) {  // INTRA_DEFAULT: residual is the signal
        for (int r = 0; r < MB; ++r)
            memcpy(dy + (j + r) * aw + i, ry + r * MB, MB * sizeof(int16_t));
        for (int r = 0; r < 8; ++r) {
            memcpy(du + (cj + r) * cw + ci, ru + r * 8, 8 * sizeof(int16_t));
            memcpy(dv + (cj + r) * cw + ci, rv + r * 8, 8 * sizeof(int16_t));
        }
        return;
    }
    build_pred(ctx, sy, su, sv, d, i, j, py, pu, pv);
    for (int r = 0; r < MB; ++r)
        for (int c = 0; c < MB; ++c)
            dy[(j + r) * aw + i + c] =
                wrap16((int)ry[r * MB + c] + py[r * MB + c]);
    for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c) {
            du[(cj + r) * cw + ci + c] =
                wrap16((int)ru[r * 8 + c] + pu[r * 8 + c]);
            dv[(cj + r) * cw + ci + c] =
                wrap16((int)rv[r * 8 + c] + pv[r * 8 + c]);
        }
}

// --------------------------------------------------------------- deblock

struct BtView {
    const uint8_t *type;
    const uint8_t *q;
};

inline void strength_qp(const BtView &bt, unsigned a, unsigned b,
                        int *strength, int *qp) {
    bool ca = t_copy(bt.type[a]), cb = t_copy(bt.type[b]);
    int qa = bt.q[a], qb = bt.q[b];
    *strength = (ca && cb) ? 0 : (ca != cb ? 1 : 2);
    if (!ca && !cb) *qp = (qa + qb) >> 1;
    else if (!ca) *qp = qa;
    else if (!cb) *qp = qb;
    else *qp = 0;
}

// filters one 8-sample edge segment in place; pstep = distance between
// p0 and p1 (±1 for vertical edges, ±stride for horizontal), rstep =
// distance between successive rows along the edge
void filter_segment(int16_t *p0_ptr, long pstep, long rstep, int qp,
                    int strength, bool luma) {
    int alpha = g_tables.alpha[qp], beta = g_tables.beta[qp];
    for (int r = 0; r < 8; ++r) {
        int16_t *pp = p0_ptr + r * rstep;
        int p0 = pp[0], p1 = pp[-pstep], p2 = pp[-2 * pstep],
            p3 = pp[-3 * pstep];
        int q0 = pp[pstep], q1 = pp[2 * pstep], q2 = pp[3 * pstep],
            q3 = pp[4 * pstep];
        int dp = p0 - q0;
        if ((dp < 0 ? -dp : dp) >= alpha) continue;
        int d1 = p1 - p0, d2 = q1 - q0;
        if ((d1 < 0 ? -d1 : d1) >= beta) continue;
        if ((d2 < 0 ? -d2 : d2) >= beta) continue;
        if (strength == 2) {
            int np0 = rounded_div(p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1, 8);
            int np1 = rounded_div(p2 + p1 + p0 + q0, 4);
            int nq0 = rounded_div(p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2, 8);
            int nq1 = rounded_div(p0 + q0 + q1 + q2, 4);
            if (luma) {
                pp[-2 * pstep] = wrap16(
                    rounded_div(2 * p3 + 3 * p2 + p1 + p0 + q0, 8));
                pp[3 * pstep] = wrap16(
                    rounded_div(2 * q3 + 3 * q2 + q1 + q0 + p0, 8));
            }
            pp[0] = wrap16(np0);
            pp[-pstep] = wrap16(np1);
            pp[pstep] = wrap16(nq0);
            pp[2 * pstep] = wrap16(nq1);
        } else {  // strength 1
            int np0 = rounded_div((q0 + p0) * 4 + p1 - q1, 8);
            int nq0 = rounded_div((q0 + p0) * 4 + q1 - p1, 8);
            if (luma) {
                pp[-pstep] = wrap16(rounded_div(p2 * 4 + p0 * 2 + q0 * 2, 8));
                pp[2 * pstep] = wrap16(rounded_div(q2 * 4 + q0 * 2 + p0 * 2, 8));
            }
            pp[0] = wrap16(np0);
            pp[pstep] = wrap16(nq0);
        }
    }
}

void deblock_plane(int16_t *plane, unsigned width, unsigned height,
                   unsigned mb_size, const BtView &bt, unsigned wb,
                   bool luma) {
    auto blk = [&](unsigned x, unsigned y) {
        return (x / mb_size) + (y / mb_size) * wb;
    };
    int strength, qp;
    // band 0 vertical edges
    for (unsigned i = 8; i < width; i += 8) {
        strength_qp(bt, blk(i - 1, 0), blk(i, 0), &strength, &qp);
        if (strength)
            filter_segment(plane + 0 * width + i - 1, 1, width, qp, strength,
                           luma);
    }
    for (unsigned j = 8; j < height; j += 8) {
        strength_qp(bt, blk(0, j - 1), blk(0, j), &strength, &qp);
        if (strength)
            filter_segment(plane + (j - 1) * width + 0, width, 1, qp,
                           strength, luma);
        for (unsigned i = 8; i < width; i += 8) {
            strength_qp(bt, blk(i, j - 1), blk(i, j), &strength, &qp);
            if (strength)
                filter_segment(plane + (j - 1) * width + i, width, 1, qp,
                               strength, luma);
            strength_qp(bt, blk(i - 1, j), blk(i, j), &strength, &qp);
            if (strength)
                filter_segment(plane + j * width + i - 1, 1, width, qp,
                               strength, luma);
        }
    }
}

}  // namespace

extern "C" {

void *evxn_dec_create(unsigned aligned_w, unsigned aligned_h) {
    Ctx *ctx = new Ctx();
    ctx->aw = aligned_w;
    ctx->ah = aligned_h;
    ctx->wb = aligned_w / MB;
    ctx->hb = aligned_h / MB;
    ctx->n_blocks = ctx->wb * ctx->hb;
    size_t ysz = (size_t)aligned_w * aligned_h;
    size_t csz = ysz / 4;
    for (int s = 0; s < RING; ++s) {
        ctx->ring_y[s] = (int16_t *)calloc(ysz, sizeof(int16_t));
        ctx->ring_u[s] = (int16_t *)calloc(csz, sizeof(int16_t));
        ctx->ring_v[s] = (int16_t *)calloc(csz, sizeof(int16_t));
    }
    return ctx;
}

void evxn_dec_destroy(void *h) {
    Ctx *ctx = (Ctx *)h;
    for (int s = 0; s < RING; ++s) {
        free(ctx->ring_y[s]);
        free(ctx->ring_u[s]);
        free(ctx->ring_v[s]);
    }
    delete ctx;
}

void evxn_dec_set_tables(const int32_t *dct, const int32_t *intra_qm,
                         const int32_t *inter_qm, const int32_t *luma_dc,
                         const int32_t *chroma_dc, const int32_t *alpha,
                         const int32_t *beta) {
    for (int i = 0; i < 8; ++i)
        for (int k = 0; k < 8; ++k) g_tables.dct[i][k] = dct[i * 8 + k];
    memcpy(g_tables.intra_qm, intra_qm, 64 * 4);
    memcpy(g_tables.inter_qm, inter_qm, 64 * 4);
    memcpy(g_tables.luma_dc, luma_dc, 32 * 4);
    memcpy(g_tables.chroma_dc, chroma_dc, 32 * 4);
    memcpy(g_tables.alpha, alpha, 32 * 4);
    memcpy(g_tables.beta, beta, 32 * 4);
    g_tables.ready = true;
}

// syncs one ring slot from/to external planar buffers (device handoff)
void evxn_dec_set_ring(void *h, int slot, const int16_t *y, const int16_t *u,
                       const int16_t *v) {
    Ctx *ctx = (Ctx *)h;
    size_t ysz = (size_t)ctx->aw * ctx->ah, csz = ysz / 4;
    memcpy(ctx->ring_y[slot], y, ysz * sizeof(int16_t));
    memcpy(ctx->ring_u[slot], u, csz * sizeof(int16_t));
    memcpy(ctx->ring_v[slot], v, csz * sizeof(int16_t));
}

void evxn_dec_get_ring(void *h, int slot, int16_t *y, int16_t *u,
                       int16_t *v) {
    Ctx *ctx = (Ctx *)h;
    size_t ysz = (size_t)ctx->aw * ctx->ah, csz = ysz / 4;
    memcpy(y, ctx->ring_y[slot], ysz * sizeof(int16_t));
    memcpy(u, ctx->ring_u[slot], csz * sizeof(int16_t));
    memcpy(v, ctx->ring_v[slot], csz * sizeof(int16_t));
}

// decodes one parsed frame: block table + residual planes -> recon ring
// slot (frame_index % 4), in-loop deblock, RGB out (crop to width/height).
// Mirrors cpuref.engine.decode_slice + deblock_recon + recon_to_rgb.
long long evxn_dec_frame(
    void *h, int frame_index,
    const uint8_t *type, const uint8_t *target, const int16_t *mx,
    const int16_t *my, const uint8_t *sp_pred, const uint8_t *sp_amount,
    const uint8_t *sp_index, const uint8_t *q_index,
    const int16_t *in_y, const int16_t *in_u, const int16_t *in_v,
    unsigned width, unsigned height, uint8_t *rgb) {
    Ctx &ctx = *(Ctx *)h;
    if (!g_tables.ready) return -1;

    // Stream-derived fields feed raw pointer arithmetic below, so a
    // corrupt/hostile table is rejected up front, before any ring state
    // is touched (the reference would read out of bounds here;
    // EVX_PARAM_CHECK only guards debug builds). Returns -2 so the
    // caller raises instead of decoding adjacent heap memory into pixels.
    unsigned idx = 0;
    for (unsigned j = 0; j < ctx.ah; j += MB) {
        for (unsigned i = 0; i < ctx.aw; i += MB, ++idx) {
            uint8_t t = type[idx];
            if (!t_copy(t) && q_index[idx] >= 32) return -2;
            if (!t_motion(t)) continue;
            long bx = (long)i + mx[idx], by = (long)j + my[idx];
            long dx = sp_pred[idx] ? kSpDir[sp_index[idx] & 7][0] : 0;
            long dy = sp_pred[idx] ? kSpDir[sp_index[idx] & 7][1] : 0;
            long x_lo = bx + (dx < 0 ? dx : 0), y_lo = by + (dy < 0 ? dy : 0);
            long x_hi = bx + (dx > 0 ? dx : 0) + MB;
            long y_hi = by + (dy > 0 ? dy : 0) + MB;
            if (x_lo < 0 || y_lo < 0 || x_hi > (long)ctx.aw ||
                y_hi > (long)ctx.ah)
                return -2;
        }
    }

    idx = 0;
    for (unsigned j = 0; j < ctx.ah; j += MB) {
        for (unsigned i = 0; i < ctx.aw; i += MB, ++idx) {
            Desc d;
            d.type = type[idx];
            d.target = t_intra(d.type) ? 0 : (uint8_t)(target[idx] & 3);
            d.mx = t_motion(d.type) ? mx[idx] : 0;
            d.my = t_motion(d.type) ? my[idx] : 0;
            d.sp_pred = t_motion(d.type) ? sp_pred[idx] : 0;
            d.sp_amount = sp_amount[idx];
            d.sp_index = (uint8_t)(sp_index[idx] & 7);
            d.q_index = q_index[idx];
            decode_block(ctx, d, frame_index, in_y, in_u, in_v, i, j);
        }
    }

    int slot = frame_index % RING;
    BtView bt{type, q_index};
    deblock_plane(ctx.ring_y[slot], ctx.aw, ctx.ah, MB, bt, ctx.wb, true);
    deblock_plane(ctx.ring_u[slot], ctx.cw(), ctx.ch(), MB / 2, bt, ctx.wb,
                  false);
    deblock_plane(ctx.ring_v[slot], ctx.cw(), ctx.ch(), MB / 2, bt, ctx.wb,
                  false);

    if (rgb) {
        const int16_t *Y = ctx.ring_y[slot], *U = ctx.ring_u[slot],
                      *V = ctx.ring_v[slot];
        unsigned cw = ctx.cw();
        for (unsigned r = 0; r < height; ++r) {
            uint8_t *orow = rgb + (size_t)r * width * 3;
            for (unsigned c = 0; c < width; ++c) {
                int yy = Y[r * ctx.aw + c] - 16;
                int uu = U[(r >> 1) * cw + (c >> 1)] - 128;
                int vv = V[(r >> 1) * cw + (c >> 1)] - 128;
                int rr = (256 * yy + 358 * vv + 128) >> 8;
                int gg = (256 * yy - 88 * uu - 182 * vv + 128) >> 8;
                int bb = (256 * yy + 452 * uu + 128) >> 8;
                orow[3 * c + 0] = (uint8_t)(rr < 0 ? 0 : (rr > 255 ? 255 : rr));
                orow[3 * c + 1] = (uint8_t)(gg < 0 ? 0 : (gg > 255 ? 255 : gg));
                orow[3 * c + 2] = (uint8_t)(bb < 0 ? 0 : (bb > 255 ? 255 : bb));
            }
        }
    }
    return 0;
}

}  // extern "C"
