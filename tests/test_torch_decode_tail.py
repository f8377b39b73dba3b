"""K11 decode_tail as csrc/tail.cu's decode_tail_kernel computes it, on
the CPU: a numpy model of its threads (48 an MB in blocks of k11::MBS
MBs, a column and then a row of an 8x8 block a thread: the column loads,
the carry, dequantization by the reciprocal table's d words and the
constant k11::SF, the paired idct8 passes with the padded transpose
through shared memory between them, the prediction add, and a copy MB
whose residual is not asked for taking its prediction row for row, in
C's int32 arithmetic) against
cuda_tail.decode_tail_plain and the cairo_tpu.tpu.ops sequence of
tpu/engine.py:352-378 (with decode_step_coo's carry :453-465), exact, on
int16-range coefficients (the corners included) at qp 0, 1, 31 and 255
for intra-default, inter and copy MBs, with and without the carry and the
residual blocks. Then the domain that lets the kernel divide with C's /
(its producers give int16 coefficients and uint8 qp; no product reaches
2^31), the thread layout (every output sample written once, each 8x8
block in 8 lanes of one warp), the C entry's signature and scale factor,
and the dispatch (a CPU tensor takes the plain version, a tensor on
another device raises before a launch). The kernel itself is held
against the plain version in test_torch_cuda.py."""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cairo_tpu.tpu import ops as jops
from cairo_tpu_torch import tables
from cairo_tpu_torch.gpu import _build, cuda_tail, engine, ops, wire

CSRC = pathlib.Path(cuda_tail.__file__).parent / "csrc"
TEXT = (CSRC / "tail.cu").read_text()
K11_TEXT = TEXT[TEXT.index("namespace k11 {"):]
SF = int(re.search(r"constexpr int SF = (\d+);", K11_TEXT)[1])
MBS = int(re.search(r"constexpr int MBS = (\d+);", K11_TEXT)[1])
LD = int(re.search(r"constexpr int LD = (\d+);", TEXT)[1])
TB = 8 * LD
R = {k: int(v) for k, v in re.findall(r"constexpr int R_(\w+) = (\d+);",
                                      TEXT)}
BASIS = np.asarray(tables.DCT_BASIS_8, np.int64)
WORDS = cuda_tail.reciprocals().astype(np.int64)

MB = 16
H, W = 48, 48          # 3 x 3 MBs: an odd count, so a chroma warp's half
N = (H // MB) * (W // MB)  # and a luma warp of the last block are idle
SHAPES = ((H, W), (H // 2, W // 2), (H // 2, W // 2))
# per MB (intra_default, is_copy): intra-default, inter, copy
KINDS = [(1, 0), (0, 0), (0, 1)]


# ------------------------------------------------------- C int32 arithmetic

def _i32(v):
    return ((int(v) + 2 ** 31) % 2 ** 32) - 2 ** 31


def _cdiv(n, d):
    """C's / on ints: truncation toward zero."""
    q = abs(n) // d
    return -q if n < 0 else q


def _wrap16(v):
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _rdiv128(v):
    return _cdiv(v - 64 if v < 0 else v + 64, 128)


def _idct8(v):
    """csrc/tail.cu's idct8 on one thread's 8 values: outputs k and 7 - k
    from the even and odd terms of output k."""
    out = [0] * 8
    for k in range(4):
        e, o = _cdiv(v[0] * int(BASIS[0, k]) * 45, 128), 0
        for j in range(1, 8):
            t = _cdiv(v[j] * int(BASIS[j, k]), 2)
            if j & 1:
                o += t
            else:
                e += t
        out[k] = _wrap16(_rdiv128(e + o))
        out[7 - k] = _wrap16(_rdiv128(e - o))
    return out


def _transpose(vals, buf, group):
    """transpose() for the 8 lanes of one 8x8 block: each lane's 8 values
    stored at r * LD + k of the block's area, then word j * LD + r loaded
    (the lanes in step, as __syncwarp on their mask orders them)."""
    base = group * TB
    for r, v in vals.items():
        for k in range(8):
            buf[base + r * LD + k] = v[k]
    return {r: [buf[base + j * LD + r] for j in range(8)] for r in vals}


# ------------------------------------------------------ the kernel's model

def _thread(block, t, n, w):
    """decode_tail_kernel's thread t of block `block`: (mb, blk, r, warp,
    lane, luma, corner, pitch), or None where the thread leaves."""
    warp, lane, r = t >> 5, t & 31, t & 7
    luma = warp < MBS
    mb = block * MBS + (warp if luma else 2 * (warp - MBS) + (lane >> 4))
    if mb >= n:
        return None
    blk = lane >> 3 if luma else 4 + ((lane >> 3) & 1)
    wb = w // MB
    bx, by = mb % wb, mb // wb
    pitch = w if luma else w // 2
    corner = ((by * MB + 8 * (blk >> 1)) * w + bx * MB + 8 * (blk & 1)
              if luma else by * 8 * pitch + bx * 8)
    return mb, blk, r, warp, lane, luma, corner, pitch


def kernel_model(coef, qp, intra_default, is_copy, pred, stale=None,
                 residual=False):
    """decode_tail_kernel on numpy planes, thread by thread. Returns (rec,
    carried, res) as decode_tail does, and the number of times each output
    word was written."""
    h, w = coef[0].shape
    n = (h // MB) * (w // MB)
    rec = [np.zeros(p.size, np.int64) for p in coef]
    carried = None if stale is None else [np.zeros(p.size, np.int64)
                                          for p in coef]
    res = None if not residual else [np.zeros(n * 256, np.int64),
                                      np.zeros(n * 64, np.int64),
                                      np.zeros(n * 64, np.int64)]
    writes = {}

    def store(name, plane, out, at, vals):
        for k, x in enumerate(vals):
            out[plane][at + k] = x
            writes[name, plane, at + k] = writes.get((name, plane, at + k),
                                                     0) + 1

    for block in range(-(-n // MBS)):
        buf = np.zeros((48 * MBS // 32) * 4 * TB, np.int64)
        groups = {}
        for t in range(48 * MBS):
            th = _thread(block, t, n, w)
            if th is not None:
                groups.setdefault((th[3], th[4] >> 3), {})[th[2]] = th
        for (warp, group), lanes in groups.items():
            assert sorted(lanes) == list(range(8))
            mbs = {th[0] for th in lanes.values()}
            blks = {th[1] for th in lanes.values()}
            assert len(mbs) == len(blks) == 1   # one 8x8 block of one MB
            mb, blk = mbs.pop(), blks.pop()
            plane = 0 if blk < 4 else blk - 3
            copy = bool(is_copy[mb])
            p = {}
            for r, th in lanes.items():
                at = th[6] + r * th[7]
                p[r] = [int(x) for x in pred[plane].reshape(-1)[at:at + 8]]
            if copy and not residual:
                # the carry and the prediction, row for row
                for r, th in lanes.items():
                    at = th[6] + r * th[7]
                    if carried is not None:
                        store("carried", plane, carried, at,
                              stale[plane].reshape(-1)[at:at + 8])
                    store("rec", plane, rec, at, p[r])
                continue
            # column r of the block: for each row j the 8 lanes read 8
            # consecutive words
            src = (stale[plane] if copy and stale is not None
                   else coef[plane]).reshape(-1)
            v = {}
            for r, th in lanes.items():
                col, pitch = th[6] + r, th[7]
                v[r] = [int(src[col + j * pitch]) for j in range(8)]
                if carried is not None:
                    for j in range(8):
                        store("carried", plane, carried, col + j * pitch,
                              [_wrap16(v[r][j])])
            q, intra = int(qp[mb]), bool(intra_default[mb])
            for r in v:
                qm_at = R["QM"] + (0 if intra else 256) + 2 + 4 * r
                dc = int(WORDS[R["DCL" if blk < 4 else "DCC"]
                               + 4 * (q & 255) + 2])
                d = []
                for j in range(8):
                    if intra and j == 0 and r == 0:
                        prod = v[r][j] * dc
                    else:
                        prod = 2 * v[r][j] * int(WORDS[qm_at + 32 * j]) * q
                    assert _i32(prod) == prod   # no product wraps
                    d.append(_wrap16(prod if intra and j == 0 and r == 0
                                     else _cdiv(prod, SF)))
                v[r] = _idct8(d)                # the column pass
            v = _transpose(v, buf, 4 * warp + group)
            for r in v:
                v[r] = _idct8(v[r])             # the row pass
                if residual:
                    at = (mb * 256 + (8 * (blk >> 1) + r) * 16
                          + 8 * (blk & 1) if blk < 4 else mb * 64 + r * 8)
                    store("res", plane, res, at, v[r])
                if not copy:
                    p[r] = [_wrap16(_i32(a + b)) for a, b in zip(v[r], p[r])]
            for r, th in lanes.items():
                store("rec", plane, rec, th[6] + r * th[7], p[r])
    shapes = [p.shape for p in coef]
    rec = [a.reshape(s) for a, s in zip(rec, shapes)]
    if carried is not None:
        carried = [a.reshape(s) for a, s in zip(carried, shapes)]
    if res is not None:
        res = [res[0].reshape(n, 16, 16), res[1].reshape(n, 8, 8),
               res[2].reshape(n, 8, 8)]
    return (rec, carried, res), writes


# ---------------------------------------------------------------- anchors

def _jblocks(planes):
    return (jops.plane_to_blocks(planes[0], MB),
            jops.plane_to_blocks(planes[1], MB // 2),
            jops.plane_to_blocks(planes[2], MB // 2))


@functools.partial(jax.jit, static_argnames=("carry",))
def _jax_decode_tail(coef, qp, intra_default, is_copy, pred, stale, *,
                     carry):
    """decode_step_coo's carry (tpu/engine.py:453-465), then
    _decode_common's dequantization, inverse DCT and prediction add
    (:352-378)."""
    h, w = coef[0].shape
    if carry:
        ymask = jnp.repeat(jnp.repeat(is_copy.reshape(h // MB, w // MB), MB,
                                      axis=0), MB, axis=1)
        masks = (ymask, ymask[::2, ::2], ymask[::2, ::2])
        coef = tuple(jnp.where(m, s.astype(jnp.int32), c)
                     for m, s, c in zip(masks, stale, coef))
    cy, cu, cv = _jblocks(coef)
    qp4 = jnp.repeat(qp, 4)
    qm4 = jnp.repeat(intra_default, 4)[:, None, None]
    qm1 = intra_default[:, None, None]
    quads = jops.mb_quads(cy).reshape(-1, 8, 8)
    dq_y = jnp.where(qm4, jops.dequantize_8x8(quads, qp4, True, True),
                     jops.dequantize_8x8(quads, qp4, False, True))
    dq_u = jnp.where(qm1, jops.dequantize_8x8(cu, qp, True, False),
                     jops.dequantize_8x8(cu, qp, False, False))
    dq_v = jnp.where(qm1, jops.dequantize_8x8(cv, qp, True, False),
                     jops.dequantize_8x8(cv, qp, False, False))
    res = (jops.quads_to_mb(jops.idct8(dq_y.reshape(-1, 4, 8, 8))),
           jops.idct8(dq_u), jops.idct8(dq_v))
    copy3 = is_copy[:, None, None]
    rec = tuple(jnp.where(copy3, p, jops.wrap16(r + p))
                for r, p in zip(res, _jblocks(pred)))
    rec = (jops.blocks_to_plane(rec[0], h, w),
           jops.blocks_to_plane(rec[1], h // 2, w // 2),
           jops.blocks_to_plane(rec[2], h // 2, w // 2))
    return rec, coef, res


def _inputs(qp_value, seed):
    """int16-range coefficient and stale planes (the corners -32768 and
    32767 in every MB's luma and chroma), prediction planes and the MB
    kinds of KINDS in turn, every MB at qp_value."""
    rng = np.random.default_rng(seed)
    coef = [rng.integers(-32768, 32768, s) for s in SHAPES]
    stale = [rng.integers(-32768, 32768, s) for s in SHAPES]
    for planes in (coef, stale):
        for p, size in zip(planes, (MB, MB // 2, MB // 2)):
            p[::size, ::size] = -32768          # every 8x8 DC of chroma
            p[1::size, 1::size] = 32767
            p[size - 1::size, size - 1::size] = -32768
    coef = [c.astype(np.int32) for c in coef]
    stale = [s.astype(np.int16) for s in stale]
    pred = [rng.integers(-300, 560, s).astype(np.int32) for s in SHAPES]
    kinds = np.array([KINDS[i % len(KINDS)] for i in range(N)], np.uint8)
    qp = np.full(N, qp_value, np.int32)
    return coef, qp, kinds[:, 0].copy(), kinds[:, 1].copy(), pred, stale


@pytest.fixture(scope="module")
def cases():
    """Every (qp, carry, residual) case: the model, the plain version and
    JAX on the same inputs."""
    out = {}
    for qp_value in (0, 1, 31, 255):
        coef, qp, intra_default, is_copy, pred, stale = _inputs(
            qp_value, 100 + qp_value)
        for carry in (True, False):
            want = _jax_decode_tail(
                tuple(map(jnp.asarray, coef)), jnp.asarray(qp),
                jnp.asarray(intra_default.astype(bool)),
                jnp.asarray(is_copy.astype(bool)),
                tuple(map(jnp.asarray, pred)),
                tuple(map(jnp.asarray, stale)), carry=carry)
            for residual in (True, False):
                st = stale if carry else None
                model = kernel_model(coef, qp, intra_default, is_copy, pred,
                                     st, residual)
                plain = cuda_tail.decode_tail_plain(
                    tuple(map(torch.from_numpy, coef)),
                    torch.from_numpy(qp), torch.from_numpy(intra_default),
                    torch.from_numpy(is_copy),
                    tuple(map(torch.from_numpy, pred)),
                    None if st is None else tuple(map(torch.from_numpy, st)),
                    residual=residual)
                out[qp_value, carry, residual] = (model, plain, want)
    return out


def _eq(got, want, what):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  np.asarray(want).astype(np.int64),
                                  err_msg=what)


@pytest.mark.parametrize("residual", [True, False],
                         ids=["residual", "no_residual"])
@pytest.mark.parametrize("carry", [True, False], ids=["carry", "no_carry"])
@pytest.mark.parametrize("qp", [0, 1, 31, 255])
def test_kernel_model_matches_plain_and_jax(cases, qp, carry, residual):
    """The model's outputs equal decode_tail_plain's and JAX's (tolerance
    0); each output word is written once (rec always, carried with the
    carry, the residual blocks where asked)."""
    ((rec, carried, res), writes), plain, want = cases[qp, carry, residual]
    for i, p in enumerate("yuv"):
        _eq(rec[i], plain[0][i], f"rec_{p} against the plain version")
        _eq(rec[i], want[0][i], f"rec_{p} against JAX")
        if carry:
            _eq(carried[i], plain[1][i], f"carried_{p} (plain)")
            _eq(carried[i], want[1][i], f"carried_{p} (JAX)")
        if residual:
            _eq(res[i], plain[2][i], f"res_{p} (plain)")
            _eq(res[i], want[2][i], f"res_{p} (JAX)")
    assert (carried is None) == (plain[1] is None) == (not carry)
    assert (res is None) == (plain[2] is None) == (not residual)
    counts = {}
    for (name, plane, _), c in writes.items():
        assert c == 1, (name, plane)
        counts[name, plane] = counts.get((name, plane), 0) + 1
    sizes = [H * W, H * W // 4, H * W // 4]
    want_counts = {("rec", i): s for i, s in enumerate(sizes)}
    if carry:
        want_counts.update({("carried", i): s for i, s in enumerate(sizes)})
    if residual:
        want_counts.update({("res", i): s for i, s in enumerate(sizes)})
    assert counts == want_counts


def test_copy_mbs_take_the_prediction_and_skip_the_passes(cases):
    """A copy MB's reconstruction is its prediction whatever its
    coefficients, so the kernel skips dequantization and both passes when
    no residual is asked: the outputs with and without the residual blocks
    agree on every MB."""
    for qp in (0, 1, 31, 255):
        for carry in (True, False):
            with_res = cases[qp, carry, True][0][0]
            without = cases[qp, carry, False][0][0]
            for a, b in zip(with_res[0], without[0]):
                _eq(a, b, "rec with and without the residual blocks")


def test_dequantization_and_idct_against_jax_ops():
    """The model's per-thread dequantization (the table's d words, C's /
    by SF) and its two paired passes with the transposes between them
    equal jops.dequantize_8x8 then jops.idct8 on whole 8x8 blocks, for
    intra and inter, luma and chroma, at qp 0, 1, 31 and 255 over blocks
    at the int16 corners."""
    rng = np.random.default_rng(11)
    blocks = np.where(rng.random((24, 8, 8)) < 0.5,
                      rng.integers(-32768, 32768, (24, 8, 8)),
                      rng.choice([-32768, 32767, 0, 1, -1], (24, 8, 8)))
    blocks[0], blocks[1] = -32768, 32767
    blocks[2] = np.where(np.add.outer(np.arange(8), np.arange(8)) % 2,
                         32767, -32768)
    for qp in (0, 1, 31, 255):
        for intra in (True, False):
            for luma in (True, False):
                qps = np.full(len(blocks), qp, np.int32)
                want = np.asarray(jops.idct8(jops.dequantize_8x8(
                    jnp.asarray(blocks, jnp.int32), jnp.asarray(qps), intra,
                    luma)))
                dc = int(WORDS[R["DCL" if luma else "DCC"] + 4 * qp + 2])
                for b, blk in enumerate(blocks):
                    cols = {r: [int(blk[j, r]) for j in range(8)]
                            for r in range(8)}   # column r, as loaded
                    for r in cols:
                        qm_at = R["QM"] + (0 if intra else 256) + 2 + 4 * r
                        cols[r] = _idct8([
                            _wrap16(cols[r][j] * dc if intra and j == r == 0
                                    else _cdiv(2 * cols[r][j] * int(
                                        WORDS[qm_at + 32 * j]) * qp, SF))
                            for j in range(8)])
                    rows = {r: _idct8([cols[j][r] for j in range(8)])
                            for r in range(8)}
                    got = np.array([rows[r] for r in range(8)])
                    np.testing.assert_array_equal(
                        got, want[b], err_msg=f"qp {qp} intra {intra} "
                        f"luma {luma} block {b}")


# ---------------------------------------------------------------- domain

def test_dequantization_domain_bound():
    """K11's domain (csrc/tail.cu's header): int16 coefficients, qp
    0..255. There no dequantization product reaches 2^31 (the tables'
    largest matrix entry and DC scale), so mul_w never wraps and ops'
    INT32_MIN case of trunc_div_pos cannot arise."""
    qm = int(max(np.max(tables.INTRA_QM_8x8), np.max(tables.INTER_QM_8x8)))
    dc = int(max(np.max(tables.luma_dc_scale(np.arange(256))),
                 np.max(tables.chroma_dc_scale(np.arange(256)))))
    assert (qm, dc) == (45, 494)
    assert 2 * 2 ** 15 * qm * 255 < 2 ** 31
    assert 2 ** 15 * dc < 2 ** 31
    # the d words the kernel reads are the tables' entries
    for k, m in enumerate((tables.INTRA_QM_8x8, tables.INTER_QM_8x8)):
        d = WORDS[R["QM"] + 256 * k + 2:R["QM"] + 256 * (k + 1):4]
        np.testing.assert_array_equal(d, np.asarray(m).reshape(-1))
    for key, fn in (("DCL", tables.luma_dc_scale),
                    ("DCC", tables.chroma_dc_scale)):
        d = WORDS[R[key] + 2:R[key] + 4 * 256:4]
        np.testing.assert_array_equal(d, fn(np.arange(256)))


def test_c_division_equals_trunc_div_pos_at_the_edges():
    """C's / by SF equals ops.trunc_div_pos over the products of the
    domain's corners (every int16 edge value, matrix entry and qp at
    the bounds) and at +-(2^31 - 1), where the bound is tight; products
    computed in int32 torch equal the int64 ones (no wrap)."""
    v = np.array([-32768, -32767, -1, 0, 1, 32766, 32767], np.int64)
    qm = np.unique(np.concatenate([np.asarray(tables.INTRA_QM_8x8).ravel(),
                                   np.asarray(tables.INTER_QM_8x8).ravel()]))
    qp = np.array([0, 1, 31, 254, 255], np.int64)
    n = (2 * v[:, None, None] * qm[None, :, None] * qp[None, None, :]).ravel()
    n32 = (2 * torch.from_numpy(v.astype(np.int32))[:, None, None]
           * torch.from_numpy(qm.astype(np.int32))[None, :, None]
           * torch.from_numpy(qp.astype(np.int32))[None, None, :]).reshape(-1)
    np.testing.assert_array_equal(n32.numpy(), n)
    n = np.concatenate([n, [2 ** 31 - 1, -(2 ** 31 - 1), 2 * 32768 * 45 * 255,
                            -2 * 32768 * 45 * 255, 15, -15, 16, -16, 17,
                            -17]])
    want = ops.trunc_div_pos(torch.from_numpy(n.astype(np.int32)),
                             tables.QUANTIZER_SCALE_FACTOR).numpy()
    np.testing.assert_array_equal([_cdiv(int(x), SF) for x in n], want)
    # and where the domain ends: INT32_MIN, which no product reaches
    assert n.min() > -2 ** 31


def test_producers_give_int16_coefficients_and_uint8_qp():
    """The planes K11 reads come from engine.coo_planes (int16 COO values,
    each position once, positions past the planes dropped) or from int16
    planes widened; qp from the block table's uint8 q_index."""
    rng = np.random.default_rng(5)
    ys, cs = H * W, H * W // 4
    k = 300
    pos = rng.permutation(ys + 2 * cs)[:k - 20].astype(np.int32)
    pos = np.concatenate([pos, np.full(20, ys + 2 * cs + 7, np.int32)])
    val = rng.choice([-32768, 32767, -1, 1, 5], k).astype(np.int16)
    body = torch.from_numpy(np.concatenate([pos.view(np.uint8),
                                            val.view(np.uint8)]))
    planes = engine.coo_planes(body, k, W, H)
    flat = torch.cat([p.reshape(-1) for p in planes]).numpy()
    want = np.zeros(ys + 2 * cs, np.int64)
    want[pos[:k - 20]] = val[:k - 20]
    np.testing.assert_array_equal(flat, want)
    assert flat.min() >= -32768 and flat.max() <= 32767
    assert [p.dtype for p in planes] == [torch.int32] * 3
    table = wire.unpack_table_wire(torch.zeros(10 * N, dtype=torch.uint8), N)
    assert table["q_index"].dtype == torch.uint8


# ---------------------------------------------------------------- layout

@pytest.mark.parametrize("grid", [(1, 1), (1, 3), (3, 3), (68, 120)],
                         ids=["1x1", "1x3", "3x3", "1080p"])
def test_thread_layout(grid):
    """Each 8x8 block of each MB is the 8 lanes r = 0..7 of one warp (so
    their __syncwarp on the block's mask suffices), the four blocks of a
    warp use disjoint transpose areas whose stores and loads fall on 32
    banks, every row of every plane is one thread's, whole 8-lane groups
    leave past the last MB, and the 16-byte accesses stay aligned, as the
    column loads' sectors do."""
    hb, wb = grid
    w = wb * MB
    n = hb * wb
    rows = {}
    for block in range(-(-n // MBS)):
        groups = {}
        for t in range(48 * MBS):
            th = _thread(block, t, n, w)
            if th is None:
                continue
            mb, blk, r, warp, lane, luma, corner, pitch = th
            groups.setdefault((warp, lane >> 3), set()).add((mb, blk))
            plane = 0 if blk < 4 else blk - 3
            at = corner + r * pitch
            # 32-byte rows, and each column load's 8 lanes one 32-byte
            # sector (words corner + j pitch + 0..7)
            assert corner % 8 == 0 and pitch % 8 == 0
            assert (plane, at) not in rows
            rows[plane, at] = th
        for (warp, group), owners in groups.items():
            assert len(owners) == 1
        for warp in {g[0] for g in groups}:
            present = [g for (wp, g) in groups if wp == warp]
            for k in range(8):
                stores = [g * TB + r * LD + k for g in present
                          for r in range(8)]
                loads = [g * TB + k * LD + r for g in present
                         for r in range(8)]
                assert len({a % 32 for a in stores}) == len(stores)
                assert len({a % 32 for a in loads}) == len(loads)
    assert len([k for k in rows if k[0] == 0]) == n * 32   # 8 samples each
    assert len([k for k in rows if k[0] == 1]) == n * 8
    assert len([k for k in rows if k[0] == 2]) == n * 8


# -------------------------------------------------- entry, scale, dispatch

def test_c_entry_signature_and_scale_factor():
    """cuda_tail.DECODE_SIGNATURE has one letter per parameter of
    cairo_decode_tail, the stream included; k11::SF is
    tables.QUANTIZER_SCALE_FACTOR, which the wrapper checks once against
    the library's cairo_decode_tail_sf and raises on otherwise."""
    params = re.search(r'extern "C" int cairo_decode_tail\(([^)]*)\)',
                       TEXT)[1]
    sig = "".join("p" if "*" in q or "cudaStream_t" in q else "i"
                  for q in params.split(","))
    assert sig == cuda_tail.DECODE_SIGNATURE
    assert SF == tables.QUANTIZER_SCALE_FACTOR
    assert re.search(r'extern "C" int cairo_decode_tail_sf\(\) \{ return '
                     r'k11::SF; \}', TEXT)
    assert MBS % 2 == 0 and "__syncthreads" not in K11_TEXT


def test_scale_factor_check_raises_on_a_mismatch(monkeypatch):
    monkeypatch.setattr(_build, "kernel_fn", lambda name, sig: lambda: SF)
    assert cuda_tail._scale_factor.__wrapped__() == SF
    monkeypatch.setattr(_build, "kernel_fn",
                        lambda name, sig: lambda: SF + 1)
    with pytest.raises(RuntimeError, match="divides by"):
        cuda_tail._scale_factor.__wrapped__()


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    coef, qp, intra_default, is_copy, pred, stale = _inputs(31, 3)
    args = (tuple(map(torch.from_numpy, coef)), torch.from_numpy(qp),
            torch.from_numpy(intra_default), torch.from_numpy(is_copy),
            tuple(map(torch.from_numpy, pred)))
    calls = []
    plain = cuda_tail.decode_tail_plain

    def spy(*a, **k):
        calls.append(k)
        return plain(*a, **k)

    def no_kernel(*a, **k):
        raise AssertionError("the CPU path reached the kernel library")

    monkeypatch.setattr(cuda_tail, "decode_tail_plain", spy)
    monkeypatch.setattr(_build, "kernel_fn", no_kernel)
    before = dict(cuda_tail.LAUNCHES)
    out = cuda_tail.decode_tail(*args, stale=tuple(map(torch.from_numpy,
                                                       stale)),
                                residual=True)
    assert len(calls) == 1 and cuda_tail.LAUNCHES == before
    want = plain(*args, tuple(map(torch.from_numpy, stale)), True)
    for a, b in zip(out, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_other_devices_raise_before_a_launch():
    """A tensor on neither the CPU nor a CUDA card (here "meta") takes the
    kernel path and raises the message the argument check always gave."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    before = dict(cuda_tail.LAUNCHES)
    args = (tuple(meta(s, torch.int32) for s in SHAPES),
            meta((N,), torch.int32), meta((N,), torch.bool),
            meta((N,), torch.bool), tuple(meta(s, torch.int32)
                                          for s in SHAPES))
    with pytest.raises(ValueError, match="coef_y: expected a CUDA tensor"):
        cuda_tail.decode_tail(*args)
    with pytest.raises(ValueError, match="coef_y: expected a CUDA tensor"):
        cuda_tail.decode_tail(*args, stale=tuple(
            meta(s, torch.int16) for s in SHAPES), residual=True)
    assert cuda_tail.LAUNCHES == before
