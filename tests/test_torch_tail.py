"""The fast step's transform tail (K10's and K11's plain versions,
cuda_tail.encode_tail_plain and decode_tail_plain) against cairo_tpu on
the CPU, exact: the sequence of cairo_tpu.tpu.ops calls that
tpu/engine.py:219-281 (encode_step) and :352-378 (_decode_common, with
decode_step_coo's carry :453-465) make, on numpy-seeded planes of 12 MBs
whose MBs are intra-default, intra-motion, inter, motion and copy, at
q 1, 16 and 31 with adaptive QP on and off, with residuals at +-32767 and
-32768 and with transformed MBs whose s * s and sum of squares wrap
int32. Then the fast step as a whole at 176x144 against
cairo_tpu.tpu.engine, and the dispatch: one encode_tail per encode_planes
and one decode_tail per decode_planes. The kernels themselves are held
against the plain versions in test_torch_cuda.py."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cairo_tpu import native as jnative
from cairo_tpu.blocktypes import BlockTable
from cairo_tpu.tpu import engine as jengine, ops as jops, wire as jwire
from cairo_tpu_torch import native as tnative, tables
from cairo_tpu_torch.gpu import cuda_tail, engine as tengine, ops

from util_video import synth_frames

MB = 16
H, W = 48, 64          # 3 x 4 MBs
N = (H // MB) * (W // MB)
SHAPES = ((H, W), (H // 2, W // 2), (H // 2, W // 2))
TOP = tables.MAX_QUANT_LEVELS - 1
# per MB (is_intra, is_motion, is_copy): intra-default, intra-motion,
# inter (delta), motion, copy, motion + copy, each twice
KINDS = [(1, 0, 0), (1, 1, 0), (0, 0, 0), (0, 1, 0), (0, 0, 1), (0, 1, 1)]


# ---------------------------------------------------------------- anchors

def _jblocks(planes):
    return (jops.plane_to_blocks(planes[0], MB),
            jops.plane_to_blocks(planes[1], MB // 2),
            jops.plane_to_blocks(planes[2], MB // 2))


@functools.partial(jax.jit, static_argnames=("adaptive",))
def _jax_encode_tail(src, pred, is_intra, is_motion, is_copy, quality, coef,
                     *, adaptive):
    """tpu/engine.py:219-281 on planes cut as encode_step cuts them."""
    aligned_h, aligned_w = src[0].shape
    n = is_intra.shape[0]
    src, pred = _jblocks(src), _jblocks(pred)
    res = tuple(jops.wrap16(s.astype(jnp.int32) - p)
                for s, p in zip(src, pred))
    ty = jops.quads_to_mb(jops.fdct8(jops.mb_quads(res[0])))
    tu = jops.fdct8(res[1])
    tv = jops.fdct8(res[2])
    variance = jops.block_variance2(ty)
    if adaptive:
        qp = jops.adaptive_qp(quality, ty)
    else:
        qp = jnp.full(n, quality, jnp.int32)
    qp4 = jnp.repeat(qp, 4)
    quads = jops.mb_quads(ty).reshape(-1, 8, 8)
    intra_qm = is_intra & ~is_motion
    qm4 = jnp.repeat(intra_qm, 4)[:, None, None]
    qm1 = intra_qm[:, None, None]
    qy = jnp.where(qm4, jops.quantize_8x8(quads, qp4, True, True),
                   jops.quantize_8x8(quads, qp4, False, True))
    qu = jnp.where(qm1, jops.quantize_8x8(tu, qp, True, False),
                   jops.quantize_8x8(tu, qp, False, False))
    qv = jnp.where(qm1, jops.quantize_8x8(tv, qp, True, False),
                   jops.quantize_8x8(tv, qp, False, False))
    copy3 = is_copy[:, None, None]
    qy_mb = jops.quads_to_mb(qy.reshape(-1, 4, 8, 8))
    new = (jnp.where(copy3, jops.plane_to_blocks(coef[0], MB)
                     .astype(jnp.int32), qy_mb),
           jnp.where(copy3, jops.plane_to_blocks(coef[1], MB // 2)
                     .astype(jnp.int32), qu),
           jnp.where(copy3, jops.plane_to_blocks(coef[2], MB // 2)
                     .astype(jnp.int32), qv))
    out_coef = (
        jops.blocks_to_plane(new[0], aligned_h, aligned_w).astype(jnp.int16),
        jops.blocks_to_plane(new[1], aligned_h // 2, aligned_w // 2)
        .astype(jnp.int16),
        jops.blocks_to_plane(new[2], aligned_h // 2, aligned_w // 2)
        .astype(jnp.int16))
    dq_y = jnp.where(qm4, jops.dequantize_8x8(qy, qp4, True, True),
                     jops.dequantize_8x8(qy, qp4, False, True))
    dq_u = jnp.where(qm1, jops.dequantize_8x8(qu, qp, True, False),
                     jops.dequantize_8x8(qu, qp, False, False))
    dq_v = jnp.where(qm1, jops.dequantize_8x8(qv, qp, True, False),
                     jops.dequantize_8x8(qv, qp, False, False))
    rblocks = (jops.quads_to_mb(jops.idct8(dq_y.reshape(-1, 4, 8, 8))),
               jops.idct8(dq_u), jops.idct8(dq_v))
    rec = tuple(jnp.where(copy3, p, jops.wrap16(r + p))
                for r, p in zip(rblocks, pred))
    rec = (jops.blocks_to_plane(rec[0], aligned_h, aligned_w),
           jops.blocks_to_plane(rec[1], aligned_h // 2, aligned_w // 2),
           jops.blocks_to_plane(rec[2], aligned_h // 2, aligned_w // 2))
    return (out_coef, qp, jops.wrap16(variance).astype(jnp.int16), rec,
            ty)


@functools.partial(jax.jit, static_argnames=("carry",))
def _jax_decode_tail(coef, qp, intra_default, is_copy, pred, stale, *,
                     carry):
    """decode_step_coo's carry (tpu/engine.py:453-465), then
    _decode_common's reconstruction (:352-378)."""
    aligned_h, aligned_w = coef[0].shape
    hb, wb = aligned_h // MB, aligned_w // MB
    if carry:
        ymask = jnp.repeat(jnp.repeat(is_copy.reshape(hb, wb), MB, axis=0),
                           MB, axis=1)
        cmask = ymask[::2, ::2]
        coef = (jnp.where(ymask, stale[0].astype(jnp.int32), coef[0]),
                jnp.where(cmask, stale[1].astype(jnp.int32), coef[1]),
                jnp.where(cmask, stale[2].astype(jnp.int32), coef[2]))
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
    rec = (jops.blocks_to_plane(rec[0], aligned_h, aligned_w),
           jops.blocks_to_plane(rec[1], aligned_h // 2, aligned_w // 2),
           jops.blocks_to_plane(rec[2], aligned_h // 2, aligned_w // 2))
    return rec, tuple(c.astype(jnp.int16) for c in coef), res


# ----------------------------------------------------------------- inputs

def _flags(rng):
    kinds = np.array(KINDS * (N // len(KINDS)))
    rng.shuffle(kinds)
    return tuple(kinds[:, i].astype(bool) for i in range(3))


def _encode_inputs(case, seed):
    """(src, pred, flags, coef) numpy planes for an encode case:
    "mixed": sources 0..271, predictions off them by noise of a
    per-MB amplitude (none to recon overshoot);
    "extreme": residuals src - pred at 32767, -32767 and 32768 (which
    wraps to -32768) and random ones across the int16 range;
    "wrap": residual MBs of full-scale +-32767 patterns, whose
    transformed luma MB's s * s and sum of squares wrap int32."""
    rng = np.random.default_rng(seed)
    src = [rng.integers(0, 272, s) for s in SHAPES]
    if case == "mixed":   # per-MB residual amplitudes: qp adapts
        amp = rng.choice([0, 2, 8, 40, 300], (H // MB, W // MB))
        pred = [s + np.rint(rng.uniform(-1, 1, s.shape) * np.kron(
            amp, np.ones((size, size)))).astype(np.int64)
            for s, size in zip(src, (MB, 8, 8))]
    elif case == "extreme":
        pick = [rng.integers(0, 4, s) for s in SHAPES]
        full = [rng.integers(-32768, 32768, s) for s in SHAPES]
        pred = [np.choose(p, [s - 32767, s + 32767, s - 32768, f])
                for p, s, f in zip(pick, src, full)]
        pred = [np.clip(p, -32768, 32767) for p in pred]
    else:
        sign = [np.where(rng.random(s) < 0.5, -1, 1) for s in SHAPES]
        pred = [s - g * 32767 for s, g in zip(src, sign)]
    coef = [rng.integers(-32768, 32768, s) for s in SHAPES]
    return ([p.astype(np.int32) for p in src],
            [p.astype(np.int32) for p in pred], _flags(rng),
            [c.astype(np.int16) for c in coef])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want, msg):
    np.testing.assert_array_equal(
        got.numpy() if torch.is_tensor(got) else np.asarray(got),
        np.asarray(want), err_msg=msg)


def _wraps(ty):
    """Per MB whether s * s, and whether the sum of squares, of the
    masked transformed luma MB leave int32 (block_variance2's wraps)."""
    v = np.asarray(ty).astype(np.int64).reshape(len(ty), -1)
    mask = v != 0
    mask[:, 0] = False
    s = np.where(mask, v, 0).sum(1)
    ss = np.where(mask, v * v, 0).sum(1)
    return s * s >= 2 ** 31, ss >= 2 ** 31


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "flat"])
@pytest.mark.parametrize("quality", [1, 16, 31])
@pytest.mark.parametrize("case", ["mixed", "extreme", "wrap"])
def test_encode_tail_plain_matches_jax(case, quality, adaptive):
    src, pred, flags, coef = _encode_inputs(case, quality)
    got = cuda_tail.encode_tail_plain(
        tuple(map(_t, src)), tuple(map(_t, pred)), *map(_t, flags),
        torch.tensor(quality, dtype=torch.int32), adaptive,
        tuple(map(_t, coef)))
    want = _jax_encode_tail(
        tuple(map(jnp.asarray, src)), tuple(map(jnp.asarray, pred)),
        *map(jnp.asarray, flags), jnp.int32(quality),
        tuple(map(jnp.asarray, coef)), adaptive=adaptive)
    for i, p in enumerate("yuv"):
        _eq(got[0][i], want[0][i], f"coef_{p}")
        _eq(got[3][i], want[3][i], f"rec_{p}")
        assert got[0][i].dtype == torch.int16
        assert got[3][i].dtype == torch.int32
    _eq(got[1], want[1], "qp")
    _eq(got[2], want[2], "variance")
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.int16
    # each rule decided something: copy MBs kept the stale coefficients
    # and the others did not
    copy = torch.from_numpy(flags[2])
    kept = (ops.plane_to_blocks(got[0][0], MB)
            == ops.plane_to_blocks(_t(coef[0]), MB)).flatten(1).all(1)
    assert kept[copy].all() and not kept[~copy].any()
    if adaptive:
        assert len(set(got[1].tolist())) > 1, "qp never adapted"
    if case == "wrap":
        s2, ss = _wraps(want[4])
        assert s2.any() and ss.any(), (s2, ss)
    if case == "extreme":
        res = [np.int64(s) - p for s, p in zip(src, pred)]
        for r in (32767, -32767, 32768):
            assert any((x == r).any() for x in res), r


@pytest.mark.parametrize("carry", [True, False], ids=["carry", "dense"])
@pytest.mark.parametrize("case", ["coded", "int16_range"])
def test_decode_tail_plain_matches_jax(case, carry):
    rng = np.random.default_rng(7 + carry)
    flags = _flags(rng)
    intra_default = flags[0] & ~flags[1]
    qp = rng.integers(0, 32, N).astype(np.int32)
    qp[:2] = (1, TOP)
    qp[flags[2]] = 0      # a copy MB's q_index is 0 on the wire
    if case == "coded":   # what a quantizer writes: mostly small, sparse
        coef = [np.where(rng.random(s) < 0.3, rng.integers(-40, 41, s), 0)
                for s in SHAPES]
    else:
        coef = [rng.integers(-32768, 32768, s) for s in SHAPES]
        coef[0][0, :4] = (-32768, 32767, -32768, 32767)
    coef = [c.astype(np.int32) for c in coef]
    pred = [rng.integers(-300, 560, s).astype(np.int32) for s in SHAPES]
    stale = [rng.integers(-32768, 32768, s).astype(np.int16)
             for s in SHAPES]
    rec, carried, res = cuda_tail.decode_tail_plain(
        tuple(map(_t, coef)), _t(qp), _t(intra_default), _t(flags[2]),
        tuple(map(_t, pred)), tuple(map(_t, stale)) if carry else None,
        residual=True)
    want = _jax_decode_tail(
        tuple(map(jnp.asarray, coef)), jnp.asarray(qp),
        jnp.asarray(intra_default), jnp.asarray(flags[2]),
        tuple(map(jnp.asarray, pred)), tuple(map(jnp.asarray, stale)),
        carry=carry)
    for i, p in enumerate("yuv"):
        _eq(rec[i], want[0][i], f"rec_{p}")
        _eq(res[i], want[2][i], f"res_{p}")
        assert rec[i].dtype == res[i].dtype == torch.int32
        if carry:
            _eq(carried[i], want[1][i], f"carried_{p}")
            assert carried[i].dtype == torch.int16
    assert (carried is None) == (not carry)
    if not carry:   # without the residual blocks: the same reconstruction
        alone = cuda_tail.decode_tail_plain(
            tuple(map(_t, coef)), _t(qp), _t(intra_default), _t(flags[2]),
            tuple(map(_t, pred)))
        assert alone[1] is None and alone[2] is None
        for a, b in zip(alone[0], rec):
            _eq(a, b, "rec without the residual blocks")


def _sqrt_mod_2_32(a):
    """An r with r * r = a (mod 2^32), a = 1 (mod 8) (Hensel lifting)."""
    r = 1
    for k in range(3, 32):
        if (r * r - a) % 2 ** (k + 1):
            r += 2 ** (k - 1)
    assert (r * r - a) % 2 ** 32 == 0
    return r


def test_variance_at_int32_min_is_outside_k10s_domain():
    """block_variance2's trunc_div_pos reads INT32_MIN only where
    s * s + count // 2 wraps to it, and no sum s of at most 255 int16
    coefficients does (an exhaustive check over |s| <= 255 * 32768), so
    K10 never meets it. The rule still holds there on int32 blocks
    outside that domain, where the port's ops and the JAX package's
    decide alike: 15 coefficients whose int32 sum r has r * r = 2^31 - 7
    (mod 2^32), so that prod + 15 // 2 wraps to INT32_MIN."""
    bound = 255 * 32768     # s and -s square alike
    for lo in range(0, bound + 1, 1 << 21):
        s = np.arange(lo, min(lo + (1 << 21), bound + 1), dtype=np.int64)
        assert ((2 ** 31 - s * s) % 2 ** 32 >= 128).all()
    r = _sqrt_mod_2_32(2 ** 31 - 7)
    blocks = np.zeros((2, 16, 16), np.int32)
    blocks[0, 1, :14] = 1
    blocks[0, 2, 0] = (r - 14 + 2 ** 31) % 2 ** 32 - 2 ** 31
    blocks[1, 3, 5] = 65537          # s * s wraps to 2^17 + 1
    s = np.int64(blocks[0].sum(dtype=np.int32))
    assert (s * s + 7) % 2 ** 32 == 2 ** 31
    got = ops.block_variance2(_t(blocks))
    _eq(got, jops.block_variance2(jnp.asarray(blocks)), "block_variance2")
    _eq(ops.adaptive_qp(16, _t(blocks)),
        jops.adaptive_qp(16, jnp.asarray(blocks)), "adaptive_qp")


# ----------------------------------------------------- the fast step, whole

AW, AH = 176, 144
STEP_KEYS = ("block_type", "prediction_target", "motion_x", "motion_y",
             "sp_pred", "sp_amount", "sp_index", "q_index", "variance",
             "coef_y", "coef_u", "coef_v", "wire", "wire_tail")
STATE_KEYS = ("ring_y", "ring_u", "ring_v", "coef_y", "coef_u", "coef_v")


def _spy(mp, calls):
    """Counts the calls of K10's and K11's wrappers, with whether K11 was
    given stale planes to carry and asked for the residual blocks."""
    for name in ("encode_tail", "decode_tail"):
        fn = getattr(cuda_tail, name)

        def run(*a, _fn=fn, _name=name, **k):
            if _name == "decode_tail":
                stale = k.get("stale", a[5] if len(a) > 5 else None)
                calls.append((_name, stale is not None,
                              k.get("residual", False)))
            else:
                calls.append((_name,))
            return _fn(*a, **k)
        mp.setattr(cuda_tail, name, run)


def _decode_wire(out, index):
    """The decoder upload for an encoded frame: header, the COO in the
    full bucket (COO_K entries), table."""
    n = (AW // MB) * (AH // MB)
    table, count, pos, val = jwire.unpack_encode_wire(
        np.asarray(out["wire"]), n, tail=lambda: np.asarray(out["wire_tail"]))
    assert count <= jwire.COO_K
    pad = jwire.COO_K - len(pos)   # past the planes: dropped
    pos = np.concatenate([pos, np.full(pad, AW * AH * 3 // 2, np.int32)])
    val = np.concatenate([val, np.zeros(pad, np.int16)])
    bt = BlockTable(**{k: np.asarray(out[k]) for k in STEP_KEYS[:9]})
    return np.concatenate([
        np.array([index, 0], np.int32).view(np.uint8),
        pos.view(np.uint8), val.view(np.uint8), jwire.pack_table_np(bt)])


@pytest.fixture(scope="module")
def fast_step():
    """One intra and one inter frame (one reference) at 176x144, q 16,
    through both packages' encode_step and decode_step_coo (the full COO
    bucket); the port's tail wrappers counted. Returns (per frame the
    (jax, port) encode outputs and states and decode wires and states,
    the calls)."""
    frames = synth_frames(AW, AH, 2, seed=5)
    for f in frames:
        f[:, 120:] = 120          # flat columns: copy MBs
    calls, runs = [], []
    jenc, jdec = jengine.init_state(AW, AH), jengine.init_state(AW, AH)
    tenc = tengine.init_state(AW, AH, "cpu")
    tdec = tengine.init_state(AW, AH, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        _spy(mp, calls)
        for i, frame in enumerate(frames):
            wire = tnative.rgb_to_yuv8(frame, AW, AH, i, 16)
            np.testing.assert_array_equal(
                wire, jnative.rgb_to_yuv8(frame, AW, AH, i, 16))
            kw = dict(aligned_w=AW, aligned_h=AH, frame_w=AW, frame_h=AH,
                      is_inter=i > 0, n_refs=2)
            jenc, jout = jengine.encode_step(jnp.asarray(wire), jenc, **kw)
            tenc, tout = tengine.encode_step(torch.from_numpy(wire), tenc,
                                             **kw)
            in_wire = _decode_wire(jout, i)
            kw = dict(aligned_w=AW, aligned_h=AH, coo_k=jwire.COO_K)
            jdec, jyuv = jengine.decode_step_coo(jnp.asarray(in_wire), jdec,
                                                 **kw)
            tdec, tyuv = tengine.decode_step_coo(torch.from_numpy(in_wire),
                                                 tdec, **kw)
            runs.append(dict(
                out=({k: np.asarray(jout[k]) for k in STEP_KEYS},
                     {k: tout[k].numpy().copy() for k in STEP_KEYS}),
                enc=({k: np.asarray(jenc[k]) for k in STATE_KEYS},
                     {k: tenc[k].numpy().copy() for k in STATE_KEYS}),
                yuv=(np.asarray(jyuv), tyuv.numpy().copy()),
                dec=({k: np.asarray(jdec[k]) for k in STATE_KEYS},
                     {k: tdec[k].numpy().copy() for k in STATE_KEYS})))
    return runs, calls


@pytest.mark.parametrize("frame", [0, 1], ids=["intra", "inter"])
def test_fast_step_matches_jax(fast_step, frame):
    run = fast_step[0][frame]
    for part, keys in (("out", STEP_KEYS), ("enc", STATE_KEYS),
                       ("dec", STATE_KEYS)):
        want, got = run[part]
        for k in keys:
            _eq(got[k], want[k], f"frame {frame} {part} {k}")
    _eq(run["yuv"][1], run["yuv"][0], f"frame {frame} decoded wire")
    if frame:   # the inter frame exercised inter, motion and copy MBs
        types = set(run["out"][0]["block_type"].tolist())
        assert {0, 2, 4} <= types, types


def test_fast_step_dispatches_through_the_tail(fast_step):
    """One encode_tail a frame, one decode_tail a decoded frame, the COO
    decode carrying the stale coefficients in it."""
    assert fast_step[1] == [("encode_tail",), ("decode_tail", True, False)] * 2


def test_decode_planes_dispatch(monkeypatch):
    """decode_step (dense planes) and a tile's decode_planes call K11 once
    a frame and carry nothing; decode_step_coo carries."""
    calls = []
    _spy(monkeypatch, calls)
    aw, ah = 32, 32
    state = tengine.init_state(aw, ah, "cpu")
    enc = tengine.init_state(aw, ah, "cpu")
    frame = synth_frames(aw, ah, 1, seed=2)[0]
    wire = tnative.rgb_to_yuv8(frame, aw, ah, 0, 16)
    enc, out = tengine.encode_step(torch.from_numpy(wire), enc, aligned_w=aw,
                                   aligned_h=ah, frame_w=aw, frame_h=ah,
                                   is_inter=False)
    table = {k: out[k] for k in STEP_KEYS[:8]}
    coef = {k: out[k] for k in ("coef_y", "coef_u", "coef_v")}
    tengine.decode_step(table, coef, state, 0, width=aw, height=ah,
                        aligned_w=aw, aligned_h=ah)
    for key in STATE_KEYS:
        _eq(state[key], enc[key], key)
    tengine.decode_planes(table, *(c.to(torch.int32) for c in coef.values()),
                          state, torch.tensor(1, dtype=torch.int32))
    assert calls == [("encode_tail",), ("decode_tail", False, False),
                     ("decode_tail", False, False)]


def test_wavefront_decode_dispatch(monkeypatch):
    """The wave decode's frames call K11 once each, carrying the stale
    coefficients and keeping the residual blocks for K7."""
    from cairo_tpu_torch import ConformanceGpuEncoder, GpuDecoder

    calls = []
    _spy(monkeypatch, calls)
    enc, dec = ConformanceGpuEncoder(device="cpu"), GpuDecoder(device="cpu")
    frames = synth_frames(48, 32, 2, seed=4)
    rgb = [dec.decode(enc.encode(f)) for f in frames]
    assert dec.host_frames == 0
    wave = [c for c in calls if c == ("decode_tail", True, True)]
    assert len(wave) == dec.frame_index - (len(calls) - len(wave))
    assert len(calls) == len(frames) and len(rgb) == len(frames)


def test_wrappers_raise_off_the_cpu_before_a_launch():
    """A tensor on neither the CPU nor a CUDA card (here "meta") goes to
    the kernel path, which checks its arguments and raises before any
    launch."""
    src, pred, flags, coef = _encode_inputs("mixed", 3)

    def meta(a, dtype):
        return torch.empty(a.shape, dtype=dtype, device="meta")

    before = dict(cuda_tail.LAUNCHES)
    with pytest.raises(ValueError):
        cuda_tail.encode_tail(
            tuple(meta(p, torch.int32) for p in src),
            tuple(meta(p, torch.int32) for p in pred),
            *(meta(f, torch.bool) for f in flags), 16, True,
            tuple(meta(c, torch.int16) for c in coef))
    with pytest.raises(ValueError):
        cuda_tail.decode_tail(
            tuple(meta(p, torch.int32) for p in src),
            meta(flags[0], torch.int32), meta(flags[0], torch.bool),
            meta(flags[2], torch.bool),
            tuple(meta(p, torch.int32) for p in pred))
    assert cuda_tail.LAUNCHES == before
