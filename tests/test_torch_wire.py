"""cairo_tpu_torch.gpu.wire against cairo_tpu.tpu.wire on the CPU: the
wires must be byte-identical (the native converters read both), in the
cases of test_delta_wire.py and test_wire_overflow.py: exception overflow
both ways, COO past COO_K, the small-frame yuv8 fallback. The source
wire's unpack in both of its layouts (planes, and the conformance step's
blocks with self_sad), with exception positions that are negative,
dropped or listed twice; and K12's algorithm (csrc/wire.cu: per MB-row
band, its start values from the column-0 fields above it, the band's
exceptions filed by row, the latest entry of a position winning) as a
numpy model against JAX's scatter."""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cairo_tpu import native as jnative
from cairo_tpu.blocktypes import BlockTable
from cairo_tpu.tpu import wire as jwire
from cairo_tpu_torch import native as tnative
from cairo_tpu_torch.gpu import wire as twire

from util_video import synth_frames
from util_wire import (CASES, content_frame, last_entries_only, rewritten,
                       yuv5d_wire)

AW, AH = 640, 512   # large enough that the 5-bit-delta wires engage
W, H = 630, 500


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_constants_match():
    for k in ("Y_SHIFT", "EXC_K", "COO_K", "COO_SMALL", "UP_EXC_K",
              "DEXC_K"):
        assert getattr(twire, k) == getattr(jwire, k), k
    assert tnative.UP_EXC_K == jnative.UP_EXC_K
    for f in ("yuv8_nbytes", "yuv5d_nbytes", "yuv_wire_nbytes",
              "yuv5d_wire_nbytes"):
        assert getattr(twire, f)(1088, 1920) == getattr(jwire, f)(1088, 1920)


def _blocks_np(y, u, v):
    """JAX planes -> the conformance step's source blocks and self_sad."""
    def blocks(p, size):
        h, w = p.shape
        return p.reshape(h // size, size, w // size, size) \
            .transpose(0, 2, 1, 3).reshape(-1, size, size)

    y, u, v = (np.asarray(p) for p in (y, u, v))
    src = (blocks(y, 16), blocks(u, 8), blocks(v, 8))
    sad = np.abs(src[0].astype(np.int64)).sum(axis=(1, 2))
    return src, sad.astype(np.uint32).view(np.int32)


def _eq_layout(got, planes, layout):
    """The port's unpack in `layout` against the JAX package's planes."""
    if layout == "planes":
        for g, r in zip(got, planes):
            _eq(g, r)
        return
    (gy, gu, gv), gsad = got
    (ry, ru, rv), rsad = _blocks_np(*planes)
    for g, r in zip((gy, gu, gv, gsad), (ry, ru, rv, rsad)):
        assert g.dtype == torch.int32 and g.is_contiguous()
        _eq(g, r)


@pytest.mark.parametrize("layout", ["planes", "blocks"])
@pytest.mark.parametrize("content", ["synth", "edges", "noise"])
def test_uplink_wires(content, layout):
    """The port's native converters give the JAX package's bytes, and the
    device unpack gives the same planes (yuv8 always; yuv5d where the
    content fits its exception list, else both fall back to yuv8), in
    the planes engine.encode_step reads and in the conformance step's
    blocks (source_blocks over the yuv8 planes)."""
    frame = content_frame(content, W, H)
    y8 = tnative.rgb_to_yuv8(frame, AW, AH, 3, 16)
    _eq(y8, jnative.rgb_to_yuv8(frame, AW, AH, 3, 16))
    want8 = jwire.unpack_yuv8(jnp.asarray(y8[8:]), AH, AW, W, H)
    got8 = twire.unpack_yuv8(_t(y8[8:]), AH, AW, W, H)
    _eq_layout(got8 if layout == "planes" else twire.source_blocks(*got8),
               want8, layout)
    kind, w5 = tnative.rgb_to_yuv5d(frame, AW, AH, 3, 16)
    jkind, jw5 = jnative.rgb_to_yuv5d(frame, AW, AH, 3, 16)
    assert kind == jkind == ("yuv8" if content == "noise" else "yuv5d")
    _eq(w5, jw5)
    if kind == "yuv5d":
        unpack = (twire.unpack_yuv5d if layout == "planes"
                  else twire.unpack_yuv5d_blocks)
        _eq_layout(unpack(_t(w5[8:]), AH, AW, W, H), want8, layout)


@pytest.fixture(scope="module")
def synth_wire():
    return yuv5d_wire(content_frame("synth", W, H), AW, AH)


@pytest.mark.parametrize("case", CASES)
def test_unpack_yuv5d_exception_positions(synth_wire, case):
    """Exception positions as drop_out_of_range takes them, against JAX's
    scatter (mode="drop"): negative ones count from the end, those still
    outside the planes (sentinels among them) are dropped, and where a
    position is listed twice JAX keeps the later entry, which the plain
    version gives on the wire without the entries it overrides. The
    blocks layout is source_blocks of the planes."""
    wire = rewritten(synth_wire, AW, AH, case, seed=CASES.index(case))
    want = jwire.unpack_yuv5d(jnp.asarray(wire[8:]), AH, AW, W, H)
    once = _t(last_entries_only(wire, AW, AH)[8:])
    got = twire.unpack_yuv5d(once, AH, AW, W, H)
    _eq_layout(got, want, "planes")
    _eq_layout(twire.unpack_yuv5d_blocks(once, AH, AW, W, H), want,
               "blocks")
    if case != "duplicates" and case != "full":
        _eq_layout(twire.unpack_yuv5d(_t(wire[8:]), AH, AW, W, H), want,
                   "planes")
    pos = wire[8:8 + 4 * twire.UP_EXC_K].view(np.int32).astype(np.int64)
    total = AH * AW * 3 // 2
    idx, keep = twire.drop_out_of_range(torch.from_numpy(pos), total)
    if case == "negative":
        assert (pos < 0).sum() >= 100 and bool(keep[pos < 0].all())
    if case == "out_of_range":
        assert int((~keep).sum()) > 0 and int(idx[keep].max()) < total
    if case in ("duplicates", "full"):
        kept = idx[keep].numpy()
        assert np.unique(kept).size < kept.size


# ------------------------------------------------------------- K12's model

CU = (pathlib.Path(twire.__file__).parent / "csrc" / "wire.cu").read_text()


def _cu_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CU)[1])


def _k12_model(wire, ah, aw, frame_w, frame_h):
    """csrc/wire.cu's unpack_yuv5d_kernel block by block, in numpy:
    returns the PLANES and the BLOCKS layouts. Each block (MB row j) sums
    the column-0 fields of the rows above its band, corrects the sum by
    each column-0 exception above the band that no later entry
    overrides, takes its rows' column-0 deltas (the latest column-0 entry
    of the row, else the field), and scans each row from its start value
    with the latest entry of each column in place of the field."""
    k, idx_bits = _cu_int("EXC_K"), _cu_int("IDX_BITS")
    assert k == twire.UP_EXC_K and k <= 1 << idx_bits
    assert _cu_int("ROWS") == 16 + 8 + 8   # a band: Y, U and V rows
    cw, ch = aw // 2, ah // 2
    ys, cs = ah * aw, ch * cw
    total = ys + 2 * cs
    exc_pos = wire[:4 * k].view(np.int32).astype(np.int64)
    exc_val = wire[4 * k:6 * k].view(np.int16).astype(np.int64)
    words = wire[6 * k:].view(np.uint32).astype(np.uint64)
    g = np.arange(total, dtype=np.uint64)
    bit = 5 * g
    wk, sh = bit >> np.uint64(5), bit & np.uint64(31)
    nxt = words[np.minimum(wk + np.uint64(1), np.uint64(words.size - 1))]
    raw = (words[wk] | (nxt << np.uint64(32))) >> sh
    field = ((raw & np.uint64(31)).astype(np.int64) ^ 16) - 16

    p = np.where(exc_pos < 0, exc_pos + total, exc_pos)
    valid = (p >= 0) & (p < total)
    plane = np.where(p >= ys, np.where(p >= ys + cs, 2, 1), 0)
    off = p - np.array([0, ys, ys + cs])[plane]
    width = np.array([aw, cw, cw])[plane]
    row, col = off // width, off % width
    bases, widths, band_h = (0, ys, ys + cs), (aw, cw, cw), (16, 8, 8)

    out = [np.zeros((ah, aw), np.int64), np.zeros((ch, cw), np.int64),
           np.zeros((ch, cw), np.int64)]
    for j in range(ah // 16):
        start = [band_h[q] * j for q in range(3)]
        band_sum = [int(field[bases[q] + np.arange(start[q]) * widths[q]]
                        .sum()) for q in range(3)]
        cand = np.flatnonzero(valid & (col == 0)
                              & (row < np.array(start)[plane]))
        for i in cand:
            if not np.any((cand > i) & (p[cand] == p[i])):
                band_sum[plane[i]] += exc_val[i] - field[p[i]]
        in_band = valid & (row >= np.array(start)[plane]) \
            & (row < np.array(start)[plane] + np.array(band_h)[plane])
        for q in range(3):
            carry = band_sum[q]
            for r in range(start[q], start[q] + band_h[q]):
                fb = bases[q] + r * widths[q]
                mine = np.flatnonzero(in_band & (plane == q) & (row == r))
                d = field[fb:fb + widths[q]].copy()
                for i in mine:        # ascending entries: the latest wins
                    d[col[i]] = exc_val[i]
                carry += d[0]
                d[0] = 0
                out[q][r] = carry + np.cumsum(d)
    planes = [o.astype(np.uint32).view(np.int32) for o in out]
    y = planes[0].astype(np.int64)
    mask = ((np.arange(ah)[:, None] < frame_h)
            & (np.arange(aw)[None, :] < frame_w))
    planes[0] = np.where(mask, y + 16, 0).astype(np.uint32).view(np.int32)
    return planes, _blocks_np(*planes)


@pytest.mark.parametrize("case", CASES)
def test_k12_model_matches_jax(synth_wire, case):
    """K12's decomposition of the scan (csrc/wire.cu) against JAX on the
    raw wire, duplicates included, in both layouts."""
    wire = rewritten(synth_wire, AW, AH, case, seed=CASES.index(case))
    want = jwire.unpack_yuv5d(jnp.asarray(wire[8:]), AH, AW, W, H)
    planes, blocks = _k12_model(wire[8:], AH, AW, W, H)
    for g, r in zip(planes, want):
        _eq(g, r)
    (ry, ru, rv), rsad = _blocks_np(*want)
    for g, r in zip((*blocks[0], blocks[1]), (ry, ru, rv, rsad)):
        _eq(g, r)


def test_k12_model_on_a_zeroed_section():
    """Content past UP_EXC_K exceptions packs a zeroed section: 8192
    entries of position 0 in the first band's first row."""
    frame = content_frame("noise", 120, 40)
    wire = yuv5d_wire(frame, 128, 48)
    want = jwire.unpack_yuv5d(jnp.asarray(wire[8:]), 48, 128, 120, 40)
    for g, r in zip(_k12_model(wire[8:], 48, 128, 120, 40)[0], want):
        _eq(g, r)


def test_unpack_entry_signature():
    """wire.UNPACK_SIGNATURE has one letter per parameter of
    cairo_unpack_yuv5d, the stream included; K12's widest frame keeps a
    column within the key's bits and a band's shared memory under 48 KB."""
    params = re.search(r'extern "C" int cairo_unpack_yuv5d\(([^)]*)\)',
                       CU)[1]
    sig = "".join("p" if "*" in q or "stream" in q else "i"
                  for q in params.split(","))
    assert sig == twire.UNPACK_SIGNATURE
    idx_bits = _cu_int("IDX_BITS")
    assert twire.K12_MAX_WIDTH << idx_bits < 2 ** 31
    assert twire.K12_MAX_WIDTH <= 1 << _cu_int("COL_BITS")
    smem = 4 * (twire.UP_EXC_K + twire.K12_MAX_WIDTH // 16) + 4 * (
        4 * 32 + 1 + 3 * 32 + 3 + 1)
    assert smem <= 48 * 1024


def test_uplink_small_frame_falls_back():
    frame = synth_frames(72, 56, 1)[0]
    kind, w = tnative.rgb_to_yuv5d(frame, 80, 64, 0, 16)
    assert kind == "yuv8"
    _eq(w, tnative.rgb_to_yuv8(frame, 80, 64, 0, 16))
    # the 5-bit packing itself is exact at any size
    n_exc, w5 = tnative.yuv8_to_yuv5d(w, 80, 64)
    assert n_exc <= tnative.UP_EXC_K
    for g, r in zip(twire.unpack_yuv5d(_t(w5[8:]), 64, 80, 72, 56),
                    twire.unpack_yuv8(_t(w[8:]), 64, 80, 72, 56)):
        _eq(g, r)


def _planes(seed, smooth):
    rng = np.random.RandomState(seed)
    if smooth:
        def grad(h, w, lo, hi):
            gy = np.sin(np.arange(h)[:, None] / 37.0)
            gx = np.cos(np.arange(w)[None, :] / 53.0)
            g = (lo + hi) / 2 + (hi - lo) / 4 * (gy + gx)
            return (g + rng.randint(-2, 3, (h, w))).astype(np.int32)
        y = grad(AH, AW, 40, 240) + 16
        u = grad(AH // 2, AW // 2, 60, 200)
        v = grad(AH // 2, AW // 2, 50, 210)
    else:
        y = rng.randint(-40, 320, (AH, AW)).astype(np.int32)
        u = rng.randint(0, 256, (AH // 2, AW // 2)).astype(np.int32)
        v = rng.randint(0, 256, (AH // 2, AW // 2)).astype(np.int32)
    return y, u, v


@pytest.mark.parametrize("case", ["smooth", "out_of_window", "noise",
                                  "pad_region"])
def test_downlink_wires(case):
    """pack_yuv_wire / pack_yuv5d_wire bytes equal the JAX package's,
    including exception counts beyond both capacities (noise)."""
    y, u, v = _planes(1 if case != "noise" else 3, case != "noise")
    fw, fh = W, H
    if case == "out_of_window":
        y[5, 5], y[7, 9], u[3, 3] = 300, -20, 280
    if case == "pad_region":
        y[H:, :] = 0
        u[:, (W + 1) // 2:] = -5
    planes_t = [_t(p) for p in (y, u, v)]
    planes_j = [jnp.asarray(p) for p in (y, u, v)]
    w8 = twire.pack_yuv_wire(*planes_t, fw, fh)
    _eq(w8, jwire.pack_yuv_wire(*planes_j, fw, fh))
    w5 = twire.pack_yuv5d_wire(*planes_t, fw, fh)
    _eq(w5, jwire.pack_yuv5d_wire(*planes_j, fw, fh))
    count8 = int(np.frombuffer(w8.numpy()[AH * AW * 3 // 2:][:4].tobytes(),
                               np.int32)[0])
    count5 = int(np.frombuffer(w5.numpy()[:4].tobytes(), np.int32)[0])
    if case == "noise":
        assert count8 > twire.EXC_K and count5 > twire.DEXC_K
    elif case == "pad_region":
        assert count8 == 0
    elif case == "out_of_window":
        assert count8 == 3
    if count8 <= twire.EXC_K:
        gy, gu, gv, _ = twire.unpack_yuv_wire_np(w8.numpy(), AH, AW)
        _eq(gy[:H, :W], y[:H, :W])


@pytest.mark.parametrize("n,k,density", [(1000, 64, 0.02), (5000, 64, 0.5),
                                         (4096, 128, 0.0), (3000, 4096, 1.0),
                                         (700, 16, 0.03)])
def test_compact_matches_jax(n, k, density):
    rng = np.random.default_rng(7)
    vals = rng.integers(-300, 300, n).astype(np.int32)
    mask = rng.random(n) < density
    vals = np.where(mask & (vals == 0), 1, vals) * mask
    got = twire._compact(_t(vals), _t(mask), k)
    want = jwire._compact(jnp.asarray(vals), jnp.asarray(mask), k)
    for g, w in zip(got, want):
        _eq(g, w)


def _table(rng, n, copy_frac):
    bt = rng.integers(0, 8, n).astype(np.uint8)
    bt = np.where(bt == 5, 4, bt).astype(np.uint8)
    bt[rng.random(n) < copy_frac] = 4
    return dict(
        block_type=bt,
        prediction_target=rng.integers(0, 4, n).astype(np.uint8),
        motion_x=rng.integers(-16, 17, n).astype(np.int16),
        motion_y=rng.integers(-16, 17, n).astype(np.int16),
        sp_pred=rng.random(n) < 0.5, sp_amount=rng.random(n) < 0.5,
        sp_index=rng.integers(0, 8, n).astype(np.uint8),
        q_index=rng.integers(0, 32, n).astype(np.uint8),
        variance=rng.integers(-32768, 32768, n).astype(np.int16))


@pytest.mark.parametrize("density", [0.01, 0.2, 0.9])
def test_encode_wire_roundtrip(density):
    """Head and tail buffers equal the JAX package's, from a head-only
    count to a count past COO_K; the host unpack and COO apply reproduce
    the exact planes whenever the count fits."""
    rng = np.random.default_rng(int(density * 100))
    n = (AW // 16) * (AH // 16)
    table = _table(rng, n, 0.3)
    copy = (table["block_type"] & 4) != 0

    def plane(h, w):
        p = rng.integers(-500, 500, (h, w)).astype(np.int16)
        return np.where(rng.random((h, w)) < density, p, 0).astype(np.int16)

    cy, cu, cv = plane(AH, AW), plane(AH // 2, AW // 2), plane(AH // 2, AW // 2)
    head, tail = twire.pack_encode_wire(
        {k: _t(v) for k, v in table.items()}, _t(cy), _t(cu), _t(cv),
        _t(copy))
    jhead, jtail = jwire.pack_encode_wire(
        {k: jnp.asarray(v) for k, v in table.items()}, jnp.asarray(cy),
        jnp.asarray(cu), jnp.asarray(cv), jnp.asarray(copy))
    _eq(head, jhead)
    _eq(tail, jtail)
    out, count, pos, val = twire.unpack_encode_wire(
        head.numpy(), n, tail=lambda: tail.numpy())
    jout, jcount, jpos, jval = jwire.unpack_encode_wire(
        np.asarray(jhead), n, tail=lambda: np.asarray(jtail))
    assert count == jcount
    _eq(pos, jpos)
    _eq(val, jval)
    for key in out:
        _eq(out[key], jout[key])
    if density == 0.9:
        assert count > twire.COO_K  # the overflow case really overflows
        return
    planes = [np.zeros_like(p) for p in (cy, cu, cv)]
    twire.apply_coo_np(*planes, copy, count, pos, val)
    ymask = np.repeat(np.repeat(copy.reshape(AH // 16, AW // 16), 16, 0),
                      16, 1)
    _eq(planes[0], np.where(ymask, 0, cy))


def test_table_wire():
    rng = np.random.default_rng(5)
    n = 80
    t = _table(rng, n, 0.2)
    bt = BlockTable(**t)
    buf = twire.pack_table_np(bt)
    _eq(buf, jwire.pack_table_np(bt))
    got = twire.unpack_table_wire(_t(buf), n)
    want = jwire.unpack_table_wire(jnp.asarray(buf), n)
    for key in want:
        _eq(got[key], want[key])
