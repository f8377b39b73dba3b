"""cairo_tpu_torch.gpu.wire against cairo_tpu.tpu.wire on the CPU: the
wires must be byte-identical (the native converters read both), in the
cases of test_delta_wire.py and test_wire_overflow.py: exception overflow
both ways, COO past COO_K, the small-frame yuv8 fallback."""

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


@pytest.mark.parametrize("content", ["synth", "edges", "noise"])
def test_uplink_wires(content):
    """The port's native converters give the JAX package's bytes, and the
    device unpack gives the same planes (yuv8 always; yuv5d where the
    content fits its exception list, else both fall back to yuv8)."""
    if content == "synth":
        frame = synth_frames(W, H, 2)[1]
    elif content == "edges":
        frame = np.full((H, W, 3), 90, np.uint8)
        frame[10:40, 20:50] = 230
        frame[100:140, 300:420] = 5
        frame[200:220, 100:104] = 255
    else:
        frame = np.random.default_rng(0).integers(
            0, 256, (H, W, 3)).astype(np.uint8)
    y8 = tnative.rgb_to_yuv8(frame, AW, AH, 3, 16)
    _eq(y8, jnative.rgb_to_yuv8(frame, AW, AH, 3, 16))
    for g, r in zip(twire.unpack_yuv8(_t(y8[8:]), AH, AW, W, H),
                    jwire.unpack_yuv8(jnp.asarray(y8[8:]), AH, AW, W, H)):
        _eq(g, r)
    kind, w5 = tnative.rgb_to_yuv5d(frame, AW, AH, 3, 16)
    jkind, jw5 = jnative.rgb_to_yuv5d(frame, AW, AH, 3, 16)
    assert kind == jkind == ("yuv8" if content == "noise" else "yuv5d")
    _eq(w5, jw5)
    if kind == "yuv5d":
        got = twire.unpack_yuv5d(_t(w5[8:]), AH, AW, W, H)
        want = jwire.unpack_yuv8(jnp.asarray(y8[8:]), AH, AW, W, H)
        for g, r in zip(got, want):
            _eq(g, r)


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
