"""cairo_tpu_torch.entropy (the host copies of bitio, abac, slicecodec and
backends) against cairo_tpu.entropy, exact: every function of
backends.__all__ writes the same bits as cairo_tpu's on the same values
and reads them back; the Huffman precoder's unterminated 7; the zigzag
block coders at 4x4, 8x8 and 16x16 over the residual and the full int16
range; the 8x8 RLE; BitStream's reads, writes, capacity limits and seek
quirk; the Python slice codec against the port's native C++ coder on
the block table and coefficients of real encoded frames, both ways; and
chip_smoke.py's phase-9 backend round trips on the CPU."""

import importlib.util
import pathlib

import numpy as np
import pytest

from cairo_tpu.entropy import backends as jb
from cairo_tpu.entropy import bitio as jbitio
from cairo_tpu_torch import Evx1Encoder, native
from cairo_tpu_torch.blocktypes import BlockTable
from cairo_tpu_torch.entropy import backends as tb
from cairo_tpu_torch.entropy import bitio as tbitio
from cairo_tpu_torch.entropy import slicecodec

from util_video import synth_frames

N = 600
RANGES = {"residual": (-300, 301), "int16": (-32768, 32768)}


def _values(kind, n=N, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "huffman":
        return rng.integers(0, 8, n)
    if kind == "unsigned":
        v = rng.integers(0, 65536, n)
        v[: n // 2] = rng.integers(0, 300, n // 2)   # the table and beyond
        return v
    lo, hi = RANGES[kind]
    v = rng.integers(lo, hi, n)
    v[:3] = (0, lo, hi - 1)
    return v


def _both(pkg_fn, values, **kw):
    """Writes `values` with one package's function; returns the bytes and
    the bit count."""
    fn, writer_cls, coder = pkg_fn
    out = writer_cls()
    if coder is None:
        fn(values, out, **kw)
    else:
        c = coder()
        for v in values:
            fn(int(v), c, out, **kw)
        c.finish_encode(out)
    return out.getvalue(), out.bit_count


@pytest.mark.parametrize("kind", ["huffman"])
def test_huffman_streams_match(kind):
    values = _values(kind)
    want = _both((jb.huffman_encode_values, jb.BitWriter, None), values)
    got = _both((tb.huffman_encode_values, tb.BitWriter, None), values)
    assert got == want
    back = tb.huffman_decode_values(tb.BitReader(got[0], got[1]), N)
    np.testing.assert_array_equal(back, values)
    np.testing.assert_array_equal(
        back, jb.huffman_decode_values(jb.BitReader(*want), N))


def test_huffman_seven_is_unterminated():
    for mod in (jb, tb):
        out = mod.BitWriter()
        mod.huffman_encode_value(7, out)
        assert out.bit_count == 7 and out.getvalue() == b"\x00"
        out = mod.BitWriter()
        mod.huffman_encode_value(6, out)
        assert out.bit_count == 7 and out.getvalue() == b"\x40"
        with pytest.raises(ValueError):
            mod.huffman_encode_value(8, mod.BitWriter())
    seq = [7, 0, 7, 3]
    w = tb.BitWriter()
    tb.huffman_encode_values(seq, w)
    assert list(tb.huffman_decode_values(tb.BitReader(w.getvalue(),
                                                      w.bit_count), 4)) == seq


@pytest.mark.parametrize("kind", ["residual", "int16", "unsigned"])
def test_golomb_streams_match(kind):
    signed = kind != "unsigned"
    values = _values(kind)
    want = _both((jb.golomb_encode_values, jb.BitWriter, None), values,
                 signed=signed)
    got = _both((tb.golomb_encode_values, tb.BitWriter, None), values,
                signed=signed)
    assert got == want
    back = tb.golomb_decode_values(tb.BitReader(*got), N, signed=signed)
    np.testing.assert_array_equal(
        back, jb.golomb_decode_values(jb.BitReader(*want), N, signed=signed))
    np.testing.assert_array_equal(back.astype(np.int64) & 0xFFFF,
                                  values.astype(np.int64) & 0xFFFF)
    src = tb.BitReader(*got)
    assert [tb.golomb_decode_value(src, signed=signed)
            for _ in range(5)] == list(back[:5].astype(np.int64)
                                       if signed else back[:5].view(np.uint16))


@pytest.mark.parametrize("kind", ["residual", "int16", "unsigned"])
def test_entropy_value_streams_match(kind):
    """Golomb codes through the adaptive arithmetic coder."""
    signed = kind != "unsigned"
    values = _values(kind, seed=1)
    want = _both((jb.entropy_encode_value, jb.BitWriter, jb.EntropyCoder),
                 values, signed=signed)
    got = _both((tb.entropy_encode_value, tb.BitWriter, tb.EntropyCoder),
                values, signed=signed)
    assert got == want
    src, coder = tb.BitReader(*got), tb.EntropyCoder()
    coder.start_decode(src)
    back = [tb.entropy_decode_value(coder, src, signed=signed)
            for _ in values]
    np.testing.assert_array_equal(np.asarray(back) & 0xFFFF, values & 0xFFFF)


def _block_stream(mod, blocks, rle):
    out, coder = mod.BitWriter(), mod.EntropyCoder()
    for b in blocks:
        if rle:
            mod.entropy_rle_encode_8x8(b, coder, out)
        else:
            mod.entropy_encode_block(b, coder, out)
    coder.finish_encode(out)
    return out.getvalue(), out.bit_count


def _blocks(size, kind, n=24, seed=2):
    rng = np.random.default_rng(seed + size)
    lo, hi = RANGES[kind]
    blocks = rng.integers(lo, hi, (n, size, size)).astype(np.int16)
    # sparse tails, as after quantization, and an all-zero block
    blocks[::2].reshape(n // 2, -1)[:, size:] = 0
    blocks[1] = 0
    blocks[3, 0, 0] = -32768 if kind == "int16" else 0
    return blocks


@pytest.mark.parametrize("kind", list(RANGES))
@pytest.mark.parametrize("size", [4, 8, 16])
def test_zigzag_block_coders_match(size, kind):
    blocks = _blocks(size, kind)
    got = _block_stream(tb, blocks, rle=False)
    assert got == _block_stream(jb, blocks, rle=False)
    src, coder = tb.BitReader(*got), tb.EntropyCoder()
    coder.start_decode(src)
    for b in blocks:
        np.testing.assert_array_equal(
            tb.entropy_decode_block(size, coder, src), b)


@pytest.mark.parametrize("kind", list(RANGES))
def test_rle_8x8_matches(kind):
    blocks = _blocks(8, kind)
    got = _block_stream(tb, blocks, rle=True)
    assert got == _block_stream(jb, blocks, rle=True)
    src, coder = tb.BitReader(*got), tb.EntropyCoder()
    coder.start_decode(src)
    for b in blocks:
        np.testing.assert_array_equal(tb.entropy_rle_decode_8x8(coder, src),
                                      b)


def test_all_names_exported():
    assert tb.__all__ == jb.__all__
    for name in tb.__all__:
        assert callable(getattr(tb, name)), name


def _bitstream_script(mod):
    """The same sequence of BitStream calls; returns every result."""
    s = mod.BitStream(40)
    log = [s.query_capacity(), s.is_empty(), s.write_bit(1),
           s.write_byte(0xA5), s.write_bits(b"\x0f\xf0", 12),
           s.write_bytes(b"\x81", 1), s.query_occupancy(),
           s.query_byte_occupancy(), s.write_bytes(b"\xff" * 4, 4),
           s.peek_bit(), s.peek_byte(), s.peek_bits(11), s.read_bit(),
           s.read_byte(), s.read_bits(5), s.read_bytes(1)]
    s.seek(100)   # past the write index: lands at write_index + offset
    log += [s.read_index, s.write_index, s.read_bit(), s.is_full(),
            s.query_data()]
    t = mod.BitStream(data=bytes(range(7)))
    log += [t.read_bytes(3), t.read_bits(13), t.peek_bytes(2), t.seek(2),
            t.read_index, t.read_byte(), t.assign(b""), t.is_empty()]
    t.clear()
    log += [t.query_capacity(), t.resize_capacity(0), t.resize_capacity(9),
            t.query_capacity()]
    return log


def test_bitstream_matches():
    assert _bitstream_script(tbitio) == _bitstream_script(jbitio)


FIELDS = ("block_type", "prediction_target", "motion_x", "motion_y",
          "sp_pred", "sp_amount", "sp_index", "q_index")


def _real_frames():
    """Block tables and coefficient planes of real encoded frames (one
    intra, two inter) from the port's reference engine."""
    enc = Evx1Encoder()
    enc.set_quality(8)
    out = []
    for f in synth_frames(96, 64, 3, noise=0):
        f[:, 48:] = (120, 100, 140)     # a flat area: copy blocks
        enc.encode(f)
        ctx = enc._ctx
        out.append((ctx.block_table.copy(), ctx.output.y.copy(),
                    ctx.output.u.copy(), ctx.output.v.copy()))
    return out


def test_slice_codec_matches_native():
    """The Python slice coder and the native C++ one write the same bits
    for the same frames, and each decodes the other's bytes to the same
    table and planes (both persist them across frames, and the planes
    equal the encoder's, whose copy blocks keep stale coefficients too)."""
    frames = _real_frames()
    n = len(frames[0][0])
    kinds = {int(t) for bt, *_ in frames for t in bt.block_type}
    assert {1, 2, 3} <= kinds and kinds & {4, 5, 6, 7}   # copy blocks too
    state = {k: (BlockTable.zeros(n), [np.zeros_like(p) for p in
                                       frames[0][1:]])
             for k in ("python", "native")}
    for bt, y, u, v in frames:
        out = tbitio.BitWriter()
        slicecodec.encode_slice(bt, y, u, v, out)
        data, bits = native.encode_slice(bt, y, u, v)
        assert out.getvalue() == data and out.bit_count == bits
        slicecodec.decode_slice(tbitio.BitReader(data), n,
                                *state["python"][1], state["python"][0])
        native.decode_slice(out.getvalue(), 0, state["native"][0],
                            *state["native"][1])
        (pt, pp), (nt, npl) = state["python"], state["native"]
        for k in FIELDS:
            np.testing.assert_array_equal(pt.__dict__[k], nt.__dict__[k],
                                          err_msg=k)
        np.testing.assert_array_equal(pt.block_type, bt.block_type)
        for a, b, want in zip(pp, npl, (y, u, v)):
            np.testing.assert_array_equal(a, want)
            np.testing.assert_array_equal(b, want)


def test_chip_smoke_backend_round_trips():
    """chip_smoke.py's phase-9 check of the backends (10,000 values each
    on the card machine) at 400 values: every backend round-trips."""
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    bits = smoke.library_backends(np, 5, n=400)
    assert set(bits) == {"huffman", "golomb_signed", "golomb_unsigned",
                         "entropy_signed", "entropy_unsigned", "block_4x4",
                         "block_8x8", "block_16x16", "rle_8x8"}
    assert all(b > 400 for b in bits.values())
