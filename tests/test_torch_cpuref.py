"""cairo_tpu_torch's numpy reference engine (Evx1Encoder / Evx1Decoder in
cpuref/) against cairo_tpu.cpuref.api, exact: chunks at 64x48, 176x144
and the unaligned 120x56 at q 4, 16 and 29, with insert_intra and
set_quality mid-stream and under the configurations off the conformance
defaults; decoded RGB; the peek_* views; checkpoints dumped by one
package and loaded by the other continue the same bytes; and the port's
ConformanceGpuEncoder on the CPU gives the port's Evx1Encoder's bytes."""

import numpy as np
import pytest

from cairo_tpu import checkpoint as jcheckpoint
from cairo_tpu.config import CodecConfig as JConfig
from cairo_tpu.cpuref import api as japi
from cairo_tpu_torch import ConformanceGpuEncoder, Evx1Decoder, Evx1Encoder
from cairo_tpu_torch import checkpoint as tcheckpoint
from cairo_tpu_torch.config import CodecConfig as TConfig

from util_video import synth_frames

CASES = {
    "64x48_q4": dict(size=(64, 48), frames=4, quality=4),
    "64x48_q16_insert_intra": dict(size=(64, 48), frames=5, quality=16,
                                   insert_intra_at={3}),
    "64x48_q29": dict(size=(64, 48), frames=4, quality=29),
    "176x144_q4": dict(size=(176, 144), frames=2, quality=4),
    "176x144_q16": dict(size=(176, 144), frames=2, quality=16),
    "176x144_q29": dict(size=(176, 144), frames=2, quality=29),
    "120x56_quality_changes": dict(size=(120, 56), frames=4, quality=16,
                                   quality_at={2: 4, 3: 29}),
}

CONFIGS = {
    "linear_unrounded": dict(linear_quantization=True,
                             rounded_quantization=False),
    "no_quant_no_deblock": dict(quantization_enabled=False,
                                enable_deblocking=False),
    "gray_fixed_qp_2refs": dict(enable_chroma=False,
                                adaptive_quantization=False,
                                reference_frame_count=2),
    "intra_every_2": dict(periodic_intra_rate=2),
    "intra_only": dict(enable_inter_frames=False),
}

PEEKS = ("peek_source", "peek_destination", "peek_block_table",
         "peek_quant_table", "peek_block_variance", "peek_spmp_table")


def _encode(enc, frames, quality=16, insert_intra_at=(), quality_at=None):
    enc.set_quality(quality)
    chunks = []
    for t, f in enumerate(frames):
        if t in insert_intra_at:
            enc.insert_intra()
        if quality_at and t in quality_at:
            enc.set_quality(quality_at[t])
        chunks.append(enc.encode(f))
    return chunks


def _frames(size, n):
    return synth_frames(*size, n)


@pytest.fixture(scope="module")
def streams():
    """Per case: frames, controls, cairo_tpu's chunks and decoded RGB."""
    out = {}
    for name, case in CASES.items():
        case = dict(case)
        frames = _frames(case.pop("size"), case.pop("frames"))
        chunks = _encode(japi.Evx1Encoder(), frames, **case)
        dec = japi.Evx1Decoder()
        out[name] = (frames, case, chunks, [dec.decode(c) for c in chunks])
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_chunks_and_rgb_match_cairo_tpu(streams, name):
    frames, case, want, want_rgb = streams[name]
    enc = Evx1Encoder()
    assert _encode(enc, frames, **case) == want
    dec = Evx1Decoder()
    for t, (c, rgb) in enumerate(zip(want, want_rgb)):
        got = dec.decode(c)
        assert got.dtype == np.uint8 and got.shape == frames[t].shape
        np.testing.assert_array_equal(got, rgb, err_msg=f"frame {t}")
    np.testing.assert_array_equal(enc.peek_destination(), want_rgb[-1])
    assert enc.last_stats["bytes"] == len(want[-1])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_configurations_match_cairo_tpu(name):
    """The branches off the conformance defaults: linear (H.263) and
    truncating quantization, quantization off, no deblock, grayscale,
    frame-quality QP, two references, periodic intra, intra only."""
    frames = _frames((64, 48), 4)
    kw = CONFIGS[name]
    jenc = japi.Evx1Encoder(JConfig(**kw))
    tenc = Evx1Encoder(TConfig(**kw))
    want = _encode(jenc, frames, quality=12)
    assert _encode(tenc, frames, quality=12) == want
    jdec, tdec = japi.Evx1Decoder(JConfig(**kw)), Evx1Decoder(TConfig(**kw))
    for c in want:
        np.testing.assert_array_equal(tdec.decode(c), jdec.decode(c))


def test_peek_views_match(streams):
    frames, case, _, _ = streams["64x48_q16_insert_intra"]
    jenc, tenc = japi.Evx1Encoder(), Evx1Encoder()
    for enc in (jenc, tenc):
        _encode(enc, frames[:4], **case)
    for peek in PEEKS:
        want = getattr(jenc, peek)()
        got = getattr(tenc, peek)()
        assert got.dtype == want.dtype, peek
        np.testing.assert_array_equal(got, want, err_msg=peek)


PKGS = {"cairo_tpu": (japi.Evx1Encoder, japi.Evx1Decoder, jcheckpoint),
        "port": (Evx1Encoder, Evx1Decoder, tcheckpoint)}


@pytest.mark.parametrize("src,dst", [("cairo_tpu", "port"),
                                     ("port", "cairo_tpu")])
def test_checkpoints_cross_packages(streams, src, dst):
    """An encoder and a decoder checkpointed mid-stream by one package
    resume in the other and continue the same bytes and RGB."""
    frames, case, want, want_rgb = streams["120x56_quality_changes"]
    enc_cls, dec_cls, ckpt = PKGS[src]
    enc, dec = enc_cls(), dec_cls()
    head = _encode(enc, frames[:2], **case)
    for c in head:
        dec.decode(c)
    enc_cls, dec_cls, ckpt2 = PKGS[dst]
    enc2 = ckpt2.load_state(enc_cls(), ckpt.dump_state(enc))
    dec2 = ckpt2.load_state(dec_cls(), ckpt.dump_state(dec))
    tail = []
    for t in (2, 3):
        enc2.set_quality(case["quality_at"][t])
        tail.append(enc2.encode(frames[t]))
    assert head + tail == want
    for t in (2, 3):
        np.testing.assert_array_equal(dec2.decode(want[t]), want_rgb[t])
    meta, _ = enc2.state_dict()
    assert meta["kind"] == "cpuref_encoder" and meta["frame_index"] == 4


def test_unstarted_checkpoint_crosses_packages():
    enc = tcheckpoint.load_state(Evx1Encoder(), jcheckpoint.dump_state(
        japi.Evx1Encoder()))
    assert enc._ctx is None and enc.frame_index == 0
    frames = _frames((64, 48), 2)
    assert _encode(enc, frames) == _encode(japi.Evx1Encoder(), frames)


@pytest.mark.parametrize("name", ["64x48_q16_insert_intra",
                                  "120x56_quality_changes"])
def test_conformance_gpu_encoder_on_cpu_matches(streams, name):
    """The port's device path, run on the CPU, against the port's own
    reference engine (the anchor chip_smoke.py phase 9 uses on the
    card)."""
    frames, case, want, _ = streams[name]
    got_ref = _encode(Evx1Encoder(), frames, **case)
    got_dev = _encode(ConformanceGpuEncoder(device="cpu"), frames, **case)
    assert got_dev == got_ref == want


def test_out_of_order_and_size_change_raise():
    frames = _frames((64, 48), 2)
    chunks = _encode(Evx1Encoder(), frames)
    dec = Evx1Decoder()
    dec.decode(chunks[0])
    with pytest.raises(ValueError):
        dec.decode(chunks[0][14:])      # frame 0 again, header dropped
    enc = Evx1Encoder()
    enc.encode(frames[0])
    with pytest.raises(ValueError):
        enc.encode(_frames((80, 48), 1)[0])
    with pytest.raises(ValueError):
        Evx1Decoder().decode(b"EVX2" + chunks[0][4:])
