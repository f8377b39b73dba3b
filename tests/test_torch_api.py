"""GpuEncoder / GpuDecoder (device="cpu") against TpuEncoder / TpuDecoder:
byte-identical chunks, identical RGB, checkpoint hand-over from the JAX
package to the port, the host-decoder frame count, and the capacity
overflow paths (the wavefront decode: test_torch_wavedec.py)."""

import numpy as np
import pytest

from cairo_tpu import checkpoint as jcheckpoint
from cairo_tpu.cpuref.api import Evx1Decoder, Evx1Encoder
from cairo_tpu.tpu.api import TpuDecoder, TpuEncoder
from cairo_tpu_torch import checkpoint as tcheckpoint
from cairo_tpu_torch.gpu import api, wire as twire
from cairo_tpu_torch.synth import synth_frames as port_synth_frames

from util_video import synth_frames

W, H = 96, 64


def _encode_both(frames, quality, events=None):
    """Encodes with both packages; `events` maps frame -> (quality or None,
    insert_intra). Returns (chunks, TpuEncoder, GpuEncoder)."""
    jenc, tenc = TpuEncoder(), api.GpuEncoder(device="cpu")
    chunks = []
    for enc in (jenc, tenc):
        enc.set_quality(quality)
    for i, f in enumerate(frames):
        q, intra = (events or {}).get(i, (None, False))
        for enc in (jenc, tenc):
            if q is not None:
                enc.set_quality(q)
            if intra:
                enc.insert_intra()
        a, b = jenc.encode(f), tenc.encode(f)
        assert a == b, f"frame {i}: chunks differ ({len(a)} vs {len(b)} B)"
        chunks.append(b)
    return chunks, jenc, tenc


@pytest.mark.parametrize("quality", [8, 16, 31])
def test_chunks_and_rgb_match(quality):
    frames = synth_frames(W, H, 6)
    events = {2: (quality + 5 if quality < 26 else 12, False),
              4: (None, True)}
    chunks, jenc, tenc = _encode_both(frames, quality, events)
    assert tenc.last_stats["bytes"] == jenc.last_stats["bytes"]
    for peek in ("peek_destination", "peek_source", "peek_block_table",
                 "peek_quant_table", "peek_block_variance",
                 "peek_spmp_table"):
        np.testing.assert_array_equal(getattr(tenc, peek)(),
                                      getattr(jenc, peek)(), err_msg=peek)
    jdec, tdec = TpuDecoder(), api.GpuDecoder(device="cpu")
    cdec = Evx1Decoder()
    for i, c in enumerate(chunks):
        want = jdec.decode(c)
        got = tdec.decode(c)
        np.testing.assert_array_equal(got, want, err_msg=f"frame {i}")
        np.testing.assert_array_equal(got, cdec.decode(c),
                                      err_msg=f"frame {i} vs cpuref")
        assert tdec.last_stats["path"] == "device"
    assert tdec.host_frames == 0
    np.testing.assert_array_equal(got, tenc.peek_destination())


def test_many_matches_single():
    frames = synth_frames(W, H, 4, seed=3)
    chunks, _, _ = _encode_both(frames, 16)
    enc = api.GpuEncoder(device="cpu")
    enc.set_quality(16)
    assert list(enc.encode_many(frames)) == chunks
    dec = api.GpuDecoder(device="cpu")
    jdec = TpuDecoder()
    for got, c in zip(dec.decode_many(chunks), chunks):
        np.testing.assert_array_equal(got, jdec.decode(c))


def test_tpu_checkpoint_resumes_in_port():
    """A TpuEncoder/TpuDecoder checkpoint taken mid-stream resumes in
    GpuEncoder/GpuDecoder with identical bytes and pixels after it."""
    frames = synth_frames(W, H, 6, seed=5)
    jenc = TpuEncoder()
    jenc.set_quality(16)
    jdec = TpuDecoder()
    chunks = [jenc.encode(f) for f in frames[:3]]
    for c in chunks:
        jdec.decode(c)
    enc_blob = jcheckpoint.dump_state(jenc)
    dec_blob = jcheckpoint.dump_state(jdec)

    tenc = tcheckpoint.load_state(api.GpuEncoder(device="cpu"), enc_blob)
    tdec = tcheckpoint.load_state(api.GpuDecoder(device="cpu"), dec_blob)
    for f in frames[3:]:
        a, b = jenc.encode(f), tenc.encode(f)
        assert a == b
        np.testing.assert_array_equal(tdec.decode(b), jdec.decode(a))
    # and the port's own checkpoint round-trips
    again = tcheckpoint.load_state(api.GpuEncoder(device="cpu"),
                                   tcheckpoint.dump_state(tenc))
    extra = synth_frames(W, H, 7, seed=5)[6]
    assert again.encode(extra) == tenc.encode(extra)


def test_host_path_frames_are_counted():
    """Reference-encoder streams carry intra-motion blocks: with the
    wavefront decode off, every frame takes the native sequential decoder,
    and the count says so."""
    frames = synth_frames(64, 48, 3)
    enc = Evx1Encoder()
    enc.set_quality(16)
    chunks = [enc.encode(f) for f in frames]
    jdec = TpuDecoder()
    jdec.use_wavefront_decode = False
    tdec = api.GpuDecoder(device="cpu")
    tdec.use_wavefront_decode = False
    cdec = Evx1Decoder()
    for i, c in enumerate(chunks):
        got = tdec.decode(c)
        np.testing.assert_array_equal(got, jdec.decode(c))
        np.testing.assert_array_equal(got, cdec.decode(c))
        assert tdec.last_stats == dict(path="host", host_frames=i + 1)
    assert tdec.host_frames == len(chunks)


@pytest.mark.parametrize("case", ["coo", "exceptions"])
def test_capacity_overflows(monkeypatch, case):
    """In the port alone, shrunken capacities force the overflow paths:
    COO overflow (exact-plane refetch in the encoder, dense decode step
    in the decoder) or YUV-wire exception overflow (exact ring refetch).
    Bytes and pixels stay those of the JAX package at full capacity."""
    rng = np.random.default_rng(2)
    shape, quality = ((48, 40, 3), 1) if case == "coo" else ((64, 64, 3), 31)
    frames = [rng.integers(0, 255, shape).astype(np.uint8) for _ in range(3)]
    refetches = []
    if case == "coo":
        monkeypatch.setattr(twire, "COO_K", 256)
    else:
        monkeypatch.setattr(twire, "EXC_K", 2)
        exact = api.cpu_imaging.yuv420_to_rgb
        monkeypatch.setattr(api.cpu_imaging, "yuv420_to_rgb",
                            lambda *a: refetches.append(1) or exact(*a))
    chunks, _, tenc = _encode_both(frames, quality)
    if case == "coo":
        assert int((tenc._coef_y != 0).sum()) > twire.COO_K
    jdec, tdec = TpuDecoder(), api.GpuDecoder(device="cpu")
    for i, c in enumerate(chunks):
        np.testing.assert_array_equal(tdec.decode(c), jdec.decode(c),
                                      err_msg=f"frame {i}")
    assert tdec.host_frames == 0
    if case == "exceptions":
        assert refetches  # the lossy wire really was refetched


def test_default_device_needs_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.GpuEncoder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.GpuDecoder()


def test_port_synth_frames_match_test_content():
    for a, b in zip(port_synth_frames(50, 40, 3, seed=9),
                    synth_frames(50, 40, 3, seed=9)):
        np.testing.assert_array_equal(a, b)
