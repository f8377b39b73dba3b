"""The pipelined encode_many / decode_many of the port (gpu/pipeline.py),
device="cpu", against the JAX package's pipelined paths (TpuEncoder,
ConformanceTpuEncoder and TpuDecoder's encode_many / decode_many on CPU
JAX), the port's own loops and the numpy cpuref codec: byte-identical
chunks and identical RGB, also with set_quality / insert_intra between
yields, a stream that moves to the native decoder, capacity overflows, a
lagging convert lane and worker errors; the outputs that alias device
state; and chip_smoke.py's phase-7 measuring function."""

import importlib.util
import pathlib
import struct
import threading
import time

import numpy as np
import pytest
import torch

from cairo_tpu.cpuref.api import Evx1Decoder, Evx1Encoder
from cairo_tpu.tpu.api import ConformanceTpuEncoder, TpuDecoder, TpuEncoder
from cairo_tpu_torch import native as tnative
from cairo_tpu_torch.blocktypes import FRAME_INTER, FRAME_INTRA
from cairo_tpu_torch.cpuref import stream
from cairo_tpu_torch.gpu import api, engine, pipeline, wavefront
from cairo_tpu_torch.gpu import wire as twire

from util_video import synth_frames

ROOT = pathlib.Path(__file__).resolve().parents[1]
W, H = 96, 64    # the fast path's size in test_torch_api.py
CW, CH = 64, 48  # the conformance path's, as in test_torch_conformance.py


def _loop(enc, frames, quality):
    enc.set_quality(quality)
    return [enc.encode(f) for f in frames]


def _many(enc, frames, quality):
    enc.set_quality(quality)
    return list(enc.encode_many(frames))


def _cpuref_decode(chunks):
    dec = Evx1Decoder()
    return [dec.decode(c) for c in chunks]


def _port_loop(chunks):
    dec = api.GpuDecoder(device="cpu")
    return [dec.decode(c) for c in chunks]


def _assert_rgb(got, want, label):
    assert len(got) == len(want), label
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{label} frame {i}")


@pytest.mark.parametrize("quality", [8, 16, 31])
def test_encode_many_matches_jax_and_loop(quality):
    frames = synth_frames(W, H, 6)
    got = _many(api.GpuEncoder(device="cpu"), frames, quality)
    assert got == _many(TpuEncoder(), frames, quality)
    assert got == _loop(api.GpuEncoder(device="cpu"), frames, quality)


@pytest.mark.parametrize("quality", [8, 16, 31])
def test_conformance_encode_many_matches_jax_and_cpuref(quality):
    frames = synth_frames(CW, CH, 4, seed=11)
    got = _many(api.ConformanceGpuEncoder(device="cpu"), frames, quality)
    assert got == _many(ConformanceTpuEncoder(), frames, quality)
    assert got == _loop(Evx1Encoder(), frames, quality)
    assert got == _loop(api.ConformanceGpuEncoder(device="cpu"), frames,
                        quality)


def _steered(enc, frames):
    """encode_many driven by a consumer that calls set_quality after the
    second chunk and insert_intra after the fourth; returns the chunks and
    last_stats["frame_index"] at each yield."""
    enc.set_quality(12)
    chunks, indices = [], []
    for i, chunk in enumerate(enc.encode_many(frames)):
        chunks.append(chunk)
        indices.append(enc.last_stats["frame_index"])
        if i == 1:
            enc.set_quality(27)
        if i == 3:
            enc.insert_intra()
    return chunks, indices


def test_controls_between_yields_land_as_in_jax():
    """set_quality and insert_intra between yields land on the frame after
    the next, as in TpuEncoder.encode_many (frame N+1 is dispatched before
    chunk N is yielded): the prefetched source wire of that frame carries
    the old quality and is converted anew."""
    frames = synth_frames(W, H, 7, seed=5)
    got, indices = _steered(api.GpuEncoder(device="cpu"), frames)
    want, _ = _steered(TpuEncoder(), frames)
    assert got == want
    assert indices == list(range(len(frames)))
    offsets = [stream.HEADER_SIZE] + [0] * 6
    desc = [struct.unpack(stream._FRAME_FMT,
                          c[off:off + stream.FRAME_DESC_SIZE])
            for c, off in zip(got, offsets)]
    assert [q for _, _, q in desc] == [12, 12, 12, 27, 27, 27, 27]
    assert [t for t, _, _ in desc] == [FRAME_INTRA] + [FRAME_INTER] * 4 + [
        FRAME_INTRA, FRAME_INTER]


def test_decode_many_fast_stream():
    frames = synth_frames(W, H, 6, seed=3)
    chunks = _loop(api.GpuEncoder(device="cpu"), frames, 16)
    dec = api.GpuDecoder(device="cpu")
    got = list(dec.decode_many(chunks))
    _assert_rgb(got, list(TpuDecoder().decode_many(chunks)), "TpuDecoder")
    _assert_rgb(got, _port_loop(chunks), "loop")
    _assert_rgb(got, _cpuref_decode(chunks), "cpuref")
    assert dec.host_frames == 0 and dec.last_stats["path"] == "device"


def test_decode_many_conformance_stream_on_the_device():
    """Reference-origin frames (intra-motion blocks) take the wavefront
    decode under decode_many, with no host frame."""
    chunks = _loop(Evx1Encoder(), synth_frames(CW, CH, 5, seed=11), 16)
    dec = api.GpuDecoder(device="cpu")
    stats = []
    got = []
    for rgb in dec.decode_many(chunks):
        got.append(rgb)
        stats.append(dict(dec.last_stats))
    _assert_rgb(got, list(TpuDecoder().decode_many(chunks)), "TpuDecoder")
    _assert_rgb(got, _port_loop(chunks), "loop")
    _assert_rgb(got, _cpuref_decode(chunks), "cpuref")
    assert dec.host_frames == 0
    assert all(s["path"] == "device" for s in stats)
    assert any(s["members"] > 0 for s in stats)


def _switched(dec, chunks, at):
    """decode_many with use_wavefront_decode turned off once frame `at`
    was yielded."""
    out = []
    for i, rgb in enumerate(dec.decode_many(chunks)):
        out.append(rgb)
        if i == at:
            dec.use_wavefront_decode = False
    return out


def test_decode_many_moves_to_the_native_decoder():
    """use_wavefront_decode turned off mid-stream: from the next frame
    dispatched on, the stream moves to the native sequential decoder (as
    TpuDecoder.decode_many does) and stays there; RGB stays exact."""
    chunks = _loop(Evx1Encoder(), synth_frames(CW, CH, 6, seed=11), 16)
    dec = api.GpuDecoder(device="cpu")
    got = _switched(dec, chunks, 1)
    _assert_rgb(got, _switched(TpuDecoder(), chunks, 1), "TpuDecoder")
    _assert_rgb(got, _cpuref_decode(chunks), "cpuref")
    # frames 0-2 were dispatched before the switch took effect
    assert dec.host_frames == len(chunks) - 3
    assert dec.last_stats == dict(path="host", host_frames=dec.host_frames)


@pytest.mark.parametrize("source", ["fast", "conformance"])
def test_coo_overflow_every_frame(monkeypatch, source):
    """Residual volume beyond the COO capacity on every frame, through
    encode_many and decode_many: the encoder's exact-plane refetch on its
    worker gives the bytes of full capacity, and the decoder's dense
    steps (engine.decode_step, conformance_decode_step_dense) give
    cpuref's RGB."""
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 255, (48, 40, 3)).astype(np.uint8)
              for _ in range(4)]
    if source == "fast":
        full = _loop(api.GpuEncoder(device="cpu"), frames, 1)
        monkeypatch.setattr(twire, "COO_K", 256)
        enc = api.GpuEncoder(device="cpu")
        chunks = _many(enc, frames, 1)
        assert chunks == full
        assert int((enc._coef_y != 0).sum()) > twire.COO_K
    else:
        chunks = _loop(Evx1Encoder(), frames, 1)
        monkeypatch.setattr(twire, "COO_K", 256)
    dec = api.GpuDecoder(device="cpu")
    _assert_rgb(list(dec.decode_many(chunks)), _cpuref_decode(chunks),
                "cpuref")
    assert dec.host_frames == 0


def _lagging_decode(monkeypatch, chunks, delay):
    """decode_many with the convert lane slowed by `delay` s a frame;
    returns (RGB, the most frames in flight: dispatched, not yet
    converted)."""
    lock, count, peak = threading.Lock(), [0], [0]
    dispatch = api.GpuDecoder._dispatch_decode
    finish = api.GpuDecoder._finish_decode

    def counted_dispatch(self, chunk):
        with lock:
            count[0] += 1
            peak[0] = max(peak[0], count[0])
        return dispatch(self, chunk)

    def slow_finish(self, pending):
        time.sleep(delay)
        rgb = finish(self, pending)
        with lock:
            count[0] -= 1
        return rgb

    monkeypatch.setattr(api.GpuDecoder, "_dispatch_decode", counted_dispatch)
    monkeypatch.setattr(api.GpuDecoder, "_finish_decode", slow_finish)
    got = list(api.GpuDecoder(device="cpu").decode_many(chunks))
    return got, peak[0]


@pytest.mark.parametrize("case", ["yuv8", "yuv5d"])
def test_exception_overflow_with_a_lagging_convert_lane(monkeypatch, case):
    """A lossy YUV wire on every frame (exception capacity 2: EXC_K for
    the 8-bit wire, DEXC_K for the 5-bit-delta one, which a small DEXC_K
    makes the smaller) while the convert lane lags: each refetch reads the
    ring slot its frame wrote, which is held, not cloned, since at most
    two frames are in flight against RING = 4 slots. RGB stays cpuref's."""
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 255, (64, 64, 3)).astype(np.uint8)
              for _ in range(7)]
    chunks = _loop(api.GpuEncoder(device="cpu"), frames, 31)
    monkeypatch.setattr(twire, "EXC_K" if case == "yuv8" else "DEXC_K", 2)
    refetches = []
    exact = api.cpu_imaging.yuv420_to_rgb
    monkeypatch.setattr(api.cpu_imaging, "yuv420_to_rgb",
                        lambda *a: refetches.append(1) or exact(*a))
    probe = api.GpuDecoder(device="cpu")
    probe.decode(chunks[0])
    assert probe._out_fmt == case
    refetches.clear()
    got, peak = _lagging_decode(monkeypatch, chunks, 0.05)
    _assert_rgb(got, _cpuref_decode(chunks), "cpuref")
    assert len(refetches) > len(chunks) // 2  # most frames were lossy
    assert peak == 2


def test_lagging_convert_lane_keeps_two_frames_in_flight(monkeypatch):
    chunks = _loop(Evx1Encoder(), synth_frames(CW, CH, 6, seed=11), 16)
    got, peak = _lagging_decode(monkeypatch, chunks, 0.1)
    _assert_rgb(got, _cpuref_decode(chunks), "cpuref")
    assert peak == 2


def test_worker_error_propagates_from_encode_many(monkeypatch):
    """native.encode_slice raising on frame 3 (on the entropy worker)
    ends encode_many with that error after chunks 0-2."""
    calls = []
    encode_slice = tnative.encode_slice

    def failing(*a):
        calls.append(1)
        if len(calls) == 4:
            raise RuntimeError("entropy coder failed on frame 3")
        return encode_slice(*a)

    monkeypatch.setattr(tnative, "encode_slice", failing)
    for enc in (api.GpuEncoder(device="cpu"),
                api.ConformanceGpuEncoder(device="cpu")):
        calls.clear()
        got = []
        with pytest.raises(RuntimeError, match="frame 3"):
            for chunk in enc.encode_many(synth_frames(CW, CH, 6)):
                got.append(chunk)
        assert len(got) == 3


def test_errors_propagate_from_decode_many(monkeypatch):
    """An out-of-order chunk (main thread) and a converter that raises
    (convert lane) both end decode_many with their error."""
    chunks = _loop(api.GpuEncoder(device="cpu"), synth_frames(W, H, 5), 16)
    got = []
    with pytest.raises(ValueError, match="out-of-order"):
        for rgb in api.GpuDecoder(device="cpu").decode_many(
                chunks[:2] + chunks[3:]):
            got.append(rgb)
    assert len(got) == 1  # frame 1 was in flight when chunk 3 was parsed

    convert = tnative.yuv_wire_to_rgb
    calls = []

    def failing(*a):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("converter failed on frame 2")
        return convert(*a)

    monkeypatch.setattr(tnative, "yuv_wire_to_rgb", failing)
    got = []
    with pytest.raises(RuntimeError, match="frame 2"):
        for rgb in api.GpuDecoder(device="cpu").decode_many(chunks):
            got.append(rgb)
    assert len(got) == 2


@pytest.mark.parametrize("kind", ["fast", "conformance"])
def test_state_after_encode_many_equals_the_loop(kind):
    cls = api.GpuEncoder if kind == "fast" else api.ConformanceGpuEncoder
    frames = synth_frames(CW, CH, 5, seed=8)
    piped, loop = cls(device="cpu"), cls(device="cpu")
    assert _many(piped, frames, 20) == _loop(loop, frames, 20)
    (pm, pa), (lm, la) = piped.state_dict(), loop.state_dict()
    assert pm == lm and pa.keys() == la.keys()
    for k in pa:
        np.testing.assert_array_equal(pa[k], la[k], err_msg=k)
    if kind == "fast":  # the conformance encoder has no peek views
        np.testing.assert_array_equal(piped.peek_destination(),
                                      loop.peek_destination())
        np.testing.assert_array_equal(piped._coef_y, loop._coef_y)


def test_decoder_state_after_decode_many_equals_the_loop():
    chunks = _loop(Evx1Encoder(), synth_frames(CW, CH, 4, seed=8), 16)
    piped, loop = api.GpuDecoder(device="cpu"), api.GpuDecoder(device="cpu")
    _assert_rgb(list(piped.decode_many(chunks)),
                [loop.decode(c) for c in chunks], "loop")
    (pm, pa), (lm, la) = piped.state_dict(), loop.state_dict()
    assert pm == lm and pa.keys() == la.keys()
    for k in pa:
        np.testing.assert_array_equal(pa[k], la[k], err_msg=k)


def test_lanes_under_a_short_switch_interval():
    """The lanes share the encoder's host mirror and stale fields and the
    decoder's stats between threads; with the interpreter switching
    threads every microsecond, chunks and RGB stay the loop's."""
    import sys

    frames = synth_frames(W, H, 6, seed=9)
    want = _loop(api.GpuEncoder(device="cpu"), frames, 16)
    rgb = _port_loop(want)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(2):
            enc = api.GpuEncoder(device="cpu")
            assert _many(enc, frames, 16) == want
            dec = api.GpuDecoder(device="cpu")
            _assert_rgb(list(dec.decode_many(want)), rgb, "loop")
    finally:
        sys.setswitchinterval(interval)


def _wire(aw, ah, frame_index, quality, frame):
    fmt, buf = tnative.rgb_to_yuv5d(frame, aw, ah, frame_index, quality)
    return fmt, torch.from_numpy(buf)


@pytest.mark.parametrize("kind", ["fast", "conformance"])
def test_outputs_that_alias_state_stay_the_frames_own(kind):
    """The outputs a finish reads after the next step was enqueued are
    never written in place by it: encode_step returns the state's
    coefficient planes and conformance_encode_step also its stale
    q_index / variance, and the next step rebinds those keys. (The ring,
    written in place, is read through its slot: the decode tests above.)"""
    frames = synth_frames(CW, CH, 3, seed=4)
    aw, ah = api._align(CW), api._align(CH)
    mod = engine if kind == "fast" else wavefront
    state = mod.init_state(aw, ah, "cpu")
    kept = []
    for i, f in enumerate(frames):
        fmt, buf = _wire(aw, ah, i, 16, f)
        state, out = mod.encode_step(
            buf, state, aligned_w=aw, aligned_h=ah, frame_w=CW, frame_h=CH,
            is_inter=i > 0, src_fmt=fmt) if kind == "fast" else \
            mod.conformance_encode_step(
                buf, state, aligned_w=aw, aligned_h=ah, frame_w=CW,
                frame_h=CH, is_inter=i > 0, src_fmt=fmt)
        aliased = {k: v for k, v in out.items()
                   if any(v is s for s in state.values())}
        want = {"coef_y", "coef_u", "coef_v"} | (
            set() if kind == "fast" else {"q_index", "variance"})
        assert set(aliased) == want
        for tensors, copies in kept:
            for k, t in tensors.items():
                assert all(t is not s for s in state.values()), k
                torch.testing.assert_close(t, copies[k], rtol=0, atol=0)
        kept.append((aliased, {k: v.clone() for k, v in aliased.items()}))


def test_upload_copies_the_host_arrays():
    """A host plane rewritten after its upload (the parser rewrites the
    decoder's planes for the next chunk) does not reach the frame's
    step."""
    queue = pipeline.DeviceQueue(torch.device("cpu"))
    plane = np.arange(12, dtype=np.int16).reshape(3, 4)
    flags = np.array([True, False, True])
    up_plane, up_flags = queue.upload(plane, flags)
    plane[:] = -1
    flags[:] = False
    np.testing.assert_array_equal(up_plane.numpy(),
                                  np.arange(12).reshape(3, 4))
    assert up_flags.dtype == torch.bool
    assert up_flags.tolist() == [True, False, True]
    assert queue.mark() is None
    state = torch.zeros(4, dtype=torch.int16)
    host = queue.read(state)
    state += 1
    assert host.tolist() == [0, 0, 0, 0]


def test_chip_smoke_measures_the_pipelined_paths():
    """chip_smoke.py's phase-7 measuring function at 176x144 on the CPU:
    its keys, and the pipelined output equal to the loop's."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    frames = synth_frames(176, 144, 3, seed=6)
    for path in smoke.PIPELINE_PATHS:
        counts = {"k": 5}
        rec = smoke.measure_pipelined(api, frames, 1, path, device="cpu",
                                      counters=[counts])
        assert set(rec) == {f"{path}_{k}" for k in (
            "frames", "warm", "encode_fps", "encode_loop_fps", "decode_fps",
            "decode_loop_fps", "encode_stage_ms", "encode_loop_stage_ms",
            "decode_stage_ms", "decode_loop_stage_ms", "threads_ms",
            "loop_threads_ms", "stream_sha256",
            "rgb_sha256", "chunks_equal_loop", "rgb_equal_loop",
            "host_frames", "launches")}
        assert rec[f"{path}_chunks_equal_loop"]
        assert rec[f"{path}_rgb_equal_loop"]
        assert rec[f"{path}_host_frames"] == 0
        assert rec[f"{path}_launches"] == {"k": 0}  # no kernel on the CPU
        assert rec[f"{path}_encode_fps"] > 0 and rec[f"{path}_decode_fps"] > 0
        assert set(rec[f"{path}_encode_stage_ms"]) == {
            "dispatch", "fetch", "entropy"}
        assert set(rec[f"{path}_decode_stage_ms"]) == {
            "entropy", "dispatch", "device_and_fetch", "convert"}
        for key in ("threads_ms", "loop_threads_ms"):
            assert set(rec[f"{path}_{key}"]) == {
                f"{side}_{step}{cpu}" for side in ("encode", "decode")
                for step in ("dispatch", "finish") for cpu in ("", "_cpu")}
