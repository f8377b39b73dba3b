"""cairo_tpu_torch's ConformanceGpuEncoder on the CPU against
cairo_tpu's ConformanceTpuEncoder and the numpy reference encoder
(cpuref.Evx1Encoder): identical chunks over an IP GOP, quality changes
mid-stream, an inserted intra frame, noise-free content full of copy
blocks and a size that is not a multiple of 16; a ConformanceTpuEncoder
checkpoint resumes in the port with identical bytes."""

import pytest

from cairo_tpu import checkpoint as jcheckpoint
from cairo_tpu.cpuref.api import Evx1Encoder
from cairo_tpu.tpu.api import ConformanceTpuEncoder
from cairo_tpu_torch import ConformanceGpuEncoder
from cairo_tpu_torch import checkpoint as tcheckpoint

from util_video import synth_frames

CASES = {
    "ip_gop": dict(size=(64, 48), frames=4),
    "quality_changes": dict(size=(64, 48), frames=5, quality=1,
                            quality_at={2: 31, 3: 8}),
    "insert_intra": dict(size=(64, 48), frames=5, insert_intra_at={3}),
    "noise_free_copy_blocks": dict(size=(64, 48), frames=5, noise=0,
                                   flat_from=16),
    "non_aligned": dict(size=(72, 40), frames=3),
}


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


@pytest.fixture(scope="module")
def streams():
    """Per case: the frames and the chunks of the two reference encoders
    (the JAX one compiles once per frame geometry and kind)."""
    out = {}
    for name, case in CASES.items():
        case = dict(case)
        w, h = case.pop("size")
        frames = synth_frames(w, h, case.pop("frames"),
                              noise=case.pop("noise", 4))
        flat_from = case.pop("flat_from", None)
        if flat_from is not None:   # a flat area: copy blocks of all kinds
            for f in frames:
                f[:, flat_from:] = (120, 100, 140)
        out[name] = (frames, case, _encode(Evx1Encoder(), frames, **case),
                     _encode(ConformanceTpuEncoder(), frames, **case))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_chunks_match_references(streams, name):
    frames, case, cpuref_chunks, tpu_chunks = streams[name]
    assert cpuref_chunks == tpu_chunks
    enc = ConformanceGpuEncoder(device="cpu")
    for t, (got, want) in enumerate(zip(_encode(enc, frames, **case),
                                        cpuref_chunks)):
        assert got == want, f"frame {t}: stream bytes diverge"
    if name == "noise_free_copy_blocks":
        bt = enc.last_stats["block_types"]
        assert bt["INTER_COPY"] and bt["INTRA_MOTION_COPY"]


def test_many_matches_single(streams):
    frames, _, cpuref_chunks, _ = streams["ip_gop"]
    enc = ConformanceGpuEncoder(device="cpu")
    enc.set_quality(16)
    assert list(enc.encode_many(frames)) == cpuref_chunks


def test_tpu_checkpoint_resumes_in_port():
    frames = synth_frames(64, 48, 5, seed=11)
    ref = ConformanceTpuEncoder()
    ref.set_quality(12)
    for f in frames[:3]:
        ref.encode(f)
    port = tcheckpoint.load_state(ConformanceGpuEncoder(device="cpu"),
                                  jcheckpoint.dump_state(ref))
    for t, f in enumerate(frames[3:]):
        assert port.encode(f) == ref.encode(f), f"frame {3 + t}"
    # and the port's own checkpoint resumes the same stream
    again = tcheckpoint.load_state(ConformanceGpuEncoder(device="cpu"),
                                   tcheckpoint.dump_state(port))
    more = synth_frames(64, 48, 7, seed=11)[5:]
    for f in more:
        assert again.encode(f) == ref.encode(f)


def test_default_device_needs_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConformanceGpuEncoder()
