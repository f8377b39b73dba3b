"""The span log of the port's encode and decode lanes (spans.py,
gpu/pipeline.py, gpu/api.py), device="cpu", small frames: each frame's
spans, once each, children inside their parents on their thread, CPU time
within wall time, last_stats["stage_ms"] read from the spans, the log's
bound, its byte counters, and chunks unchanged by recording."""

import numpy as np
import pytest

from cairo_tpu_torch import spans as spans_mod
from cairo_tpu_torch.gpu import api, pipeline
from cairo_tpu_torch.spans import NullLog, SpanLog

from util_video import synth_frames

W, H = 64, 48
N = 4
CPU_SLACK_S = 50e-6  # the two clocks of a stamp are read one after the other

DISPATCH = {"encode.dispatch", "dispatch.upload", "upload.slot_wait",
            "dispatch.step", "dispatch.download"}
FINISH = {"encode.finish", "finish.fetch", "finish.entropy", "finish.stats"}
PIPELINE = {"encode.hold", "encode.chunk_wait", "encode.yield_lag"}
AHEAD = {"encode.wire_wait", "encode.convert_ahead"}
# the spans that read their thread's CPU time (a system call)
CPU = {"encode.dispatch", "upload.slot_wait", "encode.finish",
       "finish.fetch"}


def _encoder(kind):
    if kind == "fast":
        return api.GpuEncoder(device="cpu")
    return api.ConformanceGpuEncoder(device="cpu")


def _run(enc, frames, mode):
    """Chunks and each frame's last_stats["stage_ms"]."""
    chunks, stages = [], []
    items = enc.encode_many(frames) if mode == "many" else (
        enc.encode(f) for f in frames)
    for chunk in items:
        chunks.append(chunk)
        stages.append(enc.last_stats["stage_ms"])
    return chunks, stages


def _by_frame(log):
    out = {}
    for s in log.spans():
        out.setdefault(s.frame, {}).setdefault(s.name, []).append(s)
    return out


def _expected(frame, first, mode):
    """The spans frame `frame` records; `first`: the first frame of the
    call, for which no wire came ahead."""
    names = DISPATCH | FINISH
    if mode == "loop":
        return names | {"dispatch.convert"}
    names |= PIPELINE
    return names | ({"dispatch.convert"} if frame == first else AHEAD)


@pytest.fixture(scope="module")
def frames():
    return synth_frames(W, H, 2 * N, seed=3)


@pytest.mark.parametrize("mode", ["many", "loop"])
@pytest.mark.parametrize("kind", ["fast", "conformance"])
def test_each_frame_records_each_span_once(kind, mode, frames):
    enc = _encoder(kind)
    # a second call to encode_many starts without a wire converted ahead
    _run(enc, frames[:N], mode)
    _run(enc, frames[N:], mode)
    by_frame = _by_frame(enc.spans)
    assert sorted(by_frame) == list(range(2 * N))
    for frame, named in by_frame.items():
        first = 0 if frame < N else N
        assert set(named) == _expected(frame, first, mode), frame
        assert all(len(v) == 1 for v in named.values()), frame


@pytest.mark.parametrize("mode", ["many", "loop"])
@pytest.mark.parametrize("kind", ["fast", "conformance"])
def test_children_lie_inside_their_parent_on_its_thread(kind, mode, frames):
    enc = _encoder(kind)
    _run(enc, frames[:N], mode)
    by_frame = _by_frame(enc.spans)
    checked = 0
    for named in by_frame.values():
        for group in named.values():
            for s in group:
                if s.parent is None:
                    continue
                (parent,) = named[s.parent]
                assert parent.start <= s.start <= s.end <= parent.end, s
                assert s.thread == parent.thread, s
                checked += 1
    assert checked >= N * 7


@pytest.mark.parametrize("kind", ["fast", "conformance"])
def test_cpu_time_within_wall_time(kind, frames):
    enc = _encoder(kind)
    _run(enc, frames[:N], "many")
    spans = enc.spans.spans()
    for s in spans:
        assert s.end >= s.start, s
        if s.name in CPU:
            assert 0 <= s.cpu <= s.end - s.start + CPU_SLACK_S, s
        else:
            assert s.cpu is None, s
    assert CPU <= {s.name for s in spans}
    # the main thread's spans and the workers' are on their own threads
    threads = {s.name: s.thread for s in spans}
    assert threads["encode.finish"] != threads["encode.dispatch"]
    assert threads["encode.convert_ahead"] != threads["encode.dispatch"]
    assert threads["encode.hold"] == threads["encode.dispatch"]


@pytest.mark.parametrize("mode", ["many", "loop"])
@pytest.mark.parametrize("kind", ["fast", "conformance"])
def test_stage_ms_is_the_spans_wall_ms(kind, mode, frames):
    enc = _encoder(kind)
    _, stages = _run(enc, frames[:N], mode)
    by_frame = _by_frame(enc.spans)

    def ms(frame, name):
        (s,) = by_frame[frame][name]
        return round((s.end - s.start) * 1e3, 3)

    for frame, stage in enumerate(stages):
        assert stage == {"dispatch": ms(frame, "encode.dispatch"),
                         "fetch": ms(frame, "finish.fetch"),
                         "entropy": ms(frame, "finish.entropy")}


def test_ordering_along_one_frame(frames):
    """On the one clock: hold, dispatch, finish, then the yield lag from
    the finish's end; a frame's chunk wait is on the main thread."""
    enc = _encoder("conformance")
    _run(enc, frames[:N], "many")
    by_frame = _by_frame(enc.spans)
    for frame in range(N):
        (hold,), (disp,), (fin,), (lag,) = (
            by_frame[frame][k] for k in ("encode.hold", "encode.dispatch",
                                         "encode.finish", "encode.yield_lag"))
        assert hold.end <= disp.start < disp.end <= fin.start < fin.end
        assert lag.start == fin.end <= lag.end
        (wait,) = by_frame[frame]["encode.chunk_wait"]
        assert wait.thread == disp.thread and wait.end <= lag.end


@pytest.mark.parametrize("kind", ["fast", "conformance"])
def test_log_stays_at_its_bound(kind, frames, monkeypatch):
    enc = _encoder(kind)
    _run(enc, frames[:N], "many")
    per_frame = {}
    for r in enc.spans.records():
        per_frame[r[1]] = per_frame.get(r[1], 0) + 1
    # so FRAMES frames fit in the bound whatever a frame records
    assert max(per_frame.values()) <= spans_mod.RECORDS_PER_FRAME

    monkeypatch.setattr(spans_mod, "FRAMES", 2)
    enc = _encoder(kind)
    _run(enc, frames, "many")
    assert len(enc.spans) == 2 * spans_mod.RECORDS_PER_FRAME
    by_frame = _by_frame(enc.spans)
    last = len(frames) - 1
    assert set(by_frame[last]) >= DISPATCH | FINISH | PIPELINE
    assert min(by_frame) > 0  # the oldest frames are gone


@pytest.mark.parametrize("kind", ["fast", "conformance"])
def test_chunks_unchanged_by_recording(kind, frames, monkeypatch):
    recorded, _ = _run(_encoder(kind), frames[:N], "many")
    for name in ("stamp", "span", "join", "count"):
        monkeypatch.setattr(SpanLog, name, getattr(NullLog, name))
    enc = _encoder(kind)
    silent, _ = _run(enc, frames[:N], "many")
    assert len(enc.spans) == 0
    assert silent == recorded
    looped, _ = _run(_encoder(kind), frames[:N], "loop")
    assert looped == recorded


def test_byte_counters_are_the_copies():
    """bytes.upload: the source wire as packed (16-byte aligned);
    bytes.download: every output tensor of the conformance step."""
    frames = synth_frames(W, H, 2, seed=5)
    enc = _encoder("conformance")
    list(enc.encode_many(frames))
    counts = enc.spans.counts()
    assert [(c.name, c.frame) for c in counts] == [
        ("bytes.upload", 0), ("bytes.download", 0),
        ("bytes.upload", 1), ("bytes.download", 1)]
    _, buf = api.native.rgb_to_yuv5d(frames[1], W, H, 1, enc.quality)
    assert counts[2].value == -(-buf.nbytes // pipeline.ALIGN) * pipeline.ALIGN
    n_mb = (W // 16) * (H // 16)
    # the block table's nine fields (motion and variance int16), int16
    # coefficient planes
    table = n_mb * (1 + 1 + 2 + 2 + 1 + 1 + 1 + 1 + 2)
    planes = 2 * (W * H + 2 * (W // 2) * (H // 2))
    assert counts[3].value == table + planes


def test_tiled_queues_record_nothing():
    q = pipeline.DeviceQueue(api.resolve_device("cpu"))
    q.upload(np.zeros(5, np.uint8), frame=0)
    assert isinstance(q.spans, NullLog) and len(q.spans) == 0


def test_decoder_stage_ms_from_its_spans(frames):
    enc = _encoder("conformance")
    chunks = list(enc.encode_many(frames[:N]))
    dec = api.GpuDecoder(device="cpu")
    stages = []
    for _ in dec.decode_many(chunks):
        stages.append(dec.last_stats["stage_ms"])
    by_frame = _by_frame(dec.spans)
    for frame, stage in enumerate(stages):
        named = {k: v[0] for k, v in by_frame[frame].items()}
        assert set(named) == {"decode.dispatch", "dispatch.entropy",
                              "decode.fetch", "decode.convert"}
        ent, disp = named["dispatch.entropy"], named["decode.dispatch"]
        fetch, conv = named["decode.fetch"], named["decode.convert"]
        assert stage == {
            "entropy": (ent.end - ent.start) * 1e3,
            "dispatch": (disp.end - ent.end) * 1e3,
            "device_and_fetch": (fetch.end - disp.end) * 1e3,
            "convert": (conv.end - fetch.end) * 1e3}
        assert disp.start <= ent.start <= ent.end <= disp.end
        assert ent.thread == disp.thread != fetch.thread
        assert ent.cpu is None
        for s in (disp, fetch, conv):
            assert 0 <= s.cpu <= s.end - s.start + CPU_SLACK_S, s
