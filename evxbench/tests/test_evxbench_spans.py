"""The readers of the program's span logs: each on a synthetic run whose
value is known by construction, silent on a program that keeps no span
log, and, with a session driven on the CPU, the program's spans on the
harness's own clock."""

import threading
import time

import pytest

import tiny  # noqa: F401  (puts the harness and the port on the path)
from cairo_tpu_torch.spans import SpanLog
from harness.cell import Run, _reader
from harness.sessions import Session

NEW = ("dispatch_cpu_ms", "launch_ms", "wait_cpu_pct", "idle_in_dispatch_pct",
       "copy_mb_per_frame", "hold_ms.live", "yield_lag_ms.live")


class _Enc:
    def __init__(self, records=()):
        self.spans = SpanLog()
        for r in records:
            self.spans._log.append(r)


class _Trace:
    t0, t1 = 8.0, 9.0

    def __init__(self, ops):
        self.ops = ops

    def intervals(self):
        return self.ops


def _session(enc):
    s = Session.__new__(Session)
    s.enc = enc
    s.due, s.done, s.handed, s.dispatch, s.finish = [], [], [], [], []
    return s


def _span(name, frame, start, end, cpu, parent=None):
    return (name, frame, parent, 1, start, end, cpu)


def _count(name, frame, at, value):
    return (name, frame, 1, at, value)


def _run():
    """Window 0-10 s, traced 8-9 s; session A dispatches at 1, 2 and (in
    the trace) 8.1 s, session B at 8.45 s."""
    a = _Enc([
        _span("encode.hold", 0, 0.50, 0.53, 0.0),
        _span("encode.hold", 1, 1.50, 1.54, 0.0),
        _span("encode.dispatch", 0, 1.0, 1.1, 0.08),
        _span("upload.slot_wait", 0, 1.0, 1.01, 0.009, "dispatch.upload"),
        _span("dispatch.step", 0, 1.01, 1.09, 0.07, "encode.dispatch"),
        _span("finish.fetch", 0, 1.2, 1.25, 0.001, "encode.finish"),
        _span("encode.yield_lag", 0, 1.30, 1.31, None),
        _span("encode.dispatch", 1, 2.0, 2.2, 0.12),
        _span("dispatch.step", 1, 2.01, 2.15, 0.12, "encode.dispatch"),
        _span("encode.yield_lag", 1, 2.30, 2.33, None),
        _span("encode.dispatch", 2, 8.1, 8.5, 0.40),
        _span("dispatch.step", 2, 8.1, 8.45, 0.35, "encode.dispatch"),
        _span("finish.fetch", 2, 8.6, 8.9, 0.3, "encode.finish"),
        _span("encode.hold", 2, 8.05, 8.1, 0.0),
        _count("bytes.upload", 0, 1.0, 2_000_000),
        _count("bytes.download", 0, 1.1, 6_000_000),
        _count("bytes.upload", 1, 2.0, 2_000_000),
        _count("bytes.download", 1, 2.1, 6_000_000),
        _count("bytes.download", 1, 2.3, 400_000),
        _count("bytes.upload", 2, 8.1, 9_000_000),
        # frame 3: its upload before the window, its download in it
        _count("bytes.upload", 3, -0.1, 5_000_000),
        _count("bytes.download", 3, 0.1, 5_000_000),
        # frame 4: its upload before the trace, its download in it
        _count("bytes.upload", 4, 7.9, 2_000_000),
        _count("bytes.download", 4, 8.1, 6_000_000),
    ])
    b = _Enc([
        _span("encode.dispatch", 0, 8.45, 8.55, 0.09),
        _count("bytes.upload", 0, 8.45, 9_000_000),
    ])
    # device busy 8.0-8.2 and 8.6-8.8: idle 8.2-8.6 (dispatch from 8.2 to
    # 8.55) and 8.8-9.0 (no session dispatching)
    trace = _Trace([(8.0, 8.2), (8.6, 8.8)])
    return Run(64, 48, [_session(a), _session(b)], 0.0, 10.0, 1.0, trace)


@pytest.mark.parametrize("name,value", [
    ("dispatch_cpu_ms", 100.0),            # (80 + 120) / 2
    ("launch_ms", 110.0),                  # (80 + 140) / 2
    ("wait_cpu_pct", 100 * 0.010 / 0.060),
    ("idle_in_dispatch_pct", 100 * 0.35 / 0.6),
    ("copy_mb_per_frame", 24.4 / 3),       # frames 0, 1 and 4
    ("hold_ms.live", 35.0),
    ("yield_lag_ms.live", 20.0),
])
def test_reader_on_a_synthetic_run(name, value):
    assert _reader("layer_metrics", name)(_run()) == pytest.approx(value)


@pytest.mark.parametrize("name", NEW)
def test_reader_silent_without_span_logs(name):
    """A program that keeps no span log (the encoder has no `spans`)."""
    run = _run()
    for s in run.sessions:
        s.enc = object()
    assert _reader("layer_metrics", name)(run) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_silent_on_an_empty_log(name):
    run = _run()
    for s in run.sessions:
        s.enc = _Enc()
    assert _reader("layer_metrics", name)(run) is None


def test_idle_in_dispatch_needs_the_trace():
    run = _run()
    run.trace = None
    assert _reader("layer_metrics", "idle_in_dispatch_pct")(run) is None


def test_spans_on_the_harness_clock():
    """A session driven by the harness, open loop at 3 frames/s for 2 s on
    the CPU: the harness's wrapper of each dispatch and finish encloses the
    program's span, and along each frame the two sets of stamps fall in
    order on the one clock."""
    from cairo_tpu_torch.gpu import api
    from cairo_tpu_torch.synth import synth_frames

    enc = api.ConformanceGpuEncoder(device="cpu")
    enc.set_quality(16)
    session = Session(0, enc, synth_frames(64, 48, 8, seed=2), 0)
    stop = threading.Event()
    first_due = time.perf_counter() + 0.01
    thread = session.start(session.frames(stop, 1 / 3, first_due))
    time.sleep(2.0)
    stop.set()
    thread.join(60)
    assert not thread.is_alive() and session.error is None
    n = len(session.done)
    assert n >= 3 and n == len(session.handed)

    def one(name):
        spans = sorted(enc.spans.spans(name), key=lambda s: s.frame)
        assert [s.frame for s in spans] == list(range(n)), name
        return spans

    hold, disp, fin, lag = (one(k) for k in (
        "encode.hold", "encode.dispatch", "encode.finish",
        "encode.yield_lag"))
    for k in range(n):
        (a, b), d = session.dispatch[k], disp[k]
        assert a <= d.start < d.end <= b
        (a, b), f = session.finish[k], fin[k]
        assert a <= f.start < f.end <= b
    for k in range(n - 1):
        assert (session.handed[k] <= hold[k].start <= hold[k].end
                <= disp[k].start < disp[k].end <= fin[k].start
                < fin[k].end == lag[k].start <= lag[k].end
                <= session.done[k])


def test_readers_on_a_run_of_the_program(tmp_path):
    """A whole open-loop run on the CPU with the per-layer metrics read
    (no device trace there, so idle_in_dispatch_pct stays out): every
    other reader finds the program's spans, and the copies are the source
    wire (8-bit at 64x48, 4,616 bytes packed to 4,624) and the step's
    outputs (9,360 bytes: the block table and the coefficient planes)."""
    from harness import cell as cell_mod

    spec = tiny.write_spec(tmp_path, sessions=1, rate=3)
    result = cell_mod.run_cell("conformance.open", 2**31 + 11, 2.0, True,
                               device="cpu", spec_path=spec,
                               traffic_dir=tmp_path, log=lambda msg: None)
    assert result["correct"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(NEW) - set(got) == {"idle_in_dispatch_pct"}
    assert got["copy_mb_per_frame"] == pytest.approx((4624 + 9360) / 1e6)
    assert 0 < got["launch_ms"] and 0 < got["dispatch_cpu_ms"]
    assert 0 <= got["wait_cpu_pct"] and 0 < got["hold_ms.live"]
    assert 0 <= got["yield_lag_ms.live"]
