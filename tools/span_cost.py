#!/usr/bin/env python3
"""Host time that the span log (src/cairo_tpu_torch/spans.py) costs one
encoded frame, on this machine's CPU.

    python3 tools/span_cost.py [--frames N] [--repeats R]

Encodes three small frames with ConformanceGpuEncoder and GpuEncoder on
the CPU through encode_many, takes what the middle frame recorded (its
spans with and without CPU time, and counters), then replays that many
recording calls on one thread for N frames, R times: a stamp and a span
per span (an upper bound: the lanes chain some spans from the last one's
end stamp), a counter per counter. Prints one
JSON line per encoder: the calls a frame makes (and the thread_time
reads a frame makes in the lanes), the median, over the
repeats, of us a frame with the log recording and with a log that
records nothing (the calls alone), and the log's bound in records.
Needs no CUDA card."""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def frame_calls(enc_cls, frames) -> dict:
    """The recording calls of the middle frame under encode_many, and the
    thread_time reads of all three frames."""
    from cairo_tpu_torch import spans as spans_mod

    reads = []
    cpu = spans_mod._cpu
    spans_mod._cpu = lambda: reads.append(1) or cpu()
    try:
        enc = enc_cls(device="cpu")
        list(enc.encode_many(frames))
    finally:
        spans_mod._cpu = cpu
    spans = [s for s in enc.spans.spans() if s.frame == 1]
    return dict(cpu_spans=sum(1 for s in spans if s.cpu is not None),
                wall_spans=sum(1 for s in spans if s.cpu is None),
                counts=sum(1 for c in enc.spans.counts() if c.frame == 1),
                thread_time_reads=len(reads) / len(frames))


def us_per_frame(log_cls, calls: dict, n: int) -> float:
    log = log_cls()
    t0 = time.perf_counter()
    for frame in range(n):
        for _ in range(calls["cpu_spans"]):
            log.span("encode.dispatch", frame, None, log.stamp(cpu=True))
        for _ in range(calls["wall_spans"]):
            log.span("encode.hold", frame, None, log.stamp())
        for _ in range(calls["counts"]):
            log.count("bytes.upload", frame, 1)
    return (time.perf_counter() - t0) / n * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=20000)
    ap.add_argument("--repeats", type=int, default=7)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from cairo_tpu_torch import spans as spans_mod
    from cairo_tpu_torch.gpu import api
    from cairo_tpu_torch.synth import synth_frames

    frames = synth_frames(64, 48, 3, seed=1)
    for enc_cls in (api.ConformanceGpuEncoder, api.GpuEncoder):
        calls = frame_calls(enc_cls, frames)
        row = dict(encoder=enc_cls.__name__, calls=calls,
                   bound_records=spans_mod.FRAMES
                   * spans_mod.RECORDS_PER_FRAME)
        for key, cls in (("us_per_frame", spans_mod.SpanLog),
                         ("us_per_frame_null", spans_mod.NullLog)):
            row[key] = round(statistics.median(
                us_per_frame(cls, calls, args.frames)
                for _ in range(args.repeats)), 3)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
