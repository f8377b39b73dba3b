"""One run of one cell: set-up, the measured window, the metrics, the
check of what the window produced.

Everything about a cell is found by name: its entry in BENCHMARK.json
names a configuration (its file, given there) and a traffic mix
(evxbench/traffic/<mix>.json); each metric is read by
evxbench/end_to_end/<name>.py or evxbench/layer_metrics/<name>.py.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import struct
import sys
import threading
import time
from pathlib import Path

import numpy as np

from . import check, frames, stats
from .sessions import Session

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cairo_tpu")
DRAIN_S = 60.0       # how long a frame due in the window is waited for
JOIN_S = 120.0
# the traced stretch: TRACE_S seconds (at most half the window), ending
# TRACE_TAIL_S before the window does. The profiler slows the host's
# lanes (a live session falls seconds behind while traced), so the
# per-layer metrics read from the host's clock take the window before it.
TRACE_S = 5.0
TRACE_TAIL_S = 1.0


def load_cell(name: str, spec_path: Path | None = None,
              traffic_dir: Path | None = None) -> dict:
    """The cell's entry, configuration, mix and metrics, by name."""
    spec = json.loads((spec_path or ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    mix = json.loads((traffic_dir or BENCH_DIR / "traffic")
                     .joinpath(f"{cell['traffic']}.json").read_text())

    def for_cell(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return dict(cell=cell, config=config, mix=mix,
                end_to_end=for_cell(spec["end_to_end"]),
                per_layer=for_cell(spec["per_layer"]))


def _reader(kind: str, name: str):
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{kind}_{name}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What one run recorded, as the metric readers see it."""

    def __init__(self, width, height, sessions, t0, seconds, setup_s, trace):
        self.width, self.height = width, height
        self.sessions = sessions
        self.t0, self.seconds = t0, seconds
        self.setup_s = setup_s
        self.trace = trace

    def in_window(self, t: float) -> bool:
        return self.t0 <= t <= self.t0 + self.seconds

    def untraced(self, t: float) -> bool:
        """In the window, and before the traced stretch if there is one."""
        end = self.t0 + self.seconds if self.trace is None else self.trace.t0
        return self.t0 <= t <= end

    def latencies(self):
        """Due-to-chunk seconds of the frames due in the window (before the
        traced stretch, if any), and how many of them never got a chunk."""
        end = self.t0 + self.seconds if self.trace is None else self.trace.t0
        lat, missing = [], 0
        for s in self.sessions:
            done = s.done + [None] * (len(s.due) - len(s.done))
            got, miss = stats.latencies(s.due, done, self.t0, end - self.t0)
            lat += got
            missing += miss
        return lat, missing


def make_encoder(config: dict, device: str):
    from cairo_tpu_torch.config import CONFORMANCE, CodecConfig
    from cairo_tpu_torch.gpu import api

    codec = CodecConfig(**config["codec"])
    if config["path"] == "conformance":
        if codec != CONFORMANCE:
            raise ValueError("the conformance encoder runs the reference's "
                             "defaults only; the configuration states others")
        enc = api.ConformanceGpuEncoder(device=device)
    elif config["path"] == "fast":
        enc = api.GpuEncoder(config=codec, device=device)
    else:
        raise ValueError(f"unknown path {config['path']!r}")
    enc.set_quality(config["quality"])
    return enc


def stream_errors(session: Session, quality: int) -> int:
    """Chunks whose frame descriptor is not the next frame of the stream:
    type (intra first, then inter), index, quality."""
    errors = 0
    for k, chunk in enumerate(session.chunks):
        off = check.stream.HEADER_SIZE if k == 0 else 0
        try:
            got = struct.unpack(check.stream._FRAME_FMT,
                                chunk[off:off + check.stream.FRAME_DESC_SIZE])
        except struct.error:
            errors += 1
            continue
        errors += got != (0 if k == 0 else 1, k, quality)
    return errors


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             spec_path: Path | None = None, traffic_dir: Path | None = None,
             log=print) -> dict:
    """Runs the cell once; returns the result line's object."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_cell(name, spec_path, traffic_dir)
    config, mix = spec["config"], spec["mix"]
    width, height = config["width"], config["height"]
    n_sessions, warm = int(mix["sessions"]), int(mix["warmup_frames"])
    rate = mix.get("frames_per_s")
    rng = np.random.default_rng(seed)
    cuda = device == "cuda"

    marks = [("start", time.perf_counter())]
    ring = frames.make_ring(width, height,
                            frames.ring_length(mix, width, height),
                            mix["content"])
    marks.append(("ring", time.perf_counter()))
    offsets = frames.session_offsets(len(ring), n_sessions, rng)
    sessions = [Session(s, make_encoder(config, device), ring, offsets[s])
                for s in range(n_sessions)]
    marks.append(("encoders", time.perf_counter()))
    probed = int(rng.integers(n_sessions))
    start_probe = check.Probe(0.0, first=True)
    sessions[probed].probe = start_probe
    never = threading.Event()
    for s in sessions:
        s.run(s.frames(never, count=warm))
        if s.error:
            raise RuntimeError(f"session {s.index} warm-up:\n{s.error}")
    if cuda:
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))
    log("set-up: " + ", ".join(
        f"{name} {b - a:.2f} s" for (_, a), (name, b) in zip(
            [("process", t_start)] + marks[:-1], marks)))

    # the window: one frame of every session is copied for the check
    window_probes = [check.Probe(0.0) for _ in sessions]
    for s, probe in zip(sessions, window_probes):
        s.probe = probe
    tracer = None
    if trace and cuda:
        from .trace import DeviceTrace
        tracer = DeviceTrace()
        tracer.enter()
    stop = threading.Event()
    t0 = time.perf_counter() + 0.01
    setup_s = t0 - t_start
    for probe in window_probes:
        probe.at = t0 + seconds * float(rng.uniform(0.25, 0.75))
    period = None if rate is None else 1.0 / float(rate)
    threads = []
    for s in sessions:
        first_due = None if period is None else \
            t0 + period * s.index / n_sessions
        threads.append(s.start(s.frames(stop, period, first_due)))
    if tracer is not None:
        span = min(TRACE_S, seconds / 2)
        lead = max(0.0, seconds - TRACE_TAIL_S - span)
        _sleep_until(t0 + lead)
        tracer.begin()
        _sleep_until(t0 + lead + span)
        tracer.end()
    t_end = t0 + seconds
    _sleep_until(t_end)
    if period is None:
        stop.set()
    else:
        # every frame due in the window gets its chunk, up to DRAIN_S late
        deadline = t_end + DRAIN_S
        owed = [int((t_end - (t0 + period * s.index / n_sessions))
                    // period) + 1 for s in sessions]
        while time.perf_counter() < deadline and any(
                len(s.done) - warm < k for s, k in zip(sessions, owed)
                if s.error is None):
            time.sleep(0.01)
        stop.set()
    for th in threads:
        th.join(JOIN_S)
    alive = [th.name for th in threads if th.is_alive()]
    if alive:
        raise RuntimeError(f"sessions still running: {alive}")

    run = Run(width, height, sessions, t0, seconds, setup_s, tracer)
    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        value = _reader("layer_metrics" if trace else "end_to_end",
                        m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = dict(correct=False, attempted=0, failed=0, metrics=metrics)
    in_window = [sum(1 for h in s.handed if run.in_window(h))
                 for s in sessions]
    result["attempted"] = int(sum(in_window))
    missing = sum(len(s.due) - len(s.done) for s in sessions)
    errors = [s.error for s in sessions if s.error]
    result["failed"] = int(missing + len(errors))

    device_info = dict(platform="gpu" if cuda else "cpu",
                       kind=torch.cuda.get_device_name(0) if cuda else "cpu",
                       count=1,
                       memory_peak_bytes=int(torch.cuda.max_memory_allocated())
                       if cuda else 0)
    if cuda:
        device_info["card"] = power_limit()
    if tracer is not None:
        if not tracer.ops:
            raise RuntimeError("the device trace holds no operation")
        device_info.update(busy_s=tracer.busy_s(), window_s=tracer.window_s)
        result["breakdown"] = dict(device_ops=tracer.top_ops(),
                                   idle_gaps=tracer.top_gaps(sessions))
    result["device"] = device_info

    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        raise ImportError(f"modules loaded in the run: {found}")

    # the check, once the program's state is freed
    # the probed session's first frame and, with the encoder's work, its
    # window frame; every other session's window frame without it
    checked = [(probed, 0, *start_probe.host(), True)]
    checked += [(s.index, probe.frame, *probe.host(), s.index == probed)
                for s, probe in zip(sessions, window_probes)]
    for ses in sessions:
        ses.enc = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    counts = dict(sessions_failed=len(errors), frames_missing=missing,
                  stream_order=sum(stream_errors(x, config["quality"])
                                   for x in sessions))
    for index, k, p_pre, p_post, deep in checked:
        s = sessions[index]
        if k is None or p_post is None or k >= len(s.chunks):
            counts["frames_missing"] += 1
            continue
        got = check.check_frame(config["path"], s.chunks[k], k,
                                config["quality"], ring[s.ring_index[k]],
                                p_pre, p_post, config["codec"], rng,
                                decisions=deep)
        for key, v in got.items():
            if key != "parse_error":
                counts[key] = counts.get(key, 0) + int(v)
            else:
                log(f"session {index} frame {k}: the reference could not "
                    f"parse it: {v}")
    log("check: " + ", ".join(
        f"session {index} frame {k}{' with decisions' if deep else ''}"
        for index, k, _, _, deep in checked)
        + f", {time.perf_counter() - t_check:.1f} s")
    limits = {k: 0 for k in counts}
    result["correct"] = all(counts[k] <= limits[k] for k in counts) \
        and not errors
    result["checks"] = {k: {"value": counts[k], "limit": limits[k]}
                        for k in counts}
    if errors:
        log("session errors:\n" + "\n".join(errors))
    return result


def _sleep_until(t: float):
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def check_lines(result: dict) -> list[str]:
    """The numbers compared, each beside its limit, one to a line."""
    return [f"check {k}: {v['value']} (limit {v['limit']})"
            for k, v in result.get("checks", {}).items()]


def power_limit():
    """The card's name and power limit as nvidia-smi reads them, or None."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return None
