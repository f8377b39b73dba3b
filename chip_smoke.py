#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (src/cairo_tpu_torch) end to end on one CUDA
card and checks it.

    python3 chip_smoke.py

Phases, one line each with the elapsed seconds:
  0. a watchdog (a hang ends in a traceback and a non-zero exit), the
     card's name and power limit, the torch and CUDA versions; with no
     CUDA device the script exits non-zero at once;
  1. build: the CUDA kernels (nvcc, sm_90a) and the native C++ library
     (g++) from the sources in the checkout;
  2. kernels: K1-K4 against their plain PyTorch versions at the 1080p
     shapes of the main path, plus edge cases (tile origin x0, copy-grade
     shifts, flat planes that force ties, recon overshoot beyond 0..255);
     exact equality; CUDA-event times;
  3. main path: GpuEncoder + GpuDecoder over 1 intra + 4 inter synthetic
     1920x1080 frames at q16; every decoded frame must equal the encoder's
     reconstruction and the native sequential C++ decoder's output, no
     frame may take the host decode path, and every kernel must have been
     launched;
  4. CPU against card: 3 frames at 176x144 encoded with device="cpu" and
     on the card give byte-identical chunks.
The line before the last is a JSON object with each kernel's launches,
error and times; the last line is the contract line
{"ok": true, "device": {...}}. Any failed check exits non-zero.

    python3 chip_smoke.py --profile

runs phases 0-1 and then a torch.profiler trace of one 1080p inter frame
through GpuEncoder and GpuDecoder, with one labelled range per pipeline
stage: host and device milliseconds per stage, K1-K4's device time by
kernel name, and all kernels' device time against the unprofiled wall
time of the same work (busy share).
"""

from __future__ import annotations

import faulthandler
import json
import os
import struct
import subprocess
import sys
import time

WATCHDOG_S = 600
SEED = 20261017
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT_OPS_PER_S = 33.5e12        # one simple op per CUDA-core lane per clock
                               # (the 67 TFLOP/s float32 rate counts 2/FMA)
T0 = time.perf_counter()


def log(msg):
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def cuda_ms(torch, fn, reps):
    """Median CUDA-event time of fn() in ms, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def compare(torch, name, got, want):
    """Exact equality of two tensors or tuples of tensors; returns the
    largest absolute difference (0)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{name}[{i}]: {tuple(g.shape)} {g.dtype} vs "
                 f"{tuple(w.shape)} {w.dtype}")
        diff = (g.long() - w.long()).abs()
        e = int(diff.max()) if diff.numel() else 0
        if e:
            idx = int(diff.reshape(-1).argmax())
            fail(f"{name}[{i}]: kernel differs from the plain version "
                 f"(max abs err {e} at flat index {idx})")
        err = max(err, e)
    return err


def phase_kernels(torch, np, gpu):
    """K1-K4 against their plain versions; returns per-kernel records."""
    cm, cp = gpu["cuda_motion"], gpu["cuda_pred"]
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    H, W = 1088, 1920
    hb, wb = H // 16, W // 16
    n = hb * wb

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev, dtype)

    # main-path-like inputs: source planes in 0..271, ring planes with
    # recon overshoot beyond 0..255
    src_y = t(rng.integers(16, 272, (H, W)), torch.int32)
    src_u = t(rng.integers(0, 256, (H // 2, W // 2)), torch.int32)
    src_v = t(rng.integers(0, 256, (H // 2, W // 2)), torch.int32)
    ring_y = t(rng.integers(-300, 560, (4, H, W)), torch.int16)
    ring_u = t(rng.integers(-300, 560, (4, H // 2, W // 2)), torch.int16)
    ring_v = t(rng.integers(-300, 560, (4, H // 2, W // 2)), torch.int16)
    slot = torch.tensor([2], dtype=torch.int32, device=dev)
    thr = torch.tensor(5, dtype=torch.int32, device=dev)  # q16: (16>>2)+1
    recs = {}

    def check(name, kern, plain, label):
        out = kern()
        torch.cuda.synchronize()
        err = compare(torch, f"{name} ({label})", out, plain())
        return out, err

    # ---- K1 + K2 cases: (label, src planes, ref planes, x0, width)
    y0, u0, v0 = src_y, src_u, src_v
    # copy-grade at luma offset (6, -4), chroma (3, -2)
    shift_y = torch.roll(src_y, (4, -6), (0, 1))
    shift_u = torch.roll(src_u, (2, -3), (0, 1))
    shift_v = torch.roll(src_v, (2, -3), (0, 1))
    noise = t(rng.integers(-1, 2, (H, W)), torch.int32)
    flat_y = torch.full((H, W), 128, dtype=torch.int32, device=dev)
    flat_c = torch.full((H // 2, W // 2), 128, dtype=torch.int32, device=dev)
    checker = t((np.indices((H, W)).sum(0) % 2) * 40 + 100, torch.int16)
    checker_c = t((np.indices((H // 2, W // 2)).sum(0) % 2) * 40 + 100,
                  torch.int16)
    cases = [
        ("random", (y0, u0, v0), (ring_y[2], ring_u[2], ring_v[2]), 0, W),
        ("copy shift", (shift_y + noise, shift_u, shift_v),
         (y0.to(torch.int16), u0.to(torch.int16), v0.to(torch.int16)), 0, W),
        ("flat", (flat_y, flat_c, flat_c),
         (flat_y.to(torch.int16), flat_c.to(torch.int16),
          flat_c.to(torch.int16)), 0, W),
        ("ties", (flat_y, flat_c, flat_c), (checker, checker_c, checker_c),
         0, W),
        ("tile x0", (y0, u0, v0), (ring_y[1], ring_u[1], ring_v[1]), 64,
         W + 160),
    ]
    k1_err = k2_err = 0
    for label, (sy, su, sv), (ry, ru, rv), x0, width in cases:
        cmax, e1 = check("K1 chroma_max_maps",
                         lambda: cm.chroma_max_maps(su, sv, ru, rv),
                         lambda: cm.chroma_max_maps_plain(su, sv, ru, rv),
                         label)
        _, e2 = check("K2 dense_select",
                      lambda: cm.dense_select(sy, ry, cmax, x0, width, H,
                                              thr),
                      lambda: cm.dense_select_plain(sy, ry, cmax, x0, width,
                                                    H, thr), label)
        k1_err, k2_err = max(k1_err, e1), max(k2_err, e2)
    log("K1/K2: equal to the plain versions on " +
        ", ".join(c[0] for c in cases))

    ref_y, ref_u, ref_v = ring_y[2], ring_u[2], ring_v[2]
    cmax = cm.chroma_max_maps(src_u, src_v, ref_u, ref_v)
    recs["K1"] = dict(
        ms=cuda_ms(torch, lambda: cm.chroma_max_maps(src_u, src_v, ref_u,
                                                     ref_v), 10),
        plain_ms=cuda_ms(torch, lambda: cm.chroma_max_maps_plain(
            src_u, src_v, ref_u, ref_v), 3),
        bytes=2 * src_u.numel() * 4 + 2 * ref_u.numel() * 2 + cmax.numel() * 4,
        ops=2 * 289 * src_u.numel(), max_abs_err=k1_err)
    recs["K2"] = dict(
        ms=cuda_ms(torch, lambda: cm.dense_select(src_y, ref_y, cmax, 0, W,
                                                  H, thr), 10),
        plain_ms=cuda_ms(torch, lambda: cm.dense_select_plain(
            src_y, ref_y, cmax, 0, W, H, thr), 3),
        bytes=src_y.numel() * 4 + ref_y.numel() * 2 + cmax.numel() * 4
        + n * 17,
        ops=n * 1089 * 256, max_abs_err=k2_err)

    # ---- K3: luma and chroma windows, motion in [-16, 16] and beyond
    mx = t(rng.integers(-16, 17, n), torch.int32)
    my = t(rng.integers(-16, 17, n), torch.int32)
    mx[:64] = 40          # offsets the window clamps
    my[64:128] = -40
    k3_err = 0
    for label, planes, bx, by, blk, pad in (
            ("luma", ring_y, mx, my, 18, 17),
            ("chroma", ring_u, mx >> 1, my >> 1, 10, 9)):
        _, e = check("K3 gather_windows",
                     lambda: cp.gather_windows(planes, slot, bx, by, blk,
                                               pad),
                     lambda: cp.gather_windows_plain(planes, slot, bx, by,
                                                     blk, pad), label)
        k3_err = max(k3_err, e)
    log("K3: equal to the plain version (luma, chroma, clamped offsets)")
    recs["K3"] = dict(
        ms=cuda_ms(torch, lambda: cp.gather_windows(ring_y, slot, mx, my, 18,
                                                    17), 10),
        plain_ms=cuda_ms(torch, lambda: cp.gather_windows_plain(
            ring_y, slot, mx, my, 18, 17), 3),
        bytes=H * W * 2 + 2 * n * 4 + n * 18 * 18 * 4, ops=0,
        max_abs_err=k3_err)

    # ---- K4: every slot, sub-pel both amounts, intra zeroing
    slots = t(rng.integers(0, 4, n), torch.int32)
    spp = t(rng.random(n) < 0.5, torch.bool)
    spa = t(rng.random(n) < 0.5, torch.bool)
    spi = t(rng.integers(0, 8, n), torch.int32)
    zero = t(rng.random(n) < 0.2, torch.bool)
    args = (ring_y, ring_u, ring_v, slots, mx, my, spp, spa, spi, zero)
    _, k4_err = check("K4 pred_planes", lambda: cp.pred_planes(*args),
                      lambda: cp.pred_planes_plain(*args), "random")
    log("K4: equal to the plain version")
    # each predicted pixel reads one ring pixel (its sub-pel neighbour is
    # the next pixel's base), intra MBs read none; 7 int32 fields per MB;
    # three int32 planes written
    predicted = int((~zero).sum()) * (16 * 16 + 2 * 8 * 8)
    recs["K4"] = dict(
        ms=cuda_ms(torch, lambda: cp.pred_planes(*args), 10),
        plain_ms=cuda_ms(torch, lambda: cp.pred_planes_plain(*args), 3),
        bytes=predicted * 2 + 7 * n * 4 + H * W * 3 // 2 * 4,
        ops=0, max_abs_err=k4_err)
    return recs


def host_decode(np, native, stream, chunks):
    """Decodes a stream with the native sequential C++ decoder alone."""
    from cairo_tpu_torch.blocktypes import BlockTable
    width, height = stream.parse_header(chunks[0][:stream.HEADER_SIZE])
    aw, ah = -(-width // 16) * 16, -(-height // 16) * 16
    bt = BlockTable.zeros((aw // 16) * (ah // 16))
    coef = [np.zeros((ah, aw), np.int16),
            np.zeros((ah // 2, aw // 2), np.int16),
            np.zeros((ah // 2, aw // 2), np.int16)]
    dec = native.NativeDecoder(aw, ah)
    out = []
    for i, chunk in enumerate(chunks):
        off = stream.HEADER_SIZE if i == 0 else 0
        _, index, _ = struct.unpack(
            stream._FRAME_FMT, chunk[off:off + stream.FRAME_DESC_SIZE])
        off += stream.FRAME_DESC_SIZE
        native.decode_slice(chunk, off * 8, bt, *coef)
        out.append(dec.decode_frame(bt, *coef, index, width, height))
    return out


def phase_main(torch, np, gpu):
    """The main path at 1080p; returns (launch counts, summary dict)."""
    from cairo_tpu_torch import native
    from cairo_tpu_torch.cpuref import stream
    from cairo_tpu_torch.synth import synth_frames

    api = gpu["api"]
    frames = synth_frames(1920, 1080, 5, seed=SEED % 1000)
    for mod in (gpu["cuda_motion"], gpu["cuda_pred"]):
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    enc = api.GpuEncoder()
    enc.set_quality(16)
    chunks, recons, enc_s, stages = [], [], [], {}
    for f in frames:
        t0 = time.perf_counter()
        chunks.append(enc.encode(f))
        torch.cuda.synchronize()
        enc_s.append(time.perf_counter() - t0)
        recons.append(enc.peek_destination())
        for k, v in enc.last_stats["stage_ms"].items():
            stages.setdefault(f"encode.{k}", []).append(v)
    dec = api.GpuDecoder()
    outs, dec_s = [], []
    for c in chunks:
        t0 = time.perf_counter()
        outs.append(dec.decode(c))
        torch.cuda.synchronize()
        dec_s.append(time.perf_counter() - t0)
        for k, v in dec.last_stats.get("stage_ms", {}).items():
            stages.setdefault(f"decode.{k}", []).append(v)
    launches = {**gpu["cuda_motion"].LAUNCHES, **gpu["cuda_pred"].LAUNCHES}

    for i, (o, r) in enumerate(zip(outs, recons)):
        if not np.array_equal(o, r):
            fail(f"main path: decoded frame {i} differs from the encoder's "
                 f"reconstruction")
    if dec.host_frames:
        fail(f"main path: {dec.host_frames} frames took the host decoder")
    for i, (o, h) in enumerate(zip(outs, host_decode(np, native, stream,
                                                     chunks))):
        if not np.array_equal(o, h):
            fail(f"main path: frame {i} differs from the native C++ decoder")
    for name, count in launches.items():
        if count == 0:
            fail(f"main path: kernel {name} was never launched")
    mse = float(np.mean([np.mean((o.astype(np.float64) - f) ** 2)
                         for o, f in zip(outs, frames)]))
    summary = dict(
        frames=len(frames),
        # the inter frames only: the intra frame's time includes first-call
        # set-up
        inter_encode_fps=(len(frames) - 1) / sum(enc_s[1:]),
        inter_decode_fps=(len(frames) - 1) / sum(dec_s[1:]),
        encode_ms=[round(s * 1e3, 1) for s in enc_s],
        decode_ms=[round(s * 1e3, 1) for s in dec_s],
        psnr_db=10 * np.log10(255.0 ** 2 / max(1e-9, mse)),
        kbits_per_frame=sum(len(c) for c in chunks) * 8 / len(chunks) / 1000,
        stage_ms_median={k: round(float(np.median(v[1:])), 1)
                         for k, v in stages.items()})
    return launches, summary


def phase_cpu_vs_card(gpu):
    from cairo_tpu_torch.synth import synth_frames

    api = gpu["api"]
    frames = synth_frames(176, 144, 3, seed=SEED % 997)
    cpu, card = api.GpuEncoder(device="cpu"), api.GpuEncoder()
    for i, f in enumerate(frames):
        a, b = cpu.encode(f), card.encode(f)
        if a != b:
            fail(f"CPU and card chunks differ at frame {i} "
                 f"({len(a)} vs {len(b)} bytes)")


# pipeline stages labelled in the --profile trace: (module, attribute)
PROFILE_STAGES = (
    ("native", "rgb_to_yuv5d"), ("native", "encode_slice"),
    ("native", "decode_slice"), ("native", "extract_coo"),
    ("native", "yuv5d_wire_to_rgb"), ("wire", "unpack_yuv5d"),
    ("wire", "pack_encode_wire"), ("wire", "pack_yuv5d_wire"),
    ("motion", "inter_search"), ("cuda_motion", "chroma_max_maps"),
    ("cuda_motion", "dense_select"), ("cuda_pred", "gather_windows"),
    ("cuda_pred", "pred_planes"), ("engine", "_quantize_planes"),
    ("engine", "_reconstruct"), ("deblock", "deblock_frame"),
    ("ops", "fdct8"))
PORT_KERNELS = ("chroma_max_kernel", "dense_select_kernel",
                "gather_windows_kernel", "pred_planes_kernel")


def phase_profile(torch, gpu, smi):
    """Host and device time per pipeline stage for one inter frame, and
    the device's busy share against an unprofiled run of the same work."""
    import importlib
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from cairo_tpu_torch.synth import synth_frames

    def labelled(name, fn):
        def run(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return run

    def frame(enc, dec, f):
        with record_function("stage.encode_frame"):
            chunk = enc.encode(f)
        with record_function("stage.decode_frame"):
            dec.decode(chunk)
        torch.cuda.synchronize()

    for mod_name, attr in PROFILE_STAGES:
        pkg = "cairo_tpu_torch" if mod_name == "native" else \
            "cairo_tpu_torch.gpu"
        mod = importlib.import_module(f"{pkg}.{mod_name}")
        setattr(mod, attr, labelled(f"stage.{attr}", getattr(mod, attr)))
    frames = synth_frames(1920, 1080, 4, seed=SEED % 1000)
    enc, dec = gpu["api"].GpuEncoder(), gpu["api"].GpuDecoder()
    enc.set_quality(16)
    for f in frames[:2]:
        frame(enc, dec, f)
    t0 = time.perf_counter()
    frame(enc, dec, frames[2])
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        frame(enc, dec, frames[3])
    events = prof.key_averages()

    def dev_us(e, self_only):
        for name in (("self_device_time_total", "self_cuda_time_total")
                     if self_only else ("device_time_total",
                                        "cuda_time_total")):
            if hasattr(e, name):
                return getattr(e, name)
        return 0.0

    # kernels only: the device-side copies of the stage ranges would count
    # their whole span, idle gaps included
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.key.startswith("stage.")]
    busy = sum(dev_us(e, True) for e in kernels) / 1e6
    log(f"profile: one 1920x1080 q16 inter frame encoded + decoded on {smi}: "
        f"wall {wall * 1e3:.1f} ms unprofiled; kernels {busy * 1e3:.1f} ms "
        f"in {sum(e.count for e in kernels)} launches, so the device is busy "
        f"{100 * busy / wall:.1f}% and idle {100 - 100 * busy / wall:.1f}% "
        f"of the unprofiled wall")
    log("profile: stage | host ms (profiled) | device ms of the ATen "
        "kernels inside it | calls")
    rows = sorted((e for e in events if e.key.startswith("stage.")
                   and e.device_type == DeviceType.CPU),
                  key=lambda e: -e.cpu_time_total)
    for e in rows:
        log(f"profile: {e.key[6:]:<20} {e.cpu_time_total / 1e3:10.2f} "
            f"{dev_us(e, False) / 1e3:10.2f} {e.count:6d}")
    log("profile: top kernels | device ms | launches")
    for e in sorted(kernels, key=lambda e: -dev_us(e, True))[:10]:
        log(f"profile: {e.key[:70]:<70} {dev_us(e, True) / 1e3:8.2f} "
            f"{e.count:6d}")
    # the profiler ties a kernel to a range only through the ATen op that
    # launched it; K1-K4 launch through ctypes, so their stage rows above
    # read 0 device ms and their device time is here
    log("profile: the port's kernels | device ms | launches")
    for kname in PORT_KERNELS:
        hits = [e for e in kernels if kname in e.key]
        log(f"profile: {kname:<22} "
            f"{sum(dev_us(e, True) for e in hits) / 1e3:8.3f} "
            f"{sum(e.count for e in hits):6d}")


def main():
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device found (torch.cuda.is_available() is False)")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "src", "cairo_tpu_torch")):
        fail("src/cairo_tpu_torch is not beside this script")
    sys.path.insert(0, os.path.join(root, "src"))
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 0: card {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    from cairo_tpu_torch.gpu import _build, api, cuda_motion, cuda_pred
    gpu = dict(api=api, cuda_motion=cuda_motion, cuda_pred=cuda_pred)
    secs = _build.build_all(verbose=True)
    log(f"phase 1: built kernels in {secs['kernels_s']:.1f}s and the native "
        f"library in {secs['native_s']:.1f}s")
    log("kernels: K1 chroma_max_maps, K2 dense_select, K3 gather_windows, "
        "K4 pred_planes")
    if "--profile" in sys.argv[1:]:
        phase_profile(torch, gpu, smi)
        faulthandler.cancel_dump_traceback_later()
        return

    recs = phase_kernels(torch, np, gpu)
    for k, r in recs.items():
        log(f"phase 2: {k} {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms) "
            f"on {smi}")

    launches, summary = phase_main(torch, np, gpu)
    log(f"phase 3: 1920x1080 q16, {summary['frames']} frames on {smi}: "
        f"inter frames encode {summary['inter_encode_fps']:.2f} fps, decode "
        f"{summary['inter_decode_fps']:.2f} fps; all frames psnr "
        f"{summary['psnr_db']:.2f} dB, "
        f"{summary['kbits_per_frame']:.1f} kbit/frame; encode ms "
        f"{summary['encode_ms']}, decode ms {summary['decode_ms']}; inter "
        f"frame stage medians (ms) {summary['stage_ms_median']}; launches "
        f"{launches}")

    phase_cpu_vs_card(gpu)
    log("phase 4: CPU and card chunks byte-identical at 176x144")

    meta = {
        "K1": ("chroma_max_maps", "src/cairo_tpu_torch/gpu/csrc/motion.cu",
               "src/cairo_tpu/tpu/pallas_motion.py:314"),
        "K2": ("dense_select", "src/cairo_tpu_torch/gpu/csrc/motion.cu",
               "src/cairo_tpu/tpu/pallas_motion.py:212"),
        "K3": ("gather_windows", "src/cairo_tpu_torch/gpu/csrc/pred.cu",
               "src/cairo_tpu/tpu/pallas_pred.py:313"),
        "K4": ("pred_planes", "src/cairo_tpu_torch/gpu/csrc/pred.cu",
               "src/cairo_tpu/tpu/pallas_pred.py:221"),
    }
    kernels = []
    for k, (name, source, replaces) in meta.items():
        r = recs[k]
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / INT_OPS_PER_S * 1e3
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None))
    faulthandler.cancel_dump_traceback_later()
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
