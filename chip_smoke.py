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
     shifts, flat planes that force ties, recon overshoot beyond 0..255,
     references over the whole int16 range, window offsets the clamp
     catches); exact equality; K3 as the main path launches it (Y, U and
     V in one launch) and as a luma and a chroma call alone; K8
     deblock_frame run twice with identical outputs and its inputs left as
     they were, at 1920x1088 (recon overshoot, copy MBs with stale
     non-zero q) and at the edge cases of its CPU tests
     (tests/util_deblock.py: one MB, one MB row, one MB column, 272x480,
     400x208, which K8's tiles divide in neither dimension, and 112x208,
     one tile column; all, no and some copy MBs, q 0 and 31, samples far
     beyond int16, a uint8 q map); CUDA-event times and each kernel's
     device time from a torch.profiler trace, K8's bound and ptxas
     registers, shared memory and spills; K9 as the main path launches it,
     every reference and the classification merge in one launch
     (subpel_classify), against its plain version at 1920x1088 on the
     three references K1-K3 search (smooth content a quarter-pel step past
     a full-pel shift, so that sub-pel candidates are taken), on two and
     one of them, at a tile origin, on random vectors over windows of the
     whole int16 range with a MAD threshold that lets the copy branch take
     every lower MAD, and with no reference (every MB intra), one launch a
     call; and its one-reference entry (subpel_scan) on the arguments
     K1-K3 give it (the windows views into K3's one buffer), at a tile
     origin, on random vectors, on windows over the whole int16 range,
     with all MBs frozen and on flat planes where every candidate ties;
     inputs unchanged, with both entries' times and bounds and its ptxas
     usage; K10 encode_tail
     and K11 decode_tail against their plain versions at 1920x1088 on the
     arguments the main path gives them (GpuEncoder and GpuDecoder on an
     intra and an inter frame, each call's arguments kept) and on edge
     inputs (residuals at 32767, -32767 and 32768 at q 1, full-scale
     residuals whose variance sums wrap int32 at q 31, adaptive QP off,
     every MB a copy; K11 without the carry, with the residual blocks K7
     reads, on int16-range coefficients and with every MB a copy and the
     carry, also timed), each twice with identical outputs and its inputs
     unchanged, with their times, bounds and ptxas usage; K12
     unpack_yuv5d in both layouts (planes, and the conformance step's
     blocks with self_sad) against its plain versions at 1920x1088 on a
     frame's 5-bit wire and on its exception section rewritten (negative,
     dropped and repeated positions, crowded rows), twice, exact, with
     its times against the plain torch sequence it replaces;
  3. main path: GpuEncoder + GpuDecoder over 1 intra + 4 inter synthetic
     1920x1080 frames at q16; every decoded frame must equal the encoder's
     reconstruction and the native sequential C++ decoder's output, no
     frame may take the host decode path, every kernel must have been
     launched, K3 once per reference search (as often as K2), K9 once
     per inter frame (for all three references), K8 once per encoded and
     once per decoded frame, K10 once per encoded and K11 once per
     decoded frame, K12 once per encoded frame;
  4. CPU against card: 3 frames at 176x144 encoded with device="cpu" and
     on the card give byte-identical chunks;
  2b. the conformance path's kernels against their plain versions at its
     1080p shapes, exact: K4 at the wide pads 33/17 (|mv| up to 31 and
     clamped beyond, sub-pel), K5 on three references with shifted
     content, on flat planes that force ties (at SAD 0 and at the SAD
     threshold the reference's C-precedence quirk tests) and with overshoot
     beyond 0..255, and K6 on one intra and one inter wave pass fed the
     same K5 output, K5 and K6 each run twice with identical outputs (an
     ordering race between K6's pipelined rows would show); K4's, K5's and
     K6's device time from a torch.profiler trace that may hold no more
     than one launch of the kernel per call, K6's time per step of its
     321-MB dependency chain, and the registers and spills of every
     kernel (each template instance of K3 and K4) from the build's ptxas
     log (kept beside the library, so a cached build reports them too);
     K7 against its plain version on the inputs the wavefront decode of a
     1080p conformance stream (1 intra + 1 inter frame, q16) gives it,
     each frame's run twice, exact, one launch each; each frame's longest
     chain of dependent members (cuda_wavedec.dependency_chain, and its
     model of the steps with 1, 2 and 4 blocks an SM holding tickets) and
     K7's device time per chain step; its times on the inter frame (the
     intra frame's under intra_*);
  5. conformance path: ConformanceGpuEncoder over 1 intra + 2 inter
     synthetic 1920x1080 frames at q16, each chunk decoded by GpuDecoder
     on the device (the wavefront decode: K4 at 33/17 and K7); no frame may
     take the host decoder, every decoded frame must equal the encoder's
     reconstruction and the native sequential C++ decoder's output, K4 at
     33/17, K5, K6 and K7 must each have been launched (K6 once per frame,
     K7 once per decode frame with active waves, K8 once per encoded and
     once per decoded frame, K11 once per decoded frame, K12 once per
     encoded frame, K10 never: the conformance encoder's tail is K6's)
     and K7 must have rebuilt
     intra-motion blocks;
     prints the decode fps
     and the waves and members per frame;
  6. CPU against card, conformance: 3 frames at 176x144 at q 4, 16 and 29
     give byte-identical chunks with device="cpu" and on the card, and
     GpuDecoder decodes them to identical RGB on both, on the device path;
  7. pipelined: each path's encoder's encode_many and GpuDecoder's
     decode_many at 1920x1080 q16 (fast: 2 warm-up + 20 measured frames,
     conformance: 2 + 8), then a loop over encode and decode on the same
     frames (measure_pipelined); fails unless the chunks and RGB equal the
     loop's, no frame took the host decoder and every kernel of the path
     was launched in the pipelined run (its counts set to 0 just before
     it), K9 once per fast inter frame, K10 once per fast encoded
     frame, K11 once per decoded frame and K12 once per encoded frame
     of either path; prints both fps
     (as bench.py counts them: the yield intervals of the measured
     frames) and the per-stage medians of each run;
  8. tiled: TiledEncoder and TiledDecoder (gpu/tiled.py) over 1 intra + 4
     inter 1920x1080 frames at q16 whose content moves 9 px a frame
     across the tile edges, in four configurations: 1 tile (each slice
     equals GpuEncoder's, the RGB GpuDecoder's); 4 tiles on one card
     (decoded RGB equals recon_rgb(), some MB in a tile's first column
     takes a vector into its left neighbour; a sixth frame traced for its
     CUDA launches); 2 GOPs x 2 tiles (each GOP's stream equals that GOP
     encoded alone); 352x288 over 4 tiles (the card's chunks equal the
     CPU's); fails unless every comparison holds and K1-K4 and K8 were
     launched in each configuration, K1-K4 with the ring halo, K9 once
     per tile of each inter frame, K10 once per tile of each
     encoded frame and K11 once per tile of each decoded one; prints the
     per-frame fps of tiled encode and decode at each tile count. Phase 2
     also holds K1-K4 at a tile's halo'd shapes (1088 x (480 + 64) luma)
     against their plain versions, margins zeroed and real;
  9. library surface: the port's host reference engine (Evx1Encoder,
     Evx1Decoder: numpy, sharing nothing with the device path) against
     ConformanceGpuEncoder and GpuDecoder on the card over 1 intra + 2
     inter synthetic 640x360 frames at q16 (chunks byte-identical, RGB
     equal to Evx1Decoder's and the native decoder's, no host frame, K4
     at 33/17, K5, K6, K7 and K8 launched, their counts set to 0 just
     before), with both encoders' fps and the host CPU's model; the 10
     analysis metrics and the 6 transforms of gpu/ops (fdct4, idct4,
     fdct16_line, idct16_line, fdct16, idct16) on the card against the
     CPU, exact, over the 8,160 MBs of a 1080p frame and over blocks of
     the whole int16 range with -32768 in them; each entropy backend
     round-trips 10,000 values, and those that share the ABAC coder with
     the slice codec write its writers' bits; a `library {json}` line.
The line before the last is a JSON object with each kernel's launches (K4
once per pad set; K7's in phase 5; K8's and K11's in phases 3 and 5
together, by path under launches_by_path; phase 7's pipelined runs under
launches_pipelined; phase 8's under launches_tiled), error, times and
ptxas registers (K3's
are its three-plane launch's, with its luma and chroma calls alone under
luma_* and chroma_*); the last line is the contract line
{"ok": true, "device": {...}}. Any failed check exits non-zero.

    python3 chip_smoke.py --profile

runs phases 0-1 and then torch.profiler traces of one 1080p inter frame
through GpuEncoder and GpuDecoder, of one through ConformanceGpuEncoder
and of one conformance chunk through GpuDecoder (the wavefront decode),
with one labelled range per pipeline stage: host
and device milliseconds per stage, the port's kernels' device time by
kernel name, and all kernels' device time against the unprofiled wall
time of the same work (busy share); for the fast frame, its CUDA launches
beside the 517 it took before K9 took every reference and the merge.
"""

from __future__ import annotations

import faulthandler
import functools
import json
import os
import re
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


def device_ms(torch, fn, kernel, reps=10, traces=5, per_call=1):
    """Mean device time in ms of the `per_call` launches of the kernel
    named `kernel` that one call of fn() makes, over `reps` calls, from a
    torch.profiler trace (the event
    times above also hold the wrapper's host work). The trace records
    after a warm-up step, as the profiler's schedule has it: a trace that
    records from its first call loses that call's kernels. A trace may
    still come back without any launch of the kernel (the first trace of
    phase 2b did so in some runs, while the next one held all of them),
    but it holds none that did not happen: such a trace is taken again,
    up to `traces` times, and the run fails if none holds a launch or one
    holds more than `per_call` a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, traces + 1):
        ready = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: ready.append(
                         p.key_averages())) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
        total, launches, others = 0.0, 0, 0
        for e in (ready[0] if ready else ()):
            if e.device_type != DeviceType.CUDA:
                continue
            if kernel in e.key:
                total += getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
                launches += e.count
            else:
                others += e.count
        if launches > reps * per_call:
            break
        if launches:
            return total / launches * per_call / 1e3
        log(f"{kernel}: trace {attempt} of {traces} holds no launch of it "
            f"({others} other device events)")
    fail(f"{kernel}: {launches} launches on the device in {reps} calls "
         f"({per_call} each expected)")


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


def ptxas_usage(build_log):
    """Registers, shared memory and spills per kernel from `nvcc -Xptxas
    -v` output: {short kernel name: "N registers, M bytes smem, S bytes
    spill stores, L bytes spill loads"} (no smem where ptxas reports
    none), a template instance named with its arguments, as
    "pred_planes_kernel<17,9>"."""
    out, name = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in PORT_KERNELS if k in line), None)
            args = name and re.search(re.escape(name) + r"I((?:Li\d+E)+)E",
                                      line)
            if args:
                name += "<" + ",".join(re.findall(r"Li(\d+)E", args[1])) + ">"
            spill = "spills not reported"
        elif name and "spill stores" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            smem = re.search(r"(\d+) bytes smem", line)
            smem = f"{smem[1]} bytes smem, " if smem else ""
            out[name] = f"{regs}, {smem}{spill}"
            name = None
    return out


def pred_planes_bytes(args, H, W):
    """The bytes K4 must move for pred_planes(*args): each predicted pixel
    reads one ring sample (its sub-pel neighbour is the next pixel's
    base) and intra MBs read none; the seven per-MB fields at the widths
    passed (flags as bytes on the main path); three int32 planes."""
    fields, zero = args[3:10], args[9]
    predicted = int((~zero).sum()) * (16 * 16 + 2 * 8 * 8)
    return (predicted * 2 + sum(f.numel() * f.element_size() for f in fields)
            + H * W * 3 // 2 * 4)


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
    # references over the whole int16 range: |src - ref| up to 33023, the
    # range K2's float arithmetic must hold exactly
    full_y = t(rng.integers(-32768, 32768, (H, W)), torch.int16)
    full_c = t(rng.integers(-32768, 32768, (H // 2, W // 2)), torch.int16)
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
        ("int16 range", (y0, u0, v0), (full_y, full_c, full_c), 0, W),
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
        device_ms=device_ms(torch, lambda: cm.chroma_max_maps(
            src_u, src_v, ref_u, ref_v), "chroma_max_kernel"),
        plain_ms=cuda_ms(torch, lambda: cm.chroma_max_maps_plain(
            src_u, src_v, ref_u, ref_v), 3),
        bytes=2 * src_u.numel() * 4 + 2 * ref_u.numel() * 2 + cmax.numel() * 4,
        ops=2 * 289 * src_u.numel(), max_abs_err=k1_err)
    recs["K2"] = dict(
        ms=cuda_ms(torch, lambda: cm.dense_select(src_y, ref_y, cmax, 0, W,
                                                  H, thr), 10),
        device_ms=device_ms(torch, lambda: cm.dense_select(
            src_y, ref_y, cmax, 0, W, H, thr), "dense_select_kernel"),
        plain_ms=cuda_ms(torch, lambda: cm.dense_select_plain(
            src_y, ref_y, cmax, 0, W, H, thr), 3),
        bytes=src_y.numel() * 4 + ref_y.numel() * 2 + cmax.numel() * 4
        + n * 17,
        ops=n * 1089 * 256, max_abs_err=k2_err)

    # ---- K3: the three-plane launch of the main path and the luma and
    # chroma calls alone, motion in [-16, 16] and beyond
    mx = t(rng.integers(-16, 17, n), torch.int32)
    my = t(rng.integers(-16, 17, n), torch.int32)
    mx[:64] = 40          # offsets the window clamps
    my[64:128] = -40
    ring3 = (ring_y, ring_u, ring_v)
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
    _, e = check("K3 gather_windows_yuv",
                 lambda: cp.gather_windows_yuv(ring3, slot, mx, my),
                 lambda: cp.gather_windows_yuv_plain(ring3, slot, mx, my),
                 "Y, U and V")
    k3_err = max(k3_err, e)
    log("K3: equal to the plain version (Y, U and V in one launch; luma and "
        "chroma alone; clamped offsets)")
    # per call: one slot's plane read, the offsets, the windows written;
    # the three-plane launch (one per reference of a fast inter frame)
    # reads a luma and two chroma planes and the offsets once, and writes
    # a luma and two chroma (10 x 10, pad 9) windows per MB
    offsets = 2 * n * 4
    luma = H * W * 2 + n * 18 * 18 * 4
    chroma = H * W // 4 * 2 + n * 10 * 10 * 4
    calls = dict(
        luma=(lambda: cp.gather_windows(ring_y, slot, mx, my, 18, 17),
              lambda: cp.gather_windows_plain(ring_y, slot, mx, my, 18, 17),
              luma + offsets),
        chroma=(lambda: cp.gather_windows(ring_u, slot, mx >> 1, my >> 1, 10,
                                          9),
                lambda: cp.gather_windows_plain(ring_u, slot, mx >> 1,
                                                my >> 1, 10, 9),
                chroma + offsets))
    recs["K3"] = dict(
        ms=cuda_ms(torch, lambda: cp.gather_windows_yuv(ring3, slot, mx, my),
                   10),
        device_ms=device_ms(torch, lambda: cp.gather_windows_yuv(
            ring3, slot, mx, my), "gather_windows_kernel"),
        plain_ms=cuda_ms(torch, lambda: cp.gather_windows_yuv_plain(
            ring3, slot, mx, my), 3),
        bytes=luma + 2 * chroma + offsets, ops=0,
        max_abs_err=k3_err)
    for label, (kern, plain, nbytes) in calls.items():
        recs["K3"].update({
            f"{label}_ms": cuda_ms(torch, kern, 10),
            f"{label}_device_ms": device_ms(torch, kern,
                                            "gather_windows_kernel"),
            f"{label}_plain_ms": cuda_ms(torch, plain, 3),
            f"{label}_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})

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
    recs["K4"] = dict(
        ms=cuda_ms(torch, lambda: cp.pred_planes(*args), 10),
        device_ms=device_ms(torch, lambda: cp.pred_planes(*args),
                            "pred_planes_kernel"),
        plain_ms=cuda_ms(torch, lambda: cp.pred_planes_plain(*args), 3),
        bytes=pred_planes_bytes(args, H, W), ops=0, max_abs_err=k4_err)
    for k, err in phase_kernels_halo(torch, np, gpu, check).items():
        recs[k]["max_abs_err"] = max(recs[k]["max_abs_err"], err)
    return recs


# references a fast inter frame searches (RING - 1), one K9 launch each
REFS = 3
# integer operations per sample of a sub-pel candidate, counted from
# csrc/subpel.cu's dhalf and dquarter: the blend's sum, its sign, src -
# blend with the rounding folded in, the shift, |.|, the SAD's sum (luma
# only) and the MAD's max
SUBPEL_OPS_LUMA = 7
SUBPEL_OPS_CHROMA = 6
SUBPEL_OPS_PER_MB = 256 * SUBPEL_OPS_LUMA + 128 * SUBPEL_OPS_CHROMA


def valid_candidates(mx, my, frozen, px, py, x0, width, height):
    """The sub-pel directions of the MBs that K9 may take: the block
    stays in the frame and the MB is not frozen."""
    valid = 0
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            if (di, dj) == (0, 0):
                continue
            gx, gy = x0 + px + mx + di, py + my + dj
            valid += int(((gx >= 0) & (gx <= width - 16) & (gy >= 0)
                          & (gy <= height - 16) & ~frozen).sum())
    return valid


def subpel_work(args):
    """(bytes, operations) K9 must spend on subpel_scan(*args): the
    windows, source planes and per-MB fields read once, the outputs
    written once; the blends of the candidates that may be taken (a
    direction whose block stays in the frame, of an MB not frozen), 2
    amounts x 384 samples each (SUBPEL_OPS_PER_MB)."""
    wins, planes, mx, my, _, _, frozen, px, py, x0, width, height, _ = args
    n = mx.numel()
    nbytes = (sum(t.numel() * 4 for t in wins + planes) + n * (6 * 4 + 1)
              + n * (3 * 4 + 4))
    valid = valid_candidates(mx, my, frozen, px, py, x0, width, height)
    return nbytes, valid * 2 * SUBPEL_OPS_PER_MB


def classify_work(args):
    """(bytes, operations) K9 must spend on subpel_classify(*args): each
    reference's windows and K2 fields, the source planes and MB
    positions read once, the 11 outputs (26 bytes an MB) written once;
    each reference's candidates that may be taken, as subpel_work counts
    them, and the intra SAD's 2 operations a luma sample."""
    refs, planes, px, py, x0, width, height, _ = args
    n = px.numel()
    nbytes = sum(t.numel() * 4 for t in planes) + n * (2 * 4 + 26)
    ops = n * 256 * 2
    for wins, mx, my, _, _, frozen in refs:
        nbytes += sum(t.numel() * 4 for t in wins) + n * (4 * 4 + 1)
        ops += valid_candidates(mx, my, frozen, px, py, x0, width,
                                height) * 2 * SUBPEL_OPS_PER_MB
    return nbytes, ops


def smooth_ring(torch, rng, dev, shapes, lo, hi):
    """Planes of `shapes` (Y, U, V), 4 ring slots each, of smooth random
    content in [lo, hi], int16: sub-pel blends of it predict its
    fractional shifts well."""
    def smooth(h, w):
        yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
        xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
        f = torch.zeros((h, w), device=dev)
        for fx, fy, ph, pv in rng.uniform(0.05, 0.3, (3, 4)) * [1, 1, 20,
                                                                  20]:
            f += torch.sin(fx * xx + ph) * torch.cos(fy * yy + pv)
        f = (f - f.min()) / (f.max() - f.min())
        return torch.round(lo + (hi - lo) * f).to(torch.int32)

    return tuple(torch.stack([smooth(*s) for _ in range(4)])
                 .to(torch.int16) for s in shapes)


def quarter_shifted(torch, rng, dev, ring):
    """Source planes that show ring slot 1 a quarter-pel step past (3, -2)
    (chroma (1, -1)), plus noise in -2..2, clipped to 0..255."""
    out = []
    for i, r in enumerate(ring):
        dx, dy = (3, -2) if i == 0 else (1, -1)
        a = torch.roll(r[1].to(torch.int32), (-dy, -dx), (0, 1))
        b = torch.roll(r[1].to(torch.int32), (-dy - 1, -dx - 1), (0, 1))
        noise = torch.as_tensor(rng.integers(-2, 3, a.shape),
                                dtype=torch.int32, device=dev)
        out.append(((3 * a + b + 2) // 4 + noise).clamp(0, 255)
                   .contiguous())
    return tuple(out)


def phase_kernels_subpel(torch, np, gpu, H=1088, W=1920):
    """K9 against its plain version at 1080p on the arguments the fast
    search gives it (K1-K3 on a smooth ring whose slot 1 the source
    shows a quarter-pel step past (3, -2), plus noise; the windows are
    views at offsets into K3's one buffer), at a tile origin, on random
    vectors and metrics, on windows over the whole int16 range with a
    MAD threshold so high that the copy branch takes every lower MAD,
    with all MBs frozen, and on flat planes where every candidate ties;
    exact. Returns its record (timed on the first input)."""
    cm, cp = gpu["cuda_motion"], gpu["cuda_pred"]
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 9)
    n = (H // 16) * (W // 16)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    px, py = (idx % (W // 16)) * 16, (idx // (W // 16)) * 16
    shapes = ((H, W), (H // 2, W // 2), (H // 2, W // 2))
    slot = torch.tensor([1], dtype=torch.int32, device=dev)

    def ring_of(lo, hi):
        return smooth_ring(torch, rng, dev, shapes, lo, hi)

    def source(ring):
        return quarter_shifted(torch, rng, dev, ring)

    def searched(ring, src, x0, width, thr):
        cmax = cm.chroma_max_maps(src[1], src[2], ring[1][1], ring[2][1])
        mx, my, sad, mad, frozen = cm.dense_select(src[0], ring[0][1], cmax,
                                                   x0, width, H, thr)
        return (cp.gather_windows_yuv(ring, slot, mx, my), src, mx, my,
                sad, mad, frozen, px, py, x0, width, H, thr)

    def drawn(ring, src, thr, frozen_share=0.2, mad0=None):
        def i32(lo, hi):
            return torch.as_tensor(rng.integers(lo, hi, n), dtype=torch.int32,
                                   device=dev)
        mx, my = i32(-16, 17), i32(-16, 17)
        sad = i32(0, 20000)
        mad = i32(0, 12) if mad0 is None else torch.full_like(sad, mad0)
        frozen = torch.as_tensor(rng.random(n) < frozen_share, device=dev)
        return (cp.gather_windows_yuv(ring, slot, mx, my), src, mx, my, sad,
                mad, frozen, px, py, 0, W, H, thr)

    thr = torch.tensor(5, dtype=torch.int32, device=dev)  # q16
    ring = ring_of(-300, 560)
    src = source(ring)
    wide = ring_of(-32768, 32767)
    flat_ring = tuple(torch.full((4,) + s, 128, dtype=torch.int16,
                                 device=dev) for s in shapes)
    flat_src = tuple(torch.full(s, 128, dtype=torch.int32, device=dev)
                     for s in shapes)
    flat = drawn(flat_ring, flat_src, thr)
    flat = flat[:4] + (torch.zeros_like(flat[4]),
                       torch.zeros_like(flat[5])) + flat[6:]
    main = searched(ring, src, 0, W, thr)
    cases = [("main path", main),
             ("tile x0", searched(ring, src, 64, W + 160, thr)),
             ("random vectors", drawn(ring, src, thr)),
             ("int16 range, copy branch", drawn(
                 wide, source(wide), torch.tensor(1 << 20, dtype=torch.int32,
                                                  device=dev), mad0=1 << 30)),
             ("all frozen", drawn(ring, src, thr, frozen_share=1.0)),
             ("flat ties", flat)]
    if not main[0][2].storage_offset() or \
            main[0][0].untyped_storage().data_ptr() != \
            main[0][2].untyped_storage().data_ptr():
        fail("K9: the main-path windows are not views into one buffer")
    err, taken = 0, {}
    for label, args in cases:
        inputs = [t.clone() for a in args
                  for t in (a if isinstance(a, tuple) else (a,))
                  if torch.is_tensor(t)]
        got = cm.subpel_scan(*args)
        torch.cuda.synchronize()
        want = cm.subpel_scan_plain(*args)
        err = max(err, compare(torch, f"K9 subpel_scan ({label})",
                               tuple(got.values()), tuple(want.values())))
        after = [t for a in args for t in (a if isinstance(a, tuple) else (a,))
                 if torch.is_tensor(t)]
        if any(not torch.equal(a, b) for a, b in zip(inputs, after)):
            fail(f"K9 subpel_scan ({label}): an input changed")
        taken[label] = int(got["sp_pred"].sum())
    if not taken["main path"] or taken["all frozen"] or taken["flat ties"]:
        fail(f"K9: MBs that took a sub-pel candidate per case {taken} (some "
             f"on the main path and none frozen or flat expected)")
    log(f"K9: equal to the plain version on {', '.join(c[0] for c in cases)}"
        f"; MBs that took a sub-pel candidate {taken} of {n}")
    nbytes, ops = subpel_work(main)
    return dict(
        ms=cuda_ms(torch, lambda: cm.subpel_scan(*main), 10),
        device_ms=device_ms(torch, lambda: cm.subpel_scan(*main),
                            "subpel_scan_kernel"),
        plain_ms=cuda_ms(torch, lambda: cm.subpel_scan_plain(*main), 3),
        bytes=nbytes, ops=ops, max_abs_err=err, taken=taken)


def phase_kernels_classify(torch, np, gpu, H=1088, W=1920):
    """K9 as the main path launches it, every reference and the merge in
    one launch (cuda_motion.subpel_classify), against its plain version at
    1080p, exact: the three references of frame 2 (slots 1, 0, 3) that
    K1-K3 search on a smooth ring whose slot 1 the source shows a
    quarter-pel step past (3, -2), plus noise; the first two and the
    first alone; a tile origin; random vectors over windows of the whole
    int16 range with a MAD threshold that lets the copy branch take every
    lower MAD; no reference (every MB intra). Each call launches K9 once
    and leaves its inputs as they were. Returns its record (timed on the
    first case)."""
    cm, cp = gpu["cuda_motion"], gpu["cuda_pred"]
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 18)
    n = (H // 16) * (W // 16)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    px, py = (idx % (W // 16)) * 16, (idx // (W // 16)) * 16
    shapes = ((H, W), (H // 2, W // 2), (H // 2, W // 2))

    def ring_of(lo, hi):
        return smooth_ring(torch, rng, dev, shapes, lo, hi)

    def source(ring):
        return quarter_shifted(torch, rng, dev, ring)

    def slot_of(offset):
        return torch.tensor([(2 + 4 - offset) % 4], dtype=torch.int32,
                            device=dev)

    def searched(ring, src, x0, width, thr):
        refs = []
        for offset in range(1, REFS + 1):
            s = int(slot_of(offset))
            cmax = cm.chroma_max_maps(src[1], src[2], ring[1][s], ring[2][s])
            mx, my, sad, mad, frozen = cm.dense_select(
                src[0], ring[0][s], cmax, x0, width, H, thr)
            refs.append((cp.gather_windows_yuv(ring, slot_of(offset), mx,
                                               my), mx, my, sad, mad, frozen))
        return refs

    def drawn(ring, mad0):
        def i32(lo, hi):
            return torch.as_tensor(rng.integers(lo, hi, n), dtype=torch.int32,
                                   device=dev)
        refs = []
        for offset in range(1, REFS + 1):
            mx, my = i32(-16, 17), i32(-16, 17)
            refs.append((cp.gather_windows_yuv(ring, slot_of(offset), mx, my),
                         mx, my, i32(0, 20000), torch.full_like(mx, mad0),
                         torch.as_tensor(rng.random(n) < 0.2, device=dev)))
        return refs

    thr = torch.tensor(5, dtype=torch.int32, device=dev)  # q16
    big = torch.tensor(1 << 20, dtype=torch.int32, device=dev)
    ring = ring_of(-300, 560)
    src = source(ring)
    wide = ring_of(-32768, 32767)
    main = searched(ring, src, 0, W, thr)
    cases = [("main path", (main, src, px, py, 0, W, H, thr)),
             ("two references", (main[:2], src, px, py, 0, W, H, thr)),
             ("one reference", (main[:1], src, px, py, 0, W, H, thr)),
             ("tile x0", (searched(ring, src, 64, W + 160, thr), src, px, py,
                          64, W + 160, H, thr)),
             ("int16 range, copy branch", (drawn(wide, 1 << 30),
                                           source(wide), px, py, 0, W, H,
                                           big)),
             ("no reference", ([], src, px, py, 0, W, H, thr))]

    def tensors(args):
        return flat_tensors([x for ref in args[0] for x in ref]
                            + list(args[1:]), {})

    err, targets = 0, {}
    for label, args in cases:
        inputs = [t.clone() for t in tensors(args)]
        before = cm.LAUNCHES["subpel_scan"]
        got = cm.subpel_classify(*args)
        torch.cuda.synchronize()
        if cm.LAUNCHES["subpel_scan"] - before != 1:
            fail(f"K9 subpel_classify ({label}): "
                 f"{cm.LAUNCHES['subpel_scan'] - before} launches counted "
                 f"for one call")
        want = cm.subpel_classify_plain(*args)
        if list(got) != list(want):
            fail(f"K9 subpel_classify ({label}): other fields than the "
                 f"plain version's")
        err = max(err, compare(torch, f"K9 subpel_classify ({label})",
                               tuple(got.values()), tuple(want.values())))
        if any(not torch.equal(a, b)
               for a, b in zip(inputs, tensors(args))):
            fail(f"K9 subpel_classify ({label}): an input changed")
        targets[label] = np.bincount(got["target"].cpu().numpy(),
                                     minlength=REFS + 1).tolist()
    if not all(targets["main path"][1:]):
        fail(f"K9 subpel_classify: MBs per target on the main path "
             f"{targets['main path']} (every reference taken somewhere "
             f"expected)")
    if targets["no reference"][0] != n:
        fail(f"K9 subpel_classify: MBs per target with no reference "
             f"{targets['no reference']} (all intra expected)")
    log(f"K9 merged: equal to the plain version on "
        f"{', '.join(c[0] for c in cases)}; MBs per target (intra, offsets "
        f"1..{REFS}) {targets}")
    args = cases[0][1]
    nbytes, ops = classify_work(args)
    return dict(
        ms=cuda_ms(torch, lambda: cm.subpel_classify(*args), 10),
        device_ms=device_ms(torch, lambda: cm.subpel_classify(*args),
                            "subpel_scan_kernel"),
        plain_ms=cuda_ms(torch, lambda: cm.subpel_classify_plain(*args), 3),
        bytes=nbytes, ops=ops, max_abs_err=err, targets=targets)


# integer operations per sample of K10 and K11, counted from csrc/tail.cu
# (one per +, -, *, /, shift or select; wrap16 one; K10's divisions by
# reciprocal 5: the multiply-high, a subtraction, two shifts and an add):
# K10 the residual 2, the forward DCT's two passes 30 (outputs k and
# 7 - k paired), the variance 3 (its 5 on the 256 luma samples of 384),
# quantization 20, the carry 1, dequantization 8, the inverse DCT's two
# passes 30 and the prediction add 3; K11 the carry 1, dequantization 8
# (2 v, * qm, * qp, C's / by the constant 16 as three shifts and an add,
# wrap16, the DC select), the inverse DCT's two passes 30 (as K10's) and
# the prediction add 3
ENCODE_TAIL_OPS_PER_SAMPLE = 97
DECODE_TAIL_OPS_PER_SAMPLE = 42


def tail_work(name, args, kw):
    """(bytes, operations) K10 or K11 must spend on one call with `args`
    and `kw`: each input read once (the stale coefficients only for copy
    MBs, the only ones that read them), each output written once; the
    operations of every sample of every MB (K11: of every MB whose
    residual is needed; a copy MB whose residual nobody reads only carries
    and takes its prediction, one operation a sample)."""
    planes = args[0]
    samples = sum(p.numel() for p in planes)
    if name == "encode_tail":
        is_copy = args[4]
        copied = int(samples * float(is_copy.float().mean()))
        # source and prediction in; coefficients and recon out; the stale
        # coefficients of copy MBs in; flags in, qp and variance out
        return (samples * (4 + 4 + 2 + 4) + copied * 2
                + is_copy.numel() * (3 + 4 + 2),
                samples * ENCODE_TAIL_OPS_PER_SAMPLE)
    is_copy = args[3]
    stale, residual = kw.get("stale") is not None, bool(kw.get("residual"))
    copied = int(samples * float(is_copy.float().mean()))
    # prediction in and recon out; the coefficients of the MBs that are no
    # copy in; a copy MB's int16 stale row where the carry asks, else its
    # coefficients where the residual blocks ask; where asked, the carried
    # coefficients and the residual blocks out; qp and flags in
    coef_in = (samples - copied) * 4 + copied * (2 if stale else
                                                 4 if residual else 0)
    rebuilt = samples if residual else samples - copied
    return (samples * (4 + 4 + (2 if stale else 0) + (4 if residual else 0))
            + coef_in + is_copy.numel() * (4 + 2),
            rebuilt * DECODE_TAIL_OPS_PER_SAMPLE + (samples - rebuilt))


def kept_calls(mod, name, run):
    """Runs run() with mod.name wrapped so that each call's arguments are
    kept (tensors cloned on the stream of the call); returns the list of
    (args, kwargs)."""
    import torch

    def clone(x):
        if isinstance(x, tuple):
            return tuple(clone(v) for v in x)
        return x.clone() if torch.is_tensor(x) else x

    calls, fn = [], getattr(mod, name)

    def spy(*args, **kw):
        calls.append((clone(args), {k: clone(v) for k, v in kw.items()}))
        return fn(*args, **kw)

    setattr(mod, name, spy)
    try:
        run()
    finally:
        setattr(mod, name, fn)
    return calls


def phase_kernels_tail(torch, np, gpu):
    """K10 and K11 against their plain versions at 1080p, exact, on the
    arguments the main path gives them (GpuEncoder and GpuDecoder on an
    intra and an inter frame, each call's arguments kept), and on edge
    inputs: residuals at 32767, -32767 and 32768 at q 1; full-scale
    residuals whose transformed MBs' variance sums wrap int32, at q 31;
    adaptive QP off; every MB a copy; K11 without the carry, with the
    residual blocks K7 reads, on coefficients over the whole int16 range
    and with every MB a copy and the carry. Each case runs twice with
    identical outputs and its inputs left as they were. Returns the
    records of K10 and K11 (timed on the main path's inter frame; K11 also
    on its every-MB-a-copy case, keys all_copy_*)."""
    from cairo_tpu_torch.synth import synth_frames

    ct, api = gpu["cuda_tail"], gpu["api"]
    rng = np.random.default_rng(SEED + 10)
    frames = synth_frames(1920, 1080, 2, seed=SEED % 1000)
    enc, dec = api.GpuEncoder(), api.GpuDecoder()
    enc.set_quality(16)
    decoded = []

    def run():
        for f in frames:
            decoded.append(dec.decode(enc.encode(f)))
        torch.cuda.synchronize()   # the clones were made on the steps' streams

    calls = {}
    calls["decode_tail"] = kept_calls(
        ct, "decode_tail", lambda: calls.update(encode_tail=kept_calls(
            ct, "encode_tail", run)))
    for name in calls:
        if len(calls[name]) != len(frames):
            fail(f"{name}: {len(calls[name])} calls for {len(frames)} "
                 f"frames of the main path (one each expected)")
    if not np.array_equal(decoded[-1], enc.peek_destination()):
        fail("phase 2: the main-path frames of K10/K11's inputs decoded to "
             "other RGB than the encoder's reconstruction")

    def t(a, dtype):
        return torch.as_tensor(a).to("cuda", dtype)

    (src, pred, is_intra, is_motion, is_copy, quality, adaptive, coef), _ = \
        calls["encode_tail"][1]
    hw = [tuple(p.shape) for p in src]
    src_np = [p.cpu().numpy().astype(np.int64) for p in src]
    extreme = tuple(t(np.clip(np.choose(rng.integers(0, 4, s.shape), [
        s - 32767, s + 32767, s - 32768, rng.integers(-32768, 32768,
                                                      s.shape)]),
        -32768, 32767), torch.int32) for s in src_np)
    full = tuple(t(s - np.where(rng.random(s.shape) < 0.5, -1, 1) * 32767,
                   torch.int32) for s in src_np)

    def q(v):
        return torch.tensor(v, dtype=torch.int32, device="cuda")

    enc_cases = [
        ("main path, inter frame", calls["encode_tail"][1]),
        ("main path, intra frame", calls["encode_tail"][0]),
        ("int16 residuals, q 1", ((src, extreme, is_intra, is_motion,
                                   is_copy, q(1), adaptive, coef), {})),
        ("variance sums wrap, q 31", ((src, full, is_intra, is_motion,
                                       is_copy, q(31), adaptive, coef), {})),
        ("adaptive off", ((src, pred, is_intra, is_motion, is_copy, quality,
                           False, coef), {})),
        ("every MB a copy", ((src, pred, is_intra, is_motion,
                              torch.ones_like(is_copy), quality, adaptive,
                              coef), {}))]
    args, kw = calls["decode_tail"][1]
    _, qp, intra_default, dcopy, dpred = args
    wide = tuple(t(rng.integers(-32768, 32768, s), torch.int32) for s in hw)
    dec_cases = [
        ("main path, inter frame", calls["decode_tail"][1]),
        ("main path, intra frame", calls["decode_tail"][0]),
        ("no carry", (args, {})),
        ("residual blocks for K7", (args, {**kw, "residual": True})),
        ("int16-range coefficients", ((wide, t(rng.integers(0, 32, qp.numel()),
                                                torch.int32),
                                       intra_default, dcopy, dpred),
                                      {**kw, "residual": True})),
        ("every MB a copy, with the carry",
         ((args[0], qp, intra_default, torch.ones_like(dcopy), dpred),
          kw))]
    recs = {}
    for key, name, cases, kernel in (
            ("K10", "encode_tail", enc_cases, "encode_tail_kernel"),
            ("K11", "decode_tail", dec_cases, "decode_tail_kernel")):
        kern, plain = getattr(ct, name), getattr(ct, name + "_plain")
        err = 0
        for label, (a, k) in cases:
            inputs = [x.clone() for x in flat_tensors(a, k)]
            before = ct.LAUNCHES[name]
            runs = [kern(*a, **k) for _ in range(2)]
            torch.cuda.synchronize()
            if ct.LAUNCHES[name] - before != 2:
                fail(f"{key} {name} ({label}): {ct.LAUNCHES[name] - before} "
                     f"launches counted for 2 calls")
            compare(torch, f"{key} {name} ({label}, second run)",
                    flat_outputs(runs[1]), flat_outputs(runs[0]))
            want = plain(*a, **k)
            if [o is None for o in flat_outputs(runs[0], True)] != \
                    [o is None for o in flat_outputs(want, True)]:
                fail(f"{key} {name} ({label}): other outputs than the plain "
                     f"version's")
            err = max(err, compare(torch, f"{key} {name} ({label})",
                                   flat_outputs(runs[0]), flat_outputs(want)))
            if any(not torch.equal(x, y)
                   for x, y in zip(inputs, flat_tensors(a, k))):
                fail(f"{key} {name} ({label}): an input changed")
        log(f"{key}: two runs identical, equal to the plain version and the "
            f"inputs unchanged on {', '.join(c[0] for c in cases)}")
        a, k = cases[0][1]
        nbytes, ops = tail_work(name, a, k)
        recs[key] = dict(
            ms=cuda_ms(torch, lambda: kern(*a, **k), 10),
            device_ms=device_ms(torch, lambda: kern(*a, **k), kernel),
            plain_ms=cuda_ms(torch, lambda: plain(*a, **k), 3),
            bytes=nbytes, ops=ops, max_abs_err=err,
            copy_share=float(a[4 if name == "encode_tail" else 3]
                             .float().mean()))
    # K11 where every MB is a copy (with the carry), beside the main path
    a, k = dec_cases[-1][1]
    nbytes, ops = tail_work("decode_tail", a, k)
    kern, plain = ct.decode_tail, ct.decode_tail_plain
    recs["K11"].update(
        all_copy_ms=cuda_ms(torch, lambda: kern(*a, **k), 10),
        all_copy_device_ms=device_ms(torch, lambda: kern(*a, **k),
                                     "decode_tail_kernel"),
        all_copy_plain_ms=cuda_ms(torch, lambda: plain(*a, **k), 3),
        all_copy_bytes=nbytes, all_copy_ops=ops)
    return recs


def flat_tensors(args, kw):
    """The tensors among args and kw's values, tuples opened."""
    import torch

    out = []
    for a in list(args) + list(kw.values()):
        for x in (a if isinstance(a, tuple) else (a,)):
            if torch.is_tensor(x):
                out.append(x)
    return out


def flat_outputs(out, keep_none=False):
    """A wrapper's outputs as one tuple of tensors, tuples opened (None,
    where an output was not asked for, kept only with keep_none)."""
    flat = []
    for o in out:
        for x in (o if isinstance(o, tuple) else (o,)):
            if x is not None or keep_none:
                flat.append(x)
    return tuple(flat)


def phase_kernels_halo(torch, np, gpu, check):
    """K1-K4 at the shapes a quarter-1080p tile gives them (core 1088 x
    480 luma; reference margin and ring halo shard.HALO = 32 luma, 16
    chroma), margins zeroed and real (the frame-edge and interior tiles
    of the tiled path); returns each kernel's largest error (0)."""
    cm, cp, halo = gpu["cuda_motion"], gpu["cuda_pred"], gpu["shard"].HALO
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)
    H, W = 1088, 480
    n = (H // 16) * (W // 16)

    def plane(h, w, m, real, lo=-300, hi=560):
        a = rng.integers(lo, hi, (h, w + 2 * m))
        if not real:
            a[:, :m] = 0
            a[:, w + m:] = 0
        return torch.as_tensor(a).to(dev, torch.int16)

    src = [torch.as_tensor(rng.integers(0, 256, s)).to(dev, torch.int32)
           for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    thr = torch.tensor(5, dtype=torch.int32, device=dev)
    mx = torch.as_tensor(rng.integers(-16, 17, n)).to(dev, torch.int32)
    my = torch.as_tensor(rng.integers(-16, 17, n)).to(dev, torch.int32)
    mx[:32], my[32:64] = -40, 40
    slot = torch.tensor([3], dtype=torch.int32, device=dev)
    per_mb = (torch.as_tensor(rng.integers(0, 4, n)).to(dev, torch.int32),
              mx, my,
              torch.as_tensor(rng.random(n) < 0.5).to(dev),
              torch.as_tensor(rng.random(n) < 0.5).to(dev),
              torch.as_tensor(rng.integers(0, 8, n)).to(dev, torch.int32),
              torch.as_tensor(rng.random(n) < 0.2).to(dev))
    errs = dict(K1=0, K2=0, K3=0, K4=0)
    for real in (True, False):
        label = f"tile 1088x(480+64), {'real' if real else 'zeroed'} margin"
        ry = plane(H, W, halo, real)
        ru, rv = plane(H // 2, W // 2, halo // 2, real), \
            plane(H // 2, W // 2, halo // 2, real)
        cmax, e = check("K1 chroma_max_maps",
                        lambda: cm.chroma_max_maps(src[1], src[2], ru, rv,
                                                   halo // 2),
                        lambda: cm.chroma_max_maps_plain(src[1], src[2], ru,
                                                         rv, halo // 2),
                        label)
        errs["K1"] = max(errs["K1"], e)
        for x0 in (0, 480, 1440):
            _, e = check("K2 dense_select",
                         lambda: cm.dense_select(src[0], ry, cmax, x0, 1920,
                                                 1080, thr, halo),
                         lambda: cm.dense_select_plain(src[0], ry, cmax, x0,
                                                       1920, 1080, thr, halo),
                         f"{label}, x0 {x0}")
            errs["K2"] = max(errs["K2"], e)
        ring = tuple(torch.stack([plane(h, w, m, real) for _ in range(4)])
                     for h, w, m in ((H, W, halo), (H // 2, W // 2, halo // 2),
                                     (H // 2, W // 2, halo // 2)))
        _, e = check("K3 gather_windows_yuv",
                     lambda: cp.gather_windows_yuv(ring, slot, mx, my, halo),
                     lambda: cp.gather_windows_yuv_plain(ring, slot, mx, my,
                                                         halo), label)
        errs["K3"] = max(errs["K3"], e)
        _, e = check("K4 pred_planes",
                     lambda: cp.pred_planes(*ring, *per_mb, halo=halo),
                     lambda: cp.pred_planes_plain(*ring, *per_mb, halo=halo),
                     label)
        errs["K4"] = max(errs["K4"], e)
    log("K1-K4: equal to the plain versions at a tile's halo'd shapes "
        "(1088 x (480 + 64) luma), margins real and zeroed")
    return errs


# integer operations of one evaluation of the deblock filter (one edge at
# one row or column: the threshold tests, the sums and divisions of the
# strength-2 or strength-1 branch, the selects), an estimate from
# deblock.cu's filter
FILTER_OPS = 80


def phase_kernels_deblock(torch, gpu):
    """K8 against its plain version at 1080p and at the edge cases, twice,
    inputs unchanged; returns the kernel's record (times at 1080p)."""
    from util_deblock import KINDS, SIZES, TILE_SIZES, deblock_case

    cd, plain = gpu["cuda_deblock"], gpu["deblock"].deblock_frame
    H, W = 1088, 1920

    def on_card(kind, h, w):
        return tuple(torch.as_tensor(a).cuda()
                     for a in deblock_case(kind, h, w, seed=SEED))

    cases = [(f"mixed {W}x{H}", on_card("mixed", H, W))]
    cases += [(f"{kind} {w}x{h}", on_card(kind, h, w))
              for h, w in SIZES + TILE_SIZES for kind in KINDS]
    err = 0
    for label, args in cases:
        before = tuple(a.clone() for a in args)
        runs = [cd.deblock_frame(*args) for _ in range(2)]
        torch.cuda.synchronize()
        compare(torch, f"K8 deblock_frame ({label}, second run)", runs[1],
                runs[0])
        err = max(err, compare(torch, f"K8 deblock_frame ({label})",
                               runs[0], plain(*args)))
        compare(torch, f"K8 deblock_frame ({label}, its inputs)", args,
                before)
    log(f"K8: two runs identical, equal to the plain version and the inputs "
        f"unchanged on {len(cases)} cases ({W}x{H}; "
        f"{', '.join(f'{w}x{h}' for h, w in SIZES + TILE_SIZES)} x "
        f"{', '.join(KINDS)})")
    args = cases[0][1]
    # every edge filtered once per row (vertical) or column (horizontal):
    # Y's at 8-px cells, U's and V's at 8-px cells of the half planes
    filters = sum((pw // 8 - 1) * ph + (ph // 8 - 1) * pw
                  for ph, pw in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))
    n = (H // 16) * (W // 16)
    return dict(
        ms=cuda_ms(torch, lambda: cd.deblock_frame(*args), 10),
        device_ms=device_ms(torch, lambda: cd.deblock_frame(*args),
                            "deblock_kernel"),
        plain_ms=cuda_ms(torch, lambda: plain(*args), 3),
        # three int32 planes read and written once, the copy flags and the
        # int32 q map read once
        bytes=H * W * 3 // 2 * 4 * 2 + n * (1 + 4),
        ops=filters * FILTER_OPS, max_abs_err=err)


def unpack_outputs(out):
    """K12's outputs as one flat tuple: the planes, or the blocks and
    self_sad."""
    return out if len(out) == 3 else (*out[0], out[1])


def phase_kernels_unpack(torch, np, gpu, H=1088, W=1920):
    """K12 in both layouts against its plain versions at 1920x1088: on
    phase 5's first inter frame's 5-bit wire and on its exception section
    rewritten as the card tests rewrite it (the plain version reads the
    wire without the entries a later one overrides), each twice; returns
    its record, the times of the blocks layout (the conformance step's)
    and of the planes layout under planes_*."""
    from cairo_tpu_torch import native
    from cairo_tpu_torch.synth import synth_frames
    from util_wire import CASES, last_entries_only, rewritten

    wire = gpu["wire"]
    frame = synth_frames(1920, 1080, 2, seed=SEED % 991)[1]
    kind, w5 = native.rgb_to_yuv5d(frame, W, H, 1, 16)
    if kind != "yuv5d":
        fail(f"K12: the 1080p frame packed as {kind}, not the 5-bit wire")
    layouts = (("planes_", wire.unpack_yuv5d, wire.unpack_yuv5d_plain),
               ("", wire.unpack_yuv5d_blocks, wire.unpack_yuv5d_blocks_plain))
    err = 0
    for i, case in enumerate(CASES):
        raw = rewritten(w5, W, H, case, seed=i)
        buf = torch.from_numpy(raw[8:]).cuda()
        ref = torch.from_numpy(last_entries_only(raw, W, H)[8:]).cuda()
        for pre, fn, plain in layouts:
            label = f"K12 {pre or 'blocks_'}{case}"
            before = wire.LAUNCHES["unpack_yuv5d"]
            runs = [unpack_outputs(fn(buf, H, W, 1920, 1080))
                    for _ in range(2)]
            torch.cuda.synchronize()
            launched = wire.LAUNCHES["unpack_yuv5d"] - before
            if launched != 2:
                fail(f"{label}: {launched} launches for 2 calls")
            compare(torch, f"{label}, second run", runs[1], runs[0])
            err = max(err, compare(torch, label, runs[0], unpack_outputs(
                plain(ref, H, W, 1920, 1080))))
    log(f"K12: both layouts exact and the same on two runs over "
        f"{len(CASES)} exception sections at {W}x{H}")
    buf = torch.from_numpy(w5[8:]).cuda()
    fields = H * W * 3 // 2
    rec = dict(max_abs_err=err,
               # a field's extraction, its add in the scan, the mask
               ops=10 * fields)
    for pre, fn, plain in layouts:
        call = functools.partial(fn, buf, H, W, 1920, 1080)
        rec[pre + "ms"] = cuda_ms(torch, call, 10)
        rec[pre + "device_ms"] = device_ms(torch, call, "unpack_yuv5d_kernel")
        rec[pre + "plain_ms"] = cuda_ms(
            torch, functools.partial(plain, buf, H, W, 1920, 1080), 3)
        # the wire read once, the int32 samples (and self_sad) written once
        rec[pre + "bytes"] = (buf.numel() + 4 * fields
                              + (0 if pre else 4 * (H // 16) * (W // 16)))
    return rec


def phase_kernels_conformance(torch, np, gpu, H=1088, W=1920):
    """K4 at pads 33/17, K5 and K6 against their plain versions at the
    conformance path's shapes; returns per-kernel records."""
    cp, ci, cw = gpu["cuda_pred"], gpu["cuda_inter"], gpu["cuda_wave"]
    ops = gpu["ops"]
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)
    hb, wb = H // 16, W // 16
    n = hb * wb

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev, dtype)

    def blocks(y, u, v):
        return (ops.plane_to_blocks(y, 16).contiguous(),
                ops.plane_to_blocks(u, 8).contiguous(),
                ops.plane_to_blocks(v, 8).contiguous())

    recs = {}

    # ---- K4 at the wide pads: every slot, |mv| up to 31 (40 clamps),
    # sub-pel both amounts, intra zeroing
    ring = tuple(t(rng.integers(-300, 560, (4,) + s), torch.int16)
                 for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))
    mx = t(rng.integers(-31, 32, n), torch.int32)
    my = t(rng.integers(-31, 32, n), torch.int32)
    mx[:64] = 40
    my[64:128] = -40
    args = (*ring, t(rng.integers(0, 4, n), torch.int32), mx, my,
            t(rng.random(n) < 0.5, torch.bool),
            t(rng.random(n) < 0.5, torch.bool),
            t(rng.integers(0, 8, n), torch.int32),
            t(rng.random(n) < 0.2, torch.bool),
            cp.WIDE_YPAD, cp.WIDE_CPAD)
    got = cp.pred_planes(*args)
    torch.cuda.synchronize()
    k4_err = compare(torch, "K4 pred_planes (33/17)", got,
                     cp.pred_planes_plain(*args))
    log("K4 at 33/17: equal to the plain version")
    recs["K4w"] = dict(
        ms=cuda_ms(torch, lambda: cp.pred_planes(*args), 10),
        device_ms=device_ms(torch, lambda: cp.pred_planes(*args),
                            "pred_planes_kernel"),
        plain_ms=cuda_ms(torch, lambda: cp.pred_planes_plain(*args), 3),
        bytes=pred_planes_bytes(args, H, W), ops=0, max_abs_err=k4_err)

    # ---- K5: frame index 3, so offsets 1, 2, 3 read slots 2, 1, 0
    hdr = torch.tensor([3, 16], dtype=torch.int32, device=dev)
    src_p = (t(rng.integers(16, 236, (H, W)), torch.int32),
             t(rng.integers(16, 240, (H // 2, W // 2)), torch.int32),
             t(rng.integers(16, 240, (H // 2, W // 2)), torch.int32))
    src = blocks(*src_p)

    def shifted_ring(noise_hi):
        planes = []
        for i, p in enumerate(src_p):
            slots = []
            for dy, dx in ((3, -5), (-9, 14), (20, -26), (0, 0)):
                if i:
                    dy, dx = dy // 2, dx // 2
                r = torch.roll(p, (dy, dx), (0, 1))
                slots.insert(0, r + t(rng.integers(-noise_hi, noise_hi + 1,
                                                   r.shape), torch.int32))
            planes.append(torch.stack(slots).to(torch.int16).contiguous())
        return tuple(planes)

    def flat(level):
        return tuple(torch.full((4,) + p.shape, level, dtype=torch.int16,
                                device=dev) for p in src_p)

    flat_src = blocks(*(torch.full_like(p, 128) for p in src_p))
    overshoot = tuple(t(rng.integers(-300, 560, (4,) + p.shape),
                        torch.int16) for p in src_p)
    cases = (("shifted", src, shifted_ring(2)),
             ("copy-grade shifts", src, shifted_ring(0)),
             ("flat ties at SAD 0", flat_src, flat(128)),
             ("flat ties at SAD 8192", flat_src, flat(96)),
             ("overshoot", src, overshoot))
    k5_err = 0
    for label, s_blocks, r in cases:
        got = ci.inter_search(s_blocks, r, hdr)
        torch.cuda.synchronize()
        want = ci.inter_search_plain(s_blocks, r, hdr)
        k5_err = max(k5_err, compare(
            torch, f"K5 inter_search ({label})",
            tuple(got[k].to(torch.int32) for k in ci.FIELDS),
            tuple(want[k].to(torch.int32) for k in ci.FIELDS)))
    ring5 = cases[0][2]
    again = ci.inter_search(src, ring5, hdr)
    first = ci.inter_search(src, ring5, hdr)
    torch.cuda.synchronize()
    compare(torch, "K5 inter_search (shifted, second run)",
            tuple(again[k].to(torch.int32) for k in ci.FIELDS),
            tuple(first[k].to(torch.int32) for k in ci.FIELDS))
    log("K5: equal to the plain version on " +
        ", ".join(c[0] for c in cases) + "; two runs identical")
    # the searches the timed input needs in full: a co-located MAD under
    # the threshold freezes the MB, and the search stops there
    thr = (int(hdr[1]) >> 2) + 1
    frozen = 0
    for off in range(1, 4):
        co = [ops.plane_to_blocks(p[(int(hdr[0]) - off) % 4].to(torch.int32),
                                  b) for p, b in zip(ring5, (16, 8, 8))]
        mad = torch.stack([(a - c).abs().amax(dim=(1, 2))
                           for a, c in zip(src, co)]).amax(0)
        frozen += int((mad < thr).sum())
    recs["K5"] = dict(
        ms=cuda_ms(torch, lambda: ci.inter_search(src, ring5, hdr), 10),
        device_ms=device_ms(torch, lambda: ci.inter_search(src, ring5, hdr),
                            "inter_search_kernel"),
        plain_ms=cuda_ms(torch, lambda: ci.inter_search_plain(src, ring5,
                                                              hdr), 3),
        frozen=frozen / (3 * n),
        # source blocks, three reference slots, nine int32 fields out
        bytes=n * 384 * 4 + 3 * H * W * 3 // 2 * 2 + 9 * n * 4,
        # per MB and reference the co-located candidate and, unless it
        # freezes the MB, 5 rings of 8 (each ring's centre is the
        # ring-entry best, whose metrics are known) and 16 sub-pel blends:
        # 384 abs-diffs each
        ops=(3 * n + (3 * n - frozen) * 56) * 384, max_abs_err=k5_err)

    # ---- K6: an intra and an inter pass over the current slot (slot 3)
    self_sad = src[0].abs().sum(dim=(1, 2), dtype=torch.int32)
    best = ci.inter_search(src, ring5, hdr)
    state = dict(ring_y=ring5[0], ring_u=ring5[1], ring_v=ring5[2])
    pred = gpu["wavefront"].wide_gather_pred(
        state, hdr[0], best["target"], best["motion_x"], best["motion_y"],
        best["sp_pred"], best["sp_amount"], best["sp_index"],
        torch.zeros_like(best["is_intra"]))
    cur = tuple(p[3] for p in ring5)
    k6_err = 0
    plain_s = {}

    def flat_out(o):
        return (*o[:3], *(o[3][k] for k in cw.DESC_FIELDS), *o[4])

    for label, inter in (("intra", None), ("inter", (best, pred))):
        kw = dict(is_inter=inter is not None)
        ib, ip = inter if inter else (None, None)
        got = cw.wave_pass(src, self_sad, ib, ip, *cur, hdr[1], **kw)
        again = cw.wave_pass(src, self_sad, ib, ip, *cur, hdr[1], **kw)
        torch.cuda.synchronize()
        compare(torch, f"K6 wave_pass ({label}, second run)",
                flat_out(again), flat_out(got))
        t0 = time.perf_counter()
        want = cw.wave_pass_plain(src, self_sad, ib, ip, *cur, hdr[1], **kw)
        torch.cuda.synchronize()
        plain_s[label] = time.perf_counter() - t0
        k6_err = max(k6_err, compare(torch, f"K6 wave_pass ({label})",
                                     flat_out(got), flat_out(want)))
    log(f"K6: two runs identical and equal to the plain version on an intra "
        f"and an inter pass at {W}x{H} (plain {plain_s['intra']:.1f} s and "
        f"{plain_s['inter']:.1f} s)")
    ib, ip = best, pred
    recs["K6"] = dict(
        ms=cuda_ms(torch, lambda: cw.wave_pass(src, self_sad, ib, ip, *cur,
                                               hdr[1], is_inter=True), 10),
        device_ms=device_ms(torch, lambda: cw.wave_pass(
            src, self_sad, ib, ip, *cur, hdr[1], is_inter=True),
            "wave_kernel"),
        plain_ms=cuda_ms(torch, lambda: cw.wave_pass_plain(
            src, self_sad, ib, ip, *cur, hdr[1], is_inter=True), 3),
        # the longest chain of dependent MBs: wb + 3 (hb - 1) steps
        steps=wb + cw.SKEW * (hb - 1),
        # source and prediction blocks, self-SAD, K5's nine fields, the
        # current slot read (int16) and the reconstruction written
        # (int32), eleven int32 fields and int16 coefficient blocks out
        bytes=n * (384 * 4 * 2 + 4 + 9 * 4 + 11 * 4 + 384 * 2)
        + H * W * 3 // 2 * (2 + 4),
        # per MB: 61 intra candidates (5 rings of 9, 16 sub-pel) of 384
        # abs-diffs, and four 8-term passes over 384 coefficients
        ops=n * (61 * 384 + 4 * 384 * 8), max_abs_err=k6_err)
    return recs


def wave_decode_work(args):
    """(bytes, operations) K7 must move and do for wave_decode(*args): per
    member its 384 samples read (a sub-pel neighbour is the next
    sample's base, as for K4), its int32 residual and six int32 fields,
    its 384 int16 samples written; the schedule rows in use (bi and bj,
    int16). Per sample a residual add and wrap, and a blend for sub-pel
    members: counted as 4 operations."""
    bi, n_active, n_members = args[4], args[6], args[7]
    p = bi.shape[1]
    return (n_members * (384 * (2 + 4 + 2) + 6 * 4) + n_active * p * 4,
            n_members * 384 * 4)


def phase_kernels_wave_decode(torch, np, gpu):
    """K7 against its plain version on the arguments the wavefront decode
    of a 1080p conformance stream gives it; returns the kernel's record."""
    from cairo_tpu_torch.synth import synth_frames

    api, cwd = gpu["api"], gpu["cuda_wavedec"]
    enc = api.ConformanceGpuEncoder()
    enc.set_quality(16)
    chunks = [enc.encode(f)
              for f in synth_frames(1920, 1080, 2, seed=SEED % 983)]
    calls, frame = {}, [0]
    kernel = cwd.wave_decode

    def record(planes, *rest):
        calls[frame[0]] = (tuple(p.clone() for p in planes), *rest)
        return kernel(planes, *rest)

    dec = api.GpuDecoder()
    cwd.wave_decode = record
    try:
        for i, c in enumerate(chunks):
            frame[0] = i
            dec.decode(c)
    finally:
        cwd.wave_decode = kernel
    torch.cuda.synchronize()
    if dec.host_frames or sorted(calls) != [0, 1]:
        fail(f"K7: launched on frames {sorted(calls)} of the 1080p "
             f"conformance stream, not on its intra and inter frame "
             f"({dec.host_frames} host frames)")

    def fresh(args):
        return (tuple(p.clone() for p in args[0]), *args[1:])

    err, chains, steps = 0, {}, {}
    for i, args in sorted(calls.items()):
        want = cwd.wave_decode_plain(*fresh(args))
        runs = []
        for _ in range(2):
            before = cwd.LAUNCHES["wave_decode"]
            runs.append(kernel(*fresh(args)))
            if cwd.LAUNCHES["wave_decode"] - before != 1:
                fail(f"K7: {cwd.LAUNCHES['wave_decode'] - before} launches "
                     f"for frame {i} (one per frame expected)")
        torch.cuda.synchronize()
        compare(torch, f"K7 wave_decode (frame {i}, second run)", runs[1],
                runs[0])
        err = max(err, compare(torch, f"K7 wave_decode (frame {i})",
                               runs[0], want))
        h, w = args[0][0].shape
        chains[i] = cwd.dependency_chain(*args[3:7], h, w)
        # the ticket window's model: steps with 1, 2 and 4 blocks an SM
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        steps[i] = {k * sms: cwd.dependency_chain(*args[3:7], h, w, k * sms)
                    for k in (1, 2, 4)}
    log("K7: two runs identical and equal to the plain version at 1920x1080, "
        "one launch each, on " + ", ".join(
            f"frame {i} ({a[6]} waves, {a[7]} members, longest chain "
            f"{chains[i]}, modelled steps by grid {steps[i]})"
            for i, a in sorted(calls.items())))

    def timed(args, chain):
        scratch = fresh(args)
        nbytes, ops = wave_decode_work(args)
        dev_ms = device_ms(torch, lambda: kernel(*scratch),
                           "wave_decode_kernel")
        return dict(
            ms=cuda_ms(torch, lambda: kernel(*scratch), 10),
            device_ms=dev_ms,
            plain_ms=cuda_ms(torch, lambda: cwd.wave_decode_plain(*scratch),
                             3),
            bytes=nbytes, ops=ops, waves=args[6], members=args[7],
            launches_per_frame=1, chain=chain,
            us_per_chain_step=dev_ms * 1e3 / chain)

    rec = timed(calls[1], chains[1])
    rec["max_abs_err"] = err
    rec.update({f"intra_{k}": v
                for k, v in timed(calls[0], chains[0]).items()})
    return rec


def phase_conformance(torch, np, gpu):
    """The conformance path at 1080p; returns (launch counts, summary)."""
    from cairo_tpu_torch import native
    from cairo_tpu_torch.cpuref import imaging, stream
    from cairo_tpu_torch.synth import synth_frames

    api = gpu["api"]
    frames = synth_frames(1920, 1080, 3, seed=SEED % 991)
    counters = (gpu["cuda_pred"].LAUNCHES, gpu["cuda_inter"].LAUNCHES,
                gpu["cuda_wave"].LAUNCHES, gpu["cuda_wavedec"].LAUNCHES,
                gpu["cuda_deblock"].LAUNCHES, gpu["cuda_tail"].LAUNCHES,
                gpu["wire"].LAUNCHES)
    k8, tail, k12 = counters[4], counters[5], counters[6]
    for c in counters:
        for k in c:
            c[k] = 0
    enc = api.ConformanceGpuEncoder()
    enc.set_quality(16)
    chunks, recons, enc_s, stages = [], [], [], {}
    for i, f in enumerate(frames):
        before, unpacked = k8["deblock_frame"], k12["unpack_yuv5d"]
        t0 = time.perf_counter()
        chunks.append(enc.encode(f))
        torch.cuda.synchronize()
        enc_s.append(time.perf_counter() - t0)
        launched_once("conformance path", f"encoded frame {i}", k8, before,
                      "deblock_frame", "K8")
        launched_once("conformance path", f"encoded frame {i}", k12,
                      unpacked, "unpack_yuv5d", "K12")
        for k, v in enc.last_stats["stage_ms"].items():
            stages.setdefault(k, []).append(v)
        meta, arrays = enc.state_dict()
        slot = (meta["frame_index"] - 1) % 4
        recons.append(imaging.yuv420_to_rgb(
            arrays["ring_y"][slot], arrays["ring_u"][slot],
            arrays["ring_v"][slot], meta["width"], meta["height"]))
    dec = api.GpuDecoder()
    outs, dec_s, waves = [], [], []
    for i, c in enumerate(chunks):
        before, k8_before = counters[3]["wave_decode"], k8["deblock_frame"]
        k11 = tail["decode_tail"]
        t0 = time.perf_counter()
        outs.append(dec.decode(c))
        torch.cuda.synchronize()
        dec_s.append(time.perf_counter() - t0)
        launched_once("conformance path", f"decoded frame {i}", k8,
                      k8_before, "deblock_frame", "K8")
        launched_once("conformance path", f"decoded frame {i}", tail, k11,
                      "decode_tail", "K11")
        waves.append((dec.last_stats.get("waves"),
                      dec.last_stats.get("members")))
        k7 = counters[3]["wave_decode"] - before
        if k7 != int(bool(waves[-1][0])):
            fail(f"conformance path: frame {i} ({waves[-1][0]} waves) "
                 f"launched K7 {k7} times (once per wave-path frame "
                 f"expected)")
    launches = {"pred_planes_wide": counters[0]["pred_planes_wide"],
                "inter_search": counters[1]["inter_search"],
                "wave_pass": counters[2]["wave_pass"],
                **counters[3], **k8, "decode_tail": tail["decode_tail"],
                **k12}
    if tail["encode_tail"]:
        fail(f"conformance path: K10 launched {tail['encode_tail']} times "
             f"(the conformance encoder's tail is K6's)")
    if launches["wave_pass"] != len(frames):
        fail(f"conformance path: {launches['wave_pass']} K6 launches for "
             f"{len(frames)} frames (one wave pass each expected)")
    if dec.host_frames:
        fail(f"conformance path: {dec.host_frames} frames took the host "
             f"decoder")
    for i, (o, r, h) in enumerate(zip(outs, recons, host_decode(
            np, native, stream, chunks))):
        if not np.array_equal(o, r):
            fail(f"conformance path: decoded frame {i} differs from the "
                 f"encoder's reconstruction")
        if not np.array_equal(o, h):
            fail(f"conformance path: frame {i} differs from the native C++ "
                 f"decoder")
    for name, count in launches.items():
        if count == 0:
            fail(f"conformance path: kernel {name} was never launched")
    mse = float(np.mean([np.mean((r.astype(np.float64) - f) ** 2)
                         for r, f in zip(recons, frames)]))
    summary = dict(
        frames=len(frames), host_frames=dec.host_frames,
        inter_encode_fps=(len(frames) - 1) / sum(enc_s[1:]),
        inter_decode_fps=(len(frames) - 1) / sum(dec_s[1:]),
        encode_ms=[round(s * 1e3, 1) for s in enc_s],
        decode_ms=[round(s * 1e3, 1) for s in dec_s],
        waves_members=waves,
        psnr_db=10 * np.log10(255.0 ** 2 / max(1e-9, mse)),
        kbits_per_frame=sum(len(c) for c in chunks) * 8 / len(chunks) / 1000,
        stage_ms={k: [round(x, 1) for x in v] for k, v in stages.items()})
    return launches, summary


def phase_conformance_cpu_vs_card(gpu):
    from cairo_tpu_torch.synth import synth_frames

    import numpy as np

    api = gpu["api"]
    for q in (4, 16, 29):
        frames = synth_frames(176, 144, 3, seed=SEED % 997 + q)
        cpu = api.ConformanceGpuEncoder(device="cpu")
        card = api.ConformanceGpuEncoder()
        cpu_dec, card_dec = api.GpuDecoder(device="cpu"), api.GpuDecoder()
        for enc in (cpu, card):
            enc.set_quality(q)
        for i, f in enumerate(frames):
            a, b = cpu.encode(f), card.encode(f)
            if a != b:
                fail(f"conformance: CPU and card chunks differ at q{q} frame "
                     f"{i} ({len(a)} vs {len(b)} bytes)")
            if not np.array_equal(cpu_dec.decode(a), card_dec.decode(a)):
                fail(f"conformance: CPU and card decodes differ at q{q} "
                     f"frame {i}")
        if cpu_dec.host_frames or card_dec.host_frames:
            fail(f"conformance: q{q} frames took the host decoder "
                 f"(CPU {cpu_dec.host_frames}, card {card_dec.host_frames})")


# the kernels each pipelined path launches: (encoder, LAUNCHES keys)
PIPELINE_PATHS = {
    "fast": ("GpuEncoder", ("chroma_max_maps", "dense_select",
                            "gather_windows", "pred_planes",
                            "deblock_frame", "subpel_scan", "encode_tail",
                            "decode_tail", "unpack_yuv5d")),
    "conformance": ("ConformanceGpuEncoder", (
        "pred_planes_wide", "inter_search", "wave_pass", "wave_decode",
        "deblock_frame", "decode_tail", "unpack_yuv5d"))}


def measure_pipelined(api, frames, warm, path, quality=16, device="cuda",
                      counters=()):
    """One path ("fast" or "conformance") pipelined and as a loop: its
    encoder's encode_many over `frames`, then GpuDecoder.decode_many over
    the chunks; then new instances over the same frames through a loop
    over encode and decode. Counted as bench.py counts them: the seconds
    between successive yields (or returns), summed over the frames after
    the first `warm`. Beside the stages, the wall and thread CPU ms of
    each dispatch (main thread) and finish (a worker when pipelined):
    where a pipelined frame's interval goes. The launch counts in
    `counters` (LAUNCHES dicts) are set to 0 just before the pipelined
    run and read just after it. Returns one flat record; its keys start
    with the path's name."""
    import hashlib

    import numpy as np

    enc_cls = getattr(api, PIPELINE_PATHS[path][0])

    def timed(obj, name, key, threads):
        fn = getattr(obj, name)

        def run(*args, **kwargs):
            wall, cpu = time.perf_counter(), time.thread_time()
            try:
                return fn(*args, **kwargs)
            finally:
                threads.setdefault(key, []).append(
                    time.perf_counter() - wall)
                threads.setdefault(key + "_cpu", []).append(
                    time.thread_time() - cpu)
        setattr(obj, name, run)

    def run(encode, decode):
        enc, dec = enc_cls(device=device), api.GpuDecoder(device=device)
        enc.set_quality(quality)
        out = dict(chunks=[], rgb=[], enc_s=[], dec_s=[], enc_stages=[],
                   dec_stages=[], threads={})
        for obj, name, key in ((enc, "_dispatch", "encode_dispatch"),
                               (enc, "_finish", "encode_finish"),
                               (dec, "_dispatch_decode", "decode_dispatch"),
                               (dec, "_finish_decode", "decode_finish")):
            timed(obj, name, key, out["threads"])
        for items, key, s_key, st_key, obj in (
                (lambda: encode(enc), "chunks", "enc_s", "enc_stages", enc),
                (lambda: decode(dec, out["chunks"]), "rgb", "dec_s",
                 "dec_stages", dec)):
            t0 = time.perf_counter()
            for i, item in enumerate(items()):
                t1 = time.perf_counter()
                out[key].append(item)
                out[s_key].append(t1 - t0)
                if i >= warm:
                    out[st_key].append(
                        dict((obj.last_stats or {}).get("stage_ms", {})))
                t0 = t1
        out["host_frames"] = dec.host_frames
        return out

    for c in counters:
        for k in c:
            c[k] = 0
    piped = run(lambda enc: enc.encode_many(frames),
                lambda dec, chunks: dec.decode_many(chunks))
    launches = {k: v for c in counters for k, v in c.items()}
    loop = run(lambda enc: (enc.encode(f) for f in frames),
               lambda dec, chunks: (dec.decode(c) for c in chunks))

    def fps(seconds):
        return (len(frames) - warm) / sum(seconds[warm:])

    def medians(stages):
        return {k: float(np.median([s[k] for s in stages if k in s]))
                for k in (stages[0] if stages else {})}

    def thread_ms(threads):
        return {k: 1e3 * float(np.median(v[warm:]))
                for k, v in threads.items()}

    def sha(items):
        h = hashlib.sha256()
        for item in items:
            h.update(bytes(item) if isinstance(item, bytes)
                     else item.tobytes())
        return h.hexdigest()

    return {
        f"{path}_frames": len(frames), f"{path}_warm": warm,
        f"{path}_encode_fps": fps(piped["enc_s"]),
        f"{path}_encode_loop_fps": fps(loop["enc_s"]),
        f"{path}_decode_fps": fps(piped["dec_s"]),
        f"{path}_decode_loop_fps": fps(loop["dec_s"]),
        f"{path}_encode_stage_ms": medians(piped["enc_stages"]),
        f"{path}_encode_loop_stage_ms": medians(loop["enc_stages"]),
        f"{path}_decode_stage_ms": medians(piped["dec_stages"]),
        f"{path}_decode_loop_stage_ms": medians(loop["dec_stages"]),
        f"{path}_threads_ms": thread_ms(piped["threads"]),
        f"{path}_loop_threads_ms": thread_ms(loop["threads"]),
        f"{path}_stream_sha256": sha(piped["chunks"]),
        f"{path}_rgb_sha256": sha(piped["rgb"]),
        f"{path}_chunks_equal_loop": piped["chunks"] == loop["chunks"],
        f"{path}_rgb_equal_loop": all(
            np.array_equal(a, b) for a, b in zip(piped["rgb"], loop["rgb"]))
        and len(piped["rgb"]) == len(loop["rgb"]) == len(frames),
        f"{path}_host_frames": piped["host_frames"] + loop["host_frames"],
        f"{path}_launches": launches}


def phase_pipelined(gpu, smi):
    """Phase 7: both paths pipelined against their loops at 1920x1080 q16
    (fast: 2 + 20 frames, conformance: 2 + 8); returns the records."""
    from cairo_tpu_torch.synth import synth_frames

    frames = synth_frames(1920, 1080, 22, seed=SEED % 983)
    counters = [gpu[m].LAUNCHES for m in (
        "cuda_motion", "cuda_pred", "cuda_inter", "cuda_wave",
        "cuda_wavedec", "cuda_deblock", "cuda_tail", "wire")]
    recs = {}
    for path, n in (("fast", 22), ("conformance", 10)):
        t0 = time.perf_counter()
        rec = measure_pipelined(gpu["api"], frames[:n], 2, path,
                                counters=counters)
        if not rec[f"{path}_chunks_equal_loop"]:
            fail(f"phase 7: {path} encode_many chunks differ from the loop's")
        if not rec[f"{path}_rgb_equal_loop"]:
            fail(f"phase 7: {path} decode_many RGB differs from the loop's")
        if rec[f"{path}_host_frames"]:
            fail(f"phase 7: {path}: {rec[f'{path}_host_frames']} frames "
                 f"took the host decoder")
        for name in PIPELINE_PATHS[path][1]:
            if not rec[f"{path}_launches"][name]:
                fail(f"phase 7: {path} pipelined run never launched {name}")
        k9 = rec[f"{path}_launches"]["subpel_scan"]
        if path == "fast" and k9 != n - 1:
            fail(f"phase 7: the fast pipelined run launched K9 {k9} times for "
                 f"{n - 1} inter frames (once a frame expected)")
        k10 = rec[f"{path}_launches"]["encode_tail"]
        if path == "fast" and k10 != n:
            fail(f"phase 7: the fast pipelined run launched K10 {k10} times "
                 f"for {n} encoded frames (once a frame expected)")
        k11 = rec[f"{path}_launches"]["decode_tail"]
        if k11 != n:
            fail(f"phase 7: the {path} pipelined run launched K11 {k11} times "
                 f"for {n} decoded frames (once a frame expected)")
        k12 = rec[f"{path}_launches"]["unpack_yuv5d"]
        if k12 != n:
            fail(f"phase 7: the {path} pipelined run launched K12 {k12} times "
                 f"for {n} encoded frames (once a frame expected)")
        log(f"phase 7: {path} 1920x1080 q16, {n - 2} measured frames after "
            f"2 on {smi}: encode_many {rec[f'{path}_encode_fps']:.3f} fps "
            f"(loop {rec[f'{path}_encode_loop_fps']:.3f}), decode_many "
            f"{rec[f'{path}_decode_fps']:.3f} fps (loop "
            f"{rec[f'{path}_decode_loop_fps']:.3f}); stage medians (ms) "
            f"encode {rec[f'{path}_encode_stage_ms']} (loop "
            f"{rec[f'{path}_encode_loop_stage_ms']}), decode "
            f"{rec[f'{path}_decode_stage_ms']} (loop "
            f"{rec[f'{path}_decode_loop_stage_ms']}); dispatch and finish "
            f"wall and thread CPU ms {rec[f'{path}_threads_ms']} (loop "
            f"{rec[f'{path}_loop_threads_ms']}); pipelined launches "
            f"{rec[f'{path}_launches']}; {time.perf_counter() - t0:.1f} s")
        recs.update(rec)
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


def launched_once(path, frame, counts, before, name, kernel):
    """Fails unless counts[name] (kernel `kernel`) went up by exactly one
    since `before`."""
    if counts[name] - before != 1:
        fail(f"{path}: {frame} launched {kernel} {counts[name] - before}"
             f" times (once per frame expected)")


def phase_main(torch, np, gpu):
    """The main path at 1080p; returns (launch counts, summary dict)."""
    from cairo_tpu_torch import native
    from cairo_tpu_torch.cpuref import stream
    from cairo_tpu_torch.synth import synth_frames

    api = gpu["api"]
    frames = synth_frames(1920, 1080, 5, seed=SEED % 1000)
    k8, tail = gpu["cuda_deblock"].LAUNCHES, gpu["cuda_tail"].LAUNCHES
    k12 = gpu["wire"].LAUNCHES
    for mod in (gpu["cuda_motion"], gpu["cuda_pred"], gpu["cuda_deblock"],
                gpu["cuda_tail"], gpu["wire"]):
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    enc = api.GpuEncoder()
    enc.set_quality(16)
    chunks, recons, enc_s, stages = [], [], [], {}
    for i, f in enumerate(frames):
        before, k10 = k8["deblock_frame"], tail["encode_tail"]
        unpacked = k12["unpack_yuv5d"]
        t0 = time.perf_counter()
        chunks.append(enc.encode(f))
        torch.cuda.synchronize()
        enc_s.append(time.perf_counter() - t0)
        launched_once("main path", f"encoded frame {i}", k8, before,
                      "deblock_frame", "K8")
        launched_once("main path", f"encoded frame {i}", tail, k10,
                      "encode_tail", "K10")
        launched_once("main path", f"encoded frame {i}", k12, unpacked,
                      "unpack_yuv5d", "K12")
        recons.append(enc.peek_destination())
        for k, v in enc.last_stats["stage_ms"].items():
            stages.setdefault(f"encode.{k}", []).append(v)
    dec = api.GpuDecoder()
    outs, dec_s = [], []
    for i, c in enumerate(chunks):
        before, k11 = k8["deblock_frame"], tail["decode_tail"]
        t0 = time.perf_counter()
        outs.append(dec.decode(c))
        torch.cuda.synchronize()
        dec_s.append(time.perf_counter() - t0)
        launched_once("main path", f"decoded frame {i}", k8, before,
                      "deblock_frame", "K8")
        launched_once("main path", f"decoded frame {i}", tail, k11,
                      "decode_tail", "K11")
        for k, v in dec.last_stats.get("stage_ms", {}).items():
            stages.setdefault(f"decode.{k}", []).append(v)
    launches = {**gpu["cuda_motion"].LAUNCHES,
                **{k: gpu["cuda_pred"].LAUNCHES[k]
                   for k in ("gather_windows", "pred_planes")}, **k8,
                **tail, **k12}

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
    if launches["gather_windows"] != launches["dense_select"]:
        fail(f"main path: {launches['gather_windows']} K3 launches for "
             f"{launches['dense_select']} reference searches (one three-plane "
             f"launch each expected)")
    if launches["subpel_scan"] != len(frames) - 1:
        fail(f"main path: {launches['subpel_scan']} K9 launches for "
             f"{len(frames) - 1} fast inter frames (one a frame, for all "
             f"{REFS} references, expected)")
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


def moving_frames(width, height, n, seed=3, shift=5):
    """Textured frames whose content rolls `shift` px right a frame, with a
    patch that changes in place (tests/test_tiled.py's content)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (height, width, 3), np.uint8)
    yy, xx = np.mgrid[0:height, 0:width]
    base[..., 0] = (128 + 90 * np.sin(xx * 0.11) * np.cos(yy * 0.07)
                    ).astype(np.uint8)
    frames = []
    for t in range(n):
        f = np.roll(base, t * shift, axis=1).copy()
        f[10:30, 10:40] = (20 * t) % 200
        frames.append(np.ascontiguousarray(f))
    return frames


# the kernels of the tiled path, by LAUNCHES key: K1-K4 read the halo
TILED_HALO_KERNELS = ("chroma_max_maps", "dense_select", "gather_windows",
                      "pred_planes")


def traced_kernels(torch, fn):
    """(launches, device ms) of every CUDA kernel in a torch.profiler
    trace of fn()."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    return (sum(e.count for e in events),
            sum(getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
                for e in events) / 1e3)


def phase_tiled(torch, np, gpu, smi):
    """Phase 8: the tiled path at 1080p on one card; returns (launches by
    kernel over the phase, summary)."""
    from cairo_tpu_torch.blocktypes import MOTION_BIT

    tiled, api = gpu["tiled"], gpu["api"]
    mods = (gpu["cuda_motion"], gpu["cuda_pred"], gpu["cuda_deblock"],
            gpu["cuda_tail"])
    total = {}
    summary = {}

    def reset():
        for mod in mods:
            for counts in (mod.LAUNCHES, getattr(mod, "HALO_LAUNCHES", {})):
                for k in counts:
                    counts[k] = 0

    def launched(label, searches, encodes, decodes):
        """Fails unless K1-K4 (with the halo) and K8 launched since reset(),
        K9 once per tile of each of the `searches` inter tile frames (for
        all their references), K10 once per tile of each of the `encodes`
        tile frames and K11 once per tile of each of the `decodes`; adds
        the counts to the phase's."""
        counts = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
        halo = {k: v for mod in mods[:2]
                for k, v in mod.HALO_LAUNCHES.items()}
        for name in TILED_HALO_KERNELS + ("deblock_frame",):
            if counts[name] == 0:
                fail(f"phase 8 ({label}): {name} was never launched")
        for name in TILED_HALO_KERNELS:
            if halo[name] == 0:
                fail(f"phase 8 ({label}): {name} never launched with the "
                     f"ring halo")
        if counts["subpel_scan"] != searches:
            fail(f"phase 8 ({label}): K9 launched {counts['subpel_scan']} "
                 f"times for {searches} inter tile frames (one each "
                 f"expected)")
        if counts["encode_tail"] != encodes:
            fail(f"phase 8 ({label}): K10 launched {counts['encode_tail']} "
                 f"times for {encodes} encoded tile frames (one each "
                 f"expected)")
        if counts["decode_tail"] != decodes:
            fail(f"phase 8 ({label}): K11 launched {counts['decode_tail']} "
                 f"times for {decodes} decoded tile frames (one each "
                 f"expected)")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return {k: counts[k] for k in TILED_HALO_KERNELS
                + ("deblock_frame", "subpel_scan", "encode_tail",
                   "decode_tail")}

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def fps(seconds):
        return len(seconds) / sum(seconds)

    t_phase = time.perf_counter()
    frames = moving_frames(1920, 1080, 6, shift=9)

    # ---- 1 tile against the single-card path (run first, so that the
    # counts hold the tiled path's launches only)
    genc, gdec = api.GpuEncoder(), api.GpuDecoder()
    genc.set_quality(16)
    singles = [genc.encode(f) for f in frames[:5]]
    single_rgb = [gdec.decode(c) for c in singles]
    reset()
    enc = tiled.TiledEncoder(n_tiles=1, devices=["cuda:0"])
    dec = tiled.TiledDecoder(devices=["cuda:0"])
    enc.set_quality(16)
    enc_s, dec_s = [], []
    for i, f in enumerate(frames[:5]):
        chunk, s_enc = timed(lambda: enc.encode(f))
        rgb, s_dec = timed(lambda: dec.decode(chunk))
        enc_s.append(s_enc)
        dec_s.append(s_dec)
        off = tiled.parse_tiled_header(chunk)[3] if i == 0 else 0
        if chunk[off + 10 + 4:] != singles[i][(14 if i == 0 else 0) + 10:]:
            fail(f"phase 8: 1-tile slice of frame {i} differs from "
                 f"GpuEncoder's")
        if not np.array_equal(rgb, single_rgb[i]):
            fail(f"phase 8: 1-tile RGB of frame {i} differs from GpuDecoder's")
        if not np.array_equal(rgb, enc.recon_rgb()):
            fail(f"phase 8: 1-tile RGB of frame {i} differs from recon_rgb()")
    summary["1_tile"] = dict(
        launches=launched("1 tile", 4, 5, 5),
        inter_encode_fps=fps(enc_s[1:]),
        inter_decode_fps=fps(dec_s[1:]),
        encode_ms=[round(x * 1e3, 1) for x in enc_s],
        decode_ms=[round(x * 1e3, 1) for x in dec_s])

    # ---- 4 tiles on one card, a sixth frame traced
    reset()
    enc = tiled.TiledEncoder(n_tiles=4, devices=["cuda:0"] * 4)
    dec = tiled.TiledDecoder(devices=["cuda:0"] * 4)
    enc.set_quality(16)
    enc_s, dec_s = [], []
    for i, f in enumerate(frames[:5]):
        chunk, s_enc = timed(lambda: enc.encode(f))
        rgb, s_dec = timed(lambda: dec.decode(chunk))
        enc_s.append(s_enc)
        dec_s.append(s_dec)
        if not np.array_equal(rgb, enc.recon_rgb()):
            fail(f"phase 8: 4-tile RGB of frame {i} differs from recon_rgb()")
    reach = 0
    for t in range(1, 4):
        bt = dec._bt[t]
        col0 = np.arange(len(bt)) % (dec.tile_w // 16) == 0
        motion = (bt.block_type & MOTION_BIT).astype(bool)
        reach += int(np.sum(motion & col0 & (bt.motion_x < 0)))
    if reach == 0:
        fail("phase 8: no MB of a tile's first column took a vector into "
             "its left neighbour")
    last = {}
    traced, traced_ms = traced_kernels(torch, lambda: last.update(
        rgb=dec.decode(enc.encode(frames[5]))))
    if not np.array_equal(last["rgb"], enc.recon_rgb()):
        fail("phase 8: 4-tile RGB of the traced frame differs from "
             "recon_rgb()")
    summary["4_tiles"] = dict(
        launches=launched("4 tiles", 5 * 4, 6 * 4, 6 * 4),
        inter_encode_fps=fps(enc_s[1:]),
        inter_decode_fps=fps(dec_s[1:]),
        encode_ms=[round(x * 1e3, 1) for x in enc_s],
        decode_ms=[round(x * 1e3, 1) for x in dec_s],
        first_column_mbs_reaching_left=reach,
        cuda_launches_traced_frame=traced,
        kernel_ms_traced_frame=traced_ms,
        # the traced frame's kernel time over an untraced inter frame's
        # encode + decode wall time
        busy_share=traced_ms / 1e3 / (np.mean(enc_s[1:])
                                      + np.mean(dec_s[1:])))

    # ---- 2 GOPs x 2 tiles against each GOP alone
    reset()
    seqs = [moving_frames(1920, 1080, 5, seed=1, shift=9),
            moving_frames(1920, 1080, 5, seed=2, shift=7)]
    enc = tiled.TiledEncoder(n_tiles=2, n_gops=2, devices=["cuda:0"] * 4)
    enc.set_quality(16)
    batched, enc_s = [], []
    for a, b in zip(*seqs):
        chunks, s_enc = timed(lambda: enc.encode_batch([a, b]))
        batched.append(chunks)
        enc_s.append(s_enc)
    summary["2_gops_x_2_tiles"] = dict(
        launches=launched("2 GOPs x 2 tiles", 4 * 2 * 2, 5 * 2 * 2, 0),
        inter_batch_fps=fps(enc_s[1:]),
        encode_ms=[round(x * 1e3, 1) for x in enc_s])
    reset()
    for g, seq in enumerate(seqs):
        alone = tiled.TiledEncoder(n_tiles=2, devices=["cuda:0"] * 2)
        alone.set_quality(16)
        for i, f in enumerate(seq):
            if alone.encode(f) != batched[i][g]:
                fail(f"phase 8: GOP {g} frame {i} differs from the GOP "
                     f"encoded alone")
    launched("each GOP alone, 2 tiles", 4 * 2 * 2, 5 * 2 * 2, 0)

    # ---- 352x288 over 4 tiles: card against CPU
    reset()
    small = moving_frames(352, 288, 3, shift=9)
    cpu = tiled.TiledEncoder(n_tiles=4, devices=["cpu"] * 4)
    card = tiled.TiledEncoder(n_tiles=4, devices=["cuda:0"] * 4)
    for e in (cpu, card):
        e.set_quality(16)
    for i, f in enumerate(small):
        if cpu.encode(f) != card.encode(f):
            fail(f"phase 8: 352x288 4-tile chunks of frame {i} differ "
                 f"between the CPU and the card")
    summary["352x288_4_tiles"] = dict(
        launches=launched("352x288, 4 tiles", 2 * 4, 3 * 4, 0))
    summary["seconds"] = time.perf_counter() - t_phase
    return total, summary


def cpu_model():
    """The host CPU as /proc/cpuinfo describes it: model name, vendor,
    family and model numbers (a virtual machine may report the name as
    unknown), and the cores this process may use."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    return (f"{fields.get('model name', 'unknown')} "
            f"({fields.get('vendor_id', '?')} family "
            f"{fields.get('cpu family', '?')} model "
            f"{fields.get('model', '?')}, "
            f"{len(os.sched_getaffinity(0))} cores)")


# the conformance path's kernels phase 9 must see launched: (module, key)
LIBRARY_PATH_KERNELS = (("cuda_pred", "pred_planes_wide"),
                        ("cuda_inter", "inter_search"),
                        ("cuda_wave", "wave_pass"),
                        ("cuda_wavedec", "wave_decode"),
                        ("cuda_deblock", "deblock_frame"))
# analysis metrics: (name, call on (luma pair, chroma quadruple))
LIBRARY_METRICS = (
    ("block_sad_delta", lambda a, y, c: a.block_sad(y[0])),
    ("block_sad", lambda a, y, c: a.block_sad(y[0], y[1])),
    ("block_mse", lambda a, y, c: a.block_mse(y[0], y[1])),
    ("block_ssd", lambda a, y, c: a.block_ssd(y[0], y[1])),
    ("block_mad", lambda a, y, c: a.block_mad(y[0], c[0], c[1], y[1], c[2],
                                              c[3])),
    ("block_mean", lambda a, y, c: a.block_mean(y[0])),
    ("nonzero_block_mean", lambda a, y, c: a.nonzero_block_mean(y[0])),
    ("block_variance", lambda a, y, c: a.block_variance(y[0])),
    ("block_variance2", lambda a, y, c: a.block_variance2(y[0])),
    ("block_variance3", lambda a, y, c: a.block_variance3(y[0])),
)
LIBRARY_TRANSFORMS = ("fdct4", "idct4", "fdct16_line", "idct16_line",
                      "fdct16", "idct16")


def library_metric_inputs(np, yuv0, yuv1, seed):
    """Per-MB inputs of the analysis metrics: the 8,160 MBs of a 1080p
    frame (luma and the co-located chroma of two consecutive frames, the
    planes padded to 1088 rows like the codec's) and as many blocks drawn
    over the whole int16 range with -32768 in them."""
    def mbs(plane, size, rows):
        p = np.zeros((rows, plane.shape[1]), np.int16)
        p[:plane.shape[0]] = plane
        h, w = p.shape
        return p.reshape(h // size, size, w // size, size) \
            .swapaxes(1, 2).reshape(-1, size, size)

    frame = ([mbs(yuv1[0], 16, 1088), mbs(yuv0[0], 16, 1088)],
             [mbs(p, 8, 544) for p in (yuv1[1], yuv1[2], yuv0[1], yuv0[2])])
    n = frame[0][0].shape[0]
    rng = np.random.default_rng(seed)

    def wide(size):
        b = rng.integers(-32768, 32768, (n, size, size)).astype(np.int16)
        b[0] = -32768
        b[1] = 0
        b[2, 0, 0] = 0
        b[3, 4, 5] = -32768
        return b

    return {"1080p_frame": frame,
            "int16_range": ([wide(16), wide(16)],
                            [wide(8) for _ in range(4)])}


def library_backends(np, seed, n=10_000):
    """Each lossless backend round-trips n values. (The backends that share
    the ABAC coder with the slice codec call its writers, so their bits are
    the slice codec's.) Returns {backend: bits}."""
    from cairo_tpu_torch.entropy import backends as B

    rng = np.random.default_rng(seed)
    bits = {}

    def reader(out):
        return B.BitReader(out.getvalue(), out.bit_count)

    def coded(write, items):
        out, coder = B.BitWriter(), B.EntropyCoder()
        for x in items:
            write(x, coder, out)
        coder.finish_encode(out)
        return out

    def check(name, ok, out):
        if not ok:
            fail(f"library: backend {name} did not round-trip {n} values")
        bits[name] = out.bit_count

    vals = rng.integers(0, 8, n)
    out = B.BitWriter()
    B.huffman_encode_values(vals, out)
    check("huffman", np.array_equal(
        B.huffman_decode_values(reader(out), n), vals), out)

    signed = rng.integers(-32768, 32768, n).astype(np.int16)
    signed[: n // 2] = rng.integers(-300, 301, n // 2)
    signed[:2] = (-32768, 32767)
    unsigned = rng.integers(0, 65536, n)
    unsigned[: n // 2] = rng.integers(0, 300, n // 2)
    for mode, v, wrap in (("signed", signed, np.int16),
                          ("unsigned", unsigned, np.uint16)):
        is_signed = mode == "signed"
        out = B.BitWriter()
        B.golomb_encode_values(v, out, signed=is_signed)
        back = B.golomb_decode_values(reader(out), n, signed=is_signed)
        check(f"golomb_{mode}", np.array_equal(back.view(wrap),
                                               v.astype(wrap)), out)
        out = coded(lambda x, c, o: B.entropy_encode_value(
            int(x), c, o, signed=is_signed), v)
        src, coder = reader(out), B.EntropyCoder()
        coder.start_decode(src)
        back = np.array([B.entropy_decode_value(coder, src, signed=is_signed)
                         for _ in range(n)])
        check(f"entropy_{mode}", np.array_equal(back.astype(wrap),
                                                v.astype(wrap)), out)

    for size in (4, 8, 16):
        blocks = rng.integers(-300, 301, (-(-n // size ** 2), size, size)
                              ).astype(np.int16)
        blocks[::2].reshape(len(blocks[::2]), -1)[:, size:] = 0
        blocks[0, 0, 0] = -32768
        out = coded(B.entropy_encode_block, blocks)
        src, coder = reader(out), B.EntropyCoder()
        coder.start_decode(src)
        check(f"block_{size}x{size}", all(np.array_equal(
            B.entropy_decode_block(size, coder, src), b) for b in blocks),
            out)
        if size == 8:
            out = coded(B.entropy_rle_encode_8x8, blocks)
            src, coder = reader(out), B.EntropyCoder()
            coder.start_decode(src)
            check("rle_8x8", all(np.array_equal(
                B.entropy_rle_decode_8x8(coder, src), b) for b in blocks),
                out)
    return bits


def phase_library(torch, np, gpu):
    """Phase 9: the library surface. The port's host reference engine
    (Evx1Encoder / Evx1Decoder, which shares nothing with the device path)
    anchors ConformanceGpuEncoder's bytes and GpuDecoder's RGB at 640x360;
    analysis and the 4x4/16x16 transforms on the card against the CPU;
    the entropy backends round-trip. Returns a summary dict."""
    from cairo_tpu_torch import Evx1Decoder, Evx1Encoder, analysis, native
    from cairo_tpu_torch.cpuref import imaging, stream
    from cairo_tpu_torch.synth import synth_frames

    t_phase = time.perf_counter()
    api, ops = gpu["api"], gpu["ops"]
    frames = synth_frames(640, 360, 3, seed=SEED % 983)
    for mod, key in LIBRARY_PATH_KERNELS:
        gpu[mod].LAUNCHES[key] = 0
    dev = torch.device("cuda")
    ref, card = Evx1Encoder(), api.ConformanceGpuEncoder(device=dev)
    ref.set_quality(16)
    card.set_quality(16)
    ref_s, card_s, chunks = [], [], []
    for i, f in enumerate(frames):
        t0 = time.perf_counter()
        want = ref.encode(f)
        ref_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        got = card.encode(f)
        torch.cuda.synchronize()
        card_s.append(time.perf_counter() - t0)
        if got != want:
            fail(f"library: ConformanceGpuEncoder's 640x360 frame {i} "
                 f"differs from Evx1Encoder's ({len(got)} vs {len(want)} "
                 f"bytes)")
        chunks.append(got)
    dec, rdec = api.GpuDecoder(device=dev), Evx1Decoder()
    dec_s, rdec_s = [], []
    host = host_decode(np, native, stream, chunks)
    for i, c in enumerate(chunks):
        t0 = time.perf_counter()
        got = dec.decode(c)
        torch.cuda.synchronize()
        dec_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        want = rdec.decode(c)
        rdec_s.append(time.perf_counter() - t0)
        if not np.array_equal(got, want):
            fail(f"library: GpuDecoder's frame {i} differs from "
                 f"Evx1Decoder's")
        if not np.array_equal(got, host[i]):
            fail(f"library: GpuDecoder's frame {i} differs from the native "
                 f"C++ decoder's")
    if dec.host_frames:
        fail(f"library: {dec.host_frames} frames took the host decoder")
    launches = {key: gpu[mod].LAUNCHES[key]
                for mod, key in LIBRARY_PATH_KERNELS}
    for key, count in launches.items():
        if count == 0:
            fail(f"library: kernel {key} was never launched")
    anchor_s = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    big = synth_frames(1920, 1080, 2, seed=SEED % 977)
    yuv = [imaging.rgb_to_yuv420(f) for f in big]
    cases = library_metric_inputs(np, yuv[0], yuv[1], SEED)
    for label, (y, c) in cases.items():
        ty = [torch.from_numpy(a).to(dev) for a in y]
        tc = [torch.from_numpy(a).to(dev) for a in c]
        cy = [torch.from_numpy(a) for a in y]
        cc = [torch.from_numpy(a) for a in c]
        for name, call in LIBRARY_METRICS:
            got = call(analysis, ty, tc)
            if not got.is_cuda:
                fail(f"library: analysis.{name} did not run on the card "
                     f"({label})")
            if not torch.equal(got.cpu(), call(analysis, cy, cc)):
                fail(f"library: analysis.{name} on the card differs from "
                     f"the CPU ({label})")
        got = analysis.block_sad(y[0], y[1])
        if not got.is_cuda:
            fail(f"library: analysis on arrays did not go to the card "
                 f"({label})")
        if not torch.equal(got.cpu(), analysis.block_sad(cy[0], cy[1])):
            fail(f"library: analysis on arrays sent to the card differs "
                 f"({label})")
        planes = {4: y[0].reshape(-1, 4, 4, 4, 4).swapaxes(2, 3)
                  .reshape(-1, 4, 4), 16: y[0]}
        for name in LIBRARY_TRANSFORMS:
            x = planes[4 if name.endswith("4") else 16]
            if name.endswith("_line"):
                x = x.reshape(-1, 16)
            fn = getattr(ops, name)
            xt = torch.from_numpy(np.ascontiguousarray(x))
            got = fn(xt.to(dev))
            if not got.is_cuda:
                fail(f"library: ops.{name} did not run on the card "
                     f"({label})")
            if not torch.equal(got.cpu(), fn(xt)):
                fail(f"library: ops.{name} on the card differs from the "
                     f"CPU ({label})")
    n_mbs = cases["1080p_frame"][0][0].shape[0]
    card_cpu_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    bits = library_backends(np, SEED)
    backends_s = time.perf_counter() - t0
    return dict(
        ref_inter_fps=(len(frames) - 1) / sum(ref_s[1:]),
        card_inter_fps=(len(frames) - 1) / sum(card_s[1:]),
        ref_encode_ms=[round(s * 1e3, 1) for s in ref_s],
        card_encode_ms=[round(s * 1e3, 1) for s in card_s],
        gpu_decode_ms=[round(s * 1e3, 1) for s in dec_s],
        ref_decode_ms=[round(s * 1e3, 1) for s in rdec_s],
        launches=launches, mbs=n_mbs, backend_bits=bits,
        anchor_s=anchor_s, card_cpu_s=card_cpu_s, backends_s=backends_s,
        seconds=time.perf_counter() - t_phase, cpu=cpu_model())


# pipeline stages labelled in the --profile trace: (module, attribute)
PROFILE_STAGES = (
    ("native", "rgb_to_yuv5d"), ("native", "encode_slice"),
    ("native", "decode_slice"), ("native", "extract_coo"),
    ("native", "yuv5d_wire_to_rgb"), ("wire", "unpack_yuv5d"),
    ("wire", "pack_encode_wire"), ("wire", "pack_yuv5d_wire"),
    ("motion", "full_pel"), ("cuda_motion", "chroma_max_maps"),
    ("cuda_motion", "dense_select"), ("cuda_motion", "subpel_classify"),
    ("cuda_pred", "gather_windows_yuv"),
    ("cuda_pred", "pred_planes"), ("cuda_tail", "encode_tail"),
    ("cuda_tail", "decode_tail"), ("cuda_deblock", "deblock_frame"),
    ("cuda_inter", "inter_search"),
    ("cuda_wave", "wave_pass"), ("wavefront", "_conformance_tail"),
    ("wavefront", "conformance_decode_step"),
    ("cuda_wavedec", "wave_decode"))
PORT_KERNELS = ("chroma_max_kernel", "dense_select_kernel",
                "gather_windows_kernel", "pred_planes_kernel",
                "inter_search_kernel", "wave_decode_kernel", "wave_kernel",
                "deblock_kernel", "subpel_scan_kernel", "encode_tail_kernel",
                "decode_tail_kernel", "unpack_yuv5d_kernel")
# CUDA launches of a traced fast inter frame (encode + decode, 1080p q16)
# before K9 took every reference and the classification merge, on NVIDIA
# H100 80GB HBM3 (1,592 before K10 and K11, 5,981 before K9)
FAST_FRAME_LAUNCHES_BEFORE_MERGE = 517


def profile_frame(torch, smi, label, warm, timed, traced, before=None):
    """Prints host and device time per labelled stage of `traced()` and
    the device's busy share against the unprofiled wall time of
    `timed()`, after `warm()`; each runs the same kind of work. `before`:
    an earlier count of the frame's launches to print beside this one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    warm()
    t0 = time.perf_counter()
    timed()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced()
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
    log(f"profile: {label} on {smi}: "
        f"wall {wall * 1e3:.1f} ms unprofiled; kernels {busy * 1e3:.1f} ms "
        f"in {sum(e.count for e in kernels)} launches, so the device is busy "
        f"{100 * busy / wall:.1f}% and idle {100 - 100 * busy / wall:.1f}% "
        f"of the unprofiled wall")
    if before is not None:
        log(f"profile: {label}: {sum(e.count for e in kernels)} CUDA launches "
            f"against {before} before K9 took every reference and the "
            f"merge")
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
    # launched it; the port's kernels launch through ctypes, so their
    # stage rows above read 0 device ms and their device time is here
    log("profile: the port's kernels | device ms | launches")
    for kname in PORT_KERNELS:
        hits = [e for e in kernels if kname in e.key]
        log(f"profile: {kname:<22} "
            f"{sum(dev_us(e, True) for e in hits) / 1e3:8.3f} "
            f"{sum(e.count for e in hits):6d}")


def phase_profile(torch, gpu, smi):
    """Host and device time per pipeline stage for one fast-mode inter
    frame (encoded and decoded) and one conformance inter frame (encoded,
    and decoded through the wavefront decode), and the device's busy
    share against unprofiled runs of the same work."""
    import importlib
    from torch.profiler import record_function

    from cairo_tpu_torch.synth import synth_frames

    def labelled(name, fn):
        def run(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return run

    for mod_name, attr in PROFILE_STAGES:
        pkg = "cairo_tpu_torch" if mod_name == "native" else \
            "cairo_tpu_torch.gpu"
        mod = importlib.import_module(f"{pkg}.{mod_name}")
        setattr(mod, attr, labelled(f"stage.{attr}", getattr(mod, attr)))
    frames = synth_frames(1920, 1080, 4, seed=SEED % 1000)

    def fast(enc, dec, f):
        with record_function("stage.encode_frame"):
            chunk = enc.encode(f)
        with record_function("stage.decode_frame"):
            dec.decode(chunk)
        torch.cuda.synchronize()

    enc, dec = gpu["api"].GpuEncoder(), gpu["api"].GpuDecoder()
    enc.set_quality(16)
    profile_frame(
        torch, smi, "one 1920x1080 q16 inter frame encoded + decoded",
        lambda: [fast(enc, dec, f) for f in frames[:2]],
        lambda: fast(enc, dec, frames[2]), lambda: fast(enc, dec, frames[3]),
        before=FAST_FRAME_LAUNCHES_BEFORE_MERGE)

    chunks = []

    def conf(cenc, f):
        with record_function("stage.encode_frame"):
            chunks.append(cenc.encode(f))
        torch.cuda.synchronize()

    cenc = gpu["api"].ConformanceGpuEncoder()
    cenc.set_quality(16)
    profile_frame(
        torch, smi, "one 1920x1080 q16 conformance inter frame encoded",
        lambda: [conf(cenc, f) for f in frames[:2]],
        lambda: conf(cenc, frames[2]), lambda: conf(cenc, frames[3]))

    def conf_dec(cdec, chunk):
        with record_function("stage.decode_frame"):
            cdec.decode(chunk)
        torch.cuda.synchronize()

    cdec = gpu["api"].GpuDecoder()
    profile_frame(
        torch, smi, "one 1920x1080 q16 conformance inter frame decoded "
        "(wavefront decode)",
        lambda: [conf_dec(cdec, c) for c in chunks[:2]],
        lambda: conf_dec(cdec, chunks[2]), lambda: conf_dec(cdec, chunks[3]))
    log(f"profile: the decoded conformance frames' (waves, members): "
        f"{cdec.last_stats.get('waves')}, {cdec.last_stats.get('members')} "
        f"(the last); host frames {cdec.host_frames}")


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
    sys.path.insert(0, os.path.join(root, "tests"))  # util_deblock (numpy)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 0: card {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    from cairo_tpu_torch.gpu import (_build, api, cuda_deblock, cuda_inter,
                                     cuda_motion, cuda_pred, cuda_tail,
                                     cuda_wave, cuda_wavedec, deblock, ops,
                                     shard, tiled, wavefront, wire)
    gpu = dict(api=api, cuda_motion=cuda_motion, cuda_pred=cuda_pred,
               cuda_inter=cuda_inter, cuda_wave=cuda_wave,
               cuda_wavedec=cuda_wavedec, cuda_deblock=cuda_deblock,
               cuda_tail=cuda_tail, deblock=deblock, ops=ops, shard=shard,
               tiled=tiled, wavefront=wavefront, wire=wire)
    secs = _build.build_all()
    log(f"phase 1: built kernels in {secs['kernels_s']:.1f}s and the native "
        f"library in {secs['native_s']:.1f}s")
    log("kernels: K1 chroma_max_maps, K2 dense_select, K3 gather_windows, "
        "K4 pred_planes, K5 inter_search, K6 wave_pass, K7 wave_decode, "
        "K8 deblock_frame, K9 subpel_scan, K10 encode_tail, K11 decode_tail, "
        "K12 unpack_yuv5d")
    if "--profile" in sys.argv[1:]:
        phase_profile(torch, gpu, smi)
        faulthandler.cancel_dump_traceback_later()
        return

    usage = ptxas_usage(_build.build_log(_build.kernel_library_path()))
    recs = phase_kernels(torch, np, gpu)
    recs["K8"] = phase_kernels_deblock(torch, gpu)
    single = phase_kernels_subpel(torch, np, gpu)
    recs["K9"] = phase_kernels_classify(torch, np, gpu)
    recs["K9"].update({f"single_{k}": v for k, v in single.items()
                       if k in ("ms", "device_ms", "plain_ms", "bytes",
                                "ops")})
    recs["K9"]["taken"] = single["taken"]
    recs["K9"]["max_abs_err"] = max(recs["K9"]["max_abs_err"],
                                    single["max_abs_err"])
    recs.update(phase_kernels_tail(torch, np, gpu))
    recs["K12"] = phase_kernels_unpack(torch, np, gpu)
    for k, r in recs.items():
        dev = f", kernel alone {r['device_ms']:.3f} ms" if "device_ms" in r \
            else ""
        log(f"phase 2: {k} {r['ms']:.3f} ms{dev} (plain {r['plain_ms']:.3f} "
            f"ms) on {smi}")
    k3 = recs["K3"]
    log(f"phase 2: K3 is the three-plane launch; bound "
        f"{k3['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes) on {smi}")
    for label in ("luma", "chroma"):
        log(f"phase 2: K3 {label} call alone {k3[label + '_ms']:.3f} ms, "
            f"kernel alone {k3[label + '_device_ms']:.4f} ms (plain "
            f"{k3[label + '_plain_ms']:.3f} ms), bound "
            f"{k3[label + '_bound_ms']:.4f} ms (bytes) on {smi}")
    k9 = recs["K9"]
    if "subpel_scan_kernel" not in usage:
        fail("ptxas reported nothing for subpel_scan_kernel")
    for label, pre in (("every reference and the merge", ""),
                       ("one reference", "single_")):
        log(f"phase 2: K9 at 1920x1088, {label} "
            f"({k9[pre + 'bytes'] / 1e6:.1f} MB, "
            f"{k9[pre + 'ops'] / 1e9:.3f} G integer operations): "
            f"{k9[pre + 'ms']:.4f} ms, kernel alone "
            f"{k9[pre + 'device_ms']:.4f} ms (plain "
            f"{k9[pre + 'plain_ms']:.3f} ms), bound "
            f"{k9[pre + 'bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes) / "
            f"{k9[pre + 'ops'] / INT_OPS_PER_S * 1e3:.4f} ms (operations); "
            f"{usage['subpel_scan_kernel']} on {smi}")
    for k, kname in (("K10", "encode_tail_kernel"),
                     ("K11", "decode_tail_kernel")):
        r = recs[k]
        if kname not in usage:
            fail(f"ptxas reported nothing for {kname}")
        log(f"phase 2: {k} at 1920x1088 ({r['bytes'] / 1e6:.1f} MB, "
            f"{r['ops'] / 1e9:.3f} G integer operations, copy MBs "
            f"{100 * r['copy_share']:.1f} %): {r['ms']:.4f} ms, kernel alone "
            f"{r['device_ms']:.4f} ms (plain {r['plain_ms']:.3f} ms), bound "
            f"{r['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes) / "
            f"{r['ops'] / INT_OPS_PER_S * 1e3:.4f} ms (operations); "
            f"{usage[kname]} on {smi}")
    r = recs["K11"]
    log(f"phase 2: K11 at 1920x1088, every MB a copy, with the carry "
        f"({r['all_copy_bytes'] / 1e6:.1f} MB): {r['all_copy_ms']:.4f} ms, "
        f"kernel alone {r['all_copy_device_ms']:.4f} ms (plain "
        f"{r['all_copy_plain_ms']:.3f} ms), bound "
        f"{r['all_copy_bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes) on "
        f"{smi}")
    r = recs["K12"]
    for layout, pre in (("blocks and self_sad", ""), ("planes", "planes_")):
        kname = f"unpack_yuv5d_kernel<{int(not pre)}>"
        if kname not in usage:
            fail(f"ptxas reported nothing for {kname}")
        log(f"phase 2: K12 at 1920x1088, {layout} "
            f"({r[pre + 'bytes'] / 1e6:.2f} MB): {r[pre + 'ms']:.4f} ms, "
            f"kernel alone {r[pre + 'device_ms']:.4f} ms (plain "
            f"{r[pre + 'plain_ms']:.3f} ms), bound "
            f"{r[pre + 'bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes) / "
            f"{r['ops'] / INT_OPS_PER_S * 1e3:.4f} ms (operations); "
            f"{usage[kname]} on {smi}")
    k8 = recs["K8"]
    if "deblock_kernel" not in usage:
        fail("ptxas reported nothing for deblock_kernel")
    log(f"phase 2: K8 at 1920x1088: {k8['ms']:.4f} ms, kernel alone "
        f"{k8['device_ms']:.4f} ms (plain {k8['plain_ms']:.3f} ms), bound "
        f"{k8['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes; operations "
        f"{k8['ops'] / INT_OPS_PER_S * 1e3:.4f} ms); "
        f"{usage['deblock_kernel']} on {smi}")

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

    recs.update(phase_kernels_conformance(torch, np, gpu))
    recs["K7"] = phase_kernels_wave_decode(torch, np, gpu)
    for k in ("K4w", "K5", "K6", "K7"):
        r = recs[k]
        dev = f", kernel alone {r['device_ms']:.3f} ms" if "device_ms" in r \
            else ""
        log(f"phase 2b: {k} {r['ms']:.3f} ms{dev} (plain {r['plain_ms']:.3f} "
            f"ms) on {smi}")
    log(f"phase 2b: K6 {recs['K6']['ms'] / recs['K6']['steps'] * 1e3:.2f} "
        f"us per step of its {recs['K6']['steps']}-MB chain on {smi}")
    log(f"phase 2b: K5 timed input: {100 * recs['K5']['frozen']:.1f}% of the "
        f"(MB, reference) searches frozen by the co-located candidate")
    k7 = recs["K7"]
    for frame, pre in (("inter", ""), ("intra", "intra_")):
        log(f"phase 2b: K7 on the {frame} frame: 1 launch, "
            f"{k7[pre + 'waves']} waves, {k7[pre + 'members']} members, "
            f"longest chain {k7[pre + 'chain']}: {k7[pre + 'ms']:.4f} ms, "
            f"kernel alone {k7[pre + 'device_ms']:.4f} ms, "
            f"{k7[pre + 'us_per_chain_step']:.3f} us per chain step (plain "
            f"{k7[pre + 'plain_ms']:.3f} ms), bound "
            f"{k7[pre + 'bytes'] / HBM_BYTES_PER_S * 1e3:.6f} ms (bytes); "
            f"{usage.get('wave_decode_kernel')} on {smi}")
    for kname in ("chroma_max_kernel", "dense_select_kernel",
                  "gather_windows_kernel<0>", "gather_windows_kernel<1>",
                  "gather_windows_kernel<2>", "pred_planes_kernel<17,9>",
                  "pred_planes_kernel<33,17>", "inter_search_kernel",
                  "wave_kernel", "wave_decode_kernel", "subpel_scan_kernel",
                  "encode_tail_kernel", "decode_tail_kernel",
                  "unpack_yuv5d_kernel<0>", "unpack_yuv5d_kernel<1>"):
        if kname not in usage:
            fail(f"ptxas reported nothing for {kname}")
        log(f"phase 2b: {kname}: {usage[kname]}")

    claunches, csum = phase_conformance(torch, np, gpu)
    by_path = {name: {"fast": launches[name], "conformance": claunches[name]}
               for name in ("deblock_frame", "decode_tail", "unpack_yuv5d")}
    launches.update(claunches)
    for name, counts in by_path.items():
        launches[name] = sum(counts.values())
    log(f"phase 5: conformance encode 1920x1080 q16, {csum['frames']} frames "
        f"on {smi}: inter frames {csum['inter_encode_fps']:.2f} fps; psnr "
        f"{csum['psnr_db']:.2f} dB, {csum['kbits_per_frame']:.1f} "
        f"kbit/frame; encode ms {csum['encode_ms']}; stage ms "
        f"{csum['stage_ms']}; launches {claunches}")
    log(f"phase 5: conformance decode on the device, inter frames "
        f"{csum['inter_decode_fps']:.2f} fps; decode ms {csum['decode_ms']}; "
        f"(waves, members) per frame {csum['waves_members']}; host frames "
        f"{csum['host_frames']} on {smi}")

    phase_conformance_cpu_vs_card(gpu)
    log("phase 6: conformance CPU and card chunks byte-identical and decoded "
        "to identical RGB on the device path at 176x144, q 4, 16, 29")

    piped = phase_pipelined(gpu, smi)

    tiled_launches, tsum = phase_tiled(torch, np, gpu, smi)
    for label in ("1_tile", "4_tiles"):
        r = tsum[label]
        log(f"phase 8: 1920x1080 q16, {label.replace('_', ' ')} on one card: "
            f"inter frames encode {r['inter_encode_fps']:.2f} fps, decode "
            f"{r['inter_decode_fps']:.2f} fps; encode ms {r['encode_ms']}, "
            f"decode ms {r['decode_ms']}; launches {r['launches']} on {smi}")
    r = tsum["4_tiles"]
    log(f"phase 8: 4 tiles: {r['cuda_launches_traced_frame']} CUDA launches "
        f"and {r['kernel_ms_traced_frame']:.2f} ms of kernels in a traced "
        f"inter frame (encode + decode), busy {100 * r['busy_share']:.1f} % "
        f"of an untraced one's wall time; "
        f"{r['first_column_mbs_reaching_left']} first-column MBs took a "
        f"vector into the left neighbour")
    r = tsum["2_gops_x_2_tiles"]
    log(f"phase 8: 2 GOPs x 2 tiles: inter batches (one frame of each GOP) "
        f"{r['inter_batch_fps']:.2f} per s; encode ms {r['encode_ms']}; each "
        f"GOP's stream equals the GOP encoded alone")
    log(f"phase 8: 352x288 over 4 tiles: card and CPU chunks byte-identical; "
        f"phase seconds {tsum['seconds']:.1f} on {smi}")
    print("tiled " + json.dumps(tsum), flush=True)

    lib = phase_library(torch, np, gpu)
    log(f"phase 9: 640x360 q16, 3 frames: ConformanceGpuEncoder's chunks "
        f"equal Evx1Encoder's; inter frames Evx1Encoder "
        f"{lib['ref_inter_fps']:.3f} fps on the host ({lib['cpu']}), "
        f"ConformanceGpuEncoder {lib['card_inter_fps']:.2f} fps on {smi}; "
        f"encode ms host {lib['ref_encode_ms']}, card "
        f"{lib['card_encode_ms']}; GpuDecoder's RGB equals Evx1Decoder's and "
        f"the native decoder's, host frames 0, decode ms card "
        f"{lib['gpu_decode_ms']}, host {lib['ref_decode_ms']}; launches "
        f"{lib['launches']}")
    log(f"phase 9: analysis (10 metrics) and the 6 transforms exact on the "
        f"card against the CPU over the {lib['mbs']} MBs of a 1080p frame "
        f"and over the int16 range; backends round-trip 10000 values each, "
        f"bits {lib['backend_bits']}; seconds: anchor "
        f"{lib['anchor_s']:.1f}, card against CPU {lib['card_cpu_s']:.1f}, "
        f"backends {lib['backends_s']:.1f}, phase {lib['seconds']:.1f}")
    print("library " + json.dumps(lib), flush=True)

    meta = {
        "K1": ("chroma_max_maps", "src/cairo_tpu_torch/gpu/csrc/motion.cu",
               "src/cairo_tpu/tpu/pallas_motion.py:314"),
        "K2": ("dense_select", "src/cairo_tpu_torch/gpu/csrc/motion.cu",
               "src/cairo_tpu/tpu/pallas_motion.py:212"),
        "K3": ("gather_windows", "src/cairo_tpu_torch/gpu/csrc/pred.cu",
               "src/cairo_tpu/tpu/pallas_pred.py:313"),
        "K4": ("pred_planes", "src/cairo_tpu_torch/gpu/csrc/pred.cu",
               "src/cairo_tpu/tpu/pallas_pred.py:221"),
        "K4w": ("pred_planes_wide", "src/cairo_tpu_torch/gpu/csrc/pred.cu",
                "src/cairo_tpu/tpu/pallas_pred.py:221"),
        "K5": ("inter_search", "src/cairo_tpu_torch/gpu/csrc/inter.cu",
               "src/cairo_tpu/tpu/pallas_inter.py:395"),
        "K6": ("wave_pass", "src/cairo_tpu_torch/gpu/csrc/wave.cu",
               "src/cairo_tpu/tpu/pallas_wave.py:1045"),
        # no Pallas kernel: the XLA while_loop of the conformance decode
        "K7": ("wave_decode", "src/cairo_tpu_torch/gpu/csrc/wavedec.cu",
               "src/cairo_tpu/tpu/wavefront.py:986"),
        # no Pallas kernel: the XLA fori_loop of the in-loop deblock
        "K8": ("deblock_frame", "src/cairo_tpu_torch/gpu/csrc/deblock.cu",
               "src/cairo_tpu/tpu/deblock.py:143"),
        # no Pallas kernel: the XLA lax.scan of the fast search's sub-pel
        # refinement
        "K9": ("subpel_scan", "src/cairo_tpu_torch/gpu/csrc/subpel.cu",
               "src/cairo_tpu/tpu/motion.py:476"),
        # no Pallas kernel: the XLA fusions of the fast steps' transform
        # tail, encode (encode_step) and decode (_decode_common)
        "K10": ("encode_tail", "src/cairo_tpu_torch/gpu/csrc/tail.cu",
                "src/cairo_tpu/tpu/engine.py:219"),
        "K11": ("decode_tail", "src/cairo_tpu_torch/gpu/csrc/tail.cu",
                "src/cairo_tpu/tpu/engine.py:329"),
        # no Pallas kernel: the XLA fusions of the 5-bit source wire's
        # unpack inside the encode steps
        "K12": ("unpack_yuv5d", "src/cairo_tpu_torch/gpu/csrc/wire.cu",
                "src/cairo_tpu/tpu/wire.py:263"),
    }
    instances = dict(K1="chroma_max_kernel", K2="dense_select_kernel",
                     K3="gather_windows_kernel<2>",
                     K4="pred_planes_kernel<17,9>",
                     K4w="pred_planes_kernel<33,17>",
                     K5="inter_search_kernel", K6="wave_kernel",
                     K7="wave_decode_kernel", K8="deblock_kernel",
                     K9="subpel_scan_kernel", K10="encode_tail_kernel",
                     K11="decode_tail_kernel", K12="unpack_yuv5d_kernel<1>")
    kernels = []
    for k, (name, source, replaces) in meta.items():
        r = recs[k]
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / INT_OPS_PER_S * 1e3
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], launches_pipelined=sum(
                piped[f"{path}_launches"].get(name, 0)
                for path in PIPELINE_PATHS),
            launches_tiled=tiled_launches.get(name, 0),
            max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, ptxas=usage[instances[k]]))
        if "device_ms" in r:
            kernels[-1]["device_ms"] = r["device_ms"]
        # K3's luma and chroma calls alone beside its three-plane launch,
        # K7's intra frame beside its inter frame
        kernels[-1].update({k: v for k, v in r.items()
                            if k.startswith(("luma_", "chroma_", "intra_",
                                             "single_", "all_copy_",
                                             "planes_"))})
        if k == "K9":
            kernels[-1]["taken_by_case"] = r["taken"]
            kernels[-1]["targets_by_case"] = r["targets"]
    # K8's and K11's launches in phase 3 (fast encode and decode) and
    # phase 5 (conformance encode and the GpuDecoder of its stream)
    kernels[list(meta).index("K8")]["launches_by_path"] = \
        by_path["deblock_frame"]
    kernels[list(meta).index("K11")]["launches_by_path"] = \
        by_path["decode_tail"]
    kernels[list(meta).index("K12")]["launches_by_path"] = \
        by_path["unpack_yuv5d"]
    faulthandler.cancel_dump_traceback_later()
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
