#!/usr/bin/env python3
"""Times two checkouts of the PyTorch/CUDA port against each other on one
CUDA card, in turns, end to end and per kernel.

    python3 compare_trees.py PARENT_SRC CHANGE_SRC
    python3 compare_trees.py --pred-kernels PARENT_SRC CHANGE_SRC

PARENT_SRC and CHANGE_SRC are the `src` directories of two checkouts
(unpack a commit's with `git archive <commit> src | tar -x -C DIR`). Each
turn runs in a process of its own with that `src` first on the path,
builds that checkout's kernels (outside the timing) and prints one JSON
line, on seeded 1920x1080 content at q16:
  * fast mode: GpuEncoder over 1 intra + 4 inter frames and GpuDecoder
    over their chunks, the inter frames' encode and decode fps;
  * conformance: ConformanceGpuEncoder over 1 intra + 2 inter frames, the
    inter frames' encode fps; GpuDecoder over those chunks (the wavefront
    decode), the inter frames' decode fps, and per frame its waves and
    members, K7's launches (cuda_wavedec.LAUNCHES) and K7's device ms
    (chip_smoke.device_ms) and CUDA-event ms (chip_smoke.cuda_ms, host
    work included) on the arguments the decode gave it;
  * each kernel of the checkout's gpu/csrc (every __global__ function):
    device ms and launches in one more inter frame of each path (fast
    encode and decode, conformance encode, and the wavefront decode of
    that conformance frame's chunk), from a torch.profiler trace, and
    beside them the count and device ms of all CUDA kernels in that trace,
    ATen's included (the launches a frame takes);
  * the sha256 of each path's stream (the chunks of the timed frames) and
    of the RGB both decoders gave, so that a change that must keep the
    bytes shows that it did;
  * pipelined throughput, under keys that start with "pipelined_": each
    path's encoder's encode_many and GpuDecoder.decode_many against a loop
    over encode and decode on the same frames (fast: 2 warm-up + 20
    measured frames, conformance: 2 + 8), counted as bench.py counts
    them (chip_smoke.measure_pipelined), with per-stage medians and the
    sha256 of the pipelined stream and RGB. A checkout whose encode_many
    and decode_many are loops measures its loop twice.
With --pred-kernels a turn times K3 (gather_windows) and K4
(pred_planes) call by call instead, each checked exact against its plain
version (chip_smoke.compare), on seeded 1920x1088 inputs of the ranges
chip_smoke.py's phase 2 uses (ring planes in -300..559, motion in
-16..16 with MBs at +-40 that the windows clamp; K4 with every slot, both
lerp amounts and a fifth of the MBs intra, motion up to the pad): K3's
luma call and chroma call alone, its three windows of one reference
(gather_windows_yuv, or the three single-plane calls in a checkout
without it), K4 at pads 17/9 and 33/17; per call the device time of its
launches from a torch.profiler trace of 20 calls (chip_smoke.device_ms),
their count, and the median CUDA-event time of single calls (host work
included, chip_smoke.cuda_ms).
The turns run in the order P, C, C, P (P the parent, C the change), so
that drift of the card or the host shows as a difference between the two
turns of one checkout. The first line printed is the card's name and
power limit, then one line per turn; the last is a JSON object with
every turn. Exits non-zero without a CUDA device, when a turn fails, or
(end to end) when a turn's fast or conformance stream or decoded RGB,
pipelined or not, differs from the first turn's, or a turn's pipelined
output from its loop's, after printing every turn.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import re
import subprocess
import sys
import time

SEED = 20261017
TURN_TIMEOUT_S = 900


def kernel_names(src):
    """The __global__ functions of the checkout's CUDA sources."""
    csrc = os.path.join(src, "cairo_tpu_torch", "gpu", "csrc")
    names = []
    for f in sorted(os.listdir(csrc)):
        if f.endswith(".cu"):
            with open(os.path.join(csrc, f)) as fh:
                names += re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                    r"\([^)]*\)\s*)?(\w+)\s*\(", fh.read())
    return names


def run_turn(src):
    """One turn on the checkout whose `src` is given; returns its record."""
    sys.path.insert(0, src)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cairo_tpu_torch import (ConformanceGpuEncoder, GpuDecoder,
                                 GpuEncoder)
    from cairo_tpu_torch.gpu import _build, cuda_wavedec
    from cairo_tpu_torch.synth import synth_frames
    from cairo_tpu_torch.gpu import api
    from chip_smoke import cuda_ms, device_ms, measure_pipelined

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    names = kernel_names(src)

    def kernels_of(fn):
        """The checkout's kernels in a trace of fn(), by name, and under
        "all" every CUDA kernel of the trace."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {"all": (0.0, 0)}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            ms = getattr(e, "self_device_time_total", getattr(
                e, "self_cuda_time_total", 0.0)) / 1e3
            hit = next((k for k in names if k in e.key), None)
            for key in ("all", hit) if hit else ("all",):
                total, n = out.get(key, (0.0, 0))
                out[key] = (total + ms, n + e.count)
        return {k: {"ms": ms, "launches": n} for k, (ms, n) in out.items()}

    _build.build_all()
    frames = synth_frames(1920, 1080, 6, seed=SEED % 997)
    enc, dec = GpuEncoder(), GpuDecoder()
    enc.set_quality(16)
    enc_s, dec_s = [], []
    fast_sha, conf_sha = hashlib.sha256(), hashlib.sha256()
    fast_rgb, conf_rgb = hashlib.sha256(), hashlib.sha256()
    for f in frames[:5]:
        chunk, s = timed(lambda: enc.encode(f))
        fast_sha.update(chunk)
        enc_s.append(s)
        rgb, s = timed(lambda: dec.decode(chunk))
        fast_rgb.update(rgb.tobytes())
        dec_s.append(s)
    fast_kernels = kernels_of(lambda: dec.decode(enc.encode(frames[5])))

    cenc = ConformanceGpuEncoder()
    cenc.set_quality(16)
    conf_s, conf_chunks = [], []
    for f in frames[:3]:
        chunk, s = timed(lambda: cenc.encode(f))
        conf_sha.update(chunk)
        conf_s.append(s)
        conf_chunks.append(chunk)
    traced = []
    conf_kernels = kernels_of(lambda: traced.append(cenc.encode(frames[3])))

    # the wavefront decode of those chunks, K7's arguments kept per frame
    cdec, cdec_s, k7 = GpuDecoder(), [], []
    kernel, calls = cuda_wavedec.wave_decode, {}

    def record(planes, *rest):
        calls[len(cdec_s)] = (tuple(p.clone() for p in planes), *rest)
        return kernel(planes, *rest)

    cuda_wavedec.wave_decode = record
    try:
        for chunk in conf_chunks:
            before = cuda_wavedec.LAUNCHES["wave_decode"]
            rgb, s = timed(lambda: cdec.decode(chunk))
            conf_rgb.update(rgb.tobytes())
            cdec_s.append(s)
            k7.append(dict(waves=cdec.last_stats.get("waves"),
                           members=cdec.last_stats.get("members"),
                           launches=cuda_wavedec.LAUNCHES["wave_decode"] -
                           before))
    finally:
        cuda_wavedec.wave_decode = kernel
    conf_dec_kernels = kernels_of(lambda: cdec.decode(traced[0]))
    for i, args in calls.items():
        run = functools.partial(kernel, tuple(p.clone() for p in args[0]),
                                *args[1:])
        k7[i]["device_ms"] = device_ms(torch, run, "wave_decode_kernel",
                                       per_call=k7[i]["launches"])
        k7[i]["events_ms"] = cuda_ms(torch, run, 10)
    piped_frames = synth_frames(1920, 1080, 22, seed=SEED % 983)
    piped = {**measure_pipelined(api, piped_frames, 2, "fast"),
             **measure_pipelined(api, piped_frames[:10], 2, "conformance")}
    return {"src": src,
            **{f"pipelined_{k}": v for k, v in piped.items()},
            "fast_encode_fps": 4 / sum(enc_s[1:]),
            "fast_decode_fps": 4 / sum(dec_s[1:]),
            "conformance_encode_fps": 2 / sum(conf_s[1:]),
            "fast_encode_ms": [s * 1e3 for s in enc_s],
            "conformance_encode_ms": [s * 1e3 for s in conf_s],
            "conformance_decode_fps": 2 / sum(cdec_s[1:]),
            "conformance_decode_ms": [s * 1e3 for s in cdec_s],
            "conformance_decode_k7": k7,
            "fast_stream_sha256": fast_sha.hexdigest(),
            "conformance_stream_sha256": conf_sha.hexdigest(),
            "fast_rgb_sha256": fast_rgb.hexdigest(),
            "conformance_rgb_sha256": conf_rgb.hexdigest(),
            "fast_frame_kernels": fast_kernels,
            "conformance_frame_kernels": conf_kernels,
            "conformance_decode_frame_kernels": conf_dec_kernels}


def run_pred_turn(src):
    """One --pred-kernels turn on the checkout whose `src` is given."""
    sys.path.insert(0, src)
    import numpy as np
    import torch

    from cairo_tpu_torch.gpu import _build, cuda_pred as cp
    from chip_smoke import compare, cuda_ms, device_ms

    _build.build_all()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    h, w = 1088, 1920
    n = (h // 16) * (w // 16)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev, dtype)

    ring = tuple(t(rng.integers(-300, 560, (4,) + s), torch.int16)
                 for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
    slot = torch.tensor([2], dtype=torch.int32, device=dev)
    mx = t(rng.integers(-16, 17, n), torch.int32)
    my = t(rng.integers(-16, 17, n), torch.int32)
    mx[:64] = 40
    my[64:128] = -40

    def record(name, fn, plain, kernel, per_call=1):
        got = fn()
        torch.cuda.synchronize()
        return dict(err=compare(torch, name, got, plain()),
                    device_ms=device_ms(torch, fn, kernel, 20,
                                        per_call=per_call),
                    launches=per_call, events_ms=cuda_ms(torch, fn, 20))

    out = {"src": src}
    out["k3_luma"] = record(
        "K3 luma", lambda: cp.gather_windows(ring[0], slot, mx, my, 18, 17),
        lambda: cp.gather_windows_plain(ring[0], slot, mx, my, 18, 17),
        "gather_windows_kernel")
    out["k3_chroma"] = record(
        "K3 chroma",
        lambda: cp.gather_windows(ring[1], slot, mx >> 1, my >> 1, 10, 9),
        lambda: cp.gather_windows_plain(ring[1], slot, mx >> 1, my >> 1, 10,
                                        9), "gather_windows_kernel")
    three = tuple(zip(ring, (mx, mx >> 1, mx >> 1), (my, my >> 1, my >> 1),
                      (18, 10, 10), (17, 9, 9)))
    yuv = getattr(cp, "gather_windows_yuv", None)
    out["k3_yuv"] = record(
        "K3 Y, U and V",
        (lambda: yuv(ring, slot, mx, my)) if yuv else lambda: tuple(
            cp.gather_windows(r, slot, x, y, b, p) for r, x, y, b, p in three),
        lambda: tuple(cp.gather_windows_plain(r, slot, x, y, b, p)
                      for r, x, y, b, p in three),
        "gather_windows_kernel", 1 if yuv else 3)
    for pads, seed in (((17, 9), 1), ((33, 17), 2)):
        r = np.random.default_rng(seed)
        reach = pads[0] - 2
        kx = t(r.integers(-reach, reach + 1, n), torch.int32)
        ky = t(r.integers(-reach, reach + 1, n), torch.int32)
        kx[:64] = 40
        ky[64:128] = -40
        args = (*ring, t(r.integers(0, 4, n), torch.int32), kx, ky,
                t(r.random(n) < 0.5, torch.bool),
                t(r.random(n) < 0.5, torch.bool),
                t(r.integers(0, 8, n), torch.int32),
                t(r.random(n) < 0.2, torch.bool), *pads)
        out[f"k4_{pads[0]}"] = record(
            f"K4 {pads}", lambda: cp.pred_planes(*args),
            lambda: cp.pred_planes_plain(*args), "pred_planes_kernel")
    return out


def main():
    args = sys.argv[1:]
    turn = {"--turn": run_turn, "--pred-turn": run_pred_turn}
    if args[:1] and args[0] in turn:
        print(json.dumps(turn[args[0]](os.path.abspath(args[1]))),
              flush=True)
        return
    pred = args[:1] == ["--pred-kernels"]
    args = args[1:] if pred else args
    if len(args) != 2:
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("compare_trees: no CUDA device found")
    trees = dict(zip("PC", map(os.path.abspath, args)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    turns = []
    for who in "PCCP":
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--pred-turn" if pred else "--turn",
                               trees[who]], capture_output=True, text=True,
                              timeout=TURN_TIMEOUT_S)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise SystemExit(f"compare_trees: turn {who} failed")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["tree"] = who
        if pred:
            print(f"{who}: device ms per call " + ", ".join(
                f"{k} {v['device_ms']:.4f}" for k, v in rec.items()
                if isinstance(v, dict)), flush=True)
        else:
            traced = {path: rec[f"{path}_frame_kernels"]["all"] for path in
                      ("fast", "conformance", "conformance_decode")}
            print(f"{who}: fast encode {rec['fast_encode_fps']:.3f} fps, "
                  f"decode {rec['fast_decode_fps']:.3f} fps, conformance "
                  f"encode {rec['conformance_encode_fps']:.3f} fps, decode "
                  f"{rec['conformance_decode_fps']:.3f} fps; all kernels of "
                  f"a traced inter frame " + ", ".join(
                      f"{path} {t['launches']} launches {t['ms']:.3f} ms"
                      for path, t in traced.items())
                  + f"; K7 per frame {rec['conformance_decode_k7']}",
                  flush=True)
            print(f"{who}: pipelined " + ", ".join(
                f"{path} encode_many {rec[f'pipelined_{path}_encode_fps']:.3f}"
                f" fps (loop {rec[f'pipelined_{path}_encode_loop_fps']:.3f}),"
                f" decode_many {rec[f'pipelined_{path}_decode_fps']:.3f} fps"
                f" (loop {rec[f'pipelined_{path}_decode_loop_fps']:.3f})"
                for path in ("fast", "conformance")), flush=True)
        turns.append(rec)
    print(json.dumps({"card": smi, "turns": turns}), flush=True)
    differ = [k for k in ("fast_stream_sha256", "conformance_stream_sha256",
                          "fast_rgb_sha256", "conformance_rgb_sha256",
                          "pipelined_fast_stream_sha256",
                          "pipelined_conformance_stream_sha256",
                          "pipelined_fast_rgb_sha256",
                          "pipelined_conformance_rgb_sha256")
              if not pred and len({t[k] for t in turns}) > 1]
    differ += [f"{t['tree']} {k}" for t in turns for k in (
        "pipelined_fast_chunks_equal_loop", "pipelined_fast_rgb_equal_loop",
        "pipelined_conformance_chunks_equal_loop",
        "pipelined_conformance_rgb_equal_loop") if not pred and not t[k]]
    if differ:
        raise SystemExit(f"compare_trees: streams or RGB differ between "
                         f"turns or from the loop ({', '.join(differ)})")


if __name__ == "__main__":
    main()
