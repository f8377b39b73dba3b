#!/usr/bin/env python3
"""Times two checkouts of the PyTorch/CUDA port against each other on one
CUDA card, in turns, end to end and per kernel.

    python3 compare_trees.py PARENT_SRC CHANGE_SRC

PARENT_SRC and CHANGE_SRC are the `src` directories of two checkouts
(unpack a commit's with `git archive <commit> src | tar -x -C DIR`). Each
turn runs in a process of its own with that `src` first on the path,
builds that checkout's kernels (outside the timing) and prints one JSON
line, on seeded 1920x1080 content at q16:
  * fast mode: GpuEncoder over 1 intra + 4 inter frames and GpuDecoder
    over their chunks, the inter frames' encode and decode fps;
  * conformance: ConformanceGpuEncoder over 1 intra + 2 inter frames, the
    inter frames' encode fps;
  * each kernel of the checkout's gpu/csrc (every __global__ function):
    device ms and launches in one more inter frame of each path, from a
    torch.profiler trace.
The turns run in the order P, C, C, P (P the parent, C the change), so
that drift of the card or the host shows as a difference between the two
turns of one checkout. The first line printed is the
card's name and power limit; the last is a JSON object with every turn.
Exits non-zero without a CUDA device or when a turn fails.
"""

from __future__ import annotations

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
    from cairo_tpu_torch.gpu import _build
    from cairo_tpu_torch.synth import synth_frames

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    names = kernel_names(src)

    def kernels_of(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            hit = next((k for k in names if k in e.key), None)
            if e.device_type == DeviceType.CUDA and hit:
                ms, n = out.get(hit, (0.0, 0))
                out[hit] = (ms + getattr(e, "self_device_time_total", getattr(
                    e, "self_cuda_time_total", 0.0)) / 1e3, n + e.count)
        return {k: {"ms": ms, "launches": n} for k, (ms, n) in out.items()}

    _build.build_all()
    frames = synth_frames(1920, 1080, 6, seed=SEED % 997)
    enc, dec = GpuEncoder(), GpuDecoder()
    enc.set_quality(16)
    enc_s, dec_s = [], []
    for f in frames[:5]:
        chunk, s = timed(lambda: enc.encode(f))
        enc_s.append(s)
        dec_s.append(timed(lambda: dec.decode(chunk))[1])
    fast_kernels = kernels_of(lambda: dec.decode(enc.encode(frames[5])))

    cenc = ConformanceGpuEncoder()
    cenc.set_quality(16)
    conf_s = [timed(lambda: cenc.encode(f))[1] for f in frames[:3]]
    conf_kernels = kernels_of(lambda: cenc.encode(frames[3]))
    return {"src": src,
            "fast_encode_fps": 4 / sum(enc_s[1:]),
            "fast_decode_fps": 4 / sum(dec_s[1:]),
            "conformance_encode_fps": 2 / sum(conf_s[1:]),
            "fast_encode_ms": [s * 1e3 for s in enc_s],
            "conformance_encode_ms": [s * 1e3 for s in conf_s],
            "fast_frame_kernels": fast_kernels,
            "conformance_frame_kernels": conf_kernels}


def main():
    args = sys.argv[1:]
    if args[:1] == ["--turn"]:
        print(json.dumps(run_turn(os.path.abspath(args[1]))), flush=True)
        return
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
                               "--turn", trees[who]], capture_output=True,
                              text=True, timeout=TURN_TIMEOUT_S)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise SystemExit(f"compare_trees: turn {who} failed")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["tree"] = who
        print(f"{who}: fast encode {rec['fast_encode_fps']:.3f} fps, decode "
              f"{rec['fast_decode_fps']:.3f} fps, conformance "
              f"{rec['conformance_encode_fps']:.3f} fps", flush=True)
        turns.append(rec)
    print(json.dumps({"card": smi, "turns": turns}), flush=True)


if __name__ == "__main__":
    main()
