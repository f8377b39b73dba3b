#!/usr/bin/env python3
"""Splits the device time of a kernel of the PyTorch/CUDA port by timing
variants of its source on one CUDA card.

    python3 tools/kernel_split.py [--src SRC] SET [SET ...]

SRC is the `src` directory of a checkout (default: this one's; unpack a
commit's with `git archive <commit> src | tar -x -C DIR`). Each SET in
VARIANTS names the wrapper to time, the kernel's name in a profiler
trace, and variants of the kernel's source: a few lines of the checkout's
`gpu/csrc` replaced by regular expressions, so that a part of the
kernel's work is gone and the difference to the unchanged source ("base")
is what that part costs. A variant's outputs are wrong by design; only
its time is read. Each variant is one `nvcc` of the patched source into a
library of its own (all started together), loaded in place of the
checkout's kernel library while its wrapper runs on the arguments the
main path gives it (GpuEncoder and GpuDecoder on two seeded 1920x1080
frames at q16, the inter frame's call kept, chip_smoke.kept_calls).
Time: the device time of the kernel from a torch.profiler trace
(chip_smoke.device_ms, 10 calls), each variant in turn, twice (turns
base, v1, ..., vn, vn, ..., base); for the unchanged source also the
median CUDA-event time of
single calls (chip_smoke.cuda_ms, 20 calls), whose excess over the
device time is the wrapper's host work. Prints the card's name and
power limit, one line per set and a last line with every set's JSON.
Exits non-zero without a CUDA device or when a replacement matches
nothing (a variant that no longer fits the source)."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# set -> (module, wrapper, trace name, source file, {variant: [(file,
# pattern, replacement), ...]}); file None is the set's source file
VARIANTS = {
    # K10 before its redesign (one 384-thread block an MB), for an older
    # checkout's source (--src)
    "k10-old": ("cuda_tail", "encode_tail", "encode_tail_kernel", "tail.cu", {
        "no_division": [("common.cuh", r"int q = a / d;\n  if \(a % d != 0 "
                         r"&& a < 0\) --q;", "int q = a >> 3;")],
        "no_dct": [(None, r"const int v = forward\(x, s, buf, B\);",
                    "const int v = x;"),
                   (None, r"inverse\(dequantize\(q, s, intra, qp, tb\), s, "
                    r"buf, B\)", "dequantize(q, s, intra, qp, tb)")],
        "no_dct_no_division": [
            ("common.cuh", r"int q = a / d;\n  if \(a % d != 0 && a < 0\) "
             r"--q;", "int q = a >> 3;"),
            (None, r"const int v = forward\(x, s, buf, B\);",
             "const int v = x;"),
            (None, r"inverse\(dequantize\(q, s, intra, qp, tb\), s, buf, "
             r"B\)", "dequantize(q, s, intra, qp, tb)")],
    }),
    # K11 before its redesign (one 384-thread block an MB, the passes
    # through shared memory), for an older checkout's source (--src)
    "k11-old": ("cuda_tail", "decode_tail", "decode_tail_kernel", "tail.cu", {
        "no_shared_passes": [(None, r"inverse\(dequantize\(v, s, "
                              r"intra_default\[mb\], qp_in\[mb\], tb\),"
                              r"\s*s, buf, B\)",
                              "dequantize(v, s, intra_default[mb], "
                              "qp_in[mb], tb)")],
        "no_division": [(None, r"trunc_div_pos\(mul_w\(mul_w\(mul_w\(2, v\), "
                         r"qm\), qp\), tb\.sf\)",
                         "(mul_w(mul_w(mul_w(2, v), qm), qp) >> 4)")],
        "basis_immediate": [(None, r"B\[j \* 8 \+ s\.[rc]\]",
                             "(128 - 13 * j)")],
        "terms_by_constant": [(None, r"return j == 0 \? trunc_div_pos\("
                               r"mul_w\(p, 45\), 128\) : trunc_div_pos\(p, "
                               r"2\);",
                               "return j == 0 ? p * 45 / 128 : p / 2;")],
        "no_shared_passes_no_division": [
            (None, r"inverse\(dequantize\(v, s, intra_default\[mb\], "
             r"qp_in\[mb\], tb\),\s*s, buf, B\)",
             "dequantize(v, s, intra_default[mb], qp_in[mb], tb)"),
            (None, r"trunc_div_pos\(mul_w\(mul_w\(mul_w\(2, v\), qm\), qp\), "
             r"tb\.sf\)", "(mul_w(mul_w(mul_w(2, v), qm), qp) >> 4)")],
    }),
    # K9 before its redesign (one launch a reference), for an older
    # checkout's source (--src)
    "k9-old": ("cuda_motion", "subpel_scan", "subpel_scan_kernel",
               "subpel.cu", {
        "no_reduction": [(None, r"__reduce_(add|max)_sync\(FULL, (\w+)\)",
                          r"\2")],
        "luma_only": [(None, r"\n    chroma<[01]>\([^;]*;", "")],
    }),
    # K10 redesigned: 48 threads an MB, rows in registers
    "k10": ("cuda_tail", "encode_tail", "encode_tail_kernel", "tail.cu", {
        "no_quantizer": [(None, r"quant\(x\[k\], intra[^;]*;",
                          "q = x[k];\n    d = x[k];")],
        "no_dct": [(None, r"\n  [fi]dct8\(x\);[^\n]*", "")],
        "no_reciprocal": [(None, r"const unsigned t = __umulhi\(n, "
                           r"static_cast<unsigned>\(r.x\)\);\n  return "
                           r"[^;]*;", "return n >> r.y;")],
        "mbs4": [(None, r"constexpr int MBS = \d+;", "constexpr int MBS = 4;")],
        "mbs8": [(None, r"constexpr int MBS = \d+;", "constexpr int MBS = 8;")],
        "basis_in_constant_memory": [
            (None, r"__device__ __forceinline__ int B8\(int i\) \{\n"
             r"  constexpr int b\[64\] = \{", "__constant__ int B8c[64] = {"),
            (None, r"\};\n  return b\[i\];\n\}",
             "};\n__device__ __forceinline__ int B8(int i) { return B8c[i]; }")],
        "no_dct_no_quantizer": [
            (None, r"quant\(x\[k\], intra[^;]*;", "q = x[k];\n    d = x[k];"),
            (None, r"\n  [fi]dct8\(x\);[^\n]*", "")],
        "min_blocks16": [(None, r"__launch_bounds__\(k10::BLOCK\)",
                          "__launch_bounds__(k10::BLOCK, 16)")],
        "min_blocks21": [(None, r"__launch_bounds__\(k10::BLOCK\)",
                          "__launch_bounds__(k10::BLOCK, 21)")],
    }),
    # K9 redesigned: every reference and the merge in one launch
    "k9": ("cuda_motion", "subpel_classify", "subpel_scan_kernel",
           "subpel.cu", {
        "no_reduction": [(None, r"__reduce_(add|max)_sync\(FULL, (\w+)\)",
                          r"\2")],
        "luma_only": [(None, r"\n    chroma<[01]>\([^;]*;", "")],
        "one_copy": [(None, r"scan<[01], [01]>\(", "scan<0, 0>(")],
        "no_window_loads": [
            (None, r"yp\[a\]\[b\] = yw\[a \* YW \+ b\];",
             "yp[a][b] = a * 7 + b + m + mx;"),
            (None, r"(\w)p\[a\]\[b\] = ref\.\w+\[coff \+ a \* CW \+ b\];",
             r"\1p[a][b] = a * 5 + b + m + my;")],
        "int2_loads": [
            (None, r"for \(int b = 0; b < 10; \+\+b\) yp\[a\]\[b\] = "
             r"yw\[a \* YW \+ b\];",
             "for (int b = 0; b < 10; b += 2) {\n"
             "        const int2 w2 = *reinterpret_cast<const int2*>("
             "yw + a * YW + b);\n"
             "        yp[a][b] = w2.x;\n        yp[a][b + 1] = w2.y;\n      }"),
            (None, r"for \(int b = 0; b < 4; \+\+b\) \{\n"
             r"        up\[a\]\[b\] = ref\.uwin\[coff \+ a \* CW \+ b\];\n"
             r"        vp\[a\]\[b\] = ref\.vwin\[coff \+ a \* CW \+ b\];\n"
             r"      \}",
             "for (int b = 0; b < 4; b += 2) {\n"
             "        const int2 u2 = *reinterpret_cast<const int2*>("
             "ref.uwin + coff + a * CW + b);\n"
             "        const int2 v2 = *reinterpret_cast<const int2*>("
             "ref.vwin + coff + a * CW + b);\n"
             "        up[a][b] = u2.x;\n        up[a][b + 1] = u2.y;\n"
             "        vp[a][b] = v2.x;\n        vp[a][b + 1] = v2.y;\n      }")],
        "warps4": [(None, r"constexpr int WARPS = \d+;",
                    "constexpr int WARPS = 4;")],
        "warps8": [(None, r"constexpr int WARPS = \d+;",
                    "constexpr int WARPS = 8;")],
    }),

    # K11 redesigned: K10's threads and passes, the forward half left out
    "k11": ("cuda_tail", "decode_tail", "decode_tail_kernel", "tail.cu", {
        "no_dequantization": [(None, r"v\[j\] = wrap16\(intra && j == 0[^;]*;",
                               "v[j] = v[j];")],
        "no_qm_loads": [(None, r"__ldg\(qm \+ 32 \* j\)", "(16 + j)")],
        "no_idct": [(None, r"\n  idct8\(v\);[^\n]*", "")],
        "no_transpose": [(None, r"\n  transpose\(v, tr[^\n]*", "")],
        "loads_and_stores_only": [
            (None, r"v\[j\] = wrap16\(intra && j == 0[^;]*;", "v[j] = v[j];"),
            (None, r"\n  idct8\(v\);[^\n]*", ""),
            (None, r"\n  transpose\(v, tr[^\n]*", "")],
        "scalar_access": [
            (None, r"(void load8\(const int\* p, int \(&v\)\[8\]\) \{\n)"
             r"[^}]*\}", r"\1#pragma unroll\n  for (int k = 0; k < 8; ++k) "
             r"v[k] = p[k];\n}"),
            (None, r"(void store8\(int\* p, const int \(&v\)\[8\]\) \{\n)"
             r"[^}]*\}", r"\1#pragma unroll\n  for (int k = 0; k < 8; ++k) "
             r"p[k] = v[k];\n}")],
        # the design not taken: rows loaded with 16-byte loads (the carried
        # row one 16-byte store), a transpose turning them into columns
        "row_loads": [
            (None, r"(?s)  int v\[8\];\n  const size_t col = corner \+ r;\n"
             r".*?static_cast<int16_t>\(v\[j\]\);\n  \}\n",
             "  int v[8];\n"
             "  if (copy && stale_y != nullptr) {\n"
             "    const int4 a = *reinterpret_cast<const int4*>(\n"
             "        plane_of(blk, stale_y, stale_u, stale_v) + at);\n"
             "    const int w4[4] = {a.x, a.y, a.z, a.w};\n"
             "#pragma unroll\n"
             "    for (int k = 0; k < 4; ++k) {\n"
             "      v[2 * k] = (w4[k] << 16) >> 16;\n"
             "      v[2 * k + 1] = w4[k] >> 16;\n"
             "    }\n"
             "  } else {\n"
             "    load8(plane_of(blk, coef_y, coef_u, coef_v) + at, v);\n"
             "  }\n"
             "  if (carried_y != nullptr) {\n"
             "    *reinterpret_cast<int4*>(plane_of(blk, carried_y, "
             "carried_u, carried_v) + at) =\n"
             "        make_int4(pack16(v[0], v[1]), pack16(v[2], v[3]), "
             "pack16(v[4], v[5]), pack16(v[6], v[7]));\n"
             "  }\n"
             "  transpose(v, tr[warp] + (lane >> 3) * TB, r, lanes);\n")],
        "mbs4": [(None, r"(namespace k11 \{\n\n)constexpr int MBS = \d+;",
                  r"\1constexpr int MBS = 4;")],
        "mbs8": [(None, r"(namespace k11 \{\n\n)constexpr int MBS = \d+;",
                  r"\1constexpr int MBS = 8;")],
    }),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def patched(csrc, out_dir, source, edits):
    """A copy of csrc in out_dir with `edits` applied; raises when a
    pattern matches nothing."""
    shutil.copytree(csrc, out_dir)
    for name, pattern, repl in edits:
        path = os.path.join(out_dir, name or source)
        with open(path) as fh:
            text = fh.read()
        text, n = re.subn(pattern, repl, text)
        if not n:
            raise SystemExit(f"kernel_split: {pattern!r} matches nothing in "
                             f"{name or source}")
        with open(path, "w") as fh:
            fh.write(text)
    return os.path.join(out_dir, source)


def build(nvcc, cu, lib):
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", lib, cu],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"kernel_split: nvcc failed on {cu}\n"
                         f"{proc.stdout}{proc.stderr}")
    return lib


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("sets", nargs="+", choices=sorted(VARIANTS))
    opts = ap.parse_args()
    src = os.path.abspath(opts.src)
    sys.path.insert(0, src)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_split: no CUDA device")
    from cairo_tpu_torch.gpu import _build, api, cuda_motion, cuda_tail
    from cairo_tpu_torch.synth import synth_frames
    from chip_smoke import (SEED, cuda_ms, device_ms, kept_calls,
                            nvidia_smi_line)

    mods = dict(cuda_motion=cuda_motion, cuda_tail=cuda_tail)
    csrc = os.path.join(src, "cairo_tpu_torch", "gpu", "csrc")
    smi = nvidia_smi_line()
    print(smi, flush=True)
    _build.build_all()
    work = tempfile.mkdtemp(prefix="kernel_split.")
    nvcc = _build.nvcc_path()
    jobs = {}
    for s in opts.sets:
        _, _, _, source, variants = VARIANTS[s]
        for v, edits in {"base": [], **variants}.items():
            d = os.path.join(work, f"{s}.{v}")
            jobs[s, v] = (patched(csrc, d, source, edits), d + ".so")
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda j: build(nvcc, *j),
                                       jobs.values())))

    frames = synth_frames(1920, 1080, 2, seed=SEED % 1000)
    out = {"card": smi}
    real = _build.load("kernels")
    for s in opts.sets:
        mod_name, fn_name, trace, _, variants = VARIANTS[s]
        mod = mods[mod_name]
        enc, dec = api.GpuEncoder(), api.GpuDecoder()
        enc.set_quality(16)

        def run():
            for f in frames:
                dec.decode(enc.encode(f))
            torch.cuda.synchronize()

        args, kw = kept_calls(mod, fn_name, run)[-1]
        fn = getattr(mod, fn_name)
        order = ["base", *variants]
        times = {v: [] for v in order}
        events = []
        for v in order + order[::-1]:
            _build._loaded["kernels"] = ctypes.CDLL(libs[s, v])
            _build._fns.clear()
            times[v].append(device_ms(torch, lambda: fn(*args, **kw), trace))
            if v == "base":
                events.append(cuda_ms(torch, lambda: fn(*args, **kw), 20))
        _build._loaded["kernels"] = real
        _build._fns.clear()
        out[s] = {v: t for v, t in times.items()}
        out[s]["base_event_ms"] = events
        print(f"{s}: device ms per variant, two turns each, on {smi}: "
              f"{json.dumps(out[s])}", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
