"""Builds the port's native libraries from the sources in the checkout.

Two shared libraries with plain C interfaces, loaded with ctypes:
  * the CUDA kernels (csrc/*.cu, sharing csrc/*.cuh): one `nvcc` per
    source, all started together, then one link; built for sm_90a
    (Hopper) on first use;
  * the host entropy coder and sequential decoder (native/*.cpp), g++.

Each library lands in `<repo>/.torch_build/<sha256 of sources and
flags>/`, beside `lib<name>.log`, the compiler's output (for the kernels,
ptxas' registers and spills per kernel: `build_log`). A build writes to
private temporary names and `os.replace`s the finished log and then the
library into place, so a build that is cut off leaves nothing
that a later run would wait on or load, and concurrent builds (test
workers) never see a half-written library. No PyTorch header is compiled
and no lock file is taken.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
BUILD_ROOT = _PKG.parents[1] / ".torch_build"

CSRC = sorted((_PKG / "gpu" / "csrc").glob("*.cu"))
CSRC_HEADERS = sorted((_PKG / "gpu" / "csrc").glob("*.cuh"))
NATIVE_SRC = [_PKG / "native" / "entropy.cpp", _PKG / "native" / "decoder.cpp"]

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _digest(sources, flags) -> str:
    h = hashlib.sha256()
    for f in flags:
        h.update(f.encode() + b"\0")
    for s in sources:
        h.update(s.name.encode() + b"\0" + s.read_bytes())
    return h.hexdigest()[:24]


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"build failed: {' '.join(map(str, cmd))}\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _build_native(out: Path):
    return _run(["g++", *GXX_FLAGS, "-o", str(out), *map(str, NATIVE_SRC)])


def _build_kernels(out: Path):
    nvcc = nvcc_path()
    tmpdir = Path(tempfile.mkdtemp(prefix="obj.", dir=out.parent))
    try:
        objs = [tmpdir / (s.stem + ".o") for s in CSRC]
        with ThreadPoolExecutor(len(CSRC)) as pool:
            logs = list(pool.map(
                lambda so: _run([nvcc, *NVCC_FLAGS, "-c",
                                 str(so[0]), "-o", str(so[1])]),
                zip(CSRC, objs)))
        _run([nvcc, "-shared", "-o", str(out), *map(str, objs)])
        return "".join(logs)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def _ensure(name: str, sources, flags, build_fn) -> Path:
    """Path of the built library `name`, building it (and its log) if it
    is missing."""
    final = BUILD_ROOT / _digest(sources, flags) / f"lib{name}.so"
    if final.exists():
        return final
    final.parent.mkdir(parents=True, exist_ok=True)
    tmps = []
    try:
        for suffix in (".so", ".log"):
            fd, tmp = tempfile.mkstemp(prefix=f".lib{name}.",
                                       suffix=suffix + ".tmp",
                                       dir=final.parent)
            os.close(fd)
            tmps.append(tmp)
        log = build_fn(Path(tmps[0]))
        Path(tmps[1]).write_text(log or "")
        os.replace(tmps[1], final.with_suffix(".log"))
        os.replace(tmps[0], final)
    finally:
        for tmp in tmps:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return final


def build_log(library: Path) -> str:
    """The compiler output of the build that made `library`, whichever
    process ran it."""
    return library.with_suffix(".log").read_text()


def native_library_path() -> Path:
    return _ensure("cairo_native", NATIVE_SRC, ["g++"] + GXX_FLAGS,
                   _build_native)


def kernel_library_path() -> Path:
    return _ensure("cairo_kernels", CSRC + CSRC_HEADERS,
                   ["nvcc"] + NVCC_FLAGS, _build_kernels)


def load(name: str) -> ctypes.CDLL:
    """The loaded library "native" or "kernels" (built on first use)."""
    with _lock:
        if name not in _loaded:
            path = (native_library_path() if name == "native"
                    else kernel_library_path())
            _loaded[name] = ctypes.CDLL(str(path))
        return _loaded[name]


def build_all() -> dict:
    """Builds both libraries side by side; returns seconds per library."""
    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(2) as pool:
        k = pool.submit(timed, kernel_library_path)
        n = pool.submit(timed, native_library_path)
        return {"kernels_s": k.result(), "native_s": n.result()}


# ----------------------------------------------------------------- binding

_fns: dict[str, object] = {}


def kernel_fn(name: str, sig: str):
    """ctypes handle of kernel launcher `name` in the kernel library. `sig`
    has one letter per argument: 'p' for a device pointer or the stream
    (c_void_p, never a 32-bit int), 'i' for an int (c_int)."""
    if name not in _fns:
        fn = getattr(load("kernels"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                       for c in sig]
        _fns[name] = fn
    return _fns[name]


def check(t, name: str, dtype, shape=None):
    """Raises unless `t` is a contiguous CUDA tensor of `dtype` (and
    `shape`, where given) that the kernel can take as it is."""
    import torch

    if not torch.is_tensor(t) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_many(specs, index: int):
    """Raises as check() does unless each (tensor, name, dtypes, shape) of
    `specs` is a contiguous tensor of one of `dtypes` and `shape` on CUDA
    device `index`; the common case reads a few attributes a tensor (a
    launch's host time, where a wrapper takes many tensors)."""
    import torch

    for t, name, dtypes, shape in specs:
        if (isinstance(t, torch.Tensor) and t.dtype in dtypes
                and t.shape == shape and t.is_cuda
                and t.get_device() == index and t.is_contiguous()):
            continue
        if isinstance(t, torch.Tensor) and t.dtype in dtypes:
            check(t, name, t.dtype, shape)
        else:
            check(t, name, dtypes[0], shape)
        raise ValueError(f"{name}: on {t.device}, expected cuda:{index}")


def launch(fn, device, *args):
    """Launches on the current stream of `device`; raises on a CUDA error
    returned by the launcher (a launch the runtime refused never runs)."""
    import torch

    if len(args) + 1 != len(fn.argtypes):  # ctypes would pass extras as int
        raise TypeError(f"{fn.__name__}: {len(args)} arguments and the "
                        f"stream for {len(fn.argtypes)} parameters")
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    # the raw handle, as torch's generated kernels take it: building a
    # torch.cuda.Stream and entering the device context cost some 6 and
    # 4 us of host time a launch on the card
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err} at launch")
