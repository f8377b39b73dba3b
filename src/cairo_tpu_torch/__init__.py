"""cairo-tpu-torch: the evx1 codec on PyTorch and CUDA (Hopper).

The counterpart of the `cairo_tpu` package, which stays the reference.
Public surface:
  GpuEncoder / GpuDecoder  -- fast-mode encode and decode on a CUDA card
                              (or on the CPU with device="cpu"); streams
                              are byte-identical to cairo_tpu's TpuEncoder.
  ConformanceGpuEncoder    -- the reference encoder's own bytes on the
                              card (wavefront schedule), identical to
                              ConformanceTpuEncoder's.
  TiledEncoder / TiledDecoder -- frames split into tiles over a (gop,
                              tile) mesh of devices (gpu/tiled.py,
                              gpu/shard.py, gpu/cluster.py); streams are
                              byte-identical to cairo_tpu's tiled ones.
  Evx1Encoder / Evx1Decoder -- the numpy reference engine (cpuref/), a
                              host engine as in cairo_tpu: bit-exact with
                              the reference encoder, sharing nothing with
                              the device path it is held against.
  analysis, entropy.backends -- the analysis.h block metrics (torch, on
                              the input's device) and the four lossless
                              backends of stream.h (host).
  checkpoint / metrics     -- session save/resume, per-frame stats.

Layout mirrors cairo_tpu: `gpu/` is the counterpart of `cairo_tpu/tpu/`,
with `cuda_motion.py`, `cuda_pred.py`, `cuda_inter.py` and `cuda_wave.py`
in place of the Pallas kernels and the CUDA sources under `gpu/csrc/`.
The package imports torch, numpy and the standard library only.
"""

from . import checkpoint, metrics, tables
from .blocktypes import BlockTable
from .cpuref.api import Evx1Decoder, Evx1Encoder

__version__ = "0.1.0"
__all__ = ["GpuEncoder", "GpuDecoder", "ConformanceGpuEncoder",
           "TiledEncoder", "TiledDecoder", "Evx1Encoder", "Evx1Decoder",
           "BlockTable", "checkpoint", "metrics", "tables"]


def __getattr__(name):
    if name in ("GpuEncoder", "GpuDecoder", "ConformanceGpuEncoder"):
        from .gpu import api
        return getattr(api, name)
    if name in ("TiledEncoder", "TiledDecoder"):
        from .gpu import tiled
        return getattr(tiled, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
