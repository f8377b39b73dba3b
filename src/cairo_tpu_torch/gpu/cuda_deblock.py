"""In-loop deblock kernel K8 with its plain PyTorch version (counterpart of
cairo_tpu/tpu/deblock.py's deblock_frame, :143, an XLA fori_loop over
8-row bands inside the step's jit, which has no Pallas kernel).

Dispatch, one rule: a CPU tensor takes the plain version,
deblock.deblock_frame (the band scan as torch ops); a CUDA tensor
launches the kernel of csrc/deblock.cu or raises. One call launches the
kernel once for Y, U and V; LAUNCHES["deblock_frame"] counts those
launches.

The kernel runs one block per output tile of a plane: the tile's input
with a 4-sample halo staged in shared memory, the deblock's three
parallel passes there (the source's header says why three suffice and
why tiles never wait on each other), each edge's strength and QP computed
from the per-MB maps.
"""

from __future__ import annotations

import torch

from .. import tables
from . import _build
from .cuda_pred import _FLAG, _INT, _field
from .deblock import deblock_frame as deblock_frame_plain

MB = tables.MACROBLOCK_SIZE
I32 = torch.int32
SIGNATURE = "pppppiipppp"

LAUNCHES = {"deblock_frame": 0}


def _plane(t, name, shape):
    """A plane as the kernel reads it: contiguous, 16-byte aligned int32
    as it comes, else converted to that (the kernel stages 16-byte
    chunks)."""
    t = t.to(I32).contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    _build.check(t, name, I32, shape)
    return t


def deblock_frame(y, u, v, copy_blocks, q_blocks):
    """The deblocked planes (Y, U, V), new int32 tensors of the input
    shapes: Y (H, W) at 16-px MBs, U and V (H / 2, W / 2) at 8-px cells
    (deblock.cpp:256-275). copy_blocks: (H / 16, W / 16) bool or uint8;
    q_blocks: (H / 16, W / 16) q per MB, 0..31 (a copy MB's is not read).
    The inputs are left as they are."""
    if y.device.type == "cpu":
        return deblock_frame_plain(y, u, v, copy_blocks, q_blocks)
    h, w = y.shape
    if h % MB or w % MB:
        raise ValueError("deblock_frame: plane dims must be multiples of 16")
    if h * w >= 2 ** 31:
        raise ValueError("deblock_frame: planes of 2^31 samples or more")
    y = _plane(y, "y", (h, w))
    u = _plane(u, "u", (h // 2, w // 2))
    v = _plane(v, "v", (h // 2, w // 2))
    n = (h // MB) * (w // MB)
    copy = _field(copy_blocks.reshape(-1), "copy_blocks", n, _FLAG)
    q = _field(q_blocks.reshape(-1), "q_blocks", n, _INT)
    for name, t in (("u", u), ("v", v), ("copy_blocks", copy),
                    ("q_blocks", q)):
        if t.device != y.device:
            raise ValueError(f"{name}: on {t.device}, the planes on "
                             f"{y.device}")
    cs = h * w // 4
    buf = torch.empty(h * w + 2 * cs, dtype=I32, device=y.device)
    out_y, out_u, out_v = buf.split([h * w, cs, cs])
    fn = _build.kernel_fn("cairo_deblock_frame", SIGNATURE)
    _build.launch(fn, y.device, y.data_ptr(), u.data_ptr(), v.data_ptr(),
                  copy.data_ptr(), q.data_ptr(), h, w, out_y.data_ptr(),
                  out_u.data_ptr(), out_v.data_ptr())
    LAUNCHES["deblock_frame"] += 1
    return (out_y.view(h, w), out_u.view(h // 2, w // 2),
            out_v.view(h // 2, w // 2))
