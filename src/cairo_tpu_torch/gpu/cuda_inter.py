"""Exact inter-search kernel K5 (counterpart of
cairo_tpu/tpu/pallas_inter.py), with its plain PyTorch version.

Dispatch, one rule: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel of csrc/inter.cu or raises. Each launch adds one to
LAUNCHES["inter_search"].

  * inter_search (K5) replaces pallas_inter.inter_search
    (pallas_inter.py:395); plain version: motion.inter_search_exact per
    reference offset 1..RING-1, folded by motion.merge_descs, as the XLA
    branch of wavefront._dense_inter does (wavefront.py:104-115).

The reference slots and the quality come from the device: the kernel
reads the wire header's [frame_index, quality] through a pointer.
"""

from __future__ import annotations

import torch

from .. import tables
from . import _build
from . import motion as motion_mod

MB = tables.MACROBLOCK_SIZE
RING = tables.REFERENCE_FRAME_COUNT
I32 = torch.int32
FIELDS = ("sad", "is_copy", "is_motion", "target", "motion_x", "motion_y",
          "sp_pred", "sp_amount", "sp_index")
_BOOL = ("is_copy", "is_motion", "sp_pred", "sp_amount")

LAUNCHES = {"inter_search": 0}


def _mb_coords(h, w, device):
    wb = w // MB
    idx = torch.arange((h // MB) * wb, dtype=I32, device=device)
    return (idx % wb) * MB, (idx // wb) * MB


def inter_search_plain(src, ring, hdr):
    h, w = ring[0].shape[1:]
    px, py = _mb_coords(h, w, src[0].device)
    frame_index, quality = hdr[0], hdr[1]
    best = None
    for offset in range(1, RING):
        slot = ((frame_index + RING - offset) % RING).reshape(1).long()
        ref = tuple(p.index_select(0, slot)[0] for p in ring)
        cand = motion_mod.inter_search_exact(src, ref, px, py, quality)
        cand["target"] = torch.full_like(px, offset)
        best = cand if best is None else motion_mod.merge_descs(best, cand)
    out = {k: best[k] for k in FIELDS}
    out["is_intra"] = torch.zeros_like(best["is_copy"])
    return out


def inter_search(src, ring, hdr):
    """Folded exact inter candidates of every MB against the ring slots at
    offsets 1..RING-1 from the frame index.

    src: (Y (N,16,16), U (N,8,8), V (N,8,8)) int32 source blocks; ring:
    (ring_y, ring_u, ring_v) int16 (RING, H, W) stacks; hdr: (2,) int32
    [frame_index, quality] on the device. Returns the dict of (N,) fields
    FIELDS (bool or int32) plus is_intra (all False)."""
    if src[0].device.type == "cpu":
        return inter_search_plain(src, ring, hdr)
    _, h, w = ring[0].shape
    if h % MB or w % MB:
        raise ValueError("inter_search: plane dims must be multiples of 16")
    n = (h // MB) * (w // MB)
    _build.check(src[0], "src_y", I32, (n, MB, MB))
    _build.check(src[1], "src_u", I32, (n, MB // 2, MB // 2))
    _build.check(src[2], "src_v", I32, (n, MB // 2, MB // 2))
    _build.check(ring[0], "ring_y", torch.int16, (RING, h, w))
    _build.check(ring[1], "ring_u", torch.int16, (RING, h // 2, w // 2))
    _build.check(ring[2], "ring_v", torch.int16, (RING, h // 2, w // 2))
    _build.check(hdr, "hdr", I32, (2,))
    out = torch.empty((len(FIELDS), n), dtype=I32, device=src[0].device)
    fn = _build.kernel_fn("cairo_inter_search", "pppppppiipp")
    _build.launch(fn, src[0].device, *(t.data_ptr() for t in src),
                  *(t.data_ptr() for t in ring), hdr.data_ptr(), h, w,
                  out.data_ptr())
    LAUNCHES["inter_search"] += 1
    best = {k: (out[i] != 0 if k in _BOOL else out[i])
            for i, k in enumerate(FIELDS)}
    best["is_intra"] = torch.zeros(n, dtype=torch.bool, device=out.device)
    return best
