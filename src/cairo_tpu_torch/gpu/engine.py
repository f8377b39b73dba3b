"""Per-frame fast-mode encode and decode steps on torch tensors
(counterpart of cairo_tpu/tpu/engine.py).

Encode dataflow: source wire -> per-MB full-pel searches against the 3
previous ring slots (motion.full_pel: K1-K3) -> the sub-pel scan of all
three and the classification merge in one launch (K9) -> prediction
planes (K4) -> the transform tail (K10: residual DCT,
adaptive QP, quantize, coefficient planes, reconstruction) -> deblock
(K8) -> ring slot, and the packed output wire (block table + residual
COO). The host's C++ entropy coder serializes the slice. Decode: K4 ->
K11 (dequantize, inverse DCT, prediction add) -> K8 -> ring slot.

The carried state is the recon ring and the persistent coefficient
planes, as on the JAX package's Pallas path (no window caches). The tiled
path (gpu/shard.py) runs the same pieces on a tile with a ring halo:
encode_planes and decode_planes stop before the ring write, which waits
for the halo exchange there. Copy
blocks keep their stale coefficient contents (FORMAT.md §4). The state
dict is updated in place and also returned. The frame index and quality
travel in the wire's 8-byte header and stay on the device: nothing here
waits for the host.
"""

from __future__ import annotations

import torch

from .. import tables
from ..blocktypes import COPY_BIT, INTRA_BIT, MOTION_BIT
from . import cuda_deblock, cuda_motion, cuda_pred, cuda_tail, ops
from . import motion as motion_mod
from . import wire as wire_mod

MB = tables.MACROBLOCK_SIZE
RING = tables.REFERENCE_FRAME_COUNT
I32 = torch.int32


def init_state(aligned_w: int, aligned_h: int, device="cuda"):
    """Ring + persistent coefficient planes, int16, zeroed."""
    shape_y = (aligned_h, aligned_w)
    shape_c = (aligned_h // 2, aligned_w // 2)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int16, device=device)

    return dict(ring_y=z(RING, *shape_y), ring_u=z(RING, *shape_c),
                ring_v=z(RING, *shape_c), coef_y=z(*shape_y),
                coef_u=z(*shape_c), coef_v=z(*shape_c))


def _mb_coords(aligned_w, aligned_h, device):
    wb, hb = aligned_w // MB, aligned_h // MB
    idx = torch.arange(wb * hb, dtype=I32, device=device)
    return (idx % wb) * MB, (idx // wb) * MB, wb, hb


def _header(wire):
    """The wire's leading [frame_index, quality] int32 pair, on device."""
    hdr = wire[:8].view(I32)
    return hdr[0], hdr[1]


def _pred_planes(state, frame_index, target, mx, my, sp_pred, sp_amount,
                 sp_index, zero, halo=0):
    """Prediction planes (K4) of all MBs (zeroed where `zero`, i.e.
    intra); `halo`: the ring's halo columns (0 on a single card)."""
    slot_per_mb = (frame_index + RING - target) % RING
    return cuda_pred.pred_planes(
        state["ring_y"], state["ring_u"], state["ring_v"], slot_per_mb,
        mx, my, sp_pred, sp_amount, sp_index, zero, halo=halo)


def _intra_best(n, device):
    zi = torch.zeros(n, dtype=I32, device=device)
    zb = torch.zeros(n, dtype=torch.bool, device=device)
    return dict(sad=zi, is_copy=zb, is_motion=zb,
                is_intra=torch.ones(n, dtype=torch.bool, device=device),
                target=zi, motion_x=zi, motion_y=zi, sp_pred=zb,
                sp_amount=zb, sp_index=zi)


def _classify_inter(src_planes, ring, px, py, quality, frame_index,
                    n_refs=RING, *, x0=0, full_width=None, halo=0):
    """Inter-frame classification (encode.cpp:17-67, fast mode): the
    full-pel search of each reference offset (K1-K3), then one sub-pel
    scan of them all that merges them copy-first, then by lower SAD (K9;
    shard._classify_tile under tiling: x0, full_width and halo as
    motion.inter_search takes them). Returns the merged best and its
    block types (cuda_motion.subpel_classify)."""
    height = src_planes[0].shape[0]
    width = full_width if full_width is not None else src_planes[0].shape[1]
    mad_thr = (quality >> 2) + 1
    refs = []
    for offset in range(1, n_refs):
        slot = ((frame_index + RING - offset) % RING).reshape(1)
        ref = tuple(p.index_select(0, slot)[0] for p in ring)
        refs.append(motion_mod.full_pel(src_planes, ref, ring, slot,
                                        mad_thr, x0=x0,
                                        full_width=full_width, halo=halo))
    return cuda_motion.subpel_classify(refs, src_planes, px, py, x0, width,
                                       height, mad_thr)


def quantize_planes(ty, tu, tv, qp, intra_qm):
    """Quantizes every MB's 4 luma quads and 2 chroma blocks; intra_qm
    picks the intra matrices per MB."""
    qp4 = qp.repeat_interleave(4)
    qm4 = intra_qm.repeat_interleave(4)[:, None, None]
    qm1 = intra_qm[:, None, None]
    quads = ops.mb_quads(ty).reshape(-1, 8, 8)
    qy = torch.where(qm4, ops.quantize_8x8(quads, qp4, True, True),
                     ops.quantize_8x8(quads, qp4, False, True))
    qu = torch.where(qm1, ops.quantize_8x8(tu, qp, True, False),
                     ops.quantize_8x8(tu, qp, False, False))
    qv = torch.where(qm1, ops.quantize_8x8(tv, qp, True, False),
                     ops.quantize_8x8(tv, qp, False, False))
    return qy, qu, qv


def coef_blocks(coef_y, coef_u, coef_v):
    """Coefficient planes -> the blocks dequantisation takes: luma as the
    4 quadrants of every MB ((4N, 8, 8)), U and V as (N, 8, 8), as
    engine._decode_common and wavefront._conformance_decode_core cut
    them."""
    quads = ops.mb_quads(ops.plane_to_blocks(coef_y, MB)).reshape(-1, 8, 8)
    return (quads, ops.plane_to_blocks(coef_u, MB // 2),
            ops.plane_to_blocks(coef_v, MB // 2))


def residual(qy, qu, qv, qp, intra_qm):
    """Dequantize + inverse DCT (decode.cpp:15-144) -> the residual blocks
    ((N, 16, 16), (N, 8, 8), (N, 8, 8)) int32; intra_qm picks the intra
    matrices per MB (the res_* of wavefront._conformance_decode_core)."""
    qp4 = qp.repeat_interleave(4)
    qm4 = intra_qm.repeat_interleave(4)[:, None, None]
    qm1 = intra_qm[:, None, None]
    dq_y = torch.where(qm4, ops.dequantize_8x8(qy, qp4, True, True),
                       ops.dequantize_8x8(qy, qp4, False, True))
    dq_u = torch.where(qm1, ops.dequantize_8x8(qu, qp, True, False),
                       ops.dequantize_8x8(qu, qp, False, False))
    dq_v = torch.where(qm1, ops.dequantize_8x8(qv, qp, True, False),
                       ops.dequantize_8x8(qv, qp, False, False))
    return (ops.quads_to_mb(ops.idct8(dq_y.reshape(-1, 4, 8, 8))),
            ops.idct8(dq_u), ops.idct8(dq_v))


def add_pred(res, pred, copy_mb):
    """Residual + prediction, int16-wrapped; copy MBs take the prediction
    as it is (the rec0 and the wave body's rec of
    wavefront._conformance_decode_core)."""
    copy3 = copy_mb[:, None, None]
    return tuple(torch.where(copy3, p, ops.wrap16(r + p))
                 for r, p in zip(res, pred))


def reconstruct(qy, qu, qv, qp, intra_qm, pred, copy_mb):
    """Dequantize + inverse DCT + prediction (decode.cpp:15-144) -> recon
    blocks; copy MBs take the prediction as it is."""
    return add_pred(residual(qy, qu, qv, qp, intra_qm), pred, copy_mb)


def finish_planes(state, rec_y, rec_u, rec_v, frame_index, copy_mb, qp,
                  deblock):
    """Recon planes -> deblock (q 0 on copy MBs) -> ring slot
    frame_index % RING (a device scalar: no host read), as the tail of
    wavefront._conformance_decode_core does. Returns the deblocked
    planes."""
    planes = deblock_planes(rec_y, rec_u, rec_v, copy_mb, qp, deblock)
    write_slot(state, planes, frame_index)
    return planes


def deblock_planes(rec_y, rec_u, rec_v, copy_mb, qp, deblock):
    """The in-loop deblock (K8) of recon planes, q 0 on copy MBs."""
    if not deblock:
        return rec_y, rec_u, rec_v
    hb, wb = rec_y.shape[0] // MB, rec_y.shape[1] // MB
    copy_map = copy_mb.reshape(hb, wb)
    q_map = torch.where(copy_map, 0, qp.reshape(hb, wb))
    return cuda_deblock.deblock_frame(rec_y, rec_u, rec_v, copy_map, q_map)


def write_slot(state, planes, frame_index):
    """Writes (y, u, v) planes of the ring's shape into ring slot
    frame_index % RING in place; frame_index is an int32 device scalar
    (no host read) or an int."""
    slot = torch.as_tensor(frame_index, device=state["ring_y"].device)
    slot = (slot % RING).reshape(1).long()
    for key, plane in zip(("ring_y", "ring_u", "ring_v"), planes):
        state[key].index_copy_(0, slot, plane.to(torch.int16)[None])


def encode_step(src_wire, state, *, aligned_w, aligned_h, frame_w, frame_h,
                is_inter, n_refs=RING, deblock=True, adaptive=True,
                src_fmt="yuv8"):
    """One frame through the pipeline. src_wire: uint8 tensor on the
    state's device, the source wire (native.rgb_to_yuv8 / rgb_to_yuv5d)
    prefixed with the 8-byte [frame_index, quality] int32 header.
    Returns (state, outputs); the state is updated in place."""
    frame_index, quality = _header(src_wire)
    unpack = (wire_mod.unpack_yuv5d if src_fmt == "yuv5d"
              else wire_mod.unpack_yuv8)
    y_in, u_in, v_in = unpack(src_wire[8:], aligned_h, aligned_w, frame_w,
                              frame_h)
    outputs, rec, copy_mb = encode_planes(
        y_in, u_in, v_in, state, frame_index, quality, is_inter=is_inter,
        n_refs=n_refs, deblock=deblock, adaptive=adaptive)
    write_slot(state, rec, frame_index)
    outputs["wire"], outputs["wire_tail"] = wire_mod.pack_encode_wire(
        outputs, state["coef_y"], state["coef_u"], state["coef_v"], copy_mb)
    return state, outputs


def encode_planes(y_in, u_in, v_in, state, frame_index, quality, *,
                  is_inter, n_refs=RING, deblock=True, adaptive=True, x0=0,
                  full_width=None, halo=0):
    """The body of encode_step from the int32 source planes: search,
    prediction, transform, quantization, the coefficient planes (updated
    in the state) and the deblocked reconstruction. Returns (outputs,
    (rec_y, rec_u, rec_v), the per-MB copy flags). The ring slot is not
    written: the caller writes it (write_slot), on a tile after
    the halo exchange. x0, full_width and halo as motion.inter_search
    takes them (gpu/shard.py's tiles; 0, None, 0 on a single card)."""
    dev = y_in.device
    aligned_h, aligned_w = y_in.shape
    px, py, wb, hb = _mb_coords(aligned_w, aligned_h, dev)
    n = wb * hb
    ring = (state["ring_y"], state["ring_u"], state["ring_v"])

    if is_inter:
        best = _classify_inter((y_in, u_in, v_in), ring, px, py, quality,
                               frame_index, n_refs, x0=x0,
                               full_width=full_width, halo=halo)
        block_type = best["block_type"]
    else:
        best = _intra_best(n, dev)
        block_type = (best["is_intra"].to(I32) * INTRA_BIT
                      | best["is_motion"].to(I32) * MOTION_BIT
                      | best["is_copy"].to(I32) * COPY_BIT)

    pred = _pred_planes(state, frame_index, best["target"], best["motion_x"],
                        best["motion_y"], best["sp_pred"], best["sp_amount"],
                        best["sp_index"], best["is_intra"], halo)

    # --- the transform tail (K10): residual DCT, adaptive QP, quantization,
    # the coefficient planes (stale on copy blocks), reconstruction
    copy_mb = best["is_copy"]
    coef, qp, variance, rec = cuda_tail.encode_tail(
        (y_in, u_in, v_in), pred, best["is_intra"], best["is_motion"],
        copy_mb, quality, adaptive,
        (state["coef_y"], state["coef_u"], state["coef_v"]))
    state["coef_y"], state["coef_u"], state["coef_v"] = coef
    rec = deblock_planes(*rec, copy_mb, qp, deblock)

    outputs = dict(
        block_type=block_type.to(torch.uint8),
        prediction_target=best["target"].to(torch.uint8),
        motion_x=best["motion_x"].to(torch.int16),
        motion_y=best["motion_y"].to(torch.int16),
        sp_pred=best["sp_pred"], sp_amount=best["sp_amount"],
        sp_index=best["sp_index"].to(torch.uint8),
        q_index=torch.where(copy_mb, 0, qp).to(torch.uint8),
        variance=variance,
        coef_y=state["coef_y"], coef_u=state["coef_u"],
        coef_v=state["coef_v"])
    return outputs, rec, copy_mb


def _decode_common(table, coef_y, coef_u, coef_v, state, frame_index,
                   deblock=True, carry=False):
    """Shared reconstruction body (decode.cpp:15-144, fast-mode streams).
    coef planes int32-valued; with `carry`, copy MBs take the state's
    stale coefficients instead (decode_step_coo). Returns (rec_y, rec_u,
    rec_v) and updates the state's ring and coefficient planes in
    place."""
    out = decode_planes(table, coef_y, coef_u, coef_v, state, frame_index,
                        deblock, carry=carry)
    write_slot(state, out, frame_index)
    if not carry:
        state["coef_y"] = coef_y.to(torch.int16)
        state["coef_u"] = coef_u.to(torch.int16)
        state["coef_v"] = coef_v.to(torch.int16)
    return out


def decode_planes(table, coef_y, coef_u, coef_v, state, frame_index,
                  deblock=True, halo=0, carry=False):
    """The deblocked reconstruction of one fast-mode frame (decode.cpp:
    15-144) from its block table and int32-valued coefficient planes,
    against the state's ring (halo: its halo columns); the ring slot is
    not written (_decode_common writes it; a tile, after the halo
    exchange). With `carry`, copy MBs take the state's stale coefficients
    (FORMAT.md §4) and the carried planes replace the state's, in the
    same launch (K11)."""
    block_type = table["block_type"].to(I32)
    is_intra = (block_type & INTRA_BIT) != 0
    is_motion = (block_type & MOTION_BIT) != 0
    is_copy = (block_type & COPY_BIT) != 0

    # stale-field gating (FORMAT.md §4)
    target = torch.where(is_intra, 0, table["prediction_target"].to(I32))
    mx = torch.where(is_motion, table["motion_x"].to(I32), 0)
    my = torch.where(is_motion, table["motion_y"].to(I32), 0)
    sp_pred = is_motion & table["sp_pred"]
    qp = table["q_index"].to(I32)
    intra_default = is_intra & ~is_motion
    pred = _pred_planes(state, frame_index, target, mx, my, sp_pred,
                        table["sp_amount"], table["sp_index"].to(I32),
                        intra_default, halo)

    stale = (state["coef_y"], state["coef_u"], state["coef_v"]) \
        if carry else None
    rec, carried, _ = cuda_tail.decode_tail(
        (coef_y, coef_u, coef_v), qp, intra_default, is_copy, pred,
        stale=stale)
    if carry:
        state["coef_y"], state["coef_u"], state["coef_v"] = carried
    return deblock_planes(*rec, is_copy, qp, deblock)


def decode_step(table, coef, state, frame_index, *, width, height,
                aligned_w, aligned_h, deblock=True):
    """Reconstruction of one parsed frame from dense coefficient planes,
    returning RGB (no intra-motion blocks: the host checks that before
    dispatch). table/coef: dicts of tensors on the state's device."""
    rec_y, rec_u, rec_v = _decode_common(
        table, coef["coef_y"].to(I32), coef["coef_u"].to(I32),
        coef["coef_v"].to(I32), state,
        torch.tensor(frame_index, dtype=I32, device=state["ring_y"].device),
        deblock)
    rgb = ops.yuv420_to_rgb(rec_y[:height, :width],
                            rec_u[:(height + 1) // 2, :(width + 1) // 2],
                            rec_v[:(height + 1) // 2, :(width + 1) // 2])
    return state, rgb


def decode_step_coo(in_wire, state, *, aligned_w, aligned_h, frame_w=None,
                    frame_h=None, deblock=True, coo_k=None, out_fmt="yuv8"):
    """Transfer-optimized decode: one packed upload (8-byte header with the
    frame index + residual COO + block table), YUV wire out. Copy blocks
    keep their stale coefficients; non-copy blocks are rebuilt from the
    COO list. COO positions past the planes (the bucket's unused tail)
    are dropped, not clamped."""
    n = (aligned_w // MB) * (aligned_h // MB)
    k = coo_k if coo_k is not None else wire_mod.COO_K
    frame_index = in_wire[:8].view(I32)[0]
    body = in_wire[8:]
    table = wire_mod.unpack_table_wire(body[6 * k:], n)
    rec_y, rec_u, rec_v = _decode_common(
        table, *coo_planes(body, k, aligned_w, aligned_h), state,
        frame_index, deblock, carry=True)
    pack = (wire_mod.pack_yuv5d_wire if out_fmt == "yuv5d"
            else wire_mod.pack_yuv_wire)
    return state, pack(rec_y, rec_u, rec_v,
                       frame_w if frame_w is not None else aligned_w,
                       frame_h if frame_h is not None else aligned_h)


def coo_planes(body, k, aligned_w, aligned_h):
    """The residual COO at the head of a decoder input wire's body (k int32
    positions, then k int16 values) -> int32 coefficient planes (Y, U, V)
    (engine.decode_step_coo, wavefront.conformance_decode_step). Positions
    past the planes (the bucket's unused tail) are dropped, not clamped,
    as JAX's mode="drop" scatter does: they add 0 at position 0, which
    needs no host read of how many there are."""
    coo_pos = wire_mod._view(body[:4 * k], I32).long()
    coo_val = wire_mod._view(body[4 * k:6 * k], torch.int16).to(I32)
    ys = aligned_h * aligned_w
    cs = (aligned_h // 2) * (aligned_w // 2)
    coo_pos, keep = wire_mod.drop_out_of_range(coo_pos, ys + 2 * cs)
    flat = torch.zeros(ys + 2 * cs, dtype=I32, device=body.device)
    flat.index_add_(0, torch.where(keep, coo_pos, 0),
                    torch.where(keep, coo_val, 0))
    return (flat[:ys].reshape(aligned_h, aligned_w),
            flat[ys:ys + cs].reshape(aligned_h // 2, aligned_w // 2),
            flat[ys + cs:].reshape(aligned_h // 2, aligned_w // 2))


def carry_coef(stale, is_copy, new_coef):
    """The frame's int32 coefficient planes: copy MBs keep the stale
    coefficients (the state's int16 planes, FORMAT.md §4), the others
    take new_coef (the carry of engine.decode_step_coo and
    wavefront._conformance_decode_core; K11's plain version)."""
    ymask = mb_mask(is_copy, *stale[0].shape)
    cmask = ymask[::2, ::2]
    return tuple(torch.where(mask, old.to(I32), new)
                 for old, mask, new in zip(stale, (ymask, cmask, cmask),
                                           new_coef))


def mb_mask(flags, height, width):
    """(N,) per-MB flags -> the (height, width) luma sample mask (chroma:
    [::2, ::2]), the jnp.repeat masks of engine.decode_step_coo and
    wavefront._conformance_decode_core."""
    return flags.reshape(height // MB, width // MB) \
        .repeat_interleave(MB, 0).repeat_interleave(MB, 1)
