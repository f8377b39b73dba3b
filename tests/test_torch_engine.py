"""cairo_tpu_torch.gpu.engine against cairo_tpu.tpu.engine on the CPU:
encode_step and decode_step_coo outputs and the ring/coefficient state,
field by field, over one intra and two inter frames at 72x56 (not a
multiple of 16), for every source and output wire format. Exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cairo_tpu import native as jnative
from cairo_tpu.blocktypes import BlockTable
from cairo_tpu.tpu import engine as jengine, wire as jwire
from cairo_tpu_torch import native as tnative
from cairo_tpu_torch.gpu import engine as tengine

from util_video import synth_frames

W, H = 72, 56
AW, AH = 80, 64
STATE_KEYS = ("ring_y", "ring_u", "ring_v", "coef_y", "coef_u", "coef_v")
TABLE_KEYS = ("block_type", "prediction_target", "motion_x", "motion_y",
              "sp_pred", "sp_amount", "sp_index", "q_index", "variance")


def _eq(got, want, msg):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def _src_wire(frame, index, quality, fmt):
    wire = tnative.rgb_to_yuv8(frame, AW, AH, index, quality)
    np.testing.assert_array_equal(
        wire, jnative.rgb_to_yuv8(frame, AW, AH, index, quality))
    if fmt == "yuv5d":  # the 5-bit packing, exact at this size as well
        n_exc, wire = tnative.yuv8_to_yuv5d(wire, AW, AH)
        assert n_exc <= tnative.UP_EXC_K
    return wire


def _frames(n, seed):
    """Moving content on the left, a flat area on the right: the inter
    frames carry motion, delta and copy blocks."""
    frames = synth_frames(W, H, n, seed=seed)
    for f in frames:
        f[:, 40:] = 120
    return frames


def _decode_wire(out, index):
    """The decoder upload for an encoded frame: header + COO + table."""
    n = (AW // 16) * (AH // 16)
    table, count, pos, val = jwire.unpack_encode_wire(
        np.asarray(out["wire"]), n, tail=lambda: np.asarray(out["wire_tail"]))
    assert count <= jwire.COO_K
    coo_k = jwire.COO_SMALL if count <= jwire.COO_SMALL else jwire.COO_K
    bt = BlockTable(**{k: np.asarray(out[k]) for k in TABLE_KEYS})
    return np.concatenate([
        np.array([index, 0], np.int32).view(np.uint8),
        pos[:coo_k].view(np.uint8), val[:coo_k].view(np.uint8),
        jwire.pack_table_np(bt)]), coo_k


@pytest.mark.parametrize("src_fmt", ["yuv8", "yuv5d"])
@pytest.mark.parametrize("out_fmt", ["yuv8", "yuv5d"])
def test_encode_and_decode_steps_match(src_fmt, out_fmt):
    frames = _frames(3, 11)
    qualities = (16, 16, 24)
    jstate = jengine.init_state(AW, AH)
    tstate = tengine.init_state(AW, AH, "cpu")
    jdec = jengine.init_state(AW, AH)
    tdec = tengine.init_state(AW, AH, "cpu")
    for i, (frame, q) in enumerate(zip(frames, qualities)):
        wire = _src_wire(frame, i, q, src_fmt)
        kw = dict(aligned_w=AW, aligned_h=AH, frame_w=W, frame_h=H,
                  is_inter=i > 0, src_fmt=src_fmt)
        jstate, jout = jengine.encode_step(jnp.asarray(wire), jstate, **kw)
        tstate, tout = tengine.encode_step(torch.from_numpy(wire), tstate,
                                           **kw)
        for key in TABLE_KEYS + ("coef_y", "coef_u", "coef_v", "wire",
                                 "wire_tail"):
            _eq(tout[key], jout[key], f"frame {i} encode output {key}")
        for key in STATE_KEYS:
            _eq(tstate[key], jstate[key], f"frame {i} encode state {key}")
        if i > 0:  # the inter frames really exercise motion and copy
            types = set(np.asarray(jout["block_type"]).tolist())
            assert {0, 2, 4} <= types, types

        in_wire, coo_k = _decode_wire(jout, i)
        kw = dict(aligned_w=AW, aligned_h=AH, frame_w=W, frame_h=H,
                  coo_k=coo_k, out_fmt=out_fmt)
        jdec, jyuv = jengine.decode_step_coo(jnp.asarray(in_wire), jdec, **kw)
        tdec, tyuv = tengine.decode_step_coo(torch.from_numpy(in_wire), tdec,
                                             **kw)
        _eq(tyuv, jyuv, f"frame {i} decode wire")
        for key in STATE_KEYS:
            _eq(tdec[key], jdec[key], f"frame {i} decode state {key}")
            _eq(tdec[key], tstate[key], f"frame {i} decoder vs encoder {key}")


def test_dense_decode_step_matches():
    """decode_step (the COO-overflow path) from dense coefficient planes."""
    frames = _frames(2, 12)
    enc = tengine.init_state(AW, AH, "cpu")
    jdec = jengine.init_state(AW, AH)
    tdec = tengine.init_state(AW, AH, "cpu")
    for i, frame in enumerate(frames):
        wire = _src_wire(frame, i, 8, "yuv8")
        enc, out = tengine.encode_step(
            torch.from_numpy(wire), enc, aligned_w=AW, aligned_h=AH,
            frame_w=W, frame_h=H, is_inter=i > 0)
        table = {k: out[k].numpy().copy() for k in TABLE_KEYS
                 if k != "variance"}
        coef = {k: out[k].numpy().copy() for k in ("coef_y", "coef_u",
                                                   "coef_v")}
        kw = dict(width=W, height=H, aligned_w=AW, aligned_h=AH)
        jdec, jrgb = jengine.decode_step(
            {k: jnp.asarray(v) for k, v in table.items()},
            {k: jnp.asarray(v) for k, v in coef.items()}, jdec, i, **kw)
        tdec, trgb = tengine.decode_step(
            {k: torch.from_numpy(v) for k, v in table.items()},
            {k: torch.from_numpy(v) for k, v in coef.items()}, tdec, i, **kw)
        _eq(trgb, jrgb, f"frame {i} rgb")
        for key in STATE_KEYS:
            _eq(tdec[key], jdec[key], f"frame {i} state {key}")
