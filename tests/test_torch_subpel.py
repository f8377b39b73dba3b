"""The fast search's sub-pel scan (K9's plain version,
cuda_motion.subpel_scan_plain) against cairo_tpu, on the CPU with exact
equality: gpu.motion.inter_search against tpu.motion.inter_search (its
XLA anchor, windows given) field for field, on content built so that each
rule of the scan decides something. Each case also checks, from the
candidates the fold saw, that its rule was exercised. The kernel itself
is held against the plain version in test_torch_cuda.py."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cairo_tpu.tpu import motion as jmotion, ops as jops
from cairo_tpu_torch import tables
from cairo_tpu_torch.gpu import api, cuda_motion, motion as tmotion
from cairo_tpu_torch.synth import synth_frames

RING = 4
H, W = 64, 96
SAD_THRESHOLD = tables.MOTION_SAD_THRESHOLD


def _smooth(rng, h, w, lo=16, hi=240):
    """A smooth random plane in [lo, hi]: sub-pel blends of it predict its
    fractional shifts well."""
    yy, xx = np.mgrid[0:h, 0:w]
    f = np.zeros((h, w))
    for _ in range(3):
        fx, fy = rng.uniform(0.05, 0.3, 2)
        px, py = rng.uniform(0, 2 * np.pi, 2)
        f += np.sin(fx * xx + px) * np.cos(fy * yy + py)
    f = (f - f.min()) / (f.max() - f.min())
    return np.rint(lo + (hi - lo) * f).astype(np.int32)


def _quarter_shift(p, dx, dy):
    """p moved by (dx, dy) full-pel plus a quarter-pel step towards
    (dx + 1, dy + 1): the best full-pel vector is (dx, dy) and its
    quarter-pel neighbour in direction (1, 1) predicts it exactly."""
    a = np.roll(p, (-dy, -dx), (0, 1))
    b = np.roll(p, (-dy - 1, -dx - 1), (0, 1))
    return (3 * a + b + 2) // 4


def _shifted(rng, dx, dy, lo=16, hi=240, noise=0):
    """(src, ref) plane triples: smooth references in [lo, hi], sources
    their quarter-pel shift by (dx, dy) (chroma by (dx >> 1, dy >> 1)),
    clipped to 0..255, plus uniform noise in [-noise, noise] (per MB row
    of the luma when `noise` is a list)."""
    ref = [_smooth(rng, H, W, lo, hi), _smooth(rng, H // 2, W // 2, lo, hi),
           _smooth(rng, H // 2, W // 2, lo, hi)]
    src = [_quarter_shift(ref[0], dx, dy),
           _quarter_shift(ref[1], dx >> 1, dy >> 1),
           _quarter_shift(ref[2], dx >> 1, dy >> 1)]
    amp = np.repeat(np.broadcast_to(noise, (H // 16,)), 16)[:, None]
    src[0] = src[0] + np.rint(rng.uniform(-1, 1, (H, W)) * amp).astype(
        np.int32)
    return [np.clip(s, 0, 255).astype(np.int32) for s in src], ref


def _content(case, rng):
    if case.startswith("parity"):
        dx, dy = {"parity_ee": (4, 2), "parity_oe": (5, 2),
                  "parity_eo": (4, 3), "parity_oo": (5, 3)}[case]
        return _shifted(rng, dx, dy, noise=1)
    if case == "reach16":        # +16 in x, -16 in y
        return _shifted(rng, 16, -16, noise=1)
    if case == "frozen":         # the top half unchanged, the rest shifted
        src, ref = _shifted(rng, 3, 1, noise=1)
        src[0][:32] = ref[0][:32] + rng.integers(-1, 2, (32, W))
        for s, r in zip(src[1:], ref[1:]):
            s[:16] = r[:16]
        return [np.clip(s, 0, 255).astype(np.int32) for s in src], ref
    if case == "copy_ties":
        # vertical stripes moved one column: the co-located block is not
        # copy-grade, the full-pel best (+-1, 0) is, and the vertical
        # sub-pel neighbours blend a stripe with itself (equal MAD)
        ref_y = (100 + 20 * (np.arange(W) % 2))[None, :].repeat(H, 0)
        flat = np.full((H // 2, W // 2), 128)
        src_y = np.roll(ref_y, 1, 1) + rng.integers(0, 2, (H, W))
        return ([src_y.astype(np.int32), flat.astype(np.int32),
                 flat.astype(np.int32)],
                [ref_y.astype(np.int32), flat.astype(np.int32),
                 flat.astype(np.int32)])
    if case == "sad_threshold":  # block SADs from some 2,500 to 25,000
        return _shifted(rng, 2, 1, noise=[20, 50, 80, 110])
    if case == "overshoot":      # references far outside 0..255
        return _shifted(rng, 3, -2, lo=-300, hi=560, noise=2)
    return _shifted(rng, -3, 2, noise=4)   # "mixed"


@functools.lru_cache(maxsize=None)
def _anchor(x0, full_width):
    """tpu.motion.inter_search jitted once per tile geometry (the cases
    share its shapes), so that the file stays quick."""
    return jax.jit(functools.partial(jmotion.inter_search, x0=x0,
                                     full_width=full_width))


def _run(case, quality, x0=0, full_width=None, seed=0):
    """Runs both searches on the case's content; returns (torch result,
    JAX result, what K2 gave, the fold's candidates as recorded)."""
    rng = np.random.default_rng(sum(map(ord, case)) + seed)
    src, ref = _content(case, rng)
    n = (H // 16) * (W // 16)
    idx = np.arange(n)
    px = ((idx % (W // 16)) * 16).astype(np.int32)
    py = ((idx // (W // 16)) * 16).astype(np.int32)
    blocks = [jops.plane_to_blocks(jnp.asarray(p), b)
              for p, b in zip(src, (16, 8, 8))]
    refs = [jnp.asarray(p) for p in ref]
    want = _anchor(x0, full_width)(
        tuple(blocks), tuple(jnp.asarray(p) for p in src), tuple(refs),
        jmotion.pred_windows(tuple(refs)), jnp.asarray(px), jnp.asarray(py),
        jnp.int32(quality))

    slot = 2
    rings = []
    for p in ref:
        stack = rng.integers(-300, 560, (RING,) + p.shape).astype(np.int16)
        stack[slot] = p
        rings.append(torch.from_numpy(stack))
    seen = dict(dense=None, cands=[], accept=[])
    dense, fold, accept = (cuda_motion.dense_select, cuda_motion.fold_subpel,
                           cuda_motion.accept_subpel)

    def dense_rec(*args):
        seen["dense"] = dense(*args)
        return seen["dense"]

    def fold_rec(sad, mad, cands, mad_thr):
        cands = list(cands)
        seen["cands"] += cands
        return fold(sad, mad, cands, mad_thr)

    def accept_rec(c_sad, c_mad, sad, mad, mad_thr):
        seen["accept"].append((sad, mad, mad_thr))
        return accept(c_sad, c_mad, sad, mad, mad_thr)

    mp = pytest.MonkeyPatch()
    mp.setattr(cuda_motion, "dense_select", dense_rec)
    mp.setattr(cuda_motion, "fold_subpel", fold_rec)
    mp.setattr(cuda_motion, "accept_subpel", accept_rec)
    try:
        got = tmotion.inter_search(
            tuple(torch.from_numpy(np.asarray(b)) for b in blocks),
            tuple(torch.from_numpy(p) for p in src),
            tuple(r[slot] for r in rings), tuple(rings),
            torch.tensor([slot], dtype=torch.int32), torch.from_numpy(px),
            torch.from_numpy(py), torch.tensor(quality, dtype=torch.int32),
            x0=x0, full_width=full_width)
    finally:
        mp.undo()
    assert len(seen["cands"]) == len(seen["accept"]) == 16
    # per candidate: ok, c_sad, c_mad and the state it was judged against
    cands = [dict(ok=c[0].numpy(), c_sad=c[3].numpy(), c_mad=c[4].numpy(),
                  sad=a[0].numpy(), mad=a[1].numpy(), thr=int(a[2]))
             for c, a in zip(seen["cands"], seen["accept"])]
    return got, want, seen["dense"], cands


def _eq_fields(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)


CASES = ["parity_ee", "parity_oe", "parity_eo", "parity_oo", "reach16",
         "frozen", "copy_ties", "sad_threshold", "overshoot", "mixed"]


@pytest.fixture(scope="module")
def runs():
    out = {(c, 16): _run(c, 16) for c in CASES}
    out["mixed", 4] = _run("mixed", 4)
    out["mixed", 29] = _run("mixed", 29)
    out["tile", 16] = _run("mixed", 16, x0=32, full_width=160, seed=5)
    return out


@pytest.mark.parametrize("key", [(c, 16) for c in CASES]
                         + [("mixed", 4), ("mixed", 29), ("tile", 16)])
def test_inter_search_matches_anchor(runs, key):
    got, want, _, _ = runs[key]
    _eq_fields(got, want)
    # sub-pel candidates were taken where the content lets them win
    assert got["sp_pred"].any() or key[0] in ("copy_ties", "frozen")


@pytest.mark.parametrize("case,parity", [
    ("parity_ee", (0, 0)), ("parity_oe", (1, 0)), ("parity_eo", (0, 1)),
    ("parity_oo", (1, 1))])
def test_parities_reach_every_chroma_shift(runs, case, parity):
    got, _, _, _ = runs[case, 16]
    mx, my = got["motion_x"].numpy(), got["motion_y"].numpy()
    hit = ((mx & 1) == parity[0]) & ((my & 1) == parity[1]) & \
        got["sp_pred"].numpy()
    # the chroma neighbour of direction (+-1, +-1) then shifts by -1 and 0
    # (even) or 0 and 1 (odd) in each axis
    assert hit.sum() >= 4


def test_reach16_candidates_leave_the_frame(runs):
    _, _, dense, cands = runs["reach16", 16]
    mx, my, frozen = dense[0].numpy(), dense[1].numpy(), dense[4].numpy()
    edge = ~frozen & ((mx == 16) | (my == -16))
    assert edge.any()
    out = np.zeros_like(edge)
    for c in cands:
        out |= edge & ~c["ok"]
    assert out.any()


def test_frozen_mbs_take_no_candidate(runs):
    got, _, dense, cands = runs["frozen", 16]
    frozen = dense[4].numpy()
    assert frozen.any() and not frozen.all()
    assert not any((c["ok"] & frozen).any() for c in cands)
    assert not got["sp_pred"].numpy()[frozen].any()


def test_copy_branch_ties_keep_the_best(runs):
    _, _, _, cands = runs["copy_ties", 16]
    ties = sum(int((c["ok"] & (c["mad"] < c["thr"])
                    & (c["c_mad"] == c["mad"])).sum()) for c in cands)
    assert ties > 0


def test_sad_threshold_decides_both_ways(runs):
    _, _, _, cands = runs["sad_threshold", 16]
    plain = [c["ok"] & (c["mad"] >= c["thr"]) & (c["c_sad"] < c["sad"])
             & (c["c_mad"] >= c["thr"]) for c in cands]
    below = sum(int((p & (c["c_sad"] < SAD_THRESHOLD)).sum())
                for p, c in zip(plain, cands))
    above = sum(int((p & (c["c_sad"] >= SAD_THRESHOLD)).sum())
                for p, c in zip(plain, cands))
    assert below > 0 and above > 0


def test_overshoot_windows_blend_negative_and_wide_samples(runs):
    got, _, _, _ = runs["overshoot", 16]
    assert got["sp_pred"].any()


def test_one_subpel_scan_per_inter_search(monkeypatch):
    """Each inter_search launches K9 once (here its plain version), so an
    inter frame of the fast encoder takes one per reference."""
    calls = []
    scan = cuda_motion.subpel_scan

    def counted(*args):
        calls.append(args)
        return scan(*args)

    monkeypatch.setattr(cuda_motion, "subpel_scan", counted)
    enc = api.GpuEncoder(device="cpu")
    frames = synth_frames(64, 48, 2)
    enc.encode(frames[0])
    assert calls == []
    enc.encode(frames[1])
    assert len(calls) == RING - 1
