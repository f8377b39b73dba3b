"""The fast classification (K9 with every reference and the merge,
cuda_motion.subpel_classify) against cairo_tpu, and K10's arithmetic, on
the CPU with exact equality.

  * engine._classify_inter (its plain version on CPU tensors: the sub-pel
    scan per reference, then the merge) against
    cairo_tpu.tpu.engine._classify_inter (its XLA anchor, windows given)
    at n_refs 2, 3 and 4, and against tpu.shard._classify_tile at a tile
    origin with the ring halo, field for field. The content gives each
    MB row one job: a copy beside a non-copy of lower SAD, a lower SAD
    after a higher one, two equal SADs, a dark source no reference beats
    (intra), a reference equal to the source (frozen). From the
    references' results as the merge saw them, each test checks that its
    rule decided something.
  * K10's reciprocal table (cuda_tail.reciprocals): every divisor meets
    the round-up condition, and a numpy model of the kernel's
    multiply-high division equals // at its edges and on a seeded sample;
    the table's layout and the DCT basis as csrc/tail.cu declares them;
    numpy models of K10's quantizer (by reciprocals) and of its DCT passes
    (outputs k and 7 - k paired by the basis' symmetry) against gpu/ops.
The kernels themselves are held against these plain versions in
test_torch_cuda.py."""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cairo_tpu.tpu import engine as jengine, motion as jmotion, ops as jops
from cairo_tpu.tpu import shard as jshard
from cairo_tpu_torch import tables
from cairo_tpu_torch.blocktypes import COPY_BIT, INTRA_BIT, MOTION_BIT
from cairo_tpu_torch.gpu import cuda_motion, cuda_tail, engine, ops

RING = 4
FRAME = 3                       # references at slots 2, 1, 0
HALO = jshard.HALO
CSRC = pathlib.Path(cuda_tail.__file__).parent / "csrc"
JOBS = ("copy_over_lower_sad", "lower_sad", "equal_sad", "intra",
        "frozen")


def _content(rng, h, w, halo=0):
    """Source planes (h, w) and a ring (RING, h, w + 2 halo) of uint8-range
    noise, MB row r doing JOBS[r % 5]: the references at offsets 1, 2, 3
    (slots 2, 1, 0) equal to the source, but for
      copy_over_lower_sad: offset 1 the source + 3 (a copy), offset 2 the
        source with one luma sample per MB off by 10 (SAD 10, no copy);
      lower_sad: offset 1 two samples off (SAD 20), offset 2 one;
      equal_sad: offsets 1 and 2 the same sample off;
      intra: a dark source (0..3) and noise references;
      frozen: offset 3 the source itself.
    A reference that a job does not name is noise there, which no shift
    of the source matches."""
    cs = (h // 2, (w + 2 * halo) // 2)
    src = [rng.integers(0, 256, (h, w)), rng.integers(0, 256, (h // 2,
                                                               w // 2)),
           rng.integers(0, 256, (h // 2, w // 2))]
    ring = [rng.integers(0, 256, (RING, h, w + 2 * halo)),
            rng.integers(0, 256, (RING,) + cs),
            rng.integers(0, 256, (RING,) + cs)]
    slot = {1: 2, 2: 1, 3: 0}
    for r in range(h // 16):
        job = JOBS[r % 5]
        rows = [slice(16 * r, 16 * r + 16), slice(8 * r, 8 * r + 8),
                slice(8 * r, 8 * r + 8)]
        if job == "intra":
            for p, rs in zip(src, rows):
                p[rs] = rng.integers(0, 4, p[rs].shape)
            continue
        same = {"copy_over_lower_sad": (1, 2), "lower_sad": (1, 2),
                "equal_sad": (1, 2), "frozen": (3,)}[job]
        for i, (p, rs) in enumerate(zip(src, rows)):
            m = halo if i == 0 else halo // 2
            for off in same:
                ring[i][slot[off], rs, m:m + p.shape[1]] = p[rs]
            if job == "copy_over_lower_sad":
                ring[i][slot[1], rs, m:m + p.shape[1]] += 3
        y = ring[0]
        cols = np.arange(halo + 5, halo + w, 16)       # one sample an MB
        if job == "copy_over_lower_sad":
            y[slot[2], 16 * r + 7, cols] += 10
        elif job == "lower_sad":
            y[slot[1], 16 * r + 7, cols] += 10
            y[slot[1], 16 * r + 9, cols] += 10
            y[slot[2], 16 * r + 7, cols] += 10
        elif job == "equal_sad":
            y[slot[1], 16 * r + 7, cols] += 10
            y[slot[2], 16 * r + 7, cols] += 10
    return ([p.astype(np.int32) for p in src],
            [r.astype(np.int16) for r in ring])


@functools.lru_cache(maxsize=None)
def _anchor(n_refs):
    return jax.jit(functools.partial(jengine._classify_inter, n_refs=n_refs))


@functools.lru_cache(maxsize=None)
def _tile_anchor():
    return jax.jit(jshard._classify_tile, static_argnames=("full_width",))


def _run(h, w, n_refs, quality, *, x0=None, full_width=None, seed=0):
    """Both classifications of one frame; returns (port's best, JAX's
    best, the port's per-reference results and K2 outputs as the merge
    saw them, the intra SAD)."""
    rng = np.random.default_rng(seed + 7 * n_refs + h)
    halo = 0 if x0 is None else HALO
    src, ring = _content(rng, h, w, halo)
    n = (h // 16) * (w // 16)
    idx = np.arange(n)
    px = ((idx % (w // 16)) * 16).astype(np.int32)
    py = ((idx // (w // 16)) * 16).astype(np.int32)
    blocks = tuple(jops.plane_to_blocks(jnp.asarray(p), b)
                   for p, b in zip(src, (16, 8, 8)))
    jring = tuple(jnp.asarray(r) for r in ring)
    if x0 is None:
        wins = [jmotion.pred_windows(tuple(jnp.asarray(r[s], jnp.int32)
                                           for r in ring))
                for s in range(RING)]
        state_wins = tuple(jnp.stack([wn[i] for wn in wins])
                           for i in range(3))
        want = _anchor(n_refs)(
            blocks, tuple(jnp.asarray(p) for p in src), jring, state_wins,
            jnp.asarray(px), jnp.asarray(py), jnp.int32(quality),
            jnp.int32(FRAME))
    else:
        want = _tile_anchor()(
            blocks, tuple(jnp.asarray(p) for p in src), jring,
            jnp.asarray(px), jnp.asarray(py), jnp.int32(quality),
            jnp.int32(FRAME), jnp.int32(x0), full_width=full_width)

    seen = dict(dense=[], scans=[])
    dense, scan = cuda_motion.dense_select, cuda_motion.subpel_scan

    def dense_rec(*args):
        seen["dense"].append(dense(*args))
        return seen["dense"][-1]

    def scan_rec(*args):
        seen["scans"].append(scan(*args))
        return seen["scans"][-1]

    mp = pytest.MonkeyPatch()
    mp.setattr(cuda_motion, "dense_select", dense_rec)
    mp.setattr(cuda_motion, "subpel_scan", scan_rec)
    try:
        got = engine._classify_inter(
            tuple(torch.from_numpy(p) for p in src),
            tuple(torch.from_numpy(r) for r in ring), torch.from_numpy(px),
            torch.from_numpy(py), torch.tensor(quality, dtype=torch.int32),
            torch.tensor(FRAME, dtype=torch.int32), n_refs,
            x0=0 if x0 is None else x0, full_width=full_width, halo=halo)
    finally:
        mp.undo()
    intra_sad = np.abs(np.asarray(blocks[0])).sum(axis=(1, 2))
    return got, want, seen, intra_sad


CONFIGS = {"176x144_refs2": (144, 176, 2), "176x144_refs3": (144, 176, 3),
           "176x144_refs4": (144, 176, 4), "64x96_refs4": (64, 96, 4)}


@pytest.fixture(scope="module")
def runs():
    out = {key: _run(*cfg, 16) for key, cfg in CONFIGS.items()}
    out["tile"] = _run(96, 64, RING, 16, x0=64, full_width=192, seed=3)
    return out


@pytest.mark.parametrize("key", list(CONFIGS) + ["tile"])
def test_classify_matches_anchor(runs, key):
    got, want, seen, _ = runs[key]
    n_refs = RING if key == "tile" else CONFIGS[key][2]
    assert len(seen["scans"]) == n_refs - 1
    assert tuple(got) == cuda_motion.CLASSIFY_FIELDS + ("block_type",)
    for k in cuda_motion.CLASSIFY_FIELDS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    bt = (np.asarray(want["is_intra"]) * INTRA_BIT
          | np.asarray(want["is_motion"]) * MOTION_BIT
          | np.asarray(want["is_copy"]) * COPY_BIT)
    assert got["block_type"].dtype == torch.uint8
    np.testing.assert_array_equal(got["block_type"].numpy(), bt)


def _decisions(run):
    """How often each merge rule decided, replaying the merge over the
    references' results in offset order."""
    got, _, seen, intra_sad = run
    b_sad = intra_sad.astype(np.int64)
    b_copy = np.zeros(b_sad.shape, bool)
    b_intra = np.ones(b_sad.shape, bool)
    count = dict.fromkeys(("copy_over_lower_sad", "lower_sad", "equal_sad"),
                          0)
    for scan in seen["scans"]:
        sad, copy = scan["sad"].numpy(), scan["is_copy"].numpy()
        differ = copy != b_copy
        count["copy_over_lower_sad"] += int(
            (differ & ((copy & (sad >= b_sad)) | (b_copy & (sad < b_sad))))
            .sum())
        same = ~differ & ~b_intra
        count["lower_sad"] += int((same & (sad < b_sad)).sum())
        count["equal_sad"] += int((same & (sad == b_sad)).sum())
        take = np.where(differ, copy, sad < b_sad)
        b_sad = np.where(take, sad, b_sad)
        b_copy = np.where(take, copy, b_copy)
        b_intra &= ~take
    count["intra"] = int(b_intra.sum())
    np.testing.assert_array_equal(b_intra, got["is_intra"].numpy())
    return count


@pytest.mark.parametrize("key", ["176x144_refs4", "tile"])
@pytest.mark.parametrize("rule", ["copy_over_lower_sad", "lower_sad",
                                  "equal_sad", "intra"])
def test_each_merge_rule_decides(runs, key, rule):
    assert _decisions(runs[key])[rule] > 0


@pytest.mark.parametrize("key", ["176x144_refs4", "tile"])
def test_frozen_mbs_take_no_subpel_candidate(runs, key):
    _, _, seen, _ = runs[key]
    frozen_any = False
    for dense, scan in zip(seen["dense"], seen["scans"]):
        frozen = dense[4].numpy()
        frozen_any |= bool(frozen.any())
        assert not scan["sp_pred"].numpy()[frozen].any()
    assert frozen_any


def test_equal_sad_keeps_the_earlier_reference(runs):
    """On the rows where offsets 1 and 2 hold the same content, the best
    names offset 1."""
    got, _, _, _ = runs["176x144_refs4"]
    rows = np.arange(99) // 11
    equal = np.isin(rows % 5, [JOBS.index("equal_sad")])
    target = got["target"].numpy()
    assert (target[equal & ~got["is_intra"].numpy()] == 1).mean() > 0.5


def test_intra_when_no_reference(runs):
    """n_refs 1 searches nothing: every MB stays intra with its source
    SAD (the JAX scan over an empty range)."""
    src = [np.random.default_rng(1).integers(0, 256, s).astype(np.int32)
           for s in ((48, 64), (24, 32), (24, 32))]
    ring = tuple(torch.zeros((RING,) + p.shape, dtype=torch.int16)
                 for p in src)
    idx = torch.arange(12, dtype=torch.int32)
    got = engine._classify_inter(
        tuple(torch.from_numpy(p) for p in src), ring, (idx % 4) * 16,
        (idx // 4) * 16, torch.tensor(16, dtype=torch.int32),
        torch.tensor(1, dtype=torch.int32), 1)
    assert got["is_intra"].all() and not got["target"].any()
    np.testing.assert_array_equal(
        got["sad"].numpy(),
        np.abs(ops.plane_to_blocks(torch.from_numpy(src[0]), 16).numpy())
        .sum(axis=(1, 2)))


# ------------------------------------------------------- K10's arithmetic

def _divisors():
    qm = np.concatenate([np.asarray(tables.INTRA_QM_8x8).reshape(-1),
                         np.asarray(tables.INTER_QM_8x8).reshape(-1)])
    qp = np.arange(1, 256)
    return sorted({int(d) for d in np.concatenate([
        qm, qp << 1, tables.luma_dc_scale(np.arange(256)),
        tables.chroma_dc_scale(np.arange(256)),
        [tables.QUANTIZER_SCALE_FACTOR]])})


def _udiv(n, m, s):
    """csrc/tail.cu's udiv on uint32 n (numpy uint64 arithmetic; m and s
    arrays or ints)."""
    n = np.asarray(n, np.uint64)
    t = (n * np.asarray(m, np.uint64)) >> np.uint64(32)
    return (t + ((n - t) >> np.uint64(1))) >> (np.asarray(s, np.uint64)
                                               - np.uint64(1))


def test_every_divisor_meets_the_round_up_condition():
    for d in _divisors():
        m, s = cuda_tail.reciprocal(d)
        assert 0 <= m < 2 ** 32 and 2 ** (s - 1) < d <= 2 ** s
        assert 2 ** (32 + s) <= (2 ** 32 + m) * d <= 2 ** (32 + s) + 2 ** s


def test_reciprocal_division_equals_floor():
    """For every divisor: 0, d - 1, d, k d - 1, k d, k d + 1 over the
    uint32 range, 2^31 - 1, 2^31, 2^32 - 1 and a seeded sample."""
    rng = np.random.default_rng(17)
    for d in _divisors():
        m, s = cuda_tail.reciprocal(d)
        k = np.arange(1, 2 ** 32 // d, max(1, 2 ** 32 // d // 200),
                      dtype=np.uint64)
        n = np.concatenate([
            np.array([0, d - 1, d, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1],
                     np.uint64),
            k * np.uint64(d) - np.uint64(1), k * np.uint64(d),
            k * np.uint64(d) + np.uint64(1),
            rng.integers(0, 2 ** 32, 4000, dtype=np.uint64)])
        n = n[n < 2 ** 32]
        np.testing.assert_array_equal(_udiv(n, m, s), n // np.uint64(d),
                                      err_msg=f"d={d}")


def test_reciprocal_table_layout():
    """The words cuda_tail.reciprocals() writes are where csrc/tail.cu's
    k10::R_* constants read them, with every divisor K10 meets."""
    text = (CSRC / "tail.cu").read_text()
    declared = {k: int(v) for k, v in re.findall(
        r"constexpr int R_(\w+) = (\d+);", text)}
    assert declared == cuda_tail.RECIP_LAYOUT
    words = cuda_tail.reciprocals().view(np.uint32).astype(np.int64)
    lay = cuda_tail.RECIP_LAYOUT

    def entry(at):
        return tuple(words[at:at + 4])

    def want(d):
        m, s = cuda_tail.reciprocal(d)
        return m, s - 1, d, d // 2

    for k, qm in enumerate((tables.INTRA_QM_8x8, tables.INTER_QM_8x8)):
        for i, d in enumerate(np.asarray(qm).reshape(-1)):
            assert entry(lay["QM"] + 4 * (64 * k + i)) == want(int(d))
    for qp in range(256):
        assert entry(lay["QP2"] + 4 * qp) == want(max(qp, 1) << 1)
        for key, fn in (("DCL", tables.luma_dc_scale),
                        ("DCC", tables.chroma_dc_scale)):
            assert entry(lay[key] + 4 * qp) == \
                want(int(fn(np.asarray([qp]))[0]))
    assert entry(lay["SF"]) == want(tables.QUANTIZER_SCALE_FACTOR)


def test_no_dividend_reaches_2_31():
    """K10 divides |n| < 2^31 only, so abs() never wraps and ops'
    INT32_MIN case lies outside its domain: coefficients and residuals
    are int16, the largest products bounded from the tables."""
    qm = int(max(np.max(tables.INTRA_QM_8x8), np.max(tables.INTER_QM_8x8)))
    sf = int(tables.QUANTIZER_SCALE_FACTOR)
    dc = int(max(np.max(tables.luma_dc_scale(np.arange(256))),
                 np.max(tables.chroma_dc_scale(np.arange(256)))))
    assert 2 * 2 ** 15 * qm * 255 < 2 ** 31          # dequantization
    assert 2 ** 15 * sf + qm < 2 ** 31               # quantization
    assert 2 ** 15 * dc < 2 ** 31                    # intra DC
    assert 8 * 2 ** 15 * 128 * 45 < 2 ** 31          # DCT sums, DC term


def test_dct_basis_as_tail_cu_declares_it():
    text = (CSRC / "tail.cu").read_text()
    body = re.search(r"int B8\(int i\) \{\n  constexpr int b\[64\] = \{([^}]*)\}",
                     text)[1]
    b = np.array([int(v) for v in body.replace("\n", " ").split(",")])
    np.testing.assert_array_equal(b.reshape(8, 8), tables.DCT_BASIS_8)
    sign = (-1) ** np.arange(8)[:, None]
    np.testing.assert_array_equal(b.reshape(8, 8)[:, ::-1],
                                  sign * b.reshape(8, 8))


def _trunc(n, d):
    return np.sign(n) * (np.abs(n) // d)


def _rdiv128(v):
    return _trunc(np.where(v < 0, v - 64, v + 64), 128)


def _wrap16(v):
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _fdct_pass(x):
    """csrc/tail.cu k10::fdct8 over the last axis (int64 numpy)."""
    b = np.asarray(tables.DCT_BASIS_8, np.int64)
    e = x[..., :4] + x[..., 7:3:-1]
    o = x[..., :4] - x[..., 7:3:-1]
    out = []
    for k in range(8):
        acc = ((o if k & 1 else e) * b[k, :4]).sum(-1)
        out.append(_wrap16(_rdiv128(_trunc(acc * 45, 128) if k == 0
                                    else _trunc(acc, 2))))
    return np.stack(out, -1)


def _idct_pass(v):
    """csrc/tail.cu k10::idct8 over the last axis (int64 numpy)."""
    b = np.asarray(tables.DCT_BASIS_8, np.int64)
    out = [None] * 8
    for k in range(4):
        e = _trunc(v[..., 0] * b[0, k] * 45, 128)
        o = 0
        for j in range(1, 8):
            t = _trunc(v[..., j] * b[j, k], 2)
            if j & 1:
                o = o + t
            else:
                e = e + t
        out[k] = _wrap16(_rdiv128(e + o))
        out[7 - k] = _wrap16(_rdiv128(e - o))
    return np.stack(out, -1)


def _blocks(rng, n=4000):
    """Random int16 blocks, half of them at the int16 edges."""
    a = rng.integers(-32768, 32768, (n, 8, 8))
    edge = rng.choice([-32768, -32767, 32767, 0, 1, -1], (n, 8, 8))
    return np.where(rng.random((n, 8, 8)) < 0.5, a, edge)


def test_paired_dct_passes_equal_ops():
    """K10's DCT passes (rows then columns forward, columns then rows
    inverse, outputs k and 7 - k paired) equal ops.fdct8 and ops.idct8."""
    x = _blocks(np.random.default_rng(5))
    fwd = np.swapaxes(_fdct_pass(np.swapaxes(_fdct_pass(x), -1, -2)), -1,
                      -2)
    np.testing.assert_array_equal(
        fwd, ops.fdct8(torch.from_numpy(x.astype(np.int32))).numpy())
    inv = _idct_pass(np.swapaxes(_idct_pass(np.swapaxes(x, -1, -2)), -1,
                                 -2))
    np.testing.assert_array_equal(
        inv, ops.idct8(torch.from_numpy(x.astype(np.int32))).numpy())


def _quant_model(v, qp, intra, luma):
    """K10's quant() by reciprocals (numpy) over (N, 8, 8) coefficient
    blocks at per-block qp: (quantized, dequantized)."""
    words = cuda_tail.reciprocals().view(np.uint32).astype(np.int64)
    lay = cuda_tail.RECIP_LAYOUT

    def entry(at):
        """(m, s - 1, d, d // 2), each an array shaped as `at`."""
        return tuple(words[at + i] for i in range(4))

    def tdiv(n, r):
        return np.sign(n) * _udiv(np.abs(n), r[0], r[1] + 1).astype(np.int64)

    def rdiv(n, r):
        return tdiv(np.where(n < 0, n - r[3], n + r[3]), r)

    qm = entry(lay["QM"] + 4 * ((0 if intra else 64)
                                + np.arange(64).reshape(8, 8)))
    qpb = qp[:, None, None]
    q2 = entry(lay["QP2"] + 4 * qpb)
    sf = entry(lay["SF"])
    if intra:
        a = _wrap16(rdiv(rdiv(v * sf[2], qm), q2))
    else:
        qf = _wrap16(rdiv(v * sf[2], qm))
        a = _wrap16(rdiv(qf - np.sign(qf) * qpb, q2))
    d = _wrap16(tdiv(2 * a * qm[2] * qpb, sf))
    if intra:
        dc = entry(lay["DCL" if luma else "DCC"] + 4 * qp)
        a[:, 0, 0] = _wrap16(rdiv(v[:, 0, 0], dc))
        d[:, 0, 0] = _wrap16(a[:, 0, 0] * dc[2])
    return a, d


@pytest.mark.parametrize("intra,luma", [(True, True), (True, False),
                                        (False, True)])
def test_quantizer_by_reciprocals_equals_ops(intra, luma):
    """K10's quantization and dequantization by reciprocals equal
    ops.quantize_8x8 and ops.dequantize_8x8 on int16 coefficients at
    every qp 1..31 and at 128 and 255."""
    rng = np.random.default_rng(int(intra) * 2 + int(luma))
    qps = np.concatenate([np.arange(1, 32), [128, 255]])
    v = _blocks(rng, 64 * len(qps))
    qp = np.repeat(qps, 64)
    q, d = _quant_model(v.astype(np.int64), qp, intra, luma)
    tq = ops.quantize_8x8(torch.from_numpy(v.astype(np.int32)),
                          torch.from_numpy(qp.astype(np.int32)), intra, luma)
    np.testing.assert_array_equal(q, tq.numpy())
    td = ops.dequantize_8x8(tq, torch.from_numpy(qp.astype(np.int32)), intra,
                            luma)
    np.testing.assert_array_equal(d, td.numpy())


def test_ctypes_signatures_match_the_c_entries():
    """K9's and K10's signatures (cuda_motion.SUBPEL_SIGNATURE,
    cuda_tail.ENCODE_SIGNATURE) have one letter per parameter of their C
    entries, a pointer for each pointer and the stream."""
    entries = {}
    for cu in ("subpel.cu", "tail.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       (CSRC / cu).read_text()):
            entries[name] = "".join(
                "p" if "*" in q or "cudaStream_t" in q else "i"
                for q in params.split(","))
    assert entries["cairo_subpel_scan"] == cuda_motion.SUBPEL_SIGNATURE
    assert entries["cairo_encode_tail"] == cuda_tail.ENCODE_SIGNATURE


def test_check_many_raises_on_what_the_kernels_do_not_take():
    """_build.check_many, K9's and K10's argument check, raises before a
    launch on a CPU tensor, a wrong dtype, shape or contiguity, as
    _build.check does."""
    from cairo_tpu_torch.gpu import _build

    t = torch.zeros((4, 6), dtype=torch.int32)
    for bad, dtypes, shape in ((t, (torch.int32,), (4, 6)),
                               (t.t(), (torch.int32,), (6, 4)),
                               (t, (torch.int16,), (4, 6)),
                               (t, (torch.bool, torch.uint8), (4, 6)),
                               (t, (torch.int32,), (4, 5)),
                               (t.numpy(), (torch.int32,), (4, 6))):
        with pytest.raises(ValueError):
            _build.check_many([(bad, "t", dtypes, shape)], 0)


def test_subpel_differences_fold_the_blend_exactly():
    """csrc/subpel.cu's dhalf and dquarter: |src - blend| from 2 src - b
    and 4 src + 1 - 3 b with the blend's rounding folded in equal
    |src - ops.lerp_half(b, t)| and |src - ops.lerp_quarter(b, t)| over
    int16 samples (every pair of the int16 edges and a seeded sample)."""
    rng = np.random.default_rng(9)
    edge = np.array([-32768, -32767, -2, -1, 0, 1, 2, 255, 32766, 32767])
    grid = np.array(np.meshgrid(edge, edge, edge)).reshape(3, -1)
    src, b, t = np.concatenate(
        [grid, rng.integers(-32768, 32768, (3, 200000)),
         rng.integers(-300, 560, (3, 200000))], axis=1).astype(np.int64)
    half = np.abs((2 * src - b - t - ((b + t) >> 31)) >> 1)
    quarter = np.abs((4 * src + 1 - 3 * b - t - ((3 * b + t) >> 31)) >> 2)
    tb, tt = (torch.from_numpy(a.astype(np.int32)) for a in (b, t))
    np.testing.assert_array_equal(
        half, np.abs(src - ops.lerp_half(tb, tt).numpy()))
    np.testing.assert_array_equal(
        quarter, np.abs(src - ops.lerp_quarter(tb, tt).numpy()))
