"""5-bit-delta source wires for the tests of its unpack (numpy and the
port's native converter only, so the card tests import it too): a
frame's wire, and the same wire with its exception section rewritten to
hold the positions a scatter with mode="drop" treats apart."""

import numpy as np

from cairo_tpu_torch import native
from cairo_tpu_torch.synth import synth_frames

K = native.UP_EXC_K
# rewrites of a frame's exception section (besides the packer's own)
CASES = ("as_packed", "negative", "out_of_range", "duplicates", "column0",
         "crowded_rows", "full")


def content_frame(content, w, h):
    """An RGB frame: "synth" (the package's game-like content), "edges"
    (flat areas with hard edges) or "noise" (uniform random)."""
    if content == "synth":
        return synth_frames(w, h, 2)[1]
    if content == "edges":
        frame = np.full((h, w, 3), 90, np.uint8)
        frame[10:40, 20:50] = 230
        frame[100:140, 300:420] = 5
        frame[200:220, 100:104] = 255
        return frame
    return np.random.default_rng(0).integers(0, 256, (h, w, 3)) \
        .astype(np.uint8)


def yuv5d_wire(frame, aw, ah):
    """The frame's 5-bit-delta wire with its 8-byte header, packed
    whatever its exception count (past UP_EXC_K the section is left
    zero: every entry sets field 0 to 0)."""
    return native.yuv8_to_yuv5d(native.rgb_to_yuv8(frame, aw, ah, 3, 16),
                                aw, ah)[1]


def _section(wire):
    pos = wire[8:8 + 4 * K].view(np.int32)
    val = wire[8 + 4 * K:8 + 6 * K].view(np.int16)
    return pos, val


def _col0(rng, n, aw, ah):
    """n random column-0 positions over the three planes."""
    ys, cw, ch = ah * aw, aw // 2, ah // 2
    plane = rng.integers(0, 3, n)
    row = np.where(plane == 0, rng.integers(0, ah, n),
                   rng.integers(0, ch, n))
    return np.where(plane == 0, row * aw,
                    ys + (plane - 1) * ch * cw + row * cw)


def rewritten(wire, aw, ah, case, seed=0):
    """A copy of `wire` whose free exception entries (those after the
    packer's) hold the case's positions and values."""
    wire = wire.copy()
    pos, val = _section(wire)
    total = ah * aw * 3 // 2
    rng = np.random.default_rng(seed)
    used = int(np.count_nonzero((pos >= 0) & (pos < total)))
    free = K - used
    if case == "as_packed":
        return wire
    if case == "negative":
        p = rng.integers(0, total, 200)
        p[:40] = _col0(rng, 40, aw, ah)
        p = p - total
    elif case == "out_of_range":
        p = np.array([total, total + 1, 2 ** 31 - 1, -total - 1, -2 ** 31,
                      -total - 7, total + 2 ** 20, 5, -1, -total])
    elif case == "duplicates":
        base = np.concatenate([_col0(rng, 32, aw, ah),
                               rng.integers(0, total, 32)])
        p = np.repeat(base, rng.integers(2, 5, base.size))
        p = np.where(rng.random(p.size) < 0.3, p - total, p)
        rng.shuffle(p)
    elif case == "column0":
        rows = [np.arange(0, ah, 3) * aw,
                ah * aw + np.arange(1, ah // 2, 3) * (aw // 2),
                ah * aw * 5 // 4 + np.arange(2, ah // 2, 3) * (aw // 2)]
        p = np.concatenate(rows)
    elif case == "crowded_rows":
        y_row = 37 * aw + rng.integers(0, aw, 100)
        u_row = ah * aw + (ah // 4) * (aw // 2) + rng.integers(0, aw // 2, 50)
        p = np.concatenate([y_row, u_row, y_row[:10]])
    elif case == "full":
        used, free = 0, K
        p = rng.integers(-total - 100, total + 100, K)
    else:
        raise ValueError(case)
    p = p[:free]
    pos[used:used + p.size] = p
    val[used:used + p.size] = rng.integers(-2000, 2000, p.size)
    return wire


def last_entries_only(wire, aw, ah):
    """The wire with every exception entry that a later one overrides,
    and every entry the scatter drops, made a sentinel: a wire whose
    exceptions mean the same to any scatter, whatever order it applies
    them in."""
    wire = wire.copy()
    pos, _ = _section(wire)
    total = ah * aw * 3 // 2
    p = pos.astype(np.int64)
    p = np.where(p < 0, p + total, p)
    keep = (p >= 0) & (p < total)
    seen = set()
    for i in range(K - 1, -1, -1):
        if keep[i]:
            if p[i] in seen:
                keep[i] = False
            seen.add(p[i])
    pos[~keep] = total
    return wire
