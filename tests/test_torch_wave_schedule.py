"""K6's wait rule against the causal window, on the CPU (no card needed).

The kernel (csrc/wave.cu) walks MB rows as a pipeline: before MB (bi, bj)
a block waits until its own row has completed bi-1 and row bj-1 has
completed min(bi + LEAD, wb-1). From cuda_wave's LEAD and the window
extents WIN_X / WIN_Y, these tests derive for each MB the MBs its wait
rule guarantees done when it starts (the transitive closure of the two
waits) and the MBs guaranteed not yet started while it runs (those that
transitively wait on it), and require that every raster-earlier MB of
its window is in the first set and every raster-later one in the second:
then the pipelined pass reads exactly what raster order reads.

The kernel reaches the rule through its strip loader, which the last
tests model event by event: a block reads its window from SLOTS shared
strips of one MB column, each loaded once, and MB bi starts when the strip
LEAD columns to its right is in. Those tests require that each strip is
loaded after the rows above have finished it and before the row below can
start it, that its slot is not reloaded before its last reader is done,
and that the waits form no cycle.
"""

import pathlib
import re
from collections import deque

import numpy as np
import pytest

from cairo_tpu_torch.gpu import cuda_wave

MB = cuda_wave.MB
SIZES = [(1920, 1088), (176, 144), (160, 96), (48, 32)]
WAVE_CU = pathlib.Path(cuda_wave.__file__).parent / "csrc" / "wave.cu"


def guaranteed_done(wb, hb, lead):
    """g[bj, bi, r]: the last column of row r that is complete whenever MB
    (bi, bj) starts (-1: none). A row completes its MBs left to right, so
    'row r through c' means every (c' <= c, r)."""
    g = np.full((hb, wb, hb), -1, dtype=np.int32)
    for bj in range(hb):
        for bi in range(wb):
            cur = g[bj, bi]
            if bi > 0:                          # own row through bi-1
                np.maximum(cur, g[bj, bi - 1], out=cur)
                cur[bj] = max(cur[bj], bi - 1)
            if bj > 0:                          # row above through c
                c = min(bi + lead, wb - 1)
                np.maximum(cur, g[bj - 1, c], out=cur)
                cur[bj - 1] = max(cur[bj - 1], c)
    return g


def window_mbs(bi, bj, wb, hb):
    """The MBs that the window of MB (bi, bj) overlaps, inside the frame."""
    px, py = bi * MB, bj * MB
    cols = range(max(0, (px + cuda_wave.WIN_X[0]) // MB),
                 min(wb, (px + cuda_wave.WIN_X[1] - 1) // MB + 1))
    rows = range(max(0, (py + cuda_wave.WIN_Y[0]) // MB),
                 min(hb, (py + cuda_wave.WIN_Y[1] - 1) // MB + 1))
    return [(c, r) for r in rows for c in cols if (c, r) != (bi, bj)]


def order_faults(wb, hb, lead):
    """(MB, window MB, what is wrong) for every window MB that the wait
    rule with this lead does not order as raster order does."""
    g = guaranteed_done(wb, hb, lead)
    faults = []
    for bj in range(hb):
        for bi in range(wb):
            for c, r in window_mbs(bi, bj, wb, hb):
                if (r, c) < (bj, bi):
                    # raster-earlier: done before (bi, bj) starts
                    if g[bj, bi, r] < c:
                        faults.append(((bi, bj), (c, r), "maybe not done"))
                elif g[r, c, bj] < bi:
                    # raster-later: (c, r) waits on (bi, bj) transitively,
                    # so it has not started while (bi, bj) runs
                    faults.append(((bi, bj), (c, r), "maybe started"))
    return faults


def test_lead_is_the_wave_skew():
    """The wait on (bi + LEAD, bj - 1) is the wave order w = bi + SKEW bj:
    that MB lies in wave w - 1, and the window reaches LEAD MBs right."""
    assert cuda_wave.LEAD == 2
    assert cuda_wave.SKEW == cuda_wave.LEAD + 1
    assert cuda_wave.WIN_X[1] == MB * (cuda_wave.LEAD + 1)
    for bi, bj in ((0, 1), (5, 3), (117, 67)):
        w = bi + cuda_wave.SKEW * bj
        assert (bi + cuda_wave.LEAD) + cuda_wave.SKEW * (bj - 1) == w - 1


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_wait_rule_keeps_raster_order(size):
    wb, hb = size[0] // MB, size[1] // MB
    assert order_faults(wb, hb, cuda_wave.LEAD) == []


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_lead_of_one_breaks_raster_order(size):
    """The check catches a wrong constant: with a lead of 1 the MB at
    (bi + 2, bj - 1), raster-earlier and inside the window, may not be
    done yet, and (bi - 2, bj + 1), raster-later, may have started."""
    wb, hb = size[0] // MB, size[1] // MB
    faults = set(order_faults(wb, hb, 1))
    assert ((0, 1), (2, 0), "maybe not done") in faults
    assert ((2, 0), (0, 1), "maybe started") in faults


def kernel_reach():
    """wave.cu's window reach in MBs: (LEFT, RIGHT, UP, DOWN)."""
    m = re.search(r"constexpr int LEFT = (\d+), RIGHT = (\d+), "
                  r"UP = (\d+), DOWN = (\d+);", WAVE_CU.read_text())
    assert m, "wave.cu no longer states its window reach"
    return tuple(int(v) for v in m.groups())


def test_kernel_window_is_the_modules():
    left, right, up, down = cuda_wave.window_reach()
    assert kernel_reach() == (left, right, up, down)
    assert right == cuda_wave.LEAD
    assert (-left * MB, (right + 1) * MB) == cuda_wave.WIN_X
    assert (-up * MB, (down + 1) * MB) == cuda_wave.WIN_Y


def strip_schedule(wb, hb, lead, left, right, slots):
    """The kernel's events and their waits, as wave.cu's loader and
    compute warps run them: ("L", bj, c) loads strip c of row bj (strips
    -left .. wb + right - 1, in order; its slot is free once MB
    c - slots + left is done; it needs row bj-1 through
    min(max(c - right, 0) + lead, wb-1)); ("S", bj, bi) starts MB bi (after
    MB bi-1 and strip bi + right); ("D", bj, bi) completes it.

    Returns, per event, the last MB column completed ("D") and the last
    strip loaded ("L") in each row whenever it has happened, or None when
    the waits form a cycle (the kernel would deadlock)."""
    preds = {}
    for bj in range(hb):
        for c in range(-left, wb + right):
            p = [("L", bj, c - 1)] if c > -left else []
            if c - slots + left >= 0:
                p.append(("D", bj, c - slots + left))
            if bj > 0 and c >= 0:
                p.append(("D", bj - 1, min(max(c - right, 0) + lead, wb - 1)))
            preds[("L", bj, c)] = p
        for bi in range(wb):
            p = [("L", bj, bi + right)]
            if bi > 0:
                p.append(("D", bj, bi - 1))
            preds[("S", bj, bi)] = p
            preds[("D", bj, bi)] = [("S", bj, bi)]
    succs = {e: [] for e in preds}
    indeg = {e: len(p) for e, p in preds.items()}
    for e, p in preds.items():
        for q in p:
            succs[q].append(e)
    ready = deque(e for e, n in indeg.items() if n == 0)
    state = {}
    while ready:
        e = ready.popleft()
        done, loaded = np.full(hb, -1), np.full(hb, -left - 1)
        for q in preds[e]:
            np.maximum(done, state[q][0], out=done)
            np.maximum(loaded, state[q][1], out=loaded)
        kind, bj, x = e
        if kind == "D":
            done[bj] = max(done[bj], x)
        elif kind == "L":
            loaded[bj] = max(loaded[bj], x)
        state[e] = (done, loaded)
        for s in succs[e]:
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    return state if len(state) == len(preds) else None


def strip_faults(wb, hb, lead, left, right, slots):
    """What the strip schedule gets wrong against the window geometry
    (cuda_wave.WIN_X / WIN_Y): a strip loaded before a row above finished
    its column or after the row below may have started it, a reader that
    may start before its strip is in, a slot reloaded while a reader of its
    old strip may still run."""
    state = strip_schedule(wb, hb, lead, left, right, slots)
    if state is None:
        return ["deadlock"]
    up = -cuda_wave.WIN_Y[0] // MB
    # the MBs whose window covers strip c, inside the frame or not
    readers = {c: [bi for bi in range(wb)
                   if (bi * MB + cuda_wave.WIN_X[0]) // MB <= c
                   <= (bi * MB + cuda_wave.WIN_X[1] - 1) // MB]
               for c in range(-left, wb + right)}
    faults = []
    for bj in range(hb):
        for c in range(-left, wb + right):
            done, loaded = state[("L", bj, c)]
            if 0 <= c < wb:
                for r in range(max(0, bj - up), bj):
                    if done[r] < c:
                        faults.append((bj, c, f"row {r} not done"))
                if bj + 1 < hb and \
                        state[("S", bj + 1, c)][1][bj] < c:
                    faults.append((bj, c, "row below may have started"))
            if not readers[c]:
                continue
            if state[("S", bj, readers[c][0])][1][bj] < c:
                faults.append((bj, c, "first reader may start before it"))
            reuse = ("L", bj, c + slots)
            if reuse in state and state[reuse][0][bj] < readers[c][-1]:
                faults.append((bj, c, "slot reloaded under a reader"))
    return faults


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_strip_loads_keep_raster_order(size):
    left, right, _, _ = kernel_reach()
    slots = left + 1 + right + 1      # wave.cu SLOTS
    assert strip_faults(size[0] // MB, size[1] // MB, cuda_wave.LEAD, left,
                        right, slots) == []


def test_strip_model_catches_wrong_constants():
    """A lead of 1 loads strips before the row above finished them, a
    loader that takes the window's left reach for one MB frees each slot
    one MB early and reloads it under a reader, and a slot fewer than the
    window's span deadlocks."""
    wb, hb = 11, 6
    left, right, _, _ = kernel_reach()
    span = left + 1 + right
    assert any(f[2].startswith("row ") and "not done" in f[2]
               for f in strip_faults(wb, hb, 1, left, right, span + 1))
    assert any(f[2] == "slot reloaded under a reader"
               for f in strip_faults(wb, hb, cuda_wave.LEAD, left - 1, right,
                                     span + 1))
    assert strip_faults(wb, hb, cuda_wave.LEAD, left, right, span - 1) == \
        ["deadlock"]
