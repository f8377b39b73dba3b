"""The arithmetic of the metrics, on plain lists of times (seconds on the
host's clock unless named otherwise), kept apart from any device so the
tests can drive it with synthetic timelines."""

from __future__ import annotations

import math


def rate(done_times, start: float, seconds: float) -> float:
    """Completions per second: those that fall inside [start, start +
    seconds], over the window's length."""
    end = start + seconds
    return sum(1 for t in done_times if start <= t <= end) / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile by nearest rank: the smallest value with at least
    q percent of the values at or below it."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no values")
    rank = max(1, math.ceil(q / 100 * len(ordered)))
    return ordered[rank - 1]


def latencies(due, done, start: float, seconds: float):
    """Due-to-done seconds of every item due inside the window, in the order
    given. `done[i]` is None for an item that never completed: it has no
    latency, and `missing` counts it."""
    end = start + seconds
    out, missing = [], 0
    for d, f in zip(due, done):
        if not start <= d <= end:
            continue
        if f is None:
            missing += 1
        else:
            out.append(f - d)
    return out, missing


def union_length(intervals, lo: float, hi: float) -> float:
    """The length of [lo, hi] that the union of the (start, end) intervals
    covers."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """The (start, end) stretches of [lo, hi] that no interval covers,
    longest first."""
    gaps, cursor = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        gaps.append((cursor, hi))
    return sorted(gaps, key=lambda g: g[0] - g[1])


def idle_share(intervals, lo: float, hi: float) -> float:
    """Percent of [lo, hi] with no interval running."""
    return 100.0 * (1.0 - union_length(intervals, lo, hi) / (hi - lo))


def mean(values) -> float:
    values = list(values)
    if not values:
        raise ValueError("no values")
    return sum(values) / len(values)
