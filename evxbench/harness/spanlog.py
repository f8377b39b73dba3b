"""The program's span logs, as the per-layer readers take them: each
session's encoder keeps one (`enc.spans`, cairo_tpu_torch/spans.py: spans
with start and end on time.perf_counter(), the harness's clock, and the
thread's CPU seconds; counters beside them). A program without span logs
gives the readers nothing to read: `logs` returns None, and so does each
reader then."""

from __future__ import annotations


def logs(run):
    """Each session's span log, or None where an encoder keeps none."""
    found = [getattr(s.enc, "spans", None) for s in run.sessions]
    if not found or any(log is None for log in found):
        return None
    return found


def spans(run, *names, when=None):
    """Every session's spans of those names that started where `when`
    holds (all, if None); None without span logs."""
    found = logs(run)
    if found is None:
        return None
    return [s for log in found for s in log.spans(*names)
            if when is None or when(s.start)]


def merged(intervals):
    """The union of (start, end) intervals as disjoint ones, in order."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a, b) -> float:
    """The length that two lists of disjoint intervals, each in order,
    have in common."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
