"""Of the traced stretch's device-idle time (where no operation of the
device trace runs, as `idle_pct` reads it), the percent during which at
least one session was inside its encoder's dispatch (the program's
`encode.dispatch` span, on the same host clock)."""

from harness import spanlog, stats


def read(run):
    if run.trace is None:
        return None
    spans = spanlog.spans(run, "encode.dispatch")
    if not spans:
        return None
    gaps = sorted(stats.idle_gaps(run.trace.intervals(), run.trace.t0,
                                  run.trace.t1))
    idle = sum(hi - lo for lo, hi in gaps)
    if idle <= 0:
        return None
    inside = spanlog.overlap(spanlog.merged((s.start, s.end) for s in spans),
                             gaps)
    return 100.0 * inside / idle
