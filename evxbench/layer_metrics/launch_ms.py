"""The wall ms of each frame's engine step on the host (the program's
`dispatch.step` span inside `_dispatch`: the step's Python and the issue
of its launches), the mean over the steps that began in the window before
the traced stretch."""

from harness import spanlog, stats


def read(run):
    spans = spanlog.spans(run, "dispatch.step", when=run.untraced)
    return 1e3 * stats.mean(s.end - s.start for s in spans) if spans \
        else None
