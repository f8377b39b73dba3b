"""The wall ms that `pipelined_encode` holds each frame undispatched
while it waits for the next one (the program's `encode.hold` span: its
`next()` on the frame source), the mean over the holds that began in the
window before the traced stretch."""

from harness import spanlog, stats


def read(run):
    spans = spanlog.spans(run, "encode.hold", when=run.untraced)
    return 1e3 * stats.mean(s.end - s.start for s in spans) if spans \
        else None
