"""The wall ms from the end of each frame's finish (entropy coding, on the
worker) to the yield of its chunk by `pipelined_encode` (the program's
`encode.yield_lag` span), the mean over the lags that began in the window
before the traced stretch."""

from harness import spanlog, stats


def read(run):
    spans = spanlog.spans(run, "encode.yield_lag", when=run.untraced)
    return 1e3 * stats.mean(s.end - s.start for s in spans) if spans \
        else None
