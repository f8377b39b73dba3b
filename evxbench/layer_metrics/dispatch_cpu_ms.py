"""The thread-CPU ms of each encoder dispatch (the program's
`encode.dispatch` span: all of gpu/api.py `_dispatch`, on the session's
main thread), the mean over the dispatches that began in the window
before the traced stretch; `dispatch_ms` is the same calls' wall ms, from
the harness's wrapper."""

from harness import spanlog, stats


def read(run):
    spans = spanlog.spans(run, "encode.dispatch", when=run.untraced)
    return 1e3 * stats.mean(s.cpu for s in spans) if spans else None
