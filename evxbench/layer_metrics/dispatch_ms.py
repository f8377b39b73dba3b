"""Main-thread wall ms of each call into an encoder's dispatch lane
(gpu/api.py `_dispatch`: the upload, the step's launches and the start of
the download), the mean over the calls that began in the window before
the traced stretch (the profiler slows the lanes), from the harness's
wrapper."""

from harness import stats


def read(run):
    spans = [b - a for s in run.sessions for a, b in s.dispatch
             if run.untraced(a)]
    return 1e3 * stats.mean(spans) if spans else None
