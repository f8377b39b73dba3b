"""Chunks that all sessions' encoders yielded inside the window, over the
window's seconds."""

from harness import stats


def read(run):
    done = [t for s in run.sessions for t in s.done]
    return stats.rate(done, run.t0, run.seconds)
