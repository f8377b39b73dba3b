"""The session driver's own lateness: the 95th percentile of how long
after its due time each frame due in the window before the traced
stretch was handed to its encoder (a session's encode_many asks for its
next frame only when its main thread is free, so this is the backlog
the encoder leaves, plus the driver's wake-up)."""

from harness import stats


def read(run):
    late = [h - d for s in run.sessions for d, h in zip(s.due, s.handed)
            if run.untraced(d)]
    return 1e3 * stats.percentile(late, 95) if late else None
