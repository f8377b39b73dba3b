"""The native entropy coder's ms a frame (native/ `encode_slice`, on the
encoder's finish lane): the mean of `last_stats["stage_ms"]["entropy"]`
over the chunks that came out in the window before the traced stretch."""

from harness import stats


def read(run):
    ms = [e for s in run.sessions for t, e in zip(s.done, s.entropy_ms)
          if run.untraced(t)]
    return stats.mean(ms) if ms else None
