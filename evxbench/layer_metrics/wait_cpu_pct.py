"""Percent of the host's waits on the device that its threads spend on
the CPU: thread-CPU seconds over wall seconds, summed over the program's
`upload.slot_wait` (an upload's wait for its staging slot) and
`finish.fetch` (the finish lane's wait for the frame's download) spans
that began in the window before the traced stretch. Near 100 the waits
spin; near 0 they block."""

from harness import spanlog


def read(run):
    spans = spanlog.spans(run, "upload.slot_wait", "finish.fetch",
                          when=run.untraced)
    if not spans:
        return None
    wall = sum(s.end - s.start for s in spans)
    return 100.0 * sum(s.cpu for s in spans) / wall if wall > 0 else None
