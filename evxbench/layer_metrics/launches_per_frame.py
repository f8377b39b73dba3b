"""Every kernel launch on the device in the traced stretch (the port's
hand kernels and ATen's alike), over the chunks that came out in it."""


def read(run):
    if run.trace is None:
        return None
    frames = sum(1 for s in run.sessions for t in s.done
                 if run.trace.t0 <= t <= run.trace.t1)
    launches = run.trace.launches()
    return launches / frames if frames and launches else None
