"""Seconds from the process's start to the window's: imports, the CUDA
context, the frame ring, the encoders, the kernels' build (or its cache)
and each session's warm-up frames."""


def read(run):
    return run.setup_s
