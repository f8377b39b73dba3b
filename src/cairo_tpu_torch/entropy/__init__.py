"""Copy of cairo_tpu.entropy: the Python bit I/O, ABAC coder, slice codec and lossless backends (host code)."""
