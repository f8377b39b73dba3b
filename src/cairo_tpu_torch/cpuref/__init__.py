"""Copy of cairo_tpu.cpuref: the numpy reference engine (Evx1Encoder/Evx1Decoder in api.py), colour conversion and the stream header (host code)."""
