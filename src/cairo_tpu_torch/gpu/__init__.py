"""The device pipeline on PyTorch (counterpart of cairo_tpu.tpu)."""
