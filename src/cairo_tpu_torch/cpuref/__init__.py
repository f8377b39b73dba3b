"""Host-side (numpy) pieces of cairo_tpu.cpuref that the port needs: colour conversion and the stream header."""
