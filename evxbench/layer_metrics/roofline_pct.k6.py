"""K6 wave_pass's share of its roofline (evxbench/roofline/k6.py)."""

from harness import roofline


def read(run):
    return roofline.share(run, "k6")
