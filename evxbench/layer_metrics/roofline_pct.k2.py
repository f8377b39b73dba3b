"""K2 dense_select's share of its roofline (evxbench/roofline/k2.py)."""

from harness import roofline


def read(run):
    return roofline.share(run, "k2")
