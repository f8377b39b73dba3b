"""The frozen K2 and K6 counts against the port's kernel table, and their
scaling with the frame."""

import pytest

import tiny  # noqa: F401  (puts the harness and the port on the path)
from harness import roofline


def test_1080p_bounds_match_the_kernel_table():
    # the kernel table's bounds: K2 0.0679 ms by operations, K6 0.0152 ms
    # by bytes, at 1920x1088
    b2, o2 = roofline.load("k2").work(1920, 1080)
    b6, o6 = roofline.load("k6").work(1920, 1080)
    assert o2 / roofline.INT_OPS_PER_S * 1e3 == pytest.approx(0.0679,
                                                              abs=5e-5)
    assert o2 / roofline.INT_OPS_PER_S > b2 / roofline.HBM_BYTES_PER_S
    assert b6 / roofline.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.0152,
                                                                abs=5e-5)
    assert b6 / roofline.HBM_BYTES_PER_S > o6 / roofline.INT_OPS_PER_S
    assert roofline.bound_ms("k2", 1920, 1080) == pytest.approx(0.0679,
                                                                abs=5e-5)
    assert roofline.bound_ms("k6", 1920, 1080) == pytest.approx(0.0152,
                                                                abs=5e-5)


@pytest.mark.parametrize("kernel", ["k2", "k6"])
def test_2160p_scales_with_the_macroblocks(kernel):
    # 3840x2160 has 32,400 macroblocks, 1920x1088 8,160
    small = roofline.load(kernel).work(1920, 1080)
    big = roofline.load(kernel).work(3840, 2160)
    assert big[1] / small[1] == pytest.approx(32400 / 8160)
    assert big[0] / small[0] == pytest.approx(32400 / 8160, rel=0.01)


class _Trace:
    def __init__(self, ms):
        self.ms = ms

    def kernel_ms(self, name):
        return None if self.ms is None else (3, self.ms)


class _Run:
    width, height = 1920, 1080

    def __init__(self, ms):
        self.trace = _Trace(ms)


def test_share_and_silence():
    assert roofline.share(_Run(2.56), "k6") == pytest.approx(
        100 * 0.015170 / 2.56, rel=1e-3)
    assert roofline.share(_Run(None), "k6") is None
