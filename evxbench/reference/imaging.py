"""Copy of cairo_tpu.cpuref.imaging: RGB24 <-> YUV 4:2:0 int16 colour conversion."""

from __future__ import annotations

import numpy as np

from .xmath import trunc_div


def rgb_to_yuv420(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 -> Y (H, W), U, V (H/2, W/2) int16. H, W must be even."""
    height, width = rgb.shape[:2]
    assert height % 2 == 0 and width % 2 == 0
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)

    y = ((77 * r + 150 * g + 29 * b + 128) >> 8) + 16

    cu = trunc_div(-43 * r - 85 * g + 128 * b + 128, 256) + 128
    cv = trunc_div(128 * r - 107 * g - 21 * b + 128, 256) + 128
    # Sum each 2x2 quad, then (sum + 2) >> 2.
    u = (cu.reshape(height // 2, 2, width // 2, 2).sum(axis=(1, 3)) + 2) >> 2
    v = (cv.reshape(height // 2, 2, width // 2, 2).sum(axis=(1, 3)) + 2) >> 2
    return y.astype(np.int16), u.astype(np.int16), v.astype(np.int16)


def yuv420_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                  width: int, height: int) -> np.ndarray:
    """Y/U/V int16 planes -> (height, width, 3) uint8 (crops to width×height)."""
    yy = y[:height, :width].astype(np.int32) - 16
    uu = (u.astype(np.int32) - 128).repeat(2, axis=0).repeat(2, axis=1)[:height, :width]
    vv = (v.astype(np.int32) - 128).repeat(2, axis=0).repeat(2, axis=1)[:height, :width]
    r = (256 * yy + 358 * vv + 128) >> 8
    g = (256 * yy - 88 * uu - 182 * vv + 128) >> 8
    b = (256 * yy + 452 * uu + 128) >> 8
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)
