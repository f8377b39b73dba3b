"""Copy of cairo_tpu.metrics: per-frame structured encoder stats."""

from __future__ import annotations

import numpy as np

from .blocktypes import COPY_BIT, INTRA_BIT, MOTION_BIT

BLOCK_TYPE_NAMES = {
    0: "INTER_DELTA",
    1: "INTRA_DEFAULT",
    2: "INTER_MOTION_DELTA",
    3: "INTRA_MOTION_DELTA",
    4: "INTER_COPY",
    6: "INTER_MOTION_COPY",
    7: "INTRA_MOTION_COPY",
}


def frame_stats(frame_index: int, frame_type: int, quality: int,
                n_bytes: int, block_type: np.ndarray, q_index: np.ndarray,
                stage_ms: dict | None = None) -> dict:
    """Structured stats for one encoded frame."""
    bt = np.asarray(block_type).astype(np.int32)
    qp = np.asarray(q_index).astype(np.int32)
    hist = {name: int(np.count_nonzero(bt == t))
            for t, name in BLOCK_TYPE_NAMES.items()}
    copy = (bt & COPY_BIT) != 0
    non_copy = ~copy
    stats = {
        "frame_index": int(frame_index),
        "frame_type": "I" if frame_type == 0 else "P",
        "quality": int(quality),
        "bytes": int(n_bytes),
        "bits_per_mb": round(8.0 * n_bytes / max(1, bt.size), 2),
        "blocks": int(bt.size),
        "block_types": hist,
        "copy_ratio": round(float(np.mean(copy)), 4),
        "intra_ratio": round(float(np.mean((bt & INTRA_BIT) != 0)), 4),
        "motion_ratio": round(float(np.mean((bt & MOTION_BIT) != 0)), 4),
        "mean_qp": round(float(qp[non_copy].mean()), 2) if non_copy.any() else 0.0,
        "max_qp": int(qp[non_copy].max()) if non_copy.any() else 0,
    }
    if stage_ms:
        stats["stage_ms"] = {k: round(v, 3) for k, v in stage_ms.items()}
    return stats


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    """PSNR in dB between two uint8/int images of identical shape."""
    mse = float(np.mean(
        (np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse <= 0.0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)
