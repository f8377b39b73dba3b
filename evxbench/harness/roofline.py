"""A kernel's share of its roofline: the least time the card could take
for one launch (its bytes over the memory rate or its integer operations
over the integer rate, whichever is larger) over the launch's mean device
time in the traced window. The counts come from evxbench/roofline/<kernel>.py,
found by name."""

from __future__ import annotations

import importlib.util
from pathlib import Path

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s
HBM_BYTES_PER_S = 3.35e12
# one simple integer operation per CUDA-core lane per clock, all 128 lanes
# of each of the 132 SMs at 1.98 GHz: an upper peak, so a share against it
# is never too high
INT_OPS_PER_S = 33.5e12

ROOFLINE_DIR = Path(__file__).resolve().parents[1] / "roofline"


def load(kernel: str):
    path = ROOFLINE_DIR / f"{kernel}.py"
    spec = importlib.util.spec_from_file_location(f"roofline_{kernel}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bound_ms(kernel: str, width: int, height: int) -> float:
    nbytes, ops = load(kernel).work(width, height)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S)


def share(run, kernel: str):
    """Percent of the roofline, or None where the trace holds no launch."""
    if run.trace is None:
        return None
    timed = run.trace.kernel_ms(load(kernel).KERNEL)
    if timed is None:
        return None
    return 100.0 * bound_ms(kernel, run.width, run.height) / timed[1]
