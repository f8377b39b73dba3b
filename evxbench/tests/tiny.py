"""Small cells for the CPU tests: the benchmark's own configurations and
mixes at a few macroblocks, written into a temporary directory beside a
spec in BENCHMARK.json's form, and a run of one on the CPU."""

from __future__ import annotations

import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(BENCH_DIR), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

CONFIGS = {"conformance": "evx1_conformance_1080p_q16",
           "fast": "evx1_fast_1080p_q16"}


def write_spec(tmp: Path, width=64, height=48, sessions=2, rate=None,
               ring_frames=10) -> Path:
    """A spec with one closed-loop cell per path ("conformance.closed",
    "fast.closed") and an open-loop one ("conformance.open"), all at
    width x height; returns the spec's path (mixes in the same folder)."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs = []
    for path, name in CONFIGS.items():
        cfg = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
        cfg.update(width=width, height=height)
        (tmp / f"{path}.json").write_text(json.dumps(cfg))
        configs.append(dict(name=path, file=str(tmp / f"{path}.json")))
    for mix, src, extra in (("closed", "closed4", {}),
                            ("open", "live30", dict(frames_per_s=rate or 4))):
        m = json.loads((BENCH_DIR / "traffic" / f"{src}.json").read_text())
        m.update(sessions=sessions,
                 ring_bytes=width * height * 3 * ring_frames, **extra)
        (tmp / f"{mix}.json").write_text(json.dumps(m))
    cells = [dict(name="conformance.closed", config="conformance",
                  traffic="closed", chips=1),
             dict(name="fast.closed", config="fast", traffic="closed",
                  chips=1),
             dict(name="conformance.open", config="conformance",
                  traffic="open", chips=1)]
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    spec.update(configs=configs, workloads=cells)
    (tmp / "spec.json").write_text(json.dumps(spec))
    return tmp / "spec.json"


def run(tmp: Path, cell: str, seed=2**31 + 7, seconds=2.0, **kw) -> dict:
    from harness import cell as cell_mod

    spec = write_spec(tmp, **kw)
    return cell_mod.run_cell(cell, seed, seconds, False, device="cpu",
                             spec_path=spec, traffic_dir=tmp,
                             log=lambda msg: None)
