"""Runs one cell of the evx1 encode benchmark once and prints its result.

    python3 evxbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (BENCHMARK.json names the cells). The last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics), `device`, with --trace 1 `breakdown`, and last
`checks`, each number that decided `correct` beside its limit; the same
numbers end standard error. Exits 1 without a result where no CUDA card
is found, and where the port's package or its sources are missing.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    sys.path[:0] = [str(BENCH_DIR), str(ROOT / "src")]
    import torch

    from harness import cell

    spec = cell.load_cell(args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"evxbench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "cairo_tpu_torch").is_dir():
        print("evxbench: the port's package (src/cairo_tpu_torch) is "
              "missing from the checkout", file=sys.stderr)
        return 1

    def log(msg):
        print(f"evxbench: {msg}", file=sys.stderr, flush=True)

    result = cell.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start=T_START, log=log)
    log(f"card: {result['device'].get('card')}")
    for line in cell.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
