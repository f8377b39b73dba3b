"""Nothing that runs on the card loads JAX or the JAX package: the harness,
its reference and the port, compared by whole top-level module names
(the port's name begins with the JAX package's)."""

import subprocess
import sys

from tiny import BENCH_DIR, ROOT
from harness import cell

PROBE = """
import sys
sys.path[:0] = [{bench!r}, {src!r}]
import harness.cell, harness.check, harness.trace, harness.roofline
import reference.engine, reference.slicecodec
import cairo_tpu_torch
from cairo_tpu_torch.gpu import api, wavefront, engine
from cairo_tpu_torch import native
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_forbidden_names_are_whole_top_level_names():
    assert "cairo_tpu" in cell.FORBIDDEN and "jax" in cell.FORBIDDEN
    loaded = {"cairo_tpu_torch.gpu.api", "jax_like", "numpy"}
    assert not {m.split(".")[0] for m in loaded} & set(cell.FORBIDDEN)
    assert {m.split(".")[0] for m in {"cairo_tpu.tpu"}} & set(cell.FORBIDDEN)


def test_the_run_path_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(bench=str(BENCH_DIR),
                                            src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    names = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "cairo_tpu_torch" in names
    assert not names & set(cell.FORBIDDEN), names & set(cell.FORBIDDEN)


def test_sources_import_neither():
    for path in BENCH_DIR.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for word in ("import jax", "from jax", "import cairo_tpu\n",
                     "from cairo_tpu ", "from cairo_tpu.", "import flax"):
            assert word not in text, (path, word)
