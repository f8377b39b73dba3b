"""The port stands alone: nothing under src/cairo_tpu_torch/, and neither
chip_smoke.py nor compare_trees.py, imports jax or cairo_tpu; it imports
every module and runs both encoders, the decoder, the reference engine,
analysis and the entropy backends with both blocked; no
CUDA source includes a PyTorch header and nothing builds with torch's
extension loader; chip_smoke.py fails fast without a card."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "cairo_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "cairo_tpu")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "compare_trees.py"]


def _imported_roots(path):
    roots = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.append(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_imports(path):
    bad = [r for r in _imported_roots(path) if r in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_sources_bind_without_torch_headers():
    for src in sorted((PKG / "gpu" / "csrc").glob("*.cu*")):
        text = src.read_text()
        for needle in ("torch/", "ATen", "c10/", "pybind11"):
            assert needle not in text, f"{src.name} includes {needle}"
    for path in _port_files():
        text = path.read_text()
        for needle in ("cpp_extension", "load_inline", "torch.compile"):
            assert needle not in text, f"{path.name} uses {needle}"


def test_imports_and_runs_with_jax_blocked(tmp_path):
    """A fresh interpreter with jax and cairo_tpu unimportable imports
    every port module (the conformance path's too) and encodes + decodes
    two frames with each encoder on the CPU, the conformance chunks and
    RGB equal to the port's Evx1Encoder's and Evx1Decoder's, and calls
    analysis and the entropy backends."""
    mods = sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = f"""
import sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None
sys.path.insert(0, {str(ROOT / 'src')!r})
import importlib
for m in {mods!r}:
    importlib.import_module(m)
import numpy as np
from cairo_tpu_torch import ConformanceGpuEncoder, GpuDecoder, GpuEncoder
from cairo_tpu_torch.synth import synth_frames
enc, dec = GpuEncoder(device="cpu"), GpuDecoder(device="cpu")
for f in synth_frames(48, 32, 2):
    rgb = dec.decode(enc.encode(f))
    assert np.array_equal(rgb, enc.peek_destination())
cenc, cdec = ConformanceGpuEncoder(device="cpu"), GpuDecoder(device="cpu")
from cairo_tpu_torch import Evx1Decoder, Evx1Encoder, analysis
from cairo_tpu_torch.entropy import backends
renc, rdec = Evx1Encoder(), Evx1Decoder()
for f in synth_frames(48, 32, 2):
    chunk = cenc.encode(f)
    assert chunk == renc.encode(f)
    assert np.array_equal(cdec.decode(chunk), rdec.decode(chunk))
blocks = np.arange(-512, 512, dtype=np.int16).reshape(4, 16, 16)
assert int(analysis.block_variance2(blocks, device="cpu")[0]) != 0
out = backends.BitWriter()
backends.golomb_encode_values([3, -7, 0], out)
assert list(backends.golomb_decode_values(
    backends.BitReader(out.getvalue(), out.bit_count), 3)) == [3, -7, 0]
assert "jax" not in [m.split(".")[0] for m in sys.modules
                     if sys.modules[m] is not None]
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def _run_smoke(script, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=120, cwd=cwd, env=env)


def test_chip_smoke_fails_fast_without_a_card():
    proc = _run_smoke(ROOT / "chip_smoke.py", ROOT)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path / "chip_smoke.py", tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
