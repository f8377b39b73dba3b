"""The port's build cache (gpu/_build.py), on the CPU with a stand-in
compiler: a library is built once per digest, its compiler log lands
beside it and is read back on a cache hit (chip_smoke.py reads ptxas'
registers, shared memory and spills from it), and a build that fails leaves nothing."""

import importlib.util
import pathlib

import pytest

from cairo_tpu_torch.gpu import _build

ROOT = pathlib.Path(__file__).resolve().parents[1]

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119dense_select_kernelEPKiPKsS1_iiiiPiS4_S4_S4_Pb' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119dense_select_kernelEPKiPKsS1_iiiiPiS4_S4_S4_Pb
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 63 registers, 412 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111wave_kernelEPKiS1_S1_S1_S1_S1_S1_S1_PiS2_S2_PsS3_S3_S1_S1_iiiS2_S2_S3_S3_S3_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111wave_kernelEPKiS1_S1_S1_S1_S1_S1_S1_PiS2_S2_PsS3_S3_S1_S1_iiiS2_S2_S3_S3_S3_
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 142 registers, 520 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114deblock_kernelENS_5PlaneES0_S0_NS_4MapsEii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114deblock_kernelENS_5PlaneES0_S0_NS_4MapsEii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers, 21376 bytes smem, 440 bytes cmem[0]
"""


@pytest.fixture
def source(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    return src


def test_log_is_read_back_from_a_cached_build(source):
    builds = []

    def fake_build(out):
        builds.append(out)
        out.write_bytes(b"\x7fELF")
        return PTXAS_LOG

    first = _build._ensure("k", [source], ["nvcc", "-v"], fake_build)
    again = _build._ensure("k", [source], ["nvcc", "-v"], fake_build)
    assert first == again and len(builds) == 1
    assert _build.build_log(again) == PTXAS_LOG
    assert sorted(p.name for p in first.parent.iterdir()) == ["libk.log",
                                                              "libk.so"]
    # another source is another digest, built anew
    source.write_text("// another kernel\n")
    other = _build._ensure("k", [source], ["nvcc", "-v"], fake_build)
    assert other.parent != first.parent and len(builds) == 2


def test_failed_build_leaves_nothing(source):
    def broken(out):
        raise RuntimeError("build failed")

    with pytest.raises(RuntimeError):
        _build._ensure("k", [source], ["nvcc"], broken)
    digest_dir = _build.BUILD_ROOT / _build._digest([source], ["nvcc"])
    assert list(digest_dir.iterdir()) == []


def test_kernel_builds_report_registers():
    flags = _build.NVCC_FLAGS
    assert flags[flags.index("-Xptxas") + 1] == "-v"


def test_chip_smoke_reads_registers_and_spills_from_the_log():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    usage = smoke.ptxas_usage(PTXAS_LOG)
    assert usage["dense_select_kernel"] == (
        "63 registers, 0 bytes stack frame, 0 bytes spill stores, 0 bytes "
        "spill loads")
    assert usage["wave_kernel"].startswith("142 registers, 8 bytes stack")


def test_chip_smoke_reads_shared_memory_from_the_log():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.ptxas_usage(PTXAS_LOG)["deblock_kernel"] == (
        "56 registers, 21376 bytes smem, 0 bytes stack frame, 0 bytes spill "
        "stores, 0 bytes spill loads")
