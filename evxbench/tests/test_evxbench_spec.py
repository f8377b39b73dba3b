"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by the names it gives."""

import importlib.util
import json
import re

import pytest

from tiny import BENCH_DIR, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["evxbench"]
    assert SPEC["command"] == ["python3", "evxbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("evxbench/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] == "host_clock" and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(names)) == len(names)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for cell in CELLS:
        mine = [m for m in SPEC["end_to_end"]
                if cell in m.get("workloads", [cell])]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        layers = [m for m in SPEC["per_layer"] if cell in m["workloads"]]
        assert layers
        for m in layers:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    from harness import cell as cell_mod

    spec = cell_mod.load_cell(cell)
    cfg = spec["config"]
    assert {"path", "width", "height", "quality", "codec"} <= set(cfg)
    assert {"sessions", "warmup_frames", "ring_bytes", "content"} <= \
        set(spec["mix"])
    for m in spec["end_to_end"]:
        assert (BENCH_DIR / "end_to_end" / f"{m['name']}.py").is_file()
    for m in spec["per_layer"]:
        assert (BENCH_DIR / "layer_metrics" / f"{m['name']}.py").is_file()
        assert callable(cell_mod._reader("layer_metrics", m["name"]))


def test_configuration_files_state_the_program_defaults():
    """The configurations run the reference's config.h defaults, which the
    program's CodecConfig holds; the conformance encoder runs no other."""
    from cairo_tpu_torch.config import CONFORMANCE, CodecConfig

    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert CodecConfig(**cfg["codec"]) == CONFORMANCE
        assert cfg["source"] == c["source"]


@pytest.mark.parametrize("kernel", ["k2", "k6"])
def test_roofline_readers_name_existing_counts(kernel):
    path = BENCH_DIR / "roofline" / f"{kernel}.py"
    spec = importlib.util.spec_from_file_location(kernel, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.KERNEL.endswith("_kernel")
