"""Every cell of ``BENCHMARK.json`` resolves to its files, and the file
keeps to the benchmark contract's shape."""
import json
import re

import pytest

from bench.harness.spec import BENCH, ROOT, load_cell, metric_reader

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    assert SPEC["paths"] == ["bench"] and SPEC["command"][1].startswith("bench/")
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_lines():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in SPEC[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("end_to_end", "per_layer"):
        assert len({m["name"] for m in SPEC[key]}) == len(SPEC[key])
        for m in SPEC[key]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in SPEC["configs"] + SPEC["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_bounds_and_setup():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = load_cell(name)
    assert (BENCH / "configs" / f"{cell.workload['config']}.json").exists()
    ref = cell.reference()
    assert callable(ref.recipe) and callable(ref.forward) and callable(ref.train_loss)
    assert callable(ref.model_flops)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported
        assert callable(metric_reader(m["name"]))
    assert cell.traffic["kind"] in ("train", "serve")


@pytest.mark.parametrize("name", CELLS)
def test_config_matches_the_program(name):
    from bench.harness.train import program_config

    cfg = program_config(load_cell(name))
    assert cfg.compute_dtype == "bfloat16"


def test_every_config_is_used_and_its_file_under_paths():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used and c["file"] == f"bench/configs/{c['name']}.json"
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]


def test_every_metric_file_is_named_in_the_benchmark():
    named = {m["name"] for m in SPEC["per_layer"]}
    assert {p.stem for p in (BENCH / "metrics").glob("*.py")} == named


def test_every_per_layer_metric_lists_its_cells():
    for m in SPEC["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS)


def test_a_per_layer_metric_without_cells_is_refused(tmp_path):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    del spec["per_layer"][0]["workloads"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "bench").symlink_to(BENCH)
    with pytest.raises(ValueError, match="lists no workloads"):
        load_cell(CELLS[0], tmp_path)
