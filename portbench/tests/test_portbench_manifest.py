"""BENCHMARK.json against the rules of its format (keys, names, units, sizes,
bounds), and the files each of its names is found by."""

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(BENCH) == KEYS
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield entry["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_name_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
        assert (REPO / "portbench/metrics" / f"{metric['name']}.py").exists()
        for w in metric.get("workloads", []):
            assert w in {c["name"] for c in BENCH["workloads"]}


def test_unique_names_and_setup_metric():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert "setup_s" in metrics


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    assert (REPO / "portbench/traffic" / f"{cell['traffic']}.json").exists()
    assert (REPO / "portbench/limits" / f"{cell['name']}.json").exists()
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert 1 <= len(config["source"]) <= 200
    data = json.loads((REPO / config["file"]).read_text())
    assert config["file"].startswith("portbench/")
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"] == []
    assert "assumed" in data and "deployment" in data
    assert (REPO / "portbench" / data["input"]).exists()
    # pmarlo's settings/defaults.yaml (md, remd)
    assert data["remd"] == {"n_replicas": 32, "t_min": 300.0, "t_max": 450.0,
                            "exchange_frequency": 100}
    assert data["md"]["timestep_ps"] == 0.002 and data["md"]["friction_per_ps"] == 1.0
    assert data["md"]["steps_per_segment"] == 10000 and data["md"]["report_interval"] == 100
    assert data["hydrogen_mass_amu"] == 3.0
    # pmarlo's gbn2, or the obc2 it documents, which the source then names
    assert data["gb_model"] == "gbn2" or (data["gb_model"] == "obc2" and "obc2" in data["source"])
    assert data["precision"] == "float32"


def test_every_config_used_and_per_layer_cover():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        reported = [m for m in BENCH["per_layer"]
                    if "workloads" not in m or w["name"] in m["workloads"]]
        assert reported, w["name"]
