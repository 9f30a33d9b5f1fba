"""BENCHMARK.json against the contract's schema, and every name in it found
as a file of the benchmark."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]


def test_top_level_keys_and_limits():
    assert list(BENCH) == TOP_KEYS
    assert 1 <= len(BENCH["paths"]) <= 16 and BENCH["paths"] == ["portbench"]
    assert len(BENCH["command"]) <= 32 and all(1 <= len(w) <= 200 for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits its time: 2 + 14 x 24 runs, compiles, spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + metrics]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"]) and NAME.match(w["config"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_metrics_and_files(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    assert w["chips"] == 1
    conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert conf["file"].startswith("portbench/") and (ROOT / conf["file"]).is_file()
    assert json.loads((ROOT / conf["file"]).read_text())["reduced"] == conf["reduced"] == []
    mix = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    assert (ROOT / "portbench" / "drivers" / f"{mix['driver']}.py").is_file()
    assert (ROOT / "portbench" / "limits" / f"{cell}.json").is_file()
    e2e = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"] if cell in m.get("workloads", [cell])]
    assert layer
    for m in layer:  # each per-layer metric's end-to-end metric is reported in its cells
        assert m["moves"] in e2e
        assert (ROOT / "portbench" / "metrics" / f"{m['name'].split('.')[0]}.py").is_file()


def test_every_config_is_used_and_one_layer_name_per_layer():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    by_base = {}
    for m in BENCH["per_layer"]:
        by_base.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(layers) == 1 for layers in by_base.values())
