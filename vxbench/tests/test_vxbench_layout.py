"""BENCHMARK.json against the files it names, and the contract's limits on
names, units and sizes."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from vxbench import harness

ROOT = Path(__file__).resolve().parents[2]
HOME = ROOT / "vxbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _metrics():
    return [(kind, m) for kind in ("end_to_end", "per_layer") for m in BENCH[kind]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vxbench"]
    assert BENCH["command"][1] == "vxbench/run.py" and (ROOT / BENCH["command"][1]).is_file()
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_of_24_cells_fits():
    """2 + 14 x cells runs of run_seconds + 60 s, 2 x 90 s a cell to compile
    and 1200 s spare, within 43200 s."""
    cells = 24
    assert (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_names_files_that_exist(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] == 1
    workload = json.loads((HOME / "workloads" / f"{cell}.json").read_text())
    assert workload["config"] == entry["config"] and workload["chips"] == entry["chips"]
    config = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert (ROOT / config["file"]).is_file()
    reported = {m["name"] for m in harness.cell_metrics(BENCH, cell, False)}
    assert "setup_s" in reported and len(reported) >= 2
    per_layer = harness.cell_metrics(BENCH, cell, True)
    assert per_layer and all(m["moves"] in reported for m in per_layer)
    assert set(workload["check"]["limits"]) == {"fb_off_share", "fb_mean_gap", "image_gap"}


@pytest.mark.parametrize("kind,metric", _metrics(), ids=[m["name"] for _, m in _metrics()])
def test_every_metric_has_its_reader(kind, metric):
    module = harness.reader(HOME, metric["name"])
    assert module.UNIT == metric["unit"] and module.SOURCE == metric["source"]
    assert metric["source"] in SOURCES and metric["better"] in ("lower", "higher")
    if kind == "per_layer":
        assert module.LAYER == metric["layer"] and module.MOVES == metric["moves"]
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}


def test_names_and_units_use_the_allowed_characters():
    names = [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [m["name"] for _, m in _metrics()] + [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for _, m in _metrics())
    texts = [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
    texts += [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    for group in ([w["name"] for w in BENCH["workloads"]], [c["name"] for c in BENCH["configs"]],
                  [m["name"] for _, m in _metrics()]):
        assert len(group) == len(set(group))


def test_roofline_names_and_ranges():
    for _, m in _metrics():
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
