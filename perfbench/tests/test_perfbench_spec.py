"""BENCHMARK.json against the contract's shape, and every name it holds
finding its file."""

from __future__ import annotations

import json
import re

import pytest

from perfbench import spec as S

BENCH = S.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
LAYER_METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_name_and_unit_keeps_to_the_alphabet():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200


def test_end_to_end_bounds_and_setup():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files_and_reports_what_it_must(cell):
    spec = S.load_cell(cell)
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"], cell
    for m in spec["per_layer"]:
        assert m["moves"] in names, (cell, m["name"])
    assert set(spec["limits"]) == {"bad_answers", "rank_gap_mean", "score_rms"}
    assert spec["limits"]["bad_answers"] == 0


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_published_shape(config):
    cfg = json.loads((S.ROOT / config["file"]).read_text())
    assert cfg["name"] == config["name"] and cfg["source"] == config["source"]
    assert config["reduced"] == []
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
    assert config["file"].startswith("perfbench/")


@pytest.mark.parametrize("metric", LAYER_METRICS)
def test_layer_reader_found_by_name_and_silent_without_input(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert m["layer"] and "\n" not in m["layer"]
    assert S.layer_reader(metric)({}) is None


def test_unknown_names_raise():
    with pytest.raises(S.SpecError):
        S.load_cell("no-such-cell")
    with pytest.raises(S.SpecError):
        S.layer_reader("no.such.metric")
