"""BENCHMARK.json and the files the harness finds by name: every cell,
metric and configuration parses and keeps to the benchmark's contract."""

import json
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    SPEC = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["h100bench"]
    assert 1 <= len(SPEC["command"]) <= 32 and all(line(w) for w in SPEC["command"])
    assert [w for w in SPEC["command"] if "/" in w] == ["h100bench/run.py"]
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the driver's time
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys():
    groups = {"configs": {"name", "source", "file", "reduced", "why"},
              "workloads": {"name", "config", "traffic", "chips", "why"},
              "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
              "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                            "workloads"}}
    for group, keys in groups.items():
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
        for e in SPEC[group]:
            assert set(e) <= keys and set(e) >= keys - {"workloads"}, e
            assert NAME.match(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    metrics = [m["name"] for g in ("end_to_end", "per_layer") for m in SPEC[g]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_configs(entry):
    assert line(entry["source"]) and line(entry["why"])
    assert entry["file"].startswith("h100bench/configs/")
    cfg = load("configs", os.path.basename(entry["file"]))
    assert cfg["reduced"] == entry["reduced"] == [] and cfg["assumed"] == []
    assert cfg["dtype"] == "float32" and cfg["tf32"] is False
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])
    for y in cfg["yamls"]:
        assert os.path.exists(os.path.join(ROOT, y)), y
    g = cfg["hifigan"]["Model"]["Generator"]["params"]
    hop = 1
    for s in g["upsample_scales"]:
        hop *= s
    assert hop == cfg["audio_config"]["hop_length"]


@pytest.mark.parametrize("cell", CELLS)
def test_cells(cell):
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert w["chips"] == 1 and line(w["why"])
    assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    mix = load("traffic", f"{w['traffic']}.json")
    assert os.path.exists(os.path.join(BENCH, "paths", f"{mix['path']}.py"))
    assert load("workloads", f"{cell}.json")["limits"]
    e2e = [m["name"] for m in SPEC["end_to_end"] if reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reports(m, cell) for m in SPEC["per_layer"])
    pairs = [(x["config"], x["traffic"]) for x in SPEC["workloads"]]
    assert pairs.count((w["config"], w["traffic"])) == 1


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        for c in m.get("workloads", []):
            assert c in CELLS
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25 for m in SPEC["end_to_end"])


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer(metric):
    assert os.path.exists(os.path.join(BENCH, "layer_metrics", f"{metric['name']}.py"))
    assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                "host_clock")
    assert line(metric["layer"])
    moved = next(m for m in SPEC["end_to_end"] if m["name"] == metric["moves"])
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS and reports(moved, cell), (metric["name"], cell)
    layers = {m["layer"] for m in SPEC["per_layer"]}
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    assert all(layer in perf for layer in layers)
