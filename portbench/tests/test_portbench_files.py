"""BENCHMARK.json against the contract's shape, and every name in it
resolving to its file under portbench/."""
import json
import os
import re

import pytest

from portbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["command"] == ["python3", "portbench/run.py"]
    assert s["paths"] == ["portbench"]
    assert isinstance(s["run_seconds"], int) and 1 <= s["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    runs = 2 + 14 * 24
    assert runs * (s["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_entries_have_the_contract_keys():
    s = spec()
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_units_and_text():
    s = spec()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in s[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in s["configs"] + s["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    for m in s["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for c in s["configs"]:
        assert len(c["reduced"]) <= 16
        assert c["source"].startswith("https://")


@pytest.mark.parametrize("kind", ["config", "traffic", "driver", "limits"])
def test_every_cell_resolves(bench, kind):
    for name, cell in bench.cells.items():
        if kind == "config":
            cfg = bench.config(cell)
            assert cfg["name"] == cell["config"]
            entry = bench.configs[cell["config"]]
            assert entry["file"].startswith("portbench/")
            assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
        elif kind == "traffic":
            assert bench.traffic(cell)["mix"]
        elif kind == "driver":
            drv = harness.driver(bench.traffic(cell)["driver"])
            for fn in ("setup", "window", "trace", "judge"):
                assert callable(getattr(drv, fn))
        else:
            assert bench.limits(cell)


def test_every_metric_has_a_reader(bench):
    s = spec()
    for m in s["end_to_end"] + s["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_every_cell_reports_what_the_contract_asks(bench):
    s = spec()
    e2e_names = {m["name"] for m in s["end_to_end"]}
    for name, cell in bench.cells.items():
        e2e = {m["name"] for m in bench.metrics(cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = bench.metrics(cell, "per_layer")
        assert per_layer
        for m in per_layer:
            assert m["moves"] in e2e_names
            assert m["moves"] in e2e, (name, m["name"])


def test_configs_are_used_and_files_unique():
    s = spec()
    used = {w["config"] for w in s["workloads"]}
    assert used == {c["name"] for c in s["configs"]}
    files = [c["file"] for c in s["configs"]]
    assert len(files) == len(set(files))
    pairs = [(w["config"], w["traffic"]) for w in s["workloads"]]
    assert len(pairs) == len(set(pairs))

