"""BENCHMARK.json, the configuration and traffic files it names, and the
metric readers, against the benchmark's contract."""
import json
import os
import re

import pytest

from portbench.spec import HERE, ROOT, load_cell, load_json, metric_reader
from portbench.traffic import Traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
        "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(bench):
    assert set(bench) == KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(text_ok(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    # a full check of 24 cells fits in 43200 s at this run length
    assert 2 + 14 * 24 <= (43200 - 1200 - 24 * 180) / (bench["run_seconds"] + 60)
    assert 1 <= cells <= 24


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert text_ok(c["source"]) and text_ok(c["why"])
        assert c["file"].startswith("portbench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and text_ok(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                         "moves"}
        assert text_ok(m["layer"])


def test_every_cell_loads_and_reports(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    configs = {c["name"] for c in bench["configs"]}
    used = set()
    pairs = set()
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        used.add(w["config"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert cell.config["name"] == w["config"]
        Traffic(cell.traffic, 2**31 + 5).point(0)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])
            assert callable(metric_reader(m["name"]).read)
    assert used == configs
    for m in bench["per_layer"]:
        assert m["moves"] in e2e


def test_configuration_files(bench):
    for c in bench["configs"]:
        cfg = load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"] and cfg["precision"] == "float32"
        assert cfg["step"]["channel"] == "threefry"


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, dirnames, files in os.walk(HERE):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert PATH.match(rel), rel


def test_traffic_files_name_known_keys():
    for f in os.listdir(os.path.join(HERE, "traffic")):
        params = json.load(open(os.path.join(HERE, "traffic", f)))
        t = Traffic(params, 1)
        assert t.batch >= 1 and t.snr_db == params["snr_db"]
