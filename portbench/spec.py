"""What a cell is, read from BENCHMARK.json and the files it names.

A cell (an entry of `workloads`) names a configuration, whose file is the
configuration entry's `file`, and a traffic mix, portbench/traffic/<traffic>.json.
Its end-to-end metrics are those of `end_to_end` that list it under
`workloads` or list no workloads; its per-layer metrics likewise, each read
by portbench/metrics/<name>.py.  Nothing here is particular to one cell, so
a cell, a configuration, a mix or a metric is added as files and entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: str = os.path.join(ROOT, "BENCHMARK.json")) -> Cell:
    bench = load_json(benchmark)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in {benchmark}; have {sorted(entries)}")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(name: str):
    """The module portbench/metrics/<name>.py (its `read(ctx)`)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
