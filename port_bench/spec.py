"""Finds what a run needs by name: the cell in `BENCHMARK.json`, its
configuration's file, its traffic mix (`traffic/<name>.json`), its limits
(`limits/<cell>.json`) and each per-layer metric's reader
(`metrics/<metric>.py`, a `read(run)` function). A name with no entry or
no file is an error, never a default.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_json(path: str) -> Dict:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no such file: {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def _named(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict  # the configuration file's contents
    traffic_name: str
    traffic: Dict  # the mix's parameters
    limits: Dict  # number compared -> its limit
    end_to_end: List[Dict]  # the end-to-end metrics this cell reports
    per_layer: List[Dict]  # the per-layer metrics this cell reports


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: str = os.path.join(ROOT, "BENCHMARK.json")) -> Cell:
    bench = _load_json(bench_path)
    w = _named(bench["workloads"], name, "workload")
    c = _named(bench["configs"], w["config"], "config")
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_load_json(os.path.join(ROOT, c["file"])),
        traffic_name=w["traffic"],
        traffic=_load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
        limits=_load_json(os.path.join(HERE, "limits", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def reader(metric: str) -> Callable:
    """The `read` function of `metrics/<metric>.py`."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no reader for per-layer metric {metric!r}: "
                                f"{os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location("port_bench_metric_" + metric.replace(".", "_")
                                                  .replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
