"""Finds what a run needs by name: the cell in `BENCHMARK.json`, its
configuration's file, the modules of `reference/` that the file names (the
model's reference, key "reference"; its kernels' launches, key "launches"),
its traffic mix (`traffic/<name>.json`), its limits (`limits/<cell>.json`)
and each per-layer metric's reader (`metrics/<metric>.py`, a `read(run)`
function). A name with no entry or no file is an error, never a default.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# what the harness reads of a module of `reference/`, by the configuration's
# key that names it (port_bench/README.md); a reference module may also give
# `fixed(sd, cfg)`, which sets tensors the seeded draw leaves
CONTRACT = {
    "reference": ("param_shapes", "init", "DURATION_OUT", "acoustic", "to_durations", "Precision",
                  "synthesize", "request_flops"),
    "launches": ("KERNELS", "kernel_launches"),
}


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
    config = _load_json(os.path.join(ROOT, c["file"]))
    for key in CONTRACT:  # a configuration that names no module fails here, before set-up
        named_module(config, key)
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
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


def named_module(cfg: Dict, key: str) -> ModuleType:
    """The module of `reference/` that the configuration's `key` names by its
    file name, imported as `port_bench.reference.<stem>`."""
    if key not in cfg:
        raise KeyError(f"configuration {cfg.get('name', '')!r} lacks the key \"{key}\": "
                       f"the file name of a module under port_bench/reference/")
    name = cfg[key]
    if not isinstance(name, str) or not re.fullmatch(r"[A-Za-z_]\w*\.py", name):
        raise ValueError(f"{key!r} {name!r} is not the name of a .py file in port_bench/reference/")
    path = "port_bench/reference/" + name
    module = "port_bench.reference." + name[:-3]
    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise FileNotFoundError(f"no module {name!r} for {key!r}: {path}") from None
    missing = [n for n in CONTRACT[key] if not hasattr(mod, n)]
    if missing:
        raise AttributeError(f"module {path}, named by {key!r}, lacks {missing}")
    return mod


def reference(cfg: Dict) -> ModuleType:
    """The model's reference module: weights, forward, control, operations."""
    return named_module(cfg, "reference")


def launches(cfg: Dict) -> ModuleType:
    """The model's kernel launch list: `KERNELS` and `kernel_launches`."""
    return named_module(cfg, "launches")
