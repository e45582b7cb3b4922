"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration and a traffic mix;
the configuration names a generator module and the mix a kernel module;
the cell's per-layer metrics are the `per_layer` entries whose
`workloads` list it (or that have no such list).  Nothing here knows any
particular cell.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(path: str = BENCHMARK) -> dict:
    return load_json(path)


def _module(kind: str, name: str) -> ModuleType:
    """graphbench/<kind>/<name>.py, loaded by its path (a name may hold
    '-' or '.', which an import statement cannot spell)."""
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"graphbench.{kind}.{name.replace('-', '_').replace('.', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel(name: str) -> ModuleType:
    return _module("kernels", name)


def metric(name: str) -> ModuleType:
    return _module("metrics", name)


def generator(name: str) -> ModuleType:
    return _module("generators", name)


def mix(name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad mix name {name!r}")
    return load_json(os.path.join(HERE, "mixes", f"{name}.json"))


def config(bench: dict, name: str) -> dict:
    """The configuration file of BENCHMARK.json's config `name`."""
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(ROOT, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def reports(metric_entry: dict, workload: str) -> bool:
    """Whether a metric entry is reported in the cell `workload`."""
    cells = metric_entry.get("workloads")
    return cells is None or workload in cells


def end_to_end(bench: dict, workload: str) -> list:
    return [m for m in bench["end_to_end"] if reports(m, workload)]


def per_layer(bench: dict, workload: str) -> list:
    return [m for m in bench["per_layer"] if reports(m, workload)]
