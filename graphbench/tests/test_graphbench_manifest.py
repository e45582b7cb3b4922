"""BENCHMARK.json names files that exist, with names and units the
contract allows, and every cell reports what it must."""

import json
import os
import re

import pytest

from graphbench import manifest

TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["graphbench"]
    assert 1 <= len(bench["command"]) <= 32
    assert all(TEXT.match(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(manifest.BENCHMARK) <= 64 * 1024


def test_configs_resolve(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert manifest.NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"]) and c["file"].startswith("graphbench/")
        assert c["file"] not in files
        files.add(c["file"])
        cfg = manifest.config(bench, c["name"])
        assert cfg["name"] == c["name"]
        assert hasattr(manifest.generator(cfg["generator"]), "edges")
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        for key in c["reduced"]:
            assert manifest.NAME.match(key) and key in cfg
        used = [w for w in bench["workloads"] if w["config"] == c["name"]]
        assert used, c["name"]
    assert len({c["source"] for c in bench["configs"]}) == len(names)


def test_cells_resolve_and_report(bench):
    cells = [w["name"] for w in bench["workloads"]]
    assert len(set(cells)) == len(cells)
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(cells)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        for key in ("name", "config", "traffic"):
            assert manifest.NAME.match(w[key]), w[key]
        assert TEXT.match(w["why"])
        mix = manifest.mix(w["traffic"])
        kern = manifest.kernel(mix["kernel"])
        for attr in ("plan", "Trials", "check", "control"):
            assert hasattr(kern, attr)
        e2e = [m["name"] for m in manifest.end_to_end(bench, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.per_layer(bench, w["name"])
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= 1


def test_metrics_resolve(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    seen = set()
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                           "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                           "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        assert hasattr(manifest.metric(m["name"]), "read")
        for w in m.get("workloads", []):
            assert w in cells
            assert m["moves"] in [x["name"] for x in
                                  manifest.end_to_end(bench, w)]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert manifest.NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert manifest.UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


def test_files_under_paths_are_named_from_name_characters():
    for base, dirs, files in os.walk(manifest.HERE):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), manifest.ROOT)
            if f.endswith(".pyc"):
                continue
            assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


@pytest.mark.parametrize("name", ["pr-pull", "bfs-random", "tc"])
def test_mix_files_are_data(name):
    path = os.path.join(manifest.HERE, "mixes", f"{name}.json")
    mix = json.load(open(path))
    assert {"kernel", "solver_args", "sample"} <= set(mix)
