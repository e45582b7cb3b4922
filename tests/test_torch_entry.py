"""The port's entry points run as a user runs them, in fresh processes:
the package imports neither jax nor the JAX package gardenia_tpu, and the
CLI and the bench print their contract lines on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# refuses jax and every module of the JAX package gardenia_tpu;
# gardenia_tpu_torch passes
_FINDER = r"""
import importlib, importlib.abc, pkgutil, runpy, sys

class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError(f"jax import attempted: {name}")
        if name == "gardenia_tpu" or name.startswith("gardenia_tpu."):
            raise ImportError(f"gardenia_tpu import attempted: {name}")
        return None

sys.meta_path.insert(0, NoJax())
"""

_NO_JAX = _FINDER + r"""
import gardenia_tpu_torch
# every module of the port, subpackages included
names = [m.name for m in pkgutil.walk_packages(gardenia_tpu_torch.__path__,
                                               "gardenia_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {"gardenia_tpu_torch.cli", "gardenia_tpu_torch.solvers.cc",
        "gardenia_tpu_torch.core.graph", "gardenia_tpu_torch.native",
        "gardenia_tpu_torch.verify.oracles"} <= set(names), names
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
assert not any(m == "gardenia_tpu" or m.startswith("gardenia_tpu.")
               for m in sys.modules)
print("imports ok")
"""


def _run(args, **kw):
    """`python -m <module> ...` (args[0] == "-m") run under the finder
    that refuses jax and gardenia_tpu, or `python <args>` as given."""
    if args[0] == "-m":
        args = ["-c", _FINDER + f"sys.argv = {args[1:]!r}\n"
                f"runpy.run_module({args[1]!r}, run_name='__main__')"]
    return subprocess.run([sys.executable, *args], cwd=REPO, text=True,
                          capture_output=True, timeout=300, **kw)


def test_port_imports_without_jax():
    proc = _run(["-c", _NO_JAX])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "imports ok"


def test_cli_pr_cpu_contract_lines():
    proc = _run(["-m", "gardenia_tpu_torch.cli", "pr", "rmat", "10",
                 "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "PageRank by gardenia_tpu_torch"
    assert lines[1].startswith("|V| 1024 |E| ")
    assert any(ln.startswith("\titerations = ") for ln in lines)
    assert any(ln.startswith("\truntime [pull] = ") and ln.endswith(" ms.")
               for ln in lines)
    assert any(ln.startswith("GTEPS = ") for ln in lines)
    assert lines[-1] == "Correct"


def test_bench_cpu_prints_one_json_line():
    proc = _run(["-m", "gardenia_tpu_torch.bench", "--scale", "10",
                 "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "pr_pull_gteps_rmat10" and rec["unit"] == "GTEPS"
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    assert rec["detail"]["m"] == 1024 and rec["detail"]["iters"] > 0
    assert rec["detail"]["device"] == "cpu"


def test_cli_tc_cpu_contract_lines():
    from gardenia_tpu.core.generate import generate_graph
    from gardenia_tpu.solvers.tc import tc_solver
    proc = _run(["-m", "gardenia_tpu_torch.cli", "tc", "rmat", "10",
                 "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[:2] == ["Triangle Counting by gardenia_tpu_torch",
                         "Using DAG (static orientation)"]
    assert lines[2].startswith("|V| 1024 |E| ")
    assert lines[3].startswith("runtime [base] = ") and \
        lines[3].endswith(" sec")
    expect = tc_solver(generate_graph("rmat", scale=10, symmetrize=True))
    assert lines[4] == f"total_num_triangles = {expect}" and expect > 0
    assert lines[-1] == "Correct"


def test_bench_tc_cpu_prints_one_json_line():
    proc = _run(["-m", "gardenia_tpu_torch.bench", "--kernel", "tc",
                 "--scale", "10", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "tc_meps_rmat10" and rec["unit"] == "M edges/s"
    assert rec["value"] > 0
    assert rec["vs_baseline"] == rec["value"] / 2000.0
    assert rec["detail"]["m"] == 1024 and rec["detail"]["triangles"] > 0
    assert rec["detail"]["device"] == "cpu"


def test_cli_cc_cpu_contract_lines():
    proc = _run(["-m", "gardenia_tpu_torch.cli", "cc", "rmat", "10",
                 "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "Connected Components by gardenia_tpu_torch"
    assert lines[1].startswith("|V| 1024 |E| ")
    assert lines[2].startswith("\truntime [sv] = ") and \
        lines[2].endswith(" ms.")
    from gardenia_tpu.core.generate import generate_graph
    from gardenia_tpu.verify import oracles
    expect = oracles.cc_serial(generate_graph("rmat", scale=10,
                                              symmetrize=True))
    assert lines[3] == f"num_components = {len(np.unique(expect))}"
    assert lines[-1] == "Correct"


def test_bench_cc_cpu_prints_one_json_line():
    proc = _run(["-m", "gardenia_tpu_torch.bench", "--kernel", "cc",
                 "--scale", "10", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "cc_sv_ms_rmat10" and rec["unit"] == "ms"
    d = rec["detail"]
    assert rec["value"] > 0 and rec["vs_baseline"] == \
        1.0 / (rec["value"] / (d["nnz"] / 1e6))
    assert d["m"] == 1024 and d["rounds"] >= 1 and d["device"] == "cpu"
    assert d["k2_launches"] == 0                 # CPU: plain version only
