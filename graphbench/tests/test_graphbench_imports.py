"""Nothing the benchmark runs loads jax, jaxlib, flax or the JAX package
gardenia_tpu (top-level names compared whole); the reference loads
nothing of the port."""

import ast
import json
import os
import subprocess
import sys

from graphbench import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "gardenia_tpu"}


def _python(code: str) -> dict:
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_of_every_cell_loads_no_jax():
    got = _python(
        "import json, sys, time\n"
        "from graphbench import manifest, run, control\n"
        "bench = manifest.load_benchmark()\n"
        "for w in bench['workloads']:\n"
        "    for tr in (False, True):\n"
        "        run.run_cell(bench, w['name'], 3, 0.2, tr, 'cpu',\n"
        "                     cfg_override={'scale': 8},\n"
        "                     t_start=time.perf_counter())\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    tops = set(got)
    assert "gardenia_tpu_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    got = _python(
        "import json, sys\n"
        "from graphbench import reference, generators\n"
        "e = generators.generate({'generator': 'urand', 'scale': 6,"
        " 'edge_factor': 4}, 1, 'cpu')\n"
        "g = reference.clean_csr(e.m, e.src, e.dst)\n"
        "reference.pagerank(g, 1e-4); reference.bfs(g, 0);"
        " reference.triangles(g)\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    assert not set(got) & (FORBIDDEN | {"gardenia_tpu_torch"})


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_names_jax():
    for base, _, files in os.walk(manifest.HERE):
        for f in files:
            if f.endswith(".py"):
                names = _imports(os.path.join(base, f))
                assert not names & FORBIDDEN, (f, names & FORBIDDEN)
    ref = _imports(os.path.join(manifest.HERE, "reference.py"))
    assert "gardenia_tpu_torch" not in ref and "graphbench" not in ref
