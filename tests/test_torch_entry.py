"""The port's entry points run as a user runs them, in fresh processes:
the package imports neither jax nor the JAX package gardenia_tpu, and the
CLI and the bench print their contract lines on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

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
        "gardenia_tpu_torch.solvers.bfs", "gardenia_tpu_torch.solvers.bc",
        "gardenia_tpu_torch.solvers.spmv", "gardenia_tpu_torch.solvers.sssp",
        "gardenia_tpu_torch.solvers.sssp_nf", "gardenia_tpu_torch.solvers.mst",
        "gardenia_tpu_torch.solvers.scc",
        "gardenia_tpu_torch.solvers.clustering",
        "gardenia_tpu_torch.solvers.sampling",
        "gardenia_tpu_torch.solvers.vc", "gardenia_tpu_torch.solvers.symgs",
        "gardenia_tpu_torch.solvers.sgd", "gardenia_tpu_torch.ops.vc_core",
        "gardenia_tpu_torch.utils.checkpoint",
        "gardenia_tpu_torch.mining.kcl", "gardenia_tpu_torch.mining.motif",
        "gardenia_tpu_torch.mining.wedgestream",
        "gardenia_tpu_torch.mining.pattern", "gardenia_tpu_torch.mining.sgl",
        "gardenia_tpu_torch.mining.dfscode", "gardenia_tpu_torch.mining.labels",
        "gardenia_tpu_torch.mining.gspan", "gardenia_tpu_torch.mining.fsm_agg",
        "gardenia_tpu_torch.mining.fsm", "gardenia_tpu_torch.ops.kcl_count",
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


# --- the CLI's flags, anywhere among the positionals ------------------------

def _cli(*words):
    proc = _run(["-m", "gardenia_tpu_torch.cli", *words])
    return proc, proc.stdout.splitlines()


@pytest.mark.parametrize("words", [
    ("cc", "--variant=afforest", "--device=cpu", "rmat", "10"),
    ("cc", "rmat", "10", "--device=cpu", "--variant=afforest"),
    ("cc", "rmat", "--variant=afforest", "10", "--device", "cpu")])
def test_cli_flags_anywhere_among_the_positionals(words):
    proc, lines = _cli(*words)
    assert proc.returncode == 0, proc.stderr
    assert lines[0] == "Connected Components by gardenia_tpu_torch"
    assert lines[1].startswith("|V| 1024 |E| ")
    assert lines[2].startswith("\truntime [afforest] = ")
    assert lines[-1] == "Correct"


@pytest.mark.parametrize("words,variant", [
    (("pr", "rmat", "10", "--variant=push"), "push"),
    (("pr", "rmat", "10", "1", "--variant=delta"), "delta"),
    (("tc", "--variant=bsearch", "rmat", "10"), "bsearch"),
    (("bfs", "rmat", "10", "1", "0", "5", "--variant=do_fused"), "do_fused"),
    (("bfs", "rmat", "10"), "pull"),
    (("bc", "rmat", "10"), "base")])
def test_cli_variants_and_new_kernels(words, variant):
    """Every kernel prints `runtime [<variant>]` with the variant that ran
    and ends Correct; bfs and bc print their iterations line.  (pr delta
    runs on the symmetrized graph: on the directed one both packages'
    residual check prints Wrong, the variant being approximate.)"""
    proc, lines = _cli(*words, "--device=cpu")
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert any(f"runtime [{variant}] = " in ln for ln in lines), lines
    assert lines[-1] == "Correct"
    if words[0] in ("bfs", "bc"):
        assert any(ln.startswith("\titerations = ") and ln.endswith(".")
                   for ln in lines)
    if words[0] in ("bfs", "pr"):
        assert any(ln.startswith("GTEPS = ") for ln in lines)


def test_cli_bfs_source_is_the_fifth_positional():
    """bfs <filetype> <scale> [symmetrize] [reverse] [source]: another
    source, another depth count, both Correct against the serial oracle."""
    from gardenia_tpu.core.generate import generate_graph
    from gardenia_tpu.solvers.bfs import bfs_solver
    g = generate_graph("rmat", scale=10, symmetrize=True, need_reverse=True)
    for source in (5, 338):
        proc, lines = _cli("bfs", "rmat", "10", "1", "0", str(source),
                           "--device=cpu", "--variant=do_fused")
        assert proc.returncode == 0, proc.stderr
        want = int(bfs_solver(g, source, variant="do_fused").iterations)
        assert f"\titerations = {want}." in lines
        assert lines[-1] == "Correct"


@pytest.mark.parametrize("words,message", [
    (("cc", "rmat", "10", "--bogus=1"), "unknown flag '--bogus=1'"),
    (("cc", "rmat", "10", "--dist=4"),
     "kernel 'cc' has no multi-device path yet"),
    (("cc", "rmat", "10", "--variant=nope", "--device=cpu"),
     "unknown CC variant 'nope'"),
    (("bc", "rmat", "10", "--variant=nope", "--device=cpu"),
     "unknown bc variant 'nope'"),
    (("cc", "rmat", "10", "--device=tpu"), "unknown device 'tpu'"),
    (("nope", "rmat", "10"), "Usage: python -m gardenia_tpu_torch.cli")])
def test_cli_refuses_what_it_does_not_know(words, message):
    proc, lines = _cli(*words)
    assert proc.returncode == 1
    assert any(message in ln for ln in lines), proc.stdout
    assert "Correct" not in lines


@pytest.mark.parametrize("kernel,metric,unit_per", [
    ("bfs", "bfs_dofused_gteps_rmat10", 1),
    ("msbfs", "msbfs128_gteps_rmat10", 128),
    ("bc", "bc_batched128_gteps_rmat10", 256)])
def test_bench_bfs_msbfs_bc_cpu_print_one_json_line(kernel, metric, unit_per):
    proc = _run(["-m", "gardenia_tpu_torch.bench", "--kernel", kernel,
                 "--scale", "10", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    d = rec["detail"]
    assert rec["metric"] == metric and rec["unit"] == "GTEPS"
    # the reference's formulas: edges (x sources, x 2 for Brandes) / time
    assert abs(rec["value"] - d["nnz"] * unit_per / d["ms"] / 1e6) \
        < 1e-9 * rec["value"]
    assert rec["vs_baseline"] == rec["value"] / (5.0 if kernel == "bc"
                                                 else 30.0)
    assert d["m"] == 1024 and d["levels"] >= 2 and d["device"] == "cpu"
    assert d["k1_launches"] == 0 == d["k1_tc_launches"]   # CPU: plain only
    if kernel != "bfs":
        assert d["sources"] == 128


# --- spmv, sssp, scc, mst --------------------------------------------------

@pytest.mark.parametrize("words,variant,lines_of", [
    (("spmv", "rmat", "10"), "ell", "spmv"),
    (("spmv", "rmat", "10", "1", "--variant=hybrid"), "hybrid", "spmv"),
    (("spmv", "--variant=segment", "rmat", "10"), "segment", "spmv"),
    (("spmv", "rmat", "10", "1", "--variant=push_pb"), "push_pb", "spmv"),
    (("sssp", "rmat", "10", "1", "0", "0", "8", "--variant=nearfar"),
     "nearfar", "sssp"),
    (("sssp", "rmat", "10", "--variant=bf"), "bf", "sssp"),
    (("sssp", "rmat", "10", "1", "0", "3", "16"), "delta", "sssp"),
    (("sssp", "--variant=hybrid", "rmat", "10", "1", "0", "0", "4"),
     "hybrid", "sssp"),
    (("scc", "rmat", "10"), "color", "scc"),
    (("scc", "rmat", "10", "--variant=wcc"), "wcc", "scc"),
    (("mst", "rmat", "10"), "boruvka", "mst")])
def test_cli_spmv_sssp_scc_mst_contract_lines(words, variant, lines_of):
    """spmv, sssp, scc and mst print the reference's lines and end
    Correct on the CPU, with --variant= anywhere.  (push_pb is the
    transpose product: it runs on the symmetrized graph, where it equals
    the forward one.)"""
    proc, lines = _cli(*words, "--device=cpu")
    assert proc.returncode == 0, proc.stderr + proc.stdout
    title = {"spmv": "Sparse Matrix-Vector Multiplication",
             "sssp": "Single Source Shortest Path",
             "scc": "Strongly Connected Components",
             "mst": "Minimum Spanning Tree"}[lines_of]
    assert lines[0] == f"{title} by gardenia_tpu_torch"
    assert lines[1].startswith("|V| 1024 |E| ")
    runtime = [ln for ln in lines if ln.startswith(f"\truntime [{variant}] = ")]
    assert len(runtime) == 1
    if lines_of == "spmv":
        assert runtime[0].endswith(" GB/s)") and "GFLOP/s" in runtime[0]
    else:
        assert runtime[0].endswith(" ms.")
    if lines_of == "sssp":
        assert any(ln.startswith("\titerations = ") for ln in lines)
    if lines_of == "scc":
        assert any(ln.startswith("number of SCCs = ") for ln in lines)
    if lines_of == "mst":
        assert any(ln.startswith("MST weight = ") for ln in lines)
    assert lines[-1] == "Correct"


@pytest.mark.parametrize("words,message", [
    (("spmv", "rmat", "10", "--variant=nope", "--device=cpu"),
     "unknown SpMV variant 'nope'"),
    (("sssp", "rmat", "10", "--variant=nope", "--device=cpu"),
     "unknown SSSP variant 'nope'"),
    (("scc", "rmat", "10", "--variant=nope", "--device=cpu"),
     "unknown SCC variant 'nope'"),
    (("mst", "rmat", "10", "--variant=nope", "--device=cpu"),
     "unknown mst variant 'nope'")])
def test_cli_spmv_sssp_scc_mst_refuse_unknown_variants(words, message):
    proc, lines = _cli(*words)
    assert proc.returncode == 1
    assert any(message in ln for ln in lines), proc.stdout
    assert "Correct" not in lines


@pytest.mark.parametrize("kernel,metric,unit", [
    ("spmv", "spmv_gflops_rmat10", "GFLOP/s"),
    ("sssp", "sssp_nf_gteps_grid32", "GTEPS"),
    ("mst", "mst_boruvka_ms_rmat10", "ms"),
    ("scc", "scc_ms_rmat10d", "ms")])
def test_bench_spmv_sssp_mst_scc_cpu_print_one_json_line(kernel, metric, unit):
    """One JSON line with the reference's metric name and formula."""
    proc = _run(["-m", "gardenia_tpu_torch.bench", "--kernel", kernel,
                 "--scale", "10", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    d = rec["detail"]
    assert rec["metric"] == metric and rec["unit"] == unit
    assert rec["value"] > 0 and d["device"] == "cpu"
    if kernel == "spmv":
        assert abs(rec["value"] - 2 * d["nnz"] / d["ms_per_apply"] / 1e6) \
            < 1e-9 * rec["value"]
        assert rec["vs_baseline"] == rec["value"] / 55.0
        assert d["reps"] == 8 and d["k1_launches"] == 0   # CPU: plain K1
    elif kernel == "sssp":
        assert d["m"] == 1024 and d["nnz"] == 3968 and d["rounds"] > 1
        assert abs(rec["value"] - d["nnz"] / d["ms"] / 1e6) \
            < 1e-9 * rec["value"]
    else:
        per = {"mst": 2.0, "scc": 1.0}[kernel]
        assert rec["vs_baseline"] == per / (rec["value"] / (d["nnz"] / 1e6))
        assert (d["weight"] > 0) if kernel == "mst" else (
            d["sccs"] > 1 and d["rounds"] >= 1)


# --- vc, symgs, sgd -----------------------------------------------------

@pytest.mark.parametrize("words", [("vc", "rmat", "10"),
                                   ("symgs", "rmat", "10"),
                                   ("sgd", "rmat", "10"),
                                   ("sgd", "rmat", "10", "0", "0", "0.05",
                                    "0.003", "5")])
def test_cli_vc_symgs_sgd_contract_lines(words):
    """vc, symgs and sgd print the reference's lines (gardenia_tpu/cli.py:
    133-141, 203-250) and end Correct on the CPU."""
    proc, lines = _cli(*words, "--device=cpu")
    assert proc.returncode == 0, proc.stderr + proc.stdout
    title = {"vc": "Vertex Coloring",
             "symgs": "Symmetric Gauss-Seidel smoother",
             "sgd": "Stochastic Gradient Descent"}[words[0]]
    assert lines[0] == f"{title} by gardenia_tpu_torch"
    assert lines[1].startswith("|V| 1024 |E| ")
    runtime = [ln for ln in lines if ln.startswith("\truntime [base] = ")]
    assert len(runtime) == 1
    if words[0] == "vc":
        from gardenia_tpu.core.generate import generate_graph
        from gardenia_tpu.solvers.vc import vc_solver
        want = vc_solver(generate_graph("rmat", scale=10, symmetrize=True))
        assert runtime[0].endswith(
            f" ms, num_colors = {int(want.num_colors)}.")
    else:
        assert runtime[0].endswith(" ms.")
    if words[0] == "sgd":
        epochs = int(words[-1]) if len(words) > 3 else 3
        assert [ln.split(":")[0] for ln in lines
                if ln.startswith("Iteration ")] == [
            f"Iteration {i + 1}" for i in range(epochs)]
        assert f"\titerations = {epochs}." in lines
    assert lines[-1] == "Correct"


@pytest.mark.parametrize("kernel,metric,unit", [
    ("vc", "vc_ms_rmat10", "ms"),
    ("symgs", "symgs_gflops_rmat10", "GFLOP/s"),
    ("sgd", "sgd_mf_mrps_rmat10", "M ratings/s")])
def test_bench_vc_symgs_sgd_cpu_print_one_json_line(kernel, metric, unit):
    """One JSON line with the reference's metric name and formula
    (bench.py:291-331, 442-452, 500-522).  At scale 10 the SGD bench takes
    the full-gradient step (no 64K-edge batch), where step 0.1 diverges,
    in the JAX package too: only its shape is checked here."""
    proc = _run(["-m", "gardenia_tpu_torch.bench", "--kernel", kernel,
                 "--scale", "10", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    d = rec["detail"]
    assert rec["metric"] == metric and rec["unit"] == unit
    assert rec["value"] > 0 and d["device"] == "cpu" and d["m"] == 1024
    if kernel == "vc":
        assert rec["vs_baseline"] == 1.0 / (rec["value"] / (d["nnz"] / 1e6))
        assert d["rounds"] == sum(d["rounds_by_tier"].values()) >= 1
        assert d["palette"] == 128 and d["core_size"] == 1024
        assert d["v1_launches"] == 0 and d["num_colors"] > 1   # CPU: plain
    elif kernel == "symgs":
        assert abs(rec["value"] - 4 * d["nnz"] / d["ms"] / 1e6) \
            < 1e-9 * rec["value"]
        assert d["colors"] > 1
    else:
        assert d["epochs"] == 10 and len(d["rmse"]) == 10
        assert abs(rec["value"] - d["nnz"] * 10 / d["ms"] / 1e3) \
            < 1e-9 * rec["value"]


def test_timer_needs_its_device():
    """time_op and Timer have no default device: a CUDA solve timed
    without its synchronize would measure the enqueue."""
    from gardenia_tpu_torch.utils.timer import Timer, time_op
    with pytest.raises(TypeError):
        time_op(lambda: None)
    with pytest.raises(TypeError):
        Timer()
    result, secs = time_op(lambda: 7, device="cpu", warmup=0, iters=2)
    assert result == 7 and secs >= 0


# --- kcl, motif ---------------------------------------------------------

@pytest.mark.parametrize("words,title,total", [
    (("kcl", "rmat", "8"), "k-Clique Listing", "total_num_cliques = 44214"),
    (("kcl", "rmat", "8", "1", "3"), "k-Clique Listing",
     "total_num_cliques = 11768"),
    (("motif", "rmat", "6", "1", "4"), "Motif Counting", "4-clique: 2726"),
    (("motif", "rmat", "6"), "Motif Counting", "3-triangle: 1328")])
def test_cli_kcl_motif_contract_lines(words, title, total):
    """kcl and motif print the reference's lines (gardenia_tpu/cli.py:
    251-288) and end Correct on the CPU: kcl against the serial DFS, motif
    against the brute-force census; kcl names its route and Q1's
    launches, motif at k = 4 its aggregates."""
    proc, lines = _cli(*words, "--device=cpu")
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert lines[0] == f"{title} by gardenia_tpu_torch"
    assert lines[1].startswith(f"|V| {1 << int(words[2])} |E| ")
    variant = "base" if words[0] == "kcl" else "formula"
    assert lines[2].startswith(f"\truntime [{variant}] = ")
    assert total in lines
    if words[0] == "kcl":
        route = "tc" if words[-1] == "3" else "q1_plain"
        assert f"route = {route}, Q1 launches = 0" in lines
    if words[-1] == "4":
        assert "aggregates = streams" in lines
    assert lines[-1] == "Correct"


@pytest.mark.parametrize("kernel,metric,unit", [
    ("kcl", "kcl4_mcps_rmat8", "M cliques/s"),
    ("motif", "motif4_meps_rmat8", "M edges/s")])
def test_bench_kcl_motif_cpu_print_one_json_line(kernel, metric, unit):
    """One JSON line with the reference's metric name and formula
    (bench.py:376-408), the route or the aggregates' branch, and the
    check that holds the answer."""
    proc = _run(["-m", "gardenia_tpu_torch.bench", "--kernel", kernel,
                 "--scale", "8", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    d = rec["detail"]
    assert rec["metric"] == metric and rec["unit"] == unit
    assert d["device"] == "cpu" and d["m"] == 256 and d["correct"] is True
    if kernel == "kcl":
        assert d["cliques"] == 44214 and d["k"] == 4
        assert abs(rec["value"] - 44214 / d["ms"] / 1e3) < 1e-9 * rec["value"]
        assert rec["vs_baseline"] == rec["value"] / 200.0
        assert d["route"] == "q1_plain" and d["q1_launches"] == 0
        assert d["check"] == "verifier"
    else:
        assert d["census"]["4-clique"] == 44214
        assert abs(rec["value"] - d["nnz"] / d["ms"] / 1e3) \
            < 1e-9 * rec["value"]
        assert rec["vs_baseline"] == rec["value"] / 50.0
        assert d["aggregates"] == "streams" and d["check"] == "solvers"
        assert d["kcl_route"] == "q1_plain" and d["q1_launches"] == 0
        assert d["n_parts"] == d["n_qparts"] == 1


# --- sgl, fsm -------------------------------------------------------------

@pytest.mark.parametrize("words,title,want", [
    (("sgl", "rmat", "5", "1", "diamond"), "Subgraph Listing",
     ("total_num_diamond = 1525",)),
    (("sgl", "rmat", "5", "1", "house"), "Subgraph Listing",
     ("total_num_house = 683",)),
    (("fsm", "rmat", "8", "2", "2"), "Frequent Subgraph Mining",
     ("minsup = 2", "k = 2", "Number of frequent subgraphs (minsup=2): 91"))])
def test_cli_sgl_fsm_contract_lines(words, title, want):
    """sgl and fsm print the reference's lines (gardenia_tpu/cli.py:
    290-318) and end Correct on the CPU: sgl against the brute-force
    listing, fsm against the brute-force miner; the counts are the JAX
    package's."""
    from gardenia_tpu.core.generate import generate_graph
    from gardenia_tpu.mining.fsm import fsm_solver
    from gardenia_tpu.mining.sgl import sgl_solver
    proc, lines = _cli(*words, "--device=cpu")
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert lines[0] == f"{title} by gardenia_tpu_torch"
    assert lines[1].startswith(f"|V| {1 << int(words[2])} |E| ")
    assert any(ln.startswith("\truntime [base] = ") for ln in lines)
    for line in want:
        assert line in lines
    g = generate_graph("rmat", scale=int(words[2]), symmetrize=True)
    if words[0] == "sgl":
        assert want[0].endswith(f" = {sgl_solver(g, words[4])}")
    else:
        assert want[-1].endswith(f": {fsm_solver(g, 2, 2)}")
    assert lines[-1] == "Correct"


def test_cli_and_bench_list_every_kernel_of_the_reference():
    """All 16 of the reference CLI's kernels and all 17 of its bench's
    entries (gardenia_tpu/cli.py:321-338, bench.py:569-575)."""
    from gardenia_tpu_torch import bench, cli
    assert len(cli.KERNELS) == 16 and len(bench.KERNELS) == 17
    proc, lines = _cli()
    assert proc.returncode == 1
    assert lines[-1] == "kernels: " + " ".join(sorted(cli.KERNELS))


@pytest.mark.parametrize("kernel,metric,unit", [
    ("sgl", "sgl_diamond_meps_rmat10", "M edges/s"),
    ("fsm", "fsm2_minsup5000_meps_rmat10", "M edges/s")])
def test_bench_sgl_fsm_cpu_print_one_json_line(kernel, metric, unit):
    """One JSON line with the reference's metric name and formula
    (bench.py:525-566) and the check that holds the answer."""
    proc = _run(["-m", "gardenia_tpu_torch.bench", "--kernel", kernel,
                 "--scale", "10", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    d = rec["detail"]
    assert rec["metric"] == metric and rec["unit"] == unit
    assert d["device"] == "cpu" and d["m"] == 1024 and d["correct"] is True
    assert abs(rec["value"] - d["nnz"] / d["ms"] / 1e3) < 1e-9 * rec["value"]
    if kernel == "sgl":
        assert d["count"] == 2706606 and d["check"] == "engine"
        assert rec["vs_baseline"] == rec["value"] / 100.0
        assert d["route"] == "streams" and d["kcl_route"] == "q1_plain"
        assert d["q1_launches"] == 0
    else:
        assert rec["vs_baseline"] == rec["value"] / 5.0
        assert d["frequent_patterns"] == 0 and d["check"] == "gspan"
        assert d["labels"] == 11 and d["lane_chunks"] == 1
        assert d["k1_launches"] == {"simt": 0, "tc": 0}
        assert d["split_launches"] == 0
        # no pattern reaches minsup 5000 here: at minsup 30 the bench's
        # aggregate path and its gSpan check have patterns to agree on
        from gardenia_tpu_torch import bench
        from gardenia_tpu_torch.mining import fsm, gspan
        g = bench.get_graph(10)
        assert fsm.fsm_solver(g, 2, 30, device="cpu") == \
            gspan.fsm_gspan(g, 2, 30, device="cpu") == 47
