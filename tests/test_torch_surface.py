"""The port's single-device surface beside the JAX package's, on the CPU:
GAP flags, the converter, statistics, the profiler, the bench's --quick,
the run and entry twins, and the CLI's --dist= on gloo CPU ranks."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax

from gardenia_tpu.core import command_line as jcl
from gardenia_tpu.core.generate import generate_graph as jax_generate
from gardenia_tpu.tools import converter as jconv
from gardenia_tpu.utils import statistics as jstats

from gardenia_tpu_torch.core import command_line as tcl
from gardenia_tpu_torch.core.graph import from_csr_of
from gardenia_tpu_torch.tools import converter as tconv
from gardenia_tpu_torch.utils import profiler as tprof
from gardenia_tpu_torch.utils import statistics as tstats

from tests.test_torch_entry import REPO, _FINDER, _run

MTX = """%%MatrixMarket matrix coordinate pattern general
% a small directed graph with a hub, a cycle and a tail
12 12 22
1 2
2 3
3 1
3 4
4 5
5 6
6 4
1 7
7 8
8 9
9 10
10 11
11 12
12 1
2 7
5 9
6 10
4 12
3 8
1 5
9 2
11 3
"""


@pytest.fixture
def mtx(tmp_path):
    path = tmp_path / "small.mtx"
    path.write_text(MTX)
    return str(path)


# ---- GAP flags -------------------------------------------------------------

ARGVS = [[], ["-g", "8"], ["-u", "9", "-k", "4", "-s"],
         ["-f", "x.mtx", "-n", "3", "-r", "5"],
         ["-g", "10", "-i", "20", "-t", "1e-3", "-d", "8", "extra"],
         ["-s", "-k", "2", "-g", "6", "a", "b"]]


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) or "none"
                                             for a in ARGVS])
def test_parse_gap_args_matches_jax(argv):
    assert vars(tcl.parse_gap_args(argv)) == vars(jcl.parse_gap_args(argv))


@settings(max_examples=40, deadline=None)
@given(st.lists(st.sampled_from(["-g", "-u", "-k", "-s", "-n", "-r", "-i",
                                 "-t", "-d", "-f", "3", "7", "0.5", "x",
                                 "-q"]), max_size=8))
def test_parse_gap_args_matches_jax_on_any_argv(argv):
    def parse(mod):
        try:
            return "ok", vars(mod.parse_gap_args(argv))
        except Exception as e:                    # the same error on both
            return type(e).__name__, str(e)
    assert parse(tcl) == parse(jcl)


@pytest.mark.parametrize("argv", [["-g", "7", "-k", "4"],
                                  ["-u", "8", "-s"], ["-g", "6", "-s"],
                                  "file"])
def test_load_from_flags_matches_jax(argv, mtx):
    if argv == "file":
        argv = ["-f", mtx, "-s"]
    gj = jcl.load_from_flags(jcl.parse_gap_args(argv), need_reverse=True)
    gt = tcl.load_from_flags(tcl.parse_gap_args(argv), need_reverse=True)
    np.testing.assert_array_equal(gt.rowptr, gj.rowptr)
    np.testing.assert_array_equal(gt.colidx, gj.colidx)
    np.testing.assert_array_equal(gt.in_colidx, gj.in_colidx)
    assert gt.symmetric == gj.symmetric


def test_load_from_flags_needs_a_graph():
    with pytest.raises(ValueError, match="need -f"):
        tcl.load_from_flags(tcl.parse_gap_args([]))


# ---- the converter -----------------------------------------------------------

@pytest.mark.parametrize("opts", [[], ["--symmetrize", "--labels=degree"]])
def test_converter_writes_the_jax_packages_bytes(mtx, tmp_path, opts, capsys):
    assert jconv.main([mtx, str(tmp_path / "jax"), *opts]) == 0
    assert tconv.main([mtx, str(tmp_path / "port"), *opts]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[2] and out[0].startswith("|V| 12 |E| ")
    exts = [".meta.txt", ".vertex.bin", ".edge.bin"] + \
        ([".vlabel.bin"] if opts else [])
    for ext in exts:
        a = (tmp_path / f"jax{ext}").read_bytes()
        b = (tmp_path / f"port{ext}").read_bytes()
        assert a == b and len(a) > 0, ext


def test_cli_reads_the_converted_binary(mtx, tmp_path, capsys):
    from gardenia_tpu_torch import cli
    prefix = str(tmp_path / "small")
    tconv.main([mtx, prefix, "--symmetrize"])
    for kernel in ("pr", "bfs", "tc"):
        assert cli.main([kernel, "bin", prefix, "--device=cpu"]) == 0
        assert capsys.readouterr().out.splitlines()[-1] == "Correct"


# ---- statistics and the profiler --------------------------------------------

@pytest.mark.parametrize("symmetrize", [False, True])
def test_graph_stats_match_jax(symmetrize):
    gj = jax_generate("rmat", scale=9, degree=8, symmetrize=symmetrize)
    assert tstats.graph_stats(from_csr_of(gj)) == jstats.graph_stats(gj)


def test_report_stats_and_env_check(capsys):
    tstats.report_stats({"a": 1, "b": 2.5}, prefix="> ")
    assert capsys.readouterr().out == "> a = 1\n> b = 2.5\n"
    env = tstats.env_check()
    assert env["torch"] == torch.__version__
    assert env["device_count"] == torch.cuda.device_count() == \
        len(env["devices"])
    assert env["omp_threads_analog"] == os.cpu_count()


def test_profile_region_writes_a_chrome_trace(tmp_path):
    with tprof.profile_region("solve", str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
    files = os.listdir(tmp_path / "trace")
    assert files == [f"solve.{os.getpid()}.trace.json"]
    assert (tmp_path / "trace" / files[0]).stat().st_size > 0


def test_profile_region_reads_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("GARDENIA_PROFILE_DIR", str(tmp_path))
    with tprof.profile_region("env"):
        torch.zeros(8).sum()
    assert os.listdir(tmp_path) == [f"env.{os.getpid()}.trace.json"]
    monkeypatch.delenv("GARDENIA_PROFILE_DIR")
    with tprof.profile_region("none"):          # no trace, only the range
        pass
    assert len(os.listdir(tmp_path)) == 1


def test_roi_times_the_region():
    with tprof.roi("step") as stats:
        torch.ones(16).sum()
    assert stats["name"] == "step" and stats["seconds"] >= 0


def test_device_memory_stats():
    assert tprof.device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tprof.device_memory_stats("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprof.device_memory_stats(f"cuda:{torch.cuda.device_count()}")


# ---- the bench's --quick, the run and entry twins ------------------------------

def test_bench_quick_is_scale_16():
    from gardenia_tpu_torch import bench
    assert bench.parse_args(["--quick"]).scale == 16
    assert bench.parse_args(["--quick", "--scale", "12"]).scale == 16
    assert bench.parse_args(["--scale", "12"]).scale == 12
    assert bench.parse_args([]).scale == 20


def test_run_twin_passes_on_the_cpu(mtx):
    proc = _run(["-m", "gardenia_tpu_torch.run", "--device", "cpu",
                 "--kernels", "pr,bfs,tc", "--datasets", mtx])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert [ln.split()[:2] for ln in lines[:3]] == \
        [["[PASS]", "pr"], ["[PASS]", "bfs"], ["[PASS]", "tc"]]
    assert lines[-1] == "3 passed, 0 failed, 0 skipped"


def _env_without_reference():
    return {k: v for k, v in os.environ.items() if k != "GARDENIA_REFERENCE"}


@pytest.mark.parametrize("given", ["nothing", "empty dir"])
def test_run_twin_skips_an_absent_fixture(given, tmp_path):
    from gardenia_tpu_torch import run
    flag = [] if given == "nothing" else ["--reference", str(tmp_path)]
    proc = _run(["-m", "gardenia_tpu_torch.run", "--device", "cpu",
                 "--kernels", "pr", "--quick", *flag],
                env=_env_without_reference())
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == f"0 passed, 0 failed, {len(run.FIXTURES)} skipped"
    skips = [ln for ln in lines if ln.startswith("[SKIP]")]
    assert len(skips) == len(run.FIXTURES)
    assert all(("no reference checkout" if given == "nothing" else
                "no file " + str(tmp_path)) in ln for ln in skips)


def test_run_twin_reads_the_fixture_of_the_named_checkout(mtx, tmp_path):
    from gardenia_tpu_torch import run
    ref = tmp_path / "reference"
    for _, rel, _ in run.FIXTURES:
        (ref / rel).parent.mkdir(parents=True, exist_ok=True)
        (ref / rel).write_text(open(mtx).read())
    proc = _run(["-m", "gardenia_tpu_torch.run", "--device", "cpu",
                 "--kernels", "bfs", "--quick"],
                env={**_env_without_reference(), "GARDENIA_REFERENCE":
                     str(ref)})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].split()[:3] == ["[PASS]", "bfs", "chesapeake.mtx"]
    assert lines[-1] == f"{len(run.FIXTURES)} passed, 0 failed, 0 skipped"


def test_run_twin_rmat_rows():
    from gardenia_tpu_torch import run
    assert run.targets("pr", [], True) == [("rmat", "16", ("1",))]
    assert run.targets("kcl", [], True) == [("rmat", "12", ("1", "4"))]
    assert run.targets("fsm", [("mtx", "a.mtx", "1")], True) == \
        [("mtx", "a.mtx", ("1",)), ("rmat", "12", ("2", "2"))]
    assert run.targets("motif", [], True) == []
    assert run.targets("pr", [], False) == []


def test_entry_step_matches_jax():
    import __graft_entry__
    from gardenia_tpu_torch.entry import entry
    fn_j, (x_j,) = __graft_entry__.entry()
    fn_t, (x_t,) = entry(device="cpu")
    np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    np.testing.assert_allclose(fn_t(x_t).numpy(),
                               np.asarray(jax.jit(fn_j)(x_j)), atol=1e-6,
                               rtol=0)


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    from gardenia_tpu_torch.entry import dryrun_multichip
    line = dryrun_multichip(2, device="cpu")
    assert line.startswith(
        "dryrun_multichip OK: 2 ranks (gloo, cpu x2) (1x2 2D), kernels "
        "sgd+pr+bfs+sssp+cc+bc+spmv+msbfs-dp+vc+symgs+mst+tc2d+scc2d, "
        "sgd rmse=")
    assert ", pr 3 iters, tc=" in line
    assert capsys.readouterr().out.strip() == line


def test_entry_refuses_a_missing_card():
    from gardenia_tpu_torch.entry import entry
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        entry()


# ---- the CLI's --dist= on gloo CPU ranks -------------------------------------

@pytest.mark.parametrize("kernel", ["pr", "bfs", "tc", "vc", "scc"])
def test_cli_dist_ends_correct(kernel, capsys):
    from gardenia_tpu_torch import cli
    assert cli.main([kernel, "rmat", "10", "--dist=2", "--device=cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == "mesh: 2 ranks (gloo, cpu x2)"
    assert lines[2].startswith(f"\truntime [{kernel}_dist2] = ")
    assert lines[-1] == "Correct"


def test_cli_dist_refuses_other_kernels_and_ignores_variant(capsys):
    from gardenia_tpu_torch import cli
    assert cli.main(["cc", "rmat", "10", "--dist=2", "--device=cpu"]) == 1
    assert capsys.readouterr().out.splitlines() == \
        ["kernel 'cc' has no multi-device path yet"]
    assert cli.main(["pr", "rmat", "10", "--dist=two", "--device=cpu"]) == 1
    assert capsys.readouterr().out.splitlines() == \
        ["--dist takes a number of ranks, got 'two'"]
    assert cli.main(["bfs", "rmat", "10", "1", "0", "7", "--variant=do",
                     "--dist=2", "--device=cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("(--variant=do is ignored for --dist runs")
    assert lines[-1] == "Correct"


def test_cli_dist_as_a_user_runs_it():
    """A fresh process under the finder that refuses jax: the ranks import
    the port only."""
    proc = _run(["-m", "gardenia_tpu_torch.cli", "pr", "rmat", "10",
                 "--dist=2", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "Correct"


def test_new_modules_import_without_jax():
    code = _FINDER + """
import importlib
for name in ("gardenia_tpu_torch.parallel.mesh",
             "gardenia_tpu_torch.parallel.partition",
             "gardenia_tpu_torch.parallel.pr", "gardenia_tpu_torch.parallel.bfs",
             "gardenia_tpu_torch.parallel.tc",
             "gardenia_tpu_torch.parallel.color",
             "gardenia_tpu_torch.core.command_line",
             "gardenia_tpu_torch.tools.converter",
             "gardenia_tpu_torch.utils.profiler",
             "gardenia_tpu_torch.utils.statistics",
             "gardenia_tpu_torch.run", "gardenia_tpu_torch.entry"):
    importlib.import_module(name)
assert not any(m == "jax" or m.startswith(("jax.", "gardenia_tpu."))
               for m in sys.modules)
print("imports ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                          capture_output=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "imports ok"
