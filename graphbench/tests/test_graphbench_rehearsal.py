"""A rehearsal of every cell on the CPU at a tiny scale through the
harness's own run_cell: the result line has the contract's keys and
comes out correct; each kernel's control, put in the program's place,
comes out not correct; and the runner gives no result without a card."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from graphbench import control, manifest, run

TINY = {"scale": 10}
CELLS = ["kron20-pr", "urand20-pr", "kron20-bfs", "kron20-tc"]


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_rehearses_correct(bench, workload, trace):
    res, lines = run.run_cell(bench, workload, 2**31 + 99, 0.3, trace, "cpu",
                              cfg_override=TINY, t_start=time.perf_counter())
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    json.dumps(res)
    assert lines[-len(res["checks"]):] == [
        f"check {k} = {v['value']} (limit {v['limit']})"
        for k, v in res["checks"].items()]
    if trace:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(res["device"])
        # the CPU has no device trace: only the host-clock metrics remain
        assert set(res["metrics"]) == {"graph_build_s", "first_trial_s"}
    else:
        want = {m["name"] for m in manifest.end_to_end(bench, workload)}
        assert set(res["metrics"]) == want


def _control(config, mix, monkeypatch=None):
    cfg = dict(manifest.config(manifest.load_benchmark(), config))
    cfg.update(TINY)
    out = {}
    for seed in (5, 6, 2**31 + 5):
        for name, prog, ctrl, _ in control.readings(cfg, [mix], seed, 0.2,
                                                    "cpu"):
            out[seed] = (prog, ctrl)
    return out


@pytest.mark.parametrize("config", ["kron20", "urand20"])
def test_pr_control_fails(config):
    from graphbench.kernels import pr as _  # noqa: F401
    limits = manifest.kernel("pr").LIMITS
    for prog, ctrl in _control(config, "pr-pull").values():
        assert prog["score_gap"] <= limits["score_gap"]
        assert ctrl["score_gap"] > limits["score_gap"]


def test_bfs_control_fails():
    for prog, ctrl in _control("kron20", "bfs-random").values():
        assert prog["depth_mismatch"] == 0 and ctrl["depth_mismatch"] > 0


def test_tc_control_fails_where_the_count_passes_its_accumulator(
        monkeypatch):
    # kron20's count passes float32's 2^24; the tiny graph's (~8e4)
    # passes bfloat16's 2^8, so the test takes that accumulator
    monkeypatch.setattr(manifest, "kernel", _patched_tc_kernel(monkeypatch))
    for prog, ctrl in _control("kron20", "tc").values():
        assert prog["count_gap"] == 0 and ctrl["count_gap"] > 0


def _patched_tc_kernel(monkeypatch):
    real = manifest.kernel

    def kernel(name):
        mod = real(name)
        if name == "tc":
            monkeypatch.setattr(mod, "CONTROL_ACCUMULATE", torch.bfloat16)
        return mod
    return kernel


def test_runner_gives_no_result_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "kron20-pr", "--seed", "1", "--seconds",
                   "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "no result" in out.err


def test_runner_gives_no_result_beside_the_benchmark_alone(tmp_path):
    shutil.copy(manifest.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(manifest.HERE, tmp_path / "graphbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "graphbench.run", "--workload", "kron20-pr",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout == ""
