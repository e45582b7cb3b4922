"""A rehearsal of the kron20-sssp and urand20-bfs cells on the CPU at a
tiny scale through the harness's own run_cell: the result line has the
contract's keys and comes out correct; each SSSP control, put in the
program's place, comes out not correct.  On the card, both cells at
scale 16, traced."""

import json
import time

import pytest

from graphbench import control, manifest, run

TINY = {"scale": 10}
CELLS = ["kron20-sssp", "urand20-bfs"]


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_rehearses_correct(bench, workload, trace):
    res, lines = run.run_cell(bench, workload, 2**31 + 77, 0.3, trace,
                              "cpu", cfg_override=TINY,
                              t_start=time.perf_counter())
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    json.dumps(res)
    assert lines[-len(res["checks"]):] == [
        f"check {k} = {v['value']} (limit {v['limit']})"
        for k, v in res["checks"].items()]
    if trace:
        # the CPU has no device trace: the host-clock metrics and the
        # program's round count remain
        want = {"graph_build_s", "first_trial_s"}
        if workload == "kron20-sssp":
            want.add("sssp_rounds_per_trial")
        assert set(res["metrics"]) == want
    else:
        want = {m["name"] for m in manifest.end_to_end(bench, workload)}
        assert set(res["metrics"]) == want


def _one_control(name, monkeypatch):
    real = manifest.kernel

    def kernel(kind):
        mod = real(kind)
        if kind == "sssp":
            monkeypatch.setattr(mod, "CONTROLS", (name,))
        return mod
    monkeypatch.setattr(manifest, "kernel", kernel)


@pytest.mark.parametrize("name", ["bfloat16", "one_round_short"])
def test_sssp_control_fails(name, monkeypatch):
    _one_control(name, monkeypatch)
    cfg = dict(manifest.config(manifest.load_benchmark(), "kron20w"))
    cfg.update(TINY)
    for seed in (5, 2**31 + 5):
        (_, prog, ctrl, info), = control.readings(cfg, ["sssp-random"],
                                                  seed, 0.2, "cpu")
        assert prog["dist_mismatch"] == 0 and ctrl["dist_mismatch"] > 0
        assert info["control"]["answers_wrong"] == \
            info["control"]["sources_checked"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(bench, card, workload):
    res, _ = run.run_cell(bench, workload, 2**31 + 17, 1.0, True, card,
                          cfg_override={"scale": 16},
                          t_start=time.perf_counter())
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
    assert res["device"]["memory_peak_bytes"] > 0
    assert {"launches_per_trial", "device_idle_pct"} <= set(res["metrics"])
    if workload == "kron20-sssp":
        assert {"sssp_roofline_pct",
                "sssp_rounds_per_trial"} <= set(res["metrics"])
