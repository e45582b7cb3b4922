"""The hpcg20-symgs and urand20-tc cells on the card at scale 16, traced
(their CPU rehearsals are in tests/test_torch_symgs_bench.py)."""

import time

import pytest

from graphbench import run


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["hpcg20-symgs", "urand20-tc"])
def test_cell_on_the_card(bench, card, workload):
    res, _ = run.run_cell(bench, workload, 2**31 + 17, 1.0, True, card,
                          cfg_override={"scale": 16},
                          t_start=time.perf_counter())
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
    assert res["device"]["memory_peak_bytes"] > 0
    assert {"launches_per_trial", "device_idle_pct"} <= set(res["metrics"])
    if workload == "hpcg20-symgs":
        assert {"symgs_roofline_pct", "symgs_colors"} <= set(res["metrics"])
