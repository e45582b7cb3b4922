"""On the card: every cell at a small scale through run_cell, traced,
comes out correct with a device trace to read."""

import time

import pytest

from graphbench import run


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["kron20-pr", "urand20-pr",
                                      "kron20-bfs", "kron20-tc"])
def test_cell_on_the_card(bench, card, workload):
    res, _ = run.run_cell(bench, workload, 2**31 + 17, 1.0, True, card,
                          cfg_override={"scale": 16},
                          t_start=time.perf_counter())
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
    assert res["device"]["memory_peak_bytes"] > 0
    assert {"launches_per_trial", "device_idle_pct"} <= set(res["metrics"])
