"""The benchmark's arithmetic on synthetic inputs: percentiles, spread,
the union of device intervals, idle gaps, and the per-layer readers."""

import pytest

from graphbench import manifest, stats, trace


def test_percentiles_and_window_metrics():
    ms = list(range(1, 101))                  # 1..100 ms
    assert stats.percentile(ms, 50) == pytest.approx(50.5)
    assert stats.percentile(ms, 95) == pytest.approx(95.05)
    out = stats.window_metrics([x / 1e3 for x in ms], 10.0)
    assert out["trials_per_s"] == 10.0
    assert out["trial_ms_p50"] == pytest.approx(50.5)
    assert out["trial_ms_p95"] == pytest.approx(95.05)
    assert stats.percentile([7.0], 95) == 7.0


def test_union_counts_overlap_once():
    assert trace.union_length([(0, 10), (5, 15), (20, 25)]) == 20
    assert trace.union_length([(0, 10), (2, 3)]) == 10
    assert trace.union_length([]) == 0
    assert trace.merged([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]


def test_summary_idle_and_gap_labels():
    ev = [("k1", "kernel", 0, 4_000_000),
          ("memcpy", "copy", 4_000_000, 5_000_000),
          ("k2", "kernel", 7_000_000, 8_000_000),      # 2 ms after memcpy
          ("k3", "kernel", 7_500_000, 9_000_000),      # overlaps k2
          ("k1", "kernel", 12_000_000, 13_000_000)]    # 3 ms, a trial began
    s = trace.summary(ev, window_s=0.020, trials=2,
                      trial_starts_ns=[0, 10_000_000])
    assert s["busy_s"] == pytest.approx(0.008)
    assert s["kernels"] == 4 and s["copies"] == 1
    gaps = dict((k, v) for k, v in s["idle_gaps"])
    assert gaps["between trials"] == pytest.approx(0.003)
    assert gaps["after memcpy"] == pytest.approx(0.002)
    ops = dict((k, v) for k, v in s["device_ops"])
    assert ops["k1"] == pytest.approx(0.005)
    run = {"trace": s}
    assert manifest.metric("device_idle_pct").read(run) == \
        pytest.approx(60.0)
    assert manifest.metric("launches_per_trial").read(run) == 2.0


def test_roofline_byte_counts_and_shares():
    pr = manifest.metric("pr_roofline_pct")
    tc = manifest.metric("tc_roofline_pct")
    assert pr.iteration_bytes(1 << 20, 31_404_232) == \
        4 * 31_404_232 + 8 * (1 << 20)
    assert pr.trial_bytes(10, 100, 3) == 3 * (400 + 80)
    assert tc.dag_bytes(10, 50) == 200 + 44
    peaks = {"hbm_bytes_per_s": 1e9}
    run = {"trace": {"busy_s": 2.0, "trials": 4, "window_s": 3.0,
                     "kernels": 8},
           "graph": {"vertices": 10, "arcs": 100, "dag_edges": 50},
           "reference": {"pr_iterations": 3}, "peaks": peaks}
    # 1440 bytes at 1 GB/s = 1.44 us over 0.5 s of busy a trial
    assert pr.read(run) == pytest.approx(100 * 1.44e-6 / 0.5)
    assert tc.read(run) == pytest.approx(100 * 244e-9 / 0.5)


def test_readers_find_nothing_without_a_trace_or_peaks():
    run = {"trace": None, "graph": {}, "reference": {}, "peaks": None,
           "phases": {"graph_build_s": 1.5, "first_trial_s": 2.5}}
    for name in ("launches_per_trial", "device_idle_pct",
                 "pr_roofline_pct", "tc_roofline_pct"):
        assert manifest.metric(name).read(run) is None
    assert manifest.metric("graph_build_s").read(run) == 1.5
    assert manifest.metric("first_trial_s").read(run) == 2.5
