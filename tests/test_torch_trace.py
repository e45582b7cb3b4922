"""The port's recorder (gardenia_tpu_torch/utils/profiler: spans,
counters, host_read) and what graphbench reads of it (graphbench/spans.py,
the recorder's metrics, graphbench/spanrun.py), on the CPU."""

import json
import os
import time

import pytest
import torch

from gardenia_tpu_torch.core.generate import generate_graph
from gardenia_tpu_torch.ops import _build, tc_count
from gardenia_tpu_torch.solvers import bfs, pr, tc
from gardenia_tpu_torch.utils import profiler as P

from graphbench import manifest, spanrun, spans


@pytest.fixture
def rec():
    """The recorder on for the test, empty before and after it."""
    P.take()
    with P.recording():
        yield P
    P.take()


@pytest.fixture(scope="module")
def graph():
    return generate_graph("rmat", 9, symmetrize=True)


def names(spans_):
    out = {}
    for s in spans_:
        out[s[2]] = out.get(s[2], 0) + 1
    return out


def own(counters):
    return {k: v for k, v in counters.items()
            if not k.startswith("launches.")}


# --- the recorder ------------------------------------------------------------

def test_off_records_nothing(graph):
    P.take()
    assert P.span("x") is P.span("y")            # the one shared null context
    with P.span("x"):
        P.count("n", 5)
        assert P.host_read(torch.tensor(2.5)) == 2.5
    r = pr.pr_solver(graph, device="cpu")
    assert r.iterations > 0
    got = P.take()
    assert got["spans"] == [] and own(got["counters"]) == {}


def test_nesting_and_parent_ids(rec):
    with P.span("a"):
        with P.span("b"):
            with P.span("c"):
                pass
        with P.span("d"):
            pass
    with P.span("e"):
        pass
    got = P.take()["spans"]
    by = {s[2]: s for s in got}
    assert [s[2] for s in got] == ["a", "b", "c", "d", "e"]
    assert by["a"][1] is None and by["e"][1] is None
    assert by["b"][1] == by["a"][0] and by["d"][1] == by["a"][0]
    assert by["c"][1] == by["b"][0]
    assert len({s[0] for s in got}) == 5
    for s in got:
        assert s[3] <= s[4]
    assert by["a"][3] <= by["b"][3] <= by["c"][4] <= by["b"][4] \
        <= by["d"][3] <= by["a"][4] <= by["e"][3]


def test_a_span_closes_when_its_region_raises(rec, monkeypatch):
    monkeypatch.setattr(_build, "_LIB", None)

    def no_nvcc(force=False):
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "build", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.lib()
    (load,) = P.take()["spans"]
    assert load[2] == "kernels.load" and load[4] is not None


def test_counters_and_launches_in_one_snapshot(rec, monkeypatch):
    monkeypatch.setitem(tc_count.LAUNCHES, "merge_count", 6)
    P.count("a")
    P.count("a", 2)
    P.count("b", 0)
    got = P.take()
    assert got["counters"]["a"] == 3 and got["counters"]["b"] == 0
    assert got["counters"]["launches.tc_count.merge_count"] == 6
    again = P.take()
    assert own(again["counters"]) == {} and again["spans"] == []
    assert again["counters"]["launches.tc_count.merge_count"] == 6


def test_recording_restores_the_state_it_found():
    P.take()
    with P.recording():
        with P.recording():
            P.count("x")
        P.count("x")
    P.count("x")                                   # off again
    assert own(P.take()["counters"]) == {"x": 2}


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("value,plain", [
    (torch.tensor(0.1, dtype=torch.float32), float),
    (torch.tensor(7, dtype=torch.int64), int),
    (torch.tensor(True), bool),
    (torch.tensor([3, 9, 27], dtype=torch.int64), lambda t: t.tolist()),
], ids=["float32", "int64", "bool", "stack"])
def test_host_read_returns_what_the_bare_read_did(value, plain, on):
    P.take()
    with P.recording() if on else P.span("off"):
        got = P.host_read(value)
    want = plain(value)
    assert got == want and type(got) is type(want)
    rec = P.take()
    assert own(rec["counters"]) == ({"host_reads": 1} if on else {})
    assert names(rec["spans"]) == ({"read": 1} if on else {})


def test_spanned_keeps_the_function(rec):
    assert pr.pr_solver.__name__ == "pr_solver"
    assert pr.pr_solver.__wrapped__.__name__ == "pr_solver"

    @P.spanned("solve.x")
    def f(a, *, b=2):
        return a + b
    assert f(1, b=3) == 4
    (s,) = P.take()["spans"]
    assert s[2] == "solve.x"


def test_roi_is_a_span(rec):
    with P.roi("step") as stats:
        torch.ones(16).sum()
    (s,) = P.take()["spans"]
    assert s[2] == "step" and stats["seconds"] >= 0


def test_profile_region_writes_its_spans_into_the_trace(tmp_path):
    P.take()
    with P.profile_region("solve", str(tmp_path)):
        with P.span("inner"):
            torch.ones(64).cumsum(0)
    assert own(P.take()["counters"]) == {}        # nothing left behind
    (name,) = os.listdir(tmp_path)
    trace = json.load(open(tmp_path / name))
    mine = [e for e in trace["traceEvents"]
            if e.get("cat") == "gardenia_span"]
    assert [e["name"] for e in mine] == ["inner"]
    # on the trace's own time base: inside the region's profiler events
    ops = [e for e in trace["traceEvents"] if e.get("ph") == "X"
           and e.get("cat") != "gardenia_span"]
    assert min(e["ts"] for e in ops) - 1e6 < mine[0]["ts"] < \
        max(e["ts"] + e.get("dur", 0) for e in ops) + 1e6


# --- where the port records --------------------------------------------------

@pytest.mark.parametrize("variant,layout", [
    ("pull", "hybrid"), ("pull", "ell"), ("delta", "hybrid"),
    ("push", "auto")])
def test_pr_reads_once_an_iteration(graph, rec, variant, layout):
    r = pr.pr_solver(graph, variant=variant, layout=layout, device="cpu")
    got = P.take()
    assert got["counters"]["host_reads"] == r.iterations
    n = names(got["spans"])
    assert n["pr.iteration"] == r.iterations == n["read"]
    assert n["solve.pr"] == 1


@pytest.mark.parametrize("source", [0, 5, 100])
def test_bfs_do_fused_reads_once_a_level_and_twice_more(graph, rec, source):
    """The source's relabelled id, the first level's state, then one read
    that ends each level."""
    r = bfs.bfs_solver(graph, source, variant="do_fused", device="cpu")
    got = P.take()
    assert got["counters"]["host_reads"] == r.iterations + 2
    n = names(got["spans"])
    assert n["bfs.level"] == r.iterations and n["read"] == r.iterations + 2
    # every level's span holds its read
    by = {s[0]: s for s in got["spans"]}
    inside = [s for s in got["spans"] if s[2] == "read"
              and by[s[1]][2] == "bfs.level"]
    assert len(inside) == r.iterations


@pytest.mark.parametrize("variant,more", [("pull", 1), ("do", 0)])
def test_bfs_host_loops_read_once_a_level(graph, rec, variant, more):
    """pull also reads the source's relabelled id; do runs on the
    original ids."""
    r = bfs.bfs_solver(graph, 3, variant=variant, device="cpu")
    n = names(P.take()["spans"])
    assert n["bfs.level"] == r.iterations
    assert n["read"] == r.iterations + more


def test_tc_reads_once(graph, rec):
    count = tc.tc_solver(graph, device="cpu")
    got = P.take()
    assert count > 0 and got["counters"]["host_reads"] == 1
    assert names(got["spans"])["solve.tc"] == 1


@pytest.mark.parametrize("kernel", ["pr", "bfs", "tc"])
def test_a_second_solve_builds_no_layout(kernel, rec):
    g = generate_graph("rmat", 8, symmetrize=True)
    solve = {"pr": lambda: pr.pr_solver(g, device="cpu"),
             "bfs": lambda: bfs.bfs_solver(g, 1, variant="do_fused",
                                           device="cpu"),
             "tc": lambda: tc.tc_solver(g, device="cpu")}[kernel]
    solve()
    first = P.take()
    assert first["counters"]["layout_builds"] == \
        sum(1 for s in first["spans"] if s[2].startswith("layout.")) > 0
    solve()
    second = P.take()
    assert not [s for s in second["spans"] if s[2].startswith("layout.")]
    assert "layout_builds" not in second["counters"]
    assert second["counters"]["layout_hits"] > 0


def test_from_edges_is_a_span(rec):
    generate_graph("rmat", 6, symmetrize=True)
    assert names(P.take()["spans"]) == {"graph.from_edges": 1}


def test_off_costs_a_flag_test():
    """The off path allocates nothing and stays well under a microsecond
    a span (the CPU micro-timing PERF.md §6 gives)."""
    P.take()
    n = 20000
    t = time.perf_counter()
    for _ in range(n):
        with P.span("x"):
            pass
    per = (time.perf_counter() - t) / n
    assert per < 20e-6
    assert P.take()["spans"] == []


# --- what graphbench reads of it ---------------------------------------------

MS = 1_000_000


def hand_run():
    """A 100 ms window of two trials; times in ms from 0.  Device busy
    [0, 10), [20, 30), [60, 90).  Host: solve A [0, 50) with an iteration
    [5, 40) holding a read [30, 40); between trials [50, 55); solve B
    [55, 100) with a read [85, 95).  Set-up: a layout [-500, -300) holding
    an inner layout, and a library load [-200, -150)."""
    sp = [(1, None, "layout.relabel", -500 * MS, -300 * MS),
          (2, 1, "layout.hybrid", -450 * MS, -350 * MS),
          (3, None, "kernels.load", -200 * MS, -150 * MS),
          (10, None, "solve.pr", 0, 50 * MS),
          (11, 10, "pr.iteration", 5 * MS, 40 * MS),
          (12, 11, "read", 30 * MS, 40 * MS),
          (20, None, "solve.pr", 55 * MS, 100 * MS),
          (21, 20, "read", 85 * MS, 95 * MS)]
    return {"spans": sp,
            "counters": {"setup": {"host_reads": 4, "layout_builds": 2},
                         "window": {"host_reads": 2, "layout_hits": 6}},
            "window": {"start_ns": 0, "end_ns": 100 * MS, "trials": 2,
                       "busy_ns": [[0, 10 * MS], [20 * MS, 30 * MS],
                                   [60 * MS, 90 * MS]]}}


def test_interval_arithmetic():
    a = [[0, 10], [20, 30]]
    assert spans.intersect(a, [[5, 25]]) == [[5, 10], [20, 25]]
    assert spans.subtract(a, [[5, 25]]) == [[0, 5], [25, 30]]
    assert spans.subtract([[0, 100]], [[10, 20], [30, 40]]) == \
        [[0, 10], [20, 30], [40, 100]]
    assert spans.clip([(5, 50), (-5, 2)], 0, 10) == [[0, 2], [5, 10]]
    assert spans.length([[0, 5], [7, 8]]) == 6


def test_segments_follow_the_innermost_span():
    sp = hand_run()["spans"]
    seg = [(s // MS, e // MS, n[-1] if n else None)
           for s, e, n in spans.segments(sp, 0, 100 * MS)]
    assert seg == [(0, 5, "solve.pr"), (5, 30, "pr.iteration"),
                   (30, 40, "read"), (40, 50, "solve.pr"), (50, 55, None),
                   (55, 85, "solve.pr"), (85, 95, "read"),
                   (95, 100, "solve.pr")]


def test_idle_by_the_innermost_span():
    got = dict(spans.idle_by_span(hand_run()))
    # idle: [10, 20), [30, 60), [90, 100)
    assert got == pytest.approx({"pr.iteration": 0.010, "read": 0.015,
                                 "solve.pr": 0.020,
                                 spans.OUTSIDE: 0.005})


def read(metric, run):
    return manifest.metric(metric).read(run)


def test_the_recorder_metrics_on_a_hand_made_run():
    run = hand_run()
    assert read("host_reads_per_trial", run) == 1.0
    # solve 95 ms less reads 20 ms, over 2 trials
    assert read("host_issue_ms_per_trial", run) == pytest.approx(37.5)
    # idle inside solves outside reads: [10, 20), [40, 50), [55, 60),
    # [95, 100): 30 ms of 100
    assert read("idle_issuing_pct", run) == pytest.approx(30.0)
    assert read("layout_build_s", run) == pytest.approx(0.2)   # outermost
    assert read("kernel_load_s", run) == pytest.approx(0.05)
    del run["spans"][2]
    assert read("kernel_load_s", run) is None        # no library loaded
    for name in spanrun.METRICS:
        assert read(name, {"trace": None, "phases": {}}) is None


def test_spanrun_carries_the_recorder_metrics(bench_cell):
    got = bench_cell(record=True)
    assert got["correct"] and got["recorder"]
    assert set(got["recorder_metrics"]) == {
        "host_reads_per_trial", "host_issue_ms_per_trial",
        "idle_issuing_pct", "layout_build_s"}   # no kernel library here
    reads = got["recorder_metrics"]["host_reads_per_trial"]
    assert reads == got["counters"]["window"]["host_reads"] / \
        got["attempted"]
    assert reads > 0 and float(reads).is_integer()   # one an iteration
    assert got["idle_by_span"] and got["against"]["layout_builds_window"] == 0
    assert got["against"]["from_edges_s"] > 0
    assert set(got["metrics"]) <= {m["name"] for m in
                                   manifest.load_benchmark()["per_layer"]}


def test_spanrun_without_the_recorder_carries_the_old_metrics(
        bench_cell, monkeypatch):
    monkeypatch.setattr(spanrun, "recorder", lambda: None)
    got = bench_cell(record=True)
    assert got["correct"] and not got["recorder"]
    assert "recorder_metrics" not in got and "idle_by_span" not in got
    assert set(got["metrics"]) == {"graph_build_s", "first_trial_s"}


@pytest.fixture
def bench_cell():
    def run(record):
        return spanrun.traced(manifest.load_benchmark(), "urand20-pr", 5,
                              0.2, "cpu", record=record,
                              cfg_override={"scale": 7})
    return run
