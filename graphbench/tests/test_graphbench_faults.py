"""The whole run, with the timed path broken underneath, comes out not
correct: once for each fault a cell can have (a step that returns its
state unchanged; an answer altered where it is produced).  One card, so
there is no exchange between chips to leave out."""

import time

import pytest
import torch

from graphbench import run

TINY = {"scale": 10}


def _run(bench, workload):
    res, _ = run.run_cell(bench, workload, 2**31 + 4242, 0.3, False, "cpu",
                          cfg_override=TINY, t_start=time.perf_counter())
    return res


def test_pr_step_that_returns_its_state_unchanged(bench, monkeypatch):
    from gardenia_tpu_torch.solvers import pr

    def unchanged(spmv_fn, out_deg, m, epsilon, max_iter):
        scores = torch.full((m,), 1.0 / m, dtype=torch.float32,
                            device=out_deg.device)
        errs = torch.full((max_iter,), float("inf"))
        errs[0] = 0.0          # the first step changed nothing: L1 0
        return scores, 1, errs
    monkeypatch.setattr(pr, "_pr_loop", unchanged)
    res = _run(bench, "kron20-pr")
    assert res["correct"] is False
    assert res["checks"]["iteration_gap"]["value"] >= 1


@pytest.mark.parametrize("workload", ["kron20-pr", "urand20-pr"])
def test_pr_solve_that_stops_one_iteration_early(bench, monkeypatch,
                                                 workload):
    from gardenia_tpu_torch.solvers import pr
    real = pr._pr_loop

    def early(spmv_fn, out_deg, m, epsilon, max_iter):
        _, n, _ = real(spmv_fn, out_deg, m, epsilon, max_iter)
        return real(spmv_fn, out_deg, m, epsilon, n - 1)
    monkeypatch.setattr(pr, "_pr_loop", early)
    res = _run(bench, workload)
    assert res["correct"] is False
    assert res["checks"]["iteration_gap"]["value"] == 1


@pytest.mark.parametrize("workload", ["kron20-pr", "urand20-pr"])
def test_pr_answer_altered_in_the_apply(bench, monkeypatch, workload):
    from gardenia_tpu_torch.ops import bsr
    real = bsr.spmv_hybrid

    def altered(*a, **k):
        y = real(*a, **k).clone()
        y[int(y.argmax())] *= 1.01
        return y
    monkeypatch.setattr(bsr, "spmv_hybrid", altered)
    res = _run(bench, workload)
    assert res["correct"] is False


def test_bfs_level_that_returns_its_state_unchanged(bench, monkeypatch):
    from gardenia_tpu_torch.solvers import bfs

    def unchanged(rowptr, colidx, deg, dist, mask, depth, cap):
        return dist, torch.zeros_like(mask)
    monkeypatch.setattr(bfs, "_td_level", unchanged)
    res = _run(bench, "kron20-bfs")
    assert res["correct"] is False and res["failed"] > 0


def test_bfs_depth_altered_where_it_is_produced(bench, monkeypatch):
    from gardenia_tpu_torch.solvers import bfs
    real = bfs._relax

    def altered(dist, tgt, depth):
        out = real(dist, tgt, depth)
        if depth == 0:
            out = out.clone()
            out[out == 1] = 2
        return out
    monkeypatch.setattr(bfs, "_relax", altered)
    res = _run(bench, "kron20-bfs")
    assert res["correct"] is False


# (H1's bitmap_count runs only where a DAG out-degree reaches
# HUB_THRESHOLD = 128, beyond what a CPU test holds)
@pytest.mark.parametrize("route", ["rot_count", "merge_count"])
@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_tc_count_step_faults(bench, monkeypatch, route, fault):
    from gardenia_tpu_torch.ops import tc_count
    real = getattr(tc_count, route)
    calls = []

    def broken(*a, **k):
        counts = real(*a, **k)
        calls.append(1)
        if fault == "unchanged":         # the step adds nothing to total
            return torch.zeros_like(counts)
        counts = counts.clone()
        counts.view(-1)[0] += 1
        return counts
    monkeypatch.setattr(tc_count, route, broken)
    res = _run(bench, "kron20-tc")
    assert calls, f"{route} does not run at this scale"
    assert res["correct"] is False
