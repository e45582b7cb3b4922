"""Benchmark CLI of the port — the `pr`, `tc` and `cc` kernels, with the
positional argv of gardenia_tpu/cli.py:

  python -m gardenia_tpu_torch.cli {pr,tc,cc} <filetype> <graph-prefix|scale>
                                   [symmetrize] [--device {cuda,cpu}]
e.g.
  python -m gardenia_tpu_torch.cli pr rmat 20
  python -m gardenia_tpu_torch.cli pr mtx soc-LiveJournal1 0 --device cpu
  python -m gardenia_tpu_torch.cli tc rmat 20
  python -m gardenia_tpu_torch.cli cc rmat 20

Each prints the reference's contract lines: '|V| <m> |E| <nnz>', the
kernel's own lines (pr: the error trace, 'runtime [pull] = X ms.',
'GTEPS = ...'; tc: 'runtime [base] = X sec', 'total_num_triangles = N';
cc: 'runtime [sv] = X ms.', 'num_components = N') and the serial
oracle's 'Correct'/'Wrong'.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from gardenia_tpu_torch.core.graph import load_graph
from gardenia_tpu_torch.verify import check, oracles
from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.utils.report import gteps, report_runtime
from gardenia_tpu_torch.utils.timer import time_op


def _load(args, symmetrize_default=False, need_reverse=False):
    """The Graph named by <filetype> <prefix|scale> [symmetrize]; each
    run_* function picks the symmetrize default and whether the reverse
    view is built (the pull sweeps read in-edges)."""
    filetype, prefix = args[0], args[1]
    symmetrize = bool(int(args[2])) if len(args) > 2 else symmetrize_default
    if filetype in ("rmat", "uniform"):
        # GAP-style synthetic graphs: prefix is the scale
        from gardenia_tpu_torch.core.generate import generate_graph
        g = generate_graph(filetype, scale=int(prefix),
                           symmetrize=symmetrize or symmetrize_default,
                           need_reverse=need_reverse)
    else:
        g = load_graph(prefix, filetype, symmetrize=symmetrize,
                       need_reverse=need_reverse)
    print(f"|V| {g.m} |E| {g.nnz}")
    return g


def run_pr(args, device) -> bool:
    print("PageRank by gardenia_tpu_torch")
    g = _load(args, need_reverse=True)
    from gardenia_tpu_torch.solvers.pr import (EPSILON, pr_print_trace,
                                               pr_solver)
    res, secs = time_op(lambda: pr_solver(g, device=device), device=device)
    pr_print_trace(res)
    report_runtime("pull", secs)
    print(f"GTEPS = {gteps(g.nnz, secs, res.iterations):.4f}")
    resid = oracles.pagerank_push_residual(g, res.scores.cpu().numpy())
    return check(resid < EPSILON, f"(residual {resid})")


def run_tc(args, device) -> bool:
    """tc <filetype> <graph> (src/tc/main.cc:5-9): symmetrizes by default
    and applies the DAG orientation itself."""
    print("Triangle Counting by gardenia_tpu_torch")
    print("Using DAG (static orientation)")
    g = _load(args, symmetrize_default=True)
    from gardenia_tpu_torch.solvers.tc import tc_solver
    total, secs = time_op(lambda: tc_solver(g, device=device), device=device)
    print(f"runtime [base] = {secs:f} sec")
    print(f"total_num_triangles = {total}")
    expect = oracles.tc_serial(g.oriented())
    return check(total == expect, f"(expected {expect})")


def same_components(comp, expect) -> bool:
    """The bijection check of gardenia_tpu/cli.py run_cc: no expected
    component split across labels, and as many labels as components (a
    solver that merges components must fail)."""
    _, inv_a = np.unique(comp, return_inverse=True)
    _, inv_b = np.unique(expect, return_inverse=True)
    return (len(np.unique(inv_a * (inv_b.max() + 1) + inv_b)) ==
            len(np.unique(inv_b))
            and len(np.unique(inv_a)) == len(np.unique(inv_b)))


def run_cc(args, device, variant="sv") -> bool:
    """cc <filetype> <graph> (src/cc/main.cc): symmetrizes by default;
    Shiloach-Vishkin, as the reference CLI runs it."""
    print("Connected Components by gardenia_tpu_torch")
    g = _load(args, symmetrize_default=True, need_reverse=True)
    from gardenia_tpu_torch.solvers.cc import cc_solver
    res, secs = time_op(lambda: cc_solver(g, variant=variant, device=device),
                        device=device)
    report_runtime(variant, secs)
    comp = res.comp.cpu().numpy()
    print(f"num_components = {len(np.unique(comp))}")
    return check(same_components(comp, oracles.cc_serial(g)))


KERNELS = {"pr": run_pr, "tc": run_tc, "cc": run_cc}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gardenia_tpu_torch.cli")
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("args", nargs="+",
                    help="<filetype> <graph-prefix|scale> [symmetrize]")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ns = ap.parse_args(argv)
    device = resolve_device(ns.device)
    ok = KERNELS[ns.kernel](ns.args, device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
