"""Benchmark CLI of the port — the `pr` kernel, with the positional argv
of gardenia_tpu/cli.py:

  python -m gardenia_tpu_torch.cli pr <filetype> <graph-prefix|scale>
                                   [symmetrize] [--device {cuda,cpu}]
e.g.
  python -m gardenia_tpu_torch.cli pr rmat 20
  python -m gardenia_tpu_torch.cli pr mtx soc-LiveJournal1 0 --device cpu

It prints the reference's contract lines: '|V| <m> |E| <nnz>', the error
trace, 'runtime [pull] = X ms.', 'GTEPS = ...' and the serial oracle's
'Correct'/'Wrong'.
"""

from __future__ import annotations

import argparse
import sys

from gardenia_tpu import load_graph
from gardenia_tpu.verify import check, oracles
from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.utils.report import gteps, report_runtime
from gardenia_tpu_torch.utils.timer import time_op


def _load(args):
    """The Graph named by <filetype> <prefix|scale> [symmetrize], with its
    reverse view (the pull sweeps read in-edges)."""
    filetype, prefix = args[0], args[1]
    symmetrize = bool(int(args[2])) if len(args) > 2 else False
    if filetype in ("rmat", "uniform"):
        # GAP-style synthetic graphs: prefix is the scale
        from gardenia_tpu.core.generate import generate_graph
        g = generate_graph(filetype, scale=int(prefix),
                           symmetrize=symmetrize, need_reverse=True)
    else:
        g = load_graph(prefix, filetype, symmetrize=symmetrize,
                       need_reverse=True)
    print(f"|V| {g.m} |E| {g.nnz}")
    return g


def run_pr(args, device) -> bool:
    print("PageRank by gardenia_tpu_torch")
    g = _load(args)
    from gardenia_tpu_torch.solvers.pr import (EPSILON, pr_print_trace,
                                               pr_solver)
    res, secs = time_op(lambda: pr_solver(g, device=device), device=device)
    pr_print_trace(res)
    report_runtime("pull", secs)
    print(f"GTEPS = {gteps(g.nnz, secs, res.iterations):.4f}")
    resid = oracles.pagerank_push_residual(g, res.scores.cpu().numpy())
    return check(resid < EPSILON, f"(residual {resid})")


KERNELS = {"pr": run_pr}


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
