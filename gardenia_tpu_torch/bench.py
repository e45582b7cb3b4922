"""Headline benchmark of the port — prints ONE JSON line in the shape of
the repo's bench.py:
  {"metric": "pr_pull_gteps_rmat{scale}", "value": N, "unit": "GTEPS",
   "vs_baseline": N, "detail": {"iters", "ms", "nnz", "m", ...}}

Kernels, each on a Graph500 R-MAT graph, symmetrized (scale 20: |V| =
1,048,576), with the formula, repeats and baseline constant of the
repo's bench.py:
  pr — pull PageRank GTEPS: edges x iterations / solve time, best of 3
       after one warm-up solve that also builds and uploads the layout;
       vs 2.0 GTEPS.
  tc — `tc_meps_rmat{scale}`: edges / solve time / 1e6, best of 2 after
       one warm-up solve that also relabels, preps and uploads; vs 2000
       M edges/s; detail.triangles is the count.
The graph is generated anew from the generator's fixed seed in every
run; nothing is cached on disk.  `detail.device` names the card the
number was taken on.  Numbers are printed unrounded: a slow CPU rate
must not round to 0.

Run: python -m gardenia_tpu_torch.bench [--kernel {pr,tc}] [--scale 20]
                                        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from gardenia_tpu_torch import resolve_device

BASELINE_GTEPS = 2.0      # the constants of the repo's bench.py
BASELINE_TC_MEPS = 2000.0
WARMUP, ITERS = 1, 3      # pr: untimed solves (layout build, upload), timed
TC_WARMUP, TC_ITERS = 1, 2    # tc: the same, as bench.py:253-263


def get_graph(scale: int):
    """Symmetrized Graph500 R-MAT graph of 2^scale vertices, degree 16."""
    from gardenia_tpu.core.generate import generate_graph
    return generate_graph("rmat", scale=scale, degree=16, symmetrize=True)


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def bench_pr(scale: int, device="cuda", g=None):
    """(record, graph, last PRResult) of the PR benchmark; g, when given,
    is the graph get_graph(scale) returns."""
    from gardenia_tpu_torch.solvers.pr import pr_solver
    from gardenia_tpu_torch.utils.timer import time_op
    dev = resolve_device(device)
    if g is None:
        g = get_graph(scale)
    res, secs = time_op(lambda: pr_solver(g, device=dev), warmup=WARMUP,
                        iters=ITERS, device=dev)
    gteps = g.nnz * res.iterations / secs / 1e9
    record = {"metric": f"pr_pull_gteps_rmat{scale}",
              "value": gteps, "unit": "GTEPS",
              "vs_baseline": gteps / BASELINE_GTEPS,
              "detail": {"iters": res.iterations,
                         "ms": secs * 1e3, "nnz": g.nnz,
                         "m": g.m, "device": device_name(dev)}}
    return record, g, res


def bench_tc(scale: int, device="cuda", g=None):
    """(record, graph, triangle count) of the TC benchmark; g, when given,
    is the graph get_graph(scale) returns."""
    from gardenia_tpu_torch.solvers.tc import tc_solver
    from gardenia_tpu_torch.utils.timer import time_op
    dev = resolve_device(device)
    if g is None:
        g = get_graph(scale)
    total, secs = time_op(lambda: tc_solver(g, device=dev),
                          warmup=TC_WARMUP, iters=TC_ITERS, device=dev)
    meps = g.nnz / secs / 1e6
    record = {"metric": f"tc_meps_rmat{scale}", "value": meps,
              "unit": "M edges/s", "vs_baseline": meps / BASELINE_TC_MEPS,
              "detail": {"triangles": int(total),
                         "ms": secs * 1e3, "nnz": g.nnz,
                         "m": g.m, "device": device_name(dev)}}
    return record, g, total


KERNELS = {"pr": bench_pr, "tc": bench_tc}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gardenia_tpu_torch.bench")
    ap.add_argument("--kernel", default="pr", choices=sorted(KERNELS))
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    t0 = time.time()
    record, _, _ = KERNELS[args.kernel](args.scale, args.device)
    record["detail"]["total_s"] = time.time() - t0
    print(json.dumps(record))


if __name__ == "__main__":
    main()
