"""Headline benchmark of the port — prints ONE JSON line in the shape of
the repo's bench.py:
  {"metric": "pr_pull_gteps_rmat{scale}", "value": N, "unit": "GTEPS",
   "vs_baseline": N, "detail": {"iters", "ms", "nnz", "m", ...}}

Pull PageRank GTEPS (edges x iterations / solve time, best of 3 after one
warm-up solve that also builds and uploads the layout) on a Graph500
R-MAT graph, symmetrized (scale 20: |V| = 1,048,576).  vs_baseline is
against the same 2.0 GTEPS constant as bench.py.  The graph is generated
anew from the generator's fixed seed in every run; nothing is cached on
disk.  `detail.device` names the card the number was taken on.

Run: python -m gardenia_tpu_torch.bench [--kernel pr] [--scale 20]
                                        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from gardenia_tpu_torch import resolve_device

BASELINE_GTEPS = 2.0      # the constant of the repo's bench.py
WARMUP, ITERS = 1, 3      # untimed solves (layout build, upload), timed


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
              "value": round(gteps, 4), "unit": "GTEPS",
              "vs_baseline": round(gteps / BASELINE_GTEPS, 4),
              "detail": {"iters": res.iterations,
                         "ms": round(secs * 1e3, 3), "nnz": g.nnz,
                         "m": g.m, "device": device_name(dev)}}
    return record, g, res


KERNELS = {"pr": bench_pr}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gardenia_tpu_torch.bench")
    ap.add_argument("--kernel", default="pr", choices=sorted(KERNELS))
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    t0 = time.time()
    record, _, _ = KERNELS[args.kernel](args.scale, args.device)
    record["detail"]["total_s"] = round(time.time() - t0, 1)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
