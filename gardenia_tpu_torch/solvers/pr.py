"""PageRank — power iteration, damping 0.85, L1 tolerance 1e-4, max 100
iterations (reference src/pr/{pr.h,omp_base.cc,base.cu}); torch
counterpart of gardenia_tpu/solvers/pr.py.

Variants:
  'pull'  — gather over in-edges (the layouts below).
  'push'  — scatter-add over out-edges in COO order (ops/spmv.
            spmv_segment; reference src/pr/push.cu); no layout.
  'delta' — residual propagation (reference src/pr/delta.cu): only the
            vertices whose |delta| exceeds EPSILON2 * score propagate;
            over the pull layouts.

The JAX solver runs the loop on the device under lax.while_loop.  Here the
loop runs on the host and reads the L1 error back once per iteration, as
the reference's base.cu does; each iteration is contrib = scores /
out_degree, incoming = SpMV over the transposed graph, scores' = base +
kDamp * incoming.

Layouts (pull and delta):
  'hybrid' — degree-relabelled hybrid block-sparse (ops/bsr.py): dense
             panels through kernel K1 plus an ELL remainder.  Scores map
             back to the original ids.
  'ell'    — degree-bucketed slab SpMV (ops/ell.py) over the original ids.
  'auto'   — hybrid (on every device).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.utils.profiler import host_read, span, spanned

KDAMP = 0.85          # reference src/pr/pr.h:6
EPSILON = 1e-4        # reference src/pr/pr.h:5
EPSILON2 = 1e-3       # reference src/pr/pr.h:8 (delta activity threshold)
MAX_ITER = 100        # reference src/pr/pr.h:12


@dataclasses.dataclass
class PRResult:
    scores: torch.Tensor    # f32[m], original vertex ids
    iterations: int
    errors: torch.Tensor    # f32[max_iter] on the host (inf-filled tail)


def _pr_loop(spmv_fn, out_deg: torch.Tensor, m: int, epsilon: float,
             max_iter: int):
    """(scores, iterations, errors) of the pull power iteration."""
    # f32 constants, compared and combined as the JAX loop does
    base = float(np.float32((1.0 - KDAMP) / m))
    kd = float(np.float32(KDAMP))
    epsilon = float(np.float32(epsilon))
    safe_deg = out_deg.float().clamp(min=1.0)
    has_out = out_deg > 0
    scores = torch.full((m,), float(np.float32(1.0 / m)),
                        dtype=torch.float32, device=out_deg.device)
    errs = torch.full((max_iter,), float("inf"), dtype=torch.float32)
    it, err = 0, float("inf")
    while it < max_iter and err >= epsilon:
        with span("pr.iteration"):
            contrib = torch.where(has_out, scores / safe_deg, 0.0)
            new_scores = base + kd * spmv_fn(contrib)
            # one device-to-host read per iteration: the convergence test
            err = host_read((new_scores - scores).abs().sum())
        errs[it] = err
        scores = new_scores
        it += 1
    return scores, it, errs


def _pr_delta_loop(spmv_fn, out_deg: torch.Tensor, m: int, epsilon: float,
                   max_iter: int):
    """(scores, iterations, errors) of residual-propagation PageRank
    (reference delta.cu:100-123, omp_delta.cc:59-101): deltas start at
    1/m, each round the active vertices push delta / degree, deltas' =
    kDamp * sums (plus the one-time base-score correction in round 0),
    scores accumulate the deltas, and a vertex stays active while |delta|
    > EPSILON2 * score.  err = sum |deltas|."""
    init_score = float(np.float32(1.0 / m))
    base = float(np.float32((1.0 - KDAMP) / m))
    kd = float(np.float32(KDAMP))
    eps2 = float(np.float32(EPSILON2))
    epsilon = float(np.float32(epsilon))
    safe_deg = out_deg.float().clamp(min=1.0)
    has_out = out_deg > 0
    scores = torch.full((m,), init_score, dtype=torch.float32,
                        device=out_deg.device)
    deltas = scores.clone()
    errs = torch.full((max_iter,), float("inf"), dtype=torch.float32)
    it, err = 0, float("inf")
    while it < max_iter and err >= epsilon:
        with span("pr.iteration"):
            active = deltas.abs() > eps2 * scores
            contrib = torch.where(active & has_out, deltas / safe_deg, 0.0)
            sums = spmv_fn(contrib)
            deltas = kd * sums
            if it == 0:
                deltas = base + deltas - init_score
            scores = scores + deltas
            err = host_read(deltas.abs().sum())  # the iteration's one read
        errs[it] = err
        it += 1
    return scores, it, errs


@spanned("solve.pr")
def pr_solver(g, *, epsilon: float = EPSILON, max_iter: int = MAX_ITER,
              variant: str = "pull", layout: str = "auto",
              device="cuda") -> PRResult:
    """PageRank scores for all vertices of g on `device`.

    g is the host Graph (gardenia_tpu_torch.core.graph); the pull and
    delta variants sweep its reverse (in-edge) view, push its COO edges.
    """
    if variant not in ("pull", "push", "delta"):
        raise ValueError(f"unknown PR variant {variant!r}")
    if layout == "auto":
        layout = "hybrid"
    dev = resolve_device(device)
    m = g.m
    from gardenia_tpu_torch.core import views
    from gardenia_tpu_torch.ops.semiring import F32_PLUS_TIMES
    loop = _pr_delta_loop if variant == "delta" else _pr_loop
    if variant == "push":
        from gardenia_tpu_torch.ops.spmv import spmv_segment
        src, dst = views.coo(g, dev)
        spmv_fn = partial(spmv_segment, dst, src, None,
                          semiring=F32_PLUS_TIMES, num_rows=m)
        return PRResult(*loop(spmv_fn, views.degrees(g, dev), m, epsilon,
                              max_iter))
    if layout == "hybrid":
        from gardenia_tpu_torch.ops.bsr import spmv_hybrid
        g2, hyb, new_of_old = views.relabeled_hybrid(g, dev)
        spmv_fn = partial(spmv_hybrid, hyb, num_rows=m)
        scores, it, errs = loop(spmv_fn, views.degrees(g2, dev), m, epsilon,
                                max_iter)
        return PRResult(scores[new_of_old], it, errs)
    if layout == "ell":
        from gardenia_tpu_torch.ops.spmv import spmv_ell
        spmv_fn = partial(spmv_ell, views.ell(g, dev, reverse=True),
                          semiring=F32_PLUS_TIMES, num_rows=m)
        scores, it, errs = loop(spmv_fn, views.degrees(g, dev), m, epsilon,
                                max_iter)
        return PRResult(scores, it, errs)
    raise ValueError(f"unknown PR layout {layout!r}")


def pr_print_trace(result: PRResult) -> None:
    """Per-iteration error trace in the reference's format
    (' %2d    %lf' — src/pr/omp_base.cc:35)."""
    iters = int(result.iterations)
    errs = np.asarray(result.errors)
    for i in range(iters):
        print(f" {i + 1:2d}    {errs[i]:.6f}")
    print(f"\titerations = {iters}.")
