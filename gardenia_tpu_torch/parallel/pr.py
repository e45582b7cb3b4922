"""Multi-device pull PageRank over a 1D vertex partition — the torch
counterpart of gardenia_tpu/parallel/pr.py.

Each rank owns a contiguous vertex range (edge-balanced by default, see
parallel/partition.py) and the in-edges of that range, padded to
rows_per_shard rows.  An iteration, on every rank:
  contrib_l    = scores_l / out_degree_l
  contrib_full = all_gather(contrib_l)          (the padded vertex space)
  incoming     = the rank's SpMV over contrib_full
  scores_l'    = (base + kDamp * incoming) * valid_l
  err          = all_reduce(sum |scores_l' - scores_l|)
and one host read of err, as the single-device solvers/pr.py reads it.

layout='hybrid' (the default) sweeps the rank's rows of the
degree-relabelled graph through ops/bsr.spmv_hybrid: kernel K1 on its
dense panels (S = 1, an f32 operand: the JAX package's hi/lo bf16 split
of the operand is not needed) plus its ELL remainder.  layout='ell'
sweeps ELL slabs over the original ids.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from gardenia_tpu_torch.parallel import partition
from gardenia_tpu_torch.solvers.pr import EPSILON, KDAMP, MAX_ITER, PRResult


def shard_of(g, mesh, layout: str, balance: str):
    """This rank's Shard of g's in-edges (partition.hybrid_shard or
    ell_shard: the pull sweeps read them) with its matrix on the rank's
    device, cached on g."""
    def mk():
        build = partition.hybrid_shard if layout == "hybrid" else \
            partition.ell_shard
        sh = build(g, mesh.size, mesh.rank, reverse=True, balance=balance)
        sh.mat = sh.mat.to(mesh.device)
        return sh
    return g._dev(("torch", "shard1d", layout, balance, mesh.size,
                   mesh.rank, str(mesh.device)), mk)


def local_apply(sh, layout: str):
    """x (the all-gathered padded vector) -> the rank's rows of A x,
    rows_per_shard of them."""
    mb = sh.ranges.rows_per_shard
    if layout == "hybrid":
        from gardenia_tpu_torch.ops.bsr import spmv_hybrid
        return partial(spmv_hybrid, sh.mat, num_rows=mb)
    from gardenia_tpu_torch.ops.semiring import F32_PLUS_TIMES
    from gardenia_tpu_torch.ops.spmv import spmv_ell
    return partial(spmv_ell, sh.mat, semiring=F32_PLUS_TIMES, num_rows=mb)


def padded_local(sh, values: np.ndarray, dtype) -> torch.Tensor:
    """The rank's rows of a per-vertex array, zero-padded to
    rows_per_shard."""
    out = np.zeros(sh.ranges.rows_per_shard, values.dtype)
    out[:sh.hi - sh.lo] = values[sh.lo:sh.hi]
    return torch.from_numpy(out).to(dtype)


def pr_solver_dist(g, *, mesh, epsilon: float = EPSILON,
                   max_iter: int = MAX_ITER, balance: str = "edges",
                   layout: str = "hybrid") -> PRResult:
    """Distributed pull PageRank on every rank of mesh; the scores of all
    vertices (original ids) come back on every rank, on its device."""
    if layout not in ("hybrid", "ell"):
        raise ValueError(f"unknown PR layout {layout!r}")
    new_of_old = None
    if layout == "hybrid":
        from gardenia_tpu_torch.core.relabel import relabeled
        rel = relabeled(g)
        g, new_of_old = rel.graph, rel.new_of_old
    dev = mesh.device
    m = g.m
    sh = shard_of(g, mesh, layout, balance)
    apply = local_apply(sh, layout)
    # f32 constants, combined as the single-device loop does
    base = float(np.float32((1.0 - KDAMP) / m))
    kd = float(np.float32(KDAMP))
    epsilon = float(np.float32(epsilon))
    deg_l = padded_local(sh, g.degrees.astype(np.float32),
                         torch.float32).to(dev)
    valid_l = padded_local(sh, np.ones(m, np.float32), torch.float32).to(dev)
    safe_deg = deg_l.clamp(min=1.0)
    scores = valid_l * float(np.float32(1.0 / m))
    errs = torch.full((max_iter,), float("inf"), dtype=torch.float32)
    it, err = 0, float("inf")
    while it < max_iter and err >= epsilon:
        contrib = torch.where(deg_l > 0, scores / safe_deg, 0.0)
        incoming = apply(mesh.all_gather(contrib))
        new = (base + kd * incoming) * valid_l
        # the iteration's one host read: the all-reduced L1 change
        err = float(mesh.all_reduce((new - scores).abs().sum()))
        errs[it] = err
        scores = new
        it += 1
    full = sh.ranges.from_padded(mesh.all_gather(scores))
    if new_of_old is not None:
        # padded -> relabelled -> original vertex order
        full = full[torch.from_numpy(new_of_old.astype(np.int64)).to(dev)]
    return PRResult(full, it, errs)
