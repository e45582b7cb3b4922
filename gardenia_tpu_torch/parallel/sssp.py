"""Multi-device SSSP: a 1D vertex partition, frontier Bellman-Ford — the
torch counterpart of gardenia_tpu/parallel/sssp.py.

Each rank owns a contiguous vertex range and the weighted in-edges of
that range.  A round, on every rank:
  x_l    = dist_l where it improved last round, else INF   (the frontier)
  x_full = all_gather(x_l)
  cand   = min-plus over the rank's rows (x_full[src] + w)
  dist_l = min(dist_l, cand); alive = all_reduce(|improved|)
the frontier masking of the reference's data-driven worklist
(src/sssp/omp_base.cc:12-100: only bucketed vertices relax).  Distances
are int32 with the MYINFINITY sentinel, min-plus safe (common.h:66).

layout='hybrid' (the default) relaxes through ops/bsr.spmv_hybrid_min_plus
on the rank's weighted shard of the degree-relabelled graph: kernel M1 on
its dense panels every round (an unweighted graph rides the count layout
with scale 1, PR's shard), the ELL remainder beside it.  layout='ell'
relaxes over weighted ELL slabs of the original ids.
"""

from __future__ import annotations

import numpy as np
import torch

from gardenia_tpu_torch.core import types as T
from gardenia_tpu_torch.parallel.pr import shard_of
from gardenia_tpu_torch.solvers.sssp import SSSPResult

INF = int(T.MYINFINITY)


def sssp_solver_dist(g, source: int = 0, *, mesh, balance: str = "edges",
                     max_rounds: int = None,
                     layout: str = "hybrid") -> SSSPResult:
    """Distributed frontier Bellman-Ford on every rank of mesh: int32
    distances of all vertices (original ids, MYINFINITY where
    unreachable) on every rank.  Weights must be positive integers (an
    unweighted graph has unit weights)."""
    from gardenia_tpu_torch.ops.bsr import spmv_hybrid_min_plus
    from gardenia_tpu_torch.ops.semiring import I32_MIN_PLUS
    from gardenia_tpu_torch.ops.spmv import spmv_ell
    if layout not in ("hybrid", "ell"):
        raise ValueError(f"unknown SSSP layout {layout!r}")
    if max_rounds is None:
        max_rounds = g.m + 1
    dev = mesh.device
    new_of_old = None
    if layout == "hybrid":
        from gardenia_tpu_torch.core.relabel import relabeled
        rel = relabeled(g)
        g, new_of_old = rel.graph, rel.new_of_old
        source = int(new_of_old[source])
    # ELL slabs carry unit values where g has no weights; the hybrid count
    # layout of an unweighted graph has them in its cells (scale 1)
    weighted = layout == "ell" or g.weights is not None
    sh = shard_of(g, mesh, layout, balance, reverse=True, weighted=weighted)
    mb = sh.ranges.rows_per_shard
    dist = torch.full((mb,), INF, dtype=torch.int32, device=dev)
    if sh.lo <= source < sh.hi:
        dist[source - sh.lo] = 0
    front = dist == 0
    it, alive = 0, 1
    while alive > 0 and it < max_rounds:
        x = mesh.all_gather(torch.where(front, dist, INF))
        if layout == "hybrid":
            cand = spmv_hybrid_min_plus(sh.mat, x, num_rows=mb, sentinel=INF)
        else:
            cand = spmv_ell(sh.mat, x, semiring=I32_MIN_PLUS, num_rows=mb)
        front = cand < dist
        dist = torch.minimum(dist, cand)
        alive = int(mesh.all_reduce(front.sum(dtype=torch.int32)))
        it += 1
    full = sh.ranges.from_padded(mesh.all_gather(dist))
    if new_of_old is not None:
        full = full[torch.from_numpy(new_of_old.astype(np.int64)).to(dev)]
    return SSSPResult(full, it)
