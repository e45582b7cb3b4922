"""Multi-device BFS — the torch counterpart of gardenia_tpu/parallel/bfs.py.

`bfs_solver_dist`: a 1D vertex partition, bottom-up levels.  Each rank
owns a vertex range and its in-edges; a level is
  frontier_full = all_gather(frontier_l)
  newly_l       = unvisited & (count of frontier in-neighbours > 0)
  alive         = all_reduce(|newly|)          (the level's one host read)
the scale-out form of the reference's bottom-up step (src/bfs/
omp_beamer.cc:13-33), the all-gathered frontier in the shared Bitmap's
place.  layout='hybrid' counts through ops/bsr.spmv_hybrid (K1 on the
rank's panels, S = 1) over the degree-relabelled graph; 'ell' through ELL
slabs over the original ids.

`bfs_multi_source_dist`: data-parallel batched BFS.  The sources are
split over the ranks and the graph is replicated: each rank traverses its
S/n sources with solvers/bfs.bfs_multi_source (K1's tensor-core kernel at
S/n columns), with no traffic between ranks until the end, where the
level counter is reduced and the columns are gathered.
"""

from __future__ import annotations

import numpy as np
import torch

from gardenia_tpu_torch.core import types as T
from gardenia_tpu_torch.parallel.pr import local_apply, padded_local, shard_of
from gardenia_tpu_torch.solvers.bfs import BFSResult

INF = int(T.MYINFINITY)


def bfs_solver_dist(g, source: int = 0, *, mesh, balance: str = "edges",
                    layout: str = "hybrid") -> BFSResult:
    """Distributed bottom-up BFS on every rank of mesh; the depths of all
    vertices (original ids, INF where unreached) on every rank.  g needs
    its in-edges (need_reverse) unless it is symmetric."""
    if layout not in ("hybrid", "ell"):
        raise ValueError(f"unknown BFS layout {layout!r}")
    new_of_old = None
    if layout == "hybrid":
        from gardenia_tpu_torch.core.relabel import relabeled
        rel = relabeled(g)
        g, new_of_old = rel.graph, rel.new_of_old
        source = int(new_of_old[source])
    dev = mesh.device
    sh = shard_of(g, mesh, layout, balance)
    count = local_apply(sh, layout)
    start = np.zeros(g.m, np.int32)
    start[source] = 1
    frontier = padded_local(sh, start, torch.float32).to(dev)
    dist = torch.where(frontier > 0, 0, INF).to(torch.int32)
    depth, alive = 0, 1
    while alive > 0:
        cnt = count(mesh.all_gather(frontier))
        newly = (cnt > 0.5) & (dist == INF)
        dist = torch.where(newly, depth + 1, dist)
        frontier = newly.float()
        depth += 1
        alive = int(mesh.all_reduce(newly.sum(dtype=torch.int32)))
    full = sh.ranges.from_padded(mesh.all_gather(dist))
    if new_of_old is not None:
        full = full[torch.from_numpy(new_of_old.astype(np.int64)).to(dev)]
    return BFSResult(full, depth)


def bfs_multi_source_dist(g, sources, *, mesh,
                          layout: str = "auto") -> BFSResult:
    """Data-parallel multi-source BFS: dist (m, S) with column j the
    depths from sources[j], and the deepest rank's level count, on every
    rank.  The mesh size must divide S."""
    from gardenia_tpu_torch.solvers.bfs import bfs_multi_source
    sources = np.asarray(sources, np.int64)
    S, n = len(sources), mesh.size
    if S % n:
        raise ValueError(f"the mesh size ({n}) must divide the source "
                         f"count ({S})")
    per = S // n
    mine = sources[mesh.rank * per:(mesh.rank + 1) * per]
    res = bfs_multi_source(g, mine, layout=layout, device=mesh.device)
    depth = int(mesh.all_reduce(
        torch.tensor(res.iterations, dtype=torch.int32, device=mesh.device),
        "max"))
    return BFSResult(mesh.all_gather_cols(res.dist), depth)
